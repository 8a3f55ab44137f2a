"""The normative tables (models/vvc/vvc_tables.npz, read once) and
per-device copies of the constant tensors the ops read, made on first
use."""
from __future__ import annotations

import os

import numpy as np

with np.load(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models", "vvc", "vvc_tables.npz")) as _z:
  VVC_TABLES = {k: _z[k] for k in _z.files}

_CACHE: dict = {}


def on_device(key, device, make):
  """make() -> CPU tensor, moved to `device` once per (key, device)."""
  k = (key, str(device))
  if k not in _CACHE:
    _CACHE[k] = make().to(device)
  return _CACHE[k]
