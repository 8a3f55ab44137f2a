"""The truth a run's frames are judged by, made by an independent
decoder: for each configuration a pool of generator seeds, each with its
stream's byte count and sha256 and the MD5 of every output frame as the
JAX package generates and decodes it on the CPU
(`truth/<config>/<seed>.json`, written by `truth/make.py`; a run reads
the JSON alone and loads nothing of JAX).

A run decodes every stream of the pool in turn, so that every seed does
the same work; its `--seed` picks the stream the rotation starts at
(`first`)."""
from __future__ import annotations

import json
import os

from .cells import ROOT


def pool(config_name: str, root: str = ROOT) -> list:
  """The configuration's entries, {"seed": generator seed, "bytes",
  "sha256", "md5": [each output frame's MD5], "generator"}, in the order
  of their generator seeds; raises FileNotFoundError where it has
  none."""
  d = os.path.join(root, "truth", config_name)
  names = sorted((f for f in os.listdir(d) if f.endswith(".json")),
                 key=lambda f: int(f[:-5])) if os.path.isdir(d) else []
  if not names:
    raise FileNotFoundError(f"no truth for {config_name!r} under {d}")
  out = []
  for name in names:
    with open(os.path.join(d, name)) as f:
      out.append(json.load(f))
  return out


def first(seed: int, entries: list) -> int:
  """The index of the stream a run with `seed` starts at."""
  if seed < 0:
    raise ValueError(f"seed {seed} is negative")
  return seed % len(entries)
