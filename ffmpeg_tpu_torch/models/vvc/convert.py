"""Numpy host-input tree -> the port's tensors.

`inputs_from_numpy` takes a frame's host-input dict as
`inputs.build_host_inputs` returns it and moves it to `device` as
int32 tensors (the ALF tree in its own int8 and int16 dtypes).  Counts
the host loops need stay Python ints.  Each layout's control rows
travel as one (len(KEYS), n) matrix whose rows
are exposed under their names, with a host copy kept for the checks
and the chunk bounds (so do the MC batch's tile offsets and work
lists, and the LMCS tables that the inter and LMCS kernels take in
their parameter blocks).
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils import trace
from .inputs import INTER_KEYS, INTRA_KEYS


def _to(t: torch.Tensor, device) -> torch.Tensor:
  """t on `device`, counted as one copy of the open trace span's
  (pipeline.submit_frame's h2d)."""
  trace.count("copies")
  return t.to(device)


def _t(a, device) -> torch.Tensor:
  return _to(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)),
             device)


def _rows(layout: dict, keys, device) -> dict:
  mat_host = np.stack([np.asarray(layout[k], np.int32) for k in keys])
  mat = _t(mat_host, device)
  out = {k: mat[i] for i, k in enumerate(keys)}
  out["mat"] = mat
  out["mat_host"] = mat_host
  return out


def _intra(intra: dict, n_chunks: int, device) -> dict:
  out = _rows(intra, INTRA_KEYS, device)
  ipos = np.asarray(intra["ipos"], np.int32)
  out["ipos_host"], out["ipos"] = ipos, _t(ipos, device)
  ioff = np.asarray(intra["ioff"], np.int32)[:n_chunks]
  iend = np.asarray(intra["iend"], np.int32)[:n_chunks]
  out["ioff_host"], out["iend_host"] = ioff, iend
  out["ioff"], out["iend"] = _t(ioff, device), _t(iend, device)
  return out


def _inter(inter: dict, n_inter: int, device) -> dict:
  """The MC batch: n_mc rows, the first n_inter of them pure inter; its
  tiles hold T samples per channel (mc_tiles)."""
  out = _rows(inter, INTER_KEYS, device)
  out["n_inter"] = n_inter
  out["n_mc"] = out["mat"].shape[1]
  for k in ("gwt", "gslot", "toff", "small", "large"):
    out[k] = _t(inter[k], device)
  for k in ("toff", "small", "large"):
    out[k + "_host"] = np.asarray(inter[k], np.int32)
  out["T"] = int(out["toff_host"][-1])
  return out


def _lmcs(lm: dict, device) -> dict:
  """The LMCS tables as tensors, and as host arrays the tables that
  travel in kernels' parameter blocks: the inter kernel's forward table
  (pivot[0:16] then fwd_scale) and the LMCS kernels' table (ops/lmcs.py:
  pivot, inv_scale, min_bin, max_bin, then chroma_scale when present)."""
  out = {k: _t(v, device) for k, v in lm.items()}
  out["fwd_host"] = np.concatenate(
      [np.asarray(lm["pivot"])[:16], lm["fwd_scale"]]).astype(np.int32)
  out["inv_host"] = np.concatenate(
      [lm["pivot"], lm["inv_scale"], lm["bins"]]
      + ([lm["chroma_scale"]] if "chroma_scale" in lm else [])).astype(
          np.int32)
  return out


def inputs_from_numpy(inp: dict, device) -> dict:
  device = torch.device(device)
  out = {"planes": []}
  for p in inp["planes"]:
    out["planes"].append({"buckets": {
        wh: {"mat": _t(b["mat"], device), "lv": _t(b["lv"], device),
             "n": int(np.asarray(b["n"]).reshape(-1)[0])}
        for wh, b in p["buckets"].items()}})
  out["ctrl"] = {}
  for tag, ct in inp["ctrl"].items():
    n_chunks = int(ct["n_chunks"])
    out["ctrl"][tag] = {"n_chunks": n_chunks,
                        "intra": _intra(ct["intra"], n_chunks, device),
                        "inter": _inter(ct["inter"], int(ct["n_inter"]),
                                        device)}
  if "cclm_vc" in inp:
    out["cclm_vc"] = int(inp["cclm_vc"])
  for key in ("deblock", "sao", "sl"):
    if key in inp:
      out[key] = {k: _t(v, device) for k, v in inp[key].items()}
  if "alf" in inp:
    # in its host dtypes (int8 CTB grid, int16 tables), as the ALF kernel
    # reads them
    out["alf"] = {k: _to(torch.from_numpy(np.ascontiguousarray(v)), device)
                  for k, v in inp["alf"].items()}
  if "lmcs" in inp:
    out["lmcs"] = _lmcs(inp["lmcs"], device)
  return out
