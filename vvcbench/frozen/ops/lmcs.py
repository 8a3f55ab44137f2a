"""LMCS (luma mapping with chroma scaling), spec 8.7.5 / 8.8.2.

Port of the JAX frame program's `_lmcs_fwd`, `_lmcs_inv` and
`_lmcs_vpdu_scales`.  `lm` is the frame's converted LMCS tree
(convert._lmcs: inputs._lmcs_inputs on the device): `pivot` (17,),
`fwd_scale` and `inv_scale` (16,), `bins` (min_bin, max_bin) and, when
the picture header enables chroma residual scaling, `chroma_scale`
(16,); and its host copies `fwd_host` (the inter kernel's table) and
`inv_host` (this module's kernels' tables).

The luma prediction of inter units is mapped forward (the inter kernel
and ops/inter.py do that per sample with the same formula), intra and
inter units reconstruct in the mapped domain, chroma residuals are scaled
per VPDU from the mapped luma around it, and the whole luma plane is
mapped back before the loop filters.

`lmcs_inv` is the frame program's entry point for the inverse map: on
a CUDA tensor it launches its kernel (csrc/lmcs.cu, the tables in the
parameter block from `inv_host`, so the wrapper reads nothing of the
card), on a CPU tensor it runs its plain version (`lmcs_inv_plain`:
int32 torch ops, the kernel's oracle); nothing falls back from one to
the other.  The chroma residual scales have no entry point of their
own: the chroma residual call computes each scaled TU's scale
(ops/transform.py residual_planes, csrc/lmcs_scale.cuh), and
`lmcs_vpdu_scales_plain` is their plain version.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

_I32 = torch.int32

# launches of the CUDA kernels and runs of the plain versions: plain
# integer counters a caller may reset to 0 and read back
LAUNCHES = {"lmcs_inv": 0}
PLAIN_RUNS = {"lmcs_inv": 0}

# interior tile boundaries per direction that the chroma residual kernel
# takes in its parameter block (csrc/lmcs_scale.cuh LMCS_MAX_BDS)
MAX_TILE_BDS = 64
# inv_host: pivot (17), inv_scale (16), min_bin, max_bin, then
# chroma_scale (16) when chroma residual scaling is on
INV_TABLE = 35
INV_TABLE_CRS = 51


def lmcs_fwd(x: torch.Tensor, lm: dict, bit_depth: int) -> torch.Tensor:
  """Forward luma mapping over 16 uniform input segments
  (lmcs_derive_lut_sample, vvc_ps.c:592-598).  A sample outside the 16
  segments maps to 0, as in the JAX form, which selects among them."""
  shift = bit_depth - 4
  idx = x >> shift
  valid = (idx >= 0) & (idx < 16)
  i = idx.clamp(0, 15).long()
  seg = lm["pivot"][i] + ((lm["fwd_scale"][i] * (x - (i.to(_I32) << shift))
                           + (1 << 10)) >> 11)
  seg = torch.where(valid, seg, torch.zeros_like(seg))
  return seg.clamp(0, (1 << bit_depth) - 1)


def _pivot_index(x: torch.Tensor, lm: dict) -> torch.Tensor:
  """The inverse map's bin of each sample: min_bin plus the pivots
  pivot[j + 1], min_bin <= j <= max_bin, that it reaches (the
  reference's scan, vvc_ps.c:656-660)."""
  mb, xb = lm["bins"][0], lm["bins"][1]
  idx = torch.zeros_like(x) + mb
  for j in range(16):
    take = (j >= mb) & (j <= xb)
    idx = idx + (take & (x >= lm["pivot"][j + 1])).to(_I32)
  return idx


def lmcs_inv(x: torch.Tensor, lm: dict, bit_depth: int) -> torch.Tensor:
  """Inverse luma mapping over the non-uniform pivots
  (ff_vvc_lmcs_filter, vvc_filter.c:1322-1331) of every sample of x,
  into a new tensor of its shape.  A CUDA tensor (contiguous int32)
  launches the kernel; a CPU tensor runs lmcs_inv_plain."""
  dev = x.device
  if dev.type == "cuda":
    return _inv_cuda(x, lm, bit_depth)
  if dev.type != "cpu":
    raise ValueError(f"lmcs_inv: unsupported device {dev}")
  return lmcs_inv_plain(x, lm, bit_depth)


def lmcs_inv_plain(x: torch.Tensor, lm: dict, bit_depth: int) -> torch.Tensor:
  """lmcs_inv's plain version, with its arguments and result."""
  PLAIN_RUNS["lmcs_inv"] += 1
  shift = bit_depth - 4
  idx = _pivot_index(x, lm)
  valid = (idx >= 0) & (idx < 16)
  i = idx.clamp(0, 15).long()
  seg = (i.to(_I32) << shift) + ((lm["inv_scale"][i] * (x - lm["pivot"][i])
                                  + (1 << 10)) >> 11)
  seg = torch.where(valid, seg, torch.zeros_like(seg))
  return seg.clamp(0, (1 << bit_depth) - 1)


def lmcs_vpdu_scales_plain(plane_y: torch.Tensor, lm: dict, W: int, H: int,
                           vsz: int, bit_depth: int,
                           tile_bds=((), ())) -> torch.Tensor:
  """Per-VPDU chroma residual scale factors from the mapped luma recon
  (lmcs_derive_chroma_scale, vvc_intra_template.c:390-428): the mean of
  the VPDU's outside-left column and outside-top row (edge-replicated to
  vsz samples within the picture), mapped through the pivot scan.  A
  neighbour in another tile is unavailable (ff_vvc_get_top/left_available).
  plane_y: the (H, W) picture of mapped luma, which may be a view of the
  padded plane; tile_bds: the interior tile boundaries (columns, rows) in
  luma samples.  Returns the flat (nvy * nvx,) int32 scales, indexed by a
  TU's `vpdu` row: the plain version of the scales that the chroma
  residual kernel derives per TU (csrc/lmcs_scale.cuh)."""
  dev = plane_y.device
  nvx, nvy = -(-W // vsz), -(-H // vsz)
  vy = torch.arange(nvy, dtype=torch.long, device=dev) * vsz
  vx = torch.arange(nvx, dtype=torch.long, device=dev) * vsz
  i = torch.arange(vsz, dtype=torch.long, device=dev)
  rows = (vy[:, None] + i[None, :]).clamp(max=H - 1)          # (nvy, vsz)
  lsum = plane_y[rows[:, None, :], (vx - 1).clamp(min=0)[None, :, None]].sum(
      -1, dtype=_I32)                                         # (nvy, nvx)
  cols = (vx[:, None] + i[None, :]).clamp(max=W - 1)          # (nvx, vsz)
  tsum = plane_y[(vy - 1).clamp(min=0)[:, None, None], cols[None, :, :]].sum(
      -1, dtype=_I32)
  avail_l = (vx > 0)[None, :]
  avail_t = (vy > 0)[:, None]
  for bx in tile_bds[0]:
    avail_l = avail_l & (vx != bx)[None, :]
  for by in tile_bds[1]:
    avail_t = avail_t & (vy != by)[:, None]
  al, at = avail_l.to(_I32), avail_t.to(_I32)
  total = lsum * al + tsum * at
  cnt_log2 = (vsz.bit_length() - 1) + (al & at)
  cnt = (al + at) * vsz
  luma = torch.where(cnt > 0, (total + (cnt >> 1)) >> cnt_log2,
                     torch.full_like(total, 1 << (bit_depth - 1)))
  idx = _pivot_index(luma, lm).clamp(max=15)
  return lm["chroma_scale"][idx.reshape(-1).long()]


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "lmcs.cu")
_lib = None


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("lmcs", [_SRC]))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lmcs_inv_launch.restype = ctypes.c_int
    lib.lmcs_inv_launch.argtypes = [
        p, p, ll,           # src, dst, samples
        p, i, i, p]         # tables, their length, bit_depth, stream
    lib.lmcs_error_string.restype = ctypes.c_char_p
    lib.lmcs_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


def host_table(lm: dict, name: str, crs: bool):
  """lm's `inv_host` as a ctypes array and its length; raises
  ValueError when it is missing or malformed, or (crs: for the chroma
  scales) lacks the chroma scales or has a negative min_bin (the kernels
  read nothing else of the tree)."""
  if "inv_host" not in lm:
    raise ValueError(f"{name}: the LMCS tree has no inv_host table "
                     "(models/vvc/convert.py _lmcs)")
  t = np.ascontiguousarray(lm["inv_host"], np.int32)
  want = (INV_TABLE_CRS,) if crs else (INV_TABLE, INV_TABLE_CRS)
  if t.shape not in [(n,) for n in want]:
    raise ValueError(f"{name}: inv_host of shape {t.shape}, expected "
                     f"one of {want} entries")
  if crs and t[33] < 0:
    raise ValueError(f"{name}: min_bin {t[33]} below 0")
  return (ctypes.c_int * len(t))(*t.tolist()), len(t)


def _raise_on(rc: int, lib, name: str) -> None:
  if rc != 0:
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{lib.lmcs_error_string(rc).decode()}")


def _inv_cuda(x, lm, bit_depth):
  """One launch on x's device's current stream into a new tensor."""
  if x.dtype != _I32 or not x.is_contiguous():
    raise ValueError(f"lmcs_inv: expected a contiguous int32 tensor, got "
                     f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
  tab, n_tab = host_table(lm, "lmcs_inv", False)
  lib = _get_kernel()
  dst = torch.empty_like(x)
  with torch.cuda.device(x.device):
    rc = lib.lmcs_inv_launch(
        x.data_ptr(), dst.data_ptr(), x.numel(), tab, n_tab, bit_depth,
        torch.cuda.current_stream(x.device).cuda_stream)
  _raise_on(rc, lib, "lmcs_inv")
  LAUNCHES["lmcs_inv"] += 1
  return dst

