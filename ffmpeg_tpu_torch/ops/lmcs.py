"""LMCS (luma mapping with chroma scaling), spec 8.7.5 / 8.8.2.

Int32 torch port of the JAX frame program's `_lmcs_fwd`, `_lmcs_inv`
and `_lmcs_vpdu_scales`.  `lm` is the frame's converted LMCS tree
(inputs._lmcs_inputs on the device): `pivot` (17,), `fwd_scale` and
`inv_scale` (16,), `bins` (min_bin, max_bin) and, when the picture
header enables chroma residual scaling, `chroma_scale` (16,).

The luma prediction of inter units is mapped forward (the inter kernel
and ops/inter.py do that per sample with the same formula), intra and
inter units reconstruct in the mapped domain, chroma residuals are scaled
per VPDU from the mapped luma around it, and the whole luma plane is
mapped back before the loop filters.
"""
from __future__ import annotations

import torch

_I32 = torch.int32


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
  (ff_vvc_lmcs_filter, vvc_filter.c:1322-1331)."""
  shift = bit_depth - 4
  idx = _pivot_index(x, lm)
  valid = (idx >= 0) & (idx < 16)
  i = idx.clamp(0, 15).long()
  seg = (i.to(_I32) << shift) + ((lm["inv_scale"][i] * (x - lm["pivot"][i])
                                  + (1 << 10)) >> 11)
  seg = torch.where(valid, seg, torch.zeros_like(seg))
  return seg.clamp(0, (1 << bit_depth) - 1)


def lmcs_vpdu_scales(plane_y: torch.Tensor, lm: dict, W: int, H: int,
                     vsz: int, bit_depth: int,
                     tile_bds=((), ())) -> torch.Tensor:
  """Per-VPDU chroma residual scale factors from the mapped luma recon
  (lmcs_derive_chroma_scale, vvc_intra_template.c:390-428): the mean of
  the VPDU's outside-left column and outside-top row (edge-replicated to
  vsz samples within the picture), mapped through the pivot scan.  A
  neighbour in another tile is unavailable (ff_vvc_get_top/left_available).
  plane_y: the (H, W) picture of mapped luma.  Returns the flat
  (nvy * nvx,) int32 scales, indexed by a TU's `vpdu` row."""
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
