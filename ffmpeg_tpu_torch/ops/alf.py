"""Adaptive loop filter (ALF) and cross-component ALF as whole-plane
int32 torch passes.

Port of the JAX package's ops/alf.py (spec 8.8.5; alf_classify,
alf_filter_luma, alf_filter_chroma and alf_filter_cc of
vvc_filter_template.c, driven as ff_vvc_alf_filter, vvc_filter.c:1254-1320)
and of the frame program's `_alf_pass`.  Out-of-place passes read the
pre-ALF neighbours by construction, so two reference behaviours need
handling: picture borders replicate (clamped indexing), and the
horizontal virtual boundary 4 luma rows (2 chroma rows) above every CTU
row boundary remaps the taps near it, the same in every CTU row band.

All functions take exact picture-size (H, W) int32 planes.
"""
from __future__ import annotations

import numpy as np
import torch

_I32 = torch.int32

# transpose_idx -> coefficient position permutation (alf_recon_coeff)
TRANSPOSE_IDX = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
    [9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6],
    [0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11],
    [9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6],
], dtype=np.int32)

# class_idx from directional activity (alf_get_idx)
ARG_VAR = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                   dtype=np.int32)

# luma 7x7 diamond: coefficient j -> symmetric neighbour offsets
# (dy0, dx0), (dy1, dx1)
LUMA_TAPS = [((3, 0), (-3, 0)), ((2, 1), (-2, -1)), ((2, 0), (-2, 0)),
             ((2, -1), (-2, 1)), ((1, 2), (-1, -2)), ((1, 1), (-1, -1)),
             ((1, 0), (-1, 0)), ((1, -1), (-1, 1)), ((1, -2), (-1, 2)),
             ((0, 3), (0, -3)), ((0, 2), (0, -2)), ((0, 1), (0, -1))]

# chroma 5x5 diamond
CHROMA_TAPS = [((2, 0), (-2, 0)), ((1, 1), (-1, -1)), ((1, 0), (-1, 0)),
               ((1, -1), (-1, 1)), ((0, 2), (0, -2)), ((0, 1), (0, -1))]

# cc-alf: 7 taps on the luma grid around the collocated sample
CC_TAPS = [(-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1), (2, 0)]


def _ar(n, device):
  return torch.arange(n, dtype=torch.long, device=device)


def _const(a, device):
  return torch.as_tensor(a, device=device)


def _sample(plane, rows, cols):
  """plane at clamped (rows, cols) index grids (broadcast)."""
  H, W = plane.shape
  return plane[rows.clamp(0, H - 1), cols.clamp(0, W - 1)]


def _clipf(curr, v, clip):
  return torch.minimum(torch.maximum(v - curr, -clip), clip)


def alf_classify(plane: torch.Tensor, ctb: int, bit_depth: int):
  """Per-4x4-block (class_idx, transpose_idx) of a (H, W) luma plane
  (alf_classify + alf_get_idx).  Returns two (H // 4, W // 4) int32.

  The block's activity multiplies values that may pass 31 bits; the
  reference compares them in 64 bits, and so does this port (the JAX
  form splits the products, `_mulcmp_le`; tests hold the two equal)."""
  H, W = plane.shape
  dev = plane.device
  vb_rel = ctb - 4
  # gradient field on odd rows r = 2 gi - 3, even columns c = 2 ci - 2;
  # the virtual-boundary substitutions (s0 := s1, s3 := s2) depend only
  # on r % ctb
  Hg, Wg = H // 2 + 2, W // 2 + 2
  r = (2 * _ar(Hg, dev) - 3)[:, None]
  c = (2 * _ar(Wg, dev) - 2)[None, :]
  lr = r % ctb
  r0 = torch.where(lr == ctb - 5, r + 1, r)
  r3 = torch.where(lr == ctb - 7, r + 2, r + 3)

  def P(rr, cc):
    return _sample(plane, rr, cc)

  val0 = P(r + 1, c) * 2
  vert0 = (val0 - P(r0, c) - P(r + 2, c)).abs()
  horz0 = (val0 - P(r + 1, c - 1) - P(r + 1, c + 1)).abs()
  dig00 = (val0 - P(r0, c - 1) - P(r + 2, c + 1)).abs()
  dig10 = (val0 - P(r0, c + 1) - P(r + 2, c - 1)).abs()
  val1 = P(r + 2, c + 1) * 2
  vert1 = (val1 - P(r + 1, c + 1) - P(r3, c + 1)).abs()
  horz1 = (val1 - P(r + 2, c) - P(r + 2, c + 2)).abs()
  dig01 = (val1 - P(r + 1, c) - P(r3, c + 2)).abs()
  dig11 = (val1 - P(r + 1, c + 2) - P(r3, c)).abs()
  grad = torch.stack([vert0 + vert1, horz0 + horz1, dig00 + dig01,
                      dig10 + dig11])                    # (4, Hg, Wg)

  nby, nbx = H // 4, W // 4
  ly = (_ar(nby, dev) * 4) % ctb
  start = torch.where(ly == vb_rel, 1, 0)
  end = torch.where(ly == vb_rel - 4, 3, 4)
  ac = torch.where((ly == vb_rel) | (ly == vb_rel - 4), 3, 2).to(_I32)
  sums = torch.zeros((4, nby, nbx), dtype=_I32, device=dev)
  for i in range(4):
    live = ((i >= start) & (i < end))[None, :, None]
    rows = grad[:, i:i + 2 * nby:2, :]                    # rows 2 by + i
    for j in range(4):
      sums += torch.where(live, rows[:, :, j:j + 2 * nbx:2], 0)
  v, hz, d0g, d1g = sums[0], sums[1], sums[2], sums[3]
  dir_hv = (v <= hz).to(_I32)
  hv1, hv0 = torch.maximum(v, hz), torch.minimum(v, hz)
  dir_d = (d0g <= d1g).to(_I32)
  d1, d0 = torch.maximum(d0g, d1g), torch.minimum(d0g, d1g)
  dir1 = d1.long() * hv0.long() <= hv1.long() * d0.long()
  hvd1 = torch.where(dir1, hv1, d1)
  hvd0 = torch.where(dir1, hv0, d0)
  act = (((v + hz) * ac[:, None]) >> (bit_depth - 1)).clamp(0, 15)
  cls = _const(ARG_VAR, dev)[act.long()]
  dir1i = dir1.to(_I32)
  cls = torch.where(hvd1 * 2 > 9 * hvd0, cls + (dir1i * 2 + 2) * 5,
                    torch.where(hvd1 > 2 * hvd0, cls + (dir1i * 2 + 1) * 5,
                                cls))
  return cls, dir_d * 2 + dir_hv


def _row_offsets(y, ctb, vb_rel, n):
  """{|dy|: the row offset of a tap |dy| rows away} for |dy| = 0..n, per
  row y (a column of row indices): near the virtual boundary the taps
  that would cross it collapse toward the row itself; the negative side
  takes the negated offsets (`_vb_row_offsets`)."""
  ly = y % ctb
  d = {0: torch.zeros_like(ly),
       1: torch.where((ly == vb_rel - 1) | (ly == vb_rel), 0, 1)}
  for k in range(2, n + 1):
    d[k] = torch.where((ly >= vb_rel - k) & (ly <= vb_rel + k - 1), d[k - 1],
                       k)
  return d


def _diamond(plane, y, x, dmap, taps, coeff, clip):
  """sum_j coeff_j * (clip(s(+tap_j) - s) + clip(s(-tap_j) - s))."""
  total = torch.zeros_like(plane)
  for j, pair in enumerate(taps):
    kj = clip[..., j]
    t = 0
    for dy, dx in pair:
      rows = y + (dmap[abs(dy)] if dy >= 0 else -dmap[abs(dy)])
      t = t + _clipf(plane, _sample(plane, rows, x + dx), kj)
    total += coeff[..., j] * t
  return total


def _block_to_pixel(blk, H, W):
  """(H // 4, W // 4, ...) per-block values -> (H, W, ...) per sample."""
  return blk.repeat_interleave(4, 0).repeat_interleave(4, 1)[:H, :W]


def alf_filter_luma(plane, coeff, clip, ctb: int, on, bit_depth: int):
  """7x7 diamond clipped filter (alf_filter_luma).  coeff/clip:
  (H // 4, W // 4, 12) per block, transpose applied; on: (H // 4,
  W // 4) bool, the blocks whose CTB has alf_ctb_flag[luma]."""
  H, W = plane.shape
  dev = plane.device
  vb_rel = ctb - 4
  y, x = _ar(H, dev)[:, None], _ar(W, dev)[None, :]
  dmap = _row_offsets(y, ctb, vb_rel, 3)
  total = _diamond(plane, y, x, dmap, LUMA_TAPS,
                   _block_to_pixel(coeff, H, W), _block_to_pixel(clip, H, W))
  ly = y % ctb
  near = (ly >= vb_rel - 1) & (ly <= vb_rel)
  s = torch.where(near, (total + (1 << 9)) >> 10, (total + 64) >> 7)
  out = (plane + s).clamp(0, (1 << bit_depth) - 1)
  return torch.where(_block_to_pixel(on, H, W), out, plane)


def alf_filter_chroma(plane, coeff, clip, ctb_c: int, on, bit_depth: int):
  """5x5 diamond clipped filter (alf_filter_chroma).  coeff/clip: (H, W,
  6) per sample; on: (H, W) bool; ctb_c: the CTB size in chroma
  samples."""
  H, W = plane.shape
  dev = plane.device
  vb_rel = ctb_c - 2
  y, x = _ar(H, dev)[:, None], _ar(W, dev)[None, :]
  dmap = _row_offsets(y, ctb_c, vb_rel, 2)
  total = _diamond(plane, y, x, dmap, CHROMA_TAPS, coeff, clip)
  ly = y % ctb_c
  near = (ly >= vb_rel - 1) & (ly <= vb_rel)
  s = torch.where(near, (total + (1 << 9)) >> 10, (total + 64) >> 7)
  out = (plane + s).clamp(0, (1 << bit_depth) - 1)
  return torch.where(on, out, plane)


def alf_filter_cc(chroma, luma_pre_alf, coeff, ctb: int, on,
                  bit_depth: int):
  """Cross-component filter for 4:2:0 (alf_filter_cc): adds a high-pass
  of the pre-ALF luma to the chroma-ALF'd plane.  coeff: (Hc, Wc, 7) per
  sample; on: (Hc, Wc) bool; ctb: the luma CTB size."""
  Hc, Wc = chroma.shape
  dev = chroma.device
  vb_rel = ctb - 4
  yl = _ar(Hc, dev)[:, None] << 1
  xl = _ar(Wc, dev)[None, :] << 1
  pos = yl % ctb
  # rows near the luma virtual boundary collapse toward the centre row
  sub_all = (pos == vb_rel - 1) | (pos == vb_rel)
  sub_s3 = (pos == vb_rel - 2) | (pos == vb_rel + 1)
  zero = torch.zeros_like(pos)
  r1 = torch.where(sub_all, 0, 1)
  rows_of = {-1: torch.where(sub_all, 0, -1), 0: zero, 1: r1,
             2: torch.where(sub_all, 0, torch.where(sub_s3, r1, 2))}
  center = _sample(luma_pre_alf, yl, xl)
  total = torch.zeros_like(chroma)
  for j, (dy, dx) in enumerate(CC_TAPS):
    total += coeff[..., j] * (
        _sample(luma_pre_alf, yl + rows_of[dy], xl + dx) - center)
  half = 1 << (bit_depth - 1)
  s = ((total + 64) >> 7).clamp(-half, half - 1)
  out = (chroma + s).clamp(0, (1 << bit_depth) - 1)
  return torch.where(on, out, chroma)


def alf_pass(planes, a: dict, *, W: int, H: int, ctb_log2: int,
             bit_depth: int, mono: bool = False):
  """deblock -> SAO -> ALF: the last in-loop stage over the padded
  planes (the frame program's `_alf_pass`).  a: the frame's converted
  ALF tree (inputs._alf_inputs): per-CTB flags and filter indices `ctb`
  (cbh, cbw, 8), the luma banks, the chroma alternatives and the CC-ALF
  coefficients.  Returns the filtered planes."""
  ctb_sz = 1 << ctb_log2
  dev = planes[0].device
  ly0 = planes[0][:H, :W]
  cls, tr = alf_classify(ly0, ctb_sz, bit_depth)
  nby, nbx = H // 4, W // 4
  cb_by = (_ar(nby, dev) * 4) >> ctb_log2
  cb_bx = (_ar(nbx, dev) * 4) >> ctb_log2
  ctb_blk = a["ctb"][cb_by[:, None], cb_bx[None, :]]          # (nby, nbx, 8)
  bank = ctb_blk[..., 1].long()
  perm = _const(TRANSPOSE_IDX, dev).long()[tr.long()]          # (nby, nbx, 12)
  coeff12 = torch.gather(a["banks_coeff"][bank, cls.long()], -1, perm)
  clip12 = torch.gather(a["banks_clipv"][bank, cls.long()], -1, perm)
  out = [planes[0].clone()]
  out[0][:H, :W] = alf_filter_luma(ly0, coeff12, clip12, ctb_sz,
                                   ctb_blk[..., 0] > 0, bit_depth)
  if mono:
    return out
  Hc, Wc = H >> 1, W >> 1
  yc = (_ar(Hc, dev) >> (ctb_log2 - 1))[:, None]
  xc = (_ar(Wc, dev) >> (ctb_log2 - 1))[None, :]
  for c in (1, 2):
    pc = planes[c][:Hc, :Wc]
    alt = a["ctb"][..., 2 * c + 1][yc, xc]
    known = ((alt >= 0) & (alt < 8))[..., None]  # else zero coefficients
    alt = alt.long().clamp(0, 7)
    pc = alf_filter_chroma(
        pc, torch.where(known, a["chroma_coeff"][alt], 0),
        torch.where(known, a["chroma_clipv"][alt], 0), ctb_sz >> 1,
        a["ctb"][..., 2 * c][yc, xc] > 0, bit_depth)
    idc = a["ctb"][..., 5 + c][yc, xc]
    cc7 = a["cc_coeff"][c - 1][idc.long().clamp(0, 4)]
    cc7 = torch.where(((idc >= 0) & (idc < 5))[..., None], cc7, 0)
    pc = alf_filter_cc(pc, ly0, cc7, ctb_sz, idc > 0, bit_depth)
    o = planes[c].clone()
    o[:Hc, :Wc] = pc
    out.append(o)
  return out
