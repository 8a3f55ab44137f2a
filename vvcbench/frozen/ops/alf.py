"""Adaptive loop filter (ALF) and cross-component ALF: the ALF kernel
and its plain versions.

Port of the JAX package's ops/alf.py (spec 8.8.5; alf_classify,
alf_filter_luma, alf_filter_chroma and alf_filter_cc of
vvc_filter_template.c, driven as ff_vvc_alf_filter, vvc_filter.c:1254-1320)
and of the frame program's `_alf_pass`.  Out-of-place passes read the
pre-ALF neighbours by construction, so two reference behaviours need
handling: picture borders replicate (clamped indexing), and the
horizontal virtual boundary 4 luma rows (2 chroma rows) above every CTU
row boundary remaps the taps near it, the same in every CTU row band.

`alf_planes` is the frame program's entry point: a luma plane
(classification and the 7x7 diamond), or the Cb and Cr planes together
(the 5x5 diamond, then CC-ALF from the pre-ALF luma), each over the
padded planes with the frame's ALF tree.  A CUDA tensor launches the
kernel (csrc/alf.cu: one launch per call, a persistent grid over TILE
tiles with their halo in shared memory, each sample written once; the
chroma launch may overlap the luma launch queued just before it, when
the caller says so); a CPU tensor runs
the plain version, `alf_planes_plain`, composed of the whole-plane
passes below (the ports of the JAX functions, and the kernel's oracle),
which take exact picture-size (H, W) int32 planes.  `alf_tiled_plain`
runs the kernel's decomposition on the CPU.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

_I32 = torch.int32

# launches of the CUDA kernel, the chroma launches among them that may
# overlap the luma launch before them, and runs of the plain version:
# plain integer counters a caller may reset to 0 and read back
LAUNCHES = {"alf": 0}
OVERLAPS = {"alf": 0}
PLAIN_RUNS = {"alf": 0}

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


# ----------------------------------------------------------------------
# the entry point, its plain version, and the CUDA kernel (csrc/alf.cu),
# built with nvcc at first use and bound with ctypes
# ----------------------------------------------------------------------

# The kernel's tiles (csrc/alf.cu gets them at build time): a luma thread
# block owns TILE = (TH, TW) output samples, a chroma block TH x TW/2
# samples of Cb and of Cr; one thread a run of 4 samples of a row.  Its
# buffers hold the tile with a clamped halo of 3 luma or 2 chroma rows
# and the aligned columns [x0 - 4, x0 + TW + 4), beside the collocated
# luma.  Chosen on the card by tools/alf_tiles.py's sweep (PERF.md).
TILE = (16, 32)
# copy chunks of 4 columns (the kernel's 16-byte copies)
_CHUNK = 4


def _check(planes, a, chroma, W, H, ctb_log2, bit_depth, luma):
  """Shapes and types the kernel takes, on every device: one luma or two
  chroma (Hp, Wp) int32 contiguous planes of one shape and device (and
  for chroma the pre-ALF luma plane), the ALF tree in its host dtypes
  (inputs._alf_inputs: an int8 (cbh, cbw, 8) CTB grid that covers the
  picture, int16 tables), a picture of whole 4x4 luma blocks inside the
  planes, CTB 32 to 128, 8 to 12 bits."""
  def bad(msg):
    raise ValueError(f"alf: {msg}")

  if len(planes) != (2 if chroma else 1):
    bad(f"{len(planes)} planes for a {'chroma' if chroma else 'luma'} call")
  if chroma != (luma is not None):
    bad("the pre-ALF luma goes with a chroma call, and only there")
  Hp, Wp = planes[0].shape
  dev = planes[0].device
  ss = 1 if chroma else 0
  for t in list(planes) + ([luma] if chroma else []):
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() \
        or t.device != dev or (t is not luma and t.shape != (Hp, Wp)):
      bad(f"expected contiguous int32 ({Hp}, {Wp}) planes on {dev}, got "
          f"{t.dtype} {tuple(t.shape)} on {t.device}")
  if H % 4 or W % 4 or H < 8 or W < 8 or (H >> ss) > Hp or (W >> ss) > Wp \
      or (chroma and (H > luma.shape[0] or W > luma.shape[1])):
    bad(f"a {H}x{W} picture does not fit the planes in whole 4x4 blocks")
  if not 5 <= ctb_log2 <= 7 or not 8 <= bit_depth <= 12:
    bad(f"CTB 2^{ctb_log2} or {bit_depth} bits not taken")
  g = a["ctb"]
  if g.dtype != torch.int8 or g.dim() != 3 or g.shape[2] != 8 \
      or not g.is_contiguous() or g.device != dev \
      or g.shape[0] << ctb_log2 < H or g.shape[1] << ctb_log2 < W:
    bad(f"the CTB grid {g.dtype} {tuple(g.shape)} does not cover {H}x{W}")
  if chroma:
    tables = {"chroma_coeff": (8, 6), "chroma_clipv": (8, 6),
              "cc_coeff": (2, 5, 7)}
  else:
    nb = max(1, a["banks_coeff"].shape[0])  # at least one bank
    tables = {"banks_coeff": (nb, 25, 12), "banks_clipv": (nb, 25, 12)}
  for k, shape in tables.items():
    t = a[k]
    if t.dtype != torch.int16 or not t.is_contiguous() or t.device != dev \
        or tuple(t.shape) != shape:
      bad(f"{k}: expected contiguous int16 {shape} on {dev}, got "
          f"{t.dtype} {tuple(t.shape)} on {t.device}")


def alf_planes(planes, alf, *, chroma: bool, W: int, H: int, ctb_log2: int,
               bit_depth: int, luma=None, overlap: bool = False):
  """ALF over the padded planes of one frame: deblock -> SAO -> ALF, the
  last in-loop stage (the frame program's `_alf_pass`, one call per
  component kind).

  planes: [luma], or [Cb, Cr], (Hp, Wp) int32 contiguous padded planes.
  alf: the frame's converted ALF tree (inputs._alf_inputs, in its host
  dtypes): per-CTB values `ctb` (cbh, cbw, 8) int8 (the luma flag and
  bank, the Cb and Cr flags and alternatives, the two CC-ALF indices),
  the luma banks `banks_coeff` / `banks_clipv` (B, 25, 12) int16, the
  chroma alternatives (8, 6) int16 and the CC-ALF coefficients (2, 5, 7)
  int16.  W, H: the cropped luma picture.  luma: for a chroma call, the
  pre-ALF padded luma plane that CC-ALF reads.  overlap (chroma calls
  on the card): the caller queued the luma call whose input is `luma`
  just before this one on the current stream, and keeps that call's
  inputs referenced until this call is queued (the frame program's
  pair); the chroma launch may then start while the luma launch runs.
  Returns the filtered planes, (nch, Hp, Wp) int32, a new tensor: the
  picture filtered, the padding copied.  A CUDA tensor launches the
  kernel; a CPU tensor runs the plain version; nothing falls back from
  one to the other."""
  _check(planes, alf, chroma, W, H, ctb_log2, bit_depth, luma)
  dev = planes[0].device
  kw = dict(chroma=chroma, W=W, H=H, ctb_log2=ctb_log2, bit_depth=bit_depth,
            luma=luma)
  if dev.type == "cuda":
    return _alf_cuda(planes, alf, **kw, overlap=overlap and chroma)
  if dev.type != "cpu":
    raise ValueError(f"alf: unsupported device {dev}")
  return alf_planes_plain(planes, alf, **kw)


def alf_planes_plain(planes, alf, *, chroma: bool, W: int, H: int,
                     ctb_log2: int, bit_depth: int, luma=None):
  """alf_planes's plain version, with its arguments and result: the
  whole-plane passes on the cropped planes, the per-4x4 (luma) and
  per-sample (chroma) coefficients gathered from the tree as the JAX
  `_alf_pass` gathers them."""
  PLAIN_RUNS["alf"] += 1
  a = alf
  ctb_sz = 1 << ctb_log2
  dev = planes[0].device
  if not chroma:
    ly0 = planes[0][:H, :W]
    cls, tr = alf_classify(ly0, ctb_sz, bit_depth)
    nby, nbx = H // 4, W // 4
    cb_by = (_ar(nby, dev) * 4) >> ctb_log2
    cb_bx = (_ar(nbx, dev) * 4) >> ctb_log2
    ctb_blk = a["ctb"][cb_by[:, None], cb_bx[None, :]]      # (nby, nbx, 8)
    # a bank past the tree's takes the nearest, as the JAX gather does
    bank = ctb_blk[..., 1].long().clamp(0, a["banks_coeff"].shape[0] - 1)
    perm = _const(TRANSPOSE_IDX, dev).long()[tr.long()]      # (nby, nbx, 12)
    coeff12 = torch.gather(a["banks_coeff"][bank, cls.long()], -1, perm)
    clip12 = torch.gather(a["banks_clipv"][bank, cls.long()], -1, perm)
    out = planes[0].clone()
    out[:H, :W] = alf_filter_luma(ly0, coeff12, clip12, ctb_sz,
                                  ctb_blk[..., 0] > 0, bit_depth)
    return out[None]
  ly0 = luma[:H, :W]
  Hc, Wc = H >> 1, W >> 1
  yc = (_ar(Hc, dev) >> (ctb_log2 - 1))[:, None]
  xc = (_ar(Wc, dev) >> (ctb_log2 - 1))[None, :]
  out = []
  for c, plane in zip((1, 2), planes):
    pc = plane[:Hc, :Wc]
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
    o = plane.clone()
    o[:Hc, :Wc] = pc
    out.append(o)
  return torch.stack(out)


# ----------------------------------------------------------------------
# the kernel's decomposition on the CPU
# ----------------------------------------------------------------------

# the transpose as the kernel applies it (csrc/alf.cu transpose12): the
# permutation of dir_hv (TRANSPOSE_IDX[1]), then with dir_d the swaps
# (1 3) (4 8) (5 7) (TRANSPOSE_IDX[2])
_SIGMA = TRANSPOSE_IDX[1].tolist()
_SWAPS = TRANSPOSE_IDX[2].tolist()


def _load_rows(plane, oy, ox, R, C, h, w, vec):
  """csrc/alf.cu load_rows for a batch of tiles: rows [oy, oy + R) x
  columns [ox, ox + C) of a plane (oy, ox: (n,) tensors, ox a multiple
  of 4), each position clamped to [0, h) x [0, w), as (n, R, C).  A chunk
  of 4 columns inside [0, w) is copied as it lies (the 16-byte copy)
  when vec; any other chunk column by column, clamped."""
  dev = plane.device
  rows = (oy[:, None] + _ar(R, dev)).clamp(0, h - 1)
  gx = ox[:, None] + _CHUNK * _ar(C // _CHUNK, dev)
  whole = (gx >= 0) & (gx + _CHUNK <= w) & vec
  cols = gx[:, :, None] + _ar(_CHUNK, dev)
  cols = torch.where(whole[:, :, None], cols, cols.clamp(0, w - 1))
  return plane[rows[:, :, None], cols.reshape(len(ox), 1, C)]


def _put(out, written, rows, cols, vals, mask):
  """out[rows, cols] = vals where mask (broadcast), each write counted."""
  rows, cols, vals, mask = torch.broadcast_tensors(rows, cols, vals, mask)
  r, c = rows[mask], cols[mask]
  out[r, c] = vals[mask].to(out.dtype)
  written.index_put_((r, c), torch.ones_like(r, dtype=written.dtype),
                     accumulate=True)


def _luma_tiles(plane, out, written, y0, x0, a, H, W, ctb_log2, bit_depth,
                th, tw, vec):
  """One stage of the persistent grid on luma: the tiles at (y0, x0)
  ((n,) each).  Dimensions of the threads' values: (tile, block row by,
  block column bx, row q of the block, sample j of the run)."""
  dev = plane.device
  n = len(y0)
  buf = _load_rows(plane, y0 - 3, x0 - 4, th + 6, tw + 8, H, W, vec)
  ctb = 1 << ctb_log2
  m, vb = ctb - 1, ctb - 4
  ni = _ar(n, dev)[:, None, None, None, None]
  by = _ar(th // 4, dev)[None, :, None, None, None]
  bx = _ar(tw // 4, dev)[None, None, :, None, None]
  q = _ar(4, dev)[None, None, None, :, None]
  j = _ar(4, dev)[None, None, None, None, :]
  yb = y0[:, None, None, None, None] + 4 * by
  x = x0[:, None, None, None, None] + 4 * bx
  inside = (yb < H) & (x < W)
  g = a["ctb"]
  gv = g[(yb >> ctb_log2).clamp(max=g.shape[0] - 1),
         (x >> ctb_log2).clamp(max=g.shape[1] - 1)].long()
  on = inside & (gv[..., 0] > 0)
  nb = a["banks_coeff"].shape[0]
  bank = torch.where(inside, gv[..., 1].clamp(0, nb - 1), 0)

  def at(rows, cols):
    return buf[ni, rows, cols].long()

  # classification: thread q's window row (gradients on row r = yb - 3 +
  # 2q, columns x - 2 + 2j), buffer rows from 4 by + 2q
  r = yb - 3 + 2 * q
  lr = r & m
  br = 4 * by + 2 * q
  R0 = torch.where(lr == ctb - 5, br + 1, br)
  R3 = torch.where(lr == ctb - 7, br + 2, br + 3)
  k = 4 * bx + 2 * j + 2
  v0 = at(br + 1, k) * 2
  v1 = at(br + 2, k + 1) * 2
  sv = (v0 - at(R0, k) - at(br + 2, k)).abs() + \
      (v1 - at(br + 1, k + 1) - at(R3, k + 1)).abs()
  sh = (v0 - at(br + 1, k - 1) - at(br + 1, k + 1)).abs() + \
      (v1 - at(br + 2, k) - at(br + 2, k + 2)).abs()
  sd0 = (v0 - at(R0, k - 1) - at(br + 2, k + 1)).abs() + \
      (v1 - at(br + 1, k) - at(R3, k + 2)).abs()
  sd1 = (v0 - at(R0, k + 1) - at(br + 2, k - 1)).abs() + \
      (v1 - at(br + 1, k + 2) - at(R3, k)).abs()
  ly = yb & m
  live = (q >= (ly == vb).long()) & (q < torch.where(ly == vb - 4, 3, 4))
  # each thread's row over its 4 positions, then the 4 rows (shuffles)
  sv, sh, sd0, sd1 = (torch.where(live, s.sum(-1, keepdim=True), 0)
                      .sum(-2, keepdim=True) for s in (sv, sh, sd0, sd1))
  ac = torch.where((ly == vb) | (ly == vb - 4), 3, 2)
  dir_hv, dir_d = sv <= sh, sd0 <= sd1
  hv1, hv0 = torch.maximum(sv, sh), torch.minimum(sv, sh)
  d1, d0 = torch.maximum(sd0, sd1), torch.minimum(sd0, sd1)
  dir1 = d1 * hv0 <= hv1 * d0
  hvd1 = torch.where(dir1, hv1, d1)
  hvd0 = torch.where(dir1, hv0, d0)
  act = (((sv + sh) * ac) >> (bit_depth - 1)).clamp(0, 15)
  cls = _const(ARG_VAR, dev).long()[act]
  cls = torch.where(hvd1 * 2 > 9 * hvd0, cls + (dir1.long() * 2 + 2) * 5,
                    torch.where(hvd1 > 2 * hvd0,
                                cls + (dir1.long() * 2 + 1) * 5, cls))

  def bank_row(t):
    v = t[bank, cls].long()                         # (..., 12)
    v = torch.where(dir_hv[..., None], v[..., _SIGMA], v)
    return torch.where(dir_d[..., None], v[..., _SWAPS], v)

  cf, kp = bank_row(a["banks_coeff"]), bank_row(a["banks_clipv"])
  # the 7x7 diamond: the thread's row y, its row offsets once
  y = yb + q
  ly1 = y & m
  e = {0: torch.zeros_like(ly1)}
  e[1] = torch.where((ly1 == vb - 1) | (ly1 == vb), 0, 1)
  e[2] = torch.where((ly1 >= vb - 2) & (ly1 <= vb + 1), e[1], 2)
  e[3] = torch.where((ly1 >= vb - 3) & (ly1 <= vb + 2), e[2], 3)
  Cr = 4 * by + q + 3
  col = 4 * bx + 4 + j
  curr = at(Cr, col)
  tot = torch.zeros_like(curr)
  for t, pair in enumerate(LUMA_TAPS):
    side = 0
    for dy, dx in pair:
      off = e[abs(dy)] if dy >= 0 else -e[abs(dy)]
      side = side + torch.minimum(torch.maximum(
          at(Cr + off, col + dx) - curr, -kp[..., t]), kp[..., t])
    tot = tot + cf[..., t] * side
  near = (ly1 >= vb - 1) & (ly1 <= vb)
  sh_ = torch.where(near, (tot + (1 << 9)) >> 10, (tot + 64) >> 7)
  val = torch.where(on, (curr + sh_).clamp(0, (1 << bit_depth) - 1), curr)
  _put(out, written, y, x + j, val, inside)


def _chroma_tiles(planes, luma, out, written, y0, x0, a, H, W, ctb_log2,
                  bit_depth, th, cw, vec):
  """One stage of the persistent grid on chroma: the tiles at (y0, x0)
  of both planes.  Dimensions: (tile, plane, row ty, run rx, sample j)."""
  dev = luma.device
  n = len(y0)
  Hc, Wc = H >> 1, W >> 1
  cb = torch.stack([_load_rows(p, y0 - 2, x0 - 4, th + 4, cw + 8, Hc, Wc,
                               vec) for p in planes], 1)
  lb = _load_rows(luma, 2 * y0 - 1, 2 * x0 - 4, 2 * th + 2, 2 * cw + 8, H,
                  W, vec)
  ni = _ar(n, dev)[:, None, None, None, None]
  pl = _ar(2, dev)[None, :, None, None, None]
  ty = _ar(th, dev)[None, None, :, None, None]
  rx = _ar(cw // 4, dev)[None, None, None, :, None]
  j = _ar(4, dev)[None, None, None, None, :]
  y = y0[:, None, None, None, None] + ty
  x = x0[:, None, None, None, None] + 4 * rx
  run = (y < Hc) & (x < Wc)
  lc = ctb_log2 - 1
  g = a["ctb"]
  gv = g[(y >> lc).clamp(max=g.shape[0] - 1),
         (x >> lc).clamp(max=g.shape[1] - 1)].long()     # (..., 8)

  def byte(cb, cr):
    return torch.cat([gv[..., cb], gv[..., cr]], 1)

  # each component c's flag 2c, alternative 2c + 1, CC-ALF index 5 + c
  flag, alt, idc = byte(2, 4), byte(3, 5), byte(6, 7)
  S = ty + 2
  col = 4 * rx + 4 + j
  curr = cb[ni, pl, S, col].long()
  maxv = (1 << bit_depth) - 1
  # the 5x5 diamond
  known = (alt >= 0) & (alt < 8)
  alt = torch.where(known, alt, 0)
  cf = torch.where(known[..., None], a["chroma_coeff"][alt].long(), 0)
  kp = torch.where(known[..., None], a["chroma_clipv"][alt].long(), 0)
  ctb_c = 1 << lc
  mc, vbc = ctb_c - 1, ctb_c - 2
  ly = y & mc
  e = {0: torch.zeros_like(ly)}
  e[1] = torch.where((ly == vbc - 1) | (ly == vbc), 0, 1)
  e[2] = torch.where((ly >= vbc - 2) & (ly <= vbc + 1), e[1], 2)
  tot = torch.zeros_like(curr)
  for t, pair in enumerate(CHROMA_TAPS):
    side = 0
    for dy, dx in pair:
      off = e[abs(dy)] if dy >= 0 else -e[abs(dy)]
      side = side + torch.minimum(torch.maximum(
          cb[ni, pl, S + off, col + dx].long() - curr, -kp[..., t]),
          kp[..., t])
    tot = tot + cf[..., t] * side
  near = (ly >= vbc - 1) & (ly <= vbc)
  sh = torch.where(near, (tot + (1 << 9)) >> 10, (tot + 64) >> 7)
  pc = torch.where(flag > 0, (curr + sh).clamp(0, maxv), curr)
  # CC-ALF from the collocated luma: row 2y is buffer row 2 ty + 1,
  # sample j's column 8 rx + 4 + 2j
  known = idc < 5
  wt = a["cc_coeff"].long()[pl, torch.where(known, idc, 0)]
  wt = torch.where(known[..., None], wt, 0)
  ctb = 1 << ctb_log2
  m, vb = ctb - 1, ctb - 4
  pos = (2 * y) & m
  sub_all = (pos == vb - 1) | (pos == vb)
  sub_s3 = (pos == vb - 2) | (pos == vb + 1)
  r1 = torch.where(sub_all, 0, 1)
  rows_of = {-1: torch.where(sub_all, 0, -1), 0: torch.zeros_like(r1),
             1: r1, 2: torch.where(sub_all, 0, torch.where(sub_s3, r1, 2))}
  L = 2 * ty + 1
  lcol = 8 * rx + 4 + 2 * j
  center = lb[ni, L, lcol].long()
  tot = torch.zeros_like(center)
  for t, (dy, dx) in enumerate(CC_TAPS):
    tot = tot + wt[..., t] * (lb[ni, L + rows_of[dy], lcol + dx].long()
                              - center)
  half = 1 << (bit_depth - 1)
  cc = ((tot + 64) >> 7).clamp(-half, half - 1)
  pc = torch.where(idc > 0, (pc + cc).clamp(0, maxv), pc)
  for p in range(2):
    _put(out[p], written[p], y[:, 0], (x + j)[:, 0], pc[:, p],
         (run & (x + j < Wc))[:, 0])


def alf_tiled_plain(planes, alf, *, chroma: bool, W: int, H: int,
                    ctb_log2: int, bit_depth: int, luma=None, grid=7,
                    aligned=True, tile=None):
  """The kernel's algorithm on the CPU, with alf_planes's arguments and
  result: the padding ring copied, then the tiles (tile: (TH, TW), TILE
  by default) in the persistent grid's order (`grid` blocks; block b
  takes tiles b, b + grid, ...; each stage, every block's next tile, as
  one batch), each loaded into its buffer with csrc/alf.cu's copies
  (aligned=False: the 4-byte path of a misaligned plane) and filtered
  from the buffer alone, per thread as the kernel does: the window rows
  and their shuffle sum, the transposed coefficients, the per-row
  virtual-boundary offsets.  Raises unless every sample of the planes is
  written exactly once.  Equal to alf_planes_plain
  (tests/test_torch_alf_tiles.py)."""
  _check(planes, alf, chroma, W, H, ctb_log2, bit_depth, luma)
  th, tw = tile or TILE
  Hp, Wp = planes[0].shape
  dev = planes[0].device
  out = torch.empty((len(planes), Hp, Wp), dtype=torch.int32, device=dev)
  written = torch.zeros(out.shape, dtype=torch.int32, device=dev)
  h, w = (H >> 1, W >> 1) if chroma else (H, W)
  for c, p in enumerate(planes):           # the ring: outside the picture
    out[c, :h, w:], out[c, h:] = p[:h, w:], p[h:]
    written[c, :h, w:] += 1
    written[c, h:] += 1
  cw = tw // 2 if chroma else tw
  ntx = -(-w // cw)
  ntiles = ntx * -(-h // th)
  grid = max(1, min(grid, ntiles))
  for k in range(0, ntiles, grid):
    tiles = _ar(min(ntiles, k + grid) - k, dev) + k
    y0, x0 = (tiles // ntx) * th, (tiles % ntx) * cw
    if chroma:
      _chroma_tiles(planes, luma, out, written, y0, x0, alf, H, W, ctb_log2,
                    bit_depth, th, cw, aligned)
    else:
      _luma_tiles(planes[0], out[0], written[0], y0, x0, alf, H, W,
                  ctb_log2, bit_depth, th, tw, aligned)
  if not bool((written == 1).all()):
    raise AssertionError("alf_tiled_plain: samples written "
                         f"{sorted(set(written.unique().tolist()))} times")
  return out


# ----------------------------------------------------------------------
# the CUDA kernel (csrc/alf.cu), built with nvcc at first use and bound
# with ctypes
# ----------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "alf.cu")
_lib = None
# launch flags of csrc/alf.cu: the launch may start while the luma launch
# before it runs; 4-byte copies only
_F_OVERLAP, _F_SCALAR = 1, 2


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    _lib = _bind(build_cuda("alf", [_SRC], defines=(
        ("ALF_TH", TILE[0]), ("ALF_TW", TILE[1]))))
  return _lib


def _bind(path):
  """The built library at `path`, its functions typed."""
  lib = ctypes.CDLL(path)
  p, i = ctypes.c_void_p, ctypes.c_int
  lib.alf_luma_launch.restype = ctypes.c_int
  lib.alf_luma_launch.argtypes = [
      p, p, i, i, i, i,   # src, dst, Hp, Wp, H, W
      p, i, i,            # ctb grid, cbh, cbw
      p, p, i,            # banks_coeff, banks_clipv, bank count
      i, i, i, i, p]      # ctb_log2, bit_depth, max blocks, flags, stream
  lib.alf_chroma_launch.restype = ctypes.c_int
  lib.alf_chroma_launch.argtypes = [
      p, p, i, i,         # src pointers (2,), dst, Hp, Wp
      p, i, i, i, i,      # pre-ALF luma, its Hp, Wp; H, W (luma)
      p, i, i,            # ctb grid, cbh, cbw
      p, p, p,            # chroma_coeff, chroma_clipv, cc_coeff
      i, i, i, i, p]      # ctb_log2, bit_depth, max blocks, flags, stream
  lib.alf_plan.restype = ctypes.c_int
  lib.alf_plan.argtypes = [i, i, i, i, p]
  lib.alf_error_string.restype = ctypes.c_char_p
  lib.alf_error_string.argtypes = [ctypes.c_int]
  return lib


def launch_plan(*, chroma: bool, W: int, H: int):
  """A call's launch on the current card, without launching: its tiles,
  blocks (the persistent grid: the resident blocks the card holds, at
  most the tiles), resident blocks per SM, tiles per block (the most any
  block takes), dynamic shared bytes, SMs and threads per block."""
  lib = _get_kernel()
  out = (ctypes.c_int * 6)()
  rc = lib.alf_plan(int(chroma), H, W, 0, out)
  if rc != 0:
    raise RuntimeError(f"alf plan failed: {lib.alf_error_string(rc).decode()}")
  tiles, blocks, per_sm, smem, sms, threads = out
  return {"tiles": tiles, "blocks": blocks, "blocks_per_sm": per_sm,
          "tiles_per_block": -(-tiles // blocks), "smem": smem, "sms": sms,
          "threads": threads, "tile": TILE if not chroma else
          (TILE[0], TILE[1] // 2)}


def _alf_cuda(planes, a, *, chroma, W, H, ctb_log2, bit_depth, luma,
              overlap=False, max_blocks=0, scalar=False):
  """One launch on the planes' device's current stream into a new
  (nch, Hp, Wp) tensor, which the launch writes whole.  overlap: a
  chroma launch may start while the luma launch queued just before it
  runs (csrc/alf.cu; alf_planes says when a caller may ask).  max_blocks
  (a cap on the grid) and scalar (4-byte copies only) serve the kernel's
  ablations (tools/alf_tiles.py)."""
  Hp, Wp = planes[0].shape
  dev = planes[0].device
  lib = _get_kernel()
  dst = torch.empty((len(planes), Hp, Wp), dtype=torch.int32, device=dev)
  g = a["ctb"]
  flags = (_F_SCALAR if scalar else 0) | (_F_OVERLAP if overlap else 0)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    if chroma:
      rc = lib.alf_chroma_launch(
          (ctypes.c_longlong * 2)(*(pl.data_ptr() for pl in planes)),
          dst.data_ptr(), Hp, Wp, luma.data_ptr(), *luma.shape, H, W,
          g.data_ptr(), g.shape[0], g.shape[1], a["chroma_coeff"].data_ptr(),
          a["chroma_clipv"].data_ptr(), a["cc_coeff"].data_ptr(), ctb_log2,
          bit_depth, max_blocks, flags, stream)
    else:
      rc = lib.alf_luma_launch(
          planes[0].data_ptr(), dst.data_ptr(), Hp, Wp, H, W, g.data_ptr(),
          g.shape[0], g.shape[1], a["banks_coeff"].data_ptr(),
          a["banks_clipv"].data_ptr(), a["banks_coeff"].shape[0], ctb_log2,
          bit_depth, max_blocks, flags, stream)
  if rc != 0:
    raise RuntimeError("alf kernel launch failed: "
                       f"{lib.alf_error_string(rc).decode()}")
  LAUNCHES["alf"] += 1
  OVERLAPS["alf"] += bool(chroma and overlap)
  return dst
