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
kernel (csrc/alf.cu: one launch per call, TILE x TILE tiles with their
halo in shared memory, each sample written once); a CPU tensor runs the
plain version, `alf_planes_plain`, composed of the whole-plane passes
below (the ports of the JAX functions, and the kernel's oracle), which
take exact picture-size (H, W) int32 planes.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

_I32 = torch.int32

# launches of the CUDA kernel, and runs of the plain version: plain
# integer counters a caller may reset to 0 and read back
LAUNCHES = {"alf": 0}
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

# The kernel's tiles: a thread block owns TILE x TILE output samples of
# one plane (csrc/alf.cu gets it at build time) and reads them with a
# clamped halo of 3 luma or 2 chroma samples, beside the collocated luma.
TILE = 32


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
               bit_depth: int, luma=None):
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
  pre-ALF padded luma plane that CC-ALF reads.
  Returns the filtered planes, (nch, Hp, Wp) int32, a new tensor: the
  picture filtered, the padding copied.  A CUDA tensor launches the
  kernel; a CPU tensor runs the plain version; nothing falls back from
  one to the other."""
  _check(planes, alf, chroma, W, H, ctb_log2, bit_depth, luma)
  dev = planes[0].device
  kw = dict(chroma=chroma, W=W, H=H, ctb_log2=ctb_log2, bit_depth=bit_depth,
            luma=luma)
  if dev.type == "cuda":
    return _alf_cuda(planes, alf, **kw)
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


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "alf.cu")
_lib = None


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("alf", [_SRC],
                                 defines=(("ALF_TILE", TILE),)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.alf_luma_launch.restype = ctypes.c_int
    lib.alf_luma_launch.argtypes = [
        p, p, i, i, i, i,   # src, dst, Hp, Wp, H, W
        p, i, i,            # ctb grid, cbh, cbw
        p, p, i,            # banks_coeff, banks_clipv, bank count
        i, i, p]            # ctb_log2, bit_depth, stream
    lib.alf_chroma_launch.restype = ctypes.c_int
    lib.alf_chroma_launch.argtypes = [
        p, p, i, i,         # src pointers (2,), dst, Hp, Wp
        p, i, i, i, i,      # pre-ALF luma, its Hp, Wp; H, W (luma)
        p, i, i,            # ctb grid, cbh, cbw
        p, p, p,            # chroma_coeff, chroma_clipv, cc_coeff
        i, i, p]            # ctb_log2, bit_depth, stream
    lib.alf_error_string.restype = ctypes.c_char_p
    lib.alf_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


def _alf_cuda(planes, a, *, chroma, W, H, ctb_log2, bit_depth, luma):
  """One launch on the planes' device's current stream into a new
  (nch, Hp, Wp) tensor, which every thread block writes its tile of."""
  Hp, Wp = planes[0].shape
  dev = planes[0].device
  lib = _get_kernel()
  dst = torch.empty((len(planes), Hp, Wp), dtype=torch.int32, device=dev)
  g = a["ctb"]
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    if chroma:
      rc = lib.alf_chroma_launch(
          (ctypes.c_longlong * 2)(*(pl.data_ptr() for pl in planes)),
          dst.data_ptr(), Hp, Wp, luma.data_ptr(), *luma.shape, H, W,
          g.data_ptr(), g.shape[0], g.shape[1], a["chroma_coeff"].data_ptr(),
          a["chroma_clipv"].data_ptr(), a["cc_coeff"].data_ptr(), ctb_log2,
          bit_depth, stream)
    else:
      rc = lib.alf_luma_launch(
          planes[0].data_ptr(), dst.data_ptr(), Hp, Wp, H, W, g.data_ptr(),
          g.shape[0], g.shape[1], a["banks_coeff"].data_ptr(),
          a["banks_clipv"].data_ptr(), a["banks_coeff"].shape[0], ctb_log2,
          bit_depth, stream)
  if rc != 0:
    raise RuntimeError("alf kernel launch failed: "
                       f"{lib.alf_error_string(rc).decode()}")
  LAUNCHES["alf"] += 1
  return dst
