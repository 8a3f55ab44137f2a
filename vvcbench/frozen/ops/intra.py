"""Intra prediction as batched int32 torch ops over reference edges.

Bit-exact port of the JAX package's intra ops (spec 8.4.5.2; parity
target `vvc_intra_template.c:450-1015` and `vvc_intra.c:529-714`):
reference-sample gathering with availability substitution, the [1 2 1]
reference filter, negative-angle projection, planar/DC/V/H/angular
prediction with the 4-tap luma and 2-tap chroma interpolation, PDPC,
MIP and CCLM.

Every function works on a batch of N units at once (one wavefront
chunk): per-unit scalars are (N,) int32 tensors, edges are (N, L)
vectors and predictions (N, maxs, maxs) blocks whose valid region
(h, w) the caller masks.  Edges have origin OFF:
  top[:, OFF + j]  = reference row sample at x0 + j
  left[:, OFF + j] = reference column sample at y0 + j
with OFF = 2*maxs + 8 and L = 5*maxs + 16.  These are the plain
versions that the recon kernel (csrc/recon.cu) is held against.
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import VVC_TABLES as _TABLES
from .tables import on_device

INTRA_LUMA_FILTER = _TABLES["intra_luma_filter"].astype(np.int32)  # (2,32,4)

# mode classes (the control row `mode_class`)
MC_PLANAR, MC_DC, MC_VERT, MC_HORZ, MC_ANG_V, MC_ANG_H = range(6)


def _mip_bank() -> np.ndarray:
  """One combined MIP matrix bank padded to (30, 64, 8): rows 0..15 =
  size-id 0 (16x4 used), 16..23 = size-id 1 (16x8), 24..29 = size-id 2
  (64x7)."""
  bank = np.zeros((30, 64, 8), np.int32)
  bank[0:16, :16, :4] = _TABLES["mip_0"].astype(np.int32)   # (16, 16, 4)
  bank[16:24, :16, :8] = _TABLES["mip_1"].astype(np.int32)  # (8, 16, 8)
  bank[24:30, :64, :7] = _TABLES["mip_2"].astype(np.int32)  # (6, 64, 7)
  return bank


MIP_BANK = _mip_bank()

CCLM_DIV_SIG = np.array([0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0],
                        np.int32)

_I32 = torch.int32


def _const(name, arr, device):
  return on_device(name, device, lambda: torch.from_numpy(arr))


def edge_len(maxs: int) -> tuple[int, int]:
  return 5 * maxs + 16, 2 * maxs + 8  # (length, OFF)


def _ar(n, device):
  return torch.arange(n, dtype=_I32, device=device)


def _take(vec, idx):
  """vec (N, L), idx (N, ...) -> vec[n, idx[n, ...]]."""
  n = vec.shape[0]
  return torch.gather(vec, 1, idx.long().reshape(n, -1)).reshape(idx.shape)


def _sh(val, like):
  """Scalar `val` as a tensor shaped like `like` (for `val << t`)."""
  return torch.full_like(like, val)


def _ilog2f(v):
  """log2 of a power-of-two int, as the JAX ops take it (round(log2))."""
  return torch.round(torch.log2(v.to(torch.float32))).to(_I32)


def edge_arrays(plane, x0, y0, maxs: int, avail_l, avail_t, cand_up_left,
                mid_val: int, ref_idx=None):
  """Gather + substitute reference samples (parity
  prepare_intra_edge_params, vvc_intra_template.c:467-548).  ref_idx
  selects the MRL reference line: edges read row y0-1-r / column
  x0-1-r, and the corner region spans lanes [-1-r, -1]."""
  L, OFF = edge_len(maxs)
  H, W = plane.shape
  dev = plane.device
  flat = plane.reshape(-1)
  r = torch.zeros_like(x0) if ref_idx is None else ref_idx
  r1 = r[:, None]
  j = (_ar(L, dev) - OFF)[None, :]
  neg = torch.maximum(torch.minimum(j, _sh(-1, j)), -1 - r1)
  joff = torch.where(j >= 0, torch.minimum(j, avail_t[:, None] - 1), neg)
  top_iy = (y0 - 1 - r).clamp(0, H - 1)[:, None]

  def at(yy, xx):
    return flat[(yy * W + xx).long()]

  top_raw = at(top_iy, (x0[:, None] + joff).clamp(0, W - 1))
  joff_l = torch.where(j >= 0, torch.minimum(j, avail_l[:, None] - 1), neg)
  left_ix = (x0 - 1 - r).clamp(0, W - 1)[:, None]
  left_raw = at((y0[:, None] + joff_l).clamp(0, H - 1), left_ix)

  top0 = at(top_iy, x0[:, None].clamp(0, W - 1))
  left0 = at(y0[:, None].clamp(0, H - 1), left_ix)
  al, at_, cul = avail_l[:, None], avail_t[:, None], cand_up_left[:, None]
  fallback = torch.where(al > 0, left0,
                         torch.where(at_ > 0, top0, _sh(mid_val, top0)))
  top_m1 = torch.where(cul > 0, at(top_iy, (x0[:, None] - 1).clamp(0, W - 1)),
                       fallback)
  left_m1 = torch.where(cul > 0,
                        at((y0[:, None] - 1).clamp(0, H - 1), left_ix),
                        fallback)
  top = torch.where(j >= 0, torch.where(at_ > 0, top_raw, top_m1),
                    torch.where(cul > 0, top_raw, fallback))
  left = torch.where(j >= 0, torch.where(al > 0, left_raw, left_m1),
                     torch.where(cul > 0, left_raw, fallback))
  return left.to(_I32), top.to(_I32)


def ref_filter_121(left, top, OFF: int, left_size, top_size,
                   unfilter_last_one):
  """[1 2 1]/4 reference smoothing (vvc_intra_template.c:450-466); the
  neighbours wrap at the vector ends like jnp.roll."""
  corner = (left[:, OFF] + 2 * left[:, OFF - 1] + top[:, OFF] + 2) >> 2
  j = (_ar(left.shape[1], left.device) - OFF)[None, :]

  def filt(a):
    return (torch.roll(a, 1, 1) + 2 * a + torch.roll(a, -1, 1) + 2) >> 2

  nl = (left_size - unfilter_last_one)[:, None]
  nt = (top_size - unfilter_last_one)[:, None]
  left_o = torch.where((j >= 0) & (j < nl), filt(left), left)
  top_o = torch.where((j >= 0) & (j < nt), filt(top), top)
  left_o[:, OFF - 1] = corner
  top_o[:, OFF - 1] = corner
  return left_o, top_o


def project_negative_angle(dst, src, OFF: int, inv_angle, limit,
                           ref_idx=None):
  """Negative-angle projection (vvc_intra_template.c:566-583):
  dst[x-1-r] = src[-1-r + min((x*invAngle + 256) >> 9, limit)],
  x in [-limit, -1)."""
  L = dst.shape[1]
  r = (torch.zeros_like(limit) if ref_idx is None else ref_idx)[:, None]
  t = (_ar(L, dst.device) - OFF)[None, :]
  xx = t + 1 + r
  sidx = OFF - 1 - r + torch.minimum((xx * inv_angle[:, None] + 256) >> 9,
                                     limit[:, None])
  proj = _take(src, sidx.clamp(0, L - 1))
  sel = (t >= -limit[:, None] - 1 - r) & (t <= -2 - r)
  return torch.where(sel, proj, dst)


def _yx(maxs, device):
  a = _ar(maxs, device)
  return a[None, :, None], a[None, None, :]


def _c(v):
  return v[:, None, None]


def pred_planar(top, left, OFF: int, maxs: int, w, h, logw, logh):
  y, x = _yx(maxs, top.device)
  t = top[:, None, OFF:OFF + maxs]
  lv = left[:, OFF:OFF + maxs, None]
  tr = _c(_take(top, OFF + w))    # top-right
  bl = _c(_take(left, OFF + h))   # bottom-left
  w, h, logw, logh = _c(w), _c(h), _c(logw), _c(logh)
  pv = ((h - 1 - y) * t + (y + 1) * bl) << logw
  ph = ((w - 1 - x) * lv + (x + 1) * tr) << logh
  return (pv + ph + w * h) >> (logw + logh + 1)


def pred_dc(top, left, OFF: int, maxs: int, w, h):
  i = _ar(maxs, top.device)[None, :]
  zero = torch.zeros_like(top[:, OFF:OFF + maxs])
  sum_t = torch.where(i < w[:, None], top[:, OFF:OFF + maxs], zero).sum(1)
  sum_l = torch.where(i < h[:, None], left[:, OFF:OFF + maxs], zero).sum(1)
  s = (torch.where(w >= h, sum_t, 0) + torch.where(w <= h, sum_l, 0)).to(_I32)
  offset = torch.where(w == h, w << 1, torch.maximum(w, h)).clamp(min=1)
  dc = (s + (offset >> 1)) >> _ilog2f(offset)
  return _c(dc).expand(-1, maxs, maxs).contiguous()


def pred_v(top, OFF: int, maxs: int):
  return top[:, None, OFF:OFF + maxs].expand(-1, maxs, maxs).contiguous()


def pred_h(left, OFF: int, maxs: int):
  return left[:, OFF:OFF + maxs, None].expand(-1, maxs, maxs).contiguous()


def _angular_core(main, OFF: int, maxs: int, angle, filter_flag,
                  is_chroma: bool, clip_max: int, ref_idx):
  """Line i (0..maxs-1) of the prediction from `main`:
  pos = (i+1+ref_idx)*angle; idx = pos>>5; fact = pos&31."""
  i, x = _yx(maxs, main.device)
  pos = (i + 1 + _c(ref_idx)) * _c(angle)
  idx = pos >> 5
  fact = pos & 31
  base = OFF + x + idx
  L = main.shape[1]
  p = [_take(main, (base + k - 1).clamp(0, L - 1)) for k in range(4)]
  if is_chroma:
    interp = ((32 - fact) * p[1] + fact * p[2] + 16) >> 5
    use_copy = fact == 0
  else:
    ftab = _const("luma_filter", INTRA_LUMA_FILTER, main.device)
    f = ftab[_c(filter_flag).expand_as(fact).long(), fact.long()]
    acc = (f[..., 0] * p[0] + f[..., 1] * p[1]
           + f[..., 2] * p[2] + f[..., 3] * p[3] + 32) >> 6
    interp = acc.clamp(0, clip_max)
    use_copy = (fact == 0) & (_c(filter_flag) == 0)
  return torch.where(use_copy, p[1], interp).to(_I32)


def pred_angular_v(top, left, OFF: int, maxs: int, w, h, angle, inv_angle,
                   filter_flag, do_pdpc, ns, is_chroma: bool, clip_max: int,
                   ref_idx):
  pred = _angular_core(top, OFF, maxs, angle, filter_flag, is_chroma,
                       clip_max, ref_idx)
  y, x = _yx(maxs, top.device)
  inv_sum = 256 + _c(inv_angle) * (x + 1)
  lv = _take(left, (OFF + y + (inv_sum >> 9)).clamp(0, left.shape[1] - 1))
  ns = _c(ns)
  wl = _sh(32, pred) >> torch.minimum((x << 1) >> ns, _sh(31, pred))
  val = (pred + (((lv - pred) * wl + 32) >> 6)).clamp(0, clip_max)
  lim = torch.minimum(_c(w), _sh(3, ns) << ns)
  out = torch.where(x < lim, val, pred)
  return torch.where(_c(do_pdpc) > 0, out, pred)


def pred_angular_h(top, left, OFF: int, maxs: int, w, h, angle, inv_angle,
                   filter_flag, do_pdpc, ns, is_chroma: bool, clip_max: int,
                   ref_idx):
  pred = _angular_core(left, OFF, maxs, angle, filter_flag, is_chroma,
                       clip_max, ref_idx).transpose(1, 2)
  y, x = _yx(maxs, top.device)
  inv_sum = 256 + _c(inv_angle) * (y + 1)
  tv = _take(top, (OFF + x + (inv_sum >> 9)).clamp(0, top.shape[1] - 1))
  ns = _c(ns)
  wt = _sh(32, pred) >> torch.minimum((y * 2) >> ns, _sh(31, pred))
  val = (pred + (((tv - pred) * wt + 32) >> 6)).clamp(0, clip_max)
  lim = torch.minimum(_c(h), _sh(3, ns) << ns)
  out = torch.where(y < lim, val, pred)
  return torch.where(_c(do_pdpc) > 0, out, pred)


def pdpc_hvdc(pred, top, left, OFF: int, maxs: int, logw, logh, mode_class,
              clip_max: int):
  """PDPC for planar/DC/V/H (vvc_intra_template.c:652-683)."""
  scale = _c((logw + logh - 2) >> 2)
  y, x = _yx(maxs, pred.device)
  lv = left[:, OFF:OFF + maxs, None]
  tv = top[:, None, OFF:OFF + maxs]
  corner_l = _c(left[:, OFF - 1])
  corner_t = _c(top[:, OFF - 1])
  mc = _c(mode_class)
  is_vh = (mc == MC_VERT) | (mc == MC_HORZ)
  lq = torch.where(is_vh, lv - corner_l + pred, lv)
  tq = torch.where(is_vh, tv - corner_t + pred, tv)
  c32, c31 = _sh(32, pred), _sh(31, pred)
  wl = torch.where(mc == MC_HORZ, 0, c32 >> torch.minimum((x << 1) >> scale,
                                                          c31))
  wt = torch.where(mc == MC_VERT, 0, c32 >> torch.minimum((y << 1) >> scale,
                                                          c31))
  out = pred + ((wl * (lq - pred) + wt * (tq - pred) + 32) >> 6)
  return out.clamp(0, clip_max)


def pred_mip(top, left, OFF: int, maxs: int, w, h, mip_id, mip_t, size_id,
             bit_depth: int, clip_max: int):
  """MIP prediction (spec 8.4.5.2.2; parity pred_mip,
  vvc_intra_template.c:708-825) of (N, maxs, maxs) blocks."""
  dev = top.device
  N = top.shape[0]
  bsz = torch.where(size_id == 0, 2, 4).to(_I32)
  ps = torch.where(size_id == 2, 8, 4).to(_I32)
  in_size = torch.where(size_id == 0, 4,
                        torch.where(size_id == 2, 7, 8)).to(_I32)
  jj = _ar(maxs, dev)
  i4 = _ar(4, dev)

  def downsample(vals, n):
    # reduced[i] = (sum of group i + ratio/2) >> log2(ratio)
    ratio = n // bsz
    lg = _ilog2f(ratio)
    grp = jj[None, :] >> lg[:, None]                             # (N, maxs)
    m = (jj[None, None, :] < n[:, None, None]) & (
        grp[:, None, :] == i4[None, :, None])                    # (N, 4, maxs)
    sums = torch.where(m, vals[:, None, :], 0).sum(2).to(_I32)
    return (sums + (ratio >> 1)[:, None]) >> lg[:, None]         # (N, 4)

  red_t = downsample(top[:, OFF:OFF + maxs], w)
  red_l = downsample(left[:, OFF:OFF + maxs], h)
  tr = (mip_t > 0)[:, None]
  first = torch.where(tr, red_l, red_t)
  second = torch.where(tr, red_t, red_l)
  i8 = _ar(8, dev)[None, :].expand(N, 8)
  r8 = torch.where(i8 < bsz[:, None], _take(first, i8.clamp(0, 3)),
                   _take(second, (i8 - bsz[:, None]).clamp(0, 3)))
  temp0 = r8[:, :1]
  mid = 1 << (bit_depth - 1)
  v = torch.where((size_id == 2)[:, None], _take(r8, (i8 + 1).clamp(0, 7))
                  - temp0, torch.where(i8 == 0, mid - temp0, r8 - temp0))
  v = torch.where(i8 < in_size[:, None], v, 0)
  ow = 32 - 32 * v.sum(1, keepdim=True).to(_I32)
  mat = _const("mip_bank", MIP_BANK, dev)[mip_id.clamp(0, 29).long()]
  predv = ((mat * v[:, None, :]).sum(2).to(_I32) + ow) >> 6
  predv = (predv + temp0).clamp(0, clip_max)                     # (N, 64)

  y8, x8 = _ar(8, dev)[None, :, None], _ar(8, dev)[None, None, :]
  p8 = _take(predv, (y8 * _c(ps) + x8).clamp(0, 63))
  p8 = torch.where(_c(mip_t) > 0, p8.transpose(1, 2), p8)       # (N, 8, 8)

  # upsampling (mip_upsampling_1d): horizontal over the ps rows that
  # hold predRed, then vertical over all w columns
  uh, uv = w // ps, h // ps
  lg_h, lg_v = _c(_ilog2f(uh)), _c(_ilog2f(uv))
  uh, uv = _c(uh), _c(uv)
  x = _ar(maxs, dev)[None, None, :]
  yr = _ar(8, dev)[None, :, None]
  k = x >> lg_h
  dx = (x & (uh - 1)) + 1
  brow = _take(left, OFF + ((yr + 1) * uv - 1).clamp(0, maxs - 1))
  full8 = (N, 8, maxs)
  pa = torch.where(k == 0, brow, torch.gather(
      p8, 2, (k - 1).clamp(0, 7).expand(full8).long()))
  pb = torch.gather(p8, 2, k.clamp(0, 7).expand(full8).long())
  tmp = ((uh - dx) * pa + dx * pb + (uh >> 1)) >> lg_h          # (N, 8, maxs)

  y = _ar(maxs, dev)[None, :, None]
  ky = y >> lg_v
  dy = (y & (uv - 1)) + 1
  trow = top[:, None, OFF:OFF + maxs]
  fullm = (N, maxs, maxs)
  ca = torch.where(ky == 0, trow, torch.gather(
      tmp, 1, (ky - 1).clamp(0, 7).expand(fullm).long()))
  cb = torch.gather(tmp, 1, ky.clamp(0, 7).expand(fullm).long())
  return (((uv - dy) * ca + dy * cb + (uv >> 1)) >> lg_v).to(_I32)


# ----------------------------------------------------------------------
# CCLM — cross-component linear model (spec 8.4.5.2.14; parity
# intra_cclm_pred, vvc_intra_template.c:29-375).  The luma plane is
# fully reconstructed before chroma recon starts, so the collocated
# downsample is one whole-plane stencil and the boundary picks are
# small gathers.
# ----------------------------------------------------------------------

def cclm_dsy_plane(luma, vc: int, col_bds=(), row_bds=()):
  """Downsampled collocated luma at chroma resolution (4:2:0), full
  plane (cclm_get_luma_rec_pixels).  Picture-edge clamping at x=0 /
  y=0 reproduces the per-block avail_l/avail_t replication; interior
  tile boundaries (col_bds/row_bds, luma samples) replicate the same
  way.  `vc` is sps_chroma_vertical_collocated_flag."""
  lm1 = torch.cat([luma[:, :1], luma[:, :-1]], dim=1)   # x-1
  tm1 = torch.cat([luma[:1, :], luma[:-1, :]], dim=0)   # y-1
  for bx in col_bds:
    lm1[:, bx] = luma[:, bx]
  for by in row_bds:
    tm1[by, :] = luma[by, :]
  c0 = luma[0::2, 0::2]
  c1 = luma[1::2, 0::2]
  r0 = luma[0::2, 1::2]
  r1 = luma[1::2, 1::2]
  l0 = lm1[0::2, 0::2]
  l1 = lm1[1::2, 0::2]
  t0 = tm1[0::2, 0::2]
  if vc > 0:
    return (l0 + t0 + 4 * c0 + r0 + c1 + 4) >> 3
  return (l0 + l1 + 2 * (c0 + c1) + r0 + r1 + 4) >> 3


def cclm_select_luma(luma, x0, y0, cnt_t, pos, vc, b_ctu, avl, avt):
  """The 4 downsampled boundary luma picks (cclm_select_luma) of N
  units -> (N, 4).  x0/y0: chroma coords; pos: (N, 4) packed positions
  (cnt_t top picks then left picks); avl/avt: binary luma
  availability; b_ctu: the block starts at a CTU row (line-buffer
  single-row top filter)."""
  H, W = luma.shape
  flat = luma.reshape(-1)

  def at(yy, xx):
    return flat[(yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()]

  c = lambda v: v[:, None]  # noqa: E731
  i4 = _ar(4, luma.device)[None, :]
  is_top = i4 < c(cnt_t)
  lx0, ly0 = c(2 * x0), c(2 * y0)
  xa = lx0 + 2 * pos
  hl = (2 * pos > 0) | (c(avl) > 0)
  lt_r1 = torch.where(hl, at(ly0 - 1, xa - 1), at(ly0 - 1, xa))
  sel_ctu = (lt_r1 + 2 * at(ly0 - 1, xa) + at(ly0 - 1, xa + 1) + 2) >> 2
  lt_r2 = torch.where(hl, at(ly0 - 2, xa - 1), at(ly0 - 2, xa))
  sel_vc = (at(ly0 - 3, xa) + lt_r2 + 4 * at(ly0 - 2, xa)
            + at(ly0 - 2, xa + 1) + at(ly0 - 1, xa) + 4) >> 3
  sel_6 = (lt_r2 + lt_r1 + 2 * (at(ly0 - 2, xa) + at(ly0 - 1, xa))
           + at(ly0 - 2, xa + 1) + at(ly0 - 1, xa + 1) + 4) >> 3
  sel_top = torch.where(c(b_ctu) > 0, sel_ctu,
                        torch.where(c(vc) > 0, sel_vc, sel_6))
  ya = ly0 + 2 * pos
  ht = (2 * pos > 0) | (c(avt) > 0)
  tv = torch.where(ht, at(ya - 1, lx0 - 2), at(ya, lx0 - 2))
  sel_l_vc = (at(ya, lx0 - 3) + tv + 4 * at(ya, lx0 - 2)
              + at(ya, lx0 - 1) + at(ya + 1, lx0 - 2) + 4) >> 3
  sel_l_6 = (at(ya, lx0 - 3) + at(ya + 1, lx0 - 3)
             + 2 * (at(ya, lx0 - 2) + at(ya + 1, lx0 - 2))
             + at(ya, lx0 - 1) + at(ya + 1, lx0 - 1) + 4) >> 3
  sel_left = torch.where(c(vc) > 0, sel_l_vc, sel_l_6)
  return torch.where(is_top, sel_top, sel_left).to(_I32)


def _cclm_log2(v):
  """floor(log2(v)) for v in [1, 2^12) via compares (branch-free)."""
  acc = torch.zeros_like(v)
  for k in range(1, 12):
    acc = acc + (v >= (1 << k)).to(_I32)
  return acc


def cclm_get_params(sel_l, sel_c, n_sel, bit_depth: int):
  """(a, k, b) model parameters, each (N,), for one chroma channel
  (cclm_get_min_max + cclm_get_params).  sel_l/sel_c: (N, 4) picks,
  already 2-sample-reordered; n_sel: (N,) total picks."""
  mid = 1 << (bit_depth - 1)
  v = [(sel_l[:, i], sel_c[:, i]) for i in range(4)]

  def swap_if(cond, a, b):
    return ((torch.where(cond, b[0], a[0]), torch.where(cond, b[1], a[1])),
            (torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])))

  # 4-element min/max network, payload swapped in lockstep
  mi0, mi1, ma0, ma1 = v[0], v[2], v[1], v[3]
  mi0, mi1 = swap_if(mi0[0] > mi1[0], mi0, mi1)
  ma0, ma1 = swap_if(ma0[0] > ma1[0], ma0, ma1)
  c3 = mi0[0] > ma1[0]
  mi0, ma0 = swap_if(c3, mi0, ma0)
  mi1, ma1 = swap_if(c3, mi1, ma1)
  mi1, ma0 = swap_if(mi1[0] > ma0[0], mi1, ma0)
  max_l = (ma0[0] + ma1[0] + 1) >> 1
  min_l = (mi0[0] + mi1[0] + 1) >> 1
  max_c = (ma0[1] + ma1[1] + 1) >> 1
  min_c = (mi0[1] + mi1[1] + 1) >> 1

  diff = max_l - min_l
  diffc = max_c - min_c
  x = _cclm_log2(diff.clamp(min=1))
  norm_diff = ((diff << 4) >> x) & 15
  x = x + (norm_diff != 0).to(_I32)
  absc = diffc.abs()
  y = torch.where(absc > 0, _cclm_log2(absc.clamp(min=1)) + 1, 0).to(_I32)
  vdiv = _const("cclm_div", CCLM_DIV_SIG, sel_l.device)[norm_diff.long()] | 8
  add = (_sh(1, y) << y) >> 1
  a = (diffc * vdiv + add) >> y
  k = (3 + x - y).clamp(min=1)
  a = torch.where((3 + x - y) < 1, torch.sign(a) * 15, a)
  b = min_c - ((a * min_l) >> k)
  # diff == 0 -> flat model; no picks -> mid fill
  a = torch.where(diff == 0, 0, a)
  k = torch.where(diff == 0, 0, k)
  b = torch.where(diff == 0, min_c, b)
  a = torch.where(n_sel == 0, 0, a)
  k = torch.where(n_sel == 0, 0, k)
  b = torch.where(n_sel == 0, mid, b)
  return a.to(_I32), k.to(_I32), b.to(_I32)


def cclm_reorder2(sel):
  """cnt==2 pick reorder (cclm_select_samples tail): [s0,s1] ->
  [s1,s0,s1,s0]."""
  return sel[:, [1, 0, 1, 0]]
