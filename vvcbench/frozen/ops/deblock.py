"""Deblocking filter: the deblock kernel and its plain versions.

Spec 8.8.3: all vertical edges of the picture are filtered first, then
all horizontal edges — a pair of full-plane passes; the horizontal pass
is the vertical one on the transposed plane.  The decision and filter
math is the JAX package's deblock ops' (`vvc_filter_template.c:466-760`
and `h2656_deblock_template.c`: luma weak/strong/large, chroma
weak/strong/one-sided), driven by per-edge parameter grids (bs, qp, max
filter lengths) built on the host (models/vvc/deblock_ctrl.py).

Layout: for the vertical pass, edges sit at x = G*e; each 4-row (luma)
or 2-row (4:2:0 chroma) segment of each edge has its own parameters.

`deblock_planes` is the frame program's entry point: both passes over a
luma plane, or over Cb and Cr together; `deblock_pass` runs one of them
(the band split of parallel/spatial.py).  A CUDA tensor launches the
kernel (csrc/deblock.cu: one launch, tiles of TILE x TILE samples with
their halo in shared memory, both passes there, each tile written once);
a CPU tensor runs the plain version (`deblock_planes_plain`,
`deblock_pass_plain`), the single-plane passes
`deblock_vertical_luma_plain` / `deblock_vertical_chroma_plain` (the
ports of the JAX functions, and the kernel's oracle) on each plane and
on the transposed view of its result.  `deblock_tiled_plain` is the
kernel's tiling run on the CPU.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .tables import on_device

# launches of the CUDA kernel, and runs of the plain version: plain
# integer counters a caller may reset to 0 and read back
LAUNCHES = {"deblock": 0}
PLAIN_RUNS = {"deblock": 0}

TCTABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 3, 4, 4, 4, 4, 5, 5, 5, 5, 7, 7, 8, 9, 10,
    10, 11, 13, 14, 15, 17, 19, 21, 24, 25, 29, 33, 36, 41, 45, 51,
    57, 64, 71, 80, 89, 100, 112, 125, 141, 157, 177, 198, 222, 250, 280, 314,
    352, 395], dtype=np.int32)

BETATABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88],
    dtype=np.int32)

MAX_QP = 63
DEFAULT_INTRA_TC_OFFSET = 2

# large-filter coefficient tables indexed by max_len in {3,5,7} -> idx 0/1/2
# (m_coef, ref_coef, tc_mult) per position 0..6 (vvc_filter_template.c:495-545)
LARGE_COEF_M = np.zeros((3, 7), np.int32)
LARGE_COEF_R = np.zeros((3, 7), np.int32)
LARGE_TC_MULT = np.zeros((3, 7), np.int32)
LARGE_COEF_M[0, :3] = [53, 32, 11]
LARGE_COEF_R[0, :3] = [11, 32, 53]
LARGE_TC_MULT[0, :3] = [6, 4, 2]
LARGE_COEF_M[1, :5] = [58, 45, 32, 19, 6]
LARGE_COEF_R[1, :5] = [6, 19, 32, 45, 58]
LARGE_TC_MULT[1, :5] = [6, 5, 4, 3, 2]
LARGE_COEF_M[2, :7] = [59, 50, 41, 32, 23, 14, 5]
LARGE_COEF_R[2, :7] = [5, 14, 23, 32, 41, 50, 59]
LARGE_TC_MULT[2, :7] = [6, 5, 4, 3, 2, 1, 1]


def _const(name, arr, device):
  return on_device(name, device, lambda: torch.from_numpy(arr))


def _tc_beta(bs, qp, bit_depth, beta_off, tc_off):
  dev = bs.device
  beta = _const("beta", BETATABLE, dev)[
      (qp + beta_off).clamp(0, MAX_QP).long()] << (bit_depth - 8)
  tc10 = _const("tc", TCTABLE, dev)[
      (qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + tc_off).clamp(
          0, MAX_QP + DEFAULT_INTRA_TC_OFFSET).long()]
  if bit_depth < 10:
    tc = (tc10 + (1 << (9 - bit_depth))) >> (10 - bit_depth)
  else:
    tc = tc10 << (bit_depth - 10)
  return tc.where(bs > 0, 0), beta


def _windows(plane, E, grid, width):
  """win[y, e, k] = plane[y, clip(grid*e + k - width//2)], and the
  column index it read."""
  H, W = plane.shape
  dev = plane.device
  xs = (torch.arange(E, device=dev)[None, :, None] * grid
        + torch.arange(width, device=dev)[None, None, :] - width // 2)
  xs = xs.clamp(0, W - 1)
  rows = torch.arange(H, device=dev)[:, None, None]
  return plane[rows, xs], rows, xs


def _scatter_delta(plane, rows, xs, delta):
  """Add each window's change back into the plane.  Where windows
  overlap the changes add up: two neighbouring edges' long filters can
  both change a sample, and at the plane's border several clamped window
  positions name the same last column (tests/test_torch_deblock.py holds
  the JAX function's scatter-add to the same sums there)."""
  out = plane.clone()
  out.index_put_((rows.expand_as(delta), xs.expand_as(delta)), delta,
                 accumulate=True)
  return out


def deblock_vertical_luma_plain(plane, bs, qp, maxp, maxq, hor_ctu_edge, *,
                                grid: int = 4, bit_depth: int = 8,
                                beta_off: int = 0, tc_off: int = 0):
  """One luma deblock pass over vertical edges (the port of JAX
  deblock_vertical_luma).

  plane: (H, W) int32 (any strides: a transposed view runs the
  horizontal pass), H % 4 == 0, W % grid == 0.
  bs/qp/maxp/maxq/hor_ctu_edge: (S, E) int32, S = H//4 segments,
    E = W//grid edges (edge e at x = grid*e; edge 0 must have bs 0).
    qp is the raw averaged QP; beta_off/tc_off are the effective
    slice/PH/PPS deblock offsets (already x2), applied to the table
    indices per spec 8.8.3.6.
  Returns the filtered plane.
  """
  H, W = plane.shape
  S, E = bs.shape
  maxv = (1 << bit_depth) - 1
  tc, beta = _tc_beta(bs, qp, bit_depth, beta_off, tc_off)
  win, rows, xs = _windows(plane, E, grid, 16)              # (H, E, 16)

  def P(i):  # p_i for all rows
    return win[..., 7 - i]

  def Q(i):
    return win[..., 8 + i]

  def seg_line(v, line):  # (H, E) -> (S, E) taking row 4*s + line
    return v.reshape(S, 4, E)[:, line, :]

  dp = (P(2) - 2 * P(1) + P(0)).abs()
  dq = (Q(2) - 2 * Q(1) + Q(0)).abs()
  dp0, dp3 = seg_line(dp, 0), seg_line(dp, 3)
  dq0, dq3 = seg_line(dq, 0), seg_line(dq, 3)
  d0 = dp0 + dq0
  d3 = dp3 + dq3
  tc25 = (tc * 5 + 1) >> 1
  beta_3 = beta >> 3
  beta_2 = beta >> 2

  large_p = (maxp > 3) & (hor_ctu_edge == 0)
  large_q = maxq > 3
  any_large = large_p | large_q
  mlp = torch.where(large_p, maxp, 3)
  mlq = torch.where(large_q, maxq, 3)

  # ---- large decision (per segment) --------------------------------
  dpl = (P(5) - 2 * P(4) + P(3)).abs()
  dql = (Q(5) - 2 * Q(4) + Q(3)).abs()
  dp0l = torch.where(large_p, (dp0 + seg_line(dpl, 0) + 1) >> 1, dp0)
  dp3l = torch.where(large_p, (dp3 + seg_line(dpl, 3) + 1) >> 1, dp3)
  dq0l = torch.where(large_q, (dq0 + seg_line(dql, 0) + 1) >> 1, dq0)
  dq3l = torch.where(large_q, (dq3 + seg_line(dql, 3) + 1) >> 1, dq3)
  d0l = dp0l + dq0l
  d3l = dp3l + dq3l
  beta53 = (beta * 3) >> 5
  beta_4 = beta >> 4

  def win_line(line):  # (S, E, 16)
    return win.reshape(S, 4, E, 16)[:, line]

  w0, w3 = win_line(0), win_line(3)

  def PL(wl, i):
    return wl[..., 7 - i]

  def QL(wl, i):
    return wl[..., 8 + i]

  def PL_dyn(wl, ml):  # wl[..., 7-ml]
    return torch.gather(wl, -1, (7 - ml).long()[..., None])[..., 0]

  def QL_dyn(wl, ml):
    return torch.gather(wl, -1, (8 + ml).long()[..., None])[..., 0]

  def sp_l(wl):
    return (PL(wl, 3) - PL(wl, 0)).abs() + torch.where(
        mlp == 7, (PL(wl, 7) - PL(wl, 6) - PL(wl, 5) + PL(wl, 4)).abs(), 0)

  def sq_l(wl):
    return (QL(wl, 0) - QL(wl, 3)).abs() + torch.where(
        mlq == 7, (QL(wl, 4) - QL(wl, 5) - QL(wl, 6) + QL(wl, 7)).abs(), 0)

  sp0l, sq0l, sp3l, sq3l = sp_l(w0), sq_l(w0), sp_l(w3), sq_l(w3)
  sp0 = torch.where(large_p, (sp0l + (PL(w0, 3) - PL_dyn(w0, mlp)).abs()
                              + 1) >> 1, sp0l)
  sp3 = torch.where(large_p, (sp3l + (PL(w3, 3) - PL_dyn(w3, mlp)).abs()
                              + 1) >> 1, sp3l)
  sq0 = torch.where(large_q, (sq0l + (QL(w0, 3) - QL_dyn(w0, mlq)).abs()
                              + 1) >> 1, sq0l)
  sq3 = torch.where(large_q, (sq3l + (QL(w3, 3) - QL_dyn(w3, mlq)).abs()
                              + 1) >> 1, sq3l)

  use_large = (any_large & (d0l + d3l < beta)
               & (sp0 + sq0 < beta53) & ((PL(w0, 0) - QL(w0, 0)).abs() < tc25)
               & (sp3 + sq3 < beta53) & ((PL(w3, 0) - QL(w3, 0)).abs() < tc25)
               & ((d0l << 1) < beta_4) & ((d3l << 1) < beta_4))

  # ---- strong/weak decision (per segment) --------------------------
  normal_pass = (d0 + d3 < beta) & ~use_large
  use_strong = (normal_pass & (maxp > 2) & (maxq > 2)
                & ((PL(w0, 3) - PL(w0, 0)).abs()
                   + (QL(w0, 3) - QL(w0, 0)).abs() < beta_3)
                & ((PL(w0, 0) - QL(w0, 0)).abs() < tc25)
                & ((PL(w3, 3) - PL(w3, 0)).abs()
                   + (QL(w3, 3) - QL(w3, 0)).abs() < beta_3)
                & ((PL(w3, 0) - QL(w3, 0)).abs() < tc25)
                & ((d0 << 1) < beta_2) & ((d3 << 1) < beta_2))
  use_weak = normal_pass & ~use_strong
  both = (maxp > 1) & (maxq > 1)
  side_lim = (beta + (beta >> 1)) >> 3
  nd_p = torch.where(both & (dp0 + dp3 < side_lim), 2, 1)
  nd_q = torch.where(both & (dq0 + dq3 < side_lim), 2, 1)

  active = tc > 0
  use_large = use_large & active
  use_strong = use_strong & active
  use_weak = use_weak & active

  def b(v):  # (S, E) -> (H, E)
    return v.repeat_interleave(4, dim=0)

  tc_r = b(tc)
  use_large_r, use_strong_r, use_weak_r = (b(use_large), b(use_strong),
                                           b(use_weak))
  mlp_r, mlq_r = b(mlp), b(mlq)
  nd_p_r, nd_q_r = b(nd_p), b(nd_q)

  # ---- large filter values (per row) -------------------------------
  p = [P(i) for i in range(8)]
  q = [Q(i) for i in range(8)]
  # middle value m: 6 variants selected by (mlp, mlq)
  m55 = (p[4] + p[3] + 2 * (p[2] + p[1] + p[0] + q[0] + q[1] + q[2])
         + q[3] + q[4] + 8) >> 4
  m77 = (p[6] + p[5] + p[4] + p[3] + p[2] + p[1] + 2 * (p[0] + q[0])
         + q[1] + q[2] + q[3] + q[4] + q[5] + q[6] + 8) >> 4
  m57 = (p[5] + p[4] + p[3] + p[2] + 2 * (p[1] + p[0] + q[0] + q[1])
         + q[2] + q[3] + q[4] + q[5] + 8) >> 4
  m_8 = (p[3] + p[2] + p[1] + p[0] + q[0] + q[1] + q[2] + q[3] + 4) >> 3
  m37 = (2 * (p[2] + p[1] + p[0] + q[0]) + p[0] + p[1]
         + q[1] + q[2] + q[3] + q[4] + q[5] + q[6] + 8) >> 4
  m73 = (p[6] + p[5] + p[4] + p[3] + p[2] + p[1]
         + 2 * (q[2] + q[1] + q[0] + p[0]) + q[0] + q[1] + 8) >> 4
  # jnp.select order: the first matching condition wins
  m = m73
  for cond, val in reversed([((mlp_r == 5) & (mlq_r == 5), m55),
                             (mlp_r == mlq_r, m77),
                             (mlp_r + mlq_r == 12, m57),
                             (mlp_r + mlq_r == 8, m_8),
                             (mlq_r == 7, m37)]):
    m = torch.where(cond, val, m)

  def row_dyn(idx):  # win[..., idx] with per-(row, edge) idx
    return torch.gather(win, -1, idx.long()[..., None])[..., 0]

  refp = (row_dyn(7 - mlp_r) + row_dyn(7 - (mlp_r - 1)) + 1) >> 1
  refq = (row_dyn(8 + mlq_r) + row_dyn(8 + mlq_r - 1) + 1) >> 1
  dev = plane.device
  cm = _const("lcm", LARGE_COEF_M, dev)
  cr = _const("lcr", LARGE_COEF_R, dev)
  ct = _const("ltc", LARGE_TC_MULT, dev)
  ip = ((mlp_r - 3) >> 1).clamp(0, 2).long()
  iq = ((mlq_r - 3) >> 1).clamp(0, 2).long()

  large_p_out, large_q_out = [], []
  for pos in range(7):
    lim_p = (tc_r * ct[ip, pos]) >> 1
    large_p_out.append(p[pos] + torch.clamp(
        ((m * cm[ip, pos] + refp * cr[ip, pos] + 32) >> 6) - p[pos],
        -lim_p, lim_p))
    lim_q = (tc_r * ct[iq, pos]) >> 1
    large_q_out.append(q[pos] + torch.clamp(
        ((m * cm[iq, pos] + refq * cr[iq, pos] + 32) >> 6) - q[pos],
        -lim_q, lim_q))

  # ---- strong filter values ----------------------------------------
  tc2_r, tc3_r = tc_r << 1, tc_r * 3

  def cl(v, lim):
    return torch.clamp(v, -lim, lim)

  sp0v = p[0] + cl(((p[2] + 2 * p[1] + 2 * p[0] + 2 * q[0] + q[1] + 4) >> 3)
                   - p[0], tc3_r)
  sp1v = p[1] + cl(((p[2] + p[1] + p[0] + q[0] + 2) >> 2) - p[1], tc2_r)
  sp2v = p[2] + cl(((2 * p[3] + 3 * p[2] + p[1] + p[0] + q[0] + 4) >> 3)
                   - p[2], tc_r)
  sq0v = q[0] + cl(((p[1] + 2 * p[0] + 2 * q[0] + 2 * q[1] + q[2] + 4) >> 3)
                   - q[0], tc3_r)
  sq1v = q[1] + cl(((p[0] + q[0] + q[1] + q[2] + 2) >> 2) - q[1], tc2_r)
  sq2v = q[2] + cl(((2 * q[3] + 3 * q[2] + q[1] + q[0] + p[0] + 4) >> 3)
                   - q[2], tc_r)

  # ---- weak filter values ------------------------------------------
  delta0 = (9 * (q[0] - p[0]) - 3 * (q[1] - p[1]) + 8) >> 4
  weak_ok = delta0.abs() < 10 * tc_r
  d0c = cl(delta0, tc_r)
  wp0 = (p[0] + d0c).clamp(0, maxv)
  wq0 = (q[0] - d0c).clamp(0, maxv)
  tc_2 = tc_r >> 1
  dp1 = cl((((p[2] + p[0] + 1) >> 1) - p[1] + d0c) >> 1, tc_2)
  wp1 = (p[1] + dp1).clamp(0, maxv)
  dq1 = cl((((q[2] + q[0] + 1) >> 1) - q[1] - d0c) >> 1, tc_2)
  wq1 = (q[1] + dq1).clamp(0, maxv)

  # ---- compose output windows --------------------------------------
  new_win = win.clone()
  for pos in range(7):
    k_p, k_q = 7 - pos, 8 + pos
    vp, vq = large_p_out[pos], large_q_out[pos]
    sel_p = use_large_r & (pos < mlp_r)
    sel_q = use_large_r & (pos < mlq_r)
    if pos < 3:
      vp = torch.where(use_strong_r, [sp0v, sp1v, sp2v][pos], vp)
      vq = torch.where(use_strong_r, [sq0v, sq1v, sq2v][pos], vq)
      sel_p = sel_p | use_strong_r
      sel_q = sel_q | use_strong_r
    if pos < 2:
      sel_p_w = use_weak_r & weak_ok & ((pos == 0) | (nd_p_r > 1))
      sel_q_w = use_weak_r & weak_ok & ((pos == 0) | (nd_q_r > 1))
      vp = torch.where(sel_p_w, [wp0, wp1][pos], vp)
      vq = torch.where(sel_q_w, [wq0, wq1][pos], vq)
      sel_p = sel_p | sel_p_w
      sel_q = sel_q | sel_q_w
    new_win[..., k_p] = torch.where(sel_p, vp, new_win[..., k_p])
    new_win[..., k_q] = torch.where(sel_q, vq, new_win[..., k_q])
  return _scatter_delta(plane, rows, xs, new_win - win)


def deblock_vertical_chroma_plain(plane, bs, qp, maxp, maxq, *,
                                  bit_depth: int = 8, beta_off: int = 0,
                                  tc_off: int = 0):
  """One 4:2:0 chroma deblock pass over vertical edges (the port of JAX
  deblock_vertical_chroma).

  plane: (H, W) int32 chroma plane, H % 2 == 0, W % 8 == 0.
  bs/qp/maxp/maxq: (S, E) int32; S = H//2 two-row segments, E = W//8
  edges (edge e at x = 8*e — the chroma deblock grid is 8 samples).
  maxp is pre-demoted to 1 at horizontal CTU edges by the caller
  (max_filter_length_chroma).
  """
  S, E = bs.shape
  maxv = (1 << bit_depth) - 1
  tc, beta = _tc_beta(bs, qp, bit_depth, beta_off, tc_off)
  win, rows, xs = _windows(plane, E, 8, 8)                  # (H, E, 8)

  def P(i):
    return win[..., 3 - i]

  def Q(i):
    return win[..., 4 + i]

  def win_line(line):  # decision lines 0 and 1 of each 2-row segment
    return win.reshape(S, 2, E, 8)[:, line]

  w0, w1 = win_line(0), win_line(1)

  def PL(wl, i):
    return wl[..., 3 - i]

  def QL(wl, i):
    return wl[..., 4 + i]

  tc25 = (tc * 5 + 1) >> 1
  beta_3 = beta >> 3
  beta_2 = beta >> 2
  active = (tc > 0) & (maxp > 0) & (maxq > 0)

  # decision for maxq == 3 (vvc_filter_template.c:700-735)
  one = maxp == 1
  p2_0 = torch.where(one, PL(w0, 1), PL(w0, 2))
  p3_0 = torch.where(one, PL(w0, 1), PL(w0, 3))
  p2_1 = torch.where(one, PL(w1, 1), PL(w1, 2))
  p3_1 = torch.where(one, PL(w1, 1), PL(w1, 3))
  dp0 = (p2_0 - 2 * PL(w0, 1) + PL(w0, 0)).abs()
  dq0 = (QL(w0, 2) - 2 * QL(w0, 1) + QL(w0, 0)).abs()
  dp1 = (p2_1 - 2 * PL(w1, 1) + PL(w1, 0)).abs()
  dq1 = (QL(w1, 2) - 2 * QL(w1, 1) + QL(w1, 0)).abs()
  d0 = dp0 + dq0
  d1 = dp1 + dq1
  dsam0 = (((d0 << 1) < beta_2)
           & ((p3_0 - PL(w0, 0)).abs() + (QL(w0, 0) - QL(w0, 3)).abs()
              < beta_3)
           & ((PL(w0, 0) - QL(w0, 0)).abs() < tc25))
  dsam1 = (((d1 << 1) < beta_2)
           & ((p3_1 - PL(w1, 0)).abs() + (QL(w1, 0) - QL(w1, 3)).abs()
              < beta_3)
           & ((PL(w1, 0) - QL(w1, 0)).abs() < tc25))
  keep3 = (maxq == 3) & (d0 + d1 < beta) & dsam0 & dsam1
  demote = (maxq == 3) & ~keep3
  mlp = torch.where(demote, 1, maxp)
  mlq = torch.where(demote, 1, maxq)

  use_strong = active & (mlp == 3) & (mlq == 3)
  use_one_side = active & (mlq == 3) & ~use_strong
  use_weak = active & (mlq != 3)

  def b(v):
    return v.repeat_interleave(2, dim=0)

  tc_r = b(tc)
  strong_r, oneside_r, weak_r = b(use_strong), b(use_one_side), b(use_weak)

  p0, p1, p2, p3 = P(0), P(1), P(2), P(3)
  q0, q1, q2, q3 = Q(0), Q(1), Q(2), Q(3)

  def cl(v, c):
    return torch.minimum(torch.maximum(v, c - tc_r), c + tc_r)

  # strong (both sides)
  st_p0 = cl((p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0)
  st_p1 = cl((2 * p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3, p1)
  st_p2 = cl((3 * p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
  st_q0 = cl((p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0)
  st_q1 = cl((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3, q1)
  st_q2 = cl((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3, q2)
  # one-sided strong
  os_p0 = cl((3 * p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0)
  os_q0 = cl((2 * p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0)
  os_q1 = cl((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3, q1)
  os_q2 = cl((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3, q2)
  # weak
  wd = torch.clamp((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc_r, tc_r)
  wk_p0 = (p0 + wd).clamp(0, maxv)
  wk_q0 = (q0 - wd).clamp(0, maxv)

  def select3(v_st, v_os, v_wk, dflt):
    return torch.where(strong_r, v_st, torch.where(
        oneside_r, v_os, torch.where(weak_r, v_wk, dflt)))

  any_r = strong_r | oneside_r | weak_r
  upd = [
      (3, select3(st_p0, os_p0, wk_p0, p0), any_r),
      (2, st_p1, strong_r),
      (1, st_p2, strong_r),
      (4, select3(st_q0, os_q0, wk_q0, q0), any_r),
      (5, torch.where(strong_r, st_q1, os_q1), strong_r | oneside_r),
      (6, torch.where(strong_r, st_q2, os_q2), strong_r | oneside_r),
  ]
  new_win = win.clone()
  for k, val, sel in upd:
    new_win[..., k] = torch.where(sel, val, new_win[..., k])
  return _scatter_delta(plane, rows, xs, new_win - win)


# ----------------------------------------------------------------------
# the entry points, their plain versions, and the CUDA kernel
# (csrc/deblock.cu), built with nvcc at first use and bound with ctypes
# ----------------------------------------------------------------------

# The kernel's tiles: a thread block owns TILE x TILE output samples of
# one plane and reads them with a halo of HALO[kind] samples on each side
# (csrc/deblock.cu gets both at build time; deblock_tiled_plain is its
# algorithm on the CPU).  A halo is a multiple of the kind's edge
# spacing and covers the windows of the edges that write into the tile.
TILE = 48
HALO = {"luma": 12, "chroma": 8}
# per kind: edge spacing, lines per segment, window samples read on each
# side of an edge, and the samples written before it and from it on
# less one (the kernel's Kind<C>::G, SEG, N / 2, WP, WQ)
_GEOM = {"luma": (4, 4, 8, 7, 6), "chroma": (8, 2, 4, 3, 2)}


def _check(planes, grids_v, grids_h, chroma, beta_off, tc_off):
  """Shapes and types the kernel takes, on every device: 1 luma or 1-2
  chroma (H, W) int32 contiguous planes of one shape and device, and per
  plane the (S, E) int32 contiguous grids of each pass that runs: the
  vertical pass's laid out for the plane, the horizontal pass's for its
  transpose."""
  nch = len(planes)
  if not 1 <= nch <= (2 if chroma else 1):
    raise ValueError(f"deblock: {nch} planes for a "
                     f"{'chroma' if chroma else 'luma'} call")
  if grids_v is None and grids_h is None:
    raise ValueError("deblock: no pass to run")
  if not (len(beta_off) == len(tc_off) == nch) or any(
      g is not None and len(g) != nch for g in (grids_v, grids_h)):
    raise ValueError("deblock: one grid tuple and one offset pair per plane")
  H, W = planes[0].shape
  seg, grid = (2, 8) if chroma else (4, 4)
  dev = planes[0].device
  for grids, (rows, cols) in ((grids_v, (H, W)), (grids_h, (W, H))):
    if grids is None:
      continue
    if rows % seg or cols % grid:
      raise ValueError(f"deblock: a {rows}x{cols} view is not whole "
                       f"{seg}-line segments and {grid}-sample edges")
    S, E = rows // seg, cols // grid
    for pl, g in zip(planes, grids):
      if len(g) != (4 if chroma else 5):
        raise ValueError(f"deblock: {len(g)} grids per plane")
      for t, shape in ((pl, (H, W)), *((x, (S, E)) for x in g)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
            or tuple(t.shape) != shape or t.device != dev:
          raise ValueError(
              f"deblock: expected contiguous int32 {shape} on {dev}, got "
              f"{t.dtype} {tuple(t.shape)} on {t.device}")


def deblock_planes(planes, grids_v, grids_h, *, chroma: bool, bit_depth: int,
                   beta_off, tc_off):
  """Deblock a luma plane, or the Cb and Cr planes: the vertical edges,
  then the horizontal edges of the result, in one launch.

  planes: [luma], or [Cb, Cr] (or one chroma plane), (H, W) int32
  contiguous.
  grids_v, grids_h: per plane (bs, qp, maxp, maxq, hor_ctu_edge) for luma
  or (bs, qp, maxp, maxq) for chroma, (S, E) int32: the vertical pass's
  laid out for the plane, luma (H/4, W/4) or chroma (H/2, W/8), the
  horizontal pass's for its transpose, luma (W/4, H/4) or chroma (W/2,
  H/8); None for a pass that does not run (deblock_pass).
  beta_off, tc_off: per plane, the effective offsets (already x2).
  Returns the filtered planes, (nch, H, W) int32, a new tensor.  A CUDA
  tensor launches the kernel; a CPU tensor runs the plain version;
  nothing falls back from one to the other."""
  _check(planes, grids_v, grids_h, chroma, beta_off, tc_off)
  dev = planes[0].device
  kw = dict(chroma=chroma, bit_depth=bit_depth, beta_off=beta_off,
            tc_off=tc_off)
  if dev.type == "cuda":
    return _deblock_cuda(planes, grids_v, grids_h, **kw)
  if dev.type != "cpu":
    raise ValueError(f"deblock: unsupported device {dev}")
  return deblock_planes_plain(planes, grids_v, grids_h, **kw)


def deblock_planes_plain(planes, grids_v, grids_h, *, chroma: bool,
                         bit_depth: int, beta_off, tc_off):
  """deblock_planes's plain version, with its arguments and result: the
  single-plane passes on each plane, vertical, then horizontal on the
  transposed view of its result."""
  PLAIN_RUNS["deblock"] += 1
  fn = deblock_vertical_chroma_plain if chroma else deblock_vertical_luma_plain
  out = []
  for c, (pl, bo, to) in enumerate(zip(planes, beta_off, tc_off)):
    kw = dict(bit_depth=bit_depth, beta_off=bo, tc_off=to)
    if grids_v is not None:
      pl = fn(pl, *grids_v[c], **kw)
    if grids_h is not None:
      pl = fn(pl.T, *grids_h[c], **kw).T
    out.append(pl)
  return torch.stack(out)


def deblock_pass(planes, grids, *, chroma: bool, horizontal: bool,
                 bit_depth: int, beta_off, tc_off):
  """One pass of deblock_planes: the vertical (or, with horizontal, the
  horizontal) edges alone, grids laid out for that pass as there; the
  same kernel in a one-pass mode.  Returns (nch, H, W) int32."""
  return deblock_planes(planes, None if horizontal else grids,
                        grids if horizontal else None, chroma=chroma,
                        bit_depth=bit_depth, beta_off=beta_off,
                        tc_off=tc_off)


def deblock_pass_plain(planes, grids, *, chroma: bool, horizontal: bool,
                       bit_depth: int, beta_off, tc_off):
  """deblock_pass's plain version, with its arguments and result."""
  return deblock_planes_plain(planes, None if horizontal else grids,
                              grids if horizontal else None, chroma=chroma,
                              bit_depth=bit_depth, beta_off=beta_off,
                              tc_off=tc_off)


def _edge_range(a, n_edges, kind):
  """The edges [lo, hi] whose written samples reach [a, a + TILE) of an
  axis with n_edges edges (the kernel's edge_range)."""
  G, _, _, WP, WQ = _GEOM[kind]
  return max(0, -((WQ - a) // G)), min(n_edges - 1, (a + TILE - 1 + WP) // G)


def _tile_grids(grids, seg, grid, y0, y1, x0, x1, segs, edges):
  """grids of a pass cut to the sub-plane [y0, y1) x [x0, x1) of its
  view, with bs 0 outside segments [segs) and edges [edges]."""
  out = [g[y0 // seg:y1 // seg, x0 // grid:x1 // grid] for g in grids]
  keep = torch.zeros_like(out[0], dtype=torch.bool)
  keep[segs[0] - y0 // seg:segs[1] - y0 // seg,
       edges[0] - x0 // grid:edges[1] + 1 - x0 // grid] = True
  return (out[0].where(keep, 0),) + tuple(out[1:])


def deblock_tiled_plain(planes, grids_v, grids_h, *, chroma: bool,
                        bit_depth: int, beta_off, tc_off):
  """The kernel's algorithm on the CPU: deblock_planes (or one pass, with
  the other's grids None) tile by tile.  Each TILE x TILE tile is cut
  from the plane with its halo (clipped to the plane), the plain passes
  run on that sub-plane with the grids cut to it, the edges kept that
  the kernel filters (the others set to bs 0), and the tile's interior
  is kept.  Equal to the whole-plane passes when the halo and the
  kernel's edge and row ranges suffice (tests/test_torch_deblock.py)."""
  kind = "chroma" if chroma else "luma"
  G, SEG, R, _, _ = _GEOM[kind]
  h = HALO[kind]
  fn = deblock_vertical_chroma_plain if chroma else deblock_vertical_luma_plain
  H, W = planes[0].shape
  out = torch.empty((len(planes), H, W), dtype=torch.int32)
  for r0 in range(0, H, TILE):
    r1 = min(H, r0 + TILE)
    for c0 in range(0, W, TILE):
      c1 = min(W, c0 + TILE)
      y0, y1 = (max(0, r0 - h), min(H, r1 + h)) if grids_h is not None \
          else (r0, r1)
      x0, x1 = (max(0, c0 - h), min(W, c1 + h)) if grids_v is not None \
          else (c0, c1)
      if grids_h is not None:
        eh = _edge_range(r0, H // G, kind)
        sh = (c0 // SEG, -(-c1 // SEG))
      for c, (pl, bo, to) in enumerate(zip(planes, beta_off, tc_off)):
        kw = dict(bit_depth=bit_depth, beta_off=bo, tc_off=to)
        sub = pl[y0:y1, x0:x1]
        if grids_v is not None:
          # the rows the horizontal pass reads, or the tile's own
          v0, v1 = (max(0, min(r0, G * eh[0] - R)), min(H, max(r1, G * eh[1]
                                                              + R))) \
              if grids_h is not None else (r0, r1)
          g = _tile_grids(grids_v[c], SEG, G, y0, y1, x0, x1,
                          (v0 // SEG, -(-v1 // SEG)),
                          _edge_range(c0, W // G, kind))
          sub = fn(sub, *g, **kw)
        if grids_h is not None:
          g = _tile_grids(grids_h[c], SEG, G, x0, x1, y0, y1, sh, eh)
          sub = fn(sub.T, *g, **kw).T
        out[c, r0:r1, c0:c1] = sub[r0 - y0:r1 - y0, c0 - x0:c1 - x0]
  return out


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "deblock.cu")
_lib = None


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("deblock", [_SRC], defines=(
        ("DEBLOCK_TILE", TILE), ("DEBLOCK_HALO_LUMA", HALO["luma"]),
        ("DEBLOCK_HALO_CHROMA", HALO["chroma"]))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.deblock_launch.restype = ctypes.c_int
    lib.deblock_launch.argtypes = [
        p, p, i, i, i, i,   # src pointers (nch,), dst, nch, H, W, chroma
        p, i, i,            # vertical grid pointers (nch x 4 or 5), S, E
        p, i, i,            # horizontal grid pointers, S, E
        p, p, i,            # beta_off, tc_off (nch,), bit_depth
        p, p, p, p, p,      # TCTABLE, BETATABLE, LARGE_COEF_M/R, TC_MULT
        p]                  # stream
    lib.deblock_error_string.restype = ctypes.c_char_p
    lib.deblock_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


def _deblock_cuda(planes, grids_v, grids_h, *, chroma, bit_depth, beta_off,
                  tc_off):
  """One launch on the planes' device's current stream into a new
  (nch, H, W) tensor, which every thread block writes its tile of."""
  nch = len(planes)
  H, W = planes[0].shape
  dev = planes[0].device
  lib = _get_kernel()
  dst = torch.empty((nch, H, W), dtype=torch.int32, device=dev)

  def ptrs(grids):
    if grids is None:
      return None, 0, 0
    flat = [t.data_ptr() for g in grids for t in g]
    return ((ctypes.c_longlong * len(flat))(*flat),
            *grids[0][0].shape)

  ints = ctypes.c_int * nch
  tabs = [_const(n, a, dev).data_ptr() for n, a in (
      ("tc", TCTABLE), ("beta", BETATABLE), ("lcm", LARGE_COEF_M),
      ("lcr", LARGE_COEF_R), ("ltc", LARGE_TC_MULT))]
  with torch.cuda.device(dev):
    rc = lib.deblock_launch(
        (ctypes.c_longlong * nch)(*(pl.data_ptr() for pl in planes)),
        dst.data_ptr(), nch, H, W, int(chroma), *ptrs(grids_v),
        *ptrs(grids_h), ints(*beta_off), ints(*tc_off), bit_depth, *tabs,
        torch.cuda.current_stream(dev).cuda_stream)
  if rc != 0:
    raise RuntimeError("deblock kernel launch failed: "
                       f"{lib.deblock_error_string(rc).decode()}")
  LAUNCHES["deblock"] += 1
  return dst
