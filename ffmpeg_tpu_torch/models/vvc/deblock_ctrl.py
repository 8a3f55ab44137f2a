"""Deblock edge-parameter derivation (numpy, host side).

Builds per-edge grids (bs, qp, max filter lengths) from the TU records
(parity: vvc_deblock_bs* in vvc_filter.c:477-751) for the deblock ops
(ops/deblock.py), which filter all vertical edges and then all
horizontal edges (8.8.3.2).
"""
from __future__ import annotations

import numpy as np

from .host import FrameSyntax


def _tu_grids_cbf(fs: FrameSyntax, c_idx: int, g: int):
  """Per-g-sample grids (pos_x, pos_y, w, h, qp, cbf) for one
  component, filled TU by TU (the native pass, vvch_fo_deblock_grids,
  fills its own)."""
  ss = 0 if c_idx == 0 else 1
  W, H = fs.width >> ss, fs.height >> ss
  gw, gh = W // g, H // g
  qp_bd_offset = 6 * (fs.bit_depth - 8)
  pos_x = np.zeros((gh, gw), np.int32)
  pos_y = np.zeros((gh, gw), np.int32)
  tw = np.zeros((gh, gw), np.int32)
  th = np.zeros((gh, gw), np.int32)
  qp = np.zeros((gh, gw), np.int32)
  cbf = np.zeros((gh, gw), np.int32)
  sel = np.where(fs.tus["c_idx"] == c_idx)[0]
  jop = fs.tus.get("jop") if c_idx else None
  for j in sel:
    x0 = int(fs.tus["x0"][j])
    y0 = int(fs.tus["y0"][j])
    w = int(fs.tus["w"][j])
    h = int(fs.tus["h"][j])
    q = int(fs.tus["qp"][j]) - qp_bd_offset  # stored with bd offset
    ys, xs = y0 // g, x0 // g
    sl = (slice(ys, (y0 + h) // g), slice(xs, (x0 + w) // g))
    pos_x[sl] = x0
    pos_y[sl] = y0
    tw[sl] = w
    th[sl] = h
    qp[sl] = q
    if fs.tus["coded"][j] == 1 or (jop is not None and jop[j] > 0):
      cbf[sl] = 1
  return pos_x, pos_y, tw, th, qp, cbf


def _mv_far(ax, ay, bx, by):
  return (np.abs(ax - bx) >= 8) | (np.abs(ay - by) >= 8)


def _bs_between(motion_p, motion_q, cbf_p, cbf_q, pcmf_p=None,
                pcmf_q=None):
  """Luma bs core — full boundary_strength (vvc_filter.c:308-372).

  motion_*: dict with per-sample planes pf, m0x, m0y, p0 (L0 mv/refpoc),
  m1x, m1y, p1 (L1).
  """
  P, Q = motion_p, motion_q
  intra = (P["pf"] == 0) | (Q["pf"] == 0)
  cbf = (cbf_p | cbf_q) > 0

  both_bi = (P["pf"] == 3) & (Q["pf"] == 3)
  direct = (_mv_far(Q["m0x"], Q["m0y"], P["m0x"], P["m0y"])
            | _mv_far(Q["m1x"], Q["m1y"], P["m1x"], P["m1y"]))
  cross = (_mv_far(Q["m1x"], Q["m1y"], P["m0x"], P["m0y"])
           | _mv_far(Q["m0x"], Q["m0y"], P["m1x"], P["m1y"]))
  all_same = ((P["p0"] == Q["p0"]) & (P["p0"] == P["p1"])
              & (Q["p0"] == Q["p1"]))
  pair_direct = (Q["p0"] == P["p0"]) & (Q["p1"] == P["p1"])
  pair_cross = (Q["p1"] == P["p0"]) & (Q["p0"] == P["p1"])
  bs_bi = np.where(all_same, (direct & cross).astype(np.int32),
                   np.where(pair_direct, direct.astype(np.int32),
                            np.where(pair_cross, cross.astype(np.int32), 1)))

  both_uni = (P["pf"] != 3) & (Q["pf"] != 3)
  # single-MV sides: select the used list per sample
  pax = np.where(P["pf"] == 1, P["m0x"], P["m1x"])
  pay = np.where(P["pf"] == 1, P["m0y"], P["m1y"])
  ppoc = np.where(P["pf"] == 1, P["p0"], P["p1"])
  qax = np.where(Q["pf"] == 1, Q["m0x"], Q["m1x"])
  qay = np.where(Q["pf"] == 1, Q["m0y"], Q["m1y"])
  qpoc = np.where(Q["pf"] == 1, Q["p0"], Q["p1"])
  bs_uni = ((ppoc != qpoc) | _mv_far(pax, pay, qax, qay)).astype(np.int32)

  bs_mv = np.where(both_bi, bs_bi, np.where(both_uni, bs_uni, 1))
  bs = np.where(intra, 2, np.where(cbf, 1, bs_mv))
  if pcmf_p is not None:
    # both sides BDPCM -> no filtering (pcmf, vvc_filter.c:556,677)
    bs = np.where((pcmf_p & pcmf_q) > 0, 0, bs)
  return bs


def _sb_grids(fs: FrameSyntax):
  """Per-4-sample planes (flag, cb-start, cb-size) marking subblock-
  motion CUs (SbTMVP; tab.msf analog) in both edge orientations.
  Returns None when the frame has none (the common case)."""
  cus = fs.cus
  if cus is None or "sbtmvp" not in cus:
    return None
  sbf = (cus["sbtmvp"] > 0) | (cus.get("affine", 0) > 0)
  if not np.any(sbf):
    return None
  gw, gh = fs.width // 4, fs.height // 4
  msf = np.zeros((gh, gw), np.int32)
  cbx = np.zeros((gh, gw), np.int32)
  cby = np.zeros((gh, gw), np.int32)
  cbw = np.zeros((gh, gw), np.int32)
  cbh = np.zeros((gh, gw), np.int32)
  idx = np.where(sbf & (cus["pred_mode"] == 0))[0]
  for j in idx:
    x0, y0 = int(cus["x0"][j]), int(cus["y0"][j])
    w, h = int(cus["w"][j]), int(cus["h"][j])
    sl = (slice(y0 // 4, (y0 + h) // 4), slice(x0 // 4, (x0 + w) // 4))
    msf[sl] = 1
    cbx[sl] = x0
    cby[sl] = y0
    cbw[sl] = w
    cbh[sl] = h
  return {"v": (msf, cbx, cbw),
          "h": (msf.T.copy(), cby.T.copy(), cbh.T.copy())}


def _luma_edge_params(pos, tw, qp, motion, cbf, Sp: int, Ep: int,
                      pcmf=None, sb=None):
  """Vertical-orientation params on (S, E) grids from 4-granular planes.

  pos/tw/qp/cbf: (gh, gw) grids at 4-sample granularity (rows = segments).
  motion: (pf, mvx, mvy, refpoc) 4-granular planes.
  Returns bs, qp_avg, maxp, maxq zero-padded to (Sp, Ep).
  """
  gh, gw = pos.shape
  bs = np.zeros((Sp, Ep), np.int32)
  qpa = np.zeros((Sp, Ep), np.int32)
  maxp = np.zeros((Sp, Ep), np.int32)
  maxq = np.zeros((Sp, Ep), np.int32)
  e = np.arange(1, gw)
  is_edge = pos[:, 1:] == (e[None, :] * 4)  # TU starts here
  mp_side = {k: m[:, :-1] for k, m in motion.items()}
  mq_side = {k: m[:, 1:] for k, m in motion.items()}
  pp = pcmf[:, :-1] if pcmf is not None else None
  pq = pcmf[:, 1:] if pcmf is not None else None
  bs_v = _bs_between(mp_side, mq_side, cbf[:, :-1], cbf[:, 1:], pp, pq)
  bs[:gh, 1:gw] = np.where(is_edge, bs_v, 0)
  size_p = tw[:, :-1]
  size_q = tw[:, 1:]
  small = (size_p <= 4) | (size_q <= 4)
  mp = np.where(small, 1, np.where(size_p >= 32, 7, 3))
  mq = np.where(small, 1, np.where(size_q >= 32, 7, 3))
  if sb is not None:
    # subblock-motion CUs (SbTMVP): clamp at the CU-boundary edges and
    # add internal per-8-sample edges (derive_max_filter_length_luma +
    # vvc_deblock_subblock_bs_*, vvc_filter.c:374-478)
    msf, cb0, cbs_ = sb
    p_msf, q_msf = msf[:, :-1], msf[:, 1:]
    mp = np.where(p_msf > 0, np.minimum(mp, 5), mp)
    mq = np.where((q_msf > 0) & (cbs_[:, 1:] > 8), np.minimum(mq, 5), mq)
    maxp[:gh, 1:gw] = np.where(is_edge, mp, 0)
    maxq[:gh, 1:gw] = np.where(is_edge, mq, 0)
    dist = e[None, :] * 4 - cb0[:, 1:]
    internal = ((q_msf > 0) & ~is_edge & (dist > 0) & (dist % 8 == 0)
                & (dist < cbs_[:, 1:]))
    zero = np.zeros_like(cbf[:, 1:])
    bs_mv = _bs_between(mp_side, mq_side, zero, zero)
    bs[:gh, 1:gw] = np.where(internal, bs_mv, bs[:gh, 1:gw])
    il = np.where((dist == 8) | (dist == cbs_[:, 1:] - 8), 2, 3)
    maxp[:gh, 1:gw] = np.where(internal, il, maxp[:gh, 1:gw])
    maxq[:gh, 1:gw] = np.where(internal, il, maxq[:gh, 1:gw])
  else:
    maxp[:gh, 1:gw] = np.where(is_edge, mp, 0)
    maxq[:gh, 1:gw] = np.where(is_edge, mq, 0)
  qpa[:gh, 1:gw] = (qp[:, :-1] + qp[:, 1:] + 1) >> 1
  return bs, qpa, maxp, maxq


def _chroma_edge_params(pos, tw, qp, motion, cbf, Sp: int, Ep: int,
                        ctu_edge_cols=None, pcmf=None):
  """Vertical-orientation chroma params; grids at 2-sample granularity,
  edges every 8 chroma samples (= every 4 grid columns).
  motion/cbf are at the same 2-chroma-sample granularity."""
  gh, gw = pos.shape
  bs = np.zeros((Sp, Ep), np.int32)
  qpa = np.zeros((Sp, Ep), np.int32)
  maxp = np.zeros((Sp, Ep), np.int32)
  maxq = np.zeros((Sp, Ep), np.int32)
  n_e = (gw + 3) // 4  # edges at grid col 4e (chroma x = 8e), 4e < gw
  for e in range(1, n_e):
    c = 4 * e
    is_edge = pos[:, c] == 8 * e
    # chroma bs: intra -> 2, cbf -> 1, else 0 (no MV term; vvc_filter.c:737)
    pf_p = motion["pf"][:, c - 1]
    pf_q = motion["pf"][:, c]
    b0 = np.where((pf_p == 0) | (pf_q == 0), 2,
                  np.where((cbf[:, c - 1] | cbf[:, c]) > 0, 1, 0))
    if pcmf is not None:
      b0 = np.where((pcmf[:, c - 1] & pcmf[:, c]) > 0, 0, b0)
    b = np.where(is_edge, b0, 0)
    size_p = tw[:, c - 1]
    size_q = tw[:, c]
    big = (size_p >= 8) & (size_q >= 8)
    mp = np.where(big, 3, (b == 2).astype(np.int32))
    mq = np.where(big, 3, (b == 2).astype(np.int32))
    if ctu_edge_cols is not None and ctu_edge_cols[e]:
      mp = np.where(big, 1, mp)
    bs[:gh, e] = b
    maxp[:gh, e] = np.where(is_edge, mp, 0)
    maxq[:gh, e] = np.where(is_edge, mq, 0)
    qpa[:gh, e] = (qp[:, c - 1] + qp[:, c] + 1) >> 1
  return bs, qpa, maxp, maxq

