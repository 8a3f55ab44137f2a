"""Host half of a frame decode: FrameSyntax -> numpy input tree.

Numpy port of the JAX frame program's host-input assembly
(build_host_inputs with its LMCS and ALF tables, _layout_ctrl,
_pallas_ctrl's inter index, _gpm_weight_blocks, _bucket_inputs,
_deblock_grids).  The tree has the same structure and the same per-unit
and per-TU rows as the JAX builder's non-Pallas tree.  Arrays are sized
to this frame's exact counts: eager torch has no compiled program whose
shapes would need to stay fixed across frames.

Streams outside the port's slices are refused here, loudly
(`check_supported`), naming the ROADMAP item that will add them.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ...ops.tables import VVC_TABLES
from ...ops.transform import BUCKET_ROWS, LEVEL_SCALE, dequant_scale_shift
from .host import CHUNK_CAP, FrameSyntax, _get_lib
from .mc_tiles import MC_TILE, offsets
from .recon import CTRL_KEYS, _round_up

# TU size classes per plane kind (w, h): the port's residual
# buckets (ISP and 64-point classes come with their ROADMAP items)
LUMA_SIZES = [(w, h) for w in (4, 8, 16, 32) for h in (4, 8, 16, 32)]
CHROMA_SIZES = [(w, h) for w in (2, 4, 8, 16, 32) for h in (2, 4, 8, 16, 32)]

# control rows of the MC batch (the JAX frame program's INTER_KEYS); the
# last five are DMVR's: its flag and the original, unrefined MVs, around
# which the unit's reads are clamped
INTER_KEYS = ("x0", "y0", "w", "h", "pf", "m0x", "m0y", "m1x", "m1y",
              "r0slot", "r1slot", "wden", "w0", "w1", "wo0", "wo1",
              "hpel", "hyp0lx", "hyp1lx",
              "gpm_part", "gpm_tx", "gpm_ty", "gpm_lw", "gpm_lh",
              "w0b", "w1b", "wo0b", "wo1b",
              "prof", "pdhx0", "pdhy0", "pdvx0", "pdvy0",
              "pdhx1", "pdhy1", "pdvx1", "pdvy1", "bdof",
              "dmvr", "om0x", "om0y", "om1x", "om1y")

# the inter kernel's small units: at most SMALL_AREA samples, counted
# over at least 4 x 4 (csrc/inter_pred.cu SMALL_AREA)
SMALL_AREA = 64

# control rows the intra pass reads (the JAX frame program's INTRA_KEYS,
# with the CIIP motion and blend rows)
INTRA_KEYS = ("x0", "y0", "w", "h", "logw", "logh", "mode_class", "angle",
              "inv_angle", "filter_flag", "smooth", "left_size", "top_size",
              "unfilter_last_one", "do_pdpc", "nscale", "avail_l", "avail_t",
              "cand_up_left", "proj_v", "proj_h",
              "pf", "m0x", "m0y", "m1x", "m1y", "r0slot", "r1slot",
              "wden", "w0", "w1", "wo0", "wo1", "hpel", "ciipw",
              "hyp0lx", "hyp1lx",
              "mip_id", "mip_t", "mip_sz",
              "cclm", "cclm_vc", "cclm_ct", "cclm_cl",
              "cclm_p0", "cclm_p1", "cclm_p2", "cclm_p3",
              "mrl")


def check_supported(fs: FrameSyntax) -> None:
  """Raise NotImplementedError for every stream feature the port does
  not decode (never decode such a frame wrongly or fall back)."""
  refusals = [
      (fs.chroma_format_idc not in (0, 1),
       f"chroma_format_idc {fs.chroma_format_idc}: only 4:2:0 and 4:0:0"),
      (bool(fs.has_isp), "ISP: ROADMAP 'Still to port' #2"),
      (bool(fs.has_tb64), "64-sample transform blocks (TB-64): ROADMAP "
       "'Still to port' #2"),
      (fs.sl is not None, "explicit scaling lists: ROADMAP 'Still to "
       "port' #5"),
  ]
  for bad, what in refusals:
    if bad:
      raise NotImplementedError(f"poc {fs.poc}: {what}")
  for ctrl in (fs.ctrl_y, fs.ctrl_c):
    if ctrl is not None and ctrl.size and (
        (ctrl[CTRL_KEYS.index("w")] > MC_TILE).any()
        or (ctrl[CTRL_KEYS.index("h")] > MC_TILE).any()):
      raise NotImplementedError(
          f"poc {fs.poc}: 64-wide units: ROADMAP 'Still to port' #2")


def _padded_plane_shapes(W, H, ctb_log2):
  maxs_y = 1 << ctb_log2
  Hp_y = _round_up(H, 128) + maxs_y
  Wp_y = _round_up(W, 128) + maxs_y
  Hp_c = _round_up(H >> 1, 64) + (maxs_y >> 1)
  Wp_c = _round_up(W >> 1, 64) + (maxs_y >> 1)
  return (Hp_y, Wp_y), (Hp_c, Wp_c)


_QP_TAB_OFF = 32  # tables cover qp in [-32, 95]
_SCALE_SHIFT_TABLES: dict = {}
_SCSH_CACHE: dict = {}


def _scale_shift_tables_ts():
  """Transform-skip dequant: flat scale, bd_shift = 10 (derive_qp /
  derive_scale, vvc_intra.c; rect factor never applies)."""
  key = "ts"
  if key not in _SCALE_SHIFT_TABLES:
    qps = range(-_QP_TAB_OFF, 96)
    sc = np.zeros(len(qps), np.int32)
    sh = np.full(len(qps), 10, np.int32)
    for i, qp in enumerate(qps):
      if qp >= 0:
        sc[i] = int(LEVEL_SCALE[0][qp % 6]) << (qp // 6)
    _SCALE_SHIFT_TABLES[key] = (sc, sh)
  return _SCALE_SHIFT_TABLES[key]


def _scale_shift_tables(lw, lh, bit_depth, dep_quant=False):
  """Vectorized dequant scale/shift lookup over qp (spec 8.7.3);
  index with qp + _QP_TAB_OFF."""
  key = (lw, lh, bit_depth, dep_quant)
  if key not in _SCALE_SHIFT_TABLES:
    qps = range(-_QP_TAB_OFF, 96)
    sc = np.zeros(len(qps), np.int32)
    sh = np.zeros(len(qps), np.int32)
    for i, qp in enumerate(qps):
      if qp + (1 if dep_quant else 0) < 0:
        sc[i], sh[i] = 0, 1  # qp//6 < 0: unreachable for parsed Qp' values
      else:
        sc[i], sh[i] = dequant_scale_shift(qp, lw, lh, bit_depth,
                                           dep_quant=dep_quant)
    _SCALE_SHIFT_TABLES[key] = (sc, sh)
  return _SCALE_SHIFT_TABLES[key]


def _scsh_blob(sizes, bit_depth, dep_quant):
  """(n_sizes, 4, 128) dequant table blob for the native bucket filler:
  [sc, sh, sc_ts, sh_ts] per size class, indexed by qp_deq + 32."""
  key = (tuple(sizes), bit_depth, dep_quant)
  if key not in _SCSH_CACHE:
    blob = np.empty((len(sizes), 4, 128), np.int32)
    sc_ts, sh_ts = _scale_shift_tables_ts()
    for k, (w, h) in enumerate(sizes):
      sc, sh = _scale_shift_tables(w.bit_length() - 1, h.bit_length() - 1,
                                   bit_depth, dep_quant=dep_quant)
      blob[k, 0], blob[k, 1], blob[k, 2], blob[k, 3] = sc, sh, sc_ts, sh_ts
    _SCSH_CACHE[key] = np.ascontiguousarray(blob)
  return _SCSH_CACHE[key]


def _bucket_inputs(fs: FrameSyntax, c_idx: int, sizes):
  """Size-bucketed residual batches, filled by the native parser
  (vvch_fo_fill_buckets): one (len(BUCKET_ROWS), n) scalar matrix and
  one (n, h, w) int16 level-block array per size class, at exactly
  the frame's TU count per class."""
  lib = _get_lib()
  n_sizes = len(sizes)
  sizes_arr = np.ascontiguousarray(np.array(sizes, np.int32))
  counts = np.zeros(n_sizes, np.int32)
  i32p = ctypes.POINTER(ctypes.c_int32)
  fo = fs.fo.ptr
  lib.vvch_fo_bucket_counts(fo, c_idx, n_sizes,
                            sizes_arr.ctypes.data_as(i32p),
                            counts.ctypes.data_as(i32p))
  # the filler writes at most caps[k] rows per class: caps == counts
  caps = np.ascontiguousarray(counts.copy())
  scsh = _scsh_blob(sizes, fs.bit_depth, bool(fs.dep_quant))
  mats = [np.zeros((len(BUCKET_ROWS), max(cap, 1)), np.int32) for cap in caps]
  lvs = [np.zeros((max(cap, 1), h, w), np.int16)
         for cap, (w, h) in zip(caps, sizes)]
  slots = fs.slots_y if c_idx == 0 else fs.slots_c
  has_slots = slots is not None and len(slots)
  rc = lib.vvch_fo_fill_buckets(
      fo, c_idx, n_sizes,
      sizes_arr.ctypes.data_as(i32p), caps.ctypes.data_as(i32p),
      scsh.ctypes.data_as(i32p),
      slots.ctypes.data_as(i32p) if has_slots else None,
      (ctypes.c_void_p * n_sizes)(*[m.ctypes.data for m in mats]),
      (ctypes.c_void_p * n_sizes)(*[lv.ctypes.data for lv in lvs]))
  assert rc == 0, (
      f"bucket fill failed (plane {c_idx}): capacity model violated or "
      f"coded TU size outside the bucket list {sizes}")
  return {(w, h): {"mat": mats[k][:, :caps[k]], "lv": lvs[k][:caps[k]],
                   "n": counts[k:k + 1]}
          for k, (w, h) in enumerate(sizes)}


def _deblock_grids(fs: FrameSyntax, Hp_y, Wp_y, Hp_c, Wp_c, ctb_log2):
  from . import deblock_ctrl as D

  ctb = 1 << ctb_log2
  y_pos_x, y_pos_y, y_w, y_h, y_qp, cbf_y = D._tu_grids_cbf(fs, 0, 4)
  mvf = fs.mvf

  def refpoc(ref_plane, lx):
    outp = np.full_like(ref_plane, -(10 ** 6) - lx)
    for i, poc in enumerate(fs.ref_pocs[lx]):
      outp[ref_plane == i] = poc
    return outp.astype(np.int32)

  motion = {
      # CIIP cells count as intra for boundary strength (the bs-2 rule
      # is "P or Q intra or ciip", vvc_filter.c:537)
      "pf": np.where(np.asarray(mvf.get("ciip", 0)) > 0, 0,
                     mvf["pf"]).astype(np.int32),
      "m0x": mvf["mv_x"].astype(np.int32),
      "m0y": mvf["mv_y"].astype(np.int32),
      "p0": refpoc(mvf["ref"], 0),
      "m1x": mvf["mv1_x"].astype(np.int32),
      "m1y": mvf["mv1_y"].astype(np.int32),
      "p1": refpoc(mvf["ref1"], 1),
  }
  motion_t = {k: m.T for k, m in motion.items()}

  def pcmf_plane(want_c, g):
    if "pcmf" not in fs.tus or not np.any(fs.tus["pcmf"]):
      return None
    ss = 0 if want_c == 0 else 1
    gw = (fs.width >> ss) // g
    gh = (fs.height >> ss) // g
    pl = np.zeros((gh, gw), np.int32)
    sel = np.where((fs.tus["c_idx"] == want_c) & (fs.tus["pcmf"] == 1))[0]
    for j in sel:
      x0, y0 = int(fs.tus["x0"][j]), int(fs.tus["y0"][j])
      w, h = int(fs.tus["w"][j]), int(fs.tus["h"][j])
      pl[y0 // g:(y0 + h) // g, x0 // g:(x0 + w) // g] = 1
    return pl

  pcmf_y = pcmf_plane(0, 4)
  pcmf_c = pcmf_plane(1, 2)  # CB records mark the shared chroma plane
  d = {}
  Sv, Ev = Hp_y // 4, Wp_y // 4
  sbg = D._sb_grids(fs)
  d["ybs_v"], d["yqp_v"], d["ymp_v"], d["ymq_v"] = D._luma_edge_params(
      y_pos_x, y_w, y_qp, motion, cbf_y, Sv, Ev, pcmf_y,
      sb=None if sbg is None else sbg["v"])
  d["yhor0"] = np.zeros((Sv, Ev), np.int32)
  Sh, Eh = Wp_y // 4, Hp_y // 4
  d["ybs_h"], d["yqp_h"], d["ymp_h"], d["ymq_h"] = D._luma_edge_params(
      y_pos_y.T, y_h.T, y_qp.T, motion_t, cbf_y.T, Sh, Eh,
      pcmf_y.T if pcmf_y is not None else None,
      sb=None if sbg is None else sbg["h"])
  hor = np.zeros((Sh, Eh), np.int32)
  hor[:, :] = (((np.arange(Eh) * 4) % ctb) == 0)[None, :]
  d["yhor"] = hor
  for c_idx in () if fs.chroma_format_idc == 0 else (1, 2):
    pos_x, pos_y, tw, th, qpc, cbf_c = D._tu_grids_cbf(fs, c_idx, 2)
    Sv, Ev = Hp_c // 2, Wp_c // 8
    (d[f"c{c_idx}bs_v"], d[f"c{c_idx}qp_v"], d[f"c{c_idx}mp_v"],
     d[f"c{c_idx}mq_v"]) = D._chroma_edge_params(pos_x, tw, qpc, motion,
                                                 cbf_c, Sv, Ev,
                                                 pcmf=pcmf_c)
    Sh, Eh = Wp_c // 2, Hp_c // 8
    ctu_cols = ((np.arange(Eh) * 8 * 2) % ctb) == 0
    (d[f"c{c_idx}bs_h"], d[f"c{c_idx}qp_h"], d[f"c{c_idx}mp_h"],
     d[f"c{c_idx}mq_h"]) = D._chroma_edge_params(
         pos_y.T, th.T, qpc.T, motion_t, cbf_c.T, Sh, Eh,
         ctu_edge_cols=ctu_cols,
         pcmf=pcmf_c.T if pcmf_c is not None else None)
  # every grid value is tiny (bs 0-2, max filter lengths <= 7, averaged
  # qp in [-32, 63], CTU-edge flags): int8 halves nothing on the device
  # but a quarter of the host->device bytes
  return {k: v.astype(np.int8) for k, v in d.items()}


_GPM_W_CACHE: dict = {}


def _gpm_weight_plane(part: int, W: int, H: int):
  """Per-CU GPM luma blend weights, sliced from the normative tables
  (pred_gpm_blk, vvc_inter.c:466-496; tables vvc_data.c:1998-3486)."""
  key = (part, W, H)
  if key not in _GPM_W_CACHE:
    T = VVC_TABLES
    aidx = int(T["gpm_angle_idx"][part])
    wi = int(T["gpm_angle_to_weights_idx"][aidx])
    mt = int(T["gpm_angle_to_mirror"][aidx])
    hh, ww = H.bit_length() - 4, W.bit_length() - 4
    ox = int(T["gpm_weights_offset_x"][part][hh][ww])
    oy = int(T["gpm_weights_offset_y"][part][hh][ww])
    GW = 112
    wt = T["gpm_weights"].reshape(6, GW, GW).astype(np.int32)
    y = np.arange(H)[:, None]
    x = np.arange(W)[None, :]
    if mt == 0:
      w = wt[wi][oy + y, ox + x]
    elif mt == 1:
      w = wt[wi][oy + y, GW - 1 - ox - x]
    else:
      w = wt[wi][GW - 1 - oy - y, ox + x]
    _GPM_W_CACHE[key] = np.ascontiguousarray(w)
  return _GPM_W_CACHE[key]


def _gpm_weight_blocks(inter, ss, S=MC_TILE):
  """(n_gpm or 1, S, S) per-GPM-unit weight tiles + the per-MC-row
  index into them (0 for units that are not GPM)."""
  part = inter["gpm_part"]
  sel = np.flatnonzero(part > 0)
  gwt = np.zeros((max(len(sel), 1), S, S), np.int32)
  gslot = np.zeros(len(part), np.int32)
  for j, r in enumerate(sel):
    wfull = _gpm_weight_plane(int(part[r]) - 1, 1 << int(inter["gpm_lw"][r]),
                              1 << int(inter["gpm_lh"][r]))
    tx = int(inter["gpm_tx"][r]) << ss   # luma coords
    ty = int(inter["gpm_ty"][r]) << ss
    h_u = min(S, int(inter["h"][r]))
    w_u = min(S, int(inter["w"][r]))
    ys = ty + (np.arange(h_u) << ss)
    xs = tx + (np.arange(w_u) << ss)
    gwt[j, :h_u, :w_u] = wfull[ys[:, None], xs[None, :]]
    gslot[r] = j
  return gwt, gslot


def mc_size_classes(w, h, bdof):
  """The inter kernel's two work lists over an MC batch's rows (int32
  row indices): small, the units of at most SMALL_AREA samples (over
  at least 4 x 4) without BDOF, in row order; large, the rest, the
  largest first.  bdof: the luma batch's bdof row (0 for chroma)."""
  area = np.maximum(w, 4) * np.maximum(h, 4)
  small = (area <= SMALL_AREA) & ~(np.asarray(bdof) > 0)
  large = np.flatnonzero(~small)
  large = large[np.argsort(-area[large], kind="stable")]
  return np.flatnonzero(small).astype(np.int32), large.astype(np.int32)


def _layout_ctrl(mat, n_l0: int, ss: int):
  """The two layouts of one (kNumKeys, n_units) control matrix:

    inter: the MC batch, dict of (n_mc,) INTER_KEYS rows: the n_inter
      pure inter units (chunk < 0; no intra-frame sample deps), then
      the CIIP units, whose MC tile the intra pass blends.  Plus the
      GPM weight tiles `gwt` and the per-row index `gslot`, the tile
      offsets `toff` (mc_tiles) and the kernel's work lists `small` and
      `large` (mc_size_classes).
    intra: dict of (n_iu + CHUNK_CAP,) arrays, units contiguous in
      chunk order, plus ioff/iend (n_chunks,): chunk s's units live at
      [ioff[s], iend[s]), at most CHUNK_CAP of them.  The CHUNK_CAP
      tail of zero (w=0) rows keeps a full CHUNK_CAP window from any
      ioff in bounds.  The host guarantees every sample dependency of a
      unit lives in a strictly earlier chunk.  `ipos` is each unit's
      row in the MC batch (its CIIP tile; 0 for other units).

  Reference slots: r0slot/r1slot become ref_idx + n_l0 * list, an index
  into the frame's [L0 refs..., L1 refs...] (GPM hypotheses can sit on
  either list).  Returns (inter, n_inter, intra, n_chunks)."""
  keys = {k: mat[j] for j, k in enumerate(CTRL_KEYS)}
  keys["r0slot"] = keys["r0slot"] + n_l0 * keys["hyp0lx"]
  keys["r1slot"] = keys["r1slot"] + n_l0 * keys["hyp1lx"]
  chunk = keys["chunk"]
  pure_idx = np.flatnonzero(chunk < 0)
  mc_idx = np.concatenate([pure_idx, np.flatnonzero(keys["ciipw"] > 0)])
  inter = {k: np.ascontiguousarray(keys[k][mc_idx], np.int32)
           for k in INTER_KEYS}
  inter["gwt"], inter["gslot"] = _gpm_weight_blocks(inter, ss)
  inter["toff"] = offsets(inter["w"], inter["h"])
  inter["small"], inter["large"] = mc_size_classes(
      inter["w"], inter["h"], inter["bdof"] if ss == 0 else 0)
  ipos = np.zeros(mat.shape[1], np.int32)
  ipos[mc_idx] = np.arange(len(mc_idx), dtype=np.int32)

  intra_idx = np.flatnonzero(chunk >= 0)
  n_iu = len(intra_idx)
  if n_iu:
    c = chunk[intra_idx]
    n_chunks = int(c.max()) + 1
    order = np.argsort(c, kind="stable")
    counts = np.bincount(c[order], minlength=n_chunks)
    assert counts.max() <= CHUNK_CAP
    offs = np.zeros(n_chunks + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
  else:
    n_chunks = 0
    order = np.zeros(0, np.int64)
    offs = np.zeros(1, np.int64)
  src = intra_idx[order]
  intra = {}
  for k in (*INTRA_KEYS, "ipos"):
    a = np.zeros(n_iu + CHUNK_CAP, np.int32)
    a[:n_iu] = (ipos if k == "ipos" else keys[k])[src]
    intra[k] = a
  intra["ioff"] = offs[:-1].astype(np.int32)
  intra["iend"] = offs[1:].astype(np.int32)
  return inter, np.int32(len(pure_idx)), intra, np.int32(n_chunks)


def has_dmvr(fs: FrameSyntax) -> bool:
  """The frame has DMVR units: its unit controls need the refined MVs
  (ops/dmvr.py, host.dmvr_apply) before its inputs can be built."""
  return fs.cus is not None and "dmvr" in fs.cus and bool(
      np.any(fs.cus["dmvr"]))


def _lmcs_inputs(fs: FrameSyntax) -> dict:
  """LMCS piecewise-segment tables (ops/lmcs.py evaluates the mapping
  arithmetically); chroma_scale only when the picture header enables
  chroma residual scaling."""
  lm = {"pivot": fs.lmcs["pivot"], "fwd_scale": fs.lmcs["fwd_scale"],
        "inv_scale": fs.lmcs["inv_scale"],
        "bins": np.array([fs.lmcs["min_bin"], fs.lmcs["max_bin"]], np.int32)}
  if fs.lmcs["crs_flag"]:
    lm["chroma_scale"] = fs.lmcs["chroma_scale"]
  return {k: np.asarray(v, np.int32) for k, v in lm.items()}


# ALF clip index -> clip value 1 << (bd - ALF_CLIP_OFF[idx])
ALF_CLIP_OFF = np.array([0, 3, 5, 7], np.int32)


def _alf_inputs(fs: FrameSyntax) -> dict:
  """ALF filter banks: the 16 fixed sets (alf_fixed through
  alf_class_to_filt) then the slice's APS banks, clip indices turned into
  clip values at the frame's bit depth, and the CC-ALF coefficients with a
  zero row for filter index 0 (ops/alf.py)."""
  a = fs.alf
  bd = fs.bit_depth
  fixed = VVC_TABLES["alf_fixed"].astype(np.int32)           # (64, 12)
  c2f = VVC_TABLES["alf_class_to_filt"].astype(np.int32)     # (16, 25)

  def clipv(idx):
    return (1 << (bd - ALF_CLIP_OFF[idx])).astype(np.int32)

  return {
      "ctb": np.asarray(a["ctb"], np.int8),
      "banks_coeff": np.concatenate(
          [fixed[c2f], a["luma_coeff"]], axis=0).astype(np.int16),
      "banks_clipv": np.concatenate(
          [np.full((16, 25, 12), 1 << bd, np.int32),
           clipv(a["luma_clipidx"])], axis=0).astype(np.int16),
      "chroma_coeff": np.asarray(a["chroma_coeff"], np.int16),
      "chroma_clipv": clipv(a["chroma_clipidx"]).astype(np.int16),
      "cc_coeff": np.concatenate([np.zeros((2, 1, 7), np.int32),
                                  a["cc_coeff"]], axis=1).astype(np.int16),
  }


def build_host_inputs(fs: FrameSyntax):
  """Numpy input tree of one frame (safe on a parse worker)."""
  check_supported(fs)
  W, H = fs.width, fs.height
  inp = {"planes": []}
  mono = fs.chroma_format_idc == 0
  n_l0 = max(1, len(fs.ref_pocs[0]))
  ctrl = {}
  for tag, mat in (("y", fs.ctrl_y), ("c", fs.ctrl_c)):
    if mat is None:
      mat = np.zeros((len(CTRL_KEYS), 0), np.int32)
    inter, n_inter, intra, n_chunks = _layout_ctrl(mat, n_l0,
                                                   0 if tag == "y" else 1)
    ctrl[tag] = {"inter": inter, "n_inter": n_inter, "intra": intra,
                 "n_chunks": n_chunks}
  inp["ctrl"] = ctrl
  if (fs.ctrl_c is not None and fs.ctrl_c.size and
      (fs.ctrl_c[CTRL_KEYS.index("cclm")] > 0).any()):
    inp["cclm_vc"] = np.int32(
        fs.ctrl_c[CTRL_KEYS.index("cclm_vc")].max() & 1)
  (Hp_y, Wp_y), (Hp_c, Wp_c) = _padded_plane_shapes(W, H, fs.ctb_log2)
  for c_idx in range(1 if mono else 3):
    sizes = LUMA_SIZES if c_idx == 0 else CHROMA_SIZES
    inp["planes"].append({"buckets": _bucket_inputs(fs, c_idx, sizes)})
  if not fs.deblock_disabled:
    inp["deblock"] = _deblock_grids(fs, Hp_y, Wp_y, Hp_c, Wp_c, fs.ctb_log2)
  if fs.lmcs is not None:
    inp["lmcs"] = _lmcs_inputs(fs)
  if fs.alf is not None:
    inp["alf"] = _alf_inputs(fs)
  if fs.sao is not None and np.any(fs.sao[..., 0:3]):
    # per-CTB params are all small ints (types 0-2, band pos 0-28,
    # offsets |v| <= 31)
    sao = fs.sao.astype(np.int8)
    inp["sao"] = {
        "type": sao[..., 0:3],
        "band": sao[..., 3:6],
        "eo": sao[..., 6:9],
        "offv": sao[..., 9:24].reshape(sao.shape[0], sao.shape[1], 3, 5),
    }
  return inp
