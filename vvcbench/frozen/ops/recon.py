"""Reconstruction of one plane kind: the recon kernel and its plain
version.

The decoder's one sequential stage.  First the pure inter units of the
MC batch (`inputs._layout_ctrl`) are placed: their prediction tiles
(`ops.inter.inter_pred`) plus the residual.  Then the intra units
(transform blocks of at most maxs x maxs) are reconstructed in an order
that respects their sample dependencies.  The host lays them out in
wavefront chunks of at most CHUNK_CAP mutually independent units, chunk
s at [ioff[s], iend[s]) of the intra layout; every sample a unit reads
was reconstructed by the inter placement or a strictly earlier chunk.
CIIP units are intra units whose prediction is blended with their MC
tile, found through `ipos`.

`recon_plane` is the entry point.  A CUDA tensor launches the kernel
(csrc/recon.cu: a placement launch, then a dataflow wavefront launch in
which each intra unit waits only for the writers of the samples it
reads, the cells of `_wait_rects`); a CPU tensor runs
`recon_plane_plain`, the batched torch port of the JAX frame program's
`_recon_plane` (the inter pass, then the intra_chunk loop with
`_intra_unit`/`_cclm_unit` and the CIIP blend), which is also the
kernel's oracle.  `dependency_levels` is the Python twin of the
kernel's wait stencil.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..models.vvc import mc_tiles
from ..models.vvc.host import CHUNK_CAP
from ..models.vvc.inputs import INTER_KEYS, INTRA_KEYS
from ..models.vvc.recon import MC_CCLM, MC_MIP
from . import intra as I

_K = {k: i for i, k in enumerate(INTRA_KEYS)}

# launches of the CUDA kernel, and runs of the plain version: plain
# integer counters a caller may reset to 0 and read back
LAUNCHES = {"recon": 0}
PLAIN_RUNS = {"recon": 0}
# launches by the wavefront's instance: units of at most 32 a side, or
# the 64-edge instance of maxs-64 calls (csrc/recon.cu wave_kernel<MX>)
EDGE_LAUNCHES = {32: 0, 64: 0}


def _check_ipos(intra: dict, n_units: int, n_mc: int) -> None:
  """Every CIIP unit's tile rows (its first row `ipos` and, for a unit
  above MC_TILE a side, the blocks after it) lie in the MC batch."""
  rows = intra["mat_host"]
  ciip = rows[_K["ciipw"], :n_units] > 0
  ipos = intra["ipos_host"][:n_units][ciip]
  last = ipos + mc_tiles.n_blocks(rows[_K["w"], :n_units][ciip],
                                  rows[_K["h"], :n_units][ciip]) - 1
  if ipos.size and (ipos.min() < 0 or last.max() >= n_mc):
    raise ValueError(f"recon: CIIP tile index out of range [0, {n_mc}): "
                     f"{ipos.min()}..{last.max()}")


# edge in samples of a readiness cell where every unit is 2-aligned
CELL = 2


def readiness_cell(rows: np.ndarray) -> int:
  """Edge in samples of the recon kernel's readiness cells for a call's
  (len(INTRA_KEYS), n) intra rows: 2, unless a unit is not aligned to 2
  samples (the 1- and 2-sample ISP sub-partitions), then 1.  Every unit
  then covers whole cells, so each cell has one writer (decode.cc's `g`
  is 1 on every ISP frame, 2 otherwise; at 2 where every unit is
  2-aligned, the writers of a stencil are the same)."""
  xywh = rows[[_K["x0"], _K["y0"], _K["w"], _K["h"]]]
  return 1 if (xywh % CELL).any() else CELL


def _wait_rects(x0, y0, avail_l, avail_t, cand_up_left, r, C=CELL):
  """The cells a unit waits for before it builds its edges, as
  half-open (row0, row1, col0, col1) ranges of C x C cells: the top
  run [x0, x0 + avail_t) on rows y0-1-r .. y0-1, the left run [y0, y0 +
  avail_l) on columns x0-1-r .. x0-1, and the corner when cand_up_left is
  set.  r is the MRL reference line (0 for chroma).  This is decode.cc's
  chunk stencil (derive, "wavefront chunk") and the twin of
  csrc/recon.cu `wait_rects`: change the three together."""
  yt, xl = max(0, (y0 - 1 - r) // C), max(0, (x0 - 1 - r) // C)
  rects = []
  if avail_t > 0:
    rects.append((yt, (y0 - 1) // C + 1, x0 // C, (x0 + avail_t - 1) // C + 1))
  if avail_l > 0:
    rects.append((y0 // C, (y0 + avail_l - 1) // C + 1, xl, (x0 - 1) // C + 1))
  if cand_up_left > 0 and x0 > 0 and y0 > 0:
    rects.append((yt, (y0 - 1) // C + 1, xl, (x0 - 1) // C + 1))
  return rects


def dependency_levels(intra: dict, n_units: int, *, is_chroma: bool):
  """Each intra unit's level in the dataflow wavefront: 1 + the largest
  level among the intra units that write the cells it waits for
  (`_wait_rects` at the kernel's readiness_cell for these rows;
  cells no intra unit writes are ready from the start, level 0).  Units
  are visited in layout order, which is topological: a unit's writers
  lie in strictly earlier chunks.  The largest level is the critical
  path of the recon kernel's wavefront launch.  Returns (n_units,)
  int64."""
  rows = intra["mat_host"][:, :n_units].astype(np.int64)
  C = readiness_cell(rows)
  x0, y0, w, h = (rows[_K[k]] for k in ("x0", "y0", "w", "h"))
  avl, avt, cul = (rows[_K[k]] for k in ("avail_l", "avail_t",
                                         "cand_up_left"))
  mrl = np.zeros_like(x0) if is_chroma else rows[_K["mrl"]]
  level = np.zeros(n_units, np.int64)
  if not n_units:
    return level
  cells = np.zeros((int((y0 + np.maximum(h, avl)).max()) // C + 1,
                    int((x0 + np.maximum(w, avt)).max()) // C + 1),
                   np.int64)
  for i in range(n_units):
    dep = 0
    for a, b, c, d in _wait_rects(int(x0[i]), int(y0[i]), int(avl[i]),
                                  int(avt[i]), int(cul[i]), int(mrl[i]), C):
      dep = max(dep, int(cells[a:b, c:d].max()))
    level[i] = dep + 1
    cells[y0[i] // C:(y0[i] + h[i]) // C,
          x0[i] // C:(x0[i] + w[i]) // C] = dep + 1
  return level


def _slice_block(plane, y0, x0, maxs):
  """(N, maxs, maxs) blocks read at per-unit offsets via a flat gather."""
  Wp = plane.shape[1]
  d = torch.arange(maxs, dtype=torch.int32, device=plane.device)
  idx = ((y0[:, None, None] + d[None, :, None]) * Wp
         + x0[:, None, None] + d[None, None, :])
  return plane.reshape(-1)[idx.long()]


def _cclm_units(c, top, left, cclm, OFF, maxs, bit_depth, maxv):
  """CCLM prediction for N chroma units (8.4.5.2.14): boundary picks
  from the units' own edge vectors and the reconstructed luma plane,
  min/max model fit, applied to the downsampled collocated luma."""
  luma, dsy = cclm
  vcf = c["cclm_vc"]
  cnt_t, cnt_l = c["cclm_ct"], c["cclm_cl"]
  pos = torch.stack([c["cclm_p0"], c["cclm_p1"], c["cclm_p2"],
                     c["cclm_p3"]], dim=1)
  n_sel = cnt_t + cnt_l
  sel_l = I.cclm_select_luma(luma, c["x0"], c["y0"], cnt_t, pos, vcf & 1,
                             (vcf >> 1) & 1, (vcf >> 2) & 1, (vcf >> 3) & 1)
  i4 = torch.arange(4, dtype=torch.int32, device=top.device)[None, :]
  sel_c = torch.where(i4 < cnt_t[:, None], I._take(top, OFF + pos),
                      I._take(left, OFF + pos))
  two = (n_sel == 2)[:, None]
  sel_l = torch.where(two, I.cclm_reorder2(sel_l), sel_l)
  sel_c = torch.where(two, I.cclm_reorder2(sel_c), sel_c)
  a, k, b = I.cclm_get_params(sel_l, sel_c, n_sel, bit_depth)
  Hd, Wd = dsy.shape
  # lax.dynamic_slice semantics: the window start clamps into the plane
  blk = _slice_block(dsy, c["y0"].clamp(0, Hd - maxs),
                     c["x0"].clamp(0, Wd - maxs), maxs)
  return (((blk * a[:, None, None]) >> k[:, None, None])
          + b[:, None, None]).clamp(0, maxv)


def _intra_units(plane, res_plane, c, present, *, maxs, is_chroma, bit_depth,
                 cclm, tiles):
  """Prediction + residual for the N units of one chunk window.
  `present` holds the host's view of which paths the chunk's live
  units take (mode classes, smoothing, projections, PDPC, CIIP); paths
  no live unit takes are skipped — their results would be discarded.
  tiles: this channel's MC tiles as (n_mc, S, S) blocks with zeros
  outside each unit (mc_tiles.unpack), read by CIIP units."""
  maxv = (1 << bit_depth) - 1
  mid = 1 << (bit_depth - 1)
  _, OFF = I.edge_len(maxs)
  w, h = c["w"], c["h"]
  mrl = torch.zeros_like(w) if is_chroma else c["mrl"]
  left, top = I.edge_arrays(plane, c["x0"], c["y0"], maxs, c["avail_l"],
                            c["avail_t"], c["cand_up_left"], mid, ref_idx=mrl)
  if present["smooth"]:
    lf, tf = I.ref_filter_121(left, top, OFF, c["left_size"], c["top_size"],
                              c["unfilter_last_one"])
    on = (c["smooth"] > 0)[:, None]
    left, top = torch.where(on, lf, left), torch.where(on, tf, top)
  inv = c["inv_angle"]
  if present["proj_v"]:
    top = torch.where((c["proj_v"] > 0)[:, None],
                      I.project_negative_angle(top, left, OFF, inv, h, mrl),
                      top)
  if present["proj_h"]:
    left = torch.where((c["proj_h"] > 0)[:, None],
                       I.project_negative_angle(left, top, OFF, inv, w, mrl),
                       left)
  angle, ff = c["angle"], c["filter_flag"]
  pdpc, ns = c["do_pdpc"], c["nscale"]
  logw, logh = c["logw"], c["logh"]
  branches = {
      I.MC_PLANAR: lambda: I.pred_planar(top, left, OFF, maxs, w, h, logw,
                                         logh),
      I.MC_DC: lambda: I.pred_dc(top, left, OFF, maxs, w, h),
      I.MC_VERT: lambda: I.pred_v(top, OFF, maxs),
      I.MC_HORZ: lambda: I.pred_h(left, OFF, maxs),
      I.MC_ANG_V: lambda: I.pred_angular_v(top, left, OFF, maxs, w, h, angle,
                                           inv, ff, pdpc, ns, is_chroma, maxv,
                                           mrl),
      I.MC_ANG_H: lambda: I.pred_angular_h(top, left, OFF, maxs, w, h, angle,
                                           inv, ff, pdpc, ns, is_chroma, maxv,
                                           mrl),
      MC_MIP: lambda: I.pred_mip(top, left, OFF, maxs, w, h, c["mip_id"],
                                 c["mip_t"], c["mip_sz"], bit_depth, maxv),
  }
  if cclm is not None:
    branches[MC_CCLM] = lambda: _cclm_units(c, top, left, cclm, OFF, maxs,
                                            bit_depth, maxv)
  mc = c["mode_class"]
  pred = torch.zeros((w.shape[0], maxs, maxs), dtype=torch.int32,
                     device=plane.device)
  for cls in present["mode_class"]:
    pred = torch.where((mc == cls)[:, None, None], branches[cls](), pred)
  if present["pdpc_hvdc"]:
    pred = torch.where(((pdpc > 0) & (mc < I.MC_ANG_V))[:, None, None],
                       I.pdpc_hvdc(pred, top, left, OFF, maxs, logw, logh, mc,
                                   maxv), pred)
  if present["ciip"]:
    # CIIP blend (put_ciip, vvc_inter_template.c:60-76) with the unit's
    # MC tile (its blocks, for a unit above MC_TILE a side)
    mcb = mc_tiles.ciip_blocks(tiles, c["ipos"], w, maxs)
    cw = c["ciipw"][:, None, None]
    pred = torch.where(cw > 0, (pred * cw + mcb * (4 - cw) + 2) >> 2, pred)
  res = _slice_block(res_plane, c["y0"], c["x0"], maxs)
  return (pred + res).clamp(0, maxv)


def _present(rows: np.ndarray) -> dict:
  """Which paths the (len(INTRA_KEYS), n) host rows of live units take."""
  mc = rows[_K["mode_class"]]
  return {"mode_class": sorted(int(v) for v in np.unique(mc)),
          "smooth": bool((rows[_K["smooth"]] > 0).any()),
          "proj_v": bool((rows[_K["proj_v"]] > 0).any()),
          "proj_h": bool((rows[_K["proj_h"]] > 0).any()),
          "pdpc_hvdc": bool(((rows[_K["do_pdpc"]] > 0)
                             & (mc < I.MC_ANG_V)).any()),
          "ciip": bool((rows[_K["ciipw"]] > 0).any())}


def _scatter(plane, Wp, blks, c, valid, maxs):
  """Write N disjoint (maxs, maxs) blocks into the flat plane (its last
  element is a spare that takes every masked-off position)."""
  HW = plane.numel() - 1
  d = torch.arange(maxs, dtype=torch.int32, device=plane.device)
  mask = ((d[None, :, None] < c["h"][:, None, None])
          & (d[None, None, :] < c["w"][:, None, None])
          & valid[:, None, None])
  flat = ((c["y0"][:, None, None] + d[None, :, None]) * Wp
          + c["x0"][:, None, None] + d[None, None, :])
  flat = torch.where(mask, flat, HW)
  plane[flat.reshape(-1).long()] = blks.reshape(-1)


def recon_plane_plain(res_plane, intra: dict, n_chunks: int, *, maxs: int,
                      is_chroma: bool, bit_depth: int, cclm=None, inter=None,
                      tiles=None):
  """Plain torch reconstruction of one plane: (Hp, Wp) residual ->
  (Hp, Wp) reconstruction, from a mid-grey plane.
  The inter pass places the n_inter pure inter units of `inter` (the
  converted MC batch): clip(tile + residual) over each unit's (h, w).
  Then chunk s slices a full CHUNK_CAP window from ioff[s] and writes
  only the units in [ioff[s], iend[s]) with w > 0; the window's tail
  belongs to chunk s+1 and is reconstructed there.
  cclm: (reconstructed luma plane, cclm_dsy_plane of it) or None.
  tiles: this channel's (T,) row of the MC tiles (ops.inter.inter_pred,
  mc_tiles), or None for a frame without MC units."""
  PLAIN_RUNS["recon"] += 1
  Hp, Wp = res_plane.shape
  dev = res_plane.device
  maxv = (1 << bit_depth) - 1
  plane = torch.full((Hp * Wp + 1,), 1 << (bit_depth - 1), dtype=torch.int32,
                     device=dev)
  n_inter = inter["n_inter"] if inter is not None else 0
  # the MC tiles as (n_mc, S, S) blocks, zeros outside each unit
  blocks = None if tiles is None else mc_tiles.unpack(
      tiles, inter["toff"], inter["w"], inter["h"])
  if n_inter:
    S = blocks.shape[-1]
    c = {k: inter[k][:n_inter] for k in ("x0", "y0", "w", "h")}
    d = torch.arange(S, dtype=torch.int32, device=dev)
    inside = ((d[None, :, None] < c["h"][:, None, None])
              & (d[None, None, :] < c["w"][:, None, None]))
    at = ((c["y0"][:, None, None] + d[None, :, None]) * Wp
          + c["x0"][:, None, None] + d[None, None, :])
    res = res_plane.reshape(-1)[torch.where(inside, at, 0).long()]
    blks = (blocks[:n_inter] + res).clamp(0, maxv)
    _scatter(plane, Wp, blks, c, torch.ones_like(c["w"], dtype=torch.bool), S)
  lanes = torch.arange(CHUNK_CAP, dtype=torch.int32, device=dev)
  ioff, iend = intra["ioff_host"], intra["iend_host"]
  rows = intra["mat_host"]
  for s in range(n_chunks):
    off, end = int(ioff[s]), int(iend[s])
    c = {k: intra[k][off:off + CHUNK_CAP] for k in (*INTRA_KEYS, "ipos")}
    view = plane[:Hp * Wp].view(Hp, Wp)
    blks = _intra_units(view, res_plane, c, _present(rows[:, off:end]),
                        maxs=maxs, is_chroma=is_chroma, bit_depth=bit_depth,
                        cclm=cclm, tiles=blocks)
    _scatter(plane, Wp, blks, c, (off + lanes < end) & (c["w"] > 0), maxs)
  return plane[:Hp * Wp].view(Hp, Wp).clone()


# ----------------------------------------------------------------------
# CUDA kernel (csrc/recon.cu), built with nvcc at first use and bound
# with ctypes
# ----------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "recon.cu")
_lib = None


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("recon", [_SRC]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recon_launch.restype = ctypes.c_int
    lib.recon_launch.argtypes = [
        p, i, i, i,         # ctrl (NK, ucap), NK, ucap, n_units
        p, i, i, i,         # MC batch ctrl (NKI, n_mc), NKI, n_mc, n_inter
        p, p, ctypes.c_longlong,  # MC tiles (nch, T) int16, toff, T
        p,                  # ipos (ucap,)
        p, p, i, i, i,      # res, plane (nch, Hp, Wp), nch, Hp, Wp
        p, i, i,            # dsy (Hd, Wd)
        p, i, i,            # luma (Hl, Wl)
        p, p, p,            # luma filter, MIP bank, CCLM div table
        i, i, i, i,         # maxs, is_chroma, bit_depth, readiness cell
        p,                  # scratch: readiness maps + ticket
        i,                  # stage: 0 placement, 1 wavefront
        p]                  # stream
    lib.recon_error_string.restype = ctypes.c_char_p
    lib.recon_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


def _check(t, name, shape=None, dtype=torch.int32):
  if t.device.type != "cuda":
    raise ValueError(f"recon: {name} must be a CUDA tensor")
  if t.dtype != dtype:
    raise ValueError(f"recon: {name} must be {dtype}, got {t.dtype}")
  if not t.is_contiguous():
    raise ValueError(f"recon: {name} must be contiguous")
  if shape is not None and tuple(t.shape) != tuple(shape):
    raise ValueError(f"recon: {name} has shape {tuple(t.shape)}, "
                     f"expected {tuple(shape)}")




def _recon_cuda(res, intra, n_chunks, inter, tiles, *, maxs, is_chroma,
                bit_depth, cclm, mark=None):
  """The kernel's two launches on the current stream.  mark(stage), if
  given, is called just before each (stage 0 the placement, 1 the
  wavefront), to record a CUDA event and time the two apart."""
  nch, Hp, Wp = res.shape
  mat = intra["mat"]
  ucap = mat.shape[1]
  n_units = int(intra["iend_host"][-1]) if n_chunks else 0
  dev = res.device
  _check(res, "res")
  _check(mat, "ctrl", (len(INTRA_KEYS), ucap))
  _check(intra["ipos"], "ipos", (ucap,))
  # readiness cells: every unit covers whole cells (readiness_cell)
  cell = readiness_cell(intra["mat_host"][:, :n_units])
  if Hp % cell or Wp % cell:
    raise ValueError(f"recon: a {Hp}x{Wp} plane is not whole {cell}x{cell} "
                     "readiness cells")
  if maxs not in (16, 32, 64) or (maxs == 64 and is_chroma):
    raise ValueError(f"recon: maxs {maxs} not in (16, 32), or 64 for luma")
  if n_units and intra["mat_host"][[_K["w"], _K["h"]], :n_units].max() > maxs:
    raise ValueError(f"recon: an intra unit exceeds maxs {maxs}")
  n_mc, n_inter = inter["n_mc"], inter["n_inter"]
  _check(inter["mat"], "MC batch ctrl", (len(INTER_KEYS), n_mc))
  if n_mc:
    _check(inter["toff"], "toff", (n_mc + 1,))
    _check(tiles, "tiles", (nch, inter["T"]), mc_tiles.DTYPE)
  plane = torch.full((nch, Hp, Wp), 1 << (bit_depth - 1), dtype=torch.int32,
                     device=dev)
  if n_units == 0 and n_inter == 0:
    return plane
  dsy_ptr, Hd, Wd, luma_ptr, Hl, Wl = None, 0, 0, None, 0, 0
  if cclm is not None:
    luma, dsy = cclm[0], cclm[1].contiguous()
    _check(luma, "luma")
    _check(dsy, "dsy")
    (Hl, Wl), (Hd, Wd) = luma.shape, dsy.shape
    luma_ptr, dsy_ptr = luma.data_ptr(), dsy.data_ptr()
  ftab = I._const("luma_filter", I.INTRA_LUMA_FILTER, dev)
  bank = I._const("mip_bank", I.MIP_BANK, dev)
  div = I._const("cclm_div", I.CCLM_DIV_SIG, dev)
  # per channel a readiness map of (Hp/cell, Wp/cell) cells, 0 = ready;
  # then the ticket counter
  scratch = torch.zeros(nch * (Hp // cell) * (Wp // cell) + 1,
                        dtype=torch.int32, device=dev)
  lib = _get_kernel()
  args = (mat.data_ptr(), len(INTRA_KEYS), ucap, n_units,
          inter["mat"].data_ptr(), len(INTER_KEYS), n_mc, n_inter,
          tiles.data_ptr() if n_mc else None,
          inter["toff"].data_ptr() if n_mc else None, inter["T"],
          intra["ipos"].data_ptr(),
          res.data_ptr(), plane.data_ptr(), nch, Hp, Wp,
          dsy_ptr, Hd, Wd, luma_ptr, Hl, Wl,
          ftab.data_ptr(), bank.data_ptr(), div.data_ptr(),
          maxs, int(is_chroma), bit_depth, cell, scratch.data_ptr())
  stream = torch.cuda.current_stream(dev).cuda_stream
  for stage in (0, 1):
    if mark is not None:
      mark(stage)
    rc = lib.recon_launch(*args, stage, stream)
    if rc != 0:
      raise RuntimeError("recon kernel launch failed: "
                         f"{lib.recon_error_string(rc).decode()}")
  LAUNCHES["recon"] += 1
  if n_units:
    EDGE_LAUNCHES[64 if maxs > 32 else 32] += 1
  return plane


def recon_plane(res, intra: dict, n_chunks: int, inter: dict, tiles, *,
                maxs: int, is_chroma: bool, bit_depth: int, cclm=None):
  """Reconstruction of one plane kind.

  res: (nch, Hp, Wp) int32 residual planes (nch=1 luma, 2 for Cb+Cr,
  which share the chroma control rows).  intra, inter: the converted
  intra layout and MC batch (convert.inputs_from_numpy).  tiles: the
  MC batch's (nch, T) int16 prediction tiles (ops.inter.inter_pred,
  mc_tiles), or None when n_mc is 0.  cclm: (luma plane, dsy plane)
  for chroma frames with CCLM units.  Returns (nch, Hp, Wp) int32.
  A CUDA tensor launches the kernel; a CPU tensor runs the plain
  version; nothing falls back from one to the other."""
  n_units = int(intra["iend_host"][-1]) if n_chunks else 0
  _check_ipos(intra, n_units, inter["n_mc"])
  if res.device.type == "cuda":
    return _recon_cuda(res, intra, n_chunks, inter, tiles, maxs=maxs,
                       is_chroma=is_chroma, bit_depth=bit_depth, cclm=cclm)
  if res.device.type != "cpu":
    raise ValueError(f"recon: unsupported device {res.device}")
  return recon_plane_plain_kind(res, intra, n_chunks, inter, tiles, maxs=maxs,
                                is_chroma=is_chroma, bit_depth=bit_depth,
                                cclm=cclm)


def recon_plane_plain_kind(res, intra: dict, n_chunks: int, inter: dict,
                           tiles, *, maxs: int, is_chroma: bool,
                           bit_depth: int, cclm=None):
  """recon_plane's plain version, with its arguments and result: every
  channel of the plane kind through recon_plane_plain."""
  return torch.stack([recon_plane_plain(
      res[ch], intra, n_chunks, maxs=maxs, is_chroma=is_chroma,
      bit_depth=bit_depth, cclm=cclm, inter=inter,
      tiles=tiles[ch] if tiles is not None else None)
      for ch in range(res.shape[0])])
