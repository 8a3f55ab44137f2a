"""Frame program of one frame: host inputs + reference planes -> decoded
planes.

Torch port of the JAX frame program (pipeline.frame_program, non-Pallas
form), stage by stage on one device:

  luma buckets ──residual kernel──> luma residual plane (dequant, LFNST,
                                    inverse DCT2/DST7/DCT8, placement)
  MC batch + DPB refs ──inter kernel──> prediction tiles (P/B frames; the
                                        luma mapped forward under LMCS)
  tiles + intra layout ──recon kernel──> luma (in the LMCS-mapped domain)
  mapped luma ──> per-VPDU chroma residual scales (LMCS)
  chroma buckets ──residual kernel, scaled──> Cb+Cr residual planes (one
                                             launch for both)
  tiles + intra layout ──recon kernel──> Cb+Cr (CCLM reads the
                                         reconstructed luma)
  luma ──LMCS inverse──> edge grids ──deblock kernel──> V, then H (one
       launch for luma, one for Cb+Cr) ──> SAO ──ALF kernel──> luma
       (classification + 7x7 diamond), then Cb+Cr (5x5 diamond + CC-ALF
       from the pre-ALF luma) ──> packed bytes

DMVR frames first run their refinement (ops/dmvr.py, `refine_dmvr`)
against the DPB, which the session does in decode order.

Eager torch needs no compiled program per stream geometry: shapes come
from each frame's own counts.
"""
from __future__ import annotations

import torch

from ...ops import intra as I
from ...ops.alf import alf_planes, alf_planes_plain
from ...ops.deblock import deblock_planes, deblock_planes_plain
from ...ops.dmvr import refine_frame
from ...ops.inter import inter_pred, inter_pred_plain_kind
from ...ops.lmcs import lmcs_inv, lmcs_vpdu_scales
from ...ops.recon import recon_plane, recon_plane_plain_kind
from ...ops.sao import sao_plane
from ...ops.transform import residual_planes, residual_planes_plain
from ...utils import trace
from .convert import inputs_from_numpy
from .host import ColStore, FrameSyntax, HostDecoder, dmvr_apply
from .inputs import (CHROMA_SIZES, _padded_plane_shapes, build_host_inputs,
                     has_dmvr)


def _sync_for(device):
  if torch.device(device).type == "cuda":
    return lambda: torch.cuda.synchronize(device)
  return None


# each kernel of the frame program: (wrapper, its plain version, which
# takes the same arguments and returns the same result)
KERNELS = {"residual": (residual_planes, residual_planes_plain),
           "inter_pred": (inter_pred, inter_pred_plain_kind),
           "recon": (recon_plane, recon_plane_plain_kind),
           "deblock": (deblock_planes, deblock_planes_plain),
           "alf": (alf_planes, alf_planes_plain)}


def _launch(name, label, kw):
  return KERNELS[name][0](**kw)


def _deblock_grids(d, c, o):
  """Component c's per-edge grids for the o ("v" or "h") pass, in
  deblock_planes's order."""
  if c == 0:
    return tuple(d[f"y{k}_{o}"] for k in ("bs", "qp", "mp", "mq")) + (
        d["yhor0" if o == "v" else "yhor"],)
  return tuple(d[f"c{c}{k}_{o}"] for k in ("bs", "qp", "mp", "mq"))


def frame_program(inp, refs, *, W, H, ctb_log2, bit_depth, mono=False,
                  tile_bds=((), ()), crop=(0, 0, 0, 0), dbo=(0, 0, 0),
                  dto=(0, 0, 0), wrap=0, tb64=False, device="cuda",
                  call=None):
  """inp: converted input tree (convert.inputs_from_numpy).
  refs: per component, the reference planes [L0..., L1...]
  (resolve_refs).
  tile_bds: interior tile boundaries in luma samples (CCLM stencils and
  the LMCS chroma scales).
  wrap: the luma reference wraparound offset (0 = off).
  tb64: the frame has 64-sample luma TBs or CIIP units above 32 a side:
  luma intra units reach 64 (the JAX frame program's maxs_intra_y).
  crop: conformance-window offsets (l, r, t, b) in luma samples.
  dbo/dto: effective deblock beta/tc offsets per component.
  call(kernel name, plane kind, kwargs) -> result runs each kernel call
  of KERNELS, in order: residual of luma, inter_pred of luma then
  chroma (P/B frames), recon of luma, residual of chroma (Cb and Cr
  together, after the LMCS chroma scales that read the luma recon),
  recon of chroma, deblock of luma then chroma (frames with deblock
  on), alf of luma then chroma (frames with ALF on; the chroma call
  reads the pre-ALF luma); a 4:0:0 frame makes only the luma calls.
  The default runs the wrapper; a check passes its own to hold each call
  against the plain version.
  Returns {"planes": padded int32 planes, "packed": flat planar bytes
  (uint8, or int16 holding the uint16 sample bytes above 8 bits)}."""
  bd = bit_depth
  sync = _sync_for(device)
  maxs_y = 1 << ctb_log2
  (Hp_y, Wp_y), (Hp_c, Wp_c) = _padded_plane_shapes(W, H, ctb_log2)
  n_comp = 1 if mono else 3
  lm = inp.get("lmcs")
  call = call or _launch

  def residual(label, chroma_scale=None):
    # one call per plane kind; luma's size classes vary with its tools
    # (inputs.py)
    cs = (1, 2) if label == "chroma" else (0,)
    with trace.span("residual", sync):
      return call("residual", label, dict(
          buckets=[inp["planes"][c]["buckets"] for c in cs],
          sizes=CHROMA_SIZES if cs[0] else list(inp["planes"][0]["buckets"]),
          Hp=Hp_c if cs[0] else Hp_y, Wp=Wp_c if cs[0] else Wp_y,
          bit_depth=bd, chroma=bool(cs[0]), chroma_scale=chroma_scale,
          sl=inp.get("sl")))

  res_y = residual("luma")
  # plane kinds: (label, chroma shift, control, reference channels)
  kinds = [("luma", 0, inp["ctrl"]["y"], refs[:1])]
  if not mono:
    kinds.append(("chroma", 1, inp["ctrl"]["c"], refs[1:]))
  with trace.span("inter", sync):
    tiles = {label: call("inter_pred", label, dict(
        refs=chans, inter=ct["inter"], H=H >> ss, W=W >> ss,
        is_chroma=bool(ss), bit_depth=bd, wrap=wrap >> ss,
        lmcs=None if ss else lm))
             if ct["inter"]["n_mc"] else None
             for label, ss, ct, chans in kinds}

  def recon(label, ss, ct, res, cclm=None):
    maxs = min(64 if tb64 and not ss else 32, maxs_y >> ss)
    with trace.span("recon", sync):
      return list(call("recon", label, dict(
          res=res, intra=ct["intra"], n_chunks=ct["n_chunks"],
          inter=ct["inter"], tiles=tiles[label], maxs=maxs,
          is_chroma=bool(ss), bit_depth=bd, cclm=cclm)))

  # luma first, in the LMCS-mapped domain when LMCS is on
  planes = recon("luma", 0, inp["ctrl"]["y"], res_y)
  if not mono:
    scale = None
    if lm is not None and "chroma_scale" in lm:
      # chroma residual scaling reads the mapped luma recon around each
      # VPDU, so the chroma residuals wait for it
      with trace.span("lmcs", sync):
        scale = lmcs_vpdu_scales(planes[0][:H, :W], lm, W, H,
                                 min(maxs_y, 64), bd, tile_bds)
    res_c = residual("chroma", scale)
    cclm = None
    if "cclm_vc" in inp:
      # chroma CCLM reads the reconstructed (mapped) luma: the whole-plane
      # collocated downsample + the plane itself
      with trace.span("recon", sync):
        cclm = (planes[0], I.cclm_dsy_plane(planes[0], inp["cclm_vc"],
                                            tile_bds[0], tile_bds[1]))
    planes += recon("chroma", 1, inp["ctrl"]["c"], res_c, cclm)
  if lm is not None:
    # the whole luma plane back to the original domain before the loop
    # filters (ff_vvc_lmcs_filter, vvc_filter.c:1322-1331)
    with trace.span("lmcs", sync):
      planes[0] = lmcs_inv(planes[0], lm, bd)

  if "deblock" in inp:
    d = inp["deblock"]
    # vertical edges, then horizontal edges on the result, in one call:
    # luma, then Cb and Cr together; the horizontal pass's grids are laid
    # out for the transposed plane
    comps = [("luma", (0,))] + ([] if mono else [("chroma", (1, 2))])
    with trace.span("deblock", sync):
      for label, cs in comps:
        out = call("deblock", label, dict(
            planes=[planes[c] for c in cs],
            grids_v=[_deblock_grids(d, c, "v") for c in cs],
            grids_h=[_deblock_grids(d, c, "h") for c in cs],
            chroma=label == "chroma", bit_depth=bd,
            beta_off=tuple(dbo[c] for c in cs),
            tc_off=tuple(dto[c] for c in cs)))
        for c, pl in zip(cs, out):
          planes[c] = pl

  if "sao" in inp:
    with trace.span("sao", sync):
      s = inp["sao"]
      for c in range(n_comp):
        ss = 0 if c == 0 else 1
        planes[c] = sao_plane(planes[c], s["type"][..., c],
                              s["band"][..., c], s["offv"][..., c, :],
                              s["eo"][..., c], W >> ss, H >> ss,
                              ctb=(1 << ctb_log2) >> ss, bit_depth=bd)

  if "alf" in inp:
    # luma into a new plane, then Cb and Cr together, whose CC-ALF reads
    # the pre-ALF luma (SAO's output)
    geo = dict(alf=inp["alf"], W=W, H=H, ctb_log2=ctb_log2, bit_depth=bd)
    with trace.span("alf", sync):
      pre = planes[0]
      planes[0] = call("alf", "luma", dict(planes=[pre], chroma=False,
                                           **geo))[0]
      if not mono:
        planes[1], planes[2] = call("alf", "chroma", dict(
            planes=planes[1:3], chroma=True, luma=pre, **geo))

  with trace.span("pack", sync):
    # the cropped planes in planar YCbCr order: the exact byte layout of
    # a rawvideo frame, fetched with one copy.  The conformance window
    # crops the output only; the planes keep the full coded area.
    cl, cr, ctop, cb = crop
    dt = torch.uint8 if bd == 8 else torch.int16
    parts = [planes[0][ctop:H - cb, cl:W - cr].to(dt).reshape(-1)]
    parts += [planes[c][ctop >> 1:(H - cb) >> 1,
                        cl >> 1:(W - cr) >> 1].to(dt).reshape(-1)
              for c in range(1, n_comp)]
    packed = torch.cat(parts) if len(parts) > 1 else parts[0]
  return {"planes": planes, "packed": packed}


def frame_geometry(fs: FrameSyntax) -> dict:
  """The frame program's static arguments for one frame."""
  return dict(W=fs.width, H=fs.height, ctb_log2=fs.ctb_log2,
              bit_depth=fs.bit_depth, mono=fs.chroma_format_idc == 0,
              tile_bds=(tuple(v for v in fs.tile_bd[0] if 0 < v < fs.width),
                        tuple(v for v in fs.tile_bd[1]
                              if 0 < v < fs.height)),
              crop=tuple(fs.crop), dbo=tuple(fs.beta_offset),
              dto=tuple(fs.tc_offset), wrap=int(fs.wrap_off),
              tb64=bool(fs.has_tb64))


_ZEROS: dict = {}


def _zero_plane(shape, device):
  key = (tuple(shape), str(device))
  if key not in _ZEROS:
    _ZEROS[key] = torch.zeros(shape, dtype=torch.int32, device=device)
  return _ZEROS[key]


def resolve_refs(fs: FrameSyntax, dpb: dict, device, missing=None) -> list:
  """Per component, the frame's reference planes [L0..., L1...] (at
  least one per list, so a unit's unused hypothesis always has a plane
  to read): the DPB's device planes of the listed POCs, and for list
  entries that do not exist `missing`'s plane of the component, or a
  shared zero plane (`resolve_refs` of the JAX frame program).  Empty
  for intra frames, which read no reference."""
  if fs.slice_type == 2:
    return []
  shapes = _padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)
  n_comp = 1 if fs.chroma_format_idc == 0 else 3
  out = []
  for c_idx in range(n_comp):
    shape = shapes[0 if c_idx == 0 else 1]
    planes = []
    for lx in (0, 1):
      pocs = fs.ref_pocs[lx]
      for k in range(max(1, len(pocs))):
        if k < len(pocs) and pocs[k] in dpb:
          planes.append(dpb[pocs[k]][c_idx])
        elif missing is not None:
          planes.append(missing[c_idx])
        else:
          planes.append(_zero_plane(shape, device))
    out.append(planes)
  return out


def refine_dmvr(fs: FrameSyntax, colstore: ColStore, epoch: int, dpb: dict,
                device) -> None:
  """A DMVR frame's refinement: the subblock search on `device` against
  the DPB's planes, its rows fetched, then host.dmvr_apply, which
  publishes the frame's collocated motion and rereads its unit controls
  with the refined MVs.  Runs on the main thread in decode order, before
  the session waits on a later frame's parse (which may need that
  motion)."""
  with trace.span("dmvr", _sync_for(device)):
    dmvr_apply(fs, colstore, epoch, refine_frame(fs, dpb, device))


def prepare_frame(fs: FrameSyntax):
  """Worker-thread half of a frame decode: the numpy host inputs."""
  with trace.span("inputs"):
    return build_host_inputs(fs)


def submit_frame(host_inp, fs: FrameSyntax, device, dpb: dict, call=None,
                 missing=None):
  """Main-thread half: move the inputs to `device` and run the frame
  program against the DPB's planes (poc -> per-component planes), on
  the device's current stream.  call: as in frame_program; missing: as
  in resolve_refs.  Returns (packed, planes), both on `device`."""
  with trace.span("h2d", _sync_for(device)):
    inp = inputs_from_numpy(host_inp, device)
  out = frame_program(inp, resolve_refs(fs, dpb, device, missing),
                      device=device, call=call, **frame_geometry(fs))
  return out["packed"], out["planes"]


def walk_frames(aus, device, call):
  """Every frame of a stream's access units (VVCDecoder._split_aus) in
  decode order through the frame program, on one thread, each frame
  kept as a reference for the later ones: yields (fs, host inputs)
  after each frame's program was queued.  call: as in frame_program.
  The card checks walk streams with it, to hold each kernel call of the
  real program against its plain version."""
  colstore = ColStore()
  host, dpb = HostDecoder(colstore), {}
  for _, epoch, au in aus:
    fs = host.decode_au(au, epoch)
    if fs is None:
      continue
    if has_dmvr(fs):
      refine_dmvr(fs, colstore, epoch, dpb, device)
    h = build_host_inputs(fs)
    _, dpb[fs.poc] = submit_frame(h, fs, device, dpb, call=call)
    yield fs, h
