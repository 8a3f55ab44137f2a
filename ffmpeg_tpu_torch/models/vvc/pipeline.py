"""Frame program of one frame: host inputs + reference planes -> decoded
planes.

Torch port of the JAX frame program (pipeline.frame_program, non-Pallas
form), stage by stage on one device:

  luma buckets ──residual kernel──> luma residual plane (dequant, LFNST,
                                    inverse DCT2/DST7/DCT8, placement)
  MC batch + DPB refs ──inter kernel──> prediction tiles (P/B frames; the
                                        luma mapped forward under LMCS)
  tiles + intra layout ──recon kernel──> luma (in the LMCS-mapped domain)
  chroma buckets + mapped luma ──residual kernel, scaled──> Cb+Cr residual
       planes (one call for both; each scaled TU derives its VPDU's LMCS
       chroma scale from the mapped luma around it)
  tiles + intra layout ──recon kernel──> Cb+Cr (CCLM reads the
                                         reconstructed luma)
  luma ──LMCS inverse kernel──> edge grids ──deblock kernel──> V, then H
       (one launch for luma, one for Cb+Cr) ──SAO kernel──> luma, then
       Cb+Cr ──ALF kernel──> luma (classification + 7x7 diamond), then
       Cb+Cr (5x5 diamond + CC-ALF from the pre-ALF luma) ──> packed
       bytes

DMVR frames first run their refinement (`refine_dmvr`: the DMVR search
kernel through ops/dmvr.py, then the host's dmvr_apply) against the DPB,
which the session does in decode order.

Eager torch needs no compiled program per stream geometry: shapes come
from each frame's own counts.
"""
from __future__ import annotations

import torch

from ...ops import intra as I
from ...ops.alf import alf_planes, alf_planes_plain
from ...ops.deblock import deblock_planes, deblock_planes_plain
from ...ops.dmvr import (refine_frame, refine_subblocks,
                        refine_subblocks_plain)
from ...ops.inter import inter_pred, inter_pred_plain_kind
from ...ops.lmcs import lmcs_inv, lmcs_inv_plain
from ...ops.recon import recon_plane, recon_plane_plain_kind
from ...ops.sao import sao_planes, sao_planes_plain
from ...ops.transform import (error_word, raise_on_error, residual_planes,
                               residual_planes_plain)
from ...utils import trace
from .convert import inputs_from_numpy
from .host import ColStore, FrameSyntax, HostDecoder, dmvr_apply
from .inputs import (CHROMA_SIZES, _padded_plane_shapes, build_host_inputs,
                     has_dmvr)


# each kernel of the frame program: (wrapper, its plain version, which
# takes the same arguments and returns the same result)
KERNELS = {"residual": (residual_planes, residual_planes_plain),
           "inter_pred": (inter_pred, inter_pred_plain_kind),
           "recon": (recon_plane, recon_plane_plain_kind),
           "lmcs_inv": (lmcs_inv, lmcs_inv_plain),
           "deblock": (deblock_planes, deblock_planes_plain),
           "sao": (sao_planes, sao_planes_plain),
           "alf": (alf_planes, alf_planes_plain),
           "dmvr": (refine_subblocks, refine_subblocks_plain)}


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
  together; on frames with chroma residual scaling on it reads the
  mapped luma recon for the scales), recon of chroma, lmcs_inv of luma
  (frames with LMCS on), deblock of luma
  then chroma (frames with deblock on), sao of luma then chroma (frames
  with SAO on), alf of luma then chroma (frames with ALF on; the chroma
  call reads the pre-ALF luma); a 4:0:0 frame makes only the luma
  calls.
  The default runs the wrapper, and asks for the sao and alf chroma
  launches to overlap the luma launch before each (sao_planes and
  alf_planes overlap=True); a check passes its own hook to hold each
  call against the plain version, and gets no overlap, since it may
  queue work between the calls.
  Returns {"planes": padded int32 planes, "packed": flat planar bytes
  (uint8, or int16 holding the uint16 sample bytes above 8 bits), "err":
  the frame's residual error word, a one-element int32 tensor on
  `device` that both residual calls write and nothing reads: the caller
  reads it (ops/transform.py raise_on_error) before it hands the frame
  out}.
  Each stage is a trace span (utils/trace.py) around its calls: it times
  their launches on the host, not the device's work."""
  bd = bit_depth
  maxs_y = 1 << ctb_log2
  (Hp_y, Wp_y), (Hp_c, Wp_c) = _padded_plane_shapes(W, H, ctb_log2)
  n_comp = 1 if mono else 3
  lm = inp.get("lmcs")
  # with no hook, nothing is queued between the two calls of the sao and
  # of the alf pair
  pair = call is None
  call = call or _launch
  err = error_word(device)

  def residual(label, scale_src=None):
    # one call per plane kind; luma's size classes vary with its tools
    # (inputs.py)
    cs = (1, 2) if label == "chroma" else (0,)
    with trace.span("residual"):
      return call("residual", label, dict(
          buckets=[inp["planes"][c]["buckets"] for c in cs],
          sizes=CHROMA_SIZES if cs[0] else list(inp["planes"][0]["buckets"]),
          Hp=Hp_c if cs[0] else Hp_y, Wp=Wp_c if cs[0] else Wp_y,
          bit_depth=bd, chroma=bool(cs[0]), scale_src=scale_src,
          sl=inp.get("sl"), err=err))

  res_y = residual("luma")
  # plane kinds: (label, chroma shift, control, reference channels)
  kinds = [("luma", 0, inp["ctrl"]["y"], refs[:1])]
  if not mono:
    kinds.append(("chroma", 1, inp["ctrl"]["c"], refs[1:]))
  with trace.span("inter"):
    tiles = {label: call("inter_pred", label, dict(
        refs=chans, inter=ct["inter"], H=H >> ss, W=W >> ss,
        is_chroma=bool(ss), bit_depth=bd, wrap=wrap >> ss,
        lmcs=None if ss else lm))
             if ct["inter"]["n_mc"] else None
             for label, ss, ct, chans in kinds}

  def recon(label, ss, ct, res, cclm=None):
    maxs = min(64 if tb64 and not ss else 32, maxs_y >> ss)
    with trace.span("recon"):
      return list(call("recon", label, dict(
          res=res, intra=ct["intra"], n_chunks=ct["n_chunks"],
          inter=ct["inter"], tiles=tiles[label], maxs=maxs,
          is_chroma=bool(ss), bit_depth=bd, cclm=cclm)))

  # luma first, in the LMCS-mapped domain when LMCS is on
  planes = recon("luma", 0, inp["ctrl"]["y"], res_y)
  if not mono:
    src = None
    if lm is not None and "chroma_scale" in lm:
      # chroma residual scaling reads the mapped luma recon around each
      # VPDU, so the chroma residuals wait for it
      src = dict(luma=planes[0][:H, :W], lm=lm, vsz=min(maxs_y, 64),
                 tile_bds=tile_bds)
    res_c = residual("chroma", src)
    cclm = None
    if "cclm_vc" in inp:
      # chroma CCLM reads the reconstructed (mapped) luma: the whole-plane
      # collocated downsample + the plane itself
      with trace.span("recon"):
        cclm = (planes[0], I.cclm_dsy_plane(planes[0], inp["cclm_vc"],
                                            tile_bds[0], tile_bds[1]))
    planes += recon("chroma", 1, inp["ctrl"]["c"], res_c, cclm)
  if lm is not None:
    # the whole luma plane back to the original domain before the loop
    # filters (ff_vvc_lmcs_filter, vvc_filter.c:1322-1331)
    with trace.span("lmcs"):
      planes[0] = call("lmcs_inv", "luma", dict(x=planes[0], lm=lm,
                                                bit_depth=bd))

  # the loop filters' calls: luma, then Cb and Cr together
  comps = [("luma", (0,))] + ([] if mono else [("chroma", (1, 2))])
  if "deblock" in inp:
    d = inp["deblock"]
    # vertical edges, then horizontal edges on the result, in one call;
    # the horizontal pass's grids are laid out for the transposed plane
    with trace.span("deblock"):
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
    # out of place (the edge offset reads the unfiltered neighbours),
    # each call into a new tensor.  Without a hook the Cb+Cr launch
    # follows the luma launch directly and may run beside it (ops/sao.py
    # sao_planes, overlap), so `deblocked` keeps the luma call's input
    # referenced until both calls are queued: the Cb+Cr call's fresh
    # output must not take memory the luma launch still reads.
    with trace.span("sao"):
      deblocked = planes[0]
      for label, cs in comps:
        ss = int(label == "chroma")
        kw = dict(planes=[planes[c] for c in cs], sao=inp["sao"], comps=cs,
                  pic_w=W >> ss, pic_h=H >> ss, ctb=(1 << ctb_log2) >> ss,
                  bit_depth=bd)
        out = call("sao", label, dict(kw, overlap=True) if ss and pair
                   else kw)
        for c, pl in zip(cs, out):
          planes[c] = pl
      del deblocked

  if "alf" in inp:
    # luma into a new plane, then Cb and Cr together, whose CC-ALF reads
    # the pre-ALF luma (SAO's output).  Without a hook the chroma launch
    # follows the luma launch directly and may run beside it (ops/alf.py
    # alf_planes, overlap), so `pre` and the tree stay referenced here
    # until both calls are queued: the chroma call's fresh output must
    # not take memory the luma launch still reads.
    geo = dict(alf=inp["alf"], W=W, H=H, ctb_log2=ctb_log2, bit_depth=bd)
    with trace.span("alf"):
      pre = planes[0]
      planes[0] = call("alf", "luma", dict(planes=[pre], chroma=False,
                                           **geo))[0]
      if not mono:
        kw = dict(planes=planes[1:3], chroma=True, luma=pre, **geo)
        planes[1], planes[2] = call("alf", "chroma", dict(
            kw, overlap=True) if pair else kw)

  with trace.span("pack"):
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
  return {"planes": planes, "packed": packed, "err": err}


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
                device, call=None) -> None:
  """A DMVR frame's refinement: the subblock search on `device` against
  the DPB's planes, its rows fetched (span dmvr_search, which holds the
  fetch's wait on the device: the only span here that does), then
  host.dmvr_apply, which publishes the frame's collocated motion and
  rereads its unit controls with the refined MVs (span dmvr_apply).  Runs
  on the main thread in decode order, before the session waits on a
  later frame's parse (which may need that motion).  call: as in
  frame_program; it runs the search as kernel "dmvr", plane kind
  "luma"."""
  with trace.span("dmvr"):
    with trace.span("dmvr_search"):
      planes6 = refine_frame(fs, dpb, device, call=call)
    with trace.span("dmvr_apply"):
      dmvr_apply(fs, colstore, epoch, planes6)


def prepare_frame(fs: FrameSyntax):
  """Worker-thread half of a frame decode: the numpy host inputs."""
  with trace.span("inputs"):
    return build_host_inputs(fs)


def submit_frame(host_inp, fs: FrameSyntax, device, dpb: dict, call=None,
                 missing=None):
  """Main-thread half: move the inputs to `device` and run the frame
  program against the DPB's planes (poc -> per-component planes), on
  the device's current stream.  call: as in frame_program; missing: as
  in resolve_refs.  Returns (packed, planes, err), all on `device`: err
  is the frame's residual error word (frame_program), unread.  The
  h2d span's attribute `copies` counts the host-to-device transfers of
  the inputs (convert.py)."""
  with trace.span("h2d", copies=0):
    inp = inputs_from_numpy(host_inp, device)
  out = frame_program(inp, resolve_refs(fs, dpb, device, missing),
                      device=device, call=call, **frame_geometry(fs))
  return out["packed"], out["planes"], out["err"]


def walk_frames(aus, device, call):
  """Every frame of a stream's access units (VVCDecoder._split_aus) in
  decode order through the frame program, on one thread, each frame
  kept as a reference for the later ones: yields (fs, host inputs)
  after each frame's program ran, its residual error word read (a frame
  with rows out of range raises RuntimeError).  call: as in
  frame_program; a DMVR frame's search goes through it too, first
  (refine_dmvr).  The card checks walk streams with it, to hold each
  kernel call of the real program against its plain version."""
  colstore = ColStore()
  host, dpb = HostDecoder(colstore), {}
  for _, epoch, au in aus:
    fs = host.decode_au(au, epoch)
    if fs is None:
      continue
    if has_dmvr(fs):
      refine_dmvr(fs, colstore, epoch, dpb, device, call=call)
    h = build_host_inputs(fs)
    _, dpb[fs.poc], err = submit_frame(h, fs, device, dpb, call=call)
    raise_on_error(int(err.item()), f" (POC {fs.poc})")
    yield fs, h
