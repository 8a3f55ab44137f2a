"""Inter prediction of the MC batch: the inter-prediction kernel and its
plain version.

Every unit of the MC batch (`inputs._layout_ctrl`: the pure inter units,
then the CIIP units) gets its clipped w x h prediction per channel, in
the MC tile format of `models.vvc.mc_tiles`: both hypotheses through
the separable 8-tap luma / 4-tap chroma filter (AMVR half-pel and affine
6-tap banks through `hpel`), reference wraparound, PROF, BDOF, uni/bi
rounding, explicit weights and BCW (Cr takes the second weight set), the
GPM blend, DMVR's read window around the original MV (the units filter
at the refined MV) and, for luma under LMCS, the forward mapping of the
prediction.  The recon pass places the pure units' samples and blends
the CIIP units' samples.

`inter_pred` is the entry point.  A CUDA tensor launches the kernel
(csrc/inter_pred.cu, up to two launches per plane kind per frame: the
small units of `inputs.mc_size_classes` one per half-warp, then the
large ones one per 128-thread block); a CPU tensor runs `inter_pred_plain_kind`, the
batched torch port of the JAX frame program's `_inter_pred_unit` (with
`_mc_block`, `_hwrap`, `_prof_refine` and `_bdof_bi`) on S x S tiles,
packed at the end, which is also the kernel's oracle.  All of it is
int32 arithmetic: the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..models.vvc import mc_tiles
from ..models.vvc.inputs import INTER_KEYS
from ..models.vvc.mc_tiles import MC_TILE
from .lmcs import lmcs_fwd
from .tables import VVC_TABLES, on_device

INTERP_LUMA = VVC_TABLES["interp_luma"].astype(np.int32)      # (3, 16, 8)
INTERP_CHROMA = VVC_TABLES["interp_chroma"].astype(np.int32)  # (3, 32, 4)

# Cr reads the second weight set of the shared chroma rows
_CR_WEIGHTS = (("w0", "w0b"), ("w1", "w1b"), ("wo0", "wo0b"), ("wo1", "wo1b"))

# units per batch of the plain version (bounds its gather indices)
_PLAIN_BATCH = 2048

# kernel launches (one per size class that has units), and apart by class
LAUNCHES = {"inter_pred": 0}
CLASS_LAUNCHES = {"small": 0, "large": 0}
PLAIN_RUNS = {"inter_pred": 0}

_I32 = torch.int32


def _ar(n, device):
  return torch.arange(n, dtype=_I32, device=device)


def _ilog2(v):
  """floor(log2(v)) for v > 0 (av_log2), saturating at 20 as the JAX
  reference counts it."""
  b = torch.zeros_like(v)
  for k in range(1, 21):
    b = b + (v >= (1 << k)).to(_I32)
  return b


class _Refs:
  """Stacked (n_refs, H, W) picture-size reference planes of one channel
  with the frame's clamps: rows to the picture, columns to the picture
  or through reference wraparound (ClipH, spec 8.5.6.3.2)."""

  def __init__(self, refs, wrap):
    self.n, self.H, self.W = refs.shape
    self.flat = refs.reshape(-1)
    self.wrap = wrap

  def window(self, slot, iy, ix, n, wrap_on, win=None):
    """(N, n, n) samples from rows iy.., columns ix.. of each unit's
    reference plane; columns wrap for the units where wrap_on (N,).
    win, when given, is each unit's (wx0, wx1, wy0, wy1) clamp window,
    inside the picture (DMVR's, or the picture itself)."""
    d = _ar(n, slot.device)
    ys = iy[:, None] + d
    xs = ix[:, None] + d
    if self.wrap:
      on = wrap_on[:, None]
      xs = torch.where(on & (xs < 0), xs + self.wrap, xs)
      xs = torch.where(on & (xs > self.W - 1), xs - self.wrap, xs)
    if win is None:
      xs = xs.clamp(0, self.W - 1)
      ys = ys.clamp(0, self.H - 1)
    else:
      wx0, wx1, wy0, wy1 = (v[:, None] for v in win)
      xs = torch.minimum(torch.maximum(xs, wx0), wx1)
      ys = torch.minimum(torch.maximum(ys, wy0), wy1)
    slot = slot.clamp(0, self.n - 1)
    idx = (slot[:, None, None] * (self.H * self.W) + ys[:, :, None] * self.W
           + xs[:, None, :])
    return self.flat[idx.long()]


def _mc_block(R, c, lx, *, taps, before, frac_bits, bit_depth, hp):
  """Separable MC window per unit (S x S), 14-bit out (`_mc_block`)."""
  S = MC_TILE
  mvx, mvy = (c["m1x"], c["m1y"]) if lx else (c["m0x"], c["m0y"])
  slot = c["r1slot"] if lx else c["r0slot"]
  mask = (1 << frac_bits) - 1
  fx, fy = (mvx & mask).long(), (mvy & mask).long()
  dev = mvx.device
  if taps == 4:
    ftab = on_device("interp_chroma0", dev,
                     lambda: torch.from_numpy(INTERP_CHROMA[0].copy()))
    hf, vf = ftab[fx], ftab[fy]
  else:
    ftab = on_device("interp_luma", dev,
                     lambda: torch.from_numpy(INTERP_LUMA.copy()))
    hf, vf = ftab[hp.long(), fx], ftab[hp.long(), fy]
  g = S + taps - 1
  win = R.window(slot, c["y0"] + (mvy >> frac_bits) - before,
                 c["x0"] + (mvx >> frac_bits) - before, g, c["wrap_mc"],
                 c[f"win{lx}"])
  acc = torch.zeros((win.shape[0], g, S), dtype=_I32, device=dev)
  for k in range(taps):
    acc += hf[:, k, None, None] * win[:, :, k:k + S]
  tmp = acc >> (bit_depth - 8)
  acc = torch.zeros((win.shape[0], S, S), dtype=_I32, device=dev)
  for k in range(taps):
    acc += vf[:, k, None, None] * tmp[:, k:k + S, :]
  return acc >> 6


def _int_ring(R, c, lx, n, bit_depth, wrap_on, win=None):
  """(N, n, n) integer-position reference samples around each unit,
  scaled to 14 bits (bdof_fetch_samples)."""
  mvx, mvy = (c["m1x"], c["m1y"]) if lx else (c["m0x"], c["m0y"])
  slot = c["r1slot"] if lx else c["r0slot"]
  iy = c["y0"] + (mvy >> 4) + ((mvy >> 3) & 1) - 1
  ix = c["x0"] + (mvx >> 4) + ((mvx >> 3) & 1) - 1
  return R.window(slot, iy, ix, n, wrap_on, win) << (14 - bit_depth)


def _prof_refine(R, c, t, lx, bit_depth):
  """PROF (8.5.5.9) on the 4x4 corner of each (affine subblock) unit's
  tile (`_prof_refine`)."""
  sfx = "1" if lx else "0"
  on = ((c["prof"] >> lx) & 1) > 0
  p = _int_ring(R, c, lx, 6, bit_depth, torch.ones_like(on))
  p[:, 1:5, 1:5] = t[:, :4, :4]
  gh = (p[:, 1:5, 2:6] >> 6) - (p[:, 1:5, 0:4] >> 6)
  gv = (p[:, 2:6, 1:5] >> 6) - (p[:, 0:4, 1:5] >> 6)
  dhx, dhy = c["pdhx" + sfx][:, None, None], c["pdhy" + sfx][:, None, None]
  dvx, dvy = c["pdvx" + sfx][:, None, None], c["pdvy" + sfx][:, None, None]
  d4 = _ar(4, t.device)
  xg, yg = d4[None, None, :], d4[None, :, None]
  rx = xg * (dhx * 4) + yg * (dhy * 4) - 6 * (dhx + dhy)
  ry = xg * (dvx * 4) + yg * (dvy * 4) - 6 * (dvx + dvy)
  dmx = ((rx + 128 - (rx >= 0).to(_I32)) >> 8).clamp(-31, 31)
  dmy = ((ry + 128 - (ry >= 0).to(_I32)) >> 8).clamp(-31, 31)
  lim = 1 << max(13, bit_depth + 1)
  di = (gh * dmx + gv * dmy).clamp(-lim, lim - 1)
  t = t.clone()
  t[:, :4, :4] = torch.where(on[:, None, None], t[:, :4, :4] + di,
                             t[:, :4, :4])
  return t


def _bdof_bi(R, c, t0, t1, bit_depth, maxv):
  """BDOF (8.5.6.4/5) for bi units of at most 16 x 16 (`_bdof_bi`):
  integer-ring pad, joint gradients, per-4x4 (vx, vy) from 6x6
  windows, then the per-sample offset.  Returns S x S tiles."""
  S = MC_TILE
  M = t0.shape[0]
  dev = t0.device
  w, h = c["w"][:, None, None], c["h"][:, None, None]
  d18 = _ar(18, dev)
  xi, yi = d18[None, None, :] - 1, d18[None, :, None] - 1
  inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
  xc = torch.minimum(xi.clamp(min=0), w - 1)
  yc = torch.minimum(yi.clamp(min=0), h - 1)

  def rep(t, stride):  # edge-replicated 18x18 (pad_int16)
    flat = t.reshape(M, -1)
    idx = (yc * stride + xc).clamp(0, flat.shape[1] - 1)
    return torch.gather(flat, 1, idx.reshape(M, -1).long()).reshape(M, 18, 18)

  t0r, t1r = rep(t0, S), rep(t1, S)
  p0 = torch.where(inside, t0r, _int_ring(R, c, 0, 18, bit_depth,
                                          c["wrap_mc"], c["win0"]))
  p1 = torch.where(inside, t1r, _int_ring(R, c, 1, 18, bit_depth,
                                          c["wrap_mc"], c["win1"]))

  def grad(p):  # 3-tap gradients on the int-ring padded signal
    return ((p[:, 1:17, 2:18] >> 6) - (p[:, 1:17, 0:16] >> 6),
            (p[:, 2:18, 1:17] >> 6) - (p[:, 0:16, 1:17] >> 6))

  gh0, gv0 = grad(p0)
  gh1, gv1 = grad(p1)
  temph = (rep(gh0, 16) + rep(gh1, 16)) >> 1
  tempv = (rep(gv0, 16) + rep(gv1, 16)) >> 1
  diff = (t0r >> 4) - (t1r >> 4)

  def win(a):  # (M, 4, 4, 6, 6): the 6x6 window of each 4x4 block
    return a.unfold(1, 6, 4).unfold(2, 6, 4)

  wh, wv, wd = win(temph), win(tempv), win(diff)
  sgx2 = wh.abs().sum((-1, -2), dtype=_I32)
  sgy2 = wv.abs().sum((-1, -2), dtype=_I32)
  sgxgy = (torch.sign(wv) * wh).sum((-1, -2), dtype=_I32)
  sgxdi = (-torch.sign(wh) * wd).sum((-1, -2), dtype=_I32)
  sgydi = (-torch.sign(wv) * wd).sum((-1, -2), dtype=_I32)
  zero = torch.zeros_like(sgx2)
  vx = torch.where(sgx2 > 0, ((sgxdi * 4) >> _ilog2(sgx2)).clamp(-15, 15),
                   zero)
  vy = torch.where(sgy2 > 0, (((sgydi * 4) - ((vx * sgxgy) >> 1))
                              >> _ilog2(sgy2)).clamp(-15, 15), zero)
  vx = vx.repeat_interleave(4, 1).repeat_interleave(4, 2)
  vy = vy.repeat_interleave(4, 1).repeat_interleave(4, 2)
  off = vx * (gh0 - gh1) + vy * (gv0 - gv1)
  shift4 = 15 - bit_depth
  res = ((t0[:, :16, :16] + t1[:, :16, :16] + (1 << (shift4 - 1)) + off)
         >> shift4).clamp(0, maxv)
  out = torch.zeros((M, S, S), dtype=_I32, device=dev)
  out[:, :16, :16] = res
  return out


def _dmvr_windows(R, c, *, taps, frac_bits):
  """Each unit's read window per list, (wx0, wx1, wy0, wy1): for a DMVR
  unit the reference region of its original MV (om*) and filter taps,
  clamped into the picture (emulated_edge_dmvr; `_inter_pred_unit`'s
  dmvr_win), which also bounds the reads at the refined MV; the picture
  for every other unit.  The CIIP rows (wrap_mc) take no DMVR window, as
  the JAX frame program's intra pass, which predicts them, has none."""
  eb, ea = (3, 4) if taps == 8 else (1, 2)
  on = (c["dmvr"] > 0) & ~c["wrap_mc"]
  out = []
  for lx in (0, 1):
    xsb = c["x0"] + (c[f"om{lx}x"] >> frac_bits)
    ysb = c["y0"] + (c[f"om{lx}y"] >> frac_bits)
    wx0 = (xsb - eb).clamp(0, R.W - 1)
    wx1 = wx0 + ((xsb + c["w"] + ea).clamp(max=R.W) - wx0).clamp(min=1) - 1
    wy0 = (ysb - eb).clamp(0, R.H - 1)
    wy1 = wy0 + ((ysb + c["h"] + ea).clamp(max=R.H) - wy0).clamp(min=1) - 1
    zero = torch.zeros_like(wx0)
    out.append((torch.where(on, wx0, zero),
                torch.where(on, wx1, zero + R.W - 1),
                torch.where(on, wy0, zero),
                torch.where(on, wy1, zero + R.H - 1)))
  return out


def _rows(c, sel):
  """The control rows (and read windows) of the units `sel`."""
  return {k: tuple(a[sel] for a in v) if isinstance(v, tuple) else v[sel]
          for k, v in c.items()}


def _pred_units(R, c, gwt, gslot, *, is_chroma, bit_depth, lmcs=None):
  """Clipped prediction tiles of N units of one channel
  (`_inter_pred_unit`), the luma mapped forward when lmcs is given."""
  S = MC_TILE
  bd = bit_depth
  maxv = (1 << bd) - 1
  taps, before, fb = (4, 1, 5) if is_chroma else (8, 3, 4)
  c = dict(c)
  c["win0"], c["win1"] = _dmvr_windows(R, c, taps=taps, frac_bits=fb)
  hp = torch.zeros_like(c["hpel"]) if is_chroma else c["hpel"]
  kw = dict(taps=taps, before=before, frac_bits=fb, bit_depth=bd, hp=hp)
  t0 = _mc_block(R, c, 0, **kw)
  t1 = _mc_block(R, c, 1, **kw)
  pf = c["pf"][:, None, None]
  if not is_chroma:
    sel = torch.nonzero(c["prof"] != 0).flatten()
    if sel.numel():
      cs = _rows(c, sel)
      t0[sel] = _prof_refine(R, cs, t0[sel], 0, bd)
      t1[sel] = _prof_refine(R, cs, t1[sel], 1, bd)
  shift2 = 14 - bd
  uni = torch.where(pf == 1, t0, t1)
  uni = ((uni + (1 << (shift2 - 1))) >> shift2).clamp(0, maxv)
  sh_avg = max(3, 15 - bd)
  bi = ((t0 + t1 + (1 << (sh_avg - 1))) >> sh_avg).clamp(0, maxv)
  if not is_chroma:
    sel = torch.nonzero(c["bdof"] > 0).flatten()
    if sel.numel():
      cs = _rows(c, sel)
      bi[sel] = _bdof_bi(R, cs, t0[sel], t1[sel], bd, maxv)
  # explicit uni weighting (put_uni_w) and weighted bi (w_avg: BCW and
  # explicit weights); wden < 0 selects the defaults, and the shift is
  # formed from max(wden, 0) so that it is never negative
  wden = c["wden"][:, None, None]
  wd = wden.clamp(min=0)
  w0, w1 = c["w0"][:, None, None], c["w1"][:, None, None]
  wo0, wo1 = c["wo0"][:, None, None], c["wo1"][:, None, None]
  shu = wd + 14 - bd
  t_act = torch.where(pf == 1, t0, t1)
  uni_w = (((t_act * w0 + ((torch.ones_like(shu) << shu) >> 1)) >> shu)
           + (wo0 << (bd - 8))).clamp(0, maxv)
  uni = torch.where(wden >= 0, uni_w, uni)
  shw = wd + max(3, 15 - bd)
  offw = (((wo0 + wo1) << (bd - 8)) + 1) << (shw - 1)
  bi_w = ((t0 * w0 + t1 * w1 + offw) >> shw).clamp(0, maxv)
  bi = torch.where(wden >= 0, bi_w, bi)
  pred = torch.where(pf == 3, bi, uni)
  sh_g = max(5, 17 - bd)
  wb = gwt[gslot.long()]
  gp = ((t0 * wb + t1 * (8 - wb) + (1 << (sh_g - 1))) >> sh_g).clamp(0, maxv)
  pred = torch.where(c["gpm_part"][:, None, None] > 0, gp, pred)
  if lmcs is not None:
    pred = lmcs_fwd(pred, lmcs, bd)
  d = _ar(S, pred.device)
  inside = ((d[None, :, None] < c["h"][:, None, None])
            & (d[None, None, :] < c["w"][:, None, None]))
  return torch.where(inside, pred, torch.zeros_like(pred))


def inter_pred_plain(refs, inter: dict, *, is_chroma: bool, bit_depth: int,
                     wrap: int = 0, cr: bool = False, lmcs=None):
  """Plain torch prediction tiles of one channel: refs (n_refs, H, W)
  picture-size planes [L0..., L1...]; inter: the converted MC batch
  (convert.inputs_from_numpy); cr: Cr, which takes the second weight
  set.  wrap: the channel's wraparound offset (0 = edge clamp).  lmcs:
  the frame's converted LMCS tables, given for luma: the prediction is
  mapped forward (ops/lmcs.py lmcs_fwd).  Returns the channel's (T,)
  int16 tiles (mc_tiles), computed as (n_mc, S, S) tiles and packed.

  The reads follow the JAX frame program's, whose pure inter units take
  the read window of `_inter_pred_unit` (every unit of its INTER_KEYS
  batch carries the DMVR rows): a DMVR unit clamps the MC window and the
  BDOF ring to the region of its original MV (`_dmvr_windows`), though
  it filters at the refined MV; every other pure unit clamps them to the
  picture.  The PROF ring always wraps.  CIIP units (rows n_inter..
  here, MC from the intra pass without that window) wrap every read."""
  PLAIN_RUNS["inter_pred"] += 1
  n = inter["n_mc"]
  R = _Refs(refs, wrap)
  keys = {k: inter[k] for k in INTER_KEYS}
  if cr:
    for a, b in _CR_WEIGHTS:
      keys[a] = inter[b]
  keys["wrap_mc"] = _ar(n, refs.device) >= inter["n_inter"]
  out = []
  for lo in range(0, n, _PLAIN_BATCH):
    c = {k: v[lo:lo + _PLAIN_BATCH] for k, v in keys.items()}
    out.append(_pred_units(R, c, inter["gwt"],
                           inter["gslot"][lo:lo + _PLAIN_BATCH],
                           is_chroma=is_chroma, bit_depth=bit_depth,
                           lmcs=lmcs))
  padded = (torch.cat(out) if out else
            torch.zeros((0, MC_TILE, MC_TILE), dtype=_I32, device=refs.device))
  return mc_tiles.pack(padded, inter["toff"], inter["w"], inter["h"])


# ----------------------------------------------------------------------
# CUDA kernel (csrc/inter_pred.cu), built with nvcc at first use and
# bound with ctypes
# ----------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "inter_pred.cu")
_lib = None

# limits of the kernel's parameter block (csrc/inter_pred.cu), and the
# length of its LMCS forward table (16 pivots, 16 scales)
MAX_NCH, MAX_REFS, LMCS_TABLE = 2, 32, 32


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("inter_pred", [_SRC]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.inter_pred_launch.restype = ctypes.c_int
    lib.inter_pred_launch.argtypes = [
        p, i, i, i,         # ctrl (NK, n_mc), NK, n_mc, n_inter
        p, i, i,            # work list, its length, class (0 small,
                            # 1 large)
        p, i, i,            # host array of ref plane pointers (nch,
                            # n_refs), n_refs, nch
        i, i, i,            # picture H, W, plane row stride
        p, p,               # GPM weight tiles, gslot
        p, ctypes.c_longlong,  # toff (n_mc + 1,), T
        p,                  # out (nch, T) int16
        i, i, i,            # is_chroma, bit_depth, wrap
        p,                  # host LMCS forward table (LMCS_TABLE,), or
                            # NULL: no mapping
        p]                  # stream
    lib.inter_pred_error_string.restype = ctypes.c_char_p
    lib.inter_pred_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


def _check(t, name, shape=None):
  if t.device.type != "cuda":
    raise ValueError(f"inter_pred: {name} must be a CUDA tensor")
  if t.dtype != torch.int32:
    raise ValueError(f"inter_pred: {name} must be int32, got {t.dtype}")
  if not t.is_contiguous():
    raise ValueError(f"inter_pred: {name} must be contiguous")
  if shape is not None and tuple(t.shape) != tuple(shape):
    raise ValueError(f"inter_pred: {name} has shape {tuple(t.shape)}, "
                     f"expected {tuple(shape)}")


def _lmcs_table(lmcs):
  """The kernel's LMCS forward table: pivot[0:16] then fwd_scale[0:16]
  (the host copy convert.py keeps), as a ctypes array; None without
  LMCS."""
  if lmcs is None:
    return None
  t = np.ascontiguousarray(lmcs["fwd_host"], np.int32)
  if t.shape != (LMCS_TABLE,):
    raise ValueError(f"inter_pred: LMCS table of shape {t.shape}")
  return (ctypes.c_int * LMCS_TABLE)(*t.tolist())


def _inter_cuda(refs, inter, *, H, W, is_chroma, bit_depth, wrap, lmcs=None,
                mark=None):
  """The kernel's launches on the current stream: the small units, then
  the large ones (a class with no unit is not launched), into one
  (nch, T) output.  mark(cls), if given, is called just before each (0
  small, 1 large), to record a CUDA event and time the two apart.  The
  host checks here are O(1): the kernel checks each unit against its
  class, its toff and T, and traps on a malformed batch."""
  nch, n_refs = len(refs), len(refs[0])
  n_mc = inter["n_mc"]
  mat = inter["mat"]
  dev = mat.device
  if not 1 <= nch <= MAX_NCH or not 1 <= n_refs <= MAX_REFS:
    raise ValueError(f"inter_pred: {nch} channels of {n_refs} references "
                     f"(at most {MAX_NCH} of {MAX_REFS})")
  _check(mat, "ctrl", (len(INTER_KEYS), n_mc))
  _check(inter["gslot"], "gslot", (n_mc,))
  _check(inter["gwt"], "gwt")
  if inter["gwt"].shape[1:] != (MC_TILE, MC_TILE):
    raise ValueError(f"inter_pred: gwt has shape {tuple(inter['gwt'].shape)}")
  _check(inter["toff"], "toff", (n_mc + 1,))
  n_list = {k: len(inter[k + "_host"]) for k in ("small", "large")}
  for k, n in n_list.items():
    _check(inter[k], k, (n,))
  if sum(n_list.values()) != n_mc:
    raise ValueError(f"inter_pred: the small and large lists hold "
                     f"{sum(n_list.values())} units of {n_mc}")
  T = inter["T"]
  if T != int(inter["toff_host"][-1]):
    raise ValueError(f"inter_pred: T {T} is not toff[-1]")
  Hp, Wp = refs[0][0].shape
  if Hp < H or Wp < W:
    raise ValueError(f"inter_pred: reference planes {Hp}x{Wp} are smaller "
                     f"than the picture {H}x{W}")
  for ch in refs:
    if len(ch) != n_refs:
      raise ValueError("inter_pred: channels differ in reference count")
    for r in ch:
      _check(r, "reference plane", (Hp, Wp))
  if lmcs is not None and is_chroma:
    raise ValueError("inter_pred: LMCS maps luma only")
  ptrs = (ctypes.c_longlong * (nch * n_refs))(
      *[r.data_ptr() for ch in refs for r in ch])
  lm = _lmcs_table(lmcs)
  out = torch.empty((nch, T), dtype=mc_tiles.DTYPE, device=dev)
  lib = _get_kernel()
  stream = torch.cuda.current_stream(dev).cuda_stream
  for cls, key in enumerate(("small", "large")):
    if mark is not None:
      mark(cls)
    if not n_list[key]:
      continue
    rc = lib.inter_pred_launch(
        mat.data_ptr(), len(INTER_KEYS), n_mc, inter["n_inter"],
        inter[key].data_ptr(), n_list[key], cls,
        ptrs, n_refs, nch, H, W, Wp, inter["gwt"].data_ptr(),
        inter["gslot"].data_ptr(), inter["toff"].data_ptr(), T,
        out.data_ptr(), int(is_chroma), bit_depth, wrap, lm, stream)
    if rc != 0:
      raise RuntimeError("inter_pred kernel launch failed: "
                         f"{lib.inter_pred_error_string(rc).decode()}")
    LAUNCHES["inter_pred"] += 1
    CLASS_LAUNCHES[key] += 1
  return out


def inter_pred(refs, inter: dict, *, H: int, W: int, is_chroma: bool,
               bit_depth: int, wrap: int = 0, lmcs=None):
  """Prediction samples of the MC batch of one plane kind.

  refs: per channel (1 for luma, 2 for Cb+Cr), the frame's reference
  planes [L0..., L1...] as padded (Hp, Wp) int32 DPB planes; reads
  clamp to the H x W picture, or to a DMVR unit's window (or wrap by
  `wrap` columns).  inter: the converted MC batch.  lmcs: the frame's
  converted LMCS tree, luma only: the prediction is mapped forward.
  Returns its (nch, T) int16 tiles (mc_tiles).  A
  CUDA batch launches the kernel; a CPU batch runs the plain version;
  nothing falls back from one to the other."""
  dev = inter["mat"].device
  if dev.type == "cuda":
    return _inter_cuda(refs, inter, H=H, W=W, is_chroma=is_chroma,
                       bit_depth=bit_depth, wrap=wrap, lmcs=lmcs)
  if dev.type != "cpu":
    raise ValueError(f"inter_pred: unsupported device {dev}")
  return inter_pred_plain_kind(refs, inter, H=H, W=W, is_chroma=is_chroma,
                               bit_depth=bit_depth, wrap=wrap, lmcs=lmcs)


def inter_pred_plain_kind(refs, inter: dict, *, H: int, W: int,
                          is_chroma: bool, bit_depth: int, wrap: int = 0,
                          lmcs=None):
  """inter_pred's plain version, with its arguments and result: every
  channel of the plane kind through inter_pred_plain."""
  return torch.stack([
      inter_pred_plain(torch.stack([r[:H, :W] for r in ch]), inter,
                       is_chroma=is_chroma, bit_depth=bit_depth, wrap=wrap,
                       cr=is_chroma and i == 1, lmcs=lmcs)
      for i, ch in enumerate(refs)])
