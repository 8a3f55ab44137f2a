"""DMVR and the inter prediction's DMVR windows and LMCS forward map in
the PyTorch port against the JAX package, bit for bit (tolerance 0: all
integer arithmetic).

The search (ops/dmvr.py) against JAX refine_frame_device and the numpy
models/vvc/dmvr.refine_frame on every DMVR frame of the `dmvr` and
`dmvr-bdof-tmvp` streams, with the references of the port's own CPU
decode of the frames before (whose MD5s equal the JAX package's,
tests/test_torch_decode.py), and on seeded random frames whose padding
holds garbage.  The plain inter prediction against JAX `_inter_pred_unit`
on the real MC batches of `dmvr-tools-ra` (DMVR, BDOF, PROF and LMCS) and
on seeded random batches with DMVR units whose refined reads cross their
original window and a random LMCS map (tests/torch_mc_rows.py).  JAX runs
on the CPU, the port on the CPU."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream
from ffmpeg_tpu.models.vvc import dmvr as JDH
from ffmpeg_tpu.models.vvc import pipeline as JP
from ffmpeg_tpu.ops import dmvr as JD
from ffmpeg_tpu_torch.models.vvc import host as TH
from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc.convert import _inter, _lmcs
from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
from ffmpeg_tpu_torch.models.vvc.mc_tiles import unpack
from ffmpeg_tpu_torch.models.vvc.pipeline import resolve_refs, submit_frame
from ffmpeg_tpu_torch.ops import dmvr as TD
from ffmpeg_tpu_torch.ops import inter as TIP
from torch_mc_rows import batch, random_lmcs, random_rows

torch.set_num_threads(2)

# the DMVR cases of tests/test_conformance.py (same ids and configs)
STREAMS = {
    "dmvr": dict(width=96, height=64, seed=2501, qp=28, inter=True,
                 b_slices=True, ra=True, n_frames=9, dmvr=True, max_mv=90),
    "dmvr-bdof-tmvp": dict(width=96, height=96, seed=2502, qp=28, inter=True,
                           b_slices=True, ra=True, n_frames=9, dmvr=True,
                           bdof=True, tmvp=True, deblock=True, sao=True,
                           max_mv=90),
    "dmvr-tools-ra": dict(width=96, height=64, seed=2503, qp=28, inter=True,
                          b_slices=True, ra=True, n_frames=9, dmvr=True,
                          bdof=True, mmvd=True, lmcs=True, affine=True,
                          prof=True, deblock=True, max_mv=90),
}

_PLANES6 = ("rx0", "ry0", "rx1", "ry1", "valid", "nobdof")


@functools.lru_cache(maxsize=None)
def _session(name):
  """Every frame of a stream in decode order through the port on the CPU,
  DMVR frames refined by the port's search: [(fs after the refinement,
  port host inputs, per-component reference planes as numpy [L0...,
  L1...], {name: (port planes6, JAX device planes6, numpy planes6,
  port subblock rows, JAX subblock rows)} for DMVR frames else None)]."""
  data, _ = encode_stream(EncoderConfig(**STREAMS[name]))
  aus = VVCDecoder(device="cpu")._split_aus(data)
  colstore = TH.ColStore()
  host, dpb, out = TH.HostDecoder(colstore), {}, []
  for _, epoch, au in aus:
    fs = host.decode_au(au, epoch)
    found = None
    if TI.has_dmvr(fs):
      H, W = fs.height, fs.width
      got = TD.refine_frame(fs, dpb, "cpu")
      dev = JD.refine_frame_device(
          fs, {p: [jnp.asarray(v[0].numpy())] for p, v in dpb.items()})
      np_host = JDH.refine_frame(
          fs, {p: v[0][:H, :W].numpy() for p, v in dpb.items()})
      found = (got, [np.asarray(a) for a in dev], np_host,
               TD.build_subblock_ctrl(fs), JD.build_subblock_ctrl(fs))
      TH.dmvr_apply(fs, colstore, epoch, got)
    t = TI.build_host_inputs(fs)
    refs = [[r.numpy() for r in comp]
            for comp in resolve_refs(fs, dpb, "cpu")]
    out.append((fs, t, refs, found))
    _, dpb[fs.poc], _ = submit_frame(t, fs, "cpu", dpb)
  return out


@pytest.mark.parametrize("name", ["dmvr", "dmvr-bdof-tmvp"])
def test_search_matches_jax(name):
  """The subblock rows and the six per-4x4 planes of every DMVR frame:
  port search = JAX device search = numpy host search."""
  n_frames = n_sub = n_moved = 0
  for fs, _, _, found in _session(name):
    if found is None:
      continue
    got, dev, np_host, ctrl, jctrl = found
    np.testing.assert_array_equal(ctrl, jctrl)
    for g, d, h, k in zip(got, dev, np_host, _PLANES6):
      np.testing.assert_array_equal(g, d, err_msg=f"{fs.poc} {k} (device)")
      np.testing.assert_array_equal(g, h, err_msg=f"{fs.poc} {k} (host)")
    n_frames += 1
    n_sub += ctrl.shape[1]
    n_moved += int((got[0][ctrl[1] >> 2, ctrl[0] >> 2] != ctrl[4]).sum())
  assert n_frames >= 2 and n_sub > 20 and n_moved > 0


def _fake_frame(rng, W, H, bd, n_cu, n_refs):
  """A frame of random DMVR units (the numpy search's own test layout);
  both lists name the same pictures, and every other unit reads both
  hypotheses from one picture a few samples apart, so that its SADs are
  small."""
  cus = {k: [] for k in ("dmvr", "x0", "y0", "w", "h", "mv_x", "mv_y",
                         "mv1_x", "mv1_y", "ref_idx", "ref_idx1")}
  for _ in range(n_cu):
    w, h = (int(v) for v in rng.choice([8, 16, 32], 2))
    h = 16 if w * h < 128 else h
    cus["dmvr"].append(1)
    cus["x0"].append(int(rng.integers(0, (W - w) // 8 + 1)) * 8)
    cus["y0"].append(int(rng.integers(0, (H - h) // 8 + 1)) * 8)
    cus["w"].append(w)
    cus["h"].append(h)
    for k in ("mv_x", "mv_y", "mv1_x", "mv1_y"):
      cus[k].append(int(rng.integers(-300, 300)))
    cus["ref_idx"].append(int(rng.integers(0, n_refs)))
    cus["ref_idx1"].append(int(rng.integers(0, n_refs)))
    if len(cus["w"]) % 2:
      cus["ref_idx1"][-1] = cus["ref_idx"][-1]
      cus["mv1_x"][-1] = cus["mv_x"][-1] + int(rng.integers(-24, 25))
      cus["mv1_y"][-1] = cus["mv_y"][-1] + int(rng.integers(-24, 25))
  return types.SimpleNamespace(
      cus={k: np.array(v, np.int32) for k, v in cus.items()}, width=W,
      height=H, bit_depth=bd,
      ref_pocs=(tuple(range(n_refs)), tuple(range(n_refs))))


def _smooth_plane(rng, H, W, bd):
  """A smooth random picture: 8x8 random levels, box-filtered, in a
  band of a sixteenth of the range in the top half and of the whole
  range in the bottom half, so that SADs range from small to large."""
  low = rng.integers(0, 1 << bd, (H // 8 + 2, W // 8 + 2))
  low[:H // 16 + 1] = (1 << (bd - 1)) + low[:H // 16 + 1] // 16
  up = np.kron(low, np.ones((8, 8)))
  c = np.cumsum(np.cumsum(np.pad(up, ((1, 0), (1, 0))), 0), 1)
  box = (c[8:, 8:] - c[:-8, 8:] - c[8:, :-8] + c[:-8, :-8]) // 64
  return box[:H, :W].astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_search_random_frames(bd):
  """Random DMVR units over smooth random references whose padding (below
  and right of the picture) holds garbage: the search reads the picture
  only, clamped at its edges."""
  rng = np.random.default_rng(bd)
  W, H = 128, 96
  fs = _fake_frame(rng, W, H, bd, 24, 2)
  planes = {p: _smooth_plane(rng, H, W, bd) for p in fs.ref_pocs[0]}
  dpb = {p: [torch.from_numpy(np.pad(v, ((0, 32), (0, 32)),
                                     constant_values=9999))]
         for p, v in planes.items()}
  want = JDH.refine_frame(fs, planes)
  got = TD.refine_frame(fs, dpb, "cpu")
  for g, w, k in zip(got, want, _PLANES6):
    np.testing.assert_array_equal(g, w, err_msg=k)
  moved = got[0][fs.cus["y0"] >> 2, fs.cus["x0"] >> 2] != fs.cus["mv_x"]
  assert np.any(got[5]) and not np.all(got[5][got[4] > 0]) and moved.any()


# ---- the inter prediction with DMVR windows and LMCS ---------------------

def _t(a):
  return torch.from_numpy(np.array(a, np.int32))


def _jax_pred(refs, c, wb, *, is_chroma, bit_depth, wrap, jlm):
  fn = jax.jit(jax.vmap(lambda cc, w1: JP._inter_pred_unit(
      refs, cc, maxs=32, taps=4 if is_chroma else 8,
      before=1 if is_chroma else 3, frac_bits=5 if is_chroma else 4,
      bit_depth=bit_depth, maxv=(1 << bit_depth) - 1, lmcs=jlm, wb=w1,
      wrap=wrap)))
  return np.asarray(fn({k: jnp.asarray(v) for k, v in c.items()},
                       jnp.asarray(wb)))


def _masked(tiles, w, h):
  d = np.arange(32)
  inside = (d[None, :, None] < h[:, None, None]) & (
      d[None, None, :] < w[:, None, None])
  return np.where(inside, tiles, 0)


def _check_pred(refs_np, rows, gwt, gslot, n_inter, *, is_chroma, bit_depth,
                wrap, cr, lm=None):
  """The plain prediction of one channel against JAX, within each unit.
  As in the JAX frame program, the n_inter pure inter rows go through
  _inter_pred_unit with their DMVR rows, the CIIP rows after them
  without; lm (host LMCS tables) maps the luma forward."""
  rows = {k: np.asarray(v, np.int32) for k, v in rows.items()}
  inter = _inter(batch(rows, gwt, gslot, is_chroma), n_inter, "cpu")
  tiles = TIP.inter_pred_plain(
      _t(refs_np), inter, is_chroma=is_chroma, bit_depth=bit_depth,
      wrap=wrap, cr=cr, lmcs=None if lm is None else _lmcs(lm, "cpu"))
  got = unpack(tiles, inter["toff"], inter["w"], inter["h"]).numpy()
  c = dict(rows)
  if cr:
    for a, b in TIP._CR_WEIGHTS:
      c[a] = rows[b]
  dmvr_keys = ("dmvr", "om0x", "om0y", "om1x", "om1y")
  ciip = {k: v[n_inter:] for k, v in c.items() if k not in dmvr_keys}
  jlm = None if lm is None else {k: jnp.asarray(v) for k, v in lm.items()}
  wb = gwt[gslot]
  want = [_jax_pred(jnp.asarray(refs_np), part, w, is_chroma=is_chroma,
                    bit_depth=bit_depth, wrap=wrap, jlm=jlm)
          for part, w in (({k: v[:n_inter] for k, v in c.items()},
                           wb[:n_inter]), (ciip, wb[n_inter:]))
          if len(w)]
  np.testing.assert_array_equal(got, _masked(np.concatenate(want), rows["w"],
                                             rows["h"]))


def test_inter_pred_plain_real():
  """Luma (LMCS-mapped), Cb and Cr tiles of every B frame of
  dmvr-tools-ra, with the refined MVs and the frame's real references."""
  n_dmvr = 0
  for fs, t, refs, _ in _session("dmvr-tools-ra"):
    if fs.slice_type == 2:
      continue
    H, W = fs.height, fs.width
    for c_idx in range(len(refs)):
      ss = 0 if c_idx == 0 else 1
      ct = t["ctrl"]["y" if c_idx == 0 else "c"]
      inter = ct["inter"]
      if not len(inter["x0"]):
        continue
      n_dmvr += int((inter["dmvr"] > 0).sum())
      stack = np.stack([r[:H >> ss, :W >> ss] for r in refs[c_idx]])
      _check_pred(stack, {k: inter[k] for k in TI.INTER_KEYS}, inter["gwt"],
                  inter["gslot"], int(ct["n_inter"]), is_chroma=c_idx > 0,
                  bit_depth=fs.bit_depth, wrap=fs.wrap_off >> ss,
                  cr=c_idx == 2, lm=t["lmcs"] if c_idx == 0 else None)
  assert n_dmvr > 0


def _crossing(rows, H, W, is_chroma):
  """DMVR units whose refined filter window leaves their original one
  (ops/inter.py _dmvr_windows) on some side: the case a picture clamp
  would get wrong."""
  taps, before, fb = (4, 1, 5) if is_chroma else (8, 3, 4)
  eb, ea = before, taps - before - 1
  on = rows["dmvr"] > 0
  out = np.zeros(len(on), bool)
  for lx in (0, 1):
    for a, size, n in (("x", rows["w"], W), ("y", rows["h"], H)):
      o = rows[f"{a}0"] + (rows[f"om{lx}{a}"] >> fb)
      lo = np.clip(o - eb, 0, n - 1)
      hi = lo + np.maximum(np.minimum(n, o + size + ea) - lo, 1) - 1
      r = rows[f"{a}0"] + (rows[f"m{lx}{a}"] >> fb) - before
      out |= on & ((r < lo) | (r + size + taps - 2 > hi))
  return int(out.sum())


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("chan", ["y", "cb", "cr"])
def test_inter_pred_plain_random_dmvr_lmcs(bd, chan):
  """Seeded random batches with DMVR units (a third of the rows, some
  with BDOF, some of the CIIP rows flagged too, which the JAX intra pass
  predicts without a window) and, for luma, a random LMCS map."""
  rng = np.random.default_rng(7000 + 100 * bd + ("y", "cb", "cr").index(chan))
  is_chroma = chan != "y"
  H, W, n_refs = (24, 40, 3) if is_chroma else (48, 80, 3)
  refs = rng.integers(0, 1 << bd, (n_refs, H, W)).astype(np.int32)
  rows, gwt, gslot = random_rows(rng, 192, H, W, n_refs, is_chroma, bd,
                                 dmvr=True)
  assert _crossing({k: v[:128] for k, v in rows.items()}, H, W,
                   is_chroma) > 5
  _check_pred(refs, rows, gwt, gslot, 128, is_chroma=is_chroma, bit_depth=bd,
              wrap=0, cr=chan == "cr",
              lm=None if is_chroma else random_lmcs(rng, bd))
