"""The port's inter path against the JAX package, bit for bit (tolerance
0: all of it is int32 arithmetic): the host inter layout, GPM weight
tiles and reference slots, the plain inter prediction, the plain
reconstruction with inter and CIIP units, and the deblock grids of
inter frames.  Frames are parsed from generated P/B streams in decode
order (TMVP motion crosses frames); their references are the planes of
the port's own CPU decode of the frames before them, whose MD5s equal
the JAX package's (tests/test_torch_decode.py).  JAX runs its default
non-Pallas frame program functions on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream
from ffmpeg_tpu.models.vvc import host as JH
from ffmpeg_tpu.models.vvc import pipeline as JP
from ffmpeg_tpu_torch.models.vvc import host as TH
from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc.convert import _inter, inputs_from_numpy
from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
from ffmpeg_tpu_torch.models.vvc.host import CHUNK_CAP
from ffmpeg_tpu_torch.models.vvc.mc_tiles import unpack
from ffmpeg_tpu_torch.models.vvc.pipeline import resolve_refs, submit_frame
from ffmpeg_tpu_torch.ops import inter as TIP
from ffmpeg_tpu_torch.ops import recon as TR
from ffmpeg_tpu_torch.ops.transform import residual_plane
from torch_mc_rows import batch, random_rows

torch.set_num_threads(2)

# P/B streams covering each inter tool of the slice (configs of
# tests/test_conformance.py ids ciip-deblock, bdof-affine-ra, gpm-filters,
# wp-b and wraparound-ra)
STREAMS = {
    "ciip": dict(width=96, height=96, seed=1802, qp=28, inter=True,
                 b_slices=True, n_frames=3, ciip=True, deblock=True,
                 sao=True),
    "bdof-affine": dict(width=96, height=96, seed=2405, qp=28, inter=True,
                        b_slices=True, ra=True, n_frames=5, bdof=True,
                        affine=True, prof=True, sbtmvp=True, deblock=True,
                        sao=True, max_mv=90),
    "gpm": dict(width=96, height=96, seed=1902, qp=28, inter=True,
                b_slices=True, n_frames=3, gpm=True, deblock=True, sao=True),
    "wp": dict(width=96, height=96, seed=2002, qp=28, inter=True,
               b_slices=True, n_frames=3, weighted_pred=True, deblock=True,
               sao=True),
    "wrap": dict(width=96, height=64, seed=4102, qp=32, wraparound=True,
                 inter=True, b_slices=True, ra=True, tmvp=True, n_frames=5,
                 max_mv=400, deblock=True, sao=True),
}


@functools.lru_cache(maxsize=None)
def _session(name):
  """Every frame of a stream in decode order, parsed by both packages'
  host parsers (each with its own TMVP store) and decoded by the port
  on the CPU: [(port fs, JAX fs, port host inputs, JAX host inputs,
  per-component reference planes as numpy [L0..., L1...])]."""
  data, _ = encode_stream(EncoderConfig(**STREAMS[name]))
  aus = VVCDecoder(device="cpu")._split_aus(data)
  th, jh = TH.HostDecoder(TH.ColStore()), JH.HostDecoder(JH.ColStore())
  dpb, out = {}, []
  for _, epoch, au in aus:
    tfs, jfs = th.decode_au(au, epoch), jh.decode_au(au, epoch)
    t = TI.build_host_inputs(tfs)
    j = JP.build_host_inputs(jfs, jfs.ctb_log2, pallas=False)
    refs = [[r.numpy() for r in comp]
            for comp in resolve_refs(tfs, dpb, "cpu")]
    out.append((tfs, jfs, t, j, refs))
    _, dpb[tfs.poc] = submit_frame(t, tfs, "cpu", dpb)
  return out


def _inter_frames(name):
  return [f for f in _session(name) if f[0].slice_type != 2]


def _np(a):
  return np.asarray(a).astype(np.int64)


def _t(a):
  return torch.from_numpy(np.array(a, np.int32))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inter_layout(name):
  """MC batch rows, reference slots, GPM weight tiles, gslot and the
  intra layout's CIIP tile index against JAX _layout_ctrl,
  _gpm_weight_blocks and _pallas_ctrl."""
  frames = _inter_frames(name)
  assert frames
  seen_mc = 0
  for tfs, jfs, t, j, _ in frames:
    for tag, mat in (("y", jfs.ctrl_y), ("c", jfs.ctrl_c)):
      jc, tc = j["ctrl"][tag], t["ctrl"][tag]
      n_mc = len(tc["inter"]["x0"])
      seen_mc += n_mc
      assert int(jc["n_inter"]) == int(tc["n_inter"])
      for k in TI.INTER_KEYS:
        np.testing.assert_array_equal(_np(jc["inter"][k])[:n_mc],
                                      _np(tc["inter"][k]), err_msg=k)
      n_gpm = int((tc["inter"]["gpm_part"] > 0).sum())
      np.testing.assert_array_equal(_np(jc["inter"]["gwt"])[:n_gpm],
                                    _np(tc["inter"]["gwt"])[:n_gpm])
      np.testing.assert_array_equal(_np(jc["inter"]["gslot"])[:n_mc],
                                    _np(tc["inter"]["gslot"]))
      nch = int(tc["n_chunks"])
      assert int(jc["n_chunks"]) == nch
      n_iu = int(tc["intra"]["iend"][-1]) if nch else 0
      for k in TI.INTRA_KEYS:
        np.testing.assert_array_equal(_np(jc["intra"][k])[:n_iu + CHUNK_CAP],
                                      _np(tc["intra"][k]), err_msg=k)
      if mat is None:
        continue
      ipos = JP._pallas_ctrl(mat, (jfs.width, jfs.height), tag)["ipos"]
      chunk = mat[JP.CTRL_KEYS.index("chunk")]
      intra_idx = np.flatnonzero(chunk >= 0)
      src = intra_idx[np.argsort(chunk[intra_idx], kind="stable")]
      np.testing.assert_array_equal(_np(tc["intra"]["ipos"])[:n_iu],
                                    _np(ipos[src]))
  assert seen_mc > 0


def _jax_pred(refs, c, wb, *, is_chroma, bit_depth, wrap):
  """vmapped JAX _inter_pred_unit on (n, S, S) tiles."""
  fn = jax.jit(jax.vmap(lambda cc, w1: JP._inter_pred_unit(
      refs, cc, maxs=32, taps=4 if is_chroma else 8,
      before=1 if is_chroma else 3, frac_bits=5 if is_chroma else 4,
      bit_depth=bit_depth, maxv=(1 << bit_depth) - 1, wb=w1, wrap=wrap)))
  return np.asarray(fn({k: jnp.asarray(v) for k, v in c.items()},
                       jnp.asarray(wb)))


def _masked(tiles, w, h):
  d = np.arange(32)
  inside = (d[None, :, None] < h[:, None, None]) & (
      d[None, None, :] < w[:, None, None])
  return np.where(inside, tiles, 0)


def _check_pred(refs_np, rows, gwt, gslot, n_inter, *, is_chroma, bit_depth,
                wrap, cr):
  """The plain prediction of one channel against JAX, within each unit;
  0 outside it (the compact tiles unpacked).  As in the JAX frame
  program, the n_inter pure inter rows go through _inter_pred_unit with
  its DMVR rows present (DMVR off), the CIIP rows after them without."""
  rows = {k: np.asarray(v, np.int32) for k, v in rows.items()}
  inter = _inter(batch(rows, gwt, gslot, is_chroma), n_inter, "cpu")
  tiles = TIP.inter_pred_plain(_t(refs_np), inter, is_chroma=is_chroma,
                               bit_depth=bit_depth, wrap=wrap, cr=cr)
  got = unpack(tiles, inter["toff"], inter["w"], inter["h"]).numpy()
  c = dict(rows)
  if cr:
    for a, b in TIP._CR_WEIGHTS:
      c[a] = rows[b]
  wb = gwt[gslot]
  dmvr = ("dmvr", "om0x", "om0y", "om1x", "om1y")
  pure = {k: v[:n_inter] for k, v in c.items()}
  pure.update({k: np.zeros(n_inter, np.int32) for k in dmvr})
  want = [_jax_pred(jnp.asarray(refs_np), part, w, is_chroma=is_chroma,
                    bit_depth=bit_depth, wrap=wrap)
          for part, w in ((pure, wb[:n_inter]),
                          ({k: v[n_inter:] for k, v in c.items()
                            if k not in dmvr}, wb[n_inter:]))
          if len(w)]
  np.testing.assert_array_equal(got, _masked(np.concatenate(want), rows["w"],
                                             rows["h"]))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inter_pred_plain_real(name):
  """Luma, Cb and Cr tiles of every P/B frame's MC batch, with the
  frame's real references."""
  n_units = 0
  for tfs, _, t, _, refs in _inter_frames(name):
    H, W = tfs.height, tfs.width
    for c_idx in range(len(refs)):
      ss = 0 if c_idx == 0 else 1
      inter = t["ctrl"]["y" if c_idx == 0 else "c"]["inter"]
      if not len(inter["x0"]):
        continue
      n_units += len(inter["x0"])
      stack = np.stack([r[:H >> ss, :W >> ss] for r in refs[c_idx]])
      _check_pred(stack, {k: inter[k] for k in TI.INTER_KEYS}, inter["gwt"],
                  inter["gslot"], int(t["ctrl"]["y" if c_idx == 0 else "c"]
                                      ["n_inter"]), is_chroma=c_idx > 0,
                  bit_depth=tfs.bit_depth, wrap=tfs.wrap_off >> ss,
                  cr=c_idx == 2)
  assert n_units > 0


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("chan", ["y", "cb", "cr"])
@pytest.mark.parametrize("wrap", [0, 1])
def test_inter_pred_plain_random(bd, chan, wrap):
  rng = np.random.default_rng(1000 * bd + 10 * ("y", "cb", "cr").index(chan)
                              + wrap)
  is_chroma = chan != "y"
  H, W, n_refs = (24, 40, 3) if is_chroma else (48, 80, 3)
  refs = rng.integers(0, 1 << bd, (n_refs, H, W)).astype(np.int32)
  rows, gwt, gslot = random_rows(rng, 192, H, W, n_refs, is_chroma, bd)
  _check_pred(refs, rows, gwt, gslot, 128, is_chroma=is_chroma, bit_depth=bd,
              wrap=(W - 8 if wrap else 0), cr=chan == "cr")


def _residuals(fs, j):
  (Hp_y, Wp_y), (Hp_c, Wp_c) = TI._padded_plane_shapes(fs.width, fs.height,
                                                       fs.ctb_log2)
  tj = inputs_from_numpy({"planes": j["planes"], "ctrl": {}}, "cpu")
  return [residual_plane(tj["planes"][c]["buckets"],
                         Hp_y if c == 0 else Hp_c, Wp_y if c == 0 else Wp_c,
                         fs.bit_depth,
                         TI.LUMA_SIZES if c == 0 else TI.CHROMA_SIZES, c > 0,
                         "cpu").numpy() for c in range(len(j["planes"]))]


@pytest.mark.parametrize("name", ["ciip", "bdof-affine", "gpm", "wrap"])
def test_recon_plain_inter(name):
  """The plain reconstruction (inter placement, intra chunks, CIIP
  blend) of each P/B frame's luma and chroma planes against JAX
  _recon_plane with the same references; chroma CCLM from the same
  reconstructed luma."""
  n_ciip = 0
  for fs, _, t, j, refs in _inter_frames(name):
    bd, H, W = fs.bit_depth, fs.height, fs.width
    res = _residuals(fs, j)
    inp = inputs_from_numpy(t, "cpu")
    luma = None
    for c_idx in range(len(refs)):
      ss = 0 if c_idx == 0 else 1
      tag = "y" if c_idx == 0 else "c"
      jc, tc = j["ctrl"][tag], inp["ctrl"][tag]
      maxs = min(32, (1 << fs.ctb_log2) >> ss)
      wrap = fs.wrap_off >> ss
      stack = [r[:H >> ss, :W >> ss] for r in refs[c_idx]]
      cclm = None
      if c_idx and "cclm_vc" in j:
        vc = j["cclm_vc"]
        cclm = (jnp.asarray(luma), JP.I.cclm_dsy_plane(jnp.asarray(luma), vc),
                vc)
      jin, jia = (jax.tree_util.tree_map(jnp.asarray, jc[k])
                  for k in ("inter", "intra"))
      want = np.asarray(JP._recon_plane(
          jnp.asarray(res[c_idx]), jin, jc["n_inter"], jia, jc["n_chunks"], jnp.asarray(np.stack(stack)), maxs_inter=maxs,
          maxs_intra=maxs, is_chroma=c_idx > 0, bit_depth=bd,
          cr_weights=c_idx == 2, cclm=cclm, wrap=wrap))
      tiles = None
      if tc["inter"]["n_mc"]:
        tiles = TIP.inter_pred([[_t(r) for r in refs[c_idx]]], tc["inter"],
                               H=H >> ss, W=W >> ss, is_chroma=c_idx > 0,
                               bit_depth=bd, wrap=wrap)
        if c_idx == 2:  # Cr: the second weight set, as the chroma call
          tiles = TIP.inter_pred([[_t(r) for r in refs[1]],
                                  [_t(r) for r in refs[2]]], tc["inter"],
                                 H=H >> ss, W=W >> ss, is_chroma=True,
                                 bit_depth=bd, wrap=wrap)[1:]
      tcclm = None
      if cclm is not None:
        tcclm = (_t(luma), TR.I.cclm_dsy_plane(_t(luma), inp["cclm_vc"]))
      got = TR.recon_plane(_t(res[c_idx])[None], tc["intra"],
                           tc["n_chunks"], tc["inter"], tiles, maxs=maxs,
                           is_chroma=c_idx > 0, bit_depth=bd,
                           cclm=tcclm)[0].numpy()
      np.testing.assert_array_equal(got, want, err_msg=f"{fs.poc} {c_idx}")
      n_ciip += int((tc["intra"]["mat_host"][TI.INTRA_KEYS.index("ciipw")]
                     > 0).sum())
      if c_idx == 0:
        luma = want
  if name == "ciip":
    assert n_ciip > 0


@pytest.mark.parametrize("name", ["bdof-affine", "gpm", "wp"])
def test_deblock_grids_inter(name):
  """Boundary strength from motion (and every other grid) of each P/B
  frame against JAX _deblock_grids."""
  motion_edges = 0
  for fs, jfs, _, _, _ in _inter_frames(name):
    shapes = TI._padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)
    (Hp_y, Wp_y), (Hp_c, Wp_c) = shapes
    want = JP._deblock_grids(jfs, Hp_y, Wp_y, Hp_c, Wp_c, jfs.ctb_log2)
    got = TI._deblock_grids(fs, Hp_y, Wp_y, Hp_c, Wp_c, fs.ctb_log2)
    assert sorted(want) == sorted(got)
    for k in want:
      np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    motion_edges += int((np.asarray(got["ybs_v"]) == 1).sum())
  assert motion_edges > 0  # bs 1: edges that only motion makes

