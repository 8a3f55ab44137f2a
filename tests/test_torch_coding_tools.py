"""The stages that ISP, 64-sample transform blocks (TB-64, CTU-128) and
explicit scaling lists add to the port, against the JAX package on the
CPU, at tolerance 0 (integer arithmetic, and float64 products that are
exact).

  - The residual stage: ops/transform.py bucket_residuals against JAX
    _bucket_residuals for every ISP, TB-64 and ISP-64 size class, with
    and without scaling lists, with transform skip, the MTS kinds and
    LFNST, and on chroma classes with joint CbCr and scaling lists;
    inputs made from a numpy seed.
  - The recon stage: the plain per-unit reconstruction, run in
    ops/recon.py dependency_levels order (shuffled within a level),
    against JAX _recon_plane on a TB-64 frame (luma units up to 64, maxs
    64), an ISP frame (1-high sub-partitions, readiness cell 1) and the
    B frames of a CTU-64 stream whose CIIP units reach 64x64 (their MC
    prediction from four 32x32 MC rows).
  - The schedule at readiness cell 1: every cell an ISP frame's unit
    waits on has an earlier writer, and the critical path equals the
    native parser's uncapped chunk count.
"""
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
from ffmpeg_tpu_torch.models.vvc.convert import inputs_from_numpy
from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
from ffmpeg_tpu_torch.models.vvc.pipeline import resolve_refs, submit_frame
from ffmpeg_tpu_torch.models.vvc.recon import CTRL_KEYS
from ffmpeg_tpu_torch.ops import recon as TR
from ffmpeg_tpu_torch.ops.inter import inter_pred
from ffmpeg_tpu_torch.ops.transform import (bucket_residuals, bucket_view,
                                            residual_plane)
from test_torch_decode import CODING_CASES, make_mip64, unit_kinds
from test_torch_recon_schedule import (_chunk_cap, _n_units, _owners,
                                       _recon_by_levels, _t)
from torch_residual_draws import _random_bucket, _scaling_lists

torch.set_num_threads(2)

LUMA_EXTRA = TI.ISP_EXTRA_SIZES + TI.TB64_EXTRA_SIZES + TI.ISP64_EXTRA_SIZES


def _residuals_both(w, h, bd, is_chroma, with_sl, seed):
  rng = np.random.default_rng(seed)
  mat, lv = _random_bucket(rng, w, h, bd, is_chroma)
  sl = _scaling_lists(rng) if with_sl else None
  n = mat.shape[1]
  want, mask = JP._bucket_residuals(
      {"mat": jnp.asarray(mat), "lv": jnp.asarray(lv),
       "n": jnp.asarray([n], jnp.int32)}, w, h, bd, is_chroma, None,
      None if sl is None else {k: jnp.asarray(v) for k, v in sl.items()})
  assert bool(np.asarray(mask).all())
  got = bucket_residuals(
      bucket_view({"mat": torch.from_numpy(mat), "lv": torch.from_numpy(lv),
                   "n": n}), w, h, bd, is_chroma,
      sl=None if sl is None else {k: torch.from_numpy(v)
                                  for k, v in sl.items()})
  return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("with_sl", [False, True])
@pytest.mark.parametrize("w,h", LUMA_EXTRA)
def test_luma_class_matches_jax(w, h, with_sl):
  """Every ISP, TB-64 and ISP-64 luma class: 1-D passes, the 64-point
  DCT2 with its zero-out, transform skip, MTS, LFNST, scaling lists."""
  bd = 10 if (w * h) % 3 else 8
  got, want = _residuals_both(w, h, bd, False, with_sl, 100 * w + h)
  assert got.shape == (24, h, w)
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h", [(2, 2), (4, 8), (16, 4), (32, 32)])
def test_chroma_class_scaling_lists_match_jax(w, h):
  """Chroma classes under scaling lists, with joint CbCr modes."""
  got, want = _residuals_both(w, h, 8, True, True, 7 * w + h)
  np.testing.assert_array_equal(got, want)


# ---- recon against JAX _recon_plane ---------------------------------------

RECON_CASES = ("tb64", "isp-10bit-filters", "ciip64")


@functools.lru_cache(maxsize=None)
def _frames(case):
  """Every frame of a coding case in decode order: (port fs, port fs
  parsed with no chunk cap, port host inputs, JAX host inputs,
  per-component reference planes as numpy), the references from the
  port's own CPU decode."""
  data, _ = encode_stream(EncoderConfig(**CODING_CASES[case]))
  aus = VVCDecoder(device="cpu")._split_aus(data)
  th, th0 = TH.HostDecoder(TH.ColStore()), TH.HostDecoder(TH.ColStore())
  jh = JH.HostDecoder(JH.ColStore())
  dpb, out = {}, []
  for _, epoch, au in aus:
    tfs, jfs = th.decode_au(au, epoch), jh.decode_au(au, epoch)
    with _chunk_cap(0):
      fs0 = th0.decode_au(au, epoch)
    if tfs is None:
      continue
    t = TI.build_host_inputs(tfs)
    j = JP.build_host_inputs(jfs, jfs.ctb_log2, pallas=False)
    refs = [[r.numpy() for r in comp]
            for comp in resolve_refs(tfs, dpb, "cpu")]
    out.append((tfs, fs0, t, j, refs))
    _, dpb[tfs.poc], _ = submit_frame(t, tfs, "cpu", dpb)
  return out


def _luma_maxs(fs):
  return min(64 if fs.has_tb64 else 32, 1 << fs.ctb_log2)


@functools.partial(jax.jit, static_argnames=("maxs", "bit_depth", "wrap"))
def _jax_luma(res, inter, n_inter, intra, n_chunks, refs, *, maxs, bit_depth,
              wrap):
  return JP._recon_plane(res, inter, n_inter, intra, n_chunks, refs,
                         maxs_inter=min(32, maxs), maxs_intra=maxs,
                         is_chroma=False, bit_depth=bit_depth, wrap=wrap)


@pytest.mark.parametrize("case", (*RECON_CASES, "tb64-mip64"))
def test_luma_level_order_matches_jax(case):
  """The plain per-unit luma recon, one unit at a time in dependency-level
  order at the call's readiness cell and maxs, equals JAX _recon_plane
  with the JAX frame program's maxs_intra_y, on every frame that carries
  the case's tool.  tb64-mip64: the tb64 frame with its 64x64 units made
  MIP units (test_torch_decode.make_mip64) on both sides."""
  want_kind = {"tb64": "edge64", "isp-10bit-filters": "cell1",
               "ciip64": "ciip64", "tb64-mip64": "mip64"}[case]
  seen = 0
  for i, (fs, _, t, j, refs) in enumerate(_frames(case.split("-mip")[0])):
    if case.endswith("mip64"):
      t, j = ({**h, "ctrl": {**h["ctrl"], "y": {
          **h["ctrl"]["y"], "intra": {k: np.array(v) for k, v in
                                      h["ctrl"]["y"]["intra"].items()}}}}
              for h in (t, j))
      n = int(t["ctrl"]["y"]["intra"]["iend"][-1])
      assert make_mip64(t["ctrl"]["y"]["intra"], n).size
      make_mip64(j["ctrl"]["y"]["intra"], n)
    inp = inputs_from_numpy(t, "cpu")
    ct = inp["ctrl"]["y"]
    maxs = _luma_maxs(fs)
    kinds = unit_kinds(dict(intra=ct["intra"], n_chunks=ct["n_chunks"],
                            is_chroma=False))
    if want_kind not in kinds:
      continue
    seen += 1
    Hp, Wp = TI._padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)[0]
    res = residual_plane(inp["planes"][0]["buckets"], Hp, Wp, fs.bit_depth,
                         list(inp["planes"][0]["buckets"]), False, "cpu",
                         sl=inp.get("sl"))
    tiles = None
    if ct["inter"]["n_mc"]:
      tiles = inter_pred([[_t(r) for r in refs[0]]], ct["inter"], H=fs.height,
                         W=fs.width, is_chroma=False, bit_depth=fs.bit_depth,
                         wrap=fs.wrap_off)[0]
    got = _recon_by_levels(res, ct, tiles, maxs=maxs, is_chroma=False,
                           bit_depth=fs.bit_depth, cclm=None, seed=i)
    jc = j["ctrl"]["y"]
    jin, jia = ({k: jnp.asarray(np.asarray(v, np.int32))
                 for k, v in jc[k].items()} for k in ("inter", "intra"))
    stack = (np.stack([r[:fs.height, :fs.width] for r in refs[0]]) if refs
             else np.zeros((1, fs.height, fs.width), np.int32))
    want = np.asarray(_jax_luma(
        jnp.asarray(res.numpy()), jin, jc["n_inter"], jia, jc["n_chunks"],
        jnp.asarray(stack), maxs=maxs, bit_depth=fs.bit_depth,
        wrap=fs.wrap_off))
    np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
  assert seen > 0


def test_isp_wait_cells_written_earlier_at_cell_1():
  """Readiness cell 1 (1-high ISP sub-partitions): every cell a luma unit
  waits for is written by an inter unit or by an intra unit earlier in
  layout order, no two intra units write one cell, and the critical path
  equals the native parser's chunk count with no cap (decode.cc tracks
  ISP frames at 1 sample)."""
  chunk = CTRL_KEYS.index("chunk")
  K = {k: TI.INTRA_KEYS.index(k) for k in TI.INTRA_KEYS}
  waits = 0
  for fs, fs0, t, _, _ in _frames("isp-10bit-filters"):
    ct = inputs_from_numpy(t, "cpu")["ctrl"]["y"]
    n = _n_units(ct)
    rows = ct["intra"]["mat_host"]
    assert TR.readiness_cell(rows[:, :n]) == 1
    Hp, Wp = TI._padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)[0]
    own = _owners(ct, Hp, Wp, C=1)
    for u in range(n):
      for a, b, c, d in TR._wait_rects(
          *(int(rows[K[k], u]) for k in ("x0", "y0", "avail_l", "avail_t",
                                         "cand_up_left", "mrl")), 1):
        cells = own[a:b, c:d]
        assert cells.size and ((cells == -1) | ((cells >= 0)
                                                & (cells < u))).all()
        waits += cells.size
    levels = TR.dependency_levels(ct["intra"], n, is_chroma=False)
    mat = fs0.ctrl_y
    assert int(levels.max(initial=0)) == int(mat[chunk].max()) + 1
  assert waits > 0
