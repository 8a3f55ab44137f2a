"""LMCS and ALF of the PyTorch port against the JAX package, bit for bit
(tolerance 0: both are integer arithmetic).

LMCS: the forward and inverse luma maps over every sample value and the
per-VPDU chroma residual scales, on the LMCS parameters the native parser
reads from LMCS streams at 8, 10 and 12 bits, with and without tile
boundaries; the chroma residual scaling of the residual stage.  ALF: the
classification and the luma, chroma and cross-component filters on
seeded random planes and coefficients at 8, 10 and 12 bits and CTB 32
and 64 (every row of the planes, so rows on and next to the virtual
boundary and at the picture borders); the 64-bit activity compare; the
host's filter banks against the JAX builder's on real frames.  JAX runs
on the CPU, the port on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream
from ffmpeg_tpu.models.vvc import pipeline as JP
from ffmpeg_tpu.models.vvc.host import HostDecoder as JHost
from ffmpeg_tpu.ops import alf as JA
from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc.convert import inputs_from_numpy
from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
from ffmpeg_tpu_torch.models.vvc.host import HostDecoder as THost
from ffmpeg_tpu_torch.ops import alf as TA
from ffmpeg_tpu_torch.ops import lmcs as TL
from ffmpeg_tpu_torch.ops.transform import residual_plane

torch.set_num_threads(2)

# LMCS streams per bit depth, each with chroma residual scaling on: the
# `lmcs` case of tests/test_conformance.py, and the `lmcs-10bit-jcbcr`
# configuration at 10 and 12 bits with seeds whose picture header turns
# the scaling on
LMCS_STREAMS = {
    8: dict(width=96, height=96, seed=1501, qp=30, lmcs=True),
    10: dict(width=96, height=64, seed=1507, qp=32, lmcs=True, bit_depth=10,
             joint_cbcr=True, sao=True),
    12: dict(width=96, height=64, seed=1513, qp=32, lmcs=True, bit_depth=12,
             joint_cbcr=True),
}
# ALF streams: the `alf-ccalf` and `alf-ctu64-10bit` cases
ALF_STREAMS = {
    "alf-ccalf": dict(width=96, height=96, seed=1604, qp=30, alf=True,
                      ccalf=True),
    "alf-ctu64-10bit": dict(width=128, height=128, seed=1606, qp=30,
                            alf=True, ccalf=True, ctu_log2=6, max_bt_size=64,
                            bit_depth=10),
}


@functools.lru_cache(maxsize=None)
def _frame(kw_items):
  """Frame 0 of a generated stream, parsed by each package's own host
  parser: (port fs, JAX fs)."""
  data, _ = encode_stream(EncoderConfig(**dict(kw_items)))
  au = VVCDecoder(device="cpu")._split_aus(data)[0][2]
  return THost().decode_au(au, 0), JHost().decode_au(au, 0)


def _lmcs(bd):
  fs, jfs = _frame(tuple(sorted(LMCS_STREAMS[bd].items())))
  assert fs.lmcs is not None and fs.bit_depth == bd
  host = TI._lmcs_inputs(fs)
  jlm = JP.build_host_inputs(jfs, jfs.ctb_log2, pallas=False)["lmcs"]
  assert sorted(host) == sorted(jlm)
  for k, v in jlm.items():
    np.testing.assert_array_equal(np.asarray(v), host[k], err_msg=k)
  return fs, {k: torch.from_numpy(v) for k, v in host.items()}, \
      {k: jnp.asarray(v) for k, v in jlm.items()}


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_lmcs_maps_every_value(bd):
  """Forward and inverse maps over every sample value, and a margin of
  values outside the range (the JAX form maps those to its clip)."""
  _, lm, jlm = _lmcs(bd)
  x = np.arange(-64, (1 << bd) + 64, dtype=np.int32)
  for port, jax_fn in ((TL.lmcs_fwd, JP._lmcs_fwd),
                       (TL.lmcs_inv, JP._lmcs_inv)):
    want = np.asarray(jax_fn(jnp.asarray(x), jlm, bd))
    got = port(torch.from_numpy(x), lm, bd).numpy()
    np.testing.assert_array_equal(got, want, err_msg=port.__name__)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("tiles", [((), ()), ((32,), (32,)),
                                   ((64,), ())])
@pytest.mark.parametrize("vsz", [32, 64])
def test_lmcs_vpdu_scales(bd, tiles, vsz):
  fs, lm, jlm = _lmcs(bd)
  assert "chroma_scale" in lm
  rng = np.random.default_rng(bd * 100 + vsz + len(tiles[0]))
  H, W = 88, 136
  plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
  want = np.asarray(JP._lmcs_vpdu_scales(jnp.asarray(plane), jlm, W, H, vsz,
                                         bd, tiles))
  got = TL.lmcs_vpdu_scales_plain(torch.from_numpy(plane), lm, W, H, vsz,
                                  bd, tiles).numpy()
  np.testing.assert_array_equal(got, want)
  assert len(np.unique(want)) > 1


_JRES = jax.jit(JP._residual_from_buckets, static_argnums=(1, 2, 3, 4, 5))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_chroma_residual_scaling(bd):
  """The residual stage's chroma planes with per-VPDU LMCS scales (drawn
  from a seed, one per VPDU) against JAX _residual_from_buckets, joint
  CbCr rows included at 10 and 12 bits."""
  fs, _, _ = _lmcs(bd)
  t = TI.build_host_inputs(fs)
  tt = inputs_from_numpy(t, "cpu")
  _, (Hp, Wp) = TI._padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)
  vsz = min(1 << fs.ctb_log2, 64)
  n_vpdu = -(-fs.width // vsz) * -(-fs.height // vsz)
  scale = np.random.default_rng(bd).integers(
      1, 1 << 13, n_vpdu).astype(np.int32)
  for c in (1, 2):
    want = np.asarray(_JRES(t["planes"][c]["buckets"], Hp, Wp, bd,
                            tuple(TI.CHROMA_SIZES), True, jnp.asarray(scale)))
    assert np.any(want != 0)
    got = residual_plane(tt["planes"][c]["buckets"], Hp, Wp, bd,
                         TI.CHROMA_SIZES, True, "cpu",
                         torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"plane {c}")


# ---- ALF ----------------------------------------------------------------

def _alf_case(bd, ctb, seed):
  """A seeded random luma plane of 8x8 patches, each noise or stripes
  (horizontal, vertical or diagonal) at an amplitude from flat to full
  range, so that the classes and transposes vary; per-block coefficients
  and clips; a chroma plane with its per-sample coefficients, clips and
  CC-ALF coefficients."""
  rng = np.random.default_rng(seed)
  H, W = 2 * ctb + 24, 2 * ctb + 40
  yy, xx = np.mgrid[:H, :W]
  pats = np.stack([rng.integers(-1, 2, (H, W)), (yy % 2) * 2 - 1,
                   (xx % 2) * 2 - 1, ((xx + yy) % 2) * 2 - 1,
                   ((xx - yy) % 3) - 1])
  pick = rng.integers(0, len(pats), (H // 8 + 1, W // 8 + 1))
  amp = 1 << rng.integers(0, bd, (H // 8 + 1, W // 8 + 1))
  pick = pick.repeat(8, 0).repeat(8, 1)[:H, :W]
  amp = amp.repeat(8, 0).repeat(8, 1)[:H, :W]
  y = (1 << (bd - 1)) + amp * np.take_along_axis(pats, pick[None], 0)[0] // 2
  y = np.clip(y, 0, (1 << bd) - 1).astype(np.int32)
  nby, nbx = H // 4, W // 4
  coeff = rng.integers(-64, 64, (nby, nbx, 12)).astype(np.int32)
  clip = (1 << (bd - rng.choice([0, 3, 5, 7], (nby, nbx, 12)))).astype(
      np.int32)
  on = rng.random((nby, nbx)) < 0.8
  Hc, Wc = H // 2, W // 2
  ch = rng.integers(0, 1 << bd, (Hc, Wc)).astype(np.int32)
  ccoeff = rng.integers(-64, 64, (Hc, Wc, 6)).astype(np.int32)
  cclip = (1 << (bd - rng.choice([0, 3, 5, 7], (Hc, Wc, 6)))).astype(
      np.int32)
  cc = rng.integers(-64, 65, (Hc, Wc, 7)).astype(np.int32)
  con = rng.random((Hc, Wc)) < 0.8
  return y, coeff, clip, on, ch, ccoeff, cclip, cc, con


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


ALF_GRID = [(bd, ctb) for bd in (8, 10, 12) for ctb in (32, 64)]


@pytest.mark.parametrize("bd,ctb", ALF_GRID)
def test_alf_classify(bd, ctb):
  y = _alf_case(bd, ctb, bd * ctb)[0]
  jc, jt = JA.alf_classify(jnp.asarray(y), ctb, bd)
  tc, tt = TA.alf_classify(_t(y), ctb, bd)
  np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
  assert len(np.unique(np.asarray(jc))) > 10
  assert len(np.unique(np.asarray(jt))) == 4


@pytest.mark.parametrize("bd,ctb", ALF_GRID)
def test_alf_filter_luma(bd, ctb):
  y, coeff, clip, on = _alf_case(bd, ctb, bd * ctb + 1)[:4]
  want = np.asarray(JA.alf_filter_luma(jnp.asarray(y), jnp.asarray(coeff),
                                       jnp.asarray(clip), ctb,
                                       jnp.asarray(on), bd))
  got = TA.alf_filter_luma(_t(y), _t(coeff), _t(clip), ctb, _t(on), bd)
  np.testing.assert_array_equal(got.numpy(), want)
  assert np.any(want != y)


@pytest.mark.parametrize("bd,ctb", ALF_GRID)
def test_alf_filter_chroma(bd, ctb):
  _, _, _, _, ch, ccoeff, cclip, _, con = _alf_case(bd, ctb, bd * ctb + 2)
  want = np.asarray(JA.alf_filter_chroma(
      jnp.asarray(ch), jnp.asarray(ccoeff), jnp.asarray(cclip), ctb // 2,
      jnp.asarray(con), bd))
  got = TA.alf_filter_chroma(_t(ch), _t(ccoeff), _t(cclip), ctb // 2,
                             _t(con), bd)
  np.testing.assert_array_equal(got.numpy(), want)
  assert np.any(want != ch)


@pytest.mark.parametrize("bd,ctb", ALF_GRID)
def test_alf_filter_cc(bd, ctb):
  y, _, _, _, ch, _, _, cc, con = _alf_case(bd, ctb, bd * ctb + 3)
  want = np.asarray(JA.alf_filter_cc(jnp.asarray(ch), jnp.asarray(y),
                                     jnp.asarray(cc), ctb, jnp.asarray(con),
                                     bd))
  got = TA.alf_filter_cc(_t(ch), _t(y), _t(cc), ctb, _t(con), bd)
  np.testing.assert_array_equal(got.numpy(), want)
  assert np.any(want != ch)


def test_alf_activity_compare_is_exact():
  """The classification's d1 * hv0 <= hv1 * d0, a plain int64 compare in
  the port, against the JAX form's split products (_mulcmp_le), on values
  whose products pass 31 bits, and on ties.  The operands are sums of 16
  gradients of at most 2 * 2 * 4095 (12 bits), so below 2^18."""
  rng = np.random.default_rng(5)
  v = rng.integers(0, 1 << 18, (4, 4096)).astype(np.int32)
  v[2:, :256] = v[:2, :256][::-1]  # ties: a * b == b * a
  a, b, c, d = v
  want = np.asarray(JA._mulcmp_le(*map(jnp.asarray, (a, b, c, d))))
  got = a.astype(np.int64) * b <= c.astype(np.int64) * d
  np.testing.assert_array_equal(got, want)
  assert 0 < want.mean() < 1


@pytest.mark.parametrize("case", sorted(ALF_STREAMS))
def test_alf_host_banks(case):
  """The host's ALF tree (fixed banks through class_to_filt, the APS
  banks, clip values at the frame's bit depth, CC-ALF with its zero row)
  equals the JAX builder's on a real frame."""
  fs, jfs = _frame(tuple(sorted(ALF_STREAMS[case].items())))
  want = JP.build_host_inputs(jfs, jfs.ctb_log2, pallas=False)["alf"]
  got = TI.build_host_inputs(fs)["alf"]
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    assert got[k].dtype == np.asarray(v).dtype, k
    np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
  assert np.any(got["ctb"][..., 0])
