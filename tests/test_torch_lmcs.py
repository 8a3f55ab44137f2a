"""LMCS: the inverse map's entry point lmcs_inv (its plain version on the
CPU) and the chroma scales' plain version lmcs_vpdu_scales_plain against
the JAX frame program's `_lmcs_inv` and `_lmcs_vpdu_scales`, bit for bit
(tolerance 0: integer arithmetic), on LMCS tables drawn from a seed the
way the parser derives them (bin codewords, the pivots, the inverse and
chroma scales) at 8, 10 and 12 bits; the chroma scales read through the
padded plane's row stride (W < Wp) with tile boundaries at VPDU sizes 32
and 64; a tile list over the chroma residual kernel's cap raising in the
residual call that takes the scales' source; the host table `inv_host`
equal to the device tables; and (on the card) the CUDA kernel
csrc/lmcs.cu against the plain version, the inverse map on every value
from -64 to 2^bd + 64 and on int32 values far outside that range, on a
1088x1920 plane and on lengths around the kernel's per-thread and
per-block chunks, and the chroma residual kernel (csrc/residual.cu,
which derives the scales per TU, csrc/lmcs_scale.cuh) against the plain
pair, lmcs_vpdu_scales_plain then the plain chroma residual, on the same
planes and tables.

JAX is imported inside the tests that need it, so that the card, which
has no JAX, collects the `gpu` tests:

  python -m pytest --noconftest -m gpu tests/test_torch_lmcs.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ffmpeg_tpu_torch.models.vvc.convert import _lmcs  # noqa: E402
from ffmpeg_tpu_torch.ops import lmcs as TL  # noqa: E402

torch.set_num_threads(2)

BDS = (8, 10, 12)
# (min_bin, max_bin): the parser's max_bin = 15 - min_bin, and max_bin 15
# (a sample past the last pivot takes bin 16 and maps to 0)
BINS = ((1, 14), (3, 12), (2, 15))
TILES = (((), ()), ((64,), (64,)), ((128,), ()), ((), (64, 128)))


def draw_lmcs(bd, bins, seed, crs=True):
  """An LMCS host tree (inputs._lmcs_inputs's layout) derived as the
  native parser derives it (decode.cc derive_lmcs) from bin codewords
  drawn from a seed: org_cw + delta in [org_cw / 8, 2 org_cw) for the
  bins in [min_bin, max_bin], 0 elsewhere, scaled down where their sum
  would pass 2^bd - 1 (a conforming stream's limit)."""
  rng = np.random.default_rng(seed)
  org = (1 << bd) // 16
  shift = org.bit_length() - 1
  mb, xb = bins
  cw = np.zeros(16, np.int64)
  cw[mb:xb + 1] = rng.integers(org // 8, 2 * org, xb - mb + 1)
  if cw.sum() > (1 << bd) - 1:
    cw = np.maximum(cw * ((1 << bd) - 1) // cw.sum(), 1) * (cw > 0)
  pivot = np.concatenate([[0], np.cumsum(cw)])
  fwd = (cw * (1 << 11) + (1 << (shift - 1))) >> shift
  inv = np.where(cw > 0, org * (1 << 11) // np.maximum(cw, 1), 0)
  delta_crs = int(rng.integers(-7, 8))
  chroma = np.where(cw > 0, org * (1 << 11)
                    // np.maximum(cw + delta_crs, 1), 1 << 11)
  lm = {"pivot": pivot, "fwd_scale": fwd, "inv_scale": inv,
        "bins": np.array([mb, xb])}
  if crs:
    lm["chroma_scale"] = chroma
  return {k: v.astype(np.int32) for k, v in lm.items()}


def _ids(b):
  return f"bins{b[0]}-{b[1]}"


def _jax_lm(host):
  import jax.numpy as jnp

  return {k: jnp.asarray(v) for k, v in host.items()}


def padded_plane(bd, H, W, seed):
  """A (Hp, Wp) int32 plane padded past the (H, W) picture (its padding
  at the maximum, which a read past the picture would pick up)."""
  rng = np.random.default_rng(seed)
  Hp, Wp = H + 24, W + 40
  plane = np.full((Hp, Wp), (1 << bd) - 1, np.int32)
  plane[:H, :W] = rng.integers(0, 1 << bd, (H, W))
  # flat regions: whole VPDU borders at one level
  plane[:H, 60:70] = rng.integers(0, 1 << bd)
  return plane


@pytest.mark.parametrize("bins", BINS, ids=_ids)
@pytest.mark.parametrize("bd", BDS)
def test_lmcs_inv_matches_jax(bd, bins):
  """Every value from -64 to 2^bd + 64 (the JAX form's clip and its bin
  16), through the wrapper (the plain version on the CPU)."""
  import jax.numpy as jnp

  from ffmpeg_tpu.models.vvc import pipeline as JP

  host = draw_lmcs(bd, bins, seed=bd + bins[0])
  lm = _lmcs(host, "cpu")
  x = np.arange(-64, (1 << bd) + 64, dtype=np.int32)
  runs = TL.PLAIN_RUNS["lmcs_inv"]
  got = TL.lmcs_inv(torch.from_numpy(x), lm, bd).numpy()
  assert TL.PLAIN_RUNS["lmcs_inv"] == runs + 1
  want = np.asarray(JP._lmcs_inv(jnp.asarray(x), _jax_lm(host), bd))
  np.testing.assert_array_equal(got, want)
  if bins[1] == 15:
    # past the last pivot: bin 16, mapped to 0
    assert want[-1] == 0 and x[-1] >= host["pivot"][16]


@pytest.mark.parametrize("vsz", [32, 64])
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("bd", BDS)
def test_lmcs_vpdu_scales_strided_matches_jax(bd, tiles, vsz):
  """The chroma scales from the picture as a view of its padded plane
  (rows read through the plane's stride), against JAX on the contiguous
  picture."""
  import jax.numpy as jnp

  from ffmpeg_tpu.models.vvc import pipeline as JP

  H, W = 152, 200
  host = draw_lmcs(bd, BINS[len(tiles[0]) % 3], seed=bd * 7 + vsz)
  lm = _lmcs(host, "cpu")
  plane = padded_plane(bd, H, W, seed=bd + vsz)
  view = torch.from_numpy(plane)[:H, :W]
  assert not view.is_contiguous()
  got = TL.lmcs_vpdu_scales_plain(view, lm, W, H, vsz, bd, tiles).numpy()
  want = np.asarray(JP._lmcs_vpdu_scales(
      jnp.asarray(plane[:H, :W]), _jax_lm(host), W, H, vsz, bd, tiles))
  np.testing.assert_array_equal(got, want)
  assert got.shape == (-(-W // vsz) * -(-H // vsz),)
  assert len(np.unique(want)) > 1


def _chroma_call(plane, lm, vsz, bd, tiles, device="cpu"):
  """A seeded chroma residual call (tests/torch_residual_draws.py) whose
  scales' source is the (H, W) picture `plane` with lm, vsz and tiles,
  its TUs pointed at every VPDU of that picture in turn."""
  from torch_residual_draws import draw_call, spread_vpdus

  kw = draw_call("chroma", bd, n=24, seed=bd + vsz, device=device)
  H, W = plane.shape
  kw["scale_src"] = {"luma": plane, "lm": lm, "vsz": vsz,
                     "tile_bds": tiles}
  spread_vpdus(kw, -(-W // vsz) * -(-H // vsz))
  return kw


def test_lmcs_vpdu_scales_tile_cap():
  """More tile boundaries than the chroma residual kernel's parameter
  block holds raise in the call that takes the scales' source (on any
  device: the call is refused, not cut short); at the cap it runs."""
  from ffmpeg_tpu_torch.ops.transform import residual_planes

  host = draw_lmcs(8, BINS[0], seed=1)
  lm = _lmcs(host, "cpu")
  plane = torch.zeros((64, 64), dtype=torch.int32)
  over = tuple(range(1, TL.MAX_TILE_BDS + 2))
  for bds in ((over, ()), ((), over)):
    with pytest.raises(ValueError, match="tile boundaries"):
      residual_planes(**_chroma_call(plane, lm, 32, 8, bds))
  at_cap = tuple(range(1, TL.MAX_TILE_BDS + 1))
  kw = _chroma_call(plane, lm, 32, 8, (at_cap, at_cap))
  assert residual_planes(**kw).shape == (2, kw["Hp"], kw["Wp"])


@pytest.mark.parametrize("crs", [True, False])
@pytest.mark.parametrize("bd", BDS)
def test_inv_host_equals_device_tables(bd, crs):
  """convert._lmcs's host table for the LMCS kernels holds the device
  tables, in the order csrc/lmcs.cu reads them."""
  lm = _lmcs(draw_lmcs(bd, BINS[2], seed=bd, crs=crs), "cpu")
  keys = ("pivot", "inv_scale", "bins") + (("chroma_scale",) if crs else ())
  want = torch.cat([lm[k] for k in keys]).numpy()
  assert lm["inv_host"].dtype == np.int32
  np.testing.assert_array_equal(lm["inv_host"], want)
  assert len(want) == (TL.INV_TABLE_CRS if crs else TL.INV_TABLE)


def test_lmcs_refuses_other_devices():
  """The inverse map, and a chroma residual call with the scales' source,
  on a device that is neither CUDA nor the CPU raise."""
  from ffmpeg_tpu_torch.ops.transform import residual_planes

  lm = _lmcs(draw_lmcs(8, BINS[0], seed=2), "cpu")
  x = torch.zeros((8, 8), dtype=torch.int32, device="meta")
  with pytest.raises(ValueError, match="device"):
    TL.lmcs_inv(x, lm, 8)
  kw = _chroma_call(x, lm, 32, 8, ((), ()), device="meta")
  with pytest.raises(ValueError, match="device"):
    residual_planes(**kw)


def test_frame_program_lmcs_tables_on_host():
  """The frame program's LMCS trees carry inv_host: the full1080 frame
  0's converted tree."""
  from ffmpeg_tpu_torch.models.vvc.convert import inputs_from_numpy
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.host import HostDecoder
  from ffmpeg_tpu_torch.models.vvc.inputs import build_host_inputs

  path = os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "ffmpeg_tpu_torch", "testdata",
      "full1080.vvc")
  with open(path, "rb") as f:
    au = VVCDecoder(device="cpu")._split_aus(f.read())[0][2]
  h = build_host_inputs(HostDecoder().decode_au(au, 0))
  lm = inputs_from_numpy(h, "cpu")["lmcs"]
  assert len(lm["inv_host"]) == TL.INV_TABLE_CRS
  np.testing.assert_array_equal(lm["inv_host"][:17], h["lmcs"]["pivot"])
  np.testing.assert_array_equal(lm["inv_host"][35:],
                                h["lmcs"]["chroma_scale"])


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_lmcs.py)")
  return torch.device("cuda")


def _launched(name, fn):
  """fn's result, and that it launched the `name` kernel once and ran no
  plain version."""
  before, runs = TL.LAUNCHES[name], TL.PLAIN_RUNS[name]
  out = fn()
  torch.cuda.synchronize()
  assert TL.LAUNCHES[name] == before + 1 and TL.PLAIN_RUNS[name] == runs
  return out


@pytest.mark.gpu
@pytest.mark.parametrize("bins", BINS, ids=_ids)
@pytest.mark.parametrize("bd", BDS)
def test_lmcs_inv_kernel_every_value(cuda, bd, bins):
  """Every value from -64 to 2^bd + 64, then int32 values drawn over the
  whole range (the products wrap), as a 1-D tensor whose length is not
  a multiple of 4, and as a 2-D plane 4 bytes off alignment."""
  lm = _lmcs(draw_lmcs(bd, bins, seed=bd + bins[0]), cuda)
  x = torch.arange(-64, (1 << bd) + 64, dtype=torch.int32, device=cuda)
  got = _launched("lmcs_inv", lambda: TL.lmcs_inv(x, lm, bd))
  assert torch.equal(got, TL.lmcs_inv_plain(x, lm, bd))
  rng = np.random.default_rng(bd)
  wide = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 4099).astype(
      np.int32)).to(cuda)
  got = _launched("lmcs_inv", lambda: TL.lmcs_inv(wide, lm, bd))
  assert torch.equal(got, TL.lmcs_inv_plain(wide, lm, bd))
  big = torch.from_numpy(rng.integers(-64, (1 << bd) + 64, 1 + 96 * 136)
                         .astype(np.int32)).to(cuda)
  plane = big[1:].view(96, 136)
  got = _launched("lmcs_inv", lambda: TL.lmcs_inv(plane, lm, bd))
  assert torch.equal(got, TL.lmcs_inv_plain(plane, lm, bd))


@pytest.mark.gpu
@pytest.mark.parametrize("bins", BINS, ids=_ids)
@pytest.mark.parametrize("bd", (8, 10))
def test_lmcs_inv_kernel_1080p(cuda, bd, bins):
  """A 1088x1920 luma plane (the frame program's call on full1080): the
  kernel's one-wave grid, equal to the plain version."""
  lm = _lmcs(draw_lmcs(bd, bins, seed=bd * 3 + bins[0]), cuda)
  rng = np.random.default_rng(bd + bins[1])
  plane = torch.from_numpy(rng.integers(-64, (1 << bd) + 64, (1088, 1920))
                           .astype(np.int32)).to(cuda)
  got = _launched("lmcs_inv", lambda: TL.lmcs_inv(plane, lm, bd))
  assert torch.equal(got, TL.lmcs_inv_plain(plane, lm, bd))


# lengths around the kernel's chunks (csrc/lmcs.cu: 4 samples a run,
# INV_LOADS = 4 runs a thread, 256 threads a block), and one past a
# whole wave of the card's blocks, whose threads loop
INV_CHUNK = 4 * 4 * 256
LENGTHS = (1, 3, 4, 5, 63, INV_CHUNK - 1, INV_CHUNK, INV_CHUNK + 1,
           INV_CHUNK + 6, 3 * INV_CHUNK + 17, 5_000_003)


@pytest.mark.gpu
@pytest.mark.parametrize("n", LENGTHS)
def test_lmcs_inv_kernel_lengths(cuda, n):
  """Lengths that are not a multiple of a thread's or a block's samples,
  contiguous and 4 bytes off 16-byte alignment (the scalar path)."""
  lm = _lmcs(draw_lmcs(10, BINS[2], seed=11), cuda)
  rng = np.random.default_rng(n)
  big = torch.from_numpy(rng.integers(-64, (1 << 10) + 64, n + 1)
                         .astype(np.int32)).to(cuda)
  for x in (big[:n], big[1:]):
    got = _launched("lmcs_inv", lambda: TL.lmcs_inv(x, lm, 10))
    assert torch.equal(got, TL.lmcs_inv_plain(x, lm, 10))


def _fused_vs_pair(kw, device):
  """The chroma residual call on the card (each scaled TU deriving its
  scale) against the plain pair, lmcs_vpdu_scales_plain then the plain
  chroma residual: equal, the error word 0, the residual kernel
  launched (one launch per work group) and no LMCS kernel."""
  from ffmpeg_tpu_torch.ops import transform as TT

  src = kw["scale_src"]
  luma = src["luma"]
  scales = TL.lmcs_vpdu_scales_plain(luma, src["lm"], luma.shape[1],
                                     luma.shape[0], src["vsz"],
                                     kw["bit_depth"], src["tile_bds"])
  want = torch.stack([TT.residual_plane(
      b, kw["Hp"], kw["Wp"], kw["bit_depth"], kw["sizes"], True, device,
      scales) for b in kw["buckets"]])
  err = TT.error_word(device)
  lmcs, res = dict(TL.LAUNCHES), TT.LAUNCHES["residual"]
  got = TT.residual_planes(**kw, err=err)
  torch.cuda.synchronize()
  assert torch.equal(got, want)
  assert err.item() == 0 and TL.LAUNCHES == lmcs
  assert TT.LAUNCHES["residual"] == res + 3


@pytest.mark.gpu
@pytest.mark.parametrize("vsz", [32, 64])
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("bd", BDS)
def test_lmcs_scales_kernel_matches_plain(cuda, bd, tiles, vsz):
  """The chroma residual kernel's scales, derived per TU from a picture
  read through its padded plane's stride, against the plain pair."""
  H, W = 152, 200
  lm = _lmcs(draw_lmcs(bd, BINS[len(tiles[0]) % 3], seed=bd * 7 + vsz),
             cuda)
  view = torch.from_numpy(padded_plane(bd, H, W, seed=bd + vsz)).to(
      cuda)[:H, :W]
  _fused_vs_pair(_chroma_call(view, lm, vsz, bd, tiles, cuda), cuda)


@pytest.mark.gpu
def test_lmcs_scales_kernel_1080p(cuda):
  """A 1920x1080 picture in its 1920x1088 plane, VPDU 64, with a tile
  boundary at every VPDU edge: the chroma residual kernel's scales of
  all 510 VPDUs against the plain pair."""
  lm = _lmcs(draw_lmcs(8, BINS[0], seed=5), cuda)
  plane = torch.from_numpy(padded_plane(8, 1088, 1920, seed=5)).to(cuda)
  view = plane[:1080, :1920]
  tiles = (tuple(range(64, 1920, 64)), tuple(range(64, 1080, 64)))
  _fused_vs_pair(_chroma_call(view, lm, 64, 8, tiles, cuda), cuda)


@pytest.mark.gpu
def test_lmcs_kernels_refuse(cuda):
  """A strided tensor for the inverse map, a tree without its host table,
  and a chroma residual call whose scales' source is a plane with a
  column stride or a tree without chroma scales raise; nothing is
  launched."""
  from ffmpeg_tpu_torch.ops import transform as TT

  host = draw_lmcs(8, BINS[0], seed=3)
  lm = _lmcs(host, cuda)
  x = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
  before = dict(TL.LAUNCHES)
  with pytest.raises(ValueError):
    TL.lmcs_inv(x[:, :32], lm, 8)
  with pytest.raises(ValueError, match="inv_host"):
    TL.lmcs_inv(x, {k: v for k, v in lm.items() if k != "inv_host"}, 8)
  res = TT.LAUNCHES["residual"]
  with pytest.raises(ValueError):
    TT.residual_planes(**_chroma_call(x.T, lm, 32, 8, ((), ()), cuda),
                       err=TT.error_word(cuda))
  no_crs = _lmcs({k: v for k, v in host.items() if k != "chroma_scale"},
                 cuda)
  with pytest.raises(ValueError):
    TT.residual_planes(**_chroma_call(x, no_crs, 32, 8, ((), ()), cuda),
                       err=TT.error_word(cuda))
  assert TL.LAUNCHES == before and TT.LAUNCHES["residual"] == res
