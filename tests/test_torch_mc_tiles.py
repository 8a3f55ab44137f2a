"""The MC tile format (ffmpeg_tpu_torch/models/vvc/mc_tiles.py) and the
inter kernel's work lists (inputs.mc_size_classes): pack/unpack round
trips, the host's tile offsets and size classes on every P/B frame of
real streams, and the plain placement of the pure inter units from
compact tiles against JAX _recon_plane, bit for bit (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu.models.vvc import pipeline as JP
from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc import mc_tiles
from ffmpeg_tpu_torch.models.vvc.convert import inputs_from_numpy
from ffmpeg_tpu_torch.ops import inter as TIP
from ffmpeg_tpu_torch.ops import recon as TR
from test_torch_inter import _inter_frames, _residuals, _t

torch.set_num_threads(2)

# two inter streams of tests/test_torch_inter.py: affine/PROF, BDOF and
# SbTMVP subblocks; wraparound with TMVP
NAMES = ["bdof-affine", "wrap"]


def _masked(padded, w, h):
  d = torch.arange(padded.shape[-1])
  inside = ((d[:, None] < h[:, None, None]) & (d[None, :] < w[:, None, None]))
  return torch.where(inside.reshape(len(w), *[1] * (padded.dim() - 3),
                                    *inside.shape[1:]), padded, 0)


@pytest.mark.parametrize("chans", [(), (2,)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pack_unpack_round_trip(seed, chans):
  """Random units of w, h in {4, 8, 16, 32}: pack keeps each unit's w x h
  corner at toff, unpack restores it with zeros outside the unit."""
  rng = np.random.default_rng(seed)
  n = 40
  sizes = np.array([4, 8, 16, 32])
  w, h = sizes[rng.integers(0, 4, n)], sizes[rng.integers(0, 4, n)]
  toff = torch.from_numpy(mc_tiles.offsets(w, h))
  w, h = torch.from_numpy(w), torch.from_numpy(h)
  padded = torch.from_numpy(rng.integers(0, 4096, (n, *chans, 32, 32)))
  tiles = mc_tiles.pack(padded, toff, w, h)
  assert tiles.dtype == torch.int16
  assert tiles.shape == (*chans, int((w * h).sum()))
  u = int(rng.integers(0, n))
  unit = tiles[..., int(toff[u]):int(toff[u + 1])]
  assert torch.equal(unit.reshape(*chans, int(h[u]), int(w[u])).int(),
                     padded[u, ..., :h[u], :w[u]].int())
  back = mc_tiles.unpack(tiles, toff, w, h)
  assert back.dtype == torch.int32 and back.shape == padded.shape
  assert torch.equal(back, _masked(padded, w, h).int())
  assert torch.equal(mc_tiles.pack(back, toff, w, h), tiles)
  assert mc_tiles.nbytes(toff, 2) == 4 * int((w * h).sum())


def _batches(name):
  """(poc, tag, host MC batch) of every P/B frame of a stream."""
  return [(fs.poc, tag, t["ctrl"][tag]["inter"])
          for fs, _, t, _, _ in _inter_frames(name) for tag in t["ctrl"]]


@pytest.mark.parametrize("name", NAMES)
def test_toff_is_prefix_sum(name):
  n_units = 0
  for poc, tag, inter in _batches(name):
    wh = inter["w"].astype(np.int64) * inter["h"]
    want = np.concatenate([[0], np.cumsum(wh)])
    np.testing.assert_array_equal(inter["toff"], want, err_msg=f"{poc} {tag}")
    assert inter["toff"].dtype == np.int32
    n_units += len(wh)
  assert n_units > 0


@pytest.mark.parametrize("name", NAMES)
def test_size_classes_partition_batch(name):
  """small and large partition the MC batch; small holds the units of at
  most SMALL_AREA samples (over at least 4x4) without BDOF, in row order;
  every luma BDOF unit is large; large runs the largest first."""
  seen = {"small": 0, "large": 0, "bdof": 0}
  for poc, tag, inter in _batches(name):
    small, large = inter["small"], inter["large"]
    n = len(inter["w"])
    assert sorted(np.concatenate([small, large]).tolist()) == list(range(n))
    area = np.maximum(inter["w"], 4) * np.maximum(inter["h"], 4)
    bdof = (inter["bdof"] > 0) if tag == "y" else np.zeros(n, bool)
    np.testing.assert_array_equal(
        small, np.flatnonzero((area <= TI.SMALL_AREA) & ~bdof))
    assert set(np.flatnonzero(bdof)) <= set(large.tolist())
    assert (np.diff(area[large]) <= 0).all(), f"{poc} {tag}"
    seen["small"] += len(small)
    seen["large"] += len(large)
    seen["bdof"] += int(bdof.sum())
  assert seen["small"] and seen["large"], seen
  if name == "bdof-affine":
    assert seen["bdof"], seen


@pytest.mark.parametrize("name", NAMES)
def test_recon_placement_matches_jax(name):
  """The plain recon's inter pass alone (no intra chunk): the pure inter
  units placed from compact tiles equal JAX _recon_plane with no chunk,
  for luma, Cb and Cr."""
  n_placed = 0
  for fs, _, t, j, refs in _inter_frames(name):
    bd, H, W = fs.bit_depth, fs.height, fs.width
    res = _residuals(fs, j)
    inp = inputs_from_numpy(t, "cpu")
    for c_idx in range(len(refs)):
      ss = int(c_idx > 0)
      tag = "c" if ss else "y"
      jc, tc = j["ctrl"][tag], inp["ctrl"][tag]
      maxs = min(32, (1 << fs.ctb_log2) >> ss)
      wrap = fs.wrap_off >> ss
      jin, jia = (jax.tree_util.tree_map(jnp.asarray, jc[k])
                  for k in ("inter", "intra"))
      want = np.asarray(JP._recon_plane(
          jnp.asarray(res[c_idx]), jin, jc["n_inter"], jia, 0,
          jnp.asarray(np.stack([r[:H >> ss, :W >> ss] for r in refs[c_idx]])),
          maxs_inter=maxs, maxs_intra=maxs, is_chroma=bool(ss), bit_depth=bd,
          cr_weights=c_idx == 2, wrap=wrap))
      tiles = None
      if tc["inter"]["n_mc"]:
        chans = [1, 2] if ss else [0]
        tiles = TIP.inter_pred([[_t(r) for r in refs[c]] for c in chans],
                               tc["inter"], H=H >> ss, W=W >> ss,
                               is_chroma=bool(ss), bit_depth=bd, wrap=wrap)
        tiles = tiles[chans.index(c_idx)]
      got = TR.recon_plane_plain(_t(res[c_idx]), tc["intra"], 0, maxs=maxs,
                                 is_chroma=bool(ss), bit_depth=bd,
                                 inter=tc["inter"], tiles=tiles).numpy()
      np.testing.assert_array_equal(got, want, err_msg=f"{fs.poc} {c_idx}")
      n_placed += tc["inter"]["n_inter"]
  assert n_placed > 0
