"""The ALF kernel's decomposition on the CPU: ops/alf.py alf_tiled_plain
runs csrc/alf.cu's algorithm in torch (the persistent grid's tile order,
the tile shape and its halo, the 16-byte copies of chunks inside the
picture against the clamped 4-byte path, each thread's classification
row and the shuffle sum, the transposed coefficients, the per-row
virtual-boundary offsets, the padding ring) and must equal
alf_planes_plain bit for bit (tolerance 0: integer arithmetic), writing
every sample of the planes exactly once.  The draws are those of
tests/test_torch_alf.py (8, 10 and 12 bits, CTB 32, 64 and 128, pictures
that are not whole tiles or CTBs), a 1080p draw and a 4:0:0 draw, at the
kernel's tile and at the other shapes tools/alf_tiles.py sweeps, and the
frame program's ALF calls of full1080's first frame.
"""
import functools
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_alf import DRAWS, KINDS, _call, _draw, _draw_id, \
    _mono  # noqa: E402
from test_torch_decode import _read  # noqa: E402

from ffmpeg_tpu_torch.ops import alf as TA  # noqa: E402

torch.set_num_threads(2)

# the tile shapes tools/alf_tiles.py sweeps by default (TA.TILE among
# them): (TH, TW) luma samples, TH x TW/2 of each chroma plane
TILES = [(8, 32), (16, 32), (32, 32), (8, 64), (16, 64), (32, 64),
         (8, 128), (4, 128)]
# the persistent grid's width and the copy path: one block for all tiles,
# 3 blocks with the 4-byte copies of a misaligned plane, a block per tile
MODES = {"grid1": dict(grid=1), "grid3-misaligned": dict(grid=3,
                                                          aligned=False),
         "block-per-tile": dict(grid=1 << 20)}


def _check(kw, **opt):
  want = TA.alf_planes_plain(**kw)
  got = TA.alf_tiled_plain(**kw, **opt)
  assert got.dtype == torch.int32 and got.shape == want.shape
  assert torch.equal(got, want), \
      f"{int((got != want).sum())} samples differ"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("draw", DRAWS, ids=_draw_id)
def test_alf_tiled_plain_matches_plain(draw, kind):
  """The kernel's tile (TA.TILE) and a 7-block grid on each seeded draw:
  pictures of 1 to 2 CTBs a side, not whole tiles, with the virtual
  boundary inside, flags off and unknown indices among the CTBs."""
  _check(_call(kind, *_draw(*draw)))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_alf_tiled_plain_tile_shapes(tile, kind, mode):
  """Every swept tile shape, in each grid width and copy path, on one
  draw per shape (the bit depth and CTB size vary with the shape)."""
  k = TILES.index(tile)
  _check(_call(kind, *_draw(*DRAWS[(3 * k + 1) % len(DRAWS)])), tile=tile,
         **MODES[mode])


@pytest.mark.parametrize("kind", KINDS)
def test_alf_tiled_plain_1080p(kind):
  """A 1920x1080 draw at CTB 64 on a grid of 396 blocks (3 per SM of an
  H100): tiles straddling CTU rows and the bottom edge."""
  _check(_call(kind, *_draw(8, 6, size=(1080, 1920))), grid=396)


@pytest.mark.parametrize("kind", KINDS)
def test_alf_tiled_plain_runs_past_the_chroma_width(kind):
  """A 60-wide picture: its chroma width, 30, is not whole runs of 4, so
  the last run of each chroma row writes 2 samples and the copy of the
  chunk across the edge takes the clamped path."""
  _check(_call(kind, *_draw(10, 5, seed=460, size=(72, 60))))


def test_alf_tiled_plain_mono():
  """A 4:0:0 frame's one call: luma alone."""
  _check(_call("luma", *_mono(_draw(10, 6, seed=410))))


@functools.lru_cache(maxsize=1)
def _full1080_frame0_calls():
  """The ALF calls of full1080's first frame, walked on the CPU through
  the frame program (its real tree, its SAO output as the pre-ALF
  planes)."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  calls = {}

  def record(name, label, kw):
    if name == "alf":
      calls[label] = kw
    return KERNELS[name][0](**kw)

  aus = VVCDecoder(device="cpu")._split_aus(_read("full1080"))[:1]
  for _ in walk_frames(aus, "cpu", record):
    pass
  return calls


@pytest.mark.parametrize("kind", KINDS)
def test_alf_tiled_plain_full1080_frame(kind):
  """full1080's frame-program ALF calls of frame 0 (1920x1080, CTB 32),
  at the kernel's tile on a 396-block grid."""
  kw = _full1080_frame0_calls()[kind]
  assert kw["chroma"] == (kind == "chroma")
  _check(kw, grid=396)


def test_alf_tiled_plain_refuses_what_alf_planes_refuses():
  """The emulation takes alf_planes's arguments and checks them alike."""
  planes, tree, geo = _draw(8, 5)
  kw = _call("luma", planes, tree, geo)
  kw["W"] -= 2
  with pytest.raises(ValueError):
    TA.alf_tiled_plain(**kw)
