"""The PyTorch port's parallel layer against the JAX package: the wave
planner, the GOP-wave decode over the device-resident DPB pool
(ffmpeg_tpu_torch/parallel/gop.py) and the band-split filters
(parallel/spatial.py).

On the CPU every mesh device is "cpu" (make_mesh(devices=["cpu"] * n)),
so a wave's frames run in order; the frame devices still split the
pool.  The wave decode must give the JAX package's sequential MD5s
(testdata/inter_cases.md5.json, tools_cases.md5.json, and
parallel_cases.md5.json for the stream of
tests/test_parallel.py::test_gop_mesh_md5_parity).  Regenerate the last
with

  python tests/test_torch_parallel.py

The `slow` twin checks that the JAX package's own decode_gop_mesh gives
its sequential MD5s on the same cases; the `gpu` test of the wave path
on the card is in test_torch_decode.py.
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from test_torch_decode import (INTER_CASES, INTER_JSON, TESTDATA,  # noqa: E402
                               TOOL_CASES, TOOLS_JSON, _read, _stream)

PARALLEL_JSON = os.path.join(TESTDATA, "parallel_cases.md5.json")

# the stream of tests/test_parallel.py::test_gop_mesh_md5_parity
PARITY = dict(width=96, height=64, seed=1401, qp=30, inter=True,
              b_slices=True, ra=True, n_frames=7, deblock=True, sao=True)
# single-IRAP-period, DMVR-free cases: (config, the JSON of their JAX
# sequential MD5s)
GOP_CASES = {
    **{k: (INTER_CASES[k], INTER_JSON) for k in ("ra-pyramid", "tmvp-ra")},
    **{k: (TOOL_CASES[k], TOOLS_JSON)
       for k in ("alf-lmcs-ra", "gpm-tools-ra", "bdof-ra")},
    "gop-mesh-parity": (PARITY, PARALLEL_JSON),
}
# the stream on which the JAX wave path skips DMVR's refinement (POC 1-3
# differ from its sequential decode; ROADMAP Queue C)
DMVR_RA5 = dict(width=64, height=64, seed=7, qp=30, inter=True,
                b_slices=True, ra=True, n_frames=5, dmvr=True, max_mv=90)
# mesh: (devices, streams per frame device)
MESHES = {"1dev-1stream": (1, 1), "1dev-2streams": (1, 2),
          "2dev": (2, None)}

_STREAMS: dict = {}


def _gop_stream(case):
  if case not in _STREAMS:
    _STREAMS[case] = _stream(GOP_CASES[case][0])
  return _STREAMS[case]


def _want(case):
  kw, path = GOP_CASES[case]
  with open(path) as f:
    entry = json.load(f)[case]
  assert entry["config"] == json.loads(json.dumps(kw))
  return entry["md5"]


def _cpu_mesh(n, frame_axis=None):
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  return make_mesh(devices=["cpu"] * n, frame_axis=frame_axis)


def _frames(data):
  """The port parser's frames of a stream, in decode order."""
  from ffmpeg_tpu_torch.parallel.gop import _parse_period

  return _parse_period(data, torch.device("cpu"))


# ---- mesh and planner -----------------------------------------------------

def test_make_mesh():
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  m = _cpu_mesh(8, frame_axis=2)
  assert m.shape == {"frame": 2, "tile": 4}
  assert m.devices.shape == (2, 4)
  assert m.axis_devices("tile") == [torch.device("cpu")] * 4
  assert _cpu_mesh(8).shape == {"frame": 2, "tile": 4}
  assert _cpu_mesh(3).shape == {"frame": 1, "tile": 3}
  assert _cpu_mesh(8, frame_axis=8).shape == {"frame": 8, "tile": 1}
  with pytest.raises(ValueError, match="frame rows"):
    _cpu_mesh(6, frame_axis=4)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA"):
      make_mesh()


@pytest.mark.parametrize("case", list(GOP_CASES))
def test_plan_waves_matches_jax(case):
  from ffmpeg_tpu.parallel import gop as J
  from ffmpeg_tpu_torch.parallel import gop as T

  frames = _frames(_gop_stream(case))
  waves = T.plan_waves(frames)
  assert waves == J.plan_waves(frames)
  assert T._allocate_slots(frames, waves) == J._allocate_slots(frames,
                                                                waves)
  assert sorted(i for w in waves for i in w) == list(range(len(frames)))


def _synthetic(refs):
  """Frames in decode order as (poc, [L0 pocs], [L1 pocs])."""
  return [SimpleNamespace(poc=p, ref_pocs=(l0, l1)) for p, l0, l1 in refs]


def test_planner_refusals_match_jax():
  """A missing reference POC and an exhausted pool raise in both."""
  from ffmpeg_tpu.parallel import gop as J
  from ffmpeg_tpu_torch.parallel import gop as T

  missing = _synthetic([(0, [], []), (2, [1], [])])
  # 18 frames each referencing every earlier one: all stay live
  deep = _synthetic([(p, list(range(p)), []) for p in range(18)])
  for mod in (T, J):
    with pytest.raises(RuntimeError, match="missing reference POC 1"):
      mod.plan_waves(missing)
    with pytest.raises(RuntimeError, match="exhausted"):
      mod._allocate_slots(deep, mod.plan_waves(deep))


# ---- the band-split filters (inputs of tests/test_parallel.py) -----------

def test_sao_tiled_matches_whole_plane_and_jax():
  import jax.numpy as jnp

  from ffmpeg_tpu.ops.sao import sao_plane as jax_sao
  from ffmpeg_tpu_torch.ops.sao import sao_plane
  from ffmpeg_tpu_torch.parallel.spatial import sao_plane_tiled

  rng = np.random.default_rng(0)
  ctb, bd = 32, 8
  pic_w, pic_h = 120, 88
  Hp, Wp = 128, 128
  cbh, cbw = 3, 4
  args = [rng.integers(0, 256, (Hp, Wp), dtype=np.int32),
          rng.integers(0, 3, (cbh, cbw), dtype=np.int32),
          rng.integers(0, 28, (cbh, cbw), dtype=np.int32),
          rng.integers(-12, 13, (cbh, cbw, 5), dtype=np.int32),
          rng.integers(0, 4, (cbh, cbw), dtype=np.int32)]
  plane, st, bp, ov, eo = args
  t = [torch.from_numpy(a) for a in (plane, st, bp, ov, eo)]
  want = np.asarray(jax_sao(*map(jnp.asarray, (plane, st, bp, ov, eo)),
                            pic_w, pic_h, ctb=ctb, bit_depth=bd))
  whole = sao_plane(*t, pic_w, pic_h, ctb=ctb, bit_depth=bd).numpy()
  got = sao_plane_tiled(*t, pic_w, pic_h, ctb=ctb, bit_depth=bd,
                        mesh=_cpu_mesh(8, frame_axis=2)).numpy()
  np.testing.assert_array_equal(whole, want)
  np.testing.assert_array_equal(got, want)


def test_deblock_tiled_matches_whole_plane_and_jax():
  import jax.numpy as jnp

  from ffmpeg_tpu.ops.deblock import deblock_vertical_luma as jax_luma
  from ffmpeg_tpu_torch.ops.deblock import deblock_vertical_luma_plain
  from ffmpeg_tpu_torch.parallel.spatial import deblock_vertical_tiled

  rng = np.random.default_rng(3)
  plane = rng.integers(0, 256, (128, 128), dtype=np.int32)
  S, E = 128 // 4, 128 // 4
  bs = rng.integers(0, 3, (S, E), dtype=np.int32)
  bs[:, 0] = 0
  qp = rng.integers(18, 45, (S, E), dtype=np.int32)
  mp = rng.choice([1, 3, 7], (S, E)).astype(np.int32)
  mq = rng.choice([1, 3, 7], (S, E)).astype(np.int32)
  he = np.zeros((S, E), np.int32)
  arrs = (plane, bs, qp, mp, mq, he)
  kw = dict(bit_depth=8, beta_off=2, tc_off=-2)
  want = np.asarray(jax_luma(*map(jnp.asarray, arrs), **kw))
  t = [torch.from_numpy(a) for a in arrs]
  whole = deblock_vertical_luma_plain(*t, **kw).numpy()
  got = deblock_vertical_tiled(*t, mesh=_cpu_mesh(8, frame_axis=2),
                               **kw).numpy()
  np.testing.assert_array_equal(whole, want)
  np.testing.assert_array_equal(got, want)


def test_deblock_tiled_chroma_matches_whole_plane():
  """The chroma pass in 2-row segments over 4 bands, with a plane whose
  height does not split into whole bands."""
  from ffmpeg_tpu_torch.ops.deblock import deblock_vertical_chroma_plain
  from ffmpeg_tpu_torch.parallel.spatial import deblock_vertical_tiled

  rng = np.random.default_rng(4)
  H, W = 100, 64
  S, E = H // 2, W // 8
  plane = torch.from_numpy(rng.integers(0, 1024, (H, W), dtype=np.int32))
  bs = rng.integers(0, 3, (S, E), dtype=np.int32)
  bs[:, 0] = 0
  grids = [torch.from_numpy(a) for a in (
      bs, rng.integers(18, 50, (S, E), dtype=np.int32),
      rng.choice([1, 3], (S, E)).astype(np.int32),
      rng.choice([1, 3], (S, E)).astype(np.int32))]
  kw = dict(bit_depth=10, beta_off=-2, tc_off=4)
  whole = deblock_vertical_chroma_plain(plane, *grids, **kw)
  got = deblock_vertical_tiled(plane, *grids, None, chroma=True,
                               mesh=_cpu_mesh(4, frame_axis=1), **kw)
  assert torch.equal(got, whole)


def test_alf_tiled_matches_whole_plane_and_jax():
  import jax.numpy as jnp

  from ffmpeg_tpu.ops import alf as J
  from ffmpeg_tpu_torch.ops import alf as T
  from ffmpeg_tpu_torch.parallel.spatial import alf_luma_tiled

  rng = np.random.default_rng(5)
  ctb, bd = 32, 8
  plane = rng.integers(0, 256, (128, 128), dtype=np.int32)
  nby = nbx = 128 // ctb
  bank = rng.integers(0, 16, (nby, nbx), dtype=np.int32)
  flag = rng.integers(0, 2, (nby, nbx), dtype=np.int32)
  bco = rng.integers(-32, 33, (16, 25, 12), dtype=np.int32)
  bcl = rng.choice([256, 32, 8, 2], (16, 25, 12)).astype(np.int32)
  cb = (np.arange(128 // 4) * 4) // ctb
  bank44, flag44 = bank[cb[:, None], cb[None, :]], flag[cb[:, None],
                                                        cb[None, :]]

  def whole(mod, xp, asarr):
    cls, tr = mod.alf_classify(asarr(plane), ctb, bd)
    cls, tr = np.asarray(cls), np.asarray(tr)
    perm = mod.TRANSPOSE_IDX[tr]
    c12 = np.take_along_axis(bco[bank44, cls], perm, axis=-1)
    k12 = np.take_along_axis(bcl[bank44, cls], perm, axis=-1)
    return np.asarray(mod.alf_filter_luma(asarr(plane), asarr(c12),
                                          asarr(k12), ctb,
                                          asarr(flag44 > 0), bd))

  want = whole(J, jnp, jnp.asarray)
  np.testing.assert_array_equal(whole(T, torch, torch.from_numpy), want)
  got = alf_luma_tiled(*(torch.from_numpy(a) for a in (plane, bank, flag,
                                                       bco, bcl)),
                       ctb=ctb, bit_depth=bd,
                       mesh=_cpu_mesh(8, frame_axis=2)).numpy()
  np.testing.assert_array_equal(got, want)


# ---- the GOP-wave decode ---------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(GOP_CASES))
def test_gop_decode_matches_jax(case, mesh):
  """The wave path gives the JAX package's sequential MD5s, at stream
  widths 1 and 2 and with 2 frame devices (which split the pool)."""
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh

  n, streams = MESHES[mesh]
  got = decode_gop_mesh(_gop_stream(case), _cpu_mesh(n, frame_axis=n),
                        streams=streams)
  assert [poc for poc, _, _ in got] == sorted(poc for poc, _, _ in got)
  assert [md5 for _, md5, _ in got] == _want(case)


def test_gop_decode_runs_the_frame_program():
  """Every frame goes through the frame program's kernel calls (the
  call hook), and the packed buffers are the frames' bytes."""
  import hashlib

  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh

  seen = []

  def record(name, label, kw):
    seen.append(name)
    return KERNELS[name][0](**kw)

  got = decode_gop_mesh(_gop_stream("ra-pyramid"), _cpu_mesh(1),
                        call=record)
  assert seen.count("recon") == 2 * len(got)
  assert seen.count("inter_pred") == 2 * (len(got) - 1)
  for _, md5, buf in got:
    assert buf.dtype == np.uint8 and buf.size == 96 * 64 * 3 // 2
    assert hashlib.md5(buf.tobytes()).hexdigest() == md5


def test_measure_scaling_on_cpu():
  from ffmpeg_tpu_torch.parallel.gop import measure_scaling

  out = measure_scaling(_gop_stream("ra-pyramid"), (1, 2), reps=1,
                        mesh=_cpu_mesh(1))
  assert out["md5_equal"] is True
  for w in (1, 2):
    assert out[w]["fps"] > 0 and out[w]["wave_fps"] >= out[w]["fps"]
  assert out[1]["efficiency"] == 1.0


@pytest.mark.parametrize("case", ["dmvr", "dmvr-tools-ra", "dmvr-ra5"])
def test_gop_decode_refuses_dmvr(case):
  """DMVR's refinement needs the reference planes in decode order, and
  the JAX wave path skips it: the port's refuses such a stream."""
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh

  kw = DMVR_RA5 if case == "dmvr-ra5" else TOOL_CASES[case]
  with pytest.raises(RuntimeError, match="DMVR.*VVCDecoder"):
    decode_gop_mesh(_stream(kw), _cpu_mesh(1))


def test_gop_decode_refuses_several_irap_periods():
  """ai720's four frames are IDRs, four IRAP periods: one per call."""
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh

  with pytest.raises(RuntimeError, match="one IRAP period per call"):
    decode_gop_mesh(_read("ai720"), _cpu_mesh(1))


def test_gop_decode_default_mesh_needs_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable")
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh

  with pytest.raises(RuntimeError, match="CUDA"):
    decode_gop_mesh(_gop_stream("ra-pyramid"))


# ---- the JAX side live (slow) ----------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("case", list(GOP_CASES))
def test_gop_case_jax_live(case):
  """The JAX package's own wave path gives its sequential MD5s."""
  from ffmpeg_tpu.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu.parallel.gop import decode_gop_mesh
  from ffmpeg_tpu.parallel.mesh import make_mesh

  data = _gop_stream(case)
  want = [f.md5() for f in VVCDecoder().decode(data)]
  assert want == _want(case)
  assert [m for _, m, _ in decode_gop_mesh(data, make_mesh(
      frame_axis=2))] == want


def main():
  """Regenerate parallel_cases.md5.json with the JAX package's
  sequential decode."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  from ffmpeg_tpu.models.vvc.decoder import VVCDecoder

  out = {"gop-mesh-parity": {
      "config": PARITY,
      "md5": [f.md5() for f in VVCDecoder().decode(_stream(PARITY))]}}
  with open(PARALLEL_JSON, "w") as f:
    json.dump(out, f, indent=1)
    f.write("\n")


if __name__ == "__main__":
  main()
