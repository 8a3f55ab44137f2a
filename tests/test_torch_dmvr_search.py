"""The DMVR search's entry point, ops/dmvr.py refine_subblocks (its plain
version on the CPU), against the JAX package's `_refine_jit`
(ffmpeg_tpu/ops/dmvr.py: `_unit` and `_bilin` vmapped over the
subblocks), bit for bit (tolerance 0: integer arithmetic), on seeded
calls (tests/torch_dmvr_draws.py): the four bilinear branches at 8, 10
and 12 bits (the 12-bit whole-MV window pinned at JAX's 0), windows
across every picture edge over garbage padding, each subblock shape,
searches that stop at the centre, best offsets on the border, SAD ties,
the flat parabola and both neighbour-equals-minimum cases of the
parametric step, and 30 reference slots.  Also: the wrapper runs and
counts its plain version on the CPU; each host check raises; the frame
program's call hook and trace spans see each DMVR frame's search.  On
the card, the kernel (csrc/dmvr.cu) against the plain version on the
same draws, and the session's launches.

JAX is imported inside the tests that need it, so that the card, which
has no JAX, collects the `gpu` tests:

  python -m pytest --noconftest -m gpu tests/test_torch_dmvr_search.py
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ffmpeg_tpu_torch.ops import dmvr as TD  # noqa: E402
from torch_dmvr_draws import SHAPES, classify, draw  # noqa: E402

torch.set_num_threads(2)

# (kind, bit depth, seed) of every drawn call
CALLS = ([("branches", bd, s) for bd in (8, 10, 12) for s in (0, 1)]
         + [("edges", bd, 0) for bd in (8, 10, 12)]
         + [("cases", 10, s) for s in (4, 5, 6)]
         + [("parabolas", 10, 0), ("slots30", 10, 0), ("slots30", 12, 3)]
         + [("flat", 10, 0), ("flat", 8, 1)])


def _id(call):
  return "-".join(map(str, call))


def _tensors(c, device="cpu"):
  planes = [torch.from_numpy(np.ascontiguousarray(p)).to(device)
            for p in c["planes"]]
  return planes, torch.from_numpy(c["ctrl"]).to(device)


def _plain(c, device="cpu"):
  planes, ctrl = _tensors(c, device)
  return TD.refine_subblocks_plain(planes, ctrl, H=c["H"], W=c["W"],
                                   bit_depth=c["bit_depth"])


def _jax(c):
  import jax.numpy as jnp

  from ffmpeg_tpu.ops import dmvr as JD

  out = JD._refine_jit(tuple(jnp.asarray(p) for p in c["planes"]),
                       jnp.asarray(c["ctrl"]), c["bit_depth"], c["H"],
                       c["W"])
  return np.stack([np.asarray(a) for a in out])


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("mxy", [(0, 0), (9, 0), (0, 7), (3, 13)],
                         ids=["whole", "horizontal", "vertical", "diagonal"])
def test_bilin_branch_matches_jax(bd, mxy):
  """Each bilinear branch of one window; at 12 bits a whole MV's window
  shifts by -2, which JAX (and torch) take as 0."""
  import jax.numpy as jnp

  from ffmpeg_tpu.ops import dmvr as JD

  rng = np.random.default_rng(bd * 16 + mxy[0])
  win = rng.integers(0, 1 << bd, (TD._WIN, TD._WIN)).astype(np.int32)
  mx, my = mxy
  got = TD._bilin(torch.from_numpy(win)[None],
                  torch.tensor([mx], dtype=torch.int32),
                  torch.tensor([my], dtype=torch.int32), bd)[0].numpy()
  want = np.asarray(JD._bilin(jnp.asarray(win), mx, my, bd))
  np.testing.assert_array_equal(got, want)
  if bd == 12 and mxy == (0, 0):
    assert not want.any()
  else:
    assert want.any()


@pytest.mark.parametrize("call", CALLS, ids=_id)
def test_search_matches_jax(call):
  """The wrapper on the CPU (its plain version, counted once) against
  JAX `_refine_jit` on the same planes and rows."""
  c = draw(*call)
  planes, ctrl = _tensors(c)
  runs, launches = TD.PLAIN_RUNS["dmvr"], TD.LAUNCHES["dmvr"]
  got = TD.refine_subblocks(planes, ctrl, H=c["H"], W=c["W"],
                            bit_depth=c["bit_depth"])
  assert TD.PLAIN_RUNS["dmvr"] == runs + 1
  assert TD.LAUNCHES["dmvr"] == launches
  assert got.dtype == torch.int32 and got.shape == (3, ctrl.shape[1])
  np.testing.assert_array_equal(got.numpy(), _jax(c))
  if call[0] == "branches" and call[1] == 12:
    # whole MVs on both lists: both predictions 0, no search, BDOF off
    whole = ~np.any(c["ctrl"][4:8] & 15, axis=0)
    assert whole.any()
    assert (got.numpy()[:, whole] == np.array([[0], [0], [1]])).all()


def _window_origins(c):
  """Each list's window origin (x, y) per subblock: (2, 2, n)."""
  r = dict(zip(TD.CTRL_KEYS, c["ctrl"].astype(np.int64)))
  return np.stack([np.stack([r["x"] + (r[f"mx{lx}"] >> 4) - 2,
                             r["y"] + (r[f"my{lx}"] >> 4) - 2])
                   for lx in (0, 1)])


@pytest.mark.parametrize("call", CALLS, ids=_id)
def test_draw_covers_its_cases(call):
  """What each draw is for is in it: every subblock shape; the four
  bilinear branches on both lists (branches); windows across each edge
  and wholly outside (edges); centre stops, border offsets, ties and
  interior steps (cases, over the three seeds); the three parametric
  special cases (parabolas); slots up to 29 (slots30); all 25 SADs tied,
  the search stopping at the centre or the biased centre winning
  (flat)."""
  kind, bd, seed = call
  c = draw(kind, bd, seed)
  r = dict(zip(TD.CTRL_KEYS, c["ctrl"]))
  TD.check_rows(c["ctrl"], c["n_l0"], len(c["planes"]))
  shapes = set(zip(r["w"].tolist(), r["h"].tolist()))
  assert shapes == set(SHAPES) or kind == "parabolas"
  if kind == "branches":
    for lx in (0, 1):
      fx, fy = r[f"mx{lx}"] & 15, r[f"my{lx}"] & 15
      kinds = set(zip((fx > 0).tolist(), (fy > 0).tolist()))
      assert kinds == {(False, False), (True, False), (False, True),
                       (True, True)}
  elif kind == "edges":
    o = _window_origins(c)
    W, H, win = c["W"], c["H"], TD._WIN
    for a, lim in ((0, W), (1, H)):
      assert (o[:, a] < 0).any() and (o[:, a] + win > lim).any()
      assert (o[:, a] + win <= 0).any() and (o[:, a] >= lim).any()
    assert (np.asarray(c["planes"][0])[H:, :] >= 1 << bd).all()
  elif kind == "cases":
    got = classify(c)
    assert got["no_search"] and got["border"] and got["ties"] \
        and got["interior"]
    if seed in (4, 6):
      assert got["plus_eq"]
  elif kind == "parabolas":
    got = classify(c)
    assert got["denom0"] == got["minus_eq"] == got["plus_eq"] == 1
  elif kind == "slots30":
    assert len(c["planes"]) == 30 and c["n_l0"] == 15
    assert r["s0"].max() == 14 and r["s1"].min() == 15 \
        and r["s1"].max() == 29
  elif kind == "flat" and bd == 10:
    got = classify(c)
    assert got["all_tie"] == got["no_search"] + got["interior"] > 0
    assert got["no_search"] and got["all_tie_search"] == got["interior"]


def test_parabola_steps():
  """The three designed centres: a flat parabola gives no sub-pel step,
  a left neighbour equal to the biased centre -8, a right one +8."""
  got = TD.refine_subblocks(*_tensors(draw("parabolas", 10, 0)), H=24,
                            W=96, bit_depth=10).numpy()
  np.testing.assert_array_equal(got[:2], [[0, -8, 8], [0, 0, 0]])


def _bad_planes(kind):
  p = [torch.zeros((24, 40), dtype=torch.int32) for _ in range(2)]
  if kind == "too-many":
    p = p * 17
  elif kind == "shapes":
    p[1] = torch.zeros((24, 48), dtype=torch.int32)
  elif kind == "strided":
    p[1] = torch.zeros((24, 80), dtype=torch.int32)[:, ::2]
  elif kind == "int64":
    p[0] = p[0].long()
  elif kind == "none":
    p = []
  return p


@pytest.mark.parametrize("kind", ["too-many", "shapes", "strided", "int64",
                                  "none", "picture"])
def test_plane_checks_raise(kind):
  """More than MAX_SLOTS planes, planes of two shapes, a strided plane,
  int64, no plane, a picture larger than the planes: ValueError, before
  anything runs."""
  planes = _bad_planes(kind) if kind != "picture" else _bad_planes("")
  ctrl = torch.from_numpy(draw("branches", 8, 0)["ctrl"][:, :4])
  runs = TD.PLAIN_RUNS["dmvr"]
  with pytest.raises(ValueError, match="refine_subblocks"):
    TD.refine_subblocks(planes, ctrl, H=32 if kind == "picture" else 24,
                        W=40, bit_depth=8)
  assert TD.PLAIN_RUNS["dmvr"] == runs


ROW_FAULTS = {"s0-negative": (8, -1), "s0-in-l1": (8, 2), "s1-in-l0": (9, 1),
              "s1-past-slots": (9, 4), "w-32": (2, 32), "h-4": (3, 4),
              "8x8": (2, 8)}


@pytest.mark.parametrize("fault", sorted(ROW_FAULTS))
def test_row_checks_raise(fault):
  """Slots outside 0 <= s0 < n_l0 <= s1 < slots and subblocks other than
  16x16, 8x16 and 16x8 raise ValueError (n_l0 2, 4 slots)."""
  ctrl = np.tile(np.array([[0], [0], [16], [8], [0], [0], [0], [0], [1],
                           [3]], np.int32), (1, 3))
  TD.check_rows(ctrl, 2, 4)
  k, v = ROW_FAULTS[fault]
  ctrl[k, 1] = v
  if fault == "8x8":
    ctrl[3, 1] = 8
  with pytest.raises(ValueError, match="refine_subblocks"):
    TD.check_rows(ctrl, 2, 4)


def test_slot_cap_checked():
  """The slot cap: 31 slots pass, MAX_SLOTS + 1 raise."""
  ctrl = np.array([[0], [0], [16], [16], [0], [0], [0], [0], [0], [16]],
                  np.int32)
  TD.check_rows(ctrl, 16, TD.MAX_SLOTS)
  with pytest.raises(ValueError, match="at most"):
    TD.check_rows(ctrl, 16, TD.MAX_SLOTS + 1)


def test_refine_frame_checks_rows_before_the_search():
  """A unit naming an L0 entry past its list raises in refine_frame,
  before the rows go to the device and before any search runs."""
  cus = {k: np.array([v], np.int32) for k, v in dict(
      dmvr=1, x0=8, y0=8, w=16, h=16, mv_x=0, mv_y=0, mv1_x=0, mv1_y=0,
      ref_idx=2, ref_idx1=0).items()}
  fs = types.SimpleNamespace(cus=cus, width=64, height=48, bit_depth=8,
                             ref_pocs=((0, 1), (0,)))
  dpb = {p: [torch.zeros((48, 64), dtype=torch.int32)] for p in (0, 1)}
  runs = TD.PLAIN_RUNS["dmvr"]
  with pytest.raises(ValueError, match="reference slots"):
    TD.refine_frame(fs, dpb, "cpu")
  assert TD.PLAIN_RUNS["dmvr"] == runs
  cus["ref_idx"][0] = 1
  assert TD.refine_frame(fs, dpb, "cpu")[4].sum() == 16
  assert TD.PLAIN_RUNS["dmvr"] == runs + 1


def test_walk_sends_each_search_through_the_hook():
  """The frame program's walk (pipeline.walk_frames) on the CPU over the
  `dmvr` case: each DMVR frame's search reaches the call hook once, as
  kernel "dmvr" on "luma", before the frame's other calls; its result
  equals the search without the hook; the traced dmvr, dmvr_search and
  dmvr_apply spans each count one per DMVR frame."""
  from test_torch_decode import TOOL_CASES, _stream

  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames
  from ffmpeg_tpu_torch.utils import trace

  seen, frames = [], []

  def record(name, label, kw):
    seen.append((name, label))
    out = KERNELS[name][0](**kw)
    if name == "dmvr":
      assert set(kw) == {"planes", "ctrl", "H", "W", "bit_depth"}
      assert torch.equal(out, TD.refine_subblocks_plain(**kw))
    return out

  aus = VVCDecoder(device="cpu")._split_aus(_stream(TOOL_CASES["dmvr"]))
  trace.reset()
  trace.enable(True)
  try:
    for fs, _ in walk_frames(aus, "cpu", record):
      frames.append(list(seen))
      seen.clear()
  finally:
    trace.enable(False)
  spans = trace.summary()
  n = sum(("dmvr", "luma") in f for f in frames)
  assert n >= 2
  for f in frames:
    assert f.count(("dmvr", "luma")) == (f[0] == ("dmvr", "luma"))
  for span in ("dmvr", "dmvr_search", "dmvr_apply"):
    assert spans[span]["n"] == n


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_dmvr_search.py)")
  return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("call", CALLS, ids=_id)
def test_search_kernel_matches_plain(cuda, call):
  """The kernel, launched once, against the plain version on the same
  card tensors and on their CPU copies."""
  c = draw(*call)
  planes, ctrl = _tensors(c, cuda)
  launches, runs = TD.LAUNCHES["dmvr"], TD.PLAIN_RUNS["dmvr"]
  got = TD.refine_subblocks(planes, ctrl, H=c["H"], W=c["W"],
                            bit_depth=c["bit_depth"])
  torch.cuda.synchronize()
  assert TD.LAUNCHES["dmvr"] == launches + 1
  assert TD.PLAIN_RUNS["dmvr"] == runs
  assert torch.equal(got, _plain(c, cuda))
  assert torch.equal(got.cpu(), _plain(c))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 193, 4099])
def test_search_kernel_subblock_counts(cuda, n):
  """One subblock, counts that are no multiple of a warp or of a block's
  warps, and a few thousand (beyond one wave of blocks): one launch,
  equal to the plain version."""
  c = draw("branches", 10, n, n=n)
  planes, ctrl = _tensors(c, cuda)
  launches = TD.LAUNCHES["dmvr"]
  got = TD.refine_subblocks(planes, ctrl, H=c["H"], W=c["W"], bit_depth=10)
  torch.cuda.synchronize()
  assert TD.LAUNCHES["dmvr"] == launches + 1 and got.shape == (3, n)
  assert torch.equal(got, _plain(c, cuda))


@pytest.mark.gpu
def test_search_kernel_1080p_planes(cuda):
  """3,072 subblocks over 1920x1080 pictures in 1920x1088 planes, two
  slots a list, at 8 bits."""
  rng = np.random.default_rng(1080)
  planes = [torch.from_numpy(rng.integers(0, 256, (1088, 1920)).astype(
      np.int32)).to(cuda) for _ in range(4)]
  n = 3072
  shape = np.array(SHAPES)[rng.integers(0, 3, n)]
  ctrl = np.stack([rng.integers(0, 1904 // 8, n) * 8,
                   rng.integers(0, 1064 // 8, n) * 8, shape[:, 0],
                   shape[:, 1], *rng.integers(-512, 512, (4, n)),
                   rng.integers(0, 2, n), rng.integers(2, 4, n)])
  ctrl = torch.from_numpy(ctrl.astype(np.int32)).to(cuda)
  got = TD.refine_subblocks(planes, ctrl, H=1080, W=1920, bit_depth=8)
  assert torch.equal(got, TD.refine_subblocks_plain(
      planes, ctrl, H=1080, W=1920, bit_depth=8))


@pytest.mark.gpu
def test_search_kernel_refuses(cuda):
  """Planes the kernel does not take, and rows that are not contiguous
  int32 (10, n) on the planes' card, raise; nothing is launched.  No
  subblocks: an empty result, no launch."""
  c = draw("branches", 8, 0)
  planes, ctrl = _tensors(c, cuda)
  launches = TD.LAUNCHES["dmvr"]
  kw = dict(H=c["H"], W=c["W"], bit_depth=8)
  for bad in (planes * 9, [planes[0], planes[1][:, 1:]],
              [p.long() for p in planes]):
    with pytest.raises(ValueError):
      TD.refine_subblocks(bad, ctrl, **kw)
  for bad in (ctrl.long(), ctrl[:9], ctrl.t().contiguous().t(), ctrl.cpu()):
    with pytest.raises(ValueError):
      TD.refine_subblocks(planes, bad, **kw)
  empty = TD.refine_subblocks(planes, ctrl[:, :0].contiguous(), **kw)
  assert empty.shape == (3, 0) and empty.device.type == "cuda"
  assert TD.LAUNCHES["dmvr"] == launches


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["full1080", "dmvr-bdof-tmvp"])
def test_session_launches_search_per_dmvr_frame(cuda, name):
  """The session (VVCDecoder on the card) launches the search kernel once
  per DMVR frame and never runs the plain version; its frames keep
  their committed MD5s."""
  import json

  from test_torch_decode import (TOOL_CASES, TOOLS_JSON, _fixture_md5s,
                                 _read, _stream)

  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.utils import trace

  if name == "full1080":
    data, want = _read(name), _fixture_md5s(name)
  else:
    data = _stream(TOOL_CASES[name])
    with open(TOOLS_JSON) as f:
      want = json.load(f)[name]["md5"]
  TD.LAUNCHES["dmvr"] = TD.PLAIN_RUNS["dmvr"] = 0
  trace.reset()
  trace.enable(True)
  try:
    got = [fr.md5() for fr in VVCDecoder(device=cuda).decode(data)]
  finally:
    trace.enable(False)
  n = trace.summary()["dmvr"]["n"]
  assert got == want
  assert n >= 2 and TD.LAUNCHES["dmvr"] == n and TD.PLAIN_RUNS["dmvr"] == 0
