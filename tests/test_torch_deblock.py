"""Deblocking: the port's plain deblock against the JAX package's over
the kernel's parameter space (one pass, and both in loopfilters' order),
the kernel's tiling emulated on the CPU against the whole-plane passes,
the deblock conformance cases decoded to the JAX MD5s, and (on the card)
the CUDA kernel csrc/deblock.cu, both passes and each alone, against the
plain version.

The JAX MD5s of the cases live in
ffmpeg_tpu_torch/testdata/deblock_cases.md5.json; regenerate them with

  python tests/test_torch_deblock.py

JAX is imported inside the tests that need it, so that the card, which
has no JAX, collects the `gpu` tests:

  python -m pytest --noconftest -m gpu tests/test_torch_deblock.py
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_decode import TESTDATA, _port_md5s, _stream  # noqa: E402

from ffmpeg_tpu_torch.ops.deblock import TILE  # noqa: E402

DEBLOCK_JSON = os.path.join(TESTDATA, "deblock_cases.md5.json")

# the cases of tests/test_conformance.py that run deblock and had no port
# test (same ids and configs): slice-header and picture-header offsets, a
# QP per CU, transform skip with BDPCM, tile and slice edges
DEBLOCK_CASES = {
    "deblock": dict(width=128, height=96, seed=104, qp=30, deblock=True),
    "deblock-sh-override": dict(width=96, height=64, seed=3806, qp=30,
                                inter=True, n_frames=5,
                                deblock_override=True, deblock=True,
                                sao=True, max_mv=48),
    "deblock-ph": dict(width=96, height=64, seed=3807, qp=30, inter=True,
                       n_frames=5, deblock_in_ph=True, deblock=True,
                       sao=True, max_mv=48),
    "qp-delta-inter": dict(width=96, height=64, seed=603, qp=28,
                           cu_qp_delta=True, inter=True, b_slices=True,
                           deblock=True, n_frames=3),
    "bdpcm-ts-inter": dict(width=96, height=64, seed=902, qp=28, bdpcm=True,
                           transform_skip=True, deblock=True, inter=True,
                           b_slices=True, n_frames=3),
    "rect-slices-3": dict(width=192, height=96, seed=4002, qp=30,
                          tile_cols=(2, 2, 2), tile_rows=(2, 1),
                          rect_slices=((0, 0, 3, 1), (0, 1, 2, 1),
                                       (2, 1, 1, 1)),
                          deblock=True, sao=True),
}


# ---- the plain deblock against JAX over the kernel's parameter space --

LUMA_MAX = (1, 2, 3, 4, 5, 6, 7)      # maxp / maxq drawn for luma
CHROMA_MAX = (0, 1, 3)                # and for chroma
# (kind, bit depth, horizontal, draw); the offsets of each case are
# nonzero, and Cr's differ from Cb's
CASES = [(kind, bd, h, "draw") for kind in ("luma", "chroma")
         for bd in (8, 10, 12) for h in (False, True)]
CASES += [(kind, 8, h, "border") for kind in ("luma", "chroma")
          for h in (False, True)]
OFFSETS = {8: ((4, -2), (-2, 4)), 10: ((-6, 4), (2, 6)),
           12: ((2, 6), (-4, -2))}


def _case_id(case):
  kind, bd, h, draw = case
  return f"{kind}-{bd}bit-{'h' if h else 'v'}-{draw}"


def _draw(kind, bd, h, draw, size=(64, 128)):
  """numpy planes, their grids for the pass's view (of `size` for luma,
  half of it for chroma) and the offsets: kind "luma" one plane,
  "chroma" Cb and Cr.  A "draw" has piecewise flat 8x8 blocks with steps
  between them and noise of a random strength per 16x16 region (so that
  the large, strong and weak filters all run), every (maxp, maxq) pair,
  bs 0-2, QP 20-63 and, for
  luma, the CTU-edge flag on a quarter of the segments.  A "large" draw
  has small steps, little noise, QP 50-63 and max lengths 5 and 7
  (chroma 3), so that the long filters run on most edges.  A "border"
  case has active edges whose windows cross the plane's border: luma
  edges 0, 1 and the last with maxp = maxq = 7 on flat sides around a
  step (the large filter writes clamped columns several times); chroma
  edge 0 with a ramp on its q side (the strong filter)."""
  rng = np.random.default_rng([bd, int(h), kind == "chroma",
                               draw == "border"])
  chroma = kind == "chroma"
  nch = 2 if chroma else 1
  seg, grid = (2, 8) if chroma else (4, 4)
  maxv = (1 << bd) - 1
  sc = 1 << (bd - 8)
  if draw == "border":
    H, W = (4, 16) if chroma else (8, 32)
    x = np.arange(W)[None, :].repeat(H, 0)
    if chroma:
      pl = np.where(x < 4, 100 + 3 * x, 100) * sc
    else:
      pl = (100 + np.where(x >= W - 4, 12, 0) - np.where(x < 4, 12, 0)) * sc
    planes = [pl.astype(np.int32)] * nch
  else:
    H, W = (size[0] // 2, size[1] // 2) if chroma else size
    planes = []
    large = draw == "large"
    for _ in range(nch):
      blocks = rng.integers(*((120, 128) if large else (80, 176)),
                            (H // 8 + 1, W // 8 + 1)) * sc
      base = np.kron(blocks, np.ones((8, 8), np.int64))[:H, :W]
      amp = rng.choice([0, 0, 1] if large else [0, 0, 1, 2, 6, 20],
                       (H // 16 + 1, W // 16 + 1))
      amp = np.kron(amp, np.ones((16, 16), np.int64))[:H, :W] * sc
      noise = np.rint(rng.standard_normal((H, W)) * amp).astype(np.int64)
      planes.append(np.clip(base + noise, 0, maxv).astype(np.int32))
  # the planes above and the grids below are laid out for the pass's
  # view: the plane itself, or (horizontal) its transpose
  S, E = H // seg, W // grid
  grids = []
  for _ in range(nch):
    if draw == "border":
      bs = np.zeros((S, E), np.int32)
      bs[:, [0, 1, E - 1] if not chroma else [0]] = 2
      qp = np.full((S, E), 45 if not chroma else 63, np.int32)
      mp = np.full((S, E), 7 if not chroma else 3, np.int32)
      g = [bs, qp, mp, mp.copy()]
    else:
      bs = rng.choice([0, 1, 2], (S, E), p=[0.2, 0.3, 0.5]).astype(np.int32)
      bs[:, 0] = 0
      vals = CHROMA_MAX if chroma else LUMA_MAX
      if large:
        vals = (3,) if chroma else (5, 7)
      g = [bs, rng.integers(50 if large else 20, 64, (S, E), dtype=np.int32),
           rng.choice(vals, (S, E)).astype(np.int32),
           rng.choice(vals, (S, E)).astype(np.int32)]
    if not chroma:
      g.append((rng.random((S, E)) < (0.05 if large else 0.25)).astype(
          np.int32) if draw != "border" else np.zeros((S, E), np.int32))
    grids.append(tuple(g))
  if h:
    planes = [np.ascontiguousarray(p.T) for p in planes]
  offs = OFFSETS[bd][:nch]
  return planes, grids, tuple(o[0] for o in offs), tuple(o[1] for o in offs)


def _pass_kw(kind, bd, h, beta_off, tc_off):
  return dict(chroma=kind == "chroma", horizontal=h, bit_depth=bd,
              beta_off=beta_off, tc_off=tc_off)


def _filters_run(kind, deltas):
  """The filters a pass ran, from its windows' changes (ops/deblock.py
  _scatter_delta's delta, (H, E, window)): a luma sample 4-7 from its
  edge only the large filter writes, p2/q2 the strong (or a 3-sample
  large side), p0/p1/q0/q1 alone the weak one; a chroma p1/p2 the strong
  filter, q1/q2 without them the one-sided one, p0/q0 alone the weak."""
  nz = deltas != 0
  kinds = set()
  if kind == "luma":
    far = nz[..., :5].any(-1) | nz[..., 11:].any(-1)
    two = nz[..., 5] | nz[..., 10]
    near = nz[..., 6:10].any(-1)
    for name, m in (("large", far), ("strong", two & ~far),
                    ("weak", near & ~two & ~far)):
      if m.any():
        kinds.add(name)
  else:
    p12 = nz[..., 1:3].any(-1)
    q12 = nz[..., 5:7].any(-1)
    near = nz[..., 3:5].any(-1)
    for name, m in (("strong", p12), ("one-sided", q12 & ~p12),
                    ("weak", near & ~p12 & ~q12)):
      if m.any():
        kinds.add(name)
  return kinds


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_deblock_matches_jax(case, monkeypatch):
  """deblock_pass on the CPU (the plain version, on the plane or its
  transposed view) equals the JAX deblock_vertical_luma/_chroma on the
  plane or its transpose, torch.equal, at bit depths 8, 10 and 12 with
  nonzero offsets, the CTU-edge flag, every (maxp, maxq) pair and the
  large, strong and weak filters; and where a window crosses the
  plane's border, where both add every window's change to the clamped
  column."""
  import jax.numpy as jnp

  from ffmpeg_tpu.ops import deblock as JD
  from ffmpeg_tpu_torch.ops import deblock as TD

  kind, bd, h, draw = case
  planes, grids, beta_off, tc_off = _draw(*case)
  deltas, cols = [], []
  scatter = TD._scatter_delta

  def spy(plane, rows, xs, delta):
    deltas.append(delta.numpy())
    cols.append(np.broadcast_to(xs.numpy(), delta.shape))
    return scatter(plane, rows, xs, delta)

  monkeypatch.setattr(TD, "_scatter_delta", spy)
  got = TD.deblock_pass([torch.from_numpy(p) for p in planes],
                        [tuple(map(torch.from_numpy, g)) for g in grids],
                        **_pass_kw(kind, bd, h, beta_off, tc_off))
  jf = JD.deblock_vertical_chroma if kind == "chroma" \
      else JD.deblock_vertical_luma
  for c, (p, g) in enumerate(zip(planes, grids)):
    src = np.ascontiguousarray(p.T) if h else p
    want = np.asarray(jf(jnp.asarray(src), *map(jnp.asarray, g),
                         bit_depth=bd, beta_off=beta_off[c],
                         tc_off=tc_off[c]))
    want = torch.from_numpy(np.array(want.T if h else want))
    assert torch.equal(got[c], want), f"plane {c}"
    assert not torch.equal(got[c], torch.from_numpy(p))
  if draw == "draw":
    vals = CHROMA_MAX if kind == "chroma" else LUMA_MAX
    pairs = {(int(a), int(b)) for g in grids
             for a, b in zip(g[2][g[0] > 0], g[3][g[0] > 0])}
    assert pairs == {(a, b) for a in vals for b in vals}
    want_kinds = {"large", "strong", "weak"} if kind == "luma" \
        else {"strong", "one-sided", "weak"}
    assert set().union(*(_filters_run(kind, d) for d in deltas)) == \
        want_kinds
  else:  # the border column took the changes of several window positions
    x, d = cols[0], deltas[0]
    at_border = ((x == 0) | (x == x.max())) & (d != 0)
    assert at_border.sum(-1).max() >= (1 if kind == "chroma" else 3)


# ---- both passes: loopfilters' order, and the kernel's tiles -----------

def _draw_pair(kind, bd, draw, size):
  """planes of `size` (H, W), the grids of both passes (the vertical
  pass's for the plane, the horizontal pass's for its transpose) and the
  offsets, as torch tensors: _draw's "draw" and "large" draws, or a
  "border" case whose active edges' windows cross the plane's border in
  both directions (luma edges 0, 1 and the last with maxp = maxq = 7 on
  flat sides around steps; chroma edge 0 with ramps on its q side)."""
  chroma = kind == "chroma"
  nch = 2 if chroma else 1
  seg, grid = (2, 8) if chroma else (4, 4)
  H, W = size
  if draw == "border":
    sc = 1 << (bd - 8)
    y, x = np.mgrid[:H, :W]
    if chroma:
      pl = 100 + np.where(x < 4, 3 * x, 0) + np.where(y < 4, 3 * y, 0)
    else:
      pl = (100 + 12 * ((x >= W - 4) | (y >= H - 4))
            - 12 * ((x < 4) | (y < 4)))
    planes = [(pl * sc).astype(np.int32)] * nch

    def grids(rows, cols):
      S, E = rows // seg, cols // grid
      bs = np.zeros((S, E), np.int32)
      bs[:, [0] if chroma else [0, 1, E - 1]] = 2
      qp = np.full((S, E), 63 if chroma else 45, np.int32)
      mp = np.full((S, E), 3 if chroma else 7, np.int32)
      g = (bs, qp, mp, mp.copy()) + (() if chroma else (0 * bs,))
      return [g] * nch

    gv, gh = grids(H, W), grids(W, H)
    offs = OFFSETS[bd][:nch]
    bo, to = tuple(o[0] for o in offs), tuple(o[1] for o in offs)
  else:
    scale = 2 if chroma else 1  # _draw's sizes are luma sizes
    planes, gv, bo, to = _draw(kind, bd, False, draw,
                               size=(H * scale, W * scale))
    gh = _draw(kind, bd, True, draw, size=(W * scale, H * scale))[1]
  return ([torch.from_numpy(p) for p in planes],
          [tuple(map(torch.from_numpy, g)) for g in gv],
          [tuple(map(torch.from_numpy, g)) for g in gh], bo, to)


# (kind, bit depth, draw, plane size): sides that are not multiples of
# the kernel's TILE, planes smaller than one tile, and the border case
# over 2 x 2 tiles
PAIR_SIZES = {"luma": (2 * TILE + 4, TILE + 20),
              "chroma": (TILE + 24, TILE + 8)}
SMALL_SIZES = {"luma": (20, 28), "chroma": (16, 24)}
BORDER_SIZES = {"luma": (TILE + 4, TILE + 8), "chroma": (TILE + 8, TILE + 16)}
PAIR_CASES = [(kind, bd, draw, PAIR_SIZES[kind])
              for kind in ("luma", "chroma") for bd in (8, 10, 12)
              for draw in ("draw", "large")]
PAIR_CASES += [(kind, 8, "draw", SMALL_SIZES[kind])
               for kind in ("luma", "chroma")]
PAIR_CASES += [(kind, bd, "border", BORDER_SIZES[kind])
               for kind in ("luma", "chroma") for bd in (8, 12)]
MODES = ("vh", "v", "h")


def _pair_id(case):
  kind, bd, draw, (H, W) = case
  return f"{kind}-{bd}bit-{draw}-{H}x{W}"


def _pair_kw(kind, bd, bo, to):
  return dict(chroma=kind == "chroma", bit_depth=bd, beta_off=bo,
              tc_off=to)


def _mode_grids(mode, gv, gh):
  return (gv if "v" in mode else None), (gh if "h" in mode else None)


@pytest.mark.parametrize("case", [c for c in PAIR_CASES if c[2] != "large"
                                  or c[1] == 8], ids=_pair_id)
def test_deblock_planes_plain_matches_jax(case):
  """deblock_planes on the CPU (the plain version) equals the JAX
  package's passes in loopfilters' order (ffmpeg_tpu/models/vvc/
  pipeline.py): deblock_vertical_luma/_chroma on the plane, then on the
  transpose of the result with the horizontal grids, torch.equal."""
  import jax.numpy as jnp

  from ffmpeg_tpu.ops import deblock as JD
  from ffmpeg_tpu_torch.ops.deblock import deblock_planes

  kind, bd, draw, size = case
  P, GV, GH, bo, to = _draw_pair(kind, bd, draw, size)
  got = deblock_planes(P, GV, GH, **_pair_kw(kind, bd, bo, to))
  jf = JD.deblock_vertical_chroma if kind == "chroma" \
      else JD.deblock_vertical_luma
  for c, (p, gv, gh) in enumerate(zip(P, GV, GH)):
    kw = dict(bit_depth=bd, beta_off=bo[c], tc_off=to[c])
    v = jf(jnp.asarray(p.numpy()), *(jnp.asarray(g.numpy()) for g in gv),
           **kw)
    want = jf(v.T, *(jnp.asarray(g.numpy()) for g in gh), **kw).T
    assert torch.equal(got[c], torch.from_numpy(np.array(want))), f"plane {c}"
    assert not torch.equal(got[c], p)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", PAIR_CASES, ids=_pair_id)
def test_tiled_emulation_matches_plain(case, mode):
  """The kernel's tiling on the CPU (deblock_tiled_plain: each TILE x
  TILE tile with its halo, only the edges and rows the kernel filters)
  equals the whole-plane passes, torch.equal: both passes and each alone,
  at bit depths 8, 10 and 12, on planes whose sides are not multiples of
  TILE, smaller than a tile, and with windows across the border."""
  from ffmpeg_tpu_torch.ops import deblock as TD

  kind, bd, draw, size = case
  P, GV, GH, bo, to = _draw_pair(kind, bd, draw, size)
  gv, gh = _mode_grids(mode, GV, GH)
  kw = _pair_kw(kind, bd, bo, to)
  want = TD.deblock_planes_plain(P, gv, gh, **kw)
  assert not torch.equal(want, torch.stack(P))
  assert torch.equal(TD.deblock_tiled_plain(P, gv, gh, **kw), want)


def _deblock_calls(kw):
  """The deblock calls of a stream's frames, walked through the frame
  program on the CPU: [kwargs]."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  calls = []

  def record(name, label, k):
    if name == "deblock":
      calls.append(k)
    return KERNELS[name][0](**k)

  aus = VVCDecoder(device="cpu")._split_aus(_stream(kw))
  for _ in walk_frames(aus, "cpu", record):
    pass
  return calls


def _held_case(case):
  from test_torch_decode import INTRA_CASES

  return DEBLOCK_CASES.get(case) or INTRA_CASES[case]


HELD_CASES = list(DEBLOCK_CASES) + ["mono-filters"]


@pytest.mark.parametrize("case", HELD_CASES)
def test_tiled_emulation_on_case_frames(case):
  """The kernel's tiling on the CPU equals the whole-plane passes on
  every deblock call of the deblock cases' real frames (and 4:0:0
  frames): both passes and each alone."""
  from ffmpeg_tpu_torch.ops import deblock as TD

  calls = _deblock_calls(_held_case(case))
  assert calls
  for kw in calls:
    base = {k: v for k, v in kw.items()
            if k not in ("planes", "grids_v", "grids_h")}
    for mode in MODES:
      gv, gh = _mode_grids(mode, kw["grids_v"], kw["grids_h"])
      want = TD.deblock_planes_plain(kw["planes"], gv, gh, **base)
      assert torch.equal(TD.deblock_tiled_plain(kw["planes"], gv, gh, **base),
                         want), mode


# ---- the deblock conformance cases, and the frame program's calls ------

# the effective offsets (x2) of every component, by case: the slice
# header's beta_div2 -1, tc_div2 +2; the picture header's tc_div2 +3
CASE_OFFSETS = {"deblock-sh-override": (-2, 4), "deblock-ph": (0, 6)}


@pytest.mark.parametrize("case", list(DEBLOCK_CASES))
def test_deblock_case_matches_jax(case, monkeypatch):
  """Each case decodes on the CPU to its JAX MD5s, through two deblock
  calls a frame with the offsets the headers carry."""
  from ffmpeg_tpu_torch.models.vvc import pipeline

  with open(DEBLOCK_JSON) as f:
    want = json.load(f)[case]
  assert want["config"] == json.loads(json.dumps(DEBLOCK_CASES[case]))
  offs = []
  launch = pipeline._launch

  def record(name, label, kw):
    if name == "deblock":
      offs.extend(zip(kw["beta_off"], kw["tc_off"]))
    return launch(name, label, kw)

  monkeypatch.setattr(pipeline, "_launch", record)
  assert _port_md5s(_stream(DEBLOCK_CASES[case])) == want["md5"]
  assert len(offs) == 3 * len(want["md5"])  # luma; Cb and Cr
  assert set(offs) == {CASE_OFFSETS.get(case, (0, 0))}


@pytest.mark.parametrize("case,labels", [
    ("deblock", ["luma", "chroma"]), ("mono-filters", ["luma"])])
def test_frame_program_deblock_calls(case, labels):
  """The frame program runs deblock as 2 calls of the deblock kernel per
  4:2:0 frame (luma, then Cb and Cr together, each both passes) and 1
  per 4:0:0 frame, through its call hook; each call takes the planes,
  the vertical pass's grids laid out for them and the horizontal pass's
  laid out for their transpose."""
  from test_torch_decode import INTRA_CASES

  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def record(name, label, kw):
    out = KERNELS[name][0](**kw)
    if name == "deblock":
      H, W = kw["planes"][0].shape
      seg, grid = (2, 8) if kw["chroma"] else (4, 4)
      assert kw["grids_v"][0][0].shape == (H // seg, W // grid)
      assert kw["grids_h"][0][0].shape == (W // seg, H // grid)
      assert out.shape == (len(kw["planes"]), H, W)
      seen.append(label)
    return out

  kw = DEBLOCK_CASES.get(case) or INTRA_CASES[case]
  aus = VVCDecoder(device="cpu")._split_aus(_stream(kw))
  n = sum(1 for _ in walk_frames(aus, "cpu", record))
  assert seen == labels * n


def _meta(t):
  return torch.empty(t.shape, dtype=t.dtype, device="meta")


BAD_INPUTS = ("two-luma-planes", "grid-shape", "plane-strided", "int16",
              "missing-grid", "meta-device")


BAD_PAIRS = ("no-pass", "h-grids-untransposed", "one-grid-for-two",
             "three-chroma-planes", "chroma-rows-not-whole-edges")


@pytest.mark.parametrize("bad", BAD_PAIRS)
def test_deblock_planes_refuses(bad):
  """deblock_planes checks both passes' inputs on every device and
  raises on what the kernel does not take."""
  from ffmpeg_tpu_torch.ops.deblock import deblock_planes

  kind = "luma" if bad in ("no-pass", "h-grids-untransposed") else "chroma"
  P, GV, GH, bo, to = _draw_pair(kind, 8, "draw", PAIR_SIZES[kind])
  kw = _pair_kw(kind, 8, bo, to)
  if bad == "no-pass":
    GV = GH = None
  elif bad == "h-grids-untransposed":
    GH = GV
  elif bad == "one-grid-for-two":
    GH = GH[:1]
  elif bad == "three-chroma-planes":
    P, GV, GH = P + P[:1], GV + GV[:1], GH + GH[:1]
    kw["beta_off"], kw["tc_off"] = bo + bo[:1], to + to[:1]
  else:  # 68 rows: whole 2-line segments, not whole 8-sample edges
    P = [p[:68] for p in P]
    GV = [tuple(g[:34] for g in gg) for gg in GV]
    GH = [tuple(g[:, :8] for g in gg) for gg in GH]
    P = [p.contiguous() for p in P]
    GV = [tuple(g.contiguous() for g in gg) for gg in GV]
    GH = [tuple(g.contiguous() for g in gg) for gg in GH]
  with pytest.raises(ValueError):
    deblock_planes(P, GV, GH, **kw)


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_deblock_pass_refuses(bad):
  """deblock_pass checks its inputs on every device and raises on what
  the kernel does not take, and on a device that is neither CUDA nor the
  CPU (nothing falls back to the plain version)."""
  from ffmpeg_tpu_torch.ops.deblock import deblock_pass

  planes, grids, bo, to = _draw("luma", 8, False, "draw")
  P = [torch.from_numpy(p) for p in planes]
  G = [tuple(map(torch.from_numpy, g)) for g in grids]
  kw = _pass_kw("luma", 8, False, bo, to)
  if bad == "two-luma-planes":
    P, G, kw["beta_off"], kw["tc_off"] = P * 2, G * 2, bo * 2, to * 2
  elif bad == "grid-shape":
    G = [(G[0][0][:-1],) + G[0][1:]]
  elif bad == "plane-strided":
    P = [P[0].T.contiguous().T]
  elif bad == "int16":
    P = [P[0].to(torch.int16)]
  elif bad == "missing-grid":
    G = [G[0][:4]]
  else:
    P, G = [_meta(P[0])], [tuple(map(_meta, G[0]))]
  with pytest.raises(ValueError):
    deblock_pass(P, G, **kw)


# ---- on the card ---------------------------------------------------------

# the draws above, and one at 1920x1088 (chroma 960x544), the size of
# the main path's planes
GPU_CASES = CASES + [(kind, 8, h, "full") for kind in ("luma", "chroma")
                     for h in (False, True)]


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_deblock.py)")
  return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=_case_id)
def test_deblock_kernel_matches_plain_on_card(cuda, case):
  """The kernel's one-pass mode (deblock_pass) against the plain version
  on the same draws, tolerance 0: the vertical pass on the plane, the
  horizontal pass (grids laid out for the transpose) against the plain
  version on .T.contiguous().  5 launches each (the shared-memory
  atomics' order differs between launches), each counted once, the
  plain version never run by the wrapper, and the input planes left as
  they were."""
  from ffmpeg_tpu_torch.ops import deblock as TD

  kind, bd, h, draw = case
  planes, grids, beta_off, tc_off = _draw(
      *case[:3], "draw" if draw == "full" else draw,
      **({"size": (1088, 1920)} if draw == "full" else {}))
  P = [torch.from_numpy(p).to(cuda) for p in planes]
  G = [tuple(torch.from_numpy(a).to(cuda) for a in g) for g in grids]
  fn = TD.deblock_vertical_chroma_plain if kind == "chroma" \
      else TD.deblock_vertical_luma_plain
  want = []
  for c, (p, g) in enumerate(zip(P, G)):
    kw = dict(bit_depth=bd, beta_off=beta_off[c], tc_off=tc_off[c])
    want.append(fn(p.T.contiguous(), *g, **kw).T if h else fn(p, *g, **kw))
  want = torch.stack(want)
  launches, plain = TD.LAUNCHES["deblock"], TD.PLAIN_RUNS["deblock"]
  for i in range(5):
    got = TD.deblock_pass(P, G, **_pass_kw(kind, bd, h, beta_off, tc_off))
    assert torch.equal(got, want), f"launch {i}"
  torch.cuda.synchronize()
  assert TD.LAUNCHES["deblock"] == launches + 5
  assert TD.PLAIN_RUNS["deblock"] == plain
  assert all(torch.equal(p.cpu(), torch.from_numpy(a))
             for p, a in zip(P, planes))


# the pairs above, and a 1920x1088 plane (chroma 960x544), the size of
# the main path's planes
GPU_PAIR_CASES = PAIR_CASES + [("luma", 8, "draw", (1088, 1920)),
                               ("chroma", 8, "draw", (544, 960))]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", GPU_PAIR_CASES, ids=_pair_id)
def test_deblock_planes_kernel_matches_plain_on_card(cuda, case, mode):
  """The kernel, both passes in one launch (deblock_planes) and each
  alone (deblock_pass), against the plain version on the same draws,
  tolerance 0, on planes whose sides are not multiples of the tile,
  smaller than a tile, with windows across the border, and at 1080p.
  5 launches each, each counted once, no plain run by the wrapper, the
  inputs left as they were."""
  from ffmpeg_tpu_torch.ops import deblock as TD

  kind, bd, draw, size = case
  P, GV, GH, bo, to = _draw_pair(kind, bd, draw, size)
  kw = _pair_kw(kind, bd, bo, to)
  gv, gh = _mode_grids(mode, GV, GH)
  want = TD.deblock_planes_plain(P, gv, gh, **kw).to(cuda)
  Pc = [p.to(cuda) for p in P]
  gvc, ghc = ([tuple(t.to(cuda) for t in g) for g in gg] if gg else None
              for gg in (gv, gh))
  launches, plain = TD.LAUNCHES["deblock"], TD.PLAIN_RUNS["deblock"]
  for i in range(5):
    if mode == "vh":
      got = TD.deblock_planes(Pc, gvc, ghc, **kw)
    else:
      got = TD.deblock_pass(Pc, gvc or ghc, horizontal=mode == "h", **kw)
    assert torch.equal(got, want), f"launch {i}"
  torch.cuda.synchronize()
  assert TD.LAUNCHES["deblock"] == launches + 5
  assert TD.PLAIN_RUNS["deblock"] == plain
  assert all(torch.equal(a.cpu(), b) for a, b in zip(Pc, P))


@pytest.mark.gpu
@pytest.mark.parametrize("case", HELD_CASES)
def test_deblock_kernel_on_case_frames_on_card(cuda, case):
  """Every deblock call of the deblock cases' frames (and 4:0:0 frames),
  walked on the card: the kernel, both passes and each alone (the
  horizontal pass on the vertical pass's result), equal to the plain
  version, tolerance 0."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames
  from ffmpeg_tpu_torch.ops import deblock as TD

  n = []

  def check(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name != "deblock":
      return got
    base = {k: v for k, v in kw.items()
            if k not in ("planes", "grids_v", "grids_h")}
    assert torch.equal(got, TD.deblock_planes_plain(
        kw["planes"], kw["grids_v"], kw["grids_h"], **base)), label
    v = TD.deblock_pass(kw["planes"], kw["grids_v"], horizontal=False, **base)
    assert torch.equal(v, TD.deblock_pass_plain(
        kw["planes"], kw["grids_v"], horizontal=False, **base)), label
    h = TD.deblock_pass(list(v), kw["grids_h"], horizontal=True, **base)
    assert torch.equal(h, got), label
    n.append(label)
    return got

  aus = VVCDecoder(device=cuda)._split_aus(_stream(_held_case(case)))
  frames = sum(1 for _ in walk_frames(aus, cuda, check))
  assert len(n) == frames * (1 if case == "mono-filters" else 2)


@pytest.mark.gpu
def test_deblock_launch_failure_raises(cuda):
  """A launch the kernel refuses (grids that do not match the plane,
  past the wrapper's checks) raises; so does a failed build."""
  from ffmpeg_tpu_torch.ops import deblock as TD

  planes, grids, bo, to = _draw("luma", 8, False, "draw")
  P = [torch.from_numpy(planes[0]).to(cuda)]
  G = [tuple(torch.from_numpy(a[:-1]).to(cuda) for a in grids[0])]
  with pytest.raises(RuntimeError, match="deblock kernel launch failed"):
    TD._deblock_cuda(P, G, None, chroma=False, bit_depth=8, beta_off=bo,
                     tc_off=to)


@pytest.mark.gpu
def test_deblock_build_failure_raises(cuda, tmp_path, monkeypatch):
  from ffmpeg_tpu_torch.ops import deblock as TD
  from ffmpeg_tpu_torch.utils import build

  (tmp_path / "deblock.cu").write_text("this is not CUDA\n")
  monkeypatch.setattr(TD, "_SRC", str(tmp_path / "deblock.cu"))
  monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
  monkeypatch.setattr(TD, "_lib", None)
  with pytest.raises(RuntimeError, match="nvcc failed"):
    TD._get_kernel()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DEBLOCK_CASES))
def test_deblock_case_decodes_on_card(cuda, case):
  """Each case through the kernels on the card to the JAX MD5s, the
  streams made as the tool cases' are: deblock launched 2 times a frame,
  no plain version run."""
  from test_torch_decode import _counts_zeroed

  from ffmpeg_tpu_torch.ops import deblock as D

  with open(DEBLOCK_JSON) as f:
    want = json.load(f)[case]["md5"]
  P, R = _counts_zeroed()
  assert _port_md5s(_stream(DEBLOCK_CASES[case]), device=cuda) == want
  assert D.LAUNCHES["deblock"] == 2 * len(want)
  assert R.LAUNCHES["recon"] > 0
  assert (P.LAUNCHES["inter_pred"] > 0) == bool(
      DEBLOCK_CASES[case].get("inter"))
  assert D.PLAIN_RUNS["deblock"] == 0 and R.PLAIN_RUNS["recon"] == 0
  assert P.PLAIN_RUNS["inter_pred"] == 0


def _jax_md5s(data):
  from ffmpeg_tpu.models.vvc.decoder import DecoderConfig, VVCDecoder

  dec = VVCDecoder(config=DecoderConfig(errors="contain"))
  return [f.md5() for f in dec.decode(data)]


def main():
  """Regenerate deblock_cases.md5.json with the JAX package's decoder,
  one decode at a time."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  out = {}
  for case, kw in DEBLOCK_CASES.items():
    out[case] = {"config": kw, "md5": _jax_md5s(_stream(kw))}
    print(case, out[case]["md5"], flush=True)
  with open(DEBLOCK_JSON, "w") as f:
    json.dump(out, f, indent=1)
    f.write("\n")


if __name__ == "__main__":
  main()
