"""SAO: the port's entry points sao_planes, sao_rows and sao_plane (their
plain versions on the CPU) against the JAX package's sao_plane and
sao_rows, bit for bit (tolerance 0: integer arithmetic), on seeded draws
at 8, 10 and 12 bits: a luma call and a Cb+Cr call (the chroma planes as
views of one tensor, as deblock leaves them, and as separate tensors),
every SAO type and EO class, band positions 28-31 (the band index
wraps), pictures smaller than their padded planes, samples at 0 and at
the maximum; the band form (a halo row, y0 > 0, zero ring ends); the
4:0:0 frame's one call; the frame program asking the Cb+Cr call to
overlap the luma call only when it launches the kernels itself; the
wrappers' checks; and (on the card) the CUDA kernel csrc/sao.cu against
the plain version, at 1080p too, overlapped pairs among them.

JAX is imported inside the tests that need it, so that the card, which
has no JAX, collects the `gpu` tests:

  python -m pytest --noconftest -m gpu tests/test_torch_sao.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_decode import (INTRA_CASES, TESTDATA, TOOL_CASES,  # noqa: E402
                               _fixture_md5s, _port_md5s, _read, _stream)

from ffmpeg_tpu_torch.ops import sao as TS  # noqa: E402

torch.set_num_threads(2)

BDS = (8, 10, 12)
LAYOUTS = ("luma", "chroma-views", "chroma-separate")
# (Hp, Wp, pic_h, pic_w, luma CTB): CTB-aligned planes with smaller
# pictures, and a plane width that is not a multiple of the CTB (the
# last CTB column's grid entry covers the rest: the CTB column clamps);
# CTB 128 with a picture width that is not a multiple of it (12 CTBs:
# the kernel's tiles lie inside one CTB, which covers a tile and more)
SHAPES = [(96, 128, 88, 120, 32), (128, 136, 120, 130, 32),
          (192, 256, 180, 250, 64), (64, 96, 64, 96, 16),
          (384, 512, 380, 500, 128)]


def _plane(rng, H, W, bd):
  """Samples from a few levels around mid-grey, so that neighbours are
  often equal, with runs at 0 and at the maximum."""
  maxv = (1 << bd) - 1
  mid = 1 << (bd - 1)
  p = mid + rng.integers(-3, 4, (H, W)) * rng.choice([1, 5, 1 << (bd - 4)],
                                                      (H, W))
  p = np.where(rng.random((H, W)) < 0.05, 0, p)
  p = np.where(rng.random((H, W)) < 0.05, maxv, p)
  p[:, :4] = maxv
  p[-3:, :] = 0
  return np.clip(p, 0, maxv).astype(np.int32)


def _tree(rng, cbh, cbw):
  """A frame's SAO tree in its converted layout (int32): per CTB and
  component type 0-2, band position (a quarter of them 28-31), EO class
  0-3, 5 offsets in -31..31.  In CTB raster order the first four CTBs
  of every component are edge CTBs of classes 0-3, the next four band
  CTBs at positions 28-31 and the ninth is off."""
  typ = rng.integers(0, 3, (cbh, cbw, 3))
  band = np.where(rng.random((cbh, cbw, 3)) < 0.25,
                  rng.integers(28, 32, (cbh, cbw, 3)),
                  rng.integers(0, 32, (cbh, cbw, 3)))
  eo = rng.integers(0, 4, (cbh, cbw, 3))
  offv = rng.integers(-31, 32, (cbh, cbw, 3, 5))
  t, b, e = (a.reshape(-1, 3) for a in (typ, band, eo))
  t[:4], e[:4] = 2, np.arange(4)[:, None]
  t[4:8], b[4:8] = 1, np.arange(28, 32)[:, None]
  t[8] = 0
  return {"type": typ.astype(np.int32), "band": band.astype(np.int32),
          "eo": eo.astype(np.int32), "offv": offv.astype(np.int32)}


def draw(bd, shape, layout, seed):
  """A call's numpy inputs: planes [(Hp, Wp)] and the call's geometry
  (the component's picture and CTB size), with the frame's tree."""
  Hp, Wp, ph, pw, ctb = shape
  rng = np.random.default_rng(seed)
  ss = 0 if layout == "luma" else 1
  Hp, Wp, ph, pw, ctb = Hp >> ss, Wp >> ss, ph >> ss, pw >> ss, ctb >> ss
  n = 1 if layout == "luma" else 2
  planes = [_plane(rng, Hp, Wp, bd) for _ in range(n)]
  tree = _tree(rng, -(-Hp // ctb), Wp // ctb)
  return planes, tree, dict(comps=(0,) if n == 1 else (1, 2), pic_w=pw,
                            pic_h=ph, ctb=ctb, bit_depth=bd)


def to_call(planes, tree, geo, layout, device):
  """The draw as sao_planes's arguments on `device`: chroma planes as
  views of one (2, Hp, Wp) tensor, or as separate tensors."""
  if layout == "chroma-views":
    both = torch.from_numpy(np.stack(planes)).to(device)
    pl = [both[0], both[1]]
  else:
    pl = [torch.from_numpy(p).to(device) for p in planes]
  return dict(planes=pl, sao={k: torch.from_numpy(v).to(device)
                              for k, v in tree.items()}, **geo)


def _jax_planes(planes, tree, geo):
  """The JAX package's sao_plane per plane, as the JAX frame program
  calls it."""
  import jax.numpy as jnp

  from ffmpeg_tpu.ops import sao as JS

  out = []
  for p, c in zip(planes, geo["comps"]):
    out.append(np.asarray(JS.sao_plane(
        jnp.asarray(p), jnp.asarray(tree["type"][..., c]),
        jnp.asarray(tree["band"][..., c]), jnp.asarray(tree["offv"][..., c, :]),
        jnp.asarray(tree["eo"][..., c]), geo["pic_w"], geo["pic_h"],
        ctb=geo["ctb"], bit_depth=geo["bit_depth"])))
  return np.stack(out)


def _ids(shape):
  return f"{shape[1]}x{shape[0]}-pic{shape[3]}x{shape[2]}-ctb{shape[4]}"


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bd", BDS)
def test_sao_planes_plain_matches_jax(bd, layout, shape):
  planes, tree, geo = draw(bd, shape, layout, seed=bd * 10 + len(layout))
  kw = to_call(planes, tree, geo, layout, "cpu")
  runs = TS.PLAIN_RUNS["sao"]
  got = TS.sao_planes(**kw)
  assert TS.PLAIN_RUNS["sao"] == runs + 1
  want = _jax_planes(planes, tree, geo)
  np.testing.assert_array_equal(got.numpy(), want)
  assert torch.equal(got, TS.sao_planes_plain(**kw))
  # the draw reaches the offsets, the clip and the untouched padding
  assert np.any(want != np.stack(planes))
  assert np.any(want == (1 << bd) - 1) and np.any(want == 0)
  np.testing.assert_array_equal(want[:, geo["pic_h"]:],
                                np.stack(planes)[:, geo["pic_h"]:])


@pytest.mark.parametrize("bd", BDS)
def test_sao_draws_cover_every_mode(bd):
  """The draws hold every type, every EO class and band positions 28-31
  on CTBs inside the picture."""
  for shape in SHAPES:
    for layout in LAYOUTS:
      _, tree, geo = draw(bd, shape, layout, seed=bd * 10 + len(layout))
      c = geo["comps"][0]
      typ = tree["type"][..., c]
      assert set(np.unique(typ)) == {0, 1, 2}
      assert set(np.unique(tree["eo"][..., c][typ == 2])) == {0, 1, 2, 3}
      assert np.any(tree["band"][..., c][typ == 1] >= 28)


def band_draw(bd, seed):
  """A band of the band split: 2 CTB rows of a 128-row plane with its
  halo rows, the band's own grids, at picture row y0 = 64."""
  rng = np.random.default_rng(seed)
  ctb, Wp = 32, 96
  full = _plane(rng, 128, Wp, bd)
  tree = _tree(rng, 4, 3)
  y0 = 64
  ext = full[y0 - 1:y0 + 2 * ctb + 1].copy()
  grids = (tree["type"][2:4, :, 0], tree["band"][2:4, :, 0],
           tree["offv"][2:4, :, 0], tree["eo"][2:4, :, 0])
  return ext, grids, dict(pic_w=Wp - 6, pic_h=120, ctb=ctb, bit_depth=bd,
                          y0=y0, halo=1)


@pytest.mark.parametrize("ring", ["halo", "zero-ring"])
@pytest.mark.parametrize("bd", BDS)
def test_sao_rows_band_form_matches_jax(bd, ring):
  """sao_rows with a halo row above and below (or zero rows, the band
  split's ring ends, which the in-picture test masks at the picture's
  edge) against JAX sao_rows."""
  import jax.numpy as jnp

  from ffmpeg_tpu.ops import sao as JS

  ext, grids, geo = band_draw(bd, seed=bd)
  if ring == "zero-ring":
    ext[0] = ext[-1] = 0
    geo = dict(geo, pic_h=geo["y0"] + 2 * geo["ctb"])
  got = TS.sao_rows(torch.from_numpy(ext),
                    *(torch.from_numpy(np.ascontiguousarray(g))
                      for g in grids), **geo)
  want = np.asarray(JS.sao_rows(jnp.asarray(ext),
                                *(jnp.asarray(g) for g in grids), **geo))
  assert got.shape == (ext.shape[0] - 2, ext.shape[1])
  np.testing.assert_array_equal(got.numpy(), want)
  assert np.any(want != ext[1:-1])


def test_sao_plane_plain_matches_jax():
  """sao_plane, the single-plane form the band split's tests hold."""
  planes, tree, geo = draw(10, SHAPES[1], "luma", seed=3)
  g = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
      tree["type"][..., 0], tree["band"][..., 0], tree["offv"][..., 0, :],
      tree["eo"][..., 0])]
  got = TS.sao_plane(torch.from_numpy(planes[0]), *g, geo["pic_w"],
                     geo["pic_h"], ctb=geo["ctb"], bit_depth=10)
  np.testing.assert_array_equal(got.numpy(),
                                _jax_planes(planes, tree, geo)[0])


def _mono_sao_calls(device, check):
  """Walk the 4:0:0 case with SAO (mono-filters) through the frame
  program on `device` with `check` on its SAO calls; returns every
  frame's SAO calls' plane kinds."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen, frames = [], []

  def hook(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name == "sao":
      seen.append(label)
      check(got, kw)
    return got

  aus = VVCDecoder(device=device)._split_aus(
      _stream(INTRA_CASES["mono-filters"]))
  for fs, h in walk_frames(aus, device, hook):
    assert fs.chroma_format_idc == 0
    frames.append((("sao" in h), list(seen)))
    seen.clear()
  return frames


def test_sao_mono_frame_one_call():
  """A 4:0:0 frame with SAO makes one SAO call (luma), equal to JAX's
  sao_plane on the same plane."""
  def check(got, kw):
    assert kw["comps"] == (0,) and got.shape[0] == 1
    tree = {k: v.numpy() for k, v in kw["sao"].items()}
    np.testing.assert_array_equal(
        got.numpy(), _jax_planes([kw["planes"][0].numpy()], tree, kw))

  frames = _mono_sao_calls("cpu", check)
  assert any(on for on, _ in frames)
  for on, calls in frames:
    assert calls == (["luma"] if on else [])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sao_planes_overlap_on_cpu_is_plain(layout):
  """overlap=True, which the frame program passes on its Cb+Cr call, runs
  the plain version on the CPU: the same result, no launch."""
  planes, tree, geo = draw(8, SHAPES[1], layout, seed=7)
  kw = to_call(planes, tree, geo, layout, "cpu")
  runs, launches = TS.PLAIN_RUNS["sao"], TS.LAUNCHES["sao"]
  got = TS.sao_planes(**kw, overlap=True)
  assert TS.PLAIN_RUNS["sao"] == runs + 1 and TS.LAUNCHES["sao"] == launches
  assert torch.equal(got, TS.sao_planes_plain(**kw))


@pytest.mark.parametrize("hooked", [False, True], ids=["session", "hook"])
def test_frame_program_asks_sao_overlap_without_hook(monkeypatch, hooked):
  """Launching the kernels itself (the session, through pipeline._launch),
  the frame program asks every sao Cb+Cr call to overlap the luma call
  just before it (overlap=True) and no luma call; through a call hook,
  which may queue work between the two calls, it never asks."""
  from ffmpeg_tpu_torch.models.vvc import pipeline as P
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  asked = []
  launch = P._launch

  def spy(name, label, kw):
    if name == "sao":
      asked.append((label, kw.get("overlap")))
    return launch(name, label, kw)

  data = _stream(TOOL_CASES["alf-inter"])
  if hooked:
    aus = VVCDecoder(device="cpu")._split_aus(data)
    frames = sum(1 for _ in P.walk_frames(aus, "cpu", spy))
  else:
    monkeypatch.setattr(P, "_launch", spy)
    frames = len(_port_md5s(data))
  n = sum(1 for label, _ in asked if label == "luma")
  assert frames == 4 and n > 0
  assert asked == [("luma", None), ("chroma", None if hooked else True)] * n


BAD = ("three-planes", "comps-mismatch", "meta-device")


@pytest.mark.parametrize("bad", BAD)
def test_sao_planes_refuses(bad):
  planes, tree, geo = draw(8, SHAPES[0], "chroma-separate", seed=1)
  kw = to_call(planes, tree, geo, "chroma-separate", "cpu")
  if bad == "three-planes":
    kw["planes"] = kw["planes"] * 2
    kw["comps"] = (1, 2, 1, 2)
  elif bad == "comps-mismatch":
    kw["comps"] = (1,)
  else:
    kw["planes"] = [p.to("meta") for p in kw["planes"]]
  with pytest.raises(ValueError):
    TS.sao_planes(**kw)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_sao.py)")
  return torch.device("cuda")


def _launched(fn, n=1):
  """fn's result, and that it launched the SAO kernel n times."""
  before = TS.LAUNCHES["sao"]
  out = fn()
  torch.cuda.synchronize()
  assert TS.LAUNCHES["sao"] == before + n
  return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bd", BDS)
def test_sao_kernel_matches_plain(cuda, bd, layout, shape):
  planes, tree, geo = draw(bd, shape, layout, seed=bd * 10 + len(layout))
  kw = to_call(planes, tree, geo, layout, cuda)
  runs = TS.PLAIN_RUNS["sao"]
  got = _launched(lambda: TS.sao_planes(**kw))
  assert TS.PLAIN_RUNS["sao"] == runs
  assert torch.equal(got, TS.sao_planes_plain(**kw))


@pytest.mark.gpu
@pytest.mark.parametrize("bd", BDS)
def test_sao_kernel_unaligned_planes(cuda, bd):
  """Planes 4 bytes off 16-byte alignment, whose rows are 4 bytes apart
  from a multiple of 16 (the kernel's 4-byte path), and an odd width."""
  planes, tree, geo = draw(bd, SHAPES[1], "chroma-separate", seed=bd)
  kw = to_call(planes, tree, geo, "chroma-separate", cuda)
  Hp, Wp = kw["planes"][0].shape
  big = torch.zeros((2, Hp, Wp + 1), dtype=torch.int32, device=cuda)
  big[:, :, 1:] = torch.stack(kw["planes"])
  kw["planes"] = [big[0, :, 1:], big[1, :, 1:]]
  got = _launched(lambda: TS.sao_planes(**kw))
  assert torch.equal(got, TS.sao_planes_plain(**kw))
  odd = dict(kw, planes=[p[:, :Wp - 3] for p in kw["planes"]])
  got = _launched(lambda: TS.sao_planes(**odd))
  assert torch.equal(got, TS.sao_planes_plain(**odd))


@pytest.mark.gpu
@pytest.mark.parametrize("ring", ["halo", "zero-ring"])
@pytest.mark.parametrize("bd", BDS)
def test_sao_kernel_band_form(cuda, bd, ring):
  ext, grids, geo = band_draw(bd, seed=bd)
  if ring == "zero-ring":
    ext[0] = ext[-1] = 0
    geo = dict(geo, pic_h=geo["y0"] + 2 * geo["ctb"])
  args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
          for a in (ext, *grids)]
  got = _launched(lambda: TS.sao_rows(*args, **geo))
  assert torch.equal(got, TS.sao_rows_plain(*args, **geo))


@pytest.mark.gpu
def test_sao_kernel_mono_frames(cuda):
  """The 4:0:0 stream on the card: one SAO launch per frame with SAO,
  each equal to the plain version."""
  def check(got, kw):
    assert torch.equal(got, TS.sao_planes_plain(**kw))

  before = TS.LAUNCHES["sao"]
  frames = _mono_sao_calls(cuda, check)
  assert TS.LAUNCHES["sao"] - before == sum(on for on, _ in frames) > 0


# 1080p planes padded to their CTB: luma, and Cb with Cr as views
HD = {"ctb32": (1088, 1920, 1080, 1920, 32),
      "ctb128": (1152, 1920, 1080, 1920, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("luma", "chroma-views"))
@pytest.mark.parametrize("hd", HD)
@pytest.mark.parametrize("bd", (8, 10))
def test_sao_kernel_1080p(cuda, bd, hd, layout):
  """A 1080p frame's calls at CTB 32 (1088x1920 luma, 544x960 chroma)
  and CTB 128 (1152x1920, 576x960): every type and EO class."""
  planes, tree, geo = draw(bd, HD[hd], layout, seed=bd + len(hd))
  kw = to_call(planes, tree, geo, layout, cuda)
  typ = tree["type"][..., geo["comps"][0]]
  assert set(np.unique(typ)) == {0, 1, 2}
  assert set(np.unique(tree["eo"][..., geo["comps"][0]][typ == 2])) == \
      {0, 1, 2, 3}
  got = _launched(lambda: TS.sao_planes(**kw))
  assert torch.equal(got, TS.sao_planes_plain(**kw))


@pytest.mark.gpu
def test_sao_kernel_overlapped_pairs_on_card(cuda):
  """20 luma and Cb+Cr call pairs of full1080's first B frame queued back
  to back on one stream, as the frame program queues them, the Cb+Cr
  call asking to overlap the luma launch (overlap=True): 20 overlapped
  launches, each output equal to the plain version's; then the same
  without the request: none."""
  from ffmpeg_tpu_torch.tools.deblock_tiles import b_frame_calls

  calls = dict(b_frame_calls(os.path.join(TESTDATA, "full1080.vvc"), "sao"))
  kl, kc = calls["luma"], calls["chroma"]
  want = [TS.sao_planes_plain(**kl), TS.sao_planes_plain(**kc)]
  for overlap in (True, False):
    torch.cuda.synchronize()
    TS.OVERLAPS["sao"] = 0
    outs = [TS.sao_planes(**kw) for _ in range(20)
            for kw in (kl, dict(kc, overlap=overlap))]
    torch.cuda.synchronize()
    assert TS.OVERLAPS["sao"] == (20 if overlap else 0)
    bad = [i for i, o in enumerate(outs) if not torch.equal(o, want[i % 2])]
    assert not bad, f"calls {bad} differ"


@pytest.mark.gpu
def test_sao_session_overlaps_on_card(cuda):
  """The session (no call hook) decodes full1080 to its committed MD5s
  with 2 sao launches a frame, each frame's Cb+Cr launch overlapping its
  luma launch: a lost overlap fails here."""
  TS.LAUNCHES["sao"] = TS.OVERLAPS["sao"] = 0
  assert _port_md5s(_read("full1080"), device="cuda") == \
      _fixture_md5s("full1080")
  assert (TS.LAUNCHES["sao"], TS.OVERLAPS["sao"]) == (10, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [(24, 40, 1), (8, 30, 2), (16, 48, 1)],
                         ids=lambda b: f"y{b[0]}-h{b[1]}-halo{b[2]}")
@pytest.mark.parametrize("bd", (8, 12))
def test_sao_kernel_band_form_across_tiles(cuda, bd, band):
  """Bands whose first row and height are not multiples of the kernel's
  tile rows (ops/sao.py TILE), so that halo rows and CTB rows (16) cross
  tile boundaries; the band's grids start at its first CTB row."""
  y0, h, halo = band
  rng = np.random.default_rng(bd + y0)
  full = _plane(rng, 128, 136, bd)
  tree = _tree(rng, 8, 8)
  ctb = 16
  ext = torch.from_numpy(full[y0 - halo:y0 + h + halo].copy()).to(cuda)
  grids = [torch.from_numpy(np.ascontiguousarray(tree[k][y0 // ctb:, :, 0]))
           .to(cuda) for k in ("type", "band", "offv", "eo")]
  geo = dict(pic_w=130, pic_h=120, ctb=ctb, bit_depth=bd, y0=y0, halo=halo)
  got = _launched(lambda: TS.sao_rows(ext, *grids, **geo))
  assert got.shape == (h, 136)
  assert torch.equal(got, TS.sao_rows_plain(ext, *grids, **geo))


@pytest.mark.gpu
def test_sao_kernel_refuses_small_ctb(cuda):
  """A CTB below the kernel's smallest (ops/sao.py MIN_CTB), or not a
  power of 2, raises; nothing is launched."""
  planes, tree, geo = draw(8, SHAPES[0], "luma", seed=2)
  kw = to_call(planes, tree, geo, "luma", cuda)
  before = TS.LAUNCHES["sao"]
  for ctb in (4, 10):
    with pytest.raises(ValueError, match="CTB"):
      TS.sao_planes(**dict(kw, ctb=ctb))
  assert TS.LAUNCHES["sao"] == before


@pytest.mark.gpu
def test_sao_kernel_refuses_int64(cuda):
  planes, tree, geo = draw(8, SHAPES[0], "luma", seed=2)
  kw = to_call(planes, tree, geo, "luma", cuda)
  kw["planes"] = [kw["planes"][0].long()]
  with pytest.raises(ValueError):
    TS.sao_planes(**kw)
