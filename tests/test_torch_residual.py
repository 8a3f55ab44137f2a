"""The residual stage: the port's entry point residual_planes (its plain
version on the CPU) against the JAX package's `_residual_from_buckets`,
bit for bit (tolerance 0: integer arithmetic, and float64 products that
are exact), on seeded draws of whole calls at 8, 10 and 12 bits (every
luma class: 2-D with MTS, LFNST in both layouts and transform skip,
1-D ISP, TB-64 and ISP-64; the Cb+Cr classes with joint CbCr in every
mode and LMCS chroma scaling; with and without scaling lists; levels at
the 16-bit limits) and on a 4:0:0 frame; the wrapper's checks; the rows
the plain version refuses; and (on the card) the CUDA kernel
csrc/residual.cu against the plain version.

JAX is imported inside the tests that need it, so that the card, which
has no JAX, collects the `gpu` tests:

  python -m pytest --noconftest -m gpu tests/test_torch_residual.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_alf import ALF_MONO  # noqa: E402
from test_torch_decode import (CODING_CASES, _read,  # noqa: E402
                               _stream)
from torch_residual_draws import draw_call  # noqa: E402

from ffmpeg_tpu_torch.ops import transform as TT  # noqa: E402
from ffmpeg_tpu_torch.ops.transform import BUCKET_ROWS  # noqa: E402

torch.set_num_threads(2)

BDS = (8, 10, 12)
# (kind, with_sl, scaled): luma with and without scaling lists; Cb+Cr
# with and without scaling lists and LMCS scales
VARIANTS = [("luma", False, False), ("luma", True, False),
            ("chroma", False, False), ("chroma", True, False),
            ("chroma", False, True), ("chroma", True, True)]
DRAWS = [(bd, *v, False) for bd in BDS for v in VARIANTS] + [
    (12, "luma", True, False, True), (12, "chroma", False, True, True)]


def _draw_id(d):
  bd, kind, with_sl, scaled, clamp = d
  return "-".join([f"{bd}bit", kind] + ["sl"] * with_sl
                  + ["lmcs"] * scaled + ["clamp"] * clamp)


def _call(draw, device="cpu"):
  bd, kind, with_sl, scaled, clamp = draw
  return draw_call(kind, bd, with_sl, scaled, clamp,
                   seed=bd * 10 + VARIANTS.index((kind, with_sl, scaled)),
                   device=device)


def _jax_residual(*, buckets, sizes, Hp, Wp, bit_depth, chroma,
                  chroma_scale=None, sl=None):
  """JAX _residual_from_buckets on the same inputs (numpy), for each
  component of the call.  Returns (nch, Hp, Wp) numpy."""
  import jax.numpy as jnp

  from ffmpeg_tpu.models.vvc import pipeline as JP

  def j(t):
    return jnp.asarray(t.cpu().numpy())

  cs = None if chroma_scale is None else j(chroma_scale)
  jsl = None if sl is None else {k: j(v) for k, v in sl.items()}
  out = []
  for comp in buckets:
    jb = {wh: {"mat": j(b["mat"]), "lv": j(b["lv"]),
               "n": jnp.asarray([int(b["n"])], jnp.int32)}
          for wh, b in comp.items()}
    out.append(np.asarray(JP._residual_from_buckets(
        jb, Hp, Wp, bit_depth, tuple(sizes), chroma, cs, jsl)))
  return np.stack(out)


def _kinds_present(kw):
  """What a drawn call exercises: its rows' tools (each must be there)."""
  k = BUCKET_ROWS.index
  rows = [b["mat"].cpu().numpy() for comp in kw["buckets"]
          for b in comp.values()]
  cat = np.concatenate(rows, axis=1)
  return {"ts": bool((cat[k("ts")] > 0).any()),
          "lfnst": bool((cat[k("lf_sel")] >= 0).any()),
          "lfnst_tr": bool(((cat[k("lf_sel")] >= 0)
                            & (cat[k("lf_tr")] > 0)).any()),
          "mts": bool(((cat[k("trh")] > 0) | (cat[k("trv")] > 0)).any()),
          "jop": sorted(set(cat[k("jop")].tolist()))}


# ---- the plain entry against JAX -----------------------------------------

@pytest.mark.parametrize("draw", DRAWS, ids=_draw_id)
def test_residual_planes_plain_matches_jax(draw):
  """residual_planes on CPU tensors (the plain version, run once, no
  launch) against JAX _residual_from_buckets on the same seeded call,
  every class of the plane kind, an empty class among them: the whole
  planes equal."""
  kw = _call(draw)
  plain, launches = TT.PLAIN_RUNS["residual"], TT.LAUNCHES["residual"]
  got = TT.residual_planes(**kw)
  assert TT.PLAIN_RUNS["residual"] == plain + 1
  assert TT.LAUNCHES["residual"] == launches
  assert got.shape == (2 if kw["chroma"] else 1, kw["Hp"], kw["Wp"])
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), _jax_residual(**kw))
  assert np.count_nonzero(got.numpy()) > got.numel() // 8
  seen = _kinds_present(kw)
  assert seen["ts"] and seen["mts"]
  if kw["chroma"]:
    assert seen["jop"] == [0, 1, 2, 3, 4]
  else:
    assert seen["lfnst"] and seen["lfnst_tr"]


def _mono_calls(check):
  """Walk the 4:0:0 ALF stream (test_torch_alf.ALF_MONO) on the CPU
  through the frame program with `check` as its call hook; returns the
  calls per frame."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import walk_frames

  seen, frames = [], []

  def hook(name, label, kw):
    seen.append((name, label))
    return check(name, label, kw)

  aus = VVCDecoder(device="cpu")._split_aus(_stream(ALF_MONO))
  for fs, _ in walk_frames(aus, "cpu", hook):
    assert fs.chroma_format_idc == 0
    frames.append(list(seen))
    seen.clear()
  return frames


def test_residual_plain_matches_jax_on_mono_frame():
  """A 4:0:0 frame makes one residual call (luma) and equals JAX."""
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS

  def check(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name == "residual":
      assert label == "luma" and got.shape[0] == 1
      np.testing.assert_array_equal(got.numpy(), _jax_residual(**kw))
    return got

  frames = _mono_calls(check)
  assert frames and all(
      [c for c in calls if c[0] == "residual"] == [("residual", "luma")]
      for calls in frames)


# ---- the wrapper's checks and the rows the plain version refuses -------------

BAD = ("one-component-chroma", "two-component-luma", "int16-levels",
       "rows-strided", "levels-wrong-shape", "missing-class", "bit-depth-7",
       "scale-with-luma", "int64-scale", "sl-wrong-shape", "meta-device")


def _meta(t):
  return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("bad", BAD)
def test_residual_planes_refuses(bad):
  """residual_planes checks its inputs on every device and raises
  ValueError on what the kernel does not take, and on a device that is
  neither CUDA nor the CPU (nothing is converted, nothing falls back)."""
  chroma = bad in ("one-component-chroma", "int64-scale")
  kw = draw_call("chroma" if chroma else "luma", 10, with_sl=True,
                 scaled=chroma, n=2)
  comp = kw["buckets"][0]
  wh = kw["sizes"][0]
  if bad == "one-component-chroma":
    kw["buckets"] = kw["buckets"][:1]
  elif bad == "two-component-luma":
    kw["buckets"] = kw["buckets"] * 2
  elif bad == "int16-levels":
    comp[wh]["lv"] = comp[wh]["lv"].to(torch.int16)
  elif bad == "rows-strided":
    comp[wh]["mat"] = comp[wh]["mat"].T.contiguous().T
  elif bad == "levels-wrong-shape":
    comp[wh]["lv"] = comp[wh]["lv"][:, :, :1].contiguous()
  elif bad == "missing-class":
    del comp[wh]
  elif bad == "bit-depth-7":
    kw["bit_depth"] = 7
  elif bad == "scale-with-luma":
    kw["chroma_scale"] = torch.ones(4, dtype=torch.int32)
  elif bad == "int64-scale":
    kw["chroma_scale"] = kw["chroma_scale"].long()
  elif bad == "sl-wrong-shape":
    kw["sl"]["rec"] = kw["sl"]["rec"][:27].contiguous()
  else:
    kw["buckets"] = [{k: dict(b, mat=_meta(b["mat"]), lv=_meta(b["lv"]))
                      for k, b in c.items()} for c in kw["buckets"]]
    kw["sl"] = {k: _meta(v) for k, v in kw["sl"].items()}
  with pytest.raises(ValueError, match="residual"):
    TT.residual_planes(**kw)


# rows that index out of range: (row, value, kind, scaled, with_sl); the
# kernel writes its error word for each and the wrapper raises
BAD_ROWS = {"kind": ("trv", 3, "luma", False, False),
            "vpdu": ("vpdu", 99, "chroma", True, False),
            "slid": ("slid", 28, "luma", False, True),
            "place": ("y0", 10 ** 6, "luma", False, False)}


def _bad_row_call(which, device="cpu"):
  """A seeded call whose one TU (of the 8x8 class) has a bad row."""
  row, value, kind, scaled, with_sl = BAD_ROWS[which]
  kw = draw_call(kind, 10, with_sl=with_sl, scaled=scaled, n=2,
                 device=device)
  b = kw["buckets"][0][(8, 8)]
  b["mat"][BUCKET_ROWS.index(row), 1] = value
  return kw


@pytest.mark.parametrize("which", sorted(BAD_ROWS))
def test_residual_plain_refuses_bad_rows(which):
  """The plain version raises on the rows the kernel refuses: a
  transform kind, a VPDU or a scaling-list id past its table, a block
  past the plane."""
  with pytest.raises(IndexError):
    TT.residual_planes(**_bad_row_call(which))


def test_residual_empty_call_plain():
  """A call without TUs gives zero planes."""
  kw = draw_call("chroma", 8, n=2)
  for comp in kw["buckets"]:
    for wh, b in comp.items():
      comp[wh] = dict(b, mat=b["mat"][:, :0].contiguous(),
                      lv=b["lv"][:0].contiguous(), n=0)
  got = TT.residual_planes(**kw)
  assert got.shape == (2, kw["Hp"], kw["Wp"]) and not got.any()


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_residual.py)")
  return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("draw", DRAWS, ids=_draw_id)
def test_residual_kernel_matches_plain_on_card(cuda, draw):
  """The kernel against the plain version on the same card tensors,
  tolerance 0: 3 launches, each counted once, no plain run by the
  wrapper."""
  kw = _call(draw, cuda)
  want = TT.residual_planes_plain(**kw)
  launches, plain = TT.LAUNCHES["residual"], TT.PLAIN_RUNS["residual"]
  for i in range(3):
    got = TT.residual_planes(**kw)
    assert torch.equal(got, want), f"launch {i}"
  assert TT.LAUNCHES["residual"] == launches + 3
  assert TT.PLAIN_RUNS["residual"] == plain


def _residual_calls_on_card(data, device, n_frames=None):
  """Walk a stream on the card holding every residual call against the
  plain version, tolerance 0; returns the calls' plane kinds and the
  frames."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def check(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name == "residual":
      assert torch.equal(got, TT.residual_planes_plain(**kw)), label
      seen.append(label)
    return got

  aus = VVCDecoder(device=device)._split_aus(data)[:n_frames]
  frames = sum(1 for _ in walk_frames(aus, device, check))
  return seen, frames


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_frames", [
    ("full1080", 2), ("ctu128_1080", 2), ("ciip64", None),
    ("ai256x128_10b", None), ("gop720", 3)])
def test_residual_kernel_on_fixture_frames_on_card(cuda, name, n_frames):
  """Every residual call of the fixtures' first frames (the main path;
  CTU-128 with TB-64, ISP, scaling lists and LFNST; CIIP-64; 10 bits)
  equal to the plain version, luma then Cb+Cr on each frame."""
  seen, frames = _residual_calls_on_card(_read(name), cuda, n_frames)
  assert seen == ["luma", "chroma"] * frames


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["isp", "isp-dualtree", "tb64",
                                  "scaling-inter", "ctu128-tools-ra"])
def test_residual_kernel_on_coding_cases_on_card(cuda, case):
  seen, frames = _residual_calls_on_card(_stream(CODING_CASES[case]), cuda)
  assert seen == ["luma", "chroma"] * frames


@pytest.mark.gpu
def test_residual_kernel_on_mono_frame_on_card(cuda):
  """The 4:0:0 stream on the card: one residual launch a frame, equal to
  the plain version."""
  launches = TT.LAUNCHES["residual"]
  seen, frames = _residual_calls_on_card(_stream(ALF_MONO), cuda)
  assert frames and seen == ["luma"] * frames
  assert TT.LAUNCHES["residual"] == launches + frames


@pytest.mark.gpu
@pytest.mark.parametrize("which", sorted(BAD_ROWS) + ["shift"])
def test_residual_kernel_bad_row_raises(cuda, which):
  """A row out of range sets the kernel's error word and the wrapper
  raises, naming it; a dequant shift past 31 (undefined in C) too."""
  kw = _bad_row_call("kind" if which == "shift" else which, cuda)
  if which == "shift":
    b = kw["buckets"][0][(8, 8)]
    b["mat"][BUCKET_ROWS.index("trv"), 1] = 0
    b["mat"][BUCKET_ROWS.index("shift"), 0] = 40
  msg = {"kind": "transform kind", "vpdu": "vpdu", "slid": "scaling-list",
         "place": "leaves the plane", "shift": "dequant shift"}[which]
  with pytest.raises(RuntimeError, match=msg):
    TT.residual_planes(**kw)


@pytest.mark.gpu
def test_residual_kernel_empty_call_on_card(cuda):
  """A call without TUs still launches once and gives zero planes."""
  kw = draw_call("chroma", 8, n=2, device=cuda)
  for comp in kw["buckets"]:
    for wh, b in comp.items():
      comp[wh] = dict(b, mat=b["mat"][:, :0].contiguous(),
                      lv=b["lv"][:0].contiguous(), n=0)
  launches = TT.LAUNCHES["residual"]
  got = TT.residual_planes(**kw)
  assert not got.any() and TT.LAUNCHES["residual"] == launches + 1


@pytest.mark.gpu
def test_residual_build_failure_raises(cuda, tmp_path, monkeypatch):
  from ffmpeg_tpu_torch.utils import build

  (tmp_path / "residual.cu").write_text("this is not CUDA\n")
  monkeypatch.setattr(TT, "_SRC", str(tmp_path / "residual.cu"))
  monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
  monkeypatch.setattr(TT, "_lib", None)
  with pytest.raises(RuntimeError, match="nvcc failed"):
    TT._get_kernel()
