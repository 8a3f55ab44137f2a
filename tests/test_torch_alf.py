"""ALF and CC-ALF: the port's entry point alf_planes (its plain version
on the CPU) against the JAX package's ALF functions as the JAX frame
program's `_alf_pass` composes them, bit for bit over the whole padded
planes (tolerance 0: integer arithmetic), on seeded draws at 8, 10 and
12 bits and CTB 32, 64 and 128 and on the ALF calls of real frames; the
4:0:0 case (one luma call a frame, ALF_MONO); the frame program's ALF
calls; the wrapper's checks; and (on the card) the CUDA kernel
csrc/alf.cu against the plain version.

JAX is imported inside the tests that need it, so that the card, which
has no JAX, collects the `gpu` tests:

  python -m pytest --noconftest -m gpu tests/test_torch_alf.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_decode import (TESTDATA, TOOL_CASES,  # noqa: E402
                               _jax_md5s, _port_md5s, _read, _stream)

from ffmpeg_tpu_torch.models.vvc.inputs import \
    _padded_plane_shapes  # noqa: E402
from ffmpeg_tpu_torch.ops import alf as TA  # noqa: E402

torch.set_num_threads(2)

BDS = (8, 10, 12)
CTB_LOG2S = (5, 6, 7)
DRAWS = [(bd, lg) for bd in BDS for lg in CTB_LOG2S]
KINDS = ("luma", "chroma")
# the tool cases of tests/test_torch_decode.py with ALF on (ALF_STREAMS
# of tests/test_torch_lmcs_alf.py among them)
ALF_CASES = sorted(k for k, v in TOOL_CASES.items() if v.get("alf"))

# 4:0:0 with ALF.  The generator's 4:0:0 ALF streams are mostly not
# legal: it writes the chroma clip indices and the CC-ALF data into the
# APS, and the chroma ALF flags into the slice header, whatever the
# chroma format, so that both packages' parsers refuse them (a fault of
# the JAX package's generator, which stays as it is).  This is the one
# such stream that parses as generated.  Its JAX MD5 is in
# ALF_MONO_JSON; regenerate it with `python tests/test_torch_alf.py`.
ALF_MONO = dict(width=64, height=64, seed=4, qp=30, chroma_format_idc=0,
                alf=True)
ALF_MONO_JSON = os.path.join(TESTDATA, "alf_mono_case.md5.json")


def _draw_id(d):
  return f"{d[0]}bit-ctb{1 << d[1]}"


def _luma(rng, H, W, bd):
  """8x8 patches, each noise or stripes (horizontal, vertical, diagonal)
  at an amplitude from flat to full range, so that the classes and
  transposes vary."""
  yy, xx = np.mgrid[:H, :W]
  pats = np.stack([rng.integers(-1, 2, (H, W)), (yy % 2) * 2 - 1,
                   (xx % 2) * 2 - 1, ((xx + yy) % 2) * 2 - 1,
                   ((xx - yy) % 3) - 1])
  pick = rng.integers(0, len(pats), (H // 8 + 1, W // 8 + 1))
  amp = 1 << rng.integers(0, bd + 1, (H // 8 + 1, W // 8 + 1))
  pick = pick.repeat(8, 0).repeat(8, 1)[:H, :W]
  amp = amp.repeat(8, 0).repeat(8, 1)[:H, :W]
  y = (1 << (bd - 1)) + amp * np.take_along_axis(pats, pick[None], 0)[0] // 2
  return np.clip(y, 0, (1 << bd) - 1).astype(np.int32)


def _tree(rng, bd, cbh, cbw, n_banks=20):
  """An ALF tree in the host's layout and dtypes (inputs._alf_inputs),
  drawn: flags mostly on, chroma alternatives in -1..9 and CC-ALF
  indices in -1..6 (outside 0..7 and 0..4: zero coefficients).  The
  first CTB has everything on with known indices; the last has luma off,
  Cb's alternative 8, Cr's -1, CC indices 5 and 0; the first of the last
  row Cb off and CC indices -1 and 4."""
  ctb = np.zeros((cbh, cbw, 8), np.int8)
  for k in (0, 2, 4):
    ctb[..., k] = rng.random((cbh, cbw)) < 0.8
  ctb[..., 1] = rng.integers(0, n_banks, (cbh, cbw))
  ctb[..., 3] = rng.integers(-1, 10, (cbh, cbw))
  ctb[..., 5] = rng.integers(-1, 10, (cbh, cbw))
  ctb[..., 6:] = rng.integers(-1, 7, (cbh, cbw, 2))
  ctb[0, 0] = (1, n_banks - 1, 1, 3, 1, 7, 2, 4)
  ctb[-1, -1] = (0, 0, 1, 8, 1, -1, 5, 0)
  if cbh > 1:
    ctb[-1, 0, [2, 6, 7]] = (0, -1, 4)

  def clipv(shape):
    return (1 << (bd - rng.choice([0, 3, 5, 7], shape))).astype(np.int16)

  cc = rng.integers(-64, 65, (2, 5, 7)).astype(np.int16)
  cc[:, 0] = 0
  return {"ctb": ctb,
          "banks_coeff": rng.integers(-64, 64, (n_banks, 25, 12)).astype(
              np.int16),
          "banks_clipv": clipv((n_banks, 25, 12)),
          "chroma_coeff": rng.integers(-64, 64, (8, 6)).astype(np.int16),
          "chroma_clipv": clipv((8, 6)),
          "cc_coeff": cc}


def _draw(bd, ctb_log2, seed=None, size=None):
  """numpy padded planes (the padding drawn too), the picture size (not
  a multiple of the CTB unless `size` says so) and an ALF tree."""
  ctb = 1 << ctb_log2
  rng = np.random.default_rng(seed if seed is not None else
                              bd * 100 + ctb_log2)
  H, W = size or (ctb + 40, ctb + 24)
  (Hp, Wp), (Hpc, Wpc) = _padded_plane_shapes(W, H, ctb_log2)
  y = rng.integers(0, 1 << bd, (Hp, Wp)).astype(np.int32)
  y[:H, :W] = _luma(rng, H, W, bd)
  cb, cr = (rng.integers(0, 1 << bd, (Hpc, Wpc)).astype(np.int32)
            for _ in range(2))
  tree = _tree(rng, bd, -(-H // ctb), -(-W // ctb))
  return [y, cb, cr], tree, dict(W=W, H=H, ctb_log2=ctb_log2, bit_depth=bd)


def _mono(draw):
  """A 4:0:0 frame's ALF inputs from a seeded draw: the luma plane alone,
  and a tree whose chroma flags, alternatives and CC-ALF indices are 0,
  as the parser leaves them without chroma."""
  planes, tree, geo = draw
  tree["ctb"][..., 2:] = 0
  return planes[:1], tree, geo


def _call(kind, planes, tree, geo, device="cpu"):
  """The frame program's call of one kind: its alf_planes kwargs."""
  t = [torch.from_numpy(p).to(device) for p in planes]
  a = {k: torch.from_numpy(v).to(device) for k, v in tree.items()}
  if kind == "luma":
    return dict(planes=t[:1], alf=a, chroma=False, **geo)
  return dict(planes=t[1:], alf=a, chroma=True, luma=t[0], **geo)


def _jax_alf(planes, alf, *, chroma, W, H, ctb_log2, bit_depth, luma=None):
  """The JAX package's ALF functions on the same inputs (numpy), composed
  as the JAX frame program's `_alf_pass` composes them
  (ffmpeg_tpu/models/vvc/pipeline.py `_alf_pass`) for the planes of one
  alf_planes call: the luma plane, or Cb and Cr with the pre-ALF luma.
  Returns (nch, Hp, Wp) numpy."""
  import jax.numpy as jnp

  from ffmpeg_tpu.ops.alf import (TRANSPOSE_IDX, alf_classify,
                                  alf_filter_cc, alf_filter_chroma,
                                  alf_filter_luma)

  a = {k: jnp.asarray(np.asarray(v)) for k, v in alf.items()}
  planes = [jnp.asarray(np.asarray(p)) for p in planes]
  ctb_sz, bd = 1 << ctb_log2, bit_depth
  if not chroma:
    ly0 = planes[0][:H, :W]
    cls, tr = alf_classify(ly0, ctb_sz, bd)
    cb_by = (jnp.arange(H // 4) * 4) >> ctb_log2
    cb_bx = (jnp.arange(W // 4) * 4) >> ctb_log2
    ctb_blk = a["ctb"][cb_by[:, None], cb_bx[None, :]]
    bank = ctb_blk[..., 1]
    perm = jnp.asarray(TRANSPOSE_IDX)[tr]
    coeff12 = jnp.take_along_axis(a["banks_coeff"][bank, cls], perm, axis=-1)
    clip12 = jnp.take_along_axis(a["banks_clipv"][bank, cls], perm, axis=-1)
    ly1 = alf_filter_luma(ly0, coeff12, clip12, ctb_sz, ctb_blk[..., 0] > 0,
                          bd)
    return np.asarray(planes[0].at[:H, :W].set(ly1))[None]
  ly0 = jnp.asarray(np.asarray(luma))[:H, :W]
  Hc, Wc = H >> 1, W >> 1
  yc = jnp.arange(Hc) >> (ctb_log2 - 1)
  xc = jnp.arange(Wc) >> (ctb_log2 - 1)
  out = []
  for c, plane in zip((1, 2), planes):
    pc = plane[:Hc, :Wc]
    flag = a["ctb"][..., 2 * c][yc[:, None], xc[None, :]]
    alt = a["ctb"][..., 2 * c + 1][yc[:, None], xc[None, :]]
    coeff6 = jnp.zeros((Hc, Wc, 6), jnp.int32)
    clip6 = jnp.zeros((Hc, Wc, 6), jnp.int32)
    for al in range(8):
      sel = (alt == al)[..., None]
      coeff6 = jnp.where(sel, a["chroma_coeff"][al], coeff6)
      clip6 = jnp.where(sel, a["chroma_clipv"][al], clip6)
    pc = alf_filter_chroma(pc, coeff6, clip6, ctb_sz >> 1, flag > 0, bd)
    idc = a["ctb"][..., 5 + c][yc[:, None], xc[None, :]]
    cc7 = jnp.zeros((Hc, Wc, 7), jnp.int32)
    for k in range(5):
      cc7 = jnp.where((idc == k)[..., None], a["cc_coeff"][c - 1, k], cc7)
    pc = alf_filter_cc(pc, ly0, cc7, ctb_sz, idc > 0, bd)
    out.append(np.asarray(plane.at[:Hc, :Wc].set(pc)))
  return np.stack(out)


def _padding_kept(got, kw):
  """The samples outside the cropped picture are the input's."""
  ss = 1 if kw["chroma"] else 0
  H, W = kw["H"] >> ss, kw["W"] >> ss
  for g, p in zip(got, kw["planes"]):
    assert torch.equal(g[H:], p[H:]) and torch.equal(g[:, W:], p[:, W:])


# ---- the plain entry against JAX -----------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("draw", DRAWS, ids=_draw_id)
def test_alf_planes_plain_matches_jax(draw, kind):
  """alf_planes on CPU tensors (the plain version) against the JAX
  composition on seeded draws whose picture is not whole CTBs, with
  flags off, unknown chroma alternatives and CC-ALF indices: the whole
  padded planes equal, the padding as it was, the picture filtered."""
  planes, tree, geo = _draw(*draw)
  kw = _call(kind, planes, tree, geo)
  plain = TA.PLAIN_RUNS["alf"]
  got = TA.alf_planes(**kw)
  assert TA.PLAIN_RUNS["alf"] == plain + 1
  want = _jax_alf(**kw)
  np.testing.assert_array_equal(got.numpy(), want)
  _padding_kept(got, kw)
  assert not torch.equal(got, torch.stack(kw["planes"]))


@pytest.mark.parametrize("case", ALF_CASES)
def test_alf_planes_plain_on_case_frames(case):
  """Every ALF call of an ALF case's frames (walked on the CPU through the
  frame program, with the real ALF tree and the real pre-ALF planes)
  against the JAX composition: luma, then Cb and Cr, on every frame."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def check(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name == "alf":
      np.testing.assert_array_equal(got.numpy(), _jax_alf(**kw),
                                    err_msg=label)
      _padding_kept(got, kw)
      seen.append(label)
    return got

  aus = VVCDecoder(device="cpu")._split_aus(_stream(TOOL_CASES[case]))
  frames = sum(1 for _ in walk_frames(aus, "cpu", check))
  assert seen == ["luma", "chroma"] * frames


@pytest.mark.parametrize("bd", BDS)
def test_alf_planes_plain_matches_jax_mono(bd):
  """A seeded 4:0:0 draw: the luma call alone (chroma=False, no luma
  plane), against the JAX composition."""
  planes, tree, geo = _mono(_draw(bd, 6, seed=bd + 400))
  kw = _call("luma", planes, tree, geo)
  got = TA.alf_planes(**kw)
  np.testing.assert_array_equal(got.numpy(), _jax_alf(**kw))
  _padding_kept(got, kw)
  assert not torch.equal(got, torch.stack(kw["planes"]))


def _mono_alf_calls(device, check):
  """Walk ALF_MONO's frames through the frame program on `device` with
  `check` on its ALF calls; returns every call's (kernel, plane kind)
  per frame."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen, frames = [], []

  def hook(name, label, kw):
    seen.append((name, label))
    got = KERNELS[name][0](**kw)
    if name == "alf":
      check(got, kw)
    return got

  aus = VVCDecoder(device=device)._split_aus(_stream(ALF_MONO))
  for fs, h in walk_frames(aus, device, hook):
    assert fs.chroma_format_idc == 0 and "alf" in h
    frames.append(list(seen))
    seen.clear()
  return frames


def test_alf_mono_case_matches_jax():
  """ALF_MONO decodes on the CPU to the committed JAX MD5s."""
  import json

  with open(ALF_MONO_JSON) as f:
    want = json.load(f)["alf-mono"]
  assert want["config"] == ALF_MONO
  assert _port_md5s(_stream(ALF_MONO)) == want["md5"]


def test_alf_planes_plain_on_mono_frame():
  """ALF_MONO's frames make one ALF call each (luma; no chroma call)
  and one residual call, and the ALF call equals the JAX composition."""
  def check(got, kw):
    assert not kw["chroma"] and kw.get("luma") is None
    np.testing.assert_array_equal(got.numpy(), _jax_alf(**kw))
    _padding_kept(got, kw)

  frames = _mono_alf_calls("cpu", check)
  assert frames
  for calls in frames:
    assert [c for c in calls if c[0] == "alf"] == [("alf", "luma")]
    assert [c for c in calls if c[0] == "residual"] == [("residual", "luma")]


def test_frame_program_alf_calls_full1080():
  """The main path's frames walked on the CPU: on each frame with ALF
  on, the alf kernel's calls come last, luma then Cb and Cr, and the
  chroma call's luma is the pre-ALF plane the luma call read."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def record(name, label, kw):
    seen.append((name, label))
    out = KERNELS[name][0](**kw)
    if name == "alf" and label == "luma":
      record.pre = kw["planes"][0].clone()
    elif name == "alf":
      assert torch.equal(kw["luma"], record.pre)
    return out

  aus = VVCDecoder(device="cpu")._split_aus(_read("full1080"))
  n_alf = 0
  for fs, h in walk_frames(aus, "cpu", record):
    calls = [c for c in seen if c[0] == "alf"]
    if "alf" in h:
      n_alf += 1
      assert calls == [("alf", "luma"), ("alf", "chroma")]
      assert seen[-2:] == calls
    else:
      assert calls == []
    seen.clear()
  assert n_alf == 5


@pytest.mark.parametrize("hooked", [False, True], ids=["session", "hook"])
def test_frame_program_asks_alf_overlap_without_hook(monkeypatch, hooked):
  """Launching the kernels itself (the session), the frame program asks
  every alf chroma call to overlap the luma call just before it
  (overlap=True) and no luma call; through a call hook, which may queue
  work between the two calls, it never asks."""
  from ffmpeg_tpu_torch.models.vvc import pipeline as P
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  wrapper, plain = P.KERNELS["alf"]
  asked = []

  def spy(**kw):
    asked.append((kw["chroma"], kw.get("overlap")))
    return wrapper(**kw)

  monkeypatch.setitem(P.KERNELS, "alf", (spy, plain))
  data = _stream(TOOL_CASES["alf-inter"])
  if hooked:
    aus = VVCDecoder(device="cpu")._split_aus(data)
    frames = sum(1 for _ in P.walk_frames(
        aus, "cpu", lambda name, label, kw: P.KERNELS[name][0](**kw)))
  else:
    frames = len(_port_md5s(data))
  n = sum(1 for chroma, _ in asked if not chroma)
  assert frames == 4 and n > 0
  want = [(False, None), (True, None if hooked else True)] * n
  assert asked == want


# ---- the wrapper's checks ---------------------------------------------------

BAD = ("two-luma-planes", "one-chroma-plane", "chroma-without-luma",
       "luma-with-luma", "int32-ctb-grid", "grid-too-small", "int32-banks",
       "plane-strided", "picture-past-plane", "odd-width", "ctb-16",
       "meta-device")


def _meta(t):
  return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("bad", BAD)
def test_alf_planes_refuses(bad):
  """alf_planes checks its inputs on every device and raises on what the
  kernel does not take, and on a device that is neither CUDA nor the CPU
  (nothing falls back to the plain version)."""
  planes, tree, geo = _draw(8, 5)
  kind = "chroma" if bad in ("one-chroma-plane", "chroma-without-luma") \
      else "luma"
  kw = _call(kind, planes, tree, geo)
  a = kw["alf"]
  if bad == "two-luma-planes":
    kw["planes"] = kw["planes"] * 2
  elif bad == "one-chroma-plane":
    kw["planes"] = kw["planes"][:1]
  elif bad == "chroma-without-luma":
    kw["luma"] = None
  elif bad == "luma-with-luma":
    kw["luma"] = kw["planes"][0]
  elif bad == "int32-ctb-grid":
    a["ctb"] = a["ctb"].int()
  elif bad == "grid-too-small":
    a["ctb"] = a["ctb"][:1].contiguous()
  elif bad == "int32-banks":
    a["banks_coeff"] = a["banks_coeff"].int()
  elif bad == "plane-strided":
    kw["planes"] = [kw["planes"][0].T.contiguous().T]
  elif bad == "picture-past-plane":
    kw["H"] = kw["planes"][0].shape[0] + 8
  elif bad == "odd-width":
    kw["W"] -= 2
  elif bad == "ctb-16":
    kw["ctb_log2"] = 4
  else:
    kw["planes"] = [_meta(p) for p in kw["planes"]]
    kw["alf"] = {k: _meta(v) for k, v in a.items()}
  with pytest.raises(ValueError):
    TA.alf_planes(**kw)


# ---- on the card -----------------------------------------------------------

# the draws above, one at 1920x1080 for each CTB size and kind, and one
# of 12-bit full-range noise (its blocks' activity products pass 31 bits)
GPU_DRAWS = [(bd, lg, None) for bd, lg in DRAWS] + [
    (8, lg, (1080, 1920)) for lg in CTB_LOG2S] + [(12, 6, "noise")]


def _gpu_id(d):
  return _draw_id(d) + ("" if d[2] is None else
                        "-noise" if d[2] == "noise" else "-1080p")


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_alf.py)")
  return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("draw", GPU_DRAWS, ids=_gpu_id)
def test_alf_kernel_matches_plain_on_card(cuda, draw, kind):
  """The kernel against the plain version on the same card tensors,
  tolerance 0, over the whole padded planes: 3 launches, each counted
  once, no plain run by the wrapper, the inputs left as they were."""
  bd, lg, size = draw
  planes, tree, geo = _draw(bd, lg, size=None if size == "noise" else size)
  if size == "noise":
    H, W = geo["H"], geo["W"]
    planes[0][:H, :W] = np.random.default_rng(3).integers(
        0, 1 << bd, (H, W))
  kw = _call(kind, planes, tree, geo, cuda)
  want = TA.alf_planes_plain(**kw)
  launches, plain = TA.LAUNCHES["alf"], TA.PLAIN_RUNS["alf"]
  for i in range(3):
    got = TA.alf_planes(**kw)
    assert torch.equal(got, want), f"launch {i}"
  torch.cuda.synchronize()
  assert TA.LAUNCHES["alf"] == launches + 3
  assert TA.PLAIN_RUNS["alf"] == plain
  src = planes[:1] if kind == "luma" else planes[1:]
  assert all(torch.equal(p.cpu(), torch.from_numpy(a))
             for p, a in zip(kw["planes"], src))


def _alf_calls_on_card(data, device, n_frames=None):
  """Walk a stream on the card holding every ALF call against the plain
  version, tolerance 0; returns the calls' plane kinds."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def check(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name == "alf":
      assert torch.equal(got, TA.alf_planes_plain(**kw)), label
      seen.append(label)
    return got

  aus = VVCDecoder(device=device)._split_aus(data)[:n_frames]
  frames = sum(1 for _ in walk_frames(aus, device, check))
  return seen, frames


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["full1080", "ctu128_1080", "gop720"])
def test_alf_kernel_on_fixture_frames_on_card(cuda, name):
  """Every ALF call of the ALF fixtures' frames (the main path, CTU-128,
  the GOP-4 pyramid) equal to the plain version, 2 per frame."""
  seen, frames = _alf_calls_on_card(_read(name), cuda)
  assert seen == ["luma", "chroma"] * frames


@pytest.mark.gpu
@pytest.mark.parametrize("case", ALF_CASES)
def test_alf_kernel_on_case_frames_on_card(cuda, case):
  seen, frames = _alf_calls_on_card(_stream(TOOL_CASES[case]), cuda)
  assert seen == ["luma", "chroma"] * frames


@pytest.mark.gpu
@pytest.mark.parametrize("bd", BDS)
def test_alf_kernel_mono_on_card(cuda, bd):
  """The 4:0:0 path on the card: the seeded 4:0:0 draw and ALF_MONO's
  frames, one launch per luma call, equal to the plain version."""
  planes, tree, geo = _mono(_draw(bd, 6, seed=bd + 400))
  kw = _call("luma", planes, tree, geo, cuda)
  launches = TA.LAUNCHES["alf"]
  assert torch.equal(TA.alf_planes(**kw), TA.alf_planes_plain(**kw))
  assert TA.LAUNCHES["alf"] == launches + 1

  def check(got, kw):
    assert torch.equal(got, TA.alf_planes_plain(**kw))

  launches = TA.LAUNCHES["alf"]
  frames = _mono_alf_calls(cuda, check)
  assert frames and TA.LAUNCHES["alf"] == launches + len(frames)


@pytest.mark.gpu
def test_alf_launch_failure_raises(cuda):
  """A launch the kernel refuses (a CTB grid that does not cover the
  picture, past the wrapper's checks) raises."""
  planes, tree, geo = _draw(8, 5)
  kw = _call("luma", planes, tree, geo, cuda)
  kw["alf"]["ctb"] = kw["alf"]["ctb"][:1].contiguous()
  with pytest.raises(RuntimeError, match="alf kernel launch failed"):
    TA._alf_cuda(kw["planes"], kw["alf"], chroma=False, W=geo["W"],
                 H=geo["H"], ctb_log2=5, bit_depth=8, luma=None)


@pytest.mark.gpu
def test_alf_build_failure_raises(cuda, tmp_path, monkeypatch):
  from ffmpeg_tpu_torch.utils import build

  (tmp_path / "alf.cu").write_text("this is not CUDA\n")
  monkeypatch.setattr(TA, "_SRC", str(tmp_path / "alf.cu"))
  monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
  monkeypatch.setattr(TA, "_lib", None)
  with pytest.raises(RuntimeError, match="nvcc failed"):
    TA._get_kernel()


def _misaligned(t):
  """t's values in a contiguous tensor whose storage starts 4 bytes past
  a 16-byte boundary (the kernel's 4-byte copy path)."""
  buf = torch.empty(t.numel() + 3, dtype=t.dtype, device=t.device)
  o = (4 - buf.data_ptr() % 16) % 16 // t.element_size()
  out = buf[o:o + t.numel()].view(t.shape)
  out.copy_(t)
  assert out.is_contiguous() and out.data_ptr() % 16 == 4
  return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("draw", [(8, 5), (10, 6), (12, 7)], ids=_draw_id)
def test_alf_kernel_misaligned_planes_on_card(cuda, draw, kind):
  """Planes (and for chroma the pre-ALF luma) whose base is 4 bytes off
  16-byte alignment: the kernel copies them 4 bytes at a time, and the
  result equals the plain version's on the aligned planes."""
  kw = _call(kind, *_draw(*draw), cuda)
  want = TA.alf_planes_plain(**kw)
  mis = dict(kw, planes=[_misaligned(p) for p in kw["planes"]])
  if kind == "chroma":
    mis["luma"] = _misaligned(kw["luma"])
  assert torch.equal(TA.alf_planes(**mis), want)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("lg", CTB_LOG2S)
def test_alf_kernel_band_shapes_on_card(cuda, T, lg):
  """The band planes parallel/spatial.py alf_luma_tiled passes for a
  1920x1080 luma plane in T bands: each band with a CTB row of halo above
  and below, no padding (Wp = W = 1920, Hp = H), its ALF tree cut to the
  band; the kernel equal to the plain version on each."""
  planes, tree, geo = _draw(8, lg, size=(1080, 1920))
  ctb = 1 << lg
  H, W = geo["H"], geo["W"]
  rows = -(-H // (T * ctb)) * ctb
  ly = torch.from_numpy(planes[0][:H, :W])
  ly = torch.cat([ly, ly[-1:].expand(rows * T - H, W)])
  for k in range(T):
    lo, hi = max(0, k * rows - ctb), min(rows * T, (k + 1) * rows + ctb)
    band = ly[lo:hi].contiguous()
    g = tree["ctb"][lo // ctb:-(-hi // ctb)]
    g = np.concatenate([g, np.zeros_like(g[:1]).repeat(
        -(-band.shape[0] // ctb) - len(g), 0)])
    kw = _call("luma", [band.numpy()], dict(tree, ctb=g),
               dict(geo, H=band.shape[0]), cuda)
    assert torch.equal(TA.alf_planes(**kw), TA.alf_planes_plain(**kw)), k


@pytest.mark.gpu
def test_alf_kernel_overlapped_pairs_on_card(cuda):
  """20 luma and chroma call pairs queued back to back on one stream, as
  the frame program queues them, the chroma call asking to overlap the
  luma launch (overlap=True): 20 overlapped launches, each output equal
  to the plain version; then the same without the request: none."""
  from ffmpeg_tpu_torch.tools.deblock_tiles import b_frame_calls

  calls = dict(b_frame_calls(os.path.join(TESTDATA, "full1080.vvc"), "alf"))
  kl, kc = calls["luma"], calls["chroma"]
  assert kc["luma"] is kl["planes"][0]
  want = [TA.alf_planes_plain(**kl), TA.alf_planes_plain(**kc)]
  for overlap in (True, False):
    torch.cuda.synchronize()
    TA.OVERLAPS["alf"] = 0
    outs = [TA.alf_planes(**kw) for _ in range(20)
            for kw in (kl, dict(kc, overlap=overlap))]
    torch.cuda.synchronize()
    assert TA.OVERLAPS["alf"] == (20 if overlap else 0)
    bad = [i for i, o in enumerate(outs) if not torch.equal(o, want[i % 2])]
    assert not bad, f"calls {bad} differ"


@pytest.mark.gpu
def test_alf_session_overlaps_on_card(cuda):
  """The session (no call hook) decodes full1080 to its committed MD5s
  with 2 alf launches a frame, each frame's chroma launch overlapping
  its luma launch: a lost overlap fails here."""
  import json

  with open(os.path.join(TESTDATA, "full1080.md5.json")) as f:
    want = json.load(f)["md5"]
  TA.LAUNCHES["alf"] = TA.OVERLAPS["alf"] = 0
  assert _port_md5s(_read("full1080"), device="cuda") == want
  assert (TA.LAUNCHES["alf"], TA.OVERLAPS["alf"]) == (10, 5)


@pytest.mark.gpu
def test_alf_wrapper_returns_with_card_busy(cuda):
  """The wrapper queues its launch and returns: the card is still busy
  with the work queued before it when the call comes back."""
  import time

  kw = _call("luma", *_draw(8, 6, size=(1080, 1920)), cuda)
  want = TA.alf_planes_plain(**kw)
  TA.alf_planes(**kw)                # the build and the first launch
  torch.cuda.synchronize()
  torch.cuda._sleep(400_000_000)     # cycles: about 0.2 s
  t0 = time.perf_counter()
  got = TA.alf_planes(**kw)
  after = torch.cuda.Event()
  after.record()
  host_s = time.perf_counter() - t0
  assert not after.query(), f"the call waited ({host_s} s)"
  torch.cuda.synchronize()
  assert torch.equal(got, want)


@pytest.mark.slow
def test_alf_mono_case_jax_live():
  """The committed MD5s are the JAX package's decode of ALF_MONO."""
  import json

  with open(ALF_MONO_JSON) as f:
    assert _jax_md5s(_stream(ALF_MONO)) == json.load(f)["alf-mono"]["md5"]


def main():
  """Regenerate ALF_MONO_JSON with the JAX package's decoder."""
  import json

  import jax

  jax.config.update("jax_platforms", "cpu")
  out = {"alf-mono": {"config": ALF_MONO,
                      "md5": _jax_md5s(_stream(ALF_MONO))}}
  print(out, flush=True)
  with open(ALF_MONO_JSON, "w") as f:
    json.dump(out, f, indent=1)
    f.write("\n")


if __name__ == "__main__":
  main()
