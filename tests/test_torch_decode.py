"""End to end: the PyTorch port decodes intra and P/B streams to the JAX
package's frame MD5s, and refuses what its slices do not cover.

The JAX MD5s of the small cases live in
ffmpeg_tpu_torch/testdata/intra_cases.md5.json and inter_cases.md5.json
(a JAX decode per case costs a minute of XLA compile on the CPU);
regenerate both with

  python tests/test_torch_decode.py

The `slow` tests rerun the JAX side live; the `gpu` tests need a CUDA
card and skip here.  On the card, which has no JAX (so the JAX-importing
conftest stays out):

  python -m pytest --noconftest -m gpu tests/test_torch_decode.py
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TESTDATA = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata")
CASES_JSON = os.path.join(TESTDATA, "intra_cases.md5.json")
INTER_JSON = os.path.join(TESTDATA, "inter_cases.md5.json")

torch.set_num_threads(2)

# intra cases of tests/test_conformance.py (same ids and configs)
INTRA_CASES = {
    "64x64": dict(width=64, height=64, seed=101, qp=32),
    "96x96-dense": dict(width=96, height=96, seed=103, qp=45,
                        coeff_density=0.4),
    "deblock-unaligned": dict(width=72, height=40, seed=105, qp=24,
                              deblock=True, n_frames=2),
    "dualtree-cclm-mip-mrl": dict(width=128, height=96, seed=3202, qp=28,
                                  dual_tree=True, cclm=True, mip=True,
                                  mrl=True, deblock=True, sao=True),
    "bdpcm-10bit": dict(width=64, height=64, seed=903, qp=33, bdpcm=True,
                        ts_max_size=16, bit_depth=10, sao=True),
    "cclm-mip-ctu64-10bit": dict(width=128, height=128, seed=2703, qp=30,
                                 cclm=True, mip=True, ctu_log2=6,
                                 max_bt_size=64, min_qt_size=16,
                                 bit_depth=10),
    "12bit-filters": dict(width=96, height=64, seed=3911, qp=34,
                          bit_depth=12, deblock=True, sao=True),
    "mono-filters": dict(width=96, height=64, seed=3902, qp=28,
                         chroma_format_idc=0, deblock=True, sao=True),
    "lfnst-full": dict(width=128, height=64, seed=1003, qp=28, lfnst=True,
                       mts=True, joint_cbcr=True, cu_qp_delta=True,
                       deblock=True, sao=True),
    "transform-skip-dense": dict(width=64, height=64, seed=802, qp=40,
                                 transform_skip=True, coeff_density=0.5,
                                 max_level=30),
    "tiles-filters": dict(width=128, height=96, seed=3002, qp=28,
                          tile_cols=(1, 2, 1), tile_rows=(3,), deblock=True,
                          sao=True),
    "wpp-intra-tools": dict(width=128, height=96, seed=3102, qp=28, wpp=True,
                            deblock=True, sao=True, mip=True, cclm=True),
    "crop": dict(width=96, height=64, seed=3301, qp=30,
                 conf_window=(0, 2, 0, 4), deblock=True, sao=True),
}

# P/B cases of tests/test_conformance.py (same ids and configs); they
# cover every inter tool of the slice
INTER_CASES = {
    "inter-p": dict(width=128, height=96, seed=106, qp=28, inter=True,
                    n_frames=4),
    "inter-p-deblock": dict(width=96, height=64, seed=107, qp=35, inter=True,
                            deblock=True, n_frames=4, max_mv=300),
    "inter-b": dict(width=96, height=64, seed=108, qp=30, inter=True,
                    b_slices=True, deblock=True, n_frames=4, max_mv=200),
    "10bit-sao-full": dict(width=96, height=64, seed=109, qp=32, bit_depth=10,
                           sao=True, deblock=True, inter=True, b_slices=True,
                           n_frames=3),
    "ra-pyramid": dict(width=96, height=64, seed=1101, qp=30, inter=True,
                       b_slices=True, ra=True, n_frames=9),
    "ra-full": dict(width=96, height=96, seed=1102, qp=28, inter=True,
                    b_slices=True, ra=True, n_frames=9, deblock=True,
                    sao=True, max_mv=200),
    "tmvp-ra": dict(width=96, height=96, seed=1203, qp=30, inter=True,
                    b_slices=True, ra=True, tmvp=True, n_frames=9, sao=True),
    "mmvd": dict(width=96, height=64, seed=1701, qp=28, inter=True,
                 n_frames=3, mmvd=True),
    "amvr": dict(width=96, height=64, seed=1703, qp=28, inter=True,
                 b_slices=True, n_frames=3, amvr=True, max_mv=120),
    "bcw": dict(width=96, height=96, seed=1704, qp=28, inter=True,
                b_slices=True, n_frames=3, bcw=True, min_qt_size=16),
    "ciip-deblock": dict(width=96, height=96, seed=1802, qp=28, inter=True,
                         b_slices=True, n_frames=3, ciip=True, deblock=True,
                         sao=True),
    "wp-b": dict(width=96, height=96, seed=2002, qp=28, inter=True,
                 b_slices=True, n_frames=3, weighted_pred=True, deblock=True,
                 sao=True),
    "sbtmvp-filters": dict(width=96, height=96, seed=2105, qp=28, inter=True,
                           b_slices=True, n_frames=4, sbtmvp=True,
                           deblock=True, sao=True, max_mv=220),
    "affine": dict(width=96, height=64, seed=2201, qp=28, inter=True,
                   n_frames=3, affine=True),
    "prof": dict(width=96, height=96, seed=2302, qp=28, inter=True,
                 b_slices=True, n_frames=4, affine=True, prof=True,
                 deblock=True, sao=True),
    "bdof-affine-ra": dict(width=96, height=96, seed=2405, qp=28, inter=True,
                           b_slices=True, ra=True, n_frames=9, bdof=True,
                           affine=True, prof=True, sbtmvp=True, deblock=True,
                           sao=True, max_mv=90),
    "gpm-filters": dict(width=96, height=96, seed=1902, qp=28, inter=True,
                        b_slices=True, n_frames=3, gpm=True, deblock=True,
                        sao=True),
    "tiles-inter": dict(width=96, height=96, seed=3003, qp=28,
                        tile_cols=(2, 1), tile_rows=(2, 1), inter=True,
                        b_slices=True, n_frames=4, deblock=True, sao=True,
                        tmvp=True),
    "wpp-inter": dict(width=96, height=96, seed=3103, qp=28, wpp=True,
                      inter=True, b_slices=True, n_frames=4, deblock=True,
                      sao=True, tmvp=True),
    "cra-rasl": dict(width=96, height=64, seed=3601, qp=30, inter=True,
                     b_slices=True, n_frames=8, cra=True, deblock=True,
                     sao=True),
    "gdr": dict(width=96, height=64, seed=3602, qp=30, inter=True, n_frames=7,
                gdr=True, deblock=True),
    "ltr-ra": dict(width=96, height=64, seed=3502, qp=28, inter=True,
                   b_slices=True, ra=True, n_frames=9, ltr=True, deblock=True,
                   sao=True),
    "crop-ra": dict(width=96, height=96, seed=3302, qp=28,
                    conf_window=(0, 4, 0, 2), inter=True, b_slices=True,
                    ra=True, n_frames=5, tmvp=True, deblock=True, sao=True),
    "mono-inter": dict(width=96, height=64, seed=3903, qp=32,
                       chroma_format_idc=0, inter=True, b_slices=True,
                       n_frames=4, deblock=True, max_mv=48),
    "12bit-inter": dict(width=96, height=64, seed=3912, qp=34, bit_depth=12,
                        inter=True, b_slices=True, n_frames=3, deblock=True,
                        sao=True, max_mv=48),
    "wraparound-ra": dict(width=96, height=64, seed=4102, qp=32,
                          wraparound=True, inter=True, b_slices=True, ra=True,
                          tmvp=True, n_frames=5, max_mv=400, deblock=True,
                          sao=True),
}

# one stream per refused feature: (config, what the refusal names)
REFUSED = {
    "dmvr": (dict(width=96, height=64, seed=2501, qp=28, inter=True,
                  b_slices=True, ra=True, n_frames=9, dmvr=True, max_mv=90),
             "DMVR"),
    "isp": (dict(width=96, height=96, seed=3501, qp=30, isp=True,
                 split_prob=0.8), "ISP"),
    "tb64": (dict(width=128, height=128, seed=3701, qp=30, ctu_log2=6,
                  tb64=True, min_qt_size=64, max_mtt_depth=0,
                  split_prob=0.3), "TB-64"),
    "scaling-lists": (dict(width=96, height=96, seed=7002, qp=28,
                           scaling_lists=True, mts=True, joint_cbcr=True),
                      "scaling lists"),
    "lmcs": (dict(width=96, height=96, seed=1501, qp=30, lmcs=True),
             "LMCS"),
    "alf": (dict(width=96, height=96, seed=1601, qp=30, alf=True), "ALF"),
}


# a lost access unit: the inter-p stream without its second AU, so the P
# frames that list it decode against a synthesized mid-gray reference
# (errors="contain" in both packages)
MISSING_REF = dict(base="inter-p", drop_au=1)


def _stream(kw) -> bytes:
  from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream

  return encode_stream(EncoderConfig(**kw))[0]


def _missing_ref_stream():
  """(the cut stream, its number of access units)."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  aus = VVCDecoder(device="cpu")._split_aus(
      _stream(INTER_CASES[MISSING_REF["base"]]))
  drop = MISSING_REF["drop_au"]
  return b"".join(au for i, (_, _, au) in enumerate(aus) if i != drop), \
      len(aus) - 1


def _port_md5s(data, device="cpu", errors="raise"):
  from ffmpeg_tpu_torch.models.vvc.decoder import DecoderConfig, VVCDecoder

  dec = VVCDecoder(device=device, config=DecoderConfig(errors=errors))
  return [f.md5() for f in dec.decode(data)]


def _jax_md5s(data, errors="contain"):
  from ffmpeg_tpu.models.vvc.decoder import DecoderConfig, VVCDecoder

  dec = VVCDecoder(config=DecoderConfig(errors=errors))
  return [f.md5() for f in dec.decode(data)]


def _fixture_md5s(name):
  with open(os.path.join(TESTDATA, f"{name}.md5.json")) as f:
    return json.load(f)["md5"]


def _read(name):
  with open(os.path.join(TESTDATA, f"{name}.vvc"), "rb") as f:
    return f.read()


@pytest.mark.parametrize("case", sorted(INTRA_CASES))
def test_intra_case_matches_jax(case):
  with open(CASES_JSON) as f:
    want = json.load(f)[case]
  assert want["config"] == json.loads(json.dumps(INTRA_CASES[case]))
  assert _port_md5s(_stream(INTRA_CASES[case])) == want["md5"]


@pytest.mark.parametrize("case", sorted(INTER_CASES))
def test_inter_case_matches_jax(case):
  with open(INTER_JSON) as f:
    want = json.load(f)[case]
  assert want["config"] == json.loads(json.dumps(INTER_CASES[case]))
  assert _port_md5s(_stream(INTER_CASES[case])) == want["md5"]


def test_fixture_10bit_matches_jax():
  assert _port_md5s(_read("ai256x128_10b")) == _fixture_md5s("ai256x128_10b")


def test_cli_cpu(capsys):
  from ffmpeg_tpu_torch.tools.decode import main

  path = os.path.join(TESTDATA, "ai256x128_10b.vvc")
  assert main([path, "--device", "cpu", "--strict"]) == 0
  lines = capsys.readouterr().out.strip().splitlines()
  assert [ln.split(", ")[-1] for ln in lines] == _fixture_md5s(
      "ai256x128_10b")
  assert lines[0].startswith("0, 0, 256x128, ")


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_stream_raises(case):
  """Outside the slice: NotImplementedError naming the ROADMAP item,
  even in the default error-containing mode — never a wrong frame."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  kw, what = REFUSED[case]
  dec = VVCDecoder(device="cpu")
  with pytest.raises(NotImplementedError, match="ROADMAP") as e:
    list(dec.decode(_stream(kw)))
  assert what in str(e.value)


def test_ciip_tile_index_checked_by_recon():
  """A CIIP row whose MC tile index lies outside the MC batch raises in
  the recon entry, before any device work."""
  from ffmpeg_tpu_torch.models.vvc.convert import _inter, _intra
  from ffmpeg_tpu_torch.models.vvc.inputs import INTER_KEYS, INTRA_KEYS
  from ffmpeg_tpu_torch.ops.recon import recon_plane

  rows = {k: np.zeros(33, np.int32) for k in (*INTRA_KEYS, "ipos")}
  rows["w"][0] = rows["h"][0] = 8
  rows["ciipw"][0] = 2
  rows["ipos"][0] = 1
  rows["ioff"] = np.array([0], np.int32)
  rows["iend"] = np.array([1], np.int32)
  intra = _intra(rows, 1, "cpu")
  batch = {k: np.zeros(1, np.int32) for k in INTER_KEYS}
  batch["gwt"], batch["gslot"] = np.zeros((1, 32, 32)), np.zeros(1)
  inter = _inter(batch, 0, "cpu")
  tiles = torch.zeros((1, 1, 32, 32), dtype=torch.int32)
  with pytest.raises(ValueError, match="CIIP tile index"):
    recon_plane(torch.zeros((1, 64, 64), dtype=torch.int32), intra, 1, inter,
                tiles, maxs=32, is_chroma=False, bit_depth=8)


def test_frame_program_kernel_calls():
  """walk_frames runs the frame program's kernel calls through its hook,
  in order: an I frame's recon of luma and chroma; a P frame's
  inter_pred of luma and chroma first."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def record(name, label, kw):
    seen.append((name, label))
    return KERNELS[name][0](**kw)

  aus = VVCDecoder(device="cpu")._split_aus(_stream(INTER_CASES["inter-p"]))
  frames = []
  for fs, _ in walk_frames(aus, "cpu", record):
    frames.append((fs.slice_type, list(seen)))
    seen.clear()
  recons = [("recon", "luma"), ("recon", "chroma")]
  assert frames[0] == (2, recons)
  assert len(frames) == len(aus)
  for slice_type, calls in frames[1:]:
    assert slice_type == 1
    assert calls == [("inter_pred", "luma"), ("inter_pred", "chroma"),
                     *recons]


@pytest.mark.parametrize("errors", ["raise", "contain"])
def test_missing_reference(errors):
  """A P frame whose reference was lost: errors="raise" raises, the
  default "contain" decodes it against a synthesized mid-gray plane, to
  the JAX package's frames."""
  cut, n_aus = _missing_ref_stream()
  if errors == "raise":
    with pytest.raises(RuntimeError, match="missing reference"):
      _port_md5s(cut, errors=errors)
    return
  with open(INTER_JSON) as f:
    want = json.load(f)["missing-ref"]
  assert want["config"] == MISSING_REF
  got = _port_md5s(cut, errors=errors)
  assert len(got) == n_aus
  assert got == want["md5"]


def test_default_device_is_cuda():
  """Entry points run on the card unless told otherwise; without a card
  they refuse rather than fall back to the CPU."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable")
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder, decode_file
  from ffmpeg_tpu_torch.tools.decode import main

  path = os.path.join(TESTDATA, "ai256x128_10b.vvc")
  with pytest.raises(RuntimeError, match="cuda"):
    VVCDecoder()
  with pytest.raises(RuntimeError, match="cuda"):
    next(decode_file(path))
  with pytest.raises(RuntimeError, match="cuda"):
    main([path])


def test_frame_planes_layout():
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  frames = list(VVCDecoder(device="cpu").decode(_read("ai256x128_10b")))
  y, cb, cr = frames[0].planes
  assert y.shape == (128, 256) and cb.shape == cr.shape == (64, 128)
  assert y.dtype == np.uint16 and int(y.max()) < 1024


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_decode.py)")
  return torch.device("cuda")


def _kernels_vs_plain(data, device, n_frames=None, repeats=1):
  """Walk a stream's frames through the frame program on the card,
  holding every kernel call, launched `repeats` times, against its plain
  version on the same card tensors.  Returns the names of the kernels
  called."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames
  from ffmpeg_tpu_torch.ops import inter as P
  from ffmpeg_tpu_torch.ops import recon as R

  launches = {"inter_pred": P.LAUNCHES, "recon": R.LAUNCHES}
  called = set()

  def check(name, label, kw):
    kernel, plain = KERNELS[name]
    want = plain(**kw)
    before = launches[name][name]
    for i in range(repeats):
      got = kernel(**kw)
      assert torch.equal(got, want), f"{name} {label} launch {i}"
    assert launches[name][name] == before + repeats
    called.add(name)
    return got

  aus = VVCDecoder(device=device)._split_aus(data)[:n_frames]
  for _ in walk_frames(aus, device, check):
    pass
  return called


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ai256x128_10b", "ai720"])
def test_recon_kernel_matches_plain_on_card(cuda, name):
  assert _kernels_vs_plain(_read(name), cuda, n_frames=1) == {"recon"}


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_frames", [("ra1080", 3), ("ai720", 1)])
def test_recon_kernel_repeats_match_plain_on_card(cuda, name, n_frames):
  """The race check of the recon kernel's dataflow wavefront, whose
  order of work differs from launch to launch: every kernel call of the
  first frames in decode order (ra1080: POC 0, 4 and the B frame POC 2;
  ai720: frame 0) launched 20 times, each equal to the plain version."""
  assert "recon" in _kernels_vs_plain(_read(name), cuda, n_frames,
                                      repeats=20)


# a line of csrc/recon.cu, and what replaces it to break the wait stencil
BROKEN_STENCIL = {
    "no-wait": ("  wait_ready(p, c, map, lane);\n", ""),
    "no-corner": ("if (c[k_cand_up_left] > 0 && x0 > 0 && y0 > 0)",
                  "if (false)"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("broken,name,n_frames", [
    ("no-wait", "ai720", 1), ("no-corner", "ra1080", 3)])
def test_recon_race_check_catches_a_broken_stencil(cuda, tmp_path,
                                                   monkeypatch, broken, name,
                                                   n_frames):
  """The race check has teeth: the recon kernel built from a copy of its
  source (under tmp_path, never in the checkout) that skips the wait, or
  drops the corner cell from the wait stencil, gives launches unequal to
  the plain version on the last frame's calls."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames
  from ffmpeg_tpu_torch.ops import recon as R
  from ffmpeg_tpu_torch.utils import build

  calls = []

  def record(kernel, label, kw):
    calls.append((kernel, kw))
    return KERNELS[kernel][0](**kw)

  aus = VVCDecoder(device=cuda)._split_aus(_read(name))[:n_frames]
  for _ in walk_frames(aus, cuda, record):
    pass
  last = [kw for kernel, kw in calls[-2:] if kernel == "recon"]
  want = [KERNELS["recon"][1](**kw) for kw in last]
  with open(R._SRC) as f:
    src = f.read()
  line, repl = BROKEN_STENCIL[broken]
  assert src.count(line) == 1
  (tmp_path / "recon.cu").write_text(src.replace(line, repl))
  monkeypatch.setattr(R, "_SRC", str(tmp_path / "recon.cu"))
  monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
  monkeypatch.setattr(R, "_lib", None)
  unequal = sum(not torch.equal(R.recon_plane(**kw), w)
                for kw, w in zip(last, want) for _ in range(20))
  assert unequal > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ciip-deblock", "gpm-filters", "wp-b",
                                  "bdof-affine-ra", "wraparound-ra",
                                  "12bit-inter", "mono-inter"])
def test_kernels_match_plain_on_card_inter(cuda, case):
  """Both kernels against their plain versions on every frame of a P/B
  case, with the frame's real references."""
  assert _kernels_vs_plain(_stream(INTER_CASES[case]), cuda) == {
      "inter_pred", "recon"}


def _counts_zeroed():
  from ffmpeg_tpu_torch.ops import inter as P
  from ffmpeg_tpu_torch.ops import recon as R

  for d in (P.LAUNCHES, P.PLAIN_RUNS, R.LAUNCHES, R.PLAIN_RUNS):
    for k in d:
      d[k] = 0
  return P, R


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(INTRA_CASES))
def test_intra_case_decodes_on_card(cuda, case):
  """The kernel path on every intra case: CTU 64 (32-wide chroma
  units), 10/12-bit, 4:0:0, tiles, WPP, cropping."""
  with open(CASES_JSON) as f:
    want = json.load(f)[case]["md5"]
  _, R = _counts_zeroed()
  assert _port_md5s(_stream(INTRA_CASES[case]), device=cuda) == want
  assert R.PLAIN_RUNS["recon"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(INTER_CASES))
def test_inter_case_decodes_on_card(cuda, case):
  """Every P/B case through both kernels to the JAX MD5s."""
  with open(INTER_JSON) as f:
    want = json.load(f)[case]["md5"]
  P, R = _counts_zeroed()
  assert _port_md5s(_stream(INTER_CASES[case]), device=cuda) == want
  assert P.LAUNCHES["inter_pred"] > 0 and R.LAUNCHES["recon"] > 0
  assert P.PLAIN_RUNS["inter_pred"] == 0 and R.PLAIN_RUNS["recon"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ai256x128_10b", "ai720", "ra1080"])
def test_fixture_decodes_on_card(cuda, name):
  P, R = _counts_zeroed()
  assert _port_md5s(_read(name), device=cuda) == _fixture_md5s(name)
  assert R.LAUNCHES["recon"] > 0
  assert (P.LAUNCHES["inter_pred"] > 0) == name.startswith("ra")
  assert R.PLAIN_RUNS["recon"] == 0 and P.PLAIN_RUNS["inter_pred"] == 0


# ---- the JAX side live (slow) ----------------------------------------------

@pytest.mark.slow
def test_ai720_fixture_regenerates():
  """The committed 720p fixture is the generator's output for its
  config, and its MD5s are the JAX package's decode (~2 min)."""
  with open(os.path.join(TESTDATA, "ai720.md5.json")) as f:
    fixture = json.load(f)
  data = _stream(fixture["config"])
  assert data == _read("ai720")
  assert _jax_md5s(data) == fixture["md5"]


@pytest.mark.slow
def test_ra1080_fixture_regenerates():
  """The committed 1080p random-access fixture is the generator's output
  for its config, and its MD5s are the JAX package's decode (~3 min)."""
  with open(os.path.join(TESTDATA, "ra1080.md5.json")) as f:
    fixture = json.load(f)
  data = _stream(fixture["config"])
  assert data == _read("ra1080")
  assert _jax_md5s(data) == fixture["md5"]


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(INTRA_CASES))
def test_intra_case_jax_live(case):
  data = _stream(INTRA_CASES[case])
  assert _port_md5s(data) == _jax_md5s(data)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(INTER_CASES))
def test_inter_case_jax_live(case):
  data = _stream(INTER_CASES[case])
  assert _port_md5s(data) == _jax_md5s(data)


@pytest.mark.slow
def test_missing_reference_jax_live():
  cut, _ = _missing_ref_stream()
  assert _port_md5s(cut, errors="contain") == _jax_md5s(cut)


def _missing_ref_entry():
  return {"config": MISSING_REF, "md5": _jax_md5s(_missing_ref_stream()[0])}


def main():
  """Regenerate intra_cases.md5.json and inter_cases.md5.json (with the
  missing-ref entry) with the JAX package's decoder."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  for cases, path in ((INTRA_CASES, CASES_JSON), (INTER_CASES, INTER_JSON)):
    out = {}
    for case, kw in sorted(cases.items()):
      out[case] = {"config": kw, "md5": _jax_md5s(_stream(kw))}
      print(case, out[case]["md5"], flush=True)
    if cases is INTER_CASES:
      out["missing-ref"] = _missing_ref_entry()
      print("missing-ref", out["missing-ref"]["md5"], flush=True)
    with open(path, "w") as f:
      json.dump(out, f, indent=1)
      f.write("\n")


if __name__ == "__main__":
  main()
