"""The PyTorch port's stream generator (ffmpeg_tpu_torch/encoder, cbs,
bitstream/cabac.py, native/encode.cc and tools/genvvc.py) against the
JAX package's, on the CPU; tolerance 0 everywhere (bytes and MD5s):

  - every committed case config (testdata/*_case*.md5.json) gives the
    same bytes and the same intent in both packages, and the small
    committed fixtures regenerate to their bytes;
  - the native CABAC engine is bin-exact with the Python engine, its
    plain version (on test_cabac.py's bin sessions, and whole streams
    made with the Python engine in its place), and the port's Python
    engine with the JAX package's;
  - the header writer (cbs/h266.py) writes the JAX package's bytes for
    every SPS, PPS, APS, picture header and slice header of
    test_cbs_roundtrip.py's configs;
  - the CLI writes the JAX CLI's file and intent sidecar;
  - the port's generator feeds the port's decoder to the committed JAX
    MD5s, with no ffmpeg_tpu module in the loop;
  - a native engine that fails to build raises; nothing falls back.

The JAX package's generator needs no JAX, so this file imports none.  The
`gpu` test decodes generated cases through the kernels on the card:

  python -m pytest --noconftest -m gpu tests/test_torch_generator.py
"""
import dataclasses
import glob
import json
import os
import random
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TESTDATA = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata")

torch.set_num_threads(2)


def _committed_cases() -> dict:
  """{"<file>/<case>": its committed {"config", "md5"}} for every case
  of testdata/*_case*.md5.json that is a generator config (not the
  inter cases' missing-ref, an access unit dropped from inter-p)."""
  out = {}
  for path in sorted(glob.glob(os.path.join(TESTDATA, "*_case*.md5.json"))):
    stem = os.path.basename(path).split(".")[0]
    with open(path) as f:
      for case, entry in json.load(f).items():
        if "config" in entry and "base" not in entry["config"]:
          out[f"{stem}/{case}"] = entry
  return out


CASES = _committed_cases()
# the committed fixtures small enough to generate in a CPU test (the 1080p and
# 720p ones take 10-25 s each; chip_smoke.py regenerates all seven)
SMALL_FIXTURES = ("ciip64", "ai256x128_10b")
# one case per tool group, generated and decoded by the port alone
END_TO_END = ("intra_cases/dualtree-cclm-mip-mrl",
              "tools_cases/dmvr-bdof-tmvp", "tools_cases/alf-lmcs-ra",
              "coding_cases/isp", "coding_cases/tb64",
              "intra_cases/bdpcm-10bit", "intra_cases/mono-filters")
# whole streams made with the Python engine in the native one's place:
# WPP and tile entry points (context snapshots), dependent quantisation,
# sign hiding, transform skip, ALF/LMCS APSs, inter
PY_ENGINE = ("tools_cases/wpp-tools-ra", "tools_cases/tiles-tools-ra",
             "conformance_cases/dep-quant-ts",
             "conformance_cases/sign-hiding-inter",
             "conformance_cases/transform-skip-full",
             "tools_cases/alf-lmcs-ra")
# generated cases decoded on the card
ON_CARD = ("conformance_cases/slices-wpp", "conformance_cases/rect-slices-ra",
           "conformance_cases/wraparound-p", "intra_cases/mono-filters",
           "tools_cases/dmvr-bdof-tmvp", "coding_cases/isp-inter")


def _port(kw):
  from ffmpeg_tpu_torch.encoder import config_from_json, encode_stream

  return encode_stream(config_from_json(kw))


def _jax(kw):
  """The JAX package's generator on the same field values as _port's."""
  from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream
  from ffmpeg_tpu_torch.encoder import config_from_json

  return encode_stream(EncoderConfig(**vars(config_from_json(kw))))


def _md5s(data, device="cpu"):
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  return [f.md5() for f in VVCDecoder(device=device).decode(data)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_matches_jax(case):
  kw = CASES[case]["config"]
  data, intent = _port(kw)
  want, want_intent = _jax(kw)
  assert data == want
  assert intent == want_intent


def test_config_from_json_restores_tuples():
  """A config's JSON form (nested tuples come back as lists) gives the
  stream of the config itself."""
  from ffmpeg_tpu_torch.encoder import EncoderConfig, encode_stream
  from torch_conformance_cases import ALL_CASES

  kw = CASES["conformance_cases/rect-slices"]["config"]
  assert kw["rect_slices"] and isinstance(kw["rect_slices"][0], list)
  assert _port(kw)[0] == encode_stream(EncoderConfig(
      **ALL_CASES["rect-slices"]))[0]


@pytest.mark.parametrize("name", SMALL_FIXTURES)
def test_small_fixture_regenerates(name):
  with open(os.path.join(TESTDATA, f"{name}.md5.json")) as f:
    kw = json.load(f)["config"]
  with open(os.path.join(TESTDATA, f"{name}.vvc"), "rb") as f:
    assert _port(kw)[0] == f.read()


def test_full1080_17_config_is_bench_full_kw():
  """full1080_17.json holds bench.py FULL_KW at 17 frames, its stream's
  size and sha256, and one JAX MD5 a frame."""
  from bench import FULL_KW

  with open(os.path.join(TESTDATA, "full1080_17.json")) as f:
    ref = json.load(f)
  assert ref["config"] == dict(FULL_KW, n_frames=17)
  assert len(ref["md5"]) == 17 and len(ref["sha256"]) == 64
  assert ref["bytes"] > 3 << 20


@pytest.mark.parametrize("case", END_TO_END)
def test_port_generator_feeds_port_decoder(case):
  data, _ = _port(CASES[case]["config"])
  assert _md5s(data) == CASES[case]["md5"]


# -- CABAC engines ----------------------------------------------------------


def _session(seed, n_ops):
  """test_cabac.py's random bin session: (qp, init_type, ops)."""
  from test_cabac import _random_session

  return _random_session(seed, n_ops)


def _biased(seed):
  """test_cabac.py's long runs of one bin (renormalisation and carry)."""
  rng = random.Random(5)
  for _ in range(seed + 1):
    ops = []
    for _ in range(50):
      ctx, b = rng.randrange(378), rng.randrange(2)
      ops += [("ctx", ctx, b)] * rng.randrange(1, 60)
    ops.append(("term1", None, 1))
  return 30, 1, ops


SESSIONS = {**{f"small-{s}": (lambda s=s: _session(s, 200))
               for s in range(20)},
            "large": lambda: _session(999, 20000),
            **{f"biased-{s}": (lambda s=s: _biased(s)) for s in range(5)}}


def _run(enc, ctxs, ops):
  """The payload bytes of a bin session (the bit counts differ: the
  native engine's counts whole bytes, and the generator reads neither)."""
  for kind, ctx, b in ops:
    if kind == "ctx":
      enc.encode(ctxs, ctx, b)
    elif kind == "bypass":
      enc.bypass(b)
    else:
      enc.terminate(b)
  return enc.finish()[0]


def _python_engine(pkg, qp, init_type, ops):
  if pkg == "port":
    from ffmpeg_tpu_torch.bitstream.cabac import CabacEncoder, ContextTable
  else:
    from ffmpeg_tpu.bitstream.cabac import CabacEncoder, ContextTable
  ctxs = ContextTable()
  ctxs.init_states(qp, init_type)
  return _run(CabacEncoder(), ctxs, ops)


@pytest.mark.parametrize("name", list(SESSIONS))
def test_native_engine_matches_python_engine(name):
  from ffmpeg_tpu_torch.bitstream.cabac import CabacDecoder, ContextTable
  from ffmpeg_tpu_torch.encoder.native_cabac import NativeCabac

  qp, init_type, ops = SESSIONS[name]()
  got = _run(NativeCabac(qp, init_type), None, ops)
  assert got == _python_engine("port", qp, init_type, ops)
  ctxs = ContextTable()
  ctxs.init_states(qp, init_type)
  dec = CabacDecoder(got)
  for kind, ctx, b in ops:
    assert b == (dec.decode(ctxs, ctx) if kind == "ctx" else
                 dec.bypass() if kind == "bypass" else dec.terminate())


@pytest.mark.parametrize("seed", range(8))
def test_python_engine_matches_jax(seed):
  qp, init_type, ops = _session(1000 + seed, 3000)
  assert _python_engine("port", qp, init_type, ops) == \
      _python_engine("jax", qp, init_type, ops)


def test_native_engine_context_snapshots():
  """save_states / load_states (WPP's row inheritance) carry every
  context: an engine that loads a snapshot codes on as the Python engine
  does from the contexts the snapshot was taken at."""
  from ffmpeg_tpu_torch.bitstream.cabac import CabacEncoder, ContextTable
  from ffmpeg_tpu_torch.encoder.native_cabac import NativeCabac

  qp, init_type, ops = _session(7, 800)
  head = [op for op in ops[:400] if op[0] == "ctx"]
  tail = [op for op in ops[400:] if op[0] == "ctx"] + [("term1", None, 1)]
  native = NativeCabac(qp, init_type)
  ctxs = ContextTable()
  ctxs.init_states(qp, init_type)
  py = CabacEncoder()
  for _, ctx, b in head:
    native.encode(None, ctx, b)
    py.encode(ctxs, ctx, b)
  restored = NativeCabac((qp + 17) % 64, (init_type + 1) % 3)
  restored.load_states(native.save_states())
  assert _run(restored, None, tail) == _run(CabacEncoder(), ctxs, tail)


def test_native_encoder_source_copied():
  """native/encode.cc is the JAX package's but for its header comment."""
  def code(pkg):
    with open(os.path.join(ROOT, pkg, "native", "encode.cc")) as f:
      src = f.read()
    return src[src.index("#include"):]

  assert code("ffmpeg_tpu_torch") == code("ffmpeg_tpu")


@pytest.mark.parametrize("case", PY_ENGINE)
def test_python_engine_streams_match_native(case, monkeypatch):
  """Whole streams with the Python engine (CabacEncoder with the Python
  residual coder) in the native engine's place are the same bytes."""
  from ffmpeg_tpu_torch.bitstream.cabac import CabacEncoder
  from ffmpeg_tpu_torch.encoder import ctu

  kw = CASES[case]["config"]
  native, _ = _port(kw)
  monkeypatch.setattr(ctu, "NativeCabac", lambda qp, it: CabacEncoder())
  assert _port(kw)[0] == native


def test_no_fallback_when_the_build_fails(tmp_path, monkeypatch):
  """A native engine whose source does not compile raises with the
  compiler's message, from the generator's own entry point."""
  from ffmpeg_tpu_torch.encoder import EncoderConfig, encode_stream, \
      native_cabac
  from ffmpeg_tpu_torch.utils import build

  (tmp_path / "encode.cc").write_text("this is not C++\n")
  monkeypatch.setattr(native_cabac, "_SRC", str(tmp_path / "encode.cc"))
  monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
  monkeypatch.setattr(native_cabac, "_lib", None)
  with pytest.raises(RuntimeError, match="failed for vvc_enc"):
    encode_stream(EncoderConfig(width=64, height=64))
  assert not os.path.exists(tmp_path / "_build" / "libvvc_enc.so")


def test_no_fallback_without_a_compiler(tmp_path, monkeypatch):
  from ffmpeg_tpu_torch.encoder import EncoderConfig, encode_stream, \
      native_cabac
  from ffmpeg_tpu_torch.utils import build

  monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
  monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
  monkeypatch.setattr(native_cabac, "_lib", None)
  with pytest.raises(RuntimeError, match="no-such-compiler"):
    encode_stream(EncoderConfig(width=64, height=64))


# -- header writer ----------------------------------------------------------


def _as_jax(obj, J):
  """A port header object as the JAX package's class of the same name,
  field by field."""
  if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
    out = object.__new__(getattr(J, type(obj).__name__))
    out.__dict__.update({k: _as_jax(v, J) for k, v in vars(obj).items()})
    return out
  if isinstance(obj, (list, tuple)):
    return type(obj)(_as_jax(v, J) for v in obj)
  if isinstance(obj, dict):
    return {k: _as_jax(v, J) for k, v in obj.items()}
  return obj


def _cbs_cases():
  from test_cbs_roundtrip import CASES as CBS

  return CBS


@pytest.mark.parametrize("name", sorted(_cbs_cases()))
def test_header_writer_matches_jax(name, monkeypatch):
  """Each header the port's encoder writes, written again by the JAX
  package's writer from the same fields, is the same bytes."""
  from ffmpeg_tpu.bitstream import bits as JB
  from ffmpeg_tpu.cbs import h266 as J
  from ffmpeg_tpu_torch.bitstream.bits import BitWriter
  from ffmpeg_tpu_torch.cbs import h266 as H
  from ffmpeg_tpu_torch.encoder import EncoderConfig, encode_stream

  seen = {}

  def wrap_nal(cls):
    orig = cls.to_nal

    def to_nal(self, *args):
      got = orig(self, *args)
      want = getattr(J, cls.__name__).to_nal(_as_jax(self, J),
                                             *_as_jax(args, J))
      assert got == want, cls.__name__
      seen[cls.__name__] = seen.get(cls.__name__, 0) + 1
      return got
    monkeypatch.setattr(cls, "to_nal", to_nal)

  for cls in (H.SPS, H.PPS, H.APS, H.PictureHeader):
    wrap_nal(cls)
  orig_sh = H.SliceHeader.write

  def sh_write(self, w, sps, pps, **kw):
    mine, theirs = BitWriter(), JB.BitWriter()
    orig_sh(self, mine, sps, pps, **kw)
    J.SliceHeader.write(_as_jax(self, J), theirs, _as_jax(sps, J),
                        _as_jax(pps, J), **kw)
    assert (mine.to_bytes(), mine.bit_length) == \
        (theirs.to_bytes(), theirs.bit_length)
    seen["SliceHeader"] = seen.get("SliceHeader", 0) + 1
    return orig_sh(self, w, sps, pps, **kw)
  monkeypatch.setattr(H.SliceHeader, "write", sh_write)

  kw = _cbs_cases()[name]
  data, _ = encode_stream(EncoderConfig(**kw))
  assert data == _jax(json.loads(json.dumps(kw)))[0]
  assert seen["SPS"] == 1 and seen["PPS"] == 1 and seen["SliceHeader"] >= 1
  if kw.get("alf") or kw.get("lmcs") or kw.get("scaling_lists"):
    assert seen.get("APS", 0) >= 1


# -- CLI --------------------------------------------------------------------


def test_cli_matches_jax_cli(tmp_path):
  flags = ["--width", "96", "--height", "64", "--seed", "2007", "--inter",
           "--b-slices", "--n-frames", "3", "--tile-cols", "2,1"]
  out = {}
  for pkg in ("ffmpeg_tpu_torch", "ffmpeg_tpu"):
    path = tmp_path / f"{pkg}.vvc"
    subprocess.run([sys.executable, "-m", f"{pkg}.tools.genvvc", *flags,
                    "-o", str(path)], check=True, cwd=ROOT,
                   capture_output=True, env=dict(os.environ))
    out[pkg] = (path.read_bytes(),
                (tmp_path / f"{pkg}.vvc.intent.json").read_bytes())
  assert out["ffmpeg_tpu_torch"] == out["ffmpeg_tpu"]
  assert len(out["ffmpeg_tpu"][0]) > 100


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_generator.py)")
  return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ON_CARD)
def test_generated_case_decodes_on_card(cuda, case):
  """Generated on the card's host by the port, decoded through the
  kernels (no plain version runs) to the committed JAX MD5s."""
  from ffmpeg_tpu_torch.ops import (alf, deblock, dmvr, inter, lmcs, recon,
                                    sao, transform)

  mods = (transform, inter, recon, deblock, alf, sao, lmcs, dmvr)
  before = [dict(m.PLAIN_RUNS) for m in mods]
  launched = sum(sum(m.LAUNCHES.values()) for m in mods)
  data, _ = _port(CASES[case]["config"])
  assert _md5s(data, device=cuda) == CASES[case]["md5"]
  assert [dict(m.PLAIN_RUNS) for m in mods] == before
  assert sum(sum(m.LAUNCHES.values()) for m in mods) > launched
