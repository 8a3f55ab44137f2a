"""Stream robustness of the PyTorch port's session, held against the JAX
package: flush/seek restart, back-to-back decodes on one session, a
missing IDR in "contain" and "raise" modes, truncated streams, garbage
input, and seeks to a CRA and a GDR (the scenarios of
tests/test_robustness.py, whose reference behaviours are vvc_refs.c:316-347
gray references, vvc_thread.c:605 per-frame error containment,
vvcdec.c:894 flush and vvc_ps.c:745-762 recovery output).

Each scenario's outcome, the frame MD5s of every decode it runs or the
exception it raises, is committed for the JAX package in
ffmpeg_tpu_torch/testdata/robustness_cases.md5.json.  Regenerate it with

  python tests/test_torch_robustness.py

The `slow` twin reruns the JAX side live.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ROBUST_JSON = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata",
                           "robustness_cases.md5.json")

torch.set_num_threads(2)

P3 = dict(width=64, height=64, qp=30, inter=True, n_frames=3)


def _gen(**kw) -> bytes:
  from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream

  return encode_stream(EncoderConfig(**kw))[0]


def _session(pkg, errors="contain"):
  """A fresh decoder session of the port (on the CPU) or of the JAX
  package."""
  if pkg == "port":
    from ffmpeg_tpu_torch.models.vvc.decoder import DecoderConfig, VVCDecoder

    return VVCDecoder(device="cpu", config=DecoderConfig(errors=errors))
  from ffmpeg_tpu.models.vvc.decoder import DecoderConfig, VVCDecoder

  return VVCDecoder(config=DecoderConfig(errors=errors))


def _md5s(dec, data):
  return [f.md5() for f in dec.decode(data)]


def _nals(data):
  from ffmpeg_tpu_torch.bitstream.bits import split_annexb_raw

  return split_annexb_raw(data)


def _drop_idr(data):
  """The stream without its first slice NAL (the IDR), parameter sets
  kept."""
  out, dropped = bytearray(), False
  for t, _l, _tid, raw in _nals(data):
    if t <= 10 and not dropped:
      dropped = True
      continue
    out += b"\x00\x00\x00\x01" + raw
  return bytes(out)


def _from_nal(data, nal_keep):
  """Parameter sets + every NAL from the first NAL of type nal_keep on."""
  params, keep, found = [], [], False
  for t, _l, _tid, raw in _nals(data):
    if t in (12, 13, 14, 15, 16, 17, 18):
      params.append(raw)
      continue
    found = found or t == nal_keep
    if found:
      keep.append(raw)
  return b"".join(params + keep)


def _junk_slice():
  """A stream's parameter sets, then an IDR slice NAL header with a
  random payload."""
  rng = np.random.default_rng(2)
  params = b"".join(raw for t, _l, _tid, raw in _nals(_gen(seed=59, **P3))
                    if t in (14, 15, 16))
  return params + b"\x00\x00\x01\x00\x41" + bytes(
      rng.integers(1, 255, 300, dtype=np.uint8))


def _flush_restart(new):
  """flush() + refeed from a new IDR stream == decoding it standalone."""
  d1 = _gen(seed=41, **dict(P3, qp=32))
  d2 = _gen(seed=43, **P3)
  dec = new()
  first = _md5s(dec, d1)
  dec.flush()
  return [first, _md5s(dec, d2), _md5s(new(), d2)]


def _back_to_back(new):
  """Back-to-back decode() calls on one session (epoch separation of
  the TMVP store)."""
  d = _gen(seed=47, b_slices=True, tmvp=True, **P3)
  dec = new()
  return [_md5s(dec, d), _md5s(dec, d)]


def _missing_idr(errors):
  return lambda new: [_md5s(new(errors), _drop_idr(_gen(seed=53, **P3)))]


def _truncated(frac):
  """The whole stream, then its first `frac` of bytes: the truncated
  final access unit is dropped with an error log, not a crash."""
  def run(new):
    data = _gen(seed=59, **P3)
    return [_md5s(new(), data), _md5s(new(), data[:int(len(data) * frac)])]
  return run


def _garbage(make):
  return lambda new: [_md5s(new(), make())]


def _seek(kind):
  """Decoding from a mid-stream CRA drops its RASL leading pictures;
  from a GDR, output before the recovery point is suppressed."""
  def run(new):
    kw = dict(width=96, height=64, qp=30, inter=True, deblock=True)
    if kind == "cra":
      kw.update(b_slices=True, n_frames=8, cra=True, seed=911)
    else:
      kw.update(n_frames=7, gdr=True, seed=912)
    return [_md5s(new(), _from_nal(_gen(**kw), 9 if kind == "cra" else 10))]
  return run


SCENARIOS = {
    "flush-seek-restart": _flush_restart,
    "back-to-back": _back_to_back,
    "missing-idr-contain": _missing_idr("contain"),
    "missing-idr-raise": _missing_idr("raise"),
    "truncated-0.25": _truncated(0.25),
    "truncated-0.5": _truncated(0.5),
    "truncated-0.85": _truncated(0.85),
    "truncated-0.97": _truncated(0.97),
    "garbage-startcode": _garbage(lambda: b"\x00\x00\x00\x01" + bytes(
        np.random.default_rng(0).integers(0, 255, 400, dtype=np.uint8))),
    "garbage-no-startcode": _garbage(lambda: bytes(
        np.random.default_rng(1).integers(4, 255, 400, dtype=np.uint8))),
    "garbage-empty": _garbage(lambda: b""),
    "garbage-slice": _garbage(_junk_slice),
    "seek-cra": _seek("cra"),
    "seek-gdr": _seek("gdr"),
}


def outcome(name, pkg):
  """{"md5": [each decode's frame MD5s]}, or {"raises": exception type}."""
  try:
    return {"md5": SCENARIOS[name](
        lambda errors="contain": _session(pkg, errors))}
  except Exception as e:  # the outcome under test
    return {"raises": type(e).__name__}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_robustness_matches_jax(name):
  with open(ROBUST_JSON) as f:
    want = json.load(f)[name]
  assert outcome(name, "port") == want


def test_robustness_outcomes_hold_their_contract():
  """The committed outcomes say what the scenarios promise: a restart
  after flush equals a standalone decode, back-to-back decodes agree,
  a missing IDR leaves the two P frames in "contain" mode and raises in
  "raise" mode, a truncated stream decodes to a prefix of the whole
  one, garbage decodes to no frame."""
  with open(ROBUST_JSON) as f:
    got = json.load(f)
  first, restart, alone = got["flush-seek-restart"]["md5"]
  assert len(first) == 3 and restart == alone
  a, b = got["back-to-back"]["md5"]
  assert a == b and len(a) == 3
  assert len(got["missing-idr-contain"]["md5"][0]) == 2
  assert got["missing-idr-raise"] == {"raises": "RuntimeError"}
  for frac in ("0.25", "0.5", "0.85", "0.97"):
    full, cut = got[f"truncated-{frac}"]["md5"]
    assert len(full) == 3 and cut == full[:len(cut)], frac
  assert [got[k] for k in got if k.startswith("garbage-")] == \
      [{"md5": [[]]}] * 4


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_robustness_jax_live(name):
  assert outcome(name, "port") == outcome(name, "jax")


def main():
  """Regenerate robustness_cases.md5.json with the JAX package."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  out = {}
  for name in SCENARIOS:
    out[name] = outcome(name, "jax")
    print(name, out[name], flush=True)
  with open(ROBUST_JSON, "w") as f:
    json.dump(out, f, indent=1)
    f.write("\n")


if __name__ == "__main__":
  main()
