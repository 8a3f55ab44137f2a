"""The PyTorch port's container layer and session options against the
JAX package: the port's own copies of the bit reader and writer
(bitstream/bits.py), the SPS sniff, the vvcC record, the MP4 demuxer
and muxer and the probe (formats/), and the ffprobe analog
(tools/probe.py); and the session's host_threads and fetch_batch
options, which leave every frame MD5 unchanged.  The twins of
tests/test_formats.py use only the port's copies.
"""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from test_torch_decode import (TESTDATA, TOOL_CASES, TOOLS_JSON,  # noqa: E402
                               _port_md5s, _stream)


def _gen(**kw):
  return _stream(kw)


# ---- twins of tests/test_formats.py, on the port's copies ----------------

def test_probe_and_sniff():
  from ffmpeg_tpu_torch.bitstream.bits import split_annexb_raw
  from ffmpeg_tpu_torch.formats import probe_format
  from ffmpeg_tpu_torch.formats.isobmff import annexb_to_mp4
  from ffmpeg_tpu_torch.formats.sniff import sniff_sps

  data = _gen(width=96, height=64, seed=11, qp=30, bit_depth=10)
  assert probe_format(data) == "vvc-annexb"
  assert probe_format(annexb_to_mp4(data)) == "mp4"
  assert probe_format(b"\x00" * 64) == "unknown"
  sps_raw = next(raw for t, _l, _t2, raw in split_annexb_raw(data)
                 if t == 15)
  s = sniff_sps(sps_raw)
  assert (s["width"], s["height"], s["bit_depth"],
          s["chroma_format_idc"]) == (96, 64, 10, 1)


def test_vvcc_roundtrip():
  from ffmpeg_tpu_torch.formats.vvcc import (parse_vvcc, vvcc_from_annexb,
                                             write_vvcc)

  rec, _ = vvcc_from_annexb(_gen(width=64, height=64, seed=12, qp=32))
  rec2 = parse_vvcc(write_vvcc(rec))
  assert rec2.arrays == rec.arrays
  assert (rec2.max_width, rec2.max_height) == (64, 64)
  assert rec2.nal_length_size == 4


def test_mp4_demux_roundtrip():
  from ffmpeg_tpu_torch.formats import open_input
  from ffmpeg_tpu_torch.formats.isobmff import annexb_to_mp4, read_mp4_vvc

  data = _gen(width=96, height=64, seed=13, qp=30, inter=True, n_frames=3)
  mp4 = annexb_to_mp4(data)
  tr = read_mp4_vvc(mp4)
  assert (tr.width, tr.height) == (96, 64)
  assert len(tr.samples) == 3
  annexb, info = open_input(mp4)
  assert info["format"] == "mp4"
  assert _port_md5s(annexb) == _port_md5s(data)


# ---- the copies equal the JAX package's ------------------------------------

CONTAINER_CASES = {
    "p3": dict(width=96, height=64, seed=13, qp=30, inter=True, n_frames=3),
    "10bit": dict(width=96, height=64, seed=11, qp=30, bit_depth=10),
    "ra-alf": TOOL_CASES["alf-lmcs-ra"],
}


@pytest.mark.parametrize("case", list(CONTAINER_CASES))
def test_container_layer_matches_jax(case):
  """The same stream through both packages' muxer, vvcC writer and
  parser, demuxer and probe gives the same bytes and values."""
  from ffmpeg_tpu.formats import open_input as j_open
  from ffmpeg_tpu.formats import isobmff as JI
  from ffmpeg_tpu.formats import vvcc as JV
  from ffmpeg_tpu_torch.formats import open_input
  from ffmpeg_tpu_torch.formats import isobmff as TI
  from ffmpeg_tpu_torch.formats import vvcc as TV

  data = _gen(**CONTAINER_CASES[case])
  mp4 = TI.annexb_to_mp4(data)
  assert mp4 == JI.annexb_to_mp4(data)
  rec, others = TV.vvcc_from_annexb(data)
  jrec, jothers = JV.vvcc_from_annexb(data)
  assert others == jothers
  assert TV.write_vvcc(rec) == JV.write_vvcc(jrec)
  assert vars(TV.parse_vvcc(TV.write_vvcc(rec))) == vars(
      JV.parse_vvcc(JV.write_vvcc(jrec)))
  tr, jtr = TI.read_mp4_vvc(mp4), JI.read_mp4_vvc(mp4)
  assert (tr.vvcc, tr.samples, tr.width, tr.height) == (
      jtr.vvcc, jtr.samples, jtr.width, jtr.height)
  for src in (data, mp4):
    assert open_input(src) == j_open(src)


def test_bits_match_jax():
  """The copied bit writer, reader, escaping and splitters equal the JAX
  package's on seeded random values and payloads."""
  from ffmpeg_tpu.bitstream import bits as J
  from ffmpeg_tpu_torch.bitstream import bits as T

  rng = np.random.default_rng(21)
  vals = rng.integers(0, 5000, 200).tolist()
  written = []
  for mod in (J, T):
    w = mod.BitWriter()
    for v in vals:
      w.ue(v).se(v - 2500).u(13, v).flag(v & 1)
    written.append(w.rbsp_trailing_bits().to_bytes())
  assert written[1] == written[0]
  r = T.BitReader(written[1])
  for v in vals:
    assert (r.ue(), r.se(), r.u(13), r.flag()) == (v, v - 2500, v, v & 1)
  payload = bytes(rng.choice([0, 0, 0, 1, 2, 3, 7], 2000).astype(np.uint8))
  assert T.nal_escape(payload) == J.nal_escape(payload)
  assert T.nal_unescape(T.nal_escape(payload)) == payload
  stream = b"".join(T.make_nal(t, payload[k * 97:(k + 1) * 97] + b"\x80")
                    for k, t in enumerate((15, 16, 8, 0, 1, 19, 23)))
  assert stream == b"".join(J.make_nal(t, payload[k * 97:(k + 1) * 97]
                                       + b"\x80")
                            for k, t in enumerate((15, 16, 8, 0, 1, 19, 23)))
  assert T.split_annexb(stream) == J.split_annexb(stream)
  assert T.split_annexb_raw(stream) == J.split_annexb_raw(stream)
  for name in ("NAL_IDR_N_LP", "NAL_CRA", "NAL_SPS", "NAL_PH"):
    assert getattr(T, name) == getattr(J, name)


# ---- the ffprobe analog ----------------------------------------------------

@pytest.mark.parametrize("container", ["annexb", "mp4"])
def test_probe_tool_matches_jax(container, tmp_path, capsys):
  """tools/probe.py prints the JAX tool's dict, on ai720.vvc and on its
  MP4 (made by the port's muxer)."""
  from ffmpeg_tpu.tools import probe as J
  from ffmpeg_tpu_torch.formats.isobmff import annexb_to_mp4
  from ffmpeg_tpu_torch.tools import probe as T

  path = os.path.join(TESTDATA, "ai720.vvc")
  if container == "mp4":
    with open(path, "rb") as f:
      data = f.read()
    path = str(tmp_path / "ai720.mp4")
    with open(path, "wb") as f:
      f.write(annexb_to_mp4(data))
  got = T.probe(path)
  assert got == J.probe(path)
  assert got["format"]["format"] == ("mp4" if container == "mp4"
                                     else "vvc-annexb")
  assert got["streams"][0]["width"] == 1280
  assert got["streams"][0]["nb_frames"] == 4
  for argv in ([path, "--json"], [path, "--frames"]):
    assert T.main(argv) == 0
    mine = capsys.readouterr().out
    assert J.main(argv) == 0
    assert mine == capsys.readouterr().out


# ---- the session's options ---------------------------------------------------

SESSION_CASE = "dmvr-bdof-tmvp"


@pytest.mark.parametrize("option", ["host_threads=1", "host_threads=2",
                                    "host_threads=8", "fetch_batch=1",
                                    "fetch_batch=3"])
def test_session_options_keep_md5s(option):
  """host_threads (the parse pool, its handles and the parse-ahead
  depth) and fetch_batch (frames per fetch) change no frame: a stream
  with DMVR and TMVP (the main thread's refinement between parses) to
  the JAX MD5s, twice on one session with a flush between."""
  from ffmpeg_tpu_torch.models.vvc.decoder import DecoderConfig, VVCDecoder

  key, val = option.split("=")
  with open(TOOLS_JSON) as f:
    want = json.load(f)[SESSION_CASE]["md5"]
  cfg = DecoderConfig(errors="raise", **{key: int(val)})
  dec = VVCDecoder(device="cpu", config=cfg)
  data = _stream(TOOL_CASES[SESSION_CASE])
  assert [f.md5() for f in dec.decode(data)] == want
  dec.flush()
  assert dec._hosts.qsize() == cfg.host_threads
  assert [f.md5() for f in dec.decode(data)] == want


def test_session_host_threads_argument():
  """VVCDecoder(host_threads=n) sets the parse pool without changing the
  caller's config."""
  from ffmpeg_tpu_torch.models.vvc.decoder import DecoderConfig, VVCDecoder

  cfg = DecoderConfig(fetch_batch=2)
  dec = VVCDecoder(device="cpu", host_threads=3, config=cfg)
  assert (dec.config.host_threads, dec.config.fetch_batch) == (3, 2)
  assert dec._parse_ahead == 6 and dec._hosts.qsize() == 3
  assert cfg.host_threads == 4
  assert VVCDecoder(device="cpu").config == DecoderConfig()
