"""End to end: the PyTorch port decodes intra and P/B streams, with LMCS,
ALF/CC-ALF, DMVR, ISP, 64-sample transform blocks (CTU-128) and explicit
scaling lists, to the JAX package's frame MD5s, and refuses what the JAX
package refuses too (4:2:2, 4:4:4).

The JAX MD5s of the small cases live in
ffmpeg_tpu_torch/testdata/intra_cases.md5.json, inter_cases.md5.json,
tools_cases.md5.json and coding_cases.md5.json (a JAX decode per case
costs a minute of XLA compile on the CPU); the coding cases' CPU tests
are in test_torch_decode_tb64.py and test_torch_decode_isp_sl.py.
Regenerate them with

  python tests/test_torch_decode.py

The `slow` tests rerun the JAX side live; the `gpu` tests need a CUDA
card and skip here (among them the wave path of parallel/gop.py, whose
CPU tests are in test_torch_parallel.py).  On the card, which has no JAX (so the JAX-importing
conftest stays out):

  python -m pytest --noconftest -m gpu tests/test_torch_decode.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TESTDATA = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata")
CASES_JSON = os.path.join(TESTDATA, "intra_cases.md5.json")
INTER_JSON = os.path.join(TESTDATA, "inter_cases.md5.json")
TOOLS_JSON = os.path.join(TESTDATA, "tools_cases.md5.json")
CODING_JSON = os.path.join(TESTDATA, "coding_cases.md5.json")

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

# cases of tests/test_conformance.py with LMCS, ALF/CC-ALF or DMVR (same
# ids and configs): every one the port decodes since those tools came
TOOL_CASES = {
    "lmcs": dict(width=96, height=96, seed=1501, qp=30, lmcs=True),
    "lmcs-b": dict(width=96, height=96, seed=1504, qp=30, lmcs=True),
    "lmcs-inter": dict(width=96, height=64, seed=1502, qp=28, lmcs=True,
                       inter=True, b_slices=True, deblock=True, sao=True,
                       n_frames=4),
    "lmcs-ra": dict(width=96, height=64, seed=1505, qp=30, lmcs=True,
                    inter=True, b_slices=True, ra=True, n_frames=9,
                    deblock=True),
    "lmcs-10bit-jcbcr": dict(width=96, height=64, seed=1506, qp=32, lmcs=True,
                             bit_depth=10, joint_cbcr=True, sao=True),
    "lmcs-tools": dict(width=128, height=64, seed=1507, qp=30, lmcs=True,
                       mts=True, lfnst=True, dep_quant=True, cu_qp_delta=True,
                       ctu_log2=6, max_bt_size=64),
    "alf": dict(width=96, height=96, seed=1601, qp=30, alf=True),
    "alf-ccalf": dict(width=96, height=96, seed=1604, qp=30, alf=True,
                      ccalf=True),
    "alf-inter": dict(width=96, height=64, seed=1605, qp=28, alf=True,
                      ccalf=True, inter=True, b_slices=True, deblock=True,
                      sao=True, n_frames=4),
    "alf-ctu64-10bit": dict(width=128, height=128, seed=1606, qp=30, alf=True,
                            ccalf=True, ctu_log2=6, max_bt_size=64,
                            bit_depth=10),
    "alf-lmcs-ra": dict(width=96, height=64, seed=1607, qp=30, alf=True,
                        ccalf=True, lmcs=True, inter=True, b_slices=True,
                        ra=True, n_frames=9, deblock=True, sao=True),
    "inter-wave1-all": dict(width=96, height=64, seed=1706, qp=30, inter=True,
                            b_slices=True, ra=True, tmvp=True, n_frames=9,
                            mmvd=True, amvr=True, bcw=True, lmcs=True,
                            alf=True, deblock=True, sao=True),
    "ciip-tools-ra": dict(width=96, height=64, seed=1803, qp=28, inter=True,
                          b_slices=True, ra=True, n_frames=9, ciip=True,
                          mmvd=True, amvr=True, bcw=True, lmcs=True,
                          deblock=True),
    "wp-tools-ra": dict(width=96, height=64, seed=2003, qp=28, inter=True,
                        b_slices=True, ra=True, n_frames=9,
                        weighted_pred=True, mmvd=True, lmcs=True,
                        deblock=True),
    "sbtmvp-tools-ra": dict(width=96, height=64, seed=2106, qp=28, inter=True,
                            b_slices=True, ra=True, n_frames=9, sbtmvp=True,
                            tmvp=True, mmvd=True, amvr=True, bcw=True,
                            lmcs=True, deblock=True, max_mv=160),
    "affine-tools-ra": dict(width=96, height=64, seed=2206, qp=28, inter=True,
                            b_slices=True, ra=True, n_frames=9, affine=True,
                            sbtmvp=True, tmvp=True, mmvd=True, amvr=True,
                            bcw=True, lmcs=True, deblock=True, max_mv=120),
    "prof-tools-ra": dict(width=96, height=64, seed=2303, qp=28, inter=True,
                          b_slices=True, ra=True, n_frames=9, affine=True,
                          prof=True, sbtmvp=True, tmvp=True, bcw=True,
                          lmcs=True, deblock=True, max_mv=120),
    "bdof-ra": dict(width=96, height=64, seed=2403, qp=28, inter=True,
                    b_slices=True, ra=True, n_frames=9, bdof=True, mmvd=True,
                    tmvp=True, lmcs=True, deblock=True, max_mv=90),
    "dmvr": dict(width=96, height=64, seed=2501, qp=28, inter=True,
                 b_slices=True, ra=True, n_frames=9, dmvr=True, max_mv=90),
    "dmvr-bdof-tmvp": dict(width=96, height=96, seed=2502, qp=28, inter=True,
                           b_slices=True, ra=True, n_frames=9, dmvr=True,
                           bdof=True, tmvp=True, deblock=True, sao=True,
                           max_mv=90),
    "dmvr-tools-ra": dict(width=96, height=64, seed=2503, qp=28, inter=True,
                          b_slices=True, ra=True, n_frames=9, dmvr=True,
                          bdof=True, mmvd=True, lmcs=True, affine=True,
                          prof=True, deblock=True, max_mv=90),
    "gpm-tools-ra": dict(width=96, height=64, seed=1903, qp=28, inter=True,
                         b_slices=True, ra=True, n_frames=9, gpm=True,
                         ciip=True, mmvd=True, bcw=True, amvr=True, lmcs=True,
                         deblock=True),
    "mip-lmcs-ra": dict(width=96, height=64, seed=2605, qp=30, mip=True,
                        inter=True, b_slices=True, ra=True, n_frames=5,
                        deblock=True, sao=True, lmcs=True),
    "cclm-lmcs-ra": dict(width=96, height=64, seed=2705, qp=30, cclm=True,
                         inter=True, b_slices=True, ra=True, n_frames=5,
                         deblock=True, sao=True, lmcs=True),
    "mrl-tools-ra": dict(width=96, height=64, seed=2804, qp=30, mrl=True,
                         cclm=True, inter=True, b_slices=True, ra=True,
                         n_frames=5, deblock=True, sao=True, lmcs=True),
    "tiles-tools-ra": dict(width=96, height=96, seed=3004, qp=28,
                           tile_cols=(1, 2), tile_rows=(1, 2), inter=True,
                           b_slices=True, ra=True, n_frames=9, mmvd=True,
                           amvr=True, bcw=True, lmcs=True, alf=True,
                           deblock=True, sao=True, mip=True, cclm=True),
    "wpp-tools-ra": dict(width=96, height=96, seed=3104, qp=28, wpp=True,
                         inter=True, b_slices=True, ra=True, n_frames=9,
                         mmvd=True, amvr=True, bcw=True, lmcs=True, alf=True,
                         deblock=True, sao=True),
    "separate-ph-tools-ra": dict(width=96, height=64, seed=2902, qp=28,
                                 separate_ph=True, inter=True, b_slices=True,
                                 ra=True, n_frames=5, deblock=True, sao=True,
                                 lmcs=True),
    "dualtree-10bit-filters": dict(width=96, height=64, seed=3205, qp=28,
                                   dual_tree=True, bit_depth=10, alf=True,
                                   ccalf=True, lmcs=True, deblock=True,
                                   sao=True),
    "rpl-ph-sps-ra": dict(width=96, height=64, seed=3804, qp=30, inter=True,
                          b_slices=True, ra=True, tmvp=True, n_frames=9,
                          rpl_in_ph=True, rpl_in_sps=True, deblock=True,
                          sao=True, lmcs=True, max_mv=48),
    "alf-ph": dict(width=96, height=64, seed=3805, qp=30, inter=True,
                   n_frames=5, alf_in_ph=True, alf=True, ccalf=True,
                   deblock=True, sao=True, max_mv=48),
}

# the ISP, TB-64/CTU-128 and scaling-list cases of tests/test_conformance.py
# (same ids and configs), and ciip64: CTU-64 B frames whose CIIP units
# reach 64x64 (the luma units' edge is 64 without TB-64)
CODING_CASES = {
    "tb64": dict(width=128, height=128, seed=3701, qp=30, ctu_log2=6,
                 tb64=True, min_qt_size=64, max_mtt_depth=0, split_prob=0.3),
    "tb64-filters": dict(width=192, height=128, seed=3702, qp=28, ctu_log2=6,
                         tb64=True, min_qt_size=32, max_mtt_depth=1,
                         max_bt_size=64, max_tt_size=64, deblock=True,
                         sao=True, split_prob=0.4),
    "tb64-lfnst": dict(width=128, height=128, seed=3703, qp=30, ctu_log2=6,
                       tb64=True, min_qt_size=32, max_mtt_depth=0,
                       lfnst=True, split_prob=0.4),
    "ctu128": dict(width=256, height=192, seed=3704, qp=30, ctu_log2=7,
                   tb64=True, min_qt_size=64, max_mtt_depth=0,
                   split_prob=0.4),
    "ctu128-inter": dict(width=256, height=192, seed=3705, qp=32, ctu_log2=7,
                         tb64=True, min_qt_size=32, max_mtt_depth=1,
                         max_bt_size=64, max_tt_size=64, inter=True,
                         b_slices=True, deblock=True, sao=True, max_mv=64,
                         n_frames=4, split_prob=0.4),
    "ctu128-tools-ra": dict(width=256, height=192, seed=3706, qp=32,
                            ctu_log2=7, tb64=True, min_qt_size=32,
                            max_mtt_depth=1, max_bt_size=64, max_tt_size=64,
                            inter=True, b_slices=True, ra=True, tmvp=True,
                            n_frames=5, deblock=True, sao=True, alf=True,
                            lmcs=True, mip=True, max_mv=64, split_prob=0.4),
    "isp": dict(width=96, height=96, seed=3501, qp=30, isp=True,
                split_prob=0.8),
    "isp-lfnst": dict(width=96, height=64, seed=3504, qp=30, isp=True,
                      lfnst=True, mts_implicit=True),
    "isp-dualtree": dict(width=96, height=64, seed=3506, qp=30, isp=True,
                         dual_tree=True, cclm=True, mip=True, mrl=True),
    "isp-10bit-filters": dict(width=96, height=64, seed=3508, qp=32, isp=True,
                              bit_depth=10, deblock=True, sao=True),
    "isp-inter": dict(width=96, height=64, seed=3509, qp=30, isp=True,
                      inter=True, b_slices=True, n_frames=4, deblock=True),
    "scaling-mts-jcbcr": dict(width=96, height=96, seed=7002, qp=28,
                              scaling_lists=True, mts=True, joint_cbcr=True),
    "scaling-lfnst-ts": dict(width=96, height=64, seed=7003, qp=30,
                             scaling_lists=True, lfnst=True,
                             transform_skip=True),
    "scaling-inter": dict(width=96, height=64, seed=7005, qp=30,
                          scaling_lists=True, inter=True, b_slices=True,
                          n_frames=4, deblock=True),
    "ciip64": dict(width=128, height=128, seed=5222, qp=30, ctu_log2=6,
                   min_qt_size=64, max_mtt_depth=0, inter=True, b_slices=True,
                   n_frames=3, ciip=True, deblock=True),
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


@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_tool_case_matches_jax(case):
  with open(TOOLS_JSON) as f:
    want = json.load(f)[case]
  assert want["config"] == json.loads(json.dumps(TOOL_CASES[case]))
  assert _port_md5s(_stream(TOOL_CASES[case])) == want["md5"]


def test_session_decodes_dmvr_stream_again():
  """One session decodes a stream with DMVR and TMVP three times, each to
  the JAX MD5s: a parser handle that parsed a DMVR frame is not reused
  (it would keep deferring the collocated motion of the frames it parses
  next, and a later frame's TMVP would wait for it)."""
  from ffmpeg_tpu_torch.models.vvc.decoder import DecoderConfig, VVCDecoder

  with open(TOOLS_JSON) as f:
    want = json.load(f)["dmvr-bdof-tmvp"]["md5"]
  data = _stream(TOOL_CASES["dmvr-bdof-tmvp"])
  dec = VVCDecoder(device="cpu", config=DecoderConfig(errors="raise"))
  for _ in range(3):
    assert [f.md5() for f in dec.decode(data)] == want


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


def _host_frames(data):
  """The port's parser on each access unit of a stream, on one handle
  pool of one: [FrameSyntax]."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.host import ColStore, HostDecoder

  hd = HostDecoder(ColStore())
  out = []
  for _, epoch, au in VVCDecoder(device="cpu")._split_aus(data):
    fs = hd.decode_au(au, epoch)
    if fs is not None:
      out.append(fs)
  return out, hd


@pytest.mark.parametrize("chroma_format_idc", [2, 3])
def test_refused_stream_raises(chroma_format_idc):
  """Outside the port, as outside the JAX package: a 4:2:2 or 4:4:4
  frame raises NotImplementedError naming its chroma format, never a
  wrong frame.  The generator makes no legal 4:2:2 stream, so the check
  runs on a parsed frame with its chroma format changed."""
  import dataclasses

  from ffmpeg_tpu_torch.models.vvc.inputs import check_supported

  fs = _host_frames(_read("ai256x128_10b"))[0][0]
  check_supported(fs)
  bad = dataclasses.replace(fs, chroma_format_idc=chroma_format_idc)
  with pytest.raises(NotImplementedError, match="JAX package") as e:
    check_supported(bad)
  assert f"chroma_format_idc {chroma_format_idc}" in str(e.value)


def test_cli_decodes_mp4(tmp_path, capsys):
  """An MP4 (ISO-BMFF) input, made by the port's own muxer, decodes to
  the annex-B stream's MD5s."""
  from ffmpeg_tpu_torch.formats.isobmff import annexb_to_mp4
  from ffmpeg_tpu_torch.tools.decode import main

  path = tmp_path / "t.mp4"
  path.write_bytes(annexb_to_mp4(_read("ai256x128_10b")))
  assert main([str(path), "--device", "cpu", "--strict"]) == 0
  lines = capsys.readouterr().out.strip().splitlines()
  assert [ln.split(", ")[-1] for ln in lines] == _fixture_md5s(
      "ai256x128_10b")


def test_cli_refuses_unknown_input(tmp_path):
  """Input that is neither annex-B nor MP4 exits non-zero with a
  message, not with "decoded 0 frames"."""
  from ffmpeg_tpu_torch.tools.decode import main

  path = tmp_path / "junk.bin"
  path.write_bytes(bytes(np.random.default_rng(9).integers(
      4, 255, 4096, dtype=np.uint8)))
  with pytest.raises(SystemExit, match="unrecognized input format") as e:
    main([str(path), "--device", "cpu"])
  assert e.value.code != 0


def test_parser_flags_do_not_stick():
  """A parser handle that parsed an ISP or TB-64 frame is not reused:
  the next frame it parses, from a stream without either tool, has
  has_isp and has_tb64 0."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  plain = VVCDecoder(device="cpu")._split_aus(_stream(INTRA_CASES["64x64"]))
  for case, flag in (("isp", "has_isp"), ("tb64", "has_tb64")):
    frames, hd = _host_frames(_stream(CODING_CASES[case]))
    assert getattr(frames[0], flag) == 1
    fs = hd.decode_au(plain[0][2], plain[0][1])
    assert (fs.has_isp, fs.has_tb64) == (0, 0), case


def test_session_decodes_coding_tools_then_plain():
  """One session decodes an ISP stream, a TB-64 stream, then a stream
  with neither, each to the JAX MD5s."""
  from ffmpeg_tpu_torch.models.vvc.decoder import DecoderConfig, VVCDecoder

  with open(CODING_JSON) as f:
    coding = json.load(f)
  with open(CASES_JSON) as f:
    intra = json.load(f)
  dec = VVCDecoder(device="cpu", config=DecoderConfig(errors="raise"))
  for kw, want in ((CODING_CASES["isp"], coding["isp"]["md5"]),
                   (CODING_CASES["tb64"], coding["tb64"]["md5"]),
                   (INTRA_CASES["64x64"], intra["64x64"]["md5"])):
    assert [f.md5() for f in dec.decode(_stream(kw))] == want


def test_ciip_tile_index_checked_by_recon():
  """A CIIP row whose MC tile index lies outside the MC batch raises in
  the recon entry, before any device work."""
  from ffmpeg_tpu_torch.models.vvc.convert import _inter, _intra
  from ffmpeg_tpu_torch.models.vvc.inputs import INTER_KEYS, INTRA_KEYS
  from ffmpeg_tpu_torch.ops.recon import recon_plane
  from torch_mc_rows import batch

  rows = {k: np.zeros(33, np.int32) for k in (*INTRA_KEYS, "ipos")}
  rows["w"][0] = rows["h"][0] = 8
  rows["ciipw"][0] = 2
  rows["ipos"][0] = 1
  rows["ioff"] = np.array([0], np.int32)
  rows["iend"] = np.array([1], np.int32)
  intra = _intra(rows, 1, "cpu")
  mc = {k: np.zeros(1, np.int32) for k in INTER_KEYS}
  mc["w"][0] = mc["h"][0] = 8
  inter = _inter(batch(mc, np.zeros((1, 32, 32)), np.zeros(1), False), 0,
                 "cpu")
  tiles = torch.zeros((1, 64), dtype=torch.int16)
  with pytest.raises(ValueError, match="CIIP tile index"):
    recon_plane(torch.zeros((1, 64, 64), dtype=torch.int32), intra, 1, inter,
                tiles, maxs=32, is_chroma=False, bit_depth=8)


def test_frame_program_kernel_calls():
  """walk_frames runs the frame program's kernel calls through its hook,
  in order: an I frame's residual and recon of luma, then of chroma; a
  P frame's inter_pred of luma and chroma after the luma residual."""
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
  luma = [("recon", "luma"), ("residual", "chroma"), ("recon", "chroma")]
  assert frames[0] == (2, [("residual", "luma"), *luma])
  assert len(frames) == len(aus)
  for slice_type, calls in frames[1:]:
    assert slice_type == 1
    assert calls == [("residual", "luma"), ("inter_pred", "luma"),
                     ("inter_pred", "chroma"), *luma]


def test_frame_program_kernel_calls_full_toolset():
  """The main path's first two frames (I, then B; full1080: LMCS with
  chroma residual scaling, deblock, SAO, ALF): every kernel call
  through the hook, in order: residual of luma, inter_pred of luma and
  chroma (B), recon of luma, residual of chroma (with the scales'
  source: the mapped luma recon) and recon of chroma, lmcs_inv,
  deblock, sao and alf of luma then chroma."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def record(name, label, kw):
    seen.append((name, label))
    if name == "residual":
      assert (kw["scale_src"] is not None) == (label == "chroma")
    return KERNELS[name][0](**kw)

  aus = VVCDecoder(device="cpu")._split_aus(_read("full1080"))[:2]
  frames = []
  for fs, h in walk_frames(aus, "cpu", record):
    assert all(k in h for k in ("deblock", "sao", "alf"))
    assert "chroma_scale" in h["lmcs"]
    frames.append((fs.slice_type, list(seen)))
    seen.clear()
  pair = [("luma",), ("chroma",)]
  inter = [("inter_pred",) + k for k in pair]
  for slice_type, calls in frames:
    want = [("residual", "luma"), *(inter if slice_type != 2 else []),
            ("recon", "luma"), ("residual", "chroma"), ("recon", "chroma"),
            ("lmcs_inv", "luma")]
    want += [(k,) + p for k in ("deblock", "sao", "alf") for p in pair]
    assert calls == want
  assert [t for t, _ in frames] == [2, 0]


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

# the SAO and LMCS kernels, which a frame calls as its inputs ask
FILTER_KERNELS = ("sao", "lmcs_inv")
# per fixture, its frames with SAO and with LMCS on (the traced sao and
# lmcs spans)
FIXTURE_FILTER_FRAMES = {
    "full1080": {"sao": 5, "lmcs": 5},
    "gop720": {"sao": 9, "lmcs": 9},
    "ctu128_1080": {"sao": 5, "lmcs": 5},
    "ra1080": {"sao": 5, "lmcs": 0},
    "ai720": {"sao": 4, "lmcs": 0},
    "ai256x128_10b": {"sao": 2, "lmcs": 0},
    "ciip64": {"sao": 0, "lmcs": 0}}

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_decode.py)")
  return torch.device("cuda")


def unit_kinds(kw) -> set:
  """The unit kinds of one recon call that the 64-edge and ISP paths
  add: luma units 64 a side ("edge64"), 1 or 2 samples high ("high1",
  "high2"), CIIP ("ciip64") and MIP ("mip64") units of 64x64, and calls
  at readiness cell 1 ("cell1")."""
  from ffmpeg_tpu_torch.models.vvc.inputs import INTRA_KEYS
  from ffmpeg_tpu_torch.models.vvc.recon import MC_MIP
  from ffmpeg_tpu_torch.ops.recon import readiness_cell

  intra = kw["intra"]
  n = int(intra["iend_host"][-1]) if kw["n_chunks"] else 0
  r = {k: intra["mat_host"][INTRA_KEYS.index(k), :n]
       for k in ("w", "h", "ciipw", "mode_class")}
  big = (r["w"] == 64) & (r["h"] == 64)
  kinds = {"edge64": bool(((r["w"] == 64) | (r["h"] == 64)).any()),
           "high1": bool((r["h"] == 1).any()),
           "high2": bool((r["h"] == 2).any() and not kw["is_chroma"]),
           "ciip64": bool((big & (r["ciipw"] > 0)).any()),
           "mip64": bool((big & (r["mode_class"] == MC_MIP)).any()),
           "cell1": readiness_cell(intra["mat_host"][:, :n]) == 1}
  return {k for k, v in kinds.items() if v}


def make_mip64(rows: dict, n: int) -> np.ndarray:
  """Turn every 64x64 non-CIIP intra unit among the first n of a luma
  layout's rows (INTRA_KEYS -> numpy row, edited in place) into a MIP unit
  of size id 2 (matrix 24 + u % 6, transposed for odd u).  The generator
  makes no MIP unit above 32 a side, so a 64x64 MIP unit is made this
  way; MIP reads only the unfiltered top and left runs, which the unit's
  waits cover.  Returns the edited units."""
  from ffmpeg_tpu_torch.models.vvc.recon import MC_MIP

  big = np.flatnonzero((rows["w"][:n] == 64) & (rows["h"][:n] == 64)
                       & (rows["ciipw"][:n] == 0))
  for k, v in (("mode_class", MC_MIP), ("mip_sz", 2), ("smooth", 0),
               ("proj_v", 0), ("proj_h", 0), ("do_pdpc", 0), ("mrl", 0)):
    rows[k][big] = v
  rows["mip_id"][big] = 24 + big % 6
  rows["mip_t"][big] = big & 1
  return big


def _kernels_vs_plain(data, device, n_frames=None, repeats=1, kinds=None):
  """Walk a stream's frames through the frame program on the card,
  holding every kernel call, launched `repeats` times, against its plain
  version on the same card tensors.  Returns the names of the kernels
  called; `kinds`, a set, gathers the recon calls' unit_kinds."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames
  from ffmpeg_tpu_torch.ops import alf as A
  from ffmpeg_tpu_torch.ops import deblock as D
  from ffmpeg_tpu_torch.ops import dmvr as DM
  from ffmpeg_tpu_torch.ops import inter as P
  from ffmpeg_tpu_torch.ops import lmcs as L
  from ffmpeg_tpu_torch.ops import recon as R
  from ffmpeg_tpu_torch.ops import sao as S
  from ffmpeg_tpu_torch.ops import transform as T

  launches = {"inter_pred": P.LAUNCHES, "recon": R.LAUNCHES,
              "deblock": D.LAUNCHES, "alf": A.LAUNCHES,
              "residual": T.LAUNCHES, "sao": S.LAUNCHES,
              "lmcs_inv": L.LAUNCHES, "dmvr": DM.LAUNCHES}
  called, frame = set(), []

  def per_call(name, kw):
    """Launches counted per call: recon, deblock, alf and dmvr 1; inter_pred 1
    per size class that has units; residual 1 per work group that has
    TUs."""
    if name == "residual":
      return sum(g["items"] > 0 for g in T.launch_plan(T._classes(**kw)[1]))
    if name != "inter_pred":
      return 1
    return sum(len(kw["inter"][k + "_host"]) > 0 for k in ("small", "large"))

  def check(name, label, kw):
    kernel, plain = KERNELS[name]
    want = plain(**kw)
    before = launches[name][name]
    for i in range(repeats):
      got = kernel(**kw)
      assert torch.equal(got, want), f"{name} {label} launch {i}"
    assert launches[name][name] == before + repeats * per_call(name, kw)
    called.add(name)
    frame.append(name)
    if kinds is not None and name == "recon":
      kinds.update(unit_kinds(kw))
    return got

  aus = VVCDecoder(device=device)._split_aus(data)[:n_frames]
  for fs, h in walk_frames(aus, device, check):
    # the SAO and LMCS kernels' calls, as the frame's inputs ask
    mono = fs.chroma_format_idc == 0
    assert frame.count("sao") == ("sao" in h) * (1 if mono else 2)
    assert frame.count("lmcs_inv") == ("lmcs" in h)
    frame.clear()
  return called


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ai256x128_10b", "ai720"])
def test_recon_kernel_matches_plain_on_card(cuda, name):
  assert _kernels_vs_plain(_read(name), cuda, n_frames=1) == {
      "residual", "recon", "deblock", "sao"}


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_frames", [("ra1080", 3), ("ai720", 1)])
def test_recon_kernel_repeats_match_plain_on_card(cuda, name, n_frames):
  """The race check of the recon kernel's dataflow wavefront, whose
  order of work differs from launch to launch: every kernel call of the
  first frames in decode order (ra1080: POC 0, 4 and the B frame POC 2;
  ai720: frame 0) launched 20 times, each equal to the plain version."""
  assert "recon" in _kernels_vs_plain(_read(name), cuda, n_frames,
                                      repeats=20)


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("chan", ["y", "cb", "cr"])
@pytest.mark.parametrize("wrap", [0, 1])
@pytest.mark.parametrize("tools", ["", "dmvr-lmcs"])
def test_inter_kernel_matches_plain_random(cuda, bd, chan, wrap, tools):
  """The inter-prediction kernel against its plain version on seeded
  random MC batches with every mode (tests/torch_mc_rows.py): Cr through
  a two-channel call, wraparound on and off; pure inter rows, then CIIP
  rows; small and large units both launched.  With dmvr-lmcs, a third of
  the units are DMVR units whose refined reads cross their original
  window, and luma is mapped through a random LMCS table."""
  from ffmpeg_tpu_torch.models.vvc.convert import _inter, _lmcs
  from ffmpeg_tpu_torch.ops import inter as P
  from torch_mc_rows import batch, random_lmcs, random_rows

  rng = np.random.default_rng(1000 * bd + 10 * ("y", "cb", "cr").index(chan)
                              + wrap + (7 if tools else 0))
  is_chroma = chan != "y"
  H, W, n_refs = (24, 40, 3) if is_chroma else (48, 80, 3)
  refs = [[torch.from_numpy(rng.integers(0, 1 << bd, (H, W)).astype(
      np.int32)).to(cuda) for _ in range(n_refs)]
          for _ in range(2 if chan == "cr" else 1)]
  rows, gwt, gslot = random_rows(rng, 192, H, W, n_refs, is_chroma, bd,
                                 dmvr=bool(tools))
  inter = _inter(batch(rows, gwt, gslot, is_chroma), 128, cuda)
  kw = dict(H=H, W=W, is_chroma=is_chroma, bit_depth=bd,
            wrap=W - 8 if wrap else 0)
  if tools and not is_chroma:
    kw["lmcs"] = _lmcs(random_lmcs(rng, bd), cuda)
  want = P.inter_pred_plain_kind(refs, inter, **kw)
  before = dict(P.CLASS_LAUNCHES)
  got = P.inter_pred(refs, inter, **kw)
  assert torch.equal(got, want)
  assert all(P.CLASS_LAUNCHES[k] == before[k] + 1 for k in before)


# a malformed MC batch, made from a good one: the kernel traps on it
MALFORMED = ("large-unit-in-small-list", "toff-shifted")

_MALFORMED_SCRIPT = """
import os
import sys
import numpy as np
import torch
from ffmpeg_tpu_torch.models.vvc.convert import _inter
from ffmpeg_tpu_torch.models.vvc.inputs import SMALL_AREA
from ffmpeg_tpu_torch.ops import inter as P
from torch_mc_rows import batch, random_rows

rng = np.random.default_rng(7)
H, W = 48, 80
refs = [[torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.int32))
         .cuda() for _ in range(3)]]
rows, gwt, gslot = random_rows(rng, 192, H, W, 3, False, 8)
b = batch(rows, gwt, gslot, False)
area = np.maximum(b["w"], 4) * np.maximum(b["h"], 4)
if sys.argv[1] == "large-unit-in-small-list":
  big = int(np.flatnonzero(area > SMALL_AREA)[0])
  b["small"] = np.append(b["small"], big).astype(np.int32)
  b["large"] = b["large"][b["large"] != big]
else:
  b["toff"] = b["toff"].copy()
  b["toff"][1:-1] += 1
inter = _inter(b, 128, "cuda")
try:
  P.inter_pred(refs, inter, H=H, W=W, is_chroma=False, bit_depth=8)
  torch.cuda.synchronize()
except RuntimeError as e:
  print("failed:", str(e).splitlines()[0], flush=True)
  os._exit(3)  # no teardown in the failed CUDA context
sys.exit(0)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("broken", MALFORMED)
def test_inter_kernel_traps_malformed_batch(cuda, broken):
  """The kernel checks each unit against its class and the tile offsets
  (the wrapper's host checks are O(1)): a unit too large for the small
  class, or toff that is not the prefix sum of w * h, makes the launch
  fail instead of writing outside the unit's buffers.  A trap ends the
  CUDA context, so each case runs in a process of its own."""
  env = dict(os.environ, PYTHONPATH=os.pathsep.join(
      [ROOT, os.path.dirname(os.path.abspath(__file__))]))
  proc = subprocess.run([sys.executable, "-c", _MALFORMED_SCRIPT, broken],
                        capture_output=True, text=True, env=env, timeout=600)
  assert proc.returncode == 3, proc.stdout + proc.stderr


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
  last = [kw for kernel, kw in calls if kernel == "recon"][-2:]
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
  """Every kernel against its plain version on every frame of a P/B
  case, with the frame's real references."""
  called = _kernels_vs_plain(_stream(INTER_CASES[case]), cuda)
  assert called - {"deblock", "alf", *FILTER_KERNELS} == {
      "residual", "inter_pred", "recon"}
  assert "deblock" in called or not INTER_CASES[case].get("deblock")
  assert ("alf" in called) == bool(INTER_CASES[case].get("alf"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dmvr-bdof-tmvp", "alf-lmcs-ra"])
def test_kernels_match_plain_on_card_tools(cuda, case):
  """Every kernel against its plain version on every frame of a stream
  with DMVR (its search kernel and the refined controls run in the walk)
  or with LMCS and ALF, with the frame's real references."""
  called = _kernels_vs_plain(_stream(TOOL_CASES[case]), cuda)
  assert called - {"deblock", "alf", "dmvr", *FILTER_KERNELS} == {
      "residual", "inter_pred", "recon"}
  assert ("dmvr" in called) == bool(TOOL_CASES[case].get("dmvr"))
  assert "lmcs_inv" in called or not TOOL_CASES[case].get("lmcs")
  assert "deblock" in called or not TOOL_CASES[case].get("deblock")
  assert ("alf" in called) == bool(TOOL_CASES[case].get("alf"))


def _counts_zeroed():
  from ffmpeg_tpu_torch.ops import alf as A
  from ffmpeg_tpu_torch.ops import deblock as D
  from ffmpeg_tpu_torch.ops import inter as P
  from ffmpeg_tpu_torch.ops import recon as R
  from ffmpeg_tpu_torch.ops import transform as T

  from ffmpeg_tpu_torch.ops import lmcs as L
  from ffmpeg_tpu_torch.ops import sao as S

  for d in (P.LAUNCHES, P.CLASS_LAUNCHES, P.PLAIN_RUNS, R.LAUNCHES,
            R.EDGE_LAUNCHES, R.PLAIN_RUNS, D.LAUNCHES, D.PLAIN_RUNS,
            A.LAUNCHES, A.PLAIN_RUNS, T.LAUNCHES, T.CALLS, T.GROUP_LAUNCHES,
            T.PLAIN_RUNS, S.LAUNCHES, S.PLAIN_RUNS, L.LAUNCHES,
            L.PLAIN_RUNS):
    for k in d:
      d[k] = 0
  return P, R


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(INTRA_CASES))
def test_intra_case_decodes_on_card(cuda, case):
  """The kernel path on every intra case: CTU 64 (32-wide chroma
  units), 10/12-bit, 4:0:0, tiles, WPP, cropping; the residual wrapper
  called once a 4:0:0 frame, twice a 4:2:0 frame, each call launching
  one to three work groups."""
  from ffmpeg_tpu_torch.ops import transform as T

  with open(CASES_JSON) as f:
    want = json.load(f)[case]["md5"]
  _, R = _counts_zeroed()
  assert _port_md5s(_stream(INTRA_CASES[case]), device=cuda) == want
  assert R.PLAIN_RUNS["recon"] == 0 and T.PLAIN_RUNS["residual"] == 0
  mono = INTRA_CASES[case].get("chroma_format_idc") == 0
  calls = (1 if mono else 2) * len(want)
  assert T.CALLS["residual"] == calls
  assert calls <= T.LAUNCHES["residual"] <= 3 * calls
  assert sum(T.GROUP_LAUNCHES.values()) == T.LAUNCHES["residual"]


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
@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_tool_case_decodes_on_card(cuda, case):
  """Every LMCS, ALF and DMVR case through both kernels (the intra-only
  ones through recon) to the JAX MD5s."""
  with open(TOOLS_JSON) as f:
    want = json.load(f)[case]["md5"]
  P, R = _counts_zeroed()
  assert _port_md5s(_stream(TOOL_CASES[case]), device=cuda) == want
  assert R.LAUNCHES["recon"] > 0
  assert (P.LAUNCHES["inter_pred"] > 0) == bool(TOOL_CASES[case].get("inter"))
  assert P.PLAIN_RUNS["inter_pred"] == 0 and R.PLAIN_RUNS["recon"] == 0


# coding cases held kernel by kernel on the card, and the unit kinds each
# must reach
CODING_ON_CARD = {"tb64": {"edge64"}, "ctu128-tools-ra": {"edge64"},
                  "isp": {"high2"}, "isp-dualtree": {"high1", "cell1"},
                  "isp-inter": {"high1", "cell1"}, "ciip64": {"ciip64"},
                  "scaling-inter": set()}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CODING_ON_CARD))
def test_kernels_match_plain_on_card_coding(cuda, case):
  """Both kernels (recon alone on intra-only cases) against their plain
  versions on every frame of the ISP, TB-64 and scaling-list cases,
  each recon call launched 5 times (the race check at cell 1 and in the
  64-edge instance): 64-edge luma units, 1-high ISP sub-partitions, a
  64x64 CIIP unit from its four MC rows."""
  kinds = set()
  called = _kernels_vs_plain(_stream(CODING_CASES[case]), cuda, repeats=5,
                             kinds=kinds)
  assert "recon" in called
  assert ("inter_pred" in called) == bool(CODING_CASES[case].get("inter"))
  assert CODING_ON_CARD[case] <= kinds, kinds


@pytest.mark.gpu
def test_kernels_match_plain_on_card_ctu128_1080(cuda):
  """Both kernels on the ctu128_1080 fixture's I frame (ISP at cell 1,
  64-edge luma units, MIP) and first B frame, each call launched 3
  times."""
  kinds = set()
  assert _kernels_vs_plain(_read("ctu128_1080"), cuda, n_frames=2, repeats=3,
                           kinds=kinds) == {"residual", "inter_pred",
                                            "recon", "deblock", "alf", "sao",
                                            "lmcs_inv"}
  assert {"edge64", "high1", "cell1"} <= kinds, kinds


@pytest.mark.gpu
def test_recon_kernel_mip64_on_card(cuda):
  """The 64-edge wavefront against the plain version on the tb64 case's
  luma with its 64x64 units turned into MIP units (make_mip64), 5
  launches."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.inputs import INTRA_KEYS
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  edited = []

  def check(name, label, kw):
    kernel, plain = KERNELS[name]
    if name == "recon" and label == "luma":
      intra = dict(kw["intra"])
      mh = intra["mat_host"].copy()
      n = int(intra["iend_host"][-1])
      edited.append(len(make_mip64(
          {k: mh[i] for i, k in enumerate(INTRA_KEYS)}, n)))
      intra["mat_host"], intra["mat"] = mh, torch.from_numpy(mh).to(cuda)
      intra.update({k: intra["mat"][i] for i, k in enumerate(INTRA_KEYS)})
      mip = dict(kw, intra=intra)
      assert kw["maxs"] == 64
      want = plain(**mip)
      for _ in range(5):
        assert torch.equal(kernel(**mip), want)
    return kernel(**kw)

  aus = VVCDecoder(device=cuda)._split_aus(_stream(CODING_CASES["tb64"]))
  for _ in walk_frames(aus, cuda, check):
    pass
  assert edited and min(edited) > 0


@pytest.mark.gpu
def test_recon_wave_instance(cuda):
  """Frames without 64-edge units keep the 32-edge wavefront: full1080's
  first frame launches only it; ctu128_1080's luma launches the 64-edge
  instance."""
  from ffmpeg_tpu_torch.ops import recon as R

  for name, want in (("full1080", {32}), ("ctu128_1080", {32, 64})):
    _counts_zeroed()
    _kernels_vs_plain(_read(name), cuda, n_frames=1)
    assert {k for k, v in R.EDGE_LAUNCHES.items() if v} == want, name


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CODING_CASES))
def test_coding_case_decodes_on_card(cuda, case):
  """Every ISP, TB-64/CTU-128, scaling-list and CIIP-64 case through the
  kernels to the JAX MD5s."""
  with open(CODING_JSON) as f:
    want = json.load(f)[case]["md5"]
  P, R = _counts_zeroed()
  assert _port_md5s(_stream(CODING_CASES[case]), device=cuda) == want
  assert R.LAUNCHES["recon"] > 0
  assert (P.LAUNCHES["inter_pred"] > 0) == bool(
      CODING_CASES[case].get("inter"))
  assert P.PLAIN_RUNS["inter_pred"] == 0 and R.PLAIN_RUNS["recon"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ai256x128_10b", "ai720", "ra1080",
                                  "full1080", "ctu128_1080", "ciip64",
                                  "gop720"])
def test_fixture_decodes_on_card(cuda, name):
  """Each fixture to its MD5s through the kernels: the residual wrapper
  twice a frame (luma; Cb and Cr; one to three launches each), the ALF
  and SAO kernels twice on each frame with ALF or SAO on, the LMCS
  inverse map once on each frame with LMCS on (the traced alf, sao and
  lmcs spans count those frames), no LMCS kernel launch of the chroma
  scales (the chroma residual call derives them), no plain version
  run."""
  from ffmpeg_tpu_torch.ops import alf as A
  from ffmpeg_tpu_torch.ops import deblock as D
  from ffmpeg_tpu_torch.ops import lmcs as L
  from ffmpeg_tpu_torch.ops import sao as S
  from ffmpeg_tpu_torch.ops import transform as T
  from ffmpeg_tpu_torch.utils import trace

  P, R = _counts_zeroed()
  trace.reset()
  trace.enable(True)
  try:
    got = _port_md5s(_read(name), device=cuda)
    assert got == _fixture_md5s(name)
  finally:
    trace.enable(False)
  spans = trace.summary()
  alf_frames = spans.get("alf", {}).get("n", 0)
  assert R.LAUNCHES["recon"] > 0 and D.LAUNCHES["deblock"] > 0
  assert (P.LAUNCHES["inter_pred"] > 0) == (not name.startswith("ai"))
  assert R.PLAIN_RUNS["recon"] == 0 and P.PLAIN_RUNS["inter_pred"] == 0
  assert D.PLAIN_RUNS["deblock"] == 0 and A.PLAIN_RUNS["alf"] == 0
  assert T.CALLS["residual"] == 2 * len(got)
  assert 2 * len(got) <= T.LAUNCHES["residual"] <= 6 * len(got)
  assert T.PLAIN_RUNS["residual"] == 0
  assert (alf_frames > 0) == (name in ("full1080", "ctu128_1080", "gop720"))
  assert A.LAUNCHES["alf"] == 2 * alf_frames
  frames = {k: spans.get(k, {}).get("n", 0) for k in ("sao", "lmcs")}
  assert frames == FIXTURE_FILTER_FRAMES[name]
  assert S.LAUNCHES["sao"] == 2 * frames["sao"]
  assert L.LAUNCHES == {"lmcs_inv": frames["lmcs"]}
  assert S.PLAIN_RUNS["sao"] == 0 and not any(L.PLAIN_RUNS.values())


# DMVR-free single-IRAP-period cases for the wave path on the card:
# (config, the JSON of their JAX MD5s)
GOP_ON_CARD = {"alf-lmcs-ra": (TOOL_CASES["alf-lmcs-ra"], TOOLS_JSON),
               "gpm-tools-ra": (TOOL_CASES["gpm-tools-ra"], TOOLS_JSON),
               "tmvp-ra": (INTER_CASES["tmvp-ra"], INTER_JSON)}


def _gop_case(case):
  """(stream, JAX MD5s) of a GOP_ON_CARD case."""
  kw, path = GOP_ON_CARD[case]
  with open(path) as f:
    return _stream(kw), json.load(f)[case]["md5"]


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(GOP_ON_CARD))
def test_gop_decode_on_card(cuda, case, streams):
  """The wave path (parallel/gop.py) on the card at stream widths 1, 2
  and 4: the JAX package's sequential MD5s, through both kernels."""
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  data, want = _gop_case(case)
  P, R = _counts_zeroed()
  got = decode_gop_mesh(data, make_mesh(frame_axis=1), streams=streams)
  assert [md5 for _, md5, _ in got] == want
  assert P.LAUNCHES["inter_pred"] > 0 and R.LAUNCHES["recon"] > 0
  assert P.PLAIN_RUNS["inter_pred"] == 0 and R.PLAIN_RUNS["recon"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("frame_axis", [2, 4])
def test_gop_decode_across_cards(cuda, frame_axis):
  """The wave path over `frame_axis` cards: the pool split across them,
  a frame's reads of another card's slots and its write into one copied
  between cards; the JAX MD5s, as on one card."""
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  if torch.cuda.device_count() < frame_axis:
    pytest.skip(f"needs {frame_axis} CUDA cards")
  mesh = make_mesh(frame_axis, frame_axis=frame_axis)
  for case in sorted(GOP_ON_CARD):
    data, want = _gop_case(case)
    got = decode_gop_mesh(data, mesh, streams=2)
    assert [md5 for _, md5, _ in got] == want, case
  got = decode_gop_mesh(_read("gop720"), mesh)
  assert [md5 for _, md5, _ in got] == _fixture_md5s("gop720")


@pytest.mark.gpu
def test_tiled_filters_across_cards(cuda):
  """The band-split deblock, SAO and ALF with one band per card equal the
  whole-plane ops on the first card."""
  from ffmpeg_tpu_torch.ops.deblock import deblock_pass
  from ffmpeg_tpu_torch.ops.sao import sao_plane
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh
  from ffmpeg_tpu_torch.parallel.spatial import (alf_luma_tiled,
                                                 deblock_vertical_tiled,
                                                 sao_plane_tiled)

  n = torch.cuda.device_count()
  if n < 2:
    pytest.skip("needs 2 or more CUDA cards")
  mesh = make_mesh(n, frame_axis=1)
  rng = np.random.default_rng(31)

  def t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

  H, W, ctb = 256, 192, 32
  plane = t(rng.integers(0, 256, (H, W), dtype=np.int32))
  S, E = H // 4, W // 4
  bs = rng.integers(0, 3, (S, E), dtype=np.int32)
  bs[:, 0] = 0
  db = [t(a) for a in (bs, rng.integers(18, 45, (S, E), dtype=np.int32),
                       rng.choice([1, 3, 7], (S, E)).astype(np.int32),
                       rng.choice([1, 3, 7], (S, E)).astype(np.int32),
                       np.zeros((S, E), np.int32))]
  assert torch.equal(
      deblock_vertical_tiled(plane, *db, bit_depth=8, mesh=mesh),
      deblock_pass([plane], [tuple(db)], chroma=False, horizontal=False,
                   bit_depth=8, beta_off=(0,), tc_off=(0,))[0])
  cb = (H // ctb, W // ctb)
  sao = [t(rng.integers(0, 3, cb, dtype=np.int32)),
         t(rng.integers(0, 28, cb, dtype=np.int32)),
         t(rng.integers(-12, 13, cb + (5,), dtype=np.int32)),
         t(rng.integers(0, 4, cb, dtype=np.int32))]
  assert torch.equal(
      sao_plane_tiled(plane, *sao, W - 8, H - 8, ctb=ctb, bit_depth=8,
                      mesh=mesh),
      sao_plane(plane, *sao, W - 8, H - 8, ctb=ctb, bit_depth=8))
  bank = t(rng.integers(0, 16, cb, dtype=np.int32))
  flag = t(rng.integers(0, 2, cb, dtype=np.int32))
  bco = t(rng.integers(-32, 33, (16, 25, 12), dtype=np.int32))
  bcl = t(rng.choice([256, 32, 8, 2], (16, 25, 12)).astype(np.int32))
  one = make_mesh(1, frame_axis=1)
  assert torch.equal(
      alf_luma_tiled(plane, bank, flag, bco, bcl, ctb=ctb, bit_depth=8,
                     mesh=mesh),
      alf_luma_tiled(plane, bank, flag, bco, bcl, ctb=ctb, bit_depth=8,
                     mesh=one))


@pytest.mark.gpu
def test_gop_kernels_match_plain_on_card(cuda):
  """Every kernel call of the wave path at width 4, on its own stream,
  against its plain version on the same card tensors; each recon call
  launched 5 times (the race check, with other streams' launches in
  flight)."""
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  checked = []

  def check(name, label, kw):
    kernel, plain = KERNELS[name]
    want = plain(**kw)
    for _ in range(5 if name == "recon" else 1):
      got = kernel(**kw)
      assert torch.equal(got, want), f"{name} {label}"
    checked.append(name)
    return got

  data, want = _gop_case("alf-lmcs-ra")
  got = decode_gop_mesh(data, make_mesh(frame_axis=1), streams=4, call=check)
  assert [md5 for _, md5, _ in got] == want
  assert checked.count("recon") == 2 * len(got)
  assert checked.count("deblock") == 2 * len(got)
  assert checked.count("residual") == 2 * len(got)


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
def test_full1080_fixture_regenerates():
  """The committed full-toolset 1080p fixture is the generator's output
  for its config (bench.py FULL_KW with 5 frames), and its MD5s are the
  JAX package's decode (~5 min)."""
  from bench import FULL_KW

  with open(os.path.join(TESTDATA, "full1080.md5.json")) as f:
    fixture = json.load(f)
  assert fixture["config"] == dict(FULL_KW, n_frames=5)
  data = _stream(fixture["config"])
  assert data == _read("full1080")
  assert _jax_md5s(data) == fixture["md5"]


@pytest.mark.slow
def test_ctu128_1080_fixture_regenerates():
  """The committed CTU-128 1080p fixture is the generator's output for
  its config (bench.py FULL_KW with 5 frames, seed 29, CTU-128, TB-64,
  ISP, scaling lists and LFNST; CIIP and GPM off), and its MD5s are the
  JAX package's decode (~5 min)."""
  from bench import FULL_KW

  with open(os.path.join(TESTDATA, "ctu128_1080.md5.json")) as f:
    fixture = json.load(f)
  assert fixture["config"] == dict(
      FULL_KW, n_frames=5, seed=29, ctu_log2=7, tb64=True, min_qt_size=32,
      max_mtt_depth=1, max_bt_size=64, max_tt_size=64, isp=True,
      scaling_lists=True, lfnst=True, ciip=False, gpm=False)
  data = _stream(fixture["config"])
  assert data == _read("ctu128_1080")
  assert _jax_md5s(data) == fixture["md5"]


@pytest.mark.slow
def test_gop720_fixture_regenerates():
  """The committed 720p wave-path fixture is the generator's output for
  its config (bench.py FULL_KW at 1280x720, 9 frames, DMVR off), its
  MD5s are the JAX package's sequential decode, and the JAX wave path
  gives them too (~10 min)."""
  from bench import FULL_KW
  from ffmpeg_tpu.parallel.gop import decode_gop_mesh
  from ffmpeg_tpu.parallel.mesh import make_mesh

  with open(os.path.join(TESTDATA, "gop720.md5.json")) as f:
    fixture = json.load(f)
  assert fixture["config"] == dict(FULL_KW, dmvr=False, width=1280,
                                   height=720, n_frames=9)
  data = _stream(fixture["config"])
  assert data == _read("gop720")
  assert _jax_md5s(data) == fixture["md5"]
  assert [m for _, m, _ in decode_gop_mesh(data, make_mesh(
      2, frame_axis=2))] == fixture["md5"]


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CODING_CASES))
def test_coding_case_jax_live(case):
  data = _stream(CODING_CASES[case])
  assert _port_md5s(data) == _jax_md5s(data)


@pytest.mark.slow
@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_tool_case_jax_live(case):
  data = _stream(TOOL_CASES[case])
  assert _port_md5s(data) == _jax_md5s(data)


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
  """Regenerate intra_cases.md5.json, inter_cases.md5.json (with the
  missing-ref entry), tools_cases.md5.json and coding_cases.md5.json
  with the JAX package's decoder, one decode at a time."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  for cases, path in ((INTRA_CASES, CASES_JSON), (INTER_CASES, INTER_JSON),
                      (TOOL_CASES, TOOLS_JSON), (CODING_CASES, CODING_JSON)):
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
