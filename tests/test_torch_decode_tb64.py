"""The port decodes the 64-sample transform block cases (TB-64, CTU-128)
of tests/test_conformance.py, and the CIIP-64 case, on the CPU to the
JAX package's frame MD5s (testdata/coding_cases.md5.json, regenerated by
`python tests/test_torch_decode.py`).  The ISP and scaling-list cases
are in test_torch_decode_isp_sl.py, so that two test workers share
them."""
import json
import os

import pytest

from test_torch_decode import (CODING_CASES, CODING_JSON, TESTDATA, _port_md5s,
                               _stream)

CASES = [c for c in CODING_CASES if c.startswith(("tb64", "ctu128", "ciip"))]


@pytest.mark.parametrize("case", CASES)
def test_coding_case_matches_jax(case):
  with open(CODING_JSON) as f:
    want = json.load(f)[case]
  assert want["config"] == json.loads(json.dumps(CODING_CASES[case]))
  assert _port_md5s(_stream(CODING_CASES[case])) == want["md5"]


def _fixture(name):
  return os.path.join(TESTDATA, name)


def test_ciip64_fixture_is_the_case():
  """testdata/ciip64.vvc, which chip_smoke.py decodes on the card, is the
  generator's output for the ciip64 case, with the case's JAX MD5s."""
  with open(CODING_JSON) as f:
    want = json.load(f)["ciip64"]
  with open(_fixture("ciip64.md5.json")) as f:
    fixture = json.load(f)
  assert fixture == want
  with open(_fixture("ciip64.vvc"), "rb") as f:
    assert f.read() == _stream(CODING_CASES["ciip64"])


def test_ctu128_1080_fixture_matches_jax():
  """The committed CTU-128 1080p fixture (TB-64, ISP, scaling lists,
  LFNST, DMVR, LMCS, ALF) decodes on the CPU to its JAX MD5s."""
  with open(_fixture("ctu128_1080.md5.json")) as f:
    want = json.load(f)["md5"]
  with open(_fixture("ctu128_1080.vvc"), "rb") as f:
    assert _port_md5s(f.read()) == want
