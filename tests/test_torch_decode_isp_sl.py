"""The port decodes the ISP and explicit scaling-list cases of
tests/test_conformance.py on the CPU to the JAX package's frame MD5s
(testdata/coding_cases.md5.json, regenerated by `python
tests/test_torch_decode.py`).  The TB-64 cases are in
test_torch_decode_tb64.py."""
import json

import pytest

from test_torch_decode import CODING_CASES, CODING_JSON, _port_md5s, _stream

CASES = [c for c in CODING_CASES if c.startswith(("isp", "scaling"))]


@pytest.mark.parametrize("case", CASES)
def test_coding_case_matches_jax(case):
  with open(CODING_JSON) as f:
    want = json.load(f)[case]
  assert want["config"] == json.loads(json.dumps(CODING_CASES[case]))
  assert _port_md5s(_stream(CODING_CASES[case])) == want["md5"]
