"""The port decodes the intra-tool (MIP, MRL, CCLM, dual tree, 4:0:0,
CTU-64) configs of tests/test_conformance.py that no other port test
decodes, on the CPU, to the JAX package's frame MD5s
(ffmpeg_tpu_torch/testdata/conformance_cases.md5.json, regenerated by
`python tests/torch_conformance_cases.py`)."""
import json

import pytest

from test_torch_decode import _port_md5s, _stream
from torch_conformance_cases import INTRA_CASES, committed


@pytest.mark.parametrize("case", list(INTRA_CASES))
def test_intra_tool_case_matches_jax(case):
  want = committed(case)
  assert want["config"] == json.loads(json.dumps(INTRA_CASES[case]))
  assert _port_md5s(_stream(INTRA_CASES[case])) == want["md5"]
