"""The port decodes the inter-tool (TMVP, SbTMVP, CIIP, GPM, weighted
prediction, SBT, MMVD, random access, LTR and RPL signalling,
wraparound) configs of tests/test_conformance.py that no other port test
decodes, on the CPU, to the JAX package's frame MD5s
(ffmpeg_tpu_torch/testdata/conformance_cases.md5.json, regenerated by
`python tests/torch_conformance_cases.py`)."""
import json

import pytest

from test_torch_decode import _port_md5s, _stream
from torch_conformance_cases import INTER_CASES, committed


@pytest.mark.parametrize("case", list(INTER_CASES))
def test_inter_tool_case_matches_jax(case):
  want = committed(case)
  assert want["config"] == json.loads(json.dumps(INTER_CASES[case]))
  assert _port_md5s(_stream(INTER_CASES[case])) == want["md5"]
