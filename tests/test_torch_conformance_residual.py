"""The port decodes the residual-coding (MTS, dependent quantisation, sign
hiding, joint CbCr, transform skip and BDPCM, LFNST, QP delta) configs
of tests/test_conformance.py that no other port test decodes, on the
CPU, to the JAX package's frame MD5s
(ffmpeg_tpu_torch/testdata/conformance_cases.md5.json, regenerated by
`python tests/torch_conformance_cases.py`)."""
import json

import pytest

from test_torch_decode import _port_md5s, _stream
from torch_conformance_cases import RESIDUAL_CASES, committed


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_residual_case_matches_jax(case):
  want = committed(case)
  assert want["config"] == json.loads(json.dumps(RESIDUAL_CASES[case]))
  assert _port_md5s(_stream(RESIDUAL_CASES[case])) == want["md5"]
