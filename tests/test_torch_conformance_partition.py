"""The port decodes the picture-partition (tiles, WPP, raster and
rectangular slices, a separate picture header) configs of
tests/test_conformance.py that no other port test decodes, on the CPU,
to the JAX package's frame MD5s
(ffmpeg_tpu_torch/testdata/conformance_cases.md5.json, regenerated by
`python tests/torch_conformance_cases.py`). Also: these 62 configs and
the port's other case files together hold every config of
tests/test_conformance.py, with its id and config."""
import json

import pytest

from test_torch_decode import _port_md5s, _stream
from torch_conformance_cases import PARTITION_CASES, committed


@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_partition_case_matches_jax(case):
  want = committed(case)
  assert want["config"] == json.loads(json.dumps(PARTITION_CASES[case]))
  assert _port_md5s(_stream(PARTITION_CASES[case])) == want["md5"]


def _conformance_configs():
  """{id: config} of tests/test_conformance.py's parametrize list, read
  from its syntax tree (the file does not import: ROADMAP C4)."""
  import ast
  import os

  path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_conformance.py")
  with open(path) as f:
    tree = ast.parse(f.read())
  call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
              and getattr(n.func, "attr", "") == "parametrize"
              and ast.literal_eval(n.args[0]) == "cfg_kw")
  cfgs = [{k.arg: ast.literal_eval(k.value) for k in d.keywords}
          for d in call.args[1].elts]
  ids = ast.literal_eval(call.args[2].slice)
  return dict(zip(ids, cfgs, strict=True))


def test_cases_are_the_conformance_configs():
  import glob

  from test_torch_decode import TESTDATA
  from torch_conformance_cases import ALL_CASES, CONFORMANCE_JSON

  conf = _conformance_configs()
  assert len(conf) == 152 and len(ALL_CASES) == 62
  assert {k: conf[k] for k in ALL_CASES} == ALL_CASES
  held = {}
  for path in glob.glob(f"{TESTDATA}/*_cases.md5.json"):
    with open(path) as f:
      held.update({k: v["config"] for k, v in json.load(f).items()
                   if k in conf})
  assert set(held) == set(conf)
  assert held == json.loads(json.dumps(conf))
  with open(CONFORMANCE_JSON) as f:
    assert set(json.load(f)) == set(ALL_CASES)
