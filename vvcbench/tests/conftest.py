"""The benchmark's own tests: `python -m pytest vvcbench/tests` from the
root of the repository (the CPU ones), and on a card
`python -m pytest -m gpu vvcbench/tests`."""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
  sys.path.insert(0, REPO)


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "gpu: needs a CUDA card (python -m pytest -m gpu "
      "vvcbench/tests)")


@pytest.fixture
def cuda():
  """Skips the test where torch sees no CUDA card."""
  import torch

  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda")


@pytest.fixture(scope="session")
def write_truth():
  return _write_truth


def _write_truth(root, config_name, config, gen_seeds):
  """truth/<config>/<seed>.json under `root` for a configuration small
  enough for the CPU, from the frozen plain path (the JAX package's
  decode agrees with it on the committed cases,
  test_vvcbench_generator.py); returns the streams."""
  import hashlib
  import json

  from vvcbench import compare, reference, streams
  from vvcbench.frozen.encoder import config_from_json, encode_stream

  d = os.path.join(str(root), "truth", config_name)
  os.makedirs(d, exist_ok=True)
  out = []
  for s in gen_seeds:
    kw = streams.generator_kwargs(config, s)
    data = encode_stream(config_from_json(kw))[0]
    entry = {"seed": s, "generator": kw, "bytes": len(data),
             "sha256": hashlib.sha256(data).hexdigest(),
             "md5": [compare.md5(f) for f in reference.decode(data, "cpu")]}
    with open(os.path.join(d, f"{s}.json"), "w") as f:
      json.dump(entry, f)
    out.append(data)
  return out
