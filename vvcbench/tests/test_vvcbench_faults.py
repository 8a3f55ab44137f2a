"""A run with its timed path broken underneath comes out not correct:
the harness's measure (everything a run does but its look for a card)
on the CPU, at a small size, with the port's session wrapped so that it
yields wrong frames.  The cells run on one card, so there is no exchange
between cards to leave out."""
import json
import shutil
import time

import pytest

from vvcbench import cells, harness

GEN = {"width": 64, "height": 64, "n_frames": 5, "seed": 3, "qp": 32,
       "inter": True, "b_slices": True, "ra": True, "tmvp": True,
       "deblock": True, "sao": True, "alf": True, "ccalf": True,
       "lmcs": True, "dmvr": True, "bdof": True}


@pytest.fixture(scope="module")
def setup(tmp_path_factory, write_truth):
  root = tmp_path_factory.mktemp("vvcbench")
  shutil.copytree(cells.ROOT, root, dirs_exist_ok=True,
                  ignore=shutil.ignore_patterns("frozen", ".cache",
                                                "__pycache__", "tests"))
  tiny = {"source": "x", "generator": GEN, "reduced": [], "assumed": []}
  (root / "configs" / "tiny.json").write_text(json.dumps(tiny))
  write_truth(root, "tiny", tiny, [3, 4, 5])
  bench = cells.load_benchmark()
  bench["workloads"].append({"name": "tiny.single", "config": "tiny",
                             "traffic": "single", "chips": 1, "why": "x"})
  for m in bench["end_to_end"] + bench["per_layer"]:
    if "ai720.single" in m.get("workloads", []):
      m["workloads"].append("tiny.single")
  return cells.resolve("tiny.single", bench, str(root)), root


def _port(device="cpu"):
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  return VVCDecoder(device=device, host_threads=2)


class Wrapped:
  """The port's session with `fault(frames)` applied to what it
  yields."""

  def __init__(self, fault):
    self.dec, self.fault = _port(), fault

  def decode(self, data, fetch=True):
    return self.fault(self.dec.decode(data, fetch=fetch))


def unchanged(frames):
  """Each frame after the first hands out its predecessor's samples: a
  step that returns its state unchanged."""
  prev = None
  for f in frames:
    if prev is not None:
      f.buf = prev
    prev = f.buf
    yield f


def half_left_out(frames):
  """Every other frame left out."""
  for i, f in enumerate(frames):
    if i % 2 == 0:
      yield f


def altered(frames):
  """One sample of each third frame altered where it is produced."""
  for i, f in enumerate(frames):
    if i % 3 == 2:
      f.buf = f.buf.clone()
      f.buf[7] ^= 1
    yield f


def _run(setup, make_decoder=None):
  cell, root = setup
  rec = harness.measure(cell, 2**31 + 11, 4.0, False, "cpu",
                        time.perf_counter(), cache=str(root / ".cache"),
                        make_decoder=make_decoder)
  return harness.result_line(cell, rec, False, "cpu", "none", str(root))


def test_sound_run_is_correct(setup):
  line = _run(setup)
  assert line["correct"] is True and line["attempted"] > 0
  assert list(line)[-1] == "compared"
  assert set(line["metrics"]) == {"fps.single", "setup_s"}
  # the window starts at the pool's stream that the seed picks, and
  # every frame it counted was compared
  assert line["run"]["first"] == (2**31 + 11) % 3
  assert line["attempted"] == line["run"]["frames"]


def test_a_stream_other_than_the_truths_is_not_correct(setup):
  cell, root = setup
  path = root / "truth" / "tiny" / "4.json"
  saved = path.read_text()
  entry = json.loads(saved)
  try:
    path.write_text(json.dumps(dict(entry, sha256="0" * 64)))
    line = _run(setup)
  finally:
    path.write_text(saved)
  assert line["correct"] is False
  assert line["compared"]["stream_differs"]["value"] == 1


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(setup, fault):
  line = _run(setup, lambda: Wrapped(fault))
  assert line["correct"] is False
  assert line["failed"] > 0
