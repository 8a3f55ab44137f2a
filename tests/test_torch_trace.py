"""The port's span store (`ffmpeg_tpu_torch/utils/trace.py`): what a span
records and when, its clock against torch.profiler's, the session's
spans of each frame on the CPU, and the benchmark's readers of the
spans and of the store (`vvcbench/metrics/`)."""
import os
import sys
import threading
import time

import pytest
import torch

from ffmpeg_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata")


@pytest.fixture(autouse=True)
def _trace_off():
  """Each test starts with tracing off and an empty store, and leaves
  them so."""
  trace.enable(False)
  trace.PROFILE_RANGES = False
  trace.reset()
  yield
  trace.enable(False)
  trace.PROFILE_RANGES = False
  trace.reset()


def _stage_events(prof, name):
  return [e for e in prof.profiler.kineto_results.events()
          if e.name() == "stage/" + name]


def _profile():
  from torch.profiler import ProfilerActivity, profile

  return profile(activities=[ProfilerActivity.CPU])


def test_span_off_records_nothing_and_opens_no_range():
  with _profile() as prof:
    with trace.span("idle", copies=0), trace.frame((0, 0)):
      trace.count("copies")
  assert trace.records() == [] and trace.summary() == {}
  assert _stage_events(prof, "idle") == []
  # one shared do-nothing object, whatever the name
  assert trace.span("a") is trace.span("b") is trace.frame(1)


def test_span_on_the_profiler_clock():
  """A span while PROFILE_RANGES is on is a "stage/<name>" range, and
  its record's edges lie within 1 ms of the range's on the profiler's
  clock; its CPU time is below its wall time over a sleep; it names the
  span open around it as its parent."""
  trace.PROFILE_RANGES = True
  with _profile() as prof:
    with trace.span("warm"):  # the first range pays the profiler's set-up
      pass
    with trace.span("outer"):
      with trace.span("sleep", k=3):
        time.sleep(0.02)
  trace.PROFILE_RANGES = False
  recs = {r["name"]: r for r in trace.records()}
  (ev,) = _stage_events(prof, "sleep")
  rec = recs["sleep"]
  assert abs(rec["start_ns"] - ev.start_ns()) < 1e6
  assert abs(rec["end_ns"] - ev.end_ns()) < 1e6
  wall = rec["end_ns"] - rec["start_ns"]
  assert wall >= 20e6 and 0 <= rec["cpu_ns"] < wall
  assert rec["parent"] == "outer"
  assert recs["outer"]["parent"] is None and recs["warm"]["parent"] is None
  assert rec["attrs"] == {"k": 3}
  assert rec["thread"] == threading.get_ident() and rec["frame"] is None
  assert len(_stage_events(prof, "outer")) == 1


def test_enabled_records_without_ranges():
  trace.enable(True)
  with _profile() as prof:
    with trace.frame(("s", 7)), trace.span("h2d", copies=0):
      trace.count("copies")
      trace.count("copies", 2)
  trace.enable(False)
  (rec,) = trace.records()
  assert rec["attrs"] == {"copies": 3} and rec["frame"] == ("s", 7)
  assert _stage_events(prof, "h2d") == []
  assert trace.summary()["h2d"]["n"] == 1
  assert set(trace.summary()["h2d"]) == {"n", "total_ms", "mean_ms",
                                         "max_ms"}


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
  monkeypatch.setattr(trace, "MAX_RECORDS", 5)
  trace.enable(True)
  for _ in range(8):
    with trace.span("x"):
      pass
  assert len(trace.records()) == 5 and trace.dropped() == 3
  trace.reset()
  assert trace.records() == [] and trace.dropped() == 0


def test_store_under_many_threads(monkeypatch):
  """More threads than cores record nested spans with a short switch
  interval: every span is kept or counted as dropped, and each record's
  parent and frame are its own thread's."""
  n_threads, per = 2 * (os.cpu_count() or 4), 100
  monkeypatch.setattr(trace, "MAX_RECORDS", n_threads * per)
  trace.enable(True)

  def work(i):
    with trace.frame(i):
      for _ in range(per // 2):
        with trace.span("outer"):
          with trace.span("inner"):
            pass

  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads + 2)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
  finally:
    sys.setswitchinterval(old)
  recs = trace.records()
  assert len(recs) == n_threads * per
  assert len(recs) + trace.dropped() == (n_threads + 2) * per
  outer = {}
  for r in recs:
    if r["name"] == "outer":
      outer.setdefault(r["thread"], []).append(r)
  for r in recs:
    if r["name"] == "inner":
      assert r["parent"] == "outer"
      # inside an outer span of its own thread and frame, where one was
      # kept
      around = [p for p in outer.get(r["thread"], ())
                if p["start_ns"] <= r["start_ns"] <= r["end_ns"]
                <= p["end_ns"]]
      assert all(p["frame"] == r["frame"] for p in around)
    else:
      assert r["parent"] is None


def _decode_traced(monkeypatch):
  """A CPU decode of ai256x128_10b with fetch=False under tracing, and
  each inputs_from_numpy call's `.to(device)` calls, counted by wrapping
  torch.Tensor.to on the session's main thread."""
  from ffmpeg_tpu_torch.models.vvc import pipeline
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  main = threading.get_ident()
  counting, counts = [], []
  real_to, real_inputs = torch.Tensor.to, pipeline.inputs_from_numpy

  def to(self, *a, **kw):
    if counting and threading.get_ident() == main and a and isinstance(
        a[0], torch.device):
      counts[-1] += 1
    return real_to(self, *a, **kw)

  def inputs(*a, **kw):
    counts.append(0)
    counting.append(1)
    try:
      return real_inputs(*a, **kw)
    finally:
      counting.pop()

  monkeypatch.setattr(torch.Tensor, "to", to)
  monkeypatch.setattr(pipeline, "inputs_from_numpy", inputs)
  with open(os.path.join(TESTDATA, "ai256x128_10b.vvc"), "rb") as f:
    data = f.read()
  trace.enable(True)
  try:
    frames = list(VVCDecoder(device="cpu", host_threads=2).decode(
        data, fetch=False))
  finally:
    trace.enable(False)
  return frames, counts, trace.records()


def test_session_spans_of_each_frame(monkeypatch):
  frames, counts, recs = _decode_traced(monkeypatch)
  assert len(frames) == 2
  main = threading.get_ident()
  by_frame: dict = {}
  for r in recs:
    by_frame.setdefault(r["frame"], []).append(r)
  assert None not in by_frame and len(by_frame) == len(frames)
  ids = sorted(by_frame)
  assert len({fid[0] for fid in ids}) == 1  # one session
  assert [fid[1] for fid in ids] == [0, 1]
  for fid in ids:
    rs = by_frame[fid]
    one = {}
    for name in ("parse_wait", "submit", "out_wait", "host_parse",
                 "inputs", "cabac", "h2d"):
      got = [r for r in rs if r["name"] == name]
      assert len(got) == 1, (fid, name)
      one[name] = got[0]
    for name in ("parse_wait", "submit", "out_wait", "h2d"):
      assert one[name]["thread"] == main
    for name in ("host_parse", "inputs", "cabac"):
      assert one[name]["thread"] != main
    assert one["cabac"]["parent"] == "host_parse"
    assert one["host_parse"]["parent"] is None
    assert one["inputs"]["parent"] is None
    assert one["h2d"]["parent"] == "submit"
    for name in ("residual", "recon", "pack"):
      assert all(r["parent"] == "submit" for r in rs if r["name"] == name)
  h2d = [r for r in recs if r["name"] == "h2d"]
  h2d.sort(key=lambda r: r["start_ns"])
  assert counts and all(c > 0 for c in counts)
  assert [r["attrs"]["copies"] for r in h2d] == counts
  # the frames the session waited for tie every lane record in
  assert 0 < _reader("lane_cpu_share.single")({}, recs) <= 100


def test_deblock_grids_span_in_inputs(monkeypatch):
  """On each parsed frame the deblock grids' span nests in `inputs` on
  the same thread and carries native 1: the native pass, never the numpy
  fallback."""
  frames, _, recs = _decode_traced(monkeypatch)
  by_frame: dict = {}
  for r in recs:
    by_frame.setdefault(r["frame"], []).append(r)
  assert len(by_frame) == len(frames) == 2
  for fid, rs in by_frame.items():
    (grids,) = [r for r in rs if r["name"] == "deblock_grids"]
    (inputs,) = [r for r in rs if r["name"] == "inputs"]
    assert grids["parent"] == "inputs", fid
    assert grids["thread"] == inputs["thread"] != threading.get_ident()
    assert (inputs["start_ns"] <= grids["start_ns"] <= grids["end_ns"]
            <= inputs["end_ns"])
    assert grids["attrs"] == {"native": 1}


def test_tracing_off_leaves_the_decode_unrecorded():
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  with open(os.path.join(TESTDATA, "ai256x128_10b.vvc"), "rb") as f:
    data = f.read()
  frames = list(VVCDecoder(device="cpu", host_threads=2).decode(
      data, fetch=False))
  assert len(frames) == 2 and trace.records() == []


# ---- the benchmark's readers ----------------------------------------------

def _reader(name):
  from vvcbench import cells

  return cells.reader("metrics", name)


@pytest.mark.parametrize("metric, stage", [
    ("parse_wait_ms.single", "parse_wait"), ("submit_ms.single", "submit"),
    ("out_wait_ms.single", "out_wait"), ("cabac_ms.single", "cabac"),
    ("deblock_grids_ms.single", "deblock_grids")])
def test_span_readers(metric, stage):
  read = _reader(metric)
  spans = {stage: [0.050, 0.070], "other": [1.0]}
  assert read({"trace": {"spans": spans}}) == pytest.approx(60.0)
  assert read({"trace": {"spans": {"other": [1.0]}}}) is None
  assert read({"trace": None}) is None
  assert read({}) is None


def _rec(name, wall_ms, cpu_ms, thread=1, frame=None, **attrs):
  return {"name": name, "thread": thread, "start_ns": 10**18,
          "end_ns": 10**18 + int(wall_ms * 1e6), "cpu_ns": int(cpu_ms * 1e6),
          "parent": None, "frame": frame, "attrs": attrs}


def test_lane_cpu_share_reader():
  """The lanes' records of the frames the session waited for: not a
  frame left queued when the session closed (its parse runs on past the
  window), nor a DMVR frame's inputs on the main thread."""
  read = _reader("lane_cpu_share.single")
  lane, main = 7, 1
  recs = [_rec("host_parse", 10, 8, lane, (0, 0)),
          _rec("inputs", 10, 6, lane, (0, 0)),
          _rec("cabac", 5, 5, lane, (0, 0)),
          _rec("parse_wait", 50, 1, main, (0, 0)),
          _rec("inputs", 20, 20, main, (0, 1)),
          _rec("parse_wait", 1, 1, main, (0, 1)),
          _rec("host_parse", 9000, 90, lane, (0, 2))]
  assert read({}, recs) == pytest.approx(70.0)
  assert read({}, recs[:3]) is None  # no frame waited for
  assert read({}, [_rec("parse_wait", 50, 1, main, (0, 0))]) is None
  assert read({}, []) is None
  assert read({}) is None  # the store, empty


def test_h2d_copies_reader():
  read = _reader("h2d_copies.single")
  recs = [_rec("h2d", 1, 1, copies=100), _rec("h2d", 1, 1, copies=120),
          _rec("h2d", 1, 1), _rec("submit", 2, 2, copies=7)]
  assert read({}, recs) == pytest.approx(110.0)
  assert read({}, [_rec("h2d", 1, 1)]) is None
  assert read({}, []) is None
  assert read({}) is None  # the store, empty


def _lane_parse(fid):
  with trace.frame(fid), trace.span("host_parse"):
    time.sleep(0.002)


def test_store_readers_read_the_port_store():
  trace.enable(True)
  lane = threading.Thread(target=_lane_parse, args=((0, 0),))
  lane.start()
  lane.join()
  with trace.frame((0, 0)), trace.span("parse_wait"):
    pass
  with trace.span("h2d", copies=0):
    trace.count("copies", 5)
  trace.enable(False)
  assert 0 < _reader("lane_cpu_share.single")({}) <= 100
  assert _reader("h2d_copies.single")({}) == 5


def test_store_readers_without_a_store(monkeypatch):
  """A program whose trace module keeps no store (the benchmark's files
  laid over an older checkout) gives nothing to read, and no error."""
  monkeypatch.delattr(trace, "records")
  assert _reader("lane_cpu_share.single")({}) is None
  assert _reader("h2d_copies.single")({}) is None
