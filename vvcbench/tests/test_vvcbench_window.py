"""The window's rate arithmetic, the trace's busy union and idle gaps,
and the roofline's least time, on made-up clocks, events and frames."""
import json
import os

import pytest

from vvcbench import cells, devtrace, readers, roofline, truth, window


class Clock:
  def __init__(self):
    self.t = 100.0

  def __call__(self):
    return self.t


class FakeFrame:
  def __init__(self, buf):
    self.buf = buf


class FakeDecoder:
  """Yields `n` frames a pass, each `step` seconds of the clock later."""

  def __init__(self, clock, n, step):
    self.clock, self.n, self.step = clock, n, step

  def decode(self, data, fetch=True):
    assert fetch is False
    for i in range(self.n):
      self.clock.t += self.step
      yield FakeFrame(i)


def test_rate_counts_the_final_sync_inside_the_window():
  clock = Clock()
  waits = []

  def sync():
    waits.append(clock.t)
    clock.t += 0.5  # the card finishing what the sessions queued

  dec = FakeDecoder(clock, n=4, step=0.25)
  win = window.run_window([dec], [b"a", b"b"], 0, 2.0, sync, clock=clock)
  # frames at +0.25 .. +1.75 counted (7); the one at +2.0 is at the
  # deadline and is not
  assert win.frames == 7
  assert win.seconds == pytest.approx(2.0 + 0.5)
  assert win.rate == pytest.approx(7 / 2.5)
  assert len(waits) == 1
  run = win.runs[0]
  assert run.passes == [(0, 4)]  # one whole pass, then a cut one
  assert [(k, p) for k, p, _ in run.frames] == [
      (0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2)]
  assert readers.rate({"frames": win.frames,
                       "window_s": win.seconds}) == pytest.approx(2.8)


def test_a_session_error_is_kept_and_stops_that_session():
  clock = Clock()

  class Broken(FakeDecoder):
    def decode(self, data, fetch=True):
      yield from super().decode(data, fetch)
      raise RuntimeError("rows out of range")

  win = window.run_window([Broken(clock, 2, 0.1)], [b""], 0, 5.0,
                          lambda: None, clock=clock)
  assert isinstance(win.runs[0].error, RuntimeError)
  assert win.frames == 2


def test_sessions_rotate_through_the_streams_from_the_seeds_pick():
  """Each session decodes every stream in turn, session i from stream
  first + i; each pass is fed its own stream."""
  clock = Clock()
  fed = []

  class Recording(FakeDecoder):
    def decode(self, data, fetch=True):
      fed.append(data)
      yield from super().decode(data, fetch)

  win = window.run_window([Recording(clock, 2, 0.1)], [b"a", b"b", b"c"],
                          2, 0.95, lambda: None, clock=clock)
  assert fed[:4] == [b"c", b"a", b"b", b"c"]
  assert win.runs[0].passes[:3] == [(2, 2), (0, 2), (1, 2)]
  assert truth.first(7, [{}, {}, {}]) == 1
  assert truth.first(2**31 + 5, [{}, {}, {}]) == (2**31 + 5) % 3
  with pytest.raises(ValueError):
    truth.first(-1, [{}])


def test_warm_up_raises_a_session_error():
  class Broken:
    def decode(self, data, fetch=True):
      raise ValueError("bad stream")
      yield  # noqa: unreachable - a generator

  with pytest.raises(ValueError):
    window.warm_up([Broken()], b"", lambda: None)


def test_union_and_idle_gaps():
  iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
  assert devtrace.union_s(iv) == 15 + 11 + 1
  assert devtrace.idle_gaps(iv, 0, 50) == [(15, 20), (31, 40), (41, 50)]
  assert devtrace.idle_gaps([], 2, 5) == [(2, 5)]
  assert devtrace.union_s([]) == 0


def E(name, kind, s, e):
  return devtrace.Event(name, kind, s, e)


def test_reduce_on_made_up_events():
  names = {"wave_kernel", "sao_kernel"}
  events = [
      E(devtrace.WINDOW_RANGE, "cpu", 1000, 11000),
      E("void wave_kernel<32>(Params)", "cuda", 1500, 2500),
      E("sao_kernel", "cuda", 2000, 3000),          # overlaps wave_kernel
      E("Memcpy HtoD (Pageable -> Device)", "cuda", 4000, 4500),
      E("void at::native::elementwise_kernel<128, 4>(int)", "cuda", 5000,
        5200),
      E("stage/h2d", "cuda", 3900, 4600),           # a mark, not work
      E("sao_kernel", "cuda", 500, 1200),           # clipped at the start
      E("stage/host_parse", "cpu", 2000, 9000),
      E("stage/host_parse", "cpu", 9500, 10500),
      E("stage/inputs", "cpu", 6000, 8500),
      E("stage/inputs", "cpu", 10900, 12000),       # ends after the window
  ]
  t = devtrace.reduce(events, names)
  assert t["window_s"] == pytest.approx(0.01)
  # union: [1000,1200] + [1500,3000] + [4000,4500] + [5000,5200]
  assert t["busy_s"] == pytest.approx((200 + 1500 + 500 + 200) / 1e6)
  assert t["kernel_s"] == pytest.approx((1000 + 1000 + 200) / 1e6)
  assert t["h2d_s"] == pytest.approx(500 / 1e6)
  assert t["spans"]["host_parse"] == pytest.approx([0.007, 0.001])
  assert t["spans"]["inputs"] == pytest.approx([0.0025])
  gaps = dict((round(s * 1e6), n) for n, s in t["idle_gaps"])
  # the longest gap, [5200, 11000], is named by the stages at its middle
  assert gaps[5800] == "host_parse+inputs"
  assert t["device_ops"][0][0] == "sao_kernel"
  rec = {"frames": 4, "trace": t, "generator": {}, "positions": []}
  assert readers.device_ms_per_frame(rec, "kernel_s") == pytest.approx(
      2200 / 1e6 / 4 * 1e3)
  assert readers.span_mean_ms(rec, "host_parse") == pytest.approx(4.0)
  assert readers.span_mean_ms(rec, "dmvr") is None
  assert readers.device_idle_share(rec) == pytest.approx(
      (1 - 2400 / 10000) * 100)


def test_reduce_needs_the_window_range():
  with pytest.raises(RuntimeError):
    devtrace.reduce([E("sao_kernel", "cuda", 0, 1)], set())


def test_port_kernel_names_and_matching():
  import ffmpeg_tpu_torch

  names = devtrace.port_kernel_names(os.path.join(
      os.path.dirname(ffmpeg_tpu_torch.__file__), "csrc"))
  assert {"wave_kernel", "place_kernel", "packed_kernel", "band_kernel",
          "small_kernel", "large_kernel", "deblock_tile_kernel",
          "sao_kernel", "alf_luma_kernel", "alf_chroma_kernel",
          "lmcs_inv_kernel", "dmvr_search_kernel"} <= names
  assert devtrace.is_port_kernel("void wave_kernel<64>(Params)", names)
  assert devtrace.is_port_kernel("sao_kernel", names)
  assert not devtrace.is_port_kernel(
      "void at::native::vectorized_elementwise_kernel<4>(int)", names)
  assert not devtrace.is_port_kernel("Memcpy HtoD (Pinned -> Device)",
                                     names)


with open(os.path.join(cells.ROOT, "configs", "ra1080_full.json")) as f:
  RA = json.load(f)
AI = cells.resolve("ai720.single", cells.load_benchmark()).config


def test_roofline_bytes_from_geometry_and_tools():
  g = RA["generator"]
  whole, luma = 1920 * 1080 * 3 // 2, 1920 * 1080
  # B frame: residual 2, recon 3, inter 2 planes, LMCS 2 luma, deblock,
  # SAO, ALF 2 each, CC-ALF 1 luma; two bytes a 10-bit sample
  assert roofline.frame_bytes(g, intra=False) == 2 * (13 * whole + 3 * luma)
  assert roofline.frame_bytes(g, intra=True) == 2 * (10 * whole + 3 * luma)
  a = AI["generator"]
  whole, luma = 1280 * 720 * 3 // 2, 1280 * 720
  assert roofline.frame_bytes(a, intra=True) == 2 * (10 * whole + 3 * luma)
  assert roofline.frame_bytes(dict(a, bit_depth=8), intra=True) * 2 == (
      roofline.frame_bytes(a, intra=True))
  assert [roofline.is_intra(g, p) for p in (0, 1, 16)] == [True, False,
                                                         False]
  assert all(roofline.is_intra(a, p) for p in (0, 5))
  least = roofline.least_seconds(g, [0, 1, 2])
  assert least == pytest.approx(
      (roofline.frame_bytes(g, True) + 2 * roofline.frame_bytes(g, False))
      / 3.35e12)


def test_roofline_share_reads_the_least_time_over_the_kernels_time():
  g = RA["generator"]
  least = roofline.least_seconds(g, [1] * 10)
  rec = {"frames": 10, "positions": [1] * 10, "generator": g,
         "trace": {"kernel_s": 4 * least}}
  assert readers.kernels_roofline(rec) == pytest.approx(25.0)
  rec["trace"]["kernel_s"] = 0
  assert readers.kernels_roofline(rec) is None
