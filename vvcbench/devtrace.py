"""The traced run's reduction: torch.profiler over the window, with the
port's stage ranges on (`ffmpeg_tpu_torch.utils.trace.PROFILE_RANGES`,
which marks each `trace.span` as a profiler range "stage/<name>"), on
every thread of the process.

From the trace (all times in seconds, clipped to the window's own
range, "vvcbench/window"):
  busy_s      the union of the device's kernel and copy intervals
  window_s    the window's length on the profiler's clock
  kernel_s    device time of the port's hand-written kernels, found by
              the names of the `__global__` functions in its CUDA sources
  h2d_s       device time of host-to-device copies
  spans       {stage: [seconds, ...]} of the host's stage ranges that
              ended in the window, from the threads that ran them
  device_ops  the ten device operations that took most time
  idle_gaps   the ten longest idle gaps of the device, each named by the
              host stages running at its middle
"""
from __future__ import annotations

import glob
import os
import re

WINDOW_RANGE = "vvcbench/window"
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


def port_kernel_names(csrc_dir: str) -> set:
  """The `__global__` functions defined in the CUDA sources of
  `csrc_dir`."""
  names = set()
  for path in glob.glob(os.path.join(csrc_dir, "*.cu")) + glob.glob(
      os.path.join(csrc_dir, "*.cuh")):
    with open(path) as f:
      names.update(_GLOBAL.findall(f.read()))
  return names


def is_port_kernel(event_name: str, names: set) -> bool:
  """A device event of one of `names`: "name", "name<...>(...)" or
  "void name<...>(...)"."""
  base = event_name[5:] if event_name.startswith("void ") else event_name
  return re.split(r"[<(]", base, maxsplit=1)[0].strip() in names


def union_s(intervals) -> float:
  """The length of the union of (start, end) intervals."""
  busy, end = 0.0, float("-inf")
  for s0, s1 in sorted(intervals):
    if s1 > end:
      busy += s1 - max(s0, end)
      end = s1
  return busy


def idle_gaps(intervals, lo: float, hi: float) -> list:
  """The (start, end) gaps in [lo, hi] that no interval covers."""
  gaps, cur = [], lo
  for s0, s1 in sorted(intervals):
    if s0 > cur:
      gaps.append((cur, min(s0, hi)))
    cur = max(cur, s1)
    if cur >= hi:
      break
  if cur < hi:
    gaps.append((cur, hi))
  return [g for g in gaps if g[1] > g[0]]


def _label(t: float, host_ranges) -> str:
  names = sorted({n for s0, s1, n in host_ranges if s0 <= t <= s1})
  return "+".join(names) if names else "no stage"


def reduce(events, kernel_names: set, top: int = 10) -> dict:
  """The traced window's numbers from the profiler's events: objects
  with `.name`, `.device_type` ("cpu"/"cuda"; torch's DeviceType values
  are mapped by the caller) and `.start`, `.end` in microseconds."""
  win = [e for e in events if e.device_type == "cpu"
         and e.name == WINDOW_RANGE]
  if not win:
    raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
  lo, hi = win[0].start, win[0].end
  dev, host = [], []
  for e in events:
    if e.end < lo or e.start > hi:
      continue
    if e.device_type == "cuda" and not e.name.startswith("stage/"):
      dev.append((max(e.start, lo), min(e.end, hi), e.name))
    elif e.device_type == "cpu" and e.name.startswith("stage/"):
      host.append((e.start, e.end, e.name[6:]))
  by_name: dict = {}
  for s0, s1, name in dev:
    by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
  intervals = [(s0, s1) for s0, s1, _ in dev]
  spans: dict = {}
  for s0, s1, name in host:
    if s1 <= hi:
      spans.setdefault(name, []).append((s1 - s0) / 1e6)
  gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])
  ops = sorted(by_name.items(), key=lambda kv: -kv[1])
  return {
      "busy_s": union_s(intervals) / 1e6,
      "window_s": (hi - lo) / 1e6,
      "kernel_s": sum(v for k, v in by_name.items()
                      if is_port_kernel(k, kernel_names)) / 1e6,
      "h2d_s": sum(v for k, v in by_name.items() if "HtoD" in k) / 1e6,
      "spans": spans,
      "device_ops": [[k[:120], v / 1e6] for k, v in ops[:top]],
      "idle_gaps": [[_label((g0 + g1) / 2, host), (g1 - g0) / 1e6]
                    for g0, g1 in gaps[:top]],
  }


class Event:
  __slots__ = ("name", "device_type", "start", "end")

  def __init__(self, name, device_type, start, end):
    self.name, self.device_type, self.start, self.end = (
        name, device_type, start, end)


def from_profiler(prof) -> list:
  """The profiler's raw events as Event objects (the kineto results:
  building torch's FunctionEvent tree for a window's hundreds of
  thousands of host operations takes minutes)."""
  from torch.autograd import DeviceType

  kinds = {DeviceType.CPU: "cpu", DeviceType.CUDA: "cuda"}
  return [Event(e.name(), kinds.get(e.device_type(), "other"),
                e.start_ns() / 1e3, e.end_ns() / 1e3)
          for e in prof.profiler.kineto_results.events()]


def profiler(torch):
  """torch.profiler over the CPU (every thread) and the card."""
  from torch.profiler import ProfilerActivity, profile

  acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  try:
    from torch._C._profiler import _ExperimentalConfig

    cfg = _ExperimentalConfig(profile_all_threads=True)
  except (ImportError, TypeError) as e:
    raise RuntimeError("this torch cannot profile every thread "
                       f"(profile_all_threads): {e}") from e
  return profile(activities=acts, experimental_config=cfg)

