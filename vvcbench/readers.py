"""What the metric files under `end_to_end/` and `metrics/` read from a
run's record (harness.measure):

  frames, window_s, setup_s   the window's counted frames and length, and
                              the set-up before it
  positions                   each counted frame's position in its pass
  generator                   the configuration's generator arguments
  trace                       the traced run's reduction (devtrace), or
                              None

Each returns None where the record holds nothing to read, and the
harness then leaves the metric out."""
from __future__ import annotations

from . import roofline


def rate(rec: dict) -> float:
  """Frames counted over the window, the final synchronisation in it."""
  return rec["frames"] / rec["window_s"]


def span_mean_ms(rec: dict, stage: str):
  """The mean length of the host's `stage` ranges in the traced window,
  in ms (one range a frame, or a DMVR frame for "dmvr")."""
  spans = (rec.get("trace") or {}).get("spans", {}).get(stage)
  if not spans:
    return None
  return sum(spans) / len(spans) * 1e3


def device_ms_per_frame(rec: dict, key: str):
  t = rec.get("trace")
  if t is None or not rec["frames"] or not t[key]:
    return None
  return t[key] / rec["frames"] * 1e3


def kernels_roofline(rec: dict):
  """The kernels' least time on the counted frames (roofline.py) over
  their device time in the window, in %."""
  t = rec.get("trace")
  if t is None or not t["kernel_s"]:
    return None
  least = roofline.least_seconds(rec["generator"], rec["positions"])
  return least / t["kernel_s"] * 100


def device_idle_share(rec: dict):
  t = rec.get("trace")
  if t is None or not t["window_s"]:
    return None
  return (1 - t["busy_s"] / t["window_s"]) * 100
