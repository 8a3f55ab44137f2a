"""The comparison that decides `correct`: the MD5 of every frame the
window counted against the MD5 that the JAX package's decode gives the
frame at its position in its stream's output order (truth.py), and each
stream against the one that decode read.

Limits (an exact comparison has the limit 0):
  stream_differs     streams whose sha256 is not the truth's            0
  mismatched_frames  counted frames whose MD5 is not the truth's       0
  missing_frames     frames a finished pass yielded too few or too many 0
  session_errors     sessions stopped by an exception                   0
  compared_frames    frames compared                            at least 1
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

LIMITS = {"stream_differs": 0, "mismatched_frames": 0, "missing_frames": 0,
          "session_errors": 0}
MIN_COMPARED = 1


@dataclass
class Collected:
  """The window's counted frames: {(stream, position): {md5: count}},
  each distinct MD5 of a position's frame with how often it came; each
  finished pass as (stream, frames); sessions stopped by an
  exception."""
  versions: dict
  passes: list
  errors: int


def md5(data) -> str:
  return hashlib.md5(data).hexdigest()


def collect(runs, to_bytes) -> Collected:
  """The counted frames of the window's runs (window.SessionRun);
  `to_bytes(buf)` brings one counted buffer to the host as the frame's
  planar bytes."""
  versions: dict = {}
  for run in runs:
    for k, pos, buf in run.frames:
      counts = versions.setdefault((k, pos), {})
      h = md5(to_bytes(buf))
      counts[h] = counts.get(h, 0) + 1
  return Collected(versions=versions,
                   passes=[k for r in runs for k in r.passes],
                   errors=sum(r.error is not None for r in runs))


def compare(got: Collected, truths: list, stream_sha256s: list) -> dict:
  """The numbers compared, {name: value}, of the counted frames against
  the truth's entries (truth.pool) of the streams, which hash to
  `stream_sha256s`, in the same order."""
  mismatched = compared = 0
  for (k, pos), counts in got.versions.items():
    want = truths[k]["md5"]
    for h, count in counts.items():
      compared += count
      if pos >= len(want) or h != want[pos]:
        mismatched += count
  return {"stream_differs": sum(sha != t["sha256"] for sha, t
                                in zip(stream_sha256s, truths)),
          "mismatched_frames": mismatched,
          "missing_frames": sum(abs(len(truths[k]["md5"]) - n)
                                for k, n in got.passes),
          "session_errors": got.errors, "compared_frames": compared}


def verdict(numbers: dict) -> bool:
  return (all(numbers[k] <= v for k, v in LIMITS.items())
          and numbers["compared_frames"] >= MIN_COMPARED)


def limits_report(numbers: dict) -> dict:
  """{name: {"value", "limit"}} of every number compared, for the result
  line and standard error."""
  out = {k: {"value": numbers[k], "limit": v} for k, v in LIMITS.items()}
  out["compared_frames"] = {"value": numbers["compared_frames"],
                            "limit": f">= {MIN_COMPARED}"}
  return out
