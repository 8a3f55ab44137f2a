"""Spans of the decoder's work on the host, recorded in one store (the
VVC_THREAD_DEBUG / checkasm --bench analog, reference
vvc_thread.c:568-603).

`with trace.span(name, **attrs):` records while tracing is on: ENABLED
(FFMPEG_TPU_TRACE=1, or enable()) or PROFILE_RANGES, which is read at
each span.  While PROFILE_RANGES is on the span is also a torch.profiler
range "stage/<name>", so that a profile can sum the device time of the
kernels each stage launched and name the host work in the device's idle
gaps.  No span synchronises the device: a span around launches times
their enqueue on the host.  With tracing off a span is one flag check
and the same shared do-nothing object.

Each span leaves one record in an in-memory store, at most MAX_RECORDS
(later ones are dropped and counted, dropped()); records() returns them:
  name, thread      the span's name; threading.get_ident() of its thread
  start_ns, end_ns  time.time_ns() at its edges: Unix-epoch ns, the clock
                    of the profiler's CPU events (kineto start_ns/end_ns)
  cpu_ns            the thread's CPU time over the span
                    (time.thread_time_ns): below end_ns - start_ns where
                    the thread waited, on a lock, the GIL or the host
  parent            the name of the span open around it on the same
                    thread, or None
  frame             the frame it works for (`with trace.frame(fid):`),
                    shared by its spans on every thread, or None: it
                    ties a lane's spans to the session's wait on them
  attrs             the attributes given, with what count() added
summary() aggregates the store by name.

The session's spans (models/vvc): on a parse lane `host_parse` (holding
`cabac`, the native parse; the rest is the Python gather of its arrays)
and then `inputs` (holding `deblock_grids`, the deblock edge grids, with
its attribute `native`: 1 for the native pass, 0 for the numpy
fallback); on the main thread `parse_wait` (the wait on a lane's
parse), `submit` (holding `h2d`, with its attribute `copies`, and the
frame program's stages: residual, inter, recon, lmcs, deblock, sao, alf,
pack), `out_wait` (the wait on a frame's error word before it is handed
out, decode(fetch=False)) or `fetch` (the group's fetch), and on DMVR
frames `dmvr` (holding `dmvr_search` and `dmvr_apply`).
"""
from __future__ import annotations

import os
import threading
import time

ENABLED = bool(os.environ.get("FFMPEG_TPU_TRACE"))
# profiler ranges around the spans (vvcbench's traced window, chip_smoke.py's
# profile phase); spans record while either switch is on
PROFILE_RANGES = False
MAX_RECORDS = 1 << 18

_lock = threading.Lock()
_records: list = []
_dropped = 0
_local = threading.local()


def enable(on: bool = True) -> None:
    global ENABLED
    ENABLED = on


class _Off:
    """A span or frame while tracing is off: records and opens nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "parent", "frame", "range", "t0", "c0")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        self.frame = getattr(_local, "frame", None)
        self.range = None
        if PROFILE_RANGES:
            from torch.profiler import record_function

            self.range = record_function("stage/" + self.name)
            self.range.__enter__()
        stack.append(self)
        self.c0 = time.thread_time_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        c1 = time.thread_time_ns()
        _stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        _store({"name": self.name, "thread": threading.get_ident(),
                "start_ns": self.t0, "end_ns": t1, "cpu_ns": c1 - self.c0,
                "parent": self.parent, "frame": self.frame,
                "attrs": self.attrs})
        return False


def _store(rec: dict) -> None:
    global _dropped
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(rec)
        else:
            _dropped += 1


def span(name: str, **attrs):
    """A context manager that records the work inside it as `name`
    (while tracing is on), with `attrs` in its record."""
    if not (ENABLED or PROFILE_RANGES):
        return _OFF
    return _Span(name, attrs)


class _Frame:
    __slots__ = ("fid", "prev")

    def __init__(self, fid):
        self.fid = fid

    def __enter__(self):
        self.prev = getattr(_local, "frame", None)
        _local.frame = self.fid
        return self

    def __exit__(self, *exc):
        _local.frame = self.prev
        return False


def frame(fid):
    """A context manager under which this thread's spans carry the frame
    identifier `fid` (while tracing is on)."""
    if not (ENABLED or PROFILE_RANGES):
        return _OFF
    return _Frame(fid)


def count(attr: str, n: int = 1) -> None:
    """Add n to the attribute `attr` of the innermost span open on this
    thread (while tracing is on)."""
    if not (ENABLED or PROFILE_RANGES):
        return
    stack = _stack()
    if stack:
        attrs = stack[-1].attrs
        attrs[attr] = attrs.get(attr, 0) + n


def records() -> list:
    """The store's records, oldest first (the dicts themselves: read
    them, do not change them)."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Records the full store turned away since the last reset()."""
    return _dropped


def reset() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def summary() -> dict:
    """Aggregated span stats: {name: {n, total_ms, mean_ms, max_ms}}."""
    by_name: dict = {}
    for rec in records():
        by_name.setdefault(rec["name"], []).append(
            (rec["end_ns"] - rec["start_ns"]) / 1e6)
    return {name: {"n": len(ts), "total_ms": round(sum(ts), 2),
                   "mean_ms": round(sum(ts) / len(ts), 3),
                   "max_ms": round(max(ts), 3)}
            for name, ts in by_name.items()}
