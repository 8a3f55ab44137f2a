"""Per-stage decode timing (the VVC_THREAD_DEBUG / checkasm --bench
analog, reference vvc_thread.c:568-603).

Enable with FFMPEG_TPU_TRACE=1 (or `enable()`): the decoder records
wall-clock spans for each stage (host_parse, inputs, dmvr, h2d,
residual, inter, recon, lmcs, deblock, sao, alf, pack, fetch) and
`summary()` aggregates them.  A span
given a `sync` callable (torch.cuda.synchronize for a CUDA device)
calls it at both edges, so the span holds the device work it queued;
that costs the overlap of host and device and happens only while
tracing is on.  Zero overhead when disabled (module-level flag, no-op
span).
"""
from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = bool(os.environ.get("FFMPEG_TPU_TRACE"))
# profiler ranges around the spans (chip_smoke.py's profile phase); off
# unless set, and independent of ENABLED
PROFILE_RANGES = False

_lock = threading.Lock()
_spans: dict[str, list[float]] = defaultdict(list)


def enable(on: bool = True) -> None:
    global ENABLED
    ENABLED = on


@contextmanager
def _timed(stage: str, sync=None):
    if not ENABLED:
        yield
        return
    if sync is not None:
        sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        dt = time.perf_counter() - t0
        with _lock:
            _spans[stage].append(dt)


@contextmanager
def span(stage: str, sync=None):
    """Time a stage (while tracing is on); while PROFILE_RANGES is on,
    also mark it as a torch.profiler range named "stage/<stage>", so that a
    profile can sum the device time of the kernels each stage launched."""
    if not PROFILE_RANGES:
        with _timed(stage, sync):
            yield
        return
    from torch.profiler import record_function

    with record_function("stage/" + stage), _timed(stage, sync):
        yield


def reset() -> None:
    with _lock:
        _spans.clear()


def summary() -> dict:
    """Aggregated stage stats: {stage: {n, total_ms, mean_ms, max_ms}}."""
    out = {}
    with _lock:
        for stage, ts in _spans.items():
            out[stage] = {
                "n": len(ts),
                "total_ms": round(sum(ts) * 1e3, 2),
                "mean_ms": round(sum(ts) / len(ts) * 1e3, 3),
                "max_ms": round(max(ts) * 1e3, 3),
            }
    return out


def report() -> str:
    lines = []
    for stage, st in sorted(summary().items()):
        lines.append(f"{stage:28s} {st}")
    return "\n".join(lines)
