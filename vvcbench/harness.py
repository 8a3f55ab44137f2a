"""One run of one cell: set-up, the measured window, the comparison, the
metrics and the result line.

  set-up   the configuration's pool of streams (truth.py; made by the
           frozen generator, or read from the cache), the traffic's
           decode sessions of the port, and one warm-up pass through each
           of the stream the seed starts at.  `setup_s` counts from the
           process's start to the window's, less the seconds spent
           generating streams the cache did not hold: making the traffic
           is the benchmark's work, not the decoder's, and a checkout's
           first run would otherwise read a set-up several times its
           second's.
  window   window.run_window over the pool's streams in turn, from the
           one the seed picks; with --trace 1 under torch.profiler.
  check    the counted frames' MD5s against the truth's (compare.py).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

from . import cells, compare, devtrace, streams, truth, window

FORBIDDEN = ("jax", "jaxlib", "flax", "ffmpeg_tpu")


def forbidden_modules() -> list:
  """Loaded modules whose top-level name, compared whole, is one of
  FORBIDDEN (`ffmpeg_tpu_torch` is not `ffmpeg_tpu`)."""
  return sorted({m.split(".")[0] for m in list(sys.modules)
                 if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
  try:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=20)
  except (OSError, subprocess.TimeoutExpired) as e:
    return f"unknown ({e})"
  return out.stdout.strip() or f"unknown (rc {out.returncode})"


def _port_decoder(device, host_threads):
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  return lambda: VVCDecoder(device=device, host_threads=host_threads)


def as_bytes(packed) -> bytes:
  """A packed frame (uint8, or int16 holding uint16 samples), as the
  port yields it, brought to the host as its planar bytes."""
  return packed.cpu().numpy().tobytes()


def _port_csrc() -> str:
  import ffmpeg_tpu_torch

  return os.path.join(os.path.dirname(ffmpeg_tpu_torch.__file__), "csrc")


def measure(cell: cells.Cell, seed: int, seconds: float, traced: bool,
            device: str, t0: float, *, cache: str = streams.CACHE,
            make_decoder=None) -> dict:
  """The run's record: the window's numbers, the comparison's numbers,
  and with `traced` the trace's reduction (devtrace.reduce).
  make_decoder() -> a decode session (the port's VVCDecoder on `device`
  with the traffic's parse lanes unless given)."""
  import torch

  cuda = device == "cuda"
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  gen = cell.config["generator"]
  make = make_decoder or _port_decoder(device, cell.traffic["host_threads"])
  truths = truth.pool(cell.config_name, cell.root)
  first = truth.first(seed, truths)
  data, gen_s = streams.pool_streams(cell.config_name, cell.config,
                                     [t["seed"] for t in truths], cache)
  decoders = [make() for _ in range(cell.traffic["sessions"])]
  window.warm_up(decoders, data[first], sync)
  setup_s = time.perf_counter() - t0 - gen_s

  trace_out = None
  if traced:
    from torch.profiler import record_function

    from ffmpeg_tpu_torch.utils import trace

    trace.PROFILE_RANGES = True
    try:
      with devtrace.profiler(torch) as prof:
        with record_function(devtrace.WINDOW_RANGE):
          win = window.run_window(decoders, data, first, seconds, sync)
    finally:
      trace.PROFILE_RANGES = False
  else:
    win = window.run_window(decoders, data, first, seconds, sync)
  peak = torch.cuda.max_memory_allocated() if cuda else 0
  window_s, frames = win.seconds, win.frames
  positions = [pos for r in win.runs for _, pos, _ in r.frames]
  got = compare.collect(win.runs, as_bytes)
  errors = [repr(r.error) for r in win.runs if r.error is not None]
  del win, decoders
  if traced:
    t_red = time.perf_counter()
    trace_out = devtrace.reduce(devtrace.from_profiler(prof),
                                devtrace.port_kernel_names(_port_csrc()))
    trace_out["reduce_s"] = time.perf_counter() - t_red
    del prof
  if cuda:
    torch.cuda.empty_cache()

  numbers = compare.compare(got, truths,
                            [hashlib.sha256(d).hexdigest() for d in data])
  return {"frames": frames, "window_s": window_s, "setup_s": setup_s,
          "generate_s": gen_s, "positions": positions, "generator": gen,
          "peak": peak, "numbers": numbers, "errors": errors,
          "trace": trace_out, "first": first,
          "stream_bytes": [len(d) for d in data],
          "stream_frames": [len(t["md5"]) for t in truths]}


def result_line(cell: cells.Cell, rec: dict, traced: bool, kind: str,
                card: str, root: str = cells.ROOT) -> dict:
  numbers = rec["numbers"]
  out = {"correct": compare.verdict(numbers),
         "attempted": numbers["compared_frames"],
         "failed": (numbers["mismatched_frames"] + numbers["missing_frames"]
                    + numbers["session_errors"])}
  if traced:
    out["metrics"] = cells.read_metrics(cell.per_layer, "metrics", rec, root)
  else:
    out["metrics"] = cells.read_metrics(cell.end_to_end, "end_to_end", rec,
                                        root)
  out["device"] = {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": rec["peak"]}
  if traced:
    t = rec["trace"]
    out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
    out["breakdown"] = {"device_ops": t["device_ops"],
                        "idle_gaps": t["idle_gaps"]}
  out["run"] = {"card": card, "frames": rec["frames"],
                "window_s": rec["window_s"], "setup_s": rec["setup_s"],
                "generate_s": rec["generate_s"],
                "first": rec["first"],
                "stream_bytes": rec["stream_bytes"],
                "stream_frames": rec["stream_frames"],
                "errors": rec["errors"][:4]}
  if traced:
    out["run"]["trace_reduce_s"] = rec["trace"]["reduce_s"]
  out["compared"] = compare.limits_report(numbers)
  return out


def parse_args(argv):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def main(argv, t0: float) -> int:
  args = parse_args(argv)
  import torch

  torch.set_num_threads(1)
  cell = cells.resolve(args.workload, cells.load_benchmark())
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f"vvcbench: {cell.name} needs {cell.chips} CUDA device(s); "
          f"torch.cuda.is_available()={torch.cuda.is_available()}, "
          f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
    return 3
  rec = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
  bad = forbidden_modules()
  if bad:
    print(f"vvcbench: modules loaded that the run may not load: {bad}",
          file=sys.stderr)
    return 4
  line = result_line(cell, rec, bool(args.trace),
                     torch.cuda.get_device_name(0), power_limit())
  for name, v in line["compared"].items():
    print(f"vvcbench check {name}: {v['value']} (limit {v['limit']})",
          file=sys.stderr)
  print(json.dumps(line), flush=True)
  return 0
