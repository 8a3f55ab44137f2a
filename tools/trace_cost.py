"""The cost of the port's span store alone, with no profiler: a cell of
BENCHMARK.json's untraced window (vvcbench/harness.py `measure`), run in
one process with the store off and on (`utils/trace.py` enable(), as
FFMPEG_TPU_TRACE=1 sets it) in turns, on each seed.

    python3 tools/trace_cost.py --workload ai720.single --seconds 30 \
        --seeds 11 12 13

from the root of a checkout, on a CUDA card.  Prints one JSON line a
window: seed, store on or off, frames a second, the records kept and
dropped, `correct`, and the card with its power limit.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--seeds", type=int, nargs="+", required=True)
  args = p.parse_args(argv)

  from vvcbench.run import _environment  # the benchmark's environment

  _environment()
  import torch

  from ffmpeg_tpu_torch.utils import trace
  from vvcbench import cells, compare, harness

  torch.set_num_threads(1)
  cell = cells.resolve(args.workload, cells.load_benchmark())
  card = harness.power_limit()
  for i, seed in enumerate(args.seeds):
    # off, on for one seed; on, off for the next
    for on in ((False, True) if i % 2 == 0 else (True, False)):
      trace.reset()
      trace.enable(on)
      try:
        rec = harness.measure(cell, seed, args.seconds, False, "cuda",
                              time.perf_counter())
      finally:
        trace.enable(False)
      print(json.dumps({
          "seed": seed, "store": on,
          "fps": rec["frames"] / rec["window_s"],
          "records": len(trace.records()), "dropped": trace.dropped(),
          "correct": compare.verdict(rec["numbers"]), "card": card}),
            flush=True)
  return 0


if __name__ == "__main__":
  rc = main(sys.argv[1:])
  sys.stdout.flush()
  # as vvcbench/run.py: a parse lane left waiting on collocated motion
  # must not hold the process at exit
  os._exit(rc)
