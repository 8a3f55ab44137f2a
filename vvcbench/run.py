"""Run one cell of BENCHMARK.json once and print its result line.

    python vvcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The caches that building and running fill
live in fixed directories inside the checkout: `vvcbench/.cache/`
(streams and the toolchains' kernel caches),
`vvcbench/frozen/_build/` and the port's `ffmpeg_tpu_torch/_build/`.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def _environment() -> None:
  here = os.path.dirname(os.path.abspath(__file__))
  cache = os.path.join(here, ".cache")
  os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
  os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
  os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
  # one thread for each numeric library's own pool: the parse lanes and
  # the session's main thread are the run's load, and the host has 8
  # cores
  for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
  # the port's wall-clock spans synchronise the card; the traced run reads
  # its stages from profiler ranges instead
  os.environ.pop("FFMPEG_TPU_TRACE", None)
  sys.path.insert(0, os.path.dirname(here))


if __name__ == "__main__":
  _environment()
  from vvcbench.harness import main

  rc = main(sys.argv[1:], T0)
  sys.stdout.flush()
  sys.stderr.flush()
  # a session stopped at the deadline may leave a parse lane waiting on
  # the collocated motion of a frame it will never decode (the native
  # wait gives up after 600 s); the interpreter's exit would join that
  # thread, so end the process here, every spawned process already ended
  os._exit(rc)
