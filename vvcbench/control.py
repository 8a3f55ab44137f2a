"""The control of the comparison: the frozen plain decode path
(`reference.py`) put in the port's place one precision below what the
configuration states (`reference.control`, each residual plane held in
int8), its frames judged against the truth as the window's are.  It
must come out not correct on every stream.  With `--witness` the same
path at full precision, a second decoder beside the JAX package's, which
must come out correct.

    python -m vvcbench.control --config ra1080_full [--witness] \
        [--device cuda] [--entries 0 1 2]

prints one JSON line a pool entry (truth.py) with the numbers compared;
the streams come from (and go to) the run's cache.  Exit code 0 where
every control failed (every witness passed), else 1."""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from . import cells, compare, reference, streams, truth


def frames_as_window(frames) -> compare.Collected:
  """A stream's frames (planar bytes each) as one whole pass of the
  window's counted frames."""
  return compare.Collected(
      versions={(0, pos): {compare.md5(f): 1}
                for pos, f in enumerate(frames)},
      passes=[(0, len(frames))], errors=0)


def judge(config_name: str, config: dict, want: dict, device: str,
          call=reference.control, cache: str = streams.CACHE) -> dict:
  """The numbers compared of the frozen path's decode, with `call` for
  its kernel calls, of the stream of the truth's entry `want`."""
  (data,), _ = streams.pool_streams(config_name, config, [want["seed"]],
                                    cache)
  t0 = time.perf_counter()
  frames = reference.decode(data, device, call=call)
  numbers = compare.compare(frames_as_window(frames), [want],
                            [hashlib.sha256(data).hexdigest()])
  return dict(numbers, config=config_name, stream_seed=want["seed"],
              correct=compare.verdict(numbers),
              decode_s=time.perf_counter() - t0)


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--config", required=True)
  p.add_argument("--entries", type=int, nargs="*")
  p.add_argument("--witness", action="store_true")
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  with open(os.path.join(cells.ROOT, "configs", args.config + ".json")) as f:
    config = json.load(f)
  entries = truth.pool(args.config)
  picked = [entries[i] for i in args.entries] if args.entries else entries
  call = reference.plain if args.witness else reference.control
  ok = True
  for want in picked:
    out = judge(args.config, config, want, args.device, call)
    out["role"] = "witness" if args.witness else "control"
    ok &= out["correct"] == args.witness
    print(json.dumps(out), flush=True)
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
