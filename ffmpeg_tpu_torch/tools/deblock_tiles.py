"""Time the deblock kernel built at several tile edges on a real frame.

  python -m ffmpeg_tpu_torch.tools.deblock_tiles [--tiles 32 48 64]
      [--stream ffmpeg_tpu_torch/testdata/full1080.vvc] [--reps 20]

Walks the stream on the card to its first B frame, keeps that frame's
deblock calls (luma; Cb and Cr), then, per tile edge, builds
csrc/deblock.cu with it (ops/deblock.py TILE, the halos unchanged) and
times each call with CUDA events (reps launches queued behind a held
card, in the order of --tiles and then reversed), each output held
against the plain version.  Prints one JSON line per tile edge, with
the card's name and power limit.  Needs a CUDA card.  The same sweep
times csrc/alf.cu (main(kernel="alf"), tools/alf_tiles.py, which adds
what it times and reports), whose tiles are shapes TH x TW (--tiles
16x64 8x128 ...).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..models.vvc.decoder import VVCDecoder
from ..models.vvc.pipeline import KERNELS, walk_frames
from ..ops import alf as A
from ..ops import deblock as D

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "testdata")
# per kernel: its module (TILE, _lib, _get_kernel), its entry point, its
# plain version and the tiles swept by default (deblock: edges; alf:
# shapes TH x TW)
SWEEPS = {"deblock": (D, D.deblock_planes, D.deblock_planes_plain,
                      [32, 48, 64]),
          "alf": (A, A.alf_planes, A.alf_planes_plain,
                  [(16, 64), (8, 64), (16, 32), (32, 32), (8, 128), (32, 64),
                   (4, 128)])}


def _tile(s):
  """A tile edge ("48") or shape ("16x64")."""
  return tuple(int(v) for v in s.split("x")) if "x" in s else int(s)


def b_frame_calls(path, kernel="deblock"):
  """The `kernel` calls of the stream's first B frame: [(label, kwargs)]."""
  with open(path, "rb") as f:
    aus = VVCDecoder(device="cuda")._split_aus(f.read())
  calls = []

  def record(name, label, kw):
    if name == kernel:
      calls.append((label, kw))
    return KERNELS[name][0](**kw)

  for fs, _ in walk_frames(aus, "cuda", record):
    if fs.slice_type == 0:
      return calls
    calls.clear()
  raise RuntimeError(f"{path}: no B frame")


def time_call(kw, want, reps, fn):
  """ms per launch of fn (after one untimed launch: the first loads the
  module) and the launches unequal to `want`; kw and want may be lists of
  calls made in turn (ms per turn)."""
  kws, wants = (kw, want) if isinstance(kw, list) else ([kw], [want])
  for k in kws:
    fn(**k)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  torch.cuda._sleep(100_000_000)  # hold the card: time launches, not Python
  start.record()
  outs = [fn(**k) for _ in range(reps) for k in kws]
  end.record()
  torch.cuda.synchronize()
  return (start.elapsed_time(end) / reps,
          sum(not torch.equal(o, wants[i % len(kws)])
              for i, o in enumerate(outs)))


def _alone(calls, want):
  """Each call timed alone: [(label, kwargs, want)]."""
  return [(label, kw, w) for (label, kw), w in zip(calls, want)]


def main(argv=None, kernel="deblock", runs=_alone, report=None) -> int:
  """The sweep.  runs(calls, want) -> [(label, kwargs or a list of
  kwargs called in turn, want)]: what is timed per tile (each call alone
  by default); report(tile, calls, ms) -> dict: more keys of the tile's
  line (none by default)."""
  mod, fn, plain, tiles = SWEEPS[kernel]
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--tiles", type=_tile, nargs="+", default=tiles)
  ap.add_argument("--stream", default=os.path.join(TESTDATA, "full1080.vvc"))
  ap.add_argument("--reps", type=int, default=20)
  a = ap.parse_args(argv)
  if not torch.cuda.is_available():
    print(f"{kernel}_tiles: needs a CUDA card", file=sys.stderr)
    return 1
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True).stdout.strip().splitlines()[0]
  calls = b_frame_calls(a.stream, kernel)
  want = [plain(**kw) for _, kw in calls]
  default = mod.TILE
  try:
    for tile in a.tiles + a.tiles[::-1]:
      mod.TILE, mod._lib = tile, None
      mod._get_kernel()
      ms = {}
      for label, kw, w in runs(calls, want):
        t, unequal = time_call(kw, w, a.reps, fn)
        if unequal:
          print(f"{kernel}_tiles: tile {tile} {label}: {unequal} launches "
                "differ from the plain version", file=sys.stderr)
          return 1
        ms[label] = t
      line = {"tile": tile, "ms": ms, "ms_frame": sum(ms.values())}
      line.update(report(tile, calls, ms) if report else {})
      print(json.dumps({**line, "card": card,
                        "stream": os.path.basename(a.stream),
                        "reps": a.reps}), flush=True)
  finally:
    mod.TILE, mod._lib = default, None
  return 0


if __name__ == "__main__":
  sys.exit(main())
