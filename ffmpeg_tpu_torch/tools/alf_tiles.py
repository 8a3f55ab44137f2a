"""Time the ALF kernel built at several tile shapes on a real frame.

  python -m ffmpeg_tpu_torch.tools.alf_tiles [--tiles 16x64 8x128 ...]
      [--stream ffmpeg_tpu_torch/testdata/full1080.vvc] [--reps 20]
  python -m ffmpeg_tpu_torch.tools.alf_tiles --ablations [--stream ...]
      [--reps 20]

deblock_tiles's sweep for csrc/alf.cu: walks the stream on the card to
its first B frame, keeps that frame's ALF calls (luma; Cb and Cr), then,
per tile shape TH x TW (TH x TW luma samples a block, TH x TW/2 of each
chroma plane), builds the kernel with it (ops/alf.py TILE) and times
each call alone and the frame's pair, luma then Cb and Cr overlapping
it, with CUDA events (reps calls queued behind a held card, in the order
of --tiles and then reversed), each output held against the plain
version.  Prints one JSON line per shape with each call's launch (grid,
resident blocks per SM, tiles per block, shared bytes), the kernels'
registers (ptxas) and the card's name and power limit.  Needs a CUDA
card.

--ablations times the kernel at ops/alf.py's TILE against one change at
a time, each in the order design, change, change, design, on the same
calls (luma alone, Cb and Cr alone, and the pair): a block per tile
instead of the persistent grid; 4-byte copies only; the chroma launch
not overlapping the luma launch.  One JSON line per change, each output
held against the plain version.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

from ..ops import alf as A
from ..utils.build import BUILD_LOG
from .deblock_tiles import TESTDATA, b_frame_calls, main, time_call


def _runs(calls, want, overlap=True):
  """Each call alone, then the frame's pair as the frame program queues
  it: luma, then Cb and Cr asking to overlap it."""
  (_, kl), (_, kc) = calls
  return [(label, kw, w) for (label, kw), w in zip(calls, want)] + [
      ("pair", [kl, dict(kc, overlap=overlap)], want)]


# per tile shape, ptxas's lines from its first build (a rebuild of the
# same shape finds the library built and prints none)
_PTXAS = {}


def _report(tile, calls, ms):
  """The sweep line's launches and registers; its ms_frame, the pair's."""
  regs = _PTXAS.setdefault(tile, [
      ln for ln in BUILD_LOG.get("alf", {}).get("ptxas", [])
      if "registers" in ln or "Compiling" in ln])
  return {"ms_frame": ms["pair"], "ptxas": regs, "launch": {
      label: A.launch_plan(chroma=kw["chroma"], W=kw["W"], H=kw["H"])
      for label, kw in calls}}


def _times(calls, want, reps, overlap=True, **opt):
  """ms of luma alone, chroma alone and the pair, and the outputs unequal
  to the plain version's; opt: _alf_cuda's ablation arguments."""
  def fn(planes, alf, luma=None, **kw):
    return A._alf_cuda(planes, alf, luma=luma, **kw, **opt)

  out, bad = {}, 0
  for label, kw, w in _runs(calls, want, overlap):
    out[label], unequal = time_call(kw, w, reps, fn)
    bad += unequal
  return out, bad


def ablations(argv=None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--ablations", action="store_true")
  ap.add_argument("--stream", default=os.path.join(TESTDATA, "full1080.vvc"))
  ap.add_argument("--reps", type=int, default=20)
  a = ap.parse_args(argv)
  if not torch.cuda.is_available():
    print("alf_tiles: needs a CUDA card", file=sys.stderr)
    return 1
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True).stdout.strip().splitlines()[0]
  calls = b_frame_calls(a.stream, "alf")
  want = [A.alf_planes_plain(**kw) for _, kw in calls]
  changes = {"block per tile": dict(max_blocks=1 << 30),
             "4-byte copies": dict(scalar=True),
             "no overlap": dict(overlap=False)}
  for name, opt in changes.items():
    res, bad = {"design": [], "change": []}, 0
    for which in ("design", "change", "change", "design"):
      t, b = _times(calls, want, a.reps, **(opt if which == "change" else {}))
      res[which].append(t)
      bad += b
    if bad:
      print(f"alf_tiles: {name}: {bad} calls differ from the plain version",
            file=sys.stderr)
      return 1
    print(json.dumps({"change": name, "tile": A.TILE, "ms": res,
                      "card": card, "stream": os.path.basename(a.stream),
                      "reps": a.reps}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(ablations() if "--ablations" in sys.argv
           else main(kernel="alf", runs=_runs, report=_report))
