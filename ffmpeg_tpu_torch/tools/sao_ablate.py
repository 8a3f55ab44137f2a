"""Time the SAO and LMCS inverse-map kernels against copies of their
sources with one change each, on a real frame.

  python -m ffmpeg_tpu_torch.tools.sao_ablate
      [--stream ffmpeg_tpu_torch/testdata/full1080.vvc] [--reps 20]

Walks the stream on the card to its first B frame and keeps its sao
calls (luma; Cb and Cr) and its lmcs_inv call.  Then, per change, builds
a copy of csrc/sao.cu or csrc/lmcs.cu with that one change in a
temporary directory and times the design's kernel and the changed copy
in the order design, change, change, design (CUDA events, reps launches
queued behind a held card): for sao each call alone and the frame's
pair, the Cb and Cr call overlapping the luma call.  The changes:

  sao "copy only"     the filtering off: the same tile copies, offset
                      tables and clip (its outputs are not the plain
                      version's, and are not held against it)
  sao "one stage"     NSTAGE 1: no copies in flight while a tile is
                      filtered
  sao "three stages"  NSTAGE 3
  sao "tile a block"  a block per tile instead of the persistent grid
  lmcs_inv "map off"  the map replaced by x + 1: the same loads and
                      stores (not held against the plain version)
  lmcs_inv "2 runs a round"  INV_LOADS 2

Every other output is held against the plain version, and a difference
fails the run.  Prints one JSON line per change, with the card's name
and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

from ..ops import lmcs as L
from ..ops import sao as S
from ..utils import build
from .deblock_tiles import TESTDATA, b_frame_calls, time_call

# (kernel, change, the text replaced, its replacement, outputs held)
CHANGES = [
    ("sao", "copy only",
     "const bool band = q.x == 1, edge = q.x == 2 && n_in > 0;",
     "const bool band = false, edge = false;", False),
    ("sao", "one stage", "#define NSTAGE 2", "#define NSTAGE 1", True),
    ("sao", "three stages", "#define NSTAGE 2", "#define NSTAGE 3", True),
    ("sao", "tile a block", "out[1] = (int)(tiles < cap ? tiles : cap);",
     "out[1] = (int)tiles;", True),
    ("lmcs_inv", "map off",
     "                                       const int2* seg) {\n",
     "                                       const int2* seg) {\n"
     "  return x + 1;\n", False),
    ("lmcs_inv", "2 runs a round", "#define INV_LOADS 1 ",
     "#define INV_LOADS 2 ", True),
]
_MODS = {"sao": (S, "sao"), "lmcs_inv": (L, "lmcs")}


def _variant(kernel, old, new, tmp, k):
  """The kernel's library built from a copy of its source with `old`
  replaced by `new`, named by the change's index k (a library loaded once
  stays loaded under its path); ptxas's lines."""
  mod, lib = _MODS[kernel]
  with open(mod._SRC) as f:
    src = f.read()
  if src.count(old) != 1:
    raise RuntimeError(f"{kernel}: the change's text is not in {mod._SRC} "
                       "exactly once")
  path = os.path.join(tmp, f"{lib}_{k}.cu")
  with open(path, "w") as f:
    f.write(src.replace(old, new))
  out = os.path.join(tmp, f"lib{lib}_{k}.so")
  proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, path],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for {kernel}:\n{proc.stderr}")
  return out, [ln.strip() for ln in proc.stderr.splitlines()
               if "registers" in ln or "spill" in ln]


def _use(kernel, path=None):
  """Load the kernel's library: the design's (path None) or a variant."""
  mod, _ = _MODS[kernel]
  real = build.build_cuda
  if path is not None:
    build.build_cuda = lambda name, sources, defines=(): path
  try:
    mod._lib = None
    mod._get_kernel()
  finally:
    build.build_cuda = real


def _runs(kernel, calls, want):
  """[(label, kwargs or a list of kwargs called in turn, want)]."""
  if kernel == "lmcs_inv":
    return [("luma", calls["lmcs_inv"], want["lmcs_inv"])]
  kl, kc = calls["luma"], calls["chroma"]
  return [("luma", kl, want["luma"]), ("chroma", kc, want["chroma"]),
          ("pair", [kl, dict(kc, overlap=True)],
           [want["luma"], want["chroma"]])]


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--stream", default=os.path.join(TESTDATA, "full1080.vvc"))
  ap.add_argument("--reps", type=int, default=20)
  a = ap.parse_args(argv)
  if not torch.cuda.is_available():
    print("sao_ablate: needs a CUDA card", file=sys.stderr)
    return 1
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True).stdout.strip().splitlines()[0]
  calls = dict(b_frame_calls(a.stream, "sao"))
  calls["lmcs_inv"] = dict(b_frame_calls(a.stream, "lmcs_inv"))["luma"]
  want = {"luma": S.sao_planes_plain(**calls["luma"]),
          "chroma": S.sao_planes_plain(**calls["chroma"]),
          "lmcs_inv": L.lmcs_inv_plain(**calls["lmcs_inv"])}
  fns = {"sao": S.sao_planes, "lmcs_inv": L.lmcs_inv}
  with tempfile.TemporaryDirectory() as tmp:
    for k, (kernel, name, old, new, held) in enumerate(CHANGES):
      path, ptxas = _variant(kernel, old, new, tmp, k)
      res = {"design": [], "change": []}
      for which in ("design", "change", "change", "design"):
        _use(kernel, path if which == "change" else None)
        ms = {}
        for label, kw, w in _runs(kernel, calls, want):
          ms[label], unequal = time_call(kw, w, a.reps, fns[kernel])
          if unequal and (held or which == "design"):
            print(f"sao_ablate: {kernel} {name} ({which}) {label}: "
                  f"{unequal} launches differ from the plain version",
                  file=sys.stderr)
            return 1
        res[which].append(ms)
      _use(kernel)
      print(json.dumps({"kernel": kernel, "change": name, "ms": res,
                        "ptxas": ptxas, "held": held, "card": card,
                        "stream": os.path.basename(a.stream),
                        "reps": a.reps}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
