"""Count the memory instructions of each kernel function in a built
kernel library, from its SASS (`cuobjdump -sass`, CUDA toolkit):

  python -m ffmpeg_tpu_torch.tools.sass_loads LIB.so [LIB.so ...]
      [--function NAME] [--dump DIR]

prints one JSON line per library (or per SASS text that an earlier
--dump wrote, a file named *.sass): for each kernel function (mangled
name) its instruction count and its counts of shared loads (LDS),
shared stores (STS), constant loads (LDC), global loads (LDG), global
to shared copies (LDGSTS, cp.async) and global stores (STG), in the
whole function and inside its loops (the
instructions between a backward branch's target and the branch; the
largest such range is the function's outermost loop).  These are
static counts: an instruction inside a loop runs once per trip.
--function keeps the functions whose name contains NAME; --dump writes
each library's SASS to DIR/<its path, / as _>.sass.  A library needs the card's
toolkit (no card), so it runs where the kernels are built.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

OPS = ("LDS", "STS", "LDC", "LDG", "LDGSTS", "STG")
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*);")
_TARGET = re.compile(r"(0x[0-9a-f]+)")


def _cuobjdump() -> str:
  cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  path = os.path.join(cuda, "bin", "cuobjdump")
  return path if os.path.exists(path) else "cuobjdump"


def sass(lib: str) -> str:
  """The library's SASS text (a .sass file's text as it is); raises when
  cuobjdump fails."""
  if lib.endswith(".sass"):
    with open(lib) as f:
      return f.read()
  proc = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                        text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"cuobjdump failed on {lib}: {proc.stderr.strip()}")
  return proc.stdout


def parse(text: str) -> dict:
  """{function: [(address, opcode, operands)]} from cuobjdump's SASS."""
  funcs: dict = {}
  cur = None
  for line in text.splitlines():
    m = _FUNC.search(line)
    if m:
      cur = funcs.setdefault(m.group(1), [])
      continue
    m = _INSN.search(line)
    if m and cur is not None:
      cur.append((int(m.group(1), 16), m.group(2), m.group(4)))
  return funcs


def counts(insns) -> dict:
  """A function's instruction count and memory instruction counts, in
  all and inside its loops (the outermost loop's range apart)."""
  loops = []
  for addr, op, args in insns:
    if op == "BRA":
      t = _TARGET.search(args)
      if t and int(t.group(1), 16) < addr:
        loops.append((int(t.group(1), 16), addr))

  def tally(lo=None, hi=None):
    sel = [op for a, op, _ in insns if lo is None or lo <= a <= hi]
    return {"instructions": len(sel), **{k: sel.count(k) for k in OPS}}

  out = {"all": tally(), "loops": len(loops)}
  if loops:
    lo, hi = max(loops, key=lambda r: r[1] - r[0])
    out["outer_loop"] = {"range": [hex(lo), hex(hi)], **tally(lo, hi)}
  return out


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("libs", nargs="+")
  ap.add_argument("--function", default="")
  ap.add_argument("--dump", default=None)
  a = ap.parse_args(argv)
  for lib in a.libs:
    text = sass(lib)
    if a.dump:
      os.makedirs(a.dump, exist_ok=True)
      name = os.path.normpath(lib).strip(os.sep).replace(os.sep, "_")
      with open(os.path.join(a.dump, name + ".sass"), "w") as f:
        f.write(text)
    print(json.dumps({"library": lib, "functions": {
        fn: counts(ins) for fn, ins in parse(text).items()
        if a.function in fn}}), flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
