"""Time the ALF kernel built at several tile edges on a real frame.

  python -m ffmpeg_tpu_torch.tools.alf_tiles [--tiles 16 32 48 64]
      [--stream ffmpeg_tpu_torch/testdata/full1080.vvc] [--reps 20]

deblock_tiles's sweep for csrc/alf.cu: walks the stream on the card to
its first B frame, keeps that frame's ALF calls (luma; Cb and Cr), then,
per tile edge, builds the kernel with it (ops/alf.py TILE) and times each
call with CUDA events (reps launches queued behind a held card, in the
order of --tiles and then reversed), each output held against the plain
version.  Prints one JSON line per tile edge, with the card's name and
power limit.  Needs a CUDA card.
"""
import sys

from .deblock_tiles import main

if __name__ == "__main__":
  sys.exit(main(kernel="alf"))
