"""CLI decoder: VVC (annex-B or MP4) in, frame hashes / raw YUV out.

The port's `ffmpeg -i x.vvc -f framemd5 -` analog.  The input container
is probed (formats/probe.py): MP4/ISO-BMFF samples go through the
vvcC/mp4toannexb conversion; input that is neither annex-B nor MP4
exits non-zero with a message.  Runs on the CUDA device unless
`--device cpu` is given; without a CUDA device the default refuses to
start rather than fall back.

  python -m ffmpeg_tpu_torch.tools.decode stream.vvc [--device cpu]
  python -m ffmpeg_tpu_torch.tools.decode stream.mp4 [--device cpu]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description="decode VVC to frame MD5 / yuv")
  p.add_argument("input")
  p.add_argument("--framemd5", action="store_true",
                 help="print one MD5 line per frame (default)")
  p.add_argument("--yuv", help="write raw planar YUV to this path")
  p.add_argument("--strict", action="store_true",
                 help="raise on stream errors instead of containing")
  p.add_argument("--device", default="cuda",
                 help="torch device to decode on: cuda (default) or cpu")
  args = p.parse_args(argv)

  from ..formats import open_input
  from ..models.vvc.decoder import DecoderConfig, VVCDecoder

  try:
    data, _info = open_input(args.input)
  except ValueError as e:
    raise SystemExit(f"{args.input}: {e}")
  dec = VVCDecoder(device=args.device, config=DecoderConfig(
      errors="raise" if args.strict else "contain"))
  yuv = open(args.yuv, "wb") if args.yuv else None
  n = 0
  for frame in dec.decode(data):
    print(f"{n}, {frame.poc}, {frame.width}x{frame.height}, {frame.md5()}")
    if yuv:
      for plane in frame.planes:
        yuv.write(plane.tobytes())
    n += 1
  if yuv:
    yuv.close()
  print(f"decoded {n} frames", file=sys.stderr)
  return 0


if __name__ == "__main__":
  sys.exit(main())
