"""CLI decoder: annex-B VVC in, frame hashes / raw YUV out.

The port's `ffmpeg -i x.vvc -f framemd5 -` analog.  Runs on the CUDA
device unless `--device cpu` is given; without a CUDA device the
default refuses to start rather than fall back.

  python -m ffmpeg_tpu_torch.tools.decode stream.vvc [--device cpu]

The input must be an annex-B byte stream; anything else (an MP4/ISO-BMFF
file among them) is refused with an error rather than decoded to
nothing.
"""
from __future__ import annotations

import argparse
import sys

_START_CODES = (b"\x00\x00\x01", b"\x00\x00\x00\x01")


def check_annexb(data: bytes, path: str) -> None:
  """Refuse input that does not open with an annex-B start code."""
  if data.startswith(_START_CODES):
    return
  what = ("an MP4/ISO-BMFF file" if data[4:8] == b"ftyp"
          else "not an annex-B stream")
  raise SystemExit(f"{path}: {what}; MP4/ISO-BMFF input is not supported "
                   "yet (ROADMAP A4): give an annex-B .vvc stream")


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

  from ..models.vvc.decoder import DecoderConfig, VVCDecoder

  with open(args.input, "rb") as f:
    data = f.read()
  check_annexb(data, args.input)
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
