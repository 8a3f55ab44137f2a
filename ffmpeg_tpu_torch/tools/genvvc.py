"""Generate a random legal VVC bitstream (CLI over the conformance encoder).

Every EncoderConfig field becomes a CLI flag (underscores -> dashes);
booleans are store_true flags. The chosen syntax intent is written next
to the output as ``<out>.intent.json`` for debugging mismatches.

Usage: python -m ffmpeg_tpu_torch.tools.genvvc --width 96 --height 64 \
           --seed 2007 --inter --b-slices --weighted-pred -o x.vvc
"""
import argparse
import dataclasses
import json
import sys


def main() -> int:
    from ffmpeg_tpu_torch.encoder.encoder import EncoderConfig, encode_stream

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--output", required=True)
    for f in dataclasses.fields(EncoderConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type is bool or isinstance(f.default, bool):
            ap.add_argument(flag, dest=f.name, action="store_true",
                            default=f.default)
        elif isinstance(f.default, tuple):
            # e.g. --tile-cols 2,1 (comma-separated ints)
            ap.add_argument(flag, dest=f.name, default=f.default,
                            type=lambda s: tuple(
                                int(v) for v in s.split(",") if v))
        else:
            ap.add_argument(flag, dest=f.name, type=type(f.default),
                            default=f.default)
    args = ap.parse_args()

    cfg = EncoderConfig(**{f.name: getattr(args, f.name)
                           for f in dataclasses.fields(EncoderConfig)})
    data, intent = encode_stream(cfg)
    with open(args.output, "wb") as fh:
        fh.write(data)
    with open(args.output + ".intent.json", "w") as fh:
        json.dump(intent, fh, default=str)
    print(f"{args.output}: {len(data)} bytes, "
          f"{cfg.n_frames} frames {cfg.width}x{cfg.height}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
