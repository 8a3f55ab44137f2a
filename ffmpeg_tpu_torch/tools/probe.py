"""Stream introspection CLI: the ffprobe analog (fftools/ffprobe.c).

Prints container/stream/frame info for a VVC input (annex-B or MP4) as
text or JSON: codec parameters from the SPS, NAL-level layout, and
per-AU type/POC/size.
"""
from __future__ import annotations

import argparse
import json
import sys

_NAL_NAMES = {
    0: "TRAIL", 1: "STSA", 2: "RADL", 3: "RASL",
    7: "IDR_W_RADL", 8: "IDR_N_LP", 9: "CRA", 10: "GDR",
    12: "OPI", 13: "DCI", 14: "VPS", 15: "SPS", 16: "PPS",
    17: "PREFIX_APS", 18: "SUFFIX_APS", 19: "PH", 20: "AUD",
    21: "EOS", 22: "EOB", 23: "PREFIX_SEI", 24: "SUFFIX_SEI",
}
_PIX_FMT = {(0, 8): "gray", (1, 8): "yuv420p", (1, 10): "yuv420p10le",
            (2, 8): "yuv422p", (2, 10): "yuv422p10le",
            (3, 8): "yuv444p", (3, 10): "yuv444p10le"}


def probe(src) -> dict:
    from ..bitstream.bits import split_annexb_raw
    from ..formats import open_input
    from ..formats.sniff import sniff_sps

    data, info = open_input(src)
    nals = split_annexb_raw(data)
    stream: dict = {"codec_name": "vvc"}
    out = {"format": info, "streams": [stream], "frames": []}
    nal_counts: dict = {}
    au_size = 0
    n_frames = 0
    for t, _l, _tid, raw in nals:
        name = _NAL_NAMES.get(t, str(t))
        nal_counts[name] = nal_counts.get(name, 0) + 1
        au_size += len(raw)
        if t == 15 and "width" not in stream:
            s = sniff_sps(raw)
            stream.update(
                width=s["width"], height=s["height"],
                pix_fmt=_PIX_FMT.get((s["chroma_format_idc"],
                                      s["bit_depth"]), "unknown"),
                bit_depth=s["bit_depth"],
                profile=s.get("profile_idc"), level=s.get("level"),
                ctu_size=1 << s["ctu_log2"])
        if t <= 10:  # slice: AU boundary (one slice per AU v1)
            out["frames"].append({
                "n": n_frames, "type": name,
                "key_frame": int(t in (7, 8, 9)),
                "size": au_size})
            n_frames += 1
            au_size = 0
    stream["nb_frames"] = n_frames
    stream["nal_counts"] = nal_counts
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="inspect a VVC stream")
    p.add_argument("input")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.add_argument("--frames", action="store_true",
                   help="include per-frame lines")
    args = p.parse_args(argv)
    info = probe(args.input)
    if args.json:
        print(json.dumps(info, indent=1))
        return 0
    st = info["streams"][0]
    print(f"Input: {info['format']['format']}, codec vvc")
    if "width" in st:
        print(f"  Stream: {st['pix_fmt']}, {st['width']}x{st['height']}, "
              f"profile {st.get('profile')}, level {st.get('level')}, "
              f"CTU {st.get('ctu_size')}, {st['nb_frames']} frames")
    print("  NAL units: " + ", ".join(
        f"{k}:{v}" for k, v in sorted(st["nal_counts"].items())))
    if args.frames:
        for f in info["frames"]:
            print(f"  frame {f['n']}: {f['type']}"
                  f"{' (key)' if f['key_frame'] else ''}, {f['size']} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
