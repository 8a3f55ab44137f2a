"""Input probing + demuxer dispatch (the av_probe_input_format /
demuxer-registry analog).

Annex-B VVC probe mirrors libavformat/vvcdec.c:27-76: scan NAL
headers, count parameter sets and valid slice units, reject on
malformed header bits.  ISO-BMFF is detected by box structure and
routed through the mp4->annexb conversion (bsf/vvc_mp4toannexb.c).
"""
from __future__ import annotations

from ..bitstream.bits import split_annexb_raw
from .isobmff import read_mp4_vvc
from .vvcc import extradata_to_annexb, mp4_sample_to_annexb

_MP4_BRANDS = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide")


def probe_vvc_annexb(data: bytes) -> int:
    """Score 0-100 (AVPROBE_SCORE style; vvc_probe, vvcdec.c:43-76)."""
    sps = pps = irap = slices = 0
    try:
        nals = split_annexb_raw(data)
    except Exception:
        return 0
    for t, layer, tid, raw in nals:
        if layer != 0 or t > 27:
            return 0
        if len(raw) < 3:
            return 0
        if t == 15:
            sps += 1
        elif t == 16:
            pps += 1
        elif t in (7, 8, 9, 10):
            irap += 1
            slices += 1
        elif t <= 6:
            slices += 1
    if sps and pps and (irap or slices):
        return 51  # > AVPROBE_SCORE_EXTENSION
    return 0


def probe_format(data: bytes) -> str:
    if len(data) >= 8 and data[4:8] in _MP4_BRANDS:
        return "mp4"
    if probe_vvc_annexb(data[:1 << 16] if len(data) > 1 << 16 else data):
        return "vvc-annexb"
    return "unknown"


def open_input(src) -> tuple[bytes, dict]:
    """Accepts a path or bytes; returns (annexb_bytes, info).  Input that
    is neither annex-B VVC nor MP4 raises ValueError.

    info carries container metadata: format, nal_length_size (mp4),
    width/height when the container declares them.
    """
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    fmt = probe_format(data)
    if fmt == "mp4":
        tr = read_mp4_vvc(data)
        extradata, nsz = extradata_to_annexb(tr.vvcc)
        out = bytearray(extradata)
        for s in tr.samples:
            out += mp4_sample_to_annexb(s, nsz)
        return bytes(out), {"format": "mp4", "nal_length_size": nsz,
                            "width": tr.width, "height": tr.height}
    if fmt == "vvc-annexb":
        return data, {"format": "vvc-annexb"}
    raise ValueError("unrecognized input format (not annex-B VVC or MP4)")
