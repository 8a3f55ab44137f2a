"""Minimal ISO-BMFF (MP4/MOV) demuxer + muxer for VVC tracks.

Read side mirrors what mov.c needs for `vvc1`/`vvi1` sample entries:
box walk -> stsd/vvcC + stsz/stsc/stco sample tables -> length-prefixed
samples.  Write side is the movenc.c `mov_write_vvcc_tag` path
(movenc.c:1477-1490) reduced to a single-track, single-chunk video
file that the reference demuxer accepts.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field


def _boxes(data: bytes, start: int = 0, end: int | None = None):
    """Yield (type, payload_start, payload_end) for sibling boxes."""
    end = len(data) if end is None else end
    i = start
    while i + 8 <= end:
        size = int.from_bytes(data[i:i + 4], "big")
        btype = data[i + 4:i + 8]
        hdr = 8
        if size == 1:
            size = int.from_bytes(data[i + 8:i + 16], "big")
            hdr = 16
        elif size == 0:
            size = end - i
        if size < hdr or i + size > end:
            break
        yield btype, i + hdr, i + size
        i += size


def _find(data: bytes, path: list[bytes], start=0, end=None):
    """Return (payload_start, payload_end) of the first box at path."""
    if not path:
        return start, len(data) if end is None else end
    for btype, s, e in _boxes(data, start, end):
        if btype == path[0]:
            if len(path) == 1:
                return s, e
            return _find(data, path[1:], s, e)
    return None


@dataclass
class Mp4Track:
    vvcc: bytes = b""           # vvcC payload
    samples: list = field(default_factory=list)  # length-prefixed bytes
    width: int = 0
    height: int = 0


def read_mp4_vvc(data: bytes) -> Mp4Track:
    """Extract the (first) VVC track."""
    tr = Mp4Track()
    moov = _find(data, [b"moov"])
    if moov is None:
        raise ValueError("no moov box")
    for btype, ts, te in _boxes(data, *moov):
        if btype != b"trak":
            continue
        stbl = _find(data, [b"mdia", b"minf", b"stbl"], ts, te)
        if stbl is None:
            continue
        stsd = _find(data, [b"stsd"], *stbl)
        if stsd is None:
            continue
        entry = None
        for etype, es, ee in _boxes(data, stsd[0] + 8, stsd[1]):
            if etype in (b"vvc1", b"vvi1"):
                entry = (es, ee)
                break
        if entry is None:
            continue
        # VisualSampleEntry: 6 reserved + 2 data_ref_idx + 70 bytes
        tr.width = int.from_bytes(data[entry[0] + 24:entry[0] + 26], "big")
        tr.height = int.from_bytes(data[entry[0] + 26:entry[0] + 28], "big")
        cfg = _find(data, [b"vvcC"], entry[0] + 78, entry[1])
        if cfg is None:
            raise ValueError("vvc1 entry without vvcC")
        # VvcConfigurationBox is a FullBox: 1 byte version + 3 flags
        tr.vvcc = data[cfg[0] + 4:cfg[1]]

        def table(name):
            loc = _find(data, [name], *stbl)
            return None if loc is None else data[loc[0]:loc[1]]

        stsz = table(b"stsz")
        default_size = int.from_bytes(stsz[4:8], "big")
        count = int.from_bytes(stsz[8:12], "big")
        sizes = ([default_size] * count if default_size else
                 [int.from_bytes(stsz[12 + 4 * i:16 + 4 * i], "big")
                  for i in range(count)])
        stco = table(b"stco")
        if stco is not None:
            n_chunks = int.from_bytes(stco[4:8], "big")
            offsets = [int.from_bytes(stco[8 + 4 * i:12 + 4 * i], "big")
                       for i in range(n_chunks)]
        else:
            co64 = table(b"co64")
            n_chunks = int.from_bytes(co64[4:8], "big")
            offsets = [int.from_bytes(co64[8 + 8 * i:16 + 8 * i], "big")
                       for i in range(n_chunks)]
        stsc = table(b"stsc")
        n_stsc = int.from_bytes(stsc[4:8], "big")
        stsc_rows = [(int.from_bytes(stsc[8 + 12 * i:12 + 12 * i], "big"),
                      int.from_bytes(stsc[12 + 12 * i:16 + 12 * i], "big"))
                     for i in range(n_stsc)]  # (first_chunk, samples/chunk)
        # expand sample->offset
        si = 0
        for ci, coff in enumerate(offsets):
            spc = 0
            for first, cnt in stsc_rows:
                if ci + 1 >= first:
                    spc = cnt
            pos = coff
            for _ in range(spc):
                if si >= len(sizes):
                    break
                tr.samples.append(data[pos:pos + sizes[si]])
                pos += sizes[si]
                si += 1
        return tr
    raise ValueError("no VVC track found")


def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def annexb_to_mp4(data: bytes) -> bytes:
    """Annex-B VVC stream -> single-track MP4 (vvcC extradata +
    length-prefixed samples grouped per access unit)."""
    from .sniff import sniff_sps
    from .vvcc import annexb_sample_to_mp4, vvcc_from_annexb, write_vvcc

    rec, others = vvcc_from_annexb(data)
    samples, cur = [], []
    for nal in others:
        cur.append(nal)
        if (nal[1] >> 3) <= 10:  # slice closes the AU
            samples.append(annexb_sample_to_mp4(cur))
            cur = []
    if cur:
        samples.append(annexb_sample_to_mp4(cur))
    sps_raw = rec.arrays.get(15, [None])[0]
    info = sniff_sps(sps_raw) if sps_raw else {"width": 0, "height": 0}
    return write_mp4_vvc(samples, write_vvcc(rec), info["width"],
                         info["height"])


def write_mp4_vvc(samples: list[bytes], vvcc_payload: bytes, width: int,
                  height: int, timescale: int = 25600,
                  sample_dur: int = 1024) -> bytes:
    """Single-track VVC MP4 (one chunk, constant duration)."""
    n = len(samples)
    mdat_payload = b"".join(samples)
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) +
                b"isomiso2mp41")
    # chunk offset: ftyp + moov sizes known only after moov is built;
    # build moov with a placeholder then patch stco
    dur = n * sample_dur

    def full(btype, version, flags, payload):
        return _box(btype, bytes([version]) + flags.to_bytes(3, "big") +
                    payload)

    mvhd = full(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, timescale, dur) + struct.pack(">IH", 0x00010000, 0x0100)
        + b"\x00" * 10 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0,
                                     0, 0x40000000) + b"\x00" * 24 +
        struct.pack(">I", 2))
    tkhd = full(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 1, 0, dur) +
                b"\x00" * 16 + struct.pack(
                    ">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000) +
                struct.pack(">II", width << 16, height << 16))
    mdhd = full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, dur) +
                struct.pack(">HH", 0x55C4, 0))
    hdlr = full(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide" +
                b"\x00" * 12 + b"VideoHandler\x00")
    vmhd = full(b"vmhd", 0, 1, b"\x00" * 8)
    dref = full(b"dref", 0, 0, struct.pack(">I", 1) +
                full(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    vvcc = _box(b"vvcC", b"\x00\x00\x00\x00" + vvcc_payload)  # version+flags
    sample_entry = _box(b"vvc1", b"\x00" * 6 + struct.pack(">H", 1) +
                        b"\x00" * 16 + struct.pack(">HH", width, height) +
                        struct.pack(">II", 0x00480000, 0x00480000) +
                        struct.pack(">I", 0) + struct.pack(">H", 1) +
                        b"\x00" * 32 + struct.pack(">Hh", 0x18, -1) + vvcc)
    stsd = full(b"stsd", 0, 0, struct.pack(">I", 1) + sample_entry)
    stts = full(b"stts", 0, 0, struct.pack(">III", 1, n, sample_dur))
    stsc = full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = full(b"stsz", 0, 0, struct.pack(">II", 0, n) +
                b"".join(struct.pack(">I", len(s)) for s in samples))
    stco_placeholder = full(b"stco", 0, 0, struct.pack(">II", 1, 0))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco_placeholder)
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    trak = _box(b"trak", tkhd + mdia)
    moov = _box(b"moov", mvhd + trak)
    mdat_off = len(ftyp) + len(moov) + 8
    moov = moov.replace(full(b"stco", 0, 0, struct.pack(">II", 1, 0)),
                        full(b"stco", 0, 0,
                             struct.pack(">II", 1, mdat_off)), 1)
    return ftyp + moov + _box(b"mdat", mdat_payload)
