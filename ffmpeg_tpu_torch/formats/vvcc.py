"""VvcDecoderConfigurationRecord (`vvcC` box) read/write and the
mp4->annexb conversion.

Parity targets: libavformat/vvc.c:87-428 (ff_isom_write_vvcc builds the
record from SPS/PPS/VPS), libavcodec/bsf/vvc_mp4toannexb.c:39-120
(VvcPTLRecord parse + sample conversion).  Format per ISO/IEC
14496-15:2022 section 11.2.4.2.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.bits import BitReader, BitWriter

_STARTCODE = b"\x00\x00\x00\x01"


def _read_bytes(r: BitReader, n: int) -> bytes:
    assert r.pos % 8 == 0, "vvcC fields are byte-aligned here"
    off = r.pos >> 3
    r.pos += 8 * n
    return bytes(r.data[off:off + n])
# NAL types carried in vvcC arrays, in the order the reference writes
# them (vvc.c:668-724): OPI, VPS, SPS, PPS, prefix APS, prefix SEI
_ARRAY_ORDER = (12, 14, 15, 16, 17, 23)
_NO_COUNT_TYPES = (13, 12)  # DCI/OPI: num_nalus omitted (always 1)


@dataclass
class VvcConfigRecord:
    length_size_minus_one: int = 3
    ptl_present: int = 1
    chroma_format_idc: int = 1
    bit_depth_minus8: int = 0
    max_width: int = 0
    max_height: int = 0
    profile_idc: int = 1
    tier_flag: int = 0
    level_idc: int = 51
    # nal arrays: {nal_type: [rbsp-with-header bytes, ...]}
    arrays: dict = field(default_factory=dict)

    @property
    def nal_length_size(self) -> int:
        return self.length_size_minus_one + 1


def _parse_ptl_record(r: BitReader, num_sublayers: int) -> dict:
    """VvcPTLRecord (14496-15 11.2.4.2.2) — parsed to advance the
    reader; mirrors vvc_mp4toannexb.c:39-76."""
    r.u(2)  # reserved
    num_bytes_constraint_info = r.u(6)
    profile_idc = r.u(7)
    tier = r.u(1)
    level = r.u(8)
    r.u(1)  # ptl_frame_only_constraint_flag
    r.u(1)  # ptl_multi_layer_enabled_flag
    if num_bytes_constraint_info:
        for _ in range(num_bytes_constraint_info - 1):
            r.u(8)
        r.u(6)
    sub_present = []
    for i in range(num_sublayers - 2, -1, -1):
        sub_present.append(r.u(1))
    if num_sublayers > 1:
        for _ in range(8 - (num_sublayers - 1)):
            r.u(1)  # ptl_reserved_zero_bit
        for p in sub_present:
            if p:
                r.u(8)  # sublayer_level_idc
    num_sub_profiles = r.u(8)
    for _ in range(num_sub_profiles):
        r.u(32)
    return {"profile_idc": profile_idc, "tier": tier, "level": level}


def parse_vvcc(data: bytes) -> VvcConfigRecord:
    """Parse a vvcC payload (the box body, after size/type)."""
    r = BitReader(data)
    rec = VvcConfigRecord()
    r.u(5)  # reserved '11111'
    rec.length_size_minus_one = r.u(2)
    rec.ptl_present = r.u(1)
    if rec.ptl_present:
        r.u(9)   # ols_idx
        num_sublayers = r.u(3)
        r.u(2)   # constant_frame_rate
        rec.chroma_format_idc = r.u(2)
        rec.bit_depth_minus8 = r.u(3)
        r.u(5)   # reserved
        ptl = _parse_ptl_record(r, num_sublayers)
        rec.profile_idc = ptl["profile_idc"]
        rec.tier_flag = ptl["tier"]
        rec.level_idc = ptl["level"]
        rec.max_width = r.u(16)
        rec.max_height = r.u(16)
        r.u(16)  # avg_frame_rate
    num_arrays = r.u(8)
    for _ in range(num_arrays):
        r.u(1)  # array_completeness
        r.u(1)  # reserved
        nal_type = r.u(6)
        num = 1 if nal_type in _NO_COUNT_TYPES else r.u(16)
        lst = rec.arrays.setdefault(nal_type, [])
        for _ in range(num):
            ln = r.u(16)
            lst.append(_read_bytes(r, ln))
    return rec


def write_vvcc(rec: VvcConfigRecord) -> bytes:
    """Serialize a vvcC payload (ff_isom_write_vvcc analog)."""
    w = BitWriter()
    w.u(5, 0b11111)
    w.u(2, rec.length_size_minus_one)
    w.u(1, rec.ptl_present)
    if rec.ptl_present:
        w.u(9, 0)               # ols_idx
        w.u(3, 1)               # num_sublayers
        w.u(2, 0)               # constant_frame_rate: unknown
        w.u(2, rec.chroma_format_idc)
        w.u(3, rec.bit_depth_minus8)
        w.u(5, 0b11111)
        # VvcPTLRecord(1): one empty constraint-info byte (keeps the
        # record byte-aligned: 26 + 8*n - 2 bits), no sub profiles
        w.u(2, 0)
        w.u(6, 1)               # num_bytes_constraint_info = 1
        w.u(7, rec.profile_idc)
        w.u(1, rec.tier_flag)
        w.u(8, rec.level_idc)
        w.u(1, 1)               # ptl_frame_only_constraint_flag
        w.u(1, 0)               # ptl_multi_layer_enabled_flag
        w.u(6, 0)               # gci_present=0 + 5 alignment zero bits
        w.u(8, 0)               # num_sub_profiles
        w.u(16, rec.max_width)
        w.u(16, rec.max_height)
        w.u(16, 0)              # avg_frame_rate
    arrays = [(t, rec.arrays[t]) for t in _ARRAY_ORDER if rec.arrays.get(t)]
    w.u(8, len(arrays))
    for nal_type, nalus in arrays:
        w.u(1, 1)               # array_completeness
        w.u(1, 0)
        w.u(6, nal_type)
        if nal_type not in _NO_COUNT_TYPES:
            w.u(16, len(nalus))
        for nalu in nalus:
            w.u(16, len(nalu))
            for b in nalu:
                w.u(8, b)
    return w.to_bytes()


def vvcc_from_annexb(data: bytes) -> tuple[VvcConfigRecord, list[bytes]]:
    """Build a vvcC record from an annex-B stream's parameter sets and
    return (record, remaining sample NALs with headers)."""
    from ..bitstream.bits import split_annexb_raw

    rec = VvcConfigRecord()
    others: list[bytes] = []
    sps_raw = None
    for t, _l, _tid, raw in split_annexb_raw(data):
        nal = raw[3:]  # strip the start code: header + payload
        if t in _ARRAY_ORDER and t != 23:
            rec.arrays.setdefault(t, []).append(nal)
            if t == 15:
                sps_raw = nal
        else:
            others.append(nal)
    if sps_raw is not None:
        # light SPS sniff for the record header fields: resolution,
        # chroma format, bit depth (14496-15 requires them to match)
        from .sniff import sniff_sps

        info = sniff_sps(sps_raw)
        rec.chroma_format_idc = info["chroma_format_idc"]
        rec.bit_depth_minus8 = info["bit_depth"] - 8
        rec.max_width = info["width"]
        rec.max_height = info["height"]
    return rec, others


def mp4_sample_to_annexb(sample: bytes, nal_length_size: int) -> bytes:
    """Length-prefixed sample -> annex-B (vvc_mp4toannexb_filter's
    per-packet loop)."""
    out = bytearray()
    i, n = 0, len(sample)
    while i + nal_length_size <= n:
        ln = int.from_bytes(sample[i:i + nal_length_size], "big")
        i += nal_length_size
        if ln == 0 or i + ln > n:
            break
        out += _STARTCODE + sample[i:i + ln]
        i += ln
    return bytes(out)


def annexb_sample_to_mp4(nals: list[bytes],
                         nal_length_size: int = 4) -> bytes:
    out = bytearray()
    for nal in nals:
        out += len(nal).to_bytes(nal_length_size, "big") + nal
    return bytes(out)


def extradata_to_annexb(vvcc_payload: bytes) -> tuple[bytes, int]:
    """vvcC extradata -> annex-B parameter-set NALs + NAL length size
    (the BSF's extradata path, vvc_mp4toannexb.c:117-171)."""
    rec = parse_vvcc(vvcc_payload)
    out = bytearray()
    for t in _ARRAY_ORDER:
        for nalu in rec.arrays.get(t, []):
            out += _STARTCODE + nalu
    return bytes(out), rec.nal_length_size
