"""Light header sniffing for container metadata (the vvc_parser.c
width/height/pix_fmt export analog, without full PS derivation).

sniff_sps reads just the SPS prefix fields needed by vvcC and probing:
resolution, chroma format, bit depth, profile/tier/level
(spec 7.3.2.4 field order).
"""
from __future__ import annotations

from ..bitstream.bits import BitReader, nal_unescape


def _profile_tier_level(r: BitReader, max_sublayers_minus1: int) -> dict:
    profile_idc = r.u(7)
    tier = r.u(1)
    level = r.u(8)
    r.u(1)  # ptl_frame_only_constraint_flag
    r.u(1)  # ptl_multilayer_enabled_flag
    if r.u(1):  # gci_present_flag
        # 71 defined constraint flags + gci_num_additional_bits
        for _ in range(71):
            r.u(1)
        extra = r.u(8)
        for _ in range(extra):
            r.u(1)
    r.byte_align()
    present = [r.u(1) for _ in range(max_sublayers_minus1)]
    r.byte_align()
    for p in present:
        if p:
            r.u(8)
    num_sub_profiles = r.u(8)
    for _ in range(num_sub_profiles):
        r.u(32)
    return {"profile_idc": profile_idc, "tier": tier, "level": level}


def sniff_sps(raw_nal: bytes) -> dict:
    """raw_nal: SPS NAL (2-byte header + escaped payload); a leading
    annex-B start code, if present, is skipped."""
    if raw_nal[:3] == b"\x00\x00\x01":
        raw_nal = raw_nal[3:]
    elif raw_nal[:4] == b"\x00\x00\x00\x01":
        raw_nal = raw_nal[4:]
    r = BitReader(nal_unescape(raw_nal[2:]))
    r.u(4)  # sps_seq_parameter_set_id
    r.u(4)  # sps_video_parameter_set_id
    max_sub_m1 = r.u(3)
    chroma = r.u(2)
    ctu_log2 = r.u(2) + 5
    ptl = {}
    if r.u(1):  # sps_ptl_dpb_hrd_params_present_flag
        ptl = _profile_tier_level(r, max_sub_m1)
    r.u(1)  # sps_gdr_enabled_flag
    if r.u(1):  # sps_ref_pic_resampling_enabled_flag
        r.u(1)
    width = r.ue()
    height = r.ue()
    if r.u(1):  # sps_conformance_window_flag
        for _ in range(4):
            r.ue()
    if r.u(1):  # sps_subpic_info_present_flag
        raise ValueError("subpic sniff unsupported")
    bit_depth = r.ue() + 8
    return {"width": width, "height": height, "chroma_format_idc": chroma,
            "bit_depth": bit_depth, "ctu_log2": ctu_log2, **ptl}
