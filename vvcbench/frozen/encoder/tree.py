"""Coding-tree split legality and syntax (encode side).

Mirrors the spec's allowSplit derivation (H.266 6.4.2; parity target
vvc_ctu.c:521-620 can_split) and the split-flag context derivations
(vvc_cabac.c:1086-1180).

The generator additionally restricts itself to "mode-type-safe" splits:
splits whose children would trigger modeTypeCondition (spec 7.4.11.4 —
local dual tree / non-inter signalling in 4:2:0) are not chosen, so
single-tree parsing stays valid until local dual tree is implemented.
"""
from __future__ import annotations

from dataclasses import dataclass

SPLIT_NONE, SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER, SPLIT_BT_VER, SPLIT_QT = \
    0, 1, 2, 3, 4, 5


@dataclass
class PartitionCtx:
    """Slice-level partition constraints (I-slice luma, single tree)."""
    min_cb_size: int = 4
    min_qt_size: int = 8
    max_bt_size: int = 32
    max_tt_size: int = 32
    max_mtt_depth: int = 2
    pic_width: int = 64
    pic_height: int = 64


def can_split(pc: PartitionCtx, x0, y0, w, h, mtt_depth, depth_offset,
              part_idx, last_split_mode, chroma=False) -> dict:
    """Returns {'qt','btv','bth','ttv','tth'} -> bool.  With chroma=True
    applies the DUAL_TREE_CHROMA restrictions (4:2:0; vvc_ctu.c:548-566)
    and pc must hold the chroma-tree constraint set."""
    qt = btv = bth = ttv = tth = True
    if mtt_depth:
        qt = False
    if w <= pc.min_qt_size:
        qt = False
    if chroma:
        chroma_area = (w >> 1) * (h >> 1)
        chroma_width = w >> 1
        if chroma_width == 8:
            ttv = False
        elif chroma_width <= 4:
            if chroma_width == 4:
                btv = False
            qt = False
        if chroma_area <= 32:
            ttv = tth = False
            if chroma_area <= 16:
                btv = bth = False
    max_mtt_depth = pc.max_mtt_depth + depth_offset
    if w <= 2 * pc.min_cb_size:
        ttv = False
        if w <= pc.min_cb_size:
            btv = False
    if h <= 2 * pc.min_cb_size:
        tth = False
        if h <= pc.min_cb_size:
            bth = False
    if w > pc.max_bt_size or h > pc.max_bt_size:
        btv = bth = False
    max_tt = min(64, pc.max_tt_size)
    if w > max_tt or h > max_tt:
        ttv = tth = False
    if mtt_depth >= max_mtt_depth:
        btv = bth = ttv = tth = False
    if x0 + w > pc.pic_width:
        ttv = tth = False
        if h > 64:
            btv = False
        if y0 + h <= pc.pic_height:
            bth = False
        elif w > pc.min_qt_size:
            btv = bth = False
    if y0 + h > pc.pic_height:
        btv = ttv = tth = False
        if w > 64:
            bth = False
    if mtt_depth > 0 and part_idx == 1:
        if last_split_mode == SPLIT_TT_VER:
            btv = False
        elif last_split_mode == SPLIT_TT_HOR:
            bth = False
    if w <= 64 and h > 64:
        btv = False
    if w > 64 and h <= 64:
        bth = False
    return {"qt": qt, "btv": btv, "bth": bth, "ttv": ttv, "tth": tth}


def mode_type_condition_free(w: int, h: int, split: int) -> bool:
    """True if this split does NOT trigger modeTypeCondition in 4:2:0
    I-slices (spec 7.4.11.4; vvc_ctu.c:1826-1846)."""
    area = w * h
    if area == 64 and split in (SPLIT_QT, SPLIT_TT_HOR, SPLIT_TT_VER):
        return False
    if area == 32 and split in (SPLIT_BT_HOR, SPLIT_BT_VER):
        return False
    if area == 64 and split in (SPLIT_BT_HOR, SPLIT_BT_VER):
        return False
    if area == 128 and split in (SPLIT_TT_HOR, SPLIT_TT_VER):
        return False
    if w == 8 and split == SPLIT_BT_VER:
        return False
    if w == 16 and split == SPLIT_TT_VER:
        return False
    return True


def split_children(x0, y0, w, h, split, pic_w, pic_h):
    """Child blocks in coding order: list of
    (x, y, w, h, cqt_delta, mtt_delta, depth_offset_delta, part_idx).
    Skips children fully outside the picture (vvc_ctu.c:1872-2030)."""
    out = []
    if split == SPLIT_QT:
        x1, y1 = x0 + w // 2, y0 + h // 2
        cands = [(x0, y0, 0), (x1, y0, 1), (x0, y1, 2), (x1, y1, 3)]
        for (x, y, idx) in cands:
            if (x == x0 or x < pic_w) and (y == y0 or y < pic_h):
                out.append((x, y, w // 2, h // 2, 1, 0, 0, idx))
    elif split == SPLIT_BT_VER:
        doff = 1 if x0 + w > pic_w else 0
        x1 = x0 + w // 2
        out.append((x0, y0, w // 2, h, 0, 1, doff, 0))
        if x1 < pic_w:
            out.append((x1, y0, w // 2, h, 0, 1, doff, 1))
    elif split == SPLIT_BT_HOR:
        doff = 1 if y0 + h > pic_h else 0
        y1 = y0 + h // 2
        out.append((x0, y0, w, h // 2, 0, 1, doff, 0))
        if y1 < pic_h:
            out.append((x0, y1, w, h // 2, 0, 1, doff, 1))
    elif split == SPLIT_TT_VER:
        out.append((x0, y0, w // 4, h, 0, 1, 0, 0))
        out.append((x0 + w // 4, y0, w // 2, h, 0, 1, 0, 1))
        out.append((x0 + 3 * w // 4, y0, w // 4, h, 0, 1, 0, 2))
    elif split == SPLIT_TT_HOR:
        out.append((x0, y0, w, h // 4, 0, 1, 0, 0))
        out.append((x0, y0 + h // 4, w, h // 2, 0, 1, 0, 1))
        out.append((x0, y0 + 3 * h // 4, w, h // 4, 0, 1, 0, 2))
    return out
