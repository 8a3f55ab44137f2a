"""Diagonal scan order (ITU-T H.266 6.5.2, up-right diagonal).

Computed rather than tabulated; parity target ff_vvc_diag_scan_x/y
(`libavcodec/vvc/vvc_data.c:27-276`).
"""
from functools import lru_cache


@lru_cache(maxsize=None)
def diag_scan(blk_w: int, blk_h: int) -> tuple:
    """Return tuple of (x, y) in scan order for a blk_w x blk_h block."""
    out = []
    x = y = 0
    while len(out) < blk_w * blk_h:
        while y >= 0:
            if x < blk_w and y < blk_h:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return tuple(out)
