"""Per-predict-unit control rows: the layout of the native control matrix.

The native parser (ctrl::derive in native/decode.cc) emits one
(kNumKeys, n_units) int32 matrix per plane kind; CTRL_KEYS names its
rows in order.  The frame program and the recon kernel read units
through these names.
"""
from __future__ import annotations

CTRL_KEYS = (
    "x0", "y0", "w", "h", "logw", "logh", "mode_class", "angle", "inv_angle",
    "filter_flag", "smooth", "left_size", "top_size", "unfilter_last_one",
    "do_pdpc", "nscale", "avail_l", "avail_t", "cand_up_left",
    "proj_v", "proj_h", "pf", "m0x", "m0y", "m1x", "m1y",
    "r0slot", "r1slot", "chunk",
    "wden", "w0", "w1", "wo0", "wo1", "hpel", "ciipw",
    "gpm_part", "gpm_tx", "gpm_ty", "gpm_lw", "gpm_lh",
    "hyp0lx", "hyp1lx",
    "w0b", "w1b", "wo0b", "wo1b",
    "corner_src",
    "prof", "pdhx0", "pdhy0", "pdvx0", "pdvy0",
    "pdhx1", "pdhy1", "pdvx1", "pdvy1", "bdof",
    "dmvr", "om0x", "om0y", "om1x", "om1y",
    "mip_id", "mip_t", "mip_sz", "cclm", "cclm_vc",
    "cclm_ct", "cclm_cl", "cclm_p0", "cclm_p1", "cclm_p2", "cclm_p3",
    "mrl")

MC_INTER = 6  # extra mode class: prediction comes from the MC plane
MC_MIP = 7    # matrix-based intra prediction (8.4.5.2.2)
MC_CCLM = 8   # cross-component linear model (8.4.5.2.14)


def _round_up(v: int, m: int) -> int:
  return (v + m - 1) // m * m
