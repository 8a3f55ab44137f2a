"""Stream assembly: SPS/PPS + per-frame slices -> annex-B .vvc file.

Also emits an `intent` structure recording every syntax choice, used by
tests to validate the native parser field-by-field, and by the slow
reference model to compute expected pixels.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bits import BitWriter, NAL_IDR_N_LP, NAL_TRAIL, make_nal
from ..cbs.h266 import PPS, RefPicListStruct, SPS, PictureHeader, SliceHeader
from .ctu import CuIntent, FrameSyntaxEncoder


@dataclass
class EncoderConfig:
    def n_frames_total(self):
        return self.n_frames

    width: int = 64
    height: int = 64
    ctu_log2: int = 5  # 32x32 CTU
    qp: int = 32
    n_frames: int = 1
    chroma_format_idc: int = 1  # 4:2:0
    bit_depth: int = 8
    seed: int = 0
    max_level: int = 12  # max abs coefficient level
    coeff_density: float = 0.15  # fraction of nonzero coeffs
    deblock: bool = False  # in-loop deblocking
    sao: bool = False      # sample adaptive offset
    # inter (P/B slices referencing the previous frame)
    inter: bool = False
    b_slices: bool = False   # use B slices (prev frame in both lists)
    inter_prob: float = 0.7  # chance a CU in a P slice is inter
    skip_prob: float = 0.2   # chance an inter CU is skip
    merge_prob: float = 0.5  # chance a non-skip inter CU uses merge
    max_mv: int = 64         # max |MV| component in quarter-pel
    # partition constraints
    min_qt_size: int = 8
    max_mtt_depth: int = 2
    max_bt_size: int = 32
    max_tt_size: int = 32
    # 64-sample transform blocks (sps_max_luma_transform_size_64_flag;
    # requires ctu_log2 >= 6).  Real encoders (VTM/vvenc) default to
    # CTU-128 + TB-64, so this is the wild-stream configuration.
    tb64: bool = False
    # horizontal reference wraparound (360 video; spec 8.5.6.3.2):
    # MC reads wrap at the picture width instead of edge-clamping
    wraparound: bool = False
    # header-layout variants real encoders emit (VERDICT r4 item 4)
    rpl_in_sps: bool = False   # candidate RPLs in the SPS, slices select
    rpl_in_ph: bool = False    # ref_pic_lists() in the picture header
    alf_in_ph: bool = False    # ALF on/off + APS ids in the PH
    deblock_override: bool = False  # per-slice deblock offset override
    deblock_in_ph: bool = False     # deblock params in the PH
    split_prob: float = 0.6  # chance of splitting at each eligible node
    # transform tools
    mts: bool = False           # explicit MTS (intra + inter mts_idx)
    mts_implicit: bool = False  # sps_mts on, explicit off (DST7 4..16)
    # per-QG delta QP
    cu_qp_delta: bool = False
    cu_qp_delta_subdiv: int = 2
    # joint chroma residual coding
    joint_cbcr: bool = False
    # emit the picture header as its own PH NAL (PH_NUT) instead of
    # inside the slice header (sh_picture_header_in_slice_header_flag=0)
    separate_ph: bool = False
    # dependent quantization / sign data hiding (mutually exclusive in a
    # slice: SDH flag is only written when dep-quant is off, 7.3.7)
    dep_quant: bool = False
    sign_hiding: bool = False
    # transform skip
    transform_skip: bool = False
    ts_max_size: int = 8
    # BDPCM (requires transform_skip SPS machinery)
    bdpcm: bool = False
    # LFNST secondary transform
    lfnst: bool = False
    # explicit scaling lists (APS-carried dequant matrices, 7.3.2.21)
    scaling_lists: bool = False
    # LMCS (luma mapping with chroma scaling): random APS model
    lmcs: bool = False
    # ALF / CC-ALF: random APS filters + per-CTB flags
    alf: bool = False
    ccalf: bool = False
    # inter toolset wave 1
    amvr: bool = False
    bcw: bool = False
    mmvd: bool = False
    mmvd_fullpel: bool = False
    ciip: bool = False
    gpm: bool = False
    # explicit weighted prediction (disjoint from bcw in generated
    # streams: bcw coding is gated on unweighted refs)
    weighted_pred: bool = False
    # random-access GOP-4 pyramid: multi-ref B slices + output reorder
    # (requires inter; n_frames should be 4k+1)
    ra: bool = False
    # temporal motion vector prediction (collocated-picture candidates)
    tmvp: bool = False
    sbtmvp: bool = False  # subblock temporal MVP (implies tmvp)
    affine: bool = False  # affine motion (merge + AMVP, 4/6-param)
    prof: bool = False    # affine prediction refinement w/ optical flow
    bdof: bool = False    # bi-directional optical flow
    dmvr: bool = False    # decoder-side motion vector refinement
    sbt: bool = False     # subblock transform (inter CUs, one coded half)
    # long-term reference: keep the IDR (poc 0) as an LT entry in L0 of
    # every inter frame (POC LSB + MSB-cycle syntax, vvc_refs.c:415-466)
    ltr: bool = False
    # explicit tile-aligned rect slices: per-slice (tx0, ty0, w_tiles,
    # h_tiles) rectangles following the no-delta raster advance; needs
    # tile_cols/tile_rows
    rect_slices: tuple = ()
    # raster multi-slice: number of slices per picture (each slice a
    # contiguous tile range; needs tiles and a separate PH NAL)
    n_slices: int = 1
    # open GOP: a mid-stream CRA with RASL leading pictures that
    # reference across it (seek-into-CRA drops the RASL output)
    cra: bool = False
    # gradual decoding refresh: a mid-stream GDR picture with
    # ph_recovery_poc_cnt (start-at-GDR suppresses pre-recovery output)
    gdr: bool = False
    # intra toolset wave
    mip: bool = False     # matrix-based intra prediction
    isp: bool = False     # intra sub-partitions (2/4-way 1-D TU split)
    cclm: bool = False    # cross-component linear model chroma
    # sps_chroma_vertical_collocated_flag (CCLM luma downsampler shape)
    cclm_vertical_collocated: bool = True
    mrl: bool = False     # multi-reference-line intra
    # tiles: explicit column widths / row heights in CTUs (empty = one
    # tile).  Entry-point offsets are always signaled when tiled.
    tile_cols: tuple = ()
    tile_rows: tuple = ()
    # WPP (sps_entropy_coding_sync): one CABAC sub-stream per CTU row,
    # contexts inherited from the row above's first CTU
    wpp: bool = False
    # dual-tree intra (sps_qtbtt_dual_tree_intra_flag): I-slice CTUs
    # carry independent luma and chroma coding trees
    dual_tree: bool = False
    # conformance window (left, right, top, bottom) in chroma units:
    # output cropping without changing the coded size (7.4.3.3)
    conf_window: tuple = ()



def config_from_json(kw: dict) -> EncoderConfig:
    """The EncoderConfig of a config's JSON form (the "config" of a
    committed case or fixture), whose tuples came back as lists."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return EncoderConfig(**{k: tup(v) for k, v in kw.items()})

def build_sps_pps(cfg: EncoderConfig) -> tuple[SPS, PPS]:
    min_qt_log2 = cfg.min_qt_size.bit_length() - 1
    tiled = bool(cfg.tile_cols or cfg.tile_rows)
    # SPS candidate ref pic lists covering the generator's ST patterns
    # (P chains + the RA GOP-4 pyramid); slices whose lists match select
    # by index, others fall back to inline structs — both paths of
    # ref_pic_lists() (spec 7.3.9) get exercised
    sps_rpls = ((), ())
    if cfg.rpl_in_sps:
        from ..cbs.h266 import RefPicListStruct as _R
        L0 = [[(1, 1)], [(4, 1)], [(4, 1), (4, 1)], [(2, 1)],
              [(1, 1), (2, 0)], [(1, 1), (2, 1)]]
        L1 = [[(1, 1)], [(2, 0)], [(1, 0), (2, 0)], [(1, 0), (2, 1)]]
        sps_rpls = (tuple(_R(entries=[tuple(e) for e in l]) for l in L0),
                    tuple(_R(entries=[tuple(e) for e in l]) for l in L1))
    # get_cclm_enabled is unconditional for CTBs < 64 (vvc_ctu.c:637);
    # the generator does not model the 64x64 luma-split probe
    assert not (cfg.dual_tree and cfg.cclm and cfg.ctu_log2 >= 6), \
        "generator: dual_tree+cclm requires ctu_log2 < 6"
    # the reference exports raw (unscaled) offsets and its default
    # output path realigns odd left/top crops; right/bottom-even crops
    # sidestep both quirks for bit-exact parity streams
    if cfg.conf_window:
        l, r_, t, b = cfg.conf_window
        assert l == 0 and t == 0 and r_ % 2 == 0 and b % 2 == 0, \
            "generator: conf_window must be (0, even, 0, even)"
    sps = SPS(
        sps_entry_point_offsets_present_flag=1 if (tiled or cfg.wpp) else 0,
        sps_entropy_coding_sync_enabled_flag=1 if cfg.wpp else 0,
        sps_chroma_format_idc=cfg.chroma_format_idc,
        sps_log2_ctu_size_minus5=cfg.ctu_log2 - 5,
        sps_pic_width_max_in_luma_samples=cfg.width,
        sps_pic_height_max_in_luma_samples=cfg.height,
        sps_bitdepth_minus8=cfg.bit_depth - 8,
        sps_max_luma_transform_size_64_flag=1 if cfg.tb64 else 0,
        sps_log2_diff_min_qt_min_cb_intra_slice_luma=min_qt_log2 - 2,
        sps_max_mtt_hierarchy_depth_intra_slice_luma=cfg.max_mtt_depth,
        sps_log2_diff_max_bt_min_qt_intra_slice_luma=(
            cfg.max_bt_size.bit_length() - 1 - min_qt_log2
            if cfg.max_mtt_depth else 0),
        sps_log2_diff_max_tt_min_qt_intra_slice_luma=(
            cfg.max_tt_size.bit_length() - 1 - min_qt_log2
            if cfg.max_mtt_depth else 0),
        sps_conformance_window_flag=1 if cfg.conf_window else 0,
        sps_conf_win=tuple(cfg.conf_window) if cfg.conf_window
        else (0, 0, 0, 0),
        sps_qtbtt_dual_tree_intra_flag=1 if cfg.dual_tree else 0,
        sps_log2_diff_min_qt_min_cb_intra_slice_chroma=(
            min_qt_log2 - 2 if cfg.dual_tree else 0),
        sps_max_mtt_hierarchy_depth_intra_slice_chroma=(
            cfg.max_mtt_depth if cfg.dual_tree else 0),
        sps_log2_diff_max_bt_min_qt_intra_slice_chroma=(
            cfg.max_bt_size.bit_length() - 1 - min_qt_log2
            if cfg.dual_tree and cfg.max_mtt_depth else 0),
        sps_log2_diff_max_tt_min_qt_intra_slice_chroma=(
            cfg.max_tt_size.bit_length() - 1 - min_qt_log2
            if cfg.dual_tree and cfg.max_mtt_depth else 0),
        sps_log2_diff_min_qt_min_cb_inter_slice=min_qt_log2 - 2,
        sps_max_mtt_hierarchy_depth_inter_slice=cfg.max_mtt_depth,
        sps_log2_diff_max_bt_min_qt_inter_slice=(
            cfg.max_bt_size.bit_length() - 1 - min_qt_log2
            if cfg.max_mtt_depth else 0),
        sps_log2_diff_max_tt_min_qt_inter_slice=(
            cfg.max_tt_size.bit_length() - 1 - min_qt_log2
            if cfg.max_mtt_depth else 0),
        sps_sao_enabled_flag=1 if cfg.sao else 0,
        dpb_max_num_reorder_pics=2 if (cfg.ra or cfg.cra) else 0,
        sps_temporal_mvp_enabled_flag=1 if (cfg.tmvp or cfg.sbtmvp) else 0,
        sps_sbtmvp_enabled_flag=1 if cfg.sbtmvp else 0,
        sps_affine_enabled_flag=1 if cfg.affine else 0,
        sps_five_minus_max_num_subblock_merge_cand=0,
        sps_6param_affine_enabled_flag=1 if cfg.affine else 0,
        sps_affine_prof_enabled_flag=1 if (cfg.affine and cfg.prof) else 0,
        sps_bdof_enabled_flag=1 if cfg.bdof else 0,
        sps_sbt_enabled_flag=1 if cfg.sbt else 0,
        sps_long_term_ref_pics_flag=1 if cfg.ltr else 0,
        sps_gdr_enabled_flag=1 if cfg.gdr else 0,
        sps_dmvr_enabled_flag=1 if cfg.dmvr else 0,
        sps_mts_enabled_flag=1 if (cfg.mts or cfg.mts_implicit) else 0,
        sps_joint_cbcr_enabled_flag=1 if cfg.joint_cbcr else 0,
        sps_transform_skip_enabled_flag=(
            1 if (cfg.transform_skip or cfg.bdpcm) else 0),
        sps_log2_transform_skip_max_size_minus2=(
            cfg.ts_max_size.bit_length() - 3
            if (cfg.transform_skip or cfg.bdpcm) else 0),
        sps_bdpcm_enabled_flag=1 if cfg.bdpcm else 0,
        sps_lfnst_enabled_flag=1 if cfg.lfnst else 0,
        sps_explicit_scaling_list_enabled_flag=1 if cfg.scaling_lists else 0,
        sps_scaling_matrix_for_lfnst_disabled_flag=(
            1 if (cfg.scaling_lists and cfg.lfnst) else 0),
        sps_mip_enabled_flag=1 if cfg.mip else 0,
        sps_isp_enabled_flag=1 if cfg.isp else 0,
        sps_mrl_enabled_flag=1 if cfg.mrl else 0,
        sps_cclm_enabled_flag=1 if cfg.cclm else 0,
        sps_chroma_vertical_collocated_flag=(
            1 if cfg.cclm_vertical_collocated else 0),
        sps_explicit_mts_intra_enabled_flag=1 if cfg.mts else 0,
        sps_explicit_mts_inter_enabled_flag=1 if cfg.mts else 0,
        sps_dep_quant_enabled_flag=1 if cfg.dep_quant else 0,
        sps_sign_data_hiding_enabled_flag=1 if cfg.sign_hiding else 0,
        sps_lmcs_enabled_flag=1 if cfg.lmcs else 0,
        sps_alf_enabled_flag=1 if (cfg.alf or cfg.ccalf) else 0,
        sps_ccalf_enabled_flag=1 if cfg.ccalf else 0,
        sps_amvr_enabled_flag=1 if cfg.amvr else 0,
        sps_bcw_enabled_flag=1 if cfg.bcw else 0,
        sps_mmvd_enabled_flag=1 if cfg.mmvd else 0,
        sps_mmvd_fullpel_only_enabled_flag=1 if cfg.mmvd_fullpel else 0,
        sps_ciip_enabled_flag=1 if cfg.ciip else 0,
        sps_gpm_enabled_flag=1 if cfg.gpm else 0,
        sps_weighted_pred_flag=1 if cfg.weighted_pred else 0,
        sps_weighted_bipred_flag=1 if (cfg.weighted_pred and
                                       cfg.b_slices) else 0,
        sps_ref_pic_lists=sps_rpls,
        sps_ref_wraparound_enabled_flag=1 if cfg.wraparound else 0,
    )
    ctb = 1 << cfg.ctu_log2
    pic_w_ctbs = (cfg.width + ctb - 1) >> cfg.ctu_log2
    pic_h_ctbs = (cfg.height + ctb - 1) >> cfg.ctu_log2
    tile_cols = tuple(cfg.tile_cols) or (pic_w_ctbs,)
    tile_rows = tuple(cfg.tile_rows) or (pic_h_ctbs,)
    if tiled:
        assert sum(tile_cols) == pic_w_ctbs and sum(tile_rows) == pic_h_ctbs
        assert len(tile_cols) * len(tile_rows) > 1, \
            "tiled configs need >1 tile (rect_slice inference differs)"
    deblock_ctl = bool(cfg.deblock and (cfg.deblock_override
                                        or cfg.deblock_in_ph))
    pps = PPS(
        pps_no_pic_partition_flag=0 if tiled else 1,
        pps_num_exp_tile_columns_minus1=len(tile_cols) - 1,
        pps_tile_column_width_minus1=tuple(v - 1 for v in tile_cols),
        pps_num_exp_tile_rows_minus1=len(tile_rows) - 1,
        pps_tile_row_height_minus1=tuple(v - 1 for v in tile_rows),
        pps_loop_filter_across_tiles_enabled_flag=1 if tiled else 0,
        pps_loop_filter_across_slices_enabled_flag=1 if tiled else 0,
        # raster (tile-scan) slices: the reference CBS only derives
        # NumEntryPoints correctly for this layout (its rect
        # single-slice-per-subpic path never fills slice_width_in_tiles);
        # the 1x1-tile info-in-PH layout keeps the inferred rect slice
        pps_rect_slice_flag=1 if cfg.rect_slices else (0 if tiled else 1),
        pps_single_slice_per_subpic_flag=0 if (tiled or cfg.rect_slices)
        else 1,
        pps_slice_rects=tuple(cfg.rect_slices),
        pps_pic_width_in_luma_samples=cfg.width,
        pps_pic_height_in_luma_samples=cfg.height,
        pps_init_qp_minus26=cfg.qp - 26,
        # deblocking defaults ON in VVC; disable until the deblock stage
        # exists (configurable once implemented)
        pps_deblocking_filter_control_present_flag=(
            1 if (not cfg.deblock or deblock_ctl) else 0),
        pps_deblocking_filter_disabled_flag=0 if cfg.deblock else 1,
        pps_deblocking_filter_override_enabled_flag=1 if deblock_ctl else 0,
        pps_dbf_info_in_ph_flag=1 if (cfg.deblock and cfg.deblock_in_ph)
        else 0,
        pps_rpl1_idx_present_flag=1 if cfg.rpl_in_sps else 0,
        pps_ref_wraparound_enabled_flag=1 if cfg.wraparound else 0,
        # full-width wraparound (PpsRefWraparoundOffset = pic_w/MinCb)
        pps_pic_width_minus_wraparound_offset=0,
        pps_rpl_info_in_ph_flag=1 if cfg.rpl_in_ph else 0,
        pps_alf_info_in_ph_flag=1 if cfg.alf_in_ph else 0,
        pps_cu_qp_delta_enabled_flag=1 if cfg.cu_qp_delta else 0,
        pps_weighted_pred_flag=1 if cfg.weighted_pred else 0,
        pps_weighted_bipred_flag=1 if (cfg.weighted_pred and
                                       cfg.b_slices) else 0,
    )
    return sps, pps


def _random_coeffs(cfg, rng, cw, ch, luma=True):
    if rng.random() < 0.15:
        return None  # uncoded
    mask = rng.random((ch, cw)) < cfg.coeff_density
    mag = rng.integers(1, cfg.max_level + 1, size=(ch, cw))
    sign = rng.choice([-1, 1], size=(ch, cw))
    c = (mask * mag * sign).astype(np.int32)
    # 64-point zero-out: a 64-sample TB dimension codes only its low 32
    # coefficients (residual_coding log2_zo = min(log2, 5)), so zero
    # every position whose TB-local coordinate is >= 32.  The CU's
    # transform-tree leaves tile it by (min(w, mtb), min(h, mtb)); this
    # conservative per-leaf clamp also covers ISP sub-partitions (their
    # coded regions are subsets of the leaf's).
    if luma and cfg.tb64:
        lw, lh = min(cw, 64), min(ch, 64)
        if lw > 32:
            c[:, np.arange(cw) % lw >= 32] = 0
        if lh > 32:
            c[np.arange(ch) % lh >= 32, :] = 0
    if not np.any(c):
        c[rng.integers(0, min(ch, 32)), rng.integers(0, min(cw, 32))] = 1
    return c


def _random_cu(cfg, rng, x0, y0, w, h, is_inter_slice=False,
               tree="single"):
    cu = CuIntent(
        x0=x0, y0=y0, w=w, h=h, tree=tree,
        luma_mode=int(rng.integers(0, 67)),
        chroma_mode_idx=int(rng.choice([0, 1, 2, 3, 4])),
        coeff_y=(_random_coeffs(cfg, rng, w, h)
                 if tree != "chroma" else None),
        coeff_cb=(_random_coeffs(cfg, rng, w // 2, h // 2, luma=False)
                  if tree != "luma" and cfg.chroma_format_idc else None),
        coeff_cr=(_random_coeffs(cfg, rng, w // 2, h // 2, luma=False)
                  if tree != "luma" and cfg.chroma_format_idc else None),
    )
    if tree == "chroma":
        # chroma-only CU: chroma mode / BDPCM-C / CCLM choices apply,
        # every luma-side tool stays off
        if (cfg.bdpcm and (w // 2) <= cfg.ts_max_size
                and (h // 2) <= cfg.ts_max_size and rng.random() < 0.5):
            cu.bdpcm_c = 1
            cu.bdpcm_dir_c = int(rng.random() < 0.5)
        if cfg.cclm and not cu.bdpcm_c and rng.random() < 0.6:
            cu.cclm_idx = int(rng.integers(0, 3))
        return cu
    if tree == "luma":
        cu.chroma_mode_idx = 4
    if is_inter_slice and rng.random() < cfg.inter_prob:
        cu.pred_mode = "inter"
        if rng.random() < cfg.skip_prob:
            cu.skip = True
            cu.merge = True
            cu.merge_idx = int(rng.integers(0, 6))
            cu.coeff_y = cu.coeff_cb = cu.coeff_cr = None
            if (cfg.sbtmvp or cfg.affine) and w >= 8 and h >= 8 \
                    and rng.random() < 0.5:
                cu.sbtmvp = True
                cu.merge_idx = int(rng.integers(0, 5 if cfg.affine else 1))
            elif cfg.mmvd and rng.random() < 0.5:
                cu.mmvd = (int(rng.integers(0, 2)),
                           int(rng.integers(0, 8)),
                           int(rng.integers(0, 4)))
        elif rng.random() < cfg.merge_prob:
            cu.merge = True
            cu.merge_idx = int(rng.integers(0, 6))
            if (cfg.sbtmvp or cfg.affine) and w >= 8 and h >= 8 \
                    and rng.random() < 0.5:
                cu.sbtmvp = True
                cu.merge_idx = int(rng.integers(0, 5 if cfg.affine else 1))
            elif (cfg.ciip and w * h >= 64 and w <= 64 and h <= 64
                    and rng.random() < 0.5):
                cu.ciip = True  # excludes mmvd (regular_merge_flag 0)
            elif (cfg.gpm and cfg.b_slices and w >= 8 and h >= 8
                  and w < 8 * h and h < 8 * w and rng.random() < 0.5):
                cu.gpm = (int(rng.integers(0, 64)),
                          int(rng.integers(0, 6)),
                          int(rng.integers(0, 5)))
            elif cfg.mmvd and rng.random() < 0.5:
                cu.mmvd = (int(rng.integers(0, 2)),
                           int(rng.integers(0, 8)),
                           int(rng.integers(0, 4)))
        else:
            if cfg.b_slices:
                choices = ["L0", "L1", "BI"] if w + h > 12 else ["L0", "L1"]
                cu.pred_list = str(rng.choice(choices))
            cu.mvp_flag = int(rng.integers(0, 2))
            cu.mvd = (int(rng.integers(-cfg.max_mv, cfg.max_mv + 1)),
                      int(rng.integers(-cfg.max_mv, cfg.max_mv + 1)))
            cu.mvp_flag1 = int(rng.integers(0, 2))
            cu.mvd1 = (int(rng.integers(-cfg.max_mv, cfg.max_mv + 1)),
                       int(rng.integers(-cfg.max_mv, cfg.max_mv + 1)))
            mvds_used = [cu.mvd] if cu.pred_list == "L0" else (
                [cu.mvd1] if cu.pred_list == "L1" else [cu.mvd, cu.mvd1])
            if cfg.amvr and any(any(d) for d in mvds_used) \
                    and rng.random() < 0.6:
                cu.amvr_shift = int(rng.choice([3, 4, 6]))
            if cfg.bcw and cu.pred_list == "BI" and w * h >= 256 \
                    and rng.random() < 0.7:
                cu.bcw_idx = int(rng.integers(0, 3))
            if cfg.affine and w >= 16 and h >= 16 and rng.random() < 0.6:
                model = 2 if rng.random() < 0.5 else 1
                ncp = model + 1
                def _cp_mvds():
                    return [(int(rng.integers(-48, 49)),
                             int(rng.integers(-48, 49)))
                            for _ in range(ncp)]
                cu.affine_params = (model, _cp_mvds(), _cp_mvds())
                cu.amvr_shift = 2  # affine AMVR off in generated SPSes
        if cu.mmvd is not None and cfg.skip_prob and cu.skip:
            pass
        if cu.merge and not cu.skip:
            # merge non-skip parses residual; luma cbf inferred 1 when
            # chroma uncoded -> guarantee coefficients exist (within
            # the first TB leaf's zero-out region for 64-dim CUs)
            if cu.coeff_y is None or not np.any(cu.coeff_y):
                c = np.zeros((h, w), np.int32)
                c[int(rng.integers(0, min(h, 32))),
                  int(rng.integers(0, min(w, 32)))] = \
                    int(rng.integers(1, cfg.max_level + 1))
                cu.coeff_y = c
    if (cfg.sbt and cu.pred_mode == "inter" and not cu.skip and not cu.ciip
            and max(w, h) <= 32 and (w >= 8 or h >= 8)
            # the stream generator's residual coders do not model the
            # 32-point SBT zero-out narrowing; with MTS on, keep the
            # coded TB under 32 (the decoder handles the general case)
            and not ((cfg.mts or cfg.mts_implicit) and max(w, h) > 16)
            and rng.random() < 0.6):
        ver_h, hor_h = w >= 8, h >= 8
        ver_q, hor_q = w >= 16, h >= 16
        quad = int((ver_q or hor_q) and rng.random() < 0.4)
        if quad:
            hor = int(hor_q) if not (ver_q and hor_q) \
                else int(rng.integers(0, 2))
        else:
            hor = int(hor_h) if not (ver_h and hor_h) \
                else int(rng.integers(0, 2))
        pos = int(rng.integers(0, 2))
        cu.sbt = (quad, hor, pos)
        # residual lives only in the coded sub-TU; zero everything else
        # and keep the 32-point implicit-DST7/DCT8 zero-out region
        # (hls_residual_coding, vvc_cabac.c:2369-2377) when MTS is on
        frac = (1 if pos == 0 else 3) if quad else 2
        mts_on = cfg.mts or cfg.mts_implicit

        def restrict(arr, shift):
            if arr is None:
                return None
            hh, ww = arr.shape
            # coded sub-TU span along the split axis (grid units)
            dim = (h if hor else w) >> shift
            split = (h * frac // 4 if hor else w * frac // 4) >> shift
            a0, a1 = (0, split) if pos == 0 else (split, dim)
            out_arr = np.zeros_like(arr)
            if hor:
                out_arr[a0:a1, :] = arr[a0:a1, :]
            else:
                out_arr[:, a0:a1] = arr[:, a0:a1]
            if shift == 0 and mts_on:
                # zero beyond 16 in any 32-long coded-TB dimension
                tbw, tbh = (ww, a1 - a0) if hor else (a1 - a0, hh)
                x0c, y0c = (0, a0) if hor else (a0, 0)
                if tbw == 32:
                    out_arr[:, x0c + 16:x0c + 32] = 0
                if tbh == 32:
                    out_arr[y0c + 16:y0c + 32, :] = 0
            return out_arr

        cu.coeff_y = restrict(cu.coeff_y, 0)
        cu.coeff_cb = restrict(cu.coeff_cb, 1)
        cu.coeff_cr = restrict(cu.coeff_cr, 1)
        # the coded TU's luma cbf is inferred 1 when its chroma is
        # uncoded -> guarantee a nonzero luma coefficient there
        if cu.coeff_y is None or not np.any(cu.coeff_y):
            c = cu.coeff_y if cu.coeff_y is not None \
                else np.zeros((h, w), np.int32)
            if hor:
                ys = (0, h * frac // 4) if pos == 0 \
                    else (h * frac // 4, h)
                xs = (0, w)
            else:
                xs = (0, w * frac // 4) if pos == 0 \
                    else (w * frac // 4, w)
                ys = (0, h)
            yy = int(rng.integers(ys[0], min(ys[1], ys[0] + 16)))
            xx = int(rng.integers(xs[0], min(xs[1], xs[0] + 16)))
            c[yy, xx] = int(rng.integers(1, cfg.max_level + 1))
            cu.coeff_y = c
    if (cfg.bdpcm and cu.pred_mode == "intra"
            and max(w, h) <= cfg.ts_max_size and rng.random() < 0.5):
        cu.bdpcm_l = 1
        cu.luma_mode = 50 if rng.random() < 0.5 else 18
        if (tree != "luma" and (w // 2) <= cfg.ts_max_size
                and (h // 2) <= cfg.ts_max_size and rng.random() < 0.7):
            cu.bdpcm_c = 1
            cu.bdpcm_dir_c = int(rng.random() < 0.5)
    if (cfg.cclm and tree != "luma" and cu.pred_mode == "intra"
            and not cu.bdpcm_c and rng.random() < 0.6):
        cu.cclm_idx = int(rng.integers(0, 3))  # 0 LT / 1 L / 2 T
    if (cfg.mrl and cu.pred_mode == "intra" and not cu.bdpcm_l
            and (y0 % (1 << cfg.ctu_log2)) and rng.random() < 0.5):
        cu.mrl_idx = int(rng.integers(1, 3))      # line 1 or 2
        cu.mrl_mpm_idx = int(rng.integers(0, 5))  # pick from the MPM list
    # MIP is capped at the max transform size: for larger CUs the
    # reference predicts each split TB with tab.imm/imtf values it only
    # wrote at the CU's first min-CB column (vvc_ctu.c:976-977) and
    # never zeroes per frame (vvcdec.c:101 tl_init zero=0) — stale
    # out-of-spec modes.  Our decoder follows the spec (the CU's MIP
    # mode applies to every TB), so the generator avoids the quirk.
    if (cfg.mip and cu.pred_mode == "intra" and not cu.bdpcm_l
            and cu.mrl_idx == 0
            and max(w, h) <= 32 and rng.random() < 0.5):
        c_max = 15 if (w == 4 and h == 4) else \
            7 if ((w == 4 or h == 4) or (w == 8 and h == 8)) else 5
        cu.mip_mode = int(rng.integers(0, c_max + 1))
        cu.mip_transposed = int(rng.integers(0, 2))
        cu.luma_mode = cu.mip_mode  # tab.ipm parity (vvc_ctu.c:980)
    if (cfg.isp and cu.pred_mode == "intra" and tree != "chroma"
            and not cu.bdpcm_l and cu.mrl_idx == 0 and cu.mip_mode < 0
            and max(w, h) <= 32 and w * h > 16 and rng.random() < 0.6):
        cu.isp = 2 if rng.random() < 0.5 else 1  # 1 HOR / 2 VER
        cu.isp_parts = 2 if (w, h) in ((4, 8), (8, 4)) else 4
        # the last sub-partition's luma cbf is inferred 1 when all the
        # previous ones are 0: make sure it carries a coefficient then
        if cu.coeff_y is None:
            cu.coeff_y = np.zeros((h, w), np.int32)
        n = cu.isp_parts
        if cu.isp == 1:
            pre, last = cu.coeff_y[:h - h // n], cu.coeff_y[h - h // n:]
        else:
            pre, last = (cu.coeff_y[:, :w - w // n],
                         cu.coeff_y[:, w - w // n:])
        if not np.any(pre) and not np.any(last):
            last[int(rng.integers(0, last.shape[0])),
                 int(rng.integers(0, last.shape[1]))] = \
                int(rng.integers(1, cfg.max_level + 1))
    if (cfg.mts and max(w, h) <= 32 and not cu.bdpcm_l
            and cu.sbt is None and cu.isp == 0 and rng.random() < 0.5):
        _try_mts(cu, rng)
    if (cfg.lfnst and cu.pred_mode == "intra" and not cu.bdpcm_l
            and cu.mts_idx == 0 and min(w, h) >= 4 and max(w, h) <= 32
            and not (cu.mip_mode >= 0 and min(w, h) < 16)
            and rng.random() < 0.5):
        if cu.isp:
            _try_lfnst_isp(cu, rng)
        else:
            _try_lfnst(cu, rng)
    return cu


def _try_lfnst_isp(cu, rng):
    """LFNST under ISP: the size gate uses the sub-partition dims and
    the dc-only tracker is bypassed (vvc_ctu.c:818-831); each sub-TB's
    coefficients must stay in the LFNST-legal region."""
    n = cu.isp_parts
    sw = cu.w // n if cu.isp == 2 else cu.w
    sh = cu.h // n if cu.isp == 1 else cu.h
    if min(sw, sh) < 4 or cu.coeff_y is None or not np.any(cu.coeff_y):
        return
    c = cu.coeff_y.copy()
    for i in range(n):
        if cu.isp == 1:
            c[sh * i:sh * (i + 1)] = _lfnst_restrict(
                c[sh * i:sh * (i + 1)], sw, sh)
        else:
            c[:, sw * i:sw * (i + 1)] = _lfnst_restrict(
                c[:, sw * i:sw * (i + 1)], sw, sh)
    if not np.any(c):
        return  # restriction emptied the CU; keep lfnst off
    cu.coeff_y = c
    # the chroma TBs feed the same zero-out tracker
    cu.coeff_cb = _lfnst_restrict(cu.coeff_cb, cu.w // 2, cu.h // 2)
    cu.coeff_cr = _lfnst_restrict(cu.coeff_cr, cu.w // 2, cu.h // 2)
    cu.lfnst_idx = int(rng.integers(1, 3))


def _lfnst_restrict(c, w, h):
    """Zero everything outside the LFNST-legal coefficient region: the
    first 4x4 subblock, and only its first 8 scan positions for square
    4x4/8x8 TBs (the lfnst_zero_out tracker conditions)."""
    if c is None or w < 4 or h < 4:
        return c
    from .scan import diag_scan
    keep = np.zeros((h, w), bool)
    n = 8 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 16
    for x, y in diag_scan(4, 4)[:n]:
        keep[y, x] = True
    return np.where(keep, c, 0).astype(np.int32)


def _try_lfnst(cu, rng):
    """Pick lfnst_idx if the CU's coefficients can be made eligible:
    all >=4x4 TBs confined to the LFNST region and some non-DC
    coefficient present (lfnst_dc_only must clear)."""
    cy = _lfnst_restrict(cu.coeff_y, cu.w, cu.h)
    ccb = _lfnst_restrict(cu.coeff_cb, cu.w // 2, cu.h // 2)
    ccr = _lfnst_restrict(cu.coeff_cr, cu.w // 2, cu.h // 2)

    def non_dc(c):
        if c is None or not np.any(c):
            return False
        nz = np.argwhere(c != 0)
        return len(nz) > 1 or tuple(nz[0]) != (0, 0)

    clears = (non_dc(cy)
              or (ccb is not None and min(cu.w // 2, cu.h // 2) >= 4
                  and non_dc(ccb))
              or (ccr is not None and min(cu.w // 2, cu.h // 2) >= 4
                  and non_dc(ccr)))
    if not clears:
        return
    cu.coeff_y, cu.coeff_cb, cu.coeff_cr = cy, ccb, ccr
    cu.lfnst_idx = int(rng.integers(1, 3))


def _try_mts(cu, rng):
    """Pick a nonzero mts_idx if the CU's luma coefficients can be made
    MTS-eligible: all sig coeffs inside 16x16 and not DC-only."""
    c = cu.coeff_y
    if c is None:
        return
    c = c.copy()
    c[16:, :] = 0
    c[:, 16:] = 0
    nz = np.transpose(np.nonzero(c))
    dc_only = len(nz) == 0 or (len(nz) == 1 and tuple(nz[0]) == (0, 0))
    if dc_only or not np.any(c):
        return
    cu.coeff_y = c
    cu.mts_idx = int(rng.integers(1, 5))


def _random_tree(cfg, pc, rng, x0, y0, w, h, cqt_depth, mtt_depth,
                 depth_offset, part_idx, last_split, is_inter_slice=False,
                 tree="single"):
    """Random legal coding tree node.  Single-tree nodes stay
    mode-type-safe; dual-tree I-slice nodes have no modeTypeCondition
    (vvc_ctu.c:1833-1835) so every legal split is available."""
    from .tree import (SPLIT_NONE, SPLIT_QT, can_split,
                       mode_type_condition_free, split_children)

    chroma = tree == "chroma"
    allowed = can_split(pc, x0, y0, w, h, mtt_depth, depth_offset, part_idx,
                        last_split, chroma=chroma)
    is_inside = (x0 + w <= cfg.width) and (y0 + h <= cfg.height)
    names = {"qt": SPLIT_QT, "btv": 4, "bth": 2, "ttv": 3, "tth": 1}
    choices = [s for k, s in names.items()
               if allowed[k] and (tree != "single"
                                  or mode_type_condition_free(w, h, s))]
    if not is_inside:
        # forced split: must pick an allowed split (qt preferred like real
        # encoders); safety filter can't apply (splitting is mandatory)
        forced = [s for k, s in names.items() if allowed[k]]
        assert forced, (x0, y0, w, h)
        split = SPLIT_QT if allowed["qt"] else forced[0]
    elif choices and rng.random() < cfg.split_prob:
        split = int(rng.choice(choices))
    else:
        split = SPLIT_NONE

    if split == SPLIT_NONE:
        return {"split": SPLIT_NONE,
                "cu": _random_cu(cfg, rng, x0, y0, w, h, is_inter_slice,
                                 tree=tree)}
    kids = []
    for (cx, cy, cw, ch, dq, dm, doff, idx) in split_children(
            x0, y0, w, h, split, cfg.width, cfg.height):
        kids.append(_random_tree(cfg, pc, rng, cx, cy, cw, ch,
                                 cqt_depth + dq, mtt_depth + dm,
                                 depth_offset + doff, idx, split,
                                 is_inter_slice, tree))
    return {"split": split, "children": kids}


def random_frame_intent(cfg: EncoderConfig, sps: SPS, pps: PPS,
                        rng: np.random.Generator,
                        is_inter_slice: bool = False) -> list[dict]:
    """One coding-tree intent per CTU."""
    from .tree import PartitionCtx

    min_cb = 1 << (sps.sps_log2_min_luma_coding_block_size_minus2 + 2)
    pc = PartitionCtx(min_cb_size=min_cb, min_qt_size=cfg.min_qt_size,
                      max_bt_size=cfg.max_bt_size, max_tt_size=cfg.max_tt_size,
                      max_mtt_depth=cfg.max_mtt_depth,
                      pic_width=cfg.width, pic_height=cfg.height)
    ctu = 1 << cfg.ctu_log2
    dual = cfg.dual_tree and not is_inter_slice
    trees = []
    for y0 in range(0, cfg.height, ctu):
        for x0 in range(0, cfg.width, ctu):
            if dual:
                trees.append({
                    "dualtree": True,
                    "luma": _random_tree(cfg, pc, rng, x0, y0, ctu, ctu,
                                         0, 0, 0, 0, 0, tree="luma"),
                    "chroma": _random_tree(cfg, pc, rng, x0, y0, ctu, ctu,
                                           0, 0, 0, 0, 0, tree="chroma"),
                })
            else:
                trees.append(_random_tree(cfg, pc, rng, x0, y0, ctu, ctu,
                                          0, 0, 0, 0, 0, is_inter_slice))
    return trees


def _random_sao(cfg, rng, can_left: bool, can_up: bool) -> dict:
    from .ctu import _sao_off

    sao = _sao_off()
    r = rng.random()
    if r < 0.15 and can_left:
        sao["merge"] = "left"
        return sao
    if r < 0.3 and can_up:
        sao["merge"] = "up"
        return sao
    max_off = (1 << (min(cfg.bit_depth, 10) - 5)) - 1
    for c in range(3):
        t = int(rng.choice([0, 1, 2]))
        sao["type"][c] = t
        if t:
            sao["offset_abs"][c] = [int(v) for v in
                                    rng.integers(0, max_off + 1, 4)]
            if t == 1:
                sao["offset_sign"][c] = [int(v) for v in rng.integers(0, 2, 4)]
                sao["band_position"][c] = int(rng.integers(0, 32))
            else:
                sao["eo_class"][c] = int(rng.integers(0, 4))
    # c2 shares type/eo with c1
    sao["type"][2] = sao["type"][1]
    sao["eo_class"][2] = sao["eo_class"][1]
    if sao["type"][2] == 0:
        sao["offset_abs"][2] = [0] * 4
        sao["offset_sign"][2] = [0] * 4
        sao["band_position"][2] = 0
    return sao


def tree_leaves(node: dict) -> list[CuIntent]:
    if "cu" in node:
        return [node["cu"]]
    if "dualtree" in node:
        return tree_leaves(node["luma"]) + tree_leaves(node["chroma"])
    out = []
    for c in node["children"]:
        out.extend(tree_leaves(c))
    return out


def _random_scaling_aps(cfg, rng):
    """Random scaling-list APS exercising all three per-id modes:
    copy (with/without pred_id_delta), prediction + deltas, and
    explicit-from-8 (scaling_derive, vvc_ps.c:903-960)."""
    from ..cbs.h266 import APS, APS_TYPE_SCALING

    copy_f, pred_f, pred_d = [], [], []
    dc = []
    deltas = []
    for sid in range(28):
        max_d = sid if sid < 2 else (sid - 2 if sid < 8 else sid - 8)
        r = rng.random()
        if r < 0.3:
            c, p = 1, 0
        elif r < 0.6:
            c, p = 0, 1
        else:
            c, p = 0, 0
        d = 0
        if (c or p) and sid not in (0, 2, 8) and max_d > 0:
            d = int(rng.integers(0, max_d + 1))
        copy_f.append(c)
        pred_f.append(p)
        pred_d.append(d)
        if sid > 13:
            dc.append(0 if c else int(rng.integers(-8, 9)))
        deltas.append(tuple(int(v) for v in rng.integers(-6, 7, size=64)))
    while len(dc) < 14:
        dc.append(0)
    return APS(
        aps_params_type=APS_TYPE_SCALING,
        aps_adaptation_parameter_set_id=int(rng.integers(0, 8)),
        aps_chroma_present_flag=1,
        sl_copy_mode_flag=tuple(copy_f),
        sl_pred_mode_flag=tuple(pred_f),
        sl_pred_id_delta=tuple(pred_d),
        sl_dc_coef=tuple(dc),
        sl_delta_coef=tuple(deltas),
    )


def _random_lmcs_aps(cfg, rng):
    """Random conforming LMCS model (7.3.2.18 / 7.4.3.18 constraints).

    lmcs_delta_max_bin_idx is kept equal to lmcs_min_bin_idx because
    the reference derives its max_bin from min_bin (vvc_ps.c:620);
    min_bin >= 1 avoids the reference's out-of-bounds inverse-LUT scan
    for max_bin 15 (vvc_ps.c:656-660).
    """
    from ..cbs.h266 import APS, APS_TYPE_LMCS

    bd = cfg.bit_depth
    org = (1 << bd) // 16
    lo, hi = org >> 3, (org << 3) - 1
    min_bin = int(rng.integers(1, 4))
    nbins = (15 - min_bin) - min_bin + 1
    span = min(12, org - lo, hi - org)
    while True:
        deltas = rng.integers(-span, span // 2 + 1, nbins)
        cw = org + deltas
        if (cw >= lo).all() and (cw <= hi).all() and                 cw.sum() <= (1 << bd) - 1:
            break
    while True:
        crs = int(rng.integers(-7, 8))
        if cw.min() + crs >= lo and cw.max() + crs <= hi:
            break
    return APS(
        aps_params_type=APS_TYPE_LMCS,
        aps_adaptation_parameter_set_id=int(rng.integers(0, 4)),
        aps_chroma_present_flag=1 if cfg.chroma_format_idc else 0,
        lmcs_min_bin_idx=min_bin,
        lmcs_delta_max_bin_idx=min_bin,
        lmcs_delta_cw_prec_minus1=3,  # 4-bit abs values (<= span 12)
        lmcs_delta_abs_cw=tuple(int(abs(d)) for d in deltas),
        lmcs_delta_sign_cw_flag=tuple(1 if d < 0 else 0 for d in deltas),
        lmcs_delta_abs_crs=abs(crs),
        lmcs_delta_sign_crs_flag=1 if crs < 0 else 0,
    )


def _random_alf_aps(cfg, rng, aps_id):
    """Random conforming ALF APS: luma (25-class delta-indexed filter
    set), chroma alternatives, and CC-ALF filters (7.3.2.19; coeff
    ranges per 7.4.3.19)."""
    from ..cbs.h266 import APS, APS_TYPE_ALF

    nf = int(rng.integers(1, 6))
    coeffs = rng.integers(0, 17, (nf, 12))
    signs = rng.integers(0, 2, (nf, 12))
    clip_flag = int(rng.integers(0, 2))
    clips = rng.integers(0, 4, (nf, 12)) if clip_flag else         np.zeros((nf, 12), np.int64)
    nalt = int(rng.integers(1, 4))
    cabs = rng.integers(0, 17, (nalt, 6))
    csgn = rng.integers(0, 2, (nalt, 6))
    cclip_flag = int(rng.integers(0, 2))
    cclips = rng.integers(0, 4, (nalt, 6)) if cclip_flag else         np.zeros((nalt, 6), np.int64)
    ncc = [int(rng.integers(1, 5)), int(rng.integers(1, 5))]
    ccabs = [rng.integers(0, 8, (ncc[i], 7)) for i in range(2)]
    ccsgn = [rng.integers(0, 2, (ncc[i], 7)) for i in range(2)]
    return APS(
        aps_params_type=APS_TYPE_ALF,
        aps_adaptation_parameter_set_id=aps_id,
        aps_chroma_present_flag=1 if cfg.chroma_format_idc else 0,
        alf_luma_filter_signal_flag=1,
        alf_chroma_filter_signal_flag=1 if cfg.chroma_format_idc else 0,
        alf_cc_cb_filter_signal_flag=1 if cfg.ccalf else 0,
        alf_cc_cr_filter_signal_flag=1 if cfg.ccalf else 0,
        alf_luma_clip_flag=clip_flag,
        alf_luma_num_filters_signalled_minus1=nf - 1,
        alf_luma_coeff_delta_idx=tuple(
            int(v) for v in rng.integers(0, nf, 25)),
        alf_luma_coeff_abs=tuple(tuple(int(v) for v in row)
                                 for row in coeffs),
        alf_luma_coeff_sign=tuple(tuple(int(v) for v in row)
                                  for row in signs),
        alf_luma_clip_idx=tuple(tuple(int(v) for v in row)
                                for row in clips),
        alf_chroma_clip_flag=cclip_flag,
        alf_chroma_num_alt_filters_minus1=nalt - 1,
        alf_chroma_coeff_abs=tuple(tuple(int(v) for v in row)
                                   for row in cabs),
        alf_chroma_coeff_sign=tuple(tuple(int(v) for v in row)
                                    for row in csgn),
        alf_chroma_clip_idx=tuple(tuple(int(v) for v in row)
                                  for row in cclips),
        alf_cc_cb_filters_signalled_minus1=ncc[0] - 1,
        alf_cc_cb_mapped_coeff_abs=tuple(tuple(int(v) for v in row)
                                         for row in ccabs[0]),
        alf_cc_cb_coeff_sign=tuple(tuple(int(v) for v in row)
                                   for row in ccsgn[0]),
        alf_cc_cr_filters_signalled_minus1=ncc[1] - 1,
        alf_cc_cr_mapped_coeff_abs=tuple(tuple(int(v) for v in row)
                                         for row in ccabs[1]),
        alf_cc_cr_coeff_sign=tuple(tuple(int(v) for v in row)
                                   for row in ccsgn[1]),
    )


def _random_pwt(cfg, rng):
    denom = int(rng.integers(0, 4))
    cd = int(rng.integers(-denom, 8 - denom))

    def side():
        lwf, cwf, dlw, lo, dcw, dco = [], [], [], [], [], []
        for _ in range(16):
            lf = int(rng.random() < 0.6)
            cf = int(rng.random() < 0.6)
            lwf.append(lf)
            cwf.append(cf)
            dlw.append(int(rng.integers(-8, 9)) if lf else 0)
            lo.append(int(rng.integers(-32, 33)) if lf else 0)
            dcw.append((int(rng.integers(-8, 9)),
                        int(rng.integers(-8, 9))) if cf else (0, 0))
            dco.append((int(rng.integers(-64, 65)),
                        int(rng.integers(-64, 65))) if cf else (0, 0))
        return lwf, cwf, dlw, lo, dcw, dco

    s0, s1 = side(), side()
    return {"luma_log2_weight_denom": denom,
            "delta_chroma_log2_weight_denom": cd,
            "luma_weight_flags": (s0[0], s1[0]),
            "chroma_weight_flags": (s0[1], s1[1]),
            "delta_luma_weights": (s0[2], s1[2]),
            "luma_offsets": (s0[3], s1[3]),
            "delta_chroma_weights": (s0[4], s1[4]),
            "delta_chroma_offsets": (s0[5], s1[5])}


def encode_stream(cfg: EncoderConfig):
    """Returns (annexb_bytes, intent_dict)."""
    assert not (cfg.weighted_pred and cfg.bcw), \
        "generator keeps wp and bcw streams disjoint"
    if (cfg.rpl_in_ph or cfg.alf_in_ph or cfg.deblock_in_ph) and \
            not (cfg.tile_cols or cfg.tile_rows):
        # info-in-PH syntax requires pps_no_pic_partition_flag == 0:
        # use the proven 2-tile raster-slice layout (the reference's
        # rect single-slice-per-subpic path corrupts its slice maps)
        ctb = 1 << cfg.ctu_log2
        ctb_w = (cfg.width + ctb - 1) >> cfg.ctu_log2
        ctb_h = (cfg.height + ctb - 1) >> cfg.ctu_log2
        if ctb_w > 1:
            cfg.tile_cols, cfg.tile_rows = (1, ctb_w - 1), (ctb_h,)
        else:
            assert ctb_h > 1, "info-in-PH streams need >= 2 CTUs"
            cfg.tile_cols, cfg.tile_rows = (ctb_w,), (1, ctb_h - 1)
    rng = np.random.default_rng(cfg.seed)
    sps, pps = build_sps_pps(cfg)
    out = bytearray()
    out += sps.to_nal()
    out += pps.to_nal(sps)
    alf_apss = []
    if cfg.alf or cfg.ccalf:
        n_aps = int(rng.integers(1, 4))
        for k in range(n_aps):
            alf_apss.append(_random_alf_aps(cfg, rng, k))
            out += alf_apss[-1].to_nal()
    sl_aps = None
    if cfg.scaling_lists:
        sl_aps = _random_scaling_aps(cfg, rng)
        out += sl_aps.to_nal()
    lmcs_aps = None
    lmcs_crs_flag = 0
    if cfg.lmcs:
        lmcs_aps = _random_lmcs_aps(cfg, rng)
        out += lmcs_aps.to_nal()
        # fixed per stream: the flag selects a different compiled
        # program variant, so per-frame flips would churn compiles
        lmcs_crs_flag = int(rng.integers(0, 2)) if cfg.chroma_format_idc \
            else 0

    intent = {
        "config": {k: getattr(cfg, k) for k in (
            "width", "height", "ctu_log2", "qp", "n_frames",
            "chroma_format_idc", "bit_depth", "seed")},
        "frames": [],
    }

    col_store: dict = {}  # poc -> collocated motion snapshot (TMVP)

    def rpl_from_pocs(cur, refs):
        entries = []
        prev = cur
        for r in refs:
            if isinstance(r, tuple) and r[0] == "lt":
                # LT entry: POC LSB + MSB cycle resolving to r[1]
                ltpoc = r[1]
                lsb = ltpoc & 255
                delta = ((cur - (cur & 255)) - (ltpoc - lsb)) // 256
                entries.append(("lt", lsb, delta))
                continue
            d = r - prev
            entries.append((abs(d), 1 if d < 0 else 0))
            prev = r
        return RefPicListStruct(entries=entries)

    def poc_of(r):
        return r[1] if isinstance(r, tuple) else r

    if cfg.cra:
        # open GOP in decode order: trailing P/B frames, a CRA, then
        # RASL leading pictures referencing across the CRA
        assert cfg.inter and cfg.b_slices and not cfg.ra
        n = cfg.n_frames_total()
        assert n >= 6, "cra streams need >= 6 frames"
        k = n // 2  # CRA at poc k+1, RASL at poc k
        from ..bitstream.bits import NAL_CRA, NAL_RASL
        frame_plan = [(0, None, None, None)]
        frame_plan += [(p, [p - 1], [p - 1], None) for p in range(1, k)]
        frame_plan += [(k + 1, None, None, NAL_CRA),
                       (k, [k - 1], [k + 1], NAL_RASL)]
        frame_plan += [(p, [p - 1], [p - 1], None)
                       for p in range(k + 2, n + 1)]
    elif cfg.gdr:
        # a mid-stream GDR picture (intra slice here; the reference
        # does not verify refresh areas) with a 2-frame recovery period
        assert cfg.inter
        from ..bitstream.bits import NAL_GDR
        n = cfg.n_frames_total()
        assert n >= 5, "gdr streams need >= 5 frames"
        k = n // 2
        frame_plan = [(0, None, None, None)]
        frame_plan += [(p, [p - 1], [p - 1] if cfg.b_slices else None,
                        None) for p in range(1, k)]
        frame_plan += [(k, None, None, NAL_GDR)]
        frame_plan += [(p, [p - 1], [p - 1] if cfg.b_slices else None,
                        None) for p in range(k + 1, n)]
    elif cfg.ra:
        # GOP-4 pyramid in decode order (poc, l0_refs, l1_refs)
        assert cfg.inter and cfg.b_slices, "ra implies inter B slices"
        schedule = [(0, None, None)]
        g = 0
        while g + 4 < cfg.n_frames_total():
            schedule += [
                (g + 4, [g] + ([g - 4] if g >= 4 else []), [g]),
                (g + 2, [g], [g + 4]),
                (g + 1, [g, g + 2], [g + 2, g + 4]),
                (g + 3, [g + 2, g], [g + 4, g + 2]),
            ]
            g += 4
        frame_plan = schedule
    else:
        frame_plan = [(poc, None, None) for poc in range(cfg.n_frames)]
    if cfg.ltr:
        # keep the IDR (poc 0) alive as a long-term reference appended
        # to L0 of every inter frame
        frame_plan = [
            (poc,
             ([*(l0 or [poc - 1]), ("lt", 0)] if poc > 0 else l0),
             ((l1 or ([poc - 1] if cfg.b_slices else None))
              if poc > 0 else l1))
            for poc, l0, l1 in frame_plan]

    from ..bitstream.bits import NAL_CRA, NAL_GDR
    for entry in frame_plan:
        poc, l0_refs, l1_refs = entry[:3]
        nal_override = entry[3] if len(entry) > 3 else None
        # CRA/GDR pictures are generated as intra frames here
        is_p = cfg.inter and poc > 0 and nal_override not in (NAL_CRA,
                                                              NAL_GDR)
        nal_type = nal_override if nal_override is not None else (
            NAL_TRAIL if is_p else NAL_IDR_N_LP)
        sh = SliceHeader(nal_unit_type=nal_type)
        sh.ph.ph_pic_order_cnt_lsb = poc & 0xFFFF
        if nal_override == NAL_GDR:
            sh.ph.ph_gdr_pic_flag = 1
            sh.ph.ph_recovery_poc_cnt = 2
        if cfg.dep_quant:
            sh.sh_dep_quant_used_flag = 1
        elif cfg.sign_hiding:
            sh.sh_sign_data_hiding_used_flag = 1
        if is_p:
            sh.sh_slice_type = 0 if cfg.b_slices else 1
            sh.ph.ph_gdr_or_irap_pic_flag = 0
            sh.ph.ph_inter_slice_allowed_flag = 1
            sh.ph.ph_intra_slice_allowed_flag = 1
            if l0_refs is not None:
                sh.sh_ref_pic_lists = (rpl_from_pocs(poc, l0_refs),
                                       rpl_from_pocs(poc, l1_refs or []))
                if max(len(l0_refs), len(l1_refs or [])) > 1:
                    sh.sh_num_ref_idx_active_override_flag = 1
                    sh.sh_num_ref_idx_active_minus1 = (
                        len(l0_refs) - 1, max(len(l1_refs or []) - 1, 0))
            else:
                # short-term ref(s): the previous frame (delta_poc -1)
                l1 = (RefPicListStruct(entries=[(1, 1)]) if cfg.b_slices
                      else RefPicListStruct())
                sh.sh_ref_pic_lists = (RefPicListStruct(entries=[(1, 1)]),
                                       l1)
            if cfg.b_slices:
                sh.ph.ph_mvd_l1_zero_flag = 0
            if cfg.tmvp or cfg.sbtmvp:
                sh.ph.ph_temporal_mvp_enabled_flag = 1
            if cfg.rpl_in_sps:
                # select matching SPS candidate structs by index;
                # non-matching lists (LT entries, odd patterns) fall
                # back to inline coding — both 7.3.9 paths exercised
                idxs = []
                for i in range(2):
                    ent = list(sh.sh_ref_pic_lists[i].entries)
                    hit = [k for k, st in
                           enumerate(sps.sps_ref_pic_lists[i])
                           if list(st.entries) == ent]
                    idxs.append(hit[0] if hit else None)
                sh.sh_rpl_sps_idx = tuple(idxs)
        if cfg.sao:
            sh.sh_sao_luma_used_flag = 1
            sh.sh_sao_chroma_used_flag = 1
        if cfg.cu_qp_delta:
            sh.ph.ph_cu_qp_delta_subdiv_intra_slice = cfg.cu_qp_delta_subdiv
            sh.ph.ph_cu_qp_delta_subdiv_inter_slice = cfg.cu_qp_delta_subdiv
        if cfg.joint_cbcr:
            sh.ph.ph_joint_cbcr_sign_flag = int(rng.integers(0, 2))
        if cfg.alf or cfg.ccalf:
            sh.sh_alf_enabled_flag = 1
            n_ids = int(rng.integers(1, len(alf_apss) + 1))
            sh.sh_num_alf_aps_ids_luma = n_ids
            ids = list(rng.choice(len(alf_apss), size=n_ids,
                                  replace=False))
            sh.sh_alf_aps_id_luma = tuple(
                int(v) for v in ids) + (0,) * (8 - n_ids)
            sh.sh_alf_cb_enabled_flag = int(rng.integers(0, 2)) \
                if cfg.alf else 0
            sh.sh_alf_cr_enabled_flag = int(rng.integers(0, 2)) \
                if cfg.alf else 0
            if sh.sh_alf_cb_enabled_flag or sh.sh_alf_cr_enabled_flag:
                sh.sh_alf_aps_id_chroma = int(
                    rng.integers(0, len(alf_apss)))
            if cfg.ccalf:
                sh.sh_alf_cc_cb_enabled_flag = int(rng.integers(0, 2))
                sh.sh_alf_cc_cb_aps_id = int(rng.integers(0, len(alf_apss)))
                sh.sh_alf_cc_cr_enabled_flag = int(rng.integers(0, 2))
                sh.sh_alf_cc_cr_aps_id = int(rng.integers(0, len(alf_apss)))
        if cfg.lmcs:
            sh.ph.ph_lmcs_enabled_flag = 1
            sh.ph.ph_lmcs_aps_id = lmcs_aps.aps_adaptation_parameter_set_id
            sh.ph.ph_chroma_residual_scale_flag = lmcs_crs_flag
        if cfg.scaling_lists:
            sh.ph.ph_explicit_scaling_list_enabled_flag = 1
            sh.ph.ph_scaling_list_aps_id = \
                sl_aps.aps_adaptation_parameter_set_id
        if cfg.rpl_in_ph:
            # ref_pic_lists() moves to the PH (written for every
            # picture, IDRs carry empty lists); collocated selection
            # rides along when TMVP is on.  ph_collocated_from_l0 is
            # kept 0: the reference's CBS never applies the 7.4.8
            # inference (sh_collocated_* inherit from the PH) and
            # leaves the raw SH fields zero, so 0 is the only value
            # both a spec decoder and the reference agree on.
            sh.ph.ph_ref_pic_lists = sh.sh_ref_pic_lists if is_p else (
                RefPicListStruct(), RefPicListStruct())
            if cfg.rpl_in_sps:
                sh.ph.ph_rpl_sps_idx = sh.sh_rpl_sps_idx
            has_l1 = is_p and sh.sh_ref_pic_lists[1].num_ref_entries > 0
            sh.ph.ph_collocated_from_l0_flag = 0 if has_l1 else 1
            sh.ph.ph_collocated_ref_idx = 0
        if cfg.alf_in_ph and (cfg.alf or cfg.ccalf):
            sh.ph.ph_alf_enabled_flag = sh.sh_alf_enabled_flag
            sh.ph.ph_alf_aps_id_luma = tuple(
                sh.sh_alf_aps_id_luma[:sh.sh_num_alf_aps_ids_luma])
            sh.ph.ph_alf_cb_enabled_flag = sh.sh_alf_cb_enabled_flag
            sh.ph.ph_alf_cr_enabled_flag = sh.sh_alf_cr_enabled_flag
            sh.ph.ph_alf_aps_id_chroma = sh.sh_alf_aps_id_chroma
            sh.ph.ph_alf_cc_cb_enabled_flag = sh.sh_alf_cc_cb_enabled_flag
            sh.ph.ph_alf_cc_cb_aps_id = sh.sh_alf_cc_cb_aps_id
            sh.ph.ph_alf_cc_cr_enabled_flag = sh.sh_alf_cc_cr_enabled_flag
            sh.ph.ph_alf_cc_cr_aps_id = sh.sh_alf_cc_cr_aps_id
        if cfg.deblock and cfg.deblock_in_ph:
            # PH-level offset override, fixed per stream (the decode
            # program treats deblock offsets as frame constants)
            sh.ph.ph_deblocking_params_present_flag = 1
            sh.ph.ph_luma_beta_offset_div2 = int(cfg.seed % 5) - 2
            sh.ph.ph_luma_tc_offset_div2 = int(cfg.seed % 7) - 3
        elif cfg.deblock and cfg.deblock_override:
            sh.sh_deblocking_params_present_flag = 1
            sh.sh_deblocking_filter_disabled_flag = 0
            sh.sh_luma_beta_offset_div2 = int(cfg.seed % 5) - 2
            sh.sh_luma_tc_offset_div2 = int(cfg.seed % 7) - 3
        trees = random_frame_intent(cfg, sps, pps, rng, is_inter_slice=is_p)
        if cfg.sao:
            # merge-left/up candidates never cross a tile boundary
            # (decode_sao gates on tile-aware ctb_left_/ctb_up_)
            ctb_w = (cfg.width + (1 << cfg.ctu_log2) - 1) >> cfg.ctu_log2
            col_bd = np.cumsum((0,) + (tuple(cfg.tile_cols) or (ctb_w,)))
            ctb_h = (cfg.height + (1 << cfg.ctu_log2) - 1) >> cfg.ctu_log2
            row_bd = np.cumsum((0,) + (tuple(cfg.tile_rows) or (ctb_h,)))
            for i, t in enumerate(trees):
                rx, ry = i % ctb_w, i // ctb_w
                can_left = rx not in col_bd
                can_up = ry not in row_bd
                t["sao"] = _random_sao(cfg, rng, can_left, can_up)
        if cfg.alf or cfg.ccalf:
            n_ids = sh.sh_num_alf_aps_ids_luma
            for t in trees:
                fy = int(rng.random() < 0.7)
                if fy and rng.random() < 0.6 and n_ids > 0:
                    set_idx = 16 + int(rng.integers(0, n_ids))
                else:
                    set_idx = int(rng.integers(0, 16))
                alt_aps = alf_apss[sh.sh_alf_aps_id_chroma] \
                    if alf_apss else None
                nalt = (alt_aps.alf_chroma_num_alt_filters_minus1 + 1) \
                    if alt_aps else 1
                fcb = int(sh.sh_alf_cb_enabled_flag
                          and rng.random() < 0.7)
                fcr = int(sh.sh_alf_cr_enabled_flag
                          and rng.random() < 0.7)
                cc = [0, 0]
                for i2, (en, aid) in enumerate((
                        (sh.sh_alf_cc_cb_enabled_flag,
                         sh.sh_alf_cc_cb_aps_id),
                        (sh.sh_alf_cc_cr_enabled_flag,
                         sh.sh_alf_cc_cr_aps_id))):
                    if en:
                        nf_cc = alf_apss[aid].alf_cc_cb_filters_signalled_minus1 + 1 \
                            if i2 == 0 else \
                            alf_apss[aid].alf_cc_cr_filters_signalled_minus1 + 1
                        cc[i2] = int(rng.integers(0, nf_cc + 1))
                t["alf"] = {
                    "flag_y": fy if fy else 0,
                    "set_idx": set_idx if fy else 0,
                    "flag_cb": fcb,
                    "alt_cb": int(rng.integers(0, nalt)) if fcb else 0,
                    "flag_cr": fcr,
                    "alt_cr": int(rng.integers(0, nalt)) if fcr else 0,
                    "cc_idc": cc,
                }
        fse = FrameSyntaxEncoder(sps, pps, sh, col_store=col_store)
        if is_p:
            refs_all = (l0_refs or [poc - 1]) + (l1_refs or
                                                 ([poc - 1]
                                                  if cfg.b_slices else []))
            fse.no_backward_pred = all(poc_of(r) < poc for r in refs_all)
        if cfg.mmvd_fullpel:
            sh.ph.ph_mmvd_fullpel_only_flag = int(rng.integers(0, 2))
        if cfg.weighted_pred and is_p:
            sh.sh_pred_weight_table = _random_pwt(cfg, rng)
        if cfg.alf or cfg.ccalf:
            ch_aps = alf_apss[sh.sh_alf_aps_id_chroma] if alf_apss else None
            fse.alf_num_chroma_alts = (
                ch_aps.alf_chroma_num_alt_filters_minus1 + 1
                if ch_aps else 1)
            fse.alf_num_cc_filters = (
                alf_apss[sh.sh_alf_cc_cb_aps_id]
                .alf_cc_cb_filters_signalled_minus1 + 1,
                alf_apss[sh.sh_alf_cc_cr_aps_id]
                .alf_cc_cr_filters_signalled_minus1 + 1)
        fse.qp_delta_rng = rng
        fse.tool_rng = rng
        n_tiles = len(fse.tile_col_w) * len(fse.tile_row_h)
        if cfg.rect_slices:
            # explicit rect slices: each slice encodes its tile
            # rectangle in raster order within the rectangle
            n_cols = len(fse.tile_col_w)
            slice_payloads = []
            for si, (tx0, ty0, wt, ht) in enumerate(cfg.rect_slices):
                tiles = [ty * n_cols + tx
                         for ty in range(ty0, ty0 + ht)
                         for tx in range(tx0, tx0 + wt)]
                payload, eps = fse.encode_slice_data(trees, tiles=tiles)
                slice_payloads.append((si, len(tiles), payload, eps))
        elif cfg.n_slices > 1:
            # raster multi-slice: split the tile range into contiguous
            # per-slice chunks; each slice is its own NAL after a
            # separate PH NAL (7.4.8 requires the PH NAL when a picture
            # has more than one slice)
            assert 1 < cfg.n_slices <= n_tiles, \
                "n_slices needs at least that many tiles"
            bounds = [round(k * n_tiles / cfg.n_slices)
                      for k in range(cfg.n_slices + 1)]
            slice_payloads = []
            for lo, hi in zip(bounds, bounds[1:]):
                payload, eps = fse.encode_slice_data(trees, lo, hi)
                slice_payloads.append((lo, hi - lo, payload, eps))
        else:
            payload, ep_offsets = fse.encode_slice_data(trees)
            sh.sh_entry_point_offsets = tuple(ep_offsets)
            if n_tiles > 1:  # raster slice covering every tile
                sh.sh_slice_address = 0
                sh.sh_num_tiles_in_slice_minus1 = n_tiles - 1
        # snapshot this frame's motion for TMVP readers
        if cfg.tmvp:
            import numpy as _np
            if fse.motion is not None:
                m = fse.motion
                col_store[poc] = (poc, m.pf.copy(), m.mvx.copy(),
                                  m.mvy.copy(), m.ridx.copy(), m.rpl)
            else:  # intra frame: all-intra motion field
                ph4, pw4 = cfg.height >> 2, cfg.width >> 2
                col_store[poc] = (poc, _np.zeros((ph4, pw4), _np.int32),
                                  _np.zeros((2, ph4, pw4), _np.int32),
                                  _np.zeros((2, ph4, pw4), _np.int32),
                                  _np.full((2, ph4, pw4), -1, _np.int32),
                                  ((), ()))

        if cfg.rect_slices or cfg.n_slices > 1:
            import copy
            sh.sh_picture_header_in_slice_header_flag = 0
            if cfg.lmcs:
                sh.sh_lmcs_used_flag = 1
            if cfg.scaling_lists:
                sh.sh_explicit_scaling_list_used_flag = 1
            out += sh.ph.to_nal(sps, pps)
            for addr, cnt, payload_k, eps in slice_payloads:
                sk = copy.deepcopy(sh)
                sk.sh_slice_address = addr
                if not cfg.rect_slices:
                    sk.sh_num_tiles_in_slice_minus1 = cnt - 1
                sk.sh_entry_point_offsets = tuple(eps)
                w = BitWriter()
                sk.write(w, sps, pps, num_tiles_in_pic=n_tiles,
                         num_slices_in_pic=max(len(cfg.rect_slices), 1))
                assert w.bit_length % 8 == 0
                out += make_nal(nal_type,
                                w.to_bytes() + payload_k + b"\x80")
        else:
            if cfg.separate_ph:
                sh.sh_picture_header_in_slice_header_flag = 0
                if cfg.lmcs:
                    sh.sh_lmcs_used_flag = 1
                if cfg.scaling_lists:
                    sh.sh_explicit_scaling_list_used_flag = 1
                out += sh.ph.to_nal(sps, pps)
            w = BitWriter()
            sh.write(w, sps, pps, num_tiles_in_pic=n_tiles)
            assert w.bit_length % 8 == 0
            rbsp = w.to_bytes() + payload + b"\x80"  # rbsp stop bit byte
            out += make_nal(nal_type, rbsp)

        intent["frames"].append({
            "poc": poc,
            "slice_qp": fse.slice_qp_y,
            # leaves in decode (z) order, matching the parser's CU order
            "cus": [_cu_to_dict(cu) for t in trees for cu in tree_leaves(t)],
        })

    return bytes(out), intent


def _cu_to_dict(cu: CuIntent) -> dict:
    return {
        "x0": cu.x0, "y0": cu.y0, "w": cu.w, "h": cu.h,
        "pred_mode": cu.pred_mode,
        "skip": int(cu.skip), "merge": int(cu.merge),
        "sbtmvp": int(cu.sbtmvp),
        "affine": cu.affine_params[0] if cu.affine_params else 0,
        "merge_idx": cu.merge_idx, "mvp_flag": cu.mvp_flag,
        "mvd": list(cu.mvd), "mv": None if cu.mv is None else list(cu.mv),
        "ref_idx": cu.ref_idx,
        "pred_list": cu.pred_list, "pred_flag": cu.pred_flag,
        "mv1": None if cu.mv1 is None else list(cu.mv1),
        "ref_idx1": cu.ref_idx1,
        "luma_mode": cu.luma_mode,
        "chroma_mode_idx": cu.chroma_mode_idx,
        "mip_mode": cu.mip_mode, "mip_transposed": cu.mip_transposed,
        "cclm_idx": cu.cclm_idx,
        "coeff_y": None if cu.coeff_y is None else cu.coeff_y.tolist(),
        "coeff_cb": None if cu.coeff_cb is None else cu.coeff_cb.tolist(),
        "coeff_cr": None if cu.coeff_cr is None else cu.coeff_cr.tolist(),
    }
