"""H.266 header syntax structures and bitstream writer (CBS write side).

Python dataclasses named after the spec's syntax elements, with writers
that emit the exact field order of ITU-T H.266 7.3.2 (behavioural parity
with the reference's CBS read/write template,
`libavcodec/cbs_h266_syntax_template.c:1054` (SPS), `:1645` (PPS),
`:2593` (PH), `:3011` (SH)).  Used by the stream generator, the muxer
side of the framework, and round-trip tests against the native reader.

Only syntax branches for tools the framework exercises are writable; the
remaining branches assert their enable flags are 0 so an unsupported
config fails loudly at write time rather than emitting a broken stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.bits import (
    BitWriter,
    NAL_PPS,
    NAL_SPS,
    make_nal,
)


def ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


@dataclass
class GeneralConstraintsInfo:
    gci_present_flag: int = 0

    def write(self, w: BitWriter) -> None:
        w.flag(self.gci_present_flag)
        assert not self.gci_present_flag, "gci fields not implemented"
        w.align_zero()


@dataclass
class ProfileTierLevel:
    general_profile_idc: int = 1  # Main 10
    general_tier_flag: int = 0
    general_level_idc: int = 83  # level 5.1
    ptl_frame_only_constraint_flag: int = 1
    ptl_multilayer_enabled_flag: int = 0
    gci: GeneralConstraintsInfo = field(default_factory=GeneralConstraintsInfo)
    ptl_num_sub_profiles: int = 0

    def write(self, w: BitWriter, profile_present: int, max_sublayers_minus1: int) -> None:
        if profile_present:
            w.u(7, self.general_profile_idc)
            w.flag(self.general_tier_flag)
        w.u(8, self.general_level_idc)
        w.flag(self.ptl_frame_only_constraint_flag)
        w.flag(self.ptl_multilayer_enabled_flag)
        if profile_present:
            self.gci.write(w)
        for _ in range(max_sublayers_minus1 - 1, -1, -1):
            w.flag(0)  # ptl_sublayer_level_present_flag
        w.align_zero()  # ptl_reserved_zero_bit
        if profile_present:
            w.u(8, self.ptl_num_sub_profiles)
            assert self.ptl_num_sub_profiles == 0


@dataclass
class RefPicListStruct:
    """One candidate reference picture list (spec 7.3.10).

    entries: ST entries are (abs_delta_poc, sign); LT entries are
    ("lt", poc_lsb, delta_poc_msb_cycle).  Inline slice-header structs
    have ltrp_in_header inferred 1, so the LT POC info is written in
    the ref_pic_lists() post-amble (write_lt_info)."""
    entries: list = field(default_factory=list)

    @property
    def num_ref_entries(self) -> int:
        return len(self.entries)

    def write(self, w: BitWriter, sps: "SPS", list_idx: int, rpls_idx: int,
              in_sps: bool = False) -> None:
        w.ue(self.num_ref_entries)
        if in_sps and sps.sps_long_term_ref_pics_flag and self.num_ref_entries:
            w.flag(1)  # ltrp_in_header_flag: LT POC info in ref_pic_lists()
        assert not sps.sps_inter_layer_prediction_enabled_flag
        st_count = sum(1 for e in self.entries if e[0] != "lt")
        if not sps.sps_long_term_ref_pics_flag:
            assert st_count == len(self.entries), "LT needs the SPS flag"
        wp = sps.sps_weighted_pred_flag or sps.sps_weighted_bipred_flag
        for i, e in enumerate(self.entries):
            is_lt = e[0] == "lt"
            if sps.sps_long_term_ref_pics_flag:
                w.flag(0 if is_lt else 1)  # st_ref_pic_flag
            if is_lt:
                continue  # POC LSB + MSB cycle follow in the post-amble
            abs_delta_poc, sign = e
            coded = abs_delta_poc if (wp and i != 0) else abs_delta_poc - 1
            assert coded >= 0
            w.ue(coded)
            if abs_delta_poc > 0:
                w.flag(sign)

    def write_lt_info(self, w: BitWriter, sps: "SPS") -> None:
        """ref_pic_lists() LT post-amble (spec 7.3.9)."""
        for e in self.entries:
            if e[0] != "lt":
                continue
            _, poc_lsb, msb_cycle = e
            w.u(sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4, poc_lsb)
            w.flag(1)  # delta_poc_msb_cycle_present_flag
            w.ue(msb_cycle)


def write_ref_pic_lists(w: BitWriter, sps: "SPS", pps: "PPS", rpl,
                        sps_idx=()) -> None:
    """ref_pic_lists() (spec 7.3.9): per list, either select an SPS
    candidate struct (rpl_sps_flag + rpl_idx; sps_idx gives the two
    indices and the selected structs must equal rpl[i]) or write the
    struct inline, then the LT post-amble."""
    for i in range(2):
        n = len(sps.sps_ref_pic_lists[i])
        use_sps = bool(sps_idx) and sps_idx[i] is not None
        if n > 0 and (i == 0 or pps.pps_rpl1_idx_present_flag):
            w.flag(1 if use_sps else 0)
        else:
            assert use_sps == (False if n == 0 else bool(sps_idx)
                               and sps_idx[0] is not None), \
                "inferred rpl_sps_flag mismatch"
        if use_sps:
            idx = sps_idx[i]
            if n > 1 and (i == 0 or pps.pps_rpl1_idx_present_flag):
                bits = max((n - 1).bit_length(), 1)
                w.u(bits, idx)
            sel = sps.sps_ref_pic_lists[i][idx]
            assert sel.entries == rpl[i].entries, \
                f"selected SPS rpl {i}[{idx}] != slice rpl"
        else:
            rpl[i].write(w, sps, i, n)
        rpl[i].write_lt_info(w, sps)


@dataclass
class SPS:
    sps_seq_parameter_set_id: int = 0
    sps_video_parameter_set_id: int = 0
    sps_max_sublayers_minus1: int = 0
    sps_chroma_format_idc: int = 1  # 4:2:0
    sps_log2_ctu_size_minus5: int = 0  # CTU 32
    sps_ptl_dpb_hrd_params_present_flag: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    sps_gdr_enabled_flag: int = 0
    sps_ref_pic_resampling_enabled_flag: int = 0
    sps_pic_width_max_in_luma_samples: int = 64
    sps_pic_height_max_in_luma_samples: int = 64
    sps_conformance_window_flag: int = 0
    sps_conf_win: tuple = (0, 0, 0, 0)
    sps_subpic_info_present_flag: int = 0
    sps_bitdepth_minus8: int = 0
    sps_entropy_coding_sync_enabled_flag: int = 0
    sps_entry_point_offsets_present_flag: int = 0
    sps_log2_max_pic_order_cnt_lsb_minus4: int = 4
    sps_poc_msb_cycle_flag: int = 0
    sps_num_extra_ph_bytes: int = 0
    sps_num_extra_sh_bytes: int = 0
    # dpb (present when ptl_dpb_hrd present, single sublayer)
    dpb_max_dec_pic_buffering_minus1: int = 7
    dpb_max_num_reorder_pics: int = 0
    dpb_max_latency_increase_plus1: int = 0
    sps_log2_min_luma_coding_block_size_minus2: int = 0  # min CB 4
    sps_partition_constraints_override_enabled_flag: int = 0
    sps_log2_diff_min_qt_min_cb_intra_slice_luma: int = 0
    sps_max_mtt_hierarchy_depth_intra_slice_luma: int = 0
    sps_log2_diff_max_bt_min_qt_intra_slice_luma: int = 0
    sps_log2_diff_max_tt_min_qt_intra_slice_luma: int = 0
    sps_qtbtt_dual_tree_intra_flag: int = 0
    sps_log2_diff_min_qt_min_cb_intra_slice_chroma: int = 0
    sps_max_mtt_hierarchy_depth_intra_slice_chroma: int = 0
    sps_log2_diff_max_bt_min_qt_intra_slice_chroma: int = 0
    sps_log2_diff_max_tt_min_qt_intra_slice_chroma: int = 0
    sps_log2_diff_min_qt_min_cb_inter_slice: int = 0
    sps_max_mtt_hierarchy_depth_inter_slice: int = 0
    sps_log2_diff_max_bt_min_qt_inter_slice: int = 0
    sps_log2_diff_max_tt_min_qt_inter_slice: int = 0
    sps_max_luma_transform_size_64_flag: int = 0
    sps_transform_skip_enabled_flag: int = 0
    sps_log2_transform_skip_max_size_minus2: int = 0
    sps_bdpcm_enabled_flag: int = 0
    sps_mts_enabled_flag: int = 0
    sps_explicit_mts_intra_enabled_flag: int = 0
    sps_explicit_mts_inter_enabled_flag: int = 0
    sps_lfnst_enabled_flag: int = 0
    sps_joint_cbcr_enabled_flag: int = 0
    sps_same_qp_table_for_chroma_flag: int = 1
    # one qp table by default: list of (start_minus26, [(in_minus1, diff)])
    qp_tables: list = field(default_factory=lambda: [(0, [(25, 1)])])
    sps_sao_enabled_flag: int = 0
    sps_alf_enabled_flag: int = 0
    sps_ccalf_enabled_flag: int = 0
    sps_lmcs_enabled_flag: int = 0
    sps_weighted_pred_flag: int = 0
    sps_weighted_bipred_flag: int = 0
    sps_long_term_ref_pics_flag: int = 0
    sps_inter_layer_prediction_enabled_flag: int = 0
    sps_idr_rpl_present_flag: int = 0
    sps_rpl1_same_as_rpl0_flag: int = 0
    sps_ref_pic_lists: tuple = ((), ())  # tuple[list[RefPicListStruct], ...]
    sps_ref_wraparound_enabled_flag: int = 0
    sps_temporal_mvp_enabled_flag: int = 0
    sps_sbtmvp_enabled_flag: int = 0
    sps_amvr_enabled_flag: int = 0
    sps_bdof_enabled_flag: int = 0
    sps_bdof_control_present_in_ph_flag: int = 0
    sps_smvd_enabled_flag: int = 0
    sps_dmvr_enabled_flag: int = 0
    sps_dmvr_control_present_in_ph_flag: int = 0
    sps_mmvd_enabled_flag: int = 0
    sps_mmvd_fullpel_only_enabled_flag: int = 0
    sps_six_minus_max_num_merge_cand: int = 0
    sps_sbt_enabled_flag: int = 0
    sps_affine_enabled_flag: int = 0
    sps_five_minus_max_num_subblock_merge_cand: int = 0
    sps_6param_affine_enabled_flag: int = 0
    sps_affine_amvr_enabled_flag: int = 0
    sps_affine_prof_enabled_flag: int = 0
    sps_prof_control_present_in_ph_flag: int = 0
    sps_bcw_enabled_flag: int = 0
    sps_ciip_enabled_flag: int = 0
    sps_gpm_enabled_flag: int = 0
    sps_max_num_merge_cand_minus_max_num_gpm_cand: int = 0
    sps_log2_parallel_merge_level_minus2: int = 0
    sps_isp_enabled_flag: int = 0
    sps_mrl_enabled_flag: int = 0
    sps_mip_enabled_flag: int = 0
    sps_cclm_enabled_flag: int = 0
    sps_chroma_horizontal_collocated_flag: int = 1
    sps_chroma_vertical_collocated_flag: int = 1
    sps_palette_enabled_flag: int = 0
    sps_act_enabled_flag: int = 0
    sps_min_qp_prime_ts: int = 0
    sps_ibc_enabled_flag: int = 0
    sps_ladf_enabled_flag: int = 0
    sps_explicit_scaling_list_enabled_flag: int = 0
    sps_scaling_matrix_for_lfnst_disabled_flag: int = 0
    sps_dep_quant_enabled_flag: int = 0
    sps_sign_data_hiding_enabled_flag: int = 0
    sps_virtual_boundaries_enabled_flag: int = 0
    sps_timing_hrd_params_present_flag: int = 0
    sps_field_seq_flag: int = 0
    sps_vui_parameters_present_flag: int = 0
    sps_extension_flag: int = 0

    # ---- derived helpers ----
    @property
    def ctb_log2_size_y(self) -> int:
        return self.sps_log2_ctu_size_minus5 + 5

    @property
    def bit_depth(self) -> int:
        return self.sps_bitdepth_minus8 + 8

    def write(self, w: BitWriter) -> None:
        w.u(4, self.sps_seq_parameter_set_id)
        w.u(4, self.sps_video_parameter_set_id)
        w.u(3, self.sps_max_sublayers_minus1)
        w.u(2, self.sps_chroma_format_idc)
        w.u(2, self.sps_log2_ctu_size_minus5)
        w.flag(self.sps_ptl_dpb_hrd_params_present_flag)
        if self.sps_ptl_dpb_hrd_params_present_flag:
            self.ptl.write(w, 1, self.sps_max_sublayers_minus1)
        w.flag(self.sps_gdr_enabled_flag)
        w.flag(self.sps_ref_pic_resampling_enabled_flag)
        assert not self.sps_ref_pic_resampling_enabled_flag
        w.ue(self.sps_pic_width_max_in_luma_samples)
        w.ue(self.sps_pic_height_max_in_luma_samples)
        w.flag(self.sps_conformance_window_flag)
        if self.sps_conformance_window_flag:
            for v in self.sps_conf_win:
                w.ue(v)
        w.flag(self.sps_subpic_info_present_flag)
        assert not self.sps_subpic_info_present_flag, "subpics not implemented"
        w.ue(self.sps_bitdepth_minus8)
        w.flag(self.sps_entropy_coding_sync_enabled_flag)
        w.flag(self.sps_entry_point_offsets_present_flag)
        w.u(4, self.sps_log2_max_pic_order_cnt_lsb_minus4)
        w.flag(self.sps_poc_msb_cycle_flag)
        assert not self.sps_poc_msb_cycle_flag
        w.u(2, self.sps_num_extra_ph_bytes)
        w.u(2, self.sps_num_extra_sh_bytes)
        assert not (self.sps_num_extra_ph_bytes or self.sps_num_extra_sh_bytes)
        if self.sps_ptl_dpb_hrd_params_present_flag:
            # sps_sublayer_dpb_params_flag only if sublayers > 0
            assert self.sps_max_sublayers_minus1 == 0
            w.ue(self.dpb_max_dec_pic_buffering_minus1)
            w.ue(self.dpb_max_num_reorder_pics)
            w.ue(self.dpb_max_latency_increase_plus1)
        w.ue(self.sps_log2_min_luma_coding_block_size_minus2)
        w.flag(self.sps_partition_constraints_override_enabled_flag)
        w.ue(self.sps_log2_diff_min_qt_min_cb_intra_slice_luma)
        w.ue(self.sps_max_mtt_hierarchy_depth_intra_slice_luma)
        if self.sps_max_mtt_hierarchy_depth_intra_slice_luma:
            w.ue(self.sps_log2_diff_max_bt_min_qt_intra_slice_luma)
            w.ue(self.sps_log2_diff_max_tt_min_qt_intra_slice_luma)
        if self.sps_chroma_format_idc != 0:
            w.flag(self.sps_qtbtt_dual_tree_intra_flag)
        if self.sps_qtbtt_dual_tree_intra_flag:
            w.ue(self.sps_log2_diff_min_qt_min_cb_intra_slice_chroma)
            w.ue(self.sps_max_mtt_hierarchy_depth_intra_slice_chroma)
            if self.sps_max_mtt_hierarchy_depth_intra_slice_chroma:
                w.ue(self.sps_log2_diff_max_bt_min_qt_intra_slice_chroma)
                w.ue(self.sps_log2_diff_max_tt_min_qt_intra_slice_chroma)
        w.ue(self.sps_log2_diff_min_qt_min_cb_inter_slice)
        w.ue(self.sps_max_mtt_hierarchy_depth_inter_slice)
        if self.sps_max_mtt_hierarchy_depth_inter_slice:
            w.ue(self.sps_log2_diff_max_bt_min_qt_inter_slice)
            w.ue(self.sps_log2_diff_max_tt_min_qt_inter_slice)
        if (1 << self.ctb_log2_size_y) > 32:
            w.flag(self.sps_max_luma_transform_size_64_flag)
        else:
            assert not self.sps_max_luma_transform_size_64_flag
        w.flag(self.sps_transform_skip_enabled_flag)
        if self.sps_transform_skip_enabled_flag:
            w.ue(self.sps_log2_transform_skip_max_size_minus2)
            w.flag(self.sps_bdpcm_enabled_flag)
        w.flag(self.sps_mts_enabled_flag)
        if self.sps_mts_enabled_flag:
            w.flag(self.sps_explicit_mts_intra_enabled_flag)
            w.flag(self.sps_explicit_mts_inter_enabled_flag)
        w.flag(self.sps_lfnst_enabled_flag)
        if self.sps_chroma_format_idc != 0:
            w.flag(self.sps_joint_cbcr_enabled_flag)
            w.flag(self.sps_same_qp_table_for_chroma_flag)
            num_qp_tables = (1 if self.sps_same_qp_table_for_chroma_flag
                             else (3 if self.sps_joint_cbcr_enabled_flag else 2))
            assert len(self.qp_tables) == num_qp_tables
            for start_minus26, points in self.qp_tables:
                w.se(start_minus26)
                w.ue(len(points) - 1)
                for in_minus1, diff in points:
                    w.ue(in_minus1)
                    w.ue(diff)
        w.flag(self.sps_sao_enabled_flag)
        w.flag(self.sps_alf_enabled_flag)
        if self.sps_alf_enabled_flag and self.sps_chroma_format_idc:
            w.flag(self.sps_ccalf_enabled_flag)
        w.flag(self.sps_lmcs_enabled_flag)
        w.flag(self.sps_weighted_pred_flag)
        w.flag(self.sps_weighted_bipred_flag)
        w.flag(self.sps_long_term_ref_pics_flag)
        if self.sps_video_parameter_set_id > 0:
            w.flag(self.sps_inter_layer_prediction_enabled_flag)
        w.flag(self.sps_idr_rpl_present_flag)
        w.flag(self.sps_rpl1_same_as_rpl0_flag)
        for i in range(1 if self.sps_rpl1_same_as_rpl0_flag else 2):
            lists = self.sps_ref_pic_lists[i]
            w.ue(len(lists))
            for j, rpls in enumerate(lists):
                rpls.write(w, self, i, j, in_sps=True)
        w.flag(self.sps_ref_wraparound_enabled_flag)
        w.flag(self.sps_temporal_mvp_enabled_flag)
        if self.sps_temporal_mvp_enabled_flag:
            w.flag(self.sps_sbtmvp_enabled_flag)
        w.flag(self.sps_amvr_enabled_flag)
        w.flag(self.sps_bdof_enabled_flag)
        if self.sps_bdof_enabled_flag:
            w.flag(self.sps_bdof_control_present_in_ph_flag)
        w.flag(self.sps_smvd_enabled_flag)
        w.flag(self.sps_dmvr_enabled_flag)
        if self.sps_dmvr_enabled_flag:
            w.flag(self.sps_dmvr_control_present_in_ph_flag)
        w.flag(self.sps_mmvd_enabled_flag)
        if self.sps_mmvd_enabled_flag:
            w.flag(self.sps_mmvd_fullpel_only_enabled_flag)
        w.ue(self.sps_six_minus_max_num_merge_cand)
        max_num_merge_cand = 6 - self.sps_six_minus_max_num_merge_cand
        w.flag(self.sps_sbt_enabled_flag)
        w.flag(self.sps_affine_enabled_flag)
        if self.sps_affine_enabled_flag:
            w.ue(self.sps_five_minus_max_num_subblock_merge_cand)
            w.flag(self.sps_6param_affine_enabled_flag)
            if self.sps_amvr_enabled_flag:
                w.flag(self.sps_affine_amvr_enabled_flag)
            w.flag(self.sps_affine_prof_enabled_flag)
            if self.sps_affine_prof_enabled_flag:
                w.flag(self.sps_prof_control_present_in_ph_flag)
        w.flag(self.sps_bcw_enabled_flag)
        w.flag(self.sps_ciip_enabled_flag)
        if max_num_merge_cand >= 2:
            w.flag(self.sps_gpm_enabled_flag)
            if self.sps_gpm_enabled_flag and max_num_merge_cand >= 3:
                w.ue(self.sps_max_num_merge_cand_minus_max_num_gpm_cand)
        w.ue(self.sps_log2_parallel_merge_level_minus2)
        w.flag(self.sps_isp_enabled_flag)
        w.flag(self.sps_mrl_enabled_flag)
        w.flag(self.sps_mip_enabled_flag)
        if self.sps_chroma_format_idc != 0:
            w.flag(self.sps_cclm_enabled_flag)
        if self.sps_chroma_format_idc == 1:
            w.flag(self.sps_chroma_horizontal_collocated_flag)
            w.flag(self.sps_chroma_vertical_collocated_flag)
        w.flag(self.sps_palette_enabled_flag)
        assert not self.sps_palette_enabled_flag
        if self.sps_chroma_format_idc == 3 and not self.sps_max_luma_transform_size_64_flag:
            w.flag(self.sps_act_enabled_flag)
        if self.sps_transform_skip_enabled_flag or self.sps_palette_enabled_flag:
            w.ue(self.sps_min_qp_prime_ts)
        w.flag(self.sps_ibc_enabled_flag)
        assert not self.sps_ibc_enabled_flag
        w.flag(self.sps_ladf_enabled_flag)
        assert not self.sps_ladf_enabled_flag
        w.flag(self.sps_explicit_scaling_list_enabled_flag)
        if self.sps_lfnst_enabled_flag and self.sps_explicit_scaling_list_enabled_flag:
            w.flag(self.sps_scaling_matrix_for_lfnst_disabled_flag)
        # act scaling matrix branch: act off
        w.flag(self.sps_dep_quant_enabled_flag)
        w.flag(self.sps_sign_data_hiding_enabled_flag)
        w.flag(self.sps_virtual_boundaries_enabled_flag)
        assert not self.sps_virtual_boundaries_enabled_flag
        if self.sps_ptl_dpb_hrd_params_present_flag:
            w.flag(self.sps_timing_hrd_params_present_flag)
            assert not self.sps_timing_hrd_params_present_flag
        w.flag(self.sps_field_seq_flag)
        w.flag(self.sps_vui_parameters_present_flag)
        assert not self.sps_vui_parameters_present_flag
        w.flag(self.sps_extension_flag)
        assert not self.sps_extension_flag
        w.rbsp_trailing_bits()

    def to_nal(self) -> bytes:
        w = BitWriter()
        self.write(w)
        return make_nal(NAL_SPS, w.to_bytes())


@dataclass
class PPS:
    pps_pic_parameter_set_id: int = 0
    pps_seq_parameter_set_id: int = 0
    pps_mixed_nalu_types_in_pic_flag: int = 0
    pps_pic_width_in_luma_samples: int = 64
    pps_pic_height_in_luma_samples: int = 64
    pps_conformance_window_flag: int = 0
    pps_scaling_window_explicit_signalling_flag: int = 0
    pps_output_flag_present_flag: int = 0
    pps_no_pic_partition_flag: int = 1
    pps_subpic_id_mapping_present_flag: int = 0
    # tile geometry (used when no_pic_partition == 0)
    pps_num_exp_tile_columns_minus1: int = 0
    pps_tile_column_width_minus1: tuple = (0,)
    pps_num_exp_tile_rows_minus1: int = 0
    pps_tile_row_height_minus1: tuple = (0,)
    pps_loop_filter_across_tiles_enabled_flag: int = 0
    pps_rect_slice_flag: int = 1
    pps_single_slice_per_subpic_flag: int = 1
    pps_num_slices_in_pic_minus1: int = 0
    pps_loop_filter_across_slices_enabled_flag: int = 0
    pps_cabac_init_present_flag: int = 0
    pps_num_ref_idx_default_active_minus1: tuple = (0, 0)
    pps_rpl1_idx_present_flag: int = 0
    # explicit tile-aligned rect slices: per-slice (tx0, ty0, w_tiles,
    # h_tiles) following the no-delta raster advance (spec 6.5.1)
    pps_slice_rects: tuple = ()
    pps_weighted_pred_flag: int = 0
    pps_weighted_bipred_flag: int = 0
    pps_ref_wraparound_enabled_flag: int = 0
    pps_pic_width_minus_wraparound_offset: int = 0
    pps_init_qp_minus26: int = 0
    pps_cu_qp_delta_enabled_flag: int = 0
    pps_chroma_tool_offsets_present_flag: int = 0
    pps_cb_qp_offset: int = 0
    pps_cr_qp_offset: int = 0
    pps_joint_cbcr_qp_offset_present_flag: int = 0
    pps_joint_cbcr_qp_offset_value: int = 0
    pps_slice_chroma_qp_offsets_present_flag: int = 0
    pps_cu_chroma_qp_offset_list_enabled_flag: int = 0
    pps_deblocking_filter_control_present_flag: int = 0
    pps_deblocking_filter_override_enabled_flag: int = 0
    pps_deblocking_filter_disabled_flag: int = 0
    pps_dbf_info_in_ph_flag: int = 0
    pps_luma_beta_offset_div2: int = 0
    pps_luma_tc_offset_div2: int = 0
    pps_cb_beta_offset_div2: int = 0
    pps_cb_tc_offset_div2: int = 0
    pps_cr_beta_offset_div2: int = 0
    pps_cr_tc_offset_div2: int = 0
    # *_info_in_ph flags (only when partitioned)
    pps_rpl_info_in_ph_flag: int = 0
    pps_sao_info_in_ph_flag: int = 0
    pps_alf_info_in_ph_flag: int = 0
    pps_wp_info_in_ph_flag: int = 0
    pps_qp_delta_info_in_ph_flag: int = 0
    pps_picture_header_extension_present_flag: int = 0
    pps_slice_header_extension_present_flag: int = 0
    pps_extension_flag: int = 0

    def write(self, w: BitWriter, sps: SPS) -> None:
        w.u(6, self.pps_pic_parameter_set_id)
        w.u(4, self.pps_seq_parameter_set_id)
        w.flag(self.pps_mixed_nalu_types_in_pic_flag)
        w.ue(self.pps_pic_width_in_luma_samples)
        w.ue(self.pps_pic_height_in_luma_samples)
        w.flag(self.pps_conformance_window_flag)
        assert not self.pps_conformance_window_flag
        w.flag(self.pps_scaling_window_explicit_signalling_flag)
        assert not self.pps_scaling_window_explicit_signalling_flag
        w.flag(self.pps_output_flag_present_flag)
        w.flag(self.pps_no_pic_partition_flag)
        w.flag(self.pps_subpic_id_mapping_present_flag)
        assert not self.pps_subpic_id_mapping_present_flag
        if not self.pps_no_pic_partition_flag:
            w.u(2, sps.sps_log2_ctu_size_minus5)
            w.ue(self.pps_num_exp_tile_columns_minus1)
            w.ue(self.pps_num_exp_tile_rows_minus1)
            for v in self.pps_tile_column_width_minus1:
                w.ue(v)
            for v in self.pps_tile_row_height_minus1:
                w.ue(v)
            num_tiles = self._num_tiles(sps)
            if num_tiles > 1:
                w.flag(self.pps_loop_filter_across_tiles_enabled_flag)
                w.flag(self.pps_rect_slice_flag)
            if self.pps_rect_slice_flag:
                w.flag(self.pps_single_slice_per_subpic_flag)
            if self.pps_rect_slice_flag and \
                    not self.pps_single_slice_per_subpic_flag:
                # explicit tile-aligned rect slice layout (7.3.2.4);
                # pps_slice_rects must follow the no-delta raster
                # advance so every width/height presence condition and
                # inference reproduces the given rectangles
                ctb = sps.ctb_log2_size_y
                w_ctbs = (self.pps_pic_width_in_luma_samples
                          + (1 << ctb) - 1) >> ctb
                h_ctbs = (self.pps_pic_height_in_luma_samples
                          + (1 << ctb) - 1) >> ctb
                cols = tile_partition(self.pps_tile_column_width_minus1,
                                      w_ctbs)
                rows = tile_partition(self.pps_tile_row_height_minus1,
                                      h_ctbs)
                n_cols, n_rows = len(cols), len(rows)
                rects = self.pps_slice_rects
                assert rects, "explicit layout needs pps_slice_rects"
                w.ue(len(rects) - 1)
                if len(rects) > 2:  # minus1 > 1 (7.3.2.4)
                    w.flag(0)  # pps_tile_idx_delta_present_flag
                tile_idx = 0
                prev_h = None
                for i, (tx0, ty0, wt, ht) in enumerate(rects):
                    assert tile_idx == ty0 * n_cols + tx0, \
                        "rects must follow the no-delta raster advance"
                    if i < len(rects) - 1:
                        if tx0 < n_cols - 1:
                            w.ue(wt - 1)
                        else:
                            assert wt == 1
                        if ty0 < n_rows - 1 and tx0 == 0:
                            w.ue(ht - 1)
                        elif ty0 == n_rows - 1:
                            assert ht == 1
                        else:
                            assert ht == prev_h, "inferred height chain"
                        if wt == 1 and ht == 1 and rows[ty0] > 1:
                            w.ue(0)  # pps_num_exp_slices_in_tile
                    else:
                        assert wt == n_cols - tx0 and ht == n_rows - ty0, \
                            "last slice covers the remaining rectangle"
                    prev_h = ht
                    tile_idx += wt
                    if tile_idx % n_cols == 0:
                        tile_idx += (ht - 1) * n_cols
            w.flag(self.pps_loop_filter_across_slices_enabled_flag)
        w.flag(self.pps_cabac_init_present_flag)
        for v in self.pps_num_ref_idx_default_active_minus1:
            w.ue(v)
        w.flag(self.pps_rpl1_idx_present_flag)
        w.flag(self.pps_weighted_pred_flag)
        w.flag(self.pps_weighted_bipred_flag)
        w.flag(self.pps_ref_wraparound_enabled_flag)
        if self.pps_ref_wraparound_enabled_flag:
            w.ue(self.pps_pic_width_minus_wraparound_offset)
        w.se(self.pps_init_qp_minus26)
        w.flag(self.pps_cu_qp_delta_enabled_flag)
        w.flag(self.pps_chroma_tool_offsets_present_flag)
        if self.pps_chroma_tool_offsets_present_flag:
            w.se(self.pps_cb_qp_offset)
            w.se(self.pps_cr_qp_offset)
            w.flag(self.pps_joint_cbcr_qp_offset_present_flag)
            if self.pps_joint_cbcr_qp_offset_present_flag:
                w.se(self.pps_joint_cbcr_qp_offset_value)
            w.flag(self.pps_slice_chroma_qp_offsets_present_flag)
            w.flag(self.pps_cu_chroma_qp_offset_list_enabled_flag)
            assert not self.pps_cu_chroma_qp_offset_list_enabled_flag
        w.flag(self.pps_deblocking_filter_control_present_flag)
        if self.pps_deblocking_filter_control_present_flag:
            w.flag(self.pps_deblocking_filter_override_enabled_flag)
            w.flag(self.pps_deblocking_filter_disabled_flag)
            if (not self.pps_no_pic_partition_flag
                    and self.pps_deblocking_filter_override_enabled_flag):
                w.flag(self.pps_dbf_info_in_ph_flag)
            if not self.pps_deblocking_filter_disabled_flag:
                w.se(self.pps_luma_beta_offset_div2)
                w.se(self.pps_luma_tc_offset_div2)
                if self.pps_chroma_tool_offsets_present_flag:
                    w.se(self.pps_cb_beta_offset_div2)
                    w.se(self.pps_cb_tc_offset_div2)
                    w.se(self.pps_cr_beta_offset_div2)
                    w.se(self.pps_cr_tc_offset_div2)
        if not self.pps_no_pic_partition_flag:
            w.flag(self.pps_rpl_info_in_ph_flag)
            w.flag(self.pps_sao_info_in_ph_flag)
            w.flag(self.pps_alf_info_in_ph_flag)
            if ((self.pps_weighted_pred_flag or self.pps_weighted_bipred_flag)
                    and self.pps_rpl_info_in_ph_flag):
                w.flag(self.pps_wp_info_in_ph_flag)
            w.flag(self.pps_qp_delta_info_in_ph_flag)
        w.flag(self.pps_picture_header_extension_present_flag)
        w.flag(self.pps_slice_header_extension_present_flag)
        assert not (self.pps_picture_header_extension_present_flag
                    or self.pps_slice_header_extension_present_flag)
        w.flag(self.pps_extension_flag)
        assert not self.pps_extension_flag
        w.rbsp_trailing_bits()

    def _num_tiles(self, sps: SPS) -> int:
        ctb = sps.ctb_log2_size_y
        w_ctbs = (self.pps_pic_width_in_luma_samples + (1 << ctb) - 1) >> ctb
        h_ctbs = (self.pps_pic_height_in_luma_samples + (1 << ctb) - 1) >> ctb
        cols = tile_partition(self.pps_tile_column_width_minus1, w_ctbs)
        rows = tile_partition(self.pps_tile_row_height_minus1, h_ctbs)
        return len(cols) * len(rows)

    def to_nal(self, sps: SPS) -> bytes:
        w = BitWriter()
        self.write(w, sps)
        return make_nal(NAL_PPS, w.to_bytes())


def tile_partition(exp_sizes_minus1, total: int) -> list[int]:
    """Expand explicit tile column/row sizes to the full partition
    (spec 6.5.1: remaining space filled with the last explicit size)."""
    sizes = []
    remaining = total
    for v in exp_sizes_minus1:
        assert v + 1 <= remaining
        sizes.append(v + 1)
        remaining -= v + 1
    unified = sizes[-1]
    while remaining > 0:
        s = min(unified, remaining)
        sizes.append(s)
        remaining -= s
    return sizes


APS_TYPE_ALF = 0
APS_TYPE_LMCS = 1
APS_TYPE_SCALING = 2


@dataclass
class APS:
    """Adaptation parameter set (spec 7.3.2.5 aps / 7.3.2.18 lmcs_data;
    reference: cbs_h266_syntax_template.c aps/lmcs_data)."""
    aps_params_type: int = APS_TYPE_LMCS
    aps_adaptation_parameter_set_id: int = 0
    aps_chroma_present_flag: int = 1
    # alf_data (APS_TYPE_ALF)
    alf_luma_filter_signal_flag: int = 0
    alf_chroma_filter_signal_flag: int = 0
    alf_cc_cb_filter_signal_flag: int = 0
    alf_cc_cr_filter_signal_flag: int = 0
    alf_luma_clip_flag: int = 0
    alf_luma_num_filters_signalled_minus1: int = 0
    alf_luma_coeff_delta_idx: tuple = (0,) * 25
    alf_luma_coeff_abs: tuple = ()      # (n_filters, 12)
    alf_luma_coeff_sign: tuple = ()
    alf_luma_clip_idx: tuple = ()       # (n_filters, 12)
    alf_chroma_clip_flag: int = 0
    alf_chroma_num_alt_filters_minus1: int = 0
    alf_chroma_coeff_abs: tuple = ()    # (n_alts, 6)
    alf_chroma_coeff_sign: tuple = ()
    alf_chroma_clip_idx: tuple = ()
    alf_cc_cb_filters_signalled_minus1: int = 0
    alf_cc_cb_mapped_coeff_abs: tuple = ()  # (n, 7)
    alf_cc_cb_coeff_sign: tuple = ()
    alf_cc_cr_filters_signalled_minus1: int = 0
    alf_cc_cr_mapped_coeff_abs: tuple = ()
    alf_cc_cr_coeff_sign: tuple = ()
    # lmcs_data
    lmcs_min_bin_idx: int = 0
    lmcs_delta_max_bin_idx: int = 0
    lmcs_delta_cw_prec_minus1: int = 0
    lmcs_delta_abs_cw: tuple = ()        # [min_bin_idx .. 15-delta_max]
    lmcs_delta_sign_cw_flag: tuple = ()
    lmcs_delta_abs_crs: int = 0
    lmcs_delta_sign_crs_flag: int = 0
    # scaling_list_data (7.3.2.21): per-id syntax (28 ids)
    sl_copy_mode_flag: tuple = (1,) * 28
    sl_pred_mode_flag: tuple = (0,) * 28
    sl_pred_id_delta: tuple = (0,) * 28
    sl_dc_coef: tuple = (0,) * 14        # ids 14..27, se(v)
    sl_delta_coef: tuple = ()            # (28, 64) se(v) deltas

    def write(self, w: BitWriter) -> None:
        w.u(3, self.aps_params_type)
        w.u(5, self.aps_adaptation_parameter_set_id)
        w.flag(self.aps_chroma_present_flag)
        if self.aps_params_type == APS_TYPE_ALF:
            w.flag(self.alf_luma_filter_signal_flag)
            if self.aps_chroma_present_flag:
                w.flag(self.alf_chroma_filter_signal_flag)
                w.flag(self.alf_cc_cb_filter_signal_flag)
                w.flag(self.alf_cc_cr_filter_signal_flag)
            nf = self.alf_luma_num_filters_signalled_minus1 + 1
            if self.alf_luma_filter_signal_flag:
                w.flag(self.alf_luma_clip_flag)
                w.ue(self.alf_luma_num_filters_signalled_minus1)
                if nf > 1:
                    bits = (nf - 1).bit_length()
                    for f in range(25):
                        w.u(bits, self.alf_luma_coeff_delta_idx[f])
                for sf in range(nf):
                    for j in range(12):
                        w.ue(self.alf_luma_coeff_abs[sf][j])
                        if self.alf_luma_coeff_abs[sf][j]:
                            w.flag(self.alf_luma_coeff_sign[sf][j])
            for sf in range(nf):
                for j in range(12):
                    if self.alf_luma_clip_flag:
                        w.u(2, self.alf_luma_clip_idx[sf][j])
            if self.alf_chroma_filter_signal_flag:
                w.flag(self.alf_chroma_clip_flag)
                w.ue(self.alf_chroma_num_alt_filters_minus1)
            for alt in range(self.alf_chroma_num_alt_filters_minus1 + 1):
                for j in range(6):
                    if self.alf_chroma_filter_signal_flag:
                        w.ue(self.alf_chroma_coeff_abs[alt][j])
                        if self.alf_chroma_coeff_abs[alt][j]:
                            w.flag(self.alf_chroma_coeff_sign[alt][j])
                for j in range(6):
                    if self.alf_chroma_clip_flag:
                        w.u(2, self.alf_chroma_clip_idx[alt][j])
            for cc, (sig, nmin, cabs, csgn) in enumerate((
                    (self.alf_cc_cb_filter_signal_flag,
                     self.alf_cc_cb_filters_signalled_minus1,
                     self.alf_cc_cb_mapped_coeff_abs,
                     self.alf_cc_cb_coeff_sign),
                    (self.alf_cc_cr_filter_signal_flag,
                     self.alf_cc_cr_filters_signalled_minus1,
                     self.alf_cc_cr_mapped_coeff_abs,
                     self.alf_cc_cr_coeff_sign))):
                if sig:
                    w.ue(nmin)
                for k in range(nmin + 1):
                    for j in range(7):
                        if sig:
                            w.u(3, cabs[k][j])
                            if cabs[k][j]:
                                w.flag(csgn[k][j])
        elif self.aps_params_type == APS_TYPE_LMCS:
            w.ue(self.lmcs_min_bin_idx)
            w.ue(self.lmcs_delta_max_bin_idx)
            w.ue(self.lmcs_delta_cw_prec_minus1)
            lmcs_max_bin_idx = 15 - self.lmcs_delta_max_bin_idx
            n = lmcs_max_bin_idx - self.lmcs_min_bin_idx + 1
            assert len(self.lmcs_delta_abs_cw) == n
            for i in range(n):
                w.u(self.lmcs_delta_cw_prec_minus1 + 1,
                    self.lmcs_delta_abs_cw[i])
                if self.lmcs_delta_abs_cw[i] > 0:
                    w.flag(self.lmcs_delta_sign_cw_flag[i])
            if self.aps_chroma_present_flag:
                w.u(3, self.lmcs_delta_abs_crs)
                if self.lmcs_delta_abs_crs > 0:
                    w.flag(self.lmcs_delta_sign_crs_flag)
        elif self.aps_params_type == APS_TYPE_SCALING:
            # scaling_list_data (7.3.2.21); the delta loop walks the
            # 8x8 diagonal scan (only the 64x64 skip needs x/y)
            diag = []
            for s in range(15):
                for y in range(min(s, 7), -1, -1):
                    if s - y < 8:
                        diag.append((s - y, y))
            for sid in range(28):
                if not (self.aps_chroma_present_flag or sid % 3 == 2
                        or sid == 27):
                    assert self.sl_copy_mode_flag[sid] == 1
                    continue
                copy = self.sl_copy_mode_flag[sid]
                w.flag(copy)
                if not copy:
                    w.flag(self.sl_pred_mode_flag[sid])
                if ((copy or self.sl_pred_mode_flag[sid])
                        and sid not in (0, 2, 8)):
                    w.ue(self.sl_pred_id_delta[sid])
                if not copy:
                    msize = 2 if sid < 2 else (4 if sid < 8 else 8)
                    if sid > 13:
                        w.se(self.sl_dc_coef[sid - 14])
                    for i in range(msize * msize):
                        x, y = diag[i]
                        if not (sid > 25 and x >= 4 and y >= 4):
                            w.se(self.sl_delta_coef[sid][i])
        else:
            raise NotImplementedError("APS type not implemented yet")
        w.flag(0)  # aps_extension_flag
        w.rbsp_trailing_bits()

    def to_nal(self) -> bytes:
        from ..bitstream.bits import NAL_PREFIX_APS

        w = BitWriter()
        self.write(w)
        return make_nal(NAL_PREFIX_APS, w.to_bytes())


@dataclass
class PictureHeader:
    ph_gdr_or_irap_pic_flag: int = 1
    ph_non_ref_pic_flag: int = 0
    ph_gdr_pic_flag: int = 0
    ph_inter_slice_allowed_flag: int = 0
    ph_intra_slice_allowed_flag: int = 1
    ph_pic_parameter_set_id: int = 0
    ph_pic_order_cnt_lsb: int = 0
    ph_recovery_poc_cnt: int = 0
    ph_pic_output_flag: int = 1
    ph_ref_pic_lists: tuple = None  # (RefPicListStruct, RefPicListStruct) if rpl in ph
    ph_partition_constraints_override_flag: int = 0
    ph_cu_qp_delta_subdiv_intra_slice: int = 0
    ph_cu_qp_delta_subdiv_inter_slice: int = 0
    ph_temporal_mvp_enabled_flag: int = 0
    ph_mmvd_fullpel_only_flag: int = 0
    ph_mvd_l1_zero_flag: int = 1
    ph_bdof_disabled_flag: int = 1
    ph_dmvr_disabled_flag: int = 1
    ph_prof_disabled_flag: int = 1
    ph_qp_delta: int = 0
    ph_joint_cbcr_sign_flag: int = 0
    ph_sao_luma_enabled_flag: int = 0
    ph_sao_chroma_enabled_flag: int = 0
    ph_lmcs_enabled_flag: int = 0
    ph_lmcs_aps_id: int = 0
    ph_chroma_residual_scale_flag: int = 0
    ph_alf_enabled_flag: int = 0
    ph_deblocking_params_present_flag: int = 0
    ph_deblocking_filter_disabled_flag: int = 0
    ph_luma_beta_offset_div2: int = 0
    ph_luma_tc_offset_div2: int = 0
    # RPL in PH (pps_rpl_info_in_ph_flag)
    ph_ref_pic_lists: tuple = ()      # (RefPicListStruct, RefPicListStruct)
    ph_rpl_sps_idx: tuple = ()        # SPS-candidate selection per list
    ph_collocated_from_l0_flag: int = 1
    ph_collocated_ref_idx: int = 0
    # ALF in PH (pps_alf_info_in_ph_flag)
    ph_alf_enabled_flag: int = 0
    ph_alf_aps_id_luma: tuple = ()
    ph_alf_cb_enabled_flag: int = 0
    ph_alf_cr_enabled_flag: int = 0
    ph_alf_aps_id_chroma: int = 0
    ph_alf_cc_cb_enabled_flag: int = 0
    ph_alf_cc_cb_aps_id: int = 0
    ph_alf_cc_cr_enabled_flag: int = 0
    ph_alf_cc_cr_aps_id: int = 0
    ph_explicit_scaling_list_enabled_flag: int = 0
    ph_scaling_list_aps_id: int = 0

    def write(self, w: BitWriter, sps: SPS, pps: PPS) -> None:
        w.flag(self.ph_gdr_or_irap_pic_flag)
        w.flag(self.ph_non_ref_pic_flag)
        if self.ph_gdr_or_irap_pic_flag:
            w.flag(self.ph_gdr_pic_flag)
        w.flag(self.ph_inter_slice_allowed_flag)
        if self.ph_inter_slice_allowed_flag:
            w.flag(self.ph_intra_slice_allowed_flag)
        w.ue(self.ph_pic_parameter_set_id)
        w.u(sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4, self.ph_pic_order_cnt_lsb)
        if self.ph_gdr_pic_flag:
            w.ue(self.ph_recovery_poc_cnt)
        if sps.sps_alf_enabled_flag and pps.pps_alf_info_in_ph_flag:
            w.flag(self.ph_alf_enabled_flag)
            if self.ph_alf_enabled_flag:
                w.u(3, len(self.ph_alf_aps_id_luma))
                for a in self.ph_alf_aps_id_luma:
                    w.u(3, a)
                if sps.sps_chroma_format_idc != 0:
                    w.flag(self.ph_alf_cb_enabled_flag)
                    w.flag(self.ph_alf_cr_enabled_flag)
                if self.ph_alf_cb_enabled_flag or self.ph_alf_cr_enabled_flag:
                    w.u(3, self.ph_alf_aps_id_chroma)
                if sps.sps_ccalf_enabled_flag:
                    w.flag(self.ph_alf_cc_cb_enabled_flag)
                    if self.ph_alf_cc_cb_enabled_flag:
                        w.u(3, self.ph_alf_cc_cb_aps_id)
                    w.flag(self.ph_alf_cc_cr_enabled_flag)
                    if self.ph_alf_cc_cr_enabled_flag:
                        w.u(3, self.ph_alf_cc_cr_aps_id)
        if sps.sps_lmcs_enabled_flag:
            w.flag(self.ph_lmcs_enabled_flag)
            if self.ph_lmcs_enabled_flag:
                w.u(2, self.ph_lmcs_aps_id)
                if sps.sps_chroma_format_idc != 0:
                    w.flag(self.ph_chroma_residual_scale_flag)
        if sps.sps_explicit_scaling_list_enabled_flag:
            w.flag(self.ph_explicit_scaling_list_enabled_flag)
            if self.ph_explicit_scaling_list_enabled_flag:
                w.u(3, self.ph_scaling_list_aps_id)
        if pps.pps_output_flag_present_flag and not self.ph_non_ref_pic_flag:
            w.flag(self.ph_pic_output_flag)
        if pps.pps_rpl_info_in_ph_flag:
            write_ref_pic_lists(w, sps, pps, self.ph_ref_pic_lists,
                                self.ph_rpl_sps_idx)
        if sps.sps_partition_constraints_override_enabled_flag:
            w.flag(self.ph_partition_constraints_override_flag)
            assert not self.ph_partition_constraints_override_flag
        if self.ph_intra_slice_allowed_flag:
            if pps.pps_cu_qp_delta_enabled_flag:
                w.ue(self.ph_cu_qp_delta_subdiv_intra_slice)
        if self.ph_inter_slice_allowed_flag:
            if pps.pps_cu_qp_delta_enabled_flag:
                w.ue(self.ph_cu_qp_delta_subdiv_inter_slice)
            if sps.sps_temporal_mvp_enabled_flag:
                w.flag(self.ph_temporal_mvp_enabled_flag)
                if self.ph_temporal_mvp_enabled_flag and \
                        pps.pps_rpl_info_in_ph_flag:
                    rpl = self.ph_ref_pic_lists
                    if rpl[1].num_ref_entries > 0:
                        w.flag(self.ph_collocated_from_l0_flag)
                    nsel = (rpl[0] if self.ph_collocated_from_l0_flag
                            else rpl[1]).num_ref_entries
                    if nsel > 1:
                        w.ue(self.ph_collocated_ref_idx)
            if sps.sps_mmvd_fullpel_only_enabled_flag:
                w.flag(self.ph_mmvd_fullpel_only_flag)
            if not pps.pps_rpl_info_in_ph_flag or \
                    self.ph_ref_pic_lists[1].num_ref_entries > 0:
                w.flag(self.ph_mvd_l1_zero_flag)
            if sps.sps_bdof_control_present_in_ph_flag:
                w.flag(self.ph_bdof_disabled_flag)
            if sps.sps_dmvr_control_present_in_ph_flag:
                w.flag(self.ph_dmvr_disabled_flag)
            if sps.sps_prof_control_present_in_ph_flag:
                w.flag(self.ph_prof_disabled_flag)
            assert not pps.pps_wp_info_in_ph_flag
        if pps.pps_qp_delta_info_in_ph_flag:
            w.se(self.ph_qp_delta)
        if sps.sps_joint_cbcr_enabled_flag:
            w.flag(self.ph_joint_cbcr_sign_flag)
        if sps.sps_sao_enabled_flag and pps.pps_sao_info_in_ph_flag:
            w.flag(self.ph_sao_luma_enabled_flag)
            if sps.sps_chroma_format_idc != 0:
                w.flag(self.ph_sao_chroma_enabled_flag)
        if pps.pps_dbf_info_in_ph_flag:
            w.flag(self.ph_deblocking_params_present_flag)
        if self.ph_deblocking_params_present_flag:
            if not pps.pps_deblocking_filter_disabled_flag:
                w.flag(self.ph_deblocking_filter_disabled_flag)
            if not self.ph_deblocking_filter_disabled_flag:
                w.se(self.ph_luma_beta_offset_div2)
                w.se(self.ph_luma_tc_offset_div2)
                assert not pps.pps_chroma_tool_offsets_present_flag

    def to_nal(self, sps: SPS, pps: PPS) -> bytes:
        """Standalone PH_NUT (7.3.2.8: picture_header_structure +
        rbsp_trailing_bits)."""
        from ..bitstream.bits import NAL_PH, make_nal

        w = BitWriter()
        self.write(w, sps, pps)
        w.rbsp_trailing_bits()
        return make_nal(NAL_PH, w.to_bytes())


@dataclass
class SliceHeader:
    nal_unit_type: int = 8  # IDR_N_LP
    sh_picture_header_in_slice_header_flag: int = 1
    ph: PictureHeader = field(default_factory=PictureHeader)
    sh_slice_address: int = 0
    sh_num_tiles_in_slice_minus1: int = 0
    sh_slice_type: int = 2  # I
    sh_no_output_of_prior_pics_flag: int = 0
    sh_alf_enabled_flag: int = 0
    sh_num_alf_aps_ids_luma: int = 0
    sh_alf_aps_id_luma: tuple = (0,) * 8
    sh_alf_cb_enabled_flag: int = 0
    sh_alf_cr_enabled_flag: int = 0
    sh_alf_aps_id_chroma: int = 0
    sh_alf_cc_cb_enabled_flag: int = 0
    sh_alf_cc_cb_aps_id: int = 0
    sh_alf_cc_cr_enabled_flag: int = 0
    sh_alf_cc_cr_aps_id: int = 0
    sh_lmcs_used_flag: int = 0
    sh_explicit_scaling_list_used_flag: int = 0
    sh_pred_weight_table: dict | None = None
    sh_num_ref_idx_active_override_flag: int = 0
    sh_num_ref_idx_active_minus1: tuple = (0, 0)
    sh_ref_pic_lists: tuple = None  # (RefPicListStruct, RefPicListStruct)
    sh_cabac_init_flag: int = 0
    sh_collocated_from_l0_flag: int = 1
    sh_collocated_ref_idx: int = 0
    sh_qp_delta: int = 0
    sh_cb_qp_offset: int = 0
    sh_cr_qp_offset: int = 0
    sh_joint_cbcr_qp_offset: int = 0
    sh_sao_luma_used_flag: int = 0
    sh_sao_chroma_used_flag: int = 0
    sh_deblocking_params_present_flag: int = 0
    sh_rpl_sps_idx: tuple = ()  # SPS-candidate rpl selection per list
    sh_deblocking_filter_disabled_flag: int = 0
    sh_luma_beta_offset_div2: int = 0
    sh_luma_tc_offset_div2: int = 0
    sh_dep_quant_used_flag: int = 0
    sh_sign_data_hiding_used_flag: int = 0
    sh_ts_residual_coding_disabled_flag: int = 0
    sh_entry_point_offsets: tuple = ()  # byte offsets (minus1 values written)

    def write(self, w: BitWriter, sps: SPS, pps: PPS,
              num_tiles_in_pic: int = 1, num_slices_in_pic: int = 1) -> None:
        from ..bitstream.bits import NAL_IDR_N_LP, NAL_IDR_W_RADL, NAL_CRA, NAL_GDR

        w.flag(self.sh_picture_header_in_slice_header_flag)
        if self.sh_picture_header_in_slice_header_flag:
            self.ph.write(w, sps, pps)
        ph = self.ph
        if (pps.pps_rect_slice_flag and num_slices_in_pic > 1) or \
           (not pps.pps_rect_slice_flag and num_tiles_in_pic > 1):
            if not pps.pps_rect_slice_flag:
                bits = ceil_log2(num_tiles_in_pic)
            else:
                bits = ceil_log2(num_slices_in_pic)
            w.u(bits, self.sh_slice_address)
        if not pps.pps_rect_slice_flag and \
                num_tiles_in_pic - self.sh_slice_address > 1:
            w.ue(self.sh_num_tiles_in_slice_minus1)
        if ph.ph_inter_slice_allowed_flag:
            w.ue(self.sh_slice_type)
        if self.nal_unit_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA, NAL_GDR):
            w.flag(self.sh_no_output_of_prior_pics_flag)
        if sps.sps_alf_enabled_flag and not pps.pps_alf_info_in_ph_flag:
            w.flag(self.sh_alf_enabled_flag)
            if self.sh_alf_enabled_flag:
                w.u(3, self.sh_num_alf_aps_ids_luma)
                for i in range(self.sh_num_alf_aps_ids_luma):
                    w.u(3, self.sh_alf_aps_id_luma[i])
                if sps.sps_chroma_format_idc:
                    w.flag(self.sh_alf_cb_enabled_flag)
                    w.flag(self.sh_alf_cr_enabled_flag)
                if self.sh_alf_cb_enabled_flag or self.sh_alf_cr_enabled_flag:
                    w.u(3, self.sh_alf_aps_id_chroma)
                if sps.sps_ccalf_enabled_flag:
                    w.flag(self.sh_alf_cc_cb_enabled_flag)
                    if self.sh_alf_cc_cb_enabled_flag:
                        w.u(3, self.sh_alf_cc_cb_aps_id)
                    w.flag(self.sh_alf_cc_cr_enabled_flag)
                    if self.sh_alf_cc_cr_enabled_flag:
                        w.u(3, self.sh_alf_cc_cr_aps_id)
        if not self.sh_picture_header_in_slice_header_flag:
            if ph.ph_lmcs_enabled_flag:
                w.flag(self.sh_lmcs_used_flag)
            if ph.ph_explicit_scaling_list_enabled_flag:
                w.flag(self.sh_explicit_scaling_list_used_flag)
        is_idr = self.nal_unit_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
        rpl = None
        if pps.pps_rpl_info_in_ph_flag:
            rpl = ph.ph_ref_pic_lists
        elif not is_idr or sps.sps_idr_rpl_present_flag:
            rpl = self.sh_ref_pic_lists or (RefPicListStruct(), RefPicListStruct())
            write_ref_pic_lists(w, sps, pps, rpl, self.sh_rpl_sps_idx)
        if rpl is None and self.sh_slice_type != 2:
            raise NotImplementedError("inter slices need rpl")
        num_ref_entries = [rpl[i].num_ref_entries if rpl else 0 for i in range(2)]
        if (self.sh_slice_type != 2 and num_ref_entries[0] > 1) or \
           (self.sh_slice_type == 0 and num_ref_entries[1] > 1):
            w.flag(self.sh_num_ref_idx_active_override_flag)
            if self.sh_num_ref_idx_active_override_flag:
                for i in range(2 if self.sh_slice_type == 0 else 1):
                    if num_ref_entries[i] > 1:
                        w.ue(self.sh_num_ref_idx_active_minus1[i])
        if self.sh_slice_type != 2:
            if pps.pps_cabac_init_present_flag:
                w.flag(self.sh_cabac_init_flag)
            if ph.ph_temporal_mvp_enabled_flag and not pps.pps_rpl_info_in_ph_flag:
                if self.sh_slice_type == 0:
                    w.flag(self.sh_collocated_from_l0_flag)
                na = self.num_ref_idx_active(pps, rpl)
                idx = 0 if self.sh_collocated_from_l0_flag else 1
                if na[idx] > 1:
                    w.ue(self.sh_collocated_ref_idx)
            na = self.num_ref_idx_active(pps, rpl)
            if (pps.pps_weighted_pred_flag and self.sh_slice_type == 1) or \
                    (pps.pps_weighted_bipred_flag and self.sh_slice_type == 0):
                # pred_weight_table (7.3.8); chroma flags for both
                # components share one flag per ref
                pwt = self.sh_pred_weight_table
                w.ue(pwt["luma_log2_weight_denom"])
                if sps.sps_chroma_format_idc:
                    w.se(pwt["delta_chroma_log2_weight_denom"])
                for lx in range(2):
                    if lx == 0:
                        n = na[0]
                    elif pps.pps_weighted_bipred_flag and \
                            num_ref_entries[1] > 0:
                        n = na[1]
                    else:
                        n = 0
                    lwf = pwt["luma_weight_flags"][lx]
                    cwf = pwt["chroma_weight_flags"][lx]
                    for i in range(n):
                        w.flag(lwf[i])
                    if sps.sps_chroma_format_idc:
                        for i in range(n):
                            w.flag(cwf[i])
                    for i in range(n):
                        if lwf[i]:
                            w.se(pwt["delta_luma_weights"][lx][i])
                            w.se(pwt["luma_offsets"][lx][i])
                        if cwf[i]:
                            for j in range(2):
                                w.se(pwt["delta_chroma_weights"][lx][i][j])
                                w.se(pwt["delta_chroma_offsets"][lx][i][j])
        if not pps.pps_qp_delta_info_in_ph_flag:
            w.se(self.sh_qp_delta)
        if pps.pps_slice_chroma_qp_offsets_present_flag:
            w.se(self.sh_cb_qp_offset)
            w.se(self.sh_cr_qp_offset)
            if sps.sps_joint_cbcr_enabled_flag:
                w.se(self.sh_joint_cbcr_qp_offset)
        if sps.sps_sao_enabled_flag and not pps.pps_sao_info_in_ph_flag:
            w.flag(self.sh_sao_luma_used_flag)
            if sps.sps_chroma_format_idc != 0:
                w.flag(self.sh_sao_chroma_used_flag)
        if pps.pps_deblocking_filter_override_enabled_flag and \
                not pps.pps_dbf_info_in_ph_flag:
            w.flag(self.sh_deblocking_params_present_flag)
        if self.sh_deblocking_params_present_flag:
            if not pps.pps_deblocking_filter_disabled_flag:
                w.flag(self.sh_deblocking_filter_disabled_flag)
            if not self.sh_deblocking_filter_disabled_flag:
                w.se(self.sh_luma_beta_offset_div2)
                w.se(self.sh_luma_tc_offset_div2)
                assert not pps.pps_chroma_tool_offsets_present_flag
        if sps.sps_dep_quant_enabled_flag:
            w.flag(self.sh_dep_quant_used_flag)
        if sps.sps_sign_data_hiding_enabled_flag and not self.sh_dep_quant_used_flag:
            w.flag(self.sh_sign_data_hiding_used_flag)
        if sps.sps_transform_skip_enabled_flag and \
                not self.sh_dep_quant_used_flag and \
                not self.sh_sign_data_hiding_used_flag:
            w.flag(self.sh_ts_residual_coding_disabled_flag)
        if sps.sps_entry_point_offsets_present_flag and self.sh_entry_point_offsets:
            offset_len = max(max(self.sh_entry_point_offsets).bit_length(), 1)
            w.ue(offset_len - 1)
            for off_minus1 in self.sh_entry_point_offsets:
                w.u(offset_len, off_minus1)
        # byte_alignment(): sh_alignment_bit_equal_to_one, then zeros
        w.u(1, 1)
        w.align_zero()

    def num_ref_idx_active(self, pps: PPS, rpl) -> list[int]:
        out = [0, 0]
        for i in range(2):
            if self.sh_slice_type == 0 or (self.sh_slice_type == 1 and i == 0):
                if self.sh_num_ref_idx_active_override_flag:
                    out[i] = self.sh_num_ref_idx_active_minus1[i] + 1
                else:
                    out[i] = min(rpl[i].num_ref_entries,
                                 pps.pps_num_ref_idx_default_active_minus1[i] + 1)
        return out
