// H.266 parameter set and slice header parsing (spec 7.3.2).
// Behavioural parity: cbs_h266_syntax_template.c:1054 (SPS), :1645 (PPS),
// :2593 (PH), :3011 (SH) — independent implementation.
//
// Branches for tools the framework does not yet reconstruct raise
// UnsupportedError so unsupported streams fail loudly, mirroring the
// reference's AVERROR_PATCHWELCOME discipline (vvc_ctu.c:1454 etc).
#pragma once

#include <cstdint>
#include <stdexcept>
#include <vector>

#include "bits.h"

namespace vvc {

struct UnsupportedError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

#define VVC_UNSUPPORTED(cond, what) \
  do { if (cond) throw UnsupportedError(what); } while (0)

struct RefPicListStruct {
  int num_ref_entries = 0;
  // per-entry: ST delta chain or long-term reference (spec 7.3.10;
  // inline rpl structs have ltrp_in_header inferred 1, so LT POC LSBs
  // and MSB cycles arrive in the ref_pic_lists() post-amble; SPS
  // structs carry an explicit ltrp_in_header_flag and, when 0, the
  // LT POC LSBs inline)
  int ltrp_in_header = 1;
  std::vector<int> abs_delta_poc_st;  // 0 for LT entries
  std::vector<int> sign;
  std::vector<int> is_lt;
  std::vector<int> lt_poc_lsb;     // per LT entry (j-indexed)
  std::vector<int> lt_msb_cycle;   // per LT entry; -1 = not present
  int num_lt() const {
    int n = 0;
    for (int v : is_lt) n += v;
    return n;
  }
};

struct Sps {
  int sps_seq_parameter_set_id = 0;
  int sps_chroma_format_idc = 1;
  int ctb_log2_size_y = 5;
  int sps_gdr_enabled_flag = 0;
  int width = 0;   // sps_pic_width_max_in_luma_samples
  int height = 0;
  int conf_win[4] = {0, 0, 0, 0};
  int bit_depth = 8;
  int sps_entropy_coding_sync_enabled_flag = 0;
  int sps_entry_point_offsets_present_flag = 0;
  int log2_max_poc_lsb = 8;
  int dpb_max_dec_pic_buffering = 8;
  int dpb_max_num_reorder_pics = 0;
  int min_cb_log2_size_y = 2;
  int sps_partition_constraints_override_enabled_flag = 0;
  int log2_diff_min_qt_min_cb_intra_luma = 0;
  int max_mtt_depth_intra_luma = 0;
  int log2_diff_max_bt_min_qt_intra_luma = 0;
  int log2_diff_max_tt_min_qt_intra_luma = 0;
  int sps_qtbtt_dual_tree_intra_flag = 0;
  int log2_diff_min_qt_min_cb_intra_chroma = 0;
  int max_mtt_depth_intra_chroma = 0;
  int log2_diff_max_bt_min_qt_intra_chroma = 0;
  int log2_diff_max_tt_min_qt_intra_chroma = 0;
  int log2_diff_min_qt_min_cb_inter = 0;
  int max_mtt_depth_inter = 0;
  int log2_diff_max_bt_min_qt_inter = 0;
  int log2_diff_max_tt_min_qt_inter = 0;
  int sps_max_luma_transform_size_64_flag = 0;
  int sps_transform_skip_enabled_flag = 0;
  int max_ts_size = 4;
  int sps_min_qp_prime_ts = 0;
  int sps_bdpcm_enabled_flag = 0;
  int sps_mts_enabled_flag = 0;
  int sps_explicit_mts_intra_enabled_flag = 0;
  int sps_explicit_mts_inter_enabled_flag = 0;
  int sps_lfnst_enabled_flag = 0;
  int sps_explicit_scaling_list_enabled_flag = 0;
  int sps_scaling_matrix_for_lfnst_disabled_flag = 0;
  int sps_joint_cbcr_enabled_flag = 0;
  int sps_same_qp_table_for_chroma_flag = 1;
  int8_t chroma_qp_table[3][112];  // [cb/cr/jcbcr][qp + qp_bd_offset]
  int sps_sao_enabled_flag = 0;
  int sps_alf_enabled_flag = 0;
  int sps_ccalf_enabled_flag = 0;
  int sps_lmcs_enabled_flag = 0;
  int sps_weighted_pred_flag = 0;
  int sps_weighted_bipred_flag = 0;
  int sps_long_term_ref_pics_flag = 0;
  int sps_idr_rpl_present_flag = 0;
  int sps_temporal_mvp_enabled_flag = 0;
  int sps_sbtmvp_enabled_flag = 0;
  int sps_amvr_enabled_flag = 0;
  int sps_bdof_enabled_flag = 0;
  int sps_smvd_enabled_flag = 0;
  int sps_dmvr_enabled_flag = 0;
  int sps_mmvd_enabled_flag = 0;
  int sps_mmvd_fullpel_only_flag = 0;
  int max_num_merge_cand = 6;
  int sps_sbt_enabled_flag = 0;
  int sps_affine_enabled_flag = 0;
  int sps_five_minus_max_num_subblock_merge_cand = 5;
  int sps_6param_affine_enabled_flag = 0;
  int sps_affine_amvr_enabled_flag = 0;
  int sps_affine_prof_enabled_flag = 0;
  int sps_prof_control_present_in_ph_flag = 0;
  int sps_bcw_enabled_flag = 0;
  int sps_ciip_enabled_flag = 0;
  int sps_gpm_enabled_flag = 0;
  int max_num_gpm_merge_cand = 0;
  int log2_parallel_merge_level = 2;
  int sps_isp_enabled_flag = 0;
  int sps_mrl_enabled_flag = 0;
  int sps_mip_enabled_flag = 0;
  int sps_cclm_enabled_flag = 0;
  int sps_chroma_horizontal_collocated_flag = 1;
  int sps_chroma_vertical_collocated_flag = 1;
  int sps_dep_quant_enabled_flag = 0;
  int sps_sign_data_hiding_enabled_flag = 0;
  int sps_ref_wraparound_enabled_flag = 0;
  // candidate ref pic list structs coded in the SPS (spec 7.3.10;
  // slices select one with rpl_sps_flag + rpl_idx)
  std::vector<RefPicListStruct> rpl_lists[2];

  // derived
  int qp_bd_offset = 0;
  int ctb_size_y = 32;
  int max_tb_size_y = 32;
  int hshift_c = 1, vshift_c = 1;
  int log2_transform_range = 15;

  int ctb_width(int pic_w) const {
    return (pic_w + ctb_size_y - 1) >> ctb_log2_size_y;
  }
};

struct Pps {
  int pps_pic_parameter_set_id = 0;
  int pps_seq_parameter_set_id = 0;
  int width = 0, height = 0;
  int conf_win[4] = {0, 0, 0, 0};  // SubWidthC/SubHeightC units
  int pps_no_pic_partition_flag = 1;
  int num_tile_columns = 1, num_tile_rows = 1;
  std::vector<int> col_width, row_height;  // in CTBs
  int pps_loop_filter_across_tiles_enabled_flag = 0;
  int pps_rect_slice_flag = 1;
  int pps_loop_filter_across_slices_enabled_flag = 0;
  int pps_cabac_init_present_flag = 0;
  int num_ref_idx_default_active[2] = {1, 1};
  int pps_rpl1_idx_present_flag = 0;
  int pps_weighted_pred_flag = 0;
  int pps_weighted_bipred_flag = 0;
  int pps_init_qp = 26;
  int pps_cu_qp_delta_enabled_flag = 0;
  int pps_chroma_tool_offsets_present_flag = 0;
  int chroma_qp_offset[3] = {0, 0, 0};  // cb, cr, jcbcr
  int pps_slice_chroma_qp_offsets_present_flag = 0;
  int pps_deblocking_filter_disabled_flag = 0;
  int pps_deblocking_filter_override_enabled_flag = 0;
  int pps_dbf_info_in_ph_flag = 0;
  int beta_offset[3] = {0, 0, 0};  // luma, cb, cr (div2 values *2)
  int tc_offset[3] = {0, 0, 0};
  int pps_rpl_info_in_ph_flag = 0;
  int pps_sao_info_in_ph_flag = 0;
  int pps_alf_info_in_ph_flag = 0;
  int pps_wp_info_in_ph_flag = 0;
  int pps_qp_delta_info_in_ph_flag = 0;
  // horizontal reference wraparound (360 video): offset in LUMA
  // samples (PpsRefWraparoundOffset * MinCbSizeY); 0 = disabled
  int ref_wraparound_offset = 0;

  // derived tile maps (in CTBs)
  std::vector<int> col_bd, row_bd;          // tile column/row start per tile idx
  std::vector<int> ctb_to_col_bd, ctb_to_row_bd;  // per-CTB tile boundary start
  // explicit rect-slice layout (tile-aligned): per-slice
  // (tile_x0, tile_y0, w_tiles, h_tiles); empty = raster slices or
  // the whole-picture rect slice
  struct SliceRect { int tx0, ty0, wt, ht; };
  std::vector<SliceRect> slice_rects;
};


// Adaptation parameter set (spec 7.3.2.5; reference cbs template aps()
// + lmcs_data()).  Only the LMCS payload is stored for now; ALF comes
// with the ALF stage.
struct Aps {
  int aps_params_type = -1;  // 0 ALF, 1 LMCS, 2 SCALING
  int id = 0;
  int chroma_present = 0;
  // lmcs_data: signed per-bin codeword deltas (lmcsCW[i] = OrgCw +
  // delta_cw[i] for coded bins), chroma residual scale delta
  int lmcs_min_bin_idx = 0;
  int lmcs_delta_max_bin_idx = 0;
  int lmcs_delta_cw[16] = {};
  int lmcs_delta_crs = 0;
  // alf_data, already derived to signed coefficients / clip indices
  // (alf_derive, vvc_ps.c:873-878): luma per class (delta_idx applied),
  // chroma per alternative, cc per component+filter
  int alf_luma_signal = 0;
  int alf_chroma_signal = 0;
  int alf_cc_signal[2] = {0, 0};
  int16_t alf_luma_coeff[25][12] = {};
  uint8_t alf_luma_clipidx[25][12] = {};
  int num_chroma_alts = 1;
  int16_t alf_chroma_coeff[8][6] = {};
  uint8_t alf_chroma_clipidx[8][6] = {};
  int num_cc_filters[2] = {1, 1};
  int16_t alf_cc_coeff[2][4][7] = {};
  // scaling_list_data, already derived to ScalingMatrixRec /
  // ScalingMatrixDcRec (scaling_derive, vvc_ps.c:903-960)
  uint8_t sl_rec[28][64] = {};
  uint8_t sl_dc_rec[14] = {};
};

struct PictureHeader {
  int ph_gdr_or_irap_pic_flag = 0;
  int ph_non_ref_pic_flag = 0;
  int ph_gdr_pic_flag = 0;
  int ph_inter_slice_allowed_flag = 0;
  int ph_intra_slice_allowed_flag = 1;
  int ph_pic_parameter_set_id = 0;
  int ph_pic_order_cnt_lsb = 0;
  int ph_recovery_poc_cnt = 0;
  int ph_pic_output_flag = 1;
  int ph_temporal_mvp_enabled_flag = 0;
  int ph_cu_qp_delta_subdiv_intra_slice = 0;
  int ph_cu_qp_delta_subdiv_inter_slice = 0;
  int ph_mmvd_fullpel_only_flag = 0;
  int ph_mvd_l1_zero_flag = 1;
  int ph_prof_disabled_flag = 1;
  int ph_qp_delta = 0;
  int ph_joint_cbcr_sign_flag = 0;
  int ph_lmcs_enabled_flag = 0;
  int ph_lmcs_aps_id = 0;
  int ph_chroma_residual_scale_flag = 0;
  int ph_explicit_scaling_list_enabled_flag = 0;
  int ph_scaling_list_aps_id = 0;
  int ph_sao_luma_enabled_flag = 0;
  int ph_sao_chroma_enabled_flag = 0;
  // RPL coded in the PH (pps_rpl_info_in_ph_flag); slices inherit
  int ph_rpl_present = 0;
  RefPicListStruct rpl[2];
  int ph_collocated_from_l0_flag = 1;
  int ph_collocated_ref_idx = 0;
  // ALF coded in the PH (pps_alf_info_in_ph_flag); slices inherit
  int ph_alf_enabled_flag = 0;
  int ph_num_alf_aps_ids_luma = 0;
  int ph_alf_aps_id_luma[8] = {};
  int ph_alf_cb_enabled_flag = 0;
  int ph_alf_cr_enabled_flag = 0;
  int ph_alf_aps_id_chroma = 0;
  int ph_alf_cc_cb_enabled_flag = 0;
  int ph_alf_cc_cb_aps_id = 0;
  int ph_alf_cc_cr_enabled_flag = 0;
  int ph_alf_cc_cr_aps_id = 0;
  // deblock params coded in the PH (pps_dbf_info_in_ph_flag)
  int ph_deblocking_filter_disabled_flag = 0;
  int beta_offset[3] = {0, 0, 0};  // effective (PH override or PPS)
  int tc_offset[3] = {0, 0, 0};
};

// explicit weighted prediction table, derived (pred_weight_table,
// vvc_ps.c:540-561): weight/offset per [list][luma/cb/cr][ref]
struct PredWeight {
  int log2_denom[2] = {0, 0};  // luma, chroma
  int nb_weights[2] = {0, 0};
  int weight_flag[2][3][16] = {};
  int weight[2][3][16] = {};
  int offset[2][3][16] = {};
};

struct SliceHeader {
  int nal_type = NAL_IDR_N_LP;
  int sh_picture_header_in_slice_header_flag = 1;
  PictureHeader ph;
  int sh_slice_address = 0;
  int sh_num_tiles_in_slice_minus1 = 0;
  int sh_slice_type = 2;  // I
  int sh_no_output_of_prior_pics_flag = 0;
  RefPicListStruct rpl[2];
  int num_ref_idx_active[2] = {0, 0};
  int sh_cabac_init_flag = 0;
  int sh_collocated_from_l0_flag = 1;
  int sh_collocated_ref_idx = 0;
  int slice_qp_y = 26;
  int sh_cb_qp_offset = 0, sh_cr_qp_offset = 0, sh_joint_cbcr_qp_offset = 0;
  int sh_alf_enabled_flag = 0;
  int sh_num_alf_aps_ids_luma = 0;
  int sh_alf_aps_id_luma[8] = {};
  int sh_alf_cb_enabled_flag = 0;
  int sh_alf_cr_enabled_flag = 0;
  int sh_alf_aps_id_chroma = 0;
  int sh_alf_cc_cb_enabled_flag = 0;
  int sh_alf_cc_cb_aps_id = 0;
  int sh_alf_cc_cr_enabled_flag = 0;
  int sh_alf_cc_cr_aps_id = 0;
  int sh_sao_luma_used_flag = 0;
  int sh_sao_chroma_used_flag = 0;
  int sh_deblocking_filter_disabled_flag = 0;
  int beta_offset[3] = {0, 0, 0};  // effective (SH override, PH, or PPS)
  int tc_offset[3] = {0, 0, 0};
  PredWeight pwt;
  int sh_dep_quant_used_flag = 0;
  int sh_sign_data_hiding_used_flag = 0;
  int sh_ts_residual_coding_disabled_flag = 0;
  int sh_ts_residual_coding_rice_idx_minus1 = 0;
  int sh_lmcs_used_flag = 0;  // inferred = ph_lmcs_enabled when PH in SH
  int sh_explicit_scaling_list_used_flag = 0;  // same inference rule
  std::vector<uint32_t> entry_point_offsets;
  size_t data_bitpos = 0;  // byte-aligned start of slice_data()
};

Sps parse_sps(BitReader& r);
Pps parse_pps(BitReader& r, const Sps& sps);
Aps parse_aps(BitReader& r);
// Standalone PH_NUT parse (spec 7.3.2.8; parity: cbs reads the same
// picture_header_structure the in-slice path does).
PictureHeader parse_picture_header_nal(BitReader& r, const Sps& sps,
                                       const Pps& pps);
// ext_ph: the active picture header from a preceding PH NAL, used when
// sh_picture_header_in_slice_header_flag == 0.
SliceHeader parse_slice_header(BitReader& r, int nal_type, const Sps& sps,
                               const Pps& pps,
                               const PictureHeader* ext_ph = nullptr);

}  // namespace vvc
