// SPS/PPS/PH/SH parsing.  See headers.h for parity citations.
#include "headers.h"

namespace vvc {
namespace {

int clip(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

int ceil_log2(int x) {
  int n = 0;
  while ((1 << n) < x) n++;
  return n;
}

void skip_profile_tier_level(BitReader& r, int profile_present,
                             int max_sublayers_minus1) {
  if (profile_present) {
    r.u(7);  // general_profile_idc
    r.flag();  // general_tier_flag
  }
  r.u(8);  // general_level_idc
  r.flag();  // ptl_frame_only_constraint_flag
  r.flag();  // ptl_multilayer_enabled_flag
  if (profile_present) {
    int gci_present = r.flag();
    VVC_UNSUPPORTED(gci_present, "general_constraints_info");
    r.byte_align();
  }
  std::vector<int> sublayer_present;
  for (int i = max_sublayers_minus1 - 1; i >= 0; i--)
    sublayer_present.push_back(r.flag());
  r.byte_align();
  for (int p : sublayer_present)
    if (p) r.u(8);
  if (profile_present) {
    int num_sub_profiles = r.u(8);
    for (int i = 0; i < num_sub_profiles; i++) r.u(32);
  }
}

void derive_chroma_qp_table(Sps& sps, int num_tables, int same_for_all,
                            const int start_minus26[3],
                            const std::vector<std::pair<int, int>> points[3]) {
  // parity: vvc_ps.c:86-125 (spec 7.4.3.4)
  int off = sps.qp_bd_offset;
  for (int i = 0; i < num_tables; i++) {
    int n = (int)points[i].size();
    std::vector<int> qp_in(n + 1), qp_out(n + 1), delta_in(n);
    qp_in[0] = qp_out[0] = start_minus26[i] + 26;
    for (int j = 0; j < n; j++) {
      delta_in[j] = points[i][j].first + 1;
      qp_in[j + 1] = qp_in[j] + delta_in[j];
      qp_out[j + 1] = qp_out[j] + (points[i][j].first ^ points[i][j].second);
    }
    int8_t* tab = sps.chroma_qp_table[i];
    tab[qp_in[0] + off] = (int8_t)qp_out[0];
    for (int k = qp_in[0] - 1 + off; k >= 0; k--)
      tab[k] = (int8_t)clip(tab[k + 1] - 1, -off, 63);
    for (int j = 0; j < n; j++) {
      int sh = delta_in[j] >> 1;
      for (int k = qp_in[j] + 1 + off, m = 1; k <= qp_in[j + 1] + off; k++, m++)
        tab[k] = (int8_t)(tab[qp_in[j] + off] +
                          ((qp_out[j + 1] - qp_out[j]) * m + sh) / delta_in[j]);
    }
    for (int k = qp_in[n] + 1 + off; k <= 63 + off; k++)
      tab[k] = (int8_t)clip(tab[k - 1] + 1, -off, 63);
  }
  if (same_for_all) {
    for (int k = 0; k < 112; k++) {
      sps.chroma_qp_table[1][k] = sps.chroma_qp_table[0][k];
      sps.chroma_qp_table[2][k] = sps.chroma_qp_table[0][k];
    }
  }
}

void parse_rpl_struct(BitReader& r, const Sps& sps, RefPicListStruct& rpl,
                      bool in_sps) {
  rpl.num_ref_entries = r.ue();
  // inline rpl structs (rplsIdx == sps_num_ref_pic_lists) have
  // ltrp_in_header_flag inferred 1, so LT POC info follows in the
  // ref_pic_lists() post-amble (cbs_h266_syntax_template.c:445-450);
  // SPS structs carry the flag explicitly and, when 0, the LT POC
  // LSBs inline (rpls_poc_lsb_lt)
  rpl.ltrp_in_header = 1;
  if (in_sps && sps.sps_long_term_ref_pics_flag && rpl.num_ref_entries > 0)
    rpl.ltrp_in_header = r.flag();
  int wp = sps.sps_weighted_pred_flag || sps.sps_weighted_bipred_flag;
  for (int i = 0; i < rpl.num_ref_entries; i++) {
    int is_st = 1;
    if (sps.sps_long_term_ref_pics_flag) is_st = r.flag();
    rpl.is_lt.push_back(!is_st);
    if (is_st) {
      int coded = r.ue();
      int abs_delta = (wp && i != 0) ? coded : coded + 1;
      int sign = 0;
      if (abs_delta > 0) sign = r.flag();
      rpl.abs_delta_poc_st.push_back(abs_delta);
      rpl.sign.push_back(sign);
    } else {
      rpl.abs_delta_poc_st.push_back(0);
      rpl.sign.push_back(0);
      if (!rpl.ltrp_in_header)
        rpl.lt_poc_lsb.push_back((int)r.u(sps.log2_max_poc_lsb));
    }
  }
}

// LT post-amble of ref_pic_lists() (spec 7.3.9): per LT entry the POC
// LSB (inline structs only) and the optional MSB cycle
void parse_rpl_lt_info(BitReader& r, const Sps& sps, RefPicListStruct& rpl) {
  for (int j = 0; j < rpl.num_lt(); j++) {
    // SPS structs with ltrp_in_header == 0 already carry the LSBs
    if (rpl.ltrp_in_header)
      rpl.lt_poc_lsb.push_back(r.u(sps.log2_max_poc_lsb));
    if (r.flag()) {
      rpl.lt_msb_cycle.push_back((int)r.ue());
    } else {
      // without the MSB cycle the LT picture resolves by LSB match
      // against the DPB (add_candidate_ref use_msb=0) — the parser
      // computes full POCs up front, so require the cycle
      VVC_UNSUPPORTED(1, "LT ref without delta_poc_msb_cycle");
    }
  }
}

// ref_pic_lists() (spec 7.3.9): per list either select an SPS struct
// (rpl_sps_flag + rpl_idx) or parse one inline, then the LT post-amble
void parse_ref_pic_lists(BitReader& r, const Sps& sps, const Pps& pps,
                         RefPicListStruct* rpl) {
  int sps_flag[2] = {0, 0};
  int idx[2] = {0, 0};
  for (int i = 0; i < 2; i++) {
    const int n = (int)sps.rpl_lists[i].size();
    if (n > 0 && (i == 0 || pps.pps_rpl1_idx_present_flag))
      sps_flag[i] = r.flag();
    else
      sps_flag[i] = n == 0 ? 0 : sps_flag[0];
    if (sps_flag[i]) {
      if (n > 1 && (i == 0 || pps.pps_rpl1_idx_present_flag)) {
        idx[i] = (int)r.u(ceil_log2(n));
      } else {
        idx[i] = (i == 1 && !pps.pps_rpl1_idx_present_flag) ? idx[0] : 0;
      }
      VVC_UNSUPPORTED(idx[i] >= n, "rpl_idx out of range");
      rpl[i] = sps.rpl_lists[i][idx[i]];
    } else {
      rpl[i] = RefPicListStruct();
      parse_rpl_struct(r, sps, rpl[i], /*in_sps=*/false);
    }
    parse_rpl_lt_info(r, sps, rpl[i]);
  }
}

}  // namespace

Sps parse_sps(BitReader& r) {
  Sps sps;
  sps.sps_seq_parameter_set_id = r.u(4);
  int vps_id = r.u(4);
  VVC_UNSUPPORTED(vps_id != 0, "VPS");
  int max_sublayers_minus1 = r.u(3);
  VVC_UNSUPPORTED(max_sublayers_minus1 != 0, "sublayers");
  sps.sps_chroma_format_idc = r.u(2);
  sps.ctb_log2_size_y = r.u(2) + 5;
  sps.ctb_size_y = 1 << sps.ctb_log2_size_y;
  int ptl_present = r.flag();
  if (ptl_present) skip_profile_tier_level(r, 1, max_sublayers_minus1);
  sps.sps_gdr_enabled_flag = r.flag();
  int ref_pic_resampling = r.flag();
  VVC_UNSUPPORTED(ref_pic_resampling, "reference picture resampling");
  sps.width = r.ue();
  sps.height = r.ue();
  if (r.flag()) {  // conformance window
    for (int i = 0; i < 4; i++) sps.conf_win[i] = r.ue();
  }
  int subpic_info = r.flag();
  VVC_UNSUPPORTED(subpic_info, "subpictures");
  sps.bit_depth = r.ue() + 8;
  sps.qp_bd_offset = 6 * (sps.bit_depth - 8);
  sps.sps_entropy_coding_sync_enabled_flag = r.flag();
  sps.sps_entry_point_offsets_present_flag = r.flag();
  sps.log2_max_poc_lsb = r.u(4) + 4;
  int poc_msb_cycle = r.flag();
  VVC_UNSUPPORTED(poc_msb_cycle, "poc msb cycle");
  int extra_ph = r.u(2), extra_sh = r.u(2);
  VVC_UNSUPPORTED(extra_ph || extra_sh, "extra ph/sh bits");
  if (ptl_present) {
    sps.dpb_max_dec_pic_buffering = r.ue() + 1;
    sps.dpb_max_num_reorder_pics = r.ue();
    r.ue();  // dpb_max_latency_increase_plus1
  }
  sps.min_cb_log2_size_y = r.ue() + 2;
  sps.sps_partition_constraints_override_enabled_flag = r.flag();
  sps.log2_diff_min_qt_min_cb_intra_luma = r.ue();
  sps.max_mtt_depth_intra_luma = r.ue();
  if (sps.max_mtt_depth_intra_luma) {
    sps.log2_diff_max_bt_min_qt_intra_luma = r.ue();
    sps.log2_diff_max_tt_min_qt_intra_luma = r.ue();
  }
  if (sps.sps_chroma_format_idc != 0) sps.sps_qtbtt_dual_tree_intra_flag = r.flag();
  if (sps.sps_qtbtt_dual_tree_intra_flag) {
    sps.log2_diff_min_qt_min_cb_intra_chroma = r.ue();
    sps.max_mtt_depth_intra_chroma = r.ue();
    if (sps.max_mtt_depth_intra_chroma) {
      sps.log2_diff_max_bt_min_qt_intra_chroma = r.ue();
      sps.log2_diff_max_tt_min_qt_intra_chroma = r.ue();
    }
  }
  sps.log2_diff_min_qt_min_cb_inter = r.ue();
  sps.max_mtt_depth_inter = r.ue();
  if (sps.max_mtt_depth_inter) {
    sps.log2_diff_max_bt_min_qt_inter = r.ue();
    sps.log2_diff_max_tt_min_qt_inter = r.ue();
  }
  if (sps.ctb_size_y > 32) sps.sps_max_luma_transform_size_64_flag = r.flag();
  sps.max_tb_size_y = sps.sps_max_luma_transform_size_64_flag ? 64 : 32;
  sps.sps_transform_skip_enabled_flag = r.flag();
  if (sps.sps_transform_skip_enabled_flag) {
    sps.max_ts_size = 1 << (r.ue() + 2);
    sps.sps_bdpcm_enabled_flag = r.flag();
  }
  sps.sps_mts_enabled_flag = r.flag();
  if (sps.sps_mts_enabled_flag) {
    sps.sps_explicit_mts_intra_enabled_flag = r.flag();
    sps.sps_explicit_mts_inter_enabled_flag = r.flag();
  }
  sps.sps_lfnst_enabled_flag = r.flag();
  if (sps.sps_chroma_format_idc != 0) {
    sps.sps_joint_cbcr_enabled_flag = r.flag();
    sps.sps_same_qp_table_for_chroma_flag = r.flag();
    int num_tables = sps.sps_same_qp_table_for_chroma_flag
                         ? 1
                         : (sps.sps_joint_cbcr_enabled_flag ? 3 : 2);
    int start_minus26[3] = {0, 0, 0};
    std::vector<std::pair<int, int>> points[3];
    for (int i = 0; i < num_tables; i++) {
      start_minus26[i] = r.se();
      int n = r.ue() + 1;
      for (int j = 0; j < n; j++) {
        int in_minus1 = r.ue();
        int diff = r.ue();
        points[i].push_back({in_minus1, diff});
      }
    }
    derive_chroma_qp_table(sps, num_tables,
                           sps.sps_same_qp_table_for_chroma_flag,
                           start_minus26, points);
  }
  sps.sps_sao_enabled_flag = r.flag();
  sps.sps_alf_enabled_flag = r.flag();
  if (sps.sps_alf_enabled_flag && sps.sps_chroma_format_idc)
    sps.sps_ccalf_enabled_flag = r.flag();
  sps.sps_lmcs_enabled_flag = r.flag();
  sps.sps_weighted_pred_flag = r.flag();
  sps.sps_weighted_bipred_flag = r.flag();
  sps.sps_long_term_ref_pics_flag = r.flag();
  sps.sps_idr_rpl_present_flag = r.flag();
  int rpl1_same = r.flag();
  for (int i = 0; i < (rpl1_same ? 1 : 2); i++) {
    int num_lists = r.ue();
    VVC_UNSUPPORTED(num_lists > 64, "sps_num_ref_pic_lists > 64");
    for (int k = 0; k < num_lists; k++) {
      RefPicListStruct st;
      parse_rpl_struct(r, sps, st, /*in_sps=*/true);
      sps.rpl_lists[i].push_back(st);
    }
  }
  if (rpl1_same) sps.rpl_lists[1] = sps.rpl_lists[0];
  sps.sps_ref_wraparound_enabled_flag = r.flag();
  sps.sps_temporal_mvp_enabled_flag = r.flag();
  if (sps.sps_temporal_mvp_enabled_flag) sps.sps_sbtmvp_enabled_flag = r.flag();
  sps.sps_amvr_enabled_flag = r.flag();
  sps.sps_bdof_enabled_flag = r.flag();
  if (sps.sps_bdof_enabled_flag)
    VVC_UNSUPPORTED(r.flag(), "bdof control in ph");
  sps.sps_smvd_enabled_flag = r.flag();
  sps.sps_dmvr_enabled_flag = r.flag();
  if (sps.sps_dmvr_enabled_flag)
    VVC_UNSUPPORTED(r.flag(), "dmvr control in ph");
  sps.sps_mmvd_enabled_flag = r.flag();
  if (sps.sps_mmvd_enabled_flag)
    sps.sps_mmvd_fullpel_only_flag = r.flag();
  sps.max_num_merge_cand = 6 - r.ue();
  sps.sps_sbt_enabled_flag = r.flag();
  sps.sps_affine_enabled_flag = r.flag();
  if (sps.sps_affine_enabled_flag) {
    sps.sps_five_minus_max_num_subblock_merge_cand = (int)r.ue();
    sps.sps_6param_affine_enabled_flag = r.flag();
    if (sps.sps_amvr_enabled_flag)
      sps.sps_affine_amvr_enabled_flag = r.flag();
    sps.sps_affine_prof_enabled_flag = r.flag();
    if (sps.sps_affine_prof_enabled_flag)
      sps.sps_prof_control_present_in_ph_flag = r.flag();
  }
  sps.sps_bcw_enabled_flag = r.flag();
  sps.sps_ciip_enabled_flag = r.flag();
  if (sps.max_num_merge_cand >= 2) {
    sps.sps_gpm_enabled_flag = r.flag();
    sps.max_num_gpm_merge_cand = 2;
    if (sps.sps_gpm_enabled_flag && sps.max_num_merge_cand >= 3)
      sps.max_num_gpm_merge_cand =
          sps.max_num_merge_cand - (int)r.ue();
  }
  sps.log2_parallel_merge_level = r.ue() + 2;
  sps.sps_isp_enabled_flag = r.flag();
  sps.sps_mrl_enabled_flag = r.flag();
  sps.sps_mip_enabled_flag = r.flag();
  if (sps.sps_chroma_format_idc != 0) sps.sps_cclm_enabled_flag = r.flag();
  if (sps.sps_chroma_format_idc == 1) {
    sps.sps_chroma_horizontal_collocated_flag = r.flag();
    sps.sps_chroma_vertical_collocated_flag = r.flag();
  }
  VVC_UNSUPPORTED(r.flag(), "palette");
  if (sps.sps_chroma_format_idc == 3 && !sps.sps_max_luma_transform_size_64_flag)
    VVC_UNSUPPORTED(r.flag(), "ACT");
  if (sps.sps_transform_skip_enabled_flag) sps.sps_min_qp_prime_ts = r.ue();
  VVC_UNSUPPORTED(r.flag(), "IBC");
  VVC_UNSUPPORTED(r.flag(), "LADF");
  // explicit scaling lists (7.4.3.4; consumed via derive_scale_m)
  sps.sps_explicit_scaling_list_enabled_flag = r.flag();
  if (sps.sps_lfnst_enabled_flag &&
      sps.sps_explicit_scaling_list_enabled_flag)
    sps.sps_scaling_matrix_for_lfnst_disabled_flag = r.flag();
  // ACT is unsupported above -> the alternative-colour-space branch
  // never parses
  sps.sps_dep_quant_enabled_flag = r.flag();
  sps.sps_sign_data_hiding_enabled_flag = r.flag();
  VVC_UNSUPPORTED(r.flag(), "virtual boundaries");
  if (ptl_present) VVC_UNSUPPORTED(r.flag(), "timing/hrd");
  r.flag();  // field_seq
  VVC_UNSUPPORTED(r.flag(), "VUI payload");
  VVC_UNSUPPORTED(r.flag(), "sps extensions");

  sps.hshift_c = (sps.sps_chroma_format_idc == 1 || sps.sps_chroma_format_idc == 2) ? 1 : 0;
  sps.vshift_c = sps.sps_chroma_format_idc == 1 ? 1 : 0;
  sps.log2_transform_range = 15;
  return sps;
}

Pps parse_pps(BitReader& r, const Sps& sps) {
  Pps pps;
  pps.pps_pic_parameter_set_id = r.u(6);
  pps.pps_seq_parameter_set_id = r.u(4);
  r.flag();  // mixed_nalu_types
  pps.width = r.ue();
  pps.height = r.ue();
  // conformance window (7.4.3.5): offsets in SubWidthC/SubHeightC
  // units; when the PPS size equals the SPS max size the SPS window
  // applies instead (the flag is then constrained to 0)
  if (r.flag()) {
    for (int i = 0; i < 4; i++) pps.conf_win[i] = r.ue();
  } else if (pps.width == sps.width && pps.height == sps.height) {
    for (int i = 0; i < 4; i++) pps.conf_win[i] = sps.conf_win[i];
  }
  VVC_UNSUPPORTED(r.flag(), "scaling window");
  int output_flag_present = r.flag();
  VVC_UNSUPPORTED(output_flag_present, "pps_output_flag_present");
  pps.pps_no_pic_partition_flag = r.flag();
  VVC_UNSUPPORTED(r.flag(), "pps subpic id mapping");

  int pic_w_ctbs = (pps.width + sps.ctb_size_y - 1) >> sps.ctb_log2_size_y;
  int pic_h_ctbs = (pps.height + sps.ctb_size_y - 1) >> sps.ctb_log2_size_y;
  if (!pps.pps_no_pic_partition_flag) {
    r.u(2);  // pps_log2_ctu_size_minus5 (must equal sps)
    int n_exp_cols = r.ue() + 1;
    int n_exp_rows = r.ue() + 1;
    std::vector<int> exp_cols(n_exp_cols), exp_rows(n_exp_rows);
    for (int i = 0; i < n_exp_cols; i++) exp_cols[i] = r.ue() + 1;
    for (int i = 0; i < n_exp_rows; i++) exp_rows[i] = r.ue() + 1;
    // expand to full partition (spec 6.5.1)
    auto expand = [](const std::vector<int>& exp, int total) {
      std::vector<int> sizes;
      int rem = total;
      for (int v : exp) {
        sizes.push_back(v);
        rem -= v;
      }
      int unified = exp.back();
      while (rem > 0) {
        int s = unified < rem ? unified : rem;
        sizes.push_back(s);
        rem -= s;
      }
      return sizes;
    };
    pps.col_width = expand(exp_cols, pic_w_ctbs);
    pps.row_height = expand(exp_rows, pic_h_ctbs);
    pps.num_tile_columns = (int)pps.col_width.size();
    pps.num_tile_rows = (int)pps.row_height.size();
    int num_tiles = pps.num_tile_columns * pps.num_tile_rows;
    if (num_tiles > 1) {
      pps.pps_loop_filter_across_tiles_enabled_flag = r.flag();
      pps.pps_rect_slice_flag = r.flag();
    }
    int single_slice_per_subpic = 1;
    if (pps.pps_rect_slice_flag) single_slice_per_subpic = r.flag();
    if (pps.pps_rect_slice_flag && !single_slice_per_subpic) {
      // explicit tile-aligned rect slice layout (spec 6.5.1 /
      // vvc_ps.c:254-455).  Sub-tile slices (pps_num_exp_slices_in_
      // tile) stay unsupported.
      const int n_cols = pps.num_tile_columns;
      const int n_rows = pps.num_tile_rows;
      int n_slices = (int)r.ue() + 1;
      // pps_tile_idx_delta_present_flag present only when
      // pps_num_slices_in_pic_minus1 > 1 (7.3.2.4)
      int delta_present = n_slices > 2 ? (int)r.flag() : 0;
      int tile_idx = 0;
      int prev_h = n_rows;  // height inference chain
      for (int i = 0; i < n_slices; i++) {
        const int tx = tile_idx % n_cols, ty = tile_idx / n_cols;
        int wt = 1, ht = 1;
        if (i < n_slices - 1) {
          wt = tx < n_cols - 1 ? (int)r.ue() + 1 : 1;
          if (ty < n_rows - 1 && (delta_present || tx == 0))
            ht = (int)r.ue() + 1;
          else if (ty == n_rows - 1)
            ht = 1;
          else
            ht = prev_h;  // inferred: previous slice's height
        } else {
          // last slice: covers the remaining rectangle
          wt = n_cols - tx;
          ht = n_rows - ty;
        }
        prev_h = ht;
        // the syntax loop runs i < num_slices-1: the last slice never
        // carries sub-tile syntax
        if (i < n_slices - 1 && wt == 1 && ht == 1 &&
            pps.row_height[ty] > 1) {
          int n_exp = (int)r.ue();
          VVC_UNSUPPORTED(n_exp != 0, "sub-tile rect slices");
        }
        pps.slice_rects.push_back({tx, ty, wt, ht});
        if (i < n_slices - 1) {
          if (delta_present) {
            tile_idx += (int)r.se();
            VVC_UNSUPPORTED(tile_idx < 0 || tile_idx >= n_cols * n_rows,
                            "tile_idx_delta out of range");
          } else {
            tile_idx += wt;
            if (tile_idx % n_cols == 0) tile_idx += (ht - 1) * n_cols;
          }
        }
      }
    }
    pps.pps_loop_filter_across_slices_enabled_flag = r.flag();
  } else {
    pps.col_width = {pic_w_ctbs};
    pps.row_height = {pic_h_ctbs};
  }
  // derived tile maps (parity: vvc_ps.c:254-455)
  pps.col_bd.clear();
  pps.row_bd.clear();
  int acc = 0;
  for (int w : pps.col_width) {
    pps.col_bd.push_back(acc);
    acc += w;
  }
  pps.col_bd.push_back(acc);
  acc = 0;
  for (int h : pps.row_height) {
    pps.row_bd.push_back(acc);
    acc += h;
  }
  pps.row_bd.push_back(acc);
  pps.ctb_to_col_bd.assign(pic_w_ctbs + 1, 0);
  pps.ctb_to_row_bd.assign(pic_h_ctbs + 1, 0);
  {
    int tile = 0, bd = 0;
    for (int i = 0; i <= pic_w_ctbs; i++) {
      if (tile < (int)pps.col_width.size() && i == pps.col_bd[tile + 1]) {
        tile++;
        bd = pps.col_bd[tile];
      }
      pps.ctb_to_col_bd[i] = bd;
    }
    tile = 0;
    bd = 0;
    for (int i = 0; i <= pic_h_ctbs; i++) {
      if (tile < (int)pps.row_height.size() && i == pps.row_bd[tile + 1]) {
        tile++;
        bd = pps.row_bd[tile];
      }
      pps.ctb_to_row_bd[i] = bd;
    }
  }

  pps.pps_cabac_init_present_flag = r.flag();
  for (int i = 0; i < 2; i++) pps.num_ref_idx_default_active[i] = r.ue() + 1;
  pps.pps_rpl1_idx_present_flag = r.flag();
  pps.pps_weighted_pred_flag = r.flag();
  pps.pps_weighted_bipred_flag = r.flag();
  if (r.flag()) {  // pps_ref_wraparound_enabled_flag
    VVC_UNSUPPORTED(!sps.sps_ref_wraparound_enabled_flag,
                    "pps wraparound without the sps flag");
    const int min_cb = 1 << sps.min_cb_log2_size_y;
    int minus_off = (int)r.ue();
    // PpsRefWraparoundOffset = pic_w / MinCb - pps_pic_width_minus_
    // wraparound_offset (7.4.3.4); stored in luma samples
    pps.ref_wraparound_offset =
        (pps.width / min_cb - minus_off) * min_cb;
  }
  pps.pps_init_qp = 26 + r.se();
  pps.pps_cu_qp_delta_enabled_flag = r.flag();
  pps.pps_chroma_tool_offsets_present_flag = r.flag();
  if (pps.pps_chroma_tool_offsets_present_flag) {
    pps.chroma_qp_offset[0] = r.se();
    pps.chroma_qp_offset[1] = r.se();
    if (r.flag()) pps.chroma_qp_offset[2] = r.se();
    pps.pps_slice_chroma_qp_offsets_present_flag = r.flag();
    VVC_UNSUPPORTED(r.flag(), "cu chroma qp offset list");
  }
  int dbf_control = r.flag();
  if (dbf_control) {
    pps.pps_deblocking_filter_override_enabled_flag = r.flag();
    pps.pps_deblocking_filter_disabled_flag = r.flag();
    if (!pps.pps_no_pic_partition_flag &&
        pps.pps_deblocking_filter_override_enabled_flag)
      pps.pps_dbf_info_in_ph_flag = r.flag();
    if (!pps.pps_deblocking_filter_disabled_flag) {
      pps.beta_offset[0] = r.se() * 2;
      pps.tc_offset[0] = r.se() * 2;
      if (pps.pps_chroma_tool_offsets_present_flag) {
        pps.beta_offset[1] = r.se() * 2;
        pps.tc_offset[1] = r.se() * 2;
        pps.beta_offset[2] = r.se() * 2;
        pps.tc_offset[2] = r.se() * 2;
      } else {
        pps.beta_offset[1] = pps.beta_offset[2] = pps.beta_offset[0];
        pps.tc_offset[1] = pps.tc_offset[2] = pps.tc_offset[0];
      }
    }
  }
  if (!pps.pps_no_pic_partition_flag) {
    pps.pps_rpl_info_in_ph_flag = r.flag();
    pps.pps_sao_info_in_ph_flag = r.flag();
    pps.pps_alf_info_in_ph_flag = r.flag();
    pps.pps_qp_delta_info_in_ph_flag = r.flag();
  }
  VVC_UNSUPPORTED(r.flag(), "ph extension");
  VVC_UNSUPPORTED(r.flag(), "sh extension");
  VVC_UNSUPPORTED(r.flag(), "pps extension");
  return pps;
}

static PictureHeader parse_picture_header(BitReader& r, const Sps& sps,
                                          const Pps& pps) {
  PictureHeader ph;
  ph.ph_gdr_or_irap_pic_flag = r.flag();
  ph.ph_non_ref_pic_flag = r.flag();
  if (ph.ph_gdr_or_irap_pic_flag) ph.ph_gdr_pic_flag = r.flag();
  ph.ph_inter_slice_allowed_flag = r.flag();
  if (ph.ph_inter_slice_allowed_flag)
    ph.ph_intra_slice_allowed_flag = r.flag();
  ph.ph_pic_parameter_set_id = r.ue();
  ph.ph_pic_order_cnt_lsb = r.u(sps.log2_max_poc_lsb);
  if (ph.ph_gdr_pic_flag) ph.ph_recovery_poc_cnt = r.ue();
  if (sps.sps_alf_enabled_flag && pps.pps_alf_info_in_ph_flag) {
    // ALF coded once in the PH; slices inherit (spec 7.3.2.8)
    ph.ph_alf_enabled_flag = r.flag();
    if (ph.ph_alf_enabled_flag) {
      ph.ph_num_alf_aps_ids_luma = r.u(3);
      for (int i = 0; i < ph.ph_num_alf_aps_ids_luma; i++)
        ph.ph_alf_aps_id_luma[i] = r.u(3);
      if (sps.sps_chroma_format_idc) {
        ph.ph_alf_cb_enabled_flag = r.flag();
        ph.ph_alf_cr_enabled_flag = r.flag();
      }
      if (ph.ph_alf_cb_enabled_flag || ph.ph_alf_cr_enabled_flag)
        ph.ph_alf_aps_id_chroma = r.u(3);
      if (sps.sps_ccalf_enabled_flag) {
        ph.ph_alf_cc_cb_enabled_flag = r.flag();
        if (ph.ph_alf_cc_cb_enabled_flag)
          ph.ph_alf_cc_cb_aps_id = r.u(3);
        ph.ph_alf_cc_cr_enabled_flag = r.flag();
        if (ph.ph_alf_cc_cr_enabled_flag)
          ph.ph_alf_cc_cr_aps_id = r.u(3);
      }
    }
  }
  if (sps.sps_lmcs_enabled_flag) {
    ph.ph_lmcs_enabled_flag = r.flag();
    if (ph.ph_lmcs_enabled_flag) {
      ph.ph_lmcs_aps_id = r.u(2);
      if (sps.sps_chroma_format_idc)
        ph.ph_chroma_residual_scale_flag = r.flag();
    }
  }
  if (sps.sps_explicit_scaling_list_enabled_flag) {
    ph.ph_explicit_scaling_list_enabled_flag = r.flag();
    if (ph.ph_explicit_scaling_list_enabled_flag)
      ph.ph_scaling_list_aps_id = r.u(3);
  }
  if (pps.pps_rpl_info_in_ph_flag) {
    ph.ph_rpl_present = 1;
    parse_ref_pic_lists(r, sps, pps, ph.rpl);
  }
  if (sps.sps_partition_constraints_override_enabled_flag)
    VVC_UNSUPPORTED(r.flag(), "partition constraints override");
  if (ph.ph_intra_slice_allowed_flag && pps.pps_cu_qp_delta_enabled_flag)
    ph.ph_cu_qp_delta_subdiv_intra_slice = r.ue();
  if (ph.ph_inter_slice_allowed_flag) {
    if (pps.pps_cu_qp_delta_enabled_flag)
      ph.ph_cu_qp_delta_subdiv_inter_slice = r.ue();
    if (sps.sps_temporal_mvp_enabled_flag) {
      ph.ph_temporal_mvp_enabled_flag = r.flag();
      if (ph.ph_temporal_mvp_enabled_flag && pps.pps_rpl_info_in_ph_flag) {
        // collocated picture selection lives in the PH when the RPL
        // does (spec 7.3.2.8)
        ph.ph_collocated_from_l0_flag =
            ph.rpl[1].num_ref_entries > 0 ? (int)r.flag() : 1;
        const int nsel = ph.ph_collocated_from_l0_flag
                             ? ph.rpl[0].num_ref_entries
                             : ph.rpl[1].num_ref_entries;
        if (nsel > 1) ph.ph_collocated_ref_idx = (int)r.ue();
      }
    }
    if (sps.sps_mmvd_fullpel_only_flag)
      ph.ph_mmvd_fullpel_only_flag = r.flag();
    if (!pps.pps_rpl_info_in_ph_flag || ph.rpl[1].num_ref_entries > 0)
      ph.ph_mvd_l1_zero_flag = r.flag();
    if (sps.sps_prof_control_present_in_ph_flag)
      ph.ph_prof_disabled_flag = r.flag();
    else
      ph.ph_prof_disabled_flag = !sps.sps_affine_prof_enabled_flag;
  }
  if (pps.pps_qp_delta_info_in_ph_flag) ph.ph_qp_delta = r.se();
  if (sps.sps_joint_cbcr_enabled_flag) ph.ph_joint_cbcr_sign_flag = r.flag();
  if (sps.sps_sao_enabled_flag && pps.pps_sao_info_in_ph_flag) {
    ph.ph_sao_luma_enabled_flag = r.flag();
    if (sps.sps_chroma_format_idc) ph.ph_sao_chroma_enabled_flag = r.flag();
  }
  ph.ph_deblocking_filter_disabled_flag =
      pps.pps_deblocking_filter_disabled_flag;
  for (int i = 0; i < 3; i++) {
    ph.beta_offset[i] = pps.beta_offset[i];
    ph.tc_offset[i] = pps.tc_offset[i];
  }
  if (pps.pps_dbf_info_in_ph_flag && r.flag()) {
    // ph_deblocking_params_present_flag: PH-level override
    ph.ph_deblocking_filter_disabled_flag =
        pps.pps_deblocking_filter_disabled_flag ? 0 : (int)r.flag();
    if (!ph.ph_deblocking_filter_disabled_flag) {
      ph.beta_offset[0] = r.se() * 2;
      ph.tc_offset[0] = r.se() * 2;
      if (pps.pps_chroma_tool_offsets_present_flag) {
        ph.beta_offset[1] = r.se() * 2;
        ph.tc_offset[1] = r.se() * 2;
        ph.beta_offset[2] = r.se() * 2;
        ph.tc_offset[2] = r.se() * 2;
      } else {
        ph.beta_offset[1] = ph.beta_offset[2] = ph.beta_offset[0];
        ph.tc_offset[1] = ph.tc_offset[2] = ph.tc_offset[0];
      }
    }
  }
  return ph;
}

// spec 7.3.2.5 aps_data + 7.3.2.18 lmcs_data (reference:
// cbs_h266_syntax_template.c aps()/lmcs_data())
Aps parse_aps(BitReader& r) {
  Aps aps;
  aps.aps_params_type = r.u(3);
  aps.id = r.u(5);
  aps.chroma_present = r.flag();
  if (aps.aps_params_type == 1) {  // LMCS
    aps.lmcs_min_bin_idx = (int)r.ue();
    aps.lmcs_delta_max_bin_idx = (int)r.ue();
    int prec = (int)r.ue() + 1;
    VVC_UNSUPPORTED(prec > 15, "lmcs_delta_cw_prec out of range");
    const int max_bin = 15 - aps.lmcs_delta_max_bin_idx;
    VVC_UNSUPPORTED(max_bin < aps.lmcs_min_bin_idx, "lmcs bin range");
    for (int i = aps.lmcs_min_bin_idx; i <= max_bin; i++) {
      int abs_cw = r.u(prec);
      int sign = abs_cw > 0 ? (int)r.flag() : 0;
      aps.lmcs_delta_cw[i] = (1 - 2 * sign) * abs_cw;
    }
    if (aps.chroma_present) {
      int abs_crs = r.u(3);
      int sign = abs_crs > 0 ? (int)r.flag() : 0;
      aps.lmcs_delta_crs = (1 - 2 * sign) * abs_crs;
    }
  } else if (aps.aps_params_type == 0) {  // ALF (spec 7.3.2.19)
    aps.alf_luma_signal = r.flag();
    if (aps.chroma_present) {
      aps.alf_chroma_signal = r.flag();
      aps.alf_cc_signal[0] = r.flag();
      aps.alf_cc_signal[1] = r.flag();
    }
    int luma_clip = 0, num_luma = 1;
    int delta_idx[25] = {};
    int16_t coeff[25][12] = {};
    uint8_t clipidx[25][12] = {};
    if (aps.alf_luma_signal) {
      luma_clip = r.flag();
      num_luma = (int)r.ue() + 1;
      VVC_UNSUPPORTED(num_luma > 25, "alf num luma filters");
      if (num_luma > 1) {
        int bits = 1;
        while ((1 << bits) < num_luma) bits++;
        for (int f = 0; f < 25; f++) delta_idx[f] = r.u(bits);
      }
      for (int sf = 0; sf < num_luma; sf++)
        for (int j = 0; j < 12; j++) {
          int a = (int)r.ue();
          VVC_UNSUPPORTED(a > 128, "alf luma coeff abs");
          int sgn = a ? (int)r.flag() : 0;
          coeff[sf][j] = (int16_t)((1 - 2 * sgn) * a);
        }
    }
    for (int sf = 0; sf < num_luma; sf++)
      for (int j = 0; j < 12; j++)
        clipidx[sf][j] = luma_clip ? (uint8_t)r.u(2) : 0;
    // expand per-class (alf_luma, vvc_ps.c:821-836)
    for (int cls = 0; cls < 25; cls++) {
      int ref = delta_idx[cls];
      VVC_UNSUPPORTED(ref >= num_luma, "alf delta idx");
      std::memcpy(aps.alf_luma_coeff[cls], coeff[ref], sizeof(coeff[ref]));
      std::memcpy(aps.alf_luma_clipidx[cls], clipidx[ref],
                  sizeof(clipidx[ref]));
    }
    int chroma_clip = 0;
    if (aps.alf_chroma_signal) {
      chroma_clip = r.flag();
      aps.num_chroma_alts = (int)r.ue() + 1;
      VVC_UNSUPPORTED(aps.num_chroma_alts > 8, "alf chroma alts");
    }
    for (int alt = 0; alt < aps.num_chroma_alts; alt++) {
      for (int j = 0; j < 6; j++) {
        int a = aps.alf_chroma_signal ? (int)r.ue() : 0;
        VVC_UNSUPPORTED(a > 128, "alf chroma coeff abs");
        int sgn = a ? (int)r.flag() : 0;
        aps.alf_chroma_coeff[alt][j] = (int16_t)((1 - 2 * sgn) * a);
      }
      for (int j = 0; j < 6; j++)
        aps.alf_chroma_clipidx[alt][j] =
            chroma_clip ? (uint8_t)r.u(2) : 0;
    }
    for (int cc = 0; cc < 2; cc++) {
      if (aps.alf_cc_signal[cc])
        aps.num_cc_filters[cc] = (int)r.ue() + 1;
      VVC_UNSUPPORTED(aps.num_cc_filters[cc] > 4, "alf cc filters");
      for (int k = 0; k < aps.num_cc_filters[cc] && aps.alf_cc_signal[cc];
           k++)
        for (int j = 0; j < 7; j++) {
          int m = r.u(3);  // mapped abs: 0 or 1 << (m-1)
          int c = 0;
          if (m) {
            int sgn = (int)r.flag();
            c = (1 - 2 * sgn) * (1 << (m - 1));
          }
          aps.alf_cc_coeff[cc][k][j] = (int16_t)c;
        }
    }
  } else if (aps.aps_params_type == 2) {
    // scaling_list_data (7.3.2.21) parsed and immediately derived to
    // ScalingMatrixRec / ScalingMatrixDcRec (scaling_derive,
    // vvc_ps.c:903-960).  The delta accumulation always walks the
    // 8x8 diagonal scan; placement uses the matrix's own scan.
    uint8_t d8x[64], d8y[64];
    {
      int i = 0;
      for (int s = 0; s < 15; s++)
        for (int y = std::min(s, 7); y >= 0 && s - y < 8; y--) {
          d8x[i] = (uint8_t)(s - y);
          d8y[i] = (uint8_t)y;
          i++;
        }
    }
    for (int id = 0; id < 28; id++) {
      const int msize = id < 2 ? 2 : (id < 8 ? 4 : 8);
      const int lsize = msize * msize;
      int copy = 1, pred = 0, pred_delta = 0;
      int coeff[64] = {};
      int dc = 0;
      bool present = aps.chroma_present || id % 3 == 2 || id == 27;
      if (present) {
        copy = (int)r.flag();
        if (!copy) pred = (int)r.flag();
        if ((copy || pred) && id != 0 && id != 2 && id != 8)
          pred_delta = (int)r.ue();
        if (!copy) {
          int next = 0;
          if (id > 13) {
            dc = next = r.se();
            VVC_UNSUPPORTED(dc < -128 || dc > 127, "scaling dc range");
          }
          for (int i = 0; i < lsize; i++) {
            if (!(id > 25 && d8x[i] >= 4 && d8y[i] >= 4)) next += r.se();
            coeff[i] = next;
          }
        }
      }
      // dc reconstruction (id >= 14)
      if (id >= 14) {
        if (!copy && !pred) {
          aps.sl_dc_rec[id - 14] = 8;
        } else if (!pred_delta) {
          aps.sl_dc_rec[id - 14] = 16;
        } else {
          const int ref_id = id - pred_delta;
          int base = ref_id >= 14 ? aps.sl_dc_rec[ref_id - 14]
                                  : aps.sl_rec[ref_id][0];
          aps.sl_dc_rec[id - 14] = (uint8_t)((dc + base) & 255);
        }
      }
      // ac reconstruction: predictor + (copy ? 0 : coeff), diag order
      const int pred8 = (!copy && !pred) ? 8 : 16;
      const uint8_t* refm =
          (copy || pred) && pred_delta ? aps.sl_rec[id - pred_delta]
                                       : nullptr;
      // diag scan of the matrix's own size
      int i = 0;
      for (int s = 0; s < 2 * msize - 1 && i < lsize; s++)
        for (int y = std::min(s, msize - 1); y >= 0 && s - y < msize; y--) {
          const int x = s - y;
          const int off = y * msize + x;
          const int p = refm ? refm[off] : pred8;
          const int v = copy ? 0 : coeff[i];
          aps.sl_rec[id][off] = (uint8_t)((p + v) & 255);
          i++;
        }
    }
  } else {
    VVC_UNSUPPORTED(true, "unknown APS type");
  }
  VVC_UNSUPPORTED(r.flag(), "aps extension");
  return aps;
}

PictureHeader parse_picture_header_nal(BitReader& r, const Sps& sps,
                                       const Pps& pps) {
  return parse_picture_header(r, sps, pps);
}

SliceHeader parse_slice_header(BitReader& r, int nal_type, const Sps& sps,
                               const Pps& pps,
                               const PictureHeader* ext_ph) {
  SliceHeader sh;
  sh.nal_type = nal_type;
  sh.sh_picture_header_in_slice_header_flag = r.flag();
  if (sh.sh_picture_header_in_slice_header_flag) {
    sh.ph = parse_picture_header(r, sps, pps);
  } else {
    VVC_UNSUPPORTED(!ext_ph, "slice without a preceding PH NAL");
    sh.ph = *ext_ph;
  }
  // inferred value when PH is in SH (7.4.8.1); overridden below when a
  // separate PH carries the picture header
  sh.sh_lmcs_used_flag = sh.ph.ph_lmcs_enabled_flag;
  sh.sh_explicit_scaling_list_used_flag =
      sh.ph.ph_explicit_scaling_list_enabled_flag;
  const PictureHeader& ph = sh.ph;

  // no subpics; slice address (single slice per pic supported so far)
  int num_tiles_in_pic = pps.num_tile_columns * pps.num_tile_rows;
  int num_slices_in_pic = pps.slice_rects.empty()
                              ? 1 : (int)pps.slice_rects.size();
  if ((pps.pps_rect_slice_flag && num_slices_in_pic > 1) ||
      (!pps.pps_rect_slice_flag && num_tiles_in_pic > 1)) {
    int bits = ceil_log2(pps.pps_rect_slice_flag ? num_slices_in_pic
                                                 : num_tiles_in_pic);
    sh.sh_slice_address = r.u(bits);
  }
  if (!pps.pps_rect_slice_flag && num_tiles_in_pic - sh.sh_slice_address > 1)
    sh.sh_num_tiles_in_slice_minus1 = r.ue();
  if (ph.ph_inter_slice_allowed_flag) sh.sh_slice_type = r.ue();
  if (nal_is_irap(nal_type) || nal_type == NAL_GDR)
    sh.sh_no_output_of_prior_pics_flag = r.flag();
  if (sps.sps_alf_enabled_flag && pps.pps_alf_info_in_ph_flag) {
    // ALF signalled in the PH: slices inherit every field (7.4.8)
    sh.sh_alf_enabled_flag = ph.ph_alf_enabled_flag;
    sh.sh_num_alf_aps_ids_luma = ph.ph_num_alf_aps_ids_luma;
    for (int i = 0; i < 8; i++)
      sh.sh_alf_aps_id_luma[i] = ph.ph_alf_aps_id_luma[i];
    sh.sh_alf_cb_enabled_flag = ph.ph_alf_cb_enabled_flag;
    sh.sh_alf_cr_enabled_flag = ph.ph_alf_cr_enabled_flag;
    sh.sh_alf_aps_id_chroma = ph.ph_alf_aps_id_chroma;
    sh.sh_alf_cc_cb_enabled_flag = ph.ph_alf_cc_cb_enabled_flag;
    sh.sh_alf_cc_cb_aps_id = ph.ph_alf_cc_cb_aps_id;
    sh.sh_alf_cc_cr_enabled_flag = ph.ph_alf_cc_cr_enabled_flag;
    sh.sh_alf_cc_cr_aps_id = ph.ph_alf_cc_cr_aps_id;
  }
  if (sps.sps_alf_enabled_flag && !pps.pps_alf_info_in_ph_flag)
  {
    sh.sh_alf_enabled_flag = r.flag();
    if (sh.sh_alf_enabled_flag) {
      sh.sh_num_alf_aps_ids_luma = r.u(3);
      for (int i = 0; i < sh.sh_num_alf_aps_ids_luma; i++)
        sh.sh_alf_aps_id_luma[i] = r.u(3);
      if (sps.sps_chroma_format_idc) {
        sh.sh_alf_cb_enabled_flag = r.flag();
        sh.sh_alf_cr_enabled_flag = r.flag();
      }
      if (sh.sh_alf_cb_enabled_flag || sh.sh_alf_cr_enabled_flag)
        sh.sh_alf_aps_id_chroma = r.u(3);
      if (sps.sps_ccalf_enabled_flag) {
        sh.sh_alf_cc_cb_enabled_flag = r.flag();
        if (sh.sh_alf_cc_cb_enabled_flag)
          sh.sh_alf_cc_cb_aps_id = r.u(3);
        sh.sh_alf_cc_cr_enabled_flag = r.flag();
        if (sh.sh_alf_cc_cr_enabled_flag)
          sh.sh_alf_cc_cr_aps_id = r.u(3);
      }
    }
  }

  if (!sh.sh_picture_header_in_slice_header_flag) {
    if (ph.ph_lmcs_enabled_flag)
      sh.sh_lmcs_used_flag = r.flag();
    sh.sh_explicit_scaling_list_used_flag =
        ph.ph_explicit_scaling_list_enabled_flag ? (int)r.flag() : 0;
  }

  bool is_idr = nal_is_idr(nal_type);
  if (pps.pps_rpl_info_in_ph_flag) {
    // RPL signalled in the PH: slices inherit (7.4.8)
    sh.rpl[0] = ph.rpl[0];
    sh.rpl[1] = ph.rpl[1];
    sh.sh_collocated_from_l0_flag = ph.ph_collocated_from_l0_flag;
    sh.sh_collocated_ref_idx = ph.ph_collocated_ref_idx;
  } else if (!is_idr || sps.sps_idr_rpl_present_flag) {
    parse_ref_pic_lists(r, sps, pps, sh.rpl);
  }
  if ((sh.sh_slice_type != 2 && sh.rpl[0].num_ref_entries > 1) ||
      (sh.sh_slice_type == 0 && sh.rpl[1].num_ref_entries > 1)) {
    int override_flag = r.flag();
    if (override_flag) {
      for (int i = 0; i < (sh.sh_slice_type == 0 ? 2 : 1); i++)
        if (sh.rpl[i].num_ref_entries > 1)
          sh.num_ref_idx_active[i] = r.ue() + 1;
        else
          sh.num_ref_idx_active[i] = 1;
    } else {
      for (int i = 0; i < 2; i++) {
        if (sh.sh_slice_type == 0 || (sh.sh_slice_type == 1 && i == 0)) {
          int n = sh.rpl[i].num_ref_entries;
          int d = pps.num_ref_idx_default_active[i];
          sh.num_ref_idx_active[i] = n < d ? n : d;
        }
      }
    }
  } else {
    for (int i = 0; i < 2; i++) {
      if (sh.sh_slice_type == 0 || (sh.sh_slice_type == 1 && i == 0))
        sh.num_ref_idx_active[i] =
            sh.rpl[i].num_ref_entries < pps.num_ref_idx_default_active[i]
                ? sh.rpl[i].num_ref_entries
                : pps.num_ref_idx_default_active[i];
    }
  }

  if (sh.sh_slice_type != 2) {
    if (pps.pps_cabac_init_present_flag) sh.sh_cabac_init_flag = r.flag();
    if (ph.ph_temporal_mvp_enabled_flag && !pps.pps_rpl_info_in_ph_flag) {
      if (sh.sh_slice_type == 0) sh.sh_collocated_from_l0_flag = r.flag();
      int idx = sh.sh_collocated_from_l0_flag ? 0 : 1;
      if (sh.num_ref_idx_active[idx] > 1) sh.sh_collocated_ref_idx = r.ue();
    }
    // explicit weighted prediction (7.3.8 pred_weight_table +
    // derivation vvc_ps.c:540-561)
    if ((pps.pps_weighted_pred_flag && sh.sh_slice_type == 1) ||
        (pps.pps_weighted_bipred_flag && sh.sh_slice_type == 0)) {
      PredWeight& w = sh.pwt;
      w.log2_denom[0] = (int)r.ue();
      w.log2_denom[1] = w.log2_denom[0];
      if (sps.sps_chroma_format_idc) w.log2_denom[1] += r.se();
      const int denom[2] = {1 << w.log2_denom[0], 1 << w.log2_denom[1]};
      for (int lx = 0; lx < 2; lx++) {
        int n = 0;
        if (lx == 0)
          n = sh.num_ref_idx_active[0];
        else if (pps.pps_weighted_bipred_flag &&
                 sh.rpl[1].num_ref_entries > 0)
          n = sh.num_ref_idx_active[1];
        w.nb_weights[lx] = n;
        for (int i = 0; i < n; i++) w.weight_flag[lx][0][i] = r.flag();
        if (sps.sps_chroma_format_idc)
          for (int i = 0; i < n; i++) {
            w.weight_flag[lx][1][i] = r.flag();
            w.weight_flag[lx][2][i] = w.weight_flag[lx][1][i];
          }
        for (int i = 0; i < n; i++) {
          w.weight[lx][0][i] = denom[0];
          w.offset[lx][0][i] = 0;
          if (w.weight_flag[lx][0][i]) {
            w.weight[lx][0][i] += r.se();
            w.offset[lx][0][i] = r.se();
          }
          for (int j = 1; j <= 2; j++) {
            w.weight[lx][j][i] = denom[1];
            w.offset[lx][j][i] = 0;
          }
          if (w.weight_flag[lx][1][i]) {
            for (int j = 1; j <= 2; j++) {
              w.weight[lx][j][i] = denom[1] + r.se();
              int off = 128 + r.se();
              off -= (128 * w.weight[lx][j][i]) >> w.log2_denom[1];
              w.offset[lx][j][i] = clip(off, -128, 127);
            }
          }
        }
      }
    }
  }
  int qp_delta = pps.pps_qp_delta_info_in_ph_flag ? ph.ph_qp_delta : r.se();
  sh.slice_qp_y = pps.pps_init_qp + qp_delta;
  if (pps.pps_slice_chroma_qp_offsets_present_flag) {
    sh.sh_cb_qp_offset = r.se();
    sh.sh_cr_qp_offset = r.se();
    if (sps.sps_joint_cbcr_enabled_flag) sh.sh_joint_cbcr_qp_offset = r.se();
  }
  if (sps.sps_sao_enabled_flag && !pps.pps_sao_info_in_ph_flag) {
    sh.sh_sao_luma_used_flag = r.flag();
    if (sps.sps_chroma_format_idc) sh.sh_sao_chroma_used_flag = r.flag();
  } else {
    sh.sh_sao_luma_used_flag = ph.ph_sao_luma_enabled_flag;
    sh.sh_sao_chroma_used_flag = ph.ph_sao_chroma_enabled_flag;
  }
  sh.sh_deblocking_filter_disabled_flag =
      ph.ph_deblocking_filter_disabled_flag;
  for (int i = 0; i < 3; i++) {
    sh.beta_offset[i] = ph.beta_offset[i];
    sh.tc_offset[i] = ph.tc_offset[i];
  }
  if (pps.pps_deblocking_filter_override_enabled_flag &&
      !pps.pps_dbf_info_in_ph_flag && r.flag()) {
    // sh_deblocking_params_present_flag: slice-level override (7.3.8)
    sh.sh_deblocking_filter_disabled_flag =
        pps.pps_deblocking_filter_disabled_flag ? 0 : (int)r.flag();
    if (!sh.sh_deblocking_filter_disabled_flag) {
      sh.beta_offset[0] = r.se() * 2;
      sh.tc_offset[0] = r.se() * 2;
      if (pps.pps_chroma_tool_offsets_present_flag) {
        sh.beta_offset[1] = r.se() * 2;
        sh.tc_offset[1] = r.se() * 2;
        sh.beta_offset[2] = r.se() * 2;
        sh.tc_offset[2] = r.se() * 2;
      } else {
        sh.beta_offset[1] = sh.beta_offset[2] = sh.beta_offset[0];
        sh.tc_offset[1] = sh.tc_offset[2] = sh.tc_offset[0];
      }
    }
  }
  if (sps.sps_dep_quant_enabled_flag) sh.sh_dep_quant_used_flag = r.flag();
  if (sps.sps_sign_data_hiding_enabled_flag && !sh.sh_dep_quant_used_flag)
    sh.sh_sign_data_hiding_used_flag = r.flag();
  if (sps.sps_transform_skip_enabled_flag && !sh.sh_dep_quant_used_flag &&
      !sh.sh_sign_data_hiding_used_flag)
    sh.sh_ts_residual_coding_disabled_flag = r.flag();
  if (sps.sps_entry_point_offsets_present_flag) {
    // NumEntryPoints (7.4.8.1; parity cbs_h266_syntax_template.c:3380)
    int entropy_sync = sps.sps_entropy_coding_sync_enabled_flag;
    int pic_h_ctbs = (pps.height + sps.ctb_size_y - 1) >> sps.ctb_log2_size_y;
    int num_entry_points;
    if (pps.pps_rect_slice_flag && !pps.slice_rects.empty()) {
      // explicit tile-aligned rect slice: EPs per tile (or per CTU
      // row of the slice's tile rows with WPP)
      const auto& sr = pps.slice_rects[sh.sh_slice_address];
      if (entropy_sync) {
        int rows = 0;
        for (int ty = sr.ty0; ty < sr.ty0 + sr.ht; ty++)
          rows += pps.row_height[ty];
        num_entry_points = sr.wt * rows - 1;
      } else {
        num_entry_points = sr.wt * sr.ht - 1;
      }
    } else if (pps.pps_rect_slice_flag) {
      // whole-picture rect slice
      int width_in_tiles = pps.num_tile_columns;
      int height = entropy_sync ? pic_h_ctbs : pps.num_tile_rows;
      num_entry_points = width_in_tiles * height - 1;
    } else {
      // raster slice: one EP per tile (or per CTU row with WPP)
      num_entry_points = 0;
      int n_tiles = pps.num_tile_columns * pps.num_tile_rows;
      int first = sh.sh_slice_address;
      int cnt = sh.sh_num_tiles_in_slice_minus1 + 1;
      for (int t = first; t < first + cnt && t < n_tiles; t++) {
        int ty = t / pps.num_tile_columns;
        num_entry_points += entropy_sync ? pps.row_height[ty] : 1;
      }
      num_entry_points -= 1;
    }
    if (num_entry_points > 0) {
      int len = r.ue() + 1;
      for (int i = 0; i < num_entry_points; i++)
        sh.entry_point_offsets.push_back(r.u(len) + 1);
    }
  }
  // byte_alignment()
  int one = r.u(1);
  if (one != 1) throw std::runtime_error("sh alignment bit != 1");
  r.byte_align();
  sh.data_bitpos = r.bitpos();
  return sh;
}

}  // namespace vvc
