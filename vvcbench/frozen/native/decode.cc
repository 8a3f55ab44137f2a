// VVC slice-data parser: coding tree, intra CU syntax, residual coding.
// Emits device-ready syntax tensors (coefficient planes, per-min-CB mode
// planes, CU/TU record tables) for the JAX reconstruction pipeline.
//
// Behavioural parity targets (independent implementation):
//   coding tree / CU / TU     vvc_ctu.c:947-2330
//   syntax element decoding   vvc_cabac.c:950-1780
//   residual coding           vvc_cabac.c:1843-2460
//
// v1 toolset: all-intra, single tree, CU == CTU or no-split configs
// (split decoding lands with can_split), regular residual coding.
#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "bits.h"
#include "cabac.h"
#include "cabac_tables.h"
#include "headers.h"

namespace vvc {
namespace {

constexpr int MODE_INTER = 0, MODE_INTRA = 1;
constexpr int INTRA_PLANAR = 0, INTRA_DC = 1, INTRA_HORZ = 18, INTRA_VERT = 50,
              INTRA_VDIAG = 66, INTRA_LT_CCLM = 81, INTRA_L_CCLM = 82,
              INTRA_T_CCLM = 83;

// Diagonal scan (spec 6.5.2), computed on demand.
struct DiagScan {
  std::vector<uint8_t> x, y;
};
const DiagScan& diag_scan(int log2_w, int log2_h) {
  static DiagScan cache[6][6];
  static bool init[6][6] = {};
  DiagScan& s = cache[log2_w][log2_h];
  if (!init[log2_w][log2_h]) {
    int bw = 1 << log2_w, bh = 1 << log2_h;
    int xx = 0, yy = 0;
    while ((int)s.x.size() < bw * bh) {
      while (yy >= 0) {
        if (xx < bw && yy < bh) {
          s.x.push_back(xx);
          s.y.push_back(yy);
        }
        yy--;
        xx++;
      }
      yy = xx;
      xx = 0;
    }
    init[log2_w][log2_h] = true;
  }
  return s;
}

}  // namespace

#pragma pack(push, 4)
struct CuRecord {
  int32_t x0, y0, w, h;        // luma coords
  int32_t pred_mode;           // MODE_*
  int32_t luma_mode;           // IntraPredModeY
  int32_t chroma_mode;         // derived IntraPredModeC
  int32_t qp;                  // QpY
  int32_t qp_c[3];             // Qp'Cb, Qp'Cr, Qp'CbCr
  int32_t skip, merge, idx;    // idx = merge_idx or mvp_lx_flag
  int32_t mv_x, mv_y, ref_idx; // L0 motion (1/16 pel)
  int32_t pf;                  // PF_* of final motion
  int32_t mv1_x, mv1_y, ref_idx1;  // L1 motion
  int32_t bdpcm_l, bdpcm_c;    // BDPCM per component pair
  int32_t bcw;                 // bcw_idx (0 = default equal weights)
  int32_t hpel;                // hpel_if_idx (AMVR half-pel alt filter)
  int32_t ciip;                // combined inter/intra prediction
  int32_t ciip_w;              // CIIP intra blend weight (1..3)
  int32_t gpm_part;            // GPM partition idx (-1 = not GPM)
  int32_t gpm_lx0, gpm_lx1;    // per-hypothesis reference list
  int32_t sbtmvp;              // merge_subblock_flag (SbTMVP; per-8x8
                               // motion lives in the mvf planes)
  int32_t affine;              // affine motion model (merge or AMVP):
                               // per-4x4 motion in the mvf planes
  int32_t prof;                // PROF flags (1 = L0, 2 = L1)
  int32_t pd[8];               // per-list subblock deltas for PROF:
                               // [list*4 + (dhx, dhy, dvx, dvy)]
  int32_t bdof;                // BDOF applies (16x16 luma subblocks)
  int32_t dmvr;                // DMVR applies (refined per subblock on
                               // the python side; planes in FrameOut)
  int32_t mip;                 // MIP mode (-1 = not MIP; vvc_ctu.c:967-980)
  int32_t mip_t;               // intra_mip_transposed_flag
  int32_t mrl;                 // intra_luma_ref_idx (0/1/2, MRL)
  int32_t isp;                 // IntraSubPartitionsSplitType: 0 none,
                               // 1 HOR, 2 VER (vvc_ctu.c:985-993)
  int32_t isp_parts;           // NumIntraSubPartitions (1/2/4)
};
struct TuRecord {
  int32_t x0, y0, w, h;  // component coords
  int32_t c_idx;
  int32_t coded;         // *parsed* cbf (what the deblock cbf tab sees)
  int32_t qp;            // component QP used for dequant
  int32_t cu_index;      // owning CU
  int32_t trh, trv;      // transform kinds (0=DCT2 1=DST7 2=DCT8)
  int32_t res;           // residual present (parsed or jointly derived)
  int32_t jop;           // joint-CbCr op: 0 none, 1+[sign<0]+2*shift
  int32_t qsel;          // dequant qp source: 0 by c_idx, 1..3 qp_c[0..2]
  int32_t qp_deq;        // dequant qp (differs from qp for joint TBs)
  int32_t ts;            // transform skip
  int32_t pcmf;          // BDPCM marker for deblock (luma / CB-as-chroma)
  int32_t lf_sel;        // LFNST kernel: -1 none, else set*2 + (idx-1)
  int32_t lf_tr;         // LFNST transpose (pred mode > 34)
  int32_t slid = -1;     // scaling-matrix id (Table 38; -1 = flat 16)
};
#pragma pack(pop)

// LMCS derived state (parity: lmcs_derive_lut, vvc_ps.c:601-671) —
// exported as piecewise-linear segment tables, NOT sample LUTs: the
// device evaluates fwd/inv mapping arithmetically (16 segments), which
// avoids per-pixel LUT gathers that are slow on TPU.
struct LmcsOut {
  int enabled = 0;            // sh_lmcs_used (inferred from PH here)
  int crs_flag = 0;           // ph_chroma_residual_scale_flag
  int min_bin = 0, max_bin = 15;
  int32_t pivot[17] = {};
  int32_t fwd_scale[16] = {};
  int32_t inv_scale[16] = {};
  int32_t chroma_scale[16] = {};
};

// ALF derived per-frame state: the slice's filter banks (flattened
// from the referenced APSs) + per-CTB CABAC decisions.  Parity:
// alf_params (vvc_ctu.c) + VVCALF (vvc_ps.c:803-886).
struct AlfOut {
  int enabled = 0;        // sh_alf_enabled_flag
  int cc_enabled[2] = {0, 0};
  int n_aps_luma = 0;     // luma APS banks (bank_idx 16+k selects k)
  std::vector<int32_t> luma_coeff;    // (n_aps_luma, 25, 12)
  std::vector<int32_t> luma_clipidx;  // (n_aps_luma, 25, 12)
  int num_chroma_alts = 1;
  int32_t chroma_coeff[8][6] = {};
  int32_t chroma_clipidx[8][6] = {};
  int32_t cc_coeff[2][4][7] = {};
  // per-CTB, 8 ints: flag_y, filt_set_idx_y, flag_cb, alt_cb,
  // flag_cr, alt_cr, cc_idc_cb, cc_idc_cr
  std::vector<int32_t> ctb;
};

constexpr int PF_INTRA = 0, PF_L0 = 1, PF_L1 = 2, PF_BI = 3;

struct MvF {
  int32_t mv[2][2] = {{0, 0}, {0, 0}};  // [list][x/y], 1/16 pel
  int32_t ref_idx[2] = {-1, -1};
  int32_t pred_flag = PF_INTRA;
  int32_t bcw = 0;   // bcw_idx (propagates through spatial/HMVP merge)
  int32_t hpel = 0;  // hpel_if_idx
  int32_t ciip = 0;  // not inheritable (vvc_mvs.c:813); set at store
  bool operator==(const MvF& o) const {
    if (pred_flag != o.pred_flag) return false;
    for (int i = 0; i < 2; i++) {
      if (pred_flag & (i + 1)) {
        if (mv[i][0] != o.mv[i][0] || mv[i][1] != o.mv[i][1] ||
            ref_idx[i] != o.ref_idx[i])
          return false;
      }
    }
    return true;
  }
};

struct FrameOut {
  int width = 0, height = 0, bit_depth = 8, chroma_format_idc = 1;
  int ctb_log2 = 5;
  // tile boundaries in luma samples, ascending, with 0 / >=pic sentinels
  std::vector<int32_t> tile_col_bd{0, 1 << 16};
  std::vector<int32_t> tile_row_bd{0, 1 << 16};
  int max_num_reorder = 0;
  int poc = 0, slice_qp = 26;
  int mcb_w = 0, mcb_h = 0;  // min-CB grid dims of the ipm plane
  int deblock_disabled = 0;
  int beta_offset[3] = {0, 0, 0};  // luma, cb, cr (x2 applied)
  int tc_offset[3] = {0, 0, 0};
  int slice_type = 2;  // 0=B 1=P 2=I
  int dep_quant = 0;   // sh_dep_quant_used_flag (drives dequant addin)
  int crop[4] = {0, 0, 0, 0};  // conf window L/R/T/B in LUMA samples
  int gdr_pic = 0;             // ph_gdr_pic_flag
  int recovery_poc_cnt = 0;    // ph_recovery_poc_cnt (GDR pictures)
  int has_isp = 0;             // any ISP CU in the frame (drives the
                               // fine-grained recon-bitmap granularity
                               // and the extended residual size set)
  int ref_wraparound_offset = 0;  // luma samples; 0 = disabled
  int has_tb64 = 0;            // any luma TB with a 64-sample dimension
                               // (sps_max_luma_transform_size_64_flag
                               // streams: drives the 64-size residual
                               // classes + 64-wide intra predict units)
  int has_sl = 0;              // sh_explicit_scaling_list_used_flag
  uint8_t sl_rec[28][64] = {};  // ScalingMatrixRec (active APS)
  uint8_t sl_dc_rec[14] = {};   // ScalingMatrixDcRec
  int cclm_vc = 0;     // sps_chroma_vertical_collocated_flag (CCLM dsy)
  int nb_refs[2] = {0, 0};
  int32_t ref_pocs[2][16] = {};
  std::vector<int32_t> coeff[3];  // [h][w] raster planes (chroma at c-res)
  std::vector<CuRecord> cus;
  std::vector<TuRecord> tus;
  std::vector<int32_t> ipm;  // per-min-cb intra mode plane
  // MvField planes at 4x4 granularity (MIN_PU_LOG2 == 2)
  std::vector<int32_t> mvf_pf, mvf_x, mvf_y, mvf_ref;       // L0
  std::vector<int32_t> mvf_x1, mvf_y1, mvf_ref1;            // L1
  std::vector<int32_t> mvf_ciip;  // per-4x4 ciip flag (deblock bs)
  // per-CTB SAO params, 24 ints each:
  // type[3], band_position[3], eo_class[3], offset_val[3][5]
  std::vector<int32_t> sao;
  LmcsOut lmcs;
  AlfOut alf;
  // explicit weighted prediction (derive_weight, vvc_inter.c:149-178)
  int wp_active = 0;
  int wpp = 0;  // sps_entropy_coding_sync (clips intra/MV availability)
  PredWeight pwt;
  // DMVR (8.5.3): refined per-subblock MVs arrive from the search
  // (vvch_dmvr_apply) as per-4x4 planes; col publication is deferred
  // until then so later frames' TMVP sees the refined motion
  int needs_dmvr = 0;
  int pending_epoch = 0;
  std::vector<int32_t> dmvr_x0, dmvr_y0, dmvr_x1, dmvr_y1, dmvr_nobdof;
  std::vector<MvF> pending_col;  // original motion awaiting publication
};

// ---------------- per-CU reconstruction controls ----------------
// Native mirror of ffmpeg_tpu/models/vvc/recon.py:derive_cu_controls and
// the host-side mode derivations in ffmpeg_tpu/ops/intra.py (spec
// 8.4.5.2; parity targets vvc_intra.c:591-713).  Emitted as a (26, n)
// int32 matrix in CTRL_KEYS order so the Python side hands the parser
// output straight to the frame program.
namespace ctrl {

constexpr int kNumKeys = 75;
// CTRL_KEYS order (recon.py): x0,y0,w,h,logw,logh,mode_class,angle,
// inv_angle,filter_flag,smooth,left_size,top_size,unfilter_last_one,
// do_pdpc,nscale,avail_l,avail_t,cand_up_left,proj_v,proj_h,
// pf,m0x,m0y,m1x,m1y,r0slot,r1slot,chunk,corner_src
enum Key {
  kX0, kY0, kW, kH, kLogW, kLogH, kModeClass, kAngle, kInvAngle,
  kFilterFlag, kSmooth, kLeftSize, kTopSize, kUnfilterLastOne,
  kDoPdpc, kNscale, kAvailL, kAvailT, kCandUpLeft, kProjV, kProjH,
  kPf, kM0x, kM0y, kM1x, kM1y, kR0Idx, kR1Idx, kChunk,
  // weighted-sample-prediction controls (derive_weight,
  // vvc_inter.c:149-178): kWden < 0 means default averaging
  kWden, kW0, kW1, kO0, kO1,
  // kHpel: luma interpolation filter bank (hpel_if_idx; AMVR shift 3)
  kHpel,
  // kCiipW: CIIP intra blend weight 1..3 (0 = not a CIIP unit;
  // ciip_derive_intra_weight, vvc_inter.c:523-543)
  kCiipW,
  // GPM (pred_gpm_blk, vvc_inter.c:466-522): partition index (-1 =
  // not GPM), the unit tile's offset inside the CU and the CU's log2
  // dims (the host slices the blend-weight table with these), and the
  // two hypotheses' reference lists (slot mapping)
  kGpmPart, kGpmTx, kGpmTy, kGpmLw, kGpmLh, kHyp0Lx, kHyp1Lx,
  // second weight set (Cr) for the shared chroma control matrix
  kW0b, kW1b, kO0b, kO1b,
  // kCornerSrc: where the above-left corner sample lives for the
  // line-buffer kernel: 0 = the covering unit's bottom row is y0-1
  // (read the B buffer), 1 = it extends below (read its right column
  // from the R buffer).  Exactly one holds when the corner is decoded.
  kCornerSrc,
  // PROF (8.5.5.9 + apply_prof, vvc_inter_template.c:160-230): flag
  // bits (1 = L0, 2 = L1) + the per-list subblock deltas the device
  // rebuilds diff_mv_x/y from (d_hor_x, d_hor_y, d_ver_x, d_ver_y)
  kProf,
  kPDhx0, kPDhy0, kPDvx0, kPDvy0,
  kPDhx1, kPDhy1, kPDvx1, kPDvy1,
  // BDOF (8.5.6.4-5): bi-directional optical flow on this luma unit
  kBdof,
  // DMVR (8.5.3): the unit's MC uses the refined MV with sample reads
  // clamped to the original-MV window (emulated_edge_dmvr); kOm* are
  // the original (pre-refinement) MVs
  kDmvr,
  kOm0x, kOm0y, kOm1x, kOm1y,
  // MIP (matrix-based intra prediction, 8.4.5.2.2): kMipId = global
  // matrix row ({0,16,24}[size_id] + mode, -1 = not MIP), kMipT =
  // transposed, kMipSz = size id of the predict unit's TB dims
  kMipId, kMipT, kMipSz,
  // CCLM (8.4.5.2.14): kCclm = 0 off / 1 LT / 2 L / 3 T; kCclmVC =
  // sps_chroma_vertical_collocated_flag (selects the 5-tap vs 6-tap
  // luma downsampling stencil).  The avail keys carry the CCLM
  // select-sample runs (w / h for LT, the extended w+min(w,h) /
  // h+min(w,h) runs for T / L).  kCclmCT/kCclmCL = select-sample
  // counts, kCclmP0..3 = packed positions (cnt_t top picks then
  // cnt_l left picks; cclm_get_select_pos, vvc_intra_template.c:61-87)
  kCclm, kCclmVC, kCclmCT, kCclmCL, kCclmP0, kCclmP1, kCclmP2, kCclmP3,
  // MRL (8.4.5.2.5): intra_luma_ref_idx — the reference line offset.
  // Disables the ref filter and PDPC; angular positions start at
  // (y + 1 + ref_idx) * angle; edges come from row/col -1-ref_idx.
  kMrl,
};

constexpr int kPlanar = 0, kDc = 1, kHorz = 18, kDiag = 34, kVert = 50;
enum ModeClass { MC_PLANAR, MC_DC, MC_VERT, MC_HORZ, MC_ANG_V, MC_ANG_H,
                 MC_INTER, MC_MIP, MC_CCLM };

constexpr int kAngles[] = {0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20,
                           23, 26, 29, 32, 35, 39, 45, 51, 57, 64, 73,
                           86, 102, 128, 171, 256, 341, 512};

inline int bitlen(int v) {  // python int.bit_length (abs for negatives)
  unsigned u = (unsigned)(v < 0 ? -v : v);
  return u ? 32 - __builtin_clz(u) : 0;
}

inline int wide_angle_map(int mode, int w, int h) {
  if (w == h || mode == kPlanar || mode == kDc) return mode;
  int ratio = std::abs((bitlen(w) - 1) - (bitlen(h) - 1));
  int mx = ratio > 1 ? 8 + 2 * ratio : 8;
  int mn = ratio > 1 ? 60 - 2 * ratio : 60;
  if (w > h && mode >= 2 && mode < mx) return mode + 65;
  if (h > w && mode <= 66 && mode > mn) return mode - 67;
  return mode;
}

inline int intra_pred_angle(int mode) {
  int idx;
  if (mode > kDiag) idx = mode - kVert;
  else if (mode > 0) idx = kHorz - mode;
  else idx = kHorz - 2 - mode;
  int sign = 1;
  if (idx < 0) { idx = -idx; sign = -1; }
  return sign * kAngles[idx];
}

inline int intra_inv_angle(int angle) {
  int a = std::abs(angle);
  int val = (2 * 16384 + a) / (2 * a);
  return angle > 0 ? val : -val;
}

inline bool ref_filter_flag(int mode) {
  switch (mode) {
    case -14: case -12: case -10: case -6: case 0: case 2: case 34:
    case 66: case 72: case 76: case 78: case 80: return true;
    default: return false;
  }
}

inline int nscale(int w, int h, int mode) {
  if (mode == kPlanar || mode == kDc || mode == kHorz || mode == kVert)
    return (bitlen(w) + bitlen(h) - 4) >> 2;
  int angle = intra_pred_angle(mode);
  int inv = intra_inv_angle(angle);
  int side = mode >= kVert ? h : w;
  int v = (bitlen(side) - 1) - (bitlen(3 * inv - 2) - 1) + 8;
  return v < 2 ? v : 2;
}

inline bool need_pdpc(int w, int h, int mode) {
  if (w >= 4 && h >= 4) {
    if (mode == kPlanar || mode == kDc || mode == kHorz || mode == kVert)
      return true;
    if (mode > kHorz && mode < kVert) return false;
    return nscale(w, h, mode) >= 0;
  }
  return false;
}

inline int classify_mode(int mode) {
  if (mode == kPlanar) return MC_PLANAR;
  if (mode == kDc) return MC_DC;
  if (mode == kVert) return MC_VERT;
  if (mode == kHorz) return MC_HORZ;
  return mode >= kDiag ? MC_ANG_V : MC_ANG_H;
}

// One entry per *predict unit* (vvc_intra.c:214-241): for intra CUs the
// prediction runs per transform block (later TBs of a split CU read the
// reconstructed samples of earlier ones); inter CUs are one unit.
struct Unit {
  int cu_index;
  int x0, y0, w, h;    // component coords
  int lx0, ly0;        // luma origin (for CTU-relative availability)
};

// Units are <=32x32 tiles in decode order.  Intra units are transform
// blocks (1:1 with TuRecords of the plane kind); inter units follow the
// transform-tree leaves, tiled to <=32 (bit-exact: MC interpolation is
// per-pixel independent, so splitting a CU's prediction into tiles
// reads identical reference windows).  `slots`, when non-null, receives
// the per-TuRecord unit index (or -1) — the residual scatter target:
// every coded TU is exactly one unit tile, and a Cr TB shares its Cb
// sibling's slot (same geometry; residual planes differ by channel).
inline std::vector<Unit> predict_units(const FrameOut& fr, bool is_chroma,
                                       std::vector<int32_t>* slots = nullptr) {
  const int ss = (is_chroma && fr.chroma_format_idc == 1) ? 1 : 0;
  const int want_c = is_chroma ? 1 : 0;
  std::vector<Unit> units;
  units.reserve(fr.tus.size());
  if (slots) slots->assign(fr.tus.size(), -1);
  int cb_slot = -1, cb_x0 = -1, cb_y0 = -1;  // last Cb unit, for Cr
  for (size_t j = 0; j < fr.tus.size(); j++) {
    const TuRecord& tu = fr.tus[j];
    if (tu.c_idx != want_c) {
      if (slots && want_c == 1 && tu.c_idx == 2 && tu.x0 == cb_x0 &&
          tu.y0 == cb_y0)
        (*slots)[j] = cb_slot;
      continue;
    }
    // ISP_VER sub-partitions narrower than 4 merge into 4-wide predict
    // units (get_luma_predict_unit, vvc_intra.c:220-228): only the
    // first TB of each 4-wide group emits a unit; later TBs map their
    // residual slot onto it
    const CuRecord& cu0 = fr.cus[tu.cu_index];
    if (want_c == 0 && cu0.isp == 2 && tu.w < 4) {
      const int group = 4 / tu.w;
      const int k = ((tu.x0 - cu0.x0) / tu.w) % group;
      if (k != 0) {
        if (slots) (*slots)[j] = (int)units.size() - 1;
        continue;
      }
      if (slots) (*slots)[j] = (int)units.size();
      units.push_back({tu.cu_index, tu.x0, tu.y0, 4, tu.h,
                       tu.x0 << ss, tu.y0 << ss});
      continue;
    }
    // intra prediction is per-TB (predict_intra runs on the whole TB
    // from its own neighbours, vvc_intra.c:480-496), so a 64-sample
    // intra TB must stay ONE unit (splitting it would read interior
    // "reference" samples the spec never uses); inter MC is linear and
    // splits exactly, so inter TBs tile into <=32 MC units below
    const CuRecord& ucu = fr.cus[tu.cu_index];
    if (ucu.pred_mode == 0 && ucu.ciip && (ucu.w > 32 || ucu.h > 32)) {
      // large CIIP: planar + MC blend over the whole CB (predict_ciip
      // runs per CU, vvc_inter.c:915-921) — one CU-sized unit per
      // plane kind, emitted at the CB-origin TB; later TBs of the CU
      // only map their residual slots onto it
      const int ux0 = want_c ? (ucu.x0 >> ss) : ucu.x0;
      const int uy0 = want_c ? (ucu.y0 >> ss) : ucu.y0;
      if (tu.x0 == ux0 && tu.y0 == uy0) {
        if (slots) (*slots)[j] = (int)units.size();
        units.push_back({tu.cu_index, ux0, uy0,
                         want_c ? (ucu.w >> ss) : ucu.w,
                         want_c ? (ucu.h >> ss) : ucu.h,
                         ucu.x0, ucu.y0});
        if (want_c == 1) {
          cb_slot = (int)units.size() - 1;
          cb_x0 = tu.x0;
          cb_y0 = tu.y0;
        }
      } else if (slots) {
        (*slots)[j] = -1;
      }
      continue;
    }
    const int umax = ucu.pred_mode != 0 ? 64 : 32;
    const bool single = tu.w <= umax && tu.h <= umax;
    if (slots && single) (*slots)[j] = (int)units.size();
    if (want_c == 1 && single) {
      cb_slot = (int)units.size();
      cb_x0 = tu.x0;
      cb_y0 = tu.y0;
    }
    // subblock CUs (SbTMVP) predict per 8x8 luma subblock
    // (pred_regular_blk num_sb loop, vvc_inter.c:782-811): emit one MC
    // unit per subblock, row-major so the residual scatter can place a
    // TU across consecutive unit slots
    int step = umax;  // one tile for single TBs (incl. 64-wide intra)
    if (ucu.pred_mode == 0) {
      if (ucu.affine)
        step = want_c ? (8 >> ss) : 4;  // 4x4 affine subblocks
      else if (ucu.sbtmvp)
        step = want_c ? (8 >> ss) : 8;  // 8x8 SbTMVP subblocks
      else if (ucu.dmvr)
        step = want_c ? (16 >> ss) : 16;  // refined per 16x16 subblock
      else if (ucu.bdof && !want_c)
        step = 16;  // BDOF refines per 16x16 luma subblock
    }
    for (int ty = 0; ty < tu.h; ty += step)
      for (int tx = 0; tx < tu.w; tx += step) {
        const int tw = std::min(step, tu.w - tx);
        const int th = std::min(step, tu.h - ty);
        units.push_back({tu.cu_index, tu.x0 + tx, tu.y0 + ty, tw, th,
                         (tu.x0 + tx) << ss, (tu.y0 + ty) << ss});
      }
  }
  return units;
}

// derive all control rows for one plane kind; out must hold
// kNumKeys*predict_units(...).size() ints.  chunk_cap sets the max
// units per wavefront chunk (kChunk): units in the same chunk are
// mutually independent, and every dependency (the reference samples
// the unit actually reads, per its avail runs) lives in an earlier
// chunk — the device executes chunks sequentially and units within a
// chunk as one vmapped batch.  Inter units get chunk -1 (no intra-
// frame sample deps; they run as one batched pass before chunk 0).
// ff_vvc_round_mv(mv, 0, 1): affine chroma MV averaging
inline void round_mv_pair(int32_t* x, int32_t* y) {
  *x = (*x + 1 - (*x >= 0)) >> 1;
  *y = (*y + 1 - (*y >= 0)) >> 1;
}

inline void derive(const FrameOut& fr, bool is_chroma, int ctb_log2,
                   const std::vector<Unit>& units, int32_t* out,
                   int chunk_cap) {
  const int ss = (is_chroma && fr.chroma_format_idc == 1) ? 1 : 0;
  const int n = (int)units.size();
  const int ctb = 1 << ctb_log2;
  const int pic_w = fr.width >> ss;
  const int pic_h = fr.height >> ss;
  // recon bitmap granularity (min block dim); ISP sub-TUs can be one
  // sample high/wide, so ISP frames track at sample granularity
  const int g = fr.has_isp ? 1 : 2;
  const int bw = pic_w / g, bh = pic_h / g;
  std::vector<uint8_t> recon((size_t)bw * bh, 0);
  auto rec = [&](int by, int bx) -> uint8_t& {
    return recon[(size_t)by * bw + bx];
  };
  // latest (unique) writer chunk per cell; -1 = inter unit or unwritten
  std::vector<int32_t> cmap((size_t)bw * bh, -1);
  auto cm = [&](int by, int bx) -> int32_t& {
    return cmap[(size_t)by * bw + bx];
  };
  // writer unit's bottom edge (y0+h) per cell, for kCornerSrc
  std::vector<int32_t> cellbot((size_t)bw * bh, 0);
  auto cb = [&](int by, int bx) -> int32_t& {
    return cellbot[(size_t)by * bw + bx];
  };
  std::vector<int32_t> chunk_count;
  std::memset(out, 0, sizeof(int32_t) * kNumKeys * n);
  auto O = [&](Key k, int i) -> int32_t& { return out[(size_t)k * n + i]; };

  for (int i = 0; i < n; i++) {
    const Unit& u = units[i];
    const CuRecord& cu = fr.cus[u.cu_index];
    const int lx0 = u.lx0, ly0 = u.ly0;
    const int x0 = u.x0, y0 = u.y0;
    const int w = u.w, h = u.h;
    // CIIP units follow the intra (chunked) path with a blend weight;
    // EXCEPT chroma blocks of width <= 2, which stay pure MC
    // (pred_regular_chroma do_ciip, vvc_inter.c:590)
    const bool unit_ciip = cu.ciip && !(is_chroma && w <= 2);
    if (cu.pred_mode == 0 && !unit_ciip) {  // MODE_INTER
      int u_pf = cu.pf, u_r0 = cu.ref_idx, u_r1 = cu.ref_idx1;
      int u_m0x = cu.mv_x, u_m0y = cu.mv_y;
      int u_m1x = cu.mv1_x, u_m1y = cu.mv1_y;
      if (cu.dmvr) {
        // refined subblock MVs (dmvr planes); MC clamps sample reads
        // to the original-MV window (emulated_edge_dmvr)
        const size_t cell =
            (size_t)(ly0 >> 2) * (fr.width >> 2) + (lx0 >> 2);
        if (!fr.dmvr_x0.empty()) {
          u_m0x = fr.dmvr_x0[cell];
          u_m0y = fr.dmvr_y0[cell];
          u_m1x = fr.dmvr_x1[cell];
          u_m1y = fr.dmvr_y1[cell];
        }
        O(kDmvr, i) = 1;
        O(kOm0x, i) = cu.mv_x;
        O(kOm0y, i) = cu.mv_y;
        O(kOm1x, i) = cu.mv1_x;
        O(kOm1y, i) = cu.mv1_y;
        O(kBdof, i) = 0;
        if (cu.bdof && !is_chroma && !fr.dmvr_nobdof.empty())
          O(kBdof, i) = !fr.dmvr_nobdof[cell];
      }
      if (cu.sbtmvp || cu.affine) {
        // per-subblock motion lives in the exported mvf planes
        // (sb_temporal_merge_candidate / store_sb_mvs)
        const size_t cell =
            (size_t)(ly0 >> 2) * (fr.width >> 2) + (lx0 >> 2);
        u_pf = fr.mvf_pf[cell];
        u_m0x = fr.mvf_x[cell];
        u_m0y = fr.mvf_y[cell];
        u_r0 = fr.mvf_ref[cell];
        u_m1x = fr.mvf_x1[cell];
        u_m1y = fr.mvf_y1[cell];
        u_r1 = fr.mvf_ref1[cell];
        if (cu.affine && is_chroma) {
          // derive_affine_mvc: average the diagonal pair of luma
          // subblock MVs (vvc_inter.c:580-596)
          const size_t c2 =
              (size_t)((ly0 >> 2) + ss) * (fr.width >> 2) + (lx0 >> 2) + ss;
          int32_t ax = u_m0x + fr.mvf_x[c2], ay = u_m0y + fr.mvf_y[c2];
          round_mv_pair(&ax, &ay);
          u_m0x = ax;
          u_m0y = ay;
          ax = u_m1x + fr.mvf_x1[c2];
          ay = u_m1y + fr.mvf_y1[c2];
          round_mv_pair(&ax, &ay);
          u_m1x = ax;
          u_m1y = ay;
        }
      }
      O(kX0, i) = x0; O(kY0, i) = y0; O(kW, i) = w; O(kH, i) = h;
      O(kModeClass, i) = MC_INTER;
      O(kPf, i) = u_pf;
      O(kM0x, i) = u_m0x; O(kM0y, i) = u_m0y;
      O(kM1x, i) = u_m1x; O(kM1y, i) = u_m1y;
      O(kR0Idx, i) = u_r0 < 0 ? 0 : u_r0;
      O(kR1Idx, i) = u_r1 < 0 ? 0 : u_r1;
      O(kChunk, i) = -1;
      // weighted bi-prediction controls (derive_weight,
      // vvc_inter.c:149-178): BCW lookup {4,5,3,10,-2}; kWden < 0
      // selects the default average
      O(kWden, i) = -1;
      if (cu.bcw && u_pf == 3 /* PF_BI */) {
        static const int bcw_w_lut[5] = {4, 5, 3, 10, -2};
        O(kWden, i) = 2;
        O(kW1, i) = bcw_w_lut[cu.bcw];
        O(kW0, i) = 8 - bcw_w_lut[cu.bcw];
        O(kO0, i) = 0;
        O(kO1, i) = 0;
        if (is_chroma) {
          // Cr always reads the b-set (the shared chroma ctrl carries
          // Cb in the main set): BCW weights apply to both components
          O(kW0b, i) = O(kW0, i);
          O(kW1b, i) = O(kW1, i);
        }
      } else if (fr.wp_active && cu.gpm_part < 0) {
        // explicit weights; for the shared chroma ctrl, the main set
        // carries Cb and the b-set Cr (derive_weight/derive_weight_uni)
        const PredWeight& w = fr.pwt;
        const int c0 = is_chroma ? 1 : 0;
        const int r0 = u_r0 < 0 ? 0 : u_r0;
        const int r1 = u_r1 < 0 ? 0 : u_r1;
        O(kWden, i) = w.log2_denom[is_chroma ? 1 : 0];
        if (u_pf == 3) {
          O(kW0, i) = w.weight[0][c0][r0];
          O(kO0, i) = w.offset[0][c0][r0];
          O(kW1, i) = w.weight[1][c0][r1];
          O(kO1, i) = w.offset[1][c0][r1];
          if (is_chroma) {
            O(kW0b, i) = w.weight[0][2][r0];
            O(kO0b, i) = w.offset[0][2][r0];
            O(kW1b, i) = w.weight[1][2][r1];
            O(kO1b, i) = w.offset[1][2][r1];
          }
        } else {
          const int lx = u_pf - 1;
          const int rr = lx ? r1 : r0;
          O(kW0, i) = w.weight[lx][c0][rr];
          O(kO0, i) = w.offset[lx][c0][rr];
          if (is_chroma) {
            O(kW0b, i) = w.weight[lx][2][rr];
            O(kO0b, i) = w.offset[lx][2][rr];
          }
        }
      }
      // affine luma MC uses the dedicated 6-tap filter bank
      // (ff_vvc_inter_luma_filters[2]); selected via the hpel control
      O(kHpel, i) = cu.affine ? 2 : cu.hpel;
      if (cu.prof && !is_chroma) {
        O(kProf, i) = cu.prof;
        for (int k = 0; k < 8; k++)
          O(Key(kPDhx0 + k), i) = cu.pd[k];
      }
      if (!cu.dmvr) O(kBdof, i) = cu.bdof && !is_chroma;
      O(kHyp1Lx, i) = 1;  // normal bi: hypotheses on L0/L1
      if (cu.gpm_part >= 0) {
        O(kGpmPart, i) = cu.gpm_part + 1;  // 0 = not GPM
        O(kGpmTx, i) = x0 - (cu.x0 >> ss);
        O(kGpmTy, i) = y0 - (cu.y0 >> ss);
        int lw = 0, lh = 0, t;
        t = cu.w; while (t >>= 1) lw++;
        t = cu.h; while (t >>= 1) lh++;
        O(kGpmLw, i) = lw;
        O(kGpmLh, i) = lh;
        O(kHyp0Lx, i) = cu.gpm_lx0;
        O(kHyp1Lx, i) = cu.gpm_lx1;
        O(kWden, i) = -1;
      }
      for (int by = y0 / g; by < (y0 + h) / g; by++)
        for (int bx = x0 / g; bx < (x0 + w) / g; bx++) {
          rec(by, bx) = 1;
          cb(by, bx) = y0 + h;
        }
      continue;
    }
    const int raw_mode = unit_ciip ? 0
                         : (is_chroma ? cu.chroma_mode : cu.luma_mode);
    if (unit_ciip) {
      // motion + blend controls for the CIIP inter hypothesis
      O(kPf, i) = cu.pf;
      O(kM0x, i) = cu.mv_x; O(kM0y, i) = cu.mv_y;
      O(kM1x, i) = cu.mv1_x; O(kM1y, i) = cu.mv1_y;
      O(kR0Idx, i) = cu.ref_idx < 0 ? 0 : cu.ref_idx;
      O(kR1Idx, i) = cu.ref_idx1 < 0 ? 0 : cu.ref_idx1;
      O(kWden, i) = -1;  // derive_weight: no bcw/wp for ciip
      O(kHpel, i) = cu.hpel;
      O(kHyp1Lx, i) = 1;
      O(kCiipW, i) = cu.ciip_w;
    }
    const int bdpcm = is_chroma ? cu.bdpcm_c : cu.bdpcm_l;
    // MIP applies to the luma predict unit (per-TB dims, 8.4.5.2.1);
    // the chroma blocks of a MIP CU take the normal derived mode path
    const bool is_mip = !is_chroma && !unit_ciip && cu.mip >= 0 && !bdpcm;
    const bool is_cclm = is_chroma && !unit_ciip && raw_mode >= INTRA_LT_CCLM;
    const int mrl = (!is_chroma && !unit_ciip && !is_mip && !bdpcm)
                        ? cu.mrl : 0;
    // ISP luma: wide-angle mapping uses the CU dims, the reference
    // filter/smoothing is off, and angular edges extend to cb+tb
    // (prepare_intra_edge_params, vvc_intra_template.c:478-517;
    // ff_vvc_wide_angle_mode_mapping, vvc_intra.c:692-714)
    const bool isp_u = !is_chroma && !unit_ciip && cu.isp != 0;
    const int mode = (is_mip || is_cclm)
        ? 0 : wide_angle_map(raw_mode, isp_u ? cu.w : w, isp_u ? cu.h : h);
    const int mc = is_mip ? MC_MIP : is_cclm ? MC_CCLM : classify_mode(mode);
    int angle = 0, inv = 0, filter_flag = 0, ns = 0;
    const bool pdpc = !is_mip && !is_cclm && !bdpcm && !mrl &&
                      need_pdpc(w, h, mode);
    if (mc == MC_ANG_V || mc == MC_ANG_H) {
      angle = intra_pred_angle(mode);
      inv = angle ? intra_inv_angle(angle) : 0;
      if (!is_chroma && !mrl && !isp_u) {  // MRL/ISP: filter_flag = 0
        if (ref_filter_flag(mode)) {
          filter_flag = 0;
        } else {
          int min_dist = std::min(std::abs(mode - 50), std::abs(mode - 18));
          static const int thres[5] = {24, 14, 2, 0, 0};
          int ntbs = ((bitlen(w) - 1) + (bitlen(h) - 1)) >> 1;
          filter_flag = min_dist > thres[ntbs - 2] ? 1 : 0;
        }
      }
      if (pdpc) ns = nscale(w, h, mode);
    }
    const int smooth =
        (!is_mip && !mrl && !isp_u && !is_chroma && w * h > 32 &&
         ref_filter_flag(mode)) ? 1 : 0;
    int left_size, top_size, unfilter_last, need_l, need_t;
    if (mc == MC_MIP) {
      // MIP reads unfiltered top[0..w) / left[0..h) (pred_mip,
      // vvc_intra_template.c:773-825); no ref filter, no PDPC
      left_size = h; top_size = w; unfilter_last = 1;
      need_l = h; need_t = w;
    } else if (mc == MC_CCLM) {
      // the avail runs carry the CCLM select-sample counts
      // (cclm_get_select_pos, vvc_intra_template.c:61-87)
      const int mn = w < h ? w : h;
      unfilter_last = 1;
      if (raw_mode == INTRA_LT_CCLM) { need_t = w; need_l = h; }
      else if (raw_mode == INTRA_L_CCLM) { need_t = 0; need_l = h + mn; }
      else { need_t = w + mn; need_l = 0; }
      left_size = need_l; top_size = need_t;
    } else if (mc == MC_PLANAR) {
      left_size = h + 1 + smooth; top_size = w + 1 + smooth;
      unfilter_last = 0; need_l = left_size; need_t = top_size;
    } else if (mc == MC_DC) {
      left_size = h; top_size = w; unfilter_last = 1;
      need_l = h; need_t = w;
    } else if (mc == MC_VERT) {
      left_size = pdpc ? h : 1; top_size = w; unfilter_last = 1;
      need_l = left_size; need_t = w;
    } else if (mc == MC_HORZ) {
      left_size = h; top_size = pdpc ? w : 1; unfilter_last = 1;
      need_l = h; need_t = top_size;
    } else {
      // angular: refw/refh = 2*tb, or cb+tb under ISP
      const int refw = isp_u ? cu.w + w : 2 * w;
      const int refh = isp_u ? cu.h + h : 2 * h;
      left_size = refh; top_size = refw; unfilter_last = 1;
      need_l = refh; need_t = refw;
    }

    // availability (parity ff_vvc_get_left/top_available, vvc_intra.c);
    // intra reference samples never cross tile boundaries
    const int ctb_rx = lx0 >> ctb_log2, ctb_ry = ly0 >> ctb_log2;
    int tlx0 = 0, tlx1 = fr.width;
    for (size_t k = 1; k < fr.tile_col_bd.size(); k++)
      if (fr.tile_col_bd[k] > lx0) {
        tlx0 = fr.tile_col_bd[k - 1];
        tlx1 = std::min(fr.width, (int)fr.tile_col_bd[k]);
        break;
      }
    int tly0 = 0;
    for (size_t k = 1; k < fr.tile_row_bd.size(); k++)
      if (fr.tile_row_bd[k] > ly0) {
        tly0 = fr.tile_row_bd[k - 1];
        break;
      }
    const bool ctb_left = lx0 > tlx0, ctb_up = ly0 > tly0;
    const int end_of_ctb_x = (ctb_rx + 1) << ctb_log2;
    const int end_of_ctb_y = (ctb_ry + 1) << ctb_log2;
    const int log2_ctb_c = ctb_log2 - ss;
    const int y0b_c = y0 & ((1 << log2_ctb_c) - 1);
    const int x0b_c = x0 & ((1 << log2_ctb_c) - 1);
    const int tile_w_c = (tlx1 >> ss) - x0;  // to the tile's right edge

    int avail_t;
    if (y0b_c == 0) {
      avail_t = ctb_up ? std::min(need_t,
                                  std::min(pic_w - x0, tile_w_c)) : 0;
      // WPP: the above-right CTU is not yet decoded in the wavefront;
      // the top reference run stops at the current CTU's right edge
      // (ff_vvc_get_top_available, vvc_intra.c:605-609)
      if (fr.wpp)
        avail_t = std::min(avail_t, (end_of_ctb_x >> ss) - x0);
    } else {
      int max_x = std::min(fr.width, end_of_ctb_x) >> ss;
      int tgt = std::max(0, std::min(need_t, max_x - x0));
      int run = 0;
      int ry_ = (y0 - 1) / g;
      while (run < tgt && rec(ry_, (x0 + run) / g))
        run += g - ((x0 + run) % g);
      avail_t = std::min(run, tgt);
    }
    int avail_l;
    if (x0b_c == 0 && !ctb_left) {
      avail_l = 0;
    } else {
      int max_y = std::min(fr.height, end_of_ctb_y) >> ss;
      int tgt = std::max(0, std::min(need_l, max_y - y0));
      if (x0b_c == 0) {
        avail_l = tgt;
      } else {
        int run = 0;
        int cx_ = (x0 - 1) / g;
        while (run < tgt && rec((y0 + run) / g, cx_))
          run += g - ((y0 + run) % g);
        avail_l = std::min(run, tgt);
      }
    }

    // cand_up_left from LUMA coords (ff_vvc_set_neighbour_available)
    const int x0b_l = lx0 & (ctb - 1), y0b_l = ly0 & (ctb - 1);
    const bool cand_left = ctb_left || x0b_l;
    const bool cand_up = ctb_up || y0b_l;
    const int cul = (x0b_l || y0b_l) ? (cand_left && cand_up ? 1 : 0)
                                     : (ctb_left && ctb_up ? 1 : 0);

    // wavefront chunk: after every intra-frame sample dependency
    // (the avail runs + corner are exactly what edge_arrays reads)
    // MRL reads rows/cols out to -1-mrl: widen the dependency stencil
    int dep = -1;
    const int byt0 = std::max(0, (y0 - 1 - mrl) / g);
    const int bxl0 = std::max(0, (x0 - 1 - mrl) / g);
    if (avail_t > 0) {
      for (int by = byt0; by <= (y0 - 1) / g; by++)
        for (int bx = x0 / g; bx <= (x0 + avail_t - 1) / g; bx++)
          dep = std::max(dep, cm(by, bx));
    }
    if (avail_l > 0) {
      for (int bx = bxl0; bx <= (x0 - 1) / g; bx++)
        for (int by = y0 / g; by <= (y0 + avail_l - 1) / g; by++)
          dep = std::max(dep, cm(by, bx));
    }
    if (cul && x0 > 0 && y0 > 0)
      for (int by = byt0; by <= (y0 - 1) / g; by++)
        for (int bx = bxl0; bx <= (x0 - 1) / g; bx++)
          dep = std::max(dep, cm(by, bx));
    int chunk = dep + 1;
    while ((int)chunk_count.size() <= chunk) chunk_count.push_back(0);
    while (chunk_count[chunk] >= chunk_cap) {
      chunk++;
      if ((int)chunk_count.size() <= chunk) chunk_count.push_back(0);
    }
    chunk_count[chunk]++;

    // corner source for the line-buffer kernel (before marking self)
    if (x0 > 0 && y0 > 0)
      O(kCornerSrc, i) = cb((y0 - 1) / g, (x0 - 1) / g) == y0 ? 0 : 1;

    for (int by = y0 / g; by < (y0 + h) / g; by++)
      for (int bx = x0 / g; bx < (x0 + w) / g; bx++) {
        rec(by, bx) = 1;
        cm(by, bx) = chunk;
        cb(by, bx) = y0 + h;
      }

    O(kX0, i) = x0; O(kY0, i) = y0; O(kW, i) = w; O(kH, i) = h;
    O(kLogW, i) = bitlen(w) - 1; O(kLogH, i) = bitlen(h) - 1;
    O(kModeClass, i) = mc; O(kAngle, i) = angle; O(kInvAngle, i) = inv;
    O(kFilterFlag, i) = filter_flag; O(kSmooth, i) = smooth;
    O(kLeftSize, i) = left_size; O(kTopSize, i) = top_size;
    O(kUnfilterLastOne, i) = unfilter_last;
    O(kDoPdpc, i) = pdpc ? 1 : 0; O(kNscale, i) = ns;
    O(kAvailL, i) = avail_l; O(kAvailT, i) = avail_t;
    O(kCandUpLeft, i) = cul;
    O(kProjV, i) = (mc == MC_ANG_V && angle < 0) ? 1 : 0;
    O(kProjH, i) = (mc == MC_ANG_H && angle < 0) ? 1 : 0;
    O(kChunk, i) = chunk;
    if (is_mip) {
      // size id from the predict unit's (TB) dims (8.4.5.2.1)
      int size_id = (w == 4 && h == 4) ? 0
                    : ((w == 4 || h == 4) || (w == 8 && h == 8)) ? 1 : 2;
      static const int base[3] = {0, 16, 24};
      O(kMipId, i) = base[size_id] + cu.mip;
      O(kMipT, i) = cu.mip_t;
      O(kMipSz, i) = size_id;
    } else {
      O(kMipId, i) = -1;
    }
    O(kMrl, i) = mrl;
    if (is_cclm) {
      const int variant = raw_mode - INTRA_LT_CCLM;  // 0 LT / 1 L / 2 T
      O(kCclm, i) = 1 + variant;
      // binary luma availability stops at the tile (or picture) edge
      const bool at_bin = ly0 > tly0, al_bin = lx0 > tlx0;
      // bit 0: vertical-collocated stencil; bit 1: block starts at a
      // CTU row (line-buffer single-row top-pick filter); bits 2/3:
      // block-level left/top binary availability (tile-aware; drives
      // the pick-filter edge substitution, cclm_select_luma)
      O(kCclmVC, i) = fr.cclm_vc + 2 * (y0b_c == 0 ? 1 : 0) +
                      4 * (al_bin ? 1 : 0) + 8 * (at_bin ? 1 : 0);
      const int num_is4 = (variant != 0 || !at_bin || !al_bin) ? 1 : 0;
      const int num_t = avail_t, num_l = avail_l;  // runs (see above)
      const int cnt_t = std::min(num_t, (1 + num_is4) << 1);
      const int cnt_l = std::min(num_l, (1 + num_is4) << 1);
      O(kCclmCT, i) = cnt_t;
      O(kCclmCL, i) = cnt_l;
      int pos[4] = {0, 0, 0, 0}, np = 0;
      const int start_t = num_t >> (2 + num_is4);
      const int step_t = std::max(1, num_t >> (1 + num_is4));
      for (int c = 0; c < cnt_t; c++) pos[np++] = start_t + c * step_t;
      const int start_l = num_l >> (2 + num_is4);
      const int step_l = std::max(1, num_l >> (1 + num_is4));
      for (int c = 0; c < cnt_l && np < 4; c++)
        pos[np++] = start_l + c * step_l;
      O(kCclmP0, i) = pos[0];
      O(kCclmP1, i) = pos[1];
      O(kCclmP2, i) = pos[2];
      O(kCclmP3, i) = pos[3];
    }
  }
}

}  // namespace ctrl

// LFNST transform-set selection by intra mode (spec table 38;
// parity ff_vvc_lfnst_tr_set_index, vvc_data.c:1631)
static const uint8_t kLfnstTrSet[95] = {
    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1
};

// motion field entry (mirror of ffmpeg_tpu/encoder/mvs.py MvField)
// normative GPM geometry tables (spec tables 36/123; extracted values
// cross-check tools/extract_transform_matrices.py / vvc_data.c:1998)
constexpr int kGpmAngleIdx[64] = {0, 0, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 8, 8, 11, 11, 11, 11, 12, 12, 12, 12, 13, 13, 13, 13, 14, 14, 14, 14, 16, 16, 18, 18, 18, 19, 19, 19, 20, 20, 20, 21, 21, 21, 24, 24, 27, 27, 27, 28, 28, 28, 29, 29, 29, 30, 30, 30};
constexpr int kGpmDistanceIdx[64] = {1, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 1, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 1, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3};
constexpr int kGpmDistanceLut[32] = {8, 8, 8, 8, 4, 4, 2, 1, 0, -1, -2, -4, -4, -8, -8, -8, -8, -8, -8, -8, -4, -4, -2, -1, 0, 1, 2, 4, 4, 8, 8, 8};

// Collocated-picture motion store for TMVP, shared across decoder
// instances: frame-parallel parsing threads publish each picture's
// motion field and wait here for their collocated picture (the
// reference serializes this through its per-frame progress waits,
// vvc_thread.c).  Keyed by POC; reset per decode session.
struct ColData {
  int poc = 0;
  int pu_w = 0, pu_h = 0;
  std::vector<MvF> mvf;  // 4x4 granularity
  int32_t ref_pocs[2][16] = {};
  int nb_refs[2] = {0, 0};
};
// Collocated-motion store scoped per decode *session* (a pool of
// Decoder handles parsing one stream).  Keyed by (idr_epoch, poc): POC
// restarts near 0 after an IDR, so a bare-POC key would let a stale
// prior-GOP entry satisfy the wait under parse-ahead.  Each Decoder
// defaults to a private store; sessions share one via
// vvch_set_colstore so frame-parallel workers can exchange fields.
struct ColStore {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::pair<int, int>, std::shared_ptr<ColData>> map;

  void publish(int epoch, int poc, std::shared_ptr<ColData> d) {
    std::lock_guard<std::mutex> lk(mu);
    map[{epoch, poc}] = std::move(d);
    cv.notify_all();
  }
  std::shared_ptr<ColData> wait(int epoch, int poc) {
    std::unique_lock<std::mutex> lk(mu);
    auto key = std::make_pair(epoch, poc);
    // generous guard: publication can legitimately trail by minutes
    // when the main thread sits in first-frame XLA compilation (DMVR
    // defers publication until after device work)
    if (!cv.wait_for(lk, std::chrono::seconds(600),
                     [&] { return map.count(key) > 0; }))
      return nullptr;
    return map[key];
  }
  void reset() {
    std::lock_guard<std::mutex> lk(mu);
    map.clear();
  }
};

class Decoder {
 public:
  int decode_au(const uint8_t* data, size_t size, std::string* err) {
    try {
      auto nals = split_annexb(data, size);
      for (auto& nal : nals) {
        BitReader r(nal.rbsp.data(), nal.rbsp.size());
        switch (nal.type) {
          case NAL_SPS:
            sps_ = parse_sps(r);
            has_sps_ = true;
            break;
          case NAL_PPS:
            VVC_UNSUPPORTED(!has_sps_, "PPS before SPS");
            pps_ = parse_pps(r, sps_);
            has_pps_ = true;
            break;
          case NAL_PH:
            VVC_UNSUPPORTED(!has_sps_ || !has_pps_, "PH before SPS/PPS");
            ph_ = parse_picture_header_nal(r, sps_, pps_);
            has_ph_ = true;
            break;
          case NAL_PREFIX_APS:
          case NAL_SUFFIX_APS: {
            Aps aps = parse_aps(r);
            if (aps.aps_params_type == 1)  // LMCS
              aps_lmcs_[aps.id & 3] = aps;
            else if (aps.aps_params_type == 0)  // ALF
              aps_alf_[aps.id & 7] = aps;
            else if (aps.aps_params_type == 2)  // SCALING
              aps_sl_[aps.id & 7] = aps;
            break;
          }
          default:
            if (nal_is_slice(nal.type)) {
              VVC_UNSUPPORTED(!has_sps_ || !has_pps_, "slice before SPS/PPS");
              decode_slice(nal, r);
            }
            break;
        }
      }
      return 0;
    } catch (const std::exception& e) {
      *err = e.what();
      return -1;
    }
  }

  FrameOut out;
  bool frame_ready = false;
  // session-shared collocated store + this AU's IDR epoch (set by the
  // session layer before each decode_au; default: private store)
  ColStore* colstore = nullptr;
  ColStore own_colstore;
  int epoch = 0;

  ColStore& cols() { return colstore ? *colstore : own_colstore; }

 private:
  Sps sps_;
  Pps pps_;
  Aps aps_lmcs_[4];
  Aps aps_alf_[8];
  Aps aps_sl_[8];
  bool has_sps_ = false, has_pps_ = false;
  PictureHeader ph_;  // active header from a separate PH NAL
  bool has_ph_ = false;

  // parse-time state
  CabacStates ctxs_;
  CabacDecoder* cd_ = nullptr;
  SliceHeader sh_;
  int min_cb_log2_ = 2;
  int mcb_w_ = 0, mcb_h_ = 0;  // min-cb grid dims
  std::vector<int32_t> tab_ipm_, tab_cpm_, tab_imf_;
  std::vector<int32_t> tab_cbw_, tab_cbh_, tab_cqt_;
  // chroma-tree (ch_type 1) neighbour tables: written by dual-tree
  // chroma CUs, read by the chroma tree's split/pred ctx derivations
  // (the reference's tab.cb_width[1] etc., vvc_ctu.h:273)
  std::vector<int32_t> tab_cbw_c_, tab_cbh_c_, tab_cqt_c_, tab_cpm_c_;
  // MTT split modes at 32x32 granularity, mtt_depth 0 and 1 (TAB_MSM,
  // get_cclm_enabled's 64x64 luma-split probe, vvc_ctu.c:2066-2068)
  std::vector<int32_t> tab_msm_[2];
  int msm_w_ = 0, msm_h_ = 0;
  std::vector<int32_t> tab_ispmf_;  // 64-aligned ISP markers (TAB_ISPMF)
  int ispmf_w_ = 0;
  int prev_tu_cbf_y_ = 0;      // lc->parse.prev_tu_cbf_y (ISP cbf ctx)
  int infer_tu_cbf_luma_ = 1;  // lc->parse.infer_tu_cbf_luma
  bool ctb_left_ = false, ctb_up_ = false;
  // current tile bounds in luma samples (whole picture when no tiles)
  int tile_x0_ = 0, tile_y0_ = 0, tile_x1_ = 0, tile_y1_ = 0;
  int qp_y_ = 26;
  // MTS parse state, reset per coded CU (vvc_ctu.c:1805-1806)
  int mts_zero_out_ = 1, mts_dc_only_ = 1;
  int cu_first_tb_ts_ = -1;  // ts of the CU's first luma TB (mts gate)
  int cu_any_coded_ts_ = 0;  // any coded TB used transform skip
  // LFNST parse state (vvc_cabac.c:2383-2389, vvc_ctu.c:791-839)
  int lfnst_dc_only_ = 1, lfnst_zero_out_ = 1;
  // cu_qp_delta quantization-group state (vvc_ctu.c:77-171, 2043-2046)
  int qg_x_ = 0, qg_y_ = 0;
  int is_first_qg_ = 1;
  int is_cu_qp_delta_coded_ = 0;
  int cu_qp_delta_subdiv_ = 0;
  std::vector<int32_t> tab_qpy_;  // final QpY per min-CB (predictor tab)
  // slice-level partition constraints (spec 7.4.8): [0] = luma (intra
  // or inter per slice type), [1] = chroma tree (dual-tree intra)
  struct PartConstraints {
    int min_qt, max_bt, max_tt, max_mtt;
  };
  PartConstraints part_[2];

  // tree/mode types (reference vvc_ctu.h VVCTreeType / VVCModeType)
  enum { TREE_SINGLE = 0, TREE_LUMA = 1, TREE_CHROMA = 2 };
  enum { MT_ALL = 0, MT_INTRA = 1, MT_INTER = 2 };

  // ---- motion state (mirror of ffmpeg_tpu/encoder/mvs.py) ----
  std::vector<MvF> mvf_;       // 4x4 plane
  std::shared_ptr<ColData> col_;  // collocated picture (TMVP)
  int no_backward_ = 1;
  int ref_idx_sym_[2] = {-1, -1};  // RefIdxSymL0/L1 (SMVD, vvcdec.c:363)
  std::vector<uint8_t> mvf_set_;
  int pu_w_ = 0, pu_h_ = 0;
  std::vector<MvF> hmvp_;
  std::vector<int32_t> tab_skip_;
  std::vector<int32_t> tab_msf_;  // per-min-cb msf|iaf union (subblock
                                  // merge or AMVP affine; feeds the
                                  // get_inter_flag_inc ctx, tab.msf/iaf)
  std::vector<int32_t> tab_mmi_;  // per-min-cb motion model idc
  std::vector<int32_t> tab_cbx_, tab_cby_;  // CU origin per min-cb
  // per-min-cb affine control-point MVs: [(cell*3 + cp)*2 + comp]
  std::vector<int32_t> tab_cpmv_[2];

  MvF& mvf_at(int x, int y) { return mvf_[(size_t)(y >> 2) * pu_w_ + (x >> 2)]; }

  void set_mvf(int x0, int y0, int w, int h, const MvF& f) {
    for (int y = y0 >> 2; y < (y0 + h) >> 2; y++)
      for (int x = x0 >> 2; x < (x0 + w) >> 2; x++) {
        mvf_[(size_t)y * pu_w_ + x] = f;
        mvf_set_[(size_t)y * pu_w_ + x] = 1;
      }
  }

  bool decoded_at(int x, int y) const {
    if (x < 0 || y < 0 || x >= pps_.width || y >= pps_.height) return false;
    return mvf_set_[(size_t)(y >> 2) * pu_w_ + (x >> 2)];
  }

  struct Nb {
    int x, y;
    bool pre_ok;
  };
  // neighbour geometry (vvc_mvs.c:573-596); prediction dependencies
  // stop at tile boundaries (tile_* bounds; single slice per picture)
  void neighbours(int x0, int y0, int w, int h, Nb nbs[7]) {
    int ctb = sps_.ctb_size_y;
    int x0b = x0 & (ctb - 1), y0b = y0 & (ctb - 1);
    bool ctb_left = x0 > tile_x0_, ctb_up = y0 > tile_y0_;
    bool cand_left = ctb_left || x0b;
    bool cand_up = ctb_up || y0b;
    bool cand_up_left = (x0b || y0b) ? (cand_left && cand_up)
                                     : (ctb_left && ctb_up);
    bool sap = (x0b + w == ctb) ? (ctb_up && !y0b) : cand_up;
    bool cand_up_right = sap && (x0 + w) < std::min(pps_.width, tile_x1_);
    // WPP (1-CTU sync delay): neighbours in a CTU column right of the
    // current CU's CTU are not yet decoded in the wavefront and are
    // unavailable (check_available, vvc_mvs.c:607)
    if (sps_.sps_entropy_coding_sync_enabled_flag)
      cand_up_right = cand_up_right &&
          ((x0 + w) >> sps_.ctb_log2_size_y) <= (x0 >> sps_.ctb_log2_size_y);
    bool a0_ok;
    if (!x0b && !ctb_left) {
      a0_ok = false;
    } else {
      int max_y = std::min(pps_.height,
                           (((y0 >> sps_.ctb_log2_size_y) + 1)
                            << sps_.ctb_log2_size_y));
      a0_ok = (y0 + h < max_y) && decoded_at(x0 - 1, y0 + h);
    }
    nbs[0] = {x0 - 1, y0 + h, a0_ok};                 // A0
    nbs[1] = {x0 - 1, y0 + h - 1, cand_left};         // A1
    nbs[2] = {x0 - 1, y0, cand_left};                 // A2
    nbs[3] = {x0 + w, y0 - 1, cand_up_right};         // B0
    nbs[4] = {x0 + w - 1, y0 - 1, cand_up};           // B1
    nbs[5] = {x0 - 1, y0 - 1, cand_up_left};          // B2
    nbs[6] = {x0, y0 - 1, cand_up};                   // B3
  }

  const MvF* check_nb(const Nb& nb) {
    if (!nb.pre_ok) return nullptr;
    if (!decoded_at(nb.x, nb.y)) return nullptr;
    MvF& f = mvf_at(nb.x, nb.y);
    if (f.pred_flag == PF_INTRA) return nullptr;
    return &f;
  }

  static void round_mv(int32_t* x, int32_t* y, int lshift, int rshift) {
    if (rshift) {
      int off = 1 << (rshift - 1);
      *x = ((*x + off - (*x >= 0)) >> rshift) * (1 << lshift);
      *y = ((*y + off - (*y >= 0)) >> rshift) * (1 << lshift);
    } else {
      *x <<= lshift;
      *y <<= lshift;
    }
  }

  // merge candidate list (vvc_mvs.c:637-830; translational, no TMVP)
  // parity: mv_compression + ff_vvc_mv_scale + check_mvset +
  // derive_temporal_colocated_mvs + temporal_luma_motion_vector
  // (vvc_mvs.c:46-246)
  static int32_t clip_intp2_17(int64_t v) {
    const int64_t lim = 1LL << 17;
    return (int32_t)(v < -lim ? -lim : (v > lim - 1 ? lim - 1 : v));
  }

  static int32_t mv_compress1(int32_t v) {
    const int s = v >> 17;
    unsigned u = (unsigned)((v ^ s) | 31);
    int log2 = 31 - __builtin_clz(u);
    const int f = log2 - 4;
    const int mask = (-1 * (1 << f)) >> 1;
    const int round = (1 << f) >> 2;
    return (v + round) & mask;
  }

  static void mv_scale(int32_t* dst, const int32_t* src, int td, int tb) {
    td = td < -128 ? -128 : (td > 127 ? 127 : td);
    tb = tb < -128 ? -128 : (tb > 127 ? 127 : tb);
    int tx = (0x4000 + (std::abs(td) >> 1)) / td;
    int64_t sf = ((int64_t)tb * tx + 32) >> 6;
    sf = sf < -(1 << 12) ? -(1 << 12) : (sf > (1 << 12) - 1 ? (1 << 12) - 1
                                                            : sf);
    for (int i = 0; i < 2; i++) {
      int64_t p = sf * src[i];
      dst[i] = clip_intp2_17((p + 127 + (p < 0)) >> 8);
    }
  }

  int check_mvset(const MvF& tc, int list_col, int ref_idx_lx, int X,
                  int32_t* mv_out) {
    int col_poc_diff = col_->poc - col_->ref_pocs[list_col][tc.ref_idx[list_col]];
    int cur_poc_diff = out.poc - out.ref_pocs[X][ref_idx_lx];
    int32_t mv_col[2] = {mv_compress1(tc.mv[list_col][0]),
                         mv_compress1(tc.mv[list_col][1])};
    if (col_poc_diff == cur_poc_diff) {
      mv_out[0] = clip_intp2_17(mv_col[0]);
      mv_out[1] = clip_intp2_17(mv_col[1]);
    } else {
      mv_scale(mv_out, mv_col, col_poc_diff, cur_poc_diff);
    }
    return 1;
  }

  int derive_col_mv(const MvF& tc, int ref_idx_lx, int X, int32_t* mv_out) {
    if (tc.pred_flag == PF_INTRA) return 0;
    int list_col;
    if (!(tc.pred_flag & PF_L0))
      list_col = 1;
    else if (tc.pred_flag == PF_L0)
      list_col = 0;
    else {  // BI
      if (no_backward_)
        list_col = X;
      else
        list_col = sh_.sh_collocated_from_l0_flag ? 1 : 0;
    }
    return check_mvset(tc, list_col, ref_idx_lx, X, mv_out);
  }

  bool temporal_mv(int x0, int y0, int w, int h, int ref_idx_lx, int X,
                   bool check_center, int32_t* mv_out) {
    if (!col_ || !sh_.ph.ph_temporal_mvp_enabled_flag || w * h <= 32)
      return false;
    int x = x0 + w, y = y0 + h;
    if ((y0 >> sps_.ctb_log2_size_y) == (y >> sps_.ctb_log2_size_y) &&
        y < pps_.height && x < pps_.width) {
      int xc = x & ~7, yc = y & ~7;
      const MvF& tc = col_->mvf[(size_t)(yc >> 2) * col_->pu_w + (xc >> 2)];
      if (derive_col_mv(tc, ref_idx_lx, X, mv_out)) return true;
    }
    if (check_center) {
      int xc = (x0 + (w >> 1)) & ~7, yc = (y0 + (h >> 1)) & ~7;
      const MvF& tc = col_->mvf[(size_t)(yc >> 2) * col_->pu_w + (xc >> 2)];
      if (derive_col_mv(tc, ref_idx_lx, X, mv_out)) return true;
    }
    return false;
  }

  // -- SbTMVP (8.5.5.3/8.5.5.4; sb_temporal_merge_candidate +
  // sb_temporal_luma_motion_data, vvc_mvs.c:1000-1120) ---------------
  // colocated fetch, sb_flag variant of derive_temporal_colocated_mvs
  // (vvc_mvs.c:150-162): prefer the matching list, fall back to the
  // other only when NoBackwardPredFlag
  int derive_col_mv_sb(const MvF& tc, int X, int32_t* mv_out) {
    if (tc.pred_flag == PF_INTRA) return 0;
    if (tc.pred_flag & (X + 1)) return check_mvset(tc, X, 0, X, mv_out);
    if (no_backward_ && (tc.pred_flag & (2 - X)))
      return check_mvset(tc, 1 - X, 0, X, mv_out);
    return 0;
  }

  // sb_clip_location + colocated motion at (x, y) shifted by temp_mv
  // (sb_temproal_luma_motion, vvc_mvs.c:1005-1030)
  void sb_col_motion(int x_ctb, int y_ctb, const int32_t* tmv, int x,
                     int y, bool is_b, MvF* m) {
    const int ctb = 1 << sps_.ctb_log2_size_y;
    int yy = y + tmv[1];
    int ylim = std::min(pps_.height - 1, y_ctb + ctb - 1);
    yy = (yy < y_ctb ? y_ctb : (yy > ylim ? ylim : yy)) & ~7;
    int xx = x + tmv[0];
    int xlim = std::min(pps_.width - 1, x_ctb + ctb + 3);
    xx = (xx < x_ctb ? x_ctb : (xx > xlim ? xlim : xx)) & ~7;
    const MvF& tc = col_->mvf[(size_t)(yy >> 2) * col_->pu_w + (xx >> 2)];
    m->pred_flag = 0;
    m->ref_idx[0] = 0;
    m->ref_idx[1] = 0;
    int32_t mv[2];
    if (derive_col_mv_sb(tc, 0, mv)) {
      m->pred_flag |= PF_L0;
      m->mv[0][0] = mv[0];
      m->mv[0][1] = mv[1];
    }
    if (is_b && derive_col_mv_sb(tc, 1, mv)) {
      m->pred_flag |= PF_L1;
      m->mv[1][0] = mv[0];
      m->mv[1][1] = mv[1];
    }
  }

  struct AffMi {
    int pf = 0;
    int ref_idx[2] = {0, 0};
    int bcw = 0;
    int mmi = 1;               // motion model idc (1=4param, 2=6param)
    int32_t cp[2][3][2] = {};  // [list][cp][x/y], 1/16 pel
  };

  // merge_data_subblock + sb_mv_merge_mode (vvc_mvs.c:1396-1445):
  // SbCol, inherited affine A/B, constructed affine 1-6, then the
  // zero-CPMV fallback (translational zero when affine is off).
  void sb_merge_mode(CuRecord& cu, int x0, int y0, int w, int h,
                     bool is_b, int merge_idx) {
    cu.sbtmvp = 1;
    cu.bcw = 0;
    cu.hpel = 0;
    cu.mv_x = cu.mv_y = cu.mv1_x = cu.mv1_y = 0;
    cu.ref_idx = 0;
    cu.ref_idx1 = 0;
    int num_cands = 0;
    Nb nbs[7];
    neighbours(x0, y0, w, h, nbs);
    // SbCol: derives + stores its subblock motion immediately (a later
    // candidate overwrites it when not selected)
    if (sps_.sps_sbtmvp_enabled_flag &&
        sh_.ph.ph_temporal_mvp_enabled_flag && !(w < 8 && h < 8)) {
      MvF ctr;
      ctr.pred_flag = 0;
      int32_t tmv[2] = {0, 0};
      if (col_) {
        // shift vector from A1 when it references the collocated picture
        const MvF* a1 = check_nb(nbs[1]);
        if (a1) {
          if ((a1->pred_flag & PF_L0) &&
              col_->poc == out.ref_pocs[0][a1->ref_idx[0]]) {
            tmv[0] = a1->mv[0][0];
            tmv[1] = a1->mv[0][1];
          } else if ((a1->pred_flag & PF_L1) &&
                     col_->poc == out.ref_pocs[1][a1->ref_idx[1]]) {
            tmv[0] = a1->mv[1][0];
            tmv[1] = a1->mv[1][1];
          }
          round_mv(&tmv[0], &tmv[1], 0, 4);
        }
        const int x_ctb =
            (x0 >> sps_.ctb_log2_size_y) << sps_.ctb_log2_size_y;
        const int y_ctb =
            (y0 >> sps_.ctb_log2_size_y) << sps_.ctb_log2_size_y;
        sb_col_motion(x_ctb, y_ctb, tmv, x0 + w / 2, y0 + h / 2, is_b,
                      &ctr);
        if (ctr.pred_flag) {
          for (int sy = y0; sy < y0 + h; sy += 8)
            for (int sx = x0; sx < x0 + w; sx += 8) {
              MvF m;
              sb_col_motion(x_ctb, y_ctb, tmv, sx + 4, sy + 4, is_b, &m);
              if (!m.pred_flag) m = ctr;
              set_mvf(sx, sy, 8, 8, m);
            }
          if (merge_idx == num_cands) {
            cu.pf = ctr.pred_flag;
            return;
          }
          num_cands++;
        }
      }
    }
    AffMi mi;
    if (sps_.sps_affine_enabled_flag) {
      static const int ak[] = {0, 1};     // A0, A1
      static const int bk[] = {3, 4, 5};  // B0, B1, B2
      if (affine_merge_from_nbs(x0, y0, w, h, nbs, ak, 2, &mi)) {
        if (merge_idx == num_cands) {
          finish_sb_affine(cu, mi, x0, y0, w, h);
          return;
        }
        num_cands++;
      }
      if (affine_merge_from_nbs(x0, y0, w, h, nbs, bk, 3, &mi)) {
        if (merge_idx == num_cands) {
          finish_sb_affine(cu, mi, x0, y0, w, h);
          return;
        }
        num_cands++;
      }
      static const int tl[] = {5, 6, 2};  // B2, B3, A2
      static const int tr[] = {4, 3};     // B1, B0
      static const int bl[] = {1, 0};     // A1, A0
      const MvF* c0 = derive_corner_mvf(nbs, tl, 3);
      const MvF* c1 = derive_corner_mvf(nbs, tr, 2);
      const MvF* c2 = derive_corner_mvf(nbs, bl, 2);
      if (sps_.sps_6param_affine_enabled_flag) {
        if (affine_const1(c0, c1, c2, &mi)) {
          if (merge_idx == num_cands) {
            finish_sb_affine(cu, mi, x0, y0, w, h);
            return;
          }
          num_cands++;
        }
        MvF corner3;
        const MvF* c3 = nullptr;
        if (sh_.ph.ph_temporal_mvp_enabled_flag) {
          bool a0 = temporal_mv(x0, y0, w, h, 0, 0, false, corner3.mv[0]);
          bool a1v = is_b
                         ? temporal_mv(x0, y0, w, h, 0, 1, false,
                                       corner3.mv[1])
                         : false;
          corner3.pred_flag = (a0 ? 1 : 0) | ((a1v ? 1 : 0) << 1);
          corner3.ref_idx[0] = 0;
          corner3.ref_idx[1] = 0;
          if (corner3.pred_flag) c3 = &corner3;
        }
        if (affine_const2(c0, c1, c3, &mi)) {
          if (merge_idx == num_cands) {
            finish_sb_affine(cu, mi, x0, y0, w, h);
            return;
          }
          num_cands++;
        }
        if (affine_const3(c0, c2, c3, &mi)) {
          if (merge_idx == num_cands) {
            finish_sb_affine(cu, mi, x0, y0, w, h);
            return;
          }
          num_cands++;
        }
        if (affine_const4(c1, c2, c3, &mi)) {
          if (merge_idx == num_cands) {
            finish_sb_affine(cu, mi, x0, y0, w, h);
            return;
          }
          num_cands++;
        }
      }
      if (affine_const5(c0, c1, &mi)) {
        if (merge_idx == num_cands) {
          finish_sb_affine(cu, mi, x0, y0, w, h);
          return;
        }
        num_cands++;
      }
      if (affine_const6(c0, c2, w, h, &mi)) {
        if (merge_idx == num_cands) {
          finish_sb_affine(cu, mi, x0, y0, w, h);
          return;
        }
        num_cands++;
      }
    }
    // zero candidate (affine_merge_zero_motion)
    mi = AffMi();
    mi.pf = PF_L0 + ((is_b ? 1 : 0) << 1);
    mi.mmi = 1;
    finish_sb_affine(cu, mi, x0, y0, w, h);
  }

  void finish_sb_affine(CuRecord& cu, const AffMi& mi, int x0, int y0,
                        int w, int h) {
    cu.affine = 1;
    cu.pf = mi.pf;
    cu.bcw = mi.bcw;
    set_cb_tab(tab_mmi_, x0, y0, w, h, mi.mmi);
    store_sb_mvs(cu, mi, x0, y0, w, h);
  }

  // ================= affine motion (8.5.5; vvc_mvs.c:838-1300) =======
  static int ilog2(int v) {
    int l = 0;
    while (v >>= 1) l++;
    return l;
  }

  void store_cp_mv(const AffMi& mi, int x0, int y0, int w, int h, int lx) {
    int xs = x0 >> min_cb_log2_, ys = y0 >> min_cb_log2_;
    for (int y = 0; y < (h >> min_cb_log2_); y++)
      for (int x = 0; x < (w >> min_cb_log2_); x++) {
        int32_t* d = &tab_cpmv_[lx][((size_t)(ys + y) * mcb_w_ + xs + x) * 6];
        for (int c = 0; c < 3; c++) {
          d[c * 2] = mi.cp[lx][c][0];
          d[c * 2 + 1] = mi.cp[lx][c][1];
        }
      }
  }

  struct SbParams {
    int dhx, dvx, dhy, dvy, sh, sv, fallback;
  };

  // is_fallback_mode (vvc_mvs.c:313-337)
  static int sb_is_fallback(const SbParams* sp, int pf) {
    const int a = 4 * (2048 + sp->dhx);
    const int b = 4 * sp->dhy;
    const int c = 4 * (2048 + sp->dvy);
    const int d = 4 * sp->dvx;
    if (pf == PF_BI) {
      const int maxw = std::max(0, std::max(a, std::max(b, a + b)));
      const int minw = std::min(0, std::min(a, std::min(b, a + b)));
      const int maxh = std::max(0, std::max(c, std::max(d, c + d)));
      const int minh = std::min(0, std::min(c, std::min(d, c + d)));
      return (((maxw - minw) >> 11) + 9) * (((maxh - minh) >> 11) + 9) > 225;
    }
    const int wxh = (std::abs(a) >> 11) + 9;
    const int hxh = (std::abs(d) >> 11) + 9;
    const int wxv = (std::abs(b) >> 11) + 9;
    const int hxv = (std::abs(c) >> 11) + 9;
    return !(wxh * hxh <= 165 && wxv * hxv <= 165);
  }

  void init_sb_params(SbParams* sp, const AffMi& mi, int w, int h,
                      int lx) const {
    const int lw = ilog2(w), lh = ilog2(h);
    const auto& cp = mi.cp[lx];
    sp->dhx = (cp[1][0] - cp[0][0]) * (1 << (7 - lw));
    sp->dvx = (cp[1][1] - cp[0][1]) * (1 << (7 - lw));
    if (mi.mmi == 2) {
      sp->dhy = (cp[2][0] - cp[0][0]) * (1 << (7 - lh));
      sp->dvy = (cp[2][1] - cp[0][1]) * (1 << (7 - lh));
    } else {
      sp->dhy = -sp->dvx;
      sp->dvy = sp->dhx;
    }
    sp->sh = cp[0][0] * (1 << 7);
    sp->sv = cp[0][1] * (1 << 7);
    sp->fallback = sb_is_fallback(sp, mi.pf);
  }

  // ff_vvc_store_sb_mvs (8.5.5.9): per-4x4 subblock MVs from CPMVs;
  // also derives cb_prof_flag + the PROF deltas per list
  // (derive_cb_prof_flag_lx + derive_subblock_diff_mvs)
  void store_sb_mvs(CuRecord& cu, const AffMi& mi, int x0, int y0, int w,
                    int h) {
    SbParams params[2] = {};
    MvF f;
    f.pred_flag = mi.pf;
    f.bcw = mi.bcw;
    for (int i = 0; i < 2; i++) {
      if (mi.pf & (i + 1)) {
        store_cp_mv(mi, x0, y0, w, h, i);
        init_sb_params(&params[i], mi, w, h, i);
        f.ref_idx[i] = mi.ref_idx[i];
        bool same01 = mi.cp[i][0][0] == mi.cp[i][1][0] &&
                      mi.cp[i][0][1] == mi.cp[i][1][1];
        bool same = mi.mmi == 1
                        ? same01
                        : (same01 && mi.cp[i][0][0] == mi.cp[i][2][0] &&
                           mi.cp[i][0][1] == mi.cp[i][2][1]);
        if (!sh_.ph.ph_prof_disabled_flag && !params[i].fallback && !same) {
          cu.prof |= 1 << i;
          cu.pd[i * 4 + 0] = params[i].dhx;
          cu.pd[i * 4 + 1] = params[i].dhy;
          cu.pd[i * 4 + 2] = params[i].dvx;
          cu.pd[i * 4 + 3] = params[i].dvy;
        }
      }
    }
    for (int sby = 0; sby < (h >> 2); sby++)
      for (int sbx = 0; sbx < (w >> 2); sbx++) {
        for (int i = 0; i < 2; i++) {
          if (!(mi.pf & (i + 1))) continue;
          const SbParams& sp = params[i];
          const int xp = sp.fallback ? (w >> 1) : (2 + (sbx << 2));
          const int yp = sp.fallback ? (h >> 1) : (2 + (sby << 2));
          f.mv[i][0] = sp.sh + sp.dhx * xp + sp.dhy * yp;
          f.mv[i][1] = sp.sv + sp.dvx * xp + sp.dvy * yp;
          round_mv(&f.mv[i][0], &f.mv[i][1], 0, 7);
          f.mv[i][0] = clip_intp2_17(f.mv[i][0]);
          f.mv[i][1] = clip_intp2_17(f.mv[i][1]);
        }
        set_mvf(x0 + sbx * 4, y0 + sby * 4, 4, 4, f);
      }
  }

  // affine_neighbour_cb: neighbour CU geometry when affine (tab.mmi)
  int affine_neighbour_cb(int x_nb, int y_nb, int* xcb, int* ycb, int* cbw,
                          int* cbh) const {
    const size_t cell = (size_t)(y_nb >> min_cb_log2_) * mcb_w_ +
                        (x_nb >> min_cb_log2_);
    const int mmi = tab_mmi_[cell];
    if (mmi) {
      *xcb = tab_cbx_[cell];
      *ycb = tab_cby_[cell];
      *cbw = tab_cbw_[cell];
      *cbh = tab_cbh_[cell];
    }
    return mmi;
  }

  // affine_cps_from_nb: inherit CPMVs from an affine neighbour
  void affine_cps_from_nb(int x0, int y0, int cbw, int cbh, int x_nb,
                          int y_nb, int nbw, int nbh, int lx,
                          int32_t cps[3][2], int num_cps) const {
    const int log2_nbw = ilog2(nbw), log2_nbh = ilog2(nbh);
    const int is_ctb_boundary =
        !((y_nb + nbh) % sps_.ctb_size_y) && (y_nb + nbh == y0);
    int32_t lx_mv[2], rx_mv[2];
    int mmi_nb = 0;
    if (is_ctb_boundary) {
      const MvF& l = mvf_[(size_t)((y_nb + nbh - 1) >> 2) * pu_w_ +
                          (x_nb >> 2)];
      const MvF& r = mvf_[(size_t)((y_nb + nbh - 1) >> 2) * pu_w_ +
                          ((x_nb + nbw - 1) >> 2)];
      lx_mv[0] = l.mv[lx][0];
      lx_mv[1] = l.mv[lx][1];
      rx_mv[0] = r.mv[lx][0];
      rx_mv[1] = r.mv[lx][1];
    } else {
      const size_t cell = (size_t)(y_nb >> min_cb_log2_) * mcb_w_ +
                          (x_nb >> min_cb_log2_);
      const size_t cell_r = (size_t)(y_nb >> min_cb_log2_) * mcb_w_ +
                            ((x_nb + nbw - 1) >> min_cb_log2_);
      mmi_nb = tab_mmi_[cell];
      const int32_t* tl = &tab_cpmv_[lx][cell * 6];
      const int32_t* tr = &tab_cpmv_[lx][cell_r * 6 + 2];  // cp 1
      lx_mv[0] = tl[0];
      lx_mv[1] = tl[1];
      rx_mv[0] = tr[0];
      rx_mv[1] = tr[1];
    }
    int mv_scale_hor = lx_mv[0] * (1 << 7);
    int mv_scale_ver = lx_mv[1] * (1 << 7);
    int d_hor_x = (rx_mv[0] - lx_mv[0]) * (1 << (7 - log2_nbw));
    int d_ver_x = (rx_mv[1] - lx_mv[1]) * (1 << (7 - log2_nbw));
    int d_hor_y, d_ver_y;
    if (!is_ctb_boundary && mmi_nb == 2) {
      const size_t cell_b = (size_t)((y_nb + nbh - 1) >> min_cb_log2_) *
                                mcb_w_ +
                            (x_nb >> min_cb_log2_);
      const int32_t* lb = &tab_cpmv_[lx][cell_b * 6 + 4];  // cp 2
      d_hor_y = (lb[0] - lx_mv[0]) * (1 << (7 - log2_nbh));
      d_ver_y = (lb[1] - lx_mv[1]) * (1 << (7 - log2_nbh));
    } else {
      d_hor_y = -d_ver_x;
      d_ver_y = d_hor_x;
    }
    if (is_ctb_boundary) y_nb = y0;
    cps[0][0] = mv_scale_hor + d_hor_x * (x0 - x_nb) + d_hor_y * (y0 - y_nb);
    cps[0][1] = mv_scale_ver + d_ver_x * (x0 - x_nb) + d_ver_y * (y0 - y_nb);
    cps[1][0] = mv_scale_hor + d_hor_x * (x0 + cbw - x_nb) +
                d_hor_y * (y0 - y_nb);
    cps[1][1] = mv_scale_ver + d_ver_x * (x0 + cbw - x_nb) +
                d_ver_y * (y0 - y_nb);
    if (num_cps == 3) {
      cps[2][0] = mv_scale_hor + d_hor_x * (x0 - x_nb) +
                  d_hor_y * (y0 + cbh - y_nb);
      cps[2][1] = mv_scale_ver + d_ver_x * (x0 - x_nb) +
                  d_ver_y * (y0 + cbh - y_nb);
    }
    for (int i = 0; i < num_cps; i++) {
      round_mv(&cps[i][0], &cps[i][1], 0, 7);
      cps[i][0] = clip_intp2_17(cps[i][0]);
      cps[i][1] = clip_intp2_17(cps[i][1]);
    }
  }

  // inherited affine merge candidate from one neighbour position
  int affine_merge_candidate(int x0, int y0, int w, int h, int x_cand,
                             int y_cand, AffMi* mi) {
    int xcb, ycb, nbw, nbh;
    const int mmi = affine_neighbour_cb(x_cand, y_cand, &xcb, &ycb, &nbw,
                                        &nbh);
    if (mmi) {
      const MvF& mvf = mvf_[(size_t)(ycb >> 2) * pu_w_ + (xcb >> 2)];
      mi->bcw = mvf.bcw;
      mi->pf = mvf.pred_flag;
      for (int i = 0; i < 2; i++) {
        if (mi->pf & (i + 1))
          affine_cps_from_nb(x0, y0, w, h, xcb, ycb, nbw, nbh, i,
                             mi->cp[i], mmi + 1);
        mi->ref_idx[i] = mvf.ref_idx[i];
      }
      mi->mmi = mmi;
    }
    return mmi;
  }

  int affine_merge_from_nbs(int x0, int y0, int w, int h, const Nb* nbs,
                            const int* idxs, int n, AffMi* mi) {
    for (int i = 0; i < n; i++) {
      if (check_nb(nbs[idxs[i]]) &&
          affine_merge_candidate(x0, y0, w, h, nbs[idxs[i]].x,
                                 nbs[idxs[i]].y, mi))
        return 1;
    }
    return 0;
  }

  const MvF* derive_corner_mvf(const Nb* nbs, const int* idxs, int n) {
    for (int i = 0; i < n; i++) {
      const MvF* f = check_nb(nbs[idxs[i]]);
      if (f) return f;
    }
    return nullptr;
  }

  // compare_pf_ref_idx (vvc_mvs.c:980-997)
  bool cmp_pf_ref(const MvF* A, const MvF* B, const MvF* C, int lx) const {
    const int mask = (lx + 1) & A->pred_flag;
    if (!(B->pred_flag & mask)) return false;
    if (A->ref_idx[lx] != B->ref_idx[lx]) return false;
    if (C) {
      if (!(C->pred_flag & mask)) return false;
      if (A->ref_idx[lx] != C->ref_idx[lx]) return false;
    }
    return true;
  }

  // constructed affine merge candidates 1-6 (vvc_mvs.c:1120-1310)
  int affine_const1(const MvF* c0, const MvF* c1, const MvF* c2,
                    AffMi* mi) {
    if (!(c0 && c1 && c2)) return 0;
    mi->pf = 0;
    for (int i = 0; i < 2; i++) {
      if (cmp_pf_ref(c0, c1, c2, i)) {
        mi->pf |= i + 1;
        mi->ref_idx[i] = c0->ref_idx[i];
        for (int c = 0; c < 2; c++) {
          mi->cp[i][0][c] = c0->mv[i][c];
          mi->cp[i][1][c] = c1->mv[i][c];
          mi->cp[i][2][c] = c2->mv[i][c];
        }
      }
    }
    if (!mi->pf) return 0;
    if (mi->pf == PF_BI) mi->bcw = c0->bcw;
    mi->mmi = 2;
    return 1;
  }

  int affine_const2(const MvF* c0, const MvF* c1, const MvF* c3,
                    AffMi* mi) {
    if (!(c0 && c1 && c3)) return 0;
    mi->pf = 0;
    for (int i = 0; i < 2; i++) {
      if (cmp_pf_ref(c0, c1, c3, i)) {
        mi->pf |= i + 1;
        mi->ref_idx[i] = c0->ref_idx[i];
        for (int c = 0; c < 2; c++) {
          mi->cp[i][0][c] = c0->mv[i][c];
          mi->cp[i][1][c] = c1->mv[i][c];
          mi->cp[i][2][c] = c3->mv[i][c] + c0->mv[i][c] - c1->mv[i][c];
        }
        mi->cp[i][2][0] = clip_intp2_17(mi->cp[i][2][0]);
        mi->cp[i][2][1] = clip_intp2_17(mi->cp[i][2][1]);
      }
    }
    if (!mi->pf) return 0;
    mi->bcw = mi->pf == PF_BI ? c0->bcw : 0;
    mi->mmi = 2;
    return 1;
  }

  int affine_const3(const MvF* c0, const MvF* c2, const MvF* c3,
                    AffMi* mi) {
    if (!(c0 && c2 && c3)) return 0;
    mi->pf = 0;
    for (int i = 0; i < 2; i++) {
      if (cmp_pf_ref(c0, c2, c3, i)) {
        mi->pf |= i + 1;
        mi->ref_idx[i] = c0->ref_idx[i];
        for (int c = 0; c < 2; c++) {
          mi->cp[i][0][c] = c0->mv[i][c];
          mi->cp[i][1][c] = c3->mv[i][c] + c0->mv[i][c] - c2->mv[i][c];
          mi->cp[i][2][c] = c2->mv[i][c];
        }
        mi->cp[i][1][0] = clip_intp2_17(mi->cp[i][1][0]);
        mi->cp[i][1][1] = clip_intp2_17(mi->cp[i][1][1]);
      }
    }
    if (!mi->pf) return 0;
    mi->bcw = mi->pf == PF_BI ? c0->bcw : 0;
    mi->mmi = 2;
    return 1;
  }

  int affine_const4(const MvF* c1, const MvF* c2, const MvF* c3,
                    AffMi* mi) {
    if (!(c1 && c2 && c3)) return 0;
    mi->pf = 0;
    for (int i = 0; i < 2; i++) {
      if (cmp_pf_ref(c1, c2, c3, i)) {
        mi->pf |= i + 1;
        mi->ref_idx[i] = c1->ref_idx[i];
        for (int c = 0; c < 2; c++) {
          mi->cp[i][0][c] = c1->mv[i][c] + c2->mv[i][c] - c3->mv[i][c];
          mi->cp[i][1][c] = c1->mv[i][c];
          mi->cp[i][2][c] = c2->mv[i][c];
        }
        mi->cp[i][0][0] = clip_intp2_17(mi->cp[i][0][0]);
        mi->cp[i][0][1] = clip_intp2_17(mi->cp[i][0][1]);
      }
    }
    if (!mi->pf) return 0;
    mi->bcw = mi->pf == PF_BI ? c1->bcw : 0;
    mi->mmi = 2;
    return 1;
  }

  int affine_const5(const MvF* c0, const MvF* c1, AffMi* mi) {
    if (!(c0 && c1)) return 0;
    mi->pf = 0;
    for (int i = 0; i < 2; i++) {
      if (cmp_pf_ref(c0, c1, nullptr, i)) {
        mi->pf |= i + 1;
        mi->ref_idx[i] = c0->ref_idx[i];
        for (int c = 0; c < 2; c++) {
          mi->cp[i][0][c] = c0->mv[i][c];
          mi->cp[i][1][c] = c1->mv[i][c];
        }
      }
    }
    if (!mi->pf) return 0;
    if (mi->pf == PF_BI) mi->bcw = c0->bcw;
    mi->mmi = 1;
    return 1;
  }

  int affine_const6(const MvF* c0, const MvF* c2, int w, int h,
                    AffMi* mi) {
    if (!(c0 && c2)) return 0;
    const int shift = 7 + ilog2(w) - ilog2(h);
    mi->pf = 0;
    for (int i = 0; i < 2; i++) {
      if (cmp_pf_ref(c0, c2, nullptr, i)) {
        mi->pf |= i + 1;
        mi->ref_idx[i] = c0->ref_idx[i];
        mi->cp[i][0][0] = c0->mv[i][0];
        mi->cp[i][0][1] = c0->mv[i][1];
        mi->cp[i][1][0] = (c0->mv[i][0] * (1 << 7)) +
                          ((c2->mv[i][1] - c0->mv[i][1]) * (1 << shift));
        mi->cp[i][1][1] = (c0->mv[i][1] * (1 << 7)) -
                          ((c2->mv[i][0] - c0->mv[i][0]) * (1 << shift));
        round_mv(&mi->cp[i][1][0], &mi->cp[i][1][1], 0, 7);
        mi->cp[i][1][0] = clip_intp2_17(mi->cp[i][1][0]);
        mi->cp[i][1][1] = clip_intp2_17(mi->cp[i][1][1]);
      }
    }
    if (!mi->pf) return 0;
    if (mi->pf == PF_BI) mi->bcw = c0->bcw;
    mi->mmi = 1;
    return 1;
  }

  // 8.5.5.7 affine AMVP predictor list (affine_mvp, vvc_mvs.c:1666-1722)
  void affine_mvp(int x0, int y0, int w, int h, int mvp_lx_flag, int lx,
                  const int* ref_idx, int amvr_shift, int num_cp,
                  int32_t cps[3][2]) {
    Nb nbs[7];
    neighbours(x0, y0, w, h, nbs);
    int num_cands = 0;
    const int poc = out.ref_pocs[lx][ref_idx[lx]];
    // inherited from an affine neighbour whose mvf matches the ref poc
    auto from_nbs = [&](const int* idxs, int n) {
      for (int i = 0; i < n; i++) {
        if (!check_nb(nbs[idxs[i]])) continue;
        int xcb, ycb, nbw, nbh;
        const int mmi = affine_neighbour_cb(nbs[idxs[i]].x, nbs[idxs[i]].y,
                                            &xcb, &ycb, &nbw, &nbh);
        if (!mmi) continue;
        const MvF& mvf = mvf_[(size_t)(ycb >> 2) * pu_w_ + (xcb >> 2)];
        int use = -1;
        if ((mvf.pred_flag & (lx + 1)) &&
            out.ref_pocs[lx][mvf.ref_idx[lx]] == poc)
          use = lx;
        else {
          const int ly = 1 - lx;
          if ((mvf.pred_flag & (ly + 1)) && mvf.ref_idx[ly] >= 0 &&
              out.ref_pocs[ly][mvf.ref_idx[ly]] == poc)
            use = ly;
        }
        if (use < 0) continue;
        affine_cps_from_nb(x0, y0, w, h, xcb, ycb, nbw, nbh, use, cps,
                           num_cp);
        for (int c = 0; c < num_cp; c++)
          round_mv(&cps[c][0], &cps[c][1], amvr_shift, amvr_shift);
        return true;
      }
      return false;
    };
    static const int ak[] = {0, 1};     // A0, A1
    static const int bk[] = {3, 4, 5};  // B0, B1, B2
    if (from_nbs(ak, 2)) {
      if (mvp_lx_flag == num_cands) return;
      num_cands++;
    }
    if (from_nbs(bk, 3)) {
      if (mvp_lx_flag == num_cands) return;
      num_cands++;
    }
    // constructed corner CPs (affine_mvp_const1/const2)
    int avail[3] = {0, 0, 0};
    int32_t ccp[3][2] = {};
    auto corner_cp = [&](const int* idxs, int n, int32_t* cp) {
      for (int i = 0; i < n; i++) {
        const MvF* fnb = check_nb(nbs[idxs[i]]);
        if (!fnb) continue;
        if ((fnb->pred_flag & (lx + 1)) &&
            out.ref_pocs[lx][fnb->ref_idx[lx]] == poc) {
          cp[0] = fnb->mv[lx][0];
          cp[1] = fnb->mv[lx][1];
        } else {
          const int ly = 1 - lx;
          if ((fnb->pred_flag & (ly + 1)) && fnb->ref_idx[ly] >= 0 &&
              out.ref_pocs[ly][fnb->ref_idx[ly]] == poc) {
            cp[0] = fnb->mv[ly][0];
            cp[1] = fnb->mv[ly][1];
          } else {
            continue;
          }
        }
        round_mv(&cp[0], &cp[1], amvr_shift, amvr_shift);
        return 1;
      }
      return 0;
    };
    static const int tl[] = {5, 6, 2};  // B2, B3, A2
    static const int tr[] = {4, 3};     // B1, B0
    static const int bl[] = {1, 0};     // A1, A0
    avail[0] = corner_cp(tl, 3, ccp[0]);
    avail[1] = corner_cp(tr, 2, ccp[1]);
    avail[2] = corner_cp(bl, 2, ccp[2]);
    if (avail[0] && avail[1] && (avail[2] || num_cp == 2)) {
      if (mvp_lx_flag == num_cands) {
        for (int j = 0; j < num_cp; j++) {
          cps[j][0] = ccp[j][0];
          cps[j][1] = ccp[j][1];
        }
        return;
      }
      num_cands++;
    }
    for (int i = 2; i >= 0; i--) {
      if (avail[i]) {
        if (mvp_lx_flag == num_cands) {
          for (int j = 0; j < num_cp; j++) {
            cps[j][0] = ccp[i][0];
            cps[j][1] = ccp[i][1];
          }
          return;
        }
        num_cands++;
      }
    }
    int32_t tmv[2];
    if (temporal_mv(x0, y0, w, h, ref_idx[lx], lx, true, tmv)) {
      if (mvp_lx_flag == num_cands) {
        round_mv(&tmv[0], &tmv[1], amvr_shift, amvr_shift);
        for (int j = 0; j < num_cp; j++) {
          cps[j][0] = tmv[0];
          cps[j][1] = tmv[1];
        }
        return;
      }
      num_cands++;
    }
    for (int j = 0; j < num_cp; j++) cps[j][0] = cps[j][1] = 0;
  }

  MvF merge_candidate(int x0, int y0, int w, int h, int merge_idx,
                      int max_num_merge, bool is_b) {
    Nb nbs[7];
    neighbours(x0, y0, w, h, nbs);
    const MvF* nb_list[7] = {};
    std::vector<MvF> cands;
    static const int order[4][2] = {{4, -1}, {1, 4}, {3, 4}, {0, 1}};
    auto same = [&](const MvF* a, const MvF* b) {
      return a && b && *a == *b;
    };
    for (auto& o : order) {
      const MvF* c = check_nb(nbs[o[0]]);
      nb_list[o[0]] = c;
      if (c && !(o[1] >= 0 && same(c, nb_list[o[1]]))) {
        cands.push_back(*c);
        if (merge_idx == (int)cands.size() - 1) return cands.back();
      }
    }
    if (cands.size() != 4) {
      const MvF* c = check_nb(nbs[5]);  // B2
      nb_list[5] = c;
      if (c && !same(c, nb_list[1]) && !same(c, nb_list[4])) {
        cands.push_back(*c);
        if (merge_idx == (int)cands.size() - 1) return cands.back();
      }
    }
    // temporal candidate (mv_merge_temporal_candidate, vvc_mvs.c:678)
    {
      MvF c;
      bool a0 = temporal_mv(x0, y0, w, h, 0, 0, true, c.mv[0]);
      bool a1 = is_b ? temporal_mv(x0, y0, w, h, 0, 1, true, c.mv[1])
                     : false;
      c.pred_flag = (a0 ? PF_L0 : 0) | (a1 ? PF_L1 : 0);
      if (c.pred_flag) {
        c.ref_idx[0] = 0;
        c.ref_idx[1] = 0;
        cands.push_back(c);
        if (merge_idx == (int)cands.size() - 1) return cands.back();
      }
    }
    // HMVP
    for (int i = 1; i <= (int)hmvp_.size() &&
                    (int)cands.size() < max_num_merge - 1; i++) {
      const MvF& hc = hmvp_[hmvp_.size() - i];
      bool dup = i <= 2 && (same(&hc, nb_list[1]) || same(&hc, nb_list[4]));
      if (!dup) {
        cands.push_back(hc);
        if (merge_idx == (int)cands.size() - 1) return cands.back();
      }
    }
    // pairwise
    if (cands.size() > 1) {
      const MvF& p0 = cands[0];
      const MvF& p1 = cands[1];
      MvF c;
      c.pred_flag = 0;
      int n_lists = is_b ? 2 : 1;
      for (int i = 0; i < n_lists; i++) {
        int mask = i + 1;
        if (p0.pred_flag & mask) {
          c.pred_flag |= mask;
          c.ref_idx[i] = p0.ref_idx[i];
          if (p1.pred_flag & mask) {
            c.mv[i][0] = p0.mv[i][0] + p1.mv[i][0];
            c.mv[i][1] = p0.mv[i][1] + p1.mv[i][1];
            round_mv(&c.mv[i][0], &c.mv[i][1], 0, 1);
          } else {
            c.mv[i][0] = p0.mv[i][0];
            c.mv[i][1] = p0.mv[i][1];
          }
        } else if (p1.pred_flag & mask) {
          c.pred_flag |= mask;
          c.mv[i][0] = p1.mv[i][0];
          c.mv[i][1] = p1.mv[i][1];
          c.ref_idx[i] = p1.ref_idx[i];
        }
      }
      if (c.pred_flag) {
        // pairwise: bcw 0; hpel kept only when both sources agree
        // (mv_merge_pairwise_candidate, vvc_mvs.c:742-744)
        c.bcw = 0;
        c.hpel = p0.hpel == p1.hpel ? p0.hpel : 0;
        cands.push_back(c);
        if (merge_idx == (int)cands.size() - 1) return cands.back();
      }
    }
    // zero candidates
    int num_ref = is_b ? std::min(sh_.num_ref_idx_active[0],
                                  sh_.num_ref_idx_active[1])
                       : sh_.num_ref_idx_active[0];
    int zero_idx = 0;
    while ((int)cands.size() < max_num_merge) {
      MvF c;
      c.pred_flag = PF_L0 + ((is_b ? 1 : 0) << 1);
      int ri = zero_idx < num_ref ? zero_idx : 0;
      c.ref_idx[0] = c.ref_idx[1] = ri;
      c.mv[0][0] = c.mv[0][1] = c.mv[1][0] = c.mv[1][1] = 0;
      cands.push_back(c);
      if (merge_idx == (int)cands.size() - 1) return cands.back();
      zero_idx++;
    }
    return cands[merge_idx];
  }

  bool mvp_cand_from(const MvF& f, int lx, const int* ref_idx, int32_t* mv) {
    int poc = out.ref_pocs[lx][ref_idx[lx]];
    if ((f.pred_flag & (lx + 1)) &&
        out.ref_pocs[lx][f.ref_idx[lx]] == poc) {
      mv[0] = f.mv[lx][0];
      mv[1] = f.mv[lx][1];
      return true;
    }
    int ly = 1 - lx;
    if ((f.pred_flag & (ly + 1)) && f.ref_idx[ly] >= 0 &&
        out.ref_pocs[ly][f.ref_idx[ly]] == poc) {
      mv[0] = f.mv[ly][0];
      mv[1] = f.mv[ly][1];
      return true;
    }
    return false;
  }

  // AMVP (vvc_mvs.c:1404-1604; no TMVP)
  void mvp(int x0, int y0, int w, int h, int mvp_lx_flag, int lx,
           const int* ref_idx, int amvr_shift, int32_t* mv_out) {
    Nb nbs[7];
    neighbours(x0, y0, w, h, nbs);
    int num_cands = 0;
    int32_t mv_a[2] = {0, 0};
    bool have_a = false;

    auto from_nbs = [&](const int* idxs, int n, int32_t* mv) {
      for (int i = 0; i < n; i++) {
        const MvF* f = check_nb(nbs[idxs[i]]);
        if (f && mvp_cand_from(*f, lx, ref_idx, mv)) {
          round_mv(&mv[0], &mv[1], amvr_shift, amvr_shift);
          return true;
        }
      }
      return false;
    };
    static const int ak[] = {0, 1};
    static const int bk[] = {3, 4, 5};
    int32_t mv[2];
    if (from_nbs(ak, 2, mv)) {
      if (mvp_lx_flag == num_cands) {
        mv_out[0] = mv[0];
        mv_out[1] = mv[1];
        return;
      }
      num_cands++;
      mv_a[0] = mv[0];
      mv_a[1] = mv[1];
      have_a = true;
    }
    if (from_nbs(bk, 3, mv)) {
      if (!have_a || mv_a[0] != mv[0] || mv_a[1] != mv[1]) {
        if (mvp_lx_flag == num_cands) {
          mv_out[0] = mv[0];
          mv_out[1] = mv[1];
          return;
        }
        num_cands++;
      }
    }
    // temporal candidate (mvp_temporal_candidates, vvc_mvs.c:1526)
    if (temporal_mv(x0, y0, w, h, ref_idx[lx], lx, true, mv)) {
      if (mvp_lx_flag == num_cands) {
        round_mv(&mv[0], &mv[1], amvr_shift, amvr_shift);
        mv_out[0] = mv[0];
        mv_out[1] = mv[1];
        return;
      }
      num_cands++;
    }
    int poc = out.ref_pocs[lx][ref_idx[lx]];
    int n_h = std::min((size_t)4, hmvp_.size());
    for (int i = 1; i <= n_h; i++) {
      const MvF& hc = hmvp_[i - 1];
      for (int j = 0; j < 2; j++) {
        int ly = j ? (1 - lx) : lx;
        if ((hc.pred_flag & (ly + 1)) && hc.ref_idx[ly] >= 0 &&
            poc == out.ref_pocs[ly][hc.ref_idx[ly]]) {
          if (mvp_lx_flag == num_cands) {
            mv_out[0] = hc.mv[ly][0];
            mv_out[1] = hc.mv[ly][1];
            round_mv(&mv_out[0], &mv_out[1], amvr_shift, amvr_shift);
            return;
          }
          num_cands++;
        }
      }
    }
    mv_out[0] = mv_out[1] = 0;
  }

  void update_hmvp(const MvF& f) {
    bool found = false;
    for (size_t i = 0; i < hmvp_.size(); i++) {
      if (f == hmvp_[i]) {
        hmvp_.erase(hmvp_.begin() + i);
        found = true;
        break;
      }
    }
    if (!found && hmvp_.size() == 5) hmvp_.erase(hmvp_.begin());
    hmvp_.push_back(f);
  }

  int32_t ipm_at(int x_cb, int y_cb) const { return tab_ipm_[y_cb * mcb_w_ + x_cb]; }
  int32_t cpm_at(int x_cb, int y_cb) const { return tab_cpm_[y_cb * mcb_w_ + x_cb]; }
  int32_t imf_at(int x_cb, int y_cb) const { return tab_imf_[y_cb * mcb_w_ + x_cb]; }

  int bin(int ctx) { return cd_->decode(ctxs_, ctx); }

  int truncated_binary(int c_max) {
    int n = c_max + 1;
    int k = 0;
    while ((2 << k) <= n) k++;  // k = floor(log2(n))
    int u = (1 << (k + 1)) - n;
    int v = (int)cd_->bypass_bits(k);
    if (v >= u) {
      v = (v << 1) | cd_->bypass();
      v -= u;
    }
    return v;
  }

  // LMCS table derivation (parity: lmcs_derive_lut, vvc_ps.c:601-671,
  // including the reference's max_bin_idx derivation from
  // lmcs_min_bin_idx at vvc_ps.c:620 — the stream generator keeps
  // lmcs_delta_max_bin_idx == lmcs_min_bin_idx so spec and reference
  // agree).  sh_lmcs_used_flag is inferred from ph_lmcs_enabled_flag
  // (PH carried in SH).
  void derive_lmcs() {
    LmcsOut& lm = out.lmcs;
    lm = LmcsOut();
    if (!sh_.sh_lmcs_used_flag) return;
    const Aps& aps = aps_lmcs_[sh_.ph.ph_lmcs_aps_id & 3];
    VVC_UNSUPPORTED(aps.aps_params_type != 1, "LMCS APS missing");
    VVC_UNSUPPORTED(sps_.bit_depth > 12, "LMCS >12-bit");
    // min_bin 0 makes the reference's inverse-LUT pivot scan read one
    // past its 16-entry tables for top samples (vvc_ps.c:656-660 with
    // max_bin 15) — undefined behaviour there, so no golden exists
    VVC_UNSUPPORTED(aps.lmcs_min_bin_idx < 1, "lmcs_min_bin_idx 0");
    lm.enabled = 1;
    lm.crs_flag = sh_.ph.ph_chroma_residual_scale_flag;
    const int max = 1 << sps_.bit_depth;
    const int org_cw = max / 16;
    int shift = 0;
    while ((1 << (shift + 1)) <= org_cw) shift++;
    const int off = 1 << (shift - 1);
    lm.min_bin = aps.lmcs_min_bin_idx;
    lm.max_bin = 15 - aps.lmcs_min_bin_idx;  // reference quirk, see above
    int cw[16] = {};
    for (int i = lm.min_bin; i <= lm.max_bin; i++)
      cw[i] = org_cw + aps.lmcs_delta_cw[i];
    lm.pivot[0] = 0;
    for (int i = 0; i < 16; i++) {
      lm.pivot[i + 1] = lm.pivot[i] + cw[i];
      lm.fwd_scale[i] = (cw[i] * (1 << 11) + off) >> shift;
      if (cw[i] == 0) {
        lm.inv_scale[i] = 0;
        lm.chroma_scale[i] = 1 << 11;
      } else {
        lm.inv_scale[i] = org_cw * (1 << 11) / cw[i];
        // denominator > 0 for conforming streams (7.4.3.18); clamp so
        // a non-conforming one cannot fault the process
        lm.chroma_scale[i] = org_cw * (1 << 11) /
                             std::max(1, cw[i] + aps.lmcs_delta_crs);
      }
    }
  }

  // Flatten the slice's ALF filter banks out of the referenced APSs
  // (alf_derive, vvc_ps.c:873-886) and size the per-CTB decision table.
  void derive_alf() {
    AlfOut& a = out.alf;
    a = AlfOut();
    const int cbw = sps_.ctb_width(pps_.width);
    const int cbh = sps_.ctb_width(pps_.height);
    a.ctb.assign((size_t)cbw * cbh * 8, 0);
    a.enabled = sh_.sh_alf_enabled_flag;
    a.cc_enabled[0] = sh_.sh_alf_cc_cb_enabled_flag;
    a.cc_enabled[1] = sh_.sh_alf_cc_cr_enabled_flag;
    if (!a.enabled && !a.cc_enabled[0] && !a.cc_enabled[1]) return;
    a.n_aps_luma = sh_.sh_num_alf_aps_ids_luma;
    a.luma_coeff.assign((size_t)a.n_aps_luma * 25 * 12, 0);
    a.luma_clipidx.assign((size_t)a.n_aps_luma * 25 * 12, 0);
    for (int k = 0; k < a.n_aps_luma; k++) {
      const Aps& aps = aps_alf_[sh_.sh_alf_aps_id_luma[k] & 7];
      VVC_UNSUPPORTED(aps.aps_params_type != 0, "ALF APS missing");
      for (int cls = 0; cls < 25; cls++)
        for (int j = 0; j < 12; j++) {
          a.luma_coeff[((size_t)k * 25 + cls) * 12 + j] =
              aps.alf_luma_coeff[cls][j];
          a.luma_clipidx[((size_t)k * 25 + cls) * 12 + j] =
              aps.alf_luma_clipidx[cls][j];
        }
    }
    if (sh_.sh_alf_cb_enabled_flag || sh_.sh_alf_cr_enabled_flag) {
      const Aps& aps = aps_alf_[sh_.sh_alf_aps_id_chroma & 7];
      VVC_UNSUPPORTED(aps.aps_params_type != 0, "chroma ALF APS missing");
      a.num_chroma_alts = aps.num_chroma_alts;
      for (int alt = 0; alt < 8; alt++)
        for (int j = 0; j < 6; j++) {
          a.chroma_coeff[alt][j] = aps.alf_chroma_coeff[alt][j];
          a.chroma_clipidx[alt][j] = aps.alf_chroma_clipidx[alt][j];
        }
    }
    const int cc_ids[2] = {sh_.sh_alf_cc_cb_aps_id, sh_.sh_alf_cc_cr_aps_id};
    for (int i = 0; i < 2; i++) {
      if (!a.cc_enabled[i]) continue;
      const Aps& aps = aps_alf_[cc_ids[i] & 7];
      VVC_UNSUPPORTED(aps.aps_params_type != 0, "CC-ALF APS missing");
      for (int k = 0; k < 4; k++)
        for (int j = 0; j < 7; j++)
          a.cc_coeff[i][k][j] = aps.alf_cc_coeff[i][k][j];
    }
  }

  // alf_params CABAC mirror (vvc_ctu.c alf_params + vvc_cabac.c
  // ff_vvc_alf_* decoders)
  void decode_alf(int rx, int ry) {
    AlfOut& a = out.alf;
    const int cbw = sps_.ctb_width(pps_.width);
    int32_t* p = &a.ctb[(size_t)(ry * cbw + rx) * 8];
    const int32_t* left = rx > 0 ? p - 8 : nullptr;
    const int32_t* up = ry > 0 ? p - (size_t)cbw * 8 : nullptr;
    if (sh_.sh_alf_enabled_flag) {
      int inc = (ctb_left_ && left[0] ? 1 : 0) + (ctb_up_ && up[0] ? 1 : 0);
      p[0] = bin(ALF_CTB_FLAG + inc);
      if (p[0]) {
        int use_aps = 0;
        if (sh_.sh_num_alf_aps_ids_luma > 0) use_aps = bin(ALF_USE_APS_FLAG);
        if (use_aps) {
          p[1] = 16;
          if (sh_.sh_num_alf_aps_ids_luma > 1)
            p[1] += truncated_binary(sh_.sh_num_alf_aps_ids_luma - 1);
        } else {
          p[1] = truncated_binary(15);
        }
      }
      const int cb_cr_en[2] = {sh_.sh_alf_cb_enabled_flag,
                               sh_.sh_alf_cr_enabled_flag};
      for (int c = 1; c <= 2; c++) {
        if (!cb_cr_en[c - 1]) continue;
        const int fi = 2 * c;  // flag at p[2]/p[4], alt at p[3]/p[5]
        int inc_c = c * 3 + (ctb_left_ && left[fi] ? 1 : 0) +
                    (ctb_up_ && up[fi] ? 1 : 0);
        p[fi] = bin(ALF_CTB_FLAG + inc_c);
        if (p[fi] && a.num_chroma_alts > 1) {
          int i = 0;
          while (i < a.num_chroma_alts - 1 &&
                 bin(ALF_CTB_FILTER_ALT_IDX + c - 1))
            i++;
          p[fi + 1] = i;
        }
      }
    }
    if (sps_.sps_ccalf_enabled_flag) {
      const Aps* ccaps[2] = {&aps_alf_[sh_.sh_alf_cc_cb_aps_id & 7],
                             &aps_alf_[sh_.sh_alf_cc_cr_aps_id & 7]};
      for (int i = 0; i < 2; i++) {
        if (!a.cc_enabled[i]) continue;
        int base = i ? ALF_CTB_CC_CR_IDC : ALF_CTB_CC_CB_IDC;
        int inc = base + (ctb_left_ && left[6 + i] ? 1 : 0) +
                  (ctb_up_ && up[6 + i] ? 1 : 0);
        int v = 0;
        if (bin(inc)) {
          v = 1;
          while (v < ccaps[i]->num_cc_filters[i] && cd_->bypass()) v++;
        }
        p[6 + i] = v;
      }
    }
  }

  void decode_slice(const Nal& nal, BitReader& r) {
    sh_ = parse_slice_header(r, nal.type, sps_, pps_,
                             has_ph_ ? &ph_ : nullptr);
    VVC_UNSUPPORTED(pps_.num_tile_columns * pps_.num_tile_rows != 1 &&
                        !pps_.pps_loop_filter_across_tiles_enabled_flag,
                    "loop filter disabled across tiles (todo)");

    // multi-slice pictures: frame state initializes on the first slice
    // only; later slices parse their tile ranges into the same FrameOut
    // (the decode_slice/frame_start split, vvcdec.c:598-723)
    if (!frame_in_progress_) {
      frame_in_progress_ = true;
      tiles_done_ = 0;
      frame_setup();
    }
    decode_slice_data(nal, r);
  }

  bool frame_in_progress_ = false;
  int tiles_done_ = 0;

  void frame_setup() {
    out.width = pps_.width;
    out.height = pps_.height;
    out.bit_depth = sps_.bit_depth;
    out.chroma_format_idc = sps_.sps_chroma_format_idc;
    out.ref_wraparound_offset = pps_.ref_wraparound_offset;
    out.ctb_log2 = sps_.ctb_log2_size_y;
    out.tile_col_bd.clear();
    for (int bd : pps_.col_bd)
      out.tile_col_bd.push_back(bd << sps_.ctb_log2_size_y);
    out.tile_row_bd.clear();
    for (int bd : pps_.row_bd)
      out.tile_row_bd.push_back(bd << sps_.ctb_log2_size_y);
    tile_x1_ = pps_.width;
    tile_y1_ = pps_.height;
    out.max_num_reorder = sps_.dpb_max_num_reorder_pics;
    out.poc = sh_.ph.ph_pic_order_cnt_lsb;
    out.slice_qp = sh_.slice_qp_y;
    out.dep_quant = sh_.sh_dep_quant_used_flag;
    // the reference exports the RAW signalled offsets as luma crop
    // (vvc_refs.c:188-191 — without the spec's SubWidthC scaling);
    // golden MD5s come from it, so mirror that observable behaviour
    for (int i = 0; i < 4; i++) out.crop[i] = pps_.conf_win[i];
    out.gdr_pic = sh_.ph.ph_gdr_pic_flag;
    out.recovery_poc_cnt = sh_.ph.ph_recovery_poc_cnt;
    out.cclm_vc = sps_.sps_chroma_vertical_collocated_flag;
    out.wpp = sps_.sps_entropy_coding_sync_enabled_flag;
    out.wp_active =
        (pps_.pps_weighted_pred_flag && sh_.sh_slice_type == 1) ||
        (pps_.pps_weighted_bipred_flag && sh_.sh_slice_type == 0);
    out.pwt = sh_.pwt;
    derive_lmcs();
    derive_alf();
    out.has_sl = sh_.sh_explicit_scaling_list_used_flag;
    if (out.has_sl) {
      const Aps& aps = aps_sl_[sh_.ph.ph_scaling_list_aps_id & 7];
      VVC_UNSUPPORTED(aps.aps_params_type != 2, "scaling-list APS missing");
      std::memcpy(out.sl_rec, aps.sl_rec, sizeof(out.sl_rec));
      std::memcpy(out.sl_dc_rec, aps.sl_dc_rec, sizeof(out.sl_dc_rec));
    }
    out.coeff[0].assign((size_t)pps_.width * pps_.height, 0);
    int cw = pps_.width >> sps_.hshift_c, ch = pps_.height >> sps_.vshift_c;
    if (sps_.sps_chroma_format_idc) {
      out.coeff[1].assign((size_t)cw * ch, 0);
      out.coeff[2].assign((size_t)cw * ch, 0);
    }
    out.cus.clear();
    out.tus.clear();

    min_cb_log2_ = sps_.min_cb_log2_size_y;
    mcb_w_ = pps_.width >> min_cb_log2_;
    mcb_h_ = pps_.height >> min_cb_log2_;
    tab_ipm_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cpm_.assign((size_t)mcb_w_ * mcb_h_, MODE_INTER);
    tab_imf_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cbw_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cbh_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cqt_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cpm_c_.assign((size_t)mcb_w_ * mcb_h_, MODE_INTER);
    tab_cbw_c_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cbh_c_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cqt_c_.assign((size_t)mcb_w_ * mcb_h_, 0);
    msm_w_ = (pps_.width + 31) >> 5;
    msm_h_ = (pps_.height + 31) >> 5;
    for (int d = 0; d < 2; d++)
      tab_msm_[d].assign((size_t)msm_w_ * msm_h_, SPLIT_NONE);
    ispmf_w_ = (pps_.width + 63) >> 6;
    tab_ispmf_.assign((size_t)ispmf_w_ * ((pps_.height + 63) >> 6), 0);
    out.ipm.assign((size_t)mcb_w_ * mcb_h_, 0);
    out.mcb_w = mcb_w_;
    out.mcb_h = mcb_h_;
    out.deblock_disabled = sh_.sh_deblocking_filter_disabled_flag;
    for (int i = 0; i < 3; i++) {
      // effective offsets: SH override when present, else PH, else PPS
      // (resolved in parse_slice_header)
      out.beta_offset[i] = sh_.beta_offset[i];
      out.tc_offset[i] = sh_.tc_offset[i];
    }

    // partition constraints per slice type (no PH override)
    if (sh_.sh_slice_type == 2) {
      part_[0].min_qt = 1 << (sps_.log2_diff_min_qt_min_cb_intra_luma +
                              sps_.min_cb_log2_size_y);
      part_[0].max_bt =
          part_[0].min_qt << sps_.log2_diff_max_bt_min_qt_intra_luma;
      part_[0].max_tt =
          part_[0].min_qt << sps_.log2_diff_max_tt_min_qt_intra_luma;
      part_[0].max_mtt = sps_.max_mtt_depth_intra_luma;
      // chroma-tree constraints, in LUMA sample units (sh->min_qt_size
      // et al. with chroma=1; derived per spec 7.4.3.4)
      part_[1].min_qt = 1 << (sps_.log2_diff_min_qt_min_cb_intra_chroma +
                              sps_.min_cb_log2_size_y);
      part_[1].max_bt =
          part_[1].min_qt << sps_.log2_diff_max_bt_min_qt_intra_chroma;
      part_[1].max_tt =
          part_[1].min_qt << sps_.log2_diff_max_tt_min_qt_intra_chroma;
      part_[1].max_mtt = sps_.max_mtt_depth_intra_chroma;
    } else {
      part_[0].min_qt = 1 << (sps_.log2_diff_min_qt_min_cb_inter +
                              sps_.min_cb_log2_size_y);
      part_[0].max_bt = part_[0].min_qt << sps_.log2_diff_max_bt_min_qt_inter;
      part_[0].max_tt = part_[0].min_qt << sps_.log2_diff_max_tt_min_qt_inter;
      part_[0].max_mtt = sps_.max_mtt_depth_inter;
      part_[1] = part_[0];  // local dual tree in P/B uses ch-0 bounds?
      // (reference sh->min_qt_size[1] is set from the intra-chroma SPS
      // fields only for I slices; P/B chroma lookups use [1] == [0])
    }

    // motion state + reference POC lists
    out.slice_type = sh_.sh_slice_type;
    pu_w_ = pps_.width >> 2;
    pu_h_ = pps_.height >> 2;
    mvf_.assign((size_t)pu_w_ * pu_h_, MvF());
    mvf_set_.assign((size_t)pu_w_ * pu_h_, 0);
    tab_skip_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_msf_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_mmi_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cbx_.assign((size_t)mcb_w_ * mcb_h_, 0);
    tab_cby_.assign((size_t)mcb_w_ * mcb_h_, 0);
    for (int lx = 0; lx < 2; lx++)
      tab_cpmv_[lx].assign((size_t)mcb_w_ * mcb_h_ * 6, 0);
    hmvp_.clear();
    for (int lx = 0; lx < 2; lx++) {
      const RefPicListStruct& rpl = sh_.rpl[lx];
      out.nb_refs[lx] = rpl.num_ref_entries;
      int poc_base = out.poc;
      const int max_lsb = 1 << sps_.log2_max_poc_lsb;
      int prev_delta_msb = 0, j = 0;
      for (int i = 0; i < rpl.num_ref_entries && i < 16; i++) {
        if (i < (int)rpl.is_lt.size() && rpl.is_lt[i]) {
          // FullPocLt (poc_lt, vvc_refs.c:401-414); the parser
          // requires the MSB cycle so full POCs resolve up front
          const int delta = rpl.lt_msb_cycle[j] + prev_delta_msb;
          int lt_poc = rpl.lt_poc_lsb[j] + out.poc - delta * max_lsb -
                       (out.poc & (max_lsb - 1));
          prev_delta_msb = delta;
          out.ref_pocs[lx][i] = lt_poc;
          j++;
          continue;
        }
        int d = rpl.sign[i] ? -rpl.abs_delta_poc_st[i]
                            : rpl.abs_delta_poc_st[i];
        poc_base += d;
        out.ref_pocs[lx][i] = poc_base;
      }
    }

    // NoBackwardPredFlag + collocated picture for TMVP (vvc_mvs.c:121,
    // vvc_refs.c:461-463); parsing waits for the collocated picture's
    // motion field when frame-parallel workers run ahead
    no_backward_ = 1;
    for (int lx = 0; lx < 2; lx++)
      for (int i = 0; i < out.nb_refs[lx]; i++)
        if (out.ref_pocs[lx][i] > out.poc) no_backward_ = 0;

    // RefIdxSymL0/L1 (smvd_ref_idx, vvcdec.c:363-375): nearest
    // forward ref in L0 + nearest backward in L1, else swapped.  All
    // refs here are short-term (LTR is VVC_UNSUPPORTED at parse).
    ref_idx_sym_[0] = ref_idx_sym_[1] = -1;
    if (sh_.sh_slice_type == 0) {
      auto find = [&](int lx, bool positive) {
        int idx = -1, old_diff = 0;
        for (int i = 0; i < sh_.num_ref_idx_active[lx] &&
                        i < out.nb_refs[lx]; i++) {
          // SMVD considers short-term refs only (smvd_ref_idx,
          // vvcdec.c:363-375)
          if (i < (int)sh_.rpl[lx].is_lt.size() && sh_.rpl[lx].is_lt[i])
            continue;
          int diff = out.poc - out.ref_pocs[lx][i];
          bool better = positive ? (diff > 0 && (idx < 0 || diff < old_diff))
                                 : (diff < 0 && (idx < 0 || diff > old_diff));
          if (better) { idx = i; old_diff = diff; }
        }
        return idx;
      };
      ref_idx_sym_[0] = find(0, true);
      ref_idx_sym_[1] = find(1, false);
      if (ref_idx_sym_[0] == -1 || ref_idx_sym_[1] == -1) {
        ref_idx_sym_[0] = find(0, false);
        ref_idx_sym_[1] = find(1, true);
      }
    }
    col_.reset();
    if (sh_.ph.ph_temporal_mvp_enabled_flag && sh_.sh_slice_type != 2) {
      int lx = sh_.sh_collocated_from_l0_flag ? 0 : 1;
      int cpoc = out.ref_pocs[lx][sh_.sh_collocated_ref_idx];
      col_ = cols().wait(epoch, cpoc);
      if (!col_)
        throw std::runtime_error("tmvp: collocated picture unavailable");
    }

    tab_qpy_.assign((size_t)mcb_w_ * mcb_h_, sh_.slice_qp_y);
    {
      int ctb_w = (pps_.width + sps_.ctb_size_y - 1) >> sps_.ctb_log2_size_y;
      int ctb_h = (pps_.height + sps_.ctb_size_y - 1) >> sps_.ctb_log2_size_y;
      out.sao.assign((size_t)ctb_w * ctb_h * SAO_N, 0);
    }
  }

  void decode_slice_data(const Nal& nal, BitReader& r) {
    int init_type = 2 - sh_.sh_slice_type;
    if (sh_.sh_cabac_init_flag && sh_.sh_slice_type != 2) init_type ^= 3;
    int qp = sh_.slice_qp_y < 0 ? 0 : (sh_.slice_qp_y > 63 ? 63 : sh_.slice_qp_y);
    ctxs_.init(qp, init_type);
    qp_y_ = sh_.slice_qp_y;
    cu_qp_delta_subdiv_ = sh_.sh_slice_type == 2
        ? sh_.ph.ph_cu_qp_delta_subdiv_intra_slice
        : sh_.ph.ph_cu_qp_delta_subdiv_inter_slice;

    CabacDecoder cd(r.data(), r.size(), sh_.data_bitpos);
    cd_ = &cd;

    int ctb_w = (pps_.width + sps_.ctb_size_y - 1) >> sps_.ctb_log2_size_y;
    int ctb_h = (pps_.height + sps_.ctb_size_y - 1) >> sps_.ctb_log2_size_y;

    // entry-point rbsp byte starts: signaled escaped offsets adjusted
    // by the NAL's emulation-byte positions (ep_init_cabac_decoder,
    // vvcdec.c:426-451)
    std::vector<size_t> ep_start;
    {
      size_t start = sh_.data_bitpos >> 3;
      size_t sk = 0;
      while (sk < nal.skipped.size() && nal.skipped[sk] <= start) sk++;
      for (uint32_t off : sh_.entry_point_offsets) {
        size_t end = start + off;
        while (sk < nal.skipped.size() && nal.skipped[sk] <= end) {
          end--;
          sk++;
        }
        ep_start.push_back(end);
        start = end;
      }
    }

    // tile-major CTU scan (spec 6.5.1 CTB raster within tile, tiles in
    // raster order); per-tile CABAC entry point + context re-init.
    // Raster slices cover [sh_slice_address, +num_tiles) linear tile
    // indices; explicit rect slices cover their tile rectangle in
    // raster order within the rectangle.
    const int n_tile_cols = pps_.num_tile_columns;
    const int n_tiles = n_tile_cols * pps_.num_tile_rows;
    std::vector<int> slice_tiles;
    if (pps_.pps_rect_slice_flag && !pps_.slice_rects.empty()) {
      const auto& sr = pps_.slice_rects[sh_.sh_slice_address];
      for (int ty = sr.ty0; ty < sr.ty0 + sr.ht; ty++)
        for (int tx = sr.tx0; tx < sr.tx0 + sr.wt; tx++)
          slice_tiles.push_back(ty * n_tile_cols + tx);
    } else {
      int t_first = 0, t_cnt = n_tiles;
      if (!pps_.pps_rect_slice_flag && n_tiles > 1) {
        t_first = sh_.sh_slice_address;
        t_cnt = sh_.sh_num_tiles_in_slice_minus1 + 1;
      }
      for (int ti = 0; ti < t_cnt; ti++) slice_tiles.push_back(t_first + ti);
    }
    const int t_cnt = (int)slice_tiles.size();
    // WPP: each CTU row is its own CABAC sub-stream; contexts are
    // inherited from the state saved after the row above's first CTU
    // (schedule_next_parse, vvc_thread.c:255-279; sync window = 1 CTU)
    const bool wpp = sps_.sps_entropy_coding_sync_enabled_flag;
    CabacStates wpp_saved;
    int ep_idx = 0;
    for (int ti = 0; ti < t_cnt; ti++) {
      const int t = slice_tiles[ti];
      const int tx = t % n_tile_cols, ty = t / n_tile_cols;
      const int rx0 = pps_.col_bd[tx], rx1 = pps_.col_bd[tx + 1];
      const int ry0 = pps_.row_bd[ty], ry1 = pps_.row_bd[ty + 1];
      for (int ry = ry0; ry < std::min(ry1, ctb_h); ry++) {
        const bool new_tile = ti > 0 && ry == ry0;
        const bool new_row = wpp && ry > ry0;
        if (new_tile || new_row) {
          // end_of_tile_one_bit / end_of_subset_one_bit of the
          // previous sub-stream, then re-align at the entry point
          if (!cd.terminate())
            throw std::runtime_error("end_of_subset/tile bit != 1");
          if (ep_idx < (int)ep_start.size())
            cd.reinit_at(ep_start[ep_idx++] * 8);
          else
            cd.restart();  // no signaled entry points: by alignment
          if (new_row)
            ctxs_ = wpp_saved;  // WPP context inheritance
          else
            ctxs_.init(qp, init_type);
        }
        for (int rx = rx0; rx < std::min(rx1, ctb_w); rx++) {
          parse_ctu(rx, ry, ry * ctb_w + rx);
          // context storage after the row's first CTU (9.3.1; the
          // 1-CTU WPP sync window)
          if (wpp && rx == rx0) wpp_saved = ctxs_;
        }
      }
    }
    if (!cd.terminate())
      throw std::runtime_error("end_of_slice_one_bit != 1");
    cd_ = nullptr;
    // the frame completes when every tile has been covered by a slice
    tiles_done_ += t_cnt;
    if (tiles_done_ < n_tiles) return;
    frame_in_progress_ = false;
    // publish this picture's motion field for later TMVP readers;
    // DMVR frames defer publication to vvch_dmvr_apply (the refined
    // subblock MVs must land in the collocated store first)
    if (out.needs_dmvr) {
      out.pending_epoch = epoch;
      out.pending_col = mvf_;
    } else {
      auto cdta = std::make_shared<ColData>();
      cdta->poc = out.poc;
      cdta->pu_w = pu_w_;
      cdta->pu_h = pu_h_;
      cdta->mvf = mvf_;
      for (int lx = 0; lx < 2; lx++) {
        cdta->nb_refs[lx] = out.nb_refs[lx];
        std::memcpy(cdta->ref_pocs[lx], out.ref_pocs[lx],
                    sizeof(cdta->ref_pocs[lx]));
      }
      cols().publish(epoch, out.poc, std::move(cdta));
    }
    // export MvField planes (L0) for MC + deblock BS derivation
    size_t n = (size_t)pu_w_ * pu_h_;
    out.mvf_pf.resize(n);
    out.mvf_x.resize(n);
    out.mvf_y.resize(n);
    out.mvf_ref.resize(n);
    out.mvf_x1.resize(n);
    out.mvf_y1.resize(n);
    out.mvf_ref1.resize(n);
    out.mvf_ciip.resize(n);
    for (size_t i = 0; i < n; i++) {
      out.mvf_pf[i] = mvf_.empty() ? PF_INTRA : mvf_[i].pred_flag;
      out.mvf_x[i] = mvf_.empty() ? 0 : mvf_[i].mv[0][0];
      out.mvf_y[i] = mvf_.empty() ? 0 : mvf_[i].mv[0][1];
      out.mvf_ref[i] = mvf_.empty() ? -1 : mvf_[i].ref_idx[0];
      out.mvf_x1[i] = mvf_.empty() ? 0 : mvf_[i].mv[1][0];
      out.mvf_y1[i] = mvf_.empty() ? 0 : mvf_[i].mv[1][1];
      out.mvf_ref1[i] = mvf_.empty() ? -1 : mvf_[i].ref_idx[1];
      out.mvf_ciip[i] = mvf_.empty() ? 0 : mvf_[i].ciip;
    }
    frame_ready = true;
  }

  static constexpr int SAO_N = 24;  // ints per CTB in out.sao

  // hls_sao mirror (vvc_ctu.c:2147-2213)
  void decode_sao(int rx, int ry) {
    int ctb_w = sps_.ctb_width(pps_.width);
    int32_t* p = &out.sao[(size_t)(ry * ctb_w + rx) * SAO_N];
    int32_t* left = rx > 0 ? p - SAO_N : nullptr;
    int32_t* up = ry > 0 ? p - (size_t)ctb_w * SAO_N : nullptr;
    int merge_left = 0, merge_up = 0;
    bool luma_used = sh_.sh_sao_luma_used_flag;
    bool chroma_used = sh_.sh_sao_chroma_used_flag;
    if (luma_used || chroma_used) {
      if (rx > 0 && ctb_left_) merge_left = bin(SAO_MERGE_FLAG);
      if (ry > 0 && !merge_left && ctb_up_) merge_up = bin(SAO_MERGE_FLAG);
    }
    if (merge_left || merge_up) {
      const int32_t* src = merge_left ? left : up;
      for (int i = 0; i < SAO_N; i++) p[i] = src[i];
      return;
    }
    int32_t type[3] = {0, 0, 0}, band[3] = {0, 0, 0}, eo[3] = {0, 0, 0};
    int32_t offs[3][4] = {};
    int32_t sign[3][4] = {};
    int n_c = sps_.sps_chroma_format_idc ? 3 : 1;
    int bd = sps_.bit_depth;
    int max_off = (1 << (std::min(bd, 10) - 5)) - 1;
    for (int c = 0; c < n_c; c++) {
      bool used = c == 0 ? luma_used : chroma_used;
      if (!used) continue;
      if (c == 2) {
        type[2] = type[1];
        eo[2] = eo[1];
      } else {
        if (bin(SAO_TYPE_IDX))
          type[c] = cd_->bypass() ? 2 : 1;  // 1=band 2=edge
      }
      if (!type[c]) continue;
      for (int i = 0; i < 4; i++) {
        int v = 0;
        while (v < max_off && cd_->bypass()) v++;
        offs[c][i] = v;
      }
      if (type[c] == 1) {
        for (int i = 0; i < 4; i++)
          if (offs[c][i]) sign[c][i] = cd_->bypass();
        band[c] = (int)cd_->bypass_bits(5);
      } else if (c != 2) {
        eo[c] = (int)cd_->bypass_bits(2);
      }
    }
    // offset_val derivation (vvc_ctu.c:2216-2229)
    int scale = bd - std::min(10, bd);
    for (int c = 0; c < 3; c++) {
      p[c] = type[c];
      p[3 + c] = band[c];
      p[6 + c] = eo[c];
      int32_t* ov = &p[9 + c * 5];
      ov[0] = 0;
      for (int i = 0; i < 4; i++) {
        int v = offs[c][i];
        if (type[c] == 2) {
          if (i > 1) v = -v;
        } else if (sign[c][i]) {
          v = -v;
        }
        ov[i + 1] = v * (1 << scale);
      }
    }
  }

  void parse_ctu(int rx, int ry, int ctu_idx) {
    const int log2 = sps_.ctb_log2_size_y;
    // current tile bounds (CTU-aligned; maps from vvc_ps.c:254-455)
    const int tcx = pps_.ctb_to_col_bd[rx], tcy = pps_.ctb_to_row_bd[ry];
    tile_x0_ = tcx << log2;
    tile_y0_ = tcy << log2;
    tile_x1_ = pps_.width;
    for (size_t i = 1; i < pps_.col_bd.size(); i++)
      if (pps_.col_bd[i] > rx) {
        tile_x1_ = std::min(pps_.width, pps_.col_bd[i] << log2);
        break;
      }
    tile_y1_ = pps_.height;
    for (size_t i = 1; i < pps_.row_bd.size(); i++)
      if (pps_.row_bd[i] > ry) {
        tile_y1_ = std::min(pps_.height, pps_.row_bd[i] << log2);
        break;
      }
    ctb_left_ = rx > tcx;
    ctb_up_ = ry > tcy;
    // HMVP + first-QG reset at each tile-column start (vvc_ctu.c:2447-2450)
    if (rx == tcx) {
      hmvp_.clear();
      is_first_qg_ = (ry == tcy) || !ctu_idx;
    }
    if (sh_.sh_sao_luma_used_flag || sh_.sh_sao_chroma_used_flag)
      decode_sao(rx, ry);
    if (sh_.sh_alf_enabled_flag || sps_.sps_ccalf_enabled_flag)
      decode_alf(rx, ry);
    int x0 = rx << sps_.ctb_log2_size_y;
    int y0 = ry << sps_.ctb_log2_size_y;
    if (sh_.sh_slice_type == 2 && sps_.sps_qtbtt_dual_tree_intra_flag)
      dual_tree_implicit_qt_split(x0, y0, sps_.ctb_size_y, 0);
    else
      coding_tree(x0, y0, sps_.ctb_size_y, sps_.ctb_size_y, 0, 0, 0, 0,
                  SPLIT_NONE, /*qg_on_y=*/1, /*cb_sub_div=*/0);
  }

  // parity: vvc_ctu.c:2088-2145 (dual_tree_implicit_qt_split): the
  // I-slice dual-tree CTU splits implicitly (no signalled bits) down
  // to 64x64, then each node parses a full luma tree followed by a
  // full chroma tree
  void dual_tree_implicit_qt_split(int x0, int y0, int cb_size,
                                   int cqt_depth) {
    const int cb_subdiv = 2 * cqt_depth;
    if (cb_size > 64) {
      const int x1 = x0 + cb_size / 2;
      const int y1 = y0 + cb_size / 2;
      if (pps_.pps_cu_qp_delta_enabled_flag &&
          cb_subdiv <= cu_qp_delta_subdiv_) {
        is_cu_qp_delta_coded_ = 0;
        qg_x_ = x0;
        qg_y_ = y0;
      }
      dual_tree_implicit_qt_split(x0, y0, cb_size / 2, cqt_depth + 1);
      if (x1 < pps_.width)
        dual_tree_implicit_qt_split(x1, y0, cb_size / 2, cqt_depth + 1);
      if (y1 < pps_.height)
        dual_tree_implicit_qt_split(x0, y1, cb_size / 2, cqt_depth + 1);
      if (x1 < pps_.width && y1 < pps_.height)
        dual_tree_implicit_qt_split(x1, y1, cb_size / 2, cqt_depth + 1);
    } else {
      coding_tree(x0, y0, cb_size, cb_size, cqt_depth, 0, 0, 0, SPLIT_NONE,
                  /*qg_on_y=*/1, cb_subdiv, TREE_LUMA, MT_ALL);
      coding_tree(x0, y0, cb_size, cb_size, cqt_depth, 0, 0, 0, SPLIT_NONE,
                  /*qg_on_y=*/0, cb_subdiv, TREE_CHROMA, MT_ALL);
    }
  }

  // -- coding tree ----------------------------------------------------
  enum SplitMode {
    SPLIT_NONE = 0, SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER,
    SPLIT_BT_VER, SPLIT_QT
  };
  struct Allowed {
    bool qt, btv, bth, ttv, tth;
    bool any_mtt() const { return btv || bth || ttv || tth; }
    bool any() const { return qt || any_mtt(); }
  };

  // parity: vvc_ctu.c:521-620 (all tree/mode types)
  Allowed can_split(int x0, int y0, int w, int h, int mtt_depth,
                    int depth_offset, int part_idx, int last_split,
                    int tree, int mode) const {
    Allowed a{true, true, true, true, true};
    const int chroma = tree == TREE_CHROMA;
    const PartConstraints& pc = part_[chroma];
    int min_cb = 1 << sps_.min_cb_log2_size_y;
    if (mtt_depth) a.qt = false;
    if (w <= pc.min_qt) a.qt = false;
    if (chroma) {
      const int chroma_area = (w >> sps_.hshift_c) * (h >> sps_.vshift_c);
      const int chroma_width = w >> sps_.hshift_c;
      if (chroma_width == 8) {
        a.ttv = false;
      } else if (chroma_width <= 4) {
        if (chroma_width == 4) a.btv = false;
        a.qt = false;
      }
      if (mode == MT_INTRA) a.qt = a.btv = a.bth = a.ttv = a.tth = false;
      if (chroma_area <= 32) {
        a.ttv = a.tth = false;
        if (chroma_area <= 16) a.btv = a.bth = false;
      }
    }
    int max_mtt = pc.max_mtt + depth_offset;
    if (mode == MT_INTER) {
      const int area = w * h;
      if (area == 32)
        a.btv = a.bth = false;
      else if (area == 64)
        a.ttv = a.tth = false;
    }
    if (w <= 2 * min_cb) {
      a.ttv = false;
      if (w <= min_cb) a.btv = false;
    }
    if (h <= 2 * min_cb) {
      a.tth = false;
      if (h <= min_cb) a.bth = false;
    }
    if (w > pc.max_bt || h > pc.max_bt) a.btv = a.bth = false;
    int max_tt = pc.max_tt < 64 ? pc.max_tt : 64;
    if (w > max_tt || h > max_tt) a.ttv = a.tth = false;
    if (mtt_depth >= max_mtt) a.btv = a.bth = a.ttv = a.tth = false;
    if (x0 + w > pps_.width) {
      a.ttv = a.tth = false;
      if (h > 64) a.btv = false;
      if (y0 + h <= pps_.height)
        a.bth = false;
      else if (w > pc.min_qt)
        a.btv = a.bth = false;
    }
    if (y0 + h > pps_.height) {
      a.btv = a.ttv = a.tth = false;
      if (w > 64) a.bth = false;
    }
    if (mtt_depth > 0 && part_idx == 1) {
      if (last_split == SPLIT_TT_VER) a.btv = false;
      else if (last_split == SPLIT_TT_HOR) a.bth = false;
    }
    if (w <= 64 && h > 64) a.btv = false;
    if (w > 64 && h <= 64) a.bth = false;
    return a;
  }

  void left_top_tab(const std::vector<int32_t>& tab_l,
                    const std::vector<int32_t>& tab_t, int x0, int y0,
                    int def_l, int def_t, int* left, int* top) const {
    int x0b = x0 & (sps_.ctb_size_y - 1);
    int y0b = y0 & (sps_.ctb_size_y - 1);
    *left = (ctb_left_ || x0b)
                ? tab_l[((size_t)(y0 >> min_cb_log2_)) * mcb_w_ +
                        ((x0 - 1) >> min_cb_log2_)]
                : def_l;
    *top = (ctb_up_ || y0b)
               ? tab_t[((size_t)((y0 - 1) >> min_cb_log2_)) * mcb_w_ +
                       (x0 >> min_cb_log2_)]
               : def_t;
  }

  // parity: ff_vvc_split_cu_flag / ff_vvc_split_mode (vvc_cabac.c:1086+)
  int decode_split(int x0, int y0, int w, int h, int cqt_depth, int mtt_depth,
                   const Allowed& a, int ch) {
    const std::vector<int32_t>& cbw = ch ? tab_cbw_c_ : tab_cbw_;
    const std::vector<int32_t>& cbh = ch ? tab_cbh_c_ : tab_cbh_;
    const std::vector<int32_t>& cqt = ch ? tab_cqt_c_ : tab_cqt_;
    bool is_inside = (x0 + w <= pps_.width) && (y0 + h <= pps_.height);
    int split_flag;
    if (a.any() && is_inside) {
      int left_h, top_w;
      left_top_tab(cbh, cbw, x0, y0, h, w, &left_h, &top_w);
      int inc = (left_h < h) + (top_w < w);
      int na = a.btv + a.bth + a.ttv + a.tth + 2 * a.qt;
      inc += (na - 1) / 2 * 3;
      split_flag = bin(SPLIT_CU_FLAG + inc);
    } else {
      split_flag = !is_inside;
    }
    if (!split_flag) return SPLIT_NONE;

    bool allow_no_qt = a.any_mtt();
    int qt_flag;
    if (allow_no_qt && a.qt) {
      int dl, dt;
      left_top_tab(cqt, cqt, x0, y0, 0, 0, &dl, &dt);
      int inc = (dl > cqt_depth) + (dt > cqt_depth) + (cqt_depth >= 2) * 3;
      qt_flag = bin(SPLIT_QT_FLAG + inc);
    } else {
      qt_flag = !allow_no_qt || a.qt;
    }
    if (qt_flag) return SPLIT_QT;

    int vertical;
    if ((a.bth || a.tth) && (a.btv || a.ttv)) {
      int v = a.btv + a.ttv, hh = a.bth + a.tth;
      int inc;
      if (v > hh) {
        inc = 4;
      } else if (v < hh) {
        inc = 3;
      } else {
        int x0b = x0 & (sps_.ctb_size_y - 1);
        int y0b = y0 & (sps_.ctb_size_y - 1);
        bool avail_a = ctb_up_ || y0b;
        bool avail_l = ctb_left_ || x0b;
        int cw_above = avail_a ? cbw[((size_t)((y0 - 1) >> min_cb_log2_))
                                     * mcb_w_ + (x0 >> min_cb_log2_)] : 1;
        int ch_left = avail_l ? cbh[((size_t)(y0 >> min_cb_log2_))
                                    * mcb_w_ + ((x0 - 1) >> min_cb_log2_)]
                              : 1;
        int da = w / (avail_a ? cw_above : 1);
        int dl = h / (avail_l ? ch_left : 1);
        if (da == dl || !avail_a || !avail_l)
          inc = 0;
        else if (da < dl)
          inc = 1;
        else
          inc = 2;
      }
      vertical = bin(MTT_SPLIT_CU_VERTICAL_FLAG + inc);
    } else {
      vertical = !(a.bth || a.tth);
    }
    int binary;
    if ((a.btv && a.ttv && vertical) || (a.bth && a.tth && !vertical)) {
      int inc = 2 * vertical + (mtt_depth <= 1 ? 1 : 0);
      binary = bin(MTT_SPLIT_CU_BINARY_FLAG + inc);
    } else {
      if (!a.btv && !a.bth) binary = 0;
      else if (!a.ttv && !a.tth) binary = 1;
      else if (a.bth && a.ttv) binary = 1 - vertical;
      else binary = vertical;
    }
    static const int modes[4] = {SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER,
                                 SPLIT_BT_VER};
    return modes[(vertical << 1) + binary];
  }

  // parity: vvc_ctu.c:1826-1846 (derive_mode_type_condition)
  int derive_mode_type_condition(int split, int w, int h,
                                 int mode_curr) const {
    const int area = w * h;
    if ((sh_.sh_slice_type == 2 && sps_.sps_qtbtt_dual_tree_intra_flag) ||
        mode_curr != MT_ALL || !sps_.sps_chroma_format_idc ||
        sps_.sps_chroma_format_idc == 3)
      return 0;
    if ((area == 64 && (split == SPLIT_QT || split == SPLIT_TT_HOR ||
                        split == SPLIT_TT_VER)) ||
        (area == 32 && (split == SPLIT_BT_HOR || split == SPLIT_BT_VER)))
      return 1;
    if ((area == 64 && (split == SPLIT_BT_HOR || split == SPLIT_BT_VER) &&
         sps_.sps_chroma_format_idc == 1) ||
        (area == 128 && (split == SPLIT_TT_HOR || split == SPLIT_TT_VER) &&
         sps_.sps_chroma_format_idc == 1) ||
        (w == 8 && split == SPLIT_BT_VER) || (w == 16 && split == SPLIT_TT_VER))
      return 1 + (sh_.sh_slice_type != 2);
    return 0;
  }

  // parity: vvc_ctu.c:1849-1864 (mode_type_decode)
  int mode_type_decode(int x0, int y0, int w, int h, int split, int ch,
                       int mode_curr) {
    const int cond = derive_mode_type_condition(split, w, h, mode_curr);
    if (cond == 1) return MT_INTRA;
    if (cond == 2) {
      // ff_vvc_non_inter_flag (vvc_cabac.c:1196-1205)
      const std::vector<int32_t>& cpm = ch ? tab_cpm_c_ : tab_cpm_;
      int l, t;
      left_top_tab(cpm, cpm, x0, y0, 0, 0, &l, &t);
      return bin(NON_INTER_FLAG + ((l == MODE_INTRA || t == MODE_INTRA)
                                   ? 1 : 0))
                 ? MT_INTRA : MT_INTER;
    }
    return mode_curr;
  }

  void coding_tree(int x0, int y0, int cb_w, int cb_h, int cqt_depth,
                   int mtt_depth, int depth_offset, int part_idx,
                   int last_split, int qg_on_y = 1, int cb_sub_div = 0,
                   int tree_curr = TREE_SINGLE, int mode_curr = MT_ALL) {
    // new quantization group (vvc_ctu.c:2043-2046)
    if (pps_.pps_cu_qp_delta_enabled_flag && qg_on_y &&
        cb_sub_div <= cu_qp_delta_subdiv_) {
      is_cu_qp_delta_coded_ = 0;
      qg_x_ = x0;
      qg_y_ = y0;
    }
    const int ch = tree_curr == TREE_CHROMA;
    Allowed a = can_split(x0, y0, cb_w, cb_h, mtt_depth, depth_offset,
                          part_idx, last_split, tree_curr, mode_curr);
    int split = decode_split(x0, y0, cb_w, cb_h, cqt_depth, mtt_depth, a, ch);
    if (split == SPLIT_NONE) {
      coding_unit(x0, y0, cb_w, cb_h, cqt_depth, tree_curr, mode_curr);
      return;
    }
    const int mode = mode_type_decode(x0, y0, cb_w, cb_h, split, ch,
                                      mode_curr);
    // a MODE_TYPE_INTRA subtree parses luma-only; the chroma of the
    // region follows as one implicit local-dual-tree pass below
    const int tree = (mode == MT_INTRA && tree_curr != TREE_CHROMA)
                         ? TREE_LUMA : tree_curr;
    // TAB_MSM: MTT split modes at 32-aligned nodes, depths 0/1
    // (vvc_ctu.c:2066-2068; read by get_cclm_enabled)
    if (split != SPLIT_QT && !(x0 & 31) && !(y0 & 31) && mtt_depth <= 1)
      msm_at(mtt_depth, x0, y0) = split;

    int W = pps_.width, H = pps_.height;
    switch (split) {
      case SPLIT_QT: {
        int x1 = x0 + cb_w / 2, y1 = y0 + cb_h / 2;
        int sd = cb_sub_div + 2;
        coding_tree(x0, y0, cb_w / 2, cb_h / 2, cqt_depth + 1, 0, 0, 0, split,
                    qg_on_y, sd, tree, mode);
        if (x1 < W)
          coding_tree(x1, y0, cb_w / 2, cb_h / 2, cqt_depth + 1, 0, 0, 1,
                      split, qg_on_y, sd, tree, mode);
        if (y1 < H)
          coding_tree(x0, y1, cb_w / 2, cb_h / 2, cqt_depth + 1, 0, 0, 2,
                      split, qg_on_y, sd, tree, mode);
        if (x1 < W && y1 < H)
          coding_tree(x1, y1, cb_w / 2, cb_h / 2, cqt_depth + 1, 0, 0, 3,
                      split, qg_on_y, sd, tree, mode);
        break;
      }
      case SPLIT_BT_VER: {
        int doff = depth_offset + (x0 + cb_w > W ? 1 : 0);
        int x1 = x0 + cb_w / 2;
        int sd = cb_sub_div + 1;
        coding_tree(x0, y0, cb_w / 2, cb_h, cqt_depth, mtt_depth + 1, doff, 0,
                    split, qg_on_y, sd, tree, mode);
        if (x1 < W)
          coding_tree(x1, y0, cb_w / 2, cb_h, cqt_depth, mtt_depth + 1, doff,
                      1, split, qg_on_y, sd, tree, mode);
        break;
      }
      case SPLIT_BT_HOR: {
        int doff = depth_offset + (y0 + cb_h > H ? 1 : 0);
        int y1 = y0 + cb_h / 2;
        int sd = cb_sub_div + 1;
        coding_tree(x0, y0, cb_w, cb_h / 2, cqt_depth, mtt_depth + 1, doff, 0,
                    split, qg_on_y, sd, tree, mode);
        if (y1 < H)
          coding_tree(x0, y1, cb_w, cb_h / 2, cqt_depth, mtt_depth + 1, doff,
                      1, split, qg_on_y, sd, tree, mode);
        break;
      }
      case SPLIT_TT_VER: {
        int qg = qg_on_y && (cb_sub_div + 2 <= cu_qp_delta_subdiv_);
        coding_tree(x0, y0, cb_w / 4, cb_h, cqt_depth, mtt_depth + 1,
                    depth_offset, 0, split, qg, cb_sub_div + 2, tree, mode);
        coding_tree(x0 + cb_w / 4, y0, cb_w / 2, cb_h, cqt_depth,
                    mtt_depth + 1, depth_offset, 1, split, qg, cb_sub_div + 1,
                    tree, mode);
        coding_tree(x0 + 3 * cb_w / 4, y0, cb_w / 4, cb_h, cqt_depth,
                    mtt_depth + 1, depth_offset, 2, split, qg, cb_sub_div + 2,
                    tree, mode);
        break;
      }
      case SPLIT_TT_HOR: {
        int qg = qg_on_y && (cb_sub_div + 2 <= cu_qp_delta_subdiv_);
        coding_tree(x0, y0, cb_w, cb_h / 4, cqt_depth, mtt_depth + 1,
                    depth_offset, 0, split, qg, cb_sub_div + 2, tree, mode);
        coding_tree(x0, y0 + cb_h / 4, cb_w, cb_h / 2, cqt_depth,
                    mtt_depth + 1, depth_offset, 1, split, qg, cb_sub_div + 1,
                    tree, mode);
        coding_tree(x0, y0 + 3 * cb_h / 4, cb_w, cb_h / 4, cqt_depth,
                    mtt_depth + 1, depth_offset, 2, split, qg, cb_sub_div + 2,
                    tree, mode);
        break;
      }
    }
    // implicit local dual tree: the chroma of a MODE_TYPE_INTRA region
    // parses as one DUAL_TREE_CHROMA pass (hls_coding_tree,
    // vvc_ctu.c:2073-2078)
    if (mode_curr == MT_ALL && mode == MT_INTRA)
      coding_tree(x0, y0, cb_w, cb_h, cqt_depth, mtt_depth, 0, 0, split,
                  0, cb_sub_div, TREE_CHROMA, mode);
  }

  int32_t& msm_at(int depth, int x0, int y0) {
    return tab_msm_[depth][(size_t)(y0 >> 5) * msm_w_ + (x0 >> 5)];
  }

  int get_inc_tab(const std::vector<int32_t>& tab, int x0, int y0) {
    int l, t;
    left_top_tab(tab, tab, x0, y0, 0, 0, &l, &t);
    return (l != 0) + (t != 0);
  }

  // -- CU -------------------------------------------------------------
  void coding_unit(int x0, int y0, int cb_w, int cb_h, int cqt_depth,
                   int tree = TREE_SINGLE, int mode = MT_ALL) {
    CuRecord cu = {};
    cu.x0 = x0;
    cu.y0 = y0;
    cu.w = cb_w;
    cu.h = cb_h;
    cu.ref_idx = -1;
    cu.mip = -1;
    cu.isp_parts = 1;
    prev_tu_cbf_y_ = 0;  // per-CU reset (add_cu, vvc_ctu.c:1205)
    const int ch = tree == TREE_CHROMA;

    // pred_mode_decode (vvc_ctu.c:1032-1092), no IBC
    bool inter_slice = sh_.sh_slice_type != 2;
    bool is_4x4 = cb_w == 4 && cb_h == 4;
    int skip = 0;
    int is_intra = 1;
    if (inter_slice) {
      if (tree != TREE_CHROMA && !is_4x4 && mode != MT_INTRA)
        skip = bin(CU_SKIP_FLAG + get_inc_tab(tab_skip_, x0, y0));
      if (is_4x4 || mode == MT_INTRA) {
        is_intra = 1;
      } else if (mode == MT_INTER || skip) {
        is_intra = 0;
      } else {
        const std::vector<int32_t>& cpm = ch ? tab_cpm_c_ : tab_cpm_;
        int l, t;
        left_top_tab(cpm, cpm, x0, y0, 0, 0, &l, &t);
        is_intra = bin(PRED_MODE_FLAG + ((l || t) ? 1 : 0));
      }
    }
    cu.skip = skip;
    if (tree != TREE_CHROMA) {
      set_cb_tab(tab_skip_, x0, y0, cb_w, cb_h, skip);
      set_cb_tab(tab_cbx_, x0, y0, cb_w, cb_h, x0);
      set_cb_tab(tab_cby_, x0, y0, cb_w, cb_h, y0);
    }
    set_cb_tab(ch ? tab_cbw_c_ : tab_cbw_, x0, y0, cb_w, cb_h, cb_w);
    set_cb_tab(ch ? tab_cbh_c_ : tab_cbh_, x0, y0, cb_w, cb_h, cb_h);
    set_cb_tab(ch ? tab_cqt_c_ : tab_cqt_, x0, y0, cb_w, cb_h, cqt_depth);
    cu.pred_mode = is_intra ? MODE_INTRA : MODE_INTER;
    set_cb_tab(ch ? tab_cpm_c_ : tab_cpm_, x0, y0, cb_w, cb_h, cu.pred_mode);
    if (tree == TREE_SINGLE)
      set_cb_tab(tab_cpm_c_, x0, y0, cb_w, cb_h, cu.pred_mode);

    if (is_intra) {
      if (tree != TREE_CHROMA) {
        // intra_bdpcm_luma (vvc_ctu.c:962-966)
        if (sps_.sps_bdpcm_enabled_flag && cb_w <= sps_.max_ts_size &&
            cb_h <= sps_.max_ts_size)
          cu.bdpcm_l = bin(INTRA_BDPCM_LUMA_FLAG);
        if (cu.bdpcm_l) {
          cu.luma_mode = bin(INTRA_BDPCM_LUMA_DIR_FLAG) ? 50 : 18;
        } else {
          // intra_mip_flag (vvc_ctu.c:967-980, ff_vvc_intra_mip_flag)
          if (sps_.sps_mip_enabled_flag) {
            int inc = (cb_w > cb_h * 2 || cb_h > cb_w * 2)
                          ? 3 : get_inc_tab(tab_imf_, x0, y0);
            if (bin(INTRA_MIP_FLAG + inc)) {
              cu.mip_t = (int)cd_->bypass();
              int c_max = (cb_w == 4 && cb_h == 4) ? 15
                          : ((cb_w == 4 || cb_h == 4) ||
                             (cb_w == 8 && cb_h == 8)) ? 7 : 5;
              cu.mip = truncated_binary(c_max);
            }
          }
          if (cu.mip >= 0) {
            cu.luma_mode = cu.mip;  // tab.ipm stores the MIP mode
          } else {
            // intra_luma_ref_idx (MRL, vvc_ctu.c:984-985): unary, 2 ctx
            if (sps_.sps_mrl_enabled_flag && (y0 & (sps_.ctb_size_y - 1))) {
              if (bin(INTRA_LUMA_REF_IDX))
                cu.mrl = bin(INTRA_LUMA_REF_IDX + 1) ? 2 : 1;
            }
            // intra_subpartitions_mode_flag + split dir
            // (vvc_ctu.c:985-993, ff_vvc_isp_split_type)
            int ispmf = 0;
            if (sps_.sps_isp_enabled_flag && !cu.mrl &&
                cb_w <= sps_.max_tb_size_y && cb_h <= sps_.max_tb_size_y &&
                cb_w * cb_h > 16)
              ispmf = bin(INTRA_SUBPARTITIONS_MODE_FLAG);
            if (!(x0 & 63) && !(y0 & 63) && !tab_ispmf_.empty())
              tab_ispmf_[(size_t)(y0 >> 6) * ispmf_w_ + (x0 >> 6)] = ispmf;
            if (ispmf) {
              cu.isp = 1 + bin(INTRA_SUBPARTITIONS_SPLIT_FLAG);
              cu.isp_parts =
                  ((cb_w == 4 && cb_h == 8) || (cb_w == 8 && cb_h == 4))
                      ? 2 : 4;
              out.has_isp = 1;
            } else {
              cu.isp_parts = 1;
            }
            cu.luma_mode = decode_luma_intra_mode(x0, y0, cb_w, cb_h,
                                                  cu.mrl, ispmf);
          }
        }
        set_cb_tab(tab_imf_, x0, y0, cb_w, cb_h, cu.mip >= 0 ? 1 : 0);
        set_cb_tab(tab_ipm_, x0, y0, cb_w, cb_h, cu.luma_mode);
        set_cb_tab(out.ipm, x0, y0, cb_w, cb_h, cu.luma_mode);
        if (inter_slice) {
          MvF f;
          f.pred_flag = PF_INTRA;
          set_mvf(x0, y0, cb_w, cb_h, f);
        }
      }
      if (tree != TREE_LUMA && sps_.sps_chroma_format_idc) {
        // intra_bdpcm_chroma (vvc_ctu.c:1008-1015)
        if (sps_.sps_bdpcm_enabled_flag &&
            (cb_w >> sps_.hshift_c) <= sps_.max_ts_size &&
            (cb_h >> sps_.vshift_c) <= sps_.max_ts_size)
          cu.bdpcm_c = bin(INTRA_BDPCM_CHROMA_FLAG);
        if (cu.bdpcm_c) {
          cu.chroma_mode = bin(INTRA_BDPCM_CHROMA_DIR_FLAG) ? 50 : 18;
        } else {
          // cclm_mode_flag/idx (vvc_ctu.c:1016-1030; get_cclm_enabled
          // probes the 64x64 luma split under dual tree)
          int cclm_flag = 0;
          if (sps_.sps_cclm_enabled_flag && cclm_enabled_at(x0, y0))
            cclm_flag = bin(CCLM_MODE_FLAG);
          if (cclm_flag) {
            int idx = bin(CCLM_MODE_IDX) ? (int)cd_->bypass() + 1 : 0;
            cu.chroma_mode = INTRA_LT_CCLM + idx;
          } else {
            int chroma_mode_idx =
                bin(INTRA_CHROMA_PRED_MODE) ? (int)cd_->bypass_bits(2) : 4;
            cu.chroma_mode = derive_chroma_mode(chroma_mode_idx,
                                                cu.luma_mode,
                                                x0, y0, cb_w, cb_h);
          }
        }
      }
      if (tree == TREE_CHROMA) {
        // QpY of the luma CB covering the CU centre (set_qp_c,
        // vvc_ctu.c:187-210: ff_vvc_get_qPy path)
        int xc = (x0 + cb_w / 2) >> min_cb_log2_;
        int yc = (y0 + cb_h / 2) >> min_cb_log2_;
        cu.qp = tab_qpy_[(size_t)yc * mcb_w_ + xc];
      } else {
        cu.qp = qp_y_;
      }
      derive_qp_c(cu);
      int cu_index = (int)out.cus.size();
      size_t tu_begin = out.tus.size();
      mts_zero_out_ = 1;
      mts_dc_only_ = 1;
      cu_first_tb_ts_ = -1;
      cu_any_coded_ts_ = 0;
      lfnst_dc_only_ = 1;
      lfnst_zero_out_ = 1;
      sbt_flag_ = 0;
      transform_unit(cu, cu_index, /*is_intra=*/true, /*coded=*/true,
                     /*merge_non_skip=*/false, tree);
      finish_cu_transforms(cu, /*coded=*/true, tu_begin, tree);
      finalize_cu_qp(cu, tu_begin, tree);
      out.cus.push_back(cu);
    } else {
      inter_data(cu);
    }
  }

  void decode_mvd(int32_t* mvd) {
    // mvd_coding (vvc_ctu.c:1466-1489)
    int gt0[2];
    for (int c = 0; c < 2; c++) gt0[c] = bin(ABS_MVD_GREATER0_FLAG);
    int gt1[2] = {0, 0};
    for (int c = 0; c < 2; c++)
      if (gt0[c]) gt1[c] = bin(ABS_MVD_GREATER1_FLAG);
    for (int c = 0; c < 2; c++) {
      int v = gt0[c] + gt1[c];
      mvd[c] = 0;
      if (v > 0) {
        if (v == 2) v += egk_decode(1, 15, 17);
        mvd[c] = cd_->bypass() ? -v : v;
      }
    }
  }

  int decode_ref_idx(int lx) {
    int ref_idx = 0;
    if (sh_.num_ref_idx_active[lx] > 1) {
      int c_max = sh_.num_ref_idx_active[lx] - 1;
      int max_ctx = std::min(c_max, 2);
      int i = 0;
      while (i < max_ctx && bin(REF_IDX_LX + i)) i++;
      if (i == 2)
        while (i < c_max && cd_->bypass()) i++;
      ref_idx = i;
    }
    return ref_idx;
  }

  // -- inter CU (inter_data, vvc_ctu.c:1694-1730; merge_data_regular) --
  void inter_data(CuRecord& cu) {
    int x0 = cu.x0, y0 = cu.y0, w = cu.w, h = cu.h;
    bool is_b = sh_.sh_slice_type == 0;
    int general_merge = 1;
    if (!cu.skip) general_merge = bin(GENERAL_MERGE_FLAG);
    cu.merge = general_merge;
    MvF f;
    int is_ciip = 0;
    int is_gpm = 0;
    int is_sbtmvp = 0;
    int is_affine_amvp = 0;
    int was_mmvd = 0;
    int was_sym_mvd = 0;
    cu.gpm_part = -1;
    if (general_merge) {
      // merge_subblock_flag first (hls_merge_data, vvc_ctu.c:1456-1459;
      // MaxNumSubblockMergeCand without affine = sbtmvp && tmvp)
      const int max_sb_cand =
          sps_.sps_affine_enabled_flag
              ? 5 - sps_.sps_five_minus_max_num_subblock_merge_cand
              : (sps_.sps_sbtmvp_enabled_flag &&
                 sh_.ph.ph_temporal_mvp_enabled_flag);
      if (max_sb_cand > 0 && w >= 8 && h >= 8)
        is_sbtmvp =
            bin(MERGE_SUBBLOCK_FLAG + get_inc_tab(tab_msf_, x0, y0));
    }
    if (general_merge && !is_sbtmvp) {
      // merge_data_block gating (vvc_ctu.c:1338-1360): GPM still off
      const int is_128 = w == 128 || h == 128;
      const int ciip_avail = sps_.sps_ciip_enabled_flag && !cu.skip &&
                             w * h >= 64;
      const int gpm_avail = sps_.sps_gpm_enabled_flag && is_b && w >= 8 &&
                            h >= 8 && w < 8 * h && h < 8 * w;
      int regular = 1;
      if (!is_128 && (ciip_avail || gpm_avail))
        regular = bin(REGULAR_MERGE_FLAG + !cu.skip);
      if (!regular) {
        if (ciip_avail && gpm_avail)
          is_ciip = bin(CIIP_FLAG);
        else
          is_ciip = ciip_avail && !cu.skip && !is_128 && w * h >= 64;
        if (is_ciip) {
          // CIIP above 32x32 (up to 64x64): the intra hypothesis is
          // planar over the WHOLE CU, so the predict unit must keep
          // the CU dims — reuse the 64-wide-unit machinery (has_tb64
          // drives maxs_intra=64 in the frame program)
          if (w > 32 || h > 32) out.has_tb64 = 1;
        } else {
          is_gpm = 1;
        }
      }
    }
    if (is_sbtmvp) {
      set_cb_tab(tab_msf_, x0, y0, w, h, 1);
      // merge_subblock_idx (ff_vvc_merge_subblock_idx)
      int sb_idx = 0;
      const int max_sb =
          sps_.sps_affine_enabled_flag
              ? 5 - sps_.sps_five_minus_max_num_subblock_merge_cand
              : 1;
      if (max_sb > 1 && bin(MERGE_SUBBLOCK_IDX)) {
        sb_idx = 1;
        while (sb_idx < max_sb - 1 && cd_->bypass()) sb_idx++;
      }
      cu.idx = sb_idx;
      sb_merge_mode(cu, x0, y0, w, h, is_b, sb_idx);
    } else if (is_gpm) {
      // merge_data_gpm (vvc_ctu.c:1341-1358) + ff_vvc_luma_mv_merge_gpm
      // (vvc_mvs.c:805-829) + ff_vvc_store_gpm_mvf (vvc_mvs.c:440-486)
      int part = 0;
      for (int j = 0; j < 6; j++) part = (part << 1) | (int)cd_->bypass();
      int gidx[2] = {0, 0};
      const int n_gpm = sps_.max_num_gpm_merge_cand;
      for (int k = 0; k < (n_gpm > 2 ? 2 : 1); k++) {
        int c_max = n_gpm - k - 1;
        if (c_max > 0 && bin(MERGE_IDX)) {
          gidx[k] = 1;
          while (gidx[k] < c_max && cd_->bypass()) gidx[k]++;
        }
      }
      int idx[2] = {gidx[0], gidx[1] + (gidx[1] >= gidx[0] ? 1 : 0)};
      MvF hyp[2];
      for (int k = 0; k < 2; k++) {
        MvF cand = merge_candidate(x0, y0, w, h, idx[k],
                                   sps_.max_num_merge_cand, is_b);
        int lx = idx[k] & 1;
        if (!(cand.pred_flag & (lx + 1))) lx = !lx;
        hyp[k] = MvF();
        hyp[k].pred_flag = lx + 1;
        hyp[k].ref_idx[lx] = cand.ref_idx[lx];
        hyp[k].mv[lx][0] = cand.mv[lx][0];
        hyp[k].mv[lx][1] = cand.mv[lx][1];
      }
      cu.gpm_part = part;
      int lx0 = hyp[0].pred_flag - 1, lx1 = hyp[1].pred_flag - 1;
      cu.gpm_lx0 = lx0;
      cu.gpm_lx1 = lx1;
      cu.pf = 3;
      cu.mv_x = hyp[0].mv[lx0][0];
      cu.mv_y = hyp[0].mv[lx0][1];
      cu.ref_idx = hyp[0].ref_idx[lx0];
      cu.mv1_x = hyp[1].mv[lx1][0];
      cu.mv1_y = hyp[1].mv[lx1][1];
      cu.ref_idx1 = hyp[1].ref_idx[lx1];
      cu.bcw = 0;
      cu.hpel = 0;
      // per-4x4 motion storage by geometric side (store_gpm_mvf)
      {
        const int a = kGpmAngleIdx[part];
        const int d = kGpmDistanceIdx[part];
        const int disp_x = kGpmDistanceLut[a];
        const int disp_y = kGpmDistanceLut[(a + 8) % 32];
        const int is_flip = a >= 13 && a <= 27;
        const int sh_hor = (a % 16 == 8 || (a % 16 && h >= w)) ? 0 : 1;
        const int sign = a < 16 ? 1 : -1;
        int off_x = (-w) >> 1, off_y = (-h) >> 1;
        if (!sh_hor)
          off_y += sign * ((d * h) >> 3);
        else
          off_x += sign * ((d * w) >> 3);
        for (int yy = 0; yy < h; yy += 4)
          for (int xx = 0; xx < w; xx += 4) {
            const int midx = (((xx + off_x) * 2) + 5) * disp_x +
                             (((yy + off_y) * 2) + 5) * disp_y;
            const int s_type = std::abs(midx) < 32
                                   ? 2
                                   : (midx <= 0 ? (1 - is_flip) : is_flip);
            const int pfb = hyp[0].pred_flag | hyp[1].pred_flag;
            if (s_type == 0) {
              set_mvf(x0 + xx, y0 + yy, 4, 4, hyp[0]);
            } else if (s_type == 1 || (s_type == 2 && pfb != 3)) {
              set_mvf(x0 + xx, y0 + yy, 4, 4, hyp[1]);
            } else {
              MvF m2 = hyp[0];
              m2.pred_flag = 3;
              m2.ref_idx[lx1] = hyp[1].ref_idx[lx1];
              m2.mv[lx1][0] = hyp[1].mv[lx1][0];
              m2.mv[lx1][1] = hyp[1].mv[lx1][1];
              set_mvf(x0 + xx, y0 + yy, 4, 4, m2);
            }
          }
      }
    } else if (is_ciip) {
      // merge_data_ciip (vvc_ctu.c:1321-1339): plain merge idx, planar
      // intra over the CU blended with the MC at recon
      int merge_idx = 0;
      if (sps_.max_num_merge_cand > 1) {
        if (bin(MERGE_IDX)) {
          merge_idx = 1;
          while (merge_idx < sps_.max_num_merge_cand - 1 && cd_->bypass())
            merge_idx++;
        }
      }
      cu.idx = merge_idx;
      f = merge_candidate(x0, y0, w, h, merge_idx, sps_.max_num_merge_cand,
                          is_b);
      if (f.pred_flag == PF_BI && w + h == 12) {
        f.pred_flag = PF_L0;
        f.bcw = 0;
      }
      f.bcw = 0;  // derive_weight skips bcw for ciip (vvc_inter.c:158)
      cu.ciip = 1;
      // intra blend weight from neighbour intra-ness at the CU's
      // above-right and below-left cells (vvc_inter.c:523-543)
      cu.ciip_w = 1;
      if (y0 > 0 &&
          mvf_[(size_t)((y0 - 1) >> 2) * pu_w_ + ((x0 - 1 + w) >> 2)]
                  .pred_flag == PF_INTRA)
        cu.ciip_w++;
      if (x0 > 0 &&
          mvf_[(size_t)((y0 - 1 + h) >> 2) * pu_w_ + ((x0 - 1) >> 2)]
                  .pred_flag == PF_INTRA)
        cu.ciip_w++;
    } else if (general_merge) {
      // merge_data_regular (vvc_ctu.c): mmvd, else regular merge idx
      // (ciip/gpm/sbt-merge still gated off at SPS)
      int merge_idx = 0;
      int mmvd = 0;
      int32_t mmvd_off[2] = {0, 0};
      if (sps_.sps_mmvd_enabled_flag) mmvd = bin(MMVD_MERGE_FLAG);
      was_mmvd = mmvd;
      if (mmvd) {
        int cand = 0;
        if (sps_.max_num_merge_cand > 1) cand = bin(MMVD_CAND_FLAG);
        // mmvd_offset_coding (vvc_cabac.c:1395-1417)
        int dist_idx = 0;
        if (bin(MMVD_DISTANCE_IDX)) {
          dist_idx = 1;
          while (dist_idx < 7 && cd_->bypass()) dist_idx++;
        }
        int shift = sh_.ph.ph_mmvd_fullpel_only_flag ? 4 : 2;
        int dist = 1 << (dist_idx + shift);
        int dir = ((int)cd_->bypass() << 1) | (int)cd_->bypass();
        const int signs[4][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}};
        mmvd_off[0] = dist * signs[dir][0];
        mmvd_off[1] = dist * signs[dir][1];
        merge_idx = cand;
      } else if (sps_.max_num_merge_cand > 1) {
        if (bin(MERGE_IDX)) {
          merge_idx = 1;
          while (merge_idx < sps_.max_num_merge_cand - 1 && cd_->bypass())
            merge_idx++;
        }
      }
      cu.idx = merge_idx;
      f = merge_candidate(x0, y0, w, h, merge_idx, sps_.max_num_merge_cand,
                          is_b);
      if (mmvd) {
        // derive_mmvd (vvc_ctu.c): scale the offset to each list by
        // POC distance when bi-predicted
        if (f.pred_flag == PF_BI) {
          int diff0 = out.poc - out.ref_pocs[0][f.ref_idx[0]];
          int diff1 = out.poc - out.ref_pocs[1][f.ref_idx[1]];
          int32_t m0[2], m1[2];
          if (diff0 == diff1) {
            m0[0] = m1[0] = mmvd_off[0];
            m0[1] = m1[1] = mmvd_off[1];
          } else if (std::abs(diff0) < std::abs(diff1)) {
            m1[0] = mmvd_off[0];
            m1[1] = mmvd_off[1];
            mv_scale(m0, mmvd_off, diff1, diff0);
          } else {
            m0[0] = mmvd_off[0];
            m0[1] = mmvd_off[1];
            mv_scale(m1, mmvd_off, diff0, diff1);
          }
          f.mv[0][0] += m0[0];
          f.mv[0][1] += m0[1];
          f.mv[1][0] += m1[0];
          f.mv[1][1] += m1[1];
        } else {
          int idx = f.pred_flag - PF_L0;
          f.mv[idx][0] += mmvd_off[0];
          f.mv[idx][1] += mmvd_off[1];
        }
      }
      // mv_merge_refine_pred_flag: bi & w+h==12 -> L0
      if (f.pred_flag == PF_BI && w + h == 12) {
        f.pred_flag = PF_L0;
        f.bcw = 0;
      }
    } else {
      // AMVP (ff_vvc_pred_flag, vvc_cabac.c:1480); amvr off -> shift 2
      int pf = PF_L0;
      if (is_b) {
        int is_bi = 0;
        if (w + h > 12) {
          int log2 = 0, t = w;
          while (t >>= 1) log2++;
          t = h;
          while (t >>= 1) log2++;
          int inc = 7 - ((1 + log2) >> 1);
          is_bi = bin(INTER_PRED_IDC + inc);
        }
        if (is_bi)
          pf = PF_BI;
        else
          pf = PF_L0 + bin(INTER_PRED_IDC + 5);
      }
      // inter_affine_flag + cu_affine_type_flag (mvp_data,
      // vvc_ctu.c:1540-1560)
      int inter_affine = 0, affine_type = 0;
      if (sps_.sps_affine_enabled_flag && w >= 16 && h >= 16) {
        inter_affine =
            bin(INTER_AFFINE_FLAG + get_inc_tab(tab_msf_, x0, y0));
        if (sps_.sps_6param_affine_enabled_flag && inter_affine)
          affine_type = bin(CU_AFFINE_TYPE_FLAG);
      }
      const int num_cp_mv = inter_affine + affine_type + 1;
      // sym_mvd_flag (mvp_data, vvc_ctu.c:1599-1603)
      int sym_mvd = 0;
      if (sps_.sps_smvd_enabled_flag && !sh_.ph.ph_mvd_l1_zero_flag &&
          pf == PF_BI && !inter_affine &&
          ref_idx_sym_[0] > -1 && ref_idx_sym_[1] > -1)
        sym_mvd = was_sym_mvd = bin(SYM_MVD_FLAG);
      int32_t mvds[2][3][2] = {};
      int mvp_flags[2] = {0, 0};
      int ref_idxs[2] = {-1, -1};
      int has_no_zero_mvd = 0;
      for (int lx = 0; lx < 2; lx++) {
        int skip_flag_pf = lx == 0 ? PF_L1 : PF_L0;
        if (pf != skip_flag_pf) {
          // ref_idx_decode (vvc_ctu.c:1511-1521)
          ref_idxs[lx] = sym_mvd ? ref_idx_sym_[lx] : decode_ref_idx(lx);
          // ph_mvd_l1_zero_flag: L1+BI -> inferred zero
          if (lx == 1 && sh_.ph.ph_mvd_l1_zero_flag && pf == PF_BI) {
            // all cp mvds inferred zero
          } else {
            if (lx == 1 && sym_mvd) {
              // mvds_decode: L1 first-cp mvd mirrored (vvc_ctu.c:1537)
              mvds[1][0][0] = -mvds[0][0][0];
              mvds[1][0][1] = -mvds[0][0][1];
            } else {
              decode_mvd(mvds[lx][0]);
            }
            has_no_zero_mvd |= (mvds[lx][0][0] || mvds[lx][0][1]);
            for (int j = 1; j < num_cp_mv; j++) {
              decode_mvd(mvds[lx][j]);
              mvds[lx][j][0] += mvds[lx][0][0];
              mvds[lx][j][1] += mvds[lx][0][1];
              has_no_zero_mvd |= (mvds[lx][j][0] || mvds[lx][j][1]);
            }
          }
          mvp_flags[lx] = bin(MVP_LX_FLAG);
        }
      }
      cu.idx = mvp_flags[0];
      // AMVR (ff_vvc_amvr_shift, vvc_cabac.c:1551-1583)
      int amvr_shift = 2;
      const int amvr_en = (inter_affine ? sps_.sps_affine_amvr_enabled_flag
                                        : sps_.sps_amvr_enabled_flag) &&
                          has_no_zero_mvd;
      if (amvr_en) {
        if (bin(AMVR_FLAG + inter_affine)) {
          if (inter_affine) {
            // amvr_precision_idx(lc, 2, 1): shift = idx * 4
            amvr_shift = bin(AMVR_PRECISION_IDX + 2) ? 4 : 0;
          } else {
            static const int shifts[3] = {3, 4, 6};
            int idx = 0;
            if (bin(AMVR_PRECISION_IDX)) {
              idx = 1;
              if (bin(AMVR_PRECISION_IDX + 1)) idx = 2;
            }
            amvr_shift = shifts[idx];
          }
        }
      }
      f.hpel = amvr_shift == 3;
      // BCW (bcw_idx_decode, vvc_ctu.c:1490-1509; no explicit WP yet)
      const PredWeight& pw = sh_.pwt;
      const int wpr0 = ref_idxs[0] < 0 ? 0 : ref_idxs[0];
      const int wpr1 = ref_idxs[1] < 0 ? 0 : ref_idxs[1];
      const bool refs_weighted =
          pw.weight_flag[0][0][wpr0] || pw.weight_flag[1][0][wpr1] ||
          pw.weight_flag[0][1][wpr0] || pw.weight_flag[1][1][wpr1];
      if (sps_.sps_bcw_enabled_flag && pf == PF_BI && !refs_weighted &&
          w * h >= 256) {
        int no_backward = 1;
        for (int lx = 0; lx < 2 && no_backward; lx++)
          for (int k = 0; k < out.nb_refs[lx]; k++)
            if (out.ref_pocs[lx][k] > out.poc) {
              no_backward = 0;
              break;
            }
        int c_max = no_backward ? 4 : 2;
        if (bin(BCW_IDX)) {
          int i = 1;
          while (i < c_max && cd_->bypass()) i++;
          f.bcw = i;
        }
      }
      f.pred_flag = pf;
      if (inter_affine) {
        // ff_vvc_affine_mvp + mvp_add_difference + store_sb_mvs
        AffMi mi;
        mi.pf = pf;
        mi.mmi = inter_affine + affine_type;
        mi.bcw = f.bcw;
        int ri[2] = {ref_idxs[0] < 0 ? 0 : ref_idxs[0],
                     ref_idxs[1] < 0 ? 0 : ref_idxs[1]};
        for (int lx = 0; lx < 2; lx++) {
          if (!(pf & (lx + 1))) continue;
          mi.ref_idx[lx] = ri[lx];
          affine_mvp(x0, y0, w, h, mvp_flags[lx], lx, ri, amvr_shift,
                     mi.mmi + 1, mi.cp[lx]);
          for (int j = 0; j < num_cp_mv; j++) {
            mi.cp[lx][j][0] += mvds[lx][j][0] * (1 << amvr_shift);
            mi.cp[lx][j][1] += mvds[lx][j][1] * (1 << amvr_shift);
          }
        }
        is_affine_amvp = 1;
        cu.ref_idx = (pf & PF_L0) ? ref_idxs[0] : -1;
        cu.ref_idx1 = (pf & PF_L1) ? ref_idxs[1] : -1;
        cu.hpel = 0;
        set_cb_tab(tab_msf_, x0, y0, w, h, 1);  // tab.iaf analog
        finish_sb_affine(cu, mi, x0, y0, w, h);
      } else {
        for (int lx = 0; lx < 2; lx++) {
          if (pf & (lx + 1)) {
            int ri[2] = {ref_idxs[0] < 0 ? 0 : ref_idxs[0],
                         ref_idxs[1] < 0 ? 0 : ref_idxs[1]};
            int32_t mv[2];
            mvp(x0, y0, w, h, mvp_flags[lx], lx, ri, amvr_shift, mv);
            f.ref_idx[lx] = ref_idxs[lx];
            f.mv[lx][0] = mv[0] + (mvds[lx][0][0] * (1 << amvr_shift));
            f.mv[lx][1] = mv[1] + (mvds[lx][0][1] * (1 << amvr_shift));
          }
        }
      }
    }
    if (!is_gpm && !is_sbtmvp && !is_affine_amvp) {
      // derive_dmvr_bdof_flag (vvc_ctu.c): BDOF for symmetric-bi
      // translational CUs without bcw/wp/ciip
      if ((sps_.sps_bdof_enabled_flag || sps_.sps_dmvr_enabled_flag) &&
          f.pred_flag == PF_BI && !is_ciip && !f.bcw && w >= 8 && h >= 8 &&
          w * h >= 128) {
        const int p0 = out.ref_pocs[0][f.ref_idx[0]];
        const int p1 = out.ref_pocs[1][f.ref_idx[1]];
        const PredWeight& pwt = sh_.pwt;
        const bool wt = pwt.weight_flag[0][0][f.ref_idx[0]] ||
                        pwt.weight_flag[1][0][f.ref_idx[1]] ||
                        pwt.weight_flag[0][1][f.ref_idx[0]] ||
                        pwt.weight_flag[1][1][f.ref_idx[1]];
        if (out.poc - p0 == p1 - out.poc && !wt) {
          // BDOF excluded for SMVD CUs (derive_dmvr_bdof_flag,
          // vvc_ctu.c:1668-1672)
          if (sps_.sps_bdof_enabled_flag && !was_sym_mvd) cu.bdof = 1;
          // dmvr_flag (vvc_ctu.c): merge without mmvd
          if (sps_.sps_dmvr_enabled_flag && general_merge && !was_mmvd) {
            cu.dmvr = 1;
            out.needs_dmvr = 1;
          }
        }
      }
      f.ciip = is_ciip;
      set_mvf(x0, y0, w, h, f);
      // gpm/subblock skip hmvp (vvc_ctu.c:1723)
      update_hmvp(mvf_at(x0, y0));
      cu.pf = f.pred_flag;
      cu.mv_x = f.mv[0][0];
      cu.mv_y = f.mv[0][1];
      cu.ref_idx = f.ref_idx[0];
      cu.mv1_x = f.mv[1][0];
      cu.mv1_y = f.mv[1][1];
      cu.ref_idx1 = f.ref_idx[1];
      cu.bcw = f.bcw;
      cu.hpel = f.hpel;
    }

    // cu_coded_flag (vvc_ctu.c:1794-1798)
    int coded;
    if (!general_merge)
      coded = bin(CU_CODED_FLAG);
    else
      coded = !cu.skip;
    cu.qp = qp_y_;
    derive_qp_c(cu);
    int cu_index = (int)out.cus.size();
    size_t tu_begin = out.tus.size();
    mts_zero_out_ = 1;
    mts_dc_only_ = 1;
    cu_first_tb_ts_ = -1;
    cu_any_coded_ts_ = 0;
    lfnst_dc_only_ = 1;
    lfnst_zero_out_ = 1;
    decode_sbt_info(cu, coded, is_ciip);
    transform_unit(cu, cu_index, /*is_intra=*/false, coded != 0,
                   /*merge_non_skip=*/general_merge && !cu.skip);
    finish_cu_transforms(cu, coded != 0, tu_begin);
    finalize_cu_qp(cu, tu_begin);
    out.cus.push_back(cu);
  }

  // SBT parse state, valid for the CU being parsed
  int sbt_flag_ = 0, sbt_hor_ = 0, sbt_pos_ = 0, sbt_fourths_tb0_ = 2;

  // parity: sbt_info (vvc_ctu.c:1092-1129) + ff_vvc_sbt_* ctx
  // derivations (vvc_cabac.c:2420-2446)
  void decode_sbt_info(const CuRecord& cu, int coded, int is_ciip) {
    sbt_flag_ = 0;
    if (!coded || cu.pred_mode != MODE_INTER ||
        !sps_.sps_sbt_enabled_flag || is_ciip ||
        cu.w > sps_.max_tb_size_y || cu.h > sps_.max_tb_size_y)
      return;
    const int ver_h = cu.w >= 8, hor_h = cu.h >= 8;
    if (ver_h || hor_h)
      sbt_flag_ = bin(CU_SBT_FLAG + (cu.w * cu.h <= 256));
    if (!sbt_flag_) return;
    const int ver_q = cu.w >= 16, hor_q = cu.h >= 16;
    int quad = 0;
    if ((ver_h || hor_h) && (ver_q || hor_q)) quad = bin(CU_SBT_QUAD_FLAG);
    const int hor_inc = cu.w == cu.h ? 0 : (cu.w < cu.h ? 1 : 2);
    if (quad) {
      sbt_hor_ = hor_q;
      if (ver_q && hor_q) sbt_hor_ = bin(CU_SBT_HORIZONTAL_FLAG + hor_inc);
    } else {
      sbt_hor_ = hor_h;
      if (ver_h && hor_h) sbt_hor_ = bin(CU_SBT_HORIZONTAL_FLAG + hor_inc);
    }
    sbt_pos_ = bin(CU_SBT_POS_FLAG);
    const int sbt_min = quad ? 1 : 2;
    sbt_fourths_tb0_ = sbt_pos_ ? 4 - sbt_min : sbt_min;
  }

  void finalize_cu_qp(CuRecord& cu, size_t tu_begin,
                      int tree = TREE_SINGLE) {
    if (tree != TREE_CHROMA) {
      cu.qp = qp_y_;
      derive_qp_c(cu);
    }
    for (size_t j = tu_begin; j < out.tus.size(); j++) {
      TuRecord& tr = out.tus[j];
      if (tr.c_idx == 0) {
        tr.qp = cu.qp + sps_.qp_bd_offset;
        tr.qp_deq = tr.qp;
      } else {
        // tab qp (deblock) follows set_qp_c_tab: the component qp, or
        // the joint qp when this TU is jointly coded with both cbfs
        tr.qp = cu.qp_c[tr.qsel == 3 ? 2 : tr.c_idx - 1];
        // dequant qp follows derive_qp: the parsed TB's source
        tr.qp_deq = cu.qp_c[tr.qsel ? tr.qsel - 1 : tr.c_idx - 1];
      }
      if (tr.ts) {
        int lo = 4 + 6 * sps_.sps_min_qp_prime_ts;
        int hi = 63 + sps_.qp_bd_offset;
        tr.qp_deq = tr.qp_deq < lo ? lo : (tr.qp_deq > hi ? hi : tr.qp_deq);
      }
    }
    if (tree != TREE_CHROMA)
      set_cb_tab(tab_qpy_, cu.x0, cu.y0, cu.w, cu.h, qp_y_);
  }

  // mts_idx decode + per-TB transform kinds (vvc_ctu.c:842-860,
  // vvc_intra.c:130-164).  Runs after the CU's transform tree; patches
  // the luma TuRecords pushed since tu_begin.
  void finish_cu_transforms(const CuRecord& cu, bool coded,
                            size_t tu_begin, int tree = TREE_SINGLE) {
    bool is_intra = cu.pred_mode == MODE_INTRA;
    // lfnst_idx (vvc_ctu.c:791-850): under a dual chroma tree the size
    // gates use the CHROMA block dims and the kernels apply to the
    // chroma TBs; the first-bin ctx shifts for any dual tree
    // ISP: the size gate uses the sub-partition dims and the dc-only
    // tracker is bypassed (vvc_ctu.c:818-831)
    int lw = tree == TREE_CHROMA ? cu.w >> sps_.hshift_c : cu.w;
    int lh = tree == TREE_CHROMA ? cu.h >> sps_.vshift_c : cu.h;
    if (tree != TREE_CHROMA && cu.isp) {
      if (cu.isp == 2) lw = cu.w / cu.isp_parts;
      if (cu.isp == 1) lh = cu.h / cu.isp_parts;
    }
    int lfnst_idx = 0;
    if (coded && sps_.sps_lfnst_enabled_flag && is_intra &&
        std::max(cu.w, cu.h) <= sps_.max_tb_size_y && !cu_any_coded_ts_ &&
        std::min(lw, lh) >= 4 &&
        !(tree != TREE_CHROMA && cu.mip >= 0 &&
          std::min(lw, lh) < 16)) {  // vvc_ctu.c:826
      if ((cu.isp || !lfnst_dc_only_) && lfnst_zero_out_) {
        if (bin(LFNST_IDX + (tree != TREE_SINGLE)))
          lfnst_idx = bin(LFNST_IDX + 2) ? 2 : 1;
      }
    }
    if (lfnst_idx) {
      const int want_c = tree == TREE_CHROMA ? 1 : 0;
      for (size_t j = tu_begin; j < out.tus.size(); j++) {
        TuRecord& tr = out.tus[j];
        if ((want_c ? tr.c_idx == 0 : tr.c_idx != 0) || !tr.coded) continue;
        // derive_ilfnst_pred_mode_intra + wide angle (vvc_intra.c:380-417);
        // MIP luma / CCLM chroma select the planar transform set
        int base_mode;
        if (want_c)
          base_mode = cu.chroma_mode >= INTRA_LT_CCLM ? 0 : cu.chroma_mode;
        else
          base_mode = cu.mip >= 0 ? 0 : cu.luma_mode;
        // ISP luma uses the CU dims for the wide-angle mapping
        // (ff_vvc_wide_angle_mode_mapping, vvc_intra.c:692-714)
        int mw = tr.w, mh = tr.h;
        if (!want_c && cu.isp) { mw = cu.w; mh = cu.h; }
        int mode = ctrl::wide_angle_map(base_mode, mw, mh);
        tr.lf_tr = mode > 34;
        int set = mode < 0 ? 1 : kLfnstTrSet[mode];
        tr.lf_sel = set * 2 + (lfnst_idx - 1);
      }
    }
    int mts_idx = 0;
    if (tree != TREE_CHROMA && !sbt_flag_ && !cu.isp &&
        coded && !lfnst_idx && sps_.sps_mts_enabled_flag) {
      bool explicit_on = is_intra
          ? sps_.sps_explicit_mts_intra_enabled_flag != 0
          : sps_.sps_explicit_mts_inter_enabled_flag != 0;
      if (explicit_on && std::max(cu.w, cu.h) <= 32 && mts_zero_out_ &&
          !mts_dc_only_ && cu_first_tb_ts_ <= 0) {
        while (mts_idx < 4 && bin(MTS_IDX + mts_idx)) mts_idx++;
      }
    }
    static const int32_t mts_to_trh[] = {0, 1, 2, 1, 2};  // DCT2/DST7/DCT8
    static const int32_t mts_to_trv[] = {0, 1, 1, 2, 2};
    // derive_transform_type (vvc_intra.c:130-165): ISP selects the
    // implicit DST7/DCT2 rule whenever SPS MTS is on (DCT2 with LFNST)
    bool implicit_on = sps_.sps_mts_enabled_flag &&
                       ((cu.isp && !lfnst_idx) ||
                        (!cu.isp && is_intra &&
                         !sps_.sps_explicit_mts_intra_enabled_flag &&
                         !lfnst_idx && cu.mip < 0));
    for (size_t j = tu_begin; j < out.tus.size(); j++) {
      TuRecord& tr = out.tus[j];
      if (tr.c_idx != 0 || !tr.coded) continue;
      if (cu.isp && lfnst_idx) { tr.trh = tr.trv = 0; continue; }
      if (sbt_flag_) {
        // SBT implicit DST7/DCT8 selection by sub-TU position
        // (derive_transform_type, vvc_intra.c:144-156); DCT2 when MTS
        // is off or the TB exceeds the 32-point DST7/DCT8 sizes
        if (sps_.sps_mts_enabled_flag && std::max(tr.w, tr.h) <= 32) {
          tr.trh = (sbt_hor_ || sbt_pos_) ? 1 : 2;
          tr.trv = (!sbt_hor_ || sbt_pos_) ? 1 : 2;
        } else {
          tr.trh = tr.trv = 0;
        }
      } else if (implicit_on) {
        tr.trh = (tr.w >= 4 && tr.w <= 16) ? 1 : 0;
        tr.trv = (tr.h >= 4 && tr.h <= 16) ? 1 : 0;
      } else {
        tr.trh = mts_to_trh[mts_idx];
        tr.trv = mts_to_trv[mts_idx];
      }
    }
    // scaling-matrix id per residual-carrying TB (derive_scale_m,
    // vvc_intra.c:340-385, Table 38); -1 selects the flat default
    if (out.has_sl) {
      static const int ids[2][3][6] = {
          {{0, 2, 8, 14, 20, 26},
           {0, 3, 9, 15, 21, 21},
           {0, 4, 10, 16, 22, 22}},
          {{0, 5, 11, 17, 23, 27},
           {0, 6, 12, 18, 24, 24},
           {1, 7, 13, 19, 25, 25}}};
      const int inter = cu.pred_mode != MODE_INTRA;
      for (size_t j = tu_begin; j < out.tus.size(); j++) {
        TuRecord& tr = out.tus[j];
        if (!tr.res || tr.ts) continue;
        if (sps_.sps_scaling_matrix_for_lfnst_disabled_flag &&
            tr.lf_sel >= 0)
          continue;
        // joint-CbCr derived TBs dequant the parsed component's
        // coefficients -> use the parsed component's matrix
        int eff_c = tr.c_idx;
        if (tr.jop > 0) eff_c = tr.c_idx == 2 ? 1 : 2;
        const int ml2 =
            ctrl::bitlen(std::max(tr.w, tr.h)) - 1;
        tr.slid = ids[inter][eff_c][ml2 - 1];
      }
    }
  }

  int egk_decode(int k, int max_pre, int trunc_len) {
    int pre = 0;
    while (pre < max_pre && cd_->bypass()) pre++;
    int esc = pre == max_pre ? trunc_len : pre + k;
    int val = (int)cd_->bypass_bits(esc);
    return val + (((1 << pre) - 1) << k);
  }

  void set_cb_tab(std::vector<int32_t>& tab, int x0, int y0, int w, int h,
                  int32_t v) {
    int xs = x0 >> min_cb_log2_, ys = y0 >> min_cb_log2_;
    for (int y = 0; y < (h >> min_cb_log2_); y++)
      for (int x = 0; x < (w >> min_cb_log2_); x++)
        tab[(ys + y) * mcb_w_ + xs + x] = v;
  }

  int decode_luma_intra_mode(int x0, int y0, int cb_w, int cb_h,
                             int ref_idx = 0, int ispmf = 0) {
    // parity: vvc_ctu.c:680-789 (luma_intra_pred_mode + MPM list);
    // with MRL (ref_idx > 0) mpm_flag and not_planar are inferred 1
    int mpm_flag = ref_idx ? 1 : bin(INTRA_LUMA_MPM_FLAG);
    int not_planar = 1, mpm_idx = 0, remainder = 0;
    if (mpm_flag) {
      if (!ref_idx)  // ctx inc = !ispmf (ff_vvc_intra_luma_not_planar_flag)
        not_planar = bin(INTRA_LUMA_NOT_PLANAR_FLAG + !ispmf);
      if (not_planar)
        while (mpm_idx < 4 && cd_->bypass()) mpm_idx++;
    } else {
      remainder = truncated_binary(60);
    }
    if (mpm_flag && !not_planar) return INTRA_PLANAR;

    int ctb_mask = sps_.ctb_size_y - 1;
    int x_a = (x0 - 1) >> min_cb_log2_, y_a = (y0 + cb_h - 1) >> min_cb_log2_;
    int x_b = (x0 + cb_w - 1) >> min_cb_log2_, y_b = (y0 - 1) >> min_cb_log2_;
    int x0b = x0 & ctb_mask, y0b = y0 & ctb_mask;
    bool avail_l = ctb_left_ || x0b;
    bool avail_u = ctb_up_ || y0b;
    int a = INTRA_PLANAR, b = INTRA_PLANAR;
    // MIP neighbours count as planar (vvc_ctu.c:719-731 imf gate)
    if (avail_l && cpm_at(x_a, y_a) == MODE_INTRA && !imf_at(x_a, y_a))
      a = ipm_at(x_a, y_a);
    if (avail_u && cpm_at(x_b, y_b) == MODE_INTRA && !imf_at(x_b, y_b) && y0b)
      b = ipm_at(x_b, y_b);

    int cand[5];
    if (a == b && a > INTRA_DC) {
      cand[0] = a;
      cand[1] = 2 + ((a + 61) % 64);
      cand[2] = 2 + ((a - 1) % 64);
      cand[3] = 2 + ((a + 60) % 64);
      cand[4] = 2 + (a % 64);
    } else {
      int minab = a < b ? a : b, maxab = a < b ? b : a;
      if (a > INTRA_DC && b > INTRA_DC) {
        int diff = maxab - minab;
        cand[0] = a;
        cand[1] = b;
        if (diff == 1) {
          cand[2] = 2 + ((minab + 61) % 64);
          cand[3] = 2 + ((maxab - 1) % 64);
          cand[4] = 2 + ((minab + 60) % 64);
        } else if (diff >= 62) {
          cand[2] = 2 + ((minab - 1) % 64);
          cand[3] = 2 + ((maxab + 61) % 64);
          cand[4] = 2 + (minab % 64);
        } else if (diff == 2) {
          cand[2] = 2 + ((minab - 1) % 64);
          cand[3] = 2 + ((minab + 61) % 64);
          cand[4] = 2 + ((maxab - 1) % 64);
        } else {
          cand[2] = 2 + ((minab + 61) % 64);
          cand[3] = 2 + ((minab - 1) % 64);
          cand[4] = 2 + ((maxab + 61) % 64);
        }
      } else if (a > INTRA_DC || b > INTRA_DC) {
        cand[0] = maxab;
        cand[1] = 2 + ((maxab + 61) % 64);
        cand[2] = 2 + ((maxab - 1) % 64);
        cand[3] = 2 + ((maxab + 60) % 64);
        cand[4] = 2 + (maxab % 64);
      } else {
        cand[0] = INTRA_DC;
        cand[1] = INTRA_VERT;
        cand[2] = INTRA_HORZ;
        cand[3] = INTRA_VERT - 4;
        cand[4] = INTRA_VERT + 4;
      }
    }
    if (mpm_flag) return cand[mpm_idx];
    // remainder: rank among non-MPM modes
    for (int i = 0; i < 5; i++)  // insertion sort (5 elems)
      for (int j = i + 1; j < 5; j++)
        if (cand[j] < cand[i]) std::swap(cand[i], cand[j]);
    int pred = remainder + 1;
    for (int i = 0; i < 5; i++)
      if (pred >= cand[i]) pred++;
    return pred;
  }

  // parity: get_cclm_enabled (vvc_ctu.c:629-673): under dual-tree
  // intra with 64+ CTBs, CCLM availability depends on the split
  // structure probed at the covering 64x64 / 32x32 nodes
  int cclm_enabled_at(int x0, int y0) {
    if (!sps_.sps_qtbtt_dual_tree_intra_flag || sh_.sh_slice_type != 2 ||
        sps_.ctb_log2_size_y < 6)
      return 1;
    const int x64 = (x0 >> 6) << 6, y64 = (y0 >> 6) << 6;
    const int y32 = (y0 >> 5) << 5;
    const int x64_cu = x64 >> min_cb_log2_, y64_cu = y64 >> min_cb_log2_;
    const int y32_cu = y32 >> min_cb_log2_;
    auto at = [&](const std::vector<int32_t>& t, int xc, int yc) {
      return t[(size_t)yc * mcb_w_ + xc];
    };
    const int depth = at(tab_cqt_c_, x64_cu, y64_cu);
    const int min_depth = sps_.ctb_log2_size_y - 6;
    const int msm64 = msm_at(0, x64, y64);
    const int msm32 = msm_at(1, x64, y32);
    int enabled = at(tab_cbw_c_, x64_cu, y64_cu) == 64 &&
                  at(tab_cbh_c_, x64_cu, y64_cu) == 64;
    enabled |= (depth == min_depth && msm64 == SPLIT_BT_HOR &&
                at(tab_cbw_c_, x64_cu, y32_cu) == 64 &&
                at(tab_cbh_c_, x64_cu, y32_cu) == 32);
    enabled |= depth > min_depth;
    enabled |= (depth == min_depth && msm64 == SPLIT_BT_HOR &&
                msm32 == SPLIT_BT_VER);
    if (enabled) {
      const int w = at(tab_cbw_, x64_cu, y64_cu);
      const int h = at(tab_cbh_, x64_cu, y64_cu);
      const int depth0 = at(tab_cqt_, x64_cu, y64_cu);
      const int ispmf64 =
          tab_ispmf_[(size_t)(y64 >> 6) * ispmf_w_ + (x64 >> 6)];
      if ((w == 64 && h == 64 && ispmf64) ||
          ((w < 64 || h < 64) && depth0 == min_depth))
        return 0;
    }
    return enabled;
  }

  int derive_chroma_mode(int idx, int luma_mode, int x0, int y0, int cb_w,
                         int cb_h) {
    // center luma mode (single tree, no MIP yet -> CU's own mode works,
    // but use the center sample for parity with split CUs later)
    int xc = (x0 + cb_w / 2) >> min_cb_log2_;
    int yc = (y0 + cb_h / 2) >> min_cb_log2_;
    // a MIP center counts as planar (derive_center_luma_intra_pred_mode,
    // vvc_ctu.c:863-879; 4:4:4 mip_chroma_direct not supported yet)
    int center = imf_at(xc, yc) ? INTRA_PLANAR : ipm_at(xc, yc);
    (void)luma_mode;
    if (idx == 4) return center;
    static const int pred_mode_c[4][5] = {
        {INTRA_VDIAG, INTRA_PLANAR, INTRA_PLANAR, INTRA_PLANAR, INTRA_PLANAR},
        {INTRA_VERT, INTRA_VDIAG, INTRA_VERT, INTRA_VERT, INTRA_VERT},
        {INTRA_HORZ, INTRA_HORZ, INTRA_VDIAG, INTRA_HORZ, INTRA_HORZ},
        {INTRA_DC, INTRA_DC, INTRA_DC, INTRA_VDIAG, INTRA_DC},
    };
    static const int modes[4] = {INTRA_PLANAR, INTRA_VERT, INTRA_HORZ, INTRA_DC};
    int m;
    for (m = 0; m < 4; m++)
      if (modes[m] == center) break;
    return pred_mode_c[idx][m];
  }

  // parity: get_qp_y_pred (vvc_ctu.c:77-126)
  int get_qp_y_pred(const CuRecord& cu) {
    const int ctb_log2 = sps_.ctb_log2_size_y;
    const int ctb_mask = (1 << ctb_log2) - 1;
    const int xQg = qg_x_, yQg = qg_y_;
    const int x_cb = cu.x0 >> min_cb_log2_;
    const int y_cb = cu.y0 >> min_cb_log2_;
    const int x_ctb = cu.x0 >> ctb_log2;
    const int y_ctb = cu.y0 >> ctb_log2;
    const bool in_same_ctb_a = ((xQg - 1) >> ctb_log2) == x_ctb &&
                               (yQg >> ctb_log2) == y_ctb;
    const bool in_same_ctb_b = (xQg >> ctb_log2) == x_ctb &&
                               ((yQg - 1) >> ctb_log2) == y_ctb;
    const int x0b = cu.x0 & ctb_mask, y0b = cu.y0 & ctb_mask;
    const bool cand_left = ctb_left_ || x0b;
    const bool cand_up = ctb_up_ || y0b;

    if (cand_up) {
      const bool first_qg_in_ctu = !(xQg & ctb_mask) && !(yQg & ctb_mask);
      const int qpy_up = tab_qpy_[(size_t)(y_cb - 1) * mcb_w_ + x_cb];
      if (first_qg_in_ctu && pps_.ctb_to_col_bd[xQg >> ctb_log2] == xQg)
        return qpy_up;
    }
    const int qpy_pred = is_first_qg_ ? sh_.slice_qp_y : qp_y_;
    int qpy_b, qpy_a;
    if (!cand_up || !in_same_ctb_b)
      qpy_b = qpy_pred;
    else
      qpy_b = tab_qpy_[(size_t)(y_cb - 1) * mcb_w_ + x_cb];
    if (!cand_left || !in_same_ctb_a)
      qpy_a = qpy_pred;
    else
      qpy_a = tab_qpy_[(size_t)y_cb * mcb_w_ + (x_cb - 1)];
    return (qpy_a + qpy_b + 1) >> 1;
  }

  // parity: set_qp_y (vvc_ctu.c:141-171); x0/y0 are the TU coords
  void set_qp_y(const CuRecord& cu, int x0, int y0, int has_qp_delta) {
    if (!pps_.pps_cu_qp_delta_enabled_flag) {
      qp_y_ = sh_.slice_qp_y;
    } else if (is_first_qg_ || (qg_x_ == x0 && qg_y_ == y0)) {
      qp_y_ = get_qp_y_pred(cu);
      is_first_qg_ = 0;
    }
    if (has_qp_delta) {
      int abs_v = 0;
      if (bin(CU_QP_DELTA_ABS)) {
        // prefix: up to 4 more ctx bins; suffix: EG0 bypass (vvc_cabac.c:1625)
        int v = 1;
        while (v < 5 && bin(CU_QP_DELTA_ABS + 1)) v++;
        if (v < 5) {
          abs_v = v;
        } else {
          int k = 0;
          while (k < 6 && cd_->bypass()) k++;
          int i = (1 << k) - 1;
          int sfx = 0;
          while (k--) sfx = (sfx << 1) + cd_->bypass();
          abs_v = sfx + i + 5;
        }
      }
      int delta = 0;
      if (abs_v) delta = cd_->bypass() ? -abs_v : abs_v;
      is_cu_qp_delta_coded_ = 1;
      if (delta) {
        int off = sps_.qp_bd_offset;
        qp_y_ = (qp_y_ + delta + 64 + 2 * off) % (64 + off) - off;
      }
    }
  }

  void derive_qp_c(CuRecord& cu) {
    // parity: vvc_ctu.c set_qp_c (spec 8.7.1)
    int off = sps_.qp_bd_offset;
    int qp_luma = cu.qp + off;  // single tree
    int qp_chroma = qp_luma < 0 ? 0 : (qp_luma > 63 + off ? 63 + off : qp_luma);
    int sh_off[3] = {sh_.sh_cb_qp_offset, sh_.sh_cr_qp_offset,
                     sh_.sh_joint_cbcr_qp_offset};
    for (int i = 0; i < 2 + sps_.sps_joint_cbcr_enabled_flag; i++) {
      int qp = sps_.chroma_qp_table[i][qp_chroma];
      qp = qp + pps_.chroma_qp_offset[i] + sh_off[i];
      qp = qp < -off ? -off : (qp > 63 ? 63 : qp);
      cu.qp_c[i] = qp + off;
    }
  }

  // -- transform tree / unit ------------------------------------------
  // hls_transform_tree (vvc_ctu.c:406-434): a CU larger than the max
  // transform size splits in half (wider dimension first) until every
  // TU fits; each TU carries its co-located chroma TBs (no ISP/SBT yet).
  void transform_unit(CuRecord& cu, int cu_index, bool is_intra, bool coded,
                      bool merge_non_skip, int tree = TREE_SINGLE) {
    bool chroma_avail = sps_.sps_chroma_format_idc != 0;
    (void)merge_non_skip;
    if (!coded) {
      // skip / uncoded inter CU: record zero-coded TUs for deblock grids
      set_qp_y(cu, cu.x0, cu.y0, 0);
      int hs0 = sps_.hshift_c, vs0 = sps_.vshift_c;
      TuRecord ty = {cu.x0, cu.y0, cu.w, cu.h, 0, 0,
                     cu.qp + sps_.qp_bd_offset, cu_index, 0, 0, 0, 0, 0,
                     0, 0, 0, -1, 0};
      out.tus.push_back(ty);
      if (chroma_avail) {
        TuRecord tb = {cu.x0 >> hs0, cu.y0 >> vs0, cu.w >> hs0, cu.h >> vs0,
                       1, 0, cu.qp_c[0], cu_index};
        TuRecord tr2 = tb;
        tr2.c_idx = 2;
        tr2.qp = cu.qp_c[1];
        out.tus.push_back(tb);
        out.tus.push_back(tr2);
      }
      return;
    }
    bool is_large = cu.w > sps_.max_tb_size_y || cu.h > sps_.max_tb_size_y;
    infer_tu_cbf_luma_ = 1;  // hls_transform_tree, vvc_ctu.c:412
    if (cu.isp) {
      // ISP: 2 or 4 sub-TUs along the split axis; chroma rides the
      // last one (hls_transform_tree, vvc_ctu.c:463-476)
      const int n = cu.isp_parts;
      if (cu.isp == 1) {  // ISP_HOR_SPLIT
        const int hh = cu.h / n;
        for (int i = 0; i < n; i++)
          transform_unit_leaf(cu, cu_index, is_intra, is_large, cu.x0,
                              cu.y0 + hh * i, cu.w, hh, tree, -1, i);
      } else {            // ISP_VER_SPLIT
        const int ww = cu.w / n;
        for (int i = 0; i < n; i++)
          transform_unit_leaf(cu, cu_index, is_intra, is_large,
                              cu.x0 + ww * i, cu.y0, ww, cu.h, tree, -1, i);
      }
      return;
    }
    if (sbt_flag_) {
      // SBT: two TUs, only one carries residual (hls_transform_tree,
      // vvc_ctu.c:437-466)
      if (!sbt_hor_) {
        const int w0 = cu.w * sbt_fourths_tb0_ / 4;
        transform_unit_leaf(cu, cu_index, is_intra, is_large, cu.x0, cu.y0,
                            w0, cu.h, tree, /*sbt_idx=*/0);
        transform_unit_leaf(cu, cu_index, is_intra, is_large, cu.x0 + w0,
                            cu.y0, cu.w - w0, cu.h, tree, /*sbt_idx=*/1);
      } else {
        const int h0 = cu.h * sbt_fourths_tb0_ / 4;
        transform_unit_leaf(cu, cu_index, is_intra, is_large, cu.x0, cu.y0,
                            cu.w, h0, tree, /*sbt_idx=*/0);
        transform_unit_leaf(cu, cu_index, is_intra, is_large, cu.x0,
                            cu.y0 + h0, cu.w, cu.h - h0, tree,
                            /*sbt_idx=*/1);
      }
      return;
    }
    transform_tree(cu, cu_index, is_intra, is_large, cu.x0, cu.y0, cu.w,
                   cu.h, tree);
  }

  void transform_tree(CuRecord& cu, int cu_index, bool is_intra,
                      bool is_large, int x0, int y0, int tw, int th,
                      int tree = TREE_SINGLE) {
    int mtb = sps_.max_tb_size_y;
    if (tw > mtb || th > mtb) {
      bool ver = tw > mtb && tw > th;
      int w2 = ver ? tw / 2 : tw;
      int h2 = ver ? th : th / 2;
      transform_tree(cu, cu_index, is_intra, is_large, x0, y0, w2, h2, tree);
      if (ver)
        transform_tree(cu, cu_index, is_intra, is_large, x0 + w2, y0, w2, h2,
                       tree);
      else
        transform_tree(cu, cu_index, is_intra, is_large, x0, y0 + h2, w2, h2,
                       tree);
      return;
    }
    transform_unit_leaf(cu, cu_index, is_intra, is_large, x0, y0, tw, th,
                        tree);
  }

  void transform_unit_leaf(CuRecord& cu, int cu_index, bool is_intra,
                           bool is_large, int x0, int y0, int tw, int th,
                           int tree = TREE_SINGLE, int sbt_idx = -1,
                           int isp_idx = -1) {
    // SBT: exactly one of the two TUs carries residual
    // (is_sbt_not_coded, vvc_ctu.c:327-328)
    const bool sbt_not_coded =
        sbt_idx >= 0 && ((sbt_idx == 0 && sbt_pos_) ||
                         (sbt_idx == 1 && !sbt_pos_));
    const bool is_isp = cu.isp != 0;
    const bool is_isp_last = is_isp && isp_idx == cu.isp_parts - 1;
    bool chroma_avail = tree != TREE_LUMA &&
                        sps_.sps_chroma_format_idc != 0 &&
                        (!is_isp || is_isp_last);
    int cb_coded = 0, cr_coded = 0;
    if (chroma_avail && !sbt_not_coded) {
      // cbf ctx shifts under BDPCM (vvc_cabac.c:1199-1216)
      cb_coded = bin(TU_CB_CODED_FLAG + cu.bdpcm_c);
      cr_coded = bin(TU_CR_CODED_FLAG + (cu.bdpcm_c ? 2 : cb_coded));
    }
    int is_chroma_coded = chroma_avail && (cb_coded || cr_coded);
    int y_coded = 0;
    if (tree != TREE_CHROMA) {
      // tu_y_coded_flag present for intra, chroma-coded, or split CUs;
      // else inferred 1; SBT not-coded TUs infer 0; for ISP the last
      // sub-TU's cbf is inferred 1 when all previous were 0
      // (tu_y_coded_flag_decode, vvc_ctu.c:273-292)
      if (sbt_not_coded) {
        y_coded = 0;
      } else if (is_isp) {
        const bool has_flag =
            isp_idx < cu.isp_parts - 1 || !infer_tu_cbf_luma_;
        if (has_flag) {
          // ctx inc = 2 + prev_tu_cbf_y (ff_vvc_tu_y_coded_flag)
          y_coded = bin(TU_Y_CODED_FLAG + 2 + prev_tu_cbf_y_);
          prev_tu_cbf_y_ = y_coded;
        } else {
          y_coded = 1;
        }
        infer_tu_cbf_luma_ = infer_tu_cbf_luma_ && !y_coded;
      } else if (is_intra || is_chroma_coded || is_large) {
        y_coded = bin(TU_Y_CODED_FLAG + (cu.bdpcm_l ? 1 : 0));
        prev_tu_cbf_y_ = y_coded;
      } else {
        y_coded = 1;
      }
      // qp_delta presence gates on is_128 (CbWidth/CbHeight > 64,
      // vvc_ctu.c:323,356), NOT is_large (> max_tb_size) which only
      // controls tu_y_coded_flag presence (vvc_ctu.c:283-284)
      const bool is_128 = cu.w > 64 || cu.h > 64;
      const int has_qp_delta = (is_128 || y_coded || is_chroma_coded) &&
                               pps_.pps_cu_qp_delta_enabled_flag &&
                               !is_cu_qp_delta_coded_;
      set_qp_y(cu, x0, y0, has_qp_delta);
    }

    // tu_joint_cbcr_residual_flag (vvc_ctu.c:374-379)
    int joint = 0;
    if (sps_.sps_joint_cbcr_enabled_flag && chroma_avail &&
        ((is_intra && (cb_coded || cr_coded)) || (cb_coded && cr_coded)))
      joint = bin(TU_JOINT_CBCR_RESIDUAL_FLAG + 2 * cb_coded + cr_coded - 1);

    int hs = sps_.hshift_c, vs = sps_.vshift_c;
    // ISP: the last sub-TU carries the whole CU's chroma TBs
    // (hls_transform_unit, vvc_ctu.c:335-346)
    int xc = (is_isp ? cu.x0 : x0) >> hs, yc = (is_isp ? cu.y0 : y0) >> vs;
    int wc = (is_isp ? cu.w : tw) >> hs, hc = (is_isp ? cu.h : th) >> vs;

    // transform_skip_flag (vvc_ctu.c:386-397)
    auto ts_flag = [&](int w_, int h_, int c) -> int {
      int bdpcm = c ? cu.bdpcm_c : cu.bdpcm_l;
      if (bdpcm) return 1;  // forced, no flag (vvc_ctu.c:386)
      if (!sps_.sps_transform_skip_enabled_flag) return 0;
      if (sbt_flag_) return 0;  // !cu->sbt_flag gate (vvc_ctu.c:391)
      if (!c && is_isp) return 0;  // (is_chroma || !is_isp) gate
      if (w_ > sps_.max_ts_size || h_ > sps_.max_ts_size) return 0;
      return bin(TRANSFORM_SKIP_FLAG + (c ? 1 : 0));
    };
    auto residual = [&](int rx0, int ry0, int w_, int h_, int c, int ts) {
      int bdpcm = c ? cu.bdpcm_c : cu.bdpcm_l;
      if (ts) cu_any_coded_ts_ = 1;
      if (ts && !sh_.sh_ts_residual_coding_disabled_flag)
        residual_ts_coding(rx0, ry0, w_, h_, c, bdpcm);
      else
        residual_coding(rx0, ry0, w_, h_, c, ts);
      if (bdpcm)
        bdpcm_accumulate(rx0, ry0, w_, h_, c, cu.luma_mode, cu.chroma_mode);
    };
    int ts_y = 0;
    if (tree != TREE_CHROMA) {
      if (y_coded) {
        ts_y = ts_flag(tw, th, 0);
        residual(x0, y0, tw, th, 0, ts_y);
      }
      if (cu_first_tb_ts_ < 0) cu_first_tb_ts_ = ts_y;
      TuRecord ty = {x0, y0, tw, th, 0, y_coded, cu.qp + sps_.qp_bd_offset,
                     cu_index, 0, 0, y_coded, 0, 0, 0, ts_y, cu.bdpcm_l,
                     -1, 0};
      out.tus.push_back(ty);
      // a 64-sample luma TB (intra predict unit or coded residual)
      // switches the frame to the 64-size residual classes + 64-wide
      // intra units (sps_max_luma_transform_size_64_flag streams)
      if ((tw > 32 || th > 32) && (is_intra || y_coded)) out.has_tb64 = 1;
    }
    if (!chroma_avail) return;

    // which chroma TBs carry a parsed residual (tb->has_coeffs,
    // vvc_ctu.c:383-386): Cb if cbf_cb; Cr if cbf_cr unless joint rides
    // in Cb.  The other component's residual is derived post-ITX.
    int cb_parsed = cb_coded;
    int cr_parsed = cr_coded && !(cb_coded && joint);
    int ts_cb = 0, ts_cr = 0;
    if (cb_parsed) {
      ts_cb = ts_flag(wc, hc, 1);
      residual(xc, yc, wc, hc, 1, ts_cb);
    }
    if (cr_parsed) {
      ts_cr = ts_flag(wc, hc, 2);
      residual(xc, yc, wc, hc, 2, ts_cr);
    }

    int is_jcbcr = joint && cb_coded && cr_coded;
    // qsel: dequant qp source for joint TBs (derive_qp, vvc_intra.c)
    int parsed_c = cb_parsed ? 1 : 2;
    int parsed_qsel = is_jcbcr ? 3 : parsed_c;
    TuRecord tcb = {xc, yc, wc, hc, 1, cb_parsed, cu.qp_c[0], cu_index,
                    0, 0, cb_parsed, 0, cb_parsed ? parsed_qsel : 0, 0,
                    ts_cb, cu.bdpcm_c, -1, 0};
    TuRecord tcr = {xc, yc, wc, hc, 2, cr_parsed, cu.qp_c[1], cu_index,
                    0, 0, cr_parsed, 0, cr_parsed ? parsed_qsel : 0, 0,
                    ts_cr, 0, -1, 0};
    if (joint) {
      // derived component: 1 + cbf_cb (add_residual_for_joint_coding,
      // vvc_intra.c:166-186); shift = cbf_cb ^ cbf_cr
      int shift = cb_coded ^ cr_coded;
      int neg = sh_.ph.ph_joint_cbcr_sign_flag ? 1 : 0;
      int jop = 1 + neg + 2 * shift;
      TuRecord& drv = cb_coded ? tcr : tcb;
      drv.res = 1;
      drv.jop = jop;
      drv.qsel = parsed_qsel;
      drv.ts = cb_parsed ? ts_cb : ts_cr;
      // copy the parsed coefficients into the derived component's
      // coeff plane so the residual buckets stay per-plane
      int src_c = parsed_c, dst_c = cb_coded ? 2 : 1;
      int pw = out.width >> hs;
      for (int yy = 0; yy < hc; yy++) {
        const int32_t* srow =
            out.coeff[src_c].data() + (size_t)(yc + yy) * pw + xc;
        int32_t* drow = out.coeff[dst_c].data() + (size_t)(yc + yy) * pw + xc;
        std::memcpy(drow, srow, sizeof(int32_t) * wc);
      }
    }
    out.tus.push_back(tcb);
    out.tus.push_back(tcr);
  }

  // -- residual coding (regular) --------------------------------------
  // parity: vvc_cabac.c:1843-2460
  struct RcCtx {
    int log2_sb_w, log2_sb_h, num_sb_coeff;
    int w_sbs, h_sbs;
    int last_sb, last_pos;
    int last_x, last_y;
    int rem_bins;
    const DiagScan* sb_scan;
    const DiagScan* scan;
    int plane_w;  // tb width (for local arrays)
    int qstate = 0;  // dep-quant state machine (vvc_cabac.c:1962-1965)
    std::vector<int32_t> abs_level, abs_level_pass1, sig;
    std::vector<uint8_t> sb_coded;
  };
  RcCtx rc_scratch_;  // per-TB scratch, reused to avoid 4 allocs per TB

  // qstate_translate_table (vvc_cabac.c:1962): next state by level parity
  static constexpr uint8_t kQStateTrans[4][2] = {
      {0, 2}, {2, 0}, {1, 3}, {3, 1}};

  static int local_sum(const std::vector<int32_t>& v, int w, int h, int xc,
                       int yc) {
    int s = 0;
    const int32_t* p = v.data() + (size_t)yc * w + xc;
    if (xc < w - 1) {
      s += p[1];
      if (xc < w - 2) s += p[2];
      if (yc < h - 1) s += p[w + 1];
    }
    if (yc < h - 1) {
      s += p[w];
      if (yc < h - 2) s += p[2 * w];
    }
    return s;
  }

  int sig_ctx_inc(const RcCtx& rc, int tb_w, int tb_h, int xc, int yc,
                  int c_idx) {
    // dep-quant biases the context by the quantizer state
    // (vvc_cabac.c:1835-1837); qstate stays 0 when dep quant is off
    int d = xc + yc;
    int loc = local_sum(rc.abs_level_pass1, tb_w, tb_h, xc, yc);
    int m = (loc + 1) >> 1;
    if (m > 3) m = 3;
    int qs = rc.qstate > 1 ? rc.qstate - 1 : 0;
    if (c_idx == 0) return 12 * qs + m + (d < 2 ? 8 : (d < 5 ? 4 : 0));
    return 36 + 8 * qs + m + (d < 2 ? 4 : 0);
  }

  int gtx_ctx_inc(const RcCtx& rc, int tb_w, int tb_h, int xc, int yc,
                  int c_idx, bool is_last) {
    if (is_last) return c_idx == 0 ? 0 : 21;
    int d = xc + yc;
    int loc_sig = local_sum(rc.sig, tb_w, tb_h, xc, yc);
    int loc_p1 = local_sum(rc.abs_level_pass1, tb_w, tb_h, xc, yc);
    int offset = loc_p1 - loc_sig;
    if (offset > 4) offset = 4;
    if (c_idx == 0)
      return 1 + offset + (d == 0 ? 15 : (d < 3 ? 10 : (d < 10 ? 5 : 0)));
    return 22 + offset + (d == 0 ? 5 : 0);
  }

  static const int* rice_params() {
    static const int t[32] = {0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2,
                              2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3};
    return t;
  }

  int rice_param(const RcCtx& rc, int tb_w, int tb_h, int xc, int yc,
                 int base_level) {
    int loc = local_sum(rc.abs_level, tb_w, tb_h, xc, yc) - base_level * 5;
    if (loc < 0) loc = 0;
    if (loc > 31) loc = 31;
    return rice_params()[loc];
  }

  int abs_decode(int c_rice) {
    const int MAX_BIN = 6;
    int prefix = 0;
    while (prefix < MAX_BIN && cd_->bypass()) prefix++;
    if (prefix < MAX_BIN) return (prefix << c_rice) + (int)cd_->bypass_bits(c_rice);
    // limited EGk, k = c_rice + 1
    int k = c_rice + 1;
    int max_pre = 26 - sps_.log2_transform_range;
    int pre = 0;
    while (pre < max_pre && cd_->bypass()) pre++;
    int esc = pre == max_pre ? sps_.log2_transform_range : pre + k;
    int val = (int)cd_->bypass_bits(esc);
    val += ((1 << pre) - 1) << k;
    return val + (MAX_BIN << c_rice);
  }

  int last_sig_prefix(int log2_tb_size, int log2_zo_size, int c_idx, int base) {
    int maximum = (log2_zo_size << 1) - 1;
    int ctx_offset, ctx_shift;
    if (c_idx == 0) {
      static const int offset_y[] = {0, 0, 3, 6, 10, 15};
      ctx_offset = offset_y[log2_tb_size - 1];
      ctx_shift = (log2_tb_size + 1) >> 2;
    } else {
      static const int shifts[] = {0, 0, 0, 1, 2, 2, 2};
      ctx_offset = 20;
      ctx_shift = shifts[log2_tb_size];
    }
    int i = 0;
    while (i < maximum && bin(base + (i >> ctx_shift) + ctx_offset)) i++;
    return i;
  }

  void residual_coding(int x0, int y0, int tb_w, int tb_h, int c_idx,
                       int is_ts = 0) {
    int log2_w = 0, log2_h = 0;
    while ((1 << log2_w) < tb_w) log2_w++;
    while ((1 << log2_h) < tb_h) log2_h++;
    int zo_w = log2_w < 5 ? log2_w : 5;
    int zo_h = log2_h < 5 ? log2_h : 5;
    // SBT 32-point DST7/DCT8 zero-out (hls_residual_coding,
    // vvc_cabac.c:2369-2377)
    if (sps_.sps_mts_enabled_flag && sbt_flag_ && c_idx == 0) {
      if (log2_w == 5 && log2_h < 6) zo_w = 4;
      if (log2_h == 5 && log2_w < 6) zo_h = 4;
    }

    RcCtx& rc = rc_scratch_;  // reused: .assign() below never reallocs
    rc.qstate = 0;            // dep-quant state restarts per TB
    rc.log2_sb_w = (zo_w < 2 || zo_h < 2) ? 1 : 2;
    rc.log2_sb_h = rc.log2_sb_w;
    if (zo_w + zo_h > 3) {
      if (zo_w < 2) {
        rc.log2_sb_w = zo_w;
        rc.log2_sb_h = 4 - rc.log2_sb_w;
      } else if (zo_h < 2) {
        rc.log2_sb_h = zo_h;
        rc.log2_sb_w = 4 - rc.log2_sb_h;
      }
    }
    rc.num_sb_coeff = 1 << (rc.log2_sb_w + rc.log2_sb_h);
    rc.w_sbs = 1 << (zo_w - rc.log2_sb_w);
    rc.h_sbs = 1 << (zo_h - rc.log2_sb_h);
    rc.rem_bins = ((1 << (zo_w + zo_h)) * 7) >> 2;
    rc.sb_scan = &diag_scan(zo_w - rc.log2_sb_w, zo_h - rc.log2_sb_h);
    rc.scan = &diag_scan(rc.log2_sb_w, rc.log2_sb_h);
    rc.abs_level.assign((size_t)tb_w * tb_h, 0);
    rc.abs_level_pass1.assign((size_t)tb_w * tb_h, 0);
    rc.sig.assign((size_t)tb_w * tb_h, 0);
    rc.sb_coded.assign((size_t)rc.w_sbs * rc.h_sbs, 0);

    // last significant coefficient position
    int px = last_sig_prefix(log2_w, zo_w, c_idx, LAST_SIG_COEFF_X_PREFIX);
    int py = last_sig_prefix(log2_h, zo_h, c_idx, LAST_SIG_COEFF_Y_PREFIX);
    int last_x = px, last_y = py;
    if (px > 3) {
      int len = (px >> 1) - 1;
      int suffix = (int)cd_->bypass_bits(len);
      last_x = (1 << ((px >> 1) - 1)) * (2 + (px & 1)) + suffix;
    }
    if (py > 3) {
      int len = (py >> 1) - 1;
      int suffix = (int)cd_->bypass_bits(len);
      last_y = (1 << ((py >> 1) - 1)) * (2 + (py & 1)) + suffix;
    }
    rc.last_x = last_x;
    rc.last_y = last_y;

    // derive last_sub_block / last_scan_pos
    int last_scan_pos = rc.num_sb_coeff;
    int last_sb =
        (1 << (zo_w + zo_h - rc.log2_sb_w - rc.log2_sb_h)) - 1;
    int xc, yc;
    do {
      if (last_scan_pos == 0) {
        last_scan_pos = rc.num_sb_coeff;
        last_sb--;
      }
      last_scan_pos--;
      int xs = rc.sb_scan->x[last_sb], ys = rc.sb_scan->y[last_sb];
      xc = (xs << rc.log2_sb_w) + rc.scan->x[last_scan_pos];
      yc = (ys << rc.log2_sb_h) + rc.scan->y[last_scan_pos];
    } while (xc != last_x || yc != last_y);
    rc.last_sb = last_sb;
    rc.last_pos = last_scan_pos;
    if ((last_sb > 0 || last_scan_pos > 0) && c_idx == 0)
      mts_dc_only_ = 0;  // vvc_cabac.c:2390
    // LFNST trackers (vvc_cabac.c:2383-2389)
    if (!last_sb && log2_w >= 2 && log2_h >= 2 && !is_ts &&
        last_scan_pos > 0)
      lfnst_dc_only_ = 0;
    if ((last_sb > 0 && log2_w >= 2 && log2_h >= 2) ||
        (last_scan_pos > 7 && (log2_w == 2 || log2_w == 3) &&
         log2_w == log2_h))
      lfnst_zero_out_ = 0;

    int32_t* plane;
    int plane_w;
    if (c_idx == 0) {
      plane = out.coeff[0].data();
      plane_w = out.width;
    } else {
      plane = out.coeff[c_idx].data();
      plane_w = out.width >> sps_.hshift_c;
    }

    for (int i = last_sb; i >= 0; i--)
      residual_subblock(rc, i, tb_w, tb_h, c_idx, plane, plane_w, x0, y0);
  }

  void bdpcm_accumulate(int x0, int y0, int tb_w, int tb_h, int c_idx,
                        int luma_mode, int chroma_mode) {
    int mode = c_idx ? chroma_mode : luma_mode;
    bool vertical = mode == 50;
    int32_t* plane;
    int plane_w;
    if (c_idx == 0) {
      plane = out.coeff[0].data();
      plane_w = out.width;
    } else {
      plane = out.coeff[c_idx].data();
      plane_w = out.width >> sps_.hshift_c;
    }
    // Log2TransformRange is fixed 15 without extended precision
    // (vvc_ps.c:81; sps_.log2_transform_range), not bit_depth-derived
    const int range = sps_.log2_transform_range;
    const int64_t hi = (1LL << range) - 1, lo = -(1LL << range);
    auto clip = [&](int64_t v) {
      return (int32_t)(v < lo ? lo : (v > hi ? hi : v));
    };
    if (vertical) {
      for (int y = 1; y < tb_h; y++)
        for (int x = 0; x < tb_w; x++) {
          int32_t* q = plane + (size_t)(y0 + y) * plane_w + x0 + x;
          *q = clip((int64_t)*q + q[-plane_w]);
        }
    } else {
      for (int y = 0; y < tb_h; y++)
        for (int x = 1; x < tb_w; x++) {
          int32_t* q = plane + (size_t)(y0 + y) * plane_w + x0 + x;
          *q = clip((int64_t)*q + q[-1]);
        }
    }
  }

  // -- residual coding (transform skip) -------------------------------
  // parity: vvc_cabac.c:2036-2166 (residual_ts_coding_subblock)
  void residual_ts_coding(int x0, int y0, int tb_w, int tb_h, int c_idx,
                          int bdpcm = 0) {
    int log2_w = 0, log2_h = 0;
    while ((1 << log2_w) < tb_w) log2_w++;
    while ((1 << log2_h) < tb_h) log2_h++;
    int log2_sb_w = (std::min(log2_w, log2_h) < 2) ? 1 : 2;
    int log2_sb_h = log2_sb_w;
    if (log2_w + log2_h > 3) {
      if (log2_w < 2) {
        log2_sb_w = log2_w;
        log2_sb_h = 4 - log2_sb_w;
      } else if (log2_h < 2) {
        log2_sb_h = log2_h;
        log2_sb_w = 4 - log2_sb_h;
      }
    }
    const int num_sb_coeff = 1 << (log2_sb_w + log2_sb_h);
    const int w_sbs = 1 << (log2_w - log2_sb_w);
    const int h_sbs = 1 << (log2_h - log2_sb_h);
    const int last_sb = w_sbs * h_sbs - 1;
    int rem_bins = ((1 << (log2_w + log2_h)) * 7) >> 2;
    const DiagScan& sb_scan = diag_scan(log2_w - log2_sb_w,
                                        log2_h - log2_sb_h);
    const DiagScan& scan = diag_scan(log2_sb_w, log2_sb_h);

    std::vector<int32_t> sig((size_t)tb_w * tb_h, 0);
    std::vector<int32_t> pass1((size_t)tb_w * tb_h, 0);
    std::vector<int32_t> abs_level((size_t)tb_w * tb_h, 0);
    std::vector<int32_t> sign_level((size_t)tb_w * tb_h, 0);
    std::vector<uint8_t> sb_coded((size_t)w_sbs * h_sbs, 0);
    int infer_sb_cbf = 1;

    int32_t* plane;
    int plane_w;
    if (c_idx == 0) {
      plane = out.coeff[0].data();
      plane_w = out.width;
    } else {
      plane = out.coeff[c_idx].data();
      plane_w = out.width >> sps_.hshift_c;
    }

    std::vector<int> gtx(num_sb_coeff);
    std::vector<int> pass2(num_sb_coeff);
    for (int i = 0; i <= last_sb; i++) {
      const int xs = sb_scan.x[i], ys = sb_scan.y[i];
      uint8_t* sbc = &sb_coded[(size_t)ys * w_sbs + xs];
      if (i != last_sb || !infer_sb_cbf) {
        int left = xs > 0 ? sbc[-1] : 0;
        int above = ys > 0 ? sbc[-w_sbs] : 0;
        *sbc = bin(SB_CODED_FLAG + left + above + 4);
      } else {
        *sbc = 1;
      }
      if (*sbc && i < last_sb) infer_sb_cbf = 0;

      int infer_sb_sig = 1;
      int last_pass1 = -1, last_pass2 = -1;
      // first scan pass: sig / sign / gt1 / par
      int n = 0;
      for (; n < num_sb_coeff && rem_bins >= 4; n++) {
        const int xc = (xs << log2_sb_w) + scan.x[n];
        const int yc = (ys << log2_sb_h) + scan.y[n];
        const size_t off = (size_t)yc * tb_w + xc;
        int par = 0;
        gtx[n] = 0;
        last_pass1 = n;
        if (*sbc && (n != num_sb_coeff - 1 || !infer_sb_sig)) {
          int l = xc > 0 ? (int)sig[off - 1] : 0;
          int a = yc > 0 ? (int)sig[off - tb_w] : 0;
          sig[off] = bin(SIG_COEFF_FLAG + 60 + l + a);
          rem_bins--;
          if (sig[off]) infer_sb_sig = 0;
        } else {
          sig[off] = (n == num_sb_coeff - 1) && infer_sb_sig && *sbc;
        }
        sign_level[off] = 0;
        if (sig[off]) {
          int ls = xc > 0 ? (int)sign_level[off - 1] : 0;
          int as = yc > 0 ? (int)sign_level[off - tb_w] : 0;
          int inc;
          if (ls == -as) inc = bdpcm ? 3 : 0;
          else if (ls >= 0 && as >= 0) inc = bdpcm ? 4 : 1;
          else inc = bdpcm ? 5 : 2;
          sign_level[off] = 1 - 2 * bin(COEFF_SIGN_FLAG + inc);
          int gt1_inc;
          if (bdpcm) {
            gt1_inc = 67;
          } else {
            int lsf = xc > 0 ? (int)sig[off - 1] : 0;
            int asf = yc > 0 ? (int)sig[off - tb_w] : 0;
            gt1_inc = 64 + lsf + asf;
          }
          gtx[n] = bin(ABS_LEVEL_GTX_FLAG + gt1_inc);
          rem_bins -= 2;
          if (gtx[n]) {
            par = bin(PAR_LEVEL_FLAG + 32);
            rem_bins--;
          }
        }
        pass1[off] = (int32_t)(sig[off] + par + gtx[n]);
      }

      // greater-than-x pass
      for (n = 0; n < num_sb_coeff && rem_bins >= 4; n++) {
        const int xc = (xs << log2_sb_w) + scan.x[n];
        const int yc = (ys << log2_sb_h) + scan.y[n];
        const size_t off = (size_t)yc * tb_w + xc;
        pass2[n] = (int)pass1[off];
        for (int j = 1; j < 5 && gtx[n]; j++) {
          gtx[n] = bin(ABS_LEVEL_GTX_FLAG + 67 + j);
          pass2[n] += gtx[n] << 1;
          rem_bins--;
        }
        last_pass2 = n;
      }

      // remainder pass
      for (n = 0; n < num_sb_coeff; n++) {
        const int xc = (xs << log2_sb_w) + scan.x[n];
        const int yc = (ys << log2_sb_h) + scan.y[n];
        const size_t off = (size_t)yc * tb_w + xc;
        int abs_rem = 0;
        if ((n <= last_pass2 && pass2[n] >= 10) ||
            (n > last_pass2 && n <= last_pass1 && pass1[off] >= 2) ||
            (n > last_pass1 && *sbc)) {
          int rice = sh_.sh_ts_residual_coding_rice_idx_minus1 + 1;
          abs_rem = abs_decode(rice);
        }
        if (n <= last_pass2)
          abs_level[off] = pass2[n] + 2 * abs_rem;
        else if (n <= last_pass1)
          abs_level[off] = pass1[off] + 2 * abs_rem;
        else {
          abs_level[off] = abs_rem;
          if (abs_rem) sign_level[off] = 1 - 2 * cd_->bypass();
        }
        // level prediction remap (skipped for BDPCM)
        if (!bdpcm && n <= last_pass1) {
          int left = xc > 0 ? (int)abs_level[off - 1] : 0;
          int above = yc > 0 ? (int)abs_level[off - tb_w] : 0;
          int pred = std::max(left, above);
          if (abs_level[off] == 1 && pred > 0)
            abs_level[off] = pred;
          else if (abs_level[off] > 0 && abs_level[off] <= pred)
            abs_level[off]--;
        }
        plane[(size_t)(y0 + yc) * plane_w + (x0 + xc)] =
            abs_level[off] ? sign_level[off] * abs_level[off] : 0;
      }
    }
  }

  void residual_subblock(RcCtx& rc, int i, int tb_w, int tb_h, int c_idx,
                         int32_t* plane, int plane_w, int x0, int y0) {
    int xs = rc.sb_scan->x[i], ys = rc.sb_scan->y[i];
    uint8_t* sbc = &rc.sb_coded[(size_t)ys * rc.w_sbs + xs];
    int infer_sb_dc_sig = 0;
    if (i < rc.last_sb && i > 0) {
      int right = xs < rc.w_sbs - 1 ? sbc[1] : 0;
      int bottom = ys < rc.h_sbs - 1 ? sbc[rc.w_sbs] : 0;
      int inc = (right | bottom) + (c_idx ? 2 : 0);
      *sbc = bin(SB_CODED_FLAG + inc);
      infer_sb_dc_sig = 1;
    } else {
      *sbc = 1;
    }
    if (*sbc && (xs > 3 || ys > 3) && c_idx == 0)
      mts_zero_out_ = 0;  // sig coeff outside 16x16 (vvc_cabac.c:2191)
    if (!*sbc) return;

    int first_pos_mode0 = i == rc.last_sb ? rc.last_pos : rc.num_sb_coeff - 1;
    int first_pos_mode1 = first_pos_mode0;
    int gt2[16] = {0};  // num_sb_coeff <= 16
    int first_sig = rc.num_sb_coeff, last_sig_sb = -1;
    const int dq = sh_.sh_dep_quant_used_flag;
    const int start_qstate_sb = rc.qstate;

    int n = first_pos_mode0;
    for (; n >= 0 && rc.rem_bins >= 4; n--) {
      int xc = (xs << rc.log2_sb_w) + rc.scan->x[n];
      int yc = (ys << rc.log2_sb_h) + rc.scan->y[n];
      bool is_last = xc == rc.last_x && yc == rc.last_y;
      size_t off = (size_t)yc * tb_w + xc;
      int sig;
      if ((n > 0 || !infer_sb_dc_sig) && !is_last) {
        sig = bin(SIG_COEFF_FLAG + sig_ctx_inc(rc, tb_w, tb_h, xc, yc, c_idx));
        rc.rem_bins--;
        if (sig) infer_sb_dc_sig = 0;
      } else {
        sig = is_last ||
              (rc.scan->x[n] == 0 && rc.scan->y[n] == 0 && infer_sb_dc_sig);
      }
      rc.sig[off] = sig;
      int p1 = 0;
      if (sig) {
        int inc = gtx_ctx_inc(rc, tb_w, tb_h, xc, yc, c_idx, is_last);
        int gt1 = bin(ABS_LEVEL_GTX_FLAG + inc);
        rc.rem_bins--;
        int par = 0;
        if (gt1) {
          par = bin(PAR_LEVEL_FLAG + inc);
          gt2[n] = bin(ABS_LEVEL_GTX_FLAG + inc + 32);
          rc.rem_bins -= 2;
        }
        if (last_sig_sb == -1) last_sig_sb = n;
        first_sig = n;
        p1 = 1 + par + gt1 + (gt2[n] << 1);
      }
      rc.abs_level_pass1[off] = p1;
      if (dq) rc.qstate = kQStateTrans[rc.qstate][p1 & 1];
      first_pos_mode1 = n - 1;
    }
    for (n = first_pos_mode0; n > first_pos_mode1; n--) {
      int xc = (xs << rc.log2_sb_w) + rc.scan->x[n];
      int yc = (ys << rc.log2_sb_h) + rc.scan->y[n];
      size_t off = (size_t)yc * tb_w + xc;
      rc.abs_level[off] = rc.abs_level_pass1[off];
      if (gt2[n]) {
        int c_rice = rice_param(rc, tb_w, tb_h, xc, yc, 4);
        int rem = abs_decode(c_rice);
        rc.abs_level[off] += 2 * rem;
      }
    }
    for (n = first_pos_mode1; n >= 0; n--) {
      int xc = (xs << rc.log2_sb_w) + rc.scan->x[n];
      int yc = (ys << rc.log2_sb_h) + rc.scan->y[n];
      size_t off = (size_t)yc * tb_w + xc;
      int c_rice = rice_param(rc, tb_w, tb_h, xc, yc, 0);
      int dec = abs_decode(c_rice);
      int zero_pos = (rc.qstate < 2 ? 1 : 2) << c_rice;
      int abs = 0;
      if (dec != zero_pos) {
        abs = dec;
        if (dec < zero_pos) abs += 1;
      }
      rc.abs_level[off] = abs;
      if (abs > 0) {
        if (last_sig_sb == -1) last_sig_sb = n;
        first_sig = n;
      }
      if (dq) rc.qstate = kQStateTrans[rc.qstate][abs & 1];
    }
    // sign pass with sign-data-hiding + dep-quant level reconstruction
    // (vvc_cabac.c:2277-2312)
    const int sig_hidden = sh_.sh_sign_data_hiding_used_flag &&
                           (last_sig_sb - first_sig > 3 ? 1 : 0);
    if (dq) rc.qstate = start_qstate_sb;
    int sum = 0;
    for (n = first_pos_mode0; n >= 0; n--) {
      int xc = (xs << rc.log2_sb_w) + rc.scan->x[n];
      int yc = (ys << rc.log2_sb_h) + rc.scan->y[n];
      size_t off = (size_t)yc * tb_w + xc;
      int abs = rc.abs_level[off];
      if (abs > 0) {
        int sign = 1;
        if (!sig_hidden || n != first_sig) sign = 1 - 2 * (int)cd_->bypass();
        int level;
        if (dq) {
          level = (2 * abs - (rc.qstate > 1)) * sign;
        } else {
          level = abs * sign;
          if (sig_hidden) {
            sum += abs;
            if (n == first_sig && (sum % 2)) level = -level;
          }
        }
        plane[(size_t)(y0 + yc) * plane_w + (x0 + xc)] = level;
      }
      if (dq) rc.qstate = kQStateTrans[rc.qstate][abs & 1];
    }
  }
};


// ---------------- C API ----------------
extern "C" {

void* vvch_new() { return new Decoder(); }
void vvch_free(void* h) { delete (Decoder*)h; }

static thread_local std::string g_err;

int vvch_decode_au(void* h, const uint8_t* data, int len) {
  auto* d = (Decoder*)h;
  d->frame_ready = false;
  return d->decode_au(data, (size_t)len, &g_err);
}

const char* vvch_last_error() { return g_err.c_str(); }

// info: [frame_ready,width,height,bit_depth,chroma_idc,poc,slice_qp,
//        n_cus,n_tus,mcb_w,mcb_h,deblock_disabled,
//        beta_off_l,beta_off_cb,beta_off_cr,tc_off_l,tc_off_cb,tc_off_cr]
void vvch_frame_info(void* h, int32_t* info) {
  auto* d = (Decoder*)h;
  const FrameOut& o = d->out;
  info[0] = d->frame_ready;
  info[1] = o.width;
  info[2] = o.height;
  info[3] = o.bit_depth;
  info[4] = o.chroma_format_idc;
  info[5] = o.poc;
  info[6] = o.slice_qp;
  info[7] = (int32_t)o.cus.size();
  info[8] = (int32_t)o.tus.size();
  info[9] = o.mcb_w;
  info[10] = o.mcb_h;
  info[11] = o.deblock_disabled;
  for (int i = 0; i < 3; i++) {
    info[12 + i] = o.beta_offset[i];
    info[15 + i] = o.tc_offset[i];
  }
  info[18] = o.ctb_log2;
  info[19] = o.max_num_reorder;
  info[20] = o.dep_quant;
  for (int i = 0; i < 4; i++) info[21 + i] = o.crop[i];
  info[25] = o.gdr_pic;
  info[26] = o.recovery_poc_cnt;
  info[27] = o.has_isp;
  info[28] = o.has_sl;
  info[29] = o.has_tb64;
  info[30] = o.ref_wraparound_offset;
}

// active scaling-list matrices: 28 matrices expanded to an 8x8 grid
// (top-left msize x msize occupied), then 14 dc values.  sl_rec stores
// each matrix with its own row stride (2/4/8).
void vvch_sl(void* h, int32_t* out_buf) {
  const FrameOut& o = ((Decoder*)h)->out;
  int k = 0;
  for (int id = 0; id < 28; id++) {
    const int msize = id < 2 ? 2 : (id < 8 ? 4 : 8);
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++)
        out_buf[k++] = (y < msize && x < msize)
                           ? o.sl_rec[id][y * msize + x] : 0;
  }
  for (int i = 0; i < 14; i++) out_buf[k++] = o.sl_dc_rec[i];
}

// tile boundaries in luma samples: out[0]=n_cols+1, out[1]=n_rows+1,
// then col bds (incl. 0 and width) and row bds (incl. 0 and height)
void vvch_tile_bd(void* h, int32_t* out) {
  const FrameOut& o = ((Decoder*)h)->out;
  out[0] = (int32_t)o.tile_col_bd.size();
  out[1] = (int32_t)o.tile_row_bd.size();
  int k = 2;
  for (int v : o.tile_col_bd) out[k++] = v;
  for (int v : o.tile_row_bd) out[k++] = v;
}

const int32_t* vvch_coeffs(void* h, int c_idx) {
  return ((Decoder*)h)->out.coeff[c_idx].data();
}
const int32_t* vvch_cus(void* h) {
  return (const int32_t*)((Decoder*)h)->out.cus.data();
}
const int32_t* vvch_tus(void* h) {
  return (const int32_t*)((Decoder*)h)->out.tus.data();
}
const int32_t* vvch_ipm(void* h) { return ((Decoder*)h)->out.ipm.data(); }
const int32_t* vvch_sao(void* h) { return ((Decoder*)h)->out.sao.data(); }
const int32_t* vvch_mvf(void* h, int which) {
  FrameOut& o = ((Decoder*)h)->out;
  switch (which) {
    case 0: return o.mvf_pf.data();
    case 1: return o.mvf_x.data();
    case 2: return o.mvf_y.data();
    case 3: return o.mvf_ref.data();
    case 4: return o.mvf_x1.data();
    case 5: return o.mvf_y1.data();
    case 6: return o.mvf_ref1.data();
    default: return o.mvf_ciip.data();
  }
}
// ALF derived state.  vvch_alf_info: [enabled, cc_cb_en, cc_cr_en,
// n_aps_luma, num_chroma_alts].  vvch_alf_small packs the fixed-size
// tables: chroma_coeff (8*6), chroma_clipidx (8*6), cc_coeff (2*4*7).
void vvch_alf_info(void* h, int32_t* info) {
  const AlfOut& a = ((Decoder*)h)->out.alf;
  info[0] = a.enabled;
  info[1] = a.cc_enabled[0];
  info[2] = a.cc_enabled[1];
  info[3] = a.n_aps_luma;
  info[4] = a.num_chroma_alts;
}
void vvch_alf_small(void* h, int32_t* o) {
  const AlfOut& a = ((Decoder*)h)->out.alf;
  std::memcpy(o, a.chroma_coeff, sizeof(a.chroma_coeff));
  std::memcpy(o + 48, a.chroma_clipidx, sizeof(a.chroma_clipidx));
  std::memcpy(o + 96, a.cc_coeff, sizeof(a.cc_coeff));
}
const int32_t* vvch_alf_luma_coeff(void* h) {
  return ((Decoder*)h)->out.alf.luma_coeff.data();
}
const int32_t* vvch_alf_luma_clipidx(void* h) {
  return ((Decoder*)h)->out.alf.luma_clipidx.data();
}
const int32_t* vvch_alf_ctb(void* h) {
  return ((Decoder*)h)->out.alf.ctb.data();
}

// LMCS derived state: [enabled, crs_flag, min_bin, max_bin,
// pivot[17], fwd_scale[16], inv_scale[16], chroma_scale[16]] (69 ints)
void vvch_lmcs(void* h, int32_t* info) {
  const LmcsOut& lm = ((Decoder*)h)->out.lmcs;
  info[0] = lm.enabled;
  info[1] = lm.crs_flag;
  info[2] = lm.min_bin;
  info[3] = lm.max_bin;
  std::memcpy(info + 4, lm.pivot, sizeof(lm.pivot));
  std::memcpy(info + 21, lm.fwd_scale, sizeof(lm.fwd_scale));
  std::memcpy(info + 37, lm.inv_scale, sizeof(lm.inv_scale));
  std::memcpy(info + 53, lm.chroma_scale, sizeof(lm.chroma_scale));
}

// [slice_type, nb_refs0, nb_refs1, ref_pocs0[16], ref_pocs1[16]]
void vvch_ref_info(void* h, int32_t* info) {
  FrameOut& o = ((Decoder*)h)->out;
  info[0] = o.slice_type;
  info[1] = o.nb_refs[0];
  info[2] = o.nb_refs[1];
  for (int lx = 0; lx < 2; lx++)
    for (int i = 0; i < 16; i++) info[3 + lx * 16 + i] = o.ref_pocs[lx][i];
}

// (26, n_units) int32 control matrix in recon.py CTRL_KEYS order —
// one column per predict unit (intra TBs + inter CUs, in decode
// order); *n_out receives n_units.  Valid until the next call with the
// same is_chroma on this thread.
// same as vvch_cu_ctrl but against a detached FrameOut (DMVR frames
// recompute unit controls after the refined MVs arrive)
const int32_t* vvch_fo_cu_ctrl(void* fo_, int is_chroma, int ctb_log2,
                               int chunk_cap, int32_t* n_out) {
  auto& fo = *(vvc::FrameOut*)fo_;
  static thread_local std::vector<int32_t> bufs[2];
  auto& buf = bufs[is_chroma ? 1 : 0];
  auto units = ctrl::predict_units(fo, is_chroma != 0);
  buf.resize((size_t)ctrl::kNumKeys * units.size() + 1);
  ctrl::derive(fo, is_chroma != 0, ctb_log2, units, buf.data(),
               chunk_cap > 0 ? chunk_cap : 1 << 30);
  *n_out = (int32_t)units.size();
  return buf.data();
}

const int32_t* vvch_cu_ctrl(void* h, int is_chroma, int ctb_log2,
                            int chunk_cap, int32_t* n_out) {
  auto* d = (Decoder*)h;
  static thread_local std::vector<int32_t> bufs[2];
  auto& buf = bufs[is_chroma ? 1 : 0];
  auto units = ctrl::predict_units(d->out, is_chroma != 0);
  buf.resize((size_t)ctrl::kNumKeys * units.size() + 1);
  ctrl::derive(d->out, is_chroma != 0, ctb_log2, units, buf.data(),
               chunk_cap > 0 ? chunk_cap : 1 << 30);
  *n_out = (int32_t)units.size();
  return buf.data();
}

// Session-scoped collocated stores: a VVCDecoder session creates one
// store and attaches it to every pooled handle; epochs (IDR count at
// the AU) disambiguate restarted POCs.
void* vvch_colstore_new() { return new vvc::ColStore(); }
void vvch_colstore_free(void* s) { delete (vvc::ColStore*)s; }
void vvch_set_colstore(void* h, void* s) {
  ((Decoder*)h)->colstore = (vvc::ColStore*)s;
}
void vvch_set_epoch(void* h, int epoch) { ((Decoder*)h)->epoch = epoch; }

void vvch_col_reset() {}  // legacy no-op: stores are session-scoped now

// DMVR (8.5.3): receive the refined per-4x4 subblock MVs from the
// python search, stash them for ctrl::derive, and publish the deferred
// collocated motion (original field with refined DMVR-CU cells,
// set_dmvr_info/fill_dmvr_info semantics, vvc_inter.c:316-330).
// valid[cell] marks cells inside DMVR CUs; nobdof[cell] carries the
// per-subblock SAD-based BDOF kill.
void vvch_dmvr_apply(void* fo_, void* colstore, int epoch,
                     const int32_t* rx0, const int32_t* ry0,
                     const int32_t* rx1, const int32_t* ry1,
                     const int32_t* valid, const int32_t* nobdof) {
  vvc::FrameOut& fo = *(vvc::FrameOut*)fo_;
  const size_t n = (size_t)(fo.width >> 2) * (fo.height >> 2);
  fo.dmvr_x0.assign(rx0, rx0 + n);
  fo.dmvr_y0.assign(ry0, ry0 + n);
  fo.dmvr_x1.assign(rx1, rx1 + n);
  fo.dmvr_y1.assign(ry1, ry1 + n);
  fo.dmvr_nobdof.assign(nobdof, nobdof + n);
  auto cdta = std::make_shared<vvc::ColData>();
  cdta->poc = fo.poc;
  cdta->pu_w = fo.width >> 2;
  cdta->pu_h = fo.height >> 2;
  cdta->mvf = fo.pending_col;
  for (size_t i = 0; i < n && i < cdta->mvf.size(); i++) {
    if (valid[i]) {
      cdta->mvf[i].mv[0][0] = rx0[i];
      cdta->mvf[i].mv[0][1] = ry0[i];
      cdta->mvf[i].mv[1][0] = rx1[i];
      cdta->mvf[i].mv[1][1] = ry1[i];
    }
  }
  for (int lx = 0; lx < 2; lx++) {
    cdta->nb_refs[lx] = fo.nb_refs[lx];
    std::memcpy(cdta->ref_pocs[lx], fo.ref_pocs[lx],
                sizeof(cdta->ref_pocs[lx]));
  }
  ((vvc::ColStore*)colstore)->publish(epoch, fo.poc, std::move(cdta));
  fo.pending_col.clear();
}

// Per-TuRecord unit-slot mapping for plane kind `is_chroma` (see
// predict_units): out must hold n_tus int32; -1 = TU has no slot in
// this kind (wrong component, or an uncoded multi-tile leaf).
void vvch_tu_slots(void* h, int is_chroma, int32_t* out) {
  auto* d = (Decoder*)h;
  std::vector<int32_t> slots;
  ctrl::predict_units(d->out, is_chroma != 0, &slots);
  std::memcpy(out, slots.data(), sizeof(int32_t) * slots.size());
}

int vvch_cu_record_size() { return (int)(sizeof(CuRecord) / 4); }
int vvch_tu_record_size() { return (int)(sizeof(TuRecord) / 4); }

// ---------------- residual bucket fill (device input assembly) -------
// The frame program consumes residuals as size-bucketed batches (one
// (cap, h, w) level block array + one (11, cap) per-TU scalar matrix
// per (w, h) size class, pipeline.py:_bucket_inputs).  Assembling
// those in numpy costs ~20 GIL-bound ms/frame at 720p; this fills the
// python-allocated buffers in one C pass over the TU list instead.
//
// vvch_detach moves the parsed FrameOut onto the heap so the fill can
// run on a worker thread after the pooled Decoder handle is reused.

void* vvch_detach(void* h) {
  return new FrameOut(std::move(((Decoder*)h)->out));
}
void vvch_fo_free(void* fo) { delete (FrameOut*)fo; }

namespace {
// row order of the per-bucket scalar matrix (pipeline.py BUCKET_ROWS)
enum BucketRow {
  kBX0, kBY0, kBScale, kBShift, kBSlot, kBTrh, kBTrv, kBJop, kBTs,
  kBLfSel, kBLfTr,
  // kBVpdu: linear index of the owning CU's LMCS chroma-scale VPDU
  // (min(ctb,64)-sized luma grid; lmcs_derive_chroma_scale,
  // vvc_intra_template.c:390-428)
  kBVpdu,
  // kBSbs: subblock split size (0 = none): the TU's residual block is
  // redistributed across the consecutive per-subblock predict-unit
  // slots starting at kBSlot (SbTMVP units are 8x8 luma / 4x4 chroma)
  kBSbs,
  // kBSlId: scaling-matrix id (Table 38; -1 = flat default 16)
  kBSlId,
  kBucketRows
};

inline int size_key(int w, int h) {
  int lw = 31 - __builtin_clz((unsigned)w);
  int lh = 31 - __builtin_clz((unsigned)h);
  return lw * 8 + lh;
}
}  // namespace

// Deblock control grids for one component at g-sample granularity:
// per-cell TU top-left/size/qp plus the parsed-cbf plane.  One pass
// over the TU list replaces ~150 ms/frame of per-TU numpy rectangle
// fills at 1080p (deblock_ctrl._tu_grids / cbf_plane).
// Outputs are (gh, gw) row-major int32: pos_x, pos_y, tw, th, qp
// (minus qp_bd_offset), cbf.
void vvch_fo_tu_grids(void* fo_, int c_idx, int g, int qp_bd_offset,
                      int32_t* pos_x, int32_t* pos_y, int32_t* tw,
                      int32_t* th, int32_t* qp, int32_t* cbf) {
  FrameOut& fo = *(FrameOut*)fo_;
  int ss = c_idx == 0 ? 0 : 1;
  int W = fo.width >> ss, H = fo.height >> ss;
  int gw = W / g, gh = H / g;
  size_t n = (size_t)gw * gh;
  std::memset(pos_x, 0, n * 4);
  std::memset(pos_y, 0, n * 4);
  std::memset(tw, 0, n * 4);
  std::memset(th, 0, n * 4);
  std::memset(qp, 0, n * 4);
  std::memset(cbf, 0, n * 4);
  for (const TuRecord& tu : fo.tus) {
    if (tu.c_idx != c_idx) continue;
    const int xs = tu.x0 / g, ys = tu.y0 / g;
    const int xe = (tu.x0 + tu.w) / g, ye = (tu.y0 + tu.h) / g;
    const int32_t q = tu.qp - qp_bd_offset;
    // deblock cbf: parsed tu_coded_flag, OR'd with the joint-CbCr
    // derived-component flag for chroma (vvc_filter.c:680-684)
    const int32_t coded = tu.coded || (c_idx && tu.jop > 0);
    for (int y = ys; y < ye && y < gh; y++) {
      const size_t row = (size_t)y * gw;
      const int x1 = xe < gw ? xe : gw;
      for (int x = xs; x < x1; x++) {
        pos_x[row + x] = tu.x0;
        pos_y[row + x] = tu.y0;
        tw[row + x] = tu.w;
        th[row + x] = tu.h;
        qp[row + x] = q;
        if (coded) cbf[row + x] = 1;
      }
    }
  }
}

// counts[k] = number of coded TUs of plane c_idx with size sizes[k]
void vvch_fo_bucket_counts(void* fo_, int c_idx, int n_sizes,
                           const int32_t* sizes, int32_t* counts) {
  FrameOut& fo = *(FrameOut*)fo_;
  int lut[64];
  std::memset(lut, -1, sizeof(lut));
  for (int k = 0; k < n_sizes; k++)
    lut[size_key(sizes[2 * k], sizes[2 * k + 1])] = k;
  std::memset(counts, 0, sizeof(int32_t) * n_sizes);
  for (const TuRecord& tu : fo.tus) {
    if (tu.c_idx != c_idx || !tu.res) continue;
    int k = lut[size_key(tu.w, tu.h)];
    if (k >= 0) counts[k]++;
  }
}

// Fill the per-bucket buffers for plane c_idx.
//   sizes:  (n_sizes, 2) int32 [w, h]
//   caps:   (n_sizes,)  bucket capacities
//   scsh:   (n_sizes, 4, 128) dequant tables [sc, sh, sc_ts, sh_ts]
//           indexed by qp_deq + 32 (clamped)
//   slots:  per-TuRecord predict-unit slot for this plane kind
//           (vvch_tu_slots output; may be null -> slot stays -1)
//   mats:   n_sizes pointers to (11, cap) int32 (fully initialized here)
//   lvs:    n_sizes pointers to (cap, h, w) int16 (fully initialized);
//           transform coefficient levels are spec-clamped to
//           [-2^15, 2^15-1] (log2TransformRange = 15), so int16 is
//           exact and halves the host->device bytes
// Returns 0, or -1 if any bucket overflows its capacity (caller must
// treat this as fatal: silent truncation would corrupt frames).
int vvch_fo_fill_buckets(void* fo_, int c_idx, int n_sizes,
                         const int32_t* sizes, const int32_t* caps,
                         const int32_t* scsh, const int32_t* slots,
                         void** mats, void** lvs) {
  FrameOut& fo = *(FrameOut*)fo_;
  int lut[64];
  std::memset(lut, -1, sizeof(lut));
  for (int k = 0; k < n_sizes; k++)
    lut[size_key(sizes[2 * k], sizes[2 * k + 1])] = k;

  // defaults for unused rows (shift=1 keeps `1 << shift` benign;
  // slot/lf_sel = -1 mean "none")
  for (int k = 0; k < n_sizes; k++) {
    int32_t* m = (int32_t*)mats[k];
    const int cap = caps[k];
    std::memset(m, 0, sizeof(int32_t) * kBucketRows * cap);
    std::fill(m + (size_t)kBShift * cap, m + (size_t)(kBShift + 1) * cap, 1);
    std::fill(m + (size_t)kBSlot * cap, m + (size_t)(kBSlot + 1) * cap, -1);
    std::fill(m + (size_t)kBLfSel * cap, m + (size_t)(kBLfSel + 1) * cap,
              -1);
    std::fill(m + (size_t)kBSlId * cap, m + (size_t)(kBSlId + 1) * cap,
              -1);
    // 64-point DCT2 high-frequency zero-out: coefficients beyond the
    // low 32x32 region are never coded (log2_zo = min(log2, 5), spec
    // residual_coding; ff_vvc_inv_dct2_64 zero-out in vvc_itx_1d.c:375-
    // 655), so 64-dim buckets store only the coded (zh, zw) corner
    const int zw_k = sizes[2 * k] > 32 ? 32 : sizes[2 * k];
    const int zh_k = sizes[2 * k + 1] > 32 ? 32 : sizes[2 * k + 1];
    std::memset(lvs[k], 0, sizeof(int16_t) * (size_t)cap * zw_k * zh_k);
  }

  int32_t counts[64] = {};
  const int ss = (c_idx && fo.chroma_format_idc == 1) ? 1 : 0;
  const int pw = c_idx ? (fo.width >> ss) : fo.width;
  const int32_t* plane = fo.coeff[c_idx].data();
  const int vsz = std::min(1 << fo.ctb_log2, 64);  // LMCS VPDU size
  const int nvx = (fo.width + vsz - 1) / vsz;
  for (size_t j = 0; j < fo.tus.size(); j++) {
    const TuRecord& tu = fo.tus[j];
    if (tu.c_idx != c_idx || !tu.res) continue;
    const int k = lut[size_key(tu.w, tu.h)];
    if (k < 0) return -1;  // size outside the bucket list
    const int n = counts[k]++;
    if (n >= caps[k]) return -1;  // overflow: capacity model violated
    const int cap = caps[k];
    int32_t* m = (int32_t*)mats[k];
    int qp = tu.qp_deq + 32;
    qp = qp < 0 ? 0 : (qp > 127 ? 127 : qp);
    const int32_t* tab = scsh + (size_t)k * 4 * 128;
    m[(size_t)kBX0 * cap + n] = tu.x0;
    m[(size_t)kBY0 * cap + n] = tu.y0;
    m[(size_t)kBScale * cap + n] = tab[(tu.ts ? 2 : 0) * 128 + qp];
    m[(size_t)kBShift * cap + n] = tab[(tu.ts ? 3 : 1) * 128 + qp];
    if (slots) m[(size_t)kBSlot * cap + n] = slots[j];
    m[(size_t)kBTrh * cap + n] = tu.trh;
    m[(size_t)kBTrv * cap + n] = tu.trv;
    {
      const CuRecord& bcu = fo.cus[tu.cu_index];
      int sbs = 0;
      if (bcu.pred_mode == 0) {
        if (bcu.affine)
          sbs = c_idx ? (8 >> ss) : 4;
        else if (bcu.sbtmvp)
          sbs = c_idx ? (8 >> ss) : 8;
        else if (bcu.dmvr)
          sbs = c_idx ? (16 >> ss) : 16;
        else if (bcu.bdof)
          sbs = c_idx ? 0 : 16;
      }
      m[(size_t)kBSbs * cap + n] = sbs;
    }
    m[(size_t)kBJop * cap + n] = tu.jop;
    m[(size_t)kBTs * cap + n] = tu.ts;
    m[(size_t)kBLfSel * cap + n] = tu.lf_sel;
    m[(size_t)kBLfTr * cap + n] = tu.lf_tr;
    m[(size_t)kBSlId * cap + n] = tu.slid;
    const CuRecord& cu = fo.cus[tu.cu_index];
    m[(size_t)kBVpdu * cap + n] = (cu.y0 / vsz) * nvx + (cu.x0 / vsz);
    const int zw = tu.w > 32 ? 32 : tu.w;   // 64-point zero-out region
    const int zh = tu.h > 32 ? 32 : tu.h;
    int16_t* lv = (int16_t*)lvs[k] + (size_t)n * zw * zh;
    for (int yy = 0; yy < zh; yy++) {
      const int32_t* src = plane + (size_t)(tu.y0 + yy) * pw + tu.x0;
      int16_t* dst = lv + (size_t)yy * zw;
      for (int xx = 0; xx < zw; xx++) dst[xx] = (int16_t)src[xx];
    }
  }
  return 0;
}

}  // extern "C"

}  // namespace vvc
