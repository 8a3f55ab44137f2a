// H.266 CABAC *encoder* + residual_coding encoder — native hot path for
// the test-stream generator.
//
// Bin-exact mirror of the Python implementation in
// `bitstream/cabac.py` (CabacEncoder: exact-interval
// arithmetic with incremental carry-propagating byte flush) and
// `encoder/residual.py` (regular + transform-skip
// residual_coding per spec 7.3.11.11 / 9.3.4.2.x; decode-side parity
// target `libavcodec/vvc/vvc_cabac.c:1700-2460`).  The Python classes
// stay as the plain version that the tests hold this engine against;
// the generator runs only this one, because the per-bin Python loop
// dominated stream-generation time (90 s for one 720p all-intra stream).
// Built on its own into libvvc_enc.so (encoder/native_cabac.py); the
// decoder's libvvc_host.so does not hold it.
//
// Exposed C API (ctypes): vvce_new/free/init_states/bin/bypass/
// bypass_bits/terminate/finish + vvce_residual / vvce_residual_ts.

#include <cstdint>
#include <cstring>
#include <vector>

#include "cabac_tables.h"

namespace vvce {


using vvc::kInitValues;
using vvc::kNumContexts;

static const int kRiceParams[32] = {
    0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3};

// qstate_translate_table (vvc_cabac.c:1962)
static const int kQStateTrans[4][2] = {{0, 2}, {2, 0}, {1, 3}, {3, 1}};

// ---------------------------------------------------------------------
// Diagonal scan (spec 6.5.2, mirrors encoder/scan.py diag_scan)
struct Scan {
  std::vector<int> x, y;
};

static Scan diag_scan(int blk_w, int blk_h) {
  Scan s;
  int x = 0, y = 0;
  while ((int)s.x.size() < blk_w * blk_h) {
    while (y >= 0) {
      if (x < blk_w && y < blk_h) {
        s.x.push_back(x);
        s.y.push_back(y);
      }
      y -= 1;
      x += 1;
    }
    y = x;
    x = 0;
  }
  return s;
}

// ---------------------------------------------------------------------
// Arithmetic encoder (mirror of bitstream/cabac.py CabacEncoder).
// `low` is an exact integer of `nbits` bits whose high bytes flush
// incrementally once nbits exceeds KEEP, with +1 carries propagated
// into already-flushed bytes.
struct Encoder {
  static constexpr int kKeep = 64;

  unsigned __int128 low = 0;
  int range = 510;
  int nbits = 9;
  std::vector<uint8_t> out;

  int32_t state0[kNumContexts];
  int32_t state1[kNumContexts];
  int32_t shift0[kNumContexts];
  int32_t shift1[kNumContexts];

  void init_states(int qp, int init_type) {
    if (qp < 0) qp = 0;
    if (qp > 63) qp = 63;
    for (int i = 0; i < kNumContexts; i++) {
      int init_value = kInitValues[init_type][i];
      int shift_idx = kInitValues[3][i];
      int m = (init_value >> 3) - 4;
      int n = (init_value & 7) * 18 + 1;
      int pre = ((m * (qp - 16)) >> 1) + n;
      pre = pre < 1 ? 1 : (pre > 127 ? 127 : pre);
      state0[i] = pre << 3;
      state1[i] = pre << 7;
      shift0[i] = (shift_idx >> 2) + 2;
      shift1[i] = (shift_idx & 3) + 3 + shift0[i];
    }
  }

  void carry_check() {
    if (low >> nbits) {
      low -= (unsigned __int128)1 << nbits;
      for (int i = (int)out.size() - 1; i >= 0; i--) {
        if (out[i] == 0xFF) {
          out[i] = 0;
        } else {
          out[i] += 1;
          return;
        }
      }
      // carry out of stream start: unreachable for conforming input
    }
  }

  void shift(int n = 1) {
    low <<= n;
    nbits += n;
    while (nbits >= kKeep + 8) {
      int top = nbits - 8;
      uint8_t byte = (uint8_t)(low >> top);
      out.push_back(byte);
      low -= (unsigned __int128)byte << top;
      nbits -= 8;
    }
  }

  void bin(int ctx, int binval) {
    int p_state = state1[ctx] + (state0[ctx] << 4);
    int val_mps = p_state >> 14;
    int q_range = range >> 5;
    int prob = val_mps ? 32767 - p_state : p_state;
    int lps = ((q_range * (prob >> 9)) >> 1) + 4;
    range -= lps;
    if (binval != val_mps) {
      low += (unsigned)range;
      range = lps;
      carry_check();
    }
    while (range < 256) {
      range <<= 1;
      shift();
    }
    state0[ctx] += ((1023 * binval) >> shift0[ctx]) - (state0[ctx] >> shift0[ctx]);
    state1[ctx] += ((16383 * binval) >> shift1[ctx]) - (state1[ctx] >> shift1[ctx]);
  }

  void bypass(int binval) {
    shift();
    if (binval) {
      low += (unsigned)range;
      carry_check();
    }
  }

  void bypass_bits(uint32_t value, int n) {
    for (int i = n - 1; i >= 0; i--) bypass((value >> i) & 1);
  }

  void terminate(int binval) {
    range -= 2;
    if (binval) {
      low += (unsigned)range;
      range = 2;
      carry_check();
    }
    while (range < 256) {
      range <<= 1;
      shift();
    }
  }

  // Close the interval; append the remaining bits of the codeword with
  // the most trailing zeros in [low, low+range).  Mirrors finish().
  void finish() {
    unsigned __int128 lo = low, hi = low + (unsigned)range;
    unsigned __int128 code = hi - 1;
    for (int k = nbits; k >= 0; k--) {
      unsigned __int128 cand =
          ((lo + ((unsigned __int128)1 << k) - 1) >> k) << k;
      if (cand < hi) {
        code = cand;
        break;
      }
    }
    int rem = nbits;
    while (rem >= 8) {
      rem -= 8;
      out.push_back((uint8_t)(code >> rem));
    }
    if (rem) {
      out.push_back(
          (uint8_t)(((code & (((unsigned __int128)1 << rem) - 1)) << (8 - rem))));
    }
  }
};

// ---------------------------------------------------------------------
// Residual coding (mirror of encoder/residual.py).

struct Residual {
  Encoder& e;
  int is_intra_slice, dep_quant, sign_hiding;
  int qstate = 0;
  // tracker-clear bitmask returned to Python
  int clear_flags = 0;  // 1:lfnst_dc 2:lfnst_zo 4:mts_dc 8:mts_zo

  const int32_t* coeffs;  // row-major h x w
  int w, h;

  Residual(Encoder& enc, const int32_t* c, int w_, int h_, int intra,
           int dq, int sh)
      : e(enc), is_intra_slice(intra), dep_quant(dq), sign_hiding(sh),
        coeffs(c), w(w_), h(h_) {}

  int at(int x, int y) const { return coeffs[y * w + x]; }

  static int local_sum(const std::vector<int>& lvl, int w, int h, int xc,
                       int yc) {
    // spec 9.3.4.2.7 locSumAbs template (right/below neighbours)
    int s = 0;
    if (xc < w - 1) {
      s += lvl[yc * w + xc + 1];
      if (xc < w - 2) s += lvl[yc * w + xc + 2];
      if (yc < h - 1) s += lvl[(yc + 1) * w + xc + 1];
    }
    if (yc < h - 1) {
      s += lvl[(yc + 1) * w + xc];
      if (yc < h - 2) s += lvl[(yc + 2) * w + xc];
    }
    return s;
  }

  void abs_encode(int value, int c_rice, int log2_transform_range = 15) {
    const int kMaxBin = 6;
    int prefix = value >> c_rice;
    if (prefix < kMaxBin) {
      for (int i = 0; i < prefix; i++) e.bypass(1);
      e.bypass(0);
      e.bypass_bits(value & ((1 << c_rice) - 1), c_rice);
    } else {
      for (int i = 0; i < kMaxBin; i++) e.bypass(1);
      int k = c_rice + 1;
      int max_pre_ext_len = 26 - log2_transform_range;
      int val = value - (kMaxBin << c_rice);
      int pre_ext_len = 0;
      while (pre_ext_len < max_pre_ext_len &&
             val >= (((1 << (pre_ext_len + 1)) - 1) << k))
        pre_ext_len += 1;
      for (int i = 0; i < pre_ext_len; i++) e.bypass(1);
      int escape_len;
      if (pre_ext_len < max_pre_ext_len) {
        e.bypass(0);
        escape_len = pre_ext_len + k;
      } else {
        escape_len = log2_transform_range;
      }
      int rem = val - (((1 << pre_ext_len) - 1) << k);
      e.bypass_bits(rem, escape_len);
    }
  }

  static int group_idx(int value) {
    int p = 0;
    for (;;) {
      int lo = p > 3 ? (1 << ((p >> 1) - 1)) * (2 + (p & 1)) : p;
      int nxt = p + 1;
      int hi = nxt > 3 ? (1 << ((nxt >> 1) - 1)) * (2 + (nxt & 1)) : nxt;
      if (lo <= value && value < hi) return p;
      p += 1;
    }
  }

  void last_sig_prefix(int value, int log2_tb_size, int log2_zo_size,
                       int c_idx, int ctx_base) {
    int prefix = value <= 3 ? value : group_idx(value);
    int maximum = (log2_zo_size << 1) - 1;
    int ctx_offset, ctx_shift;
    if (c_idx == 0) {
      static const int offset_y[6] = {0, 0, 3, 6, 10, 15};
      ctx_offset = offset_y[log2_tb_size - 1];
      ctx_shift = (log2_tb_size + 1) >> 2;
    } else {
      static const int shifts[7] = {0, 0, 0, 1, 2, 2, 2};
      ctx_offset = 20;
      ctx_shift = shifts[log2_tb_size];
    }
    for (int i = 0; i < prefix; i++)
      e.bin(ctx_base + (i >> ctx_shift) + ctx_offset, 1);
    if (prefix < maximum)
      e.bin(ctx_base + (prefix >> ctx_shift) + ctx_offset, 0);
  }

  void last_sig_suffix(int value, int prefix) {
    if (prefix > 3) {
      int base = (1 << ((prefix >> 1) - 1)) * (2 + (prefix & 1));
      int length = (prefix >> 1) - 1;
      e.bypass_bits(value - base, length);
    }
  }

  int sig_ctx_inc(const std::vector<int>& p1, int xc, int yc,
                  int c_idx) const {
    int d = xc + yc;
    int loc = local_sum(p1, w, h, xc, yc);
    int qs = qstate - 1;
    if (qs < 0) qs = 0;
    if (c_idx == 0) {
      int m = (loc + 1) >> 1;
      if (m > 3) m = 3;
      return 12 * qs + m + (d < 2 ? 8 : (d < 5 ? 4 : 0));
    }
    int m = (loc + 1) >> 1;
    if (m > 3) m = 3;
    return 36 + 8 * qs + m + (d < 2 ? 4 : 0);
  }

  int gtx_ctx_inc(const std::vector<int>& sig, const std::vector<int>& p1,
                  int xc, int yc, int c_idx, int is_last) const {
    if (is_last) return c_idx == 0 ? 0 : 21;
    int d = xc + yc;
    int loc_sig = local_sum(sig, w, h, xc, yc);
    int loc_p1 = local_sum(p1, w, h, xc, yc);
    int offset = loc_p1 - loc_sig;
    if (offset > 4) offset = 4;
    if (c_idx == 0)
      return 1 + offset + (d == 0 ? 15 : (d < 3 ? 10 : (d < 10 ? 5 : 0)));
    return 22 + offset + (d == 0 ? 5 : 0);
  }

  int rice_param(const std::vector<int>& abs_level, int xc, int yc,
                 int base_level) const {
    int loc = local_sum(abs_level, w, h, xc, yc) - base_level * 5;
    if (loc < 0) loc = 0;
    if (loc > 31) loc = 31;
    return kRiceParams[loc];
  }

  // -- regular residual_coding -----------------------------------------
  void encode(int c_idx) {
    int log2_w = 31 - __builtin_clz((unsigned)w);
    int log2_h = 31 - __builtin_clz((unsigned)h);
    int zo_w = log2_w < 5 ? log2_w : 5, zo_h = log2_h < 5 ? log2_h : 5;

    int log2_sb_w = (zo_w < 2 || zo_h < 2) ? 1 : 2;
    int log2_sb_h = log2_sb_w;
    if (zo_w + zo_h > 3) {
      if (zo_w < 2) {
        log2_sb_w = zo_w;
        log2_sb_h = 4 - log2_sb_w;
      } else if (zo_h < 2) {
        log2_sb_h = zo_h;
        log2_sb_w = 4 - log2_sb_h;
      }
    }
    int num_sb_coeff = 1 << (log2_sb_w + log2_sb_h);
    int w_sbs = 1 << (zo_w - log2_sb_w);
    int h_sbs = 1 << (zo_h - log2_sb_h);
    Scan sb_scan = diag_scan(w_sbs, h_sbs);
    Scan scan = diag_scan(1 << log2_sb_w, 1 << log2_sb_h);
    int rem_bins = ((1 << (zo_w + zo_h)) * 7) >> 2;

    // last significant coefficient in scan order
    int last_sb = -1, last_pos = -1;
    for (int i = (int)sb_scan.x.size() - 1; i >= 0 && last_sb < 0; i--) {
      int xs = sb_scan.x[i], ys = sb_scan.y[i];
      for (int n = num_sb_coeff - 1; n >= 0; n--) {
        int xc = (xs << log2_sb_w) + scan.x[n];
        int yc = (ys << log2_sb_h) + scan.y[n];
        if (at(xc, yc)) {
          last_sb = i;
          last_pos = n;
          break;
        }
      }
    }
    // caller guarantees a nonzero block (cbf set)
    int xs = sb_scan.x[last_sb], ys = sb_scan.y[last_sb];
    int last_x = (xs << log2_sb_w) + scan.x[last_pos];
    int last_y = (ys << log2_sb_h) + scan.y[last_pos];

    last_sig_prefix(last_x, log2_w, zo_w, c_idx, vvc::LAST_SIG_COEFF_X_PREFIX);
    last_sig_prefix(last_y, log2_h, zo_h, c_idx, vvc::LAST_SIG_COEFF_Y_PREFIX);
    last_sig_suffix(last_x, last_x > 3 ? group_idx(last_x) : last_x);
    last_sig_suffix(last_y, last_y > 3 ? group_idx(last_y) : last_y);

    // lfnst/mts parse-state tracking (vvc_cabac.c:2407-2437)
    if (last_sb == 0 && log2_w >= 2 && log2_h >= 2 && last_pos > 0)
      clear_flags |= 1;
    if ((last_sb > 0 && log2_w >= 2 && log2_h >= 2) ||
        (last_pos > 7 && (log2_w == 2 || log2_w == 3) && log2_w == log2_h))
      clear_flags |= 2;
    if ((last_sb > 0 || last_pos > 0) && c_idx == 0) clear_flags |= 4;

    std::vector<int> abs_level(w * h, 0), abs_p1(w * h, 0), sig_flag(w * h, 0);
    std::vector<int> sb_coded(w_sbs * h_sbs, 0);
    qstate = 0;  // per-TB (init_residual_coding, vvc_cabac.c:2035)

    for (int i = last_sb; i >= 0; i--) {
      encode_subblock(i, last_sb, last_pos, sb_scan, scan, log2_sb_w,
                      log2_sb_h, num_sb_coeff, w_sbs, h_sbs, c_idx, rem_bins,
                      last_x, last_y, abs_level, abs_p1, sig_flag, sb_coded);
    }
  }

  void encode_subblock(int i, int last_sb, int last_pos, const Scan& sb_scan,
                       const Scan& scan, int log2_sb_w, int log2_sb_h,
                       int num_sb_coeff, int w_sbs, int h_sbs, int c_idx,
                       int& rem_bins, int last_x, int last_y,
                       std::vector<int>& abs_level, std::vector<int>& abs_p1,
                       std::vector<int>& sig_flag,
                       std::vector<int>& sb_coded) {
    int xs = sb_scan.x[i], ys = sb_scan.y[i];
    int coded = 0;
    for (int yy = ys << log2_sb_h; yy < (ys + 1) << log2_sb_h && !coded; yy++)
      for (int xx = xs << log2_sb_w; xx < (xs + 1) << log2_sb_w; xx++)
        if (at(xx, yy)) {
          coded = 1;
          break;
        }
    int infer_sb_dc_sig = 0;
    if (0 < i && i < last_sb) {
      int right = xs < w_sbs - 1 ? sb_coded[ys * w_sbs + xs + 1] : 0;
      int bottom = ys < h_sbs - 1 ? sb_coded[(ys + 1) * w_sbs + xs] : 0;
      int inc = (right | bottom) + (c_idx ? 2 : 0);
      e.bin(vvc::SB_CODED_FLAG + inc, coded);
      infer_sb_dc_sig = 1;
    } else {
      coded = 1;
    }
    sb_coded[ys * w_sbs + xs] = coded;
    if (coded && (xs > 3 || ys > 3) && c_idx == 0) clear_flags |= 8;
    if (!coded) return;

    int first_pos_mode0 = i == last_sb ? last_pos : num_sb_coeff - 1;
    int first_pos_mode1 = first_pos_mode0;
    std::vector<int> gt2(num_sb_coeff, 0);
    int first_sig = num_sb_coeff;
    int last_sig_sb = -1;
    int start_qstate_sb = qstate;

    int n = first_pos_mode0;
    while (n >= 0 && rem_bins >= 4) {
      int xc = (xs << log2_sb_w) + scan.x[n];
      int yc = (ys << log2_sb_h) + scan.y[n];
      int level = at(xc, yc);
      if (level < 0) level = -level;
      int is_last = (xc == last_x && yc == last_y);
      int sig;
      if ((n > 0 || !infer_sb_dc_sig) && !is_last) {
        sig = level > 0;
        e.bin(vvc::SIG_COEFF_FLAG + sig_ctx_inc(abs_p1, xc, yc, c_idx), sig);
        rem_bins -= 1;
        if (sig) infer_sb_dc_sig = 0;
      } else {
        sig = (is_last || (scan.x[n] == 0 && scan.y[n] == 0 && infer_sb_dc_sig))
                  ? 1
                  : 0;
      }
      sig_flag[yc * w + xc] = sig;
      int p1 = 0;
      if (sig) {
        int inc = gtx_ctx_inc(sig_flag, abs_p1, xc, yc, c_idx, is_last);
        int gt1 = level > 1;
        e.bin(vvc::ABS_LEVEL_GTX_FLAG + inc, gt1);
        rem_bins -= 1;
        int par = 0;
        if (gt1) {
          par = (level - 2) & 1;
          gt2[n] = level > 3;
          e.bin(vvc::PAR_LEVEL_FLAG + inc, par);
          e.bin(vvc::ABS_LEVEL_GTX_FLAG + inc + 32, gt2[n]);
          rem_bins -= 2;
        }
        if (last_sig_sb == -1) last_sig_sb = n;
        first_sig = n;
        p1 = 1 + par + gt1 + (gt2[n] << 1);
      }
      abs_p1[yc * w + xc] = p1;
      if (dep_quant) qstate = kQStateTrans[qstate][p1 & 1];
      first_pos_mode1 = n - 1;
      n -= 1;
    }

    // remainder pass for pass-1-coded positions
    for (int m = first_pos_mode0; m > first_pos_mode1; m--) {
      int xc = (xs << log2_sb_w) + scan.x[m];
      int yc = (ys << log2_sb_h) + scan.y[m];
      int level = at(xc, yc);
      if (level < 0) level = -level;
      abs_level[yc * w + xc] = abs_p1[yc * w + xc];
      if (gt2[m]) {
        int rem = (level - 4) >> 1;
        int c_rice = rice_param(abs_level, xc, yc, 4);
        abs_encode(rem, c_rice);
        abs_level[yc * w + xc] = level;
      }
    }

    // mode1: dec_abs_level coding for the rest
    for (int m = first_pos_mode1; m >= 0; m--) {
      int xc = (xs << log2_sb_w) + scan.x[m];
      int yc = (ys << log2_sb_h) + scan.y[m];
      int level = at(xc, yc);
      if (level < 0) level = -level;
      int c_rice = rice_param(abs_level, xc, yc, 0);
      int zero_pos = (qstate < 2 ? 1 : 2) << c_rice;
      int dec;
      if (level == 0)
        dec = zero_pos;
      else if (level <= zero_pos)
        dec = level - 1;
      else
        dec = level;
      abs_encode(dec, c_rice);
      abs_level[yc * w + xc] = level;
      if (level > 0) {
        if (last_sig_sb == -1) last_sig_sb = m;
        first_sig = m;
      }
      if (dep_quant) qstate = kQStateTrans[qstate][level & 1];
    }

    // sign pass (sign hiding: first significant coefficient's sign is
    // inferred from the level-sum parity, vvc_cabac.c:2277-2312)
    int sig_hidden = sign_hiding && (last_sig_sb - first_sig > 3);
    if (dep_quant) qstate = start_qstate_sb;
    for (int m = first_pos_mode0; m >= 0; m--) {
      int xc = (xs << log2_sb_w) + scan.x[m];
      int yc = (ys << log2_sb_h) + scan.y[m];
      int level = at(xc, yc);
      if (level != 0 && !(sig_hidden && m == first_sig))
        e.bypass(level < 0 ? 1 : 0);
      if (dep_quant) {
        int a = level < 0 ? -level : level;
        qstate = kQStateTrans[qstate][a & 1];
      }
    }
  }

  // -- transform-skip residual coding ------------------------------------
  void encode_ts(int c_idx, int bdpcm) {
    (void)c_idx;
    int log2_w = 31 - __builtin_clz((unsigned)w);
    int log2_h = 31 - __builtin_clz((unsigned)h);
    int log2_sb_w = (log2_w < 2 || log2_h < 2) ? 1 : 2;
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
    int num_sb = 1 << (log2_sb_w + log2_sb_h);
    int w_sbs = 1 << (log2_w - log2_sb_w);
    int h_sbs = 1 << (log2_h - log2_sb_h);
    Scan sb_scan = diag_scan(w_sbs, h_sbs);
    Scan scan = diag_scan(1 << log2_sb_w, 1 << log2_sb_h);
    int rem_bins = ((1 << (log2_w + log2_h)) * 7) >> 2;
    int last_sb = w_sbs * h_sbs - 1;

    std::vector<int> sig(w * h, 0), sign_level(w * h, 0), abs_final(w * h, 0);
    std::vector<int> sb_coded(w_sbs * h_sbs, 0);
    int infer_sb_cbf = 1;

    for (int i = 0; i <= last_sb; i++) {
      int xs = sb_scan.x[i], ys = sb_scan.y[i];
      int sbc = 0;
      for (int yy = ys << log2_sb_h; yy < (ys + 1) << log2_sb_h && !sbc; yy++)
        for (int xx = xs << log2_sb_w; xx < (xs + 1) << log2_sb_w; xx++)
          if (at(xx, yy)) {
            sbc = 1;
            break;
          }
      if (i != last_sb || !infer_sb_cbf) {
        int left = xs > 0 ? sb_coded[ys * w_sbs + xs - 1] : 0;
        int above = ys > 0 ? sb_coded[(ys - 1) * w_sbs + xs] : 0;
        e.bin(vvc::SB_CODED_FLAG + left + above + 4, sbc);
      } else {
        sbc = 1;
      }
      sb_coded[ys * w_sbs + xs] = sbc;
      if (sbc && i < last_sb) infer_sb_cbf = 0;

      int infer_sb_sig = 1;
      int last_pass1 = -1, last_pass2 = -1;
      std::vector<int> gtx(num_sb, 0), pass1(num_sb, 0), vcoded(num_sb, 0);
      std::vector<int> nx(num_sb), ny(num_sb);
      for (int n = 0; n < num_sb; n++) {
        nx[n] = (xs << log2_sb_w) + scan.x[n];
        ny[n] = (ys << log2_sb_h) + scan.y[n];
      }

      // pass 1
      int n = 0;
      while (n < num_sb && rem_bins >= 4) {
        int xc = nx[n], yc = ny[n];
        int F = at(xc, yc);
        if (F < 0) F = -F;
        int v;
        if (bdpcm) {
          v = F;
        } else {
          int left = xc > 0 ? abs_final[yc * w + xc - 1] : 0;
          int above = yc > 0 ? abs_final[(yc - 1) * w + xc] : 0;
          int pred = left > above ? left : above;
          if (pred > 0 && F == pred)
            v = 1;
          else if (pred > 0 && 1 <= F && F <= pred - 1)
            v = F + 1;
          else
            v = F;
        }
        vcoded[n] = v;
        abs_final[yc * w + xc] = F;
        last_pass1 = n;
        if (sbc && (n != num_sb - 1 || !infer_sb_sig)) {
          int l = xc > 0 ? sig[yc * w + xc - 1] : 0;
          int a = yc > 0 ? sig[(yc - 1) * w + xc] : 0;
          e.bin(vvc::SIG_COEFF_FLAG + 60 + l + a, v > 0);
          sig[yc * w + xc] = v > 0;
          rem_bins -= 1;
          if (v > 0) infer_sb_sig = 0;
        } else {
          sig[yc * w + xc] = (n == num_sb - 1 && infer_sb_sig && sbc) ? 1 : 0;
        }
        int par = 0;
        if (sig[yc * w + xc]) {
          int ls = xc > 0 ? sign_level[yc * w + xc - 1] : 0;
          int a_s = yc > 0 ? sign_level[(yc - 1) * w + xc] : 0;
          int inc;
          if (ls == -a_s)
            inc = bdpcm ? 3 : 0;
          else if (ls >= 0 && a_s >= 0)
            inc = bdpcm ? 4 : 1;
          else
            inc = bdpcm ? 5 : 2;
          int neg = at(xc, yc) < 0;
          e.bin(vvc::COEFF_SIGN_FLAG + inc, neg);
          sign_level[yc * w + xc] = 1 - 2 * neg;
          int gt1_inc;
          if (bdpcm) {
            gt1_inc = 67;
          } else {
            int lsf = xc > 0 ? sig[yc * w + xc - 1] : 0;
            int asf = yc > 0 ? sig[(yc - 1) * w + xc] : 0;
            gt1_inc = 64 + lsf + asf;
          }
          int gt1 = v > 1;
          e.bin(vvc::ABS_LEVEL_GTX_FLAG + gt1_inc, gt1);
          gtx[n] = gt1;
          rem_bins -= 2;
          if (gt1) {
            par = (v - 2) & 1;
            e.bin(vvc::PAR_LEVEL_FLAG + 32, par);
            rem_bins -= 1;
          }
        }
        pass1[n] = sig[yc * w + xc] + par + gtx[n];
        n += 1;
      }

      // pass 2: gtx chain
      std::vector<int> pass2(num_sb, 0);
      n = 0;
      while (n < num_sb && rem_bins >= 4) {
        pass2[n] = pass1[n];
        int v = vcoded[n];
        for (int j = 1; j < 5 && gtx[n]; j++) {
          int b = v >= pass2[n] + 2;
          e.bin(vvc::ABS_LEVEL_GTX_FLAG + 67 + j, b);
          gtx[n] = b;
          pass2[n] += b << 1;
          rem_bins -= 1;
        }
        last_pass2 = n;
        n += 1;
      }

      // remainder pass
      for (n = 0; n < num_sb; n++) {
        int xc = nx[n], yc = ny[n];
        int v;
        if (n <= last_pass1) {
          v = vcoded[n];
        } else {
          int F = at(xc, yc);
          if (F < 0) F = -F;
          v = F;
          abs_final[yc * w + xc] = F;
        }
        if ((n <= last_pass2 && pass2[n] >= 10) ||
            (last_pass2 < n && n <= last_pass1 && pass1[n] >= 2) ||
            (n > last_pass1 && sbc)) {
          int rem;
          if (n <= last_pass2)
            rem = (v - pass2[n]) >> 1;
          else if (n <= last_pass1)
            rem = (v - pass1[n]) >> 1;
          else
            rem = v;
          abs_encode(rem, 1);
        }
        if (n > last_pass1 && v) e.bypass(at(xc, yc) < 0);
      }
    }
  }
};

}  // namespace vvce

// ---------------------------------------------------------------------
// C API

extern "C" {

void* vvce_new() { return new vvce::Encoder(); }

void vvce_free(void* h) { delete static_cast<vvce::Encoder*>(h); }

void vvce_init_states(void* h, int qp, int init_type) {
  static_cast<vvce::Encoder*>(h)->init_states(qp, init_type);
}

void vvce_bin(void* h, int ctx, int val) {
  static_cast<vvce::Encoder*>(h)->bin(ctx, val);
}

void vvce_bypass(void* h, int val) {
  static_cast<vvce::Encoder*>(h)->bypass(val);
}

void vvce_bypass_bits(void* h, uint32_t val, int n) {
  static_cast<vvce::Encoder*>(h)->bypass_bits(val, n);
}

void vvce_terminate(void* h, int val) {
  static_cast<vvce::Encoder*>(h)->terminate(val);
}

// Copy the 378 adaptive context states between handles (WPP context
// inheritance: the state after a row's first CTU seeds the next row)
void vvce_copy_states(void* dst, const void* src) {
  auto* d = static_cast<vvce::Encoder*>(dst);
  const auto* s = static_cast<const vvce::Encoder*>(src);
  std::memcpy(d->state0, s->state0, sizeof(d->state0));
  std::memcpy(d->state1, s->state1, sizeof(d->state1));
  std::memcpy(d->shift0, s->shift0, sizeof(d->shift0));
  std::memcpy(d->shift1, s->shift1, sizeof(d->shift1));
}

// Finalize into caller buffer; returns byte count (call with cap=0 for
// a size query — finish() is only performed on the sized call).
int vvce_finish(void* h, uint8_t* out, int cap) {
  auto* e = static_cast<vvce::Encoder*>(h);
  if (out == nullptr) {
    // upper bound: flushed bytes + kept window bits + 2
    return (int)e->out.size() + (e->nbits + 7) / 8 + 2;
  }
  e->finish();
  int n = (int)e->out.size();
  if (n > cap) return -1;
  std::memcpy(out, e->out.data(), n);
  return n;
}

// Regular residual_coding; returns the tracker-clear bitmask
// (1:lfnst_dc_only 2:lfnst_zero_out 4:mts_dc_only 8:mts_zero_out).
int vvce_residual(void* h, const int32_t* coeffs, int w, int ht, int c_idx,
                  int is_intra_slice, int dep_quant, int sign_hiding) {
  auto* e = static_cast<vvce::Encoder*>(h);
  vvce::Residual r(*e, coeffs, w, ht, is_intra_slice, dep_quant, sign_hiding);
  r.encode(c_idx);
  return r.clear_flags;
}

void vvce_residual_ts(void* h, const int32_t* coeffs, int w, int ht,
                      int c_idx, int bdpcm) {
  auto* e = static_cast<vvce::Encoder*>(h);
  vvce::Residual r(*e, coeffs, w, ht, 0, 0, 0);
  r.encode_ts(c_idx, bdpcm);
}

}  // extern "C"
