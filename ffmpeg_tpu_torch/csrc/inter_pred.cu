// Inter prediction of the MC batch of one plane kind, for Hopper.
//
// Replaces the JAX frame program's XLA inter prediction (pipeline.py
// _pred_blocks over _inter_pred_unit, with _mc_block, _hwrap,
// _prof_refine and _bdof_bi); it is not a Pallas kernel, but it is the
// main device work of every P/B frame.  For every unit of the MC batch
// and every channel it computes the clipped w x h prediction: both
// hypotheses through the separable 8-tap luma / 4-tap chroma filter (the
// hpel row selects the AMVR half-pel or the affine 6-tap luma bank),
// reference wraparound, PROF on affine subblocks, BDOF on bi units of at
// most 16x16, uni/bi rounding, explicit weights and BCW (Cr reads the
// second weight set), the GPM blend, DMVR's read window and, for luma
// under LMCS, the forward mapping of the prediction.  It writes the MC
// tile format of
// models/vvc/mc_tiles.py: (nch, T) int16, unit u's w * h samples
// row-major at toff[u].  Its oracle is the plain torch version in
// ffmpeg_tpu_torch/ops/inter.py (inter_pred_plain); everything is int32
// arithmetic, so the two agree bit for bit.
//
// What bounds it on this card: neither bytes nor operations, but
// latency.  A 1080p B frame has about 71,000 (unit, channel) items, 90% of
// its luma units 4x4 affine or SbTMVP subblocks, and each item is a chain
// of dependent reads (work list, control row, reference windows) followed
// by a few hundred operations.  Its time is the items over the items in
// flight, times one item's chain.  So the design keeps many items in
// flight and each chain short:
//
//  - Size classes (models/vvc/inputs.py mc_size_classes), one launch
//    each.  small_kernel takes the units of at most SMALL_AREA samples
//    (counted over at least 4x4) without BDOF: one half-warp per (unit,
//    channel), two units per warp, each with a slice of shared memory
//    sized for such a unit.  Only __syncwarp orders its steps; the groups
//    stride over the list and fetch the next unit's row index ahead.
//    large_kernel takes the rest, one 128-thread block per (unit,
//    channel), the largest units first so that the tail is short; only it
//    holds BDOF's buffers.
//  - One memory latency per unit for its samples: both hypotheses'
//    windows, and PROF's rings, go out as cp.async copies into shared
//    memory, and each lane's GPM weights as plain loads into registers,
//    before a single wait.  BDOF's integer ring is read from the staged
//    window: the two clamp alike (pure inter units to the picture, or a
//    DMVR unit to the region of its original MV, CIIP units through the
//    wraparound), and for a unit of at most 16x16 the ring samples BDOF
//    uses lie inside the window.  PROF's ring always wraps while a pure
//    unit's window clamps, so it has copies of its own.
//  - DMVR changes only the clamp bounds of those reads: the window stays
//    (w + 7) x (h + 7) at the refined MV, its rows and columns clamped to
//    the original MV's region (ops/inter.py _dmvr_windows).  DMVR units
//    are at least 8x16, so they run in the large class.
//  - LMCS maps the clipped luma prediction forward through the frame's 16
//    pivots and scales, which travel in the parameter block.
//  - Filter coefficients come from __constant__ memory into registers;
//    a group reads one bank row, so the reads broadcast.  The reference
//    plane pointers sit in the parameter block.  Windows are walked in
//    row/column steps (Walk), with no divide per sample.
//  - Stores are int16, only the unit's w * h samples, neighbouring lanes
//    on neighbouring addresses.
//
// TMA is not used: it fills the part of a box outside the plane with
// zeros, while the picture clamp and the wraparound replicate edge
// samples.
//
// The host builds every batch to fit these buffers (inputs.py: units of
// at most MC_TILE a side, toff the prefix sum of w * h, the size
// classes); the kernel checks each unit against its class as it loads
// the row and traps on a malformed one, so the wrapper does no per-unit
// work on the host.
//
// Build (at first use, ffmpeg_tpu_torch/utils/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
//        -Xcompiler -fPIC -o _build/libinter_pred.so inter_pred.cu

#include <cuda_runtime.h>

#define FULL 0xffffffffu
#define GW 32              // GPM weight tile edge (inputs._gpm_weight_blocks)
#define MAX_NCH 2          // channels of a plane kind (ops/inter.py MAX_NCH)
#define MAX_REFS 32        // reference planes per channel (MAX_REFS)
#define SMALL_AREA 64      // inputs.SMALL_AREA: computed samples, >= 4x4
#define SMALL_WIN 256      // largest small 8-tap window: (16 + 7) x (4 + 7)
#define SMALL_TMP 176      // largest small horizontal pass: (4 + 7) x 16
#define SMALL_THREADS 128  // threads per small_kernel block
#define SMALL_GS 16        // lanes per small unit: two units per warp
#define LARGE_EDGE 32      // largest unit edge (mc_tiles.MC_TILE)
#define LARGE_WIN ((LARGE_EDGE + 7) * (LARGE_EDGE + 7))
#define LARGE_TMP ((LARGE_EDGE + 7) * LARGE_EDGE)
#define LARGE_AREA (LARGE_EDGE * LARGE_EDGE)
#define LARGE_THREADS 128  // threads per large_kernel block (one unit)

// control rows, in the order of INTER_KEYS (models/vvc/inputs.py)
enum {
  k_x0, k_y0, k_w, k_h, k_pf, k_m0x, k_m0y, k_m1x, k_m1y, k_r0slot,
  k_r1slot, k_wden, k_w0, k_w1, k_wo0, k_wo1, k_hpel, k_hyp0lx, k_hyp1lx,
  k_gpm_part, k_gpm_tx, k_gpm_ty, k_gpm_lw, k_gpm_lh, k_w0b, k_w1b,
  k_wo0b, k_wo1b, k_prof, k_pdhx0, k_pdhy0, k_pdvx0, k_pdvy0, k_pdhx1,
  k_pdhy1, k_pdvx1, k_pdvy1, k_bdof, k_dmvr, k_om0x, k_om0y, k_om1x,
  k_om1y,
  NUM_KEYS
};

// interpolation filters: the luma banks [regular, AMVR half-pel, affine
// 6-tap] x 16 phases, and the chroma filter x 32 phases (ops/inter.py
// INTERP_LUMA and INTERP_CHROMA[0]; tests/test_torch_tables.py holds the
// two equal)
__constant__ int c_luma[3][16][8] = {
    {{0, 0, 0, 64, 0, 0, 0, 0},
     {0, 1, -3, 63, 4, -2, 1, 0},
     {-1, 2, -5, 62, 8, -3, 1, 0},
     {-1, 3, -8, 60, 13, -4, 1, 0},
     {-1, 4, -10, 58, 17, -5, 1, 0},
     {-1, 4, -11, 52, 26, -8, 3, -1},
     {-1, 3, -9, 47, 31, -10, 4, -1},
     {-1, 4, -11, 45, 34, -10, 4, -1},
     {-1, 4, -11, 40, 40, -11, 4, -1},
     {-1, 4, -10, 34, 45, -11, 4, -1},
     {-1, 4, -10, 31, 47, -9, 3, -1},
     {-1, 3, -8, 26, 52, -11, 4, -1},
     {0, 1, -5, 17, 58, -10, 4, -1},
     {0, 1, -4, 13, 60, -8, 3, -1},
     {0, 1, -3, 8, 62, -5, 2, -1},
     {0, 1, -2, 4, 63, -3, 1, 0}},
    {{0, 0, 0, 64, 0, 0, 0, 0},
     {0, 1, -3, 63, 4, -2, 1, 0},
     {-1, 2, -5, 62, 8, -3, 1, 0},
     {-1, 3, -8, 60, 13, -4, 1, 0},
     {-1, 4, -10, 58, 17, -5, 1, 0},
     {-1, 4, -11, 52, 26, -8, 3, -1},
     {-1, 3, -9, 47, 31, -10, 4, -1},
     {-1, 4, -11, 45, 34, -10, 4, -1},
     {0, 3, 9, 20, 20, 9, 3, 0},
     {-1, 4, -10, 34, 45, -11, 4, -1},
     {-1, 4, -10, 31, 47, -9, 3, -1},
     {-1, 3, -8, 26, 52, -11, 4, -1},
     {0, 1, -5, 17, 58, -10, 4, -1},
     {0, 1, -4, 13, 60, -8, 3, -1},
     {0, 1, -3, 8, 62, -5, 2, -1},
     {0, 1, -2, 4, 63, -3, 1, 0}},
    {{0, 0, 0, 64, 0, 0, 0, 0},
     {0, 1, -3, 63, 4, -2, 1, 0},
     {0, 1, -5, 62, 8, -3, 1, 0},
     {0, 2, -8, 60, 13, -4, 1, 0},
     {0, 3, -10, 58, 17, -5, 1, 0},
     {0, 3, -11, 52, 26, -8, 2, 0},
     {0, 2, -9, 47, 31, -10, 3, 0},
     {0, 3, -11, 45, 34, -10, 3, 0},
     {0, 3, -11, 40, 40, -11, 3, 0},
     {0, 3, -10, 34, 45, -11, 3, 0},
     {0, 3, -10, 31, 47, -9, 2, 0},
     {0, 2, -8, 26, 52, -11, 3, 0},
     {0, 1, -5, 17, 58, -10, 3, 0},
     {0, 1, -4, 13, 60, -8, 2, 0},
     {0, 1, -3, 8, 62, -5, 1, 0},
     {0, 1, -2, 4, 63, -3, 1, 0}},
};
__constant__ int c_chroma[32][4] = {
    {0, 64, 0, 0},
    {-1, 63, 2, 0},
    {-2, 62, 4, 0},
    {-2, 60, 7, -1},
    {-2, 58, 10, -2},
    {-3, 57, 12, -2},
    {-4, 56, 14, -2},
    {-4, 55, 15, -2},
    {-4, 54, 16, -2},
    {-5, 53, 18, -2},
    {-6, 52, 20, -2},
    {-6, 49, 24, -3},
    {-6, 46, 28, -4},
    {-5, 44, 29, -4},
    {-4, 42, 30, -4},
    {-4, 39, 33, -4},
    {-4, 36, 36, -4},
    {-4, 33, 39, -4},
    {-4, 30, 42, -4},
    {-4, 29, 44, -5},
    {-4, 28, 46, -6},
    {-3, 24, 49, -6},
    {-2, 20, 52, -6},
    {-2, 18, 53, -5},
    {-2, 16, 54, -4},
    {-2, 15, 55, -4},
    {-2, 14, 56, -4},
    {-2, 12, 57, -3},
    {-2, 10, 58, -2},
    {-1, 7, 60, -2},
    {0, 4, 62, -2},
    {0, 2, 63, -1}};

struct Params {
  const int* ctrl;             // (NUM_KEYS, n_mc)
  int n_mc, n_inter;           // rows n_inter.. are CIIP units
  const int* list;             // this launch's rows of the MC batch
  int n_items;                 // list length x nch
  int nch, n_refs;
  long long refs[MAX_NCH][MAX_REFS];  // reference plane pointers
  int H, W, stride;            // picture size, plane row stride
  const int* gwt;              // (n_gpm, GW, GW) GPM blend weights
  const int* gslot;            // (n_mc,)
  const int* toff;             // (n_mc + 1,) tile offsets
  long long T;                 // tile samples per channel
  short* out;                  // (nch, T)
  int bd, wrap;
  int lmcs;                    // map the luma prediction forward
  int lm_pivot[16], lm_fwd[16];  // LMCS forward segments (ops/lmcs.py)
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// XLA shift semantics (the JAX reference): out-of-range amounts give 0
// (left) or the sign fill (right); left shifts of negative values wrap
__device__ __forceinline__ int shl(int a, int s) {
  return (s < 0 || s >= 32) ? 0 : (int)((unsigned)a << s);
}
__device__ __forceinline__ int shr(int a, int s) {
  return (s < 0 || s >= 32) ? (a < 0 ? -1 : 0) : (a >> s);
}

__device__ __forceinline__ int ilog2_sat(int v) {  // av_log2, saturates at 20
  int b = 0;
  for (int k = 1; k < 21; ++k) b += v >= (1 << k);
  return b;
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// column clamp: the picture edge, or reference wraparound (ClipH)
__device__ __forceinline__ int hwrap(int x, int W, int wrap) {
  if (wrap) {
    if (x < 0) x += wrap;
    if (x > W - 1) x -= wrap;
  }
  return clampi(x, 0, W - 1);
}

// the rectangle a hypothesis reads from, inclusive: the picture, or for a
// DMVR unit the region of its original MV with the filter's taps before
// (eb) and after (ea) it, clamped into the picture (emulated_edge_dmvr)
struct Win {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ Win read_window(const int* c, int lx, bool dmvr,
                                           int W, int H, int fb, int eb,
                                           int ea) {
  if (!dmvr) return Win{0, W - 1, 0, H - 1};
  const int xsb = c[k_x0] + (c[lx ? k_om1x : k_om0x] >> fb);
  const int ysb = c[k_y0] + (c[lx ? k_om1y : k_om0y] >> fb);
  const int x0 = clampi(xsb - eb, 0, W - 1), y0 = clampi(ysb - eb, 0, H - 1);
  return Win{x0, x0 + max(min(W, xsb + c[k_w] + ea) - x0, 1) - 1, y0,
             y0 + max(min(H, ysb + c[k_h] + ea) - y0, 1) - 1};
}

// LMCS forward mapping of a clipped luma sample (lmcs_fwd)
__device__ __forceinline__ int lmcs_fwd(const Params& p, int v, int maxv) {
  const int shift = p.bd - 4, i = v >> shift;
  return clampi(p.lm_pivot[i] +
                    ((p.lm_fwd[i] * (v - (i << shift)) + (1 << 10)) >> 11),
                0, maxv);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// this thread's cp.async copies have landed (a group sync then shows
// every thread's)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// GS threads that compute one unit: a half-warp or a block
template <int GS>
struct Group {
  int lane;
  unsigned mask;  // the group's lanes of its warp (GS < 32)
  __device__ __forceinline__ void sync() const {
    if constexpr (GS <= 32)
      __syncwarp(mask);
    else
      __syncthreads();
  }
};

// a lane's positions in a row-major area `cols` wide, visited in steps
// of GS: one divide per walk, then row/column steps
template <int GS>
struct Walk {
  int r, q, dr, dq, cols;
  __device__ __forceinline__ Walk(int lane, int cols_) : cols(cols_) {
    r = lane / cols;
    q = lane - r * cols;
    dr = GS / cols;
    dq = GS - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    q += dq;
    if (q >= cols) {
      q -= cols;
      ++r;
    }
  }
};

// a group's shared memory for one unit
template <int WIN, int TMP, int AREA>
struct Unit {
  int c[NUM_KEYS];
  int win[2][WIN];   // reference windows, row stride gw
  int tmp[2][TMP];   // horizontal passes, row stride ww
  int t[2][AREA];    // 14-bit hypotheses, row stride ww
  int ring[2][36];   // PROF's 6x6 integer rings, raw samples
};
using SmallUnit = Unit<SMALL_WIN, SMALL_TMP, SMALL_AREA>;
using LargeUnit = Unit<LARGE_WIN, LARGE_TMP, LARGE_AREA>;

struct Bdof {
  int gh[2][256], gv[2][256];  // gradients at the unit's samples, stride 16
  int vx[16], vy[16];          // per 4x4 block
};

template <int TAPS>
__device__ __forceinline__ void load_filter(const int* c, int frac, int* f) {
  if constexpr (TAPS == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = c_chroma[frac][k];
  } else {
    const int bank = clampi(c[k_hpel], 0, 2);
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = c_luma[bank][frac][k];
  }
}

// PROF (8.5.5.9) at (y, x) of the 4x4 corner of hypothesis lx
// (_prof_refine): the offset to add to its sample
template <int WIN, int TMP, int AREA>
__device__ int prof_delta(const Unit<WIN, TMP, AREA>& s, int bd, int lx,
                          int y, int x, int ww) {
  const int* c = s.c;
  // p[r][q] of the 6x6 pad: the tile inside [1, 5), the ring outside
  auto pad = [&](int r, int q) {
    return (r >= 1 && r < 5 && q >= 1 && q < 5)
               ? s.t[lx][(r - 1) * ww + q - 1]
               : shl(s.ring[lx][r * 6 + q], 14 - bd);
  };
  const int gh = (pad(y + 1, x + 2) >> 6) - (pad(y + 1, x) >> 6);
  const int gv = (pad(y + 2, x + 1) >> 6) - (pad(y, x + 1) >> 6);
  const int dhx = c[lx ? k_pdhx1 : k_pdhx0], dhy = c[lx ? k_pdhy1 : k_pdhy0];
  const int dvx = c[lx ? k_pdvx1 : k_pdvx0], dvy = c[lx ? k_pdvy1 : k_pdvy0];
  const int rx = x * (dhx * 4) + y * (dhy * 4) - 6 * (dhx + dhy);
  const int ry = x * (dvx * 4) + y * (dvy * 4) - 6 * (dvx + dvy);
  const int dmx = clampi((rx + 128 - (rx >= 0)) >> 8, -31, 31);
  const int dmy = clampi((ry + 128 - (ry >= 0)) >> 8, -31, 31);
  const int lim = 1 << max(13, bd + 1);
  return clampi(gh * dmx + gv * dmy, -lim, lim - 1);
}

// BDOF (8.5.6.4/5) on a bi unit of at most 16x16 (_bdof_bi): the
// gradients at the unit's samples and the per-4x4 (vx, vy) into b.  The
// 18x18 pad holds the unit's samples (s.t) inside and the integer ring
// outside, read from the staged window: ring row r is window row r + 2 +
// ((mv_y >> 3) & 1), and likewise for columns.
template <int GS, int WIN, int TMP, int AREA>
__device__ void bdof_prepare(const Unit<WIN, TMP, AREA>& s, Bdof& b, int bd,
                             int w, int h, int ww, int gw, const Group<GS>& g) {
  const int* c = s.c;
  const int ry0 = 2 + ((c[k_m0y] >> 3) & 1), rx0 = 2 + ((c[k_m0x] >> 3) & 1);
  const int ry1 = 2 + ((c[k_m1y] >> 3) & 1), rx1 = 2 + ((c[k_m1x] >> 3) & 1);
  auto pad = [&](int l, int r, int q) {
    return (r >= 1 && r <= h && q >= 1 && q <= w)
               ? s.t[l][(r - 1) * ww + q - 1]
               : shl(s.win[l][(r + (l ? ry1 : ry0)) * gw + q + (l ? rx1 : rx0)],
                     14 - bd);
  };
  for (int i = g.lane; i < 2 * 256; i += GS) {
    const int l = i >> 8, y = (i >> 4) & 15, x = i & 15;
    if (y < h && x < w) {
      b.gh[l][y * 16 + x] = (pad(l, y + 1, x + 2) >> 6) - (pad(l, y + 1, x) >> 6);
      b.gv[l][y * 16 + x] = (pad(l, y + 2, x + 1) >> 6) - (pad(l, y, x + 1) >> 6);
    }
  }
  g.sync();
  if (g.lane < 16) {
    const int by = g.lane >> 2, bx = g.lane & 3;
    int sgx2 = 0, sgy2 = 0, sgxgy = 0, sgxdi = 0, sgydi = 0;
    for (int a = 0; a < 6; ++a)
      for (int e = 0; e < 6; ++e) {
        // edge-replicated: the 6x6 window around the block, clamped into
        // the unit
        const int yc = clampi(by * 4 + a - 1, 0, h - 1);
        const int xc = clampi(bx * 4 + e - 1, 0, w - 1);
        const int gi = yc * 16 + xc;
        const int th = (b.gh[0][gi] + b.gh[1][gi]) >> 1;
        const int tv = (b.gv[0][gi] + b.gv[1][gi]) >> 1;
        const int d = (s.t[0][yc * ww + xc] >> 4) - (s.t[1][yc * ww + xc] >> 4);
        sgx2 += abs(th);
        sgy2 += abs(tv);
        sgxgy += sgn(tv) * th;
        sgxdi += -sgn(th) * d;
        sgydi += -sgn(tv) * d;
      }
    const int vx =
        sgx2 > 0 ? clampi(shr(sgxdi * 4, ilog2_sat(sgx2)), -15, 15) : 0;
    const int vy = sgy2 > 0 ? clampi(shr(sgydi * 4 - ((vx * sgxgy) >> 1),
                                         ilog2_sat(sgy2)),
                                     -15, 15)
                            : 0;
    b.vx[g.lane] = vx;
    b.vy[g.lane] = vy;
  }
  g.sync();
}

// one (unit, channel) by the group g
template <int TAPS, int GS, int WIN, int TMP, int AREA, bool BDOF>
__device__ void predict_unit(const Params& p, Unit<WIN, TMP, AREA>& s,
                             Bdof* b, int u, int ch, const Group<GS>& g) {
  constexpr bool CHROMA = TAPS == 4;
  constexpr int BEFORE = CHROMA ? 1 : 3;  // filter taps before the sample
  constexpr int FB = CHROMA ? 5 : 4;      // MV fraction bits
  constexpr int NS = AREA / GS;           // samples per lane
  const int lane = g.lane;
  int* c = s.c;

  // the control row; the GPM slot and the tile bounds go out with it
  if (u < 0 || u >= p.n_mc) __trap();
  for (int k = lane; k < NUM_KEYS; k += GS)
    c[k] = __ldg(p.ctrl + (size_t)k * p.n_mc + u);
  const int gslot = __ldg(p.gslot + u);
  const int off = __ldg(p.toff + u), end = __ldg(p.toff + u + 1);
  g.sync();

  const int w = c[k_w], h = c[k_h];
  // computed over at least the 4x4 corner PROF refines
  const int ww = max(w, 4), hh = max(h, 4), n = ww * hh;
  const int gw = ww + TAPS - 1, gh = hh + TAPS - 1;
  // the unit is at most LARGE_EDGE (the GPM weight tile's edge) a side
  // and fits its class's buffers, BDOF only in the large class on at most
  // 16x16, and its w * h samples lie at toff[u] inside the tiles; else
  // the batch is malformed and the launch fails
  if (w < 1 || h < 1 || w > LARGE_EDGE || h > LARGE_EDGE || n > AREA ||
      gw * gh > WIN || gh * ww > TMP || off < 0 || end - off != w * h ||
      end > p.T || (!CHROMA && c[k_bdof] > 0 && (!BDOF || w > 16 || h > 16)))
    __trap();
  const int pf = c[k_pf];
  const bool gpm = c[k_gpm_part] > 0;
  const bool need[2] = {gpm || pf == 1 || pf == 3, gpm || pf != 1};
  const int prof = CHROMA ? 0 : c[k_prof] & (need[0] | (need[1] << 1));
  // the reference's reads: pure inter units clamp the MC window and the
  // BDOF ring to the picture, or a DMVR unit to its original MV's region;
  // CIIP units wrap them; the PROF ring always wraps (ops/inter.py
  // inter_pred_plain)
  const bool ciip = u >= p.n_inter;
  const int wrap_mc = ciip ? p.wrap : 0;
  const bool dmvr = !ciip && c[k_dmvr] > 0;

  // every sample load of the unit, then one wait
#pragma unroll
  for (int lx = 0; lx < 2; ++lx) {
    if (!need[lx]) continue;
    const int mvx = c[lx ? k_m1x : k_m0x], mvy = c[lx ? k_m1y : k_m0y];
    const int* ref = (const int*)p.refs[ch][clampi(
        c[lx ? k_r1slot : k_r0slot], 0, p.n_refs - 1)];
    const int ix = c[k_x0] + (mvx >> FB) - BEFORE;
    const int iy = c[k_y0] + (mvy >> FB) - BEFORE;
    const Win rw =
        read_window(c, lx, dmvr, p.W, p.H, FB, BEFORE, TAPS - BEFORE - 1);
    Walk<GS> wk(lane, gw);
    for (int i = lane; i < gw * gh; i += GS, wk.next())
      cp_async4(&s.win[lx][i],
                ref + (size_t)clampi(iy + wk.r, rw.y0, rw.y1) * p.stride +
                    clampi(hwrap(ix + wk.q, p.W, wrap_mc), rw.x0, rw.x1));
    if ((prof >> lx) & 1) {
      const int ry = c[k_y0] + (mvy >> 4) + ((mvy >> 3) & 1) - 1;
      const int rx = c[k_x0] + (mvx >> 4) + ((mvx >> 3) & 1) - 1;
      for (int i = lane; i < 36; i += GS) {
        const int r = i / 6, q = i - 6 * r;
        cp_async4(&s.ring[lx][i],
                  ref + (size_t)clampi(ry + r, 0, p.H - 1) * p.stride +
                      hwrap(rx + q, p.W, p.wrap));
      }
    }
  }
  int gwv[NS];
  {
    const int* wb = p.gwt + (size_t)gslot * GW * GW;
    Walk<GS> ws(lane, ww);
#pragma unroll
    for (int j = 0; j < NS; ++j, ws.next())
      gwv[j] = gpm && lane + j * GS < n && ws.r < h && ws.q < w
                   ? __ldg(wb + ws.r * GW + ws.q)
                   : 0;
  }
  cp_async_wait_all();
  g.sync();

  // horizontal passes over the windows
#pragma unroll
  for (int lx = 0; lx < 2; ++lx) {
    if (!need[lx]) continue;
    int f[TAPS];
    load_filter<TAPS>(c, c[lx ? k_m1x : k_m0x] & ((1 << FB) - 1), f);
    Walk<GS> wk(lane, ww);
    for (int i = lane; i < gh * ww; i += GS, wk.next()) {
      const int* row = &s.win[lx][wk.r * gw + wk.q];
      int acc = 0;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) acc += f[k] * row[k];
      s.tmp[lx][i] = acc >> (p.bd - 8);
    }
  }
  g.sync();

  // vertical passes: the lane's samples, kept in registers (and in s.t
  // for the neighbours PROF and BDOF read)
  int t[2][NS];
#pragma unroll
  for (int lx = 0; lx < 2; ++lx) {
    int f[TAPS];
    if (need[lx]) load_filter<TAPS>(c, c[lx ? k_m1y : k_m0y] & ((1 << FB) - 1), f);
    Walk<GS> ws(lane, ww);
#pragma unroll
    for (int j = 0; j < NS; ++j, ws.next()) {
      const int k = lane + j * GS;
      int acc = 0;
      if (need[lx] && k < n) {
        const int* col = &s.tmp[lx][ws.r * ww + ws.q];
#pragma unroll
        for (int tap = 0; tap < TAPS; ++tap) acc += f[tap] * col[tap * ww];
        acc >>= 6;
        s.t[lx][k] = acc;
      }
      t[lx][j] = acc;
    }
  }
  if (prof) {
    g.sync();  // every hypothesis sample is in s.t
    Walk<GS> ws(lane, ww);
#pragma unroll
    for (int j = 0; j < NS; ++j, ws.next())
      if (lane + j * GS < n && ws.r < 4 && ws.q < 4) {
#pragma unroll
        for (int lx = 0; lx < 2; ++lx)
          if ((prof >> lx) & 1)
            t[lx][j] += prof_delta(s, p.bd, lx, ws.r, ws.q, ww);
      }
  }
  const int wden = c[k_wden];
  const bool bdof = BDOF && !gpm && pf == 3 && wden < 0 && c[k_bdof] > 0;
  if constexpr (BDOF) {
    if (bdof) {
      if (prof) {  // BDOF reads the refined samples
        g.sync();
#pragma unroll
        for (int j = 0; j < NS; ++j)
          if (lane + j * GS < n) {
            s.t[0][lane + j * GS] = t[0][j];
            s.t[1][lane + j * GS] = t[1][j];
          }
      }
      g.sync();
      bdof_prepare<GS>(s, *b, p.bd, w, h, ww, gw, g);
    }
  }

  // weighting, rounding and the clip; the unit's w * h samples out
  const int bd = p.bd, maxv = (1 << bd) - 1;
  const bool cr = CHROMA && ch == 1;
  const int w0 = c[cr ? k_w0b : k_w0], w1 = c[cr ? k_w1b : k_w1];
  const int wo0 = c[cr ? k_wo0b : k_wo0], wo1 = c[cr ? k_wo1b : k_wo1];
  const int wd = max(wden, 0);
  const int shift2 = 14 - bd, sh_avg = max(3, 15 - bd);
  const int sh_g = max(5, 17 - bd), shift4 = 15 - bd;
  short* out = p.out + (size_t)ch * p.T + off;
  Walk<GS> ws(lane, ww);
#pragma unroll
  for (int j = 0; j < NS; ++j, ws.next()) {
    const int y = ws.r, x = ws.q;
    if (lane + j * GS >= n || y >= h || x >= w) continue;
    const int t0 = t[0][j], t1 = t[1][j];
    int pred;
    if (gpm) {
      const int gv = gwv[j];
      pred = clampi((t0 * gv + t1 * (8 - gv) + (1 << (sh_g - 1))) >> sh_g, 0,
                    maxv);
    } else if (pf == 3) {
      if (wden >= 0) {
        const int shw = wd + sh_avg;
        const int offw = shl(shl(wo0 + wo1, bd - 8) + 1, shw - 1);
        pred = clampi(shr(t0 * w0 + t1 * w1 + offw, shw), 0, maxv);
      } else if (bdof) {  // the wrapper holds BDOF units to 16x16
        const int bi = (y >> 2) * 4 + (x >> 2), gi = y * 16 + x;
        const int o = b->vx[bi] * (b->gh[0][gi] - b->gh[1][gi]) +
                      b->vy[bi] * (b->gv[0][gi] - b->gv[1][gi]);
        pred = clampi((t0 + t1 + (1 << (shift4 - 1)) + o) >> shift4, 0, maxv);
      } else {
        pred = clampi((t0 + t1 + (1 << (sh_avg - 1))) >> sh_avg, 0, maxv);
      }
    } else {
      const int ta = pf == 1 ? t0 : t1;
      if (wden >= 0) {
        const int shu = wd + 14 - bd;
        pred = clampi(shr(ta * w0 + (shl(1, shu) >> 1), shu) +
                          shl(wo0, bd - 8),
                      0, maxv);
      } else {
        pred = clampi((ta + (1 << (shift2 - 1))) >> shift2, 0, maxv);
      }
    }
    if (!CHROMA && p.lmcs) pred = lmcs_fwd(p, pred, maxv);
    out[y * w + x] = (short)pred;
  }
}

// the small units: half-warps stride over the list, SMALL_THREADS /
// SMALL_GS of them per block, each with its own slice of shared memory
template <int TAPS>
__global__ void __launch_bounds__(SMALL_THREADS)
    small_kernel(const __grid_constant__ Params p) {
  constexpr int GS = SMALL_GS, GROUPS = SMALL_THREADS / GS;
  __shared__ SmallUnit sm[GROUPS];
  const int gi = threadIdx.x / GS;
  const Group<GS> g{(int)(threadIdx.x % GS), 0xffffu << (threadIdx.x & 16)};
  const int step = gridDim.x * GROUPS;
  int item = blockIdx.x * GROUPS + gi;
  int u = item < p.n_items ? __ldg(p.list + item / p.nch) : 0;
  while (item < p.n_items) {
    const int next = item + step;
    const int un = next < p.n_items ? __ldg(p.list + next / p.nch) : 0;
    predict_unit<TAPS, GS, SMALL_WIN, SMALL_TMP, SMALL_AREA, false>(
        p, sm[gi], nullptr, u, item % p.nch, g);
    g.sync();  // the unit's shared memory is read no more
    item = next;
    u = un;
  }
}

// the large units: one block per (unit, channel), in list order
template <int TAPS>
__global__ void __launch_bounds__(LARGE_THREADS)
    large_kernel(const __grid_constant__ Params p) {
  __shared__ LargeUnit s;
  __shared__ Bdof b;
  const Group<LARGE_THREADS> g{(int)threadIdx.x, FULL};
  const int item = blockIdx.x;
  predict_unit<TAPS, LARGE_THREADS, LARGE_WIN, LARGE_TMP, LARGE_AREA,
               TAPS == 8>(p, s, &b, __ldg(p.list + item / p.nch),
                          item % p.nch, g);
}

// blocks for a striding launch: as many as the card holds at once, no
// more than the work needs
static cudaError_t grid_for(const void* kernel, int threads, long items,
                            int items_per_block, int* grid) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return e;
  const long need = (items + items_per_block - 1) / items_per_block;
  *grid = (int)(need < (long)sms * per_sm ? need : (long)sms * per_sm);
  return cudaSuccess;
}

template <int TAPS>
static cudaError_t launch(const Params& p, int cls, cudaStream_t stream) {
  if (cls == 1) {
    large_kernel<TAPS><<<p.n_items, LARGE_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  int grid = 0;
  const cudaError_t e = grid_for((const void*)small_kernel<TAPS>,
                                 SMALL_THREADS, p.n_items,
                                 SMALL_THREADS / SMALL_GS, &grid);
  if (e != cudaSuccess) return e;
  small_kernel<TAPS><<<grid, SMALL_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// one launch over the rows `list` of the MC batch: cls 0 the small units,
// 1 the large ones.  refs is a host array of nch x n_refs plane pointers;
// lmcs a host array of the 16 forward pivots then the 16 forward scales
// (luma only), or null.
extern "C" int inter_pred_launch(
    const int* ctrl, int num_keys, int n_mc, int n_inter, const int* list,
    int n_list, int cls, const long long* refs, int n_refs, int nch, int H,
    int W, int stride, const int* gwt, const int* gslot, const int* toff,
    long long T, short* out, int is_chroma, int bit_depth, int wrap,
    const int* lmcs, void* stream) {
  if (num_keys != NUM_KEYS || n_refs < 1 || n_refs > MAX_REFS || nch < 1 ||
      nch > MAX_NCH || H < 1 || W < 1 || stride < W || bit_depth < 8 ||
      bit_depth > 12 || n_inter < 0 || n_inter > n_mc || n_list < 0 ||
      n_list > n_mc || cls < 0 || cls > 1 || T < 0 || (lmcs && is_chroma))
    return (int)cudaErrorInvalidValue;
  if (n_list == 0) return 0;
  Params p{};
  p.ctrl = ctrl;
  p.n_mc = n_mc;
  p.n_inter = n_inter;
  p.list = list;
  p.n_items = n_list * nch;
  p.nch = nch;
  p.n_refs = n_refs;
  for (int c = 0; c < nch; ++c)
    for (int r = 0; r < n_refs; ++r) p.refs[c][r] = refs[c * n_refs + r];
  p.H = H;
  p.W = W;
  p.stride = stride;
  p.gwt = gwt;
  p.gslot = gslot;
  p.toff = toff;
  p.T = T;
  p.out = out;
  p.bd = bit_depth;
  p.wrap = wrap;
  p.lmcs = lmcs != nullptr;
  for (int i = 0; lmcs && i < 16; ++i) {
    p.lm_pivot[i] = lmcs[i];
    p.lm_fwd[i] = lmcs[16 + i];
  }
  const cudaError_t e =
      is_chroma ? launch<4>(p, cls, (cudaStream_t)stream)
                : launch<8>(p, cls, (cudaStream_t)stream);
  return (int)e;
}

extern "C" const char* inter_pred_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
