// Deblocking filter passes for Hopper: one pass over the vertical (or,
// on the transposed view, the horizontal) edges of a luma plane, or of
// the Cb and Cr planes together.
//
// Replaces the JAX package's XLA deblock, ffmpeg_tpu/ops/deblock.py
// deblock_vertical_luma and deblock_vertical_chroma (not Pallas), which
// the frame program runs vertical, then horizontal, per component
// (ffmpeg_tpu/models/vvc/pipeline.py loopfilters).  Its oracle is the
// plain torch version in ffmpeg_tpu_torch/ops/deblock.py
// (deblock_vertical_luma_plain, deblock_vertical_chroma_plain): the same
// decisions and filters (vvc_filter_template.c:466-760,
// h2656_deblock_template.c), bit for bit.
//
// Design, simple and right first: one thread per (segment, edge).  A
// luma segment is 4 lines along the edge and its window 16 samples
// across it (p7..p0 q0..q7); a chroma segment is 2 lines and 8 samples
// (p3..q3).  The thread takes tc and beta from the tables, decides on
// lines 0 and 3 (luma) or 0 and 1 (chroma), and filters each line.
//
// Out of place, like the reference.  Every window is read from the
// pass's input plane `src`; `dst` starts as a copy of it (the wrapper
// makes it) and the thread adds each changed sample's delta with an
// integer atomicAdd.  Edges are 4 samples apart, so one window overlaps
// the samples its neighbours write; and a window column past the plane's
// border is clamped to the last column, so several window positions can
// name one sample.  The reference adds every window's delta there (a
// scatter-add), and the atomics add the same deltas: integer addition
// does not depend on their order, so the result is exact and the same on
// every launch.
//
// Layout.  The pass runs on a view of the physical (H, W) plane with two
// strides, along the edge (sa) and across it (sx): the vertical pass
// (sa, sx) = (W, 1), the horizontal pass the transposed view (1, W).  So
// no plane is ever transposed in memory.  Neighbouring threads take the
// coordinate that is contiguous in memory: neighbouring edges in the
// vertical pass, neighbouring segments in the horizontal one.  The
// per-edge grids (bs, qp, maxp, maxq and, for luma, the horizontal CTU
// edge flag) are (S, E) int32, laid out for the view.
//
// Bound.  Each pass reads the plane and its grids once and writes the
// plane once, so bytes bound it: about 0.019 ms for the four passes of
// a 1080p 4:2:0 frame at 3.35 TB/s (chip_smoke.py's bound).  Nothing
// here is tuned for it yet (a later PR's work): the window reads of
// neighbouring threads overlap and are served by L1, and the copy that
// dst starts as is a pass over the planes of its own.
//
// Build (at first use, ffmpeg_tpu_torch/utils/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
//        -Xcompiler -fPIC -o _build/libdeblock.so deblock.cu

#include <cuda_runtime.h>

#define THREADS 128
#define MAX_QP 63
#define INTRA_TC_OFFSET 2  // DEFAULT_INTRA_TC_OFFSET
#define MAX_NCH 2

struct Params {
  const int* src[MAX_NCH];   // input planes, (H, W) row-major each
  int* dst;                  // (nch, H, W): the inputs' copy, deltas added
  const int* bs[MAX_NCH];    // per-edge grids, (S, E) each
  const int* qp[MAX_NCH];
  const int* maxp[MAX_NCH];
  const int* maxq[MAX_NCH];
  const int* hor;            // luma: the p side lies across a CTU row edge
  int beta_off[MAX_NCH];     // effective offsets, already doubled
  int tc_off[MAX_NCH];
  int S, E;                  // segments along the edges, edges across
  long long sa, sx;          // strides of the view: along, across
  int span;                  // samples across the edges
  long long plane;           // H * W
  int seg_fast;              // neighbouring threads: neighbouring segments
  int bd;                    // bit depth
  const int* tct;            // TCTABLE (66)
  const int* betat;          // BETATABLE (64)
  const int* lcm;            // LARGE_COEF_M, LARGE_COEF_R, LARGE_TC_MULT:
  const int* lcr;            // (3, 7) each, row (max length - 3) / 2
  const int* lct;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// w[idx] for an index known only at run time, without sending w to local
// memory
template <int N>
__device__ __forceinline__ int pick(const int (&w)[N], int idx) {
  int v = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) v = k == idx ? w[k] : v;
  return v;
}

// the (segment, edge) of this thread, or false past the grid
__device__ __forceinline__ bool my_edge(const Params& p, int* s, int* e) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)p.S * p.E) return false;
  *s = (int)(p.seg_fast ? t % p.S : t / p.E);
  *e = (int)(p.seg_fast ? t / p.S : t % p.E);
  return true;
}

// tc (0 where bs is 0) and beta of one segment (ops/deblock.py _tc_beta)
__device__ __forceinline__ void tc_beta(const Params& p, int ch, int i,
                                        int* tc, int* beta) {
  const int bs = __ldg(p.bs[ch] + i), qp = __ldg(p.qp[ch] + i);
  *beta = __ldg(p.betat + clampi(qp + p.beta_off[ch], 0, MAX_QP))
          << (p.bd - 8);
  const int tc10 = __ldg(p.tct + clampi(
      qp + INTRA_TC_OFFSET * (bs - 1) + p.tc_off[ch], 0,
      MAX_QP + INTRA_TC_OFFSET));
  const int t = p.bd < 10 ? (tc10 + (1 << (9 - p.bd))) >> (10 - p.bd)
                          : tc10 << (p.bd - 10);
  *tc = bs > 0 ? t : 0;
}

// one line's N-sample window starting x0 samples across, columns clamped
// to the plane as the reference's window gather clamps them
template <int N>
__device__ __forceinline__ void load_line(const Params& p, const int* src,
                                          long long row, int x0,
                                          int (&w)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    w[k] = __ldg(src + row + clampi(x0 + k, 0, p.span - 1) * p.sx);
}

// add a window sample's change into dst at the column the window read
__device__ __forceinline__ void add(const Params& p, int* dst, long long row,
                                    int x, int delta) {
  if (delta != 0)
    atomicAdd(dst + row + clampi(x, 0, p.span - 1) * p.sx, delta);
}

#define P(w, i) (w)[7 - (i)]
#define Q(w, i) (w)[8 + (i)]

// ---------------------------------------------------------------------
// luma (ops/deblock.py deblock_vertical_luma_plain)
// ---------------------------------------------------------------------

enum { F_LARGE, F_STRONG, F_WEAK };

__device__ __forceinline__ int sp_large(const int (&w)[16], int ml) {
  return abs(P(w, 3) - P(w, 0))
         + (ml == 7 ? abs(P(w, 7) - P(w, 6) - P(w, 5) + P(w, 4)) : 0);
}

__device__ __forceinline__ int sq_large(const int (&w)[16], int ml) {
  return abs(Q(w, 0) - Q(w, 3))
         + (ml == 7 ? abs(Q(w, 4) - Q(w, 5) - Q(w, 6) + Q(w, 7)) : 0);
}

__global__ void __launch_bounds__(THREADS) luma_kernel(Params p) {
  int s, e;
  if (!my_edge(p, &s, &e)) return;
  const int i = s * p.E + e;
  int tc, beta;
  tc_beta(p, 0, i, &tc, &beta);
  if (tc <= 0) return;  // every filter is gated on tc > 0
  const int maxp = __ldg(p.maxp[0] + i), maxq = __ldg(p.maxq[0] + i);
  const int* src = p.src[0];
  const long long row0 = (long long)(4 * s) * p.sa;
  const int x0 = 4 * e - 8;

  // ---- decisions, from lines 0 and 3 ---------------------------------
  int filt, mlp, mlq, nd_p, nd_q;
  {
    int w0[16], w3[16];
    load_line(p, src, row0, x0, w0);
    load_line(p, src, row0 + 3 * p.sa, x0, w3);
    const int dp0 = abs(P(w0, 2) - 2 * P(w0, 1) + P(w0, 0));
    const int dp3 = abs(P(w3, 2) - 2 * P(w3, 1) + P(w3, 0));
    const int dq0 = abs(Q(w0, 2) - 2 * Q(w0, 1) + Q(w0, 0));
    const int dq3 = abs(Q(w3, 2) - 2 * Q(w3, 1) + Q(w3, 0));
    const int d0 = dp0 + dq0, d3 = dp3 + dq3;
    const int tc25 = (tc * 5 + 1) >> 1;
    const int beta_3 = beta >> 3, beta_2 = beta >> 2;
    const bool large_p = maxp > 3 && __ldg(p.hor + i) == 0;
    const bool large_q = maxq > 3;
    mlp = large_p ? maxp : 3;
    mlq = large_q ? maxq : 3;

    bool use_large = false;
    if (large_p || large_q) {
      const int dp0l = large_p
          ? (dp0 + abs(P(w0, 5) - 2 * P(w0, 4) + P(w0, 3)) + 1) >> 1 : dp0;
      const int dp3l = large_p
          ? (dp3 + abs(P(w3, 5) - 2 * P(w3, 4) + P(w3, 3)) + 1) >> 1 : dp3;
      const int dq0l = large_q
          ? (dq0 + abs(Q(w0, 5) - 2 * Q(w0, 4) + Q(w0, 3)) + 1) >> 1 : dq0;
      const int dq3l = large_q
          ? (dq3 + abs(Q(w3, 5) - 2 * Q(w3, 4) + Q(w3, 3)) + 1) >> 1 : dq3;
      const int d0l = dp0l + dq0l, d3l = dp3l + dq3l;
      const int beta53 = (beta * 3) >> 5, beta_4 = beta >> 4;
      int sp0 = sp_large(w0, mlp), sp3 = sp_large(w3, mlp);
      int sq0 = sq_large(w0, mlq), sq3 = sq_large(w3, mlq);
      if (large_p) {
        sp0 = (sp0 + abs(P(w0, 3) - pick(w0, 7 - mlp)) + 1) >> 1;
        sp3 = (sp3 + abs(P(w3, 3) - pick(w3, 7 - mlp)) + 1) >> 1;
      }
      if (large_q) {
        sq0 = (sq0 + abs(Q(w0, 3) - pick(w0, 8 + mlq)) + 1) >> 1;
        sq3 = (sq3 + abs(Q(w3, 3) - pick(w3, 8 + mlq)) + 1) >> 1;
      }
      use_large = d0l + d3l < beta && sp0 + sq0 < beta53
                  && abs(P(w0, 0) - Q(w0, 0)) < tc25
                  && sp3 + sq3 < beta53 && abs(P(w3, 0) - Q(w3, 0)) < tc25
                  && (d0l << 1) < beta_4 && (d3l << 1) < beta_4;
    }
    // large, strong and weak exclude each other, so the reference's
    // compose order (weak over strong over large) never decides a sample
    if (use_large) {
      filt = F_LARGE;
    } else if (d0 + d3 >= beta) {
      return;
    } else if (maxp > 2 && maxq > 2
               && abs(P(w0, 3) - P(w0, 0)) + abs(Q(w0, 3) - Q(w0, 0)) < beta_3
               && abs(P(w0, 0) - Q(w0, 0)) < tc25
               && abs(P(w3, 3) - P(w3, 0)) + abs(Q(w3, 3) - Q(w3, 0)) < beta_3
               && abs(P(w3, 0) - Q(w3, 0)) < tc25
               && (d0 << 1) < beta_2 && (d3 << 1) < beta_2) {
      filt = F_STRONG;
    } else {
      filt = F_WEAK;
    }
    const bool both = maxp > 1 && maxq > 1;
    const int side_lim = (beta + (beta >> 1)) >> 3;
    nd_p = both && dp0 + dp3 < side_lim ? 2 : 1;
    nd_q = both && dq0 + dq3 < side_lim ? 2 : 1;
  }

  // ---- filters, line by line -----------------------------------------
  const int maxv = (1 << p.bd) - 1;
  const int ip = clampi((mlp - 3) >> 1, 0, 2) * 7;
  const int iq = clampi((mlq - 3) >> 1, 0, 2) * 7;
  for (int l = 0; l < 4; ++l) {
    const long long row = row0 + l * p.sa;
    int w[16];
    load_line(p, src, row, x0, w);
    const int p0 = P(w, 0), p1 = P(w, 1), p2 = P(w, 2), p3 = P(w, 3);
    const int q0 = Q(w, 0), q1 = Q(w, 1), q2 = Q(w, 2), q3 = Q(w, 3);
    if (filt == F_LARGE) {
      const int p4 = P(w, 4), p5 = P(w, 5), p6 = P(w, 6);
      const int q4 = Q(w, 4), q5 = Q(w, 5), q6 = Q(w, 6);
      int m;  // the middle value, by the reference's select order
      if (mlp == 5 && mlq == 5)
        m = (p4 + p3 + 2 * (p2 + p1 + p0 + q0 + q1 + q2) + q3 + q4 + 8) >> 4;
      else if (mlp == mlq)
        m = (p6 + p5 + p4 + p3 + p2 + p1 + 2 * (p0 + q0) + q1 + q2 + q3 + q4
             + q5 + q6 + 8) >> 4;
      else if (mlp + mlq == 12)
        m = (p5 + p4 + p3 + p2 + 2 * (p1 + p0 + q0 + q1) + q2 + q3 + q4 + q5
             + 8) >> 4;
      else if (mlp + mlq == 8)
        m = (p3 + p2 + p1 + p0 + q0 + q1 + q2 + q3 + 4) >> 3;
      else if (mlq == 7)
        m = (2 * (p2 + p1 + p0 + q0) + p0 + p1 + q1 + q2 + q3 + q4 + q5 + q6
             + 8) >> 4;
      else
        m = (p6 + p5 + p4 + p3 + p2 + p1 + 2 * (q2 + q1 + q0 + p0) + q0 + q1
             + 8) >> 4;
      const int refp = (pick(w, 7 - mlp) + pick(w, 8 - mlp) + 1) >> 1;
      const int refq = (pick(w, 8 + mlq) + pick(w, 7 + mlq) + 1) >> 1;
#pragma unroll
      for (int pos = 0; pos < 7; ++pos) {
        if (pos < mlp) {
          const int v = P(w, pos), lim = (tc * __ldg(p.lct + ip + pos)) >> 1;
          add(p, p.dst, row, 4 * e - 1 - pos, clampi(
              ((m * __ldg(p.lcm + ip + pos) + refp * __ldg(p.lcr + ip + pos)
                + 32) >> 6) - v, -lim, lim));
        }
        if (pos < mlq) {
          const int v = Q(w, pos), lim = (tc * __ldg(p.lct + iq + pos)) >> 1;
          add(p, p.dst, row, 4 * e + pos, clampi(
              ((m * __ldg(p.lcm + iq + pos) + refq * __ldg(p.lcr + iq + pos)
                + 32) >> 6) - v, -lim, lim));
        }
      }
    } else if (filt == F_STRONG) {
      const int tc2 = tc << 1, tc3 = tc * 3;
      add(p, p.dst, row, 4 * e - 1, clampi(
          ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0, -tc3, tc3));
      add(p, p.dst, row, 4 * e - 2, clampi(
          ((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -tc2, tc2));
      add(p, p.dst, row, 4 * e - 3, clampi(
          ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2, -tc, tc));
      add(p, p.dst, row, 4 * e, clampi(
          ((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0, -tc3, tc3));
      add(p, p.dst, row, 4 * e + 1, clampi(
          ((p0 + q0 + q1 + q2 + 2) >> 2) - q1, -tc2, tc2));
      add(p, p.dst, row, 4 * e + 2, clampi(
          ((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2, -tc, tc));
    } else {
      const int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta0) >= 10 * tc) continue;
      const int d0c = clampi(delta0, -tc, tc), tc_2 = tc >> 1;
      add(p, p.dst, row, 4 * e - 1, clampi(p0 + d0c, 0, maxv) - p0);
      add(p, p.dst, row, 4 * e, clampi(q0 - d0c, 0, maxv) - q0);
      if (nd_p > 1) {
        const int dp1 = clampi((((p2 + p0 + 1) >> 1) - p1 + d0c) >> 1,
                               -tc_2, tc_2);
        add(p, p.dst, row, 4 * e - 2, clampi(p1 + dp1, 0, maxv) - p1);
      }
      if (nd_q > 1) {
        const int dq1 = clampi((((q2 + q0 + 1) >> 1) - q1 - d0c) >> 1,
                               -tc_2, tc_2);
        add(p, p.dst, row, 4 * e + 1, clampi(q1 + dq1, 0, maxv) - q1);
      }
    }
  }
}

#undef P
#undef Q
#define P(w, i) (w)[3 - (i)]
#define Q(w, i) (w)[4 + (i)]

// ---------------------------------------------------------------------
// chroma, 4:2:0 (ops/deblock.py deblock_vertical_chroma_plain); plane
// blockIdx.y: Cb, Cr
// ---------------------------------------------------------------------

// one decision line: d (its dp + dq) and its dSam test (maxq == 3)
__device__ __forceinline__ bool chroma_line(const int (&w)[8], bool one,
                                            int tc25, int beta_2, int beta_3,
                                            int* d) {
  const int p2 = one ? P(w, 1) : P(w, 2), p3 = one ? P(w, 1) : P(w, 3);
  *d = abs(p2 - 2 * P(w, 1) + P(w, 0)) + abs(Q(w, 2) - 2 * Q(w, 1) + Q(w, 0));
  return (*d << 1) < beta_2
         && abs(p3 - P(w, 0)) + abs(Q(w, 0) - Q(w, 3)) < beta_3
         && abs(P(w, 0) - Q(w, 0)) < tc25;
}

__global__ void __launch_bounds__(THREADS) chroma_kernel(Params p) {
  int s, e;
  if (!my_edge(p, &s, &e)) return;
  const int ch = blockIdx.y, i = s * p.E + e;
  int tc, beta;
  tc_beta(p, ch, i, &tc, &beta);
  const int maxp = __ldg(p.maxp[ch] + i), maxq = __ldg(p.maxq[ch] + i);
  if (tc <= 0 || maxp <= 0 || maxq <= 0) return;
  const int* src = p.src[ch];
  int* dst = p.dst + ch * p.plane;
  const long long row0 = (long long)(2 * s) * p.sa;
  const int x0 = 8 * e - 4;

  int mlp = maxp, mlq = maxq;
  if (maxq == 3) {  // vvc_filter_template.c:700-735: keep 3 or demote to 1
    int w0[8], w1[8], d0, d1;
    load_line(p, src, row0, x0, w0);
    load_line(p, src, row0 + p.sa, x0, w1);
    const int tc25 = (tc * 5 + 1) >> 1;
    const bool one = maxp == 1;
    const bool sam0 = chroma_line(w0, one, tc25, beta >> 2, beta >> 3, &d0);
    const bool sam1 = chroma_line(w1, one, tc25, beta >> 2, beta >> 3, &d1);
    if (!(d0 + d1 < beta && sam0 && sam1)) mlp = mlq = 1;
  }
  const bool strong = mlp == 3 && mlq == 3, one_side = mlq == 3 && !strong;
  const int maxv = (1 << p.bd) - 1;
  for (int l = 0; l < 2; ++l) {
    const long long row = row0 + l * p.sa;
    int w[8];
    load_line(p, src, row, x0, w);
    const int p0 = P(w, 0), p1 = P(w, 1), p2 = P(w, 2), p3 = P(w, 3);
    const int q0 = Q(w, 0), q1 = Q(w, 1), q2 = Q(w, 2), q3 = Q(w, 3);
    // cl(v, c) of the reference: v clamped to c +- tc, as a delta from c
#define CL(v, c) (min(max((v), (c) - tc), (c) + tc) - (c))
    if (strong) {
      add(p, dst, row, 8 * e - 1,
          CL((p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0));
      add(p, dst, row, 8 * e - 2,
          CL((2 * p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3, p1));
      add(p, dst, row, 8 * e - 3,
          CL((3 * p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3, p2));
      add(p, dst, row, 8 * e,
          CL((p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0));
    } else if (one_side) {
      add(p, dst, row, 8 * e - 1,
          CL((3 * p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0));
      add(p, dst, row, 8 * e,
          CL((2 * p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0));
    } else {
      const int wd = clampi((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
      add(p, dst, row, 8 * e - 1, clampi(p0 + wd, 0, maxv) - p0);
      add(p, dst, row, 8 * e, clampi(q0 - wd, 0, maxv) - q0);
    }
    if (strong || one_side) {  // q1 and q2: the same in both
      add(p, dst, row, 8 * e + 1,
          CL((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3, q1));
      add(p, dst, row, 8 * e + 2,
          CL((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3, q2));
    }
#undef CL
  }
}

#undef P
#undef Q

// One pass.  src: nch (1 luma; 1 or 2 chroma: Cb and Cr) pointers to
// (H, W) int32 planes; dst: (nch, H, W) int32, a copy of them; grids:
// per plane bs, qp, maxp, maxq and (luma) the horizontal CTU edge flag,
// (S, E) int32 each, S = (view rows) / (4 luma, 2 chroma) and E = (view
// columns) / (4 luma, 8 chroma), the view being the plane (vertical
// pass) or its transpose (horizontal pass).
extern "C" int deblock_launch(
    const long long* src, int* dst, int nch, int H, int W, int chroma,
    int horizontal, const long long* grids, int S, int E,
    const int* beta_off, const int* tc_off, int bit_depth, const int* tct,
    const int* betat, const int* lcm, const int* lcr, const int* lct,
    void* stream) {
  const int rows = horizontal ? W : H, cols = horizontal ? H : W;
  const int seg = chroma ? 2 : 4, grid = chroma ? 8 : 4;
  if (nch < 1 || nch > MAX_NCH || (!chroma && nch != 1) || H < 1 || W < 1
      || bit_depth < 8 || bit_depth > 12 || rows % seg || cols % grid
      || S != rows / seg || E != cols / grid || !dst || !tct || !betat
      || !lcm || !lcr || !lct)
    return (int)cudaErrorInvalidValue;
  Params p{};
  const int ng = chroma ? 4 : 5;
  for (int c = 0; c < nch; ++c) {
    p.src[c] = (const int*)src[c];
    p.bs[c] = (const int*)grids[c * ng];
    p.qp[c] = (const int*)grids[c * ng + 1];
    p.maxp[c] = (const int*)grids[c * ng + 2];
    p.maxq[c] = (const int*)grids[c * ng + 3];
    p.beta_off[c] = beta_off[c];
    p.tc_off[c] = tc_off[c];
    if (!p.src[c] || !p.bs[c] || !p.qp[c] || !p.maxp[c] || !p.maxq[c])
      return (int)cudaErrorInvalidValue;
  }
  p.hor = chroma ? nullptr : (const int*)grids[4];
  if (!chroma && !p.hor) return (int)cudaErrorInvalidValue;
  p.dst = dst;
  p.S = S;
  p.E = E;
  p.sa = horizontal ? 1 : W;
  p.sx = horizontal ? W : 1;
  p.span = cols;
  p.plane = (long long)H * W;
  p.seg_fast = horizontal;
  p.bd = bit_depth;
  p.tct = tct;
  p.betat = betat;
  p.lcm = lcm;
  p.lcr = lcr;
  p.lct = lct;
  const long long items = (long long)S * E;
  if (items == 0) return (int)cudaSuccess;
  const dim3 blocks((unsigned)((items + THREADS - 1) / THREADS), nch);
  if (chroma)
    chroma_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  else
    luma_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* deblock_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
