// Deblocking filter for Hopper: the vertical edges, then the horizontal
// edges of the result, of a luma plane, or of the Cb and Cr planes, in
// one launch; or one of the two passes alone.
//
// Replaces the JAX package's XLA deblock, ffmpeg_tpu/ops/deblock.py:67,300
// (deblock_vertical_luma, deblock_vertical_chroma; not Pallas), which the
// frame program runs vertical, then horizontal on the transposed plane,
// per component (ffmpeg_tpu/models/vvc/pipeline.py loopfilters).  Its
// oracle is the plain torch version in ffmpeg_tpu_torch/ops/deblock.py
// (deblock_planes_plain over deblock_vertical_luma_plain and
// deblock_vertical_chroma_plain): the same decisions and filters
// (vvc_filter_template.c:466-760, h2656_deblock_template.c), bit for bit.
//
// Bound.  Each plane is read once and written once, and both passes'
// per-edge grids are read once, so bytes bound the work: about 0.011 ms
// for a 1080p 4:2:0 frame at 3.35 TB/s (chip_smoke.py's bound).  A few
// hundred integer operations per filtered segment are far from the
// operation bound, and the tensor cores have no part in an integer
// stencil.  The design keeps each sample's traffic to one write and one
// read of device memory (neighbouring tiles' re-reads of a halo come
// from the L2 cache):
//
// Tiles.  A block owns a TILE x TILE tile of output samples of one
// plane (blockIdx.x, blockIdx.y; the plane blockIdx.z).  It copies the
// tile and a halo of HALO samples on each side into shared memory with
// cp.async, runs the vertical pass there, then the horizontal pass on
// its result, and writes the tile's samples once, with coalesced
// stores, into a fresh output plane: no copy of the planes, no second
// trip through device memory between the passes.  The halo is what the
// horizontal pass's windows reach above and below the tile (luma edges
// 4 apart change up to 7 samples on a side and read 8, so the edges
// from 4 above the tile to 4 below it read 12 rows beyond it; chroma
// edges 8 apart read 4), and what the vertical pass's windows reach
// beside it; HALO is a multiple of the edge spacing, so the tile's grid
// stays the plane's grid.  TILE and HALO come from ops/deblock.py at
// build time (-DDEBLOCK_TILE, -DDEBLOCK_HALO_LUMA, -DDEBLOCK_HALO_CHROMA),
// whose plain emulation of these tiles (deblock_tiled_plain) the CPU
// tests hold equal to the whole-plane passes.
//
// Scatter-add in shared memory.  As in the reference, every window is
// read from the pass's input, and each window's change is added to a
// second buffer that starts as a copy of it: neighbouring edges' windows
// overlap, and at the plane's border several clamped window positions
// name one sample.  The adds are integer atomicAdds on shared memory:
// exact, and the same in any order.  Window positions are clamped to the
// plane in plane coordinates first, so a clamped position reads and
// writes the border sample's own slot, never a halo copy of it.
//
// Work only where bs > 0.  While the tile's copy is in flight, the block
// loads both passes' grids at the tile's positions, all loads at once,
// and lists the (segment, edge) positions with bs above 0 (a warp ballot
// appends them to a list in shared memory, so a bs-0 position costs a
// load and a test); the tables sit in shared memory beside the tile.
// Then SEG threads take each listed segment, one line each (luma
// 4, chroma 2): they share lines 0 and 3 (luma) or 0 and 1 (chroma) for
// the segment's decision through warp shuffles, and each filters its
// own line.  One window of 16 (luma) or 8 (chroma) samples per thread
// keeps registers at 64 or below, so that 1024 threads fit an SM: 4
// blocks of 256 at the tile edge of 48 (the registers, not the 44 KB of
// shared memory a luma block takes, set that limit).  The tile edge was
// chosen on the card (ffmpeg_tpu_torch/tools/deblock_tiles.py, PERF.md):
// larger tiles read less halo, smaller ones leave more blocks per SM.
//
// Build (at first use, ffmpeg_tpu_torch/ops/deblock.py _get_kernel), as
// one command:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -DDEBLOCK_TILE=.. -DDEBLOCK_HALO_LUMA=..
//        -DDEBLOCK_HALO_CHROMA=.. -o _build/libdeblock_...so deblock.cu

#include <cuda_runtime.h>

#if !defined(DEBLOCK_TILE) || !defined(DEBLOCK_HALO_LUMA) || \
    !defined(DEBLOCK_HALO_CHROMA)
#error "build with the tile constants of ops/deblock.py"
#endif

#define TILE DEBLOCK_TILE
#define THREADS (TILE <= 32 ? 128 : 256)
#define MIN_BLOCKS (1024 / THREADS)  // so at most 64 registers a thread
#define MAX_QP 63
#define INTRA_TC_OFFSET 2  // DEFAULT_INTRA_TC_OFFSET
#define MAX_NCH 2
#define FULL 0xffffffffu

static_assert(TILE % 8 == 0 && TILE <= 64, "TILE: a multiple of 8, <= 64");

// the geometry of a component kind: edge spacing G, lines per segment
// SEG, window N (samples read across an edge, N/2 on each side), the
// samples written before (WP) and from (WQ + 1) the edge, grids per plane
template <bool C> struct Kind;
template <> struct Kind<false> {  // luma
  static constexpr int G = 4, SEG = 4, N = 16, WP = 7, WQ = 6, NG = 5;
  static constexpr int HALO = DEBLOCK_HALO_LUMA;
};
template <> struct Kind<true> {   // 4:2:0 chroma
  static constexpr int G = 8, SEG = 2, N = 8, WP = 3, WQ = 2, NG = 4;
  static constexpr int HALO = DEBLOCK_HALO_CHROMA;
};

// the tables' lengths: TCTABLE, BETATABLE, then LARGE_COEF_M, LARGE_COEF_R
// and LARGE_TC_MULT (3 x 7 each)
#define N_TC 66
#define N_BETA 64
#define N_TABS (N_TC + N_BETA + 3 * 21)

template <class K> struct Tile {
  static constexpr int P = TILE + 2 * K::HALO;  // shared row pitch
  // listed (segment, edge) positions of one pass, at most
  static constexpr int LIST = (P / K::SEG) * (TILE / K::G + 3);
  // a thread's candidate positions of one pass
  static constexpr int PER = (LIST + THREADS - 1) / THREADS;
  // two buffers, two lists, two counts, the tables (bytes)
  static constexpr int SMEM = (2 * P * P + 2 * LIST + 2 + N_TABS) * 4;
  // the windows of the edges that write into the tile reach
  // G * floor(WQ / G) + N / 2 before it and G * floor((WP - 1) / G) + N / 2
  // after it (edge_range)
  static_assert(K::HALO % K::G == 0
                && K::HALO >= K::G * (K::WQ / K::G) + K::N / 2
                && K::HALO >= K::G * ((K::WP - 1) / K::G) + K::N / 2,
                "the halo keeps the edge grid and covers the windows");
};

struct Grids {              // one pass's per-edge grids, (S, E) int32
  const int* g[MAX_NCH][5];  // bs, qp, maxp, maxq and (luma) the CTU flag
  int E;                     // edges across the pass's lines
};

struct Params {
  const int* src[MAX_NCH];  // input planes, (H, W) row-major each
  int* dst;                 // (nch, H, W): the output planes
  Grids v, h;               // the vertical and the horizontal pass
  int beta_off[MAX_NCH];    // effective offsets, already doubled
  int tc_off[MAX_NCH];
  int H, W;
  int do_v, do_h;           // which passes run
  int vec;                  // 16-byte rows: W % 4 == 0, aligned planes
  int bd;                   // bit depth
  const int* tct;           // TCTABLE (66)
  const int* betat;         // BETATABLE (64)
  const int* lcm;           // LARGE_COEF_M, LARGE_COEF_R, LARGE_TC_MULT:
  const int* lcr;           // (3, 7) each, row (max length - 3) / 2
  const int* lct;
};

struct Tabs {               // the tables' copies in shared memory
  const int *tc, *beta, *lcm, *lcr, *lct;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
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

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// this thread's cp.async copies have landed (a block barrier then shows
// every thread's)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// tc (0 where bs is 0) and beta of one segment (ops/deblock.py _tc_beta)
__device__ __forceinline__ void tc_beta(const Params& p, const Tabs& tb,
                                        int ch, int bs, int qp, int* tc,
                                        int* beta) {
  *beta = tb.beta[clampi(qp + p.beta_off[ch], 0, MAX_QP)] << (p.bd - 8);
  const int tc10 = tb.tc[clampi(
      qp + INTRA_TC_OFFSET * (bs - 1) + p.tc_off[ch], 0,
      MAX_QP + INTRA_TC_OFFSET)];
  const int t = p.bd < 10 ? (tc10 + (1 << (9 - p.bd))) >> (10 - p.bd)
                          : tc10 << (p.bd - 10);
  *tc = bs > 0 ? t : 0;
}

// The edges [lo, hi] whose written samples reach [a, a + TILE) of an
// axis with n edges (edge e at G * e).
template <class K>
__device__ __forceinline__ void edge_range(int a, int n, int* lo, int* hi) {
  *lo = max(0, floor_div(a - K::WQ + K::G - 1, K::G));
  *hi = min(n - 1, floor_div(a + TILE - 1 + K::WP, K::G));
}

// A listed position: its segment and edge within the pass's ranges, its
// max filter lengths, the luma CTU flag, bs and qp.
struct Entry {
  int s, e, maxp, maxq, hor, bs, qp;
};

__device__ __forceinline__ int pack(int sl, int el, int mp, int mq, int hor,
                                    int bs, int qp) {
  return sl | el << 6 | (mp & 7) << 12 | (mq & 7) << 15 | (hor != 0) << 18
         | (bs & 3) << 19 | (qp & 0xff) << 21;
}

__device__ __forceinline__ Entry unpack(int v, int s0, int e0) {
  return {s0 + (v & 63), e0 + ((v >> 6) & 63), (v >> 12) & 7, (v >> 15) & 7,
          (v >> 18) & 1, (v >> 19) & 3, (int)(signed char)((v >> 21) & 0xff)};
}

// The grid values of one pass at segments [s0, s1) x edges [e0, e1],
// PER positions per thread, all loads in flight at once (bs, qp, maxp,
// maxq and the luma CTU flag of position threadIdx.x + r * THREADS).
template <bool C>
struct Cands {
  static constexpr int PER = Tile<Kind<C>>::PER;
  static constexpr int NE = TILE / Kind<C>::G + 3;  // edges, at most
  int v[PER][5];
  int s0, e0;
};

template <bool C>
__device__ __forceinline__ void load_cands(const Params& p, const Grids& g,
                                           int ch, int s0, int s1, int e0,
                                           int e1, Cands<C>* c) {
  constexpr int NE = Cands<C>::NE;
  const int ne = e1 - e0 + 1;
  c->s0 = s0;
  c->e0 = e0;
  // position (sl, el), el < ne, is candidate sl * NE + el
  const int n = ne > 0 && s1 > s0 ? (s1 - s0) * NE : 0;
  if (ne > NE || n > Tile<Kind<C>>::LIST) __trap();  // wrong ranges
#pragma unroll
  for (int r = 0; r < Cands<C>::PER; ++r) {
    const int i = r * THREADS + threadIdx.x;
    const int sl = i / NE, el = i - sl * NE;
    if (i >= n || el >= ne) {
      c->v[r][0] = 0;
      continue;
    }
    const int gi = (s0 + sl) * g.E + e0 + el;
#pragma unroll
    for (int k = 0; k < Kind<C>::NG; ++k) c->v[r][k] = __ldg(g.g[ch][k] + gi);
  }
}

// List the loaded positions with bs above 0 (chroma: and both max
// lengths), in any order; a warp ballot appends them.
template <bool C>
__device__ __forceinline__ void append(const Cands<C>& c, int* list,
                                       int* count) {
#pragma unroll
  for (int r = 0; r < Cands<C>::PER; ++r) {
    const int i = r * THREADS + threadIdx.x;
    const int* v = c.v[r];
    const bool act = v[0] > 0 && (!C || (v[2] > 0 && v[3] > 0));
    const unsigned m = __ballot_sync(FULL, act);
    if (m) {  // the same in every lane
      const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(count, __popc(m));
      base = __shfl_sync(FULL, base, leader);
      if (act) {
        constexpr int NE = Cands<C>::NE;
        list[base + __popc(m & ((1u << lane) - 1))] =
            pack(i / NE, i % NE, v[2], v[3], C ? 0 : v[4], v[0], v[1]);
      }
    }
  }
}

// One line's window across an edge in a shared buffer of pitch PP: the
// samples pos0 .. pos0 + N - 1 along the axis across the edge (columns
// for the vertical pass, rows for the horizontal one), clamped to the
// plane's span in plane coordinates, then made relative to the buffer's
// origin on that axis.  fixed: the line's own offset in the buffer.
template <int N, int PP, bool HOR>
struct Line {
  static constexpr int STRIDE = HOR ? PP : 1;  // along the window
  int fixed, pos0, span, origin;

  // the window lies inside the plane: sample k at base() + k * STRIDE
  __device__ __forceinline__ bool inside() const {
    return pos0 >= 0 && pos0 + N <= span;
  }
  __device__ __forceinline__ int base() const {
    return fixed + (pos0 - origin) * STRIDE;
  }

  __device__ __forceinline__ int idx(int k) const {
    if (inside()) return base() + k * STRIDE;
    return fixed + (clampi(pos0 + k, 0, span - 1) - origin) * STRIDE;
  }

  __device__ __forceinline__ void load(const int* buf, int (&w)[N]) const {
    if (inside()) {
      const int* b = buf + base();
      if constexpr (!HOR) {
        // 16-byte aligned: pos0 - origin, fixed and PP are multiples of 4
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const int4 t = reinterpret_cast<const int4*>(b)[q];
          w[4 * q] = t.x;
          w[4 * q + 1] = t.y;
          w[4 * q + 2] = t.z;
          w[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) w[k] = b[k * STRIDE];
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) w[k] = buf[idx(k)];
    }
  }

  // add the change of window sample k where the window read it
  __device__ __forceinline__ void add(int* buf, int k, int delta) const {
    if (delta != 0) atomicAdd(buf + idx(k), delta);
  }
};

template <bool C, bool HOR>
__device__ __forceinline__ Line<Kind<C>::N, Tile<Kind<C>>::P, HOR> line_of(
    const Params& p, const Entry& t, int oy, int ox) {
  using K = Kind<C>;
  constexpr int PP = Tile<K>::P;
  const int l = K::SEG * t.s + threadIdx.x % K::SEG;  // this lane's line
  if (HOR)
    return {l - ox, K::G * t.e - K::N / 2, p.H, oy};
  return {(l - oy) * PP, K::G * t.e - K::N / 2, p.W, ox};
}

#define P(w, i) (w)[7 - (i)]
#define Q(w, i) (w)[8 + (i)]

// ---------------------------------------------------------------------
// luma (ops/deblock.py deblock_vertical_luma_plain)
// ---------------------------------------------------------------------

enum { F_NONE, F_LARGE, F_STRONG, F_WEAK };

__device__ __forceinline__ int sp_large(const int (&w)[16], int ml) {
  return abs(P(w, 3) - P(w, 0))
         + (ml == 7 ? abs(P(w, 7) - P(w, 6) - P(w, 5) + P(w, 4)) : 0);
}

__device__ __forceinline__ int sq_large(const int (&w)[16], int ml) {
  return abs(Q(w, 0) - Q(w, 3))
         + (ml == 7 ? abs(Q(w, 4) - Q(w, 5) - Q(w, 6) + Q(w, 7)) : 0);
}

// One pass over the listed luma segments: the 4 lanes of a quad take
// one segment, lane l its line l.  in: the pass's input; acc: a copy of
// it, to which each change is added.
template <bool HOR>
__device__ void luma_pass(const Params& p, const Tabs& tb, const int* list,
                          int n, int s0, int e0, const int* in, int* acc,
                          int oy, int ox) {
  constexpr int NQ = THREADS / 4;
  const int quad = threadIdx.x / 4;
  const int maxv = (1 << p.bd) - 1;
  for (int j0 = 0; j0 < n; j0 += NQ) {  // n is the same in every thread
    const bool valid = j0 + quad < n;
    const Entry t = unpack(list[min(j0 + quad, n - 1)], s0, e0);
    const auto ln = line_of<false, HOR>(p, t, oy, ox);
    int w[16];
    ln.load(in, w);
    int tc, beta;
    tc_beta(p, tb, 0, t.bs, t.qp, &tc, &beta);

    // ---- this line's share of the decision --------------------------
    const bool large_p = t.maxp > 3 && t.hor == 0, large_q = t.maxq > 3;
    const int mlp = large_p ? t.maxp : 3, mlq = large_q ? t.maxq : 3;
    const int dp = abs(P(w, 2) - 2 * P(w, 1) + P(w, 0));
    const int dq = abs(Q(w, 2) - 2 * Q(w, 1) + Q(w, 0));
    const int dpl = large_p
        ? (dp + abs(P(w, 5) - 2 * P(w, 4) + P(w, 3)) + 1) >> 1 : dp;
    const int dql = large_q
        ? (dq + abs(Q(w, 5) - 2 * Q(w, 4) + Q(w, 3)) + 1) >> 1 : dq;
    int sp = sp_large(w, mlp), sq = sq_large(w, mlq);
    if (large_p) sp = (sp + abs(P(w, 3) - pick(w, 7 - mlp)) + 1) >> 1;
    if (large_q) sq = (sq + abs(Q(w, 3) - pick(w, 8 + mlq)) + 1) >> 1;
    const int tc25 = (tc * 5 + 1) >> 1;
    const int pq = abs(P(w, 0) - Q(w, 0));
    const bool l_ok = sp + sq < ((beta * 3) >> 5) && pq < tc25;
    const bool s_ok = abs(P(w, 3) - P(w, 0)) + abs(Q(w, 3) - Q(w, 0))
                      < (beta >> 3) && pq < tc25;
    // d, dl < 2^15 and dp, dq < 2^14 at 12 bits
    const unsigned a = (unsigned)(dp + dq) | (unsigned)(dpl + dql) << 16;
    const unsigned b = (unsigned)dp | (unsigned)dq << 14
                       | (unsigned)l_ok << 28 | (unsigned)s_ok << 29;
    // lines 0 and 3 of the segment (every lane shuffles)
    const unsigned a0 = __shfl_sync(FULL, a, 0, 4);
    const unsigned a3 = __shfl_sync(FULL, a, 3, 4);
    const unsigned b0 = __shfl_sync(FULL, b, 0, 4);
    const unsigned b3 = __shfl_sync(FULL, b, 3, 4);
    if (!valid || tc <= 0) continue;  // every filter is gated on tc > 0

    // ---- the segment's decision (lines 0 and 3) -----------------------
    const int d0 = a0 & 0xffff, d0l = a0 >> 16;
    const int d3 = a3 & 0xffff, d3l = a3 >> 16;
    const int dp0 = b0 & 0x3fff, dq0 = (b0 >> 14) & 0x3fff;
    const int dp3 = b3 & 0x3fff, dq3 = (b3 >> 14) & 0x3fff;
    int filt;
    if ((large_p || large_q) && d0l + d3l < beta && ((b0 & b3) >> 28 & 1)
        && (d0l << 1) < (beta >> 4) && (d3l << 1) < (beta >> 4)) {
      filt = F_LARGE;
    } else if (d0 + d3 >= beta) {
      filt = F_NONE;
    } else if (t.maxp > 2 && t.maxq > 2 && ((b0 & b3) >> 29 & 1)
               && (d0 << 1) < (beta >> 2) && (d3 << 1) < (beta >> 2)) {
      filt = F_STRONG;
    } else {
      filt = F_WEAK;
    }
    // large, strong and weak exclude each other, so the reference's
    // compose order (weak over strong over large) never decides a sample
    if (filt == F_NONE) continue;
    const bool both = t.maxp > 1 && t.maxq > 1;
    const int side_lim = (beta + (beta >> 1)) >> 3;
    const int nd_p = both && dp0 + dp3 < side_lim ? 2 : 1;
    const int nd_q = both && dq0 + dq3 < side_lim ? 2 : 1;

    // ---- this line's filter ---------------------------------------------
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
      const int ip = clampi((mlp - 3) >> 1, 0, 2) * 7;
      const int iq = clampi((mlq - 3) >> 1, 0, 2) * 7;
#pragma unroll
      for (int pos = 0; pos < 7; ++pos) {
        if (pos < mlp) {
          const int v = P(w, pos), lim = (tc * tb.lct[ip + pos]) >> 1;
          ln.add(acc, 7 - pos, clampi(
              ((m * tb.lcm[ip + pos] + refp * tb.lcr[ip + pos] + 32) >> 6)
              - v, -lim, lim));
        }
        if (pos < mlq) {
          const int v = Q(w, pos), lim = (tc * tb.lct[iq + pos]) >> 1;
          ln.add(acc, 8 + pos, clampi(
              ((m * tb.lcm[iq + pos] + refq * tb.lcr[iq + pos] + 32) >> 6)
              - v, -lim, lim));
        }
      }
    } else if (filt == F_STRONG) {
      const int tc2 = tc << 1, tc3 = tc * 3;
      ln.add(acc, 7, clampi(
          ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0, -tc3, tc3));
      ln.add(acc, 6, clampi(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -tc2, tc2));
      ln.add(acc, 5, clampi(
          ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2, -tc, tc));
      ln.add(acc, 8, clampi(
          ((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0, -tc3, tc3));
      ln.add(acc, 9, clampi(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, -tc2, tc2));
      ln.add(acc, 10, clampi(
          ((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2, -tc, tc));
    } else {
      const int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta0) >= 10 * tc) continue;
      const int d0c = clampi(delta0, -tc, tc), tc_2 = tc >> 1;
      ln.add(acc, 7, clampi(p0 + d0c, 0, maxv) - p0);
      ln.add(acc, 8, clampi(q0 - d0c, 0, maxv) - q0);
      if (nd_p > 1) {
        const int dp1 = clampi((((p2 + p0 + 1) >> 1) - p1 + d0c) >> 1,
                               -tc_2, tc_2);
        ln.add(acc, 6, clampi(p1 + dp1, 0, maxv) - p1);
      }
      if (nd_q > 1) {
        const int dq1 = clampi((((q2 + q0 + 1) >> 1) - q1 - d0c) >> 1,
                               -tc_2, tc_2);
        ln.add(acc, 9, clampi(q1 + dq1, 0, maxv) - q1);
      }
    }
  }
}

#undef P
#undef Q
#define P(w, i) (w)[3 - (i)]
#define Q(w, i) (w)[4 + (i)]

// ---------------------------------------------------------------------
// chroma, 4:2:0 (ops/deblock.py deblock_vertical_chroma_plain)
// ---------------------------------------------------------------------

// One pass over the listed chroma segments of plane ch: the 2 lanes of a
// pair take one segment, lane l its line l.
template <bool HOR>
__device__ void chroma_pass(const Params& p, const Tabs& tb, int ch,
                            const int* list, int n, int s0, int e0,
                            const int* in, int* acc, int oy, int ox) {
  constexpr int NPAIR = THREADS / 2;
  const int pair = threadIdx.x / 2;
  const int maxv = (1 << p.bd) - 1;
  for (int j0 = 0; j0 < n; j0 += NPAIR) {  // n is the same in every thread
    const bool valid = j0 + pair < n;
    const Entry t = unpack(list[min(j0 + pair, n - 1)], s0, e0);
    const auto ln = line_of<true, HOR>(p, t, oy, ox);
    int w[8];
    ln.load(in, w);
    int tc, beta;
    tc_beta(p, tb, ch, t.bs, t.qp, &tc, &beta);

    // this line's d and dSam (vvc_filter_template.c:700-735), for a
    // maxq of 3: keep 3 or demote to 1
    const bool one = t.maxp == 1;
    const int pp2 = one ? P(w, 1) : P(w, 2), pp3 = one ? P(w, 1) : P(w, 3);
    const int d = abs(pp2 - 2 * P(w, 1) + P(w, 0))
                  + abs(Q(w, 2) - 2 * Q(w, 1) + Q(w, 0));
    const bool sam = (d << 1) < (beta >> 2)
                     && abs(pp3 - P(w, 0)) + abs(Q(w, 0) - Q(w, 3))
                        < (beta >> 3)
                     && abs(P(w, 0) - Q(w, 0)) < ((tc * 5 + 1) >> 1);
    const int a = d | (int)sam << 20;  // d < 2^15 at 12 bits
    const int a0 = __shfl_sync(FULL, a, 0, 2);  // lines 0 and 1
    const int a1 = __shfl_sync(FULL, a, 1, 2);
    if (!valid || tc <= 0) continue;  // every filter is gated on tc > 0
    int mlp = t.maxp, mlq = t.maxq;
    if (mlq == 3 && !((a0 & 0xfffff) + (a1 & 0xfffff) < beta
                      && (a0 & a1) >> 20))
      mlp = mlq = 1;
    const bool strong = mlp == 3 && mlq == 3, one_side = mlq == 3 && !strong;
    const int p0 = P(w, 0), p1 = P(w, 1), p2 = P(w, 2), p3 = P(w, 3);
    const int q0 = Q(w, 0), q1 = Q(w, 1), q2 = Q(w, 2), q3 = Q(w, 3);
    // cl(v, c) of the reference: v clamped to c +- tc, as a delta from c
#define CL(v, c) (min(max((v), (c) - tc), (c) + tc) - (c))
    if (strong) {
      ln.add(acc, 3, CL((p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0));
      ln.add(acc, 2, CL((2 * p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3, p1));
      ln.add(acc, 1, CL((3 * p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3, p2));
      ln.add(acc, 4, CL((p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0));
    } else if (one_side) {
      ln.add(acc, 3, CL((3 * p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0));
      ln.add(acc, 4, CL((2 * p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0));
    } else {
      const int wd = clampi((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
      ln.add(acc, 3, clampi(p0 + wd, 0, maxv) - p0);
      ln.add(acc, 4, clampi(q0 - wd, 0, maxv) - q0);
    }
    if (strong || one_side) {  // q1 and q2: the same in both
      ln.add(acc, 5, CL((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3, q1));
      ln.add(acc, 6, CL((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3, q2));
    }
#undef CL
  }
}

#undef P
#undef Q

template <bool C, bool HOR>
__device__ __forceinline__ void run_pass(const Params& p, const Tabs& tb,
                                         int ch, const int* list, int n,
                                         int s0, int e0, const int* in,
                                         int* acc, int oy, int ox) {
  if constexpr (C)
    chroma_pass<HOR>(p, tb, ch, list, n, s0, e0, in, acc, oy, ox);
  else
    luma_pass<HOR>(p, tb, list, n, s0, e0, in, acc, oy, ox);
}

template <int N> struct Step {
  static constexpr int value = N;
};

// f(Step<STEP>, shared offset, global offset) over rows [y0, y1) x
// columns [x0, x1) of the plane, in units of STEP samples, between global
// memory (row pitch W) and a shared buffer of pitch PP whose sample
// (0, 0) is the plane's (oy, ox).  Each row is walked from column xs in
// WIDTH samples known at compile time, so the index math is a multiply
// by a constant, not a division.
template <int PP, int WIDTH, int STEP, class F>
__device__ __forceinline__ void box(int W, int y0, int y1, int xs, int x0,
                                    int x1, int oy, int ox, F f) {
  constexpr int PER_ROW = WIDTH / STEP;
  const int n = (y1 - y0) * PER_ROW;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int y = y0 + i / PER_ROW, x = xs + (i % PER_ROW) * STEP;
    if (x >= x0 && x < x1)
      f(Step<STEP>(), (y - oy) * PP + x - ox, (long long)y * W + x);
  }
}

// box in 16-byte chunks (vec: W % 4 == 0, 16-byte aligned planes; x0,
// x1 and xs multiples of 4), or sample by sample
template <int PP, int WIDTH, class F>
__device__ __forceinline__ void for_box(int vec, int W, int y0, int y1,
                                        int xs, int x0, int x1, int oy,
                                        int ox, F f) {
  if (vec)
    box<PP, WIDTH, 4>(W, y0, y1, xs, x0, x1, oy, ox, f);
  else
    box<PP, WIDTH, 1>(W, y0, y1, xs, x0, x1, oy, ox, f);
}

// copy STEP samples between shared (or global) buffers
template <int STEP>
__device__ __forceinline__ void copy(int* dst, const int* src) {
  if constexpr (STEP == 4)
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  else
    *dst = *src;
}

template <bool C>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
deblock_tile_kernel(Params p) {
  using K = Kind<C>;
  using T = Tile<K>;
  constexpr int PP = T::P;
  extern __shared__ int4 smem4[];
  int* const buf0 = reinterpret_cast<int*>(smem4);
  int* const buf1 = buf0 + PP * PP;
  int* const list_v = buf1 + PP * PP;
  int* const list_h = list_v + T::LIST;
  int* const count = list_h + T::LIST;  // [0] vertical, [1] horizontal
  int* const tabs = count + 2;
  const Tabs tb{tabs, tabs + N_TC, tabs + N_TC + N_BETA,
                tabs + N_TC + N_BETA + 21, tabs + N_TC + N_BETA + 42};

  const int ch = blockIdx.z, H = p.H, W = p.W;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int oy = r0 - K::HALO, ox = c0 - K::HALO;  // buffer origin
  const int r1 = min(H, r0 + TILE), c1 = min(W, c0 + TILE);
  const int* src = p.src[ch];

  // ---- the tile and what the passes read beside it, into buf0 --------
  const int y0 = p.do_h ? max(0, r0 - K::HALO) : r0;
  const int y1 = p.do_h ? min(H, r1 + K::HALO) : r1;
  const int x0 = p.do_v ? max(0, c0 - K::HALO) : c0;
  const int x1 = p.do_v ? min(W, c1 + K::HALO) : c1;
  if (threadIdx.x < 2) count[threadIdx.x] = 0;
  // (the same walk as the copy into buf1 below: each thread copies what
  // its own cp.async brought)
  const auto load = [&](auto st, int s, long long g) {
    if constexpr (decltype(st)::value == 4)
      cp_async16(buf0 + s, src + g);
    else
      cp_async4(buf0 + s, src + g);
  };
  for_box<PP, PP>(p.vec, W, y0, y1, ox, x0, x1, oy, ox, load);
  for (int i = threadIdx.x; i < N_TABS; i += THREADS) {
    const int* t = i < N_TC ? p.tct + i
                   : i < N_TC + N_BETA ? p.betat + i - N_TC
                   : i < N_TC + N_BETA + 21 ? p.lcm + i - N_TC - N_BETA
                   : i < N_TC + N_BETA + 42 ? p.lcr + i - N_TC - N_BETA - 21
                   : p.lct + i - N_TC - N_BETA - 42;
    cp_async4(tabs + i, t);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // ---- meanwhile, the positions each pass filters -----------------------
  // horizontal pass: the segments of the tile's columns, the edges that
  // write into its rows; vertical pass: the edges that write into its
  // columns, on the rows that the horizontal pass reads (or the tile's).
  // Both passes' grid loads are in flight together.
  Cands<C> cand_v, cand_h;
  int eh1 = -1;
  if (p.do_h) {
    int eh0;
    edge_range<K>(r0, p.h.E, &eh0, &eh1);
    load_cands<C>(p, p.h, ch, c0 / K::SEG, (c1 + K::SEG - 1) / K::SEG, eh0,
                  eh1, &cand_h);
  }
  if (p.do_v) {
    int ev0, ev1, v0 = r0, v1 = r1;
    edge_range<K>(c0, p.v.E, &ev0, &ev1);
    if (p.do_h) {  // the rows the horizontal pass's windows read
      v0 = max(0, min(r0, K::G * cand_h.e0 - K::N / 2));
      v1 = min(H, max(r1, K::G * eh1 + K::N / 2));
    }
    load_cands<C>(p, p.v, ch, v0 / K::SEG, (v1 + K::SEG - 1) / K::SEG, ev0,
                  ev1, &cand_v);
  }
  __syncthreads();  // the counts are 0
  if (p.do_h) append<C>(cand_h, list_h, count + 1);
  if (p.do_v) append<C>(cand_v, list_v, count);

  // ---- buf1: a copy of buf0 on the tile's columns (the only ones either
  // pass writes and the output needs) -----------------------------------
  cp_async_wait_all();  // this thread's copies, which it copies again
  for_box<PP, PP>(p.vec, W, y0, y1, ox, max(x0, c0), min(x1, c1), oy, ox,
                  [&](auto st, int s, long long) {
                    copy<decltype(st)::value>(buf1 + s, buf0 + s);
                  });
  __syncthreads();

  // ---- the passes -------------------------------------------------------
  int* out = buf1;
  if (p.do_v) {
    run_pass<C, false>(p, tb, ch, list_v, count[0], cand_v.s0, cand_v.e0,
                       buf0, buf1, oy, ox);
    __syncthreads();
    if (p.do_h) {  // the vertical pass's result is the horizontal's input
      for_box<PP, TILE>(p.vec, W, y0, y1, c0, c0, c1, oy, ox,
                        [&](auto st, int s, long long) {
                          copy<decltype(st)::value>(buf0 + s, buf1 + s);
                        });
      __syncthreads();
      run_pass<C, true>(p, tb, ch, list_h, count[1], cand_h.s0, cand_h.e0,
                        buf1, buf0, oy, ox);
      out = buf0;
      __syncthreads();
    }
  } else {
    run_pass<C, true>(p, tb, ch, list_h, count[1], cand_h.s0, cand_h.e0,
                      buf0, buf1, oy, ox);
    __syncthreads();
  }

  // ---- the tile's samples, once ---------------------------------------
  int* dst = p.dst + (long long)ch * H * W;
  for_box<PP, TILE>(p.vec, W, r0, r1, c0, c0, c1, oy, ox,
                    [&](auto st, int s, long long g) {
                      copy<decltype(st)::value>(dst + g, out + s);
                    });
}

template <bool C>
static int launch(const Params& p, int nch, cudaStream_t stream) {
  using T = Tile<Kind<C>>;
  static unsigned configured = 0;  // per device: the attributes are set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32 && !(configured >> dev & 1)) {
    e = cudaFuncSetAttribute(deblock_tile_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(deblock_tile_kernel<C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured |= 1u << dev;
  }
  const dim3 blocks((p.W + TILE - 1) / TILE, (p.H + TILE - 1) / TILE, nch);
  deblock_tile_kernel<C><<<blocks, THREADS, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

static bool set_grids(Grids* g, const long long* ptrs, int nch, int ng,
                      int E) {
  g->E = E;
  for (int c = 0; c < nch; ++c)
    for (int k = 0; k < ng; ++k)
      if (!(g->g[c][k] = (const int*)ptrs[c * ng + k])) return false;
  return true;
}

// The vertical pass (grids_v), the horizontal pass (grids_h), or both,
// the vertical first.  src: nch (1 luma; 1 or 2 chroma: Cb and Cr)
// pointers to (H, W) int32 planes; dst: (nch, H, W) int32, written
// whole.  Per plane, bs, qp, maxp, maxq and (luma) the horizontal CTU
// edge flag, (S, E) int32 each: the vertical pass's laid out for the
// plane, S = H / (4 luma, 2 chroma) and E = W / (4 luma, 8 chroma), the
// horizontal pass's for its transpose (W for H and H for W); null for a
// pass that does not run.
extern "C" int deblock_launch(
    const long long* src, int* dst, int nch, int H, int W, int chroma,
    const long long* grids_v, int Sv, int Ev, const long long* grids_h,
    int Sh, int Eh, const int* beta_off, const int* tc_off, int bit_depth,
    const int* tct, const int* betat, const int* lcm, const int* lcr,
    const int* lct, void* stream) {
  const int seg = chroma ? 2 : 4, grid = chroma ? 8 : 4, ng = chroma ? 4 : 5;
  Params p{};
  p.do_v = grids_v != nullptr;
  p.do_h = grids_h != nullptr;
  if (nch < 1 || nch > MAX_NCH || (!chroma && nch != 1) || H < 1 || W < 1
      || bit_depth < 8 || bit_depth > 12 || !(p.do_v || p.do_h) || !dst
      || !tct || !betat || !lcm || !lcr || !lct
      || (p.do_v && (H % seg || W % grid || Sv != H / seg || Ev != W / grid
                     || !set_grids(&p.v, grids_v, nch, ng, Ev)))
      || (p.do_h && (W % seg || H % grid || Sh != W / seg || Eh != H / grid
                     || !set_grids(&p.h, grids_h, nch, ng, Eh))))
    return (int)cudaErrorInvalidValue;
  p.vec = W % 4 == 0 && ((unsigned long long)dst & 15) == 0;
  for (int c = 0; c < nch; ++c) {
    p.src[c] = (const int*)src[c];
    if (!p.src[c]) return (int)cudaErrorInvalidValue;
    p.vec = p.vec && ((unsigned long long)src[c] & 15) == 0;
    p.beta_off[c] = beta_off[c];
    p.tc_off[c] = tc_off[c];
  }
  p.dst = dst;
  p.H = H;
  p.W = W;
  p.bd = bit_depth;
  p.tct = tct;
  p.betat = betat;
  p.lcm = lcm;
  p.lcr = lcr;
  p.lct = lct;
  return chroma ? launch<true>(p, nch, (cudaStream_t)stream)
                : launch<false>(p, nch, (cudaStream_t)stream);
}

extern "C" const char* deblock_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
