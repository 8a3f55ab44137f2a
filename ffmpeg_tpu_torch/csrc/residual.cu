// The residual stage for Hopper: dequant, inverse LFNST, the inverse
// DCT2/DST7/DCT8 passes and placement of one call's TUs (the luma plane,
// or the Cb and Cr planes together), in at most three launches, one per
// work group.
//
// Replaces the JAX package's XLA residual, ffmpeg_tpu/models/vvc/
// pipeline.py:569,443,332 (_residual_from_buckets over _bucket_residuals
// and _apply_lfnst; not Pallas).  Its oracle is the plain torch version in
// ffmpeg_tpu_torch/ops/transform.py (residual_planes_plain over
// residual_plane, bucket_residuals and apply_lfnst): the same dequant
// (spec 8.7.3, vvc_intra.c:277-417), LFNST (vvc_intra.c:419-480), passes
// (vvcdsp.c:94-138), joint-CbCr and LMCS chroma scaling, bit for bit.
// Since the chroma scales are folded in, the chroma call also replaces
// the XLA `_lmcs_vpdu_scales` (pipeline.py:393) that fed it: its plain
// version applies ops/lmcs.py lmcs_vpdu_scales_plain first.
//
// Input.  TUs arrive grouped by (w, h) size class, each class a (14, ld)
// int32 row matrix (ops/transform.py BUCKET_ROWS order, ld >= n columns)
// and an (ld, zh, zw) int32 level array (zh = min(h, 32), zw = min(w, 32):
// the 64-point DCT2 keeps its low 32 coefficients).
//
// Work split (ops/transform.py work_split, from the classes' counts
// alone).  A call's classes fall into three groups by their samples, and
// each group is one launch of 128-thread blocks whose class table sits in
// the parameter block; a block finds its class by a binary search of the
// classes' first items.
//   small  (w * h <= 64: chroma 2x2 .. 8x8, luma 4x4 .. 8x8, the 1-D ISP
//          classes): 16 lanes per TU, 8 consecutive TUs per block;
//   medium (w * h <= 256): a warp per TU, 4 consecutive TUs per block;
//   large  (32x32, 16x32, 32x16 and the 64-point classes): a block per
//          band of output rows (band = min(h, 512 / w)).  Output row y
//          needs column-pass row y only, so each band recomputes its TU's
//          dequant (and LFNST) from the coded corner and needs nothing
//          from the other bands.
// In the packed groups (small, medium) lane j of a block reads row k of
// TU base + j, so the row loads coalesce; the block's TUs' levels are one
// contiguous span; the rows, the levels and the DCT2 bases are all in
// flight at once (cp.async), and the DST7/DCT8 bases follow only when a
// TU of the block uses them: the bases are staged once per block; below
// the block's barriers a TU's lanes synchronise with __syncwarp alone.
// Each launch's shared memory is sized by the largest item of its own
// group (residual_smem_ints), not by the call's largest class.  A call's
// later launches start while its earlier ones run (Overlap: programmatic
// dependent launch).  The passes sum 2 x 2 output tiles per lane, so that
// each value loaded from shared memory feeds two products.
//
// LMCS chroma scaling.  A scaled TU (a chroma call with a scale source, a
// 2-D TU of more than 4 samples) derives its VPDU's scale in its own lanes
// (lmcs_scale.cuh): its VPDU index is loaded first, each lane loads its
// share of the VPDU's left column and top row of mapped luma right after
// the block's cp.async staging is issued, so that their latency hides
// under it, and the team sums them by shuffles (the large group: the
// block, through shared memory).  In the packed groups a run of a block's
// consecutive TUs in one VPDU (a class's TUs come in decode order, so
// neighbours often share one) derives the scale once, in its first TU's
// lanes, and the others read it from shared memory after the barrier.
// The chroma residual call is the scales' only consumer, so no table of
// scales is built and no launch of its own runs; the runs that share a
// VPDU across blocks each read its 64 or 128 samples again from L2.  A
// TU that is not scaled reads no luma, and each kernel is built twice,
// with and without the scales' code (SCALED), so that a call without a
// scale source (luma) runs none of it.
//
// Bound.  Every sum is exact in int32: a basis value is at most 91, an
// input below 2^15, and a pass sums at most 32 coded terms, so
// |sum| < 32 * 91 * 2^15 < 2^27 (the LFNST's 16 terms of at most 127 stay
// below 2^26).  The plain version sums in float64 only because CUDA torch
// has no int32 matrix product; float64 is exact over these sums, so the
// two agree to the bit.  A 1080p frame needs about 0.2 G integer
// operations (6 us at the H100's int32 rate) and moves about 24 MB
// (levels, rows and planes: 7 us at 3.35 TB/s), so bytes bound it; what
// one block per TU lost was latency and idle lanes (a 4x4 TU's 16 outputs
// held 128 threads, and a 64x64 TU was one block's serial work), and what
// bounds these launches in practice is shared-memory loads and each
// launch's single wave of blocks.
//
// Integer semantics.  The C reference wraps the dequant product in int32,
// and so do the JAX and plain versions; signed overflow is undefined in
// CUDA C++, so the products (scale * m, then * level) run in uint32 and
// are cast back.  `>>` on a negative int is an arithmetic shift with nvcc,
// as the plain version's torch `>>` is; the dequant, the passes' rounding,
// the joint-CbCr halving and the LMCS scaling rely on it.
//
// Rows out of range.  Torch raises where a row indexes out of range; the
// kernel checks those rows (a transform kind outside 0..2 where the class
// uses it, `vpdu` outside the VPDU grid, `slid` past the 28 scaling
// lists, a block that leaves the plane, and a dequant shift outside
// 0..31, whose C shift would be undefined), writes nothing for such a TU,
// and ORs the failed checks into the frame's error word, which the caller
// reads before it hands the frame out (the launch does not wait for it).
// Negative kinds, VPDUs and block origins are errors too, though torch's
// indexing would wrap them.
//
// Tables.  The DCT2 bases (2..64), the DST7/DCT8 bases (4..32), the LFNST
// matrices and the LFNST scan and scatter coordinates come from
// models/vvc/vvc_tables.npz through ops/transform.py `_tables`, as one
// int32 device buffer with the offsets of each table (toff) in the
// parameter block.
//
// Build (at first use, ffmpeg_tpu_torch/ops/transform.py _get_kernel):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -o _build/libresidual.so residual.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "lmcs_scale.cuh"

#define THREADS 128
#define MAX_CLASSES 64
#define NUM_ROWS 14

// the work groups (ops/transform.py GROUPS): lanes per TU in the packed
// groups, the largest samples of a class in each, and each group's
// shared-memory budget in bytes (ops/transform.py SMEM_BUDGET)
#define G_SMALL 0
#define G_MEDIUM 1
#define G_LARGE 2
#define SMALL_LANES 16
#define MEDIUM_LANES 32
#define SMALL_MAX 64
#define MEDIUM_MAX 256
#define SMEM_SMALL 20480
#define SMEM_MEDIUM 24576
#define SMEM_LARGE 16384

// the row order of ops/transform.py BUCKET_ROWS (decode.cc BucketRow)
enum {
  R_X0, R_Y0, R_SCALE, R_SHIFT, R_SLOT, R_TRH, R_TRV, R_JOP, R_TS,
  R_LF_SEL, R_LF_TR, R_VPDU, R_SBS, R_SLID
};

// the table offsets of ops/transform.py `_tables`: the bases at
// kind * 7 + log2(n) (kind 0 DCT2, 1 DST7, 2 DCT8), then the LFNST
// matrices (8, 16, N) for N = 16 and 48, the 4x4 diagonal scan (16 rows,
// then 16 columns) and, for N = 16 and 48, the normal layout's rows and
// columns and the transposed layout's rows and columns (N each)
#define T_LFNST4 21
#define T_LFNST8 22
#define T_SCAN 23
#define T_POS4 24
#define T_POS8 25
#define NUM_TOFF 26

// the error word's bits (ops/transform.py ERRORS)
#define E_KIND 1
#define E_VPDU 2
#define E_SLID 4
#define E_PLACE 8
#define E_SHIFT 16

// A class in the parameter block.  Its small fields are 16-bit, so that
// the block (64 classes, the chroma scales' source) stays within the 4 KB
// that a launch carries inline.
struct Class {
  const int* mat;  // (14, ld) rows
  const int* lv;   // (ld, zh, zw) levels
  int n, ld;
  int first;       // the class's first item (block) in its launch
  short w, h, plane;
  short per;       // TUs per item: 8 (small), 4 (medium) or 1 (large)
  short band;      // output rows per item: h, or a large class's band
};

struct Params {
  Class cls[MAX_CLASSES];
  int n_cls;
  int* out;        // (nch, Hp, Wp), zero-filled
  int* err;        // the error word
  int Hp, Wp, bd, chroma;
  LmcsScales lm;            // the chroma scales' source (plane null: none)
  const int* sl_rec;        // (28, 8, 8) scaling lists, or null (flat)
  const int* sl_dc;         // (14,)
  const int* tab;
  int toff[NUM_TOFF];
};
static_assert(sizeof(Params) <= 4096, "the parameter block outgrew 4 KB");

__host__ __device__ __forceinline__ int ilog2i(int v) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(v);
#else
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
#endif
}

// what a class's TUs are: coded extents, which passes use a transform
// kind (DST7/DCT8 exist for 4..32, 4..16 on 1-D classes), 1-D or 2-D
struct Shape {
  int w, h, zw, zh, lw, lzw, lzh;
  bool one_d, uses_v, uses_h;
};

__host__ __device__ __forceinline__ Shape shape_of(int w, int h) {
  Shape s;
  s.w = w;
  s.h = h;
  s.zw = w < 32 ? w : 32;
  s.zh = h < 32 ? h : 32;
  s.lw = ilog2i(w);
  s.lzw = ilog2i(s.zw);
  s.lzh = ilog2i(s.zh);
  s.one_d = w == 1 || h == 1;
  const int mts = s.one_d ? 16 : 32;
  s.uses_v = (s.one_d ? w == 1 : true) && h >= 4 && h <= mts;
  s.uses_h = (s.one_d ? h == 1 : true) && w >= 4 && w <= mts;
  return s;
}

__host__ __device__ __forceinline__ int group_of(int w, int h) {
  return w * h <= SMALL_MAX ? G_SMALL
                            : (w * h <= MEDIUM_MAX ? G_MEDIUM : G_LARGE);
}

// the staged bases of a packed block: every kind of the vertical basis
// (h rows of zh coded columns) and of the horizontal one (w rows of zw),
// at a pitch of the columns + 1 (odd: the passes' strided reads fall in
// distinct banks); a side of 1 has no basis
__host__ __device__ __forceinline__ int kinds_v(const Shape& s) {
  return s.h > 1 ? (s.uses_v ? 3 : 1) : 0;
}
__host__ __device__ __forceinline__ int kinds_h(const Shape& s) {
  return s.w > 1 ? (s.uses_h ? 3 : 1) : 0;
}

// the ints of shared memory an item of class (w, h) takes in its group
// (ops/transform.py smem_bytes mirrors it): packed, per TU its levels
// (then coefficients), its column-pass rows (2-D) and its 14 rows, and
// the bases; large, the TU's coded corner, the band's column-pass rows,
// the band's rows of the vertical basis and the horizontal basis
__host__ __device__ __forceinline__ int residual_smem_ints(int group, int w,
                                                           int h, int band) {
  const Shape s = shape_of(w, h);
  if (group == G_LARGE)
    return s.zh * s.zw + band * s.zw + band * (s.zh + 1) + w * (s.zw + 1);
  const int per = THREADS / (group == G_SMALL ? SMALL_LANES : MEDIUM_LANES);
  return per * (s.zh * s.zw + (s.one_d ? 0 : h * s.zw) + NUM_ROWS) +
         kinds_v(s) * h * (s.zh + 1) + kinds_h(s) * w * (s.zw + 1);
}

__device__ __forceinline__ int clamp16(int v) {
  return min(max(v, -32768), 32767);
}

// -v with the int32 wrap of torch's negation (no undefined overflow)
__device__ __forceinline__ int neg(int v) { return (int)(0u - (unsigned)v); }

__device__ __forceinline__ const int* basis(const Params& p, int kind,
                                            int n) {
  return p.tab + p.toff[kind * 7 + ilog2i(n)];
}

// one int from global to shared memory with cp.async (4 bytes, kept in
// L1: the bases are read by every block of a class)
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// a basis's rows [r0, r0 + rows) and columns [0, 1 << lc) into shared
// memory at a pitch of the columns + 1 (odd: the passes' strided reads
// fall in distinct banks), with cp.async; completed by cp_async_wait
__device__ __forceinline__ void stage(int* dst, const int* src, int n, int r0,
                                      int rows, int lc, int tid) {
  const int cols = 1 << lc;
  for (int e = tid; e < rows << lc; e += THREADS) {
    const int r = e >> lc, c = e & (cols - 1);
    cp_async4(dst + r * (cols + 1) + c, src + (r0 + r) * n + c);
  }
}

// n ints from global to shared memory with cp.async, in 16-byte pieces
// where both ends allow it (dst is 16-byte aligned: the start of the
// dynamic shared memory); completed by cp_async_wait
__device__ __forceinline__ void copy_span(int* dst, const int* src, int n,
                                          int tid) {
  if ((((uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    for (int e = tid * 4; e < n; e += THREADS * 4) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + e);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + e));
    }
  } else {
    for (int e = tid; e < n; e += THREADS) cp_async4(dst + e, src + e);
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Programmatic dependent launch: a call's later group launches may start
// while the earlier ones run (their TUs are disjoint).  Each block lets
// the next launch start at once; one thread of the grid waits, before it
// exits, for the launch before its own to complete, so that a launch
// completes only after every earlier group of the call (and a later
// kernel of the stream sees all of them).  Outside such a launch the
// wait returns at once.
struct Overlap {
  __device__ __forceinline__ Overlap() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
  __device__ __forceinline__ ~Overlap() {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
};

// the item's class: the last whose first item is at most `item`
__device__ __forceinline__ int find_class(const Params& p, int item) {
  int lo = 0, hi = p.n_cls - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.cls[mid].first <= item)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// a class's TUs take the LMCS chroma scaling: chroma, a scale source, 2-D
// and more than 4 samples
__device__ __forceinline__ bool scaled_class(const Params& p, const Shape& s) {
  return p.chroma && p.lm.plane && !s.one_d && s.w * s.h > 4;
}

// the failed checks of one TU's rows (the error word's bits)
__device__ __forceinline__ int check_rows(const Params& p, const Shape& s,
                                          const int* row) {
  const bool scaled = scaled_class(p, s);
  int bad = 0;
  if ((s.uses_v && (unsigned)row[R_TRV] > 2u) ||
      (s.uses_h && (unsigned)row[R_TRH] > 2u))
    bad |= E_KIND;
  if (scaled && (unsigned)row[R_VPDU] >= (unsigned)(p.lm.nvx * p.lm.nvy))
    bad |= E_VPDU;
  if (p.sl_rec && row[R_SLID] > 27) bad |= E_SLID;
  const int x0 = row[R_X0], y0 = row[R_Y0];
  if (x0 < 0 || y0 < 0 || x0 > p.Wp - s.w || y0 > p.Hp - s.h) bad |= E_PLACE;
  if ((unsigned)row[R_SHIFT] > 31u) bad |= E_SHIFT;
  return bad;
}

// A chroma sample's epilogue: the joint-CbCr sign (modes 2 and 4) and
// halving (3 and 4), then the LMCS chroma residual scaling of TBs of more
// than 4 samples (scaled), on the value clamped to +-(1 << bd).
__device__ __forceinline__ int chroma_epilogue(int v, int jop, bool scaled,
                                               int sc, int bd) {
  if (jop != 0) {
    const int sg = (jop == 2 || jop == 4) ? neg(v) : v;
    v = jop >= 3 ? sg >> 1 : sg;
  }
  if (scaled) {
    const int lim = 1 << bd;
    const int c = min(max(v, -lim), lim - 1);
    const int mag = (int)((unsigned)abs(c) * (unsigned)sc + (1u << 10)) >> 11;
    v = c < 0 ? neg(mag) : mag;
  }
  return v;
}

// The G threads that work on one TU: 16 or 32 lanes of a warp, or the
// whole block (a large group's band).
template <int G>
struct Team {
  int lane;        // rank in the team
  unsigned mask;   // the team's lanes in their warp (G < THREADS)
  __device__ __forceinline__ void sync() const {
    if (G == THREADS)
      __syncthreads();
    else
      __syncwarp(mask);
  }
  // the sum of v over the team's lanes (G < THREADS), in every lane
  __device__ __forceinline__ unsigned sum(unsigned v) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
    return v;
  }
};

// One TU's output rows [r0, r1), by its team: dequant of the coded corner
// in place over its levels in coef, the inverse LFNST, the passes, the
// chroma epilogue, the samples written into the plane.  bv: the vertical
// basis of the TU's kind, output row y's row at (y - r0) * pv, pv = zh + 1;
// bh: the horizontal basis of its kind, output column x's row at x * ph,
// ph = zw + 1; tmp: (r1 - r0) x zw; sc: the TU's LMCS chroma scale, where
// its class is scaled (SCALED: the call has a scale source).
template <int G, bool SCALED>
__device__ __forceinline__ void tu_rows(const Params& p, const Team<G>& tm,
                                        const Shape& s, const int* row,
                                        int plane, int* coef, int* tmp,
                                        const int* bv, const int* bh, int r0,
                                        int r1, int sc) {
  const int lane = tm.lane, area = s.zh * s.zw;
  const int pv = s.zh + 1, ph = s.zw + 1;

  // 1. dequant: (level * scale16 + off) >> shift, clamped to 16 bits, 0
  // where the level is 0; scale16 = scale * m, m the scaling list's factor
  // (the TU's 8x8 list upsampled by index shifts, its DC for ids >= 14) or
  // the flat 16
  const int sh = row[R_SHIFT], slid = row[R_SLID];
  const unsigned scale = (unsigned)row[R_SCALE];
  const unsigned off = (unsigned)((int)(1u << sh) >> 1);  // arithmetic >>
  const bool flat = p.sl_rec == nullptr || slid < 0;
  const int mx = max(s.w, s.h);
  const int l2m = mx == 2 ? 1 : (mx == 4 ? 2 : 3);
  const int lh = ilog2i(s.h);
  for (int e = lane; e < area; e += G) {
    const int level = coef[e];
    unsigned m = 16;
    if (!flat) {
      const int y = e >> s.lzw, x = e & (s.zw - 1);
      const int iy = min((y << l2m) >> lh, (1 << l2m) - 1);
      const int ix = min((x << l2m) >> s.lw, (1 << l2m) - 1);
      m = (unsigned)__ldg(p.sl_rec + slid * 64 + iy * 8 + ix);
      if (mx >= 16 && slid >= 14 && e == 0)
        m = (unsigned)__ldg(p.sl_dc + slid - 14);
    }
    const int d = (int)((unsigned)level * (scale * m) + off) >> sh;
    coef[e] = level == 0 ? 0 : clamp16(d);
  }
  tm.sync();

  // 2. the inverse LFNST (luma TBs of at least 4x4 with lf_sel >= 0): the
  // 16 scanned inputs times the set's 16 x N matrix, rounded and clamped,
  // held in registers, then scattered in the normal or transposed layout
  // over the zeroed block
  if (!p.chroma && s.w >= 4 && s.h >= 4 && row[R_LF_SEL] >= 0) {
    const bool big = s.w >= 8 && s.h >= 8;
    const int N = big ? 48 : 16;
    const int sel = min(max(row[R_LF_SEL], 0), 7);
    const int* M = p.tab + p.toff[big ? T_LFNST8 : T_LFNST4] + sel * 16 * N;
    const int* scan = p.tab + p.toff[T_SCAN];
    constexpr int NV = (48 + G - 1) / G;
    int v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int o = j * G + lane;
      int acc = 0;
      if (o < N)
        for (int k = 0; k < 16; ++k)
          acc += coef[__ldg(scan + k) * s.zw + __ldg(scan + 16 + k)] *
                 __ldg(M + k * N + o);
      v[j] = clamp16((acc + 64) >> 7);
    }
    tm.sync();
    for (int e = lane; e < area; e += G) coef[e] = 0;
    tm.sync();
    const int* pos = p.tab + p.toff[big ? T_POS8 : T_POS4] +
                     (row[R_LF_TR] > 0 ? 2 * N : 0);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int o = j * G + lane;
      if (o < N) coef[__ldg(pos + o) * s.zw + __ldg(pos + N + o)] = v[j];
    }
    tm.sync();
  }

  // transform skip, where the class is not zeroed out: the dequantized
  // levels are the residual
  const bool ts = row[R_TS] > 0 && s.zw == s.w && s.zh == s.h;
  int* out = p.out + ((size_t)plane * p.Hp + row[R_Y0]) * p.Wp + row[R_X0];

  // 3a. 1-D classes (ISP sub-partitions, packed groups only): one pass,
  // shift 6 + 15 - bd, no intermediate clip; DST7/DCT8 for 4..16, else
  // DCT2
  if (s.one_d) {
    const bool hor = s.h == 1;
    const int n1 = hor ? s.w : s.h, z1 = hor ? s.zw : s.zh;
    const int* B = hor ? bh : bv;
    const int pb = hor ? ph : pv;
    const int shift1 = 6 + 15 - p.bd;
    for (int e = lane; e < n1; e += G) {
      int v = coef[e];
      if (!ts) {
        int acc = 0;
        for (int k = 0; k < z1; ++k) acc += B[e * pb + k] * coef[k];
        v = (acc + (1 << (shift1 - 1))) >> shift1;
      }
      out[hor ? e : (size_t)e * p.Wp] = v;
    }
    return;
  }

  // 3b. 2-D classes: the column pass (the vertical basis over the zh coded
  // rows) of rows [r0, r1) into tmp, rounded by 7 and clamped to 16 bits,
  // then the row pass (the horizontal basis over the zw coded columns),
  // shift 5 + 15 - bd, and the chroma epilogue.  Each lane sums a tile of
  // 2 x 2 outputs, so that every value it loads from shared memory feeds
  // two products (and the rows of coef and tmp load as int2): the passes
  // are bound by shared-memory loads, not by the integer multiply-adds.
  const int band = r1 - r0;
  const int shift2 = 5 + 15 - p.bd;
  const bool scaled = SCALED && scaled_class(p, s);
  int* orow = out + (size_t)r0 * p.Wp;
  if (ts) {
    for (int e = lane; e < band * s.w; e += G) {
      int v = coef[r0 * s.w + e];  // zw == w
      if (p.chroma) v = chroma_epilogue(v, row[R_JOP], scaled, sc, p.bd);
      orow[(size_t)(e >> s.lw) * p.Wp + (e & (s.w - 1))] = v;
    }
    return;
  }
  {
    const int lt = s.lzw - 1;  // tiles per row: zw / 2
    for (int t = lane; t < (band >> 1) << lt; t += G) {
      const int yy = (t >> lt) << 1, x = (t & ((1 << lt) - 1)) << 1;
      const int* a0 = bv + yy * pv;
      const int* a1 = a0 + pv;
      int s00 = 0, s01 = 0, s10 = 0, s11 = 0;
#pragma unroll 4
      for (int k = 0; k < s.zh; ++k) {
        const int2 c = *reinterpret_cast<const int2*>(coef + (k << s.lzw) + x);
        const int u0 = a0[k], u1 = a1[k];
        s00 += u0 * c.x;
        s01 += u0 * c.y;
        s10 += u1 * c.x;
        s11 += u1 * c.y;
      }
      int* o = tmp + yy * s.zw + x;
      o[0] = clamp16((s00 + 64) >> 7);
      o[1] = clamp16((s01 + 64) >> 7);
      o[s.zw] = clamp16((s10 + 64) >> 7);
      o[s.zw + 1] = clamp16((s11 + 64) >> 7);
    }
    tm.sync();
  }
  const int lt = s.lw - 1;  // tiles per row: w / 2
  for (int t = lane; t < (band >> 1) << lt; t += G) {
    const int yy = (t >> lt) << 1, x = (t & ((1 << lt) - 1)) << 1;
    const int* a0 = tmp + yy * s.zw;
    const int* a1 = a0 + s.zw;
    const int* b0 = bh + x * ph;
    const int* b1 = b0 + ph;
    int acc[4] = {0, 0, 0, 0};  // (yy, x), (yy, x + 1), (yy + 1, x), ...
#pragma unroll 2
    for (int k = 0; k < s.zw; k += 2) {
      const int2 u0 = *reinterpret_cast<const int2*>(a0 + k);
      const int2 u1 = *reinterpret_cast<const int2*>(a1 + k);
      const int v00 = b0[k], v01 = b0[k + 1], v10 = b1[k], v11 = b1[k + 1];
      acc[0] += u0.x * v00 + u0.y * v01;
      acc[1] += u0.x * v10 + u0.y * v11;
      acc[2] += u1.x * v00 + u1.y * v01;
      acc[3] += u1.x * v10 + u1.y * v11;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int v = (acc[q] + (1 << (shift2 - 1))) >> shift2;
      if (p.chroma) v = chroma_epilogue(v, row[R_JOP], scaled, sc, p.bd);
      orow[(size_t)(yy + (q >> 1)) * p.Wp + x + (q & 1)] = v;
    }
  }
}

// The packed groups: block `item` of a class runs its TUs [i0, i0 + cnt),
// G lanes each.  SCALED: the call has a chroma scales' source (the other
// instance holds no code of the scales).  The scaled instances leave
// ptxas free to use more registers (a block per SM is all they ask), which
// ran the chroma call faster on the card than a cap that keeps 10 blocks
// an SM; the others keep the cap (48 registers), which luma ran fastest
// with (PERF.md).
template <int G, bool SCALED>
__global__ void __launch_bounds__(THREADS, SCALED ? 1 : 10)
    packed_kernel(const __grid_constant__ Params p) {
  constexpr int T = THREADS / G;
  extern __shared__ __align__(16) int sm[];
  const Overlap overlap;
  const int item = blockIdx.x, tid = threadIdx.x;
  const Class& C = p.cls[find_class(p, item)];
  const Shape s = shape_of(C.w, C.h);
  const int i0 = (item - C.first) * T;
  const int cnt = min(T, C.n - i0);
  const int area = s.zh * s.zw;
  int* coef = sm;                                 // T x area
  int* tmp = coef + T * area;                     // T x h x zw (2-D)
  int* rows = tmp + (s.one_d ? 0 : T * s.h * s.zw);  // T x NUM_ROWS
  int* bv = rows + T * NUM_ROWS;                  // kinds x h x (zh + 1)
  const int kv = kinds_v(s), kh = kinds_h(s);
  int* bh = bv + kv * s.h * (s.zh + 1);           // kinds x w x (zw + 1)
  // a scaled TU's VPDU index first, so that it is in by the time the
  // copies below are issued and its luma loads follow at once: lane k < T
  // of each TU's team loads TU k's
  const int t = tid / G, lane = tid % G;
  const unsigned mask = G == 32 ? 0xffffffffu : 0xffffu << (tid & 16);
  const bool scaled = SCALED && scaled_class(p, s);
  const int vk = scaled && t < cnt && lane < cnt
                     ? __ldg(C.mat + (size_t)R_VPDU * C.ld + i0 + lane)
                     : -1;

  // the TUs' rows, their levels (one span) and the DCT2 bases in flight
  // at once; the DST7 and DCT8 bases then only if one of the block's TUs
  // uses them
  for (int e = tid; e < NUM_ROWS * cnt; e += THREADS) {
    const int k = e / cnt, j = e - k * cnt;
    cp_async4(rows + j * NUM_ROWS + k, C.mat + (size_t)k * C.ld + i0 + j);
  }
  copy_span(coef, C.lv + (size_t)i0 * area, cnt * area, tid);
  if (kv) stage(bv, basis(p, 0, s.h), s.h, 0, s.h, s.lzh, tid);
  if (kh) stage(bh, basis(p, 0, s.w), s.w, 0, s.w, s.lzw, tid);
  // a run of the block's TUs in one VPDU (consecutive TUs of a class are
  // often neighbours) derives its scale once, in its first TU's lanes,
  // while the copies fly; every TU of the run reads it after the barrier
  __shared__ int luma_scale[T];
  int first = t;
  if (scaled && t < cnt) {
    const int vpdu = __shfl_sync(mask, vk, t, G);
    while (first > 0 && __shfl_sync(mask, vk, first - 1, G) == vpdu) --first;
    if (first == t) {
      const Vpdu u = vpdu_at(p.lm, vpdu);
      const unsigned total =
          Team<G>{lane, mask}.sum(vpdu_partial<G>(p.lm, u, lane));
      if (lane == 0) luma_scale[t] = vpdu_scale(p.lm, u, total, p.bd);
    }
  }
  cp_async_wait();
  __syncthreads();
  bool mts = false;
  if (tid < cnt) {
    const int* r = rows + tid * NUM_ROWS;
    mts = (kv > 1 && r[R_TRV] != 0) || (kh > 1 && r[R_TRH] != 0);
  }
  if (__syncthreads_or(mts)) {
    for (int q = 1; q < kv; ++q)
      stage(bv + q * s.h * (s.zh + 1), basis(p, q, s.h), s.h, 0, s.h, s.lzh,
            tid);
    for (int q = 1; q < kh; ++q)
      stage(bh + q * s.w * (s.zw + 1), basis(p, q, s.w), s.w, 0, s.w, s.lzw,
            tid);
    cp_async_wait();
    __syncthreads();
  }

  // from here on each TU's lanes alone: no block barrier
  if (t >= cnt) return;
  const int* row = rows + t * NUM_ROWS;
  const int bad = check_rows(p, s, row);
  if (bad) {
    if (lane == 0) atomicOr(p.err, bad);
    return;
  }
  const Team<G> tm{lane, mask};
  const int* bvk = bv + (s.uses_v ? row[R_TRV] : 0) * s.h * (s.zh + 1);
  const int* bhk = bh + (s.uses_h ? row[R_TRH] : 0) * s.w * (s.zw + 1);
  const int sc = scaled ? luma_scale[first] : 0;
  tu_rows<G, SCALED>(p, tm, s, row, C.plane, coef + t * area,
                     tmp + t * s.h * s.zw, bvk, bhk, 0, s.h, sc);
}

// The large group: block `item` runs one band of output rows of one TU,
// recomputing the TU's dequant (and LFNST) from its coded corner.
// SCALED: as in packed_kernel.
template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
    band_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) int sm[];
  __shared__ int row[NUM_ROWS];
  __shared__ unsigned luma_sum[THREADS / 32];
  const Overlap overlap;
  const int item = blockIdx.x, tid = threadIdx.x;
  const Class& C = p.cls[find_class(p, item)];
  const Shape s = shape_of(C.w, C.h);
  const int nb = s.h / C.band, local = item - C.first;
  const int i = local / nb, r0 = (local - i * nb) * C.band;
  const int area = s.zh * s.zw;
  int* coef = sm;                      // zh x zw
  int* tmp = coef + area;              // band x zw
  int* bv = tmp + C.band * s.zw;       // band x (zh + 1)
  int* bh = bv + C.band * (s.zh + 1);  // w x (zw + 1)

  // a scaled TU's VPDU index first (as in packed_kernel)
  const bool scaled = SCALED && scaled_class(p, s);
  const int vpdu = scaled ? __ldg(C.mat + (size_t)R_VPDU * C.ld + i) : -1;

  // the levels and the DCT2 bases in flight while the rows load; a TU of
  // another kind then restages its bases
  copy_span(coef, C.lv + (size_t)i * area, area, tid);
  stage(bv, basis(p, 0, s.h), s.h, r0, C.band, s.lzh, tid);
  stage(bh, basis(p, 0, s.w), s.w, 0, s.w, s.lzw, tid);
  if (tid < NUM_ROWS) row[tid] = __ldg(C.mat + (size_t)tid * C.ld + i);
  // a scaled TU's VPDU luma, a sample a thread, summed by warp
  Vpdu u{0, 0, false, false};
  if (scaled) {
    u = vpdu_at(p.lm, vpdu);
    const unsigned part = __reduce_add_sync(
        0xffffffffu, vpdu_partial<THREADS>(p.lm, u, tid));
    if ((tid & 31) == 0) luma_sum[tid >> 5] = part;
  }
  __syncthreads();
  const int bad = check_rows(p, s, row);
  if (bad) {
    if (tid == 0 && r0 == 0) atomicOr(p.err, bad);
    cp_async_wait();
    return;
  }
  const int qv = s.uses_v ? row[R_TRV] : 0, qh = s.uses_h ? row[R_TRH] : 0;
  if (qv || qh) {
    cp_async_wait();
    __syncthreads();
    if (qv) stage(bv, basis(p, qv, s.h), s.h, r0, C.band, s.lzh, tid);
    if (qh) stage(bh, basis(p, qh, s.w), s.w, 0, s.w, s.lzw, tid);
  }
  cp_async_wait();
  __syncthreads();
  int sc = 0;
  if (scaled) {
    unsigned total = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) total += luma_sum[k];
    sc = vpdu_scale(p.lm, u, total, p.bd);
  }
  const Team<THREADS> tm{tid, 0u};
  tu_rows<THREADS, SCALED>(p, tm, s, row, C.plane, coef, tmp, bv, bh, r0,
                           r0 + C.band, sc);
}

// the kernel of a work group, with or without the chroma scales' code
static const void* kernel_of(int group, bool scaled) {
  static const void* const fns[3][2] = {
      {(const void*)packed_kernel<SMALL_LANES, false>,
       (const void*)packed_kernel<SMALL_LANES, true>},
      {(const void*)packed_kernel<MEDIUM_LANES, false>,
       (const void*)packed_kernel<MEDIUM_LANES, true>},
      {(const void*)band_kernel<false>, (const void*)band_kernel<true>}};
  return fns[group][scaled];
}

// One launch of one work group of a call; after: another group of the
// call was launched just before on the stream, and this launch may start
// while it runs (Overlap).  cls: a host array of n_cls
// classes of the group, 10 values each (mat pointer, levels pointer, w,
// h, n, ld, plane, first item, TUs per item, rows per item), none empty,
// their items numbered in order from 0 to items - 1; smem: the launch's
// dynamic shared memory in bytes, at least every class's need and at most
// the group's budget; out: the zero-filled (nch, Hp, Wp) planes; err: the
// error word; the chroma scales' source (a chroma call's, or a null
// lm_plane): the (lm_h, lm_w) mapped luma picture at lm_plane, row stride
// lm_pitch, the VPDU edge vsz, the host table inv_host (lm_tab, n_tab)
// and the interior tile boundaries bx, by (set_lmcs_scales); sl_rec +
// sl_dc: device arrays or null; tab + toff: the tables and their offsets.
// Returns a cudaError_t, without launching anything when the table or the
// scale source is malformed.
extern "C" int residual_launch(int group, int after, const long long* cls,
                               int n_cls, int items, int smem, int* out,
                               int* err,
                               int nch, int Hp, int Wp, int bd, int chroma,
                               const int* lm_plane, long long lm_pitch,
                               int lm_w, int lm_h, int vsz, const int* lm_tab,
                               int n_tab, const int* bx, int n_bx,
                               const int* by, int n_by,
                               const int* sl_rec, const int* sl_dc,
                               const int* tab, const int* toff, int n_toff,
                               void* stream) {
  static const int budget[3] = {SMEM_SMALL, SMEM_MEDIUM, SMEM_LARGE};
  if (group < G_SMALL || group > G_LARGE || n_cls < 1 ||
      n_cls > MAX_CLASSES || items < 1 || smem < 0 || smem > budget[group] ||
      n_toff != NUM_TOFF || nch < 1 || Hp < 1 || Wp < 1 || bd < 8 ||
      bd > 12 || !out || !err || !tab || (lm_plane && !chroma) ||
      (!sl_rec != !sl_dc))
    return (int)cudaErrorInvalidValue;
  Params p{};
  if (!set_lmcs_scales(&p.lm, lm_plane, lm_pitch, lm_w, lm_h, vsz, lm_tab,
                       n_tab, bx, n_bx, by, n_by))
    return (int)cudaErrorInvalidValue;
  long long total = 0;
  const int per = group == G_LARGE
                      ? 1
                      : THREADS / (group == G_SMALL ? SMALL_LANES
                                                    : MEDIUM_LANES);
  for (int c = 0; c < n_cls; ++c) {
    const long long* v = cls + 10 * c;
    Class& k = p.cls[c];
    k.mat = (const int*)v[0];
    k.lv = (const int*)v[1];
    // the 16-bit fields: sides, plane, TUs and rows per item up to 64
    const int narrow[5] = {2, 3, 6, 8, 9};
    for (int j = 0; j < 5; ++j)
      if (v[narrow[j]] < 0 || v[narrow[j]] > 64)
        return (int)cudaErrorInvalidValue;
    k.w = (short)v[2];
    k.h = (short)v[3];
    k.n = (int)v[4];
    k.ld = (int)v[5];
    k.plane = (short)v[6];
    k.first = (int)v[7];
    k.per = (short)v[8];
    k.band = (short)v[9];
    const bool pow2 = k.w > 0 && k.h > 0 && !(k.w & (k.w - 1)) &&
                      !(k.h & (k.h - 1));
    if (!pow2 || k.w > 64 || k.h > 64 || k.w * k.h < 2 || k.n < 1 ||
        k.ld < k.n || k.plane < 0 || k.plane >= nch || !k.mat || !k.lv ||
        group_of(k.w, k.h) != group || k.per != per || k.first != total ||
        k.band < 1 || k.h % k.band ||
        (group != G_LARGE && k.band != k.h) ||
        residual_smem_ints(group, k.w, k.h, k.band) * (int)sizeof(int) >
            smem)
      return (int)cudaErrorInvalidValue;
    total += group == G_LARGE ? (long long)k.n * (k.h / k.band)
                              : (k.n + per - 1) / per;
  }
  if (total != items) return (int)cudaErrorInvalidValue;
  p.n_cls = n_cls;
  p.out = out;
  p.err = err;
  p.Hp = Hp;
  p.Wp = Wp;
  p.bd = bd;
  p.chroma = chroma;
  p.sl_rec = sl_rec;
  p.sl_dc = sl_dc;
  p.tab = tab;
  for (int k = 0; k < NUM_TOFF; ++k) p.toff[k] = toff[k];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after ? 1 : 0;
  void* args[] = {&p};
  const cudaError_t e =
      cudaLaunchKernelExC(&cfg, kernel_of(group, lm_plane != nullptr), args);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The resident blocks per SM of a group's kernel (with the chroma scales
// where scaled) at `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
extern "C" int residual_occupancy(int group, int scaled, int smem) {
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_of(group, scaled), THREADS, smem);
  return e == cudaSuccess ? n : -1;
}

extern "C" const char* residual_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
