// The residual stage for Hopper: dequant, inverse LFNST, the inverse
// DCT2/DST7/DCT8 passes and placement, over every size class of one call
// in one launch: the luma plane, or the Cb and Cr planes together.
//
// Replaces the JAX package's XLA residual, ffmpeg_tpu/models/vvc/
// pipeline.py:569,443,332 (_residual_from_buckets over _bucket_residuals
// and _apply_lfnst; not Pallas).  Its oracle is the plain torch version in
// ffmpeg_tpu_torch/ops/transform.py (residual_planes_plain over
// residual_plane, bucket_residuals and apply_lfnst): the same dequant
// (spec 8.7.3, vvc_intra.c:277-417), LFNST (vvc_intra.c:419-480), passes
// (vvcdsp.c:94-138), joint-CbCr and LMCS chroma scaling, bit for bit.
//
// Work.  TUs arrive grouped by (w, h) size class, each class a (14, ld)
// int32 row matrix (ops/transform.py BUCKET_ROWS order, ld >= n columns)
// and an (ld, zh, zw) int32 level array (zh = min(h, 32), zw = min(w, 32):
// the 64-point DCT2 keeps its low 32 coefficients).  The host passes a
// table of the call's non-empty classes in the parameter block; block t
// of the grid owns the t-th TU of the call, and finds its class by the
// classes' running counts.  The block reads the TU's 14 rows, checks the
// ones that index a table or the plane, dequantizes the coded levels into
// shared memory, applies the LFNST there, runs the column pass into a
// shared tmp and then the row pass, and writes the w x h result, with the
// chroma epilogue, straight into its place in a zero-filled plane (TUs
// never overlap).
//
// Bound.  Every sum is exact in int32: a basis value is at most 91, an
// input below 2^15, and a pass sums at most 32 coded terms, so
// |sum| < 32 * 91 * 2^15 < 2^27 (the LFNST's 16 terms of at most 127 stay
// below 2^26).  The plain version sums in float64 only because CUDA torch
// has no int32 matrix product; float64 is exact over these sums, so the
// two agree to the bit.  The levels, the rows and the planes are the bytes
// that must move; the products are a few tens of millions of integer
// operations a 1080p frame, far below the operation bound.
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
// uses it, `vpdu` outside the chroma scales, `slid` past the 28 scaling
// lists, a block that leaves the plane, and a dequant shift outside
// 0..31, whose C shift would be undefined), writes nothing for such a TU,
// and ORs the failed checks into an error word, which the wrapper reads
// and raises on.  Negative kinds, VPDUs and block origins are errors too,
// though torch's indexing would wrap them.
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

#define THREADS 128
#define MAX_CLASSES 64
#define NUM_ROWS 14

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

struct Class {
  const int* mat;  // (14, ld) rows
  const int* lv;   // (ld, zh, zw) levels
  int w, h, n, ld, plane, first;
};

struct Params {
  Class cls[MAX_CLASSES];
  int n_cls, total;
  int* out;        // (nch, Hp, Wp), zero-filled
  int* err;        // the error word
  int Hp, Wp, bd, chroma;
  const int* chroma_scale;  // per-VPDU LMCS scales, or null
  int n_scale;
  const int* sl_rec;        // (28, 8, 8) scaling lists, or null (flat)
  const int* sl_dc;         // (14,)
  const int* tab;
  int toff[NUM_TOFF];
};

__device__ __forceinline__ int clamp16(int v) {
  return min(max(v, -32768), 32767);
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// -v with the int32 wrap of torch's negation (no undefined overflow)
__device__ __forceinline__ int neg(int v) { return (int)(0u - (unsigned)v); }

__device__ __forceinline__ const int* basis(const Params& p, int kind,
                                            int n) {
  return p.tab + p.toff[kind * 7 + ilog2(n)];
}

// a basis's rows [0, rows) and columns [0, cols) into shared memory at a
// pitch of cols + 1 (odd: the passes' strided reads fall in distinct
// banks)
__device__ __forceinline__ void stage(int* dst, const int* src, int n,
                                      int rows, int cols, int tid, int nt) {
  for (int e = tid; e < rows * cols; e += nt) {
    const int r = e / cols, c = e - r * cols;
    dst[r * (cols + 1) + c] = __ldg(src + r * n + c);
  }
}

__global__ void __launch_bounds__(THREADS)
    residual_kernel(const __grid_constant__ Params p) {
  extern __shared__ int sm[];
  __shared__ int row[NUM_ROWS];
  __shared__ int lf[48];
  const int t = blockIdx.x;
  if (t >= p.total) return;  // an empty call's one block
  const int tid = threadIdx.x, nt = blockDim.x;
  int ci = 0;
  while (ci + 1 < p.n_cls && t >= p.cls[ci + 1].first) ++ci;
  const Class& C = p.cls[ci];
  const int w = C.w, h = C.h, i = t - C.first;
  const int zw = min(w, 32), zh = min(h, 32);
  const int lw = ilog2(w), lh = ilog2(h), lzw = ilog2(zw);
  for (int k = tid; k < NUM_ROWS; k += nt) row[k] = __ldg(C.mat + k * C.ld + i);
  __syncthreads();

  // the checks, the same on every thread of the block
  const bool one_d = w == 1 || h == 1;
  const int mts = one_d ? 16 : 32;
  const bool uses_v = (one_d ? w == 1 : true) && h >= 4 && h <= mts;
  const bool uses_h = (one_d ? h == 1 : true) && w >= 4 && w <= mts;
  const bool scaled = p.chroma && p.chroma_scale && !one_d && w * h > 4;
  const int x0 = row[R_X0], y0 = row[R_Y0], sh = row[R_SHIFT];
  const int slid = row[R_SLID], vpdu = row[R_VPDU];
  int bad = 0;
  if ((uses_v && (unsigned)row[R_TRV] > 2u) ||
      (uses_h && (unsigned)row[R_TRH] > 2u))
    bad |= E_KIND;
  if (scaled && (unsigned)vpdu >= (unsigned)p.n_scale) bad |= E_VPDU;
  if (p.sl_rec && slid > 27) bad |= E_SLID;
  if (x0 < 0 || y0 < 0 || x0 > p.Wp - w || y0 > p.Hp - h) bad |= E_PLACE;
  if ((unsigned)sh > 31u) bad |= E_SHIFT;
  if (bad) {
    if (tid == 0) atomicOr(p.err, bad);
    return;
  }

  // 1. dequant: (level * scale16 + off) >> shift, clamped to 16 bits, 0
  // where the level is 0; scale16 = scale * m, m the scaling list's factor
  // (the TU's 8x8 list upsampled by index shifts, its DC for ids >= 14) or
  // the flat 16
  int* coef = sm;                 // zh x zw
  const unsigned scale = (unsigned)row[R_SCALE];
  const unsigned off = (unsigned)((int)(1u << sh) >> 1);  // arithmetic >>
  const bool flat = p.sl_rec == nullptr || slid < 0;
  const int mx = max(w, h);
  const int l2m = mx == 2 ? 1 : (mx == 4 ? 2 : 3);
  const int* lv = C.lv + (size_t)i * zh * zw;
  for (int e = tid; e < zh * zw; e += nt) {
    const int y = e >> lzw, x = e & (zw - 1);
    const int level = __ldg(lv + e);
    unsigned m = 16;
    if (!flat) {
      const int iy = min((y << l2m) >> lh, (1 << l2m) - 1);
      const int ix = min((x << l2m) >> lw, (1 << l2m) - 1);
      m = (unsigned)__ldg(p.sl_rec + slid * 64 + iy * 8 + ix);
      if (mx >= 16 && slid >= 14 && e == 0)
        m = (unsigned)__ldg(p.sl_dc + slid - 14);
    }
    const int d = (int)((unsigned)level * (scale * m) + off) >> sh;
    coef[e] = level == 0 ? 0 : clamp16(d);
  }
  __syncthreads();

  // 2. the inverse LFNST (luma TBs of at least 4x4 with lf_sel >= 0): the
  // 16 scanned inputs times the set's 16 x N matrix, rounded and clamped,
  // scattered in the normal or transposed layout over a zeroed block
  if (!p.chroma && w >= 4 && h >= 4 && row[R_LF_SEL] >= 0) {
    const bool big = w >= 8 && h >= 8;
    const int N = big ? 48 : 16;
    const int sel = min(max(row[R_LF_SEL], 0), 7);
    const int* M = p.tab + p.toff[big ? T_LFNST8 : T_LFNST4] + sel * 16 * N;
    const int* scan = p.tab + p.toff[T_SCAN];
    for (int o = tid; o < N; o += nt) {
      int s = 0;
      for (int k = 0; k < 16; ++k)
        s += coef[__ldg(scan + k) * zw + __ldg(scan + 16 + k)] *
             __ldg(M + k * N + o);
      lf[o] = clamp16((s + 64) >> 7);
    }
    __syncthreads();
    for (int e = tid; e < zh * zw; e += nt) coef[e] = 0;
    __syncthreads();
    const int* pos = p.tab + p.toff[big ? T_POS8 : T_POS4] +
                     (row[R_LF_TR] > 0 ? 2 * N : 0);
    for (int o = tid; o < N; o += nt)
      coef[__ldg(pos + o) * zw + __ldg(pos + N + o)] = lf[o];
    __syncthreads();
  }

  // transform skip, where the class is not zeroed out: the dequantized
  // levels are the residual
  const bool ts = row[R_TS] > 0 && zw == w && zh == h;
  int* out = p.out + ((size_t)C.plane * p.Hp + y0) * p.Wp + x0;

  // 3a. 1-D classes (ISP sub-partitions): one pass, shift 6 + 15 - bd, no
  // intermediate clip; DST7/DCT8 for 4..16, else DCT2
  if (one_d) {
    const int n1 = h == 1 ? w : h, z1 = h == 1 ? zw : zh;
    const int* B = basis(p, (h == 1 ? uses_h : uses_v)
                                ? row[h == 1 ? R_TRH : R_TRV] : 0, n1);
    const int shift1 = 6 + 15 - p.bd;
    for (int e = tid; e < n1; e += nt) {
      int v = coef[e];
      if (!ts) {
        int s = 0;
        for (int k = 0; k < z1; ++k) s += __ldg(B + e * n1 + k) * coef[k];
        v = (s + (1 << (shift1 - 1))) >> shift1;
      }
      out[h == 1 ? e : (size_t)e * p.Wp] = v;
    }
    return;
  }

  // 3b. 2-D classes: the column pass (the vertical basis over the zh coded
  // rows) into tmp, rounded by 7 and clamped to 16 bits, then the row pass
  // (the horizontal basis over the zw coded columns), shift 5 + 15 - bd
  int* tmp = coef + zh * zw;      // h x zw
  int* bv = tmp + h * zw;         // h x (zh + 1)
  int* bh = bv + h * (zh + 1);    // w x (zw + 1)
  if (!ts) {
    stage(bv, basis(p, uses_v ? row[R_TRV] : 0, h), h, h, zh, tid, nt);
    stage(bh, basis(p, uses_h ? row[R_TRH] : 0, w), w, w, zw, tid, nt);
    __syncthreads();
    for (int e = tid; e < h * zw; e += nt) {
      const int y = e >> lzw, x = e & (zw - 1);
      const int* b = bv + y * (zh + 1);
      int s = 0;
      for (int k = 0; k < zh; ++k) s += b[k] * coef[k * zw + x];
      tmp[e] = clamp16((s + 64) >> 7);
    }
    __syncthreads();
  }
  const int shift2 = 5 + 15 - p.bd;
  const int jop = row[R_JOP];
  const int sc = scaled ? __ldg(p.chroma_scale + vpdu) : 0;
  const int lim = 1 << p.bd;
  for (int e = tid; e < h * w; e += nt) {
    const int y = e >> lw, x = e & (w - 1);
    int v;
    if (ts) {
      v = coef[e];                // zw == w
    } else {
      const int* a = tmp + y * zw;
      const int* b = bh + x * (zw + 1);
      int s = 0;
      for (int k = 0; k < zw; ++k) s += a[k] * b[k];
      v = (s + (1 << (shift2 - 1))) >> shift2;
    }
    if (p.chroma) {
      // joint CbCr: the sign (modes 2 and 4) and the halving (3 and 4)
      if (jop != 0) {
        const int sg = (jop == 2 || jop == 4) ? neg(v) : v;
        v = jop >= 3 ? sg >> 1 : sg;
      }
      // LMCS chroma residual scaling of TBs of more than 4 samples, on
      // the value clamped to +-(1 << bd)
      if (scaled) {
        const int c = min(max(v, -lim), lim - 1);
        const int mag =
            (int)((unsigned)abs(c) * (unsigned)sc + (1u << 10)) >> 11;
        v = c < 0 ? neg(mag) : mag;
      }
    }
    out[(size_t)y * p.Wp + x] = v;
  }
}

// One launch over the classes of one call.  cls: a host array of n_cls
// classes, 7 values each (mat pointer, levels pointer, w, h, n, ld,
// plane), none empty; out: the zero-filled (nch, Hp, Wp) planes; err:
// one zeroed int; chroma_scale / sl_rec + sl_dc: device arrays or null;
// tab + toff: the tables and their offsets.
extern "C" int residual_launch(const long long* cls, int n_cls, int* out,
                               int* err, int nch, int Hp, int Wp, int bd,
                               int chroma, const int* chroma_scale,
                               int n_scale, const int* sl_rec,
                               const int* sl_dc, const int* tab,
                               const int* toff, int n_toff, void* stream) {
  if (n_cls < 0 || n_cls > MAX_CLASSES || n_toff != NUM_TOFF || nch < 1 ||
      Hp < 1 || Wp < 1 || bd < 8 || bd > 12 || !out || !err || !tab ||
      (chroma_scale && n_scale < 1) || (!sl_rec != !sl_dc))
    return (int)cudaErrorInvalidValue;
  Params p{};
  long long total = 0;
  int smem = 0;
  for (int c = 0; c < n_cls; ++c) {
    const long long* v = cls + 7 * c;
    Class& k = p.cls[c];
    k.mat = (const int*)v[0];
    k.lv = (const int*)v[1];
    k.w = (int)v[2];
    k.h = (int)v[3];
    k.n = (int)v[4];
    k.ld = (int)v[5];
    k.plane = (int)v[6];
    const bool pow2 = k.w > 0 && k.h > 0 && !(k.w & (k.w - 1)) &&
                      !(k.h & (k.h - 1));
    if (!pow2 || k.w > 64 || k.h > 64 || k.w * k.h < 2 || k.n < 1 ||
        k.ld < k.n || k.plane < 0 || k.plane >= nch || !k.mat || !k.lv)
      return (int)cudaErrorInvalidValue;
    k.first = (int)total;
    total += k.n;
    const int zw = k.w < 32 ? k.w : 32, zh = k.h < 32 ? k.h : 32;
    const int need = (zh * zw + k.h * zw + k.h * (zh + 1) +
                      k.w * (zw + 1)) * (int)sizeof(int);
    if (need > smem) smem = need;
  }
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.n_cls = n_cls;
  p.total = (int)total;
  p.out = out;
  p.err = err;
  p.Hp = Hp;
  p.Wp = Wp;
  p.bd = bd;
  p.chroma = chroma;
  p.chroma_scale = chroma_scale;
  p.n_scale = n_scale;
  p.sl_rec = sl_rec;
  p.sl_dc = sl_dc;
  p.tab = tab;
  for (int k = 0; k < NUM_TOFF; ++k) p.toff[k] = toff[k];
  // an empty call still launches (one block that returns), so that every
  // call of the frame program is one launch
  residual_kernel<<<total > 0 ? (int)total : 1, THREADS, smem,
                    (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* residual_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
