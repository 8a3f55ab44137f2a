// LMCS (luma mapping with chroma scaling) for Hopper: the inverse luma
// map of a whole plane, and the per-VPDU chroma residual scales.
//
// Replaces the JAX package's XLA `_lmcs_inv` and `_lmcs_vpdu_scales`,
// ffmpeg_tpu/models/vvc/pipeline.py:373,393 (not Pallas), which its
// frame program runs on the luma plane before the loop filters and on
// the mapped luma recon before the chroma residuals.  Their oracles are
// the plain torch versions in ffmpeg_tpu_torch/ops/lmcs.py
// (lmcs_inv_plain, lmcs_vpdu_scales_plain), bit for bit.
//
// Tables.  Both kernels take the frame's tables in their parameter
// block (the host copy `inv_host` that models/vvc/convert.py keeps:
// pivot[17], inv_scale[16], min_bin, max_bin, chroma_scale[16]), so a
// launch reads nothing of the card but its plane.  An inverse-map block
// copies the (inv_scale[i], pivot[i]) pairs that a sample's bin indexes
// into shared memory, a pair a thread; a chroma-scales block the pivots
// and chroma scales (its thread 0).
//
// lmcs_inv.  Bound by bytes: the plane is read once and written once,
// 16.7 MB for a 1920x1088 luma plane, 0.005 ms at 3.35 TB/s; its
// operations come close behind (the bin's 16 compare-and-adds and about
// 12 more a sample: 0.003 ms at the int32 rate), so the design keeps a
// sample's work to arithmetic and one shared-memory load.  A sample's
// bin is min_bin plus the pivots pivot[j + 1], min_bin <= j <= max_bin,
// that it reaches (the reference's scan, counted rather than stopped, as
// the JAX form counts it); a bin outside 0..15 (16, for a sample at or
// past the last pivot with max_bin 15) maps to 0.  The host hands the
// kernel the 16 pivots with those outside the window set to INT_MIN,
// which every int32 reaches, and min_bin less their number, so the count
// is 16 unrolled compares with constant indices, the pivots in registers
// (loaded once from the parameter block): no shared load, no loop.  The
// bin then indexes one 8-byte pair in shared memory.  The
// arithmetic is the JAX form's int32 arithmetic, wrapping, with
// arithmetic shifts, for every int32 input, not only for the legal
// range.  A thread maps rounds of INV_LOADS runs of 4 adjacent samples
// (16-byte loads and stores when the tensor is 16-byte aligned) and
// issues a round's loads before it maps the round before, so that its
// first arithmetic waits on 2 x INV_LOADS loads in flight; the grid is at
// most one wave (the resident blocks the card holds, fewer where the
// plane is smaller), and its threads stride over the plane.
//
// lmcs_scales.  Bound by the launch: 128 samples for each of the 510
// VPDUs of a 1080p frame.  One warp per VPDU: the lanes sum the left
// column and the top row (read through the plane's row stride, rows and
// columns clamped to the picture: the edge replication), a shuffle
// reduces the sums, and lane 0 scans the pivots and writes the scale.
// A side in another tile is unavailable: the interior tile boundaries
// travel in the parameter block, at most LMCS_MAX_BDS a direction.
//
// Build (at first use, ffmpeg_tpu_torch/ops/lmcs.py _get_kernel), as one
// command:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -o _build/liblmcs.so lmcs.cu

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define LMCS_MAX_BDS 64  // interior tile boundaries per direction
#define N_PIVOT 17
#define N_BINS 16
#define INV_THREADS 256
#define INV_LOADS 1  // runs of 4 samples a thread loads a round
#define SCALE_WARPS 8
#define FULL 0xffffffffu

struct Tables {
  int pivot[N_PIVOT];
  int inv_scale[N_BINS];
  int chroma_scale[N_BINS];
  int min_bin, max_bin;
};

struct InvParams {
  // pivot[j + 1] for the bins j in [max(min_bin, 0), min(max_bin, 15)],
  // INT_MIN for the others; base: min_bin less the number of others
  int piv[N_BINS];
  int base;
  int2 seg[N_BINS];  // (inv_scale[i], pivot[i])
  const int* src;
  int* dst;
  long long n;      // samples
  int shift, maxv;  // bit_depth - 4, 2^bit_depth - 1
  bool vec;         // 16-byte loads and stores
};

struct ScaleParams {
  Tables t;
  const int* plane;  // the mapped luma picture, row stride `pitch`
  long long pitch;
  int* dst;          // (nvy * nvx,)
  int W, H, vsz, vsz_log2, nvx, nvy, bit_depth;
  int n_bx, n_by;
  int bx[LMCS_MAX_BDS], by[LMCS_MAX_BDS];
};

// the chroma scales' tables in shared memory: pivot, chroma_scale
struct Shared {
  int pivot[N_PIVOT];
  int chroma_scale[N_BINS];
};

// constant indices only, so the parameter block is read in place
__device__ __forceinline__ void load_tables(Shared* s, const Tables& t) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < N_PIVOT; ++j) s->pivot[j] = t.pivot[j];
#pragma unroll
    for (int j = 0; j < N_BINS; ++j) s->chroma_scale[j] = t.chroma_scale[j];
  }
  __syncthreads();
}

// min_bin plus the pivots pivot[j + 1], j in [min_bin, max_bin] and in
// 0..15, that x reaches (ops/lmcs.py _pivot_index)
__device__ __forceinline__ int pivot_index(int x, const int* pivot, int mb,
                                           int lo, int hi) {
  int idx = mb;
  for (int j = lo; j <= hi; ++j) idx += x >= pivot[j + 1];
  return idx;
}

// the inverse map of x, with the pairs (inv_scale[i], pivot[i]) in
// shared memory
__device__ __forceinline__ int inv_map(int x, const InvParams& p,
                                       const int2* seg) {
  unsigned i = (unsigned)p.base;  // int32 sums wrap, as torch's do
#pragma unroll
  for (int j = 0; j < N_BINS; ++j) i += (unsigned)(x >= p.piv[j]);
  int out = 0;
  if (i < N_BINS) {
    const int2 t = seg[i];
    // int32 products and sums wrap, as torch's do
    const unsigned prod = (unsigned)t.x * ((unsigned)x - (unsigned)t.y)
        + (1u << 10);
    out = (int)((i << p.shift) + (unsigned)((int)prod >> 11));
  }
  return min(max(out, 0), p.maxv);
}

__device__ __forceinline__ int4 load_quad(const InvParams& p, long long q) {
  if (p.vec) return __ldg(reinterpret_cast<const int4*>(p.src) + q);
  const int* a = p.src + 4 * q;
  return make_int4(__ldg(a), __ldg(a + 1), __ldg(a + 2), __ldg(a + 3));
}

// a round of a thread's runs: INV_LOADS runs of 4 samples, INV_THREADS
// runs apart from q0 (zeros past the last run)
__device__ __forceinline__ void load_round(int4* v, const InvParams& p,
                                           long long q0, long long quads) {
#pragma unroll
  for (int u = 0; u < INV_LOADS; ++u)
    v[u] = q0 + u * INV_THREADS < quads ? load_quad(p, q0 + u * INV_THREADS)
                                        : make_int4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(INV_THREADS)
lmcs_inv_kernel(const InvParams p) {
  __shared__ int2 seg[N_BINS];
  // a pair a thread; constant indices, so the parameter block is read in
  // place
  if (threadIdx.x < N_BINS) {
#pragma unroll
    for (int j = 0; j < N_BINS; ++j)
      if (threadIdx.x == j) seg[j] = p.seg[j];
  }
  __syncthreads();
  constexpr int CHUNK = INV_THREADS * INV_LOADS;
  const long long quads = p.n >> 2;
  const long long stride = (long long)gridDim.x * CHUNK;
  long long q0 = (long long)blockIdx.x * CHUNK + threadIdx.x;
  int4 v[INV_LOADS];
  load_round(v, p, q0, quads);
  for (; q0 < quads; q0 += stride) {
    // the next round's loads fly while this round is mapped
    int4 next[INV_LOADS];
    load_round(next, p, q0 + stride, quads);
#pragma unroll
    for (int u = 0; u < INV_LOADS; ++u) {
      const long long q = q0 + u * INV_THREADS;
      if (q >= quads) break;
      const int4 m =
          make_int4(inv_map(v[u].x, p, seg), inv_map(v[u].y, p, seg),
                    inv_map(v[u].z, p, seg), inv_map(v[u].w, p, seg));
      if (p.vec) {
        reinterpret_cast<int4*>(p.dst)[q] = m;
      } else {
        int* d = p.dst + 4 * q;
        d[0] = m.x;
        d[1] = m.y;
        d[2] = m.z;
        d[3] = m.w;
      }
    }
#pragma unroll
    for (int u = 0; u < INV_LOADS; ++u) v[u] = next[u];
  }
  // the last n % 4 samples
  if (blockIdx.x == 0 && threadIdx.x < (p.n & 3)) {
    const long long k = (quads << 2) + threadIdx.x;
    p.dst[k] = inv_map(__ldg(p.src + k), p, seg);
  }
}

__global__ void __launch_bounds__(SCALE_WARPS * 32)
lmcs_scales_kernel(const ScaleParams p) {
  __shared__ Shared s;
  load_tables(&s, p.t);
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * SCALE_WARPS + (threadIdx.x >> 5);
  if (v >= p.nvx * p.nvy) return;
  const int vy = (v / p.nvx) * p.vsz, vx = (v % p.nvx) * p.vsz;
  bool al = vx > 0, at = vy > 0;
  for (int k = 0; k < p.n_bx; ++k) al = al && vx != p.bx[k];
  for (int k = 0; k < p.n_by; ++k) at = at && vy != p.by[k];
  // int32 sums wrap, as torch's do
  unsigned lsum = 0, tsum = 0;
  if (al) {
    const int* col = p.plane + (vx - 1);
    for (int i = lane; i < p.vsz; i += 32)
      lsum += (unsigned)__ldg(col + min(vy + i, p.H - 1) * p.pitch);
  }
  if (at) {
    const int* row = p.plane + (long long)(vy - 1) * p.pitch;
    for (int i = lane; i < p.vsz; i += 32)
      tsum += (unsigned)__ldg(row + min(vx + i, p.W - 1));
  }
  unsigned total = (al ? lsum : 0u) + (at ? tsum : 0u);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  if (lane) return;
  const int cnt = ((int)al + (int)at) * p.vsz;
  const int cnt_log2 = p.vsz_log2 + (int)(al && at);
  const int luma = cnt > 0 ? (int)(total + (unsigned)(cnt >> 1)) >> cnt_log2
                           : 1 << (p.bit_depth - 1);
  const int mb = p.t.min_bin;
  const int idx = min(pivot_index(luma, s.pivot, mb, max(mb, 0),
                                  min(p.t.max_bin, N_BINS - 1)),
                      N_BINS - 1);
  p.dst[v] = s.chroma_scale[idx];
}

static bool set_tables(Tables* t, const int* tab, int n) {
  // pivot[17], inv_scale[16], min_bin, max_bin[, chroma_scale[16]]
  if (!tab || (n != 35 && n != 51)) return false;
  for (int j = 0; j < N_PIVOT; ++j) t->pivot[j] = tab[j];
  for (int j = 0; j < N_BINS; ++j) {
    t->inv_scale[j] = tab[N_PIVOT + j];
    t->chroma_scale[j] = n == 51 ? tab[35 + j] : 0;
  }
  t->min_bin = tab[33];
  t->max_bin = tab[34];
  return true;
}

// resident lmcs_inv blocks the current card holds at once (SMs x blocks
// per SM), per device (the first 32), once; 0 on an error, in *err
static int inv_resident(int* err) {
  static int known[32];
  int dev = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c == cudaSuccess && dev < 32 && known[dev]) return known[dev];
  int sms = 0, per = 0;
  if (c == cudaSuccess)
    c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (c == cudaSuccess)
    c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, lmcs_inv_kernel,
                                                      INV_THREADS, 0);
  *err = (int)c;
  if (c != cudaSuccess) return 0;
  const int n = sms * (per > 0 ? per : 1);
  if (dev < 32) known[dev] = n;
  return n;
}

// The inverse map of n contiguous int32 samples, src into dst.
extern "C" int lmcs_inv_launch(const int* src, int* dst, long long n,
                               const int* tab, int n_tab, int bit_depth,
                               void* stream) {
  InvParams p{};
  Tables t{};
  if (!src || !dst || n < 0 || bit_depth < 8 || bit_depth > 16
      || !set_tables(&t, tab, n_tab))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int lo = t.min_bin > 0 ? t.min_bin : 0;
  const int hi = t.max_bin < N_BINS - 1 ? t.max_bin : N_BINS - 1;
  unsigned base = (unsigned)t.min_bin;
  for (int j = 0; j < N_BINS; ++j) {
    const bool in = j >= lo && j <= hi;
    p.piv[j] = in ? t.pivot[j + 1] : INT_MIN;
    base -= in ? 0u : 1u;
    p.seg[j] = make_int2(t.inv_scale[j], t.pivot[j]);
  }
  p.base = (int)base;
  p.src = src;
  p.dst = dst;
  p.n = n;
  p.shift = bit_depth - 4;
  p.maxv = (1 << bit_depth) - 1;
  p.vec = ((uintptr_t)src & 15) == 0 && ((uintptr_t)dst & 15) == 0;
  int err = 0;
  const int wave = inv_resident(&err);
  if (!wave) return err;
  // at most one wave; the loop strides
  const long long want =
      ((n >> 2) + INV_THREADS * INV_LOADS - 1) / (INV_THREADS * INV_LOADS);
  const int blocks = (int)(want < 1 ? 1 : (want > wave ? wave : want));
  lmcs_inv_kernel<<<blocks, INV_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The per-VPDU chroma scales of the (H, W) picture at `plane` (row
// stride `pitch` samples) into dst (nvy * nvx,); bx, by: the interior
// tile boundaries in luma samples.
extern "C" int lmcs_scales_launch(const int* plane, long long pitch, int W,
                                  int H, int vsz, int bit_depth,
                                  const int* tab, int n_tab, const int* bx,
                                  int n_bx, const int* by, int n_by, int* dst,
                                  void* stream) {
  ScaleParams p{};
  if (!plane || !dst || W < 1 || H < 1 || pitch < W || vsz < 1
      || (vsz & (vsz - 1)) || bit_depth < 8 || bit_depth > 16 || n_tab != 51
      || !set_tables(&p.t, tab, n_tab) || n_bx < 0 || n_by < 0
      || n_bx > LMCS_MAX_BDS || n_by > LMCS_MAX_BDS || (n_bx && !bx)
      || (n_by && !by))
    return (int)cudaErrorInvalidValue;
  p.plane = plane;
  p.pitch = pitch;
  p.dst = dst;
  p.W = W;
  p.H = H;
  p.vsz = vsz;
  p.vsz_log2 = 31 - __builtin_clz((unsigned)vsz);
  p.nvx = (W + vsz - 1) / vsz;
  p.nvy = (H + vsz - 1) / vsz;
  p.bit_depth = bit_depth;
  p.n_bx = n_bx;
  p.n_by = n_by;
  for (int k = 0; k < n_bx; ++k) p.bx[k] = bx[k];
  for (int k = 0; k < n_by; ++k) p.by[k] = by[k];
  const int nv = p.nvx * p.nvy;
  lmcs_scales_kernel<<<(nv + SCALE_WARPS - 1) / SCALE_WARPS, SCALE_WARPS * 32,
                       0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* lmcs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
