// LMCS (luma mapping with chroma scaling) for Hopper: the inverse luma
// map of a whole plane.  (The per-VPDU chroma residual scales are
// computed inside the chroma residual launch: lmcs_scale.cuh.)
//
// Replaces the JAX package's XLA `_lmcs_inv`,
// ffmpeg_tpu/models/vvc/pipeline.py:373 (not Pallas), which its frame
// program runs on the luma plane before the loop filters.  Its oracle is
// the plain torch version in ffmpeg_tpu_torch/ops/lmcs.py
// (lmcs_inv_plain), bit for bit.
//
// Tables.  The kernel takes the frame's tables in its parameter block
// (the host copy `inv_host` that models/vvc/convert.py keeps: pivot[17],
// inv_scale[16], min_bin, max_bin, then chroma_scale[16] where chroma
// residual scaling is on), so a launch reads nothing of the card but its
// plane.  A block copies the (inv_scale[i], pivot[i]) pairs that a
// sample's bin indexes into shared memory, a pair a thread.
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
// Build (at first use, ffmpeg_tpu_torch/ops/lmcs.py _get_kernel), as one
// command:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -o _build/liblmcs.so lmcs.cu

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define N_PIVOT 17
#define N_BINS 16
#define INV_THREADS 256
#define INV_LOADS 1  // runs of 4 samples a thread loads a round

struct Tables {
  int pivot[N_PIVOT];
  int inv_scale[N_BINS];
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

static bool set_tables(Tables* t, const int* tab, int n) {
  // pivot[17], inv_scale[16], min_bin, max_bin[, chroma_scale[16]]
  if (!tab || (n != 35 && n != 51)) return false;
  for (int j = 0; j < N_PIVOT; ++j) t->pivot[j] = tab[j];
  for (int j = 0; j < N_BINS; ++j) t->inv_scale[j] = tab[N_PIVOT + j];
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

extern "C" const char* lmcs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
