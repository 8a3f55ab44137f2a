// DMVR search for Hopper: per subblock of every DMVR unit of a frame, the
// 10-bit bilinear predictions of both lists around the parsed MVs, the 25
// integer offsets scored by a 2x vertically subsampled SAD with mirrored
// offsets, the argmin and the 3-bit parametric sub-pel step.
//
// Replaces the JAX package's XLA `_unit` and `_bilin`,
// ffmpeg_tpu/ops/dmvr.py:48,29 (not Pallas), vmapped over the subblocks by
// `_refine_jit` (137).  Its oracle is the plain torch version in
// ffmpeg_tpu_torch/ops/dmvr.py (refine_subblocks_plain), bit for bit.
//
// Bound.  The launch: a 1080p DMVR frame has a few hundred to a thousand
// subblocks, each reading two 21 x 21 windows (3.5 KB) and doing about 20k
// integer operations, well under a microsecond of the card's bytes or
// operations.  What a launch costs beyond its floor is one subblock's
// chain of dependent steps, so the design spreads that chain over a block.
//
// Design.  One block of DMVR_THREADS threads per subblock: a frame's few
// hundred subblocks are one wave, and a few thousand one or two.  All the
// block's threads stage both lists' 21 x 21 windows into shared memory
// with 4-byte cp.async copies, each source clamped to the H x W picture
// (not the padded plane), from the DPB's reference planes in place (their
// device pointers travel in the parameter block, so nothing is stacked and
// no index tensor is built), and wait once.  They compute both 20 x 20
// predictions into shared memory (rows padded to 24 words, so that the
// two half-warps' rows fall on disjoint banks in the SAD loop).  The 25
// SADs are split over the warps, warp w taking offsets w, w + 4, ...: lane
// (r, c) takes column c and rows r*2, r*2 + 4, ... of the 8 subsampled
// rows, masked by the subblock's w and h, and a warp reduction
// (__reduce_add_sync) sums each offset.  Warp 0 then takes the argmin of
// sad * 32 + scan order (the centre first) by a shuffle reduction, lane k
// holding offset k's key, and its lanes 0 and 1 run the parametric steps
// of x and y at once where the best offset is interior.
//
// Arithmetic.  The JAX form's int32 arithmetic: products, sums and
// differences wrap (done in unsigned), right shifts are arithmetic, and a
// left shift by a negative count (a << (10 - bd) at 12 bits) gives 0, as
// JAX and torch give it.  The keys sad * 32 + order are distinct (their
// low 5 bits are the order, 0..24), so the argmin has no ties to break.
//
// Build (at first use, ffmpeg_tpu_torch/ops/dmvr.py _get_kernel), as one
// command:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -DDMVR_MAX_SLOTS=32 -o _build/libdmvr_32.so dmvr.cu

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#ifndef DMVR_MAX_SLOTS
#error "DMVR_MAX_SLOTS (ops/dmvr.py MAX_SLOTS) must be defined"
#endif

#define DMVR_WARPS 4
#define DMVR_THREADS (DMVR_WARPS * 32)
#define SB 16           // subblocks are at most 16 x 16
#define WIN (SB + 5)    // the bilinear window of a subblock
#define PRED (WIN - 1)  // the prediction of a subblock and its offsets
#define PRED_PITCH 24   // words per prediction row in shared memory
#define N_KEYS 10       // control rows: x y w h mx0 my0 mx1 my1 s0 s1
#define N_OFFSETS 25
#define FULL 0xffffffffu

struct Params {
  const int* planes[DMVR_MAX_SLOTS];  // the reference luma planes
  int n_planes;
  long long pitch;                    // their row stride (samples)
  int H, W, bit_depth;
  const int* ctrl;                    // (N_KEYS, n)
  int* out;                           // (3, n): dmv_x, dmv_y, nobdof
  int n;
};

// int32 arithmetic that wraps, as torch's and JAX's does
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (s < 0 || s >= 32) ? 0 : (int)((unsigned)a << s);
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? (int)(0u - (unsigned)a) : a;
}

// (16 - f) * a + f * b + o, then >> s (the bilinear tap pair)
__device__ __forceinline__ int tap(int a, int b, int f, int o, int s) {
  return wadd(wadd(wmul(16 - f, a), wmul(f, b)), o) >> s;
}

// parametric_mv_refine: the parabola's sub-pel offset by a 3-bit restoring
// division (ops/dmvr.py _parametric)
__device__ int parametric(int sm, int sc, int sp) {
  const int denom = wshl(wsub(wadd(sm, sp), wshl(sc, 1)), 3);
  int num = wmul(wsub(sm, sp), 16);
  const bool sign = num < 0;
  num = wabs(num);
  int q = 0, d = denom;
  for (int k = 0; k < 3; ++k) {
    q <<= 1;
    if (num >= d) {
      num = wsub(num, d);
      q += 1;
    }
    d >>= 1;
  }
  q = sign ? -q : q;
  q = sm == sc ? -8 : (sp == sc ? 8 : q);
  return denom == 0 ? 0 : q;
}

// one int from global to shared memory (4 bytes, cp.async); completed by
// cp.async.wait_all
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__global__ void __launch_bounds__(DMVR_THREADS)
dmvr_search_kernel(const __grid_constant__ Params p) {
  __shared__ int win[2][WIN * WIN];
  __shared__ int pred[2][PRED * PRED_PITCH];
  __shared__ int sad[N_OFFSETS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x;
  int c[N_KEYS];
#pragma unroll
  for (int k = 0; k < N_KEYS; ++k)
    c[k] = __ldg(p.ctrl + (long long)k * p.n + i);
  const int x = c[0], y = c[1], w = c[2], h = c[3];

  // both lists' windows, clamped to the picture, in flight at once; a slot
  // outside the table (refine_frame checks the rows on the host) is
  // clamped into it
  {
    const int* plane0 = p.planes[min(max(c[8], 0), p.n_planes - 1)];
    const int* plane1 = p.planes[min(max(c[9], 0), p.n_planes - 1)];
    const int ox0 = x + (c[4] >> 4) - 2, oy0 = y + (c[5] >> 4) - 2;
    const int ox1 = x + (c[6] >> 4) - 2, oy1 = y + (c[7] >> 4) - 2;
    for (int e = tid; e < 2 * WIN * WIN; e += DMVR_THREADS) {
      const bool l = e >= WIN * WIN;
      const int f = l ? e - WIN * WIN : e;
      const int r = f / WIN, q = f - r * WIN;
      const int yy = min(max((l ? oy1 : oy0) + r, 0), p.H - 1);
      const int xx = min(max((l ? ox1 : ox0) + q, 0), p.W - 1);
      cp_async4(&win[l][f], (l ? plane1 : plane0) + yy * p.pitch + xx);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // the 10-bit bilinear predictions (ops/dmvr.py _bilin)
  const int s1 = p.bit_depth - 6, o1 = 1 << (s1 - 1);
  for (int e = tid; e < 2 * PRED * PRED; e += DMVR_THREADS) {
    const bool l = e >= PRED * PRED;
    const int f = l ? e - PRED * PRED : e;
    const int r = f / PRED, q = f - r * PRED;
    const int mx = (l ? c[6] : c[4]) & 15, my = (l ? c[7] : c[5]) & 15;
    const int* a = win[l] + r * WIN + q;
    int v;
    if (mx == 0 && my == 0) {
      v = wshl(a[0], 10 - p.bit_depth);
    } else if (my == 0) {
      v = tap(a[0], a[1], mx, o1, s1);
    } else if (mx == 0) {
      v = tap(a[0], a[WIN], my, o1, s1);
    } else {
      const int h0 = tap(a[0], a[1], mx, o1, s1);
      const int h1 = tap(a[WIN], a[WIN + 1], mx, o1, s1);
      v = tap(h0, h1, my, 8, 4);
    }
    pred[l][r * PRED_PITCH + q] = v;
  }
  __syncthreads();

  // the 25 SADs, warp w taking offsets w, w + DMVR_WARPS, ...: over rows
  // 0, 2, ..., 14 and columns 0..15 of the subblock, masked by h and w,
  // list 1 at the mirrored offset
  const int col = lane & 15, half = lane >> 4;
  const bool on_col = col < w;
  for (int k = warp; k < N_OFFSETS; k += DMVR_WARPS) {
    const int dy = k / 5, dx = k - 5 * dy;
    const int* a = pred[0] + dy * PRED_PITCH + dx + col;
    const int* b = pred[1] + (4 - dy) * PRED_PITCH + (4 - dx) + col;
    unsigned part = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 2 * half + 4 * j;
      if (on_col && row < h)
        part += (unsigned)wabs(wsub(a[row * PRED_PITCH], b[row * PRED_PITCH]));
    }
    const unsigned total = __reduce_add_sync(FULL, part);
    if (lane == 0) sad[k] = (int)total;
  }
  __syncthreads();
  if (warp) return;

  // warp 0: lane k < 25 holds offset k's SAD (the centre's biased) and
  // key; the argmin by a shuffle reduction over (key, k)
  int s = lane < N_OFFSETS ? sad[lane] : 0;
  if (lane == 12) s = wsub(s, s >> 2);
  const int order = lane < 12 ? lane + 1 : (lane == 12 ? 0 : lane + 1);
  int key = lane < N_OFFSETS ? wadd(wmul(s, 32), order) : INT_MAX;
  int best = lane;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int k2 = __shfl_xor_sync(FULL, key, o);
    const int b2 = __shfl_xor_sync(FULL, best, o);
    if (k2 < key || (k2 == key && b2 < best)) {
      key = k2;
      best = b2;
    }
  }
  const int center = __shfl_sync(FULL, s, 12);
  const int area = wmul(w, h);
  const bool run = center >= area;
  const int min_sad = run ? __shfl_sync(FULL, s, best) : center;
  const int bdy = best / 5, bdx = best - 5 * bdy;
  // lane 0 steps along x, lane 1 along y: the neighbours best -+ step
  const int step = lane == 0 ? 1 : 5;
  const int sm = __shfl_sync(FULL, s, max(best - step, 0));
  const int sp = __shfl_sync(FULL, s, min(best + step, 31));
  if (lane > 2) return;
  if (lane == 2) {
    p.out[2 * p.n + i] = min_sad < wmul(2, area);
    return;
  }
  const int whole = ((lane == 0 ? bdx : bdy) - 2) * 16;
  int dmv = run ? whole : 0;
  if (run && bdx != 0 && bdx != 4 && bdy != 0 && bdy != 4)
    dmv += parametric(sm, min_sad, sp);
  p.out[lane * p.n + i] = dmv;
}

// The search of n subblocks: planes, n_planes device pointers to
// contiguous int32 planes of row stride `pitch` (at least W wide and H
// high); ctrl (10, n) int32 rows on the card; out (3, n) int32.
extern "C" int dmvr_search_launch(const int* const* planes, int n_planes,
                                  long long pitch, int H, int W,
                                  int bit_depth, const int* ctrl, int* out,
                                  int n, void* stream) {
  Params p{};
  if (!planes || n_planes < 1 || n_planes > DMVR_MAX_SLOTS || !ctrl || !out
      || n < 0 || H < 1 || W < 1 || pitch < W || bit_depth < 8
      || bit_depth > 16)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_planes; ++k) {
    if (!planes[k]) return (int)cudaErrorInvalidValue;
    p.planes[k] = planes[k];
  }
  if (n == 0) return 0;
  p.n_planes = n_planes;
  p.pitch = pitch;
  p.H = H;
  p.W = W;
  p.bit_depth = bit_depth;
  p.ctrl = ctrl;
  p.out = out;
  p.n = n;
  dmvr_search_kernel<<<n, DMVR_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* dmvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
