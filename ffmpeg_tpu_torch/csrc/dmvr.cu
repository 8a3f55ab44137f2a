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
// operations.  So the design is simple and keeps everything on chip.
//
// Design.  One warp per subblock, DMVR_WARPS warps a block.  The warp
// gathers both lists' 21 x 21 windows into shared memory, each read clamped
// to the H x W picture (not the padded plane), from the DPB's reference
// planes in place: their device pointers travel in the parameter block, so
// nothing is stacked and no index tensor is built.  It computes both 20 x 20
// predictions into shared memory (rows padded to 24 words, so that the two
// half-warps' rows fall on disjoint banks in the SAD loop), then the 25
// SADs: lane (r, c) takes column c and rows r*2, r*2 + 4, ... of the 8
// subsampled rows, masked by the subblock's w and h, and a warp reduction
// (__reduce_add_sync) sums each offset.  Lane 0 then biases the centre,
// takes the argmin of sad * 32 + scan order (the centre first), and runs
// the parametric step where the best offset is interior.
//
// Arithmetic.  The JAX form's int32 arithmetic: products, sums and
// differences wrap (done in unsigned), right shifts are arithmetic, and a
// left shift by a negative count (a << (10 - bd) at 12 bits) gives 0, as
// JAX and torch give it.
//
// Build (at first use, ffmpeg_tpu_torch/ops/dmvr.py _get_kernel), as one
// command:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -DDMVR_MAX_SLOTS=32 -o _build/libdmvr_32.so dmvr.cu

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DMVR_MAX_SLOTS
#error "DMVR_MAX_SLOTS (ops/dmvr.py MAX_SLOTS) must be defined"
#endif

#define DMVR_WARPS 4
#define SB 16           // subblocks are at most 16 x 16
#define WIN (SB + 5)    // the bilinear window of a subblock
#define PRED (WIN - 1)  // the prediction of a subblock and its offsets
#define PRED_PITCH 24   // words per prediction row in shared memory
#define N_KEYS 10       // control rows: x y w h mx0 my0 mx1 my1 s0 s1
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

struct Warp {
  int win[2][WIN * WIN];
  int pred[2][PRED * PRED_PITCH];
  int sad[25];
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

__global__ void __launch_bounds__(DMVR_WARPS * 32)
dmvr_search_kernel(const Params p) {
  __shared__ Warp warps[DMVR_WARPS];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * DMVR_WARPS + (threadIdx.x >> 5);
  if (i >= p.n) return;  // a whole warp leaves together
  Warp& s = warps[threadIdx.x >> 5];
  int c[N_KEYS];
#pragma unroll
  for (int k = 0; k < N_KEYS; ++k)
    c[k] = __ldg(p.ctrl + (long long)k * p.n + i);
  const int x = c[0], y = c[1], w = c[2], h = c[3];
  const int s1 = p.bit_depth - 6, o1 = 1 << (s1 - 1);

  // both lists' windows, clamped to the picture; a slot outside the table
  // (refine_frame checks the rows on the host) is clamped into it
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int mvx = c[4 + 2 * l], mvy = c[5 + 2 * l];
    const int slot = min(max(c[8 + l], 0), p.n_planes - 1);
    const int* plane = p.planes[slot];
    const int ox = x + (mvx >> 4) - 2, oy = y + (mvy >> 4) - 2;
    for (int e = lane; e < WIN * WIN; e += 32) {
      const int r = e / WIN, q = e - r * WIN;
      const int yy = min(max(oy + r, 0), p.H - 1);
      const int xx = min(max(ox + q, 0), p.W - 1);
      s.win[l][e] = __ldg(plane + yy * p.pitch + xx);
    }
  }
  __syncwarp();

  // the 10-bit bilinear predictions (ops/dmvr.py _bilin)
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int mx = c[4 + 2 * l] & 15, my = c[5 + 2 * l] & 15;
    const int* wn = s.win[l];
    int* pr = s.pred[l];
    for (int e = lane; e < PRED * PRED; e += 32) {
      const int r = e / PRED, q = e - r * PRED;
      const int* a = wn + r * WIN + q;
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
      pr[r * PRED_PITCH + q] = v;
    }
  }
  __syncwarp();

  // the 25 SADs over rows 0, 2, ..., 14 and columns 0..15 of the subblock,
  // masked by h and w, list 1 at the mirrored offset
  const int col = lane & 15, half = lane >> 4;
  const bool on_col = col < w;
  for (int dy = 0; dy < 5; ++dy) {
    for (int dx = 0; dx < 5; ++dx) {
      const int* a = s.pred[0] + dy * PRED_PITCH + dx + col;
      const int* b = s.pred[1] + (4 - dy) * PRED_PITCH + (4 - dx) + col;
      unsigned part = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = 2 * half + 4 * k;
        if (on_col && row < h)
          part += (unsigned)wabs(wsub(a[row * PRED_PITCH],
                                      b[row * PRED_PITCH]));
      }
      const unsigned total = __reduce_add_sync(FULL, part);
      if (lane == 0) s.sad[dy * 5 + dx] = (int)total;
    }
  }
  __syncwarp();
  if (lane) return;

  int* sad = s.sad;
  const int center = wsub(sad[12], sad[12] >> 2);
  sad[12] = center;
  const int area = wmul(w, h);
  const bool run = center >= area;
  // argmin of sad * 32 + scan order, the centre first (ops/dmvr.py _ORDER)
  int best = 12, best_key = wmul(center, 32);
  for (int k = 0; k < 25; ++k) {
    const int order = k < 12 ? k + 1 : (k == 12 ? 0 : k + 1);
    const int key = wadd(wmul(sad[k], 32), order);
    if (key < best_key || (key == best_key && k < best)) {
      best_key = key;
      best = k;
    }
  }
  const int min_sad = run ? sad[best] : center;
  const int bdy = best / 5, bdx = best - 5 * bdy;
  int dmv_x = run ? (bdx - 2) * 16 : 0;
  int dmv_y = run ? (bdy - 2) * 16 : 0;
  if (run && bdx != 0 && bdx != 4 && bdy != 0 && bdy != 4) {
    dmv_x += parametric(sad[best - 1], min_sad, sad[best + 1]);
    dmv_y += parametric(sad[best - 5], min_sad, sad[best + 5]);
  }
  p.out[i] = dmv_x;
  p.out[p.n + i] = dmv_y;
  p.out[2 * p.n + i] = min_sad < wmul(2, area);
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
  dmvr_search_kernel<<<(n + DMVR_WARPS - 1) / DMVR_WARPS, DMVR_WARPS * 32, 0,
                       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* dmvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
