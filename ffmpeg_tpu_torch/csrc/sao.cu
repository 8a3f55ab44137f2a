// Sample adaptive offset (SAO) for Hopper: one launch filters a luma
// plane, or the Cb and Cr planes, out of place into a fresh
// (nch, Hs, Wp) tensor.
//
// Replaces the JAX package's XLA `sao_plane` over `sao_rows`,
// ffmpeg_tpu/ops/sao.py:93,34 (not Pallas), which its frame program runs
// per component (ffmpeg_tpu/models/vvc/pipeline.py:1347) and its band
// split per CTB-row band (ffmpeg_tpu/parallel/spatial.py:139).  Its
// oracle is the plain torch version in ffmpeg_tpu_torch/ops/sao.py
// (sao_rows_plain, sao_planes_plain): band offset where
// ((x >> (bd - 5)) - band_pos) & 31 is below 4, edge offset by the EO
// class's two neighbours where both lie inside the picture, the clip to
// [0, 2^bd), samples outside the picture unchanged (spec 8.8.2;
// vvc_filter_template.c sao_band_filter / sao_edge_filter), bit for bit.
//
// Out of place.  The edge offset compares each sample with its
// unfiltered neighbours, so the kernel reads only its input planes and
// writes only its output: no order between threads matters.
//
// Bound by bytes: each plane read once and written once, 25.1 MB for a
// 1080p 4:2:0 frame (the int32 planes), 0.0075 ms at 3.35 TB/s; the
// per-CTB grids are a few KB.  A thread filters a run of 4 adjacent
// samples of one row (one 16-byte load and store where the rows are
// 16-byte aligned); its neighbours' rows come from the L1 and L2 caches,
// since a block covers 8 rows of 128 samples.  The CTB's parameters are
// read per sample from the grids, through their strides, so the
// frame's SAO tree ((CBH, CBW, 3) type, band and EO class grids and the
// (CBH, CBW, 3, 5) offsets) is read in place with the component's
// offset, never sliced or copied.
//
// The band form.  The planes may carry `halo` rows above and below the
// Hs rows filtered (a band of the band split with its neighbours' rows);
// `y0` is the picture row of the first filtered row, which the
// in-picture tests use, while the CTB row is counted from the band's
// first row.
//
// Build (at first use, ffmpeg_tpu_torch/ops/sao.py _get_kernel), as one
// command:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -o _build/libsao.so sao.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_NCH 2
#define TX 32  // runs of 4 samples a block row
#define TY 8   // rows a block

// a per-CTB grid of one plane: element (cby, cbx[, slot]) at
// p[cby * sy + cbx * sx + slot * ss]
struct Grid {
  const int* p[MAX_NCH];
  long long sy, sx, ss;
};

struct Params {
  const int* src[MAX_NCH];   // (He, Wp) planes, row stride pitch[c]
  long long pitch[MAX_NCH];
  int* dst;                  // (nch, Hs, Wp), contiguous
  Grid type, band, eo, offv;
  int He, Hs, Wp, halo, y0, pic_w, pic_h, ctb, cbh, cbw, bd;
  bool vec;                  // 16-byte loads and stores
};

// EO class k's neighbours are a = (dx, dy) and b = (-dx, -dy)
// (ops/sao.py _EO_DIRS): 0 horizontal, 1 vertical, 2 the 135 and 3 the
// 45 degree diagonal
__device__ __forceinline__ int eo_dx(int k) {
  return k == 1 ? 0 : (k == 3 ? 1 : -1);
}
__device__ __forceinline__ int eo_dy(int k) { return k == 0 ? 0 : -1; }

// 2 + sign(c - a) + sign(c - b) -> offset slot (ops/sao.py _EDGE_MAP:
// 1, 2, 0, 3, 4)
__device__ __forceinline__ int edge_slot(int idx) {
  return idx < 2 ? idx + 1 : (idx == 2 ? 0 : idx);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int at(const Grid& g, int c, int cby, int cbx,
                                  int slot = 0) {
  return __ldg(g.p[c] + cby * g.sy + cbx * g.sx + slot * g.ss);
}

// the filtered value of sample (row r of the Hs rows, column x), whose
// input value is v
__device__ __forceinline__ int sao_sample(const Params& p, int c, int r,
                                          int x, int v) {
  const int y = p.y0 + r;  // picture row
  if (y >= p.pic_h || x >= p.pic_w) return v;
  const int cby = min(max(r / p.ctb, 0), p.cbh - 1);
  const int cbx = min(x / p.ctb, p.cbw - 1);
  const int t = at(p.type, c, cby, cbx);
  int off = 0;
  if (t == 1) {
    const int delta = ((v >> (p.bd - 5)) - at(p.band, c, cby, cbx)) & 31;
    if (delta < 4) off = at(p.offv, c, cby, cbx, delta + 1);
  } else if (t == 2) {
    const int k = at(p.eo, c, cby, cbx) & 3;
    const int dx = eo_dx(k), dy = eo_dy(k);
    const int ax = x + dx, ay = y + dy, bx = x - dx, by = y - dy;
    if (ax >= 0 && ax < p.pic_w && ay >= 0 && ay < p.pic_h && bx >= 0
        && bx < p.pic_w && by >= 0 && by < p.pic_h) {
      // rows of the extended plane, clamped to it as the plain version's
      // reads are
      const int re = r + p.halo;
      const int* base = p.src[c];
      const int a = __ldg(base + min(max(re + dy, 0), p.He - 1)
                          * p.pitch[c] + min(max(ax, 0), p.Wp - 1));
      const int b = __ldg(base + min(max(re - dy, 0), p.He - 1)
                          * p.pitch[c] + min(max(bx, 0), p.Wp - 1));
      // int32 differences wrap, as torch's do
      const int idx = 2 + sgn((int)((unsigned)v - (unsigned)a))
          + sgn((int)((unsigned)v - (unsigned)b));
      off = at(p.offv, c, cby, cbx, edge_slot(idx));
    }
  } else {
    return min(max(v, 0), (1 << p.bd) - 1);
  }
  return min(max((int)((unsigned)v + (unsigned)off), 0), (1 << p.bd) - 1);
}

__global__ void __launch_bounds__(TX * TY) sao_kernel(const Params p) {
  const int c = blockIdx.z;
  const int r = blockIdx.y * TY + threadIdx.y;
  const int x0 = (blockIdx.x * TX + threadIdx.x) * 4;
  if (r >= p.Hs || x0 >= p.Wp) return;
  const int* in = p.src[c] + (r + p.halo) * p.pitch[c] + x0;
  int* out = p.dst + ((long long)c * p.Hs + r) * p.Wp + x0;
  if (p.vec) {
    int4 v = __ldg(reinterpret_cast<const int4*>(in));
    v.x = sao_sample(p, c, r, x0, v.x);
    v.y = sao_sample(p, c, r, x0 + 1, v.y);
    v.z = sao_sample(p, c, r, x0 + 2, v.z);
    v.w = sao_sample(p, c, r, x0 + 3, v.w);
    *reinterpret_cast<int4*>(out) = v;
    return;
  }
  const int n = min(4, p.Wp - x0);
  for (int i = 0; i < n; ++i)
    out[i] = sao_sample(p, c, r, x0 + i, __ldg(in + i));
}

static bool set_grid(Grid* g, const long long* ptrs, const long long* strides,
                     int nch, bool slots) {
  for (int c = 0; c < nch; ++c) {
    g->p[c] = (const int*)ptrs[c];
    if (!g->p[c]) return false;
  }
  g->sy = strides[0];
  g->sx = strides[1];
  g->ss = slots ? strides[2] : 0;
  return true;
}

// src: nch pointers to (He, Wp) int32 planes with row strides pitch;
// dst: (nch, He - 2 * halo, Wp) int32, contiguous.  type, band, eo: nch
// pointers each (the plane's component's (0, 0) element) with strides
// (sy, sx); offv: nch pointers with strides (sy, sx, slot).  cbh, cbw:
// the grids' CTB rows and columns.
extern "C" int sao_launch(const long long* src, const long long* pitch,
                          int* dst, int nch, int He, int Wp, int halo, int y0,
                          int pic_w, int pic_h, int ctb, int bit_depth,
                          const long long* type, const long long* type_st,
                          const long long* band, const long long* band_st,
                          const long long* eo, const long long* eo_st,
                          const long long* offv, const long long* offv_st,
                          int cbh, int cbw, void* stream) {
  Params p{};
  const int Hs = He - 2 * halo;
  if (!src || !pitch || !dst || nch < 1 || nch > MAX_NCH || halo < 0
      || Hs < 0 || Wp < 1 || ctb < 1 || cbh < 1 || cbw < 1 || bit_depth < 5
      || bit_depth > 16 || !set_grid(&p.type, type, type_st, nch, false)
      || !set_grid(&p.band, band, band_st, nch, false)
      || !set_grid(&p.eo, eo, eo_st, nch, false)
      || !set_grid(&p.offv, offv, offv_st, nch, true))
    return (int)cudaErrorInvalidValue;
  if (Hs == 0) return 0;
  p.vec = Wp % 4 == 0 && ((uintptr_t)dst & 15) == 0;
  for (int c = 0; c < nch; ++c) {
    p.src[c] = (const int*)src[c];
    p.pitch[c] = pitch[c];
    if (!p.src[c] || pitch[c] < Wp) return (int)cudaErrorInvalidValue;
    p.vec = p.vec && ((uintptr_t)src[c] & 15) == 0 && pitch[c] % 4 == 0;
  }
  p.dst = dst;
  p.He = He;
  p.Hs = Hs;
  p.Wp = Wp;
  p.halo = halo;
  p.y0 = y0;
  p.pic_w = pic_w;
  p.pic_h = pic_h;
  p.ctb = ctb;
  p.cbh = cbh;
  p.cbw = cbw;
  p.bd = bit_depth;
  const dim3 block(TX, TY);
  const dim3 grid((Wp + 4 * TX - 1) / (4 * TX), (Hs + TY - 1) / TY, nch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  sao_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* sao_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
