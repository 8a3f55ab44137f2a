// Adaptive loop filter (ALF) and cross-component ALF (CC-ALF) for Hopper:
// one launch filters a luma plane (4x4 classification and the 7x7
// clipped diamond), one launch filters the Cb and Cr planes (the 5x5
// clipped diamond, then the CC-ALF correction from the pre-ALF luma).
//
// Replaces the JAX package's XLA ALF, ffmpeg_tpu/ops/alf.py:91,169,202,241
// (alf_classify, alf_filter_luma, alf_filter_chroma, alf_filter_cc; not
// Pallas), which the frame program composes in `_alf_pass`
// (ffmpeg_tpu/models/vvc/pipeline.py:1211).  Its oracle is the plain
// torch version in ffmpeg_tpu_torch/ops/alf.py (alf_planes_plain over
// alf_classify and alf_filter_*): the same classification, tap tables,
// virtual-boundary rules and rounding (vvc_filter_template.c:43-381,
// vvc_filter.c:1254-1320), bit for bit.
//
// Bound.  Each plane is read once and written once, the luma once more
// for CC-ALF, and the per-CTB grid and the filter banks are a few KB:
// bytes bound the work, about 0.01 ms for a 1080p 4:2:0 frame at
// 3.35 TB/s (chip_smoke.py's bound).  Some 60 integer operations per
// luma sample for the diamond and about 20 for its share of the
// classification are far from the operation bound; the tensor cores
// have no part in a clipped integer stencil.  The design keeps each
// sample's traffic to one read and one write of device memory
// (neighbouring tiles' re-reads of a halo come from the L2 cache), and
// the whole-plane temporaries of the plain version (the gradient stack,
// the per-4x4 and per-sample coefficient fields) in shared memory:
//
// Tiles.  A block owns a TILE x TILE tile of output samples of one plane
// (blockIdx.x, blockIdx.y; for chroma the plane blockIdx.z).  It copies
// the tile and a halo into shared memory with cp.async, clamping each
// position to the cropped picture (the plain version's clamped reads,
// _sample), so that a read at any position of the buffer is the plain
// version's read at that position.  The luma halo is 3 samples: the
// 7x7 diamond reaches 3 rows and columns, and a 4x4 block's
// classification reads rows 4by-3 .. 4by+6 and columns 4bx-3 .. 4bx+6
// (gradients on rows r = 2gi-3 read r .. r+3).  The chroma halo is 2
// samples (5x5 diamond); beside it the block copies the collocated
// pre-ALF luma that CC-ALF reads: rows 2y-1 .. 2y+2, columns 2x-1 ..
// 2x+1 of each chroma sample (y, x).  Samples of the padded plane
// outside the cropped picture are copied unchanged; a tile wholly
// outside it only copies.
//
// Luma.  While the tile's copy is in flight, the block reads each of its
// 4x4 blocks' CTB flag and bank from the per-CTB grid (int8).  Then all
// threads compute the gradient field of the tile ((2 TILE/4 + 2)^2
// positions, four directions each) into shared memory; one thread per
// 4x4 block sums its window (rows cut at the virtual boundary), finds
// its class and transpose (the activity compare d1*hv0 <= hv1*d0 in 64
// bits), and the block's 12 transposed coefficients and clips are taken
// from its bank (int16) into shared memory; then each thread filters
// samples of the tile and writes each once, coalesced, into a fresh
// plane.
//
// Virtual boundary.  It sits ctb-4 luma rows (ctb/2-2 chroma rows) into
// every CTU row; every rule near it (the classification's window and
// row substitutions, the filters' collapsed row taps and the rounding
// shift of 10 on the two rows next to it, CC-ALF's row collapse) is a
// function of the absolute row modulo the CTB size, so tiles need not
// align to CTBs and may straddle the boundary.
//
// Build (at first use, ffmpeg_tpu_torch/ops/alf.py _get_kernel), as one
// command:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
//        -fPIC -DALF_TILE=.. -o _build/libalf_...so alf.cu

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ALF_TILE
#error "build with the tile constant of ops/alf.py"
#endif

#define TILE ALF_TILE
#define THREADS 256

static_assert(TILE % 4 == 0 && TILE >= 8 && TILE <= 64,
              "TILE: a multiple of 4, 8 .. 64");

// luma: the halo, the buffer's pitch, 4x4 blocks and gradient positions
// per tile side
#define LH 3
#define LP (TILE + 2 * LH)
#define NB (TILE / 4)
#define NG (2 * NB + 2)
// chroma: the halo and pitch; the collocated luma's rows and pitch
#define CH 2
#define CP (TILE + 2 * CH)
#define CLR (2 * TILE + 2)
#define CLP (2 * TILE + 1)

// luma shared memory (ints): the buffer, the gradient field (4
// directions), per 4x4 block its flag, bank, class and transpose, then
// its 12 coefficients and 12 clips
#define L_SMEM ((LP * LP + 4 * NG * NG + 4 * NB * NB + 24 * NB * NB) * 4)
// chroma shared memory (ints): the chroma buffer, the luma buffer, the
// chroma alternatives' coefficients and clips (8 x 6 each) and the
// component's CC-ALF coefficients (5 x 7)
#define C_SMEM ((CP * CP + CLR * CLP + 2 * 48 + 35) * 4)

// transpose_idx -> coefficient position permutation (alf_recon_coeff)
__constant__ int kTranspose[4][12] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    {9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6},
    {0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11},
    {9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6}};

// class_idx from directional activity (alf_get_idx)
__constant__ int kArgVar[16] = {0, 1, 2, 2, 2, 2, 2, 3,
                                3, 3, 3, 3, 3, 3, 3, 4};

struct LumaParams {
  const int* src;      // (Hp, Wp) padded luma, row-major
  int* dst;            // (Hp, Wp): the filtered plane
  int Hp, Wp;          // the padded plane
  int H, W;            // the cropped picture, multiples of 4
  const int8_t* ctb;   // (cbh, cbw, 8) per-CTB values
  int cbw;
  const int16_t* coeff;  // (nbanks, 25, 12) filter banks
  const int16_t* clipv;
  int nbanks;
  int ctb_log2, bd;
};

struct ChromaParams {
  const int* src[2];   // Cb, Cr: (Hp, Wp) padded chroma planes
  int* dst;            // (2, Hp, Wp)
  int Hp, Wp;
  int Hc, Wc;          // the cropped chroma picture
  const int* luma;     // the pre-ALF padded luma, pitch Wl
  int Wl;
  int H, W;            // the cropped luma picture
  const int8_t* ctb;
  int cbw;
  const int16_t* ccoeff;  // (8, 6) chroma alternatives
  const int16_t* cclipv;
  const int16_t* cc;      // (2, 5, 7) CC-ALF, row 0 zero
  int ctb_log2, bd;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// clip(v - curr, -k, k) as the plain version's _clipf
__device__ __forceinline__ int clipf(int d, int k) {
  return min(max(d, -k), k);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// a tile wholly outside the cropped picture: its samples as they are
__device__ __forceinline__ void copy_tile(const int* src, int* dst, int y0,
                                          int x0, int Hp, int Wp) {
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int y = y0 + i / TILE, x = x0 + i % TILE;
    const long long g = (long long)y * Wp + x;
    if (y < Hp && x < Wp) dst[g] = src[g];
  }
}

// rows [oy, oy + R) x columns [ox, ox + C) of a plane, each position
// clamped to [0, h) x [0, w), into buf (pitch C) with cp.async
__device__ __forceinline__ void load_clamped(int* buf, const int* src,
                                             int pitch, int oy, int ox,
                                             int R, int C, int h, int w) {
  for (int i = threadIdx.x; i < R * C; i += THREADS) {
    const int r = i / C, c = i - r * C;
    const int gy = clampi(oy + r, 0, h - 1), gx = clampi(ox + c, 0, w - 1);
    cp_async4(buf + i, src + (long long)gy * pitch + gx);
  }
}

__global__ void __launch_bounds__(THREADS)
alf_luma_kernel(LumaParams p) {
  extern __shared__ int smem[];
  int* const buf = smem;                       // LP x LP
  int* const grad = buf + LP * LP;             // 4 x NG x NG
  int* const b_on = grad + 4 * NG * NG;        // NB x NB each
  int* const b_bank = b_on + NB * NB;
  int* const b_cls = b_bank + NB * NB;
  int* const b_tr = b_cls + NB * NB;
  int* const b_coef = b_tr + NB * NB;          // NB x NB x 12
  int* const b_clip = b_coef + 12 * NB * NB;

  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int H = p.H, W = p.W, Wp = p.Wp;
  if (y0 >= H || x0 >= W) {
    copy_tile(p.src, p.dst, y0, x0, p.Hp, Wp);
    return;
  }
  const int ctb = 1 << p.ctb_log2, m = ctb - 1, vb = ctb - 4;

  load_clamped(buf, p.src, Wp, y0 - LH, x0 - LH, LP, LP, H, W);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // meanwhile, each 4x4 block's CTB flag and bank (blocks outside the
  // picture are never filtered)
  for (int b = threadIdx.x; b < NB * NB; b += THREADS) {
    const int yb = y0 + 4 * (b / NB), xb = x0 + 4 * (b % NB);
    int on = 0, bank = 0;
    if (yb < H && xb < W) {
      const int8_t* g = p.ctb + ((long long)(yb >> p.ctb_log2) * p.cbw
                                 + (xb >> p.ctb_log2)) * 8;
      on = g[0] > 0;
      // the host's banks are in range; an index past them takes the
      // nearest bank, as the JAX package's clamped gather does
      bank = clampi(g[1], 0, p.nbanks - 1);
    }
    b_on[b] = on;
    b_bank[b] = bank;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- the gradient field: rows r = y0 + 2gi - 3, columns c = x0 + 2ci
  // - 2 (alf_classify), the virtual boundary's row substitutions s0 :=
  // s1, s3 := s2 by r % ctb ------------------------------------------------
  for (int i = threadIdx.x; i < NG * NG; i += THREADS) {
    const int gi = i / NG, ci = i - gi * NG;
    const int r = y0 + 2 * gi - 3;
    const int lr = r & m;
    // buffer rows of r, r0 (s0), r + 1, r + 2, r3 (s3); column of c
    const int br = 2 * gi - 3 + LH;
    const int b0 = lr == ctb - 5 ? br + 1 : br;
    const int b3 = lr == ctb - 7 ? br + 2 : br + 3;
    const int bc = 2 * ci - 2 + LH;
    const int* R0 = buf + b0 * LP;
    const int* R1 = buf + (br + 1) * LP;
    const int* R2 = buf + (br + 2) * LP;
    const int* R3 = buf + b3 * LP;
    const int val0 = R1[bc] * 2;
    const int vert0 = abs(val0 - R0[bc] - R2[bc]);
    const int horz0 = abs(val0 - R1[bc - 1] - R1[bc + 1]);
    const int dig00 = abs(val0 - R0[bc - 1] - R2[bc + 1]);
    const int dig10 = abs(val0 - R0[bc + 1] - R2[bc - 1]);
    const int val1 = R2[bc + 1] * 2;
    const int vert1 = abs(val1 - R1[bc + 1] - R3[bc + 1]);
    const int horz1 = abs(val1 - R2[bc] - R2[bc + 2]);
    const int dig01 = abs(val1 - R1[bc] - R3[bc + 2]);
    const int dig11 = abs(val1 - R1[bc + 2] - R3[bc]);
    grad[i] = vert0 + vert1;
    grad[NG * NG + i] = horz0 + horz1;
    grad[2 * NG * NG + i] = dig00 + dig01;
    grad[3 * NG * NG + i] = dig10 + dig11;
  }
  __syncthreads();

  // ---- each 4x4 block's class and transpose ---------------------------
  for (int b = threadIdx.x; b < NB * NB; b += THREADS) {
    const int by = b / NB, bx = b - by * NB;
    const int ly = (y0 + 4 * by) & m;
    const int start = ly == vb ? 1 : 0, end = ly == vb - 4 ? 3 : 4;
    const int ac = (ly == vb || ly == vb - 4) ? 3 : 2;
    int s[4] = {0, 0, 0, 0};
    for (int i = start; i < end; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = (2 * by + i) * NG + 2 * bx + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] += grad[k * NG * NG + g];
      }
    }
    const int v = s[0], hz = s[1], d0g = s[2], d1g = s[3];
    const int dir_hv = v <= hz, dir_d = d0g <= d1g;
    const int hv1 = max(v, hz), hv0 = min(v, hz);
    const int d1 = max(d0g, d1g), d0 = min(d0g, d1g);
    // the products may pass 31 bits (alf_get_idx compares in 64)
    const int dir1 = (long long)d1 * hv0 <= (long long)hv1 * d0;
    const int hvd1 = dir1 ? hv1 : d1, hvd0 = dir1 ? hv0 : d0;
    const int act = clampi(((v + hz) * ac) >> (p.bd - 1), 0, 15);
    int cls = kArgVar[act];
    if (hvd1 * 2 > 9 * hvd0)
      cls += (dir1 * 2 + 2) * 5;
    else if (hvd1 > 2 * hvd0)
      cls += (dir1 * 2 + 1) * 5;
    b_cls[b] = cls;
    b_tr[b] = dir_d * 2 + dir_hv;
  }
  __syncthreads();

  // ---- each block's 12 transposed coefficients and clips --------------
  for (int i = threadIdx.x; i < 12 * NB * NB; i += THREADS) {
    const int b = i / 12, j = i - b * 12;
    const int k = (b_bank[b] * 25 + b_cls[b]) * 12 + kTranspose[b_tr[b]][j];
    b_coef[i] = p.coeff[k];
    b_clip[i] = p.clipv[k];
  }
  __syncthreads();

  // ---- the 7x7 diamond, each sample written once -----------------------
  const int maxv = (1 << p.bd) - 1;
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int ty = i / TILE, tx = i - ty * TILE;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= p.Hp || x >= Wp) continue;
    const long long g = (long long)y * Wp + x;
    if (y >= H || x >= W) {
      p.dst[g] = p.src[g];
      continue;
    }
    const int* s = buf + (ty + LH) * LP + tx + LH;
    const int curr = s[0];
    const int b = (ty >> 2) * NB + (tx >> 2);
    int out = curr;
    if (b_on[b]) {
      // the row taps collapse toward the row near the virtual boundary
      // (_row_offsets)
      const int ly = y & m;
      const int d1 = (ly == vb - 1 || ly == vb) ? 0 : 1;
      const int d2 = (ly >= vb - 2 && ly <= vb + 1) ? d1 : 2;
      const int d3 = (ly >= vb - 3 && ly <= vb + 2) ? d2 : 3;
      const int* c = b_coef + 12 * b;
      const int* k = b_clip + 12 * b;
#define TAP(j, ya, xa, yb, xb)                          \
  c[j] * (clipf(s[(ya) * LP + (xa)] - curr, k[j]) +     \
          clipf(s[(yb) * LP + (xb)] - curr, k[j]))
      const int total = TAP(0, d3, 0, -d3, 0) + TAP(1, d2, 1, -d2, -1) +
                        TAP(2, d2, 0, -d2, 0) + TAP(3, d2, -1, -d2, 1) +
                        TAP(4, d1, 2, -d1, -2) + TAP(5, d1, 1, -d1, -1) +
                        TAP(6, d1, 0, -d1, 0) + TAP(7, d1, -1, -d1, 1) +
                        TAP(8, d1, -2, -d1, 2) + TAP(9, 0, 3, 0, -3) +
                        TAP(10, 0, 2, 0, -2) + TAP(11, 0, 1, 0, -1);
#undef TAP
      const int sh = (ly >= vb - 1 && ly <= vb) ? (total + (1 << 9)) >> 10
                                                : (total + 64) >> 7;
      out = clampi(curr + sh, 0, maxv);
    }
    p.dst[g] = out;
  }
}

__global__ void __launch_bounds__(THREADS)
alf_chroma_kernel(ChromaParams p) {
  extern __shared__ int smem[];
  int* const buf = smem;                   // CP x CP
  int* const lbuf = buf + CP * CP;         // CLR x CLP
  int* const t_coef = lbuf + CLR * CLP;    // 8 x 6
  int* const t_clip = t_coef + 48;         // 8 x 6
  int* const t_cc = t_clip + 48;           // 5 x 7

  const int ch = blockIdx.z;               // 0 Cb, 1 Cr
  const int c = ch + 1;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int Hc = p.Hc, Wc = p.Wc, Wp = p.Wp;
  // (a constant index: a parameter array indexed at run time would be
  // copied to local memory)
  const int* src = ch ? p.src[1] : p.src[0];
  int* dst = p.dst + (long long)ch * p.Hp * Wp;
  if (y0 >= Hc || x0 >= Wc) {
    copy_tile(src, dst, y0, x0, p.Hp, Wp);
    return;
  }
  load_clamped(buf, src, Wp, y0 - CH, x0 - CH, CP, CP, Hc, Wc);
  load_clamped(lbuf, p.luma, p.Wl, 2 * y0 - 1, 2 * x0 - 1, CLR, CLP, p.H,
               p.W);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < 48 + 48 + 35; i += THREADS)
    t_coef[i] = i < 48 ? p.ccoeff[i]
                : i < 96 ? p.cclipv[i - 48]
                         : p.cc[ch * 35 + i - 96];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lc = p.ctb_log2 - 1;           // log2 of the chroma CTB size
  const int ctb_c = 1 << lc, mc = ctb_c - 1, vbc = ctb_c - 2;
  const int ctb = 1 << p.ctb_log2, m = ctb - 1, vb = ctb - 4;
  const int maxv = (1 << p.bd) - 1, half = 1 << (p.bd - 1);
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int ty = i / TILE, tx = i - ty * TILE;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= p.Hp || x >= Wp) continue;
    const long long g = (long long)y * Wp + x;
    if (y >= Hc || x >= Wc) {
      dst[g] = src[g];
      continue;
    }
    const int8_t* cv = p.ctb + ((long long)(y >> lc) * p.cbw + (x >> lc)) * 8;
    const int flag = cv[2 * c], alt = cv[2 * c + 1], idc = cv[5 + c];
    const int* s = buf + (ty + CH) * CP + tx + CH;
    const int curr = s[0];
    int pc = curr;
    if (flag > 0) {
      // an alternative outside 0..7 selects zero coefficients
      const bool known = alt >= 0 && alt < 8;
      const int a = known ? alt : 0;
      int cf[6], kp[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        cf[j] = known ? t_coef[6 * a + j] : 0;
        kp[j] = known ? t_clip[6 * a + j] : 0;
      }
      const int ly = y & mc;
      const int d1 = (ly == vbc - 1 || ly == vbc) ? 0 : 1;
      const int d2 = (ly >= vbc - 2 && ly <= vbc + 1) ? d1 : 2;
#define TAP(j, ya, xa, yb, xb)                          \
  cf[j] * (clipf(s[(ya) * CP + (xa)] - curr, kp[j]) +   \
           clipf(s[(yb) * CP + (xb)] - curr, kp[j]))
      const int total = TAP(0, d2, 0, -d2, 0) + TAP(1, d1, 1, -d1, -1) +
                        TAP(2, d1, 0, -d1, 0) + TAP(3, d1, -1, -d1, 1) +
                        TAP(4, 0, 2, 0, -2) + TAP(5, 0, 1, 0, -1);
#undef TAP
      const int sh = (ly >= vbc - 1 && ly <= vbc) ? (total + (1 << 9)) >> 10
                                                  : (total + 64) >> 7;
      pc = clampi(curr + sh, 0, maxv);
    }
    if (idc > 0) {
      // CC-ALF: 7 taps of the pre-ALF luma around the collocated sample
      // (alf_filter_cc); an index past 4 selects zero coefficients
      const bool known = idc < 5;
      const int a = known ? idc : 0;
      int w[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) w[j] = known ? t_cc[7 * a + j] : 0;
      const int pos = (2 * y) & m;
      const bool sub_all = pos == vb - 1 || pos == vb;
      const bool sub_s3 = pos == vb - 2 || pos == vb + 1;
      const int r1 = sub_all ? 0 : 1, rm1 = sub_all ? 0 : -1;
      const int r2 = sub_all ? 0 : (sub_s3 ? r1 : 2);
      const int* L = lbuf + (2 * ty + 1) * CLP + 2 * tx + 1;
      const int center = L[0];
#define CC(j, dy, dx) w[j] * (L[(dy) * CLP + (dx)] - center)
      const int total = CC(0, rm1, 0) + CC(1, 0, -1) + CC(2, 0, 1) +
                        CC(3, r1, -1) + CC(4, r1, 0) + CC(5, r1, 1) +
                        CC(6, r2, 0);
#undef CC
      const int sh = clampi((total + 64) >> 7, -half, half - 1);
      pc = clampi(pc + sh, 0, maxv);
    }
    dst[g] = pc;
  }
}

template <class K>
static int configure(K kernel, int smem, unsigned* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && dev < 32 && !(*configured >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    *configured |= 1u << dev;
  }
  return 0;
}

// One luma plane.  src, dst: (Hp, Wp) int32, dst written whole; H, W:
// the cropped picture (multiples of 4); ctb: the (cbh, cbw, 8) int8
// per-CTB grid covering it; coeff, clipv: (nbanks, 25, 12) int16.
extern "C" int alf_luma_launch(const int* src, int* dst, int Hp, int Wp,
                               int H, int W, const int8_t* ctb, int cbh,
                               int cbw, const int16_t* coeff,
                               const int16_t* clipv, int nbanks,
                               int ctb_log2, int bit_depth, void* stream) {
  if (!src || !dst || !ctb || !coeff || !clipv || H < 4 || W < 4 || H % 4
      || W % 4 || H > Hp || W > Wp || nbanks < 1 || ctb_log2 < 5
      || ctb_log2 > 7 || bit_depth < 8 || bit_depth > 12
      || ((long long)cbh << ctb_log2) < H || ((long long)cbw << ctb_log2) < W)
    return (int)cudaErrorInvalidValue;
  static unsigned configured = 0;
  int e = configure(alf_luma_kernel, L_SMEM, &configured);
  if (e) return e;
  LumaParams p{src, dst, Hp, Wp, H, W, ctb, cbw, coeff, clipv, nbanks,
               ctb_log2, bit_depth};
  const dim3 blocks((Wp + TILE - 1) / TILE, (Hp + TILE - 1) / TILE);
  alf_luma_kernel<<<blocks, THREADS, L_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The Cb and Cr planes.  src: 2 pointers to (Hp, Wp) int32 planes; dst:
// (2, Hp, Wp) int32, written whole; luma: the pre-ALF (Hl, Wl) padded
// luma plane; H, W: the cropped luma picture (chroma H/2 x W/2);
// ccoeff, cclipv: (8, 6) int16; cc: (2, 5, 7) int16.
extern "C" int alf_chroma_launch(const long long* src, int* dst, int Hp,
                                 int Wp, const int* luma, int Hl, int Wl,
                                 int H, int W, const int8_t* ctb, int cbh,
                                 int cbw, const int16_t* ccoeff,
                                 const int16_t* cclipv, const int16_t* cc,
                                 int ctb_log2, int bit_depth, void* stream) {
  if (!src || !src[0] || !src[1] || !dst || !luma || !ctb || !ccoeff
      || !cclipv || !cc || H < 8 || W < 8 || H % 4 || W % 4 || H > Hl
      || W > Wl || (H >> 1) > Hp || (W >> 1) > Wp || ctb_log2 < 5
      || ctb_log2 > 7 || bit_depth < 8 || bit_depth > 12
      || ((long long)cbh << ctb_log2) < H || ((long long)cbw << ctb_log2) < W)
    return (int)cudaErrorInvalidValue;
  static unsigned configured = 0;
  int e = configure(alf_chroma_kernel, C_SMEM, &configured);
  if (e) return e;
  ChromaParams p{{(const int*)src[0], (const int*)src[1]}, dst, Hp, Wp,
                 H >> 1, W >> 1, luma, Wl, H, W, ctb, cbw, ccoeff, cclipv,
                 cc, ctb_log2, bit_depth};
  const dim3 blocks((Wp + TILE - 1) / TILE, (Hp + TILE - 1) / TILE, 2);
  alf_chroma_kernel<<<blocks, THREADS, C_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* alf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
