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
// vvc_filter.c:1254-1320), bit for bit.  ops/alf.py alf_tiled_plain
// runs this file's decomposition (tiles, halo, copy paths, per-row
// offsets, the padding ring) on the CPU.
//
// Bound.  Each plane is read once and written once, the luma once more
// for CC-ALF, and the per-CTB grid and the filter banks are a few KB:
// bytes bound the least time, about 0.011 ms for a 1080p 4:2:0 frame at
// 3.35 TB/s (chip_smoke.py's bound).  The operations come close behind,
// and on the card the integer pipe limits the kernel (the clip's
// add-and-max and min, the gradients' absolute differences), so the
// design cuts the instructions a sample as much as the traffic:
//
// Threads own rows of a 4x4 block.  A luma block owns TH x TW output
// tiles; thread (warp w, lane l) owns row l >> 3 of 4x4 block column
// (w % (TW / 32)) * 8 + (l & 7) of block row w / (TW / 32): 4 adjacent
// samples of one row.  The 4 threads of a 4x4 block are lanes 8 apart
// in one warp.  Each computes one row of its block's classification
// window (4 gradient positions, the virtual boundary's row
// substitutions, the window cut at it) and the four sum by shuffles, so
// each holds the block's class and transpose; each then keeps the
// block's 12 transposed coefficients and 12 clips in registers, takes
// its row's virtual-boundary offsets once, and reads the diamond's rows
// as 16-, 8- and 4-byte vectors from shared memory (48 words for 4
// samples, 44 more for the gradients).  A chroma block owns TH x TW/2
// samples of both Cb and Cr (half its threads each) over one copy of
// the collocated luma; a thread filters a run of 4 samples of one row
// with its CTB's values read once.
//
// A persistent grid.  The launch has as many blocks as the card holds
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, or the
// tile count if smaller; at most 64 registers a thread, MINB); block b
// takes tiles b, b + grid, ... in row order, one tile buffer each: the
// card's other resident blocks cover a tile's copy (cp.async).  Tiles
// cover the cropped picture only; the padding ring around it (the
// plane's samples outside the picture, copied unchanged) is a
// grid-stride copy in 16-byte vectors.
//
// Copies.  A tile's buffer holds rows [y0 - halo, y0 + TH + halo) and
// the aligned columns [x0 - 4, x0 + TW + 4) of the plane, each position
// clamped to the cropped picture (the plain version's clamped reads,
// _sample), so that a read at any buffer position is the plain version's
// read there.  A chunk of 4 columns inside the picture is one 16-byte
// cp.async.cg from its (clamped) row; a chunk that crosses the picture's
// edge, or any chunk of a plane whose base or pitch is not 16-byte
// aligned, is 4 clamped 4-byte copies.  The luma halo is 3 rows: the
// 7x7 diamond reaches 3 rows and columns, and a 4x4 block's
// classification reads rows 4by-3 .. 4by+6 and columns 4bx-3 .. 4bx+6.
// The chroma halo is 2 rows (5x5 diamond); the collocated luma that
// CC-ALF reads is rows 2y-1 .. 2y+2, columns 2x-1 .. 2x+1 of each chroma
// sample (y, x).
//
// Two launches that overlap.  The chroma call reads the pre-ALF luma,
// not the luma call's output, so it may run beside the luma launch:
// launched after it with programmatic stream serialization, it starts
// as soon as every luma block has started (each calls
// griddepcontrol.launch_dependents first), and one thread of its grid
// waits (griddepcontrol.wait) before it exits, so that the chroma launch
// completes only after the luma launch (a later kernel of the stream
// sees both).  Outside such a launch the wait returns at once.
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
//        -fPIC -DALF_TH=.. -DALF_TW=..
//        -o _build/libalf_...so alf.cu

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(ALF_TH) || !defined(ALF_TW)
#error "build with the tile constants of ops/alf.py"
#endif

#define TH ALF_TH
#define TW ALF_TW
#define THREADS (TH * TW / 4)
// blocks per SM the register budget must allow: at most 64 registers a
// thread (more registers and fewer resident blocks ran slower)
#define MINB (1024 / THREADS)

static_assert(TH % 4 == 0 && TW % 32 == 0 && THREADS % 32 == 0 &&
                  THREADS >= 64 && THREADS <= 1024,
              "TH: a multiple of 4; TW: a multiple of 32; 64 .. 1024 "
              "threads");

// luma: the buffer's rows (halo 3) and pitch (4 aligned columns a side)
#define LR (TH + 6)
#define LP (TW + 8)
#define LBUF (LR * LP)
// chroma: a TH x CW tile of each plane; the chroma buffers' rows (halo
// 2) and pitch; the collocated luma's rows and pitch
#define CW (TW / 2)
#define CR (TH + 4)
#define CP (CW + 8)
#define CLR (2 * TH + 2)
#define CLP (TW + 8)
#define CBUF (2 * CR * CP + CLR * CLP)
// a chroma thread's run: runs per row, threads per plane
#define CRUNS (CW / 4)
#define CPLANE (TH * CRUNS)
// the chroma tables in shared memory: the alternatives' coefficients
// and clips (8 x 6 each), both components' CC-ALF coefficients (5 x 7)
#define CTAB (48 + 48 + 70)

#define L_SMEM (LBUF * 4)
#define C_SMEM ((CBUF + CTAB) * 4)

#define FULL 0xffffffffu

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
  int ntx, ntiles;     // tiles per row, tiles
  int vsrc, vdst;      // 16-byte copies from src / into dst
  int vtab;            // 8-byte reads of the banks
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
  int ntx, ntiles;
  int vsrc, vluma, vdst;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// clip(v - curr, -k, k), as the plain version's _clipf; nc = -curr, nk =
// -k (two instructions: Hopper's add-and-max, then the min)
__device__ __forceinline__ int clipd(int v, int nc, int nk, int k) {
  return min(max(v + nc, nk), k);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until every committed group has landed
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [oy, oy + R) x columns [ox, ox + C) of a plane (ox a multiple of
// 4), each position clamped to [0, h) x [0, w), into buf (pitch C): a
// chunk of 4 columns inside [0, w) as one 16-byte copy when vec, else 4
// copies of clamped positions
template <int R, int C>
__device__ __forceinline__ void load_rows(int* buf, const int* src,
                                          int pitch, int oy, int ox, int h,
                                          int w, bool vec) {
  constexpr int NC = C / 4;
  for (int i = threadIdx.x; i < R * NC; i += THREADS) {
    const int r = i / NC, c = i - r * NC;
    const int* row = src + (long long)clampi(oy + r, 0, h - 1) * pitch;
    const int gx = ox + 4 * c;
    int* d = buf + r * C + 4 * c;
    if (vec && gx >= 0 && gx + 4 <= w) {
      cp_async16(d, row + gx);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(d + j, row + clampi(gx + j, 0, w - 1));
    }
  }
}

// the padding ring of one plane, samples as they are: rows [0, H) x
// columns [W, Wp), then rows [H, Hp) whole (contiguous); every thread of
// the grid takes a stride of it, in 16-byte vectors when vec (src and
// dst 16-byte aligned, Wp a multiple of 4) and W is a multiple of 4
__device__ void copy_ring(const int* src, int* dst, int Hp, int Wp, int H,
                          int W, bool vec) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n = (long long)gridDim.x * THREADS;
  const int side = Wp - W;
  const long long tail = (long long)H * Wp;
  if (vec && !(W & 3)) {
    const int sv = side >> 2;
    const long long na = (long long)H * sv;
    const long long nb = ((long long)(Hp - H) * Wp) >> 2;
    for (long long i = t; i < na + nb; i += n) {
      const long long g = i < na ? (i / sv) * Wp + W + 4 * (i % sv)
                                 : tail + 4 * (i - na);
      *(int4*)(dst + g) = __ldg((const int4*)(src + g));
    }
  } else {
    const long long na = (long long)H * side;
    const long long nb = (long long)(Hp - H) * Wp;
    for (long long i = t; i < na + nb; i += n) {
      const long long g = i < na ? (i / side) * Wp + W + i % side
                                 : tail + (i - na);
      dst[g] = __ldg(src + g);
    }
  }
}

// words o .. o+3 (o .. o+1) of a row in shared memory into v[o ..]: the
// row 16-byte aligned, o a multiple of 4 (2)
__device__ __forceinline__ void lds4(int* v, const int* row, int o) {
  const int4 a = *(const int4*)(row + o);
  v[o] = a.x;
  v[o + 1] = a.y;
  v[o + 2] = a.z;
  v[o + 3] = a.w;
}

__device__ __forceinline__ void lds2(int* v, const int* row, int o) {
  const int2 a = *(const int2*)(row + o);
  v[o] = a.x;
  v[o + 1] = a.y;
}

// 12 int16 values of a bank row into v
__device__ __forceinline__ void ld_bank(int* v, const int16_t* p,
                                        bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint2 a = __ldg((const uint2*)p + i);
      v[4 * i] = (int)(short)(a.x & 0xffff);
      v[4 * i + 1] = (int)a.x >> 16;
      v[4 * i + 2] = (int)(short)(a.y & 0xffff);
      v[4 * i + 3] = (int)a.y >> 16;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = __ldg(p + i);
  }
}

// the transpose (alf_recon_coeff's transpose_idx tr = 2 dir_d + dir_hv)
// applied to a block's 12 values: position j takes value perm[tr][j] of
// the bank row, the permutation of dir_hv (sigma) then, with dir_d, the
// swaps (1 3) (4 8) (5 7): tr 1 = sigma, tr 2 = the swaps, tr 3 = both
__device__ __forceinline__ void transpose12(int* v, bool hv, bool d) {
  if (hv) {
    const int t0 = v[0], t1 = v[1], t2 = v[2], t3 = v[3], t4 = v[4],
              t6 = v[6], t8 = v[8], t9 = v[9], t10 = v[10], t11 = v[11];
    // sigma = {9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6}
    v[0] = t9; v[1] = t4; v[2] = t10; v[3] = t8; v[4] = t1;
    v[6] = t11; v[8] = t3; v[9] = t0; v[10] = t2; v[11] = t6;
  }
  if (d) {
    int t = v[1]; v[1] = v[3]; v[3] = t;
    t = v[4]; v[4] = v[8]; v[8] = t;
    t = v[5]; v[5] = v[7]; v[7] = t;
  }
}

// ---------------------------------------------------------------------
// luma
// ---------------------------------------------------------------------

__device__ __forceinline__ void load_luma_tile(int* buf, const LumaParams& p,
                                               int tile) {
  const int ty = tile / p.ntx, tx = tile - ty * p.ntx;
  load_rows<LR, LP>(buf, p.src, p.Wp, ty * TH - 3, tx * TW - 4, p.H, p.W,
                    p.vsrc);
}

// one tile: the thread's run of 4 samples of row y0 + 4 by + q, columns
// x0 + 4 bx .. + 3; buf: the tile's buffer
__device__ __forceinline__ void luma_tile(const LumaParams& p,
                                          const int* buf, int tile, int q,
                                          int by, int bx) {
  const int ty = tile / p.ntx, tx = tile - ty * p.ntx;
  const int yb = ty * TH + 4 * by, y = yb + q, x = tx * TW + 4 * bx;
  const bool inside = yb < p.H && x < p.W;
  const int ctb = 1 << p.ctb_log2, m = ctb - 1, vb = ctb - 4;
  // buffer column 4 bx is sample column x - 4: a thread's columns are
  // [4 bx, 4 bx + 12) of its rows
  const int* B = buf + 4 * bx;
  const int* C = B + (4 * by + q + 3) * LP;  // row y
  int on = 0, bank = 0;
  if (inside) {
    const int8_t* g = p.ctb + ((long long)(yb >> p.ctb_log2) * p.cbw
                               + (x >> p.ctb_log2)) * 8;
    on = g[0] > 0;
    // the host's banks are in range; an index past them takes the
    // nearest bank, as the JAX package's clamped gather does
    bank = clampi(g[1], 0, p.nbanks - 1);
  }
  int4 out = *(const int4*)(C + 4);
  if (__any_sync(FULL, on)) {
    // ---- classification: row q of the block's window (gradients on
    // rows r = yb - 3 + 2q, columns x - 2 + 2j; the virtual boundary's
    // substitutions s0 := s1, s3 := s2 by r % ctb), summed over the
    // window's rows by shuffles (rows cut at the virtual boundary) -----
    int sv = 0, sh = 0, sd0 = 0, sd1 = 0;
    {
      const int r = yb - 3 + 2 * q, lr = r & m, br = 4 * by + 2 * q;
      const int* R0 = B + (lr == ctb - 5 ? br + 1 : br) * LP;
      const int* R1 = B + (br + 1) * LP;
      const int* R2 = B + (br + 2) * LP;
      const int* R3 = B + (lr == ctb - 7 ? br + 2 : br + 3) * LP;
      int a[12], b[12], c[12], d[12];
      lds4(a, R0, 0); lds4(a, R0, 4); lds2(a, R0, 8);
      lds4(b, R1, 0); lds4(b, R1, 4); lds4(b, R1, 8);
      lds4(c, R2, 0); lds4(c, R2, 4); lds4(c, R2, 8);
      lds2(d, R3, 2); lds4(d, R3, 4); lds4(d, R3, 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 2 * j + 2;  // the position's column
        const int v0 = b[k] * 2;
        const int v1 = c[k + 1] * 2;
        sv += abs(v0 - a[k] - c[k]) + abs(v1 - b[k + 1] - d[k + 1]);
        sh += abs(v0 - b[k - 1] - b[k + 1]) + abs(v1 - c[k] - c[k + 2]);
        sd0 += abs(v0 - a[k - 1] - c[k + 1]) + abs(v1 - b[k] - d[k + 2]);
        sd1 += abs(v0 - a[k + 1] - c[k - 1]) + abs(v1 - b[k + 2] - d[k]);
      }
      const int ly = yb & m;
      const int start = ly == vb ? 1 : 0, end = ly == vb - 4 ? 3 : 4;
      if (q < start || q >= end) sv = sh = sd0 = sd1 = 0;
    }
#pragma unroll
    for (int o = 8; o <= 16; o <<= 1) {
      sv += __shfl_xor_sync(FULL, sv, o);
      sh += __shfl_xor_sync(FULL, sh, o);
      sd0 += __shfl_xor_sync(FULL, sd0, o);
      sd1 += __shfl_xor_sync(FULL, sd1, o);
    }
    if (on) {
      const int ly = yb & m;
      const int ac = (ly == vb || ly == vb - 4) ? 3 : 2;
      const bool dir_hv = sv <= sh, dir_d = sd0 <= sd1;
      const int hv1 = max(sv, sh), hv0 = min(sv, sh);
      const int d1 = max(sd0, sd1), d0 = min(sd0, sd1);
      // the products may pass 31 bits (alf_get_idx compares in 64)
      const bool dir1 = (long long)d1 * hv0 <= (long long)hv1 * d0;
      const int hvd1 = dir1 ? hv1 : d1, hvd0 = dir1 ? hv0 : d0;
      const int act = clampi(((sv + sh) * ac) >> (p.bd - 1), 0, 15);
      int cls = kArgVar[act];
      if (hvd1 * 2 > 9 * hvd0)
        cls += (dir1 * 2 + 2) * 5;
      else if (hvd1 > 2 * hvd0)
        cls += (dir1 * 2 + 1) * 5;
      // ---- the block's 12 transposed coefficients and clips --------
      int cf[12], kp[12];
      const long long o = ((long long)bank * 25 + cls) * 12;
      ld_bank(cf, p.coeff + o, p.vtab);
      ld_bank(kp, p.clipv + o, p.vtab);
      transpose12(cf, dir_hv, dir_d);
      transpose12(kp, dir_hv, dir_d);
      int nk[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) nk[j] = -kp[j];
      // ---- the 7x7 diamond on the thread's 4 samples; the row taps
      // collapse toward the row near the virtual boundary (_row_offsets)
      const int ly1 = y & m;
      const int e1 = (ly1 == vb - 1 || ly1 == vb) ? 0 : 1;
      const int e2 = (ly1 >= vb - 2 && ly1 <= vb + 1) ? e1 : 2;
      const int e3 = (ly1 >= vb - 3 && ly1 <= vb + 2) ? e2 : 3;
      int s[12], u[12], w[12];
      lds4(s, C, 0); lds4(s, C, 4); lds4(s, C, 8);
      int nc[4], tot[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nc[j] = -s[4 + j];
#define T2(t, va, vb_)                                             \
  cf[t] * (clipd(va, nc[j], nk[t], kp[t]) + clipd(vb_, nc[j], nk[t], kp[t]))
        tot[j] = T2(9, s[7 + j], s[1 + j]) + T2(10, s[6 + j], s[2 + j]) +
                 T2(11, s[5 + j], s[3 + j]);
      }
      const int* U = C + e1 * LP;
      const int* D = C - e1 * LP;
      lds2(u, U, 2); lds4(u, U, 4); lds2(u, U, 8);
      lds2(w, D, 2); lds4(w, D, 4); lds2(w, D, 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tot[j] += T2(4, u[6 + j], w[2 + j]) + T2(5, u[5 + j], w[3 + j]) +
                  T2(6, u[4 + j], w[4 + j]) + T2(7, u[3 + j], w[5 + j]) +
                  T2(8, u[2 + j], w[6 + j]);
      U = C + e2 * LP;
      D = C - e2 * LP;
      u[3] = U[3]; lds4(u, U, 4); u[8] = U[8];
      w[3] = D[3]; lds4(w, D, 4); w[8] = D[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tot[j] += T2(1, u[5 + j], w[3 + j]) + T2(2, u[4 + j], w[4 + j]) +
                  T2(3, u[3 + j], w[5 + j]);
      lds4(u, C + e3 * LP, 4);
      lds4(w, C - e3 * LP, 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[j] += T2(0, u[4 + j], w[4 + j]);
#undef T2
      const bool near = ly1 >= vb - 1 && ly1 <= vb;
      const int rnd = near ? 1 << 9 : 64, shift = near ? 10 : 7;
      const int maxv = (1 << p.bd) - 1;
      out.x = clampi(s[4] + ((tot[0] + rnd) >> shift), 0, maxv);
      out.y = clampi(s[5] + ((tot[1] + rnd) >> shift), 0, maxv);
      out.z = clampi(s[6] + ((tot[2] + rnd) >> shift), 0, maxv);
      out.w = clampi(s[7] + ((tot[3] + rnd) >> shift), 0, maxv);
    }
  }
  if (inside) {
    int* o = p.dst + (long long)y * p.Wp + x;
    if (p.vdst) {
      *(int4*)o = out;
    } else {
      o[0] = out.x;
      o[1] = out.y;
      o[2] = out.z;
      o[3] = out.w;
    }
  }
}

__global__ void __launch_bounds__(THREADS, MINB)
alf_luma_kernel(LumaParams p) {
  extern __shared__ __align__(16) int smem[];
  // the chroma launch after this one may start at once (it reads none
  // of this launch's output)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane >> 3;
  const int by = warp / (TW / 32), bx = (warp % (TW / 32)) * 8 + (lane & 7);
  copy_ring(p.src, p.dst, p.Hp, p.Wp, p.H, p.W, p.vsrc && p.vdst);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    load_luma_tile(smem, p, tile);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    luma_tile(p, smem, tile, q, by, bx);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// chroma
// ---------------------------------------------------------------------

__device__ __forceinline__ void load_chroma_tile(int* buf,
                                                 const ChromaParams& p,
                                                 int tile) {
  const int ty = tile / p.ntx, tx = tile - ty * p.ntx;
  const int y0 = ty * TH, x0 = tx * CW;
  load_rows<CR, CP>(buf, p.src[0], p.Wp, y0 - 2, x0 - 4, p.Hc, p.Wc,
                    p.vsrc);
  load_rows<CR, CP>(buf + CR * CP, p.src[1], p.Wp, y0 - 2, x0 - 4, p.Hc,
                    p.Wc, p.vsrc);
  load_rows<CLR, CLP>(buf + 2 * CR * CP, p.luma, p.Wl, 2 * y0 - 1,
                      2 * x0 - 4, p.H, p.W, p.vluma);
}

// one tile: the thread's run of 4 samples of plane pl, row y0 + ty,
// columns x0 + 4 rx .. + 3
__device__ __forceinline__ void chroma_tile(const ChromaParams& p,
                                            const int* buf, const int* tab,
                                            int tile, int pl, int ty,
                                            int rx) {
  const int t = tile / p.ntx, tx = tile - t * p.ntx;
  const int y = t * TH + ty, x = tx * CW + 4 * rx;
  if (y >= p.Hc || x >= p.Wc) return;
  const int c = pl + 1;
  const int lc = p.ctb_log2 - 1;  // log2 of the chroma CTB size
  const int8_t* g = p.ctb + ((long long)(y >> lc) * p.cbw + (x >> lc)) * 8;
  const int flag = g[2 * c], alt = g[2 * c + 1], idc = g[5 + c];
  // the thread's columns of its plane's buffer: [4 rx, 4 rx + 12), the
  // samples at 4 .. 7
  const int* S = buf + pl * CR * CP + (ty + 2) * CP + 4 * rx;
  int s[12];
  lds4(s, S, 4);
  int4 out = make_int4(s[4], s[5], s[6], s[7]);
  const int maxv = (1 << p.bd) - 1;
  if (flag > 0) {
    // an alternative outside 0..7 selects zero coefficients
    const bool known = alt >= 0 && alt < 8;
    const int a = known ? alt : 0;
    int cf[6], kp[6], nk[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      cf[j] = known ? tab[6 * a + j] : 0;
      kp[j] = known ? tab[48 + 6 * a + j] : 0;
      nk[j] = -kp[j];
    }
    const int mc = (1 << lc) - 1, vbc = (1 << lc) - 2;
    const int ly = y & mc;
    const int e1 = (ly == vbc - 1 || ly == vbc) ? 0 : 1;
    const int e2 = (ly >= vbc - 2 && ly <= vbc + 1) ? e1 : 2;
    lds2(s, S, 2); lds2(s, S, 8);
    int u[12], w[12], nc[4], tot[4];
#define T2(t, va, vb_)                                             \
  cf[t] * (clipd(va, nc[j], nk[t], kp[t]) + clipd(vb_, nc[j], nk[t], kp[t]))
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nc[j] = -s[4 + j];
      tot[j] = T2(4, s[6 + j], s[2 + j]) + T2(5, s[5 + j], s[3 + j]);
    }
    const int* U = S + e1 * CP;
    const int* D = S - e1 * CP;
    u[3] = U[3]; lds4(u, U, 4); u[8] = U[8];
    w[3] = D[3]; lds4(w, D, 4); w[8] = D[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tot[j] += T2(1, u[5 + j], w[3 + j]) + T2(2, u[4 + j], w[4 + j]) +
                T2(3, u[3 + j], w[5 + j]);
    lds4(u, S + e2 * CP, 4);
    lds4(w, S - e2 * CP, 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[j] += T2(0, u[4 + j], w[4 + j]);
#undef T2
    const bool near = ly >= vbc - 1 && ly <= vbc;
    const int rnd = near ? 1 << 9 : 64, shift = near ? 10 : 7;
    out.x = clampi(s[4] + ((tot[0] + rnd) >> shift), 0, maxv);
    out.y = clampi(s[5] + ((tot[1] + rnd) >> shift), 0, maxv);
    out.z = clampi(s[6] + ((tot[2] + rnd) >> shift), 0, maxv);
    out.w = clampi(s[7] + ((tot[3] + rnd) >> shift), 0, maxv);
  }
  if (idc > 0) {
    // CC-ALF: 7 taps of the pre-ALF luma around the collocated sample
    // (alf_filter_cc); an index past 4 selects zero coefficients
    const bool known = idc < 5;
    const int a = known ? idc : 0;
    int wt[7];
#pragma unroll
    for (int j = 0; j < 7; ++j)
      wt[j] = known ? tab[96 + 35 * pl + 7 * a + j] : 0;
    const int ctb = 1 << p.ctb_log2, m = ctb - 1, vb = ctb - 4;
    const int pos = (2 * y) & m;
    const bool sub_all = pos == vb - 1 || pos == vb;
    const bool sub_s3 = pos == vb - 2 || pos == vb + 1;
    const int r1 = sub_all ? 0 : 1, rm1 = sub_all ? 0 : -1;
    const int r2 = sub_all ? 0 : (sub_s3 ? r1 : 2);
    // luma row 2y is buffer row 2 ty + 1; the thread's columns [8 rx, 8
    // rx + 12), sample j's collocated column at 4 + 2j
    const int* L = buf + 2 * CR * CP + (2 * ty + 1) * CLP + 8 * rx;
    int l0[12], l1[12], lm[12], l2[12];
    l0[3] = L[3]; lds4(l0, L, 4); lds4(l0, L, 8);
    const int* L1 = L + r1 * CLP;
    l1[3] = L1[3]; lds4(l1, L1, 4); lds4(l1, L1, 8);
    lds4(lm, L + rm1 * CLP, 4); lds4(lm, L + rm1 * CLP, 8);
    lds4(l2, L + r2 * CLP, 4); lds4(l2, L + r2 * CLP, 8);
    const int half = 1 << (p.bd - 1);
    int o[4] = {out.x, out.y, out.z, out.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 + 2 * j, ce = l0[k];
      const int total = wt[0] * (lm[k] - ce) + wt[1] * (l0[k - 1] - ce) +
                        wt[2] * (l0[k + 1] - ce) + wt[3] * (l1[k - 1] - ce) +
                        wt[4] * (l1[k] - ce) + wt[5] * (l1[k + 1] - ce) +
                        wt[6] * (l2[k] - ce);
      o[j] = clampi(o[j] + clampi((total + 64) >> 7, -half, half - 1), 0,
                    maxv);
    }
    out = make_int4(o[0], o[1], o[2], o[3]);
  }
  int* d = p.dst + ((long long)pl * p.Hp + y) * p.Wp + x;
  if (p.vdst && x + 4 <= p.Wc) {
    *(int4*)d = out;
  } else {
    // a run that crosses the picture's right edge writes its picture
    // samples (the ring copy writes the rest)
    const int n = min(4, p.Wc - x);
    d[0] = out.x;
    if (n > 1) d[1] = out.y;
    if (n > 2) d[2] = out.z;
    if (n > 3) d[3] = out.w;
  }
}

__global__ void __launch_bounds__(THREADS, MINB)
alf_chroma_kernel(ChromaParams p) {
  extern __shared__ __align__(16) int smem[];
  int* const tab = smem + CBUF;
  const int pl = threadIdx.x / CPLANE, r = threadIdx.x - pl * CPLANE;
  const int ty = r / CRUNS, rx = r - ty * CRUNS;
  for (int i = threadIdx.x; i < CTAB; i += THREADS)
    tab[i] = i < 48 ? p.ccoeff[i] : i < 96 ? p.cclipv[i - 48] : p.cc[i - 96];
  copy_ring(p.src[0], p.dst, p.Hp, p.Wp, p.Hc, p.Wc, p.vsrc && p.vdst);
  copy_ring(p.src[1], p.dst + (long long)p.Hp * p.Wp, p.Hp, p.Wp, p.Hc,
            p.Wc, p.vsrc && p.vdst);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    load_chroma_tile(smem, p, tile);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    chroma_tile(p, smem, tab, tile, pl, ty, rx);
    __syncthreads();
  }
  // complete only after the launch this one may overlap
  if (blockIdx.x == 0 && threadIdx.x == 0)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

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

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The launch's geometry: out[0] tiles, out[1] blocks (the resident blocks
// the card holds, at most the tiles; max_blocks > 0 caps them instead),
// out[2] resident blocks per SM, out[3] dynamic shared bytes, out[4] SMs,
// out[5] threads per block.  Returns a cudaError_t.
extern "C" int alf_plan(int chroma, int H, int W, int max_blocks, int* out) {
  // per device (the first 32) and kernel, once: its SMs and resident
  // blocks per SM
  static int known[32][2][2];
  const int smem = chroma ? C_SMEM : L_SMEM;
  int dev = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return (int)c;
  int sms = dev < 32 ? known[dev][chroma][0] : 0;
  int per = dev < 32 ? known[dev][chroma][1] : 0;
  if (!sms) {
    unsigned configured = 0;
    int e = chroma ? configure(alf_chroma_kernel, smem, &configured)
                   : configure(alf_luma_kernel, smem, &configured);
    if (e) return e;
    c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (c == cudaSuccess)
      c = chroma ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per, alf_chroma_kernel, THREADS, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per, alf_luma_kernel, THREADS, smem);
    if (c != cudaSuccess) return (int)c;
    if (dev < 32) {
      known[dev][chroma][0] = sms;
      known[dev][chroma][1] = per;
    }
  }
  const int h = chroma ? H >> 1 : H, w = chroma ? W >> 1 : W;
  const int tw = chroma ? CW : TW;
  const long long tiles =
      (long long)((h + TH - 1) / TH) * ((w + tw - 1) / tw);
  const long long cap = max_blocks > 0 ? max_blocks
                                       : (long long)(per > 0 ? per : 1) * sms;
  out[0] = (int)tiles;
  out[1] = (int)(tiles < cap ? tiles : cap);
  out[2] = per;
  out[3] = smem;
  out[4] = sms;
  out[5] = THREADS;
  return 0;
}

// flags: bit 0, the launch may start while the launch before it on the
// stream runs (programmatic stream serialization; chroma only); bit 1,
// 4-byte copies only
#define F_OVERLAP 1
#define F_SCALAR 2

// One luma plane.  src, dst: (Hp, Wp) int32, dst written whole; H, W:
// the cropped picture (multiples of 4); ctb: the (cbh, cbw, 8) int8
// per-CTB grid covering it; coeff, clipv: (nbanks, 25, 12) int16;
// max_blocks: 0, or a cap on the grid (the persistent grid otherwise).
extern "C" int alf_luma_launch(const int* src, int* dst, int Hp, int Wp,
                               int H, int W, const int8_t* ctb, int cbh,
                               int cbw, const int16_t* coeff,
                               const int16_t* clipv, int nbanks,
                               int ctb_log2, int bit_depth, int max_blocks,
                               int flags, void* stream) {
  if (!src || !dst || !ctb || !coeff || !clipv || H < 4 || W < 4 || H % 4
      || W % 4 || H > Hp || W > Wp || nbanks < 1 || ctb_log2 < 5
      || ctb_log2 > 7 || bit_depth < 8 || bit_depth > 12 || max_blocks < 0
      || ((long long)cbh << ctb_log2) < H || ((long long)cbw << ctb_log2) < W)
    return (int)cudaErrorInvalidValue;
  int plan[6];
  int e = alf_plan(0, H, W, max_blocks, plan);
  if (e) return e;
  const bool vec = !(flags & F_SCALAR) && Wp % 4 == 0;
  LumaParams p{src, dst, Hp, Wp, H, W, ctb, cbw, coeff, clipv, nbanks,
               ctb_log2, bit_depth, (W + TW - 1) / TW, plan[0],
               vec && aligned16(src), vec && aligned16(dst),
               ((uintptr_t)coeff & 7) == 0 && ((uintptr_t)clipv & 7) == 0};
  alf_luma_kernel<<<plan[1], THREADS, L_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The Cb and Cr planes.  src: 2 pointers to (Hp, Wp) int32 planes; dst:
// (2, Hp, Wp) int32, written whole; luma: the pre-ALF (Hl, Wl) padded
// luma plane; H, W: the cropped luma picture (chroma H/2 x W/2);
// ccoeff, cclipv: (8, 6) int16; cc: (2, 5, 7) int16; flags: F_OVERLAP
// only when the caller queued the luma launch whose input is `luma`
// just before this one on the stream (the frame program's pair).
extern "C" int alf_chroma_launch(const long long* src, int* dst, int Hp,
                                 int Wp, const int* luma, int Hl, int Wl,
                                 int H, int W, const int8_t* ctb, int cbh,
                                 int cbw, const int16_t* ccoeff,
                                 const int16_t* cclipv, const int16_t* cc,
                                 int ctb_log2, int bit_depth, int max_blocks,
                                 int flags, void* stream) {
  if (!src || !src[0] || !src[1] || !dst || !luma || !ctb || !ccoeff
      || !cclipv || !cc || H < 8 || W < 8 || H % 4 || W % 4 || H > Hl
      || W > Wl || (H >> 1) > Hp || (W >> 1) > Wp || ctb_log2 < 5
      || ctb_log2 > 7 || bit_depth < 8 || bit_depth > 12 || max_blocks < 0
      || ((long long)cbh << ctb_log2) < H || ((long long)cbw << ctb_log2) < W)
    return (int)cudaErrorInvalidValue;
  int plan[6];
  int e = alf_plan(1, H, W, max_blocks, plan);
  if (e) return e;
  const int* s0 = (const int*)src[0];
  const int* s1 = (const int*)src[1];
  const bool vec = !(flags & F_SCALAR);
  ChromaParams p{{s0, s1}, dst, Hp, Wp, H >> 1, W >> 1, luma, Wl, H, W,
                 ctb, cbw, ccoeff, cclipv, cc, ctb_log2, bit_depth,
                 ((W >> 1) + CW - 1) / CW, plan[0],
                 vec && Wp % 4 == 0 && aligned16(s0) && aligned16(s1),
                 vec && Wl % 4 == 0 && aligned16(luma),
                 vec && Wp % 4 == 0 && aligned16(dst)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan[1]);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = (flags & F_OVERLAP) ? 1 : 0;
  const cudaError_t c = cudaLaunchKernelEx(&cfg, alf_chroma_kernel, p);
  return (int)(c != cudaSuccess ? c : cudaGetLastError());
}

extern "C" const char* alf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
