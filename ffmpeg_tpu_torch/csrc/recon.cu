// Reconstruction of one plane kind (luma, or Cb+Cr) for Hopper.
//
// Replaces the TPU Pallas kernel ffmpeg_tpu/ops/recon_pallas.py
// (recon_plane_pallas, body _build_kernel): the same control rows in,
// the same reconstructed plane out, bit for bit.  Its oracle is the
// plain torch version in ffmpeg_tpu_torch/ops/recon.py
// (recon_plane_plain), itself a port of the JAX frame program's
// _recon_plane.
//
// Design: two plain (non-cooperative) launches per plane kind per frame,
// each sized to the card (blocks per SM x SMs), with no grid barrier.
//
//  1. place_kernel.  One warp per work item, the warps striding over the
//     items: first each (pure inter unit, channel) of the MC batch, whose
//     samples clip(tile + residual) over the unit's (h, w) the warp's
//     lanes write row by row (the int16 tiles of models/vvc/mc_tiles.py,
//     written by csrc/inter_pred.cu);
//     then each intra unit, whose cell x cell cells the warp marks
//     pending (1) in every channel's readiness map.  The cell is 2
//     samples, or 1 where a unit is not 2-aligned (ISP's 1- and 2-sample
//     sub-partitions; ops/recon.py readiness_cell), so that every unit
//     covers whole cells and each cell has one writer.  The wrapper zeroes
//     the maps, so every cell no intra unit writes is ready from the
//     start.  Stream order makes the placed samples and the marks visible
//     to launch 2.
//
//  2. wave_kernel, a dataflow wavefront.  Each warp loops: it takes the
//     next ticket t from a global atomic counter; t is (unit t / nch,
//     channel t % nch) in the intra layout's order, which is chunk order
//     and so topological: every sample a unit reads was written by the
//     placement or by a unit of a strictly earlier chunk.  The warp
//     prefetches what depends on no other unit (the control row, the
//     residual block, CCLM's collocated luma block and its four boundary
//     luma picks, or CIIP's MC tile),
//     then waits for exactly the cells it reads (wait_rects: the top run
//     on rows y0-1-mrl .. y0-1, the left run, the corner when
//     cand_up_left is set; twin of ops/recon.py _wait_rects and of
//     decode.cc's chunk stencil), reconstructs the unit and publishes its
//     cells as ready (0) in its channel's map.  Cb and Cr have their own
//     maps, so a Cr unit never waits on Cb cells.
//
// Memory order.  Publishing: every lane stores its samples with
// st.global.cg; the warp runs __syncwarp, so that every lane's stores
// precede every lane's fence; each lane runs fence.acq_rel.gpu and then
// writes its share of the flags with relaxed gpu-scope stores (the PTX
// release pattern: a fence followed by a strong store; the fence is
// cumulative over the stores the __syncwarp ordered before it).  Waiting:
// the lanes poll the
// cells with relaxed gpu-scope loads, vote with __all_sync, back off with
// __nanosleep, and once all are ready each lane runs fence.acq_rel.gpu
// (the acquire pattern) and the warp __syncwarp; the edge loads that
// follow are ld.global.cg, so no stale L1 line is read.
//
// Why it cannot deadlock.  A warp waits only for units with smaller
// tickets of its channel (their chunks are earlier).  A ticket is taken
// only by a warp that is running, and that warp holds it until the unit
// is published.  So the lowest ticket not yet published never waits: its
// writers are all published.  Progress never needs the whole grid to be
// resident, and no warp waits for another warp of its block.
//
// One warp per unit.  The unit's edge vectors (L = 5*maxs+16), its
// residual block and an auxiliary block (CCLM's luma, CIIP's tile, or
// MIP's reduced prediction and upsampling rows) live in the warp's slice
// of shared memory; each lane builds L/32 edge entries and predicts
// w*h/32 samples; __syncwarp replaces __syncthreads; the DC sums and
// MIP's boundary sums are warp reductions, CCLM's model is computed by
// every lane in registers.
//
// Units of 64 a side (the luma of frames with 64-sample transform blocks
// or CIIP units above 32: maxs 64) run in a second instance of the
// wavefront kernel, wave_kernel<64>, which the launch picks for such a
// call; it is the same code over the same tickets, so the argument above
// holds as it is.  Staging a 64x64 unit's residual and CIIP block whole
// would take 32 KB a warp and leave one block per SM, so a unit above 32
// a side is staged and reconstructed a 32x32 quarter at a time through
// the same buffers as in wave_kernel<32> (the first quarter before the
// wait, the others as the warp reaches them, each load batch in flight
// together); only its edge vectors are longer.  That is 13.8 KB a warp,
// 3 warps a block, against 11.3 KB and 4 in wave_kernel<32>, which frames
// without 64-sample units keep.  A CIIP unit above 32 a side has its MC
// prediction in 32x32 MC rows, one per quarter (models/vvc/mc_tiles.py
// split_rows).
//
// What bounds it on this card: not bytes (a frame moves a few tens of
// MB) and not operations, but latency — the critical path of the
// dependency levels (ops/recon.py dependency_levels) times the latency of
// one unit (ticket, poll, dependent edge loads, prediction, stores and
// fence, flag store).  The TPU-layout machinery of the Pallas kernel
// (one-hot MXU matmuls, Toeplitz windows, 40x256 store windows, SMEM
// segmenting) has no counterpart: indexed loads from shared memory
// replace it.
//
// Build (at first use, ffmpeg_tpu_torch/utils/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
//        -Xcompiler -fPIC -o _build/librecon.so recon.cu

#include <cuda_runtime.h>

#define PLACE_THREADS 256
#define FULL 0xffffffffu
// a wait longer than this means a writer that never comes (a layout that
// broke its topological order): trap rather than hang the card
#define WAIT_LIMIT_NS 2000000000ull

// control rows, in the order of INTRA_KEYS (models/vvc/inputs.py)
enum {
  k_x0, k_y0, k_w, k_h, k_logw, k_logh, k_mode_class, k_angle, k_inv_angle,
  k_filter_flag, k_smooth, k_left_size, k_top_size, k_unfilter_last_one,
  k_do_pdpc, k_nscale, k_avail_l, k_avail_t, k_cand_up_left, k_proj_v,
  k_proj_h, k_pf, k_m0x, k_m0y, k_m1x, k_m1y, k_r0slot, k_r1slot, k_wden,
  k_w0, k_w1, k_wo0, k_wo1, k_hpel, k_ciipw, k_hyp0lx, k_hyp1lx, k_mip_id,
  k_mip_t, k_mip_sz, k_cclm, k_cclm_vc, k_cclm_ct, k_cclm_cl, k_cclm_p0,
  k_cclm_p1, k_cclm_p2, k_cclm_p3, k_mrl,
  NUM_KEYS
};

// mode classes (ops/intra.py, models/vvc/recon.py)
enum { MC_PLANAR, MC_DC, MC_VERT, MC_HORZ, MC_ANG_V, MC_ANG_H, MC_INTER,
       MC_MIP, MC_CCLM };

struct Params {
  const int* ctrl;   // (NUM_KEYS, ucap) intra layout
  int ucap, n_units;
  const int* ictrl;  // (NUM_INTER_KEYS, n_mc) MC batch; x0, y0, w, h first
  int n_mc, n_inter;
  const short* tiles;  // (nch, T) MC prediction samples, unit u's w * h
                       // row-major at toff[u] (models/vvc/mc_tiles.py)
  const int* toff;   // (n_mc + 1,)
  long long T;
  const int* ipos;   // (ucap,) row of a CIIP unit in the MC batch
  const int* res;    // (nch, Hp, Wp) residual
  int* plane;        // (nch, Hp, Wp) output, pre-filled with mid grey
  int Hp, Wp;
  const int* dsy;    // (Hd, Wd) downsampled luma, or null (no CCLM)
  int Hd, Wd;
  const int* luma;   // (Hl, Wl) reconstructed luma plane, or null
  int Hl, Wl;
  const int* lfilt;  // (2, 32, 4) luma interpolation filter
  const int* mip;    // (30, 64, 8) MIP matrix bank
  const int* div;    // (16,) CCLM division significands
  int maxs, is_chroma, bd;
  int nch;
  int cl2;           // log2 of the readiness cell edge (0 or 1)
  int* ready;        // (nch, Hc, Wc) readiness maps: 0 ready, 1 pending
  int* ticket;       // next wavefront ticket
  int Hc, Wc;        // map shape: Hp >> cl2, Wp >> cl2
};

// a unit is reconstructed a quarter of at most QE x QE samples at a time:
// the whole unit when it is at most 32 a side, else its 32x32 quarters.
// QE is mc_tiles.MC_TILE: a CIIP unit's quarter is one of its MC rows.
#define QE 32

// the warp's slice of shared memory for units of at most MX a side
template <int MX>
struct WarpSmem {
  static constexpr int L = 5 * MX + 16;  // edge vector length at MX
  static constexpr int WARPS = MX > 32 ? 3 : 4;  // warps per block
  int c[64];                            // control row
  int e[4][L];                          // edge vectors: left, top, scratch
  int res[QE * QE];  // the quarter's residual, row stride its width
  int aux[QE * QE];  // CCLM luma block | CIIP tile quarter (stride the
                     // quarter's width) | MIP upsampling rows [0, 8 * MX)
                     // + reduced prediction [8 * MX, 8 * MX + 64)
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// XLA shift semantics (the JAX reference): out-of-range amounts give 0
// (left) or the sign fill (right) instead of undefined behaviour
__device__ __forceinline__ int shl(int a, int s) {
  return (s < 0 || s >= 32) ? 0 : (int)((unsigned)a << s);
}
__device__ __forceinline__ int shr(int a, int s) {
  return (s < 0 || s >= 32) ? (a < 0 ? -1 : 0) : (a >> s);
}

__device__ __forceinline__ int ilog2(int v) {  // v a power of two > 0
  return v > 0 ? 31 - __clz(v) : 0;
}

// the JAX reference's CCLM log2 saturates at 11
__device__ __forceinline__ int cclm_log2(int v) {
  int acc = 0;
  for (int k = 1; k < 12; ++k) acc += v >= (1 << k);
  return acc;
}

// ---- readiness flags ----------------------------------------------------

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Rect { int y0, y1, x0, x1; };  // half-open cell ranges

// The cells a unit reads before it builds its edges: the top run [x0, x0
// + avail_t) on rows y0-1-r .. y0-1, the left run [y0, y0 + avail_l) on
// columns x0-1-r .. x0-1, and the corner when cand_up_left is set.  Twin
// of ops/recon.py _wait_rects (and decode.cc's chunk stencil): change the
// three together.  Returns the number of rects.
__device__ int wait_rects(const int* c, int r, int s, Rect* out) {
  const int x0 = c[k_x0], y0 = c[k_y0];
  const int avl = c[k_avail_l], avt = c[k_avail_t];
  const int yt = max(0, (y0 - 1 - r) >> s), xl = max(0, (x0 - 1 - r) >> s);
  int n = 0;
  if (avt > 0)
    out[n++] = {yt, ((y0 - 1) >> s) + 1, x0 >> s, ((x0 + avt - 1) >> s) + 1};
  if (avl > 0)
    out[n++] = {y0 >> s, ((y0 + avl - 1) >> s) + 1, xl, ((x0 - 1) >> s) + 1};
  if (c[k_cand_up_left] > 0 && x0 > 0 && y0 > 0)
    out[n++] = {yt, ((y0 - 1) >> s) + 1, xl, ((x0 - 1) >> s) + 1};
  return n;
}

// the warp waits until every cell of the unit's stencil is ready
__device__ void wait_ready(const Params& p, const int* c, const int* map,
                           int lane) {
  const int r = p.is_chroma ? 0 : c[k_mrl];
  Rect rc[3];
  const int nr = wait_rects(c, r, p.cl2, rc);
  int cnt[3], total = 0;
  for (int q = 0; q < nr; ++q) {
    cnt[q] = (rc[q].y1 - rc[q].y0) * (rc[q].x1 - rc[q].x0);
    total += cnt[q];
  }
  const unsigned long long t0 = now_ns();
  for (int ns = 32;; ns = min(2 * ns, 256)) {
    bool ok = true;
    for (int k = lane; k < total; k += 32) {  // loads in flight together
      int q = 0, kk = k;
      while (kk >= cnt[q]) kk -= cnt[q++];
      const int wq = rc[q].x1 - rc[q].x0;
      const int cy = rc[q].y0 + kk / wq, cx = rc[q].x0 + kk % wq;
      ok &= ld_relaxed(map + cy * p.Wc + cx) == 0;
    }
    if (__all_sync(FULL, ok)) break;
    __nanosleep(ns);
    if (now_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
  fence_acq_rel();  // acquire: the writers' samples before the edge loads
  __syncwarp();
}

// ---- per-unit preparation ---------------------------------------------

template <int LMAX>
__device__ void build_edges(const Params& p, const int* c, int* eL, int* eT,
                            const int* plane, int L, int OFF, int mid,
                            int lane) {
  const int x0 = c[k_x0], y0 = c[k_y0];
  const int r = p.is_chroma ? 0 : c[k_mrl];
  const int avl = c[k_avail_l], avt = c[k_avail_t], cul = c[k_cand_up_left];
  const int H = p.Hp, W = p.Wp;
  const int top_iy = clampi(y0 - 1 - r, 0, H - 1);
  const int left_ix = clampi(x0 - 1 - r, 0, W - 1);
  const int top0 = __ldcg(plane + top_iy * W + clampi(x0, 0, W - 1));
  const int left0 = __ldcg(plane + clampi(y0, 0, H - 1) * W + left_ix);
  const int fallback = avl > 0 ? left0 : (avt > 0 ? top0 : mid);
  const int top_m1 =
      cul > 0 ? __ldcg(plane + top_iy * W + clampi(x0 - 1, 0, W - 1))
              : fallback;
  const int left_m1 =
      cul > 0 ? __ldcg(plane + clampi(y0 - 1, 0, H - 1) * W + left_ix)
              : fallback;
#pragma unroll
  for (int i = lane; i < LMAX; i += 32) {  // every load in flight at once
    if (i >= L) break;
    const int j = i - OFF;
    const int neg = max(min(j, -1), -1 - r);
    const int joff = j >= 0 ? min(j, avt - 1) : neg;
    const int top_raw =
        __ldcg(plane + top_iy * W + clampi(x0 + joff, 0, W - 1));
    const int joff_l = j >= 0 ? min(j, avl - 1) : neg;
    const int left_raw =
        __ldcg(plane + clampi(y0 + joff_l, 0, H - 1) * W + left_ix);
    eT[i] = j >= 0 ? (avt > 0 ? top_raw : top_m1)
                   : (cul > 0 ? top_raw : fallback);
    eL[i] = j >= 0 ? (avl > 0 ? left_raw : left_m1)
                   : (cul > 0 ? left_raw : fallback);
  }
}

// [1 2 1] reference smoothing into (tL, tT); neighbours wrap at the
// vector ends, as the JAX reference's rolled vectors do
__device__ void filter_edges(const int* c, const int* eL, const int* eT,
                             int* tL, int* tT, int L, int OFF, int lane) {
  const int nl = c[k_left_size] - c[k_unfilter_last_one];
  const int nt = c[k_top_size] - c[k_unfilter_last_one];
  for (int i = lane; i < L; i += 32) {
    const int j = i - OFF;
    const int im = (i + L - 1) % L, ip = (i + 1) % L;
    const int fl = (eL[im] + 2 * eL[i] + eL[ip] + 2) >> 2;
    const int ft = (eT[im] + 2 * eT[i] + eT[ip] + 2) >> 2;
    int lo = (j >= 0 && j < nl) ? fl : eL[i];
    int to = (j >= 0 && j < nt) ? ft : eT[i];
    if (i == OFF - 1) {
      const int corner = (eL[OFF] + 2 * eL[OFF - 1] + eT[OFF] + 2) >> 2;
      lo = corner;
      to = corner;
    }
    tL[i] = lo;
    tT[i] = to;
  }
}

// negative-angle projection of `src` into the negative lanes of `dst`,
// written to `out`
__device__ void project(const int* dst, const int* src, int* out, int L,
                        int OFF, int inv, int limit, int r, int lane) {
  for (int i = lane; i < L; i += 32) {
    const int t = i - OFF;
    const int xx = t + 1 + r;
    const int sidx = OFF - 1 - r + min(shr(xx * inv + 256, 9), limit);
    const int proj = src[clampi(sidx, 0, L - 1)];
    const bool sel = t >= -limit - 1 - r && t <= -2 - r;
    out[i] = sel ? proj : dst[i];
  }
}

// MIP: boundary reduction (warp sums), the 64 x 8 matrix product and the
// horizontal upsampling over the 8 reduced rows (mip_upsampling_1d), rows
// of stride MX in aux, the reduced prediction at aux + 8 * MX
template <int MX>
__device__ void mip_prepare(const Params& p, const int* c, const int* eL,
                            const int* eT, int* aux, int OFF, int maxv,
                            int mid, int lane) {
  const int w = c[k_w], h = c[k_h], sz = c[k_mip_sz];
  const int bsz = sz == 0 ? 2 : 4;
  const int ps = sz == 2 ? 8 : 4;
  const int maxs = p.maxs;
  const int in_size = sz == 0 ? 4 : (sz == 2 ? 7 : 8);
  int red[2][4];
  for (int side = 0; side < 2; ++side) {
    const int n = side == 0 ? w : h;
    const int* e = side == 0 ? eT : eL;
    const int ratio = n / bsz;
    const int lg = ilog2(ratio);
    for (int g = 0; g < 4; ++g) {
      int sum = 0;  // the lane's samples of group g
      for (int i = lane; i < MX; i += 32)
        sum += i < n && shr(i, lg) == g ? e[OFF + i] : 0;
      red[side][g] = shr(__reduce_add_sync(FULL, sum) + (ratio >> 1), lg);
    }
  }
  const int* first = c[k_mip_t] > 0 ? red[1] : red[0];
  const int* second = c[k_mip_t] > 0 ? red[0] : red[1];
  int r8[8];
  for (int i = 0; i < 8; ++i)
    r8[i] = i < bsz ? first[clampi(i, 0, 3)] : second[clampi(i - bsz, 0, 3)];
  const int temp0 = r8[0];
  int v[8], sum = 0;
  for (int i = 0; i < 8; ++i) {
    int vi = sz == 2 ? r8[clampi(i + 1, 0, 7)] - temp0
                     : (i == 0 ? mid - temp0 : r8[i] - temp0);
    vi = i < in_size ? vi : 0;
    v[i] = vi;
    sum += vi;
  }
  const int ow = 32 - 32 * sum;
  int* predv = aux + 8 * MX;
  for (int i = lane; i < 64; i += 32) {
    const int* m = p.mip + (clampi(c[k_mip_id], 0, 29) * 64 + i) * 8;
    int acc = 0;
    for (int k = 0; k < 8; ++k) acc += __ldg(m + k) * v[k];
    predv[i] = clampi(shr(acc + ow, 6) + temp0, 0, maxv);
  }
  __syncwarp();
  const int uh = w / ps, uv = h / ps;
  const int lg_h = ilog2(uh);
  const bool tr = c[k_mip_t] > 0;
  for (int i = lane; i < 8 * maxs; i += 32) {
    const int yr = i / maxs, x = i % maxs;
    const int k = shr(x, lg_h);
    const int dx = (x & (uh - 1)) + 1;
    auto p8 = [&](int a, int b) {  // reduced grid, transposed layout aware
      return tr ? predv[clampi(b * ps + a, 0, 63)]
                : predv[clampi(a * ps + b, 0, 63)];
    };
    const int brow = eL[OFF + clampi((yr + 1) * uv - 1, 0, maxs - 1)];
    const int pa = k == 0 ? brow : p8(yr, clampi(k - 1, 0, 7));
    const int pb = p8(yr, clampi(k, 0, 7));
    aux[yr * MX + x] = shr((uh - dx) * pa + dx * pb + (uh >> 1), lg_h);
  }
}

// one of a CCLM unit's four downsampled boundary luma picks, i < 4 (top
// picks first); ops/intra.py cclm_select_luma.  cclm_vc carries the
// flags: bit 0 vertical collocation, 1 the block starts a CTU row (the
// line buffer's single-row top filter), 2 and 3 luma availability left
// and top.
__device__ int cclm_pick(const Params& p, const int* c, int i) {
  const int H = p.Hl, W = p.Wl;
  auto at = [&](int yy, int xx) {
    return __ldg(p.luma + clampi(yy, 0, H - 1) * W + clampi(xx, 0, W - 1));
  };
  const int vcf = c[k_cclm_vc];
  const int vc = vcf & 1, b_ctu = (vcf >> 1) & 1;
  const int pos = c[k_cclm_p0 + i];
  const int lx0 = 2 * c[k_x0], ly0 = 2 * c[k_y0];
  if (i < c[k_cclm_ct]) {
    const int xa = lx0 + 2 * pos;
    const bool hl = 2 * pos > 0 || ((vcf >> 2) & 1);
    const int lt_r1 = at(ly0 - 1, hl ? xa - 1 : xa);
    if (b_ctu)
      return (lt_r1 + 2 * at(ly0 - 1, xa) + at(ly0 - 1, xa + 1) + 2) >> 2;
    const int lt_r2 = at(ly0 - 2, hl ? xa - 1 : xa);
    if (vc)
      return (at(ly0 - 3, xa) + lt_r2 + 4 * at(ly0 - 2, xa)
              + at(ly0 - 2, xa + 1) + at(ly0 - 1, xa) + 4) >> 3;
    return (lt_r2 + lt_r1 + 2 * (at(ly0 - 2, xa) + at(ly0 - 1, xa))
            + at(ly0 - 2, xa + 1) + at(ly0 - 1, xa + 1) + 4) >> 3;
  }
  const int ya = ly0 + 2 * pos;
  if (vc) {
    const bool ht = 2 * pos > 0 || ((vcf >> 3) & 1);
    return (at(ya, lx0 - 3) + at(ht ? ya - 1 : ya, lx0 - 2)
            + 4 * at(ya, lx0 - 2) + at(ya, lx0 - 1) + at(ya + 1, lx0 - 2)
            + 4) >> 3;
  }
  return (at(ya, lx0 - 3) + at(ya + 1, lx0 - 3)
          + 2 * (at(ya, lx0 - 2) + at(ya + 1, lx0 - 2)) + at(ya, lx0 - 1)
          + at(ya + 1, lx0 - 1) + 4) >> 3;
}

struct Cclm { int a, k, b; };

// CCLM model from the four boundary picks; every lane computes it
__device__ Cclm cclm_model(const Params& p, const int* c, const int* eL,
                           const int* eT, const int* sl_in, int L, int OFF,
                           int mid) {
  const int cnt_t = c[k_cclm_ct];
  const int n_sel = cnt_t + c[k_cclm_cl];
  int sl[4], sc[4];
  for (int i = 0; i < 4; ++i) {
    const int pos = clampi(OFF + c[k_cclm_p0 + i], 0, L - 1);
    sl[i] = sl_in[i];
    sc[i] = i < cnt_t ? eT[pos] : eL[pos];
  }
  if (n_sel == 2) {  // [s0, s1] -> [s1, s0, s1, s0]
    const int l0 = sl[0], l1 = sl[1], c0 = sc[0], c1 = sc[1];
    sl[0] = l1; sl[1] = l0; sl[2] = l1; sl[3] = l0;
    sc[0] = c1; sc[1] = c0; sc[2] = c1; sc[3] = c0;
  }
  // 4-element min/max network, payload swapped in lockstep
  int mi0l = sl[0], mi0c = sc[0], mi1l = sl[2], mi1c = sc[2];
  int ma0l = sl[1], ma0c = sc[1], ma1l = sl[3], ma1c = sc[3];
  int t;
#define SWAP(a, b) (t = a, a = b, b = t)
  if (mi0l > mi1l) { SWAP(mi0l, mi1l); SWAP(mi0c, mi1c); }
  if (ma0l > ma1l) { SWAP(ma0l, ma1l); SWAP(ma0c, ma1c); }
  if (mi0l > ma1l) {
    SWAP(mi0l, ma0l); SWAP(mi0c, ma0c);
    SWAP(mi1l, ma1l); SWAP(mi1c, ma1c);
  }
  if (mi1l > ma0l) { SWAP(mi1l, ma0l); SWAP(mi1c, ma0c); }
#undef SWAP
  const int max_l = (ma0l + ma1l + 1) >> 1, min_l = (mi0l + mi1l + 1) >> 1;
  const int max_c = (ma0c + ma1c + 1) >> 1, min_c = (mi0c + mi1c + 1) >> 1;
  const int diff = max_l - min_l, diffc = max_c - min_c;
  int x = cclm_log2(max(diff, 1));
  const int norm_diff = shr(shl(diff, 4), x) & 15;
  x += norm_diff != 0;
  const int absc = abs(diffc);
  const int y = absc > 0 ? cclm_log2(max(absc, 1)) + 1 : 0;
  const int vdiv = __ldg(p.div + norm_diff) | 8;
  const int add = shl(1, y) >> 1;
  int a = shr(diffc * vdiv + add, y);
  int k = max(1, 3 + x - y);
  if (3 + x - y < 1) a = ((a > 0) - (a < 0)) * 15;
  int b = min_c - shr(a * min_l, k);
  if (diff == 0) { a = 0; k = 0; b = min_c; }
  if (n_sel == 0) { a = 0; k = 0; b = mid; }
  return {a, k, b};
}

// ---- per-sample prediction --------------------------------------------

__device__ int ang_core(const Params& p, const int* c, const int* main, int i,
                        int col, int L, int OFF, int maxv, int r) {
  const int pos = (i + 1 + r) * c[k_angle];
  const int idx = pos >> 5;
  const int fact = pos & 31;
  const int base = OFF + col + idx;
  int q[4];
  for (int k = 0; k < 4; ++k) q[k] = main[clampi(base + k - 1, 0, L - 1)];
  if (p.is_chroma)
    return fact == 0 ? q[1] : ((32 - fact) * q[1] + fact * q[2] + 16) >> 5;
  const int ff = c[k_filter_flag];
  if (fact == 0 && ff == 0) return q[1];
  const int* f = p.lfilt + (clampi(ff, 0, 1) * 32 + fact) * 4;
  const int acc = (__ldg(f) * q[0] + __ldg(f + 1) * q[1] + __ldg(f + 2) * q[2]
                   + __ldg(f + 3) * q[3] + 32) >> 6;
  return clampi(acc, 0, maxv);
}

template <int MX>
__device__ int predict(const Params& p, const int* c, const int* eL,
                       const int* eT, const int* aux, int idx, int y, int x,
                       int L, int OFF, int maxv, int dc, Cclm cm) {
  const int w = c[k_w], h = c[k_h];
  const int logw = c[k_logw], logh = c[k_logh];
  const int mc = c[k_mode_class];
  const int pdpc = c[k_do_pdpc], ns = c[k_nscale], inv = c[k_inv_angle];
  const int r = p.is_chroma ? 0 : c[k_mrl];
  int pred = 0;
  switch (mc) {
    case MC_PLANAR: {
      const int t = eT[OFF + x], l = eL[OFF + y];
      const int tr = eT[OFF + w], bl = eL[OFF + h];
      const int pv = shl((h - 1 - y) * t + (y + 1) * bl, logw);
      const int ph = shl((w - 1 - x) * l + (x + 1) * tr, logh);
      pred = shr(pv + ph + w * h, logw + logh + 1);
      break;
    }
    case MC_DC:
      pred = dc;
      break;
    case MC_VERT:
      pred = eT[OFF + x];
      break;
    case MC_HORZ:
      pred = eL[OFF + y];
      break;
    case MC_ANG_V: {
      pred = ang_core(p, c, eT, y, x, L, OFF, maxv, r);
      if (pdpc > 0) {
        const int inv_sum = 256 + inv * (x + 1);
        const int lv = eL[clampi(OFF + y + shr(inv_sum, 9), 0, L - 1)];
        const int wl = shr(32, min(shr(x << 1, ns), 31));
        const int val = clampi(pred + shr((lv - pred) * wl + 32, 6), 0, maxv);
        if (x < min(w, shl(3, ns))) pred = val;
      }
      break;
    }
    case MC_ANG_H: {
      pred = ang_core(p, c, eL, x, y, L, OFF, maxv, r);
      if (pdpc > 0) {
        const int inv_sum = 256 + inv * (y + 1);
        const int tv = eT[clampi(OFF + x + shr(inv_sum, 9), 0, L - 1)];
        const int wt = shr(32, min(shr(y * 2, ns), 31));
        const int val = clampi(pred + shr((tv - pred) * wt + 32, 6), 0, maxv);
        if (y < min(h, shl(3, ns))) pred = val;
      }
      break;
    }
    case MC_MIP: {
      const int ps = c[k_mip_sz] == 2 ? 8 : 4;
      const int uv = h / ps;
      const int lg_v = ilog2(uv);
      const int ky = shr(y, lg_v);
      const int dy = (y & (uv - 1)) + 1;
      const int ca = ky == 0 ? eT[OFF + x]
                             : aux[clampi(ky - 1, 0, 7) * MX + x];
      const int cb = aux[clampi(ky, 0, 7) * MX + x];
      pred = shr((uv - dy) * ca + dy * cb + (uv >> 1), lg_v);
      break;
    }
    case MC_CCLM:
      pred = clampi(shr(aux[idx] * cm.a, cm.k) + cm.b, 0, maxv);
      break;
    default:
      break;  // MC_INTER units are placed, never in the intra layout
  }
  if (pdpc > 0 && mc < MC_ANG_V) {  // PDPC for planar/DC/V/H
    const int scale = (logw + logh - 2) >> 2;
    const bool is_vh = mc == MC_VERT || mc == MC_HORZ;
    const int lv = eL[OFF + y], tv = eT[OFF + x];
    const int lq = is_vh ? lv - eL[OFF - 1] + pred : lv;
    const int tq = is_vh ? tv - eT[OFF - 1] + pred : tv;
    const int wl = mc == MC_HORZ ? 0 : shr(32, min(shr(x << 1, scale), 31));
    const int wt = mc == MC_VERT ? 0 : shr(32, min(shr(y << 1, scale), 31));
    pred = clampi(pred + shr(wl * (lq - pred) + wt * (tq - pred) + 32, 6), 0,
                  maxv);
  }
  return pred;
}

// ---- one intra unit, one warp -------------------------------------------

template <int MX>
__device__ void recon_unit(const Params& p, WarpSmem<MX>& sm, int u, int ch,
                           int lane) {
  const size_t hw = (size_t)p.Hp * p.Wp;
  int* plane = p.plane + ch * hw;
  int* map = p.ready + (size_t)ch * p.Hc * p.Wc;
  const int maxs = p.maxs;
  const int L = 5 * maxs + 16, OFF = 2 * maxs + 8;
  const int maxv = (1 << p.bd) - 1, mid = 1 << (p.bd - 1);
  int* c = sm.c;

  for (int k = lane; k < NUM_KEYS; k += 32)
    c[k] = __ldg(p.ctrl + k * p.ucap + u);
  __syncwarp();
  const int x0 = c[k_x0], y0 = c[k_y0], w = c[k_w], h = c[k_h];
  if (w <= 0) return;
  const int mc = c[k_mode_class], cw = c[k_ciipw];
  const int* res = p.res + ch * hw + y0 * p.Wp + x0;
  const short* tiles = p.tiles + (size_t)ch * p.T;
  const int first = cw > 0 ? __ldg(p.ipos + u) : 0;
  // the quarters, row-major: nqx across; a unit of at most QE a side is
  // one quarter (always in the 32-edge instance)
  const int nqx = MX > QE ? (w + QE - 1) / QE : 1;
  const int nq = MX > QE ? nqx * ((h + QE - 1) / QE) : 1;

  // stage quarter q: its residual and CIIP's MC samples (a CIIP unit
  // above QE a side has one MC row per quarter, mc_tiles.py split_rows);
  // 0 outside the MC unit
  auto stage = [&](int q, int qx, int qy, int qw, int qh, int lqw) {
    const int* r = res + qy * p.Wp + qx;
#pragma unroll 4
    for (int k = lane; k < qw * qh; k += 32)
      sm.res[k] = __ldg(r + (k >> lqw) * p.Wp + (k & (qw - 1)));
    if (cw > 0) {
      const int m = clampi(first + q, 0, p.n_mc - 1);
      const int mw = __ldg(p.ictrl + 2 * p.n_mc + m);
      const int mh = __ldg(p.ictrl + 3 * p.n_mc + m);
      const short* tile = tiles + __ldg(p.toff + m);
#pragma unroll 4
      for (int k = lane; k < qw * qh; k += 32) {
        const int y = k >> lqw, x = k & (qw - 1);
        sm.aux[k] = y < mh && x < mw ? __ldg(tile + y * mw + x) : 0;
      }
    }
  };

  // prefetch what depends on no other unit: the control row, the first
  // quarter's residual and CIIP tile, CCLM's luma block and picks
  const int qw0 = min(w, QE), qh0 = min(h, QE);
  stage(0, 0, 0, qw0, qh0, ilog2(qw0));
  if (mc == MC_CCLM) {  // chroma: one quarter, row stride w
    // lax.dynamic_slice semantics: the window start clamps into the plane
    const int ys = clampi(y0, 0, p.Hd - maxs), xs = clampi(x0, 0, p.Wd - maxs);
    const int* blk = p.dsy + ys * p.Wd + xs;
    const int lw = c[k_logw];
#pragma unroll 4
    for (int k = lane; k < w * h; k += 32)
      sm.aux[k] = __ldg(blk + (k >> lw) * p.Wd + (k & (w - 1)));
  }
  int sl[4];
  if (mc == MC_CCLM) {
    const int pick = lane < 4 ? cclm_pick(p, c, lane) : 0;
    for (int i = 0; i < 4; ++i) sl[i] = __shfl_sync(FULL, pick, i);
  }

  wait_ready(p, c, map, lane);

  int *eL = sm.e[0], *eT = sm.e[1], *tL = sm.e[2], *tT = sm.e[3], *sw;
  const int r = p.is_chroma ? 0 : c[k_mrl];
  build_edges<WarpSmem<MX>::L>(p, c, eL, eT, plane, L, OFF, mid, lane);
  __syncwarp();
  if (c[k_smooth] > 0) {
    filter_edges(c, eL, eT, tL, tT, L, OFF, lane);
    __syncwarp();
    sw = eL; eL = tL; tL = sw;
    sw = eT; eT = tT; tT = sw;
  }
  if (c[k_proj_v] > 0) {
    project(eT, eL, tT, L, OFF, c[k_inv_angle], h, r, lane);
    __syncwarp();
    sw = eT; eT = tT; tT = sw;
  }
  if (c[k_proj_h] > 0) {
    project(eL, eT, tL, L, OFF, c[k_inv_angle], w, r, lane);
    __syncwarp();
    sw = eL; eL = tL; tL = sw;
  }

  int dc = 0;
  Cclm cm{0, 0, 0};
  if (mc == MC_DC) {
    int st = 0, sl_ = 0;  // the lane's top and left samples
    for (int i = lane; i < MX; i += 32) {
      st += i < w ? eT[OFF + i] : 0;
      sl_ += i < h ? eL[OFF + i] : 0;
    }
    const int sum_t = __reduce_add_sync(FULL, st);
    const int sum_l = __reduce_add_sync(FULL, sl_);
    const int sum = (w >= h ? sum_t : 0) + (w <= h ? sum_l : 0);
    const int offset = max(w == h ? w << 1 : max(w, h), 1);
    dc = shr(sum + (offset >> 1), ilog2(offset));
  } else if (mc == MC_MIP) {
    mip_prepare<MX>(p, c, eL, eT, sm.aux, OFF, maxv, mid, lane);
    __syncwarp();
  } else if (mc == MC_CCLM) {
    cm = cclm_model(p, c, eL, eT, sl, L, OFF, mid);
  }

  for (int q = 0; q < nq; ++q) {
    const int qx = (q % nqx) * QE, qy = (q / nqx) * QE;
    const int qw = min(w - qx, QE), qh = min(h - qy, QE), lqw = ilog2(qw);
    if (q > 0) {
      __syncwarp();  // every lane is done with the previous quarter
      stage(q, qx, qy, qw, qh, lqw);
      __syncwarp();
    }
    for (int k = lane; k < qw * qh; k += 32) {
      const int y = qy + (k >> lqw), x = qx + (k & (qw - 1));
      int pred = predict<MX>(p, c, eL, eT, sm.aux, k, y, x, L, OFF, maxv, dc,
                             cm);
      if (cw > 0)  // CIIP blend (put_ciip, vvc_inter_template.c:60-76)
        pred = (pred * cw + sm.aux[k] * (4 - cw) + 2) >> 2;
      __stcg(plane + (y0 + y) * p.Wp + x0 + x,
             clampi(pred + sm.res[k], 0, maxv));
    }
  }

  // publish (release): __syncwarp orders every lane's sample stores before
  // each lane's fence, and the fence orders them before its flag stores
  __syncwarp();
  fence_acq_rel();
  const int cw_ = w >> p.cl2, nc = cw_ * (h >> p.cl2);
  int* cells = map + (y0 >> p.cl2) * p.Wc + (x0 >> p.cl2);
  for (int k = lane; k < nc; k += 32)
    st_relaxed(cells + (k / cw_) * p.Wc + k % cw_, 0);
}

template <int MX>
__global__ void __launch_bounds__(WarpSmem<MX>::WARPS * 32, 4)
    wave_kernel(Params p) {
  __shared__ WarpSmem<MX> smem[WarpSmem<MX>::WARPS];
  WarpSmem<MX>& sm = smem[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int n_tickets = p.n_units * p.nch;
  for (;;) {
    __syncwarp();  // the previous unit's shared memory is no longer read
    int t = 0;
    if (lane == 0) t = atomicAdd(p.ticket, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= n_tickets) break;
    const int u = t / p.nch;
    recon_unit<MX>(p, sm, u, t - u * p.nch, lane);
  }
}

// placement of the pure inter units, clip(tile + residual) over each
// unit's (h, w), and the pending marks of the intra units' cells.  The
// pure inter units are the MC batch's rows [0, n_inter); the CIIP units'
// rows follow from n_inter on, and the wavefront blends their tiles,
// found through ipos.
__global__ void __launch_bounds__(PLACE_THREADS) place_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const int n_place = p.n_inter * p.nch;
  const int n_items = n_place + p.n_units;
  const int maxv = (1 << p.bd) - 1;
  const size_t hw = (size_t)p.Hp * p.Wp;
  for (int it = warp; it < n_items; it += n_warps) {
    if (it < n_place) {
      const int u = it / p.nch, ch = it - u * p.nch;
      const int x0 = __ldg(p.ictrl + 0 * p.n_mc + u);
      const int y0 = __ldg(p.ictrl + 1 * p.n_mc + u);
      const int w = __ldg(p.ictrl + 2 * p.n_mc + u);
      const int h = __ldg(p.ictrl + 3 * p.n_mc + u);
      const short* tile = p.tiles + (size_t)ch * p.T + __ldg(p.toff + u);
      const int* res = p.res + ch * hw + y0 * p.Wp + x0;
      int* plane = p.plane + ch * hw + y0 * p.Wp + x0;
#pragma unroll 4
      for (int k = lane; k < w * h; k += 32) {
        const int y = k / w, x = k - y * w;
        __stcg(plane + y * p.Wp + x,
               clampi(__ldg(tile + k) + __ldg(res + y * p.Wp + x), 0, maxv));
      }
    } else {
      const int u = it - n_place;
      const int x0 = __ldg(p.ctrl + k_x0 * p.ucap + u);
      const int y0 = __ldg(p.ctrl + k_y0 * p.ucap + u);
      const int cw = __ldg(p.ctrl + k_w * p.ucap + u) >> p.cl2;
      const int nc = cw * (__ldg(p.ctrl + k_h * p.ucap + u) >> p.cl2);
      for (int ch = 0; ch < p.nch; ++ch) {
        int* cells = p.ready + (size_t)ch * p.Hc * p.Wc
                     + (y0 >> p.cl2) * p.Wc + (x0 >> p.cl2);
        for (int k = lane; k < nc; k += 32) cells[(k / cw) * p.Wc + k % cw] = 1;
      }
    }
  }
}

// blocks for one launch: as many as the card holds at once, no more than
// the work needs
static cudaError_t grid_for(const void* kernel, int threads, long items,
                            int items_per_block, int* grid) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return e;
  const long need = (items + items_per_block - 1) / items_per_block;
  *grid = (int)(need < (long)sms * per_sm ? need : (long)sms * per_sm);
  return cudaSuccess;
}

// stage 0: place_kernel; stage 1: wave_kernel, its 64-edge instance when
// maxs > 32 (luma only).  cell is the readiness cell edge, 1 or 2
// (ops/recon.py readiness_cell); scratch holds the nch readiness maps of
// (Hp / cell) x (Wp / cell) cells, zeroed, then the ticket counter,
// zeroed.
extern "C" int recon_launch(
    const int* ctrl, int num_keys, int ucap, int n_units, const int* ictrl,
    int num_inter_keys, int n_mc, int n_inter, const short* tiles,
    const int* toff, long long T, const int* ipos, const int* res,
    int* plane, int nch, int Hp, int Wp,
    const int* dsy, int Hd, int Wd, const int* luma, int Hl, int Wl,
    const int* lfilt,
    const int* mip, const int* div, int maxs, int is_chroma, int bit_depth,
    int cell, int* scratch, int stage, void* stream) {
  if (num_keys != NUM_KEYS || num_inter_keys < 4 || maxs < 1 || maxs > 64
      || (maxs > 32 && is_chroma) || nch < 1 || n_units < 0
      || n_units > ucap || n_inter < 0 || n_inter > n_mc
      || (n_mc > 0 && (!tiles || !toff)) || T < 0 || (cell != 1 && cell != 2)
      || Hp % cell || Wp % cell || !scratch || stage < 0 || stage > 1)
    return (int)cudaErrorInvalidValue;
  const int cl2 = cell == 2, Hc = Hp >> cl2, Wc = Wp >> cl2;
  Params p{ctrl, ucap, n_units, ictrl, n_mc, n_inter, tiles, toff, T, ipos,
           res, plane, Hp, Wp, dsy, Hd, Wd, luma, Hl, Wl, lfilt, mip, div, maxs,
           is_chroma, bit_depth, nch, cl2, scratch,
           scratch + (size_t)nch * Hc * Wc, Hc, Wc};
  const long items = stage == 0 ? (long)n_inter * nch + n_units
                                : (long)n_units * nch;
  if (items == 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t e;
  if (stage == 0) {
    e = grid_for((const void*)place_kernel, PLACE_THREADS, items,
                 PLACE_THREADS / 32, &grid);
    if (e == cudaSuccess)
      place_kernel<<<grid, PLACE_THREADS, 0, (cudaStream_t)stream>>>(p);
  } else {
    const bool big = maxs > 32;
    const int warps = big ? WarpSmem<64>::WARPS : WarpSmem<32>::WARPS;
    e = grid_for(big ? (const void*)wave_kernel<64>
                     : (const void*)wave_kernel<32>,
                 warps * 32, items, warps, &grid);
    if (e == cudaSuccess && big)
      wave_kernel<64><<<grid, warps * 32, 0, (cudaStream_t)stream>>>(p);
    else if (e == cudaSuccess)
      wave_kernel<32><<<grid, warps * 32, 0, (cudaStream_t)stream>>>(p);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* recon_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
