// Reconstruction of one plane kind (luma, or Cb+Cr) for Hopper.
//
// Replaces the TPU Pallas kernel ffmpeg_tpu/ops/recon_pallas.py
// (recon_plane_pallas, body _build_kernel): the same control rows in,
// the same reconstructed plane out, bit for bit.  Its oracle is the
// plain torch version in ffmpeg_tpu_torch/ops/recon.py
// (recon_plane_plain), itself a port of the JAX frame program's
// _recon_plane.
//
// Design.  One cooperative launch per plane kind per frame.  Block
// (b, ch) works on channel ch, 1024 threads, one per sample of a 32x32
// tile.
//  - Placement phase: the blocks of a channel stride over the pure
//    inter units of the MC batch and write clip(tile + residual), the
//    tiles coming from the inter-prediction kernel (csrc/inter_pred.cu).
//    A grid-wide barrier follows.
//  - Intra phase: the intra units come in wavefront chunks of at most
//    CHUNK_CAP mutually independent units (chunk s = units [ioff[s],
//    iend[s]) of the intra layout); every sample a unit reads was
//    written by the placement or a strictly earlier chunk.  Block b
//    reconstructs unit ioff[s] + b; a grid-wide barrier separates
//    chunks.  CIIP units blend their intra prediction with their MC tile
//    (found through ipos) as (pred * w + tile * (4 - w) + 2) >> 2.
// The plane lives in device memory (a 1080p int32 luma plane is 10 MB
// and stays in the 50 MB L2); plane loads and stores go through L2 only
// (ld.global.cg / st.global.cg), so a block never reads a stale L1 line
// of a sample another SM wrote before a barrier.  A unit's reference
// edges are built in shared memory; MIP's reduced prediction and the
// CCLM model are computed once per unit in shared memory.  The
// TPU-layout machinery of the Pallas kernel (one-hot MXU matmuls,
// Toeplitz windows, 40x256 store windows, SMEM segmenting) has no
// counterpart: indexed loads from shared memory replace it.
//
// What bounds it on this card: not bytes (each frame moves a few tens
// of MB) and not operations, but latency — the number of sequential
// chunks times the latency of one unit (its barriers and dependent
// loads), plus one grid barrier per chunk.  Only CHUNK_CAP x nch of the
// 132 SMs are busy.  Warp-level edge building, fewer barriers per unit
// and wgmma/TMA for the residual transform are later work.
//
// Build (at first use, ffmpeg_tpu_torch/utils/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
//        -Xcompiler -fPIC -o _build/librecon.so recon.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define CHUNK_CAP 32
#define MAXS 32               // largest unit dimension
#define LMAX (5 * MAXS + 16)  // edge vector length at MAXS
#define TILE 32               // MC tile edge (MC_TILE)

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
  const int* ctrl;   // (NUM_KEYS, ucap)
  int ucap;
  const int* ioff;   // (n_chunks,)
  const int* iend;
  int n_chunks;
  const int* ictrl;  // (NUM_INTER_KEYS, n_mc) MC batch; x0, y0, w, h first
  int n_mc, n_inter;
  const int* tiles;  // (n_mc, nch, TILE, TILE) MC prediction tiles
  const int* ipos;   // (ucap,) row of a CIIP unit in the MC batch
  const int* res;    // (nch, Hp, Wp) residual
  int* plane;        // (nch, Hp, Wp) output, pre-filled with mid grey
  int Hp, Wp;
  const int* dsy;    // (Hd, Wd) downsampled luma, or null (no CCLM)
  int Hd, Wd;
  const int* sel;    // (4, ucap) CCLM boundary luma picks, or null
  const int* lfilt;  // (2, 32, 4) luma interpolation filter
  const int* mip;    // (30, 64, 8) MIP matrix bank
  const int* div;    // (16,) CCLM division significands
  int maxs, is_chroma, bd;
  int nch;
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

__device__ __forceinline__ int cclm_log2(int v) {  // saturates at 11
  int acc = 0;
  for (int k = 1; k < 12; ++k) acc += v >= (1 << k);
  return acc;
}

struct Shared {
  int c[NUM_KEYS];
  int eL[LMAX], eT[LMAX];  // left / top reference edges
  int tL[LMAX], tT[LMAX];  // scratch for the in-place edge passes
  int predv[64];           // MIP reduced prediction
  int tmp[8 * MAXS];       // MIP horizontal upsampling
  int v[8];                // MIP input vector
  int misc[8];             // dc | mip ow, temp0 | cclm a, k, b
};

// ---- per-unit preparation ---------------------------------------------

__device__ void build_edges(const Params& p, Shared& s, const int* plane,
                            int L, int OFF, int mid) {
  const int* c = s.c;
  const int x0 = c[k_x0], y0 = c[k_y0];
  const int r = p.is_chroma ? 0 : c[k_mrl];
  const int avl = c[k_avail_l], avt = c[k_avail_t], cul = c[k_cand_up_left];
  const int H = p.Hp, W = p.Wp;
  const int i = threadIdx.x;
  if (i >= L) return;
  const int j = i - OFF;
  const int neg = max(min(j, -1), -1 - r);
  const int joff = j >= 0 ? min(j, avt - 1) : neg;
  const int top_iy = clampi(y0 - 1 - r, 0, H - 1);
  const int top_raw = __ldcg(plane + top_iy * W + clampi(x0 + joff, 0, W - 1));
  const int joff_l = j >= 0 ? min(j, avl - 1) : neg;
  const int left_ix = clampi(x0 - 1 - r, 0, W - 1);
  const int left_raw =
      __ldcg(plane + clampi(y0 + joff_l, 0, H - 1) * W + left_ix);
  const int top0 = __ldcg(plane + top_iy * W + clampi(x0, 0, W - 1));
  const int left0 = __ldcg(plane + clampi(y0, 0, H - 1) * W + left_ix);
  const int fallback = avl > 0 ? left0 : (avt > 0 ? top0 : mid);
  const int top_m1 =
      cul > 0 ? __ldcg(plane + top_iy * W + clampi(x0 - 1, 0, W - 1))
              : fallback;
  const int left_m1 =
      cul > 0 ? __ldcg(plane + clampi(y0 - 1, 0, H - 1) * W + left_ix)
              : fallback;
  s.eT[i] = j >= 0 ? (avt > 0 ? top_raw : top_m1)
                   : (cul > 0 ? top_raw : fallback);
  s.eL[i] = j >= 0 ? (avl > 0 ? left_raw : left_m1)
                   : (cul > 0 ? left_raw : fallback);
}

// [1 2 1] reference smoothing; neighbours wrap at the vector ends
__device__ void filter_edges(Shared& s, int L, int OFF) {
  const int* c = s.c;
  const int i = threadIdx.x;
  if (i < L) {
    const int j = i - OFF;
    const int im = (i + L - 1) % L, ip = (i + 1) % L;
    const int nl = c[k_left_size] - c[k_unfilter_last_one];
    const int nt = c[k_top_size] - c[k_unfilter_last_one];
    const int fl = (s.eL[im] + 2 * s.eL[i] + s.eL[ip] + 2) >> 2;
    const int ft = (s.eT[im] + 2 * s.eT[i] + s.eT[ip] + 2) >> 2;
    int lo = (j >= 0 && j < nl) ? fl : s.eL[i];
    int to = (j >= 0 && j < nt) ? ft : s.eT[i];
    if (i == OFF - 1) {
      const int corner = (s.eL[OFF] + 2 * s.eL[OFF - 1] + s.eT[OFF] + 2) >> 2;
      lo = corner;
      to = corner;
    }
    s.tL[i] = lo;
    s.tT[i] = to;
  }
  __syncthreads();
  if (i < L) {
    s.eL[i] = s.tL[i];
    s.eT[i] = s.tT[i];
  }
  __syncthreads();
}

// negative-angle projection of `src` into the negative lanes of `dst`
__device__ void project(int* dst, const int* src, int* tmp, int L, int OFF,
                        int inv, int limit, int r) {
  const int i = threadIdx.x;
  if (i < L) {
    const int t = i - OFF;
    const int xx = t + 1 + r;
    const int sidx = OFF - 1 - r + min(shr(xx * inv + 256, 9), limit);
    const int proj = src[clampi(sidx, 0, L - 1)];
    const bool sel = t >= -limit - 1 - r && t <= -2 - r;
    tmp[i] = sel ? proj : dst[i];
  }
  __syncthreads();
  if (i < L) dst[i] = tmp[i];
  __syncthreads();
}

__device__ void mip_prepare(const Params& p, Shared& s, int OFF, int maxv,
                            int mid) {
  const int* c = s.c;
  const int w = c[k_w], h = c[k_h], sz = c[k_mip_sz];
  const int bsz = sz == 0 ? 2 : 4;
  const int ps = sz == 2 ? 8 : 4;
  const int maxs = p.maxs;
  if (threadIdx.x == 0) {
    const int in_size = sz == 0 ? 4 : (sz == 2 ? 7 : 8);
    int red[2][4];
    for (int side = 0; side < 2; ++side) {
      const int* vals = side == 0 ? s.eT + OFF : s.eL + OFF;
      const int n = side == 0 ? w : h;
      const int ratio = n / bsz;
      const int lg = ilog2(ratio);
      for (int g = 0; g < 4; ++g) {
        int sum = 0;
        for (int jj = 0; jj < maxs; ++jj)
          if (jj < n && shr(jj, lg) == g) sum += vals[jj];
        red[side][g] = shr(sum + (ratio >> 1), lg);
      }
    }
    const int* first = c[k_mip_t] > 0 ? red[1] : red[0];
    const int* second = c[k_mip_t] > 0 ? red[0] : red[1];
    int r8[8];
    for (int i = 0; i < 8; ++i)
      r8[i] = i < bsz ? first[clampi(i, 0, 3)] : second[clampi(i - bsz, 0, 3)];
    const int temp0 = r8[0];
    int sum = 0;
    for (int i = 0; i < 8; ++i) {
      int v = sz == 2 ? r8[clampi(i + 1, 0, 7)] - temp0
                      : (i == 0 ? mid - temp0 : r8[i] - temp0);
      v = i < in_size ? v : 0;
      s.v[i] = v;
      sum += v;
    }
    s.misc[1] = 32 - 32 * sum;  // ow
    s.misc[2] = temp0;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < 64) {
    const int* m = p.mip + (clampi(c[k_mip_id], 0, 29) * 64 + i) * 8;
    int acc = 0;
    for (int k = 0; k < 8; ++k) acc += m[k] * s.v[k];
    s.predv[i] = clampi(shr(acc + s.misc[1], 6) + s.misc[2], 0, maxv);
  }
  __syncthreads();
  // horizontal upsampling over the 8 reduced rows (mip_upsampling_1d)
  if (i < 8 * maxs) {
    const int yr = i / maxs, x = i % maxs;
    const int uh = w / ps, uv = h / ps;
    const int lg_h = ilog2(uh);
    const int k = shr(x, lg_h);
    const int dx = (x & (uh - 1)) + 1;
    const bool tr = c[k_mip_t] > 0;
    auto p8 = [&](int a, int b) {  // reduced grid, transposed layout aware
      return tr ? s.predv[clampi(b * ps + a, 0, 63)]
                : s.predv[clampi(a * ps + b, 0, 63)];
    };
    const int brow = s.eL[OFF + clampi((yr + 1) * uv - 1, 0, maxs - 1)];
    const int pa = k == 0 ? brow : p8(yr, clampi(k - 1, 0, 7));
    const int pb = p8(yr, clampi(k, 0, 7));
    s.tmp[yr * MAXS + x] = shr((uh - dx) * pa + dx * pb + (uh >> 1), lg_h);
  }
  __syncthreads();
}

__device__ void cclm_prepare(const Params& p, Shared& s, int u, int L,
                             int OFF, int mid) {
  if (threadIdx.x != 0) return;
  const int* c = s.c;
  const int cnt_t = c[k_cclm_ct];
  const int n_sel = cnt_t + c[k_cclm_cl];
  int sl[4], sc[4];
  for (int i = 0; i < 4; ++i) {
    const int pos = clampi(OFF + c[k_cclm_p0 + i], 0, L - 1);
    sl[i] = p.sel[i * p.ucap + u];
    sc[i] = i < cnt_t ? s.eT[pos] : s.eL[pos];
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
  const int vdiv = p.div[norm_diff] | 8;
  const int add = shl(1, y) >> 1;
  int a = shr(diffc * vdiv + add, y);
  int k = max(1, 3 + x - y);
  if (3 + x - y < 1) a = ((a > 0) - (a < 0)) * 15;
  int b = min_c - shr(a * min_l, k);
  if (diff == 0) { a = 0; k = 0; b = min_c; }
  if (n_sel == 0) { a = 0; k = 0; b = mid; }
  s.misc[3] = a;
  s.misc[4] = k;
  s.misc[5] = b;
}

// ---- per-sample prediction --------------------------------------------

__device__ int ang_core(const Params& p, const Shared& s, const int* main,
                        int i, int col, int L, int OFF, int maxv, int r) {
  const int pos = (i + 1 + r) * s.c[k_angle];
  const int idx = pos >> 5;
  const int fact = pos & 31;
  const int base = OFF + col + idx;
  int q[4];
  for (int k = 0; k < 4; ++k) q[k] = main[clampi(base + k - 1, 0, L - 1)];
  if (p.is_chroma)
    return fact == 0 ? q[1] : ((32 - fact) * q[1] + fact * q[2] + 16) >> 5;
  const int ff = s.c[k_filter_flag];
  if (fact == 0 && ff == 0) return q[1];
  const int* f = p.lfilt + (clampi(ff, 0, 1) * 32 + fact) * 4;
  const int acc = (f[0] * q[0] + f[1] * q[1] + f[2] * q[2] + f[3] * q[3] + 32) >> 6;
  return clampi(acc, 0, maxv);
}

__device__ int predict(const Params& p, const Shared& s, int y, int x, int L,
                       int OFF, int maxv) {
  const int* c = s.c;
  const int w = c[k_w], h = c[k_h];
  const int logw = c[k_logw], logh = c[k_logh];
  const int mc = c[k_mode_class];
  const int pdpc = c[k_do_pdpc], ns = c[k_nscale], inv = c[k_inv_angle];
  const int r = p.is_chroma ? 0 : c[k_mrl];
  int pred = 0;
  switch (mc) {
    case MC_PLANAR: {
      const int t = s.eT[OFF + x], l = s.eL[OFF + y];
      const int tr = s.eT[OFF + w], bl = s.eL[OFF + h];
      const int pv = shl((h - 1 - y) * t + (y + 1) * bl, logw);
      const int ph = shl((w - 1 - x) * l + (x + 1) * tr, logh);
      pred = shr(pv + ph + w * h, logw + logh + 1);
      break;
    }
    case MC_DC:
      pred = s.misc[0];
      break;
    case MC_VERT:
      pred = s.eT[OFF + x];
      break;
    case MC_HORZ:
      pred = s.eL[OFF + y];
      break;
    case MC_ANG_V: {
      pred = ang_core(p, s, s.eT, y, x, L, OFF, maxv, r);
      if (pdpc > 0) {
        const int inv_sum = 256 + inv * (x + 1);
        const int lv = s.eL[clampi(OFF + y + shr(inv_sum, 9), 0, L - 1)];
        const int wl = shr(32, min(shr(x << 1, ns), 31));
        const int val = clampi(pred + shr((lv - pred) * wl + 32, 6), 0, maxv);
        if (x < min(w, shl(3, ns))) pred = val;
      }
      break;
    }
    case MC_ANG_H: {
      pred = ang_core(p, s, s.eL, x, y, L, OFF, maxv, r);
      if (pdpc > 0) {
        const int inv_sum = 256 + inv * (y + 1);
        const int tv = s.eT[clampi(OFF + x + shr(inv_sum, 9), 0, L - 1)];
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
      const int ca = ky == 0 ? s.eT[OFF + x]
                             : s.tmp[clampi(ky - 1, 0, 7) * MAXS + x];
      const int cb = s.tmp[clampi(ky, 0, 7) * MAXS + x];
      pred = shr((uv - dy) * ca + dy * cb + (uv >> 1), lg_v);
      break;
    }
    case MC_CCLM: {
      const int ys = clampi(c[k_y0], 0, p.Hd - p.maxs);
      const int xs = clampi(c[k_x0], 0, p.Wd - p.maxs);
      const int blk = __ldg(p.dsy + (ys + y) * p.Wd + xs + x);
      pred = clampi(shr(blk * s.misc[3], s.misc[4]) + s.misc[5], 0, maxv);
      break;
    }
    default:
      break;  // MC_INTER units are placed, never chunked
  }
  if (pdpc > 0 && mc < MC_ANG_V) {  // PDPC for planar/DC/V/H
    const int scale = (logw + logh - 2) >> 2;
    const bool is_vh = mc == MC_VERT || mc == MC_HORZ;
    const int lv = s.eL[OFF + y], tv = s.eT[OFF + x];
    const int lq = is_vh ? lv - s.eL[OFF - 1] + pred : lv;
    const int tq = is_vh ? tv - s.eT[OFF - 1] + pred : tv;
    const int wl = mc == MC_HORZ ? 0 : shr(32, min(shr(x << 1, scale), 31));
    const int wt = mc == MC_VERT ? 0 : shr(32, min(shr(y << 1, scale), 31));
    pred = clampi(pred + shr(wl * (lq - pred) + wt * (tq - pred) + 32, 6), 0,
                  maxv);
  }
  return pred;
}

__device__ void recon_unit(const Params& p, Shared& s, int u, int ch,
                           int* plane, const int* res) {
  const int maxs = p.maxs;
  const int L = 5 * maxs + 16, OFF = 2 * maxs + 8;
  const int maxv = (1 << p.bd) - 1, mid = 1 << (p.bd - 1);
  const int* c = s.c;
  const int r = p.is_chroma ? 0 : c[k_mrl];

  build_edges(p, s, plane, L, OFF, mid);
  __syncthreads();
  if (c[k_smooth] > 0) filter_edges(s, L, OFF);
  if (c[k_proj_v] > 0)
    project(s.eT, s.eL, s.tT, L, OFF, c[k_inv_angle], c[k_h], r);
  if (c[k_proj_h] > 0)
    project(s.eL, s.eT, s.tL, L, OFF, c[k_inv_angle], c[k_w], r);

  const int mc = c[k_mode_class];
  if (mc == MC_DC) {
    if (threadIdx.x == 0) {
      const int w = c[k_w], h = c[k_h];
      int sum_t = 0, sum_l = 0;
      for (int i = 0; i < maxs; ++i) {
        if (i < w) sum_t += s.eT[OFF + i];
        if (i < h) sum_l += s.eL[OFF + i];
      }
      const int sum = (w >= h ? sum_t : 0) + (w <= h ? sum_l : 0);
      const int offset = max(w == h ? w << 1 : max(w, h), 1);
      s.misc[0] = shr(sum + (offset >> 1), ilog2(offset));
    }
    __syncthreads();
  } else if (mc == MC_MIP) {
    mip_prepare(p, s, OFF, maxv, mid);
  } else if (mc == MC_CCLM) {
    cclm_prepare(p, s, u, L, OFF, mid);
    __syncthreads();
  }

  const int y = threadIdx.x >> 5, x = threadIdx.x & 31;
  if (y < c[k_h] && x < c[k_w]) {
    int pred = predict(p, s, y, x, L, OFF, maxv);
    const int cw = c[k_ciipw];
    if (cw > 0) {  // CIIP blend (put_ciip, vvc_inter_template.c:60-76)
      const int at = (clampi(__ldg(p.ipos + u), 0, p.n_mc - 1) * p.nch + ch)
                     * TILE * TILE + y * TILE + x;
      pred = (pred * cw + __ldg(p.tiles + at) * (4 - cw) + 2) >> 2;
    }
    const int at = (c[k_y0] + y) * p.Wp + c[k_x0] + x;
    __stcg(plane + at, clampi(pred + __ldg(res + at), 0, maxv));
  }
}

// placement of the pure inter units: clip(tile + residual) over each
// unit's (h, w); the blocks of a channel stride over the units
__device__ void place_inter(const Params& p, int ch, int* plane,
                            const int* res) {
  const int maxv = (1 << p.bd) - 1;
  const int y = threadIdx.x >> 5, x = threadIdx.x & 31;
  for (int u = blockIdx.x; u < p.n_inter; u += gridDim.x) {
    const int x0 = __ldg(p.ictrl + 0 * p.n_mc + u);
    const int y0 = __ldg(p.ictrl + 1 * p.n_mc + u);
    const int w = __ldg(p.ictrl + 2 * p.n_mc + u);
    const int h = __ldg(p.ictrl + 3 * p.n_mc + u);
    if (y < h && x < w) {
      const int tile = __ldg(p.tiles + ((size_t)u * p.nch + ch) * TILE * TILE
                             + y * TILE + x);
      const int at = (y0 + y) * p.Wp + x0 + x;
      __stcg(plane + at, clampi(tile + __ldg(res + at), 0, maxv));
    }
  }
}

__global__ void __launch_bounds__(1024, 1) recon_kernel(Params p) {
  __shared__ Shared s;
  cg::grid_group grid = cg::this_grid();
  const int ch = blockIdx.y;
  const size_t hw = (size_t)p.Hp * p.Wp;
  int* plane = p.plane + ch * hw;
  const int* res = p.res + ch * hw;
  if (p.n_inter > 0) {
    place_inter(p, ch, plane, res);
    grid.sync();  // the placed samples are visible to chunk 0
  }
  for (int k = 0; k < p.n_chunks; ++k) {
    const int u = __ldg(p.ioff + k) + blockIdx.x;
    if (u < __ldg(p.iend + k)) {  // uniform over the block
      if (threadIdx.x < NUM_KEYS)
        s.c[threadIdx.x] = __ldg(p.ctrl + threadIdx.x * p.ucap + u);
      __syncthreads();
      if (s.c[k_w] > 0) recon_unit(p, s, u, ch, plane, res);
      __syncthreads();
    }
    grid.sync();  // chunk k's samples are visible to chunk k+1
  }
}

extern "C" int recon_launch(
    const int* ctrl, int num_keys, int ucap, const int* ioff, const int* iend,
    int n_chunks, const int* ictrl, int num_inter_keys, int n_mc, int n_inter,
    const int* tiles, const int* ipos, const int* res, int* plane, int nch,
    int Hp, int Wp, const int* dsy, int Hd, int Wd, const int* sel,
    const int* lfilt, const int* mip, const int* div, int maxs, int is_chroma,
    int bit_depth, void* stream) {
  if (num_keys != NUM_KEYS || num_inter_keys < 4 || maxs < 1 || maxs > MAXS
      || nch < 1 || n_inter < 0 || n_inter > n_mc || (n_mc > 0 && !tiles))
    return (int)cudaErrorInvalidValue;
  Params p{ctrl, ucap, ioff, iend, n_chunks, ictrl, n_mc, n_inter, tiles,
           ipos, res, plane, Hp, Wp, dsy, Hd, Wd, sel, lfilt, mip, div, maxs,
           is_chroma, bit_depth, nch};
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)recon_kernel, dim3(CHUNK_CAP, nch), dim3(1024), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* recon_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
