// Inter prediction of the MC batch of one plane kind, for Hopper.
//
// The JAX frame program computes this in XLA (pipeline.py _pred_blocks
// over _inter_pred_unit, with _mc_block, _hwrap, _prof_refine and
// _bdof_bi); it is not a Pallas kernel, but it is the main device work
// of every P/B frame.  This kernel computes, for every unit of the MC
// batch and every channel, the clipped S x S (S = 32) prediction tile:
// both hypotheses through the separable 8-tap luma / 4-tap chroma
// filter (the hpel control selects the AMVR half-pel or the affine
// 6-tap luma bank), reference wraparound, PROF on affine subblocks,
// BDOF on 16x16 bi units, uni/bi rounding, explicit weights and BCW
// (Cr reads the second weight set), and the GPM blend.  Samples outside
// the unit's (h, w) are 0.  Its oracle is the plain torch version in
// ffmpeg_tpu_torch/ops/inter.py (inter_pred_plain); everything is int32
// arithmetic, so the two agree bit for bit.
//
// Design.  One block of 256 threads per (unit, channel).  A
// hypothesis's (h + taps - 1) x (w + taps - 1) reference window is
// gathered into shared memory with the picture clamps (rows to the
// picture, columns to the picture or through the wraparound offset),
// then filtered horizontally and vertically in shared memory.  Only the
// hypotheses the unit's prediction reads are computed, and only over
// the unit's own samples.  The data-dependent gathers and branches (per
// unit reference, filter bank, weighting mode, GPM, BDOF, PROF) are
// why this is CUDA and not Triton.
//
// What bounds it on this card: the reference reads are gathers with
// little reuse between units, and most units are small (affine and
// SbTMVP subblocks are 4x4 and 8x8), so a block does little work
// between its barriers: it is bound by latency, not by bytes or
// operations.  Packing several small units into one block, and
// compacting the 32x32 tile storage, are later work.
//
// Build (at first use, ffmpeg_tpu_torch/utils/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
//        -Xcompiler -fPIC -o _build/libinter_pred.so inter_pred.cu

#include <cuda_runtime.h>

#define S 32                 // MC tile edge (MC_TILE)
#define G (S + 7)            // largest window edge (8 taps)
#define NT 256               // threads per block

// control rows, in the order of INTER_KEYS (models/vvc/inputs.py)
enum {
  k_x0, k_y0, k_w, k_h, k_pf, k_m0x, k_m0y, k_m1x, k_m1y, k_r0slot,
  k_r1slot, k_wden, k_w0, k_w1, k_wo0, k_wo1, k_hpel, k_hyp0lx, k_hyp1lx,
  k_gpm_part, k_gpm_tx, k_gpm_ty, k_gpm_lw, k_gpm_lh, k_w0b, k_w1b,
  k_wo0b, k_wo1b, k_prof, k_pdhx0, k_pdhy0, k_pdvx0, k_pdvy0, k_pdhx1,
  k_pdhy1, k_pdvx1, k_pdvy1, k_bdof,
  NUM_KEYS
};

struct Params {
  const int* ctrl;             // (NUM_KEYS, n_mc)
  int n_mc, n_inter;           // rows n_inter.. are CIIP units
  const long long* refs;       // (nch, n_refs) plane pointers
  int n_refs, nch;
  int H, W, stride;            // picture size, plane row stride
  const int* gwt;              // (n_gpm, S, S) GPM blend weights
  const int* gslot;            // (n_mc,)
  const int* lfilt;            // (3, 16, 8) luma filter banks
  const int* cfilt;            // (32, 4) chroma filter
  int* out;                    // (n_mc, nch, S, S)
  int is_chroma, bd, wrap;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// XLA shift semantics (the JAX reference): out-of-range amounts give 0
// (left) or the sign fill (right); left shifts of negative values wrap
__device__ __forceinline__ int shl(int a, int s) {
  return (s < 0 || s >= 32) ? 0 : (int)((unsigned)a << s);
}
__device__ __forceinline__ int shr(int a, int s) {
  return (s < 0 || s >= 32) ? (a < 0 ? -1 : 0) : (a >> s);
}

__device__ __forceinline__ int ilog2_sat(int v) {  // av_log2, saturates at 20
  int b = 0;
  for (int k = 1; k < 21; ++k) b += v >= (1 << k);
  return b;
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

struct Shared {
  int c[NUM_KEYS];
  int win[G * G];              // reference window
  int tmp[G * S];              // horizontal pass
  int t[2][S * S];             // 14-bit hypotheses
  int p[2][18 * 18];           // BDOF padded hypotheses
  int gh[2][16 * 16], gv[2][16 * 16];
  int vx[16], vy[16];
};

// column clamp: the picture edge, or reference wraparound (ClipH)
__device__ __forceinline__ int hwrap(int x, int W, int wrap) {
  if (wrap) {
    if (x < 0) x += wrap;
    if (x > W - 1) x -= wrap;
  }
  return clampi(x, 0, W - 1);
}

__device__ __forceinline__ const int* ref_plane(const Params& p, int ch,
                                                int slot) {
  return (const int*)p.refs[ch * p.n_refs + clampi(slot, 0, p.n_refs - 1)];
}

// one hypothesis: t[lx][y][x] for y < hh, x < ww (14-bit, _mc_block)
__device__ void mc_block(const Params& p, Shared& s, int ch, int lx, int hh,
                         int ww, int wrap) {
  const int* c = s.c;
  const int taps = p.is_chroma ? 4 : 8;
  const int before = p.is_chroma ? 1 : 3;
  const int fb = p.is_chroma ? 5 : 4;
  const int mvx = c[lx ? k_m1x : k_m0x], mvy = c[lx ? k_m1y : k_m0y];
  const int* ref = ref_plane(p, ch, c[lx ? k_r1slot : k_r0slot]);
  const int mask = (1 << fb) - 1;
  const int fx = mvx & mask, fy = mvy & mask;
  const int ix = c[k_x0] + (mvx >> fb) - before;
  const int iy = c[k_y0] + (mvy >> fb) - before;
  const int gw = ww + taps - 1, gh = hh + taps - 1;
  for (int i = threadIdx.x; i < gh * gw; i += NT) {
    const int r = i / gw, q = i % gw;
    const int ys = clampi(iy + r, 0, p.H - 1);
    const int xs = hwrap(ix + q, p.W, wrap);
    s.win[r * G + q] = __ldg(ref + (size_t)ys * p.stride + xs);
  }
  const int* hf;
  const int* vf;
  if (p.is_chroma) {
    hf = p.cfilt + fx * 4;
    vf = p.cfilt + fy * 4;
  } else {
    const int bank = clampi(c[k_hpel], 0, 2) * 16;
    hf = p.lfilt + (bank + fx) * 8;
    vf = p.lfilt + (bank + fy) * 8;
  }
  __syncthreads();
  const int shift1 = p.bd - 8;
  for (int i = threadIdx.x; i < gh * ww; i += NT) {
    const int r = i / ww, x = i % ww;
    int acc = 0;
    for (int k = 0; k < taps; ++k) acc += __ldg(hf + k) * s.win[r * G + x + k];
    s.tmp[r * S + x] = acc >> shift1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hh * ww; i += NT) {
    const int y = i / ww, x = i % ww;
    int acc = 0;
    for (int k = 0; k < taps; ++k) acc += __ldg(vf + k) * s.tmp[(y + k) * S + x];
    s.t[lx][y * S + x] = acc >> 6;
  }
  __syncthreads();
}

// integer-position reference sample around the unit, 14-bit
// (bdof_fetch_samples), at (r, q) of a ring starting one sample up-left
__device__ __forceinline__ int int_ring(const Params& p, const Shared& s,
                                        int ch, int lx, int r, int q,
                                        int wrap) {
  const int* c = s.c;
  const int mvx = c[lx ? k_m1x : k_m0x], mvy = c[lx ? k_m1y : k_m0y];
  const int* ref = ref_plane(p, ch, c[lx ? k_r1slot : k_r0slot]);
  const int iy = c[k_y0] + (mvy >> 4) + ((mvy >> 3) & 1) - 1 + r;
  const int ix = c[k_x0] + (mvx >> 4) + ((mvx >> 3) & 1) - 1 + q;
  const int v = __ldg(ref + (size_t)clampi(iy, 0, p.H - 1) * p.stride +
                      hwrap(ix, p.W, wrap));
  return shl(v, 14 - p.bd);
}

// PROF (8.5.5.9) on the 4x4 corner of hypothesis lx (_prof_refine)
__device__ void prof_refine(const Params& p, Shared& s, int ch, int lx) {
  const int* c = s.c;
  const int i = threadIdx.x;
  int di = 0;
  if (i < 16) {
    const int y = i >> 2, x = i & 3;
    // p[r][q] of the 6x6 pad: the tile inside [1, 5), the ring outside
    auto pad = [&](int r, int q) {
      return (r >= 1 && r < 5 && q >= 1 && q < 5)
                 ? s.t[lx][(r - 1) * S + q - 1]
                 : int_ring(p, s, ch, lx, r, q, p.wrap);
    };
    const int gh = (pad(y + 1, x + 2) >> 6) - (pad(y + 1, x) >> 6);
    const int gv = (pad(y + 2, x + 1) >> 6) - (pad(y, x + 1) >> 6);
    const int dhx = c[lx ? k_pdhx1 : k_pdhx0], dhy = c[lx ? k_pdhy1 : k_pdhy0];
    const int dvx = c[lx ? k_pdvx1 : k_pdvx0], dvy = c[lx ? k_pdvy1 : k_pdvy0];
    const int rx = x * (dhx * 4) + y * (dhy * 4) - 6 * (dhx + dhy);
    const int ry = x * (dvx * 4) + y * (dvy * 4) - 6 * (dvx + dvy);
    const int dmx = clampi((rx + 128 - (rx >= 0)) >> 8, -31, 31);
    const int dmy = clampi((ry + 128 - (ry >= 0)) >> 8, -31, 31);
    const int lim = 1 << max(13, p.bd + 1);
    di = clampi(gh * dmx + gv * dmy, -lim, lim - 1);
  }
  __syncthreads();  // every read of the tile's corner is done
  if (i < 16) s.t[lx][(i >> 2) * S + (i & 3)] += di;
  __syncthreads();
}

// BDOF (8.5.6.4/5) on a bi unit of at most 16x16 (_bdof_bi): the
// gradients and the per-4x4 (vx, vy) go to shared memory; the
// per-sample result is computed by bdof_sample
__device__ void bdof_prepare(const Params& p, Shared& s, int ch, int wrap) {
  const int* c = s.c;
  const int w = c[k_w], h = c[k_h];
  for (int i = threadIdx.x; i < 2 * 324; i += NT) {
    const int l = i / 324, r = (i % 324) / 18, q = i % 18;
    const int xi = q - 1, yi = r - 1;
    const bool inside = xi >= 0 && xi < w && yi >= 0 && yi < h;
    const int xc = clampi(xi, 0, w - 1), yc = clampi(yi, 0, h - 1);
    s.p[l][r * 18 + q] = inside ? s.t[l][yc * S + xc]
                                : int_ring(p, s, ch, l, r, q, wrap);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * 256; i += NT) {
    const int l = i >> 8, y = (i & 255) >> 4, x = i & 15;
    const int* pp = s.p[l];
    s.gh[l][y * 16 + x] =
        (pp[(y + 1) * 18 + x + 2] >> 6) - (pp[(y + 1) * 18 + x] >> 6);
    s.gv[l][y * 16 + x] =
        (pp[(y + 2) * 18 + x + 1] >> 6) - (pp[y * 18 + x + 1] >> 6);
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int by = threadIdx.x >> 2, bx = threadIdx.x & 3;
    int sgx2 = 0, sgy2 = 0, sgxgy = 0, sgxdi = 0, sgydi = 0;
    for (int a = 0; a < 6; ++a)
      for (int b = 0; b < 6; ++b) {
        const int r = by * 4 + a, q = bx * 4 + b;  // in the 18x18 pad
        const int yc = clampi(r - 1, 0, h - 1), xc = clampi(q - 1, 0, w - 1);
        const int g = min(yc * 16 + xc, 255);  // edge-replicated gradients
        const int th = (s.gh[0][g] + s.gh[1][g]) >> 1;
        const int tv = (s.gv[0][g] + s.gv[1][g]) >> 1;
        const int d = (s.t[0][yc * S + xc] >> 4) - (s.t[1][yc * S + xc] >> 4);
        sgx2 += abs(th);
        sgy2 += abs(tv);
        sgxgy += sgn(tv) * th;
        sgxdi += -sgn(th) * d;
        sgydi += -sgn(tv) * d;
      }
    const int vx =
        sgx2 > 0 ? clampi(shr(sgxdi * 4, ilog2_sat(sgx2)), -15, 15) : 0;
    const int vy = sgy2 > 0 ? clampi(shr(sgydi * 4 - ((vx * sgxgy) >> 1),
                                         ilog2_sat(sgy2)),
                                     -15, 15)
                            : 0;
    s.vx[threadIdx.x] = vx;
    s.vy[threadIdx.x] = vy;
  }
  __syncthreads();
}

__device__ __forceinline__ int bdof_sample(const Params& p, const Shared& s,
                                           int y, int x, int maxv) {
  if (y >= 16 || x >= 16) return 0;
  const int b = (y >> 2) * 4 + (x >> 2), g = y * 16 + x;
  const int off = s.vx[b] * (s.gh[0][g] - s.gh[1][g]) +
                  s.vy[b] * (s.gv[0][g] - s.gv[1][g]);
  const int shift4 = 15 - p.bd;
  return clampi(
      (s.t[0][y * S + x] + s.t[1][y * S + x] + (1 << (shift4 - 1)) + off) >>
          shift4,
      0, maxv);
}

__global__ void __launch_bounds__(NT) inter_pred_kernel(Params p) {
  __shared__ Shared s;
  const int u = blockIdx.x, ch = blockIdx.y;
  if (threadIdx.x < NUM_KEYS)
    s.c[threadIdx.x] = __ldg(p.ctrl + threadIdx.x * p.n_mc + u);
  __syncthreads();
  const int* c = s.c;
  const int w = min(c[k_w], S), h = min(c[k_h], S);
  // the tile is computed over at least the 4x4 corner PROF refines
  const int ww = max(w, 4), hh = max(h, 4);
  const int pf = c[k_pf], gpm = c[k_gpm_part] > 0;
  const bool luma = !p.is_chroma;
  const bool need0 = gpm || pf == 1 || pf == 3;
  const bool need1 = gpm || pf != 1;
  // the reference's reads: pure inter units clamp the MC window and the
  // BDOF ring to the picture, and wrap only the PROF ring; CIIP units
  // wrap every read (ops/inter.py inter_pred_plain)
  const int wrap_mc = u >= p.n_inter ? p.wrap : 0;
  if (need0) mc_block(p, s, ch, 0, hh, ww, wrap_mc);
  if (need1) mc_block(p, s, ch, 1, hh, ww, wrap_mc);
  if (luma && need0 && ((c[k_prof] >> 0) & 1)) prof_refine(p, s, ch, 0);
  if (luma && need1 && ((c[k_prof] >> 1) & 1)) prof_refine(p, s, ch, 1);
  const int wden = c[k_wden];
  const bool bdof = luma && !gpm && pf == 3 && wden < 0 && c[k_bdof] > 0;
  if (bdof) bdof_prepare(p, s, ch, wrap_mc);

  const int bd = p.bd, maxv = (1 << bd) - 1;
  const bool cr = p.is_chroma && ch == 1;
  const int w0 = c[cr ? k_w0b : k_w0], w1 = c[cr ? k_w1b : k_w1];
  const int wo0 = c[cr ? k_wo0b : k_wo0], wo1 = c[cr ? k_wo1b : k_wo1];
  const int wd = max(wden, 0);
  const int shift2 = 14 - bd, sh_avg = max(3, 15 - bd);
  const int sh_g = max(5, 17 - bd);
  const int* wb = p.gwt + (size_t)__ldg(p.gslot + u) * S * S;
  int* out = p.out + ((size_t)u * p.nch + ch) * S * S;
  for (int i = threadIdx.x; i < S * S; i += NT) {
    const int y = i / S, x = i % S;
    int pred = 0;
    if (y < h && x < w) {
      const int t0 = s.t[0][i], t1 = s.t[1][i];
      if (gpm) {
        const int g = __ldg(wb + i);
        pred = clampi((t0 * g + t1 * (8 - g) + (1 << (sh_g - 1))) >> sh_g, 0,
                      maxv);
      } else if (pf == 3) {
        if (wden >= 0) {
          const int shw = wd + sh_avg;
          const int offw = shl(shl(wo0 + wo1, bd - 8) + 1, shw - 1);
          pred = clampi(shr(t0 * w0 + t1 * w1 + offw, shw), 0, maxv);
        } else if (bdof) {
          pred = bdof_sample(p, s, y, x, maxv);
        } else {
          pred = clampi((t0 + t1 + (1 << (sh_avg - 1))) >> sh_avg, 0, maxv);
        }
      } else {
        const int ta = pf == 1 ? t0 : t1;
        if (wden >= 0) {
          const int shu = wd + 14 - bd;
          pred = clampi(shr(ta * w0 + (shl(1, shu) >> 1), shu) +
                            shl(wo0, bd - 8),
                        0, maxv);
        } else {
          pred = clampi((ta + (1 << (shift2 - 1))) >> shift2, 0, maxv);
        }
      }
    }
    out[i] = pred;
  }
}

extern "C" int inter_pred_launch(const int* ctrl, int num_keys, int n_mc,
                                 int n_inter, const long long* refs, int n_refs, int nch,
                                 int H, int W, int stride, const int* gwt,
                                 const int* gslot, const int* lfilt,
                                 const int* cfilt, int* out, int is_chroma,
                                 int bit_depth, int wrap, void* stream) {
  if (num_keys != NUM_KEYS || n_refs < 1 || nch < 1 || H < 1 || W < 1 ||
      stride < W || bit_depth < 8 || bit_depth > 12 || n_inter < 0 ||
      n_inter > n_mc)
    return (int)cudaErrorInvalidValue;
  if (n_mc == 0) return 0;
  Params p{ctrl, n_mc, n_inter, refs, n_refs, nch, H, W, stride, gwt, gslot,
           lfilt, cfilt, out, is_chroma, bit_depth, wrap};
  inter_pred_kernel<<<dim3(n_mc, nch), NT, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* inter_pred_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
