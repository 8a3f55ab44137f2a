// The LMCS chroma residual scale of one VPDU (lmcs_derive_chroma_scale,
// vvc_intra_template.c:390-428), for the kernels that scale chroma
// residuals (residual.cu computes it in each scaled TU's lanes).
//
// Replaces the JAX package's XLA `_lmcs_vpdu_scales`,
// ffmpeg_tpu/models/vvc/pipeline.py:393 (not Pallas), which builds the
// frame's whole table of scales.  Its oracle is the plain torch version,
// ffmpeg_tpu_torch/ops/lmcs.py lmcs_vpdu_scales_plain, bit for bit.
//
// A VPDU's scale: the mean of its outside-left column and outside-top row
// of the mapped luma recon (each vsz samples, rows and columns clamped to
// the picture: the edge replication), a side in another tile or outside
// the picture unavailable, mapped through the pivot scan.  The sums wrap
// in 32 bits, as the JAX form's int32 sums do.  full1080's CTB is 32, so
// its vsz is 32 and a 1920x1080 frame has 2,040 VPDUs (510 at vsz 64),
// each reading at most 64 luma samples (128 at vsz 64).
//
// The source travels in the kernel's parameter block: the luma plane's
// pointer and row stride, the VPDU grid, the interior tile boundaries (at
// most LMCS_MAX_BDS a direction) and the tables of the host copy
// `inv_host` (models/vvc/convert.py _lmcs: pivot[17], inv_scale[16],
// min_bin, max_bin, chroma_scale[16]), so that nothing but the luma
// samples is read from the card.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#define LMCS_MAX_BDS 64  // interior tile boundaries per direction
#define LMCS_MAX_VSZ 64  // VPDU edge: min(CTB, 64)
#define LMCS_TABLE 51    // inv_host with chroma_scale

struct LmcsScales {
  const int* plane;  // the mapped luma picture; null: no scaling
  long long pitch;   // its row stride (samples)
  int W, H, vsz, vsz_log2, nvx, nvy;
  // pivot[j + 1] for the bins j in [max(min_bin, 0), min(max_bin, 15)],
  // INT_MIN (which every value reaches) for the others; base: min_bin
  // less the number of others
  int piv[16];
  int base;
  int chroma_scale[16];
  int n_bx, n_by;
  int bx[LMCS_MAX_BDS], by[LMCS_MAX_BDS];
};

// A VPDU's origin and which of its sides are available (none for an index
// outside the grid, which the caller reports).
struct Vpdu {
  int vx, vy;
  bool al, at;
};

__device__ __forceinline__ Vpdu vpdu_at(const LmcsScales& s, int v) {
  Vpdu u{0, 0, false, false};
  if ((unsigned)v >= (unsigned)(s.nvx * s.nvy)) return u;
  u.vy = (v / s.nvx) * s.vsz;
  u.vx = (v % s.nvx) * s.vsz;
  u.al = u.vx > 0;
  u.at = u.vy > 0;
  for (int k = 0; k < s.n_bx; ++k) u.al = u.al && u.vx != s.bx[k];
  for (int k = 0; k < s.n_by; ++k) u.at = u.at && u.vy != s.by[k];
  return u;
}

// Lane `lane` of LANES: its share of the sum of the VPDU's available
// left column (entries 0 .. vsz - 1) and top row (vsz .. 2 vsz - 1).  The
// loads have no dependences, so they are all in flight at once.
template <int LANES>
__device__ __forceinline__ unsigned vpdu_partial(const LmcsScales& s,
                                                 const Vpdu& u, int lane) {
  unsigned sum = 0;
#pragma unroll
  for (int k = 0; k < (2 * LMCS_MAX_VSZ + LANES - 1) / LANES; ++k) {
    const int j = lane + k * LANES;
    if (j < s.vsz) {
      if (u.al)
        sum += (unsigned)__ldg(s.plane + (u.vx - 1) +
                               min(u.vy + j, s.H - 1) * s.pitch);
    } else if (j < 2 * s.vsz) {
      if (u.at)
        sum += (unsigned)__ldg(s.plane + (long long)(u.vy - 1) * s.pitch +
                               min(u.vx + j - s.vsz, s.W - 1));
    }
  }
  return sum;
}

// The scale from the sum of the available samples: their rounded mean
// (mid-grey with neither side), its bin by the pivot scan (16 unrolled
// compares with the parameter block's operands, no loop), clamped to 15,
// and the bin's chroma scale.
__device__ __forceinline__ int vpdu_scale(const LmcsScales& s, const Vpdu& u,
                                          unsigned total, int bit_depth) {
  const int cnt = ((int)u.al + (int)u.at) * s.vsz;
  const int cnt_log2 = s.vsz_log2 + (int)(u.al && u.at);
  const int luma = cnt > 0 ? (int)(total + (unsigned)(cnt >> 1)) >> cnt_log2
                           : 1 << (bit_depth - 1);
  int idx = s.base;
#pragma unroll
  for (int j = 0; j < 16; ++j) idx += luma >= s.piv[j];
  return s.chroma_scale[min(idx, 15)];
}

// Fill *s from the host's arguments: the (H, W) picture at `plane`, row
// stride `pitch`; vsz a power of 2 up to LMCS_MAX_VSZ; tab: inv_host with
// its chroma scales (n_tab == LMCS_TABLE) and min_bin >= 0; bx, by: the
// interior tile boundaries in luma samples.  A null plane fills an empty
// source (no scaling).  Returns false on anything else.
static bool set_lmcs_scales(LmcsScales* s, const int* plane, long long pitch,
                            int W, int H, int vsz, const int* tab, int n_tab,
                            const int* bx, int n_bx, const int* by,
                            int n_by) {
  *s = LmcsScales{};
  if (!plane) return true;
  if (W < 1 || H < 1 || pitch < W || vsz < 1 || vsz > LMCS_MAX_VSZ ||
      (vsz & (vsz - 1)) || !tab || n_tab != LMCS_TABLE || tab[33] < 0 ||
      n_bx < 0 || n_by < 0 || n_bx > LMCS_MAX_BDS || n_by > LMCS_MAX_BDS ||
      (n_bx && !bx) || (n_by && !by))
    return false;
  s->plane = plane;
  s->pitch = pitch;
  s->W = W;
  s->H = H;
  s->vsz = vsz;
  s->vsz_log2 = 31 - __builtin_clz((unsigned)vsz);
  s->nvx = (W + vsz - 1) / vsz;
  s->nvy = (H + vsz - 1) / vsz;
  const int min_bin = tab[33], max_bin = tab[34];
  s->base = min_bin;
  for (int j = 0; j < 16; ++j) {
    const bool in = j >= min_bin && j <= max_bin;
    s->piv[j] = in ? tab[j + 1] : INT_MIN;
    s->base -= !in;
    s->chroma_scale[j] = tab[35 + j];
  }
  s->n_bx = n_bx;
  s->n_by = n_by;
  for (int k = 0; k < n_bx; ++k) s->bx[k] = bx[k];
  for (int k = 0; k < n_by; ++k) s->by[k] = by[k];
  return true;
}
