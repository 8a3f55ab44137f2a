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
// per-CTB grids are a few KB.  The design keeps every sample's work to
// shared-memory reads between one 16-byte load and one 16-byte store, and
// a warp's runs free of branches on their CTBs' types and classes:
//
// Tiles.  A block filters TH x TW output tiles: warp w takes tile rows
// w and w + 8, lane l the run of 4 samples at column 4l.  Tiles start at
// multiples of TH rows (counted from the band's first row, as the CTB
// rows are) and TW columns, so with CTBs of TH samples or more a tile
// lies in one CTB row and covers whole CTB columns (or a part of one
// 128-sample CTB).  A tile's input, with its one-sample ring, is staged
// in shared memory: rows [r0 - 1, r0 + TH] and the aligned columns
// [x0 - 4, x0 + TW + 4), each position clamped to the plane (the plain
// version's clamped reads), a chunk of 4 columns inside the plane as one
// 16-byte cp.async.cg when the plane's base and pitch are 16-byte
// aligned, otherwise 4 clamped 4-byte copies.  The edge offset's
// neighbours are read there: per run two 16-byte reads (the rows of
// neighbours a and b) and two 4-byte reads at the run's left and right,
// each sample's pair picked by selects on its CTB's class.
//
// CTB parameters once per tile.  With the tile's copies, one thread per
// CTB the tile touches (at most PR x PC) copies its type, band position,
// EO class and 5 offsets through the grids' strides (the frame's SAO
// tree read in place with the component's offset, never sliced or
// copied) into shared memory, eight 4-byte cp.async.  From them the
// block builds each CTB's offset table (build_luts): a band CTB's offset
// for each of the 32 bands, an edge CTB's for each edge index 0..4, and
// a zero entry.  A sample's offset is then one table read at its band or
// its edge index (or the zero entry), whatever its CTB's type: a warp
// computes the band indices if any of its runs lies in a band CTB and
// the edge indices if any lies in an edge CTB (warp votes), so runs of
// CTBs of different types or classes in one warp do not diverge, and a
// warp whose CTBs are all off (type 0) takes only the clip and reads no
// neighbours.  The quirks hold: the CTB column clamps to cbw - 1 and the
// CTB row, counted from the band's first row, to cbh - 1.  CTBs must be
// a power of 2 of at least MIN_CTB samples (VVC's are 16 to 128), so
// that a run lies in one CTB and its index is a shift.
//
// A persistent, pipelined grid.  The launch has as many blocks as the
// card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs, or the tile count if smaller); block b takes tiles b, b + grid,
// ... of both planes of a call in row order, with NSTAGE buffers: the
// next tile's copies are issued before the block filters the current
// one.  A 1080p luma plane is about 1,100 tiles, its Cb and Cr about
// 550: two or three tiles a block.
//
// What holds it (NVIDIA H100, tools/sao_ablate.py): the tile copies
// themselves.  Without the filtering (the same copies, tables and
// clip), a launch takes about three quarters of its time: a block
// filters two or three tiles, so a launch is little more than one wave
// of copies whose latency nothing hides but the other blocks and, for
// the Cb+Cr call, the overlap.  One stage or three changed nothing, and
// a block per tile made the pair slower.
//
// Two launches that overlap.  The Cb+Cr call reads only the deblocked
// chroma planes, which the launches before the luma call wrote, so it may
// run beside the luma launch: launched after it with programmatic stream
// serialization (flag F_OVERLAP), it starts as soon as every luma block
// has started (each calls griddepcontrol.launch_dependents first), and
// one thread of its grid waits (griddepcontrol.wait) before it exits, so
// that the chroma launch completes only after the luma launch (a later
// kernel of the stream sees both).  Outside such a launch the wait
// returns at once.
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
#define TH 16        // output rows a tile
#define TW 128       // output columns a tile: a warp's 32 runs of 4
#define THREADS 256  // 8 warps, a tile row each at a time
#define WARPS (THREADS / 32)
// blocks per SM the register budget must allow: at most 64 registers a
// thread
#define MINB 4
// the tile's buffer: rows (a ring row above and below) and pitch (4
// columns a side keep its rows 16-byte aligned)
#define BR (TH + 2)
#define BP (TW + 8)
// the smallest CTB, and the CTB rows and columns a tile touches at most
#define MIN_CTB 8
#define PR ((TH - 1) / MIN_CTB + 2)
#define PC ((TW - 1) / MIN_CTB + 2)
// a CTB's offset table: 32 entries (the bands; the edge indices 0..4)
// and a zero entry; the odd pitch spreads the CTBs over the banks
#define LUT_ZERO 32
#define LP 33
// flags: bit 0, the launch may start while the launch before it on the
// stream runs (programmatic stream serialization)
#define F_OVERLAP 1
// tiles a block has in flight: the one filtered and the next ones copied
#define NSTAGE 2

static_assert(TW == 128 && TH % WARPS == 0, "a warp's 32 runs fill a row");

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
  int He, Hs, Wp, halo, y0, pic_w, pic_h, ctb_lg, cbh, cbw, bd;
  int ntx, nty, ntiles;      // tiles a row, tile rows a plane, in all
  bool vsrc, vdst;           // 16-byte copies in, 16-byte stores out
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
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

// wait until every committed group but the last NSTAGE - 1 has landed
__device__ __forceinline__ void cp_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1) : "memory");
}

// sign(d) of an int32 difference
__device__ __forceinline__ int sgn(int d) { return min(max(d, -1), 1); }

__device__ __forceinline__ int clip_add(int v, int off, int maxv) {
  // int32 sums wrap, as torch's do
  return min(max((int)((unsigned)v + (unsigned)off), 0), maxv);
}

// edge index of value v between neighbours a and b: 2 + sign(v - a) +
// sign(v - b), the differences wrapping as torch's do
__device__ __forceinline__ int edge_idx(int v, int a, int b) {
  return 2 + sgn((int)((unsigned)v - (unsigned)a))
      + sgn((int)((unsigned)v - (unsigned)b));
}

// rows [r0 - 1, r0 + TH] (of the Hs rows; extended-plane rows + halo) and
// columns [x0 - 4, x0 + TW + 4) of plane c, each position clamped to the
// (He, Wp) plane, into buf (pitch BP); rows and chunks that no run reads
// are skipped
__device__ __forceinline__ void load_tile(int* buf, const Params& p, int c,
                                          int r0, int x0) {
  constexpr int NC = BP / 4;
  const int* src = p.src[c];
  const long long pitch = p.pitch[c];
  // the last run starts before Wp and reads up to 4 columns past its
  // start
  const int rows = min(BR, p.Hs - r0 + 2), cmax = p.Wp - x0 + 7;
  for (int i = threadIdx.x; i < rows * NC; i += THREADS) {
    const int br = i / NC, k = i - br * NC;
    if (4 * k > cmax) continue;
    const int* row =
        src + (long long)clampi(r0 + p.halo - 1 + br, 0, p.He - 1) * pitch;
    const int gx = x0 - 4 + 4 * k;
    int* d = buf + br * BP + 4 * k;
    if (p.vsrc && gx >= 0 && gx + 4 <= p.Wp) {
      cp_async16(d, row + gx);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(d + j, row + clampi(gx + j, 0, p.Wp - 1));
    }
  }
}

// the run of 4 samples at output row r (tile row ry) and column x of
// plane c; q: its CTB's type, band position and EO class; lut: its CTB's
// offset table (build_luts)
__device__ __forceinline__ void filter_run(const Params& p, const int* buf,
                                           int c, int ry, int r, int x,
                                           int lane, int4 q, const int* lut) {
  const int* mid = buf + (ry + 1) * BP + 4 + 4 * lane;
  const int4 v = *reinterpret_cast<const int4*>(mid);
  const int y = p.y0 + r;  // picture row
  const int maxv = (1 << p.bd) - 1;
  const int n_in = y < p.pic_h ? clampi(p.pic_w - x, 0, 4) : 0;
  // the warp's runs take the band, the edge or neither part, each part
  // for all its lanes at once (no divergence between CTB types)
  const unsigned lanes = __activemask();
  const bool band = q.x == 1, edge = q.x == 2 && n_in > 0;
  int4 ix = make_int4(LUT_ZERO, LUT_ZERO, LUT_ZERO, LUT_ZERO);
  if (__any_sync(lanes, edge)) {
    // EO class k's neighbours are a = (dx, dy) and b = (-dx, -dy)
    // (ops/sao.py _EO_DIRS): 0 horizontal, 1 vertical, 2 the 135 and 3
    // the 45 degree diagonal
    const int k = q.z & 3;
    const int dx = k == 1 ? 0 : (k == 3 ? 1 : -1), dy = k == 0 ? 0 : -1;
    const int* ra = mid + dy * BP;
    const int* rb = mid - dy * BP;
    const int4 ma = *reinterpret_cast<const int4*>(ra);
    const int4 mb = *reinterpret_cast<const int4*>(rb);
    const int sa = ra[dx < 0 ? -1 : 4], sb = rb[dx < 0 ? 4 : -1];
    const int4 a = dx < 0 ? make_int4(sa, ma.x, ma.y, ma.z)
                          : dx > 0 ? make_int4(ma.y, ma.z, ma.w, sa) : ma;
    const int4 b = dx < 0 ? make_int4(mb.y, mb.z, mb.w, sb)
                          : dx > 0 ? make_int4(sb, mb.x, mb.y, mb.z) : mb;
    // both neighbours inside the picture
    const bool oky = edge && y + dy >= 0 && y + dy < p.pic_h && y - dy >= 0
        && y - dy < p.pic_h;
    const int lo = dx ? 1 : 0, hi = p.pic_w - 1 - (dx ? 1 : 0);
#define EDGE(f, i)                                                      \
  ix.f = oky && x + i >= lo && x + i <= hi ? edge_idx(v.f, a.f, b.f)    \
                                           : LUT_ZERO
    EDGE(x, 0);
    EDGE(y, 1);
    EDGE(z, 2);
    EDGE(w, 3);
#undef EDGE
  }
  if (__any_sync(lanes, band) && band) {
    // the band of each sample; its offset is the table's entry
    const int s = p.bd - 5;
    ix = make_int4((v.x >> s) & 31, (v.y >> s) & 31, (v.z >> s) & 31,
                   (v.w >> s) & 31);
  }
  // samples outside the picture keep their input value
  const int4 out = make_int4(
      n_in > 0 ? clip_add(v.x, lut[ix.x], maxv) : v.x,
      n_in > 1 ? clip_add(v.y, lut[ix.y], maxv) : v.y,
      n_in > 2 ? clip_add(v.z, lut[ix.z], maxv) : v.z,
      n_in > 3 ? clip_add(v.w, lut[ix.w], maxv) : v.w);
  int* d = p.dst + ((long long)c * p.Hs + r) * p.Wp + x;
  if (p.vdst) {
    *reinterpret_cast<int4*>(d) = out;
  } else {
    const int n = min(4, p.Wp - x);
    d[0] = out.x;
    if (n > 1) d[1] = out.y;
    if (n > 2) d[2] = out.z;
    if (n > 3) d[3] = out.w;
  }
}

// a tile's place: plane c, first output row r0 and column x0, its CTBs
// rows cy0.., columns cx0 .. cx0 + nc - 1 (nr x nc of them)
struct Tile {
  int c, r0, x0, cy0, cx0, nr, nc;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int tile) {
  Tile t;
  const int per_plane = p.ntx * p.nty;
  t.c = tile / per_plane;
  const int k = tile - t.c * per_plane, ty = k / p.ntx;
  t.r0 = ty * TH;
  t.x0 = (k - ty * p.ntx) * TW;
  t.cy0 = min(t.r0 >> p.ctb_lg, p.cbh - 1);
  t.cx0 = min(t.x0 >> p.ctb_lg, p.cbw - 1);
  t.nr = min((min(t.r0 + TH, p.Hs) - 1) >> p.ctb_lg, p.cbh - 1) - t.cy0 + 1;
  t.nc = min((min(t.x0 + TW, p.Wp) - 1) >> p.ctb_lg, p.cbw - 1) - t.cx0 + 1;
  return t;
}

// a tile's CTB parameters, one CTB a thread, 4-byte copies: par[8e ..
// 8e + 7] = type, band position, EO class, offsets 0..4 of its CTB e (in
// raster order of the tile's CTBs)
__device__ __forceinline__ void load_params(int* par, const Params& p,
                                            const Tile& t) {
  const int e = threadIdx.x;
  if (e >= t.nr * t.nc) return;
  const int cby = t.cy0 + e / t.nc, cbx = t.cx0 + e % t.nc;
  int* d = par + 8 * e;
  cp_async4(d, p.type.p[t.c] + cby * p.type.sy + cbx * p.type.sx);
  cp_async4(d + 1, p.band.p[t.c] + cby * p.band.sy + cbx * p.band.sx);
  cp_async4(d + 2, p.eo.p[t.c] + cby * p.eo.sy + cbx * p.eo.sx);
  const int* o = p.offv.p[t.c] + cby * p.offv.sy + cbx * p.offv.sx;
#pragma unroll
  for (int j = 0; j < 5; ++j) cp_async4(d + 3 + j, o + j * p.offv.ss);
}

// each CTB's offset table from its parameters: entry k (k < 32) of a
// band CTB is the offset of band k (offsets 1..4 for bands band_pos ..
// band_pos + 3, modulo 32), entry k (k < 5) of an edge CTB the offset of
// edge index k (offset slot 1, 2, 0, 3, 4: ops/sao.py _EDGE_MAP), every
// other entry 0, entry LUT_ZERO among them
__device__ __forceinline__ void build_luts(int* lut, const int* par,
                                           const Tile& t) {
  for (int i = threadIdx.x; i < t.nr * t.nc * LP; i += THREADS) {
    const int e = i / LP, k = i - e * LP;
    const int* q = par + 8 * e;  // type, band, EO class, offsets 0..4
    int off = 0;
    if (k < 32 && q[0] == 1) {
      const int d = (int)(((unsigned)k - (unsigned)q[1]) & 31u);
      if (d < 4) off = q[4 + d];
    } else if (k < 5 && q[0] == 2) {
      off = q[3 + (k < 2 ? k + 1 : (k == 2 ? 0 : k))];
    }
    lut[i] = off;
  }
}

// issue the copies of the block's tile `tile` (if any) into stage slot
// `slot`, as one commit group (empty past the last tile)
__device__ __forceinline__ void issue_tile(int (*buf)[BR * BP],
                                           int (*par)[PR * PC * 8],
                                           const Params& p, int tile,
                                           int slot) {
  if (tile < p.ntiles) {
    const Tile t = tile_at(p, tile);
    load_tile(buf[slot], p, t.c, t.r0, t.x0);
    load_params(par[slot], p, t);
  }
  cp_commit();
}

__global__ void __launch_bounds__(THREADS, MINB) sao_kernel(const Params p) {
  // NSTAGE stages: the copies of the block's next NSTAGE - 1 tiles fly
  // while one is filtered
  __shared__ __align__(16) int buf[NSTAGE][BR * BP];
  __shared__ __align__(16) int par[NSTAGE][PR * PC * 8];
  __shared__ int lut[PR * PC * LP];
  // a launch queued after this one with programmatic stream
  // serialization may start now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k)
    issue_tile(buf, par, p, blockIdx.x + k * gridDim.x, k);
  int s = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    issue_tile(buf, par, p, tile + (NSTAGE - 1) * gridDim.x,
               s ? s - 1 : NSTAGE - 1);
    cp_wait_stages();
    __syncthreads();
    const Tile t = tile_at(p, tile);
    build_luts(lut, par[s], t);
    __syncthreads();
    const int x = t.x0 + 4 * lane;
    const int e0 = min(x >> p.ctb_lg, p.cbw - 1) - t.cx0;
#pragma unroll
    for (int k = 0; k < TH / WARPS; ++k) {
      const int ry = warp + k * WARPS, r = t.r0 + ry;
      if (r < p.Hs && x < p.Wp) {
        const int e = (min(r >> p.ctb_lg, p.cbh - 1) - t.cy0) * t.nc + e0;
        filter_run(p, buf[s], t.c, ry, r, x, lane,
                   *reinterpret_cast<const int4*>(par[s] + 8 * e),
                   lut + e * LP);
      }
    }
    // this slot is refilled by the next trip's copies
    __syncthreads();
    s = s == NSTAGE - 1 ? 0 : s + 1;
  }
  // complete only after the launch this one may overlap
  if (blockIdx.x == 0 && threadIdx.x == 0)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The launch's geometry for nch planes of Hs x Wp output samples: out[0]
// tiles, out[1] blocks (the resident blocks the card holds, at most the
// tiles), out[2] resident blocks per SM, out[3] static shared bytes,
// out[4] SMs, out[5] threads per block.  Returns a cudaError_t.
extern "C" int sao_plan(int nch, int Hs, int Wp, int* out) {
  // per device (the first 32), once: its SMs and resident blocks per SM
  static int known[32][2];
  int dev = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return (int)c;
  int sms = dev < 32 ? known[dev][0] : 0;
  int per = dev < 32 ? known[dev][1] : 0;
  if (!sms) {
    c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (c == cudaSuccess)
      c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, sao_kernel,
                                                        THREADS, 0);
    if (c != cudaSuccess) return (int)c;
    if (dev < 32) {
      known[dev][0] = sms;
      known[dev][1] = per;
    }
  }
  const long long tiles = (long long)nch * ((Hs + TH - 1) / TH)
      * ((Wp + TW - 1) / TW);
  const long long cap = (long long)(per > 0 ? per : 1) * sms;
  out[0] = (int)tiles;
  out[1] = (int)(tiles < cap ? tiles : cap);
  out[2] = per;
  out[3] = (int)(sizeof(int)
                 * (NSTAGE * (BR * BP + PR * PC * 8) + PR * PC * LP));
  out[4] = sms;
  out[5] = THREADS;
  return 0;
}

// src: nch pointers to (He, Wp) int32 planes with row strides pitch;
// dst: (nch, He - 2 * halo, Wp) int32, contiguous.  type, band, eo: nch
// pointers each (the plane's component's (0, 0) element) with strides
// (sy, sx); offv: nch pointers with strides (sy, sx, slot).  cbh, cbw:
// the grids' CTB rows and columns; ctb: a power of 2, at least MIN_CTB.
// flags: F_OVERLAP only when the caller queued the luma launch
// just before this one on the stream and this launch reads nothing it
// writes (the frame program's pair).
extern "C" int sao_launch(const long long* src, const long long* pitch,
                          int* dst, int nch, int He, int Wp, int halo, int y0,
                          int pic_w, int pic_h, int ctb, int bit_depth,
                          const long long* type, const long long* type_st,
                          const long long* band, const long long* band_st,
                          const long long* eo, const long long* eo_st,
                          const long long* offv, const long long* offv_st,
                          int cbh, int cbw, int flags, void* stream) {
  Params p{};
  const int Hs = He - 2 * halo;
  if (!src || !pitch || !dst || nch < 1 || nch > MAX_NCH || halo < 0
      || Hs < 0 || Wp < 1 || ctb < MIN_CTB || (ctb & (ctb - 1)) || cbh < 1
      || cbw < 1
      || bit_depth < 5 || bit_depth > 16
      || !set_grid(&p.type, type, type_st, nch, false)
      || !set_grid(&p.band, band, band_st, nch, false)
      || !set_grid(&p.eo, eo, eo_st, nch, false)
      || !set_grid(&p.offv, offv, offv_st, nch, true))
    return (int)cudaErrorInvalidValue;
  if (Hs == 0) return 0;
  p.vsrc = true;
  for (int c = 0; c < nch; ++c) {
    p.src[c] = (const int*)src[c];
    p.pitch[c] = pitch[c];
    if (!p.src[c] || pitch[c] < Wp) return (int)cudaErrorInvalidValue;
    p.vsrc = p.vsrc && aligned16(p.src[c]) && pitch[c] % 4 == 0;
  }
  p.vdst = Wp % 4 == 0 && aligned16(dst);
  p.dst = dst;
  p.He = He;
  p.Hs = Hs;
  p.Wp = Wp;
  p.halo = halo;
  p.y0 = y0;
  p.pic_w = pic_w;
  p.pic_h = pic_h;
  p.ctb_lg = 31 - __builtin_clz((unsigned)ctb);
  p.cbh = cbh;
  p.cbw = cbw;
  p.bd = bit_depth;
  p.ntx = (Wp + TW - 1) / TW;
  p.nty = (Hs + TH - 1) / TH;
  int plan[6];
  const int e = sao_plan(nch, Hs, Wp, plan);
  if (e) return e;
  p.ntiles = plan[0];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan[1]);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = (flags & F_OVERLAP) ? 1 : 0;
  const cudaError_t c = cudaLaunchKernelEx(&cfg, sao_kernel, p);
  return (int)(c != cudaSuccess ? c : cudaGetLastError());
}

extern "C" const char* sao_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
