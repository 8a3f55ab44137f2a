// The host library's parser unit: decode.cc, the parser, kept
// byte-equal to the JAX package's copy (tests/test_torch_tables.py),
// compiled in this translation unit with the entry points that only the
// port has, which read its FrameOut and records directly.
#include <cstdlib>

// decode.cc's types use its anonymous namespace, which g++ flags in an
// included file; no other unit sees them
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wsubobject-linkage"
#include "decode.cc"
#pragma GCC diagnostic pop

namespace vvc {
namespace {

// ---- deblock edge grids (vvch_fo_deblock_grids) ----
// Parity: vvc_deblock_bs* and the max-filter-length derivations,
// vvc_filter.c:308-751; the port's plain version is
// models/vvc/inputs.py _deblock_grids_plain (deblock_ctrl.py).

// One component's TUs on its g-sample cells (gh x gw, row-major): each
// cell's covering TU record (the last in the list, as
// deblock_ctrl._tu_grids_cbf), or a zero record with qp qp_bd_offset
// where none covers it, and the deblock cbf, OR'd over the covering
// TUs: the parsed tu_coded_flag, and the joint-CbCr derived-component
// flag for chroma (vvc_filter.c:680-684).
struct TuGrid {
  int gw = 0, gh = 0, qp_off = 0;
  TuRecord none{};
  std::vector<const TuRecord*> tu;
  std::vector<uint8_t> cbf;
  TuGrid(const FrameOut& fo, int c_idx, int g, int qp_bd_offset)
      : qp_off(qp_bd_offset) {
    const int ss = c_idx == 0 ? 0 : 1;
    gw = (fo.width >> ss) / g;
    gh = (fo.height >> ss) / g;
    none.qp = qp_bd_offset;
    tu.assign((size_t)gw * gh, &none);
    cbf.assign((size_t)gw * gh, 0);
    for (const TuRecord& r : fo.tus) {
      if (r.c_idx != c_idx) continue;
      const uint8_t coded = r.coded || (c_idx && r.jop > 0);
      const int xe = std::min((r.x0 + r.w) / g, gw);
      for (int y = r.y0 / g; y < (r.y0 + r.h) / g && y < gh; y++) {
        const size_t row = (size_t)y * gw;
        for (int x = r.x0 / g; x < xe; x++) {
          tu[row + x] = &r;
          cbf[row + x] |= coded;
        }
      }
    }
  }
  // a TU's start and size across the edges of one orientation
  static int32_t start(const TuRecord& r, bool horizontal) {
    return horizontal ? r.y0 : r.x0;
  }
  static int32_t size(const TuRecord& r, bool horizontal) {
    return horizontal ? r.h : r.w;
  }
};

// the 4x4 motion planes as boundary strength reads them: CIIP cells as
// intra (the bs-2 rule is "P or Q intra or ciip", vvc_filter.c:537),
// reference indices as POCs, an unused list's as -(10^6) - lx.  Raw
// pointers, copied into each loop's locals: the loops' int8 stores may
// alias any memory the compiler cannot see is theirs alone.
struct DbkMotion {
  const int32_t *pf_, *ciip, *ref[2], *mx[2], *my[2];
  const int32_t (*pocs)[16];
  int nb[2];
  explicit DbkMotion(const FrameOut& fo)
      : pf_(fo.mvf_pf.data()), ciip(fo.mvf_ciip.data()),
        ref{fo.mvf_ref.data(), fo.mvf_ref1.data()},
        mx{fo.mvf_x.data(), fo.mvf_x1.data()},
        my{fo.mvf_y.data(), fo.mvf_y1.data()}, pocs(fo.ref_pocs),
        nb{std::min(fo.nb_refs[0], 16), std::min(fo.nb_refs[1], 16)} {}
  int32_t pf(size_t i) const { return ciip[i] > 0 ? 0 : pf_[i]; }
  int32_t poc(int lx, size_t i) const {
    const int32_t r = ref[lx][i];
    return r >= 0 && r < nb[lx] ? pocs[lx][r] : -1000000 - lx;
  }
  int32_t mvx(int lx, size_t i) const { return mx[lx][i]; }
  int32_t mvy(int lx, size_t i) const { return my[lx][i]; }
};

inline bool mv_far(int32_t ax, int32_t ay, int32_t bx, int32_t by) {
  return std::abs(ax - bx) >= 8 || std::abs(ay - by) >= 8;
}

// boundary strength between cells p and q from their prediction, cbf
// and motion (boundary_strength, vvc_filter.c:308-372)
inline int bs_between(const DbkMotion& m, size_t p, size_t q, int32_t cbf_p,
                      int32_t cbf_q) {
  const int32_t pfp = m.pf(p), pfq = m.pf(q);
  if (pfp == PF_INTRA || pfq == PF_INTRA) return 2;
  if ((cbf_p | cbf_q) > 0) return 1;
  // whether the MV of list a at q and of list b at p are 8 or more
  // (half a sample) apart in either component
  auto far = [&](int a, int b) {
    return mv_far(m.mvx(a, q), m.mvy(a, q), m.mvx(b, p), m.mvy(b, p));
  };
  if (pfp == PF_BI && pfq == PF_BI) {
    const bool direct = far(0, 0) || far(1, 1);
    const bool cross = far(1, 0) || far(0, 1);
    const int32_t P0 = m.poc(0, p), P1 = m.poc(1, p);
    const int32_t Q0 = m.poc(0, q), Q1 = m.poc(1, q);
    if (P0 == Q0 && P0 == P1 && Q0 == Q1) return direct && cross;
    if (Q0 == P0 && Q1 == P1) return direct;
    if (Q1 == P0 && Q0 == P1) return cross;
    return 1;
  }
  if (pfp != PF_BI && pfq != PF_BI) {
    // one MV a side: the list each side uses
    const int lp = pfp == PF_L0 ? 0 : 1, lq = pfq == PF_L0 ? 0 : 1;
    return m.poc(lp, p) != m.poc(lq, q) || far(lq, lp);
  }
  return 1;
}

// a (gh, gw) plane marking the cells of component c_idx's BDPCM TUs
// (pcmf) at g-sample granularity; empty when the frame has none
std::vector<int32_t> pcmf_plane(const FrameOut& fo, int c_idx, int g,
                                int gw, int gh) {
  std::vector<int32_t> pl;
  for (const TuRecord& tu : fo.tus) {
    if (tu.c_idx != c_idx || tu.pcmf != 1) continue;
    if (pl.empty()) pl.assign((size_t)gw * gh, 0);
    const int xe = std::min((tu.x0 + tu.w) / g, gw);
    for (int y = tu.y0 / g; y < (tu.y0 + tu.h) / g && y < gh; y++)
      for (int x = tu.x0 / g; x < xe; x++) pl[(size_t)y * gw + x] = 1;
  }
  return pl;
}

// per-4x4-cell planes of the subblock-motion CUs (SbTMVP or affine,
// tab.msf's analog): flag, CU top-left and size; empty when the frame
// has none
struct SbGrid {
  std::vector<int32_t> msf, cbx, cby, cbw, cbh;
  SbGrid(const FrameOut& fo, int gw, int gh) {
    for (const CuRecord& cu : fo.cus) {
      if (!(cu.sbtmvp > 0 || cu.affine > 0) || cu.pred_mode != MODE_INTER)
        continue;
      if (msf.empty())
        for (auto* v : {&msf, &cbx, &cby, &cbw, &cbh})
          v->assign((size_t)gw * gh, 0);
      const int xe = std::min((cu.x0 + cu.w) / 4, gw);
      for (int y = cu.y0 / 4; y < (cu.y0 + cu.h) / 4 && y < gh; y++)
        for (int x = cu.x0 / 4; x < xe; x++) {
          const size_t i = (size_t)y * gw + x;
          msf[i] = 1;
          cbx[i] = cu.x0;
          cby[i] = cu.y0;
          cbw[i] = cu.w;
          cbh[i] = cu.h;
        }
    }
  }
};

// The cells on either side of edge e of segment s, in one orientation
// of a (gh, gw) grid: vertical edges run along the rows (segment = row,
// edge = column), horizontal ones along the columns (segment = column,
// edge = row); each output grid is (S, E) with segment s at row s.
// each<every>(f) calls f(s, e, p, q) for every cell q = (s, e) with e >= 1
// whose edge index is a multiple of `every` (edge e / every), p the cell
// before it across the edge.  Vertical edges go in the grid's row-major
// order; horizontal ones a band of 8 edges at a time, segment by
// segment, so that the reads go along the rows and the writes along
// the segments.
struct Orient {
  bool horizontal;
  int gw, gh;
  template <int every, class F>
  void each(F f) const {
    if (!horizontal) {
      for (int y = 0; y < gh; y++)
        for (int x = every; x < gw; x += every) {
          const size_t q = (size_t)y * gw + x;
          f(y, x / every, q - 1, q);
        }
      return;
    }
    for (int e0 = 1; e0 * every < gh; e0 += 8)
      for (int x = 0; x < gw; x++)
        for (int e = e0; e < e0 + 8 && e * every < gh; e++) {
          const size_t q = (size_t)e * every * gw + x;
          f(x, e, q - gw, q);
        }
  }
};

// One luma orientation (4-sample cells; an edge wherever the Q cell's
// TU starts): bs, averaged qp and max filter lengths 1/3/7, the
// subblock-motion CUs' clamp to 5 and their internal edges every 8
// samples (derive_max_filter_length_luma and vvc_deblock_subblock_bs_*,
// vvc_filter.c:374-478).
void luma_edges(const TuGrid& t, bool horizontal, const DbkMotion& motion,
                const std::vector<int32_t>& pcmf_plane, const SbGrid& sb,
                int E, int8_t* bs, int8_t* qpa, int8_t* maxp, int8_t* maxq) {
  const DbkMotion m = motion;  // locals: see DbkMotion
  const TuRecord* const* tu = t.tu.data();
  const uint8_t* cbf = t.cbf.data();
  const int32_t qp_off = t.qp_off;
  const int32_t* pcmf = pcmf_plane.empty() ? nullptr : pcmf_plane.data();
  const int32_t* msf = sb.msf.empty() ? nullptr : sb.msf.data();
  const int32_t* cb0 = horizontal ? sb.cby.data() : sb.cbx.data();
  const int32_t* cbs = horizontal ? sb.cbh.data() : sb.cbw.data();
  Orient{horizontal, t.gw, t.gh}.each<1>([&](int s, int e, size_t p,
                                             size_t q) {
    const TuRecord &tp = *tu[p], &tq = *tu[q];
    const size_t out = (size_t)s * E + e;
    qpa[out] = (int8_t)((tp.qp + tq.qp - 2 * qp_off + 1) >> 1);
    int b = 0, mp = 0, mq = 0;
    if (TuGrid::start(tq, horizontal) == 4 * e) {
      b = bs_between(m, p, q, cbf[p], cbf[q]);
      // both sides BDPCM: no filtering (vvc_filter.c:556,677)
      if (pcmf && (pcmf[p] & pcmf[q]) > 0) b = 0;
      const int32_t sp = TuGrid::size(tp, horizontal);
      const int32_t sq = TuGrid::size(tq, horizontal);
      const bool small = sp <= 4 || sq <= 4;
      mp = small ? 1 : (sp >= 32 ? 7 : 3);
      mq = small ? 1 : (sq >= 32 ? 7 : 3);
      if (msf && msf[p] > 0) mp = std::min(mp, 5);
      if (msf && msf[q] > 0 && cbs[q] > 8) mq = std::min(mq, 5);
    } else if (msf && msf[q] > 0) {
      const int32_t dist = 4 * e - cb0[q];
      if (dist > 0 && dist % 8 == 0 && dist < cbs[q]) {
        b = bs_between(m, p, q, 0, 0);
        mp = mq = (dist == 8 || dist == cbs[q] - 8) ? 2 : 3;
      }
    }
    bs[out] = (int8_t)b;
    maxp[out] = (int8_t)mp;
    maxq[out] = (int8_t)mq;
  });
}

// One chroma orientation (2-sample cells, edges every 8 samples: every
// 4 cells): bs 2 for an intra side, else 1 for a cbf, else 0 (no
// motion term, vvc_filter.c:737); max filter lengths 3 where both
// sides are 8 or more, else bs == 2; maxp 1 on the CTU-edge rows of the
// horizontal pass (ctb: the luma CTB size; 0 for the vertical pass).
void chroma_edges(const TuGrid& t, bool horizontal, const DbkMotion& motion,
                  const std::vector<int32_t>& pcmf_plane, int ctb, int E,
                  int8_t* bs, int8_t* qpa, int8_t* maxp, int8_t* maxq) {
  const DbkMotion m = motion;  // locals: see DbkMotion
  const TuRecord* const* tu = t.tu.data();
  const uint8_t* cbf = t.cbf.data();
  const int32_t qp_off = t.qp_off;
  const int32_t* pcmf = pcmf_plane.empty() ? nullptr : pcmf_plane.data();
  Orient{horizontal, t.gw, t.gh}.each<4>([&](int s, int e, size_t p,
                                             size_t q) {
    const TuRecord &tp = *tu[p], &tq = *tu[q];
    const size_t out = (size_t)s * E + e;
    qpa[out] = (int8_t)((tp.qp + tq.qp - 2 * qp_off + 1) >> 1);
    int b = 0, mp = 0, mq = 0;
    if (TuGrid::start(tq, horizontal) == 8 * e) {
      b = (m.pf(p) == PF_INTRA || m.pf(q) == PF_INTRA)
              ? 2
              : ((cbf[p] | cbf[q]) > 0 ? 1 : 0);
      if (pcmf && (pcmf[p] & pcmf[q]) > 0) b = 0;
      const bool big = TuGrid::size(tp, horizontal) >= 8 &&
                       TuGrid::size(tq, horizontal) >= 8;
      mp = mq = big ? 3 : (b == 2);
      if (ctb && big && (e * 16) % ctb == 0) mp = 1;
    }
    bs[out] = (int8_t)b;
    maxp[out] = (int8_t)mp;
    maxq[out] = (int8_t)mq;
  });
}

}  // namespace

extern "C" {

// The frame's deblock edge grids, int8, in one pass over the detached
// FrameOut (models/vvc/inputs.py _deblock_grids; its plain version
// _deblock_grids_plain gives the same bytes).  out: n_out pointers to
// row-major int8 grids that this call fills whole, in the order
//   ybs_v, yqp_v, ymp_v, ymq_v, yhor0   (Hp_y/4, Wp_y/4)
//   ybs_h, yqp_h, ymp_h, ymq_h, yhor    (Wp_y/4, Hp_y/4)
// and for 4:2:0 (n_out 26; 4:0:0 takes 10), per chroma component c,
//   c{c}bs_v, qp_v, mp_v, mq_v          (Hp_c/2, Wp_c/8)
//   c{c}bs_h, qp_h, mp_h, mq_h          (Wp_c/2, Hp_c/8)
// Reads the parse's motion planes (fo.mvf_*), which vvch_dmvr_apply
// leaves as they are.  Returns 0, or -1 where the grids cannot hold the
// frame or n_out does not fit its chroma format.
int vvch_fo_deblock_grids(void* fo_, int Hp_y, int Wp_y, int Hp_c, int Wp_c,
                          int ctb_log2, int qp_bd_offset, int n_out,
                          int8_t** out) {
  const FrameOut& fo = *(const FrameOut*)fo_;
  const bool chroma = fo.chroma_format_idc != 0;
  if (n_out != (chroma ? 26 : 10)) return -1;
  const TuGrid y(fo, 0, 4, qp_bd_offset);
  const size_t cells = (size_t)y.gw * y.gh;
  for (const auto* v : {&fo.mvf_pf, &fo.mvf_x, &fo.mvf_y, &fo.mvf_ref,
                        &fo.mvf_x1, &fo.mvf_y1, &fo.mvf_ref1, &fo.mvf_ciip})
    if (v->size() != cells) return -1;
  const int Sv = Hp_y / 4, Ev = Wp_y / 4, Sh = Wp_y / 4, Eh = Hp_y / 4;
  if (y.gh > Sv || y.gw > Ev) return -1;
  for (int k = 0; k < 10; k++) std::memset(out[k], 0, (size_t)Sv * Ev);
  const DbkMotion m(fo);
  const SbGrid sb(fo, y.gw, y.gh);
  const std::vector<int32_t> pcmf_y = pcmf_plane(fo, 0, 4, y.gw, y.gh);
  luma_edges(y, false, m, pcmf_y, sb, Ev, out[0], out[1], out[2], out[3]);
  luma_edges(y, true, m, pcmf_y, sb, Eh, out[5], out[6], out[7], out[8]);
  const int ctb = 1 << ctb_log2;
  // yhor: the horizontal edges on a CTU row's top, the same for every
  // segment
  for (int e = 0; e < Eh; e++) out[9][e] = (e * 4) % ctb == 0;
  for (int s = 1; s < Sh; s++)
    std::memcpy(out[9] + (size_t)s * Eh, out[9], Eh);
  if (!chroma) return 0;
  const int Scv = Hp_c / 2, Ecv = Wp_c / 8, Sch = Wp_c / 2, Ech = Hp_c / 8;
  for (int c = 1; c <= 2; c++) {
    const TuGrid t(fo, c, 2, qp_bd_offset);
    // the chroma cells are the motion planes' 4x4 luma cells
    if (t.gw != y.gw || t.gh != y.gh) return -1;
    if (t.gh > Scv || (t.gw + 3) / 4 > Ecv || t.gw > Sch ||
        (t.gh + 3) / 4 > Ech)
      return -1;
    // CB records mark the shared chroma BDPCM plane
    const std::vector<int32_t> pcmf_c = pcmf_plane(fo, 1, 2, t.gw, t.gh);
    int8_t** g = out + 10 + 8 * (c - 1);
    for (int k = 0; k < 4; k++) std::memset(g[k], 0, (size_t)Scv * Ecv);
    for (int k = 4; k < 8; k++) std::memset(g[k], 0, (size_t)Sch * Ech);
    chroma_edges(t, false, m, pcmf_c, 0, Ecv, g[0], g[1], g[2], g[3]);
    chroma_edges(t, true, m, pcmf_c, ctb, Ech, g[4], g[5], g[6], g[7]);
  }
  return 0;
}

}  // extern "C"

}  // namespace vvc
