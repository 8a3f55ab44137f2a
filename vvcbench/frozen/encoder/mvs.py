"""Motion vector derivation: merge list, AMVP, HMVP (encode-side mirror).

Bit-exact mirror of the reference's derivations (vvc_mvs.c:519-830 merge,
:1404-1604 AMVP, :1760-1800 HMVP update; spec 8.5.2.x), restricted to
the translational, no-TMVP toolset the generator currently emits.

MVs are in 1/16-pel units throughout.  The MvField plane lives at 4x4
granularity (MIN_PU_LOG2 == 2, vvcdec.h:40).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PF_INTRA, PF_L0, PF_L1, PF_BI = 0, 1, 2, 3
MAX_NUM_HMVP = 5

A0, A1, A2, B0, B1, B2, B3 = range(7)


@dataclass
class MvField:
    mv: list = field(default_factory=lambda: [[0, 0], [0, 0]])
    ref_idx: list = field(default_factory=lambda: [-1, -1])
    pred_flag: int = PF_INTRA

    def copy(self) -> "MvField":
        return MvField([list(self.mv[0]), list(self.mv[1])],
                       list(self.ref_idx), self.pred_flag)


def compare_mv_ref_idx(a: MvField | None, b: MvField | None) -> bool:
    if a is None or b is None:
        return False
    if a.pred_flag != b.pred_flag:
        return False
    for i in range(2):
        if a.pred_flag & (i + 1):
            if a.mv[i] != b.mv[i] or a.ref_idx[i] != b.ref_idx[i]:
                return False
    return True


def round_mv(x: int, y: int, lshift: int, rshift: int) -> tuple[int, int]:
    if rshift:
        off = 1 << (rshift - 1)
        x = ((x + off - (x >= 0)) >> rshift) * (1 << lshift)
        y = ((y + off - (y >= 0)) >> rshift) * (1 << lshift)
    else:
        x, y = x << lshift, y << lshift
    return x, y


class MotionState:
    """Per-frame motion context shared by the CU encoder."""

    def __init__(self, pic_w: int, pic_h: int, ctb_log2: int,
                 rpl_pocs: tuple, poc: int = 0, col=None,
                 collocated_from_l0: int = 1):
        # col: (col_poc, pf, mvx, mvy, ridx, col_rpl) snapshot of the
        # collocated picture's motion (TMVP), or None
        self.poc = poc
        self.col = col
        self.collocated_from_l0 = collocated_from_l0
        self.no_backward = int(not any(p > poc for lst in rpl_pocs
                                       for p in lst))
        self.pw = pic_w >> 2
        self.ph = pic_h >> 2
        self.ctb_log2 = ctb_log2
        self.ctb = 1 << ctb_log2
        self.pic_w = pic_w
        self.pic_h = pic_h
        self.rpl = rpl_pocs  # (list0 pocs, list1 pocs)
        # mvf planes at 4x4
        self.pf = np.zeros((self.ph, self.pw), np.int32)
        self.mvx = np.zeros((2, self.ph, self.pw), np.int32)
        self.mvy = np.zeros((2, self.ph, self.pw), np.int32)
        self.ridx = np.full((2, self.ph, self.pw), -1, np.int32)
        self.decoded = np.zeros((self.ph, self.pw), bool)
        self.hmvp: list[MvField] = []

    # -- mvf plane access ----------------------------------------------
    def mvf_at(self, x: int, y: int) -> MvField:
        px, py = x >> 2, y >> 2
        f = MvField()
        f.pred_flag = int(self.pf[py, px])
        for i in range(2):
            f.mv[i] = [int(self.mvx[i, py, px]), int(self.mvy[i, py, px])]
            f.ref_idx[i] = int(self.ridx[i, py, px])
        return f

    def set_mvf(self, x0, y0, w, h, f: MvField) -> None:
        xs, ys = x0 >> 2, y0 >> 2
        xe, ye = (x0 + w) >> 2, (y0 + h) >> 2
        self.pf[ys:ye, xs:xe] = f.pred_flag
        for i in range(2):
            self.mvx[i, ys:ye, xs:xe] = f.mv[i][0]
            self.mvy[i, ys:ye, xs:xe] = f.mv[i][1]
            self.ridx[i, ys:ye, xs:xe] = f.ref_idx[i]
        self.decoded[ys:ye, xs:xe] = True

    def set_intra(self, x0, y0, w, h) -> None:
        self.set_mvf(x0, y0, w, h, MvField(pred_flag=PF_INTRA))

    # -- neighbour availability (vvc_mvs.c:544-620) --------------------
    def _neighbours(self, x0, y0, w, h):
        ctb = self.ctb
        x0b, y0b = x0 & (ctb - 1), y0 & (ctb - 1)
        ctb_left = x0 > 0
        ctb_up = y0 > 0
        cand_left = bool(ctb_left or x0b)
        cand_up = bool(ctb_up or y0b)
        cand_up_left = (cand_left and cand_up) if (x0b or y0b) else \
            (ctb_left and ctb_up)
        # exact mirror of ff_vvc_set_neighbour_available (single tile/slice)
        ctb_up_right = ctb_up
        if x0b + w == ctb:
            sap = ctb_up_right and not y0b
        else:
            sap = cand_up
        cand_up_right = sap and (x0 + w) < self.pic_w

        # A0 availability (is_a0_available, vvc_mvs.c:554-571)
        if not x0b and not ctb_left:
            a0_ok = False
        else:
            max_y = min(self.pic_h, ((y0 >> self.ctb_log2) + 1) << self.ctb_log2)
            if y0 + h >= max_y:
                a0_ok = False
            else:
                a0_ok = self._decoded_at(x0 - 1, y0 + h)
        nbs = {
            A0: (x0 - 1, y0 + h, a0_ok),
            A1: (x0 - 1, y0 + h - 1, cand_left),
            A2: (x0 - 1, y0, cand_left),
            B0: (x0 + w, y0 - 1, cand_up_right),
            B1: (x0 + w - 1, y0 - 1, cand_up),
            B2: (x0 - 1, y0 - 1, cand_up_left),
            B3: (x0, y0 - 1, cand_up),
        }
        return nbs

    def _decoded_at(self, x, y) -> bool:
        if x < 0 or y < 0 or x >= self.pic_w or y >= self.pic_h:
            return False
        return bool(self.decoded[y >> 2, x >> 2])

    def _check(self, nb) -> MvField | None:
        x, y, pre_ok = nb
        if not pre_ok:
            return None
        if not self._decoded_at(x, y):
            return None
        f = self.mvf_at(x, y)
        if f.pred_flag == PF_INTRA:
            return None
        return f

    # -- TMVP (vvc_mvs.c:46-246) ----------------------------------------
    @staticmethod
    def _clip17(v: int) -> int:
        return max(-(1 << 17), min((1 << 17) - 1, int(v)))

    @staticmethod
    def _compress1(v: int) -> int:
        s = v >> 17
        u = (v ^ s) | 31
        f = u.bit_length() - 1 - 4
        mask = (-1 * (1 << f)) >> 1
        rnd = (1 << f) >> 2
        return (v + rnd) & mask

    def _mv_scale(self, src, td: int, tb: int):
        td = max(-128, min(127, td))
        tb = max(-128, min(127, tb))
        tx = (0x4000 + (abs(td) >> 1)) // td if td > 0 else \
            -((0x4000 + (abs(td) >> 1)) // -td)
        sf = (tb * tx + 32) >> 6
        sf = max(-(1 << 12), min((1 << 12) - 1, sf))
        out = []
        for v in src:
            pv = sf * v
            out.append(self._clip17((pv + 127 + (1 if pv < 0 else 0)) >> 8))
        return out

    def _check_mvset(self, tc: MvField, list_col: int, ref_idx_lx: int,
                     x_list: int):
        col_poc, _, _, _, _, col_rpl = self.col
        col_poc_diff = col_poc - col_rpl[list_col][tc.ref_idx[list_col]]
        cur_poc_diff = self.poc - self.rpl[x_list][ref_idx_lx]
        mv_col = [self._compress1(tc.mv[list_col][0]),
                  self._compress1(tc.mv[list_col][1])]
        if col_poc_diff == cur_poc_diff:
            return [self._clip17(mv_col[0]), self._clip17(mv_col[1])]
        return self._mv_scale(mv_col, col_poc_diff, cur_poc_diff)

    def _derive_col_mv(self, tc: MvField, ref_idx_lx: int, x_list: int):
        if tc.pred_flag == PF_INTRA:
            return None
        if not (tc.pred_flag & PF_L0):
            list_col = 1
        elif tc.pred_flag == PF_L0:
            list_col = 0
        else:
            if self.no_backward:
                list_col = x_list
            else:
                list_col = 1 if self.collocated_from_l0 else 0
        return self._check_mvset(tc, list_col, ref_idx_lx, x_list)

    def _col_mvf_at(self, x: int, y: int) -> MvField:
        _, pf, mvx, mvy, ridx, _ = self.col
        px, py = x >> 2, y >> 2
        f = MvField()
        f.pred_flag = int(pf[py, px])
        for i in range(2):
            f.mv[i] = [int(mvx[i, py, px]), int(mvy[i, py, px])]
            f.ref_idx[i] = int(ridx[i, py, px])
        return f

    def temporal_mv(self, x0, y0, w, h, ref_idx_lx: int, x_list: int):
        if self.col is None or w * h <= 32:
            return None
        x, y = x0 + w, y0 + h
        if ((y0 >> self.ctb_log2) == (y >> self.ctb_log2)
                and y < self.pic_h and x < self.pic_w):
            tc = self._col_mvf_at(x & ~7, y & ~7)
            mv = self._derive_col_mv(tc, ref_idx_lx, x_list)
            if mv is not None:
                return mv
        tc = self._col_mvf_at((x0 + (w >> 1)) & ~7, (y0 + (h >> 1)) & ~7)
        return self._derive_col_mv(tc, ref_idx_lx, x_list)

    # -- SbTMVP (8.5.5.3/8.5.5.4; vvc_mvs.c:1000-1120) ------------------
    def _derive_col_mv_sb(self, tc: MvField, x_list: int):
        # sb_flag colocated-list selection: prefer the matching list,
        # other list only when NoBackwardPredFlag
        if tc.pred_flag == PF_INTRA:
            return None
        if tc.pred_flag & (x_list + 1):
            return self._check_mvset(tc, x_list, 0, x_list)
        if self.no_backward and (tc.pred_flag & (2 - x_list)):
            return self._check_mvset(tc, 1 - x_list, 0, x_list)
        return None

    def _sb_col_motion(self, x_ctb, y_ctb, tmv, x, y, is_b) -> MvField:
        yy = max(y_ctb, min(min(self.pic_h - 1, y_ctb + self.ctb - 1),
                            y + tmv[1])) & ~7
        xx = max(x_ctb, min(min(self.pic_w - 1, x_ctb + self.ctb + 3),
                            x + tmv[0])) & ~7
        tc = self._col_mvf_at(xx, yy)
        m = MvField()
        m.pred_flag = 0
        m.ref_idx = [0, 0]
        mv = self._derive_col_mv_sb(tc, 0)
        if mv is not None:
            m.pred_flag |= PF_L0
            m.mv[0] = mv
        if is_b:
            mv = self._derive_col_mv_sb(tc, 1)
            if mv is not None:
                m.pred_flag |= PF_L1
                m.mv[1] = mv
        return m

    def sb_merge_mode(self, x0, y0, w, h, is_b: bool) -> None:
        """Derive + store the SbTMVP candidate's per-8x8 motion; zero
        translational fallback when the centre motion is unavailable."""
        x_ctb = (x0 >> self.ctb_log2) << self.ctb_log2
        y_ctb = (y0 >> self.ctb_log2) << self.ctb_log2
        ctr = MvField()
        ctr.pred_flag = 0
        tmv = [0, 0]
        if self.col is not None:
            col_poc = self.col[0]
            a1 = self._check(self._neighbours(x0, y0, w, h)[A1])
            if a1 is not None:
                if (a1.pred_flag & PF_L0) and \
                        col_poc == self.rpl[0][a1.ref_idx[0]]:
                    tmv = list(a1.mv[0])
                elif (a1.pred_flag & PF_L1) and \
                        col_poc == self.rpl[1][a1.ref_idx[1]]:
                    tmv = list(a1.mv[1])
                tmv = list(round_mv(tmv[0], tmv[1], 0, 4))
            ctr = self._sb_col_motion(x_ctb, y_ctb, tmv,
                                      x0 + w // 2, y0 + h // 2, is_b)
        if ctr.pred_flag:
            for sy in range(y0, y0 + h, 8):
                for sx in range(x0, x0 + w, 8):
                    m = self._sb_col_motion(x_ctb, y_ctb, tmv,
                                            sx + 4, sy + 4, is_b)
                    if not m.pred_flag:
                        m = ctr.copy()
                    self.set_mvf(sx, sy, 8, 8, m)
        else:
            m = MvField()
            m.pred_flag = PF_L0 + (2 if is_b else 0)
            m.ref_idx = [0, 0]
            self.set_mvf(x0, y0, w, h, m)

    # -- merge list (vvc_mvs.c:637-830) --------------------------------
    def merge_candidate(self, x0, y0, w, h, merge_idx: int,
                        max_num_merge: int, is_b: bool,
                        num_ref_idx_active) -> MvField:
        nbs = self._neighbours(x0, y0, w, h)
        nb_list: dict = {}
        cand_list: list[MvField] = []

        def spatial(nb, olds):
            cand = self._check(nbs[nb])
            nb_list[nb] = cand
            if cand is None:
                return None
            for old in olds:
                if compare_mv_ref_idx(cand, nb_list.get(old)):
                    return None
            return cand

        for nb, olds in ((B1, ()), (A1, (B1,)), (B0, (B1,)), (A0, (A1,))):
            c = spatial(nb, olds)
            if c is not None:
                cand_list.append(c.copy())
                if merge_idx == len(cand_list) - 1:
                    return cand_list[merge_idx]
        if len(cand_list) != 4:
            c = spatial(B2, (A1, B1))
            if c is not None:
                cand_list.append(c.copy())
                if merge_idx == len(cand_list) - 1:
                    return cand_list[merge_idx]
        # temporal candidate (mv_merge_temporal_candidate, vvc_mvs.c:678)
        if self.col is not None:
            c = MvField()
            m0 = self.temporal_mv(x0, y0, w, h, 0, 0)
            m1 = self.temporal_mv(x0, y0, w, h, 0, 1) if is_b else None
            c.pred_flag = ((PF_L0 if m0 is not None else 0)
                           | (PF_L1 if m1 is not None else 0))
            if c.pred_flag:
                if m0 is not None:
                    c.mv[0] = m0
                if m1 is not None:
                    c.mv[1] = m1
                c.ref_idx = [0, 0]
                cand_list.append(c)
                if merge_idx == len(cand_list) - 1:
                    return cand_list[merge_idx]
        # HMVP (vvc_mvs.c:692-709)
        for i in range(1, len(self.hmvp) + 1):
            if len(cand_list) >= max_num_merge - 1:
                break
            hc = self.hmvp[len(self.hmvp) - i]
            same = i <= 2 and (compare_mv_ref_idx(hc, nb_list.get(A1))
                               or compare_mv_ref_idx(hc, nb_list.get(B1)))
            if not same:
                cand_list.append(hc.copy())
                if merge_idx == len(cand_list) - 1:
                    return cand_list[merge_idx]
        # pairwise average
        if len(cand_list) > 1:
            p0, p1 = cand_list[0], cand_list[1]
            cand = MvField()
            n_lists = 2 if is_b else 1
            for i in range(n_lists):
                mask = i + 1
                if p0.pred_flag & mask:
                    cand.pred_flag |= mask
                    cand.ref_idx[i] = p0.ref_idx[i]
                    if p1.pred_flag & mask:
                        mx = p0.mv[i][0] + p1.mv[i][0]
                        my = p0.mv[i][1] + p1.mv[i][1]
                        cand.mv[i] = list(round_mv(mx, my, 0, 1))
                    else:
                        cand.mv[i] = list(p0.mv[i])
                elif p1.pred_flag & mask:
                    cand.pred_flag |= mask
                    cand.mv[i] = list(p1.mv[i])
                    cand.ref_idx[i] = p1.ref_idx[i]
            if cand.pred_flag:
                cand_list.append(cand)
                if merge_idx == len(cand_list) - 1:
                    return cand_list[merge_idx]
        # zero candidates
        num_ref = (num_ref_idx_active[0] if not is_b
                   else min(num_ref_idx_active[0], num_ref_idx_active[1]))
        zero_idx = 0
        while len(cand_list) < max_num_merge:
            cand = MvField()
            cand.pred_flag = PF_L0 + ((1 if is_b else 0) << 1)
            ri = zero_idx if zero_idx < num_ref else 0
            cand.ref_idx = [ri, ri]
            cand_list.append(cand)
            if merge_idx == len(cand_list) - 1:
                return cand_list[merge_idx]
            zero_idx += 1
        return cand_list[merge_idx]

    # -- AMVP (vvc_mvs.c:1404-1604) ------------------------------------
    def _mvp_candidate(self, f: MvField, lx: int, ref_idx) -> list | None:
        poc = self.rpl[lx][ref_idx[lx]]
        if (f.pred_flag & (lx + 1)) and \
                self.rpl[lx][f.ref_idx[lx]] == poc:
            return list(f.mv[lx])
        ly = 1 - lx
        if (f.pred_flag & (ly + 1)) and f.ref_idx[ly] >= 0 and \
                self.rpl[ly][f.ref_idx[ly]] == poc:
            return list(f.mv[ly])
        return None

    def mvp(self, x0, y0, w, h, mvp_lx_flag: int, lx: int, ref_idx,
            amvr_shift: int) -> list:
        nbs = self._neighbours(x0, y0, w, h)
        num_cands = 0
        mv_a = None

        def from_nbs(idxs):
            for nb in idxs:
                f = self._check(nbs[nb])
                if f is not None:
                    mv = self._mvp_candidate(f, lx, ref_idx)
                    if mv is not None:
                        return list(round_mv(mv[0], mv[1], amvr_shift,
                                             amvr_shift))
            return None

        mv = from_nbs((A0, A1))
        if mv is not None:
            if mvp_lx_flag == num_cands:
                return mv
            num_cands += 1
            mv_a = mv
        mvb = from_nbs((B0, B1, B2))
        if mvb is not None:
            if mv_a is None or mv_a != mvb:
                if mvp_lx_flag == num_cands:
                    return mvb
                num_cands += 1
        # temporal candidate (mvp_temporal_candidates, vvc_mvs.c:1526)
        if self.col is not None:
            tmv = self.temporal_mv(x0, y0, w, h, ref_idx[lx], lx)
            if tmv is not None:
                if mvp_lx_flag == num_cands:
                    return list(round_mv(tmv[0], tmv[1], amvr_shift,
                                         amvr_shift))
                num_cands += 1
        # HMVP (vvc_mvs.c:1543-1568)
        poc = self.rpl[lx][ref_idx[lx]]
        for i in range(1, min(4, len(self.hmvp)) + 1):
            hc = self.hmvp[i - 1]
            for j in range(2):
                ly = (1 - lx) if j else lx
                if (hc.pred_flag & (ly + 1)) and hc.ref_idx[ly] >= 0 and \
                        poc == self.rpl[ly][hc.ref_idx[ly]]:
                    if mvp_lx_flag == num_cands:
                        return list(round_mv(hc.mv[ly][0], hc.mv[ly][1],
                                             amvr_shift, amvr_shift))
                    num_cands += 1
        return [0, 0]

    # -- HMVP update (vvc_mvs.c:1770-1800) -----------------------------
    def update_hmvp(self, f: MvField) -> None:
        # parallel merge level 2: is_greater_mer always true for cb>=4
        for i, h in enumerate(self.hmvp):
            if compare_mv_ref_idx(f, h):
                self.hmvp.pop(i)
                break
        else:
            if len(self.hmvp) == MAX_NUM_HMVP:
                self.hmvp.pop(0)
        self.hmvp.append(f.copy())
