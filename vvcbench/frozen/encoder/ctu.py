"""CTU-level syntax encoder: coding tree, intra CU, transform units.

Bin-exact mirror of the coding_tree_unit()/coding_unit()/transform_unit()
syntax (H.266 7.3.11.2-10); behavioural parity target is the decode side
in `libavcodec/vvc/vvc_ctu.c:947-2330` and `vvc_cabac.c:950-1780`.

v1 feature set (all-intra): single tree, no QT/BT/TT split flags (stream
configs keep MinQtSize == CTU and MaxMttDepth == 0 or use explicit legal
split decisions), normal intra modes with MPM, chroma DM/planar/angular,
per-TB CBFs, regular residual coding.  Tools off: MIP, MRL, ISP, CCLM,
BDPCM, transform-skip, LFNST, MTS, dep-quant, sign hiding.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.cabac import CTX, ContextTable
from .native_cabac import NativeCabac
from .residual import ResidualEncoder

MODE_INTER, MODE_INTRA = 0, 1
INTRA_PLANAR, INTRA_DC, INTRA_HORZ, INTRA_VERT = 0, 1, 18, 50


def _sao_off() -> dict:
    return {"merge": None, "type": [0, 0, 0],
            "offset_abs": [[0] * 4 for _ in range(3)],
            "offset_sign": [[0] * 4 for _ in range(3)],
            "band_position": [0, 0, 0], "eo_class": [0, 0, 0]}


def rpl_pocs(poc: int, rpls, max_poc_lsb: int = 256) -> list[int]:
    """Reference POCs from a RefPicListStruct (ST delta chain + LT
    entries resolved via the MSB-cycle formula, spec 8.3.2)."""
    out = []
    base = poc
    prev_delta = 0
    for e in rpls.entries:
        if e[0] == "lt":
            _, lsb, msb_cycle = e
            delta = msb_cycle + prev_delta
            out.append(lsb + poc - delta * max_poc_lsb
                       - (poc & (max_poc_lsb - 1)))
            prev_delta = delta
            continue
        abs_delta, sign = e
        d = -abs_delta if sign else abs_delta
        base += d
        out.append(base)
    return out


def _rpl_deltas(rpls) -> list[int]:
    """Cumulative POC deltas (current - ref); ST-only lists."""
    return [-d for d in rpl_pocs(0, rpls)]


def mpm_candidates(a: int, b: int) -> list[int]:
    """Spec 8.4.2 MPM list from left mode `a` and above mode `b`."""
    if a == b and a > INTRA_DC:
        return [a, 2 + ((a + 61) % 64), 2 + ((a - 1) % 64),
                2 + ((a + 60) % 64), 2 + (a % 64)]
    minab, maxab = min(a, b), max(a, b)
    if a > INTRA_DC and b > INTRA_DC:
        diff = maxab - minab
        cand = [a, b]
        if diff == 1:
            cand += [2 + ((minab + 61) % 64), 2 + ((maxab - 1) % 64),
                     2 + ((minab + 60) % 64)]
        elif diff >= 62:
            cand += [2 + ((minab - 1) % 64), 2 + ((maxab + 61) % 64),
                     2 + (minab % 64)]
        elif diff == 2:
            cand += [2 + ((minab - 1) % 64), 2 + ((minab + 61) % 64),
                     2 + ((maxab - 1) % 64)]
        else:
            cand += [2 + ((minab + 61) % 64), 2 + ((minab - 1) % 64),
                     2 + ((maxab + 61) % 64)]
        return cand
    if a > INTRA_DC or b > INTRA_DC:
        return [maxab, 2 + ((maxab + 61) % 64), 2 + ((maxab - 1) % 64),
                2 + ((maxab + 60) % 64), 2 + (maxab % 64)]
    return [INTRA_DC, INTRA_VERT, INTRA_HORZ, INTRA_VERT - 4, INTRA_VERT + 4]


@dataclass
class CuIntent:
    """One CU's chosen syntax (the generator's ground truth)."""
    x0: int
    y0: int
    w: int
    h: int
    pred_mode: str = "intra"  # "intra" | "inter"
    luma_mode: int = INTRA_PLANAR
    # chroma mode syntax value: 4 = DM, 0..3 = planar/vert/horz/dc list
    chroma_mode_idx: int = 4
    # inter fields
    skip: bool = False
    merge: bool = False
    merge_idx: int = 0
    pred_list: str = "L0"    # AMVP: "L0" | "L1" | "BI"
    mvp_flag: int = 0
    mvd: tuple = (0, 0)      # quarter-pel units (pre amvr shift)
    mvp_flag1: int = 0
    mvd1: tuple = (0, 0)
    amvr_shift: int = 2      # 2 (off) / 3 / 4 / 6
    bcw_idx: int = 0         # BI only, w*h >= 256
    mmvd: tuple | None = None  # (cand_flag, distance_idx, direction)
    sbtmvp: bool = False     # merge_subblock_flag (subblock merge)
    affine_params: tuple | None = None  # AMVP affine: (model_idc,
                                        #  [cp mvds L0], [cp mvds L1])
    ciip: bool = False       # combined inter/intra (merge, w*h >= 64)
    gpm: tuple | None = None  # (partition_idx, merge_idx0, merge_idx1)
    # filled during encoding: derived final MVs (1/16 pel) + refs
    pred_flag: int = 0       # PF_* of the final motion
    mv: tuple | None = None
    ref_idx: int = 0
    mv1: tuple | None = None
    ref_idx1: int = -1
    # per-component coeff arrays (raster, chroma at chroma resolution) or None
    coeff_y: np.ndarray | None = None
    coeff_cb: np.ndarray | None = None
    coeff_cr: np.ndarray | None = None
    # explicit MTS index (0=DCT2, 1..4 = DST7/DCT8 combos); only legal
    # when the CU is MTS-eligible (checked at encode time)
    mts_idx: int = 0
    # BDPCM (forces luma/chroma mode HORZ/VERT and transform skip)
    bdpcm_l: int = 0
    bdpcm_c: int = 0
    bdpcm_dir_c: int = 0  # 0 = HORZ, 1 = VERT
    # LFNST index (0 off, 1..2 kernel); only when the CU is eligible
    lfnst_idx: int = 0
    # MIP (matrix-based intra prediction): mode (-1 = off) + transpose
    mip_mode: int = -1
    # ISP (intra sub-partitions): 0 none, 1 HOR, 2 VER + part count
    isp: int = 0
    isp_parts: int = 1
    mip_transposed: int = 0
    # CCLM chroma mode: -1 off, 0 LT / 1 L / 2 T
    cclm_idx: int = -1
    # MRL: reference line (0 off, 1/2) + which MPM candidate to use
    mrl_idx: int = 0
    mrl_mpm_idx: int = 0
    # dual-tree membership: "single" | "luma" | "chroma"
    tree: str = "single"
    # SBT (subblock transform): None off, else (quad, horizontal, pos)
    sbt: tuple | None = None


class FrameSyntaxEncoder:
    """Encodes slice data (all CTUs) of one frame."""

    def __init__(self, sps, pps, sh, col_store=None):
        from .tree import PartitionCtx

        self.col_store = col_store or {}
        self.sps = sps
        # cu_qp_delta quantization-group state (mirrors vvc_ctu.c)
        self.cu_qp_delta_enabled = bool(
            getattr(pps, "pps_cu_qp_delta_enabled_flag", 0))
        self.cu_qp_delta_subdiv = (
            sh.ph.ph_cu_qp_delta_subdiv_intra_slice
            if sh.sh_slice_type == 2
            else sh.ph.ph_cu_qp_delta_subdiv_inter_slice)
        self.is_cu_qp_delta_coded = False
        self.qg_pending_delta = 0
        self.qp_delta_rng = None  # set by the stream generator
        self.tool_rng = None      # rng for per-TU tool choices
        self.cu_first_tb_ts = -1  # ts of the CU's first luma TB
        self.cu_any_coded_ts = False
        self.prev_tu_cbf_y = 0    # ISP cbf ctx chain
        self.infer_tu_cbf_luma = 1
        self.pps = pps
        self.sh = sh
        self.width = pps.pps_pic_width_in_luma_samples
        self.height = pps.pps_pic_height_in_luma_samples
        self.ctb_log2 = sps.ctb_log2_size_y
        self.ctb_size = 1 << self.ctb_log2
        self.ctb_w = (self.width + self.ctb_size - 1) >> self.ctb_log2
        self.ctb_h = (self.height + self.ctb_size - 1) >> self.ctb_log2
        self.min_cb_log2 = sps.sps_log2_min_luma_coding_block_size_minus2 + 2
        min_cb = 1 << self.min_cb_log2
        min_qt = 1 << (sps.sps_log2_diff_min_qt_min_cb_intra_slice_luma
                       + self.min_cb_log2)
        self.pc = PartitionCtx(
            min_cb_size=min_cb,
            min_qt_size=min_qt,
            max_bt_size=min_qt << sps.sps_log2_diff_max_bt_min_qt_intra_slice_luma,
            max_tt_size=min_qt << sps.sps_log2_diff_max_tt_min_qt_intra_slice_luma,
            max_mtt_depth=sps.sps_max_mtt_hierarchy_depth_intra_slice_luma,
            pic_width=self.width, pic_height=self.height)
        mw = self.width >> self.min_cb_log2
        mh = self.height >> self.min_cb_log2
        # per-min-CB tables mirroring fc->tab
        self.tab_ipm = np.zeros((mh, mw), dtype=np.int32)
        self.tab_cpm = np.zeros((mh, mw), dtype=np.int32)  # MODE_INTER init
        self.tab_imf = np.zeros((mh, mw), dtype=np.int32)  # intra_mip_flag
        self.tab_cbw = np.zeros((mh, mw), dtype=np.int32)
        self.tab_cbh = np.zeros((mh, mw), dtype=np.int32)
        self.tab_cqt = np.zeros((mh, mw), dtype=np.int32)
        # chroma-tree (ch_type 1) neighbour tables for dual-tree splits
        self.tab_cbw_c = np.zeros((mh, mw), dtype=np.int32)
        self.tab_cbh_c = np.zeros((mh, mw), dtype=np.int32)
        self.tab_cqt_c = np.zeros((mh, mw), dtype=np.int32)
        # chroma-tree partition constraints (spec 7.4.3.4)
        min_qt_c = 1 << (sps.sps_log2_diff_min_qt_min_cb_intra_slice_chroma
                         + self.min_cb_log2)
        self.pc_c = PartitionCtx(
            min_cb_size=min_cb,
            min_qt_size=min_qt_c,
            max_bt_size=(min_qt_c <<
                         sps.sps_log2_diff_max_bt_min_qt_intra_slice_chroma),
            max_tt_size=(min_qt_c <<
                         sps.sps_log2_diff_max_tt_min_qt_intra_slice_chroma),
            max_mtt_depth=sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma,
            pic_width=self.width, pic_height=self.height)
        self.tab_skip = np.zeros((mh, mw), dtype=np.int32)
        self.tab_msf = np.zeros((mh, mw), dtype=np.int32)
        self.tab_sao: dict = {}  # (rx, ry) -> resolved sao params
        self.tab_alf: dict = {}  # (rx, ry) -> [fy, set, fcb, acb, fcr, acr, cc0, cc1]
        self.alf_num_chroma_alts = 1
        self.alf_num_cc_filters = (1, 1)
        # NoBackwardPredFlag (vvc_mvs.c:121-135): every active reference
        # precedes the current picture; drives the BCW unary c_max
        self.no_backward_pred = True

        # inter state (P slices): list0 POCs + motion context
        self.is_inter_slice = sh.sh_slice_type != 2
        self.num_ref_idx_active = [0, 0]
        self.motion = None
        if self.is_inter_slice:
            from .mvs import MotionState

            poc = sh.ph.ph_pic_order_cnt_lsb
            rpls = [rpl_pocs(poc, sh.sh_ref_pic_lists[i])
                    for i in range(2)]
            self.num_ref_idx_active = sh.num_ref_idx_active(
                pps, sh.sh_ref_pic_lists)
            col = None
            if sh.ph.ph_temporal_mvp_enabled_flag and self.col_store:
                lx = 0 if sh.sh_collocated_from_l0_flag else 1
                col_poc = rpls[lx][sh.sh_collocated_ref_idx]
                col = self.col_store.get(col_poc)
            self.motion = MotionState(self.width, self.height, self.ctb_log2,
                                      tuple(rpls), poc=poc, col=col,
                                      collocated_from_l0=(
                                          sh.sh_collocated_from_l0_flag))

        self.slice_qp_y = 26 + pps.pps_init_qp_minus26 + sh.sh_qp_delta
        init_type = 2 - sh.sh_slice_type
        if sh.sh_cabac_init_flag and sh.sh_slice_type != 2:
            init_type ^= 3
        self._init_type = init_type
        self._new_engine()

        # tile geometry in CTU units, expanded like the parser
        # (spec 6.5.1; parity vvc_ps.c:254-455)
        if getattr(pps, "pps_no_pic_partition_flag", 1):
            col_w, row_h = [self.ctb_w], [self.ctb_h]
        else:
            def expand(exp, total):
                sizes, rem = [], total
                for v in exp:
                    sizes.append(v)
                    rem -= v
                while rem > 0:
                    s = min(exp[-1], rem)
                    sizes.append(s)
                    rem -= s
                return sizes
            col_w = expand([v + 1 for v in pps.pps_tile_column_width_minus1],
                           self.ctb_w)
            row_h = expand([v + 1 for v in pps.pps_tile_row_height_minus1],
                           self.ctb_h)
        assert sum(col_w) == self.ctb_w and sum(row_h) == self.ctb_h
        self.tile_col_w, self.tile_row_h = col_w, row_h
        self.ctb_to_col_bd, self.ctb_to_row_bd = [], []
        acc = 0
        for tw in col_w:
            self.ctb_to_col_bd += [acc] * tw
            acc += tw
        acc = 0
        for th in row_h:
            self.ctb_to_row_bd += [acc] * th
            acc += th

        # neighbour availability for the current CTU
        self.ctb_left = False
        self.ctb_up = False

    def _new_engine(self, restore=None) -> None:
        """Fresh CABAC engine; contexts re-initialised (per tile entry
        point; cabac_init_state, vvc_cabac.c:842-858) or restored from
        a _save_ctx snapshot (WPP row inheritance)."""
        qp = max(0, min(self.slice_qp_y, 63))
        self.ctxs = ContextTable()
        self.ctxs.init_states(qp, self._init_type)
        # The native engine, whose contexts live in its handle; self.ctxs
        # is kept (and initialised identically) for the Python engine,
        # CabacEncoder, which the tests put in NativeCabac's place as its
        # plain version.  A library that fails to build or load raises.
        self.enc = NativeCabac(qp, self._init_type)
        if restore is not None:
            kind, snap = restore
            if kind == "n":
                self.enc.load_states(snap)
            else:
                (self.ctxs.state0[:], self.ctxs.state1[:],
                 self.ctxs.shift0[:], self.ctxs.shift1[:]) = snap
        self.res = ResidualEncoder(
            self.enc, self.ctxs, self.sh.sh_slice_type == 2,
            dep_quant=self.sh.sh_dep_quant_used_flag,
            sign_hiding=self.sh.sh_sign_data_hiding_used_flag)

    def _save_ctx(self):
        """Snapshot the adaptive contexts (WPP: taken after a row's
        first CTU, restored at the next row's start)."""
        if hasattr(self.enc, "save_states"):
            return ("n", self.enc.save_states())
        c = self.ctxs
        return ("p", (c.state0.copy(), c.state1.copy(),
                      c.shift0.copy(), c.shift1.copy()))

    # -- helpers -------------------------------------------------------
    def _bin(self, name: str, inc: int, val: int) -> None:
        self.enc.encode(self.ctxs, CTX[name] + inc, val)

    def _truncated_binary(self, val: int, c_max: int) -> None:
        n = c_max + 1
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        if val < u:
            self.enc.bypass_bits(val, k)
        else:
            self.enc.bypass_bits(val + u, k + 1)

    # -- intra modes ---------------------------------------------------
    def _left_top_ipm(self, cu: CuIntent) -> tuple[int, int]:
        """MPM neighbour modes a (left) and b (above), spec 8.4.2."""
        s = self.min_cb_log2
        x_a, y_a = (cu.x0 - 1) >> s, (cu.y0 + cu.h - 1) >> s
        x_b, y_b = (cu.x0 + cu.w - 1) >> s, (cu.y0 - 1) >> s
        x0b = cu.x0 & (self.ctb_size - 1)
        y0b = cu.y0 & (self.ctb_size - 1)
        avail_l = self.ctb_left or x0b
        avail_u = self.ctb_up or y0b
        a = b = INTRA_PLANAR
        # MIP neighbours count as planar (vvc_ctu.c:719-731 imf gate)
        if avail_l and self.tab_cpm[y_a, x_a] == MODE_INTRA \
                and not self.tab_imf[y_a, x_a]:
            a = int(self.tab_ipm[y_a, x_a])
        if avail_u and self.tab_cpm[y_b, x_b] == MODE_INTRA \
                and not self.tab_imf[y_b, x_b] and y0b:
            b = int(self.tab_ipm[y_b, x_b])
        return a, b

    def _encode_luma_intra_mode(self, cu: CuIntent) -> None:
        # intra_luma_ref_idx (MRL, vvc_ctu.c:984-985): present whenever
        # MRL is enabled and the CU is below the CTU's top row
        if self.sps.sps_mrl_enabled_flag and (cu.y0 % self.ctb_size):
            self._bin("INTRA_LUMA_REF_IDX", 0, int(cu.mrl_idx > 0))
            if cu.mrl_idx > 0:
                self._bin("INTRA_LUMA_REF_IDX", 1, int(cu.mrl_idx == 2))
        else:
            assert cu.mrl_idx == 0
        # intra_subpartitions_mode_flag + split dir (vvc_ctu.c:985-993)
        if (self.sps.sps_isp_enabled_flag and cu.mrl_idx == 0
                and cu.w <= self.max_tb_size and cu.h <= self.max_tb_size
                and cu.w * cu.h > 16):
            self._bin("INTRA_SUBPARTITIONS_MODE_FLAG", 0, int(cu.isp > 0))
            if cu.isp:
                self._bin("INTRA_SUBPARTITIONS_SPLIT_FLAG", 0,
                          int(cu.isp == 2))
        else:
            assert cu.isp == 0, "ISP chosen for ineligible CU"
        a, b = self._left_top_ipm(cu)
        cand = mpm_candidates(a, b)
        if cu.mrl_idx > 0:
            # mpm_flag / not_planar inferred 1: the mode comes from the
            # MPM list; the intent picks the list slot
            idx = cu.mrl_mpm_idx
            cu.luma_mode = cand[idx]
            for _ in range(idx):
                self.enc.bypass(1)
            if idx < 4:
                self.enc.bypass(0)
            s = self.min_cb_log2
            ys, xs = cu.y0 >> s, cu.x0 >> s
            self.tab_ipm[ys:ys + (cu.h >> s), xs:xs + (cu.w >> s)] = \
                cu.luma_mode
            self.tab_cpm[ys:ys + (cu.h >> s), xs:xs + (cu.w >> s)] = \
                MODE_INTRA
            return
        mode = cu.luma_mode
        np_inc = int(cu.isp == 0)  # ctx inc = !ispmf
        if mode == INTRA_PLANAR:
            self._bin("INTRA_LUMA_MPM_FLAG", 0, 1)
            self._bin("INTRA_LUMA_NOT_PLANAR_FLAG", np_inc, 0)
        elif mode in cand:
            idx = cand.index(mode)
            self._bin("INTRA_LUMA_MPM_FLAG", 0, 1)
            self._bin("INTRA_LUMA_NOT_PLANAR_FLAG", np_inc, 1)
            # mpm_idx: bypass unary, max 4
            for i in range(idx):
                self.enc.bypass(1)
            if idx < 4:
                self.enc.bypass(0)
        else:
            self._bin("INTRA_LUMA_MPM_FLAG", 0, 0)
            # remainder: truncated binary of rank among non-MPM modes
            scand = sorted(cand)
            pred = mode
            for c in reversed(scand):
                if pred > c:
                    pred -= 1
            # decode: pred = rem + 1 then ++ for each cand <= pred
            # inverse: rem = mode - 1 - #cands < mode
            rem = mode - 1 - sum(1 for c in scand if c < mode)
            assert 0 <= rem <= 60
            self._truncated_binary(rem, 60)
        # update tables over the CU area
        s = self.min_cb_log2
        ys, xs = cu.y0 >> s, cu.x0 >> s
        self.tab_ipm[ys:ys + (cu.h >> s), xs:xs + (cu.w >> s)] = mode
        self.tab_cpm[ys:ys + (cu.h >> s), xs:xs + (cu.w >> s)] = MODE_INTRA

    def _encode_chroma_intra_mode(self, cu: CuIntent) -> None:
        # cclm_mode_flag/idx (vvc_ctu.c:1016-1030); without dual tree
        # get_cclm_enabled is just the SPS flag (vvc_ctu.c:629-637)
        if self.sps.sps_cclm_enabled_flag:
            self._bin("CCLM_MODE_FLAG", 0, int(cu.cclm_idx >= 0))
        else:
            assert cu.cclm_idx < 0
        if cu.cclm_idx >= 0:
            self._bin("CCLM_MODE_IDX", 0, int(cu.cclm_idx > 0))
            if cu.cclm_idx > 0:
                self.enc.bypass(cu.cclm_idx - 1)
            return
        # intra_chroma_pred_mode: 4 = DM
        if cu.chroma_mode_idx == 4:
            self._bin("INTRA_CHROMA_PRED_MODE", 0, 0)
        else:
            self._bin("INTRA_CHROMA_PRED_MODE", 0, 1)
            self.enc.bypass_bits(cu.chroma_mode_idx, 2)

    # -- transform unit -------------------------------------------------
    def _encode_transform_unit(self, cu: CuIntent) -> None:
        """Transform tree (vvc_ctu.c:406-466): CUs wider/taller than the
        max transform size split in half (wider dimension first); SBT
        CUs split into two sub-TUs of which exactly one is coded."""
        if cu.isp:
            # ISP: 2/4 sub-TUs along the split axis; chroma rides the
            # last one (hls_transform_tree, vvc_ctu.c:463-476)
            self.prev_tu_cbf_y = 0
            self.infer_tu_cbf_luma = 1
            n = cu.isp_parts
            if cu.isp == 1:  # HOR
                hh = cu.h // n
                for i in range(n):
                    self._transform_unit_leaf(cu, cu.x0, cu.y0 + hh * i,
                                              cu.w, hh, False, isp_idx=i)
            else:            # VER
                ww = cu.w // n
                for i in range(n):
                    self._transform_unit_leaf(cu, cu.x0 + ww * i, cu.y0,
                                              ww, cu.h, False, isp_idx=i)
            return
        if cu.sbt is not None:
            quad, hor, pos = cu.sbt
            frac = (1 if pos == 0 else 3) if quad else 2
            if not hor:
                w0 = cu.w * frac // 4
                self._transform_unit_leaf(cu, cu.x0, cu.y0, w0, cu.h,
                                          False, sbt_idx=0)
                self._transform_unit_leaf(cu, cu.x0 + w0, cu.y0,
                                          cu.w - w0, cu.h, False,
                                          sbt_idx=1)
            else:
                h0 = cu.h * frac // 4
                self._transform_unit_leaf(cu, cu.x0, cu.y0, cu.w, h0,
                                          False, sbt_idx=0)
                self._transform_unit_leaf(cu, cu.x0, cu.y0 + h0,
                                          cu.w, cu.h - h0, False,
                                          sbt_idx=1)
            return
        mtb = self.max_tb_size
        is_large = cu.w > mtb or cu.h > mtb
        self._transform_tree(cu, cu.x0, cu.y0, cu.w, cu.h, is_large)

    @property
    def max_tb_size(self) -> int:
        return 64 if self.sps.sps_max_luma_transform_size_64_flag else 32

    def _transform_tree(self, cu, x0, y0, tw, th, is_large) -> None:
        mtb = self.max_tb_size
        if tw > mtb or th > mtb:
            ver = tw > mtb and tw > th
            w2 = tw // 2 if ver else tw
            h2 = th if ver else th // 2
            self._transform_tree(cu, x0, y0, w2, h2, is_large)
            if ver:
                self._transform_tree(cu, x0 + w2, y0, w2, h2, is_large)
            else:
                self._transform_tree(cu, x0, y0 + h2, w2, h2, is_large)
            return
        self._transform_unit_leaf(cu, x0, y0, tw, th, is_large)

    def _transform_unit_leaf(self, cu, x0, y0, tw, th, is_large,
                             sbt_idx=-1, isp_idx=-1) -> None:
        sps = self.sps
        is_intra = cu.pred_mode == "intra"
        sbt_not_coded = sbt_idx >= 0 and (
            (sbt_idx == 0 and cu.sbt[2]) or (sbt_idx == 1 and not cu.sbt[2]))
        is_isp = cu.isp > 0
        is_isp_last = is_isp and isp_idx == cu.isp_parts - 1
        chroma_available = (cu.tree != "luma"
                            and sps.sps_chroma_format_idc != 0
                            and (not is_isp or is_isp_last))
        ry, rx = y0 - cu.y0, x0 - cu.x0

        def sub(c, shift):
            if c is None:
                return None
            return c[ry >> shift:(ry + th) >> shift,
                     rx >> shift:(rx + tw) >> shift]

        cy = sub(cu.coeff_y, 0)
        # ISP: the last sub-TU carries the whole CU's chroma TBs
        ccb = cu.coeff_cb if is_isp else sub(cu.coeff_cb, 1)
        ccr = cu.coeff_cr if is_isp else sub(cu.coeff_cr, 1)
        if is_isp and not is_isp_last:
            ccb = ccr = None
        cb_coded = chroma_available and ccb is not None and np.any(ccb)
        cr_coded = chroma_available and ccr is not None and np.any(ccr)
        y_coded = cy is not None and np.any(cy)
        if sbt_not_coded:
            assert not (y_coded or cb_coded or cr_coded), \
                "SBT not-coded sub-TU carries coefficients"
            return
        if chroma_available:
            # cbf ctx shifts under BDPCM (vvc_cabac.c:1199-1216)
            self._bin("TU_CB_CODED_FLAG", cu.bdpcm_c, int(cb_coded))
            self._bin("TU_CR_CODED_FLAG",
                      2 if cu.bdpcm_c else int(cb_coded), int(cr_coded))
        is_chroma_coded = chroma_available and (cb_coded or cr_coded)
        if cu.tree != "chroma":
            # tu_y_coded_flag: present for intra, chroma-coded, or split
            # CUs; else inferred 1 (vvc_ctu.c:274-292); for ISP the last
            # sub-TU's cbf is inferred 1 when all previous were 0, and
            # the ctx is 2 + prev_tu_cbf_y (ff_vvc_tu_y_coded_flag)
            if is_isp:
                has_flag = (isp_idx < cu.isp_parts - 1
                            or not self.infer_tu_cbf_luma)
                if has_flag:
                    self._bin("TU_Y_CODED_FLAG", 2 + self.prev_tu_cbf_y,
                              int(y_coded))
                    self.prev_tu_cbf_y = int(y_coded)
                else:
                    assert y_coded, \
                        "all-zero ISP CU: last sub-TU cbf inferred 1"
                self.infer_tu_cbf_luma = (self.infer_tu_cbf_luma
                                          and not y_coded)
            elif is_intra or is_chroma_coded or is_large:
                self._bin("TU_Y_CODED_FLAG", 1 if cu.bdpcm_l else 0,
                          int(y_coded))
                self.prev_tu_cbf_y = int(y_coded)
            else:
                assert y_coded, \
                    "inter TU with no chroma must have luma coeffs"
            # qp_delta gates on is_128 (CbWidth/CbHeight > 64,
            # vvc_ctu.c:323), not is_large (tu_y_coded presence only)
            is_128 = cu.w > 64 or cu.h > 64
            has_qp_delta = ((is_128 or y_coded or is_chroma_coded)
                            and self.cu_qp_delta_enabled
                            and not self.is_cu_qp_delta_coded)
            if has_qp_delta:
                self._encode_cu_qp_delta(self.qg_pending_delta)
                self.is_cu_qp_delta_coded = True
        # tu_joint_cbcr_residual_flag (vvc_ctu.c:374-379)
        joint = 0
        if (sps.sps_joint_cbcr_enabled_flag and chroma_available
                and ((is_intra and (cb_coded or cr_coded))
                     or (cb_coded and cr_coded))):
            if self.tool_rng is not None:
                joint = int(self.tool_rng.random() < 0.5)
            self._bin("TU_JOINT_CBCR_RESIDUAL_FLAG",
                      2 * int(cb_coded) + int(cr_coded) - 1, joint)
        def ts_flag(c, w_, h_):
            # transform_skip_flag (vvc_ctu.c:386-397; !cu->sbt_flag gate)
            if (cu.bdpcm_c if c else cu.bdpcm_l):
                return 1  # forced, no flag
            if not sps.sps_transform_skip_enabled_flag:
                return 0
            if cu.sbt is not None:
                return 0
            if c == 0 and cu.isp:
                return 0  # (is_chroma || !is_isp) gate (vvc_ctu.c:389)
            max_ts = 1 << (sps.sps_log2_transform_skip_max_size_minus2 + 2)
            if w_ > max_ts or h_ > max_ts:
                return 0
            ts = int(self.tool_rng is not None
                     and self.tool_rng.random() < 0.5)
            if c == 0 and cu.mts_idx > 0:
                ts = 0  # an explicit MTS choice requires a non-ts first TB
            if cu.lfnst_idx > 0:
                ts = 0  # LFNST requires no transform-skip TB in the CU
            self._bin("TRANSFORM_SKIP_FLAG", 1 if c else 0, ts)
            return ts

        def encode_res(c, arr, ts):
            arr = np.ascontiguousarray(arr)
            if ts:
                self.cu_any_coded_ts = True
            bdpcm = cu.bdpcm_c if c else cu.bdpcm_l
            if ts and not self.sh.sh_ts_residual_coding_disabled_flag:
                self.res.encode_ts(arr, c, bdpcm=bdpcm)
            else:
                self.res.encode(arr, c)

        ts_y = 0
        if cu.tree != "chroma":
            if y_coded:
                ts_y = ts_flag(0, tw, th)
                encode_res(0, cy, ts_y)
            if self.cu_first_tb_ts < 0:
                self.cu_first_tb_ts = ts_y
        if cb_coded:
            # ISP: the chroma TBs span the whole CU (vvc_ctu.c:335-346)
            cwc = (cu.w if is_isp else tw) >> 1
            chc = (cu.h if is_isp else th) >> 1
            encode_res(1, ccb, ts_flag(1, cwc, chc))
        if cr_coded and not (cb_coded and joint):
            cwc = (cu.w if is_isp else tw) >> 1
            chc = (cu.h if is_isp else th) >> 1
            encode_res(2, ccr, ts_flag(2, cwc, chc))

    def _encode_cu_qp_delta(self, delta: int) -> None:
        """cu_qp_delta_abs + sign (vvc_cabac.c:1625-1656): ctx bin for
        >0, unary ctx prefix to 4, EG0 bypass suffix, bypass sign."""
        abs_v = abs(delta)
        self._bin("CU_QP_DELTA_ABS", 0, int(abs_v > 0))
        if abs_v:
            for v in range(1, 5):
                b = 1 if abs_v > v else 0
                self._bin("CU_QP_DELTA_ABS", 1, b)
                if not b:
                    break
            if abs_v >= 5:
                u = abs_v - 5
                k = 0
                while (1 << (k + 1)) - 1 <= u:
                    k += 1
                assert k < 6, "delta out of generator range"
                for _ in range(k):
                    self.enc.bypass(1)
                self.enc.bypass(0)
                rem = u - ((1 << k) - 1)
                for i in range(k - 1, -1, -1):
                    self.enc.bypass((rem >> i) & 1)
            self.enc.bypass(1 if delta < 0 else 0)

    def _encode_lfnst_idx(self, cu: CuIntent) -> None:
        """lfnst_idx after the CU's transform tree (vvc_ctu.c:791-850);
        under a dual chroma tree the size gates use the chroma dims and
        the first-bin ctx shifts for any dual tree."""
        sps = self.sps
        if not sps.sps_lfnst_enabled_flag:
            assert cu.lfnst_idx == 0
            return
        lw = cu.w // 2 if cu.tree == "chroma" else cu.w
        lh = cu.h // 2 if cu.tree == "chroma" else cu.h
        if cu.tree != "chroma" and cu.isp:
            # ISP: size gate uses the sub-partition dims, dc-only
            # tracker bypassed (vvc_ctu.c:818-831)
            if cu.isp == 2:
                lw = cu.w // cu.isp_parts
            else:
                lh = cu.h // cu.isp_parts
        eligible = (cu.pred_mode == "intra"
                    and max(cu.w, cu.h) <= (64 if
                        sps.sps_max_luma_transform_size_64_flag else 32)
                    and not self.cu_any_coded_ts
                    and min(lw, lh) >= 4
                    and not (cu.tree != "chroma" and cu.mip_mode >= 0
                             and min(lw, lh) < 16)
                    and (cu.isp > 0 or not self.res.lfnst_dc_only)
                    and self.res.lfnst_zero_out_sig_coeff_flag)
        if not eligible:
            assert cu.lfnst_idx == 0, "lfnst chosen for ineligible CU"
            return
        self._bin("LFNST_IDX", int(cu.tree != "single"),
                  int(cu.lfnst_idx > 0))
        if cu.lfnst_idx > 0:
            self._bin("LFNST_IDX", 2, int(cu.lfnst_idx == 2))

    def _encode_mts_idx(self, cu: CuIntent) -> None:
        """mts_idx after the CU's transform tree (vvc_ctu.c:842-860,
        1810-1811); only when explicit MTS is eligible for this CU."""
        sps = self.sps
        if not sps.sps_mts_enabled_flag:
            assert cu.mts_idx == 0
            return
        explicit = (sps.sps_explicit_mts_intra_enabled_flag
                    if cu.pred_mode == "intra"
                    else sps.sps_explicit_mts_inter_enabled_flag)
        eligible = (explicit and cu.lfnst_idx == 0
                    and max(cu.w, cu.h) <= 32
                    and cu.isp == 0 and cu.sbt is None
                    and self.res.mts_zero_out_sig_coeff_flag
                    and not self.res.mts_dc_only
                    and self.cu_first_tb_ts <= 0)
        if not eligible:
            assert cu.mts_idx == 0, "mts_idx chosen for ineligible CU"
            return
        for i in range(4):
            b = 1 if cu.mts_idx > i else 0
            self._bin("MTS_IDX", i, b)
            if not b:
                break

    def _encode_ref_idx(self, lx: int) -> int:
        """Pick and encode ref_idx_lx (vvc_cabac.c ff_vvc_ref_idx_lx):
        up to two ctx bins then bypass extension."""
        c_max = self.num_ref_idx_active[lx] - 1
        if c_max <= 0:
            return 0
        ref_idx = (int(self.tool_rng.integers(0, c_max + 1))
                   if self.tool_rng is not None else 0)
        i = 0
        max_ctx = min(c_max, 2)
        while i < max_ctx:
            b = 1 if ref_idx > i else 0
            self._bin("REF_IDX_LX", i, b)
            if not b:
                return ref_idx
            i += 1
        while i < c_max:
            b = 1 if ref_idx > i else 0
            self.enc.bypass(b)
            if not b:
                break
            i += 1
        return ref_idx

    def _encode_mvd(self, mvd) -> None:
        for c in (0, 1):
            self._bin("ABS_MVD_GREATER0_FLAG", 0, int(abs(mvd[c]) > 0))
        for c in (0, 1):
            if mvd[c]:
                self._bin("ABS_MVD_GREATER1_FLAG", 0, int(abs(mvd[c]) > 1))
        for c in (0, 1):
            v = abs(mvd[c])
            if v > 0:
                if v > 1:
                    self._egk(v - 2, 1, 15, 17)
                self.enc.bypass(int(mvd[c] < 0))

    # -- inter CU -------------------------------------------------------
    def _encode_inter_cu(self, cu: CuIntent) -> None:
        from .mvs import MvField, PF_BI, PF_L0, PF_L1

        m = self.motion
        is_b = self.sh.sh_slice_type == 0
        general_merge = cu.skip or cu.merge
        if not cu.skip:
            self._bin("GENERAL_MERGE_FLAG", 0, int(general_merge))
        if general_merge:
            # merge_subblock_flag first (hls_merge_data); without affine
            # MaxNumSubblockMergeCand = sbtmvp && tmvp
            if self.sps.sps_affine_enabled_flag:
                max_sb = (5 - self.sps
                          .sps_five_minus_max_num_subblock_merge_cand)
            else:
                max_sb = int(self.sps.sps_sbtmvp_enabled_flag
                             and self.sh.ph.ph_temporal_mvp_enabled_flag)
            if max_sb > 0 and cu.w >= 8 and cu.h >= 8:
                self._bin("MERGE_SUBBLOCK_FLAG",
                          self._get_inc(self.tab_msf, cu.x0, cu.y0),
                          int(cu.sbtmvp))
            else:
                assert not cu.sbtmvp
        if general_merge and cu.sbtmvp:
            if max_sb > 1:
                idx = cu.merge_idx  # subblock merge candidate index
                assert idx < max_sb
                self._bin("MERGE_SUBBLOCK_IDX", 0, int(idx > 0))
                if idx > 0:
                    for _ in range(1, idx):
                        self.enc.bypass(1)
                    if idx < max_sb - 1:
                        self.enc.bypass(0)
            s_ = self.min_cb_log2
            self.tab_msf[cu.y0 >> s_:(cu.y0 + cu.h) >> s_,
                         cu.x0 >> s_:(cu.x0 + cu.w) >> s_] = 1
            m.sb_merge_mode(cu.x0, cu.y0, cu.w, cu.h, is_b)
        elif general_merge:
            # merge_data_block gating (GPM still off)
            ciip_avail = (self.sps.sps_ciip_enabled_flag and not cu.skip
                          and cu.w * cu.h >= 64)
            gpm_avail = (self.sps.sps_gpm_enabled_flag and is_b
                         and cu.w >= 8 and cu.h >= 8
                         and cu.w < 8 * cu.h and cu.h < 8 * cu.w)
            if ciip_avail or gpm_avail:
                self._bin("REGULAR_MERGE_FLAG", int(not cu.skip),
                          int(not (cu.ciip or cu.gpm is not None)))
            else:
                assert not cu.ciip and cu.gpm is None
            if (cu.ciip or cu.gpm is not None) and ciip_avail and gpm_avail:
                self._bin("CIIP_FLAG", 0, int(cu.ciip))
            c_max = self.sps_max_merge_cand() - 1
            if cu.gpm is not None:
                part, g0, g1 = cu.gpm
                for j in range(5, -1, -1):
                    self.enc.bypass((part >> j) & 1)
                n_gpm = self.sps_max_gpm_cand()
                for k, g in enumerate((g0, g1)[:2 if n_gpm > 2 else 1]):
                    cm = n_gpm - k - 1
                    assert g <= cm
                    if cm > 0:
                        self._bin("MERGE_IDX", 0, int(g > 0))
                        if g > 0:
                            for _ in range(1, g):
                                self.enc.bypass(1)
                            if g < cm:
                                self.enc.bypass(0)
                # motion-field bookkeeping: whole-CU hyp0 approximation
                # (the decoder derives the exact per-4x4 geometric
                # storage; no later syntax depends on these values)
                idx0 = g0
                mvf = m.merge_candidate(cu.x0, cu.y0, cu.w, cu.h, idx0,
                                        self.sps_max_merge_cand(), is_b,
                                        self.num_ref_idx_active)
                m.set_mvf(cu.x0, cu.y0, cu.w, cu.h, mvf)
            elif cu.ciip:
                # merge_data_ciip: plain merge idx, no mmvd
                self._bin("MERGE_IDX", 0, int(cu.merge_idx > 0))
                if cu.merge_idx > 0:
                    for i in range(1, cu.merge_idx):
                        self.enc.bypass(1)
                    if cu.merge_idx < c_max:
                        self.enc.bypass(0)
                mvf = m.merge_candidate(cu.x0, cu.y0, cu.w, cu.h,
                                        cu.merge_idx,
                                        self.sps_max_merge_cand(), is_b,
                                        self.num_ref_idx_active)
                if mvf.pred_flag == PF_BI and cu.w + cu.h == 12:
                    mvf.pred_flag = PF_L0
                m.set_mvf(cu.x0, cu.y0, cu.w, cu.h, mvf)
            elif True:
              if self.sps.sps_mmvd_enabled_flag:
                self._bin("MMVD_MERGE_FLAG", 0, int(cu.mmvd is not None))
              merge_idx = cu.merge_idx
              if cu.mmvd is not None:
                  cand, dist_idx, direction = cu.mmvd
                  if self.sps_max_merge_cand() > 1:
                      self._bin("MMVD_CAND_FLAG", 0, cand)
                  self._bin("MMVD_DISTANCE_IDX", 0, int(dist_idx > 0))
                  for i in range(1, dist_idx):
                      self.enc.bypass(1)
                  if 0 < dist_idx < 7:
                      self.enc.bypass(0)
                  self.enc.bypass(direction >> 1)
                  self.enc.bypass(direction & 1)
                  merge_idx = cand
              else:
                  self._bin("MERGE_IDX", 0, int(merge_idx > 0))
                  if merge_idx > 0:
                      for i in range(1, merge_idx):
                          self.enc.bypass(1)
                      if merge_idx < c_max:
                          self.enc.bypass(0)
              mvf = m.merge_candidate(cu.x0, cu.y0, cu.w, cu.h, merge_idx,
                                      self.sps_max_merge_cand(), is_b,
                                      self.num_ref_idx_active)
              if cu.mmvd is not None:
                  # motion-field bookkeeping only: the decoder derives
                  # the exact per-list scaled offsets (derive_mmvd);
                  # no later syntax depends on these values
                  _, dist_idx, direction = cu.mmvd
                  shift = 4 if self.sh.ph.ph_mmvd_fullpel_only_flag else 2
                  d = 1 << (dist_idx + shift)
                  off = ((d, 0), (-d, 0), (0, d), (0, -d))[direction]
                  for lx in (0, 1):
                      if mvf.pred_flag & (lx + 1):
                          mvf.mv[lx] = [mvf.mv[lx][0] + off[0],
                                        mvf.mv[lx][1] + off[1]]
              # mv_merge_refine_pred_flag (bi + w+h==12 -> L0)
              if mvf.pred_flag == PF_BI and cu.w + cu.h == 12:
                  mvf.pred_flag = PF_L0
              m.set_mvf(cu.x0, cu.y0, cu.w, cu.h, mvf)
        else:
            # AMVP; amvr off -> shift 2
            pf = {"L0": PF_L0, "L1": PF_L1, "BI": PF_BI}[cu.pred_list]
            if is_b:
                # ff_vvc_pred_flag (vvc_cabac.c:1480)
                if cu.w + cu.h > 12:
                    log2 = (cu.w.bit_length() - 1) + (cu.h.bit_length() - 1)
                    inc = 7 - ((1 + log2) >> 1)
                    self._bin("INTER_PRED_IDC", inc, int(pf == PF_BI))
                else:
                    assert pf != PF_BI
                if pf != PF_BI:
                    self._bin("INTER_PRED_IDC", 5, int(pf == PF_L1))
            else:
                assert pf == PF_L0
            aff = cu.affine_params
            if (self.sps.sps_affine_enabled_flag and cu.w >= 16
                    and cu.h >= 16):
                self._bin("INTER_AFFINE_FLAG",
                          self._get_inc(self.tab_msf, cu.x0, cu.y0),
                          int(aff is not None))
                if aff is not None:
                    if self.sps.sps_6param_affine_enabled_flag:
                        self._bin("CU_AFFINE_TYPE_FLAG", 0,
                                  int(aff[0] == 2))
                    else:
                        assert aff[0] == 1
            else:
                assert aff is None
            mvds = [None, None]
            mvps = [cu.mvp_flag, cu.mvp_flag1]
            ref_sel = [0, 0]
            if pf != PF_L1:
                ref_sel[0] = self._encode_ref_idx(0)
                if aff is not None:
                    for d in aff[1][:aff[0] + 1]:
                        self._encode_mvd(d)
                    mvds[0] = aff[1][0]
                else:
                    mvds[0] = cu.mvd
                    self._encode_mvd(cu.mvd)
                self._bin("MVP_LX_FLAG", 0, cu.mvp_flag)
            if pf != PF_L0:
                assert not self.sh.ph.ph_mvd_l1_zero_flag or pf != PF_BI
                ref_sel[1] = self._encode_ref_idx(1)
                if aff is not None:
                    for d in aff[2][:aff[0] + 1]:
                        self._encode_mvd(d)
                    mvds[1] = aff[2][0]
                else:
                    mvds[1] = cu.mvd1
                    self._encode_mvd(cu.mvd1)
                self._bin("MVP_LX_FLAG", 0, cu.mvp_flag1)
            amvr_shift = cu.amvr_shift
            has_no_zero_mvd = any(
                mvds[lx] is not None and any(mvds[lx])
                for lx in (0, 1)
                if not (lx == 1 and self.sh.ph.ph_mvd_l1_zero_flag
                        and pf == PF_BI))
            if aff is not None:
                # affine AMVR is off in generated SPSes -> shift 2
                assert not self.sps.sps_affine_amvr_enabled_flag
                assert amvr_shift == 2
            elif self.sps.sps_amvr_enabled_flag and has_no_zero_mvd:
                self._bin("AMVR_FLAG", 0, int(amvr_shift != 2))
                if amvr_shift != 2:
                    idx = {3: 0, 4: 1, 6: 2}[amvr_shift]
                    self._bin("AMVR_PRECISION_IDX", 0, int(idx > 0))
                    if idx > 0:
                        self._bin("AMVR_PRECISION_IDX", 1, int(idx == 2))
            else:
                assert amvr_shift == 2
            if self.sps.sps_bcw_enabled_flag and pf == PF_BI \
                    and cu.w * cu.h >= 256:
                c_max = 4 if self.no_backward_pred else 2
                assert cu.bcw_idx <= c_max
                self._bin("BCW_IDX", 0, int(cu.bcw_idx > 0))
                if cu.bcw_idx:
                    for _ in range(1, cu.bcw_idx):
                        self.enc.bypass(1)
                    if cu.bcw_idx < c_max:
                        self.enc.bypass(0)
            else:
                assert cu.bcw_idx == 0
            mvf = MvField()
            mvf.pred_flag = pf
            for lx in (0, 1):
                if pf & (lx + 1):
                    pred = m.mvp(cu.x0, cu.y0, cu.w, cu.h, mvps[lx], lx,
                                 ref_sel, amvr_shift)
                    mvf.ref_idx[lx] = ref_sel[lx]
                    mvf.mv[lx] = [pred[0] + (mvds[lx][0] << amvr_shift),
                                  pred[1] + (mvds[lx][1] << amvr_shift)]
            m.set_mvf(cu.x0, cu.y0, cu.w, cu.h, mvf)
            if aff is not None:
                s_ = self.min_cb_log2
                self.tab_msf[cu.y0 >> s_:(cu.y0 + cu.h) >> s_,
                             cu.x0 >> s_:(cu.x0 + cu.w) >> s_] = 1
        if not cu.sbtmvp and cu.affine_params is None:
            # subblock/affine skip hmvp (vvc_ctu.c:1723)
            m.update_hmvp(m.mvf_at(cu.x0, cu.y0))
        f = m.mvf_at(cu.x0, cu.y0)
        cu.pred_flag = f.pred_flag
        cu.mv = tuple(f.mv[0])
        cu.ref_idx = f.ref_idx[0]
        cu.mv1 = tuple(f.mv[1])
        cu.ref_idx1 = f.ref_idx[1]

        # cu_coded_flag (vvc_ctu.c:1794-1798)
        has_coeff = any(c is not None and np.any(c) for c in
                        (cu.coeff_y, cu.coeff_cb, cu.coeff_cr))
        if cu.skip:
            assert not has_coeff
            return
        if not general_merge:
            self._bin("CU_CODED_FLAG", 0, int(has_coeff))
            if not has_coeff:
                return
        else:
            assert has_coeff, "merge non-skip CU parses residual (cbf may " \
                "be 0 but then luma cbf would be inferred 1)"
        self._encode_sbt_info(cu)
        self._encode_transform_unit(cu)
        if cu.sbt is None:
            self._encode_mts_idx(cu)

    def _encode_sbt_info(self, cu: CuIntent) -> None:
        """sbt_info bins (vvc_ctu.c:1092-1129 + vvc_cabac.c:2420-2446)."""
        sps = self.sps
        mtb = self.max_tb_size
        if not (sps.sps_sbt_enabled_flag and not cu.ciip
                and cu.w <= mtb and cu.h <= mtb):
            assert cu.sbt is None
            return
        ver_h, hor_h = cu.w >= 8, cu.h >= 8
        if not (ver_h or hor_h):
            assert cu.sbt is None
            return
        self._bin("CU_SBT_FLAG", int(cu.w * cu.h <= 256),
                  int(cu.sbt is not None))
        if cu.sbt is None:
            return
        quad, hor, pos = cu.sbt
        ver_q, hor_q = cu.w >= 16, cu.h >= 16
        if ver_q or hor_q:
            self._bin("CU_SBT_QUAD_FLAG", 0, quad)
        else:
            assert not quad
        hor_inc = 0 if cu.w == cu.h else (1 if cu.w < cu.h else 2)
        if (quad and ver_q and hor_q) or (not quad and ver_h and hor_h):
            self._bin("CU_SBT_HORIZONTAL_FLAG", hor_inc, hor)
        else:
            assert hor == (hor_q if quad else hor_h)
        self._bin("CU_SBT_POS_FLAG", 0, pos)

    def sps_max_gpm_cand(self) -> int:
        if self.sps_max_merge_cand() < 3:
            return 2
        return (self.sps_max_merge_cand()
                - self.sps.sps_max_num_merge_cand_minus_max_num_gpm_cand)

    def sps_max_merge_cand(self) -> int:
        return 6 - self.sps.sps_six_minus_max_num_merge_cand

    def _egk(self, value: int, k: int, max_pre: int, trunc_len: int) -> None:
        """limited k-th order EGk bypass encode (vvc_cabac.c:916-948)."""
        pre = 0
        while pre < max_pre and value >= ((1 << (pre + 1)) - 1) << k:
            pre += 1
        for _ in range(pre):
            self.enc.bypass(1)
        if pre < max_pre:
            self.enc.bypass(0)
            esc = pre + k
        else:
            esc = trunc_len
        rem = value - (((1 << pre) - 1) << k)
        self.enc.bypass_bits(rem, esc)

    # -- CU / CTU -------------------------------------------------------
    def encode_cu(self, cu: CuIntent) -> None:
        # reset lfnst/mts trackers (unused while both tools are off)
        self.res.lfnst_dc_only = 1
        self.res.lfnst_zero_out_sig_coeff_flag = 1
        self.res.mts_dc_only = 1
        self.res.mts_zero_out_sig_coeff_flag = 1
        self.cu_first_tb_ts = -1
        self.cu_any_coded_ts = False
        s = self.min_cb_log2
        ys, xs = cu.y0 >> s, cu.x0 >> s
        area = (slice(ys, ys + (cu.h >> s)), slice(xs, xs + (cu.w >> s)))
        is_intra = cu.pred_mode == "intra"

        if self.is_inter_slice:
            # pred_mode_decode (vvc_ctu.c:1032-1092), no IBC
            is_4x4 = cu.w == 4 and cu.h == 4
            if not is_4x4:
                inc = self._get_inc(self.tab_skip, cu.x0, cu.y0)
                self._bin("CU_SKIP_FLAG", inc, int(cu.skip))
            if is_4x4:
                assert is_intra
            elif cu.skip:
                assert not is_intra
            else:
                left, top = self._left_top_tab(self.tab_cpm, cu.x0, cu.y0, 0)
                inc = int(bool(left) or bool(top))
                self._bin("PRED_MODE_FLAG", inc, int(is_intra))
        else:
            assert is_intra
        if cu.tree != "chroma":
            self.tab_skip[area] = int(cu.skip)

        if is_intra:
            sps = self.sps
            max_ts = 1 << (sps.sps_log2_transform_skip_max_size_minus2 + 2)
            if cu.tree != "chroma":
                # intra_bdpcm_luma (vvc_ctu.c:962-966)
                if (sps.sps_bdpcm_enabled_flag and cu.w <= max_ts
                        and cu.h <= max_ts):
                    self._bin("INTRA_BDPCM_LUMA_FLAG", 0, cu.bdpcm_l)
                else:
                    assert not cu.bdpcm_l
                if cu.bdpcm_l:
                    assert cu.luma_mode in (18, 50)
                    self._bin("INTRA_BDPCM_LUMA_DIR_FLAG", 0,
                              int(cu.luma_mode == 50))
                    s_ = self.min_cb_log2
                    ys, xs = cu.y0 >> s_, cu.x0 >> s_
                    self.tab_ipm[ys:ys + (cu.h >> s_),
                                 xs:xs + (cu.w >> s_)] = cu.luma_mode
                    self.tab_cpm[ys:ys + (cu.h >> s_),
                                 xs:xs + (cu.w >> s_)] = MODE_INTRA
                else:
                    # intra_mip_flag (vvc_ctu.c:967-980)
                    if sps.sps_mip_enabled_flag:
                        inc = 3 if (cu.w > cu.h * 2 or cu.h > cu.w * 2) \
                            else self._get_inc(self.tab_imf, cu.x0, cu.y0)
                        self._bin("INTRA_MIP_FLAG", inc,
                                  int(cu.mip_mode >= 0))
                    else:
                        assert cu.mip_mode < 0
                    if cu.mip_mode >= 0:
                        self.enc.bypass(cu.mip_transposed)
                        c_max = 15 if (cu.w == 4 and cu.h == 4) else \
                            7 if ((cu.w == 4 or cu.h == 4)
                                  or (cu.w == 8 and cu.h == 8)) else 5
                        assert 0 <= cu.mip_mode <= c_max
                        self._truncated_binary(cu.mip_mode, c_max)
                        assert cu.luma_mode == cu.mip_mode
                        self.tab_ipm[area] = cu.luma_mode
                        self.tab_cpm[area] = MODE_INTRA
                        self.tab_imf[area] = 1
                    else:
                        self._encode_luma_intra_mode(cu)
            if cu.tree != "luma" and self.sps.sps_chroma_format_idc:
                # intra_bdpcm_chroma (vvc_ctu.c:1008-1015)
                if (sps.sps_bdpcm_enabled_flag and cu.w // 2 <= max_ts
                        and cu.h // 2 <= max_ts):
                    self._bin("INTRA_BDPCM_CHROMA_FLAG", 0, cu.bdpcm_c)
                else:
                    assert not cu.bdpcm_c
                if cu.bdpcm_c:
                    self._bin("INTRA_BDPCM_CHROMA_DIR_FLAG", 0,
                              cu.bdpcm_dir_c)
                else:
                    self._encode_chroma_intra_mode(cu)
            if self.motion is not None:
                self.motion.set_intra(cu.x0, cu.y0, cu.w, cu.h)
            self._encode_transform_unit(cu)
            self._encode_lfnst_idx(cu)
            if cu.tree != "chroma":
                self._encode_mts_idx(cu)
        else:
            self.tab_cpm[area] = MODE_INTER
            self._encode_inter_cu(cu)

    def _get_inc(self, tab, x0, y0) -> int:
        left, top = self._left_top_tab(tab, x0, y0, 0)
        return int(left) + int(top)

    # -- coding tree ----------------------------------------------------
    def _left_top_tab(self, tab, x0, y0, default):
        """get_left_top (vvc_cabac.c:950-975): neighbour tab values."""
        s = self.min_cb_log2
        x0b = x0 & (self.ctb_size - 1)
        y0b = y0 & (self.ctb_size - 1)
        left = tab[y0 >> s, (x0 - 1) >> s] if (self.ctb_left or x0b) else default
        top = tab[(y0 - 1) >> s, x0 >> s] if (self.ctb_up or y0b) else default
        return int(left), int(top)

    def _encode_split(self, node, x0, y0, w, h, allowed,
                      tree="single") -> int:
        """Encode split_cu_flag / split mode bins; returns chosen split.
        Mirrors ff_vvc_split_cu_flag/ff_vvc_split_mode (vvc_cabac.c:1086+)."""
        from .tree import (SPLIT_BT_HOR, SPLIT_BT_VER, SPLIT_NONE, SPLIT_QT,
                           SPLIT_TT_HOR, SPLIT_TT_VER)

        ch = tree == "chroma"
        tab_cbw = self.tab_cbw_c if ch else self.tab_cbw
        tab_cbh = self.tab_cbh_c if ch else self.tab_cbh
        tab_cqt = self.tab_cqt_c if ch else self.tab_cqt
        split = node["split"]
        any_split = any(allowed.values())
        is_inside = (x0 + w <= self.width) and (y0 + h <= self.height)
        if any_split and is_inside:
            left_h, _ = self._left_top_tab(tab_cbh, x0, y0, h)
            _, top_w = self._left_top_tab(tab_cbw, x0, y0, w)
            inc = (left_h < h) + (top_w < w)
            na = (allowed["btv"] + allowed["bth"] + allowed["ttv"]
                  + allowed["tth"] + 2 * allowed["qt"])
            inc += (na - 1) // 2 * 3
            self._bin("SPLIT_CU_FLAG", inc, int(split != SPLIT_NONE))
        else:
            assert (split != SPLIT_NONE) == (not is_inside), \
                "forced split state mismatch"
        if split == SPLIT_NONE:
            return split

        allow_no_qt = (allowed["btv"] or allowed["bth"] or allowed["ttv"]
                       or allowed["tth"])
        if allow_no_qt and allowed["qt"]:
            dl, dt = self._left_top_tab(tab_cqt, x0, y0, 0)
            cqt = node["cqt_depth"]
            inc = (dl > cqt) + (dt > cqt) + (cqt >= 2) * 3
            self._bin("SPLIT_QT_FLAG", inc, int(split == SPLIT_QT))
        else:
            assert (split == SPLIT_QT) == (not allow_no_qt or allowed["qt"])
        if split == SPLIT_QT:
            return split

        vertical = split in (SPLIT_BT_VER, SPLIT_TT_VER)
        if (allowed["bth"] or allowed["tth"]) and (allowed["btv"] or allowed["ttv"]):
            v = allowed["btv"] + allowed["ttv"]
            hh = allowed["bth"] + allowed["tth"]
            if v > hh:
                inc = 4
            elif v < hh:
                inc = 3
            else:
                s = self.min_cb_log2
                x0b = x0 & (self.ctb_size - 1)
                y0b = y0 & (self.ctb_size - 1)
                avail_a = self.ctb_up or y0b
                avail_l = self.ctb_left or x0b
                da = w // (int(tab_cbw[(y0 - 1) >> s, x0 >> s]) if avail_a else 1)
                dl = h // (int(tab_cbh[y0 >> s, (x0 - 1) >> s]) if avail_l else 1)
                if da == dl or not avail_a or not avail_l:
                    inc = 0
                elif da < dl:
                    inc = 1
                else:
                    inc = 2
            self._bin("MTT_SPLIT_CU_VERTICAL_FLAG", inc, int(vertical))
        else:
            assert vertical == (not (allowed["bth"] or allowed["tth"]))
        binary = split in (SPLIT_BT_VER, SPLIT_BT_HOR)
        if (allowed["btv"] and allowed["ttv"] and vertical) or \
           (allowed["bth"] and allowed["tth"] and not vertical):
            inc = 2 * vertical + (1 if node["mtt_depth"] <= 1 else 0)
            self._bin("MTT_SPLIT_CU_BINARY_FLAG", inc, int(binary))
        else:
            if not allowed["btv"] and not allowed["bth"]:
                assert not binary
            elif not allowed["ttv"] and not allowed["tth"]:
                assert binary
            elif allowed["bth"] and allowed["ttv"]:
                assert binary == (1 - vertical)
            else:
                assert binary == vertical
        return split

    def encode_tree(self, node: dict, x0: int, y0: int, w: int, h: int,
                    cqt_depth: int, mtt_depth: int, depth_offset: int,
                    part_idx: int, last_split: int, qg_on_y: bool = True,
                    cb_sub_div: int = 0, tree: str = "single") -> None:
        from .tree import SPLIT_NONE, can_split, split_children

        # new quantization group (vvc_ctu.c:2043-2046)
        if (self.cu_qp_delta_enabled and qg_on_y
                and cb_sub_div <= self.cu_qp_delta_subdiv):
            self.is_cu_qp_delta_coded = False
            if self.qp_delta_rng is not None:
                self.qg_pending_delta = int(self.qp_delta_rng.integers(-6, 7))
        ch = tree == "chroma"
        allowed = can_split(self.pc_c if ch else self.pc, x0, y0, w, h,
                            mtt_depth, depth_offset, part_idx, last_split,
                            chroma=ch)
        node["cqt_depth"] = cqt_depth
        node["mtt_depth"] = mtt_depth
        split = self._encode_split(node, x0, y0, w, h, allowed, tree)
        if split == SPLIT_NONE:
            cu = node["cu"]
            assert (cu.x0, cu.y0, cu.w, cu.h) == (x0, y0, w, h), (
                (cu.x0, cu.y0, cu.w, cu.h), (x0, y0, w, h))
            s = self.min_cb_log2
            ys, xs = y0 >> s, x0 >> s
            area = (slice(ys, ys + (h >> s)), slice(xs, xs + (w >> s)))
            (self.tab_cbw_c if ch else self.tab_cbw)[area] = w
            (self.tab_cbh_c if ch else self.tab_cbh)[area] = h
            (self.tab_cqt_c if ch else self.tab_cqt)[area] = cqt_depth
            assert cu.tree == tree, (cu.tree, tree)
            self.encode_cu(cu)
            return
        children = split_children(x0, y0, w, h, split, self.width, self.height)
        assert len(children) == len(node["children"]), (split, x0, y0, w, h)
        from .tree import SPLIT_QT
        is_tt = split in (1, 3)  # SPLIT_TT_HOR / SPLIT_TT_VER
        child_qg = qg_on_y and not (
            is_tt and not (cb_sub_div + 2 <= self.cu_qp_delta_subdiv))
        for child_node, (cx, cy, cw, ch, dq, dm, doff, idx) in zip(
                node["children"], children):
            if split == SPLIT_QT:
                sd = cb_sub_div + 2
            elif is_tt:
                sd = cb_sub_div + (1 if idx == 1 else 2)
            else:  # BT
                sd = cb_sub_div + 1
            self.encode_tree(child_node, cx, cy, cw, ch,
                             cqt_depth + dq, mtt_depth + dm,
                             depth_offset + doff, idx, split,
                             child_qg, sd, tree)

    # -- ALF per-CTB decisions (alf_params, vvc_ctu.c; CABAC mirrors
    # ff_vvc_alf_* in vvc_cabac.c:1022-1082) ---------------------------
    def _encode_alf(self, rx: int, ry: int, alf: dict) -> None:
        sh = self.sh
        p = [0] * 8
        left = self.tab_alf.get((rx - 1, ry)) if self.ctb_left else None
        up = self.tab_alf.get((rx, ry - 1)) if self.ctb_up else None
        if sh.sh_alf_enabled_flag:
            fy = int(alf["flag_y"])
            inc = (1 if left and left[0] else 0) + (1 if up and up[0] else 0)
            self._bin("ALF_CTB_FLAG", inc, fy)
            p[0] = fy
            if fy:
                si = int(alf["set_idx"])
                n_ids = sh.sh_num_alf_aps_ids_luma
                use_aps = si >= 16
                if n_ids > 0:
                    self._bin("ALF_USE_APS_FLAG", 0, int(use_aps))
                else:
                    assert not use_aps
                if use_aps:
                    assert si - 16 < n_ids
                    if n_ids > 1:
                        self._truncated_binary(si - 16, n_ids - 1)
                else:
                    self._truncated_binary(si, 15)
                p[1] = si
            for c, (en, fkey, akey) in ((1, (sh.sh_alf_cb_enabled_flag,
                                             "flag_cb", "alt_cb")),
                                        (2, (sh.sh_alf_cr_enabled_flag,
                                             "flag_cr", "alt_cr"))):
                if not en:
                    continue
                fi = 2 * c
                f = int(alf[fkey])
                inc = (c * 3 + (1 if left and left[fi] else 0)
                       + (1 if up and up[fi] else 0))
                self._bin("ALF_CTB_FLAG", inc, f)
                p[fi] = f
                alt = int(alf[akey])
                if f and self.alf_num_chroma_alts > 1:
                    for _ in range(alt):
                        self._bin("ALF_CTB_FILTER_ALT_IDX", c - 1, 1)
                    if alt < self.alf_num_chroma_alts - 1:
                        self._bin("ALF_CTB_FILTER_ALT_IDX", c - 1, 0)
                    p[fi + 1] = alt
                else:
                    assert alt == 0
        if self.sps.sps_ccalf_enabled_flag:
            for i, en in enumerate((sh.sh_alf_cc_cb_enabled_flag,
                                    sh.sh_alf_cc_cr_enabled_flag)):
                idc = int(alf["cc_idc"][i])
                if not en:
                    assert idc == 0
                    continue
                name = "ALF_CTB_CC_CB_IDC" if i == 0 else "ALF_CTB_CC_CR_IDC"
                inc = ((1 if left and left[6 + i] else 0)
                       + (1 if up and up[6 + i] else 0))
                self._bin(name, inc, int(idc != 0))
                if idc:
                    for _ in range(idc - 1):
                        self.enc.bypass(1)
                    if idc < self.alf_num_cc_filters[i]:
                        self.enc.bypass(0)
                p[6 + i] = idc
        self.tab_alf[(rx, ry)] = p

    # -- SAO (hls_sao, vvc_ctu.c:2147-2213) ----------------------------
    def _encode_sao(self, rx: int, ry: int, sao: dict) -> None:
        """sao intent: {'merge': 'left'|'up'|None,
        'type': [3], 'offset_abs': [3][4], 'offset_sign': [3][4],
        'band_position': [3], 'eo_class': [3]} (resolved params stored
        into self.tab_sao for neighbour merges)."""
        sh = self.sh
        bd = self.sps.bit_depth
        merge = sao.get("merge")
        merge_left = merge == "left"
        merge_up = merge == "up"
        if sh.sh_sao_luma_used_flag or sh.sh_sao_chroma_used_flag:
            if rx > 0 and self.ctb_left:
                self._bin("SAO_MERGE_FLAG", 0, int(merge_left))
            if ry > 0 and not merge_left and self.ctb_up:
                self._bin("SAO_MERGE_FLAG", 0, int(merge_up))
        if merge_left:
            params = dict(self.tab_sao[(rx - 1, ry)])
        elif merge_up:
            params = dict(self.tab_sao[(rx, ry - 1)])
        else:
            params = sao
            n_c = 3 if self.sps.sps_chroma_format_idc else 1
            max_off = (1 << (min(bd, 10) - 5)) - 1
            for c in range(n_c):
                used = (sh.sh_sao_luma_used_flag if c == 0
                        else sh.sh_sao_chroma_used_flag)
                if not used:
                    assert sao["type"][c] == 0
                    continue
                if c == 2:
                    assert sao["type"][2] == sao["type"][1]
                    assert sao["eo_class"][2] == sao["eo_class"][1]
                else:
                    t = sao["type"][c]
                    self._bin("SAO_TYPE_IDX", 0, int(t != 0))
                    if t != 0:
                        self.enc.bypass(int(t == 2))
                if sao["type"][c] == 0:
                    continue
                for i in range(4):
                    v = sao["offset_abs"][c][i]
                    assert 0 <= v <= max_off
                    for _ in range(v):
                        self.enc.bypass(1)
                    if v < max_off:
                        self.enc.bypass(0)
                if sao["type"][c] == 1:  # band
                    for i in range(4):
                        if sao["offset_abs"][c][i]:
                            self.enc.bypass(sao["offset_sign"][c][i])
                    self.enc.bypass_bits(sao["band_position"][c], 5)
                elif c != 2:  # edge
                    self.enc.bypass_bits(sao["eo_class"][c], 2)
        self.tab_sao[(rx, ry)] = params
        sao.update({k: params[k] for k in ("type", "offset_abs",
                                           "offset_sign", "band_position",
                                           "eo_class")})

    def encode_ctu(self, rx: int, ry: int, tree: dict,
                   is_last_in_slice: bool) -> None:
        # availability never crosses a tile boundary
        # (ff_vvc_decode_neighbour, vvc_ctu.c:2468-2495)
        tcx, tcy = self.ctb_to_col_bd[rx], self.ctb_to_row_bd[ry]
        self.ctb_left = rx > tcx
        self.ctb_up = ry > tcy
        # HMVP resets at each tile-column start (vvc_ctu.c:2447-2450);
        # single tile -> at the first CTU of every row
        if rx == tcx and self.motion is not None:
            self.motion.hmvp.clear()
        if self.sh.sh_sao_luma_used_flag or self.sh.sh_sao_chroma_used_flag:
            self._encode_sao(rx, ry, tree.setdefault("sao", _sao_off()))
        if self.sh.sh_alf_enabled_flag or self.sps.sps_ccalf_enabled_flag:
            self._encode_alf(rx, ry, tree.get("alf") or {
                "flag_y": 0, "set_idx": 0, "flag_cb": 0, "alt_cb": 0,
                "flag_cr": 0, "alt_cr": 0, "cc_idc": [0, 0]})
        x0 = rx << self.ctb_log2
        y0 = ry << self.ctb_log2
        if "dualtree" in tree:
            # dual-tree intra CTU (<= 64x64: no implicit QT needed):
            # full luma tree, then full chroma tree
            # (dual_tree_implicit_qt_split, vvc_ctu.c:2088-2145)
            assert self.ctb_size <= 64
            self.encode_tree(tree["luma"], x0, y0, self.ctb_size,
                             self.ctb_size, 0, 0, 0, 0, 0,
                             qg_on_y=True, tree="luma")
            self.encode_tree(tree["chroma"], x0, y0, self.ctb_size,
                             self.ctb_size, 0, 0, 0, 0, 0,
                             qg_on_y=False, tree="chroma")
        else:
            self.encode_tree(tree, x0, y0, self.ctb_size, self.ctb_size,
                             0, 0, 0, 0, 0)
        if is_last_in_slice:
            self.enc.terminate(1)

    def finish(self) -> bytes:
        payload, _bits = self.enc.finish()
        return payload

    def encode_slice_data(self, trees: list, t_lo: int = 0,
                          t_hi: int | None = None,
                          tiles: list | None = None) -> tuple[bytes, list]:
        """Tile-major slice_data() encode (spec 6.5.1 CTB scan) for the
        tile range [t_lo, t_hi): each tile is an independent CABAC
        sub-stream with re-initialised contexts, separated by
        end_of_tile_one_bit terminates.  A raster slice is exactly such
        a range; the last CTU emits end_of_slice_one_bit.  Returns
        (payload, sh_entry_point_offset_minus1 values in escaped-byte
        units, 7.4.8.1 / ep carving vvcdec.c:426-451)."""
        segs = []
        wpp = bool(self.sps.sps_entropy_coding_sync_enabled_flag)
        n_tile_cols = len(self.tile_col_w)
        n_tiles = n_tile_cols * len(self.tile_row_h)
        if t_hi is None:
            t_hi = n_tiles
        col_bd, row_bd = [0], [0]
        for tw in self.tile_col_w:
            col_bd.append(col_bd[-1] + tw)
        for th in self.tile_row_h:
            row_bd.append(row_bd[-1] + th)
        saved = None
        self._new_engine()
        tile_list = tiles if tiles is not None else list(range(t_lo, t_hi))
        for t_pos, t in enumerate(tile_list):
            tx, ty = t % n_tile_cols, t // n_tile_cols
            for ry in range(row_bd[ty], row_bd[ty + 1]):
                new_tile = t_pos > 0 and ry == row_bd[ty]
                new_row = wpp and ry > row_bd[ty]
                if new_tile or new_row:
                    # end_of_tile_one_bit / end_of_subset_one_bit, flush
                    self.enc.terminate(1)
                    segs.append(self.enc.finish()[0])
                    self._new_engine(restore=saved if new_row else None)
                for rx in range(col_bd[tx], col_bd[tx + 1]):
                    last = (t_pos == len(tile_list) - 1
                            and ry == row_bd[ty + 1] - 1
                            and rx == col_bd[tx + 1] - 1)
                    self.encode_ctu(rx, ry, trees[ry * self.ctb_w + rx],
                                    last)
                    if wpp and rx == col_bd[tx]:
                        saved = self._save_ctx()
        segs.append(self.enc.finish()[0])
        # signaled offsets count transmitted (escaped) bytes; escape
        # state carries across segment boundaries exactly as nal_escape
        # will see them (the slice header always ends on a nonzero byte)
        lens, zeros = [], 0
        for seg in segs:
            n = len(seg)
            for b in seg:
                if zeros >= 2 and b <= 3:
                    n += 1
                    zeros = 0
                zeros = zeros + 1 if b == 0 else 0
            lens.append(n)
        return b"".join(segs), [n - 1 for n in lens[:-1]]
