"""Regular (non-transform-skip) residual coding — encoder side.

Bin-exact mirror of the spec's residual_coding() syntax (H.266 7.3.11.11)
and its context derivations (9.3.4.2.x); behavioural parity target:
`libavcodec/vvc/vvc_cabac.c:1700-2460` (decode side).

The encoder takes a 2-D array of chosen transform coefficient levels and
emits the exact bin sequence a conforming decoder will read back.
Supports: dep-quant off, sign-data-hiding off, persistent rice off,
no SBT/MTS zero-out narrowing (log2_zo = min(log2, 5)).
"""
from __future__ import annotations

import numpy as np

from ..bitstream.cabac import CTX, CabacEncoder, ContextTable
from .scan import diag_scan

RICE_PARAMS = [
    0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3,
]


def _local_sum(level: np.ndarray, xc: int, yc: int) -> int:
    """Spec 9.3.4.2.7 locSumAbs template (right/below neighbours)."""
    h, w = level.shape
    s = 0
    if xc < w - 1:
        s += int(level[yc, xc + 1])
        if xc < w - 2:
            s += int(level[yc, xc + 2])
        if yc < h - 1:
            s += int(level[yc + 1, xc + 1])
    if yc < h - 1:
        s += int(level[yc + 1, xc])
        if yc < h - 2:
            s += int(level[yc + 2, xc])
    return s


class ResidualEncoder:
    """Encodes one transform block's residual_coding() payload."""

    # qstate_translate_table (vvc_cabac.c:1962): next state by level parity
    QSTATE_TRANS = ((0, 2), (2, 0), (1, 3), (3, 1))

    def __init__(self, enc: CabacEncoder, ctxs: ContextTable,
                 is_intra_slice: bool, dep_quant: int = 0,
                 sign_hiding: int = 0):
        self.enc = enc
        self.ctxs = ctxs
        self.is_intra_slice = is_intra_slice
        self.dep_quant = dep_quant
        self.sign_hiding = sign_hiding
        self.qstate = 0
        # lfnst/mts parse-state trackers (consumed by the CU encoder)
        self.lfnst_dc_only = 1
        self.lfnst_zero_out_sig_coeff_flag = 1
        self.mts_dc_only = 1
        self.mts_zero_out_sig_coeff_flag = 1

    # -- primitive encoders -------------------------------------------
    def _bin(self, ctx_name: str, inc: int, val: int) -> None:
        self.enc.encode(self.ctxs, CTX[ctx_name] + inc, val)

    def _abs_encode(self, value: int, c_rice: int, log2_transform_range: int = 15) -> None:
        """Inverse of abs_decode: prefix (bypass unary, max 6) + suffix."""
        MAX_BIN = 6
        prefix = value >> c_rice
        if prefix < MAX_BIN:
            for _ in range(prefix):
                self.enc.bypass(1)
            self.enc.bypass(0)
            self.enc.bypass_bits(value & ((1 << c_rice) - 1), c_rice)
        else:
            for _ in range(MAX_BIN):
                self.enc.bypass(1)
            # limited k-th order EGk with k = c_rice + 1
            k = c_rice + 1
            max_pre_ext_len = 26 - log2_transform_range
            val = value - (MAX_BIN << c_rice)
            pre_ext_len = 0
            while (pre_ext_len < max_pre_ext_len
                   and val >= ((1 << (pre_ext_len + 1)) - 1) << k):
                pre_ext_len += 1
            for _ in range(pre_ext_len):
                self.enc.bypass(1)
            if pre_ext_len < max_pre_ext_len:
                self.enc.bypass(0)
                escape_len = pre_ext_len + k
            else:
                escape_len = log2_transform_range
            rem = val - (((1 << pre_ext_len) - 1) << k)
            assert 0 <= rem < (1 << escape_len), "abs level out of range"
            self.enc.bypass_bits(rem, escape_len)

    # -- last significant coefficient ---------------------------------
    def _last_sig_prefix(self, value: int, log2_tb_size: int, log2_zo_size: int,
                         c_idx: int, ctx_name: str) -> None:
        prefix = min(value, 3) if value <= 3 else (
            # group_idx: prefix p maps to range [ (1<<(p>>1)-1)*(2+(p&1)), ... )
            self._group_idx(value))
        maximum = (log2_zo_size << 1) - 1
        if c_idx == 0:
            offset_y = [0, 0, 3, 6, 10, 15]
            ctx_offset = offset_y[log2_tb_size - 1]
            ctx_shift = (log2_tb_size + 1) >> 2
        else:
            shifts = [0, 0, 0, 1, 2, 2, 2]
            ctx_offset = 20
            ctx_shift = shifts[log2_tb_size]
        for i in range(prefix):
            self._bin(ctx_name, (i >> ctx_shift) + ctx_offset, 1)
        if prefix < maximum:
            self._bin(ctx_name, (prefix >> ctx_shift) + ctx_offset, 0)

    @staticmethod
    def _group_idx(value: int) -> int:
        """Inverse of the last-sig prefix->value mapping."""
        p = 0
        while True:
            lo = ((1 << ((p >> 1) - 1)) * (2 + (p & 1))) if p > 3 else p
            nxt = p + 1
            hi = ((1 << ((nxt >> 1) - 1)) * (2 + (nxt & 1))) if nxt > 3 else nxt
            if lo <= value < hi:
                return p
            p += 1

    def _last_sig_suffix(self, value: int, prefix: int) -> None:
        if prefix > 3:
            base = (1 << ((prefix >> 1) - 1)) * (2 + (prefix & 1))
            length = (prefix >> 1) - 1
            self.enc.bypass_bits(value - base, length)

    # -- main ----------------------------------------------------------
    def encode_ts(self, coeffs: np.ndarray, c_idx: int,
                  bdpcm: int = 0) -> None:
        if hasattr(self.enc, "residual_ts"):  # NativeCabac fast path
            self.enc.residual_ts(coeffs, c_idx, bdpcm)
            return
        self._encode_ts_py(coeffs, c_idx, bdpcm)

    def _encode_ts_py(self, coeffs: np.ndarray, c_idx: int,
                      bdpcm: int = 0) -> None:
        """Transform-skip residual coding — encoder side.

        Bin-exact mirror of residual_ts_coding (spec 7.3.11.11 ts path;
        decode parity vvc_cabac.c:2036-2166): per-subblock sig/sign/
        gt1/par pass, gtx pass, remainder pass with the level
        prediction remap applied in inverse.
        """
        h, w = coeffs.shape
        log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
        log2_sb_w = 1 if min(log2_w, log2_h) < 2 else 2
        log2_sb_h = log2_sb_w
        if log2_w + log2_h > 3:
            if log2_w < 2:
                log2_sb_w = log2_w
                log2_sb_h = 4 - log2_sb_w
            elif log2_h < 2:
                log2_sb_h = log2_h
                log2_sb_w = 4 - log2_sb_h
        num_sb = 1 << (log2_sb_w + log2_sb_h)
        w_sbs = 1 << (log2_w - log2_sb_w)
        h_sbs = 1 << (log2_h - log2_sb_h)
        sb_scan = diag_scan(w_sbs, h_sbs)
        scan = diag_scan(1 << log2_sb_w, 1 << log2_sb_h)
        rem_bins = ((1 << (log2_w + log2_h)) * 7) >> 2
        last_sb = w_sbs * h_sbs - 1

        sig = np.zeros((h, w), np.int32)
        sign_level = np.zeros((h, w), np.int32)
        abs_final = np.zeros((h, w), np.int32)  # progressive decoded plane
        sb_coded = np.zeros((h_sbs, w_sbs), np.int32)
        infer_sb_cbf = 1

        def sb_has_coeff(xs, ys):
            y0, x0 = ys << log2_sb_h, xs << log2_sb_w
            return int(np.any(coeffs[y0:y0 + (1 << log2_sb_h),
                                     x0:x0 + (1 << log2_sb_w)]))

        for i in range(last_sb + 1):
            xs, ys = sb_scan[i]
            sbc = sb_has_coeff(xs, ys)
            if i != last_sb or not infer_sb_cbf:
                left = int(sb_coded[ys, xs - 1]) if xs > 0 else 0
                above = int(sb_coded[ys - 1, xs]) if ys > 0 else 0
                self._bin("SB_CODED_FLAG", left + above + 4, sbc)
            else:
                assert sbc, "inferred-coded ts subblock must have coeffs"
                sbc = 1
            sb_coded[ys, xs] = sbc
            if sbc and i < last_sb:
                infer_sb_cbf = 0

            # the *coded* value v per position: inverse of the level
            # prediction remap, computed lazily in the remainder pass
            # (pred depends on neighbours decoded so far); passes 1-2
            # need v up front, so precompute with a shadow plane.
            infer_sb_sig = 1
            last_pass1 = -1
            last_pass2 = -1
            gtx = [0] * num_sb
            pass1 = [0] * num_sb
            vcoded = [0] * num_sb

            # Precompute v for each n: the remap for position n uses
            # FINAL abs values of left/above neighbours, which for
            # earlier scan positions in this sb (and any earlier sb) are
            # already final.  Process in scan order, filling abs_final.
            n_coords = []
            for n in range(num_sb):
                xc = (xs << log2_sb_w) + scan[n][0]
                yc = (ys << log2_sb_h) + scan[n][1]
                n_coords.append((xc, yc))

            # pass 1
            n = 0
            while n < num_sb and rem_bins >= 4:
                xc, yc = n_coords[n]
                F = int(abs(coeffs[yc, xc]))
                # inverse remap needs pred at remainder time; but the
                # remap neighbours are in raster (left/above), and the
                # remainder pass for this sb runs after passes 1-2 with
                # the same plane state as now EXCEPT positions of this
                # sb processed earlier in the remainder pass itself.
                # Since scan order fills positions so that left/above
                # raster neighbours inside the sb always precede a
                # position in scan order (diagonal scan property), we
                # can compute v progressively here.
                if bdpcm:
                    v = F  # no level prediction remap for BDPCM
                else:
                    left = int(abs_final[yc, xc - 1]) if xc > 0 else 0
                    above = int(abs_final[yc - 1, xc]) if yc > 0 else 0
                    pred = max(left, above)
                    if pred > 0 and F == pred:
                        v = 1
                    elif pred > 0 and 1 <= F <= pred - 1:
                        v = F + 1
                    else:
                        v = F
                vcoded[n] = v
                abs_final[yc, xc] = F
                last_pass1 = n
                if sbc and (n != num_sb - 1 or not infer_sb_sig):
                    l = int(sig[yc, xc - 1]) if xc > 0 else 0
                    a = int(sig[yc - 1, xc]) if yc > 0 else 0
                    self._bin("SIG_COEFF_FLAG", 60 + l + a, int(v > 0))
                    sig[yc, xc] = int(v > 0)
                    rem_bins -= 1
                    if v > 0:
                        infer_sb_sig = 0
                else:
                    inferred = int(n == num_sb - 1 and infer_sb_sig and sbc)
                    assert inferred == int(v > 0), \
                        "ts sig inference mismatch (generator)"
                    sig[yc, xc] = inferred
                par = 0
                if sig[yc, xc]:
                    ls = int(sign_level[yc, xc - 1]) if xc > 0 else 0
                    a_s = int(sign_level[yc - 1, xc]) if yc > 0 else 0
                    if ls == -a_s:
                        inc = 3 if bdpcm else 0
                    elif ls >= 0 and a_s >= 0:
                        inc = 4 if bdpcm else 1
                    else:
                        inc = 5 if bdpcm else 2
                    neg = int(coeffs[yc, xc] < 0)
                    self._bin("COEFF_SIGN_FLAG", inc, neg)
                    sign_level[yc, xc] = 1 - 2 * neg
                    if bdpcm:
                        gt1_inc = 67
                    else:
                        lsf = int(sig[yc, xc - 1]) if xc > 0 else 0
                        asf = int(sig[yc - 1, xc]) if yc > 0 else 0
                        gt1_inc = 64 + lsf + asf
                    gt1 = int(v > 1)
                    self._bin("ABS_LEVEL_GTX_FLAG", gt1_inc, gt1)
                    gtx[n] = gt1
                    rem_bins -= 2
                    if gt1:
                        par = (v - 2) & 1
                        self._bin("PAR_LEVEL_FLAG", 32, par)
                        rem_bins -= 1
                pass1[n] = sig[yc, xc] + par + gtx[n]
                n += 1

            # pass 2: gtx chain
            pass2 = [0] * num_sb
            n = 0
            while n < num_sb and rem_bins >= 4:
                pass2[n] = pass1[n]
                v = vcoded[n]
                j = 1
                while j < 5 and gtx[n]:
                    b = int(v >= pass2[n] + 2)
                    self._bin("ABS_LEVEL_GTX_FLAG", 67 + j, b)
                    gtx[n] = b
                    pass2[n] += b << 1
                    rem_bins -= 1
                    j += 1
                last_pass2 = n
                n += 1

            # remainder pass
            for n in range(num_sb):
                xc, yc = n_coords[n]
                if n <= last_pass1:
                    v = vcoded[n]
                else:
                    # beyond the pass-1 budget the raw value is coded
                    F = int(abs(coeffs[yc, xc]))
                    v = F
                    abs_final[yc, xc] = F
                if ((n <= last_pass2 and pass2[n] >= 10)
                        or (last_pass2 < n <= last_pass1 and pass1[n] >= 2)
                        or (n > last_pass1 and sbc)):
                    if n <= last_pass2:
                        rem = (v - pass2[n]) >> 1
                    elif n <= last_pass1:
                        rem = (v - pass1[n]) >> 1
                    else:
                        rem = v
                    assert rem >= 0
                    self._abs_encode(rem, 1)
                if n > last_pass1 and v:
                    self.enc.bypass(int(coeffs[yc, xc] < 0))

    def encode(self, coeffs: np.ndarray, c_idx: int) -> None:
        if hasattr(self.enc, "residual"):  # NativeCabac fast path
            flags = self.enc.residual(coeffs, c_idx, self.is_intra_slice,
                                      self.dep_quant, self.sign_hiding)
            if flags & 1:
                self.lfnst_dc_only = 0
            if flags & 2:
                self.lfnst_zero_out_sig_coeff_flag = 0
            if flags & 4:
                self.mts_dc_only = 0
            if flags & 8:
                self.mts_zero_out_sig_coeff_flag = 0
            return
        self._encode_py(coeffs, c_idx)

    def _encode_py(self, coeffs: np.ndarray, c_idx: int) -> None:
        """coeffs: int array shaped (tb_height, tb_width), raster order."""
        h, w = coeffs.shape
        log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
        zo_w, zo_h = min(log2_w, 5), min(log2_h, 5)  # no SBT narrowing
        assert np.all(coeffs[1 << zo_h:, :] == 0) and np.all(coeffs[:, 1 << zo_w:] == 0)

        # subblock geometry (spec 7.3.11.11 log2SbW/H derivation)
        log2_sb_w = 1 if min(zo_w, zo_h) < 2 else 2
        log2_sb_h = log2_sb_w
        if zo_w + zo_h > 3:
            if zo_w < 2:
                log2_sb_w = zo_w
                log2_sb_h = 4 - log2_sb_w
            elif zo_h < 2:
                log2_sb_h = zo_h
                log2_sb_w = 4 - log2_sb_h
        num_sb_coeff = 1 << (log2_sb_w + log2_sb_h)
        w_sbs = 1 << (zo_w - log2_sb_w)
        h_sbs = 1 << (zo_h - log2_sb_h)
        sb_scan = diag_scan(w_sbs, h_sbs)
        scan = diag_scan(1 << log2_sb_w, 1 << log2_sb_h)
        rem_bins_pass1 = ((1 << (zo_w + zo_h)) * 7) >> 2

        # find last significant coefficient in scan order
        last_sb = -1
        last_pos = -1
        for i in range(len(sb_scan) - 1, -1, -1):
            xs, ys = sb_scan[i]
            for n in range(num_sb_coeff - 1, -1, -1):
                xc = (xs << log2_sb_w) + scan[n][0]
                yc = (ys << log2_sb_h) + scan[n][1]
                if coeffs[yc, xc]:
                    last_sb, last_pos = i, n
                    break
            if last_sb >= 0:
                break
        assert last_sb >= 0, "residual_coding called with all-zero block"
        xs, ys = sb_scan[last_sb]
        last_x = (xs << log2_sb_w) + scan[last_pos][0]
        last_y = (ys << log2_sb_h) + scan[last_pos][1]

        self._last_sig_prefix(last_x, log2_w, zo_w, c_idx, "LAST_SIG_COEFF_X_PREFIX")
        self._last_sig_prefix(last_y, log2_h, zo_h, c_idx, "LAST_SIG_COEFF_Y_PREFIX")
        self._last_sig_suffix(last_x, self._group_idx(last_x) if last_x > 3 else last_x)
        self._last_sig_suffix(last_y, self._group_idx(last_y) if last_y > 3 else last_y)

        # lfnst/mts parse-state tracking (decode side vvc_cabac.c:2407-2437)
        last_scan_pos_linear = last_sb * num_sb_coeff + last_pos
        if last_sb == 0 and log2_w >= 2 and log2_h >= 2 and last_pos > 0:
            self.lfnst_dc_only = 0
        if (last_sb > 0 and log2_w >= 2 and log2_h >= 2) or \
           (last_pos > 7 and (log2_w == 2 or log2_w == 3) and log2_w == log2_h):
            self.lfnst_zero_out_sig_coeff_flag = 0
        if (last_sb > 0 or last_pos > 0) and c_idx == 0:
            self.mts_dc_only = 0

        abs_level = np.zeros((h, w), dtype=np.int64)
        abs_level_pass1 = np.zeros((h, w), dtype=np.int64)
        sig_flag = np.zeros((h, w), dtype=np.int64)
        sb_coded = np.zeros((h_sbs, w_sbs), dtype=np.int64)

        infer_sb_cbf = 1  # unused in regular mode (only ts); kept for clarity
        self.qstate = 0  # per-TB (init_residual_coding, vvc_cabac.c:2035)
        state = {"rem_bins": rem_bins_pass1}

        for i in range(last_sb, -1, -1):
            self._encode_subblock(
                coeffs, abs_level, abs_level_pass1, sig_flag, sb_coded,
                i, last_sb, last_pos, sb_scan, scan,
                log2_sb_w, log2_sb_h, num_sb_coeff, w_sbs, h_sbs,
                c_idx, state, last_x, last_y)

    def _encode_subblock(self, coeffs, abs_level, abs_level_pass1, sig_flag,
                         sb_coded, i, last_sb, last_pos, sb_scan, scan,
                         log2_sb_w, log2_sb_h, num_sb_coeff, w_sbs, h_sbs,
                         c_idx, state, last_x, last_y) -> None:
        xs, ys = sb_scan[i]
        coded = int(np.any(self._sb_block(coeffs, xs, ys, log2_sb_w, log2_sb_h) != 0))
        infer_sb_dc_sig = 0
        if 0 < i < last_sb:
            # sb_coded_flag with ctx from right/bottom neighbours
            right = int(sb_coded[ys, xs + 1]) if xs < w_sbs - 1 else 0
            bottom = int(sb_coded[ys + 1, xs]) if ys < h_sbs - 1 else 0
            inc = (right | bottom) + (2 if c_idx else 0)
            self._bin("SB_CODED_FLAG", inc, coded)
            infer_sb_dc_sig = 1
        else:
            coded = 1
        sb_coded[ys, xs] = coded
        if coded and (xs > 3 or ys > 3) and c_idx == 0:
            self.mts_zero_out_sig_coeff_flag = 0
        if not coded:
            return

        first_pos_mode0 = last_pos if i == last_sb else num_sb_coeff - 1
        first_pos_mode1 = first_pos_mode0
        gt2 = [0] * num_sb_coeff
        first_sig = num_sb_coeff
        last_sig_sb = -1
        start_qstate_sb = self.qstate

        n = first_pos_mode0
        while n >= 0 and state["rem_bins"] >= 4:
            xc = (xs << log2_sb_w) + scan[n][0]
            yc = (ys << log2_sb_h) + scan[n][1]
            level = abs(int(coeffs[yc, xc]))
            is_last = (xc == last_x and yc == last_y)
            if (n > 0 or not infer_sb_dc_sig) and not is_last:
                sig = int(level > 0)
                self._bin("SIG_COEFF_FLAG",
                          self._sig_ctx_inc(abs_level_pass1, xc, yc, c_idx), sig)
                state["rem_bins"] -= 1
                if sig:
                    infer_sb_dc_sig = 0
            else:
                sig = int(is_last or (scan[n] == (0, 0) and infer_sb_dc_sig))
                assert sig == (level > 0), (
                    f"inferred sig mismatch at ({xc},{yc}): level={level}")
            sig_flag[yc, xc] = sig
            p1 = 0
            if sig:
                inc = self._gtx_ctx_inc(sig_flag, abs_level_pass1, xc, yc,
                                        c_idx, is_last)
                gt1 = int(level > 1)
                self._bin("ABS_LEVEL_GTX_FLAG", inc, gt1)
                state["rem_bins"] -= 1
                par = 0
                if gt1:
                    par = (level - 2) & 1
                    gt2[n] = int(level > 3)
                    self._bin("PAR_LEVEL_FLAG", inc, par)
                    self._bin("ABS_LEVEL_GTX_FLAG", inc + 32, gt2[n])
                    state["rem_bins"] -= 2
                if last_sig_sb == -1:
                    last_sig_sb = n
                first_sig = n
                p1 = 1 + par + gt1 + (gt2[n] << 1)
            abs_level_pass1[yc, xc] = p1
            if self.dep_quant:
                self.qstate = self.QSTATE_TRANS[self.qstate][p1 & 1]
            first_pos_mode1 = n - 1
            n -= 1

        # remainder pass for pass-1-coded positions
        for n in range(first_pos_mode0, first_pos_mode1, -1):
            xc = (xs << log2_sb_w) + scan[n][0]
            yc = (ys << log2_sb_h) + scan[n][1]
            level = abs(int(coeffs[yc, xc]))
            abs_level[yc, xc] = abs_level_pass1[yc, xc]
            if gt2[n]:
                rem = (level - 4) >> 1
                c_rice = self._rice_param(abs_level, xc, yc,
                                          4 if self.is_intra_slice else 4)
                # base_level for rrc off, <=12bit: {4,4} -> always 4
                self._abs_encode(rem, c_rice)
                abs_level[yc, xc] = level

        # mode1: dec_abs_level coding for the rest
        for n in range(first_pos_mode1, -1, -1):
            xc = (xs << log2_sb_w) + scan[n][0]
            yc = (ys << log2_sb_h) + scan[n][1]
            level = abs(int(coeffs[yc, xc]))
            c_rice = self._rice_param(abs_level, xc, yc, 0)
            zero_pos = (1 if self.qstate < 2 else 2) << c_rice
            if level == 0:
                dec = zero_pos
            elif level <= zero_pos:
                dec = level - 1
            else:
                dec = level
            self._abs_encode(dec, c_rice)
            abs_level[yc, xc] = level
            if level > 0:
                if last_sig_sb == -1:
                    last_sig_sb = n
                first_sig = n
            if self.dep_quant:
                self.qstate = self.QSTATE_TRANS[self.qstate][level & 1]

        # sign pass; with sign-data-hiding the first significant
        # coefficient's sign is inferred from the level-sum parity, so it
        # is not written (the decoded sign may differ from the intent —
        # the generator is judged against the reference decode, not the
        # intent).  vvc_cabac.c:2277-2312.
        sig_hidden = self.sign_hiding and (last_sig_sb - first_sig > 3)
        if self.dep_quant:
            self.qstate = start_qstate_sb
        for n in range(first_pos_mode0, -1, -1):
            xc = (xs << log2_sb_w) + scan[n][0]
            yc = (ys << log2_sb_h) + scan[n][1]
            level = int(coeffs[yc, xc])
            if level != 0 and not (sig_hidden and n == first_sig):
                self.enc.bypass(1 if level < 0 else 0)
            if self.dep_quant:
                self.qstate = self.QSTATE_TRANS[self.qstate][abs(level) & 1]

    # -- context derivations -------------------------------------------
    @staticmethod
    def _sb_block(arr, xs, ys, log2_sb_w, log2_sb_h):
        return arr[ys << log2_sb_h:(ys + 1) << log2_sb_h,
                   xs << log2_sb_w:(xs + 1) << log2_sb_w]

    def _sig_ctx_inc(self, abs_level_pass1, xc, yc, c_idx) -> int:
        # dep-quant biases the context by the quantizer state
        # (vvc_cabac.c:1835-1837); qstate stays 0 when dep quant is off
        d = xc + yc
        loc = _local_sum(abs_level_pass1, xc, yc)
        qs = max(0, self.qstate - 1)
        if c_idx == 0:
            return (12 * qs + min((loc + 1) >> 1, 3)
                    + (8 if d < 2 else (4 if d < 5 else 0)))
        return 36 + 8 * qs + min((loc + 1) >> 1, 3) + (4 if d < 2 else 0)

    @staticmethod
    def _gtx_ctx_inc(sig_flag, abs_level_pass1, xc, yc, c_idx, is_last) -> int:
        if is_last:
            return 0 if c_idx == 0 else 21
        d = xc + yc
        loc_sig = _local_sum(sig_flag, xc, yc)
        loc_p1 = _local_sum(abs_level_pass1, xc, yc)
        offset = min(loc_p1 - loc_sig, 4)
        if c_idx == 0:
            return 1 + offset + (15 if d == 0 else (10 if d < 3 else (5 if d < 10 else 0)))
        return 22 + offset + (5 if d == 0 else 0)

    @staticmethod
    def _rice_param(abs_level, xc, yc, base_level) -> int:
        loc = _local_sum(abs_level, xc, yc)
        loc = max(0, min(loc - base_level * 5, 31))
        return RICE_PARAMS[loc]
