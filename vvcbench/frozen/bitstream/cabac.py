"""H.266 CABAC arithmetic engine — decoder and encoder.

Implements the spec's two-rate adaptive binary arithmetic coding
(ITU-T H.266 9.3.4: ivlCurrRange in [256,510], 10/14-bit probability state
pair, per-context adaptation shifts).  Behavioural parity target:
`libavcodec/vvc/vvc_cabac.c:813-911` (vvc_get_cabac,
cabac_init_state) and `libavcodec/cabac_functions.h` (bypass/terminate) —
this is an independent spec-style implementation (explicit range/offset
registers rather than ffmpeg's windowed `low` register).

The encoder is used by the test-stream generator (`tools/genvvc.py`).  It
uses an exact interval arithmetic formulation: `low` is kept as an
arbitrary-precision integer whose high bytes are flushed incrementally
with carry propagation, so no outstanding-bit bookkeeping is needed.
"""
from __future__ import annotations

import numpy as np

from ..models.vvc.cabac_tables import CTX, INIT_VALUES, NUM_CONTEXTS

__all__ = ["ContextTable", "CabacDecoder", "CabacEncoder", "CTX"]


class ContextTable:
    """The 378 adaptive contexts of one entry point (spec 9.3.2.2)."""

    def __init__(self) -> None:
        self.state0 = np.zeros(NUM_CONTEXTS, dtype=np.int32)
        self.state1 = np.zeros(NUM_CONTEXTS, dtype=np.int32)
        self.shift0 = np.zeros(NUM_CONTEXTS, dtype=np.int32)
        self.shift1 = np.zeros(NUM_CONTEXTS, dtype=np.int32)

    def init_states(self, qp: int, init_type: int) -> None:
        qp = min(max(qp, 0), 63)
        init_value = INIT_VALUES[init_type].astype(np.int32)
        shift_idx = INIT_VALUES[3].astype(np.int32)
        m = (init_value >> 3) - 4
        n = (init_value & 7) * 18 + 1
        pre = np.clip(((m * (qp - 16)) >> 1) + n, 1, 127)
        self.state0[:] = pre << 3
        self.state1[:] = pre << 7
        self.shift0[:] = (shift_idx >> 2) + 2
        self.shift1[:] = (shift_idx & 3) + 3 + self.shift0

    def clone(self) -> "ContextTable":
        c = ContextTable()
        c.state0 = self.state0.copy()
        c.state1 = self.state1.copy()
        c.shift0 = self.shift0.copy()
        c.shift1 = self.shift1.copy()
        return c

    def _lps_and_mps(self, ctx: int, ivl_range: int) -> tuple[int, int]:
        q_range = ivl_range >> 5
        p_state = int(self.state1[ctx]) + (int(self.state0[ctx]) << 4)
        val_mps = p_state >> 14
        prob = (32767 - p_state) if val_mps else p_state
        lps = ((q_range * (prob >> 9)) >> 1) + 4
        return lps, val_mps

    def _update(self, ctx: int, binval: int) -> None:
        s0, s1 = int(self.state0[ctx]), int(self.state1[ctx])
        sh0, sh1 = int(self.shift0[ctx]), int(self.shift1[ctx])
        self.state0[ctx] = s0 - (s0 >> sh0) + ((1023 * binval) >> sh0)
        self.state1[ctx] = s1 - (s1 >> sh1) + ((16383 * binval) >> sh1)


class CabacDecoder:
    """Spec-style arithmetic decoder reading MSB-first from a byte buffer."""

    def __init__(self, data: bytes, bitpos: int = 0) -> None:
        self.data = data
        self.pos = bitpos  # absolute bit position
        assert bitpos % 8 == 0, "CABAC starts byte-aligned"
        self.ivl_range = 510
        self.offset = self._read_bits(9)

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            idx = self.pos >> 3
            byte = self.data[idx] if idx < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def decode(self, ctxs: ContextTable, ctx: int) -> int:
        lps, val_mps = ctxs._lps_and_mps(ctx, self.ivl_range)
        self.ivl_range -= lps
        if self.offset < self.ivl_range:
            binval = val_mps
        else:
            binval = 1 - val_mps
            self.offset -= self.ivl_range
            self.ivl_range = lps
        while self.ivl_range < 256:
            self.ivl_range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        ctxs._update(ctx, binval)
        return binval

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bits(1)
        if self.offset >= self.ivl_range:
            self.offset -= self.ivl_range
            return 1
        return 0

    def bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        self.ivl_range -= 2
        if self.offset >= self.ivl_range:
            return 1
        while self.ivl_range < 256:
            self.ivl_range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return 0

    def byte_align_pos(self) -> int:
        """Bit position rounded up to the next byte (entry-point boundary)."""
        return (self.pos + 7) & ~7


class CabacEncoder:
    """Exact-interval arithmetic encoder (mirror of CabacDecoder)."""

    _KEEP = 64  # bits of `low` kept unflushed (carry window)

    def __init__(self) -> None:
        self.low = 0
        self.ivl_range = 510
        self.nbits = 9  # bits of `low` not yet flushed
        self.out = bytearray()  # flushed high bytes

    # -- interval maintenance -------------------------------------------
    def _carry_check(self) -> None:
        if self.low >> self.nbits:
            self.low -= 1 << self.nbits
            # propagate +1 into flushed bytes
            i = len(self.out) - 1
            while i >= 0:
                if self.out[i] == 0xFF:
                    self.out[i] = 0
                    i -= 1
                else:
                    self.out[i] += 1
                    break
            else:
                raise OverflowError("carry out of stream start")

    def _shift(self, n: int = 1) -> None:
        self.low <<= n
        self.nbits += n
        while self.nbits >= self._KEEP + 8:
            top = self.nbits - 8
            byte = self.low >> top
            self.out.append(byte)
            self.low -= byte << top
            self.nbits -= 8

    # -- bin coding ------------------------------------------------------
    def encode(self, ctxs: ContextTable, ctx: int, binval: int) -> None:
        lps, val_mps = ctxs._lps_and_mps(ctx, self.ivl_range)
        self.ivl_range -= lps
        if binval != val_mps:
            self.low += self.ivl_range
            self.ivl_range = lps
            self._carry_check()
        while self.ivl_range < 256:
            self.ivl_range <<= 1
            self._shift()
        ctxs._update(ctx, binval)

    def bypass(self, binval: int) -> None:
        self._shift()
        if binval:
            self.low += self.ivl_range
            self._carry_check()

    def bypass_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bypass((value >> i) & 1)

    def terminate(self, binval: int) -> None:
        self.ivl_range -= 2
        if binval:
            self.low += self.ivl_range
            self.ivl_range = 2
            self._carry_check()
        while self.ivl_range < 256:
            self.ivl_range <<= 1
            self._shift()

    def finish(self) -> tuple[bytes, int]:
        """Close the interval; returns (payload bytes, payload bit count).

        Picks the codeword in [low, low+range) with the most trailing
        zeros so the tail compresses to alignment bits.
        """
        lo, hi = self.low, self.low + self.ivl_range  # [lo, hi)
        code = hi - 1
        for k in range(self.nbits, -1, -1):
            cand = ((lo + (1 << k) - 1) >> k) << k
            if cand < hi:
                code = cand
                break
        total_bits = len(self.out) * 8 + self.nbits
        payload = bytearray(self.out)
        # append remaining nbits of `code`, MSB first, zero-padded to a byte
        rem = self.nbits
        while rem >= 8:
            rem -= 8
            payload.append((code >> rem) & 0xFF)
        if rem:
            payload.append(((code & ((1 << rem) - 1)) << (8 - rem)) & 0xFF)
        return bytes(payload), total_bits
