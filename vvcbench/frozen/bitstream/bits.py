"""Bit-level I/O and NAL packaging for H.266 annex-B streams.

The session needs no bit reader: the native parser unescapes and parses
every NAL itself, so it uses only the raw split (`split_annexb_raw`).
The container layer (`formats/`) reads the SPS prefix and writes the
vvcC record with the MSB-first reader and writer here, which also carry
Exp-Golomb codes and RBSP emulation-prevention escaping (the
reference's get_bits.h/golomb.h and h2645_parse.c, behavioural parity).
"""
from __future__ import annotations


class BitWriter:
    """MSB-first bit writer (RBSP payload builder)."""

    def __init__(self) -> None:
        self._bits: list[int] = []

    def u(self, n: int, value: int) -> "BitWriter":
        if n < 0 or value < 0 or (n < 64 and value >> n):
            raise ValueError(f"u({n}) cannot hold {value}")
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)
        return self

    def flag(self, value) -> "BitWriter":
        return self.u(1, 1 if value else 0)

    def ue(self, value: int) -> "BitWriter":
        """Unsigned Exp-Golomb (spec 9.2)."""
        if value < 0:
            raise ValueError("ue() needs value >= 0")
        v = value + 1
        n = v.bit_length()
        self.u(n - 1, 0)
        return self.u(n, v)

    def se(self, value: int) -> "BitWriter":
        """Signed Exp-Golomb: 0,1,-1,2,-2,... -> 0,1,2,3,4,..."""
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_one(self) -> "BitWriter":
        while len(self._bits) % 8:
            self._bits.append(1)
        return self

    def align_zero(self) -> "BitWriter":
        while len(self._bits) % 8:
            self._bits.append(0)
        return self

    def rbsp_trailing_bits(self) -> "BitWriter":
        self.u(1, 1)
        return self.align_zero()

    def put_bytes(self, data: bytes) -> "BitWriter":
        assert len(self._bits) % 8 == 0, "byte-aligned writes only"
        for b in data:
            self.u(8, b)
        return self

    @property
    def bit_length(self) -> int:
        return len(self._bits)

    def to_bytes(self) -> bytes:
        assert len(self._bits) % 8 == 0, "call rbsp_trailing_bits()/align first"
        out = bytearray()
        for i in range(0, len(self._bits), 8):
            byte = 0
            for bit in self._bits[i : i + 8]:
                byte = (byte << 1) | bit
            out.append(byte)
        return bytes(out)


class BitReader:
    """MSB-first bit reader over an (unescaped) RBSP buffer."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0  # bit position

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3] if (self.pos >> 3) < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def flag(self) -> int:
        return self.u(1)

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid exp-golomb")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        v = self.ue()
        return (v + 1) >> 1 if v & 1 else -(v >> 1)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos


def nal_escape(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (00 00 0x -> 00 00 03 0x, x<=3)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unescape(data: bytes) -> bytes:
    """Remove emulation-prevention bytes (00 00 03 -> 00 00)."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 <= n:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


# H.266 NAL unit types (spec table 5)
NAL_TRAIL = 0
NAL_STSA = 1
NAL_RADL = 2
NAL_RASL = 3
NAL_IDR_W_RADL = 7
NAL_IDR_N_LP = 8
NAL_CRA = 9
NAL_GDR = 10
NAL_OPI = 12
NAL_DCI = 13
NAL_VPS = 14
NAL_SPS = 15
NAL_PPS = 16
NAL_PREFIX_APS = 17
NAL_SUFFIX_APS = 18
NAL_PH = 19
NAL_AUD = 20
NAL_EOS = 21
NAL_EOB = 22
NAL_PREFIX_SEI = 23
NAL_SUFFIX_SEI = 24


def make_nal(nal_type: int, rbsp: bytes, layer_id: int = 0, tid: int = 0,
             long_startcode: bool = True) -> bytes:
    """Wrap an RBSP in a 2-byte H.266 NAL header + annex-B start code."""
    hdr = bytes([(layer_id & 0x3F), (nal_type << 3) | ((tid + 1) & 7)])
    sc = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    return sc + hdr + nal_escape(rbsp)


def _startcode_positions(data: bytes) -> list:
    """Payload start offsets after each 00 00 01 start code (C-speed scan)."""
    starts = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i + 3)
        i = data.find(b"\x00\x00\x01", i + 3)
    starts.append(None)
    return starts


def split_annexb_raw(data: bytes) -> list[tuple[int, int, int, bytes]]:
    """Split an annex-B stream into raw (still escaped) NAL units:
    [(nal_type, layer_id, temporal_id, nal_bytes_with_startcode)].

    No emulation-prevention processing happens here — the native parser
    unescapes on its side — so the split is just start-code scanning.
    """
    nals = []
    n = len(data)
    starts = _startcode_positions(data)
    for s, e in zip(starts[:-1], starts[1:]):
        end = n if e is None else e - 3
        while end > s and data[end - 1] == 0:  # trailing zeros = next start code
            end -= 1
        if end - s < 3:
            continue
        layer_id = data[s] & 0x3F
        nal_type = data[s + 1] >> 3
        tid = (data[s + 1] & 7) - 1
        nals.append((nal_type, layer_id, tid, b"\x00\x00\x01" + data[s:end]))
    return nals


def split_annexb(data: bytes) -> list[tuple[int, int, int, bytes]]:
    """Split an annex-B stream -> [(nal_type, layer_id, temporal_id, rbsp)]."""
    nals = []
    n = len(data)
    starts = _startcode_positions(data)
    for s, e in zip(starts[:-1], starts[1:]):
        end = n if e is None else e - 3
        while end > s and data[end - 1] == 0:  # trim trailing zeros of start code
            end -= 1
        payload = data[s:end]
        if len(payload) < 3:
            continue
        layer_id = payload[0] & 0x3F
        nal_type = payload[1] >> 3
        tid = (payload[1] & 7) - 1
        nals.append((nal_type, layer_id, tid, nal_unescape(payload[2:])))
    return nals
