"""ctypes binding to the native CABAC encoder (native/encode.cc).

The stream generator's engine: the arithmetic coder and the 378
adaptive contexts live in C++, and whole residual_coding() payloads are
encoded in one call.  It has the interface of the pure-Python
``CabacEncoder`` + ``ContextTable`` pair (`bitstream/cabac.py`,
`encoder/residual.py`), which stays as its plain version in the tests
(`tests/test_torch_generator.py` holds the two bin-exact).  encode.cc is
built on its own into `_build/libvvc_enc.so` at first use; the decoder's
libvvc_host.so does not hold it.  A failed build raises with the
compiler's output: nothing falls back to the Python engine.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import build

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "encode.cc")
_HEADERS = (os.path.join(_NATIVE_DIR, "cabac_tables.h"),)

_lib = None


def get_lib():
    """Load libvvc_enc.so, building it first if it is missing or older
    than its sources."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build.build_cxx("vvc_enc", [_SRC], _HEADERS))
        lib.vvce_new.restype = ctypes.c_void_p
        lib.vvce_free.argtypes = [ctypes.c_void_p]
        lib.vvce_init_states.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]
        lib.vvce_bin.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.vvce_bypass.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vvce_bypass_bits.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_int]
        lib.vvce_terminate.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vvce_copy_states.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.vvce_finish.restype = ctypes.c_int
        lib.vvce_finish.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int]
        lib.vvce_residual.restype = ctypes.c_int
        lib.vvce_residual.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
        lib.vvce_residual_ts.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
        _lib = lib
    return _lib


class _NativeStates:
    """A snapshot of the 378 adaptive contexts (held in a spare native
    encoder handle; only its state tables are ever used)."""

    def __init__(self, lib, src_h) -> None:
        self._lib = lib
        self._h = lib.vvce_new()
        lib.vvce_copy_states(self._h, src_h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vvce_free(self._h)
            self._h = None


class NativeCabac:
    """Same interface as ``CabacEncoder`` (the ``ctxs`` argument of
    ``encode`` is ignored: context state lives inside the handle)."""

    def __init__(self, qp: int, init_type: int) -> None:
        self._lib = get_lib()
        self._h = self._lib.vvce_new()
        self._lib.vvce_init_states(self._h, qp, init_type)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vvce_free(self._h)
            self._h = None

    def encode(self, _ctxs, ctx: int, binval: int) -> None:
        self._lib.vvce_bin(self._h, ctx, binval)

    def bypass(self, binval: int) -> None:
        self._lib.vvce_bypass(self._h, binval)

    def bypass_bits(self, value: int, n: int) -> None:
        if n:
            self._lib.vvce_bypass_bits(self._h, value, n)

    def terminate(self, binval: int) -> None:
        self._lib.vvce_terminate(self._h, binval)

    # -- WPP context inheritance ---------------------------------------
    def save_states(self) -> "_NativeStates":
        return _NativeStates(self._lib, self._h)

    def load_states(self, s: "_NativeStates") -> None:
        self._lib.vvce_copy_states(self._h, s._h)

    def finish(self) -> tuple[bytes, int]:
        cap = self._lib.vvce_finish(self._h, None, 0)
        buf = (ctypes.c_uint8 * cap)()
        n = self._lib.vvce_finish(self._h, buf, cap)
        if n < 0:
            raise RuntimeError("native CABAC finish: buffer overflow")
        return bytes(buf[:n]), n * 8

    # -- bulk residual coding -----------------------------------------
    def residual(self, coeffs: np.ndarray, c_idx: int, is_intra_slice: int,
                 dep_quant: int, sign_hiding: int) -> int:
        a = np.ascontiguousarray(coeffs, dtype=np.int32)
        h, w = a.shape
        return self._lib.vvce_residual(
            self._h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            w, h, c_idx, int(is_intra_slice), int(dep_quant),
            int(sign_hiding))

    def residual_ts(self, coeffs: np.ndarray, c_idx: int,
                    bdpcm: int) -> None:
        a = np.ascontiguousarray(coeffs, dtype=np.int32)
        h, w = a.shape
        self._lib.vvce_residual_ts(
            self._h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            w, h, c_idx, int(bdpcm))
