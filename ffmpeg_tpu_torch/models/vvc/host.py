"""ctypes binding to the native VVC host parser (libvvc_host.so).

The native library turns an access unit (annex-B bytes) into
device-ready syntax tensors: coefficient planes, per-min-CB mode planes,
and CU/TU record tables.  Builds the library on demand with make, into
the package's git-ignored `_build/` directory (never beside the
sources).
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from ...utils.build import BUILD_DIR, build_locked

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_LIB_PATH = os.path.join(BUILD_DIR, "libvvc_host.so")

# max units per wavefront chunk (ctrl kChunk); units within a chunk are
# independent and run as one batch on the device (one block each in the
# recon kernel)
CHUNK_CAP = 32

CU_FIELDS = ["x0", "y0", "w", "h", "pred_mode", "luma_mode", "chroma_mode",
             "qp", "qp_cb", "qp_cr", "qp_jcbcr",
             "skip", "merge", "idx", "mv_x", "mv_y", "ref_idx",
             "pf", "mv1_x", "mv1_y", "ref_idx1", "bdpcm_l", "bdpcm_c",
             "bcw", "hpel", "ciip", "ciip_w",
             "gpm_part", "gpm_lx0", "gpm_lx1", "sbtmvp", "affine",
             "prof", "pdhx0", "pdhy0", "pdvx0", "pdvy0",
             "pdhx1", "pdhy1", "pdvx1", "pdvy1", "bdof", "dmvr",
             "mip", "mip_t", "mrl", "isp", "isp_parts"]
TU_FIELDS = ["x0", "y0", "w", "h", "c_idx", "coded", "qp", "cu_index",
             "trh", "trv", "res", "jop", "qsel", "qp_deq", "ts", "pcmf",
             "lf_sel", "lf_tr", "slid"]


def _build() -> None:
    """make is mtime-driven, so an up-to-date library costs one stat
    pass; the lock keeps concurrent processes from racing the link."""
    build_locked("vvc_host", ["make", "-s", "-j2", f"OUT={_LIB_PATH}",
                  f"OBJDIR={os.path.join(BUILD_DIR, 'obj')}", _LIB_PATH],
                 cwd=_NATIVE_DIR)


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.vvch_new.restype = ctypes.c_void_p
        lib.vvch_free.argtypes = [ctypes.c_void_p]
        lib.vvch_decode_au.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
        lib.vvch_last_error.restype = ctypes.c_char_p
        lib.vvch_frame_info.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32)]
        for name in ("vvch_coeffs", "vvch_cus", "vvch_tus", "vvch_ipm",
                     "vvch_mvf", "vvch_sao"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(ctypes.c_int32)
            fn.argtypes = [ctypes.c_void_p] + (
                [ctypes.c_int] if name in ("vvch_coeffs", "vvch_mvf") else [])
        lib.vvch_ref_info.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_tile_bd.restype = None
        lib.vvch_tile_bd.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_col_reset.restype = None
        lib.vvch_col_reset.argtypes = []
        lib.vvch_colstore_new.restype = ctypes.c_void_p
        lib.vvch_colstore_free.argtypes = [ctypes.c_void_p]
        lib.vvch_set_colstore.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.vvch_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vvch_cu_ctrl.restype = ctypes.POINTER(ctypes.c_int32)
        lib.vvch_cu_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_tu_slots.restype = None
        lib.vvch_tu_slots.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_alf_info.restype = None
        lib.vvch_alf_info.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_alf_small.restype = None
        lib.vvch_alf_small.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int32)]
        for name in ("vvch_alf_luma_coeff", "vvch_alf_luma_clipidx",
                     "vvch_alf_ctb"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(ctypes.c_int32)
            fn.argtypes = [ctypes.c_void_p]
        lib.vvch_lmcs.restype = None
        lib.vvch_lmcs.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_sl.restype = None
        lib.vvch_sl.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_fo_cu_ctrl.restype = ctypes.POINTER(ctypes.c_int32)
        lib.vvch_fo_cu_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_dmvr_apply.restype = None
        lib.vvch_dmvr_apply.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.POINTER(ctypes.c_int32)] * 6
        lib.vvch_detach.restype = ctypes.c_void_p
        lib.vvch_detach.argtypes = [ctypes.c_void_p]
        lib.vvch_fo_free.restype = None
        lib.vvch_fo_free.argtypes = [ctypes.c_void_p]
        lib.vvch_fo_tu_grids.restype = None
        lib.vvch_fo_tu_grids.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int] + \
            [ctypes.POINTER(ctypes.c_int32)] * 6
        lib.vvch_fo_bucket_counts.restype = None
        lib.vvch_fo_bucket_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.vvch_fo_fill_buckets.restype = ctypes.c_int
        lib.vvch_fo_fill_buckets.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
        _lib = lib
    return _lib


@dataclass
class FrameSyntax:
    """Parsed syntax of one frame, as numpy arrays."""
    width: int
    height: int
    bit_depth: int
    chroma_format_idc: int
    poc: int
    slice_qp: int
    coeff_y: np.ndarray       # (H, W) int32
    coeff_cb: np.ndarray      # (H/2, W/2) int32 (4:2:0)
    coeff_cr: np.ndarray
    cus: dict                 # field -> (n_cus,) int32
    tus: dict                 # field -> (n_tus,) int32
    ipm: np.ndarray           # (mcb_h, mcb_w) int32
    deblock_disabled: int = 1
    beta_offset: tuple = (0, 0, 0)   # luma, cb, cr
    tc_offset: tuple = (0, 0, 0)
    slice_type: int = 2       # 0=B 1=P 2=I
    ref_pocs: tuple = ((), ())  # per-list reference POCs
    mvf: dict | None = None   # 4x4 planes: pf, mv_x, mv_y, ref (L0)
    sao: np.ndarray | None = None  # (ctb_h, ctb_w, 24) per-CTB params
    # native-derived (26, n_cus) control matrices (recon.py CTRL_KEYS order)
    ctrl_y: np.ndarray | None = None
    ctrl_c: np.ndarray | None = None
    ctb_log2: int = 5
    max_num_reorder: int = 0
    # tile boundaries in luma samples, incl. 0 and width/height
    # (vvch_tile_bd; ((0, W), (0, H)) when untiled)
    tile_bd: tuple = ((), ())
    dep_quant: int = 0        # sh_dep_quant_used_flag (dequant addin)
    # per-TuRecord unit-slot maps (residual scatter targets for the
    # decode-order recon kernel); -1 = no slot in that plane kind
    slots_y: np.ndarray | None = None
    slots_c: np.ndarray | None = None
    # detached native FrameOut handle (vvch_detach): the C-side TU list
    # + coefficient planes, consumed by the native bucket filler
    fo: "NativeFrame | None" = None
    # LMCS derived state (None = disabled): {"crs_flag", "min_bin",
    # "max_bin", "pivot"(17,), "fwd_scale"(16,), "inv_scale"(16,),
    # "chroma_scale"(16,)} int32 arrays (vvch_lmcs layout)
    lmcs: dict | None = None
    # ALF derived state (None = disabled): {"cc_enabled"(2,),
    # "luma_coeff"/"luma_clipidx"(n_aps,25,12), "chroma_coeff"/
    # "chroma_clipidx"(8,6), "num_chroma_alts", "cc_coeff"(2,4,7),
    # "ctb"(cbh,cbw,8)} (vvch_alf_* layout)
    alf: dict | None = None
    # conformance-window crop (left, right, top, bottom) in luma samples
    crop: tuple = (0, 0, 0, 0)
    gdr_pic: int = 0           # ph_gdr_pic_flag
    recovery_poc_cnt: int = 0  # ph_recovery_poc_cnt
    has_isp: int = 0           # any ISP CU (extends the residual sizes)
    has_tb64: int = 0          # any 64-sample luma TB (64-size residual
    #                            classes + 64-wide intra predict units)
    wrap_off: int = 0          # horizontal ref wraparound offset (luma
    #                            samples; 0 = disabled)
    # explicit scaling lists (None = flat): {"rec": (28, 8, 8) int32
    # ScalingMatrixRec, "dc": (14,) ScalingMatrixDcRec}
    sl: dict | None = None


class NativeFrame:
    """Owns a detached native FrameOut (freed with the python object)."""

    def __init__(self, lib, ptr) -> None:
        self._lib = lib
        self.ptr = ptr

    def __del__(self):
        if self.ptr:
            self._lib.vvch_fo_free(self.ptr)
            self.ptr = None


class ColStore:
    """Session-scoped collocated-motion store (TMVP): one per decode
    session, shared across that session's pooled HostDecoders, so
    concurrent sessions never clobber each other's in-flight state."""

    def __init__(self) -> None:
        self._lib = _get_lib()
        self._s = self._lib.vvch_colstore_new()

    def __del__(self):
        if getattr(self, "_s", None):
            self._lib.vvch_colstore_free(self._s)
            self._s = None


class HostDecoder:
    """Stateful host-side parser; feed access units, get FrameSyntax."""

    def __init__(self, colstore: ColStore | None = None) -> None:
        self._lib = _get_lib()
        self._colstore = colstore  # keep alive while attached
        self._h = None
        self._renew()

    def _renew(self) -> None:
        """A fresh native handle on the session's store.  Any handle can
        parse any AU (each carries its parameter sets), so the parse goes
        on with a fresh one where the old one's state cannot be trusted:
        after a native error, and after a frame with DMVR units, whose
        flag the handle keeps past vvch_detach; it would defer the
        collocated motion of every later frame it parses, which no
        dmvr_apply then publishes, and a later TMVP reader would wait
        for it."""
        if self._h:
            self._lib.vvch_free(self._h)
        self._h = self._lib.vvch_new()
        if self._colstore is not None:
            self._lib.vvch_set_colstore(self._h, self._colstore._s)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vvch_free(self._h)
            self._h = None

    def decode_au(self, data: bytes, epoch: int = 0) -> FrameSyntax | None:
        self._lib.vvch_set_epoch(self._h, epoch)
        ret = self._lib.vvch_decode_au(self._h, data, len(data))
        if ret != 0:
            err = self._lib.vvch_last_error().decode()
            self._renew()
            raise RuntimeError(f"native decode error: {err}")
        info = (ctypes.c_int32 * 31)()
        self._lib.vvch_frame_info(self._h, info)
        if not info[0]:
            return None  # no frame in this AU (parameter sets only)
        (w, h, bd, cidc, poc, qp, n_cus, n_tus, mcb_w, mcb_h,
         deblock_disabled) = list(info)[1:12]
        beta_off = tuple(info[12:15])
        tc_off = tuple(info[15:18])
        ctb_log2 = int(info[18])
        max_num_reorder = int(info[19])
        dep_quant = int(info[20])
        crop = tuple(int(v) for v in info[21:25])
        gdr_pic, recovery_poc_cnt = int(info[25]), int(info[26])
        has_isp = int(info[27])
        has_tb64 = int(info[29])
        wrap_off = int(info[30])
        sl = None
        if info[28]:
            buf = np.zeros(28 * 64 + 14, np.int32)
            self._lib.vvch_sl(self._h, buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)))
            sl = {"rec": buf[:28 * 64].reshape(28, 8, 8).copy(),
                  "dc": buf[28 * 64:].copy()}

        def plane(c_idx, pw, ph):
            ptr = self._lib.vvch_coeffs(self._h, c_idx)
            return np.ctypeslib.as_array(ptr, shape=(ph, pw)).copy()

        cw, chh = (w // 2, h // 2) if cidc == 1 else (w, h)
        n_cu_fields = len(CU_FIELDS)
        n_tu_fields = len(TU_FIELDS)
        cus_raw = np.ctypeslib.as_array(
            self._lib.vvch_cus(self._h), shape=(n_cus, n_cu_fields)).copy() \
            if n_cus else np.zeros((0, n_cu_fields), np.int32)
        tus_raw = np.ctypeslib.as_array(
            self._lib.vvch_tus(self._h), shape=(n_tus, n_tu_fields)).copy() \
            if n_tus else np.zeros((0, n_tu_fields), np.int32)
        ipm = np.ctypeslib.as_array(
            self._lib.vvch_ipm(self._h), shape=(mcb_h, mcb_w)).copy()

        tinfo = (ctypes.c_int32 * 134)()
        self._lib.vvch_tile_bd(self._h, tinfo)
        n_cb, n_rb = int(tinfo[0]), int(tinfo[1])
        tile_bd = (tuple(tinfo[2:2 + n_cb]),
                   tuple(tinfo[2 + n_cb:2 + n_cb + n_rb]))

        rinfo = (ctypes.c_int32 * 35)()
        self._lib.vvch_ref_info(self._h, rinfo)
        slice_type = int(rinfo[0])
        nb0, nb1 = int(rinfo[1]), int(rinfo[2])
        ref_pocs = (tuple(rinfo[3:3 + nb0]), tuple(rinfo[19:19 + nb1]))
        ctb = 1 << ctb_log2
        cbh, cbw = (h + ctb - 1) // ctb, (w + ctb - 1) // ctb
        sao = np.ctypeslib.as_array(self._lib.vvch_sao(self._h),
                                    shape=(cbh, cbw, 24)).copy()
        def cu_ctrl(is_chroma):
            n_keys = 75  # ctrl::kNumKeys
            if not n_cus:
                return np.zeros((n_keys, 0), np.int32)
            n_units = ctypes.c_int32(0)
            ptr = self._lib.vvch_cu_ctrl(self._h, int(is_chroma), ctb_log2,
                                         CHUNK_CAP,
                                         ctypes.byref(n_units))
            nu = int(n_units.value)
            if not nu:
                return np.zeros((n_keys, 0), np.int32)
            return np.ctypeslib.as_array(ptr, shape=(n_keys, nu)).copy()

        def tu_slots(is_chroma):
            n_tus = len(tus_raw)
            if not n_tus:
                return np.zeros(0, np.int32)
            buf = np.zeros(n_tus, np.int32)
            self._lib.vvch_tu_slots(
                self._h, int(is_chroma),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return buf

        ainfo = np.zeros(5, np.int32)
        self._lib.vvch_alf_info(self._h,
                                ainfo.ctypes.data_as(
                                    ctypes.POINTER(ctypes.c_int32)))
        alf = None
        if ainfo[0] or ainfo[1] or ainfo[2]:
            small = np.zeros(152, np.int32)
            self._lib.vvch_alf_small(self._h,
                                     small.ctypes.data_as(
                                         ctypes.POINTER(ctypes.c_int32)))
            n_aps = int(ainfo[3])
            if n_aps:
                lc = np.ctypeslib.as_array(
                    self._lib.vvch_alf_luma_coeff(self._h),
                    shape=(n_aps, 25, 12)).copy()
                lci = np.ctypeslib.as_array(
                    self._lib.vvch_alf_luma_clipidx(self._h),
                    shape=(n_aps, 25, 12)).copy()
            else:
                lc = np.zeros((0, 25, 12), np.int32)
                lci = np.zeros((0, 25, 12), np.int32)
            alf = {"cc_enabled": (int(ainfo[1]), int(ainfo[2])),
                   "num_chroma_alts": int(ainfo[4]),
                   "luma_coeff": lc, "luma_clipidx": lci,
                   "chroma_coeff": small[:48].reshape(8, 6),
                   "chroma_clipidx": small[48:96].reshape(8, 6),
                   "cc_coeff": small[96:152].reshape(2, 4, 7),
                   "ctb": np.ctypeslib.as_array(
                       self._lib.vvch_alf_ctb(self._h),
                       shape=(cbh, cbw, 8)).copy()}

        lminfo = np.zeros(69, np.int32)
        self._lib.vvch_lmcs(self._h,
                            lminfo.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_int32)))
        lmcs = None
        if lminfo[0]:
            lmcs = {"crs_flag": int(lminfo[1]), "min_bin": int(lminfo[2]),
                    "max_bin": int(lminfo[3]), "pivot": lminfo[4:21].copy(),
                    "fwd_scale": lminfo[21:37].copy(),
                    "inv_scale": lminfo[37:53].copy(),
                    "chroma_scale": lminfo[53:69].copy()}

        pu_h, pu_w = h // 4, w // 4
        mvf = {name: np.ctypeslib.as_array(
                   self._lib.vvch_mvf(self._h, i),
                   shape=(pu_h, pu_w)).copy()
               for i, name in enumerate(("pf", "mv_x", "mv_y", "ref",
                                         "mv1_x", "mv1_y", "ref1",
                                         "ciip"))}

        fs = FrameSyntax(
            width=w, height=h, bit_depth=bd, chroma_format_idc=cidc,
            poc=poc, slice_qp=qp,
            coeff_y=plane(0, w, h),
            coeff_cb=plane(1, cw, chh) if cidc else None,
            coeff_cr=plane(2, cw, chh) if cidc else None,
            cus={f: cus_raw[:, i] for i, f in enumerate(CU_FIELDS)},
            tus={f: tus_raw[:, i] for i, f in enumerate(TU_FIELDS)},
            ipm=ipm,
            deblock_disabled=int(deblock_disabled),
            beta_offset=beta_off,
            tc_offset=tc_off,
            slice_type=slice_type,
            ref_pocs=ref_pocs,
            mvf=mvf,
            sao=sao,
            ctrl_y=cu_ctrl(False),
            ctrl_c=cu_ctrl(True),
            ctb_log2=ctb_log2,
            max_num_reorder=max_num_reorder,
            tile_bd=tile_bd,
            dep_quant=dep_quant,
            slots_y=tu_slots(False),
            slots_c=tu_slots(True),
            lmcs=lmcs,
            alf=alf,
            crop=crop,
            gdr_pic=gdr_pic,
            recovery_poc_cnt=recovery_poc_cnt,
            has_isp=has_isp,
            has_tb64=has_tb64,
            wrap_off=wrap_off,
            sl=sl,
            fo=NativeFrame(self._lib,
                           self._lib.vvch_detach(self._h)),
        )
        if np.any(fs.cus["dmvr"]):
            self._renew()
        return fs


def dmvr_apply(fs: FrameSyntax, colstore: ColStore, epoch: int,
               planes6) -> None:
    """Hand the refined DMVR subblock MVs (ops/dmvr.py refine_frame) to
    the native side: it stores them on the detached FrameOut, publishes
    the frame's deferred collocated motion (which a later frame's parse
    may be waiting on), and the unit control matrices are read again,
    now with the refined MVs and the per-subblock BDOF kills."""
    lib = _get_lib()
    i32p = ctypes.POINTER(ctypes.c_int32)
    arrs = [np.ascontiguousarray(a, np.int32) for a in planes6]
    lib.vvch_dmvr_apply(fs.fo.ptr, colstore._s, epoch,
                        *[a.ctypes.data_as(i32p) for a in arrs])
    n_keys = 75  # ctrl::kNumKeys

    def fo_ctrl(is_chroma):
        n_units = ctypes.c_int32(0)
        ptr = lib.vvch_fo_cu_ctrl(fs.fo.ptr, int(is_chroma), fs.ctb_log2,
                                  CHUNK_CAP, ctypes.byref(n_units))
        nu = int(n_units.value)
        if not nu:
            return np.zeros((n_keys, 0), np.int32)
        return np.ctypeslib.as_array(ptr, shape=(n_keys, nu)).copy()

    fs.ctrl_y = fo_ctrl(False)
    fs.ctrl_c = fo_ctrl(True)
