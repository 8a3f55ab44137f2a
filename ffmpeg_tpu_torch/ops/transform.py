"""Residual stage: dequant, inverse LFNST and inverse DCT2/DST7/DCT8.

Bit-exact torch port of the bucketed residual path of the JAX frame
program (dequant per spec 8.7.3, `vvc_intra.c:277-417`; 2-D inverse
transform `vvcdsp.c:94-117`): TUs arrive grouped by (w, h) size class,
each class is one batched dequant + two matrix products, and the
results are placed into a residual plane.

Besides the 2-D classes of 2..32 a side, three kinds of classes exist
on the frames that carry their tools (inputs.py adds them per frame):
the 1-D classes of ISP sub-partitions (1 or 2 samples wide or high: one
transform pass, shift 6 + 15 - bd, no intermediate clip), the 64-point
classes of TB-64 frames (DCT2 only, with the high-frequency zero-out:
levels arrive as the coded (min(h, 32), min(w, 32)) corner and the basis
columns are sliced to it), and both at once.  Explicit scaling lists
replace the flat dequant factor 16 with a per-coefficient factor.

`residual_planes` is the frame program's entry point: one call for the
luma plane, one for the Cb and Cr planes together.  A CUDA tensor
launches the kernel (csrc/residual.cu: one launch per call, one thread
block per TU, int32 sums, each TU written once into a zero-filled
plane); a CPU tensor runs the plain version, `residual_planes_plain`,
composed of `residual_plane` per component (the ports of the JAX
functions below, and the kernel's oracle).

CUDA torch has no integer matrix product, so the plain version's
products run in float64.  That is exact: every basis value is at most
91 in magnitude, every input below 2^15 and every sum has at most 32
coded terms (the 64-point zero-out keeps 32), so |sum| < 32 * 91 * 2^15
< 2^27, far below 2^53.  Everything else is int32, with the C
reference's wraparound on the dequant multiply and arithmetic `>>` on
negatives.
"""
from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np
import torch

from .tables import VVC_TABLES as _TABLES
from .tables import on_device

# launches of the CUDA kernel, and runs of the plain version: plain
# integer counters a caller may reset to 0 and read back
LAUNCHES = {"residual": 0}
PLAIN_RUNS = {"residual": 0}

LEVEL_SCALE = np.array([[40, 45, 51, 57, 64, 72],
                        [57, 64, 72, 80, 90, 102]], dtype=np.int32)

# row order of the per-bucket scalar matrix (decode.cc BucketRow)
BUCKET_ROWS = ("x0", "y0", "scale", "shift", "slot", "trh", "trv", "jop",
               "ts", "lf_sel", "lf_tr", "vpdu", "sbs", "slid")


def itx_matrix(kind: str, n: int) -> np.ndarray:
  """Inverse 1-D basis M (out = M @ coeffs), int32."""
  return _TABLES[f"{kind}_{n}"].astype(np.int32)


def dequant_scale_shift(qp: int, log2_w: int, log2_h: int, bit_depth: int,
                        dep_quant: bool = False) -> tuple[int, int]:
  """Per-TB dequant scale and shift (spec 8.7.3, ts=0, flat scale_m=16)."""
  log_sum = log2_w + log2_h
  rect = log_sum & 1
  qp_eff = qp + (1 if dep_quant else 0)
  scale = int(LEVEL_SCALE[rect][qp_eff % 6]) << (qp_eff // 6)
  bd_shift = bit_depth + rect + log_sum // 2 + 10 - 15 + (1 if dep_quant else 0)
  return scale, bd_shift


@lru_cache(maxsize=None)
def diag_scan(blk_w: int, blk_h: int) -> tuple:
  """(x, y) in up-right diagonal scan order (spec 6.5.2)."""
  out = []
  x = y = 0
  while len(out) < blk_w * blk_h:
    while y >= 0:
      if x < blk_w and y < blk_h:
        out.append((x, y))
      y -= 1
      x += 1
    y = x
    x = 0
  return tuple(out)


@lru_cache(maxsize=None)
def lfnst_consts(big: bool):
  """Static tables for the inverse LFNST (ilfnst_transform,
  vvc_intra.c:419-480): stacked kernel matrices [8][16][N]
  (set*2 + kernel) and scatter coordinates for the normal and
  transposed output layouts."""
  mats = _TABLES["lfnst_8x8" if big else "lfnst_4x4"].astype(np.int32)
  mats = mats.reshape(8, 16, mats.shape[-1])  # (set*2+kernel, 16, N)
  sc = diag_scan(4, 4)
  in_x = np.array([p[0] for p in sc], np.int32)
  in_y = np.array([p[1] for p in sc], np.int32)
  oy, ox, ty, tx = [], [], [], []
  if big:
    # rows 0-3: 8 wide; rows 4-7: 4 wide (48 outputs)
    for y in range(8):
      for x in range(8 if y < 4 else 4):
        oy.append(y)
        ox.append(x)
    # transpose layout (vvc_intra.c:441-457): dst[y][0..3] = src[y + 8*k];
    # rows 0-3 also cols 4-7 from 32 + ...
    grid = {}
    for y in range(8):
      for k in range(4):
        grid[(y, k)] = y + 8 * k
      if y < 4:
        for k in range(4):
          grid[(y, 4 + k)] = 32 + y + 4 * k
    inv = {v: yx for yx, v in grid.items()}
    for j in range(48):
      y, x = inv[j]
      ty.append(y)
      tx.append(x)
  else:
    for y in range(4):
      for x in range(4):
        oy.append(y)
        ox.append(x)
    for j in range(16):
      ty.append(j % 4)
      tx.append(j // 4)
  return (mats, in_y, in_x, np.array(oy, np.int32), np.array(ox, np.int32),
          np.array(ty, np.int32), np.array(tx, np.int32))


def _basis_stack(n: int, device) -> torch.Tensor:
  """(3, n, n) float64 DCT2/DST7/DCT8 bases, indexed by the TU's kind."""
  return on_device(("stack", n), device, lambda: torch.from_numpy(np.stack(
      [itx_matrix(k, n) for k in ("dct2", "dst7", "dct8")])).double())


def _dct2(n: int, device) -> torch.Tensor:
  return on_device(("dct2", n), device,
             lambda: torch.from_numpy(itx_matrix("dct2", n)).double())


def _idx(a, device):
  return torch.as_tensor(a, dtype=torch.long, device=device)


def apply_lfnst(deq: torch.Tensor, b: dict, w: int, h: int) -> torch.Tensor:
  """Inverse LFNST on the dequantized coefficients of lfnst TUs
  (wholesale block replace is safe: signalling legality confines the
  parsed coefficients to the gather region).  The transform range is
  fixed at 15 bits (no extended precision)."""
  big = w >= 8 and h >= 8
  mats, in_y, in_x, oy, ox, ty, tx = lfnst_consts(big)
  dev = deq.device
  lim = 1 << 15
  u = deq[:, _idx(in_y, dev), _idx(in_x, dev)]          # (n, 16)
  sel = b["lf_sel"].clamp(0, 7).long()
  M = on_device(("lfnst", big), dev, lambda: torch.from_numpy(mats).double())[sel]
  v = torch.einsum("ni,nio->no", u.double(), M).to(torch.int32)
  v = ((v + 64) >> 7).clamp(-lim, lim - 1)
  norm = torch.zeros_like(deq)
  norm[:, _idx(oy, dev), _idx(ox, dev)] = v
  trans = torch.zeros_like(deq)
  trans[:, _idx(ty, dev), _idx(tx, dev)] = v
  out = torch.where(b["lf_tr"][:, None, None] > 0, trans, norm)
  return torch.where((b["lf_sel"] >= 0)[:, None, None], out, deq)


def bucket_view(bucket: dict) -> dict:
  """Named live rows of one size class: the first n columns of the
  per-bucket scalar matrix (BUCKET_ROWS order) and the first n level
  blocks."""
  n = bucket["n"]
  d = {k: bucket["mat"][i, :n] for i, k in enumerate(BUCKET_ROWS)}
  d["lv"] = bucket["lv"][:n]
  return d


def _zo(d: int) -> int:
  """Coded extent of a transform dimension: the 64-point DCT2 zeroes out
  all but its low 32 coefficients."""
  return min(d, 32)


def _scaling_factors(b: dict, w: int, h: int, sl: dict) -> torch.Tensor:
  """Per-coefficient dequant factors m of explicit scaling lists
  (derive_scale_m, vvc_intra.c:340-385) over the coded (zh, zw) region:
  the TU's 8x8 ScalingMatrixRec (row `slid`) upsampled by index shifts,
  position (0, 0) overridden by ScalingMatrixDcRec for ids >= 14, and
  the flat 16 where slid < 0.  Returns (n, zh, zw) int32."""
  dev = b["lv"].device
  slid = b["slid"].long()
  mx = max(w, h)
  l2m = 1 if mx == 2 else (2 if mx == 4 else 3)
  log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
  iy = np.minimum((np.arange(_zo(h)) << l2m) >> log2h, (1 << l2m) - 1)
  ix = np.minimum((np.arange(_zo(w)) << l2m) >> log2w, (1 << l2m) - 1)
  m = sl["rec"][slid.clamp(min=0)][:, _idx(iy, dev)][:, :, _idx(ix, dev)]
  if mx >= 16:
    dc = sl["dc"][(slid - 14).clamp(0, 13)]
    m[:, 0, 0] = torch.where(slid >= 14, dc, m[:, 0, 0])
  return torch.where(slid[:, None, None] < 0, 16, m)


def _pass_basis(kind_row, n: int, zn: int, dev, mts_max: int):
  """The inverse basis of one transform pass over n outputs from zn
  coded inputs: per TU (DCT2/DST7/DCT8 by its kind row, (N, n, n)) for 4
  <= n <= mts_max, else DCT2 with its columns sliced to the coded region
  ((n, zn), shared)."""
  if 4 <= n <= mts_max:
    return _basis_stack(n, dev)[kind_row.long()]
  return _dct2(n, dev)[:, :zn]


def bucket_residuals(b: dict, w: int, h: int, bit_depth: int,
                     is_chroma: bool, chroma_scale=None,
                     sl=None) -> torch.Tensor:
  """Dequant + inverse transform of one (w, h) size class -> (n, h, w)
  int32 residual blocks (bucket_view rows in, live rows only; the level
  blocks are the coded (min(h, 32), min(w, 32)) corner).
  chroma_scale, when given, is the flat per-VPDU LMCS scale array
  (ops/lmcs.py lmcs_vpdu_scales), applied to chroma TBs of more than 4
  samples by their `vpdu` row (itransform, vvc_intra.c:449-475).
  sl: the frame's explicit scaling lists {"rec": (28, 8, 8), "dc": (14,)}
  int32, or None (flat)."""
  dev = b["lv"].device
  levels = b["lv"]
  zw, zh = _zo(w), _zo(h)
  if sl is not None:
    # int32 products in the JAX order (scale * m, then * level), so that
    # any wrap is the same wrap
    scale16 = b["scale"][:, None, None] * _scaling_factors(b, w, h, sl)
  else:
    scale16 = (b["scale"] * 16)[:, None, None]
  sh = b["shift"][:, None, None]
  off = (1 << sh) >> 1
  deq = (levels * scale16 + off) >> sh
  deq = torch.where(levels == 0, torch.zeros_like(deq),
                    deq.clamp(-(1 << 15), (1 << 15) - 1))
  if not is_chroma and w >= 4 and h >= 4:
    deq = apply_lfnst(deq, b, w, h)
  # transform skip, where the block is not zeroed out: the dequantized
  # levels ARE the residual (never signalled for 64-point TBs)
  ts = (zw, zh) == (w, h)
  if w == 1 or h == 1:
    # 1-D TBs (ISP sub-partitions): one pass with shift 6 + 15 - bd and no
    # intermediate clip (itx_1d, vvcdsp.c:119-138); DST7/DCT8 for 4..16
    if h == 1:
      m = _pass_basis(b["trh"], w, zw, dev, 16)
      out = torch.einsum("nyk,nxk->nyx" if m.dim() == 3 else "nyk,xk->nyx",
                         deq.double(), m)
    else:
      m = _pass_basis(b["trv"], h, zh, dev, 16)
      out = torch.einsum("nyk,nkx->nyx" if m.dim() == 3 else "yk,nkx->nyx",
                         m, deq.double())
    shift1 = 6 + 15 - bit_depth
    out = (out.to(torch.int32) + (1 << (shift1 - 1))) >> shift1
    return torch.where(b["ts"][:, None, None] > 0, deq, out) if ts else out
  # per-TU transform kind (0=DCT2 1=DST7 2=DCT8, spec 8.7.4 / MTS);
  # DST7/DCT8 exist for 4..32 only, other sizes are always DCT2
  mv = _pass_basis(b["trv"], h, zh, dev, 32)
  tmp = torch.einsum("nyk,nkx->nyx" if mv.dim() == 3 else "yk,nkx->nyx", mv,
                     deq.double())
  tmp = ((tmp.to(torch.int32) + 64) >> 7).clamp(-(1 << 15), (1 << 15) - 1)
  mh = _pass_basis(b["trh"], w, zw, dev, 32)
  out = torch.einsum("nyk,nxk->nyx" if mh.dim() == 3 else "nyk,xk->nyx",
                     tmp.double(), mh)
  shift2 = 5 + 15 - bit_depth
  out = (out.to(torch.int32) + (1 << (shift2 - 1))) >> shift2
  if ts:
    out = torch.where(b["ts"][:, None, None] > 0, deq, out)
  if is_chroma:
    # joint-CbCr derived residual: (r * c_sign) >> shift applied to
    # the post-ITX samples (add_residual_joint, vvcdsp_template.c:48)
    jop = b["jop"][:, None, None]
    sgn = torch.where((jop == 2) | (jop == 4), -out, out)
    out = torch.where(jop == 0, out, torch.where(jop >= 3, sgn >> 1, sgn))
  if is_chroma and chroma_scale is not None and w * h > 4:
    # LMCS chroma residual scaling (lmcs_scale_chroma,
    # vvc_intra_template.c:431-454), after the joint-CbCr sign and shift
    sc = chroma_scale[b["vpdu"].long()][:, None, None]
    c = out.clamp(-(1 << bit_depth), (1 << bit_depth) - 1)
    mag = (c.abs() * sc + (1 << 10)) >> 11
    out = torch.where(c < 0, -mag, mag)
  return out


def residual_plane(buckets: dict, Hp: int, Wp: int, bit_depth: int, sizes,
                   is_chroma: bool, device, chroma_scale=None,
                   sl=None) -> torch.Tensor:
  """(Hp, Wp) int32 residual plane of one component: every size class's
  blocks placed at their TU origins (TUs never overlap).  chroma_scale,
  sl: as in bucket_residuals."""
  res = torch.zeros((Hp, Wp), dtype=torch.int32, device=device)
  for (w, h) in sizes:
    bucket = buckets[(w, h)]
    if not bucket["n"]:
      continue
    b = bucket_view(bucket)
    out = bucket_residuals(b, w, h, bit_depth, is_chroma, chroma_scale, sl)
    yy = b["y0"].long()[:, None, None] + torch.arange(h, device=device)[
        None, :, None]
    xx = b["x0"].long()[:, None, None] + torch.arange(w, device=device)[
        None, None, :]
    res[yy, xx] = out
  return res


# ----------------------------------------------------------------------
# the entry point, its plain version, and the CUDA kernel
# (csrc/residual.cu), built with nvcc at first use and bound with ctypes
# ----------------------------------------------------------------------

# the kernel's error word: the rows it found out of range, by bit
ERRORS = {1: "a transform kind outside 0..2",
          2: "a vpdu outside the chroma scales",
          4: "a scaling-list id past 27",
          8: "a block that leaves the plane",
          16: "a dequant shift outside 0..31"}

# the transform sizes a class may have a side of
_EDGES = (1, 2, 4, 8, 16, 32, 64)


def _classes(buckets, sizes, Hp, Wp, bit_depth, chroma, chroma_scale, sl):
  """Check a call's inputs, on every device, and list its non-empty
  classes for the kernel: (component, w, h, bucket).  Per component a
  bucket per size, whose (14, ld) row matrix and (ld, zh, zw) levels are
  contiguous int32 tensors of at least n columns and blocks on one
  device; one component for luma, two for chroma; the chroma scales (a
  chroma call's only) and the scaling lists ({"rec": (28, 8, 8), "dc":
  (14,)}) contiguous int32 on that device; 8 to 12 bits.  Raises
  ValueError on anything else: nothing is copied or converted."""
  def bad(msg):
    raise ValueError(f"residual: {msg}")

  if len(buckets) != (2 if chroma else 1):
    bad(f"{len(buckets)} components for a "
        f"{'chroma' if chroma else 'luma'} call")
  if not 8 <= bit_depth <= 12 or Hp < 1 or Wp < 1:
    bad(f"{bit_depth} bits or a {Hp}x{Wp} plane not taken")
  dev, out = None, []
  for c, comp in enumerate(buckets):
    for wh in sizes:
      w, h = wh
      if wh not in comp or w not in _EDGES or h not in _EDGES or w * h < 2:
        bad(f"no bucket of size class {wh} in component {c}")
      b = comp[wh]
      n, mat, lv = int(b["n"]), b["mat"], b["lv"]
      if dev is None:
        dev = mat.device
      shapes_ok = (mat.dim() == 2 and mat.shape[0] == len(BUCKET_ROWS)
                   and mat.shape[1] >= n and lv.dim() == 3
                   and lv.shape[0] >= n
                   and tuple(lv.shape[1:]) == (_zo(h), _zo(w)))
      if not shapes_ok or any(
          t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev
          for t in (mat, lv)):
        bad(f"class {wh} of component {c}: expected contiguous int32 rows "
            f"({len(BUCKET_ROWS)}, >={n}) and levels (>={n}, {_zo(h)}, "
            f"{_zo(w)}) on {dev}, got {mat.dtype} {tuple(mat.shape)} and "
            f"{lv.dtype} {tuple(lv.shape)} on {mat.device}, {lv.device}")
      if n:
        out.append((c, w, h, b))
  extra = {}
  if chroma_scale is not None:
    if not chroma:
      bad("chroma scales go with a chroma call")
    extra["chroma_scale"] = (chroma_scale, None)
  if sl is not None:
    extra.update(rec=(sl["rec"], (28, 8, 8)), dc=(sl["dc"], (14,)))
  for k, (t, shape) in extra.items():
    if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev \
        or (shape is None and (t.dim() != 1 or not t.numel())) \
        or (shape is not None and tuple(t.shape) != shape):
      bad(f"{k}: expected contiguous int32 {shape or '1-D'} on {dev}, got "
          f"{t.dtype} {tuple(t.shape)} on {t.device}")
  return dev, out


def residual_planes(*, buckets, sizes, Hp: int, Wp: int, bit_depth: int,
                    chroma: bool, chroma_scale=None, sl=None):
  """The residual planes of one call of the frame program: luma, or Cb
  and Cr together.

  buckets: per component (one for luma, Cb and Cr for chroma) the
  converted size classes {(w, h): {"mat": (14, ld) int32 rows in
  BUCKET_ROWS order, "lv": (ld, min(h, 32), min(w, 32)) int32 levels,
  "n": live TUs}}; sizes: the classes to run, in order.  chroma_scale:
  the per-VPDU LMCS scales (chroma only), sl: the explicit scaling lists,
  as in bucket_residuals.  Returns (nch, Hp, Wp) int32, zero outside the
  TUs.  A CUDA tensor launches the kernel and raises on the rows its
  error word names (reading the word waits for the launch); a CPU tensor
  runs the plain version; nothing falls back from one to the other."""
  dev, classes = _classes(buckets, sizes, Hp, Wp, bit_depth, chroma,
                          chroma_scale, sl)
  if dev.type == "cuda":
    planes, err = _residual_launch(dev, classes, nch=len(buckets), Hp=Hp,
                                   Wp=Wp, bit_depth=bit_depth, chroma=chroma,
                                   chroma_scale=chroma_scale, sl=sl)
    e = int(err.item())  # waits for the launch
    if e:
      raise RuntimeError("residual kernel: rows out of range: " + "; ".join(
          msg for bit, msg in ERRORS.items() if e & bit))
    return planes
  if dev.type != "cpu":
    raise ValueError(f"residual: unsupported device {dev}")
  return residual_planes_plain(buckets=buckets, sizes=sizes, Hp=Hp, Wp=Wp,
                               bit_depth=bit_depth, chroma=chroma,
                               chroma_scale=chroma_scale, sl=sl)


def residual_planes_plain(*, buckets, sizes, Hp: int, Wp: int,
                          bit_depth: int, chroma: bool, chroma_scale=None,
                          sl=None):
  """residual_planes's plain version, with its arguments and result:
  residual_plane per component."""
  PLAIN_RUNS["residual"] += 1
  dev = buckets[0][sizes[0]]["mat"].device
  return torch.stack([residual_plane(b, Hp, Wp, bit_depth, sizes, chroma,
                                     dev, chroma_scale, sl)
                      for b in buckets])


@lru_cache(maxsize=None)
def _table_blob():
  """The kernel's tables as one int32 array and the offset of each
  (csrc/residual.cu T_*): the bases at kind * 7 + log2(n), the LFNST
  matrices (8, 16, N) for N = 16 and 48, the 4x4 diagonal scan (rows,
  then columns) and per N the normal and transposed scatter (rows,
  columns, rows, columns)."""
  parts, toff = [], []

  def put(a):
    toff.append(sum(p.size for p in parts))
    parts.append(np.asarray(a, np.int32).reshape(-1))

  for kind in ("dct2", "dst7", "dct8"):
    for lg in range(7):
      n = 1 << lg
      if f"{kind}_{n}" in _TABLES:
        put(itx_matrix(kind, n))
      else:
        toff.append(-1)
  for big in (False, True):
    put(lfnst_consts(big)[0])
  _, in_y, in_x, *_ = lfnst_consts(False)
  put(np.concatenate([in_y, in_x]))
  for big in (False, True):
    put(np.concatenate(lfnst_consts(big)[3:]))
  return np.concatenate(parts), np.asarray(toff, np.int32)


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "residual.cu")
_lib = None


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("residual", [_SRC]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.residual_launch.restype = ctypes.c_int
    lib.residual_launch.argtypes = [
        p, i, p, p,         # classes, their count, planes, error word
        i, i, i, i, i,      # nch, Hp, Wp, bit_depth, chroma
        p, i, p, p,         # chroma scales, their count, sl rec, sl dc
        p, p, i, p]         # tables, their offsets, offset count, stream
    lib.residual_error_string.restype = ctypes.c_char_p
    lib.residual_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


def _residual_launch(dev, classes, *, nch, Hp, Wp, bit_depth, chroma,
                     chroma_scale, sl):
  """One launch over `classes` (_classes) on the device's current stream
  into a new zero-filled (nch, Hp, Wp) tensor, which every thread block
  writes its TU into.  Returns the planes and the kernel's error word (a
  one-element tensor in the same allocation, after the planes: one fill
  for both), unread."""
  lib = _get_kernel()
  blob, toff = _table_blob()
  tab = on_device(("residual_tables",), dev,
                  lambda: torch.from_numpy(blob))
  rows = []
  for c, w, h, b in classes:
    rows += [b["mat"].data_ptr(), b["lv"].data_ptr(), w, h, int(b["n"]),
             b["mat"].shape[1], c]
  buf = torch.zeros(nch * Hp * Wp + 1, dtype=torch.int32, device=dev)
  planes, err = buf[:-1].view(nch, Hp, Wp), buf[-1:]
  scale = (None, 0) if chroma_scale is None else (chroma_scale.data_ptr(),
                                                  chroma_scale.numel())
  lists = (None, None) if sl is None else (sl["rec"].data_ptr(),
                                           sl["dc"].data_ptr())
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.residual_launch(
        (ctypes.c_longlong * len(rows))(*rows), len(classes),
        planes.data_ptr(), err.data_ptr(), nch, Hp, Wp, bit_depth,
        int(chroma), *scale, *lists, tab.data_ptr(), toff.ctypes.data,
        len(toff), stream)
  if rc != 0:
    raise RuntimeError("residual kernel launch failed: "
                       f"{lib.residual_error_string(rc).decode()}")
  LAUNCHES["residual"] += 1
  return planes, err

