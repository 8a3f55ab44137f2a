"""DMVR: decoder-side motion vector refinement (spec 8.5.3) on the device.

Int32 torch port of the JAX package's ops/dmvr.py (`_bilin`, `_unit`,
`build_subblock_ctrl`, `refine_frame_device`; the reference's
dmvr_mv_refine, vvc_inter.c:685-749, its bilinear kernels and vvc_sad).
Per 16x16 subblock of every DMVR unit: 10-bit bilinear predictions of
both lists around the parsed MVs, the 25 integer offsets scored by a
2x vertically subsampled SAD with mirrored offsets, then the 3-bit
parametric sub-pel division.  The search reads the DPB's device planes;
only the (dmv_x, dmv_y, nobdof) rows come back to the host, where a
numpy scatter fills the six per-4x4 planes that host.dmvr_apply hands
the native parser (the refined motion feeds the collocated store that
later frames read).

`refine_subblocks` is the search's entry point: on CUDA tensors it
launches the kernel (csrc/dmvr.cu, one launch a frame, the reference
planes read in place through a table of their pointers in the parameter
block), on CPU tensors it runs its plain version
(`refine_subblocks_plain`: int32 torch ops, the kernel's oracle);
nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

_I32 = torch.int32
# subblocks are at most 16x16; the bilinear window of a subblock needs
# (16 + 4 + 1) samples a side
_SB = 16
_WIN = _SB + 5

# the scan order of the 25 offsets, the centre first (the reference seeds
# its minimum with the centre and keeps the first strictly smaller SAD)
_ORDER = np.arange(25) + 1
_ORDER[12] = 0
_ORDER[13:] += 1

# control rows of a subblock (build_subblock_ctrl)
CTRL_KEYS = ("x", "y", "w", "h", "mx0", "my0", "mx1", "my1", "s0", "s1")

# reference planes the kernel takes in its parameter block (passed to nvcc
# as DMVR_MAX_SLOTS): a VVC list holds at most 15 entries, so both fit
MAX_SLOTS = 32

# launches of the CUDA kernel and runs of the plain version: plain
# integer counters a caller may reset to 0 and read back
LAUNCHES = {"dmvr": 0}
PLAIN_RUNS = {"dmvr": 0}


def _bilin(win, mx, my, bd):
  """(N, WIN - 1, WIN - 1) 10-bit bilinear predictions from (N, WIN, WIN)
  windows (dmvr/dmvr_h/dmvr_v/dmvr_hv, vvc_inter_template.c:324-437)."""
  P = _WIN - 1
  s1 = bd - 6
  o1 = 1 << (s1 - 1)
  mx, my = mx[:, None, None], my[:, None, None]
  a = win[:, :P, :P]
  h = ((16 - mx) * a + mx * win[:, :P, 1:] + o1) >> s1
  h2 = ((16 - mx) * win[:, :, :P] + mx * win[:, :, 1:] + o1) >> s1
  v = ((16 - my) * a + my * win[:, 1:, :P] + o1) >> s1
  hv = ((16 - my) * h2[:, :P] + my * h2[:, 1:] + 8) >> 4
  plain = a << (10 - bd)
  return torch.where((mx == 0) & (my == 0), plain,
                     torch.where(my == 0, h,
                                 torch.where(mx == 0, v, hv)))


def _parametric(s_minus, s_center, s_plus):
  """parametric_mv_refine (vvc_inter.c:642-683): the parabola's sub-pel
  offset by a 3-bit restoring division."""
  denom = ((s_minus + s_plus) - (s_center << 1)) << 3
  num = (s_minus - s_plus) * 16
  sign = num < 0
  num = num.abs()
  q = torch.zeros_like(num)
  d = denom
  for _ in range(3):
    q = q << 1
    ge = num >= d
    num = torch.where(ge, num - d, num)
    q = torch.where(ge, q + 1, q)
    d = d >> 1
  q = torch.where(sign, -q, q)
  q = torch.where(s_minus == s_center, -8,
                  torch.where(s_plus == s_center, 8, q))
  return torch.where(denom == 0, 0, q)


def refine_subblocks(planes, ctrl: torch.Tensor, *, H: int, W: int,
                     bit_depth: int):
  """The search of n subblocks.  planes: the reference luma planes
  [L0..., L1...] (padded DPB planes, all of one shape, contiguous int32,
  at most MAX_SLOTS; reads clamp to the H x W picture); ctrl: (10, n)
  int32 rows (CTRL_KEYS; s1 already indexes the L1 block; check_rows
  holds them to the planes).  Returns (3, n) int32: dmv_x, dmv_y and
  nobdof.  CUDA tensors launch the kernel; CPU tensors run
  refine_subblocks_plain."""
  check_planes(planes, H, W)
  dev = ctrl.device
  if planes[0].device != dev:
    raise ValueError(f"refine_subblocks: rows on {dev}, planes on "
                     f"{planes[0].device}")
  if dev.type == "cuda":
    return _search_cuda(planes, ctrl, H, W, bit_depth)
  if dev.type != "cpu":
    raise ValueError(f"refine_subblocks: unsupported device {dev}")
  return refine_subblocks_plain(planes, ctrl, H=H, W=W, bit_depth=bit_depth)


def refine_subblocks_plain(planes, ctrl: torch.Tensor, *, H: int, W: int,
                           bit_depth: int):
  """refine_subblocks's plain version, with its arguments and result."""
  PLAIN_RUNS["dmvr"] += 1
  dev = ctrl.device
  c = {k: ctrl[i] for i, k in enumerate(CTRL_KEYS)}
  n = ctrl.shape[1]
  Hp, Wp = planes[0].shape
  flat = torch.stack(list(planes)).reshape(-1)
  idx = torch.arange(_WIN, dtype=_I32, device=dev)

  def predict(slot, mvx, mvy):
    ys = (c["y"] + (mvy >> 4) - 2)[:, None] + idx
    xs = (c["x"] + (mvx >> 4) - 2)[:, None] + idx
    ys, xs = ys.clamp(0, H - 1), xs.clamp(0, W - 1)
    g = (slot.long()[:, None, None] * (Hp * Wp) + ys.long()[:, :, None] * Wp
         + xs.long()[:, None, :])
    return _bilin(flat[g], mvx & 15, mvy & 15, bit_depth)

  t0 = predict(c["s0"], c["mx0"], c["my0"])
  t1 = predict(c["s1"], c["mx1"], c["my1"])
  # the SAD of every other row of the subblock, offsets mirrored between
  # the lists
  rows = torch.arange(0, _SB, 2, device=dev)
  cols = torch.arange(_SB, device=dev)
  m = ((rows[None, :, None] < c["h"][:, None, None])
       & (cols[None, None, :] < c["w"][:, None, None])).to(_I32)
  sads = []
  for dy in range(5):
    for dx in range(5):
      a = t0[:, dy:dy + _SB:2, dx:dx + _SB]
      b = t1[:, 4 - dy:4 - dy + _SB:2, 4 - dx:4 - dx + _SB]
      sads.append(((a - b).abs() * m).sum((1, 2), dtype=_I32))
  sads = torch.stack(sads, 1)                                  # (n, 25)
  center = sads[:, 12] - (sads[:, 12] >> 2)
  sads[:, 12] = center
  area = c["w"] * c["h"]
  run = center >= area
  key = sads * 32 + torch.as_tensor(_ORDER, dtype=_I32, device=dev)
  best = key.argmin(1)
  ar = torch.arange(n, device=dev)
  min_sad = torch.where(run, sads[ar, best], center)
  bdy, bdx = best // 5, best % 5
  dmv_x = torch.where(run, (bdx.to(_I32) - 2) * 16, 0)
  dmv_y = torch.where(run, (bdy.to(_I32) - 2) * 16, 0)
  interior = (bdx != 0) & (bdx != 4) & (bdy != 0) & (bdy != 4)

  def at(k):
    return sads[ar, k.clamp(0, 24)]

  px = _parametric(at(best - 1), min_sad, at(best + 1))
  py = _parametric(at(best - 5), min_sad, at(best + 5))
  do_p = run & interior
  dmv_x = dmv_x + torch.where(do_p, px, 0)
  dmv_y = dmv_y + torch.where(do_p, py, 0)
  nobdof = (min_sad < 2 * area).to(_I32)
  return torch.stack([dmv_x, dmv_y, nobdof])


def build_subblock_ctrl(fs) -> np.ndarray:
  """Per-subblock control rows (10, n) of every DMVR unit of the frame
  (CTRL_KEYS; s0/s1 are the units' reference indices in their lists),
  in unit order, subblocks in raster order."""
  cus = fs.cus
  j = np.flatnonzero(cus["dmvr"])
  if not len(j):
    return np.zeros((10, 0), np.int32)
  w, h = cus["w"][j].astype(np.int64), cus["h"][j].astype(np.int64)
  nsx = np.where(w > 16, w >> 4, 1)
  nsy = np.where(h > 16, h >> 4, 1)
  sbw, sbh = w // nsx, h // nsy
  reps = nsx * nsy
  u = np.repeat(np.arange(len(j)), reps)
  k = np.arange(int(reps.sum())) - np.repeat(np.cumsum(reps) - reps, reps)
  sx = cus["x0"][j][u] + (k % nsx[u]) * sbw[u]
  sy = cus["y0"][j][u] + (k // nsx[u]) * sbh[u]
  rows = [sx, sy, sbw[u], sbh[u], cus["mv_x"][j][u], cus["mv_y"][j][u],
          cus["mv1_x"][j][u], cus["mv1_y"][j][u], cus["ref_idx"][j][u],
          cus["ref_idx1"][j][u]]
  return np.ascontiguousarray(np.stack(rows).astype(np.int32))


def refine_frame(fs, dpb: dict, device, call=None):
  """The DMVR search of one frame on `device` against the DPB's luma
  planes, and the host scatter of its results: returns the six per-4x4
  (H / 4, W / 4) int32 planes of host.dmvr_apply (refined L0 x/y, L1
  x/y, valid, nobdof), as the JAX refine_frame_device does.  The rows
  are checked (check_rows) before they go to the device.  call(kernel
  name, plane kind, kwargs) -> result, when given, runs the search as
  kernel "dmvr", plane kind "luma" (the frame program's call hook)."""
  ctrl = build_subblock_ctrl(fs)
  n = ctrl.shape[1]
  pw, ph = fs.width >> 2, fs.height >> 2
  out = [np.zeros((ph, pw), np.int32) for _ in range(6)]
  if not n:
    return tuple(out)
  # reference slots: the L0 planes, then the L1 planes (s1 offset by the
  # L0 count); an entry missing from the DPB reads its first plane
  n_l0 = max(1, len(fs.ref_pocs[0]))
  planes = []
  for lx in range(2):
    for k in range(max(1, len(fs.ref_pocs[lx]))):
      poc = fs.ref_pocs[lx][k] if k < len(fs.ref_pocs[lx]) else None
      planes.append(dpb[poc][0] if poc in dpb else dpb[next(iter(dpb))][0])
  dctrl = ctrl.copy()
  dctrl[9] += n_l0
  check_rows(dctrl, n_l0, len(planes))
  kw = dict(planes=planes, ctrl=torch.from_numpy(dctrl).to(device),
            H=fs.height, W=fs.width, bit_depth=fs.bit_depth)
  res = (call("dmvr", "luma", kw) if call is not None
         else refine_subblocks(**kw)).cpu().numpy()
  dmv_x, dmv_y = res[0].astype(np.int64), res[1].astype(np.int64)

  def clip17(v):
    return np.clip(v, -(1 << 17), (1 << 17) - 1)

  x0q, y0q = ctrl[0] >> 2, ctrl[1] >> 2
  wq, hq = ctrl[2] >> 2, ctrl[3] >> 2
  reps = (wq * hq).astype(np.int64)
  start = np.cumsum(reps) - reps
  pos = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(start, reps)
  w_i = np.repeat(wq.astype(np.int64), reps)
  flat = ((np.repeat(y0q.astype(np.int64), reps) + pos // w_i) * pw
          + np.repeat(x0q.astype(np.int64), reps) + pos % w_i)
  for plane, vals in zip(out, (clip17(ctrl[4] + dmv_x),
                               clip17(ctrl[5] + dmv_y),
                               clip17(ctrl[6] - dmv_x),
                               clip17(ctrl[7] - dmv_y),
                               np.ones(n, np.int64), res[2])):
    plane.reshape(-1)[flat] = np.repeat(vals.astype(np.int32), reps)
  return tuple(out)


def check_planes(planes, H: int, W: int) -> None:
  """Raises ValueError unless the search can take `planes`: 1 to
  MAX_SLOTS tensors of one shape, device and dtype (int32), each
  contiguous and covering the H x W picture."""
  if not 1 <= len(planes) <= MAX_SLOTS:
    raise ValueError(f"refine_subblocks: {len(planes)} reference planes, "
                     f"expected 1 to {MAX_SLOTS}")
  p0 = planes[0]
  for k, p in enumerate(planes):
    if p.dtype != _I32 or p.dim() != 2 or not p.is_contiguous() \
        or p.shape != p0.shape or p.device != p0.device:
      raise ValueError(f"refine_subblocks: plane {k} is {p.dtype} "
                       f"{tuple(p.shape)} strides {p.stride()} on {p.device}; "
                       "expected contiguous int32 planes of one shape "
                       f"{tuple(p0.shape)} on {p0.device}")
  if not (1 <= H <= p0.shape[0] and 1 <= W <= p0.shape[1]):
    raise ValueError(f"refine_subblocks: picture {W}x{H} outside the planes "
                     f"{tuple(p0.shape)}")


def check_rows(ctrl: np.ndarray, n_l0: int, slots: int) -> None:
  """Raises ValueError unless the (10, n) control rows (s1 already offset
  by n_l0) name slots 0 <= s0 < n_l0 <= s1 < slots and subblocks of w, h
  in {8, 16} with w * h >= 128 (build_subblock_ctrl's shapes)."""
  c = dict(zip(CTRL_KEYS, ctrl))
  if not (0 < n_l0 < slots <= MAX_SLOTS):
    raise ValueError(f"refine_subblocks: {n_l0} L0 slots of {slots}, at "
                     f"most {MAX_SLOTS}")
  if len(c["s0"]) and (c["s0"].min() < 0 or c["s0"].max() >= n_l0
                       or c["s1"].min() < n_l0 or c["s1"].max() >= slots):
    raise ValueError("refine_subblocks: reference slots outside 0 <= s0 < "
                     f"{n_l0} <= s1 < {slots}")
  w, h = c["w"], c["h"]
  if not np.all(((w == 8) | (w == 16)) & ((h == 8) | (h == 16))
                & (w * h >= 128)):
    raise ValueError("refine_subblocks: subblocks other than 16x16, 8x16 "
                     "and 16x8")


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "dmvr.cu")
_lib = None


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("dmvr", [_SRC],
                                 (("DMVR_MAX_SLOTS", MAX_SLOTS),)))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dmvr_search_launch.restype = ctypes.c_int
    lib.dmvr_search_launch.argtypes = [
        p, i, ll,       # plane pointers, their count, row stride
        i, i, i,        # H, W, bit_depth
        p, p, i, p]     # ctrl, out, subblocks, stream
    lib.dmvr_error_string.restype = ctypes.c_char_p
    lib.dmvr_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


def _search_cuda(planes, ctrl, H, W, bit_depth):
  """One launch on ctrl's device's current stream into a new (3, n)
  tensor; the planes (checked by the caller, on ctrl's device) are read
  in place."""
  dev = ctrl.device
  if ctrl.dtype != _I32 or ctrl.dim() != 2 or ctrl.shape[0] != len(CTRL_KEYS) \
      or not ctrl.is_contiguous():
    raise ValueError(f"refine_subblocks: expected contiguous int32 (10, n) "
                     f"rows, got {ctrl.dtype} {tuple(ctrl.shape)} strides "
                     f"{ctrl.stride()}")
  n = ctrl.shape[1]
  out = torch.empty((3, n), dtype=_I32, device=dev)
  if not n:
    return out
  ptrs = (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])
  lib = _get_kernel()
  with torch.cuda.device(dev):
    rc = lib.dmvr_search_launch(
        ptrs, len(planes), planes[0].stride(0), H, W, bit_depth,
        ctrl.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream)
  if rc != 0:
    raise RuntimeError("dmvr kernel launch failed: "
                       f"{lib.dmvr_error_string(rc).decode()}")
  LAUNCHES["dmvr"] += 1
  return out
