"""Sample Adaptive Offset: the SAO kernel and its plain version.

Bit-exact port of the JAX package's SAO (spec 8.8.2; parity target
vvc_filter_template.c sao_band_filter/sao_edge_filter +
ff_vvc_sao_filter, vvc_filter.c:154-306).  The whole plane is filtered
out of place from the deblocked input, so every edge comparison reads
the unfiltered neighbour by construction.  Edge offsets are not applied
where the needed neighbour lies outside the picture.

`sao_planes` is the frame program's entry point: a luma plane, or the
Cb and Cr planes together, with the frame's SAO tree; `sao_rows` (the
band form) and `sao_plane` take one plane and its per-CTB grids.  A
CUDA tensor launches the kernel (csrc/sao.cu: one launch per call into
a new tensor, a persistent grid over TH x TW tiles staged in shared
memory with their ring, the grids read in place through their strides,
each tile's CTB parameters once; the Cb+Cr launch may overlap the luma
launch queued just before it, when the caller says so); a CPU tensor
runs the plain version (`sao_rows_plain`, `sao_planes_plain`: int32
torch ops, the kernel's oracle); nothing falls back from one to the
other.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .tables import on_device

# launches of the CUDA kernel, the Cb+Cr launches among them that may
# overlap the luma launch before them, and runs of the plain version:
# plain integer counters a caller may reset to 0 and read back
LAUNCHES = {"sao": 0}
OVERLAPS = {"sao": 0}
PLAIN_RUNS = {"sao": 0}

# the kernel's tile (csrc/sao.cu TH, TW) and its smallest CTB: it takes
# CTBs of a power of 2 samples, MIN_CTB or more (a thread's run of 4
# lies in one)
TILE = (16, 128)
MIN_CTB = 8

# per-eo-class neighbour offsets (a, b): (dx, dy)
_EO_DIRS = np.array([
    [[-1, 0], [1, 0]],    # 0: horizontal
    [[0, -1], [0, 1]],    # 1: vertical
    [[-1, -1], [1, 1]],   # 2: 135 diagonal
    [[1, -1], [-1, 1]],   # 3: 45 diagonal
], dtype=np.int32)

# edge_idx remap (sao_edge_filter): 2+sign(c-a)+sign(c-b) -> offset slot
_EDGE_MAP = np.array([1, 2, 0, 3, 4], dtype=np.int32)


def sao_rows(plane_ext, sao_type, band_pos, offv, eo_class, pic_w, pic_h,
             *, ctb: int, bit_depth: int, y0=0, halo: int = 0):
  """Row-band SAO core: filters rows [halo, Hs+halo) of plane_ext,
  whose first/last `halo` rows carry neighbour rows from the adjacent
  band.  `y0` is the global picture row of the band's first real row;
  sao_type / band_pos / eo_class / offv are the band's own CTB rows.
  Returns the filtered (Hs, Wp) real rows, a new tensor.  A CUDA tensor
  launches the kernel; a CPU tensor runs sao_rows_plain."""
  dev = plane_ext.device
  if dev.type == "cuda":
    return _sao_cuda([plane_ext], [(sao_type, band_pos, offv, eo_class)],
                     pic_w=pic_w, pic_h=pic_h, ctb=ctb, bit_depth=bit_depth,
                     y0=y0, halo=halo)[0]
  if dev.type != "cpu":
    raise ValueError(f"sao: unsupported device {dev}")
  return sao_rows_plain(plane_ext, sao_type, band_pos, offv, eo_class, pic_w,
                        pic_h, ctb=ctb, bit_depth=bit_depth, y0=y0, halo=halo)


def sao_rows_plain(plane_ext, sao_type, band_pos, offv, eo_class, pic_w,
                   pic_h, *, ctb: int, bit_depth: int, y0=0, halo: int = 0):
  """sao_rows's plain version, with its arguments and result."""
  PLAIN_RUNS["sao"] += 1
  return _sao_rows_torch(plane_ext, sao_type, band_pos, offv, eo_class,
                         pic_w, pic_h, ctb=ctb, bit_depth=bit_depth, y0=y0,
                         halo=halo)


def _sao_rows_torch(plane_ext, sao_type, band_pos, offv, eo_class, pic_w,
                    pic_h, *, ctb: int, bit_depth: int, y0=0, halo: int = 0):
  He, Wp = plane_ext.shape
  Hs = He - 2 * halo
  dev = plane_ext.device
  maxv = (1 << bit_depth) - 1
  y = torch.arange(Hs, device=dev)[:, None] + y0   # global picture row
  ye = torch.arange(Hs, device=dev)[:, None] + halo  # row in plane_ext
  x = torch.arange(Wp, device=dev)[None, :]
  plane = plane_ext[halo:He - halo if halo else He, :]
  cby = ((y - y0) // ctb).clamp(0, sao_type.shape[0] - 1)
  cbx = (x // ctb).clamp(0, sao_type.shape[1] - 1)
  t = sao_type[cby, cbx]          # (Hs, Wp)
  bpos = band_pos[cby, cbx]
  eo = eo_class[cby, cbx].long()
  offs = offv[cby, cbx]           # (Hs, Wp, 5)

  # band offset
  band = plane >> (bit_depth - 5)
  delta = (band - bpos) & 31
  band_off = torch.where(delta < 4, torch.gather(
      offs, -1, (delta + 1).clamp(0, 4).long()[..., None])[..., 0], 0)

  # edge offset
  dirs = on_device("sao_eo_dirs", dev, lambda: torch.from_numpy(_EO_DIRS))
  da = dirs[eo, 0]  # (Hs, Wp, 2)
  db = dirs[eo, 1]
  ax = (x + da[..., 0]).clamp(0, Wp - 1)
  ay = (ye + da[..., 1]).clamp(0, He - 1)
  bx = (x + db[..., 0]).clamp(0, Wp - 1)
  by = (ye + db[..., 1]).clamp(0, He - 1)
  a = plane_ext[ay, ax]
  b = plane_ext[by, bx]
  idx = 2 + torch.sign(plane - a) + torch.sign(plane - b)
  slot = on_device("sao_edge_map", dev,
                   lambda: torch.from_numpy(_EDGE_MAP))[idx.long()]
  edge_off = torch.gather(offs, -1, slot.long()[..., None])[..., 0]
  # neighbours must be inside the picture
  in_pic = ((x + da[..., 0] >= 0) & (x + da[..., 0] < pic_w)
            & (y + da[..., 1] >= 0) & (y + da[..., 1] < pic_h)
            & (x + db[..., 0] >= 0) & (x + db[..., 0] < pic_w)
            & (y + db[..., 1] >= 0) & (y + db[..., 1] < pic_h))
  edge_off = torch.where(in_pic, edge_off, 0)

  off = torch.where(t == 1, band_off, torch.where(t == 2, edge_off, 0))
  out = (plane + off).clamp(0, maxv)
  return torch.where((y < pic_h) & (x < pic_w), out, plane)


def sao_plane(plane, sao_type, band_pos, offv, eo_class, pic_w, pic_h, *,
              ctb: int, bit_depth: int):
  """plane: (Hp, Wp) int32 (padded; only the picture area is filtered).
  sao_type/band_pos/eo_class: (CBH, CBW) int32 per-CTB grids.
  offv: (CBH, CBW, 5) int32 offsets.  Returns the filtered plane, a new
  tensor (the kernel on a CUDA tensor, as sao_rows)."""
  return sao_rows(plane, sao_type, band_pos, offv, eo_class, pic_w, pic_h,
                  ctb=ctb, bit_depth=bit_depth, y0=0, halo=0)


def _grids(sao: dict, c: int):
  """Component c's grids of the frame's SAO tree, as views: type, band
  position, offsets, EO class."""
  return (sao["type"][..., c], sao["band"][..., c], sao["offv"][..., c, :],
          sao["eo"][..., c])


def sao_planes(planes, sao, comps, *, pic_w: int, pic_h: int, ctb: int,
               bit_depth: int, overlap: bool = False):
  """SAO of one frame's luma plane, or of its Cb and Cr planes together
  (the frame program's calls).

  planes: [luma] or [Cb, Cr], (Hp, Wp) int32 padded planes with unit
  column stride (views of one tensor, or separate ones).  sao: the
  frame's converted SAO tree (inputs.build_host_inputs "sao"): `type`,
  `band` and `eo` (CBH, CBW, 3) int32 and `offv` (CBH, CBW, 3, 5) int32,
  indexed by component.  comps: the planes' components, (0,) or (1, 2).
  pic_w, pic_h, ctb: the component's picture size and CTB size.
  overlap (Cb+Cr calls on the card): the caller queued the luma call
  just before this one on the current stream, and keeps that call's
  input plane referenced until this call is queued (the frame program's
  pair); the Cb+Cr launch may then start while the luma launch runs.
  Returns the filtered planes, (nch, Hp, Wp) int32, a new tensor: the
  picture filtered, the padding copied.  A CUDA tensor launches the
  kernel once; a CPU tensor runs sao_planes_plain."""
  if len(planes) != len(comps) or not 1 <= len(planes) <= 2:
    raise ValueError(f"sao: {len(planes)} planes for components {comps}")
  dev = planes[0].device
  if dev.type == "cuda":
    return _sao_cuda(planes, [_grids(sao, c) for c in comps], pic_w=pic_w,
                     pic_h=pic_h, ctb=ctb, bit_depth=bit_depth, y0=0, halo=0,
                     overlap=overlap and comps[0] != 0)
  if dev.type != "cpu":
    raise ValueError(f"sao: unsupported device {dev}")
  return sao_planes_plain(planes, sao, comps, pic_w=pic_w, pic_h=pic_h,
                          ctb=ctb, bit_depth=bit_depth)


def sao_planes_plain(planes, sao, comps, *, pic_w: int, pic_h: int, ctb: int,
                     bit_depth: int):
  """sao_planes's plain version, with its arguments and result: the
  whole-plane pass per plane, stacked."""
  PLAIN_RUNS["sao"] += 1
  return torch.stack([
      _sao_rows_torch(pl, *_grids(sao, c), pic_w, pic_h, ctb=ctb,
                      bit_depth=bit_depth) for pl, c in zip(planes, comps)])


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "sao.cu")
_lib = None


def _get_kernel():
  global _lib
  if _lib is None:
    from ..utils.build import build_cuda

    lib = ctypes.CDLL(build_cuda("sao", [_SRC]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sao_launch.restype = ctypes.c_int
    lib.sao_launch.argtypes = [
        p, p, p, i,         # src pointers (nch,), their row strides, dst, nch
        i, i, i, i,         # He, Wp, halo, y0
        i, i, i, i,         # pic_w, pic_h, ctb, bit_depth
        p, p, p, p,         # type pointers (nch,), strides; band, strides
        p, p, p, p,         # eo pointers, strides; offv pointers, strides
        i, i, i, p]         # cbh, cbw, flags, stream
    lib.sao_plan.restype = ctypes.c_int
    lib.sao_plan.argtypes = [i, i, i, p]  # nch, Hs, Wp, out (6,)
    lib.sao_error_string.restype = ctypes.c_char_p
    lib.sao_error_string.argtypes = [ctypes.c_int]
    _lib = lib
  return _lib


# csrc/sao.cu's flags: the launch may overlap the launch before it
_F_OVERLAP = 1


def launch_plan(nch: int, Hs: int, Wp: int):
  """The kernel's launch for nch planes of Hs x Wp output samples on the
  current card: tiles, blocks (the persistent grid), resident blocks per
  SM, tiles per block (the most any block takes), static shared bytes,
  SMs and threads per block."""
  lib = _get_kernel()
  out = (ctypes.c_int * 6)()
  rc = lib.sao_plan(nch, Hs, Wp, out)
  if rc != 0:
    raise RuntimeError(f"sao plan failed: {lib.sao_error_string(rc).decode()}")
  tiles, blocks, per_sm, smem, sms, threads = out
  return {"tiles": tiles, "blocks": blocks, "blocks_per_sm": per_sm,
          "tiles_per_block": -(-tiles // blocks), "smem": smem, "sms": sms,
          "threads": threads, "tile": TILE}


def _sao_cuda(planes, grids, *, pic_w, pic_h, ctb, bit_depth, y0, halo,
              overlap=False):
  """One launch on the planes' device's current stream into a new
  (nch, He - 2 * halo, Wp) tensor.  grids: per plane (type, band
  position, offsets, EO class), int32 views read through their strides
  (the planes' grids share their strides and shape).  overlap: the
  launch may start while the luma launch queued just before it runs
  (csrc/sao.cu; sao_planes says when a caller may ask)."""
  if ctb < MIN_CTB or ctb & (ctb - 1):
    raise ValueError(f"sao: CTB of {ctb} samples; the kernel takes a "
                     f"power of 2 of at least {MIN_CTB}")
  dev = planes[0].device
  He, Wp = planes[0].shape
  for pl in planes:
    if pl.dtype != torch.int32 or pl.device != dev or pl.dim() != 2 \
        or tuple(pl.shape) != (He, Wp) or pl.stride(1) != 1:
      raise ValueError("sao: expected int32 planes of one shape on one "
                       f"device with unit column stride, got {pl.dtype} "
                       f"{tuple(pl.shape)} strides {pl.stride()} on "
                       f"{pl.device}")
  cbh, cbw = grids[0][0].shape
  for g in grids:
    for k, t in enumerate(g):
      shape = (cbh, cbw, 5) if k == 2 else (cbh, cbw)
      if t.dtype != torch.int32 or t.device != dev \
          or tuple(t.shape) != shape or t.stride() != grids[0][k].stride():
        raise ValueError(f"sao: grid {k} expected int32 {shape} on {dev} "
                         "with the first plane's strides, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()} "
                         f"on {t.device}")
  n = len(planes)
  ptrs = ctypes.c_longlong * n

  def grid(k):
    st = (list(grids[0][k].stride()) + [0])[:3]   # (sy, sx[, slot])
    return (ptrs(*(g[k].data_ptr() for g in grids)),
            (ctypes.c_longlong * 3)(*st))

  lib = _get_kernel()
  dst = torch.empty((n, He - 2 * halo, Wp), dtype=torch.int32, device=dev)
  with torch.cuda.device(dev):
    rc = lib.sao_launch(
        ptrs(*(pl.data_ptr() for pl in planes)),
        ptrs(*(pl.stride(0) for pl in planes)), dst.data_ptr(), n, He, Wp,
        halo, y0, pic_w, pic_h, ctb, bit_depth, *grid(0), *grid(1),
        *grid(3), *grid(2), cbh, cbw, _F_OVERLAP if overlap else 0,
        torch.cuda.current_stream(dev).cuda_stream)
  if rc != 0:
    raise RuntimeError("sao kernel launch failed: "
                       f"{lib.sao_error_string(rc).decode()}")
  LAUNCHES["sao"] += 1
  OVERLAPS["sao"] += bool(overlap)
  return dst
