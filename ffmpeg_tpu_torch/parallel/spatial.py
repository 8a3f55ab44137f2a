"""Spatial ('tile'-axis) split of the filter stages, with halo exchange.

Port of the JAX package's parallel/spatial.py.  The reference
parallelises the in-loop filters across CTUs with a stencil task graph
(P2: anti-diagonal wavefronts, vvc_thread.c:156-184).  Here each filter
stage is the port's whole-plane op run on CTB-row bands, band t on the
mesh's tile device t; the stencil dependency becomes halo rows copied
from the neighbouring band to the band's device (the JAX path's
ppermute).  The bands, their padding and their halos are the JAX
functions' own: deblock needs no halo, SAO one row, ALF one CTB row
(edge-replicated at the ring ends).
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from ..ops.alf import alf_planes
from ..ops.deblock import deblock_pass
from ..ops.sao import sao_rows


def _pad_rows(t, n, mode="constant"):
  """t with n more rows at the bottom: zeros, or copies of its last row
  (mode "replicate")."""
  if n == 0:
    return t
  if mode == "replicate":
    return torch.cat([t, t[-1:].expand((n,) + t.shape[1:])])
  return Fn.pad(t, (0, 0) * (t.dim() - 1) + (0, n))


def _bands(t, rows, devs):
  """The T bands of `rows` rows of t, band k on devs[k]."""
  return [t[k * rows:(k + 1) * rows].to(d) for k, d in enumerate(devs)]


def _gather(bands, device, n):
  """The bands back on `device`, stacked, cut to n rows."""
  return torch.cat([b.to(device) for b in bands])[:n]


def deblock_vertical_tiled(plane, bs, qp, maxp, maxq, hor_ctu_edge, *,
                           bit_depth: int, mesh, axis: str = "tile",
                           beta_off: int = 0, tc_off: int = 0,
                           chroma: bool = False):
  """Bit-exact deblock_pass over one plane's vertical edges, split into
  row bands over `axis`, each band through deblock_pass on its own
  device (the kernel on a card).  Vertical-edge filtering only reads and
  writes samples within each segment of 4 (luma) or 2 (chroma) rows, so
  the bands need NO halo.  The caller applies the horizontal pass by
  transposing, exactly like the whole-plane op.

  plane: (Hp, Wp) int32; bs/qp/maxp/maxq (and hor_ctu_edge, luma only;
  None for chroma): (S, E) with S = Hp // 4 (luma) or Hp // 2 (chroma).
  """
  devs = mesh.axis_devices(axis)
  T = len(devs)
  seg = 2 if chroma else 4
  Hp = plane.shape[0]
  S = bs.shape[0]
  # band height: a multiple of seg rows covering the plane across T
  rows_per = -(-Hp // (T * seg)) * seg
  segs_per = rows_per // seg
  pad = segs_per * T - S  # bs 0 = no filtering on padded segments
  pl = _bands(_pad_rows(plane, rows_per * T - Hp), rows_per, devs)
  grids = [_bands(_pad_rows(g, pad), segs_per, devs)
           for g in ((bs, qp, maxp, maxq) if chroma
                     else (bs, qp, maxp, maxq, hor_ctu_edge))]
  out = [deblock_pass([pl[k]], [tuple(gr[k] for gr in grids)],
                      chroma=chroma, horizontal=False, bit_depth=bit_depth,
                      beta_off=(beta_off,), tc_off=(tc_off,))[0]
         for k in range(T)]
  return _gather(out, plane.device, Hp)


def alf_luma_tiled(ly0, ctb_bank, ctb_flag, banks_coeff, banks_clipv,
                   *, ctb: int, bit_depth: int, mesh, axis: str = "tile"):
  """Bit-exact ALF luma (classify + 7x7 clipped filter), split into
  CTB-row bands over `axis` with a one-CTB-row halo, each extended band
  through alf_planes on its own device (the ALF kernel on a card).

  The ALF virtual boundary already confines most row taps to the CTU
  row, but classification windows and the first rows of a CTU still
  read a few rows across the boundary: a full CTB-row halo
  (edge-replicated at the ring ends, matching the global clamp) keeps
  y % ctb congruent and covers every tap.  Only the band's own rows of
  each result are kept.

  ly0: (H, W) int32 cropped luma; ctb_bank/ctb_flag: (nby, nbx) per-CTB
  filter-bank index / on flag; banks_coeff/banks_clipv: (B, 25, 12).
  """
  devs = mesh.axis_devices(axis)
  T = len(devs)
  H, W = ly0.shape
  rows_per = -(-H // (T * ctb)) * ctb
  cb_per = rows_per // ctb
  pl = _bands(_pad_rows(ly0, rows_per * T - H, "replicate"), rows_per, devs)
  pad = cb_per * T - ctb_bank.shape[0]
  bank = _bands(_pad_rows(ctb_bank, pad), cb_per, devs)
  flag = _bands(_pad_rows(ctb_flag, pad), cb_per, devs)  # padding: off
  # halo CTB rows take the band's first and last (their outputs are
  # discarded)
  rows = (torch.arange(cb_per + 2) - 1).clamp(0, cb_per - 1)
  out = []
  for k, dev in enumerate(devs):
    b = pl[k]
    # halo rows from the neighbours' devices; the ring ends replicate
    # their own first/last row (== the global row clamp)
    up = pl[k - 1][-ctb:].to(dev) if k else b[:1].expand(ctb, W)
    dn = pl[k + 1][:ctb].to(dev) if k < T - 1 else b[-1:].expand(ctb, W)
    ext = torch.cat([up, b, dn])
    # the extended band's ALF tree: per CTB the luma flag and bank
    grid = torch.zeros((cb_per + 2, ctb_bank.shape[1], 8), dtype=torch.int8,
                       device=dev)
    grid[..., 0] = flag[k][rows.to(dev)]
    grid[..., 1] = bank[k][rows.to(dev)]
    a = {"ctb": grid,
         "banks_coeff": banks_coeff.to(dev, torch.int16).contiguous(),
         "banks_clipv": banks_clipv.to(dev, torch.int16).contiguous()}
    filt = alf_planes([ext], a, chroma=False, W=W, H=ext.shape[0],
                      ctb_log2=ctb.bit_length() - 1, bit_depth=bit_depth)
    out.append(filt[0, ctb:ctb + rows_per])
  return _gather(out, ly0.device, H)


def sao_plane_tiled(plane, sao_type, band_pos, offv, eo_class,
                    pic_w, pic_h, *, ctb: int, bit_depth: int, mesh,
                    axis: str = "tile"):
  """Bit-exact sao_plane, computed as CTB-row bands over `axis` with a
  one-row halo from each neighbour: each band one sao_rows call (on a
  card, one launch of the SAO kernel in its band form).

  plane: (Hp, Wp) int32.  Returns the filtered (Hp, Wp) plane.
  """
  devs = mesh.axis_devices(axis)
  T = len(devs)
  Hp, Wp = plane.shape
  rows_per = -(-Hp // (T * ctb)) * ctb    # CTB-aligned band height
  cb_per = rows_per // ctb
  pl = _bands(_pad_rows(plane, rows_per * T - Hp), rows_per, devs)
  pad = cb_per * T - sao_type.shape[0]     # type 0 = SAO off (padding)
  grids = [_bands(_pad_rows(g, pad), cb_per, devs)
           for g in (sao_type, band_pos, offv, eo_class)]
  out = []
  for k, dev in enumerate(devs):
    # halo exchange: the previous band's last row on top, the next
    # band's first row below; the ring ends take zeros, which the
    # in-picture mask inside sao_rows ignores
    zero = torch.zeros((1, Wp), dtype=plane.dtype, device=dev)
    up = pl[k - 1][-1:].to(dev) if k else zero
    dn = pl[k + 1][:1].to(dev) if k < T - 1 else zero
    ext = torch.cat([up, pl[k], dn])
    st, bp, ov, eo = (g[k] for g in grids)
    out.append(sao_rows(ext, st, bp, ov, eo, pic_w, pic_h, ctb=ctb,
                        bit_depth=bit_depth, y0=k * rows_per, halo=1))
  return _gather(out, plane.device, Hp)
