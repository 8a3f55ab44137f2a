"""The MC tile format: the prediction samples of an MC batch.

`ops.inter.inter_pred` writes them and `ops.recon.recon_plane` reads
them (the pure inter units' placement and the CIIP blend).  A plane
kind's tiles are one (nch, T) int16 tensor: unit u's w x h samples are
stored row-major at [toff[u], toff[u] + w * h) of each channel row
(Cr is row 1 of the chroma tiles).  `toff` is (n_mc + 1,) int32, the
prefix sum of w * h over the MC batch's rows in row order (pure inter
units, then CIIP units), built on the host by `inputs._layout_ctrl`;
T = toff[-1].  int16 is exact: every prediction is clipped to [0, 2^bd
- 1] with bd <= 12.

`pack` and `unpack` convert from and to S x S tiles with zeros outside
each unit (S = MC_TILE), the layout of the plain versions' batched
arithmetic and of the tests' JAX references; the card's main path does
not use them.
"""
from __future__ import annotations

import numpy as np
import torch

# every MC unit is at most MC_TILE x MC_TILE (inputs.check_supported
# refuses larger ones); the edge of the plain versions' padded tiles
MC_TILE = 32

DTYPE = torch.int16


def offsets(w, h) -> np.ndarray:
  """toff of an MC batch from its (n_mc,) widths and heights."""
  toff = np.zeros(len(w) + 1, np.int64)
  np.cumsum(np.asarray(w, np.int64) * np.asarray(h, np.int64), out=toff[1:])
  return toff.astype(np.int32)


def nbytes(toff, nch: int) -> int:
  """Bytes of a plane kind's tiles: nch channels of T int16 samples."""
  return 2 * nch * int(toff[-1])


def _samples(toff, w, h):
  """(unit, row, column) of every stored sample, in storage order."""
  dev = w.device
  sizes = (w.long() * h.long())
  T = int(toff[-1])
  unit = torch.repeat_interleave(torch.arange(w.numel(), device=dev), sizes,
                                 output_size=T)
  k = torch.arange(T, device=dev) - toff[:-1].long()[unit]
  wu = w.long()[unit]
  y = torch.div(k, wu, rounding_mode="floor")
  return unit, y, k - y * wu


def pack(padded, toff, w, h):
  """(n_mc, *C, S, S) tiles -> (*C, T) int16: each unit's w x h corner."""
  unit, y, x = _samples(toff, w, h)
  return padded.movedim(0, -3)[..., unit, y, x].to(DTYPE).contiguous()


def unpack(tiles, toff, w, h, S: int = MC_TILE):
  """(*C, T) tiles -> (n_mc, *C, S, S) int32, zeros outside each unit."""
  unit, y, x = _samples(toff, w, h)
  out = torch.zeros((*tiles.shape[:-1], w.numel(), S, S), dtype=torch.int32,
                    device=tiles.device)
  out[..., unit, y, x] = tiles.to(torch.int32)
  return out.movedim(-3, 0).contiguous()
