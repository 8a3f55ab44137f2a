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

Every MC row is at most MC_TILE a side.  A CIIP unit above that (up to
64x64, on frames with 64-sample luma units) is split into its MC_TILE x
MC_TILE blocks, in row-major order, as consecutive rows of the batch
(`split_rows`); the unit's CIIP tile index (`ipos`) is its first row,
and its block (by, bx) is row ipos + by * nbx + bx with nbx = ceil(w /
MC_TILE).  Inter prediction is position-wise for such units (no BDOF,
PROF, DMVR, GPM or weights), so the blocks hold exactly the unit's
prediction.  `ciip_blocks` reassembles a unit's prediction from them.

`pack` and `unpack` convert from and to S x S tiles with zeros outside
each unit (S = MC_TILE), the layout of the plain versions' batched
arithmetic and of the tests' JAX references; the card's main path does
not use them.
"""
from __future__ import annotations

import numpy as np
import torch

# every MC row is at most MC_TILE x MC_TILE (split_rows); the edge of the
# plain versions' padded tiles
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


def n_blocks(w, h):
  """Rows of the MC batch that a unit of w x h takes (split_rows)."""
  return ((np.asarray(w) + MC_TILE - 1) // MC_TILE
          * ((np.asarray(h) + MC_TILE - 1) // MC_TILE))


def split_rows(rows: dict):
  """An MC batch's (n,) control rows, each unit above MC_TILE a side
  replaced by its MC_TILE blocks in row-major order (x0, y0, w and h
  moved to the block; every other row copied).  Returns (the new rows,
  (n,) int32 index of each unit's first row)."""
  w, h = rows["w"], rows["h"]
  nbx = (w + MC_TILE - 1) // MC_TILE
  cnt = n_blocks(w, h).astype(np.int64)
  first = np.zeros(len(w), np.int64)
  np.cumsum(cnt[:-1], out=first[1:])
  if not (cnt > 1).any():
    return rows, first.astype(np.int32)
  src = np.repeat(np.arange(len(w)), cnt)
  k = np.arange(len(src)) - first[src]
  bx, by = k % nbx[src], k // nbx[src]
  out = {key: np.ascontiguousarray(v[src]) for key, v in rows.items()}
  out["x0"] = (out["x0"] + MC_TILE * bx).astype(np.int32)
  out["y0"] = (out["y0"] + MC_TILE * by).astype(np.int32)
  out["w"] = np.minimum(MC_TILE, w[src] - MC_TILE * bx).astype(np.int32)
  out["h"] = np.minimum(MC_TILE, h[src] - MC_TILE * by).astype(np.int32)
  return out, first.astype(np.int32)


def ciip_blocks(blocks, first, w, maxs: int):
  """(N, maxs, maxs) MC prediction of N CIIP units from the unpacked
  (n_mc, MC_TILE, MC_TILE) blocks: unit i's first row first[i] and its
  width w[i] ((N,) tensors); values outside the unit are not defined
  beyond being read from in-range rows."""
  last = blocks.shape[0] - 1
  if maxs <= MC_TILE:
    return blocks[first.long().clamp(0, last), :maxs, :maxs]
  nbx = (w + MC_TILE - 1) // MC_TILE
  q = maxs // MC_TILE
  rows = [torch.cat([blocks[(first + by * nbx + bx).long().clamp(0, last)]
                     for bx in range(q)], dim=-1) for by in range(q)]
  return torch.cat(rows, dim=-2)
