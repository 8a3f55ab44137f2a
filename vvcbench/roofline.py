"""The least time of the port's kernels on a frame, from the frame's
geometry and the configuration's tools alone, so that the share reads
the same work whatever implements it.

Each stage's kernel has to read its input planes once and write its
output planes once, at the stream's sample width (one byte a sample up
to 8 bits, two above); the least time is those bytes over the card's
memory bandwidth.  Per frame, in planes of all its components
(4:2:0: 1.5 x width x height samples):

  residual    coefficients in, residual out                    1 + 1
  inter       a reference in, the prediction out (inter)       1 + 1
  recon       residual (and prediction, inter) in, samples out 1 (+1) + 1
  lmcs_inv    luma in, luma out (LMCS on)                      luma 1 + 1
  deblock     samples in, samples out                          1 + 1
  sao         samples in, samples out (SAO on)                 1 + 1
  alf         samples in, samples out (ALF on)                 1 + 1
  cc-alf      the pre-ALF luma in (CC-ALF on)                  luma 1
  dmvr        not counted: its windows are a small fraction of a plane

Every count is a floor (a bi-predicted unit reads two references), so
the share can only read low, never above 100%.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet: HBM3 at 3.35 TB/s (at 700 W)
HBM_BYTES_PER_S = 3.35e12


def frame_bytes(gen: dict, intra: bool) -> int:
  """The bytes one frame's kernels must move at the least, for the
  generator's keyword arguments `gen`."""
  luma = gen["width"] * gen["height"]
  mono = gen.get("chroma_format_idc", 1) == 0
  whole = luma if mono else luma * 3 // 2
  planes = 2 + 2 + (0 if intra else 2) + (0 if intra else 1)
  total = planes * whole
  if gen.get("lmcs"):
    total += 2 * luma
  for tool in ("deblock", "sao", "alf"):
    if gen.get(tool):
      total += 2 * whole
  if gen.get("alf") and gen.get("ccalf") and not mono:
    total += luma
  return total * (1 if gen.get("bit_depth", 8) <= 8 else 2)


def is_intra(gen: dict, pos: int) -> bool:
  """Whether the frame at output position `pos` of a pass is intra: every
  frame of an all-intra stream, the first of an inter stream (one I
  frame a stream)."""
  return not gen.get("inter") or pos == 0


def least_seconds(gen: dict, positions) -> float:
  """The least time of the kernels over frames at `positions`."""
  return sum(frame_bytes(gen, is_intra(gen, p))
             for p in positions) / HBM_BYTES_PER_S
