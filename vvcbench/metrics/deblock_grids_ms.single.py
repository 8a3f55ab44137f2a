"""The mean deblock_grids range (the frame's deblock edge grids, inside
inputs: one native pass, or the numpy fallback for a frame without a
native handle), ms."""
from vvcbench.readers import span_mean_ms


def read(rec):
  return span_mean_ms(rec, "deblock_grids")
