"""The mean inputs range (the frame's numpy inputs), ms."""
from vvcbench.readers import span_mean_ms


def read(rec):
  return span_mean_ms(rec, "inputs")
