"""The mean out_wait range (the session's main thread waiting on a
frame's error word before it hands the frame out), ms."""
from vvcbench.readers import span_mean_ms


def read(rec):
  return span_mean_ms(rec, "out_wait")
