"""The mean submit range (the session's main thread queuing a frame:
its inputs' copies, the kernels' launches, the pack), ms."""
from vvcbench.readers import span_mean_ms


def read(rec):
  return span_mean_ms(rec, "submit")
