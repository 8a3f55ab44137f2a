"""The mean parse_wait range (the session's main thread waiting on a
parse lane's frame), ms."""
from vvcbench.readers import span_mean_ms


def read(rec):
  return span_mean_ms(rec, "parse_wait")
