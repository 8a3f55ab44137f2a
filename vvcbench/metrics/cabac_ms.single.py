"""The mean cabac range (the native parse inside host_parse, on a parse
lane; the rest of host_parse is the Python gather of its arrays), ms."""
from vvcbench.readers import span_mean_ms


def read(rec):
  return span_mean_ms(rec, "cabac")
