"""The mean host_parse range (native CABAC parse, on a parse lane), ms."""
from vvcbench.readers import span_mean_ms


def read(rec):
  return span_mean_ms(rec, "host_parse")
