"""Device ms of the port's hand-written kernels per counted frame."""
from vvcbench.readers import device_ms_per_frame


def read(rec):
  return device_ms_per_frame(rec, "kernel_s")
