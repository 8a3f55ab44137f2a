"""Device ms of host-to-device copies per counted frame."""
from vvcbench.readers import device_ms_per_frame


def read(rec):
  return device_ms_per_frame(rec, "h2d_s")
