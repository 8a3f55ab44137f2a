"""Seconds from the process's start to the window's, less stream generation."""


def read(rec):
  return rec["setup_s"]
