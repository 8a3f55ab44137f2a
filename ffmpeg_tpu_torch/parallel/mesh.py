"""Device mesh for multi-device VVC decode.

Maps the reference's concurrency axes (SURVEY §2.5) onto an (F, T) grid
of torch devices, as the JAX package's mesh does:
  'frame' — frame/GOP-level parallelism (P1): a dependency wave's frames
            are dealt to the frame devices (parallel/gop.py);
  'tile'  — spatial split within a frame (P2/P5): CTB-row bands of the
            filter stages, one per tile device (parallel/spatial.py).

The JAX module's frame_sharding, tu_batch_sharding and plane_sharding
have no torch counterpart: a torch tensor lives on one device, so the
wave and band code place each frame and band on its device itself.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
  """An (F, T) array of torch devices with axes 'frame' and 'tile'."""

  def __init__(self, devices: np.ndarray) -> None:
    self.devices = devices
    self.shape = {"frame": devices.shape[0], "tile": devices.shape[1]}

  def axis_devices(self, axis: str) -> list:
    """The devices along `axis` (the first row or column of the grid)."""
    return list(self.devices[:, 0] if axis == "frame" else self.devices[0])


def make_mesh(n_devices: int | None = None, frame_axis: int | None = None,
              devices=None) -> Mesh:
  """The first n_devices of `devices` (default: every CUDA device; none
  raises) as an (F, T) mesh with F = frame_axis (default 2 when the
  count is even and above 1, else 1)."""
  if devices is None:
    if not torch.cuda.is_available():
      raise RuntimeError("make_mesh: no CUDA device (torch.cuda.is_available()"
                         " is false); pass devices=['cpu', ...] to run on "
                         "the CPU")
    devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
  devs = [torch.device(d) for d in devices][:n_devices or len(devices)]
  n = len(devs)
  if frame_axis is None:
    frame_axis = 2 if n % 2 == 0 and n > 1 else 1
  if frame_axis < 1 or n % frame_axis:
    raise ValueError(f"make_mesh: {n} devices do not split into "
                     f"{frame_axis} frame rows")
  grid = np.empty(n, dtype=object)
  grid[:] = devs
  return Mesh(grid.reshape(frame_axis, n // frame_axis))
