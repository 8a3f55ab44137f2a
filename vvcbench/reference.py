"""A second decoder beside the JAX package's (whose MD5s, truth.py, decide
`correct`): the frozen copy of the port's plain path.  It serves the
control (control.py) and checks the truth as a witness.

Every access unit in decode order on one thread: the frozen native
parser (`frozen/native/decode.cc`), the numpy inputs, and the frame
program with each kernel call run by its plain PyTorch version
(`frozen/ops`), DMVR frames refined first, as the port's
`pipeline.walk_frames` does.  It imports nothing of `ffmpeg_tpu_torch`
and takes nothing the port made: it parses the stream's bytes itself.

`control` is the reference computed one precision below what the
configuration states: each residual plane held in int8 (saturating),
where the specification bounds residuals by 16 bits.  Its frames must
fail the comparison (`tests/test_vvcbench_control.py`, and
`python -m vvcbench.control` on the card).
"""
from __future__ import annotations

import torch

from .frozen.models.vvc.decoder import VVCDecoder
from .frozen.models.vvc.host import ColStore, HostDecoder
from .frozen.models.vvc.inputs import build_host_inputs, has_dmvr
from .frozen.models.vvc.pipeline import KERNELS, refine_dmvr, submit_frame
from .frozen.ops.transform import raise_on_error

_IDR = (7, 8)


def plain(name, label, kw):
  """The frame program's call hook: each kernel call by its plain
  version."""
  return KERNELS[name][1](**kw)


def control(name, label, kw):
  """plain, with each residual plane saturated to int8."""
  out = KERNELS[name][1](**kw)
  return out.clamp(-128, 127) if name == "residual" else out


def split_aus(data: bytes) -> list:
  """The stream's access units as the session splits them: [(nal type,
  epoch, self-contained bytes)]."""
  dec = VVCDecoder(device="cpu", host_threads=1)
  try:
    return dec._split_aus(data)
  finally:
    dec._exec.shutdown()


def as_bytes(packed: torch.Tensor) -> bytes:
  """A packed frame (uint8, or int16 holding uint16 samples) as its
  planar bytes on the host."""
  return packed.cpu().numpy().tobytes()


def decode(data: bytes, device="cpu", call=plain) -> list:
  """The stream's frames in output order, each the planar YCbCr bytes
  of the cropped frame."""
  device = torch.device(device)
  colstore = ColStore()
  host, dpb, frames = HostDecoder(colstore), {}, []
  for nal_type, epoch, au in split_aus(data):
    fs = host.decode_au(au, epoch)
    if fs is None:
      continue
    if nal_type in _IDR:
      dpb = {}
    if has_dmvr(fs):
      refine_dmvr(fs, colstore, epoch, dpb, device, call=call)
    packed, dpb[fs.poc], err = submit_frame(build_host_inputs(fs), fs,
                                            device, dpb, call=call)
    raise_on_error(int(err.item()), f" (POC {fs.poc})")
    frames.append(((epoch, fs.poc), as_bytes(packed)))
  frames.sort(key=lambda f: f[0])
  return [f for _, f in frames]
