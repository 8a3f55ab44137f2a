"""GOP-parallel decode: dependency waves over a device-resident DPB pool.

Port of the JAX package's parallel/gop.py (P1/P6/P8).  The reference
decodes frames concurrently in `nb_fcs` frame contexts, with
cross-frame progress listeners waking dependent CTU tasks
(vvcdec.c:932-975, vvc_refs.c:492-565).  Here frames are grouped into
dependency waves by their reference lists (plan_waves): every frame's
references decode in strictly earlier waves.  A wave's frames are dealt
to the mesh's 'frame' devices and run at once on up to `streams` CUDA
streams per device, each through the session's frame program and
kernels (pipeline.submit_frame).

Decoded planes go into the slots of a DPB pool allocated once per call.
The CUDA event recorded after a slot's write is what every later reader
of the slot waits on, and a slot's next writer waits on the events of
its readers: the progress/listener machinery becomes stream-ordered
work, with no device-wide synchronisation between waves.  The packed
outputs are fetched once, after the last wave is queued.

Frame-axis parallelism lives here; the spatial ('tile') split of the
filter stages lives in parallel/spatial.py.
"""
from __future__ import annotations

import contextlib
import hashlib
import time

import torch

POOL_SLOTS = 16  # DPB pool size (reference: VVC_MAX_DPB_SIZE)
MAX_STREAMS = 4  # default stream width of a frame device


def plan_waves(frames):
  """Group decode-order frames into dependency waves: every frame's
  references decode in strictly earlier waves (the static analog of
  the reference's per-CTU cross-frame progress waits)."""
  wave_of: dict[int, int] = {}
  waves: list[list[int]] = []
  for idx, fs in enumerate(frames):
    deps = [p for lx in (0, 1) for p in fs.ref_pocs[lx]]
    w = 0
    for p in deps:
      if p not in wave_of:
        raise RuntimeError(f"missing reference POC {p}")
      w = max(w, wave_of[p] + 1)
    wave_of[fs.poc] = w
    while len(waves) <= w:
      waves.append([])
    waves[w].append(idx)
  return waves


def _allocate_slots(frames, waves):
  """Greedy DPB-slot allocation: a slot stays live until the last
  wave that references its POC has decoded."""
  wave_of = {}
  for w, idxs in enumerate(waves):
    for i in idxs:
      wave_of[frames[i].poc] = w
  last_need = {fs.poc: wave_of[fs.poc] for fs in frames}
  for fs in frames:
    for lx in (0, 1):
      for p in fs.ref_pocs[lx]:
        last_need[p] = max(last_need[p], wave_of[fs.poc])

  slot_of: dict[int, int] = {}
  free = list(range(POOL_SLOTS))
  releases: list[list[int]] = [[] for _ in waves]
  for w, idxs in enumerate(waves):
    for i in idxs:
      poc = frames[i].poc
      if not free:
        raise RuntimeError("DPB pool exhausted (GOP too deep)")
      slot_of[poc] = free.pop(0)
      releases[last_need[poc]].append(slot_of[poc])
    # slots whose last referencing wave just decoded come back
    # (after this wave, so a wave never reuses a slot it reads)
    free.extend(releases[w])
  return slot_of


class _Lane:
  """One CUDA stream of a frame device.  On the CPU there is no stream:
  work runs in order as it is queued, and events are None."""

  def __init__(self, device: torch.device) -> None:
    self.stream = None
    if device.type == "cuda":
      self.stream = torch.cuda.Stream(device)
      # the pool's fill, queued on the device's current stream, first
      self.stream.wait_stream(torch.cuda.current_stream(device))

  def queue(self):
    """Context in which torch work is queued on this lane."""
    if self.stream is None:
      return contextlib.nullcontext()
    return torch.cuda.stream(self.stream)

  def wait(self, events) -> None:
    if self.stream is not None:
      for ev in events:
        if ev is not None:
          self.stream.wait_event(ev)

  def mark(self):
    """An event after the work queued on this lane so far."""
    if self.stream is None:
      return None
    ev = torch.cuda.Event()
    ev.record(self.stream)
    return ev


def _read_slot(planes, ready, device):
  """A slot's planes as `device` reads them: the pool's own views, or a
  copy from the frame device that holds the slot (the JAX path's
  cross-shard gather).  The copy runs on the holder's current stream,
  so that stream first waits on the slot's write."""
  src = planes[0].device
  if src == device:
    return planes
  if src.type == "cuda" and ready is not None:
    torch.cuda.current_stream(src).wait_event(ready)
  return [p.to(device, non_blocking=True) for p in planes]


def _parse_period(data: bytes, device):
  """The frames of a single-IRAP-period buffer, parsed in decode order
  by one HostDecoder on a session ColStore (as the JAX function does).
  Refuses several IRAP periods and DMVR frames."""
  from ..models.vvc.decoder import VVCDecoder
  from ..models.vvc.host import HostDecoder
  from ..models.vvc.inputs import has_dmvr

  dec = VVCDecoder(device=device, host_threads=1)
  aus = dec._split_aus(data)
  periods = {ep for _, ep, _ in aus}
  if len(periods) > 1:
    raise RuntimeError(
        "decode_gop_mesh decodes one IRAP period per call; this stream "
        f"holds {len(periods)} (one per IDR): decode one period per call, "
        "or the whole stream with VVCDecoder")
  hd = HostDecoder(dec._colstore)
  frames = []
  for _, ep, au in aus:
    fs = hd.decode_au(au, ep)
    if fs is None:
      continue
    if has_dmvr(fs):
      # checked before the next frame's parse, which may wait on this
      # frame's refined collocated motion
      raise RuntimeError(
          f"decode_gop_mesh: POC {fs.poc} has DMVR units, whose "
          "refinement needs the reference planes in decode order; decode "
          "the stream with VVCDecoder")
    frames.append(fs)
  return frames


def _prepare(data: bytes, mesh):
  """Host half: the period's frames and their numpy inputs."""
  from ..models.vvc.inputs import build_host_inputs

  frames = _parse_period(data, mesh.axis_devices("frame")[0])
  return frames, [build_host_inputs(fs) for fs in frames]


def _run_waves(frames, inputs, mesh, streams=None, call=None):
  """Device half: every wave queued on the frame devices' streams, then
  one fetch of all packed outputs.  Returns (poc, md5, packed ndarray)
  in POC order."""
  from ..models.vvc.decoder import _fetch_group
  from ..models.vvc.inputs import _padded_plane_shapes
  from ..models.vvc.pipeline import submit_frame

  if not frames:
    return []
  fdevs = mesh.axis_devices("frame")
  F = len(fdevs)
  waves = plan_waves(frames)
  slot_of = _allocate_slots(frames, waves)
  fs0 = frames[0]
  n_comp = 1 if fs0.chroma_format_idc == 0 else 3
  shapes = _padded_plane_shapes(fs0.width, fs0.height, fs0.ctb_log2)
  # the pool, split over the frame devices (slot s on device
  # s * F // n_slots, padded to a multiple of F) and filled with
  # mid-gray as the JAX pool is.  Slot POOL_SLOTS is read for reference
  # list entries that do not exist (so no frame reads the session's
  # shared zero planes, pipeline._ZEROS, whose fill is queued on the
  # stream that first asked for them); POOL_SLOTS + 1 is the JAX path's
  # scratch slot for the padding frames of a wave chunk, and stays
  # unwritten here, where a wave runs no padding frame.
  n_slots = -(-(POOL_SLOTS + 2) // F) * F
  per = n_slots // F
  mid = 1 << (fs0.bit_depth - 1)
  shards = [[torch.full((per,) + shapes[min(c, 1)], mid, dtype=torch.int32,
                        device=dev) for c in range(n_comp)] for dev in fdevs]

  def slot(s):
    return [plane[s % per] for plane in shards[s // per]]

  zeros = [_read_slot(slot(POOL_SLOTS), None, dev) for dev in fdevs]
  width = max(-(-len(w) // F) for w in waves)
  lanes = [[_Lane(dev) for _ in range(min(streams or MAX_STREAMS, width))]
           for dev in fdevs]
  ready: dict = {}    # slot -> event after its latest write
  readers: dict = {}  # slot -> events after the frames that read it since
  fetches = []
  for idxs in waves:
    for j, i in enumerate(idxs):
      f = j % F
      dev, lane = fdevs[f], lanes[f][(j // F) % len(lanes[f])]
      fs = frames[i]
      refs = {p for lx in (0, 1) for p in fs.ref_pocs[lx]}
      s = slot_of[fs.poc]
      with lane.queue():
        lane.wait(ready.get(slot_of[p]) for p in refs)
        view = {p: _read_slot(slot(slot_of[p]), ready.get(slot_of[p]), dev)
                for p in refs}
        packed, planes = submit_frame(inputs[i], fs, dev, view, call=call,
                                      missing=zeros[f])
        # the slot's earlier readers and writer finish before it changes
        lane.wait(readers.get(s, []) + [ready.get(s)])
        for dst, src in zip(slot(s), planes):
          dst.copy_(src, non_blocking=True)
        done = lane.mark()
      ready[s], readers[s] = done, []
      for p in refs:
        readers.setdefault(slot_of[p], []).append(done)
      fetches.append((fs.poc, packed))
  for f, dev in enumerate(fdevs):
    if dev.type == "cuda":
      for lane in lanes[f]:
        torch.cuda.current_stream(dev).wait_stream(lane.stream)
  host = _fetch_group([p for _, p in fetches])
  out = sorted(zip((poc for poc, _ in fetches), host), key=lambda t: t[0])
  return [(poc, hashlib.md5(buf.tobytes()).hexdigest(), buf)
          for poc, buf in out]


def decode_gop_mesh(data: bytes, mesh=None, streams=None, call=None):
  """Decode a single-IRAP-period annex-B buffer wave-parallel over
  `mesh`'s 'frame' devices (default: every CUDA device on the frame
  axis; no CUDA device raises), each running a wave's frames on up to
  `streams` CUDA streams (default: the wave's width on the device, at
  most MAX_STREAMS).  Returns the decoded frames in POC (display) order
  as (poc, md5, packed ndarray) tuples.  call: as in
  pipeline.frame_program, for every frame.

  Raises RuntimeError for a buffer of several IRAP periods, a missing
  reference POC, an exhausted pool, or a frame with DMVR units (the JAX
  function skips their refinement; decode such streams with
  VVCDecoder)."""
  from .mesh import make_mesh

  if mesh is None:
    mesh = make_mesh(frame_axis=torch.cuda.device_count())
  frames, inputs = _prepare(data, mesh)
  return _run_waves(frames, inputs, mesh, streams, call)


def measure_scaling(data: bytes, widths, reps: int = 2, mesh=None):
  """Frames/s against stream width for one GOP: decodes the same buffer
  at each width (the number of CUDA streams a frame device runs a wave's
  frames on), timing warm repetitions, and checks MD5 equality across
  widths.  Returns {width: {"fps", "efficiency", "wave_fps"},
  "md5_equal": bool}: fps over the whole call (parse, inputs, waves and
  the fetch), wave_fps over the waves and the fetch alone."""
  from .mesh import make_mesh

  if mesh is None:
    mesh = make_mesh(frame_axis=torch.cuda.device_count())
  out, md5s = {}, {}
  for width in widths:
    decode_gop_mesh(data, mesh, streams=width)  # warm (allocator, caches)
    t_host = t_waves = 0.0
    for _ in range(reps):
      t0 = time.perf_counter()
      frames, inputs = _prepare(data, mesh)
      t1 = time.perf_counter()
      gop = _run_waves(frames, inputs, mesh, streams=width)
      t_host += t1 - t0
      t_waves += time.perf_counter() - t1
    md5s[width] = [m for _, m, _ in gop]
    out[width] = {"fps": len(gop) * reps / (t_host + t_waves),
                  "wave_fps": len(gop) * reps / t_waves}
  base = min(out)
  for width in out:
    out[width]["efficiency"] = out[width]["fps"] / (
        out[base]["fps"] * width / base)
  ref = next(iter(md5s.values()))
  out["md5_equal"] = all(v == ref for v in md5s.values())
  return out
