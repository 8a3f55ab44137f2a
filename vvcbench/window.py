"""The measured window: decode sessions on threads of one process, each
decoding the pool's streams one after another, from its start in the
rotation, again and again.

Every session waits at one barrier; the window opens when they are let
go and each stops at the first frame yielded at or after the deadline,
which it does not count.  The window closes once every session has
stopped and the card has finished what they queued (`sync`), so the
rate is the frames counted over all the time their device work took.
The counted frames' buffers are kept, on the card, to be judged once
the window has closed."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class SessionRun:
  """One session's window: the frames it counted as (stream, position
  in its pass, packed buffer), each finished pass as (stream, frames it
  yielded), and the exception that stopped it, if one did."""
  frames: list = field(default_factory=list)
  passes: list = field(default_factory=list)
  error: BaseException | None = None


@dataclass
class Window:
  start: float
  end: float
  runs: list

  @property
  def seconds(self) -> float:
    return self.end - self.start

  @property
  def frames(self) -> int:
    return sum(len(r.frames) for r in self.runs)

  @property
  def rate(self) -> float:
    return self.frames / self.seconds


def _drive(dec, streams, first, run, state, barrier, clock):
  barrier.wait()
  deadline = state["deadline"]
  k = first
  try:
    while True:
      frames = dec.decode(streams[k], fetch=False)
      pos = 0
      for frame in frames:
        if clock() >= deadline:
          frames.close()
          return
        run.frames.append((k, pos, frame.buf))
        pos += 1
      run.passes.append((k, pos))
      k = (k + 1) % len(streams)
  except Exception as e:  # noqa: BLE001 - reported as a failed run
    run.error = e


def run_window(decoders, streams: list, first: int, seconds: float, sync,
               clock=time.perf_counter) -> Window:
  """Each decoder in `decoders` on its own thread for `seconds`, session
  i starting at stream (first + i) % len(streams); `sync()` waits for
  the card (torch.cuda.synchronize)."""
  runs = [SessionRun() for _ in decoders]
  state: dict = {}
  barrier = threading.Barrier(len(decoders) + 1)
  threads = [threading.Thread(
      target=_drive, args=(d, streams, (first + i) % len(streams), r, state,
                           barrier, clock))
             for i, (d, r) in enumerate(zip(decoders, runs))]
  for t in threads:
    t.start()
  start = clock()
  state["deadline"] = start + seconds
  barrier.wait()
  for t in threads:
    t.join()
  sync()
  return Window(start=start, end=clock(), runs=runs)


def warm_up(decoders, data: bytes, sync) -> None:
  """One whole pass of a stream through each session, the sessions side
  by side as in the window; raises the first session's error."""
  errors = []

  def one(dec):
    try:
      for _ in dec.decode(data, fetch=False):
        pass
    except Exception as e:  # noqa: BLE001 - raised below
      errors.append(e)

  threads = [threading.Thread(target=one, args=(d,)) for d in decoders]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  sync()
  if errors:
    raise errors[0]
