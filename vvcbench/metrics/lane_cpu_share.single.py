"""The parse lanes' thread CPU time over their wall time, %, summed over
the host_parse and inputs records of the port's trace store.  Under 100
where a lane waited: on the interpreter lock, on the collocated motion,
or for a core.

Only the lanes' work for the frames a session took in the window
counts: the records of the frames that have a parse_wait record (the
session's wait on the lane's result, which ends after both lane spans
and inside the window), on the threads that ran host_parse.  That
leaves out the parses a closed session left queued, which run on as the
window and the profiler stop, and a DMVR frame's inputs on the main
thread."""

LANE_SPANS = ("host_parse", "inputs")


def store_records():
  """The port's trace records, or None where the port keeps no store."""
  from ffmpeg_tpu_torch.utils import trace

  records = getattr(trace, "records", None)
  return records() if records is not None else None


def read(rec, records=None):
  if records is None:
    records = store_records()
  records = records or ()
  taken = {r["frame"] for r in records if r["name"] == "parse_wait"}
  taken.discard(None)
  lanes = {r["thread"] for r in records if r["name"] == "host_parse"}
  recs = [r for r in records if r["name"] in LANE_SPANS
          and r["thread"] in lanes and r["frame"] in taken]
  wall = sum(r["end_ns"] - r["start_ns"] for r in recs)
  if not wall:
    return None
  return sum(r["cpu_ns"] for r in recs) / wall * 100
