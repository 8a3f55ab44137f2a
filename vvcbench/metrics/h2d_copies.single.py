"""Host-to-device tensor copies a frame: the mean `copies` attribute of
the h2d records in the port's trace store, which holds the spans of the
traced window (its base: the h2d records that carry it)."""


def store_records():
  """The port's trace records, or None where the port keeps no store."""
  from ffmpeg_tpu_torch.utils import trace

  records = getattr(trace, "records", None)
  return records() if records is not None else None


def read(rec, records=None):
  if records is None:
    records = store_records()
  copies = [r["attrs"]["copies"] for r in records or ()
            if r["name"] == "h2d" and "copies" in r["attrs"]]
  if not copies:
    return None
  return sum(copies) / len(copies)
