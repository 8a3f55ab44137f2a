"""The comparison's numbers on made-up frames: each counted frame's MD5
against its stream's truth at its position, each stream's sha256, and
the frames a finished pass yielded."""
from vvcbench import compare, window

TRUTHS = [{"sha256": "a" * 64, "md5": [compare.md5(b"a0"), compare.md5(b"a1")]},
          {"sha256": "b" * 64, "md5": [compare.md5(b"b0"), compare.md5(b"b1"),
                                       compare.md5(b"b2")]}]


def _collected(frames, passes, error=None):
  run = window.SessionRun(frames=frames, passes=passes, error=error)
  return compare.collect([run], lambda buf: buf)


def test_a_sound_window_reads_zero_on_every_number():
  got = _collected([(0, 0, b"a0"), (0, 1, b"a1"), (1, 0, b"b0"),
                    (1, 1, b"b1"), (1, 2, b"b2"), (0, 0, b"a0")],
                   [(0, 2), (1, 3)])
  n = compare.compare(got, TRUTHS, ["a" * 64, "b" * 64])
  assert n == {"stream_differs": 0, "mismatched_frames": 0,
               "missing_frames": 0, "session_errors": 0,
               "compared_frames": 6}
  assert compare.verdict(n)


def test_each_fault_reads_on_its_number():
  # a frame of the second stream judged against its own truth, not the
  # first's; a pass one frame short; a stream not the truth's; a
  # position past the stream's end
  got = _collected([(0, 0, b"a0"), (1, 1, b"a1"), (1, 3, b"b2")],
                   [(0, 1), (1, 3)], error=RuntimeError("x"))
  n = compare.compare(got, TRUTHS, ["a" * 64, "c" * 64])
  assert n == {"stream_differs": 1, "mismatched_frames": 2,
               "missing_frames": 1, "session_errors": 1,
               "compared_frames": 3}
  assert not compare.verdict(n)
  report = compare.limits_report(n)
  assert list(report)[-1] == "compared_frames"
  assert all(report[k]["limit"] == 0 for k in compare.LIMITS)


def test_nothing_compared_is_not_correct():
  n = compare.compare(_collected([], []), TRUTHS, ["a" * 64, "b" * 64])
  assert n["compared_frames"] == 0 and not compare.verdict(n)
