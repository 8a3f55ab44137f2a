"""The port's leveled logging (ffmpeg_tpu_torch/utils/log.py): which of
the decoder session's three lines appear at each level (error: an
undecodable access unit dropped; warning: a missing reference
synthesized, under errors="contain"; debug: each decoded POC), each with
the "[name @ LEVEL]" prefix of the JAX package's logger, and the level
taken from FFMPEG_TPU_TORCH_LOGLEVEL at import.
"""
import io
import logging
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_decode import _missing_ref_stream  # noqa: E402
from test_torch_robustness import _junk_slice  # noqa: E402

from ffmpeg_tpu_torch.utils import log  # noqa: E402

torch.set_num_threads(2)

NAME = "ffmpeg_tpu_torch.vvc.decoder"
LINES = {"error": f"[{NAME} @ ERROR] dropping undecodable access unit",
         "warning": f"[{NAME} @ WARNING] poc ",
         "debug": f"[{NAME} @ DEBUG] decoded poc "}
# the lines each level shows
SHOWN = {"quiet": set(), "error": {"error"},
         "warning": {"error", "warning"}, "info": {"error", "warning"},
         "debug": set(LINES), "trace": set(LINES)}


@pytest.fixture
def stderr():
  """The port's stderr handler writing into a buffer for the test; the
  level back at warning after it."""
  handler = logging.getLogger("ffmpeg_tpu_torch").handlers[0]
  buf = io.StringIO()
  old = handler.setStream(buf)
  yield buf
  handler.setStream(old)
  log.set_level("warning")


@pytest.mark.parametrize("name", sorted(SHOWN))
def test_session_lines_by_level(stderr, name):
  """A session at each level decodes a stream whose reference was lost
  (the missing-ref case: a warning per missing reference, a debug line
  per frame) and a junk slice (an error line): exactly the lines of that
  level and above reach stderr."""
  from ffmpeg_tpu_torch.models.vvc.decoder import DecoderConfig, VVCDecoder

  log.set_level(name)
  cut, n_aus = _missing_ref_stream()
  dec = VVCDecoder(device="cpu", config=DecoderConfig(errors="contain"))
  assert len(list(dec.decode(cut))) == n_aus
  assert list(dec.decode(_junk_slice())) == []
  err = stderr.getvalue()
  shown = {k for k, line in LINES.items() if line in err}
  assert shown == SHOWN[name], err
  if "debug" in shown:
    assert err.count(LINES["debug"]) == n_aus


@pytest.mark.parametrize("env,want", [("debug", "DEBUG"), (None, "WARNING"),
                                      ("QUIET", "Level 60")])
def test_level_from_environment(env, want):
  """The level comes from FFMPEG_TPU_TORCH_LOGLEVEL (any case), warning
  when it is unset."""
  e = {k: v for k, v in os.environ.items() if k != log.ENV}
  if env is not None:
    e[log.ENV] = env
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  out = subprocess.run(
      [sys.executable, "-c", "import logging; from ffmpeg_tpu_torch.utils "
       "import log; print(logging.getLevelName(log.get_logger('x')"
       ".getEffectiveLevel()))"], cwd=root, env=e, capture_output=True,
      text=True, check=True).stdout.strip()
  assert out == want
