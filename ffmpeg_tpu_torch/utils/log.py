"""Leveled logging for the port (the av_log analog, libavutil/log.c).

One root logger `ffmpeg_tpu_torch` with per-component children
(`get_logger("vvc.decoder")` etc.), which write to stderr as
"[name @ LEVEL] message".  The level comes from the
FFMPEG_TPU_TORCH_LOGLEVEL environment variable (quiet|panic|fatal|error|
warning|info|verbose|debug|trace: the reference's -loglevel names;
warning when unset) or from set_level().
"""
from __future__ import annotations

import logging
import os
import sys

LEVELS = {
    "quiet": logging.CRITICAL + 10,
    "panic": logging.CRITICAL,
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "verbose": logging.INFO - 5,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG - 5,
}

ENV = "FFMPEG_TPU_TORCH_LOGLEVEL"

_root = logging.getLogger("ffmpeg_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(name)s @ %(levelname)s] %(message)s"))
    _root.addHandler(_h)
    _root.propagate = False
    _root.setLevel(LEVELS.get(os.environ.get(ENV, "warning").lower(),
                              logging.WARNING))


def set_level(level: str) -> None:
    _root.setLevel(LEVELS[level.lower()])


def get_logger(name: str) -> logging.Logger:
    return _root.getChild(name)
