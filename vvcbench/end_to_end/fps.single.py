"""Frames decoded over the window, all sessions together."""
from vvcbench.readers import rate as read  # noqa: F401
