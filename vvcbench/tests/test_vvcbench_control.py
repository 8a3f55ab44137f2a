"""The control comes out not correct: the frozen plain path one
precision below what the configuration states (residual planes in
int8), judged as the window's frames are, on each configuration's
toolset at a size the CPU holds; the same path at full precision comes
out correct.  At the cells' own sizes it runs on the card against the
JAX package's MD5s: `python -m vvcbench.control --config <config>`."""
import json
import os

import pytest

from vvcbench import cells, control, reference, truth


@pytest.mark.parametrize("config,n_frames", [("ra1080_full", 5),
                                              ("ai720", 3)])
def test_control_fails_the_comparison(config, n_frames, tmp_path,
                                      write_truth):
  with open(os.path.join(cells.ROOT, "configs", config + ".json")) as f:
    cfg = json.load(f)
  small = dict(cfg, generator=dict(cfg["generator"], width=256, height=128,
                                   n_frames=n_frames))
  write_truth(tmp_path, "small", small, [5, 2**31 + 77])
  for want in truth.pool("small", str(tmp_path)):
    out = control.judge("small", small, want, "cpu",
                        cache=str(tmp_path / ".cache"))
    assert out["correct"] is False and out["mismatched_frames"] > 0
    assert out["stream_differs"] == 0
    # and the plain path judged the same way passes
    out = control.judge("small", small, want, "cpu", call=reference.plain,
                        cache=str(tmp_path / ".cache"))
    assert out["correct"] is True and out["compared_frames"] == n_frames
