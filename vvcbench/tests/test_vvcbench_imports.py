"""No module the benchmark runs imports JAX or the JAX package, and the
reference and the frozen copy import nothing of the port.  Top-level
module names are compared whole: `ffmpeg_tpu_torch` begins with
`ffmpeg_tpu` and is the port."""
import ast
import os
import subprocess
import sys

import pytest

from vvcbench import cells, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "ffmpeg_tpu"}


# writes the committed truth with the JAX package on the CPU; nothing the
# benchmark runs imports or runs it
TRUTH_MAKER = os.path.join(cells.ROOT, "truth", "make.py")


def _sources(*parts):
  base = os.path.join(cells.ROOT, *parts)
  for d, dirs, files in os.walk(base):
    dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__",
                                            "_build", ".cache")]
    for f in files:
      if f.endswith(".py") and os.path.join(d, f) != TRUTH_MAKER:
        yield os.path.join(d, f)


def _top_level_imports(path):
  with open(path) as f:
    tree = ast.parse(f.read())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        yield a.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, cells.ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
  assert not FORBIDDEN & set(_top_level_imports(path))


def test_nothing_the_benchmark_runs_imports_the_truth_maker():
  assert FORBIDDEN & set(_top_level_imports(TRUTH_MAKER))
  for path in _sources():
    with open(path) as f:
      tree = ast.parse(f.read())
    for node in ast.walk(tree):
      if isinstance(node, ast.ImportFrom):
        names = {f"{node.module}.{a.name}" for a in node.names}
        assert not any(n.endswith("truth.make") for n in names), path
      elif isinstance(node, ast.Import):
        assert not any(a.name.endswith("truth.make") for a in node.names)


@pytest.mark.parametrize("path", sorted(_sources("frozen")) + [
    os.path.join(cells.ROOT, "reference.py"),
    os.path.join(cells.ROOT, "control.py")],
    ids=lambda p: os.path.relpath(p, cells.ROOT))
def test_reference_imports_nothing_of_the_port(path):
  assert "ffmpeg_tpu_torch" not in set(_top_level_imports(path))


def test_a_run_loads_no_forbidden_module():
  """What a run imports, the port's session and trace among it, loads
  none of FORBIDDEN by itself (harness.forbidden_modules, which the run
  checks again once its window has closed)."""
  code = ("import sys; sys.path.insert(0, %r)\n"
          "import vvcbench.harness, vvcbench.reference, vvcbench.control\n"
          "import vvcbench.truth, vvcbench.streams\n"
          "import vvcbench.frozen.encoder, vvcbench.frozen.models.vvc.decoder\n"
          "import ffmpeg_tpu_torch.models.vvc.decoder\n"
          "import ffmpeg_tpu_torch.utils.trace, torch.profiler\n"
          "print(vvcbench.harness.forbidden_modules())\n" % cells.REPO)
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=cells.REPO,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
  monkeypatch.setitem(sys.modules, "ffmpeg_tpu_torch_fake", sys)
  assert harness.forbidden_modules() == []
  monkeypatch.setitem(sys.modules, "ffmpeg_tpu.fake", sys)
  monkeypatch.setitem(sys.modules, "jaxlib", sys)
  assert harness.forbidden_modules() == ["ffmpeg_tpu", "jaxlib"]
