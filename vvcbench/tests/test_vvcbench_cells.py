"""BENCHMARK.json against its required shape, each cell resolved from
its files, and a configuration, a mix and a metric added as new files
only."""
import json
import os
import re
import shutil

import pytest

from vvcbench import cells, truth

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.load_benchmark()


def test_top_level_keys():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert BENCH["paths"] == ["vvcbench"]
  assert BENCH["command"] == ["python3", "vvcbench/run.py"]
  assert 1 <= BENCH["run_seconds"] <= 51
  assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_fits_its_budget():
  # 2 + 14 runs a cell at 24 cells, each run_seconds + 60 s, 2 x 90 s of
  # compile a cell and 1200 s spare, within 43200 s
  runs = 2 + 14 * 24
  assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
  seen = set()
  for group, keys in (("configs", {"name", "source", "file", "reduced",
                                   "why"}),
                      ("workloads", {"name", "config", "traffic", "chips",
                                     "why"})):
    for e in BENCH[group]:
      assert set(e) == keys, e
      assert NAME.match(e["name"]) and e["name"] not in seen
      seen.add(e["name"])
      assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
  for e in BENCH["end_to_end"]:
    assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                       "source"}
    assert 0.01 <= e["bound"] <= 0.25
    assert e["source"] in ("host_clock", "device_trace")
  for e in BENCH["per_layer"]:
    assert set(e) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert e["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
  for e in BENCH["end_to_end"] + BENCH["per_layer"]:
    assert NAME.match(e["name"]) and e["name"] not in seen
    seen.add(e["name"])
    assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
  assert any(e["name"] == "setup_s" and e["bound"] <= 0.25
             for e in BENCH["end_to_end"])


def test_every_cell_reports_what_it_must():
  e2e = {m["name"]: m for m in BENCH["end_to_end"]}
  for w in BENCH["workloads"]:
    cell = cells.resolve(w["name"], BENCH)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
      # the metric it should move is reported in every cell it lists
      assert cells._reports(e2e[m["moves"]], w["name"])
  for c in BENCH["configs"]:
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert os.path.exists(os.path.join(cells.REPO, c["file"]))
    with open(os.path.join(cells.REPO, c["file"])) as f:
      assert json.load(f)["reduced"] == c["reduced"]


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_from_its_files(w):
  cell = cells.resolve(w, BENCH)
  entry = next(e for e in BENCH["workloads"] if e["name"] == w)
  assert w == f"{cell.config_name}.{cell.traffic_name}"
  assert cell.config_name == entry["config"] and cell.chips == 1
  gen = cell.config["generator"]
  assert gen["width"] > 0 and gen["height"] > 0 and gen["n_frames"] > 1
  assert truth.pool(cell.config_name)
  assert cell.traffic["sessions"] >= 1 and cell.traffic["host_threads"] >= 1
  for m in cell.end_to_end:
    assert callable(cells.reader("end_to_end", m["name"]))
  for m in cell.per_layer:
    assert callable(cells.reader("metrics", m["name"]))


@pytest.mark.parametrize("config", sorted(
    f[:-5] for f in os.listdir(os.path.join(cells.ROOT, "configs"))))
def test_every_configuration_has_its_truth(config):
  """Each configuration file, in a cell or kept for one, has a pool of at
  least 3 streams whose truth was made from its generator arguments."""
  with open(os.path.join(cells.ROOT, "configs", config + ".json")) as f:
    gen = json.load(f)["generator"]
  entries = truth.pool(config)
  assert len(entries) >= 3
  for e in entries:
    assert e["generator"] == dict(gen, seed=e["seed"])
    assert len(e["md5"]) == gen["n_frames"] and len(e["sha256"]) == 64


def test_unknown_cell_raises():
  with pytest.raises(KeyError):
    cells.resolve("nope.single", BENCH)


def test_config_mix_and_metric_added_as_new_files(tmp_path):
  """A later change adds a configuration, a mix, a cell and a per-layer
  metric by new files and new entries alone."""
  root = tmp_path / "vvcbench"
  shutil.copytree(cells.ROOT, root, ignore=shutil.ignore_patterns(
      "frozen", ".cache", "__pycache__", "tests"))
  before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
  (root / "configs" / "ra4k.json").write_text(json.dumps({
      "source": "x", "generator": {"width": 3840, "height": 2160,
                                   "n_frames": 9, "seed": 1},
      "reduced": [], "assumed": []}))
  (root / "truth" / "ra4k").mkdir(parents=True)
  (root / "truth" / "ra4k" / "1.json").write_text(json.dumps(
      {"seed": 1, "bytes": 9, "sha256": "0" * 64, "md5": ["0" * 32] * 9,
       "generator": {"width": 3840, "height": 2160, "n_frames": 9,
                     "seed": 1}}))
  (root / "traffic" / "live.json").write_text(json.dumps(
      {"why": "x", "sessions": 1, "host_threads": 8}))
  (root / "metrics" / "frames_seen.live.py").write_text(
      "def read(rec):\n  return rec['frames']\n")
  bench = json.loads(json.dumps(BENCH))
  bench["workloads"].append({"name": "ra4k.live", "config": "ra4k",
                             "traffic": "live", "chips": 1, "why": "x"})
  bench["end_to_end"][0].setdefault("workloads", []).append("ra4k.live")
  bench["per_layer"].append({
      "name": "frames_seen.live", "unit": "frames", "better": "higher",
      "source": "program_counter", "layer": "session",
      "moves": bench["end_to_end"][0]["name"], "workloads": ["ra4k.live"]})
  cell = cells.resolve("ra4k.live", bench, str(root))
  assert cell.config["generator"]["width"] == 3840
  assert cell.traffic["sessions"] == 1
  assert [e["seed"] for e in truth.pool("ra4k", str(root))] == [1]
  assert [m["name"] for m in cell.per_layer] == ["frames_seen.live"]
  got = cells.read_metrics(cell.per_layer, "metrics", {"frames": 7},
                           str(root))
  assert got == {"frames_seen.live": {"value": 7, "unit": "frames"}}
  # no file that was there changed
  for p, data in before.items():
    assert p.read_bytes() == data


def test_reader_returning_none_leaves_the_metric_out(tmp_path):
  (tmp_path / "metrics").mkdir()
  (tmp_path / "metrics" / "nothing.single.py").write_text(
      "def read(rec):\n  return None\n")
  entries = [{"name": "nothing.single", "unit": "ms"}]
  assert cells.read_metrics(entries, "metrics", {}, str(tmp_path)) == {}
