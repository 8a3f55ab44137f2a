"""A cell of `BENCHMARK.json`, resolved from the files that its names
point to: `<config>.<mix>` is `configs/<config>.json` under traffic
`traffic/<mix>.json`, and each metric the cell reports is read by
`end_to_end/<name>.py` or `metrics/<name>.py`."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)


@dataclass
class Cell:
  name: str
  chips: int
  config_name: str
  config: dict      # configs/<config>.json
  traffic_name: str
  traffic: dict     # traffic/<mix>.json
  end_to_end: list  # BENCHMARK.json entries this cell reports
  per_layer: list
  root: str = ROOT  # the directory the files were found under


def load_benchmark(repo: str = REPO) -> dict:
  with open(os.path.join(repo, "BENCHMARK.json")) as f:
    return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
  return cell in metric.get("workloads", [cell])


def resolve(name: str, bench: dict, root: str = ROOT) -> Cell:
  """The cell `name` of `bench`; raises KeyError for a cell it does not
  list and FileNotFoundError for a configuration or mix without a
  file."""
  entry = next((w for w in bench["workloads"] if w["name"] == name), None)
  if entry is None:
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
  with open(os.path.join(root, "configs", entry["config"] + ".json")) as f:
    config = json.load(f)
  with open(os.path.join(root, "traffic", entry["traffic"] + ".json")) as f:
    traffic = json.load(f)
  return Cell(name=name, chips=int(entry["chips"]),
              config_name=entry["config"], config=config,
              traffic_name=entry["traffic"], traffic=traffic,
              end_to_end=[m for m in bench["end_to_end"]
                          if _reports(m, name)],
              per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
              root=root)


def reader(kind: str, metric: str, root: str = ROOT):
  """`read(record)` of `<kind>/<metric>.py` (kind: "end_to_end" or
  "metrics"), loaded from its file: metric names hold dots."""
  path = os.path.join(root, kind, metric + ".py")
  spec = importlib.util.spec_from_file_location(
      f"vvcbench_{kind}_{metric.replace('.', '_')}", path)
  if spec is None or spec.loader is None:
    raise FileNotFoundError(path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read


def read_metrics(entries: list, kind: str, record: dict,
                 root: str = ROOT) -> dict:
  """{name: {"value", "unit"}} of every entry whose reader finds
  something to read in `record`; a reader that returns None leaves its
  metric out."""
  out = {}
  for m in entries:
    value = reader(kind, m["name"], root)(record)
    if value is not None:
      out[m["name"]] = {"value": value, "unit": m["unit"]}
  return out
