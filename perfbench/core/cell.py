"""Finding a cell's parts by name: BENCHMARK.json at the root of the
checkout names the cell's configuration and traffic; the configuration's
file and its scene generator (`scenes/<scene>.py`), the traffic file
(`traffic/<traffic>.json`), its driver (`drivers/<driver>.py`), each
metric's reader (`metrics/<metric>.py`) and the cell's limits
(`limits/<cell>.json`) are found from those names alone."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str):
    """A module loaded from its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    chips: int
    end_to_end: list      # BENCHMARK.json metric entries that apply to the cell
    per_layer: list
    limits: dict          # compared number -> limit
    base: str             # the benchmark folder

    def scene(self) -> dict:
        """The configuration's scene, generated by its frozen generator."""
        gen = load_module(os.path.join(self.base, "scenes", f"{self.config['scene']}.py"),
                          f"perfbench.scenes.{self.config['scene']}")
        return gen.build(self.config)

    def driver(self):
        return load_module(os.path.join(self.base, "drivers", f"{self.traffic['driver']}.py"),
                           f"perfbench.drivers.{self.traffic['driver']}")

    def reader(self, metric: str):
        return load_module(os.path.join(self.base, "metrics", f"{metric}.py"),
                           f"perfbench_metric_{metric.replace('.', '_')}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, base: str = HERE, overrides: dict | None = None) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json; `overrides` ({"config": {...},
    "traffic": {...}}) replace keys, for tests at small sizes."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(base, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    limits = {}
    limits_path = os.path.join(base, "limits", f"{name}.json")
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = {k: v["limit"] for k, v in json.load(f)["limits"].items()}
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                limits=limits, base=base)
