"""Finding a cell's files by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``perfbench/`` the configuration, the traffic mix,
the cell's limits and the per-layer metric readers."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple   # the end-to-end metric entries this cell reports
    per_layer: tuple    # the per-layer metric entries this cell reports


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"missing {path}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(ROOT / configs[w["config"]]["file"])
    traffic = _load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(HERE / "workloads" / f"{name}.json")["limits"]
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    per_layer = tuple(m for m in bench["per_layer"] if _reports(m, name))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def load_reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py`` (loaded by path:
    a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(kind: str):
    """``drivers/<kind>.py`` (the traffic mix's ``kind``)."""
    return importlib.import_module(f"perfbench.drivers.{kind}")
