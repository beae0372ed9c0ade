"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``bench/workloads/<cell>.json``, the configuration and the
traffic mix the cell names, and the metrics ``BENCHMARK.json`` gives the
cell. Adding a cell, a configuration, a mix or a metric adds files and
entries; no code here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def config(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "bench" / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "bench" / "traffic" / "mixes" / f"{name}.json")


def applies(metric: dict, cell: str) -> bool:
    """Whether ``BENCHMARK.json``'s ``metric`` is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    stages: int
    replicas: int
    replica_mode: str
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name``: its file, its configuration and mix, and the
    metrics ``BENCHMARK.json`` has it report."""
    spec = _json(Path(root) / "bench" / "workloads" / f"{name}.json")
    bench = benchmark(root)
    mix = traffic(spec["traffic"], root)
    stages, replicas = int(spec.get("stages", 1)), int(spec.get("replicas",
                                                                1))
    if stages < 1 or replicas < 1:
        raise ValueError(f"{name}: stages {stages}, replicas {replicas}")
    if mix["entry"] == "engine" and (stages, replicas) != (1, 1):
        raise ValueError(f"{name}: the single EngineExecutor has one stage "
                         f"and one replica")
    return Cell(name=name, config=config(spec["config"], root),
                traffic=mix, stages=stages, replicas=replicas,
                replica_mode=spec.get("replica_mode", "pipeline"),
                chips=next(int(w["chips"]) for w in bench["workloads"]
                           if w["name"] == name),
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
