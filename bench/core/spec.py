"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``bench/workloads/<cell>.json``, the configuration and the
traffic mix the cell names, the configuration's family, and the metrics
``BENCHMARK.json`` gives the cell. Adding a cell, a configuration, a mix,
a metric or a family adds files and entries; no code here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# What a family module gives the harness; everything that depends on a
# configuration's layers goes through these.
FAMILY_FUNCTIONS = ("make_params", "compile_program", "logits",
                    "ops_per_frame", "least_seconds")


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
    family: types.ModuleType


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
    cfg = config(spec["config"], root)
    return Cell(name=name, config=cfg, traffic=mix, stages=stages,
                replicas=replicas,
                replica_mode=spec.get("replica_mode", "pipeline"),
                chips=next(int(w["chips"]) for w in bench["workloads"]
                           if w["name"] == name),
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)],
                family=family(cfg, root))


def _module(path: Path, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict, root: Path = ROOT) -> types.ModuleType:
    """The module ``bench/families/<family>.py`` of the configuration
    ``cfg``, whose ``family`` key names it (``chain`` where it has none).

    A family holds everything that depends on a configuration's layers:
    ``make_params(cfg, seed, device)`` (the float weights on the device),
    ``compile_program(cfg, params, calib, device)`` (the program under
    test), ``logits(cfg, params, calib, frames, *, bits)`` (the plain
    reference), ``ops_per_frame(cfg)`` and ``least_seconds(cfg, batch,
    peak_ops, peak_bytes)`` (the roofline counts). Adding a family adds
    its file, as adding a cell or a metric does. A missing file, or one
    that lacks a function, is refused here, before any device work."""
    name = cfg.get("family", "chain")
    if not name.isidentifier():
        raise ValueError(f"configuration {cfg.get('name')!r}: family "
                         f"{name!r} is not a module name")
    path = Path(root) / "bench" / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {cfg.get('name')!r} names "
                                f"family {name!r}, but {path} is not there")
    mod = _module(path, f"bench.families.{name}")
    missing = [f for f in FAMILY_FUNCTIONS
               if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"{path} lacks {', '.join(missing)}")
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    return _module(path, f"bench.metrics.{metric.replace('.', '__')}").read
