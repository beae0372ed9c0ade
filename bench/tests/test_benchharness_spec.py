"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import json
import re

import pytest

from bench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_names_existing_config_traffic_and_metrics(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = spec.cell(cell)
    own = json.loads((spec.ROOT / "bench" / "workloads"
                      / f"{cell}.json").read_text())
    assert own["config"] == entry["config"] == c.config["name"]
    assert own["traffic"] == entry["traffic"]
    assert entry["chips"] == 1 and c.stages >= 1
    assert c.traffic["entry"] in ("engine", "pipeline", "frontend")
    assert c.traffic["driver"] == ("open" if c.traffic["entry"] ==
                                   "frontend" else "closed")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert len(entry["why"]) <= 200


def test_every_workload_file_is_a_cell_and_every_config_is_used():
    """No file of a cell that BENCHMARK.json no longer names stays behind,
    and every configuration keeps at least one cell."""
    files = {p.stem for p in (spec.ROOT / "bench" / "workloads").glob("*.json")}
    assert files == set(CELLS)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_names_and_units_use_allowed_characters():
    names = ([m["name"] for m in _metrics()] + CELLS
             + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for group in ([m["name"] for m in _metrics()], CELLS,
                  [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in CELLS:
        reported = [m for m in BENCH["end_to_end"] if spec.applies(m, c)]
        assert len(reported) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(
        metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] in E2E
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert m["workloads"], metric
    for cell in m["workloads"]:
        assert cell in CELLS
        assert spec.applies(E2E[m["moves"]], cell), (metric, cell)
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert m["layer"] in layers and "\n" not in m["layer"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configs_are_the_programs_models_at_published_widths(name):
    from repro_torch.core import workload as W
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = spec.config(name)
    assert entry["file"] == f"bench/configs/{name}.json"
    assert entry["reduced"] == cfg["reduced"] == []
    m = W.CNN_MODELS[name]()
    assert (cfg["input_hw"], cfg["input_ch"]) == (m.input_hw, m.input_ch)
    assert tuple(W.ConvLayer(**lyr) for lyr in cfg["layers"]) == m.layers
    # compile_for_serving's plan budget at 8 bits
    assert cfg["theta"] == 2 * 900 - len(m.layers) and cfg["bits"] == 8


def test_entries_have_just_the_contracts_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        for entry in BENCH[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert want <= set(entry) <= want | extra, entry["name"]
            for k in ("why", "layer", "source"):
                if k in entry:
                    assert 1 <= len(entry[k]) <= 200
                    assert "\n" not in entry[k] and "\t" not in entry[k]
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (spec.ROOT / "bench" / "traffic" / "mixes").glob(
        "*.json")))
def test_every_mix_names_a_process_the_generator_knows(mix):
    from bench.traffic import schedule as S
    m = spec.traffic(mix)
    assert m["driver"] in ("closed", "open")
    if m["driver"] == "open":
        assert m["process"] in S.SCENARIOS
        S.resolve_scenario_params(m["process"], m["rate_per_s"],
                                  **m.get("params", {}))
        assert S.open_loop_schedule(m, 1.0, 2 ** 31 + 1)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_sets_stages_and_replicas(cell):
    own = json.loads((spec.ROOT / "bench" / "workloads"
                      / f"{cell}.json").read_text())
    c = spec.cell(cell)
    assert (c.stages, c.replicas) == (own.get("stages", 1),
                                      own.get("replicas", 1))
    assert c.replica_mode in ("pipeline", "stage-shard")
