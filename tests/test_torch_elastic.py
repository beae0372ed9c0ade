"""The port's elastic runtime (``repro_torch.serving.elastic``): the
reference's ``tests/test_elastic.py`` case for case with the same
assertions — the pure hysteresis policy (ElasticController.decide over
hand-built signal windows), the observe -> decide -> act step against
fakes, and the knee_after_rescale artifact schema — plus the port's own
``serve_knee_rescale`` result against that schema and its served frames
against the whole chain, and ``ServerConfig(auto_rescale=True)`` on a
real server, on a tiny program compiled on the CPU. The real mid-stream
rescale under producer threads lives in the stress lane
(test_torch_serving_stress.py)."""

import dataclasses
import importlib.util
import json
import os
import threading
import time
import types

import pytest

from repro_torch.serving.elastic import (ElasticController, ElasticPolicy,
                                         RescaleDecision)
from repro_torch.serving.estimator import ServiceTimeEstimator

_ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load_validate_bench():
    spec = importlib.util.spec_from_file_location(
        "validate_bench",
        os.path.join(_ROOT, "benchmarks", "validate_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- fakes: just enough server/frontend for the controller ----------------


@dataclasses.dataclass
class _Class:
    armed: bool = True
    submitted: int = 0
    expired: int = 0
    rejected: int = 0
    rejected_wait: int = 0
    late: int = 0


class _Stats:
    def __init__(self, **classes):
        self.classes = classes


class _FakeFrontend:
    batch_size = 8

    def __init__(self):
        self.estimator = ServiceTimeEstimator()
        self._closing = threading.Event()
        self.snap = _Stats(interactive=_Class())

    def stats_snapshot(self):
        # Deep-ish copy so later mutation doesn't alias the baseline.
        return _Stats(**{k: dataclasses.replace(v)
                         for k, v in self.snap.classes.items()})


class _FakeServer:
    """Enough of Server for the controller: one model, a router-less
    executor, and a rescale() that just records the ask."""

    model_names = ("tiny",)

    def __init__(self, replicas=1):
        self.replicas = replicas
        self.rescales = []

    def _tenant_of(self, model):
        from repro_torch.serving.frontend import DEFAULT_TENANT
        return DEFAULT_TENANT

    def runtime(self, model):
        ex = types.SimpleNamespace(router=None, partition=None,
                                   n_replicas=self.replicas)
        return types.SimpleNamespace(executor=ex)

    def rescale(self, model, *, replicas=None, **kw):
        before = {"replicas": self.replicas}
        self.replicas = replicas
        self.rescales.append(replicas)
        return {"model": model, "before": before,
                "after": {"replicas": replicas},
                "replica_mode": "pipeline", "compile_s": 0.0,
                "swap_s": 0.0, "swapped_frontends": 1}


def _ctrl(policy, replicas=1):
    return ElasticController(_FakeServer(replicas), _FakeFrontend(),
                             policy=policy)


def _win(miss, n=20, *, replicas=1, drift=None, quarantines=0):
    return {"armed_miss_rate": miss, "armed_submitted": n,
            "drift": drift, "quarantine_events": quarantines,
            "replicas": replicas, "stages": 2}


# -- policy validation ----------------------------------------------------


def test_policy_rejects_inverted_bands():
    with pytest.raises(ValueError):
        ElasticPolicy(miss_high=0.01, miss_low=0.05)
    with pytest.raises(ValueError):
        ElasticPolicy(drift_high=1.2, drift_low=1.5)
    with pytest.raises(ValueError):
        ElasticPolicy(sustain=0)
    with pytest.raises(ValueError):
        ElasticPolicy(min_replicas=3, max_replicas=2)


def test_policy_json_roundtrip():
    p = ElasticPolicy(miss_high=0.02, max_replicas=3)
    j = p.to_json()
    assert j["miss_high"] == 0.02 and j["max_replicas"] == 3
    assert ElasticPolicy(**j) == p


# -- decide: pure hysteresis ----------------------------------------------


def test_scale_out_needs_sustained_miss():
    ctrl = _ctrl(ElasticPolicy(miss_high=0.05, sustain=2))
    assert ctrl.decide(_win(0.2)) is None          # one window: a blip
    d = ctrl.decide(_win(0.2))                     # two: a trend
    assert isinstance(d, RescaleDecision)
    assert d.action == "scale_out" and d.replicas == 2
    assert "2 windows" in d.reason


def test_dead_band_window_breaks_the_trend():
    ctrl = _ctrl(ElasticPolicy(miss_high=0.05, miss_low=0.005, sustain=2))
    assert ctrl.decide(_win(0.2)) is None
    assert ctrl.decide(_win(0.02)) is None         # between the edges
    assert ctrl.decide(_win(0.2)) is None          # trend restarted
    assert ctrl.decide(_win(0.2)).action == "scale_out"


def test_quiet_window_neither_builds_nor_decays():
    p = ElasticPolicy(miss_high=0.05, sustain=2, min_window_requests=8)
    ctrl = _ctrl(p)
    assert ctrl.decide(_win(0.2)) is None
    assert ctrl.decide(_win(1.0, n=3)) is None     # too quiet to call
    assert ctrl.decide(_win(0.2)).action == "scale_out"


def test_drift_alone_scales_out():
    ctrl = _ctrl(ElasticPolicy(drift_high=2.0, sustain=1))
    d = ctrl.decide(_win(0.0, drift=2.5))
    assert d is not None and d.action == "scale_out"
    assert "drift" in d.reason


def test_quarantine_triggers_on_first_event_and_respects_ceiling():
    p = ElasticPolicy(max_replicas=2)
    ctrl = _ctrl(p)
    d = ctrl.decide(_win(0.0, quarantines=1))
    assert d is not None and d.action == "scale_out"
    assert "quarantined" in d.reason
    # Already at the ceiling: nothing to scale to.
    ctrl2 = _ctrl(p, replicas=2)
    assert ctrl2.decide(_win(0.0, replicas=2, quarantines=1)) is None
    # Opted out entirely.
    ctrl3 = _ctrl(ElasticPolicy(quarantine_triggers=False, sustain=2))
    assert ctrl3.decide(_win(0.0, quarantines=1)) is None


def test_scale_in_needs_both_low_bands_and_a_floor():
    p = ElasticPolicy(miss_low=0.005, drift_low=1.3, sustain=2,
                      min_replicas=1)
    ctrl = _ctrl(p, replicas=2)
    assert ctrl.decide(_win(0.0, replicas=2)) is None
    d = ctrl.decide(_win(0.0, replicas=2))
    assert d is not None and d.action == "scale_in" and d.replicas == 1
    # Quiet-but-drifting fleet is never shrunk.
    ctrl2 = _ctrl(p, replicas=2)
    assert ctrl2.decide(_win(0.0, replicas=2, drift=1.8)) is None
    assert ctrl2.decide(_win(0.0, replicas=2, drift=1.8)) is None
    # At the floor there is nothing to shrink.
    ctrl3 = _ctrl(p, replicas=1)
    assert ctrl3.decide(_win(0.0)) is None
    assert ctrl3.decide(_win(0.0)) is None


def test_cooldown_suppresses_even_quarantine():
    ctrl = _ctrl(ElasticPolicy(cooldown_s=60.0))
    ctrl._last_rescale_t = time.perf_counter()
    assert ctrl.decide(_win(1.0, quarantines=3)) is None


# -- step: observe -> decide -> act against fakes -------------------------


def test_step_rescales_and_records_event():
    srv = _FakeServer(replicas=1)
    fe = _FakeFrontend()
    ctrl = ElasticController(srv, fe, policy=ElasticPolicy(
        miss_high=0.05, sustain=1, min_window_requests=8))
    # First window: 20 armed submissions, 10 missed -> 50% >= 5%.
    fe.snap.classes["interactive"] = _Class(submitted=20, expired=10)
    event = ctrl.step()
    assert event is not None and srv.rescales == [2]
    assert event["action"] == "scale_out"
    assert event["signals"]["armed_miss_rate"] == 0.5
    assert event["before"] == {"replicas": 1}
    assert event["after"] == {"replicas": 2}
    assert ctrl.history == [event]
    assert not ctrl.busy
    # Cooldown right after the act: an equally bad window is ignored.
    fe.snap.classes["interactive"] = _Class(submitted=40, expired=30)
    assert ctrl.step() is None


def test_step_is_noop_after_frontend_close():
    srv = _FakeServer()
    fe = _FakeFrontend()
    ctrl = ElasticController(srv, fe, policy=ElasticPolicy(sustain=1))
    fe.snap.classes["interactive"] = _Class(submitted=20, expired=20)
    fe._closing.set()
    assert ctrl.step() is None and srv.rescales == []


def test_multi_model_server_needs_explicit_model():
    srv = _FakeServer()
    srv.model_names = ("a", "b")
    with pytest.raises(ValueError, match="explicit model"):
        ElasticController(srv, _FakeFrontend())


# -- artifact schema: knee_after_rescale ----------------------------------

vb = _load_validate_bench()

_PACING = {"arrivals": 40, "target_fps": 12.0, "achieved_fps": 12.0,
           "rate_ratio": 1.0, "lag_ms_mean": 0.1, "lag_ms_max": 0.5}


def _knee_row(replicas, knee_qps):
    return {
        "measured_steady_fps": 10.0, "modeled_fps_alg1": 100.0,
        "batch": 8, "stages": 2, "seed": 0, "slo_ms": 500.0,
        "miss_target": 0.01, "traffic_mix": [], "route": "f32",
        "admission_control": True, "replicas": replicas,
        "knee_qps": knee_qps, "knee_of_steady": knee_qps / 10.0,
        "probes": [
            {"arrival_fps": knee_qps, "sustained": True,
             "armed_miss_rate": 0.0, "armed_submitted": 10,
             "submitted": 40, "completed": 40, "expired": 0,
             "rejected": 0, "rejected_wait": 0, "pacing": _PACING},
            {"arrival_fps": 2 * knee_qps, "sustained": False,
             "armed_miss_rate": 0.5, "armed_submitted": 10,
             "submitted": 40, "completed": 20, "expired": 0,
             "rejected": 0, "rejected_wait": 20, "pacing": _PACING},
        ],
    }


def _seg(label, rate, miss, replicas):
    return {"label": label, "arrival_fps": rate, "armed_submitted": 20,
            "armed_missed": int(20 * miss), "armed_miss_rate": miss,
            "replicas": replicas, "rescales_so_far": 0}


def _rescale_block():
    return {
        "batch": 8, "stages": 2, "seed": 0, "slo_ms": 500.0,
        "miss_target": 0.01, "traffic_mix": [],
        "policy": ElasticPolicy().to_json(),
        "anchor_qps": 12.0, "measured_steady_fps_r1": 10.0,
        "segments": [_seg("ramp0", 12.0, 0.4, 1),
                     _seg("recovery", 12.0, 0.0, 2)],
        "rescale_events": [{
            "model": "alexnet", "before": {"replicas": 1},
            "after": {"replicas": 2}, "compile_s": 1.0, "swap_s": 0.01,
            "action": "scale_out", "reason": "armed miss", "signals": {},
        }],
        "n_rescales": 1, "forced": False,
        "replicas_before": 1, "replicas_after": 2,
        "armed_miss_at_trigger": 0.4, "armed_miss_after_rescale": 0.0,
        "miss_recovered": True, "hung": 0,
        "knee": _knee_row(2, 18.0),
    }


def test_validate_knee_after_rescale_block(tmp_path):
    top = _knee_row(1, 12.0)
    top["knee_after_rescale"] = _rescale_block()
    data = {"schema_version": 1, "bench": "serve_knee", "seed": 0,
            "models": {"alexnet": top}}
    p = tmp_path / "BENCH_serve_knee.json"
    p.write_text(json.dumps(data))
    assert vb.validate(str(p)) == []

    def _mutated(fn):
        bad = json.loads(json.dumps(data))
        fn(bad["models"]["alexnet"]["knee_after_rescale"])
        p.write_text(json.dumps(bad))
        return vb.validate(str(p))

    # No rescale event recorded: the ramp proved nothing.
    errs = _mutated(lambda b: b.update(rescale_events=[]))
    assert any("must trigger" in e for e in errs)
    # Topology summary must reproduce from the events.
    errs = _mutated(lambda b: b.update(replicas_after=4))
    assert any("does not reproduce" in e for e in errs)
    # Event count drifting from the list it summarizes.
    errs = _mutated(lambda b: b.update(n_rescales=2))
    assert any("does not match" in e for e in errs)
    # miss_recovered contradicting the recorded rates.
    errs = _mutated(lambda b: b.update(armed_miss_after_rescale=0.9))
    assert any("contradicts miss" in e for e in errs)
    # The nested knee row must have been measured post-rescale.
    errs = _mutated(lambda b: b["knee"].update(replicas=1))
    assert any("was not measured at replicas_after" in e for e in errs)
    # A lost request is never schema-legal.
    errs = _mutated(lambda b: b.update(hung=-1))
    assert any("hung" in e for e in errs)


# -- the port's serve_knee_rescale and auto_rescale on a real server -------


def _tiny_program():
    import numpy as np

    from repro_torch.core import workload as W
    from repro_torch.core.program import compile_model
    from repro_torch.models import cnn
    m = W.CNNModel("tiny", 8, 3, (
        W.ConvLayer("c1", 3, 8, 3),
        W.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        W.ConvLayer("fc", 8 * 4 * 4, 10, 1, kind="fc"),
    ))
    calib = np.random.default_rng(1).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    return compile_model(
        m, cnn.params_from_numpy(cnn.init_params_np(m, 0), "cpu"), bits=8,
        calib_batch=calib, device="cpu")


def test_port_knee_rescale_result_validates_and_serves_exact(
        tmp_path, monkeypatch):
    """The port's ``serve_knee_rescale`` on a tiny CPU program: its block
    passes the reference's schema validator, every request resolved
    (``hung == 0``), one rescale happened, forced under live traffic, and
    every served frame's output equals the whole chain's on that frame.
    The policy is held back: whether and when it fires inside the ramp
    depends on how fast the host serves the tiny program, so the test
    takes the forced path, which runs the same drain, swap and resume
    every time (the policy's rules have their own cases above)."""
    import numpy as np

    from repro_torch.serving import server as server_t
    prog = _tiny_program()
    monkeypatch.setattr(server_t, "synthetic_stream",
                        lambda name, n, seed=0: server_t
                        .synthetic_stream_like(prog.model, n, seed))
    monkeypatch.setattr(ElasticController, "decide",
                        lambda self, signals: None)
    res = server_t.serve_knee_rescale(
        "tiny", program=prog, frames=32, batch=4, stages=2,
        max_segments=2, refine_iters=0, max_factor=2.0, output="logits",
        verbose=False, return_outputs=True)
    served = res.pop("outputs")
    assert res["hung"] == 0 and res["n_rescales"] == 1
    assert res["replicas_after"] == 2 and res["forced"] is True
    stream = server_t.synthetic_stream_like(prog.model, 32, 0)
    want = prog.compile_runner().logits(stream)
    idx = served["frame_idx"]
    assert len(idx) > 0 and len(idx) == len(served["outputs"])
    np.testing.assert_array_equal(served["outputs"], want[idx])
    top = _knee_row(1, 12.0)
    top["knee_after_rescale"] = json.loads(json.dumps(res))
    p = tmp_path / "BENCH_serve_knee.json"
    p.write_text(json.dumps({"schema_version": 1, "bench": "serve_knee",
                             "seed": 0, "models": {"tiny": top}}))
    assert vb.validate(str(p)) == []


def test_auto_rescale_attaches_a_controller_and_stops_it_at_close():
    from repro_torch.serving import (ProgramRegistry, ServerConfig,
                                     build_server)
    reg = ProgramRegistry()
    reg.register("tiny", _tiny_program())
    cfg = ServerConfig(batch=4, stages=1, calib_frames=12,
                       auto_rescale=True,
                       rescale_policy={"max_replicas": 2},
                       rescale_interval_s=0.05)
    srv = build_server(reg, cfg)
    try:
        fe = srv.open_frontend()
        ctrl = srv._controller
        assert isinstance(ctrl, ElasticController)
        assert ctrl.policy.max_replicas == 2
        fe.close()
        fe2 = srv.open_frontend()          # a newer frontend takes over
        assert srv._controller is not ctrl and ctrl._thread is None
        fe2.close()
    finally:
        srv.close()
    assert srv._controller is None
