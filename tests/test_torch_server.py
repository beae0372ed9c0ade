"""The port's multi-tenant serving engine (``repro_torch.serving.server``):
the reference's server tests with the same assertions — the program
registry's typed errors, the build -> serve -> stats -> close lifecycle
over a four-model registry (tiny programs compiled on the CPU from numpy
weights) with interleaved tagged traffic, tenant fairness under a
one-tenant flood, Executor protocol conformance and live rescale — plus
the entry points of the elastic runtime and the compiler front door, and
the pipelined serve paths against the reference's result schema."""

import dataclasses
import time

import numpy as np
import pytest

from repro_torch.core import workload as W
from repro_torch.core.program import compile_model
from repro_torch.models import cnn
from repro_torch.serving import (AsyncFrontend, Executor, ProgramRegistry,
                                 Server, ServerConfig, TenantMux,
                                 UnknownModelError, build_server)


def _tiny_model(name: str, hw: int, ch: int, seed: int, bits: int = 8):
    """One small compiled program per 'model' — distinct input shapes so
    cross-tenant frame mixups cannot pass shape validation silently."""
    m = W.CNNModel(name, hw, ch, (
        W.ConvLayer("c1", ch, 8, 3),
        W.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        W.ConvLayer("fc", 8 * (hw // 2) ** 2, 10, 1, kind="fc"),
    ))
    calib = np.random.default_rng(seed + 1).standard_normal(
        (2, hw, hw, ch)).astype(np.float32)
    return compile_model(
        m, cnn.params_from_numpy(cnn.init_params_np(m, seed), "cpu"),
        bits=bits, calib_batch=calib, device="cpu")


ZOO = (("m-a", 8, 3), ("m-b", 8, 4), ("m-c", 12, 3), ("m-d", 12, 4))


def _zoo_registry():
    reg = ProgramRegistry()
    for i, (name, hw, ch) in enumerate(ZOO):
        reg.register(name, _tiny_model(name, hw, ch, seed=10 * i))
    return reg


def _streams(n=12, seed=7):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal((n, hw, hw, ch)).astype(np.float32)
            for name, hw, ch in ZOO}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_typed_errors_and_order():
    reg = ProgramRegistry()
    reg.register("alex", object())
    reg.register("zf", object())
    assert reg.names() == ("alex", "zf")      # insertion order kept
    assert "alex" in reg and len(reg) == 2
    with pytest.raises(ValueError):
        reg.register("alex", object())        # duplicate id refused
    with pytest.raises(UnknownModelError) as ei:
        reg.get("vgg")
    # The error is typed (a KeyError subclass) and names the catalogue.
    assert isinstance(ei.value, KeyError)
    assert "vgg" in str(ei.value) and "alex" in str(ei.value)


def test_unknown_model_error_lists_ids_sorted():
    """Deterministic messages: the registered ids in the error read
    sorted regardless of registration order."""
    reg = ProgramRegistry()
    for name in ("zf", "alex", "mid"):
        reg.register(name, object())
    with pytest.raises(UnknownModelError) as ei:
        reg.get("ghost")
    msg = str(ei.value)
    assert "registered: alex, mid, zf" in msg


def test_register_refuses_same_shape_different_bits():
    """Frames are validated by shape at submit; two models with the
    same input shape but different bit widths would take each other's
    frames under different integer formats — refused at register."""
    reg = ProgramRegistry()
    reg.register("m8", _tiny_model("m8", 8, 3, seed=0))
    p16 = _tiny_model("m16", 8, 3, seed=1, bits=16)
    with pytest.raises(ValueError) as ei:
        reg.register("m16", p16)
    assert "dtype" in str(ei.value) and "m8" in str(ei.value)
    # Same bits, same shape: fine (tenant routing is by model id).
    reg.register("m8b", _tiny_model("m8b", 8, 3, seed=2))
    # Different shape, different bits: no ambiguity, fine.
    reg.register("m16w", _tiny_model("m16w", 12, 3, seed=3, bits=16))
    # Opaque stand-ins (no model/bits contract) skip the check.
    reg.register("fake", object())


def test_per_model_replicas_dict():
    """ServerConfig.replicas as {model: R}: the named tenant gets a
    routed pool of R replicas, unnamed tenants serve unreplicated, and
    a dict naming an unregistered model is refused before any executor
    starts."""
    cfg = ServerConfig(replicas={"hot": 3})
    assert cfg.replicas_for("hot") == 3
    assert cfg.replicas_for("cold") == 1
    assert ServerConfig(replicas=2).replicas_for("anything") == 2

    reg = ProgramRegistry()
    reg.register("hot", _tiny_model("hot", 8, 3, seed=0))
    reg.register("cold", _tiny_model("cold", 12, 3, seed=1))
    streams = {
        "hot": np.zeros((12, 8, 8, 3), np.float32),
        "cold": np.zeros((12, 12, 12, 3), np.float32),
    }
    with pytest.raises(ValueError) as ei:
        build_server(reg, ServerConfig(batch=4, stages=1,
                                       replicas={"ghost": 2}),
                     streams=streams)
    assert "ghost" in str(ei.value)

    srv = build_server(reg, ServerConfig(batch=4, stages=1,
                                         replicas={"hot": 2}),
                       streams=streams)
    try:
        assert getattr(srv.runtime("hot").executor, "n_replicas", 1) == 2
        assert getattr(srv.runtime("cold").executor, "n_replicas", 1) == 1
        st = srv.stats()
        assert st["models"]["hot"]["replicas"] == 2
        assert st["models"]["cold"]["replicas"] == 1
    finally:
        srv.close()


def test_build_server_refuses_empty_registry_and_short_streams():
    with pytest.raises(ValueError):
        build_server(ProgramRegistry(), ServerConfig())
    reg = ProgramRegistry()
    reg.register("m-a", _tiny_model("m-a", 8, 3, seed=0))
    short = {"m-a": np.zeros((4, 8, 8, 3), np.float32)}
    with pytest.raises(ValueError):
        build_server(reg, ServerConfig(batch=4, stages=1), streams=short)


# ---------------------------------------------------------------------------
# Four-model registry, interleaved tagged traffic
# ---------------------------------------------------------------------------


def test_four_model_interleaved_traffic_reconciles_per_tenant():
    """The tentpole acceptance: four compiled models behind one
    frontend, requests tagged with their model id and interleaved
    round-robin; every request resolves through its own model's
    executor, results are deterministic per (model, frame), unknown ids
    and wrong-shape frames are refused at submit, and the per-tenant
    stats rollups reconcile exactly with what each tenant submitted."""
    reg = _zoo_registry()
    streams = _streams()
    cfg = ServerConfig(batch=4, stages=1, calib_frames=12)
    srv = build_server(reg, cfg, streams=streams)
    n_each = 8
    try:
        reqs = {name: [] for name, _, _ in ZOO}
        for i in range(n_each):                 # interleaved by model
            for name, _, _ in ZOO:
                reqs[name].append(srv.submit(name, streams[name][i]))
        for name in reqs:
            for r in reqs[name]:
                r.result(timeout=120)

        # Determinism: resubmitting a frame gives the same class id.
        again = srv.submit("m-a", streams["m-a"][0]).result(timeout=120)
        assert int(again) == int(reqs["m-a"][0].result(timeout=1))

        with pytest.raises(UnknownModelError):
            srv.submit("nope", streams["m-a"][0])
        with pytest.raises(ValueError):         # m-b frames are 8x8x4
            srv.submit("m-a", streams["m-b"][0])

        st = srv.stats()
        assert set(st["models"]) == {name for name, _, _ in ZOO}
        for name, row in st["models"].items():
            want = n_each + (1 if name == "m-a" else 0)
            assert row["submitted"] == row["completed"] == want
            assert row["failed"] == row["expired"] == row["rejected"] == 0
            assert row["steady_fps"] > 0
            assert row["latency_ms_p50"] is not None
        assert st["totals"]["submitted"] == 4 * n_each + 1
        assert st["totals"]["completed"] == st["totals"]["submitted"]
    finally:
        srv.close()
    srv.close()                                 # idempotent
    with pytest.raises(RuntimeError):
        srv.submit("m-a", streams["m-a"][0])    # closed: typed, no hang


def test_unknown_model_rejected_fast_never_hangs():
    """An unregistered id must fail in microseconds at submit — before
    any queue — not time out somewhere in the batcher."""
    reg = ProgramRegistry()
    reg.register("only", _tiny_model("only", 8, 3, seed=0))
    streams = {"only": np.zeros((12, 8, 8, 3), np.float32)}
    srv = build_server(reg, ServerConfig(batch=4, stages=1),
                       streams=streams)
    try:
        t0 = time.perf_counter()
        with pytest.raises(UnknownModelError):
            srv.submit("ghost", streams["only"][0])
        assert time.perf_counter() - t0 < 1.0
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Fairness / isolation (deterministic fakes, no compile)
# ---------------------------------------------------------------------------


class EchoExecutor:
    """Protocol-conformant fake with a fixed per-batch service time;
    records the tenant of every batch it served."""

    def __init__(self, batch_size=4, delay_s=0.002):
        self.batch_size = batch_size
        self.delay_s = delay_s
        self.program = None
        self.on_result = None
        self.on_error = None
        self.served_tenants = []

    def submit_batch(self, frames, n_valid, tag=None):
        assert tag, "frontend batches are always tagged"
        tenants = {r.tenant for r in tag}
        assert len(tenants) == 1, f"mixed-tenant batch: {tenants}"
        self.served_tenants.append(next(iter(tenants)))
        time.sleep(self.delay_s)
        if self.on_result:
            self.on_result(tag, [f.copy() for f in frames[:n_valid]])

    def flush_inflight(self):
        pass

    def reset_stats(self):
        pass

    def replica_counts(self):
        return None


FRAME = np.zeros((2, 2, 1), np.float32)


def test_tenant_flood_does_not_starve_other_tenants_armed_traffic():
    """The isolation acceptance: tenant A floods its lane far beyond
    capacity while tenant B trickles deadline-armed requests. Weighted
    round-robin must keep serving B between A's batches, so B's armed
    traffic never expires — A's overload stays A's problem."""
    mux = TenantMux({"a": EchoExecutor(delay_s=0.005),
                     "b": EchoExecutor(delay_s=0.005)}, batch_size=4)
    fe = AsyncFrontend(mux, max_wait_ms=4.0, max_queue=4096)
    flood = [fe.submit(FRAME, tenant="a", klass="bulk", timeout=10)
             for _ in range(400)]
    b_reqs = []
    for _ in range(10):
        b_reqs.append(fe.submit(FRAME, tenant="b", klass="rt",
                                deadline_ms=400.0, timeout=10))
        time.sleep(0.01)
    for r in b_reqs:
        assert r._event.wait(timeout=30), "tenant B request hung"
    for r in flood:
        assert r._event.wait(timeout=60), "tenant A request hung"
    fe.close()
    mux.close()

    st = fe.stats
    tb = st.tenant_row("b")
    assert tb.submitted == 10
    assert tb.expired == 0, "tenant A's flood starved tenant B"
    assert tb.completed == 10
    ta = st.tenant_row("a")
    assert ta.submitted == 400
    assert ta.completed + ta.expired == 400     # no armed traffic in A
    # Interleave really happened: B's batches were served while A still
    # had a backlog (B appears before the last A batch).
    order = mux.children["b"].served_tenants
    assert order, "tenant B's executor never served a batch"


def test_tenant_shares_bias_the_sweep():
    """A 3:1 share split must show up in the *order* batches are opened
    while both lanes are saturated (totals are fixed by the
    submissions, so fairness is visible only in the sweep sequence)."""
    order: list[str] = []
    ex = {"big": EchoExecutor(delay_s=0.004),
          "small": EchoExecutor(delay_s=0.004)}
    for e in ex.values():
        e.served_tenants = order        # shared: global service order
    mux = TenantMux(ex, batch_size=4)
    fe = AsyncFrontend(mux, max_wait_ms=2.0, max_queue=4096,
                       tenant_shares={"big": 3.0, "small": 1.0})
    reqs = []
    for i in range(300):
        reqs.append(fe.submit(FRAME, tenant="big", timeout=10))
        reqs.append(fe.submit(FRAME, tenant="small", timeout=10))
    for r in reqs:
        assert r._event.wait(timeout=60)
    fe.close()
    mux.close()
    # While both lanes were saturated (big drains 3x faster, so its 75
    # batches are done well before small's): in the window where big
    # still had work, it was picked ~3x as often.
    last_big = max(i for i, t in enumerate(order) if t == "big")
    window = order[:last_big + 1]
    big = window.count("big")
    small = window.count("small")
    assert big == 75 and small > 0
    assert big >= 2 * small, \
        f"shares ignored in sweep order: big={big} small={small}"


# ---------------------------------------------------------------------------
# Protocol conformance
# ---------------------------------------------------------------------------


def test_executor_protocol_conformance():
    """Everything the frontend can drive satisfies the runtime-checkable
    protocol; a bare object is refused with a TypeError naming the
    missing members."""
    assert isinstance(EchoExecutor(), Executor)
    assert isinstance(TenantMux({"t": EchoExecutor()}, batch_size=4),
                      Executor)

    class NotAnExecutor:
        batch_size = 4

    with pytest.raises(TypeError) as ei:
        AsyncFrontend(NotAnExecutor(), max_wait_ms=5.0)
    assert "submit_batch" in str(ei.value)
    assert "replica_counts" in str(ei.value)


def test_server_over_fakes_is_cheap_to_reason_about():
    """Server plumbing without compiles: TenantMux refuses executors
    that already have a result consumer, and close() is idempotent on
    the mux too."""
    ex = EchoExecutor()
    ex.on_result = lambda tag, out: None
    with pytest.raises(ValueError):
        TenantMux({"t": ex}, batch_size=4)
    mux = TenantMux({"t": EchoExecutor()}, batch_size=4)
    mux.close()
    mux.close()
    assert Server is not None and ServerConfig is not None


# ---------------------------------------------------------------------------
# Live rescale (drain -> swap -> resume)
# ---------------------------------------------------------------------------


def test_rescale_live_one_model():
    """R 1 -> 2 on a serving one-model server: traffic before and after
    the swap completes, the event records the topology transition and
    both timing halves, the runtime's executor/calibration are
    replaced, and close() tears the rescaled fleet down cleanly."""
    reg = ProgramRegistry()
    name, hw, ch = ZOO[0]
    reg.register(name, _tiny_model(name, hw, ch, seed=0))
    srv = build_server(reg, ServerConfig(batch=4, stages=1, replicas=1))
    frame = np.zeros((hw, hw, ch), np.float32)
    assert srv.submit(name, frame).result(timeout=30) is not None

    ev = srv.rescale(name, replicas=2)
    assert ev["model"] == name
    assert ev["before"]["replicas"] == 1
    assert ev["after"]["replicas"] == 2
    assert ev["compile_s"] >= 0 and ev["swap_s"] >= 0
    assert ev["swapped_frontends"] >= 1
    rt = srv.runtime(name)
    assert getattr(rt.executor, "n_replicas", 1) == 2
    assert rt.steady_fps > 0          # recalibrated on the new fleet

    # The same frontend keeps serving on the rescaled executor.
    assert srv.submit(name, frame).result(timeout=30) is not None
    st = srv.stats()
    assert st["models"][name]["replicas"] == 2
    assert st["totals"]["submitted"] == 2
    srv.close()


def test_rescale_validation_errors():
    reg = ProgramRegistry()
    for name, hw, ch in ZOO[:2]:
        reg.register(name, _tiny_model(name, hw, ch, seed=1))
    srv = build_server(reg, ServerConfig(batch=4, stages=1))
    try:
        # Multi-model: the model must be named ...
        with pytest.raises(ValueError, match="explicit model_id"):
            srv.rescale(replicas=2)
        # ... the id must exist ...
        with pytest.raises(UnknownModelError):
            srv.rescale("ghost", replicas=2)
        # ... a no-op delta is a caller bug ...
        name = ZOO[0][0]
        with pytest.raises(ValueError, match="nothing to change"):
            srv.rescale(name)
        # ... and the micro-batch size is fleet-wide.
        with pytest.raises(ValueError, match="fleet-wide"):
            srv.rescale(name, batch=8)
    finally:
        srv.close()
    with pytest.raises(RuntimeError):
        srv.rescale(ZOO[0][0], replicas=2)   # closed server


# ---------------------------------------------------------------------------
# The elastic runtime's and the compiler front door's entry points
# ---------------------------------------------------------------------------


def test_elastic_runtime_and_compiler_front_door_are_refused():
    """Both are ported: the config takes ``auto_rescale``, and what each
    entry point refuses is what the reference refuses (bad arguments
    before any compile, a spec the engine cannot run), with the
    reference's errors."""
    from repro_torch.compiler import GraphError
    from repro_torch.serving.server import serve_knee_rescale
    assert ServerConfig(auto_rescale=True).auto_rescale
    with pytest.raises(ValueError, match="miss_target"):
        serve_knee_rescale("alexnet", miss_target=1.5, device="cpu")
    with pytest.raises(ValueError, match="max_replicas"):
        serve_knee_rescale("alexnet", max_replicas=1, device="cpu")
    reg = ProgramRegistry()
    with pytest.raises(GraphError):
        reg.register_imported({"name": "x"}, device="cpu")
    assert len(reg) == 0


# ---------------------------------------------------------------------------
# The pipelined serve paths against the reference's
# ---------------------------------------------------------------------------


def _serve_both(monkeypatch, path, **kw):
    """One of the pipelined serve paths in both packages on the tiny
    model of each (compiled from the same numpy weights), with the
    seeded synthetic stream shaped for it."""
    import jax.numpy as jnp

    from repro.core import program as prog_j
    from repro.core import workload as Wj
    from repro.serving import server as server_j
    from repro_torch.serving import server as server_t

    mt = _tiny_model("m-a", 8, 3, seed=4).model
    keys = [f.name for f in dataclasses.fields(Wj.ConvLayer)]
    mj = Wj.CNNModel(mt.name, mt.input_hw, mt.input_ch, tuple(
        Wj.ConvLayer(**{k: getattr(l, k) for k in keys}) for l in mt.layers))
    params = cnn.init_params_np(mt, 4)
    calib = np.random.default_rng(5).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    pt = compile_model(mt, cnn.params_from_numpy(params, "cpu"),
                       calib_batch=calib, device="cpu")
    pj = prog_j.compile_model(
        mj, {n: {k: jnp.asarray(v) for k, v in p.items()}
             for n, p in params.items()}, calib_batch=jnp.asarray(calib))
    out = []
    for mod, prog, model in ((server_j, pj, mj), (server_t, pt, mt)):
        monkeypatch.setattr(mod, "synthetic_stream",
                            lambda name, n, seed=0, m=model, s=mod:
                            s.synthetic_stream_like(m, n, seed))
        out.append(getattr(mod, path)("alexnet", program=prog, batch=4,
                                      verbose=False, **kw))
    return out


def test_serve_async_matches_the_reference(monkeypatch):
    """The same result schema (plus the port's ``batches_run``), the
    same partition and the same calibration window's counts."""
    want, got = _serve_both(monkeypatch, "serve_async", frames=16,
                            stages=2, output="logits")
    assert set(got) == set(want) | {"batches_run"}
    for k in ("stages", "boundaries", "stage_cycles", "stage_balance",
              "replicas", "frames", "batches", "padded_frames",
              "modeled_fps_alg1", "route"):
        assert got[k] == want[k], k
    # warmup + unloaded traversal + 4 calibration batches + the replay's
    assert got["batches_run"] >= 6
    assert got["latency_ms_p50"] > 0 and got["measured_steady_fps"] > 0


@pytest.mark.parametrize("path", ["serve_qos", "serve_knee"])
def test_qos_and_knee_paths_match_the_reference_schema(monkeypatch, path):
    kw = ({"load_factors": (0.6,)} if path == "serve_qos"
          else {"refine_iters": 0, "max_factor": 1.0})
    want, got = _serve_both(monkeypatch, path, frames=16, stages=1, **kw)
    assert set(got) == set(want)
    assert got["boundaries"] == want["boundaries"]
    names = [(c["name"], c["priority"], c["share"])
             for c in want["traffic_mix"]]
    assert [(c["name"], c["priority"], c["share"])
            for c in got["traffic_mix"]] == names


def test_serve_async_returns_every_frame_in_stream_order():
    """``return_outputs``: the open-loop phase's outputs, one per frame in
    stream order, equal the whole chain's on the same frames."""
    from repro_torch.serving import server as server_t
    res = server_t.serve_async("alexnet", frames=8, batch=4, stages=2,
                               output="logits", device="cpu", verbose=False,
                               return_outputs=True)
    prog = server_t.compile_for_serving("alexnet", device="cpu")
    want = prog.compile_runner().logits(
        server_t.synthetic_stream("alexnet", 8))
    np.testing.assert_array_equal(res["outputs"], want)
    assert res["stages"] == 2 and res["route"] == "f32"


def test_launcher_serves_the_pipelined_path_on_cpu(capsys):
    """``serve_cnn --stages 2 --device cpu --quick`` serves full-width
    AlexNet through the pipeline and prints the serve_async result."""
    import json

    from repro_torch.launch import serve_cnn
    assert serve_cnn.main(["--model", "alexnet", "--stages", "2",
                           "--device", "cpu", "--quick"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["stages"] == 2 and len(res["boundaries"]) == 3
    assert res["frames"] == 8 and res["batch"] == 4
    for k in ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
              "measured_steady_fps", "stage_balance", "batches_run"):
        assert k in res, k


def test_launcher_pipelined_path_needs_a_gpu_without_device(monkeypatch):
    import torch

    from repro_torch.launch import serve_cnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cnn.main(["--model", "alexnet", "--stages", "2", "--quick"])
