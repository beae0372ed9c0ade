"""The port's compiler front door (``repro_torch.compiler``): the
reference's ``tests/test_compiler.py`` case for case with the same
assertions, on the CPU, plus parity with the reference — the same spec
lowers to the same engine chain, and with the same params and calibration
batch LeNet's golden record equals the reference's field for field — and
the port's ``import_model`` launcher.

Compiler front door: JSON-spec ingestion, the lowering contract
(ReLU/pool folding, padding legalization, typed rejection of
engine-unrepresentable ops), cross-route int8 golden
parity for an imported non-paper CNN, and the registry-serve smoke that
pins the acceptance criterion — an imported model serves through
``build_server``/``Server.submit`` beside the paper models, with no
``onnx`` installed."""

import os

import numpy as np
import pytest

from repro_torch import compiler
from repro_torch.compiler import (GoldenMismatch, Graph, GraphError,
                                  UnsupportedOpError, from_spec,
                                  import_source)
from repro_torch.serving import (ProgramRegistry, ServerConfig,
                                 build_server, synthetic_stream_like)

LENET_SPEC = os.path.join(os.path.dirname(__file__), os.pardir,
                          "examples", "lenet.json")


def tiny_spec(**over):
    spec = {
        "name": "tinynet",
        "input": {"hw": 8, "channels": 3},
        "nodes": [
            {"op": "conv", "name": "c1", "input": "input",
             "out_channels": 4, "kernel": 3, "padding": "same"},
            {"op": "relu", "name": "r1", "input": "c1"},
            {"op": "maxpool", "name": "p1", "input": "r1",
             "kernel": 2, "stride": 2},
            {"op": "flatten", "name": "fl", "input": "p1"},
            {"op": "fc", "name": "f1", "input": "fl",
             "out_features": 10},
        ],
    }
    spec.update(over)
    return spec


# ---------------------------------------------------------------------------
# Graph IR + spec ingestion
# ---------------------------------------------------------------------------


def test_spec_builds_validated_graph_with_shapes():
    g = from_spec(tiny_spec())
    assert isinstance(g, Graph)
    assert g.shapes["c1"] == (8, 8, 4)          # 'same' keeps hw
    assert g.shapes["p1"] == (4, 4, 4)          # k2 s2 halves
    assert g.shapes["fl"] == (64,)              # 4*4*4 flattened
    assert g.shapes["f1"] == (10,)
    assert g.output == "f1"


def test_unknown_op_is_typed_and_names_the_node():
    spec = tiny_spec()
    spec["nodes"][1] = {"op": "gelu", "name": "r1", "input": "c1"}
    with pytest.raises(UnsupportedOpError) as ei:
        import_source(spec)
    assert "r1" in str(ei.value) and "gelu" in str(ei.value)
    assert isinstance(ei.value, GraphError)     # one catchable base


def test_shape_mismatch_rejected_at_import_time():
    spec = tiny_spec()
    spec["nodes"][4]["in_features"] = 999       # producer has 64
    with pytest.raises(GraphError) as ei:
        import_source(spec)
    assert "999" in str(ei.value) and "64" in str(ei.value)


def test_structural_errors_rejected_at_import_time():
    spec = tiny_spec()
    spec["nodes"][0]["input"] = "ghost"         # undefined producer
    with pytest.raises(GraphError):
        import_source(spec)
    spec = tiny_spec()
    spec["nodes"][0]["kernell"] = 3             # typo'd attr, not default
    with pytest.raises(GraphError):
        import_source(spec)
    spec = tiny_spec()
    spec["nodes"].append({"op": "relu", "name": "dangling",
                          "input": "p1"})       # two unconsumed terminals
    with pytest.raises(GraphError):
        import_source(spec)


# ---------------------------------------------------------------------------
# Lowering: normalization onto the engine contract
# ---------------------------------------------------------------------------


def test_lowering_folds_relu_and_pool_into_engine_chain():
    model, params = import_source(tiny_spec())
    assert params is None                       # spec carries no weights
    assert [(l.name, l.kind) for l in model.layers] == \
        [("c1", "conv"), ("p1", "pool"), ("f1", "fc")]
    assert model.layers[2].in_ch == 64          # flatten folded into fc


def test_relu_folds_through_max_pool_exactly():
    """conv -> pool -> relu is legal: max and ReLU commute, so the fold
    into the conv's epilogue is semantics-preserving."""
    spec = tiny_spec()
    spec["nodes"] = [
        spec["nodes"][0],
        {"op": "maxpool", "name": "p1", "input": "c1",
         "kernel": 2, "stride": 2},
        {"op": "relu", "name": "r1", "input": "p1"},
        {"op": "flatten", "name": "fl", "input": "r1"},
        spec["nodes"][4],
    ]
    model, _ = import_source(spec)
    assert [l.name for l in model.layers] == ["c1", "p1", "f1"]


def test_engine_relu_contract_is_enforced():
    # Missing ReLU on a hidden layer: the engine cannot skip its fused
    # epilogue ReLU.
    spec = tiny_spec()
    del spec["nodes"][1]
    spec["nodes"][1]["input"] = "c1"
    with pytest.raises(UnsupportedOpError) as ei:
        import_source(spec)
    assert "c1" in str(ei.value)
    # Trailing ReLU on the final layer: the final engine emits raw
    # accumulators.
    spec = tiny_spec()
    spec["nodes"].append({"op": "relu", "name": "r9", "input": "f1"})
    with pytest.raises(UnsupportedOpError) as ei:
        import_source(spec)
    assert "f1" in str(ei.value)


def test_engine_unrepresentable_ops_rejected_with_reason():
    spec = tiny_spec()
    spec["nodes"][2] = {"op": "avgpool", "name": "p1", "input": "r1",
                        "kernel": 2, "stride": 2}
    with pytest.raises(UnsupportedOpError) as ei:
        import_source(spec)
    assert "max-only" in str(ei.value)

    # Fan-out (residual topology) cannot map onto the linear chain.
    spec = tiny_spec()
    spec["nodes"] = [
        spec["nodes"][0],
        {"op": "relu", "name": "r1", "input": "c1"},
        {"op": "add", "name": "res", "inputs": ["r1", "c1"]},
    ]
    with pytest.raises(UnsupportedOpError) as ei:
        import_source(spec)
    assert "c1" in str(ei.value)


def test_illegal_padding_rejected_not_shifted():
    """A declared pad the engine's output arithmetic cannot reproduce
    must be refused — silently shifting windows would compute a
    different model."""
    spec = tiny_spec()
    # k3 s2 p1 on 8: out = 4, but the engine derives need=1 -> (0, 1)
    # from that output, not the declared (1, 1).
    spec["nodes"][0]["stride"] = 2
    spec["nodes"][0]["padding"] = 1
    with pytest.raises(UnsupportedOpError) as ei:
        import_source(spec)
    assert "shift" in str(ei.value)


# ---------------------------------------------------------------------------
# The acceptance pin: import -> compile -> golden -> serve, no onnx
# ---------------------------------------------------------------------------


def test_lenet_round_trip_golden_bit_exact():
    """The examples/lenet.json spec (a non-paper CNN) compiles through
    compile_model and its int8 execution reproduces the generated
    golden bit-exactly across independent MAC routes (f32 generate,
    int32-oracle verify)."""
    model, params = import_source(LENET_SPEC)
    assert model.name == "lenet" and params is None
    prog = compiler.quantize(model, seed=0, device="cpu")
    golden = compiler.make_golden(prog, seed=0, route="f32")
    assert golden["acc_sample"].dtype == np.int32
    assert len(golden["acc_sample"]) == min(
        compiler.calibrate.N_ACC_SAMPLE, 10)   # 10 logits in frame 0
    # Bit-exact across routes — and deterministic from (spec, seed):
    # recompiling from scratch reproduces the identical artifact.
    compiler.check_golden(prog, golden, seed=0, route="oracle")
    prog2 = compiler.quantize(*import_source(LENET_SPEC), seed=0,
                              device="cpu")
    golden2 = compiler.make_golden(prog2, seed=0, route="f32")
    assert int(golden["acc_crc"]) == int(golden2["acc_crc"])
    assert np.array_equal(golden["acc_sample"], golden2["acc_sample"])


def test_golden_mismatch_is_detected():
    model, _ = import_source(tiny_spec())
    prog = compiler.quantize(model, seed=0, device="cpu")
    golden = compiler.make_golden(prog, seed=0)
    bad = dict(golden)
    bad["acc_crc"] = int(golden["acc_crc"]) ^ 1
    with pytest.raises(GoldenMismatch) as ei:
        compiler.check_golden(prog, bad, seed=0)
    assert "acc_crc" in str(ei.value)


def test_golden_save_load_round_trip(tmp_path):
    model, _ = import_source(tiny_spec())
    prog = compiler.quantize(model, seed=0, device="cpu")
    golden = compiler.make_golden(prog, seed=0)
    path = tmp_path / "tiny_golden.npz"
    compiler.save_golden(path, golden)
    compiler.check_golden(prog, compiler.load_golden(path), seed=0)


def test_registry_serve_smoke_imported_model():
    """The end of the pipeline: register_imported puts the compiled +
    golden-checked program in the zoo, build_server serves it, and
    Server.submit resolves completed."""
    reg = ProgramRegistry()
    name, golden = reg.register_imported(tiny_spec(), seed=0, device="cpu")
    assert name == "tinynet" and name in reg
    assert int(golden["acc_crc"]) != 0
    with pytest.raises(ValueError):             # duplicate id refused
        reg.register_imported(tiny_spec(), seed=0, device="cpu")
    cfg = ServerConfig(batch=4, stages=1, calib_frames=12)
    srv = build_server(reg, cfg)                # no stream: derived from
    try:                                        # the imported model
        frames = synthetic_stream_like(reg.get(name).model, 3, seed=0)
        reqs = [srv.submit(name, f) for f in frames]
        for r in reqs:
            r.result(timeout=120)
        assert all(r.outcome == "completed" for r in reqs)
        st = srv.stats()
        assert st["models"][name]["completed"] == 3
    finally:
        srv.close()


def test_register_imported_golden_check_catches_broken_program(monkeypatch):
    """The cross-route check is live: if verification cannot reproduce
    the golden, the model never enters the zoo."""
    reg = ProgramRegistry()
    real = compiler.check_golden

    def sabotaged(prog, golden, **kw):
        bad = dict(golden)
        bad["acc_crc"] = int(golden["acc_crc"]) ^ 1
        real(prog, bad, **kw)

    monkeypatch.setattr("repro_torch.compiler.check_golden", sabotaged)
    with pytest.raises(GoldenMismatch):
        reg.register_imported(tiny_spec(), seed=0, device="cpu")
    assert len(reg) == 0


# ---------------------------------------------------------------------------
# ONNX path (skips cleanly when onnx is absent)
# ---------------------------------------------------------------------------


def _make_lenet_onnx(path):
    import onnx
    from onnx import TensorProto, helper, numpy_helper

    rng = np.random.default_rng(0)

    def init(name, arr):
        return numpy_helper.from_array(arr.astype(np.float32), name)

    inits = [
        init("w1", rng.standard_normal((4, 1, 3, 3)) * 0.1),   # OIHW
        init("b1", rng.standard_normal((4,)) * 0.1),
        init("w2", rng.standard_normal((10, 64)) * 0.1),       # (out, in)
        init("b2", rng.standard_normal((10,)) * 0.1),
    ]
    nodes = [
        helper.make_node("Conv", ["x", "w1", "b1"], ["c1"], name="c1",
                         kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
        helper.make_node("Relu", ["c1"], ["r1"], name="r1"),
        helper.make_node("MaxPool", ["r1"], ["p1"], name="p1",
                         kernel_shape=[2, 2], strides=[2, 2]),
        helper.make_node("Flatten", ["p1"], ["fl"], name="fl"),
        helper.make_node("Gemm", ["fl", "w2", "b2"], ["y"], name="fc",
                         transB=1),
    ]
    graph = helper.make_graph(
        nodes, "tiny_onnx",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT,
                                       [1, 1, 8, 8])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, [1, 10])],
        initializer=inits)
    model = helper.make_model(graph)
    onnx.save(model, str(path))


def test_onnx_import_matches_reference_float_forward(tmp_path):
    """ONNX round trip: NCHW/OIHW conventions translate so the lowered
    model + imported params reproduce a reference NHWC float forward
    (same conv/pool/fc arithmetic) to float tolerance."""
    onnx = pytest.importorskip("onnx")  # noqa: F841
    import torch

    from repro_torch.core.program import float_forward

    path = tmp_path / "tiny.onnx"
    _make_lenet_onnx(path)
    model, params = import_source(str(path), device="cpu")
    assert params is not None                  # weights imported
    assert model.input_hw == 8 and model.input_ch == 1
    assert [l.kind for l in model.layers] == ["conv", "pool", "fc"]

    # Reference: the same arithmetic in NHWC numpy, weights straight
    # from the initializers the file was built with.
    rng = np.random.default_rng(0)
    w1 = (rng.standard_normal((4, 1, 3, 3)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal((4,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((10, 64)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal((10,)) * 0.1).astype(np.float32)
    x = rng.standard_normal((1, 8, 8, 1)).astype(np.float32)

    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    conv = np.zeros((1, 8, 8, 4), np.float32)
    for i in range(8):
        for j in range(8):
            patch = xp[0, i:i + 3, j:j + 3, 0]          # (3, 3)
            for o in range(4):
                conv[0, i, j, o] = float((patch * w1[o, 0]).sum()) + b1[o]
    act = np.maximum(conv, 0.0)
    pool = act.reshape(1, 4, 2, 4, 2, 4).max(axis=(2, 4))
    flat_nchw = pool[0].transpose(2, 0, 1).reshape(-1)  # ONNX flatten order
    ref = flat_nchw @ w2.T + b2

    got = float_forward(params, model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[0], ref, rtol=1e-4, atol=1e-4)


def test_onnx_import_serves_end_to_end(tmp_path):
    pytest.importorskip("onnx")
    path = tmp_path / "tiny.onnx"
    _make_lenet_onnx(path)
    reg = ProgramRegistry()
    name, golden = reg.register_imported(str(path), device="cpu")
    assert name == "tiny"
    cfg = ServerConfig(batch=4, stages=1, calib_frames=12)
    srv = build_server(reg, cfg)
    try:
        frame = synthetic_stream_like(reg.get(name).model, 1, seed=0)[0]
        assert srv.submit(name, frame).result(timeout=120) is not None
    finally:
        srv.close()


def test_onnx_absent_raises_plain_import_error(monkeypatch):
    """The guarded path: with onnx unavailable the JSON pipeline is
    untouched and load_onnx raises ImportError, not a crash."""
    from repro_torch.compiler import onnx_import
    monkeypatch.setattr(onnx_import, "onnx_available", lambda: False)
    with pytest.raises(ImportError):
        onnx_import.load_onnx("whatever.onnx")
    # and the dependency-free path still works end to end
    model, _ = import_source(tiny_spec())
    assert model.name == "tinynet"


# ---------------------------------------------------------------------------
# Parity with the reference, the kernel route, and the launcher
# ---------------------------------------------------------------------------


def _reference_compiler():
    from repro import compiler as compiler_j
    return compiler_j


def test_spec_lowers_to_the_reference_engine_chain():
    import dataclasses
    cj = _reference_compiler()
    for spec in (LENET_SPEC, tiny_spec()):
        mj, pj = cj.import_source(spec)
        mt, pt = import_source(spec)
        assert pj is None and pt is None
        assert (mt.name, mt.input_hw, mt.input_ch) == \
            (mj.name, mj.input_hw, mj.input_ch)
        keys = [f.name for f in dataclasses.fields(type(mj.layers[0]))]
        assert [{k: getattr(l, k) for k in keys} for l in mt.layers] == \
            [dataclasses.asdict(l) for l in mj.layers]
        # The port's graph fields (an explicit pad, a ReLU flag, another
        # source, a skip) stay at their chain defaults on an import.
        assert all((l.pad, l.relu, l.src, l.residual) == (None,) * 4
                   for l in mt.layers)
        assert mt.gop == mj.gop


def test_lenet_golden_equals_the_reference_with_the_same_inputs():
    """With the same params and calibration batch (carried across as
    numpy), the port's golden record on LeNet equals the reference's field
    for field: ``acc_sample``, ``acc_crc``, ``top1``, ``e_input``,
    ``e_out``; the reference's f32 golden reproduces on each of the port's
    routes."""
    import jax.numpy as jnp

    from repro_torch.models import cnn as cnn_t
    cj = _reference_compiler()
    mt, _ = import_source(LENET_SPEC)
    mj, _ = cj.import_source(LENET_SPEC)
    params = cnn_t.init_params_np(mt, 0)
    rng = np.random.default_rng(11)
    for p in params.values():   # nonzero biases exercise bias_q
        p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(np.float32)
    calib = compiler.calibrate.calib_batch(mt, 1, seed=0)
    pj = cj.quantize(mj, {n: {k: jnp.asarray(v) for k, v in p.items()}
                          for n, p in params.items()},
                     seed=0, calib=jnp.asarray(calib))
    pt = compiler.quantize(mt, cnn_t.params_from_numpy(params, "cpu"),
                           seed=0, calib=calib, device="cpu")
    want = cj.make_golden(pj, seed=0, route="f32")
    got = compiler.make_golden(pt, seed=0, route="f32")
    assert set(got) == set(want)
    for key in ("acc_sample", "acc_crc", "top1", "e_input", "e_out"):
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for route in ("f32", "oracle", "kernel"):
        compiler.check_golden(pt, want, seed=0, route=route)


def test_unseeded_import_draws_numpy_not_the_reference():
    """The recorded divergence: an import without params or calib draws
    seeded numpy (``init_params_np``, ``default_rng(seed + 1)``), so it is
    deterministic per seed but not the reference's ``jax.random`` draw;
    the golden frames are the reference's."""
    import torch

    from repro_torch.models import cnn as cnn_t
    cj = _reference_compiler()
    mt, _ = import_source(LENET_SPEC)
    calib = compiler.calibrate.calib_batch(mt, 1, seed=0)
    np.testing.assert_array_equal(
        calib, np.random.default_rng(1).standard_normal(
            (1, 28, 28, 1), dtype=np.float32))
    prog = compiler.quantize(mt, seed=0, device="cpu")
    want = compiler.quantize(mt, cnn_t.params_from_numpy(
        cnn_t.init_params_np(mt, 0), "cpu"), calib=calib, seed=0,
        device="cpu")
    assert prog.e_input == want.e_input
    for a, b in zip(prog.steps, want.steps):
        if a.kind != "pool":
            assert torch.equal(a.wq, b.wq) and a.e_out == b.e_out
    np.testing.assert_array_equal(
        compiler.golden_frames(mt, seed=0),
        cj.golden_frames(cj.import_source(LENET_SPEC)[0], seed=0))


def test_import_model_launcher_on_cpu(capsys, tmp_path):
    """``import_model --spec examples/lenet.json --device cpu``: import,
    the cross-route golden check, a saved golden that reloads and checks
    on the kernel route, and the serve smoke through ``build_server``."""
    import json

    from repro_torch.launch import import_model
    out = tmp_path / "lenet_golden.npz"
    assert import_model.main(["--spec", LENET_SPEC, "--device", "cpu",
                              "--golden-out", str(out), "--json"]) == 0
    text = capsys.readouterr().out
    res = json.loads(text[text.index("{"):])
    assert res["model"] == "lenet" and res["device"] == "cpu"
    assert res["golden"]["checked"] and res["params"] == "seeded"
    assert res["serve"]["completed"] == 8
    assert res["serve"]["outcomes"] == ["completed"]
    assert res["serve"]["route"] == "f32"
    model, _ = import_source(LENET_SPEC)
    prog = compiler.quantize(model, seed=0, device="cpu")
    compiler.check_golden(prog, compiler.load_golden(out), seed=0,
                          route="kernel")
    with pytest.raises(SystemExit):
        import_model.main([LENET_SPEC, "--spec", LENET_SPEC])


def test_import_model_needs_a_gpu_without_device(monkeypatch):
    import torch

    from repro_torch.launch import import_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import_model.main(["--spec", LENET_SPEC, "--serve-frames", "0"])


def test_imported_model_at_bits16_is_refused_as_in_the_reference():
    """``register_imported`` makes its golden on the f32 route, which
    bits=16 does not have: both packages refuse a bits=16 import with
    ``NotImplementedError`` before anything is registered."""
    from repro.serving import ProgramRegistry as RegistryJ
    for reg, kw in ((RegistryJ(), {}), (ProgramRegistry(),
                                        {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="f32"):
            reg.register_imported(LENET_SPEC, bits=16, seed=0, **kw)
        assert len(reg) == 0
