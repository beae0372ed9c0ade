"""The port's serving slice against the reference: ``EngineExecutor`` on a
tiny model gives the same logits and top-1 ids as the JAX executor,
padded tail batch included; parameters carry across with
``params_from_numpy``; the launcher runs the single-executor path and
refuses a bit width other than 8 and 16. Every comparison is exact."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as prog_j
from repro.core.executor import EngineExecutor as ExecutorJ
from repro.models import cnn as cnn_j
from repro_torch.core import program as prog_t
from repro_torch.core.executor import EngineExecutor as ExecutorT
from repro_torch.kernels.conv2d_int8.kernel import gemm_int8
from repro_torch.launch import serve_cnn
from repro_torch.models import cnn as cnn_t
from test_torch_program import _tiny


@pytest.mark.parametrize("route", ["kernel", "f32", "oracle"])
def test_executor_matches_reference_with_padded_tail(route):
    mj, mt, params, calib, _ = _tiny()
    frames = np.random.default_rng(2).standard_normal(
        (11, 16, 16, 3)).astype(np.float32)       # 11 = 2 full + a tail of 3
    pj = prog_j.compile_model(
        mj, {n: {k: jnp.asarray(v) for k, v in p.items()}
             for n, p in params.items()}, calib_batch=jnp.asarray(calib))
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              calib_batch=calib, device="cpu")
    want = ExecutorJ(pj, batch_size=4, route="oracle",
                     output="logits").serve(frames)
    ex = ExecutorT(pt, batch_size=4, route=route, output="logits")
    got = ex.serve(frames)
    assert len(got) == len(want) == 11
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert (ex.stats.batches, ex.stats.frames, ex.stats.padded_frames) == \
        (3, 11, 1)
    top1 = ExecutorT(pt, batch_size=4, route=route).serve(frames)
    np.testing.assert_array_equal(
        np.stack(top1), ExecutorJ(pj, batch_size=4, route="oracle").serve(
            frames))


def test_executor_chunks_drains_and_validation():
    """Pre-batched chunks and single frames mix; each drain returns its own
    frames in order, and bad shapes and options are refused."""
    _, mt, params, calib, frames = _tiny()
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              calib_batch=calib, device="cpu")
    want = pt.compile_runner().classify(frames)
    ex = ExecutorT(pt, batch_size=4)
    ex.submit(frames[:3])                       # one [N, H, W, C] chunk
    ex.submit(frames[3])                        # one [H, W, C] frame
    np.testing.assert_array_equal(np.stack(ex.drain()), want[:4])
    np.testing.assert_array_equal(np.stack(ex.serve(frames[4:])), want[4:])
    assert (ex.stats.batches, ex.stats.frames, ex.stats.padded_frames) == \
        (2, 5, 3)
    with pytest.raises(ValueError):
        ex.submit(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError):
        ex.submit_batch(frames, 5)              # 5 frames > batch of 4
    with pytest.raises(ValueError):
        ExecutorT(pt, output="probs")


def test_params_from_numpy_round_trips():
    """The reference's own ``jax.random`` params carry across unchanged."""
    mj, _, _, _, _ = _tiny()
    ref = cnn_j.init_params(mj, jax.random.PRNGKey(0))
    carried = cnn_t.params_from_numpy(ref, "cpu")
    assert carried.keys() == ref.keys()
    for name, p in ref.items():
        for k, v in p.items():
            t = carried[name][k]
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(v))


def test_init_params_seeded_and_deterministic():
    from repro_torch.core import workload as Wt
    _, mt, _, _, _ = _tiny()
    a = cnn_t.init_params(mt, 0, device="cpu")
    b = cnn_t.init_params(mt, 0, device="cpu")
    c = cnn_t.init_params(mt, 1, device="cpu")
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert not torch.equal(a[name]["w"], c[name]["w"])
    alex = cnn_t.init_params_np(Wt.CNN_MODELS["alexnet"](), 0)
    assert alex["conv1"]["w"].shape == (11, 11, 3, 96)          # HWIO
    assert alex["conv2"]["w"].shape == (5, 5, 48, 256)          # grouped
    assert alex["fc6"]["w"].shape == (9216, 4096)               # [F, M]


def test_launcher_serves_alexnet_on_cpu_through_the_plain_kernel(capsys):
    before = gemm_int8.launches
    assert serve_cnn.main(["--quick", "--device", "cpu",
                           "--route", "kernel"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["route"] == "kernel" and result["device"] == "cpu"
    assert (result["frames"], result["batches"]) == (8, 2)
    assert len(result["sample_top1"]) == 4
    assert gemm_int8.launches == before     # CPU tensors launch no kernel


def test_serve_returns_the_served_outputs():
    """``return_outputs`` hands back every served frame's logits, equal to
    the oracle route of the same program on the same frames."""
    from repro_torch.serving import server
    result = server.serve("alexnet", frames=6, batch=4, output="logits",
                          device="cpu", verbose=False, return_outputs=True)
    prog = server.compile_for_serving("alexnet", device="cpu")
    want = prog.compile_runner(route="oracle").logits(
        server.synthetic_stream("alexnet", 6))
    assert result["outputs"].shape == (6, 1000)
    np.testing.assert_array_equal(result["outputs"], want)
    assert result["sample_top1"] == [int(t) for t in want[:4].argmax(-1)]


def test_launcher_refuses_unported_paths():
    """The command line refuses a bit width the engine has no format for
    (8 and 16 are served) before any serve path is chosen."""
    with pytest.raises(SystemExit) as e:
        serve_cnn.main(["--device", "cpu", "--bits", "4"])
    assert e.value.code == 2
