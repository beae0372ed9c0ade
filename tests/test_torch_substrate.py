"""The port's training substrate against the reference's: the data streams
(the same tokens and embeddings for the same config, bit for bit),
checkpoints (round trip, garbage collection, incomplete steps, a params
file written by ``repro.checkpointing.save`` restored by the port), the
restartable loop, ``elastic_replan`` and ``lm_layer_workloads``; and the
counterparts of the reference's training cases in ``tests/test_system.py``
and ``tests/test_substrate.py``, on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpointing as ckpt_j
from repro.configs import ARCHS as ARCHS_J
from repro.configs import reduced as reduced_j
from repro.core import workload as workload_j
from repro.data import pipeline as data_j
from repro.models import transformer as TJ
from repro.runtime import fault_tolerance as ft_j
from repro_torch import checkpointing as ckpt
from repro_torch import optim
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import workload as workload_t
from repro_torch.data.pipeline import (DataConfig, EmbedStream, TokenStream,
                                       make_stream)
from repro_torch.launch import steps as STEPS
from repro_torch.launch import train as train_t
from repro_torch.models import transformer as T
from repro_torch.runtime.fault_tolerance import (InjectedCrash, RunState,
                                                 StragglerDetector,
                                                 elastic_replan, run_loop)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# -- data ---------------------------------------------------------------------

def test_stream_deterministic_and_seekable():
    dc = DataConfig(global_batch=4, seq_len=8, vocab=100)
    s1, s2 = TokenStream(dc, "cpu"), TokenStream(dc, "cpu")
    a = [next(s1)["tokens"] for _ in range(3)]
    s2.seek(2)
    assert s2.step == 2
    assert torch.equal(a[2], next(s2)["tokens"])


def test_stream_host_shards_disjoint():
    d0 = DataConfig(global_batch=8, seq_len=4, vocab=1000, n_hosts=2,
                    host_id=0)
    d1 = dataclasses.replace(d0, host_id=1)
    b0, b1 = next(TokenStream(d0, "cpu")), next(TokenStream(d1, "cpu"))
    assert b0["tokens"].shape == (4, 4)
    assert not torch.equal(b0["tokens"], b1["tokens"])


@pytest.mark.parametrize("kw", [{}, {"zipf_alpha": 1.1},
                                {"n_hosts": 2, "host_id": 1}])
def test_tokens_equal_the_references(kw):
    dc = dict(global_batch=4, seq_len=8, vocab=100, **kw)
    st = TokenStream(DataConfig(**dc), "cpu")
    sj = data_j.TokenStream(data_j.DataConfig(**dc))
    for _ in range(3):
        bt, bj = next(st), next(sj)
        for k in ("tokens", "labels"):
            assert bt[k].dtype == torch.int32
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_embed_streams_equal_the_references(arch):
    """The VLM's patch embeddings and positions, the encoder-decoder's
    frames: bf16 rounded from the same float32 draws, bit for bit."""
    cfg_t, cfg_j = reduced(ARCHS[arch]), reduced_j(ARCHS_J[arch])
    dc = dict(global_batch=2, seq_len=8, vocab=cfg_t.vocab)
    st = make_stream(cfg_t, DataConfig(**dc), device="cpu")
    sj = data_j.make_stream(cfg_j, data_j.DataConfig(**dc))
    assert isinstance(st, EmbedStream)
    bt, bj = next(st), next(sj)
    assert set(bt) == set(bj)
    for k in bt:
        if bt[k].is_floating_point():
            assert bt[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(bt[k]),
                                      np.asarray(bj[k], np.float32)
                                      if bt[k].is_floating_point()
                                      else np.asarray(bj[k]))


def test_make_stream_refuses_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_stream(reduced(ARCHS["yi-6b"]), DataConfig(2, 4, 10))


# -- checkpointing ------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            "layers": [{"x": torch.ones(2)}, {"x": torch.zeros(2)}]}
    ckpt.save(str(tmp_path), 10, tree)
    assert ckpt.latest_step(str(tmp_path)) == 10
    got = ckpt.restore(str(tmp_path), 10, tree)
    assert torch.equal(got["w"], tree["w"])
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(got["layers"][0]["x"], torch.ones(2))
    # bf16 is widened to float32 in the file, as the reference writes it.
    with np.load(tmp_path / "step_10" / "shard_0.npz") as z:
        assert z["nested/b"].dtype == np.float32
        assert sorted(z.files) == ["layers/0/x", "layers/1/x", "nested/b",
                                   "w"]


def test_checkpoint_of_the_train_state_roundtrips(tmp_path):
    """(params, AdamWState) with int8 moments: every leaf back in its dtype,
    the state's fields named as the reference names them (".step")."""
    cfg = reduced(ARCHS["deepseek-v2-236b"])
    params = T.init_params(cfg, seed=0, device="cpu")
    state = (params, optim.adamw_init(params, "int8"))
    ckpt.save(str(tmp_path), 3, state)
    like = (T.init_params(cfg, seed=1, device="meta"),
            optim.adamw_init(T.init_params(cfg, seed=1, device="meta"),
                             "int8"))
    got = ckpt.restore(str(tmp_path), 3, like, device="cpu")
    items = ckpt.checkpoint._items
    assert [p for p, _ in items(state)] == [p for p, _ in items(got)]
    for (_, a), (_, b) in zip(items(state), items(got)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    with np.load(tmp_path / "step_3" / "shard_0.npz") as z:
        assert "1/.step" in z.files and "1/.mu/embed/q" in z.files


def test_checkpoint_gc_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == [4, 5]


def test_checkpoint_incomplete_ignored(tmp_path):
    tree = {"x": torch.zeros(2)}
    ckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_99.tmp", exist_ok=True)
    os.makedirs(tmp_path / "step_7", exist_ok=True)     # no manifest
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_restore_refuses_another_shape(tmp_path):
    """A leaf whose saved shape is not the state's raises; ``skeleton``
    gives a ``like`` that holds no memory and restores the same values."""
    tree = {"w": torch.arange(12.0).reshape(3, 4), "n": torch.zeros(())}
    ckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(4, 3),
                                        "n": torch.zeros(())})
    like, device = ckpt.skeleton(tree)
    assert like["w"].device.type == "meta" and device == torch.device("cpu")
    got = ckpt.restore(str(tmp_path), 1, like, device=device)
    assert torch.equal(got["w"], tree["w"]) and got["n"].shape == ()


def test_reference_params_file_restores_in_the_port(tmp_path):
    """A params tree written by ``repro.checkpointing.save`` (segments
    stacked, bf16 widened) restores into the port's per-layer tree with
    the same values and dtypes."""
    cfg_j = reduced_j(ARCHS_J["recurrentgemma-2b"])
    cfg_t = reduced(ARCHS["recurrentgemma-2b"])
    pj = TJ.init_params(cfg_j, jax.random.PRNGKey(0))
    ckpt_j.save(str(tmp_path / "ref"), 1, pj)
    got = ckpt.restore(str(tmp_path / "ref"), 1,
                       T.init_params(cfg_t, seed=5, device="cpu"))
    want = T.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")

    def check(a, b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    optim.adamw.tree_map(check, got, want)


# -- fault tolerance ----------------------------------------------------------

def test_run_loop_crash_restart(tmp_path):
    dc = DataConfig(global_batch=2, seq_len=4, vocab=10)
    stream = TokenStream(dc, "cpu")
    state = {"w": torch.zeros(2), "n": torch.zeros(())}
    seen = []

    def step_fn(state, batch):
        seen.append(int(batch["tokens"][0, 0]))
        return {"w": state["w"] + 1, "n": state["n"] + 1}, {}

    state, rs = run_loop(state=state, step_fn=step_fn, stream=stream,
                         ckpt_dir=str(tmp_path), total_steps=10,
                         ckpt_every=2, fail_at={5: "crash"},
                         log=lambda s: None)
    assert rs.restarts == 1
    assert float(state["n"]) >= 10  # every step executed (some replayed)
    # The replay re-reads steps 4.. from the seekable stream: the tokens
    # seen equal the reference's loop's, step for step.
    seen_j = []

    def step_j(state, batch):
        seen_j.append(int(batch["tokens"][0, 0]))
        return {"w": state["w"] + 1, "n": state["n"] + 1}, {}

    ft_j.run_loop(state={"w": jnp.zeros(2), "n": jnp.zeros(())},
                  step_fn=step_j, stream=data_j.TokenStream(
                      data_j.DataConfig(global_batch=2, seq_len=4, vocab=10)),
                  ckpt_dir=str(tmp_path / "ref"), total_steps=10,
                  ckpt_every=2, fail_at={5: "crash"}, log=lambda s: None)
    assert seen == seen_j


def test_run_loop_raises_what_it_did_not_inject(tmp_path):
    """Only the injected crash (``InjectedCrash``) restarts the loop: any
    other error reaches the caller at once, with no retry."""
    calls = []

    def step_fn(state, batch):
        calls.append(1)
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed") as info:
        run_loop(state={"n": torch.zeros(())}, step_fn=step_fn,
                 stream=TokenStream(DataConfig(2, 4, 10), "cpu"),
                 ckpt_dir=str(tmp_path), total_steps=3, ckpt_every=1,
                 log=lambda s: None)
    assert not isinstance(info.value, InjectedCrash)
    assert calls == [1] and ckpt.latest_step(str(tmp_path)) is None


def test_run_loop_straggler_and_shrink_injection(tmp_path):
    logs = []
    rescaled = []

    def step_fn(state, batch):
        return {"n": state["n"] + 1}, {}

    def on_rescale(state):
        rescaled.append(int(state["n"]))
        return state

    state, rs = run_loop(state={"n": torch.zeros(())}, step_fn=step_fn,
                         stream=TokenStream(DataConfig(2, 4, 10), "cpu"),
                         ckpt_dir=str(tmp_path), total_steps=6, ckpt_every=3,
                         fail_at={2: "straggler", 4: "shrink"},
                         on_rescale=on_rescale, log=logs.append)
    assert isinstance(rs, RunState)
    assert (rs.step, rs.restarts, rs.rescales) == (6, 0, 1)
    assert rescaled == [5]
    assert any("elastic rescale at step 4" in s for s in logs)
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_straggler_detector_matches_reference():
    dt, dj = StragglerDetector(), ft_j.StragglerDetector()
    for obs in ({0: 1.0, 1: 1.1}, {0: 1.0, 1: 5.0}, {0: 1.0, 1: 9.0, 2: 1.2}):
        assert dt.observe(obs) == dj.observe(obs)


def test_elastic_replan():
    plan_full = elastic_replan(ARCHS["yi-6b"], 256, seq_len=4096,
                               global_batch=256)
    plan_small = elastic_replan(ARCHS["yi-6b"], 128, seq_len=4096,
                                global_batch=256)
    assert plan_full.n_stages * plan_full.tensor_parallel == 16
    assert plan_small.n_stages * plan_small.tensor_parallel in (8, 16)


@pytest.mark.parametrize("arch,chips", [("yi-6b", 256), ("yi-6b", 96),
                                        ("recurrentgemma-2b", 16),
                                        ("deepseek-v3-671b", 512)])
def test_elastic_replan_equals_the_references(arch, chips):
    got = elastic_replan(ARCHS[arch], chips, seq_len=4096, global_batch=256)
    want = ft_j.elastic_replan(ARCHS_J[arch], chips, seq_len=4096,
                               global_batch=256)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_layer_workloads_equal_the_references(arch, mode):
    got = workload_t.lm_layer_workloads(ARCHS[arch], seq_len=4096, batch=8,
                                        mode=mode)
    want = workload_j.lm_layer_workloads(ARCHS_J[arch], seq_len=4096,
                                         batch=8, mode=mode)
    assert [dataclasses.asdict(x) for x in got] == \
        [dataclasses.asdict(x) for x in want]


# -- end to end (the reference's tests/test_system.py) ------------------------

def _train(arch, tmp_path, steps=30, fail_at=None):
    cfg = reduced(ARCHS[arch]).scaled(vocab=64)
    params = T.init_params(cfg, seed=0, device="cpu")
    opt = optim.adamw_init(params, cfg.opt_moment_dtype)
    dc = DataConfig(global_batch=4, seq_len=16, vocab=cfg.vocab)
    stream = make_stream(cfg, dc, device="cpu")
    step = STEPS.make_train_step(cfg, lr=1e-3, remat=False)
    losses = []

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
        return (p, o), m

    _, rs = run_loop(state=(params, opt), step_fn=step_fn, stream=stream,
                     ckpt_dir=str(tmp_path), total_steps=steps,
                     ckpt_every=10, fail_at=fail_at, log=lambda s: None)
    return losses, rs


def test_training_reduces_loss(tmp_path):
    losses, rs = _train("qwen3-1.7b", tmp_path, steps=40)
    first = sum(losses[:5]) / 5
    last = sum(losses[-5:]) / 5
    assert last < first, (first, last)
    assert rs.restarts == 0


def test_training_survives_crash(tmp_path):
    losses, rs = _train("yi-6b", tmp_path, steps=25, fail_at={15: "crash"})
    assert rs.restarts == 1
    assert len(losses) >= 25  # replayed steps counted too


def test_train_launcher_on_the_cpu(tmp_path):
    """``launch/train.py`` reduced on the CPU: finite losses, no kernel
    launch, and a second call on the same directory resumes from its last
    checkpoint (nothing left to run)."""
    args = ["--arch", "recurrentgemma-2b", "--reduced", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    out = train_t.main(args)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all()
    assert all(set(n.values()) == {0} for n in out["launches"])
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    assert train_t.main(args)["losses"] == []
