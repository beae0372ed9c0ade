"""The expert-parallel MoE against the JAX reference: the port's
``_moe_expert_parallel``, shard by shard, against the reference's run on
one CPU device under ``jax.vmap(..., axis_name="model")`` over the expert
stacks reshaped to [T, E/T, ...] (its ``axis_index`` and ``psum`` work
there), on reduced DeepSeek-V2 and V3 at T 2 and 4, float32, with the
reference's weights carried across. The routing of every shard (top-k
ids, its dispatch table, the choices it keeps) is exact; the combined
output and the aux loss are held within float32 rounding, the distance
measured and bounded (the port adds each token's choices in ascending
expert id within a shard, then the shards; the reference scatter-adds
within a shard, then psums). The gradient through the shards equals
``_moe_local``'s, and ``moe_apply`` takes the expert-parallel path under
a mesh whose ``model`` axis has more than one rank and stays local on a
one-rank mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import layers as LJ
from repro_torch.launch import mesh as M
from repro_torch.models import layers as LT
from repro_torch.runtime import sharding as SH
from test_torch_families import B, _both

# Measured at float32 on these cases (``measure()`` below prints them):
# the combined output at most 4.4e-7 of its largest |y| from the
# reference's, and from ``_moe_local``'s 0 at top-2 (one add a token
# either way) and 1.0e-7 at top-6 (the shards' partial sums associate the
# six adds otherwise: about 1 ulp at the largest |y|); the aux loss
# within 1.6e-7 of the reference's. The bounds carry a factor of 2-3.
Y_REL_TOL = 1e-6
AUX_RTOL = 5e-7
GRAD_REL_TOL = 1e-5
TOP6 = {"moe_n_experts": 8, "moe_top_k": 6}
CASES = [("deepseek-v2-236b", {}, cf) for cf in (8.0, 1.0)] + [
    ("deepseek-v3-671b", {}, 8.0), ("deepseek-v2-236b", TOP6, 8.0)]


def _setup(arch: str, capacity_factor: float, **scaled):
    cfg_j, cfg_t, pj, pt = _both(arch, moe_capacity_factor=capacity_factor,
                                 **scaled)
    pj = jax.tree.map(lambda a: a[0], pj["seg1"]["mlp"])
    pt = pt["seg1"][0]["mlp"]
    x = np.random.default_rng(13).standard_normal(
        (B, 12, cfg_t.d_model)).astype(np.float32)
    return cfg_j, cfg_t, pj, pt, x


def _shard(p: dict, r: int, T: int) -> dict:
    """The port's params of expert shard r of T (the router and the shared
    experts whole)."""
    E_loc = p["wi"].shape[0] // T
    return {k: (v[r * E_loc:(r + 1) * E_loc]
                if k in ("wi", "wg", "wo") else v)
            for k, v in p.items() if k != "shared"}


def _reference(pj, cfg_j, x, T: int):
    """The reference's per-shard outputs [T, B, S, D] and aux losses [T]
    under ``jax.vmap`` over the ``model`` axis."""
    stacked = {k: (v.reshape(T, -1, *v.shape[1:])
                   if k in ("wi", "wg", "wo") else v) for k, v in pj.items()}
    axes = {k: (0 if k in ("wi", "wg", "wo") else None) for k in pj}

    def run(p):
        return LJ._moe_expert_parallel(p, cfg_j, jnp.asarray(x),
                                       axis="model", n_shards=T)

    y, aux = jax.jit(jax.vmap(run, in_axes=(axes,), axis_name="model"))(
        stacked)
    return np.asarray(y), np.asarray(aux)


def _reference_topi(pj, cfg, xt):
    gates = jax.nn.softmax(LJ.apply_dense(pj["router"], jnp.asarray(xt)), -1)
    return np.asarray(jax.lax.top_k(gates, cfg.moe_top_k)[1])


def _combined(pt, cfg_t, x, T):
    """Every shard's part in ascending shard order, then the shared
    experts: what ``_moe_sharded``'s all-reduce and its shared add give."""
    parts = [LT._moe_expert_parallel(_shard(pt, r, T), cfg_t, x, shard=r,
                                     n_shards=T) for r in range(T)]
    y = parts[0][0]
    for part, _ in parts[1:]:
        y = y + part
    return y + LT.mlp_apply(pt["shared"], x, "swiglu"), [a for _, a in parts]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _distances(arch, scaled, capacity_factor, T) -> dict:
    """The combined output's distance (over its largest |y|) from the
    reference's on every shard and from ``_moe_local``'s, and the aux
    losses' relative distances."""
    cfg_j, cfg_t, pj, pt, x = _setup(arch, capacity_factor, **scaled)
    want_y, want_aux = _reference(pj, cfg_j, x, T)
    xt = torch.from_numpy(x)
    got_y, got_aux = _combined(pt, cfg_t, xt, T)
    local_y, local_aux = LT._moe_local(pt, cfg_t, xt)
    return {"y_vs_reference": max(_rel(got_y.numpy(), want_y[r])
                                  for r in range(T)),
            "y_vs_local": _rel(got_y.numpy(), local_y.numpy()),
            "aux_vs_reference": max(_rel(float(got_aux[r]), want_aux[r])
                                    for r in range(T)),
            "aux_vs_local": _rel(float(got_aux[0]), float(local_aux))}


@pytest.mark.parametrize("arch,scaled,capacity_factor", CASES)
@pytest.mark.parametrize("T", [2, 4])
def test_expert_parallel_matches_reference_shard_by_shard(arch, scaled,
                                                          capacity_factor, T):
    d = _distances(arch, scaled, capacity_factor, T)
    assert d["y_vs_reference"] <= Y_REL_TOL, d
    assert d["aux_vs_reference"] <= AUX_RTOL, d
    # Capacity from the same tokens: _moe_local drops what the shards do.
    assert d["y_vs_local"] <= Y_REL_TOL, d
    assert d["aux_vs_local"] <= AUX_RTOL, d


def measure() -> None:
    """Print every case's distances (``PYTHONPATH=src:tests python
    tests/test_torch_moe_parallel.py``)."""
    for arch, scaled, cf in CASES:
        for T in (2, 4):
            print(arch, scaled, cf, T, _distances(arch, scaled, cf, T))


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_shard_routing_is_exact(T, capacity_factor):
    """Each shard's routing: the reference's top-k ids, and its dispatch
    table the rows of the whole table for its experts (capacity from the
    same tokens); the shards' kept choices partition the kept ones."""
    cfg_j, cfg_t, pj, pt, x = _setup("deepseek-v2-236b", capacity_factor)
    xt = x.reshape(-1, cfg_t.d_model)
    whole = LT.moe_route(pt, cfg_t, torch.from_numpy(xt))
    E_loc = cfg_t.moe_n_experts // T
    kept = torch.zeros_like(whole["kept"], dtype=torch.int64)
    for r in range(T):
        route = LT.moe_route_shard(pt, cfg_t, torch.from_numpy(xt), r, T)
        np.testing.assert_array_equal(route["topi"].numpy(),
                                      _reference_topi(pj, cfg_j, xt))
        rows = slice(r * E_loc, (r + 1) * E_loc)
        valid = whole["valid"][rows]
        assert route["C"] == whole["C"]
        assert torch.equal(route["valid"], valid)
        assert torch.equal(route["tok_idx"][valid], whole["tok_idx"][rows][
            valid])
        mine = (whole["topi"] >= r * E_loc) & (whole["topi"] < (r + 1) * E_loc)
        assert torch.equal(route["kept"], whole["kept"] & mine)
        kept += route["kept"]
    assert torch.equal(kept.bool(), whole["kept"]) and int(kept.max()) <= 1
    if capacity_factor < 8.0:
        assert not whole["kept"].all()      # the drops are exercised


@pytest.mark.parametrize("T", [2, 4])
def test_expert_parallel_gradient_is_moe_locals(T):
    """d(sum(c * y) + aux) through the shards equals it through
    ``_moe_local``, for x and every parameter, at a capacity that drops
    nothing."""
    _, cfg_t, _, pt, x = _setup("deepseek-v2-236b", 8.0)
    c = torch.from_numpy(np.random.default_rng(3).standard_normal(
        x.shape).astype(np.float32))

    def grads(fn):
        leaves = {"x": torch.from_numpy(x).requires_grad_()}
        p = {k: (v.clone().requires_grad_() if k not in ("router", "shared")
                 else {n: ({m: t.clone().requires_grad_()
                            for m, t in w.items()} if isinstance(w, dict)
                           else w.clone().requires_grad_())
                       for n, w in v.items()})
             for k, v in pt.items()}
        y, aux = fn(p, leaves["x"])
        flat = [leaves["x"], p["router"]["w"], p["wi"], p["wg"], p["wo"],
                p["shared"]["wi"]["w"]]
        return torch.autograd.grad((c * y).sum() + aux, flat)

    want = grads(lambda p, xx: LT._moe_local(p, cfg_t, xx))
    got = grads(lambda p, xx: (lambda y, a: (y, a[0]))(
        *_combined(p, cfg_t, xx, T)))
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_REL_TOL


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_stays_local(one_rank_group):
    """Under a (1, 1) mesh ``moe_apply`` takes ``_moe_local``, as the
    reference does on one device: plain tensors directly, placed ones on
    the rank's whole batch (``_moe_replicated``), equal bit for bit."""
    _, cfg_t, _, pt, x = _setup("deepseek-v2-236b", 1.0)
    xt = torch.from_numpy(x)
    want, want_aux = LT._moe_local(pt, cfg_t, xt)
    mesh = M.make_debug_mesh(1, 1, device_type="cpu")
    LT.moe_apply.calls_by_path = {"local": 0, "expert_parallel": 0}
    with M.set_mesh(mesh):
        y, aux = LT.moe_apply(pt, cfg_t, xt)
        placed_p = SH.place(pt, SH.map_with_path(
            lambda _, t: SH.named_sharding(mesh, ()), pt))
        yp, auxp = LT.moe_apply(placed_p, cfg_t, SH.place(
            xt, SH.named_sharding(mesh, ())))
    assert LT.moe_apply.calls_by_path == {"local": 2, "expert_parallel": 0}
    assert torch.equal(y, want) and torch.equal(aux, want_aux)
    assert torch.equal(yp.full_tensor(), want)
    assert torch.equal(auxp.full_tensor(), want_aux)


def test_model_axis_takes_expert_parallel_path():
    """With two ``model`` ranks (the fake group: one process, shapes and
    dispatch real, values not), ``moe_apply`` takes ``_moe_sharded``, each
    rank holding E / 2 experts, and returns x's shape and placements; the
    combine is one all-reduce and the aux loss's mean another."""
    from torch.distributed.tensor.debug import CommDebugMode
    _, cfg_t, _, pt, x = _setup("deepseek-v2-236b", 8.0)
    with M.fake_process_group(2):
        mesh = M.make_debug_mesh(1, 2, device_type="cpu")
        LT.moe_apply.calls_by_path = {"local": 0, "expert_parallel": 0}
        seen = []
        real = LT._moe_expert_parallel

        def spy(p, cfg, xx, *, shard, n_shards):
            seen.append((tuple(p["wi"].shape), shard, n_shards))
            return real(p, cfg, xx, shard=shard, n_shards=n_shards)

        LT._moe_expert_parallel = spy
        try:
            with M.set_mesh(mesh), CommDebugMode() as cm:
                y, aux = LT.moe_apply(pt, cfg_t, torch.from_numpy(x))
        finally:
            LT._moe_expert_parallel = real
        counts = {str(k): v for k, v in cm.get_comm_counts().items()}
    assert LT.moe_apply.calls_by_path == {"local": 0, "expert_parallel": 1}
    E = cfg_t.moe_n_experts
    assert seen == [((E // 2, cfg_t.d_model, cfg_t.moe_d_ff), 0, 2)]
    assert y.shape == x.shape and aux.shape == ()
    assert counts.get("c10d_functional.all_reduce", 0) >= 2, counts


if __name__ == "__main__":
    measure()
