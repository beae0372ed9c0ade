"""The port's dry run on the ``meta`` device against the JAX reference's,
at full width on all ten configs: the input and cache specs, the
abstract training state, the sharding rules and the bytes each device
holds on the production meshes (the reference's rules evaluated on
``jax.sharding.AbstractMesh``, which needs no devices), the ``--dist dp``
and ZeRO-1 specs, the FLOPs ``FlopCounterMode`` counts, the meta
branches of the code the dry run traces, the CLI, and ``--dist
pipeline`` (the plan and K of the reference's ``_run_pipeline_cell``,
each cell's status as the reference records it, the stage hand-off
counted), and DeepSeek-V2/V3's ``train_4k`` cells traced through the
placed int8 AdamW update with the bytes and FLOPs they had before it.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
devices) when imported, so nothing here imports it: its ``--dist dp`` and
ZeRO-1 helpers are compiled from its source file alone.

Recorded divergences, held exactly:
* the port's segments are lists of per-layer leaves where the reference
  stacks them: a per-layer leaf has the stacked leaf's shape, dtype and
  spec without the leading layer dim;
* the port's cache ``idx`` and ``_pos`` are host ints (ROADMAP, "LM
  cache"): the reference's are int32 arrays, 4 bytes a layer and 4;
* int8 AdamW moments are blockwise codes of each per-layer leaf, where
  the reference codes the stacked leaf: ceil(n / 128) blocks a layer
  against ceil(L n / 128), and a shape code [ndim + 1] a layer against
  one [ndim + 2] (the blocks of the full-width configs divide alike, so
  only the shape codes' bytes differ).

Everything else is equal: specs entry for entry, bytes per device to
the byte, the skipped cells.
"""

import ast
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

import repro.models.transformer as TJ
from repro.configs import ARCHS as ARCHS_J
from repro.launch import shapes as shapes_j
from repro.launch import steps as steps_j
from repro.runtime import sharding as SH_J
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.rglru_scan.kernel import linear_scan
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shapes_t
from repro_torch.launch import steps as steps_t
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import layers as LT
from repro_torch.models import recurrent as RT
from repro_torch.models import transformer as TT
from repro_torch.runtime import sharding as SH_T

ROOT = Path(__file__).resolve().parent.parent
ALL = list(ARCHS)
MESHES = ("pod", "multipod")


# ---------------------------------------------------------------------------
# Helpers: the two packages' trees side by side
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return steps_j.abstract_state(ARCHS_J[arch])


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return steps_t.abstract_state(ARCHS[arch])


@functools.lru_cache(maxsize=None)
def _abstract_mesh(name):
    shape = production_mesh_shape(multi_pod=(name == "multipod"))
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _is_q8(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale", "shape"}


def _match(t, j, layers=0, like=None):
    """Assert that the port's node ``t`` is the reference's ``j`` (a
    ShapeDtypeStruct tree), per-layer where the reference stacks
    ``layers`` of them; ``like`` is the port's parameter tree beside an
    optimizer moment tree (the int8 moments' blocks depend on it)."""
    if isinstance(t, list):
        if like is None:
            assert jax.tree.leaves(j)[0].shape[0] == len(t)
        for i, v in enumerate(t):
            _match(v, j, len(t), None if like is None else like[i])
        return
    if isinstance(t, int):
        # A host int (the cache's idx, _pos): the reference's int32.
        assert j.dtype == jnp.int32
        assert j.shape == ((layers,) if layers else ())
        return
    if _is_q8(t):
        n, L = math.prod(like.shape), max(layers, 1)
        assert tuple(t["q"].shape) == (math.ceil(n / 128), 128)
        assert tuple(t["scale"].shape) == (math.ceil(n / 128), 1)
        assert tuple(t["shape"].shape) == (like.ndim + 1,)
        assert tuple(j["q"].shape) == (math.ceil(L * n / 128), 128)
        assert tuple(j["shape"].shape) == (like.ndim + 1 + bool(layers),)
        for k in t:
            assert _dtype_name(t[k].dtype) == str(j[k].dtype)
        return
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _match(t[k], j[k], layers, None if like is None else like[k])
        return
    shape = j.shape[1:] if layers else j.shape
    if layers:
        assert j.shape[0] == layers
    assert tuple(t.shape) == tuple(shape)
    assert t.device.type == "meta"
    assert _dtype_name(t.dtype) == str(j.dtype)


def _norm(spec, ndim) -> tuple:
    """A spec as a tuple of ndim entries, each None or a tuple of axes."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if e is None or e == ():
            out.append(None)
        else:
            out.append((e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_specs(shardings, tree) -> dict:
    """{path: (normalized spec, bytes on one device)} of the reference's
    sharding tree over its ShapeDtypeStruct tree."""
    flat_s = jax.tree_util.tree_flatten_with_path(shardings)[0]
    flat_t = jax.tree.leaves(tree)
    out = {}
    for (path, sh), leaf in zip(flat_s, flat_t):
        nbytes = math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
        out["/".join(_key(k) for k in path)] = (
            _norm(sh.spec, len(leaf.shape)), nbytes)
    return out


def _port_specs(specs, tree, mesh) -> dict:
    """{path: (normalized spec, bytes on one device)} of the port's spec
    tree over ``tree``; a per-layer list's leaves share their path, the
    bytes summed and the spec the same for every layer."""
    out = {}

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            fields = getattr(node, "_fields", None)
            for i, (v, s) in enumerate(zip(node, spec)):
                sub = path if fields is None else (
                    f"{path}/{fields[i]}" if path else fields[i])
                walk(v, s, sub)
        elif node is not None:
            nb = SH_T.shard_bytes(node, spec, mesh)
            sp = _norm(spec, len(SH_T._shape(node)))
            if path in out:
                assert out[path][0] == sp, path
                nb += out[path][1]
            out[path] = (sp, nb)

    walk(tree, specs, "")
    return out


def _unstacked(ref: dict, port: dict, stacked_paths) -> dict:
    """The reference's {path: (spec, bytes)} with the layer dim dropped
    from the specs of stacked leaves (``stacked_paths``)."""
    out = {}
    for path, (spec, nb) in ref.items():
        if path in stacked_paths:
            assert spec[0] is None, path
            spec = spec[1:]
        out[path] = (spec, nb)
    return out


def _stacked_paths(tree) -> set:
    """Paths of the leaves the port keeps in per-layer lists."""
    out = set()

    def walk(node, path, in_list):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k), in_list)
        elif isinstance(node, list):
            for v in node:
                walk(v, path, True)
        elif in_list:
            out.add(path)

    walk(tree, "", False)
    return out


# ---------------------------------------------------------------------------
# Shapes and the abstract state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL)
def test_specs_and_abstract_state_match_reference(arch):
    """``input_specs``, ``cache_specs`` and ``abstract_state`` at full
    width are the reference's ``jax.eval_shape`` trees leaf for leaf
    (shape, dtype), per-layer where it stacks; the skipped cells are its
    skipped cells."""
    cfg_j, cfg_t = ARCHS_J[arch], ARCHS[arch]
    for name, case_t in shapes_t.SHAPES.items():
        case_j = shapes_j.SHAPES[name]
        assert dataclass_tuple(case_t) == dataclass_tuple(case_j)
        ok = shapes_t.cell_is_runnable(cfg_t, name)
        assert ok == shapes_j.cell_is_runnable(cfg_j, name)
        if not ok[0]:
            continue
        _match(shapes_t.input_specs(cfg_t, case_t),
               shapes_j.input_specs(cfg_j, case_j))
        if case_t.mode != "train":
            _match(shapes_t.cache_specs(cfg_t, case_t),
                   shapes_j.cache_specs(cfg_j, case_j))
    (pj, oj), (pt, ot) = _ref_state(arch), _port_state(arch)
    _match(pt, pj)
    assert ot.err is None and oj.err is None
    assert tuple(ot.step.shape) == () and ot.step.dtype == torch.int32
    for t, j in ((ot.mu, oj.mu), (ot.nu, oj.nu)):
        _match(t, j, like=pt)


def dataclass_tuple(case):
    return (case.name, case.seq_len, case.global_batch, case.mode)


# ---------------------------------------------------------------------------
# Sharding rules and bytes per device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_param_count(cfg):
    return _REF_PARAM_COUNT(cfg)


_REF_PARAM_COUNT = TJ.param_count


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ALL)
def test_sharding_rules_match_reference(arch, mesh_name, monkeypatch):
    """Parameter, batch and cache specs and the bytes each device holds,
    against the reference's rules on an ``AbstractMesh`` of the production
    shape, fsdp at its default (the reference's ``param_count`` memoised:
    it re-traces the init on every call). The port's rules on the
    reference's own stacked tree give its specs exactly; on the port's
    per-layer tree, the same specs without the layer dim and the same
    bytes."""
    monkeypatch.setattr(TJ, "param_count", _ref_param_count)
    cfg_j, cfg_t = ARCHS_J[arch], ARCHS[arch]
    amesh, mesh = _abstract_mesh(mesh_name), production_mesh_shape(
        multi_pod=(mesh_name == "multipod"))
    (pj, _), (pt, _) = _ref_state(arch), _port_state(arch)

    ref = _ref_specs(SH_J.param_shardings(cfg_j, amesh, pj), pj)
    on_ref_tree = _port_specs(SH_T.param_specs(cfg_t, mesh, pj), pj, mesh)
    assert on_ref_tree == ref
    port = _port_specs(SH_T.param_specs(cfg_t, mesh, pt), pt, mesh)
    assert port == _unstacked(ref, port, _stacked_paths(pt))
    assert SH_T.opt_state_specs(SH_T.param_specs(cfg_t, mesh, pt)) == \
        SH_T.param_specs(cfg_t, mesh, pt)

    for name, case_t in shapes_t.SHAPES.items():
        if not shapes_t.cell_is_runnable(cfg_t, name)[0]:
            continue
        case_j = shapes_j.SHAPES[name]
        bj = shapes_j.input_specs(cfg_j, case_j)
        bt = shapes_t.input_specs(cfg_t, case_t)
        seq = case_t.mode == "prefill"
        assert _port_specs(SH_T.batch_specs(mesh, bt, seq_shard=seq), bt,
                           mesh) == _ref_specs(SH_J.batch_shardings(
                               amesh, bj, seq_shard=seq), bj)
        if case_t.mode == "train":
            continue
        cj = shapes_j.cache_specs(cfg_j, case_j)
        ct = shapes_t.cache_specs(cfg_t, case_t)
        ref_c = _ref_specs(SH_J.cache_shardings(amesh, cj), cj)
        port_c = _port_specs(SH_T.cache_specs(mesh, ct), ct, mesh)
        # The reference's int32 counters, which the port keeps on the
        # host: 4 bytes a layer for each idx, 4 for _pos.
        host = {p for p, v in ref_c.items()
                if p == "_pos" or p.endswith("/idx")}
        assert {p for p in port_c if port_c[p][1] == 0} == host
        for p in host:
            ref_c.pop(p), port_c.pop(p)
        assert port_c == _unstacked(ref_c, port_c, _stacked_paths(ct))


@functools.lru_cache(maxsize=None)
def _reference_dryrun_helpers() -> dict:
    """The reference dry run's ``_strip_model_axis``, ``_dp_batch_shardings``
    and ``_opt_shardings``, compiled from its source file alone: importing
    ``repro.launch.dryrun`` would set ``XLA_FLAGS`` in this process (512
    host devices), so the module's body is not run, only these three
    definitions (which import what they use inside)."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    wanted = {"_strip_model_axis", "_dp_batch_shardings", "_opt_shardings"}
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert {n.name for n in body} == wanted
    ns = {"jax": jax}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


@pytest.mark.parametrize("arch", ALL)
def test_dp_and_zero1_specs_match_reference(arch, monkeypatch):
    """``--dist dp`` (the model axis stripped from the params, the batch
    over every axis) and the ZeRO-1 moment specs (``_opt_shardings``:
    the first replicated dim over data, int8 moments' blocks over the
    whole mesh), for pjit and dp on both meshes, against the reference
    dry run's helpers: the port's on the reference's trees give its specs
    exactly; on the port's per-layer trees, the same bytes per device,
    leaf path by leaf path, but for the int8 moments' shape codes."""
    monkeypatch.setattr(TJ, "param_count", _ref_param_count)
    ref = _reference_dryrun_helpers()
    cfg_j, cfg_t = ARCHS_J[arch], ARCHS[arch]
    (pj, oj), (pt, ot) = _ref_state(arch), _port_state(arch)
    strip = functools.partial(SH_T.map_with_path,
                              lambda _, s: dryrun.strip_model_axis(s))
    for mesh_name in MESHES:
        amesh = _abstract_mesh(mesh_name)
        mesh = production_mesh_shape(multi_pod=(mesh_name == "multipod"))
        for dp in (False, True):
            psh = SH_J.param_shardings(cfg_j, amesh, pj,
                                       fsdp=False if dp else None)
            psp = SH_T.param_specs(cfg_t, mesh, pj,
                                   fsdp=False if dp else None)
            psp_t = SH_T.param_specs(cfg_t, mesh, pt,
                                     fsdp=False if dp else None)
            if dp:
                psh = jax.tree.map(ref["_strip_model_axis"], psh)
                psp, psp_t = strip(psp), strip(psp_t)
                assert _port_specs(psp, pj, mesh) == _ref_specs(psh, pj)
            want = _ref_specs(ref["_opt_shardings"](oj, psh, amesh), oj)
            got = _port_specs(dryrun.opt_specs(oj, psp, mesh), oj, mesh)
            assert got == want, (mesh_name, dp)
            mine = _port_specs(dryrun.opt_specs(ot, psp_t, mesh), ot, mesh)
            assert mine.keys() == want.keys()
            # Only the int8 moments' shape codes differ: one int32 vector
            # a layer, [ndim + 1], against one of the stacked leaf.
            differ = {p for p in mine if mine[p][1] != want[p][1]}
            assert all(p.endswith("/shape") for p in differ), differ
            assert not differ or cfg_t.opt_moment_dtype == "int8"
        for name, case_t in shapes_t.SHAPES.items():
            if not shapes_t.cell_is_runnable(cfg_t, name)[0]:
                continue
            bj = shapes_j.input_specs(cfg_j, shapes_j.SHAPES[name])
            bt = shapes_t.input_specs(cfg_t, case_t)
            assert _port_specs(dryrun.dp_batch_specs(mesh, bt), bt, mesh) \
                == _ref_specs(ref["_dp_batch_shardings"](amesh, bj), bj)


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _flops(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def test_forward_flops_are_the_products_of_the_config():
    """The meta forward of a reduced dense decoder counts 2 M K N for each
    projection, the MLP and the head, and 2 B H S^2 hd for each of QK^T
    and PV (the direct core computes every pair, the causal mask
    after); a train step (no remat at 2 layers) counts 3x the forward:
    each product's backward is two products of its size, and AdamW's
    elementwise work counts nothing. With remat (4 layers, one scanned
    segment) the recomputed forward adds more, at most the layers' forward
    once more (``torch.utils.checkpoint`` stops recomputing once the
    backward has what it saved)."""
    cfg = reduced(ARCHS["yi-6b"])
    B, S = 2, 16
    Tk = B * S
    d, H, KV, hd, f, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab)
    layer = (2 * Tk * d * (H + 2 * KV) * hd + 2 * Tk * H * hd * d
             + 3 * 2 * Tk * d * f + 2 * 2 * B * H * S * S * hd)
    head = 2 * Tk * d * V
    params = TT.init_params(cfg, device="meta")
    tokens = torch.empty((B, S), dtype=torch.int64, device="meta")
    assert _flops(TT.forward, params, cfg, {"tokens": tokens}) == \
        cfg.n_layers * layer + head
    opt = steps_t.abstract_state(cfg)[1]
    batch = {"tokens": tokens, "labels": tokens}
    assert _flops(steps_t.make_train_step(cfg), params, opt, batch) == \
        3 * (cfg.n_layers * layer + head)
    deep = cfg.scaled(n_layers=4)
    params, opt = steps_t.abstract_state(deep)
    plain = _flops(steps_t.make_train_step(deep, remat=False), params, opt,
                   batch)
    assert plain == 3 * (4 * layer + head)
    remat = _flops(steps_t.make_train_step(deep), params, opt, batch)
    assert plain < remat <= plain + 4 * layer


# ---------------------------------------------------------------------------
# The meta branches
# ---------------------------------------------------------------------------


def test_linear_scan_meta_branch_gives_shapes_only():
    """A meta operand gets an empty result of the plain path's shape and
    dtype, forward and backward, with no launch counted; a CPU operand
    still runs the plain version."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 9, 5), generator=g)
    b = torch.randn((2, 9, 5), generator=g).to(torch.bfloat16)
    before = linear_scan.launches
    cpu = linear_scan(a, b)
    assert torch.equal(cpu, linear_scan_ref(a, b).to(b.dtype))
    am, bm = a.to("meta").requires_grad_(), b.to("meta").requires_grad_()
    meta = linear_scan(am, bm)
    assert meta.device.type == "meta"
    assert (meta.shape, meta.dtype) == (cpu.shape, cpu.dtype)
    meta.float().sum().backward()
    assert (am.grad.shape, am.grad.dtype) == (a.shape, a.dtype)
    assert (bm.grad.shape, bm.grad.dtype) == (b.shape, b.dtype)
    assert linear_scan.launches == before


def test_expert_counts_are_bincount_and_static_on_meta():
    """The MoE's counts per expert equal ``torch.bincount`` on the CPU
    (an expert no token chose counts 0) and have E entries on meta, where
    ``bincount`` has no implementation."""
    ids = torch.tensor([3, 0, 3, 5, 3, 0], dtype=torch.int64)
    assert torch.equal(LT._expert_counts(ids, 8),
                       torch.bincount(ids, minlength=8))
    meta = LT._expert_counts(ids.to("meta"), 8)
    assert meta.shape == (8,) and meta.device.type == "meta"


def test_wkv_meta_branch_counts_the_loops_products():
    """RWKV6's WKV on meta: the loop's output and state shapes and dtypes,
    and the FLOPs the loop counts, forward and backward."""
    B, S, nh, hd = 2, 5, 3, 4
    g = torch.Generator().manual_seed(0)
    rkvw = [torch.randn((B, S, nh, hd), generator=g) for _ in range(4)]
    p = {"u": torch.randn((nh, hd), generator=g)}
    state = torch.zeros((B, nh, hd, hd))

    def run(device):
        ts = [t.to(device, copy=True).requires_grad_() for t in rkvw]
        with FlopCounterMode(display=False) as fc:
            o, s = RT.rwkv6_wkv_scan({"u": p["u"].to(device)}, *ts,
                                     state.to(device))
            o.sum().backward()
        return (o.shape, o.dtype, s.shape, s.dtype), fc.get_total_flops()

    (cpu, f_cpu), (meta, f_meta) = run("cpu"), run("meta")
    assert cpu == meta and f_cpu == f_meta == 3 * 2 * B * S * nh * hd * hd


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-v2-236b",
                                  "rwkv6-7b"])
def test_meta_forward_has_the_cpu_forwards_shapes(arch):
    """The three families the meta branches exist for: the reduced
    forward, prefill and decode on meta give the CPU's output and cache
    shapes and dtypes."""
    cfg = reduced(ARCHS[arch])
    B, S = 2, 8
    outs = {}
    for device in ("cpu", "meta"):
        params = TT.init_params(cfg, seed=0, device=device)
        tokens = torch.zeros((B, S), dtype=torch.int64, device=device)
        logits, _, aux = TT.forward(params, cfg, {"tokens": tokens})
        cache = TT.init_cache(cfg, B, S + 1, device=device)
        last, cache = steps_t.make_prefill_step(cfg)(
            params, cache, {"tokens": tokens})
        nxt, cache = steps_t.make_serve_step(cfg)(
            params, cache, {"tokens": tokens[:, :1]})
        leaves = [(tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor)
                  else t for t in TT._leaves(cache)]
        outs[device] = [(tuple(x.shape), x.dtype)
                        for x in (logits, aux, last, nxt)] + leaves
    assert outs["meta"] == outs["cpu"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_main_writes_one_json_per_cell(tmp_path):
    """Each cell's record: status, bytes per device, FLOPs (total and
    over the devices), collectives counted by kind from the placed step
    (ROADMAP A3.1); a skipped cell says why; int8 params hold fewer bytes
    than bf16 ones."""
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "recurrentgemma-2b", "--shape",
                        "decode_32k", "--mesh", "both", "--out",
                        str(out)]) == 0
    assert dryrun.main(["--arch", "yi-6b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k",
                        "--quant", "int8", "--jobs", "2", "--out",
                        str(out)]) == 0
    assert dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    files = sorted(p.name for p in out.iterdir())
    assert files == ["recurrentgemma-2b_decode_32k_multipod_pjit.json",
                     "recurrentgemma-2b_decode_32k_pod_pjit.json",
                     "yi-6b_decode_32k_pod_pjit.json",
                     "yi-6b_decode_32k_pod_pjit_int8.json",
                     "yi-6b_long_500k_pod_pjit.json"]
    res = {p.name: json.loads(p.read_text()) for p in out.iterdir()}
    skipped = res["yi-6b_long_500k_pod_pjit.json"]
    assert skipped["status"] == "skipped" and "full-attention" in \
        skipped["reason"]
    for name, r in res.items():
        if r["status"] == "skipped":
            continue
        assert r["status"] == "ok" and r["compile_s"] >= 0
        assert r["memory"]["argument_size_in_bytes"] > 0
        assert r["cost"]["flops"] > 0
        assert r["cost"]["flops_over_n_devices"] == \
            r["cost"]["flops"] / r["n_devices"]
        coll = r["collectives"]
        assert sum(coll["count_per_kind"].values()) > 0
        assert coll["total_bytes"] == sum(coll["bytes_per_kind"].values())
        assert "fake process group" in r["collectives_note"]
    pod = res["recurrentgemma-2b_decode_32k_pod_pjit.json"]
    multi = res["recurrentgemma-2b_decode_32k_multipod_pjit.json"]
    assert (pod["n_devices"], multi["n_devices"]) == (256, 512)
    assert pod["cost"]["flops"] == multi["cost"]["flops"]
    q = res["yi-6b_decode_32k_pod_pjit_int8.json"]["memory"]
    b = res["yi-6b_decode_32k_pod_pjit.json"]["memory"]
    assert q["argument_size_in_bytes"] < b["argument_size_in_bytes"]


# DeepSeek-V2/V3's train_4k cells on the pod mesh (the two configs with
# int8 AdamW moments), as the parent commit of the placed int8 update
# recorded them, when their placed trace stopped before the update: the
# bytes per device and the FLOPs, which the update changes neither of (the
# same sharding rules; AdamW adds no matrix product).
INT8_TRAIN_CELLS = {"deepseek-v2-236b": (4013550596, 2.747065205690204e+17),
                    "deepseek-v3-671b": (11186341860, 4.3315920283212186e+17)}


def test_int8_moment_train_cells_trace_the_update():
    """DeepSeek-V2/V3's ``train_4k`` cells on the pod mesh trace the whole
    placed step (one spawned process a cell): ok, no note of an update
    left out, the update's layout transfer counted as all-to-all (the
    step's only one: the transfer's own count of calls equals it), and
    the bytes per device and FLOPs unchanged."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    archs = list(INT8_TRAIN_CELLS)
    with ProcessPoolExecutor(
            len(archs), mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        records = list(pool.map(dryrun.run_cell, archs,
                                ["train_4k"] * len(archs),
                                ["pod"] * len(archs)))
    for arch, r in zip(archs, records):
        assert ARCHS[arch].opt_moment_dtype == "int8"
        assert r["status"] == "ok", r
        assert "update" not in r["collectives_note"], r["collectives_note"]
        coll, moved = r["collectives"], r["update_transfer"]
        assert coll["count_per_kind"]["all-to-all"] == moved["calls"] > 0
        assert coll["bytes_per_kind"]["all-to-all"] > 0
        assert (r["memory"]["argument_size_in_bytes"],
                r["cost"]["flops"]) == INT8_TRAIN_CELLS[arch]


def _ref_pipeline_plan(arch, shape, mesh_name, stages=0):
    """The reference's ``_run_pipeline_cell`` up to its plan and K, from its
    allocator and workload model with its arguments (16 x 16 chips a pod)."""
    from repro.core.allocator import plan_pipeline as plan_j
    from repro.core.workload import lm_layer_workloads as layers_j
    cfg, case = ARCHS_J[arch], shapes_j.SHAPES[shape]
    n_pod = 2 if mesh_name == "multipod" else 1
    train = case.mode == "train"
    plan = plan_j(layers_j(cfg, seq_len=case.seq_len,
                           batch=case.global_batch, mode=case.mode),
                  model_axis=16, data_axis=16 * n_pod,
                  global_batch=case.global_batch, seq_len=case.seq_len,
                  train=train, d_model=cfg.d_model,
                  allow_infeasible=not train,
                  stage_choices=[stages] if stages else None)
    K = max(1, min(plan.microbatches, case.global_batch // (16 * n_pod)))
    return plan, K


def _ref_pipeline_status(arch, shape):
    """What the reference's ``run_cell(..., dist="pipeline")`` records, from
    its own parts (its dry run compiles 256-device programs): skipped where
    ``cell_is_runnable`` says so; "error" for a decode shape and for a train
    plan that fits no HBM (``plan_pipeline`` raises), and for a prefill
    batch without tokens (its ``pipeline_prefill_fn`` reads
    ``batch["tokens"]``); "ok" otherwise, the unsupported kind's
    ``{"status": "unsupported"}`` included, which ``run_cell``'s update
    overwrites (ROADMAP C9)."""
    from repro.core import pipeline as PL_J
    cfg, case = ARCHS_J[arch], shapes_j.SHAPES[shape]
    if not shapes_j.cell_is_runnable(cfg, shape)[0]:
        return "skipped"
    if case.mode not in ("train", "prefill"):
        return "error"
    if not PL_J.supports_pipeline(cfg):
        return "ok"
    try:
        _ref_pipeline_plan(arch, shape, "pod")
    except ValueError:
        return "error"
    if case.mode == "prefill" and \
            "tokens" not in shapes_j.input_specs(cfg, case):
        return "error"
    return "ok"


# The cells the status test traces whole (the rest return before tracing):
# a train cell with its gradient and a prefill, both under 10 s here.
TRACED = {("yi-6b", "train_4k"), ("rwkv6-7b", "prefill_32k")}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ALL)
def test_dist_pipeline_plan_matches_reference(arch, mesh_name):
    """The pipelined cells' plan (S, T, boundaries, the allocator's
    predicted utilization) and microbatch count K are the reference's, on
    both meshes, for the train and prefill shapes; where the reference's
    allocator finds no plan, the port's raises alike."""
    for shape in ("train_4k", "prefill_32k"):
        try:
            want, want_k = _ref_pipeline_plan(arch, shape, mesh_name)
        except ValueError as e:
            with pytest.raises(ValueError, match="no feasible"):
                dryrun.pipeline_plan(ARCHS[arch], shapes_t.SHAPES[shape],
                                     production_mesh_shape(
                                         mesh_name == "multipod"))
            assert "no feasible" in str(e)
            continue
        got, k = dryrun.pipeline_plan(
            ARCHS[arch], shapes_t.SHAPES[shape],
            production_mesh_shape(mesh_name == "multipod"))
        assert (got.n_stages, got.tensor_parallel, tuple(got.boundaries),
                k) == (want.n_stages, want.tensor_parallel,
                       tuple(want.boundaries), want_k), (arch, shape)
        assert got.utilization == pytest.approx(want.utilization, rel=1e-12)


@pytest.mark.parametrize("arch", ALL)
def test_dist_pipeline_statuses_match_reference(arch):
    """Each pod cell's status under ``--dist pipeline`` is the reference's
    (``_ref_pipeline_status``): decode shapes and the DeepSeek train plans
    that fit no HBM are errors, RecurrentGemma-2B's unsupported kind comes
    back "ok" with the reason "unit kind" (C9). Cells that would trace
    run only where ``TRACED`` lists them; the traced ones are held in
    ``test_dist_pipeline_counts_the_handoff``."""
    for shape in shapes_t.SHAPES:
        want = _ref_pipeline_status(arch, shape)
        if want == "ok" and ARCHS[arch].name != "recurrentgemma-2b" and \
                (arch, shape) not in TRACED:
            continue
        got = dryrun._cell_or_error(arch, shape, "pod", "pipeline", 0, "none")
        assert got["status"] == want, (arch, shape, got)
        if arch == "recurrentgemma-2b" and want == "ok":
            assert got["reason"] == "unit kind" and "plan" not in got


@pytest.mark.parametrize("arch,shape", sorted(TRACED))
def test_dist_pipeline_counts_the_handoff(arch, shape):
    """A traced pipeline cell: the reference's plan; the stage hand-off
    counted as ``collective-permute`` (stage 0's forward sends: K + S - 2
    ticks, one microbatch of activations each) beside the all-reduces;
    FLOPs one rank's times the device count; the predicted utilization
    labelled as the allocator's v5e model."""
    res = dryrun.run_cell(arch, shape, "pod", dist="pipeline")
    plan, K = _ref_pipeline_plan(arch, shape, "pod")
    S, T = plan.n_stages, plan.tensor_parallel
    assert res["status"] == "ok"
    assert res["plan"]["S"] == S and res["plan"]["T"] == T
    assert res["plan"]["microbatches"] == K
    assert "v5e" in res["plan"]["predicted_util_of"]
    assert res["n_devices"] == 256 and res["mesh_shape"] == {
        "data": 16, "stage": S, "tp": T}
    cfg, case = ARCHS[arch], shapes_t.SHAPES[shape]
    mb_rows = case.global_batch // 16 // K
    coll = res["collectives"]
    assert coll["count_per_kind"]["collective-permute"] == K + S - 2
    assert coll["bytes_per_kind"]["collective-permute"] == \
        (K + S - 2) * mb_rows * case.seq_len * cfg.d_model * 2
    assert coll["count_per_kind"]["all-reduce"] > 0
    assert coll["total_bytes"] == sum(coll["bytes_per_kind"].values())
    assert res["cost"]["flops"] == res["cost"]["flops_over_n_devices"] * 256
    assert res["cost"]["flops"] > 0
    assert res["memory"]["argument_size_in_bytes"] > 0


def test_dryrun_imports_no_jax_and_sets_no_xla_flags():
    code = ("import os, sys, repro_torch.launch.dryrun; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); "
            "print(bad, os.environ.get('XLA_FLAGS')); "
            "sys.exit(1 if bad or 'XLA_FLAGS' in os.environ else 0)")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
