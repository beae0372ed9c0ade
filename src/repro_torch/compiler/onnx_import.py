"""Optional ONNX ingestion for the importer (guarded: no hard dep). A copy
of ``repro/compiler/onnx_import.py`` (numpy only) with the port's names.

Translates a (small, feed-forward) ONNX CNN into the neutral
:class:`~repro_torch.compiler.graph.Graph` IR, weights included, so the
rest of the pipeline (lower -> quantize -> golden -> registry) is shared
with the JSON path. ``onnx`` is probed via ``importlib`` — when absent,
:func:`onnx_available` is False and :func:`load_onnx` raises a plain
``ImportError`` explaining the optional extra; nothing else in the
compiler package imports this module's dependency, so the no-onnx
environment (the default CI leg) is fully functional.

Supported ONNX ops and their IR mapping:

=============  ==========================================================
ONNX           IR
=============  ==========================================================
Conv           ``conv`` (OIHW weights transposed to HWIO; symmetric
               ``pads`` only; ``group`` -> ``groups``)
Gemm           ``fc`` (``transB`` honoured; ``alpha``/``beta`` must be 1;
               the first Gemm after a spatial Flatten gets its weight
               rows permuted from NCHW- to NHWC-flatten order)
Relu           ``relu``
MaxPool        ``maxpool``
AveragePool /  ``avgpool`` (carried in the IR; the lowering pass rejects
GlobalAverage  it with a typed :class:`UnsupportedOpError`)
Flatten        ``flatten``
Add            ``add`` (carried; rejected at lowering)
=============  ==========================================================

Anything else raises :class:`UnsupportedOpError` naming the node —
imports fail loudly at the front door, never mid-serve.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from repro_torch.compiler.graph import (INPUT, Graph, GraphError, Node,
                                        UnsupportedOpError)


def onnx_available() -> bool:
    """Probe once whether the optional ``onnx`` package is importable."""
    return importlib.util.find_spec("onnx") is not None


def load_onnx(path: str | os.PathLike) -> Graph:
    """Read an ONNX file into the neutral graph IR (weights attached).

    Raises ``ImportError`` when the optional ``onnx`` package is not
    installed, :class:`GraphError` / :class:`UnsupportedOpError` for
    models the importer cannot take.
    """
    if not onnx_available():
        raise ImportError(
            "the ONNX ingestion path needs the optional 'onnx' package "
            "(pip install onnx); the JSON/dict spec path has no such "
            "dependency")
    import onnx
    from onnx import numpy_helper

    m = onnx.load(str(path))
    g = m.graph
    inits = {t.name: numpy_helper.to_array(t) for t in g.initializer}
    graph_inputs = [i for i in g.input if i.name not in inits]
    if len(graph_inputs) != 1:
        raise GraphError(
            f"{path}: expected exactly one graph input, found "
            f"{[i.name for i in graph_inputs]}")
    inp = graph_inputs[0]
    dims = [d.dim_value
            for d in inp.type.tensor_type.shape.dim]
    if len(dims) != 4:
        raise GraphError(f"{path}: input {inp.name!r} must be NCHW "
                         f"4-d, got {dims}")
    _, c, h, w = dims
    if h != w:
        raise UnsupportedOpError(
            inp.name, f"non-square input {h}x{w} (the engine's models "
                      f"carry one square input_hw)")

    nodes: list[Node] = []
    # ONNX tensor name -> IR node name producing it.
    produced: dict[str, str] = {inp.name: INPUT}
    # IR name -> NCHW spatial shape (C, H, W) for flatten-order fixes.
    spatial: dict[str, tuple[int, int, int]] = {INPUT: (c, h, w)}
    # IR names of flatten nodes whose next Gemm needs row permutation.
    nchw_flat: dict[str, tuple[int, int, int]] = {}

    used = set()

    def fresh(name: str) -> str:
        base = name or f"n{len(nodes)}"
        out, i = base, 1
        while out in used or out == INPUT:
            out = f"{base}_{i}"
            i += 1
        used.add(out)
        return out

    for on in g.node:
        attrs = {a.name: a for a in on.attribute}
        data_in = [i for i in on.input if i not in inits]
        name = fresh(on.name or (on.output[0] if on.output else ""))
        try:
            srcs = tuple(produced[i] for i in data_in)
        except KeyError as e:
            raise GraphError(f"node {name!r}: input tensor {e.args[0]!r} "
                             f"has no producer (non-feed-forward or "
                             f"pruned graph)") from None

        if on.op_type == "Conv":
            node = _conv(on, name, srcs, attrs, inits)
            c_prev = spatial.get(srcs[0])
            if c_prev is not None:
                k = _ints(attrs, "kernel_shape", name)
                s = _ints(attrs, "strides", name, default=[1, 1])
                p = _sym_pads(attrs, name)
                oh = (c_prev[1] + 2 * p - k[0]) // s[0] + 1
                spatial[name] = (int(node.attrs["out_channels"]), oh, oh)
        elif on.op_type == "Gemm":
            node = _gemm(on, name, srcs, attrs, inits, nchw_flat)
        elif on.op_type == "Relu":
            node = Node("relu", name, srcs)
            if srcs[0] in spatial:
                spatial[name] = spatial[srcs[0]]
            if srcs[0] in nchw_flat:
                nchw_flat[name] = nchw_flat[srcs[0]]
        elif on.op_type in ("MaxPool", "AveragePool"):
            op = "maxpool" if on.op_type == "MaxPool" else "avgpool"
            k = _ints(attrs, "kernel_shape", name)
            s = _ints(attrs, "strides", name, default=list(k))
            p = _sym_pads(attrs, name)
            node = Node(op, name, srcs,
                        {"kernel": list(k), "stride": list(s),
                         "padding": p if p else "valid"})
            cp = spatial.get(srcs[0])
            if cp is not None:
                oh = (cp[1] + 2 * p - k[0]) // s[0] + 1
                spatial[name] = (cp[0], oh, oh)
        elif on.op_type == "GlobalAveragePool":
            cp = spatial.get(srcs[0])
            k = cp[1] if cp else 1
            node = Node("avgpool", name, srcs,
                        {"kernel": k, "stride": k, "padding": "valid"})
        elif on.op_type in ("Flatten", "Reshape"):
            node = Node("flatten", name, srcs[:1])
            cp = spatial.get(srcs[0])
            if cp is not None:
                nchw_flat[name] = cp
        elif on.op_type == "Add":
            node = Node("add", name, srcs)
        else:
            raise UnsupportedOpError(
                name, f"ONNX op {on.op_type!r} is outside the importable "
                      f"set (Conv, Gemm, Relu, MaxPool, AveragePool, "
                      f"GlobalAveragePool, Flatten, Reshape, Add)")
        nodes.append(node)
        for out in on.output:
            produced[out] = name

    model_name = os.path.splitext(os.path.basename(str(path)))[0]
    return Graph.build(model_name or "onnx_model", int(h), int(c), nodes)


def _ints(attrs, key, node, default=None) -> list[int]:
    if key not in attrs:
        if default is not None:
            return default
        raise GraphError(f"node {node!r}: missing ONNX attribute {key!r}")
    return list(attrs[key].ints)


def _sym_pads(attrs, node) -> int:
    """ONNX pads are [top, left, bottom, right]; the engine reproduces
    only symmetric square padding."""
    if "auto_pad" in attrs:
        ap = attrs["auto_pad"].s.decode()
        if ap and ap != "NOTSET":
            raise UnsupportedOpError(
                node, f"ONNX auto_pad={ap!r} — export with explicit "
                      f"symmetric pads")
    pads = list(attrs["pads"].ints) if "pads" in attrs else [0, 0, 0, 0]
    if len(set(pads)) != 1:
        raise UnsupportedOpError(
            node, f"asymmetric ONNX pads {pads} — the engine derives "
                  f"symmetric windows from the output arithmetic")
    return int(pads[0])


def _conv(on, name, srcs, attrs, inits) -> Node:
    w_name = on.input[1]
    if w_name not in inits:
        raise GraphError(f"node {name!r}: conv weight {w_name!r} is not "
                         f"an initializer")
    w = inits[w_name]                       # OIHW
    b = inits.get(on.input[2]) if len(on.input) > 2 else None
    k = _ints(attrs, "kernel_shape", name)
    strides = _ints(attrs, "strides", name, default=[1, 1])
    group = attrs["group"].i if "group" in attrs else 1
    if "dilations" in attrs and set(attrs["dilations"].ints) != {1}:
        raise UnsupportedOpError(
            name, f"dilated conv {list(attrs['dilations'].ints)} — the "
                  f"engine's PE array walks dense RxS windows")
    p = _sym_pads(attrs, name)
    return Node("conv", name, srcs, {
        "out_channels": int(w.shape[0]),
        "kernel": list(k),
        "stride": list(strides),
        "groups": int(group),
        "padding": p if p else "valid",
        "in_channels": None,
        "weight": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
        "bias": None if b is None else np.asarray(b, np.float32),
    })


def _gemm(on, name, srcs, attrs, inits, nchw_flat) -> Node:
    w_name = on.input[1]
    if w_name not in inits:
        raise GraphError(f"node {name!r}: Gemm weight {w_name!r} is not "
                         f"an initializer")
    for key in ("alpha", "beta"):
        if key in attrs and attrs[key].f not in (0.0, 1.0):
            raise UnsupportedOpError(
                name, f"Gemm {key}={attrs[key].f} != 1 — fold scaling "
                      f"into the weights before export")
    if "transA" in attrs and attrs["transA"].i:
        raise UnsupportedOpError(name, "Gemm transA=1 is not importable")
    w = inits[w_name]
    if "transB" in attrs and attrs["transB"].i:
        w = w.T                              # -> (in, out)
    b = inits.get(on.input[2]) if len(on.input) > 2 else None
    # The engine flattens NHWC (rows h*W*C + w*C + c); ONNX flattened
    # NCHW (rows c*H*W + h*W + w). Permute the weight rows of the first
    # Gemm after a spatial Flatten so both orders compute identically.
    src_flat = nchw_flat.get(srcs[0])
    if src_flat is not None:
        C, H, Wd = src_flat
        if w.shape[0] != C * H * Wd:
            raise GraphError(
                f"node {name!r}: Gemm in_features {w.shape[0]} != "
                f"flattened {C}x{H}x{Wd} = {C * H * Wd}")
        perm = np.asarray(
            [cc * (H * Wd) + hh * Wd + ww
             for hh in range(H) for ww in range(Wd) for cc in range(C)],
            np.int64)
        w = w[perm]
    return Node("fc", name, srcs, {
        "out_features": int(w.shape[1]),
        "in_features": None,
        "weight": np.asarray(w, np.float32),
        "bias": None if b is None else np.asarray(b, np.float32),
    })
