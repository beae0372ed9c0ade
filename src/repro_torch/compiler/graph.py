"""Framework-neutral CNN graph IR — the importer's front door. A copy of
``repro/compiler/graph.py`` (numpy only) with the port's names.

The serving zoo executes :class:`~repro_torch.core.workload.CNNModel`
graphs (a linear chain of conv / fc / pool engine layers with ReLU fused into
every non-final engine). Arbitrary CNNs arrive as *graphs* with explicit
activation and pooling nodes, so the importer needs a small neutral IR
between "whatever the source framework says" and "what the engine can
lower": typed nodes for ``conv`` / ``fc`` / ``relu`` / ``maxpool`` /
``avgpool`` / ``flatten`` / ``add``, NHWC shapes inferred and checked at
import time, and topological validation (defs before uses, arity, one
terminal output).

Two ingestion paths build this IR:

* :func:`from_spec` — a pure-Python JSON/dict graph spec (no new
  dependency; what the tests, the example, and CI exercise);
* :mod:`repro_torch.compiler.onnx_import` — an optional ONNX reader,
  guarded by ``importlib`` so the no-onnx environment stays fully
  functional.

The IR deliberately represents *more* than the engine supports
(``avgpool``, ``add``): rejection with a typed
:class:`UnsupportedOpError` naming the offending node is the lowering
pass's job (:mod:`repro_torch.compiler.lower`), while malformed structure
and shape mismatches are :class:`GraphError`\\ s raised here, at import.

Conventions: NHWC activations, square spatial dims (the engine's
``CNNModel`` carries one ``input_hw``), batch dimension implicit.
Weights may ride on nodes (``weight`` / ``bias`` attrs, numpy arrays:
conv HWIO, fc ``(in, out)``) — the ONNX path fills them, the JSON path
usually leaves them to seeded init at quantization time.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Sequence

import numpy as np

INPUT = "input"                 # reserved name: the graph's input tensor

#: op -> (required attrs, optional attrs with defaults)
OP_ATTRS: dict[str, tuple[tuple[str, ...], dict[str, Any]]] = {
    "conv": (("out_channels", "kernel"),
             {"stride": 1, "padding": "same", "groups": 1,
              "in_channels": None, "weight": None, "bias": None}),
    "fc": (("out_features",),
           {"in_features": None, "weight": None, "bias": None}),
    "relu": ((), {}),
    "maxpool": (("kernel",), {"stride": None, "padding": "valid"}),
    "avgpool": (("kernel",), {"stride": None, "padding": "valid"}),
    "flatten": ((), {}),
    "add": ((), {}),
}
OPS = tuple(OP_ATTRS)
_BINARY_OPS = ("add",)


class GraphError(ValueError):
    """Malformed graph structure or a shape mismatch, rejected at
    import time (before any lowering or compilation)."""


class UnsupportedOpError(GraphError):
    """A node the importer cannot take — an op outside the IR, or (from
    the lowering pass) an IR op / attribute combination the engine
    cannot represent. Always names the node."""

    def __init__(self, node: str, why: str):
        self.node = node
        super().__init__(f"node {node!r}: {why}")


@dataclasses.dataclass(frozen=True)
class Node:
    """One typed IR node. ``attrs`` holds the op's validated attribute
    dict (schema per op in :data:`OP_ATTRS`, defaults filled in)."""

    op: str
    name: str
    inputs: tuple[str, ...]
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def attr(self, key: str):
        return self.attrs.get(key)


def _square(node: str, what: str, v) -> int:
    """Accept an int or a square [k, k] pair; anything rectangular is a
    typed legalization failure (the engine's layers are R == S)."""
    if isinstance(v, bool):
        raise GraphError(f"node {node!r}: {what} must be an int, got {v!r}")
    if isinstance(v, int):
        if v <= 0:
            raise GraphError(f"node {node!r}: {what}={v} must be positive")
        return v
    if isinstance(v, (list, tuple)) and len(v) == 2:
        a, b = v
        if a != b:
            raise UnsupportedOpError(
                node, f"non-square {what} {list(v)} (the engine's layers "
                      f"are square: R == S)")
        return _square(node, what, a)
    raise GraphError(f"node {node!r}: {what} must be an int or [k, k], "
                     f"got {v!r}")


def resolve_padding(in_hw: int, kernel: int, stride: int, padding,
                    node: str) -> tuple[int, int, int]:
    """-> ``(lo, hi, out_hw)`` for one spatial dim under the declared
    padding: ``"same"`` (ceil(in/stride), TF SAME split), ``"valid"``
    (no padding), or a symmetric integer pad. Shared by shape inference
    here and re-derivation checks in the lowering pass."""
    if padding == "same":
        out = -(-in_hw // stride)
        need = max((out - 1) * stride + kernel - in_hw, 0)
        lo = need // 2
        return lo, need - lo, out
    if padding == "valid":
        if in_hw < kernel:
            raise GraphError(
                f"node {node!r}: kernel {kernel} exceeds input size "
                f"{in_hw} under 'valid' padding")
        return 0, 0, (in_hw - kernel) // stride + 1
    if isinstance(padding, int) and not isinstance(padding, bool):
        if padding < 0:
            raise GraphError(f"node {node!r}: padding {padding} < 0")
        out = (in_hw + 2 * padding - kernel) // stride + 1
        if out < 1:
            raise GraphError(
                f"node {node!r}: kernel {kernel} stride {stride} padding "
                f"{padding} leaves no output rows on input {in_hw}")
        return padding, padding, out
    raise GraphError(f"node {node!r}: padding must be 'same', 'valid' or "
                     f"a non-negative int, got {padding!r}")


@dataclasses.dataclass
class Graph:
    """A validated importer graph: topologically ordered typed nodes
    over one square NHWC input, with every node's output shape inferred
    (``shapes[name]`` is ``(h, w, c)`` spatial or ``(features,)`` flat;
    the reserved name ``"input"`` maps to the input tensor)."""

    name: str
    input_hw: int
    input_ch: int
    nodes: tuple[Node, ...]
    shapes: dict[str, tuple[int, ...]]
    output: str

    @classmethod
    def build(cls, name: str, input_hw: int, input_ch: int,
              nodes: Sequence[Node]) -> "Graph":
        """Validate structure + infer shapes (the import-time gate)."""
        if input_hw < 1 or input_ch < 1:
            raise GraphError(f"graph {name!r}: input {input_hw}x{input_hw}"
                             f"x{input_ch} is not a tensor")
        if not nodes:
            raise GraphError(f"graph {name!r} has no nodes")
        shapes: dict[str, tuple[int, ...]] = {
            INPUT: (input_hw, input_hw, input_ch)}
        consumed: dict[str, int] = {}
        for node in nodes:
            if node.op not in OPS:
                raise UnsupportedOpError(
                    node.name, f"unknown op {node.op!r} (importable ops: "
                               f"{', '.join(OPS)})")
            if node.name in shapes:
                raise GraphError(f"duplicate node name {node.name!r}"
                                 + (" (reserved)" if node.name == INPUT
                                    else ""))
            want_arity = 2 if node.op in _BINARY_OPS else 1
            if len(node.inputs) != want_arity:
                raise GraphError(
                    f"node {node.name!r}: op {node.op!r} takes "
                    f"{want_arity} input(s), got {list(node.inputs)}")
            for src in node.inputs:
                if src not in shapes:
                    raise GraphError(
                        f"node {node.name!r}: input {src!r} is not "
                        f"defined before use (nodes must be listed in "
                        f"topological order; the input tensor is "
                        f"{INPUT!r})")
                consumed[src] = consumed.get(src, 0) + 1
            shapes[node.name] = _infer_shape(node, shapes)
        terminals = [n.name for n in nodes if n.name not in consumed]
        if len(terminals) != 1:
            raise GraphError(
                f"graph {name!r} must have exactly one output (a single "
                f"unconsumed terminal node), found {len(terminals)}: "
                f"{terminals}")
        return cls(name=str(name), input_hw=int(input_hw),
                   input_ch=int(input_ch), nodes=tuple(nodes),
                   shapes=shapes, output=terminals[0])

    def consumers(self) -> dict[str, list[Node]]:
        out: dict[str, list[Node]] = {}
        for node in self.nodes:
            for src in node.inputs:
                out.setdefault(src, []).append(node)
        return out


def _infer_shape(node: Node, shapes: dict[str, tuple[int, ...]]
                 ) -> tuple[int, ...]:
    """Per-op NHWC shape inference with the import-time mismatch checks
    (declared channels/features vs producer, weight array shapes)."""
    a = node.attrs
    src = shapes[node.inputs[0]]
    if node.op == "conv":
        if len(src) != 3:
            raise GraphError(f"node {node.name!r}: conv needs a spatial "
                             f"(h, w, c) producer, got shape {src}")
        hw, _, cin = src
        k = _square(node.name, "kernel", a["kernel"])
        stride = _square(node.name, "stride", a["stride"])
        groups = int(a["groups"])
        cout = int(a["out_channels"])
        if a["in_channels"] is not None and int(a["in_channels"]) != cin:
            raise GraphError(
                f"node {node.name!r}: declared in_channels="
                f"{a['in_channels']} but producer {node.inputs[0]!r} "
                f"has {cin} channels")
        if groups < 1 or cin % groups or cout % groups:
            raise GraphError(
                f"node {node.name!r}: groups={groups} must divide "
                f"in_channels={cin} and out_channels={cout}")
        w = a["weight"]
        if w is not None and tuple(np.shape(w)) != (k, k, cin // groups,
                                                    cout):
            raise GraphError(
                f"node {node.name!r}: weight shape "
                f"{tuple(np.shape(w))} != HWIO "
                f"{(k, k, cin // groups, cout)}")
        _check_bias(node, cout)
        _, _, out = resolve_padding(hw, k, stride, a["padding"], node.name)
        return (out, out, cout)
    if node.op == "fc":
        if len(src) != 1:
            raise GraphError(
                f"node {node.name!r}: fc needs a flat (features,) "
                f"producer, got shape {src} — insert a 'flatten' node")
        (fin,) = src
        fout = int(a["out_features"])
        if a["in_features"] is not None and int(a["in_features"]) != fin:
            raise GraphError(
                f"node {node.name!r}: declared in_features="
                f"{a['in_features']} but producer {node.inputs[0]!r} "
                f"has {fin} features")
        w = a["weight"]
        if w is not None and tuple(np.shape(w)) != (fin, fout):
            raise GraphError(
                f"node {node.name!r}: weight shape "
                f"{tuple(np.shape(w))} != (in, out) {(fin, fout)}")
        _check_bias(node, fout)
        return (fout,)
    if node.op in ("maxpool", "avgpool"):
        if len(src) != 3:
            raise GraphError(f"node {node.name!r}: {node.op} needs a "
                             f"spatial producer, got shape {src}")
        hw, _, c = src
        k = _square(node.name, "kernel", a["kernel"])
        stride = _square(node.name, "stride",
                         a["stride"] if a["stride"] is not None else k)
        _, _, out = resolve_padding(hw, k, stride, a["padding"], node.name)
        return (out, out, c)
    if node.op == "flatten":
        return (int(np.prod(src)),)
    if node.op == "relu":
        return src
    if node.op == "add":
        other = shapes[node.inputs[1]]
        if src != other:
            raise GraphError(
                f"node {node.name!r}: add operands disagree: "
                f"{node.inputs[0]!r} {src} vs {node.inputs[1]!r} {other}")
        return src
    raise UnsupportedOpError(node.name, f"unknown op {node.op!r}")


def _check_bias(node: Node, cout: int) -> None:
    b = node.attrs.get("bias")
    if b is not None and tuple(np.shape(b)) != (cout,):
        raise GraphError(f"node {node.name!r}: bias shape "
                         f"{tuple(np.shape(b))} != ({cout},)")


# ---------------------------------------------------------------------------
# JSON / dict spec ingestion (the dependency-free path)
# ---------------------------------------------------------------------------


def from_spec(spec: Mapping[str, Any]) -> Graph:
    """Build a validated :class:`Graph` from the pure-Python spec::

        {"name": "lenet",
         "input": {"hw": 28, "channels": 1},
         "nodes": [
           {"op": "conv", "name": "c1", "input": "input",
            "out_channels": 6, "kernel": 5, "padding": "same"},
           {"op": "relu", "name": "r1", "input": "c1"},
           ...]}

    Each node entry carries ``op``, ``name``, ``input`` (or ``inputs``
    for binary ops) plus the op's attrs (:data:`OP_ATTRS`). Unknown
    keys are rejected — a typo'd attribute must not silently become a
    default.
    """
    if not isinstance(spec, Mapping):
        raise GraphError(f"graph spec must be a mapping, got "
                         f"{type(spec).__name__}")
    missing = {"name", "input", "nodes"} - set(spec)
    if missing:
        raise GraphError(f"graph spec is missing {sorted(missing)}")
    inp = spec["input"]
    if not isinstance(inp, Mapping) or {"hw", "channels"} - set(inp):
        raise GraphError("spec 'input' must be {'hw': H, 'channels': C}")
    nodes = []
    for i, entry in enumerate(spec["nodes"]):
        if "op" not in entry or "name" not in entry:
            raise GraphError(f"spec node #{i} needs 'op' and 'name': "
                             f"{dict(entry)!r}")
        op, name = str(entry["op"]), str(entry["name"])
        if op not in OP_ATTRS:
            raise UnsupportedOpError(
                name, f"unknown op {op!r} (importable ops: "
                      f"{', '.join(OPS)})")
        if op in _BINARY_OPS:
            inputs = tuple(entry.get("inputs", ()))
        else:
            inputs = (entry["input"],) if "input" in entry else ()
        required, optional = OP_ATTRS[op]
        attrs: dict[str, Any] = dict(optional)
        known = set(required) | set(optional)
        for key, val in entry.items():
            if key in ("op", "name", "input", "inputs"):
                continue
            if key not in known:
                raise GraphError(
                    f"node {name!r}: unknown attribute {key!r} for op "
                    f"{op!r} (takes: {', '.join(sorted(known)) or 'none'})")
            attrs[key] = val
        for key in required:
            if attrs.get(key) is None:
                raise GraphError(f"node {name!r}: op {op!r} requires "
                                 f"attribute {key!r}")
        nodes.append(Node(op=op, name=name, inputs=inputs, attrs=attrs))
    return Graph.build(str(spec["name"]), int(inp["hw"]),
                       int(inp["channels"]), nodes)


def load_spec(path: str | os.PathLike) -> Graph:
    """Read a JSON graph spec file and build the validated graph."""
    with open(path) as f:
        try:
            spec = json.load(f)
        except json.JSONDecodeError as e:
            raise GraphError(f"{path}: not valid JSON: {e}") from None
    return from_spec(spec)
