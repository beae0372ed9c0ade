"""Lower an importer :class:`~repro_torch.compiler.graph.Graph` onto the
engine's contract. PyTorch twin of ``repro/compiler/lower.py``: the same
normalisation and checks, with the imported weights as float32 tensors on
the program's device.

The engine executes a *linear chain* of :class:`~repro_torch.core.workload
.ConvLayer` records with a fixed fusion schedule: every non-final
conv/fc engine applies bias + ReLU + requantize in its epilogue, the
final engine emits raw accumulators, and max pooling runs as its own
integer stage between engines (``core/program.py::_lower``). Lowering
therefore has to *normalize* the explicit graph onto that shape:

* **ReLU folding** — a ``relu`` node folds into the conv/fc that feeds
  it. It may also sit *after* an intervening max pool (``conv -> pool
  -> relu``): max and ReLU commute (both monotone), so the fold through
  the pool is exact and the engine's ``conv(+relu) -> pool`` order
  reproduces the source float semantics bit-for-bit.
* **Contract checks** — every non-final compute layer must end up with
  a ReLU (the engine fuses one unconditionally) and the final layer
  must not (it emits accumulators); violations are typed
  :class:`UnsupportedOpError`\\ s naming the layer rather than silently
  computing something else.
* **Legalization** — stride / padding / groups are re-derived through
  the existing :class:`ConvLayer` fields: the layer's own
  ``padding(in_hw)`` must reproduce the graph's declared (lo, hi) pads
  exactly, otherwise the engine's window positions would shift.
* **Rejection** — ops the IR carries but the engine cannot run
  (``avgpool``: the integer pool stage is max-only; ``add``: no
  residual datapath across the linear engine chain) raise
  :class:`UnsupportedOpError`.

The output is a ready-to-compile ``(CNNModel, params-or-None)`` pair:
params are assembled when the graph nodes carry weights (the ONNX
path), as tensors on ``device`` (default ``cuda``), otherwise ``None``
and the caller seeds them (:func:`repro_torch.compiler.calibrate
.quantize`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.compiler.graph import (Graph, Node, UnsupportedOpError,
                                        _square, resolve_padding)
from repro_torch.core.program import resolve_device
from repro_torch.core.workload import CNNModel, ConvLayer

_REJECT_WHY = {
    "avgpool": "average pooling is not representable — the engine's "
               "integer pool stage is max-only (exact on the po2 "
               "format; an average needs a divider the fabric lacks)",
    "add": "residual add is not representable — the engine executes a "
           "linear chain of pipelined stages with no cross-stage "
           "adder datapath",
}


def lower_graph(graph: Graph, *,
                device=None) -> tuple[CNNModel, dict | None]:
    """Normalize + legalize ``graph`` into an engine-ready
    :class:`CNNModel` (plus assembled params, on ``device``, when the
    graph carries weights). Raises :class:`UnsupportedOpError` naming the
    first node the engine cannot take."""
    _require_chain(graph)
    layers: list[ConvLayer] = []
    # Per compute layer: (node, relu_seen). The engine decides relu by
    # position (all but last), so we collect then verify.
    relu_of: dict[str, bool] = {}
    compute_nodes: list[Node] = []
    flattened = False
    hw = graph.input_hw
    for node in graph.nodes:
        if node.op in _REJECT_WHY:
            raise UnsupportedOpError(node.name, _REJECT_WHY[node.op])
        if node.op == "conv":
            if flattened:
                raise UnsupportedOpError(
                    node.name, "conv after flatten/fc — the engine "
                               "chain cannot return to spatial layout")
            layers.append(_lower_conv(node, hw, graph))
            hw = graph.shapes[node.name][0]
            compute_nodes.append(node)
            relu_of[node.name] = False
        elif node.op == "maxpool":
            layers.append(_lower_pool(node, hw, graph))
            hw = graph.shapes[node.name][0]
        elif node.op == "fc":
            flattened = True
            fin = graph.shapes[node.inputs[0]][0]
            layers.append(ConvLayer(node.name, fin,
                                    int(node.attr("out_features")), 1,
                                    kind="fc"))
            compute_nodes.append(node)
            relu_of[node.name] = False
        elif node.op == "relu":
            producer = _relu_producer(node, graph)
            if producer is None or producer.name not in relu_of:
                raise UnsupportedOpError(
                    node.name, "ReLU must follow a conv/fc engine "
                               "(optionally through max pools, where "
                               "the fold commutes exactly)")
            if relu_of[producer.name]:
                raise UnsupportedOpError(
                    node.name, f"second ReLU folding into "
                               f"{producer.name!r} — the engine epilogue "
                               f"applies one")
            relu_of[producer.name] = True
        elif node.op == "flatten":
            if len(graph.shapes[node.inputs[0]]) == 1:
                continue                      # flat already: a no-op
            flattened = True                  # engine folds it into fc
        else:  # pragma: no cover - Graph.build already rejected it
            raise UnsupportedOpError(node.name, f"op {node.op!r}")
    if not compute_nodes:
        raise UnsupportedOpError(
            graph.output, "graph has no conv/fc compute layer — nothing "
                          "for the engine to run")
    # The engine's fusion schedule: ReLU on every engine but the last.
    for node in compute_nodes[:-1]:
        if not relu_of[node.name]:
            raise UnsupportedOpError(
                node.name, "no ReLU activation — the engine fuses "
                           "bias+ReLU+requantize into every non-final "
                           "engine's epilogue and cannot skip the ReLU")
    last = compute_nodes[-1]
    if relu_of[last.name]:
        raise UnsupportedOpError(
            last.name, "trailing ReLU on the final layer — the final "
                       "engine emits raw accumulators (logits); fold "
                       "the activation into the consumer instead")
    model = CNNModel(graph.name, graph.input_hw, graph.input_ch,
                     tuple(layers))
    return model, _collect_params(graph, compute_nodes, device)


def _require_chain(graph: Graph) -> None:
    """The engine pipeline is linear: every node feeds exactly one
    consumer (the terminal feeds none). Branching means a residual/
    multi-head topology the chain cannot hold."""
    consumers = graph.consumers()
    for node in graph.nodes:
        n = len(consumers.get(node.name, ()))
        if n > 1:
            names = [c.name for c in consumers[node.name]]
            raise UnsupportedOpError(
                node.name, f"feeds {n} consumers ({', '.join(names)}) — "
                           f"the engine chain is linear (no fan-out)")


def _lower_conv(node: Node, in_hw: int, graph: Graph) -> ConvLayer:
    k = _square(node.name, "kernel", node.attr("kernel"))
    stride = _square(node.name, "stride", node.attr("stride"))
    lo, hi, out = resolve_padding(in_hw, k, stride, node.attr("padding"),
                                  node.name)
    cin = graph.shapes[node.inputs[0]][2]
    layer = ConvLayer(node.name, cin, int(node.attr("out_channels")), k,
                      stride=stride, groups=int(node.attr("groups")),
                      out_size=out)
    got = layer.padding(in_hw)
    if got != (lo, hi):
        raise UnsupportedOpError(
            node.name, f"declared padding {node.attr('padding')!r} pads "
                       f"(lo, hi)=({lo}, {hi}) but the engine derives "
                       f"{got} for out={out} stride={stride} kernel={k} "
                       f"on input {in_hw} — the window positions would "
                       f"shift; use 'same', 'valid', or a symmetric pad "
                       f"the output arithmetic reproduces")
    return layer


def _lower_pool(node: Node, in_hw: int, graph: Graph) -> ConvLayer:
    k = _square(node.name, "kernel", node.attr("kernel"))
    stride = _square(node.name, "stride",
                     node.attr("stride") if node.attr("stride") is not None
                     else k)
    lo, hi, out = resolve_padding(in_hw, k, stride, node.attr("padding"),
                                  node.name)
    ch = graph.shapes[node.name][2]
    layer = ConvLayer(node.name, ch, ch, k, stride=stride, kind="pool",
                      out_size=out)
    got = layer.padding(in_hw)
    if got != (lo, hi):
        raise UnsupportedOpError(
            node.name, f"declared padding {node.attr('padding')!r} pads "
                       f"(lo, hi)=({lo}, {hi}) but the engine derives "
                       f"{got} — max-pool windows would shift")
    return layer


def _relu_producer(node: Node, graph: Graph) -> Node | None:
    """Walk back through max pools (and no-op flattens) to the conv/fc
    a ReLU folds into. Max pool commutes with ReLU exactly, so the fold
    is semantics-preserving; anything else in between breaks it."""
    by_name = {n.name: n for n in graph.nodes}
    cur = by_name.get(node.inputs[0])
    while cur is not None and cur.op in ("maxpool", "flatten"):
        cur = by_name.get(cur.inputs[0])
    if cur is not None and cur.op in ("conv", "fc"):
        return cur
    return None


def _collect_params(graph: Graph, compute_nodes: list[Node],
                    device=None) -> dict | None:
    """Assemble a ``cnn.init_params``-shaped dict of float32 tensors on
    ``device`` (default ``cuda``) from node-attached weights.
    All-or-nothing: a graph with weights on only some compute layers is a
    broken export, not a half-seeded model."""
    with_w = [n for n in compute_nodes if n.attr("weight") is not None]
    if not with_w:
        return None
    if len(with_w) != len(compute_nodes):
        missing = [n.name for n in compute_nodes
                   if n.attr("weight") is None]
        raise UnsupportedOpError(
            missing[0], f"graph carries weights for "
                        f"{len(with_w)}/{len(compute_nodes)} compute "
                        f"layers (missing: {', '.join(missing)}) — "
                        f"provide all or none (none = seeded init)")
    device = resolve_device(device)
    params: dict = {}
    for n in compute_nodes:
        w = torch.tensor(np.asarray(n.attr("weight"), np.float32),
                         device=device)
        cout = w.shape[-1]
        b = n.attr("bias")
        b = (torch.zeros((cout,), dtype=torch.float32, device=device)
             if b is None else torch.tensor(np.asarray(b, np.float32),
                                            device=device))
        params[n.name] = {"w": w, "b": b}
    return params
