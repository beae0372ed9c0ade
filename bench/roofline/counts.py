"""Operations and bytes of each layer of a configuration, from its shapes
alone, so they count the same work whatever implements it.

A conv or fc layer does ``2 x MACs`` int8 operations a frame. Its bytes
are, each counted once a batch: its int8 input activation, its int8
weights, its int32 bias and int32 shift, and its output (int8; the last
engine's int32 accumulators). An im2col patch matrix is an
implementation's intermediate and is never counted, so moving im2col into
the kernel cannot move these numbers. A pool layer does no operations;
its bytes are its input and output. A layer's least time is the larger
of operations over the peak rate and bytes over the peak bandwidth."""

from __future__ import annotations

from bench.reference.cnn_int8 import layer_geometry


def layer_counts(cfg: dict, batch: int) -> list[dict]:
    """``{name, kind, ops, bytes}`` of each layer for one batch."""
    geo = layer_geometry(cfg)
    last = [g for g in geo if g["kind"] != "pool"][-1]["name"]
    rows = []
    for g in geo:
        hw_in, hw_out = g["in_hw"], g["out_hw"]
        if g["kind"] == "fc":
            act_in = g["in_ch"]
        else:
            act_in = hw_in * hw_in * g["in_ch"]
        act_out = hw_out * hw_out * g["out_ch"]
        if g["kind"] == "pool":
            ops, fixed = 0, 0
        else:
            cin = g["in_ch"] if g["kind"] == "fc" else (
                g["kernel"] * g["kernel"] * g["in_ch"] // g.get("groups", 1))
            ops = 2 * act_out * cin
            fixed = cin * g["out_ch"] + 8 * g["out_ch"]
        out_bytes = 4 if g["name"] == last else 1
        rows.append({"name": g["name"], "kind": g["kind"],
                     "ops": batch * ops,
                     "bytes": batch * (act_in + out_bytes * act_out) + fixed})
    return rows


def ops_per_frame(cfg: dict) -> int:
    return sum(r["ops"] for r in layer_counts(cfg, 1))


def least_seconds(cfg: dict, batch: int, peak_ops: float,
                  peak_bytes: float) -> float:
    """The least time one batch of the whole chain could take: the sum
    over layers of each layer's bound."""
    return sum(max(r["ops"] / peak_ops, r["bytes"] / peak_bytes)
               for r in layer_counts(cfg, batch))
