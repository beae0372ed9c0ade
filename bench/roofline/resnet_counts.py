"""Operations and bytes of each layer of a residual configuration, from its
shapes alone (``bench/roofline/counts.py``'s rules, over the residual
graph): a conv or fc layer does ``2 x MACs`` int8 operations a frame and
moves, once a batch, its int8 input (its source's output), its int8
weights, its int32 bias and shift, its output (int8; the last engine's
int32 accumulators) and, where it adds a skip, the skip (int8, the
output's shape). A max pool and the global average pool do no operations
and move their input and output. A layer's least time is the larger of
operations over the peak rate and bytes over the peak bandwidth."""

from __future__ import annotations

from bench.reference.resnet_int8 import layer_geometry


def layer_counts(cfg: dict, batch: int) -> list[dict]:
    """``{name, kind, ops, bytes, weights}`` of each layer for one batch
    (``weights``: its weights and biases, BatchNorm folded in)."""
    rows = []
    for g in layer_geometry(cfg):
        hw_in, hw_out = g["in_hw"], g["out_hw"]
        act_in = g["in_ch"] if g["kind"] == "fc" else \
            hw_in * hw_in * g["in_ch"]
        act_out = hw_out * hw_out * g["out_ch"]
        if g["kind"] in ("pool", "gap"):
            ops, fixed, moved, weights = 0, 0, act_in + act_out, 0
        else:
            cin = g["in_ch"] if g["kind"] == "fc" else (
                g["kernel"] * g["kernel"] * g["in_ch"] // g.get("groups", 1))
            ops = 2 * act_out * cin
            fixed = cin * g["out_ch"] + 8 * g["out_ch"]
            weights = (cin + 1) * g["out_ch"]
            moved = act_in + (4 if g["last"] else 1) * act_out
            if g["res_i"] is not None:
                moved += act_out
        rows.append({"name": g["name"], "kind": g["kind"],
                     "ops": batch * ops, "bytes": batch * moved + fixed,
                     "weights": weights})
    return rows


def ops_per_frame(cfg: dict) -> int:
    return sum(r["ops"] for r in layer_counts(cfg, 1))


def least_seconds(cfg: dict, batch: int, peak_ops: float,
                  peak_bytes: float) -> float:
    """The least time one batch of the whole graph could take: the sum
    over layers of each layer's bound."""
    return sum(max(r["ops"] / peak_ops, r["bytes"] / peak_bytes)
               for r in layer_counts(cfg, batch))
