"""The comparison that decides ``correct``: every answer the window
produced against the plain reference's logits for its frame, bit for bit.

The engine is integer end to end, so a served logit is the last engine's
int32 accumulator times its power-of-two scale and must equal the
reference's exactly. Two numbers are compared, each with the limit 0 (an
exact comparison): ``wrong_frames``, the answers that differ anywhere or
never came, and ``max_logit_gap``, the largest absolute difference of a
served logit from the reference's. Sound runs read 0 on every seed; the
control (the reference at 4 bits in the program's place) and each planted
fault read above 0 (``PERF.md`` gives the readings)."""

from __future__ import annotations

import numpy as np

LIMITS = {"wrong_frames": 0, "max_logit_gap": 0.0}
# Stands for a gap that is not a finite number (a NaN or an infinite
# logit, or answers of another shape), so the result stays valid JSON.
NOT_FINITE = float(np.finfo(np.float64).max)


def compare(outputs: list, pool_index: np.ndarray,
            ref: np.ndarray) -> dict:
    """``outputs[i]`` (a logits vector, or None for an answer that never
    came) against ``ref[pool_index[i]]``."""
    missing = np.array([o is None for o in outputs], dtype=bool)
    wrong = int(missing.sum())
    gap = 0.0
    idx = np.asarray(pool_index)[~missing]
    if len(idx):
        got = np.stack([np.asarray(o, np.float32).reshape(-1)
                        for o in outputs if o is not None])
        want = ref[idx]
        if got.shape != want.shape:
            return {"wrong_frames": len(outputs),
                    "max_logit_gap": NOT_FINITE}
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        diff[~np.isfinite(diff)] = NOT_FINITE
        wrong += int(np.count_nonzero(np.any(got != want, axis=1)))
        gap = float(diff.max()) if diff.size else 0.0
    return {"wrong_frames": wrong, "max_logit_gap": gap}


def correct(readings: dict) -> bool:
    return all(readings[k] <= LIMITS[k] for k in LIMITS)


def report(readings: dict) -> dict:
    """Each number beside its limit, as the result's last key has them."""
    return {k: {"value": readings[k], "limit": LIMITS[k]} for k in LIMITS}
