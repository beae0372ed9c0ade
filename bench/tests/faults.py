"""Faults planted under the timed path, for the test that the comparison
catches them. Each is installed in a fresh process before the harness
compiles the program:

* ``stale_state``: the last stage hands back the previous batch's answers,
  its state unchanged;
* ``half_batch``: half of each batch is left out, the mean of the rest's
  answers given in its place;
* ``handoff``: the hand-off between pipeline stages is left out, the next
  stage reading zeros (one card's analogue of the exchange between
  chips);
* ``altered``: one accumulator of the last engine is altered where it is
  produced.
"""

from __future__ import annotations

import numpy as np
import torch

FAULTS = ("stale_state", "half_batch", "handoff", "altered")


def install(name: str) -> None:
    from repro_torch.core import program as P
    from repro_torch.serving import pipeline_executor as PE

    if name == "stale_state":
        orig = P.CompiledRunner.dequantize
        last = {}

        def dequantize(self, acc):
            out = orig(self, acc)
            prev = last.get(id(self), out)
            last[id(self)] = out
            return prev
        P.CompiledRunner.dequantize = dequantize
    elif name == "half_batch":
        orig = P.CompiledRunner.dequantize

        def dequantize(self, acc):
            out = np.array(orig(self, acc))
            h = len(out) // 2
            out[h:] = out[:h].mean(axis=0)
            return out
        P.CompiledRunner.dequantize = dequantize
    elif name == "handoff":
        orig = PE.PipelineExecutor._run_stage

        def run_stage(self, i, payload):
            if i > 0:
                payload = torch.zeros_like(payload)
            return orig(self, i, payload)
        PE.PipelineExecutor._run_stage = run_stage
    elif name == "altered":
        orig = P._step_kernel

        def step(xq, st):
            out = orig(xq, st)
            if not st.requantize:
                out = out.clone()
                out.reshape(-1)[0] += 1
            return out
        P._step_kernel = step
    else:
        raise ValueError(f"unknown fault {name!r}")
