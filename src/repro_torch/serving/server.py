"""Single-model serving: compile a paper CNN and serve a frame stream
through the :class:`~repro_torch.core.executor.EngineExecutor`. The part
of ``repro/serving/server.py`` this port has so far: ``compile_for_serving``,
the synthetic streams and ``serve``. The registry, the multi-tenant
server and the pipelined/QoS/knee paths are still to port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import workload as W
from repro_torch.core.executor import EngineExecutor
from repro_torch.core.program import compile_model, resolve_device
from repro_torch.models import cnn


def compile_for_serving(model_name: str, *, bits: int = 8, seed: int = 0,
                        theta: int | None = None, device=None):
    """Compile ``model_name`` exactly as the serve paths consume it:
    seeded params, a seeded calibration batch, Table I's budget convention
    for the bit width (the plan only affects modeled numbers — never the
    executed arithmetic). ``device`` defaults to ``cuda``.

    Params and calibration batch come from seeded numpy
    (:func:`~repro_torch.models.cnn.init_params_np`,
    ``default_rng(seed + 1)``), so for the same seed the weights differ
    from the reference's ``jax.random`` draw."""
    device = resolve_device(device)
    m = W.CNN_MODELS[model_name]()
    params = cnn.init_params(m, seed, device=device)
    calib = np.random.default_rng(seed + 1).standard_normal(
        (1, m.input_hw, m.input_hw, m.input_ch), dtype=np.float32)
    # 8-bit double-pumps the 900 DSPs, so modeled_fps_alg1 here equals
    # the fps8 column of the paper's Table I.
    if theta is None:
        theta = 2 * 900 - len(m.layers) if bits == 8 else 900
    return compile_model(m, params, bits=bits, calib_batch=calib,
                         theta=theta,
                         bram_total=None if bits == 8 else 545,
                         device=device)


def synthetic_stream_like(model, frames: int, seed: int = 0) -> np.ndarray:
    """The seeded synthetic frame stream for any :class:`CNNModel`
    (explicit RNG: identical frames run to run, and identical to the
    reference's stream for the same seed)."""
    rng = np.random.default_rng(seed + 2)
    return rng.standard_normal(
        (frames, model.input_hw, model.input_hw, model.input_ch),
        dtype=np.float32)


def synthetic_stream(model_name: str, frames: int,
                     seed: int = 0) -> np.ndarray:
    """:func:`synthetic_stream_like` over a named paper CNN."""
    return synthetic_stream_like(W.CNN_MODELS[model_name](), frames, seed)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model_name: str, *, frames: int = 64, batch: int = 16,
          bits: int = 8, route: str | None = None, seed: int = 0,
          theta: int | None = None, eager_frames: int = 0,
          output: str = "top1", verbose: bool = True, device=None,
          return_outputs: bool = False) -> dict:
    """Compile ``model_name``, serve ``frames`` synthetic frames through
    the :class:`EngineExecutor` on ``device`` (default ``cuda``), return a
    result dict (measured/modeled FPS). ``eager_frames > 0`` also times the
    eager per-sample reference loop for comparison. The measurement
    includes the first cold batch, which builds the kernels.
    ``return_outputs`` adds every served frame's output, stacked, under
    ``"outputs"`` so a caller can hold the served path against a
    reference."""
    if frames <= batch:
        raise ValueError(
            f"frames={frames} <= batch={batch}: the whole stream fits in "
            f"the first micro-batch, which is charged to build/warmup, "
            f"leaving no steady-state window to measure (steady_fps would "
            f"be 0). Use frames >= 2*batch.")
    prog = compile_for_serving(model_name, bits=bits, seed=seed, theta=theta,
                               device=device)
    stream = synthetic_stream(model_name, frames, seed)

    ex = EngineExecutor(prog, batch_size=batch, route=route, output=output)
    outs = ex.serve(stream)
    st = ex.stats
    result = {
        "model": model_name,
        "bits": bits,
        "route": ex.runner.route,
        "device": str(prog.device),
        "batch": batch,
        "frames": st.frames,
        "batches": st.batches,
        "padded_frames": st.padded_frames,
        "compile_plus_first_batch_s": round(st.first_batch_s, 3),
        "measured_steady_fps": round(st.steady_fps, 3),
        "modeled_fps_alg1": round(prog.fps(), 3),
        # The port runs eagerly: no executables to count (-1 = unknown).
        "executables": ex.runner.cache_size(),
        "recompiles": None,
        "sample_top1": [int(np.asarray(o).reshape(-1).argmax())
                        if output == "logits" else int(o)
                        for o in outs[:4]],
    }
    if return_outputs:
        result["outputs"] = np.stack(outs)
    if eager_frames > 0:
        prog.run(stream[:1])           # warm the eager path
        _sync(prog.device)
        t0 = time.perf_counter()
        for i in range(eager_frames):
            prog.run(stream[i:i + 1])
        _sync(prog.device)
        dt = time.perf_counter() - t0
        result["eager_fps"] = round(eager_frames / dt, 3)
        result["speedup_vs_eager"] = round(
            result["measured_steady_fps"] / max(result["eager_fps"], 1e-9), 2)
    if verbose:
        print(f"[serve_cnn] {model_name} bits={bits} route={result['route']}"
              f" device={result['device']} batch={batch}: measured "
              f"{result['measured_steady_fps']:.2f} fps (steady), modeled "
              f"{result['modeled_fps_alg1']:.1f} fps (Alg. 1 @200MHz)"
              f" | first batch {st.first_batch_s:.1f}s")
        if "eager_fps" in result:
            print(f"[serve_cnn]   eager per-sample {result['eager_fps']:.2f}"
                  f" fps -> {result['speedup_vs_eager']:.1f}x batched")
    return result
