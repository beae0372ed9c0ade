"""Post-training quantization + golden parity artifacts for imported
models. PyTorch twin of ``repro/compiler/calibrate.py``.

The paper's flow freezes every fixed-point format at compile time from
a calibration pass (``core/program.py::compile_model``); this module is
the importer's front end to that machinery plus the *proof obligation*
that comes with an imported model: a machine-checkable int8 golden, the
way ``tests/golden/`` pins YOLO/ZF.

* :func:`quantize` — seed params if the graph carried none, draw the
  seeded calibration batch, run the float graph through the shared
  calibration pass, and compile the :class:`EngineProgram` (per-channel
  po2 weight exponents, per-tensor activation exponents, int32 bias /
  shift schedules — all frozen here, once).
* :func:`make_golden` / :func:`check_golden` — generate the golden
  record (raw accumulator sample + crc over the full buffer, top-1 ids,
  frozen exponents) on one MAC route and verify it on another: the
  exact-f32, integer-oracle and ``gemm_int8`` kernel routes are
  bit-identical by construction, so an imported model that reproduces
  its golden across routes is running the same integers the engine
  would.

Seeding: params :func:`~repro_torch.models.cnn.init_params_np` with
``seed``, calib ``default_rng(seed + 1)``, frames ``default_rng(seed +
2)``, so an import is reproducible from ``(spec, seed)`` alone. The
reference draws params and calib with ``jax.random``, which torch cannot
reproduce: for the same seed an unseeded import gets other weights and
another calibration batch than the reference's (the frames are the
same). Pass ``params`` and ``calib`` to reproduce the reference's
program, and its golden, exactly.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.core.program import EngineProgram, compile_model
from repro_torch.core.workload import CNNModel
from repro_torch.models import cnn

N_GOLDEN_FRAMES = 2
N_ACC_SAMPLE = 32


class GoldenMismatch(AssertionError):
    """An imported program's int8 execution diverged from its golden —
    the quantization or lowering no longer reproduces the artifact."""


def calib_batch(model: CNNModel, n: int = 1, seed: int = 0) -> np.ndarray:
    """The seeded float calibration batch (activation-range pass), from
    ``default_rng(seed + 1)``."""
    return np.random.default_rng(seed + 1).standard_normal(
        (n, model.input_hw, model.input_hw, model.input_ch),
        dtype=np.float32)


def golden_frames(model: CNNModel, n: int = N_GOLDEN_FRAMES,
                  seed: int = 0) -> np.ndarray:
    """The seeded float frames golden records are computed over (and
    serve smokes replay) — explicit RNG, identical across machines."""
    rng = np.random.default_rng(seed + 2)
    return rng.standard_normal(
        (n, model.input_hw, model.input_hw, model.input_ch),
        dtype=np.float32)


def quantize(model: CNNModel, params=None, *, bits: int = 8,
             seed: int = 0, calib=None, theta: int | None = None,
             device=None, **compile_kwargs) -> EngineProgram:
    """Compile an imported model into a runnable fixed-point
    :class:`EngineProgram`: seeded init when the import carried no
    weights, seeded calibration batch when none is given, Table I's
    double-pumped DSP budget convention for the bit width (matching
    ``serving.server.compile_for_serving`` so imported and paper models
    are planned on the same fabric). ``device`` defaults to ``cuda``."""
    if params is None:
        params = cnn.init_params(model, seed, device=device)
    if calib is None:
        calib = calib_batch(model, 1, seed)
    if theta is None:
        theta = 2 * 900 - len(model.layers) if bits == 8 else 900
    compile_kwargs.setdefault("bram_total", None if bits == 8 else 545)
    return compile_model(model, params, bits=bits, calib_batch=calib,
                         theta=theta, device=device, **compile_kwargs)


def make_golden(prog: EngineProgram, frames: np.ndarray | None = None,
                *, seed: int = 0, route: str = "f32") -> dict:
    """Generate the golden parity record for a compiled program (the
    ``tests/golden/generate.py`` schema): first ``N_ACC_SAMPLE`` raw
    int32 accumulators of frame 0, crc32 of the full accumulator
    buffer, per-frame top-1 ids, and the frozen activation exponents."""
    if frames is None:
        frames = golden_frames(prog.model, seed=seed)
    runner = prog.compile_runner(route=route)
    acc = runner(runner.quantize(np.asarray(frames))).cpu().numpy()
    logits = runner.dequantize(acc)
    return {
        "acc_sample": acc[0].reshape(-1)[:N_ACC_SAMPLE].astype(np.int32),
        "acc_crc": np.int64(zlib.crc32(np.ascontiguousarray(acc)
                                       .tobytes())),
        "top1": np.argmax(logits.reshape(len(frames), -1),
                          -1).astype(np.int64),
        "e_input": np.int64(prog.e_input),
        "e_out": np.asarray([s.e_out for s in prog.steps
                             if s.kind != "pool"], np.int64),
    }


def check_golden(prog: EngineProgram, golden, frames=None, *,
                 seed: int = 0, route: str = "oracle") -> None:
    """Re-execute ``prog`` on ``route`` and verify it reproduces the
    golden bit-exactly. Raises :class:`GoldenMismatch` listing every
    diverging field. Checking on a *different* route than the one that
    generated the golden cross-checks the MAC lowerings against each
    other (f32 / integer oracle / ``gemm_int8`` kernel are bit-identical
    by contract)."""
    got = make_golden(prog, frames, seed=seed, route=route)
    bad = []
    for key in ("e_input", "acc_crc"):
        if int(got[key]) != int(golden[key]):
            bad.append(f"{key}: got {int(got[key])}, golden "
                       f"{int(golden[key])}")
    for key in ("acc_sample", "top1", "e_out"):
        if not np.array_equal(np.asarray(got[key]),
                              np.asarray(golden[key])):
            bad.append(f"{key}: got {np.asarray(got[key]).tolist()}, "
                       f"golden {np.asarray(golden[key]).tolist()}")
    if bad:
        raise GoldenMismatch(
            f"model {prog.model.name!r} (route={route!r}) diverged from "
            f"its golden: " + "; ".join(bad))


def save_golden(path, golden) -> None:
    """Persist a golden record as ``.npz`` (the tests/golden format)."""
    np.savez(path, **golden)


def load_golden(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
