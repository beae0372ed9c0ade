"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right, and serves.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero without the final
line:

1. environment: the card, its power limit, torch/CUDA versions, and the
   build of every CUDA source of the port with ``nvcc`` (one ``nvcc`` per
   source, all started together, each build timed);
2. ``gemm_int8`` against its plain version on the card, bit for bit: the
   reference's shape sweep, ``emit_int32``/ReLU, biases near +-2^30, every
   shift in -31..31 with accumulators at the int32 rails, and the 8
   AlexNet engine shapes, each timed (kernel, plain version, one library
   call) beside its bound;
3. full-width AlexNet served through ``serve`` on the default (kernel)
   route, with the kernels' launches counted; every served frame's logits
   equal the oracle route's on the same frames; on one batch the raw
   int32 accumulators of the kernel, oracle and f32 routes are identical
   on the card and equal the plain integer oracle run on the CPU; and a
   breakdown of one batch's time (host enqueue, wall, device by kernel);
4. ``flash_attention`` against its plain version on the card: the
   reference's test shapes (2e-5 in float32, 3e-2 in bfloat16), a query
   block shorter than the keys, GQA, and the Yi-6B shape, which is timed
   (kernel, plain version, one library call) beside its bound;
5. Yi-6B at full width (seed 0, bf16, weights drawn on the card): the
   cache-less forward on 2 x 2048 tokens on the kernel impl, with its
   ``flash_attention`` launches counted (one per layer), held against the
   torch impl and both against a float32 forward of the same weights;
   the forward's wall time, device time by kernel and idle share;
6. Yi-6B served through ``repro_torch.launch.serve.main`` (batch 4,
   prompt 512, 32 generated), and a teacher-forced decode over the cache
   held against the kernel forward's logits at the same positions;
7. the ``kernels`` line, the card's ``nvidia-smi`` name and power limit,
   and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.executor import EngineExecutor  # noqa: E402
from repro_torch.core.program import ROUTES  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel  # noqa
from repro_torch.kernels.conv2d_int8.kernel import gemm_int8  # noqa: E402
from repro_torch.kernels.conv2d_int8.ref import (gemm_int8_ref,  # noqa: E402
                                                 requantize_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.server import (compile_for_serving,  # noqa: E402
                                        serve, synthetic_stream)

# Published dense peaks (NVIDIA data sheets), at the card's full power
# limit: int8 and bf16 tensor-core op/s, device-memory bytes/s.
PEAKS = {"H100 SXM": (1979e12, 989e12, 3.35e12),
         "H100 PCIe": (1513e12, 756e12, 2.0e12),
         "H200": (1979e12, 989e12, 4.8e12)}

# AlexNet at batch 16 on the main path: (engine, N, K, M, launches per
# batch, groups, emits int32). A grouped engine's weights are a view of
# M columns of a 2M-wide matrix, as the main path hands them over.
ALEXNET_B16 = [
    ("conv1", 48400, 363, 96, 1, 1, False),
    ("conv2", 11664, 1200, 128, 2, 2, False),
    ("conv3", 2704, 2304, 384, 1, 1, False),
    ("conv4", 2704, 1728, 192, 2, 2, False),
    ("conv5", 2704, 1728, 128, 2, 2, False),
    ("fc6", 16, 9216, 4096, 1, 1, False),
    ("fc7", 16, 4096, 4096, 1, 1, False),
    ("fc8", 16, 4096, 1000, 1, 1, True),
]
SERVE_FRAMES, SERVE_BATCH = 64, 16
GEMM_SOURCE = "src/repro_torch/kernels/conv2d_int8/csrc/gemm_int8.cu"
GEMM_REPLACES = "src/repro/kernels/conv2d_int8/kernel.py:61"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:67"
# flash_attention against its plain version: (label, B, Sq, Skv, H, KV, d,
# dtype, causal, window). The first four are the reference's test cases
# (tests/test_kernels.py); the tolerances are the ones it states.
FLASH_CASES = [
    ("reference f32", 1, 64, 64, 1, 1, 32, torch.float32, False, 0),
    ("reference f32 causal", 2, 128, 128, 2, 2, 64, torch.float32, True, 0),
    ("reference f32 window 64", 1, 256, 256, 2, 2, 64, torch.float32, True,
     64),
    ("reference bf16 window 64", 1, 256, 256, 2, 2, 64, torch.bfloat16,
     True, 64),
    ("Sq < Skv", 2, 64, 192, 4, 2, 64, torch.float32, True, 0),
    ("GQA 8:2, ragged S", 2, 300, 300, 8, 2, 128, torch.bfloat16, True, 0),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# Yi-6B at full width: the forward's batch and length (the flash kernel's
# timed shape), the float32 reference's slice, the served batch.
LM_ARCH = "yi-6b"
LM_B, LM_S = 2, 2048
F32_S, F32_LAST = 512, 64
SERVE_ARGS = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "512",
              "--gen", "32", "--seed", "0"]
TF_PROMPT, TF_STEPS = 504, 8
# Tolerances of the full-width Yi-6B checks, on bf16 logits whose largest
# magnitude is about 5 (the float32 forward's, measured by this script on
# an NVIDIA H100 80GB HBM3 at 700 W). Both attention impls round every matmul output, norm
# and residual add to bf16 over 32 layers; they differ only in where the
# attention logits are rounded (the kernel keeps QK^T in fp32, the torch
# impl rounds it to bf16 first), so that rounding noise, not the kernel,
# sets how far apart they land. Measured: kernel vs torch impl 0.121 max
# |diff| over all 2 x 2048 x 64000 logits; kernel vs float32 0.092 and
# torch impl vs float32 0.099 on the compared slice; the cache's
# teacher-forced logits vs the kernel forward 0.109.
# * LM_ROUTE_TOL bounds |kernel - torch impl| and |teacher-forced -
#   kernel forward|: twice the largest measured spread.
# * The kernel impl's error against float32 may exceed the torch impl's
#   by at most one bf16 ulp at the float32 logits' largest magnitude
#   (2^-5 for magnitudes in [4, 8)): the kernel may not make the model
#   measurably worse than the plain attention does.
LM_ROUTE_TOL = 0.25


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> tuple[str, float, float, float]:
    """(table key, int8 op/s, bf16 op/s, bytes/s) for the card ``name``."""
    key = ("H200" if "H200" in name else
           "H100 PCIe" if "H100" in name and "PCIe" in name else "H100 SXM")
    return (key, *PEAKS[key])


def reset_launches() -> None:
    gemm_int8.launches = 0
    flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "test needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    # Full float32 matmuls everywhere (the float32 references below).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed_build(source):
        t0 = time.perf_counter()
        _build.load(source)
        return round(time.perf_counter() - t0, 3)

    sources = [gemm_kernel.SOURCE, flash_kernel.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        build_s = dict(zip((src.name for src in sources),
                           pool.map(timed_build, sources)))
    env = {"phase": "environment", "device": name, "nvidia_smi": smi_line,
           "peaks_of": card_peaks(name)[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "kernel_build_s": build_s}
    emit(env)
    return env


# ---------------------------------------------------------------------------
# Phase 2: gemm_int8 against its plain version
# ---------------------------------------------------------------------------


def _rand_int8(gen, shape, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8,
                         device="cuda")


def _compare(cases: list, max_err: list, label: str, x, w, shift, bias,
             relu, emit_int32) -> None:
    got = gemm_int8(x, w, shift, bias, relu=relu, emit_int32=emit_int32)
    want = gemm_int8_ref(x, w, shift, bias, relu=relu, emit_int32=emit_int32)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    max_err[0] = max(max_err[0], err)
    exact = torch.equal(got, want)
    cases.append({"case": label, "exact": exact, "max_abs_err": err})
    if not exact:
        raise SmokeFailure(f"gemm_int8 disagrees with its plain version on "
                           f"{label}: max |err| {err}")


def _rails_case():
    """Accumulators exactly at the int32 rails, every shift in -31..31.

    K = 65536 and all-equal rows/columns give acc = (-128)(-128)K = 2^30
    and (-128)(127)K = -2^30 + 2^23; the biases put the first exactly on
    INT32_MAX and the second exactly on INT32_MIN, with no overflow."""
    K = 65536
    rows = torch.tensor([-128, 127, 0, 1, -1], dtype=torch.int8)
    x = rows[:, None].expand(5, K).contiguous()
    w = torch.cat([torch.full((K, 63), -128, dtype=torch.int8),
                   torch.full((K, 63), 127, dtype=torch.int8)], dim=1)
    shift = torch.cat([torch.arange(-31, 32), torch.arange(-31, 32)]).to(
        torch.int32)
    i32 = torch.iinfo(torch.int32)
    bias = torch.cat([torch.full((63,), i32.max - 2 ** 30),
                      torch.full((63,), i32.min + 2 ** 30 - 2 ** 23)]).to(
        torch.int32)
    return [t.cuda() for t in (x, w, shift, bias)]


def _time_cold_ms(fn, flush: torch.Tensor, iters: int = 10) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    write of a buffer larger than L2, so every launch reads its operands
    from device memory as the main path's weights mostly do. A spin of
    about half a millisecond keeps the card busy while the host enqueues
    the flush and ``fn``, so host time never shows up as device time."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _library_call(x, w, shift, bias, relu, emit_int32):
    """One PyTorch int8 GEMM (``torch._int_mm``, cuBLASLt) with the plain
    epilogue on the same inputs, or None where ``_int_mm``'s shape rules
    (more than 16 rows, K and M multiples of 8) exclude them. A K that is
    not a multiple of 8 is zero-padded (the zeros add nothing to the
    product), and N = 16 runs as the transposed product; both operand
    layouts are prepared outside the timed call."""
    N, K = x.shape
    M = w.shape[1]
    if M % 8:
        return None
    if K % 8:
        Kp = -(-K // 8) * 8
        x = torch.nn.functional.pad(x, (0, Kp - K))
        w = torch.nn.functional.pad(w, (0, 0, 0, Kp - K))
    if N > 16:
        a, b, transposed = x.contiguous(), w.contiguous(), False
    elif M > 16 and N % 8 == 0:
        a, b, transposed = w.t().contiguous(), x.t().contiguous(), True
    else:
        return None

    def run():
        acc = torch._int_mm(a, b)
        acc = acc.t() if transposed else acc
        if emit_int32:
            acc = acc + bias[None, :]
            return torch.clamp(acc, min=0) if relu else acc
        return requantize_ref(acc, shift, bias, relu)
    return run


def _bound_ms(N, K, M, emit_int32, peak_ops, peak_bytes):
    ops = 2 * N * K * M
    nbytes = N * K + K * M + 8 * M + N * M * (4 if emit_int32 else 1)
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / peak_bytes * 1e3
    return ops, nbytes, max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_gemm(env: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases: list = []
    max_err = [0]
    # The reference's shape sweep (tests/test_kernels.py), plain epilogue.
    for n, k, m in [(17, 40, 33), (128, 128, 128), (300, 100, 260),
                    (1, 9, 1)]:
        x, w = _rand_int8(gen, (n, k)), _rand_int8(gen, (k, m), -50, 50)
        shift = torch.randint(0, 12, (m,), generator=gen, device="cuda",
                              dtype=torch.int32)
        _compare(cases, max_err, f"sweep {n}x{k}x{m}", x, w, shift, None,
                 False, False)
    # emit_int32 / ReLU / biases near +-2^30 / every shift in -31..31.
    x, w = _rand_int8(gen, (70, 333)), _rand_int8(gen, (333, 63))
    shift = torch.arange(-31, 32, dtype=torch.int32, device="cuda")
    bias = torch.randint(-2 ** 30, 2 ** 30, (63,), generator=gen,
                         device="cuda", dtype=torch.int32)
    bias[:8] = torch.tensor([2 ** 30, -(2 ** 30), 2 ** 30 - 1,
                             -(2 ** 30) + 1, 0, 1, -1, 2 ** 29],
                            dtype=torch.int32)
    for relu in (False, True):
        for emit_int32 in (False, True):
            _compare(cases, max_err, f"epilogue relu={relu} "
                     f"emit_int32={emit_int32}", x, w, shift, bias, relu,
                     emit_int32)
    rx, rw, rshift, rbias = _rails_case()
    for relu in (False, True):
        for emit_int32 in (False, True):
            _compare(cases, max_err, f"int32 rails relu={relu} "
                     f"emit_int32={emit_int32}", rx, rw, rshift, rbias,
                     relu, emit_int32)
    rails = gemm_int8(rx, rw, rshift, rbias, emit_int32=True)
    i32 = torch.iinfo(torch.int32)
    if int(rails[0, 0]) != i32.max or int(rails[0, 63]) != i32.min:
        raise SmokeFailure("the rails case does not reach INT32_MAX/MIN")

    # The AlexNet engine shapes, checked and timed.
    _, peak_ops, _, peak_bytes = card_peaks(env["device"])
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    shapes = []
    for name, N, K, M, launches, groups, emit_int32 in ALEXNET_B16:
        x = _rand_int8(gen, (N, K))
        w = _rand_int8(gen, (K, M * groups))[:, :M]    # ld = groups * M
        shift = torch.randint(-2, 20, (M,), generator=gen, device="cuda",
                              dtype=torch.int32)
        bias = torch.randint(-2 ** 24, 2 ** 24, (M,), generator=gen,
                             device="cuda", dtype=torch.int32)
        relu = not emit_int32
        _compare(cases, max_err, f"alexnet {name} {N}x{K}x{M}", x, w, shift,
                 bias, relu, emit_int32)
        ms = _time_cold_ms(lambda: gemm_int8(
            x, w, shift, bias, relu=relu, emit_int32=emit_int32), flush)
        plain_ms = _time_cold_ms(lambda: gemm_int8_ref(
            x, w, shift, bias, relu=relu, emit_int32=emit_int32), flush)
        lib = _library_call(x, w, shift, bias, relu, emit_int32)
        library_ms, library_note = None, None
        if lib is None:
            library_note = "torch._int_mm shape rules exclude this shape"
        else:
            try:
                same = torch.equal(lib(), gemm_int8(
                    x, w, shift, bias, relu=relu, emit_int32=emit_int32))
                library_ms = _time_cold_ms(lib, flush)
                library_note = "exact" if same else "differs from kernel"
                if K % 8:
                    library_note += f", K zero-padded to {-(-K // 8) * 8}"
            except RuntimeError as e:       # a yardstick, not the port
                library_note = f"torch._int_mm refused: {e}"[:200]
        ops, nbytes, bound_ms, bound_by = _bound_ms(N, K, M, emit_int32,
                                                    peak_ops, peak_bytes)
        row = {"phase": "gemm_int8_shape", "engine": name, "N": N, "K": K,
               "M": M, "ld_w": w.stride(0), "launches_per_batch": launches,
               "emit_int32": emit_int32, "ops": ops, "bytes": nbytes,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": library_note, "bound_ms": bound_ms,
               "bound_by": bound_by, "exact": True}
        shapes.append(row)
        emit(row)
    del flush
    emit({"phase": "gemm_int8_vs_plain", "cases": len(cases),
          "all_exact": all(c["exact"] for c in cases),
          "max_abs_err": max_err[0],
          "failed": [c["case"] for c in cases if not c["exact"]]})

    # Per AlexNet batch: the sum over the 11 launches.
    def per(key):
        return sum(r[key] * r["launches_per_batch"] for r in shapes)
    t_ops = per("ops") / peak_ops * 1e3
    t_bytes = per("bytes") / peak_bytes * 1e3
    have_lib = all(r["library_ms"] is not None for r in shapes)
    return {"max_abs_err": max_err[0], "ms": per("ms"),
            "plain_ms": per("plain_ms"), "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": per("library_ms") if have_lib else None}


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def _program_on_cpu(prog):
    steps = [dataclasses.replace(
        s, wq=None if s.wq is None else s.wq.cpu(),
        bias_q=None if s.bias_q is None else s.bias_q.cpu(),
        shift=None if s.shift is None else s.shift.cpu())
        for s in prog.steps]
    return dataclasses.replace(prog, steps=steps, device=torch.device("cpu"))


def phase_main_path() -> dict:
    reset_launches()
    result = serve("alexnet", frames=SERVE_FRAMES, batch=SERVE_BATCH,
                   output="logits", device="cuda", verbose=False,
                   return_outputs=True)
    torch.cuda.synchronize()
    launches = gemm_int8.launches
    if flash_attention.launches:
        raise SmokeFailure("the AlexNet path launched flash_attention")
    served = result.pop("outputs")
    expect = 11 * result["batches"]
    emit({"phase": "serve", **result, "gemm_int8_launches": launches,
          "expected_launches": expect})
    if result["route"] != "kernel" or launches != expect:
        raise SmokeFailure(f"the served path ran route {result['route']} "
                           f"with {launches} gemm_int8 launches, expected "
                           f"the kernel route with {expect}")

    # Every served frame against the oracle route of the same seeded
    # program on the same frames. The logits of distinct frames differ,
    # so a batch staged, ordered or padded wrongly shows here even where
    # the random model gives most frames one top-1 class.
    prog = compile_for_serving("alexnet", seed=0, device="cuda")
    stream = synthetic_stream("alexnet", SERVE_FRAMES, 0)
    oracle = prog.compile_runner(route="oracle")
    want = np.concatenate([oracle.logits(stream[i:i + SERVE_BATCH])
                           for i in range(0, SERVE_FRAMES, SERVE_BATCH)])
    served_check = {
        "phase": "served_vs_oracle", "frames": len(served),
        "shape": list(served.shape),
        "exact": served.shape == want.shape and bool(
            np.array_equal(served, want)),
        "max_abs_err": float(np.abs(served - want).max())
        if served.shape == want.shape else None,
        "finite": bool(np.isfinite(served).all()),
        "distinct_frames": len(np.unique(served, axis=0)),
        "distinct_top1": len(np.unique(served.argmax(-1)))}
    emit(served_check)
    if not (served_check["exact"] and served_check["finite"]
            and served_check["distinct_frames"] == SERVE_FRAMES):
        raise SmokeFailure(f"served outputs check failed: {served_check}")

    # One batch through every route on the card.
    frames = stream[:SERVE_BATCH]
    accs, top1 = {}, {}
    for route in ROUTES:
        runner = prog.compile_runner(route=route)
        acc = runner(runner.quantize(frames))
        torch.cuda.synchronize()
        accs[route] = acc
        top1[route] = np.argmax(runner.dequantize(acc), axis=-1)
    kernel_acc = accs["kernel"]
    logits = prog.compile_runner().dequantize(kernel_acc)
    routes_identical = all(torch.equal(kernel_acc, accs[r]) for r in ROUTES)
    top1_identical = all(np.array_equal(top1["kernel"], top1[r])
                         for r in ROUTES)
    # The plain integer oracle on the CPU, on two frames of the same batch.
    cpu_prog = _program_on_cpu(prog)
    cpu_runner = cpu_prog.compile_runner(route="oracle")
    cpu_acc = cpu_runner(cpu_runner.quantize(frames[:2]))
    matches_cpu = torch.equal(cpu_acc, kernel_acc[:2].cpu())
    served_top1 = [int(t) for t in top1["kernel"][:4]]
    check = {"phase": "routes", "batch": SERVE_BATCH,
             "acc_shape": list(kernel_acc.shape),
             "acc_dtype": str(kernel_acc.dtype),
             "routes_identical_int32": routes_identical,
             "top1_identical": top1_identical,
             "kernel_matches_cpu_oracle": matches_cpu,
             "logits_finite": bool(np.isfinite(logits).all()),
             "top1_matches_served": served_top1 == result["sample_top1"],
             "top1": [int(t) for t in top1["kernel"]]}
    emit(check)
    ok = (routes_identical and top1_identical and matches_cpu
          and check["logits_finite"] and check["top1_matches_served"]
          and check["acc_shape"] == [SERVE_BATCH, 1000]
          and kernel_acc.dtype == torch.int32)
    if not ok:
        raise SmokeFailure(f"route check failed: {check}")
    phase_breakdown(prog, frames)
    return {"launches": launches}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def phase_breakdown(prog, frames) -> None:
    """Where one batch's time goes on the default route: a warm
    ``EngineExecutor``'s time per batch over 16 batches, beside the host's
    batch assembly (``np.stack``), quantize-in and dequantize/argmax, the
    host enqueue time and wall time of the chain alone, and the device
    time by kernel from ``torch.profiler`` (one profiled chain; its idle
    share is taken against the unprofiled wall time). What the parts do
    not cover of the executor's batch is reported as unattributed."""
    runner = prog.compile_runner()
    stream = synthetic_stream("alexnet", 16 * len(frames), 1)
    ex = EngineExecutor(prog, batch_size=len(frames))
    ex.serve(stream)
    executor_ms = 1e3 * len(frames) / ex.stats.steady_fps
    n = 20
    rows = list(frames)
    t0 = time.perf_counter()
    for _ in range(n):
        np.stack(rows)
    stack_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        xq_host = runner.quantize(frames)
    quantize_ms = (time.perf_counter() - t0) / n * 1e3
    xq = torch.as_tensor(xq_host, device="cuda")
    acc = runner(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        np.argmax(runner.dequantize(acc), axis=-1)
    decode_ms = (time.perf_counter() - t0) / n * 1e3
    for _ in range(3):
        runner(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        runner(xq)
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    # Host time of one gemm_int8 call (checks, allocation, ctypes launch),
    # at fc8's shape, without waiting for the card.
    fc8 = prog.steps[-1]
    x8 = torch.zeros((len(frames), fc8.wq.shape[0]), dtype=torch.int8,
                     device="cuda")
    t0 = time.perf_counter()
    for _ in range(n):
        gemm_int8(x8, fc8.wq, fc8.shift, fc8.bias_q, emit_int32=True)
    gemm_host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner(xq)
        torch.cuda.synchronize()
    # Kernels only: an aten op's own row repeats the device time of the
    # kernels it launched, so summing every row would count them twice.
    ops = sorted(((e.key, _device_us(e)) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and _device_us(e) > 0
                  and not e.key.startswith("Activity Buffer")),
                 key=lambda kv: -kv[1])
    device_ms = sum(us for _, us in ops) / 1e3
    gemm_ms = sum(us for k, us in ops if "gemm_int8" in k) / 1e3
    emit({"phase": "breakdown", "route": runner.route, "batch": len(frames),
          "executor_ms_per_batch": executor_ms,
          "executor_steady_fps": ex.stats.steady_fps,
          "executor_batches": ex.stats.batches,
          "unattributed_ms": executor_ms - (stack_ms + quantize_ms
                                            + wall_ms + decode_ms),
          "host_stack_ms": stack_ms,
          "host_quantize_ms": quantize_ms, "host_decode_ms": decode_ms,
          "host_enqueue_ms": enqueue_ms, "wall_ms": wall_ms,
          "gemm_int8_host_us_per_call": gemm_host_us,
          "device_busy_ms": device_ms, "gemm_int8_ms": gemm_ms,
          "other_device_ms": device_ms - gemm_ms,
          "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
          "top_device_ops_us": [[k[:60], round(us, 1)] for k, us in ops[:6]]})


# ---------------------------------------------------------------------------
# Phase 4: flash_attention against its plain version
# ---------------------------------------------------------------------------


def _check_flash(label, q, k, v, causal, window) -> float:
    """The kernel against the plain version on the same input values
    (upcast to float32, as the reference's tests hold bf16 against a
    float32 ``attention_ref``), at the reference's tolerances."""
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[q.dtype]
    err = float((got.float() - want).abs().max())
    ok = got.dtype == q.dtype and got.shape == q.shape and bool(
        torch.allclose(got.float(), want, rtol=tol, atol=tol))
    emit({"phase": "flash_attention_case", "case": label,
          "q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype),
          "causal": causal, "window": window, "tol": tol,
          "max_abs_err": err, "ok": ok})
    if not ok:
        raise SmokeFailure(f"flash_attention disagrees with its plain "
                           f"version on {label}: max |err| {err}")
    return err


def phase_flash(env: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    max_err = 0.0
    for label, B, Sq, Skv, H, KV, d, dtype, causal, window in FLASH_CASES:
        q, k, v = (rand((B, Sq, H, d), dtype), rand((B, Skv, KV, d), dtype),
                   rand((B, Skv, KV, d), dtype))
        max_err = max(max_err, _check_flash(label, q, k, v, causal, window))

    cfg = ARCHS[LM_ARCH]
    B, S, H, KV, d = LM_B, LM_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rand((B, S, H, d), torch.bfloat16)
    k, v = rand((B, S, KV, d), torch.bfloat16), rand((B, S, KV, d),
                                                     torch.bfloat16)
    max_err = max(max_err, _check_flash("Yi-6B", q, k, v, True, 0))
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    ms = _time_cold_ms(lambda: flash_attention(q, k, v, causal=True), flush)
    plain_ms = _time_cold_ms(lambda: attention_ref(q, k, v, causal=True),
                             flush)
    # The yardstick: one PyTorch call of the same function, K/V heads
    # repeated and every operand permuted to [B,H,S,d] outside the timed
    # call. The port never calls it.
    qh = q.permute(0, 2, 1, 3)
    kh, vh = (t.repeat_interleave(H // KV, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms, library_note = None, None
    try:
        lib_out = sdpa(qh, kh, vh, is_causal=True).permute(0, 2, 1, 3)
        library_note = "max |diff| vs kernel %.3g" % float(
            (lib_out.float() - flash_attention(q, k, v).float()).abs().max())
        library_ms = _time_cold_ms(lambda: sdpa(qh, kh, vh, is_causal=True),
                                   flush)
    except RuntimeError as e:           # a yardstick, not the port
        library_note = f"scaled_dot_product_attention refused: {e}"[:200]
    del flush
    _, _, peak_bf16, peak_bytes = card_peaks(env["device"])
    flops = 4 * B * H * S * S * d // 2           # causal: half of QK^T + PV
    nbytes = 2 * B * S * d * (2 * H + 2 * KV)    # q, k, v, o once, bf16
    t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bytes * 1e3
    row = {"phase": "flash_attention_yi6b", "shape": [B, S, H, KV, d],
           "dtype": "bfloat16", "causal": True, "flops": flops,
           "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": library_note,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / ms / 1e9}
    emit(row)
    return {"max_abs_err": max_err, **{k: row[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


# ---------------------------------------------------------------------------
# Phase 5: Yi-6B at full width, the cache-less forward
# ---------------------------------------------------------------------------


def _to(node, dtype):
    if isinstance(node, dict):
        return {k: _to(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dtype) for v in node]
    return node.to(dtype)


def _forward(params, cfg, tokens, impl):
    L.set_attention_impl(impl)
    try:
        return T.forward(params, cfg, {"tokens": tokens})[0]
    finally:
        L.set_attention_impl(None)


def _close(a, b) -> dict:
    """How far bf16 logits ``a`` are from ``b``: max |diff|, and whether
    they meet the reference's model tolerance (rtol 6e-2, atol 8e-2)."""
    a, b = a.float(), b.float()
    return {"max_abs_diff": float((a - b).abs().max()),
            "allclose_6e-2_8e-2": bool(torch.allclose(a, b, rtol=6e-2,
                                                      atol=8e-2))}


def _is_matmul(kernel_name: str) -> bool:
    """cuBLAS's and CUTLASS's GEMM kernels, by name."""
    return any(tag in kernel_name.lower()
               for tag in ("gemm", "nvjet", "cutlass", "xmma"))


def phase_lm_forward() -> dict:
    cfg = ARCHS[LM_ARCH]
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=gen,
                           device="cuda")

    # The main path: counts at 0 just before, read just after.
    reset_launches()
    logits_k = _forward(params, cfg, tokens, "kernel")
    torch.cuda.synchronize()
    launches = flash_attention.launches
    emit({"phase": "lm_forward", "arch": LM_ARCH,
          "params": T.param_count(cfg), "init_s": init_s,
        "tokens": [LM_B, LM_S], "impl": "kernel",
        "flash_attention_launches": launches,
        "expected_launches": cfg.n_layers,
        "gemm_int8_launches": gemm_int8.launches,
        "logits_shape": list(logits_k.shape),
        "finite": bool(torch.isfinite(logits_k).all())})
    if launches != cfg.n_layers or gemm_int8.launches:
        raise SmokeFailure(f"the Yi-6B forward launched flash_attention "
                           f"{launches} times, expected {cfg.n_layers}")
    if not torch.isfinite(logits_k).all():
        raise SmokeFailure("the Yi-6B forward gave non-finite logits")

    # Wall time of a warm forward, and its device time by kernel.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _forward(params, cfg, tokens, "kernel")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _forward(params, cfg, tokens, "kernel")
        torch.cuda.synchronize()
    ops = sorted(((e.key, _device_us(e), e.count)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and _device_us(e) > 0
                  and not e.key.startswith("Activity Buffer")),
                 key=lambda kv: -kv[1])
    device_ms = sum(us for _, us, _ in ops) / 1e3
    flash_ms = sum(us for k, us, _ in ops if "flash_fwd" in k) / 1e3
    matmul = [(us, n) for k, us, n in ops if _is_matmul(k)]
    emit({"phase": "lm_forward_time", "wall_ms": wall_ms,
          "device_busy_ms": device_ms, "flash_attention_ms": flash_ms,
          "matmul_ms": sum(us for us, _ in matmul) / 1e3,
          "matmul_launches": sum(n for _, n in matmul),
          "other_ms": device_ms - flash_ms
          - sum(us for us, _ in matmul) / 1e3,
          "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "top_device_ops_us_count": [[k[:60], round(us, 1), n]
                                      for k, us, n in ops[:8]]})

    # The torch impl on the same tokens, and both against float32 on the
    # last positions of a 512-token slice of the first sequence (causal,
    # so the bf16 logits there are those of the same 512 tokens).
    logits_t = _forward(params, cfg, tokens, "torch")
    p32 = _to(params, torch.float32)
    logits_32 = _forward(p32, cfg, tokens[:1, :F32_S], "torch")
    del p32
    torch.cuda.empty_cache()
    sl = (slice(0, 1), slice(F32_S - F32_LAST, F32_S))
    ref = logits_32[:, F32_S - F32_LAST:]
    kernel_vs_f32 = _close(logits_k[sl], ref)
    torch_vs_f32 = _close(logits_t[sl], ref)
    routes = _close(logits_k, logits_t)
    top1 = float((logits_k.argmax(-1) == logits_t.argmax(-1)).float().mean())
    check = {"phase": "lm_routes", "kernel_vs_torch": routes,
             "top1_agreement": top1,
             "f32_slice": [1, F32_S], "f32_positions_compared": F32_LAST,
             "f32_logits_max_abs": float(ref.abs().max()),
             "kernel_vs_f32": kernel_vs_f32, "torch_vs_f32": torch_vs_f32,
             "kernel_minus_torch_err_vs_f32":
                 kernel_vs_f32["max_abs_diff"] - torch_vs_f32["max_abs_diff"],
             "finite": bool(torch.isfinite(logits_t).all()
                            and torch.isfinite(logits_32).all())}
    f32_max = check["f32_logits_max_abs"]
    margin = 2.0 ** (math.floor(math.log2(f32_max)) - 7)   # one bf16 ulp
    check.update(route_tol=LM_ROUTE_TOL, f32_margin=margin)
    emit(check)
    if not (check["finite"]
            and routes["max_abs_diff"] <= LM_ROUTE_TOL
            and kernel_vs_f32["max_abs_diff"]
            <= torch_vs_f32["max_abs_diff"] + margin):
        raise SmokeFailure(f"Yi-6B logits out of tolerance: {check}")
    return {"params": params, "tokens": tokens, "logits_k": logits_k,
            "launches": launches}


# ---------------------------------------------------------------------------
# Phase 6: Yi-6B served, and the cache against the kernel forward
# ---------------------------------------------------------------------------


def phase_lm_serve(lm: dict) -> None:
    cfg = ARCHS[LM_ARCH]
    reset_launches()
    result = lm_serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    ids = np.asarray(result.pop("ids"))
    row = {"phase": "lm_serve", **result,
           "flash_attention_launches": flash_attention.launches,
           "ids_shape": list(ids.shape),
           "ids_in_vocab": bool(((ids >= 0) & (ids < cfg.vocab)).all()),
           "sample_ids": ids[0, :8].tolist()}
    emit(row)
    if ids.shape != (4, 32) or not row["ids_in_vocab"]:
        raise SmokeFailure(f"serve gave ids of shape {ids.shape}")
    if flash_attention.launches:
        raise SmokeFailure("prefill/decode launched flash_attention: the "
                           "kernel's path is the cache-less forward")

    # Teacher-forced: prefill TF_PROMPT tokens, decode the next TF_STEPS
    # over the cache, and hold the logits of positions TF_PROMPT - 1 ..
    # TF_PROMPT + TF_STEPS - 1 against the kernel forward's.
    params, tokens = lm["params"], lm["tokens"]
    # One slot more than the check needs: the decode breakdown's step.
    cache = T.init_cache(cfg, LM_B, TF_PROMPT + TF_STEPS + 1, device="cuda")
    logits_p, cache, _ = T.forward(params, cfg,
                                   {"tokens": tokens[:, :TF_PROMPT]},
                                   cache=cache)
    outs = [logits_p[:, -1]]
    for t in range(TF_PROMPT, TF_PROMPT + TF_STEPS):
        lg, cache, _ = T.forward(params, cfg,
                                 {"tokens": tokens[:, t:t + 1]}, cache=cache)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    want = lm["logits_k"][:, TF_PROMPT - 1:TF_PROMPT + TF_STEPS]
    check = {"phase": "lm_teacher_forced", "prompt": TF_PROMPT,
             "steps": TF_STEPS, "vs_kernel_forward": _close(got, want),
             "top1_agreement": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
             "finite": bool(torch.isfinite(got).all()),
             "route_tol": LM_ROUTE_TOL}
    emit(check)
    if not (check["finite"] and check["vs_kernel_forward"]["max_abs_diff"]
            <= LM_ROUTE_TOL):
        raise SmokeFailure(f"teacher-forced decode disagrees with the "
                           f"kernel forward: {check}")
    phase_decode_breakdown(params, cache, tokens[:, :1])


def phase_decode_breakdown(params, cache, tok) -> None:
    """Where a warm decode step's time goes at full width: wall time of
    single synchronised steps, the host's enqueue time of a run of steps,
    and one profiled step's device time by kernel. Every step is given
    the same cache, so each writes the same slot and attends over the
    same length."""
    cfg = ARCHS[LM_ARCH]
    decode = lm_steps.make_serve_step(cfg)
    pos = cache["_pos"]

    def step():
        decode(params, cache, {"tokens": tok})

    n = 8
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    ops = sorted(((e.key, _device_us(e), e.count)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and _device_us(e) > 0
                  and not e.key.startswith("Activity Buffer")),
                 key=lambda kv: -kv[1])
    device_ms = sum(us for _, us, _ in ops) / 1e3
    wall_ms = float(np.median(walls))
    param_bytes = T.param_count(cfg) * params["embed"].element_size()
    _, _, _, peak_bytes = card_peaks(torch.cuda.get_device_name(0))
    emit({"phase": "lm_decode_breakdown", "batch": tok.shape[0],
          "cache_len": pos, "wall_ms_median": wall_ms,
          "wall_ms_min": min(walls), "host_enqueue_ms": enqueue_ms,
          "device_busy_ms": device_ms,
          "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
          "weight_read_bound_ms": param_bytes / peak_bytes * 1e3,
          "kernels": sum(c for _, _, c in ops),
          "top_device_ops_us_count": [[k[:60], round(us, 1), c]
                                      for k, us, c in ops[:8]]})


def main() -> int:
    t_start = time.perf_counter()
    try:
        env = phase_environment()
        gemm = phase_gemm(env)
        main_path = phase_main_path()
        flash = phase_flash(env)
        lm = phase_lm_forward()
        phase_lm_serve(lm)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = [{
        "name": "gemm_int8", "route": "cuda", "source": GEMM_SOURCE,
        "replaces": GEMM_REPLACES, "launches": main_path["launches"],
        "max_abs_err": gemm["max_abs_err"], "ms": gemm["ms"],
        "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
        "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"],
        "per": f"one AlexNet batch of {SERVE_BATCH}: the sum over its 11 "
               f"launches"}, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": lm["launches"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "per": f"one launch at the Yi-6B shape (B {LM_B}, S {LM_S}, H 32, "
               f"KV 4, d 128, bf16, causal); one per layer of a forward"}]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(env["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
