"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is exact, and serves.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero without the final
line:

1. environment: the card, its power limit, torch/CUDA versions, and the
   build of every CUDA source of the port with ``nvcc``;
2. ``gemm_int8`` against its plain version on the card, bit for bit: the
   reference's shape sweep, ``emit_int32``/ReLU, biases near +-2^30, every
   shift in -31..31 with accumulators at the int32 rails, and the 8
   AlexNet engine shapes, each timed (kernel, plain version, one library
   call) beside its bound;
3. full-width AlexNet served through ``serve`` on the default (kernel)
   route, with the kernel's launches counted; every served frame's logits
   equal the oracle route's on the same frames; on one batch the raw
   int32 accumulators of the kernel, oracle and f32 routes are identical
   on the card and equal the plain integer oracle run on the CPU; and a
   breakdown of one batch's time (host enqueue, wall, device by kernel);
4. the ``kernels`` line, the card's ``nvidia-smi`` name and power limit,
   and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.executor import EngineExecutor  # noqa: E402
from repro_torch.core.program import ROUTES  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d_int8.kernel import (SOURCE,  # noqa: E402
                                                    gemm_int8)
from repro_torch.kernels.conv2d_int8.ref import (gemm_int8_ref,  # noqa: E402
                                                 requantize_ref)
from repro_torch.serving.server import (compile_for_serving,  # noqa: E402
                                        serve, synthetic_stream)

# Published dense peaks (NVIDIA data sheets): int8 tensor-core op/s and
# device-memory bytes/s, at the card's full power limit.
PEAKS = {"H100 SXM": (1979e12, 3.35e12), "H100 PCIe": (1513e12, 2.0e12),
         "H200": (1979e12, 4.8e12)}

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


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> tuple[str, float, float]:
    key = ("H200" if "H200" in name else
           "H100 PCIe" if "H100" in name and "PCIe" in name else "H100 SXM")
    return (key, *PEAKS[key])


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
    t0 = time.perf_counter()
    _build.load(SOURCE)
    build_s = time.perf_counter() - t0
    env = {"phase": "environment", "device": name, "nvidia_smi": smi_line,
           "peaks_of": card_peaks(name)[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "kernel_build_s": round(build_s, 3)}
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
    _, peak_ops, peak_bytes = card_peaks(env["device"])
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
    gemm_int8.launches = 0
    result = serve("alexnet", frames=SERVE_FRAMES, batch=SERVE_BATCH,
                   output="logits", device="cuda", verbose=False,
                   return_outputs=True)
    torch.cuda.synchronize()
    launches = gemm_int8.launches
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


def main() -> int:
    try:
        env = phase_environment()
        gemm = phase_gemm(env)
        main_path = phase_main_path()
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
               f"launches"}]
    print(env["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
