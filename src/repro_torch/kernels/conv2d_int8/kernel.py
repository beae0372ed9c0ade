"""The Hopper int8 GEMM engine: ``gemm_int8`` with the fused requantize
epilogue, the port of the Pallas kernel
``repro/kernels/conv2d_int8/kernel.py::gemm_int8``.

The kernels are CUDA C++ (``csrc/gemm_int8.cu``), built with ``nvcc`` at
first use and called through ctypes (``kernels/_build.py``). A tensor on
the CPU goes to the plain version, ``ref.gemm_int8_ref``; a CUDA tensor
always launches one kernel, or raises. Which kernel, the *path*, follows
from the shapes and the layout:

* ``"large_n"``: ``wgmma`` s8 fed by TMA, for N > 64 (the convs);
* ``"small_n"``: the same with the operands swapped, for N <= 64 (the fc
  layers at small batches);
* ``"dp4a"``: the first design (``__dp4a`` on the CUDA cores), for what
  TMA cannot take: a base or row stride that is not a multiple of 16
  bytes, a row-major ``w`` (``wgmma`` reads int8 only K-major), K = 0.

The ``wgmma`` paths want ``w`` as a [K, M] view whose stride along K is 1
(a ``.t()`` of K-major [M, K] rows): :func:`k_major_view` makes it, once
per engine at lowering (``core/program.py``). ``gemm_int8.launches`` counts the kernels'
launches and nothing else; ``gemm_int8.launches_by_path`` splits them by
path, and ``gemm_int8.residual_launches`` counts those that added a
residual (a ResNet bottleneck's skip) in their epilogue.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ref import gemm_int8_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm_int8.cu"
PATHS = ("large_n", "small_n", "dp4a")
SMALL_N = 64           # N up to this takes the swapped kernel
BOX_K = 128            # K bytes of one TMA box (one swizzled row)
ALIGN = 16             # TMA: bases and row strides in multiples of 16 bytes
# The wgmma s8 widths (of the multiples of 8 up to 256) the kernels are
# built for: 128-row tiles of each large width, 64-row tiles of the first.
LARGE_WIDTHS = (64, 96, 128)
SMALL_WIDTHS = (16, 32, 64)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a ``wgmma`` launch tiles its output: ``width`` output columns
    (rows of x on ``small_n``, whose tiles are the transposed problem's)
    by 64 x ``warpgroups`` rows a tile, one block a tile, K in stages of
    ``k_boxes`` 128-byte boxes (2 on ``small_n``, 1 on ``large_n``)."""

    path: str
    width: int
    warpgroups: int

    @property
    def k_boxes(self) -> int:
        return 2 if self.path == "small_n" else 1

    def k_iters(self, K: int) -> int:
        return -(-K // (BOX_K * self.k_boxes))

    def tiles(self, N: int, M: int) -> int:
        rows_a, rows_b = (M, N) if self.path == "small_n" else (N, M)
        return -(-rows_a // (64 * self.warpgroups)) * -(-rows_b // self.width)


def plans(N: int) -> list[Plan]:
    """Every tiling the kernels are built for that can take N rows of x."""
    if N <= SMALL_N:
        return [Plan("small_n", w, 1) for w in SMALL_WIDTHS if w >= N]
    return [Plan("large_n", LARGE_WIDTHS[0], 1)] + \
        [Plan("large_n", w, 2) for w in LARGE_WIDTHS]


@functools.lru_cache(maxsize=4096)
def plan_for(N: int, K: int, M: int, sms: int) -> Plan:
    """The tiling the wrapper picks on a card of ``sms`` SMs.

    N <= 64: the narrowest width that holds N. N > 64: 128-row tiles (two
    warpgroups, one block an SM) of the narrowest width that holds M (or
    128 columns) where they fill two thirds of the SMs and K takes more
    than one stage; else the same test on 64-column tiles, which make
    more of them; else 64 x 64 tiles (two blocks an SM). ``chip_smoke.py``
    times every tiling of :func:`plans` at every AlexNet and VGG16
    batch-16 shape beside this choice (its ``gemm_int8_tilings`` lines;
    the table is in ``PERF.md``)."""
    if N <= SMALL_N:
        return plans(N)[0]
    width = next((w for w in LARGE_WIDTHS if w >= M), LARGE_WIDTHS[-1])
    for w in dict.fromkeys((width, LARGE_WIDTHS[0])):
        tall = Plan("large_n", w, 2)
        if 3 * tall.tiles(N, M) >= 2 * sms and tall.k_iters(K) >= 2:
            return tall
    return Plan("large_n", LARGE_WIDTHS[0], 1)


def k_major_view(wq: torch.Tensor) -> torch.Tensor:
    """``wq`` ([R, S, Cg, M] or [F, M]) copied K-major, the ``wgmma``
    paths' layout: a view of wq's shape and values whose stride along R,
    S, Cg (or F) is 1, over an [M, K16] buffer of zeros past K (K16 = K
    rounded up to ``ALIGN`` bytes, the row stride TMA takes). Its strides
    are (S*Cg, Cg, 1, K16) or (1, K16); a group's column slice is again
    such a view."""
    M = wq.shape[-1]
    K = wq.numel() // M if M else 0
    buf = wq.new_zeros((M, -(-K // ALIGN) * ALIGN))
    buf[:, :K] = wq.reshape(K, M).t()
    return buf[:, :K].t().reshape(wq.shape)


@_build.once
def _lib():
    """The library, built and bound once per process, concurrent first
    callers included (a per-launch library lookup touches the filesystem
    and costs more host time than the kernel takes on the card)."""
    lib = _build.load(SOURCE)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gemm_int8_launch.argtypes = [p, ll, p, ll, ll, p, p, p, i, i, i, i,
                                     i, p, ll, p, p]
    lib.gemm_int8_wgmma_launch.argtypes = [p, ll, p, ll, p, p, p, i, i, i,
                                           i, i, i, i, i, i, p, ll, p, p]
    lib.gemm_int8_launch.restype = ctypes.c_int
    lib.gemm_int8_wgmma_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_x(x: torch.Tensor) -> None:
    """x: a 2-D int8 [N, K] with unit stride along K and rows that do not
    overlap (a leading dimension >= K)."""
    if x.dtype != torch.int8 or x.ndim != 2:
        raise ValueError(f"x: expected a 2-D torch.int8 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1 or \
            x.shape[0] > 1 and x.stride(0) < x.shape[1]:
        raise ValueError(f"x: rows must be contiguous (strides {x.stride()} "
                         f"for shape {tuple(x.shape)})")


def _w_k_major(w: torch.Tensor) -> bool:
    """Whether w [K, M] has unit stride along K (True) or along M (False,
    row-major); its columns or rows must not overlap. Raises on a 2-D int8
    tensor with neither."""
    if w.dtype != torch.int8 or w.ndim != 2:
        raise ValueError(f"w: expected a 2-D torch.int8 tensor, got "
                         f"{w.dtype} {tuple(w.shape)}")
    K, M = w.shape
    if (K <= 1 or w.stride(0) == 1) and (M <= 1 or w.stride(1) >= K):
        return True
    if (M <= 1 or w.stride(1) == 1) and (K <= 1 or w.stride(0) >= M):
        return False
    raise ValueError(f"w: needs unit stride along K or along M (strides "
                     f"{w.stride()} for shape {tuple(w.shape)})")


def _check_vec(name: str, t: torch.Tensor, m: int) -> None:
    if t.dtype != torch.int32 or t.shape != (m,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 [{m}] "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def _check_residual(residual: torch.Tensor, n: int, m: int) -> None:
    """residual: an int8 [N, M] with unit stride along M and rows that do
    not overlap (any row stride >= M)."""
    if residual.dtype != torch.int8 or residual.shape != (n, m):
        raise ValueError(f"residual: expected a torch.int8 [{n}, {m}] "
                         f"tensor, got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    if m > 1 and residual.stride(1) != 1 or \
            n > 1 and residual.stride(0) < m:
        raise ValueError(f"residual: rows must be contiguous (strides "
                         f"{residual.stride()} for shape {(n, m)})")


def gemm_int8(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
              bias: torch.Tensor | None = None, *, relu: bool = False,
              emit_int32: bool = False,
              residual: torch.Tensor | None = None,
              res_shift: torch.Tensor | None = None) -> torch.Tensor:
    """int8 GEMM with fused requantize epilogue: [N,K]x[K,M] -> int8 [N,M].

    ``out = clip((relu?)(x @ w + bias) >> shift)`` with per-column (output
    channel) ``shift``/``bias``; negative shifts left-shift. With
    ``emit_int32`` the epilogue stops after bias/ReLU and returns the raw
    int32 accumulators. ``x`` is a view with unit stride along K and any
    leading dimension; ``w`` has unit stride along K (the fast layout) or
    along M; ``shift`` and ``bias`` are contiguous int32 [M]. With an int8
    ``residual`` [N, M] (unit stride along M, any row stride) and its
    contiguous int32 [M] ``res_shift``, the epilogue adds the residual
    aligned onto each column's accumulator format before the ReLU
    (``ref.align_residual``). The ``wgmma`` tiling is :func:`plan_for`'s.
    On CPU tensors the plain version runs.
    """
    _check_x(x)
    k_major = _w_k_major(w)
    N, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    M = w.shape[1]
    _check_vec("shift", shift, M)
    if bias is not None:
        _check_vec("bias", bias, M)
    if (residual is None) != (res_shift is None):
        raise ValueError("residual and res_shift come together")
    if residual is not None:
        _check_residual(residual, N, M)
        _check_vec("res_shift", res_shift, M)
    device = x.device
    devices = {t.device for t in (x, w, shift, bias, residual, res_shift)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    if device.type == "cpu":
        return gemm_int8_ref(x, w, shift, bias, relu=relu,
                             emit_int32=emit_int32, residual=residual,
                             res_shift=res_shift)
    if device.type != "cuda":
        raise ValueError(f"gemm_int8 runs on cuda or cpu, not {device}")
    out = torch.empty((N, M), dtype=torch.int32 if emit_int32 else torch.int8,
                      device=device)
    if N == 0 or M == 0:
        return out
    ldx, ldw = x.stride(0), w.stride(1)
    tma = k_major and K > 0 and x.data_ptr() % ALIGN == 0 \
        and ldx % ALIGN == 0 and w.data_ptr() % ALIGN == 0 \
        and ldw % ALIGN == 0
    stream = torch.cuda.current_stream(device).cuda_stream
    bias_p = None if bias is None else bias.data_ptr()
    res = (None, 0, None) if residual is None else \
        (residual.data_ptr(), residual.stride(0), res_shift.data_ptr())
    if tma:
        plan = plan_for(N, K, M, _sms(device.index or 0))
        err = _lib().gemm_int8_wgmma_launch(
            x.data_ptr(), ldx, w.data_ptr(), ldw, shift.data_ptr(), bias_p,
            out.data_ptr(), N, K, M, int(relu), int(emit_int32),
            int(plan.path == "small_n"), plan.width, plan.warpgroups,
            plan.k_boxes, *res, stream)
        path = plan.path
    else:
        err = _lib().gemm_int8_launch(
            x.data_ptr(), ldx, w.data_ptr(), w.stride(0), w.stride(1),
            shift.data_ptr(), bias_p, out.data_ptr(), N, K, M, int(relu),
            int(emit_int32), *res, stream)
        path = "dp4a"
    if err:
        raise RuntimeError(f"gemm_int8 launch failed: cudaError_t {err} "
                           f"(N={N}, K={K}, M={M}, path {path})")
    _build.count(gemm_int8, path)
    if residual is not None:
        with _build._COUNT_LOCK:
            gemm_int8.residual_launches += 1
    return out


def reset_launches() -> None:
    """Set ``gemm_int8.launches``, every path's count and the residual
    launches to 0."""
    _build.reset_count(gemm_int8, PATHS)
    with _build._COUNT_LOCK:
        gemm_int8.residual_launches = 0


reset_launches()
