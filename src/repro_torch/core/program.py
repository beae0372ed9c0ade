"""Compiled engine programs: one plan drives execution and serving.
PyTorch twin of ``repro/core/program.py``.

The paper's central object is a *balanced plan*: per-layer workloads
(Section 3), the multiplier/buffer allocation that balances them
(Algorithms 1/2), and the fixed-point formats the engines exchange
(Fig. 3(c)). :func:`compile_model` materializes that plan once as an
:class:`EngineProgram`:

1. **allocate** — Algorithms 1 and 2 run once over the model's
   :class:`~repro_torch.core.workload.LayerWorkload` graph.
2. **calibrate** — a float forward over ``calib_batch`` records per-layer
   activation ranges; per-tensor activation exponents and per-output-channel
   weight exponents are frozen, weights are quantized *once* (int8 + a shift
   schedule), and biases are pre-scaled onto each engine's 32-bit
   accumulator format.
3. **lower** — each layer becomes an :class:`EngineStep` whose bias-add,
   ReLU and requantize-to-int8 are fused into the GEMM epilogue
   (``kernels/conv2d_int8``), so activations stay int8 end to end.

Layouts are the reference's at every public function: NHWC activations,
HWIO conv weights, ``[F, M]`` fc weights (fc6's flatten order depends on
NHWC). A plain float conv permutes to NCHW inside itself only.

Differences from the reference, each forced by PyTorch or by the card:

* ``jax.jit`` and buffer donation become plain eager calls; a runner's
  ``cache_size()`` is -1, the reference's own "unknown" value.
* The default MAC route is ``"kernel"`` (the hand-written Hopper
  ``gemm_int8``) when the program lives on a CUDA device, and the
  reference's ``"f32"`` on the CPU. On the card the f32 route is a library
  GEMM, so without this the default serving path would run no kernel of
  the port. Every route computes the same integers; only the default
  differs.
* bits=16 is not ported yet and raises ``NotImplementedError``.
* TF32 is switched off (:func:`exact_float32`) around ``float_forward``,
  where cuDNN's default TF32 could move a calibration amax across a po2
  boundary and change a frozen exponent, and around the f32 route, whose
  exactness proof needs true float32 products.
* The entry points run on the card: ``device=None`` means ``cuda`` and
  raises when there is none. The CPU runs only when asked for.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.allocator import (LayerAlloc, allocate_buffers,
                                        allocate_compute)
from repro_torch.core.workload import CNNModel, ConvLayer
from repro_torch.kernels.conv2d_int8.ops import conv2d_int8, fc_int8
from repro_torch.kernels.conv2d_int8.ref import (conv2d_int8_via,
                                                 matmul_int8_exact,
                                                 requantize_ref)

Params = dict[str, dict[str, Any]]

# ZC706-class board defaults (the paper's Table I setting).
DEFAULT_THETA = 900
DEFAULT_BRAM = 1090
DEFAULT_BW = 4.2e9
DEFAULT_FREQ = 200e6

ROUTES = ("f32", "oracle", "kernel")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no CUDA device and no explicit device it raises; it never
    carries on on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def exact_float32():
    """Run the block with TF32 off for float32 matmuls and cuDNN convs,
    restoring both settings after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _max_pool_nhwc(x: torch.Tensor, kernel: int, stride: int, lo: int,
                   hi: int, fill) -> torch.Tensor:
    """NHWC max pool with asymmetric ``(lo, hi)`` padding of value
    ``fill``, as an elementwise max over the window's strided slices: exact
    on every dtype, int8 included, on every device (``F.max_pool2d`` pads
    only symmetrically)."""
    xp = F.pad(x, (0, 0, lo, hi, lo, hi), value=fill)
    Ho = (xp.shape[1] - kernel) // stride + 1
    Wo = (xp.shape[2] - kernel) // stride + 1
    out = None
    for r in range(kernel):
        for s in range(kernel):
            win = xp[:, r:r + (Ho - 1) * stride + 1:stride,
                     s:s + (Wo - 1) * stride + 1:stride, :]
            out = win if out is None else torch.maximum(out, win)
    return out


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
               pad: tuple[int, int], groups: int) -> torch.Tensor:
    """NHWC x HWIO conv with asymmetric ``(lo, hi)`` padding on both
    spatial dims, through ``F.conv2d`` in the dtype of ``x``."""
    lo, hi = pad
    xn = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Shared float executor (the calibration reference and the fp32 model path)
# ---------------------------------------------------------------------------


@torch.no_grad()
def float_forward(params: Params, model: CNNModel, x: torch.Tensor,
                  record: dict[str, float] | None = None) -> torch.Tensor:
    """Reference float forward over the model graph (NHWC), with TF32 off.
    With ``record`` it doubles as the calibration pass: per-layer output
    amax (post-ReLU for hidden layers — what the next engine actually
    consumes) is stored under the layer name, the network input under
    ``"__input__"``."""
    with exact_float32():
        if record is not None:
            record["__input__"] = float(torch.max(torch.abs(x)))
        hw = x.shape[1]
        last = [l for l in model.layers if l.kind != "pool"][-1]
        for lyr in model.layers:
            out_hw = lyr.out_hw(hw)
            if lyr.kind == "pool":
                lo, hi = lyr.padding(hw)
                x = _max_pool_nhwc(x, lyr.kernel, lyr.stride, lo, hi,
                                   float("-inf"))
            else:
                w, b = params[lyr.name]["w"], params[lyr.name]["b"]
                if lyr.kind == "fc":
                    x = x.reshape(x.shape[0], -1) @ w + b
                else:
                    x = _conv_nhwc(x, w, lyr.stride, lyr.padding(hw),
                                   lyr.groups) + b
                if lyr is not last:
                    x = torch.relu(x)
                if record is not None:
                    record[lyr.name] = float(torch.max(torch.abs(x)))
            hw = out_hw
    return x


# ---------------------------------------------------------------------------
# Lowered steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineStep:
    """One pipeline engine, fully lowered: quantized weights, the frozen
    shift schedule, and the spatial plumbing the kernel needs."""

    name: str
    kind: str                      # "conv" | "fc" | "pool"
    layer: ConvLayer
    pad: tuple[int, int]           # (lo, hi), both spatial dims
    # compute-step payload (None for pool):
    wq: torch.Tensor | None = None         # int8 quantized weights
    bias_q: torch.Tensor | None = None     # int32 bias on the acc format
    shift: torch.Tensor | None = None      # int32 [M]: e_out - (e_in+e_w)
    e_in: int = 0                          # input activation exponent
    e_w: np.ndarray | None = None          # int [M] weight exponents
    e_out: int = 0                         # output activation exponent
    relu: bool = False
    requantize: bool = True        # False on the last engine (emit acc32)


@dataclasses.dataclass
class EngineProgram:
    """The compiled plan. ``allocs`` is the single source of truth for
    cycles (throughput model / Table I); ``steps`` is the executable
    lowering of the same layers, with its tensors on ``device``."""

    model: CNNModel
    bits: int
    theta_total: int
    allocs: list[LayerAlloc]
    steps: list[EngineStep] | None = None
    e_input: int = 0
    freq_hz: float = DEFAULT_FREQ
    device: torch.device = torch.device("cpu")

    # -- analytics ----------------------------------------------------------

    def frame_cycles(self) -> float:
        from repro_torch.core import throughput as T
        return T.frame_cycles(self.allocs)

    def fps(self) -> float:
        from repro_torch.core import throughput as T
        return T.pipeline_fps(self.allocs, freq_hz=self.freq_hz)

    # -- execution ----------------------------------------------------------

    def out_scale(self) -> np.ndarray:
        """Per-channel float32 po2 scale of the final engine's int32
        accumulators (logits = acc * out_scale, exactly)."""
        last = [s for s in self.steps if s.kind != "pool"][-1]
        return np.exp2(np.asarray(last.e_in + last.e_w, np.float32))

    def _require_steps(self) -> None:
        if self.steps is None:
            raise ValueError(
                "plan-only program (compiled without params) cannot run")

    @torch.no_grad()
    def run(self, x, *, use_kernel: bool = False) -> torch.Tensor:
        """Fixed-point forward, eagerly step by step. ``x`` is float NHWC
        (numpy or tensor); returns float logits on the program's device
        (the final engine's 32-bit accumulators on their exact po2 scale).
        ``use_kernel`` runs the MACs through ``gemm_int8``, else through
        the integer oracle. This is the per-sample reference path; for
        throughput use :meth:`compile_runner`."""
        self._require_steps()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        xq = quant.quantize_to_exponent(x, self.e_input, self.bits)
        for step in self.steps:
            if step.kind == "pool":
                xq = _pool_int(xq, step)
            elif use_kernel:
                xq = _step_kernel(xq, step)
            else:
                xq = _step_oracle(xq, step)
        scale = torch.as_tensor(self.out_scale(), device=self.device)
        return xq.to(torch.float32) \
            * scale.reshape((1,) * (xq.ndim - 1) + (-1,))

    def _resolve_route(self, route: str | None) -> str:
        """The MAC route a runner uses: ``"kernel"`` by default on a CUDA
        device (the hand-written kernel), ``"f32"`` elsewhere, as in the
        reference. All routes compute the same integers."""
        if route is None:
            route = "kernel" if self.device.type == "cuda" else "f32"
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}")
        return route

    def compile_runner(self, *, route: str | None = None) -> "CompiledRunner":
        """The whole step chain over a batch of already-quantized frames as
        one :class:`CompiledRunner`.

        ``route`` selects the MAC lowering (every route computes the exact
        same integers — pinned by ``tests/test_torch_program.py`` on the
        CPU and by ``chip_smoke.py`` on the card):

        * ``"kernel"`` (default on CUDA) — the Hopper ``gemm_int8`` kernel
          through ``conv2d_int8`` / ``fc_int8``; its plain version on CPU.
        * ``"f32"`` (default on CPU) — int8 im2col and float32 GEMMs over
          K-chunks of at most 1024 products, each partial sum an integer
          <= 2^24, so float32 is exact (:func:`_step_exact_f32`).
        * ``"oracle"`` — exact integer accumulators from a float64 conv /
          GEMM (:func:`_step_oracle`).
        """
        self._require_steps()
        return self.compile_stage_runner(0, len(self.steps), route=route)

    def compile_stage_runner(self, start: int, stop: int, *,
                             route: str | None = None) -> "CompiledRunner":
        """The contiguous step range ``[start, stop)`` as one runner — one
        *stage* of the layer-wise pipeline. Activations cross stage
        boundaries as the same int8 tensors the full chain passes between
        steps, so chained stage runners reproduce :meth:`compile_runner`
        bit-exactly. ``compile_runner`` is the case ``[0, len(steps))``."""
        self._require_steps()
        if not (0 <= start < stop <= len(self.steps)):
            raise ValueError(
                f"stage range [{start}, {stop}) outside the "
                f"{len(self.steps)}-step chain")
        steps = tuple(self.steps[start:stop])
        route = self._resolve_route(route)
        step_fn = {"kernel": _step_kernel, "f32": _step_exact_f32,
                   "oracle": _step_oracle}[route]

        @torch.no_grad()
        def chain(xq: torch.Tensor) -> torch.Tensor:
            for step in steps:
                xq = _pool_int(xq, step) if step.kind == "pool" \
                    else step_fn(xq, step)
            return xq

        return CompiledRunner(program=self, route=route, fn=chain,
                              start=start, stop=stop)


@dataclasses.dataclass
class CompiledRunner:
    """One eager device program for a contiguous step range of the engine
    chain — the whole chain for :meth:`EngineProgram.compile_runner`
    (``start == 0``, ``stop == len(steps)``), or one pipeline stage.

    ``fn`` maps an int8 activation batch ``[B, H, W, C]`` on the program's
    device to the range's output — raw final accumulators when the range
    includes the last engine, int8 activations otherwise. Host-side
    quantize-in and argmax/dequant-out live here so the executor can
    overlap them with device compute; they exist only at the matching end
    of the chain (first / last stage).
    """

    program: EngineProgram
    route: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    start: int = 0
    stop: int = -1          # -1 == len(program.steps) (whole chain)

    def __post_init__(self):
        if self.stop < 0:
            self.stop = len(self.program.steps)

    @property
    def is_first(self) -> bool:
        return self.start == 0

    @property
    def is_last(self) -> bool:
        return self.stop == len(self.program.steps)

    def quantize(self, x: np.ndarray) -> np.ndarray:
        """Host-side quantize onto the program's frozen input format
        (numpy twin of ``quant.quantize_to_exponent`` — bit-identical).
        Only the first stage consumes float frames."""
        if not self.is_first:
            raise ValueError(
                f"stage [{self.start}, {self.stop}) does not start the "
                f"chain; it consumes the previous stage's quantized "
                f"activations, not float frames")
        return quant.quantize_to_exponent_np(
            x, self.program.e_input, self.program.bits)

    def __call__(self, xq) -> torch.Tensor:
        """Launch one quantized batch (numpy, or a tensor already on the
        program's device) on the current stream; returns the output tensor
        without waiting for the device."""
        return self.fn(torch.as_tensor(xq, device=self.program.device))

    def dequantize(self, acc) -> np.ndarray:
        """Raw final accumulators -> float32 logits on their exact po2
        scale (host side). Only the last stage emits accumulators."""
        if not self.is_last:
            raise ValueError(
                f"stage [{self.start}, {self.stop}) does not end the "
                f"chain; it emits quantized activations, not final "
                f"accumulators")
        if isinstance(acc, torch.Tensor):
            acc = acc.cpu().numpy()
        acc = np.asarray(acc)
        scale = self.program.out_scale()
        return acc.astype(np.float32) * scale.reshape(
            (1,) * (acc.ndim - 1) + (-1,))

    def logits(self, x) -> np.ndarray:
        """Blocking convenience: float frames -> float logits. Bit-identical
        to ``program.run`` on the same route's arithmetic."""
        return self.dequantize(self(self.quantize(np.asarray(x))))

    def classify(self, x) -> np.ndarray:
        """Blocking convenience: float frames -> int class ids."""
        out = self.logits(x)
        return np.argmax(out.reshape(out.shape[0], -1), axis=-1)

    def cache_size(self) -> int:
        """Compiled executables behind ``fn``: -1 ("unknown"), since the
        port runs eagerly and compiles nothing per batch shape."""
        return -1


# ---------------------------------------------------------------------------
# Step executors
# ---------------------------------------------------------------------------


def _pool_int(xq: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """Max pool directly on the integer activations — max is monotone in
    the po2 format, so this is exact and the exponent passes through. The
    padding is ``(lo, hi)``, filled with the dtype's minimum."""
    lyr = step.layer
    lo, hi = step.pad
    fill = float("-inf") if xq.is_floating_point() \
        else torch.iinfo(xq.dtype).min
    return _max_pool_nhwc(xq, lyr.kernel, lyr.stride, lo, hi, fill)


def _step_kernel(xq: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """The kernel route: ``gemm_int8`` with the fused epilogue."""
    lyr = step.layer
    emit = not step.requantize
    if step.kind == "fc":
        return fc_int8(xq.reshape(xq.shape[0], -1), step.wq, step.shift,
                       step.bias_q, relu=step.relu, emit_int32=emit)
    return conv2d_int8(xq, step.wq, step.shift, step.bias_q,
                       stride=lyr.stride, padding=(step.pad, step.pad),
                       groups=lyr.groups, relu=step.relu, emit_int32=emit)


def _step_oracle(xq: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """The integer oracle with the identical fused epilogue. Its MACs are
    a float64 ``F.conv2d`` / matmul, independent of im2col and of the
    kernel: every partial sum is an integer far below 2^53, and the
    rounding before the int32 cast absorbs the last-bit error of a
    transform-based conv algorithm (it stays many orders below 0.5)."""
    lyr = step.layer
    if step.kind == "fc":
        acc = matmul_int8_exact(xq.reshape(xq.shape[0], -1), step.wq)
    else:
        acc = _conv_nhwc(xq.to(torch.float64), step.wq.to(torch.float64),
                         lyr.stride, step.pad, lyr.groups)
        acc = torch.round(acc).to(torch.int32)
    return _epilogue_int32(acc, step)


# Max MAC terms per float32 partial sum on the exact-f32 route: every
# int8*int8 product has |p| <= 2^14, and float32 represents all integers
# up to 2^24 exactly, so chains of <= 2^24 / 2^14 = 1024 products (in any
# order the GEMM picks) stay bit-exact.
_F32_CHUNK_MACS = 1024


def _matmul_exact_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 ``[N, K] @ [K, M]`` -> int32 through float32 GEMMs over K-chunks
    of at most ``_F32_CHUNK_MACS``, summed in int32."""
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int32,
                      device=x.device)
    with exact_float32():
        for k0 in range(0, x.shape[1], _F32_CHUNK_MACS):
            k1 = k0 + _F32_CHUNK_MACS
            acc += torch.matmul(xf[:, k0:k1], wf[k0:k1]).to(torch.int32)
    return acc


def _step_exact_f32(xq: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """int8 conv/fc via *exact* float32 arithmetic, with the identical
    fused epilogue. The conv lowers through the shared int8 im2col and
    float32 GEMMs, not ``F.conv2d``: cuDNN's FFT and Winograd algorithms
    are not chains of MACs, so the 2^24 argument would not hold for them.
    Chunking the flat im2col depth bounds every chunk at 1024 products
    whatever the kernel size, so no conv is refused here."""
    lyr = step.layer
    if step.kind == "fc":
        acc = _matmul_exact_f32(xq.reshape(xq.shape[0], -1), step.wq)
    else:
        acc = conv2d_int8_via(
            lambda patches, w2d, shift, bias, relu: _matmul_exact_f32(
                patches, w2d),
            xq, step.wq, step.shift, None, stride=lyr.stride,
            padding=(step.pad, step.pad), groups=lyr.groups)
    return _epilogue_int32(acc, step)


def _epilogue_int32(acc: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """The shared fused output stage on exact int32 accumulators."""
    if step.requantize:
        flat = requantize_ref(acc.reshape(-1, acc.shape[-1]), step.shift,
                              step.bias_q, step.relu)
        return flat.reshape(acc.shape)
    acc = acc + step.bias_q.reshape((1,) * (acc.ndim - 1) + (-1,))
    if step.relu:
        acc = torch.clamp(acc, min=0)
    return acc


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def compile_model(model: CNNModel, params: Params | None = None, *,
                  theta: int = DEFAULT_THETA, bits: int = 8,
                  calib_batch=None,
                  bram_total: int | None = DEFAULT_BRAM,
                  bandwidth_bytes: float = DEFAULT_BW,
                  freq_hz: float = DEFAULT_FREQ,
                  bram_weights: bool = False,
                  objective: str = "optimal",
                  device=None) -> EngineProgram:
    """Workload -> allocation -> execution, compiled once.

    Without ``params`` this produces a *plan-only* program (Algorithms 1/2
    only). With ``params`` (``{layer: {"w", "b"}}`` float tensors, see
    ``models.cnn``) and a ``calib_batch`` for activation ranges the program
    is fully lowered and runnable on ``device`` (default ``cuda``; raises
    without one). ``bram_total=None`` skips Algorithm 2.
    ``bram_weights=True`` makes Algorithm 2 charge weight buffers against
    the BRAM budget (plan-only analytics, never the arithmetic).
    """
    device = resolve_device(device)
    if bits != 8:
        raise NotImplementedError(
            "the port runs bits=8 only so far; bits=16 (48-bit DSP "
            "accumulation model) is still to port")
    workloads = model.layer_workloads(weight_bits=bits)
    allocs = allocate_compute(workloads, theta, objective=objective)
    if bram_total is not None:
        allocate_buffers(allocs, bram_total=bram_total,
                         bandwidth_bytes=bandwidth_bytes, freq_hz=freq_hz,
                         act_bytes=bits // 8, weights=bram_weights)
    prog = EngineProgram(model=model, bits=bits, theta_total=theta,
                         allocs=allocs, freq_hz=freq_hz, device=device)
    if params is None:
        return prog

    if calib_batch is None:
        raise ValueError("compiling an executable program needs a "
                         "calib_batch to freeze activation formats")
    params = {name: {k: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
                     for k, v in p.items()}
              for name, p in params.items()}
    calib = torch.as_tensor(calib_batch, dtype=torch.float32, device=device)
    amax: dict[str, float] = {}
    float_forward(params, model, calib, record=amax)
    prog.e_input = quant.po2_exponent(amax["__input__"], bits)
    prog.steps = _lower(model, params, amax, prog.e_input, bits)
    return prog


@torch.no_grad()
def _lower(model: CNNModel, params: Params, amax: dict[str, float],
           e_input: int, bits: int) -> list[EngineStep]:
    """Freeze every engine's formats and quantize its weights once.

    The weight scale ``2^-e_w`` is an exact power of two here. The
    reference computes it with ``jnp.exp2``, which XLA lowers to
    ``exp(ln2 * x)`` in float32 and which is exact only for |x| <= 12; the
    two agree wherever every ``|e_w| <= 12``, as on AlexNet
    (``tests/test_torch_program.py`` pins its lowering)."""
    steps: list[EngineStep] = []
    compute = [l for l in model.layers if l.kind != "pool"]
    last = compute[-1]
    hw = model.input_hw
    e_act = e_input
    for lyr in model.layers:
        pad = lyr.padding(hw)
        if lyr.kind == "pool":
            steps.append(EngineStep(name=lyr.name, kind="pool", layer=lyr,
                                    pad=pad))
            hw = lyr.out_hw(hw)
            continue
        w = params[lyr.name]["w"]
        b = params[lyr.name]["b"]
        e_w = quant.po2_scale(w, axis=-1, bits=bits).cpu().numpy().astype(
            np.int64)
        is_last = lyr is last
        e_out = quant.po2_exponent(amax[lyr.name], bits)
        # Floor each channel's weight format so (a) its bias fits the
        # int32 accumulator and (b) the output shift stays within the
        # 31-bit shifter. Without this, a channel with numerically-dead
        # weights but a significant bias would get an absurdly fine
        # accumulator scale, saturating bias_q and silently dropping the
        # bias; flooring e_w instead rounds the dead weights to zero and
        # keeps the bias exactly representable.
        b_np = b.cpu().numpy().astype(np.float64)
        nz = np.abs(b_np) > 0
        b_mag = np.full(b_np.shape, -(10 ** 9), np.int64)
        b_mag[nz] = np.ceil(np.log2(np.abs(b_np[nz])))
        e_w = np.maximum(e_w, np.maximum(b_mag - 30, e_out - 31) - e_act)
        # Quantize weights once onto the (possibly floored) formats, with
        # the reference's float32 multiply.
        qmax = 2 ** (bits - 1) - 1
        scale = torch.as_tensor(np.exp2(-e_w.astype(np.float32)),
                                device=w.device).reshape(
            (1,) * (w.ndim - 1) + (-1,))
        wq = torch.clamp(torch.round(w * scale), -qmax - 1, qmax).to(
            torch.int8)
        # Bias pre-scaled onto this engine's 32-bit accumulator format
        # (value = q * 2^(e_in + e_w[m])).
        acc_e = e_act + e_w
        bias_q = np.clip(np.round(b_np / np.exp2(acc_e)),
                         np.iinfo(np.int32).min, np.iinfo(np.int32).max
                         ).astype(np.int32)
        shift = np.clip(e_out - acc_e, -31, 31).astype(np.int32)
        steps.append(EngineStep(
            name=lyr.name, kind=lyr.kind, layer=lyr, pad=pad,
            wq=wq.contiguous(),
            bias_q=torch.as_tensor(bias_q, device=w.device),
            shift=torch.as_tensor(shift, device=w.device), e_in=e_act,
            e_w=e_w, e_out=e_out, relu=not is_last,
            requantize=not is_last))
        e_act = e_out
        hw = lyr.out_hw(hw)
    return steps
