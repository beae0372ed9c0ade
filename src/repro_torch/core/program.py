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
   (``kernels/conv2d_int8``), so activations stay int8 end to end. In a
   residual graph (ResNet-50 v1.5) a step may read an earlier step's
   output, and a bottleneck's last conv adds its skip in the same
   epilogue (the rule is :func:`_lower`'s). A ReLU6 engine (MobileNetV2)
   clips its int8 output at 6 on its frozen format, and a depthwise conv
   runs on its own kernel, ``dwconv_int8``.

Layouts are the reference's at every public function: NHWC activations,
HWIO conv weights, ``[F, M]`` fc weights (fc6's flatten order depends on
NHWC). A plain float conv permutes to NCHW inside itself only.

Differences from the reference, each forced by PyTorch or by the card:

* ``jax.jit`` and buffer donation become eager calls, and on the card's
  kernel route one CUDA graph a runner: the second batch of a shape is
  captured, every later one replays it (:class:`CompiledRunner`). A runner
  that has captured nothing reports ``cache_size()`` -1, the reference's
  own "unknown" value.
* The default MAC route is ``"kernel"`` (the hand-written Hopper
  ``gemm_int8``) when the program lives on a CUDA device, and the
  reference's ``"f32"`` on the CPU. On the card the f32 route is a library
  GEMM, so without this the default serving path would run no kernel of
  the port. Every route computes the same integers; only the default
  differs.
* Each engine keeps a second, K-major copy of its int8 weights
  (``EngineStep.wk``, made once at lowering): ``wgmma`` reads int8
  operands only K-major, and the kernel route hands the GEMM a view of
  it. The reference layout (``wq``) serves the other routes, and the
  depthwise kernel, which reads it along the channels.
* bits=16 runs the exact integer oracle: int16 weights and activations,
  int64 accumulators from a float64 GEMM over the int16 im2col patches
  (exact, :func:`_step_oracle16`), a floor shift in int64 and a clip to
  int16; the last engine emits int64. The reference models the DSP48's
  48-bit accumulation in float32 instead, which rounds the largest
  accumulators and, through its float32 ``exp2`` shift, moves a hidden
  activation by one LSB on up to a few tenths of a percent of its
  elements. As in the reference, bits=16 has no kernel route and no f32
  route; its default route is ``"oracle"`` on every device.
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
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant, spans
from repro_torch.core.quant import ref_exp2
from repro_torch.core.allocator import (LayerAlloc, allocate_buffers,
                                        allocate_compute)
from repro_torch.core.workload import CNNModel, ConvLayer
from repro_torch.kernels.conv2d_int8.kernel import (QMAX, add_launches,
                                                    k_major_view,
                                                    launch_counts)
from repro_torch.kernels.conv2d_int8.ops import conv2d_int8, fc_int8
from repro_torch.kernels.conv2d_int8.ref import (bias_relu_ref,
                                                 conv2d_int8_via,
                                                 matmul_int8_exact,
                                                 requantize_ref)
from repro_torch.kernels.dwconv_int8.kernel import depthwise_acc
from repro_torch.kernels.quantize_in.kernel import quantize_in_int8

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


def same_device(a, b) -> bool:
    """Whether two devices are one: ``cuda`` and ``cuda:<current>`` are."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    if a.index is not None and b.index is not None:
        return False
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


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


def _last_reads(reads, start: int = 0,
                stop: int | None = None) -> dict[int, int]:
    """For each output (-1: the frames) that the layers or steps ``[start,
    stop)`` of a graph read, the index of the last of them that reads it.
    ``reads`` holds what each one reads (:meth:`CNNModel.reads`,
    :func:`_step_reads`)."""
    last: dict[int, int] = {}
    for i in range(start, len(reads) if stop is None else stop):
        for j in reads[i]:
            last[j] = i
    return last


def folded_weights(model: CNNModel, params: Params, i: int) -> torch.Tensor:
    """The float weights layer ``i`` is run and quantized with: its own,
    divided by the map's area where it reads a global average pool (the
    pool emits the sum; a po2 format cannot hold 1/49)."""
    w = params[model.layers[i].name]["w"]
    src = model.sources()[i]
    if src >= 0 and model.layers[src].kind == "gap":
        hw = model.in_sizes()[src]
        w = w / float(hw * hw)
    return w


@torch.no_grad()
def float_forward(params: Params, model: CNNModel, x: torch.Tensor,
                  record: dict[str, float] | None = None) -> torch.Tensor:
    """Reference float forward over the model graph (NHWC), with TF32 off.
    With ``record`` it doubles as the calibration pass: per-layer output
    amax (post-ReLU where the layer has ReLU — what the next engine
    actually consumes; after ReLU6's hold at 6 where it has that; a
    block's last conv after its skip add and ReLU, a projection before the
    add) is stored under the layer name, the
    network input under ``"__input__"``. The global average pool emits the
    sum over the map (its amax is the sum's), and the fc after it runs on
    :func:`folded_weights`."""
    with exact_float32():
        if record is not None:
            record["__input__"] = float(torch.max(torch.abs(x)))
        last = [l for l in model.layers if l.computes][-1]
        reads = model.reads()
        last_read = _last_reads(reads)
        outs = {-1: x}
        for i, (lyr, (src, *skip), hw) in enumerate(zip(
                model.layers, reads, model.in_sizes())):
            x = outs[src]
            if lyr.kind == "pool":
                lo, hi = lyr.padding(hw)
                x = _max_pool_nhwc(x, lyr.kernel, lyr.stride, lo, hi,
                                   float("-inf"))
            elif lyr.kind == "gap":
                x = x.sum(dim=(1, 2), keepdim=True)
            else:
                w, b = folded_weights(model, params, i), params[lyr.name]["b"]
                if lyr.kind == "fc":
                    x = x.reshape(x.shape[0], -1) @ w + b
                else:
                    x = _conv_nhwc(x, w, lyr.stride, lyr.padding(hw),
                                   lyr.groups) + b
                if skip:
                    x = x + outs[skip[0]]
                if lyr.relu if lyr.relu is not None else lyr is not last:
                    x = torch.relu(x)
                if lyr.relu6:
                    x = torch.clamp(x, max=6.0)
            if record is not None and lyr.kind != "pool":
                record[lyr.name] = float(torch.max(torch.abs(x)))
            outs[i] = x
            for j in reads[i]:
                if last_read[j] == i:
                    outs.pop(j, None)
    return x


# ---------------------------------------------------------------------------
# Lowered steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineStep:
    """One pipeline engine, fully lowered: quantized weights, the frozen
    shift schedule, and the spatial plumbing the kernel needs."""

    name: str
    kind: str                      # "conv" | "fc" | "pool" | "gap"
    layer: ConvLayer
    pad: tuple[int, int]           # (lo, hi), both spatial dims
    # compute-step payload (None for pool):
    wq: torch.Tensor | None = None         # int8/int16 quantized weights
    # The same int8 weights K-major, for the kernel route: a view of wq's
    # shape over [M, K16] rows (K16 = K rounded up to 16 bytes) that hold
    # each output channel's K = R*S*Cg (or F) weights
    # (:func:`k_major_view`); None at bits=16, which has no kernel route.
    wk: torch.Tensor | None = None
    bias_q: torch.Tensor | None = None     # int32 bias on the acc format
    shift: torch.Tensor | None = None      # int32 [M]: e_out - (e_in+e_w)
    e_in: int = 0                          # input activation exponent
    e_w: np.ndarray | None = None          # int [M] weight exponents
    e_out: int = 0                         # output activation exponent
    relu: bool = False
    requantize: bool = True        # False on the last engine (emit acc32)
    # The int8 clip's upper bound where it is not the format's: a ReLU6
    # engine's ceiling, 6 on its output format (:func:`relu6_ceiling`).
    qmax: int | None = None
    # The graph, where it is not a chain: the index of the step whose
    # output this one reads (None: the previous step's), the index of the
    # step whose int8 output is added to the accumulators before ReLU
    # (the skip), and that skip's int32 [M] alignment shift onto each
    # channel's accumulator format (right shift >= 0, left shift < 0).
    src: int | None = None
    skip: int | None = None
    skip_shift: torch.Tensor | None = None


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
    # The steps with their tensors on another device, made once per device
    # a stage is placed on (:meth:`compile_stage_runner`).
    _placed: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    # -- analytics ----------------------------------------------------------

    @property
    def gop(self) -> float:
        return self.model.gop

    def frame_cycles(self) -> float:
        from repro_torch.core import throughput as T
        return T.frame_cycles(self.allocs)

    def fps(self) -> float:
        from repro_torch.core import throughput as T
        return T.pipeline_fps(self.allocs, freq_hz=self.freq_hz)

    # -- execution ----------------------------------------------------------

    def out_scale(self) -> np.ndarray:
        """Per-channel float32 po2 scale of the final engine's int32
        (int64 at bits=16) accumulators (logits = acc * out_scale)."""
        last = [s for s in self.steps if s.kind in ("conv", "fc")][-1]
        return np.exp2(np.asarray(last.e_in + last.e_w, np.float32))

    def _require_steps(self) -> None:
        if self.steps is None:
            raise ValueError(
                "plan-only program (compiled without params) cannot run")

    @torch.no_grad()
    def run(self, x, *, use_kernel: bool = False) -> torch.Tensor:
        """Fixed-point forward, eagerly step by step. ``x`` is float NHWC
        (numpy or tensor); returns float logits on the program's device
        (the final engine's accumulators on their exact po2 scale).
        ``use_kernel`` runs the MACs through ``gemm_int8`` (refused up
        front at bits=16), else through the integer oracle. This is the
        per-sample reference path; for throughput use
        :meth:`compile_runner`."""
        self._require_steps()
        if use_kernel:
            require_kernel(self.bits)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        xq = quant.quantize_to_exponent(x, self.e_input, self.bits)
        xq = _chain(self.steps, 0, len(self.steps),
                    _step_kernel if use_kernel else _step_oracle)(xq)
        scale = torch.as_tensor(self.out_scale(), device=self.device)
        return xq.to(torch.float32) \
            * scale.reshape((1,) * (xq.ndim - 1) + (-1,))

    def _resolve_route(self, route: str | None) -> str:
        """The MAC route a runner uses: at bits=8 ``"kernel"`` by default on
        a CUDA device (the hand-written kernel), ``"f32"`` elsewhere, as in
        the reference; at bits=16 ``"oracle"``, the only route it has (the
        kernel is int8, and the f32 route's exactness proof holds only for
        int8 products). All routes compute the same integers."""
        if route is None:
            if self.bits > 8:
                route = "oracle"
            else:
                route = "kernel" if self.device.type == "cuda" else "f32"
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}")
        if route == "kernel":
            require_kernel(self.bits)
        if route == "f32" and self.bits > 8:
            raise NotImplementedError(
                "the exact-f32 route holds only for int8 products "
                "(<= 2^14 per MAC); bits=16 uses route='oracle'")
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
          GEMM (:func:`_step_oracle`); the only route at bits=16
          (:func:`_step_oracle16`), and its default there.
        """
        self._require_steps()
        return self.compile_stage_runner(0, len(self.steps), route=route)

    def compile_stage_runner(self, start: int, stop: int, *,
                             route: str | None = None,
                             device=None) -> "CompiledRunner":
        """The contiguous step range ``[start, stop)`` as one runner — one
        *stage* of the layer-wise pipeline. Activations cross stage
        boundaries as the same int8 (int16 at bits=16) tensors the full
        chain passes between steps, so chained stage runners reproduce
        :meth:`compile_runner` bit-exactly. ``compile_runner`` is the case
        ``[0, len(steps))``. Where a residual graph has more than one
        tensor live at a cut (a cut inside a bottleneck: the block's input,
        which its last conv adds, beside the activation), the stage takes
        and hands on the tuple of them, in the order of :meth:`live_at`;
        a single live tensor crosses alone, as in a chain.

        ``device`` pins the stage to one ``torch.device`` (the counterpart
        of the reference's ``jax.Device`` pin): its input is moved there
        and its steps run on copies of their tensors made there once and
        cached per device. A device that is the program's own (every stage
        on one card) copies nothing. Placement never changes the
        integers."""
        self._require_steps()
        if not (0 <= start < stop <= len(self.steps)):
            raise ValueError(
                f"stage range [{start}, {stop}) outside the "
                f"{len(self.steps)}-step chain")
        device = self.device if device is None else torch.device(device)
        route = self._resolve_route(route)
        step_fn = {"kernel": _step_kernel, "f32": _step_exact_f32,
                   "oracle": _step_oracle}[route]
        chain = _chain(self.steps_on(device), start, stop, step_fn)
        card = start == 0 and rounds_on_card(device, route, self.bits)
        if card:
            chain = _rounding_first(chain, self.e_input)
        return CompiledRunner(program=self, route=route, fn=chain,
                              start=start, stop=stop, device=device,
                              card_intake=card)

    def live_at(self, cut: int) -> list[int]:
        """The step outputs live at the cut before step ``cut`` (-1: the
        quantized frames), in index order: those a step at or after the
        cut reads; the last step's output at the end of the chain."""
        self._require_steps()
        return _live_at(_step_reads(self.steps), cut)

    def steps_on(self, device) -> list[EngineStep]:
        """The lowered steps with their tensors on ``device``: the
        program's own on its device, else copies made at the first call
        for that device. The K-major ``wk`` is remade from the copied
        ``wq`` (a plain copy of the strided view would not be K-major)."""
        self._require_steps()
        device = torch.device(device)
        if same_device(device, self.device):
            return self.steps
        key = str(device)
        if key not in self._placed:
            placed = []
            for s in self.steps:
                if s.kind in ("conv", "fc"):
                    wq = s.wq.to(device)
                    s = dataclasses.replace(
                        s, wq=wq,
                        wk=None if s.wk is None else k_major_view(wq),
                        bias_q=s.bias_q.to(device), shift=s.shift.to(device),
                        skip_shift=None if s.skip_shift is None
                        else s.skip_shift.to(device))
                elif s.kind == "gap":
                    s = dataclasses.replace(s, shift=s.shift.to(device))
                placed.append(s)
            self._placed[key] = placed
        return self._placed[key]


def rounds_on_card(device, route: str, bits: int) -> bool:
    """Whether quantize-in rounds the frames on the card: where a runner
    replays its range as a CUDA graph (a CUDA device, the kernel route), at
    bits 8. There the serve loops' staging slots hold float32 frames, the
    host only copies them in (:meth:`CompiledRunner.quantize`), and the
    first runner's ``fn`` starts with ``quantize_in_int8``, so the rounding
    is the first node of stage 0's graph. Everywhere else (the CPU, the
    f32 and oracle routes, bits=16) the host rounds them into an int8
    (int16) slot. :meth:`EngineProgram.compile_stage_runner` asks it once
    and records the answer as the runner's ``card_intake``, which
    ``staging_slot`` and :meth:`CompiledRunner.quantize` read."""
    return torch.device(device).type == "cuda" and route == "kernel" \
        and bits == 8


def _rounding_first(chain: Callable, e_input: int) -> Callable:
    """The first runner's ``fn`` on the card path: a float32 batch is
    rounded onto the input format by ``quantize_in_int8`` in the same call
    (inside the graph a capture records), then runs the chain; an int8
    batch, quantized already, runs the chain as it is."""
    def fn(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            x = quantize_in_int8(x, e_input)
        return chain(x)
    return fn


class _LaunchGate:
    """Launches on the card share it; a CUDA graph capture holds it alone.
    Stage workers launch from several threads at once, and a capture has
    to see none of them launching (:meth:`CompiledRunner.__call__`). A
    capture waiting for the gate stops new launches from entering."""

    def __init__(self):
        self._cond = threading.Condition()
        self._launching = 0
        self._capturing = False

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._capturing:
                self._cond.wait()
            self._launching += 1
        try:
            yield
        finally:
            with self._cond:
                self._launching -= 1
                if not self._launching:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def alone(self):
        with self._cond:
            while self._capturing:
                self._cond.wait()
            self._capturing = True
            while self._launching:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._capturing = False
                self._cond.notify_all()


# One gate for the process: a capture must exclude every thread's launches.
_GATE = _LaunchGate()


def _shape_key(xs: tuple[torch.Tensor, ...]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in xs)


@dataclasses.dataclass
class _Graph:
    """A runner's step range captured once for one input shape: the graph,
    its static inputs and outputs, and the ``gemm_int8`` counts its
    capture recorded (:func:`launch_counts` keys)."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple[torch.Tensor, ...]
    outputs: torch.Tensor | tuple[torch.Tensor, ...]
    launches: dict[str, int]


@dataclasses.dataclass
class CompiledRunner:
    """One device program for a contiguous step range of the engine
    chain — the whole chain for :meth:`EngineProgram.compile_runner`
    (``start == 0``, ``stop == len(steps)``), or one pipeline stage.

    ``fn`` maps an int8 (int16 at bits=16) activation batch ``[B, H, W,
    C]`` on the program's device to the range's output — raw final
    accumulators (int32; int64 at bits=16) when the range includes the
    last engine, int8/int16 activations otherwise — launch by launch. On
    the card path (:func:`rounds_on_card`) the first runner's ``fn`` also
    takes the float32 frames, and rounds them on the card first.
    The runner owns a batch's trip to the card and back for both serve
    loops: quantize-in (first stage; :attr:`card_intake`), the copy in,
    the launches, the copy out and its event (:meth:`launch`), and
    dequantize and argmax (:meth:`decode`, last stage); the executors only
    order and collect.

    On a CUDA device on the kernel route a call replays ``fn`` as one CUDA
    graph: the second call with an input of one shape and dtype captures
    it, and every later call of that shape replays it (``replays``
    counts those, ``eager_calls`` every call that ran ``fn``). The same
    kernels run in the same order on the same integers. Every other
    device, route and shape runs ``fn`` eagerly.
    """

    program: EngineProgram
    route: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    start: int = 0
    stop: int = -1          # -1 == len(program.steps) (whole chain)
    device: torch.device | None = None     # None == program.device
    # The first stage on the card path (:func:`rounds_on_card`): ``fn``
    # rounds float32 frames on the card, and the staging slots hold them.
    card_intake: bool = False
    replays: int = dataclasses.field(default=0, init=False, compare=False)
    eager_calls: int = dataclasses.field(default=0, init=False,
                                         compare=False)
    _graph: _Graph | None = dataclasses.field(default=None, init=False,
                                              repr=False, compare=False)
    _seen: set = dataclasses.field(default_factory=set, init=False,
                                   repr=False, compare=False)
    _lock: Any = dataclasses.field(default_factory=threading.Lock,
                                   init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.stop < 0:
            self.stop = len(self.program.steps)
        if self.device is None:
            self.device = self.program.device

    @property
    def is_first(self) -> bool:
        return self.start == 0

    @property
    def is_last(self) -> bool:
        return self.stop == len(self.program.steps)

    def quantize(self, x, out: np.ndarray | None = None,
                 scratch: np.ndarray | None = None) -> np.ndarray:
        """Quantize-in, as the serve loops call it. Without ``out``: the
        host rounds onto the program's frozen input format (numpy twin of
        ``quant.quantize_to_exponent`` — bit-identical). With ``out`` (a
        staging slot's buffer, and its ``scratch``) the frames are written
        straight into it, zero-padded: on the card path
        (:attr:`card_intake`) as float32 frames, copied in one pass
        (``quant.copy_frames_np``), which ``fn`` rounds on the card;
        elsewhere rounded on the host (``quant.quantize_to_exponent_np``).
        Only the first stage consumes float frames."""
        if not self.is_first:
            raise ValueError(
                f"stage [{self.start}, {self.stop}) does not start the "
                f"chain; it consumes the previous stage's quantized "
                f"activations, not float frames")
        if out is not None and self.card_intake:
            return quant.copy_frames_np(x, out)
        return quant.quantize_to_exponent_np(
            x, self.program.e_input, self.program.bits, out=out,
            scratch=scratch)

    def __call__(self, xq) -> torch.Tensor:
        """Launch one quantized batch (numpy, or a tensor on any device; a
        tuple of them at a cut where several are live) on the runner's
        device's current stream; returns the output tensor (or tuple)
        without waiting for the device.

        A batch elsewhere is copied onto the stream without waiting: into
        the graph's static input when the call replays, into a fresh
        tensor on the device when it runs eagerly. From a pinned host
        tensor its owner keeps it unchanged until the stream has passed
        the call, as the executors' staging rings do. A replay copies the
        batch in, replays the graph and hands back a fresh copy of its
        static output, all three under the runner's lock, in a
        ``runner.replay`` span nested in the caller's. The capture holds
        every runner's launches off (``_GATE``) and runs on a side stream:
        the stage workers share the legacy default stream."""
        tup = isinstance(xq, tuple)
        xs = tuple(torch.as_tensor(t) for t in (xq if tup else (xq,)))
        gate = contextlib.nullcontext()
        if self.device.type == "cuda" and self.route == "kernel":
            key = _shape_key(xs)
            with self._lock:
                g = self._graph
                capture = g is None and key in self._seen
                if g is None:
                    self._seen.add(key)
            if capture:
                g = self._capture(key, xs, tup)
            if g is not None and g.key == key:
                return self._replay(g, xs)
            gate = _GATE.shared()
        with self._lock:
            self.eager_calls += 1
        xs = tuple(t.to(self.device, non_blocking=True) for t in xs)
        with gate:
            return self.fn(xs if tup else xs[0])

    def launch(self, xq, *, sleep: bool):
        """One batch's trip through the range as a serve loop makes it:
        the call on the runner's device, then, on CUDA, the accumulators'
        copy to the host behind the launches (where the range ends the
        chain, so their collector waits on this batch alone, never on one
        queued after it) and an event recorded after both. Returns
        ``(out, done)``; ``done`` is None off CUDA, where the call has
        already run. ``sleep`` makes the event's waiter sleep instead of
        spinning a core (a stage worker, beside the other stages' host
        work)."""
        if self.device.type != "cuda":
            return self(xq), None
        with torch.cuda.device(self.device):
            out = self(xq)
            if self.is_last:
                out = out.to("cpu", non_blocking=True)
            done = torch.cuda.Event(blocking=sleep)
            done.record()
        return out, done

    def _capture(self, key: tuple, xs: tuple, tup: bool) -> _Graph:
        """Capture ``fn`` on static inputs shaped as ``xs``, alone on the
        card (``_GATE``) on a side stream, once: a thread that finds the
        graph made by another takes that one. The capture's own calls to
        ``gemm_int8`` launch nothing and are taken off its counts; each
        replay adds them back. A capture that fails raises."""
        with self._lock:
            if self._graph is not None:
                return self._graph
            with _GATE.alone(), torch.cuda.device(self.device):
                inputs = tuple(torch.empty(t.shape, dtype=t.dtype,
                                           device=self.device) for t in xs)
                graph = torch.cuda.CUDAGraph()
                before = launch_counts()
                try:
                    with torch.cuda.graph(
                            graph, stream=torch.cuda.Stream(self.device),
                            capture_error_mode="thread_local"):
                        outputs = self.fn(inputs if tup else inputs[0])
                finally:
                    after = launch_counts()
                    launches = {k: after[k] - before[k] for k in after}
                    add_launches(launches, -1)
            self._graph = _Graph(key, graph, inputs, outputs, launches)
            self._seen.clear()
            return self._graph

    def _replay(self, g: _Graph, xs: tuple):
        with spans.nested("runner.replay"), self._lock, _GATE.shared():
            for static, x in zip(g.inputs, xs):
                static.copy_(x, non_blocking=True)
            g.graph.replay()
            out = g.outputs
            out = tuple(t.clone() for t in out) if isinstance(out, tuple) \
                else out.clone()
            self.replays += 1
        add_launches(g.launches)
        return out

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
        # float32 as the reference's: exact for int32 and int16, rounded
        # to 24 bits for bits=16's int64 accumulators past 2^24.
        acc = np.asarray(acc)
        scale = self.program.out_scale()
        return acc.astype(np.float32) * scale.reshape(
            (1,) * (acc.ndim - 1) + (-1,))

    def decode(self, acc, n: int, output: str) -> np.ndarray:
        """A batch's answers from its accumulators: the first ``n`` frames'
        logits (:meth:`dequantize`) for ``output == "logits"``, their
        top-1 class ids for ``"top1"`` (empty where ``n`` is 0)."""
        out = self.dequantize(acc)[:n]
        if output != "top1":
            return out
        if not n:
            return np.zeros((0,), dtype=np.int64)
        return np.argmax(out.reshape(n, -1), axis=-1)

    def logits(self, x) -> np.ndarray:
        """Blocking convenience: float frames -> float logits. Bit-identical
        to ``program.run`` on the same route's arithmetic."""
        return self.dequantize(self(self.quantize(np.asarray(x))))

    def classify(self, x) -> np.ndarray:
        """Blocking convenience: float frames -> int class ids."""
        out = self.logits(x)
        return np.argmax(out.reshape(out.shape[0], -1), axis=-1)

    def cache_size(self) -> int:
        """Compiled executables behind the runner: 1 once it has captured
        its CUDA graph, else -1 ("unknown"), since ``fn`` runs eagerly and
        compiles nothing per batch shape."""
        return -1 if self._graph is None else 1


def kernel_available(bits: int = 8) -> tuple[bool, str]:
    """Whether the kernel route applies at ``bits``, and why not. The
    build and the card are checked where the kernel first launches."""
    if bits > 8:
        return False, ("the gemm_int8 kernel is int8; bits=16 runs the "
                       "integer oracle (route='oracle')")
    return True, ""


def require_kernel(bits: int = 8) -> None:
    """Raise up front (when a runner is made, not per step) when the kernel
    route is asked for and cannot run: a run asking for the kernel must
    not silently get the oracle."""
    ok, why = kernel_available(bits)
    if not ok:
        raise NotImplementedError(why)


# ---------------------------------------------------------------------------
# Step executors
# ---------------------------------------------------------------------------


def _step_reads(steps) -> list[tuple[int, ...]]:
    """The outputs each step reads (-1: the frames): its source, then its
    skip, where it adds one (the steps' :meth:`CNNModel.reads`)."""
    return [(i - 1 if s.src is None else s.src,)
            + (() if s.skip is None else (s.skip,))
            for i, s in enumerate(steps)]


def _live_at(reads, cut: int) -> list[int]:
    """The outputs live at the cut before step ``cut``: those a step at or
    after it reads, in index order; the last output at the end."""
    if cut == len(reads):
        return [cut - 1]
    return sorted(j for j in _last_reads(reads, cut) if j < cut)


def _bottlenecks(reads) -> list[int | None]:
    """For each step, the index of the step that adds the skip of the
    bottleneck it belongs to (None: none). A bottleneck is the steps after
    its input, the one output read into them from before them, up to the
    step that adds the skip: its projection shortcut is inside, the stem
    and the pools are not."""
    block: list[int | None] = [None] * len(reads)
    for i, r in enumerate(reads):
        if len(r) > 1:
            lo = i
            while (first := min(j for k in range(lo, i + 1)
                                for j in reads[k])) < lo - 1:
                lo = first + 1
            block[lo:i + 1] = [i] * (i + 1 - lo)
    return block


_NO_SPAN = contextlib.nullcontext()


def _chain(steps, start: int, stop: int, step_fn) -> Callable:
    """The launches of steps ``[start, stop)`` as one function: ``step_fn``
    for the engines, the integer pools for the pools. Each output is kept
    while a later step of the range still reads it. The function takes the
    outputs live at ``start`` (:func:`_live_at`) and returns those live at
    ``stop``, a tuple where there are several (a cut inside a bottleneck)
    and one tensor alone otherwise, as along a chain. The launches of each
    bottleneck (:func:`_bottlenecks`) run inside a ``residual.launch``
    span carrying the enclosing span's owner and batch, and each
    depthwise step's inside a ``depthwise.launch`` span nested the same
    way (inside its block's where it has one)."""
    kinds = {"pool": _pool_int, "gap": _gap_int}
    reads = _step_reads(steps)
    ins, outs = _live_at(reads, start), _live_at(reads, stop)
    block = _bottlenecks(reads)
    last = _last_reads(reads, start, stop)
    plan = [(kinds.get(steps[i].kind, step_fn), steps[i], i, reads[i][0],
             reads[i][1] if len(reads[i]) > 1 else None,
             tuple(j for j in set(reads[i]) if last[j] == i
                   and j not in outs), block[i], steps[i].layer.depthwise)
            for i in range(start, stop)]

    @torch.no_grad()
    def chain(payload):
        env = dict(zip(ins, payload)) if len(ins) > 1 else {ins[0]: payload}
        cur, blk = None, None
        try:
            for fn, step, i, src, skip, drop, b, dw in plan:
                if b != cur:
                    if blk is not None:
                        blk.__exit__(None, None, None)
                    blk = None if b is None else \
                        spans.nested("residual.launch").__enter__()
                    cur = b
                with spans.nested("depthwise.launch") if dw else _NO_SPAN:
                    env[i] = fn(env[src], step) if skip is None else \
                        fn(env[src], step, env[skip])
                for j in drop:
                    del env[j]
        finally:
            if blk is not None:
                blk.__exit__(None, None, None)
        return env[outs[0]] if len(outs) == 1 else \
            tuple(env[j] for j in outs)
    return chain


def _gap_int(xq: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """The global average pool on the integers: the int8 map summed
    exactly in int32 over H and W (``[B, 1, 1, C]``), then requantized
    once onto the pool's own po2 format (``step.shift``); the 1/area is in
    the next engine's weights (:func:`folded_weights`)."""
    acc = xq.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)
    return requantize_ref(acc, step.shift)[:, None, None, :]


def _pool_int(xq: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """Max pool directly on the integer activations — max is monotone in
    the po2 format, so this is exact and the exponent passes through. The
    padding is ``(lo, hi)``, filled with the dtype's minimum."""
    lyr = step.layer
    lo, hi = step.pad
    fill = float("-inf") if xq.is_floating_point() \
        else torch.iinfo(xq.dtype).min
    return _max_pool_nhwc(xq, lyr.kernel, lyr.stride, lo, hi, fill)


def _qmax(step: EngineStep) -> int:
    return QMAX if step.qmax is None else step.qmax


def _step_kernel(xq: torch.Tensor, step: EngineStep,
                 skip: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel route: ``gemm_int8`` with the fused epilogue (the skip,
    where the step has one, added in it; a ReLU6 engine's ceiling), on the
    K-major weights (the layout its ``wgmma`` kernels read); a depthwise
    conv on ``dwconv_int8`` (through ``conv2d_int8``), on ``wq``."""
    lyr = step.layer
    emit = not step.requantize
    if step.kind == "fc":
        return fc_int8(xq.reshape(xq.shape[0], -1), step.wk, step.shift,
                       step.bias_q, relu=step.relu, emit_int32=emit,
                       qmax=_qmax(step))
    return conv2d_int8(xq, step.wq if lyr.depthwise else step.wk,
                       step.shift, step.bias_q, stride=lyr.stride,
                       padding=(step.pad, step.pad), groups=lyr.groups,
                       relu=step.relu, emit_int32=emit, residual=skip,
                       res_shift=step.skip_shift, qmax=_qmax(step))


def _step_oracle(xq: torch.Tensor, step: EngineStep,
                 skip: torch.Tensor | None = None) -> torch.Tensor:
    """The integer oracle with the identical fused epilogue. At bits=8 its
    MACs are a float64 ``F.conv2d`` / matmul, independent of im2col and of
    the kernel: every partial sum is an integer far below 2^53, and the
    rounding before the int32 cast absorbs the last-bit error of a
    transform-based conv algorithm (it stays many orders below 0.5).
    int16 weights (bits=16) take :func:`_step_oracle16`."""
    if step.wq.dtype != torch.int8:
        return _step_oracle16(xq, step)
    lyr = step.layer
    if step.kind == "fc":
        acc = matmul_int8_exact(xq.reshape(xq.shape[0], -1), step.wq)
    else:
        acc = _conv_nhwc(xq.to(torch.float64), step.wq.to(torch.float64),
                         lyr.stride, step.pad, lyr.groups)
        acc = torch.round(acc).to(torch.int32)
    return _epilogue_int32(acc, step, skip)


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


def _step_exact_f32(xq: torch.Tensor, step: EngineStep,
                    skip: torch.Tensor | None = None) -> torch.Tensor:
    """int8 conv/fc via *exact* float32 arithmetic, with the identical
    fused epilogue. The conv lowers through the shared int8 im2col and
    float32 GEMMs, not ``F.conv2d``: cuDNN's FFT and Winograd algorithms
    are not chains of MACs, so the 2^24 argument would not hold for them.
    Chunking the flat im2col depth bounds every chunk at 1024 products
    whatever the kernel size, so no conv is refused here. A depthwise conv
    has no GEMM to speak of (K = 9 a channel): its nine taps are summed in
    int32, exactly (``dwconv_int8``'s plain version)."""
    lyr = step.layer
    if step.kind == "fc":
        acc = _matmul_exact_f32(xq.reshape(xq.shape[0], -1), step.wq)
    elif lyr.depthwise:
        acc = depthwise_acc(xq, step.wq, lyr.stride)
    else:
        acc = conv2d_int8_via(
            lambda patches, w2d, shift, bias, relu: _matmul_exact_f32(
                patches, w2d),
            xq, step.wq, step.shift, None, stride=lyr.stride,
            padding=(step.pad, step.pad), groups=lyr.groups)
    return _epilogue_int32(acc, step, skip)


# Max MAC terms per float64 chain on the bits=16 oracle: every int16*int16
# product has |p| <= 2^30, and float64 represents all integers up to 2^53
# exactly, so a chain of <= 2^52 / 2^30 = 2^22 products stays exact in any
# order the GEMM sums it (every partial sum is an integer <= 2^52). The
# widest engine of the paper's models has K = 25088 (VGG16 fc6).
_F64_MAX_MACS = 2 ** 22


def _matmul_exact_i64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int16 ``[N, K] @ [K, M]`` -> exact int64 through one float64 GEMM
    (a chain of FMAs: exact for K <= ``_F64_MAX_MACS``, refused beyond)."""
    if x.shape[1] > _F64_MAX_MACS:
        raise NotImplementedError(
            f"K = {x.shape[1]} MACs exceeds the exact float64 chain bound "
            f"({_F64_MAX_MACS}) of the bits=16 oracle")
    return torch.matmul(x.to(torch.float64),
                        w.to(torch.float64)).to(torch.int64)


def _step_oracle16(xq: torch.Tensor, step: EngineStep) -> torch.Tensor:
    """The bits=16 engine in exact integer arithmetic: int16 x int16 MACs
    into int64 accumulators (:func:`_matmul_exact_i64` over the int16
    im2col patches; never ``F.conv2d``, whose FFT and Winograd algorithms
    are not chains of FMAs), + bias, ReLU, then ``floor(acc / 2^shift)``
    (an arithmetic shift; a left shift for a negative one) clipped to
    int16. The last engine emits the int64 accumulators.

    The reference computes the same engine in float32, which models the
    DSP48's 48-bit accumulator: it rounds accumulators past 2^24 and
    shifts by its float32 ``exp2``. The two agree within one LSB on
    hidden layers and within a float32 rounding on the last
    (``tests/test_torch_bits16.py``); this one is the same on every
    device."""
    lyr = step.layer
    if step.kind == "fc":
        acc = _matmul_exact_i64(xq.reshape(xq.shape[0], -1), step.wq)
    else:
        acc = conv2d_int8_via(
            lambda patches, w2d, shift, bias, relu: _matmul_exact_i64(
                patches, w2d),
            xq, step.wq, step.shift, None, stride=lyr.stride,
            padding=(step.pad, step.pad), groups=lyr.groups)
    acc = acc + step.bias_q.to(torch.int64).reshape(
        (1,) * (acc.ndim - 1) + (-1,))
    if step.relu:
        acc = torch.clamp(acc, min=0)
    if not step.requantize:
        return acc
    sh = step.shift.to(torch.int64).reshape((1,) * (acc.ndim - 1) + (-1,))
    right = torch.bitwise_right_shift(acc, torch.clamp(sh, min=0))
    # A left shift of >= 1 takes any |acc| >= 2^16 past the int16 rails,
    # so clamping there first keeps the sign and the clip and cannot
    # overflow int64 (2^16 << 31 = 2^47).
    left = torch.bitwise_left_shift(torch.clamp(acc, -2 ** 16, 2 ** 16),
                                    torch.clamp(-sh, min=0))
    y = torch.where(sh >= 0, right, left)
    qmax = 2 ** 15 - 1
    return torch.clamp(y, -qmax - 1, qmax).to(torch.int16)


def _epilogue_int32(acc: torch.Tensor, step: EngineStep,
                    skip: torch.Tensor | None = None) -> torch.Tensor:
    """The shared fused output stage on exact int32 accumulators (the
    aligned skip added before ReLU where the step has one)."""
    M = acc.shape[-1]
    flat = acc.reshape(-1, M)
    res = None if skip is None else skip.reshape(-1, M)
    if step.requantize:
        out = requantize_ref(flat, step.shift, step.bias_q, step.relu,
                             residual=res, res_shift=step.skip_shift,
                             qmax=_qmax(step))
    else:
        out = bias_relu_ref(flat, step.bias_q, step.relu, residual=res,
                            res_shift=step.skip_shift)
    return out.reshape(acc.shape)


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
    if bits not in (8, 16):
        raise ValueError(f"bits={bits}: the engine runs 8 or 16")
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
    if bits > 8 and (not model.linear
                     or any(l.kind == "gap" or l.relu6
                            for l in model.layers)):
        raise NotImplementedError(
            f"{model.name} at bits={bits}: the skip's alignment, the "
            f"global average pool's requantize and ReLU6's ceiling are "
            f"frozen for int8 activations; the bits=16 oracle runs linear "
            f"chains only")
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


def relu6_ceiling(e_out: int, bits: int = 8) -> int:
    """The largest integer a ReLU6 engine may emit on its po2 output format
    ``e_out``: 6 on that format, ``floor(6 * 2^-e_out)``, or the format's
    own maximum where that is smaller."""
    qmax = 2 ** (bits - 1) - 1
    six = 6 << -e_out if e_out <= 0 else 6 >> e_out
    return min(qmax, six)


@torch.no_grad()
def _lower(model: CNNModel, params: Params, amax: dict[str, float],
           e_input: int, bits: int) -> list[EngineStep]:
    """Freeze every engine's formats and quantize its weights once.

    The rule (``bench/reference/resnet_int8.py`` keeps a frozen copy):

    * every activation is int<bits> on a per-tensor po2 format, ``e_out =
      ceil(log2(amax / qmax))`` of the calibration forward's amax
      (:func:`float_forward`): after ReLU where the layer has one, a
      block's last conv after its skip add and ReLU, a projection
      shortcut before the add; a pool passes its input's format on;
    * an engine reads its source's format ``e_in``; its weights get
      per-output-channel po2 exponents ``e_w[m]``, floored so the bias
      fits 30 bits, the output shift 31 and, where the engine adds a
      skip of format ``e_s``, the aligned skip 24 bits (``e_w[m] >= e_s -
      24 - e_in``); biases are rounded onto each accumulator's format
      ``e_in + e_w[m]``, and ``shift[m] = e_out - e_in - e_w[m]``, clipped
      to [-31, 31];
    * a residual engine computes ``clip(shift(relu(acc + bias +
      align(skip))))``: ``skip_shift[m] = e_in + e_w[m] - e_s``; where it
      is negative (the skip's format the coarser) ``align`` is a left
      shift, exact for an int8 skip of at most 24 places; else an
      arithmetic right shift, which rounds as the requantize shift does.
      The adds wrap in int32 as the bias add does;
    * a ReLU6 engine holds its output at 6: its int8 clip stops at
      :func:`relu6_ceiling` of its output format, ``min(127,
      floor(6 * 2^-e_out))`` (its calibration amax is at most 6, so
      ``e_out <= -4`` and the ceiling is 6 on the format exactly);
    * the global average pool sums the map exactly in int32 and
      requantizes the sum once onto its own format (calibrated on the
      float sum); the fc after it quantizes its float weights divided by
      the map's area (:func:`folded_weights`) and emits int32
      accumulators, as the last engine does.

    The weight scale ``2^-e_w`` is the reference's ``jnp.exp2``, which XLA
    lowers to ``exp(ln2 * x)`` in float32: off the exact power of two for
    |x| >= 13. ``ref_exp2`` computes the same float32 value on the host,
    so the two lowerings agree for every exponent
    (``tests/test_torch_program.py``)."""
    steps: list[EngineStep] = []
    last = [l for l in model.layers if l.computes][-1]
    device = params[last.name]["w"].device
    e_of: list[int] = []                   # each layer's output format
    qmax = 2 ** (bits - 1) - 1
    for i, (lyr, (src, *skips), hw) in enumerate(zip(
            model.layers, model.reads(), model.in_sizes())):
        pad = lyr.padding(hw)
        e_act = e_input if src < 0 else e_of[src]
        src_step = None if lyr.src is None else src
        if lyr.kind == "pool":
            steps.append(EngineStep(name=lyr.name, kind="pool", layer=lyr,
                                    pad=pad, src=src_step))
            e_of.append(e_act)
            continue
        if lyr.kind == "gap":
            e_out = quant.po2_exponent(amax[lyr.name], bits)
            shift = np.full(lyr.out_ch, np.clip(e_out - e_act, -31, 31),
                            np.int32)
            steps.append(EngineStep(
                name=lyr.name, kind="gap", layer=lyr, pad=pad,
                shift=torch.as_tensor(shift, device=device), e_in=e_act,
                e_out=e_out, src=src_step))
            e_of.append(e_out)
            continue
        w = folded_weights(model, params, i)
        b = params[lyr.name]["b"]
        e_w = quant.po2_scale(w, axis=-1, bits=bits).cpu().numpy().astype(
            np.int64)
        is_last = lyr is last
        if is_last and lyr.relu6:
            raise NotImplementedError(
                f"{lyr.name}: the last engine emits int32 accumulators, "
                f"which ReLU6's int8 ceiling cannot hold")
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
        skip = skip_shift = None
        if skips:
            skip, = skips
            # (c) the skip, shifted left onto the accumulator, fits too.
            e_w = np.maximum(e_w, e_of[skip] - 24 - e_act)
            skip_shift = torch.as_tensor(
                np.clip(e_act + e_w - e_of[skip], -24, 31).astype(np.int32),
                device=w.device)
        # Quantize weights once onto the (possibly floored) formats, with
        # the reference's float32 multiply.
        scale = ref_exp2(-e_w).to(w.device).reshape(
            (1,) * (w.ndim - 1) + (-1,))
        wq = torch.clamp(torch.round(w * scale), -qmax - 1, qmax).to(
            quant.int_dtype(bits))
        # Bias pre-scaled onto this engine's 32-bit accumulator format
        # (value = q * 2^(e_in + e_w[m])).
        acc_e = e_act + e_w
        bias_q = np.clip(np.round(b_np / np.exp2(acc_e)),
                         np.iinfo(np.int32).min, np.iinfo(np.int32).max
                         ).astype(np.int32)
        shift = np.clip(e_out - acc_e, -31, 31).astype(np.int32)
        wq = wq.contiguous()
        steps.append(EngineStep(
            name=lyr.name, kind=lyr.kind, layer=lyr, pad=pad,
            wq=wq, wk=k_major_view(wq) if bits <= 8 and not lyr.depthwise
            else None,
            bias_q=torch.as_tensor(bias_q, device=w.device),
            shift=torch.as_tensor(shift, device=w.device), e_in=e_act,
            e_w=e_w, e_out=e_out,
            relu=lyr.relu if lyr.relu is not None else not is_last,
            requantize=not is_last, src=src_step, skip=skip,
            skip_shift=skip_shift,
            qmax=relu6_ceiling(e_out, bits) if lyr.relu6 else None))
        e_of.append(e_out)
    return steps
