"""Multi-tenant model zoo behind one serving frontend. PyTorch twin of
``repro/serving/server.py``.

The paper compiles one accelerator per CNN, but the framework's point is
that the *same* fabric and allocation algorithm serve "various CNN
models" — production traffic is many models at once. This module is the
serving-side analogue of partitioning one fabric across concurrent
compiled workloads (Shen et al., "Maximizing CNN Accelerator Efficiency
Through Resource Partitioning"):

* :class:`ProgramRegistry` — an ordered catalogue of compiled
  :class:`~repro_torch.core.program.EngineProgram`\\ s, one per model id;
* :class:`ServerConfig` + :func:`build_server` — the
  compile -> partition -> replicate -> warm -> frontend lifecycle, run
  once per registered model (each model gets its own
  :class:`~repro_torch.serving.pipeline_executor.PipelineExecutor` or
  :class:`~repro_torch.serving.replica_pool.ReplicaPool`, its own measured
  steady-state throughput, and its own estimator channels);
* :class:`TenantMux` — one :class:`~repro_torch.serving.Executor` over the
  per-model executors, dispatching each single-tenant micro-batch by
  the tenant tag the frontend stamped on it;
* :class:`Server` — ``submit(model_id, frame, ...)`` with a typed
  :class:`UnknownModelError` for unregistered ids, ``stats()`` with
  per-tenant rollups, :meth:`Server.rescale` for live
  drain-swap-resume reconfiguration (new K, R, or batch built and
  calibrated in the background, swapped in between micro-batches —
  see ``repro_torch.serving.elastic`` for the controller that automates
  it), idempotent ``close()``.

The single-model serve paths (:func:`serve`, :func:`serve_async`,
:func:`serve_qos`, :func:`serve_knee` — the entry points of
``repro_torch.launch.serve_cnn``) are thin wrappers building a one-model
registry: a one-model server attaches the frontend straight to the bare
executor under the default tenant, so the estimator channels, router
warm-start, and every result schema are the reference's.

Differences from the reference:

* Every compiling entry point takes ``device`` (default ``cuda``; raises
  without one): the weights and the calibration batch are seeded numpy
  (``models.cnn.init_params``), so for one seed they differ from the
  reference's ``jax.random`` draw.
* :func:`serve` runs the single :class:`EngineExecutor` and can return
  the served outputs (``return_outputs``); :func:`serve_async` can too,
  in stream order, and reports ``batches_run``, the micro-batches its
  executor's stage chains ran (warmup and calibration included).
* :func:`serve_knee_rescale` can return each served frame's output
  (``return_outputs``), so a caller can hold the frames served across a
  live rescale against a single executor.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core import workload as W
from repro_torch.core.executor import EngineExecutor
from repro_torch.core.program import compile_model, resolve_device
from repro_torch.models import cnn
from repro_torch.serving.calibrate import (default_max_wait_ms,
                                           pipeline_throughput,
                                           warmed_frontend)
from repro_torch.serving.estimator import ServiceTimeEstimator, window_key
from repro_torch.serving.frontend import (DEFAULT_TENANT, AsyncFrontend,
                                          ServedRequest, tenant_key)
from repro_torch.serving.pipeline_executor import PipelineExecutor
from repro_torch.serving.replica_pool import ReplicaPool

class UnknownModelError(KeyError):
    """Submit (or lookup) named a model id the registry never saw."""

    def __init__(self, name: str, known=()):
        self.name = name
        known = sorted(known)
        msg = f"unknown model {name!r}"
        if known:
            msg += f" (registered: {', '.join(known)})"
        super().__init__(msg)

    def __str__(self) -> str:  # KeyError repr-quotes its arg; keep prose
        return self.args[0]


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


class ProgramRegistry:
    """Ordered catalogue of compiled programs, one per model id. The
    registry is pure bookkeeping — no executors, no threads — so it can
    be built anywhere (tests hand it tiny compiled programs) and handed
    to :func:`build_server` to bring a serving fleet up around it."""

    def __init__(self):
        self._programs: dict[str, object] = {}

    @staticmethod
    def _io_contract(program):
        """The (input shape, bits) contract a compiled program imposes
        on submitted frames — None for opaque stand-ins (tests register
        fakes), which then skip collision checking."""
        model = getattr(program, "model", None)
        bits = getattr(program, "bits", None)
        if model is None or bits is None:
            return None
        return ((model.input_hw, model.input_hw, model.input_ch),
                int(bits))

    def register(self, name: str, program) -> None:
        if name in self._programs:
            raise ValueError(f"model {name!r} already registered")
        # Frames are validated by shape at Server.submit; two models
        # with identical input shapes but different bit widths would
        # accept each other's frames while quantizing them to different
        # integer formats — refuse the ambiguity at registration.
        new = self._io_contract(program)
        if new is not None:
            for other, prog in self._programs.items():
                old = self._io_contract(prog)
                if old is not None and old[0] == new[0] \
                        and old[1] != new[1]:
                    raise ValueError(
                        f"model {name!r} (input {new[0]}, "
                        f"{new[1]}-bit) collides with registered "
                        f"{other!r} (input {old[0]}, {old[1]}-bit): "
                        f"same frame shape under a different dtype "
                        f"contract")
        self._programs[str(name)] = program

    def register_imported(self, source, *, name: str | None = None,
                          bits: int = 8, seed: int = 0,
                          theta: int | None = None,
                          golden_check: bool = True, device=None):
        """The compiler front door: import ``source`` (a spec dict,
        ``.json``/``.onnx`` path, or in-memory compiler ``Graph``),
        lower it onto the engine contract, quantize it with the shared
        serving conventions, and register the compiled program.

        Returns ``(name, golden)`` — the id it registered under and the
        int8 golden parity record. With ``golden_check`` (default) the
        golden is generated on the exact-f32 MAC route and re-executed
        on the int32 oracle route before registration: an import that
        cannot reproduce its own golden across routes never enters the
        zoo (raises :class:`repro_torch.compiler.GoldenMismatch`).
        ``device`` defaults to ``cuda``."""
        from repro_torch import compiler

        model, params = compiler.import_source(source, device=device)
        if name is None:
            name = model.name
        if name in self._programs:
            raise ValueError(f"model {name!r} already registered")
        prog = compiler.quantize(model, params, bits=bits, seed=seed,
                                 theta=theta, device=device)
        golden = compiler.make_golden(prog, seed=seed, route="f32")
        if golden_check:
            compiler.check_golden(prog, golden, seed=seed, route="oracle")
        self.register(name, prog)
        return name, golden

    def get(self, name: str):
        try:
            return self._programs[name]
        except KeyError:
            raise UnknownModelError(name, self._programs) from None

    def names(self) -> tuple[str, ...]:
        return tuple(self._programs)

    def items(self):
        return self._programs.items()

    def __contains__(self, name: str) -> bool:
        return name in self._programs

    def __len__(self) -> int:
        return len(self._programs)

    def __iter__(self) -> Iterator[str]:
        return iter(self._programs)

    @classmethod
    def compile(cls, names, *, bits: int = 8, seed: int = 0,
                theta: int | None = None, device=None) -> "ProgramRegistry":
        """Convenience: compile each named paper CNN with the shared
        serving conventions on ``device`` (default ``cuda``) and register
        it."""
        reg = cls()
        for name in names:
            reg.register(name, compile_for_serving(name, bits=bits,
                                                   seed=seed, theta=theta,
                                                   device=device))
        return reg


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Everything :func:`build_server` needs beyond the programs. One
    config applies to every registered model (the compiled batch size
    must be fleet-wide: the frontend assembles fixed-size micro-batches
    per tenant); per-tenant asymmetry lives in ``tenant_shares``."""

    batch: int = 16
    stages: int = 2
    bits: int = 8                      # recorded; programs carry their own
    route: str | None = None
    output: str = "top1"
    seed: int = 0
    theta: int | None = None
    replicas: int | dict = 1           # fleet-wide, or {model: R} per tenant
    replica_mode: str = "pipeline"
    place_stages: bool = False
    max_wait_ms: float | None = None   # None: one batch window at the rate
    max_queue: int = 256               # per-(tenant, priority) lane bound
    admission_control: bool = True
    flush_guard_ms: float | None = None
    tenant_shares: dict | None = None  # WRR weights; None = equal
    calib_frames: int | None = None    # None: (6 + 2*stages) * batch
    # Elastic runtime: with auto_rescale, every frontend the server
    # mints gets an ElasticController watching it (observe -> decide ->
    # act on a background thread; see repro_torch.serving.elastic).
    # rescale_policy overrides ElasticPolicy fields by name.
    auto_rescale: bool = False
    rescale_policy: dict | None = None
    rescale_interval_s: float = 0.25

    def replicas_for(self, name: str) -> int:
        """The replica count for one model: the fleet-wide int, or the
        model's entry in a per-model dict (absent models serve
        unreplicated — a hot tenant scales out without forcing R
        replicas of every cold one)."""
        if isinstance(self.replicas, dict):
            return int(self.replicas.get(name, 1))
        return int(self.replicas)


@dataclasses.dataclass
class TenantRuntime:
    """One model's serving state inside a server: its compiled program,
    its (started) executor, and the calibration measurements the
    frontend warm-starts from."""

    name: str
    program: object
    executor: object
    steady_fps: float = 0.0
    lat1_s: float | None = None        # unloaded single-batch traversal
    warmup_s: float = 0.0              # compile + first warm pass
    calib: object = None               # ServeStats over the measured window


def make_executor(prog, *, stages: int, batch: int, route, output,
                  place_stages: bool = False, replicas: int = 1,
                  replica_mode: str = "pipeline", seed: int = 0):
    """One executor for every serve path: the single
    :class:`PipelineExecutor` when ``replicas <= 1``, otherwise a
    :class:`ReplicaPool` of R routed replicas
    over the device mesh (``pipeline``: whole pipeline per device;
    ``stage-shard``: each replica stage-pipelines across its contiguous
    device slice). The router RNG is seeded alongside everything else,
    so cold-start placement replays."""
    if replicas <= 1:
        return PipelineExecutor(prog, stages=stages, batch_size=batch,
                                route=route, output=output,
                                place_stages=place_stages)
    return ReplicaPool(prog, replicas=replicas, mode=replica_mode,
                       stages=stages, batch_size=batch, route=route,
                       output=output, router_seed=seed)


class TenantMux:
    """One :class:`~repro_torch.serving.Executor` over N per-tenant executors.

    The frontend's batches are single-tenant by construction (models
    take different frame shapes), so the mux only has to read the
    tenant tag the frontend stamped on each request and forward the
    batch to that tenant's executor; results and errors flow back
    through one shared pair of callback slots. ``program`` is None —
    there is no single compiled program behind the mux, and the
    :class:`Server` validates frames against the tenant's own program
    before they reach the frontend."""

    def __init__(self, executors: dict[str, object], *, batch_size: int):
        if not executors:
            raise ValueError("TenantMux needs at least one executor")
        self.children = dict(executors)
        self.batch_size = int(batch_size)
        self.program = None
        self.on_result: Callable | None = None
        self.on_error: Callable | None = None
        for name, ex in self.children.items():
            if ex.on_result is not None:
                raise ValueError(f"executor for {name!r} already has an "
                                 f"on_result consumer")
            # Late-bound forwarders: the frontend claims the mux's slots
            # after construction, and close() releases them; children
            # read whatever is current at delivery time.
            ex.on_result = self._forward_result
            ex.on_error = self._forward_error

    def _forward_result(self, tag, outputs) -> None:
        cb = self.on_result
        if cb is not None:
            cb(tag, outputs)

    def _forward_error(self, tag, exc) -> None:
        cb = self.on_error
        if cb is not None:
            cb(tag, exc)

    def submit_batch(self, frames: np.ndarray, n_valid: int,
                     tag=None) -> None:
        """Dispatch one single-tenant micro-batch to its tenant's
        executor (blocking on that executor's own backpressure). The
        tag must be the frontend's request tuple — the tenant routing
        key lives on the requests."""
        if not tag:
            raise ValueError("TenantMux.submit_batch needs a request tag "
                             "to route by tenant")
        tenant = tag[0].tenant
        child = self.children.get(tenant)
        if child is None:
            raise UnknownModelError(tenant, self.children)
        child.submit_batch(frames, n_valid, tag=tag)

    def swap_child(self, tenant: str, new_executor) -> object:
        """Replace one tenant's executor behind the mux (the multi-
        tenant half of a live rescale): release the old child's
        forwarder slots, claim the new one's, swap the table entry.
        The caller must have drained dispatch first
        (:meth:`AsyncFrontend.pause_dispatch` + quiescence) — the mux
        itself holds no queue, so a swap between micro-batches is
        atomic by construction. Returns the old executor (drained;
        caller closes it)."""
        old = self.children.get(tenant)
        if old is None:
            raise UnknownModelError(tenant, self.children)
        if new_executor.on_result is not None:
            raise ValueError(f"executor for {tenant!r} already has an "
                             f"on_result consumer")
        old.on_result = None
        old.on_error = None
        new_executor.on_result = self._forward_result
        new_executor.on_error = self._forward_error
        self.children[tenant] = new_executor
        return old

    def flush_inflight(self) -> None:
        for ex in self.children.values():
            ex.flush_inflight()

    def reset_stats(self) -> None:
        for ex in self.children.values():
            ex.reset_stats()

    def replica_counts(self) -> list | None:
        """No fleet-wide replica rows: per-tenant replica accounting is
        read per child (``Server.stats`` does)."""
        return None

    def close(self) -> None:
        for ex in self.children.values():
            # close() is an executor-lifecycle concern, not part of the
            # frontend protocol (the single-chain EngineExecutor has
            # none); fakes without one are already "closed".
            close = getattr(ex, "close", None)
            if close is not None:
                close()


_OUTCOME_KEYS = ("submitted", "completed", "failed", "expired",
                 "rejected", "rejected_wait", "late")


class Server:
    """A started multi-tenant serving fleet: one (possibly muxed)
    executor, per-tenant calibration, and frontend lifecycle. Built by
    :func:`build_server`; use as a context manager or call
    :meth:`close` (idempotent)."""

    def __init__(self, registry: ProgramRegistry, config: ServerConfig,
                 runtimes: dict[str, TenantRuntime]):
        self.registry = registry
        self.config = config
        self._runtimes = runtimes
        self._lock = threading.Lock()
        self._rescale_lock = threading.Lock()
        self._closed = False
        self._frontends: list[AsyncFrontend] = []
        self._default_frontend: AsyncFrontend | None = None
        self._controller = None            # auto-rescale ElasticController
        # One model serves under the default tenant on its bare
        # executor: the frontend's estimator keys, router warm-start,
        # and lane layout are then exactly the single-model ones — the
        # registry is invisible until a second model registers.
        self.multi = len(runtimes) > 1
        if self.multi:
            self._mux = TenantMux(
                {name: rt.executor for name, rt in runtimes.items()},
                batch_size=config.batch)
        else:
            self._mux = None

    # -- topology ------------------------------------------------------------

    @property
    def executor(self):
        """What a frontend attaches to: the tenant mux, or the single
        model's bare executor."""
        if self._mux is not None:
            return self._mux
        (rt,) = self._runtimes.values()
        return rt.executor

    @property
    def model_names(self) -> tuple[str, ...]:
        return tuple(self._runtimes)

    def runtime(self, name: str) -> TenantRuntime:
        rt = self._runtimes.get(name)
        if rt is None:
            raise UnknownModelError(name, self._runtimes)
        return rt

    def _tenant_of(self, name: str) -> str:
        return name if self.multi else DEFAULT_TENANT

    def _model_of_tenant(self, tenant: str) -> str | None:
        if self.multi:
            return tenant if tenant in self._runtimes else None
        (name,) = self._runtimes
        return name if tenant in (DEFAULT_TENANT, name) else None

    # -- frontend lifecycle --------------------------------------------------

    def open_frontend(self, rate=None, *,
                      admission_control: bool | None = None) -> AsyncFrontend:
        """A fresh frontend over this server's executor, warm-started
        from the per-tenant calibration. ``rate`` sizes the batcher's
        flush timeout (one full-batch window at the expected arrival
        rate): a float for a one-model server, a ``{model: fps}``
        mapping (or None — the calibrated steady rates) for a
        multi-model one. The server closes any still-open frontend it
        minted at :meth:`close`; callers that finish earlier close it
        themselves (the executor is reusable across frontends). With
        ``ServerConfig(auto_rescale=True)`` an
        :class:`~repro_torch.serving.elastic.ElasticController` is
        attached to the new frontend (observe cadence
        ``config.rescale_interval_s``, policy overrides from
        ``config.rescale_policy``)."""
        if self._closed:
            raise RuntimeError("server is closed")
        cfg = self.config
        admission = (cfg.admission_control if admission_control is None
                     else admission_control)
        if not self.multi:
            (rt,) = self._runtimes.values()
            r = float(rate) if rate is not None else rt.steady_fps
            fe = warmed_frontend(rt.executor, rt.steady_fps, r, cfg.batch,
                                 max_wait_ms=cfg.max_wait_ms,
                                 admission_control=admission,
                                 flush_guard_ms=cfg.flush_guard_ms,
                                 lat1_s=rt.lat1_s,
                                 max_queue=cfg.max_queue)
        else:
            rates = dict(rate) if isinstance(rate, dict) else {}
            est = ServiceTimeEstimator()
            waits = []
            for name, rt in self._runtimes.items():
                tenant = self._tenant_of(name)
                steady = max(rt.steady_fps, 1e-9)
                win = cfg.batch / steady
                n_rep = getattr(rt.executor, "n_replicas", 1)
                stages = rt.executor.partition.n_stages
                # Same two-channel convention as the single-model
                # warmed_frontend, on the tenant-scoped keys: window at
                # the tenant's fleet batch beat, latency at the measured
                # unloaded traversal (formula fallback K x R x window).
                est.warm_start(window_key(tenant_key(tenant, cfg.batch)),
                               win)
                lat_seed = (rt.lat1_s if rt.lat1_s is not None
                            and rt.lat1_s > 0 else stages * n_rep * win)
                est.warm_start(tenant_key(tenant, cfg.batch), lat_seed)
                router = getattr(rt.executor, "router", None)
                if router is not None:
                    router.warm_start(n_rep * win, stages * n_rep * win)
                r_t = rates.get(name, rt.steady_fps)
                waits.append(default_max_wait_ms(
                    cfg.batch, min(r_t, rt.steady_fps)))
            # One global flush timeout must let the *slowest* tenant
            # fill a batch; faster tenants fill (or expedite) sooner.
            wait_ms = (cfg.max_wait_ms if cfg.max_wait_ms is not None
                       else max(waits))
            fe = AsyncFrontend(self._mux, max_wait_ms=wait_ms,
                               estimator=est,
                               admission_control=admission,
                               flush_guard_ms=cfg.flush_guard_ms,
                               max_queue=cfg.max_queue,
                               tenant_shares=cfg.tenant_shares)
        with self._lock:
            self._frontends.append(fe)
        if cfg.auto_rescale:
            self._attach_controller(fe)
        return fe

    def _attach_controller(self, fe: AsyncFrontend) -> None:
        """Start an :class:`~repro_torch.serving.elastic.ElasticController`
        watching ``fe`` (``ServerConfig.auto_rescale``). One controller
        per server: a newer frontend takes over the watch."""
        from repro_torch.serving.elastic import (ElasticController,
                                                 ElasticPolicy)
        if self.multi:
            raise ValueError("auto_rescale currently watches one model; "
                             "drive rescale() directly on a multi-model "
                             "server")
        cfg = self.config
        policy = ElasticPolicy(**(cfg.rescale_policy or {}))
        with self._lock:
            prev = self._controller
        if prev is not None:
            prev.stop()
        ctrl = ElasticController(self, fe, policy=policy)
        ctrl.start(interval_s=cfg.rescale_interval_s)
        with self._lock:
            self._controller = ctrl

    def _ensure_frontend(self) -> AsyncFrontend:
        with self._lock:
            fe = self._default_frontend
            if fe is not None and not fe._closing.is_set():
                return fe
        fe = self.open_frontend()
        with self._lock:
            self._default_frontend = fe
        return fe

    # -- client side ---------------------------------------------------------

    def submit(self, model_id: str, frame: np.ndarray, *,
               priority: int = 0, deadline_ms: float | None = None,
               klass: str | None = None, timeout: float | None = None,
               block: bool = True) -> ServedRequest:
        """Enqueue one frame for ``model_id`` through the shared
        frontend (created lazily on first submit). Raises
        :class:`UnknownModelError` immediately for an unregistered id —
        typed, at submit, never a hang — and ``ValueError`` for a frame
        the model's compiled program cannot take."""
        if self._closed:
            raise RuntimeError("server is closed")
        rt = self.runtime(model_id)          # raises UnknownModelError
        arr = np.asarray(frame)
        hw = rt.program.model.input_hw
        want = (hw, hw, rt.program.model.input_ch)
        if arr.shape != want:
            raise ValueError(f"frame shape {arr.shape} does not match "
                             f"model {model_id!r} {want}")
        fe = self._ensure_frontend()
        return fe.submit(arr, priority=priority, deadline_ms=deadline_ms,
                         klass=klass, tenant=self._tenant_of(model_id),
                         timeout=timeout, block=block)

    def stats(self) -> dict:
        """Per-tenant rollups across every frontend this server minted:
        calibration numbers per model plus outcome counters and
        end-to-end latency percentiles, and fleet totals."""
        models: dict[str, dict] = {}
        samples: dict[str, list] = {}
        for name, rt in self._runtimes.items():
            models[name] = {
                "steady_fps": round(rt.steady_fps, 3),
                "modeled_fps_alg1": round(rt.program.fps(), 3),
                "warmup_s": round(rt.warmup_s, 3),
                "lat1_ms": (None if rt.lat1_s is None
                            else round(rt.lat1_s * 1e3, 3)),
                "replicas": getattr(rt.executor, "n_replicas", 1),
                "stages": rt.executor.partition.n_stages,
                **{k: 0 for k in _OUTCOME_KEYS},
                "latency_ms_p50": None,
                "latency_ms_p95": None,
            }
            samples[name] = []
        totals = {k: 0 for k in _OUTCOME_KEYS}
        with self._lock:
            frontends = list(self._frontends)
        for fe in frontends:
            st = fe.stats_snapshot()
            for tname, ts in st.tenants.items():
                model = self._model_of_tenant(tname)
                if model is None:
                    continue
                row = models[model]
                for k in _OUTCOME_KEYS:
                    v = getattr(ts, k)
                    row[k] += v
                    totals[k] += v
                samples[model].extend(ts.total_s)
        for name, row in models.items():
            if samples[name]:
                arr = np.asarray(samples[name])
                p50, p95 = np.percentile(arr, [50, 95])
                row["latency_ms_p50"] = round(float(p50) * 1e3, 3)
                row["latency_ms_p95"] = round(float(p95) * 1e3, 3)
        return {"models": models, "totals": totals}

    # -- elastic rescale -----------------------------------------------------

    def _live_frontends(self) -> list[AsyncFrontend]:
        with self._lock:
            return [fe for fe in self._frontends
                    if not fe._closing.is_set()]

    def rescale(self, model_id: str | None = None, *,
                replicas: int | None = None, stages: int | None = None,
                batch: int | None = None, replica_mode: str | None = None,
                calib_frames: int | None = None,
                drain_timeout_s: float = 60.0) -> dict:
        """Live re-partition one model without dropping a request.

        The act half of the elastic runtime (DESIGN.md section 10): build
        the candidate executor — a new K partition via the
        Algorithm-1 DP, a changed micro-batch size, or R+-1 replicas —
        **in the background** while the old one keeps serving, warm and
        calibrate it (every stage warms up, steady fps and unloaded
        traversal are measured fresh), then drain -> swap -> resume:
        every live frontend pauses dispatch at a micro-batch boundary
        (submits keep queueing — nothing is rejected), in-flight batches
        resolve on the old executor, the new executor takes the callback
        slots, and dispatch resumes. Int8 stage boundaries carry no
        cross-batch state, so the handoff is stateless. The frontend's
        estimator channels are forcibly re-warmed
        (:meth:`~repro_torch.serving.estimator.ServiceTimeEstimator
        .rewarm_channels`) from the new calibration — the old plan's
        measured EWMA priced a pipeline that no longer exists.

        ``model_id`` defaults to the sole model of a one-model server;
        unset topology arguments keep their current values. Changing
        ``batch`` is refused on a multi-tenant server (the frontend's
        micro-batch size is fleet-wide). Returns a JSON-ready rescale
        event (before/after topology, compile and swap timings).
        Serialized: concurrent calls queue on an internal lock."""
        if self._closed:
            raise RuntimeError("server is closed")
        if model_id is None:
            if len(self._runtimes) != 1:
                raise ValueError(
                    "a multi-model server needs an explicit model_id "
                    f"(registered: {', '.join(self._runtimes)})")
            (model_id,) = self._runtimes
        rt = self.runtime(model_id)          # raises UnknownModelError
        with self._rescale_lock:
            cfg = self.config
            old_ex = rt.executor
            old = {
                "replicas": getattr(old_ex, "n_replicas", 1),
                "stages": old_ex.partition.n_stages,
                "batch": int(old_ex.batch_size),
                "steady_fps": round(rt.steady_fps, 3),
            }
            new_r = old["replicas"] if replicas is None else int(replicas)
            new_k = old["stages"] if stages is None else int(stages)
            new_b = old["batch"] if batch is None else int(batch)
            mode = (replica_mode if replica_mode is not None
                    else cfg.replica_mode)
            if new_r < 1 or new_k < 1 or new_b < 1:
                raise ValueError(f"replicas={new_r}, stages={new_k}, "
                                 f"batch={new_b} must all be >= 1")
            if self.multi and new_b != old["batch"]:
                raise ValueError(
                    "cannot change batch on a multi-tenant server: the "
                    "frontend's micro-batch size is fleet-wide")
            if (new_r, new_k, new_b) == (old["replicas"], old["stages"],
                                         old["batch"]):
                raise ValueError("rescale with nothing to change "
                                 f"(replicas={new_r}, stages={new_k}, "
                                 f"batch={new_b} already serving)")

            # 1. Background build + calibration: the old executor keeps
            # serving while every new stage warms up and the new plan's
            # steady fps / unloaded traversal are measured.
            t0 = time.perf_counter()
            ex = make_executor(rt.program, stages=new_k, batch=new_b,
                               route=cfg.route, output=cfg.output,
                               place_stages=cfg.place_stages,
                               replicas=new_r, replica_mode=mode,
                               seed=cfg.seed)
            ex.start()
            try:
                n_calib = (calib_frames if calib_frames is not None
                           else (6 + 2 * new_k) * new_b)
                stream = synthetic_stream_like(rt.program.model, n_calib,
                                               cfg.seed)
                warmup_s, lat1_s, ph1 = pipeline_throughput(ex, stream,
                                                            new_b)
                compile_s = time.perf_counter() - t0

                # 2. Drain -> swap -> resume on every live frontend.
                t1 = time.perf_counter()
                lives = self._live_frontends()
                if self._mux is None:
                    for fe in lives:
                        if fe.executor is old_ex:
                            fe.swap_executor(
                                ex, drain_timeout_s=drain_timeout_s)
                else:
                    tenant = self._tenant_of(model_id)
                    paused = []
                    try:
                        for fe in lives:
                            fe.pause_dispatch()
                            paused.append(fe)
                        deadline = time.perf_counter() + drain_timeout_s
                        for fe in paused:
                            while not fe._quiescent():
                                if time.perf_counter() > deadline:
                                    raise TimeoutError(
                                        "frontend did not drain within "
                                        f"{drain_timeout_s:.1f}s; rescale "
                                        "aborted")
                                fe.executor.flush_inflight()
                                time.sleep(0.001)
                        self._mux.swap_child(tenant, ex)
                    finally:
                        for fe in paused:
                            fe.resume_dispatch()
                swap_s = time.perf_counter() - t1
            except BaseException:
                ex.close()
                raise

            # 3. Bookkeeping: runtime, config, estimator re-warm.
            rt.executor = ex
            rt.steady_fps = ph1.steady_fps
            rt.lat1_s = lat1_s
            rt.warmup_s = warmup_s
            rt.calib = ph1
            if isinstance(cfg.replicas, dict):
                new_map = dict(cfg.replicas)
                new_map[model_id] = new_r
            elif self.multi:
                new_map = {name: cfg.replicas_for(name)
                           for name in self._runtimes}
                new_map[model_id] = new_r
            else:
                new_map = new_r
            self.config = dataclasses.replace(
                cfg, replicas=new_map,
                stages=new_k if not self.multi else cfg.stages,
                batch=new_b if not self.multi else cfg.batch)
            self._rewarm_frontends(model_id, rt)

            # 4. The old executor is drained (the swap waited); close it.
            wait = getattr(old_ex, "wait_idle", None)
            if wait is not None:
                wait(timeout=drain_timeout_s)
            old_ex.close()

            actual_k = ex.partition.n_stages
            event = {
                "model": model_id,
                "before": old,
                "after": {
                    "replicas": getattr(ex, "n_replicas", 1),
                    "stages": actual_k,
                    "batch": new_b,
                    "steady_fps": round(rt.steady_fps, 3),
                },
                "replica_mode": mode if new_r > 1 else None,
                "compile_s": round(compile_s, 3),
                "swap_s": round(swap_s, 3),
                "swapped_frontends": len(lives),
            }
            return event

    def _rewarm_frontends(self, model_id: str, rt: TenantRuntime) -> None:
        """Force-reseed every live frontend's estimator channels (and
        the new router) for ``model_id`` from the rescaled plan's fresh
        calibration — the exact :func:`~repro_torch.serving.calibrate
        .warmed_frontend` convention, applied with :meth:`rewarm` so the
        old plan's measurements cannot outrank it."""
        ex = rt.executor
        batch = int(ex.batch_size)
        n_rep = getattr(ex, "n_replicas", 1)
        stages = ex.partition.n_stages
        win = batch / max(rt.steady_fps, 1e-9)
        tenant = self._tenant_of(model_id)
        key = tenant_key(tenant, batch)
        router = getattr(ex, "router", None)
        if router is not None:
            router.reset_pricing()
            router.warm_start(n_rep * win, stages * n_rep * win)
        for fe in self._live_frontends():
            fe.estimator.rewarm_channels(key, win, stages=stages,
                                         replicas=n_rep)
            if rt.lat1_s is not None and rt.lat1_s > 0:
                fe.estimator.rewarm(key, rt.lat1_s)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Close every frontend this server minted, then every
        executor. Idempotent; safe after partial failure."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            frontends = list(self._frontends)
            ctrl = self._controller
            self._controller = None
        if ctrl is not None:                 # stop rescales before drain
            ctrl.stop()
        for fe in frontends:
            fe.close()                       # idempotent per frontend
        if self._mux is not None:
            self._mux.close()
        else:
            for rt in self._runtimes.values():
                rt.executor.close()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_server(registry: ProgramRegistry, config: ServerConfig, *,
                 streams: dict[str, np.ndarray] | None = None,
                 verbose: bool = False) -> Server:
    """Bring a serving fleet up around ``registry``: per model, build
    its executor (pipeline or replica pool), start it, and run the
    shared calibration pass (:func:`~repro_torch.serving.calibrate
    .pipeline_throughput` — warm every stage, measure the
    unloaded traversal, measure closed-loop steady fps). ``streams``
    overrides the seeded synthetic calibration stream per model (the
    single-model serve paths pass their exact bench stream, keeping
    their measured numbers identical to the pre-registry code). On any
    failure mid-build, executors already started are closed before the
    error propagates."""
    if len(registry) == 0:
        raise ValueError("registry has no models to serve")
    if isinstance(config.replicas, dict):
        unknown = set(config.replicas) - set(registry.names())
        if unknown:
            raise ValueError(
                f"ServerConfig.replicas names unregistered models "
                f"{sorted(unknown)} (registered: "
                f"{', '.join(sorted(registry.names()))})")
    calib_frames = (config.calib_frames if config.calib_frames is not None
                    else (6 + 2 * config.stages) * config.batch)
    runtimes: dict[str, TenantRuntime] = {}
    try:
        for name, prog in registry.items():
            stream = (streams or {}).get(name)
            if stream is None:
                # Keyed off the compiled program's own model, so
                # imported (non-paper) models calibrate the same way.
                stream = synthetic_stream_like(prog.model, calib_frames,
                                               config.seed)
            if len(stream) <= config.batch:
                raise ValueError(
                    f"calibration stream for {name!r} has {len(stream)} "
                    f"frames <= batch={config.batch}: no steady-state "
                    f"window (use >= 2*batch)")
            ex = make_executor(prog, stages=config.stages,
                               batch=config.batch, route=config.route,
                               output=config.output,
                               place_stages=config.place_stages,
                               replicas=config.replicas_for(name),
                               replica_mode=config.replica_mode,
                               seed=config.seed)
            ex.start()
            runtimes[name] = rt = TenantRuntime(name=name, program=prog,
                                                executor=ex)
            t0 = time.perf_counter()
            warmup_s, lat1_s, ph1 = pipeline_throughput(ex, stream,
                                                        config.batch)
            rt.warmup_s = warmup_s
            rt.lat1_s = lat1_s
            rt.steady_fps = ph1.steady_fps
            rt.calib = ph1
            if verbose:
                print(f"[server] {name}: K={ex.partition.n_stages} "
                      f"batch={config.batch} steady "
                      f"{rt.steady_fps:.2f} fps, unloaded traversal "
                      f"{lat1_s * 1e3:.1f}ms, warm "
                      f"{time.perf_counter() - t0:.1f}s")
    except BaseException:
        for rt in runtimes.values():
            rt.executor.close()
        raise
    return Server(registry, config, runtimes)


# ---------------------------------------------------------------------------
# Single-model serve paths (the serve_cnn launch surface, unchanged
# flags and artifact schemas — each builds a one-model registry).
# ---------------------------------------------------------------------------


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
        # 1 once the runner replays a CUDA graph; -1 (unknown) eagerly.
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


def _one_model_server(model_name: str, *, frames: int, batch: int,
                      stages: int, bits: int, route, output,
                      place_stages: bool, replicas: int,
                      replica_mode: str, seed: int, theta,
                      max_wait_ms, admission_control: bool = True,
                      flush_guard_ms=None, program=None, device=None):
    """The shared head of the pipelined serve paths: one-model registry,
    server built over the caller's exact frame stream (so phase-1
    calibration measures the same window the pre-registry code did).
    Returns ``(server, runtime, stream)``."""
    if frames <= batch:
        raise ValueError(f"frames={frames} <= batch={batch}: no "
                         f"steady-state window (use frames >= 2*batch)")
    registry = ProgramRegistry()
    registry.register(model_name,
                      program if program is not None
                      else compile_for_serving(model_name, bits=bits,
                                               seed=seed, theta=theta,
                                               device=device))
    stream = synthetic_stream(model_name, frames, seed)
    cfg = ServerConfig(batch=batch, stages=stages, bits=bits, route=route,
                       output=output, seed=seed, theta=theta,
                       replicas=replicas, replica_mode=replica_mode,
                       place_stages=place_stages, max_wait_ms=max_wait_ms,
                       admission_control=admission_control,
                       flush_guard_ms=flush_guard_ms)
    srv = build_server(registry, cfg, streams={model_name: stream})
    return srv, srv.runtime(model_name), stream


def serve_async(model_name: str, *, frames: int = 64, batch: int = 16,
                stages: int = 2, bits: int = 8, route: str | None = None,
                seed: int = 0, theta: int | None = None,
                max_wait_ms: float | None = None,
                arrival_fps: float | None = None,
                place_stages: bool = False,
                replicas: int = 1, replica_mode: str = "pipeline",
                output: str = "top1", program=None,
                verbose: bool = True, device=None,
                return_outputs: bool = False) -> dict:
    """Serve ``frames`` synthetic frames through the K-stage pipelined
    subsystem (``repro_torch.serving``) behind the async request frontend.

    Two measurement phases over one compiled pipeline:

    1. **throughput** — closed-loop stream straight into the
       :class:`PipelineExecutor` (saturating, no frontend) after a
       warmup pass, measuring the steady-state FPS the single-chain path's
       ``measured_steady_fps`` is compared against;
    2. **latency** — the :class:`AsyncFrontend` replays the stream as an
       open-loop arrival process at ``arrival_fps`` (default: 70% of the
       measured throughput, scheduled by the shared seeded generator
       :func:`repro_torch.serving.traffic.make_schedule`) and records
       per-request p50/p95/p99. ``max_wait_ms`` defaults to one
       full-batch assembly window at the arrival rate.

    ``place_stages`` pins stage i to ``cuda:(i % n)``
    (transparent on a single device); ``replicas > 1`` serves through a
    routed :class:`ReplicaPool` instead. Pass ``program`` to reuse an
    already-compiled program (a sweep over stage counts compiles once);
    otherwise it is compiled on ``device`` (default ``cuda``).
    ``return_outputs`` adds every frame's output from the open-loop
    phase, stacked in stream order, under ``"outputs"``.
    """
    from repro_torch.serving.traffic import (TrafficClass, make_schedule,
                                             replay)

    srv, rt, stream = _one_model_server(
        model_name, frames=frames, batch=batch, stages=stages, bits=bits,
        route=route, output=output, place_stages=place_stages,
        replicas=replicas, replica_mode=replica_mode, seed=seed,
        theta=theta, max_wait_ms=max_wait_ms, program=program,
        device=device)
    px, ph1 = rt.executor, rt.calib
    part = px.partition
    steady = rt.steady_fps
    try:
        # Phase 2: open-loop latency at a sustainable arrival rate, one
        # best-effort class (the QoS path is serve_qos).
        rate = arrival_fps if arrival_fps is not None else 0.7 * steady
        if max_wait_ms is None:
            max_wait_ms = default_max_wait_ms(batch, rate)
        fe = AsyncFrontend(px, max_wait_ms=max_wait_ms)
        schedule = make_schedule(len(stream), rate,
                                 [TrafficClass("default")], seed=seed)
        reqs = replay(fe, stream, schedule)
        fe.close()
    finally:
        srv.close()

    lat = fe.stats.latency_percentiles()
    result = {
        "model": model_name,
        "bits": bits,
        "route": px.route,
        "batch": batch,
        "stages": part.n_stages,
        "boundaries": list(part.boundaries),
        "stage_cycles": [round(c, 1) for c in part.stage_cycles],
        "stage_balance": round(part.balance, 4),
        "placed": place_stages,
        "replicas": getattr(px, "n_replicas", 1),
        "replica_mode": replica_mode if replicas > 1 else None,
        "replica_devices": getattr(px, "replica_devices", None),
        "replica_rows": (px.replica_rows()
                         if hasattr(px, "replica_rows") else None),
        "frames": ph1.frames,
        "batches": ph1.batches,
        "padded_frames": ph1.padded_frames,
        "compile_plus_warmup_s": round(rt.warmup_s, 3),
        "measured_steady_fps": round(steady, 3),
        "modeled_fps_alg1": round(rt.program.fps(), 3),
        "arrival_fps": round(rate, 3),
        "client_fps": round(fe.stats.fps, 3),
        "max_wait_ms": round(max_wait_ms, 3),
        "flushes_full": fe.stats.flushes_full,
        "flushes_timeout": fe.stats.flushes_timeout,
        "latency_ms_p50": round(lat["p50"] * 1e3, 3),
        "latency_ms_p95": round(lat["p95"] * 1e3, 3),
        "latency_ms_p99": round(lat["p99"] * 1e3, 3),
        "latency_ms_mean": round(lat["mean"] * 1e3, 3),
        "batches_run": px.batches_run,
    }
    if return_outputs:
        outs = [None] * len(stream)
        for a, r in zip(schedule, reqs):
            outs[a.frame_idx] = r.result(timeout=0)
        result["outputs"] = np.stack(outs)
    if verbose:
        print(f"[serve_async] {model_name} K={part.n_stages} "
              f"batch={batch}: steady {steady:.2f} fps (balance "
              f"{part.balance:.2f}), arrival {rate:.1f} fps -> p50 "
              f"{result['latency_ms_p50']:.1f}ms p95 "
              f"{result['latency_ms_p95']:.1f}ms p99 "
              f"{result['latency_ms_p99']:.1f}ms | modeled "
              f"{result['modeled_fps_alg1']:.1f} fps")
    return result


def _class_row(cs) -> dict:
    """One traffic class's QoS row: outcome counts, SLO rates, and the
    phase-split latency percentiles (ms)."""
    pp = cs.phase_percentiles()
    return {
        "submitted": cs.submitted,
        "completed": cs.completed,
        "expired": cs.expired,
        "rejected": cs.rejected,
        "rejected_wait": cs.rejected_wait,
        "failed": cs.failed,
        "late": cs.late,
        "drop_rate": round(cs.drop_rate, 4),
        "slo_miss_rate": round(cs.slo_miss_rate, 4),
        "phase_ms": {
            phase: {p: round(v * 1e3, 3) for p, v in pcts.items()}
            for phase, pcts in pp.items()},
    }


def _derived_slo_ms(part, px, batch: int, steady: float) -> float:
    """The feasible-deadline convention shared by serve_qos and
    serve_knee: a request's best case traverses assembly (~1 window)
    plus the K-stage pipeline with its depth-2 queues; ~stages + 3
    windows is comfortably feasible below saturation. With R routed
    replicas the *fleet* window is ~R x shorter than one replica's
    per-batch beat, but a batch still traverses a single replica — so
    the traversal term scales by R."""
    return round(
        (part.n_stages * getattr(px, "n_replicas", 1) + 3)
        * 1e3 * batch / max(steady, 1e-9), 1)


def serve_qos(model_name: str, *, frames: int = 96, batch: int = 16,
              stages: int = 2, bits: int = 8, route: str | None = None,
              seed: int = 0, theta: int | None = None,
              slo_ms: float | None = None,
              traffic_mix=None,
              load_factors: tuple[float, ...] = (0.6, 1.2),
              arrival_fps: float | None = None,
              max_wait_ms: float | None = None,
              place_stages: bool = False,
              replicas: int = 1, replica_mode: str = "pipeline",
              poisson: bool = False,
              admission_control: bool = True,
              flush_guard_ms: float | None = None,
              output: str = "top1", program=None,
              verbose: bool = True, device=None) -> dict:
    """Serve a mixed-traffic stream through the QoS frontend and report
    per-class phase-split latency, SLO miss rate, and drop rate.

    After the closed-loop throughput phase (shared with
    :func:`serve_async`), each entry of ``load_factors`` replays the
    same seeded mixed-class schedule
    (:func:`repro_torch.serving.traffic.make_schedule`) open-loop at
    ``factor * measured_steady_fps`` — one rate below saturation and one
    above shows the QoS machinery working: under overload the priority
    lanes keep the interactive class inside its deadline while the
    best-effort class absorbs the queueing, and deadline-armed requests
    that cannot make it are dropped (``expired``), not served late.
    ``arrival_fps`` overrides the factor-derived rates with absolute
    rates ``factor * arrival_fps`` instead.

    ``traffic_mix`` is a sequence of :class:`TrafficClass` (default:
    25% interactive priority-1 with deadline ``slo_ms``, 75%
    best-effort batch). A ``slo_ms`` of None is derived from the
    measured service time — ``(stages + 3)`` batch windows at the
    steady rate — so the deadline is feasible below saturation on any
    backend but binds under overload (a fixed wall-clock default would
    be always-missed for a slow model on CPU and never-missed for a
    fast one, telling us nothing).

    The frontend's control decisions are adaptive: each rate's replay
    gets a :class:`~repro_torch.serving.ServiceTimeEstimator` warm-started
    from the measured calibration pass (one batch window at the steady
    rate) and kept current by every completed batch, driving the
    expedited flush; ``admission_control`` (default on) additionally
    refuses deadline-armed requests whose estimated wait already
    exceeds their budget (``rejected_wait`` — they fail fast instead of
    expiring in queue). Set ``admission_control=False`` for the
    estimator-less lane-bound-only admission.
    """
    from repro_torch.serving.traffic import default_mix, make_schedule, replay

    srv, rt, stream = _one_model_server(
        model_name, frames=frames, batch=batch, stages=stages, bits=bits,
        route=route, output=output, place_stages=place_stages,
        replicas=replicas, replica_mode=replica_mode, seed=seed,
        theta=theta, max_wait_ms=max_wait_ms,
        admission_control=admission_control,
        flush_guard_ms=flush_guard_ms, program=program, device=device)
    px = rt.executor
    part = px.partition
    steady = rt.steady_fps
    rates: dict[str, dict] = {}
    try:
        base = arrival_fps if arrival_fps is not None else steady
        if slo_ms is None:
            slo_ms = _derived_slo_ms(part, px, batch, steady)
        mix = tuple(traffic_mix) if traffic_mix is not None \
            else default_mix(slo_ms)

        warm_start_s = batch / max(steady, 1e-9)
        for factor in load_factors:
            rate = factor * base
            fe = srv.open_frontend(rate)
            schedule = make_schedule(len(stream), rate, mix, seed=seed,
                                     poisson=poisson)
            replay(fe, stream, schedule)
            fe.close()
            st = fe.stats
            rates[f"{factor:g}x"] = {
                "load_factor": factor,
                "arrival_fps": round(rate, 3),
                "client_fps": round(st.fps, 3),
                "max_wait_ms": round(fe.max_wait_s * 1e3, 3),
                "submitted": st.submitted,
                "completed": st.completed,
                "expired": st.expired,
                "rejected": st.rejected,
                "rejected_wait": st.rejected_wait,
                "failed": st.failed,
                "batches": st.batches,
                "flushes_full": st.flushes_full,
                "flushes_timeout": st.flushes_timeout,
                "flushes_deadline": st.flushes_deadline,
                "control": fe.control_config(),
                "classes": {name: _class_row(cs)
                            for name, cs in sorted(st.classes.items())},
                "replica_outcomes": st.replicas or None,
            }
            if verbose:
                parts = []
                for name, cs in sorted(st.classes.items()):
                    pq = cs.phase_percentiles()
                    parts.append(
                        f"{name}: p95 q/a/c "
                        f"{pq['queueing']['p95'] * 1e3:.1f}/"
                        f"{pq['assembly']['p95'] * 1e3:.1f}/"
                        f"{pq['compute']['p95'] * 1e3:.1f}ms "
                        f"miss {cs.slo_miss_rate:.0%} "
                        f"drop {cs.drop_rate:.0%}")
                print(f"[serve_qos] {model_name} K={part.n_stages} "
                      f"load {factor:g}x ({rate:.1f} fps): "
                      + " | ".join(parts))
    finally:
        srv.close()

    return {
        "model": model_name,
        "bits": bits,
        "route": px.route,
        "batch": batch,
        "stages": part.n_stages,
        "boundaries": list(part.boundaries),
        "stage_balance": round(part.balance, 4),
        "placed": place_stages,
        "stage_devices": ([str(d) for d in px.stage_devices]
                          if place_stages and hasattr(px, "stage_devices")
                          else None),
        "replicas": getattr(px, "n_replicas", 1),
        "replica_mode": replica_mode if replicas > 1 else None,
        "replica_devices": getattr(px, "replica_devices", None),
        "replica_rows": (px.replica_rows()
                         if hasattr(px, "replica_rows") else None),
        "seed": seed,
        "slo_ms": slo_ms,
        "poisson": poisson,
        "admission_control": admission_control,
        "flush_guard_ms": flush_guard_ms,
        "estimator_warm_start_ms": round(1e3 * warm_start_s, 3),
        "traffic_mix": [c.to_json() for c in mix],
        "frames": frames,
        "compile_plus_warmup_s": round(rt.warmup_s, 3),
        "measured_steady_fps": round(steady, 3),
        "modeled_fps_alg1": round(rt.program.fps(), 3),
        "rates": rates,
    }


def serve_knee(model_name: str, *, frames: int = 96, batch: int = 16,
               stages: int = 2, bits: int = 8, route: str | None = None,
               seed: int = 0, theta: int | None = None,
               slo_ms: float | None = None,
               traffic_mix=None,
               miss_target: float = 0.01,
               start_factor: float = 0.5,
               start_qps: float | None = None,
               max_factor: float = 4.0,
               refine_iters: int = 3,
               max_wait_ms: float | None = None,
               flush_guard_ms: float | None = None,
               admission_control: bool = True,
               place_stages: bool = False,
               replicas: int = 1, replica_mode: str = "pipeline",
               poisson: bool = False,
               scenario: str | None = None,
               scenario_params: dict | None = None,
               output: str = "top1", program=None,
               server: "Server | None" = None,
               verbose: bool = True, device=None) -> dict:
    """Bracketing absolute-QPS sweep: find the knee — the maximum
    sustained arrival rate at which the deadline-armed (interactive)
    classes keep ``slo_miss_rate < miss_target`` — and record it as the
    headline capacity number.

    ``serve_qos`` reports behaviour at load factors *relative to* the
    measured steady fps; the knee is the *absolute* QPS answer to "how
    much traffic can this deployment take": replay the seeded mix
    open-loop at ``start_factor * steady`` QPS, double while the armed
    classes stay under ``miss_target`` (capped at ``max_factor *
    steady``), halve downward if even the first probe misses, then
    bisect the sustained/unsustained bracket ``refine_iters`` times.
    Every probe reuses the same compiled pipeline, the same seeded
    schedule generator, and a fresh estimator warm-started from the
    calibration pass, so the sweep is reproducible from the recorded
    ``(seed, mix, rates)`` alone. A miss at any probe counts every
    armed-class request that did not complete inside its deadline —
    expired + refused at admission (``rejected_wait``, or ``rejected``
    on a full lane) + served late — so failing fast cannot launder the
    miss rate.

    ``replicas > 1`` sweeps the same knee over a routed
    :class:`ReplicaPool`; ``start_qps`` opens the bracket at an absolute
    rate instead of ``start_factor * steady`` — the knee-vs-R scaling
    sweep starts each R>1 bracket at the R=1 knee, so "replication never
    loses to one replica" is probed directly.

    ``scenario`` selects any arrival process from
    :data:`repro_torch.serving.traffic.SCENARIOS` (``onoff``, ``pareto``, ...)
    with knobs in ``scenario_params`` — the adversarial knees the chaos
    bench sweeps; it supersedes the legacy ``poisson`` flag (which maps
    to ``scenario="poisson"``). Every probe row records a
    :func:`~repro_torch.serving.traffic.pacing_report`, so the artifact shows
    the rate the open loop *achieved*, not just the one it targeted.

    ``server`` reuses an already-built one-model :class:`Server` (e.g.
    after a live :meth:`Server.rescale` — the post-rescale knee must be
    measured on the *rescaled* executor, not a fresh build) instead of
    compiling a new fleet; the caller keeps ownership and closes it.
    """
    from repro_torch.serving.traffic import (armed_class_names, default_mix,
                                       make_scenario_schedule,
                                       pacing_report, replay,
                                       resolve_scenario_params)

    if not 0.0 < miss_target < 1.0:
        raise ValueError(f"miss_target={miss_target} not in (0, 1)")
    if scenario is None:
        scenario = "poisson" if poisson else "uniform"
        if scenario_params:
            raise ValueError("scenario_params without a scenario")
    elif poisson and scenario != "poisson":
        raise ValueError(f"both poisson=True and scenario={scenario!r}")
    # Validate the knobs once up front (fail before compiling anything);
    # the per-probe call re-resolves with the probe's rate.
    resolve_scenario_params(scenario, 0.0, **(scenario_params or {}))
    own_server = server is None
    if own_server:
        srv, rt, stream = _one_model_server(
            model_name, frames=frames, batch=batch, stages=stages,
            bits=bits, route=route, output=output,
            place_stages=place_stages, replicas=replicas,
            replica_mode=replica_mode, seed=seed,
            theta=theta, max_wait_ms=max_wait_ms,
            admission_control=admission_control,
            flush_guard_ms=flush_guard_ms, program=program,
            device=device)
    else:
        srv = server
        if srv.multi:
            raise ValueError("serve_knee reuses one-model servers only")
        rt = srv.runtime(model_name)         # raises UnknownModelError
        stream = synthetic_stream_like(rt.program.model, frames, seed)
        batch = int(rt.executor.batch_size)
        replica_mode = srv.config.replica_mode
    px = rt.executor
    part = px.partition
    steady = rt.steady_fps
    probes: list[dict] = []
    try:
        if slo_ms is None:
            slo_ms = _derived_slo_ms(part, px, batch, steady)
        mix = tuple(traffic_mix) if traffic_mix is not None \
            else default_mix(slo_ms)
        armed = armed_class_names(mix)
        if not armed:
            raise ValueError("traffic mix has no deadline-armed class — "
                             "nothing can define 'sustained'")
        warm_start_s = batch / max(steady, 1e-9)

        def _probe(rate: float) -> dict:
            fe = srv.open_frontend(rate)
            schedule, _ = make_scenario_schedule(
                scenario, len(stream), rate, mix, seed=seed,
                **(scenario_params or {}))
            reqs = replay(fe, stream, schedule)
            pacing = pacing_report(schedule, reqs)
            fe.close()
            st = fe.stats
            cls = [st.klass(n) for n in armed if n in st.classes]
            n_armed = sum(c.submitted for c in cls)
            n_miss = sum(c.expired + c.rejected + c.rejected_wait + c.late
                         for c in cls)
            # The verdict is computed on the rounded rate the artifact
            # stores, so `sustained` and `armed_miss_rate` can never
            # contradict each other under the validator's cross-check.
            miss = round(n_miss / n_armed if n_armed else 0.0, 4)
            total_s = [s for c in cls for s in c.total_s]
            # None, not NaN, when no armed request completed — NaN is
            # not valid JSON and would poison the uploaded artifact.
            p95_ms = (round(float(np.percentile(np.asarray(total_s), 95))
                            * 1e3, 3) if total_s else None)
            row = {
                "arrival_fps": round(rate, 3),
                "sustained": bool(miss < miss_target),
                "armed_miss_rate": miss,
                "armed_submitted": n_armed,
                "armed_missed": n_miss,
                "armed_p95_ms": p95_ms,
                "client_fps": round(st.fps, 3),
                "max_wait_ms": round(fe.max_wait_s * 1e3, 3),
                "submitted": st.submitted,
                "completed": st.completed,
                "expired": st.expired,
                "rejected": st.rejected,
                "rejected_wait": st.rejected_wait,
                "failed": st.failed,
                "pacing": pacing,
            }
            if verbose:
                print(f"[serve_knee] {model_name} probe {rate:8.2f} qps: "
                      f"armed miss {miss:6.2%} "
                      f"({'sustained' if row['sustained'] else 'MISS'}) | "
                      f"expired {st.expired} rejected_wait "
                      f"{st.rejected_wait} p95 "
                      + (f"{p95_ms:.1f}ms" if p95_ms is not None else "n/a"))
            return row

        # Bracket: escalate from start_factor * steady (or the absolute
        # start_qps) by doubling until the armed miss rate crosses the
        # target (or the cap), then bisect [highest sustained, lowest
        # unsustained].
        cap = max(max_factor * steady,
                  start_qps if start_qps is not None else 0.0)
        lo_rate, lo_row, hi_rate = None, None, None
        rate = start_qps if start_qps is not None else start_factor * steady
        while hi_rate is None:
            row = _probe(rate)
            probes.append(row)
            if row["sustained"]:
                lo_rate, lo_row = rate, row
                if rate >= cap:
                    break
                rate = min(2 * rate, cap)
            else:
                hi_rate = rate
        if lo_rate is None:
            # Even the opening probe missed: descend until sustained or
            # the sweep floor — a knee of None means this deployment
            # cannot hold the SLO at any probed rate.
            floor = 0.05 * steady
            while lo_rate is None and rate / 2 >= floor:
                rate = rate / 2
                row = _probe(rate)
                probes.append(row)
                if row["sustained"]:
                    lo_rate, lo_row = rate, row
                else:
                    hi_rate = rate
        for _ in range(max(0, int(refine_iters))):
            if lo_rate is None or hi_rate is None:
                break
            if hi_rate / lo_rate < 1.05:
                break
            mid = (lo_rate + hi_rate) / 2
            row = _probe(mid)
            probes.append(row)
            if row["sustained"]:
                lo_rate, lo_row = mid, row
            else:
                hi_rate = mid
    finally:
        if own_server:
            srv.close()

    result = {
        "model": model_name,
        "bits": bits,
        "route": px.route,
        "batch": batch,
        "stages": part.n_stages,
        "boundaries": list(part.boundaries),
        "stage_balance": round(part.balance, 4),
        "placed": place_stages,
        "replicas": getattr(px, "n_replicas", 1),
        "replica_mode": (replica_mode
                         if getattr(px, "n_replicas", 1) > 1 else None),
        "replica_devices": getattr(px, "replica_devices", None),
        "replica_rows": (px.replica_rows()
                         if hasattr(px, "replica_rows") else None),
        "start_qps": None if start_qps is None else round(start_qps, 3),
        "seed": seed,
        "slo_ms": slo_ms,
        "poisson": scenario == "poisson",
        "scenario": scenario,
        # The resolved knobs minus rate_fps (each probe row carries its
        # own rate): enough to regenerate any probe's schedule.
        "scenario_params": {
            k: v for k, v in resolve_scenario_params(
                scenario, 0.0, **(scenario_params or {})).items()
            if k != "rate_fps"},
        "miss_target": miss_target,
        "admission_control": admission_control,
        "flush_guard_ms": flush_guard_ms,
        "estimator_warm_start_ms": round(1e3 * warm_start_s, 3),
        "traffic_mix": [c.to_json() for c in mix],
        "frames": frames,
        "compile_plus_warmup_s": round(rt.warmup_s, 3),
        "measured_steady_fps": round(steady, 3),
        "modeled_fps_alg1": round(rt.program.fps(), 3),
        "knee_qps": None if lo_rate is None else round(lo_rate, 3),
        "knee_of_steady": (None if lo_rate is None
                           else round(lo_rate / max(steady, 1e-9), 4)),
        "knee_miss_rate": (None if lo_row is None
                           else lo_row["armed_miss_rate"]),
        "knee_armed_p95_ms": (None if lo_row is None
                              else lo_row["armed_p95_ms"]),
        "bracket_unsustained_qps": (None if hi_rate is None
                                    else round(hi_rate, 3)),
        "probes": probes,
    }
    if verbose:
        knee = result["knee_qps"]
        print(f"[serve_knee] {model_name} K={part.n_stages} batch={batch}: "
              f"knee "
              + (f"{knee:.1f} qps ({result['knee_of_steady']:.2f}x steady)"
                 if knee is not None else "not found")
              + f" at armed miss < {miss_target:.0%} | steady "
              f"{steady:.1f} fps | slo {slo_ms:.0f}ms | "
              f"{len(probes)} probes")
    return result


def serve_knee_rescale(model_name: str = "alexnet", *, frames: int = 96,
                       batch: int = 16, stages: int = 2, bits: int = 8,
                       route: str | None = None, seed: int = 0,
                       theta: int | None = None,
                       slo_ms: float | None = None,
                       traffic_mix=None, miss_target: float = 0.01,
                       start_qps: float | None = None,
                       ramp_growth: float = 1.3, max_segments: int = 6,
                       max_factor: float = 4.0, refine_iters: int = 2,
                       max_wait_ms: float | None = None,
                       flush_guard_ms: float | None = None,
                       admission_control: bool = True,
                       place_stages: bool = False,
                       scenario: str | None = None,
                       scenario_params: dict | None = None,
                       max_replicas: int = 2,
                       replica_mode: str = "pipeline",
                       output: str = "top1", program=None,
                       verbose: bool = True, device=None,
                       return_outputs: bool = False) -> dict:
    """Drive a load ramp across the R=1 knee and measure the elastic
    runtime closing the loop live: an :class:`~repro_torch.serving.elastic
    .ElasticController` watches the frontend while open-loop segments
    escalate (``ramp_growth`` per segment, capped at ``max_factor *
    steady``); when the armed miss rate crosses ``miss_target`` the
    controller builds an R+1 plan in the background and performs the
    drain -> swap -> resume between micro-batches — traffic keeps
    flowing the whole time, and ``hung == 0`` certifies no request was
    dropped or left unresolved across the swap.

    After the swap a recovery segment replays the anchor rate — the
    rated pre-ramp load — against the rescaled fleet
    (``armed_miss_after_rescale`` vs ``armed_miss_at_trigger``), and
    :func:`serve_knee` re-brackets the
    knee **on the same server** (``server=`` reuse) so the artifact's
    nested ``knee`` row is the post-rescale capacity, directly
    comparable to the base row's pre-rescale knee.

    Quick CI runs can be too short for the policy's sustained-miss
    window to fire; if the ramp exhausts without a controller event,
    the rescale is *forced* concurrently with live recovery traffic
    (``forced: true`` in the artifact) — the drain-swap-resume
    mechanism is still exercised under load, only the trigger differs.

    The program is compiled on ``device`` (default ``cuda``) unless
    ``program`` is given. ``return_outputs`` adds ``"outputs"``: the
    stream index (``frame_idx``) and the output (``outputs``) of every
    request the ramp, hold and recovery segments served, in completion
    order of the segments (the re-bracketed knee's are not kept).
    """
    from repro_torch.serving.elastic import ElasticController, ElasticPolicy
    from repro_torch.serving.traffic import (armed_class_names, default_mix,
                                             make_scenario_schedule, replay,
                                             resolve_scenario_params)

    if not 0.0 < miss_target < 1.0:
        raise ValueError(f"miss_target={miss_target} not in (0, 1)")
    if max_replicas < 2:
        raise ValueError(f"max_replicas={max_replicas} leaves no room "
                         "to scale out")
    if scenario is None:
        scenario = "uniform"
    resolve_scenario_params(scenario, 0.0, **(scenario_params or {}))
    srv, rt, stream = _one_model_server(
        model_name, frames=frames, batch=batch, stages=stages, bits=bits,
        route=route, output=output, place_stages=place_stages,
        replicas=1, replica_mode=replica_mode, seed=seed, theta=theta,
        max_wait_ms=max_wait_ms, admission_control=admission_control,
        flush_guard_ms=flush_guard_ms, program=program, device=device)
    px = rt.executor
    part = px.partition
    steady = rt.steady_fps
    try:
        if slo_ms is None:
            slo_ms = _derived_slo_ms(part, px, batch, steady)
        mix = tuple(traffic_mix) if traffic_mix is not None \
            else default_mix(slo_ms)
        armed = armed_class_names(mix)
        if not armed:
            raise ValueError("traffic mix has no deadline-armed class — "
                             "nothing can trigger a rescale")
        anchor = start_qps if start_qps is not None else steady
        policy = ElasticPolicy(miss_high=miss_target,
                               miss_low=miss_target / 4,
                               sustain=1, cooldown_s=1.0,
                               max_replicas=max_replicas,
                               min_window_requests=4)
        fe = srv.open_frontend(anchor)
        ctrl = ElasticController(srv, fe, policy=policy)
        ctrl.start(interval_s=0.15)
        segments: list[dict] = []
        served_idx: list[int] = []
        served_out: list = []

        def _armed_counts(st) -> tuple[int, int]:
            cls = [st.klass(n) for n in armed if n in st.classes]
            return (sum(c.submitted for c in cls),
                    sum(c.expired + c.rejected + c.rejected_wait + c.late
                        for c in cls))

        def _segment(rate: float, label: str, seg_seed: int) -> dict:
            sub0, miss0 = _armed_counts(fe.stats_snapshot())
            schedule, _ = make_scenario_schedule(
                scenario, len(stream), rate, mix, seed=seg_seed,
                **(scenario_params or {}))
            reqs = replay(fe, stream, schedule)
            if return_outputs:
                for a, r in zip(schedule, reqs):
                    if r.outcome == "completed":
                        served_idx.append(a.frame_idx)
                        served_out.append(r.result(timeout=0))
            sub1, miss1 = _armed_counts(fe.stats_snapshot())
            dsub, dmiss = sub1 - sub0, miss1 - miss0
            row = {
                "label": label,
                "arrival_fps": round(rate, 3),
                "armed_submitted": dsub,
                "armed_missed": dmiss,
                "armed_miss_rate": round(dmiss / dsub if dsub else 0.0, 4),
                "replicas": getattr(rt.executor, "n_replicas", 1),
                "rescales_so_far": len(ctrl.history),
            }
            segments.append(row)
            if verbose:
                print(f"[serve_knee_rescale] {model_name} {label:>9} "
                      f"{rate:8.2f} qps: armed miss "
                      f"{row['armed_miss_rate']:6.2%} | R="
                      f"{row['replicas']} | rescales "
                      f"{row['rescales_so_far']}")
            return row

        # Ramp: escalate past the R=1 knee until the controller fires.
        # Its history gains an event only once the swap *completed*, so
        # after the ramp, hold segments keep traffic in flight while
        # ctrl.busy — the background build easily outlasts a short
        # open-loop segment, and the whole point is a swap with
        # requests in the air.
        cap = max(max_factor * steady, anchor)
        rate, trigger_row = anchor, None
        for i in range(max(1, int(max_segments))):
            rate = min(rate * ramp_growth, cap)
            row = _segment(rate, f"ramp{i}", seed + i)
            if ctrl.history:
                trigger_row = row
                break
        k = 0
        while not ctrl.history and (ctrl.busy or k < 2) and k < 60:
            _segment(rate, f"hold{k}", seed + 100 + k)
            k += 1
        ctrl.stop()                    # joins any in-flight rescale
        events = [dict(ev) for ev in ctrl.history]
        forced = not events
        if events and trigger_row is None:
            # The act completed during a hold segment (or the stop
            # join); the last segment carried the traffic across it.
            trigger_row = segments[-1]
        if forced:
            # Policy never fired within the ramp; force the mechanism
            # under live traffic so the artifact still certifies the
            # drain-swap-resume path end to end.
            trigger_row = segments[-1]
            errs: list[BaseException] = []

            def _force() -> None:
                try:
                    ev = srv.rescale(model_name, replicas=max_replicas)
                    ev.update({"action": "scale_out", "reason": "forced",
                               "signals": None,
                               "total_s": round(ev["compile_s"]
                                                + ev["swap_s"], 3)})
                    events.append(ev)
                except BaseException as e:  # surfaced after join
                    errs.append(e)

            t = threading.Thread(target=_force, daemon=True,
                                 name="forced-rescale")
            t.start()
            k = 0
            while t.is_alive():        # keep requests in flight
                _segment(trigger_row["arrival_fps"], f"forcehold{k}",
                         seed + 200 + k)
                k += 1
            t.join()
            if errs:
                raise errs[0]
        # Recovery is measured at the anchor (the rated pre-ramp load),
        # not the escalated trigger rate: the question the artifact
        # answers is whether the rescaled fleet serves the load the old
        # topology was rated for, not whether it absorbs an arbitrary
        # overload the ramp happened to end on.
        recovery = _segment(anchor, "recovery", seed + 500)
        fe.close()
        hung = fe.stats.hung
        replicas_after = getattr(rt.executor, "n_replicas", 1)

        # Re-bracket the knee on the rescaled server: the nested row is
        # the post-rescale capacity under the same seed/mix/SLO.
        knee_row = serve_knee(
            model_name, frames=frames, batch=batch, bits=bits, seed=seed,
            slo_ms=slo_ms, traffic_mix=mix, miss_target=miss_target,
            start_qps=anchor, max_factor=max_factor,
            refine_iters=refine_iters, max_wait_ms=max_wait_ms,
            flush_guard_ms=flush_guard_ms,
            admission_control=admission_control, scenario=scenario,
            scenario_params=scenario_params, output=output,
            server=srv, verbose=verbose)
    finally:
        srv.close()

    result = {
        "model": model_name,
        "bits": bits,
        "batch": batch,
        "stages": part.n_stages,
        "seed": seed,
        "slo_ms": slo_ms,
        "miss_target": miss_target,
        "scenario": scenario,
        "traffic_mix": [c.to_json() for c in mix],
        "measured_steady_fps_r1": round(steady, 3),
        "anchor_qps": round(anchor, 3),
        "policy": policy.to_json(),
        "segments": segments,
        "rescale_events": events,
        "n_rescales": len(events),
        "forced": forced,
        "replicas_before": 1,
        "replicas_after": replicas_after,
        "armed_miss_at_trigger": trigger_row["armed_miss_rate"],
        "armed_miss_after_rescale": recovery["armed_miss_rate"],
        "miss_recovered": bool(recovery["armed_miss_rate"]
                               <= trigger_row["armed_miss_rate"]),
        "hung": hung,
        "knee": knee_row,
    }
    if return_outputs:
        result["outputs"] = {"frame_idx": np.asarray(served_idx, np.int64),
                             "outputs": np.stack(served_out)}
    if verbose:
        print(f"[serve_knee_rescale] {model_name}: "
              f"{len(events)} rescale(s)"
              + (" (forced)" if forced else "")
              + f" R 1 -> {replicas_after} | miss at trigger "
              f"{result['armed_miss_at_trigger']:.2%} -> after "
              f"{result['armed_miss_after_rescale']:.2%} | hung {hung} | "
              f"post-rescale knee "
              + (f"{knee_row['knee_qps']:.1f} qps"
                 if knee_row["knee_qps"] is not None else "not found"))
    return result
