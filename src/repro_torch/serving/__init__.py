"""Stage-pipelined async serving subsystem. PyTorch twin of
``repro/serving/__init__.py``.

The software embodiment of the paper's layer-wise pipeline: Algorithm 1's
balance objective splits a compiled :class:`~repro_torch.core.program
.EngineProgram` into K stages of near-equal modeled cycles
(:mod:`~repro_torch.serving.partition`), one worker thread per stage executes
its step range with depth-2 bounded queues between stages — the
activation double-buffer analogue (:mod:`~repro_torch.serving
.pipeline_executor`), optionally with each stage placed on its own
device — and a QoS-aware request frontend batches live traffic into the
pipeline through per-``(tenant, priority)`` lanes with per-request
deadlines, backpressure, weighted round-robin tenant fairness, and
per-class phase-split latency accounting
(:mod:`~repro_torch.serving.frontend`). The frontend's control decisions —
expedited flush and estimated-wait admission — are driven by an online
per-batch-shape EWMA service-time estimator
(:mod:`~repro_torch.serving.estimator`).
:mod:`~repro_torch.serving.traffic` is the
one seeded synthetic-traffic generator every serving bench replays, and
:mod:`~repro_torch.serving.server` hosts a multi-tenant model zoo — a
:class:`ProgramRegistry` of compiled programs behind one frontend.

Every executor the frontend can drive conforms to the :class:`Executor`
protocol below — :class:`PipelineExecutor`, :class:`ReplicaPool`, the
single-chain :class:`~repro_torch.core.executor.EngineExecutor`, and the
per-tenant :class:`~repro_torch.serving.server.TenantMux` all by construction.
"""

from typing import Protocol, runtime_checkable

import numpy as np

# The frontend<->executor contract, spelled out. ``AsyncFrontend``
# refuses (TypeError) any executor that does not conform, replacing the
# per-call ``hasattr`` probes of earlier revisions: an executor either
# offers the whole surface or none of it.
EXECUTOR_MEMBERS = ("batch_size", "program", "on_result", "on_error",
                    "submit_batch", "flush_inflight", "reset_stats",
                    "replica_counts")


@runtime_checkable
class Executor(Protocol):
    """What the :class:`AsyncFrontend` requires of a serving executor.

    ================== =====================================================
    member             contract
    ================== =====================================================
    ``batch_size``     compiled micro-batch size (frames per dispatch)
    ``program``        the compiled :class:`EngineProgram` behind the
                       executor, or ``None`` when there is no single one
                       (fakes, the per-tenant mux) — the frontend uses it
                       to reject malformed frames at submit
    ``on_result``      callback slot ``(tag, outputs)``; the frontend
                       claims it (must be ``None`` at attach) and releases
                       it at :meth:`AsyncFrontend.close`
    ``on_error``       callback slot ``(tag, exc)`` for async batch
                       failures (``None`` acceptable for executors that
                       raise synchronously from ``submit_batch``)
    ``submit_batch``   ``(frames, n_valid, tag=None)``: dispatch one
                       micro-batch; blocks on internal backpressure
    ``flush_inflight`` collect finished batches now (no-op for executors
                       whose collector thread runs continuously)
    ``reset_stats``    zero the executor's serve statistics (between
                       drains, not mid-stream)
    ``replica_counts`` exact per-replica outcome counters
                       (``list[dict]``), or ``None`` for executors that
                       are not replica pools
    ================== =====================================================
    """

    batch_size: int
    program: object
    on_result: object
    on_error: object

    def submit_batch(self, frames: np.ndarray, n_valid: int,
                     tag: object = None) -> None: ...

    def flush_inflight(self) -> None: ...

    def reset_stats(self) -> None: ...

    def replica_counts(self) -> list | None: ...


from repro_torch.serving.estimator import (ServiceTimeEstimator,  # noqa: E402
                                     window_key)
from repro_torch.serving.frontend import (DEFAULT_TENANT,  # noqa: E402
                                    AsyncFrontend, ClassStats,
                                    DeadlineExpired, FrontendStats,
                                    RequestRejected, ServedRequest,
                                    tenant_key)
from repro_torch.serving.partition import (StagePartition,  # noqa: E402
                                     partition_program, stage_devices,
                                     step_cycles)
from repro_torch.serving.pipeline_executor import (  # noqa: E402
    PipelineExecutor)
from repro_torch.serving.replica_pool import ReplicaPool  # noqa: E402
from repro_torch.serving.router import LeastWaitRouter  # noqa: E402
from repro_torch.serving.traffic import (SCENARIOS, Arrival,  # noqa: E402
                                   TrafficClass, armed_class_names,
                                   default_mix, make_scenario_schedule,
                                   make_schedule, merge_schedules,
                                   pacing_report, parse_traffic_mix,
                                   record_trace, replay, tag_tenant,
                                   trace_schedule)
from repro_torch.serving.chaos import (ChaosExecutor,  # noqa: E402
                                       FaultPlan, ReplicaKilled,
                                       StageKilled, install_stage_fault,
                                       recovery_report)
from repro_torch.serving.elastic import (ElasticController,  # noqa: E402
                                         ElasticPolicy, RescaleDecision)
from repro_torch.serving.calibrate import (default_max_wait_ms,  # noqa: E402
                                     pipeline_throughput,
                                     warmed_frontend)
from repro_torch.serving.server import (ProgramRegistry, Server,  # noqa: E402
                                  ServerConfig, TenantMux,
                                  UnknownModelError, build_server,
                                  synthetic_stream, synthetic_stream_like)

__all__ = [
    "Arrival",
    "AsyncFrontend",
    "ChaosExecutor",
    "ClassStats",
    "DEFAULT_TENANT",
    "DeadlineExpired",
    "EXECUTOR_MEMBERS",
    "ElasticController",
    "ElasticPolicy",
    "Executor",
    "FaultPlan",
    "FrontendStats",
    "LeastWaitRouter",
    "PipelineExecutor",
    "ProgramRegistry",
    "ReplicaKilled",
    "ReplicaPool",
    "RequestRejected",
    "RescaleDecision",
    "SCENARIOS",
    "ServedRequest",
    "Server",
    "ServerConfig",
    "ServiceTimeEstimator",
    "StageKilled",
    "StagePartition",
    "TenantMux",
    "TrafficClass",
    "UnknownModelError",
    "armed_class_names",
    "build_server",
    "default_max_wait_ms",
    "default_mix",
    "install_stage_fault",
    "make_scenario_schedule",
    "make_schedule",
    "merge_schedules",
    "pacing_report",
    "parse_traffic_mix",
    "partition_program",
    "pipeline_throughput",
    "record_trace",
    "recovery_report",
    "replay",
    "stage_devices",
    "step_cycles",
    "synthetic_stream",
    "synthetic_stream_like",
    "tag_tenant",
    "tenant_key",
    "trace_schedule",
    "warmed_frontend",
    "window_key",
]
