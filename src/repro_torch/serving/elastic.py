"""Elastic runtime: the measure -> decide -> act loop over a live server.
PyTorch twin of ``repro/serving/elastic.py`` (pure Python: a copy with the
port's imports).

The paper's "flexible pipelining" balances the engine chain *once*,
offline (Algorithm 1); the serving stack around it — the per-shape EWMA
estimator, the knee sweep, SLO miss accounting, router quarantine —
only *measures* how well that one-shot balance is holding up under the
traffic actually arriving. :class:`ElasticController` closes the loop:
it watches the signals the stack already produces, and when they cross
hysteresis thresholds it compiles a candidate plan in the background
and swaps it in atomically between micro-batches.

The FPGA correspondence (DESIGN.md section 10): a live rescale is the
serving-plane form of partial reconfiguration — regenerate the
"bitstream" (build the new stage runners / replica fleet) for the new
resource budget while the old configuration keeps serving, then flip at
a frame boundary. Int8 stage boundaries make the handoff stateless: a
drained pipeline holds nothing but weights, so nothing needs migrating.

Signals (all already produced by the stack, read as deltas per
observation window):

* **armed-miss rate** — expired + refused-at-admission + served-late
  over deadline-armed submissions, from :class:`~repro_torch.serving.frontend
  .FrontendStats` (the same accounting the knee sweep calls a miss);
* **estimator drift** — the live latency EWMA against the value the
  channel was (re)warmed with: sustained drift means the plan the
  admission prices were calibrated for no longer describes the
  executor;
* **router quarantine events** — the cumulative
  ``LeastWaitRouter.quarantine_events`` counter: a replica died
  (a ``ChaosExecutor``-style kill), so the fleet the estimator was
  warmed for is smaller than the fleet admission thinks it has.

Decision rules (:meth:`ElasticController.decide` is pure — given an
observed window it returns the same verdict every time, so the policy
is unit-testable without a server):

* scale **out** (R+1) when the armed-miss rate has exceeded
  ``miss_high`` for ``sustain`` consecutive windows, or the latency
  EWMA has drifted past ``drift_high`` x its warm seed for ``sustain``
  windows, or any quarantine event arrived (a kill triggers rescale
  immediately);
* scale **in** (R-1) when the miss rate has stayed under ``miss_low``
  *and* drift under ``drift_low`` for ``sustain`` windows (both bands,
  so a quiet-but-drifting fleet is never shrunk);
* do nothing inside ``cooldown_s`` of the last rescale, outside the
  ``[min_replicas, max_replicas]`` bounds, or on windows with fewer
  than ``min_window_requests`` armed submissions (a 3-request window
  is noise, not a signal).

The act step delegates to :meth:`repro_torch.serving.server.Server.rescale`,
which builds and warms the new executor while the old one keeps
serving, then performs the drain -> swap -> resume through
:meth:`~repro_torch.serving.frontend.AsyncFrontend.swap_executor` — no
in-flight request is dropped or reordered, and submits are never
rejected during the swap (lanes keep accepting; backpressure only).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch.serving.frontend import tenant_key

# One controller default set, shared by ServerConfig.auto_rescale and
# the knee bench's rescale ramp (overridable per field).
DEFAULT_MISS_HIGH = 0.05
DEFAULT_MISS_LOW = 0.005
DEFAULT_DRIFT_HIGH = 2.0
DEFAULT_DRIFT_LOW = 1.3
DEFAULT_SUSTAIN = 2
DEFAULT_COOLDOWN_S = 2.0


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Hysteresis thresholds for the measure -> decide -> act loop.

    ``miss_high``/``miss_low`` bound the armed-miss-rate band,
    ``drift_high``/``drift_low`` the latency-EWMA-over-warm-seed band;
    crossing the high edge for ``sustain`` consecutive windows scales
    out, staying under *both* low edges for ``sustain`` windows scales
    in — the gap between the edges is the hysteresis that keeps the
    controller from oscillating on a load sitting near one threshold.
    ``cooldown_s`` rate-limits rescales (a swap invalidates the very
    signals the next decision would read, so the controller must wait
    for post-swap windows); ``min_window_requests`` ignores windows
    with too few armed submissions to call a rate."""

    miss_high: float = DEFAULT_MISS_HIGH
    miss_low: float = DEFAULT_MISS_LOW
    drift_high: float = DEFAULT_DRIFT_HIGH
    drift_low: float = DEFAULT_DRIFT_LOW
    sustain: int = DEFAULT_SUSTAIN
    cooldown_s: float = DEFAULT_COOLDOWN_S
    min_replicas: int = 1
    max_replicas: int = 4
    min_window_requests: int = 8
    quarantine_triggers: bool = True

    def __post_init__(self):
        if not 0.0 <= self.miss_low <= self.miss_high <= 1.0:
            raise ValueError(
                f"need 0 <= miss_low ({self.miss_low}) <= miss_high "
                f"({self.miss_high}) <= 1")
        if not 1.0 <= self.drift_low <= self.drift_high:
            raise ValueError(
                f"need 1 <= drift_low ({self.drift_low}) <= drift_high "
                f"({self.drift_high})")
        if self.sustain < 1:
            raise ValueError(f"sustain={self.sustain} must be >= 1")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RescaleDecision:
    """One verdict of :meth:`ElasticController.decide`: the action
    (``scale_out`` / ``scale_in``), the target replica count, and the
    signal values that justified it (recorded into the rescale event so
    artifacts explain every reconfiguration)."""

    action: str
    replicas: int
    reason: str
    signals: dict


class ElasticController:
    """Watch one frontend's signals; rescale its server under drift.

    >>> ctrl = ElasticController(server, frontend)
    >>> ctrl.start(interval_s=0.25)     # background observe/decide/act
    >>> ...                             # traffic crosses the knee
    >>> ctrl.stop()
    >>> ctrl.history                    # JSON-ready rescale events

    ``step()`` runs one synchronous observe -> decide -> act round for
    callers that drive the cadence themselves (the stress tests do).
    The controller only ever *adds* work on its own thread — the swap
    itself happens between micro-batches via
    :meth:`AsyncFrontend.swap_executor`, so serving never stops.
    """

    def __init__(self, server, frontend, *, model: str | None = None,
                 policy: ElasticPolicy | None = None):
        self.server = server
        self.frontend = frontend
        self.policy = policy if policy is not None else ElasticPolicy()
        if model is None:
            names = server.model_names
            if len(names) != 1:
                raise ValueError(
                    "a multi-model server needs an explicit model= "
                    f"(registered: {', '.join(names)})")
            model = names[0]
        self.model = model
        self.history: list[dict] = []
        self._lock = threading.Lock()
        self._last_stats = frontend.stats_snapshot()
        self._last_quarantines = self._quarantine_events()
        self._ref_latency: float | None = None
        self._capture_reference()
        self._over = 0          # consecutive windows over a high edge
        self._under = 0         # consecutive windows under both low edges
        self._last_rescale_t: float | None = None
        self._busy = False      # an act (background compile + swap) is
        self._thread: threading.Thread | None = None   # in flight
        self._stop = threading.Event()

    @property
    def busy(self) -> bool:
        """True while an act is in flight — the candidate plan is
        being built in the background or the swap is mid-drain. Load
        generators (``serve_knee_rescale``'s ramp) poll this to keep
        traffic flowing until the event lands in :attr:`history`."""
        return self._busy

    # -- signal plumbing -----------------------------------------------------

    def _tenant(self) -> str:
        return self.server._tenant_of(self.model)

    def _quarantine_events(self) -> int:
        router = getattr(self.server.runtime(self.model).executor,
                         "router", None)
        if router is None:
            return 0
        return int(router.snapshot()["quarantine_events"])

    def _lat_key(self):
        return tenant_key(self._tenant(), self.frontend.batch_size)

    def _capture_reference(self) -> None:
        """Pin the current latency estimate as the drift reference —
        at construction and after every swap (``rewarm_channels`` has
        just re-seeded the channel from the new plan's calibration), so
        drift always measures the live EWMA against the value the
        *current* plan was priced from."""
        self._ref_latency = self.frontend.estimator.estimate(self._lat_key())

    def _drift(self) -> float | None:
        """Live latency EWMA over the pinned reference for the watched
        tenant's batch-shape channel; None until the channel has both a
        reference and a real observation."""
        est = self.frontend.estimator
        key = self._lat_key()
        cur = est.estimate(key)
        if (cur is None or self._ref_latency is None
                or self._ref_latency <= 0 or est.n_observed(key) == 0):
            return None
        return cur / self._ref_latency

    def observe(self) -> dict:
        """One observation window: deltas of the frontend's armed
        outcome counters since the previous call, the current estimator
        drift ratio, and new router quarantine events. JSON-ready."""
        snap = self.frontend.stats_snapshot()
        prev = self._last_stats
        self._last_stats = snap

        def _armed(st):
            sub = miss = 0
            for cs in st.classes.values():
                if not cs.armed:
                    continue
                sub += cs.submitted
                miss += (cs.expired + cs.rejected + cs.rejected_wait
                         + cs.late)
            return sub, miss

        sub1, miss1 = _armed(snap)
        sub0, miss0 = _armed(prev)
        d_sub, d_miss = sub1 - sub0, miss1 - miss0
        quarantines = self._quarantine_events()
        d_quar = quarantines - self._last_quarantines
        self._last_quarantines = quarantines
        ex = self.server.runtime(self.model).executor
        return {
            "armed_submitted": d_sub,
            "armed_missed": d_miss,
            "armed_miss_rate": (round(d_miss / d_sub, 4) if d_sub else None),
            "drift": (None if (d := self._drift()) is None
                      else round(d, 3)),
            "quarantine_events": d_quar,
            "replicas": getattr(ex, "n_replicas", 1),
            "stages": (ex.partition.n_stages
                       if ex.partition is not None else 1),
        }

    # -- decision (pure) -----------------------------------------------------

    def decide(self, signals: dict) -> RescaleDecision | None:
        """Apply the hysteresis rules to one observed window. Mutates
        only the sustain counters; performs no I/O, touches no executor
        — the policy logic is testable with hand-built signal dicts."""
        p = self.policy
        replicas = int(signals.get("replicas", 1))
        now = time.perf_counter()
        if (self._last_rescale_t is not None
                and now - self._last_rescale_t < p.cooldown_s):
            return None
        # A replica death is not a trend — act on the first event.
        if p.quarantine_triggers and signals.get("quarantine_events", 0) > 0:
            self._over = self._under = 0
            if replicas < p.max_replicas:
                return RescaleDecision(
                    action="scale_out", replicas=replicas + 1,
                    reason="replica quarantined", signals=dict(signals))
            return None
        miss = signals.get("armed_miss_rate")
        drift = signals.get("drift")
        n = signals.get("armed_submitted", 0)
        if miss is None or n < p.min_window_requests:
            # Too quiet to call a rate; trends neither build nor decay.
            return None
        over = miss >= p.miss_high or (drift is not None
                                       and drift >= p.drift_high)
        under = miss <= p.miss_low and (drift is None
                                        or drift <= p.drift_low)
        self._over = self._over + 1 if over else 0
        self._under = self._under + 1 if under else 0
        if self._over >= p.sustain and replicas < p.max_replicas:
            self._over = self._under = 0
            why = (f"armed miss {miss:.2%} >= {p.miss_high:.2%}"
                   if miss >= p.miss_high else
                   f"latency drift {drift:.2f}x >= {p.drift_high:.2f}x")
            return RescaleDecision(
                action="scale_out", replicas=replicas + 1,
                reason=f"{why} for {p.sustain} windows",
                signals=dict(signals))
        if self._under >= p.sustain and replicas > p.min_replicas:
            self._over = self._under = 0
            return RescaleDecision(
                action="scale_in", replicas=replicas - 1,
                reason=(f"armed miss {miss:.2%} <= {p.miss_low:.2%} and "
                        f"no drift for {p.sustain} windows"),
                signals=dict(signals))
        return None

    # -- act -----------------------------------------------------------------

    def step(self) -> dict | None:
        """One synchronous observe -> decide -> act round. Returns the
        JSON-ready rescale event when a reconfiguration happened, else
        None. Thread-safe (the background loop and a caller-driven
        step never interleave mid-round)."""
        with self._lock:
            if self.frontend._closing.is_set():
                return None
            signals = self.observe()
            decision = self.decide(signals)
            if decision is None:
                return None
            t0 = time.perf_counter()
            self._busy = True
            try:
                event = self.server.rescale(self.model,
                                            replicas=decision.replicas)
            finally:
                self._busy = False
            self._last_rescale_t = time.perf_counter()
            event.update({
                "action": decision.action,
                "reason": decision.reason,
                "signals": decision.signals,
                "total_s": round(self._last_rescale_t - t0, 3),
            })
            # The swap re-baselined the estimator and replica counters;
            # stale sustain counts would double-trigger on old evidence.
            self._over = self._under = 0
            self._last_stats = self.frontend.stats_snapshot()
            self._last_quarantines = self._quarantine_events()
            self._capture_reference()
            self.history.append(event)
            return event

    # -- background loop -----------------------------------------------------

    def start(self, interval_s: float = 0.25) -> None:
        """Run :meth:`step` every ``interval_s`` on a daemon thread
        until :meth:`stop` (idempotent while running)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(timeout=interval_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001 - the loop must survive
                    # A failed rescale (e.g. drain timeout) leaves the
                    # old executor serving; the next window retries.
                    continue

        self._thread = threading.Thread(target=_loop,
                                        name="elastic-controller",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the background loop (joins the thread; idempotent)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    def __enter__(self) -> "ElasticController":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
