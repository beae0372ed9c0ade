"""Online per-batch-shape EWMA service-time estimator.
PyTorch twin of ``repro/serving/estimator.py`` (pure Python: a copy with the
port's imports).

The paper's Algorithm 1 balances engine resources against the *measured*
cost of each layer; the serving control plane needs the same discipline
at micro-batch granularity. Both adaptive decisions the frontend makes —
when to expedite a flush and whether to admit a deadline-armed request —
are only as good as their estimate of how long the executor takes to
serve one micro-batch. A fixed guess (the static 20% deadline-budget guard)
is wrong in both directions: too early on a fast backend (padded partial
batches), too late on a slow one (dead-on-arrival dispatches).

:class:`ServiceTimeEstimator` keeps one exponentially-weighted moving
average per *batch shape* (the compiled micro-batch size — different
frontends over differently-shaped executors do not pollute each other's
estimate), fed with each batch's measured compute phase
(``t_dispatched -> t_done``). It is:

* **thread-safe** — ``observe`` runs on the executor's collector thread
  while ``estimate`` runs on every submitting thread and the batcher;
* **warm-startable** — the serve paths seed it with the calibration
  pass's measured batch window (``batch / steady_fps``) so the very
  first open-loop request is priced from a measurement, not a guess;
* **honest about ignorance** — ``estimate`` returns ``None`` until it
  has either a warm start or an observation, and callers fall back to
  the static guard, so an estimator-less frontend behaves exactly
  as before.
"""

from __future__ import annotations

import dataclasses
import threading

# Fast enough to track a backend warming up (kernel builds, CPU frequency)
# within ~10 batches, slow enough that one scheduler hiccup does not
# whipsaw the flush guard.
DEFAULT_ALPHA = 0.3


def window_key(shape) -> tuple:
    """The estimator key for ``shape``'s *completion window* channel —
    the busy inter-completion gap (throughput beat), as opposed to the
    bare ``shape`` key holding the dispatch->done traversal latency.
    One convention, shared by the frontend (which observes both) and
    the serve paths (which warm-start both from the calibration pass:
    latency at ``stages x window``, window at ``batch/steady_fps``)."""
    return (shape, "window")


@dataclasses.dataclass
class _ShapeEstimate:
    value: float            # current EWMA, seconds per micro-batch
    n_observed: int = 0     # real observations (warm start not counted)
    warm: bool = False      # seeded from a calibration measurement


class ServiceTimeEstimator:
    """EWMA of per-micro-batch service time, keyed by batch shape.

    >>> est = ServiceTimeEstimator()
    >>> est.warm_start(32, 0.045)        # calibration: batch/steady_fps
    >>> est.estimate(32)
    0.045
    >>> est.observe(32, 0.052)           # each completed batch updates
    >>> est.estimate(16) is None         # shapes are isolated
    True

    ``shape`` is any hashable key; the frontend uses its compiled
    micro-batch size. All methods are safe to call concurrently.
    """

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha={alpha} not in (0, 1]")
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._shapes: dict[object, _ShapeEstimate] = {}

    def warm_start(self, shape, seconds: float) -> None:
        """Seed ``shape``'s estimate with a measured calibration value
        (e.g. one batch window of the throughput phase). A later warm
        start overwrites only while no real batch has been observed —
        measurements outrank calibration."""
        if seconds <= 0:
            raise ValueError(f"warm_start seconds={seconds} not > 0")
        with self._lock:
            cur = self._shapes.get(shape)
            if cur is None or cur.n_observed == 0:
                self._shapes[shape] = _ShapeEstimate(float(seconds),
                                                     warm=True)

    def warm_start_channels(self, shape, window_s: float, *,
                            stages: int = 1, replicas: int = 1) -> None:
        """Seed *both* admission channels for ``shape`` from one K>1
        calibration throughput measurement: the busy-completion-window
        channel at the measured fleet batch window
        (``batch / steady_fps``) and the latency channel at
        ``stages * replicas * window`` — one micro-batch's traversal of
        a K-stage pipeline is K windows at steady state, and routing
        over R replicas multiplies the per-batch beat each replica
        sustains by R. Admission can price a deadline before any two
        completions have ever overlapped. Measurements outrank this
        (same rule as :meth:`warm_start`)."""
        if stages < 1 or replicas < 1:
            raise ValueError(
                f"stages={stages}, replicas={replicas} must be >= 1")
        self.warm_start(window_key(shape), window_s)
        self.warm_start(shape, stages * replicas * window_s)

    def rewarm(self, shape, seconds: float) -> None:
        """Forcibly re-seed ``shape``'s estimate after a topology change.

        Unlike :meth:`warm_start`, this *overwrites* a channel that has
        real observations: when the executor underneath a frontend is
        swapped (``Server.rescale``), the old plan's measured EWMA
        describes a pipeline that no longer exists, and "measurements
        outrank calibration" would pin admission to stale prices. The
        observation count resets to zero so the swapped-in plan's own
        batches take over at full EWMA weight."""
        if seconds <= 0:
            raise ValueError(f"rewarm seconds={seconds} not > 0")
        with self._lock:
            self._shapes[shape] = _ShapeEstimate(float(seconds), warm=True)

    def rewarm_channels(self, shape, window_s: float, *,
                        stages: int = 1, replicas: int = 1) -> None:
        """Forced counterpart of :meth:`warm_start_channels` for a live
        rescale: re-seed both admission channels for ``shape`` from the
        *old* plan's measured window scaled to the new topology (the
        caller computes ``window_s``; the latency channel gets the same
        ``stages * replicas * window`` traversal formula). Existing
        observations are discarded — they priced the old partition."""
        if stages < 1 or replicas < 1:
            raise ValueError(
                f"stages={stages}, replicas={replicas} must be >= 1")
        self.rewarm(window_key(shape), window_s)
        self.rewarm(shape, stages * replicas * window_s)

    def observe(self, shape, seconds: float) -> None:
        """Fold one measured batch service time into ``shape``'s EWMA.
        Non-positive samples (clock skew) are dropped rather than
        poisoning the average."""
        if seconds <= 0:
            return
        with self._lock:
            cur = self._shapes.get(shape)
            if cur is None:
                self._shapes[shape] = _ShapeEstimate(float(seconds),
                                                     n_observed=1)
            else:
                cur.value += self.alpha * (float(seconds) - cur.value)
                cur.n_observed += 1

    def estimate(self, shape) -> float | None:
        """Current estimate (seconds per micro-batch) for ``shape``, or
        ``None`` when nothing — warm start or observation — is known."""
        with self._lock:
            cur = self._shapes.get(shape)
            return None if cur is None else cur.value

    def n_observed(self, shape) -> int:
        """Real observations folded into ``shape`` (excludes the warm
        start)."""
        with self._lock:
            cur = self._shapes.get(shape)
            return 0 if cur is None else cur.n_observed

    def snapshot(self) -> dict:
        """JSON-ready state per shape — the benches record it so an
        artifact documents the estimate its control decisions used."""
        with self._lock:
            return {str(shape): {"est_ms": round(cur.value * 1e3, 3),
                                 "n_observed": cur.n_observed,
                                 "warm_started": cur.warm}
                    for shape, cur in self._shapes.items()}
