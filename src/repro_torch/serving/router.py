"""Least-estimated-wait routing across pipeline replicas.
PyTorch twin of ``repro/serving/router.py`` (pure Python: a copy with the
port's imports).

Shen et al. (PAPERS.md) raise aggregate accelerator efficiency by
splitting one monolithic design into multiple specialized processors;
the serving-plane analogue is R replicas of the compiled pipeline behind
a router. The router's job is the same pricing problem admission control
already solves for one replica, applied per replica:

    wait(r) = inflight_batches(r) * est_window(r) + est_latency(r)

where ``est_window(r)`` is replica r's busy inter-completion window (its
throughput beat — what one more queued batch costs) and ``est_latency(r)``
its dispatch->done traversal, both per-replica
:class:`~repro_torch.serving.estimator.ServiceTimeEstimator` channels under the
same key convention as the frontend (:func:`window_key`).

Placement policy, in order:

* **warm** (every replica has both channels): pick ``argmin wait(r)`` —
  straggler avoidance falls out for free, because a replica whose EWMA
  drifts up prices itself out of the draw;
* **cold** (any estimator empty): power-of-two-choices on queue depth —
  draw two distinct replicas from a seeded RNG, take the one with fewer
  batches in flight (deterministic under the seed for a single
  submitting thread). Replicas already *flagged* as stragglers (latency
  EWMA beyond ``straggler_factor`` x the fleet median) are excluded from
  the cold draw while a healthy replica exists, so a replica that went
  bad after warmup cannot win a coin toss it should lose.

Two health states sit above pricing:

* **quarantine** (dead, not slow): ``quarantine_after`` *consecutive*
  hard failures (dispatch raised, or the batch came back as an error)
  take the replica out of both the warm argmin and the cold draw — the
  straggler flag cannot cover this case because a corpse produces no
  latency observations to drift. Any completed batch clears the state.
* **probes** (the recovery path for both states): an excluded replica
  receives no traffic, so its estimator freezes and — without help — a
  quarantined corpse that came back, or a straggler whose EWMA once
  spiked, stays excluded forever. :meth:`probe_target` fixes that:
  every ``probe_every``-th call (the pool invokes it once per real
  dispatch) it nominates one idle injured replica for a *probe batch* —
  traffic the pool synthesizes and never counts against live requests.
  A probe completion re-admits a quarantined replica and feeds the
  straggler EWMA until it re-enters band; a probe failure keeps the
  quarantine (and costs no live request).

The router never touches frames — :class:`~repro_torch.serving.replica_pool.
ReplicaPool` calls :meth:`pick` before each dispatch and
:meth:`on_complete`/:meth:`on_failure` from the replicas' collector
threads, so every method is thread-safe.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.serving.estimator import ServiceTimeEstimator, window_key

# A replica whose latency EWMA exceeds this multiple of the fleet median
# is flagged a straggler: excluded from cold-start draws, and picked
# warm only when its priced wait still wins (it rarely does).
DEFAULT_STRAGGLER_FACTOR = 3.0

# Consecutive hard failures before a replica is quarantined (excluded
# from all live-traffic picks until a probe batch completes).
DEFAULT_QUARANTINE_AFTER = 3

# One probe batch per this many live dispatches while any replica is
# excluded (quarantined or flagged): the re-admission / EWMA-decay beat.
DEFAULT_PROBE_EVERY = 8


class LeastWaitRouter:
    """Place each micro-batch on the replica with the least estimated
    wait; fall back to seeded power-of-two-choices while cold.

    >>> router = LeastWaitRouter(n_replicas=2, batch_key=32)
    >>> r = router.pick()                   # registers one in-flight batch
    >>> router.on_complete(r, service_s)    # observe + release
    """

    def __init__(self, n_replicas: int, batch_key, *, seed: int = 0,
                 straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
                 alpha: float | None = None,
                 quarantine_after: int = DEFAULT_QUARANTINE_AFTER,
                 probe_every: int = DEFAULT_PROBE_EVERY):
        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas} < 1")
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor={straggler_factor} must be > 1")
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after={quarantine_after} must be >= 1")
        if probe_every < 1:
            raise ValueError(f"probe_every={probe_every} must be >= 1")
        self.n_replicas = int(n_replicas)
        self.batch_key = batch_key
        self.straggler_factor = float(straggler_factor)
        self.quarantine_after = int(quarantine_after)
        self.probe_every = int(probe_every)
        self._est_kw = {} if alpha is None else {"alpha": alpha}
        self.estimators = [ServiceTimeEstimator(**self._est_kw)
                           for _ in range(self.n_replicas)]
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._inflight = [0] * self.n_replicas
        # Per-replica anchor for the busy inter-completion window: the
        # previous completion's timestamp, valid only while the replica
        # stayed busy across the gap (same discipline as the frontend).
        self._last_done: list[float | None] = [None] * self.n_replicas
        self._consec_fails = [0] * self.n_replicas
        self._quarantined = [False] * self.n_replicas
        self._probe_tick = 0
        self._probe_rr = 0
        self.picks = [0] * self.n_replicas
        self.cold_picks = 0
        self.straggler_skips = 0
        self.probe_picks = 0
        self.quarantine_events = 0
        self.readmissions = 0

    # -- pricing -------------------------------------------------------------

    def estimated_wait_s(self, replica: int) -> float | None:
        """Priced wait for one more batch on ``replica``:
        ``inflight * window + latency``. ``None`` while either channel is
        cold (callers fall back to power-of-two-choices)."""
        est = self.estimators[replica]
        lat = est.estimate(self.batch_key)
        win = est.estimate(window_key(self.batch_key))
        if lat is None or win is None:
            return None
        with self._lock:
            inflight = self._inflight[replica]
        return inflight * win + lat

    def is_straggler(self, replica: int) -> bool:
        """True when ``replica``'s latency EWMA has drifted beyond
        ``straggler_factor`` x the fleet median (needs >= 2 replicas with
        latency estimates to define a fleet)."""
        lats = [e.estimate(self.batch_key) for e in self.estimators]
        known = sorted(v for v in lats if v is not None)
        mine = lats[replica]
        if mine is None or len(known) < 2:
            return False
        return mine > self.straggler_factor * float(np.median(known))

    def is_quarantined(self, replica: int) -> bool:
        """True while ``replica`` is excluded for repeated hard failures
        (``quarantine_after`` consecutive). Cleared by any completion —
        in practice a probe batch, since live traffic stops arriving."""
        with self._lock:
            return self._quarantined[replica]

    # -- placement -----------------------------------------------------------

    def pick(self) -> int:
        """Choose a replica for the next micro-batch and register the
        dispatch (one more in flight). Release with :meth:`on_complete`
        or :meth:`on_failure`."""
        if self.n_replicas == 1:
            with self._lock:
                self._inflight[0] += 1
                self.picks[0] += 1
            return 0
        waits = [self.estimated_wait_s(r) for r in range(self.n_replicas)]
        with self._lock:
            # Quarantined replicas sit out both paths (dead beats slow:
            # their frozen estimator would otherwise keep pricing them
            # attractively). If *everything* is quarantined, serve
            # anyway — failing fast beats deadlocking the pool.
            alive = [r for r in range(self.n_replicas)
                     if not self._quarantined[r]]
            if not alive:
                alive = list(range(self.n_replicas))
            if any(waits[i] is None for i in alive):
                r = self._cold_pick_locked(alive)
                self.cold_picks += 1
            else:
                # Ties (fresh symmetric fleet) break toward the shorter
                # queue, then the lowest index — deterministic.
                r = min(alive,
                        key=lambda i: (waits[i], self._inflight[i], i))
            self._inflight[r] += 1
            self.picks[r] += 1
        return r

    def _cold_pick_locked(self, alive: list[int]) -> int:
        """Power-of-two-choices on queue depth, from the seeded RNG.
        Flagged stragglers sit out the draw while a healthy replica
        exists."""
        pool = [r for r in alive if not self.is_straggler(r)]
        if len(pool) < len(alive):
            self.straggler_skips += len(alive) - len(pool)
        if not pool:
            pool = list(alive)
        if len(pool) == 1:
            return pool[0]
        a, b = self._rng.choice(len(pool), size=2, replace=False)
        a, b = pool[int(a)], pool[int(b)]
        if self._inflight[b] < self._inflight[a]:
            return b
        return a

    def probe_target(self) -> int | None:
        """Nominate one excluded replica for a probe batch, or ``None``.

        The pool calls this once per live dispatch; every
        ``probe_every``-th call while any replica is excluded
        (quarantined, or flagged straggler) returns one such replica —
        round-robin across the injured set — and registers the dispatch.
        Only *idle* replicas are nominated: probing a replica with work
        still in flight could block the submitting thread on its full
        stage queue. The probe's :meth:`on_complete` is what re-admits a
        quarantined replica and decays a straggler's frozen EWMA back
        into band; its :meth:`on_failure` keeps the quarantine."""
        if self.n_replicas == 1:
            return None
        flagged = [r for r in range(self.n_replicas) if self.is_straggler(r)]
        with self._lock:
            injured = [r for r in range(self.n_replicas)
                       if (self._quarantined[r] or r in flagged)
                       and self._inflight[r] == 0]
            if not injured or injured == list(range(self.n_replicas)):
                return None
            self._probe_tick += 1
            if self._probe_tick % self.probe_every:
                return None
            r = injured[self._probe_rr % len(injured)]
            self._probe_rr += 1
            self._inflight[r] += 1
            self.probe_picks += 1
        return r

    # -- feedback ------------------------------------------------------------

    def on_complete(self, replica: int, service_s: float,
                    now: float | None = None) -> None:
        """One batch finished on ``replica`` after ``service_s`` seconds:
        fold the traversal latency, fold the busy inter-completion window
        when the replica stayed busy across the gap, release the
        in-flight slot."""
        if now is None:
            now = time.perf_counter()
        est = self.estimators[replica]
        est.observe(self.batch_key, service_s)
        with self._lock:
            last = self._last_done[replica]
            busy = self._inflight[replica] >= 1
            if last is not None and busy:
                window = now - last
                if window > 0:
                    est.observe(window_key(self.batch_key), window)
            self._inflight[replica] = max(0, self._inflight[replica] - 1)
            # The window anchor survives only while more work is queued
            # behind this completion; an idle gap is not a service time.
            self._last_done[replica] = (
                now if self._inflight[replica] > 0 else None)
            # A completed batch is proof of life: clear the failure
            # streak, and re-admit a quarantined replica (probe success).
            self._consec_fails[replica] = 0
            if self._quarantined[replica]:
                self._quarantined[replica] = False
                self.readmissions += 1

    def on_failure(self, replica: int) -> None:
        """A dispatched batch failed (or never reached the replica):
        release the slot, drop the window anchor — the failure gap is
        not a throughput beat — and quarantine the replica once the
        consecutive-failure streak reaches ``quarantine_after``."""
        with self._lock:
            self._inflight[replica] = max(0, self._inflight[replica] - 1)
            self._last_done[replica] = None
            self._consec_fails[replica] += 1
            if (not self._quarantined[replica]
                    and self._consec_fails[replica] >= self.quarantine_after):
                self._quarantined[replica] = True
                self.quarantine_events += 1

    # -- calibration / reporting ---------------------------------------------

    def warm_start(self, window_s: float, latency_s: float) -> None:
        """Seed every replica's two channels from the calibration pass
        (per-replica window = R x the fleet window under round-robin;
        the caller does that arithmetic). Measurements outrank this."""
        for est in self.estimators:
            est.warm_start(window_key(self.batch_key), window_s)
            est.warm_start(self.batch_key, latency_s)

    def reset_pricing(self) -> None:
        """Forget every replica's *measured* verdicts — estimator
        channels, window anchors, failure streaks, quarantine flags —
        so the next :meth:`warm_start` re-seeds the fleet level.

        This is the replay-boundary counterpart of the frontend's
        fresh-estimator-per-replay rule, and it exists because
        :meth:`warm_start` alone cannot undo a starvation spiral: a
        replica starved during a saturated calibration window keeps a
        stale high latency EWMA, the warm argmin then routes nothing to
        it, and — since a merely-mispriced replica is neither
        quarantined nor (with R=2, where its own EWMA drags the fleet
        median) straggler-flagged — no probe ever re-prices it. The
        cumulative telemetry counters (picks, quarantine_events, ...)
        and in-flight accounting survive; only pricing state resets."""
        with self._lock:
            self.estimators = [ServiceTimeEstimator(**self._est_kw)
                               for _ in range(self.n_replicas)]
            self._last_done = [None] * self.n_replicas
            self._consec_fails = [0] * self.n_replicas
            self._quarantined = [False] * self.n_replicas

    def inflight(self, replica: int) -> int:
        with self._lock:
            return self._inflight[replica]

    def snapshot(self) -> dict:
        """JSON-ready router state: per-replica picks, in-flight depth,
        estimator channels, straggler/quarantine flags, and the
        cold-start/skip/probe counters."""
        with self._lock:
            inflight = list(self._inflight)
            picks = list(self.picks)
            cold, skips = self.cold_picks, self.straggler_skips
            probes = self.probe_picks
            quarantines, readmits = self.quarantine_events, self.readmissions
            quarantined = list(self._quarantined)
            fails = list(self._consec_fails)
        return {
            "n_replicas": self.n_replicas,
            "cold_picks": cold,
            "straggler_skips": skips,
            "probe_picks": probes,
            "quarantine_events": quarantines,
            "readmissions": readmits,
            "replicas": [
                {"replica": r, "picks": picks[r], "inflight": inflight[r],
                 "straggler": self.is_straggler(r),
                 "quarantined": quarantined[r],
                 "consecutive_failures": fails[r],
                 "estimator": self.estimators[r].snapshot()}
                for r in range(self.n_replicas)],
        }
