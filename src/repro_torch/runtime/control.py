"""Self-healing control plane: failure detection, supervised restart,
credit-based backpressure and the autonomous elastic scaling loop
(ROADMAP item 4 — the paper's premise is an *always-on* pipeline that
keeps reports fresh through load spikes and worker churn without a
human in the loop).

One ``ControlPlane`` thread runs two cadences against a live
``ConcurrentCluster``:

* **Supervision** (every ``tick_s``): each worker's stage loops publish
  monotonic heartbeats (``WorkerRuntime.beat``) — a stage that stops
  beating past ``heartbeat_deadline_s`` makes its worker *suspect*. A
  suspect gets one in-band control ping (a ``_Ping`` on the worker's
  control queue, acked by the ingest loop); if the heartbeats are still
  stale after ``ping_grace_s`` the worker is *confirmed* failed — this
  catches crashes (a dead stage thread never beats again) AND hangs /
  stragglers (a wedged thread beats never, a straggler beats late),
  which ``fail_workers()`` by itself cannot. Confirmation drives the
  existing revoke/quiesce/transfer/grant machinery through the forced
  path (``ConcurrentCluster.replace_worker`` / ``evict_workers``): the
  broker fences the evicted consumer group so a zombie thread that
  later wakes cannot move offsets, and the replacement re-hydrates
  through the same substrate recovery uses (compacted-topic cache
  dump + watermarks via the grant path, adopted replicated buffers).

* **Policy** (every ``policy_interval_s``): the controller samples
  ``health()`` — freshness percentiles, backlog, commit lag, per-worker
  load — applies hysteresis (K consecutive out-of-band samples) and a
  cooldown between actions, then autonomously calls ``scale_to`` /
  ``repartition``. Every executed decision is traced as a
  ``control.decide`` span and crosses the ``control.decide`` fault seam
  so drills can kill the controller mid-decision.

Supervised restart: a confirmed-failed worker is replaced with
exponential backoff + deterministic jitter; ``restart.pre_hydrate``
trips before each attempt so drills can fail restarts repeatedly; after
``max_consecutive_restarts`` consecutive failures a circuit breaker
opens (no more restarts until ``reset_breaker()``), and the confirmed
worker is still evicted so the survivors keep the stream alive in
degraded mode — serving keeps answering from the last epoch with its
honest staleness stamps.

Credit-based backpressure lives in ``CreditLedger`` (one per worker
runtime): ingest *takes* credits before a fetch (never blocking — a
zero grant just skips the fetch, so the ledger cannot deadlock by
construction) and the load stage *refunds* at commit/retire time. A
stalled downstream stops refunding, the ledger drains, ingest stops
fetching and the CDC extraction loop backs off — explicit flow control
end to end, replacing the implicit bounded-queue coupling.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Dict, List, Optional

from repro_torch.durability.faults import (CONTROL_DECIDE, RESTART_PRE_HYDRATE,
                                     InjectedCrash)


class QuiesceTimeout(RuntimeError):
    """A coordinator deadline expired: a quiesce, revoke/grant/reroute
    ack, or worker join did not complete in time. Typed so callers can
    distinguish a wedged worker from a programming error."""


class QuiesceTimeoutWarning(UserWarning):
    """Emitted when ``WorkerRuntime.join`` returns with stage threads
    still alive — the caller's stop is complete but a wedged thread
    remains (counted in ``worker.join_timeouts``)."""


class CreditLedger:
    """Per-worker flow-control credits, denominated in records.

    Invariants (asserted by tests):
    * ``available + outstanding == capacity`` at every instant;
    * ``spent - refunded == outstanding`` (conservation);
    * ``take`` never blocks and never grants more than ``available``,
      so no schedule of stalls can deadlock the ledger — a starved
      ingest simply idles until the load stage refunds.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.available = int(capacity)
        self.spent = 0
        self.refunded = 0
        self._lock = threading.Lock()

    def take(self, upto: int) -> int:
        """Grant up to ``upto`` credits (possibly 0). Non-blocking."""
        if upto <= 0:
            return 0
        with self._lock:
            grant = min(int(upto), self.available)
            self.available -= grant
            self.spent += grant
            return grant

    def refund(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.refunded += int(n)
            self.available = min(self.capacity, self.available + int(n))

    @property
    def outstanding(self) -> int:
        return self.capacity - self.available

    def exhausted(self) -> bool:
        return self.available <= 0


@dataclasses.dataclass
class _Ping:
    """Supervisor -> worker liveness probe, applied (and acked) by the
    ingest loop at its control-drain point like every other control
    message."""
    kind: str = "ping"
    ack: threading.Event = dataclasses.field(default_factory=threading.Event)


@dataclasses.dataclass
class ControlConfig:
    """Tunables for the control plane. Defaults are conservative enough
    for a cold card (the first CUDA launch builds the kernels with nvcc
    for seconds); tests on the CPU tighten them to keep drills
    sub-second."""
    tick_s: float = 0.05                 # supervision cadence
    # --- failure detection
    heartbeat_deadline_s: float = 2.0    # stage silence before suspect
    ping_grace_s: float = 0.5            # suspect -> confirmed window
    warmup_s: float = 3.0                # post-start grace (cold JIT)
    # --- supervised restart
    restart: bool = True
    restart_backoff_s: float = 0.25      # base of the exponential backoff
    restart_backoff_max_s: float = 5.0
    restart_jitter_s: float = 0.1        # deterministic (crc32) jitter span
    max_consecutive_restarts: int = 3    # breaker opens after this many
    # --- scaling policy
    scaling: bool = True
    policy_interval_s: float = 0.25      # health() sampling cadence
    hysteresis_samples: int = 3          # consecutive out-of-band samples
    cooldown_s: float = 2.0              # min seconds between actions
    min_workers: int = 1
    max_workers: int = 8
    backlog_high_per_worker: int = 2000  # scale up above this
    backlog_low_per_worker: int = 100    # scale down below this
    scale_down: bool = True              # allow autonomous scale-down
    scale_down_hysteresis_mult: int = 4  # extra hysteresis for shrinking
    repartition: bool = True
    imbalance_threshold: float = 1.75    # max/mean per-worker lag ratio
    imbalance_min_backlog: int = 500     # ignore imbalance of a tiny lag
    evict_lock_timeout_s: float = 1.0    # forced-eviction commit-lock wait
    evict_join_timeout_s: float = 2.0    # forced-eviction thread-join wait


class ControlPlane:
    """Supervisor + controller thread for one ``ConcurrentCluster``.

    Attach via ``ConcurrentCluster(pipe, control=ControlConfig(...))``
    (or ``control=True`` for defaults); the cluster starts/stops it with
    its own lifecycle. All state is owned by the single control thread;
    snapshot readers see GIL-atomic field reads only.
    """

    def __init__(self, cluster, cfg: Optional[ControlConfig] = None):
        self.cluster = cluster
        self.cfg = cfg or ControlConfig()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.crashed = False             # an InjectedCrash killed the loop
        # supervision state (control-thread-owned)
        self._suspects: Dict[str, Dict] = {}
        self.suspect_names: List[str] = []   # snapshot-readable copy
        # restart/backoff state
        self.consecutive_restart_failures = 0
        self.restart_attempts = 0
        self.breaker_open = False
        self._next_restart_at = 0.0
        self.last_backoff_s = 0.0
        # policy state
        self._high_streak = 0
        self._low_streak = 0
        self._imb_streak = 0
        self._cooldown_until = 0.0
        self._last_policy_at = 0.0
        # decision log (bounded) + last-eviction marker for drills
        self.decisions: List[Dict] = []
        self.last_eviction: Optional[Dict] = None
        self.evictions = 0
        self.restarts = 0
        self.restart_failures = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.repartitions = 0
        shard = cluster.pipe.metrics.shard("control")
        self._c_pings = shard.counter("control.pings")
        self._c_evictions = shard.counter("control.evictions")
        self._c_restarts = shard.counter("control.restarts")
        self._c_restart_failures = shard.counter("control.restart_failures")
        self._c_decisions = shard.counter("control.decisions")
        self._c_scale_ups = shard.counter("control.scale_ups")
        self._c_scale_downs = shard.counter("control.scale_downs")
        self._c_repartitions = shard.counter("control.repartitions")
        self._c_errors = shard.counter("control.errors")
        shard.gauge_fn("breaker_open", lambda: int(self.breaker_open))
        shard.gauge_fn("suspects", lambda: len(self.suspect_names))
        shard.gauge_fn("degraded", lambda: int(self.degraded()))

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="control.plane")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _run(self) -> None:
        try:
            while not self._stop.wait(self.cfg.tick_s):
                self._tick(time.perf_counter())
        except InjectedCrash:
            # control.decide drill: the controller dies mid-decision.
            # The data plane is unaffected — decisions are executed
            # atomically through coordinator actions, so a crash before
            # the action leaves the cluster exactly as it was.
            self.crashed = True

    # ------------------------------------------------------------ degradation
    def degraded(self) -> bool:
        """Serving continues from the last epoch (honest staleness
        stamps) but the pipeline is impaired: a breaker is open, a
        worker is suspect/confirmed, or some live ledger is exhausted
        (downstream stall throttling extraction)."""
        if self.breaker_open or self.suspect_names:
            return True
        for rt in list(self.cluster.runtimes.values()):
            if not rt.dead and rt.credits.exhausted():
                return True
        return False

    # ------------------------------------------------------------ supervision
    def _tick(self, now: float) -> None:
        try:
            self._supervise(now)
        except InjectedCrash:
            raise
        except Exception:
            self._c_errors.inc()
        if self.cfg.scaling and now - self._last_policy_at \
                >= self.cfg.policy_interval_s:
            self._last_policy_at = now
            try:
                self._policy(now)
            except InjectedCrash:
                raise
            except Exception:
                self._c_errors.inc()

    def _supervise(self, now: float) -> None:
        cfg = self.cfg
        for name, rt in list(self.cluster.runtimes.items()):
            if rt.dead or not rt.hb:
                self._suspects.pop(name, None)
                continue
            if rt.started_at is None or now - rt.started_at < cfg.warmup_s:
                continue
            stale = [s for s, t in rt.hb.items()
                     if now - t > cfg.heartbeat_deadline_s]
            if not stale:
                self._suspects.pop(name, None)
                continue
            st = self._suspects.get(name)
            if st is None:
                ping = _Ping()
                rt.control.put(ping)
                self._c_pings.inc()
                self._suspects[name] = {"since": now, "ping": ping,
                                        "stale": stale}
            elif now - st["since"] >= cfg.ping_grace_s:
                # confirmed: the ping either never acked (ingest wedged)
                # or acked while a non-ingest stage stayed silent — both
                # are a failed worker, not a blip
                self._confirm(name, rt, stale, st, now)
        self.suspect_names = sorted(self._suspects)

    def _confirm(self, name: str, rt, stale: List[str], st: Dict,
                 now: float) -> None:
        cfg = self.cfg
        if now < self._next_restart_at:
            return                       # backing off a failed restart
        restart = cfg.restart and not self.breaker_open
        self._decide("evict" + ("+restart" if restart else ""), now,
                     worker=name, stale=stale,
                     ping_acked=st["ping"].ack.is_set())
        try:
            if restart:
                self.restart_attempts += 1
                # seam: the replacement is about to re-hydrate (cache
                # dump from compacted topics + buffer adoption)
                self.cluster.pipe.fault.trip(RESTART_PRE_HYDRATE)
                self.cluster.replace_worker(
                    name, lock_timeout=cfg.evict_lock_timeout_s,
                    join_timeout=cfg.evict_join_timeout_s)
                self.restarts += 1
                self._c_restarts.inc()
                self.consecutive_restart_failures = 0
            else:
                survivors = [n for n in self.cluster.alive_workers()
                             if n != name]
                if not survivors:
                    return               # nothing to fail over to: stay
                                         # suspect, serving runs degraded
                self.cluster.evict_workers(
                    [name], lock_timeout=cfg.evict_lock_timeout_s,
                    join_timeout=cfg.evict_join_timeout_s)
        except InjectedCrash:
            self._restart_failed(now)
            return
        except Exception:
            self._restart_failed(now)
            self._c_errors.inc()
            return
        self.evictions += 1
        self._c_evictions.inc()
        self.last_eviction = {"worker": name, "at_s": time.perf_counter(),
                              "suspect_since_s": st["since"],
                              "stale_stages": stale,
                              "restarted": restart}
        self._suspects.pop(name, None)

    def _restart_failed(self, now: float) -> None:
        """Exponential backoff with deterministic jitter; breaker after
        N consecutive failures."""
        cfg = self.cfg
        self.restart_failures += 1
        self._c_restart_failures.inc()
        self.consecutive_restart_failures += 1
        k = self.consecutive_restart_failures
        jitter = (zlib.crc32(f"restart:{self.restart_attempts}".encode())
                  % 1000) / 1000.0 * cfg.restart_jitter_s
        self.last_backoff_s = min(cfg.restart_backoff_max_s,
                                  cfg.restart_backoff_s * (2 ** (k - 1))
                                  ) + jitter
        self._next_restart_at = now + self.last_backoff_s
        self._log_decision({"action": "restart_backoff", "at_s": now,
                            "failures": k, "backoff_s": self.last_backoff_s})
        if k >= cfg.max_consecutive_restarts:
            self.breaker_open = True
            self._log_decision({"action": "breaker_open", "at_s": now,
                                "failures": k})

    def reset_breaker(self) -> None:
        """Operator action (docs/OPERATIONS.md): close the breaker and
        let supervised restarts resume."""
        self.breaker_open = False
        self.consecutive_restart_failures = 0
        self._next_restart_at = 0.0

    # ----------------------------------------------------------------- policy
    def _policy(self, now: float) -> None:
        cfg = self.cfg
        h = self.cluster.health()
        backlog = (h["backlog"]["operational_lag"]
                   + h["backlog"]["buffered"])
        alive = [n for n, w in h["workers"].items() if w["alive"]]
        n_alive = max(1, len(alive))
        per_worker = backlog / n_alive
        # per-worker owned commit lag (imbalance signal), derived from
        # the same snapshot so ownership and lag agree
        lag_by_worker = {n: 0 for n in alive}
        for topic, lags in h["commit_lag"].items():
            for name in alive:
                for p in h["workers"][name]["partitions"]:
                    lag_by_worker[name] += lags.get(p, 0)
        lag_vals = [lag_by_worker[n] for n in alive]
        mean_lag = sum(lag_vals) / n_alive
        imbalance = (max(lag_vals) / mean_lag) if mean_lag > 0 else 1.0

        self._high_streak = (self._high_streak + 1
                             if per_worker > cfg.backlog_high_per_worker
                             else 0)
        self._low_streak = (self._low_streak + 1
                            if per_worker < cfg.backlog_low_per_worker
                            else 0)
        self._imb_streak = (self._imb_streak + 1
                            if (imbalance > cfg.imbalance_threshold
                                and backlog >= cfg.imbalance_min_backlog)
                            else 0)
        if now < self._cooldown_until:
            return
        sample = {"backlog": backlog, "per_worker": round(per_worker, 1),
                  "imbalance": round(imbalance, 3), "alive": len(alive),
                  "freshness_p95_ms": h["freshness"].get("p95_ms")}

        if self._high_streak >= cfg.hysteresis_samples \
                and len(alive) < cfg.max_workers:
            self._decide("scale_up", now, **sample)
            self.cluster.scale_to(len(alive) + 1)
            self.scale_ups += 1
            self._c_scale_ups.inc()
            self._acted(now)
        elif self._imb_streak >= cfg.hysteresis_samples and cfg.repartition:
            self._decide("repartition", now, **sample)
            self.cluster.repartition()
            self.repartitions += 1
            self._c_repartitions.inc()
            self._acted(now)
        elif cfg.scale_down and len(alive) > cfg.min_workers \
                and self._low_streak >= (cfg.hysteresis_samples
                                         * cfg.scale_down_hysteresis_mult):
            self._decide("scale_down", now, **sample)
            self.cluster.scale_to(len(alive) - 1)
            self.scale_downs += 1
            self._c_scale_downs.inc()
            self._acted(now)

    def _acted(self, now: float) -> None:
        self._cooldown_until = time.perf_counter() + self.cfg.cooldown_s
        self._high_streak = self._low_streak = self._imb_streak = 0

    # ------------------------------------------------------------ bookkeeping
    def _decide(self, action: str, now: float, **detail) -> None:
        """Record + trace a decision, then cross the ``control.decide``
        fault seam (a drill may kill the controller right here — before
        the action executes, so the data plane stays consistent)."""
        self._log_decision({"action": action, "at_s": now, **detail})
        self._c_decisions.inc()
        with self.cluster.pipe.tracer.span("control.decide") as sp:
            sp.put("action", action)
        self.cluster.pipe.fault.trip(CONTROL_DECIDE)

    def _log_decision(self, entry: Dict) -> None:
        self.decisions.append(entry)
        if len(self.decisions) > 256:
            del self.decisions[:64]

    def snapshot(self) -> Dict:
        """Control-plane section of the health snapshot. Lock-free:
        every field is one GIL-atomic read of control-thread state."""
        credits = {}
        dead_lettered = 0
        for name, rt in list(self.cluster.runtimes.items()):
            dead_lettered += len(rt.worker.dead_letter)
            if not rt.dead:
                credits[name] = {"available": rt.credits.available,
                                 "outstanding": rt.credits.outstanding}
        return {
            "enabled": True,
            "crashed": self.crashed,
            "degraded": self.degraded(),
            "breaker_open": self.breaker_open,
            "suspects": list(self.suspect_names),
            "evictions": self.evictions,
            "restarts": self.restarts,
            "restart_failures": self.restart_failures,
            "restart_attempts": self.restart_attempts,
            "dead_lettered": dead_lettered,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "repartitions": self.repartitions,
            "decisions": len(self.decisions),
            "last_decision": self.decisions[-1] if self.decisions else None,
            "last_eviction": self.last_eviction,
            "credits": credits,
        }


__all__ = ["CreditLedger", "ControlConfig", "ControlPlane",
           "QuiesceTimeout", "QuiesceTimeoutWarning"]
