"""Deterministic fault injection at the pipeline's stage seams.

A ``FaultInjector`` is armed with a schedule ``{point: ordinal}``: the
ordinal-th time execution reaches the named crash point, the process
"dies" — either by raising ``InjectedCrash`` (in-process drills: the
test abandons the pipeline objects, exactly as a kill would, and
recovers into fresh ones) or by ``SIGKILL``-ing the whole process
(cross-process kill-9 drills: the parent recovers from the journal).
A third action, ``"hang"``, freezes the tripping thread instead of
killing it — the grey-failure case (a wedged stage, a straggler) that
the control plane's heartbeat detection exists to catch.

Crash points are *seams*, not random preemption: each one sits at a
stage boundary where in-flight state differs (fetched-uncommitted,
transformed-unloaded, loaded-uncommitted, checkpoint written-unrenamed,
repartition half-applied). Recovery must be exactly-once from every one
of them — that is what ``tests/test_recovery.py`` drills; the control
seams (``heartbeat.miss``, ``restart.pre_hydrate``, ``control.decide``)
are what ``tests/test_control.py`` drills.

The default injector (``NULL_INJECTOR``) never trips; ``trip`` on it is
one dict lookup, so production paths pay nothing measurable.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional

# canonical crash-point names (the seams wired through pipeline/cluster)
INGEST_FETCH = "ingest.fetch"            # records fetched, nothing committed
TRANSFORM_DONE = "transform.done"        # facts computed, nothing loaded
LOAD_PRE_COMMIT = "load.pre_commit"      # warehouse loaded, offsets NOT committed
COMMIT_POST = "commit.post"              # offsets committed (post-boundary)
CHECKPOINT_MID_WRITE = "checkpoint.mid_write"  # journal tmp written, not renamed
REPARTITION_MID = "repartition.mid"      # epoch switched, ownership not rebalanced
HEARTBEAT_MISS = "heartbeat.miss"        # stage loop heartbeat (hang = frozen stage)
RESTART_PRE_HYDRATE = "restart.pre_hydrate"  # supervisor about to re-hydrate a worker
CONTROL_DECIDE = "control.decide"        # controller about to execute a decision

CRASH_POINTS = (INGEST_FETCH, TRANSFORM_DONE, LOAD_PRE_COMMIT, COMMIT_POST,
                CHECKPOINT_MID_WRITE, REPARTITION_MID, HEARTBEAT_MISS,
                RESTART_PRE_HYDRATE, CONTROL_DECIDE)

_ACTIONS = ("raise", "sigkill", "hang")


class InjectedCrash(BaseException):
    """Raised at a tripped crash point. Derives from BaseException so an
    over-broad ``except Exception`` in a stage loop cannot swallow the
    simulated death and keep processing."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected crash at {point} (hit #{hit})")
        self.point = point
        self.hit = hit


class FaultInjector:
    """Named crash points with per-point Nth-hit ordinals.

    ``schedule`` maps point name -> ordinal(s). An ordinal is 1-based;
    a single int trips that hit only, a set/list/tuple of ints trips at
    each listed hit (e.g. every restart attempt). ``mode`` is the
    default action, overridable per point via ``actions``:

    * ``"raise"``   — raise ``InjectedCrash`` in the tripping thread
      (other stage threads keep running until the drill abandons them —
      the in-process analogue of a kill);
    * ``"sigkill"`` — ``os.kill(os.getpid(), SIGKILL)``: the real thing,
      for cross-process drills (benchmarks/recovery_bench.py --kill9);
    * ``"hang"``    — block the tripping thread on an internal event
      until ``release_hangs()`` (or a long safety timeout). A hang is a
      grey failure, not a death: it does NOT set ``tripped``, so
      checkpointing and the rest of the process carry on around the
      frozen thread — exactly what heartbeat detection must catch.

    ``sticky`` (default True) preserves the original drill contract:
    after the first kill-trip, every later trip is a no-op (the process
    is already 'dead'). Control-plane chaos schedules pass
    ``sticky=False`` so several independent faults can fire in one run.

    Hit counting is lock-protected so concurrent stage threads tripping
    the same point resolve to exactly one ordinal each; ``tripped`` is a
    ``threading.Event`` drills wait on before abandoning the cluster,
    and ``hung`` is its grey-failure sibling (set on the first hang).
    """

    def __init__(self, schedule: Optional[Dict[str, object]] = None,
                 mode: str = "raise",
                 actions: Optional[Dict[str, str]] = None,
                 sticky: bool = True,
                 hang_timeout_s: float = 300.0):
        assert mode in _ACTIONS, mode
        for pt, act in (actions or {}).items():
            assert act in _ACTIONS, (pt, act)
        self.schedule = dict(schedule or {})
        self.mode = mode
        self.actions = dict(actions or {})
        self.sticky = sticky
        self.hang_timeout_s = hang_timeout_s
        self.counts: Dict[str, int] = {}
        self.tripped = threading.Event()
        self.tripped_at: Optional[str] = None
        self.hung = threading.Event()
        self.hangs: Dict[str, int] = {}
        self.hung_at_s: Optional[float] = None
        self._hang_release = threading.Event()
        self._lock = threading.Lock()

    def _scheduled(self, point: str, hit: int) -> bool:
        target = self.schedule.get(point)
        if target is None:
            return False
        if isinstance(target, int):
            return hit == target
        return hit in target

    def trip(self, point: str) -> None:
        """Act if ``point``'s scheduled ordinal is reached; no-op
        otherwise. With ``sticky`` (the default), all trips become
        no-ops once something has kill-tripped — the process is already
        'dead', surviving threads must not re-die into cascading
        exceptions mid-teardown. Hangs never arm that latch."""
        if self.schedule.get(point) is None:
            return
        with self._lock:
            if self.sticky and self.tripped.is_set():
                return
            hit = self.counts.get(point, 0) + 1
            self.counts[point] = hit
            if not self._scheduled(point, hit):
                return
            action = self.actions.get(point, self.mode)
            if action == "hang":
                self.hangs[point] = self.hangs.get(point, 0) + 1
                if not self.hung.is_set():
                    self.hung_at_s = time.perf_counter()
                    self.hung.set()
            else:
                self.tripped_at = point
                self.tripped.set()
        if action == "hang":
            self._hang_release.wait(self.hang_timeout_s)
            return
        if action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(point, hit)

    def release_hangs(self) -> None:
        """Unblock every thread frozen by a ``hang`` trip (drill
        teardown — released threads observe their stop flags and exit)."""
        self._hang_release.set()


class _NullInjector(FaultInjector):
    """The default: never trips. ``trip`` short-circuits on the empty
    schedule, so hot paths carry one dict ``get`` per seam."""

    def __init__(self):
        super().__init__({}, "raise")


NULL_INJECTOR = _NullInjector()
