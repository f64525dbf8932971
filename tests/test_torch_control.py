"""The port's self-healing control plane (``repro_torch.runtime.control``)
on the CPU: the drills of tests/test_control.py mirrored on the port's
concurrent runtime with the torch backend (plain kernel versions). Each
drill injects a fault at a control seam — a hang, a stage-thread crash, a
poison record, a failing restart, a seeded random schedule — and the
healed cluster must finish with the reference package's uninterrupted
numpy oracle's fact table, byte for byte."""
import dataclasses
import threading
import warnings

import numpy as np
import pytest
import torch

import repro.configs.dod_etl as ref_cfg
import repro.core as ref_core
import repro.data.sampler as ref_sampler
from repro_torch.configs.dod_etl import steelworks_config
from repro_torch.core import DODETLPipeline, SourceDatabase
from repro_torch.core.buffer import DeadLetterBuffer
from repro_torch.core.message_queue import MessageQueue, TopicConfig
from repro_torch.core.records import make_batch
from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
from repro_torch.durability.faults import (HEARTBEAT_MISS, INGEST_FETCH,
                                           RESTART_PRE_HYDRATE,
                                           TRANSFORM_DONE, FaultInjector)
from repro_torch.runtime.cluster import ConcurrentCluster
from repro_torch.runtime.control import (ControlConfig, CreditLedger,
                                         QuiesceTimeout,
                                         QuiesceTimeoutWarning)

# the reference drills' fast supervision, with a 1 s heartbeat deadline
# where the reference's numpy drills use 0.4 s: a stage iteration on the
# CPU plain versions (hundreds of small torch ops) can stall for tenths of
# a second on a loaded host, and a spurious eviction would break the
# drills' restart counts
FAST = dict(tick_s=0.02, heartbeat_deadline_s=1.0, ping_grace_s=0.2,
            warmup_s=0.2, restart_backoff_s=0.05, restart_backoff_max_s=0.5,
            restart_jitter_s=0.02, policy_interval_s=0.1,
            evict_lock_timeout_s=0.5, evict_join_timeout_s=0.5,
            scaling=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per torch call: the stage threads are the
    unit of parallelism, and an oversubscribed pool would stretch
    transforms toward the heartbeat deadline."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(n_workers, n_records=2500, n_partitions=8, late_frac=0.05,
          fault=None, seed=0):
    cfg = steelworks_config(n_partitions=n_partitions)
    cfg = dataclasses.replace(cfg, buffer_capacity=4096)
    src = SourceDatabase()
    SteelworksSampler(cfg, SamplerConfig(
        records_per_table=n_records, n_equipment=n_partitions,
        late_master_frac=late_frac, seed=seed)).generate(src)
    pipe = DODETLPipeline(cfg, src, n_workers=n_workers, fault=fault,
                          device="cpu")
    return cfg, src, pipe


_ORACLES = {}


def oracle_facts(n_records, n_partitions=8, late_frac=0.05, seed=0):
    """Byte-level fact table of the REFERENCE package's uninterrupted
    single-worker numpy run over the same pre-extracted stream."""
    key = (n_records, n_partitions, late_frac, seed)
    if key not in _ORACLES:
        cfg = ref_cfg.steelworks_config(n_partitions=n_partitions,
                                        backend="numpy")
        cfg = dataclasses.replace(cfg, buffer_capacity=4096)
        src = ref_core.SourceDatabase()
        ref_sampler.SteelworksSampler(cfg, ref_sampler.SamplerConfig(
            records_per_table=n_records, n_equipment=n_partitions,
            late_master_frac=late_frac, seed=seed)).generate(src)
        pipe = ref_core.DODETLPipeline(cfg, src, n_workers=1)
        pipe.extract()
        pipe.bootstrap_caches()
        pipe.run_to_completion()
        _ORACLES[key] = pipe.warehouse.canonical_fact_table().tobytes()
    return _ORACLES[key]


def wait_for(predicate, timeout=15.0, interval=0.01):
    import time
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def stop_quietly(cluster):
    with warnings.catch_warnings():          # wedged daemon threads
        warnings.simplefilter("ignore", QuiesceTimeoutWarning)
        cluster.stop_all()


# ================================================================ credit ledger
def test_credit_ledger_conservation():
    led = CreditLedger(100)
    assert led.take(30) == 30
    assert led.available == 70 and led.outstanding == 30
    assert led.take(200) == 70          # clamps to available, never blocks
    assert led.take(10) == 0            # exhausted: zero grant, no deadlock
    assert led.exhausted()
    led.refund(30)
    assert led.available == 30 and led.outstanding == 70
    led.refund(70)
    assert led.available == led.capacity and led.outstanding == 0
    assert led.spent == 100 and led.refunded == 100
    led.refund(50)                      # over-refund capped at capacity
    assert led.available == led.capacity
    assert led.take(0) == 0 and led.take(-5) == 0


def test_credit_ledger_concurrent_hammer():
    """Many threads take/refund concurrently: conservation holds at every
    end state and the ledger never grants more than its capacity."""
    led = CreditLedger(256)
    errors = []

    def hammer(seed):
        rng = np.random.default_rng(seed)
        held = 0
        for _ in range(2000):
            if rng.random() < 0.5:
                got = led.take(int(rng.integers(1, 32)))
                if got < 0 or led.available < 0:
                    errors.append("negative grant or balance")
                held += got
            elif held:
                back = int(rng.integers(1, held + 1))
                led.refund(back)
                held -= back
        led.refund(held)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert led.available == led.capacity
    assert led.outstanding == 0
    assert led.spent == led.refunded


def test_credits_conserved_across_full_run():
    """End-to-end: a full stream spends and refunds every credit — at
    idle each live ledger is whole again."""
    n = 2000
    cfg, _, pipe = build(2, n)
    pipe.cfg = dataclasses.replace(cfg, credit_capacity=256)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False)
    cluster.start()
    done = cluster.run_until_idle(timeout=60)
    cluster.stop_all()
    assert done == n
    for rt in cluster.runtimes.values():
        assert rt.credits.available == rt.credits.capacity
        assert rt.credits.spent == rt.credits.refunded
        assert rt.credits.spent >= n // len(cluster.runtimes) // 2


def test_credits_exhausted_throttles_extraction():
    _, _, pipe = build(2, 100)
    cluster = ConcurrentCluster(pipe, poll_cdc=False)
    assert not cluster._credits_exhausted()
    for rt in cluster.runtimes.values():
        rt.credits.take(rt.credits.capacity)
    assert cluster._credits_exhausted()          # extractor backs off
    next(iter(cluster.runtimes.values())).credits.refund(1)
    assert not cluster._credits_exhausted()      # any headroom resumes


# ================================================================ group fencing
def test_fenced_group_cannot_commit_or_fetch():
    """After eviction the victim's consumer group is dead at the broker:
    its commits are dropped and its fetches return nothing."""
    q = MessageQueue()
    q.create_topic(TopicConfig("t", 0, 2, "business_key"))
    n = 50
    q.publish("t", make_batch(0, 0, np.arange(n), np.arange(n),
                              np.arange(n), np.zeros((n, 8), np.float32)))
    _, counts = q.fetch_many("g", "t", [0, 1])
    assert sum(counts.values()) == n
    q.commit("g", "t", 0, counts[0])
    committed = q.committed("g", "t", 0)
    q.fence_group("g")
    assert q.is_fenced("g")
    q.commit("g", "t", 1, counts[1])             # zombie commit: dropped
    assert q.committed("g", "t", 1) == 0
    assert q.committed("g", "t", 0) == committed
    q.rewind("g", "t", 0), q.rewind("g", "t", 1)
    batch, c2 = q.fetch_many("g", "t", [0, 1])   # zombie fetch: empty
    assert not c2 and len(batch) == 0
    assert q.fenced_commits == 1 and q.fenced_fetches == 1
    _, c3 = q.fetch_many("g2", "t", [0, 1])
    assert sum(c3.values()) == n


def test_quiesce_timeout_is_typed_runtime_error():
    assert issubclass(QuiesceTimeout, RuntimeError)
    assert issubclass(QuiesceTimeoutWarning, UserWarning)


def test_join_surfaces_wedged_threads():
    """A stop that strands a stage thread must not read as success:
    ``WorkerRuntime.join`` returns the wedged names, warns, and counts
    them in ``worker.join_timeouts``."""
    fault = FaultInjector({INGEST_FETCH: 1}, actions={INGEST_FETCH: "hang"})
    _, _, pipe = build(1, 200, fault=fault)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False)
    cluster.start()
    assert fault.hung.wait(10.0), "hang seam never reached"
    rt = next(iter(cluster.runtimes.values()))
    rt.stop.set()
    with pytest.warns(QuiesceTimeoutWarning):
        wedged = rt.join(timeout=0.3)
    assert len(wedged) == 1                       # exactly the frozen stage
    assert cluster.health()["counters"]["worker.join_timeouts"] == 1
    fault.release_hangs()
    stop_quietly(cluster)


# =========================================================== hang (grey) drill
def test_hang_drill_detect_evict_restart_byte_identical():
    """One stage thread freezes mid-stream. The supervisor detects the
    silent heartbeat, confirms via ping, force-evicts (fencing the
    zombie's group) and restarts a re-hydrated replacement — and the
    stream finishes byte-identical to the reference's oracle."""
    n = 2500
    fault = FaultInjector({TRANSFORM_DONE: 3},
                          actions={TRANSFORM_DONE: "hang"})
    _, _, pipe = build(3, n, fault=fault)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                control=ControlConfig(**FAST))
    cluster.start()
    assert fault.hung.wait(10.0), "hang seam never reached"
    assert wait_for(lambda: cluster.control.last_eviction is not None), \
        "supervisor never confirmed the hung worker"
    ev = cluster.control.last_eviction
    assert ev["restarted"] is True
    latency = ev["at_s"] - fault.hung_at_s
    bound = (FAST["heartbeat_deadline_s"] + FAST["ping_grace_s"]
             + 10 * FAST["tick_s"]
             + 2 * FAST["evict_join_timeout_s"] + 1.5)
    assert 0 < latency < bound, (latency, bound)
    done = cluster.run_until_idle(timeout=60)
    stop_quietly(cluster)
    fault.release_hangs()
    assert done == n
    assert pipe.warehouse.rows_loaded == n
    assert pipe.warehouse.canonical_fact_table().tobytes() == oracle_facts(n)
    h = cluster.health()
    assert h["control"]["enabled"] and h["control"]["restarts"] == 1
    assert h["control"]["evictions"] == 1
    assert h["counters"]["control.pings"] >= 1
    assert h["counters"]["worker.join_timeouts"] >= 1
    assert len(cluster.alive_workers()) == 3
    assert ev["worker"] not in cluster.alive_workers()


# ================================================================= crash drill
def test_crash_drill_detect_evict_restart_byte_identical():
    """A stage thread dies outright (fetched-uncommitted window); the
    supervisor replaces the worker and the fenced group's uncommitted
    records are re-served exactly once."""
    n = 2500
    fault = FaultInjector({INGEST_FETCH: 4})
    _, _, pipe = build(3, n, fault=fault)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                max_records_per_partition=25,
                                control=ControlConfig(**FAST))
    cluster.start()
    assert fault.tripped.wait(10.0), "crash seam never reached"
    assert wait_for(lambda: cluster.control.restarts >= 1), \
        "supervisor never restarted the crashed worker"
    done = cluster.run_until_idle(timeout=60)
    stop_quietly(cluster)
    assert done == n
    assert pipe.warehouse.rows_loaded == n
    assert pipe.warehouse.canonical_fact_table().tobytes() == oracle_facts(n)
    snap = cluster.control.snapshot()
    assert snap["restarts"] >= 1 and snap["restart_failures"] == 0
    assert not snap["breaker_open"]
    ev = cluster.control.last_eviction
    assert ev is not None and "ingest" in ev["stale_stages"]


# ================================================================ poison drill
class _PoisonError(Exception):
    pass


def _poison_transform(worker, key):
    orig = worker.transformer.transform_block

    def wrapped(batch, eq, qu):
        if np.any(batch.business_key == key):
            raise _PoisonError(f"poison key {key}")
        return orig(batch, eq, qu)

    worker.transformer.transform_block = wrapped


def test_poison_records_quarantined_not_crash_looped():
    """Records whose transform deterministically raises are bisected out,
    parked in the dead-letter buffer with their offsets committed; the
    worker keeps going and nothing crash-loops."""
    n, bad_key = 2500, 3
    _, _, pipe = build(2, n, late_frac=0.0)
    for w in pipe.workers:
        _poison_transform(w, bad_key)
    pipe.extract()
    # bisecting a batch runs one probe transform per split with no
    # heartbeat in between: hundreds of plain-version transforms on the
    # CPU, seconds on a loaded host — the deadline must outlast that for
    # "no eviction" to test the quarantine and not the host's speed
    cluster = ConcurrentCluster(
        pipe, poll_cdc=False,
        control=ControlConfig(**{**FAST, "heartbeat_deadline_s": 30.0}))
    cluster.start()
    cluster.run_until_idle(timeout=60)
    cluster.stop_all()
    quarantined = sum(len(rt.worker.dead_letter)
                      for rt in cluster.runtimes.values())
    assert quarantined > 0
    assert pipe.warehouse.rows_loaded == n - quarantined
    for rt in cluster.runtimes.values():
        held = rt.worker.dead_letter.peek()
        if len(held):
            assert (held.business_key == bad_key).all()
            assert all(r["reason"] == "transform-poison"
                       for r in rt.worker.dead_letter.reasons)
    assert cluster._operational_lag() == 0
    snap = cluster.control.snapshot()
    assert snap["restarts"] == 0 and snap["evictions"] == 0
    assert not snap["breaker_open"]
    assert snap["dead_lettered"] == quarantined
    h = cluster.health()
    assert h["counters"]["worker.dead_lettered"] == quarantined


def test_dead_letter_export_restore_roundtrip():
    dl = DeadLetterBuffer()
    dl.push(make_batch(0, 0, np.arange(3), np.full(3, 7), np.arange(3),
                       np.zeros((3, 8), np.float32)), reason="transform-poison")
    dl2 = DeadLetterBuffer.restore(dl.export_state())
    assert len(dl2) == 3 and dl2.total_quarantined == 3
    assert dl2.reasons == [{"reason": "transform-poison", "records": 3}]
    assert DeadLetterBuffer.restore(None).total_quarantined == 0
    assert len(dl2.drain()) == 3 and len(dl2) == 0


# ======================================================= breaker / backoff drill
def test_restart_failures_back_off_then_open_breaker():
    """Every restart attempt fails at the pre-hydration seam: backoff
    grows, the circuit breaker opens after the configured failures, and
    the control thread survives in degraded mode."""
    fault = FaultInjector(
        {HEARTBEAT_MISS: 2, RESTART_PRE_HYDRATE: set(range(1, 10))},
        actions={HEARTBEAT_MISS: "hang"}, sticky=False)
    _, _, pipe = build(3, 2000, fault=fault)
    pipe.extract()
    ctl = ControlConfig(**{**FAST, "max_consecutive_restarts": 3})
    cluster = ConcurrentCluster(pipe, poll_cdc=False, control=ctl)
    cluster.start()
    assert fault.hung.wait(10.0)
    assert wait_for(lambda: cluster.control.breaker_open, timeout=20.0), \
        "breaker never opened"
    ctrl = cluster.control
    assert ctrl.restart_attempts == 3
    assert ctrl.consecutive_restart_failures == 3
    assert ctrl.restarts == 0 and ctrl.restart_failures == 3
    assert not ctrl.crashed
    backoffs = [d["backoff_s"] for d in ctrl.decisions
                if d["action"] == "restart_backoff"]
    assert len(backoffs) == 3
    assert backoffs[0] < backoffs[1] < backoffs[2]
    assert any(d["action"] == "breaker_open" for d in ctrl.decisions)
    h = cluster.health()
    assert h["control"]["breaker_open"] and h["control"]["degraded"]
    assert wait_for(lambda: ctrl.evictions >= 1, timeout=20.0)
    assert ctrl.last_eviction["restarted"] is False
    ctrl.reset_breaker()
    assert not ctrl.breaker_open
    fault.release_hangs()
    stop_quietly(cluster)


# ============================================================== chaos schedules
def _chaos_schedule(seed):
    rng = np.random.default_rng(seed)
    point = [INGEST_FETCH, TRANSFORM_DONE, HEARTBEAT_MISS][
        int(rng.integers(0, 3))]
    action = ["raise", "hang"][int(rng.integers(0, 2))]
    ordinal = int(rng.integers(1, 30))
    return point, action, ordinal


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_schedule_exactly_once(seed):
    """Seeded random kill/hang schedules under load: the self-healing
    cluster finishes byte-identical to the oracle with whole credit
    ledgers, whether or not the fault's ordinal was reached."""
    n = 2500
    point, action, ordinal = _chaos_schedule(seed)
    fault = FaultInjector({point: ordinal}, actions={point: action},
                          sticky=(action == "raise"))
    _, _, pipe = build(3, n, fault=fault)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                max_records_per_partition=25,
                                control=ControlConfig(**FAST))
    cluster.start()
    done = cluster.run_until_idle(timeout=90)
    stop_quietly(cluster)
    fault.release_hangs()
    fired = fault.tripped.is_set() or fault.hung.is_set()
    assert done == n, (point, action, ordinal, fired)
    assert pipe.warehouse.rows_loaded == n
    assert pipe.warehouse.canonical_fact_table().tobytes() == oracle_facts(n)
    if fault.tripped.is_set() and point in (INGEST_FETCH, TRANSFORM_DONE):
        assert cluster.control.evictions >= 1
    for rt in cluster.runtimes.values():
        if not rt.dead:
            assert rt.credits.available == rt.credits.capacity
    assert not cluster.control.crashed


# ================================================================ policy drills
def test_policy_scales_up_on_sustained_backlog():
    """The autonomous loop: a pre-published backlog far above the
    per-worker threshold makes the controller scale up with no human
    call, and the stream still completes exactly once."""
    n = 4000
    _, _, pipe = build(1, n)
    pipe.extract()
    ctl = ControlConfig(**{**FAST, "scaling": True,
                           "policy_interval_s": 0.05,
                           "hysteresis_samples": 2, "cooldown_s": 0.3,
                           "backlog_high_per_worker": 200,
                           "backlog_low_per_worker": 0,
                           "scale_down": False, "repartition": False,
                           "max_workers": 3})
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                max_records_per_partition=20, control=ctl)
    cluster.start()
    assert wait_for(lambda: cluster.control.scale_ups >= 1, timeout=20.0), \
        "controller never scaled up"
    done = cluster.run_until_idle(timeout=90)
    cluster.stop_all()
    assert done == n and pipe.warehouse.rows_loaded == n
    assert len(cluster.alive_workers()) >= 2
    acted = [d for d in cluster.control.decisions
             if d["action"] == "scale_up"]
    assert acted and acted[0]["per_worker"] > 200


def test_policy_quiet_stream_makes_no_decisions():
    import time
    n = 1500
    _, _, pipe = build(2, n)
    pipe.extract()
    ctl = ControlConfig(**{**FAST, "scaling": True, "scale_down": False,
                           "repartition": False, "policy_interval_s": 0.05})
    cluster = ConcurrentCluster(pipe, poll_cdc=False, control=ctl)
    cluster.start()
    done = cluster.run_until_idle(timeout=60)
    time.sleep(0.3)                               # a few idle policy samples
    cluster.stop_all()
    assert done == n
    snap = cluster.control.snapshot()
    assert snap["scale_ups"] == 0 and snap["scale_downs"] == 0
    assert snap["repartitions"] == 0 and snap["evictions"] == 0
    assert not snap["degraded"]


def test_health_control_stub_without_control_plane():
    cfg, _, pipe = build(1, 200)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False)
    h = cluster.health()
    assert h["control"]["enabled"] is False
    assert h["control"]["suspects"] == []
    assert h["control"]["dead_lettered"] == 0
    for w in h["workers"].values():
        assert w["credits_available"] == cfg.credit_capacity
        assert "heartbeat_max_age_s" in w and "dead_lettered" in w
