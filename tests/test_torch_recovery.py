"""The port's durability plane (``repro_torch.durability``,
``repro_torch.train.checkpoint``) on the CPU: the seeded crash drills of
tests/test_recovery.py mirrored on the port — kill at a named seam,
recover a FRESH pipeline from the journal with
``recover_pipeline(device="cpu")``, finish, and compare the warehouse and
every view table byte for byte with an uninterrupted run — plus the
legs that carry state across packages: a journal written by the
reference package (numpy backend) restores into the port and finishes
the stream with the reference's uninterrupted bytes, and the reverse.
(No ``@given`` + function-scoped ``tmp_path`` here: hypothesis rejects
that pattern; the seeded schedules stand in for it.)"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.configs.dod_etl as ref_cfg
import repro.core as ref_core
import repro.data.sampler as ref_sampler
import repro.durability as ref_dur
import repro.serving.engine as ref_engine
import repro.serving.views as ref_views
import repro.train.checkpoint as ref_ckpt
import repro_torch.configs.dod_etl as port_cfg
import repro_torch.core as port_core
import repro_torch.data.sampler as port_sampler
import repro_torch.durability as port_dur
import repro_torch.serving.engine as port_engine
import repro_torch.serving.views as port_views
from repro_torch.core import MessageQueue, TopicConfig
from repro_torch.core.records import make_batch
from repro_torch.durability import FaultInjector
from repro_torch.durability.faults import (CHECKPOINT_MID_WRITE, COMMIT_POST,
                                           INGEST_FETCH, LOAD_PRE_COMMIT,
                                           REPARTITION_MID, TRANSFORM_DONE)
from repro_torch.runtime.cluster import ConcurrentCluster
from repro_torch.train import checkpoint as ckpt

SEQ_POINTS = (INGEST_FETCH, TRANSFORM_DONE, LOAD_PRE_COMMIT, COMMIT_POST)
PKGS = {"port": (port_cfg, port_core, port_sampler, port_dur, port_engine,
                 port_views),
        "ref": (ref_cfg, ref_core, ref_sampler, ref_dur, ref_engine,
                ref_views)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- harness
def _workload(pkg="port", backend="torch", n=400, n_partitions=4,
              zipf_s=0.0, strategy="static", seed=0):
    cfg_mod, core, sampler = PKGS[pkg][:3]
    cfg = cfg_mod.steelworks_config(n_partitions=n_partitions,
                                    backend=backend,
                                    partition_strategy=strategy)
    cfg = dataclasses.replace(cfg, buffer_capacity=4096)
    src = core.SourceDatabase()
    sampler.SteelworksSampler(cfg, sampler.SamplerConfig(
        records_per_table=n, n_equipment=n_partitions,
        late_master_frac=0.15, zipf_s=zipf_s, seed=seed)).generate(src)
    return cfg, src


def _pipeline(pkg, cfg, src, **kw):
    core = PKGS[pkg][1]
    if pkg == "port":
        kw["device"] = "cpu"
    return core.DODETLPipeline(cfg, src, **kw)


def _engine(pkg, cfg):
    eng, views = PKGS[pkg][4], PKGS[pkg][5]
    kw = {"device": "cpu"} if pkg == "port" else {}
    return eng.MaterializedViewEngine(views.steelworks_views(
        cfg.n_business_keys), backend=cfg.backend, **kw)


def _recover(pkg, cfg, src, root, engine, **kw):
    dur = PKGS[pkg][3]
    if pkg == "port":
        kw["device"] = "cpu"
    return dur.recover_pipeline(cfg, src, dur.DurabilityJournal(root),
                                engine=engine, n_workers=2, **kw)


def _extraction_lag(pipe):
    log = pipe.source.log
    return sum(max(0, log.next_lsn - l.offset)
               for l in pipe.tracker.listeners)


def _drill_loop(pipe, engine, coord=None, ckpt_every=2, extract_per=60,
                repartition_at=None, cap=40, max_steps=300):
    """tests/test_recovery.py's deterministic state-driven loop."""
    steps = stalls = 0
    while steps < max_steps:
        steps += 1
        pipe.extract(extract_per)
        if repartition_at is not None \
                and pipe.current_routing().epoch == 0 \
                and pipe.warehouse.commit_seq >= repartition_at:
            pipe.repartition()
        n = pipe.step(cap)
        engine.fold_pending()
        if coord is not None and steps % ckpt_every == 0:
            coord.checkpoint(pipe, engine=engine)
        if _extraction_lag(pipe) > 0:
            stalls = 0
            continue
        if n == 0 and sum(len(w.buffer) for w in pipe.workers) == 0:
            break
        stalls = stalls + 1 if n == 0 else 0
        if stalls >= 3:
            break
    return steps


def _final_state(pipe, engine):
    snap = engine.snapshot()
    return {
        "facts": pipe.warehouse.canonical_fact_table().tobytes(),
        "rows": pipe.warehouse.rows_loaded,
        "seq": pipe.warehouse.commit_seq,
        "views": {n: st.table.tobytes() for n, st in snap.states.items()},
        "rows_folded": snap.rows_folded,
        "deltas_folded": snap.deltas_folded,
    }


_ORACLES = {}


def _oracle(pkg="port", backend="torch", repartition_at=None, **wl):
    """Uninterrupted run of the drill loop (memoized per scenario)."""
    key = (pkg, backend, repartition_at, tuple(sorted(wl.items())))
    if key not in _ORACLES:
        cfg, src = _workload(pkg, backend, **wl)
        pipe = _pipeline(pkg, cfg, src, n_workers=2)
        eng = _engine(pkg, cfg)
        pipe.warehouse.attach_serving(eng)
        _drill_loop(pipe, eng, repartition_at=repartition_at)
        _ORACLES[key] = _final_state(pipe, eng)
    return _ORACLES[key]


def _crash(pkg, backend, root, point, ordinal, repartition_at=None,
           journal_fault=False, ckpt_every=2, **wl):
    """Run the drill loop in ``pkg`` with a scheduled crash, journaling
    into ``root``. Returns (cfg, source, injector, crashed)."""
    dur = PKGS[pkg][3]
    cfg, src = _workload(pkg, backend, **wl)
    fault = dur.FaultInjector({point: ordinal})
    pipe = _pipeline(pkg, cfg, src, n_workers=2, fault=fault)
    eng = _engine(pkg, cfg)
    pipe.warehouse.attach_serving(eng)
    journal = dur.DurabilityJournal(
        root, **({"fault": fault} if journal_fault else {}))
    try:
        _drill_loop(pipe, eng, coord=dur.RecoveryCoordinator(journal),
                    repartition_at=repartition_at, ckpt_every=ckpt_every)
        crashed = False
    except dur.InjectedCrash:
        crashed = True
    return cfg, src, fault, crashed


def _crash_and_recover(tmp_path, point, ordinal, backend="torch",
                       repartition_at=None, journal_fault=False,
                       ckpt_every=2, **wl):
    root = str(tmp_path)
    cfg, src, fault, crashed = _crash("port", backend, root, point, ordinal,
                                      repartition_at, journal_fault,
                                      ckpt_every, **wl)
    eng2 = _engine("port", cfg)
    pipe2, coord2, info = _recover("port", cfg, src, root, eng2)
    if info is None:                 # crash before the first checkpoint
        pipe2.warehouse.attach_serving(eng2)
    _drill_loop(pipe2, eng2, coord=coord2, repartition_at=repartition_at,
                ckpt_every=ckpt_every)
    return _final_state(pipe2, eng2), fault, info, crashed


def _assert_identical(got, want):
    assert got["rows"] == want["rows"]           # zero lost, zero duplicated
    assert got["seq"] == want["seq"]
    assert got["facts"] == want["facts"]         # byte-identical warehouse
    assert got["rows_folded"] == want["rows_folded"]
    assert got["deltas_folded"] == want["deltas_folded"]
    for name, table in want["views"].items():
        assert got["views"][name] == table, name  # byte-identical views


# ------------------------------------------------------- sequential drill matrix
def test_port_oracle_is_the_reference_oracle():
    """The uninterrupted drill loop gives the same warehouse and views in
    both packages (torch on the CPU against the reference's numpy)."""
    _assert_identical(_oracle("port", "torch"), _oracle("ref", "numpy"))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("point", SEQ_POINTS)
def test_crash_drill_byte_identical(tmp_path, point, backend):
    """Kill at each stage seam -> restart -> the final warehouse and every
    view aggregate are byte-identical to the uninterrupted run."""
    want = _oracle(backend=backend)
    got, fault, info, crashed = _crash_and_recover(
        tmp_path, point, ordinal=5, backend=backend)
    assert crashed and fault.tripped_at == point
    assert info is not None
    _assert_identical(got, want)
    assert 0 <= info["replayed_chunks"] <= info["commit_seq"]
    if info["commit_seq"] > 2:
        assert info["replayed_chunks"] < info["commit_seq"]


def test_crash_before_first_checkpoint_recovers_cold(tmp_path):
    got, fault, info, crashed = _crash_and_recover(
        tmp_path, INGEST_FETCH, ordinal=1)
    assert crashed and info is None
    _assert_identical(got, _oracle())


def test_mid_checkpoint_write_crash(tmp_path):
    got, fault, info, crashed = _crash_and_recover(
        tmp_path, CHECKPOINT_MID_WRITE, ordinal=2, journal_fault=True)
    assert crashed and fault.tripped_at == CHECKPOINT_MID_WRITE
    assert info is not None and info["step"] == 0    # fell back to step_0
    _assert_identical(got, _oracle())


def test_mid_repartition_crash(tmp_path):
    wl = dict(n=500, zipf_s=1.2, strategy="skew")
    want = _oracle(repartition_at=3, **wl)
    got, fault, info, crashed = _crash_and_recover(
        tmp_path, REPARTITION_MID, ordinal=1, repartition_at=3, **wl)
    assert crashed and fault.tripped_at == REPARTITION_MID
    _assert_identical(got, want)


@pytest.mark.parametrize("seed", [3, 11, 42, 1234, 99991])
def test_random_crash_schedule_seeded(tmp_path, seed):
    """tests/test_recovery.py's seeded random schedules: random seam,
    ordinal, skew and checkpoint cadence; exactly-once for each."""
    rng = np.random.default_rng(seed)
    point = str(rng.choice(list(SEQ_POINTS) + [CHECKPOINT_MID_WRITE]))
    ordinal = int(rng.integers(1, 9))
    zipf = float(rng.choice([0.0, 1.1]))
    ckpt_every = int(rng.integers(1, 4))
    wl = dict(n=350, zipf_s=zipf)
    got, _, _, _ = _crash_and_recover(tmp_path, point, ordinal,
                                      journal_fault=True,
                                      ckpt_every=ckpt_every, **wl)
    _assert_identical(got, _oracle(**wl))


# --------------------------------------------------- state carried across
@pytest.mark.parametrize("point", [LOAD_PRE_COMMIT, COMMIT_POST])
def test_reference_journal_restores_into_port(tmp_path, point):
    """A journal the REFERENCE wrote (numpy backend) restores into the
    port with ``recover_pipeline(device="cpu")``; the port finishes the
    stream byte-identical to the reference's uninterrupted run."""
    root = str(tmp_path)
    _, _, fault, crashed = _crash("ref", "numpy", root, point, ordinal=5)
    assert crashed and fault.tripped_at == point
    cfg, src = _workload("port", "torch")
    eng = _engine("port", cfg)
    pipe, coord, info = _recover("port", cfg, src, root, eng)
    assert info is not None and info["commit_seq"] > 0
    _drill_loop(pipe, eng, coord=coord)
    _assert_identical(_final_state(pipe, eng), _oracle("ref", "numpy"))


def test_port_journal_restores_into_reference(tmp_path):
    """And back: the reference recovers from the port's journal."""
    root = str(tmp_path)
    _, _, fault, crashed = _crash("port", "torch", root, COMMIT_POST, 5)
    assert crashed
    cfg, src = _workload("ref", "numpy")
    eng = _engine("ref", cfg)
    pipe, coord, info = _recover("ref", cfg, src, root, eng,
                                 backend="numpy")
    assert info is not None
    _drill_loop(pipe, eng, coord=coord)
    _assert_identical(_final_state(pipe, eng), _oracle("ref", "numpy"))


def test_checkpoint_files_cross_load(tmp_path):
    """One file layout: each package restores the other's flat-list
    checkpoint, checksums and extras included."""
    leaves = [np.arange(10, dtype=np.int64), np.ones((3, 4), np.float32),
              np.zeros(0, np.int32)]
    ckpt.save(str(tmp_path / "step_0"), 0, leaves, extra={"k": [1, 2]})
    ref_ckpt.save(str(tmp_path / "step_1"), 1, leaves, extra={"k": 3})
    for restore, d, step in ((ref_ckpt.restore, "step_0", 0),
                             (ckpt.restore, "step_1", 1)):
        got_step, got, extra = restore(str(tmp_path / d))
        assert got_step == step
        for a, b in zip(got, leaves):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with open(tmp_path / "step_0" / "manifest.json") as f0, \
            open(tmp_path / "step_1" / "manifest.json") as f1:
        import json
        m0, m1 = json.load(f0), json.load(f1)
    assert m0["treedef"] == m1["treedef"] and m0["leaves"] == m1["leaves"]
    _, partial, _ = ckpt.restore(str(tmp_path / "step_1"), only={1})
    assert partial[0] is None and partial[2] is None
    assert ckpt.step_numbers(str(tmp_path)) == [0, 1]
    assert ckpt.latest_step(str(tmp_path)) == 1


# --------------------------------------------------------- concurrent kill drill
@pytest.mark.parametrize("point", (INGEST_FETCH, LOAD_PRE_COMMIT,
                                   COMMIT_POST))
def test_concurrent_kill_drill_exactly_once(tmp_path, point):
    """The real runtime: stage threads + periodic checkpointer, killed at
    a seam and abandoned without drains; recovery resumes and the result
    is byte-identical to the sequential oracle, views to their rebuild.
    (1,200 records where the reference drills 3,000: the CPU plain
    versions are many small torch ops, slow under 10 contending stage
    threads; the seam ordinal still falls mid-stream.)"""
    n = 1200
    cfg, src = _workload(n=n, n_partitions=8)
    fault = FaultInjector({point: 6})
    pipe = _pipeline("port", cfg, src, n_workers=3, fault=fault)
    eng = _engine("port", cfg)
    coord = port_dur.RecoveryCoordinator(
        port_dur.DurabilityJournal(str(tmp_path)))
    pipe.extract()
    cluster = ConcurrentCluster(
        pipe, max_records_per_partition=25, poll_cdc=False, serving=eng,
        recovery=coord, checkpoint_every_s=0.02)
    cluster.checkpoint()
    cluster.start()
    assert fault.tripped.wait(30.0), "crash point never reached"
    cluster.abandon()

    eng2 = _engine("port", cfg)
    pipe2, coord2, info = port_dur.recover_pipeline(
        cfg, src, port_dur.DurabilityJournal(str(tmp_path)), engine=eng2,
        device="cpu")
    assert info is not None
    cluster2 = ConcurrentCluster(pipe2, max_records_per_partition=25,
                                 poll_cdc=False, serving=eng2,
                                 recovery=coord2, checkpoint_every_s=0.02)
    cluster2.start()
    cluster2.run_until_idle(timeout=90)
    cluster2.stop_all()
    assert pipe2.warehouse.rows_loaded == n        # exactly-once

    cfg_o, src_o = _workload(n=n, n_partitions=8)
    oracle = _pipeline("port", cfg_o, src_o, n_workers=1)
    oracle.extract()
    oracle.bootstrap_caches()
    oracle.run_to_completion()
    assert pipe2.warehouse.canonical_fact_table().tobytes() == \
        oracle.warehouse.canonical_fact_table().tobytes()
    rebuilt = port_engine.MaterializedViewEngine.rebuild(
        port_views.steelworks_views(cfg.n_business_keys),
        pipe2.warehouse.read_view().chunks, backend="numpy")
    snap = eng2.snapshot()
    assert snap.rows_folded == rebuilt.rows_folded
    for name in rebuilt.states:
        assert snap.states[name].table.tobytes() == \
            rebuilt.states[name].table.tobytes(), name


def test_capture_waiting_on_a_dying_load_journals_nothing(tmp_path):
    """The kill drill's race, made deterministic: a periodic capture
    passes its "tripped?" check, then waits for a worker's commit lock
    while that worker's load stage, holding it, loads the warehouse and
    dies at ``load.pre_commit``. The capture must journal nothing: the
    state it would see (loaded, offsets not committed) replays the load
    on recovery — a duplicate."""
    import threading
    import time
    from repro_torch.durability.faults import InjectedCrash
    cfg, src = _workload(n=300)
    fault = FaultInjector({LOAD_PRE_COMMIT: 1})
    pipe = _pipeline("port", cfg, src, n_workers=2, fault=fault)
    journal = port_dur.DurabilityJournal(str(tmp_path))
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                recovery=port_dur.RecoveryCoordinator(
                                    journal))
    assert cluster.checkpoint() == 0
    rt = cluster.runtimes[sorted(cluster.runtimes)[0]]
    got = {}
    with pytest.raises(InjectedCrash):
        with rt.commit_lock:                  # the load stage's section
            waiter = threading.Thread(
                target=lambda: got.update(step=cluster.checkpoint()))
            waiter.start()
            time.sleep(0.3)                   # it now waits for the lock
            fault.trip(LOAD_PRE_COMMIT)
    waiter.join(10.0)
    assert not waiter.is_alive()
    assert got == {"step": None}
    assert journal.steps() == [0]


def test_load_stage_yields_to_a_waiting_capture_for_a_bounded_time(
        tmp_path):
    """A load stage lets a waiting capture take its commit lock first (on
    the card a busy load thread re-took its lock ahead of the capture for
    the whole stream), but never longer than ``_YIELD_S``: a capture stuck
    behind another worker's hung stage must not stall this one. Every
    capture leaves the count of waiting captures at zero."""
    import time
    cfg, src = _workload(n=300)
    pipe = _pipeline("port", cfg, src, n_workers=2)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                recovery=port_dur.RecoveryCoordinator(
                                    port_dur.DurabilityJournal(
                                        str(tmp_path))))
    rt = cluster.runtimes[sorted(cluster.runtimes)[0]]
    t0 = time.perf_counter()
    rt._yield_to_capture()
    assert time.perf_counter() - t0 < rt._YIELD_S
    cluster._captures.add(1)
    t0 = time.perf_counter()
    rt._yield_to_capture()
    waited = time.perf_counter() - t0
    cluster._captures.add(-1)
    assert rt._YIELD_S <= waited < rt._YIELD_S + 1.0
    assert cluster.checkpoint() == 0 and not cluster._captures.waiting()


# ------------------------------------------------------- torn-checkpoint repair
def _journal_with_steps(tmp_path, n_steps=3):
    cfg, src = _workload(n=300)
    pipe = _pipeline("port", cfg, src, n_workers=2)
    eng = _engine("port", cfg)
    pipe.warehouse.attach_serving(eng)
    journal = port_dur.DurabilityJournal(str(tmp_path))
    coord = port_dur.RecoveryCoordinator(journal)
    pipe.extract()
    pipe.bootstrap_caches()
    for _ in range(n_steps):
        pipe.step(40)
        eng.fold_pending()
        coord.checkpoint(pipe, engine=eng)
    return journal


def test_truncated_tail_step_pruned(tmp_path):
    journal = _journal_with_steps(tmp_path)
    steps = journal.steps()
    leaves = os.path.join(journal._dir_for(steps[-1]), "leaves.npz")
    with open(leaves, "r+b") as f:
        f.truncate(os.path.getsize(leaves) // 2)
    state = port_dur.DurabilityJournal(str(tmp_path)).load()
    assert state is not None and state["_step"] == steps[-2]
    assert journal.steps() == steps[:-1]           # torn step removed


def test_checksum_mismatch_tail_pruned(tmp_path):
    journal = _journal_with_steps(tmp_path)
    steps = journal.steps()
    leaves = os.path.join(journal._dir_for(steps[-1]), "leaves.npz")
    with open(leaves, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(leaves, "wb") as f:
        f.write(bytes(data))
    state = port_dur.DurabilityJournal(str(tmp_path)).load()
    assert state is not None and state["_step"] == steps[-2]


def test_mid_chain_corruption_raises(tmp_path):
    journal = _journal_with_steps(tmp_path)
    leaves = os.path.join(journal._dir_for(journal.steps()[0]),
                          "leaves.npz")
    with open(leaves, "r+b") as f:
        f.truncate(10)
    with pytest.raises(IOError):
        port_dur.DurabilityJournal(str(tmp_path)).load()


def test_tmp_leftovers_ignored_and_swept(tmp_path):
    journal = _journal_with_steps(tmp_path, n_steps=2)
    steps_before = journal.steps()
    stray = os.path.join(str(tmp_path), "step_9.tmp-123-456")
    os.makedirs(stray)
    with open(os.path.join(stray, "leaves.npz"), "wb") as f:
        f.write(b"torn")
    assert journal.steps() == steps_before
    assert ckpt.latest_step(str(tmp_path)) == steps_before[-1]
    assert port_dur.DurabilityJournal(str(tmp_path)).load() is not None
    assert not os.path.exists(stray)               # swept


# ------------------------------------------------------ broker offset durability
def _toy_queue():
    q = MessageQueue()
    q.create_topic(TopicConfig("ops", 0, 4, "business_key"))
    q.create_topic(TopicConfig("master", 1, 4, "row_key", compacted=True))
    n = 200
    q.publish("ops", make_batch(0, 0, np.arange(n), np.arange(n) % 16,
                                np.arange(n), np.zeros((n, 8), np.float32)))
    q.publish("master", make_batch(1, 0, np.arange(60) % 20, np.arange(60),
                                   np.arange(60),
                                   np.arange(480, dtype=np.float32)
                                   .reshape(60, 8)))
    return q


def _clone_topics(q):
    q2 = MessageQueue()
    for t in q.topics.values():
        q2.create_topic(dataclasses.replace(t.cfg))
    return q2


def test_offsets_survive_broker_restart():
    q = _toy_queue()
    _, counts = q.fetch_many("g", "ops", range(4), 30)
    for p in (0, 1):
        q.commit("g", "ops", p, counts[p])
    q2 = _clone_topics(q)
    q2.restore_broker_state(q.export_state())
    for p in range(4):
        assert q2.committed("g", "ops", p) == q.committed("g", "ops", p)
    assert not q2.positions                        # read-ahead not durable
    b2, c2 = q2.fetch_many("g", "ops", range(4))
    q.rewind("g", "ops", 2), q.rewind("g", "ops", 3)
    b1, c1 = q.fetch_many("g", "ops", range(4))
    assert c1 == c2
    np.testing.assert_array_equal(np.sort(b1.row_key), np.sort(b2.row_key))
    rks1, pls1, tts1 = q.topics["master"].snapshot()
    rks2, pls2, tts2 = q2.topics["master"].snapshot()
    o1, o2 = np.argsort(rks1), np.argsort(rks2)
    np.testing.assert_array_equal(rks1[o1], rks2[o2])
    np.testing.assert_array_equal(tts1[o1], tts2[o2])
    np.testing.assert_array_equal(pls1[o1], pls2[o2])


def test_incremental_export_only_ships_suffix():
    q = _toy_queue()
    full = q.export_state()
    lengths = {t: m["lengths"] for t, m in full["meta"].items()}
    assert all(not segs for segs in
               q.export_state(since=lengths)["segments"].values())
    n = 40
    q.publish("ops", make_batch(0, 0, np.arange(n) + 500, np.arange(n) % 16,
                                np.arange(n) + 500,
                                np.zeros((n, 8), np.float32)))
    shipped = sum(len(cols["row_key"])
                  for segs in q.export_state(since=lengths)[
                      "segments"].values()
                  for cols in segs.values())
    assert shipped == n


def test_journal_roundtrip_delta_encoding():
    from repro_torch.durability.journal import _delta_decode, _delta_encode
    for a in (np.arange(100, dtype=np.int64) * 7 + 3,
              np.array([5, 4, 3, 9, 2, 8, 1, 7, 0], np.int64),
              np.arange(3, dtype=np.int64),
              np.zeros(0, np.int64),
              np.array([2**40, 2**40 + 1] * 8, np.int64)):
        enc, meta = _delta_encode(a)
        np.testing.assert_array_equal(_delta_decode(enc, meta), a)
        if meta.get("enc") == "d32":
            assert enc.dtype == np.int32
