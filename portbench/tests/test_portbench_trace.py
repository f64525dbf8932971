"""The interval arithmetic of the busy, idle, range-share and roofline
readers on synthetic overlapping intervals."""
from __future__ import annotations

import json

import pytest

from conftest import HERE

from portbench import trace, work
from portbench.bench import Run
from portbench.spec import Spec
from conftest import ROOT

PEAK = json.loads((HERE / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
CONF = json.loads((HERE / "configs" / "qwen2-moe-a2.7b.json").read_text())
PREFILL = json.loads((HERE / "traffic" / "prefill_2x2048.json").read_text())


def synthetic() -> trace.Trace:
    # window [0, 100] us; two streams overlap: busy = [10, 40] + [50, 70]
    ops = [("gemm", 10.0, 30.0), ("copy", 20.0, 40.0),
           ("flash_tc_kernel<128>", 50.0, 60.0), ("gemm", 55.0, 70.0),
           ("gemm", 90.0, 130.0)]                    # clipped to [90, 100]
    ranges = {"moe.dispatch": [(5.0, 25.0)], "moe.combine": [(58.0, 65.0)]}
    host = [("aten::mm", 0.0, 12.0), ("cudaStreamSynchronize", 40.0, 88.0),
            ("aten::copy_", 41.0, 45.0)]
    return trace.Trace(ops, ranges, host, (0.0, 100.0))


def run_of(t, conf=CONF, traffic=PREFILL, units=2):
    return Run(conf, traffic, PEAK, 1.0, units, units * 4096, 1.0, [], t)


def test_union_within_and_busy():
    assert trace.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]
    assert trace.within([(0, 10)], [(2, 3), (5, 20)]) == 6
    t = synthetic()
    assert trace.busy(t) == [(10.0, 40.0), (50.0, 70.0), (90.0, 100.0)]
    assert t.window_s == pytest.approx(1e-4)


def test_idle_gaps_by_host_activity():
    gaps = dict(trace.idle_gaps(synthetic()))
    # [0, 10]: aten::mm; [40, 50]: aten::copy_ at 45 (innermost at the
    # middle), [70, 90]: the synchronise
    assert gaps == {"aten::mm": pytest.approx(1e-5),
                    "aten::copy_": pytest.approx(1e-5),
                    "cudaStreamSynchronize": pytest.approx(2e-5)}


def test_top_ops():
    top = dict(trace.top_ops(synthetic()))
    assert top["gemm"] == pytest.approx((20 + 15 + 10) / 1e6)
    assert list(top)[0] == "gemm"


def test_readers():
    spec = Spec(ROOT)
    run = run_of(synthetic())
    idle = spec.reader("device_idle.prefill").read(run)
    assert idle == pytest.approx(100 * (1 - 60 / 100))
    # a family's metrics share one reader
    assert spec.reader("device_idle.train") is spec.reader(
        "device_idle.prefill")
    # moe ranges cover [10, 25] and [58, 65] of the busy time: 22 of 60
    share = spec.reader("moe_share.prefill").read(run)
    assert share == pytest.approx(100 * 22 / 60)
    flops, nbytes = work.flash_call(CONF, 2, 2048)
    roof = spec.reader("flash_roofline.prefill").read(run)
    assert roof == pytest.approx(100 * work.bound_s(flops, nbytes, PEAK)
                                 / 10e-6)
    # the untraced window's 2 units in its 1.0 s, not the traced 100 us
    mfu = spec.reader("mfu.prefill").read(run)
    assert mfu == pytest.approx(100 * 2 * work.forward_flops(CONF, 2, 2048)
                                / 1.0 / 989e12)
    assert spec.reader("mfu.prefill").read(run_of(None)) == mfu


def test_readers_find_nothing_and_say_nothing():
    spec = Spec(ROOT)
    empty = trace.Trace([], {}, [], (0.0, 100.0))
    run = run_of(empty)
    assert spec.reader("moe_share.prefill").read(run) is None
    assert spec.reader("flash_roofline.prefill").read(run) is None
    untraced = run_of(None)
    for name in ("device_idle.prefill", "flash_roofline.prefill",
                 "moe_share.prefill"):
        assert spec.reader(name).read(untraced) is None


def test_end_to_end_readers():
    spec = Spec(ROOT)
    run = Run(CONF, PREFILL, PEAK, 12.5, 10, 40960, 2.0,
              [0.1 * (i + 1) for i in range(10)])
    assert spec.reader("prefill_tokens_per_s").read(run) == 20480
    # 90th percentile of 0.1 .. 1.0 s, linear between ranks: 0.91 s
    assert spec.reader("prefill_ms_p90").read(run) == pytest.approx(910)
    assert spec.reader("setup_s").read(run) == 12.5
    assert spec.reader("train_tokens_per_s").read(run) is None
