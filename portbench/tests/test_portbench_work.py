"""The FLOP and byte counts against numbers worked by hand from the
published sizes."""
from __future__ import annotations

import json

from conftest import HERE

from portbench import work

INTERNLM2 = json.loads((HERE / "configs" / "internlm2-1.8b.json").read_text())
QWEN = json.loads((HERE / "configs" / "qwen2-moe-a2.7b.json").read_text())
PEAK = json.loads((HERE / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]


def test_active_params_internlm2():
    # per layer: q 2048x2048, k and v 2048x1024, o 2048x2048, SwiGLU
    # 3 x 2048 x 8192, two norms of 2048
    layer = 4_194_304 + 2 * 2_097_152 + 4_194_304 + 50_331_648 + 4_096
    total = 24 * layer + 2 * 92_544 * 2_048 + 2_048
    assert total == 1_889_110_016
    assert work.active_params(INTERNLM2) == total


def test_active_params_qwen2_moe():
    # per layer: attention 4 x 2048^2, 4 routed experts 3 x 2048 x 1408
    # each, the shared expert 3 x 2048 x 5632, router 2048 x 60, 2 norms
    layer = 16_777_216 + 4 * 8_650_752 + 34_603_008 + 122_880 + 4_096
    total = 24 * layer + 2 * 151_936 * 2_048 + 2_048
    assert total == 2_688_976_896
    assert work.active_params(QWEN) == total


def test_attention_and_step_flops():
    # causal pairs of 2048 positions: 2048 * 2049 / 2 = 2,098,176
    pairs = 2_098_176
    att = 24 * 8 * 4 * 16 * 128 * pairs
    assert work.attention_flops(INTERNLM2, 8, 2048) == att
    fwd = 2 * 1_889_110_016 * 8 * 2048 + att
    assert work.forward_flops(INTERNLM2, 8, 2048) == fwd
    assert work.train_flops(INTERNLM2, 8, 2048) == 3 * fwd
    assert work.forward_flops(QWEN, 2, 2048) == (
        2 * 2_688_976_896 * 4096 + 24 * 2 * 4 * 16 * 128 * pairs)


def test_flash_call_and_bound():
    flops, nbytes = work.flash_call(INTERNLM2, 1, 2048)
    assert flops == 4 * 16 * 128 * 2_098_176 == 17_188_257_792
    # q and out 2048 x 16 x 128, k and v 2048 x 8 x 128, bf16
    assert nbytes == 2 * 2048 * 128 * (2 * 16 + 2 * 8) == 25_165_824
    # compute-bound: 17.19 GFLOP / 989 TFLOP/s > 25.2 MB / 3.35 TB/s
    assert work.bound_s(flops, nbytes, PEAK) == flops / 989e12
    qf, qb = work.flash_call(QWEN, 2, 2048)
    assert qf == 2 * 17_188_257_792
    assert qb == 2 * 2 * 2048 * 128 * 64
