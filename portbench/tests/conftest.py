"""A temporary benchmark root at CPU size: a copy of ``portbench/`` with
tiny configurations and mixes added as files alone (the cells the real
``BENCHMARK.json`` names run on the card only)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 128, "vocab_size": 256,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "reference": "decoder",
}
TINY_DENSE = {**TINY, "name": "tiny-dense", "port_arch": "internlm2-1.8b"}
TINY_MOE = {**TINY, "name": "tiny-moe", "port_arch": "qwen2-moe-a2.7b",
            "num_key_value_heads": 4, "num_experts": 6,
            "num_experts_per_tok": 2, "moe_intermediate_size": 32,
            "shared_expert_intermediate_size": 64, "norm_topk_prob": True,
            "moe_group_size": 32, "moe_capacity_factor": 1.25,
            "router_aux_loss_coef": 0.001, "weight_scale": {"router": 3.0}}
TINY_TRAIN = {"name": "tiny_train", "kind": "train", "batch": 4,
              "seq_len": 32, "microbatches": 2, "remat": True,
              "optimizer": json.loads(
                  (HERE / "traffic" / "train_8x2048.json").read_text()
              )["optimizer"],
              "setup_steps": 3, "checked_steps": 3, "pool": 4,
              "trace_units": 1}
TINY_PREFILL = {"name": "tiny_prefill", "kind": "prefill", "batch": 2,
                "prompt_len": 32, "pool": 16,
                "warmup_requests": 1, "checked_requests": 4,
                "kv_checked_requests": 2, "trace_units": 2}
CELLS = {"tiny-dense.train": ("tiny-dense", "tiny_train",
                              "internlm2-1.8b.train"),
         "tiny-dense.prefill": ("tiny-dense", "tiny_prefill",
                                "internlm2-1.8b.prefill"),
         "tiny-moe.prefill": ("tiny-moe", "tiny_prefill",
                              "qwen2-moe-a2.7b.prefill")}
# The tiny cells' limits, set as the real cells' are, from CPU readings
# at these sizes (5 sound seeds, 8 for the MoE; the float8 control and
# the half-batch fault on 3, 4 for the MoE): train loss 1.8e-4 / control
# 5.9e-4, grad 7.5e-4 / 4.5e-3, change 2.5e-3 / fault 0.086; prefill K/V
# 5.1e-3 / 0.060 (dense); MoE second layer 0.014 / 0.085, median token
# 0.0055 / 0.066. The served tokens of a 256-word vocabulary matched the
# reference's best on nearly every sound and control run; their limits
# are the real cells'.
TINY_LIMITS = {"tiny-dense.train": {"loss_gap": 3.5e-4, "grad_gap": 2e-3,
                                    "change_gap": 1e-2},
               "tiny-dense.prefill": {"token_gap": 0.18, "kv_err": 0.02},
               "tiny-moe.prefill": {"token_p90": 0.45, "kv_med": 0.02,
                                    "kv_err_l1": 0.05}}


def make_root(base: Path) -> Path:
    """``base`` holding BENCHMARK.json with the tiny cells added and a copy
    of portbench/ with their files; each tiny cell reports the metrics of
    the real cell of its kind."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(HERE, base / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = base / "portbench"
    for conf in (TINY_DENSE, TINY_MOE):
        (pb / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"], "source": "test",
                                 "file": f"portbench/configs/{conf['name']}"
                                 ".json", "reduced": [], "why": "test"})
    for mix in (TINY_TRAIN, TINY_PREFILL):
        (pb / "traffic" / f"{mix['name']}.json").write_text(json.dumps(mix))
    for cell, (conf, mix, like) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": mix, "chips": 1, "why": "test"})
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS[cell]))
        for group in ("end_to_end", "per_layer"):
            for m in bench[group]:
                if like in m.get("workloads", []):
                    m["workloads"].append(cell)
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)


@pytest.fixture
def cuda_card():
    """Skips the test where no CUDA card is present (decided here, at run
    time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
