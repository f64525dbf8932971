"""The plain reference against the program at small sizes on the CPU, in
float32 (both sides on the benchmark's weights), and the reference's
independence from the program."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY_DENSE, TINY_MOE

from portbench import port, weights
from portbench.reference import decoder as ref

PREFILL = {"kind": "prefill"}
TRAIN = {"kind": "train", "microbatches": 1, "remat": False}


def setup(conf, traffic, seed=7):
    m = port.model(conf, traffic)
    layout = port.layout(m)
    tree = weights.nest(weights.draw(layout, seed, torch.device("cpu")))
    f32 = {p: t.float() for p, t in weights.draw(layout, seed,
                                                   torch.device("cpu")).items()}
    return m, tree, weights.nest(f32), ref.Dims.of(conf)


@pytest.mark.parametrize("conf", [TINY_DENSE, TINY_MOE],
                         ids=["dense", "moe"])
def test_prefill_matches_the_program_in_f32(conf):
    m, _, tree, d = setup(conf, PREFILL)
    gen = torch.Generator().manual_seed(3)
    reqs = [torch.randint(0, conf["vocab_size"], (2, 32), generator=gen)
            for _ in range(3)]
    logits, kv = ref.prefill(ref.weights_from(tree, d), d, reqs,
                             keep_kv=(0, 2))
    for i, r in enumerate(reqs):
        got, cache, _ = m.forward(tree, {"tokens": r}, mode="prefill")
        torch.testing.assert_close(got[:, -1], logits[i], rtol=1e-4,
                                   atol=1e-4)
        if i in kv:
            for layer, (k, v) in enumerate(kv[i]):
                torch.testing.assert_close(cache["k"][layer].float(), k,
                                           rtol=1e-2, atol=1e-2)
                torch.testing.assert_close(cache["v"][layer].float(), v,
                                           rtol=1e-2, atol=1e-2)


def test_moe_drops_past_capacity_in_k_major_order():
    """Every token picks both of 2 experts, expert 0 first; a group's
    capacity is int(group * 2 * factor / 2), at least 1, rounded up to a
    multiple of 4."""
    d = ref.Dims(layers=1, hidden=2, heads=1, kv_heads=1, head_dim=2,
                 vocab=4, rope_theta=1.0, eps=1e-5, experts=2, top_k=2,
                 norm_topk=True, group=4, capacity_factor=0.1)
    w = {"router": torch.tensor([[1.0, 0.0], [0.0, 1.0]]),
         "e_gate": torch.ones(2, 2, 1), "e_up": torch.ones(2, 2, 1),
         "e_down": torch.ones(2, 1, 2), "s_gate": torch.zeros(2, 1),
         "s_up": torch.zeros(2, 1), "s_down": torch.zeros(1, 2)}
    t = torch.tensor([[1.0, 0.0]] * 8)
    # groups of 4: capacity 4, each expert gets 4 assignments: all kept
    kept = ref.moe(t, w, d, ref.F32, 8)
    assert (kept != 0).all()
    # one group of 8: capacity still 4; in k-major order the first four
    # tokens fill both experts, the last four are dropped from both
    d8 = ref.Dims(**{**d.__dict__, "group": 8})
    out = ref.moe(t, w, d8, ref.F32, 8)
    torch.testing.assert_close(out[:4], kept[:4])
    assert (out[4:] == 0).all()


def test_training_step_matches_the_program_in_f32():
    conf = TINY_DENSE
    m, _, tree, d = setup(conf, TRAIN)
    from repro_torch.train.train_step import loss_and_grads, make_loss_fn
    from repro_torch.models.param import tree_paths
    gen = torch.Generator().manual_seed(5)
    rows = torch.randint(0, conf["vocab_size"], (1, 33), generator=gen)
    mb = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
    grads, (total, lo, _) = loss_and_grads(make_loss_fn(m), tree, mb)
    params = {k: tree[k].clone().requires_grad_()
              for k in ("embed", "unembed", "final_norm")}
    w = ref.weights_from(tree, d)
    params["layers"] = [{k: t.clone().requires_grad_() for k, t in l.items()}
                        for l in w["layers"]]
    params["embed"] = params["embed"][:d.vocab].detach().requires_grad_()
    params["unembed"] = params["unembed"][:d.vocab].detach().requires_grad_()
    want = ref.loss(params, d, rows[:, :-1], rows[:, 1:], ref.F32)
    torch.testing.assert_close(lo, want.detach(), rtol=1e-5, atol=1e-5)
    want.backward()
    got = dict(zip([p for p, _ in tree_paths(m.defs)], grads))
    torch.testing.assert_close(got["unembed"][:d.vocab], params["unembed"].grad,
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got["layers/attn/wq"][1],
                               params["layers"][1]["wq"].grad,
                               rtol=1e-4, atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.decoder, portbench.work, "
            "portbench.trace, portbench.weights; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}); "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    from portbench import bench
    import repro_torch  # noqa: F401  (the program: its name starts with
    # the JAX package's, and is not it)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert "repro" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in bench.forbidden_modules()
