"""The port's ``manual_dp`` against the JAX package's
``make_manual_dp_train_step``: two gloo ranks on the CPU (a data axis of
2, no model axis) and the reference on an Auto (data 2, model 1) mesh of
host devices, f32 smoke configs of internlm2 and qwen2-moe, two steps
from one warm optimizer state (seeded moments at step 3). The reference
runs once per session for this file and ``tests/test_torch_tp_train.py``
(``shared_reference``: the same weights and batch).

After each step the metrics ``loss`` and ``grad_norm`` agree within 1e-5
relative, and every updated parameter within 1e-5. The reference reports
``loss`` as cross-entropy plus aux, the mean over the data shards of
each shard's microbatches (its forward runs under ``NULL_CTX`` inside
``shard_map``, so qwen2-moe's load balance is the shard's): the port's
step reports the same.
"""
import multiprocessing
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_tp_train import (DP_ONLY_ARCHS, OPT, REF_STEPS, WARM_STEP,
                                 free_ports, ref_tree, shared_reference)

from repro_torch.models import build_model
from repro_torch.models.param import tree_leaves

ARCHS = list(DP_ONLY_ARCHS)
WORLD, STEPS, TOL = 2, REF_STEPS, 1e-5
JOB = f"dp:{WORLD}x1"


def _rank_main(rank: int, port: int, ref_dir: str, out) -> None:
    import torch.distributed as dist
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        res = {}
        for arch in ARCHS:
            model = build_model(arch, smoke=True)
            z = np.load(Path(ref_dir) / f"{arch}.npz")
            params = ref_tree(model, z, "param")
            mine = {k: torch.from_numpy(z[k]).long().chunk(WORLD)[rank]
                    for k in ("tokens", "targets")}
            opt = manual_dp.init_shard_state(params)
            lay = manual_dp.FlatLayout(params, WORLD, rank)
            for name, shard in (("mu", opt.mu), ("nu", opt.nu)):
                shard.copy_(lay.mine(lay.flat(tree_leaves(
                    ref_tree(model, z, name)), torch.float32)))
            opt = opt._replace(step=torch.tensor(WARM_STEP,
                                                 dtype=torch.int32))
            step = manual_dp.make_manual_dp_train_step(
                model, AdamWConfig(**OPT))
            steps = []
            for _ in range(STEPS):
                params, opt, met = step(params, opt, mine)
                steps.append({"metrics": {k: float(v)
                                          for k, v in met.items()},
                              "params": [p.numpy().copy() for p in
                                         tree_leaves(params)]})
            res[arch] = steps
        out.put((rank, res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = shared_reference(tmp_path_factory)
    mp = multiprocessing.get_context("spawn")
    q = mp.Queue()
    port = free_ports(1)[0]
    procs = [mp.Process(target=_rank_main, args=(r, port, str(ref), q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=300) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return ref, got


@pytest.mark.parametrize("arch", ARCHS)
def test_manual_dp_matches_reference_step(arch, runs):
    ref, got = runs
    z = np.load(Path(ref) / f"{arch}.npz")
    n = len(tree_leaves(build_model(arch, smoke=True).defs))
    for rank in range(WORLD):
        for t, step in enumerate(got[rank][arch]):
            for key in ("loss", "grad_norm"):
                want = float(z[f"{JOB}/{t}/{key}"])
                assert step["metrics"][key] == pytest.approx(
                    want, rel=TOL), (arch, rank, t, key)
            for i in range(n):
                np.testing.assert_allclose(
                    step["params"][i], z[f"{JOB}/{t}/param/{i}"], rtol=TOL,
                    atol=TOL, err_msg=f"{arch} rank {rank} step {t} leaf {i}")
