"""The production train setting against the JAX package, and the depths
``chip_smoke.py`` trains the large families at on one card.

``make_train_step`` of each family's smoke config as the card trains it
— remat on, a batch of 8 in 4 microbatches — on both sides from the same
f32 weights and warm optimizer state (``from_reference``,
``opt_from_reference``): every microbatch's loss and MoE aux, then one
step's loss, grad norm, lr, updated parameters and first moments within
1e-4 (summation order), as ``tests/test_torch_train_families.py`` holds
one microbatch. Several microbatches split the MoE's aux term and
whisper's frames per microbatch; the mean over them is what the step
differentiates.

Then the cuts: ``chip_smoke.py``'s ``TRAIN_CUTS`` names, for rwkv6-7b,
qwen2-vl-7b and qwen2-moe-a2.7b, the deepest depth at which the dry run
(``launch.dryrun``, traced on ``meta``) reckons the peak of a full-width
train step of 8 x 2048 tokens in 8 microbatches with remat at most
``TRAIN_CUT_GIB``; one layer more must reckon above it. whisper-small
trains whole (8 x 416 tokens, 1500 frames each) and fits. The constants
are read from the script's source: importing it would block JAX in this
process.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (OPT, _batch, _close, _leaf_pairs, _weights,
                              f32_ratios)  # noqa: F401 (a fixture)

from repro.models import build_model as jax_build_model
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import AdamWState as JaxAdamWState
from repro.train.train_step import make_loss_fn as jax_make_loss_fn
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import ShapeSuite
from repro_torch.launch import dryrun
from repro_torch.models import Model, build_model
from repro_torch.models.convert import from_reference, opt_from_reference
from repro_torch.optim import AdamWConfig
from repro_torch.train.train_step import make_loss_fn, make_train_step

ARCHS = ("internlm2-1.8b", "zamba2-1.2b", "rwkv6-7b", "qwen2-moe-a2.7b",
         "qwen2-vl-7b", "whisper-small")
MICROBATCHES, BATCH = 4, 8


def _smoke_cfg(build, arch):
    return dataclasses.replace(build(arch, smoke=True).cfg, remat=True,
                               microbatches=MICROBATCHES)


@pytest.mark.parametrize("arch", ARCHS)
def test_production_train_setting_matches_reference(arch, f32_ratios):
    """zamba2's Mamba2 layers on the reference's side at f32 decay
    ratios (the port's precision), as in tests/test_torch_train.py."""
    p_np, (step, mu, nu) = _weights(arch)
    jm = JaxModel(_smoke_cfg(jax_build_model, arch))
    pm = Model(_smoke_cfg(build_model, arch))
    jp = jax.tree.map(jnp.asarray, p_np)
    js = JaxAdamWState(jnp.asarray(step), jax.tree.map(jnp.asarray, mu),
                       jax.tree.map(jnp.asarray, nu))
    pp = from_reference(pm.defs, p_np)
    ps = opt_from_reference(pm.defs, (step, mu, nu))
    bt, bj = _batch(pm.cfg, b=BATCH)
    # every microbatch's loss and aux: rows [i * 2, i * 2 + 2) on both
    n = BATCH // MICROBATCHES
    jloss = jax.jit(jax_make_loss_fn(jm))
    for i in range(MICROBATCHES):
        rows = slice(i * n, (i + 1) * n)
        with torch.no_grad():
            _, (loss, aux) = make_loss_fn(pm)(
                pp, {k: v[rows] for k, v in bt.items()})
        _, (jl, ja) = jloss(jp, {k: v[rows] for k, v in bj.items()})
        _close(loss, jl, 1e-4)
        _close(aux, ja, 1e-4)
    pp, ps, met = make_train_step(pm, AdamWConfig(**OPT))(pp, ps, bt)
    jp, js, jmet = jax.jit(jax_make_train_step(
        jm, JaxAdamWConfig(**OPT)))(jp, js, bj)
    for key in ("loss", "grad_norm", "lr"):
        _close(met[key], jmet[key], 1e-4)
    for a, b in _leaf_pairs(pp, jp) + _leaf_pairs(ps.mu, js.mu):
        _close(a, b, 1e-4)
    assert int(ps.step) == int(js.step) == 6


def _smoke_constants() -> dict:
    """``TRAIN_CUTS`` and ``TRAIN_CUT_GIB`` from chip_smoke.py's source."""
    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id in ("TRAIN_CUTS", "TRAIN_CUT_GIB"):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


@pytest.mark.parametrize("arch,deeper", [
    ("rwkv6-7b", 0), ("rwkv6-7b", 1), ("qwen2-vl-7b", 0),
    ("qwen2-vl-7b", 1), ("qwen2-moe-a2.7b", 0), ("qwen2-moe-a2.7b", 1),
    ("whisper-small", 0)])
def test_train_cut_is_the_deepest_fit(arch, deeper):
    """The cell of chip_smoke.py's phase 10c at its cut (``deeper`` 0)
    reckons a peak of at most ``TRAIN_CUT_GIB``, one layer more (1) above
    it; the families the card trains whole fit whole."""
    consts = _smoke_constants()
    cut, limit = consts["TRAIN_CUTS"][arch], consts["TRAIN_CUT_GIB"] * 2**30
    full = build_model(arch).cfg
    if cut is None:
        assert not deeper
        layers = full.n_layers
    else:
        assert 0 < cut < full.n_layers
        layers = cut + deeper
    seq = 416 if full.family == "encdec" else 2048
    suite = ShapeSuite("phase_train", seq, 8, "train")
    fn, args, meta, comm = dryrun.build_cell(arch, suite.name, suite=suite,
                                             overrides={"n_layers": layers})
    assert meta["microbatches"] == 8
    peak = dryrun.analyze_cell(fn, args, meta, comm)["memory"][
        "peak_estimate_bytes"]
    if deeper:
        assert peak > limit, (arch, layers, peak / 2**30)
    else:
        assert peak <= limit, (arch, layers, peak / 2**30)
