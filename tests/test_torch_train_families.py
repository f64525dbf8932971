"""The port's training path for the four LM families beside dense and
hybrid, against the JAX package on the CPU: one ``value_and_grad`` and
two ``make_train_step`` steps of each smoke config (rwkv6, qwen2-moe,
qwen2-vl, whisper), with remat off and on — loss, aux, every gradient
leaf, the loss / grad norm / lr of both steps and the parameters and
first moments after them, within 1e-4 (summation order), as
``tests/test_torch_train.py`` holds internlm2 and zamba2 (its helpers, the
same weights and optimizer state carried across). This holds the MoE aux
term in the loss and its gradient, and the gradient of RWKV6's bonus
``u`` and per-channel decay through ``GlaChunkFn``'s recomputed plain
backward."""
import pytest
import torch

from test_torch_train import _close, _paths, _train_step_vs_reference


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-7b", "whisper-small"])
def test_family_train_step_matches_reference(arch, remat):
    pm, grads = _train_step_vs_reference(arch, remat,
                                         lambda a, b, _: _close(a, b, 1e-4))
    named = {path: g for g, (path, _) in zip(grads, _paths(pm.defs))}
    if arch == "rwkv6-7b":
        u = named[("layers", "tm", "u")]
        assert bool(u.abs().sum() > 0)
    if arch == "qwen2-moe-a2.7b":
        router = named[("layers", "moe", "router")]
        assert router.dtype == torch.float32 and bool(router.abs().sum() > 0)
