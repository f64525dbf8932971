"""rwkv6-7b (Finch) [ssm]: 32L d_model=4096 attention-free, d_ff=14336
vocab=65536, data-dependent decay. Sub-quadratic: runs long_500k.
[arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,             # wkv heads (head_size 64)
        n_kv_heads=64,
        d_ff=14336,
        vocab=65536,
        pos_scheme="none",
        ssm=SSMConfig(state_size=64, n_ssm_heads=64),
        supports_decode=True,
        subquadratic=True,
        source="arXiv:2404.05892",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="rwkv6-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        pos_scheme="none",
        ssm=SSMConfig(state_size=16, n_ssm_heads=4),
        subquadratic=True,
        microbatches=1,
        remat=False,
    )


register("rwkv6-7b", full, smoke)
