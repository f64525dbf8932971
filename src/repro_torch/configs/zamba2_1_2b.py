"""zamba2-1.2b [hybrid]: 38L d_model=2048 Mamba2 backbone + one shared
attention block (32H kv=32) applied periodically, d_ff=8192, vocab=32000,
ssm_state=64. Sub-quadratic backbone: runs long_500k.
[arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32000,
        rope_theta=1e4,
        ssm=SSMConfig(state_size=64, n_ssm_heads=64, expand=2, conv_kernel=4),
        shared_attn_every=6,     # shared block applied every 6 mamba layers
        supports_decode=True,
        subquadratic=True,
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm=SSMConfig(state_size=16, n_ssm_heads=4, expand=2, conv_kernel=4),
        shared_attn_every=2,
        subquadratic=True,
        microbatches=1,
        remat=False,
    )


register("zamba2-1.2b", full, smoke)
