"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408,
60 routed experts top-4 + 4 shared, vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=151936,
        rope_theta=1e6,
        moe=MoEConfig(
            n_experts=60,
            top_k=4,
            n_shared_experts=4,
            d_ff_expert=1408,
            n_experts_padded=64,   # EP over a 16-way axis; 4 dummy experts
        ),
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=256,
        moe=MoEConfig(n_experts=6, top_k=2, n_shared_experts=2,
                      d_ff_expert=64, group_size=64),
        microbatches=1,
        remat=False,
    )


register("qwen2-moe-a2.7b", full, smoke)
