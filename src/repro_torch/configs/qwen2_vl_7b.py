"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE, dynamic resolution. Backbone only; the vision
frontend is a stub — input_specs() provides precomputed patch embeddings.
[arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab=152064,
        pos_scheme="mrope",
        rope_theta=1e6,
        source="arXiv:2409.12191",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        pos_scheme="mrope",
        microbatches=1,
        remat=False,
    )


register("qwen2-vl-7b", full, smoke)
