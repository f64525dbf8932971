"""whisper-small [audio]: enc-dec, 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865, conv frontend stubbed (input_specs provides frame embeddings).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="whisper-small",
        family="encdec",
        n_layers=12,             # decoder layers
        n_enc_layers=12,
        enc_seq=1500,            # 30 s audio -> 1500 frames post conv stem
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=51865,
        pos_scheme="sinusoidal",
        supports_decode=True,
        subquadratic=False,
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="whisper-small-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=16,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        pos_scheme="sinusoidal",
        tie_embeddings=True,
        microbatches=1,
        remat=False,
    )


register("whisper-small", full, smoke)
