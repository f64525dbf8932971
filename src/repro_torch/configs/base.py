"""Model / run configuration system (the JAX package's ``configs/base.py``,
copied: the port imports nothing of it).

One ``ModelConfig`` dataclass covers the architecture families of the
reference: dense decoder-only transformers (GQA/MQA), encoder-decoder,
VLM backbones, attention-free SSMs, MoE transformers and hybrids (zamba2:
Mamba2 + shared attention). The port registers all six, one
architecture per family, as the reference does.

Every architecture registers itself in ``REGISTRY`` via ``register``;
``get_config(arch_id)`` returns the full published config and
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Input-shape suites (assigned): every LM arch is paired with all four.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    """One assigned (seq_len, global_batch) cell and which step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_SUITES: Dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert hidden width
    capacity_factor: float = 1.25
    group_size: int = 2048        # GShard-style dispatch group
    router_aux_weight: float = 1e-2
    n_experts_padded: int = 0     # pad expert dim for EP divisibility
                                  # (dummy experts masked out of routing)

    @property
    def padded_experts(self) -> int:
        return max(self.n_experts_padded, self.n_experts)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 64          # per-head recurrent state width
    n_ssm_heads: int = 0          # heads of the linear recurrence
    conv_kernel: int = 4          # short conv (mamba2); rwkv6 uses token-shift
    expand: int = 2               # mamba2 inner expansion


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0              # fixed encoder context (1500 for whisper)
    # positional scheme: "rope" | "mrope" | "sinusoidal" | "none"
    pos_scheme: str = "rope"
    rope_theta: float = 1e6
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # state-space / linear recurrence
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # which shape suites this arch supports (decode needs a decoder;
    # long_500k needs sub-quadratic sequence mixing)
    supports_decode: bool = True
    subquadratic: bool = False
    # training-side knobs (overridable per run)
    remat: bool = True
    microbatches: int = 8
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/unembedding can
        TP-shard on a 16-way axis (MaxText-style vocab padding; padded logits
        are sliced off before the loss/argmax)."""
        return (self.vocab + 255) // 256 * 256

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops accounting)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        if self.family in ("ssm",):
            # rwkv6: time-mix (r,k,v,g,w projections + lora decay) + channel mix
            tm = 4 * d * d + d * d + 2 * (d * 32 * 2)
            cm = 2 * d * self.d_ff + self.d_ff * d  # actually rwkv cm is 2 mats
            per_layer = tm + cm
        elif self.family == "hybrid":
            ssm = self.ssm or SSMConfig()
            d_in = ssm.expand * d
            nh = ssm.n_ssm_heads or (d_in // ssm.state_size)
            per_layer = (d * (2 * d_in + 2 * ssm.state_size + nh)
                         + d_in * d)                 # mamba2 only (no MLP)
        else:
            per_layer = attn + 3 * d * self.d_ff  # SwiGLU MLP
        total = L * per_layer
        if self.moe is not None and self.moe.n_experts:
            moe_ff = 3 * d * self.moe.d_ff_expert
            dense_ff = 3 * d * self.d_ff
            shared = self.moe.n_shared_experts * moe_ff
            total += L * (self.moe.n_experts * moe_ff + shared - dense_ff)
            total += L * d * self.moe.n_experts  # router
        if self.shared_attn_every:
            # hybrid: one shared attention+mlp block (not per-layer)
            total += attn + 3 * d * self.d_ff
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + 2 * d * self.d_ff)
            total += L * attn  # decoder cross-attention
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.moe is None or not self.moe.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        moe_ff = 3 * d * self.moe.d_ff_expert
        active = self.param_count()
        active -= L * (self.moe.n_experts - self.moe.top_k) * moe_ff
        return int(active)

    def shape_cells(self) -> Tuple[ShapeSuite, ...]:
        cells = [SHAPE_SUITES["train_4k"], SHAPE_SUITES["prefill_32k"]]
        if self.supports_decode:
            cells.append(SHAPE_SUITES["decode_32k"])
            if self.subquadratic:
                cells.append(SHAPE_SUITES["long_500k"])
        return tuple(cells)


REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    REGISTRY[arch] = full
    SMOKE_REGISTRY[arch] = smoke


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]()


def get_smoke_config(arch: str) -> ModelConfig:
    return SMOKE_REGISTRY[arch]()


def list_archs():
    return sorted(REGISTRY)
