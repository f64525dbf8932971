"""The LM substrate: every model family of the JAX package (dense, moe,
vlm, ssm, hybrid, encdec), served and trained in plain torch around the
hand-written ``flash_attention`` and ``gla_chunk`` kernels."""
from repro_torch.models.model import Model, build_model  # noqa: F401
