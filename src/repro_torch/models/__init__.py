"""The LM substrate's serving side: the dense (internlm2) and hybrid
(zamba2) model families, in plain torch around the hand-written
``flash_attention`` and ``gla_chunk`` kernels."""
from repro_torch.models.model import Model, build_model  # noqa: F401
