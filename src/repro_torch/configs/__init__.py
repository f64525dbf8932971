"""Configurations: the paper's own ETL deployment, and the registry of LM
architectures the port serves (importing this package registers one
architecture per family, as the JAX package does: whisper-small, encdec;
internlm2-1.8b, dense; qwen2-vl-7b, vlm; rwkv6-7b, ssm; qwen2-moe-a2.7b,
moe; zamba2-1.2b, hybrid)."""
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    SHAPE_SUITES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeSuite,
    get_config,
    get_smoke_config,
    list_archs,
)
from repro_torch.configs import (  # noqa: F401
    internlm2_1_8b,
    qwen2_moe_a2_7b,
    qwen2_vl_7b,
    rwkv6_7b,
    whisper_small,
    zamba2_1_2b,
)
from repro_torch.configs.dod_etl import (ETLConfig, TableConfig,  # noqa: F401
                                         steelworks_config)
