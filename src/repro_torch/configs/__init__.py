"""Configurations: the paper's own ETL deployment, and the registry of LM
architectures the port serves (importing this package registers
internlm2-1.8b and zamba2-1.2b)."""
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
from repro_torch.configs import internlm2_1_8b, zamba2_1_2b  # noqa: F401
from repro_torch.configs.dod_etl import (ETLConfig, TableConfig,  # noqa: F401
                                         steelworks_config)
