"""The paper's own ETL deployment configuration."""
from repro_torch.configs.dod_etl import (ETLConfig, TableConfig,  # noqa: F401
                                         steelworks_config)
