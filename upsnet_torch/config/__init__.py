from upsnet_torch.config.defaults import (
    Config,
    DatasetConfig,
    NetworkConfig,
    TestConfig,
    TrainConfig,
    default_config,
)
from upsnet_torch.config.loader import load_config, update_config

__all__ = [
    "Config",
    "DatasetConfig",
    "NetworkConfig",
    "TestConfig",
    "TrainConfig",
    "default_config",
    "load_config",
    "update_config",
]
