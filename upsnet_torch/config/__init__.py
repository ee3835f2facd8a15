from upsnet_torch.config.defaults import (
    Config,
    DatasetConfig,
    NetworkConfig,
    TestConfig,
    TrainConfig,
    default_config,
)

__all__ = [
    "Config",
    "DatasetConfig",
    "NetworkConfig",
    "TestConfig",
    "TrainConfig",
    "default_config",
]
