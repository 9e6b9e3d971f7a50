"""Model configurations of the LM path (counterpart of `repro.configs`)."""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      active_param_count, param_count,
                                      reduced)
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)

__all__ = ["ARCH_IDS", "AttentionConfig", "ModelConfig",
           "active_param_count", "get_config", "get_smoke_config",
           "param_count", "reduced"]
