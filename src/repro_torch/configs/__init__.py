"""Model configurations of the LM path (counterpart of `repro.configs`)."""
from repro_torch.configs.base import (AttentionConfig, EncoderConfig,
                                      HybridConfig, MLAConfig, ModelConfig,
                                      MoEConfig, SSMConfig, VisionConfig,
                                      active_param_count, param_count,
                                      reduced)
from repro_torch.configs.registry import (ARCH_IDS, all_configs, get_config,
                                          get_smoke_config)

__all__ = ["ARCH_IDS", "AttentionConfig", "EncoderConfig", "HybridConfig",
           "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "VisionConfig", "active_param_count", "all_configs", "get_config",
           "get_smoke_config", "param_count", "reduced"]
