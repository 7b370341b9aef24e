from dashinfer_tpu_torch.config.generation_config import GenerationConfig
from dashinfer_tpu_torch.config.model_config import (
    Activation,
    ModelConfig,
    MoEConfig,
    PositionEmbedding,
    RopeScaling,
)
from dashinfer_tpu_torch.config.runtime_config import (
    CacheConfig,
    CacheMode,
    EvictionStrategy,
    QuantConfig,
    RuntimeConfig,
    RuntimeConfigBuilder,
    SchedulingStrategy,
)

__all__ = [
    "Activation",
    "CacheConfig",
    "CacheMode",
    "EvictionStrategy",
    "GenerationConfig",
    "ModelConfig",
    "MoEConfig",
    "PositionEmbedding",
    "QuantConfig",
    "RopeScaling",
    "RuntimeConfig",
    "RuntimeConfigBuilder",
    "SchedulingStrategy",
]
