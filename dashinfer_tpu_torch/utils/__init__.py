from dashinfer_tpu_torch.utils.env import EnvConfig
from dashinfer_tpu_torch.utils.logging import get_logger

__all__ = ["EnvConfig", "get_logger"]
