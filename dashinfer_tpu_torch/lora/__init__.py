from dashinfer_tpu_torch.lora.manager import LoraManager

__all__ = ["LoraManager"]
