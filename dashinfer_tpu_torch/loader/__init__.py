from dashinfer_tpu_torch.loader.convert import params_from_numpy, torch_dtype
from dashinfer_tpu_torch.loader.quantize import quantize_params, quantize_weight

__all__ = ["params_from_numpy", "quantize_params", "quantize_weight",
           "torch_dtype"]
