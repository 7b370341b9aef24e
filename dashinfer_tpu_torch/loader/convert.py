"""Param-tree conversion: the JAX package's stacked numpy tree -> tensors.

The tree keeps the JAX package's layout exactly (leading num_layers dim on
every `layers` leaf; linear leaves `{"w"}` or `{"w_q", "scale", "zero"}` plus
optional `"b"`), so one checkpoint conversion serves both packages and the
tests can hand the same arrays to each.
"""

from typing import Dict, Union

import numpy as np
import torch

_QPARAM_KEYS = ("scale", "zero", "scale_g", "zero_g")
# float leaves kept in the dtype the tree gives them: the MoE router and the
# shared expert's gate route in f32 (a bf16 router flips top-k choices on
# near-ties; the JAX package routes with the f32 product, ops/moe.py)
_KEEP_DTYPE = ("router", "shared_expert_gate")


def _leaf_to_tensor(x, key: str, device, dtype: torch.dtype,
                    keep: bool = False) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            # ml_dtypes.bfloat16 has no torch counterpart in from_numpy:
            # carry the bits over as uint16 and reinterpret them
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                 ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point() and not keep:
        # quantization qparams stay f32 (the kernels read them as f32);
        # every other float leaf is held in the model dtype
        t = t.to(torch.float32 if key in _QPARAM_KEYS else dtype)
    # int8 / packed-u4 uint8 payloads travel byte for byte
    return t.to(device).contiguous()


def params_from_numpy(tree: Dict, device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Convert a (nested dict) param tree of numpy / ml_dtypes arrays (or
    tensors) to contiguous tensors on `device`."""

    def walk(node, key="", keep=False):
        if isinstance(node, dict):
            return {k: walk(v, k, keep or k in _KEEP_DTYPE)
                    for k, v in node.items()}
        return _leaf_to_tensor(node, key, device, dtype, keep)

    return walk(tree)


def torch_dtype(name: str) -> torch.dtype:
    """RuntimeConfig.dtype string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
