"""Shared HF -> params conversion helpers: counterpart of the helpers of
`dashinfer_tpu.models.common` that the port's builders use.

The card has no `ml_dtypes`, so no numpy array holds bf16 here: `_to_np`
widens bf16 to f32 (exact; a numpy bf16 array from `ml_dtypes` crosses as
its uint16 bits, as loader/convert.py takes it), the conversion runs in
numpy, and `_cast` returns a CPU tensor of the target dtype (f32 -> bf16
rounds to nearest even, as the `ml_dtypes` cast of the JAX package does).
The tree the builders return holds such tensors, which
`loader.params_from_numpy` takes as they are.
"""

from typing import Dict, List, Union

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _to_np(x) -> np.ndarray:
    """torch tensor / numpy -> numpy; bf16 as f32 (exact)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)
    return a


def _cast(x: np.ndarray, dtype: Union[str, torch.dtype]) -> torch.Tensor:
    """numpy -> a contiguous CPU tensor of `dtype` (a torch dtype or its
    name)."""
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    return torch.from_numpy(np.ascontiguousarray(x)).to(dt).contiguous()


def stack_layer_trees(per_layer: List) -> Dict:
    """Stack a list of per-layer param trees (arbitrary dict nesting, tensor
    or numpy leaves) into one tree with a leading num_layers dim."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: stack_layer_trees([t[k] for t in per_layer])
                for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(per_layer)
    return np.stack(per_layer)
