"""RMSNorm (reference op `LayerNormNoBeta`); counterpart of
`dashinfer_tpu.ops.norms.rms_norm`. Plain PyTorch: it is no Pallas kernel in
the JAX package either."""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize in f32, scale in f32, return x.dtype (HF Llama/Qwen)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (xf * weight.float()).to(x.dtype)
