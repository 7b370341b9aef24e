"""Plain rotary position embeddings (RoPE with `rope_theta`, half-split
convention of HF Llama/Qwen); counterpart of the base case of
`dashinfer_tpu.ops.rotary`. NTK, YaRN, logn, mRoPE and GLM 2-D rotary are
not ported yet (models/transformer.py raises for them)."""

from typing import Tuple

import torch

from dashinfer_tpu_torch.config import ModelConfig


def compute_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Per-model inverse frequencies [rotary_dim/2] f32."""
    rotary_dim = cfg.rotary_dim or cfg.head_dim
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=device) / rotary_dim
    return 1.0 / (cfg.rope_theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: int [...] -> cos/sin f32 [..., rotary_dim/2]."""
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., heads, head_dim]; cos/sin: [..., rotary_dim/2] broadcast
    across the heads dim. Only the first rotary_dim dims are rotated."""
    rotary_dim = cos.shape[-1] * 2
    half = rotary_dim // 2
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x_rot = x[..., :rotary_dim].float()
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    if rotary_dim < x.shape[-1]:
        out = torch.cat([out, x[..., rotary_dim:]], dim=-1)
    return out
