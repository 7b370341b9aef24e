"""uint4 packing conventions, shared with the JAX package byte for byte.

* KV pages pack HALVES of head_dim: byte j holds dim j (low nibble) and
  dim j + D/2 (high nibble).

* Weights pack TILE-128 halves along the out dim when out % 256 == 0: within
  each 256-col tile t, byte j holds col 256t+j (low) and col 256t+128+j
  (high). For out % 256 != 0 (tiny test models) the layout degrades to plain
  halves across the full out dim; the fused `quant_matmul` kernel then
  declines and the large-M path of ops/linear.py serves the matmul.

Both layouts are deterministic functions of the array shape, so the
quantizer and every consumer agree without metadata. The TILE-128 layout is
kept from the TPU design so that packed checkpoints load unchanged; the
CUDA kernel (csrc/quant_matmul.cu) reads it directly.
"""

import numpy as np
import torch


def pack_u4_kv(q):
    """q: [..., D] uint4 values (numpy or torch uint8) -> [..., D/2] uint8,
    halves packing."""
    D = q.shape[-1]
    return q[..., :D // 2] | (q[..., D // 2:] << 4)


def weight_uses_tile128(n_out: int) -> bool:
    return n_out % 256 == 0


def pack_u4_weight(q):
    """q: [K, N] uint4 values (uint8 storage, numpy or torch) -> [K, N/2]
    uint8 of the same kind."""
    K, N = q.shape
    if weight_uses_tile128(N):
        t = q.reshape(K, N // 256, 2, 128)  # [K, T, lo/hi, 128]
        return (t[:, :, 0] | (t[:, :, 1] << 4)).reshape(K, N // 2)
    lo = q[:, :N // 2]
    hi = q[:, N // 2:]
    out = lo | (hi << 4)
    return out if isinstance(out, torch.Tensor) else out.astype(np.uint8)


def weight_levels(w_q: torch.Tensor) -> torch.Tensor:
    """Quantized payload -> [K, N] integer levels: packed u4 (uint8, either
    layout) or int8 as stored."""
    return unpack_u4_weight(w_q) if w_q.dtype == torch.uint8 else w_q


def unpack_u4_weight(packed: torch.Tensor) -> torch.Tensor:
    """packed: [K, N/2] uint8 -> [K, N] uint8 levels (0..15)."""
    K, half = packed.shape
    N = half * 2
    lo = packed & 0xF
    hi = packed >> 4
    if weight_uses_tile128(N):
        out = torch.cat([lo.reshape(K, N // 256, 128),
                         hi.reshape(K, N // 256, 128)], dim=-1)
        return out.reshape(K, N)
    return torch.cat([lo, hi], dim=-1)
