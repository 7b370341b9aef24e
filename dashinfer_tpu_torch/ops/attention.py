"""Attention paths: paged decode attention + prefill attention.

Counterpart of `dashinfer_tpu.ops.attention`. Decode attention dispatches to
the paged-attention kernel wrapper (ops/paged_attention.py); `prefill_attention`
is plain PyTorch (einsum + masked softmax), as it is plain jnp in the JAX
package.
"""

import torch

from dashinfer_tpu_torch.config import CacheMode
from dashinfer_tpu_torch.ops import kv_ops
from dashinfer_tpu_torch.ops import paged_attention as _pa
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

_NEG_INF = torch.finfo(torch.float32).min


def paged_attention_ref(q: torch.Tensor, cache: KVCache, mode: CacheMode,
                        page_tables: torch.Tensor, lens: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Reference decode attention by gather + dequantize + softmax, the
    JAX package's `paged_attention_ref`: q [B, H, D]; page_tables [B, maxP]
    physical page ids; lens [B] (> 0). Returns [B, H, D] in q.dtype."""
    B, H, D = q.shape
    KH = _pa._kv_heads(cache, D)
    G = H // KH
    S = page_tables.shape[1] * cache.page_size
    k, v = kv_ops.gather_kv_pages(cache, mode, page_tables, KH)  # [B,S,KH,D]
    qf = q.float().reshape(B, KH, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(scores, dim=-1), v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention(q: torch.Tensor, cache: KVCache, mode: CacheMode,
                    page_tables: torch.Tensor, lens: torch.Tensor,
                    scale: float, use_kernel: bool = True) -> torch.Tensor:
    """Decode attention: the kernel wrapper (which itself takes the plain
    version for CPU tensors), or with `use_kernel=False` the plain version
    on any device."""
    fn = _pa.paged_attention if use_kernel else _pa.paged_attention_plain
    return fn(q, cache, mode, page_tables, lens, scale)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_start: int, kv_valid: int,
                      scale: float) -> torch.Tensor:
    """Causal attention for a prefill chunk over a (prefix + chunk) KV.

    q: [T, H, D] at sequence positions q_start + t; k/v: [S, KH, D] at
    positions 0..S-1, entries >= kv_valid are padding. Query t sees keys
    with pos <= q_start + t and pos < kv_valid."""
    T, H, D = q.shape
    S, KH, _ = k.shape
    G = H // KH
    qf = q.float().reshape(T, KH, G, D)
    scores = torch.einsum("thgd,shd->hgts", qf, k.float()) * scale
    kpos = torch.arange(S, device=q.device)
    qpos = q_start + torch.arange(T, device=q.device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < kv_valid)
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    out = torch.einsum("hgts,shd->thgd", torch.softmax(scores, dim=-1),
                       v.float())
    return out.reshape(T, H, D).to(q.dtype)
