"""Attention paths: paged decode attention + prefill attention.

Counterpart of `dashinfer_tpu.ops.attention`. Decode attention dispatches to
the paged-attention kernel wrapper (ops/paged_attention.py); `prefill_attention`
is plain PyTorch (einsum + masked softmax), as it is plain jnp in the JAX
package. ALiBi (`alibi`: the per-head slopes, `alibi_slopes`) adds
slope_h * (k_pos - q_pos) to each score after the scale; decode attention
with slopes takes the plain version, as in the JAX package (the per-op
kernel has no ALiBi there either).
"""

import functools
import math

import torch

from dashinfer_tpu_torch.config import CacheMode
from dashinfer_tpu_torch.ops import kv_ops
from dashinfer_tpu_torch.ops import paged_attention as _pa
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

_NEG_INF = torch.finfo(torch.float32).min


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """The canonical ALiBi slopes [num_heads] f32 (the JAX package's
    `models.transformer.alibi_slopes`): the power-of-two slopes of the
    largest power of two n <= num_heads, then every other slope of 2n."""
    n = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
    slopes = [base ** (i + 1) for i in range(n)]
    if n < num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * n) - 3)))
        slopes += [extra_base ** (2 * i + 1) for i in range(num_heads - n)]
    return torch.tensor(slopes, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def slopes_on(num_heads: int, device: torch.device, first: int = 0,
              count: int = 0) -> torch.Tensor:
    """Heads [first, first + count) of `alibi_slopes(num_heads)` (all of
    them when count is 0) on `device`, made once: a captured forward reads
    the same tensor, and makes no host copy."""
    s = alibi_slopes(num_heads)
    return s[first:first + (count or num_heads)].to(device)


def paged_attention_ref(q: torch.Tensor, cache: KVCache, mode: CacheMode,
                        page_tables: torch.Tensor, lens: torch.Tensor,
                        scale: float,
                        alibi: torch.Tensor = None) -> torch.Tensor:
    """Reference decode attention by gather + dequantize + softmax, the
    JAX package's `paged_attention_ref`: q [B, H, D]; page_tables [B, maxP]
    physical page ids; lens [B] (> 0); `alibi` [H] f32 slopes, the query at
    position lens - 1. Returns [B, H, D] in q.dtype."""
    B, H, D = q.shape
    KH = _pa._kv_heads(cache, D)
    G = H // KH
    S = page_tables.shape[1] * cache.page_size
    k, v = kv_ops.gather_kv_pages(cache, mode, page_tables, KH)  # [B,S,KH,D]
    qf = q.float().reshape(B, KH, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k) * scale
    pos = torch.arange(S, device=q.device)
    if alibi is not None:
        q_pos = (lens - 1)[:, None, None, None]
        scores = scores + alibi.reshape(1, KH, G, 1) * (pos - q_pos)
    mask = pos[None, :] < lens[:, None]
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(scores, dim=-1), v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention(q: torch.Tensor, cache: KVCache, mode: CacheMode,
                    page_tables: torch.Tensor, lens: torch.Tensor,
                    scale: float, use_kernel: bool = True,
                    alibi: torch.Tensor = None) -> torch.Tensor:
    """Decode attention: the kernel wrapper (which itself takes the plain
    version for CPU tensors), or with `use_kernel=False` the plain version
    on any device; with ALiBi slopes the reference (`paged_attention_ref`),
    as the JAX package's dispatch does."""
    if alibi is not None:
        return paged_attention_ref(q, cache, mode, page_tables, lens, scale,
                                   alibi)
    fn = _pa.paged_attention if use_kernel else _pa.paged_attention_plain
    return fn(q, cache, mode, page_tables, lens, scale)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_start: int, kv_valid: int,
                      scale: float, alibi: torch.Tensor = None
                      ) -> torch.Tensor:
    """Causal attention for a prefill chunk over a (prefix + chunk) KV.

    q: [T, H, D] at sequence positions q_start + t; k/v: [S, KH, D] at
    positions 0..S-1, entries >= kv_valid are padding. Query t sees keys
    with pos <= q_start + t and pos < kv_valid. `alibi`: [H] f32 slopes."""
    T, H, D = q.shape
    S, KH, _ = k.shape
    G = H // KH
    qf = q.float().reshape(T, KH, G, D)
    scores = torch.einsum("thgd,shd->hgts", qf, k.float()) * scale
    kpos = torch.arange(S, device=q.device)
    qpos = q_start + torch.arange(T, device=q.device)
    if alibi is not None:
        scores = scores + alibi.reshape(KH, G, 1, 1) * (
            kpos[None, :] - qpos[:, None])
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < kv_valid)
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    out = torch.einsum("hgts,shd->thgd", torch.softmax(scores, dim=-1),
                       v.float())
    return out.reshape(T, H, D).to(q.dtype)
