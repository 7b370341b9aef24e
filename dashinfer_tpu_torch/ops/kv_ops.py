"""KV-cache movement ops: quantize, append, gather (one layer at a time).

Counterpart of `dashinfer_tpu.ops.kv_ops` over the same page-major pool
(runtime/kv_cache.py). The appends update the pool IN PLACE and return it.

Quantization format (asymmetric per-token-per-head scale/zero, fp32), the
same formulas as the JAX package so pools compare element by element:
  int8 : q = round((x-min)/scale) - 128,  x = q*scale + zero, zero = min+128*scale
  uint4: q = round((x-min)/scale),        x = q*scale + zero, zero = min
`torch.round`, like `jnp.round`, rounds half to even.

The JAX package routes inactive or padded tokens to an out-of-bounds page
and lets the scatter drop them (`mode="drop"`); PyTorch indexing raises (CPU)
or device-asserts (CUDA) on such indices. So the prefill append writes only
its valid tokens, and the decode append sends inactive slots to the pool's
LAST physical page, a sink that the page allocator never hands out (the
runtime allocates it on top of the pool); no read ever looks at it. The
decode append thus has static shapes and no device->host read, so it can
be captured in a CUDA graph.
"""

from typing import Optional, Tuple

import torch

from dashinfer_tpu_torch.config import CacheMode
from dashinfer_tpu_torch.ops.u4pack import pack_u4_kv
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

_EPS = 1e-8


def quantize_kv(x: torch.Tensor, mode: CacheMode
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """Quantize along the last (head_dim) axis.

    x: [..., KH, D] float -> (payload [..., KH, Ds], scale [..., KH],
    zero [..., KH]); scale/zero are None in DEFAULT mode.
    """
    if mode == CacheMode.DEFAULT:
        return x, None, None
    xf = x.float()
    xmin = xf.amin(dim=-1)
    xmax = xf.amax(dim=-1)
    if mode == CacheMode.INT8:
        scale = torch.clamp_min((xmax - xmin) / 255.0, _EPS)
        q = torch.clamp(torch.round((xf - xmin[..., None]) / scale[..., None])
                        - 128.0, -128, 127)
        zero = xmin + 128.0 * scale
        payload = q.to(torch.int8)
    elif mode == CacheMode.UINT4:
        scale = torch.clamp_min((xmax - xmin) / 15.0, _EPS)
        q = torch.clamp(torch.round((xf - xmin[..., None]) / scale[..., None]),
                        0, 15).to(torch.uint8)
        zero = xmin
        # HALVES packing per head: byte j = dim j (low) | dim j+D/2 (high)
        payload = pack_u4_kv(q)
    else:
        raise ValueError(mode)
    return payload, scale, zero


def dequantize_page_tokens(payload: torch.Tensor, scale: torch.Tensor,
                           zero: torch.Tensor, mode: CacheMode,
                           out_dtype=torch.float32) -> torch.Tensor:
    """payload [..., KH, Ds], scale/zero [..., KH] -> [..., KH, D] float."""
    if mode == CacheMode.DEFAULT:
        return payload.to(out_dtype)
    if mode == CacheMode.INT8:
        q = payload.float()
    elif mode == CacheMode.UINT4:
        q = torch.cat([(payload & 0xF).float(), (payload >> 4).float()],
                      dim=-1)   # halves packing
    else:
        raise ValueError(mode)
    return (q * scale[..., None] + zero[..., None]).to(out_dtype)


def _flat(payload: torch.Tensor) -> torch.Tensor:
    """[..., KH, Ds] -> [..., KH*Ds]."""
    return payload.reshape(*payload.shape[:-2],
                           payload.shape[-2] * payload.shape[-1])


def _qparam_rows(scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """scale/zero [..., KH] -> [..., 2*KH] in qparams row order
    (row 2h = scale_h, row 2h+1 = zero_h)."""
    return torch.stack([scale, zero], dim=-1).reshape(
        *scale.shape[:-1], 2 * scale.shape[-1])


def _write(cache: KVCache, mode: CacheMode, k, v, pages, offs) -> None:
    kq, ks, kz = quantize_kv(k, mode)
    vq, vs, vz = quantize_kv(v, mode)
    cache.k[pages, offs] = _flat(kq).to(cache.k.dtype)
    cache.v[pages, offs] = _flat(vq).to(cache.v.dtype)
    if ks is not None:
        cache.k_qparams[pages, :, offs] = _qparam_rows(ks, kz)
        cache.v_qparams[pages, :, offs] = _qparam_rows(vs, vz)


def append_decode_kv(cache: KVCache, mode: CacheMode,
                     new_k: torch.Tensor, new_v: torch.Tensor,
                     page_ids: torch.Tensor, offsets: torch.Tensor,
                     active: torch.Tensor) -> KVCache:
    """Append one token's K/V per slot into its current page (one layer).

    new_k/new_v: [B, KH, D]; page_ids/offsets: [B] physical page & in-page
    offset for this layer; inactive slots write into the sink page (see the
    module docstring)."""
    pages = torch.where(active, page_ids, cache.num_pages - 1)
    _write(cache, mode, new_k, new_v, pages, offsets)
    return cache


def append_prefill_kv(cache: KVCache, mode: CacheMode,
                      k: torch.Tensor, v: torch.Tensor,
                      page_row: torch.Tensor, start_pos: int,
                      num_tokens: int) -> KVCache:
    """Write a prefill chunk's K/V into pages (one layer).

    k/v: [T, KH, D] (T = padded bucket length); page_row: [max_pages]
    physical page ids for this layer; token t (< num_tokens) lands at
    sequence position start_pos + t, i.e. page page_row[p // ps] offset
    p % ps. The padded tail t >= num_tokens is not written."""
    ps = cache.page_size
    n = int(num_tokens)
    pos = start_pos + torch.arange(n, device=page_row.device)
    page_idx = torch.clamp(pos // ps, 0, page_row.shape[0] - 1)
    _write(cache, mode, k[:n], v[:n], page_row[page_idx].long(), pos % ps)
    return cache


def gather_kv_pages(cache: KVCache, mode: CacheMode, page_row: torch.Tensor,
                    kv_heads: int, out_dtype=torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + dequantize KV pages into contiguous form.

    page_row: [..., nP] physical page ids. Returns k, v of shape
    [..., nP * ps, KH, D]."""
    lead = page_row.shape[:-1]
    nP = page_row.shape[-1]
    ps = cache.page_size
    idx = page_row.long()

    def gather(pool, qparams):
        x4 = pool[idx].reshape(*lead, nP, ps, kv_heads, -1)
        if qparams is not None:
            qp = qparams[idx][..., :ps]                     # [..., nP, 2KH, ps]
            scale = qp[..., 0::2, :].transpose(-1, -2)      # [..., nP, ps, KH]
            zero = qp[..., 1::2, :].transpose(-1, -2)
            x = dequantize_page_tokens(x4, scale, zero, mode, out_dtype)
        else:
            x = x4.to(out_dtype)
        return x.reshape(*lead, nP * ps, kv_heads, -1)

    return gather(cache.k, cache.k_qparams), gather(cache.v, cache.v_qparams)
