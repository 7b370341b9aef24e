"""Paged ("span") KV-cache pool.

The same page-major layout as `dashinfer_tpu.runtime.kv_cache`, so pools can
be compared element by element:

  k/v: `[num_pages, page_size, kv_heads * Ds]` (Ds = head_dim, or
  head_dim // 2 for packed uint4), flat across layers and heads. A request's
  logical page `g` owns the `num_layers` physical pages `g*L + l`.
  k_qparams/v_qparams (INT8 / UINT4 only): `[num_pages, 2*kv_heads, QL]`
  f32; row 2h is head h's per-token scale, row 2h+1 its zero, token t at
  lane t.

The JAX package pads QL to a multiple of 128 (a Mosaic tiling artifact); the
port keeps QL = page_size. The pool is allocated once and updated in place
(ops/kv_ops.py), where the JAX package relies on buffer donation.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from dashinfer_tpu_torch.config import CacheConfig, CacheMode, ModelConfig


@dataclasses.dataclass
class KVCache:
    """Device-side paged KV pool."""

    k: torch.Tensor
    v: torch.Tensor
    k_qparams: Optional[torch.Tensor]
    v_qparams: Optional[torch.Tensor]

    @property
    def num_pages(self) -> int:
        return self.k.shape[0]

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    def clone(self) -> "KVCache":
        return KVCache(*(None if t is None else t.clone() for t in
                         (self.k, self.v, self.k_qparams, self.v_qparams)))


def cache_dtype_and_dim(mode: CacheMode, head_dim: int,
                        model_dtype: torch.dtype) -> Tuple:
    """(storage dtype, storage head_dim per head, is_quantized)."""
    if mode == CacheMode.DEFAULT:
        return model_dtype, head_dim, False
    if mode == CacheMode.INT8:
        return torch.int8, head_dim, True
    if mode == CacheMode.UINT4:
        return torch.uint8, head_dim // 2, True
    raise ValueError(mode)


def create_kv_cache(model_cfg: ModelConfig, cache_cfg: CacheConfig,
                    num_physical_pages: int, model_dtype: torch.dtype,
                    device) -> KVCache:
    """Allocate the pool. `num_physical_pages` counts per-layer pages (the
    allocator hands out `num_layers` of them per logical sequence page)."""
    kh = model_cfg.num_kv_heads
    dtype, dim, quant = cache_dtype_and_dim(cache_cfg.mode,
                                            model_cfg.head_dim, model_dtype)
    shape = (num_physical_pages, cache_cfg.page_size, kh * dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    kq = vq = None
    if quant:
        qshape = (num_physical_pages, 2 * kh, cache_cfg.page_size)
        kq = torch.zeros(qshape, dtype=torch.float32, device=device)
        vq = torch.zeros(qshape, dtype=torch.float32, device=device)
    return KVCache(k=k, v=v, k_qparams=kq, v_qparams=vq)


def physical_page_bytes(model_cfg: ModelConfig, cache_cfg: CacheConfig,
                        model_dtype: torch.dtype) -> int:
    """Bytes of K+V pool held by ONE physical page (one layer's span)."""
    dtype, dim, quant = cache_dtype_and_dim(cache_cfg.mode,
                                            model_cfg.head_dim, model_dtype)
    kh, ps = model_cfg.num_kv_heads, cache_cfg.page_size
    itemsize = torch.empty((), dtype=dtype).element_size()
    payload = 2 * kh * ps * dim * itemsize
    qparams = 2 * 2 * kh * ps * 4 if quant else 0
    return payload + qparams


def logical_page_bytes(model_cfg: ModelConfig, cache_cfg: CacheConfig,
                       model_dtype: torch.dtype) -> int:
    """Bytes per logical sequence page (= num_layers physical pages); the
    unit of admission accounting."""
    return model_cfg.num_layers * physical_page_bytes(model_cfg, cache_cfg,
                                                      model_dtype)
