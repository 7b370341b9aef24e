"""Decoder-only transformer over the paged KV cache, for dense pre-LN RoPE
models (Qwen2, Llama): counterpart of `dashinfer_tpu.models.transformer`.

Layer params are STACKED (leading dim = num_layers), as in the JAX package;
a Python loop over layers takes the place of `lax.scan`, and the pool is
updated in place. Two entry points:
  decode_forward : [B] one token per slot, paged attention over the pool.
  prefill_forward: [S] one request's prompt; writes pages, attends causally.

A MoE model (Qwen1.5/2-MoE) runs `ops.moe.moe_block` in place of the MLP.
Architectures whose layer math this port does not have yet (ALiBi, learned
positions, GLM, scaled RoPE, QK-norm, MoE models with dense layers, non-gated
MLPs, tied or soft-capped heads) raise NotImplementedError.
"""

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dashinfer_tpu_torch.config import (Activation, CacheMode, ModelConfig,
                                        PositionEmbedding)
from dashinfer_tpu_torch.ops import attention as attn_ops
from dashinfer_tpu_torch.ops import kv_ops
from dashinfer_tpu_torch.ops.linear import linear
from dashinfer_tpu_torch.ops.moe import moe_block
from dashinfer_tpu_torch.ops.norms import rms_norm
from dashinfer_tpu_torch.ops.rotary import (apply_rope, compute_inv_freq,
                                            rope_cos_sin)
from dashinfer_tpu_torch.runtime.kv_cache import KVCache


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for layer math the port does not have."""
    unported = {
        "position embedding": cfg.position_embedding not in (
            PositionEmbedding.ROPE,),
        "rope scaling / logn": (cfg.rope_scaling.kind != "none" or
                                cfg.rope_scaling.use_logn_attn),
        "partial or interleaved rotary": (
            cfg.rotary_dim not in (0, cfg.head_dim) or cfg.rope_interleaved),
        "GLM structure": (cfg.rope_glm_2d or cfg.prefix_lm or
                          bool(cfg.glm_residual_alpha)),
        "QK-norm": cfg.qk_norm,
        "MoE with dense layers (mlp_only_layers)": (
            cfg.moe is not None and bool(cfg.moe.mlp_only_layers)),
        "parallel residual": cfg.parallel_residual,
        "activation": cfg.activation != Activation.SILU,
        "tied embeddings": cfg.tie_word_embeddings,
        "logit soft-cap": bool(cfg.final_logit_softcap),
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(
            f"{cfg.arch}: {', '.join(missing)} not ported to the PyTorch "
            "package yet")


def _layer(params: Dict, l: int) -> Dict:
    """Layer l's view of the stacked layer tree."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[l]
    return take(params["layers"])


def _qkv(cfg: ModelConfig, lp: Dict, x: torch.Tensor, use_kernel: bool):
    T = x.shape[0]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, lp["q_proj"], use_kernel=use_kernel).reshape(T, H, D)
    k = linear(x, lp["k_proj"], use_kernel=use_kernel).reshape(T, KH, D)
    v = linear(x, lp["v_proj"], use_kernel=use_kernel).reshape(T, KH, D)
    return q, k, v


def _mlp(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
         use_kernel: bool) -> torch.Tensor:
    if cfg.moe is not None:
        return moe_block(cfg, x, lp, use_kernel=use_kernel)
    g = linear(x, lp["gate_proj"], use_kernel=use_kernel)
    u = linear(x, lp["up_proj"], use_kernel=use_kernel)
    return linear(F.silu(g) * u, lp["down_proj"], use_kernel=use_kernel)


def _block(cfg: ModelConfig, lp: Dict, hidden: torch.Tensor, attend,
           use_kernel: bool) -> torch.Tensor:
    """One pre-LN layer; attend(q, k, v) -> [T, H*D] does RoPE, the cache
    write and attention."""
    x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, lp, x, use_kernel)
    attn_out = linear(attend(q, k, v), lp["o_proj"], use_kernel=use_kernel)
    h = hidden + attn_out
    x2 = rms_norm(h, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    return h + _mlp(cfg, lp, x2, use_kernel)


def _lm_logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
               use_kernel: bool) -> torch.Tensor:
    """hidden: [T, hidden] -> f32 logits [T, vocab]."""
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return linear(hidden, params["lm_head"], out_dtype=torch.float32,
                  use_kernel=use_kernel).float()


def decode_forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   cache: KVCache, page_tables: torch.Tensor,
                   lens_before: torch.Tensor, active: torch.Tensor,
                   *, mode: CacheMode, use_kernel: bool = True
                   ) -> Tuple[torch.Tensor, KVCache]:
    """tokens: [B] int; page_tables: [B, maxP] int32 LOGICAL page ids
    (logical page g owns physical pool rows g*L + l per layer l);
    lens_before: [B] int32 tokens already cached (the new token's position);
    active: [B] bool. Reads nothing back to the host, so a CUDA graph can
    capture it. Returns (logits [B, vocab] f32, cache updated in place)."""
    check_supported(cfg)
    B = tokens.shape[0]
    ps = cache.page_size
    L = cfg.num_layers
    dev = tokens.device
    hidden = params["embed_tokens"]["w"][tokens.long()]
    cos, sin = rope_cos_sin(lens_before, compute_inv_freq(cfg, dev))
    lens_after = torch.where(active, lens_before + 1, 0).to(torch.int32)
    page_col = (lens_before // ps).long().clamp(0, page_tables.shape[1] - 1)
    offsets = (lens_before % ps).long()
    pt0 = page_tables * L                                   # layer 0 rows
    page0 = torch.gather(pt0.long(), 1, page_col[:, None])[:, 0]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    for l in range(L):
        pt_l = (pt0 + l).to(torch.int32)

        def attend(q, k, v):
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            kv_ops.append_decode_kv(cache, mode, k, v, page0 + l, offsets,
                                    active)
            out = attn_ops.paged_attention(q, cache, mode, pt_l, lens_after,
                                           scale, use_kernel=use_kernel)
            return out.reshape(B, -1)

        hidden = _block(cfg, _layer(params, l), hidden, attend, use_kernel)
    return _lm_logits(cfg, params, hidden, use_kernel), cache


def prefill_forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    cache: KVCache, page_table: torch.Tensor,
                    prefix_len: int, total_len: int,
                    *, mode: CacheMode, use_kernel: bool = True
                    ) -> Tuple[torch.Tensor, KVCache]:
    """tokens: [S] the uncached suffix (padded to the bucket size S);
    page_table: [maxPb] LOGICAL pages covering positions [0, S_kv);
    prefix_len: cached-prefix length; total_len: prefix_len + new tokens.
    Returns (last-token logits [vocab] f32, cache updated in place)."""
    check_supported(cfg)
    S = tokens.shape[0]
    num_new = total_len - prefix_len
    L = cfg.num_layers
    KH = cfg.num_kv_heads
    dev = tokens.device
    hidden = params["embed_tokens"]["w"][tokens.long()]
    pos = prefix_len + torch.arange(S, device=dev)
    cos, sin = rope_cos_sin(pos, compute_inv_freq(cfg, dev))
    scale = 1.0 / math.sqrt(cfg.head_dim)

    for l in range(L):
        pt_l = page_table.long() * L + l

        def attend(q, k, v):
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            kv_ops.append_prefill_kv(cache, mode, k, v, pt_l, prefix_len,
                                     num_new)
            k_full, v_full = kv_ops.gather_kv_pages(cache, mode, pt_l, KH)
            out = attn_ops.prefill_attention(q, k_full, v_full, prefix_len,
                                             total_len, scale)
            return out.reshape(S, -1)

        hidden = _block(cfg, _layer(params, l), hidden, attend, use_kernel)
    last = min(max(num_new - 1, 0), S - 1)
    logits = _lm_logits(cfg, params, hidden[last:last + 1], use_kernel)[0]
    return logits, cache
