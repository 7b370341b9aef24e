"""Decoder-only transformer over the paged KV cache, for dense pre-LN RoPE
models (Qwen2, Llama): counterpart of `dashinfer_tpu.models.transformer`.

Layer params are STACKED (leading dim = num_layers), as in the JAX package;
a Python loop over layers takes the place of `lax.scan`, and the pool is
updated in place. Two entry points:
  decode_forward : [B] one token per slot, paged attention over the pool.
  prefill_forward: [S] one request's prompt; writes pages, attends causally.

A MoE model (Qwen1.5/2-MoE, Qwen3-MoE) runs `ops.moe.moe_block` in place of
the MLP. LoRA (lora/manager.py): `decode_forward` takes the adapter pool and
each row's one-hot slot, `prefill_forward` the pool and the prompt's slot;
the deltas (`apply_lora_batch` / `apply_lora_single`) are added to the
q, k, v and o products and, in a dense model, to gate, up (before SwiGLU)
and down, as in the JAX package (a MoE block takes none). A QK-norm model (Qwen3) RMS-normalizes each q and k head after the
projections and before RoPE, returning the model dtype, as the JAX package's
per-op path does. An ALiBi model (Baichuan-13B) skips RoPE and adds
slope_h * (k_pos - q_pos) to the attention scores (`ops.attention`), with
the canonical slopes of its H heads (`alibi_slopes`).

`tp_decode_forward` / `tp_prefill_forward` are the same forwards over a
model axis: the port's form of the JAX package's XLA-SPMD path, as an
explicit loop over the ranks. Each layer runs every rank's attention half
on its own params and pool (parallel/sharding.py), an all-reduce of the o
partials, every rank's MLP half, an all-reduce of the down partials
(parallel/collectives.py); then the lm_head on each vocab shard and the
gather. The partials are summed in f32. A MoE layer's MLP half is each
rank's share of `moe_block` (its experts, routed over all of them, and its
slice of the shared expert). An ALiBi rank attends with its heads' slice of
the global slope table (all of it when its pool holds every KV head).
Architectures whose layer math this port does not have yet (learned
positions, GLM, scaled RoPE, MoE models with dense layers, non-gated MLPs,
tied or soft-capped heads) raise NotImplementedError.
"""

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from dashinfer_tpu_torch.config import (Activation, CacheMode, ModelConfig,
                                        PositionEmbedding)
from dashinfer_tpu_torch.lora.manager import (apply_lora_batch,
                                              apply_lora_single)
from dashinfer_tpu_torch.ops import attention as attn_ops
# `alibi_slopes` lives beside the attention that reads it; the JAX package
# names it here
from dashinfer_tpu_torch.ops.attention import alibi_slopes  # noqa: F401
from dashinfer_tpu_torch.ops.attention import slopes_on
from dashinfer_tpu_torch.ops import kv_ops
from dashinfer_tpu_torch.ops.linear import linear
from dashinfer_tpu_torch.ops.moe import moe_block, rank_moe
from dashinfer_tpu_torch.ops.norms import rms_norm
from dashinfer_tpu_torch.ops.rotary import (apply_rope, compute_inv_freq,
                                            rope_cos_sin)
from dashinfer_tpu_torch.parallel.collectives import (all_gather_vocab,
                                                      all_reduce_)
from dashinfer_tpu_torch.parallel.sharding import rank_kv_heads
from dashinfer_tpu_torch.runtime.kv_cache import KVCache


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for layer math the port does not have."""
    unported = {
        "position embedding": cfg.position_embedding not in (
            PositionEmbedding.ROPE, PositionEmbedding.ALIBI),
        "rope scaling / logn": (cfg.rope_scaling.kind != "none" or
                                cfg.rope_scaling.use_logn_attn),
        "partial or interleaved rotary": (
            cfg.rotary_dim not in (0, cfg.head_dim) or cfg.rope_interleaved),
        "GLM structure": (cfg.rope_glm_2d or cfg.prefix_lm or
                          bool(cfg.glm_residual_alpha)),
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


def _qkv(cfg: ModelConfig, lp: Dict, x: torch.Tensor, use_kernel: bool,
         delta=None):
    """`delta`: the LoRA hook, delta(target, x) -> [T, out]."""
    T = x.shape[0]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(name):
        y = linear(x, lp[name], use_kernel=use_kernel)
        return y if delta is None else y + delta(name, x)

    q = lin("q_proj").reshape(T, H, D)
    k = lin("k_proj").reshape(T, KH, D)
    v = lin("v_proj").reshape(T, KH, D)
    if cfg.qk_norm:         # Qwen3: per-head RMSNorm, [D] weights
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _mlp(cfg: ModelConfig, lp: Dict, x: torch.Tensor, use_kernel: bool,
         out_dtype=None, rank: int = 0, n: int = 1,
         delta=None) -> torch.Tensor:
    if cfg.moe is not None:     # a MoE block takes no LoRA delta
        return moe_block(cfg, x, lp, use_kernel=use_kernel, rank=rank, n=n)
    g = linear(x, lp["gate_proj"], use_kernel=use_kernel)
    u = linear(x, lp["up_proj"], use_kernel=use_kernel)
    if delta is not None:
        g = g + delta("gate_proj", x)
        u = u + delta("up_proj", x)
    h = F.silu(g) * u
    y = linear(h, lp["down_proj"], out_dtype=out_dtype,
               use_kernel=use_kernel)
    return y if delta is None else y + delta("down_proj", h)


def _attention_half(cfg: ModelConfig, lp: Dict, hidden: torch.Tensor,
                    attend, use_kernel: bool, out_dtype=None,
                    delta=None) -> torch.Tensor:
    """RMSNorm, q|k|v, attend(q, k, v) -> [T, H*D] (RoPE, the cache write
    and attention) and the o product (`delta`: the LoRA hook)."""
    x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, lp, x, use_kernel, delta)
    a = attend(q, k, v)
    o = linear(a, lp["o_proj"], out_dtype=out_dtype, use_kernel=use_kernel)
    return o if delta is None else o + delta("o_proj", a)


def _mlp_half(cfg: ModelConfig, lp: Dict, h: torch.Tensor, use_kernel: bool,
              out_dtype=None, rank: int = 0, n: int = 1,
              delta=None) -> torch.Tensor:
    """RMSNorm and the MLP (or MoE block; on a model axis of n, rank
    `rank`'s share of it)."""
    x = rms_norm(h, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    return _mlp(cfg, lp, x, use_kernel, out_dtype, rank, n, delta)


def _block(cfg: ModelConfig, lp: Dict, hidden: torch.Tensor, attend,
           use_kernel: bool, delta=None) -> torch.Tensor:
    """One pre-LN layer (`delta`: the LoRA hook)."""
    h = hidden + _attention_half(cfg, lp, hidden, attend, use_kernel,
                                 delta=delta)
    return h + _mlp_half(cfg, lp, h, use_kernel, delta=delta)


def _lora_layer(lora, l: int, apply):
    """The LoRA hook of layer l: delta(target, x) = apply(x, A, B) with
    the pool's layer-l slices."""
    if lora is None:
        return None
    return lambda t, x_: apply(x_, lora["A"][t][l], lora["B"][t][l])


def _lm_logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
               use_kernel: bool) -> torch.Tensor:
    """hidden: [T, hidden] -> f32 logits [T, vocab]."""
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return linear(hidden, params["lm_head"], out_dtype=torch.float32,
                  use_kernel=use_kernel).float()


def _decode_inputs(cfg: ModelConfig, page_tables: torch.Tensor,
                   lens_before: torch.Tensor, active: torch.Tensor,
                   ps: int) -> Dict[str, torch.Tensor]:
    """A decode step's inputs of the attention: RoPE, the lengths after the
    step, each slot's layer-0 page and offset for the new token."""
    cos, sin = rope_cos_sin(lens_before,
                            compute_inv_freq(cfg, lens_before.device))
    page_col = (lens_before // ps).long().clamp(0, page_tables.shape[1] - 1)
    pt0 = page_tables * cfg.num_layers                     # layer 0 rows
    return dict(cos=cos, sin=sin, active=active, pt0=pt0,
                lens_after=torch.where(active, lens_before + 1, 0).to(
                    torch.int32),
                offsets=(lens_before % ps).long(),
                page0=torch.gather(pt0.long(), 1, page_col[:, None])[:, 0])


def _decode_attend(inp: Dict[str, torch.Tensor], cache: KVCache,
                   mode: CacheMode, l: int, scale: float, use_kernel: bool,
                   heads=None, slopes=None):
    """attend(q, k, v) of decode layer l. `heads` (first, count, H): the
    rank's query heads when its pool holds all KV heads (replicated);
    `slopes`: an ALiBi model's slopes of the heads attended (no RoPE)."""
    pt_l = (inp["pt0"] + l).to(torch.int32)

    def attend(q, k, v):
        B = q.shape[0]
        if slopes is None:
            cos, sin = inp["cos"], inp["sin"]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kv_ops.append_decode_kv(cache, mode, k, v, inp["page0"] + l,
                                inp["offsets"], inp["active"])
        out = attn_ops.paged_attention(_all_heads(q, heads), cache, mode,
                                       pt_l, inp["lens_after"], scale,
                                       use_kernel=use_kernel, alibi=slopes)
        return _own_heads(out, heads).reshape(B, -1)

    return attend


def _all_heads(q: torch.Tensor, heads) -> torch.Tensor:
    """The rank's query heads placed among all H (zeros elsewhere), for a
    pool that holds every KV head."""
    if heads is None:
        return q
    first, count, H = heads
    full = q.new_zeros(q.shape[:-2] + (H, q.shape[-1]))
    full[..., first:first + count, :] = q
    return full


def _own_heads(out: torch.Tensor, heads) -> torch.Tensor:
    if heads is None:
        return out
    first, count, _ = heads
    return out[..., first:first + count, :]


def _slopes(cfg: ModelConfig, device, n: int = 1, r: int = 0, heads=None):
    """An ALiBi model's slopes of the heads a rank attends: rank r of n's
    slice of the GLOBAL table (the JAX package's SPMD split of the heads),
    or all of it when the rank's pool holds every KV head (`heads`); None
    for a RoPE model."""
    if cfg.position_embedding != PositionEmbedding.ALIBI:
        return None
    if n == 1 or heads is not None:
        return slopes_on(cfg.num_heads, device)
    Hr = cfg.num_heads // n
    return slopes_on(cfg.num_heads, device, r * Hr, Hr)


def decode_forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   cache: KVCache, page_tables: torch.Tensor,
                   lens_before: torch.Tensor, active: torch.Tensor,
                   *, mode: CacheMode, use_kernel: bool = True,
                   lora: Dict = None, lora_onehot: torch.Tensor = None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """tokens: [B] int; page_tables: [B, maxP] int32 LOGICAL page ids
    (logical page g owns physical pool rows g*L + l per layer l);
    lens_before: [B] int32 tokens already cached (the new token's position);
    active: [B] bool; `lora` (the adapter pool) with `lora_onehot` [B, N]
    f32 (each row's slot, an all-zero row none). Reads nothing back to the
    host, so a CUDA graph can capture it. Returns (logits [B, vocab] f32,
    cache updated in place)."""
    check_supported(cfg)
    inp = _decode_inputs(cfg, page_tables, lens_before, active,
                         cache.page_size)
    hidden = params["embed_tokens"]["w"][tokens.long()]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    slopes = _slopes(cfg, tokens.device)
    for l in range(cfg.num_layers):
        attend = _decode_attend(inp, cache, mode, l, scale, use_kernel,
                                slopes=slopes)
        delta = _lora_layer(lora, l, lambda x_, A, B: apply_lora_batch(
            x_, A, B, lora["scale"], lora_onehot))
        hidden = _block(cfg, _layer(params, l), hidden, attend, use_kernel,
                        delta)
    return _lm_logits(cfg, params, hidden, use_kernel), cache


def _prefill_attend(cos, sin, cache: KVCache, mode: CacheMode,
                    pt_l: torch.Tensor, prefix_len: int, total_len: int,
                    kv_heads: int, scale: float, heads=None, slopes=None):
    num_new = total_len - prefix_len

    def attend(q, k, v):
        S = q.shape[0]
        if slopes is None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kv_ops.append_prefill_kv(cache, mode, k, v, pt_l, prefix_len, num_new)
        k_full, v_full = kv_ops.gather_kv_pages(cache, mode, pt_l, kv_heads)
        out = attn_ops.prefill_attention(_all_heads(q, heads), k_full,
                                         v_full, prefix_len, total_len, scale,
                                         alibi=slopes)
        return _own_heads(out, heads).reshape(S, -1)

    return attend


def prefill_forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    cache: KVCache, page_table: torch.Tensor,
                    prefix_len: int, total_len: int,
                    *, mode: CacheMode, use_kernel: bool = True,
                    lora: Dict = None, lora_idx: int = -1
                    ) -> Tuple[torch.Tensor, KVCache]:
    """tokens: [S] the uncached suffix (padded to the bucket size S);
    page_table: [maxPb] LOGICAL pages covering positions [0, S_kv);
    prefix_len: cached-prefix length; total_len: prefix_len + new tokens;
    `lora` (the adapter pool) with `lora_idx` (the prompt's slot, -1
    none). Returns (last-token logits [vocab] f32, cache updated in
    place)."""
    check_supported(cfg)
    S = tokens.shape[0]
    L = cfg.num_layers
    dev = tokens.device
    hidden = params["embed_tokens"]["w"][tokens.long()]
    pos = prefix_len + torch.arange(S, device=dev)
    cos, sin = rope_cos_sin(pos, compute_inv_freq(cfg, dev))
    scale = 1.0 / math.sqrt(cfg.head_dim)
    slopes = _slopes(cfg, dev)
    for l in range(L):
        attend = _prefill_attend(cos, sin, cache, mode,
                                 page_table.long() * L + l, prefix_len,
                                 total_len, cfg.num_kv_heads, scale,
                                 slopes=slopes)
        delta = _lora_layer(lora, l, lambda x_, A, B: apply_lora_single(
            x_, A, B, lora["scale"], lora_idx))
        hidden = _block(cfg, _layer(params, l), hidden, attend, use_kernel,
                        delta)
    last = min(max(total_len - prefix_len - 1, 0), S - 1)
    logits = _lm_logits(cfg, params, hidden[last:last + 1], use_kernel)[0]
    return logits, cache


# ---------------------------------------------------------------------------
# the same forwards over a model axis (the per-op TP path)
# ---------------------------------------------------------------------------

def rank_config(cfg: ModelConfig, n: int) -> ModelConfig:
    """What one rank of n computes on the per-op path: its share of the
    heads, MLP width and vocab, its KV heads (all of them when they do not
    divide among the ranks), and a MoE model's experts and shared expert
    width (`ops.moe.rank_moe`)."""
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // n,
        num_kv_heads=rank_kv_heads(cfg, n),
        intermediate_size=cfg.intermediate_size // n,
        vocab_size=cfg.vocab_size // n,
        moe=None if cfg.moe is None else rank_moe(cfg.moe, n))


def _rank_heads(cfg: ModelConfig, n: int, r: int):
    """`heads` of the attend closures: None when the rank's KV heads are its
    share, else (its first query head, its count, all heads)."""
    if rank_kv_heads(cfg, n) != cfg.num_kv_heads or n == 1:
        return None
    Hr = cfg.num_heads // n
    return (r * Hr, Hr, cfg.num_heads)


def _tp_layers(cfg: ModelConfig, rank_params: Sequence[Dict],
               hiddens: List[torch.Tensor], attends, l: int,
               use_kernel: bool) -> List[torch.Tensor]:
    """One layer on every rank, each half followed by the all-reduce of its
    f32 partials."""
    n = len(rank_params)
    cfg_r = rank_config(cfg, n)
    lps = [_layer(p, l) for p in rank_params]
    parts = all_reduce_([
        _attention_half(cfg_r, lps[r], hiddens[r], attends[r], use_kernel,
                        out_dtype=torch.float32) for r in range(n)])
    hiddens = [h + p.to(h.dtype) for h, p in zip(hiddens, parts)]
    parts = all_reduce_([
        _mlp_half(cfg_r, lps[r], hiddens[r], use_kernel,
                  out_dtype=torch.float32, rank=r, n=n) for r in range(n)])
    return [h + p.to(h.dtype) for h, p in zip(hiddens, parts)]


def _tp_logits(cfg: ModelConfig, rank_params: Sequence[Dict],
               hiddens: List[torch.Tensor], use_kernel: bool) -> torch.Tensor:
    cfg_r = rank_config(cfg, len(rank_params))
    return all_gather_vocab([_lm_logits(cfg_r, p, h, use_kernel)
                             for p, h in zip(rank_params, hiddens)])


def tp_decode_forward(cfg: ModelConfig, rank_params: Sequence[Dict],
                      tokens: torch.Tensor, caches: Sequence[KVCache],
                      page_tables: torch.Tensor, lens_before: torch.Tensor,
                      active: torch.Tensor, *, mode: CacheMode,
                      devices: Sequence[torch.device],
                      use_kernel: bool = True
                      ) -> Tuple[torch.Tensor, List[KVCache]]:
    """`decode_forward` over the ranks on `devices`: rank_params and caches
    are the ranks' (parallel/sharding.py); the step's inputs live on rank
    0's device. Returns (logits [B, vocab] f32 on rank 0's device, the
    pools updated in place)."""
    check_supported(cfg)
    n = len(devices)
    inp = _decode_inputs(cfg, page_tables, lens_before, active,
                         caches[0].page_size)
    per_dev = {d: {k: v.to(d) for k, v in inp.items()}
               for d in dict.fromkeys(devices)}
    hidden = rank_params[0]["embed_tokens"]["w"][tokens.long()]
    hiddens = [hidden.to(d) for d in devices]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for l in range(cfg.num_layers):
        attends = [_decode_attend(per_dev[d], caches[r], mode, l, scale,
                                  use_kernel, _rank_heads(cfg, n, r),
                                  _slopes(cfg, d, n, r,
                                          _rank_heads(cfg, n, r)))
                   for r, d in enumerate(devices)]
        hiddens = _tp_layers(cfg, rank_params, hiddens, attends, l,
                             use_kernel)
    return _tp_logits(cfg, rank_params, hiddens, use_kernel), list(caches)


def tp_prefill_forward(cfg: ModelConfig, rank_params: Sequence[Dict],
                       tokens: torch.Tensor, caches: Sequence[KVCache],
                       page_table: torch.Tensor, prefix_len: int,
                       total_len: int, *, mode: CacheMode,
                       devices: Sequence[torch.device],
                       use_kernel: bool = True
                       ) -> Tuple[torch.Tensor, List[KVCache]]:
    """`prefill_forward` over the ranks on `devices` (see
    `tp_decode_forward`). Returns (last-token logits [vocab] f32 on rank
    0's device, the pools updated in place)."""
    check_supported(cfg)
    n = len(devices)
    S, L = tokens.shape[0], cfg.num_layers
    kv_heads = rank_kv_heads(cfg, n)
    pos = prefix_len + torch.arange(S, device=tokens.device)
    cos, sin = rope_cos_sin(pos, compute_inv_freq(cfg, tokens.device))
    per_dev = {d: (cos.to(d), sin.to(d), page_table.to(d).long())
               for d in dict.fromkeys(devices)}
    hidden = rank_params[0]["embed_tokens"]["w"][tokens.long()]
    hiddens = [hidden.to(d) for d in devices]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for l in range(L):
        attends = []
        for r, d in enumerate(devices):
            c, s_, pt = per_dev[d]
            heads = _rank_heads(cfg, n, r)
            attends.append(_prefill_attend(
                c, s_, caches[r], mode, pt * L + l, prefix_len, total_len,
                kv_heads, scale, heads, _slopes(cfg, d, n, r, heads)))
        hiddens = _tp_layers(cfg, rank_params, hiddens, attends, l,
                             use_kernel)
    last = min(max(total_len - prefix_len - 1, 0), S - 1)
    logits = _tp_logits(cfg, rank_params,
                        [h[last:last + 1] for h in hiddens], use_kernel)[0]
    return logits, list(caches)
