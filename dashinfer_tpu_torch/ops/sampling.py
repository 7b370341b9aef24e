"""Batched sampler (counterpart of `dashinfer_tpu.ops.sampling`).

logits -> repetition/presence/frequency penalties -> min-length stop-token
suppression -> temperature -> top-k -> top-p -> Gumbel-max sample.

top-k is exact (`torch.topk`); the JAX package's `approx_max_k` is exact
off the TPU too, and greedy decoding is exact either way.

The Gumbel noise of a row is the JAX package's draw,
`jax.random.gumbel(fold_in(PRNGKey(seed), step), (K,), float32)` with
`jax_threefry_partitionable` on: threefry2x32 in uint32 arithmetic held in
int64 torch ops with masks, over the step's [rows, K] (`gumbel_noise`), so
the raw bits and uniforms are the same on the CPU and on the card and the
noise the same up to the last bits of `log`. The engine's steps draw it on
the host and copy it to the card without waiting: its ~350 small integer
ops cost less there than as launches on the card
(`tools/ab_decode.py --noise`).
"""

from typing import Optional, Sequence, Tuple

import torch

from dashinfer_tpu_torch.runtime.batch_state import SamplingParams

_NEG = -1e30


def process_logits(logits: torch.Tensor, sp: SamplingParams,
                   token_counts: torch.Tensor,
                   gen_lens: torch.Tensor) -> torch.Tensor:
    """Penalties + min-length stop suppression (reference
    process_logits_launcher, generate_op.cpp:238-312)."""
    counts = token_counts.float()
    appeared = counts > 0
    rp = sp.repetition_penalty[:, None]
    logits = torch.where(appeared,
                         torch.where(logits > 0, logits / rp, logits * rp),
                         logits)
    logits = logits - sp.presence_penalty[:, None] * appeared.float()
    logits = logits - sp.frequency_penalty[:, None] * counts

    # min-length: scatter-min _NEG onto the request's stop tokens (padding
    # entries write +inf = no-op; duplicates are harmless under min)
    ban = gen_lens < sp.min_gen_len                         # [B]
    ids = sp.stop_token_ids                                 # [B, MAX_STOP]
    upd = torch.where(ban[:, None] & (ids >= 0), _NEG, float("inf"))
    return logits.scatter_reduce(1, ids.clamp_min(0).long(), upd,
                                 reduce="amin", include_self=True)


_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds (jax `_threefry2x32_lowering`), over
    broadcastable int64 tensors holding uint32 values (sums taken mod
    2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits(seeds: torch.Tensor, steps: torch.Tensor,
                k: int) -> torch.Tensor:
    """[R, k] `jax.random.bits(fold_in(PRNGKey(seed), step), (k,))` as
    int64 for R rows (seeds, steps: [R] int64 holding uint32 values):
    PRNGKey(seed) is the key (0, seed); fold_in hashes the count (0, step)
    under it; the bits hash the (hi, lo) counters of an iota of k (hi 0)
    under the folded key and xor the two words."""
    zero = torch.zeros_like(seeds)
    f0, f1 = threefry2x32(zero, seeds, zero, steps)
    lo = torch.arange(k, dtype=torch.int64, device=seeds.device)[None, :]
    b0, b1 = threefry2x32(f0[:, None], f1[:, None], torch.zeros_like(lo), lo)
    return b0 ^ b1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform(minval=tiny, maxval=1.0)` in float32 from its
    bits: the top 23 bits as the mantissa of a float in [1, 2), less 1,
    scaled into [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * (1.0 - tiny) + tiny, tiny)


def gumbel_noise(rows: Sequence[Optional[Tuple[int, int]]], k: int,
                 device) -> torch.Tensor:
    """[len(rows), k] Gumbel noise, computed on `device`: row i is
    `jax.random.gumbel(fold_in(PRNGKey(seed), step), (k,), float32)` of
    rows[i] = (seed, step), or 0 where rows[i] is None (greedy)."""
    pairs = torch.tensor([ss if ss is not None else (0, 0) for ss in rows],
                         dtype=torch.int64).reshape(len(rows), 2) & _M32
    greedy = torch.tensor([ss is None for ss in rows]).reshape(len(rows), 1)
    pairs = pairs.to(device, non_blocking=True)
    greedy = greedy.to(device, non_blocking=True)
    u = uniform_from_bits(random_bits(pairs[:, 0], pairs[:, 1], k))
    return torch.where(greedy, 0.0, -torch.log(-torch.log(u)))


def sample(logits: torch.Tensor, sp: SamplingParams,
           token_counts: torch.Tensor, gen_lens: torch.Tensor,
           gumbel: Optional[torch.Tensor], *, max_top_k: int) -> torch.Tensor:
    """logits: [B, V] f32 raw model output; gumbel: [B, min(max_top_k, V)]
    noise (`gumbel_noise`) or None for all-greedy batches. Returns the
    sampled tokens [B] int32."""
    V = logits.shape[-1]
    logits = process_logits(logits, sp, token_counts, gen_lens)
    scaled = logits / sp.temperature.clamp_min(1e-5)[:, None]

    K = min(max_top_k, V)
    vals, idx = torch.topk(scaled, K, dim=-1)               # [B, K] desc
    rank = torch.arange(K, device=logits.device)[None, :]
    k_eff = torch.where(sp.top_k == 0, K, sp.top_k.clamp_max(K))[:, None]
    vals = torch.where(rank < k_eff, vals, _NEG)

    # top-p inside the top-k window (the first entry is always kept)
    probs = torch.softmax(vals, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < sp.top_p[:, None]
    vals = torch.where(keep, vals, _NEG)
    if gumbel is not None:
        vals = vals + gumbel
    choice = torch.argmax(vals, dim=-1)
    tokens = torch.gather(idx, 1, choice[:, None])[:, 0]
    return tokens.to(torch.int32)
