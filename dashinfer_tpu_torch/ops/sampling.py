"""Batched sampler (counterpart of `dashinfer_tpu.ops.sampling`).

logits -> repetition/presence/frequency penalties -> min-length stop-token
suppression -> temperature -> top-k -> top-p -> Gumbel-max sample.

Differences from the JAX package, both deliberate:
  * top-k is exact (`torch.topk`); the JAX package's `approx_max_k` is exact
    off the TPU too, and greedy decoding is exact either way.
  * The Gumbel noise of a row comes from a `torch.Generator` seeded from
    the request's (seed, step) (`gumbel_noise`): the same seed gives the same
    tokens, but not the JAX package's threefry bits.
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


def _mix_seed(seed: int, step: int) -> int:
    """(seed, step) -> one 64-bit generator seed (splitmix64 finalizer), so
    that every bit depends on both: the CPU generator keeps only the low 32
    bits of its seed, the CUDA one all 64."""
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def gumbel_noise(rows: Sequence[Optional[Tuple[int, int]]], k: int,
                 device) -> torch.Tensor:
    """[len(rows), k] Gumbel noise; row i is drawn from a generator seeded
    from rows[i] = (seed, step), or is 0 where rows[i] is None (greedy)."""
    out = torch.zeros((len(rows), k), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for i, ss in enumerate(rows):
        if ss is None:
            continue
        seed, step = ss
        gen = torch.Generator(device=device)
        gen.manual_seed(_mix_seed(seed, step))
        u = torch.rand((k,), generator=gen, device=device).clamp_min(tiny)
        out[i] = -torch.log(-torch.log(u))
    return out


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
