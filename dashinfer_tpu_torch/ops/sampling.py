"""Batched sampler (counterpart of `dashinfer_tpu.ops.sampling`).

logits -> repetition/presence/frequency penalties -> min-length stop-token
suppression -> bad-words / n-gram bans -> temperature -> top-k -> top-p ->
Gumbel-max sample -> optional logprobs.

The bans come in two forms, as in the JAX package: `device_banned_mask`
computes a [B, V] mask on the device from the slots' token history and ban
config (no host round trip, so a banned request keeps the pipelined and
multi-step decode), and the host channel `banned` carries up to `cap`
banned ids a row that the host oracle computed (a ban config too large for
the state's arrays). Every op here is capturable in a CUDA graph: no host
read, no data-dependent shape.

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

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from dashinfer_tpu_torch.runtime.batch_state import SamplingParams

_NEG = -1e30


class SampleOutput(NamedTuple):
    tokens: torch.Tensor                      # [B] i32
    token_logprobs: Optional[torch.Tensor]    # [B] f32 or None
    top_ids: Optional[torch.Tensor]           # [B, n] i32 or None
    top_logprobs: Optional[torch.Tensor]      # [B, n] f32 or None


def device_banned_mask(history: torch.Tensor, lens: torch.Tensor,
                       bad_words: torch.Tensor, ngram_n: torch.Tensor,
                       vocab: int, max_ngram: int) -> torch.Tensor:
    """[B, vocab] bool: the bad-words and no-repeat-ngram bans of each row
    (True = banned), computed from the slot's history on the device.

    history: [B, T] i32 prompt + generated ids (-1 pad); lens: [B] tokens in
    history; bad_words: [B, MW, WL] RIGHT-ALIGNED words (-1 pad: the last
    column is the banned token, the columns before it the context tail it
    needs, -1 a wildcard of a shorter word); ngram_n: [B]
    no_repeat_ngram_size (0 = off). The semantics are the host oracle's
    (engine/model_runtime.py `_banned_ids`)."""
    B, T = history.shape
    dev = history.device
    lens = lens.long()
    mask = torch.zeros((B, vocab), dtype=torch.int32, device=dev)

    # bad words: word w of length m bans its last token when the last m - 1
    # history tokens equal w[:-1] (a single-token word always)
    MW, WL = bad_words.shape[1], bad_words.shape[2]
    if MW > 0 and WL > 0:
        m = WL - 1
        if m > 0:
            pos = lens[:, None] - m + torch.arange(m, device=dev)[None, :]
            tail = torch.where(pos >= 0,
                               history.gather(1, pos.clamp(0, T - 1)), -2)
            prefix = bad_words[:, :, :m]
            match = ((prefix == -1) |
                     (prefix == tail[:, None, :])).all(dim=-1)   # [B, MW]
        else:
            match = torch.ones((B, MW), dtype=torch.bool, device=dev)
        last = bad_words[:, :, -1]
        match = match & (last >= 0)
        mask.scatter_add_(1, last.clamp(0, vocab - 1).long(),
                          match.to(torch.int32))

    # no-repeat-ngram: ban history[i + n - 1] wherever history[i:i + n - 1]
    # equals the current (n - 1)-token tail
    if max_ngram > 0:
        m = (ngram_n.long() - 1).clamp(0, max_ngram - 1)           # [B]
        i = torch.arange(T, device=dev)[None, :]                   # [1, T]
        eq = torch.ones((B, T), dtype=torch.bool, device=dev)
        for k in range(max_ngram - 1):
            tgt_pos = lens - m + k                                 # [B]
            tgt = torch.where(
                (k < m) & (tgt_pos >= 0),
                history.gather(1, tgt_pos.clamp(0, T - 1)[:, None])[:, 0],
                -2)
            src = torch.where(
                i + k < T,
                history.gather(1, (i + k).clamp(0, T - 1).expand(B, T)), -3)
            eq = eq & ((k >= m[:, None]) | (src == tgt[:, None]))
        ban_pos = i + m[:, None]                                   # [B, T]
        banned_tok = history.gather(1, ban_pos.clamp(0, T - 1))
        valid = ((ngram_n[:, None] > 0) & eq & (ban_pos < lens[:, None]) &
                 (banned_tok >= 0))
        mask.scatter_add_(1, banned_tok.clamp(0, vocab - 1).long(),
                          valid.to(torch.int32))
    return mask > 0


def process_logits(logits: torch.Tensor, sp: SamplingParams,
                   token_counts: torch.Tensor,
                   gen_lens: torch.Tensor,
                   banned: Optional[torch.Tensor] = None,
                   banned_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Penalties + min-length stop suppression + bans (reference
    process_logits_launcher, generate_op.cpp:238-312). banned: [B, cap]
    host-computed banned ids (-1 = unused); banned_mask: [B, V] bool from
    `device_banned_mask`."""
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
    logits = logits.scatter_reduce(1, ids.clamp_min(0).long(), upd,
                                   reduce="amin", include_self=True)
    if banned is not None:
        upd = torch.where(banned >= 0, _NEG, float("inf"))
        logits = logits.scatter_reduce(1, banned.clamp_min(0).long(), upd,
                                       reduce="amin", include_self=True)
    if banned_mask is not None:
        logits = torch.where(banned_mask, _NEG, logits)
    return logits


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
           gumbel: Optional[torch.Tensor], *, max_top_k: int,
           top_logprobs: int = 0, banned: Optional[torch.Tensor] = None,
           banned_mask: Optional[torch.Tensor] = None) -> SampleOutput:
    """logits: [B, V] f32 raw model output; gumbel: [B, min(max_top_k, V)]
    noise (`gumbel_noise`; zero rows are greedy) or None for all-greedy
    batches. With `top_logprobs` n > 0 the output also holds the sampled
    token's logprob and the n best ids and logprobs: `log_softmax` of the
    scaled logits over the whole vocab, after penalties, bans and
    temperature, as in the JAX package."""
    V = logits.shape[-1]
    logits = process_logits(logits, sp, token_counts, gen_lens, banned,
                            banned_mask)
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
    if top_logprobs > 0:
        lp_full = torch.log_softmax(scaled, dim=-1)
        token_lp = lp_full.gather(1, tokens[:, None])[:, 0]
        top_lp, top_ids = torch.topk(lp_full, top_logprobs, dim=-1)
        return SampleOutput(tokens.to(torch.int32), token_lp,
                            top_ids.to(torch.int32), top_lp)
    return SampleOutput(tokens.to(torch.int32), None, None, None)
