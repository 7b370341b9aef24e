"""Engine step functions (counterpart of `dashinfer_tpu.engine.steps`).

  prefill step [bucket S]: model prefill + KV page writes + first-token
      sampling + slot-state initialization.
  decode step: page-table growth + batched model decode + sampler + state
      bookkeeping (token, counts, history, lengths).
  decode window [N steps]: N decode steps in one call, their page installs
      and noise rows computed on the host ahead of the window.

The JAX package jits each step with donated buffers; here they are plain
functions that update the KV pool and the DecodeState tensors in place.
Host-known per-request values (slot config, the (seed, step) of each
sampling row) come in as Python values, so a step never reads a device
value back. On the card the decode step's model forward is captured once in
a CUDA graph and replayed every step: its inputs are the persistent state
and pool tensors, so one graph launch replaces the forward's ~2,000 kernel
launches. With a megakernel plan the forward is the embedding gather, the
RoPE tiles and ONE launch of the decode megakernel (ops/megakernel.py); a
prefill step built with a prefill plan is the same around ONE launch of the
prefill megakernel (ops/prefill_megakernel.py), run eagerly. A decode
window (`build_multi_decode_step`) is N steps of page install, forward,
on-device bans, sampler and bookkeeping; on the card the whole window is
one CUDA graph (its first call runs the window eagerly, then captures it),
so one replay runs N forwards and everything between them.

Per-token features, as in the JAX package: the guided (JSON) step masks
the logits to a host-computed allowed set, the banned step computes the
bad-words / n-gram mask on the device from the slots' history
(ops/sampling.py `device_banned_mask`), the host channel takes banned ids
the host computed, and the logprobs step returns the sampled token's
logprob and the best `max_top_logprobs` ids and logprobs. Each combination
is a decode step of its own around the one forward of its path.

On a model axis (the ranks' devices given as `devices`) the params, the
pool and the forward are the ranks': the decode forward is the TP segments
(ops/tp_megakernel.py; a MoE model's moe segment in place of the mlp one,
its expert list built on the card, so the forward stays one CUDA graph)
when a TP plan is given, else the per-op TP forward of
models/transformer.py; a prefill step built with a local prefill plan
(`tp_mega`) runs the TP prefill segments, one attn and one mlp launch a
rank and layer and one lm launch a rank, eagerly, and any other prefill
(a MoE model's, at every bucket) the per-op TP forward. The decode state and the sampler stay on rank 0's
device.

LoRA (lora/manager.py): a prefill step built with the adapter pool runs the
per-op forward with the prompt's adapter (never the prefill megakernel, as
in the JAX package); every prefill writes its slot's `lora_idx`. A decode
step built with the pool passes it, with the rows' `lora_idx`, to the
decode megakernel's LoRA branch, or to the per-op forward as a one-hot
computed on the card; it is a graph of its own beside the step without.
"""

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from dashinfer_tpu_torch.config import ModelConfig, RuntimeConfig
from dashinfer_tpu_torch.models import transformer
from dashinfer_tpu_torch.ops import megakernel as mk
from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
from dashinfer_tpu_torch.ops import sampling as sampling_ops
from dashinfer_tpu_torch.ops import tp_megakernel as tpk
from dashinfer_tpu_torch.ops.rotary import compute_inv_freq, rope_cos_sin
from dashinfer_tpu_torch.runtime.batch_state import (DecodeState,
                                                     SamplingParams)
from dashinfer_tpu_torch.runtime.kv_cache import KVCache


class SlotInit(NamedTuple):
    """Per-request scalars written into a slot at admission."""

    slot: int
    temperature: float
    top_k: int
    top_p: float
    repetition_penalty: float
    presence_penalty: float
    frequency_penalty: float
    seed: int
    min_gen_len: int
    stop_token_ids: Tuple[int, ...]   # padded to MAX_STOP with -1
    lora_idx: int = -1                # adapter pool slot, -1 = none
    # on-device ban config, always written so that a reused slot keeps no
    # bans of its last occupant: [MW, WL] right-aligned words (-1 pad; None
    # = no words) and no_repeat_ngram_size (0 = off)
    bad_words: Optional[np.ndarray] = None
    ngram_n: int = 0


def to_device(a, device, dtype=None) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device: a small
    pageable host->device copy is staged by the CUDA runtime, so it may be
    enqueued asynchronously."""
    t = torch.as_tensor(np.asarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device, non_blocking=True)


def _write_slot_sampling(sp: SamplingParams, init: SlotInit) -> None:
    s = init.slot
    for name in ("temperature", "top_k", "top_p", "repetition_penalty",
                 "presence_penalty", "frequency_penalty", "min_gen_len"):
        getattr(sp, name)[s] = getattr(init, name)
    sp.stop_token_ids[s] = to_device(init.stop_token_ids,
                                     sp.stop_token_ids.device, torch.int32)


def _slot_sampling_params(init: SlotInit, device) -> SamplingParams:
    """1-row SamplingParams for first-token sampling."""
    def one(v, dt):
        return torch.full((1,), v, dtype=dt, device=device)

    return SamplingParams(
        temperature=one(init.temperature, torch.float32),
        top_k=one(init.top_k, torch.int32),
        top_p=one(init.top_p, torch.float32),
        repetition_penalty=one(init.repetition_penalty, torch.float32),
        presence_penalty=one(init.presence_penalty, torch.float32),
        frequency_penalty=one(init.frequency_penalty, torch.float32),
        min_gen_len=one(init.min_gen_len, torch.int32),
        stop_token_ids=to_device(init.stop_token_ids, device,
                                 torch.int32)[None],
    )


def _prefill_mega_forward(cfg: ModelConfig, plan, params, cache: KVCache,
                          tokens, page_row, n_tokens: int):
    """Whole-prefill forward through the prefill megakernel. params is the
    mega params dict {"packed", "embed"}; requires prefix_len == 0. The pool
    is updated in place. Returns (logits [vocab] f32, cache)."""
    dev = tokens.device
    x0 = params["embed"][tokens.long()].to(torch.bfloat16)
    cos, sin = _rope_tiles(cfg, torch.arange(plan.S, device=dev))
    logits = pmk.prefill_megakernel(
        plan, params["packed"], x0, cos, sin, page_row * cfg.num_layers,
        to_device(np.asarray([n_tokens], np.int32), dev), cache)
    return logits[:cfg.vocab_size], cache


def _tp_prefill_mega_forward(cfg: ModelConfig, plan, params,
                             caches: Sequence[KVCache], tokens, page_row,
                             n_tokens: int,
                             devices: Sequence[torch.device]):
    """Whole-prefill forward through the TP prefill segments (the
    counterpart of the JAX `_tp_prefill_mega_forward`): the embedding
    gather and the RoPE tiles on rank 0's device, then
    ops/tp_megakernel.py `tp_prefill` over the ranks. params is {"packs":
    one pack a rank, "embed": [V, hid]}; requires prefix_len == 0. The
    pools are updated in place. Returns (logits [vocab] f32 on rank 0's
    device, caches)."""
    dev = tokens.device
    x0 = params["embed"][tokens.long()].to(torch.bfloat16)
    cos, sin = _rope_tiles(cfg, torch.arange(plan.S, device=dev))
    logits = tpk.tp_prefill(
        plan, params["packs"], x0, cos, sin, page_row * cfg.num_layers,
        to_device(np.asarray([n_tokens], np.int32), dev), caches, devices)
    return logits[:cfg.vocab_size], caches


def build_prefill_step(cfg: ModelConfig, rt: RuntimeConfig, bucket: int,
                       mega_plan=None,
                       devices: Optional[Sequence[torch.device]] = None,
                       tp_mega=None, lora_pool: Optional[Dict] = None
                       ) -> Callable:
    """Returns fn(params, cache, state, tokens [S], page_row [maxPb],
    prefix_len, total_len, init: SlotInit, hist, allowed=None,
    banned=None, with_logprobs=False) -> (token (0-d device tensor), lp,
    cache, state). page_row holds LOGICAL page ids.

    hist: [max_length] the slot's history row, the full prompt ids (-1
    pad), which the step completes with the first token; allowed: [V] bool,
    a guided request's allowed first tokens; banned: [cap] host-computed
    banned ids (-1 pad); with_logprobs: lp is (token logprob [1], top ids
    [1, n], top logprobs [1, n]) with n = max_top_logprobs, else None. All
    of them act on the logits of every forward below.

    With `lora_pool` (the adapter pool) the forward is the single-device
    per-op one with the prompt's adapter (`init.lora_idx`).

    With `mega_plan` the model forward is ONE launch of the prefill
    megakernel; params must be the mega params dict {"packed", "embed"} and
    the caller guarantees prefix_len == 0. With `devices` (a model axis)
    params and cache are the ranks' lists and the forward is the TP prefill
    segments with `tp_mega` (the local prefill plan; params {"packs",
    "embed"}; prefix_len == 0), else the per-op TP prefill. The first token
    is sampled from the logits on rank 0's device."""
    mode = rt.cache.mode
    V = cfg.vocab_size
    K = min(rt.sampler_max_top_k, V)

    def step(params, cache: KVCache, state: DecodeState, tokens, page_row,
             prefix_len: int, total_len: int, init: SlotInit,
             hist: torch.Tensor, allowed=None, banned=None,
             with_logprobs: bool = False):
        dev = tokens.device
        if mega_plan is not None:
            logits, cache = _prefill_mega_forward(
                cfg, mega_plan, params, cache, tokens, page_row, total_len)
        elif tp_mega is not None:
            logits, cache = _tp_prefill_mega_forward(
                cfg, tp_mega, params, cache, tokens, page_row, total_len,
                devices)
        elif devices is not None:
            logits, cache = transformer.tp_prefill_forward(
                cfg, params, tokens, cache, page_row, prefix_len, total_len,
                mode=mode, devices=devices)
        else:
            logits, cache = transformer.prefill_forward(
                cfg, params, tokens, cache, page_row, prefix_len, total_len,
                mode=mode, lora=lora_pool, lora_idx=init.lora_idx)
        if allowed is not None:
            logits = torch.where(allowed, logits, sampling_ops._NEG)

        # prompt token occurrence counts (penalties run over
        # prompt + generated tokens)
        num_new = total_len - prefix_len
        counts = torch.zeros((V,), dtype=torch.int32, device=dev)
        counts.index_add_(0, tokens[:num_new].long().clamp(0, V - 1),
                          torch.ones((num_new,), dtype=torch.int32,
                                     device=dev))
        noise = None
        if init.top_k != 1:
            noise = sampling_ops.gumbel_noise(
                [(init.seed, total_len)], K, "cpu").to(dev, non_blocking=True)
        out = sampling_ops.sample(
            logits[None], _slot_sampling_params(init, dev), counts[None],
            torch.zeros((1,), dtype=torch.int32, device=dev), noise,
            max_top_k=rt.sampler_max_top_k,
            top_logprobs=rt.max_top_logprobs if with_logprobs else 0,
            banned=None if banned is None else banned[None])
        tok = out.tokens[0]
        counts.index_add_(0, tok[None].long(),
                          torch.ones((1,), dtype=torch.int32, device=dev))

        # the history row: the prompt, then the first token at total_len
        hist[min(total_len, state.history.shape[1] - 1)] = tok
        bad_words = init.bad_words
        if bad_words is None:
            bad_words = np.full(state.bad_words.shape[1:], -1, np.int32)

        s = init.slot
        state.token_ids[s] = tok
        state.context_lens[s] = total_len
        state.prompt_lens[s] = total_len
        state.gen_lens[s] = 1
        state.page_tables[s] = 0
        state.page_tables[s, :page_row.shape[0]] = page_row
        state.active[s] = True
        state.token_counts[s] = counts
        state.lora_idx[s] = init.lora_idx
        state.history[s] = hist
        state.bad_words[s] = to_device(bad_words, dev, torch.int32)
        state.ngram_n[s] = init.ngram_n
        _write_slot_sampling(state.sampling, init)
        lp = out[1:] if with_logprobs else None
        return tok, lp, cache, state

    return step


def _rope_tiles(cfg: ModelConfig, pos: torch.Tensor):
    """Full-D cos/sin tiles [len(pos), D] bf16 for the megakernel
    (half-split rope convention, ops/rotary.py). An ALiBi plan's kernels
    and plain versions do not read them (its pack's `slopes` take their
    place), so this keeps its signature where the JAX package's
    `_rope_tiles(cfg, alibi, pos)` builds identity tiles."""
    cos, sin = rope_cos_sin(pos, compute_inv_freq(cfg, pos.device))
    return (torch.cat([cos, cos], dim=-1).to(torch.bfloat16),
            torch.cat([sin, sin], dim=-1).to(torch.bfloat16))


def _megakernel_forward(cfg: ModelConfig, plan, params, state: DecodeState,
                        cache: KVCache, lora: Optional[Dict] = None
                        ) -> torch.Tensor:
    """One whole-model decode forward through the megakernel (its LoRA
    branch with `lora`, the adapter pool, and the state's `lora_idx`).
    params is the mega params dict {"packed", "embed"}; the pool is updated
    in place. Returns logits [B, vocab] f32."""
    x0 = params["embed"][state.token_ids.long()].to(torch.bfloat16)
    cos, sin = _rope_tiles(cfg, state.context_lens)
    return mk.decode_megakernel(
        plan, params["packed"], x0, cos, sin, state.page_tables,
        state.context_lens, state.active, cache, lora=lora,
        lora_idx=None if lora is None else state.lora_idx)


def lora_onehot(lora_idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] f32 one-hot of each row's slot (-1: a zero row), computed on
    the card (capturable)."""
    slots = torch.arange(n, device=lora_idx.device, dtype=lora_idx.dtype)
    return (lora_idx[:, None] == slots[None, :]).float()


def _tp_megakernel_forward(cfg: ModelConfig, plan, params,
                           state: DecodeState, caches: Sequence[KVCache],
                           devices: Sequence[torch.device]) -> torch.Tensor:
    """One decode forward through the TP segments (the counterpart of the
    JAX `_tp_megakernel_forward`): the embedding gather and the RoPE tiles
    on rank 0's device, then per layer every rank's attn segment, an
    all-reduce, every rank's mlp (or moe) segment, an all-reduce; then
    every rank's lm segment and the gather (ops/tp_megakernel.py `tp_decode`). params
    is {"packs": one pack a rank, "embed": [V, hid]}. Returns logits
    [B, vocab] f32."""
    x0 = params["embed"][state.token_ids.long()].to(torch.bfloat16)
    cos, sin = _rope_tiles(cfg, state.context_lens)
    return tpk.tp_decode(plan, params["packs"], x0, cos, sin,
                         state.page_tables, state.context_lens, state.active,
                         caches, devices)


class _DecodeForward:
    """The decode forward over the state's tensors: the megakernel when a
    plan is given, the TP segments or the per-op TP forward on a model
    axis, else transformer.decode_forward. For CUDA tensors the first call
    captures it in a CUDA graph (after one eager warm-up run) and every
    call replays it, so every call must pass the same params, pool and
    state objects (the runtime owns one of each). A model axis over
    distinct cards runs eagerly: one process's NCCL group call would have
    to be captured on every rank card's stream at once, which a one-card
    machine cannot check. `lora`: the adapter pool (single device), whose
    tensors keep their addresses, so a load or unload between replays needs
    no new capture; `captures` counts the graph's captures."""

    def __init__(self, cfg: ModelConfig, rt: RuntimeConfig,
                 megakernel_plan=None, tp_plan=None,
                 devices: Optional[Sequence[torch.device]] = None,
                 lora: Optional[Dict] = None):
        self.cfg, self.mode = cfg, rt.cache.mode
        self.plan, self.tp_plan = megakernel_plan, tp_plan
        self.devices = None if devices is None else tuple(devices)
        self.lora = lora
        self._graph = None
        self._logits = None
        self.captures = 0

    def _run(self, params, cache, state: DecodeState):
        if self.tp_plan is not None:
            return _tp_megakernel_forward(self.cfg, self.tp_plan, params,
                                          state, cache, self.devices)
        if self.devices is not None:
            logits, _ = transformer.tp_decode_forward(
                self.cfg, params, state.token_ids, cache, state.page_tables,
                state.context_lens, state.active, mode=self.mode,
                devices=self.devices)
            return logits
        if self.plan is not None:
            return _megakernel_forward(self.cfg, self.plan, params, state,
                                       cache, self.lora)
        onehot = None if self.lora is None else lora_onehot(
            state.lora_idx, self.lora["scale"].shape[0])
        logits, _ = transformer.decode_forward(
            self.cfg, params, state.token_ids, cache, state.page_tables,
            state.context_lens, state.active, mode=self.mode,
            lora=self.lora, lora_onehot=onehot)
        return logits

    def __call__(self, params, cache, state: DecodeState):
        if not state.token_ids.is_cuda or (
                self.devices is not None and len(set(self.devices)) > 1):
            return self._run(params, cache, state)
        if self._graph is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._run(params, cache, state)   # warm-up (same writes)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._logits = self._run(params, cache, state)
            self._graph = graph
            self.captures += 1
        self._graph.replay()
        return self._logits


def _install_pages(state: DecodeState, new_page_ids: torch.Tensor,
                   ps: int) -> None:
    """new_page_ids[b] >= 0 installs a fresh LOGICAL page for slot b at the
    page-table column the incoming token starts."""
    col = (state.context_lens // ps).long().clamp(
        0, state.page_tables.shape[1] - 1)[:, None]
    old = state.page_tables.gather(1, col)
    new = new_page_ids[:, None]
    state.page_tables.scatter_(1, col, torch.where(new >= 0, new, old))


def _advance(cfg: ModelConfig, state: DecodeState,
             sampled: torch.Tensor) -> torch.Tensor:
    """The step's bookkeeping: the active slots take their sampled token
    (inactive ones keep theirs), count it, append it to the history at
    prompt_lens + gen_lens and advance their lengths. Returns the tokens
    [B]."""
    V, T = cfg.vocab_size, state.history.shape[1]
    active = state.active
    tok = torch.where(active, sampled, state.token_ids)
    inc = active.to(torch.int32)
    state.token_counts.scatter_add_(
        1, tok.long().clamp(0, V - 1)[:, None], inc[:, None])
    hcol = (state.prompt_lens + state.gen_lens).long().clamp(0, T - 1)[:, None]
    hold = state.history.gather(1, hcol)
    state.history.scatter_(1, hcol, torch.where(active[:, None], tok[:, None],
                                                hold))
    state.token_ids.copy_(tok)
    state.context_lens.add_(inc)
    state.gen_lens.add_(inc)
    return tok


def _banned_mask(cfg: ModelConfig, rt: RuntimeConfig,
                 state: DecodeState) -> torch.Tensor:
    """The on-device ban mask of the step: from the history the steps
    before it appended (hlen = prompt_lens + gen_lens)."""
    return sampling_ops.device_banned_mask(
        state.history, state.prompt_lens + state.gen_lens, state.bad_words,
        state.ngram_n, cfg.vocab_size, rt.max_ngram)


def build_decode_step(cfg: ModelConfig, rt: RuntimeConfig,
                      megakernel_plan=None, tp_megakernel=None,
                      devices: Optional[Sequence[torch.device]] = None,
                      lora_pool: Optional[Dict] = None, *,
                      with_logprobs: bool = False, with_guided: bool = False,
                      with_banned: bool = False,
                      forward: Optional[_DecodeForward] = None) -> Callable:
    """Returns fn(params, cache, state, new_page_ids [B], noise_rows,
    allowed=None, banned=None) -> (tokens [B], lp, cache, state). With
    `megakernel_plan` the forward is one launch of the decode megakernel
    and params must be the mega params dict {"packed": ..., "embed": [V,
    hid]}. On a model axis (`devices`, the ranks' devices) cache is the
    ranks' pools and the forward is the TP segments with `tp_megakernel`
    (the local plan; params {"packs", "embed"}), else the per-op TP forward
    (params: the ranks' trees).

    new_page_ids[b] >= 0 installs a fresh LOGICAL page for slot b at the
    page-table column the incoming token starts. noise_rows[b] is the
    (seed, step) of a sampling slot or None (greedy / inactive).
    `lora_pool` (single device): the adapter pool, each row's slot from
    the state's `lora_idx`.

    with_guided: `allowed` [B, V] bool masks the logits; with_banned: the
    on-device bad-words / n-gram mask from the state; `banned` [B, cap]
    (the host channel, -1 pad) when given; with_logprobs: lp is (token
    logprobs [B], top ids [B, n], top logprobs [B, n]), n =
    max_top_logprobs, else None. `forward`: a _DecodeForward to share (the
    steps of one path share its graph); the step's own `forward` is it."""
    ps = rt.cache.page_size
    K = min(rt.sampler_max_top_k, cfg.vocab_size)
    n_lp = rt.max_top_logprobs if with_logprobs else 0
    if forward is None:
        forward = _DecodeForward(cfg, rt, megakernel_plan, tp_megakernel,
                                 devices, lora_pool)

    def step(params, cache, state: DecodeState,
             new_page_ids: torch.Tensor,
             noise_rows: Sequence[Optional[Tuple[int, int]]],
             allowed: Optional[torch.Tensor] = None,
             banned: Optional[torch.Tensor] = None):
        dev = state.token_ids.device
        _install_pages(state, new_page_ids, ps)
        logits = forward(params, cache, state)
        if with_guided:
            logits = torch.where(allowed, logits, sampling_ops._NEG)
        bmask = _banned_mask(cfg, rt, state) if with_banned else None
        noise = None
        if any(r is not None for r in noise_rows):
            # drawn on the host while the card runs the forward
            noise = sampling_ops.gumbel_noise(noise_rows, K, "cpu").to(
                dev, non_blocking=True)
        out = sampling_ops.sample(
            logits, state.sampling, state.token_counts, state.gen_lens,
            noise, max_top_k=rt.sampler_max_top_k, top_logprobs=n_lp,
            banned=banned, banned_mask=bmask)
        tok = _advance(cfg, state, out.tokens)
        return tok, (out[1:] if with_logprobs else None), cache, state

    step.forward = forward
    return step


def _window_noise(noise_rows: Sequence[Sequence[Optional[Tuple[int, int]]]],
                 k: int) -> torch.Tensor:
    """[N, B, k] host tensor of a window's noise: row (i, b) is
    `gumbel_noise` of noise_rows[i][b], zero where it is None (greedy),
    drawn only for the sampling rows."""
    N, B = len(noise_rows), len(noise_rows[0])
    flat = [r for rows in noise_rows for r in rows]
    real = [j for j, r in enumerate(flat) if r is not None]
    noise = torch.zeros((N * B, k), dtype=torch.float32)
    if real:
        noise[real] = sampling_ops.gumbel_noise([flat[j] for j in real], k,
                                                "cpu")
    return noise.view(N, B, k)


class _DecodeWindow:
    """N decode steps over the state's tensors. For CUDA tensors on one
    card (a model axis whose ranks share it included) the first call runs
    the window eagerly, as the real window, on a side stream, and then
    captures it in a CUDA graph, which runs nothing: a window is not
    idempotent (it advances the lengths, counts and history and writes N
    K/V positions), so no warm-up may run it twice. Every later call
    copies its page installs and noise into the graph's input buffers and
    replays it; its tokens are copied out of the graph's output before the
    call returns, on the same stream, so that a replay launched before the
    last window is drained does not overwrite them. Every call must pass
    the same params, pool and state objects. A model axis over distinct
    cards, and the CPU, run the same body eagerly. `captures` counts the
    graph's captures."""

    def __init__(self, cfg: ModelConfig, rt: RuntimeConfig, n_steps: int,
                 forward: _DecodeForward, with_banned: bool):
        self.cfg, self.rt, self.n = cfg, rt, n_steps
        self.forward, self.with_banned = forward, with_banned
        self._graph = None
        self._inputs = None
        self._tokens = None
        self.captures = 0

    def _body(self, params, cache, state: DecodeState,
              new_page_ids: torch.Tensor, noise: torch.Tensor
              ) -> torch.Tensor:
        cfg, rt = self.cfg, self.rt
        toks = []
        for i in range(self.n):
            _install_pages(state, new_page_ids[i], rt.cache.page_size)
            logits = self.forward._run(params, cache, state)
            bmask = _banned_mask(cfg, rt, state) if self.with_banned \
                else None
            # every row adds its noise row (zero for a greedy one: the
            # argmax is the same), so the graph has no branch on the rows
            out = sampling_ops.sample(
                logits, state.sampling, state.token_counts, state.gen_lens,
                noise[i], max_top_k=rt.sampler_max_top_k,
                banned_mask=bmask)
            toks.append(_advance(cfg, state, out.tokens))
        return torch.stack(toks)

    def __call__(self, params, cache, state: DecodeState,
                 new_page_ids: np.ndarray, noise: torch.Tensor
                 ) -> torch.Tensor:
        dev = state.token_ids.device
        devices = self.forward.devices
        if not state.token_ids.is_cuda or (
                devices is not None and len(set(devices)) > 1):
            return self._body(params, cache, state,
                              to_device(new_page_ids, dev, torch.int32),
                              noise.to(dev, non_blocking=True))
        if self._graph is None:
            self._inputs = (
                torch.empty(new_page_ids.shape, dtype=torch.int32,
                            device=dev),
                torch.empty(noise.shape, dtype=torch.float32, device=dev))
        # fresh pageable host tensors: the copy stages them before it
        # returns, so the host may draw the next window at once
        self._inputs[0].copy_(torch.from_numpy(
            np.ascontiguousarray(new_page_ids, np.int32)), non_blocking=True)
        self._inputs[1].copy_(noise, non_blocking=True)
        if self._graph is not None:
            self._graph.replay()
            return self._tokens.clone()
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            toks = self._body(params, cache, state, *self._inputs)
        cur.wait_stream(side)
        toks.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._tokens = self._body(params, cache, state, *self._inputs)
        self._graph = graph
        self.captures += 1
        return toks


def build_multi_decode_step(cfg: ModelConfig, rt: RuntimeConfig,
                            n_steps: int, megakernel_plan=None,
                            tp_megakernel=None,
                            devices: Optional[Sequence[torch.device]] = None,
                            with_banned: bool = False,
                            forward: Optional[_DecodeForward] = None
                            ) -> Callable:
    """N decode steps in one call (the counterpart of the JAX
    `build_multi_decode_step`, a `lax.scan` of the single step): fn(params,
    cache, state, new_page_ids [N, B] (host), noise_rows) -> (tokens [N, B],
    cache, state). noise_rows[i][b] is the (seed, step) of slot b's i-th
    step or None (greedy / inactive); the host draws them all ahead, since
    a row depends only on (seed, step, K). The forward is the decode
    megakernel, the TP segments, the per-op TP or the per-op forward, as
    for `build_decode_step` (no LoRA form, as in the JAX package); with
    `with_banned` each step recomputes the on-device ban mask from the
    history the step before appended. `forward`: the path's _DecodeForward
    to share (only its eager body runs here). The step's `window` is its
    _DecodeWindow."""
    K = min(rt.sampler_max_top_k, cfg.vocab_size)
    if forward is None:
        forward = _DecodeForward(cfg, rt, megakernel_plan, tp_megakernel,
                                 devices)
    window = _DecodeWindow(cfg, rt, n_steps, forward, with_banned)

    def step(params, cache, state: DecodeState, new_page_ids: np.ndarray,
             noise_rows):
        return (window(params, cache, state, new_page_ids,
                       _window_noise(noise_rows, K)), cache, state)

    step.window = window
    return step


def build_deactivate(cfg: ModelConfig, rt: RuntimeConfig) -> Callable:
    """fn(state, slots: list of slot indices) -> state with them released."""

    def fn(state: DecodeState, slots: List[int]) -> DecodeState:
        for s in slots:
            state.active[s] = False
        return state

    return fn
