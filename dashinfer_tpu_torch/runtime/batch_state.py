"""Device-side continuous-batching state (counterpart of
`dashinfer_tpu.runtime.batch_state`).

Fixed `max_batch` decode slots: every per-request quantity lives in a
`[max_batch]` tensor and inactive slots are masked. The steps of
engine/steps.py update these tensors in place. The token history, the
bad-words and n-gram ban config and the prompt lengths are the JAX
package's: the bans are computed on the device from them
(ops/sampling.py `device_banned_mask`). Its mRoPE position offsets (VLM)
are left out, as are its per-slot seeds: the sampler's seeds come from the
host (engine/steps.py).
"""

import dataclasses

import torch

from dashinfer_tpu_torch.config import ModelConfig, RuntimeConfig


@dataclasses.dataclass
class SamplingParams:
    """Per-slot generation config (all [B] unless noted)."""

    temperature: torch.Tensor      # f32; 0 => greedy
    top_k: torch.Tensor            # i32; 0 => full window, 1 => greedy
    top_p: torch.Tensor            # f32
    repetition_penalty: torch.Tensor  # f32
    presence_penalty: torch.Tensor    # f32
    frequency_penalty: torch.Tensor   # f32
    min_gen_len: torch.Tensor      # i32: suppress stop tokens before this
    stop_token_ids: torch.Tensor   # i32 [B, MAX_STOP]; -1 = unused


@dataclasses.dataclass
class DecodeState:
    """All mutable per-slot state read by the decode step."""

    token_ids: torch.Tensor       # i32 [B] next input token
    context_lens: torch.Tensor    # i32 [B] tokens currently in KV cache
    prompt_lens: torch.Tensor     # i32 [B]
    gen_lens: torch.Tensor        # i32 [B] tokens generated so far
    page_tables: torch.Tensor     # i32 [B, max_pages_per_seq] LOGICAL pages
    active: torch.Tensor          # bool [B]
    token_counts: torch.Tensor    # i32 [B, vocab] occurrences (penalties)
    sampling: SamplingParams
    lora_idx: torch.Tensor        # i32 [B] adapter pool slot, -1 = none
    # prompt + generated ids (-1 pad) and each slot's ban config, so that
    # bad-words / n-gram bans are computed on the device
    history: torch.Tensor         # i32 [B, max_length]
    bad_words: torch.Tensor       # i32 [B, MW, WL] right-aligned, -1 pad
    ngram_n: torch.Tensor         # i32 [B] no_repeat_ngram_size, 0 = off

    @property
    def max_batch(self) -> int:
        return self.token_ids.shape[0]


def make_sampling_params(max_batch: int, max_stop: int,
                         device) -> SamplingParams:
    B = max_batch

    def full(v, dt, shape=(B,)):
        return torch.full(shape, v, dtype=dt, device=device)

    return SamplingParams(
        temperature=full(1.0, torch.float32),
        top_k=full(1, torch.int32),
        top_p=full(1.0, torch.float32),
        repetition_penalty=full(1.0, torch.float32),
        presence_penalty=full(0.0, torch.float32),
        frequency_penalty=full(0.0, torch.float32),
        min_gen_len=full(0, torch.int32),
        stop_token_ids=full(-1, torch.int32, (B, max_stop)),
    )


def make_decode_state(model_cfg: ModelConfig, rt_cfg: RuntimeConfig,
                      device) -> DecodeState:
    B = rt_cfg.max_batch

    def zeros(shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=device)

    def pads(shape):
        return torch.full(shape, -1, dtype=torch.int32, device=device)

    return DecodeState(
        token_ids=zeros((B,)),
        context_lens=zeros((B,)),
        prompt_lens=zeros((B,)),
        gen_lens=zeros((B,)),
        page_tables=zeros((B, rt_cfg.max_pages_per_seq)),
        active=zeros((B,), torch.bool),
        token_counts=zeros((B, model_cfg.vocab_size)),
        sampling=make_sampling_params(B, rt_cfg.max_stop_token_ids, device),
        lora_idx=pads((B,)),
        history=pads((B, rt_cfg.max_length)),
        bad_words=pads((B, rt_cfg.max_bad_words, rt_cfg.max_bad_word_len)),
        ngram_n=zeros((B,)),
    )
