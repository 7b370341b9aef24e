"""Per-request generation configuration.

Equivalent of the reference `GenerateConfig` (csrc/interface/allspark.h:98-165)
and its Python builder (python/pyhie/allspark/generation_config.py). Beam
search is config surface only in the reference too (num_beams unsupported,
allspark.h:102-106).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass
class GenerationConfig:
    max_length: int = 2048          # prompt + generated tokens cap
    min_length: int = 0             # suppress EOS until this many new tokens
    num_beams: int = 1              # beam search: config surface only, like
                                    # the reference ("unsupported in current
                                    # version", allspark.h:102-106)
    do_sample: bool = True
    early_stopping: bool = True     # stop at EOS
    temperature: float = 1.0
    top_k: int = 50                 # 0 = full vocab (top-p only)
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    length_penalty: float = 1.0     # (beam-search only; kept for API parity)
    no_repeat_ngram_size: int = 0
    eos_token_id: int = -1
    stop_words_ids: Sequence[Sequence[int]] = ()
    bad_words_ids: Sequence[Sequence[int]] = ()
    seed: int = 0
    logprobs: bool = False
    top_logprobs: int = 0           # <=10, reference device_context.h:182
    lora_name: Optional[str] = None
    # {"type": "json_object"} or {"type": "json_object", "schema": {...}}
    # (reference guided decoding, allspark.h:151-155)
    response_format: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # multimodal embedding injections: placeholder token id -> array
    mm_info: Optional[Any] = None
    # Qwen2-VL mRoPE per-token positions [3, seq] (computed host-side,
    # reference hie_allspark_worker.py:31-104) + decode-phase position delta
    mrope_positions: Optional[Any] = None
    mrope_position_delta: int = 0

    def update(self, d: Dict[str, Any]) -> "GenerationConfig":
        for k, v in d.items():
            if not hasattr(self, k):
                raise KeyError(f"unknown GenerationConfig field: {k}")
            setattr(self, k, v)
        return self

    def validate(self, vocab_size: int, engine_max_length: int) -> None:
        if self.max_length > engine_max_length:
            raise ValueError(
                f"request max_length {self.max_length} exceeds engine "
                f"max_length {engine_max_length}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0 or self.top_k > vocab_size:
            raise ValueError(f"top_k out of range: {self.top_k}")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_logprobs > 10:
            raise ValueError("top_logprobs > 10 unsupported")
        if self.num_beams > 1:
            raise ValueError(
                "beam search (num_beams > 1) unsupported — config surface "
                "kept for API parity (reference allspark.h:102-106)")
