"""Request lifecycle objects.

Reference: `GenerateContext`/`Request` (csrc/core/model/generate_context.h,
request.h), `RequestHandle` (csrc/common/engine_runtime.h:109), status enum
(csrc/interface/allspark.h:420-430).
"""

import dataclasses
import enum
import threading
import time
import uuid as _uuid
from typing import Any, Dict, List, Optional

from dashinfer_tpu_torch.config import GenerationConfig


class GenerateRequestStatus(str, enum.Enum):
    Init = "Init"
    ContextFinished = "ContextFinished"
    Generating = "Generating"
    GenerateFinished = "GenerateFinished"
    GenerateInterrupted = "GenerateInterrupted"  # evicted on cache OOM
    InternalError = "InternalError"


@dataclasses.dataclass
class StatInfo:
    """Per-request stats (reference engine_runtime.h:117-136 keys)."""

    arrival_time: float = 0.0
    first_token_time: float = 0.0
    time_to_first_token: float = 0.0   # seconds
    time_in_queue: float = 0.0
    context_tps: float = 0.0
    generate_tps: float = 0.0
    prefix_cache_hit_len: int = 0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Request:
    """Internal scheduler-side request state."""

    uuid: str
    input_ids: List[int]
    gen_cfg: GenerationConfig
    status: GenerateRequestStatus = GenerateRequestStatus.Init
    slot: int = -1                      # decode slot, -1 = not admitted
    prefix_len: int = 0                 # prefix-cache hit length
    prefilled_len: int = 0              # tokens whose KV is in cache
    generated_ids: List[int] = dataclasses.field(default_factory=list)
    logical_pages: List[List[int]] = dataclasses.field(default_factory=list)
    # ^ logical_pages[j] = the L physical page ids of sequence page j
    prefix_nodes: list = dataclasses.field(default_factory=list)
    stat: StatInfo = dataclasses.field(default_factory=StatInfo)
    # guided decoding state (engine/guided.py), None unless json mode
    format_enforcer: Any = None
    enqueue_time: float = dataclasses.field(default_factory=time.monotonic)
    interrupted: bool = False
    release_requested: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.input_ids)

    @property
    def max_total_len(self) -> int:
        return self.gen_cfg.max_length

    def remaining_budget(self) -> int:
        return self.max_total_len - self.prompt_len - len(self.generated_ids)


class RequestHandle:
    """Opaque user-facing handle (reference RequestHandle,
    engine_runtime.h:109)."""

    def __init__(self, uuid: str, model_name: str):
        self.uuid = uuid
        self.model_name = model_name

    def __repr__(self):
        return f"RequestHandle({self.model_name}:{self.uuid[:8]})"


def new_uuid() -> str:
    return _uuid.uuid4().hex
