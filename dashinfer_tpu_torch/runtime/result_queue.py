"""Streaming result queue.

Reference: `ResultQueueImpl` (csrc/common/engine_runtime.h:144-318,
result_queue.cpp) — drain-all-available `Get()` with blocking semantics
(spin-then-wait), `GetNoWait()`, `GenerateStatus()`; elements carry new token
ids + optional logprobs (SURVEY.md §8.7).
"""

import threading
import time
from typing import Dict, List, Optional

from dashinfer_tpu_torch.runtime.request import GenerateRequestStatus, StatInfo


class GeneratedElements:
    """One batch of streamed results (reference GeneratedElements,
    allspark.h:447-470)."""

    def __init__(self):
        self.ids_from_generate: List[int] = []
        # per-token: list of (token_id, logprob) pairs (top_logprobs)
        self.log_probs_list: List[List] = []
        self.token_logprobs_list: List[float] = []

    def __len__(self):
        return len(self.ids_from_generate)


class ResultQueue:
    _FINAL = (GenerateRequestStatus.GenerateFinished,
              GenerateRequestStatus.GenerateInterrupted,
              GenerateRequestStatus.InternalError)

    def __init__(self, uuid: str):
        self.uuid = uuid
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._logprobs: List = []
        self._token_logprobs: List[float] = []
        self._cursor = 0
        self._status = GenerateRequestStatus.Init
        self._stat = StatInfo()

    # -- engine side --------------------------------------------------------
    def append(self, token_ids: List[int], logprobs: Optional[List] = None,
               token_logprobs: Optional[List[float]] = None):
        with self._cond:
            self._tokens.extend(token_ids)
            if logprobs:
                self._logprobs.extend(logprobs)
            if token_logprobs:
                self._token_logprobs.extend(token_logprobs)
            self._cond.notify_all()

    def set_status(self, status: GenerateRequestStatus):
        with self._cond:
            self._status = status
            self._cond.notify_all()

    def set_stat(self, stat: StatInfo):
        self._stat = stat

    # -- user side ----------------------------------------------------------
    def GenerateStatus(self) -> GenerateRequestStatus:
        with self._cond:
            return self._status

    def RequestStatInfo(self) -> Dict[str, float]:
        return self._stat.as_dict()

    def _drain_locked(self) -> GeneratedElements:
        el = GeneratedElements()
        el.ids_from_generate = self._tokens[self._cursor:]
        if self._logprobs:
            el.log_probs_list = self._logprobs[self._cursor:]
        if self._token_logprobs:
            el.token_logprobs_list = self._token_logprobs[self._cursor:]
        self._cursor = len(self._tokens)
        return el

    def Get(self, timeout_s: Optional[float] = None) -> Optional[GeneratedElements]:
        """Block until new tokens exist or generation reaches a final state,
        then drain everything available (reference result_queue.cpp:120-200)."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond:
            while True:
                if self._cursor < len(self._tokens):
                    return self._drain_locked()
                if self._status in self._FINAL:
                    return self._drain_locked()  # possibly empty, like reference
                wait = None if deadline is None else max(deadline - time.monotonic(), 0)
                if wait == 0:
                    return None
                self._cond.wait(timeout=wait if wait is not None else 1.0)

    def GetNoWait(self) -> GeneratedElements:
        with self._cond:
            return self._drain_locked()

    def GetAllGeneratedTokens(self) -> List[int]:
        with self._cond:
            return list(self._tokens)
