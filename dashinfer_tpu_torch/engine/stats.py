"""Engine statistics (reference AsEngineStat, allspark.h:271-307; updated in
UpdateAsEngineStat as_engine.cpp:1929+)."""

import dataclasses
import time
from typing import Dict


@dataclasses.dataclass
class EngineStat:
    model_name: str = ""
    total_span: int = 0
    used_span: int = 0
    free_span: int = 0
    pendings: int = 0
    runnings: int = 0
    interrupted: int = 0
    total_prefill_tokens: int = 0
    total_gen_tokens: int = 0
    generate_token_persec: float = 0.0
    process_token_persec: float = 0.0
    _last_ts: float = dataclasses.field(default_factory=time.monotonic)
    _last_gen: int = 0
    _last_prefill: int = 0

    def tick_throughput(self):
        now = time.monotonic()
        dt = now - self._last_ts
        if dt <= 0:
            return
        self.generate_token_persec = (self.total_gen_tokens - self._last_gen) / dt
        self.process_token_persec = (
            self.total_prefill_tokens - self._last_prefill) / dt
        self._last_ts = now
        self._last_gen = self.total_gen_tokens
        self._last_prefill = self.total_prefill_tokens

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        for k in list(d):
            if k.startswith("_"):
                d.pop(k)
        return d
