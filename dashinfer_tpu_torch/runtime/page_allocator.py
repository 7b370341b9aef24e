"""Host-side page allocator with two-phase (reserve -> commit) admission.

Re-design of the reference's frame/span managers with their "pres"
reserved-frames protocol (csrc/runtime/cache/frame_manager.h:23-216;
admission rollback as_engine_prefill.cpp:210-265, model.cpp:1095-1183).
On TPU the pool is one device array, so "allocation" is pure integer
bookkeeping on the host: a free list of page ids plus a reservation ledger.
The scheduler reserves worst-case pages before dispatching a prefill or a
page-boundary-crossing decode step, and rolls back on failure — so a batch
never OOMs mid-step.
"""

import threading
from typing import Dict, List, Optional

from dashinfer_tpu_torch.utils import get_logger

logger = get_logger("page_allocator")


class NoFreePages(Exception):
    """Raised when a reservation cannot be satisfied (reference status
    ALLSPARK_CACHE_MEMORY_OUT -> victim eviction, as_engine_decode.cpp:98-181)."""


class PageAllocator:
    def __init__(self, num_pages: int):
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._num_pages = num_pages
        self._reserved: Dict[str, int] = {}  # request uuid -> page count

    @property
    def num_pages(self) -> int:
        return self._num_pages

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free) - sum(self._reserved.values())

    def grow(self, additional: int) -> None:
        """Extend the pool (used if the engine re-plans after warmup;
        reference GrowUntil/GrowBy, model.cpp:1527-1576)."""
        with self._lock:
            start = self._num_pages
            self._free.extend(range(start + additional - 1, start - 1, -1))
            self._num_pages += additional

    # -- two-phase protocol ------------------------------------------------
    def reserve(self, uuid: str, count: int) -> bool:
        """Phase 1: claim capacity without picking page ids."""
        with self._lock:
            avail = len(self._free) - sum(self._reserved.values())
            if count > avail:
                return False
            self._reserved[uuid] = self._reserved.get(uuid, 0) + count
            return True

    def release_reservation(self, uuid: str) -> None:
        with self._lock:
            self._reserved.pop(uuid, None)

    def commit(self, uuid: str, count: int) -> List[int]:
        """Phase 2: convert reservation into concrete page ids."""
        with self._lock:
            held = self._reserved.get(uuid, 0)
            if count > held:
                raise NoFreePages(
                    f"commit {count} exceeds reservation {held} for {uuid}")
            pages = [self._free.pop() for _ in range(count)]
            remaining = held - count
            if remaining:
                self._reserved[uuid] = remaining
            else:
                self._reserved.pop(uuid, None)
            return pages

    # -- direct path (reserve+commit in one step) --------------------------
    def alloc(self, count: int) -> List[int]:
        with self._lock:
            avail = len(self._free) - sum(self._reserved.values())
            if count > avail:
                raise NoFreePages(f"need {count} pages, {avail} free")
            return [self._free.pop() for _ in range(count)]

    def free(self, pages: List[int]) -> None:
        with self._lock:
            self._free.extend(pages)
