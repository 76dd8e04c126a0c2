"""Scheduling primitives for slot-based continuous batching.

Bounded admission in front, FIFO per stream, oldest-work-first batch
assembly behind. The frame engine (imaging/engine.py) is built on these;
the LM engine (serve/engine.py) predates them and implements the same
shape inline — migrating it here is an open refactor.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Hashable, Iterable, Mapping


class BoundedFifo:
    """FIFO with a hard capacity — ``push`` refuses instead of growing.

    Refusal is the backpressure signal: the caller (client or load
    generator) must retry after draining, which is exactly the behavior a
    streaming accelerator's full input queue presents to its producer.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._q: deque = deque()

    def push(self, item: Any) -> bool:
        if len(self._q) >= self.capacity:
            return False
        self._q.append(item)
        return True

    def pop(self) -> Any:
        return self._q.popleft()

    def peek(self) -> Any:
        return self._q[0]

    def remove(self, item: Any) -> None:
        """Remove a specific resident item (identity match) — the
        shed-on-overload eviction path: the control plane picks a
        victim by priority/deadline, then pulls it out of the middle."""
        for i, it in enumerate(self._q):
            if it is item:
                del self._q[i]
                return
        raise ValueError("item not in queue")

    def drain(self) -> list:
        """Pop everything, FIFO order — cancelling a closed stream's
        queue, or sweeping deadline-expired work for re-filtering."""
        items = list(self._q)
        self._q.clear()
        return items

    def __iter__(self):
        return iter(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


def assemble_batch(queues: Mapping[Hashable, BoundedFifo], max_batch: int,
                   age_of: Callable[[Any], float],
                   compatible: Callable[[Any, Any], bool] | None = None,
                   ) -> tuple[Hashable, list]:
    """Oldest-head-first batch assembly across per-stream FIFOs.

    Picks the stream whose head item is oldest (per ``age_of``, lower =
    older), then pops up to ``max_batch`` items from that stream in FIFO
    order, stopping early when ``compatible(first, item)`` says an item
    cannot share the batch (e.g. mismatched frame shapes must not be
    padded together). Returns (stream_key, items); (None, []) when idle.
    """
    live = [(k, q) for k, q in queues.items() if q]
    if not live:
        return None, []
    key, q = min(live, key=lambda kq: age_of(kq[1].peek()))
    first = q.peek()
    items = [q.pop()]
    while q and len(items) < max_batch:
        if compatible is not None and not compatible(first, q.peek()):
            break
        items.append(q.pop())
    return key, items


def pad_batch(items: list, slots: int, make_idle: Callable[[], Any]) -> list:
    """Fill a partial batch up to ``slots`` with idle entries.

    Slot-based engines compile their executor once at the full batch size
    and run partial batches with idle slots rather than recompiling per
    fill level; this is the one place that padding policy lives. Raises
    if the batch already overflows the slot count — that is an assembly
    bug, not a padding concern.
    """
    if len(items) > slots:
        raise ValueError(f"batch of {len(items)} exceeds {slots} slots")
    return items + [make_idle() for _ in range(slots - len(items))]


@dataclasses.dataclass
class RunningStat:
    """Streaming mean/max/min (Welford-lite, no variance needed here)."""
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    min: float = float("inf")

    def observe(self, x: float) -> None:
        self.count += 1
        self.total += x
        self.max = max(self.max, x)
        self.min = min(self.min, x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "max": self.max if self.count else 0.0,
                "min": self.min if self.count else 0.0}
