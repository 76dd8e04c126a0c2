"""Per-request SLA deadlines and the shed-on-overload policy.

A deadline is stamped at admission as an *absolute* time on the obs
clock (``repro_torch.obs.trace.now`` — the same monotonic timebase the
span timestamps use, so a trace viewer can line deadline misses up
against the executor timeline). Two policies consume it:

  * **shed-on-overload** (:func:`pick_shed_victim`) — when a queue is
    full and new work arrives, the controller looks for the *worst*
    resident item: lowest priority class first, then most
    deadline-expired, then oldest deadline, then oldest arrival. The
    newcomer displaces the victim only when that actually improves the
    queue — the victim is lower priority, or already expired. Otherwise
    the newcomer is the worst item and is rejected instead (saturated,
    retryable). Full queues therefore always hold the best available
    work.
  * **shed-expired** (:func:`split_expired`) — work whose deadline
    passed while queued cannot meet its SLA; executing it anyway would
    spend executor time making *other* frames miss too. The engines
    sweep expired items out at the top of each ``step`` and report them
    as structured ``ShedFrame(reason="deadline")`` results.

Both are pure functions over (item, priority, deadline, age) accessors
so the engines' request types stay dumb dataclasses.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable


def overdue_s(deadline: float | None, now: float) -> float:
    """Seconds past the deadline (negative = still has slack; None = no
    deadline, treated as never overdue)."""
    if deadline is None:
        return float("-inf")
    return now - deadline


def shed_order_key(priority: int, deadline: float | None, age: float,
                   now: float) -> tuple:
    """Sort key under which the *maximum* is the best shed victim:
    lowest priority class, then most overdue, then least slack, then
    oldest. ``age`` is the admission timestamp (smaller = older)."""
    return (priority, overdue_s(deadline, now),
            -(deadline if deadline is not None else float("inf")), -age)


def pick_shed_victim(items: Iterable[Any], new_priority: int,
                     now: float,
                     priority_of: Callable[[Any], int],
                     deadline_of: Callable[[Any], float | None],
                     age_of: Callable[[Any], float]) -> Any | None:
    """The queued item the newcomer may displace, or None.

    The victim is the max of :func:`shed_order_key`; displacement is
    allowed only when the victim is strictly lower priority than the
    newcomer OR already past its deadline. A full queue of same-priority,
    in-SLA work refuses the newcomer rather than churning (FIFO order is
    part of the engines' delivery contract).
    """
    worst = None
    worst_key = None
    for it in items:
        k = shed_order_key(priority_of(it), deadline_of(it), age_of(it), now)
        if worst_key is None or k > worst_key:
            worst, worst_key = it, k
    if worst is None:
        return None
    if priority_of(worst) > new_priority:
        return worst
    if overdue_s(deadline_of(worst), now) > 0:
        return worst
    return None


def split_expired(items: Iterable[Any], now: float,
                  deadline_of: Callable[[Any], float | None]
                  ) -> tuple[list, list]:
    """Partition into (live, expired) by deadline at time ``now``."""
    live, expired = [], []
    for it in items:
        (expired if overdue_s(deadline_of(it), now) > 0 else live).append(it)
    return live, expired
