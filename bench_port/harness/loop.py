"""What a measured window records, whichever loop drives it.

Every frame gets a due instant: in an open loop its arrival on its
client's clock, in a closed loop the instant its client offered it. Its
latency runs from there to the return of the ``step()`` that delivered
it. A frame the server refuses (its queue is full: the backpressure of
strict serving) is dropped, as a live camera drops it; a frame the
server accepted and then failed, or has not delivered when the run
stops waiting, is undelivered. Both count as missing their latency.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from . import traffic


@dataclasses.dataclass
class Window:
    seconds: float                   # the window's length as measured
    offered: int = 0                 # frames due in the window
    delivered: list = dataclasses.field(default_factory=list)
    # (client, k, due_s, done_s) of every frame due in the window that
    # was delivered; seconds from the window's start
    missing: list = dataclasses.field(default_factory=list)
    # (client, k) due in the window, accepted, and failed or never delivered
    refused: list = dataclasses.field(default_factory=list)
    # (client, k) due in the window that the server refused (open loop)
    accepted: dict = dataclasses.field(
        default_factory=lambda: defaultdict(list))
    # client -> every k the server accepted, in order: a stream's history
    lag_s: list = dataclasses.field(default_factory=list)
    # open loop: how late each frame was offered after its due instant
    backlog_end: int = 0             # frames pending as the window closed
    counted: int = 0                 # frames counted in fps


def frame(mix, pool, client, k):
    """The pool frame ``client`` offers as its k-th."""
    return pool[traffic.frame_index(mix, client, k)]
