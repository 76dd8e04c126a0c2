"""Outcome types and admission classes of the serving control plane.

The frame engine's strict mode needs two pieces of it: :class:`Priority`
(stamped on every request) and :class:`FailedFrame` (an executor
exception travels to the caller as a result, never strands a batch).
The other outcome types are here because the reconciliation identity
``offered == completed + shed + rejected + cancelled + failed +
in_flight`` names them all.
"""
from __future__ import annotations

from .admission import Priority
from .outcomes import (CancelledFrame, FailedFrame, RejectedFrame,
                       ShedFrame)

__all__ = ["CancelledFrame", "FailedFrame", "Priority", "RejectedFrame",
           "ShedFrame"]
