"""Admission classes for the serving control plane."""
from __future__ import annotations

import enum


class Priority(enum.IntEnum):
    """Admission classes; lower value = more protected from shedding."""
    HIGH = 0
    NORMAL = 1
    LOW = 2
