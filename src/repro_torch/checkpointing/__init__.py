"""Checkpoints (npz shards, JSON index, async writer) and the
fault-tolerance supervisor."""
from . import checkpoint
from .supervisor import (HardwareFailure, Preemption, Supervisor,
                         SupervisorConfig)

__all__ = ["HardwareFailure", "Preemption", "Supervisor", "SupervisorConfig",
           "checkpoint"]
