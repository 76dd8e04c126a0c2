"""Scheduling primitives for slot-based continuous batching."""
from .scheduling import BoundedFifo, RunningStat, assemble_batch, pad_batch

__all__ = ["BoundedFifo", "RunningStat", "assemble_batch", "pad_batch"]
