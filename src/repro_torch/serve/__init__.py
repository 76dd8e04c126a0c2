"""LM serving engine + scheduling primitives shared with imaging/.

The engine (and its model-stack imports) loads lazily: the frame-serving
subsystem imports ``repro_torch.serve.scheduling`` and must not pay for —
or inherit the failure surface of — the transformer stack it never uses.
"""
from .scheduling import BoundedFifo, RunningStat, assemble_batch, pad_batch

_ENGINE = {"Completed", "Engine", "Request"}
_PLANNER = {"KVPlan", "plan_kv"}

__all__ = sorted({"BoundedFifo", "RunningStat", "assemble_batch",
                  "pad_batch"} | _ENGINE | _PLANNER)


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    if name in _PLANNER:
        from . import kv_planner
        return getattr(kv_planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
