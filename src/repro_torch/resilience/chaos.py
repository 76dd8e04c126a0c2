"""Seeded fault-injection harness for the serving control plane.

Deterministic chaos: every fault decision flows from one
``random.Random(seed)``, so a failing soak run replays bit-for-bit from
its seed. Fault types cover the control plane's whole surface:

  * **compile failures** — injected through the PlanCache's
    ``compile_hook`` seam, *inside* its retry boundary, so injected
    failures exercise retry-then-fallback rather than bypassing it.
  * **executor exceptions** — :class:`ChaosExecutor` proxies a cached
    executor and raises :class:`InjectedFault` on a seeded coin flip
    per call; installed via the cache's ``executor_wrapper`` seam.
  * **malformed frames** — :meth:`ChaosMonkey.corrupt` rewrites a
    client frame dict into a NaN frame, a wrong-shape frame, or a
    wrong-dtype frame; admission must quarantine these as structured
    rejections, never raise.
  * **cache-eviction storms** — :meth:`ChaosMonkey.maybe_storm` clears
    the cache's executor level mid-serve (``evict_executors``), forcing
    recompiles under load.
  * **client churn** — the soak driver asks :meth:`ChaosMonkey.roll`
    whether to close (cancelling queued frames) and reopen a stream.

The monkey counts every injection per kind (:attr:`ChaosMonkey.injected`)
so a soak can assert it actually exercised ≥ N faults of every type —
a chaos harness that silently injects nothing proves nothing.
"""
from __future__ import annotations

import random
from collections import Counter
from typing import Mapping

import numpy as np

FAULT_KINDS = ("compile", "executor", "nan_frame", "shape_frame",
               "dtype_frame", "evict_storm", "churn")


class InjectedFault(RuntimeError):
    """A deliberately injected failure; carries its fault kind."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        super().__init__(f"injected {kind} fault"
                         + (f": {detail}" if detail else ""))


class ChaosMonkey:
    """Seeded fault source. ``rates`` maps fault kind -> probability per
    opportunity; unset kinds never fire. One RNG drives everything, so
    a fixed seed plus a deterministic driver replays exactly."""

    def __init__(self, seed: int = 0, **rates: float):
        unknown = set(rates) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds {sorted(unknown)}; "
                             f"have {FAULT_KINDS}")
        self.rng = random.Random(seed)
        self.rates = {k: float(rates.get(k, 0.0)) for k in FAULT_KINDS}
        self.injected: Counter = Counter()

    def roll(self, kind: str) -> bool:
        """One seeded coin flip for ``kind``; counts hits."""
        if self.rng.random() < self.rates[kind]:
            self.injected[kind] += 1
            return True
        return False

    # ------------------------------------------------- plan-cache seams
    def compile_hook(self, label: str) -> None:
        """Install as ``cache.compile_hook``: fails real compiles."""
        if self.roll("compile"):
            raise InjectedFault("compile", label)

    def executor_wrapper(self, ex):
        """Install as ``cache.executor_wrapper``."""
        return ChaosExecutor(ex, self)

    def maybe_storm(self, cache) -> int:
        """Clear the cache's executor level on a seeded flip; returns
        the number of executors evicted (0 = no storm)."""
        if self.roll("evict_storm"):
            return cache.evict_executors()
        return 0

    # ----------------------------------------------------- client-side
    def corrupt(self, frames: Mapping[str, np.ndarray]
                ) -> tuple[dict, str | None]:
        """Maybe corrupt one input of a client frame dict; returns
        (frames, kind) where kind is None for clean passes. At most one
        corruption per frame — admission reports the *first* defect, so
        stacking faults would make reason accounting ambiguous."""
        for kind in ("nan_frame", "shape_frame", "dtype_frame"):
            if not self.roll(kind):
                continue
            out = dict(frames)
            name = sorted(out)[self.rng.randrange(len(out))]
            arr = np.asarray(out[name])
            if kind == "nan_frame":
                bad = arr.astype(np.float32, copy=True)
                bad[tuple(self.rng.randrange(s) for s in bad.shape)] = np.nan
            elif kind == "shape_frame":
                bad = arr.reshape(-1)[: max(1, arr.size - 1)]
            else:
                bad = arr.astype(np.complex64)
            out[name] = bad
            return out, kind
        return dict(frames), None


class ChaosExecutor:
    """Transparent executor proxy that may raise before delegating.

    Forwards every attribute (smem_bytes, dag, plan, chunk, device,
    rows_per_step, frame_state_bytes, ...) to the wrapped executor, so
    engines cannot tell chaos is installed until a call blows up.
    """

    def __init__(self, ex, monkey: ChaosMonkey):
        object.__setattr__(self, "_ex", ex)
        object.__setattr__(self, "_monkey", monkey)

    def __call__(self, *args, **kwargs):
        if self._monkey.roll("executor"):
            raise InjectedFault("executor",
                                getattr(self._ex.dag, "name", "?"))
        return self._ex(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._ex, name)


def install_chaos(cache, monkey: ChaosMonkey) -> None:
    """Wire a monkey into a PlanCache's fault-injection seams."""
    cache.compile_hook = monkey.compile_hook
    cache.executor_wrapper = monkey.executor_wrapper
