"""Performance attribution, and measurement tools for the port's kernels
on the card.

The JAX package's attribution lab, closing the loop between the paper's
analytic predictions and the running system:

  * :mod:`model` — predicted steady-state cycles/frame and bytes moved
    of the generated accelerator, from the ILP schedule and the compiled
    plan (``predict(plan, h) -> PerfModel``; equal to the reference's).
  * :mod:`measure` — the measured side: steady-state executor timing on
    the card, the launch's counted operations and bytes, engine-step
    self-time breakdowns from obs traces, the card's peaks (data sheet
    and calibrated) and the roofline classification.
  * :mod:`attribution` — joins the two into per-pipeline efficiency
    ratios with time fractions that provably sum to 1, rendered as the
    ``perf_report/v1`` artifact.
  * :mod:`ledger` — schema-validated benchmark rows keyed by git SHA +
    seed + config fingerprint, and the regression gate that compares a
    run against a baseline within explicit tolerance bands.

Beside them, :mod:`timing` (CUDA events and device time), which the
kernel tools under ``tools/`` (``kernel_times.py``,
``standalone_times.py``, ``geometry_sweep.py``) time with.
"""
import importlib

# the lab's exports by module, loaded on first use: the planner
# (``core/dse.py`` reads ``perf.model``) and the timing helpers keep
# their small import surface
_EXPORTS = {
    "model": ("PerfModel", "predict", "exact_fractions"),
    "measure": ("MeasuredPerf", "Peaks", "classify", "executor_cost",
                "measure_executor", "step_breakdown"),
    "attribution": ("PERF_SCHEMA", "attribute", "build_report",
                    "perf_text", "validate_perf_report"),
    "ledger": ("LEDGER_SCHEMA", "Band", "append_row", "config_fingerprint",
               "gate", "git_sha", "make_row", "read_ledger",
               "validate_row"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_HOME[name]}", __name__), name)
