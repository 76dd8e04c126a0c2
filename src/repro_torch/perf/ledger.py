"""Benchmark ledger and regression gate.

Every benchmark run can append one schema-validated row to a JSONL
ledger — append-only, one row per (run, kind), keyed by git SHA + seed +
config fingerprint so any row is attributable to an exact code state and
reproducible invocation, and loadable as a time series
(``read_ledger``). It writes only to the path its caller gives.

The regression gate compares a fresh row against a baseline: per-metric
tolerance bands (:class:`Band`) pin the expected metrics per kind, and
:func:`gate` returns human-readable failures. Deterministic model
metrics (predicted cycles, ring bytes, alloc bits, power) get exact or
near-exact bands — they must not drift silently. Wall-clock metrics get
wide bands: the gate is for regressions, not for run-to-run speed
differences.

A copy of the JAX package's ledger: equal inputs give equal rows,
fingerprints and gate verdicts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import time

LEDGER_SCHEMA = "bench_ledger/v1"
BASELINE_SCHEMA = "bench_baseline/v1"

_ROW_KEYS = ("schema", "kind", "git_sha", "seed", "config_fingerprint",
             "ts", "metrics")


def git_sha(cwd: str | None = None) -> str:
    """Current commit SHA, or 'unknown' outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd,
                             capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and len(sha) == 40 else "unknown"
    except Exception:                    # noqa: BLE001 — git is optional
        return "unknown"


def config_fingerprint(config: dict) -> str:
    """Short stable hash of a run configuration (sorted canonical JSON)."""
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def make_row(kind: str, seed: int, config: dict, metrics: dict,
             ts: float | None = None, sha: str | None = None) -> dict:
    """Build one validated ledger row."""
    row = {
        "schema": LEDGER_SCHEMA,
        "kind": kind,
        "git_sha": sha if sha is not None else git_sha(),
        "seed": int(seed),
        "config_fingerprint": config_fingerprint(config),
        "ts": float(ts) if ts is not None else time.time(),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    errs = validate_row(row)
    if errs:                             # pragma: no cover — construction bug
        raise ValueError(f"make_row built an invalid row: {errs}")
    return row


def validate_row(row) -> list[str]:
    """Schema check for one ledger row; returns errors (empty = valid)."""
    errs: list[str] = []
    if not isinstance(row, dict):
        return [f"row must be a dict, got {type(row).__name__}"]
    for k in _ROW_KEYS:
        if k not in row:
            errs.append(f"missing key {k!r}")
    if errs:
        return errs
    if row["schema"] != LEDGER_SCHEMA:
        errs.append(f"schema is {row['schema']!r}, "
                    f"expected {LEDGER_SCHEMA!r}")
    if not isinstance(row["kind"], str) or not row["kind"]:
        errs.append("kind must be a non-empty string")
    if not isinstance(row["git_sha"], str) or not row["git_sha"]:
        errs.append("git_sha must be a non-empty string")
    if not isinstance(row["seed"], int):
        errs.append("seed must be an int")
    if not isinstance(row["config_fingerprint"], str) \
            or len(row["config_fingerprint"]) != 16:
        errs.append("config_fingerprint must be a 16-char hex string")
    if not isinstance(row["ts"], (int, float)) or row["ts"] < 0:
        errs.append("ts must be a number >= 0")
    m = row["metrics"]
    if not isinstance(m, dict) or not m:
        errs.append("metrics must be a non-empty dict")
    else:
        for k, v in m.items():
            if not isinstance(k, str):
                errs.append(f"metric key {k!r} must be a string")
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errs.append(f"metric {k!r} must be a number, got {v!r}")
    return errs


def append_row(path: str, row: dict) -> None:
    """Validate and append one row to the JSONL ledger (atomic line)."""
    errs = validate_row(row)
    if errs:
        raise ValueError(f"refusing to append invalid ledger row: "
                         + "; ".join(errs))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    line = json.dumps(row, sort_keys=True)
    if "\n" in line:                     # pragma: no cover — json escapes \n
        raise ValueError("row serialized with embedded newline")
    with open(path, "a") as f:
        f.write(line + "\n")


def read_ledger(path: str, strict: bool = True
                ) -> list[dict] | tuple[list[dict], list[str]]:
    """Load the ledger; schema-corrupt rows are *rejected*, not skipped.

    ``strict=True`` (the default, what the gate uses) raises ValueError
    naming every bad line — a ledger that cannot be trusted end-to-end
    must not silently gate. ``strict=False`` returns
    ``(valid_rows, errors)`` for forensic reading of a damaged file.
    """
    rows: list[dict] = []
    errors: list[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: not JSON ({e.msg})")
                continue
            errs = validate_row(row)
            if errs:
                errors.append(f"line {lineno}: " + "; ".join(errs))
                continue
            rows.append(row)
    if strict:
        if errors:
            raise ValueError(f"{path}: {len(errors)} corrupt ledger row(s): "
                             + " | ".join(errors))
        return rows
    return rows, errors


def latest_row(rows: list[dict], kind: str) -> dict | None:
    """Most recent row of one kind (by ts, then file order)."""
    mine = [r for r in rows if r["kind"] == kind]
    return max(mine, key=lambda r: r["ts"]) if mine else None


# ------------------------------------------------------------------ gate
@dataclasses.dataclass(frozen=True)
class Band:
    """Tolerance band for one metric, as current/baseline ratio bounds.

    ``low <= current/baseline <= high`` passes. ``required=False`` lets
    a metric be absent from the current run (e.g. cost analysis
    unavailable on some backend) without failing the gate; present
    values are still band-checked. A baseline of exactly 0 compares by
    absolute difference against ``zero_tol`` instead (a ratio against
    zero is meaningless).
    """
    metric: str
    low: float
    high: float
    required: bool = True
    zero_tol: float = 1e-12

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Band":
        return Band(**d)


def gate(baseline_metrics: dict, current_metrics: dict,
         bands: list[Band]) -> list[str]:
    """Compare a run against the baseline; returns failures (empty = ok).

    Only banded metrics are compared — the baseline may carry extra
    context metrics without forcing a band on each. A banded metric
    missing from the *baseline* is a gate-configuration failure (the
    band is unenforceable), from the *current* run a failure unless the
    band is marked optional.
    """
    failures: list[str] = []
    for b in bands:
        if b.metric not in baseline_metrics:
            failures.append(f"{b.metric}: banded but absent from baseline "
                            f"(re-run with --update-baseline)")
            continue
        if b.metric not in current_metrics:
            if b.required:
                failures.append(f"{b.metric}: absent from current run")
            continue
        base = float(baseline_metrics[b.metric])
        cur = float(current_metrics[b.metric])
        if base == 0.0:
            if abs(cur) > b.zero_tol:
                failures.append(f"{b.metric}: baseline 0, current {cur:g} "
                                f"(|delta| > {b.zero_tol:g})")
            continue
        ratio = cur / base
        if not (b.low <= ratio <= b.high):
            failures.append(
                f"{b.metric}: {cur:g} is {ratio:.3f}x of baseline "
                f"{base:g} (band [{b.low:g}, {b.high:g}])")
    return failures


# -------------------------------------------------------------- baseline
def load_baseline(path: str) -> dict:
    """Load and check a ``bench_baseline/v1`` file."""
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"{path}: schema is {data.get('schema')!r}, "
                         f"expected {BASELINE_SCHEMA!r}")
    if not isinstance(data.get("kinds"), dict):
        raise ValueError(f"{path}: missing 'kinds' mapping")
    return data


def baseline_bands(data: dict, kind: str) -> list[Band]:
    entry = data["kinds"].get(kind) or {}
    return [Band.from_dict(d) for d in entry.get("bands", [])]


def baseline_metrics(data: dict, kind: str) -> dict:
    entry = data["kinds"].get(kind) or {}
    return dict(entry.get("metrics", {}))


def write_baseline(path: str, kinds: dict, note: str = "") -> None:
    """Write a baseline file: {kind: {"metrics": {...}, "bands": [...]}}."""
    data = {"schema": BASELINE_SCHEMA, "note": note,
            "git_sha": git_sha(),
            "kinds": {
                k: {"metrics": {m: float(v)
                                for m, v in e["metrics"].items()},
                    "bands": [b.to_dict() if isinstance(b, Band) else b
                              for b in e["bands"]]}
                for k, e in kinds.items()}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
