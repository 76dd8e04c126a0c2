"""The card: its name, its power limit and energy counter
(``nvidia-smi``), and the published peaks a roofline is drawn against."""
from __future__ import annotations

import subprocess

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth (at the 700 W limit)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

SMI_FIELDS = ("total_energy_consumption", "power.draw", "power.limit",
              "clocks.sm")


def smi(fields=SMI_FIELDS) -> list[dict] | str:
    """One dict per card: each of ``fields`` as ``nvidia-smi`` reads it,
    or ``"not available"`` where it cannot; ``"not available"`` without
    ``nvidia-smi``."""
    cards: list[dict] = []
    for f in fields:
        try:
            res = subprocess.run(
                ["nvidia-smi", f"--query-gpu={f}",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return "not available"
        values = res.stdout.strip().splitlines() if res.returncode == 0 \
            else []
        for i, v in enumerate(values):
            while len(cards) <= i:
                cards.append({})
            cards[i][f] = v.strip()
    for c in cards:
        for f in fields:
            c.setdefault(f, "not available")
    return cards or "not available"


def peak_bytes_per_s(kind: str) -> float:
    if kind not in PEAK_BYTES_PER_S:
        raise ValueError(f"no published memory rate for {kind!r}")
    return PEAK_BYTES_PER_S[kind]
