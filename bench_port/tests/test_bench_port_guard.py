"""No run may load JAX or the JAX package; the port's name begins with
the JAX package's and must not trip the check. Without a card a run
prints no result and fails."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.harness import guard

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("modules, found", [
    ({"repro_torch", "repro_torch.imaging", "reprox", "numpy"}, []),
    ({"repro", "repro_torch"}, ["repro"]),
    ({"repro.core.dag"}, ["repro"]),
    ({"jax.numpy", "jaxlib.xla_client", "flax.linen"},
     ["flax", "jax", "jaxlib"]),
    ({"jax_extras", "jaxlibs"}, []),
])
def test_top_level_names_compare_whole(modules, found):
    assert guard.forbidden_modules(modules) == found


def _python(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", **env})


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The whole harness on the CPU at a small size, in a fresh process:
    what the port and the harness load is checked, not their sources."""
    code = """
import json, sys, time, torch
from bench_port.harness import cell, guard
for wl in ("spatial7-1080p.host", "video4-1080p.cams30"):
    b, c, cfg, mix = cell.load(wl)
    r, _ = cell.run(b, c, dict(cfg, height=16, width=24),
                    dict(mix, pool_frames=8), 3, 0.2, False,
                    torch.device("cpu"), time.perf_counter())
    assert r["correct"], r
print(json.dumps(guard.forbidden_modules()))
"""
    res = _python(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_fails_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "spatial7-1080p.host", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=240, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout == ""
