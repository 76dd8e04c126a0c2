"""A configuration, a traffic mix, the loop it names and a per-layer
metric added as new files, with new entries in ``BENCHMARK.json``, are
found by name: no file that was there is edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""Frames a compiled executor call served."""
from bench_port.harness import spans


def read(ctx):
    calls = spans.executor_calls(ctx.spans)
    return spans.frames_served(ctx.spans) / calls if calls else None
'''

LOOP = '''"""The closed loop, under a name of its own."""
from bench_port.loops.closed import clients, run  # noqa: F401
'''

RUN = """
import json, sys, time, torch
from bench_port.harness import cell
from pathlib import Path
root = Path(sys.argv[1])
b, c, cfg, mix = cell.load("tiny.pairs", root)
out = {}
for trace in (False, True):
    r, _ = cell.run(b, c, cfg, mix, 5, 0.3, trace, torch.device("cpu"),
                    time.perf_counter())
    out[trace] = r
print(json.dumps({"e2e": out[False]["metrics"],
                  "layer": out[True]["metrics"],
                  "correct": [out[False]["correct"], out[True]["correct"]],
                  "harness": cell.__file__}))
"""


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench_file = tmp_path / "BENCHMARK.json"
    before = _digests(tmp_path)

    here = tmp_path / "bench_port"
    cfg = json.loads((here / "configs" / "spatial7-1080p.json").read_text())
    cfg.update(name="tiny", height=16, width=24,
               pipelines=["harris-m", "unsharp-m"])
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (here / "traffic" / "pairs.json").write_text(json.dumps(
        {"loop": "relay", "clients_per_pipeline": 2, "pool_frames": 6,
         "check_per_pipeline": 1}))
    (here / "loops" / "relay.py").write_text(LOOP)
    (here / "layer_metrics" / "frames_per_call.py").write_text(READER)
    bench = json.loads(bench_file.read_text())
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "bench_port/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.pairs", "config": "tiny",
                               "traffic": "pairs", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_per_call.tput",
                               "unit": "frames", "better": "higher",
                               "source": "program_span",
                               "layer": "serving engine", "moves": "fps",
                               "workloads": ["tiny.pairs"]})
    bench_file.write_text(json.dumps(bench))

    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {Path("BENCHMARK.json")}

    res = subprocess.run(
        [sys.executable, "-c", RUN, str(tmp_path)], cwd=tmp_path,
        capture_output=True, text=True, timeout=240,
        env={**os.environ,
             "PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}"})
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["harness"].startswith(str(tmp_path))
    assert got["correct"] == [True, True]
    assert set(got["e2e"]) == {"fps", "setup_s"}
    assert got["layer"]["frames_per_call.tput"]["value"] == 2.0
    assert "engine_host_ms.tput" not in got["layer"]
