"""The tools' twins (``tools/obs_report_torch.py``,
``tools/debug_memory_torch.py``) against the JAX package's tools, and the
import rule every twin keeps.

``obs_report``: both tools' ``main(argv)`` on the same artifacts, one of
each schema (a span trace with the resilience spans and memtrace counter
tracks, the repository's ``perf_report/v1`` ``BENCH_perf.json`` and a
slowed copy for ``--diff``, the reference's ``memtrace/v1`` capture, a
quiet and a firing ``telemetry/v1`` snapshot) and one made invalid of
each: stdout and exit code equal for every flag. The port's own memtrace
capture renders differently in its header and summary lines and in each
buffer's ring rows and waste, which are the port's join.

``debug_memory``: a reduced gemma3-1b train step on meta lists the
hand-computed largest outputs first; gemma3-1b x train_4k at full config
runs to its end.

Every twin: no ``jax`` or ``repro`` import (an ``ast`` scan), and each
runs in a fresh interpreter where both are unimportable.
"""
import ast
import copy
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.imaging import PlanCache as JaxPlanCache
from repro_torch.imaging import PlanCache
from repro_torch.models import get_config
from repro_torch.obs import MetricsRegistry, export, trace
from repro_torch.obs.telemetry import AlertRule, TelemetryCollector

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = sorted([*(ROOT / "examples").glob("*_torch.py"),
                *(ROOT / "tools").glob("*_torch.py")])
# the twins this slice adds, beside the earlier train_lm_torch.py and
# run_matrix_torch.py
SLICE = ["examples/quickstart_torch.py", "examples/stream_frames_torch.py",
         "examples/stream_video_torch.py", "examples/overlap_depth_torch.py",
         "examples/tune_pipeline_torch.py",
         "examples/memtrace_pipeline_torch.py",
         "examples/trace_serving_torch.py", "examples/imagen_dse_torch.py",
         "examples/serve_lm_torch.py", "tools/obs_report_torch.py",
         "tools/debug_memory_torch.py"]


def load(path: str):
    spec = importlib.util.spec_from_file_location(
        "tool_" + pathlib.Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reports():
    return load("tools/obs_report.py"), load("tools/obs_report_torch.py")


# ------------------------------------------------------------- artifacts
def _trace_artifact(mt: dict) -> dict:
    """A span trace with the engine and resilience spans the SLO view
    reads, and ``mt``'s counter tracks merged on its execute span."""
    t = trace.Tracer(enabled=True)
    for i in range(3):
        with t.span("engine.step", delivered=4, deadline_missed=i % 2,
                    failed=0):
            with t.span("engine.execute", pipeline=mt["pipeline"]):
                with t.span("executor.call", pipeline=mt["pipeline"]):
                    pass
    for reason in ("rate", "rate", "shape"):
        with t.span("resilience.reject", reason=reason):
            pass
    with t.span("resilience.shed", reason="deadline"):
        pass
    for delay in (0.002, 0.04):
        with t.span("resilience.retry", delay_s=delay):
            pass
    with t.span("resilience.fallback", rung="compiled"):
        pass
    data = export.to_chrome_trace(t.events(), process_name="artifact")
    return export.merge_counter_tracks(data, [mt])


def _telemetry_artifact(fire: bool) -> dict:
    reg = MetricsRegistry()
    bad = reg.counter("e_deadline_missed")
    total = reg.counter("e_frames_completed")
    rule = AlertRule(name="e:burn", kind="burn_rate",
                     bad="e_deadline_missed", total="e_frames_completed",
                     objective=0.95, threshold=2.0, window_s=10.0,
                     min_events=10)
    col = TelemetryCollector(reg, rules=[rule])
    for now in range(6):
        total.inc(20)
        if fire and now >= 3:
            bad.inc(10)
        col.sample_once(now=float(now))
    assert bool(col.firing()) == fire
    return col.snapshot()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """name -> path of each artifact, valid and invalid."""
    d = tmp_path_factory.mktemp("artifacts")
    jmt = JaxPlanCache().memtrace_for("unsharp-m", 48, 32)
    with open(ROOT / "BENCH_perf.json") as f:
        perf = json.load(f)
    slow = copy.deepcopy(perf)
    for i, p in enumerate(slow["pipelines"]):
        p["measured"]["fps"] *= 0.5 if i % 3 == 0 else 0.97
    slow["pipelines"].pop()
    tr = _trace_artifact(jmt)
    arts = {"trace": tr, "perf": perf, "perf_slow": slow, "memtrace": jmt,
            "telemetry": _telemetry_artifact(False),
            "telemetry_firing": _telemetry_artifact(True)}
    arts["trace_invalid"] = {**tr, "traceEvents": [{"ph": "X"}]}
    arts["perf_invalid"] = {**perf, "pipelines": [{"pipeline": "x"}]}
    arts["memtrace_invalid"] = {k: v for k, v in jmt.items()
                                if k != "summary"}
    arts["telemetry_invalid"] = {k: v for k, v in arts["telemetry"].items()
                                 if k != "alerts"}
    paths = {}
    for name, data in arts.items():
        paths[name] = str(d / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(data, f)
    return paths


ARTIFACTS = ["trace", "perf", "memtrace", "telemetry", "telemetry_firing",
             "trace_invalid", "perf_invalid", "memtrace_invalid",
             "telemetry_invalid"]
FLAGS = [[], ["--validate"], ["--top", "3"], ["--slo"], ["--perf"],
         ["--memtrace"], ["--alerts"], ["--slo", "--validate"]]


def _run(main, argv, capsys):
    """(exit code, stdout); an exception stands in for the exit code (the
    reference renders the flame summary of a trace it found invalid, and
    a span without ``ts`` raises there)."""
    try:
        rc = main(argv)
    except Exception as e:  # noqa: BLE001 - compared, not handled
        rc = (type(e).__name__, str(e))
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "_".join(f) or "none")
@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_obs_report_equals_reference(reports, artifacts, artifact, flags,
                                     capsys):
    ref, port = reports
    argv = [artifacts[artifact], *flags]
    exp = _run(ref.main, argv, capsys)
    got = _run(port.main, argv, capsys)
    assert got == exp


def test_obs_report_out_equals_reference(reports, artifacts, tmp_path,
                                         capsys):
    ref, port = reports
    out = str(tmp_path / "clean.json")
    argv = [artifacts["trace"], "--out", out]
    exp = _run(ref.main, argv, capsys)
    with open(out) as f:
        exp_file = f.read()
    got = _run(port.main, argv, capsys)
    with open(out) as f:
        assert f.read() == exp_file
    assert got == exp and exp[0] == 0


@pytest.mark.parametrize("pair", [("perf", "perf_slow"),
                                  ("perf_slow", "perf"),
                                  ("perf", "perf_invalid")])
@pytest.mark.parametrize("tol", [None, "0.02"])
def test_obs_report_diff_equals_reference(reports, artifacts, pair, tol,
                                          capsys):
    ref, port = reports
    argv = ["--diff", *(artifacts[p] for p in pair)] + \
        (["--tol", tol] if tol else [])
    exp = _run(ref.main, argv, capsys)
    assert _run(port.main, argv, capsys) == exp


def test_obs_report_exit_codes(reports, artifacts, capsys):
    """The exit codes the equality above holds, spelled out: 1 for a
    firing alert and for an invalid file under --validate."""
    _, port = reports
    assert port.main([artifacts["telemetry"], "--alerts"]) == 0
    assert port.main([artifacts["telemetry_firing"], "--alerts"]) == 1
    for name in ("trace", "perf", "memtrace"):
        assert port.main([artifacts[name], "--validate"]) == 0
        assert port.main([artifacts[f"{name}_invalid"], "--validate"]) == 1
    capsys.readouterr()


def test_obs_report_port_memtrace(reports, tmp_path, capsys):
    """The port's capture of the same plan carries the kernel's
    shared-memory rings: rendered by each tool, every line is equal but
    the header (the port adds ``depth=``) and the summary (the port adds
    its shared-memory rings), and the ring rows, which are the port's
    own join (``alloc``, ``waste%``); both tools validate it."""
    ref, port = reports
    mt = PlanCache(device="cpu").memtrace_for("unsharp-m", 48, 32)
    path = str(tmp_path / "memtrace_port.json")
    with open(path, "w") as f:
        json.dump(mt, f)
    rc_ref, exp = _run(ref.main, [path], capsys)
    rc, got = _run(port.main, [path], capsys)
    assert rc == rc_ref == 0
    exp, got = exp.splitlines(), got.splitlines()
    assert len(got) == len(exp)
    assert "depth=1" in got[0] and got[0].replace("  depth=1", "") == exp[0]
    assert got[1] == exp[1]
    assert got[-1].startswith(exp[-1].split(" worst")[0])
    assert f"shared-memory rings {mt['summary']['smem_ring_bytes']} B" \
        in got[-1]
    for g, e in zip(got[2:-1], exp[2:-1]):
        # buffer, kind, mem, ports equal; alloc and waste are the join;
        # peak, port pressure and stalls equal
        g, e = g.split(), e.split()
        assert g[:4] == e[:4] and g[5] == e[5] and g[7:] == e[7:]
    assert _run(port.main, [path, "--validate"], capsys)[0] == 0
    assert _run(ref.main, [path, "--validate"], capsys)[0] == 0


# ---------------------------------------------------------- debug_memory
@pytest.fixture(scope="module")
def debug_memory():
    return load("tools/debug_memory_torch.py")


def test_debug_memory_largest_outputs_by_hand(debug_memory):
    """A reduced gemma3-1b (one super-block, d 256, vocab 65536) at B=1,
    S=2048: the largest outputs are the float32 logits chunks (1, 512,
    65536) of the chunked cross-entropy, forward and backward, then the
    embedding table's float32 gradient (65536, 256) and the optimizer's
    float32 temporaries of the table's size."""
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=6,
                              d_model=256, n_heads=2, n_kv_heads=1,
                              head_dim=64, d_ff=512, vocab=65536)
    rows = debug_memory.largest(
        debug_memory.run_step(cfg, "train", 1, 2048), 25)
    chunk = 512 * 65536 * 4
    top = [r for r in rows if r[0] == chunk]
    assert rows[:len(top)] == top and len(top) >= 3
    assert all(r[1] == "f32" for r in top)
    assert {r[2] for r in top} <= {(1, 512, 65536), (512, 65536),
                                   (65536, 512)}
    assert (1, 512, 65536) in {r[2] for r in top}
    table = [r for r in rows[len(top):] if r[0] == 65536 * 256 * 4]
    assert rows[len(top):len(top) + len(table)] == table
    assert {r[2] for r in table} <= {(65536, 256), (256, 65536)}
    grads = {r[3]: r[4] for r in table if r[2] == (65536, 256)}
    assert {"embedding_dense_backward", "mm"} <= set(grads)
    assert grads["embedding_dense_backward"] == "embed (EmbeddingBackward0)"
    assert "adamw_update()" in {r[4] for r in table}


def test_debug_memory_full_train_cell(debug_memory, capsys):
    rows = debug_memory.main(["--arch", "gemma3-1b", "--device", "cpu",
                              "--top", "5"])
    out = capsys.readouterr().out.splitlines()
    assert "status: run" in out[0]
    assert "temp GiB: not known" in out[1]
    assert "no sharding applied" in out[2]
    assert out[3].split() == ["GiB", "dtype", "op", "shape", "module"]
    assert len(rows) == 5 and len(out) == 9
    # the float32 logits chunk (B, 512, vocab) of train_4k: 128 GiB, as
    # the unembed's product (B * 512, vocab) and in the chunk's shape
    assert all(r[:2] == (256 * 512 * 262144 * 4, "f32") for r in rows)
    assert {r[2] for r in rows} >= {(256 * 512, 262144), (256, 512, 262144)}
    assert all(line.split()[0] == "128.00" for line in out[4:])


# ------------------------------------------------------------- imports
@pytest.mark.parametrize("path", SLICE)
def test_twin_imports_no_reference(path):
    assert (ROOT / path) in TWINS
    tree = ast.parse((ROOT / path).read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "repro")]
    assert not bad, f"{path} imports {bad}"


BLOCKED_RUN = r"""
import importlib.util, os, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "repro"):
            raise ImportError(f"{name} must not be imported")
        return None
sys.meta_path.insert(0, Block())
root = sys.argv[1]
runs = [
    ("examples/quickstart_torch.py", []),
    ("examples/stream_frames_torch.py", []),
    ("examples/stream_video_torch.py", []),
    ("examples/overlap_depth_torch.py", []),
    ("examples/tune_pipeline_torch.py", []),
    ("examples/memtrace_pipeline_torch.py", []),
    ("examples/trace_serving_torch.py", []),
    ("examples/imagen_dse_torch.py", ["--out", "dse.png"]),
    ("examples/serve_lm_torch.py", []),
    ("tools/obs_report_torch.py",
     [os.path.join(root, "BENCH_perf.json"), "--validate"]),
    ("tools/debug_memory_torch.py",
     ["--arch", "gemma3-1b", "--shape", "decode_32k", "--top", "3"]),
]
for i, (path, argv) in enumerate(runs):
    spec = importlib.util.spec_from_file_location(f"twin{i}",
                                                  os.path.join(root, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(argv + ["--device", "cpu"] if "obs_report" not in path
                  else argv)
    assert rc in (None, 0) or not isinstance(rc, int), (path, rc)
    print("ran", path, flush=True)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print("all ran")
"""


def test_twins_run_with_reference_unimportable(tmp_path):
    """Every twin of this slice runs (``--device cpu``, the reference's
    sizes) in a fresh interpreter that cannot import jax or repro."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    run = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(ROOT)],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env=env)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    ran = [ln.split()[1] for ln in run.stdout.splitlines()
           if ln.startswith("ran ")]
    assert ran == SLICE and run.stdout.rstrip().endswith("all ran")
