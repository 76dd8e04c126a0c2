"""One run of one cell: set up, measure the window, check, report.

Everything the cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names, its
traffic in ``bench_port/traffic/<traffic>.json``, the loop that mix names
in ``bench_port/loops/<loop>.py``, its server in
``bench_port/servers/<config's server>.py`` and each per-layer metric's
reader in ``bench_port/layer_metrics/<name before the first dot>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd.profiler import record_function

from . import card, check, frames, loop, profile

HERE = Path(__file__).resolve().parents[1]       # bench_port/
ROOT = HERE.parent


def load_module(path: Path):
    """A module of the benchmark loaded from its file."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"bench_port._found.{path.parent.name}.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(workload: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic mix) of ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / "bench_port" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, mix


def metrics_of(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those that
    list it, or that list no cells and move a metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    spans: list                      # the program's trace events
    trace: profile.DeviceTrace | None
    capacity: int                    # frames an executor call can take
    frame_bytes: int                 # input + output bytes of one frame
    peak_bytes_per_s: float | None
    smem: dict                       # pipeline -> CTA shared memory bytes
    # of the batches served since the window opened, as the engine
    # counted them


def _p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def _by_second(win) -> list[list[float]]:
    """Latencies, ms, of the delivered frames by the second they were
    due in."""
    out: list[list[float]] = [[] for _ in range(int(win.seconds) + 1)]
    for _, _, due, done in win.delivered:
        if due < win.seconds:
            out[int(due)].append((done - due) * 1e3)
    return out


def _load(win: loop.Window, marks: list, t_start: float) -> dict:
    """How the run went, for the reader of its line: set-up by phase,
    frames a second, p95 a second, backlog at the close, refusals, how
    late the open loop offered its frames."""
    lag = [x * 1e3 for x in win.lag_s]
    return {
        "setup": {"before_s": marks[0][1] - t_start,
                  **{n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])}},
        "window_s": win.seconds, "counted": win.counted,
        "per_second": np.bincount([int(d[3]) for d in win.delivered
                                   if d[3] < win.seconds]).tolist(),
        "p95_ms_per_second": [_p95(v) for v in _by_second(win) if v],
        "backlog_end": win.backlog_end,
        "refused": len(win.refused),
        "offer_lag_p95_ms": _p95(lag) if lag else None,
        "offer_lag_max_ms": max(lag) if lag else None,
    }


def _per_layer(bench: dict, cell: dict, ctx: Context) -> dict:
    """Each of the cell's per-layer metrics its reader finds."""
    values = {}
    for m in metrics_of(bench, cell, "per_layer"):
        fam = m["name"].split(".", 1)[0]
        v = load_module(HERE / "layer_metrics" / f"{fam}.py").read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return values


def _end_to_end(bench: dict, cell: dict, win: loop.Window, setup_s: float,
                drain_s: float) -> dict:
    """The cell's end-to-end metrics. A frame refused or never delivered
    counts in the tail at the window plus the wait after it."""
    lat = [(done - due) * 1e3 for _, _, due, done in win.delivered]
    lat += [(win.seconds + drain_s) * 1e3] * (len(win.missing)
                                               + len(win.refused))
    known = {"fps": win.counted / win.seconds,
             "latency_p95_ms": _p95(lat) if lat else None,
             "setup_s": setup_s}
    values = {}
    for m in metrics_of(bench, cell, "end_to_end"):
        if m["name"] not in known:
            raise KeyError(f"the harness computes no {m['name']!r}")
        if known[m["name"]] is not None:
            values[m["name"]] = {"value": float(known[m["name"]]),
                                 "unit": m["unit"]}
    return values


def run(bench: dict, cell: dict, config: dict, mix: dict, seed: int,
        seconds: float, trace: bool, device: torch.device,
        t_start: float) -> tuple[dict, list]:
    """One run: the result line's object (``checks`` last) and the
    earlier lines to print, (name, value) pairs."""
    from repro_torch.obs import trace as program_trace

    h, w = config["height"], config["width"]
    server_mod = load_module(HERE / "servers" / f"{config['server']}.py")
    traffic_loop = load_module(HERE / "loops" / f"{mix['loop']}.py")
    marks = [("start", time.perf_counter())]
    pool = frames.make_pool(mix["pool_frames"], h, w, seed, device)
    marks.append(("pool_s", time.perf_counter()))
    server = server_mod.Server(config, device)
    marks.append(("server_s", time.perf_counter()))
    clients = traffic_loop.clients(mix, config["pipelines"], seed)
    server.warm_up(pool, clients)
    server.open(clients)
    marks.append(("warm_up_s", time.perf_counter()))
    sampler = check.Sampler(int(mix["check_per_pipeline"]), seed)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    lines = []
    prof = None
    if trace:
        program_trace.clear()
        program_trace.enable(capacity=1 << 21)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])])
        prof.start()
    else:
        lines.append(("energy_start", card.smi() if cuda else
                      "not available"))
    mark = record_function("bench.window")
    setup_s = time.perf_counter() - t_start
    mark.__enter__()
    win = traffic_loop.run(server, clients, mix, pool, seconds, sampler,
                           seed, on_close=lambda: _close(mark, prof, trace))
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    if not trace:
        lines.append(("energy_end", card.smi() if cuda else
                      "not available"))

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    smi = card.smi(("power.limit",)) if cuda else "not available"
    if isinstance(smi, list):
        dev["power_limit_w"] = smi[0]["power.limit"]
    out = {}
    if trace:
        tr = profile.from_events(prof.profiler.kineto_results.events()) \
            if cuda else None
        prof = None                   # its events are read: free them
        ctx = Context(spans=program_trace.events(), trace=tr,
                      capacity=server.capacity,
                      # every pipeline reads one input frame and writes
                      # one output frame of float32 pixels
                      frame_bytes=2 * h * w * 4,
                      peak_bytes_per_s=card.peak_bytes_per_s(kind)
                      if cuda else None,
                      smem=server.served_smem())
        program_trace.clear()
        values = _per_layer(bench, cell, ctx)
        if tr is not None:
            dev["busy_s"] = profile.busy_s(tr)
            dev["window_s"] = profile.window_s(tr)
            out["breakdown"] = {"device_ops": profile.by_name(tr),
                                "idle_gaps": profile.idle_gaps(tr)}
    else:
        values = _end_to_end(bench, cell, win, setup_s,
                             float(mix.get("drain_s", 60.0)))

    # the program's state goes before the reference runs
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    checks = check.compare(sampler, mix, pool, win, config["pipelines"],
                           int(config["check"]["max_ulp"]), device)
    result = {
        "correct": check.passed(checks),
        "attempted": win.offered,
        "failed": len(win.missing) + len(win.refused),
        "metrics": values, "device": dev, **out,
        "load": _load(win, marks, t_start),
        "checks": checks,
    }
    return result, lines


def _close(mark, prof, trace: bool) -> None:
    """The window closes: its annotation ends, tracing stops."""
    mark.__exit__(None, None, None)
    if trace:
        from repro_torch.obs import trace as program_trace
        program_trace.disable()
        prof.stop()


def report(result: dict, lines: list, stream_out=sys.stdout,
           stream_err=sys.stderr) -> None:
    """Earlier lines first, the compared numbers as the last lines of
    standard error, the result as the last line of standard output."""
    for name, value in lines:
        print(f"{name}: {json.dumps(value)}", file=stream_out, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=stream_err, flush=True)
    print(json.dumps(result), file=stream_out, flush=True)

