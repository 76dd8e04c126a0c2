"""The reader of ``step_overlap_share`` on synthetic spans: the frames
delivered whose batch an earlier step launched (the ``launched_ahead``
of the ``engine.step`` spans) over the frames delivered; nothing from a
program without the counter or when nothing was delivered; and its
entries in ``BENCHMARK.json``, found by name."""
import json

import pytest

from bench_port.harness import cell
from bench_port.tests.test_bench_port_trace_readers import (HERE, READERS,
                                                            SPANS, _ctx,
                                                            _read, _span)


def _ahead(spans, ahead):
    """``spans`` with ``launched_ahead`` set on the ``engine.step`` spans,
    from ``ahead`` in their order (None: the key left out)."""
    values = iter(ahead)
    out = []
    for e in spans:
        attrs = dict(e.attrs)
        if e.name == "engine.step":
            v = next(values)
            if v is not None:
                attrs["launched_ahead"] = v
        out.append(_span(e.name, e.ts_ns, e.dur_ns, e.depth, **attrs))
    return out


def _failed_step(spans):
    """``spans`` and a step that returned a failed batch: no
    ``delivered``, no ``launched_ahead``."""
    return spans + [_span("engine.step", 1000, 50, 0, failed=4)]


def _drain(spans):
    """``spans`` and a step that only waited for the batch in flight, an
    ``engine.execute`` span without a call inside."""
    return spans + [_span("engine.step", 1000, 50, 0, delivered=3,
                          launched_ahead=3),
                    _span("engine.execute", 1005, 40, 1)]


@pytest.mark.parametrize("spans,share", [
    (_ahead(SPANS, (2, 1)), 1.0),
    (_ahead(SPANS, (0, 1)), 1 / 3),          # the first step launched its own
    (_ahead(SPANS, (0, 0)), 0.0),            # no lookahead (CPU, tiled)
    (_ahead(SPANS, (2, None)), 2 / 3),       # one span without the key
    (_failed_step(_ahead(SPANS, (2, 1))), 1.0),
    (_drain(_ahead(SPANS, (0, 1))), 4 / 6),
    (_ahead(SPANS, (None, None)), None),     # a program without it
    (_ahead([_span(e.name, e.ts_ns, e.dur_ns, e.depth, **{
        k: v for k, v in e.attrs.items() if k != "delivered"})
        for e in SPANS], (0, 0)), None),     # nothing delivered
    ([], None),
], ids=["all", "first-own", "none-ahead", "one-without-key", "failed-step",
        "drain", "no-counter", "nothing-delivered", "no-spans"])
def test_overlap_share_is_the_frames_launched_ahead_over_those_delivered(
        spans, share):
    got = _read("step_overlap_share", _ctx(spans=spans))
    assert got == (None if share is None else pytest.approx(share))


@pytest.mark.parametrize("name,where", [
    ("step_overlap_share.tput", "spatial7-1080p.host"),
    ("step_overlap_share.u8", "spatial7-4k-u8.host"),
    ("step_overlap_share.dev", "spatial7-1080p.device")])
def test_the_overlap_share_is_found_by_name_in_its_cell(name, where):
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    m = {e["name"]: e for e in bench["per_layer"]}[name]
    assert m["workloads"] == [where]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) \
        == ("ratio", "higher", "program_span", "serving engine", "fps")
    assert m in cell.metrics_of(bench, cells[where], "per_layer")
    for other in set(cells) - {where}:
        assert m not in cell.metrics_of(bench, cells[other], "per_layer")
    assert callable(cell.load_module(READERS / "step_overlap_share.py").read)
