"""The reader of ``h2d_pinned_share`` on synthetic spans: the bytes the
program's ``engine.assemble`` spans staged through page-locked buffers
(``pinned_bytes``) over the bytes every span handed from host memory to
the card (``h2d_bytes``); nothing from a program without the counter or
when nothing moved; and its entry in ``BENCHMARK.json``, found by
name."""
import json

import pytest

from bench_port.harness import cell
from bench_port.tests.test_bench_port_trace_readers import (HERE, READERS,
                                                            SPANS, _ctx,
                                                            _read, _span)


def _pinned(spans, pinned):
    """``spans`` with ``pinned_bytes`` set on the ``engine.assemble``
    spans, from ``pinned`` in their order (None: the key left out)."""
    values = iter(pinned)
    out = []
    for e in spans:
        attrs = dict(e.attrs)
        if e.name == "engine.assemble":
            v = next(values)
            if v is not None:
                attrs["pinned_bytes"] = v
        out.append(_span(e.name, e.ts_ns, e.dur_ns, e.depth, **attrs))
    return out


def _without_h2d(spans):
    return [_span(e.name, e.ts_ns, e.dur_ns, e.depth,
                  **{k: v for k, v in e.attrs.items() if k != "h2d_bytes"})
            for e in spans]


@pytest.mark.parametrize("spans,share", [
    (_pinned(SPANS, (600, 200)), 1.0),
    (_pinned(SPANS, (600, None)), 0.75),     # one span not staged
    (_pinned(SPANS, (0, 0)), 0.0),
    (_pinned(SPANS, (None, None)), None),    # the parent: no counter
    (_pinned(_without_h2d(SPANS), (0, 0)), None),   # nothing moved
    ([], None),
], ids=["all", "with-and-without", "none-staged", "no-counter",
        "nothing-moved", "no-spans"])
def test_pinned_share_is_the_staged_bytes_over_the_handed_bytes(spans,
                                                                share):
    got = _read("h2d_pinned_share", _ctx(spans=spans))
    assert got == (None if share is None else pytest.approx(share))


@pytest.mark.parametrize("name,where", [
    ("h2d_pinned_share.tput", "spatial7-1080p.host")])
def test_the_share_is_found_by_name_in_its_cell(name, where):
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    m = {e["name"]: e for e in bench["per_layer"]}[name]
    assert m["workloads"] == [where]
    assert m["moves"] == "fps"
    assert m in cell.metrics_of(bench, cells[where], "per_layer")
    for other in set(cells) - {where}:
        assert m not in cell.metrics_of(bench, cells[other], "per_layer")
    assert callable(cell.load_module(READERS / "h2d_pinned_share.py").read)
