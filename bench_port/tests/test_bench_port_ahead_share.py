"""The reader of ``h2d_ahead_share`` on synthetic spans: the bytes whose
copy to the card the program issued ahead of their batch (the
``ahead_bytes`` of the ``engine.assemble`` spans) over the bytes those
spans handed from host memory (``h2d_bytes``); nothing from a program
without the counter or when nothing moved; and its entries in
``BENCHMARK.json``, found by name."""
import json

import pytest

from bench_port.harness import cell
from bench_port.tests.test_bench_port_trace_readers import (HERE, READERS,
                                                            SPANS, _ctx,
                                                            _read, _span)


def _ahead(spans, ahead):
    """``spans`` with ``ahead_bytes`` set on the ``engine.assemble``
    spans, from ``ahead`` in their order (None: the key left out)."""
    values = iter(ahead)
    out = []
    for e in spans:
        attrs = dict(e.attrs)
        if e.name == "engine.assemble":
            v = next(values)
            if v is not None:
                attrs["ahead_bytes"] = v
        out.append(_span(e.name, e.ts_ns, e.dur_ns, e.depth, **attrs))
    return out


def _reference_rung(spans):
    """``spans`` and an ``engine.execute`` of the reference rung that
    handed 1000 bytes over itself: not an ``engine.assemble`` span, so
    not counted."""
    return spans + [_span("engine.execute", 990, 5, 1, reference=True,
                          h2d_bytes=1000)]


def _without_h2d(spans):
    return [_span(e.name, e.ts_ns, e.dur_ns, e.depth,
                  **{k: v for k, v in e.attrs.items() if k != "h2d_bytes"})
            for e in spans]


@pytest.mark.parametrize("spans,share", [
    (_ahead(SPANS, (600, 200)), 1.0),
    (_ahead(SPANS, (600, 0)), 0.75),         # one span's frames inline
    (_ahead(SPANS, (0, 0)), 0.0),
    (_ahead(SPANS, (600, None)), 0.75),      # one span without the key
    (_reference_rung(_ahead(SPANS, (600, 200))), 1.0),
    (_ahead(SPANS, (None, None)), None),     # a program without it
    (_ahead(_without_h2d(SPANS), (0, 0)), None),    # nothing moved
    ([], None),
], ids=["all", "one-inline", "none-ahead", "one-without-key",
        "reference-rung-not-counted", "no-counter", "nothing-moved",
        "no-spans"])
def test_ahead_share_is_the_bytes_issued_ahead_over_the_handed_bytes(
        spans, share):
    got = _read("h2d_ahead_share", _ctx(spans=spans))
    assert got == (None if share is None else pytest.approx(share))


@pytest.mark.parametrize("name,where", [
    ("h2d_ahead_share.tput", "spatial7-1080p.host"),
    ("h2d_ahead_share.u8", "spatial7-4k-u8.host")])
def test_the_share_is_found_by_name_in_its_cell(name, where):
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    m = {e["name"]: e for e in bench["per_layer"]}[name]
    assert m["workloads"] == [where]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) \
        == ("ratio", "higher", "program_counter", "host-to-device input",
            "fps")
    assert m in cell.metrics_of(bench, cells[where], "per_layer")
    for other in set(cells) - {where}:
        assert m not in cell.metrics_of(bench, cells[other], "per_layer")
    assert callable(cell.load_module(READERS / "h2d_ahead_share.py").read)
