"""The traffic repeats exactly from a seed; the camera mix arrives on a
1/30 s grid."""
import json
from pathlib import Path

import pytest

from bench_port.harness import traffic
from bench_port.loops import closed, periodic

HERE = Path(__file__).resolve().parents[1]
PIPES = ["a", "b", "c", "d"]


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 70 + 3, -5])
def test_same_seed_same_traffic(seed):
    mix = _mix("cams30")
    a = periodic.clients(mix, PIPES, seed)
    b = periodic.clients(mix, PIPES, seed)
    assert a == b
    assert periodic.arrivals(mix, a, 3.0) == periodic.arrivals(mix, b, 3.0)


def test_other_seeds_reorder_the_same_arrivals():
    mix = dict(_mix("cams30"), clients=8)
    a = periodic.clients(mix, PIPES, 1)
    b = periodic.clients(mix, PIPES, 2)
    assert [c.pipeline for c in a] == [c.pipeline for c in b]
    assert [c.phase_s for c in a] != [c.phase_s for c in b]
    assert sorted(c.phase_s for c in a) == sorted(c.phase_s for c in b)
    da = [d for d, _, _ in periodic.arrivals(mix, a, 5.0)]
    db = [d for d, _, _ in periodic.arrivals(mix, b, 5.0)]
    assert da == db and len(da) == mix["clients"] * 150


def test_cams30_is_periodic_on_a_30_hz_grid():
    mix = _mix("cams30")
    assert mix["loop"] == "periodic" and mix["rate_hz"] == 30
    cls = periodic.clients(mix, PIPES, 123)
    n = len(cls)
    assert sorted(round(c.phase_s * 30 * n, 9) for c in cls) == \
        list(range(n))
    plan = periodic.arrivals(mix, cls, 2.0)
    assert [d for d, _, _ in plan] == sorted(d for d, _, _ in plan)
    for d, ci, k in plan:
        assert d == pytest.approx(cls[ci].phase_s + k / 30, abs=1e-12)
        assert d < 2.0
    # as many clients on every pipeline, in turn
    assert n % len(PIPES) == 0
    assert [c.pipeline for c in cls] == PIPES * (n // len(PIPES))


def test_host_mix_is_a_closed_loop_of_four_clients_a_pipeline():
    mix = _mix("host")
    cls = closed.clients(mix, PIPES, 5)
    assert mix["loop"] == "closed" and len(cls) == 4 * len(PIPES)
    assert closed.clients(mix, PIPES, 5) == cls
    assert all(c.phase_s == 0.0 for c in cls)


def test_frame_indices_walk_the_pool_from_a_seeded_base():
    mix = {"loop": "closed", "clients_per_pipeline": 1, "pool_frames": 5}
    (c,) = closed.clients(mix, ["a"], 9)
    got = [traffic.frame_index(mix, c, k) for k in range(7)]
    assert got == [(c.frame_base + k) % 5 for k in range(7)]
