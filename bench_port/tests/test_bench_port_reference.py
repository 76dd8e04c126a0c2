"""The benchmark's plain reference against the port's CPU path, pipeline
by pipeline, bit for bit at a small frame size; and its bfloat16 control
visibly off."""
import numpy as np
import pytest
import torch

from bench_port.harness import check
from bench_port.reference import pipelines as reference
from repro_torch.core import algorithms

H, W, T = 23, 37, 10


def _video(seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.random((T, H, W), dtype=np.float32))


def test_the_reference_covers_every_pipeline_of_the_port():
    assert set(reference.SPATIAL) == set(algorithms.ALGORITHMS)
    assert set(reference.TEMPORAL) == set(algorithms.VIDEO_ALGORITHMS)
    for name, make in algorithms.VIDEO_ALGORITHMS.items():
        back = make().cumulative_extent(temporal=True)[0]
        assert reference.history_depth(name) == back + 1


@pytest.mark.parametrize("name", sorted(algorithms.ALGORITHMS))
def test_spatial_reference_equals_the_port(name):
    x = _video(1)[0]
    dag = algorithms.ALGORITHMS[name]()
    want = algorithms.execute_reference(dag, {"in": x})[
        dag.output_stages()[0]]
    got = reference.run(name, x[None])
    assert check.ulp_gap(got, want) == 0


@pytest.mark.parametrize("name", sorted(algorithms.VIDEO_ALGORITHMS))
def test_temporal_reference_equals_the_port_at_every_frame(name):
    video = _video(2)
    dag = algorithms.VIDEO_ALGORITHMS[name]()
    want = algorithms.execute_reference_video(dag, {"in": video})
    for t in range(T):
        got = reference.run(name, video[:t + 1])
        assert check.ulp_gap(got, want[t]) == 0, t


@pytest.mark.parametrize("name", sorted({**reference.SPATIAL,
                                         **reference.TEMPORAL}))
def test_bfloat16_control_is_off_by_far_more_than_rounding(name):
    video = _video(3) * 10   # strong enough edges that canny keeps some
    exact = reference.run(name, video)
    low = reference.run(name, video, dtype=reference.CONTROL_DTYPE)
    assert check.ulp_gap(low, exact) > 2 ** 16


def test_ulp_gap_counts_units_in_the_last_place():
    one = torch.tensor([1.0])
    nxt = torch.nextafter(one, torch.tensor([2.0]))
    assert check.ulp_gap(one, nxt) == 1
    assert check.ulp_gap(torch.tensor([0.0]), torch.tensor([-0.0])) == 0
    assert check.ulp_gap(torch.tensor([-1e-45]), torch.tensor([1e-45])) == 2
    assert check.ulp_gap(torch.tensor([float("nan")]), one) == check.NAN_GAP
    assert check.ulp_gap(torch.tensor([float("nan")]),
                         torch.tensor([float("nan")])) == 0
