"""``correct`` against its control and the faults each cell can have,
run through the whole harness at a small size on the CPU (the look for a
card skipped): the program passes, the bfloat16 reference in the
kernel's place fails, and so does each fault planted under the timed
path."""
import time

import pytest
import torch

from bench_port import control
from bench_port.harness import cell

CASES = [(wl, side) for wl, server in (("spatial7-1080p.host",
                                        "frame_engine"),
                                       ("video4-1080p.cams30",
                                        "video_engine"))
         for side in ("program", "control", *control.FAULTS[server])]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload, side", CASES)
def test_correct_holds_for_the_program_and_fails_otherwise(workload, side):
    bench, spec, config, mix = cell.load(workload)
    config = dict(config, height=20, width=36)
    mix = dict(mix, pool_frames=10)
    r = control.run_side(side, bench, spec, config, mix, 11, 0.3,
                         torch.device("cpu"))
    assert r["attempted"] > 0
    assert r["correct"] is (side == "program"), r
    if side != "program":
        assert r["checks"]["max_ulp"] > 2 ** 16


def test_the_faults_leave_the_program_as_it_was():
    import repro_torch.kernels.stencil_pipeline as sp
    kernel, call = sp.stencil_pipeline, sp.VideoExecutor.__call__
    for side in control.SIDES:
        with control.SIDES[side]():
            pass
    assert sp.stencil_pipeline is kernel
    assert sp.VideoExecutor.__call__ is call


def test_a_run_reports_its_compared_numbers_last():
    bench, spec, config, mix = cell.load("spatial7-1080p.host")
    r, lines = cell.run(bench, spec, dict(config, height=16, width=24),
                        dict(mix, pool_frames=8), 4, 0.2, False,
                        torch.device("cpu"), time.perf_counter())
    assert list(r)[-1] == "checks"
    assert [name for name, _ in lines] == ["energy_start", "energy_end"]
    assert set(r["checks"]) == {"max_ulp", "undelivered",
                                "unchecked_pipelines"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
