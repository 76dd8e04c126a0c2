"""Pipeline parallelism planned by the ImaGen formulation.

The port of ``src/repro/distributed/pipeline.py``. Mapping: PP stage ->
DAG node, microbatch index -> cycle t (W = 1), the activation stash ->
line buffer, per-step send/recv slot -> memory port. The forward chain
f0 -> f1 -> ... -> f{N-1} -> b{N-1} -> ... -> b0 with the stash edge
f_i -> b_i is exactly a multi-consumer pipeline; the ILP's optimal buffer
sizes reproduce the classic 1F1B activation-stash bound
LB(f_i) = 2*(N - i) - 1.

``pipeline_forward`` runs the reference's GPipe tick schedule. The
reference runs one stage per chip (``shard_map``) and moves activations
with ``ppermute``; on one card the stages run in turn within each tick,
and the ``ppermute`` becomes a shift of the stage buffers. A plain
tensor loop: no process group.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import Pipeline as CorePipeline
from repro_torch.core.algorithms import identity_fn
from repro_torch.core.ilp import build_problem, solve_schedule


def plan_1f1b(n_stages: int):
    """Schedule fwd/bwd stage offsets + stash sizes via the paper's ILP.

    Returns (starts, stash) where stash[i] = microbatches of activations
    stage i must hold between its forward and backward passes.
    """
    p = CorePipeline(f"pp-{n_stages}")
    prev = p.input("f0")
    fwd = [prev]
    for i in range(1, n_stages):
        prev = p.stage(f"f{i}", [(prev, 1, 1)], identity_fn)
        fwd.append(prev)
    # backward chain; b_i consumes f_i's stashed activation
    prev_b = p.stage(f"b{n_stages-1}", [(fwd[-1], 1, 1)], identity_fn)
    for i in range(n_stages - 2, -1, -1):
        prev_b = p.stage(f"b{i}", [(prev_b, 1, 1), (fwd[i], 1, 1)],
                         identity_fn)
    p.output("out", [(prev_b, 1, 1)])
    dag = p.build()
    # W=1: one "pixel" per microbatch; 2 ports = send+recv per step
    prob = build_problem(dag, w=1, ports=2)
    sched = solve_schedule(prob)
    starts = dict(sched.starts)
    # stash depth = how many microbatches sit between f_i and b_i (the
    # raw start delta: PP stashes are discrete buffers with
    # read-then-free semantics, no ring-aliasing slot)
    stash = {i: starts[f"b{i}"] - starts[f"f{i}"] for i in range(n_stages)}
    return starts, stash


def _stage_params(params: Any, s: int) -> Any:
    """Stage ``s``'s parameters: item ``s`` of a sequence (the port's
    super-blocks are modules of their own), or row ``s`` of a tensor or
    of every tensor of a dict (the reference's stacked leaves)."""
    if isinstance(params, dict):
        return {k: _stage_params(v, s) for k, v in params.items()}
    return params[s]


def pipeline_forward(params_stacked, x_micro: torch.Tensor,
                     apply_fn: Callable, mesh, stage_axis: str = "stage"
                     ) -> torch.Tensor:
    """GPipe-style forward over the ``stage`` axis of ``mesh``.

    params_stacked: per-stage parameters, ``n_stages`` of them (a
    sequence, or tensors with a leading ``n_stages`` dim). x_micro:
    (n_micro, mb, ...) microbatches. apply_fn(params_i, x) -> y of x's
    shape. Returns the last stage's (n_micro, mb, ...) outputs.

    Tick t: stage 0 takes microbatch t (while t < n_micro), every other
    stage the activation stage s - 1 produced at tick t - 1; stage s is
    active when it holds microbatch t - s, and the last stage records it.
    """
    n_stages = mesh.shape[stage_axis]
    n_micro = x_micro.shape[0]
    if not isinstance(params_stacked, dict) and \
            len(params_stacked) != n_stages:
        raise ValueError(f"{len(params_stacked)} stages of parameters for "
                         f"a '{stage_axis}' axis of {n_stages}")
    steps = n_micro + n_stages - 1
    bufs = [torch.zeros_like(x_micro[0]) for _ in range(n_stages)]
    outs = torch.zeros_like(x_micro)
    for t in range(steps):
        ys = []
        for s in range(n_stages):
            cur = x_micro[t] if (s == 0 and t < n_micro) else bufs[s]
            if t >= s and t - s < n_micro:           # active
                y = apply_fn(_stage_params(params_stacked, s), cur)
                if s == n_stages - 1:
                    outs[t - s] = y
            else:
                y = cur
            ys.append(y)
        # ppermute (i -> i + 1 mod n): stage s receives stage s - 1's
        bufs = [ys[(s - 1) % n_stages] for s in range(n_stages)]
    return outs
