"""Whether what the timed path served is right: a sample of the frames
delivered in the window, drawn from the seed, against the plain
reference, on the same input frames.

Numbers compared, each with its limit:

- ``max_ulp``: the widest gap, in float32 units in the last place,
  between a checked output pixel and the reference's (a NaN on one side
  only counts 2**32); its limit is the configuration's ``check.max_ulp``;
- ``undelivered``: frames due in the window that the server accepted and
  then failed or never delivered (limit 0; a refused frame is the
  backpressure strict serving promises, and counts in ``failed`` and in
  the latency tail instead);
- ``unchecked_pipelines``: pipelines of the mix with fewer checked frames
  than the mix asks for (limit 0).
"""
from __future__ import annotations

import bisect

import torch

from bench_port.reference import pipelines as reference

from . import frames, traffic

NAN_GAP = 2 ** 32


def ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as integers in the floats' order (+0 and -0 equal)."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 ulps between ``a`` and ``b``."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    gap = (ordered(a) - ordered(b)).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    gap = torch.where(na | nb, torch.where(na & nb, 0, NAN_GAP), gap)
    return int(gap.max()) if gap.numel() else 0


class Sampler:
    """Keeps, for each pipeline, ``per_pipeline`` delivered frames drawn
    uniformly from the seed (a reservoir over delivery order). A kept
    output is copied, so the batch it is a view of can be freed."""

    def __init__(self, per_pipeline: int, seed: int):
        self.k = per_pipeline
        self.rng = traffic.rng(seed, 3)
        self.seen: dict = {}
        self.kept: dict = {}

    def __call__(self, client, k: int, out) -> None:
        p = client.pipeline
        n = self.seen[p] = self.seen.get(p, 0) + 1
        kept = self.kept.setdefault(p, [])
        if len(kept) < self.k:
            kept.append((client, k, out.clone()))
            return
        j = int(self.rng.integers(0, n))
        if j < self.k:
            kept[j] = (client, k, out.clone())


def inputs_of(mix, pool, client, k: int, accepted: list[int],
              device) -> torch.Tensor:
    """The stream's frames up to its k-th, as many as the pipeline's
    output reads, oldest first: frames the server accepted, in order."""
    depth = reference.history_depth(client.pipeline)
    i = bisect.bisect_left(accepted, k)
    ks = accepted[max(0, i - depth + 1):i + 1]
    return torch.stack([frames.as_tensor(
        pool[traffic.frame_index(mix, client, kk)], device) for kk in ks])


def compare(sampler: Sampler, mix, pool, window, pipelines, limit: int,
            device) -> dict:
    """The compared numbers, each ``{"value": ..., "limit": ...}``."""
    worst = 0
    for kept in sampler.kept.values():
        for client, k, out in kept:
            x = inputs_of(mix, pool, client, k, window.accepted[client.index],
                          device)
            want = reference.run(client.pipeline, x)
            worst = max(worst, ulp_gap(out.to(device), want))
    short = sum(len(sampler.kept.get(p, [])) < sampler.k for p in pipelines)
    return {"max_ulp": {"value": worst, "limit": limit},
            "undelivered": {"value": len(window.missing), "limit": 0},
            "unchecked_pipelines": {"value": short, "limit": 0}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
