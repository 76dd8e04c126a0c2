"""Pipeline DAG intermediate representation (paper Sec. 4).

A pipeline is a DAG of stencil stages. Each node is a stage; each edge
connects a producer to a consumer and carries the stencil window shape
(SH, SW) the consumer reads from that producer. Stencil sizes are encoded
on edges (not nodes) because a consumer may read different windows from
different producers (paper footnote 1).

The compute payload of a stage is a vectorized window function used by both
the pure-jnp reference executor and the Pallas fused kernel; the scheduler
itself only ever looks at the graph structure and stencil heights.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Edge:
    """Producer -> consumer edge with stencil window (ST, SH, SW).

    ``(sh, sw)`` is the spatial window within one frame; ``st`` is the
    temporal extent — how many frames of the producer the consumer reads,
    causally aligned like the spatial axes: output frame t reads producer
    frames ``t-st+1 .. t``. ``st=1`` (the default) is a purely spatial
    edge, which is why it trails the spatial fields despite the DSL
    writing reads as ``(ref, st, sh, sw)``.
    """
    producer: str
    consumer: str
    sh: int  # stencil height
    sw: int  # stencil width
    st: int = 1  # temporal extent (frames, incl. the current one)

    def __post_init__(self):
        if self.sh < 1 or self.sw < 1:
            raise ValueError(f"stencil must be >=1x1, got {self.sh}x{self.sw}")
        if self.st < 1:
            raise ValueError(f"temporal extent must be >=1, got {self.st}")


def window_keys(edges: Sequence[Edge]) -> list[str]:
    """Key per in-edge for the stage-fn ``wins`` dict, in edge order.

    A stage's window dict is keyed by producer name; a stage reading two
    windows from the *same* producer (e.g. xcorr's 18x1 + 1x1 taps) gets
    the repeat keyed ``producer#STxSHxSW``. Both executors (the pure-jnp
    reference and the Pallas kernel) must agree on this keying, so it
    lives here, next to the Edge definition.
    """
    keys, seen = [], set()
    for e in edges:
        if e.producer not in seen:
            keys.append(e.producer)
        else:
            keys.append(f"{e.producer}#{e.st}x{e.sh}x{e.sw}")
        seen.add(e.producer)
    return keys


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage.

    ``fn`` maps a dict {producer_name: window array [..., SH, SW]} to the
    output pixel value(s) with matching leading batch dims. ``fn=None`` is a
    pure relay (identity on a 1x1 window) used by Darkroom linearization.
    """
    name: str
    fn: Callable[[Mapping[str, "jax.Array"]], "jax.Array"] | None = None
    is_input: bool = False
    is_output: bool = False


class PipelineDAG:
    """Immutable-ish DAG with helper queries used throughout the compiler."""

    def __init__(self, name: str, stages: Sequence[Stage], edges: Sequence[Edge]):
        self.name = name
        self.stages: dict[str, Stage] = {}
        for s in stages:
            if s.name in self.stages:
                raise ValueError(f"duplicate stage {s.name}")
            self.stages[s.name] = s
        self.edges: list[Edge] = list(edges)
        for e in self.edges:
            if e.producer not in self.stages or e.consumer not in self.stages:
                raise ValueError(f"edge {e} references unknown stage")
        self._toposort()
        self._reach = self._reachability()

    # ------------------------------------------------------------------ graph
    def _toposort(self) -> None:
        indeg = {n: 0 for n in self.stages}
        for e in self.edges:
            indeg[e.consumer] += 1
        ready = [n for n, d in indeg.items() if d == 0]
        order: list[str] = []
        consumers = self.consumers_of
        while ready:
            n = ready.pop()
            order.append(n)
            for e in self.out_edges(n):
                indeg[e.consumer] -= 1
                if indeg[e.consumer] == 0:
                    ready.append(e.consumer)
        if len(order) != len(self.stages):
            raise ValueError(f"pipeline {self.name} has a cycle")
        self.topo_order = order

    def _reachability(self) -> dict[str, frozenset[str]]:
        """reach[n] = set of nodes reachable from n (excluding n)."""
        reach: dict[str, set[str]] = {n: set() for n in self.stages}
        for n in reversed(self.topo_order):
            for e in self.out_edges(n):
                reach[n].add(e.consumer)
                reach[n] |= reach[e.consumer]
        return {k: frozenset(v) for k, v in reach.items()}

    # ----------------------------------------------------------------- queries
    def out_edges(self, name: str) -> list[Edge]:
        return [e for e in self.edges if e.producer == name]

    def in_edges(self, name: str) -> list[Edge]:
        return [e for e in self.edges if e.consumer == name]

    def consumers_of(self, name: str) -> list[str]:
        return [e.consumer for e in self.out_edges(name)]

    def producers_of(self, name: str) -> list[str]:
        return [e.producer for e in self.in_edges(name)]

    def input_stages(self) -> list[str]:
        return [n for n, s in self.stages.items() if s.is_input]

    def output_stages(self) -> list[str]:
        return [n for n, s in self.stages.items() if s.is_output]

    def depends(self, a: str, b: str) -> bool:
        """Partial order: a <= b (b is a or downstream of a)."""
        return a == b or b in self._reach[a]

    def multi_consumer_stages(self) -> list[str]:
        """Stages with >1 *distinct access pattern* consumer edges.

        Per the paper (Fig. 3), consumers reading in exactly the same pattern
        act as one. Two out-edges with identical (sh, sw) still contend at
        the port level only once for scheduling purposes if their consumers
        share a start cycle; for counting MC stages we follow Tbl. 3 and use
        distinct consumer stages.
        """
        return [n for n in self.stages if len(self.out_edges(n)) > 1]

    def num_stages(self) -> int:
        return len(self.stages)

    def cumulative_extent(self, temporal: bool = False
                          ) -> tuple[int, int] | tuple[int, int, int]:
        """(up, left) — or (back, up, left) — dependency halo of the output.

        Windows are causal (bottom-right aligned): stage output pixel
        (r, x) of frame t reads producer frames t-st+1..t, rows
        r-sh+1..r, cols x-sw+1..x. Chaining edges therefore accumulates
        (st-1, sh-1, sw-1) per hop; joins take the max over in-edges. The
        spatial legs are the halo a tile executor must prepend (above/
        left) so every output pixel of the tile sees its full input
        dependency cone; the temporal leg ``back`` is how many *past*
        input frames the current output frame depends on — the warm-up
        depth of a streaming video session. ``temporal=False`` (the
        default) keeps the historical 2-tuple for spatial callers.
        """
        ext: dict[str, tuple[int, int, int]] = {}
        for name in self.topo_order:
            ins = self.in_edges(name)
            if not ins:
                ext[name] = (0, 0, 0)
                continue
            ext[name] = (
                max(ext[e.producer][0] + e.st - 1 for e in ins),
                max(ext[e.producer][1] + e.sh - 1 for e in ins),
                max(ext[e.producer][2] + e.sw - 1 for e in ins))
        back, up, left = ext[self.output_stages()[0]]
        return (back, up, left) if temporal else (up, left)

    def temporal_depths(self) -> dict[str, int]:
        """Producer -> max temporal extent over its out-edges (entries > 1
        only). A producer with depth d must keep its last d-1 frames in a
        frame ring; spatial-only pipelines return {}."""
        depths: dict[str, int] = {}
        for e in self.edges:
            if e.st > 1:
                depths[e.producer] = max(depths.get(e.producer, 1), e.st)
        return depths

    def is_temporal(self) -> bool:
        return any(e.st > 1 for e in self.edges)

    def validate(self) -> None:
        for n, s in self.stages.items():
            ins, outs = self.in_edges(n), self.out_edges(n)
            if s.is_input and ins:
                raise ValueError(f"input stage {n} has in-edges")
            if not s.is_input and not ins:
                raise ValueError(f"non-input stage {n} has no producers")
            if s.is_output and outs:
                raise ValueError(f"output stage {n} has out-edges")
            if not s.is_output and not outs:
                raise ValueError(f"non-output stage {n} has no consumers")
            for e in ins:
                # outputs stream the current frame 1x1; relays (fn=None)
                # are spatial 1x1 identities — neither can hold history
                if e.st > 1 and (s.is_output or s.fn is None):
                    kind = "output" if s.is_output else "relay"
                    raise ValueError(
                        f"{kind} stage {n} cannot read a temporal window "
                        f"(st={e.st}) from {e.producer}")

    def __repr__(self) -> str:
        return (f"PipelineDAG({self.name}, stages={len(self.stages)}, "
                f"edges={len(self.edges)}, mc={len(self.multi_consumer_stages())})")
