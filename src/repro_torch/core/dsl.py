"""Darkroom-like DSL front end (paper Sec. 4, "Front End").

The paper deliberately reuses existing DSL ideas; ours is a tiny embedded
builder that parses to the :class:`PipelineDAG` IR. Example::

    p = Pipeline("unsharp")
    x   = p.input("in")
    bx  = p.stage("blurx", reads=[(x, 1, 5)], fn=conv_fn(gauss1d_h))
    by  = p.stage("blury", reads=[(bx, 5, 1)], fn=conv_fn(gauss1d_v))
    out = p.stage("sharp", reads=[(x, 1, 1), (by, 1, 1)], fn=unsharp_fn)
    p.output("out", reads=[(out, 1, 1)])
    dag = p.build()

A read is ``(ref, sh, sw)`` for a spatial window or ``(ref, st, sh, sw)``
for a spatio-temporal one — ``st`` frames of history, causally aligned
like the spatial axes (frame t reads producer frames t-st+1..t)::

    d = p.stage("diff", reads=[(x, 2, 1, 1)], fn=frame_diff_fn)

Stage ``fn`` signatures are vectorized window functions; see dag.Stage —
windows arrive as [..., sh, sw] for st == 1 and [..., st, sh, sw] for
st > 1.
"""
from __future__ import annotations

from typing import Callable, Sequence

from .dag import Edge, PipelineDAG, Stage

Read = tuple  # (Ref, sh, sw) or (Ref, st, sh, sw)


class Ref:
    """Handle to a declared stage, usable as a read target."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Ref({self.name})"


class Pipeline:
    def __init__(self, name: str):
        self.name = name
        self._stages: list[Stage] = []
        self._edges: list[Edge] = []

    def _declared(self) -> set[str]:
        return {s.name for s in self._stages}

    def _add_reads(self, consumer: str, reads: Sequence[Read]) -> None:
        declared = self._declared()
        for r in reads:
            ref, *dims = r
            if not isinstance(ref, Ref):
                raise TypeError(f"read target must be a Ref, got {ref!r}")
            if ref.name not in declared:
                raise ValueError(f"stage {consumer!r} reads unknown ref "
                                 f"{ref.name!r}; declare it first")
            if len(dims) == 2:
                st, (sh, sw) = 1, dims
            elif len(dims) == 3:
                st, sh, sw = dims
            else:
                raise ValueError(
                    f"read must be (ref, sh, sw) or (ref, st, sh, sw), "
                    f"got {r!r}")
            self._edges.append(Edge(producer=ref.name, consumer=consumer,
                                    sh=sh, sw=sw, st=st))

    def input(self, name: str) -> Ref:
        self._stages.append(Stage(name=name, fn=None, is_input=True))
        return Ref(name)

    def stage(self, name: str, reads: Sequence[Read],
              fn: Callable | None) -> Ref:
        self._stages.append(Stage(name=name, fn=fn))
        self._add_reads(name, reads)
        return Ref(name)

    def output(self, name: str, reads: Sequence[Read]) -> Ref:
        self._stages.append(Stage(name=name, fn=None, is_output=True))
        self._add_reads(name, reads)
        return Ref(name)

    def build(self) -> PipelineDAG:
        dag = PipelineDAG(self.name, self._stages, self._edges)
        dag.validate()
        return dag
