"""Seeded random pipelines for differential testing of the executors.

The generator of the JAX package's executor fuzz harness
(``tests/test_executor_fuzz.py``): convolution chains with occasional
2-input blends, reading from any earlier stage (so multi-consumer
buffers, skip connections and diamond joins all occur), drained by a
terminal sum over every still-open stage. Structural faults in ring
sizing, barrier levels or halos can hide between the hand-written
pipelines; random ones find them.

The blend, drain and temporal-convolution functions are plain closures
that index and add, so they run on torch and jnp windows alike, and the
kernel runs them through its expression body (``core/expr.py``). The
spatial convolutions come from ``conv``: the built-in ``conv_fn``
payload, :func:`bare_conv` (its eager function, lowered), or the JAX
package's ``conv_fn`` with ``pipeline`` its ``Pipeline`` for the oracle's
twin of the same DAG.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .algorithms import conv_fn
from .dsl import Pipeline


def blend_fn(wins):
    """a + 0.5*b over two 1x1 windows (keyed by distinct producers)."""
    a, b = (wins[k][..., 0, 0] for k in sorted(wins))
    return a + 0.5 * b


def drain_fn(wins):
    """Sum of any number of 1x1 windows — the terminal join that gives
    every dangling stage a consumer."""
    acc = None
    for k in sorted(wins):
        v = wins[k][..., 0, 0]
        acc = v if acc is None else acc + v
    return acc


def tconv_fn(taps: np.ndarray) -> Callable:
    """A weighted sum over an (st, sh, sw) spatio-temporal window, the
    taps in (t, dy, dx) order."""
    cells = [(i, float(taps[i])) for i in np.ndindex(*taps.shape)]

    def fn(wins):
        (win,) = wins.values()
        acc = None
        for (t, dy, dx), tap in cells:
            term = tap * win[..., t, dy, dx]
            acc = term if acc is None else acc + term
        return acc
    return fn


def bare_conv(taps: np.ndarray) -> Callable:
    """The ``conv_fn`` payload's eager function: the same pixels through
    the kernel's expression body."""
    return conv_fn(taps).eager


def random_pipeline(seed: int, conv: Callable = conv_fn,
                    pipeline: type = Pipeline, temporal: bool = False,
                    max_stages: int = 5, max_extent: int = 3):
    """The JAX harness's seeded random DAG, edge for edge. ``temporal``:
    a first stage reads 2-4 frames of the input through a random
    spatio-temporal convolution (its own seeded draws), and the chain
    may read it like any other stage."""
    rng = np.random.RandomState(seed)
    p = pipeline(f"fuzz{seed}{'t' if temporal else ''}")
    x = p.input("in")
    refs = [x]
    consumed: set[str] = set()
    if temporal:
        trng = np.random.RandomState(seed + 1000)
        st, sh, sw = (int(trng.randint(2, 5)), int(trng.randint(1, 3)),
                      int(trng.randint(1, 3)))
        taps = (trng.rand(st, sh, sw) / (st * sh * sw)).astype(np.float32)
        refs.append(p.stage("t0", [(x, st, sh, sw)], tconv_fn(taps)))
    n = int(rng.randint(2, max_stages + 1))
    for i in range(n):
        src = refs[int(rng.randint(len(refs)))]
        sh = int(rng.randint(1, max_extent + 1))
        sw = int(rng.randint(1, max_extent + 1))
        reads = [(src, sh, sw)]
        others = [r for r in refs if r.name != src.name]
        if others and rng.rand() < 0.4:
            other = others[int(rng.randint(len(others)))]
            reads = [(src, 1, 1), (other, 1, 1)]
            fn = blend_fn
            consumed.add(other.name)
        else:
            taps = (rng.rand(sh, sw) / (sh * sw)).astype(np.float32)
            fn = conv(taps)
        consumed.add(src.name)
        refs.append(p.stage(f"k{i}", reads, fn))
    last = refs[-1]
    open_refs = [r for r in refs[:-1] if r.name not in consumed]
    final = p.stage("drain", [(last, 1, 1)]
                    + [(r, 1, 1) for r in open_refs], drain_fn)
    p.output("out", [(final, 1, 1)])
    return p.build()
