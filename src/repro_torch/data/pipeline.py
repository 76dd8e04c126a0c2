"""Deterministic synthetic data pipeline.

A copy of ``src/repro/data/pipeline.py`` (pure numpy): the same seeds,
ranks and steps give the same batches. The train step moves each batch
to its device.

Seeded, shardable, and checkpointable: the iterator state is (seed, step),
so fault-tolerant resume replays exactly the batch it crashed on. Each
data-parallel rank draws its own slice via (seed, step, rank) hashing —
no cross-host coordination needed, which is what you want at 1000+ nodes.

Token streams follow a Zipf-ish marginal with short-range structure (a
noisy copy task) so a ~100M model visibly learns within a few hundred
steps (the JAX package's examples/train_lm.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int


class TokenStream:
    """Synthetic LM batches: {tokens, labels} of (batch, seq) int32."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 n_ranks: int = 1, rank: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.n_ranks = n_ranks
        self.rank = rank
        self.state = DataState(seed=seed, step=0)
        assert batch % n_ranks == 0
        self.local_batch = batch // n_ranks

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=self.state.seed, counter=[0, 0, step, self.rank]))

    def next(self) -> dict[str, np.ndarray]:
        rng = self._rng(self.state.step)
        b, s, v = self.local_batch, self.seq + 1, self.vocab
        # zipf-ish unigrams
        ranks = rng.integers(1, v, size=(b, s), dtype=np.int64)
        toks = (v / np.sqrt(ranks)).astype(np.int64) % v
        # structure: periodic copy with noise (learnable signal)
        period = 8
        toks[:, period:] = np.where(rng.random((b, s - period)) < 0.7,
                                    toks[:, :-period], toks[:, period:])
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        self.state.step += 1
        return {"tokens": tokens, "labels": labels}

    # ----------------------------------------------------- checkpointing
    def snapshot(self) -> dict:
        return {"seed": self.state.seed, "step": self.state.step}

    def restore(self, snap: dict) -> None:
        self.state = DataState(seed=int(snap["seed"]), step=int(snap["step"]))


class ImageStream:
    """Synthetic image frames for the stencil pipelines (benchmarks)."""

    def __init__(self, w: int, h: int, seed: int = 0):
        self.w, self.h = w, h
        self.state = DataState(seed=seed, step=0)

    def next(self) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(
            key=self.state.seed, counter=[0, 0, self.state.step, 0]))
        self.state.step += 1
        base = rng.random((self.h, self.w), dtype=np.float32)
        # smooth a little so stencils see structure
        base = 0.25 * (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                       + np.roll(base, (1, 1), (0, 1)))
        return base
