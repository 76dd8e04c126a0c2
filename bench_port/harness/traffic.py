"""What every traffic mix shares: its clients, its seeded generators and
the frames its clients offer.

A mix is a data file, ``bench_port/traffic/<name>.json``. Its ``loop``
names the module that makes its clients and drives its window,
``bench_port/loops/<loop>.py``, found by name; the rest are that loop's
parameters, and these, which every loop reads:

- ``pool_frames``: distinct frames made from the seed, in pageable host
  memory; client c's k-th frame is pool frame (base_c + k) mod
  pool_frames, base_c drawn from the seed;
- ``check_per_pipeline``: served frames of each pipeline the run checks
  against the reference, drawn from the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Client:
    index: int
    pipeline: str
    frame_base: int
    phase_s: float = 0.0


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for one purpose of one seed; any whole number seeds
    it, negative and wider than 64 bits included."""
    return np.random.default_rng([stream, seed % 2 ** 64, seed // 2 ** 64
                                  % 2 ** 64])


def spread(n: int, mix: dict, pipelines: list[str], seed: int,
           phases=None) -> list[Client]:
    """``n`` clients, in turn over ``pipelines``, each with a pool base
    drawn from the seed."""
    if n < 1:
        raise ValueError(f"a mix needs at least one client, got {n}")
    bases = rng(seed, 1).integers(0, mix["pool_frames"], size=n)
    phases = np.zeros(n) if phases is None else phases
    return [Client(i, pipelines[i % len(pipelines)], int(bases[i]),
                   float(phases[i])) for i in range(n)]


def frame_index(mix: dict, client: Client, k: int) -> int:
    """Pool index of ``client``'s k-th frame."""
    return (client.frame_base + k) % mix["pool_frames"]
