"""``FrameEngine(pixels="unorm8")`` as a cell's server: each client's
frames are requests of its pipeline, handed over as 8-bit frames.

The harness makes a float32 pool, uniform over [0, 1), and judges each
served frame against the plain reference on the pool frame it names.
Before any frame is submitted, ``warm_up`` turns every pool frame f into
its 8-bit twin, the byte u = min(floor(256 f), 255), uniform over
0..255, and writes the twin's decode, u / 255 correctly rounded
(:data:`TABLE`), back into f in place, so the reference reads exactly
what the engine is to decode the twin to. ``submit`` hands over the
twin of the pool frame it is given, found by the frame's identity.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port.servers.frame_engine import Server as FrameServer

# the decode the configuration states, v / 255 for the byte v, written
# out here so the check owes nothing to the program
TABLE = np.arange(256, dtype=np.float32) / np.float32(255)
CHUNK = 8


def twins(pool: list, device: torch.device) -> list[np.ndarray]:
    """The 8-bit twin of each pool frame, made on ``device`` a few frames
    at a time; each pool frame is overwritten with its twin's decode."""
    out = np.empty((len(pool), *pool[0].shape), dtype=np.uint8)
    table = torch.from_numpy(TABLE).to(device)
    for i in range(0, len(pool), CHUNK):
        fs = pool[i:i + CHUNK]
        x = torch.stack([torch.from_numpy(f).to(device) for f in fs])
        # 256 f is exact in float32, so the floor is the byte's
        u = torch.clamp(torch.floor(x * 256), max=255).to(torch.uint8)
        decoded = table[u.long()]
        torch.from_numpy(out[i:i + len(fs)]).copy_(u)
        for f, d in zip(fs, decoded):
            torch.from_numpy(f).copy_(d)
    return [out[i] for i in range(len(pool))]


class Server(FrameServer):
    def __init__(self, config: dict, device):
        engine = dict(config["engine"], pixels=config["pixels"])
        super().__init__(dict(config, engine=engine), device)
        self._twin: dict = {}

    def warm_up(self, pool, clients) -> None:
        self._twin = {id(f): t for f, t in
                      zip(pool, twins(pool, self.engine.device))}
        super().warm_up(pool, clients)

    def submit(self, client, k: int, frame) -> bool:
        return super().submit(client, k, self._twin[id(frame)])
