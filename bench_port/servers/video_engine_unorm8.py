"""``VideoEngine(pixels="unorm8")`` as a cell's server: each client is one
stream of its pipeline, its frames handed over as 8-bit frames.

As ``frame_engine_unorm8.py`` does for single frames, ``warm_up`` turns
every pool frame f into its 8-bit twin, min(floor(256 f), 255), and
writes the twin's decode, u / 255 correctly rounded, back into f in
place (that file's ``twins``), so the reference reads exactly what the
engine is to decode each twin to, history frames included. ``submit``
hands over the twin of the pool frame it is given, found by the frame's
identity.
"""
from __future__ import annotations

from bench_port.servers.frame_engine_unorm8 import twins
from bench_port.servers.video_engine import Server as VideoServer


class Server(VideoServer):
    def __init__(self, config: dict, device):
        engine = dict(config["engine"], pixels=config["pixels"])
        super().__init__(dict(config, engine=engine), device)
        self._twin: dict = {}

    def warm_up(self, pool, clients) -> None:
        u8 = twins(pool, self.engine.device)
        self._twin = {id(f): t for f, t in zip(pool, u8)}
        super().warm_up(u8, clients)

    def submit(self, client, k: int, frame) -> bool:
        return super().submit(client, k, self._twin[id(frame)])
