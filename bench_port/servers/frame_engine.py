"""``FrameEngine`` as a cell's server: each client's frames are requests
of its pipeline."""
from __future__ import annotations

from repro_torch.imaging import CompletedFrame, FrameEngine, FrameRequest


class Server:
    def __init__(self, config: dict, device):
        args = dict(config["engine"])
        args["tile_shape"] = tuple(args["tile_shape"])
        self.engine = FrameEngine(device=device, **args)
        self.h, self.w = config["height"], config["width"]
        self.pipelines = list(config["pipelines"])
        self.capacity = self.engine.max_batch
        self._inputs = {}
        for name in self.pipelines:          # loads the kernel libraries
            self._inputs[name] = self.engine.cache.dag_for(name) \
                .input_stages()
        self._n = 1
        self._smem: dict = {}
        self._count_smem()

    def warm_up(self, pool, clients) -> None:
        """Twice, a frame from every client: builds each pipeline's
        executor, runs its first launches and grows the allocator to the
        window's frames in flight."""
        self.open(clients)
        for _ in range(2):
            for c in clients:
                self.submit(c, 0, pool[c.index % len(pool)])
            while self.engine.pending:
                self.engine.step()

    def open(self, clients) -> None:
        self._n = len(clients)
        self._smem = {}

    def submit(self, client, k: int, frame) -> bool:
        return self.engine.submit(FrameRequest(
            rid=k * self._n + client.index, pipeline=client.pipeline,
            frames={n: frame for n in self._inputs[client.pipeline]})) \
            is True

    def step(self) -> list:
        """(client, k, output or None when it failed) per frame served."""
        return [(r.rid % self._n, r.rid // self._n,
                 r.output if isinstance(r, CompletedFrame) else None)
                for r in self.engine.step()]

    @property
    def pending(self) -> int:
        return self.engine.pending

    def served_smem(self) -> dict:
        """Shared memory one CTA reserved, in bytes, by pipeline: the mean
        over the batches served since ``open()``, as the engine's own
        ``observe_batch`` counted them."""
        return {p: sum(v) / len(v) for p, v in self._smem.items()}

    def _count_smem(self) -> None:
        metrics = self.engine.metrics
        observe = metrics.observe_batch

        def observe_batch(pipeline, n_frames, slots, execute_s, smem_bytes,
                          **kw):
            self._smem.setdefault(pipeline, []).append(smem_bytes)
            observe(pipeline, n_frames, slots, execute_s, smem_bytes, **kw)
        metrics.observe_batch = observe_batch
