"""``VideoEngine`` as a cell's server: each client is one stream of its
pipeline, opened when the window opens."""
from __future__ import annotations

from repro_torch.video import CompletedVideoFrame, VideoEngine, VideoFrame


class Server:
    def __init__(self, config: dict, device):
        self.engine = VideoEngine(device=device, **config["engine"])
        self.h, self.w = config["height"], config["width"]
        self.pipelines = list(config["pipelines"])
        self.capacity = self.engine.chunk
        self._inputs = {}
        for name in self.pipelines:          # loads the kernel libraries
            self._inputs[name] = self.engine.cache.dag_for(name) \
                .input_stages()
        self._n = 1
        self._smem: dict = {}
        self._count_smem()
        self._sid: dict = {}

    def warm_up(self, pool, clients) -> None:
        """On a stream per client, closed afterwards: a chunk each (the
        chunk executors), then single frames each (the one-frame
        executors), so every executor is built and has launched and the
        allocator holds as many frame rings as the window will."""
        sids = [(self.engine.open_stream(c.pipeline, self.h, self.w), c)
                for c in clients]
        for frames in (pool[:self.capacity], pool[:1], pool[1:2]):
            for sid, c in sids:
                for f in frames:
                    self.engine.submit(VideoFrame(
                        sid, {n: f for n in self._inputs[c.pipeline]}))
            while self.engine.pending:
                self.engine.step()
        for sid, _ in sids:
            self.engine.close_stream(sid)

    def open(self, clients) -> None:
        self._n = len(clients)
        self._smem = {}
        self._sid = {c.index: self.engine.open_stream(c.pipeline, self.h,
                                                      self.w)
                     for c in clients}

    def submit(self, client, k: int, frame) -> bool:
        return self.engine.submit(VideoFrame(
            self._sid[client.index],
            {n: frame for n in self._inputs[client.pipeline]},
            rid=k * self._n + client.index)) is True

    def step(self) -> list:
        """(client, k, output or None when it failed) per frame served."""
        return [(r.rid % self._n, r.rid // self._n,
                 r.output if isinstance(r, CompletedVideoFrame) else None)
                for r in self.engine.step() if r.rid is not None]

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
