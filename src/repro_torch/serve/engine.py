"""Batched serving engine: slot-based continuous batching (lite).

The port of ``src/repro/serve/engine.py``. A fixed pool of B slots;
requests occupy slots, prefill runs the prompt through decode steps one
token at a time, generation steps all slots together. Ring KV caches come
from the kv_planner (ImaGen-sized); finished slots free immediately
(continuous batching).

Prefill advances only the admitted slot: it runs as a batch of one on
views of that slot's cache rows, which it first zeroes. The reference
instead steps every slot with token 0 at its current position while it
prefills one, which moves the recurrent state (RG-LRU, RWKV) of every
other active slot, and it keeps a reused slot's state from its previous
request.

A request's prefill gives its first token. When that token already meets
``max_new`` the request completes at admission, without a decode step:
the next ``step()`` (or ``run()``) returns its ``Completed``, and the
slot is free again. The reference appends another token in the step
after the prefill before it checks ``max_new``, so ``max_new=1`` returns
two tokens there.

The reference jits its step and its prefill. On the card each of the
engine's step shapes (all slots; one slot's rows, per slot) is captured
once as a CUDA graph over the engine's own cache tensors, which the
decode step updates in place, and replayed: the same kernels as the eager
step, launched as one graph instead of ~70 operations a layer. On the CPU
the steps run eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Model, slot_view

from .kv_planner import KVPlan, plan_kv

# The reference samples at logits / 0.8 whatever a request's temperature,
# once it is above 0 (``src/repro/serve/engine.py:120``); kept as it is.
SAMPLE_TEMPERATURE = 0.8


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int token ids
    max_new: int = 16
    temperature: float = 0.0     # 0 = greedy, > 0 samples


@dataclasses.dataclass
class Completed:
    rid: int
    tokens: list[int]


def zero_caches(caches) -> None:
    for seg in caches:
        for sub in seg:
            for t in sub.values():
                t.zero_()


class DecodeStep:
    """``model.decode_step`` on fixed cache tensors (the engine's, or one
    slot's views of them) for a fixed batch: ``step(tokens, pos)`` ->
    logits. On a CUDA device the step is captured once as a CUDA graph and
    replayed; the returned logits are then the graph's own output buffer,
    valid until the next replay. The capture's first run writes into the
    caches, so building one zeroes them."""

    def __init__(self, model: Model, caches, batch: int):
        self.model, self.caches = model, caches
        self.graph = None
        dev = model.device
        if dev.type != "cuda":
            return
        self.tokens = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=dev)
        side = torch.cuda.Stream(dev)      # first run outside the capture
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            model.decode_step(caches, self.tokens, self.pos)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = model.decode_step(caches, self.tokens, self.pos)
        zero_caches(caches)

    def __call__(self, tokens: torch.Tensor, pos: torch.Tensor):
        """tokens, pos: (batch,) on the model's device or the host."""
        if self.graph is None:
            dev = self.model.device
            return self.model.decode_step(self.caches, tokens.to(dev),
                                          pos.to(dev))[0]
        self.tokens.copy_(tokens)
        self.pos.copy_(pos)
        self.graph.replay()
        return self.logits


class Engine:
    """Serves ``model`` (on its device) from ``n_slots`` cache rows of
    ``max_len`` positions; ``seed`` seeds the sampling generator."""

    def __init__(self, model: Model, n_slots: int, max_len: int,
                 seed: int = 0):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_plan: KVPlan = plan_kv(self.cfg, max_len)
        self.caches = model.decode_init(n_slots, max_len)
        self.pos = np.zeros((n_slots,), np.int64)
        self.active = np.zeros((n_slots,), bool)
        self.req: list[Request | None] = [None] * n_slots
        self.out_tokens: list[list[int]] = [[] for _ in range(n_slots)]
        self.last_token = np.zeros((n_slots,), np.int64)
        self._admitted_done: list[Completed] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        with torch.no_grad():
            self._step = DecodeStep(model, self.caches, n_slots)
            self._slot_steps = [DecodeStep(model, slot_view(self.caches, s),
                                           1) for s in range(n_slots)]

    # ------------------------------------------------------------ requests
    @torch.no_grad()
    def _prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Run ``prompt`` through decode steps on ``slot``'s rows only;
        returns the greedy next token."""
        step = self._slot_steps[slot]
        zero_caches(step.caches)            # nothing of a previous request
        toks = torch.as_tensor(prompt, dtype=torch.long, device=self.device)
        pos = torch.arange(len(prompt), device=self.device)
        for t in range(len(prompt)):
            logits = step(toks[t:t + 1], pos[t:t + 1])
        return int(torch.argmax(logits[0]))

    def add_request(self, req: Request) -> bool:
        n = len(req.prompt)
        if not 1 <= n < self.max_len:
            raise ValueError(f"request {req.rid}: prompt of {n} tokens; "
                             f"the engine takes 1 to {self.max_len - 1}")
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            return False
        slot = int(free[0])
        first = self._prefill(slot, np.asarray(req.prompt))
        if req.max_new <= 1:        # done at admission: the slot stays free
            self._admitted_done.append(Completed(
                rid=req.rid, tokens=[first][:max(req.max_new, 0)]))
            return True
        self.pos[slot] = n
        self.active[slot] = True
        self.req[slot] = req
        self.out_tokens[slot] = [first]
        self.last_token[slot] = first
        return True

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> list[Completed]:
        """One decode step of every active slot; returns the requests it
        completed, after those completed at admission since the last
        step."""
        done, self._admitted_done = self._admitted_done, []
        if not self.active.any():
            return done
        logits = self._step(torch.from_numpy(self.last_token),
                            torch.from_numpy(self.pos))
        greedy = torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / SAMPLE_TEMPERATURE, dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        greedy, sampled = greedy.cpu().numpy(), sampled.cpu().numpy()
        for s in range(self.n_slots):
            if not self.active[s]:
                continue
            r = self.req[s]
            tok = int(sampled[s] if r.temperature > 0 else greedy[s])
            self.out_tokens[s].append(tok)
            self.last_token[s] = tok
            self.pos[s] += 1
            if len(self.out_tokens[s]) >= r.max_new or \
                    self.pos[s] >= self.max_len - 1:
                done.append(Completed(rid=r.rid, tokens=self.out_tokens[s]))
                self.active[s] = False
                self.req[s] = None
        return done

    def run(self, requests: list[Request]) -> dict[int, list[int]]:
        """Submit everything, drain to completion (test/benchmark entry)."""
        pending = list(requests)
        results: dict[int, list[int]] = {}
        while pending or self.active.any() or self._admitted_done:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            for c in self.step():
                results[c.rid] = c.tokens
        return results
