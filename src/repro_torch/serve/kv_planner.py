"""KV-cache planning via the ImaGen formulation.

A sliding-window decode cache IS a line buffer: the decode step produces
one token per step (the producer, SH=1) and windowed attention consumes a
window-wide stencil (SH=1, SW=window) from it. Instantiating the paper's
machinery on that 2-stage DAG with image width W = window yields

    LB = ceil(max_delay / W) * W = window   (one "line" = the ring)

which is exactly the ring KV cache the serving engine allocates. The
sizes come out of the port's own compiler (``repro_torch.core``: the ILP
schedule and line-buffer allocation), and give the engine per-layer byte
budgets for admission control.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import DP, Pipeline, compile_pipeline
from repro_torch.core.algorithms import identity_fn
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import plan_segments


@dataclasses.dataclass
class KVPlan:
    per_layer: list[dict]        # kind, ring_tokens, bytes per batch elem
    bytes_per_seq: int           # total cache bytes for one sequence
    max_len: int

    def batch_budget(self, hbm_bytes: int, reserve_frac: float = 0.3) -> int:
        """Max concurrent sequences within an HBM budget (admission)."""
        usable = int(hbm_bytes * (1 - reserve_frac))
        return max(1, usable // max(self.bytes_per_seq, 1))


def _ring_tokens(window: int, max_len: int) -> int:
    """Size the ring through the paper's compiler on the 2-stage DAG."""
    w = min(window, max_len)
    p = Pipeline("kv-ring")
    producer = p.input("decode")
    attn = p.stage("attn", [(producer, 1, w)], identity_fn)
    p.output("out", [(attn, 1, 1)])
    plan = compile_pipeline(p.build(), w, mem=DP)
    lines = plan.alloc.buffers["decode"].n_lines_phys
    return lines * w  # LB in "pixels" == tokens


def plan_kv(cfg: ModelConfig, max_len: int, dtype_bytes: int = 2) -> KVPlan:
    per_layer = []
    total = 0
    kv_width = cfg.n_kv_heads * cfg.hd
    for seg in plan_segments(cfg):
        for _ in range(seg.n):
            for kind in seg.kinds:
                if kind == "G":
                    ring = max_len
                elif kind == "L":
                    ring = _ring_tokens(cfg.window, max_len)
                elif kind == "R":
                    lru = cfg.lru_width or cfg.d_model
                    b = (lru * 4) + (cfg.conv1d_width - 1) * lru * dtype_bytes
                    per_layer.append({"kind": "R", "ring_tokens": 1,
                                      "bytes": b})
                    total += b
                    continue
                elif kind == "W":
                    hd = cfg.d_model // cfg.n_heads
                    b = (cfg.n_heads * hd * hd * 4
                         + 2 * cfg.d_model * dtype_bytes)
                    per_layer.append({"kind": "W", "ring_tokens": 1,
                                      "bytes": b})
                    total += b
                    continue
                b = 2 * ring * kv_width * dtype_bytes  # K and V
                per_layer.append({"kind": kind, "ring_tokens": ring,
                                  "bytes": b})
                total += b
    return KVPlan(per_layer=per_layer, bytes_per_seq=total, max_len=max_len)
