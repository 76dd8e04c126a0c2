"""Training driver (its ``main`` comes with the training port).

Holds ``reduced_config``, which the serving driver's ``--reduced`` uses.
"""
from __future__ import annotations

import dataclasses


def reduced_config(cfg, d_model=128, n_layers=4, vocab=1024):
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2)
        if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32 if cfg.head_dim else 0, d_ff=d_model * 2, vocab=vocab,
        lru_width=d_model if cfg.lru_width else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0)
