"""Training CLI.

    python -m repro_torch.launch.train --arch gemma3-1b --reduced --steps 50
    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 4 --device cpu

One process on one device (the card unless ``--device cpu``). The
fault-tolerance supervisor wraps the loop: checkpoint/restart, failure
injection (for drills), straggler detection. Weights are random, drawn
from a generator seeded with ``--seed`` on the training device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config for CPU/local runs")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host (not ported yet)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="multi-pod (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.distributed or args.multi_pod:
        ap.error("--distributed / --multi-pod: the port trains on one "
                 "device; distributed/ is a later slice (ROADMAP.md A.3)")

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.checkpointing import Supervisor, SupervisorConfig
    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model, get_config
    from repro_torch.train import OptConfig, make_train_state, \
        make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    state = make_train_state(
        model, torch.Generator(device=dev).manual_seed(args.seed),
        compress_grads=args.compress_grads)
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum,
                              compress_grads=args.compress_grads)
    data = TokenStream(cfg.vocab, batch=args.batch, seq=args.seq,
                       seed=args.seed)
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state, ds, start = ckpt.restore(args.ckpt_dir, state)
        if ds:
            data.restore(ds)
        print(f"resumed from step {start}")

    sup = Supervisor(SupervisorConfig(ckpt_dir=args.ckpt_dir,
                                      ckpt_every=args.ckpt_every),
                     step_fn, state, data)
    out = sup.run(args.steps, start_step=start)
    losses = [m["loss"] for m in sup.metrics_log]
    print(f"done: {out} on {dev}")
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"min={min(losses):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
