"""Training CLI.

    python -m repro_torch.launch.train --arch gemma3-1b --reduced --steps 50
    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 4 --device cpu

One process on one device (the card unless ``--device cpu``). The
fault-tolerance supervisor wraps the loop: checkpoint/restart, failure
injection (for drills), straggler detection. Weights are random, drawn
from a generator seeded with ``--seed`` on the training device.

The encoder (hubert) reads ``frame_embeds`` in place of tokens: its
batches carry them in the shape and dtype ``launch/shapes.py::
train_input_specs`` gives, (B, S, d_model) bf16, drawn from a generator
seeded with (seed, step), so a resumed run sees the inputs an
uninterrupted one saw. (The reference's CLI feeds the encoder tokens
only and fails on its first step.)

``--distributed`` trains in a process group of one rank (NCCL on the
card, gloo on the CPU): the data stream takes its rank and world size
from the group, and the step averages the gradients over it. The group
meets through torchrun's ``env://`` variables where they are set, else
through a ``FileStore`` in a temporary directory; it is destroyed at
exit. The port runs on a single card, so a world size above 1 and
``--multi-pod`` are refused.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile

import numpy as np

SINGLE_CARD = ("the port trains on a single card (one process, one "
               "device)")


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


class FrameEmbedStream:
    """``stream``'s batches with the encoder's ``frame_embeds`` added:
    standard normal draws, rounded to the spec's dtype, from a Philox
    generator keyed by the stream's seed at (step, rank) — the tokens'
    counter with a lane of its own. Checkpoints through the stream's own
    (seed, step) state."""

    def __init__(self, stream, cfg):
        self.stream, self.cfg = stream, cfg

    def next(self) -> dict:
        import torch

        from repro_torch.launch.shapes import train_input_specs
        st = self.stream.state
        rng = np.random.Generator(np.random.Philox(
            key=st.seed, counter=[0, 1, st.step, self.stream.rank]))
        batch = self.stream.next()
        b, s = batch["tokens"].shape
        want = train_input_specs(self.cfg, b, s)["frame_embeds"]
        x = rng.standard_normal(tuple(want.shape), dtype=np.float32)
        batch["frame_embeds"] = torch.from_numpy(x).to(want.dtype)
        return batch

    def snapshot(self) -> dict:
        return self.stream.snapshot()

    def restore(self, snap: dict) -> None:
        self.stream.restore(snap)


@contextlib.contextmanager
def process_group(dev):
    """A process group of one rank for the run (NCCL on the card, gloo on
    the CPU), destroyed at exit; yields it."""
    import torch.distributed as dist
    backend = "nccl" if dev.type == "cuda" else "gloo"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != 1:
        raise SystemExit(f"--distributed: world size {world}; {SINGLE_CARD}")
    with contextlib.ExitStack() as stack:
        if "MASTER_ADDR" in os.environ and "RANK" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    world_size=1, rank=0)
        else:
            d = stack.enter_context(tempfile.TemporaryDirectory())
            store = dist.FileStore(os.path.join(d, "store"), 1)
            dist.init_process_group(backend, store=store, world_size=1,
                                    rank=0)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


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
                    help="train in a process group of one rank")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: " + SINGLE_CARD)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.multi_pod:
        ap.error(f"--multi-pod: {SINGLE_CARD}; there is no pod to span")

    from repro_torch._device import resolve_device
    dev = resolve_device(args.device)
    with (process_group(dev) if args.distributed
          else contextlib.nullcontext()) as group:
        return _train(args, dev, group)


def _train(args, dev, group) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpointing import Supervisor, SupervisorConfig
    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model, get_config
    from repro_torch.train import OptConfig, make_train_state, \
        make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=dev)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    state = make_train_state(
        model, torch.Generator(device=dev).manual_seed(args.seed),
        compress_grads=args.compress_grads)
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum,
                              compress_grads=args.compress_grads,
                              process_group=group)
    ranks = {} if group is None else dict(
        n_ranks=dist.get_world_size(group), rank=dist.get_rank(group))
    data = TokenStream(cfg.vocab, batch=args.batch, seq=args.seq,
                       seed=args.seed, **ranks)
    if cfg.family == "encoder":
        data = FrameEmbedStream(data, cfg)
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
    where = "" if group is None else (
        f" in a process group ({dist.get_backend(group)}, world size "
        f"{dist.get_world_size(group)})")
    print(f"done: {out} on {dev}{where}")
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"min={min(losses):.4f}")
        print(f"losses: {json.dumps(losses)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
