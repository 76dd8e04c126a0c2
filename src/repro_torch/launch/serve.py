"""Serving driver: batched requests against a (reduced) model.

    python -m repro_torch.launch.serve --arch gemma3-1b --reduced --requests 6
    python -m repro_torch.launch.serve --arch gemma3-1b --device cpu --reduced

Weights are random, drawn from a generator seeded with ``--seed`` on the
serving device (the card unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device, synchronize
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build_model, get_config
    from repro_torch.serve import Engine, Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.family == "encoder":
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    eng = Engine(model, n_slots=args.slots, max_len=args.max_len,
                 seed=args.seed)
    print(f"kv plan: {eng.kv_plan.bytes_per_seq} B/seq; "
          f"slots within 16GiB HBM: "
          f"{eng.kv_plan.batch_budget(16 << 30)}")
    rng = np.random.RandomState(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab, size=rng.randint(3, 12)),
                    max_new=args.max_new, temperature=0.8 if i % 2 else 0.0)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = eng.run(reqs)
    synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"req {rid}: {results[rid]}")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s) on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
