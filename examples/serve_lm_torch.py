"""Batched LM serving with ImaGen-planned ring KV caches, on the PyTorch
port.

    PYTHONPATH=src python examples/serve_lm_torch.py                # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --full         # gemma3-1b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The default is the JAX package's example: a 6-layer gemma3-style model
(d 128, float32). --full serves gemma3-1b at its full config in bf16 (26
layers, d 1152, vocab 262144) from 4 slots of 1024 positions. Weights are
random from a seeded generator. Runs on the card unless --device cpu.
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import (device_label, resolve_device,  # noqa: E402
                                 synchronize)
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

N_REQUESTS, MAX_NEW = 8, 12


def config(full: bool):
    """(model config, slots, positions a slot)."""
    base = get_config("gemma3-1b")
    if full:
        return base, 4, 1024
    # gemma3-style 5:1 local:global — the local layers use ring KV caches
    # sized by the paper's compiler (serve/kv_planner.py)
    return dataclasses.replace(
        base, n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, head_dim=0,
        d_ff=256, vocab=512, window=16, dtype="float32", remat=False), 4, 128


def requests(vocab: int) -> list[Request]:
    """Prompts of 4-9 tokens; the odd requests greedy, the even ones
    sampled."""
    rng = np.random.RandomState(0)
    return [Request(rid=i, prompt=rng.randint(0, vocab,
                                              size=rng.randint(4, 10)),
                    max_new=MAX_NEW, temperature=0.0 if i % 2 else 0.7)
            for i in range(N_REQUESTS)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="gemma3-1b at full config in bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_label(dev)}")
    cfg, n_slots, max_len = config(args.full)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    eng = Engine(model, n_slots=n_slots, max_len=max_len)
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}, {n_slots} slots of {max_len} positions")
    print("KV plan (per layer):")
    for i, e in enumerate(eng.kv_plan.per_layer):
        print(f"  layer {i:2d} [{e['kind']}] ring={e['ring_tokens']:4d} "
              f"tokens ({e['bytes']} B)")
    full_kv = 2 * max_len * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers
    print(f"bytes/seq: {eng.kv_plan.bytes_per_seq} (vs {full_kv} for "
          f"all-full); admission budget @16GiB: "
          f"{eng.kv_plan.batch_budget(16 << 30)} seqs")

    reqs = requests(cfg.vocab)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    synchronize(dev)
    dt = time.perf_counter() - t0
    for rid in sorted(results):
        print(f"req {rid}: {results[rid]}")
    n = sum(len(v) for v in results.values())
    print(f"{n} tokens in {dt:.1f}s ({n/dt:.1f} tok/s, {device_label(dev)})")
    return {"cfg": cfg, "model": model, "kv_plan": eng.kv_plan,
            "n_slots": n_slots, "max_len": max_len, "requests": reqs,
            "results": results, "seconds": dt}


if __name__ == "__main__":
    main()
