"""End-to-end LM training with checkpoint/restart on the PyTorch port.

Default is a small model that visibly learns in a minute on the CPU;
--full trains the ~100M-parameter configuration (same code path). Runs on
the card unless --device cpu.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--full]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 60
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.checkpointing import (Supervisor,  # noqa: E402
                                       SupervisorConfig)
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.train import (OptConfig, make_train_state,  # noqa: E402
                               make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="~100M params (slow on the CPU; sized for the card)")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = get_config(args.arch)
    if args.full:
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_ff=2048, vocab=32768, dtype="float32", remat=False)
        batch, seq = 16, 512
    else:
        cfg = dataclasses.replace(
            base, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
            d_ff=256, vocab=512, dtype="float32", remat=False)
        batch, seq = 8, 128
    model = build_model(cfg, device=dev)
    n_params = model.param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={batch}x{seq} steps={args.steps} device={dev}")

    opt = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(model, opt)
    data = TokenStream(cfg.vocab, batch=batch, seq=seq, seed=0)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        sup = Supervisor(SupervisorConfig(ckpt_dir=ckpt_dir,
                                          ckpt_every=100),
                         step, state, data)
        sup.run(args.steps)
    losses = [m["loss"] for m in sup.metrics_log]
    k = max(len(losses) // 10, 1)
    print("loss curve:",
          " -> ".join(f"{sum(losses[i:i+k])/k:.3f}"
                      for i in range(0, len(losses),
                                     max(len(losses) // 8, 1))))
    assert losses[-1] < losses[0], "model failed to learn"
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}) — learning ✓")
    return losses


if __name__ == "__main__":
    main()
