"""Design-space exploration (paper Fig. 10) on the PyTorch port's planner:
per-stage memory config sweep -> Pareto frontier, plotted per algorithm.

    PYTHONPATH=src python examples/imagen_dse_torch.py [--out dse.png]
    PYTHONPATH=src python examples/imagen_dse_torch.py --full   # 1920 wide

Planner only: no kernel runs, and the device is named for the record.
Without matplotlib the per-algorithm lines are printed and no plot is
written.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.core import algorithms, dse  # noqa: E402
from repro_torch.core.linebuffer import DP_SIZED, DPLC_SIZED  # noqa: E402

# the JAX package's sweep width, and 1080p's
WIDTHS = {False: 480, True: 1920}
ALGORITHMS = ("canny-m", "denoise-m")
MAX_POINTS = 300


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dse_pareto.png")
    ap.add_argument("--full", action="store_true",
                    help="sweep 1920-wide plans")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w = WIDTHS[args.full]
    print(f"device: {device_label(dev)} (planner only: no kernel runs)")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None

    axes = [None] * len(ALGORITHMS)
    if plt is not None:
        fig, axes = plt.subplots(1, len(ALGORITHMS), figsize=(9, 4))
    sweeps = {}
    for ax, name in zip(axes, ALGORITHMS):
        dag = algorithms.ALGORITHMS[name]()
        pts = dse.sweep(dag, w, [DP_SIZED, DPLC_SIZED],
                        max_points=MAX_POINTS)
        par = sorted((p for p in pts if p.pareto), key=lambda p: p.area)
        sweeps[name] = pts
        if ax is not None:
            ax.scatter([p.area / 1e6 for p in pts], [p.power for p in pts],
                       s=12, alpha=0.4, label="designs")
            ax.plot([p.area / 1e6 for p in par], [p.power for p in par],
                    "ro-", label="Pareto")
            for p in par:
                n_lc = sum(1 for v in p.combo.values() if v == "DPLC")
                ax.annotate(f"{n_lc} LC", (p.area / 1e6, p.power),
                            fontsize=7)
            ax.set_title(f"{name}: {len(par)} Pareto designs")
            ax.set_xlabel("area (rel.)")
            ax.set_ylabel("power (rel.)")
            ax.legend()
        print(f"{name}: {len(pts)} designs, {len(par)} pareto-optimal "
              f"(paper Fig. 10: frontier shape is algorithm-specific)")
    if plt is None:
        print("matplotlib is not installed: no plot written")
        return {"sweeps": sweeps, "plot": None}
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return {"sweeps": sweeps, "plot": args.out}


if __name__ == "__main__":
    main()
