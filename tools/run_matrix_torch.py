"""Run the port's dry-run matrix, one subprocess per cell (isolation),
merging per-cell JSON into results/dryrun_torch.json.

    PYTHONPATH=src python tools/run_matrix_torch.py            # the card
    PYTHONPATH=src python tools/run_matrix_torch.py --mesh both --device cpu

Each cell is ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M --device D``, counted on the meta device (no card memory);
``--device`` names the mesh's device: the card unless ``cpu``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402

CELLS = "results/cells_torch"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="card",
                    choices=["card", "pod", "multipod", "both"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--only-failures", action="store_true",
                    help="rerun only cells missing/failed in --out")
    args = ap.parse_args(argv)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    os.makedirs(CELLS, exist_ok=True)
    existing = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for c in json.load(f):
                existing[(c["arch"], c["shape"], c["mesh"])] = c

    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    results = []
    t_start = time.time()
    for mesh in meshes:
        for arch in ALL_ARCHS:
            for shape in SHAPES:
                key = (arch, shape, mesh)
                cell_path = f"{CELLS}/{arch}_{shape}_{mesh}.json"
                if args.only_failures and key in existing and \
                        not existing[key]["status"].startswith("FAIL"):
                    results.append(existing[key])
                    continue
                if os.path.exists(cell_path) and not args.only_failures:
                    with open(cell_path) as f:
                        cs = json.load(f)
                    if not any(c["status"].startswith("FAIL") for c in cs):
                        results.extend(cs)
                        print(f"[cached] {arch} x {shape} x {mesh}")
                        continue
                t0 = time.time()
                r = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--device", args.device, "--out", cell_path],
                    capture_output=True, text=True, timeout=3000, env=env)
                if r.returncode == 0 and os.path.exists(cell_path):
                    with open(cell_path) as f:
                        cells = json.load(f)
                    results.extend(cells)
                    for c in cells:
                        print(f"{arch} x {shape} x {mesh}: {c['status'][:60]}"
                              f" ({time.time()-t0:.0f}s)", flush=True)
                else:
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": mesh,
                                    "status": f"FAIL: rc={r.returncode} "
                                    + (r.stderr + r.stdout)[-300:]})
                    print(f"{arch} x {shape} x {mesh}: FAIL rc="
                          f"{r.returncode}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_fail = sum(1 for c in results if c["status"].startswith("FAIL"))
    print(f"total {time.time()-t_start:.0f}s; cells={len(results)} "
          f"fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
