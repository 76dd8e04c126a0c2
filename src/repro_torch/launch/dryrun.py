"""Dry run on one card: every (arch x shape) cell counted on ``meta``.

The port of ``src/repro/launch/dryrun.py``. The reference lowers and
compiles each cell for 512 fake XLA devices and reads XLA's memory and
cost analyses. Eager PyTorch has no compiler to ask, so a cell is counted
here, on ``torch.device("meta")`` (shapes and dtypes, no storage; no
card memory is allocated), against a mesh: the card's (1, 1) mesh by
default, or the reference's logical ``pod`` (16, 16) / ``multipod``
(2, 16, 16) meshes, each leaf divided by the mesh axes its spec names
(``distributed/sharding.py``). Per cell, per device:

  * ``arg_bytes`` — the call's arguments. train: the parameters as the
    port stores them, float32 masters, m and v, the step, the batch;
    prefill: the parameters and the batch; decode: the parameters, the
    caches, tokens and pos. ``out_bytes`` — the results the call
    allocates (train: its three metric scalars; prefill: the next-token
    logits; decode: the logits). The train step updates the state, and
    the decode step the caches, in place: they are arguments, not new
    results.
  * ``temp_bytes`` — None: eager PyTorch has no compile-time memory
    analysis, and no number is guessed (the smoke's launch phase
    measures it for one cell on the card).
  * ``fits`` — whether ``arg_bytes + out_bytes`` fits the H100's 80 GB.
    A cell is never shrunk to fit.
  * ``flops_per_dev`` — decode: ``FlopCounterMode`` over ``decode_step``
    on meta (what the port computes, one token); train and prefill: the
    analytic count, ``model_flops`` (6 or 2 x active parameters x tokens)
    plus ``attention_flops`` (the score and value products). A meta run
    of a recurrent arch's full sequence is a Python loop of 4k-32k steps
    (minutes a cell), hence the analytic count.
  * ``bytes_per_dev`` — a lower bound on device-memory traffic: the
    arguments read once, the results written once, and what the call
    writes in place (train: the whole state; decode: one position of
    each attention ring and the whole recurrent states).
  * ``coll_bytes`` — ``{}``. The reference parses collectives out of the
    compiled HLO (``collective_bytes``); eager PyTorch on one card has no
    such program and no counterpart (``tools/debug_memory.py``, which
    reads compiled HLO, has none either). The collective term is zero.

The port stores some leaves in float32 where the reference's
``_cast_params`` casts every float32 leaf of two or more dims (its
per-layer leaves are stacked) to the compute dtype: ``FLOAT32_LEAVES``
(the embedding table, which ``unembed`` reads in float32; ``lm_head``;
the per-layer norm scales; the MoE router; the RG-LRU ``lambda_p``; the
RWKV ``decay_base`` and ``bonus_u``). ``arg_bytes`` counts them as the
port stores them.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
  python -m repro_torch.launch.dryrun --all --device cpu --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (H100, make_card_mesh,
                                     make_production_mesh, mesh_scope)
from repro_torch.launch.shapes import (META, SHAPES, cell_status,
                                       decode_input_specs,
                                       prefill_input_specs, spec,
                                       train_input_specs)
from repro_torch.models import build_model, get_config
from repro_torch.models.transformer import plan_segments

# per-arch microbatch counts for train_4k (global batch 256 stays fixed)
# and the MoE sharding mode override per arch ("tp": replicate experts,
# shard d_ff over 'model'), as the reference has them. Microbatching
# changes a step's activations, which the count leaves out, not its
# arguments or FLOPs
MOE_MODE = {}

GRAD_ACCUM = {
    "mixtral-8x22b": 8,
    "granite-moe-1b-a400m": 4,
    "recurrentgemma-2b": 4,
    "qwen2-vl-7b": 2,
    "phi4-mini-3.8b": 2,
}

# leaves the port keeps in float32 where the reference's _cast_params
# casts them to the compute dtype (name suffixes of model.named_parameters)
FLOAT32_LEAVES = ("embed.table", "lm_head", ".ln1.scale", ".ln2.scale",
                  ".moe.router", ".rec.lambda_p", ".rwkv.decay_base",
                  ".rwkv.bonus_u")


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str
    flops_per_dev: float = 0.0
    bytes_per_dev: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int | None = None
    compile_s: float = 0.0          # here: the seconds the count took
    roofline: dict = dataclasses.field(default_factory=dict)
    fits: bool | None = None

    def to_json(self):
        return dataclasses.asdict(self)


def roofline_terms(flops: float, bytes_acc: float, coll: dict,
                   links_per_chip: float = H100["nvlink_links"]) -> dict:
    """Seconds of compute (bf16 dense), device memory and collectives
    (NVLink 4, ``links_per_chip`` links) on the H100; the largest is
    ``dominant``."""
    t_compute = flops / H100["peak_flops_bf16"]
    t_memory = bytes_acc / H100["hbm_bw"]
    link_bw = H100["nvlink_bw"] / H100["nvlink_links"]
    t_coll = sum(coll.values()) / (link_bw * links_per_chip)
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dom}


# ------------------------------------------------------------ FLOP counts
def counts(arch: str, cfg=None):
    """(cfg, n_active_matmul_params, scan-superblock denominator), by the
    leaf rule of ``benchmarks/roofline.py::counts``: every parameter but
    the embedding table and the 1-d ones, the experts' weights scaled by
    top_k / n_experts. The reference's per-layer leaves are stacked, so
    its rule keeps every per-layer vector and drops only
    ``final_ln.scale``. (The reference matches its paths as
    ``"embed/table"`` and ``"moe/w_"`` against keys that print as
    ``"['embed']/['table']"``, so it counts the table and every expert in
    full; the port applies the rule its docstring states.) ``cfg``, when
    given, stands in for the arch's registered config."""
    cfg = cfg or get_config(arch)
    model = build_model(cfg, device=META)
    total = expert = 0
    for name, p in model.named_parameters():
        stacked = name.startswith("layers.")
        if name == "embed.table" or (p.ndim < 2 and not stacked):
            continue
        total += p.numel()
        if ".moe.w_" in name:
            expert += p.numel()
    frac = cfg.top_k / cfg.n_experts if cfg.n_experts else 0
    n_active = total - expert * (1 - frac)
    sum_k = sum(len(seg.kinds) for seg in model.segments)
    return cfg, n_active, sum_k


def model_flops(arch: str, shape: str, cfg=None) -> float:
    """Analytic flops for one cell (2ND/token rule of thumb)."""
    cfg, n_active, _ = counts(arch, cfg)
    sh = SHAPES[shape]
    if sh["kind"] == "train":
        return 6.0 * n_active * sh["batch"] * sh["seq"]
    if sh["kind"] == "prefill":
        return 2.0 * n_active * sh["batch"] * sh["seq"]
    return 2.0 * n_active * sh["batch"]


def _keys(s: int, window: int, causal: bool) -> int:
    """Keys summed over the ``s`` queries of a sequence: all of them
    without a causal mask, else the earlier ones, at most ``window``."""
    if not causal:
        return s * s
    w = window or s
    if w >= s:
        return s * (s + 1) // 2
    return w * (w + 1) // 2 + (s - w) * w


def attention_flops(cfg, b: int, s: int, passes: float = 3.0) -> float:
    """FLOPs of the score and value products of the attention layers
    over (b, s) tokens, 2 x 2 x heads x head_dim a key: ``passes`` 3 for
    forward + backward, 1 for a forward. Global layers see every earlier
    key, local ones at most ``window``; recurrent layers have none."""
    per_head = 4 * cfg.n_heads * cfg.hd
    total = 0
    for seg in plan_segments(cfg):
        for kind in seg.kinds:
            if kind in ("G", "L"):
                w = cfg.window if kind == "L" else 0
                total += seg.n * per_head * _keys(s, w, cfg.causal)
    return passes * b * total


def cell_flops(arch: str, shape: str, cfg=None) -> float:
    """Train and prefill: ``model_flops`` plus ``attention_flops``."""
    cfg = cfg or get_config(arch)
    sh = SHAPES[shape]
    passes = 3.0 if sh["kind"] == "train" else 1.0
    return model_flops(arch, shape, cfg) + attention_flops(
        cfg, sh["batch"], sh["seq"], passes)


# ------------------------------------------------------------ meta state
def abstract_state(model) -> dict:
    """The train state of ``train.make_train_state`` on meta: the
    parameters in their stored dtype, the step, float32 masters and
    moments."""
    params = dict(model.named_parameters())

    def f32():
        return {n: spec(p.shape, torch.float32) for n, p in params.items()}
    return {"params": params,
            "opt": {"step": spec((), torch.int32), "master": f32(),
                    "m": f32(), "v": f32()}}


def _leaves(tree, specs):
    """(tensor, spec) pairs of a tree and its spec tree (dicts and
    lists of the same layout)."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], specs[k])
    else:
        for t, s in zip(tree, specs):
            yield from _leaves(t, s)


def tree_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of every leaf of ``tree`` under ``specs``."""
    return sum(shd.per_device_bytes(t, s, mesh)
               for t, s in _leaves(tree, specs))


def _decode_written(caches, cspec, mesh) -> int:
    """Per-device bytes a decode step writes into its caches: one
    position of each attention ring (k, v: (n, B, S, kv, hd)), the whole
    recurrent states."""
    total = 0
    for seg, seg_spec in zip(caches, cspec):
        for sub, sub_spec in zip(seg, seg_spec):
            for name, t in sub.items():
                n = shd.per_device_bytes(t, sub_spec[name], mesh)
                if name in ("k", "v") and t.ndim == 5:
                    n //= t.shape[2] // shd.axes_size(mesh,
                                                      sub_spec[name][2])
                total += n
    return total


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               verbose: bool = True, cfg=None) -> CellResult:
    """One cell, counted on meta against ``mesh``. ``cfg``, when given,
    stands in for the arch's registered config (a cut depth, for the
    card's own check of the count)."""
    status = cell_status(arch, shape_name)
    res = CellResult(arch=arch, shape=shape_name, mesh=mesh_name,
                     status=status)
    if status != "run":
        return res
    cfg = cfg or get_config(arch)
    model = build_model(cfg, device=META)
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    moe_tp = MOE_MODE.get(arch) == "tp"
    t0 = time.time()

    def batch_bytes(batch: dict) -> int:
        return tree_bytes(batch, shd.batch_specs(batch, mesh), mesh)
    with mesh_scope(mesh):
        params = dict(model.named_parameters())
        pspec = shd.param_specs(model, params, mesh, moe_tp=moe_tp)
        if kind == "train":
            state = abstract_state(model)
            sspec = shd.state_specs(model, state, mesh, moe_tp=moe_tp)
            batch = train_input_specs(cfg, sh["batch"], sh["seq"])
            state_bytes = tree_bytes(state, sspec, mesh)
            res.arg_bytes = state_bytes + batch_bytes(batch)
            res.out_bytes = 3 * 4        # loss, grad_norm, lr (float32)
            written = state_bytes
            res.flops_per_dev = cell_flops(arch, shape_name,
                                           cfg) / mesh.size
        elif kind == "prefill":
            batch = prefill_input_specs(cfg, sh["batch"], sh["seq"])
            res.arg_bytes = tree_bytes(params, pspec, mesh) + \
                batch_bytes(batch)
            # the next-token logits (B, 1, V) float32, batch over DP
            res.out_bytes = batch_bytes({"logits": spec(
                (sh["batch"], 1, cfg.vocab), torch.float32)})
            written = 0
            res.flops_per_dev = cell_flops(arch, shape_name,
                                           cfg) / mesh.size
        else:
            specs = decode_input_specs(model, sh["batch"], sh["seq"])
            cspec = shd.cache_specs(model, specs["caches"], mesh)
            io = {"tokens": specs["tokens"], "pos": specs["pos"]}
            res.arg_bytes = (tree_bytes(params, pspec, mesh)
                             + tree_bytes(specs["caches"], cspec, mesh)
                             + batch_bytes(io))
            with FlopCounterMode(display=False) as fc:
                logits, _ = model.decode_step(specs["caches"],
                                              specs["tokens"], specs["pos"])
            res.out_bytes = batch_bytes({"logits": logits})
            written = _decode_written(specs["caches"], cspec, mesh)
            res.flops_per_dev = fc.get_total_flops() / mesh.size
    res.compile_s = time.time() - t0
    res.bytes_per_dev = float(res.arg_bytes + res.out_bytes + written)
    res.roofline = roofline_terms(res.flops_per_dev, res.bytes_per_dev,
                                  res.coll_bytes)
    res.fits = res.arg_bytes + res.out_bytes <= H100["hbm_bytes"]
    if verbose:
        gb = (res.arg_bytes + res.out_bytes) / 1e9
        print(f"[{mesh_name}] {arch} x {shape_name}: count "
              f"{res.compile_s:.1f}s flops/dev={res.flops_per_dev:.3e} "
              f"bytes/dev={res.bytes_per_dev:.3e} arg+out={gb:.2f}GB "
              f"{'fits' if res.fits else 'does not fit'} 80GB "
              f"dom={res.roofline['dominant']}", flush=True)
    return res


def _mesh(name: str, device):
    if name == "card":
        return make_card_mesh(device)
    return make_production_mesh(multi_pod=(name == "multipod"),
                                device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card",
                    choices=["card", "pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device (counting is on meta)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ALL_ARCHS
    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])

    results = []
    for mesh_name in meshes:
        mesh = _mesh(mesh_name, args.device)
        for arch in archs:
            for shape in shapes:
                try:
                    r = lower_cell(arch, shape, mesh, mesh_name)
                except Exception as e:  # a failing cell is a bug: surface it
                    r = CellResult(arch=arch, shape=shape, mesh=mesh_name,
                                   status=f"FAIL: {type(e).__name__}: {e}")
                    print(f"[{mesh_name}] {arch} x {shape}: {r.status}")
                results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in results if r.status.startswith("FAIL"))
    print(f"cells: {len(results)}  run: "
          f"{sum(1 for r in results if r.status == 'run')}  "
          f"skip: {sum(1 for r in results if r.status.startswith('SKIP'))}  "
          f"fail: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
