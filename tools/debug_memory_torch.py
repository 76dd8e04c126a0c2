"""List the largest tensors one dry-run cell's step creates, on the port.

    PYTHONPATH=src python tools/debug_memory_torch.py --arch gemma3-1b
    PYTHONPATH=src python tools/debug_memory_torch.py --arch rwkv6-1.6b \
        --shape decode_32k --top 10 --device cpu

The twin of ``tools/debug_memory.py``, which reads the compiled HLO of
the cell's step. Eager PyTorch has no compiled program, so the step runs
here on the meta device (shapes and dtypes, no storage, no card memory)
under a ``TorchDispatchMode`` that records every aten op's outputs: bytes,
dtype, shape, op and the innermost module that ran it (for a backward op,
the module whose forward made its autograd node). Rows are deduplicated
by (dtype, shape, op), as the reference's are, and the largest ``--top``
are printed in the reference's columns.

The step is the port's: train — ``make_train_step`` (``Model.loss``,
backward, the AdamW update of the float32 masters and moments, with the
dry run's microbatch count); prefill — ``forward``; decode —
``decode_step``, with the inputs of ``launch/shapes.py``. Tensors are
whole: one card, no sharding applied. First come the dry run's status and
argument + output GiB (``launch.dryrun.lower_cell`` on the card's (1, 1)
mesh); temp bytes are not known, since eager PyTorch has no compile-time
memory analysis, and none are guessed. A recurrent architecture's 4k-32k
steps take minutes on meta. ``--device`` names the mesh's device: the card
unless ``cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_card_mesh  # noqa: E402
from repro_torch.launch.shapes import (META, SHAPES,  # noqa: E402
                                       decode_input_specs,
                                       prefill_input_specs,
                                       train_input_specs)
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.train import OptConfig, make_train_step  # noqa: E402

# the reference's HLO type names, so the columns read alike
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
          torch.uint8: "u8", torch.int8: "s8", torch.float64: "f64"}


def caller(names: dict[int, str]) -> tuple[str | None, str | None]:
    """(module, function): the innermost caller whose first argument is
    one of the model's modules (the model's layers are functions of their
    parameter blocks), by the module's name, and the innermost function
    of the port (``adamw_update()``); None where there is none."""
    frame = sys._getframe(1)
    function = None
    while frame is not None:
        code = frame.f_code
        if code.co_argcount:
            name = names.get(id(frame.f_locals.get(code.co_varnames[0])))
            if name is not None:
                return name or "model", function
        if function is None and frame.f_globals.get(
                "__name__", "").startswith("repro_torch."):
            function = f"{code.co_name}()"
        frame = frame.f_back
    return None, function


class NodeTagger(TorchFunctionMode):
    """Tags the autograd node of every output with the module that made
    it, so the backward op that runs the node can name it."""

    def __init__(self, names: dict[int, str]):
        super().__init__()
        self.names = names

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.grad_fn is not None \
                    and "module" not in t.grad_fn.metadata:
                module, function = caller(self.names)
                t.grad_fn.metadata["module"] = module or function
        return out


class OutputRecorder(TorchDispatchMode):
    """``rows``: (bytes, dtype, shape, aten op, module) of every tensor
    every op returns."""

    def __init__(self, names: dict[int, str]):
        super().__init__()
        self.names = names
        self.rows: list[tuple] = []

    def where(self) -> str:
        module, function = caller(self.names)
        if module is not None:
            return module
        node = torch._C._current_autograd_node()
        if node is not None:
            return f"{node.metadata.get('module') or '-'} ({node.name()})"
        return function or "-"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = [t for t in pytree.tree_leaves(out)
                   if isinstance(t, torch.Tensor)]
        if tensors:
            where = self.where()
            for t in tensors:
                self.rows.append((t.numel() * t.element_size(),
                                  DTYPES.get(t.dtype, str(t.dtype)),
                                  tuple(t.shape),
                                  func.overloadpacket.__name__, where))
        return out


def run_step(cfg, kind: str, batch: int, seq: int,
             grad_accum: int = 1) -> list[tuple]:
    """The step of a ``kind`` cell (train, prefill, decode) of ``cfg`` at
    (batch, seq), on meta; every op's outputs as recorded rows."""
    model = build_model(cfg, device=META)
    names = {id(m): n for n, m in model.named_modules()}
    rec = OutputRecorder(names)
    if kind == "train":
        state = dryrun.abstract_state(model)
        model.requires_grad_(True)
        step = make_train_step(model, OptConfig(), grad_accum=grad_accum)
        with NodeTagger(names), rec:
            step(state, train_input_specs(cfg, batch, seq))
    elif kind == "prefill":
        with rec:
            model.forward(prefill_input_specs(cfg, batch, seq))
    else:
        specs = decode_input_specs(model, batch, seq)
        with rec:
            model.decode_step(specs["caches"], specs["tokens"], specs["pos"])
    return rec.rows


def largest(rows: list[tuple], top: int) -> list[tuple]:
    """The ``top`` largest rows, one per (dtype, shape, op)."""
    seen, shown = set(), []
    for row in sorted(rows, key=lambda r: r[0], reverse=True):
        key = row[1:4]
        if key in seen:
            continue
        seen.add(key)
        shown.append(row)
        if len(shown) >= top:
            break
    return shown


def main(argv=None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device (the step runs on meta)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    res = dryrun.lower_cell(args.arch, args.shape, make_card_mesh(dev),
                            "card", verbose=False)
    gib = 1 << 30
    print(f"{args.arch} x {args.shape} on {device_label(dev)}, the (1, 1) "
          f"mesh; status: {res.status}")
    if res.status != "run":
        return []
    print(f"arg+out GiB: {(res.arg_bytes + res.out_bytes) / gib:.2f} (arg "
          f"{res.arg_bytes / gib:.2f}, out {res.out_bytes / gib:.2f}); temp "
          f"GiB: not known (eager PyTorch has no compile-time memory "
          f"analysis)")
    print("tensors are whole: one card, no sharding applied; the step ran "
          "on meta")
    sh = SHAPES[args.shape]
    rows = largest(run_step(get_config(args.arch), sh["kind"], sh["batch"],
                            sh["seq"], dryrun.GRAD_ACCUM.get(args.arch, 1)),
                   args.top)
    print(f"{'GiB':>8s}  {'dtype':6s} {'op':22s} shape  module")
    for s, dt, dims, op, name in rows:
        print(f"{s / gib:8.2f}  {dt:6s} {op:22s} "
              f"[{','.join(map(str, dims))}]  {name}")
    return rows


if __name__ == "__main__":
    main()
