"""Meshes on one card, and the card's constants for the roofline.

The port of ``src/repro/launch/mesh.py``. A jax mesh places each shard of
an array on its own chip; the port runs on one H100, so a :class:`Mesh`
is a small frozen record: the axis names, their sizes (``.shape``, a
dict, as a jax mesh has) and the one device every shard lives on. A mesh
of any size is a *logical* layout: ``distributed/sharding.py`` resolves
specs against it (how a production deployment would split each leaf),
and the dry run divides each leaf's bytes by the axes its spec names.
``make_card_mesh()`` is the (1, 1) mesh of the card itself: every spec
on it means replicated, and it is the dry run's default.

``TPU_V5E`` keeps the reference's constants (its roofline numbers);
``H100`` holds the card's, each from one home: the bf16 dense rate here,
the device-memory rate from ``perf/measure.py::datasheet_peaks``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch

from repro_torch._device import resolve_device
from repro_torch.perf.measure import datasheet_peaks


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} against sizes "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def compat_make_mesh(shape, axes, device="cuda") -> Mesh:
    """A logical mesh of ``shape`` over ``axes``; every shard lives on
    ``device`` (the card unless ``"cpu"``)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape}")
    return Mesh(axes, shape, resolve_device(device))


_CURRENT: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def current_mesh() -> Mesh | None:
    """The mesh of the innermost :func:`mesh_scope`, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    """Make ``mesh`` current and its device the current card."""
    tok = _CURRENT.set(mesh)
    try:
        if mesh.device.type == "cuda":
            with torch.cuda.device(mesh.device):
                yield mesh
        else:
            yield mesh
    finally:
        _CURRENT.reset(tok)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """The reference's production layout, (16, 16) ``("data", "model")``
    or (2, 16, 16) ``("pod", "data", "model")``, as a logical mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device)


def make_host_mesh(data: int = 2, model: int = 4, device="cuda") -> Mesh:
    """A small logical ``("data", "model")`` mesh (the reference's
    host-device test mesh)."""
    return compat_make_mesh((data, model), ("data", "model"), device)


def make_card_mesh(device="cuda") -> Mesh:
    """The card itself: the (1, 1) ``("data", "model")`` mesh."""
    return compat_make_mesh((1, 1), ("data", "model"), device)


# Hardware constants for the roofline analysis (assignment-provided).
TPU_V5E = {
    "peak_flops_bf16": 197e12,     # per chip
    "hbm_bw": 819e9,               # bytes/s per chip
    "ici_bw": 50e9,                # bytes/s per link
    "hbm_bytes": 16 << 30,
    "chips_per_pod": 256,
}

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core rate (the sparse
# figure is twice this), 80 GB of HBM3, NVLink 4 at 900 GB/s a GPU (both
# directions summed) over 18 links. The HBM rate is datasheet_peaks'.
H100_BF16_DENSE_FLOPS = 989e12
H100 = {
    "peak_flops_bf16": H100_BF16_DENSE_FLOPS,
    "hbm_bw": datasheet_peaks("NVIDIA H100 80GB HBM3").hbm_bytes_per_s,
    "hbm_bytes": 80e9,
    "nvlink_bw": 900e9,            # bytes/s per GPU, all links
    "nvlink_links": 18,
}
