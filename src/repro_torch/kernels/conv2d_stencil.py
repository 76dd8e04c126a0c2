"""Single-stage causal 2-D convolution — the building-block stencil.

The port of the JAX package's ``conv2d`` (one stencil stage, bottom-right
aligned, zero padded, float32). One CUDA kernel
(``csrc/conv2d_stencil.cu``) computes it; one CTA owns one (TR-row
tile, column strip) and reads its input tile, halo included, into shared
memory once (see the source note there).

  * :func:`conv2d_plain` — the kernel's plain PyTorch version: whole
    frame, one rounded product and sum per tap in the reference's order,
    so the kernel equals it bit for bit;
  * :data:`conv2d` — the wrapper. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises, and ``conv2d.launches``
    counts those launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

STRIP_W = 128          # output columns per CTA (kStripW in the source)
SMEM_LIMIT = 232_448   # shared memory one H100 block may reserve (227 KB)


def smem_bytes(kh: int, kw: int, tile_rows: int) -> int:
    """Dynamic shared memory one CTA reserves: the weights and its
    (TR + kh - 1) x (STRIP_W + kw - 1) input tile."""
    return (kh * kw + (tile_rows + kh - 1) * (STRIP_W + kw - 1)) * 4


def conv2d_plain(img: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """out = sum over (dy, dx), dy-major, of w[dy, dx] * the input shifted
    down dy - kh + 1 and right dx - kw + 1 rows/columns, zeros above and
    left of the frame, starting from zero — the reference's order."""
    kh, kw = weights.shape
    h, w = img.shape
    pad = F.pad(img, (kw - 1, 0, kh - 1, 0))
    out = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for dy in range(kh):
        for dx in range(kw):
            out = out + weights[dy, dx] * pad[dy:dy + h, dx:dx + w]
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d_stencil")
    fn = lib.conv2d_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.conv2d_error_string.argtypes = [ctypes.c_int]
        lib.conv2d_error_string.restype = ctypes.c_char_p
    return lib


class Conv2dKernel:
    """Wrapper of the conv2d kernel.

    ``self(img, weights, tile_rows=8)``: img (h, w) and weights (kh, kw)
    on one device, cast to contiguous float32 as the reference casts
    them; returns the (h, w) float32 output on that device.
    """
    name = "conv2d"

    def __init__(self):
        self.launches = 0

    def __call__(self, img: torch.Tensor, weights: torch.Tensor,
                 tile_rows: int = 8) -> torch.Tensor:
        if img.dim() != 2 or weights.dim() != 2:
            raise ValueError(f"conv2d takes an (h, w) image and (kh, kw) "
                             f"weights, got {tuple(img.shape)} and "
                             f"{tuple(weights.shape)}")
        if img.device != weights.device:
            raise ValueError(f"image on {img.device}, weights on "
                             f"{weights.device}")
        if tile_rows < 1:
            raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
        h, w = img.shape
        kh, kw = weights.shape
        if min(h, w, kh, kw) < 1:
            raise ValueError("conv2d needs a non-empty image and filter")
        img = img.to(torch.float32).contiguous()
        weights = weights.to(torch.float32).contiguous()
        dev = img.device
        if dev.type == "cpu":
            return conv2d_plain(img, weights)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        smem = smem_bytes(kh, kw, tile_rows)
        if smem > SMEM_LIMIT:
            raise ValueError(f"a {kh}x{kw} filter at tile_rows={tile_rows} "
                             f"needs {smem} bytes of shared memory, over "
                             f"the {SMEM_LIMIT}-byte block limit")
        if -(-h // tile_rows) > 65535:
            raise ValueError(f"{h} rows at tile_rows={tile_rows} exceed "
                             f"the grid's 65535 tiles")
        lib = _lib()
        out = torch.empty((h, w), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.conv2d_launch(img.data_ptr(), weights.data_ptr(),
                                   out.data_ptr(), h, w, kh, kw, tile_rows,
                                   stream)
        if rc != 0:
            raise RuntimeError(f"conv2d launch failed: "
                               f"{lib.conv2d_error_string(rc).decode()}")
        self.launches += 1
        return out


conv2d = Conv2dKernel()
