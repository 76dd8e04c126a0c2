"""Single-stage causal 2-D convolution — the building-block stencil.

The port of the JAX package's ``conv2d`` (one stencil stage, bottom-right
aligned, zero padded, float32). One CUDA library
(``csrc/conv2d_stencil.cu``) computes it: filters up to 7x7 stream down
bands of rows with a register window per thread (``conv2d_rows``),
larger ones read (TR-row tile, column strip) input tiles into shared
memory (``conv2d_tile``); see the source note there.

  * :func:`conv2d_plain` — the kernels' plain PyTorch version: whole
    frame, one rounded product and sum per tap in the reference's order,
    so the kernels equal it bit for bit;
  * :data:`conv2d` — the wrapper. A CPU tensor runs the plain version; a
    CUDA tensor launches a kernel or raises, ``conv2d.launches`` counts
    those launches and ``conv2d.variant`` names the kernel the last one
    ran.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .._device import launch_context, raw_stream
from . import _build

MAX_TAP = 7            # conv2d_rows takes filters up to MAX_TAP x MAX_TAP
COLS = 4               # conv2d_rows: output columns per thread (kCols)
STRIP_W = 128          # conv2d_tile: output columns per CTA (kStripW)
SMEM_LIMIT = 232_448   # shared memory one H100 block may reserve (227 KB)
# what conv2d_launch reports it ran (enum Variant in the source)
VARIANTS = ("tile", "rows_scalar", "rows_vector")


def uses_rows(kh: int, kw: int) -> bool:
    """Whether a kh x kw filter runs the row-streaming kernel."""
    return kh <= MAX_TAP and kw <= MAX_TAP


def smem_bytes(kh: int, kw: int, tile_rows: int) -> int:
    """Dynamic shared memory one CTA reserves: none for the row kernel;
    the weights and the (TR + kh - 1) x (STRIP_W + kw - 1) input tile
    for the tile kernel."""
    if uses_rows(kh, kw):
        return 0
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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.conv2d_error_string.argtypes = [ctypes.c_int]
        lib.conv2d_error_string.restype = ctypes.c_char_p
    return lib


class Conv2dKernel:
    """Wrapper of the conv2d kernels.

    ``self(img, weights, tile_rows=8)``: img (h, w) and weights (kh, kw)
    on one device, cast to contiguous float32 as the reference casts
    them; returns the (h, w) float32 output on that device.
    ``tile_rows`` sets the rows per CTA: the band the row kernel's
    threads walk down, or the tile kernel's tile height. The result does
    not depend on it.
    """
    name = "conv2d"

    def __init__(self):
        self.launches = 0
        self.variant: str | None = None   # kernel of the last launch
        self._ran = ctypes.c_int(-1)

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
        (h, w), (kh, kw) = img.shape, weights.shape
        if min(h, w, kh, kw) < 1:
            raise ValueError("conv2d needs a non-empty image and filter")
        if img.dtype != torch.float32:
            img = img.float()
        if weights.dtype != torch.float32:
            weights = weights.float()
        img, weights = img.contiguous(), weights.contiguous()
        if not img.is_cuda:
            if img.device.type != "cpu":
                raise ValueError(f"unsupported device {img.device}")
            return conv2d_plain(img, weights)
        smem = smem_bytes(kh, kw, tile_rows)
        if smem > SMEM_LIMIT:
            raise ValueError(f"a {kh}x{kw} filter at tile_rows={tile_rows} "
                             f"needs {smem} bytes of shared memory, over "
                             f"the {SMEM_LIMIT}-byte block limit")
        return self.launch(img, weights, tile_rows)

    def launch(self, img: torch.Tensor, weights: torch.Tensor, band: int,
               cols: int = COLS) -> torch.Tensor:
        """Launch on contiguous float32 CUDA tensors with ``band`` rows
        per CTA and, for the row kernel, ``cols`` output columns per
        thread (COLS for every filter; 1 and 2 also for 3x3 and 5x5)."""
        (h, w), (kh, kw) = img.shape, weights.shape
        if -(-h // band) > 65535:
            raise ValueError(f"{h} rows in bands of {band} exceed the "
                             f"grid's 65535 bands")
        lib = _lib()
        out = torch.empty_like(img)
        idx = img.device.index
        with launch_context(idx):
            rc = lib.conv2d_launch(img.data_ptr(), weights.data_ptr(),
                                   out.data_ptr(), h, w, kh, kw, band, cols,
                                   raw_stream(idx), ctypes.byref(self._ran))
        if rc != 0:
            raise RuntimeError(f"conv2d launch failed: "
                               f"{lib.conv2d_error_string(rc).decode()}")
        self.launches += 1
        self.variant = VARIANTS[self._ran.value]
        return out


conv2d = Conv2dKernel()
