"""The decode of unorm8 frames: 8-bit unsigned-normalised pixels, the
byte v in 0..255 standing for the float32 value v / 255.

A host frame in this format crosses the link at one byte a pixel and is
decoded on the card (``unorm8_decode_kernel``, in the shared library of
``csrc/stencil_pipeline.cu``, which serving loads anyway) into the
float32 the stencil kernel reads. The decode is a lookup in
:data:`TABLE`, computed once on the host as ``np.float32(v) /
np.float32(255)``, the correctly rounded quotient: no division on the
card decides a bit (torch's CUDA division by a Python scalar multiplies
by the reciprocal, which differs in the last place for some v).
:func:`decode_plain`, the table indexed by the pixels, is the kernel's
plain version; :data:`decode` takes it for CPU tensors and launches the
kernel for CUDA ones.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

TABLE = np.arange(256, dtype=np.float32) / np.float32(255)
THREADS = 256                     # kDecodeThreads: one table entry each
MAX_BLOCKS = 4096                 # beyond, the CTAs stride over the pixels

_TABLES: dict[torch.device, torch.Tensor] = {}


def is_unorm8(frame) -> bool:
    """Whether ``frame`` (a numpy array or a tensor) holds uint8 pixels."""
    if isinstance(frame, torch.Tensor):
        return frame.dtype == torch.uint8
    return np.asarray(frame).dtype == np.uint8


def table(device: torch.device) -> torch.Tensor:
    """:data:`TABLE` as a float32 tensor on ``device``, made once."""
    t = _TABLES.get(device)
    if t is None:
        t = _TABLES[device] = torch.from_numpy(TABLE).to(device)
    return t


def decode_plain(raw: torch.Tensor) -> torch.Tensor:
    """The plain version: :data:`TABLE` indexed by the uint8 pixels of
    ``raw``, a float32 tensor of its shape on its device."""
    return table(raw.device)[raw.long()]


def _library() -> ctypes.CDLL:
    lib = _build.load("stencil_pipeline")
    fn = lib.unorm8_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                ctypes.c_int,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.stencil_pipeline_error_string.argtypes = [ctypes.c_int]
        lib.stencil_pipeline_error_string.restype = ctypes.c_char_p
    return lib


class Unorm8Decode:
    """Wrapper of the decode kernel: ``self(raw, out)`` writes the
    decoded ``raw`` (uint8) into ``out`` (float32, ``raw``'s shape, both
    contiguous on one device) and returns ``out``, a new tensor when
    ``out`` is None. CPU tensors take :func:`decode_plain`; CUDA ones
    launch the kernel on the current stream, and ``launches`` counts
    those launches."""
    name = "unorm8_decode"

    def __init__(self):
        self.launches = 0

    def __call__(self, raw: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        if raw.dtype != torch.uint8:
            raise TypeError(f"unorm8 pixels must be uint8, got {raw.dtype}")
        if out is None:
            out = torch.empty(raw.shape, dtype=torch.float32,
                              device=raw.device)
        if out.dtype != torch.float32 or out.shape != raw.shape \
                or out.device != raw.device:
            raise ValueError(f"the output must be float32 of shape "
                             f"{tuple(raw.shape)} on {raw.device}, got "
                             f"{out.dtype} {tuple(out.shape)} on "
                             f"{out.device}")
        if not (raw.is_contiguous() and out.is_contiguous()):
            raise ValueError("unorm8 decode needs contiguous tensors")
        dev = raw.device
        if dev.type == "cpu":
            return out.copy_(decode_plain(raw))
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        n = raw.numel()
        if n == 0:
            return out
        lib = _library()
        blocks = min(-(-n // (4 * THREADS)), MAX_BLOCKS)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.unorm8_decode_launch(raw.data_ptr(), out.data_ptr(),
                                          table(dev).data_ptr(), n, blocks,
                                          stream)
        if rc != 0:
            msg = lib.stencil_pipeline_error_string(rc).decode()
            raise RuntimeError(f"unorm8 decode launch failed: {msg}")
        self.launches += 1
        return out


decode = Unorm8Decode()
