"""Sliding-window decode attention over a ring KV cache.

The port of the JAX package's ``swa_decode``: for local attention the
decode KV cache holds only the last ``window`` tokens in a ring — a line
buffer of ``window`` rows, the decode step as producer and attention as
consumer. One CUDA kernel (``csrc/swa_decode.cu``) computes it, one CTA
per (batch, kv head) over the head's whole GQA group (see the source note
there). The layout is the JAX package's: q (B, Hq, D); k, v (B, S, Hkv,
D); ``length`` and ``ring_start`` (B,) int32.

  * :func:`swa_decode_plain` — the kernel's plain PyTorch version, the
    Pallas kernel's math: scores times 1/sqrt(D), ring mask, the softmax
    whose all-masked rows give zero, p · v, in float32;
  * :data:`swa_decode` — the wrapper. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises, and
    ``swa_decode.launches`` counts those launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SMEM_LIMIT = 232_448   # shared memory one H100 block may reserve (227 KB)
# kernel against plain version, and plain version against the JAX oracle:
# the JAX package's own tolerance for its kernel (tests/test_kernels.py)
RTOL, ATOL = 2e-4, 2e-5


def smem_bytes(g: int, s: int, d: int) -> int:
    """Dynamic shared memory one CTA reserves: the group's G query rows
    and G x S scores."""
    return (g * d + g * s) * 4


def ring_valid(length: torch.Tensor, ring_start: torch.Tensor,
               s: int) -> torch.Tensor:
    """(B, S) mask: slot i holds one of the ``length`` most recent
    writes, i.e. (i - ring_start) mod S < length."""
    idx = torch.arange(s, device=length.device)
    return torch.remainder(idx[None, :] - ring_start[:, None], s) \
        < length[:, None]


def swa_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, ring_start: torch.Tensor
                     ) -> torch.Tensor:
    """q (B, Hq, D); k, v (B, S, Hkv, D) float32 -> (B, Hq, D) float32."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.matmul(qg, k.permute(0, 2, 3, 1)) * (1.0 / float(d) ** 0.5)
    valid = ring_valid(length, ring_start, s)[:, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p, v.permute(0, 2, 1, 3)).reshape(b, hq, d)


def _lib() -> ctypes.CDLL:
    lib = _build.load("swa_decode")
    fn = lib.swa_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.swa_decode_error_string.argtypes = [ctypes.c_int]
        lib.swa_decode_error_string.restype = ctypes.c_char_p
    return lib


class SwaDecodeKernel:
    """Wrapper of the swa_decode kernel.

    ``self(q, k, v, length, ring_start)`` with q (B, Hq, D), k and v
    (B, S, Hkv, D) and Hq a multiple of Hkv, all on one device; bf16 or
    fp16 inputs are cast to float32, as the JAX package's wrapper casts
    them. ``length`` and ``ring_start`` are (B,) integers (or scalars,
    broadcast over the batch). Returns (B, Hq, D) float32.
    """
    name = "swa_decode"

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length, ring_start) -> torch.Tensor:
        if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
            raise ValueError(f"swa_decode takes q (B, Hq, D) and k, v "
                             f"(B, S, Hkv, D), got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        b, hq, d = q.shape
        kb, s, hkv, kd = k.shape
        if kb != b or kd != d or hq % hkv:
            raise ValueError(f"q {tuple(q.shape)} does not fit k "
                             f"{tuple(k.shape)} (Hq must be a multiple "
                             f"of Hkv)")
        dev = q.device
        if k.device != dev or v.device != dev:
            raise ValueError("q, k and v must be on one device")
        q, k, v = (t.to(torch.float32).contiguous() for t in (q, k, v))
        length, ring_start = (
            torch.as_tensor(x, device=dev).to(torch.int32).expand(b)
            .contiguous() for x in (length, ring_start))
        if dev.type == "cpu":
            return swa_decode_plain(q, k, v, length, ring_start)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        g = hq // hkv
        smem = smem_bytes(g, s, d)
        if smem > SMEM_LIMIT:
            raise ValueError(f"G={g}, S={s}, D={d} needs {smem} bytes of "
                             f"shared memory, over the {SMEM_LIMIT}-byte "
                             f"block limit")
        if b > 65535:
            raise ValueError(f"batch {b} exceeds the grid's 65535 rows")
        lib = _lib()
        out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.swa_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                ring_start.data_ptr(), out.data_ptr(), b, hkv, g, s, d,
                1.0 / float(d) ** 0.5, stream)
        if rc != 0:
            raise RuntimeError(f"swa_decode launch failed: "
                               f"{lib.swa_decode_error_string(rc).decode()}")
        self.launches += 1
        return out


swa_decode = SwaDecodeKernel()
