"""Sliding-window decode attention over a ring KV cache.

The port of the JAX package's ``swa_decode``: for local attention the
decode KV cache holds only the last ``window`` tokens in a ring — a line
buffer of ``window`` rows, the decode step as producer and attention as
consumer. One CUDA library (``csrc/swa_decode.cu``) computes it,
flash-decoding style: the valid ring range is split over CTAs, each keeps
an online softmax over its share for the kv head's GQA group, and a
second kernel combines the splits (see the source note there). The
layout is the JAX package's: q (B, Hq, D); k, v (B, S, Hkv, D);
``length`` and ``ring_start`` (B,) int32.

  * :func:`swa_decode_plain` — the kernel's plain PyTorch version, the
    Pallas kernel's math: scores times 1/sqrt(D), ring mask, the softmax
    whose all-masked rows give zero, p · v, in float32;
  * :data:`swa_decode` — the wrapper. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernels or raises, and
    ``swa_decode.launches`` counts those calls (one per call, whatever
    the split count).
"""
from __future__ import annotations

import ctypes

import torch

from .._device import launch_context, raw_stream
from . import _build

# kernel against plain version, and plain version against the JAX oracle:
# the JAX package's own tolerance for its kernel (tests/test_kernels.py)
RTOL, ATOL = 2e-4, 2e-5
WARPS = 4              # warps per split CTA (kWarps in the source)
MAX_ROWS = 8           # query rows per pass, at most (kMaxRows)
MAX_SHARE = 64         # rows per pass x floats per lane, at most (kMaxShare)
MAX_SPLITS = 1024      # kMaxSplits
CTAS_PER_SM = 4        # split CTAs aimed at per SM
MIN_CHUNK = 128        # ring positions per split, at least
STAGES = 3             # rounds in flight or staged per warp (kStages)
ROUND_FLOATS = 16      # positions per round x floats per lane (kRoundFloats)


def share(d: int) -> int:
    """Floats of a D-row each lane holds: float4s when D % 4 == 0 (D up
    to 512), else floats (D up to 256); 0 when the kernel cannot take D.
    As the source's ``share``."""
    if d % 4 == 0:
        return 4 if d <= 128 else 8 if d <= 256 else 16 if d <= 512 else 0
    return 8 if d <= 256 else 0


def rows_per_pass(g: int, d: int) -> int:
    """Query rows a CTA takes at once: all G of the group, at most
    MAX_ROWS and MAX_SHARE / share(d), so they stay in registers; 0 when
    the kernel cannot take D. As the source's ``rows_per_pass``."""
    p = share(d)
    return min(g, MAX_ROWS, MAX_SHARE // p) if p else 0


def round_slots(d: int) -> int:
    """Ring positions a warp stages per round (U in the source): 4 KB of
    K and V rows at the widest head dim of the lane share."""
    return ROUND_FLOATS // share(d)


def smem_bytes(g: int, d: int) -> int:
    """Shared memory one split CTA takes: each warp's ring of STAGES
    rounds of K and V rows, reused at the end to merge the warps (a
    D-row accumulator and (m, l) per warp and query row of a pass). It
    does not depend on the window, and stays within the 48 KB a CTA
    takes without raising its limit. As the source's ``smem_bytes``."""
    u = round_slots(d)
    return max(WARPS * STAGES * 2 * u * d,
               WARPS * rows_per_pass(g, d) * (d + 2)) * 4


def split_plan(b: int, hkv: int, g: int, s: int, d: int,
               sms: int) -> tuple[int, int]:
    """(splits, chunk): the ring positions 0 .. S - 1 in ``splits`` runs
    of ``chunk``. Enough splits for CTAS_PER_SM CTAs per SM over the
    (batch, kv head, pass) rows, a power of two, with at least MIN_CHUNK
    positions each (or one split)."""
    rows = b * hkv * -(-g // rows_per_pass(g, d))
    want = -(-CTAS_PER_SM * sms // rows)
    splits = min(1 << (want - 1).bit_length(), max(1, s // MIN_CHUNK),
                 MAX_SPLITS)
    chunk = -(-s // splits)
    return -(-s // chunk), chunk


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


def _per_row(x, b: int, dev: torch.device) -> torch.Tensor:
    """``x`` (a (B,) tensor or a scalar) as a contiguous (B,) int32
    tensor on ``dev``, itself when it already is one."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32 \
            and x.shape == (b,) and x.device == dev and x.is_contiguous():
        return x
    return torch.as_tensor(x, device=dev).to(torch.int32).expand(b) \
        .contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("swa_decode")
    fn = lib.swa_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.swa_decode_error_string.argtypes = [ctypes.c_int]
        lib.swa_decode_error_string.restype = ctypes.c_char_p
    return lib


class SwaDecodeKernel:
    """Wrapper of the swa_decode kernels.

    ``self(q, k, v, length, ring_start)`` with q (B, Hq, D), k and v
    (B, S, Hkv, D) and Hq a multiple of Hkv, all on one device; bf16 or
    fp16 inputs are cast to float32, as the JAX package's wrapper casts
    them. ``length`` and ``ring_start`` are (B,) integers (or scalars,
    broadcast over the batch). Returns (B, Hq, D) float32.
    """
    name = "swa_decode"

    def __init__(self):
        self.launches = 0
        self.splits: int | None = None    # split count of the last call
        self._sms: dict[int, int] = {}    # SMs per device index

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
        q, k, v = (t.contiguous() if t.dtype == torch.float32
                   else t.float().contiguous() for t in (q, k, v))
        length, ring_start = (_per_row(x, b, dev)
                              for x in (length, ring_start))
        if not q.is_cuda:
            if dev.type != "cpu":
                raise ValueError(f"unsupported device {dev}")
            return swa_decode_plain(q, k, v, length, ring_start)
        g = hq // hkv
        if rows_per_pass(g, d) == 0:
            raise ValueError(f"head dim {d} is over what a lane's registers "
                             f"hold (512, or 256 when D % 4 != 0)")
        sms = self._sms.get(dev.index)
        if sms is None:
            sms = self._sms[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        splits, chunk = split_plan(b, hkv, g, s, d, sms)
        return self.launch(q, k, v, length, ring_start, splits, chunk)

    def launch(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: torch.Tensor, ring_start: torch.Tensor, splits: int,
               chunk: int) -> torch.Tensor:
        """Launch on contiguous float32 CUDA tensors (int32 ``length`` and
        ``ring_start``) with the ring positions in ``splits`` runs of
        ``chunk`` (splits * chunk >= S)."""
        b, hq, d = q.shape
        _, s, hkv, _ = k.shape
        g = hq // hkv
        passes = -(-g // rows_per_pass(g, d))
        if not 1 <= splits <= MAX_SPLITS or splits * chunk < s:
            raise ValueError(f"{splits} splits of {chunk} do not cover "
                             f"{s} ring slots (at most {MAX_SPLITS} splits)")
        if b > 65535 or hkv * passes > 65535:
            raise ValueError(f"batch {b} or {hkv} kv heads x {passes} "
                             f"passes exceed the grid's 65535")
        lib = _lib()
        out = torch.empty_like(q)
        ws = q.new_empty(b * hq * splits * (d + 2) if splits > 1 else 0)
        idx = q.device.index
        with launch_context(idx):
            rc = lib.swa_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                ring_start.data_ptr(), out.data_ptr(), ws.data_ptr(), b,
                hkv, g, s, d, splits, chunk, 1.0 / float(d) ** 0.5,
                raw_stream(idx))
        if rc != 0:
            raise RuntimeError(f"swa_decode launch failed: "
                               f"{lib.swa_decode_error_string(rc).decode()}")
        self.launches += 1
        self.splits = splits
        return out


swa_decode = SwaDecodeKernel()
