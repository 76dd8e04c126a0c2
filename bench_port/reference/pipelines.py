"""Plain PyTorch reference of the eleven ImaGen pipelines.

The benchmark judges every served frame against this file. It imports
nothing of the program: the stage math of the paper's seven spatial
pipelines (Table 3) and of the four temporal ones is written out here,
frame by frame, in the order the program states it (dy-major sums of
scalar taps, one rounding per operation, no fused multiply-add).

Windows are causal: output pixel (r, x) of frame t reads rows r-sh+1..r,
columns x-sw+1..x and frames t-st+1..t of its producer; pixels and
frames before the start read as zero.

``dtype`` is the precision every stage computes in. The configurations
state float32; the lower-precision control computes the same math in
bfloat16 (``CONTROL_DTYPE``) and must fail the comparison.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

CONTROL_DTYPE = torch.bfloat16


def _f32(x: float) -> float:
    return float(np.float32(x))


def gauss1d(n: int) -> np.ndarray:
    x = np.arange(n) - (n - 1) / 2
    g = np.exp(-0.5 * (x / max(n / 4.0, 1.0)) ** 2)
    return (g / g.sum()).astype(np.float32)


SOBEL_X = np.array([[-1.0, 0.0, 1.0]], dtype=np.float32)
SOBEL_Y = SOBEL_X.T
LAPLACE = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
G5H = gauss1d(5)[None, :]
G5V = gauss1d(5)[:, None]
G3 = np.outer(gauss1d(3), gauss1d(3)).astype(np.float32)
XCORR = gauss1d(18)

MAG_EPS = _f32(1e-6)
UNSHARP_K = _f32(1.5)
HARRIS_K = _f32(0.04)
BG_LO = _f32(0.25)


def windows(img: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, sh, sw), bottom-right aligned, zero
    padded."""
    pad = F.pad(img, (sw - 1, 0, sh - 1, 0))
    return pad.unfold(-2, sh, 1).unfold(-2, sw, 1)


def conv(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    sh, sw = taps.shape
    win = windows(img, sh, sw)
    acc = None
    for dy in range(sh):
        for dx in range(sw):
            term = float(taps[dy, dx]) * win[..., dy, dx]
            acc = term if acc is None else acc + term
    return acc


def nms(img: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: the window's centre where it is the
    window's maximum, else 0."""
    win = windows(img, 3, 3)
    center = win[..., 1, 1]
    return torch.where(center >= win.amax(dim=(-2, -1)), center, 0.0)


def thresh(v: torch.Tensor, lo: float) -> torch.Tensor:
    return torch.where(v > _f32(lo), v, 0.0)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in ``x``'s precision (the float64
    root of a float32 or bfloat16 value rounds correctly)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def unsharp(orig: torch.Tensor, blur: torch.Tensor) -> torch.Tensor:
    return orig + UNSHARP_K * (orig - blur)


def harris_resp(v: torch.Tensor) -> torch.Tensor:
    return v - HARRIS_K * v * v


# ----------------------------------------------------- spatial pipelines
def canny_s(x):
    by = conv(conv(x, G5H), G5V)
    gy = conv(conv(by, SOBEL_X), SOBEL_Y)
    return thresh(nms(gy * gy), 0.1)


def canny_m(x):
    by = conv(conv(x, G5H), G5V)
    gx, gy = conv(by, SOBEL_X), conv(by, SOBEL_Y)
    mag = sqrt_rn(gx * gx + gy * gy + MAG_EPS)
    return thresh(nms(nms(mag)), 0.1)


def harris_s(x):
    g = conv(x, SOBEL_X)
    return nms(harris_resp(conv(g * g, G3)))


def harris_m(x):
    ixy = conv(x, SOBEL_X) * conv(x, SOBEL_Y)
    return harris_resp(conv(ixy, G3))


def unsharp_m(x):
    return unsharp(x, conv(conv(x, G5H), G5V))


def xcorr_m(x):
    tall = windows(x, 18, 1)
    corr = None
    for dy, t in enumerate(XCORR):
        term = float(t) * tall[..., dy, 0]
        corr = term if corr is None else corr + term
    return corr - x


def denoise_m(x):
    b = conv(x, G3)
    edge_w = torch.clamp(torch.abs(conv(b, LAPLACE)), 0.0, 1.0)
    return edge_w * x + (1.0 - edge_w) * b


# ---------------------------------------------------- temporal pipelines
# Each takes the stream's frames up to the current one, (T, H, W) with
# the current frame last, and returns the current frame's output.
def _past(video: torch.Tensor, j: int) -> torch.Tensor:
    """The frame j steps before the current one; zero before the start."""
    t = video.shape[0] - 1 - j
    return video[t] if t >= 0 else torch.zeros_like(video[-1])


def stmean(video: torch.Tensor, st: int, sh: int = 1, sw: int = 1):
    """Mean over an (st, sh, sw) box: the sum oldest frame first, then
    rows, then columns, then one multiply by float32(1 / (st sh sw))."""
    k = _f32(1.0 / float(st * sh * sw))
    acc = None
    for j in range(st - 1, -1, -1):
        win = windows(_past(video, j), sh, sw)
        for dy in range(sh):
            for dx in range(sw):
                term = win[..., dy, dx]
                acc = term if acc is None else acc + term
    return acc * k


def tdenoise_t(video):
    return conv(stmean(video, 4), G3)


def tmotion_t(video):
    diff = torch.abs(video[-1] - _past(video, 1))
    return thresh(conv(diff, G3), 0.05)


def tbackground_t(video):
    d = torch.abs(video[-1] - stmean(video, 8))
    return torch.where(d > BG_LO, d, 0.0)


def tunsharp_t(video):
    return unsharp(video[-1], stmean(video, 3, 3, 3))


SPATIAL: dict[str, Callable] = {
    "canny-s": canny_s, "canny-m": canny_m, "harris-s": harris_s,
    "harris-m": harris_m, "unsharp-m": unsharp_m, "xcorr-m": xcorr_m,
    "denoise-m": denoise_m,
}
TEMPORAL: dict[str, Callable] = {
    "tdenoise-t": tdenoise_t, "tmotion-t": tmotion_t,
    "tbackground-t": tbackground_t, "tunsharp-t": tunsharp_t,
}
# frames of history (the current one included) each temporal pipeline's
# output reads
DEPTH = {"tdenoise-t": 4, "tmotion-t": 2, "tbackground-t": 8,
         "tunsharp-t": 3}


def history_depth(pipeline: str) -> int:
    """How many of a stream's frames, the current one included, one
    output depends on (1 for a spatial pipeline)."""
    if pipeline in SPATIAL:
        return 1
    return DEPTH[pipeline]


def run(pipeline: str, frames: torch.Tensor,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The output of the last of ``frames`` ((T, H, W), oldest first,
    float32; earlier frames than these read as zero), computed in
    ``dtype`` and returned as float32."""
    frames = frames.to(dtype)
    if pipeline in SPATIAL:
        out = SPATIAL[pipeline](frames[-1])
    else:
        out = TEMPORAL[pipeline](frames[-DEPTH[pipeline]:])
    return out.to(torch.float32)
