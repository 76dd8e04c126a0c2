"""The frame pool: distinct frames made from the seed on the device, a
few at a time, and kept in pageable host memory."""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 8


def make_pool(n: int, h: int, w: int, seed: int, device: torch.device):
    """``n`` uniform [0, 1) float32 frames of (h, w), a list of (h, w)
    numpy arrays in pageable host memory. The same seed gives the same
    pixels."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 64)
    host = np.empty((n, h, w), dtype=np.float32)
    for i in range(0, n, CHUNK):
        # a few frames at a time, so the card holds little of the pool
        m = min(CHUNK, n - i)
        host[i:i + m] = torch.rand((m, h, w), generator=g, device=device,
                                   dtype=torch.float32).cpu().numpy()
    return [host[i] for i in range(n)]


def as_tensor(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """A pool frame as a float32 tensor on ``device`` (the reference's
    copy of what the program was given)."""
    return torch.from_numpy(frame).to(device)
