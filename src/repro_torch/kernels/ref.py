"""Eager PyTorch oracles for the port's kernels.

``stencil_pipeline_ref`` is the fused stencil kernel's plain version:
whole images, stage by stage, through the torch ``execute_reference``.
``video_pipeline_ref`` is the whole-stream oracle of temporal pipelines.
``conv2d_ref`` is the conv2d kernel's plain version; ``swa_decode_ref``
is the JAX package's attention oracle in torch (its softmax gives NaN
where every slot is masked; the kernel and its plain version give 0).
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.algorithms import execute_reference_video
from repro_torch.core.dag import PipelineDAG

from .conv2d_stencil import conv2d_plain as conv2d_ref
from .stencil_pipeline import stencil_pipeline_plain as stencil_pipeline_ref
from .swa_decode import ring_valid


def video_pipeline_ref(dag: PipelineDAG, videos: Mapping) -> torch.Tensor:
    """Whole-stream reference for temporal pipelines: {input: (T, H, W)}
    -> (T, H, W), frames before t = 0 reading as zero (warm-up)."""
    return execute_reference_video(dag, videos)


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length, ring_start=0) -> torch.Tensor:
    """Sliding-window decode attention over a ring KV cache.

    q: (B, Hq, D); k, v: (B, S, Hkv, D) ring buffers where only the
    ``length`` most recent entries are valid; ``ring_start`` is the ring
    offset of the oldest valid entry. Hq % Hkv == 0 (GQA).
    Returns (B, Hq, D).
    """
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    qg = q.reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k) / float(d) ** 0.5
    length = torch.as_tensor(length, device=q.device).expand(b)
    ring_start = torch.as_tensor(ring_start, device=q.device).expand(b)
    valid = ring_valid(length, ring_start, s)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v).reshape(b, hq, d)


__all__ = ["conv2d_ref", "stencil_pipeline_ref", "swa_decode_ref",
           "video_pipeline_ref"]
