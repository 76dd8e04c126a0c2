"""Eager PyTorch oracles for the port's kernels.

``stencil_pipeline_ref`` is the fused stencil kernel's plain version:
whole images, stage by stage, through the torch ``execute_reference``.
``video_pipeline_ref`` is the whole-stream oracle of temporal pipelines.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.algorithms import execute_reference_video
from repro_torch.core.dag import PipelineDAG

from .stencil_pipeline import stencil_pipeline_plain as stencil_pipeline_ref


def video_pipeline_ref(dag: PipelineDAG, videos: Mapping) -> torch.Tensor:
    """Whole-stream reference for temporal pipelines: {input: (T, H, W)}
    -> (T, H, W), frames before t = 0 reading as zero (warm-up)."""
    return execute_reference_video(dag, videos)


__all__ = ["stencil_pipeline_ref", "video_pipeline_ref"]
