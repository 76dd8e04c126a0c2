"""Eager PyTorch oracles for the port's kernels.

``stencil_pipeline_ref`` is the fused stencil kernel's plain version:
whole images, stage by stage, through the torch ``execute_reference``.
"""
from .stencil_pipeline import stencil_pipeline_plain as stencil_pipeline_ref

__all__ = ["stencil_pipeline_ref"]
