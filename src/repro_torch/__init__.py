"""ImaGen on PyTorch and CUDA: the frame-serving path on an NVIDIA Hopper GPU.

A second package beside the JAX reference (``src/repro/``), with the same
layout so each module's counterpart is found by path:

  * :mod:`core <repro_torch.core>` — the planner (DSL -> DAG -> ILP schedule
    -> line-buffer allocation -> simulator check -> ``PipelinePlan``) and
    the seven spatial pipelines of the paper's Tbl. 3 with their payloads;
  * :mod:`kernels <repro_torch.kernels>` — the fused line-buffered stencil
    kernel (CUDA C++ for ``sm_90a``), its plain PyTorch version, the
    executor factory and ``fused_pipeline``;
  * :mod:`imaging <repro_torch.imaging>` — ``PlanCache``, tiling and the
    batching ``FrameEngine``;
  * :mod:`serve <repro_torch.serve>`, :mod:`obs <repro_torch.obs>`,
    :mod:`resilience <repro_torch.resilience>` — the scheduling,
    tracing/metrics and outcome types the engine is built on.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU the kernel's plain version runs instead.
"""
