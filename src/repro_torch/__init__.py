"""ImaGen on PyTorch and CUDA: frame, video and LM serving on an NVIDIA Hopper
GPU.

A second package beside the JAX reference (``src/repro/``), with the same
layout so each module's counterpart is found by path:

  * :mod:`core <repro_torch.core>` — the planner (DSL -> DAG -> ILP schedule
    -> line-buffer allocation -> simulator check -> ``PipelinePlan``), the
    autotuner and baselines, and the seven spatial and four video
    pipelines with their payloads;
  * :mod:`kernels <repro_torch.kernels>` — the fused line-buffered stencil
    kernel (CUDA C++ for ``sm_90a``, spatial and temporal), its plain
    PyTorch versions, the executor factories and ``fused_pipeline``;
  * :mod:`imaging <repro_torch.imaging>` — ``PlanCache``, tiling and the
    batching ``FrameEngine``;
  * :mod:`video <repro_torch.video>` — the streaming ``VideoEngine``;
  * :mod:`obs <repro_torch.obs>`, :mod:`resilience
    <repro_torch.resilience>`, :mod:`perf <repro_torch.perf>` — tracing
    and metrics, resilient serving, the perf lab;
  * :mod:`models <repro_torch.models>`, :mod:`configs
    <repro_torch.configs>` — the LM zoo (10 architectures: full-sequence
    forward and one-token decode);
  * :mod:`serve <repro_torch.serve>`, :mod:`launch <repro_torch.launch>`
    — the scheduling primitives, the ImaGen-planned KV planner, the
    slot-based LM ``Engine`` and its serving CLI.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU the kernel's plain version runs instead.
"""
