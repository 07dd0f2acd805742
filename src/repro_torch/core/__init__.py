"""HeterMoE core of the port (mirror of ``repro/core``).

  asym_ea    — Algorithm 1 (gather-and-squeeze) + alpha/beta memory bounds
  schedule   — Theorem 1 task ordering + dependency model
  simulator  — discrete-event simulator (paper §6.4.1 fn.2) + baselines
  hardware   — device-class models calibrated to the paper's Fig. 2
  profiler   — analytical stand-in for the §5 profiler
  planner    — ZP-group planning / elastic replanning
  zebra_spmd — single-program engine: the expert-parallel MoE FFN over
               capacity-packed buffers and the layer override that
               overlaps attention of microbatch k with the experts of
               microbatch k-1 on two CUDA streams
  zebra_mpmd — the two-group disaggregation engine, walking Theorem 1's
               schedule with a CUDA stream per expert lane

The six planning modules are host-side copies of the JAX package's, their
imports rewritten to the port.
"""

from repro_torch.core import (asym_ea, hardware, planner, profiler, schedule,
                              simulator, zebra_mpmd, zebra_spmd)

__all__ = ["asym_ea", "hardware", "planner", "profiler", "schedule",
           "simulator", "zebra_mpmd", "zebra_spmd"]
