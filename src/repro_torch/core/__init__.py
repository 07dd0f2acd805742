"""HeterMoE core of the port (mirror of ``repro/core``).

  zebra_spmd — zebra parallelism's single-program engine: the expert-
               parallel MoE FFN over capacity-packed buffers and the
               layer override that overlaps attention of microbatch k with
               the experts of microbatch k-1 on two CUDA streams

The reference's planner, simulator, Asym-EA and MPMD engine are not
ported yet.
"""

from repro_torch.core import zebra_spmd

__all__ = ["zebra_spmd"]
