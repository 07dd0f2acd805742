"""Hand-written CUDA kernels (flash attention forward and backward, grouped
expert GEMMs and their weight gradient, paged decode attention, the mamba2
SSD chunk scan).

Each kernel has a plain-torch version beside its wrapper, taken for CPU
tensors; :mod:`repro_torch.kernels.ref` holds the oracles and
:mod:`repro_torch.kernels.ops` the wrappers the model calls. Kernels are
compiled by :mod:`repro_torch.kernels._build` at first launch.
"""

from repro_torch.kernels import (flash_attention, gmm, ops, paged_attention,
                                 ref, ssd)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {**gmm.LAUNCHES, **paged_attention.LAUNCHES,
            **flash_attention.LAUNCHES, **ssd.LAUNCHES}


def variant_launch_counts() -> dict:
    """The grouped GEMM launches of :func:`launch_counts` split by operand
    types (``"gmm:f32.bf16T->f32"``, ``"gmm_dw:bf16.f32->f32"``, ...)."""
    return dict(gmm.VARIANT_LAUNCHES)


def design_launch_counts() -> dict:
    """The ``gmm_tiled``, fused GLU, ``gmm_dw_tiled``, flash and SSD scan
    launches of :func:`launch_counts` split by the design that ran them:
    ``"gmm:wgmma"`` / ``"gmm_glu:wgmma"`` / ``"gmm_dw:wgmma"`` /
    ``"flash_fwd:wgmma"`` / ``"ssd:wgmma"`` (tensor cores) or ``":fma"``,
    each counted where it launches."""
    return {**gmm.DESIGN_LAUNCHES, **flash_attention.DESIGN_LAUNCHES,
            **ssd.DESIGN_LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (gmm.LAUNCHES, gmm.DESIGN_LAUNCHES,
                   paged_attention.LAUNCHES, flash_attention.LAUNCHES,
                   flash_attention.DESIGN_LAUNCHES, ssd.LAUNCHES,
                   ssd.DESIGN_LAUNCHES):
        for name in counts:
            counts[name] = 0
    gmm._reset_variants()


__all__ = ["ops", "ref", "launch_counts", "reset_launch_counts",
           "variant_launch_counts", "design_launch_counts"]
