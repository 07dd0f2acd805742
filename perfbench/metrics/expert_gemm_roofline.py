"""expert_gemm_roofline: the least time the expert GEMMs' work needs
(``perfbench.flops.expert_gemm_work`` over the copies the routing kept, at
the H100's bf16 peak or HBM bandwidth), as a share of the summed device
time of the port's grouped-GEMM kernels of every design."""

from perfbench import flops
from perfbench import trace as T


def read(t):
    k_us = t.family_us(T.EXPERT_GEMM)
    if k_us <= 0 or not t.steps:
        return None
    m, tokens = t.info["model"], t.info["batch"] * t.info["seq"]
    stats = t.info.get("zebra")
    kept = 1.0 - stats["dropped_share"] if stats else 1.0
    work = flops.expert_gemm_work(m, tokens * m.top_k * kept)
    return 100.0 * flops.least_seconds(*work) * t.steps / (k_us / 1e6)
