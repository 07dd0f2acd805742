"""flash_roofline: the least time causal attention's work needs
(``perfbench.flops.flash_work``), as a share of the device time of the
port's flash kernels (forward, its recompute, dq, dk / dv)."""

from perfbench import flops
from perfbench import trace as T


def read(t):
    k_us = t.family_us(T.FLASH)
    if k_us <= 0 or not t.steps:
        return None
    work = flops.flash_work(t.info["model"], t.info["batch"], t.info["seq"])
    return 100.0 * flops.least_seconds(*work) * t.steps / (k_us / 1e6)
