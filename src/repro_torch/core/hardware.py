"""Device-class models for the analytical profiler and simulator.

The container has no heterogeneous hardware, so the paper's profiler (§5) is
replaced by an analytical model per device class. The GPU classes carry
efficiency constants calibrated so the model reproduces the paper's Fig. 2
measurements (see tests/test_hardware_model.py):

  * A40 / V100 (Fig. 2a): experts — V100 ~80% of A40; attention — gap grows
    from ~1.7-2x at 4K to 3.7x at 64K (V100 lacks FlashAttention: its
    attention core runs at unfused-kernel efficiency).
  * L40S / T4 (Fig. 2b): MLP 7.0x; attention 9.9x @4K -> 13.6x @64K.

TPU classes use the brief's v5e constants (197 TFLOP/s bf16, 819 GB/s HBM,
~50 GB/s/link ICI); v5e plays the "new generation" role and v3 (no usable
fused attention path in this framing) plays the "old generation" role in the
heterogeneous multi-pod scenario.

A copy of the JAX package's ``core/hardware.py`` with its imports rewritten
to the port (it imports neither jax nor the JAX package).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    name: str
    peak_flops: float          # fp16/bf16 tensor peak, FLOP/s
    hbm_bw: float              # bytes/s
    mem_bytes: float
    has_flash_attention: bool
    gemm_eff: float            # achieved fraction of peak on large GEMMs
    attn_eff: float            # achieved fraction of peak on fused attention
    attn_eff_nofa: float       # achieved fraction on unfused attention core
    link_bw: float = 12.5e9    # bytes/s per direction to the ZP-group fabric


# GPU classes (paper's testbeds) ------------------------------------------------
V100 = DeviceClass("v100", 125e12, 900e9, 16e9, False, 0.43, 0.0, 0.118)
A40 = DeviceClass("a40", 149.7e12, 696e9, 48e9, True, 0.45, 0.40, 0.18)
T4 = DeviceClass("t4", 65e12, 300e9, 16e9, False, 0.35, 0.0, 0.155)
L40S = DeviceClass("l40s", 362e12, 864e9, 48e9, True, 0.45, 0.40, 0.18)
A100 = DeviceClass("a100", 312e12, 2039e9, 80e9, True, 0.47, 0.42, 0.20)

# TPU classes ----------------------------------------------------------------
TPU_V5E = DeviceClass("tpu-v5e", 197e12, 819e9, 16e9, True, 0.55, 0.45, 0.20,
                      link_bw=50e9)
TPU_V4 = DeviceClass("tpu-v4", 275e12, 1228e9, 32e9, True, 0.55, 0.45, 0.20,
                     link_bw=50e9)
TPU_V3 = DeviceClass("tpu-v3", 123e12, 900e9, 32e9, False, 0.50, 0.0, 0.14,
                     link_bw=35e9)

CLASSES = {c.name: c for c in
           [V100, A40, T4, L40S, A100, TPU_V5E, TPU_V4, TPU_V3]}

# The port's target card, the H100 SXM, for the dry run's roofline
# (``launch/hlo_analysis.py``): the datasheet's figures, not measurements.
H100_PEAK_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12      # HBM3, bytes/s
H100_NVLINK_BW = 450e9     # NVLink 4, bytes/s a direction per GPU, in a node
H100_NET_BW = 50e9         # one 400 Gb/s NDR NIC per GPU, bytes/s a direction
H100_NODE_GPUS = 8         # GPUs a node joins by NVLink
# torch.cuda.get_device_properties(0).total_memory on the port's card,
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name, power limit).
H100_MEMORY_BYTES = 85_017_493_504


def get(name: str) -> DeviceClass:
    return CLASSES[name]
