"""The dry run's collective tally and three-term roofline (mirror of
``repro/launch/hlo_analysis.py``).

PyTorch has no HLO to parse: the collectives come from the calls one
rank's step makes into ``torch.distributed``, counted where they reach
it by ``launch/mesh_comm.py``'s ``Counter`` (one counter for both
tools). :func:`collective_bytes` sorts them into the JAX package's
buckets with its per-kind formulas. :class:`Roofline` is the JAX
package's, at the H100's peaks (``core/hardware.py``): a collective term
runs at the slowest link a group of the mesh crosses
(:func:`slowest_link`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import hardware as HW
from repro_torch.sharding.rules import coords

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# mesh_comm.Counter's kinds (torch.distributed calls) -> the JAX buckets;
# a point-to-point message is XLA's collective-permute, and so is a
# broadcast from one rank.
KIND_OF = {"all_gather": "all-gather", "all_reduce": "all-reduce",
           "reduce_scatter": "reduce-scatter",
           "all_to_all_single": "all-to-all",
           "isend": "collective-permute", "irecv": "collective-permute",
           "broadcast": "collective-permute"}


def collective_bytes(counts: dict) -> Dict[str, int]:
    """Per-device collective traffic by JAX bucket, from
    ``mesh_comm.Counter.counts`` ({kind: {"calls", "bytes",
    "operand_bytes", "ring_bytes"}}).

    Two aggregates, as in the JAX package:
      total      — sum of operand sizes: an all-gather's operand is its
                   input piece, a reduce-scatter's its whole input, every
                   other call's its tensor.
      ring_total — ring-algorithm wire bytes per device: all-reduce
                   2·X·(g-1)/g, all-gather / reduce-scatter X·(g-1)/g on
                   the FULL tensor X, all-to-all X·(g-1)/g, a sent
                   message X.
    """
    out = {k: 0 for k in COLLECTIVE_OPS}
    ring = 0
    for kind, c in counts.items():
        out[KIND_OF[kind]] += c["operand_bytes"]
        ring += c["ring_bytes"]
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    out["ring_total"] = ring
    return out


def slowest_link(mesh) -> float:
    """Bytes/s a direction of the slowest link any group of ``mesh``'s
    axes crosses: NVLink when every group lies in one node of
    ``HW.H100_NODE_GPUS`` consecutive ranks, else the network."""
    for axis in mesh.axis_names:
        if mesh.shape[axis] == 1:
            continue
        nodes = {r // HW.H100_NODE_GPUS for r in range(mesh.size)
                 if all(v == 0 for a, v in coords(mesh, r).items()
                        if a != axis)}
        if len(nodes) > 1:
            return HW.H100_NET_BW
    return HW.H100_NVLINK_BW


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one (arch x shape x mesh) cell."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int
    model_flops: float  # 6*N_active*D analytical

    peak_flops: float = HW.H100_PEAK_FLOPS
    hbm_bw: float = HW.H100_HBM_BW
    link_bw: float = HW.H100_NET_BW  # the slowest link a group crosses

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.link_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap model: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the compute is
        'useful' (catches remat / capacity-padding / dispatch waste)."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline lower bound."""
        denom = (self.step_time_lower_bound * self.n_devices
                 * self.peak_flops)
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "useful_flops_frac": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
        }
