"""Asymmetric expert assignment — Algorithm 1 of the paper (+ alpha/beta).

Decides, per layer, how many experts each expert GPU offloads back to the
attention GPUs: "gather" per-layer bubbles on the attention GPUs across
consecutive layers until at least one chunk (n1 experts per attention GPU /
n2 per expert GPU) can be "squeezed" out.

Units: all o_l are experts offloaded FROM EACH expert GPU (paper output
spec); n_min / n_max bound sum(O) in the same units.

Note on line 4: the paper prints T_squeeze = (T_E^Exp N/n) n1 +
(T_E^Attn N/n) n2, but its own prose defines N*T_E^Exp/n as the time saved
per expert *offloaded by an expert GPU* (n2 per chunk) and N*T_E^Attn/n as
the time added per expert *acquired by an attention GPU* (n1 per chunk). We
implement the prose (n2 with the Exp term, n1 with the Attn term); the two
readings coincide whenever M == N (all of the paper's Asym-EA-active
evaluation ratios are powers of two where both give identical schedules for
M=N, and the divisibility rule makes the difference a constant factor
otherwise).

A copy of the JAX package's ``core/asym_ea.py`` with its imports rewritten
to the port (it imports neither jax nor the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.core.profiler import LayerTimes


@dataclasses.dataclass(frozen=True)
class AsymEAPlan:
    offload: tuple  # o_l per layer: experts offloaded per expert GPU
    n1: int  # experts each attention GPU acquires per chunk
    n2: int  # experts each expert GPU offloads per chunk
    t_gather: float
    t_squeeze: float
    alpha: float
    beta: float

    @property
    def total_offload(self) -> int:
        return sum(self.offload)

    def experts_on_attention(self, layer: int, N: int) -> int:
        """Total experts resident on the attention group for `layer`."""
        return self.offload[layer] * N


def divisibility_ok(M: int, N: int) -> bool:
    """Asym-EA requires M | N or N | M (paper §4.2)."""
    return M % N == 0 or N % M == 0


def asym_ea_offload(
    n: int,
    L: int,
    M: int,
    N: int,
    t_attn: float,
    t_exp_attn: float,
    t_exp: float,
    n_min: int = 0,
    n_max: Optional[int] = None,
    t_comm_exposed: float = 0.0,
) -> AsymEAPlan:
    """Algorithm 1. Times are per-microbatch forward durations.

    n: experts per layer; L: layers; M/N: attention/expert GPUs per ZP group.
    t_attn = T_A^Attn, t_exp_attn = T_E^Attn (one expert FFN on an attention
    GPU), t_exp = T_E^Exp.
    n_min/n_max: bounds on sum(O) in per-expert-GPU units.

    t_comm_exposed: the EXPOSED (not-overlapped) dispatch+combine all-to-all
    residue per microbatch (simulator.exposed_comm). It sits on the expert
    hop's critical path exactly like expert compute, so it joins t_exp in
    the per-layer bubble the attention GPUs gather. With serialized
    dispatch (n_chunks=1) this is the full wire time; with chunked
    double-buffered dispatch most of it hides under expert compute and
    MUST NOT be double-counted here — the planner passes the residue only
    (DESIGN.md §8).
    """
    if not divisibility_ok(M, N):
        raise ValueError(f"Asym-EA needs M|N or N|M, got M={M}, N={N}")
    n1 = max(1, N // M)                      # line 1
    n2 = n1 * M // N                          # line 2
    if n_max is None:
        n_max = n  # at most everything
    n_max = min(n_max, L * (n // N))          # cannot offload more than held

    t_gather = t_exp + t_comm_exposed - t_attn  # line 3 (+ exposed a2a)
    # line 4 (prose form; see module docstring):
    t_squeeze = (t_exp * N / n) * n2 + (t_exp_attn * N / n) * n1

    # Degenerate: no bubbles to squeeze and no memory pressure.
    if t_gather <= 0 and n_min <= 0:
        return AsymEAPlan(tuple([0] * L), n1, n2, t_gather, t_squeeze,
                          1.0, 1.0)
    if t_gather <= 0:
        # Memory-forced offload with no perf bubbles: spread n_min evenly.
        chunks = math.ceil(n_min / n2)
        per = chunks // L
        extra = chunks % L
        O = [(per + (1 if l < extra else 0)) * n2 for l in range(L)]
        return AsymEAPlan(tuple(O), n1, n2, t_gather, t_squeeze, 1.0,
                          float("inf"))

    # alpha/beta memory coefficients (paper, "Addressing memory limitations")
    gatherable = L * t_gather
    alpha = min(((n_max // n2) * t_squeeze) / gatherable, 1.0)
    beta = max((math.ceil(n_min / n2) * t_squeeze) / gatherable, 1.0)

    t_bubble = 0.0                            # line 5
    O: List[int] = []
    per_gpu = n // N  # an expert GPU cannot offload more than it holds
    for _ in range(L):                        # line 6
        t_bubble += alpha * beta * t_gather   # line 7 (modified)
        o_l = 0
        if t_bubble >= t_squeeze:             # line 8
            o_l = int(t_bubble // t_squeeze)  # line 9
            o_l = min(o_l, per_gpu // n2)     # physical per-layer cap
            t_bubble -= o_l * t_squeeze       # line 10
            o_l *= n2                         # line 11
        O.append(o_l)
    # Enforce hard bounds exactly (alpha/beta steer; rounding can overshoot).
    O = _clamp_total(O, n_min, n_max, n2, L)
    return AsymEAPlan(tuple(O), n1, n2, t_gather, t_squeeze, alpha, beta)


def _clamp_total(O: List[int], n_min: int, n_max: int, n2: int,
                 L: int) -> List[int]:
    total = sum(O)
    if total > n_max:
        excess = total - (n_max // n2) * n2
        for l in range(L - 1, -1, -1):
            if excess <= 0:
                break
            take = min(O[l], ((excess + n2 - 1) // n2) * n2)
            O[l] -= take
            excess -= take
    total = sum(O)
    if total < n_min:
        deficit = math.ceil((n_min - total) / n2) * n2
        l = 0
        while deficit > 0:
            O[l % L] += n2
            deficit -= n2
            l += 1
    return O


# ---------------------------------------------------------------------------
# Serving-mode extension: expert placement across a decode group (§11)
# ---------------------------------------------------------------------------

def round_robin_placement(n_experts: int, ep_size: int) -> tuple:
    """Uniform baseline placement: expert e -> shard e % ep_size. Returns
    a tuple of per-shard expert-id tuples with equal cardinality."""
    if ep_size < 1 or n_experts % ep_size:
        raise ValueError(f"ep_size {ep_size} must divide "
                         f"n_experts {n_experts}")
    return tuple(tuple(range(j, n_experts, ep_size))
                 for j in range(ep_size))


def placement_speeds(shard_classes, *, flops_per_byte: float = 0.0) -> tuple:
    """Per-shard service rates for ``asym_ea_place`` from device classes.

    Decode expert service is a roofline: weight reads stream at
    ``hbm_bw``, but the grouped GEMM over the m rows routed to an expert
    only sustains ``peak_flops * gemm_eff``. At arithmetic intensity
    ``flops_per_byte`` (≈ rows per activated expert in the bf16 decode
    regime: 2*m flops per 2 weight bytes), the effective byte rate is
    ``min(hbm_bw, peak_flops * gemm_eff / flops_per_byte)`` — so a
    compute-weak class (low ``gemm_eff * peak_flops``) falls off the
    bandwidth roofline first and should receive fewer hot experts.
    ``flops_per_byte=0`` degenerates to pure HBM bandwidth (the earlier
    memory-bound assumption, kept as the default)."""
    speeds = []
    for c in shard_classes:
        bw = c.hbm_bw
        if flops_per_byte > 0.0:
            bw = min(bw, c.peak_flops * c.gemm_eff / flops_per_byte)
        speeds.append(bw)
    return tuple(speeds)


def asym_ea_place(load, speeds, cap: int) -> tuple:
    """Heterogeneity-aware expert placement: greedy LPT with fixed shard
    cardinality — the serving-mode analogue of Algorithm 1's offload
    sweep. ``load[e]`` is expert e's cost mass (for decode: its expected
    weight-read activation at the target batch), ``speeds[j]`` shard j's
    relative service rate (HBM bandwidth for the weight-read-bound decode
    regime), ``cap`` the exact experts per shard (EP layout needs equal
    shards). Experts are assigned heaviest-first to the feasible shard
    minimizing its resulting finish time (load + l) / speed, which lands
    hot experts on the strong class and cold ones on the weak class."""
    if len(load) != cap * len(speeds):
        raise ValueError(f"{len(load)} experts != {len(speeds)} shards "
                         f"x cap {cap}")
    if any(s <= 0 for s in speeds):
        raise ValueError("speeds must be positive")
    order = sorted(range(len(load)), key=lambda e: (-load[e], e))
    bins = [[] for _ in speeds]
    mass = [0.0] * len(speeds)
    for e in order:
        best, best_t = None, None
        for j, s in enumerate(speeds):
            if len(bins[j]) >= cap:
                continue
            t = (mass[j] + load[e]) / s
            if best_t is None or t < best_t:
                best, best_t = j, t
        bins[best].append(e)
        mass[best] += load[e]
    return tuple(tuple(sorted(b)) for b in bins)


def apply_offload_to_times(times: LayerTimes, offload_l: int, n: int, N: int,
                           M: int) -> tuple:
    """Per-layer durations after offloading o_l experts per expert GPU.

    Returns (t_exp_new, t_attn_extra): expert-GPU time for one microbatch
    and the extra per-microbatch expert work added to each attention GPU.
    """
    t_exp_new = times.t_exp * (1.0 - offload_l * N / n)
    acquired_per_attn = offload_l * N / M
    t_attn_extra = acquired_per_attn * (times.t_exp_attn * N / n)
    return max(t_exp_new, 0.0), t_attn_extra
