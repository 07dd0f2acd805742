"""ZP-group planning: profile -> Asym-EA -> simulate -> pick.

The Optimizer box of the paper's Fig. 3: given a ZP group (M attention
devices of one class, N expert devices of another), a model and batch
geometry, it produces a `ZebraPlan` — microbatch count, per-layer Asym-EA
offloads, and the predicted iteration time / utilizations — by running
Algorithm 1 on profiler outputs and validating candidates in the simulator.
Also provides the elastic replanning entry point of the fault-tolerance
modules (``ft/elastic.py``).

A copy of the JAX package's ``core/planner.py`` with its imports rewritten
to the port, less ``FleetPlan`` / ``plan_fleet``: they need the serving
fleet's simulator (``serve/fleet/sim.py``), which the port does not have
yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core import profiler as P
from repro_torch.core import simulator as sim
from repro_torch.core.asym_ea import (AsymEAPlan, asym_ea_offload,
                                      divisibility_ok)
from repro_torch.core.hardware import DeviceClass
from repro_torch.core.profiler import LayerTimes, ZPGroupShape
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ZebraPlan:
    zp: ZPGroupShape
    R: int
    offload: tuple
    times: LayerTimes
    comm: sim.CommTimes
    predicted: sim.SimResult
    predicted_no_asym: sim.SimResult
    n_min: int
    n_max: int
    n_chunks: int = 1  # dispatch chunking the prediction was priced at

    @property
    def tokens_per_iter(self) -> int:
        return self._tokens

    def throughput(self, global_batch: int, seq_len: int) -> float:
        return global_batch * seq_len / self.predicted.iter_time


def plan_zp_group(cfg: ModelConfig, zp: ZPGroupShape, global_batch: int,
                  seq_len: int, R: Optional[int] = None,
                  candidates: Sequence[int] = (2, 4, 8, 16),
                  use_asym: bool = True, n_chunks: Optional[int] = None,
                  chunk_candidates: Sequence[int] = (1, 2, 4)) -> ZebraPlan:
    """Pick (R, n_chunks, offload) minimizing simulated iteration time.

    Dispatch chunking is priced through the overlap-aware cost model: the
    link streams carry only the EXPOSED all-to-all residue (DESIGN.md §8),
    and the same residue — not the full wire time — feeds Algorithm 1's
    bubble estimate so Asym-EA no longer offloads experts to pay for
    communication that chunking already hid."""
    best = None
    rs = [R] if R else [r for r in candidates if global_batch % r == 0] or [1]
    qs = [n_chunks] if n_chunks else list(chunk_candidates) or [1]
    link_bw = min(zp.attn_class.link_bw, zp.exp_class.link_bw)
    for r in rs:
        times = P.profile_layer(cfg, zp, global_batch, seq_len, r,
                                link_bw=link_bw)
        # The overlap-aware LayerTimes is the single source of the a2a
        # wire times; CommTimes is just its simulator-facing view.
        comm = sim.CommTimes(dispatch=times.t_dispatch,
                             combine=times.t_combine)
        n_min, n_max = P.asym_ea_memory_bounds(cfg, zp, global_batch,
                                               seq_len, r)
        # express n_max in per-expert-GPU units (sum(O) bound; see asym_ea)
        n_max_units = n_max // max(zp.N, 1)
        for q in qs:
            no_asym = sim.simulate_hetermoe(cfg, times, comm, r, zp.M, zp.N,
                                            n_chunks=q)
            chosen = no_asym
            offload = tuple([0] * cfg.n_layers)
            if use_asym and cfg.is_moe and divisibility_ok(zp.M, zp.N):
                exposed = (sim.exposed_comm(comm.dispatch, times.t_exp, q)
                           + sim.exposed_comm(comm.combine, times.t_exp, q))
                try:
                    plan = asym_ea_offload(
                        cfg.n_experts, cfg.n_layers, zp.M, zp.N,
                        t_attn=times.t_attn, t_exp_attn=times.t_exp_attn,
                        t_exp=times.t_exp, n_min=n_min // max(zp.N, 1),
                        n_max=n_max_units, t_comm_exposed=exposed)
                    with_asym = sim.simulate_hetermoe(cfg, times, comm, r,
                                                      zp.M, zp.N, plan,
                                                      n_chunks=q)
                    if with_asym.iter_time < chosen.iter_time:
                        chosen = with_asym
                        offload = plan.offload
                except ValueError:
                    pass
            zp_plan = ZebraPlan(zp=zp, R=r, offload=offload, times=times,
                                comm=comm, predicted=chosen,
                                predicted_no_asym=no_asym, n_min=n_min,
                                n_max=n_max, n_chunks=q)
            if best is None or chosen.iter_time < best.predicted.iter_time:
                best = zp_plan
    return best


def sweep_ratios(cfg: ModelConfig, attn_class: DeviceClass,
                 exp_class: DeviceClass, M: int, Ns: Sequence[int],
                 global_batch: int, seq_len: int,
                 n_chunks: Optional[int] = None):
    """Fig. 10: HeterMoE throughput vs expert-GPU count at fixed M.
    Pass n_chunks=1 for the paper-faithful serialized-dispatch model."""
    out = {}
    for N in Ns:
        zp = ZPGroupShape(M=M, N=N, attn_class=attn_class,
                          exp_class=exp_class)
        out[N] = plan_zp_group(cfg, zp, global_batch, seq_len,
                               n_chunks=n_chunks)
    return out


# ---------------------------------------------------------------------------
# Disaggregated-serving planning (DESIGN.md §10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DisaggPlan:
    """Role assignment for a heterogeneous serving group: which devices
    prefill and which decode, plus the simulated evidence for the pick."""

    zp: ZPGroupShape
    prefill_attn: int   # attention-class devices assigned to prefill
    prefill_exp: int    # expert-class devices assigned to prefill
    profile: P.ServeProfile
    predicted: sim.ServeSimResult
    predicted_unified: sim.ServeSimResult
    expected_hit_ratio: float = 0.0  # prefix-cache discount the plan assumed

    @property
    def decode_attn(self) -> int:
        return self.zp.M - self.prefill_attn

    @property
    def decode_exp(self) -> int:
        return self.zp.N - self.prefill_exp

    @property
    def goodput_ratio(self) -> float:
        u = self.predicted_unified.goodput
        return self.predicted.goodput / u if u > 0 else float("inf")

    @property
    def ttft_ratio(self) -> float:
        d = self.predicted.ttft_p50
        return self.predicted_unified.ttft_p50 / d if d > 0 else float("inf")


def plan_disagg_group(cfg: ModelConfig, zp: ZPGroupShape, trace, *,
                      prefill_chunk: int = 256, ctx: int = 2048,
                      slots_per_device: int = 8,
                      page_size: int = 16,
                      expected_hit_ratio: float = 0.0) -> DisaggPlan:
    """Pick the prefill:decode device split maximizing simulated goodput —
    the serving analogue of Asym-EA's offload sweep (same shape: profile
    both classes on both roles, sweep assignments, validate candidates in
    the simulator, keep the best).

    ``trace`` is a list of :class:`~repro_torch.core.simulator.ServeRequest`.
    The unified baseline runs the whole mixed group as ONE lockstep
    data-parallel engine (slowest class paces both phases); disagg
    candidates assign ``a`` attention-class + ``e`` expert-class devices
    to prefill (that many parallel batch-1 streams) and the rest to
    decode, paying the page-handoff wire time per migrated request.

    ``expected_hit_ratio`` (in [0, 1)) is the anticipated prefix-cache hit
    fraction, e.g. a measured ``PrefixCache`` hit rate from a prior run or
    the deployment's known prompt-template overlap. Cache-hit tokens skip
    prefill compute entirely (the disagg engine's cached-admit path even
    skips the page handoff for them), so the prefill leg — chunk time AND
    handoff volume — is discounted by ``1 - hit`` while the decode leg is
    untouched; a high-hit workload therefore plans fewer prefill devices
    and banks the freed devices as decode slots."""
    if not 0.0 <= expected_hit_ratio < 1.0:
        raise ValueError(f"expected_hit_ratio must be in [0, 1), "
                         f"got {expected_hit_ratio}")
    prof = P.serve_profile(cfg, zp.attn_class, zp.exp_class,
                           chunk=prefill_chunk, ctx=ctx,
                           decode_batch=slots_per_device,
                           page_size=page_size)
    discount = 1.0 - expected_hit_ratio
    avg_prompt = sum(r.prompt for r in trace) / max(len(trace), 1)
    t_handoff = -(-avg_prompt // page_size) * prof.t_page * discount

    unified = sim.simulate_serve_trace(
        trace, prefill_chunk=prefill_chunk,
        t_prefill_chunk=max(prof.t_prefill_chunk_attn,
                            prof.t_prefill_chunk_exp) * discount,
        t_decode_step=max(prof.t_decode_step_attn, prof.t_decode_step_exp),
        decode_slots=slots_per_device * (zp.M + zp.N), colocated=True)

    best = None
    for a in range(zp.M + 1):
        for e in range(zp.N + 1):
            n_pre, n_dec = a + e, (zp.M - a) + (zp.N - e)
            if n_pre < 1 or n_dec < 1:
                continue
            t_chunk = max([prof.t_prefill_chunk_attn] * (a > 0) +
                          [prof.t_prefill_chunk_exp] * (e > 0)) * discount
            t_step = max([prof.t_decode_step_attn] * (zp.M - a > 0) +
                         [prof.t_decode_step_exp] * (zp.N - e > 0))
            res = sim.simulate_serve_trace(
                trace, prefill_chunk=prefill_chunk, t_prefill_chunk=t_chunk,
                t_decode_step=t_step,
                decode_slots=slots_per_device * n_dec,
                n_prefill_streams=n_pre, t_handoff=t_handoff)
            cand = DisaggPlan(zp=zp, prefill_attn=a, prefill_exp=e,
                              profile=prof, predicted=res,
                              predicted_unified=unified,
                              expected_hit_ratio=expected_hit_ratio)
            if best is None or res.goodput > best.predicted.goodput \
                    or (res.goodput == best.predicted.goodput
                        and res.ttft_p50 < best.predicted.ttft_p50):
                best = cand
    return best


# ---------------------------------------------------------------------------
# EP decode-group placement planning (DESIGN.md §11)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EPDecodePlan:
    """Heterogeneity-aware expert placement for an EP-sharded decode
    group: which experts live on which device, plus the analytical and
    simulated evidence for the pick."""

    shard_classes: tuple
    hist: tuple
    placement: tuple          # asym_ea_place under the routing histogram
    uniform: tuple            # round-robin baseline
    t_step_planned: float
    t_step_uniform: float
    predicted: sim.ServeSimResult          # trace under planned placement
    predicted_uniform: sim.ServeSimResult  # same trace, round-robin
    expert_bytes_total: int
    expert_bytes_per_device: int

    @property
    def ep_size(self) -> int:
        return len(self.shard_classes)

    @property
    def placement_ratio(self) -> float:
        """Uniform / planned decode-step time (>1: planning won)."""
        return self.t_step_uniform / self.t_step_planned \
            if self.t_step_planned > 0 else float("inf")

    @property
    def placement_ratio_sim(self) -> float:
        """Uniform / planned simulated trace makespan (>1: planning won)."""
        p = self.predicted.makespan
        return self.predicted_uniform.makespan / p if p > 0 else float("inf")

    @property
    def hbm_reduction(self) -> float:
        """Replicated / per-device expert-weight residency (~ep_size)."""
        return self.expert_bytes_total / max(self.expert_bytes_per_device, 1)


def plan_ep_decode_group(cfg: ModelConfig, shard_classes: Sequence,
                         hist: Sequence[float], trace, *,
                         decode_batch: int = 8, ctx: int = 2048,
                         prefill_chunk: int = 256, n_chunks: int = 1,
                         link_bw: Optional[float] = None) -> EPDecodePlan:
    """Asym-EA for serving (DESIGN.md §11): place experts across a
    heterogeneous decode group under an observed routing histogram.

    Decode is weight-read bound, so an expert's load is its probability of
    being ACTIVATED by a batched step — ``1-(1-p_e)^(B*k)`` — and a shard's
    speed for that load is its class's HBM bandwidth. Greedy LPT
    (asym_ea_place) sends hot experts to the high-bandwidth class; the
    round-robin baseline and the planned placement are then priced by
    ``profiler.ep_decode_step_time`` and replayed through
    ``simulate_serve_trace`` on the same trace, so ``placement_ratio_sim``
    carries end-to-end (not just per-step) evidence."""
    from repro_torch.core.asym_ea import (asym_ea_place, placement_speeds,
                                    round_robin_placement)
    if not cfg.is_moe:
        raise ValueError("EP decode planning needs a MoE config")
    ep_size = len(shard_classes)
    if ep_size < 1 or cfg.n_experts % ep_size:
        raise ValueError(
            f"ep_size={ep_size} must divide n_experts={cfg.n_experts}")
    tot = sum(hist) or 1.0
    p = [x / tot for x in hist]
    bk = decode_batch * max(cfg.top_k, 1)
    loads = [1.0 - (1.0 - pe) ** bk for pe in p]
    # Arithmetic intensity of one expert's GEMM ≈ rows per ACTIVATED expert
    # (bf16: 2*m flops per 2 weight bytes → flops/byte = m). At realistic
    # decode batches this stays far left of the roofline knee, so speeds
    # reduce to HBM bandwidth — but a compute-weak class (gemm_eff) now
    # caps out honestly instead of being priced at full bandwidth.
    fpb = bk / max(sum(loads), 1e-9)
    placement = asym_ea_place(loads,
                              placement_speeds(shard_classes,
                                               flops_per_byte=fpb),
                              cfg.n_experts // ep_size)
    uniform = round_robin_placement(cfg.n_experts, ep_size)

    def step_time(pl):
        return P.ep_decode_step_time(cfg, decode_batch, ctx, pl,
                                     shard_classes, p, n_chunks=n_chunks,
                                     link_bw=link_bw)

    t_planned, t_uniform = step_time(placement), step_time(uniform)
    # Shared prefill clock: both deployments prefill identically (EP only
    # reshapes the decode-time expert hop), so any consistent chunk time
    # keeps the simulated comparison placement-only.
    t_chunk = max(P.prefill_chunk_time(cfg, prefill_chunk, ctx, c)
                  for c in shard_classes)

    def replay(t_step):
        return sim.simulate_serve_trace(
            trace, prefill_chunk=prefill_chunk, t_prefill_chunk=t_chunk,
            t_decode_step=t_step, decode_slots=decode_batch, colocated=True)

    total = P.expert_param_bytes(cfg)
    return EPDecodePlan(
        shard_classes=tuple(shard_classes), hist=tuple(p),
        placement=placement, uniform=uniform,
        t_step_planned=t_planned, t_step_uniform=t_uniform,
        predicted=replay(t_planned), predicted_uniform=replay(t_uniform),
        expert_bytes_total=total,
        expert_bytes_per_device=-(-total // ep_size))


def replan(cfg: ModelConfig, plan: ZebraPlan, global_batch: int,
           seq_len: int, *, lost_attn: int = 0, lost_exp: int = 0,
           slow_factor: float = 1.0) -> ZebraPlan:
    """Elastic / straggler replanning (``ft/``): recompute the ZP plan for
    a shrunken group or a slowed expert class (straggler mitigation via
    expert re-placement — the same Asym-EA mechanism that balances
    generations also rebalances around degraded devices)."""
    exp_class = plan.zp.exp_class
    if slow_factor != 1.0:
        exp_class = dataclasses.replace(
            exp_class, name=exp_class.name + "-degraded",
            peak_flops=exp_class.peak_flops / slow_factor,
            hbm_bw=exp_class.hbm_bw / slow_factor)
    M = plan.zp.M - lost_attn
    N = plan.zp.N - lost_exp
    if M < 1 or N < 1:
        raise RuntimeError("ZP group no longer viable; trigger full restart")
    zp = ZPGroupShape(M=M, N=N, attn_class=plan.zp.attn_class,
                      exp_class=exp_class)
    # Keep the original plan's dispatch-chunking cost model so degraded
    # predictions stay comparable to the baseline they replace.
    return plan_zp_group(cfg, zp, global_batch, seq_len,
                         n_chunks=plan.n_chunks)
