"""Discrete-event simulator of heterogeneous MoE training schedules.

This is the paper's own methodology made explicit: HeterMoE ships a
simulator "to estimate the training throughput under different ZP group
setups" (§6.4.1 fn.2). Ours simulates the zebra schedule (and the EP /
DistEP / EP-Ideal / heterogeneity-aware-PP baselines) from per-task
durations supplied by the analytical profiler, and is what the fig7..fig12
benchmarks run.

Semantics: tasks execute on four FIFO streams (attention compute, expert
compute, two link directions). A task starts when its stream predecessor
AND its data dependencies are done. Iteration time = max end time. This is
exactly the constraint system of §4.1 (eq. for t(A_{i,j}^F)).

A copy of the JAX package's ``core/simulator.py`` with its imports rewritten
to the port (it imports neither jax nor the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict, deque
from typing import Dict, Optional

from repro_torch.core import schedule as S
from repro_torch.core.asym_ea import AsymEAPlan, apply_offload_to_times
from repro_torch.core.profiler import LayerTimes

BWD_RATIO = 2.0  # backward ~ 2x forward (paper §4.2)


@dataclasses.dataclass(frozen=True)
class CommTimes:
    """Per-microbatch all-to-all durations (one direction)."""

    dispatch: float
    combine: float


def exposed_comm(t_comm: float, t_hide: float, n_chunks: int) -> float:
    """Exposed (critical-path) time of an all-to-all split into n_chunks
    and double-buffered against compute of total duration t_hide.

    The first chunk's wire time is always exposed (nothing to hide it
    under); each later chunk transfers while the previous chunk computes,
    so only the excess of per-chunk wire time over per-chunk compute time
    stays exposed. n_chunks == 1 is the serialized baseline (full t_comm
    exposed) — the pre-overlap cost model."""
    q = max(int(n_chunks), 1)
    if q == 1:
        return t_comm
    per = t_comm / q
    return per + (q - 1) * max(0.0, per - t_hide / q)


@dataclasses.dataclass
class SimResult:
    iter_time: float
    attn_busy: float
    exp_busy: float
    attn_util: float
    exp_util: float
    starts: Dict
    # Task end times (same keys as starts). Optional so older pickled /
    # hand-built results keep working; obs.zebra.sim_to_trace needs it to
    # lay the schedule out as spans on a simulated timeline.
    ends: Dict = dataclasses.field(default_factory=dict)

    @property
    def attn_bubble(self) -> float:
        return 1.0 - self.attn_util


def task_duration(task, times: LayerTimes, comm: CommTimes, L: int,
                  offload, n_experts: int, N: int, M: int,
                  head_time: float, n_chunks: int = 1) -> float:
    kind, phase, l, _ = task
    scale = BWD_RATIO if phase == "B" else 1.0
    o_l = offload[l] if 0 <= l < L else 0
    if kind == "A":
        return times.t_attn * scale
    if kind == "E":
        t_exp, _ = apply_offload_to_times(times, o_l, n_experts, N, M)
        return t_exp * scale
    if kind == "X":
        _, t_extra = apply_offload_to_times(times, o_l, n_experts, N, M)
        return t_extra * scale
    if kind in ("D", "C"):
        # Volume is phase-independent (activations fwd, cotangents bwd);
        # with chunked dispatch only the exposed residue sits on the link
        # stream — the rest hides under the matching expert compute (whose
        # duration scales with BWD_RATIO in the backward).
        frac = 1.0 - o_l * N / n_experts  # offloaded tokens stay local-ish
        t_exp, _ = apply_offload_to_times(times, o_l, n_experts, N, M)
        vol = (comm.dispatch if kind == "D" else comm.combine) * frac
        return exposed_comm(vol, t_exp * scale, n_chunks)
    if kind == "H":
        return head_time
    raise ValueError(task)


def simulate(sched: S.ZebraSchedule, times: LayerTimes, comm: CommTimes,
             n_experts: int, N: int, M: int,
             head_time: float = 0.0) -> SimResult:
    """List-schedule the task system; Kahn topological order over
    (dependency edges + stream-FIFO edges)."""
    L, offload = sched.L, sched.offload
    preds: Dict = defaultdict(list)
    succs: Dict = defaultdict(list)
    indeg: Dict = defaultdict(int)
    tasks = sched.all_tasks()
    tset = set(tasks)

    def add_edge(a, b):
        preds[b].append(a)
        succs[a].append(b)
        indeg[b] += 1

    for stream_tasks in sched.streams.values():
        for a, b in zip(stream_tasks, stream_tasks[1:]):
            add_edge(a, b)
    for t in tasks:
        for d in S.dependencies(t, L, offload):
            if d in tset:
                add_edge(d, t)

    end: Dict = {}
    start: Dict = {}
    q = deque([t for t in tasks if indeg[t] == 0])
    done = 0
    while q:
        t = q.popleft()
        done += 1
        st = max((end[p] for p in preds[t]), default=0.0)
        dur = task_duration(t, times, comm, L, offload, n_experts, N, M,
                            head_time, n_chunks=sched.n_chunks)
        start[t] = st
        end[t] = st + dur
        for s_ in succs[t]:
            indeg[s_] -= 1
            if indeg[s_] == 0:
                q.append(s_)
    if done != len(tasks):
        raise ValueError("schedule has a dependency cycle")

    total = max(end.values())
    attn_busy = sum(end[t] - start[t] for t in sched.streams["attn_comp"])
    exp_busy = sum(end[t] - start[t] for t in sched.streams["exp_comp"])
    return SimResult(
        iter_time=total,
        attn_busy=attn_busy,
        exp_busy=exp_busy,
        attn_util=attn_busy / total if total else 0.0,
        exp_util=exp_busy / total if total else 0.0,
        starts=start,
        ends=end,
    )


# ---------------------------------------------------------------------------
# System-level throughput models (paper baselines)
# ---------------------------------------------------------------------------

def comm_times(cfg, global_batch: int, seq_len: int, R: int,
               link_bw: float, M: int, N: int) -> CommTimes:
    """All-to-all volume per microbatch: every routed token copy crosses the
    bipartite cut once per direction (paper: no extra communication vs EP)."""
    from repro_torch.core.profiler import a2a_time
    mb_tokens = global_batch * seq_len // R
    t = a2a_time(cfg, mb_tokens, link_bw, M, N)
    return CommTimes(dispatch=t, combine=t)


def simulate_hetermoe(cfg, times: LayerTimes, comm: CommTimes, R: int,
                      M: int, N: int, plan: Optional[AsymEAPlan] = None,
                      head_time: float = 0.0, n_chunks: int = 1) -> SimResult:
    offload = plan.offload if plan is not None else tuple([0] * cfg.n_layers)
    sched = S.canonical_schedule(cfg.n_layers, R, offload, n_chunks=n_chunks)
    return simulate(sched, times, comm, cfg.n_experts, N, M, head_time)


def simulate_distep(cfg, times: LayerTimes, comm: CommTimes, M: int,
                    N: int, head_time: float = 0.0) -> SimResult:
    """Naive disaggregation: no microbatch pipeline (R=1), no overlap.
    `times`/`comm` must be profiled at R=1 (whole batch per step)."""
    sched = S.canonical_schedule(cfg.n_layers, 1, None)
    return simulate(sched, times, comm, cfg.n_experts, N, M, head_time)


def distep_iter_time(cfg, zp, global_batch: int, seq_len: int,
                     link_bw: float) -> SimResult:
    """DistEP baseline with its own R=1 profile."""
    from repro_torch.core import profiler as P
    times = P.profile_layer(cfg, zp, global_batch, seq_len, 1)
    comm = comm_times(cfg, global_batch, seq_len, 1, link_bw, zp.M, zp.N)
    return simulate_distep(cfg, times, comm, zp.M, zp.N)


def ep_iter_time(cfg, zp, global_batch: int, seq_len: int,
                 link_bw: float) -> float:
    """Vanilla EP over the heterogeneous cluster: every GPU computes
    attention + its expert shard; the slowest class paces every stage."""
    from repro_torch.core import profiler as P
    G = zp.M + zp.N
    tokens_per_gpu = global_batch * seq_len // G
    copies_per_gpu = tokens_per_gpu * max(cfg.top_k, 1)
    t_attn = max(
        P.attention_block_time(cfg, tokens_per_gpu, seq_len, zp.attn_class),
        P.attention_block_time(cfg, tokens_per_gpu, seq_len, zp.exp_class))
    t_exp = max(
        P.expert_ffn_time(cfg, copies_per_gpu, zp.attn_class),
        P.expert_ffn_time(cfg, copies_per_gpu, zp.exp_class))
    byts = tokens_per_gpu * max(cfg.top_k, 1) * cfg.d_model * 2
    t_comm = 2 * byts / min(zp.attn_class.link_bw, zp.exp_class.link_bw)
    return cfg.n_layers * (1 + BWD_RATIO) * (t_attn + t_exp + t_comm)


def homogeneous_ep_iter_time(cfg, dev, n_gpus: int, global_batch: int,
                             seq_len: int) -> float:
    """EP on a homogeneous sub-cluster (basis of EP-Ideal and Fig. 11)."""
    from repro_torch.core import profiler as P
    tokens_per_gpu = global_batch * seq_len // n_gpus
    copies_per_gpu = tokens_per_gpu * max(cfg.top_k, 1)
    t_attn = P.attention_block_time(cfg, tokens_per_gpu, seq_len, dev)
    t_exp = P.expert_ffn_time(cfg, copies_per_gpu, dev)
    byts = tokens_per_gpu * max(cfg.top_k, 1) * cfg.d_model * 2
    t_comm = 2 * byts / dev.link_bw if n_gpus > 1 else 0.0
    # Tutel/Lina-style overlap on homogeneous EP: comm hides under compute
    # where possible.
    t_layer = t_attn + max(t_exp, t_comm)
    return cfg.n_layers * (1 + BWD_RATIO) * t_layer


def ep_ideal_throughput(cfg, zp, global_batch: int, seq_len: int) -> float:
    """Paper's EP (Ideal): run each class separately, sum throughputs
    (perfect balance, zero cross-class comm overhead). tokens/sec."""
    th = 0.0
    for dev, count in ((zp.attn_class, zp.M), (zp.exp_class, zp.N)):
        if count == 0:
            continue
        t = homogeneous_ep_iter_time(cfg, dev, count, global_batch, seq_len)
        th += global_batch * seq_len / t
    return th


# ---------------------------------------------------------------------------
# Serving-mode simulation (DESIGN.md §10)
# ---------------------------------------------------------------------------
#
# The serving counterpart of the training schedule simulator: a
# deterministic replay of a request trace through either deployment shape.
#
#   * unified (colocated=True): the continuous-batching engine run
#     data-parallel lockstep over the WHOLE mixed group — each tick spends
#     one prefill chunk (when a prompt is mid-flight) plus one decode step,
#     both paced by the slowest class present, and decode of live slots
#     stalls behind every prefill chunk (exactly the engine's tick loop).
#   * disagg (colocated=False): prefill streams drain the queue in
#     continuous time on the prefill group's clock; decode ticks
#     independently on the decode group's clock; a finished prefill pays
#     the page-handoff wire time before it can claim a decode slot.
#     Migration is FIFO head-of-line, like the controller.
#
# Being a function of the trace and the analytic profile only, its outputs
# gate CI (BENCH_serve.json `disagg`) the way gate.speedup does for zebra.

@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One trace entry for the serving simulator."""

    arrival: float  # seconds
    prompt: int     # prompt tokens
    gen: int        # tokens to generate


@dataclasses.dataclass
class ServeSimResult:
    makespan: float
    goodput: float     # generated tokens of finished requests per second
    ttft_mean: float
    ttft_p50: float
    n_finished: int


def zipf_poisson_trace(seed: int, n: int, rate: float, prompt: int,
                       gen: int, n_experts: int, zipf_s: float = 1.2):
    """Skewed serving workload for EP-placement planning (DESIGN.md §11):
    Poisson arrivals with fixed prompt/gen lengths, plus a Zipf routing
    histogram over a seed-shuffled expert order (rank-r expert gets mass
    1/(r+1)^s) — the distribution the placement planner consumes. Returns
    ``(requests, hist)`` with ``hist`` a normalized n_experts-tuple. Pure
    python so the simulator stays dependency-free."""
    import random
    rng = random.Random(seed)
    reqs, t = [], 0.0
    for _ in range(n):
        t += rng.expovariate(rate)
        reqs.append(ServeRequest(arrival=t, prompt=prompt, gen=gen))
    order = list(range(n_experts))
    rng.shuffle(order)
    w = [0.0] * n_experts
    for r, e in enumerate(order):
        w[e] = 1.0 / (r + 1) ** zipf_s
    tot = sum(w)
    return reqs, tuple(x / tot for x in w)


def production_trace(seed: int, n: int, *, base_rate: float,
                     diurnal_amp: float = 0.8, period_s: float = 600.0,
                     prompt_med: int = 512, prompt_sigma: float = 0.9,
                     gen_med: int = 64, gen_sigma: float = 0.8,
                     interactive_frac_amp: float = 0.45,
                     prompt_cap: int = 16384, gen_cap: int = 2048):
    """Production-shaped serving load (DESIGN.md §12): heavy-tailed
    lognormal prompt/output lengths under a diurnal arrival-rate swing.

    Arrivals are an inhomogeneous Poisson process thinned from rate
    ``base_rate * (1 + diurnal_amp * sin(2*pi*t/period_s))`` — traffic from
    a user population breathes with the clock. The REQUEST MIX breathes
    with it too: each request is "interactive" (short prompt, long
    generation — chat traffic, decode-bound) with probability
    ``0.5 + interactive_frac_amp * sin(...)`` at its arrival phase, else
    "batch" (long prompt, short generation — summarization/extraction,
    prefill-bound). The bottleneck ROLE therefore shifts over the day,
    which is exactly the gap an elastic fleet closes over any static
    prefill:decode split. Lengths are lognormal (median ``*_med``, shape
    ``*_sigma``: p99/p50 ~ e^{2.3 sigma}), capped so one request cannot
    exceed a pool. Pure python + deterministic under ``seed``."""
    import random
    rng = random.Random(seed)
    two_pi = 2.0 * math.pi

    def lognorm(med, sigma, cap):
        return max(1, min(int(med * math.exp(sigma * rng.gauss(0, 1))), cap))

    reqs, t = [], 0.0
    peak = base_rate * (1.0 + abs(diurnal_amp))
    while len(reqs) < n:
        t += rng.expovariate(peak)  # thinning: propose at the peak rate
        phase = math.sin(two_pi * t / period_s)
        rate_t = base_rate * (1.0 + diurnal_amp * phase)
        if rng.random() * peak > max(rate_t, 0.0):
            continue
        if rng.random() < 0.5 + interactive_frac_amp * phase:
            prompt = lognorm(prompt_med // 4, prompt_sigma, prompt_cap)
            gen = lognorm(gen_med * 2, gen_sigma, gen_cap)
        else:
            prompt = lognorm(prompt_med * 2, prompt_sigma, prompt_cap)
            gen = lognorm(max(gen_med // 4, 1), gen_sigma, gen_cap)
        reqs.append(ServeRequest(arrival=t, prompt=prompt, gen=gen))
    return reqs


@dataclasses.dataclass(frozen=True)
class TenantRequest:
    """One entry of a token-level multi-tenant trace (DESIGN.md §14):
    unlike :class:`ServeRequest` it carries actual token ids, because the
    prefix cache is keyed on them."""

    arrival: float       # engine ticks
    tenant: int
    prompt: tuple        # token ids (tenant shared prefix + unique tail)
    gen: int             # tokens to generate


def multi_tenant_trace(seed: int, n: int, *, n_tenants: int, rate: float,
                       prompt_len: int, gen: int, vocab: int,
                       shared_len: Optional[int] = None,
                       rates=None):
    """Shared-prefix multi-tenant serving workload (DESIGN.md §14).

    Every tenant owns a seeded ``shared_len``-token system prefix
    (default: half the prompt budget); each of its requests prepends that
    prefix to a unique random tail, so same-tenant requests share a long
    cacheable prefix while cross-tenant requests share nothing. Arrivals
    merge independent per-tenant Poisson streams: ``rates`` gives each
    tenant its own arrival rate (requests per engine tick — a skewed
    vector models one bursty tenant flooding the rest, the fairness
    scenario), defaulting to an even split of ``rate``. Generation
    budgets mix in [gen/2, gen]. Pure python + deterministic under
    ``seed``; returns ``n`` :class:`TenantRequest` sorted by arrival."""
    import random
    rng = random.Random(seed)
    shared_len = prompt_len // 2 if shared_len is None else shared_len
    assert 0 <= shared_len < prompt_len, \
        f"shared_len {shared_len} must leave room for a unique tail"
    assert n_tenants >= 1
    if rates is None:
        rates = [rate / n_tenants] * n_tenants
    assert len(rates) == n_tenants and all(r > 0 for r in rates)
    prefixes = [tuple(rng.randrange(vocab) for _ in range(shared_len))
                for _ in range(n_tenants)]
    t_next = [rng.expovariate(r) for r in rates]
    reqs = []
    while len(reqs) < n:
        tid = min(range(n_tenants), key=lambda i: t_next[i])
        t = t_next[tid]
        t_next[tid] += rng.expovariate(rates[tid])
        tail = rng.randint(1, max(1, prompt_len - shared_len))
        prompt = prefixes[tid] + tuple(
            rng.randrange(vocab) for _ in range(tail))
        g = rng.randint(max(1, gen // 2), gen)
        reqs.append(TenantRequest(arrival=t, tenant=tid, prompt=prompt,
                                  gen=g))
    return reqs


def _percentile(xs, q):
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))] if s else 0.0


def simulate_serve_trace(reqs, *, prefill_chunk: int, t_prefill_chunk: float,
                         t_decode_step: float, decode_slots: int,
                         n_prefill_streams: int = 1, t_handoff: float = 0.0,
                         colocated: bool = False,
                         max_ticks: int = 10_000_000) -> ServeSimResult:
    """Replay ``reqs`` (ServeRequest list) through one deployment shape.

    For the unified engine pass the slowest-class times and
    ``colocated=True`` (streams and handoff are ignored: one engine, one
    prefill stream, zero-copy admission). For disagg pass each group's own
    clock plus the per-request page-handoff time."""
    order = sorted(range(len(reqs)), key=lambda i: (reqs[i].arrival, i))
    chunks = {i: -(-reqs[i].prompt // prefill_chunk) for i in order}
    ttft: Dict[int, float] = {}
    finish: Dict[int, float] = {}

    if colocated:
        import collections
        queue = collections.deque(order)
        t = 0.0
        free = decode_slots
        mid = None  # (idx, chunks_left)
        active: Dict[int, int] = {}
        for _ in range(max_ticks):
            if mid is None and queue and reqs[queue[0]].arrival <= t \
                    and free > 0:
                idx = queue.popleft()
                free -= 1
                mid = [idx, chunks[idx]]
            dt = 0.0
            if mid is not None:
                dt += t_prefill_chunk
                mid[1] -= 1
                if mid[1] == 0:
                    idx = mid[0]
                    ttft[idx] = t + dt - reqs[idx].arrival
                    if reqs[idx].gen <= 1:
                        finish[idx] = t + dt
                        free += 1
                    else:
                        active[idx] = reqs[idx].gen - 1
                    mid = None
            if active:
                dt += t_decode_step
                for idx in list(active):
                    active[idx] -= 1
                    if active[idx] == 0:
                        finish[idx] = t + dt
                        free += 1
                        del active[idx]
            if dt == 0.0:
                if not queue:
                    break
                t = max(t, reqs[queue[0]].arrival)
            else:
                t += dt
    else:
        # Prefill group: FIFO over the streams, continuous time.
        stream_free = [0.0] * max(n_prefill_streams, 1)
        ready: Dict[int, float] = {}
        for i in order:
            s = min(range(len(stream_free)), key=lambda j: stream_free[j])
            start = max(reqs[i].arrival, stream_free[s])
            done = start + chunks[i] * t_prefill_chunk
            stream_free[s] = done
            ready[i] = done + t_handoff
        # Decode group: independent tick clock, FIFO head-of-line admits.
        import collections
        pending = collections.deque(order)
        t = 0.0
        free = decode_slots
        active: Dict[int, int] = {}
        for _ in range(max_ticks):
            while pending and ready[pending[0]] <= t and free > 0:
                idx = pending.popleft()
                free -= 1
                ttft[idx] = t - reqs[idx].arrival
                if reqs[idx].gen <= 1:
                    finish[idx] = t
                    free += 1
                else:
                    active[idx] = reqs[idx].gen - 1
            if not active:
                if not pending:
                    break
                t = max(t, ready[pending[0]])
                continue
            t += t_decode_step
            for idx in list(active):
                active[idx] -= 1
                if active[idx] == 0:
                    finish[idx] = t
                    free += 1
                    del active[idx]

    if len(finish) != len(reqs):
        # Never returns a truncated replay: the outputs feed the CI-gated
        # disagg.goodput_ratio_sim, which must not pass (or fail) on a
        # partial trace.
        raise RuntimeError(
            f"serve trace did not complete within {max_ticks} ticks "
            f"({len(finish)}/{len(reqs)} finished)")
    done_tok = sum(reqs[i].gen for i in finish)
    t0 = min((r.arrival for r in reqs), default=0.0)
    makespan = max(finish.values(), default=0.0) - t0
    tt = list(ttft.values())
    return ServeSimResult(
        makespan=makespan,
        goodput=done_tok / makespan if makespan > 0 else 0.0,
        ttft_mean=sum(tt) / len(tt) if tt else 0.0,
        ttft_p50=_percentile(tt, 0.5),
        n_finished=len(finish))


def pp_iter_time(cfg, zp, global_batch: int, seq_len: int,
                 n_microbatches: int = 8) -> float:
    """Heterogeneity-aware pipeline parallelism (Metis/FlashFlex style):
    layers split across one attention-class stage and one expert-class
    stage to balance per-stage time, memory permitting; 1F1B timing."""
    from repro_torch.core import profiler as P
    tokens = global_batch * seq_len
    mb_tokens = tokens // n_microbatches

    def stage_time_per_layer(dev):
        t_a = P.attention_block_time(cfg, mb_tokens, seq_len, dev)
        t_e = P.expert_ffn_time(cfg, mb_tokens * max(cfg.top_k, 1), dev)
        return t_a + t_e

    ta = stage_time_per_layer(zp.attn_class)
    te = stage_time_per_layer(zp.exp_class)
    # Optimal fractional split of L layers: attention class takes x layers
    # s.t. x*ta == (L-x)*te  ->  x = L*te/(ta+te); memory bound: the
    # expert-class stage must fit its layers.
    L = cfg.n_layers
    x = L * te / (ta + te)
    mem_per_layer = (cfg.n_experts * 3 * cfg.d_model * cfg.d_ff_expert * 12
                     + mb_tokens * cfg.d_model * 2 * 4)
    max_layers_exp = max(int(zp.exp_class.mem_bytes * zp.N * 0.9
                             // max(mem_per_layer, 1)), 1)
    layers_exp = min(L - x, max_layers_exp)
    layers_attn = L - layers_exp
    stage = max(layers_attn * ta / max(zp.M, 1) * 1.0,
                layers_exp * te / max(zp.N, 1) * 1.0)
    # 1F1B: (R + S - 1) * stage, fwd+bwd
    return (n_microbatches + 2 - 1) * stage * (1 + BWD_RATIO)


# -- chaos fault-schedule matrix (DESIGN.md §13) ----------------------------
#
# The STANDARD seeded fault schedules every chaos consumer shares: the
# acceptance tests (tests/test_chaos.py) drive the real fleet through each
# one, the CI chaos-smoke job replays them through launch/serve.py --chaos,
# and bench_serve's chaos section prices the "standard" entry against the
# fault-free run (chaos.goodput_degraded_ratio). One source of truth so a
# schedule can never silently diverge between the gate and the tests.
#
# Assumed topology (the chaos acceptance config): groups g0,g1 = prefill,
# g2,g3 = decode — two groups per role so any single-group fault is
# survivable.

def chaos_matrix():
    """``[(name, spec, seed)]`` — the standard fault-schedule matrix.

    Covers every hook point: chunk drop (probabilistic and
    retry-exhausting), corruption, link stall, heartbeat flap long enough
    to zombify-and-rejoin, and a mid-tick crash at each crash site. Specs
    follow the ``ft.chaos`` grammar; each entry carries its own seed so
    replays are independent."""
    return [
        # Probabilistic chunk loss: retries absorb it, no aborts.
        ("drop", "drop%0.6*4", 101),
        # Bit-flipped chunks: caught by the checksum, retried.
        ("corrupt", "corrupt*3", 202),
        # Delivered-but-unacked chunks: idempotent replay.
        ("stall", "stall*2", 303),
        # 4-deep drop bursts exhaust the retry budget (max_retries=3):
        # transfers abort and roll back into re-prefill.
        ("abort_reprefill", "drop@2*12", 404),
        # Heartbeat flap on decode g3, longer than the grace window:
        # zombify (fence + quarantine) then rejoin at gen+1.
        ("zombie_flap", "hb_loss@6:g3~8", 505),
        # Mid-tick crashes, one per hook point.
        ("crash_post_prefill", "crash_post_prefill@4:g0", 606),
        ("crash_mid_export", "crash_mid_export@3:g0", 707),
        ("crash_mid_import", "crash_mid_import@3:g2", 808),
        # The bench/CI "standard" schedule: a mild mix of everything.
        ("standard", "drop%0.5*2;corrupt*1;stall*1;hb_loss@6:g3~8", 909),
    ]
