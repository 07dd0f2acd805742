"""The port's host-side planning modules (``repro_torch.core``: hardware,
schedule, profiler, asym_ea, simulator, planner) against the JAX
package's originals: every function on the inputs of
``tests/test_asym_ea.py`` and ``tests/test_schedule_sim.py`` (the same
hypothesis strategies and settings) and ``plan_zp_group`` on the inputs of
``examples/hetero_mpmd.py``. The outputs must be identical: the same
values, compared exactly, field by field."""

import dataclasses
import random

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import asym_ea as j_asym
from repro.core import hardware as j_hw
from repro.core import planner as j_planner
from repro.core import profiler as j_prof
from repro.core import schedule as j_sched
from repro.core import simulator as j_sim
from repro.models import config as j_config
from repro.models import registry as j_registry
from repro_torch.core import asym_ea, hardware, planner, profiler, schedule
from repro_torch.core import simulator
from repro_torch.models import config, registry


def plain(x):
    """A dataclass (of either package) as nested plain values."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def outcome(fn, *args, **kw):
    """The function's result as plain values, or the type of the exception
    it raised."""
    try:
        return plain(fn(*args, **kw))
    except (ValueError, RuntimeError) as e:
        return type(e)


def assert_same(fn_port, fn_jax, *args, **kw):
    assert outcome(fn_port, *args, **kw) == outcome(fn_jax, *args, **kw)


def test_device_classes_identical():
    assert {k: plain(v) for k, v in hardware.CLASSES.items()} == \
        {k: plain(v) for k, v in j_hw.CLASSES.items()}
    # The roofline constants are the port's target card's, the H100 SXM
    # datasheet's (the dry run's roofline), not the JAX package's TPU v5e
    # ROOFLINE_* figures.
    assert not [n for n in dir(hardware) if n.startswith("ROOFLINE_")]
    assert (hardware.H100_PEAK_FLOPS, hardware.H100_HBM_BW,
            hardware.H100_NVLINK_BW, hardware.H100_NET_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)


# ---------------------------------------------------------------------------
# Asym-EA (tests/test_asym_ea.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,N", [(4, 4), (4, 8), (8, 4), (4, 3)])
def test_divisibility_identical(M, N):
    assert asym_ea.divisibility_ok(M, N) == j_asym.divisibility_ok(M, N)


TE = 4.0 / 3.0
OFFLOAD_CASES = [
    ((6, 4, 4, 3, 1.0, 1.0, 2.0), {}),                 # raises
    ((6, 6, 1, 1, 1.0, TE * 3.0 / 4.0, TE), {}),       # Fig. 6
    ((8, 4, 2, 2), dict(t_attn=2.0, t_exp_attn=0.5, t_exp=1.0)),
    ((8, 4, 2, 2), dict(t_attn=2.0, t_exp_attn=0.5, t_exp=1.0, n_min=3)),
    ((8, 8, 1, 1), dict(t_attn=0.1, t_exp_attn=0.05, t_exp=1.0, n_max=2)),
    ((8, 8, 4, 2), dict(t_attn=0.5, t_exp_attn=0.2, t_exp=1.0)),
    ((8, 8, 2, 4), dict(t_attn=0.5, t_exp_attn=0.2, t_exp=1.0)),
    ((16, 12, 2, 2, 0.2, 0.5, 1.0), dict(n_max=2)),
    ((16, 12, 2, 2, 0.9, 0.5, 1.0), dict(n_min=10)),
    ((6, 12, 1, 1, 1.0, 1.0, TE), {}),
]


@pytest.mark.parametrize("args,kw", OFFLOAD_CASES)
def test_asym_ea_offload_identical(args, kw):
    assert_same(asym_ea.asym_ea_offload, j_asym.asym_ea_offload, *args, **kw)


@settings(max_examples=60, deadline=None)
@given(
    n=st.sampled_from([4, 8, 16, 32]),
    L=st.integers(1, 24),
    mn=st.sampled_from([(1, 1), (2, 2), (4, 2), (2, 4), (4, 8), (8, 4)]),
    t_attn=st.floats(0.05, 4.0),
    t_exp=st.floats(0.05, 4.0),
    ratio=st.floats(0.3, 1.0),
)
def test_asym_ea_invariant_inputs_identical(n, L, mn, t_attn, t_exp, ratio):
    M, N = mn
    assert_same(asym_ea.asym_ea_offload, j_asym.asym_ea_offload, n, L, M, N,
                t_attn, t_exp * ratio, t_exp)


@settings(max_examples=30, deadline=None)
@given(
    t_exp=st.floats(1.0, 4.0),
    ratio=st.floats(0.3, 1.0),
    n_max=st.integers(0, 16),
)
def test_asym_ea_nmax_inputs_identical(t_exp, ratio, n_max):
    assert_same(asym_ea.asym_ea_offload, j_asym.asym_ea_offload, 16, 12, 2,
                2, 0.2, t_exp * ratio, t_exp, n_max=n_max)


@pytest.mark.parametrize("fpb", [0.0, 150.0])
def test_placement_identical(fpb):
    classes = (hardware.A40, hardware.V100)
    j_classes = (j_hw.A40, j_hw.V100)
    speeds = asym_ea.placement_speeds(classes, flops_per_byte=fpb)
    assert speeds == j_asym.placement_speeds(j_classes, flops_per_byte=fpb)
    load = [2.0 ** -e for e in range(8)]
    assert asym_ea.asym_ea_place(load, speeds, 4) == \
        j_asym.asym_ea_place(load, speeds, 4)
    assert asym_ea.round_robin_placement(8, 2) == \
        j_asym.round_robin_placement(8, 2)


# ---------------------------------------------------------------------------
# Theorem 1 and the simulator (tests/test_schedule_sim.py)
# ---------------------------------------------------------------------------

def times(mod, t_attn=1.0, t_exp=1.0, t_exp_attn=0.75):
    return mod.LayerTimes(t_attn=t_attn, t_exp=t_exp, t_exp_attn=t_exp_attn,
                          t_exp_on_exp=t_exp, t_attn_on_exp=2.0)


def sim_cfg(cfg_mod, L, n):
    return cfg_mod.ModelConfig(name="sim", family="moe", n_layers=L,
                               d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                               vocab_size=64,
                               pattern=(cfg_mod.LayerSpec(ffn="moe"),),
                               n_experts=n, top_k=2)


@pytest.mark.parametrize("L,R,offload", [
    (1, 1, None), (2, 3, None), (5, 4, None), (8, 2, None),
    (4, 3, (0, 1, 0, 2)), (30, 3, None), (3, 2, None)])
def test_schedule_identical(L, R, offload):
    sched = schedule.canonical_schedule(L, R, offload)
    want = j_sched.canonical_schedule(L, R, offload)
    assert plain(sched) == plain(want)
    schedule.validate(sched)
    for t in sched.all_tasks():
        assert schedule.stream_of(t) == j_sched.stream_of(t)
        assert schedule.dependencies(t, L, sched.offload) == \
            j_sched.dependencies(t, L, want.offload)


def run_simulate(sim_mod, sched_mod, prof_mod, L, R, t, comm, *args):
    return sim_mod.simulate(sched_mod.canonical_schedule(L, R),
                            times(prof_mod, *t), sim_mod.CommTimes(*comm),
                            *args)


@pytest.mark.parametrize("L,R,t,comm,args", [
    (30, 3, (1.0, TE), (0, 0), (6, 1, 1)),   # Fig. 6(a) steady state
    (3, 2, (), (0.2, 0.2), (4, 1, 1)),       # dependencies respected
    (4, 3, (1.0, 1.3), (0.05, 0.05), (4, 1, 1)),
])
def test_simulate_identical(L, R, t, comm, args):
    got = run_simulate(simulator, schedule, profiler, L, R, t, comm, *args)
    want = run_simulate(j_sim, j_sched, j_prof, L, R, t, comm, *args)
    assert plain(got) == plain(want)


def test_hetermoe_and_distep_identical():
    out = []
    for sim_mod, prof_mod, asym_mod, cfg_mod in (
            (simulator, profiler, asym_ea, config),
            (j_sim, j_prof, j_asym, j_config)):
        t = times(prof_mod, 1.0, TE, t_exp_attn=1.0)
        cfg = sim_cfg(cfg_mod, 12, 6)
        plan = asym_mod.asym_ea_offload(6, 12, 1, 1, 1.0, 1.0, TE)
        zero = sim_mod.CommTimes(0, 0)
        R = 4
        out.append([plain(r) for r in (
            sim_mod.simulate_hetermoe(cfg, t, zero, 3, 1, 1),
            sim_mod.simulate_hetermoe(cfg, t, zero, 3, 1, 1, plan),
            sim_mod.simulate_hetermoe(sim_cfg(cfg_mod, 8, 8),
                                      times(prof_mod, 1.0, 1.2),
                                      sim_mod.CommTimes(0.1, 0.1), R, 1, 1),
            sim_mod.simulate_distep(sim_cfg(cfg_mod, 8, 8),
                                    times(prof_mod, R * 1.0, R * 1.2),
                                    sim_mod.CommTimes(R * 0.1, R * 0.1), 1,
                                    1),
            sim_mod.simulate_hetermoe(cfg, t, sim_mod.CommTimes(0.1, 0.1), 3,
                                      1, 1, plan, n_chunks=4))])
    assert out[0] == out[1]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), L=st.integers(2, 4), R=st.integers(2, 4))
def test_permuted_schedules_identical(seed, L, R):
    """The Theorem 1 property test's shuffled attention streams: the same
    permutation simulated by both, the same result or both cyclic."""
    out = []
    for sim_mod, sched_mod, prof_mod in ((simulator, schedule, profiler),
                                         (j_sim, j_sched, j_prof)):
        sched = sched_mod.canonical_schedule(L, R)
        random.Random(seed).shuffle(sched.streams["attn_comp"])
        out.append(outcome(sim_mod.simulate, sched,
                           times(prof_mod, 1.0, 1.3),
                           sim_mod.CommTimes(0.05, 0.05), 4, 1, 1))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# The planner on the example's ZP group (examples/hetero_mpmd.py)
# ---------------------------------------------------------------------------

def example_plans(hw_mod, prof_mod, planner_mod, cfg):
    zp = prof_mod.ZPGroupShape(M=4, N=4, attn_class=hw_mod.A40,
                               exp_class=hw_mod.V100)
    plan = planner_mod.plan_zp_group(cfg, zp, global_batch=16, seq_len=4096)
    return (plan,
            planner_mod.replan(cfg, plan, 16, 4096, lost_attn=2,
                               slow_factor=1.5),
            planner_mod.sweep_ratios(cfg, hw_mod.A40, hw_mod.V100, 4,
                                     (2, 4, 8), 16, 4096, n_chunks=1))


def test_plan_zp_group_identical():
    got = example_plans(hardware, profiler, planner,
                        registry.get_config("mixtral-w1"))
    want = example_plans(j_hw, j_prof, j_planner,
                         j_registry.get_config("mixtral-w1"))
    plan, j_plan = got[0], want[0]
    assert (plan.R, plan.offload, plan.n_chunks) == \
        (j_plan.R, j_plan.offload, j_plan.n_chunks) == (4, (1, 2, 1, 2), 4)
    assert plan.predicted.iter_time == j_plan.predicted.iter_time
    assert plan.predicted_no_asym.iter_time == \
        j_plan.predicted_no_asym.iter_time
    assert plain(plan) == plain(j_plan)
    assert plain(got[1]) == plain(want[1])
    assert {k: plain(v) for k, v in got[2].items()} == \
        {k: plain(v) for k, v in want[2].items()}


# ---------------------------------------------------------------------------
# The rest of the copies: baselines, serve traces and their replay
# ---------------------------------------------------------------------------

def other_outputs(hw_mod, prof_mod, sim_mod, planner_mod, cfg):
    zp = prof_mod.ZPGroupShape(M=4, N=4, attn_class=hw_mod.A40,
                               exp_class=hw_mod.V100)
    reqs, hist = sim_mod.zipf_poisson_trace(0, 40, 2.0, 256, 128,
                                            cfg.n_experts)
    prod = sim_mod.production_trace(3, 30, base_rate=4.0)
    tenants = sim_mod.multi_tenant_trace(5, 12, n_tenants=2, rate=2.0,
                                         prompt_len=64, gen=8, vocab=256)
    replay = sim_mod.simulate_serve_trace(
        reqs, prefill_chunk=256, t_prefill_chunk=0.05, t_decode_step=0.01,
        decode_slots=8, n_prefill_streams=2, t_handoff=0.002)
    bw = hw_mod.A40.link_bw
    return [plain(x) for x in (
        sim_mod.distep_iter_time(cfg, zp, 16, 4096, bw),
        sim_mod.ep_iter_time(cfg, zp, 16, 4096, bw),
        sim_mod.homogeneous_ep_iter_time(cfg, hw_mod.A100, 8, 16, 4096),
        sim_mod.ep_ideal_throughput(cfg, zp, 16, 4096),
        sim_mod.pp_iter_time(cfg, zp, 16, 4096),
        sim_mod.comm_times(cfg, 16, 4096, 4, bw, 4, 4),
        sim_mod.chaos_matrix(), hist, [plain(r) for r in reqs],
        [plain(r) for r in prod], [plain(r) for r in tenants], replay,
        prof_mod.serve_profile(cfg, hw_mod.A40, hw_mod.V100, chunk=256,
                               ctx=2048, decode_batch=8),
        planner_mod.plan_disagg_group(cfg, zp, reqs[:10]),
        planner_mod.plan_ep_decode_group(cfg, (hw_mod.A40, hw_mod.V100),
                                         hist, reqs[:10]))]


def test_other_functions_identical():
    got = other_outputs(hardware, profiler, simulator, planner,
                        registry.get_config("mixtral-w2"))
    want = other_outputs(j_hw, j_prof, j_sim, j_planner,
                         j_registry.get_config("mixtral-w2"))
    assert got == want
