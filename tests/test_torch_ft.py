"""repro_torch's fault-tolerance copies (``repro_torch.ft``) against the
JAX package's ``repro.ft``.

Every case of ``tests/test_ft_monitor.py`` and of
``tests/test_train_ckpt_ft.py:250-300`` (heartbeat expiry, eviction and
joins, straggler windows, patience, membership churn, slow factors, and
the elastic controller's shrink / straggler-replan / healthy ticks with
their priority) is written once as a scenario over a package's modules
and run on both: the same injected clocks and step times give the same
decisions (dead hosts, stragglers, slow factors, strike counts), and the
controller's events carry the same kinds, details and ``replan`` results
(ZP shape, R, per-layer offloads, predicted iteration times), the port's
through ``repro_torch.core.planner.replan``. The reference's own
assertions are checked on the port's results as well.
"""

import dataclasses
import types

import pytest

import repro.core.hardware as jHW
import repro.core.planner as jplanner
import repro.core.profiler as jprofiler
import repro.ft as jft
import repro.ft.monitor as jmonitor
import repro.models.registry as jregistry
import repro_torch.core.hardware as HW
import repro_torch.core.planner as planner
import repro_torch.core.profiler as profiler
import repro_torch.ft as ft
import repro_torch.ft.monitor as monitor
import repro_torch.models.registry as registry

PORT = types.SimpleNamespace(ft=ft, monitor=monitor, planner=planner,
                             profiler=profiler, HW=HW, registry=registry)
JAX = types.SimpleNamespace(ft=jft, monitor=jmonitor, planner=jplanner,
                            profiler=jprofiler, HW=jHW, registry=jregistry)


def _monitor(pkg, hosts, clock, interval=10.0, grace=3.0):
    return pkg.ft.HeartbeatMonitor(
        hosts, pkg.monitor.HeartbeatConfig(interval_s=interval,
                                           grace_multiplier=grace),
        clock=lambda: clock["t"])


def heartbeat_expiry(pkg):
    clock = {"t": 0.0}
    mon = _monitor(pkg, ["a", "b", "c"], clock)
    clock["t"] = 5.0
    mon.beat("b")
    mon.beat("c")
    clock["t"] = 12.0
    mon.beat("c")
    log = []
    for t in (30.0, 31.0, 36.0, 43.0):
        clock["t"] = t
        log.append(sorted(mon.dead_hosts()))
    return log


def heartbeat_eviction(pkg):
    clock = {"t": 0.0}
    mon = _monitor(pkg, ["a", "b"], clock)
    clock["t"] = 100.0
    log = [sorted(mon.dead_hosts())]
    for h in ("a", "b", "b"):
        mon.remove(h)
        log.append(sorted(mon.dead_hosts()))
    return log


def heartbeat_join(pkg):
    clock = {"t": 0.0}
    mon = _monitor(pkg, ["a"], clock)
    clock["t"] = 100.0
    mon.beat("a")
    mon.add("late")
    log = [sorted(mon.dead_hosts())]
    clock["t"] = 131.0
    log.append(sorted(mon.dead_hosts()))
    mon.beat("new")
    log.append(sorted(mon.last_seen))
    return log


def heartbeat_default_config(pkg):
    clock = {"t": 0.0}
    mon = pkg.ft.HeartbeatMonitor(["a", "b"], clock=lambda: clock["t"])
    clock["t"] = 20.0
    mon.beat("a")
    clock["t"] = 35.0
    return [mon.dead_hosts()]


def straggler_empty_window(pkg):
    det = pkg.ft.StragglerDetector(["a", "b"])
    log = [det.stragglers()]
    det.record("a", 1.0)
    det.record("a", 1.0)
    return log + [det.stragglers(), det.slow_factor("a"),
                  det.slow_factor("b")]


def straggler_slow_factor(pkg):
    det = pkg.ft.StragglerDetector(["fast", "fast2", "slow"])
    for _ in range(10):
        det.record("fast", 1.0)
        det.record("fast2", 1.0)
        det.record("slow", 2.0)
    return [det.slow_factor(g) for g in ("fast", "fast2", "slow")]


def straggler_patience(pkg):
    det = pkg.ft.StragglerDetector(["a", "b"], z_thresh=3.0, patience=3)
    for _ in range(10):
        det.record("a", 1.0)
        det.record("b", 1.0)
    for _ in range(6):
        det.record("b", 5.0)
    return [det.stragglers() for _ in range(3)] + [dict(det.strikes)]


def straggler_membership(pkg):
    det = pkg.ft.StragglerDetector(["a"])
    det.add("b")
    for _ in range(10):
        det.record("a", 1.0)
        det.record("b", 1.0)
    det.remove("b")
    det.remove("b")
    log = ["b" in det.times, "b" in det.strikes, det.stragglers()]
    det.add("a")
    return log + [len(det.times["a"])]


def straggler_flags_slow_group(pkg):
    det = pkg.ft.StragglerDetector(["attn", "exp"], z_thresh=3.0, patience=2)
    for _ in range(10):
        det.record("attn", 1.0)
        det.record("exp", 1.0)
    log = [det.stragglers()]
    for _ in range(6):
        det.record("exp", 3.0)
        log.append(det.stragglers())
    return log + [det.stragglers(), det.slow_factor("exp")]


SCENARIOS = {
    "heartbeat_expiry": (heartbeat_expiry,
                         [[], ["a"], ["a", "b"], ["a", "b", "c"]]),
    "heartbeat_eviction": (heartbeat_eviction,
                           [["a", "b"], ["b"], [], []]),
    "heartbeat_join": (heartbeat_join,
                       [[], ["a", "late"], ["a", "late", "new"]]),
    "heartbeat_default_config": (heartbeat_default_config, [["b"]]),
    "straggler_empty_window": (straggler_empty_window, [[], [], 1.0, 1.0]),
    "straggler_slow_factor": (straggler_slow_factor, [1.0, 1.0, 2.0]),
    "straggler_patience": (straggler_patience,
                           [[], [], ["b"], {"a": 0, "b": 3}]),
    "straggler_membership": (straggler_membership, [False, False, [], 10]),
    "straggler_flags_slow_group": (straggler_flags_slow_group, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_monitor_decisions_equal_jax(name):
    fn, want = SCENARIOS[name]
    got = fn(PORT)
    assert got == fn(JAX)
    if want is not None:
        assert got == want
    else:  # the reference's test_straggler_detector_flags_slow_group
        assert got[0] == [] and "exp" in got[-2] and got[-1] > 2.0


# ---------------------------------------------------------------------------
# ElasticController over the planner
# ---------------------------------------------------------------------------

def _plan_summary(plan):
    if plan is None:
        return None
    return (plan.zp.M, plan.zp.N, plan.R, tuple(plan.offload),
            plan.predicted.iter_time, plan.predicted_no_asym.iter_time,
            plan.predicted.attn_util, plan.predicted.exp_util)


def _event(ev):
    return (ev.kind, ev.detail, _plan_summary(ev.plan))


def _controller(pkg):
    cfg = pkg.registry.get_config("mixtral-d1")
    zp = pkg.profiler.ZPGroupShape(M=4, N=4, attn_class=pkg.HW.A40,
                                   exp_class=pkg.HW.V100)
    plan = pkg.planner.plan_zp_group(cfg, zp, global_batch=16,
                                     seq_len=4096)
    return cfg, plan, pkg.ft.ElasticController(
        cfg, plan, 16, 4096, attn_hosts=["a0", "a1", "a2", "a3"],
        exp_hosts=["e0", "e1", "e2", "e3"])


def elastic_healthy(pkg):
    _, _, ctl = _controller(pkg)
    return [_event(ctl.tick())]


def elastic_shrink(pkg):
    _, _, ctl = _controller(pkg)
    ctl.heartbeat.last_seen["a3"] -= 1e6
    ctl.heartbeat.last_seen["e3"] -= 1e6
    return [_event(ctl.tick()), ctl.attn_hosts, ctl.exp_hosts]


def elastic_dead_before_straggler(pkg):
    _, _, ctl = _controller(pkg)
    for _ in range(10):
        ctl.record_step(1.0, 1.0)
    for _ in range(6):
        ctl.record_step(1.0, 9.0)
        ctl.detector.stragglers()
    log = ["exp" in ctl.detector.stragglers()]
    ctl.heartbeat.last_seen["e3"] -= 1e6
    return log + [_event(ctl.tick()), ctl.exp_hosts]


def elastic_straggler_then_recovers(pkg):
    _, plan, ctl = _controller(pkg)
    for _ in range(10):
        ctl.record_step(1.0, 1.0)
    for _ in range(6):
        ctl.record_step(1.0, 9.0)
        ctl.detector.stragglers()
    log = [_event(ctl.tick()), sum(plan.offload)]
    for _ in range(20):
        ctl.record_step(1.0, 1.0)
    ctl.detector.stragglers()
    return log + [_event(ctl.tick())]


def replan_slow_and_not_viable(pkg):
    cfg, plan, _ = _controller(pkg)
    slowed = pkg.planner.replan(cfg, plan, 16, 4096, slow_factor=2.0)
    zp = pkg.profiler.ZPGroupShape(M=1, N=1, attn_class=pkg.HW.A40,
                                   exp_class=pkg.HW.V100)
    small = pkg.planner.plan_zp_group(cfg, zp, global_batch=16,
                                      seq_len=4096)
    try:
        pkg.planner.replan(cfg, small, 16, 4096, lost_exp=1)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return [_plan_summary(plan), _plan_summary(slowed), raised]


ELASTIC = [elastic_healthy, elastic_shrink, elastic_dead_before_straggler,
           elastic_straggler_then_recovers, replan_slow_and_not_viable]


@pytest.mark.parametrize("fn", ELASTIC, ids=[f.__name__ for f in ELASTIC])
def test_elastic_decisions_equal_jax(fn):
    got = fn(PORT)
    assert got == fn(JAX)
    if fn is elastic_healthy:
        assert got[0][0] == "none" and got[0][2] is None
    elif fn is elastic_shrink:
        assert got[0][0] == "shrink" and got[0][2][:2] == (3, 3)
    elif fn is elastic_dead_before_straggler:
        assert got[0] and got[1][0] == "shrink" and "e3" not in got[2]
        assert got[1][2][1] == 3
    elif fn is elastic_straggler_then_recovers:
        assert got[0][0] == "straggler-replan"
        assert sum(got[0][2][3]) >= got[1] and got[2][0] == "none"
    else:
        plan, slowed, raised = got
        assert sum(slowed[3]) >= sum(plan[3]) and slowed[4] >= plan[4]
        assert raised is not None


def test_ft_exports_the_jax_packages_monitor_and_elastic_names():
    names = {"ElasticController", "ElasticEvent", "HeartbeatConfig",
             "HeartbeatMonitor", "StragglerDetector"}
    assert set(ft.__all__) == names
    assert names < set(jft.__all__)
    ev = ft.ElasticEvent("none", "healthy")
    assert dataclasses.asdict(ev) == dataclasses.asdict(
        jft.ElasticEvent("none", "healthy"))
