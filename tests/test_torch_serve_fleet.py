"""repro_torch's elastic serving fleet (``serve/fleet``, ``core.planner.
plan_fleet``, the driver's fleet flags) against the JAX package's: the
cases of ``tests/test_serve_fleet.py`` run through both packages.

* Host-only parts, equal to JAX's on the same inputs: exact percentiles,
  the router's placements (stub groups), ``production_trace``, the fleet
  simulator's ``FleetSimResult`` field for field (conservation, kills,
  elastic against static on a diurnal trace, the last prefill group never
  flips), ``plan_fleet``'s roles and results, ``parse_group_spec`` /
  ``parse_kills`` and their messages.
* The real fleet on the tiny model under an f32 ``Policy`` on the JAX
  weights: greedy tokens equal JAX's fleet and the port's unified paged
  engine; a decode group and a prefill group killed mid-trace, the forced
  flip that revives a decode-less fleet, the stall without
  ``--fleet-elastic``, topology and oversize rejections with JAX's
  messages. Each run's ``FleetEvent`` log, its ``fleet`` summary section,
  its transfer stats, robustness counters and rejections equal JAX's
  field for field; every surviving pool is checked and holds no page.
* The driver: the acceptance command line exits 0 on the CPU, and a
  failed run exits non-zero, as the JAX driver's.

Wall clock: the straggler detector's step times (host clock in both
packages) feed the router's ``slow_factor``. Each fleet here records one
fixed step time instead (``_fixed_step_times``), the same in both
packages, so no group counts as slow and routing is the same in both.

The JAX fleet compiles its two programs once per geometry: the module
fixture memoizes ``repro.serve.engine.make_continuous_program`` for the
tests' runs (the JAX package itself is not changed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jplanner
from repro.core import simulator as jsim
from repro.core.hardware import A40 as JA40
from repro.core.hardware import V100 as JV100
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.config import ModelConfig as JModelConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro.serve import fleet as jfleet
from repro.serve import metrics as jmetrics
from repro.serve.scheduler import Request as JRequest
from repro_torch.core import planner, simulator as sim
from repro_torch.core.hardware import A40, V100
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (GREEDY, FleetCfg, PagedCfg, Request,
                               ServeConfig, build_deployment, config)
from repro_torch.serve import fleet
from repro_torch.serve import metrics
from torch_parity import jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
            moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab_size=64)
FLEET = dict(prefill_classes=["a40"], decode_classes=["v100", "v100"],
             decode_slots=2, max_len=32, page_size=8, prefill_chunk=6)
STEP_S = 1e-3  # the step time each fleet's straggler detector records


# ---------------------------------------------------------------------------
# Exact percentiles, the router, the production trace (host-only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xs", [[4.0, 1.0, 3.0, 2.0], [7.0],
                                list(range(101)), []])
def test_percentiles_equal_jax(xs):
    for q in (0.0, 1 / 3, 0.5, 0.95, 0.99, 1.0):
        got, want = metrics.percentile(xs, q), jmetrics.percentile(xs, q)
        assert got == want or (np.isnan(got) and np.isnan(want))
    if xs:
        assert metrics.percentiles(xs) == jmetrics.percentiles(xs)
    assert metrics.percentile([4.0, 1.0, 3.0, 2.0], 0.5) == \
        pytest.approx(2.5)
    for q in (1.5, -0.1):
        with pytest.raises(ValueError):
            metrics.percentile([1.0], q)


class _G:
    """Minimal group view implementing the router protocol."""

    def __init__(self, gid, cls, queued=0, active=0, can=True):
        self.gid, self.cls = gid, cls
        self.name = f"g{gid}"
        self._q, self._a, self._can = queued, active, can

    def queued_prefill_tokens(self):
        return self._q

    def n_active(self):
        return self._a

    def can_accept_ticket(self, n_tokens):
        return self._can


def _routers(**kw):
    return fleet.FleetRouter(**kw), jfleet.FleetRouter(**kw)


def _same_pick(routers, method, groups, *args):
    picks = [getattr(r, method)(groups, *args) for r in routers]
    assert picks[0] is picks[1]
    return picks[0]


@pytest.mark.parametrize("case", ["fast_class", "ticket_head_of_line",
                                  "slow_factor"])
def test_router_placements_equal_jax(case):
    """The JAX router tests' placements, made by both routers on the same
    stub groups."""
    if case == "fast_class":
        rs = _routers(prefill_speed={"a40": 2.0, "v100": 1.0})
        fast, slow = _G(0, "a40", queued=10), _G(1, "v100", queued=10)
        assert _same_pick(rs, "place_request", [slow, fast], 8) is fast
        fast._q = 100  # enough backlog on the fast class flips it
        assert _same_pick(rs, "place_request", [slow, fast], 8) is slow
        assert _same_pick(rs, "place_request", [], 8) is None
    elif case == "ticket_head_of_line":
        rs = _routers(decode_speed={"a40": 1.0, "v100": 1.0})
        full = _G(0, "a40", active=1, can=False)
        free = _G(1, "v100", active=3, can=True)
        assert _same_pick(rs, "place_ticket", [full, free], 16) is free
        assert _same_pick(rs, "place_ticket", [full], 16) is None
        emptier = _G(2, "v100", active=1, can=True)
        assert _same_pick(rs, "place_ticket", [full, free, emptier],
                          16) is emptier
    else:
        rs = _routers(prefill_speed={"a40": 1.0},
                      slow_factor=lambda n: 4.0 if n == "g0" else 1.0)
        slow, ok = _G(0, "a40", queued=10), _G(1, "a40", queued=20)
        assert _same_pick(rs, "place_request", [slow, ok], 8) is ok
        assert rs[0].prefill_eta(slow, 8) == rs[1].prefill_eta(slow, 8)
        assert rs[0].decode_eta(ok) == rs[1].decode_eta(ok)


def _triples(reqs):
    return [(r.arrival, r.prompt, r.gen) for r in reqs]


@pytest.mark.parametrize("kw", [
    dict(seed=3, n=400, base_rate=20.0, period_s=60.0),
    dict(seed=0, n=4000, base_rate=40.0, diurnal_amp=0.8, period_s=40.0,
         prompt_med=512, gen_med=64, interactive_frac_amp=0.45)])
def test_production_trace_equals_jax(kw):
    """The port's production trace equals JAX's draw for draw; it is
    sorted, capped and, on the diurnal case, its mix swings with the
    phase (interactive at the peak, batch in the trough)."""
    import math
    reqs = sim.production_trace(**kw)
    assert _triples(reqs) == _triples(jsim.production_trace(**kw))
    assert _triples(reqs) == _triples(sim.production_trace(**kw))
    assert all(reqs[i].arrival <= reqs[i + 1].arrival
               for i in range(len(reqs) - 1))
    assert all(1 <= r.prompt <= 16384 and 1 <= r.gen <= 2048 for r in reqs)
    if kw["n"] == 4000:
        P = kw["period_s"]
        up = [r for r in reqs if math.sin(2 * math.pi * r.arrival / P) > 0.7]
        down = [r for r in reqs
                if math.sin(2 * math.pi * r.arrival / P) < -0.7]
        assert len(up) > 50 and len(down) > 50
        assert np.mean([r.prompt for r in up]) < \
            np.mean([r.prompt for r in down])
        assert np.mean([r.gen for r in up]) > np.mean([r.gen for r in down])


# ---------------------------------------------------------------------------
# The fleet simulator and plan_fleet (host-only)
# ---------------------------------------------------------------------------

def _sim_groups(mod, roles, t_pre=0.01, t_dec=0.02, slots=8):
    return [mod.SimGroup(gid=i, cls="x", role=r, t_prefill_chunk=t_pre,
                         t_decode_step=t_dec, decode_slots=slots)
            for i, r in enumerate(roles)]


def _poisson_sim_trace(simmod, n=60, seed=0, rate=4.0, prompt=(64, 512),
                       gen=(16, 64)):
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append(simmod.ServeRequest(arrival=t,
                                       prompt=int(rng.randint(*prompt)),
                                       gen=int(rng.randint(*gen))))
    return out


def _diurnal(simmod):
    return simmod.production_trace(
        0, 1200, base_rate=26.0, diurnal_amp=0.5, period_s=90.0,
        prompt_med=1650, prompt_sigma=0.9, gen_med=64, gen_sigma=0.8,
        interactive_frac_amp=0.45, prompt_cap=8192, gen_cap=1024)


def _simulate(pkg, trace_kw, roles, group_kw=None, **kw):
    """One ``simulate_fleet_trace`` run in ``pkg`` ('port' or 'jax'):
    (result, the groups' roles after the run)."""
    simmod, fl = (sim, fleet) if pkg == "port" else (jsim, jfleet)
    trace = _diurnal(simmod) if trace_kw == "diurnal" \
        else _poisson_sim_trace(simmod, **trace_kw)
    groups = _sim_groups(fl, roles, **(group_kw or {}))
    res = fl.simulate_fleet_trace(trace, groups, prefill_chunk=256, **kw)
    return res, [g.role for g in groups]


SIM_CASES = {
    "conservation": (dict(), ("prefill", "decode", "decode"), None, {}),
    "kill_decode": (dict(n=40), ("prefill", "decode", "decode"), None,
                    dict(kills=[(1.0, 1)], detect_delay=0.5)),
    "kill_prefill": (dict(n=40), ("prefill", "prefill", "decode",
                                  "decode"), None,
                     dict(kills=[(0.5, 0)], detect_delay=0.5)),
    "never_flip_last_prefill": (dict(n=30, gen=(64, 256)),
                                ("prefill", "decode"), None,
                                dict(elastic=True, wait_hi=0.0)),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_fleet_sim_equals_jax(case):
    """Each JAX simulator case on the same trace and groups: the port's
    ``FleetSimResult`` equals JAX's field for field, and the JAX test's
    claims hold on it (every request finishes; a kill's recovery shows in
    the worst inter-token gap; the only prefill group never flips)."""
    trace_kw, roles, group_kw, kw = SIM_CASES[case]
    got, got_roles = _simulate("port", trace_kw, roles, group_kw, **kw)
    want, want_roles = _simulate("jax", trace_kw, roles, group_kw, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got_roles == want_roles
    assert got.n_finished == got.n_requests
    if case == "conservation":
        assert got.goodput > 0 and got.makespan > 0 and got.n_flips == 0
    if case == "kill_decode":
        base, _ = _simulate("port", trace_kw, roles, group_kw)
        killed, _ = _simulate("port", trace_kw, roles, group_kw,
                              kills=[(base.makespan * 0.3, 1)],
                              detect_delay=0.5)
        assert killed.n_finished == killed.n_requests
        assert killed.itl_p99 > base.itl_p99 + 0.2
    if case == "never_flip_last_prefill":
        assert got_roles[0] == "prefill"


def test_fleet_sim_elastic_beats_static_equal_jax():
    """The diurnal acceptance: the elastic fleet flips and beats the best
    static split on goodput under the SLO; every run equals JAX's."""
    statics = (("prefill", "prefill", "prefill", "decode"),
               ("prefill", "prefill", "decode", "decode"),
               ("prefill", "decode", "decode", "decode"))
    kw = dict(slo_ttft=2.0, slo_itl=1.0)
    gk = dict(t_pre=0.0065, t_dec=0.0044)
    best = 0.0
    for roles in statics:
        got, _ = _simulate("port", "diurnal", roles, gk, **kw)
        want, _ = _simulate("jax", "diurnal", roles, gk, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        best = max(best, got.goodput_under_slo)
    el, _ = _simulate("port", "diurnal", statics[1], gk, elastic=True, **kw)
    jel, _ = _simulate("jax", "diurnal", statics[1], gk, elastic=True, **kw)
    assert dataclasses.asdict(el) == dataclasses.asdict(jel)
    assert el.n_flips > 0 and el.goodput_under_slo > best


def test_plan_fleet_equals_jax():
    """``plan_fleet`` sweeps the static splits of (A40, A40, V100): the
    port's roles, both predicted results and the ratio equal JAX's."""
    cfg = registry.get_config("mixtral-d1")
    jcfg = jreg.get_config("mixtral-d1")
    kw = dict(prefill_chunk=256, ctx=2048, decode_slots=8, slo_ttft=5.0,
              slo_itl=2.0)
    plan = planner.plan_fleet(cfg, (A40, A40, V100),
                              _poisson_sim_trace(sim, n=30, rate=8.0), **kw)
    jplan = jplanner.plan_fleet(jcfg, (JA40, JA40, JV100),
                                _poisson_sim_trace(jsim, n=30, rate=8.0),
                                **kw)
    assert (plan.classes, plan.roles) == (jplan.classes, jplan.roles)
    for f in ("predicted_static", "predicted_elastic"):
        assert dataclasses.asdict(getattr(plan, f)) == \
            dataclasses.asdict(getattr(jplan, f))
    assert plan.goodput_ratio_sim == jplan.goodput_ratio_sim > 0
    assert plan.n_prefill >= 1 and plan.n_decode >= 1
    assert plan.n_prefill + plan.n_decode == 3
    assert plan.predicted_static.n_finished == 30
    with pytest.raises(ValueError, match="at least 2 groups"):
        planner.plan_fleet(cfg, (A40,), [], slo_ttft=5.0, slo_itl=2.0)


# ---------------------------------------------------------------------------
# The real fleet (tiny model, f32, CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """(port cfg, port params, jax cfg, jax params, mesh), with the JAX
    package's ``make_continuous_program`` memoized for this module's
    fleets (one compile per program geometry)."""
    memo = {}
    make = jengine.make_continuous_program

    def memoized(cfg, mesh, run, **kw):
        key = (id(cfg), id(mesh), id(run), tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = make(cfg, mesh, run, **kw)
        return memo[key]

    jcfg = JModelConfig(**TINY)
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "make_continuous_program", memoized)
        yield (ModelConfig(**TINY), params_from_jax(jax_values_np(jp)),
               jcfg, jp, make_mesh((1, 1), ("data", "model")))


def _fixed_step_times(ctl):
    """Record STEP_S for every group step instead of its host-clock time:
    the router's slow_factor stays 1.0, the same in both packages."""
    record = ctl.detector.record
    ctl.detector.record = lambda group, _t: record(group, STEP_S)
    return ctl


def make_fleets(setup, **kw):
    """(port fleet, JAX fleet) of the tiny model on the same weights;
    ``chaos`` is a (spec, seed) pair armed in both."""
    cfg, tp, jcfg, jp, mesh = setup
    kw = {**FLEET, **kw}
    chaos = kw.pop("chaos", None)
    fleets = []
    for pkg in ("port", "jax"):
        ckw = {}
        if chaos is not None:
            from repro.ft import chaos as jchaos
            from repro_torch.ft import chaos as tchaos
            mod = tchaos if pkg == "port" else jchaos
            ckw["chaos"] = mod.FaultInjector(mod.FaultPlan.parse(chaos[0]),
                                             seed=chaos[1])
        if pkg == "port":
            ctl = fleet.make_fleet(cfg, RUN, tp, metrics=metrics
                                   .ServeMetrics(), device="cpu", **ckw,
                                   **kw)
        else:
            ctl = jfleet.make_fleet(jcfg, mesh, JRUN, jp,
                                    metrics=jmetrics.ServeMetrics(), **ckw,
                                    **kw)
        fleets.append(_fixed_step_times(ctl))
    return fleets


def fleet_trace(n=8, seed=5, rate=0.5):
    return serve_mod.build_trace(seed=seed, n=n, rate=rate, prompt_len=14,
                                 gen=8, vocab=TINY["vocab_size"],
                                 sampling=GREEDY)


def _requests(trace, pkg):
    cls = Request if pkg == "port" else JRequest
    return [cls(rid=r.rid, prompt=list(r.prompt),
                max_new_tokens=r.max_new_tokens, arrival=r.arrival)
            for r in trace]


def record(ctl, elastic=False):
    """What a fleet run leaves that the two packages must agree on."""
    sc = ServeConfig(fleet=FleetCfg(enabled=True, elastic=elastic))
    out = {"summary": serve_mod._fleet_summary(ctl, sc),
           "stats": dataclasses.asdict(ctl.transfer.stats),
           "robust": ctl.metrics.robust.as_dict(),
           "rejected": list(ctl.rejected), "shed": list(ctl.shed),
           "fenced": sorted(ctl.fenced),
           "groups": [(g.gid, g.role, g.generation) for g in ctl.groups]}
    if ctl.chaos is not None:
        out["faults"] = (ctl.chaos.log(), ctl.chaos.log_signature())
    return out


def run_both(setup, trace, kills=(), elastic=False, **kw):
    """Run ``trace`` through both fleets; assert that results and every
    recorded field agree and that every surviving pool is clean. Returns
    (port results, port fleet, its record)."""
    ctl, jctl = make_fleets(setup, elastic=elastic, **kw)
    res = ctl.run(_requests(trace, "port"), kills=list(kills))
    jres = jctl.run(_requests(trace, "jax"), kills=list(kills))
    assert res == jres
    rec = record(ctl, elastic)
    assert rec == record(jctl, elastic)
    for g in ctl.groups:
        g.worker.allocator.check()
        assert g.worker.allocator.pages_in_use == 0, g.name
    return res, ctl, rec


@pytest.fixture(scope="module")
def unified(setup):
    """The port's unified paged engine on the fleet trace (2 slots, max
    len 32, page 8, chunk 6): the fleet's token reference."""
    cfg, tp, *_ = setup
    sc = ServeConfig(slots=2, max_len=32, prefill_chunk=6,
                     paged=PagedCfg(enabled=True, page_size=8))
    eng = build_deployment(cfg, RUN, sc, params=tp, device="cpu")
    return eng.run(_requests(fleet_trace(), "port"))


FLEET_CASES = {
    # name: (make_fleet overrides, kills)
    "parity": ({}, ()),
    "kill_decode": ({}, ((8, 1),)),
    "kill_prefill": (dict(prefill_classes=["a40", "a40"]), ((2, 0),)),
    "forced_flip": (dict(prefill_classes=["a40", "a40"],
                         decode_classes=["v100"], elastic=True), ((8, 2),)),
}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_equals_jax_and_unified(setup, unified, case):
    """Greedy parity with the unified engine, a decode group and a prefill
    group killed mid-trace, and the forced flip: the port's tokens equal
    the uninterrupted unified run's and JAX's fleet's, and the events,
    the ``fleet`` section, transfer stats and counters equal JAX's."""
    kw, kills = FLEET_CASES[case]
    res, ctl, rec = run_both(setup, fleet_trace(), kills=kills, **kw)
    assert res == unified
    assert not ctl.rejected
    kinds = [e["kind"] for e in rec["summary"]["events"]]
    if case == "parity":
        assert kinds == []
    if case == "kill_decode":
        # g1, not the JAX test's g2: with equal step times the router
        # fills the decode group of the lower gid first, so g2 holds no
        # request at tick 8
        assert "dead" in kinds and "recover" in kinds
        assert all(g.gid != 1 for g in ctl.groups)
    if case == "kill_prefill":
        assert kinds.count("dead") == 1
    if case == "forced_flip":
        flips = [e for e in ctl.events if e.kind == "flip"]
        assert flips and flips[0].detail == "-> decode"
        assert len(ctl.decode_groups()) >= 1


def test_fleet_without_elastic_stalls_like_jax(setup):
    """The only decode group killed without elastic flips: both fleets
    stall past max_ticks with the same message."""
    ctl, jctl = make_fleets(setup, prefill_classes=["a40", "a40"],
                            decode_classes=["v100"])
    errs = []
    for c, pkg in ((ctl, "port"), (jctl, "jax")):
        with pytest.raises(RuntimeError, match="exceeded") as ei:
            c.run(_requests(fleet_trace(), pkg), kills=[(8, 2)],
                  max_ticks=120)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("kw", [dict(prefill_classes=["h100x"]),
                                dict(decode_classes=[])])
def test_make_fleet_rejects_invalid_topologies_like_jax(setup, kw):
    cfg, tp, jcfg, jp, mesh = setup
    with pytest.raises(ValueError) as ei:
        fleet.make_fleet(cfg, RUN, tp, device="cpu", **{**FLEET, **kw})
    with pytest.raises(ValueError) as jei:
        jfleet.make_fleet(jcfg, mesh, JRUN, jp, **{**FLEET, **kw})
    assert str(ei.value) == str(jei.value)
    assert "unknown device class" in str(ei.value) \
        or ">= 1 prefill" in str(ei.value)


def test_fleet_submit_rejects_oversized_request_like_jax(setup):
    big = Request(rid=99, prompt=list(range(40)), max_new_tokens=8,
                  sampling=GREEDY, arrival=0.0)
    res, ctl, rec = run_both(setup, fleet_trace(n=2) + [big])
    assert ctl.rejected == [99] and sorted(res) == [0, 1]


# ---------------------------------------------------------------------------
# Driver plumbing
# ---------------------------------------------------------------------------

def test_parse_group_spec_and_kills_equal_jax():
    for spec, default in (("a40,v100", "x"), ("3", "a40"),
                          (" v100 , v100 ", "x"), ("", "x")):
        assert config.parse_group_spec(spec, default) == \
            jconfig.parse_group_spec(spec, default)
    assert config.parse_group_spec("3", "a40") == ["a40"] * 3
    for specs in (["2@8", "0@10"], None, ["crash_start@4:g1"]):
        assert config.parse_kills(specs) == jconfig.parse_kills(specs)
    assert config.parse_kills(["2@8", "0@10"]) == [(8, 2), (10, 0)]
    for bad in (["nope"], ["drop@2"]):
        with pytest.raises(ValueError, match="GID@TICK") as ei:
            config.parse_kills(bad)
        with pytest.raises(ValueError) as jei:
            jconfig.parse_kills(bad)
        assert str(ei.value) == str(jei.value)


ACCEPT = ["--arch", "mixtral-w2", "--smoke", "--fleet", "--prefill-groups",
          "a40,a40", "--decode-groups", "v100,v100", "--fleet-elastic",
          "--kill-group", "2@10", "--device", "cpu"]


def test_fleet_driver_serves_and_fails_like_jax(monkeypatch, capsys):
    """The acceptance command line exits 0 on the CPU: group 2 (the first
    decode group) dies and its requests re-prefill. A failed run exits 1,
    a passed one 0, as the JAX driver's. (The summary's sections against
    the JAX driver's: ``test_torch_serve_fleet_chaos.py::
    test_driver_sections_equal_jax``.)"""
    assert serve_mod.main(ACCEPT) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=mixtral-w2-smoke fleet: " in out
    assert "g2=" not in out.split("fleet: ")[-1].split()[0]
    for mod, argv in ((serve_mod, ["--smoke", "--fleet", "--device", "cpu"]),
                      (jserve, ["--smoke", "--fleet"])):
        for ok, rc in ((False, 1), (True, 0)):
            monkeypatch.setattr(mod, "serve_arch",
                                lambda arch, args, serve_cfg=None,
                                mesh=None, ok=ok: {"ok": ok})
            assert mod.main(argv) == rc
