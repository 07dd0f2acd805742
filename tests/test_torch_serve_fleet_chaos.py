"""repro_torch's fleet under the seeded fault schedules of
``tests/test_chaos.py:239-330``, and its traced runs, against the JAX
package's fleet (the tiny model under an f32 ``Policy`` on the JAX
weights; the fleets and helpers of ``test_torch_serve_fleet.py``: fixed
straggler step times, memoized JAX programs).

* Every entry of ``core.simulator.chaos_matrix()`` (which equals JAX's):
  every request finishes with the fault-free run's tokens, nothing is
  rejected, every surviving pool is checked and holds zero pages after
  the drain; the fault log and its signature, the ``FleetEvent`` log, the
  ``fleet`` section, transfer stats and robustness counters equal JAX's.
* The same (seed, spec) replays to the same results and fault log; the
  heartbeat-flapped zombie is fenced and rejoins at generation 1; an
  exhausted transfer aborts and re-prefills; an impossible TTFT SLO sheds
  every arrival explicitly and a generous one sheds nothing.
* A traced fleet run (the forced flip after a kill, and the standard
  chaos schedule with its zombie track) equals JAX's traced run event for
  event, its signature and idle report too; tracing leaves the tokens
  alone.
* The driver: ``--chaos`` without ``--fleet`` exits 1 in both drivers; a
  fleet with the standard schedule exits 0, and its summary has the JAX
  driver's sections and ``fleet`` / ``chaos`` keys.
"""

import pytest

from repro.core.simulator import chaos_matrix as jchaos_matrix
from repro.launch import serve as jserve
from repro.obs import export as jexport
from repro.obs import trace as jtrace
from repro_torch.core.simulator import chaos_matrix
from repro_torch.launch import serve as serve_mod
from repro_torch.obs import export
from repro_torch.obs import trace as obs_trace
from test_torch_serve_fleet import (ACCEPT, _requests, fleet_trace,
                                    make_fleets, run_both,
                                    setup)  # noqa: F401
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

CHAOS = dict(prefill_classes=["a40", "a40"], decode_classes=["v100", "v100"])


@pytest.fixture(scope="module")
def fault_free(setup):  # noqa: F811
    res, _, _ = run_both(setup, fleet_trace(), **CHAOS)
    return res


def _survived(ctl, res, want):
    """Every submitted request finished with the fault-free tokens or was
    shed; nothing rejected (run_both checked the pools)."""
    assert set(res) | set(ctl.shed) == set(want)
    assert not ctl.rejected
    for rid, toks in res.items():
        assert toks == want[rid], f"rid {rid} diverged under faults"


def test_chaos_matrix_equals_jax():
    assert chaos_matrix() == jchaos_matrix()
    assert len({n for n, _, _ in chaos_matrix()}) == len(chaos_matrix())


@pytest.mark.parametrize("name,spec,seed", chaos_matrix(),
                         ids=[e[0] for e in chaos_matrix()])
def test_fleet_survives_schedule_like_jax(setup, fault_free, name, spec,
                                          seed):
    """Drops, corruption, stalls, retry-exhaustion aborts, heartbeat-flap
    zombies and mid-tick crashes: token-exact, leak-free, and the same
    faults, events and counters as JAX's fleet."""
    res, ctl, rec = run_both(setup, fleet_trace(), chaos=(spec, seed),
                             **CHAOS)
    assert rec["faults"][0], f"schedule {name!r} fired no fault"
    _survived(ctl, res, fault_free)


def test_fleet_chaos_replay_is_deterministic(setup):
    _, spec, seed = next(e for e in chaos_matrix() if e[0] == "standard")

    def once():
        ctl, _ = make_fleets(setup, chaos=(spec, seed), **CHAOS)
        res = ctl.run(_requests(fleet_trace(), "port"))
        return res, ctl.chaos.log(), ctl.chaos.log_signature()

    assert once() == once()


@pytest.mark.parametrize("case", ["zombie", "abort", "slo_shed_all",
                                  "slo_generous"])
def test_fleet_fault_paths_like_jax(setup, fault_free, case):
    """The zombie fenced and rejoined, the transfer abort recovered by
    re-prefill, and SLO shedding: each equal to JAX's run (run_both)."""
    kw = {"zombie": dict(chaos=("hb_loss@6:g3~8", 505)),
          "abort": dict(chaos=("drop@2*12", 404)),
          "slo_shed_all": dict(slo_ttft=1e-9),
          "slo_generous": dict(slo_ttft=1e9)}[case]
    trace = fleet_trace()
    res, ctl, rec = run_both(setup, trace, **CHAOS, **kw)
    robust = ctl.metrics.robust
    kinds = [e.kind for e in ctl.events]
    if case == "slo_shed_all":
        assert res == {} and sorted(ctl.shed) == [r.rid for r in trace]
        assert robust.shed_requests == len(trace)
        assert kinds.count("shed") == len(trace)
        return
    _survived(ctl, res, fault_free)
    if case == "zombie":
        assert "dead" in kinds and "rejoin" in kinds
        assert robust.zombie_rejoins >= 1 and (3, 0) in ctl.fenced
        assert ctl.group(3).generation >= 1
    if case == "abort":
        assert robust.transfer_aborts >= 1 and robust.transfer_retries >= 1
    if case == "slo_generous":
        assert not ctl.shed


def _events(tracer):
    return [(e.ph, e.track, e.name, e.ts, e.tick,
             {k: v for k, v in sorted(e.args.items()) if k != "wall_s"},
             e.eid, e.parent, e.flow_id) for e in tracer.events]


@pytest.mark.parametrize("case", ["forced_flip", "standard_chaos"])
def test_traced_fleet_equals_jax_event_for_event(setup, case):
    kw, kills = {
        "forced_flip": (dict(prefill_classes=["a40", "a40"],
                             decode_classes=["v100"], elastic=True),
                        [(8, 2)]),
        "standard_chaos": (dict(CHAOS, chaos=next(
            (s, d) for n, s, d in chaos_matrix() if n == "standard")),
            [])}[case]
    out = {}
    for pkg, tmod, emod in (("port", obs_trace, export),
                            ("jax", jtrace, jexport)):
        tracer = tmod.Tracer(wall=True)
        with tmod.use(tracer):
            ctl = make_fleets(setup, **kw)[0 if pkg == "port" else 1]
            res = ctl.run(_requests(fleet_trace(), pkg), kills=kills)
        out[pkg] = (res, tracer, emod.to_chrome(tracer,
                                                ticks=ctl.tick_count))
    (res, tr, obj), (jres, jtr, jobj) = out["port"], out["jax"]
    assert res == jres
    got, want = _events(tr), _events(jtr)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: {g} != {w}"
    assert tr.signature() == jtr.signature()
    assert obj["reproIdle"] == jobj["reproIdle"]
    names = {e[2] for e in got}
    assert {"route", "dead", "ticket", "admit", "decode"} <= names
    if case == "forced_flip":
        assert "flip" in names
    else:
        assert any(e[1] == "g3:zombie" for e in got)
    untraced = make_fleets(setup, **kw)[0].run(
        _requests(fleet_trace(), "port"), kills=kills)
    assert untraced == res


def test_driver_refuses_chaos_without_fleet_like_jax(capsys):
    """``--chaos`` without ``--fleet`` is refused by both drivers with one
    line and JAX's message; on the port's driver the standard schedule
    serves (exit 0) and prints its ``chaos:`` line."""
    assert serve_mod.main(["--smoke", "--chaos", "drop", "--device",
                           "cpu"]) == 1
    assert jserve.main(["--smoke", "--chaos", "drop"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 2 and all("--chaos requires --fleet" in e
                                 for e in err)
    assert serve_mod.main(
        ["--arch", "mixtral-w2", "--smoke", "--fleet", "--prefill-groups",
         "a40,a40", "--decode-groups", "v100,v100", "--page-size", "8",
         "--chaos", "drop%0.5*2;corrupt*1;stall*1;hb_loss@6:g3~8",
         "--chaos-seed", "909", "--device", "cpu"]) == 0
    assert "chaos: spec=" in capsys.readouterr().out


def test_driver_sections_equal_jax():
    """The acceptance command line with the standard schedule added: the
    summary has the JAX driver's sections and ``fleet`` and ``chaos``
    keys on the same flags, a group killed and no pool leaking."""
    args = serve_mod.build_parser().parse_args(
        ACCEPT + ["--page-size", "8", "--chaos",
                  "drop%0.5*2;corrupt*1;stall*1;hb_loss@6:g3~8",
                  "--chaos-seed", "909"])
    s = serve_mod.serve_arch("mixtral-w2", args)
    js = jserve.serve_arch("mixtral-w2", args)
    assert s["ok"] and js["ok"] and set(s) == set(js)
    assert set(s["fleet"]) == set(js["fleet"])
    assert set(s["chaos"]) == set(js["chaos"])
    assert s["fleet"]["n_killed"] >= 1 and s["chaos"]["leaked_groups"] == []
