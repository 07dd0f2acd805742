"""repro_torch's observability copies (``repro_torch.obs``) against the JAX
package's ``repro.obs``, and the port driver's ``--trace-out`` against the
JAX driver's.

* The op scripts of ``tests/test_obs.py`` (its ``_run_script`` and
  ``_SCRIPT`` hypothesis strategy: spans, instants, flows and idle marks on
  two tracks over advancing ticks), driven through both packages' tracers,
  give identical ``to_chrome`` JSON, identical ``idle_report``s and
  identical ``signature()``s; on the port's tracer the exported spans are
  well nested, no span is left unclosed, and the idle identity (per tick
  track the buckets sum to ticks - busy) holds exactly.
* ``NullTracer`` is inert; the registry and counters export as in the
  JAX package's ``test_export_embeds_registry_and_counters``.
* ``sim_to_trace`` of the same schedule and ``simulate`` result (each
  package's own simulator, the comm-dominant case of ``tests/test_obs.py``
  at one and four chunks) gives the same events and idle report.
* The drivers: ``--arch mixtral-w1 --smoke --steps 3 --trace-out`` through
  the port (``--device cpu``) and the JAX package, the same weights (the
  JAX init), the same tokens (``--data``: one ``write_token_bin`` file),
  both under ``Policy(compute_dtype=float32)``: the two trace files hold
  the same events in the same order (names, phases, tracks, pids, tids,
  ticks, args), the ``loss`` counters within rtol 2e-5 (the five-step tier
  of ``test_torch_train.py``), the registry snapshot equal but for its
  wall-clock ``ms_per_step`` (masked), the idle report equal, and the
  printed ``[train] zebra-sim:`` and ``[train] idle:`` lines identical.
  Tracing does not touch control flow: the port's losses with
  ``--trace-out`` are bitwise those without it.
"""

import contextlib
import copy
import functools
import io
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import schedule as JS
from repro.core.profiler import LayerTimes as JLayerTimes
from repro.core.simulator import CommTimes as JCommTimes
from repro.core.simulator import simulate as jsimulate
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.obs import export as jexport
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro.obs.zebra import sim_to_trace as jsim_to_trace
from repro.pytree import split_params
from repro_torch.core import schedule as S
from repro_torch.core.profiler import LayerTimes
from repro_torch.core.simulator import CommTimes, simulate
from repro_torch.data import write_token_bin
from repro_torch.launch import train as train_cli
from repro_torch.models.modules import Policy
from repro_torch.obs import export, report
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.zebra import sim_to_trace
from repro_torch.pytree import params_from_jax
from repro_torch.train import step as step_mod
from torch_parity import jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

_TRACKS = ("alpha", "beta")
_OPS = ("advance", "begin", "end", "instant", "flow_queued",
        "flow_step", "flow_finished", "idle")
_SCRIPT = st.lists(st.tuples(st.integers(0, 7),    # op selector
                             st.integers(0, 1),    # track
                             st.integers(0, 5)),   # rid / bucket
                   min_size=0, max_size=120)


def _run_script(trace_mod, script):
    """``tests/test_obs.py``'s interpreter, on ``trace_mod``'s tracer:
    lenient ``end`` (skipped on an empty stack), every span left open
    closed at the end."""
    tr = trace_mod.Tracer()
    tick, depth = 0, {t: 0 for t in _TRACKS}
    for sel, ti, rid in script:
        track = _TRACKS[ti % len(_TRACKS)]
        op = _OPS[sel % len(_OPS)]
        if op == "advance":
            tick += 1
            tr.advance(tick)
        elif op == "begin":
            tr.begin(track, f"work{rid}", rid=rid)
            depth[track] += 1
        elif op == "end":
            if depth[track]:
                tr.end(track)
                depth[track] -= 1
        elif op == "instant":
            tr.instant(track, "note", rid=rid)
        elif op == "idle":
            buckets = trace_mod.IDLE_BUCKETS
            tr.mark_idle(track, buckets[rid % len(buckets)])
        else:
            stage = op[len("flow_"):]
            tr.flow(track, "queued" if stage == "queued" else
                    ("finished" if stage == "finished" else "prefill"), rid)
    for track, n in depth.items():
        for _ in range(n):
            tr.end(track)
    return tr


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)


@settings(max_examples=30, deadline=None)
@given(_SCRIPT)
def test_scripts_export_identically_to_jax(script):
    tr = _run_script(obs_trace, script)
    jt = _run_script(jtrace, script)
    assert tr.signature() == jt.signature()
    assert _dump(export.to_chrome(tr)) == _dump(jexport.to_chrome(jt))
    assert report.idle_report(tr) == jreport.idle_report(jt)
    assert report.format_report(report.idle_report(tr)) == \
        jreport.format_report(jreport.idle_report(jt))


@settings(max_examples=30, deadline=None)
@given(_SCRIPT)
def test_spans_well_nested_and_idle_identity_exact(script):
    tr = _run_script(obs_trace, script)
    obj = export.to_chrome(tr)
    names = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in obj["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    xs = {}
    for e in obj["traceEvents"]:
        if e["ph"] == "X":
            assert "unclosed" not in e["args"]
            xs.setdefault(names[(e["pid"], e["tid"])], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    for track, ivals in xs.items():
        stack = []
        for t0, t1 in sorted(ivals):
            while stack and stack[-1] <= t0:
                stack.pop()
            if stack:
                assert t1 <= stack[-1], (track, t0, t1, stack)
            stack.append(t1)
    for track, r in obj["reproIdle"].items():
        assert sum(r["buckets"].values()) == r["idle"] \
            == r["ticks"] - r["busy"], track
        assert set(r["buckets"]) <= set(obs_trace.IDLE_BUCKETS)
    assert tr.signature() == _run_script(obs_trace, script).signature()


def test_null_tracer_is_inert():
    n = obs_trace.NULL
    assert not n.enabled and obs_trace.TRACER is n
    n.advance(5)
    n.begin("t", "x")
    n.end("t")
    n.flow("t", "queued", 1)
    n.mark_idle("t", "queue-starved")
    ran = []
    with n.span("t", "x"):
        ran.append(True)
    assert ran and n.busy_this_tick("t") is False
    assert report.idle_report(n) == {}
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        assert obs_trace.current() is tr
    assert obs_trace.TRACER is obs_trace.NULL


def test_export_embeds_registry_and_counters():
    objs = []
    for mod, exp in ((obs_trace, export), (jtrace, jexport)):
        tr = mod.Tracer()
        tr.registry.register("unit", lambda: {"answer": 42})
        with mod.use(tr):
            tr.advance(0)
            with tr.span("serve", "work", rid=1):
                tr.flow("serve", "queued", 1)
            tr.count("serve", "queue_depth", 3)
            tr.advance(1)
            tr.mark_idle("serve", "pool-OOM")
        objs.append(exp.to_chrome(tr, ticks=2))
    assert _dump(objs[0]) == _dump(objs[1])
    assert objs[0]["reproCounters"] == {"unit": {"answer": 42}}
    assert objs[0]["reproIdle"]["serve"] == {
        "kind": "tick", "ticks": 2, "busy": 1, "idle": 1,
        "buckets": {"pool-OOM": 1}}


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_sim_to_trace_matches_jax(n_chunks):
    times = dict(t_attn=0.05, t_exp=0.05, t_exp_attn=0.05,
                 t_exp_on_exp=0.05, t_attn_on_exp=0.4)
    sched = S.canonical_schedule(4, 3, n_chunks=n_chunks)
    res = simulate(sched, LayerTimes(**times), CommTimes(1.0, 1.0), 4, 1, 1)
    jsched = JS.canonical_schedule(4, 3, n_chunks=n_chunks)
    jres = jsimulate(jsched, JLayerTimes(**times), JCommTimes(1.0, 1.0),
                     4, 1, 1)
    tr, jt = obs_trace.Tracer(), jtrace.Tracer()
    sim_to_trace(sched, res, tr)
    jsim_to_trace(jsched, jres, jt)
    assert tr.events and tr.signature() == jt.signature()
    assert _dump(export.to_chrome(tr)) == _dump(jexport.to_chrome(jt))
    rep = report.idle_report(tr)
    assert rep == jreport.idle_report(jt)
    assert all(r["_check"] for r in rep.values())


# ---------------------------------------------------------------------------
# The drivers' --trace-out
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "mixtral-w1", "--smoke", "--steps", "3", "--batch", "4",
          "--seq", "32", "--log-every", "1"]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """(port trace, JAX trace, port stdout, JAX stdout, port summaries
    with and without tracing) of the two drivers on the same weights and
    tokens, f32 policy."""
    tmp = tmp_path_factory.mktemp("traces")
    tokens = write_token_bin(str(tmp / "tokens.bin"), 3 * 4 * 32 + 1, 256,
                             seed=3)
    jcfg = jregistry.smoke_config(jregistry.get_config("mixtral-w1"))
    init = jax_values_np(split_params(
        jstack.init_model(jax.random.PRNGKey(0), jcfg))[0])
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrain, "Policy",
                   functools.partial(JPolicy, compute_dtype=jnp.float32))
        mp.setattr(train_cli, "Policy",
                   functools.partial(Policy, compute_dtype=torch.float32))
        mp.setattr(step_mod.TrainProgram, "init_params",
                   lambda self, seed=0: params_from_jax(init))
        argv = DRIVER + ["--data", tokens]
        out = {}
        for name, main, extra in (
                ("jax", jtrain.main, []),
                ("port", train_cli.main, ["--device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(argv + extra + ["--trace-out",
                                            str(tmp / f"{name}.json")]) == 0
            out[name] = buf.getvalue()
        args = train_cli.build_parser().parse_args(argv + ["--device", "cpu"])
        with contextlib.redirect_stdout(io.StringIO()):
            plain = train_cli.train_arch("mixtral-w1", args)
            args.trace_out = str(tmp / "again.json")
            traced = train_cli.train_arch("mixtral-w1", args)
    finally:
        mp.undo()
    load = lambda n: json.loads((tmp / f"{n}.json").read_text())  # noqa
    return load("port"), load("jax"), out["port"], out["jax"], plain, traced


def _masked(obj):
    obj = copy.deepcopy(obj)
    for e in obj["traceEvents"]:
        if e["ph"] == "C" and e["name"] == "loss":
            e["args"]["value"] = None
    obj["reproCounters"]["train"]["ms_per_step"] = None
    obj["reproCounters"]["train"]["loss"] = None
    obj["reproCounters"]["train"]["nll"] = None
    return obj


def test_driver_trace_equals_jax_event_for_event(traces):
    port, jax_obj, _, _, _, _ = traces
    assert len(port["traceEvents"]) == len(jax_obj["traceEvents"]) > 0
    assert _dump(_masked(port)) == _dump(_masked(jax_obj))
    losses = [(e["args"]["value"], j["args"]["value"])
              for e, j in zip(port["traceEvents"], jax_obj["traceEvents"])
              if e["ph"] == "C" and e["name"] == "loss"]
    assert len(losses) == 3
    for got, want in losses:
        assert got == pytest.approx(want, rel=2e-5)
    for k in ("loss", "nll"):
        assert port["reproCounters"]["train"][k] == pytest.approx(
            jax_obj["reproCounters"]["train"][k], rel=2e-5)
    spans = [e["name"] for e in port["traceEvents"]
             if e["ph"] == "X" and e["pid"] == 1]
    assert spans == ["step 0", "step 1", "step 2"]
    assert port["reproIdle"]["train"] == {
        "kind": "tick", "ticks": 3, "busy": 3, "idle": 0, "buckets": {}}


def test_driver_prints_the_jax_drivers_sim_and_idle_lines(traces):
    _, _, port_out, jax_out, _, _ = traces

    def lines(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("[train] zebra-sim:", "[train] idle:",
                                  "[train] trace:"))]

    got = lines(port_out)
    assert got and got == [ln.replace("jax.json", "port.json")
                           for ln in lines(jax_out)]
    assert sum(ln.startswith("[train] zebra-sim:") for ln in got) == 1


def test_tracing_leaves_the_losses_bitwise(traces):
    _, _, _, _, plain, traced = traces
    assert traced["trace"]["events"] > 0 and plain["trace"] is None
    assert [m["loss"] for m in plain["history"]] == \
        [m["loss"] for m in traced["history"]]
    assert [m["grad_norm"] for m in plain["history"]] == \
        [m["grad_norm"] for m in traced["history"]]
    assert obs_trace.TRACER is obs_trace.NULL
