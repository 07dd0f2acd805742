"""The serving engines' trace hooks in repro_torch against the JAX
package's: a traced port run equals a traced JAX run event for event.

Each case serves one trace through both packages under an f32 ``Policy``
on the JAX weights (smoke ``mixtral-w2``) with a ``Tracer`` installed
(``obs.trace.use``), and compares every event: phase, track, name, tick,
timestamp, args, id, parent and flow id, and the tracers' ``signature()``
(wall-clock readings excluded, as the signature excludes them); then the
exported Chrome JSON's idle report. Cases: the unified paged engine on a
Poisson trace, the same on a pool tight enough to preempt (``pool-OOM``
idle marks and ``preempt`` instants), the prefix engine on the shared-page
trace (``prefix-skip`` instants, ``admitted`` flows with skips), and the
disaggregated deployment (role tracks, the transfer track's chunk spans
and flows, ``transfer-wait`` idle marks), with and without the prefix
cache (``full-hit`` and ``cached-admit``). Tracing leaves the tokens
alone. The driver's ``--trace-out`` writes the artifact, prints the
``[serve] trace:`` and ``[serve] idle:`` lines and gives the sections
and keys of the JAX driver's summary and artifact on the same flags, one
file per arch for the smoke pair.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.obs import export as jexport
from repro.obs import trace as jtrace
from repro.pytree import split_params
from repro.serve import DisaggCfg as JDisaggCfg
from repro.serve import PagedCfg as JPagedCfg
from repro.serve import PrefixCacheCfg as JPrefixCacheCfg
from repro.serve import ServeConfig as JServeConfig
from repro.serve import build_deployment as jbuild
from repro.serve.scheduler import Request as JRequest
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.obs import export
from repro_torch.obs import trace as obs_trace
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (DisaggCfg, GREEDY, PagedCfg, PrefixCacheCfg,
                               Request, ServeConfig, build_deployment)
from torch_parity import jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

SLOTS, MAX_LEN, PS, CHUNK = 2, 48, 8, 16


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.smoke_config(jreg.get_config("mixtral-w2"))
    cfg = registry.smoke_config(registry.get_config("mixtral-w2"))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    return jcfg, cfg, jp, params_from_jax(jax_values_np(jp))


def _poisson(req_cls, vocab):
    t = serve_mod.build_trace(seed=5, n=4, rate=0.7, prompt_len=40, gen=6,
                              vocab=vocab, sampling=GREEDY)
    return [req_cls(rid=r.rid, prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens, arrival=r.arrival)
            for r in t]


def _shared(req_cls, vocab):
    rng = np.random.RandomState(3)
    p = rng.randint(0, vocab, size=(12,)).astype(int).tolist()
    q = rng.randint(0, vocab, size=(10,)).astype(int).tolist()
    return [req_cls(rid=0, prompt=list(p), max_new_tokens=6, arrival=0.0),
            req_cls(rid=1, prompt=list(q), max_new_tokens=5, arrival=1.0),
            req_cls(rid=2, prompt=list(p), max_new_tokens=6, arrival=40.0)]


CASES = {
    "unified": (dict(), _poisson),
    "unified_tight": (dict(pool_pages=8), _poisson),
    "prefix": (dict(prefix=True), _shared),
    "disagg": (dict(disagg=True), _poisson),
    "disagg_tight": (dict(disagg=True, pool_pages=8), _poisson),
    "disagg_prefix": (dict(disagg=True, prefix=True), _shared),
}


def _config(pkg, kw):
    paged, prefix, disagg, sc = (
        (JPagedCfg, JPrefixCacheCfg, JDisaggCfg, JServeConfig) if pkg == "jax"
        else (PagedCfg, PrefixCacheCfg, DisaggCfg, ServeConfig))
    return sc(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
              paged=paged(enabled=not kw.get("disagg", False),
                          page_size=PS, pool_pages=kw.get("pool_pages")),
              prefix=prefix(enabled=kw.get("prefix", False)),
              disagg=disagg(enabled=kw.get("disagg", False)))


def _events(tracer):
    return [(e.ph, e.track, e.name, e.ts, e.tick,
             {k: v for k, v in sorted(e.args.items()) if k != "wall_s"},
             e.eid, e.parent, e.flow_id) for e in tracer.events]


def _traced(setup, pkg, kw, trace_fn, tracing=True):
    jcfg, cfg, jp, tp = setup
    tracer = (jtrace if pkg == "jax" else obs_trace).Tracer(wall=True)
    if pkg == "jax":
        mesh = make_mesh((1, 1), ("data", "model"))
        run = JRun(policy=JPolicy(compute_dtype=jnp.float32),
                   moe_impl="gather")
        with jtrace.use(tracer if tracing else None):
            eng = jbuild(jcfg, mesh, run, _config("jax", kw), params=jp)
            res = eng.run(trace_fn(JRequest, cfg.vocab_size))
        obj = jexport.to_chrome(tracer, ticks=eng.tick_count)
    else:
        run = RunConfig(policy=Policy(compute_dtype=torch.float32))
        with obs_trace.use(tracer if tracing else None):
            eng = build_deployment(cfg, run, _config("port", kw), params=tp,
                                   device="cpu")
            res = eng.run(trace_fn(Request, cfg.vocab_size))
        obj = export.to_chrome(tracer, ticks=eng.tick_count)
    return res, tracer, obj


@pytest.mark.parametrize("case", list(CASES))
def test_traced_run_equals_jax_event_for_event(setup, case):
    kw, trace_fn = CASES[case]
    res, tr, obj = _traced(setup, "port", kw, trace_fn)
    jres, jtr, jobj = _traced(setup, "jax", kw, trace_fn)
    assert res == jres
    got, want = _events(tr), _events(jtr)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: {g} != {w}"
    assert tr.signature() == jtr.signature()
    assert obj["reproIdle"] == jobj["reproIdle"]
    names = {e[2] for e in got}
    if case.startswith("unified"):
        assert {"prefill", "decode", "queued", "finished"} <= names
    if case.endswith("_tight"):
        assert "preempt" in names
    if case == "prefix":
        assert "prefix-skip" in names
    if case.startswith("disagg"):
        assert {"admit", "chunk", "transfer", "ticket"} <= names \
            or case == "disagg_prefix"
    if case == "disagg_prefix":
        assert {"full-hit", "cached-admit"} <= names
    # tracing does not touch control flow
    untraced, _, _ = _traced(setup, "port", kw, trace_fn, tracing=False)
    assert untraced == res


DRIVER = ["--smoke", "--paged", "--requests", "2", "--prompt-len", "16",
          "--gen", "3", "--device", "cpu"]


def test_driver_trace_out_writes_the_artifact(tmp_path, capsys):
    path = tmp_path / "serve.json"
    args = serve_mod.build_parser().parse_args(
        DRIVER + ["--arch", "mixtral-w2", "--trace-out", str(path)])
    s = serve_mod.serve_arch("mixtral-w2", args)
    assert s["ok"]
    assert set(s) == {*serve_mod.ServeMetrics().summary(), "paged", "trace",
                      "ok"}
    obj = json.loads(path.read_text())
    assert s["trace"] == {"path": str(path),
                          "n_events": len(obj["traceEvents"])} \
        and s["trace"]["n_events"] > 0
    assert set(obj["reproCounters"]) == {"serve", "robust"}
    # the JAX driver on the same flags: the same sections and keys
    args.trace_out = str(tmp_path / "jax.json")
    js = jserve.serve_arch("mixtral-w2", args)
    assert js["ok"] and set(js) == set(s) and set(js["trace"]) == \
        set(s["trace"])
    jobj = json.loads((tmp_path / "jax.json").read_text())
    assert set(jobj) == set(obj)
    out = capsys.readouterr().out
    assert f"trace: {s['trace']['n_events']} events -> {path}" in out
    assert "[serve] idle:" in out
    assert obs_trace.TRACER is obs_trace.NULL  # uninstalled after the run


def test_driver_trace_out_one_file_per_arch(tmp_path):
    path = tmp_path / "t.json"
    assert serve_mod.main(DRIVER + ["--trace-out", str(path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "t.llama3.2-3b.json", "t.qwen3-moe-30b-a3b.json"]
