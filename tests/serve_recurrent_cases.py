"""Serving cases of a recurrent arch, held against the JAX package (not a
test module: ``test_torch_serve_recurrent.py`` runs them on smoke
``recurrentgemma-9b``, ``test_torch_serve_recurrent_mamba2.py`` on smoke
``mamba2-2.7b``; each defines the module fixtures ``arch`` and
``jax_driver_modes``).

Both packages run under an f32 ``Policy`` on the JAX weights. Prompts are
longer than the smoke window (32), so recurrentgemma's dense ring wraps and
its paged decode masks by the window; there are more requests than slots,
so slots are recycled. Greedy tokens are exact and every recorded logits
row is within 1e-5 * max|JAX| (``REL``).

The JAX package compiles each engine program once per geometry: the
module fixture memoizes ``repro.serve.engine.make_continuous_program``
(also where the disaggregated controller imported it) for the module's
runs, the JAX package itself unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro.serve import BatchedServer as JBatchedServer
from repro.serve import BlockAllocator as JAllocator
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import engine as jengine
from repro.serve import fleet as jfleet
from repro.serve import make_serve_program as jmake_serve
from repro.serve.disagg import controller as jdisagg_ctl
from repro.serve.disagg import make_disagg as jmake_disagg
from repro.serve.config import ServeConfig as JServeConfig
from repro.serve.config import ServeConfigError as JServeConfigError
from repro.serve.scheduler import Request as JRequest
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (BatchedServer, BlockAllocator,
                               ContinuousBatchingEngine, PagedCfg, Request,
                               Scheduler, ServeConfig,
                               make_continuous_program, make_serve_program)
from repro_torch.serve import fleet
from repro_torch.serve.disagg import make_disagg
from torch_parity import jax_values_np, to_np

JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
            moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
REL = 1e-5
SLOTS, MAX_LEN, PS, CHUNK = 2, 56, 8, 16
TIGHT = 8  # pool pages: 2 slots x 7 pages overcommitted
# (rid, prompt length, new tokens, arrival tick): three prompts beyond the
# smoke window of 32, five requests through two slots; the prompts' last
# chunks (11, 12 and 16 tokens) are those of the driver's trace below, so
# JAX compiles three prefill shapes per program
TRACE = ((0, 43, 6, 0), (1, 12, 8, 0), (2, 44, 5, 1), (3, 48, 7, 3),
         (4, 27, 6, 6))
FLEET = dict(prefill_classes=["a40"], decode_classes=["v100", "v100"],
             decode_slots=SLOTS, max_len=MAX_LEN, page_size=PS,
             prefill_chunk=CHUNK)
STEP_S = 1e-3  # the step time each fleet's straggler detector records


@pytest.fixture(scope="module")
def setup(arch):
    """(jcfg, cfg, JAX params, port params, mesh) on the same weights, with
    the JAX programs memoized per geometry for the module."""
    memo = {}
    make = jengine.make_continuous_program

    def memoized(cfg, mesh, run, **kw):
        # One program per geometry: configs by value, a ``serve_cfg`` by
        # the geometry the JAX function reads from it, and a keyword at
        # its default (None, seed 0) as the keyword left out; so the
        # engines', disagg's, the fleet's and the driver's programs of one
        # geometry are one program.
        sc = kw.pop("serve_cfg", None)
        if sc is not None:
            kw.update(n_slots=sc.slots, max_len=sc.max_len, seed=sc.seed)
            if sc.paged.enabled:
                kw.update(page_size=sc.paged.page_size,
                          n_pages=sc.paged.pool_pages)
        kw = {k: v for k, v in kw.items()
              if v is not None and (k, v) != ("seed", 0)}
        key = (cfg, tuple(mesh.shape.items()), run, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = make(cfg, mesh, run, **kw)
        return memo[key]

    jcfg = jreg.smoke_config(jreg.get_config(arch))
    cfg = registry.smoke_config(registry.get_config(arch))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "make_continuous_program", memoized)
        mp.setattr(jdisagg_ctl, "make_continuous_program", memoized)
        # the JAX driver's policy: f32 compute, this module's JRUN
        mp.setattr(jserve, "Policy", lambda: JRUN.policy)
        yield (jcfg, cfg, jp, params_from_jax(jax_values_np(jp)),
               make_mesh((1, 1), ("data", "model")))


def _close(got, want, rel=REL):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _prompt(seed, n, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, size=(n,)).tolist()


def _requests(pkg, trace=TRACE):
    cls = Request if pkg == "port" else JRequest
    return [cls(rid=rid, prompt=_prompt(100 + rid, n), max_new_tokens=g,
                arrival=float(t)) for rid, n, g, t in trace]


def _engines(setup, *, paged, n_pages=None):
    """The port's and JAX's engines (dense or paged) on the same weights,
    recording logits."""
    jcfg, cfg, jp, tp, mesh = setup
    slots = SLOTS
    sc = ServeConfig(slots=slots, max_len=MAX_LEN, prefill_chunk=CHUNK,
                     paged=PagedCfg(enabled=paged, page_size=PS,
                                    pool_pages=n_pages))
    prog = make_continuous_program(cfg, RUN, sc, device="cpu")
    jkw = dict(page_size=PS, n_pages=n_pages) if paged else {}
    jprog = jengine.make_continuous_program(jcfg, mesh, JRUN, n_slots=slots,
                                            max_len=MAX_LEN, **jkw)
    alloc = BlockAllocator(prog.n_pages, PS, prog.max_pages) \
        if paged else None
    jalloc = JAllocator(jprog.n_pages, PS, jprog.max_pages) \
        if paged else None
    eng = ContinuousBatchingEngine(
        prog, tp, Scheduler(slots, MAX_LEN, prefill_chunk=CHUNK,
                            allocator=alloc), record_logits=True)
    jeng = JEngine(jprog, jp, JScheduler(slots, MAX_LEN, prefill_chunk=CHUNK,
                                         allocator=jalloc),
                   record_logits=True)
    return eng, jeng


def _same_logits(eng, jeng):
    assert sorted(eng.logits) == sorted(jeng.logits)
    for rid, rows in eng.logits.items():
        assert len(rows) == len(jeng.logits[rid])
        for a, b in zip(rows, jeng.logits[rid]):
            _close(a, b)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_equals_jax(setup, paged):
    """The dense (the driver's default) and paged engines on the trace:
    tokens equal JAX's, every logits row within 1e-5 * max of JAX's, every
    request served to its budget, two requests decoding at once."""
    eng, jeng = _engines(setup, paged=paged)
    res = eng.run(_requests("port"))
    assert res == jeng.run(_requests("jax"))
    assert all(len(res[rid]) == g for rid, _, g, _ in TRACE)
    _same_logits(eng, jeng)
    assert eng.metrics.summary()["max_concurrent_active"] == SLOTS
    if paged:
        eng.sched.allocator.check()
        assert eng.sched.allocator.pages_in_use == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_recycled_slot_leaks_no_recurrent_state(setup, paged):
    """Request 0 decodes to its end in slot 0; request 2 arrives later and
    is admitted into the same slot. Request 2's tokens and logits equal a
    fresh engine's (its carry starts from zeros, not from request 0's
    state) and JAX's."""
    trace = (TRACE[0], (2, 44, 5, 20))
    eng, jeng = _engines(setup, paged=paged)
    claims = []
    claim = eng.sched.decode.claim_slot
    eng.sched.decode.claim_slot = lambda: claims.append(claim()) \
        or claims[-1]
    res = eng.run(_requests("port", trace))
    assert claims == [0, 0]
    assert res == jeng.run(_requests("jax", trace))
    _same_logits(eng, jeng)
    fresh, _ = _engines(setup, paged=paged)
    assert fresh.run(_requests("port", trace[1:]))[2] == res[2]
    for a, b in zip(eng.logits[2], fresh.logits[2]):
        np.testing.assert_array_equal(a, b)


def test_paged_preemption_equals_jax(setup):
    """A pool of 8 pages for two slots of up to 7: a request is preempted
    and re-prefilled from a fresh carry; the tokens still equal JAX's on
    the same pool and the untight run's."""
    eng, jeng = _engines(setup, paged=True, n_pages=TIGHT)
    res = eng.run(_requests("port"))
    jres = jeng.run(_requests("jax"))
    assert eng.sched.n_preempted > 0, "pool was not tight enough"
    assert eng.sched.n_preempted == jeng.sched.n_preempted
    assert res == jres
    roomy, _ = _engines(setup, paged=True)
    assert roomy.run(_requests("port")) == res
    eng.sched.allocator.check()


def test_disagg_equals_jax(setup):
    """The disaggregated deployment: the prefill worker's batch-1 carry
    rides the ticket to the decode engine. Tokens and logits equal JAX's
    disagg; the transfer stats equal JAX's field for field (mamba2 ships
    no KV: its transfers carry zero bytes, checksummed as CRC 0)."""
    jcfg, cfg, jp, tp, mesh = setup
    kw = dict(decode_slots=SLOTS, max_len=MAX_LEN, page_size=PS,
              prefill_chunk=CHUNK, record_logits=True)
    ctl = make_disagg(cfg, RUN, tp, device="cpu", **kw)
    jctl = jmake_disagg(jcfg, mesh, JRUN, jp, **kw)
    res = ctl.run(_requests("port"))
    assert res == jctl.run(_requests("jax"))
    _same_logits(ctl.decode, jctl.decode)
    stats = dataclasses.asdict(ctl.transfer.stats)
    assert stats == dataclasses.asdict(jctl.transfer.stats)
    assert stats["n_transfers"] == len(TRACE)
    has_kv = any(s.mixer in ("attn", "local_attn")
                 for s in cfg.layer_layout())
    assert (stats["bytes"] > 0) == has_kv
    ctl.prefill.allocator.check()
    ctl.decode.allocator.check()


def _fixed_step_times(ctl):
    """Record STEP_S for every group step instead of its host-clock time,
    so the router's slow_factor stays 1.0 in both packages."""
    record = ctl.detector.record
    ctl.detector.record = lambda group, _t: record(group, STEP_S)
    return ctl


def test_fleet_with_a_kill_equals_jax(setup):
    """The fleet (one prefill group, two decode groups) with decode group
    g1 killed at tick 8: its requests re-prefill from a fresh carry on the
    survivor. Tokens equal JAX's fleet's and the unkilled fleet's; the
    events and transfer stats equal JAX's; every surviving pool is
    clean."""
    jcfg, cfg, jp, tp, mesh = setup
    ctl = _fixed_step_times(fleet.make_fleet(cfg, RUN, tp, device="cpu",
                                             **FLEET))
    jctl = _fixed_step_times(jfleet.make_fleet(jcfg, mesh, JRUN, jp,
                                               **FLEET))
    res = ctl.run(_requests("port"), kills=[(8, 1)])
    assert res == jctl.run(_requests("jax"), kills=[(8, 1)])
    kinds = [e.kind for e in ctl.events]
    assert "dead" in kinds
    assert kinds == [e.kind for e in jctl.events]
    assert dataclasses.asdict(ctl.transfer.stats) == \
        dataclasses.asdict(jctl.transfer.stats)
    for g in ctl.groups:
        g.worker.allocator.check()
        assert g.worker.allocator.pages_in_use == 0, g.name
    whole = _fixed_step_times(fleet.make_fleet(cfg, RUN, tp, device="cpu",
                                               **FLEET))
    assert whole.run(_requests("port")) == res


def test_lockstep_server_equals_jax(setup):
    """The lockstep ``BatchedServer``: two prompts of 40 (beyond the
    window) prefilled whole, then 6 greedy steps; tokens equal JAX's."""
    jcfg, cfg, jp, tp, mesh = setup
    B, plen, gen = 2, 40, 6
    prompts = np.asarray([_prompt(11, plen), _prompt(12, plen)], np.int32)
    server = BatchedServer(make_serve_program(cfg, RUN, device="cpu"), tp,
                           B, plen + gen)
    got = [server.submit_prefill(prompts)]
    got += [server.step() for _ in range(gen - 1)]
    jprog = jmake_serve(jcfg, mesh, JRUN,
                        JShapeConfig("t", "decode", plen + gen, B),
                        max_len=plen + gen)
    jserver = JBatchedServer(jprog, jp, B, plen + gen)
    jgot = [jserver.submit_prefill(jnp.asarray(prompts))]
    jgot += [jserver.step() for _ in range(gen - 1)]
    np.testing.assert_array_equal(to_np(torch.cat(got, dim=1)),
                                  np.asarray(jnp.concatenate(jgot, 1)))


# The driver's flags of the cases' geometry (max_len = prompt-len + gen =
# MAX_LEN), so the JAX driver runs the programs the cases compiled; its
# trace's prompts are 11, 12, 11 and 43 tokens.
DRIVER = ["--smoke", "--slots", str(SLOTS), "--requests", "4",
          "--prompt-len", "46", "--gen", "10", "--prefill-chunk", str(CHUNK),
          "--page-size", str(PS), "--device", "cpu"]
MODES = {"dense": [], "paged": ["--paged"], "disagg": ["--disagg"],
         "fleet": ["--fleet", "--prefill-groups", "a40", "--decode-groups",
                   "v100,v100"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_driver_serves_each_mode(setup, arch, jax_driver_modes, mode,
                                 capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu`` in each mode exits 0 with its summary line. In the modes of
    ``jax_driver_modes`` its summary has the JAX driver's sections, and
    every key of each, on the same flags (the JAX driver in f32, on the
    programs of the cases above; the port's ``paged`` section adds the
    step counts)."""
    argv = ["--arch", arch] + DRIVER + MODES[mode]
    assert serve_mod.main(argv) == 0
    out = capsys.readouterr().out
    assert f"[serve] arch={arch}-smoke device=cpu 4 requests" in out
    if mode not in jax_driver_modes:
        return
    args = serve_mod.build_parser().parse_args(argv)
    s, js = serve_mod.serve_arch(arch, args), jserve.serve_arch(arch, args)
    assert s["ok"] and js["ok"]
    assert set(s) == set(js)
    for k, v in js.items():
        if isinstance(v, dict):
            assert set(v) <= set(s[k]), k
    assert s["n_generated_tokens"] == js["n_generated_tokens"]


def test_driver_refuses_the_prefix_cache(setup, arch, capsys):
    """``--prefix-cache`` on a recurrent arch exits 1 with the JAX
    package's message: a skipped prefix would corrupt the recurrent
    state."""
    argv = ["--arch", arch] + DRIVER + ["--paged", "--prefix-cache"]
    assert serve_mod.main(argv) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("[serve] invalid "
                                               "configuration:")
    jcfg, _, _, _, mesh = setup
    with pytest.raises(JServeConfigError) as ei:
        JServeConfig.from_args(serve_mod.build_parser().parse_args(argv)) \
            .validate(model_cfg=jreg.get_config(arch), mesh=mesh)
    assert "--prefix-cache needs per-position KV only" in str(ei.value)
    assert err[0].endswith(str(ei.value))
