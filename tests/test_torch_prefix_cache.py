"""repro_torch's prefix cache (``serve/prefix_index.py``, the scheduler's
prefix-skip and fair admission, the engine's copy-on-write forks) against
the JAX package's.

* ``PrefixIndex`` over a ``BlockAllocator`` in both packages, driven by
  one seeded script of allocate / insert / lookup / evict / free / flush:
  equal lookups, counters, tables and refcounts, ``check()`` clean after
  every op, an empty pool after the final flush.
* Fair admission: ``PrefillScheduler(fair=True)`` picks in the JAX order
  on a flooding-tenant burst and on a seeded multi-tenant queue, and a
  preempted request still resumes first.
* The engine: greedy tokens of the port's prefix engine equal the JAX
  prefix engine's (and the cache-free run's) on the shared-page trace of
  ``tests/test_prefix_cache.py`` (an exact repeat arriving after its twin
  finished, so the registered partial tail page is COW-forked) at smoke
  ``mixtral-w2`` and smoke ``llama3.2-3b``, under an f32 ``Policy`` on the
  JAX weights; ``page_occupancy()`` equal on the JAX keys (hits, skipped
  tokens, COW forks); after ``flush()`` the pool is empty. Then the
  driver's multi-tenant trace (``--tenants 2 --fair``) on smoke
  ``mixtral-w2``: tokens and the ``prefix`` summary equal the JAX
  engine's.
* The driver: ``--paged --prefix-cache --fair --tenants 2 --device cpu``
  exits 0 with the sections and keys of the JAX driver's summary on the
  same flags, and the JAX
  configuration errors (prefix cache without a paged deployment, on a
  recurrent arch, capacity < 1) exit 1 with the JAX messages.
"""

import argparse

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
from repro.pytree import split_params
from repro.serve import PagedCfg as JPagedCfg
from repro.serve import PrefixCacheCfg as JPrefixCacheCfg
from repro.serve import ServeConfig as JServeConfig
from repro.serve import build_deployment as jbuild
from repro.serve.kv_blocks import BlockAllocator as JAllocator
from repro.serve.prefix_index import PrefixIndex as JPrefixIndex
from repro.serve.scheduler import PrefillScheduler as JPrefillScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (PagedCfg, PrefixCacheCfg, Request,
                               ServeConfig, build_deployment)
from repro_torch.serve.kv_blocks import BlockAllocator
from repro_torch.serve.prefix_index import PrefixIndex
from repro_torch.serve.scheduler import PrefillScheduler
from torch_parity import jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

PAGE = 4
JAX_OCC_KEYS = ("page_size", "n_pages", "page_peak",
                "mean_lines_per_active_slot", "n_preempted",
                "pages_allocated", "pages_shared", "n_cow_forks",
                "prefix_hits", "tokens_skipped")


# ---------------------------------------------------------------------------
# The index (host only)
# ---------------------------------------------------------------------------

def _index_script(alloc_cls, index_cls, seed: int, capacity):
    """Seeded ops on one allocator + index; returns every observable."""
    rng = np.random.RandomState(seed)
    a = alloc_cls(24, PAGE, 8)
    idx = index_cls(a, capacity_pages=capacity)
    seqs = [rng.randint(0, 3, size=rng.randint(1, 20)).tolist()
            for _ in range(6)]
    live, out = {}, []
    for step in range(60):
        op = rng.randint(6)
        toks = list(seqs[rng.randint(len(seqs))])
        if rng.randint(2):  # a fresh suffix on a shared prefix
            toks = toks[:rng.randint(len(toks) + 1)] \
                + rng.randint(0, 3, size=rng.randint(1, 6)).tolist()
        rid = int(rng.randint(5))
        if op == 0 and rid not in live:
            ok = a.allocate(rid, len(toks))
            if ok:
                live[rid] = toks
            out.append(("allocate", rid, ok))
        elif op == 1 and rid in live:
            n_valid = int(rng.randint(len(live[rid]) + 1))
            idx.insert(live[rid], a.tables[rid], n_valid=n_valid or None)
            out.append(("insert", rid, n_valid))
        elif op == 2:
            out.append(("lookup", idx.lookup(toks)))
        elif op == 3:
            out.append(("evict", idx.evict(int(rng.randint(1, 4)))))
        elif op == 4 and rid in live:
            a.free(rid)
            del live[rid]
            out.append(("free", rid))
        elif op == 5 and rid not in live:
            pages, n = idx.lookup(toks)
            n = min(n, len(toks) - 1)
            ok = a.share_pages(rid, len(toks), pages if n > 0 else ())
            if ok:
                live[rid] = toks
            out.append(("share", rid, ok))
        idx.check()
        a.check()
        out.append((idx.hits, idx.misses, idx.tokens_served, idx.n_pages,
                    idx.n_evicted, idx.n_inserted, a.n_free,
                    sorted(a.ref.items()),
                    sorted((r, list(t)) for r, t in a.tables.items())))
    for rid in list(live):
        a.free(rid)
    out.append(("flush", idx.flush()))
    idx.check()
    a.check()
    assert a.pages_in_use == 0
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("capacity", [None, 3])
def test_index_script_equals_jax(seed, capacity):
    got = _index_script(BlockAllocator, PrefixIndex, seed, capacity)
    want = _index_script(JAllocator, JPrefixIndex, seed, capacity)
    assert got == want


# ---------------------------------------------------------------------------
# Fair admission (host only)
# ---------------------------------------------------------------------------

def _plan_order(sched_cls, req_cls, fair, submits, resume=None):
    s = sched_cls(64, prefill_chunk=64, fair=fair)
    for rid, tenant in submits:
        s.submit(req_cls(rid=rid, prompt=[1, 2, 3], max_new_tokens=4,
                         tenant=tenant))
    if resume is not None:
        s.requeue_front(req_cls(rid=99, prompt=[1], max_new_tokens=4,
                                tenant=resume), [7, 8])
    order = []
    while s.has_work():
        chunk = s.plan(64, has_slot=lambda: True, claim_slot=lambda: 0)
        assert chunk is not None and chunk.final
        s.finish_chunk(chunk)
        order.append(chunk.request.rid)
    return order


_BURST = [(i, 0) for i in range(4)] + [(4, 1), (5, 2)]
_MIXED = [(i, int(t)) for i, t in
          enumerate(np.random.RandomState(5).randint(0, 3, size=12))]


@pytest.mark.parametrize("submits,resume", [
    (_BURST, None), (_MIXED, None), (_MIXED, 2), (_BURST, 5)],
    ids=["burst", "mixed", "mixed_resume", "burst_resume"])
def test_fair_admission_picks_equal_jax(submits, resume):
    for fair in (False, True):
        got = _plan_order(PrefillScheduler, Request, fair, submits, resume)
        want = _plan_order(JPrefillScheduler, JRequest, fair, submits,
                           resume)
        assert got == want
        if resume is not None:
            assert got[0] == 99  # resume beats fairness
    order = _plan_order(PrefillScheduler, Request, True, _BURST)
    assert order.index(4) <= 2 and order.index(5) <= 2


# ---------------------------------------------------------------------------
# The prefix engine against the JAX one (f32, JAX weights)
# ---------------------------------------------------------------------------

ARCHS = ("mixtral-w2", "llama3.2-3b")
SLOTS, MAX_LEN, PS8, CHUNK = 2, 24, 8, 16


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        jcfg = jreg.smoke_config(jreg.get_config(arch))
        jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
        out[arch] = (jcfg, jp, params_from_jax(jax_values_np(jp)))
    return out


def _shared_trace(req_cls, vocab):
    """``tests/test_prefix_cache.py``'s trace: two exact repeats (12
    tokens: one full 8-line page + a 4-line tail) staggered so the first
    finishes before the second arrives, plus one cold prompt."""
    rng = np.random.RandomState(3)
    p = rng.randint(0, vocab, size=(12,)).astype(int).tolist()
    q = rng.randint(0, vocab, size=(10,)).astype(int).tolist()
    return [req_cls(rid=0, prompt=list(p), max_new_tokens=6, arrival=0.0),
            req_cls(rid=1, prompt=list(q), max_new_tokens=5, arrival=1.0),
            req_cls(rid=2, prompt=list(p), max_new_tokens=6, arrival=40.0)]


def _jax_engine(jcfg, jp, prefix, *, slots=SLOTS, max_len=MAX_LEN,
                page=PS8, chunk=CHUNK, fair=False):
    mesh = make_mesh((1, 1), ("data", "model"))
    run = JRun(policy=JPolicy(compute_dtype=jnp.float32), moe_impl="gather")
    sc = JServeConfig(slots=slots, max_len=max_len, prefill_chunk=chunk,
                      paged=JPagedCfg(enabled=True, page_size=page),
                      prefix=JPrefixCacheCfg(enabled=prefix, fair=fair))
    return jbuild(jcfg, mesh, run, sc, params=jp)


def _port_engine(cfg, tp, prefix, *, slots=SLOTS, max_len=MAX_LEN,
                 page=PS8, chunk=CHUNK, fair=False):
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    sc = ServeConfig(slots=slots, max_len=max_len, prefill_chunk=chunk,
                     paged=PagedCfg(enabled=True, page_size=page),
                     prefix=PrefixCacheCfg(enabled=prefix, fair=fair))
    return build_deployment(cfg, run, sc, params=tp, device="cpu")


def _occ(engine):
    occ = engine.page_occupancy()
    return {k: occ[k] for k in JAX_OCC_KEYS}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_engine_equals_jax_on_the_shared_page_trace(weights, arch):
    jcfg, jp, tp = weights[arch]
    cfg = registry.smoke_config(registry.get_config(arch))
    jeng = _jax_engine(jcfg, jp, True)
    want = jeng.run(_shared_trace(JRequest, cfg.vocab_size))
    eng = _port_engine(cfg, tp, True)
    got = eng.run(_shared_trace(Request, cfg.vocab_size))
    assert got == want
    occ = _occ(eng)
    assert occ == _occ(jeng)
    assert occ["prefix_hits"] >= 1 and occ["tokens_skipped"] >= 8
    assert occ["n_cow_forks"] >= 1      # rid 2 forks rid 0's tail page
    # caching never changes tokens: the cache-free port run agrees
    off = _port_engine(cfg, tp, False)
    assert off.run(_shared_trace(Request, cfg.vocab_size)) == got
    sched = eng.sched
    sched.allocator.check()
    sched.prefix_index.check()
    sched.prefix_index.flush()
    sched.allocator.check()
    assert sched.allocator.pages_in_use == 0


def _tenant_args(**kw):
    a = dict(seed=0, requests=8, tenants=2, rate=0.4, prompt_len=48,
             gen=12, shared_prefix_len=None)
    a.update(kw)
    return argparse.Namespace(**a)


def test_fair_prefix_engine_equals_jax_on_the_tenant_trace(weights):
    jcfg, jp, tp = weights["mixtral-w2"]
    cfg = registry.smoke_config(registry.get_config("mixtral-w2"))
    args = _tenant_args()
    trace = serve_mod.build_tenant_trace(args, cfg.vocab_size,
                                         ServeConfig().sampling)
    jtrace = jserve.build_tenant_trace(args, jcfg.vocab_size,
                                       JServeConfig().sampling)
    assert [(r.prompt, r.tenant, r.arrival) for r in trace] == \
        [(r.prompt, r.tenant, r.arrival) for r in jtrace]
    kw = dict(slots=4, max_len=60, page=16, chunk=16, fair=True)
    jeng = _jax_engine(jcfg, jp, True, **kw)
    want = jeng.run(jtrace)
    eng = _port_engine(cfg, tp, True, **kw)
    assert eng.run(trace) == want
    idx, jidx = eng.sched.prefix_index, jeng.sched.prefix_index
    got = serve_mod._prefix_summary(idx, eng.sched.allocator,
                                    eng.sched.prefill.n_prefix_hits,
                                    eng.sched.prefill.n_tokens_skipped)
    assert got == jserve._prefix_summary(
        jidx, jeng.sched.allocator, jeng.sched.prefill.n_prefix_hits,
        jeng.sched.prefill.n_tokens_skipped)
    assert got["admissions_hit"] >= 1 and got["n_cow_forks"] >= 1
    assert _occ(eng) == _occ(jeng)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

DRIVER_ARGS = ["--arch", "mixtral-w2", "--smoke", "--paged", "--prefix-cache",
               "--fair", "--tenants", "2", "--requests", "4", "--prompt-len",
               "24", "--gen", "4"]


def test_driver_serves_prefix_cache_with_the_jax_sections(capsys):
    args = serve_mod.build_parser().parse_args(DRIVER_ARGS
                                               + ["--device", "cpu"])
    s = serve_mod.serve_arch("mixtral-w2", args)
    assert s["ok"]
    assert set(s) == {*serve_mod.ServeMetrics().summary(), "paged",
                      "prefix", "ok"}
    assert set(s["prefix"]) == {
        "lookups_hit", "lookups_miss", "tokens_served", "admissions_hit",
        "tokens_skipped", "pages_pinned", "pages_evicted",
        "pages_allocated", "pages_shared", "n_cow_forks"}
    assert set(JAX_OCC_KEYS) <= set(s["paged"])
    # the JAX driver on the same flags: the same sections and keys
    js = jserve.serve_arch("mixtral-w2", args)
    assert js["ok"] and set(js) == set(s)
    assert set(js["prefix"]) == set(s["prefix"])
    assert set(js["paged"]) == set(JAX_OCC_KEYS)
    assert serve_mod.main(DRIVER_ARGS + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=mixtral-w2-smoke prefix: hits=" in out
    assert " tenant=0 " in out


@pytest.mark.parametrize("extra,drop,message", [
    (["--prefix-cache"], "--paged",
     "--prefix-cache needs a paged deployment (--paged or --disagg)"),
    (["--prefix-capacity", "0"], None,
     "prefix capacity_pages must be >= 1, got 0"),
    (["--prefill-pool-pages", "0", "--disagg"], None,
     "prefill_pool_pages must be >= 1, got 0"),
    (["--prefix-cache", "--arch", "mamba2-2.7b"], None,
     "--prefix-cache needs per-position KV only; mamba2-2.7b carries "
     "recurrent mixers ['ssd']")])
def test_driver_refuses_the_jax_invalid_combinations(capsys, extra, drop,
                                                     message):
    argv = [a for a in ["--arch", "mixtral-w2", "--smoke", "--paged",
                        "--device", "cpu"] if a != drop] + extra
    assert serve_mod.main(argv) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith(
        "[serve] invalid configuration:")
    assert message in err[0]
