"""repro_torch's dense continuous-batching mode (the JAX serve driver's
default) and its lockstep server against the JAX package, under an f32
``Policy`` on the JAX weights.

The cases of ``tests/test_serve_continuous.py`` run through both
packages and compare greedy tokens and logits (within 1e-5 · max|JAX|):

* the dense cache writes of ``modules.apply_attention``: a per-slot
  vector ``cache_index`` against the scalar, and a dead slot (index -1)
  that writes nothing;
* chunked prefill against whole prefill through the dense program's
  ``prefill_step``, on a linear cache and across a ring's edge on a
  sliding-window config (chunks that cross the edge, and a chunk larger
  than the ring: the JAX package's regression
  ``tests/test_serve_disagg.py:372``);
* the engine: active-mask decode against the lockstep ``BatchedServer``,
  a recycled slot that leaks no KV, a ring wrap, an oversized request
  rejected while the rest serves, and the Poisson MoE acceptance trace.

Then the port's dense engine against its own paged engine on one trace
(f32 first-token logits within 1e-5 · max), and the driver without
``--paged`` on the CPU: exit 0, with the JAX driver's summary sections
and keys on the same flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import modules as jmodules
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro.serve import BatchedServer as JBatchedServer
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import make_continuous_program as jmake_program
from repro.serve import make_serve_program as jmake_serve
from repro.serve.scheduler import Request as JRequest
from repro_torch.launch import serve as serve_mod
from repro_torch.models import modules, registry, stack
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (BatchedServer, ContinuousBatchingEngine,
                               GREEDY, PagedCfg, Request, Scheduler,
                               ServeConfig, build_deployment,
                               make_continuous_program, make_serve_program)
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
            moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab_size=64)
REL = 1e-5


def _configs(name):
    """(JAX ModelConfig, port ModelConfig, init key) of a test model."""
    if name == "tiny":
        return JModelConfig(**TINY), ModelConfig(**TINY), 0
    if name == "tiny-win":
        kw = dict(TINY, name="tiny-win", window=8)
        return (JModelConfig(**kw, pattern=(JLayerSpec(mixer="local_attn"),)),
                ModelConfig(**kw, pattern=(LayerSpec(mixer="local_attn"),)),
                2)
    jcfg = jreg.smoke_config(jreg.get_config(name))
    return jcfg, registry.smoke_config(registry.get_config(name)), 0


@pytest.fixture(scope="module")
def models():
    """name -> (jcfg, cfg, JAX params, port params), on the same weights."""
    out = {}
    for name in ("tiny", "tiny-win", "qwen3-moe-30b-a3b", "mixtral-w2"):
        jcfg, cfg, key = _configs(name)
        jp = split_params(jstack.init_model(jax.random.PRNGKey(key), jcfg))[0]
        out[name] = (jcfg, cfg, jp, params_from_jax(jax_values_np(jp)))
    return out


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _close(got, want, rel=REL):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _prompt(seed, n, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, size=(n,)).tolist()


def _program(cfg, slots, max_len):
    return make_continuous_program(
        cfg, RUN, ServeConfig(slots=slots, max_len=max_len), device="cpu")


# ---------------------------------------------------------------------------
# Dense cache writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["vector_vs_scalar", "inactive_slot"])
def test_dense_cache_writes_equal_jax(case):
    """A per-slot [B] cache_index writes and attends as the scalar does
    when both rows sit at one position; a row at -1 writes nothing. Each
    output and cache equals the JAX package's."""
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jp = split_params(jmodules.init_attention(jax.random.PRNGKey(1),
                                              jcfg))[0]
    p = params_from_jax(jax_values_np(jp))
    x = np.random.RandomState(0).randn(2, 1, cfg.d_model).astype(np.float32)
    rows = [3, 3] if case == "vector_vs_scalar" else [2, -1]
    pos = np.asarray(rows, np.int32)[:, None]

    def port(index):
        cache = modules.init_attention_cache(cfg, 2, 8, 0, torch.float32)
        out, c = modules.apply_attention(
            p, cfg, RUN, torch.from_numpy(x), torch.from_numpy(pos),
            causal=True, cache=cache, cache_index=index)
        assert c is cache  # updated in place
        return out, c

    def jax_(index):
        cache = jmodules.init_attention_cache(jcfg, 2, 8, 0, jnp.float32)
        return jmodules.apply_attention(
            jp, jcfg, JRUN, jnp.asarray(x), jnp.asarray(pos), causal=True,
            cache=cache, cache_index=index)

    out_v, c_v = port(torch.tensor(rows, dtype=torch.int32))
    jout_v, jc_v = jax_(jnp.asarray(rows, jnp.int32))
    _close(out_v, jout_v)
    np.testing.assert_array_equal(to_np(c_v["pos"]), np.asarray(jc_v["pos"]))
    for k in ("k", "v"):
        _close(c_v[k], jc_v[k])
    if case == "vector_vs_scalar":
        out_s, c_s = port(3)
        np.testing.assert_allclose(to_np(out_s), to_np(out_v), atol=1e-6)
        for k in ("k", "v", "pos"):
            np.testing.assert_array_equal(to_np(c_s[k]), to_np(c_v[k]))
    else:
        assert to_np(c_v["pos"][0])[2] == 2  # the live row wrote its line
        np.testing.assert_array_equal(to_np(c_v["pos"][1]), np.full(8, -1))
        assert not to_np(c_v["k"][1]).any()  # the dead row wrote nothing


# ---------------------------------------------------------------------------
# Chunked prefill == whole prefill (linear cache and ring)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,plen,chunks", [
    ("tiny", 13, (13,)), ("tiny", 13, (5, 5, 3)),
    ("tiny-win", 21, (6, 6, 6, 3)), ("tiny-win", 21, (5, 5, 5, 5, 1)),
    ("tiny-win", 21, (13, 8))])
def test_chunked_prefill_equals_whole_and_jax(models, mesh, name, plen,
                                              chunks):
    """The dense program's chunked prefill: the last logits equal the
    cache-free forward's (2e-4, the JAX test's tolerance) and the JAX
    program's on the same chunks (1e-5 · max), and every prefill-state
    leaf equals JAX's. On the window-8 ring the chunks cross its edge
    mid-chunk, and (13, 8) rolls a block larger than the ring into a
    written ring."""
    jcfg, cfg, jp, tp = models[name]
    prompt = np.asarray([_prompt(5 if name == "tiny" else 7, plen)],
                        np.int32)
    prog = _program(cfg, 1, 32)
    jprog = jmake_program(jcfg, mesh, JRUN, n_slots=1, max_len=32)
    ps, jps, off = prog.init_pstate(), jprog.init_pstate(), 0
    params = stack.compute_params(tp, RUN.policy)
    for c in chunks:
        ps, logits = prog.prefill_step(params, ps, prompt[:, off:off + c],
                                       off)
        with mesh:
            jps, jlogits = jprog.prefill_step(
                jp, jps, jnp.asarray(prompt[:, off:off + c]),
                jnp.asarray(off, jnp.int32))
        off += c
    _close(logits, jlogits)
    jleaves = jax.tree.leaves(jps)
    assert len(jleaves) == len(_leaves(ps))
    for a, b in zip(jleaves, _leaves(ps)):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    whole, _, _ = stack.apply_model(tp, cfg, RUN, torch.from_numpy(prompt)
                                    .long())
    np.testing.assert_allclose(to_np(logits), to_np(whole[:, -1]),
                               rtol=2e-4, atol=2e-4)


def _leaves(tree):
    """A decode-state tree's tensors in JAX's pytree order (dict keys
    sorted, the blocks before the tails)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) if tree[k] is not None
                for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# ---------------------------------------------------------------------------
# The engine against JAX
# ---------------------------------------------------------------------------

def _engines(models, mesh, name, slots, max_len, chunk, record=True):
    """The port's and JAX's dense engines on the same weights."""
    jcfg, cfg, jp, tp = models[name]
    eng = ContinuousBatchingEngine(
        _program(cfg, slots, max_len), tp,
        Scheduler(slots, max_len, prefill_chunk=chunk),
        record_logits=record)
    jeng = JEngine(jmake_program(jcfg, mesh, JRUN, n_slots=slots,
                                 max_len=max_len), jp,
                   JScheduler(slots, max_len, prefill_chunk=chunk),
                   record_logits=record)
    return eng, jeng


def _both(trace):
    return ([Request(**r) for r in trace], [JRequest(**r) for r in trace])


def _ref_greedy(cfg, params, prompt, n):
    """Unbatched reference: full recompute each step, greedy."""
    seq, out = list(prompt), []
    for _ in range(n):
        logits, _, _ = stack.apply_model(params, cfg, RUN,
                                         torch.tensor([seq]))
        out.append(int(logits[0, -1].argmax()))
        seq.append(out[-1])
    return out


def _case_lockstep(models, mesh):
    """Active-mask decode against the lockstep server (2 slots, prompts
    of 9, 6 tokens): the continuous engine's tokens equal the port's
    ``BatchedServer``'s, and both equal JAX's."""
    B, plen, gen = 2, 9, 6
    jcfg, cfg, jp, tp = models["tiny"]
    prompts = np.asarray([_prompt(11, plen), _prompt(12, plen)], np.int32)
    server = BatchedServer(make_serve_program(cfg, RUN, device="cpu"), tp,
                           B, plen + gen)
    got = [server.submit_prefill(prompts)]
    got += [server.step() for _ in range(gen - 1)]
    lock = to_np(torch.cat(got, dim=1))
    jprog = jmake_serve(jcfg, mesh, JRUN, JShapeConfig("t", "decode",
                                                       plen + gen, B),
                        max_len=plen + gen)
    jserver = JBatchedServer(jprog, jp, B, plen + gen)
    jgot = [jserver.submit_prefill(jnp.asarray(prompts))]
    jgot += [jserver.step() for _ in range(gen - 1)]
    np.testing.assert_array_equal(lock, np.asarray(jnp.concatenate(jgot,
                                                                   1)))
    eng, jeng = _engines(models, mesh, "tiny", B, plen + gen, plen)
    trace = [dict(rid=b, prompt=prompts[b].tolist(), max_new_tokens=gen)
             for b in range(B)]
    reqs, jreqs = _both(trace)
    res = eng.run(reqs)
    for b in range(B):
        assert res[b] == lock[b].tolist()
    return eng, jeng, res, jeng.run(jreqs)


def _case_recycle(models, mesh):
    """Request A fills slot 0 and finishes, B is admitted into it: B's
    tokens and logits equal a fresh engine's (the insert overwrites every
    line A wrote) and the unbatched reference."""
    jcfg, cfg, jp, tp = models["tiny"]
    trace = [dict(rid=0, prompt=_prompt(21, 10), max_new_tokens=4),
             dict(rid=1, prompt=_prompt(22, 7), max_new_tokens=6)]
    eng, jeng = _engines(models, mesh, "tiny", 1, 24, 6)
    res = eng.run(_both(trace)[0])
    fresh, _ = _engines(models, mesh, "tiny", 1, 24, 6)
    res_f = fresh.run(_both(trace[1:])[0])
    assert res[1] == res_f[1] == _ref_greedy(cfg, tp, trace[1]["prompt"], 6)
    assert len(eng.logits[1]) == len(fresh.logits[1]) == 6
    for a, b in zip(eng.logits[1], fresh.logits[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    return eng, jeng, res, jeng.run(_both(trace)[1])


def _case_ring_wrap(models, mesh):
    """Window 8, chunks of 5 over a 13-token prompt wrap the ring twice;
    the greedy continuation equals the cache-free reference."""
    jcfg, cfg, jp, tp = models["tiny-win"]
    trace = [dict(rid=0, prompt=_prompt(31, 13), max_new_tokens=6)]
    eng, jeng = _engines(models, mesh, "tiny-win", 1, 24, 5)
    res = eng.run(_both(trace)[0])
    assert res[0] == _ref_greedy(cfg, tp, trace[0]["prompt"], 6)
    return eng, jeng, res, jeng.run(_both(trace)[1])


def _case_oversized(models, mesh):
    """An inadmissible request is rejected; the rest of the trace
    serves."""
    trace = [dict(rid=1, prompt=_prompt(42, 20), max_new_tokens=4),
             dict(rid=0, prompt=_prompt(41, 6), max_new_tokens=4)]
    eng, jeng = _engines(models, mesh, "tiny", 1, 16, 8)
    res = eng.run(_both(trace)[0])
    assert eng.rejected == [1] and sorted(res) == [0] and len(res[0]) == 4
    jres = jeng.run(_both(trace)[1])
    assert jeng.rejected == eng.rejected
    return eng, jeng, res, jres


def _case_poisson_moe(models, mesh):
    """The Poisson acceptance trace on the smoke MoE config: every request
    finishes with its budget, a slot is recycled mid-trace, two requests
    decode at once."""
    jcfg, cfg, jp, tp = models["qwen3-moe-30b-a3b"]
    trace = [dict(rid=r.rid, prompt=r.prompt,
                  max_new_tokens=r.max_new_tokens, arrival=r.arrival)
             for r in serve_mod.build_trace(seed=0, n=5, rate=0.6,
                                            prompt_len=16, gen=12,
                                            vocab=cfg.vocab_size,
                                            sampling=GREEDY)]
    eng, jeng = _engines(models, mesh, "qwen3-moe-30b-a3b", 2, 30, 4)
    res = eng.run(_both(trace)[0])
    assert sorted(res) == [r["rid"] for r in trace]
    assert all(len(res[r["rid"]]) == r["max_new_tokens"] for r in trace)
    tr = eng.metrics.requests
    assert any(j.first_token_tick > i.finish_tick for i in tr.values()
               for j in tr.values())
    assert eng.metrics.summary()["max_concurrent_active"] >= 2
    return eng, jeng, res, jeng.run(_both(trace)[1])


ENGINE_CASES = {"lockstep": _case_lockstep, "recycle": _case_recycle,
                "ring_wrap": _case_ring_wrap, "oversized": _case_oversized,
                "poisson_moe": _case_poisson_moe}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_dense_engine_equals_jax(models, mesh, case):
    """Each engine case: the port's greedy tokens equal JAX's, and every
    recorded logits row (the prefill's and each decode step's) is within
    1e-5 · max of JAX's."""
    eng, jeng, res, jres = ENGINE_CASES[case](models, mesh)
    assert res == jres
    assert sorted(eng.logits) == sorted(jeng.logits)
    for rid, rows in eng.logits.items():
        assert len(rows) == len(jeng.logits[rid])
        for a, b in zip(rows, jeng.logits[rid]):
            _close(a, b)
    assert eng.n_decode_steps > 0 and eng.n_prefill_chunks > 0


# ---------------------------------------------------------------------------
# Dense against paged, and the driver
# ---------------------------------------------------------------------------

def test_dense_engine_equals_paged_engine(models):
    """One Poisson trace (smoke mixtral-w2, prompts up to 96, chunks of 96
    so the MoE's packed route runs) through the dense and the paged
    engines: greedy tokens equal, f32 first-token logits within 1e-5 ·
    max. The dense engine has no page machinery."""
    _, cfg, _, tp = models["mixtral-w2"]
    trace = serve_mod.build_trace(seed=4, n=4, rate=0.5, prompt_len=96,
                                  gen=8, vocab=cfg.vocab_size,
                                  sampling=GREEDY)
    out = {}
    for paged in (False, True):
        sc = ServeConfig(slots=2, max_len=104, prefill_chunk=96,
                         paged=PagedCfg(enabled=paged))
        eng = build_deployment(cfg, RUN, sc, params=tp, device="cpu",
                               record_logits=True)
        assert eng.p.paged == paged and (eng.sched.allocator is None) \
            != paged
        out[paged] = (eng.run([Request(rid=r.rid, prompt=list(r.prompt),
                                       max_new_tokens=r.max_new_tokens,
                                       arrival=r.arrival) for r in trace]),
                      eng.logits)
        if not paged:
            with pytest.raises(ValueError, match="paged"):
                eng.page_occupancy()
    (dense, dl), (paged, pl) = out[False], out[True]
    assert dense == paged
    assert all(len(dense[r.rid]) == r.max_new_tokens for r in trace)
    for rid in dense:
        _close(dl[rid][0], pl[rid][0])


DRIVER = ["--arch", "mixtral-w2", "--smoke", "--slots", "2", "--requests",
          "3", "--prompt-len", "24", "--gen", "4", "--prefill-chunk", "8",
          "--device", "cpu"]


def test_driver_serves_dense_without_paged(capsys):
    """Without ``--paged`` the driver serves the dense engine (exit 0) and
    its summary has the JAX driver's sections and keys on the same
    flags: no ``paged`` section."""
    assert serve_mod.main(DRIVER) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=mixtral-w2-smoke device=cpu 3 requests" in out
    assert "paged:" not in out
    args = serve_mod.build_parser().parse_args(DRIVER)
    s = serve_mod.serve_arch("mixtral-w2", args)
    js = jserve.serve_arch("mixtral-w2", args)
    assert s["ok"] and js["ok"]
    assert set(s) == set(js) == {*serve_mod.ServeMetrics().summary(), "ok"}
    assert s["n_generated_tokens"] == js["n_generated_tokens"]
