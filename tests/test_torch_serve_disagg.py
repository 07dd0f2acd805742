"""repro_torch's disaggregated prefill/decode deployment (``serve/disagg``,
``serve/kv_transfer.py``, ``stack.gather_kv_pages`` /
``scatter_kv_pages``) against the JAX package's.

* The page surgery: gather and scatter over the paged state of smoke
  ``mixtral-w2`` equal the JAX functions on the same pools and ids,
  the padding sentinel (``n_pages``) dropped, a negative id counted from
  the end as JAX counts it.
* The deployment, under an f32 ``Policy`` on the JAX weights (smoke
  ``mixtral-w2``): greedy tokens of the port's disagg equal JAX's disagg
  and JAX's unified paged engine on a Poisson trace; again on a decode
  pool tight enough to preempt and re-prefill; and with the prefix cache
  on the shared-page trace, where the repeat is a full hit that reaches
  decode with no transfer. ``TransferStats`` equal field for field and the
  driver's ``disagg`` section equal the JAX controller's; both allocators
  are checked after every tick; the decode index and pool are clean after
  ``flush()``.
* Stale lines are unreachable after a transfer (the JAX test's one-slot
  pool reused by a second request), and sampled disagg equals sampled
  unified inside the port, with and without preemption.
* The driver: ``--disagg --device cpu`` exits 0 with the sections and
  keys of the JAX driver's summary on the same flags.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.launch.serve import build_trace as jbuild_trace
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro.serve import BlockAllocator as JAllocator
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import GREEDY as JGREEDY
from repro.serve import PrefixCacheCfg as JPrefixCacheCfg
from repro.serve import Scheduler as JScheduler
from repro.serve import make_continuous_program as jmake_program
from repro.serve.disagg import make_disagg as jmake_disagg
from repro.serve.scheduler import Request as JRequest
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (GREEDY, PagedCfg, PrefixCacheCfg, Request,
                               SamplingParams, ServeConfig, build_deployment)
from repro_torch.serve.disagg import make_disagg
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

SLOTS, MAX_LEN, PS, CHUNK = 2, 48, 8, 16
TRACE = dict(seed=5, n=5, rate=0.7, prompt_len=40, gen=8)
TIGHT = 8          # decode pages: 2 slots x 6 pages overcommitted
JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.smoke_config(jreg.get_config("mixtral-w2"))
    cfg = registry.smoke_config(registry.get_config("mixtral-w2"))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    mesh = make_mesh((1, 1), ("data", "model"))
    return jcfg, cfg, jp, params_from_jax(jax_values_np(jp)), mesh


def _trace(req_cls, sampling, vocab, **kw):
    t = serve_mod.build_trace(vocab=vocab, sampling=GREEDY, **{**TRACE,
                                                               **kw})
    return [req_cls(rid=r.rid, prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens, sampling=sampling,
                    arrival=r.arrival) for r in t]


def _jax_disagg(setup, **kw):
    jcfg, _, jp, _, mesh = setup
    return jmake_disagg(jcfg, mesh, JRUN, jp, decode_slots=SLOTS,
                        max_len=MAX_LEN, page_size=PS, prefill_chunk=CHUNK,
                        **kw)


def _port_disagg(setup, **kw):
    _, cfg, _, tp, _ = setup
    return make_disagg(cfg, RUN, tp, decode_slots=SLOTS, max_len=MAX_LEN,
                       page_size=PS, prefill_chunk=CHUNK, device="cpu", **kw)


def _checked(ctl):
    """Run both allocators' ``check()`` after every controller tick."""
    tick = ctl.tick

    def checked_tick():
        tick()
        ctl.prefill.allocator.check()
        ctl.decode.allocator.check()
        if ctl.decode.sched.prefix_index is not None:
            ctl.decode.sched.prefix_index.check()
    ctl.tick = checked_tick
    return ctl


def _stats(ctl):
    return dataclasses.asdict(ctl.transfer.stats)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX package's unified engine, disagg and tight-pool disagg on
    the Poisson trace."""
    jcfg, _, jp, _, mesh = setup
    jtrace = jbuild_trace(vocab=jcfg.vocab_size, sampling=JGREEDY, **TRACE)
    prog = jmake_program(jcfg, mesh, JRUN, n_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PS)
    unified = JEngine(prog, jp, JScheduler(
        SLOTS, MAX_LEN, prefill_chunk=CHUNK,
        allocator=JAllocator(prog.n_pages, prog.page_size, prog.max_pages)))
    out = {"unified": unified.run(list(jtrace))}
    for name, kw in (("ample", {}), ("tight", {"decode_pages": TIGHT})):
        ctl = _jax_disagg(setup, **kw)
        out[name] = (ctl.run(list(jtrace)), _stats(ctl),
                     serve_mod._disagg_summary(ctl, PS))
    return out


def test_gather_scatter_kv_pages_equal_jax(setup):
    jcfg, cfg, *_ = setup
    n_pages = 9
    rng = np.random.RandomState(0)
    jstate = jstack.init_paged_decode_state(jcfg, 2, n_pages, PS,
                                            jnp.float32)
    fill = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                        .astype(np.asarray(x).dtype), jstate)
    jstate = jax.tree.map(jnp.asarray, fill)
    state = stack.init_paged_decode_state(cfg, 2, n_pages, PS,
                                          torch.float32)
    leaves = jax.tree.leaves(fill)
    assert len(leaves) == 3 and state["blocks"] is not None

    def load(tree, src):
        for k, v in tree.items():
            if isinstance(v, dict):
                load(v, src[k])
            else:
                v.copy_(torch.from_numpy(np.asarray(src[k])))
    load(state["blocks"], fill["blocks"])
    src_ids = [4, 0, 8, 4]
    got = stack.gather_kv_pages(state, src_ids)
    want = jstack.gather_kv_pages(jstate, jnp.asarray(src_ids))
    np.testing.assert_array_equal(
        to_np(got["blocks"]["pos0"]["kv"]["k"]),
        np.asarray(want["blocks"]["pos0"]["kv"]["k"]))
    assert tuple(got["blocks"]["pos0"]["kv"]["k"].shape) == \
        (cfg.n_layers, 4, PS, cfg.n_kv_heads, cfg.head_dim)
    dst_ids = [1, n_pages, -1, 3]  # the sentinel dropped, -1 the last
    out = stack.scatter_kv_pages(state, got, dst_ids)
    assert out is state                 # in place
    jout = jstack.scatter_kv_pages(jstate, want, jnp.asarray(dst_ids))
    for k in ("k", "v", "pos"):
        np.testing.assert_array_equal(
            to_np(state["blocks"]["pos0"]["kv"][k]),
            np.asarray(jout["blocks"]["pos0"]["kv"][k]))


def test_disagg_greedy_equals_jax_disagg_and_unified(setup, jax_runs):
    cfg = setup[1]
    ctl = _checked(_port_disagg(setup))
    res = ctl.run(_trace(Request, GREEDY, cfg.vocab_size))
    assert res == jax_runs["unified"] == jax_runs["ample"][0]
    assert _stats(ctl) == jax_runs["ample"][1]
    assert serve_mod._disagg_summary(ctl, PS) == jax_runs["ample"][2]
    st = ctl.transfer.stats
    assert st.n_transfers == TRACE["n"] and not ctl.rejected
    # page-granular payload only: [layers, chunk pages, lines, ...]
    L, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert sorted(st.shipped_shapes) == sorted(
        [(L, 4, PS, kh, hd), (L, 4, PS)])
    assert ctl.prefill.allocator.pages_in_use == 0
    assert ctl.decode.allocator.pages_in_use == 0


def test_disagg_tight_pool_preempts_and_equals_jax(setup, jax_runs):
    cfg = setup[1]
    ctl = _checked(_port_disagg(setup, decode_pages=TIGHT))
    res = ctl.run(_trace(Request, GREEDY, cfg.vocab_size))
    assert ctl.decode.sched.n_preempted > 0, "pool was not tight enough"
    assert res == jax_runs["unified"] == jax_runs["tight"][0]
    assert _stats(ctl) == jax_runs["tight"][1]
    assert serve_mod._disagg_summary(ctl, PS) == jax_runs["tight"][2]
    assert ctl.transfer.stats.n_transfers == \
        TRACE["n"] + ctl.decode.sched.n_preempted  # re-prefills ship again


def _shared_trace(req_cls, vocab):
    rng = np.random.RandomState(3)
    p = rng.randint(0, vocab, size=(12,)).astype(int).tolist()
    q = rng.randint(0, vocab, size=(10,)).astype(int).tolist()
    return [req_cls(rid=0, prompt=list(p), max_new_tokens=6, arrival=0.0),
            req_cls(rid=1, prompt=list(q), max_new_tokens=5, arrival=1.0),
            req_cls(rid=2, prompt=list(p), max_new_tokens=6, arrival=40.0)]


def test_disagg_prefix_full_hit_equals_jax(setup):
    cfg = setup[1]
    jctl = _jax_disagg(setup, prefix=JPrefixCacheCfg(enabled=True))
    want = jctl.run(_shared_trace(JRequest, cfg.vocab_size))
    ctl = _checked(_port_disagg(setup, prefix=PrefixCacheCfg(enabled=True)))
    got = ctl.run(_shared_trace(Request, cfg.vocab_size))
    assert got == want
    off = _port_disagg(setup)
    assert off.run(_shared_trace(Request, cfg.vocab_size)) == got
    assert ctl.n_full_hits == jctl.n_full_hits == 1
    assert ctl.transfer.stats.n_transfers == 2   # the repeat shipped none
    assert _stats(ctl) == _stats(jctl)
    assert serve_mod._disagg_summary(ctl, PS) == \
        serve_mod._disagg_summary(jctl, PS)
    index = ctl.decode.sched.prefix_index
    index.check()
    index.flush()
    ctl.decode.allocator.check()
    assert ctl.decode.allocator.pages_in_use == 0
    assert ctl.prefill.allocator.pages_in_use == 0


def test_stale_lines_unreachable_after_transfer(setup):
    """Serve A then B through the SAME destination pages (a decode pool of
    one sequence): B's tokens and logits match a fresh controller although
    A's stale KV sits beyond B's frontier in the same physical pages."""
    cfg = setup[1]
    rng = np.random.RandomState(21)
    pa = rng.randint(0, cfg.vocab_size, size=(30,)).tolist()
    pb = rng.randint(0, cfg.vocab_size, size=(13,)).tolist()
    kw = dict(decode_slots=1, decode_pages=6, record_logits=True)
    _, _, _, tp, _ = setup
    ctl = make_disagg(cfg, RUN, tp, max_len=MAX_LEN, page_size=PS,
                      prefill_chunk=CHUNK, device="cpu", **kw)
    res = ctl.run([Request(rid=0, prompt=pa, max_new_tokens=4),
                   Request(rid=1, prompt=pb, max_new_tokens=6)])
    assert ctl.decode.allocator.pages_in_use == 0
    fresh = make_disagg(cfg, RUN, tp, max_len=MAX_LEN, page_size=PS,
                        prefill_chunk=CHUNK, device="cpu", **kw)
    res_f = fresh.run([Request(rid=1, prompt=pb, max_new_tokens=6)])
    assert res[1] == res_f[1]
    for a, b in zip(ctl.logits[1], fresh.logits[1]):
        np.testing.assert_array_equal(a, b)


def test_sampled_disagg_equals_sampled_unified(setup):
    """(seed, rid, n) noise: the port's disagg, with and without
    preemption, gives the unified engine's sampled tokens."""
    _, cfg, _, tp, _ = setup
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
    sc = ServeConfig(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                     seed=3, paged=PagedCfg(enabled=True, page_size=PS))
    unified = build_deployment(cfg, RUN, sc, params=tp, device="cpu")
    want = unified.run(_trace(Request, sp, cfg.vocab_size))
    for pages in (None, TIGHT):
        ctl = _port_disagg(setup, decode_pages=pages, seed=3)
        assert ctl.run(_trace(Request, sp, cfg.vocab_size)) == want
        if pages:
            assert ctl.decode.sched.n_preempted > 0
    other = _port_disagg(setup, seed=4)
    assert other.run(_trace(Request, sp, cfg.vocab_size)) != want


def test_make_disagg_refuses_expert_parallel_decode(setup):
    """EP decode over more ranks than the deployment has (two on one) is
    refused with the JAX package's message; EP itself is served
    (``tests/test_torch_serve_ep.py``)."""
    from repro_torch.serve.ep_decode import EPDecodeConfig
    with pytest.raises(ValueError, match="ep_size 2 != mesh axis 'model' "
                                         "size 1"):
        _port_disagg(setup, ep=EPDecodeConfig(ep_size=2))


def test_driver_serves_disagg_with_the_jax_sections(capsys):
    argv = ["--arch", "mixtral-w2", "--smoke", "--disagg", "--requests",
            "3", "--prompt-len", "20", "--gen", "4", "--pool-pages", "5",
            "--device", "cpu"]
    args = serve_mod.build_parser().parse_args(argv)
    s = serve_mod.serve_arch("mixtral-w2", args)
    assert s["ok"]
    assert set(s) == {*serve_mod.ServeMetrics().summary(), "disagg", "ok"}
    assert set(s["disagg"]) == {
        "page_size", "decode_pages", "prefill_pages", "decode_page_peak",
        "n_preempted", "kv_transfers", "kv_pages_shipped",
        "kv_bytes_shipped", "prefix_full_hits"}
    js = jserve.serve_arch("mixtral-w2", args)  # the JAX driver, same flags
    assert js["ok"] and set(js) == set(s)
    assert set(js["disagg"]) == set(s["disagg"])
    assert serve_mod.main(argv) == 0
    assert "[serve] arch=mixtral-w2-smoke disagg: page_size=16 " \
        in capsys.readouterr().out
