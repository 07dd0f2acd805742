"""repro_torch expert-parallel decode (``serve/ep_decode.py``, DESIGN.md
§11) at one EP rank against the JAX package, on its smoke
qwen3-moe-30b-a3b weights (``tests/test_serve_ep.py:44-82``) under the
f32 policy: numbers at rtol 1e-5, tokens exact.

* Host functions: ``placement_to_perm`` and ``validate_ep_config``
  (results and rejection messages; the port's EP ranks stand where the
  JAX mesh's "model" axis stands), ``eslot_of``, ``place_params`` leaf for
  leaf (also each rank's slots of a two-rank placement),
  ``balanced_placement``, ``ep_hbm_budget`` at ep_size 1, 2 and 4 and the
  ``RoutingEMA``'s drift.
* The EP hop ``make_ep_moe_decode`` at one rank (every collective the
  identity): y, ``ep_counts`` and the router losses against the JAX hop
  on a 1x1 mesh, decode- and prefill-sized, one and two chunks.
* The engine: greedy tokens of ``EPContinuousBatchingEngine`` (the
  driver's ``planned`` config: two chunks, drift checks every 8 steps),
  dense and paged, equal to the JAX EP engine's and to the port's
  replicated engine's, with the same re-balances, placement and EMA;
  drift-triggered re-balances (checks every 3 steps at threshold 0, a
  hottest-first placer) as often and to the same placement as JAX's; token-exact across an
  explicit mid-trace re-balance.
* ``make_disagg(ep=)``: tokens and the decode worker's EMA as JAX's.
* The driver: ``--ep-size 1 --ep-placement planned`` serves (paged, dense,
  disagg) and prints the ``ep`` section with the JAX driver's keys;
  ``--ep-size 2`` on one device and ``--ep-size`` with ``--fleet`` exit 1
  with the JAX driver's messages.

Two EP ranks: ``tests/test_torch_serve_ep_ranks.py``.
"""

import dataclasses
import types

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
from repro.serve import BlockAllocator as JBlockAllocator
from repro.serve import GREEDY as JGREEDY
from repro.serve import Scheduler as JScheduler
from repro.serve import make_continuous_program as jmake_program
from repro.serve import ep_decode as jepd
from repro.serve.disagg import make_disagg as jmake_disagg
from repro.serve.metrics import RoutingEMA as JRoutingEMA
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, params_from_jax
from repro_torch.serve import (GREEDY, BlockAllocator,
                               ContinuousBatchingEngine, EPCfg, PagedCfg,
                               RoutingEMA, Scheduler, ServeConfig,
                               make_continuous_program)
from repro_torch.serve import ep_decode as epd
from repro_torch.serve.disagg import make_disagg
from repro_torch.sharding.rules import MeshShape
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
            moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
ARCH = "qwen3-moe-30b-a3b"
TRACE = dict(seed=0, n=4, rate=0.6, prompt_len=10, gen=8)


def _planned():
    """The driver's ``--ep-size 1 --ep-placement planned``."""
    return ServeConfig(ep=EPCfg(ep_size=1, placement="planned"))


def _ranks(n, r=0):
    """A stand-in for an ``EPGroup`` of n ranks (validation reads only
    its size; placement its size and rank)."""
    return types.SimpleNamespace(size=n, rank=r)


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.smoke_config(jreg.get_config(ARCH))
    cfg = registry.smoke_config(registry.get_config(ARCH))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    return jcfg, cfg, jp, params_from_jax(jax_values_np(jp))


def _traces(vocab):
    jt = jserve.build_trace(vocab=vocab, sampling=JGREEDY, **TRACE)
    return jt, serve_mod.build_trace(vocab=vocab, sampling=GREEDY, **TRACE)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _message(fn, *args):
    try:
        out = fn(*args)
    except ValueError as e:
        return "raised", str(e)
    return "returned", out


# ---------------------------------------------------------------------------
# Host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement,ep_size", [
    (((0, 2, 4, 6), (1, 3, 5, 7)), 2),
    (((0, 1, 2, 3),), 2),                       # wrong shard count
    (((0, 1, 2), (3, 4, 5, 6, 7)), 2),          # ragged
    (((0, 1, 2, 3), (3, 4, 5, 6)), 2),          # duplicate / missing
    (((7, 6, 5, 4, 3, 2, 1, 0),), 1)])
def test_placement_to_perm_equals_jax(placement, ep_size):
    assert _message(epd.placement_to_perm, placement, 8, ep_size) \
        == _message(jepd.placement_to_perm, placement, 8, ep_size)


@pytest.mark.parametrize("case", ["dense", "truncate", "ranks", "chunks",
                                  "placement", "ok"])
def test_validate_ep_config_equals_jax(models, case):
    """The same rejections, word for word, on the same mesh shape."""
    jcfg, cfg, _, _ = models
    ep, ranks = epd.EPDecodeConfig(ep_size=2), 2
    if case == "dense":
        jcfg = jreg.smoke_config(jreg.get_config("llama3.2-3b"))
        cfg = registry.smoke_config(registry.get_config("llama3.2-3b"))
    elif case == "truncate":
        ep = epd.EPDecodeConfig(ep_size=3)
    elif case == "ranks":
        ranks = 1
    elif case == "chunks":
        ep = epd.EPDecodeConfig(ep_size=2, n_chunks=0)
    elif case == "placement":
        ep = epd.EPDecodeConfig(ep_size=2,
                                placement=((0, 1, 2, 3), (3, 4, 5, 6)))
    jep = jepd.EPDecodeConfig(**ep.__dict__)
    mesh = make_mesh((1, ranks), ("data", "model"))
    got = _message(epd.validate_ep_config, cfg,
                   MeshShape((1, ranks), ("data", "model")), ep)
    assert got == _message(jepd.validate_ep_config, jcfg, mesh, jep)
    assert (got[0] == "returned") == (case == "ok")


@pytest.mark.parametrize("placement", [((0, 2, 4, 6), (1, 3, 5, 7)),
                                       ((5, 0, 3, 6), (1, 7, 2, 4)),
                                       ((3, 1), (0, 6), (7, 2), (5, 4))])
def test_eslot_and_place_params_equal_jax(models, placement):
    """``eslot_of`` and ``place_params`` leaf for leaf (the permuted
    expert stacks, the [L, E] eslot, every other leaf as it was); under n
    ranks each rank holds exactly its slots of the JAX tree."""
    jcfg, cfg, jp, tp = models
    np.testing.assert_array_equal(epd.eslot_of(placement, 8),
                                  jepd.eslot_of(placement, 8))
    want = flatten(jax_values_np(jepd.place_params(jp, jcfg, placement)))
    got = flatten(epd.place_params(tp, cfg, placement))
    assert got.keys() == want.keys()
    for k in want:
        assert to_np(got[k]).dtype == want[k].dtype, k
        np.testing.assert_array_equal(to_np(got[k]), want[k], err_msg=k)
    n = len(placement)
    E_loc = 8 // n
    for r in range(n):
        held = flatten(epd.place_params(tp, cfg, placement, _ranks(n, r)))
        for k in want:
            w = want[k]
            if "ffn/" in k and k.rsplit("/", 1)[-1] in epd.EXPERT_KEYS:
                w = w[:, r * E_loc:(r + 1) * E_loc]
            np.testing.assert_array_equal(to_np(held[k]), w, err_msg=k)


@pytest.mark.parametrize("ep_size,speeds", [(1, None), (2, None),
                                            (4, None), (2, (3.0, 1.0))])
def test_balanced_placement_equals_jax(ep_size, speeds):
    hist = np.random.RandomState(ep_size).dirichlet(np.ones(8) * 0.5)
    assert epd.balanced_placement(hist, ep_size, speeds) \
        == jepd.balanced_placement(hist, ep_size, speeds)


@pytest.mark.parametrize("arch", [ARCH, "mixtral-w2"])
@pytest.mark.parametrize("ep_size", [1, 2, 4])
def test_ep_hbm_budget_equals_jax(arch, ep_size):
    """The full-size configs' byte counts (from the param specs, nothing
    allocated) and pool pages equal the JAX package's (its abstract param
    tree)."""
    kw = dict(hbm_bytes=80 * 2 ** 30, ep_size=ep_size, page_size=16)
    got = epd.ep_hbm_budget(registry.get_config(arch), **kw)
    assert got == jepd.ep_hbm_budget(jreg.get_config(arch), **kw)
    assert got["hbm_reduction"] >= ep_size


def test_routing_ema_drift_equals_jax():
    rng = np.random.RandomState(5)
    ema, jema = RoutingEMA(8, decay=0.9), JRoutingEMA(8, decay=0.9)
    ref = np.full(8, 1.0 / 8)
    for step in range(12):
        counts = rng.poisson(3.0 * (1 + np.arange(8) % 3), (2, 8))
        if step == 4:
            counts[1] = 0  # a layer with no live copies keeps its EMA
        ema.update(counts.astype(np.float32))
        jema.update(counts.astype(np.float32))
        assert ema.drift(ref) == jema.drift(ref)
    np.testing.assert_array_equal(ema.merged(), jema.merged())
    assert ema.n_updates == jema.n_updates == 12 and ema.drift(ref) > 0.05


# ---------------------------------------------------------------------------
# The EP hop at one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,Q", [(3, 1), (4, 2), (160, 2)])
def test_ep_hop_one_rank_equals_jax_mesh_1x1(models, T, Q):
    """Decode-sized batches take the group-dense route, the 160-token one
    the packed route of the grouped kernels; the last row is dead."""
    jcfg, cfg, jp, tp = models
    placement = ((5, 0, 3, 6, 1, 7, 2, 4),)
    rng = np.random.RandomState(T)
    x = rng.randn(T, jcfg.d_model).astype(np.float32)
    m = np.ones((T,), np.float32)
    m[-1] = 0.0
    jffn = jax.tree.map(lambda v: v[1], jepd.place_params(
        jp, jcfg, placement)["blocks"]["pos0"]["ffn"])
    jfn = jepd.make_ep_moe_decode(make_mesh((1, 1), ("data", "model")),
                                  jcfg, JRUN,
                                  jepd.EPDecodeConfig(ep_size=1, n_chunks=Q))
    y, aux = jax.jit(jfn)(jffn, jnp.asarray(x), jnp.asarray(m))
    ffn = {k: v[1] for k, v in epd.place_params(
        tp, cfg, placement)["blocks"]["pos0"]["ffn"].items()}
    fn = epd.make_ep_moe_decode(cfg, RUN,
                                epd.EPDecodeConfig(ep_size=1, n_chunks=Q))
    with torch.inference_mode():
        got, gaux = fn(ffn, torch.from_numpy(x), torch.from_numpy(m))
    _close(got, y)
    np.testing.assert_array_equal(to_np(gaux["ep_counts"]),
                                  np.asarray(aux["ep_counts"]))
    assert float(gaux["ep_counts"].sum()) == (T - 1) * cfg.top_k
    for k in ("moe_aux_loss", "moe_z_loss"):
        assert float(gaux[k]) == pytest.approx(float(aux[k]), rel=1e-5)


# ---------------------------------------------------------------------------
# The engine at one rank
# ---------------------------------------------------------------------------

def _hot_first(hist):
    """A one-rank placer that moves something: the slot order by routed
    share, hottest first (``balanced_placement`` keeps one shard's order
    by id)."""
    return (tuple(int(e) for e in np.argsort(-np.asarray(hist),
                                             kind="stable")),)


def _serve_cfg(paged):
    return ServeConfig(slots=3, max_len=24, prefill_chunk=4,
                       paged=PagedCfg(enabled=paged, page_size=4))


def _port_engine(models, paged, ep, cls=epd.EPContinuousBatchingEngine,
                 **kw):
    _, cfg, _, tp = models
    prog = make_continuous_program(cfg, RUN, _serve_cfg(paged),
                                   device="cpu", ep=ep)
    alloc = BlockAllocator(prog.n_pages, prog.page_size,
                           prog.max_pages) if paged else None
    return cls(prog, tp, Scheduler(3, 24, prefill_chunk=4, allocator=alloc),
               **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX EP engine, the driver's planned config at one rank, dense
    and paged, on the JAX test's trace; its disaggregated deployment with
    EP."""
    jcfg, _, jp, _ = models
    mesh = make_mesh((1, 1), ("data", "model"))
    ep = jepd.EPDecodeConfig(**_planned().ep_decode_config().__dict__)
    trace, _ = _traces(jcfg.vocab_size)
    out = {}
    for name, kw in (("dense", {}), ("paged", {"page_size": 4})):
        prog = jmake_program(jcfg, mesh, JRUN, n_slots=3, max_len=24, ep=ep,
                             **kw)
        alloc = JBlockAllocator(prog.n_pages, prog.page_size,
                                prog.max_pages) if kw else None
        eng = jepd.EPContinuousBatchingEngine(
            prog, jp, JScheduler(3, 24, prefill_chunk=4, allocator=alloc))
        out[name] = eng, eng.run(list(trace))
    # drift checks every 3 steps at threshold 0 (the same jitted steps)
    eng = jepd.EPContinuousBatchingEngine(
        dataclasses.replace(prog, ep=dataclasses.replace(
            ep, rebalance_every=3, drift_threshold=0.0)), jp,
        JScheduler(3, 24, prefill_chunk=4, allocator=JBlockAllocator(
            prog.n_pages, prog.page_size, prog.max_pages)),
        placer=_hot_first)
    out["drift"] = eng, eng.run(list(trace))
    ctl = jmake_disagg(jcfg, mesh, JRUN, jp, decode_slots=3, max_len=24,
                       page_size=4, prefill_chunk=4,
                       ep=jepd.EPDecodeConfig(ep_size=1, n_chunks=2))
    out["disagg"] = ctl, ctl.run(list(trace))
    return out


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_ep_engine_equals_jax_and_replicated(models, jax_runs, mode):
    """The driver's planned EP engine: greedy tokens equal the JAX EP
    engine's and the replicated engine's; the same drift-triggered
    re-balances to the same placement; the EMA as JAX's."""
    _, cfg, _, _ = models
    jeng, want = jax_runs[mode]
    paged = mode == "paged"
    eng = _port_engine(models, paged, _planned().ep_decode_config())
    _, trace = _traces(cfg.vocab_size)
    assert eng.run(list(trace)) == want
    ref = _port_engine(models, paged, None, cls=ContinuousBatchingEngine)
    assert ref.run(list(trace)) == want
    assert eng.n_rebalances == jeng.n_rebalances
    assert eng.placement == jeng.placement
    assert eng.ema.n_updates == jeng.ema.n_updates == eng.n_decode_steps
    _close(eng.ema.merged(), jeng.ema.merged())
    ffn = eng.params["blocks"]["pos0"]["ffn"]
    np.testing.assert_array_equal(
        to_np(ffn["eslot"][0]), epd.eslot_of(eng.placement, 8))
    if paged:
        eng.sched.allocator.check()
        assert eng.sched.allocator.pages_in_use == 0


def test_ep_engine_drift_rebalances_as_jax(models, jax_runs):
    """Drift checks every 3 decode steps at threshold 0: the EMA drifts
    and the placer re-places the experts mid-trace, as often and to the
    same placement as in the JAX engine, and the tokens stay the JAX EP
    engine's."""
    _, cfg, _, _ = models
    jeng, want = jax_runs["drift"]
    eng = _port_engine(models, True, epd.EPDecodeConfig(
        ep_size=1, n_chunks=2, rebalance_every=3, drift_threshold=0.0),
        placer=_hot_first)
    _, trace = _traces(cfg.vocab_size)
    assert eng.run(list(trace)) == want == jax_runs["paged"][1]
    assert eng.n_rebalances == jeng.n_rebalances > 0
    assert eng.placement == jeng.placement
    eng.sched.allocator.check()


def test_ep_engine_token_exact_across_rebalance(models, jax_runs):
    """An explicit re-balance at tick 5 (slots live, pages allocated) to
    the reversed slot order: only the params move; tokens stay the JAX
    EP engine's, the allocator clean."""
    _, cfg, _, _ = models
    eng = _port_engine(models, True, epd.EPDecodeConfig(ep_size=1,
                                                        n_chunks=2))
    _, trace = _traces(cfg.vocab_size)
    pending = sorted(trace, key=lambda r: r.arrival)
    n = 0
    while pending or eng.sched.has_work() or eng._active.any():
        while pending and pending[0].arrival <= eng.tick_count:
            eng.submit(pending.pop(0))
        eng.tick()
        n += 1
        if n == 5:
            assert eng._active.any() and eng.sched.allocator.pages_in_use
            state = eng.state
            assert eng.rebalance((tuple(reversed(eng.placement[0])),))
            assert eng.state is state
            assert not eng.rebalance(eng.placement)  # no move, no count
        assert n < 500
    assert eng.n_rebalances == 1
    assert eng.placement == ((7, 6, 5, 4, 3, 2, 1, 0),)
    assert eng.results == jax_runs["paged"][1]
    eng.sched.allocator.check()


def test_disagg_ep_equals_jax(models, jax_runs):
    """``make_disagg(ep=)``: both programs on the EP hop, the params
    placed once; tokens and the decode worker's EMA as JAX's."""
    _, cfg, _, tp = models
    jctl, want = jax_runs["disagg"]
    ctl = make_disagg(cfg, RUN, tp, decode_slots=3, max_len=24, page_size=4,
                      prefill_chunk=4, device="cpu",
                      ep=epd.EPDecodeConfig(ep_size=1, n_chunks=2))
    _, trace = _traces(cfg.vocab_size)
    assert ctl.run(list(trace)) == want
    assert ctl.prefill.p.ep is not None and ctl.decode.p.ep is not None
    assert "eslot" in ctl.decode.params["blocks"]["pos0"]["ffn"]
    ema, jema = ctl.decode.routing_ema, jctl.decode.routing_ema
    assert ema.n_updates == jema.n_updates > 0
    _close(ema.merged(), jema.merged())
    ctl.prefill.allocator.check()
    ctl.decode.allocator.check()


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "mixtral-w2", "--smoke", "--slots", "2", "--requests",
          "3", "--prompt-len", "24", "--gen", "4", "--prefill-chunk", "8",
          "--ep-size", "1", "--ep-placement", "planned", "--device", "cpu"]


@pytest.mark.parametrize("form", [["--paged"], [], ["--disagg"]],
                         ids=["paged", "dense", "disagg"])
def test_driver_serves_ep_and_prints_its_section(capsys, form):
    assert serve_mod.main(DRIVER + form) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=mixtral-w2-smoke device=cpu 3 requests" in out
    assert "[serve] arch=mixtral-w2-smoke ep: ep_size=1 placement=planned" \
        " rebalances=" in out


def test_driver_ep_section_has_the_jax_keys():
    """The paged form's summary against the JAX driver's on the same
    flags: the same sections, the ``ep`` section's keys, size, placement
    mode and EMA updates (one a decode step)."""
    args = serve_mod.build_parser().parse_args(DRIVER + ["--paged"])
    s = serve_mod.serve_arch("mixtral-w2", args)
    js = jserve.serve_arch("mixtral-w2", args)
    assert s["ok"] and js["ok"] and set(s) == set(js)
    assert set(s["ep"]) == set(js["ep"]) == {
        "ep_size", "placement_mode", "n_rebalances", "ema_updates"}
    for k in ("ep_size", "placement_mode", "ema_updates"):
        assert s["ep"][k] == js["ep"][k], k
    assert s["ep"]["ema_updates"] == s["paged"]["decode_steps"] > 0


@pytest.mark.parametrize("extra,message", [
    (["--ep-size", "2", "--paged"],
     "bad EP config: ep_size 2 != mesh axis 'model' size 1"),
    (["--ep-size", "1", "--fleet"],
     "--ep-size is not supported with --fleet")])
def test_driver_rejects_ep_with_the_jax_messages(capsys, extra, message):
    argv = ["--arch", ARCH, "--smoke", "--requests", "2"] + extra
    assert serve_mod.main(argv + ["--device", "cpu"]) == 1
    assert message in capsys.readouterr().err
    assert jserve.main(argv) == 1
    assert message in capsys.readouterr().err
