"""repro_torch expert-parallel decode on two EP ranks against the JAX
package on a 1x2 mesh.

One ``torch.multiprocessing`` spawn of two CPU ranks (gloo, a ``file://``
init method under the test's tmp_path; ``torch_parity.
ep_decode_rank_worker``) runs, on the JAX package's smoke
qwen3-moe-30b-a3b weights under the f32 policy:

* the EP hop ``ep_decode.make_ep_moe_decode`` on layer 0, its experts
  placed by a shuffled placement with each rank holding only its own
  half: decode-sized batches (an odd one, whose stripes are zero-padded;
  the group-dense route) and a prefill-sized one (the packed route of
  the grouped kernels), one and two all-to-all chunks, dead rows masked
  out of the histogram; y (rtol 1e-5, atol 1e-5 * max), the
  counts (exact) and the router losses against the JAX package's hop on
  conftest's 1x2 mesh (its shard_map);
* ``EPContinuousBatchingEngine`` at ep_size 2, dense and paged, and
  paged across a mid-trace re-balance to the reversed shard order: the
  greedy tokens of both ranks equal each other, the JAX package's EP
  engine on the 1x2 mesh (the JAX test's trace) and its replicated
  engine's; the EMA's updates and merged distribution equal JAX's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.launch.mesh import make_mesh
from repro.launch.serve import build_trace as jbuild_trace
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
from repro_torch.pytree import flatten
from torch_parity import ep_decode_rank_worker, jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

WORLD = 2
JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
            moe_impl="gather")
PLACEMENT = ((5, 0, 3, 6), (1, 7, 2, 4))
HOP_CASES = [{"name": "t3_q1", "T": 3, "Q": 1},
             {"name": "t4_q2", "T": 4, "Q": 2},
             {"name": "t200_q2", "T": 200, "Q": 2}]


def _hop_inputs(d):
    """x [T, d] and the live mask of every hop case (the last row dead)."""
    rng = np.random.RandomState(11)
    out = {}
    for c in HOP_CASES:
        out[f"x_{c['name']}"] = rng.randn(c["T"], d).astype(np.float32)
        m = np.ones((c["T"],), np.float32)
        m[-1] = 0.0
        out[f"m_{c['name']}"] = m
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.smoke_config(jreg.get_config("qwen3-moe-30b-a3b"))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    trace = jbuild_trace(seed=0, n=4, rate=0.6, prompt_len=10, gen=8,
                         vocab=jcfg.vocab_size, sampling=JGREEDY)
    return jcfg, jp, trace


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Both ranks' hop outputs and engine runs (one spawn)."""
    jcfg, jp, trace = setup
    tmp = tmp_path_factory.mktemp("ep_decode_ranks")
    flat = {f"p/{k}": v for k, v in flatten(jax_values_np(jp)).items()}
    reqs = [{"rid": r.rid, "prompt": list(r.prompt),
             "gen": r.max_new_tokens, "arrival": r.arrival} for r in trace]
    np.savez(tmp / "in.npz", placement=json.dumps(PLACEMENT),
             hop_cases=json.dumps(HOP_CASES), trace=json.dumps(reqs),
             **_hop_inputs(jcfg.d_model), **flat)
    mp.spawn(ep_decode_rank_worker, nprocs=WORLD, join=True,
             args=(WORLD, str(tmp / "init"), str(tmp / "in.npz"), str(tmp)))
    outs = [dict(np.load(tmp / f"ep_{r}.npz")) for r in range(WORLD)]
    for o in outs:
        o["tokens"] = json.loads(str(o["tokens"]))
    return outs


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("case", HOP_CASES,
                         ids=[c["name"] for c in HOP_CASES])
def test_ep_hop_two_ranks_match_jax_mesh_1x2(setup, ranks, case):
    jcfg, jp, _ = setup
    mesh = make_mesh((1, WORLD), ("data", "model"))
    placed = jepd.place_params(jp, jcfg, PLACEMENT)
    ffn = jax.tree.map(lambda v: v[0], placed["blocks"]["pos0"]["ffn"])
    moe_fn = jepd.make_ep_moe_decode(
        mesh, jcfg, JRUN, jepd.EPDecodeConfig(ep_size=WORLD,
                                              n_chunks=case["Q"]))
    inputs = _hop_inputs(jcfg.d_model)
    y, aux = jax.jit(moe_fn)(ffn, jnp.asarray(inputs[f"x_{case['name']}"]),
                             jnp.asarray(inputs[f"m_{case['name']}"]))
    for r in ranks:
        assert int(r["experts_held"]) == jcfg.n_experts // WORLD
        _close(r[f"y_{case['name']}"], y)
        np.testing.assert_array_equal(r[f"ep_counts_{case['name']}"],
                                      np.asarray(aux["ep_counts"]))
        for k in ("moe_aux_loss", "moe_z_loss"):
            assert float(r[f"{k}_{case['name']}"]) == pytest.approx(
                float(aux[k]), rel=1e-5)


@pytest.fixture(scope="module")
def jax_engines(setup):
    """The JAX package's EP engine at ep_size 2 on the 1x2 mesh (dense and
    paged, the latter also across the re-balance) and its replicated
    engine, on the JAX test's trace."""
    jcfg, jp, trace = setup
    mesh = make_mesh((1, WORLD), ("data", "model"))
    out = {}
    ref = jmake_program(jcfg, make_mesh((1, 1), ("data", "model")), JRUN,
                        n_slots=3, max_len=24)
    from repro.serve import ContinuousBatchingEngine as JEngine
    out["replicated"] = JEngine(ref, jp, JScheduler(3, 24, prefill_chunk=4)
                                ).run(list(trace))
    ep = jepd.EPDecodeConfig(ep_size=WORLD, n_chunks=2)
    for name, kw in (("dense", {}), ("paged", {"page_size": 4})):
        prog = jmake_program(jcfg, mesh, JRUN, n_slots=3, max_len=24, ep=ep,
                             **kw)
        alloc = JBlockAllocator(prog.n_pages, prog.page_size,
                                prog.max_pages) if kw else None
        eng = jepd.EPContinuousBatchingEngine(
            prog, jp, JScheduler(3, 24, prefill_chunk=4, allocator=alloc))
        out[name] = (eng.run(list(trace)), eng.ema)
    return out


@pytest.mark.parametrize("mode", ["dense", "paged", "rebalance"])
def test_ep_engine_two_ranks_match_jax_mesh_1x2(ranks, jax_engines, mode):
    """Greedy tokens of both ranks equal each other, the JAX EP engine's
    and the replicated engine's; across the re-balance too; the EMA as
    JAX's (the re-balance run against JAX's paged run: re-placing moves
    no token, so the histograms are the same)."""
    want, jema = jax_engines["paged" if mode == "rebalance" else mode]
    assert want == jax_engines["replicated"]
    runs = [r["tokens"][mode] for r in ranks]
    for run in runs:
        assert {int(k): v for k, v in run["results"].items()} == want
        assert run["n_rebalances"] == (1 if mode == "rebalance" else 0)
        assert run["experts_held"] == 4
        assert run["ema_updates"] == jema.n_updates > 0
        _close(run["ema_merged"], jema.merged())
    assert runs[0] == runs[1]
