"""repro_torch's serving mesh (``launch/serve.py --mesh``, ``serve.mesh``)
on gloo ranks against the JAX package's serving programs on the same
mesh: smoke llama3.2-3b and qwen3-moe-30b-a3b, dense and paged, at 1x2,
with the prefix cache and fair admission over two tenants, and with
expert-parallel decode over the "model" axis (``--ep-size 2``, dense and
paged), and with an 8-line sliding window on every other layer of
llama, dense (its ring split over "model", the 6-token prefill chunks
crossing the ring's edge) and paged.

One ``launch.mesh.launch_ranks`` of two CPU ranks (a module fixture) runs
every case of ``torch_parity.serve_mesh_worker``; the JAX deployments run
on a 1x2 mesh of conftest's CPU devices beside them, on the same seed-0
JAX weights and the same trace, f32 and greedy. Held
(``torch_parity.check_serve_mesh``): every request's tokens; the f32
first-token logits within 2e-5 * max|logit|; each rank's param, cache and
pool block shapes against the JAX arrays' shards at its mesh coordinate;
each rank's KV block against the JAX state's shard within 1e-5 * max on
the lines whose position is >= 0; each rank's attention heads, FFN width
and vocabulary block against the split the JAX "serve" rules give, and
the weight bytes its steps run on (``torch_parity.check_tp_census``).

A second module fixture runs llama at 1x3 (three ranks), dense and
paged: 4 q heads in blocks of 2, 2 and 0 (the third rank computes no head
and still holds a third of every cache's lines and pool's pages), d_ff
and the vocabulary in blocks of 86, 86 and 84, prefill chunks of 8 in
seq blocks of 3.
"""

import jax.numpy as jnp  # noqa: F401  (conftest's CPU devices first)
import pytest

from repro.launch.mesh import make_mesh as jmake_mesh
from torch_parity import check_serve_mesh, run_serve_mesh, serve_trace
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

MOE, DENSE = "qwen3-moe-30b-a3b", "llama3.2-3b"
BASE = {"slots": 4, "max_len": 28, "prefill_chunk": 8}
PAGED = {"paged": {"enabled": True, "page_size": 4}}


def _case(name, arch, sc, window=0, **trace_kw):
    return {"name": name, "arch": arch, "mesh": [1, 2], "window": window,
            "sc": dict(BASE, **sc),
            "trace": serve_trace(arch, trace_kw.pop("n", 5), **trace_kw)}


CASES = [
    _case("dense_llama", DENSE, {}),
    _case("paged_llama", DENSE, PAGED),
    _case("dense_moe", MOE, {}),
    _case("paged_moe", MOE, dict(PAGED, paged={"enabled": True,
                                               "page_size": 4,
                                               "pool_pages": 12})),
    _case("prefix_fair", DENSE,
          dict(PAGED, prefix={"enabled": True, "fair": True}),
          n=6, tenants=2),
    _case("ep_dense", MOE, {"ep": {"ep_size": 2}}),
    _case("ep_paged", MOE, dict(PAGED, ep={"ep_size": 2})),
    _case("ring_dense", DENSE, {"prefill_chunk": 6}, window=8),
    _case("ring_paged", DENSE, dict(PAGED, prefill_chunk=6), window=8),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_serve_mesh(tmp_path_factory.mktemp("serve1x2"),
                          jmake_mesh((1, 2), ("data", "model")), 2, CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_serve_mesh_1x2_matches_jax(runs, case):
    ref, ranks = runs
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])


CASES_1X3 = [
    {"name": f"{mode}_llama_1x3", "arch": DENSE, "mesh": [1, 3],
     "sc": dict(BASE, max_len=30, **sc),
     "trace": serve_trace(DENSE, 5, seed=11)}
    for mode, sc in (("dense", {}),
                     ("paged", {"paged": {"enabled": True, "page_size": 4,
                                          "pool_pages": 15}}))]


@pytest.fixture(scope="module")
def runs_1x3(tmp_path_factory):
    return run_serve_mesh(tmp_path_factory.mktemp("serve1x3"),
                          jmake_mesh((1, 3), ("data", "model")), 3,
                          CASES_1X3)


@pytest.mark.parametrize("case", CASES_1X3,
                         ids=[c["name"] for c in CASES_1X3])
def test_serve_mesh_1x3_matches_jax(runs_1x3, case):
    ref, ranks = runs_1x3
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])
