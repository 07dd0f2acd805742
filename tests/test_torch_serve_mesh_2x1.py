"""repro_torch's serving mesh at 2x1 (two gloo ranks, the slots split
over "data", nothing over "model") against the JAX package's serving
programs on a 2x1 mesh of conftest's CPU devices: smoke llama3.2-3b and
qwen3-moe-30b-a3b, dense and paged (the pool replicated over "data":
both ranks' decode writes reach each copy), and the disaggregated
deployment. Held as in ``tests/test_torch_serve_mesh.py``
(``torch_parity.check_serve_mesh``); the disaggregated case holds both
workers' pools.
"""

import pytest

from repro.launch.mesh import make_mesh as jmake_mesh
from torch_parity import check_serve_mesh, run_serve_mesh, serve_trace
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

BASE = {"slots": 4, "max_len": 28, "prefill_chunk": 8}
PAGED = {"paged": {"enabled": True, "page_size": 4}}
CASES = [{"name": f"{mode}_{tag}", "arch": arch, "mesh": [2, 1],
          "sc": dict(BASE, **sc), "trace": serve_trace(arch, 5, seed=11)}
         for tag, arch in (("llama", "llama3.2-3b"),
                           ("moe", "qwen3-moe-30b-a3b"))
         for mode, sc in (("dense", {}), ("paged", PAGED))]
CASES.append({"name": "disagg_moe", "arch": "qwen3-moe-30b-a3b",
              "mesh": [2, 1],
              "sc": dict(BASE, disagg={"enabled": True},
                         paged={"page_size": 4, "pool_pages": 10}),
              "trace": serve_trace("qwen3-moe-30b-a3b", 5, seed=11)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_serve_mesh(tmp_path_factory.mktemp("serve2x1"),
                          jmake_mesh((2, 1), ("data", "model")), 2, CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_serve_mesh_2x1_matches_jax(runs, case):
    ref, ranks = runs
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])
