"""repro_torch's serving mesh at 2x2 (four gloo ranks) against the JAX
package's serving programs on conftest's ``mesh4``: smoke llama3.2-3b and
qwen3-moe-30b-a3b, dense and paged, and llama with an 8-line sliding
window on every other layer, dense, whose 10-token prefill chunks are
longer than the ring and cross its edge. The four slots split over
"data", the dense caches' lines (a ring's too) and the pools' pages over
"model"; every data rank's decode writes reach each copy of a pool. Held as in
``tests/test_torch_serve_mesh.py`` (``torch_parity.check_serve_mesh``).
"""

import pytest

from torch_parity import check_serve_mesh, run_serve_mesh, serve_trace
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

BASE = {"slots": 4, "max_len": 28, "prefill_chunk": 8}
PAGED = {"paged": {"enabled": True, "page_size": 4, "pool_pages": 14}}
CASES = [{"name": f"{mode}_{tag}", "arch": arch, "mesh": [2, 2],
          "sc": dict(BASE, **sc), "trace": serve_trace(arch, 5, seed=7)}
         for tag, arch in (("llama", "llama3.2-3b"),
                           ("moe", "qwen3-moe-30b-a3b"))
         for mode, sc in (("dense", {}), ("paged", PAGED))] + [
    {"name": "ring_dense_llama", "arch": "llama3.2-3b", "mesh": [2, 2],
     "window": 8, "sc": dict(BASE, prefill_chunk=10),
     "trace": serve_trace("llama3.2-3b", 5, seed=7)}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    return run_serve_mesh(tmp_path_factory.mktemp("serve2x2"), mesh4, 4,
                          CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_serve_mesh_2x2_matches_jax(runs, case):
    ref, ranks = runs
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])
