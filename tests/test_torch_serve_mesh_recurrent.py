"""repro_torch's serving mesh for the recurrent archs at 1x2 (two gloo
ranks) against the JAX package's serving programs on a 1x2 mesh of
conftest's CPU devices: smoke recurrentgemma-9b (RG-LRU and local
attention) and mamba2-2.7b (SSD) in the dense, paged and disaggregated
deployments, and recurrentgemma as a fleet with a kill. Their per-slot
states split by channel over "model" (``serve.mesh.RecurrentBlocks``:
RG-LRU ``conv`` / ``lru`` and the SSD ``conv`` gathered for the mixer,
the SSD ``ssm`` state kept a block of heads).

Held as in ``tests/test_torch_serve_mesh.py``
(``torch_parity.check_serve_mesh``), with every recurrent state block
within 1e-5 * max of the JAX shard; each case cuts at least one
``conv`` / ``lru`` / ``ssm`` leaf over "model".
"""

import pytest

from repro.launch.mesh import make_mesh as jmake_mesh
from torch_parity import (check_serve_mesh, model_cut_leaves,
                          run_serve_mesh, serve_trace)
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

RG, MAMBA = "recurrentgemma-9b", "mamba2-2.7b"
BASE = {"slots": 4, "max_len": 28, "prefill_chunk": 8}
MODES = {"dense": {},
         "paged": {"paged": {"enabled": True, "page_size": 4}},
         "disagg": {"disagg": {"enabled": True},
                    "paged": {"page_size": 4, "pool_pages": 10}}}
CASES = [{"name": f"{mode}_{tag}", "arch": arch, "mesh": [1, 2],
          "sc": dict(BASE, **sc), "trace": serve_trace(arch, 5, seed=13)}
         for tag, arch in (("rgemma", RG), ("mamba2", MAMBA))
         for mode, sc in MODES.items()]
CASES.append(
    {"name": "fleet_kill_rgemma", "arch": RG, "mesh": [1, 2],
     "sc": dict(BASE, paged={"page_size": 4},
                fleet={"enabled": True, "prefill_groups": ["a40", "a40"],
                       "decode_groups": ["v100", "v100"],
                       "kills": [[6, 2]]}),
     "trace": serve_trace(RG, 6, seed=5)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_serve_mesh(tmp_path_factory.mktemp("serve_rec1x2"),
                          jmake_mesh((1, 2), ("data", "model")), 2, CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_serve_mesh_recurrent_1x2_matches_jax(runs, case):
    assert model_cut_leaves(case), case["name"]
    ref, ranks = runs
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])
