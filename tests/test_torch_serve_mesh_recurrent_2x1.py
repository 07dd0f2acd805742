"""repro_torch's serving mesh for the recurrent archs at 2x1 (two gloo
ranks, the slots split over "data") against the JAX package's serving
programs on a 2x1 mesh of conftest's CPU devices: smoke recurrentgemma-9b
and mamba2-2.7b, dense, paged and disaggregated, and recurrentgemma with
as many slots as its pattern repeats (2): both packages' spec mappers
then read the slot dim of a tail's state leaf as the layer dim, so the
tail ``lru`` leaf keeps every slot on both ranks and splits its channels
over "data" instead, while the decode splits its slots
(``serve.mesh.RecurrentBlocks`` follows each leaf's spec). Held as in
``tests/test_torch_serve_mesh_recurrent.py``.
"""

import pytest

from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch.models import registry
from repro_torch.serve import mesh as serve_mesh
from repro_torch.sharding.rules import MeshShape, rules_for
from torch_parity import check_serve_mesh, run_serve_mesh, serve_trace
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

RG, MAMBA = "recurrentgemma-9b", "mamba2-2.7b"
BASE = {"slots": 4, "max_len": 28, "prefill_chunk": 8}
MODES = {"dense": {},
         "paged": {"paged": {"enabled": True, "page_size": 4}},
         "disagg": {"disagg": {"enabled": True},
                    "paged": {"page_size": 4, "pool_pages": 10}}}
CASES = [{"name": f"{mode}_{tag}", "arch": arch, "mesh": [2, 1],
          "sc": dict(BASE, **sc), "trace": serve_trace(arch, 5, seed=17)}
         for tag, arch in (("rgemma", RG), ("mamba2", MAMBA))
         for mode, sc in MODES.items()]
TRAP = {"name": "slots_eq_repeats_rgemma", "arch": RG, "mesh": [2, 1],
        "sc": dict(BASE, slots=2, paged={"enabled": True, "page_size": 4}),
        "trace": serve_trace(RG, 5, seed=17)}
CASES.append(TRAP)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_serve_mesh(tmp_path_factory.mktemp("serve_rec2x1"),
                          jmake_mesh((2, 1), ("data", "model")), 2, CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_serve_mesh_recurrent_2x1_matches_jax(runs, case):
    ref, ranks = runs
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])


def test_slot_count_equal_to_repeats_misreads_tail_leaves():
    """The case above is the trap: the tail ``lru`` leaf [2, w] is read
    as stacked, so its rows are not cut while the decode's slots are, and
    its channels are cut over "data"."""
    cfg = registry.smoke_config(registry.get_config(RG))
    assert cfg.n_pattern_repeats == TRAP["sc"]["slots"] == 2
    mesh = MeshShape((2, 1), ("data", "model"))
    specs = serve_mesh.decode_state_specs(
        cfg, mesh, rules_for(cfg, mesh, "serve"), 2, 28)
    assert specs["tails/0/rglru/lru"] == (None, "data")
    assert specs["tails/0/rglru/conv"] == (None, None, None)
    assert specs["blocks/pos0/rglru/lru"] == (None, "data", "model")
