"""repro_torch's serving mesh for recurrentgemma-9b at 2x2 (four gloo
ranks) against the JAX package's serving programs on conftest's
``mesh4``, paged: the four slots over "data", the RG-LRU states' channels
and the local-attention pools' pages over "model"; and with two slots,
as many as the pattern repeats (the tail ``lru`` leaf then keeps every
slot and splits its channels over "data" alone). Held as in
``tests/test_torch_serve_mesh_recurrent.py``.
"""

import numpy as np
import pytest

from torch_parity import (check_serve_mesh, model_cut_leaves,
                          run_serve_mesh, serve_trace)
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

RG = "recurrentgemma-9b"
BASE = {"slots": 4, "max_len": 28, "prefill_chunk": 8}
PAGED = {"paged": {"enabled": True, "page_size": 4, "pool_pages": 14}}
CASES = [{"name": "paged_rgemma", "arch": RG, "mesh": [2, 2],
          "sc": dict(BASE, **PAGED), "trace": serve_trace(RG, 5, seed=19)},
         {"name": "slots_eq_repeats_rgemma", "arch": RG, "mesh": [2, 2],
          "sc": dict(BASE, slots=2, **PAGED),
          "trace": serve_trace(RG, 5, seed=19)}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    return run_serve_mesh(tmp_path_factory.mktemp("serve_rec2x2"), mesh4,
                          4, CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_serve_mesh_recurrent_2x2_matches_jax(runs, case):
    assert model_cut_leaves(case), case["name"]
    ref, ranks = runs
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])


def test_ssd_decode_gathers_y_never_the_ssm_state(tmp_path):
    """One decode step of smoke mamba2-2.7b on a 1x2 mesh (two slots):
    the only state-shaped tensors that cross "model" are each layer's
    ``conv`` block (read whole for the mixer) and the new ``conv`` taps of
    the x channels of the rank's SSD heads (each rank computes its heads:
    the SSD output ``y`` no longer crosses, its ``out_proj`` partial sums
    are all-reduced instead); no ``ssm`` block is gathered. Beside them
    the step's one logits block [B, 1, V / M]; every other gather is a
    weight block (2-dim per layer). The gathered state bytes per decode
    step: L * (conv + its x taps)."""
    import json

    from repro_torch.launch.mesh import launch_ranks
    from repro_torch.models import registry
    from torch_parity import ssd_gather_worker
    cfg = registry.smoke_config(registry.get_config("mamba2-2.7b"))
    B, M, L = 2, 2, cfg.n_layers
    din = cfg.ssm_expand * cfg.d_model
    nh, ns = cfg.ssm_heads, cfg.ssm_state
    hd = din // nh
    conv = [B, cfg.conv_width - 1, (din + 2 * ns) // M]
    x_taps = [B, cfg.conv_width - 1, din // M]
    logits = [B, 1, cfg.vocab_size // M]
    ssm = [B, nh // M, hd, ns]
    launch_ranks(ssd_gather_worker, 2, "cpu", str(tmp_path))
    for r in range(2):
        seen = json.loads((tmp_path / f"gathers_{r}.json").read_text())
        assert [g[0] for g in seen if g[0] == logits] == [logits]
        state = [g for g in seen if len(g[0]) >= 3 and g[0] != logits]
        assert all(len(g[0]) <= 2 for g in seen
                   if g not in state and g[0] != logits)
        assert not [g for g in state if g[0] == ssm]
        assert sorted(map(tuple, (g[0] for g in state))) == sorted(
            [tuple(conv)] * L + [tuple(x_taps)] * L)
        assert all(g[2] == M for g in state)
        got = sum(M * g[3] * int(np.prod(g[0])) for g in state)
        assert got == L * M * 4 * (int(np.prod(conv))
                                   + int(np.prod(x_taps)))
        assert got < L * M * 4 * int(np.prod(ssm))
