"""repro_torch serving of recurrent archs against the JAX package: smoke
``recurrentgemma-9b`` (RG-LRU and local-attention layers) through the
dense, paged, disaggregated and fleet engines and the lockstep server
(the cases of ``serve_recurrent_cases.py``; smoke ``mamba2-2.7b`` runs
them in ``test_torch_serve_recurrent_mamba2.py``), and the KV transfer's
checksum of a payload with and without leaves against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kv_transfer as jkv
from repro_torch.serve import kv_transfer
from serve_recurrent_cases import (  # noqa: F401 (fixtures, tests)
    setup, test_disagg_equals_jax, test_driver_refuses_the_prefix_cache,
    test_driver_serves_each_mode, test_engine_equals_jax,
    test_fleet_with_a_kill_equals_jax, test_lockstep_server_equals_jax,
    test_paged_preemption_equals_jax,
    test_recycled_slot_leaks_no_recurrent_state)
from torch_parity import torch_single_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def arch():
    return "recurrentgemma-9b"


@pytest.fixture(scope="module")
def jax_driver_modes():
    """The modes whose summary is held against the JAX driver's here. Its
    dense and paged builds jit-compile ``init_model`` at every call (about
    10 s each at this smoke size) and their sections do not depend on the
    arch: the mamba2 file holds them."""
    return ("disagg", "fleet")


def test_tree_crc_of_an_empty_payload_is_jax_zero():
    """The KV payload of every mamba2 transfer (SSD layers only) has no
    leaves: its checksum is 0, the CRC of no bytes, in both packages."""
    payload = {"blocks": {"pos0": {}}, "tails": []}
    assert kv_transfer._tree_crc(payload) == jkv._tree_crc(payload) == 0


def test_tree_crc_of_a_payload_equals_jax():
    """A payload with leaves of several dtypes, a stacked block and a
    tail: the port's one-copy CRC equals JAX's leaf-by-leaf chain."""
    rng = np.random.RandomState(0)
    k = rng.randn(2, 3, 8, 1, 4).astype(np.float32)
    pos = rng.randint(-1, 50, size=(3, 8)).astype(np.int32)
    tail = rng.randn(3, 8, 1, 4).astype(np.float32)

    def tree(f):
        return {"blocks": {"pos2": {"kv": {"k": f(k), "pos": f(pos)}}},
                "tails": [{"kv": {"v": f(tail)}}, {}]}
    want = jkv._tree_crc(tree(jnp.asarray))
    assert kv_transfer._tree_crc(tree(torch.from_numpy)) == want != 0
