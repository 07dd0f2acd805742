"""repro_torch serving of smoke ``mamba2-2.7b`` (SSD layers only: no KV,
a per-slot SSD state) against the JAX package, through the dense, paged,
disaggregated and fleet engines and the lockstep server: the cases of
``serve_recurrent_cases.py`` (smoke ``recurrentgemma-9b`` runs them in
``test_torch_serve_recurrent.py``).
"""

import pytest

from serve_recurrent_cases import (  # noqa: F401 (fixtures, tests)
    setup, test_disagg_equals_jax, test_driver_refuses_the_prefix_cache,
    test_driver_serves_each_mode, test_engine_equals_jax,
    test_fleet_with_a_kill_equals_jax, test_lockstep_server_equals_jax,
    test_paged_preemption_equals_jax,
    test_recycled_slot_leaks_no_recurrent_state)
from torch_parity import torch_single_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def arch():
    return "mamba2-2.7b"


@pytest.fixture(scope="module")
def jax_driver_modes():
    """The driver's summary is held against the JAX driver's in every
    mode."""
    return ("dense", "paged", "disagg", "fleet")
