"""repro_torch zebra SPMD engine on two EP ranks against the JAX package
on a 1x2 mesh.

One ``torch.multiprocessing`` spawn of two CPU ranks (gloo, a ``file://``
init method under the test's tmp_path) runs every case of
``make_ep_moe``: replicated mode (every rank the whole batch, half the
experts each, an all-reduce of the partial outputs) and alltoall mode
(the batch split over the ranks, all-to-all dispatch and combine; also
with two dispatch chunks, four combine sub-chunks and two offloaded
experts), at capacity 1.25 with inputs skewed so some experts overflow
(drops). Each rank's loss is its share of the global one
(``torch_parity.ep_rank_worker``), so the gradients of replicated values
(the router, the offloaded experts, replicated-mode x) summed over the
ranks, and of sharded ones (the remote experts, alltoall-mode x) put side
by side, are the global gradients; they, the outputs and the aux losses
are held against ``jax.vjp`` of the JAX package's ``make_ep_moe`` on a
1x2 mesh (its ``shard_map`` transposes), f32, at the tier of
``test_torch_zebra.close``.
"""

import json

import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.core import zebra_spmd as jz
from repro.launch.mesh import make_mesh
from test_torch_zebra import AUX_CT, CFG, close, ffn_arrays, \
    jax_ep_moe_grads
from torch_parity import ep_rank_worker
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

WORLD = 2
CASES = [
    {"name": "replicated", "zcfg": {"mode": "replicated"}},
    {"name": "alltoall", "zcfg": {"mode": "alltoall"}},
    {"name": "alltoall_q2_off2",
     "zcfg": {"mode": "alltoall", "n_chunks": 2, "offload_experts": 2}},
    {"name": "replicated_cf99",
     "zcfg": {"mode": "replicated", "capacity_factor": 99.0}},
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs, and the two ranks' results of every case (one spawn)."""
    tmp = tmp_path_factory.mktemp("ep_ranks")
    T, d = 64, CFG.d_model
    rng = np.random.RandomState(3)
    inputs = dict(ffn_arrays(CFG),
                  x=(rng.randn(T, d) * 0.5 + 0.3).astype(np.float32),
                  ct=rng.randn(T, d).astype(np.float32))
    np.savez(tmp / "in.npz", cases=json.dumps(CASES),
             aux_ct=json.dumps(AUX_CT), **inputs)
    mp.spawn(ep_rank_worker, nprocs=WORLD, join=True,
             args=(WORLD, str(tmp / "init"), str(tmp / "in.npz"), str(tmp)))
    out = {c["name"]: [dict(np.load(tmp / f"{c['name']}_{r}.npz"))
                       for r in range(WORLD)] for c in CASES}
    return inputs, out


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_ep_moe_two_ranks_match_jax_mesh_1x2(ranks, case):
    inputs, out = ranks
    ffn = {k: inputs[k] for k in ("router", "wi_gate", "wi_up", "wo")}
    y, aux, g_ffn, g_x = jax_ep_moe_grads(
        make_mesh((1, WORLD), ("data", "model")),
        jz.ZebraConfig(**case["zcfg"]), ffn, inputs["x"], inputs["ct"])
    per = out[case["name"]]
    if case["zcfg"]["mode"] == "replicated":
        for r in per:  # replicated output; x's gradient summed
            close(r["y"], y, "y")
        close(sum(r["dx"] for r in per), g_x, "x")
    else:  # the batch split over the ranks
        close(np.concatenate([r["y"] for r in per]), y, "y")
        close(np.concatenate([r["dx"] for r in per]), g_x, "x")
    for r in per:
        for k in AUX_CT:
            assert float(r[f"aux_{k}"]) == pytest.approx(aux[k], rel=1e-5)
    for k in ffn:  # each rank's share of every param's gradient, summed
        close(sum(r[f"d_{k}"] for r in per), g_ffn[k], k)
