"""repro_torch's lockstep server on the serving mesh
(``serve.engine.make_serve_program(mesh=)`` / ``BatchedServer``) on gloo
ranks against the JAX package's ``make_serve_program`` /
``BatchedServer`` on the same mesh of conftest's CPU devices, at 1x2 and
2x1: the cases of ``tests/test_serve_shard_hw.py:32-83`` (smoke
llama3.2-3b and qwen3-moe-30b-a3b at capacity factor 8 generate; the
sharded greedy tokens of llama3.2-3b equal an unsharded full-recompute
decode) and smoke whisper-tiny and llama-3.2-vision-90b with random
fronts and every cross-attention gate at ``torch_parity.XATTN_GATE``.
The batch's rows split over "data" (2x1), the dense caches' lines over
"model" (1x2), merged by log-sum-exp; the MoE through
``zebra_spmd.make_ep_moe`` over the mesh.

Held (``torch_parity.check_lockstep_mesh``): every rank's tokens; the
prefill's last-position logits within 2e-5 * max|logit|; param and KV
block shapes against the JAX shards at the rank's coordinate; KV blocks
within 1e-5 * max on live lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro_torch.core.zebra_mpmd import _unflatten
from torch_parity import check_lockstep_mesh, run_lockstep_mesh
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

GEN = [{"arch": "llama3.2-3b", "batch": 4, "plen": 16, "gen": 6},
       {"arch": "qwen3-moe-30b-a3b", "batch": 4, "plen": 16, "gen": 6,
        "cf": 8.0},
       {"arch": "llama3.2-3b", "batch": 2, "plen": 12, "gen": 5,
        "name": "greedy"},
       {"arch": "whisper-tiny", "batch": 4, "plen": 9, "gen": 6},
       {"arch": "llama-3.2-vision-90b", "batch": 4, "plen": 9, "gen": 6}]


def _cases(shape):
    return [dict(c, name=f"{c.get('name', c['arch'])}_{shape[0]}x"
                 f"{shape[1]}", mesh=list(shape)) for c in GEN]


CASES = {shape: _cases(shape) for shape in ((1, 2), (2, 1))}
IDS = [c["name"] for s in CASES for c in CASES[s]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for shape, cases in CASES.items():
        ref, ranks, inputs = run_lockstep_mesh(
            tmp_path_factory.mktemp(f"lockstep{shape[0]}x{shape[1]}"),
            jmake_mesh(shape, ("data", "model")), 2, cases)
        for c in cases:
            out[c["name"]] = (c, ref[c["name"]], ranks[c["name"]],
                              inputs[c["name"]])
    return out


@pytest.mark.parametrize("name", IDS)
def test_lockstep_mesh_matches_jax(runs, name):
    case, ref, per, _ = runs[name]
    check_lockstep_mesh(case, ref, per)


@pytest.mark.parametrize("shape", list(CASES))
def test_lockstep_mesh_greedy_equals_unsharded_recompute(runs, shape):
    """The sharded greedy tokens equal JAX's unsharded full-recompute
    decode of the same prompts (``tests/test_serve_shard_hw.py:54-83``)."""
    case, _, per, inputs = runs[f"greedy_{shape[0]}x{shape[1]}"]
    cfg = jreg.smoke_config(jreg.get_config(case["arch"]))
    run = JRun(policy=JPolicy(compute_dtype=jnp.float32), moe_impl="gather")
    params = _unflatten({k[2:]: jnp.asarray(v) for k, v in inputs.items()
                         if k.startswith("p|")})
    seq, want = jnp.asarray(inputs["prompts"]), []
    for _ in range(case["gen"]):
        logits, _, _ = jstack.apply_model(params, cfg, run, seq)
        nxt = jnp.argmax(logits[:, -1:], axis=-1)
        want.append(nxt)
        seq = jnp.concatenate([seq, nxt], axis=1)
    want = np.asarray(jnp.concatenate(want, 1))
    assert jax.device_count() >= 2
    for out in per:
        np.testing.assert_array_equal(out["tokens"], want)
