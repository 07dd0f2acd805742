"""repro_torch's mesh program (``make_train_program(mesh=)``) on gloo
ranks against the JAX package's ``make_train_program`` on the same mesh.

One ``launch.mesh.launch_ranks`` of four CPU ranks at 2x2, one of two
ranks at 1x2 and one of four at 1x4 (module fixtures) run the cases of
``torch_parity.mesh_train_worker``: smoke mixtral-d2 under zebra
replicated (the "hybrid" rules: attention heads and the vocabulary split
over "model", experts over "model", batch over "data"), zebra alltoall
with two dispatch chunks (and two combine sub-chunks, so the capacity is
padded to 16 rows, not 32, and drops) and two offloaded experts ("ep":
batch over data x model, all-to-all dispatch), ``--no-zebra`` (the
dropless MoE with global router statistics) and zebra replicated with
``accum_steps`` 2, and smoke llama3.2-3b (dense, 2D FSDP weights); at
1x4 zebra replicated again, whose 2 kv heads do not split over "model"
4 (JAX's constrainer leaves a dim smaller than the axis unsplit; the
port computes attention whole on each rank). Capacity 1.25 on a skewed
token file, so the zebra cases drop token copies. The JAX reference runs
on conftest's ``mesh4`` (2x2) and 1x2 and 1x4 meshes of its 8 CPU
devices, with the same init (the JAX package's, each rank keeping its
block) and the same batches, f32. The ranks run beside the JAX
reference (spawned from a thread of the test).

Held: the per-step loss, nll, z-loss, aux losses, grad norm and lr at
rtol 2e-5 (the tier of ``test_torch_train.py``); each rank's block of
every param after five steps against the same block of the JAX params
within 1e-3 * max|leaf| (the one-device port lands 3.0e-4 * max|leaf|
from the JAX package's 1x1 mesh after the same five steps: AdamW's
normalisation amplifies f32 summation-order differences in near-zero
gradients); each rank's param and moment block shapes against the JAX
arrays' shards on the device at its mesh coordinate.
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.zebra_spmd import ZebraConfig as JZebraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import DataLoader as JDataLoader
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import registry as jregistry
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRunConfig
from repro.pytree import tree_map_with_path_names
from repro.train import optimizer as jopt
from repro.train.step import make_train_program as jmake_train_program
from repro_torch.launch.mesh import launch_ranks
from repro_torch.sharding.rules import MeshShape, local_slice
from torch_parity import (MESH_B, MESH_S, MESH_STEPS, mesh_opt_cfg,
                          mesh_train_worker, skewed_token_file)
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

METRICS = ("loss", "nll", "z_loss", "moe_aux_loss", "moe_z_loss",
           "grad_norm", "lr")
REPL = {"mode": "replicated", "num_microbatches": 2}
CASES_2x2 = [
    {"name": "zebra_replicated", "arch": "mixtral-d2", "zcfg": REPL},
    {"name": "zebra_alltoall_q2_off2", "arch": "mixtral-d2",
     "zcfg": {"mode": "alltoall", "num_microbatches": 2, "n_chunks": 2,
              "n_chunks_combine": 2, "offload_experts": 2}},
    {"name": "no_zebra", "arch": "mixtral-d2", "zcfg": None},
    {"name": "accum2", "arch": "mixtral-d2", "zcfg": REPL, "accum": 2},
    {"name": "dense_fsdp", "arch": "llama3.2-3b", "zcfg": None},
]
CASES_1x2 = [{"name": "zebra_replicated_1x2", "arch": "mixtral-d2",
              "zcfg": REPL}]
# 2 kv heads over model 4: attention is not split (each rank computes it
# whole), the vocabulary and the experts are
CASES_1x4 = [{"name": "zebra_replicated_1x4", "arch": "mixtral-d2",
              "zcfg": REPL}]
PARAM_TIER = 1e-3


def flat_names(tree):
    out = {}
    tree_map_with_path_names(lambda n, v: out.__setitem__(n, v), tree)
    return out


def jax_program(case, mesh):
    cfg = jregistry.smoke_config(jregistry.get_config(case["arch"]))
    z = case.get("zcfg")
    run = JRunConfig(policy=JPolicy(compute_dtype=jnp.float32),
                     attn_impl="chunked", moe_impl="gather", remat="full",
                     chunk_q=16, use_gmm_kernel=not cfg.is_moe
                     or z is not None)
    return cfg, jmake_train_program(
        cfg, mesh, run, JShapeConfig("t", "train", MESH_S, MESH_B),
        opt_cfg=mesh_opt_cfg(jopt),
        zcfg=None if z is None else JZebraConfig(capacity_factor=1.25, **z),
        accum_steps=case.get("accum", 1))


def jax_init(case, mesh):
    """The JAX program's seed-0 params, numpy by path."""
    _, prog = jax_program(case, mesh)
    with mesh:
        return {k: np.asarray(v)
                for k, v in flat_names(prog.init_params(seed=0)).items()}


def jax_run(case, mesh, token_file):
    """Five JAX steps of ``case`` on ``mesh``: (init params as numpy by
    path, per-step metrics, final params by path, {path: {coords: shard
    shape}} of the params and of the moments)."""
    cfg, prog = jax_program(case, mesh)
    loader = JDataLoader(JDataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=MESH_S, global_batch=MESH_B,
                                     path=token_file))
    coord = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}

    def shard_shapes(tree):
        return {k: {coord[s.device.id]: tuple(s.data.shape)
                    for s in v.addressable_shards}
                for k, v in flat_names(tree).items()}

    with mesh:
        params = prog.init_params(seed=0)
        init = {k: np.asarray(v) for k, v in flat_names(params).items()}
        shapes = shard_shapes(params)
        state = prog.init_opt(params)
        mu = shard_shapes(state["mu"])
        hist = []
        for _ in range(MESH_STEPS):
            params, state, m = prog.train_step(params, state, next(loader))
            hist.append({k: float(m[k]) for k in METRICS})
        final = {k: np.asarray(v) for k, v in flat_names(params).items()}
    return init, hist, final, shapes, mu


def run_ranks(tmp, world, cases, token_file, inits):
    np.savez(tmp / "in.npz", cases=json.dumps(cases), tokens=token_file,
             **{f"{a}|{k}": v for a, p in inits.items()
                for k, v in p.items()})
    launch_ranks(mesh_train_worker, world, "cpu", str(tmp / "in.npz"),
                 str(tmp))
    return {c["name"]: [dict(np.load(tmp / f"{c['name']}_{r}.npz"))
                        for r in range(world)] for c in cases}


def run_both(tmp, mesh, world, cases, token_file):
    """The port's ranks (spawned from a thread) and the JAX reference (in
    this thread) side by side; ({case: JAX result}, {case: rank outputs})."""
    inits = {}
    for c in cases:
        if c["arch"] not in inits:
            inits[c["arch"]] = jax_init(c, mesh)
    box = {}

    def ranks():
        try:
            box["ranks"] = run_ranks(tmp, world, cases, token_file, inits)
        except BaseException as e:  # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=ranks)
    t.start()
    try:
        ref = {c["name"]: jax_run(c, mesh, token_file) for c in cases}
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    for c in cases:
        assert all(np.array_equal(ref[c["name"]][0][k], v)
                   for k, v in inits[c["arch"]].items())
    return ref, box["ranks"]


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    return skewed_token_file(tmp_path_factory.mktemp("tok") / "tok.bin")


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory, mesh4, token_file):
    return run_both(tmp_path_factory.mktemp("mesh2x2"), mesh4, 4,
                    [dict(c, mesh=[2, 2]) for c in CASES_2x2], token_file)


@pytest.fixture(scope="module")
def runs_1x2(tmp_path_factory, token_file):
    return run_both(tmp_path_factory.mktemp("mesh1x2"),
                    jmake_mesh((1, 2), ("data", "model")), 2,
                    [dict(c, mesh=[1, 2]) for c in CASES_1x2], token_file)


def check_case(case, shape, ref, per):
    init, want, final, shapes, mu = ref
    mesh = MeshShape(shape, ("data", "model"))
    for r, out in enumerate(per):
        got = json.loads(str(out["hist"]))
        for step, (g, w) in enumerate(zip(got, want)):
            for k in METRICS:
                assert g[k] == pytest.approx(w[k], rel=2e-5, abs=1e-9), \
                    (case["name"], r, step, k)
        coord = (r // shape[1], r % shape[1])
        for k, s in json.loads(str(out["shapes"])).items():
            assert tuple(s) == shapes[k][coord], (k, r)
        for k, s in json.loads(str(out["mu_shapes"])).items():
            assert tuple(s) == mu[k][coord], (k, r)
    if case.get("zcfg"):
        assert max(float(o["dropped"]) for o in per) > 0  # drops occurred
    worst = 0.0
    for r, out in enumerate(per):
        specs = json.loads(str(out["specs"]))
        for k, w in final.items():
            spec = tuple(tuple(e) if isinstance(e, list) else e
                         for e in specs[k])
            got, want = out[f"p|{k}"], local_slice(spec, mesh, r, w)
            worst = max(worst, float(np.abs(got - want).max()
                                     / (np.abs(w).max() or 1.0)))
    assert worst < PARAM_TIER, (case["name"], worst)


@pytest.fixture(scope="module")
def runs_1x4(tmp_path_factory, token_file):
    return run_both(tmp_path_factory.mktemp("mesh1x4"),
                    jmake_mesh((1, 4), ("data", "model")), 4,
                    [dict(c, mesh=[1, 4]) for c in CASES_1x4], token_file)


@pytest.mark.parametrize("case", CASES_2x2, ids=[c["name"]
                                                 for c in CASES_2x2])
def test_mesh_2x2_matches_jax(runs_2x2, case):
    ref, ranks = runs_2x2
    check_case(case, (2, 2), ref[case["name"]], ranks[case["name"]])


@pytest.mark.parametrize("case", CASES_1x2, ids=[c["name"]
                                                 for c in CASES_1x2])
def test_mesh_1x2_matches_jax(runs_1x2, case):
    ref, ranks = runs_1x2
    check_case(case, (1, 2), ref[case["name"]], ranks[case["name"]])


@pytest.mark.parametrize("case", CASES_1x4, ids=[c["name"]
                                                 for c in CASES_1x4])
def test_mesh_1x4_matches_jax(runs_1x4, case):
    ref, ranks = runs_1x4
    check_case(case, (1, 4), ref[case["name"]], ranks[case["name"]])
