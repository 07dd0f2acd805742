"""Checkpoints of repro_torch's mesh program: saved on one mesh, restored
on another, in the JAX package's format; and the driver's ``--mesh``.

Smoke mixtral-d2 without zebra (the dropless MoE with global router
statistics, so the step does not depend on the mesh's shape), f32,
skewed tokens: four gloo ranks at 2x2 train five steps and save a
checkpoint after step 2 (gathered to rank 0); two ranks at 1x2 and one
rank in this process restore it and train steps 3-5. Held: every
restored block equals the same block of the saved array bitwise; steps
3-5 equal the uninterrupted 2x2 run's at rtol 2e-5; the JAX package's
``CheckpointManager.restore`` reads the same checkpoint onto ``mesh4``
bitwise. Then the driver: ``python -m repro_torch.launch.train --smoke
--device cpu --no-zebra --mesh 2x2 --data <file>`` against the same
command at ``--mesh 1x1`` (one process), under an f32 policy, step lines
within rtol 2e-5, one header and one line per step (rank 0 alone
prints).
"""

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.models import registry as jregistry
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRunConfig
from repro.train import optimizer as jopt
from repro.train.step import make_train_program as jmake_train_program
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import launch_ranks
from repro_torch.pytree import flatten
from repro_torch.sharding.rules import MeshShape, local_slice
from test_torch_mesh_train import METRICS, flat_names
from torch_parity import (MESH_B, MESH_S, mesh_opt_cfg, mesh_train_worker,
                          skewed_token_file, to_np)
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

CASE = {"name": "no_zebra", "arch": "mixtral-d2", "zcfg": None}
SAVE = 2
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def jax_program(mesh):
    cfg = jregistry.smoke_config(jregistry.get_config(CASE["arch"]))
    run = JRunConfig(policy=JPolicy(compute_dtype=jnp.float32),
                     attn_impl="chunked", moe_impl="gather", remat="full",
                     chunk_q=16)
    return jmake_train_program(cfg, mesh, run,
                               JShapeConfig("t", "train", MESH_S, MESH_B),
                               opt_cfg=mesh_opt_cfg(jopt))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    """The 2x2 run (saving at step 2) and the 1x2 and 1x1 restores."""
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    tok = skewed_token_file(tmp / "tok.bin")
    prog = jax_program(mesh4)
    with mesh4:
        init = {k: np.asarray(v)
                for k, v in flat_names(prog.init_params(seed=0)).items()}
    ckpt = str(tmp / "ckpt")
    out = {}
    for name, world, mesh, extra in (
            ("save", 4, [2, 2], {"save": SAVE}),
            ("r1x2", 2, [1, 2], {"restore": SAVE}),
            ("r1x1", 1, [1, 1], {"restore": SAVE})):
        d = tmp / name
        d.mkdir()
        case = dict(CASE, name=name, mesh=mesh, ckpt=ckpt, **extra)
        np.savez(d / "in.npz", cases=json.dumps([case]), tokens=tok,
                 **{f"{CASE['arch']}|{k}": v for k, v in init.items()})
        launch_ranks(mesh_train_worker, world, "cpu", str(d / "in.npz"),
                     str(d))
        out[name] = [dict(np.load(d / f"{name}_{r}.npz"))
                     for r in range(world)]
    return ckpt, tok, out


def test_restore_is_bitwise_on_other_meshes(runs):
    ckpt, _, out = runs
    man = CheckpointManager(ckpt)
    assert man.latest_step() == SAVE
    step, params, state, _ = man.restore(
        *_like(out["save"][0]), step=SAVE, device="cpu")
    saved = flatten({"params": params, "opt": state})
    for name, shape in (("r1x2", (1, 2)), ("r1x1", (1, 1))):
        mesh = MeshShape(shape, ("data", "model"))
        for r, got in enumerate(out[name]):
            specs = json.loads(str(got["specs"]))
            for k, full in saved.items():
                path = k.split("/", 2)[-1] if k.startswith("opt/") else \
                    k[len("params/"):]
                spec = tuple(specs.get(path, ()))
                if k == "opt/step":
                    spec = ()
                want = local_slice(spec, mesh, r, to_np(full))
                assert np.array_equal(got[f"r|{k}"], want), (name, r, k)


def _like(rank_out):
    """Like-trees (structure only) of the params and optimizer state."""
    names = [k[2:] for k in rank_out if k.startswith("p|")]
    params, mu = {}, {}
    for n in names:
        node = params
        *ps, leaf = n.split("/")
        for q in ps:
            node = node.setdefault(q, {})
        node[leaf] = None
        mu[n] = None
    return params, {"mu": mu, "nu": dict(mu), "step": None}


def test_steps_after_restore_match_the_uninterrupted_run(runs):
    _, _, out = runs
    want = json.loads(str(out["save"][0]["hist"]))[SAVE:]
    for name in ("r1x2", "r1x1"):
        for r, got in enumerate(out[name]):
            hist = json.loads(str(got["hist"]))
            assert len(hist) == len(want)
            for g, w in zip(hist, want):
                for k in METRICS:
                    assert g[k] == pytest.approx(w[k], rel=2e-5, abs=1e-9), \
                        (name, r, k)


def test_jax_restores_the_mesh_checkpoint(runs, mesh4):
    ckpt, _, _ = runs
    prog = jax_program(mesh4)
    with mesh4:
        params = prog.init_params(seed=0)
        state = prog.init_opt(params)
    step, jp, js, extra = JCheckpointManager(ckpt).restore(
        params, state, step=SAVE, shardings=prog.param_shardings,
        opt_shardings=prog.opt_shardings)
    assert step == SAVE and extra["loader"] == {"step": SAVE}
    _, tp, ts, _ = CheckpointManager(ckpt).restore(
        *_like_from_jax(jp), step=SAVE, device="cpu")
    want = flatten({"params": tp, "opt": ts})
    got = flat_names({"params": jp, "opt": js})
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(np.asarray(v), to_np(want[k])), k


def _like_from_jax(jp):
    names = flat_names(jp)
    params = {}
    for n in names:
        node = params
        *ps, leaf = n.split("/")
        for q in ps:
            node = node.setdefault(q, {})
        node[leaf] = None
    mu = {n: None for n in names}
    return params, {"mu": mu, "nu": dict(mu), "step": None}


STEP = re.compile(r"^step\s+(\d+) loss=(\S+) nll=(\S+) gnorm=(\S+) "
                  r"lr=(\S+) ")


# The driver's run policy computes in bf16 and has no flag (nor has the
# JAX driver's); a bf16 product's rounding depends on the rows it is
# computed with, so a 2x2 step differs from a 1x1 step at the bf16 tier.
# Every interpreter of the test's driver runs (the spawned ranks too)
# imports this sitecustomize, which makes f32 the policy's default
# compute dtype.
F32_SITE = """import torch
from repro_torch.models.modules import Policy
Policy.__init__.__defaults__ = (torch.float32,) * 3
"""


def _driver(mesh, tok, site):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--device", "cpu", "--no-zebra", "--mesh", mesh, "--data", tok,
           "--steps", "3", "--batch", str(MESH_B), "--seq", str(MESH_S),
           "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([site, SRC]),
               OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.splitlines()


def test_driver_mesh_2x2_matches_1x1(runs, tmp_path):
    _, tok, _ = runs
    (tmp_path / "sitecustomize.py").write_text(F32_SITE)
    lines = {m: _driver(m, tok, str(tmp_path)) for m in ("2x2", "1x1")}
    steps = {}
    for m, out in lines.items():
        assert sum(line.startswith("[train] arch=") for line in out) == 1
        assert f"mesh={{'data': {m[0]}, 'model': {m[2]}}}" in "\n".join(out)
        steps[m] = [[float(v) for v in STEP.match(line).groups()]
                    for line in out if STEP.match(line)]
        assert [s[0] for s in steps[m]] == [1, 2, 3]
    for a, b in zip(steps["2x2"], steps["1x1"]):
        assert a == pytest.approx(b, rel=2e-5)
