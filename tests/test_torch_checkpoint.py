"""repro_torch checkpointing against the JAX package's, and resume through
the two train drivers.

The port's ``checkpoint.CheckpointManager`` is held to the JAX package's
own manager cases (``tests/test_train_ckpt_ft.py:111-195``: roundtrip,
async save with retention, corruption detected, a crash between write and
publish keeps the previous step, every fsync before the publishing
rename; the elastic re-shard case needs a mesh, which the port does not
have), to the async save's snapshot (the port's AdamW updates params and
moments in place: a checkpoint saved with ``blocking=False`` before a step
restores the state before it), and to the JAX package's format in both
directions: a checkpoint the JAX manager wrote from ``init_model`` params
and ``init_opt_state`` (one tree with bf16 params and f32 master
weights, one f32 tree) restores in the port bit for bit, the 0-dim int32
``opt/step`` included; restored and saved again by the port it gives the
same manifest entries (shape, dtype, sha256) and the same npz member
bytes per array; one the port wrote restores in JAX bit for bit.

The JAX manager's own restore cannot place a bf16 leaf: ``np.load``
returns the ml_dtypes bf16 it wrote as raw ``|V2`` and ``jnp.asarray``
refuses that (its own checkpoints included; checked here). The port's
bf16 checkpoint is therefore held to the JAX one by its bytes and
manifest, and to the JAX restore by the same refusal.

Resume through the drivers, ``mixtral-w1 --smoke``, zebra default
(replicated, 2 microbatches), batch 4 x seq 32, every run inside the
20-step warmup (so the learning rate does not depend on ``--steps``):
the port driver's ``--steps 2 --ckpt-dir d`` then ``--resume --steps 4``
is bitwise equal to ``--steps 4`` straight (losses, grad norms and the
final checkpoint's hashes of every param and moment); and the JAX
driver's step-2 checkpoint resumed by the port driver to step 4 is within
rtol 2e-5 of the JAX driver's own steps 3-4 (the five-step tier of
``test_torch_train.py``), both under ``Policy(compute_dtype=float32)``
and on one ``write_token_bin`` file. The JAX driver runs once, ``--steps
4 --ckpt-every 2``: its async step-2 save is what ``--steps 2`` would
have saved (same state, same loader position; inside the warmup the
schedule's ``total_steps`` does not enter).
"""

import dataclasses
import functools
import json
import os
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.pytree import cast_tree, split_params
from repro.train import optimizer as jopt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as mgr_mod
from repro_torch.data import write_token_bin
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from repro_torch.models.config import ShapeConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, params_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_program
from torch_parity import jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

B, S = 4, 32
DRIVER = ["--arch", "mixtral-w1", "--smoke", "--batch", str(B), "--seq",
          str(S), "--log-every", "1"]
METRICS = ("loss", "nll", "z_loss", "moe_aux_loss", "moe_z_loss",
           "grad_norm", "lr")


def _bits(x):
    """Exact bits of a numpy / jax array or a torch tensor (bf16 as
    uint16, everything else as its bytes), with shape and dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else \
            str(t.numpy().dtype)
        raw = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        return name, tuple(t.shape), raw.tobytes()
    a = np.asarray(x)
    return str(a.dtype), tuple(a.shape), a.tobytes()


def _assert_trees_bitwise(got, want):
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert _bits(g[k]) == _bits(w[k]), k


def _members(path):
    """{array name: raw .npy member bytes} of a checkpoint's npz."""
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n[:-len(".npy")].replace("\x1f", "/"): z.read(n)
                for n in z.namelist()}


def _manifest(path):
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The manager: the JAX package's own cases, on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    ostate = opt.init_opt_state(params)
    mgr.save(5, params, ostate, extra={"loader": {"step": 5}})
    step, p2, o2, extra = mgr.restore(params, ostate)
    assert step == 5 and extra["loader"]["step"] == 5
    _assert_trees_bitwise(p2, params)
    _assert_trees_bitwise(o2, ostate)
    assert o2["step"].dim() == 0 and o2["step"].dtype == torch.int32


def test_checkpoint_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"a": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, params, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert [r["step"] for r in mgr.saves] == [1, 2, 3, 4]
    assert all(r["write_s"] is not None for r in mgr.saves)


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params = {"a": torch.ones(8)}
    mgr.save(1, params)
    path = os.path.join(str(tmp_path), "step_00000001", "arrays.npz")
    np.savez(path, **{"params\x1fa": np.zeros(8, np.float32)})
    with pytest.raises(IOError):
        mgr.restore(params)


def test_checkpoint_crash_mid_save_keeps_previous_step(tmp_path,
                                                       monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    params = {"a": torch.arange(4.0)}
    mgr.save(1, params)
    real_rename = os.rename

    def crash_rename(src, dst):
        if os.path.basename(dst).startswith("step_"):
            raise RuntimeError("power loss mid-publish")
        return real_rename(src, dst)

    monkeypatch.setattr(mgr_mod.os, "rename", crash_rename)
    params2 = {"a": torch.full((4,), 9.0)}
    with pytest.raises(RuntimeError, match="power loss"):
        mgr.save(2, params2)
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert mgr.all_steps() == [1]
    step, p, _, _ = mgr.restore(params)
    assert step == 1 and torch.equal(p["a"], torch.arange(4.0))
    monkeypatch.setattr(mgr_mod.os, "rename", real_rename)
    mgr.save(2, params2)
    assert mgr.all_steps() == [1, 2]
    step, p, _, _ = mgr.restore(params2)
    assert step == 2 and torch.equal(p["a"], torch.full((4,), 9.0))


def test_checkpoint_save_fsyncs_before_publish(tmp_path, monkeypatch):
    order = []
    real_fsync, real_rename = os.fsync, os.rename
    monkeypatch.setattr(mgr_mod.os, "fsync",
                        lambda fd: (order.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(
        mgr_mod.os, "rename",
        lambda s, d: (order.append("rename"), real_rename(s, d))[1])
    CheckpointManager(str(tmp_path)).save(1, {"a": torch.ones(2)})
    # arrays.npz + MANIFEST + tmp dir before the rename, parent dir after
    assert order.index("rename") >= 3
    assert order[-1] == "fsync" and order.count("rename") == 1


def test_async_save_snapshots_before_the_next_step(tmp_path):
    """The port's AdamW updates params and moments in place; an async
    save taken before a step restores the state before it, not after."""
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl="chunked", remat="full")
    prog = make_train_program(cfg, run, ShapeConfig("t", "train", S, B),
                              device="cpu")
    params = prog.init_params(seed=0)
    state = prog.init_opt(params)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, B, S + 1), generator=gen)
    batches = [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in toks]
    params, state, _ = prog.train_step(params, state, batches[0])
    before = {k: v.clone() for k, v in flatten(
        {"params": params, "opt": state}).items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params, state, blocking=False)
    params, state, _ = prog.train_step(params, state, batches[1])
    mgr.wait()
    after = flatten({"params": params, "opt": state})
    _, p, o, _ = mgr.restore(params, state)
    got = flatten({"params": p, "opt": o})
    moved = 0
    for k, v in before.items():
        assert _bits(got[k]) == _bits(v), k
        moved += not torch.equal(after[k], v)
    assert moved > len(before) // 2  # the step did change the state


# ---------------------------------------------------------------------------
# Interop with the JAX package's manager
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_states():
    """{name: (params, opt_state)} of the JAX package: the smoke W1's
    ``init_model`` params in f32 with ``init_opt_state`` after one
    ``adamw_update`` (non-zero moments, step 1), and the same params in
    bf16 with f32 master weights."""
    jcfg = jregistry.smoke_config(jregistry.get_config("mixtral-w1"))
    params = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    ocfg = jopt.OptimizerConfig(peak_lr=1e-2, warmup_steps=0)
    grads = jax.tree.map(lambda p: jnp.cos(p) * 1e-2, params)
    out = {}
    for name, dtype, master in (("f32", jnp.float32, False),
                                ("bf16", jnp.bfloat16, True)):
        p = cast_tree(params, dtype)
        st = jopt.init_opt_state(p, master_weights=master)
        p, st, _ = jopt.adamw_update(ocfg, p, grads, st)
        out[name] = (p, st)
    return out


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_jax_checkpoint_restores_in_port_bitwise(tmp_path, jax_states, name):
    jp, jst = jax_states[name]
    JCheckpointManager(str(tmp_path / "jax")).save(
        1, jp, jst, extra={"loader": {"step": 1}})
    like_p = params_from_jax(jax_values_np(cast_tree(jp, jnp.float32)))
    like_o = opt.init_opt_state(like_p, master_weights=name == "bf16")
    step, p, o, extra = CheckpointManager(str(tmp_path / "jax")).restore(
        like_p, like_o)
    assert step == 1 and extra == {"loader": {"step": 1}}
    _assert_trees_bitwise(p, jax_values_np(jp))
    want_o = jax_values_np(jst)
    assert o["step"].dim() == 0 and o["step"].dtype == torch.int32
    # the port keys moments by flattened path names: compare by name
    assert _bits(o["step"]) == _bits(want_o["step"])
    for k in ("mu", "nu") + (("master",) if name == "bf16" else ()):
        _assert_trees_bitwise(o[k], flatten(want_o[k]))
    if name == "bf16":
        assert p["embed"]["table"].dtype == torch.bfloat16

    # restored by the port and saved again: the same manifest entries and
    # the same npz member bytes per array
    CheckpointManager(str(tmp_path / "port")).save(
        1, p, o, extra={"loader": {"step": 1}})
    jdir, pdir = tmp_path / "jax" / "step_00000001", \
        tmp_path / "port" / "step_00000001"
    jm, pm = _manifest(jdir), _manifest(pdir)
    assert pm["arrays"] == jm["arrays"] and pm["extra"] == jm["extra"]
    assert list(pm["arrays"]) == list(jm["arrays"])  # the same order
    assert _members(pdir) == _members(jdir)
    assert any(v["dtype"] == "bfloat16" for v in jm["arrays"].values()) \
        == (name == "bf16")
    assert jm["arrays"]["opt/step"]["shape"] == []


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_port_checkpoint_restores_in_jax_bitwise(tmp_path, jax_states, name):
    jp, jst = jax_states[name]
    p = params_from_jax(jax_values_np(jp))
    master = name == "bf16"
    o = opt.init_opt_state(p, master_weights=master)
    want_o = jax_values_np(jst)
    for k in ("mu", "nu") + (("master",) if master else ()):
        o[k] = {n: torch.from_numpy(np.array(v, copy=True))
                for n, v in flatten(want_o[k]).items()}
    o["step"] = torch.tensor(int(want_o["step"]), dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(3, p, o,
                                          extra={"loader": {"step": 3}})
    mgr = JCheckpointManager(str(tmp_path))
    if master:
        # the JAX manager places no bf16 leaf, its own checkpoints'
        # included: the same refusal on the port's
        with pytest.raises(TypeError, match="V2"):
            mgr.restore(jp, jst)
        JCheckpointManager(str(tmp_path / "jax")).save(
            3, jp, jst, extra={"loader": {"step": 3}})
        with pytest.raises(TypeError, match="V2"):
            JCheckpointManager(str(tmp_path / "jax")).restore(jp, jst)
        d, jd = tmp_path / "step_00000003", tmp_path / "jax" / \
            "step_00000003"
        assert _manifest(d)["arrays"] == _manifest(jd)["arrays"]
        assert _members(d) == _members(jd)
        return
    step, rp, ro, extra = mgr.restore(jp, jst)
    assert step == 3 and extra == {"loader": {"step": 3}}
    _assert_trees_bitwise(jax_values_np(rp), jax_values_np(jp))
    _assert_trees_bitwise(jax_values_np(ro), jax_values_np(jst))
    assert ro["step"].shape == () and ro["step"].dtype == jnp.int32


# ---------------------------------------------------------------------------
# Resume through the drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    return write_token_bin(str(path), 4 * B * S + 1, 256, seed=3)


def _port_args(extra):
    return train_cli.build_parser().parse_args(
        DRIVER + ["--device", "cpu"] + extra)


def test_port_resume_is_bitwise_equal_to_a_straight_run(tmp_path,
                                                        token_file):
    data = ["--data", token_file]
    straight = train_cli.train_arch(
        "mixtral-w1", _port_args(data + ["--steps", "4", "--ckpt-dir",
                                         str(tmp_path / "a")]))
    first = train_cli.train_arch(
        "mixtral-w1", _port_args(data + ["--steps", "2", "--ckpt-every", "2",
                                         "--ckpt-dir", str(tmp_path / "b")]))
    resumed = train_cli.train_arch(
        "mixtral-w1", _port_args(data + ["--steps", "4", "--resume",
                                         "--ckpt-dir", str(tmp_path / "b")]))
    assert first["start_step"] == 0 and resumed["start_step"] == 2
    assert resumed["ckpt"]["restore"]["step"] == 2
    assert len(resumed["history"]) == 2
    for got, want in zip(first["history"] + resumed["history"],
                         straight["history"]):
        for k in METRICS:
            assert got[k] == want[k], (k, got[k], want[k])
    a = _manifest(tmp_path / "a" / "step_00000004")
    b = _manifest(tmp_path / "b" / "step_00000004")
    assert a["arrays"] == b["arrays"]
    assert a["extra"] == b["extra"] == {"loader": {"step": 4}}
    assert sorted(tmp_path.joinpath("b").iterdir()) == [
        tmp_path / "b" / "step_00000002", tmp_path / "b" / "step_00000004"]


def test_port_driver_resumes_a_jax_driver_checkpoint(tmp_path, token_file,
                                                     monkeypatch, capsys):
    f32 = functools.partial(JPolicy, compute_dtype=jnp.float32)
    monkeypatch.setattr(jtrain, "Policy", f32)
    jax_hist = []
    real_make = jtrain.make_train_program

    def recording(*a, **k):
        prog = real_make(*a, **k)

        def step(params, opt_state, batch):
            params, opt_state, m = prog.train_step(params, opt_state, batch)
            jax_hist.append({n: float(m[n]) for n in METRICS})
            return params, opt_state, m

        return dataclasses.replace(prog, train_step=step)

    monkeypatch.setattr(jtrain, "make_train_program", recording)
    jdir = tmp_path / "jax"
    assert jtrain.main(DRIVER + ["--steps", "4", "--ckpt-every", "2",
                                 "--ckpt-dir", str(jdir),
                                 "--data", token_file]) == 0
    assert len(jax_hist) == 4
    shutil.copytree(jdir / "step_00000002", tmp_path / "port" /
                    "step_00000002")

    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl="chunked", moe_impl="gather", remat="full")
    capsys.readouterr()
    got = train_cli.train_arch(
        "mixtral-w1", _port_args(["--steps", "4", "--resume", "--data",
                                  token_file, "--ckpt-dir",
                                  str(tmp_path / "port")]), run=run)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert got["start_step"] == 2 and len(got["history"]) == 2
    for step, (g, w) in enumerate(zip(got["history"], jax_hist[2:]), 3):
        for k in METRICS:
            assert g[k] == pytest.approx(w[k], rel=2e-5, abs=1e-7), \
                (step, k, g[k], w[k])


def test_cli_checkpoints_traces_and_resumes(tmp_path, capsys):
    """The acceptance commands: ``--steps 4 --ckpt-dir D --ckpt-every 2
    --trace-out T.json`` exits 0; ``--resume --steps 6`` from D prints
    ``[train] resumed from step 4`` and exits 0."""
    base = ["--arch", "mixtral-w1", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "d")]
    assert train_cli.main(base + ["--steps", "4", "--ckpt-every", "2",
                                  "--trace-out",
                                  str(tmp_path / "t.json")]) == 0
    out = capsys.readouterr().out
    assert "[train] trace:" in out and "[train] zebra-sim:" in out
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert train_cli.main(base + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert out.count("loss=") == 1  # step 5 (log-every 10), then done
    assert "[train] done: final loss" in out
    assert CheckpointManager(str(tmp_path / "d")).all_steps() == [2, 4, 6]
