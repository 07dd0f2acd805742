"""repro_torch training against the JAX trainer, and the port's train CLI.

Five steps of ``smoke_config(mixtral-w1)`` (2 layers, 8 experts top-2,
d_model 128) through the port's ``make_train_program`` and the JAX
package's ``make_train_program(zcfg=None)`` on a 1x1 mesh: the same
weights (the JAX init, brought over by ``params_from_jax``), the same
tokens (one ``write_token_bin`` file read by both ``MemmapSource``s), the
f32 policy, ``remat="full"``. Two attention paths: chunked attention in
two query chunks (S 32), and the flash kernels (the port's plain versions
against the JAX package's Pallas kernels in interpret mode) at S 160, not
a multiple of the JAX kernel's 128-row blocks, so both ragged edges are
masked. Then five steps of ``smoke_config(mamba2-2.7b)`` (2 SSD layers,
chunk 32) at S 80, so the chunks carry state and the last is ragged: the
JAX package with ``use_gmm_kernel=True`` (its Pallas SSD kernel in
interpret mode, the backward by autodiff of ``ssd_chunked``) against the
port's scan plain version and the same backward. The per-step loss, nll,
z-loss, aux losses, grad norm and learning rate agree within rtol 2e-5:
the two packages sum in other orders (f32 rounding ~1e-7 per op), and
five AdamW steps carry those differences into the weights; the largest
gap measured over the chunked path's five steps is 7.4e-7. One exception:
mamba2's grad norm is held at rtol 1e-3. Its step-5 gradient is
ill-conditioned in f32: the JAX package's own two SSD routes
(``use_gmm_kernel`` True and False, which differ only in the forward's
summation order) give grad norms 1.7e-4 apart there, and the port lands
4.1e-4 from the kernel route (steps 1-4: 5.5e-6 at most; the losses agree
within 5e-7 at every step).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.zebra_spmd import ZebraConfig as JZebraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import DataLoader as JDataLoader
from repro.launch.mesh import make_mesh
from repro.models import registry as jregistry
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRunConfig
from repro.train import optimizer as jopt
from repro.train.step import make_train_program as jmake_train_program
from repro_torch.core.zebra_spmd import ZebraConfig
from repro_torch.data import DataConfig, DataLoader, write_token_bin
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from repro_torch.models.config import ShapeConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_program
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

B, S, STEPS = 4, 32, 5
S_FLASH = 160
S_MAMBA2 = 80
METRICS = ("loss", "nll", "z_loss", "moe_aux_loss", "moe_z_loss",
           "grad_norm", "lr")


def _opt_cfg(mod):
    return mod.OptimizerConfig(peak_lr=3e-3, warmup_steps=2,
                               total_steps=STEPS)


def _token_file(tmp_path_factory, seq):
    path = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    return write_token_bin(str(path), STEPS * B * seq + 1, 256, seed=3)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    return _token_file(tmp_path_factory, S)


@pytest.fixture(scope="module")
def token_file_flash(tmp_path_factory):
    return _token_file(tmp_path_factory, S_FLASH)


@pytest.fixture(scope="module")
def token_file_mamba2(tmp_path_factory):
    return _token_file(tmp_path_factory, S_MAMBA2)


def _jax_run(cfg, token_file, attn_impl="chunked", seq=S, zcfg=None):
    mesh = make_mesh((1, 1), ("data", "model"))
    run = JRunConfig(policy=JPolicy(compute_dtype=jnp.float32),
                     attn_impl=attn_impl, moe_impl="gather", remat="full",
                     chunk_q=16,
                     use_gmm_kernel=not cfg.is_moe or zcfg is not None)
    prog = jmake_train_program(cfg, mesh, run,
                               JShapeConfig("t", "train", seq, B),
                               opt_cfg=_opt_cfg(jopt),
                               zcfg=None if zcfg is None
                               else JZebraConfig(**zcfg))
    loader = JDataLoader(JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                     global_batch=B, path=token_file))
    with mesh:
        params = prog.init_params(seed=0)
        init = jax_values_np(params)  # copied before the step donates them
        state = prog.init_opt(params)
        out, batches = [], []
        for _ in range(STEPS):
            batch = next(loader)
            batches.append({k: np.asarray(v) for k, v in batch.items()})
            params, state, m = prog.train_step(params, state, batch)
            out.append({k: float(m[k]) for k in METRICS})
    return init, out, batches


def _port_program(cfg, remat="full", attn_impl="chunked", seq=S,
                  zcfg=None):
    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl=attn_impl, moe_impl="gather", remat=remat,
                    chunk_q=16)
    return make_train_program(cfg, run, ShapeConfig("t", "train", seq, B),
                              opt_cfg=_opt_cfg(opt), device="cpu",
                              zcfg=None if zcfg is None
                              else ZebraConfig(**zcfg))


def _check_train_steps_match_jax(token_file, attn_impl="chunked", seq=S,
                                 arch="mixtral-w1", rel_grad_norm=2e-5,
                                 zcfg=None):
    jcfg = jregistry.smoke_config(jregistry.get_config(arch))
    init, want, jbatches = _jax_run(jcfg, token_file, attn_impl, seq, zcfg)

    cfg = registry.smoke_config(registry.get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    prog = _port_program(cfg, attn_impl=attn_impl, seq=seq, zcfg=zcfg)
    params = params_from_jax(init)
    state = prog.init_opt(params)
    loader = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=B, path=token_file))
    got = []
    for jb in jbatches:
        batch = next(loader)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(to_np(batch[k]), jb[k])
        params, state, m = prog.train_step(params, state, batch)
        got.append({k: float(m[k]) for k in METRICS})
    assert int(state["step"]) == STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            rel = rel_grad_norm if k == "grad_norm" else 2e-5
            assert g[k] == pytest.approx(w[k], rel=rel, abs=1e-7), \
                (step, k, g[k], w[k])


def test_train_steps_match_jax(token_file):
    _check_train_steps_match_jax(token_file)


def test_zebra_train_steps_match_jax(token_file):
    """Zebra, the JAX driver's default: replicated, 2 microbatches of 64
    tokens, capacity 1.25 (C 24); the JAX package with
    ``use_gmm_kernel=True`` (its capacity-packed Pallas route)."""
    _check_train_steps_match_jax(
        token_file, zcfg=dict(mode="replicated", num_microbatches=2,
                              capacity_factor=1.25))


def test_flash_train_steps_match_jax(token_file_flash):
    _check_train_steps_match_jax(token_file_flash, "flash", S_FLASH)


def test_mamba2_train_steps_match_jax(token_file_mamba2):
    _check_train_steps_match_jax(token_file_mamba2, seq=S_MAMBA2,
                                 arch="mamba2-2.7b", rel_grad_norm=1e-3)


def test_remat_full_gradients_equal_remat_none():
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    grads = {}
    for remat in ("none", "full"):
        prog = _port_program(cfg, remat)
        grads[remat], _ = prog.grad_fn(prog.init_params(seed=0), batch)
    for name, g in grads["none"].items():
        torch.testing.assert_close(grads["full"][name], g, rtol=1e-6,
                                   atol=1e-9, msg=name)


@pytest.mark.parametrize("arch,extra", [
    ("mixtral-w1", ["--no-zebra"]), ("mamba2-2.7b", []), ("mixtral-w1", []),
    ("mixtral-w1", ["--zebra-mode", "alltoall", "--n-chunks", "2",
                    "--offload-experts", "1"])])
def test_cli_trains_on_cpu_and_prints_done(capsys, arch, extra):
    rc = train_cli.main(["--arch", arch, "--device", "cpu", "--smoke",
                         "--steps", "2", "--batch", "2", "--seq", "64",
                         "--log-every", "1", *extra])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"[train] arch={arch}-smoke params=" in out
    assert out.count("loss=") == 2 and "[train] done: final loss" in out
    zebra = arch == "mixtral-w1" and "--no-zebra" not in extra
    mode = "alltoall" if "alltoall" in extra else "replicated"
    assert (f"'mode': '{mode}'" in out) == zebra
    assert ("'num_microbatches': 2" in out) == zebra
    assert ("zebra=None" in out) == (not zebra)


@pytest.mark.parametrize("argv,names", [
    (["--ckpt-dir", "x"], ["--ckpt-dir"]),  # zebra (the default) trains
    (["--no-zebra", "--mesh", "2x1", "--ckpt-dir", "x", "--resume",
      "--trace-out", "t.json"],
     ["--mesh 2x1", "--ckpt-dir", "--resume", "--trace-out"]),
])
def test_cli_rejects_unported_settings_in_one_line(capsys, argv, names):
    rc = train_cli.main(["--arch", "mixtral-w1", "--smoke", "--device", "cpu",
                         "--steps", "1", *argv])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1 and len(err) == 1
    assert err[0].startswith("[train] invalid configuration:")
    for name in names:
        assert name in err[0]
    assert "--zebra " not in err[0] and "--no-zebra" not in err[0]


@pytest.mark.parametrize("argv", [["--zebra-mode", "pipeline"],
                                  ["--microbatches", "0"]])
def test_cli_rejects_bad_zebra_settings(capsys, argv):
    rc = train_cli.main(["--arch", "mixtral-w1", "--smoke", "--device",
                         "cpu", "--steps", "1", *argv])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1 and len(err) == 1
    assert err[0].startswith("[train] invalid configuration:")
    assert " ".join(argv) in err[0]
