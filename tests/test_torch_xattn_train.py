"""Training through cross-attention on the port against the JAX trainer.

3 train steps of the smoke configs of ``whisper-tiny`` and
``llama-3.2-vision-90b`` through the port's ``make_train_program`` and the
JAX package's ``make_train_program`` on a 1x1 mesh, on the JAX init with
every ``xgate`` at ``GATE`` and random fronts from a numpy seed per step
(``test_torch_xattn.py`` says why), one token file read by both, the f32
policy, ``remat="full"``: chunked attention at S 32 and the flash path at
S 160 (the JAX package's Pallas kernels in interpret mode, the port's
plain versions; a ragged edge). Every metric within the tiers of
``test_torch_train.py`` (rtol 2e-5); at the first step the gradients of
whisper's encoder, ``vision_proj`` and every cross-attention leaf, which
reach them through the checkpointed layers, nonzero and within 1e-4 *
max|JAX| of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import DataLoader as JDataLoader
from repro.launch.mesh import make_mesh
from repro.models import registry as jreg
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.train import optimizer as jopt
from repro.train.step import make_train_program as jmake_train_program
from repro_torch.data import DataConfig, DataLoader, write_token_bin
from repro_torch.models import registry
from repro_torch.models.config import ShapeConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, params_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_program
from torch_parity import XATTN_ARCHS as ARCHS
from torch_parity import XATTN_GATE as GATE
from torch_parity import fronts_np, jax_values_np, to_np, with_gate
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

TRAIN_B, TRAIN_STEPS = 2, 3
METRICS = ("loss", "nll", "z_loss", "moe_aux_loss", "moe_z_loss",
           "grad_norm", "lr")


def _close(got, want, rel, what):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _opt_cfg(mod):
    return mod.OptimizerConfig(peak_lr=3e-3, warmup_steps=2,
                               total_steps=TRAIN_STEPS)


@pytest.fixture(scope="module")
def token_files(tmp_path_factory):
    files = {}
    for seq in (32, 160):
        path = tmp_path_factory.mktemp("tokens") / f"tokens{seq}.bin"
        files[seq] = write_token_bin(
            str(path), TRAIN_STEPS * TRAIN_B * seq + 1, 256, seed=3)
    return files


def _cross_leaves(names):
    return [n for n in names if n.startswith("encoder/")
            or n == "vision_proj" or "/xattn/" in n or n.endswith("xgate")]


@pytest.mark.parametrize("impl,seq", [("chunked", 32), ("flash", 160)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(token_files, arch, impl, seq):
    jcfg = jreg.smoke_config(jreg.get_config(arch))
    cfg = registry.smoke_config(registry.get_config(arch))
    mesh = make_mesh((1, 1), ("data", "model"))
    jrun = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl=impl,
                moe_impl="gather", remat="full", chunk_q=16)
    jprog = jmake_train_program(jcfg, mesh, jrun,
                                JShapeConfig("t", "train", seq, TRAIN_B),
                                opt_cfg=_opt_cfg(jopt))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl=impl, moe_impl="gather", remat="full",
                    chunk_q=16)
    prog = make_train_program(cfg, run,
                              ShapeConfig("t", "train", seq, TRAIN_B),
                              opt_cfg=_opt_cfg(opt), device="cpu")
    jloader = JDataLoader(JDataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=TRAIN_B,
                                      path=token_files[seq]))
    loader = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=TRAIN_B,
                                   path=token_files[seq]))
    with mesh:
        jparams = with_gate(jprog.init_params(seed=0), GATE)
        params = params_from_jax(jax_values_np(jparams))
        jstate, state = jprog.init_opt(jparams), prog.init_opt(params)
        for step in range(TRAIN_STEPS):
            fronts = fronts_np(cfg, TRAIN_B, 100 + step)
            jbatch = {**next(jloader),
                      **{k: jnp.asarray(v) for k, v in fronts.items()}}
            batch = {**next(loader),
                     **{k: torch.from_numpy(v) for k, v in fronts.items()}}
            if step == 0:  # gradients of the cross-attention path
                jgrads = flatten(jax_values_np(jax.jit(jax.grad(
                    lambda p, b: jprog.loss_fn(p, b)[0]))(jparams, jbatch)))
                grads, _ = prog.grad_fn(params, batch)
                names = _cross_leaves(grads)
                assert names and len(names) == len(_cross_leaves(jgrads))
                for n in names:
                    want = jgrads[n]
                    assert np.abs(want).max() > 0, n
                    _close(grads[n], want, rel=1e-4, what=n)
            jparams, jstate, jm = jprog.train_step(jparams, jstate, jbatch)
            params, state, m = prog.train_step(params, state, batch)
            for k in METRICS:
                assert float(m[k]) == pytest.approx(
                    float(jm[k]), rel=2e-5, abs=1e-7), (step, k)
