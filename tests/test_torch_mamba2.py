"""repro_torch mamba2 modules against the JAX package, on smoke-size
``mamba2-2.7b`` (d_model 128, 4 SSD heads of 64, state 32, chunk 32) with
the JAX init carried over by ``params_from_jax``, under the f32 policy.

* ``causal_conv1d`` without and with a carried state: within 1e-6 *
  max|want| (the same per-tap products and sums, in the same order);
* ``apply_ssd`` cache-free (the JAX package through its Pallas kernel in
  interpret mode, ``use_gmm_kernel=True``; the port through the scan's
  plain version) and with a decode state (``ref.ssd_decode_step`` in
  both), and 2 or 80 tokens from a random state (JAX token by token, the
  port through ``ref.ssd_chunked`` from that state): output and new state
  within 1e-5 * max|want|;
* ``apply_model`` logits at S 80 (three chunks, the last one ragged)
  within 1e-4, the tier of tests/test_torch_model.py;
* the deterministic init leaves (A_log, D, norm, dt_bias, conv_b) of the
  port's own seeded init against JAX's: exact at the smoke size; at the
  full 80 heads A_log is the correctly rounded log(linspace(1, 16, 80)),
  which XLA's CPU linspace and log reach within 2 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modules as jmodules
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro_torch.models import modules, registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, materialize, params_from_jax
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

ARCH = "mamba2-2.7b"
JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), use_gmm_kernel=True)
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
DETERMINISTIC = ("A_log", "D", "norm", "dt_bias", "conv_b")


@pytest.fixture(scope="module")
def model():
    jcfg = jreg.smoke_config(jreg.get_config(ARCH))
    cfg = registry.smoke_config(registry.get_config(ARCH))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    return jcfg, jp, cfg, params_from_jax(jax_values_np(jp))


def _layer0(tree):
    return {k: v[0] for k, v in tree["blocks"]["pos0"]["mixer"].items()}


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(to_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.RandomState(0)
    x, w, b = rng.randn(2, 9, 24), rng.randn(4, 24), rng.randn(24)
    st = rng.randn(2, 3, 24) if with_state else None
    arrs = [a if a is None else a.astype(np.float32) for a in (x, w, b, st)]
    got = modules.causal_conv1d(*(None if a is None else torch.from_numpy(a)
                                  for a in arrs))
    want = jmodules.causal_conv1d(*(None if a is None else jnp.asarray(a)
                                    for a in arrs))
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _close(g, w_, 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_ssd_matches_jax(model, with_state):
    jcfg, jp, cfg, tp = model
    rng = np.random.RandomState(1)
    S = 1 if with_state else 80
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    jstate = tstate = None
    if with_state:
        shapes = {k: v.shape for k, v in
                  modules.init_ssd_state(cfg, 2, torch.float32).items()}
        st = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        jstate = {k: jnp.asarray(v) for k, v in st.items()}
        tstate = {k: torch.from_numpy(v) for k, v in st.items()}
    got, got_state = modules.apply_ssd(_layer0(tp), cfg, RUN,
                                       torch.from_numpy(x), tstate)
    want, want_state = jmodules.apply_ssd(_layer0(jp), jcfg, JRUN,
                                          jnp.asarray(x), jstate)
    _close(got, want, 1e-5)
    assert (got_state is None) == (want_state is None)
    if with_state:
        for k in ("conv", "ssm"):
            assert got_state[k].dtype == tstate[k].dtype
            _close(got_state[k], want_state[k], 1e-5)


@pytest.mark.parametrize("S", [2, 80])
def test_apply_ssd_from_state_matches_jax(model, S):
    """More than one token from a random non-zero state: the JAX package
    scans them token by token, the port through ``ref.ssd_chunked`` from
    that state (80: three chunks of 32, the last one ragged)."""
    jcfg, jp, cfg, tp = model
    rng = np.random.RandomState(3)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    shapes = {k: v.shape for k, v in
              modules.init_ssd_state(cfg, 2, torch.float32).items()}
    st = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    got, got_state = modules.apply_ssd(
        _layer0(tp), cfg, RUN, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()})
    want, want_state = jmodules.apply_ssd(
        _layer0(jp), jcfg, JRUN, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    assert got.shape == want.shape
    _close(got, want, 1e-5)
    for k in ("conv", "ssm"):
        _close(got_state[k], want_state[k], 1e-5)


def test_cache_free_logits_match_jax(model):
    jcfg, jp, cfg, tp = model
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(2, 80))
    want, _, _ = jstack.apply_model(jp, jcfg, JRUN, jnp.asarray(toks))
    got, _, aux = stack.apply_model(tp, cfg, RUN, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert set(aux) == set(stack.AUX_KEYS)


def test_deterministic_init_leaves_match_jax(model):
    jcfg, jp, cfg, _ = model
    ours = flatten(stack.init_model(torch.Generator().manual_seed(0), cfg))
    theirs = flatten(jax_values_np(jp))
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        assert tuple(t.shape) == theirs[name].shape, name
        if name.rsplit("/", 1)[-1] in DETERMINISTIC:
            np.testing.assert_array_equal(t.numpy(), theirs[name], name)

    full = registry.get_config(ARCH)
    a_log = materialize(modules.init_ssd(full), None, "cpu")["A_log"]
    want = np.asarray(split_params(jmodules.init_ssd(
        jax.random.PRNGKey(0), jreg.get_config(ARCH)))[0]["A_log"])
    ulp = np.abs(a_log.numpy().astype(np.float64) - want) \
        / np.spacing(np.abs(want))
    assert a_log.shape == (full.ssm_heads,) and ulp.max() <= 2
    np.testing.assert_array_equal(
        a_log.numpy(),
        np.log(np.linspace(1.0, 16.0, full.ssm_heads)).astype(np.float32))
