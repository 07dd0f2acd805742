"""repro_torch's RG-LRU block (recurrentgemma / Griffin) against the JAX
package, under the f32 policy, on the JAX init carried over by
``params_from_jax``: smoke ``recurrentgemma-9b`` (d_model 128, lru_width
128, window 32; 2 x (rglru, rglru, local_attn) + 2 rglru tail layers) and
the JAX test's ``small_cfg(family="hybrid", lru_width=32)`` case
(``tests/test_modules.py::test_rglru_scan_matches_loop``).

* ``_lru_scan`` (a doubling scan) against the JAX package's
  ``associative_scan``, with and without h0, at S 1, 10 and 80;
* ``apply_rglru`` cache-free, token by token with a state and in chunks
  with a state (each chunk's outputs and the final state equal the
  cache-free run's and JAX's);
* ``jax.grad`` of a scalar of ``apply_rglru`` against autograd, for every
  leaf and for x;
* the init: leaf paths and shapes equal JAX's, sigmoid(lam)^8 lies in
  (0.9, 0.999), ``compute_params`` keeps w_i and w_a in f32 under bf16;
* the cache-free logits of the smoke model (the first arch the port runs
  with ``emb_scale`` and tied embeddings) and five train steps at S 80
  against the JAX trainer (``tests/test_torch_train.py``'s check).

Each comparison is within 1e-5 * max|JAX| unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modules as jmodules
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.config import ModelConfig as JModelConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro_torch.models import modules, registry, stack
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, params_from_jax
from test_torch_train import S_MAMBA2 as S_TRAIN
from test_torch_train import _check_train_steps_match_jax, _token_file
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

ARCH = "recurrentgemma-9b"
JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32))
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
REL = 1e-5
# the JAX functions jit-compiled: one compile per shape instead of one
# per op and shape (eager ``associative_scan`` is a few seconds a shape)
_japply = jax.jit(jmodules.apply_rglru, static_argnums=(1, 2))
_jscan = jax.jit(jmodules._lru_scan)
SMALL = dict(name="t", family="hybrid", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128, lru_width=32)


@pytest.fixture(scope="module")
def model():
    jcfg = jreg.smoke_config(jreg.get_config(ARCH))
    cfg = registry.smoke_config(registry.get_config(ARCH))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    return jcfg, jp, cfg, params_from_jax(jax_values_np(jp))


@pytest.fixture(scope="module", params=["smoke", "small"])
def block(request, model):
    """(jcfg, JAX block params, cfg, port block params): layer 0 of the
    smoke model, or the JAX test's small hybrid block."""
    if request.param == "smoke":
        jcfg, jp, cfg, tp = model
        return (jcfg, {k: v[0] for k, v in
                       jp["blocks"]["pos0"]["mixer"].items()},
                cfg, {k: v[0] for k, v in
                      tp["blocks"]["pos0"]["mixer"].items()})
    jcfg = JModelConfig(**SMALL)
    jp = split_params(jmodules.init_rglru(jax.random.PRNGKey(0), jcfg))[0]
    return (jcfg, jp, ModelConfig(**SMALL),
            params_from_jax(jax_values_np(jp)))


def _close(got, want, rel=REL):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _x(cfg, S, seed=1):
    rng = np.random.RandomState(seed)
    return (0.5 * rng.randn(2, S, cfg.d_model)).astype(np.float32)


def _state(cfg, seed):
    """A random {"conv", "lru"} state, as numpy."""
    rng = np.random.RandomState(seed)
    return {"conv": rng.randn(2, cfg.conv_width - 1,
                              cfg.lru_width).astype(np.float32),
            "lru": rng.randn(2, cfg.lru_width).astype(np.float32)}


@pytest.mark.parametrize("S", [1, 10, 80])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_matches_jax(S, with_h0):
    rng = np.random.RandomState(S)
    a = rng.uniform(0.5, 0.999, size=(2, S, 32)).astype(np.float32)
    gx = rng.randn(2, S, 32).astype(np.float32)
    h0 = rng.randn(2, 32).astype(np.float32) if with_h0 else None
    got = modules._lru_scan(torch.from_numpy(a), torch.from_numpy(gx),
                            None if h0 is None else torch.from_numpy(h0))
    want = _jscan(jnp.asarray(a), jnp.asarray(gx),
                  None if h0 is None else jnp.asarray(h0))
    _close(got, want)
    # and the recurrence itself, step by step in f64
    h = np.zeros((2, 32)) if h0 is None else h0.astype(np.float64)
    for t in range(S):
        h = a[:, t] * h + gx[:, t]
    _close(got[:, -1], h)


def test_apply_rglru_cache_free_matches_jax(block):
    jcfg, jp, cfg, tp = block
    x = _x(cfg, 40)
    got, st = modules.apply_rglru(tp, cfg, RUN, torch.from_numpy(x))
    want, jst = _japply(jp, jcfg, JRUN, jnp.asarray(x))
    assert st is None and jst is None
    _close(got, want)


@pytest.mark.parametrize("chunks", [(1,) * 12, (5, 4, 3), (12,)],
                         ids=["token_by_token", "chunks", "whole"])
def test_apply_rglru_with_state_matches_jax_and_cache_free(block, chunks):
    """From a random state and from zeros: each chunk's output and the
    final state against the JAX package's run from the same state; from
    zeros, the outputs also against the cache-free run and the final state
    against one stateful pass over the whole input."""
    jcfg, jp, cfg, tp = block
    x = _x(cfg, sum(chunks), seed=2)
    for seed in (3, None):
        st0 = _state(cfg, seed) if seed is not None else {
            k: np.zeros_like(v) for k, v in _state(cfg, 0).items()}
        st = {k: torch.from_numpy(v.copy()) for k, v in st0.items()}
        jst = {k: jnp.asarray(v) for k, v in st0.items()}
        outs, jouts, off = [], [], 0
        for c in chunks:
            o, st = modules.apply_rglru(tp, cfg, RUN,
                                        torch.from_numpy(x[:, off:off + c]),
                                        st)
            jo, jst = _japply(jp, jcfg, JRUN, jnp.asarray(x[:, off:off + c]),
                              jst)
            _close(o, jo)
            outs.append(o)
            jouts.append(jo)
            off += c
        for k in ("conv", "lru"):
            assert st[k].dtype == torch.float32
            _close(st[k], jst[k])
        if seed is None:
            whole, _ = modules.apply_rglru(tp, cfg, RUN, torch.from_numpy(x))
            _close(torch.cat(outs, 1), whole)
            _, one = modules.apply_rglru(
                tp, cfg, RUN, torch.from_numpy(x),
                {k: torch.zeros_like(v) for k, v in st.items()})
            for k in ("conv", "lru"):
                _close(st[k], one[k])


def test_apply_rglru_grads_match_jax(block):
    """d/d(every leaf, x) of sum(y * ct) through ``apply_rglru``: autograd
    against ``jax.grad``."""
    jcfg, jp, cfg, tp = block
    x = _x(cfg, 24, seed=4)
    ct = np.random.RandomState(5).randn(2, 24, cfg.d_model).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = jmodules.apply_rglru(p, jcfg, JRUN, xx)
        return jnp.sum(y * ct)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = modules.apply_rglru(p, cfg, RUN, xt)
    (y * torch.from_numpy(ct)).sum().backward()
    _close(xt.grad, jgx)
    assert sorted(p) == sorted(jgp)
    for k, t in p.items():
        _close(t.grad, jgp[k])


def test_init_paths_shapes_and_lambda(model):
    jcfg, jp, cfg, _ = model
    ours = flatten(stack.init_model(torch.Generator().manual_seed(0), cfg))
    theirs = flatten(jax_values_np(jp))
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        assert tuple(t.shape) == theirs[name].shape, name
    # both inits: a = sigmoid(lam)^8 in (0.9, 0.999); lam stacked per layer
    for tree in (ours, theirs):
        for name in ("blocks/pos0/mixer/lam", "tail1/mixer/lam"):
            a = torch.sigmoid(torch.tensor(np.asarray(tree[name]))) ** 8
            assert float(a.min()) > 0.9 - 1e-6 and float(a.max()) < 0.999 \
                + 1e-6, name
    assert ours["blocks/pos0/mixer/lam"].shape == (cfg.n_pattern_repeats,
                                                   cfg.lru_width)
    assert len(set(ours["tail0/mixer/lam"].tolist())) == cfg.lru_width
    # the gate matrices stay f32 in the compute tree (cast to f32 at use)
    cp = stack.compute_params(stack.init_model(
        torch.Generator().manual_seed(0), cfg), Policy())
    mixer = cp["blocks"]["pos0"]["mixer"]
    for k in ("w_i", "w_a", "b_i", "b_a", "lam"):
        assert mixer[k].dtype == torch.float32, k
    for k in ("proj_gate", "proj_rec", "out", "conv_w", "conv_b"):
        assert mixer[k].dtype == torch.bfloat16, k


def test_cache_free_logits_match_jax(model):
    """The smoke model's logits at S 80: embeddings scaled by
    sqrt(d_model), the tied table as the head; 1e-4, the tier of
    tests/test_torch_model.py."""
    jcfg, jp, cfg, tp = model
    assert cfg.emb_scale and cfg.tie_embeddings and "lm_head" not in tp
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, size=(2, 80))
    want, _, _ = jstack.apply_model(jp, jcfg, JRUN, jnp.asarray(toks))
    got, _, aux = stack.apply_model(tp, cfg, RUN, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert set(aux) == set(stack.AUX_KEYS)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    return _token_file(tmp_path_factory, S_TRAIN)


def test_train_steps_match_jax(token_file):
    """Five steps at S 80 (the local-attention window 32 and the chunked
    attention's query chunks of 16 bite): loss, nll, z-loss, grad norm and
    learning rate within rtol 2e-5 of the JAX trainer's."""
    _check_train_steps_match_jax(token_file, seq=S_TRAIN, arch=ARCH)
