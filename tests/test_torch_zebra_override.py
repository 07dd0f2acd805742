"""repro_torch zebra layer override against the JAX package.

``make_layer_override`` at R 1, 2 and 4 microbatches (and with
``pipeline=False``) against the JAX
package's override on a 1x1 mesh (output, aux, the gradients of x and of
every layer param), and at capacity 99 the port's model with the override
against the port's model without it (logits, z-loss and all gradients;
the aux loss too at R 1: the microbatch average of f·p is not the product
of the batch means). ``smoke_config(mixtral-w1)`` widths; the JAX package
under the f32 policy with ``use_gmm_kernel=True`` (Pallas in interpret
mode, jitted), the port on the CPU (one stream); the f32 tier of
``test_torch_zebra.close``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zebra_spmd as jz
from repro.launch.mesh import make_mesh
from repro.models import stack as jstack
from repro.pytree import split_params
from repro_torch.core import zebra_spmd as zs
from repro_torch.models import stack
from repro_torch.pytree import params_from_jax
from test_torch_zebra import AUX_CT, CFG, JCFG, JRUN, RUN, close
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)


def _model_params():
    values = split_params(jstack.init_model(jax.random.PRNGKey(0), JCFG))[0]
    return jax_values_np(values)


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


@pytest.mark.parametrize("R", [1, 2, 4])
def test_layer_override_matches_jax(R):
    _override_matches_jax(num_microbatches=R)


def test_layer_override_without_pipeline_matches_jax():
    """``pipeline=False``: sequential expert parallelism, one microbatch
    whatever ``num_microbatches`` says."""
    _override_matches_jax(num_microbatches=2, pipeline=False)


def _override_matches_jax(**zkw):
    B, S, d = 4, 16, CFG.d_model
    lp = _layer0(_model_params()["blocks"]["pos0"])
    spec = CFG.pattern[0]
    rng = np.random.RandomState(4)
    x = (rng.randn(B, S, d) * 0.5 + 0.3).astype(np.float32)
    ct = rng.randn(B, S, d).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    mesh = make_mesh((1, 1), ("data", "model"))
    jov = jz.make_layer_override(mesh, JCFG, JRUN, jz.ZebraConfig(**zkw))

    @jax.jit
    def fwd_bwd(p, xx, pp, cc):
        (y, aux), vjp = jax.vjp(
            lambda p_, x_: jov(p_, JCFG.pattern[0], x_, pp), p, xx)
        return y, aux, vjp((cc, {k: jnp.float32(c)
                                 for k, c in AUX_CT.items()}))

    with mesh:
        jy, jaux, (jg, jgx) = fwd_bwd(jax.tree.map(jnp.asarray, lp),
                                      jnp.asarray(x), jnp.asarray(pos),
                                      jnp.asarray(ct))
    jg = jax_values_np(jg)

    ov = zs.make_layer_override(CFG, RUN, zs.ZebraConfig(**zkw))
    p = params_from_jax(lp)
    for v in _flat(p):
        v.requires_grad_(True)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y, aux = ov(p, spec, xt, torch.from_numpy(pos))
    loss = (y * torch.from_numpy(ct)).sum() + sum(
        aux[k] * c for k, c in AUX_CT.items())
    loss.backward()
    close(y, jy, "y")
    for k in AUX_CT:
        assert aux[k].item() == pytest.approx(float(jaux[k]), rel=1e-5), k
    close(xt.grad, jgx, "x")
    for i, (g, w) in enumerate(zip(_flat(p), _flat(jg))):
        close(g.grad, w, f"leaf {i}")


@pytest.mark.parametrize("R", [1, 2, 4])
def test_layer_override_without_drops_equals_model(R):
    """At capacity 99 (no drops) the zebra model equals the dropless
    model: logits, z-loss (a mean of per-token terms) and all gradients;
    the aux loss only at R 1."""
    B, S = 4, 16
    params = params_from_jax(_model_params())
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, CFG.vocab_size, (B, S), generator=gen)
    ct = torch.randn((B, S, CFG.vocab_size), generator=gen)
    ov = zs.make_layer_override(
        CFG, RUN, zs.ZebraConfig(num_microbatches=R, capacity_factor=99.0))

    def run(override):
        leaves = [v.detach().clone().requires_grad_(True)
                  for v in _flat(params)]
        it = iter(leaves)
        p = _unflat(params, it)
        logits, _, aux = stack.apply_model(p, CFG, RUN, tokens,
                                           layer_override=override)
        (logits * ct).sum().backward()
        return logits.detach(), aux, [t.grad for t in leaves]

    want, want_aux, want_g = run(None)
    got, aux, got_g = run(ov)
    close(got, to_np(want), "logits")
    assert aux["moe_z_loss"].item() == pytest.approx(
        float(want_aux["moe_z_loss"]), rel=1e-5)
    if R == 1:
        assert aux["moe_aux_loss"].item() == pytest.approx(
            float(want_aux["moe_aux_loss"]), rel=1e-5)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        close(g, to_np(w), f"leaf {i}")


def _flat(tree):
    out = []
    for v in tree.values():
        out.extend(_flat(v) if isinstance(v, dict) else [v])
    return out


def _unflat(tree, it):
    return {k: _unflat(v, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}
