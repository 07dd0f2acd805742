"""repro_torch MoE expert FFN gradient against the JAX package.

``ops.moe_ffn``'s forward and all five gradients (x, wi_gate, wi_up, wo,
row scales) against ``jax.vjp`` of the JAX package's ``ops.moe_ffn`` under
f32, on both routes: the packed route (the port's ``_MoEFFN`` autograd
Function, the reference's ``_make_moe_ffn`` custom_vjp) and the group-dense
route (autograd in both). Sizes include a zero-token group, whose weight
gradients must be exactly zero, and groups that are not tile multiples.
The reference runs its XLA fallback, and in one tiny case its Pallas
kernels in interpret mode. Tolerance 1e-5 (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from torch_parity import to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("x", "wi_gate", "wi_up", "wo", "scales")


def _inputs(sizes, d=32, f=48, seed=0):
    rng = np.random.RandomState(seed)
    M, G = sum(sizes), len(sizes)
    return [(rng.randn(M, d) * 0.5).astype(np.float32),
            (rng.randn(G, d, f) * 0.2).astype(np.float32),
            (rng.randn(G, d, f) * 0.2).astype(np.float32),
            (rng.randn(G, f, d) * 0.2).astype(np.float32),
            rng.rand(M).astype(np.float32),
            (rng.randn(M, d)).astype(np.float32)]  # the output cotangent


def _jax_vjp(arrays, gs, scaled, **kw):
    x, wg, wu, wo, sc, ct = (jnp.asarray(a) for a in arrays)

    def f(x, wg, wu, wo, sc):
        return jops.moe_ffn(x, wg, wu, wo, jnp.asarray(gs),
                            row_scales=sc if scaled else None, block_m=32,
                            **kw)

    out, vjp = jax.vjp(f, x, wg, wu, wo, sc)
    return np.asarray(out), [np.asarray(g) for g in vjp(ct)]


def _port_grads(arrays, gs, scaled, small_m):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in arrays[:5]]
    x, wg, wu, wo, sc = ts
    out = ops.moe_ffn(x, wg, wu, wo, torch.from_numpy(gs),
                      row_scales=sc if scaled else None, block_m=32,
                      small_m=small_m)
    out.backward(torch.from_numpy(arrays[5]))
    return to_np(out), [None if t.grad is None else to_np(t.grad)
                        for t in ts]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("small_m", [False, True])
@pytest.mark.parametrize("sizes", [[37, 0, 90, 73], [1, 1, 1, 197],
                                   [50, 50, 50, 50]])
def test_moe_ffn_grads_match_jax(sizes, small_m, scaled):
    arrays = _inputs(sizes)
    gs = np.asarray(sizes, np.int32)
    want_out, want = _jax_vjp(arrays, gs, scaled, small_m=small_m,
                              use_kernel=False)
    got_out, got = _port_grads(arrays, gs, scaled, small_m)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    for name, g, w in zip(NAMES, got, want):
        if name == "scales" and not scaled:
            assert g is None
            continue
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    for i, size in enumerate(sizes):
        if size == 0:  # an expert that received no token: exact zeros
            for g in got[1:4]:
                assert not g[i].any()


def test_moe_ffn_grads_match_pallas_interpret():
    """The reference's own Pallas kernels (gmm_glu_tiled_pair, gmm_tiled,
    gmm_dw_tiled) in interpret mode, on a tiny packed case."""
    sizes = [20, 0, 45]
    arrays = _inputs(sizes, d=16, f=24, seed=4)
    gs = np.asarray(sizes, np.int32)
    want_out, want = _jax_vjp(arrays, gs, True, small_m=False,
                              use_kernel=True, interpret=True, block_k=16,
                              block_n=16)
    got_out, got = _port_grads(arrays, gs, True, False)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_moe_ffn_function_saves_inputs_only():
    """The packed route's autograd node keeps the inputs (no packed
    activation): what the backward reads is rebuilt from them."""
    arrays = _inputs([37, 0, 90, 73])
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in arrays[:5]]
    out = ops.moe_ffn(*ts[:4], torch.tensor([37, 0, 90, 73]),
                      row_scales=ts[4], block_m=32, small_m=False)
    saved = out.grad_fn.saved_tensors
    shapes = sorted(tuple(t.shape) for t in saved)
    assert shapes == sorted([(200,), (200, 32), (4, 32, 48), (4, 32, 48),
                             (4, 48, 32), (4,)])


def test_group_products_bf16_gradient_is_the_widened_products():
    """``_group_products_f32`` on bf16 operands (no autograd formula for
    ``bmm(..., out_dtype=float32)``) has the gradient of the widened
    products, rounded once to each input's dtype."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((6, 16), generator=g).bfloat16().requires_grad_(True)
    w = torch.randn((3, 16, 8), generator=g).bfloat16().requires_grad_(True)
    dy = torch.randn((3, 6, 8), generator=g)
    y = ops._group_products_f32(a, w)
    assert y.dtype == torch.float32
    y.backward(dy)
    a2 = a.detach().clone().requires_grad_(True)
    w2 = w.detach().clone().requires_grad_(True)
    y2 = torch.bmm(a2.float().expand(3, 6, 16), w2.float())
    y2.backward(dy)
    assert torch.equal(y.detach(), y2.detach())
    assert a.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    torch.testing.assert_close(a.grad.float(), a2.grad.float(), rtol=0,
                               atol=0)
    torch.testing.assert_close(w.grad.float(), w2.grad.float(), rtol=0,
                               atol=0)
