"""repro_torch SSD scan (mamba2) against the JAX package.

The port runs the plain version of its scan kernel (CPU tensors); the JAX
package runs its Pallas kernel in interpret mode, through
``ops.ssd(use_kernel=True)``, as ``tests/test_kernels.py`` does. Inputs are
numpy arrays from a seed, over the three shapes of
``tests/test_kernels.py::test_ssd_kernel_matches_naive`` (one chunk of 32,
the ragged T 200 with chunk 64, T 256 with chunk 128).

* ``ssd_scan_plain`` against the Pallas kernel, and ``ref.ssd_naive`` /
  ``ref.ssd_chunked`` / ``ref.ssd_decode_step`` against the JAX oracles:
  f32 within 1e-5 * max|want| (the same f32 arithmetic, summed in other
  orders), bf16 within the 5e-2 tier of tests/test_kernels.py:142 (x is
  scaled so |y| < 8, where one bf16 ulp of y is below the tier);
* the forward and the five gradients (x, dt, A, B, C) of ``ops.ssd``
  against ``jax.vjp`` of the JAX ``ops.ssd(use_kernel=True)`` in f32,
  also at a ragged T and at T < 128 (the kernel's chunk drops to 128, the
  backward's to T), within 2e-5 * max|want| (the backward sums over every
  row, dA over all of them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, ssd
from torch_parity import to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

SHAPES = [(1, 64, 2, 16, 8, 32), (2, 200, 3, 32, 16, 64),
          (1, 256, 4, 64, 32, 128)]
GRAD_SHAPES = SHAPES[1:] + [(2, 100, 2, 32, 16, 256)]


def _inputs(b, T, h, hd, ns, dtype="f32", seed=0):
    """(torch tensors, jax arrays) of x, dt, A, B, C: dt = softplus(N(0,1)),
    A = -exp(N(0,1)), B and C scaled by 1/2 (the inputs of
    tests/test_kernels.py), x by 1/4 under bf16."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, T, h, hd) * (0.25 if dtype == "bf16" else 1.0)
    dt = np.log1p(np.exp(rng.randn(b, T, h)))
    A = -np.exp(rng.randn(h))
    B, C = 0.5 * rng.randn(b, T, ns), 0.5 * rng.randn(b, T, ns)
    arrays = [a.astype(np.float32) for a in (x, dt, A, B, C)]
    ts = [torch.from_numpy(a) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    if dtype == "bf16":
        for i in (0, 3, 4):
            ts[i] = ts[i].to(torch.bfloat16)
            js[i] = js[i].astype(jnp.bfloat16)
    return ts, js


def _close(got, want, dtype="f32", rel=1e-5):
    want = np.asarray(want, np.float32)
    tol = rel * float(np.abs(want).max()) if dtype == "f32" else 5e-2
    np.testing.assert_allclose(to_np(got.float()), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,T,h,hd,ns,chunk", SHAPES)
def test_ssd_scan_plain_matches_pallas(dtype, b, T, h, hd, ns, chunk):
    (x, dt, A, B, C), jargs = _inputs(b, T, h, hd, ns, dtype)
    y, state = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    jy, jstate = jops.ssd(*jargs, chunk=chunk, use_kernel=True,
                          interpret=True)
    assert y.shape == (b, T, h, hd) and y.dtype == x.dtype
    assert state.shape == (b, h, hd, ns) and state.dtype == torch.float32
    _close(y, jy, dtype)
    _close(state, jstate)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,T,h,hd,ns,chunk", SHAPES)
def test_ssd_oracles_match_jax(dtype, b, T, h, hd, ns, chunk):
    targs, jargs = _inputs(b, T, h, hd, ns, dtype, seed=1)
    for got, want in ((ref.ssd_naive(*targs), jref.ssd_naive(*jargs)),
                      (ref.ssd_chunked(*targs, chunk=chunk),
                       jref.ssd_chunked(*jargs, chunk=chunk))):
        assert got[0].dtype == targs[0].dtype
        _close(got[0], want[0], dtype)
        _close(got[1], want[1])


@pytest.mark.parametrize("b,T,h,hd,ns,chunk", SHAPES)
def test_ssd_decode_step_matches_jax(b, T, h, hd, ns, chunk):
    """Decode steps of 1 and of 5 tokens from a state that a prefix scan
    left, in both packages."""
    del chunk
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _inputs(b, T, h, hd, ns,
                                                      seed=2)
    split = T - 6
    _, state = ref.ssd_naive(x[:, :split], dt[:, :split], A, B[:, :split],
                             C[:, :split])
    _, jstate = jref.ssd_naive(jx[:, :split], jdt[:, :split], jA,
                               jB[:, :split], jC[:, :split])
    _close(state, jstate)
    for lo, hi in ((split, split + 1), (split + 1, T)):
        y, state = ref.ssd_decode_step(x[:, lo:hi], dt[:, lo:hi], A,
                                       B[:, lo:hi], C[:, lo:hi], state)
        jy, jstate = jref.ssd_decode_step(jx[:, lo:hi], jdt[:, lo:hi], jA,
                                          jB[:, lo:hi], jC[:, lo:hi], jstate)
        assert y.shape == (b, hi - lo, h, hd)
        _close(y, jy)
        _close(state, jstate)


@pytest.mark.parametrize("state_ct", [True, False])
@pytest.mark.parametrize("b,T,h,hd,ns,chunk", GRAD_SHAPES)
def test_ssd_grads_match_jax(b, T, h, hd, ns, chunk, state_ct):
    """Cotangents for y and (or not) the final state; without one the
    Function gets None for the state and the JAX vjp zeros."""
    targs, jargs = _inputs(b, T, h, hd, ns, seed=3)
    rng = np.random.RandomState(4)
    gy = rng.randn(b, T, h, hd).astype(np.float32)
    gs = (rng.randn(b, h, hd, ns) if state_ct
          else np.zeros((b, h, hd, ns))).astype(np.float32)

    ins = [t.clone().requires_grad_(True) for t in targs]
    y, state = ops.ssd(*ins, chunk=chunk)
    outs, cts = [y], [torch.from_numpy(gy)]
    if state_ct:
        outs.append(state)
        cts.append(torch.from_numpy(gs))
    got = torch.autograd.grad(outs, ins, cts)

    (jy, jstate), vjp = jax.vjp(
        lambda *a: jops.ssd(*a, chunk=chunk, use_kernel=True,
                            interpret=True), *jargs)
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    _close(y, jy)
    _close(state, jstate)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == tuple(w.shape), name
        _close(g, w, rel=2e-5)
