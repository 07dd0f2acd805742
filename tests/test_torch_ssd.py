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
  row, dA over all of them);
* the arithmetic of the tensor-core kernel (``csrc/ssd_wgmma.cu``), which
  cannot run here: :func:`_emulate_wgmma_ssd` repeats it in plain torch
  (dt folded into the f32 factors, each factor split into three bf16
  terms, the products summed in f64, the chunk states passed in order) and
  is held to the Pallas kernel's f32 y and state at 1e-5 * max|JAX| on
  bf16 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssd as jssd
from repro_torch.kernels import ops, ref, ssd
from torch_parity import split3 as _split3
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


# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (csrc/ssd_wgmma.cu)
# ---------------------------------------------------------------------------

def _terms_dot(eq, factor, other):
    """sum over the three bf16 terms of ``factor`` of einsum(eq, term,
    other), in f64: each product of two bf16 values is exact, as on the
    tensor cores."""
    return sum(torch.einsum(eq, t.double(), other.double())
               for t in _split3(factor))


def _block_scan_f32(la):
    """An f32 block scan of the kind a kernel would run (128 threads of two
    rows each, a shuffle scan per warp, the warps' totals in order), the
    f32 alternative to the kernel's f64 scan: [..., Q] -> [..., Q]."""
    *lead, Q = la.shape
    v = F.pad(la, (0, 256 - Q)).reshape(*lead, 4, 32, 2)
    v0, v1 = v[..., 0], v[..., 1]
    incl = v0 + v1
    for off in (1, 2, 4, 8, 16):
        nxt = incl.clone()
        nxt[..., off:] = incl[..., off:] + incl[..., :-off]
        incl = nxt
    excl = F.pad(incl[..., :-1], (1, 0))
    before = [torch.zeros_like(incl[..., 0, 0])]
    for w in range(3):
        before.append(before[-1] + incl[..., w, 31])
    c0 = (torch.stack(before, -1)[..., None] + excl) + v0
    return torch.stack([c0, c0 + v1], -1).reshape(*lead, 256)[..., :Q]


def _emulate_wgmma_ssd(x, dt, A, B, C, *, chunk, scan=None):
    """ssd_scan as the tensor-core kernel computes it, on bf16 x, B, C:
    per (batch, head) and chunk of Q rows, la = dt·A (f32) and its cumsum in
    f64, each exponent's argument an f64 difference rounded once to f32;
    (a) ΔS_cᵀ = (x ⊙ dt·exp(total - cum))ᵀ·B on the split factor; (b) the
    states passed in order, S = fma(exp(total), S, ΔS) in f32, keeping the
    state entering each chunk; (c) y = exp(cum)·(C·S_prev) on the split
    S_prev, plus M·x with M = (C·Bᵀ ⊙ exp(cum_i - cum_j))·dt_j (j <= i),
    split. Products are summed in f64 (the kernel sums them in f32: only
    the order and width of the sums differ). ``scan`` replaces the f64
    cumsum by an f32 one (differences then in f32). Returns y unrounded
    (f64) and the final state [b, h, hd, ns] f32."""
    b, T, h, hd = x.shape
    ns = B.shape[-1]
    Q = ssd.chunk_rows(T, chunk)
    nc = -(-T // Q)
    pad = nc * Q - T
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(
        b, nc, Q, h, hd).permute(0, 3, 1, 2, 4)          # [b, h, nc, Q, hd]
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, Q, h).permute(0, 3, 1, 2)
    Bc = F.pad(B.float(), (0, 0, 0, pad)).reshape(b, 1, nc, Q, ns)
    Cc = F.pad(C.float(), (0, 0, 0, pad)).reshape(b, 1, nc, Q, ns)
    live = (torch.arange(nc * Q) < T).reshape(nc, Q)
    la = torch.where(live, dtc * A[None, :, None, None], 0.0)
    cum = (torch.cumsum(la.double(), -1) if scan is None
           else scan(la))                                 # [b, h, nc, Q]
    total = cum[..., -1:]
    # (a) chunk states, transposed: [b, h, nc, hd, ns]
    w = torch.where(live, dtc * torch.exp((total - cum).float()), 0.0)
    dS = _terms_dot("bhcjd,bxcjn->bhcdn", xc * w[..., None], Bc).float()
    # (b) state passing
    S = torch.zeros((b, h, hd, ns))
    prev = []
    for c in range(nc):
        prev.append(S)
        et = torch.exp(total[:, :, c].float()).double()[..., None]
        S = (et * S.double() + dS[:, :, c].double()).float()
    prev = torch.stack(prev, dim=2)
    # (c) chunk outputs
    G = torch.einsum("bxcin,bxcjn->bxcij", Cc.double(), Bc.double()).float()
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    diff = (cum[..., :, None] - cum[..., None, :]).float()
    M = torch.where(tri, G * torch.exp(torch.where(tri, diff, 0.0))
                    * dtc[..., None, :], 0.0)
    inter = _terms_dot("bhcdn,bxcin->bhcid", prev, Cc).float() \
        * torch.exp(cum.float())[..., None]
    y = inter.double() + _terms_dot("bhcij,bhcjd->bhcid", M, xc)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * Q, h, hd)[:, :T]
    return y, S


def _pallas_f32(x, dt, A, B, C, *, chunk):
    """The JAX package's ``ssd_pallas`` (interpret mode) on the inputs as
    its ``ops._ssd_kernel_call`` prepares them (x̄ = x·dt and la = dt·A in
    f32, T padded to the chunk), with y left in f32 (the call rounds it to
    x's dtype afterwards). Returns numpy y [b, T, h, hd] and state."""
    b, T, h, hd = x.shape
    ns = B.shape[-1]
    Q = ssd.chunk_rows(T, chunk)
    pad = (-T) % Q
    la = (dt * A[None, None, :]).swapaxes(1, 2).reshape(b * h, T)
    xbar = jnp.moveaxis(x.astype(jnp.float32) * dt[..., None], 2, 1)
    y, state = jssd.ssd_pallas(
        jnp.pad(xbar.reshape(b * h, T, hd), ((0, 0), (0, pad), (0, 0))),
        jnp.pad(la, ((0, 0), (0, pad))),
        jnp.pad(B.astype(jnp.float32), ((0, 0), (0, pad), (0, 0))),
        jnp.pad(C.astype(jnp.float32), ((0, 0), (0, pad), (0, 0))),
        h, chunk=Q, interpret=True)
    y = np.asarray(y[:, :T]).reshape(b, h, T, hd).swapaxes(1, 2)
    return y, np.asarray(state).reshape(b, h, hd, ns)


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("b,T,h,hd,ns,chunk", [
    (2, 300, 2, 64, 64, 128),     # three chunks, the last ragged
    (1, 100, 2, 64, 128, 256),    # T < 128: one chunk of 128
    (1, 640, 2, 128, 128, 256),   # hd 128 (two column slices), ragged
    (2, 384, 3, 64, 128, 192),    # a chunk of three 64-row tiles
])
def test_wgmma_ssd_arithmetic_matches_pallas(b, T, h, hd, ns, chunk, seed):
    """The kernel's arithmetic against the Pallas kernel's f32 y (before
    the bf16 cast) and final state at 1e-5 * max|JAX| each, on bf16 x, B
    and C; the bf16 y of ``ssd_scan_plain`` agrees with it at the bf16
    tier."""
    (x, dt, A, B, C), jargs = _inputs(b, T, h, hd, ns, "bf16", seed=seed)
    y, state = _emulate_wgmma_ssd(x, dt, A, B, C, chunk=chunk)
    jy, jstate = _pallas_f32(*jargs, chunk=chunk)
    assert np.abs(y.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    assert np.abs(state.numpy() - jstate).max() \
        <= 1e-5 * np.abs(jstate).max()
    y_p, _ = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    _close(y_p, y.float().to(torch.bfloat16).float().numpy(), "bf16")


def test_f32_block_scan_misses_the_state_tier():
    """Why the kernel scans the chunk's cumsum in f64: with an f32 block
    scan (another order than the reference's sequential cumsum) the
    difference total - cum_j of two prefix sums near |cum| ~ 10^2..10^3
    loses their shared rounding, and the state falls outside 1e-5 *
    max|JAX| (3.05e-5 here); the same case passes with the f64 scan
    above."""
    (x, dt, A, B, C), jargs = _inputs(2, 300, 2, 64, 64, "bf16", seed=2)
    _, state = _emulate_wgmma_ssd(x, dt, A, B, C, chunk=128,
                                  scan=_block_scan_f32)
    _, jstate = _pallas_f32(*jargs, chunk=128)
    assert np.abs(state.numpy() - jstate).max() \
        > 2e-5 * np.abs(jstate).max()
