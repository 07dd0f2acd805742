"""repro_torch expert weight gradient (``gmm_dw_tiled``) and the grouped
GEMM's backward operand types, against the JAX package.

The port's wrappers run their plain versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode (and its XLA fallback
``ops._tiles_dw_xla``). Tolerance 1e-5 (f32 sums in another order); a
group that owns no tile has an exactly zero gradient. bf16 inputs are
rounded from the same f32 numpy arrays on both sides (round to nearest
even in both packages), so the operands are identical.

The tensor-core kernel (``csrc/gmm_dw_wgmma.cu``) cannot run here; its
arithmetic can. :func:`_emulate_wgmma_dw` repeats it in plain torch (each
f32 operand split into three bf16 terms, the kernel's six or three term
products, each exact in f32, summed in f32) and is held to the JAX kernel
at 1e-5 * max|JAX|, and the split itself is held to be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import gmm as jgmm
from repro.kernels import ops as jops
from repro_torch.kernels import gmm, ops
from torch_parity import split3 as _split3
from torch_parity import to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_M = 32


def _packed(sizes, K, N, seed=0, block_m=BLOCK_M, wide=False):
    """Tile-aligned lhs [Mp, K] and dout [Mp, N] (pad rows zero) in numpy,
    and the port's tile_group. ``wide``: magnitudes 2^u, u uniform in
    [-20, 20], random signs."""
    rng = np.random.RandomState(seed)
    gs = np.asarray(sizes, np.int32)
    M = int(gs.sum())
    dest, tg, mp = ops._pack_meta(torch.from_numpy(gs), M, len(gs), block_m)
    if wide:
        def draw(*shape):
            return (np.sign(rng.randn(*shape))
                    * 2.0 ** rng.uniform(-20, 20, shape)).astype(np.float32)
        x, d = draw(M, K), draw(M, N)
    else:
        x = (rng.randn(M, K) * 0.5).astype(np.float32)
        d = (rng.randn(M, N) * 0.5).astype(np.float32)
    lhs = to_np(ops._scatter_rows(torch.from_numpy(x), dest, mp))
    dout = to_np(ops._scatter_rows(torch.from_numpy(d), dest, mp))
    return lhs, dout, tg


@pytest.mark.parametrize("sizes,K,N", [
    ([37, 0, 90, 73], 32, 48),    # zero-token group
    ([37, 0, 90, 73], 40, 56),    # K, N not multiples of the JAX tiles
    ([0, 0, 200, 0], 24, 8),      # one group holds every row
    ([1, 1, 1, 197], 64, 32),
])
def test_gmm_dw_matches_pallas_and_xla(sizes, K, N):
    lhs, dout, tg = _packed(sizes, K, N)
    G = len(sizes)
    got = gmm.gmm_dw_tiled(torch.from_numpy(lhs), torch.from_numpy(dout),
                           tg, G, block_m=BLOCK_M)
    assert got.dtype == torch.float32 and got.shape == (G, K, N)
    jtg = jnp.asarray(to_np(tg))
    want = jgmm.gmm_dw_tiled(jnp.asarray(lhs), jnp.asarray(dout), jtg, G,
                             block_m=BLOCK_M, block_k=32, block_n=32,
                             interpret=True)
    xla = jops._tiles_dw_xla(jnp.asarray(lhs), jnp.asarray(dout), jtg, G,
                             BLOCK_M)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(got), np.asarray(xla), **TOL)
    for g, size in enumerate(sizes):
        if size == 0:
            assert not to_np(got[g]).any(), "empty group must be exact zeros"


def test_gmm_dw_bf16_lhs_and_out_dtype_match_pallas():
    """A bf16 lhs (the packed x under the bf16 policy) is widened exactly,
    as the reference's ``lhs_p.astype(f32)``; ``out_dtype`` rounds once."""
    lhs, dout, tg = _packed([37, 0, 90, 73], 32, 48, seed=1)
    lhs_bf = torch.from_numpy(lhs).to(torch.bfloat16)
    jl = jnp.asarray(lhs).astype(jnp.bfloat16)
    jtg = jnp.asarray(to_np(tg))
    want = jgmm.gmm_dw_tiled(jl.astype(jnp.float32), jnp.asarray(dout), jtg,
                             4, block_m=BLOCK_M, block_k=32, block_n=32,
                             interpret=True)
    got = gmm.gmm_dw_tiled(lhs_bf, torch.from_numpy(dout), tg, 4,
                           block_m=BLOCK_M)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    got_bf = gmm.gmm_dw_tiled(lhs_bf, torch.from_numpy(dout), tg, 4,
                              block_m=BLOCK_M, out_dtype=torch.bfloat16)
    assert got_bf.dtype == torch.bfloat16
    assert torch.equal(got_bf, got.to(torch.bfloat16))


def _weights(G, K, N, seed=2):
    return (np.random.RandomState(seed).randn(G, K, N) * 0.2).astype(
        np.float32)


# (lhs dtype, rhs dtype, out dtype, rhs transposed): the forward and the
# MoE FFN backward's uses of gmm_tiled (ops.py:414-437).
VARIANTS = [
    ("bf16", "bf16", "f32", False),   # recompute of g and u (bf16 policy)
    ("f32", "bf16", "f32", False),    # y = h @ wo on the unrounded f32 h
    ("f32", "bf16", "f32", True),     # dh / dx against swapaxes(W)
    ("f32", "f32", "f32", True),      # the same under the f32 policy
    ("f32", "f32", "f32", False),
    ("bf16", "bf16", "bf16", False),  # the forward down projection
]
_T = {"bf16": torch.bfloat16, "f32": torch.float32}
_J = {"bf16": jnp.bfloat16, "f32": jnp.float32}


@pytest.mark.parametrize("lhs_t,rhs_t,out_t,trans", VARIANTS)
def test_gmm_tiled_operand_types_match_pallas(lhs_t, rhs_t, out_t, trans):
    sizes, K, N = [37, 0, 90, 73], 40, 56
    lhs, _, tg = _packed(sizes, K, 8, seed=3)
    w = _weights(len(sizes), N, K) if trans else _weights(len(sizes), K, N)
    tl = torch.from_numpy(lhs).to(_T[lhs_t])
    tw = torch.from_numpy(w).to(_T[rhs_t])
    jl = jnp.asarray(lhs).astype(_J[lhs_t])
    jw = jnp.asarray(w).astype(_J[rhs_t])
    if trans:  # the reference widens swapaxes(W) to f32; the port reads
        tw = tw.transpose(1, 2)  # the view by stride and widens in place
        jw = jnp.swapaxes(jw, 1, 2).astype(jnp.float32)
        jl = jl.astype(jnp.float32)
    want = jgmm.gmm_tiled(jl, jw, jnp.asarray(to_np(tg)), block_m=BLOCK_M,
                          block_k=32, block_n=32, interpret=True,
                          out_dtype=_J[out_t])
    got = gmm.gmm_tiled(tl, tw, tg, block_m=BLOCK_M, out_dtype=_T[out_t])
    assert got.dtype == _T[out_t] and got.shape == (len(lhs), N)
    got = to_np(got.float())
    want = np.asarray(want.astype(jnp.float32))
    if out_t == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:  # one rounding to bf16 of f32 sums taken in another order
        ulp = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
        assert np.all(np.abs(got - want) <= ulp + 1e-6)


def test_rhs_layout_accepts_row_major_and_transposed_views_only():
    w = torch.zeros((3, 8, 5))
    assert gmm._rhs_layout(w, 8) == (False, 5)
    assert gmm._rhs_layout(w.transpose(1, 2), 5) == (True, 5)
    with pytest.raises(ValueError):
        gmm._rhs_layout(torch.zeros((3, 8, 10))[..., :5], 8)


def test_gmm_dw_wrapper_refuses_other_devices():
    lhs = torch.zeros((64, 8), device="meta")
    with pytest.raises(ValueError):
        gmm.gmm_dw_tiled(lhs, torch.zeros((64, 4), device="meta"),
                         torch.zeros(1, dtype=torch.int32, device="meta"), 1,
                         block_m=64)


# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (csrc/gmm_dw_wgmma.cu)
# ---------------------------------------------------------------------------

# (lhs term, dout term) of each product the kernel takes: f32 lhs, six of
# the nine (the three left out are each below 2^-24 |a||b|); bf16 lhs, its
# one term against dout's three.
F32_PASSES = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
BF16_PASSES = ((0, 0), (0, 1), (0, 2))
# hi rounds to bf16 inf at and above (2 - 2^-8) 2^127; under 2^-110 the
# third term falls below bf16's subnormal grid (2^-133).
SPLIT_MIN, SPLIT_END = 2.0 ** -110, (2 - 2.0 ** -8) * 2.0 ** 127


def _emulate_wgmma_dw(lhs, dout, tg, n_groups, block_m):
    """gmm_dw_tiled as the tensor-core kernel computes it: per m-tile, the
    sum over its passes of term_a^T @ term_b (bf16 terms, so every product
    is exact in f32; f32 sums), summed per group."""
    bf16 = lhs.dtype == torch.bfloat16
    a = (lhs,) if bf16 else _split3(lhs)
    b = _split3(dout)
    Mp, K = lhs.shape
    N = dout.shape[1]
    n_m = Mp // block_m
    out = torch.zeros((n_groups, K, N), dtype=torch.float32)
    for pa, pb in BF16_PASSES if bf16 else F32_PASSES:
        at = a[pa].float().reshape(n_m, block_m, K)
        bt = b[pb].float().reshape(n_m, block_m, N)
        out.index_add_(0, tg.long(), torch.bmm(at.transpose(1, 2), bt))
    return out


@pytest.mark.parametrize("lhs_t", ["f32", "bf16"])
@pytest.mark.parametrize("block_m", [8, 16, 32, 128])
@pytest.mark.parametrize("wide", [False, True])
def test_wgmma_dw_arithmetic_matches_pallas(lhs_t, block_m, wide):
    """The split and its passes against the JAX kernel's f32 dot, at
    1e-5 * max|JAX|, with a zero-token group (exact zeros), at every row
    tile the reference's routing gives and at magnitudes 2^-20 .. 2^20."""
    sizes = [37, 0, 90, 73]
    G, K, N = len(sizes), 40, 48
    lhs, dout, tg = _packed(sizes, K, N, seed=4, block_m=block_m, wide=wide)
    tl = torch.from_numpy(lhs).to(_T[lhs_t])
    jl = jnp.asarray(lhs).astype(_J[lhs_t]).astype(jnp.float32)
    want = np.asarray(jgmm.gmm_dw_tiled(
        jl, jnp.asarray(dout), jnp.asarray(to_np(tg)), G, block_m=block_m,
        block_k=32, block_n=32, interpret=True))
    got = to_np(_emulate_wgmma_dw(tl, torch.from_numpy(dout), tg, G,
                                  block_m))
    top = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * top
    assert not got[1].any(), "empty group must be exact zeros"
    # Against the exact (f64) sum, per output, in units of 2^-24 sum|a||b|:
    # the three-term split leaves only f32 summation error (under 11 units
    # at these inputs); a two-term split's dropped lo terms alone leave 36
    # to 297, so the three terms are needed to pass.
    a64, d64 = tl.double(), torch.from_numpy(dout).double()
    exact = gmm.gmm_dw_tiled_plain(a64, d64, tg, G, block_m=block_m,
                                   out_dtype=torch.float64)
    scale = gmm.gmm_dw_tiled_plain(a64.abs(), d64.abs(), tg, G,
                                   block_m=block_m, out_dtype=torch.float64)
    assert torch.all((torch.from_numpy(got).double() - exact).abs()
                     <= 16 * 2.0 ** -24 * scale)
    plain = to_np(gmm.gmm_dw_tiled(tl, torch.from_numpy(dout), tg, G,
                                   block_m=block_m))
    assert np.abs(got - plain).max() <= 1e-5 * top


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(st.floats(min_value=SPLIT_MIN, max_value=SPLIT_END,
                          exclude_max=True, width=32),
                min_size=1, max_size=64),
       st.booleans())
def test_split3_sums_to_x_exactly(mags, negative):
    """hi + mid + lo == x for every f32 x with 2^-110 <= |x| <
    (2 - 2^-8) 2^127 (the kernel's f32 operands: gradients and
    activations lie far inside)."""
    x = torch.tensor(mags, dtype=torch.float32) * (-1 if negative else 1)
    hi, mid, lo = _split3(x)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())


@pytest.mark.parametrize("x", [SPLIT_MIN, 1.0, float(np.nextafter(
    np.float32(1), np.float32(2))), 1 + 2 ** -8 + 2 ** -16 + 2 ** -23,
    3.0 * 2 ** -100, 2.0 ** 126 * (2 - 2 ** -23), float(np.nextafter(
        np.float32(SPLIT_END), np.float32(0)))])
def test_split3_is_exact_at_the_edges(x):
    """The split's edges: the smallest magnitude it holds, full 24-bit
    significands (every term used) and the largest f32 that hi does not
    round to inf."""
    for v in (x, -x):
        t = torch.tensor([v], dtype=torch.float32)
        hi, mid, lo = _split3(t)
        assert hi.double() + mid.double() + lo.double() == t.double()
