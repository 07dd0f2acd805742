"""The arithmetic of the tensor-core GEMM of an f32 lhs against a bf16
weight (``csrc/gmm_f32_wgmma.cu``), on the CPU against the JAX package, in
both of the kernel's weight layouts: the data gradients' transposed weight
(``dh = dout @ swapaxes(wo)``) and the row-major weight of the
router-scale gradient's recompute (``y = h @ wo``).

The kernel cannot run here; its arithmetic can. :func:`_emulate_split_gmm`
repeats it in plain torch: the f32 lhs split into three bf16 terms
(``torch_parity.split3``, the kernel's ``sm90.cuh`` split3), each term
multiplied by the bf16 weight (every product exact in f32), the three
summed in f32. It is held within 1e-5 * max|JAX| to the JAX package's
``gmm_tiled`` Pallas kernel in interpret mode, fed as the MoE backward
feeds it: ``swapaxes(W).astype(f32)`` (``src/repro/kernels/ops.py:
426-435``) or the f32 h and the bf16 ``wo`` as they are (``ops.py:422``,
through its ``_gemm``, ``ops.py:361-365``); and, per output, to the exact
f64 product; at ragged groups, an empty group (its rows are pad rows:
exact zeros) and block_m 8, 32 and 128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gmm as jgmm
from repro_torch.kernels import gmm, ops
from torch_parity import split3, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)


def _rhs(w, trans):
    """The [G, K, N] operand of a weight as it lies: swapaxes of a [G, N, K]
    weight (trans), or the row-major [G, K, N] weight itself."""
    return w.transpose(1, 2) if trans else w


def _emulate_split_gmm(lhs, w, tile_group, block_m, trans=True):
    """gmm_tiled(lhs, rhs) as the tensor-core kernel computes it, with rhs =
    swapaxes(w, 1, 2) of w [G, N, K] bf16 (trans) or w [G, K, N] bf16 (the
    weight as it lies, either way): lhs [Mp, K] f32; per m-tile the sum
    over the lhs's three bf16 terms of term @ rhs[g], in f32."""
    Mp, K = lhs.shape
    n_m = Mp // block_m
    rhs = _rhs(w[tile_group.long()].float(), trans)   # exact: bf16 -> f32
    out = torch.zeros((n_m, block_m, rhs.shape[-1]), dtype=torch.float32)
    for term in split3(lhs):
        out += torch.bmm(term.float().reshape(n_m, block_m, K), rhs)
    return out.reshape(Mp, -1)


def _case(sizes, K, N, block_m, wide, seed, trans=True):
    """Tile-aligned f32 lhs [Mp, K] (pad rows zero), W rounded to bf16
    ([G, N, K] when ``trans``, else [G, K, N]), and the port's tile_group.
    ``wide``: lhs magnitudes 2^u, u uniform in [-20, 20], random signs (a
    cotangent's spread)."""
    rng = np.random.RandomState(seed)
    gs = np.asarray(sizes, np.int32)
    M, G = int(gs.sum()), len(sizes)
    dest, tg, mp = ops._pack_meta(torch.from_numpy(gs), M, G, block_m)
    if wide:
        x = (np.sign(rng.randn(M, K))
             * 2.0 ** rng.uniform(-20, 20, (M, K))).astype(np.float32)
    else:
        x = (rng.randn(M, K) * 0.5).astype(np.float32)
    lhs = ops._scatter_rows(torch.from_numpy(x), dest, mp)
    shape = (G, N, K) if trans else (G, K, N)
    w = torch.from_numpy((rng.randn(*shape) / np.sqrt(K)).astype(
        np.float32)).to(torch.bfloat16)
    return lhs, w, tg


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("block_m", [8, 32, 128])
@pytest.mark.parametrize("sizes,K,N,wide", [
    ([37, 0, 90, 73], 40, 48, False),   # an empty group, ragged groups
    ([37, 0, 90, 73], 40, 48, True),    # magnitudes 2^-20 .. 2^20
    ([1, 150, 0, 5], 96, 80, False),    # the card tests' K, N
])
def test_split_gmm_arithmetic_matches_pallas(sizes, K, N, wide, block_m,
                                             trans):
    lhs, w, tg = _case(sizes, K, N, block_m, wide, seed=len(sizes) + K,
                       trans=trans)
    got = _emulate_split_gmm(lhs, w, tg, block_m, trans)
    assert got.shape == (lhs.shape[0], N) and got.dtype == torch.float32
    if trans:   # dh: swapaxes(W).astype(f32), exact
        jw = jnp.swapaxes(jnp.asarray(to_np(w.float())), 1, 2).astype(
            jnp.float32)
    else:       # y: the bf16 wo as it is
        jw = jnp.asarray(to_np(w.float())).astype(jnp.bfloat16)
    want = np.asarray(jgmm.gmm_tiled(
        jnp.asarray(to_np(lhs)), jw, jnp.asarray(to_np(tg)),
        block_m=block_m, block_k=32, block_n=32, interpret=True,
        out_dtype=jnp.float32))
    top = float(np.abs(want).max())
    assert np.abs(to_np(got) - want).max() <= 1e-5 * top
    # the pad rows (the empty group owns only those) are exact zeros
    pad = to_np(lhs.abs().sum(1) == 0)
    assert pad.any() and not to_np(got)[pad].any()
    # Against the exact (f64) product, per output, in units of 2^-24
    # sum|a||w|: nothing is left out of the split, so only the f32 sums'
    # rounding remains.
    exact = gmm.gmm_tiled_plain(lhs.double(), _rhs(w.double(), trans), tg,
                                block_m=block_m)
    scale = gmm.gmm_tiled_plain(lhs.double().abs(),
                                _rhs(w.double().abs(), trans), tg,
                                block_m=block_m)
    err = (got.double() - exact).abs()
    assert torch.all(err <= 16 * 2.0 ** -24 * scale)
    assert float(err.max()) <= 1e-5 * float(exact.abs().max())


def test_split_gmm_one_term_misses_the_f32_tier():
    """The split's lower terms are needed: the hi term alone (a bf16
    rounding of the lhs, as a plain bf16 GEMM would take it) misses the
    1e-5 tier by orders of magnitude."""
    lhs, w, tg = _case([37, 0, 90, 73], 40, 48, 32, False, seed=9)
    exact = gmm.gmm_tiled_plain(lhs.double(), w.double().transpose(1, 2),
                                tg, block_m=32)
    hi_only = gmm.gmm_tiled_plain(split3(lhs)[0], w.transpose(1, 2), tg,
                                  block_m=32, out_dtype=torch.float32)
    top = float(exact.abs().max())
    assert float((hi_only.double() - exact).abs().max()) > 1e-3 * top
    full = _emulate_split_gmm(lhs, w, tg, 32)
    assert float((full.double() - exact).abs().max()) <= 1e-6 * top
