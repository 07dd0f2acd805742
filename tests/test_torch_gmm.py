"""repro_torch grouped expert GEMMs and the MoE FFN against the JAX package.

The port's kernel wrappers run their plain versions on CPU tensors; the
JAX side runs its Pallas kernels in interpret mode. Pack metadata (dest,
tile_group, Mp) must match exactly; values at 1e-5 (f32). Cases include a
zero-token group and non-tile-multiple groups. One bf16 case holds the
group-dense route's f32 products against the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gmm as jgmm
from repro.kernels import ops as jops
from repro.models import modules as jmodules
from repro.models.config import LayerSpec, ModelConfig
from repro_torch.kernels import gmm, ops, ref
from repro_torch.models import modules
from torch_parity import to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

SIZE_CASES = [
    [37, 0, 90, 73],
    [0, 0, 200, 0],
    [1, 1, 1, 197],
    [50, 50, 50, 50],
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _ffn(sizes, d=32, f=48, seed=0):
    rng = np.random.RandomState(seed)
    M, G = sum(sizes), len(sizes)
    x = (rng.randn(M, d) * 0.5).astype(np.float32)
    wg = (rng.randn(G, d, f) * 0.1).astype(np.float32)
    wu = (rng.randn(G, d, f) * 0.1).astype(np.float32)
    wo = (rng.randn(G, f, d) * 0.1).astype(np.float32)
    return x, wg, wu, wo, np.asarray(sizes, np.int32)


def _both(*arrays):
    """(jax arrays, torch tensors) of the same numpy inputs."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


@pytest.mark.parametrize("block_m", [32, 128])
@pytest.mark.parametrize("sizes", SIZE_CASES)
def test_pack_meta_matches_jax(sizes, block_m):
    gs = np.asarray(sizes, np.int32)
    jd, jt, jmp = jops._pack_meta(jnp.asarray(gs), int(gs.sum()), len(gs),
                                  block_m)
    td, tt, tmp = ops._pack_meta(torch.from_numpy(gs), int(gs.sum()),
                                 len(gs), block_m)
    assert tmp == jmp
    np.testing.assert_array_equal(to_np(td), np.asarray(jd))
    np.testing.assert_array_equal(to_np(tt), np.asarray(jt))
    assert tt.dtype == torch.int32


@pytest.mark.parametrize("sizes", [[37, 0, 90, 73], [1, 1, 1, 197]])
def test_gmm_tiled_matches_pallas(sizes):
    x, wg, _, _, gs = _ffn(sizes)
    block_m = 32
    dest, tg, mp = ops._pack_meta(torch.from_numpy(gs), len(x), len(gs),
                                  block_m)
    x_p = to_np(ops._scatter_rows(torch.from_numpy(x), dest, mp))
    want = jgmm.gmm_tiled(jnp.asarray(x_p), jnp.asarray(wg),
                          jnp.asarray(to_np(tg)), block_m=block_m,
                          block_k=32, block_n=48, interpret=True)
    got = gmm.gmm_tiled(torch.from_numpy(x_p), torch.from_numpy(wg), tg,
                        block_m=block_m)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("sizes", [[37, 0, 90, 73], [50, 50, 50, 50]])
def test_gmm_glu_pair_and_stacked_match_pallas(sizes):
    x, wg, wu, _, gs = _ffn(sizes)
    block_m = 32
    dest, tg, mp = ops._pack_meta(torch.from_numpy(gs), len(x), len(gs),
                                  block_m)
    x_p = to_np(ops._scatter_rows(torch.from_numpy(x), dest, mp))
    tg_np = to_np(tg)
    kw = dict(block_m=block_m, block_k=32, block_n=48, interpret=True)
    want = jgmm.gmm_glu_tiled_pair(jnp.asarray(x_p), jnp.asarray(wg),
                                   jnp.asarray(wu), jnp.asarray(tg_np), **kw)
    stacked = np.concatenate([wg, wu], axis=-1)
    want_st = jgmm.gmm_glu_tiled(jnp.asarray(x_p), jnp.asarray(stacked),
                                 jnp.asarray(tg_np), **kw)
    got = gmm.gmm_glu_tiled_pair(torch.from_numpy(x_p), torch.from_numpy(wg),
                                 torch.from_numpy(wu), tg, block_m=block_m)
    got_st = gmm.gmm_glu_tiled(torch.from_numpy(x_p),
                               torch.from_numpy(stacked), tg,
                               block_m=block_m)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(got_st), np.asarray(want_st), **TOL)
    np.testing.assert_array_equal(to_np(got), to_np(got_st))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("small_m", [False, True])
@pytest.mark.parametrize("sizes", SIZE_CASES)
def test_moe_ffn_both_routes_match_jax(sizes, small_m, scaled):
    x, wg, wu, wo, gs = _ffn(sizes)
    scales = np.random.RandomState(5).rand(len(x)).astype(np.float32)
    (jx, jwg, jwu, jwo, jgs, jsc), (tx, twg, twu, two, tgs, tsc) = _both(
        x, wg, wu, wo, gs, scales)
    want = jops.moe_ffn(jx, jwg, jwu, jwo, jgs,
                        row_scales=jsc if scaled else None, block_m=32,
                        small_m=small_m, use_kernel=not small_m,
                        interpret=True)
    got = ops.moe_ffn(tx, twg, twu, two, tgs,
                      row_scales=tsc if scaled else None, block_m=32,
                      small_m=small_m)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    oracle = ref.moe_ffn(tx, twg, twu, two, tgs)
    if scaled:
        oracle = oracle * tsc[:, None]
    np.testing.assert_allclose(to_np(got), to_np(oracle), **TOL)


@pytest.mark.parametrize("sizes", [[37, 0, 90, 73], [3, 1, 0, 4]])
def test_group_dense_bf16_keeps_f32_products_like_jax(sizes):
    """bf16 policy on the group-dense route: g, u and y are f32 sums in
    both packages (``preferred_element_type=float32``), only h and the
    output are rounded to bf16. The outputs then differ only where the
    f32 summation order flips a bf16 rounding: at most 1% of them, by one
    bf16 ulp (plus 1e-3 * max|out| for outputs near 0, whose sums cancel).
    Rounding g, u and y to bf16 as well changes about 60% of the
    outputs."""
    rng = np.random.RandomState(3)
    M, G, d, f = sum(sizes), len(sizes), 256, 512
    arrays = [(rng.randn(M, d) * 0.5).astype(np.float32),
              (rng.randn(G, d, f) / np.sqrt(d)).astype(np.float32),
              (rng.randn(G, d, f) / np.sqrt(d)).astype(np.float32),
              (rng.randn(G, f, d) / np.sqrt(f)).astype(np.float32),
              rng.rand(M).astype(np.float32)]
    gs = np.asarray(sizes, np.int32)
    jx, jwg, jwu, jwo, jsc = (jnp.asarray(a).astype(jnp.bfloat16)
                              for a in arrays)
    tx, twg, twu, two, tsc = (torch.from_numpy(a).to(torch.bfloat16)
                              for a in arrays)
    want = np.asarray(jops.moe_ffn(jx, jwg, jwu, jwo, jnp.asarray(gs),
                                   row_scales=jsc, small_m=True)
                      .astype(jnp.float32))
    got = ops.moe_ffn(tx, twg, twu, two, torch.from_numpy(gs),
                      row_scales=tsc, small_m=True)
    assert got.dtype == torch.bfloat16
    got = to_np(got.float())
    one_ulp = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= one_ulp + 1e-3 * np.abs(want).max())
    assert (got != want).mean() <= 0.01


def test_moe_ffn_auto_route_crossover_matches_jax():
    """M * (G - 1) <= G * block_m picks group-dense, else packed: the
    port routes exactly like the JAX package (ops.py:514-519)."""
    calls = []
    orig = ops.moe_ffn_group_dense

    def spy(*a, **k):
        calls.append("dense")
        return orig(*a, **k)

    ops.moe_ffn_group_dense = spy
    try:
        for M, G, dense in ((146, 8, True), (147, 8, False),
                            (133, 24, True), (134, 24, False)):
            sizes = [M // G] * G
            sizes[0] += M - sum(sizes)
            x, wg, wu, wo, gs = _ffn(sizes, d=8, f=8)
            calls.clear()
            ops.moe_ffn(*(torch.from_numpy(a) for a in (x, wg, wu, wo, gs)))
            assert (calls == ["dense"]) == dense, (M, G)
    finally:
        ops.moe_ffn_group_dense = orig


MOE_CFG = ModelConfig(name="moe", family="moe", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, d_ff=48, vocab_size=64,
                      pattern=(LayerSpec(ffn="moe"),), n_experts=4, top_k=2)


@pytest.mark.parametrize("seq", [4, 90])  # decode-shape (dense) / packed
def test_apply_moe_matches_jax_and_dense_reference(seq):
    from repro.models.modules import Policy as JPolicy
    from repro.models.modules import RunConfig as JRun
    rng = np.random.RandomState(7)
    d, f, e = 32, 48, 4
    p_np = {"router": rng.randn(d, e).astype(np.float32) * 0.3,
            "wi_gate": rng.randn(e, d, f).astype(np.float32) * 0.1,
            "wi_up": rng.randn(e, d, f).astype(np.float32) * 0.1,
            "wo": rng.randn(e, f, d).astype(np.float32) * 0.1}
    x = rng.randn(2, seq, d).astype(np.float32)
    jrun = JRun(policy=JPolicy(compute_dtype=jnp.float32))
    want, jaux = jmodules.apply_moe(
        {k: jnp.asarray(v) for k, v in p_np.items()}, MOE_CFG, jrun,
        jnp.asarray(x))
    run = modules.RunConfig(policy=modules.Policy(
        compute_dtype=torch.float32))
    tp = {k: torch.from_numpy(v) for k, v in p_np.items()}
    got, aux = modules.apply_moe(tp, MOE_CFG, run, torch.from_numpy(x))
    dense, _ = modules.apply_moe(
        tp, MOE_CFG, modules.RunConfig(policy=run.policy, moe_impl="dense"),
        torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(got), to_np(dense), **TOL)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)


def test_cpu_wrappers_refuse_other_devices():
    t = torch.zeros((64, 8), device="meta")
    w = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        gmm.gmm_tiled(t, w, torch.zeros(1, dtype=torch.int32, device="meta"),
                      block_m=64)
    with pytest.raises(ValueError):  # mixed devices
        gmm.gmm_tiled(torch.zeros((64, 8)), w,
                      torch.zeros(1, dtype=torch.int32), block_m=64)
