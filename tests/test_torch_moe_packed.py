"""repro_torch capacity-packed expert FFN against the JAX package.

``ops.chunk_capacity`` on a grid of capacities and chunk counts, and
``ops.moe_ffn_packed`` / ``ops.moe_ffn_packed_multi`` (the zebra engines'
expert call over [E, C, d] buffers: the no-pack variant of the MoE FFN
Function, or the group-dense route) against the JAX package's, one and
two segments, at capacities that select block_m 8, 16, 32 and 128, an odd
capacity padded up to a multiple of 8 and a segment of capacity 0, each
with ``small_m`` True, False and None: the outputs and the gradients of
every buffer and weight stack. The JAX package runs its Pallas kernels in
interpret mode (``use_kernel=True``), f32; tolerance 1e-5 (f32 sums in
another order).
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
D, F = 32, 48

# (groups, capacity) per segment; the block_m the packed route picks
CASES = {
    "bm8": ([(3, 24)], 8),
    "bm16": ([(3, 48)], 16),
    "bm32": ([(2, 96)], 32),
    "bm128": ([(2, 128)], 128),
    "odd13": ([(3, 13)], 16),       # padded to 16 rows
    "two_bm8": ([(2, 24), (3, 40)], 8),
    "two_bm16": ([(1, 32), (3, 48)], 16),
    "two_cap0": ([(2, 0), (3, 32)], 32),
}


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 8])
def test_chunk_capacity_matches_jax(n_chunks):
    for C in list(range(0, 70)) + [213, 216, 224, 1000, 1024]:
        got = ops.chunk_capacity(C, n_chunks)
        assert got == jops.chunk_capacity(C, n_chunks), (C, n_chunks)
        padded, per_chunk = got
        assert padded == max(n_chunks, 1) * per_chunk >= C
        assert per_chunk % 8 == 0 and per_chunk > 0


def _inputs(segs, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"bufs": [arr(g, c, D, scale=0.5) for g, c in segs],
            "wg": [arr(g, D, F, scale=0.2) for g, _ in segs],
            "wu": [arr(g, D, F, scale=0.2) for g, _ in segs],
            "wo": [arr(g, F, D, scale=0.2) for g, _ in segs],
            "ct": [arr(g, c, D) for g, c in segs]}


def _jax(a, small_m):
    def fn(bufs, wg, wu, wo):
        return jops.moe_ffn_packed_multi(bufs, wg, wu, wo, use_kernel=True,
                                         small_m=small_m)

    ins = [[jnp.asarray(x) for x in a[k]] for k in ("bufs", "wg", "wu", "wo")]
    out, vjp = jax.vjp(fn, *ins)
    grads = vjp([jnp.asarray(c) for c in a["ct"]])
    return [np.asarray(o) for o in out], [[np.asarray(g) for g in gs]
                                          for gs in grads]


def _port(a, small_m):
    ins = [[torch.from_numpy(x.copy()).requires_grad_(True) for x in a[k]]
           for k in ("bufs", "wg", "wu", "wo")]
    out = ops.moe_ffn_packed_multi(*ins, small_m=small_m)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in a["ct"]])
    return [to_np(o) for o in out], [[to_np(t.grad) for t in ts]
                                     for ts in ins]


@pytest.mark.parametrize("small_m", [False, True, None])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_packed_multi_matches_jax(case, small_m):
    segs, _ = CASES[case]
    a = _inputs(segs)
    want_out, want = _jax(a, small_m)
    got_out, got = _port(a, small_m)
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape == a["bufs"][i].shape
        np.testing.assert_allclose(g, w, err_msg=f"out {i}", **TOL)
    for name, gs, ws in zip(("bufs", "wi_gate", "wi_up", "wo"), got, want):
        for i, (g, w) in enumerate(zip(gs, ws)):
            np.testing.assert_allclose(g, w, err_msg=f"d{name} {i}", **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_packed_route_block_m_and_single_segment(case, monkeypatch):
    """The packed route's block_m (the largest of 128/64/32/16/8 dividing
    every capacity padded to 8) and its one GLU and one down-projection
    call per direction; ``moe_ffn_packed`` is the one-segment case."""
    segs, block_m = CASES[case]
    a = _inputs(segs, seed=1)
    seen = []
    real = ops._MoEFFN.apply

    def spy(x, wg, wu, wo, scales, meta, bm, pack):
        seen.append((bm, pack, tuple(x.shape), meta.numel()))
        return real(x, wg, wu, wo, scales, meta, bm, pack)

    monkeypatch.setattr(ops._MoEFFN, "apply", spy)
    bufs = [torch.from_numpy(b) for b in a["bufs"]]
    ws = [[torch.from_numpy(w) for w in a[k]] for k in ("wg", "wu", "wo")]
    outs = ops.moe_ffn_packed_multi(bufs, *ws)
    rows = sum(g * (-(-c // 8) * 8) for g, c in segs)
    assert seen == [(block_m, False, (rows, D), rows // block_m)]
    if len(segs) == 1:
        one = ops.moe_ffn_packed(bufs[0], *(w[0] for w in ws))
        torch.testing.assert_close(one, outs[0], rtol=0, atol=0)
