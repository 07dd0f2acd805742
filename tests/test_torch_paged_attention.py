"""repro_torch paged decode attention against the JAX package.

The cases of the JAX package's paged serving tests (window, softcap, dead
slot, unallocated table slots, a dense oracle, stale lines of recycled
pages) at 2e-5: the port's plain version (CPU) against the Pallas kernel
in interpret mode and against the XLA gather fallback. Plus the
page-table scatter of ``_apply_attention_paged``, and the arithmetic of
the CUDA kernel, which splits each slot's page walk across blocks and
combines the splits (:func:`_emulate_split_decode`), against the Pallas
kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.models import modules as jmodules
from repro.models.config import ModelConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import modules
from repro_torch.pytree import params_from_jax
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
B, H, KH, hd, P, ps, MP = 3, 4, 2, 16, 10, 8, 4


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(P, ps, KH, hd).astype(np.float32)
    vp = rng.randn(P, ps, KH, hd).astype(np.float32)
    pt = np.asarray([[3, 7, 1, -1], [0, -1, -1, -1], [5, 2, -1, -1]],
                    np.int32)
    q_pos = np.asarray([19, -1, 9], np.int32)
    return q, kp, vp, pt, q_pos


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("kw", [{}, dict(window=6), dict(softcap=5.0),
                                dict(window=6, softcap=5.0)])
def test_paged_decode_matches_pallas_and_fallback(kw):
    arrays = _inputs()
    ker = jops.paged_decode_attention(*_j(*arrays), use_kernel=True,
                                      interpret=True, **kw)
    fb = jops.paged_decode_attention(*_j(*arrays), use_kernel=False, **kw)
    got = to_np(ops.paged_decode_attention(*_t(*arrays), **kw))
    np.testing.assert_allclose(got, np.asarray(ker), **TOL)
    np.testing.assert_allclose(got, np.asarray(fb), **TOL)
    assert np.all(got[1] == 0)  # dead slot -> zeros


def test_paged_decode_dense_oracle():
    """Pages 0..2 hold positions 0..23 contiguously: the paged result is
    plain softmax attention over the first q_pos + 1 lines."""
    _, kp, vp, _, _ = _inputs()
    rng = np.random.RandomState(1)
    qq = rng.randn(1, H, hd).astype(np.float32)
    pt3 = np.asarray([[0, 1, 2, -1]], np.int32)
    qp3 = np.asarray([13], np.int32)
    out = to_np(ops.paged_decode_attention(*_t(qq, kp, vp, pt3, qp3)))
    k_lin = kp[:3].reshape(24, KH, hd)[:14]
    v_lin = vp[:3].reshape(24, KH, hd)[:14]
    qf = qq.reshape(KH, H // KH, hd)
    s = np.einsum("kgh,tkh->kgt", qf, k_lin) * hd ** -0.5
    pr = np.exp(s - s.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    o = np.einsum("kgt,tkh->kgh", pr, v_lin).reshape(1, H, hd)
    np.testing.assert_allclose(out, o, rtol=1e-5, atol=1e-5)


def test_unallocated_slots_and_no_live_key():
    """-1 table slots are skipped; a live slot whose only pages are
    unallocated has no live key and returns 0 (divide by 1, not 0)."""
    q, kp, vp, _, _ = _inputs()
    pt = np.asarray([[-1, 4, -1, 6], [-1, -1, -1, -1], [2, -1, -1, -1]],
                    np.int32)
    q_pos = np.asarray([30, 5, 3], np.int32)
    got = to_np(pa.paged_decode_forward(
        *_t(q.reshape(B, KH, H // KH, hd), kp, vp, pt, q_pos),
        scale=hd ** -0.5))
    ker = jops.paged_decode_attention(*_j(q, kp, vp, pt, q_pos),
                                      use_kernel=True, interpret=True)
    np.testing.assert_allclose(got.reshape(B, H, hd), np.asarray(ker), **TOL)
    assert np.all(got[1] == 0) and np.all(np.isfinite(got))


def test_stale_lines_of_recycled_pages_unreachable():
    rng = np.random.RandomState(1)
    kp = rng.randn(4, ps, KH, hd).astype(np.float32)
    vp = rng.randn(4, ps, KH, hd).astype(np.float32)
    q = rng.randn(1, 4, hd).astype(np.float32)
    pt = np.asarray([[2, 3]], np.int32)
    q_pos = np.asarray([11], np.int32)  # lines 0..11 live, 12..15 stale
    base = to_np(ops.paged_decode_attention(*_t(q, kp, vp, pt, q_pos)))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[3, 4:] = 99.0
    vp2[3, 4:] = -99.0
    got = to_np(ops.paged_decode_attention(*_t(q, kp2, vp2, pt, q_pos)))
    np.testing.assert_allclose(base, got, rtol=1e-6, atol=1e-6)


def _emulate_split_decode(q, kp, vp, pt, q_pos, pages_per_split, *, scale,
                          softcap=0.0, window=0):
    """paged_decode_forward as csrc/paged_attention.cu computes it, in f32:
    each (slot, KV head)'s table slots cut into splits of pages_per_split;
    per split, over its live key positions (the frontier, the window; -1
    table slots skipped) in tiles of pa.DECODE_TILE lines from the split's
    start, the online softmax (m, l, acc), m = -inf and l = 0 where no
    line is live; then the splits combined in order, those with m = -inf
    skipped, divided by l (by 1 where no split had a live line); dead
    slots 0."""
    B, KH, G, hd = q.shape
    ps, MP, TL = kp.shape[1], pt.shape[1], pa.DECODE_TILE
    splits = max(1, -(-MP // pages_per_split))
    out = torch.zeros((B, KH, G, hd))
    for b in range(B):
        qp = int(q_pos[b])
        for h in range(KH):
            parts = []
            for s in range(splits):
                j0 = s * pages_per_split
                j1 = min(MP, j0 + pages_per_split)
                lo = max(j0 * ps, qp - window + 1 if window > 0 else 0)
                hi = min(j1 * ps - 1, qp)
                m = torch.full((G,), -torch.inf)
                l, acc = torch.zeros(G), torch.zeros((G, hd))
                for t0 in range(j0 * ps, j1 * ps, TL):
                    first, last = max(t0, lo), min(t0 + TL - 1, hi)
                    if qp < 0 or first > last:
                        continue
                    kpos = torch.arange(first, last + 1)
                    pages = pt[b, kpos // ps].long()
                    kpos, pages = kpos[pages >= 0], pages[pages >= 0]
                    if kpos.numel() == 0:
                        continue
                    k = kp[pages, kpos % ps, h].float()
                    v = vp[pages, kpos % ps, h].float()
                    sc = (q[b, h].float() @ k.T) * scale
                    if softcap > 0:
                        sc = softcap * torch.tanh(sc / softcap)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ v
                    m = m_new
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            L, A = torch.zeros(G), torch.zeros((G, hd))
            for m, l, acc in parts:
                live = m > -torch.inf
                w = torch.where(live, torch.exp(m - M), 0.0)
                L += torch.where(live, w * l, 0.0)
                A += torch.where(live[:, None], w[:, None] * acc, 0.0)
            out[b, h] = A / torch.where(L == 0, 1.0, L)[:, None]
    return out


def _long_table_inputs(seed=3):
    """Two slots of 20 table slots of 8 lines: slot 0 at position 150 with
    unallocated table slots 4, 5 and 9 and everything past its frontier
    -1, slot 1 dead."""
    rng = np.random.RandomState(seed)
    Bl, MPl, Pl = 2, 20, 48
    q = rng.randn(Bl, KH, H // KH, hd).astype(np.float32)
    kp = rng.randn(Pl, ps, KH, hd).astype(np.float32)
    vp = rng.randn(Pl, ps, KH, hd).astype(np.float32)
    pt = rng.permutation(Pl)[:Bl * MPl].reshape(Bl, MPl).astype(np.int32)
    pt[0, [4, 5, 9]] = -1
    pt[0, 150 // ps + 1:] = -1
    return q, kp, vp, pt, np.asarray([150, -1], np.int32)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 7])
@pytest.mark.parametrize("kw", [{}, dict(window=6), dict(softcap=5.0),
                                dict(window=37, softcap=5.0)])
@pytest.mark.parametrize("table", ["short", "long"])
def test_split_decode_arithmetic_matches_pallas(table, kw, pages_per_split):
    """The split-then-combine arithmetic against the Pallas kernel in
    interpret mode, within 1e-5 * max|JAX| (f32): splits of 1, 2, 3 and 7
    pages (7 x 8 lines: two tiles a split), -1 table slots, dead slots,
    splits with no live line (past the frontier, before the window, all
    -1), window and softcap."""
    if table == "short":
        q, kp, vp, pt, q_pos = _inputs()
        q = q.reshape(B, KH, H // KH, hd)
    else:
        q, kp, vp, pt, q_pos = _long_table_inputs()
    kw = dict(kw, scale=hd ** -0.5)
    got = to_np(_emulate_split_decode(*_t(q, kp, vp, pt, q_pos),
                                      pages_per_split, **kw))
    want = np.asarray(jpa.paged_decode_forward(*_j(q, kp, vp, pt, q_pos),
                                               interpret=True, **kw))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.all(got[q_pos < 0] == 0) and np.all(np.isfinite(got))


def test_paged_gather_and_positions_match_jax():
    _, kp, vp, pt, _ = _inputs()
    jk, jv, jpos = jops.paged_gather_kv(*_j(kp, vp, pt))
    tk, tv, tpos = ops.paged_gather_kv(*_t(kp, vp, pt))
    np.testing.assert_array_equal(to_np(tk), np.asarray(jk))
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(to_np(tpos), np.asarray(jpos))


TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                   n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64)


def test_paged_decode_write_matches_jax_and_drops_dead():
    """Per-slot decode scatter through the table: slot 0 at position 9
    (table slot 1 -> page 2, line 1), slot 1 dead, slot 2 at position 3
    (page 0, line 3); nothing else is written."""
    jp = split_params(jmodules.init_attention(jax.random.PRNGKey(1), TINY))[0]
    tp = params_from_jax(jax_values_np(jp))
    x = np.random.RandomState(0).randn(3, 1, TINY.d_model).astype(np.float32)
    pt = np.asarray([[4, 2, -1], [-1, -1, -1], [0, -1, -1]], np.int32)
    pos = np.asarray([[9], [-1], [3]], np.int32)
    ci = np.asarray([9, -1, 3], np.int32)
    jc = jmodules.init_paged_attention_cache(TINY, 5, 8, jnp.float32)
    jrun = JRun(policy=JPolicy(compute_dtype=jnp.float32))
    jy, jc = jmodules.apply_attention(jp, TINY, jrun, jnp.asarray(x),
                                      jnp.asarray(pos), causal=True,
                                      cache=jc, cache_index=jnp.asarray(ci),
                                      page_table=jnp.asarray(pt))
    tc = modules.init_paged_attention_cache(TINY, 5, 8, torch.float32)
    run = modules.RunConfig(policy=modules.Policy(
        compute_dtype=torch.float32))
    ty, tc = modules.apply_attention(tp, TINY, run, *_t(x, pos), causal=True,
                                     cache=tc,
                                     cache_index=torch.from_numpy(ci),
                                     page_table=torch.from_numpy(pt))
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(to_np(tc[k]), np.asarray(jc[k]), **TOL)
    expect = np.full((5, 8), -1)
    expect[2, 1], expect[0, 3] = 9, 3
    np.testing.assert_array_equal(to_np(tc["pos"]), expect)
    # Live rows agree. The dead row is discarded by the engine: the port's
    # decode kernel (like the JAX package's on its TPU) writes zeros there,
    # while the JAX gather fallback averages every masked line.
    live = [0, 2]
    np.testing.assert_allclose(to_np(ty)[live], np.asarray(jy)[live],
                               rtol=1e-4, atol=1e-5)
    assert np.all(to_np(ty)[1] == 0)
