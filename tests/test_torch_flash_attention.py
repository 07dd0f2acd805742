"""repro_torch flash attention against the JAX package.

The port runs the plain versions of its kernels (CPU tensors); the JAX
package runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does. Inputs are numpy arrays from a seed.

* forward: ``ops.flash_attention`` over the sweep of
  ``tests/test_kernels.py::test_flash_matches_ref`` at its tolerances
  (2e-5 f32, 2e-2 bf16), causal cases only where S == T as there;
* o and lse of ``flash_forward`` against ``fa.flash_forward`` on padded
  tensors, with rows that have no live key: o == 0 and lse == _NEG
  exactly in both packages;
* dq, dk, dv of the autograd Function against ``jax.vjp`` of the JAX
  ``ops.flash_attention`` in f32, within 2e-5 * max|want|, among them
  cross-attention's regime: non-causal, T > S, T not a multiple of 64;
* softcap: forward parity, and the backward raises as the reference's;
* the oracles ``ref.attention`` / ``ref.causal_window_mask`` against the
  JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from torch_parity import to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

SHAPES = [(1, 128, 128, 2, 2, 64), (2, 200, 200, 4, 2, 32),
          (1, 96, 160, 4, 1, 64)]
MASKS = [(True, 0), (False, 0), (True, 48)]
SWEEP = [pytest.param(shape, causal, window, id="x".join(map(str, shape))
                      + f"-causal{int(causal)}-window{window}")
         for shape in SHAPES for causal, window in MASKS
         if not causal or shape[1] == shape[2]]


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(a.copy())
    j = jnp.asarray(a)
    if dtype == "bf16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,causal,window", SWEEP)
def test_flash_forward_matches_jax(dtype, shape, causal, window):
    B, S, T, H, KH, hd = shape
    arrays = _arrays((B, S, H, hd), (B, T, KH, hd), (B, T, KH, hd))
    (q, jq), (k, jk), (v, jv) = (_pair(a, dtype) for a in arrays)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    assert got.shape == (B, S, H, hd) and got.dtype == q.dtype
    tol = 2e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(to_np(got.float()),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("q_len,kv_len", [(130, 130), (130, 100)])
def test_flash_forward_lse_and_dead_rows_match_jax(q_len, kv_len):
    """Tensors padded to 256 rows as the JAX kernel takes them; causal with
    window 1 (each row sees only its own key), so rows >= kv_len and the
    padded rows have no live key."""
    B, H, KH, P, hd = 2, 4, 2, 256, 32
    q, k, v = _arrays((B, H, P, hd), (B, KH, P, hd), (B, KH, P, hd), seed=1)
    kw = dict(scale=hd ** -0.5, causal=True, window=1, softcap=0.0,
              q_len=q_len, kv_len=kv_len)
    o, lse = fa.flash_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw)
    jo, jlse = jfa.flash_forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), interpret=True, **kw)
    o, lse, jo, jlse = to_np(o), to_np(lse), np.asarray(jo), np.asarray(jlse)
    dead = np.arange(P) >= kv_len
    for out, l in ((o, lse), (jo, jlse)):
        assert np.all(out[:, :, dead] == 0)
        assert np.all(l[:, :, dead] == np.float32(fa._NEG))
    np.testing.assert_allclose(o, jo, atol=2e-5)
    np.testing.assert_allclose(lse[:, :, ~dead], jlse[:, :, ~dead],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,T,causal,window", [
    (160, 160, True, 0),
    (160, 160, True, 48),
    (96, 160, False, 0),
    (40, 100, False, 0),  # cross-attention: T > S, T not a multiple of 64
])
def test_flash_gradients_match_jax(S, T, causal, window):
    B, H, KH, hd = 2, 4, 2, 32
    q, k, v, ct = _arrays((B, S, H, hd), (B, T, KH, hd), (B, T, KH, hd),
                          (B, S, H, hd), seed=2)

    def jflash(q, k, v):
        return jops.flash_attention(q, k, v, causal=causal, window=window)

    _, vjp = jax.vjp(jflash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*ins, causal=causal, window=window)
    out.backward(torch.from_numpy(ct))
    for name, t, w in zip(("dq", "dk", "dv"), ins, want):
        w = np.asarray(w)
        np.testing.assert_allclose(to_np(t.grad), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(), err_msg=name)


def test_flash_softcap_forward_matches_jax_and_backward_raises():
    B, S, H, KH, hd, cap = 2, 96, 4, 2, 32, 5.0
    q, k, v = _arrays((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd), seed=3)
    q = 4.0 * q  # logits well past the cap, so the tanh bends them
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, softcap=cap)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = ops.flash_attention(*ins, causal=True, softcap=cap)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-5)
    with pytest.raises(NotImplementedError, match="softcap"):
        got.sum().backward()


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 48, 0), (True, 16, 40)])
def test_attention_oracles_match_jax(causal, window, q_offset):
    B, S, T, H, KH, hd = 2, 70, 110, 4, 2, 32
    q, k, v = _arrays((B, S, H, hd), (B, T, KH, hd), (B, T, KH, hd), seed=4)
    m = ref.causal_window_mask(S, T, causal, window, q_offset)
    jm = jref.causal_window_mask(S, T, causal, window, q_offset)
    np.testing.assert_array_equal(to_np(m), np.asarray(jm))
    got = ref.attention(*(torch.from_numpy(a) for a in (q, k, v)), mask=m,
                        softcap=3.0)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask=jm, softcap=3.0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-5)


def test_flash_plain_matches_oracle_with_ragged_lengths():
    """flash_forward_plain on padded tensors equals the oracle on the true
    lengths; the padded rows are zero."""
    B, H, KH, hd, S, T = 2, 4, 2, 32, 90, 70
    q, k, v = _arrays((B, S + 10, H, hd), (B, T + 30, KH, hd),
                      (B, T + 30, KH, hd), seed=5)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    o, _ = fa.flash_forward(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), scale=hd ** -0.5,
                            causal=False, window=30, q_len=S, kv_len=T)
    want = ref.attention(q[:, :S], k[:, :T], v[:, :T],
                         mask=ref.causal_window_mask(S, T, False, 30))
    torch.testing.assert_close(o.transpose(1, 2)[:, :S], want, rtol=0,
                               atol=2e-5)
    assert torch.all(o[:, :, S:] == 0)
