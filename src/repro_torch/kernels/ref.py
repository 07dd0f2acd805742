"""Plain-torch oracles (mirror of ``repro/kernels/ref.py``): GQA attention
with its structural mask, the grouped expert GEMMs and the mamba2 SSD scan
(sequential, chunked dual form, decode step). They are the ground truth the
flash attention kernels, the packed pipeline and the SSD scan kernel in
:mod:`repro_torch.kernels.ops` are validated against; ``ssd_chunked`` is
also the SSD scan's backward (autograd of the recomputed forward), and
``ssd_decode_step`` the cached mixer path, as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F


_BIG_NEG = -0.7 * torch.finfo(torch.float32).max


def attention(q, k, v, mask=None, scale=None, softcap: float = 0.0):
    """GQA attention oracle. q: [B,S,H,hd]; k/v: [B,T,KH,hd]; mask: [S,T]
    or [B,S,T] (True = attend).

    Logits and softmax in f32; the probabilities are cast to q's dtype for
    the value product, and the result is in q's dtype."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qf = q.reshape(B, S, KH, H // KH, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qf.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        logits = torch.where(m[:, None, None, :, :], logits, _BIG_NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(q.dtype), v.to(q.dtype))
    return out.reshape(B, S, H, hd)


def causal_window_mask(q_len: int, kv_len: int, causal: bool, window: int,
                       q_offset: int = 0, device=None):
    """Structural [q_len, kv_len] bool mask of the flash kernel path: key
    k is visible from query q (at position q + q_offset) when k <= q under
    ``causal`` and q - k < window when window > 0."""
    qp = torch.arange(q_len, device=device)[:, None] + q_offset
    kp = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & ((qp - kp) < window)
    return m


def _row_groups(group_sizes: torch.Tensor, m: int, n_groups: int):
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    row = torch.arange(m, device=group_sizes.device)
    gid = (row[:, None] >= ends[None, :]).sum(-1)
    return gid.clamp(0, n_groups - 1)


def gmm(lhs, rhs, group_sizes, preferred_element_type=None):
    """lhs: [M,K] rows sorted by group; rhs: [G,K,N]; group_sizes: [G].

    out[m] = lhs[m] @ rhs[g(m)] where g(m) is the group row m belongs to;
    products accumulate in f32 and round once to the output dtype."""
    gid = _row_groups(group_sizes, lhs.shape[0], rhs.shape[0])
    out = torch.einsum("mk,mkn->mn", lhs.float(), rhs[gid].float())
    return out.to(preferred_element_type or lhs.dtype)


def gmm_glu(lhs, rhs_stacked, group_sizes, preferred_element_type=None):
    """Fused-GLU oracle: rhs_stacked [G,K,2N] with gate weights in
    [..., :N] and up weights in [..., N:];
    out[m] = silu(lhs[m] @ gate_g) * (lhs[m] @ up_g)."""
    N = rhs_stacked.shape[-1] // 2
    gu = gmm(lhs, rhs_stacked, group_sizes,
             preferred_element_type=torch.float32)
    out = F.silu(gu[:, :N]) * gu[:, N:]
    return out.to(preferred_element_type or lhs.dtype)


def moe_ffn(x_sorted, wi_gate, wi_up, wo, group_sizes):
    """Whole-expert-FFN oracle: the ground truth for ops.moe_ffn.

    x_sorted: [M,d] rows sorted by expert; wi_*: [G,d,f]; wo: [G,f,d]."""
    g = F.silu(gmm(x_sorted, wi_gate, group_sizes,
                   preferred_element_type=torch.float32))
    u = gmm(x_sorted, wi_up, group_sizes, preferred_element_type=torch.float32)
    return gmm((g * u).to(x_sorted.dtype), wo, group_sizes)


# ---------------------------------------------------------------------------
# SSD (mamba2 state-space duality) oracles
# ---------------------------------------------------------------------------

def ssd_naive(x, dt, A, B, C, initial_state=None):
    """Sequential ground truth, all f32 inside (the JAX ``lax.scan`` is a
    loop over time).

    x: [b, T, h, d]; dt: [b, T, h]; A: [h]; B, C: [b, T, n].
    Returns (y [b, T, h, d] in x's dtype, final_state [b, h, d, n] f32)."""
    b, T, h, d = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    a = torch.exp(dtf * A[None, None, :])  # [b, T, h]
    xbar = xf * dtf[..., None]  # [b, T, h, d]
    S = (torch.zeros((b, h, d, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(T):
        S = S * a[:, t, :, None, None] \
            + xbar[:, t, :, :, None] * Bf[:, t, None, None, :]
        ys.append(torch.einsum("bhdn,bn->bhd", S, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), S


def ssd_chunked(x, dt, A, B, C, chunk: int = 128, initial_state=None):
    """Chunked (dual-form) SSD, the torch mirror of the JAX oracle: same
    signature and returns as :func:`ssd_naive`, matmul-dominant, and
    differentiable by autograd (the SSD scan's backward recomputes it)."""
    b, T, h, d = x.shape
    n = B.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // Q

    xf = x.float().reshape(b, nc, Q, h, d)
    dtf = dt.float().reshape(b, nc, Q, h)
    Bf = B.float().reshape(b, nc, Q, n)
    Cf = C.float().reshape(b, nc, Q, n)

    la = dtf * A[None, None, None, :]  # [b, nc, Q, h] log-decay
    cum = torch.cumsum(la, dim=2)  # inclusive cumsum within the chunk
    total = cum[:, :, -1, :]  # [b, nc, h]
    xbar = xf * dtf[..., None]

    # Intra-chunk: masked decay matrix L[i, j] = exp(cum_i - cum_j), j <= i.
    # The exponent is clamped BEFORE exp: for masked j > i it is positive
    # and can overflow; where() would then leak inf * 0 = NaN into the
    # backward.
    G = torch.einsum("bcin,bcjn->bcij", Cf, Bf)  # [b, nc, Q, Q]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,Q,Q,h]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    L = torch.exp(torch.where(tri, diff, -60.0)) * tri
    M = G[..., None] * L  # [b, nc, Q, Q, h]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", M, xbar)

    # Per-chunk state contribution and the inter-chunk recurrence.
    w = torch.exp(total[:, :, None, :] - cum)  # [b, nc, Q, h]
    S_local = torch.einsum("bcjn,bcjh,bcjhd->bchdn", Bf, w, xbar)
    S = (torch.zeros((b, h, d, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)  # the state entering chunk c
        S = S * torch.exp(total[:, c])[..., None, None] + S_local[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)  # [b, nc, h, d, n]
    y_inter = torch.einsum("bcin,bchdn,bcih->bcihd", Cf, S_prevs,
                           torch.exp(cum))

    y = (y_intra + y_inter).reshape(b, Tp, h, d)[:, :T]
    return y.to(x.dtype), S


def ssd_decode_step(x, dt, A, B, C, state):
    """Single-token (or short-S) sequential decode update.

    x: [b, S, h, d]; state: [b, h, d, n] f32. Returns (y, new_state)."""
    return ssd_naive(x, dt, A, B, C, initial_state=state)
