"""Plain-torch oracles (mirror of ``repro/kernels/ref.py``): GQA attention
with its structural mask, and the grouped expert GEMMs. They are the ground
truth the flash attention kernels and the packed pipeline in
:mod:`repro_torch.kernels.ops` are validated against."""

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
