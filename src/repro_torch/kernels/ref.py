"""Plain-torch oracles for the grouped expert GEMMs (mirror of
``repro/kernels/ref.py``): the ground truth the packed pipeline in
:mod:`repro_torch.kernels.ops` is validated against."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
