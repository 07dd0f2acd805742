"""Wrappers around the kernels, forward subset (mirror of
``repro/kernels/ops.py``): pack metadata and row scatter/gather of the
packed expert domain, the single-pack MoE expert FFN with its small-M
group-dense route, and paged decode attention.

Routing decisions are the JAX package's, so both packages compute the same
things: the small-M crossover (``M * (G - 1) <= G * block_m``), the padded
size ``Mp = round_up(M, block_m) + G * block_m`` and the clipping of
trailing tiles to group G - 1. The kernel wrappers choose kernel or plain
version by the device of their tensors, so there is no ``use_kernel``
switch. Forward only: serving needs no gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import gmm as gmm_kernel
from repro_torch.kernels import paged_attention as pa


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Paged decode attention (serving, DESIGN.md §9)
# ---------------------------------------------------------------------------

def paged_kv_positions(page_table, page_size: int):
    """Structural key positions of a paged cache view.

    page_table: [B, MP] int32 (-1 = unallocated). Returns [B, MP*page_size]
    int32: line l of table slot j is position j*page_size + l; lines of
    unallocated slots are -1 (masked out by ``attention_mask``). Positions
    are never read from the pool, which keeps stale lines of recycled pages
    past the new owner's causal frontier (§9.2)."""
    B, MP = page_table.shape
    dev = page_table.device
    pos = (torch.arange(MP, dtype=torch.int32, device=dev)[:, None]
           * page_size
           + torch.arange(page_size, dtype=torch.int32, device=dev)[None, :])
    pos = pos[None].expand(B, MP, page_size)
    return torch.where(page_table[:, :, None] >= 0, pos,
                       torch.full_like(pos, -1)).reshape(B, -1)


def paged_gather_kv(k_pool, v_pool, page_table):
    """Per-slot contiguous KV view of the paged pool.

    k_pool/v_pool: [P, page_size, KH, hd]; page_table: [B, MP]. Returns
    (k [B, MP*ps, KH, hd], v, kv_pos [B, MP*ps]) — the view the masked
    reference attention of chunked prefill consumes."""
    B, MP = page_table.shape
    ps, KH, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    ptc = page_table.clamp(min=0).long()
    k = k_pool[ptc].reshape(B, MP * ps, KH, hd)
    v = v_pool[ptc].reshape(B, MP * ps, KH, hd)
    return k, v, paged_kv_positions(page_table, ps)


def paged_decode_attention(q, k_pool, v_pool, page_table, q_pos, *,
                           scale: float | None = None, softcap: float = 0.0,
                           window: int = 0):
    """Single-token decode attention over the paged KV pool.

    q: [B, H, hd] (one query per slot); k_pool/v_pool: [P, ps, KH, hd];
    page_table: [B, MP] int32; q_pos: [B] int32 (current write position of
    each slot; < 0 = dead slot, output row is zeros). Returns [B, H, hd].
    The GQA group rides the kernel's warp axis: no padding of G or hd."""
    B, H, hd = q.shape
    KH = k_pool.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    out = pa.paged_decode_forward(
        q.reshape(B, KH, H // KH, hd).contiguous(), k_pool, v_pool,
        page_table, q_pos, scale=scale, softcap=softcap, window=window)
    return out.reshape(B, H, hd)


# ---------------------------------------------------------------------------
# Packed expert domain (MoE experts, DESIGN.md §5)
# ---------------------------------------------------------------------------

def _pack_meta(group_sizes, m: int, n_groups: int, block_m: int):
    """Destination row of each sorted row + group id of each m-tile.

    Static padded size: every group padded up to a block_m multiple. Group
    lookups are ``searchsorted`` (right side) against the cumulative group
    ends. Returns (dest [m] int64, tile_group [Mp / block_m] int32, Mp)."""
    dev = group_sizes.device
    gs = group_sizes.to(torch.int64)
    padded = ((gs + block_m - 1) // block_m) * block_m
    p_starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(padded, 0)[:-1]])
    ends = torch.cumsum(gs, 0)
    starts = ends - gs
    row = torch.arange(m, dtype=torch.int64, device=dev)
    gid = torch.searchsorted(ends, row, right=True).clamp(0, n_groups - 1)
    dest = p_starts[gid] + (row - starts[gid])

    mp = _round_up(m, block_m) + n_groups * block_m  # static upper bound
    tile_ends = torch.cumsum(padded // block_m, 0)
    tile = torch.arange(mp // block_m, dtype=torch.int64, device=dev)
    tile_group = torch.searchsorted(tile_ends, tile, right=True).clamp(
        0, n_groups - 1).to(torch.int32)
    return dest, tile_group, mp


def _scatter_rows(values, dest, mp: int):
    """values [M, d] -> packed [Mp, d]; the ONE pack scatter (dest is
    strictly increasing and unique by construction; pad rows are 0)."""
    out = torch.zeros((mp, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out[dest] = values
    return out


def _gather_rows(packed, dest):
    """Packed [Mp, d] -> [M, d]; the ONE unpack gather."""
    return packed[dest]


def _group_products_f32(a, w):
    """Unrounded f32 products of ``a`` ([M, K], shared by every group, or
    [G, M, K]) with each group's ``w`` [G, K, N] -> [G, M, N] — the JAX
    package's ``preferred_element_type=float32``. On the card a bf16
    product is written in f32 straight from the GEMM (``out_dtype``),
    reading the weights as they lie; on the CPU the operands are widened
    first, which gives the same exact products and f32 sums."""
    if a.dim() == 2:
        a = a.expand(w.shape[0], *a.shape)
    if a.dtype == torch.float32:
        return torch.bmm(a, w)
    if a.is_cuda:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


def moe_ffn_group_dense(x_sorted, wi_gate, wi_up, wo, group_sizes, *,
                        row_scales=None):
    """Small-M (decode-shape) expert FFN: dense per-group GEMMs + a per-row
    select. O(G·M·d·f) arithmetic, but no pack scatter and none of the
    packed route's ~G·block_m pad rows. g, u and y are f32 sums, as in the
    JAX package; only h is rounded to the compute dtype."""
    M = x_sorted.shape[0]
    G = wi_gate.shape[0]
    dev = x_sorted.device
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    gid = torch.searchsorted(ends, torch.arange(M, device=dev),
                             right=True).clamp(0, G - 1)
    g = _group_products_f32(x_sorted, wi_gate)
    u = _group_products_f32(x_sorted, wi_up)
    h = (F.silu(g) * u).to(x_sorted.dtype)
    y = _group_products_f32(h, wo)
    y = y[gid, torch.arange(M, device=dev)]
    if row_scales is not None:
        y = y * row_scales.float()[:, None]
    return y.to(x_sorted.dtype)


def moe_ffn(x_sorted, wi_gate, wi_up, wo, group_sizes, *, row_scales=None,
            block_m: int = 128, small_m: bool | None = None):
    """Whole GLU expert FFN over expert-sorted rows, packed once.

    x_sorted: [M, d] rows sorted by group (M == sum(group_sizes));
    wi_gate/wi_up: [G, d, f]; wo: [G, f, d]; group_sizes: [G] int.
    Returns [M, d] = (silu(x @ wi_gate_g) * (x @ wi_up_g)) @ wo_g per row,
    times row_scales[r] when given (router combine weights, applied to the
    unpacked rows in the compute dtype).

    small_m: True forces / False forbids the group-dense route; None picks
    it when M * (G - 1) <= G * block_m. Otherwise: one pack scatter, the
    fused gate+up GLU kernel and the down-projection kernel in the packed
    domain, one unpack gather."""
    M = x_sorted.shape[0]
    G = wi_gate.shape[0]
    if small_m is None:
        small_m = M * (G - 1) <= G * block_m
    if small_m:
        return moe_ffn_group_dense(x_sorted, wi_gate, wi_up, wo, group_sizes,
                                   row_scales=row_scales)
    dest, tile_group, mp = _pack_meta(group_sizes, M, G, block_m)
    x_p = _scatter_rows(x_sorted, dest, mp)
    h_p = gmm_kernel.gmm_glu_tiled_pair(x_p, wi_gate, wi_up, tile_group,
                                        block_m=block_m)
    out_p = gmm_kernel.gmm_tiled(h_p, wo, tile_group, block_m=block_m)
    out = _gather_rows(out_p, dest)
    if row_scales is not None:
        out = out * row_scales.to(out.dtype)[:, None]
    return out
