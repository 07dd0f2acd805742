"""Wrappers around the kernels (mirror of ``repro/kernels/ops.py``): flash
attention with its gradient, pack metadata and row scatter/gather of the
packed expert domain, the single-pack MoE expert FFN with its small-M
group-dense route, the FFN over capacity-packed [E, C, d] buffers that the
zebra engines call (``moe_ffn_packed``, ``moe_ffn_packed_multi``,
``chunk_capacity``), paged decode attention, and the mamba2 SSD scan with
its gradient.

Routing decisions are the JAX package's, so both packages compute the same
things: the small-M crossover (``M * (G - 1) <= G * block_m``), the padded
size ``Mp = round_up(M, block_m) + G * block_m`` and the clipping of
trailing tiles to group G - 1; and for capacity-packed buffers the
capacities padded to multiples of 8 and the block_m picked from them
(``packed_block_m``). The kernel wrappers choose kernel or plain
version by the device of their tensors, so there is no ``use_kernel``
switch. The packed route's gradient is one ``torch.autograd.Function``
(the JAX package's ``_make_moe_ffn`` custom_vjp) whose backward runs the
grouped GEMM and weight-gradient kernels; the group-dense route is
differentiated by autograd, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm as gmm_kernel
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as ssd_kernel


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient (the JAX package's ``_make_flash``
    custom_vjp). Works in the model layout [B, S, H, hd]: the kernels read
    and write it through a transposed view, so nothing is copied or padded.
    Saves q, k, v, o and lse; the backward runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float,
                softcap: float):
        o, lse = fa.flash_forward(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), scale=scale,
                                  causal=causal, window=window,
                                  softcap=softcap)
        o = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(scale=scale, causal=causal, window=window)
        ctx.softcap = softcap
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.softcap > 0:
            raise NotImplementedError(
                "flash backward with softcap: use attn_impl='ref'")
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_backward(
            *(t.transpose(1, 2) for t in (q, k, v, o)), lse,
            do.contiguous().transpose(1, 2), **ctx.kw)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None, None)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    scale: float | None = None, softcap: float = 0.0):
    """q: [B,S,H,hd]; k/v: [B,T,KH,hd] -> [B,S,H,hd] in q's dtype.

    Structural masking only (causal / sliding window, positions counted
    from 0 in both sequences); arbitrary masks take the reference path.
    Differentiable, except with ``softcap > 0`` (the reference has no
    softcap backward either)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(scale), float(softcap))


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
                           window: int = 0, return_lse: bool = False):
    """Single-token decode attention over the paged KV pool.

    q: [B, H, hd] (one query per slot); k_pool/v_pool: [P, ps, KH, hd];
    page_table: [B, MP] int32; q_pos: [B] int32 (current write position of
    each slot; < 0 = dead slot, output row is zeros). Returns [B, H, hd];
    with ``return_lse`` also each row's f32 log-sum-exp [B, H] (-inf for a
    row without a live key). The GQA group rides the kernel's warp axis:
    no padding of G or hd."""
    B, H, hd = q.shape
    KH = k_pool.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    out = pa.paged_decode_forward(
        q.reshape(B, KH, H // KH, hd).contiguous(), k_pool, v_pool,
        page_table, q_pos, scale=scale, softcap=softcap, window=window,
        return_lse=return_lse)
    if return_lse:
        return out[0].reshape(B, H, hd), out[1].reshape(B, H)
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


class _GroupProductsF32(torch.autograd.Function):
    """Unrounded f32 products of low-precision operands, with their
    gradient. On the card the GEMM writes f32 straight from bf16 operands
    (``torch.bmm(..., out_dtype=float32)``, which autograd cannot
    differentiate), and so on a fake tensor (the dry run's stand-in for
    one); on the CPU the operands are widened first, which gives the same
    exact products. The backward is the same f32 products of the
    cotangent with the widened other operand, rounded once to each
    input's dtype (the JAX package's transpose of a dot with
    ``preferred_element_type=float32``)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a3 = a.expand(w.shape[0], *a.shape) if a.dim() == 2 else a
        if a.is_cuda or _build.fake(a):
            return torch.bmm(a3, w, out_dtype=torch.float32)
        return torch.bmm(a3.float(), w.float())

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(dy, w.float().transpose(1, 2))
            if a.dim() == 2:
                da = da.sum(0)
            da = da.to(a.dtype)
        if ctx.needs_input_grad[1]:
            a3 = a.expand(w.shape[0], *a.shape) if a.dim() == 2 else a
            db = torch.bmm(a3.float().transpose(1, 2), dy).to(w.dtype)
        return da, db


def _group_products_f32(a, w):
    """Unrounded f32 products of ``a`` ([M, K], shared by every group, or
    [G, M, K]) with each group's ``w`` [G, K, N] -> [G, M, N] — the JAX
    package's ``preferred_element_type=float32``, differentiable."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        if a.dim() == 2:
            a = a.expand(w.shape[0], *a.shape)
        return torch.bmm(a, w)
    return _GroupProductsF32.apply(a, w)


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


def _tile_layout(meta, m: int, n_groups: int, block_m: int, pack: bool):
    """(dest, tile_group, Mp) of :class:`_MoEFFN`'s two variants: with
    ``pack`` the rows are expert-sorted and ``meta`` holds the group sizes
    (:func:`_pack_meta`); without it the rows are already tile-aligned,
    ``meta`` is the tile group of each m-tile and there is no dest map."""
    if pack:
        return _pack_meta(meta, m, n_groups, block_m)
    return None, meta, m


class _MoEFFN(torch.autograd.Function):
    """The packed-domain GLU FFN with its gradient (the JAX package's
    ``_make_moe_ffn`` custom_vjp, ops.py:341-444).

    ``pack=True`` (the route of :func:`moe_ffn`): x holds expert-sorted
    rows and ``meta`` the group sizes; one pack scatter in, one unpack
    gather out. ``pack=False`` (:func:`moe_ffn_packed_multi`): x is already
    the tile-aligned packed domain (capacity-packed buffers flattened) and
    ``meta`` the tile group of each m-tile; no scatter, no gather, and the
    backward reads x and the cotangent as they are.

    Saves the inputs only; the backward rebuilds the layout and recomputes
    the packed activations (stage-granular remat), in the reference's
    order: g and u in f32, the row-scale gradient from one extra grouped
    GEMM on the unrounded f32 h (scaled variant only), dwo, dh, dg/du
    through silu', dwg, dwu, dx. Data gradients multiply by the transposed
    weights read by stride (never copied); weight gradients come from the
    ``gmm_dw`` kernel. Gradients come back in each input's dtype, so under
    the bf16 policy the weight gradients are rounded to bf16 as in the JAX
    package."""

    @staticmethod
    def forward(ctx, x, wi_gate, wi_up, wo, scales, meta, block_m: int,
                pack: bool):
        M, G = x.shape[0], wi_gate.shape[0]
        dest, tile_group, mp = _tile_layout(meta, M, G, block_m, pack)
        ctx.block_m, ctx.pack = block_m, pack
        ctx.save_for_backward(x, wi_gate, wi_up, wo, scales, meta)
        x_p = _scatter_rows(x, dest, mp) if pack else x
        h_p = gmm_kernel.gmm_glu_tiled_pair(x_p, wi_gate, wi_up, tile_group,
                                            block_m=block_m)
        out_p = gmm_kernel.gmm_tiled(h_p, wo, tile_group, block_m=block_m)
        out = _gather_rows(out_p, dest) if pack else out_p
        if scales is not None:
            out = out * scales.to(out.dtype)[:, None]
        return out

    @staticmethod
    def backward(ctx, dout):
        x, wi_gate, wi_up, wo, scales, meta = ctx.saved_tensors
        bm, pack = ctx.block_m, ctx.pack
        M, G = x.shape[0], wi_gate.shape[0]
        f32 = torch.float32
        dest, tg, mp = _tile_layout(meta, M, G, bm, pack)

        def gemm(lhs, rhs):
            return gmm_kernel.gmm_tiled(lhs, rhs, tg, block_m=bm,
                                        out_dtype=f32)

        def dw(lhs, d, dtype):
            return gmm_kernel.gmm_dw_tiled(lhs, d, tg, G, block_m=bm,
                                           out_dtype=dtype)

        def unpack(rows):
            return _gather_rows(rows, dest) if pack else rows

        dout_f = dout.to(f32)
        d_rows = dout_f * scales.to(f32)[:, None] if scales is not None \
            else dout_f
        if pack:
            x_p = _scatter_rows(x, dest, mp)
            dout_p = _scatter_rows(d_rows, dest, mp)
        else:
            x_p, dout_p = x, d_rows.contiguous()
        # Recompute the pre-activations (f32) in the packed domain.
        g_p = gemm(x_p, wi_gate)
        u_p = gemm(x_p, wi_up)
        sg = torch.sigmoid(g_p)
        act = g_p * sg  # silu(g)
        h_p = act * u_p
        dscales = None
        if scales is not None:
            # d(scale_r) = dout_r . y_r needs the unscaled output rows:
            # one extra grouped GEMM (nothing was stored).
            y_rows = unpack(gemm(h_p, wo))
            dscales = (dout_f * y_rows).sum(-1).to(scales.dtype)
            del y_rows
        dwo = dw(h_p, dout_p, wo.dtype)
        del h_p
        dh_p = gemm(dout_p, wo.transpose(1, 2))
        del dout_p
        dg_p = dh_p * u_p * (sg * (1.0 + g_p * (1.0 - sg)))  # silu'
        du_p = dh_p * act
        del dh_p, g_p, u_p, sg, act
        dwg = dw(x_p, dg_p, wi_gate.dtype)
        dwu = dw(x_p, du_p, wi_up.dtype)
        dx_p = gemm(dg_p, wi_gate.transpose(1, 2)) \
            + gemm(du_p, wi_up.transpose(1, 2))
        dx = unpack(dx_p).to(x.dtype)
        return dx, dwg, dwu, dwo, dscales, None, None, None


def moe_ffn(x_sorted, wi_gate, wi_up, wo, group_sizes, *, row_scales=None,
            block_m: int = 128, small_m: bool | None = None,
            ep_size: int = 1):
    """Whole GLU expert FFN over expert-sorted rows, packed once.

    x_sorted: [M, d] rows sorted by group (M == sum(group_sizes));
    wi_gate/wi_up: [G, d, f]; wo: [G, f, d]; group_sizes: [G] int.
    Returns [M, d] = (silu(x @ wi_gate_g) * (x @ wi_up_g)) @ wo_g per row,
    times row_scales[r] when given (router combine weights, applied to the
    unpacked rows in the compute dtype).

    small_m: True forces / False forbids the group-dense route; None picks
    it when M * (Gs - 1) <= Gs * block_m, Gs = G // ep_size the per-shard
    group count (``ep_size``: the expert-parallel shards the G groups are
    spread over). Otherwise: one pack scatter, the fused gate+up GLU
    kernel and the down-projection kernel in the packed domain, one unpack
    gather, with the recomputing backward of :class:`_MoEFFN`."""
    M = x_sorted.shape[0]
    G = wi_gate.shape[0]
    if small_m is None:
        Gs = max(G // max(int(ep_size), 1), 1)
        small_m = M * (Gs - 1) <= Gs * block_m
    if small_m:
        return moe_ffn_group_dense(x_sorted, wi_gate, wi_up, wo, group_sizes,
                                   row_scales=row_scales)
    return _MoEFFN.apply(x_sorted, wi_gate, wi_up, wo, row_scales,
                         group_sizes, block_m, True)


def chunk_capacity(C: int, n_chunks: int) -> tuple:
    """Pad a per-expert capacity so it splits into ``n_chunks`` equal
    slices of a multiple of 8 rows (the zebra engines' chunked-dispatch
    layout). Returns (C_padded, C_chunk), C_padded == n_chunks * C_chunk;
    pad rows are zero and inert end to end."""
    q = max(int(n_chunks), 1)
    cq = _round_up(max(-(-C // q), 1), 8)
    return cq * q, cq


def packed_block_m(capacities) -> int:
    """The row tile of the packed route over capacity-packed segments: the
    largest of 128/64/32/16/8 dividing every capacity rounded up to a
    multiple of 8 (ops.py:621-627)."""
    caps = [_round_up(c, 8) for c in capacities]
    return next(b for b in (128, 64, 32, 16, 8)
                if all(c % b == 0 for c in caps))


def moe_ffn_packed(buf, wi_gate, wi_up, wo, *, block_m: int | None = None,
                   small_m: bool | None = False, ep_size: int = 1):
    """:func:`moe_ffn` for ALREADY capacity-packed [E, C, d] buffers (the
    zebra engines' dispatch layout): every expert owns exactly C contiguous
    rows, so the buffer IS the packed domain: no sort, no pack scatter, no
    unpack gather. Returns [E, C, d]."""
    return moe_ffn_packed_multi([buf], [wi_gate], [wi_up], [wo],
                                block_m=block_m, small_m=small_m,
                                ep_size=ep_size)[0]


def _packed_group_dense(bufs, wi_gates, wi_ups, wos):
    """Group-dense evaluation of capacity-packed segments (the small-M
    route): every [G_i, C_i, d] segment flattened to rows with uniform
    group sizes C_i, through :func:`moe_ffn_group_dense` (autograd, no
    tile padding). Returns the same list of [G_i, C_i, d] outputs as the
    packed route."""
    d = bufs[0].shape[-1]
    dev = bufs[0].device
    lhs = torch.cat([b.reshape(-1, d) for b in bufs])
    sizes = torch.cat([torch.full((b.shape[0],), b.shape[1],
                                  dtype=torch.int32, device=dev)
                       for b in bufs])
    out = moe_ffn_group_dense(lhs, torch.cat(wi_gates), torch.cat(wi_ups),
                              torch.cat(wos), sizes)
    outs, off = [], 0
    for b in bufs:
        g, c = b.shape[0], b.shape[1]
        outs.append(out[off:off + g * c].reshape(g, c, d))
        off += g * c
    return outs


def moe_ffn_packed_multi(bufs, wi_gates, wi_ups, wos, *,
                         block_m: int | None = None,
                         small_m: bool | None = False, ep_size: int = 1):
    """ONE grouped-GEMM GLU FFN over SEVERAL capacity-packed buffers.

    bufs[i]: [G_i, C_i, d] (capacities may differ per segment);
    wi_gates[i]/wi_ups[i]: [G_i, d, f]; wos[i]: [G_i, f, d]. The segments'
    weight stacks and rows are concatenated into one [G_total, ...] stack
    and one tile-aligned lhs with one tile-group map, so the call is ONE
    fused GLU launch and ONE down-projection launch (the no-pack variant of
    :class:`_MoEFFN`, with its recomputing backward). Returns a list of
    [G_i, C_i, d] outputs.

    Capacities are padded to multiples of 8 (zero rows, inert); block_m,
    when not given, is the largest of 128/64/32/16/8 dividing every padded
    capacity. small_m: None routes to the group-dense evaluation when
    rows * (Gs - 1) <= Gs * (block_m or 128), Gs the group count over
    ``ep_size``; the default False keeps the training engines on the
    packed route unconditionally."""
    assert len(bufs) == len(wi_gates) == len(wi_ups) == len(wos)
    assert bufs, "need at least one packed segment"
    d = bufs[0].shape[-1]
    if small_m is None:
        G_tot = sum(b.shape[0] for b in bufs)
        n_rows = sum(b.shape[0] * b.shape[1] for b in bufs)
        Gs = max(G_tot // max(int(ep_size), 1), 1)
        small_m = n_rows * (Gs - 1) <= Gs * (block_m or 128)
    if small_m:
        return _packed_group_dense(bufs, wi_gates, wi_ups, wos)
    caps = [_round_up(b.shape[1], 8) for b in bufs]
    if block_m is None:
        block_m = packed_block_m(caps)
    assert all(c % block_m == 0 for c in caps), (caps, block_m)
    rows, tiles, n_tot = [], [], 0
    dev = bufs[0].device
    for buf, cp in zip(bufs, caps):
        g, c = buf.shape[0], buf.shape[1]
        if cp != c:
            buf = F.pad(buf, (0, 0, 0, cp - c))
        rows.append(buf.reshape(g * cp, d))
        tiles.append(torch.arange(n_tot, n_tot + g, dtype=torch.int32,
                                  device=dev).repeat_interleave(
                                      cp // block_m))
        n_tot += g
    lhs = rows[0] if len(rows) == 1 else torch.cat(rows)
    tile_group = tiles[0] if len(tiles) == 1 else torch.cat(tiles)
    cat = (lambda ws: ws[0] if len(ws) == 1 else torch.cat(ws))
    out = _MoEFFN.apply(lhs.contiguous(), cat(wi_gates), cat(wi_ups),
                        cat(wos), None, tile_group, block_m, False)
    outs, off = [], 0
    for buf, cp in zip(bufs, caps):
        g, c = buf.shape[0], buf.shape[1]
        outs.append(out[off:off + g * cp].reshape(g, cp, d)[:, :c])
        off += g * cp
    return outs


# ---------------------------------------------------------------------------
# SSD (mamba2)
# ---------------------------------------------------------------------------

class _SSD(torch.autograd.Function):
    """The SSD scan with its gradient (the JAX package's
    ``_ssd_kernel_call`` custom_vjp, ops.py:674-707): the forward is the
    scan kernel (its plain version for CPU tensors); the backward recomputes
    ``ref.ssd_chunked`` under autograd from the saved inputs and returns its
    vector-Jacobian product, as ``_ssd_bwd`` does. That backward is plain
    torch on the card too: it is the reference's own backward (autodiff of
    the chunked oracle, not a Pallas kernel), so it is no fallback."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_kernel.ssd_scan(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        needs = ctx.needs_input_grad[:5]
        cts = [(i, g) for i, g in enumerate((dy, dstate)) if g is not None]
        if not cts or not any(needs):
            return (None,) * 6
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            outs = ref.ssd_chunked(*ins, chunk=ctx.chunk)
            got = iter(torch.autograd.grad(
                [outs[i] for i, _ in cts], [t for t in ins if t.requires_grad],
                [g for _, g in cts]))
        return (*(next(got) if n else None for n in needs), None)


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """mamba2 SSD scan. x: [b, T, h, hd]; dt: [b, T, h] f32; A: [h] f32;
    B/C: [b, T, ns] in x's dtype.

    Returns (y [b, T, h, hd] in x's dtype, final_state [b, h, hd, ns] f32).
    The JAX package's ``use_kernel=True`` route: the scan kernel forward
    (chunk Q = min(chunk, round_up(T, 128)), the ragged end masked), and
    the backward by autograd of ``ref.ssd_chunked`` at ``chunk``. There is
    no kernel switch: the port's only route is the kernel's."""
    return _SSD.apply(x, dt, A, B, C, int(chunk))
