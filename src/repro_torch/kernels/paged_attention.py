"""Paged single-token decode attention (mirror of
``repro/kernels/paged_attention.py``).

Flash-style decode over a PAGED KV pool: the physical pool is
``[n_pages, page_size, KH, hd]`` shared by every slot, and slot ``b`` reads
the pages named by ``page_table[b]``. Key positions are structural (line
``l`` of table slot ``j`` is position ``j * page_size + l``), so stale lines
of recycled pages sit past the owner's causal frontier and are never
attended (DESIGN.md §9.2).

:func:`paged_decode_forward` launches the CUDA kernels of
``csrc/paged_attention.cu`` for CUDA tensors and runs
:func:`paged_decode_plain` for CPU tensors; on any other device, for a
shape the kernel does not take, or when a build or launch fails, it
raises. The kernel splits each slot's page walk across blocks
(:func:`paged_decode_plan`: splits of ``pages_per_split`` table slots,
each block writing an f32 partial softmax state) and a second kernel
combines the splits in order, so reruns are bit-identical. ``LAUNCHES``
counts wrapper calls that launched (one C call launches both kernels).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES = {"paged_decode": 0}

# Constants of csrc/paged_attention.cu: key lines a block scores at a time
# and the tiles in flight (by element size).
DECODE_TILE = 32
DECODE_STAGES = {2: 3, 4: 2}
# Blocks the split aims at per SM (the split kernel's grid covers the card
# about this many times over).
DECODE_BLOCKS_PER_SM = 2

_NEG = -0.7 * torch.finfo(torch.float32).max
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in _DTYPES.values():
        fn = getattr(lib, f"paged_decode_{dt}")
        fn.argtypes = [p] * 8 + [i] * 9 + [f, f, i, p]
        fn.restype = i
    return lib


def paged_decode_plan(B: int, KH: int, G: int, hd: int, MP: int,
                      elem_bytes: int, n_sm: int) -> dict:
    """Grid and shared memory of one kernel call: the (B * KH) x splits
    grid aims at DECODE_BLOCKS_PER_SM blocks per SM, each split a run of
    ``pages_per_split`` >= 1 table slots (splits = ceil(MP /
    pages_per_split); one split when MP = 0). Shared memory: q in f32, the
    ring of K and V tiles of DECODE_TILE lines in the input type, the
    tile's probabilities and rescale factors; ``scratch_floats``: the f32
    partials (acc [G, hd], m, l) of every block."""
    want = -(-DECODE_BLOCKS_PER_SM * n_sm // (B * KH))
    per = max(1, -(-MP // want))
    splits = max(1, -(-MP // per))
    ring = DECODE_STAGES[elem_bytes] * 2 * DECODE_TILE * hd * elem_bytes
    smem = -(-G * hd * 4 // 16) * 16 + ring + G * DECODE_TILE * 4 + G * 4
    return {"splits": splits, "pages_per_split": per, "smem_bytes": smem,
            "scratch_floats": B * KH * splits * G * (hd + 2)}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_decode_plain(q, k_pool, v_pool, page_table, q_pos, *, scale,
                       softcap=0.0, window=0, return_lse=False):
    """Plain version of the kernel, same semantics: f32 softmax over the
    live lines only (masked lines contribute exactly 0), a slot with no
    live key divides by 1, a dead slot (q_pos < 0) returns 0. With
    ``return_lse`` also the f32 log-sum-exp [B, KH, G] of each row's
    scaled scores (-inf where no line is live or the slot is dead)."""
    B, KH, G, hd = q.shape
    ps = k_pool.shape[1]
    MP = page_table.shape[1]
    ptc = page_table.clamp(min=0).long()
    k = k_pool[ptc].reshape(B, MP * ps, KH, hd).float()
    v = v_pool[ptc].reshape(B, MP * ps, KH, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", q.float(), k) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(MP * ps, device=q.device)
    qp = q_pos.long()[:, None]
    mask = (page_table >= 0).repeat_interleave(ps, dim=1) & (kpos <= qp)
    if window > 0:
        mask &= (qp - kpos) < window
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, _NEG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh", p, v) / torch.where(l == 0, 1.0, l)
    live = (q_pos >= 0)[:, None, None, None]
    out = torch.where(live, out, 0.0).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where((l > 0) & live, s.amax(-1, keepdim=True) + torch.log(l),
                      -torch.inf)
    return out, lse[..., 0]


def paged_decode_forward(q, k_pool, v_pool, page_table, q_pos, *, scale,
                         softcap=0.0, window=0, return_lse=False):
    """q: [B, KH, G, hd]; pools: [P, page_size, KH, hd]; page_table:
    [B, MP] int32 (-1 = unallocated slot); q_pos: [B] int32 (< 0 = dead).

    Returns [B, KH, G, hd] in q's dtype (zeros for dead slots); with
    ``return_lse`` the pair (out, lse), lse the f32 [B, KH, G] log-sum-exp
    of each row's scaled scores written by the combine kernel (-inf for a
    row without a live line or a dead slot): what a log-sum-exp merge of
    partial results over disjoint pages weighs the row by."""
    tensors = (q, k_pool, v_pool, page_table, q_pos)
    fake = _build.fake(q)
    if not fake and _build.on_cpu(*tensors):
        return paged_decode_plain(q, k_pool, v_pool, page_table, q_pos,
                                  scale=scale, softcap=softcap, window=window,
                                  return_lse=return_lse)
    B, KH, G, hd = q.shape
    P, ps = k_pool.shape[0], k_pool.shape[1]
    MP = page_table.shape[1]
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged decode takes one of bf16/f32 for q and "
                        f"pools, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if k_pool.shape != (P, ps, KH, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32 \
            or page_table.shape[0] != B or q_pos.shape != (B,):
        raise ValueError("page_table [B, MP] and q_pos [B] must be int32")
    if hd % 32 or hd > 256 or ps > 128 or G > 32:
        raise ValueError(f"kernel takes head_dim % 32 == 0 and <= 256, "
                         f"page_size <= 128, G <= 32; got hd={hd}, "
                         f"ps={ps}, G={G}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("paged decode takes contiguous tensors")
    if _build.address(k_pool) % 16 or _build.address(v_pool) % 16:
        raise ValueError("paged decode needs 16-byte aligned pools")
    out = torch.empty_like(q)
    lse = torch.empty((B, KH, G), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if fake:  # every table slot's lines counted: the lengths are data
        lines = B * KH * MP * ps
        _build.record_fake("paged_decode", None, 4 * G * hd * lines,
                           (q, page_table, q_pos),
                           (out,) + ((lse,) if return_lse else ()),
                           read=2 * lines * hd * k_pool.element_size())
        return (out, lse) if return_lse else out
    plan = paged_decode_plan(B, KH, G, hd, MP, q.element_size(),
                             _sm_count(q.device.index or 0))
    part = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                       device=q.device)
    fn = getattr(_lib(), f"paged_decode_{_DTYPES[q.dtype]}")
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), q_pos.data_ptr(), part.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr(),
             B, KH, G, hd, ps, MP, plan["splits"],
             plan["pages_per_split"], plan["smem_bytes"], float(scale),
             float(softcap), int(window),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {err}")
    LAUNCHES["paged_decode"] += 1
    return (out, lse) if return_lse else out
