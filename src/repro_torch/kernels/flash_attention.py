"""Flash attention forward and backward, GQA-aware (mirror of
``repro/kernels/flash_attention.py``).

Layout (the reference's): q, o, do, dq ``[B, H, S, hd]``; k, v, dk, dv
``[B, KH, T, hd]``; lse ``[B, H, S]`` f32; H = KH * G and query head h
reads KV head ``h // G``. Tensors may be views with any strides over the
first three axes (the model layout ``[B, S, H, hd]`` transposed, with no
copy); head_dim must be contiguous. Masks are structural, from global
positions counted from 0 in both sequences: query q sees key k when
q < q_len, k < kv_len, k <= q under ``causal`` and q - k < window when
window > 0. The kernel masks the ragged edge itself, so nothing is padded.
A row with no live key gets o = 0 and lse = ``_NEG`` exactly.

:func:`flash_forward` and :func:`flash_backward` launch the kernels of
``csrc/flash_attention.cu`` (FMA), ``csrc/flash_fwd_wgmma.cu`` and
``csrc/flash_bwd_wgmma.cu`` (the forward and the dq, dk/dv kernels on the
tensor cores, bf16 at head_dim 64 and 128; :func:`flash_fwd_route` and
:func:`flash_bwd_route` are the rule) for CUDA tensors and run
:func:`flash_forward_plain` / :func:`flash_backward_plain` for CPU tensors;
on any other device, an unsupported dtype or shape, or a failed build or
launch they raise. ``LAUNCHES`` counts kernel launches, and
``DESIGN_LAUNCHES`` the same launches by design (``"flash_fwd:wgmma"``,
``"flash_dq:fma"``, ...). Fake tensors take the fake route
(``_build.fake``): the card's route and checks, no launch and no count
here; ``_build.FAKE_WORK`` records the call, its work the math over the
(query, key) pairs the mask leaves (:func:`mask_pairs`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
DESIGN_LAUNCHES = {f"{k}:{d}": 0 for k in LAUNCHES for d in ("wgmma", "fma")}

_NEG = -0.7 * torch.finfo(torch.float32).max
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}

# The tensor-core kernels, constants of csrc/flash_fwd_wgmma.cu and
# csrc/flash_bwd_wgmma.cu: head_dims they are built for, rows of a k-tile
# (and of a q-tile in dk/dv), stages of the forward's and dq's K/V ring,
# and dk/dv's warpgroups, each with a ring of its own.
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_KV_ROWS = 64
WGMMA_STAGES = 3
DKV_WARPGROUPS = 2
DKV_STAGES = 2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i] * 10  # B, H, KH, S, T, hd, q_len, kv_len, causal, window
    for dt in _DTYPES.values():
        for name, n_ptr, n_float in (("fwd", 5, 2), ("dq", 7, 1),
                                     ("dkv", 8, 1)):
            fn = getattr(lib, f"flash_{name}_{dt}")
            fn.argtypes = [p] * (n_ptr + 1) + dims + [f] * n_float + [p]
            fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd_wgmma")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_wgmma_bf16.argtypes = ([p] * 6 + [i] * 10 + [f] * 2
                                         + [i] * 2 + [p])
    lib.flash_fwd_wgmma_bf16.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd_wgmma")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i] * 10  # B, H, KH, S, T, hd, q_len, kv_len, causal, window
    for name, n_ptr, n_plan in (("dq", 7, 2), ("dkv", 8, 1)):
        fn = getattr(lib, f"flash_{name}_wgmma_bf16")
        fn.argtypes = [p] * (n_ptr + 1) + dims + [f] + [i] * n_plan + [p]
        fn.restype = i
    return lib


def flash_fwd_route(dtype, hd: int) -> str:
    """The design that runs :func:`flash_forward` on CUDA tensors:
    ``"wgmma"`` (csrc/flash_fwd_wgmma.cu, tensor cores) for bf16 at a
    head_dim in ``WGMMA_HEAD_DIMS``, ``"fma"`` (csrc/flash_attention.cu)
    for f32 and for the other head_dims. Raises TypeError for other dtypes
    and ValueError for a head_dim no kernel takes (not a multiple of 32, or
    above 256)."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention takes bf16 or f32, got {dtype}")
    if hd % 32 or hd > 256:
        raise ValueError(f"kernel takes head_dim % 32 == 0 and <= 256, got "
                         f"{hd}")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def flash_bwd_route(dtype, hd: int) -> str:
    """The design that runs the dq and dk/dv kernels of
    :func:`flash_backward` on CUDA tensors, by the rule of
    :func:`flash_fwd_route`: ``"wgmma"`` (csrc/flash_bwd_wgmma.cu) for bf16
    at a head_dim in ``WGMMA_HEAD_DIMS``, ``"fma"`` (csrc/flash_attention.cu)
    otherwise; the same errors."""
    return flash_fwd_route(dtype, hd)


def flash_wgmma_plan(hd: int, S: int) -> dict:
    """Query tile and shared memory of one tensor-core forward launch:
    one 64-row warpgroup per block where S <= 64, else two (128 query
    rows); the Q tile, WGMMA_STAGES stages of one K and one V tile (64 rows
    each), two 8-byte barriers per stage plus Q's, and 1024 bytes to align
    the tiles. Raises for a head_dim the kernel is not built for."""
    if hd not in WGMMA_HEAD_DIMS:
        raise ValueError(f"no flash wgmma plan for hd={hd}")
    q_rows = 64 if S <= 64 else 128
    stage = 2 * WGMMA_KV_ROWS * hd * 2
    smem = (q_rows * hd * 2 + WGMMA_STAGES * stage
            + 8 * (1 + 2 * WGMMA_STAGES) + 1024)
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"flash plan needs {smem} bytes of shared memory, "
                         f"more than {_build.SMEM_PER_BLOCK}")
    return {"q_rows": q_rows, "stage_bytes": stage, "smem_bytes": smem}


def flash_bwd_wgmma_plan(hd: int, S: int) -> dict:
    """Tiles and shared memory of the tensor-core backward launches.
    dq: ``q_rows`` query rows per block as the forward's plan (64 where
    S <= 64, else 128), its Q and dO tiles, WGMMA_STAGES stages of one K
    and one V tile (64 rows), a full and an empty barrier per stage and
    Q's. dk/dv: its K and V tiles (64 key rows), and for each of its
    DKV_WARPGROUPS warpgroups DKV_STAGES stages of one Q and one dO tile
    (64 rows) with their lse and delta (64 f32 each) and a full barrier,
    plus K/V's. Both add 1024 bytes to align the tiles. Raises for a
    head_dim the kernels are not built for."""
    if hd not in WGMMA_HEAD_DIMS:
        raise ValueError(f"no flash backward wgmma plan for hd={hd}")
    q_rows = 64 if S <= 64 else 128
    tile = WGMMA_KV_ROWS * hd * 2          # 64 rows of one operand, bf16
    dq_smem = (2 * q_rows * hd * 2 + WGMMA_STAGES * 2 * tile
               + 8 * (1 + 2 * WGMMA_STAGES) + 1024)
    stages = DKV_WARPGROUPS * DKV_STAGES
    dkv_smem = (2 * tile + stages * (2 * tile + 2 * WGMMA_KV_ROWS * 4)
                + 8 * (1 + stages) + 1024)
    if max(dq_smem, dkv_smem) > _build.SMEM_PER_BLOCK:
        raise ValueError(f"flash backward plan needs {dq_smem} / {dkv_smem} "
                         f"bytes of shared memory, more than "
                         f"{_build.SMEM_PER_BLOCK}")
    return {"q_rows": q_rows, "dq_smem_bytes": dq_smem,
            "dkv_smem_bytes": dkv_smem}


def _mask(S, T, q_len, kv_len, causal, window, device):
    """[S, T] bool: the structural mask of the kernels, cut to the true
    lengths."""
    m = ref.causal_window_mask(S, T, causal, window, device=device)
    return (m & (torch.arange(S, device=device)[:, None] < q_len)
            & (torch.arange(T, device=device)[None, :] < kv_len))


def _scores(q, k, scale):
    """f32 q·kᵀ·scale per query head: [B, KH, G, S, T]."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    qg = q.float().reshape(B, KH, H // KH, S, hd)
    return torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale


def flash_forward_plain(q, k, v, *, scale, causal, window=0, softcap=0.0,
                        q_len=None, kv_len=None):
    """Plain version of the forward kernel, same semantics: f32 math over
    a materialised [B, H, S, T] score matrix; o = 0 and lse = _NEG on rows
    with no live key."""
    B, H, S, hd = q.shape
    KH, T = k.shape[1], k.shape[2]
    mask = _mask(S, T, S if q_len is None else q_len,
                 T if kv_len is None else kv_len, causal, window, q.device)
    s = _scores(q, k, scale)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    denom = torch.where(l == 0, 1.0, l)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / denom
    lse = torch.where(l == 0, _NEG, m + torch.log(denom))
    return (o.reshape(B, H, S, hd).to(q.dtype),
            lse.reshape(B, H, S))


def flash_backward_plain(q, k, v, o, lse, do, *, scale, causal, window=0,
                         q_len=None, kv_len=None):
    """Plain version of the two backward kernels, same semantics:
    p = exp(s - lse) only where the mask holds (selected, never multiplied
    by a 0/1 mask: a dead row's s - lse overflows), ds = p·(dp - delta)·scale
    with delta = Σ do·o in f32; dk, dv summed over the G query heads of
    each KV head. Gradients come back in q's / k's / v's dtype."""
    B, H, S, hd = q.shape
    KH, T = k.shape[1], k.shape[2]
    G = H // KH
    mask = _mask(S, T, S if q_len is None else q_len,
                 T if kv_len is None else kv_len, causal, window, q.device)
    s = _scores(q, k, scale)
    lse_g = lse.float().reshape(B, KH, G, S, 1)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    do_g = do.float().reshape(B, KH, G, S, hd)
    delta = (do_g * o.float().reshape(B, KH, G, S, hd)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgsd,bktd->bkgst", do_g, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float())
    qg = q.float().reshape(B, KH, G, S, hd)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do_g)
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, q_len, kv_len, *others):
    """Validate what the kernels take; returns (B, H, KH, S, T, hd,
    q_len, kv_len)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes one of bf16/f32 for q, k "
                        f"and v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B,H,S,hd] and k, v [B,KH,T,hd] expected, got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, H, S, hd = q.shape
    KH, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KH == 0 or H % KH:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KH)")
    if hd % 32 or hd > 256:
        raise ValueError(f"kernel takes head_dim % 32 == 0 and <= 256, got "
                         f"{hd}")
    q_len = S if q_len is None else q_len
    kv_len = T if kv_len is None else kv_len
    if not (0 <= q_len <= S and 0 <= kv_len <= T):
        raise ValueError(f"q_len {q_len} / kv_len {kv_len} outside the "
                         f"tensors' {S} / {T}")
    for t in (q, k, v, *others):
        if t.stride(-1) != 1:
            raise ValueError("flash attention takes tensors whose head_dim "
                             "is contiguous")
    return B, H, KH, S, T, hd, q_len, kv_len


def _strides(*tensors):
    """The (batch, head, row) element strides of each tensor, as a C
    array of int64 (the caller holds it across the call)."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tma(design: str, tensors, strides):
    """TMA reads the tensor-core kernels' inputs: every (batch, head, row)
    stride a multiple of 8 elements (16 bytes) and 16-byte aligned
    tensors. Raises otherwise, never falls back."""
    if any(st % 8 for t in tensors for st in t.stride()[:3]) or any(
            _build.address(t) % 16 for t in tensors):
        raise ValueError(f"the bf16 flash {design} needs (batch, head, row) "
                         f"strides that are multiples of 8 and 16-byte "
                         f"aligned tensors, got strides {list(strides)}")


def mask_pairs(S: int, T: int, q_len: int, kv_len: int, causal: bool,
               window: int) -> int:
    """(query, key) pairs the kernels' structural mask leaves (query i
    sees key j < kv_len when i < q_len, j <= i under ``causal`` and
    i - j < window when window > 0): the pairs whose products count as
    a fake launch's work."""
    n = 0
    for i in range(min(q_len, S)):
        hi = min(kv_len, T, i + 1) if causal else min(kv_len, T)
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def flash_forward(q, k, v, *, scale, causal, window=0, softcap=0.0,
                  q_len=None, kv_len=None):
    """q: [B,H,S,hd]; k/v: [B,KH,T,hd]. Returns (o [B,H,S,hd] in q's dtype
    and with q's strides, lse [B,H,S] f32). ``q_len`` / ``kv_len`` are
    the true lengths used for masking (default: the tensors').

    On CUDA tensors :func:`flash_fwd_route` picks the kernel by dtype and
    head_dim: bf16 at head_dim 64 or 128 runs on the tensor cores, which
    read q, k, v and write o by TMA and so need every (batch, head, row)
    stride a multiple of 8 elements and 16-byte aligned tensors (raises
    otherwise, never falls back); f32, and bf16 at other head_dims, run
    on the FMA kernel."""
    if not _build.fake(q) and _build.on_cpu(q, k, v):
        return flash_forward_plain(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap,
                                   q_len=q_len, kv_len=kv_len)
    dims = _check(q, k, v, q_len, kv_len)
    B, H, _, S = dims[:4]
    design = flash_fwd_route(q.dtype, dims[5])
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o)
    if _build.fake(q):
        if design == "wgmma":
            _check_tma("forward", (q, k, v, o), strides)
        pairs = mask_pairs(S, dims[4], *dims[6:8], causal, window)
        _build.record_fake("flash_fwd", design, 4 * B * H * dims[5] * pairs,
                           (q, k, v), (o, lse))
        return o, lse
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), ctypes.addressof(strides), *dims, int(causal),
            int(window), float(scale), float(softcap))
    if design == "wgmma":
        _check_tma("forward", (q, k, v, o), strides)
        plan = flash_wgmma_plan(dims[5], S)
        err = _wgmma_lib().flash_fwd_wgmma_bf16(
            *args, plan["q_rows"], plan["smem_bytes"], _stream(q))
    else:
        err = getattr(_lib(), f"flash_fwd_{_DTYPES[q.dtype]}")(*args,
                                                               _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_fwd ({design}) launch failed: cudaError "
                           f"{err}")
    LAUNCHES["flash_fwd"] += 1
    DESIGN_LAUNCHES[f"flash_fwd:{design}"] += 1
    return o, lse


def _launch_backward(name, q, k, v, do, lse, delta, *, scale, causal,
                     window=0, q_len=None, kv_len=None):
    """Launch one backward kernel on CUDA tensors: ``name`` "dq" returns
    (dq,), "dkv" returns (dk, dv). lse and delta are [B, H, S] f32,
    contiguous. :func:`flash_bwd_route` picks the design: bf16 at
    head_dim 64 or 128 runs on the tensor cores, whose TMA loads need
    strides that are multiples of 8 and 16-byte aligned tensors (raises
    otherwise)."""
    dims = _check(q, k, v, q_len, kv_len, do)
    B, H, _, S = dims[:4]
    for t in (lse, delta):
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("lse and delta must be contiguous [B, H, S] "
                             "f32")
    design = flash_bwd_route(q.dtype, dims[5])
    outs = (torch.empty_like(q),) if name == "dq" else \
        (torch.empty_like(k), torch.empty_like(v))
    strides = _strides(q, k, v, do, *outs)
    if _build.fake(q):
        if design == "wgmma":
            _check_tma("backward", (q, k, v, do, *outs), strides)
        # dq: s, dp and dq; dk/dv: s, dp, dv and dk (per pair, 2·hd each)
        pairs = mask_pairs(S, dims[4], *dims[6:8], causal, window)
        prods = 3 if name == "dq" else 4
        _build.record_fake(f"flash_{name}", design,
                           2 * prods * B * H * dims[5] * pairs,
                           (q, k, v, do, lse, delta), outs)
        return outs
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            ctypes.addressof(strides), *dims, int(causal), int(window),
            float(scale))
    if design == "wgmma":
        _check_tma("backward", (q, k, v, do, *outs), strides)
        plan = flash_bwd_wgmma_plan(dims[5], S)
        tiles = (plan["q_rows"], plan["dq_smem_bytes"]) if name == "dq" \
            else (plan["dkv_smem_bytes"],)
        fn = getattr(_bwd_wgmma_lib(), f"flash_{name}_wgmma_bf16")
        err = fn(*args, *tiles, _stream(q))
    else:
        fn = getattr(_lib(), f"flash_{name}_{_DTYPES[q.dtype]}")
        err = fn(*args, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_{name} ({design}) launch failed: "
                           f"cudaError {err}")
    LAUNCHES[f"flash_{name}"] += 1
    DESIGN_LAUNCHES[f"flash_{name}:{design}"] += 1
    return outs


def flash_backward(q, k, v, o, lse, do, *, scale, causal, window=0,
                   q_len=None, kv_len=None):
    """Returns (dq [B,H,S,hd], dk, dv [B,KH,T,hd]), each in its input's
    dtype and with its input's strides. delta = Σ do·o (f32) is one torch
    expression here; the dq and dk/dv kernels both read it. On CUDA
    tensors :func:`flash_bwd_route` picks their design (bf16 at head_dim
    64 or 128: the tensor cores)."""
    kw = dict(scale=scale, causal=causal, window=window, q_len=q_len,
              kv_len=kv_len)
    if not _build.fake(q) and _build.on_cpu(q, k, v, o, lse, do):
        return flash_backward_plain(q, k, v, o, lse, do, **kw)
    _check(q, k, v, q_len, kv_len, o)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must match q")
    delta = (do.float() * o.float()).sum(-1).contiguous()
    (dq,) = _launch_backward("dq", q, k, v, do, lse.contiguous(), delta,
                             **kw)
    dk, dv = _launch_backward("dkv", q, k, v, do, lse.contiguous(), delta,
                              **kw)
    return dq, dk, dv
