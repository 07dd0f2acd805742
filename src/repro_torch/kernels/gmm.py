"""Grouped expert GEMMs over tile-aligned groups (mirror of
``repro/kernels/gmm.py``).

The packed-domain contract is the JAX package's (DESIGN.md §5): the caller
repacks expert-sorted rows so every group starts on a ``block_m`` boundary,
``tile_group[i]`` names the group of m-tile ``i``, and pad rows are zero.
Each public function launches a hand-written CUDA kernel for a CUDA
tensor and runs its plain version (the ``*_plain`` function beside it) for
a CPU tensor; on any other device, or when a build or launch fails, it
raises. Output dtype = ``out_dtype`` or the lhs dtype, as in the JAX
package. Kernels: ``csrc/gmm_wgmma.cu`` (tensor cores) for ``gmm_tiled``
on bf16 operands, ``csrc/gmm.cu`` (FMA) for its other operand types and
the fused GLU (:func:`gmm_route` is the rule); ``csrc/gmm_dw_wgmma.cu``
(tensor cores, an exact three-term bf16 split of the f32 operands) for the
weight gradient, ``csrc/gmm_dw.cu`` (FMA) for the shapes it does not take
(:func:`gmm_dw_route`).

``LAUNCHES`` counts kernel launches per kernel (plain ints), so a run can
show that its main path went through the kernels; ``VARIANT_LAUNCHES``
splits the same launches by operand types (``"f32.bf16T->f32"``: f32 lhs,
transposed bf16 rhs, f32 out), and :func:`design_launches` reads the
``gmm_tiled`` launches by design from them and adds the ``gmm_dw``
launches by design (``DW_DESIGN_LAUNCHES``, counted: its route depends on
the shape).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES = {"gmm_glu": 0, "gmm": 0, "gmm_dw": 0}

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# (lhs, rhs, out, rhs transposed) combinations of gmm_tiled with a kernel:
# the forward, and the MoE FFN backward's uses (ops.py:414-437). bf16
# operands run on the tensor cores (csrc/gmm_wgmma.cu), the rest on the FMA
# kernel (csrc/gmm.cu).
_WGMMA_VARIANTS = (("bf16", "bf16", "bf16", False),
                   ("bf16", "bf16", "f32", False))
_FMA_VARIANTS = (("f32", "f32", "f32", False), ("f32", "bf16", "f32", False),
                 ("f32", "bf16", "f32", True), ("f32", "f32", "f32", True))
_GMM_VARIANTS = _WGMMA_VARIANTS + _FMA_VARIANTS
VARIANT_LAUNCHES = {}

# The tensor-core kernel's tiles, constants of csrc/gmm_wgmma.cu: 64-deep
# k-slices, GMM_TILE_N output columns, GMM_STAGES slices in flight.
GMM_TILE_K = 64
GMM_TILE_N = 256
GMM_STAGES = 4
# ... and of csrc/gmm_dw_wgmma.cu: a block owns GMM_DW_TILE x GMM_DW_TILE
# outputs and walks its group's rows in GMM_DW_SLICE-row slices through
# GMM_DW_STAGES shared-memory stages; a stage holds one bf16 plane per
# split term of each operand ([GMM_DW_SLICE, GMM_DW_TILE] each): three for
# an f32 operand, one for the bf16 lhs. GMM_DW_PASSES: the products per
# slice (f32 lhs: six of the nine term pairs; bf16 lhs: three).
GMM_DW_TILE = 128
GMM_DW_SLICE = 64
GMM_DW_STAGES = 2
GMM_DW_PLANES = {"f32": 3, "bf16": 1}
GMM_DW_PASSES = {"f32": 6, "bf16": 3}
DW_DESIGN_LAUNCHES = {"gmm_dw:wgmma": 0, "gmm_dw:fma": 0}


def variant_name(lhs: str, rhs: str, out: str, trans: bool) -> str:
    return f"{lhs}.{rhs}{'T' if trans else ''}->{out}"


def _reset_variants():
    VARIANT_LAUNCHES.clear()
    VARIANT_LAUNCHES.update({f"gmm:{variant_name(*v)}": 0
                             for v in _GMM_VARIANTS})
    VARIANT_LAUNCHES.update({f"gmm_dw:{dt}.f32->f32": 0
                             for dt in _DTYPES.values()})
    for k in DW_DESIGN_LAUNCHES:
        DW_DESIGN_LAUNCHES[k] = 0


_reset_variants()


def design_launches() -> dict:
    """The ``gmm_tiled`` launches of ``VARIANT_LAUNCHES`` by design
    (:func:`gmm_route` sends exactly the bf16-operand variants to the
    tensor-core kernel and the others to the FMA kernel), and the
    ``gmm_dw_tiled`` launches by design as counted."""
    wgmma = sum(VARIANT_LAUNCHES[f"gmm:{variant_name(*v)}"]
                for v in _WGMMA_VARIANTS)
    fma = sum(VARIANT_LAUNCHES[f"gmm:{variant_name(*v)}"]
              for v in _FMA_VARIANTS)
    return {"gmm:wgmma": wgmma, "gmm:fma": fma, **DW_DESIGN_LAUNCHES}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    for a, b, o, t in _FMA_VARIANTS:
        fn = getattr(lib, f"gmm_{'t_' if t else ''}{a}_{b}_{o}")
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    for dt in _DTYPES.values():
        fn = getattr(lib, f"gmm_glu_{dt}")
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("gmm_wgmma")
    p, i = ctypes.c_void_p, ctypes.c_int
    for out in ("bf16", "f32"):
        fn = getattr(lib, f"gmm_wgmma_{out}")
        fn.argtypes = [p, p, p, p] + [i] * 7 + [p]
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _dw_lib() -> ctypes.CDLL:
    lib = _build.load("gmm_dw")
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _DTYPES.values():
        fn = getattr(lib, f"gmm_dw_{dt}")
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _dw_wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("gmm_dw_wgmma")
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _DTYPES.values():
        fn = getattr(lib, f"gmm_dw_wgmma_{dt}")
        fn.argtypes = [p, p, p, p] + [i] * 6 + [p]
        fn.restype = i
    return lib


def _check_block_m(block_m: int):
    """Every grouped kernel takes a block_m that is a positive multiple of
    8 (its row tiles are 8, 16, 32, 64 or 128 rows, each inside one
    block_m tile, so one group)."""
    if block_m <= 0 or block_m % 8:
        raise ValueError(f"the grouped kernels need block_m % 8 == 0, got "
                         f"block_m={block_m}")


def _check_tiles(Mp: int, tile_group, block_m: int):
    if tile_group.dtype != torch.int32:
        raise TypeError("tile_group must be int32")
    _check_block_m(block_m)
    if Mp % block_m or tile_group.numel() != Mp // block_m:
        raise ValueError(f"Mp={Mp} is not {tile_group.numel()} tiles of "
                         f"block_m={block_m}")


def _check(lhs, weights, tile_group, block_m: int):
    Mp, K = lhs.shape
    if lhs.dtype not in _DTYPES:
        raise TypeError(f"gmm kernels take bf16 or f32, got {lhs.dtype}")
    for w in weights:
        if w.dtype != lhs.dtype or w.dim() != 3 or w.shape[1] != K:
            raise ValueError(f"weights {tuple(w.shape)} {w.dtype} do not "
                             f"match lhs {tuple(lhs.shape)} {lhs.dtype}")
    _check_tiles(Mp, tile_group, block_m)
    for t in (lhs, *weights, tile_group):
        if not t.is_contiguous():
            raise ValueError("gmm kernels take contiguous tensors")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# gmm_tiled
# ---------------------------------------------------------------------------

def gmm_tiled_plain(lhs, rhs, tile_group, *, block_m: int = 128,
                    out_dtype=None):
    """Plain version of :func:`gmm_tiled` (the JAX package's
    ``ops._tiles_gemm_xla``): a batched matmul over m-tiles with the
    per-tile weight selected by ``tile_group``, in f32, rounded once to
    ``out_dtype`` (default: the lhs dtype). ``rhs`` may be a strided view
    (a transposed weight)."""
    Mp, K = lhs.shape
    n_m = Mp // block_m
    lt = lhs.reshape(n_m, block_m, K).float()
    rt = rhs[tile_group.long()].float()
    out = torch.bmm(lt, rt).reshape(Mp, rhs.shape[-1])
    return out.to(out_dtype or lhs.dtype)


def _rhs_layout(rhs, K: int):
    """(transposed, ldw) of a [G, K, N] weight operand: row-major, or a
    transposed view of a row-major [G, N, K] tensor (``swapaxes(W, 1, 2)``,
    read by stride). Raises for any other layout."""
    G, _, N = rhs.shape
    if rhs.is_contiguous():
        return False, N
    if rhs.stride() == (N * K, 1, K):
        return True, K
    raise ValueError(f"gmm rhs must be row-major or a transposed row-major "
                     f"weight, got strides {rhs.stride()}")


def gmm_route(lhs_dtype, rhs_dtype, out_dtype, trans: bool, K: int, N: int,
              block_m: int) -> str:
    """The design that runs :func:`gmm_tiled` on CUDA tensors: ``"wgmma"``
    (csrc/gmm_wgmma.cu, tensor cores) for bf16 x bf16 (row-major rhs) ->
    bf16 or f32, ``"fma"`` (csrc/gmm.cu) for f32 x f32, f32 x bf16 and
    their transposed-rhs forms (-> f32). Raises TypeError for operand
    types with no kernel, and ValueError for a block_m that is not a
    positive multiple of 8 (any kernel) or where the tensor-core kernel
    cannot take the shape: K and N must be multiples of 8 (TMA reads rows
    whose byte strides are multiples of 16)."""
    variant = (*(_DTYPES.get(t) for t in (lhs_dtype, rhs_dtype, out_dtype)),
               bool(trans))
    if variant not in _GMM_VARIANTS:
        raise TypeError(f"no gmm kernel for {lhs_dtype} x {rhs_dtype}"
                        f"{' (transposed)' if trans else ''} -> {out_dtype}")
    _check_block_m(block_m)
    if variant in _FMA_VARIANTS:
        return "fma"
    if K % 8 or N % 8:
        raise ValueError(f"the bf16 gmm kernel needs K % 8 == 0 and "
                         f"N % 8 == 0 (TMA's 16-byte strides), got K={K}"
                         f" N={N}")
    return "wgmma"


def gmm_wgmma_plan(block_m: int) -> dict:
    """Row tile and shared memory of one tensor-core launch: tile_m is
    the largest of 128 (two consumer warpgroups), 64, 32, 16 and 8 (one)
    that divides block_m, so a tile never spans two groups; each of the
    GMM_STAGES stages holds a [max(tile_m, 64), 64] lhs slice (a warpgroup
    multiplies 64 rows; under 64 the rows past the tile are not loaded)
    and a [64, GMM_TILE_N] weight slice in bf16 and two 8-byte barriers,
    plus 1024 bytes to align the ring. Raises for a block_m that is not a
    positive multiple of 8."""
    _check_block_m(block_m)
    tile_m = next(t for t in (128, 64, 32, 16, 8) if block_m % t == 0)
    stage = (max(tile_m, 64) + GMM_TILE_N) * GMM_TILE_K * 2
    smem = GMM_STAGES * (stage + 16) + 1024
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"{GMM_STAGES} stages of {stage} bytes exceed the "
                         f"{_build.SMEM_PER_BLOCK} bytes of shared memory")
    return {"tile_m": tile_m, "stage_bytes": stage, "smem_bytes": smem}


def _gmm_wgmma(lhs, rhs, tile_group, block_m: int, out_dtype, plan: dict):
    """Launch the tensor-core kernel with ``plan`` (:func:`gmm_wgmma_plan`)
    on bf16 lhs [Mp, K] and row-major rhs [G, K, N]."""
    Mp, K = lhs.shape
    G, _, N = rhs.shape
    out = torch.empty((Mp, N), dtype=out_dtype, device=lhs.device)
    if any(t.data_ptr() % 16 for t in (lhs, rhs, out)):
        raise ValueError("the bf16 gmm kernel needs 16-byte aligned lhs, "
                         "rhs and out")
    fn = getattr(_wgmma_lib(), f"gmm_wgmma_{_DTYPES[out_dtype]}")
    err = fn(lhs.data_ptr(), rhs.data_ptr(), tile_group.data_ptr(),
             out.data_ptr(), Mp, K, N, G, block_m, plan["tile_m"],
             plan["smem_bytes"],
             torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_on(err, "gmm (wgmma)")
    return out


def gmm_tiled(lhs, rhs, tile_group, *, block_m: int = 128, out_dtype=None):
    """Dense tiled grouped matmul over tile-aligned groups.

    lhs: [Mp, K]; rhs: [G, K, N], row-major or a transposed view of a
    row-major [G, N, K] weight (the backward's ``swapaxes(W, 1, 2)``; read
    by stride, widened in the kernel, never copied); tile_group:
    [Mp // block_m] int32. Returns [Mp, N] in ``out_dtype`` (default: the
    lhs dtype) with out[tile] = lhs[tile] @ rhs[tile_group[tile]], f32
    sums rounded once. On CUDA tensors block_m must be a multiple of 8
    and :func:`gmm_route` picks the kernel: bf16 operands (-> bf16 or f32)
    run on the tensor cores and need K and N multiples of 8 and 16-byte
    aligned tensors (raises otherwise, never falls back); the f32-operand
    types run on the FMA kernel."""
    if _build.on_cpu(lhs, rhs, tile_group):
        return gmm_tiled_plain(lhs, rhs, tile_group, block_m=block_m,
                               out_dtype=out_dtype)
    out_dtype = out_dtype or lhs.dtype
    Mp, K = lhs.shape
    if rhs.dim() != 3 or rhs.shape[1] != K:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    trans, ldw = _rhs_layout(rhs, K)
    N = rhs.shape[-1]
    design = gmm_route(lhs.dtype, rhs.dtype, out_dtype, trans, K, N, block_m)
    if not (lhs.is_contiguous() and tile_group.is_contiguous()):
        raise ValueError("gmm kernels take a contiguous lhs and tile_group")
    variant = tuple(_DTYPES[t] for t in (lhs.dtype, rhs.dtype, out_dtype))
    _check_tiles(Mp, tile_group, block_m)
    if design == "wgmma":
        out = _gmm_wgmma(lhs, rhs, tile_group, block_m, out_dtype,
                         gmm_wgmma_plan(block_m))
    else:
        out = torch.empty((Mp, N), dtype=out_dtype, device=lhs.device)
        a, b, o = variant
        fn = getattr(_lib(), f"gmm_{'t_' if trans else ''}{a}_{b}_{o}")
        err = fn(lhs.data_ptr(), rhs.data_ptr(), tile_group.data_ptr(),
                 out.data_ptr(), Mp, K, N, ldw, block_m,
                 torch.cuda.current_stream(lhs.device).cuda_stream)
        _raise_on(err, "gmm")
    LAUNCHES["gmm"] += 1
    VARIANT_LAUNCHES[f"gmm:{variant_name(*variant, trans)}"] += 1
    return out


# ---------------------------------------------------------------------------
# gmm_dw_tiled (weight gradient)
# ---------------------------------------------------------------------------

def gmm_dw_tiled_plain(lhs, dout, tile_group, n_groups: int, *,
                       block_m: int = 128, out_dtype=torch.float32):
    """Plain version of :func:`gmm_dw_tiled` (the JAX package's
    ``ops._tiles_dw_xla``): per-tile ``lhs_t^T @ dout_t`` in f32, summed
    per group (a segment sum over ``tile_group``). Groups with no tile are
    exact zeros."""
    Mp, K = lhs.shape
    N = dout.shape[1]
    n_m = Mp // block_m
    lt = lhs.reshape(n_m, block_m, K).float()
    dt = dout.reshape(n_m, block_m, N).float()
    per_tile = torch.bmm(lt.transpose(1, 2), dt)
    out = torch.zeros((n_groups, K, N), dtype=torch.float32,
                      device=lhs.device)
    out.index_add_(0, tile_group.long(), per_tile)
    return out.to(out_dtype)


def gmm_dw_route(lhs_dtype, dout_dtype, K: int, N: int, block_m: int) -> str:
    """The design that runs :func:`gmm_dw_tiled` on CUDA tensors:
    ``"wgmma"`` (csrc/gmm_dw_wgmma.cu, tensor cores on an exact three-term
    bf16 split) for a bf16 or f32 lhs and an f32 dout when K and N are
    multiples of 8 (its 16-byte loads of whole rows), ``"fma"``
    (csrc/gmm_dw.cu) for any other K or N. Raises TypeError for other
    operand types and ValueError for a block_m that is not a positive
    multiple of 8."""
    if _DTYPES.get(lhs_dtype) is None or dout_dtype != torch.float32:
        raise TypeError(f"gmm_dw takes a bf16 or f32 lhs and an f32 dout, "
                        f"got {lhs_dtype} and {dout_dtype}")
    _check_block_m(block_m)
    return "fma" if K % 8 or N % 8 else "wgmma"


def gmm_dw_wgmma_plan(block_m: int, lhs_dtype) -> dict:
    """Shared memory of one tensor-core ``gmm_dw`` launch: GMM_DW_STAGES
    stages, each the lhs planes (three split terms of an f32 lhs, the bf16
    lhs as it is) and dout's three, every plane [GMM_DW_SLICE,
    GMM_DW_TILE] bf16, plus 1024 bytes to align the ring; and the products
    per slice. The 64-row slices do not depend on block_m (rows past a
    group's end are loaded as zeros), which must still be a positive
    multiple of 8 (raises otherwise)."""
    _check_block_m(block_m)
    dt = _DTYPES[lhs_dtype]
    plane = GMM_DW_SLICE * GMM_DW_TILE * 2
    stage = (GMM_DW_PLANES[dt] + 3) * plane
    smem = GMM_DW_STAGES * stage + 1024
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"{GMM_DW_STAGES} stages of {stage} bytes exceed "
                         f"the {_build.SMEM_PER_BLOCK} bytes of shared "
                         f"memory")
    return {"stage_bytes": stage, "smem_bytes": smem,
            "passes": GMM_DW_PASSES[dt]}


def gmm_dw_tiled(lhs, dout, tile_group, n_groups: int, *, block_m: int = 128,
                 out_dtype=torch.float32):
    """Gradient with respect to the grouped weight: [G, K, N] with
    drhs[g] = sum over g's m-tiles t of lhs_t^T @ dout_t (f32 sums, rounded
    once to ``out_dtype``), from tile-aligned lhs [Mp, K] (bf16 or f32;
    bf16 is widened exactly, as the reference's ``astype(f32)``) and dout
    [Mp, N] f32. A group that owns no tile gets exact zeros. On CUDA
    tensors block_m must be a multiple of 8 and :func:`gmm_dw_route`
    picks the kernel: the tensor-core kernel (16-byte aligned tensors,
    raises otherwise) where K and N are multiples of 8, else the FMA
    kernel; neither falls back to the other."""
    if _build.on_cpu(lhs, dout, tile_group):
        return gmm_dw_tiled_plain(lhs, dout, tile_group, n_groups,
                                  block_m=block_m, out_dtype=out_dtype)
    Mp, K = lhs.shape
    N = dout.shape[1]
    design = gmm_dw_route(lhs.dtype, dout.dtype, K, N, block_m)
    if dout.shape[0] != Mp:
        raise ValueError(f"dout {tuple(dout.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    _check_tiles(Mp, tile_group, block_m)
    for t in (lhs, dout, tile_group):
        if not t.is_contiguous():
            raise ValueError("gmm_dw takes contiguous tensors")
    out = torch.empty((n_groups, K, N), dtype=torch.float32,
                      device=lhs.device)
    dt = _DTYPES[lhs.dtype]
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    args = (lhs.data_ptr(), dout.data_ptr(), tile_group.data_ptr(),
            out.data_ptr(), n_groups, K, N, Mp // block_m, block_m)
    if design == "wgmma":
        if any(t.data_ptr() % 16 for t in (lhs, dout, out)):
            raise ValueError("the tensor-core gmm_dw kernel needs 16-byte "
                             "aligned lhs, dout and out")
        plan = gmm_dw_wgmma_plan(block_m, lhs.dtype)
        err = getattr(_dw_wgmma_lib(), f"gmm_dw_wgmma_{dt}")(
            *args, plan["smem_bytes"], stream)
    else:
        err = getattr(_dw_lib(), f"gmm_dw_{dt}")(*args, stream)
    _raise_on(err, f"gmm_dw ({design})")
    LAUNCHES["gmm_dw"] += 1
    VARIANT_LAUNCHES[f"gmm_dw:{dt}.f32->f32"] += 1
    DW_DESIGN_LAUNCHES[f"gmm_dw:{design}"] += 1
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Fused GLU: gmm_glu_tiled_pair / gmm_glu_tiled (one kernel)
# ---------------------------------------------------------------------------

def gmm_glu_plain(lhs, rhs_g, rhs_u, tile_group, *, block_m: int = 128):
    """Plain version of the fused GLU kernel: per m-tile
    ``silu(lhs @ rhs_g[g]) * (lhs @ rhs_u[g])`` with f32 sums, rounded once
    (the TPU kernel's ``g * logistic(g) * u`` epilogue order)."""
    Mp, K = lhs.shape
    n_m = Mp // block_m
    lt = lhs.reshape(n_m, block_m, K).float()
    tg = tile_group.long()
    g = torch.bmm(lt, rhs_g[tg].float())
    u = torch.bmm(lt, rhs_u[tg].float())
    out = g * torch.sigmoid(g) * u
    return out.reshape(Mp, rhs_g.shape[-1]).to(lhs.dtype)


def _gmm_glu_call(lhs, w_gate, w_up, tile_group, N: int, ldw: int,
                  u_off: int, block_m: int):
    """Launch the fused GLU kernel: the up weight of output column n is
    read at column n + u_off of ``w_up``; both weights have row stride
    ``ldw``."""
    _check(lhs, (w_gate, w_up), tile_group, block_m)
    Mp, K = lhs.shape
    out = torch.empty((Mp, N), dtype=lhs.dtype, device=lhs.device)
    fn = getattr(_lib(), f"gmm_glu_{_DTYPES[lhs.dtype]}")
    err = fn(lhs.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
             tile_group.data_ptr(), out.data_ptr(), Mp, K, N, ldw, u_off,
             block_m, torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_on(err, "gmm_glu")
    LAUNCHES["gmm_glu"] += 1
    return out


def gmm_glu_tiled_pair(lhs, rhs_gate, rhs_up, tile_group, *,
                       block_m: int = 128):
    """Fused GLU grouped matmul with gate/up as separate [G, K, N] weights
    (the param layout): [Mp, N] = silu(lhs @ gate) * (lhs @ up) per tile."""
    if _build.on_cpu(lhs, rhs_gate, rhs_up, tile_group):
        return gmm_glu_plain(lhs, rhs_gate, rhs_up, tile_group,
                             block_m=block_m)
    if rhs_gate.shape != rhs_up.shape:
        raise ValueError("gate and up weights differ in shape")
    N = rhs_gate.shape[-1]
    return _gmm_glu_call(lhs, rhs_gate, rhs_up, tile_group, N, N, 0, block_m)


def gmm_glu_tiled(lhs, rhs_stacked, tile_group, *, block_m: int = 128):
    """Fused GLU grouped matmul over stacked weights [G, K, 2N] (gate in
    [..., :N], up in [..., N:]): the same kernel, reading the up half at a
    column offset of N, so no slice is copied."""
    N2 = rhs_stacked.shape[-1]
    if N2 % 2:
        raise ValueError("stacked GLU weights need an even last dim")
    N = N2 // 2
    if _build.on_cpu(lhs, rhs_stacked, tile_group):
        return gmm_glu_plain(lhs, rhs_stacked[..., :N], rhs_stacked[..., N:],
                             tile_group, block_m=block_m)
    return _gmm_glu_call(lhs, rhs_stacked, rhs_stacked, tile_group, N, N2, N,
                         block_m)
