"""Grouped expert GEMMs over tile-aligned groups (mirror of
``repro/kernels/gmm.py``).

The packed-domain contract is the JAX package's (DESIGN.md §5): the caller
repacks expert-sorted rows so every group starts on a ``block_m`` boundary,
``tile_group[i]`` names the group of m-tile ``i``, and pad rows are zero.
Each public function launches a hand-written CUDA kernel for a CUDA
tensor and runs its plain version (the ``*_plain`` function beside it) for
a CPU tensor; on any other device, or when a build or launch fails, it
raises. Output dtype = ``out_dtype`` or the lhs dtype, as in the JAX
package. Kernels (tensor cores unless named FMA): ``csrc/gmm_wgmma.cu``
for ``gmm_tiled`` on bf16 operands and the bf16 fused GLU,
``csrc/gmm_f32_wgmma.cu`` (an exact three-term bf16 split of the f32 lhs)
for ``gmm_tiled`` of an f32 lhs against a bf16 weight (row-major or
transposed), ``csrc/gmm.cu`` (FMA) for the f32 x f32 types, the f32 GLU
and shapes off the multiples of 8 (:func:`gmm_route`,
:func:`gmm_glu_route`);
``csrc/gmm_dw_wgmma.cu`` (the same split of the f32 operands) for the
weight gradient, ``csrc/gmm_dw.cu`` (FMA) for the shapes it does not take
(:func:`gmm_dw_route`).

``LAUNCHES`` counts kernel launches per kernel (plain ints), so a run can
show that its main path went through the kernels; ``VARIANT_LAUNCHES``
splits the same launches by operand types (``"f32.bf16T->f32"``: f32 lhs,
transposed bf16 rhs, f32 out), and ``DESIGN_LAUNCHES`` by the design that
ran them (``"gmm:wgmma"``, ``"gmm_glu:fma"``, ...: counted, since a route
depends on the shape). Fake tensors take the fake route
(``_build.fake``): the card's route and checks, no launch and no count
here; ``_build.FAKE_WORK`` records the call.
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
# operands run on the tensor cores (csrc/gmm_wgmma.cu), and so does the f32
# lhs against a bf16 weight, row-major (y = h @ wo) or transposed (dh, dx),
# through csrc/gmm_f32_wgmma.cu where K and N are multiples of 8; the rest
# on the FMA kernel (csrc/gmm.cu).
_BF16_VARIANTS = (("bf16", "bf16", "bf16", False),
                  ("bf16", "bf16", "f32", False))
_SPLIT_VARIANTS = (("f32", "bf16", "f32", False),
                   ("f32", "bf16", "f32", True))
_GMM_VARIANTS = _BF16_VARIANTS + _SPLIT_VARIANTS + (
    ("f32", "f32", "f32", False), ("f32", "f32", "f32", True))
VARIANT_LAUNCHES = {}
DESIGN_LAUNCHES = {f"{k}:{d}": 0 for k in ("gmm", "gmm_glu", "gmm_dw")
                   for d in ("wgmma", "fma")}

# The tensor-core kernels' tiles, constants of csrc/gmm_wgmma.cu (bf16
# lhs; the GLU's stage holds a gate and an up slice of GMM_TILE_N / 2
# columns each, the same bytes): 64-deep k-slices, GMM_TILE_N output
# columns, GMM_STAGES slices in flight; and of csrc/gmm_f32_wgmma.cu (f32
# lhs, 4 bytes an element): GMM_F32_STAGES slices, GMM_F32_PASSES products
# per k step (the lhs's three bf16 terms).
GMM_TILE_K = 64
GMM_TILE_N = 256
GMM_STAGES = 4
GMM_F32_STAGES = 3
GMM_F32_PASSES = 3
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


def variant_name(lhs: str, rhs: str, out: str, trans: bool) -> str:
    return f"{lhs}.{rhs}{'T' if trans else ''}->{out}"


def _reset_variants():
    VARIANT_LAUNCHES.clear()
    VARIANT_LAUNCHES.update({f"gmm:{variant_name(*v)}": 0
                             for v in _GMM_VARIANTS})
    VARIANT_LAUNCHES.update({f"gmm_dw:{dt}.f32->f32": 0
                             for dt in _DTYPES.values()})


_reset_variants()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    for a, b, o, t in _GMM_VARIANTS:
        if (a, b, o, t) in _BF16_VARIANTS:  # csrc/gmm_wgmma.cu only
            continue
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
    lib.gmm_glu_wgmma.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.gmm_glu_wgmma.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _f32_wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("gmm_f32_wgmma")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("gmm_t_f32_bf16_f32", "gmm_f32_bf16_f32_wgmma"):
        fn = getattr(lib, name)
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
    (tensor cores) for bf16 x bf16 (row-major rhs) -> bf16 or f32
    (csrc/gmm_wgmma.cu) and for f32 x bf16 (row-major or transposed) -> f32
    where K and N are multiples of 8 (csrc/gmm_f32_wgmma.cu); ``"fma"``
    (csrc/gmm.cu) for f32 x f32 (row-major or transposed), and f32 x bf16
    at any other K or N (-> f32). Raises TypeError for
    operand types with no kernel, and ValueError for a block_m that is not
    a positive multiple of 8 (any kernel) or for bf16 operands where K or N
    is not a multiple of 8 (TMA reads rows whose byte strides are multiples
    of 16; no other kernel takes bf16 x bf16)."""
    variant = (*(_DTYPES.get(t) for t in (lhs_dtype, rhs_dtype, out_dtype)),
               bool(trans))
    if variant not in _GMM_VARIANTS:
        raise TypeError(f"no gmm kernel for {lhs_dtype} x {rhs_dtype}"
                        f"{' (transposed)' if trans else ''} -> {out_dtype}")
    _check_block_m(block_m)
    aligned = K % 8 == 0 and N % 8 == 0
    if variant in _BF16_VARIANTS:
        if not aligned:
            raise ValueError(f"the bf16 gmm kernel needs K % 8 == 0 and "
                             f"N % 8 == 0 (TMA's 16-byte strides), got K={K}"
                             f" N={N}")
        return "wgmma"
    return "wgmma" if variant in _SPLIT_VARIANTS and aligned else "fma"


def gmm_wgmma_plan(block_m: int, lhs_dtype=torch.bfloat16) -> dict:
    """Row tile and shared memory of one tensor-core launch: tile_m is
    the largest of 128 (two consumer warpgroups), 64, 32, 16 and 8 (one)
    that divides block_m, so a tile never spans two groups; each stage
    holds a [max(tile_m, 64), 64] lhs slice (a warpgroup multiplies 64
    rows; under 64 the rows past the tile are not loaded) and a
    [64, GMM_TILE_N] bf16 weight slice (the GLU's: a gate and an up slice
    of GMM_TILE_N / 2 columns) and two 8-byte barriers, plus 1024 bytes to
    align the ring. A bf16 lhs (csrc/gmm_wgmma.cu): GMM_STAGES stages, one
    product per k step; an f32 lhs (csrc/gmm_f32_wgmma.cu, split in
    registers): 4 bytes an lhs element, GMM_F32_STAGES stages,
    GMM_F32_PASSES products. Raises for a block_m that is not a positive
    multiple of 8."""
    _check_block_m(block_m)
    f32 = lhs_dtype == torch.float32
    tile_m = next(t for t in (128, 64, 32, 16, 8) if block_m % t == 0)
    stage = (max(tile_m, 64) * (4 if f32 else 2)
             + GMM_TILE_N * 2) * GMM_TILE_K
    stages = GMM_F32_STAGES if f32 else GMM_STAGES
    smem = stages * (stage + 16) + 1024
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"{stages} stages of {stage} bytes exceed the "
                         f"{_build.SMEM_PER_BLOCK} bytes of shared memory")
    return {"tile_m": tile_m, "stage_bytes": stage, "smem_bytes": smem,
            "passes": GMM_F32_PASSES if f32 else 1}


def _aligned16(name: str, *tensors):
    if any(_build.address(t) % 16 for t in tensors):
        raise ValueError(f"the tensor-core {name} kernel needs 16-byte "
                         f"aligned tensors")


def _gmm_wgmma(lhs, rhs, tile_group, block_m: int, out_dtype, trans: bool):
    """Launch a tensor-core kernel on lhs [Mp, K] and rhs [G, K, N]: bf16
    lhs and row-major rhs (csrc/gmm_wgmma.cu), or f32 lhs and a bf16 rhs
    (csrc/gmm_f32_wgmma.cu), row-major or the transposed view of a
    row-major [G, N, K] weight, passed as that weight."""
    Mp, K = lhs.shape
    G, _, N = rhs.shape
    plan = gmm_wgmma_plan(block_m, lhs.dtype)
    out = torch.empty((Mp, N), dtype=out_dtype, device=lhs.device)
    _aligned16("gmm", lhs, rhs, out)
    if lhs.dtype == torch.float32:
        lib = _f32_wgmma_lib()
        fn = lib.gmm_t_f32_bf16_f32 if trans else lib.gmm_f32_bf16_f32_wgmma
    else:
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
    by stride, never copied); tile_group: [Mp // block_m] int32. Returns
    [Mp, N] in ``out_dtype`` (default: the lhs dtype) with out[tile] =
    lhs[tile] @ rhs[tile_group[tile]], f32 sums rounded once. On CUDA
    tensors block_m must be a multiple of 8 and :func:`gmm_route` picks
    the kernel: the tensor-core kernels need 16-byte aligned tensors
    (raise otherwise, never fall back); bf16 operands run only there (K
    and N multiples of 8, raises otherwise)."""
    if not _build.fake(lhs) and _build.on_cpu(lhs, rhs, tile_group):
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
    if _build.fake(lhs):
        out = torch.empty((Mp, N), dtype=out_dtype, device=lhs.device)
        if design == "wgmma":
            gmm_wgmma_plan(block_m, lhs.dtype)
            _aligned16("gmm", lhs, rhs, out)
        _build.record_fake("gmm", design, 2 * Mp * K * N,
                           (lhs, rhs, tile_group), (out,))
        return out
    if design == "wgmma":
        out = _gmm_wgmma(lhs, rhs, tile_group, block_m, out_dtype, trans)
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
    DESIGN_LAUNCHES[f"gmm:{design}"] += 1
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
    if not _build.fake(lhs) and _build.on_cpu(lhs, dout, tile_group):
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
    if _build.fake(lhs):
        if design == "wgmma":
            gmm_dw_wgmma_plan(block_m, lhs.dtype)
            _aligned16("gmm_dw", lhs, dout, out)
        _build.record_fake("gmm_dw", design, 2 * Mp * K * N,
                           (lhs, dout, tile_group), (out,))
        return out.to(out_dtype)
    dt = _DTYPES[lhs.dtype]
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    args = (lhs.data_ptr(), dout.data_ptr(), tile_group.data_ptr(),
            out.data_ptr(), n_groups, K, N, Mp // block_m, block_m)
    if design == "wgmma":
        _aligned16("gmm_dw", lhs, dout, out)
        plan = gmm_dw_wgmma_plan(block_m, lhs.dtype)
        err = getattr(_dw_wgmma_lib(), f"gmm_dw_wgmma_{dt}")(
            *args, plan["smem_bytes"], stream)
    else:
        err = getattr(_dw_lib(), f"gmm_dw_{dt}")(*args, stream)
    _raise_on(err, f"gmm_dw ({design})")
    LAUNCHES["gmm_dw"] += 1
    VARIANT_LAUNCHES[f"gmm_dw:{dt}.f32->f32"] += 1
    DESIGN_LAUNCHES[f"gmm_dw:{design}"] += 1
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


def gmm_glu_route(dtype, K: int, N: int, ldw: int, u_off: int,
                  block_m: int) -> str:
    """The design that runs the fused GLU on CUDA tensors: ``"wgmma"``
    (csrc/gmm_wgmma.cu, tensor cores) for bf16 where K, N, the weights' row
    stride ``ldw`` and the up weight's column offset ``u_off`` are
    multiples of 8 (TMA's 16-byte strides and boxes), ``"fma"``
    (csrc/gmm.cu) for f32 and any other shape. Raises TypeError for other
    dtypes and ValueError for a block_m that is not a positive multiple of
    8."""
    if dtype not in _DTYPES:
        raise TypeError(f"gmm_glu takes bf16 or f32, got {dtype}")
    _check_block_m(block_m)
    if dtype == torch.bfloat16 and not (K % 8 or N % 8 or ldw % 8
                                        or u_off % 8):
        return "wgmma"
    return "fma"


def _gmm_glu_call(lhs, w_gate, w_up, tile_group, N: int, ldw: int,
                  u_off: int, block_m: int):
    """Launch the fused GLU kernel that :func:`gmm_glu_route` names: the
    up weight of output column n is read at column n + u_off of ``w_up``;
    both weights have row stride ``ldw``. The tensor-core kernel needs
    16-byte aligned tensors (raises otherwise, never falls back)."""
    _check(lhs, (w_gate, w_up), tile_group, block_m)
    Mp, K = lhs.shape
    design = gmm_glu_route(lhs.dtype, K, N, ldw, u_off, block_m)
    out = torch.empty((Mp, N), dtype=lhs.dtype, device=lhs.device)
    if _build.fake(lhs):
        if design == "wgmma":
            gmm_wgmma_plan(block_m)
            _aligned16("gmm_glu", lhs, w_gate, w_up, out)
        weights = (w_gate,) if w_up is w_gate else (w_gate, w_up)
        _build.record_fake("gmm_glu", design, 4 * Mp * K * N,
                           (lhs, *weights, tile_group), (out,))
        return out
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    ptrs = (lhs.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            tile_group.data_ptr(), out.data_ptr())
    if design == "wgmma":
        _aligned16("gmm_glu", lhs, w_gate, w_up, out)
        plan = gmm_wgmma_plan(block_m)
        err = _wgmma_lib().gmm_glu_wgmma(
            *ptrs, Mp, K, N, w_gate.shape[0], ldw, u_off, block_m,
            plan["tile_m"], plan["smem_bytes"], stream)
    else:
        err = getattr(_lib(), f"gmm_glu_{_DTYPES[lhs.dtype]}")(
            *ptrs, Mp, K, N, ldw, u_off, block_m, stream)
    _raise_on(err, f"gmm_glu ({design})")
    LAUNCHES["gmm_glu"] += 1
    DESIGN_LAUNCHES[f"gmm_glu:{design}"] += 1
    return out


def gmm_glu_tiled_pair(lhs, rhs_gate, rhs_up, tile_group, *,
                       block_m: int = 128):
    """Fused GLU grouped matmul with gate/up as separate [G, K, N] weights
    (the param layout): [Mp, N] = silu(lhs @ gate) * (lhs @ up) per tile."""
    if not _build.fake(lhs) and _build.on_cpu(lhs, rhs_gate, rhs_up,
                                              tile_group):
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
    if not _build.fake(lhs) and _build.on_cpu(lhs, rhs_stacked, tile_group):
        return gmm_glu_plain(lhs, rhs_stacked[..., :N], rhs_stacked[..., N:],
                             tile_group, block_m=block_m)
    return _gmm_glu_call(lhs, rhs_stacked, rhs_stacked, tile_group, N, N2, N,
                         block_m)
