"""Grouped expert GEMMs over tile-aligned groups (mirror of
``repro/kernels/gmm.py``).

The packed-domain contract is the JAX package's (DESIGN.md §5): the caller
repacks expert-sorted rows so every group starts on a ``block_m`` boundary,
``tile_group[i]`` names the group of m-tile ``i``, and pad rows are zero.
Each public function launches the hand-written CUDA kernel of
``csrc/gmm.cu`` for a CUDA tensor and runs its plain version (the
``*_plain`` function beside it) for a CPU tensor; on any other device, or
when a build or launch fails, it raises. Output dtype = lhs dtype.

``LAUNCHES`` counts kernel launches per kernel (plain ints), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES = {"gmm_glu": 0, "gmm": 0}

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _DTYPES.values():
        fn = getattr(lib, f"gmm_{dt}")
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"gmm_glu_{dt}")
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    lib.gmm_block_rows.argtypes = []
    lib.gmm_block_rows.restype = i
    return lib


def _check(lhs, weights, tile_group, block_m: int):
    Mp, K = lhs.shape
    if lhs.dtype not in _DTYPES:
        raise TypeError(f"gmm kernels take bf16 or f32, got {lhs.dtype}")
    for w in weights:
        if w.dtype != lhs.dtype or w.dim() != 3 or w.shape[1] != K:
            raise ValueError(f"weights {tuple(w.shape)} {w.dtype} do not "
                             f"match lhs {tuple(lhs.shape)} {lhs.dtype}")
    if tile_group.dtype != torch.int32:
        raise TypeError("tile_group must be int32")
    if Mp % block_m or tile_group.numel() != Mp // block_m:
        raise ValueError(f"Mp={Mp} is not {tile_group.numel()} tiles of "
                         f"block_m={block_m}")
    rows = _lib().gmm_block_rows()
    if block_m % rows:
        raise ValueError(f"block_m={block_m} must be a multiple of the "
                         f"kernel's {rows}-row tile")
    for t in (lhs, *weights, tile_group):
        if not t.is_contiguous():
            raise ValueError("gmm kernels take contiguous tensors")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# gmm_tiled
# ---------------------------------------------------------------------------

def gmm_tiled_plain(lhs, rhs, tile_group, *, block_m: int = 128):
    """Plain version of :func:`gmm_tiled` (the JAX package's
    ``ops._tiles_gemm_xla``): a batched matmul over m-tiles with the
    per-tile weight selected by ``tile_group``, in f32, rounded once."""
    Mp, K = lhs.shape
    n_m = Mp // block_m
    lt = lhs.reshape(n_m, block_m, K).float()
    rt = rhs[tile_group.long()].float()
    return torch.bmm(lt, rt).reshape(Mp, rhs.shape[-1]).to(lhs.dtype)


def gmm_tiled(lhs, rhs, tile_group, *, block_m: int = 128):
    """Dense tiled grouped matmul over tile-aligned groups.

    lhs: [Mp, K]; rhs: [G, K, N]; tile_group: [Mp // block_m] int32.
    Returns [Mp, N] with out[tile] = lhs[tile] @ rhs[tile_group[tile]]."""
    if _build.on_cpu(lhs, rhs, tile_group):
        return gmm_tiled_plain(lhs, rhs, tile_group, block_m=block_m)
    _check(lhs, (rhs,), tile_group, block_m)
    Mp, K = lhs.shape
    N = rhs.shape[-1]
    out = torch.empty((Mp, N), dtype=lhs.dtype, device=lhs.device)
    fn = getattr(_lib(), f"gmm_{_DTYPES[lhs.dtype]}")
    err = fn(lhs.data_ptr(), rhs.data_ptr(), tile_group.data_ptr(),
             out.data_ptr(), Mp, K, N, N, block_m,
             torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_on(err, "gmm")
    LAUNCHES["gmm"] += 1
    return out


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
