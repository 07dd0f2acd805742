"""mamba2 SSD (state-space duality) chunk scan (mirror of
``repro/kernels/ssd.py``).

The dual form splits the sequence into chunks of Q rows: inside a chunk the
recurrence is a masked, decay-weighted quadratic form; across chunks a small
[state x head_dim] state is carried. Per (batch, head), over the chunks in
order, with x̄ = x·dt and la = dt·A formed in f32:

    cum = cumsum(la)                       (inclusive, within the chunk)
    y   = (C Bᵀ ⊙ L)·x̄ + exp(cum)·(C·S)   L[i, j] = exp(cum_i - cum_j), j <= i
    S  <- exp(total)·S + (B ⊙ exp(total - cum))ᵀ·x̄

and the final S, transposed to [hd, ns], in f32. B and C are shared by the
heads of a batch (n_groups = 1). Q = min(chunk, round_up(T, 128)) and the
ragged end of the last chunk is a no-op (la = 0, x̄ = 0), as in the JAX
package's ``_ssd_kernel_call``.

Layouts are the model's: x [b, T, h, hd] (bf16 or f32), dt [b, T, h] f32,
A [h] f32, B/C [b, T, ns] in x's dtype; x, B and C may be strided views
(slices of the conv output), their last axis contiguous. Returns y
[b, T, h, hd] in x's dtype and the final state [b, h, hd, ns] f32.

:func:`ssd_scan` launches the CUDA kernel of ``csrc/ssd.cu`` for CUDA
tensors and runs :func:`ssd_scan_plain` for CPU tensors; on any other
device, an unsupported dtype or shape, or a failed build or launch it
raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

LAUNCHES = {"ssd": 0}

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
HEAD_DIMS = (32, 64, 128)  # head_dim values the kernel is built for
MAX_STATE = 128            # ns % 16 == 0 and ns <= MAX_STATE


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _DTYPES.values():
        fn = getattr(lib, f"ssd_scan_{dt}")
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
        fn.restype = i
    return lib


def chunk_rows(T: int, chunk: int) -> int:
    """The scan's chunk Q: ``min(chunk, round_up(T, 128))`` (the JAX
    package's choice, ops.py:679)."""
    return min(chunk, -(-T // 128) * 128)


def ssd_scan_plain(x, dt, A, B, C, *, chunk):
    """Plain version of the kernel: ``_ssd_kernel``'s arithmetic, batched
    over (batch, head) and looped over the chunks in order, with the T
    axis zero-padded to a multiple of Q (la = 0, x̄ = 0: a no-op)."""
    b, T, h, hd = x.shape
    ns = B.shape[-1]
    Q = chunk_rows(T, chunk)
    pad = (-T) % Q
    nc = (T + pad) // Q
    xbar = x.float() * dt.float()[..., None]  # [b, T, h, hd]
    la = dt.float() * A.float()[None, None, :]  # [b, T, h]
    xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3) \
        .reshape(b, h, nc, Q, hd)
    la = F.pad(la, (0, 0, 0, pad)).permute(0, 2, 1).reshape(b, h, nc, Q)
    Bf = F.pad(B.float(), (0, 0, 0, pad)).reshape(b, 1, nc, Q, ns)
    Cf = F.pad(C.float(), (0, 0, 0, pad)).reshape(b, 1, nc, Q, ns)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    S = torch.zeros((b, h, ns, hd), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xb, Bm, Cm = xbar[:, :, c], Bf[:, :, c], Cf[:, :, c]
        cum = torch.cumsum(la[:, :, c], dim=-1)  # [b, h, Q]
        total = cum[..., -1:]
        G = Cm @ Bm.transpose(-1, -2)  # [b, 1, Q, Q]
        diff = cum[..., :, None] - cum[..., None, :]
        L = torch.exp(torch.where(tri, diff, -60.0)) * tri
        y = (G * L) @ xb
        y = y + torch.exp(cum)[..., None] * (Cm @ S)
        w = torch.exp(total - cum)  # [b, h, Q]
        S = torch.exp(total)[..., None] * S \
            + (Bm * w[..., None]).transpose(-1, -2) @ xb
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :T].transpose(1, 2).to(x.dtype)
    return y, S.transpose(-1, -2)


def _check(x, dt, A, B, C):
    """Validate what the kernel takes; returns (b, T, h, hd, ns)."""
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"the SSD scan takes one of bf16/f32 for x, B and "
                        f"C, got {x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"the SSD scan takes f32 dt and A, got "
                        f"{dt.dtype}/{A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x [b, T, h, hd] expected, got {tuple(x.shape)}")
    b, T, h, hd = x.shape
    ns = B.shape[-1]
    if dt.shape != (b, T, h) or A.shape != (h,) or B.shape != (b, T, ns) \
            or C.shape != B.shape or T == 0:
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if hd not in HEAD_DIMS or ns % 16 or not 0 < ns <= MAX_STATE:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS} and a state "
                         f"size that is a multiple of 16 and <= "
                         f"{MAX_STATE}; got hd={hd}, ns={ns}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"the SSD scan takes {name} with its last axis "
                             f"contiguous")
    return b, T, h, hd, ns


def ssd_scan(x, dt, A, B, C, *, chunk):
    """x: [b, T, h, hd]; dt: [b, T, h] f32; A: [h] f32; B/C: [b, T, ns].

    Returns (y [b, T, h, hd] in x's dtype, final_state [b, h, hd, ns]
    f32)."""
    if _build.on_cpu(x, dt, A, B, C):
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    b, T, h, hd, ns = _check(x, dt, A, B, C)
    y = torch.empty((b, T, h, hd), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, hd, ns), dtype=torch.float32, device=x.device)
    st = [*x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
          *y.stride()[:3]]
    strides = (ctypes.c_longlong * len(st))(*st)
    fn = getattr(_lib(), f"ssd_scan_{_DTYPES[x.dtype]}")
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), state.data_ptr(),
             ctypes.addressof(strides), b, T, h, hd, ns,
             chunk_rows(T, chunk),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    LAUNCHES["ssd"] += 1
    return y, state
