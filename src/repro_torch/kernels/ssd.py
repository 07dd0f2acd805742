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

:func:`ssd_scan` runs :func:`ssd_scan_plain` for CPU tensors. For CUDA
tensors :func:`ssd_route` picks the kernel: ``csrc/ssd_wgmma.cu`` (tensor
cores, parallel over chunks; each f32 factor split into three bf16 terms
whose sum is exact) for bf16 at the shapes and alignments it takes,
``csrc/ssd.cu`` (FMA) for f32 and every other shape; neither falls back to
the other. On any other device, an unsupported dtype or shape, or a failed
build or launch it raises. ``LAUNCHES`` counts ``ssd_scan`` calls that ran
a kernel (one each, however many CUDA launches the design makes) and
``DESIGN_LAUNCHES`` the design that ran them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

LAUNCHES = {"ssd": 0}
DESIGN_LAUNCHES = {"ssd:wgmma": 0, "ssd:fma": 0}

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
HEAD_DIMS = (32, 64, 128)  # head_dim values the kernel is built for
MAX_STATE = 128            # ns % 16 == 0 and ns <= MAX_STATE
# The tensor-core design (csrc/ssd_wgmma.cu): its head_dims and state sizes,
# its 64-row tiles (Q a multiple of WGMMA_TILE up to WGMMA_MAX_Q) and its
# three bf16 terms per f32 factor; constants of the source, mirrored here.
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_STATES = (64, 128)
WGMMA_TILE = 64
WGMMA_MAX_Q = 256
WGMMA_PASSES = 3


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _DTYPES.values():
        fn = getattr(lib, f"ssd_scan_{dt}")
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_wgmma")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_wgmma_bf16.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.ssd_wgmma_bf16.restype = i
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


def _check_dims(dtype, hd: int, ns: int) -> None:
    """Raise for a dtype, head_dim or state size that no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"the SSD scan takes one of bf16/f32 for x, B and "
                        f"C, got {dtype}")
    if hd not in HEAD_DIMS or ns % 16 or not 0 < ns <= MAX_STATE:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS} and a state "
                         f"size that is a multiple of 16 and <= "
                         f"{MAX_STATE}; got hd={hd}, ns={ns}")


def ssd_route(dtype, hd: int, ns: int, Q: int, strides=(), ptrs=()) -> str:
    """The design that runs :func:`ssd_scan` on CUDA tensors: ``"wgmma"``
    (csrc/ssd_wgmma.cu) for bf16 x, B and C at a head_dim in
    ``WGMMA_HEAD_DIMS``, a state size in ``WGMMA_STATES`` and a chunk Q
    that is a multiple of ``WGMMA_TILE`` up to ``WGMMA_MAX_Q``, when every
    element stride in ``strides`` (x's batch, row and head strides, B's and
    C's batch and row strides) is a multiple of 8 and every address in
    ``ptrs`` (x, B, C) is 16-byte aligned, as its 16-byte copies need;
    ``"fma"`` (csrc/ssd.cu) for f32 and every other shape or alignment.
    Raises TypeError / ValueError, as :func:`ssd_scan` does, for a dtype,
    head_dim or state size that no kernel takes."""
    _check_dims(dtype, hd, ns)
    if (dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            and ns in WGMMA_STATES and Q % WGMMA_TILE == 0
            and 0 < Q <= WGMMA_MAX_Q and all(s % 8 == 0 for s in strides)
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "fma"


def ssd_wgmma_plan(hd: int, ns: int, Q: int) -> dict:
    """Shared memory of the tensor-core design's two tiled launches (the
    numbers ``csrc/ssd_wgmma.cu`` requires): chunk states, three [64, 64]
    planes of x ⊙ dt·w and B ([64, ns]), a 64-row slice of each; chunk
    outputs, C_i ([64, ns]), a region of three [64, 64] planes (a
    64-column half of S_prevᵀ, later the second j-tile buffer) and the
    first j-tile buffer, B_j ([64, ns]) and x_j ([64, 64]); both the
    chunk's cum (f64), its dt (or w) rows (f32) and four scan totals
    (f64), and 1024 bytes to align the tiles; and the bf16 terms per f32
    factor (``passes``). Raises ValueError for a shape the kernel does not
    take."""
    if (hd not in WGMMA_HEAD_DIMS or ns not in WGMMA_STATES
            or Q % WGMMA_TILE or not 0 < Q <= WGMMA_MAX_Q):
        raise ValueError(f"no SSD wgmma plan for hd={hd}, ns={ns}, Q={Q}")
    tile = WGMMA_TILE * 128          # 64 rows of a 64-column bf16 chunk
    wide = (ns // 64) * tile         # a [64, ns] bf16 tile
    scan = WGMMA_MAX_Q * 8 + WGMMA_MAX_Q * 4 + 4 * 8
    states = 3 * tile + wide + scan + 1024
    out = 2 * wide + 4 * tile + scan + 1024
    return {"states_smem": states, "out_smem": out,
            "passes": WGMMA_PASSES}


def _check(x, dt, A, B, C):
    """Validate what the kernels take; returns (b, T, h, hd, ns)."""
    if B.dtype != x.dtype or C.dtype != x.dtype:
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
    _check_dims(x.dtype, hd, ns)
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"the SSD scan takes {name} with its last axis "
                             f"contiguous")
    return b, T, h, hd, ns


def ssd_flops(b: int, T: int, h: int, hd: int, ns: int, Q: int) -> int:
    """The scan's products (the math, one term per factor): per (batch,
    head) and chunk of r live rows the causal half of G·x̄ (2·hd per
    (i, j) pair with j <= i), C·S (but for the first chunk, where S = 0)
    and the state update (2·r·ns·hd each), and C·Bᵀ once per (batch,
    chunk) over its pairs."""
    flops = 0
    for c, c0 in enumerate(range(0, T, Q)):
        r = min(Q, T - c0)
        pairs = r * (r + 1) // 2
        flops += b * h * (2 * hd * pairs + 2 * r * ns * hd * (2 if c else 1))
        flops += b * 2 * ns * pairs
    return flops


def ssd_scan(x, dt, A, B, C, *, chunk):
    """x: [b, T, h, hd]; dt: [b, T, h] f32; A: [h] f32; B/C: [b, T, ns].

    Returns (y [b, T, h, hd] in x's dtype, final_state [b, h, hd, ns]
    f32). On CUDA tensors :func:`ssd_route` picks the kernel; the
    tensor-core design also takes a temporary f32 scratch of the chunk
    states, [b, h, ceil(T / Q), hd, ns]."""
    fake = _build.fake(x)
    if not fake and _build.on_cpu(x, dt, A, B, C):
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    b, T, h, hd, ns = _check(x, dt, A, B, C)
    Q = chunk_rows(T, chunk)
    design = ssd_route(x.dtype, hd, ns, Q,
                       (*x.stride()[:3], *B.stride()[:2], *C.stride()[:2]),
                       (_build.address(x), _build.address(B),
                        _build.address(C)))
    y = torch.empty((b, T, h, hd), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, hd, ns), dtype=torch.float32, device=x.device)
    if fake:
        outs = (y, state)
        if design == "wgmma":  # and its scratch of chunk states, totals
            nc = -(-T // Q)
            outs += (torch.empty((b, h, nc, hd, ns), dtype=torch.float32,
                                 device=x.device),
                     torch.empty((b, h, nc), dtype=torch.float32,
                                 device=x.device))
        _build.record_fake("ssd", design, ssd_flops(b, T, h, hd, ns, Q),
                           (x, dt, A, B, C), outs)
        return y, state
    st = [*x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
          *y.stride()[:3]]
    strides = (ctypes.c_longlong * len(st))(*st)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if design == "wgmma":
        plan = ssd_wgmma_plan(hd, ns, Q)
        nc = -(-T // Q)
        scratch = torch.empty((b, h, nc, hd, ns), dtype=torch.float32,
                              device=x.device)
        totals = torch.empty((b, h, nc), dtype=torch.float32,
                             device=x.device)
        err = _wgmma_lib().ssd_wgmma_bf16(
            *ptrs, scratch.data_ptr(), totals.data_ptr(),
            ctypes.addressof(strides), b, T, h, hd, ns, Q,
            plan["states_smem"], plan["out_smem"], stream)
    else:
        fn = getattr(_lib(), f"ssd_scan_{_DTYPES[x.dtype]}")
        err = fn(*ptrs, ctypes.addressof(strides), b, T, h, hd, ns, Q,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan ({design}) launch failed: cudaError "
                           f"{err}")
    LAUNCHES["ssd"] += 1
    DESIGN_LAUNCHES[f"ssd:{design}"] += 1
    return y, state
