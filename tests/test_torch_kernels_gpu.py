"""repro_torch CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need a CUDA device (decided inside the ``cuda``
fixture) and skip elsewhere. On a machine with a card, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the JAX package's conftest imports jax, which the card
machine does not have). Tolerances: f32 inputs at 1e-4 (FMA vs. the plain
version's matmul order), bf16 at the 2e-2 tier with inputs scaled so one
bf16 ulp of the output stays below it.
"""

import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm, ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


def _packed(sizes, K, N, dtype, dev, block_m, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    M, G = sum(sizes), len(sizes)
    dest, tg, mp = ops._pack_meta(gs, M, G, block_m)
    x = 0.5 * torch.randn((M, K), generator=g, device=dev)
    lhs = ops._scatter_rows(x.to(dtype), dest, mp)

    def w():
        return (torch.randn((G, K, N), generator=g, device=dev)
                / math.sqrt(K)).to(dtype)
    return lhs, w(), w(), tg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,K,N,block_m", [
    ([37, 0, 90, 73], 96, 80, 64),      # zero-token group, ragged N
    ([1, 1, 1, 197], 200, 72, 128),     # ragged K and N
    ([300, 5], 256, 128, 128),
])
def test_gmm_kernels_match_plain(cuda, dtype, sizes, K, N, block_m):
    lhs, wg, wu, tg = _packed(sizes, K, N, dtype, cuda, block_m)
    got = gmm.gmm_tiled(lhs, wg, tg, block_m=block_m)
    want = gmm.gmm_tiled_plain(lhs, wg, tg, block_m=block_m)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(dtype))
    got = gmm.gmm_glu_tiled_pair(lhs, wg, wu, tg, block_m=block_m)
    want = gmm.gmm_glu_plain(lhs, wg, wu, tg, block_m=block_m)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(dtype))
    stacked = torch.cat([wg, wu], dim=-1).contiguous()
    assert torch.equal(gmm.gmm_glu_tiled(lhs, stacked, tg, block_m=block_m),
                       got)


def _wide(t, seed):
    """t's elements with magnitudes 2^u, u uniform in [-20, 20], random
    signs; zero rows (the packed layout's pad rows) stay zero."""
    g = torch.Generator(device=t.device).manual_seed(seed)
    u = torch.rand(t.shape, generator=g, device=t.device) * 40 - 20
    sign = torch.randint(0, 2, t.shape, generator=g, device=t.device) * 2 - 1
    return torch.where(t != 0, sign * torch.exp2(u), 0.0).to(t.dtype)


def _dw_case(cuda, lhs_dtype, sizes, K, N, block_m, wide=False):
    lhs, _, _, tg = _packed(sizes, K, N, lhs_dtype, cuda, block_m)
    dout, _, _, _ = _packed(sizes, N, N, torch.float32, cuda, block_m,
                            seed=1)
    if wide:
        lhs, dout = _wide(lhs.float(), 2).to(lhs_dtype), _wide(dout, 3)
    return lhs, dout, tg


@pytest.mark.parametrize("lhs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,K,N,block_m,wide", [
    ([37, 0, 90, 73], 96, 80, 64, False),   # zero-token group, ragged N
    ([1, 1, 1, 197], 200, 72, 128, False),  # ragged K and N
    ([0, 300, 5, 0], 64, 256, 128, False),  # empty first and last groups
    ([37, 0, 90, 73], 96, 80, 64, True),    # magnitudes 2^-20 .. 2^20
    ([300, 0, 5, 90], 136, 264, 128, True),
    ([37, 0, 90, 73, 5], 96, 80, 8, False),   # row tiles under 64
    ([37, 0, 90, 73, 5], 96, 80, 16, True),
    ([37, 0, 90, 73, 5], 96, 80, 32, False),
])
def test_gmm_dw_matches_plain(cuda, lhs_dtype, sizes, K, N, block_m, wide):
    """K and N multiples of 8: the tensor-core kernel (the design
    counter says so), within 1e-4 * max|plain|."""
    lhs, dout, tg = _dw_case(cuda, lhs_dtype, sizes, K, N, block_m, wide)
    G = len(sizes)
    assert gmm.gmm_dw_route(lhs_dtype, dout.dtype, K, N, block_m) == "wgmma"
    kernels.reset_launch_counts()
    got = gmm.gmm_dw_tiled(lhs, dout, tg, G, block_m=block_m)
    assert kernels.design_launch_counts()["gmm_dw:wgmma"] == 1
    assert kernels.design_launch_counts()["gmm_dw:fma"] == 0
    want = gmm.gmm_dw_tiled_plain(lhs, dout, tg, G, block_m=block_m)
    assert got.dtype == torch.float32 and got.shape == (G, K, N)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    for g, n in enumerate(sizes):
        if n == 0:
            assert not got[g].any()
    # one block per output tile, no atomics: bit-identical on a rerun
    assert torch.equal(gmm.gmm_dw_tiled(lhs, dout, tg, G, block_m=block_m),
                       got)


@pytest.mark.parametrize("lhs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,K,N,block_m", [
    ([37, 0, 90, 73], 100, 80, 64),     # K % 8 != 0
    ([1, 1, 1, 197], 96, 36, 128),      # N % 8 != 0
    ([37, 0, 90, 73, 5], 60, 44, 8),    # both, 8-row tiles
])
def test_gmm_dw_ragged_shapes_take_fma(cuda, lhs_dtype, sizes, K, N,
                                       block_m):
    """K or N not a multiple of 8: the FMA kernel (csrc/gmm_dw.cu), at the
    same tier, zeros for empty groups, bit-identical reruns."""
    lhs, dout, tg = _dw_case(cuda, lhs_dtype, sizes, K, N, block_m)
    G = len(sizes)
    kernels.reset_launch_counts()
    got = gmm.gmm_dw_tiled(lhs, dout, tg, G, block_m=block_m)
    assert kernels.design_launch_counts()["gmm_dw:fma"] == 1
    assert kernels.design_launch_counts()["gmm_dw:wgmma"] == 0
    want = gmm.gmm_dw_tiled_plain(lhs, dout, tg, G, block_m=block_m)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    for g, n in enumerate(sizes):
        if n == 0:
            assert not got[g].any()
    assert torch.equal(gmm.gmm_dw_tiled(lhs, dout, tg, G, block_m=block_m),
                       got)


def test_gmm_dw_wgmma_refusals(cuda):
    """A CUDA call the routed kernel cannot take raises; nothing falls
    back: a misaligned view, a non-f32 dout, block_m off 8."""
    lhs, dout, tg = _dw_case(cuda, torch.float32, [70, 60], 64, 64, 64)
    kernels.reset_launch_counts()
    flat = torch.zeros(lhs.numel() + 1, device=cuda)
    shifted = flat[1:].view_as(lhs)     # 4-byte, not 16-byte, aligned
    shifted.copy_(lhs)
    with pytest.raises(ValueError, match="16-byte"):
        gmm.gmm_dw_tiled(shifted, dout, tg, 2, block_m=64)
    with pytest.raises(TypeError):
        gmm.gmm_dw_tiled(lhs, dout.to(torch.bfloat16), tg, 2, block_m=64)
    with pytest.raises(ValueError, match="block_m % 8"):
        gmm.gmm_dw_tiled(lhs, dout, tg.repeat_interleave(16), 2, block_m=4)
    assert kernels.launch_counts()["gmm_dw"] == 0


@pytest.mark.parametrize("lhs_t,rhs_t,out_t,trans", [
    (torch.bfloat16, torch.bfloat16, torch.float32, False),
    (torch.float32, torch.bfloat16, torch.float32, False),
    (torch.float32, torch.bfloat16, torch.float32, True),
    (torch.float32, torch.float32, torch.float32, True),
])
@pytest.mark.parametrize("sizes,K,N,block_m", [
    ([37, 0, 90, 73], 96, 80, 64),
    ([1, 1, 1, 197], 200, 72, 128),
])
def test_gmm_backward_operand_types_match_plain(cuda, lhs_t, rhs_t, out_t,
                                                trans, sizes, K, N, block_m):
    lhs, w, _, tg = _packed(sizes, K, N, lhs_t, cuda, block_m)
    w = w.to(rhs_t)
    if trans:  # swapaxes(W, 1, 2) of a row-major [G, N, K] weight
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    got = gmm.gmm_tiled(lhs, w, tg, block_m=block_m, out_dtype=out_t)
    want = gmm.gmm_tiled_plain(lhs, w, tg, block_m=block_m, out_dtype=out_t)
    assert got.dtype == out_t
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def _gmm_close(got, want):
    """bf16 out: 2e-2 * min(1, max|want|); f32 out: 1e-4 * max|want|."""
    top = float(want.float().abs().max())
    tol = 1e-4 * top if got.dtype == torch.float32 else 2e-2 * min(1.0, top)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=max(tol, 1e-30))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sizes,K,N,block_m", [
    ([37, 0, 90, 73], 96, 80, 64),       # zero-token group, 64-row tiles
    ([200, 0, 5], 200, 136, 128),        # K, N multiples of 8, not of tiles
    ([130, 1, 0, 250], 256, 384, 128),   # trailing all-pad tiles
    ([300, 5], 264, 128, 64),
    ([0, 700, 310, 550, 0, 900, 129], 512, 640, 128),  # train-like, cut
    ([128, 300, 45], 2048, 264, 256),    # 256-row groups, deep K
])
def test_gmm_wgmma_matches_plain(cuda, out_dtype, sizes, K, N, block_m):
    lhs, w, _, tg = _packed(sizes, K, N, torch.bfloat16, cuda, block_m)
    kernels.reset_launch_counts()
    got = gmm.gmm_tiled(lhs, w, tg, block_m=block_m, out_dtype=out_dtype)
    assert kernels.design_launch_counts()["gmm:wgmma"] == 1
    assert kernels.design_launch_counts()["gmm:fma"] == 0
    want = gmm.gmm_tiled_plain(lhs, w, tg, block_m=block_m,
                               out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    _gmm_close(got, want)
    pad = lhs.abs().sum(1) == 0          # pad rows are written, as zeros
    assert pad.any() and not got[pad].any()
    # one block per output tile, no atomics: bit-identical on a rerun
    assert torch.equal(gmm.gmm_tiled(lhs, w, tg, block_m=block_m,
                                     out_dtype=out_dtype), got)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gmm_wgmma_row_tiles_agree(cuda, out_dtype):
    """The 64-row tiles (block_m 64: one consumer warpgroup) give the
    128-row tiles' result bit for bit (the sums run in the same k
    order)."""
    lhs, w, _, tg = _packed([300, 0, 77, 140], 320, 384, torch.bfloat16,
                            cuda, 128)
    assert gmm.gmm_wgmma_plan(128)["tile_m"] == 128
    assert gmm.gmm_wgmma_plan(64)["tile_m"] == 64
    want = gmm.gmm_tiled(lhs, w, tg, block_m=128, out_dtype=out_dtype)
    got = gmm.gmm_tiled(lhs, w, tg.repeat_interleave(2), block_m=64,
                        out_dtype=out_dtype)
    assert torch.equal(got, want)


def test_gmm_wgmma_refusals(cuda):
    lhs, w, _, tg = _packed([70, 60], 64, 64, torch.bfloat16, cuda, 64)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="K % 8"):   # K = 60
        gmm.gmm_tiled(lhs[:, :60].contiguous(), w[:, :60].contiguous(), tg,
                      block_m=64)
    with pytest.raises(ValueError, match="N % 8"):   # N = 60
        gmm.gmm_tiled(lhs, w[..., :60].contiguous(), tg, block_m=64)
    shifted = torch.empty(lhs.numel() + 4, dtype=lhs.dtype, device=cuda)
    shifted = shifted[4:].view(lhs.shape).copy_(lhs)  # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        gmm.gmm_tiled(shifted, w, tg, block_m=64)
    with pytest.raises(TypeError):                   # no bf16^T kernel
        gmm.gmm_tiled(lhs, w.transpose(1, 2).contiguous().transpose(1, 2),
                      tg, block_m=64)
    assert kernels.launch_counts()["gmm"] == 0
    assert sum(kernels.design_launch_counts().values()) == 0


_ROW_TILE_CASES = [
    ([37, 0, 90, 73, 5], 96, 80, 8),        # empty group, ragged groups
    ([37, 0, 90, 73, 5], 96, 80, 16),
    ([37, 0, 90, 73, 5], 136, 264, 32),
    ([37, 0, 90, 73], 96, 80, 64),
    ([200, 0, 5], 200, 136, 128),           # K, N multiples of 8, not 64
    ([0, 700, 310, 550, 0, 900, 129], 512, 640, 128),  # train-like, cut
]


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("sizes,K,N,block_m", _ROW_TILE_CASES)
def test_gmm_glu_wgmma_matches_plain(cuda, stacked, sizes, K, N, block_m):
    """The bf16 fused GLU on the tensor cores (gmm_glu:wgmma), pair and
    stacked forms, within 2e-2 * min(1, max|plain|); pad rows zero; a
    rerun is bit-identical and both forms agree bit for bit."""
    lhs, wg, wu, tg = _packed(sizes, K, N, torch.bfloat16, cuda, block_m)
    kernels.reset_launch_counts()
    if stacked:
        w = torch.cat([wg, wu], dim=-1).contiguous()

        def call():
            return gmm.gmm_glu_tiled(lhs, w, tg, block_m=block_m)
    else:
        def call():
            return gmm.gmm_glu_tiled_pair(lhs, wg, wu, tg, block_m=block_m)
    got = call()
    designs = kernels.design_launch_counts()
    assert designs["gmm_glu:wgmma"] == 1 and designs["gmm_glu:fma"] == 0
    want = gmm.gmm_glu_plain(lhs, wg, wu, tg, block_m=block_m)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _gmm_close(got, want)
    pad = lhs.abs().sum(1) == 0
    assert pad.any() and not got[pad].any()
    assert torch.equal(call(), got)
    other = (gmm.gmm_glu_tiled_pair(lhs, wg, wu, tg, block_m=block_m)
             if stacked else gmm.gmm_glu_tiled(
                 lhs, torch.cat([wg, wu], dim=-1).contiguous(), tg,
                 block_m=block_m))
    assert torch.equal(other, got)


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("sizes,K,N,block_m", _ROW_TILE_CASES)
def test_gmm_f32_wgmma_matches_plain(cuda, wide, sizes, K, N, block_m,
                                     trans):
    """f32 lhs x a bf16 weight -> f32 on the tensor cores (the three-term
    split, gmm:wgmma), the weight as it lies: swapaxes of a [G, N, K]
    weight (trans, read K-major) or a row-major [G, K, N] one (read
    MN-major); within 1e-4 * max|plain|, at lhs magnitudes 2^-20 .. 2^20
    too; pad rows zero, reruns bit-identical."""
    lhs, _, _, tg = _packed(sizes, K, N, torch.float32, cuda, block_m)
    if wide:
        lhs = _wide(lhs, 4)
    if trans:
        _, w, _, _ = _packed(sizes, N, K, torch.bfloat16, cuda, block_m,
                             seed=1)
        w_t = w.transpose(1, 2)               # [G, K, N] view of [G, N, K]
    else:
        _, w_t, _, _ = _packed(sizes, K, N, torch.bfloat16, cuda, block_m,
                               seed=1)
    assert gmm.gmm_route(lhs.dtype, w_t.dtype, torch.float32, trans, K, N,
                         block_m) == "wgmma"
    kernels.reset_launch_counts()
    got = gmm.gmm_tiled(lhs, w_t, tg, block_m=block_m,
                        out_dtype=torch.float32)
    designs = kernels.design_launch_counts()
    assert designs["gmm:wgmma"] == 1 and designs["gmm:fma"] == 0
    variant = "gmm:f32.bf16T->f32" if trans else "gmm:f32.bf16->f32"
    assert kernels.variant_launch_counts()[variant] == 1
    want = gmm.gmm_tiled_plain(lhs, w_t, tg, block_m=block_m,
                               out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _gmm_close(got, want)
    pad = lhs.abs().sum(1) == 0
    assert pad.any() and not got[pad].any()
    assert torch.equal(gmm.gmm_tiled(lhs, w_t, tg, block_m=block_m,
                                     out_dtype=torch.float32), got)


@pytest.mark.parametrize("sizes,K,N,block_m", [
    ([37, 0, 90, 73], 100, 80, 64),     # K % 8 != 0
    ([1, 1, 1, 197], 96, 36, 128),      # N % 8 != 0
    ([37, 0, 90, 73, 5], 60, 44, 8),    # both, 8-row tiles
])
def test_glu_and_split_gmm_ragged_shapes_take_fma(cuda, sizes, K, N,
                                                  block_m):
    """K or N off the multiples of 8: the bf16 GLU, f32 x bf16^T and f32 x
    bf16 run on the FMA kernel (csrc/gmm.cu; the design counters say so)
    at the same tiers."""
    lhs, wg, wu, tg = _packed(sizes, K, N, torch.bfloat16, cuda, block_m)
    kernels.reset_launch_counts()
    got = gmm.gmm_glu_tiled_pair(lhs, wg, wu, tg, block_m=block_m)
    _gmm_close(got, gmm.gmm_glu_plain(lhs, wg, wu, tg, block_m=block_m))
    lhs32, _, _, _ = _packed(sizes, K, N, torch.float32, cuda, block_m)
    w_t = wg.transpose(1, 2).contiguous().transpose(1, 2)
    got = gmm.gmm_tiled(lhs32, w_t, tg, block_m=block_m,
                        out_dtype=torch.float32)
    _gmm_close(got, gmm.gmm_tiled_plain(lhs32, w_t, tg, block_m=block_m,
                                        out_dtype=torch.float32))
    got = gmm.gmm_tiled(lhs32, wg, tg, block_m=block_m,
                        out_dtype=torch.float32)
    _gmm_close(got, gmm.gmm_tiled_plain(lhs32, wg, tg, block_m=block_m,
                                        out_dtype=torch.float32))
    designs = kernels.design_launch_counts()
    assert designs["gmm_glu:fma"] == 1 and designs["gmm_glu:wgmma"] == 0
    assert designs["gmm:fma"] == 2 and designs["gmm:wgmma"] == 0


def test_glu_and_split_gmm_refuse_misaligned_tensors(cuda):
    """A CUDA tensor that is not 16-byte aligned raises on the tensor-core
    GLU, f32 x bf16^T and f32 x bf16 routes; nothing falls back to the FMA
    kernel."""
    lhs, wg, wu, tg = _packed([70, 60], 64, 64, torch.bfloat16, cuda, 64)
    lhs32, _, _, _ = _packed([70, 60], 64, 64, torch.float32, cuda, 64)
    kernels.reset_launch_counts()

    def shifted(t):  # 8 bytes off a 16-byte boundary
        off = 8 // t.element_size()
        flat = torch.empty(t.numel() + off, dtype=t.dtype, device=cuda)
        return flat[off:].view(t.shape).copy_(t)
    with pytest.raises(ValueError, match="16-byte"):
        gmm.gmm_glu_tiled_pair(shifted(lhs), wg, wu, tg, block_m=64)
    with pytest.raises(ValueError, match="16-byte"):
        gmm.gmm_glu_tiled_pair(lhs, wg, shifted(wu), tg, block_m=64)
    with pytest.raises(ValueError, match="16-byte"):
        gmm.gmm_tiled(shifted(lhs32), wg.transpose(1, 2), tg, block_m=64,
                      out_dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        gmm.gmm_tiled(lhs32, shifted(wg), tg, block_m=64,
                      out_dtype=torch.float32)
    assert kernels.launch_counts()["gmm"] == 0
    assert kernels.launch_counts()["gmm_glu"] == 0
    assert sum(kernels.design_launch_counts().values()) == 0


@pytest.mark.parametrize("scaled", [False, True])
def test_moe_ffn_grads_on_card_match_cpu(cuda, scaled):
    g = torch.Generator().manual_seed(5)
    sizes = [137, 0, 190, 73]
    x = 0.5 * torch.randn((400, 64), generator=g)
    ws = [0.1 * torch.randn(s, generator=g)
          for s in ((4, 64, 96), (4, 64, 96), (4, 96, 64))]
    sc = torch.rand(400, generator=g)
    ct = torch.randn((400, 64), generator=g)
    gs = torch.tensor(sizes, dtype=torch.int32)

    def run(dev):
        ins = [t.detach().to(dev).requires_grad_(True) for t in (x, *ws, sc)]
        out = ops.moe_ffn(*ins[:4], gs.to(dev),
                          row_scales=ins[4] if scaled else None,
                          small_m=False)
        out.backward(ct.to(dev))
        return [out.detach()] + [t.grad for t in ins[:4 + scaled]]

    want = run("cpu")
    kernels.reset_launch_counts()
    got = run(cuda)
    counts = kernels.launch_counts()
    assert counts["gmm_glu"] == 1 and counts["gmm_dw"] == 3
    assert counts["gmm"] == 1 + 2 + scaled + 3
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_moe_ffn_on_card_matches_cpu(cuda):
    g = torch.Generator().manual_seed(3)
    sizes = [37, 0, 90, 73]
    x = 0.5 * torch.randn((200, 64), generator=g)
    ws = [0.1 * torch.randn(s, generator=g)
          for s in ((4, 64, 96), (4, 64, 96), (4, 96, 64))]
    gs = torch.tensor(sizes, dtype=torch.int32)
    sc = torch.rand(200, generator=g)
    want = ops.moe_ffn(x, *ws, gs, row_scales=sc)
    kernels.reset_launch_counts()
    got = ops.moe_ffn(x.to(cuda), *(w.to(cuda) for w in ws), gs.to(cuda),
                      row_scales=sc.to(cuda))
    assert kernels.launch_counts()["gmm_glu"] == 1
    assert kernels.launch_counts()["gmm"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_group_dense_bf16_on_card_keeps_f32_products(cuda):
    """The group-dense route's bf16 products are f32 on the card (GEMM with
    an f32 output) as on the CPU (widened operands): only the summation
    order differs, which flips at most 1% of the bf16 outputs by one ulp
    (plus 1e-3 * max|out| near 0)."""
    g = torch.Generator().manual_seed(4)
    sizes = [3, 1, 0, 4]
    x = (0.5 * torch.randn((8, 256), generator=g)).bfloat16()
    ws = [(torch.randn(s, generator=g) / math.sqrt(s[1])).bfloat16()
          for s in ((4, 256, 512), (4, 256, 512), (4, 512, 256))]
    gs = torch.tensor(sizes, dtype=torch.int32)
    want = ops.moe_ffn(x, *ws, gs, small_m=True).float()
    got = ops.moe_ffn(x.to(cuda), *(w.to(cuda) for w in ws), gs.to(cuda),
                      small_m=True).float().cpu()
    one_ulp = 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
    assert torch.all((got - want).abs()
                     <= one_ulp + 1e-3 * want.abs().max())
    assert (got != want).float().mean() <= 0.01


def _paged_inputs(cuda, dtype, B, KH, G, hd, ps, MP, seed=1):
    """Random q and pools, a shuffled table and random frontiers: slot 0
    dead, slot B - 1's first table slot unallocated, every table slot past
    a slot's frontier -1."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = B * MP + 2
    q = torch.randn((B, KH, G, hd), generator=g, device=cuda).to(dtype)
    kp = torch.randn((P, ps, KH, hd), generator=g, device=cuda).to(dtype)
    vp = torch.randn((P, ps, KH, hd), generator=g, device=cuda).to(dtype)
    table = torch.randperm(P, generator=g, device=cuda)[:B * MP]
    table = table.reshape(B, MP).to(torch.int32).contiguous()
    q_pos = torch.randint(0, MP * ps, (B,), generator=g, device=cuda,
                          dtype=torch.int32)
    q_pos[0] = -1              # dead slot
    table[-1, 0] = -1          # an unallocated slot mid-sequence
    for b, p in enumerate(q_pos.tolist()):
        table[b, max(p, 0) // ps + 1:] = -1
    return q, kp, vp, table, q_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KH,G,hd,ps,MP,kw", [
    (3, 2, 2, 32, 8, 4, {}),
    (3, 2, 2, 32, 8, 4, dict(window=6, softcap=5.0)),
    (4, 4, 4, 128, 16, 26, {}),          # mixtral-w2 decode shapes
    (2, 1, 8, 64, 64, 3, dict(window=40)),  # 64-line pages, MQA
    (4, 4, 4, 128, 16, 256, {}),         # 4096 positions a slot
    (2, 2, 32, 256, 128, 40, dict(window=300)),  # widest: G 32, hd 256
])
def test_paged_decode_matches_plain(cuda, dtype, B, KH, G, hd, ps, MP, kw):
    q, kp, vp, table, q_pos = _paged_inputs(cuda, dtype, B, KH, G, hd, ps,
                                            MP)
    got = pa.paged_decode_forward(q, kp, vp, table, q_pos,
                                  scale=hd ** -0.5, **kw)
    want = pa.paged_decode_plain(q, kp, vp, table, q_pos, scale=hd ** -0.5,
                                 **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(dtype))
    assert torch.all(got[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_empty_splits_match_plain(cuda, dtype):
    """Splits with no live line (a slot whose frontier ends in its first
    split, a window that leaves the early splits behind, a split of only
    -1 table slots, a slot whose every table slot is -1) contribute
    nothing: the combine skips them."""
    B, KH, G, hd, ps, MP = 4, 2, 4, 128, 16, 64
    q, kp, vp, table, q_pos = _paged_inputs(cuda, dtype, B, KH, G, hd, ps,
                                            MP, seed=2)
    plan = pa.paged_decode_plan(B, KH, G, hd, MP, q.element_size(),
                                pa._sm_count(cuda.index or 0))
    per = plan["pages_per_split"]
    assert plan["splits"] >= 4
    q_pos[:] = torch.tensor([5, MP * ps - 1, MP * ps - 1, 7 * per * ps],
                            dtype=torch.int32)
    table[1, per:3 * per] = -1      # two whole splits unallocated
    table[3, :] = -1                # no live key: output 0
    for kw in ({}, dict(window=per * ps + 3)):
        got = pa.paged_decode_forward(q, kp, vp, table, q_pos,
                                      scale=hd ** -0.5, **kw)
        want = pa.paged_decode_plain(q, kp, vp, table, q_pos,
                                     scale=hd ** -0.5, **kw)
        _gmm_close(got, want)
        assert torch.all(got[3] == 0) and torch.all(torch.isfinite(got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_reruns_are_bitwise_equal(cuda, dtype):
    """The splits are combined in order, without atomics: two calls give
    the same bits."""
    args = _paged_inputs(cuda, dtype, 4, 4, 4, 128, 16, 256, seed=3)
    first = pa.paged_decode_forward(*args, scale=128 ** -0.5)
    assert torch.equal(pa.paged_decode_forward(*args, scale=128 ** -0.5),
                       first)


def test_paged_decode_refusals(cuda):
    """Shapes the kernel does not take and misaligned pools raise; nothing
    falls back to the plain version."""
    q, kp, vp, table, q_pos = _paged_inputs(cuda, torch.bfloat16, 2, 2, 2,
                                            64, 8, 4)
    kernels.reset_launch_counts()
    kw = dict(scale=0.125)
    with pytest.raises(ValueError, match="head_dim"):   # hd 48
        pa.paged_decode_forward(q[..., :48].contiguous(),
                                kp[..., :48].contiguous(),
                                vp[..., :48].contiguous(), table, q_pos, **kw)
    flat = torch.empty(kp.numel() + 4, dtype=kp.dtype, device=cuda)
    shifted = flat[4:].view(kp.shape).copy_(kp)          # 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_decode_forward(q, shifted, vp, table, q_pos, **kw)
    with pytest.raises(TypeError):
        pa.paged_decode_forward(q.half(), kp.half(), vp.half(), table, q_pos,
                                **kw)
    assert kernels.launch_counts()["paged_decode"] == 0


def test_launch_counters_and_refusals(cuda):
    lhs, wg, _, tg = _packed([70, 60], 64, 64, torch.float32, cuda, 64)
    kernels.reset_launch_counts()
    got = gmm.gmm_tiled(lhs, wg, tg, block_m=64)
    gmm.gmm_tiled(lhs, wg, tg, block_m=64)
    assert kernels.launch_counts() == {"gmm_glu": 0, "gmm": 2, "gmm_dw": 0,
                                       "paged_decode": 0, "flash_fwd": 0,
                                       "flash_dq": 0, "flash_dkv": 0,
                                       "ssd": 0}
    assert kernels.variant_launch_counts()["gmm:f32.f32->f32"] == 2
    # 32-row tiles (half a 64-row group tile each): the kernel runs them
    tg32 = tg.repeat_interleave(2)
    got32 = gmm.gmm_tiled(lhs, wg, tg32, block_m=32)
    want32 = gmm.gmm_tiled_plain(lhs, wg, tg32, block_m=32)
    torch.testing.assert_close(got32, want32, rtol=0,
                               atol=1e-4 * float(want32.abs().max()))
    assert torch.equal(got32, got)   # the same sums, in the same k order
    assert kernels.launch_counts()["gmm"] == 3
    with pytest.raises(ValueError, match="block_m % 8"):
        gmm.gmm_tiled(lhs, wg, tg.repeat_interleave(16), block_m=4)
    with pytest.raises(TypeError):
        gmm.gmm_tiled(lhs.half(), wg.half(), tg, block_m=64)
    assert kernels.launch_counts()["gmm"] == 3


# Every grouped kernel (operand types as gmm_route names them) at the row
# tiles the reference's capacity routing produces, with one group empty.
_SMALL_TILE_VARIANTS = [
    ("gmm", torch.bfloat16, torch.bfloat16, torch.bfloat16, False),
    ("gmm", torch.bfloat16, torch.bfloat16, torch.float32, False),
    ("gmm", torch.float32, torch.float32, torch.float32, False),
    ("gmm", torch.float32, torch.bfloat16, torch.float32, False),
    ("gmm", torch.float32, torch.bfloat16, torch.float32, True),
    ("gmm", torch.float32, torch.float32, torch.float32, True),
    ("glu", torch.bfloat16, torch.bfloat16, torch.bfloat16, False),
    ("glu", torch.float32, torch.float32, torch.float32, False),
    ("gmm_dw", torch.bfloat16, torch.float32, torch.float32, False),
    ("gmm_dw", torch.float32, torch.float32, torch.float32, False),
]


@pytest.mark.parametrize("block_m", [8, 16, 32])
@pytest.mark.parametrize("kind,lhs_t,rhs_t,out_t,trans", _SMALL_TILE_VARIANTS)
def test_grouped_kernels_take_small_row_tiles(cuda, kind, lhs_t, rhs_t,
                                              out_t, trans, block_m):
    """block_m 8, 16 and 32 (multiples of 8, not of 64): each tile stays
    in its group; bf16 out within 2e-2 * min(1, max|plain|), f32 within
    1e-4 * max|plain|."""
    sizes = [37, 0, 90, 73, 5]
    G = len(sizes)
    lhs, w, wu, tg = _packed(sizes, 96, 80, lhs_t, cuda, block_m)
    assert tg.numel() * block_m == lhs.shape[0]
    kernels.reset_launch_counts()
    if kind == "gmm":
        w = w.to(rhs_t)
        if trans:  # swapaxes(W, 1, 2) of a row-major [G, N, K] weight
            w = w.transpose(1, 2).contiguous().transpose(1, 2)
        got = gmm.gmm_tiled(lhs, w, tg, block_m=block_m, out_dtype=out_t)
        want = gmm.gmm_tiled_plain(lhs, w, tg, block_m=block_m,
                                   out_dtype=out_t)
        variant = gmm.variant_name(*(gmm._DTYPES[t] for t in
                                     (lhs_t, rhs_t, out_t)), trans)
        assert kernels.variant_launch_counts()[f"gmm:{variant}"] == 1
        # K 96, N 80: every bf16 rhs on the tensor cores
        tensor_cores = rhs_t == torch.bfloat16
        design = "wgmma" if tensor_cores else "fma"
        assert kernels.design_launch_counts()[f"gmm:{design}"] == 1
    elif kind == "glu":
        got = gmm.gmm_glu_tiled_pair(lhs, w, wu, tg, block_m=block_m)
        want = gmm.gmm_glu_plain(lhs, w, wu, tg, block_m=block_m)
        assert kernels.launch_counts()["gmm_glu"] == 1
        design = "wgmma" if lhs_t == torch.bfloat16 else "fma"
        assert kernels.design_launch_counts()[f"gmm_glu:{design}"] == 1
    else:
        dout, _, _, _ = _packed(sizes, 80, 80, torch.float32, cuda, block_m,
                                seed=1)
        got = gmm.gmm_dw_tiled(lhs, dout, tg, G, block_m=block_m)
        want = gmm.gmm_dw_tiled_plain(lhs, dout, tg, G, block_m=block_m)
        assert not got[1].any()          # the empty group: exact zeros
        assert kernels.launch_counts()["gmm_dw"] == 1
        assert kernels.design_launch_counts()["gmm_dw:wgmma"] == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    _gmm_close(got, want)


def _flash_inputs(B, H, KH, S, T, hd, dtype, dev, model_layout, seed=0):
    """q, k, v, do in the kernels' [B, heads, rows, hd] layout, either
    contiguous or as transposed views of the model layout [B, rows, heads,
    hd]; v and do scaled down (1/2, 1/4) so the bf16 outputs stay below 4,
    where one bf16 ulp is below the 2e-2 tier."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(heads, rows, scale=1.0):
        shape = (B, rows, heads, hd) if model_layout else (B, heads, rows, hd)
        t = (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)
        return t.transpose(1, 2) if model_layout else t
    return rnd(H, S), rnd(KH, T), rnd(KH, T, 0.5), rnd(H, S, 0.25)


def _close(got, want, dtype):
    """bf16: 2e-2 * min(1, max|want|); f32: 1e-4 * max|want|."""
    top = float(want.float().abs().max())
    tol = 1e-4 * top if dtype == torch.float32 else 2e-2 * min(1.0, top)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=max(tol, 1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,S,T,hd,kw", [
    (2, 4, 2, 200, 200, 32, dict(causal=True)),        # ragged tiles, GQA
    (1, 4, 1, 96, 160, 64, dict(causal=False)),        # S != T, MQA
    (2, 4, 2, 300, 300, 64, dict(causal=True, window=48)),
    (1, 2, 2, 130, 130, 32, dict(causal=True, window=1, q_len=100,
                                 kv_len=60)),          # rows with no key
    (2, 16, 4, 256, 256, 128, dict(causal=True)),      # mixtral-w1 heads
    (1, 4, 2, 150, 150, 256, dict(causal=True)),       # 32-row tiles
    (1, 2, 1, 100, 100, 192, dict(causal=False, window=30)),
])
@pytest.mark.parametrize("model_layout", [False, True])
def test_flash_kernels_match_plain(cuda, dtype, B, H, KH, S, T, hd, kw,
                                   model_layout):
    q, k, v, do = _flash_inputs(B, H, KH, S, T, hd, dtype, cuda,
                                model_layout)
    kw = dict(kw, scale=hd ** -0.5)
    o, lse = fa.flash_forward(q, k, v, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    assert o.dtype == dtype and o.stride() == q.stride()
    _close(o, o_p, dtype)
    live = lse_p > fa._NEG
    assert torch.equal(lse[~live], lse_p[~live])
    assert torch.all(o[~live] == 0)
    _close(lse[live], lse_p[live], torch.float32)
    grads = fa.flash_backward(q, k, v, o_p, lse_p, do, **kw)
    want = fa.flash_backward_plain(q, k, v, o_p, lse_p, do, **kw)
    for got, ref_, x in zip(grads, want, (q, k, v)):
        assert got.dtype == dtype and got.stride() == x.stride()
        _close(got, ref_, dtype)
    # one block per output tile, no atomics: bit-identical on a rerun
    again = fa.flash_backward(q, k, v, o_p, lse_p, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


@pytest.mark.parametrize("kw", [dict(softcap=5.0), dict(softcap=3.0,
                                                        window=40)])
def test_flash_forward_softcap_matches_plain(cuda, kw):
    q, k, v, _ = _flash_inputs(2, 4, 2, 160, 160, 64, torch.float32, cuda,
                               True)
    q = 4.0 * q
    o, lse = fa.flash_forward(q, k, v, scale=0.125, causal=True, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, scale=0.125, causal=True,
                                        **kw)
    _close(o, o_p, torch.float32)
    _close(lse, lse_p, torch.float32)


def test_flash_attention_grads_on_card_match_cpu(cuda):
    g = torch.Generator().manual_seed(6)
    q = torch.randn((2, 200, 8, 64), generator=g)
    k, v = (torch.randn((2, 200, 2, 64), generator=g) for _ in range(2))
    ct = torch.randn((2, 200, 8, 64), generator=g)

    def run(dev):
        ins = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_attention(*ins, causal=True, window=120)
        out.backward(ct.to(dev))
        return [out.detach()] + [t.grad for t in ins]

    want = run("cpu")
    kernels.reset_launch_counts()
    got = run(cuda)
    counts = kernels.launch_counts()
    assert (counts["flash_fwd"], counts["flash_dq"],
            counts["flash_dkv"]) == (1, 1, 1)
    for a, b in zip(got, want):
        assert a.is_contiguous()
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_flash_refusals(cuda):
    q, k, v, _ = _flash_inputs(1, 2, 1, 64, 64, 64, torch.float32, cuda,
                               False)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError):  # head_dim not a multiple of 32
        fa.flash_forward(q[..., :48], k[..., :48], v[..., :48], scale=1.0,
                         causal=True)
    with pytest.raises(TypeError):
        fa.flash_forward(q, k.bfloat16(), v, scale=1.0, causal=True)
    with pytest.raises(TypeError):
        fa.flash_forward(q.half(), k.half(), v.half(), scale=1.0,
                         causal=True)
    with pytest.raises(ValueError):  # head_dim not contiguous
        fa.flash_forward(q.transpose(2, 3), k, v, scale=1.0, causal=True)
    assert kernels.launch_counts()["flash_fwd"] == 0


@pytest.mark.parametrize("B,H,KH,S,T,hd,kw", [
    (2, 4, 2, 200, 200, 64, dict(causal=True)),        # ragged tiles, GQA
    (1, 4, 1, 96, 160, 128, dict(causal=False)),       # S != T, MQA
    (1, 4, 2, 160, 96, 64, dict(causal=True)),         # S > T
    (2, 4, 2, 300, 300, 64, dict(causal=True, window=48)),
    (1, 2, 2, 130, 130, 128, dict(causal=True, window=1, q_len=100,
                                  kv_len=60)),         # rows with no key
    (2, 16, 4, 256, 256, 128, dict(causal=True)),      # mixtral-w1 heads
    (1, 4, 2, 48, 48, 64, dict(causal=True)),          # one warpgroup
    (1, 2, 1, 64, 200, 128, dict(causal=False, q_len=50)),
    (2, 4, 2, 160, 160, 64, dict(causal=True, softcap=5.0)),
    (1, 4, 2, 200, 200, 128, dict(causal=False, softcap=3.0, window=40)),
])
@pytest.mark.parametrize("model_layout", [False, True])
def test_flash_forward_wgmma_matches_plain(cuda, B, H, KH, S, T, hd, kw,
                                           model_layout):
    dtype = torch.bfloat16
    q, k, v, _ = _flash_inputs(B, H, KH, S, T, hd, dtype, cuda,
                               model_layout)
    if kw.get("softcap"):
        q = 4.0 * q      # logits large enough for the tanh to bend them
    kw = dict(kw, scale=hd ** -0.5)
    kernels.reset_launch_counts()
    o, lse = fa.flash_forward(q, k, v, **kw)
    designs = kernels.design_launch_counts()
    assert designs.pop("flash_fwd:wgmma") == 1
    assert not any(designs.values())
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    assert o.dtype == dtype and o.stride() == q.stride()
    _close(o, o_p, dtype)
    live = lse_p > fa._NEG
    assert torch.equal(lse[~live], lse_p[~live])
    assert torch.all(o[~live] == 0)
    _close(lse[live], lse_p[live], torch.float32)
    # one block per q-tile, no atomics: bit-identical on a rerun
    o2, lse2 = fa.flash_forward(q, k, v, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_flash_forward_wgmma_refusals(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((1, 2, 64, 132), generator=g, device=cuda).bfloat16()
    q = x[..., :128]                     # row stride 132: not a multiple of 8
    k = v = torch.randn((1, 1, 64, 128), generator=g,
                        device=cuda).bfloat16()
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_forward(q, k, v, scale=1.0, causal=True)
    assert kernels.launch_counts()["flash_fwd"] == 0
    # bf16 at a head_dim the tensor-core kernel is not built for: FMA
    fa.flash_forward(q[..., :32], k[..., :32], v[..., :32], scale=1.0,
                     causal=True)
    assert kernels.design_launch_counts()["flash_fwd:fma"] == 1


@pytest.mark.parametrize("B,H,KH,S,T,hd,kw", [
    (2, 4, 2, 200, 200, 64, dict(causal=True)),        # ragged tiles, GQA
    (1, 4, 1, 96, 160, 128, dict(causal=False)),       # S != T, MQA
    (1, 4, 2, 160, 96, 64, dict(causal=True)),         # S > T
    (2, 4, 2, 300, 300, 64, dict(causal=True, window=48)),
    # rows with no key; window 2, not 1: with one live key per row the
    # gradients are 0 analytically (dp - delta cancels) and both versions
    # give f32 rounding noise, which no relative tier can hold
    (1, 2, 2, 130, 130, 128, dict(causal=True, window=2, q_len=100,
                                  kv_len=60)),
    (2, 16, 4, 256, 256, 128, dict(causal=True)),      # mixtral-w1 heads
    (1, 4, 2, 48, 48, 64, dict(causal=True)),          # one warpgroup
    (1, 2, 1, 64, 200, 128, dict(causal=False, q_len=50)),
])
@pytest.mark.parametrize("model_layout", [False, True])
def test_flash_backward_wgmma_matches_plain(cuda, B, H, KH, S, T, hd, kw,
                                            model_layout):
    """The tensor-core dq and dk/dv kernels against the plain backward,
    fed the plain forward's o and lse: within 2e-2 * min(1, max|plain|)
    (p and ds are rounded to bf16 as product operands), zero gradients on
    rows with no live key, the inputs' strides, bit-identical reruns."""
    dtype = torch.bfloat16
    q, k, v, do = _flash_inputs(B, H, KH, S, T, hd, dtype, cuda,
                                model_layout)
    kw = dict(kw, scale=hd ** -0.5)
    o, lse = fa.flash_forward_plain(q, k, v, **kw)
    kernels.reset_launch_counts()
    grads = fa.flash_backward(q, k, v, o, lse, do, **kw)
    designs = kernels.design_launch_counts()
    assert (designs["flash_dq:wgmma"], designs["flash_dkv:wgmma"]) == (1, 1)
    assert designs["flash_dq:fma"] == designs["flash_dkv:fma"] == 0
    want = fa.flash_backward_plain(q, k, v, o, lse, do, **kw)
    for got, ref_, x in zip(grads, want, (q, k, v)):
        assert got.dtype == dtype and got.stride() == x.stride()
        _close(got, ref_, dtype)
    dead = lse <= fa._NEG                 # query rows with no live key
    assert torch.all(grads[0][dead] == 0)
    kv_len = kw.get("kv_len", T)
    assert not grads[1][:, :, kv_len:].any()
    assert not grads[2][:, :, kv_len:].any()
    # no atomics, a fixed order of the two warpgroups' sums: bit-identical
    again = fa.flash_backward(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


def test_flash_backward_wgmma_refusals(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((1, 2, 64, 132), generator=g, device=cuda).bfloat16()
    q = x[..., :128]                     # row stride 132: not a multiple of 8
    k = v = torch.randn((1, 1, 64, 128), generator=g,
                        device=cuda).bfloat16()
    do = torch.randn((1, 2, 64, 128), generator=g, device=cuda).bfloat16()
    o, lse = fa.flash_forward_plain(q, k, v, scale=1.0, causal=True)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_backward(q, k, v, o, lse, do, scale=1.0, causal=True)
    shifted = torch.empty(do.numel() + 4, dtype=do.dtype, device=cuda)
    shifted = shifted[4:].view(do.shape).copy_(do)  # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_backward(q.contiguous(), k, v, o, lse, shifted, scale=1.0,
                          causal=True)
    assert kernels.launch_counts()["flash_dq"] == 0
    assert kernels.launch_counts()["flash_dkv"] == 0
    # bf16 at a head_dim the tensor-core kernels are not built for: FMA
    fa.flash_backward(q[..., :32], k[..., :32], v[..., :32], o[..., :32],
                      lse, do[..., :32], scale=1.0, causal=True)
    designs = kernels.design_launch_counts()
    assert (designs["flash_dq:fma"], designs["flash_dkv:fma"]) == (1, 1)


def _ssd_inputs(b, T, h, hd, ns, dtype, dev, seed=0):
    """x, dt, A, B, C as the model hands them over: x, B and C are strided
    views into one [b, T, h*hd + 2*ns] tensor (the conv output), dt =
    softplus(N(0,1)) f32, A = -(1..16) as mamba2's init. x, B and C are
    scaled so |y| stays below 1, where one bf16 ulp is below the 2e-2
    tier."""
    g = torch.Generator(device=dev).manual_seed(seed)
    din = h * hd
    xbc = 0.25 * torch.randn((b, T, din + 2 * ns), generator=g, device=dev)
    xbc = xbc.to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, T, h), generator=g, device=dev))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    return (xbc[..., :din].reshape(b, T, h, hd), dt, A,
            xbc[..., din:din + ns], xbc[..., din + ns:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,T,h,hd,ns,chunk", [
    (2, 1000, 4, 64, 128, 256),   # ragged T: 4 chunks, the last one short
    (2, 100, 3, 64, 128, 256),    # T < 128: the chunk drops to 128
    (1, 512, 2, 32, 32, 64),      # 8 chunks of 64, hd 32
    (1, 300, 2, 128, 48, 96),     # hd 128, ns 48, a chunk of 1.5 tiles
    (2, 2048, 8, 64, 128, 256),   # mamba2-2.7b's chunk and widths
    (1, 700, 3, 128, 64, 128),    # hd 128 (two column slices), ns 64, ragged
    (2, 384, 2, 64, 64, 192),     # Q 192: three 64-row tiles a chunk
    (1, 256, 2, 128, 128, 256),   # hd 128, ns 128, one chunk
])
def test_ssd_scan_matches_plain(cuda, dtype, b, T, h, hd, ns, chunk):
    """x, B and C strided views of one conv output (row stride h·hd +
    2 ns, read in place); bf16 at head_dim 64/128, state 64/128 and a
    chunk of 64-row tiles on the tensor-core design, the rest on FMA."""
    args = _ssd_inputs(b, T, h, hd, ns, dtype, cuda)
    kernels.reset_launch_counts()
    y, state = ssd.ssd_scan(*args, chunk=chunk)
    y_p, state_p = ssd.ssd_scan_plain(*args, chunk=chunk)
    assert y.dtype == dtype and state.dtype == torch.float32
    assert y.shape == (b, T, h, hd) and state.shape == (b, h, hd, ns)
    _close(y, y_p, dtype)
    _close(state, state_p, torch.float32)
    Q = ssd.chunk_rows(T, chunk)
    wgmma = (dtype == torch.bfloat16 and hd in (64, 128) and ns in (64, 128)
             and Q % 64 == 0)
    design = "ssd:wgmma" if wgmma else "ssd:fma"
    assert kernels.launch_counts()["ssd"] == 1
    assert kernels.design_launch_counts()[design] == 1
    # one store per output, no atomics: bit-identical on a rerun
    again = ssd.ssd_scan(*args, chunk=chunk)
    assert torch.equal(again[0], y) and torch.equal(again[1], state)


def test_ssd_off_wgmma_inputs_take_fma(cuda):
    """f32 at the tensor-core shapes, bf16 at head_dim 32, at state 48 and
    at a chunk of 96 rows, and bf16 views whose base is not 16-byte
    aligned run on the FMA kernel, and agree with the plain version."""
    bf = torch.bfloat16
    x, dt, A, B, C = _ssd_inputs(2, 300, 4, 64, 128, bf, cuda)
    xbc = torch.empty((2, 300, 4 * 64 + 2 * 128 + 1), dtype=bf,
                      device=cuda)[..., 1:]          # one element in
    xbc[..., :256] = x.flatten(-2)
    xbc[..., 256:384], xbc[..., 384:] = B, C
    shifted = (xbc[..., :256].unflatten(-1, (4, 64)), dt, A,
               xbc[..., 256:384], xbc[..., 384:])
    cases = [
        (_ssd_inputs(2, 300, 4, 64, 128, torch.float32, cuda), 256),
        (_ssd_inputs(1, 300, 2, 32, 64, bf, cuda), 256),
        (_ssd_inputs(1, 300, 2, 64, 48, bf, cuda), 256),
        (_ssd_inputs(1, 300, 2, 64, 128, bf, cuda), 96),
        (shifted, 256),
    ]
    for args, chunk in cases:
        kernels.reset_launch_counts()
        y, state = ssd.ssd_scan(*args, chunk=chunk)
        assert kernels.design_launch_counts()["ssd:fma"] == 1
        assert kernels.design_launch_counts()["ssd:wgmma"] == 0
        y_p, state_p = ssd.ssd_scan_plain(*args, chunk=chunk)
        _close(y, y_p, args[0].dtype)
        _close(state, state_p, torch.float32)


def test_ssd_grads_on_card_match_cpu(cuda):
    """The autograd Function (kernel forward, autograd of ref.ssd_chunked
    backward) on the card against the same Function on the CPU (plain
    forward), f32: output and state within 1e-4 * max|cpu|, the five
    gradients within 1e-3 * max|cpu|. The backward recomputes
    ssd_chunked in f32 on each device, summing in other orders, and its
    exp(cum_i - cum_j) is only as exact as the f32 cum: at A = -16 a
    256-row chunk's cum reaches ~-3000, whose ulp is 2.4e-4 (ddt measured
    1.2e-4 * max apart)."""
    args = [t.float().cpu() for t in _ssd_inputs(2, 600, 4, 64, 128,
                                                 torch.float32, "cpu")]
    g = torch.Generator().manual_seed(7)
    gy = torch.randn((2, 600, 4, 64), generator=g)
    gs = torch.randn((2, 4, 64, 128), generator=g)

    def run(dev):
        ins = [t.detach().to(dev).requires_grad_(True) for t in args]
        y, state = ops.ssd(*ins, chunk=256)
        torch.autograd.backward([y, state], [gy.to(dev), gs.to(dev)])
        return [y.detach(), state.detach()] + [t.grad for t in ins]

    want = run("cpu")
    kernels.reset_launch_counts()
    got = run(cuda)
    assert kernels.launch_counts()["ssd"] == 1
    for i, (a, b) in enumerate(zip(got, want)):
        rel = 1e-4 if i < 2 else 1e-3
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=rel * float(b.abs().max()))


def test_ssd_refusals(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 64, 2, 64, 32, torch.float32, cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError):  # head_dim not built
        ssd.ssd_scan(x[..., :48], dt, A, B, C, chunk=64)
    with pytest.raises(ValueError):  # state size not a multiple of 16
        ssd.ssd_scan(x, dt, A, B[..., :8], C[..., :8], chunk=64)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.bfloat16(), A, B, C, chunk=64)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, A, B.bfloat16(), C, chunk=64)
    with pytest.raises(ValueError):  # state size not contiguous
        ssd.ssd_scan(x, dt, A, B.transpose(1, 2).contiguous().transpose(
            1, 2), C, chunk=64)
    assert kernels.launch_counts()["ssd"] == 0


@pytest.mark.parametrize("mode", ["replicated", "alltoall"])
def test_zebra_override_two_streams_match_one_stream(cuda, mode):
    """The zebra layer override on the card (bf16, smoke widths, R 2,
    capacity 1.25, the grouped kernels at block_m 8/16): the loss and
    every gradient of two streams run twice are bitwise equal, and equal
    to one stream within 1e-4 * max|one stream|."""
    from repro_torch.core import zebra_spmd as zs
    from repro_torch.models import registry, stack
    from repro_torch.models.modules import RunConfig
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    run = RunConfig(attn_impl="chunked", remat="full")
    zcfg = zs.ZebraConfig(mode=mode, num_microbatches=2,
                          n_chunks=2 if mode == "alltoall" else 1)
    gen = torch.Generator().manual_seed(0)
    params = stack.init_model(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen)

    def grads(dev, streams):
        p = _tree_to(params, dev)
        leaves = _leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        ov = zs.make_layer_override(cfg, run, zcfg, streams=streams)
        logits, _, aux = stack.apply_model(p, cfg, run, tokens.to(dev),
                                           layer_override=ov)
        loss = logits.float().square().mean() + aux["moe_aux_loss"]
        g = torch.autograd.grad(loss, leaves)
        return [loss.detach()] + [t.float() for t in g]

    two, again, one = (grads(cuda, True), grads(cuda, True),
                       grads(cuda, False))
    for a, b, c in zip(two, again, one):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-4 * float(c.abs().max()))


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _leaves(tree):
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out
