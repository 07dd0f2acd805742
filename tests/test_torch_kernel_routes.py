"""The kernel wrappers' route rules and shared-memory plans, on the CPU.

Which hand-written kernel runs a call on a CUDA tensor is a pure function
of dtypes and shapes (``gmm.gmm_route``, ``gmm.gmm_glu_route``,
``gmm.gmm_dw_route``, ``flash_attention.flash_fwd_route`` and
``flash_bwd_route``, and ``ssd.ssd_route``, which also reads strides and
alignment: ``"wgmma"`` for the tensor-core kernels, ``"fma"`` for the
others, or an error), and the tensor-core kernels' shared-memory plans are
computed in Python and passed to the launch (``gmm.gmm_wgmma_plan``,
``gmm.gmm_dw_wgmma_plan``, ``flash_attention.flash_wgmma_plan`` and
``flash_bwd_wgmma_plan``, ``ssd.ssd_wgmma_plan``; the paged decode's split
of the page walk across blocks, ``paged_attention.paged_decode_plan``).
Both
are held here to what the CUDA sources build: every plan fits in a block's
227 KB, every grouped kernel takes a block_m that is a multiple of 8 (the
reference's capacity routing), and a bf16 call the tensor-core kernel
cannot take raises instead of falling
back. The grouped GEMM wrappers' launches are also driven here against a
stand-in for the card (:func:`fake_card`: the libraries' entry points
recorded, not run), which shows which entry each call reaches and which
design counter it moves; the paged decode wrapper's launch too.
"""

import types

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd

BF, F32, F16 = torch.bfloat16, torch.float32, torch.float16
HOPPER_SMEM = 227 * 1024  # bytes of shared memory one block can use
H100_SMS = 132


@pytest.mark.parametrize("out", [BF, F32])
@pytest.mark.parametrize("K,N,block_m", [(2048, 7168, 128), (7168, 2048, 128),
                                         (96, 80, 64), (8, 8, 256),
                                         (64, 64, 32), (64, 64, 96),
                                         (96, 80, 8), (8, 8, 16)])
def test_gmm_route_bf16_takes_tensor_cores(out, K, N, block_m):
    assert gmm.gmm_route(BF, BF, out, False, K, N, block_m) == "wgmma"


_F32_FMA_SHAPES = [(2048, 7168, 128), (60, 36, 64), (60, 36, 8),
                   (96, 80, 200)]


@pytest.mark.parametrize("lhs,rhs,trans,K,N,block_m", [
    (lhs, rhs, trans, *shape)
    for lhs, rhs, trans in [(F32, F32, False), (F32, BF, False),
                            (F32, BF, True), (F32, F32, True)]
    for shape in _F32_FMA_SHAPES
    # K and N multiples of 8: f32 x bf16 takes the tensor cores (below)
    if not (rhs == BF and shape[0] % 8 == 0 and shape[1] % 8 == 0)])
def test_gmm_route_f32_operands_take_fma(lhs, rhs, trans, K, N, block_m):
    # the FMA kernel masks any K and N itself, and rows past a small tile
    assert gmm.gmm_route(lhs, rhs, F32, trans, K, N, block_m) == "fma"


@pytest.mark.parametrize("K,N,block_m", [
    (2048, 7168, 128), (96, 80, 200),      # from the FMA test above
    (7168, 2048, 128), (96, 80, 8), (8, 8, 16), (200, 72, 32)])
def test_gmm_route_f32_lhs_transposed_bf16_takes_tensor_cores(K, N, block_m):
    """The MoE backward's data gradients (f32 cotangent x swapaxes of a
    bf16 weight): csrc/gmm_f32_wgmma.cu where K and N are multiples of 8."""
    assert gmm.gmm_route(F32, BF, F32, True, K, N, block_m) == "wgmma"


@pytest.mark.parametrize("K,N,block_m", [(100, 80, 128), (96, 36, 128),
                                         (2044, 7168, 8), (2048, 7172, 16)])
def test_gmm_route_f32_lhs_transposed_bf16_ragged_takes_fma(K, N, block_m):
    assert gmm.gmm_route(F32, BF, F32, True, K, N, block_m) == "fma"


@pytest.mark.parametrize("K,N,block_m", [
    (7168, 2048, 128),                     # y = h @ wo at the W1 shapes
    (2048, 7168, 128), (96, 80, 200), (96, 80, 8), (8, 8, 16),
    (200, 72, 32)])
def test_gmm_route_f32_lhs_bf16_takes_tensor_cores(K, N, block_m):
    """The router-scale gradient's recompute y = h @ wo (f32 h, the bf16
    weight row-major as it lies): csrc/gmm_f32_wgmma.cu, the weight read
    MN-major, where K and N are multiples of 8."""
    assert gmm.gmm_route(F32, BF, F32, False, K, N, block_m) == "wgmma"


@pytest.mark.parametrize("K,N,block_m", [(100, 80, 128), (96, 36, 128),
                                         (7172, 2048, 8), (7168, 2044, 16),
                                         (60, 36, 64)])
def test_gmm_route_f32_lhs_bf16_ragged_takes_fma(K, N, block_m):
    assert gmm.gmm_route(F32, BF, F32, False, K, N, block_m) == "fma"


@pytest.mark.parametrize("lhs,rhs,out,trans", [(F32, F32, F32, False),
                                               (F32, BF, F32, True),
                                               (BF, BF, F32, False)])
@pytest.mark.parametrize("block_m", [0, 4, 12, 100])
def test_gmm_route_refuses_block_m_off_eight(lhs, rhs, out, trans, block_m):
    with pytest.raises(ValueError, match="block_m % 8"):
        gmm.gmm_route(lhs, rhs, out, trans, 64, 64, block_m)


@pytest.mark.parametrize("K,N,block_m,why", [
    (60, 64, 128, "K % 8"), (2044, 7168, 128, "K % 8"),
    (64, 60, 128, "N % 8"), (2048, 7172, 64, "N % 8"),
    (64, 64, 12, "block_m % 8"), (64, 64, 20, "block_m % 8"),
])
@pytest.mark.parametrize("out", [BF, F32])
def test_gmm_route_refuses_what_wgmma_cannot_take(K, N, block_m, why, out):
    with pytest.raises(ValueError, match=why):
        gmm.gmm_route(BF, BF, out, False, K, N, block_m)


@pytest.mark.parametrize("lhs,rhs,out,trans", [
    (F16, F16, F16, False),      # no fp16 kernel
    (BF, BF, BF, True),          # bf16 x bf16^T has no kernel
    (F32, F32, BF, False),       # f32 sums are only stored in f32
    (BF, F32, F32, False),
])
def test_gmm_route_refuses_types_without_kernel(lhs, rhs, out, trans):
    with pytest.raises(TypeError):
        gmm.gmm_route(lhs, rhs, out, trans, 64, 64, 128)


def test_gmm_variant_and_design_counters_keep_their_names():
    kernels.reset_launch_counts()
    assert set(kernels.variant_launch_counts()) == {
        "gmm:bf16.bf16->bf16", "gmm:f32.f32->f32", "gmm:bf16.bf16->f32",
        "gmm:f32.bf16->f32", "gmm:f32.bf16T->f32", "gmm:f32.f32T->f32",
        "gmm_dw:bf16.f32->f32", "gmm_dw:f32.f32->f32"}
    assert kernels.design_launch_counts() == {
        "gmm:wgmma": 0, "gmm:fma": 0, "gmm_glu:wgmma": 0, "gmm_glu:fma": 0,
        "gmm_dw:wgmma": 0, "gmm_dw:fma": 0,
        "flash_fwd:wgmma": 0,
        "flash_fwd:fma": 0, "flash_dq:wgmma": 0, "flash_dq:fma": 0,
        "flash_dkv:wgmma": 0, "flash_dkv:fma": 0,
        "ssd:wgmma": 0, "ssd:fma": 0}


class _Entry:
    """A recorded C entry point: ``argtypes`` as the wrapper declares them,
    each call checked against their number and appended to ``calls``."""

    def __init__(self, lib, name, calls):
        self.lib, self.name, self.calls = lib, name, calls
        self.argtypes = self.restype = None

    def __call__(self, *args):
        assert self.argtypes is not None and len(args) == len(
            self.argtypes), (self.name, len(args), self.argtypes)
        self.calls.append((self.lib, self.name, tuple(
            a for a in args if isinstance(a, int) and abs(a) < 2 ** 31)))
        return 0


class _Lib:
    def __init__(self, name, calls):
        self._name, self._calls, self._entries = name, calls, {}

    def __getattr__(self, entry):
        if entry.startswith("_"):
            raise AttributeError(entry)
        return self._entries.setdefault(
            entry, _Entry(self._name, entry, self._calls))


_LIBS = ("_lib", "_wgmma_lib", "_f32_wgmma_lib", "_dw_lib", "_dw_wgmma_lib")


@pytest.fixture
def fake_card(monkeypatch):
    """The grouped GEMM wrappers as on a card, with the built libraries
    replaced by recorders (no kernel runs): CPU tensors take the CUDA
    route, each library declares its entries' argtypes as it does on the
    card, and each launch is checked against them and appends (library,
    entry, int arguments) to the returned list, reporting success."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_build, "load", lambda name: _Lib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(pa, "_sm_count", lambda index: H100_SMS)
    caches = [getattr(gmm, fn) for fn in _LIBS] + [pa._lib]
    for fn in caches:
        fn.cache_clear()
    kernels.reset_launch_counts()
    yield calls
    kernels.reset_launch_counts()
    for fn in caches:   # no recorder outlives the test
        fn.cache_clear()


def _operands(M, K, N, lhs, rhs, trans, block_m=64, G=2):
    tg = torch.zeros(M // block_m, dtype=torch.int32)
    w = torch.zeros((G, N, K) if trans else (G, K, N), dtype=rhs)
    return torch.zeros((M, K), dtype=lhs), \
        (w.transpose(1, 2) if trans else w), tg


def test_gmm_design_counts_follow_the_variant_counts(fake_card):
    """Every gmm_tiled launch moves its variant's counter and the counter
    of the design it ran on, counted at the launch (f32 x bf16^T takes
    either design, by shape)."""
    for n, (lhs, rhs, out, trans, K, N) in (
            (2, (BF, BF, BF, False, 96, 80)),
            (3, (BF, BF, F32, False, 96, 80)),
            (5, (F32, BF, F32, True, 96, 80)),    # tensor cores
            (1, (F32, BF, F32, True, 60, 80)),    # ragged K: FMA
            (4, (F32, F32, F32, True, 96, 80)),
            (2, (F32, BF, F32, False, 96, 80)),   # tensor cores
            (3, (F32, BF, F32, False, 96, 36))):  # ragged N: FMA
        for _ in range(n):
            a, w, tg = _operands(128, K, N, lhs, rhs, trans)
            gmm.gmm_tiled(a, w, tg, block_m=64, out_dtype=out)
    variants = kernels.variant_launch_counts()
    designs = kernels.design_launch_counts()
    assert variants["gmm:f32.bf16T->f32"] == 6
    assert variants["gmm:f32.bf16->f32"] == 5
    assert designs["gmm:wgmma"] == 12 and designs["gmm:fma"] == 8
    assert sum(v for k, v in variants.items() if k.startswith("gmm:")) \
        == designs["gmm:wgmma"] + designs["gmm:fma"] \
        == kernels.launch_counts()["gmm"]
    assert [c[:2] for c in fake_card] == (
        [("gmm_wgmma", "gmm_wgmma_bf16")] * 2
        + [("gmm_wgmma", "gmm_wgmma_f32")] * 3
        + [("gmm_f32_wgmma", "gmm_t_f32_bf16_f32")] * 5
        + [("gmm", "gmm_t_f32_bf16_f32")] + [("gmm", "gmm_t_f32_f32_f32")] * 4
        + [("gmm_f32_wgmma", "gmm_f32_bf16_f32_wgmma")] * 2
        + [("gmm", "gmm_f32_bf16_f32")] * 3)


def test_gmm_tiled_split_launch_takes_the_weight_as_it_lies(fake_card):
    """f32 x swapaxes(W) with W [G, N, K] bf16: the tensor-core entry gets
    W's own pointer, (Mp, K, N, G, block_m) and the f32 plan's tile and
    shared memory; the output is [Mp, N] f32."""
    a, w, tg = _operands(256, 2048, 7168, F32, BF, True, block_m=128, G=3)
    out = gmm.gmm_tiled(a, w, tg, block_m=128, out_dtype=F32)
    assert out.shape == (256, 7168) and out.dtype == F32
    plan = gmm.gmm_wgmma_plan(128, F32)
    (lib, entry, ints), = fake_card
    assert (lib, entry) == ("gmm_f32_wgmma", "gmm_t_f32_bf16_f32")
    assert ints == (256, 2048, 7168, 3, 128, 128, plan["smem_bytes"], 0)


@pytest.mark.parametrize("block_m,tile_m", [(128, 128), (8, 8), (32, 32)])
def test_gmm_tiled_f32_row_major_bf16_launch(fake_card, block_m, tile_m):
    """f32 h x the row-major bf16 wo [G, K, N] (y = h @ wo): the
    tensor-core entry of that layout gets wo's own pointer, (Mp, K, N, G,
    block_m) and the f32 plan's tile and shared memory; the output is
    [Mp, N] f32, counted as gmm:f32.bf16->f32 on gmm:wgmma."""
    a, w, tg = _operands(256, 7168, 2048, F32, BF, False, block_m=block_m,
                         G=3)
    out = gmm.gmm_tiled(a, w, tg, block_m=block_m, out_dtype=F32)
    assert out.shape == (256, 2048) and out.dtype == F32
    plan = gmm.gmm_wgmma_plan(block_m, F32)
    assert plan["tile_m"] == tile_m
    (lib, entry, ints), = fake_card
    assert (lib, entry) == ("gmm_f32_wgmma", "gmm_f32_bf16_f32_wgmma")
    assert ints == (256, 7168, 2048, 3, block_m, tile_m, plan["smem_bytes"],
                    0)
    assert kernels.variant_launch_counts()["gmm:f32.bf16->f32"] == 1
    assert kernels.design_launch_counts()["gmm:wgmma"] == 1


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype,K,N,design", [
    (BF, 96, 80, "wgmma"), (BF, 2048, 7168, "wgmma"),
    (BF, 100, 80, "fma"), (BF, 96, 36, "fma"),     # off the multiples of 8
    (F32, 96, 80, "fma")])
def test_gmm_glu_launch_by_design(fake_card, stacked, dtype, K, N, design):
    """The pair form reads each weight with row stride N; the stacked form
    [G, K, 2N] reads one weight with row stride 2N and the up half at
    column offset N. Each call moves its design's counter."""
    G, M, bm = 2, 128, 64
    lhs = torch.zeros((M, K), dtype=dtype)
    tg = torch.zeros(M // bm, dtype=torch.int32)
    if stacked:
        out = gmm.gmm_glu_tiled(lhs, torch.zeros((G, K, 2 * N), dtype=dtype),
                                tg, block_m=bm)
        ldw, u_off = 2 * N, N
    else:
        w = torch.zeros((G, K, N), dtype=dtype)
        out = gmm.gmm_glu_tiled_pair(lhs, w, w.clone(), tg, block_m=bm)
        ldw, u_off = N, 0
    assert out.shape == (M, N) and out.dtype == dtype
    assert gmm.gmm_glu_route(dtype, K, N, ldw, u_off, bm) == design
    (lib, entry, ints), = fake_card
    if design == "wgmma":
        plan = gmm.gmm_wgmma_plan(bm)
        assert (lib, entry) == ("gmm_wgmma", "gmm_glu_wgmma")
        assert ints == (M, K, N, G, ldw, u_off, bm, plan["tile_m"],
                        plan["smem_bytes"], 0)
    else:
        assert (lib, entry) == ("gmm", f"gmm_glu_{gmm._DTYPES[dtype]}")
        assert ints == (M, K, N, ldw, u_off, bm, 0)
    designs = kernels.design_launch_counts()
    assert designs[f"gmm_glu:{design}"] == 1
    assert kernels.launch_counts()["gmm_glu"] == 1
    assert designs["gmm_glu:wgmma"] + designs["gmm_glu:fma"] == 1


@pytest.mark.parametrize("call", ["glu", "split", "bf16", "split_row_major"])
def test_tensor_core_gmm_refuses_misaligned_tensors(fake_card, call):
    """A tensor that is not 16-byte aligned raises on the tensor-core
    routes; nothing falls back to the FMA kernel."""
    dtype = F32 if call.startswith("split") else BF
    flat = torch.zeros(128 * 96 + 2, dtype=dtype)
    lhs = flat[2:].view(128, 96)                   # 4 or 8 bytes off
    tg = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        if call == "glu":
            w = torch.zeros((2, 96, 80), dtype=BF)
            gmm.gmm_glu_tiled_pair(lhs, w, w, tg, block_m=64)
        else:
            _, w, _ = _operands(128, 96, 80, dtype, BF, call == "split")
            gmm.gmm_tiled(lhs, w, tg, block_m=64, out_dtype=F32)
    assert fake_card == [] and kernels.launch_counts()["gmm"] == 0
    assert sum(kernels.design_launch_counts().values()) == 0


@pytest.mark.parametrize("block_m", [8, 16, 128, 200])
@pytest.mark.parametrize("K,N,ldw,u_off", [
    (2048, 7168, 7168, 0), (2048, 7168, 14336, 7168),   # pair, stacked
    (96, 80, 80, 0), (96, 80, 160, 80), (8, 8, 8, 0)])
def test_gmm_glu_route_bf16_takes_tensor_cores(block_m, K, N, ldw, u_off):
    assert gmm.gmm_glu_route(BF, K, N, ldw, u_off, block_m) == "wgmma"


@pytest.mark.parametrize("dtype,K,N,ldw,u_off", [
    (F32, 2048, 7168, 7168, 0), (F32, 96, 80, 160, 80),   # f32: FMA
    (BF, 100, 80, 80, 0), (BF, 96, 36, 36, 0),            # ragged K, N
    (BF, 96, 36, 72, 36), (BF, 96, 80, 84, 0), (BF, 96, 80, 160, 84)])
def test_gmm_glu_route_other_inputs_take_fma(dtype, K, N, ldw, u_off):
    assert gmm.gmm_glu_route(dtype, K, N, ldw, u_off, 128) == "fma"


@pytest.mark.parametrize("dtype,block_m,err", [
    (F16, 128, TypeError), (torch.float64, 128, TypeError),
    (BF, 12, ValueError), (F32, 0, ValueError), (BF, 100, ValueError)])
def test_gmm_glu_route_refusals(dtype, block_m, err):
    with pytest.raises(err):
        gmm.gmm_glu_route(dtype, 96, 80, 80, 0, block_m)


@pytest.mark.parametrize("block_m,tile_m", [
    (64, 64), (128, 128), (192, 64), (256, 128), (384, 128),
    (8, 8), (16, 16), (32, 32), (96, 32), (200, 8)])
def test_gmm_wgmma_plan_fits_and_tiles_one_group(block_m, tile_m):
    plan = gmm.gmm_wgmma_plan(block_m)
    assert plan["tile_m"] == tile_m    # the largest of 128/64/32/16/8
    assert block_m % tile_m == 0       # a row tile never spans two groups
    # a warpgroup multiplies 64 lhs rows: under 64 the stage keeps 64
    assert plan["stage_bytes"] == ((max(tile_m, 64) + gmm.GMM_TILE_N)
                                   * gmm.GMM_TILE_K * 2)
    assert plan["smem_bytes"] == (gmm.GMM_STAGES * plan["stage_bytes"]
                                  + 16 * gmm.GMM_STAGES + 1024)
    assert plan["smem_bytes"] <= HOPPER_SMEM == _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("block_m", [0, 4, 12, 20, 100])
def test_gmm_wgmma_plan_refusals(block_m):
    with pytest.raises(ValueError, match="block_m % 8"):
        gmm.gmm_wgmma_plan(block_m)


@pytest.mark.parametrize("block_m,tile_m", [
    (8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (200, 8)])
def test_gmm_glu_plan_is_the_bf16_plan(block_m, tile_m):
    """The GLU's stage holds the lhs slice, a gate and an up slice of
    GMM_TILE_N / 2 columns each: the bytes of the bf16 GEMM's stage, so
    it launches with that plan."""
    plan = gmm.gmm_wgmma_plan(block_m)
    assert plan["tile_m"] == tile_m and plan["passes"] == 1
    glu_stage = (max(tile_m, 64) + 2 * (gmm.GMM_TILE_N // 2)) \
        * gmm.GMM_TILE_K * 2
    assert plan["stage_bytes"] == glu_stage
    assert plan["smem_bytes"] == gmm.GMM_STAGES * (glu_stage + 16) + 1024


@pytest.mark.parametrize("block_m,tile_m", [
    (8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (256, 128),
    (96, 32), (200, 8)])
def test_gmm_f32_wgmma_plan_fits(block_m, tile_m):
    """f32 lhs (csrc/gmm_f32_wgmma.cu): the lhs slice at 4 bytes an element
    beside the [GMM_TILE_N, 64] bf16 weight, GMM_F32_STAGES stages, the
    three split terms as three products."""
    plan = gmm.gmm_wgmma_plan(block_m, F32)
    assert plan["tile_m"] == tile_m and block_m % tile_m == 0
    assert plan["stage_bytes"] == (max(tile_m, 64) * 4
                                   + gmm.GMM_TILE_N * 2) * gmm.GMM_TILE_K
    assert plan["smem_bytes"] == (gmm.GMM_F32_STAGES
                                  * (plan["stage_bytes"] + 16) + 1024)
    assert plan["smem_bytes"] <= HOPPER_SMEM == _build.SMEM_PER_BLOCK
    assert plan["passes"] == 3


@pytest.mark.parametrize("lhs", [BF, F32])
@pytest.mark.parametrize("K,N,block_m", [(7168, 2048, 128), (2048, 7168, 128),
                                         (96, 80, 8), (200, 72, 16),
                                         (64, 256, 32), (8, 8, 200)])
def test_gmm_dw_route_takes_tensor_cores(lhs, K, N, block_m):
    assert gmm.gmm_dw_route(lhs, F32, K, N, block_m) == "wgmma"


@pytest.mark.parametrize("lhs", [BF, F32])
@pytest.mark.parametrize("K,N", [(100, 80), (96, 36), (7172, 2048),
                                 (2048, 7170), (4, 4), (1, 8)])
def test_gmm_dw_route_ragged_shapes_take_fma(lhs, K, N):
    # the FMA kernel masks any K and N itself
    assert gmm.gmm_dw_route(lhs, F32, K, N, 128) == "fma"


@pytest.mark.parametrize("lhs", [BF, F32])
@pytest.mark.parametrize("block_m", [0, 4, 12, 100])
def test_gmm_dw_route_refuses_block_m_off_eight(lhs, block_m):
    with pytest.raises(ValueError, match="block_m % 8"):
        gmm.gmm_dw_route(lhs, F32, 64, 64, block_m)


@pytest.mark.parametrize("lhs,dout", [(F32, BF), (BF, BF), (F16, F32),
                                      (F32, F16), (torch.float64, F32)])
def test_gmm_dw_route_refuses_types_without_kernel(lhs, dout):
    with pytest.raises(TypeError):
        gmm.gmm_dw_route(lhs, dout, 64, 64, 128)


@pytest.mark.parametrize("lhs,planes,passes", [(F32, 3, 6), (BF, 1, 3)])
@pytest.mark.parametrize("block_m", [8, 16, 32, 64, 128])
def test_gmm_dw_wgmma_plan_fits(lhs, planes, passes, block_m):
    plan = gmm.gmm_dw_wgmma_plan(block_m, lhs)
    plane = gmm.GMM_DW_SLICE * gmm.GMM_DW_TILE * 2   # one bf16 term
    assert plan["stage_bytes"] == (planes + 3) * plane
    assert plan["smem_bytes"] == gmm.GMM_DW_STAGES * plan["stage_bytes"] \
        + 1024
    assert plan["smem_bytes"] <= HOPPER_SMEM == _build.SMEM_PER_BLOCK
    assert plan["passes"] == passes


@pytest.mark.parametrize("lhs", [BF, F32])
@pytest.mark.parametrize("block_m", [0, 4, 12, 20, 100])
def test_gmm_dw_wgmma_plan_refusals(lhs, block_m):
    with pytest.raises(ValueError, match="block_m % 8"):
        gmm.gmm_dw_wgmma_plan(block_m, lhs)


def _paged_operands(B, KH, G, hd, ps, MP, dtype=BF):
    q = torch.zeros((B, KH, G, hd), dtype=dtype)
    pool = torch.zeros((B * MP + 1, ps, KH, hd), dtype=dtype)
    table = torch.zeros((B, MP), dtype=torch.int32)
    return q, pool, pool.clone(), table, torch.zeros(B, dtype=torch.int32)


@pytest.mark.parametrize("B,KH,MP,splits,per", [
    (4, 4, 26, 13, 2),      # the serve run's decode: 16 x 13 blocks
    (4, 4, 256, 16, 16),    # 4096 positions a slot: 16 x 16 blocks
    (4, 4, 1, 1, 1),        # one page: one split
    (2, 1, 40, 40, 1),      # few (slot, head) pairs: a page a split
    (64, 8, 26, 1, 26),     # 512 (slot, head) pairs cover the card
    (3, 2, 0, 1, 1),        # an empty table: one split, no live line
])
def test_paged_decode_plan_splits_the_walk(B, KH, MP, splits, per):
    """The page walk of each (slot, KV head) is cut into splits of
    ``pages_per_split`` >= 1 table slots so the grid aims at
    DECODE_BLOCKS_PER_SM blocks per SM (as many splits as that allows);
    every table slot is in exactly one split."""
    plan = pa.paged_decode_plan(B, KH, 4, 128, MP, 2, H100_SMS)
    assert (plan["splits"], plan["pages_per_split"]) == (splits, per)
    assert per >= 1 and splits * per >= MP > (splits - 1) * per or MP == 0
    # the fewest pages a split that keeps the grid within the target: one
    # page fewer would make more splits than it wants
    want = -(-pa.DECODE_BLOCKS_PER_SM * H100_SMS // (B * KH))
    assert splits <= want and (per == 1 or -(-MP // (per - 1)) > want)
    assert plan["scratch_floats"] == B * KH * splits * 4 * (128 + 2)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("G,hd", [(1, 32), (4, 128), (8, 64), (32, 256)])
def test_paged_decode_plan_shared_memory_fits(elem, G, hd):
    """q in f32, DECODE_STAGES[elem] K and V tiles of DECODE_TILE lines in
    the input type, the tile's probabilities and rescale factors: within a
    block's 227 KB at every shape the kernel takes."""
    plan = pa.paged_decode_plan(4, 4, G, hd, 26, elem, H100_SMS)
    ring = pa.DECODE_STAGES[elem] * 2 * pa.DECODE_TILE * hd * elem
    assert plan["smem_bytes"] == (-(-G * hd * 4 // 16) * 16 + ring
                                  + G * pa.DECODE_TILE * 4 + G * 4)
    assert plan["smem_bytes"] <= HOPPER_SMEM == _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [BF, F32])
def test_paged_decode_launch(fake_card, dtype):
    """One wrapper call: one C entry (it launches the split and the combine
    kernels), given the plan's splits, pages per split and shared memory,
    the window and the stream; an f32 scratch of the partials; one count in
    LAUNCHES."""
    B, KH, G, hd, ps, MP = 4, 4, 4, 128, 16, 26
    args = _paged_operands(B, KH, G, hd, ps, MP, dtype)
    out = pa.paged_decode_forward(*args, scale=hd ** -0.5, window=100)
    assert out.shape == (B, KH, G, hd) and out.dtype == dtype
    plan = pa.paged_decode_plan(B, KH, G, hd, MP, args[0].element_size(),
                                H100_SMS)
    (lib, entry, ints), = fake_card
    assert (lib, entry) == ("paged_attention",
                            f"paged_decode_{pa._DTYPES[dtype]}")
    assert ints == (B, KH, G, hd, ps, MP, plan["splits"],
                    plan["pages_per_split"], plan["smem_bytes"], 100, 0)
    assert kernels.launch_counts()["paged_decode"] == 1


@pytest.mark.parametrize("B,KH,G,hd,ps,MP,why", [
    (2, 2, 4, 48, 16, 4, "head_dim"), (2, 2, 4, 288, 16, 4, "head_dim"),
    (2, 2, 4, 64, 256, 4, "page_size"), (2, 2, 64, 64, 16, 4, "G <= 32")])
def test_paged_decode_refuses_shapes_without_kernel(fake_card, B, KH, G, hd,
                                                    ps, MP, why):
    with pytest.raises(ValueError, match=why):
        pa.paged_decode_forward(*_paged_operands(B, KH, G, hd, ps, MP),
                                scale=0.125)
    assert fake_card == [] and kernels.launch_counts()["paged_decode"] == 0


def test_paged_decode_refuses_misaligned_pools(fake_card):
    q, kp, vp, table, q_pos = _paged_operands(2, 2, 4, 64, 16, 4)
    flat = torch.zeros(kp.numel() + 4, dtype=BF)
    shifted = flat[4:].view(kp.shape)                 # 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_decode_forward(q, kp, shifted, table, q_pos, scale=0.125)
    assert fake_card == [] and kernels.launch_counts()["paged_decode"] == 0


def test_gmm_tiled_on_cpu_takes_any_shape():
    """The route rule binds CUDA tensors only: on the CPU the plain
    version runs, whatever K."""
    g = torch.Generator().manual_seed(0)
    lhs = torch.randn((128, 60), generator=g).to(BF)
    w = torch.randn((1, 60, 36), generator=g).to(BF)
    tg = torch.zeros(1, dtype=torch.int32)
    kernels.reset_launch_counts()
    out = gmm.gmm_tiled(lhs, w, tg, block_m=128, out_dtype=F32)
    want = lhs.float() @ w[0].float()
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    assert kernels.launch_counts()["gmm"] == 0


_FLASH_ROUTES = [fa.flash_fwd_route, fa.flash_bwd_route]


@pytest.mark.parametrize("route", _FLASH_ROUTES)
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_route_bf16_takes_tensor_cores(route, hd):
    assert route(BF, hd) == "wgmma"


@pytest.mark.parametrize("route", _FLASH_ROUTES)
@pytest.mark.parametrize("dtype,hd", [(BF, 32), (BF, 96), (BF, 192),
                                      (BF, 256), (F32, 64), (F32, 128),
                                      (F32, 32)])
def test_flash_route_other_inputs_take_fma(route, dtype, hd):
    assert route(dtype, hd) == "fma"


@pytest.mark.parametrize("route", _FLASH_ROUTES)
@pytest.mark.parametrize("dtype,hd,err", [(F16, 128, TypeError),
                                          (BF, 48, ValueError),
                                          (F32, 288, ValueError)])
def test_flash_route_refusals(route, dtype, hd, err):
    with pytest.raises(err):
        route(dtype, hd)


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 64, 65, 256, 1024])
def test_flash_wgmma_plan_fits(hd, S):
    plan = fa.flash_wgmma_plan(hd, S)
    q_rows = plan["q_rows"]
    assert q_rows == (64 if S <= 64 else 128)
    assert plan["stage_bytes"] == 2 * fa.WGMMA_KV_ROWS * hd * 2
    assert plan["smem_bytes"] == (q_rows * hd * 2
                                  + fa.WGMMA_STAGES * plan["stage_bytes"]
                                  + 8 * (1 + 2 * fa.WGMMA_STAGES) + 1024)
    assert plan["smem_bytes"] <= HOPPER_SMEM == _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("hd", [32, 96, 256])
def test_flash_wgmma_plan_refusals(hd):
    with pytest.raises(ValueError):
        fa.flash_wgmma_plan(hd, 256)


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 48, 64, 65, 256, 1024])
def test_flash_bwd_wgmma_plan_fits(hd, S):
    plan = fa.flash_bwd_wgmma_plan(hd, S)
    q_rows, tile = plan["q_rows"], fa.WGMMA_KV_ROWS * hd * 2
    assert q_rows == fa.flash_wgmma_plan(hd, S)["q_rows"]
    assert plan["dq_smem_bytes"] == (2 * q_rows * hd * 2
                                     + fa.WGMMA_STAGES * 2 * tile
                                     + 8 * (1 + 2 * fa.WGMMA_STAGES) + 1024)
    stages = fa.DKV_WARPGROUPS * fa.DKV_STAGES
    assert plan["dkv_smem_bytes"] == (
        2 * tile + stages * (2 * tile + 2 * fa.WGMMA_KV_ROWS * 4)
        + 8 * (1 + stages) + 1024)
    # warpgroup 1 hands its f32 dK and dV to warpgroup 0 through the stages
    assert hd * 128 * 4 <= stages * 2 * tile
    assert max(plan["dq_smem_bytes"], plan["dkv_smem_bytes"]) \
        <= HOPPER_SMEM == _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("hd", [32, 96, 256])
def test_flash_bwd_wgmma_plan_refusals(hd):
    with pytest.raises(ValueError):
        fa.flash_bwd_wgmma_plan(hd, 256)


def _conv_views(T=64, din=5120, ns=128, pad=0, shift=0):
    """x [2, T, din / 64, 64], B and C [2, T, ns] as mamba2's mixer hands
    them to the scan: views into one bf16 conv output [2, T, din + 2 ns +
    pad], starting ``shift`` elements in (mamba2-2.7b: din 5120, ns 128, a
    row stride of 5376 elements; x, B and C at bytes 0, 10240, 10496)."""
    xbc = torch.zeros((2, T, din + 2 * ns + pad + shift), dtype=BF)
    xbc = xbc[..., shift:]
    x = xbc[..., :din].unflatten(-1, (din // 64, 64))
    return x, xbc[..., din:din + ns], xbc[..., din + ns:din + 2 * ns]


def _ssd_route_of(x, B, C, Q=256):
    return ssd.ssd_route(x.dtype, x.shape[-1], B.shape[-1], Q,
                         (*x.stride()[:3], *B.stride()[:2], *C.stride()[:2]),
                         (x.data_ptr(), B.data_ptr(), C.data_ptr()))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("ns", [64, 128])
@pytest.mark.parametrize("Q", [64, 128, 192, 256])
def test_ssd_route_bf16_takes_tensor_cores(hd, ns, Q):
    assert ssd.ssd_route(BF, hd, ns, Q) == "wgmma"
    assert ssd.ssd_route(BF, hd, ns, Q, (2048 * 5376, 5376, hd), (0, 10240,
                                                                   10496)) \
        == "wgmma"


def test_ssd_route_reads_the_conv_output_in_place():
    x, B, C = _conv_views()
    assert x.stride() == (64 * 5376, 5376, 64, 1)
    assert (B.data_ptr() - x.data_ptr(), C.data_ptr() - x.data_ptr()) \
        == (10240, 10496)
    assert _ssd_route_of(x, B, C) == "wgmma"


@pytest.mark.parametrize("pad,shift", [(1, 0), (4, 0), (0, 1), (0, 2),
                                       (0, 4)])
def test_ssd_route_misaligned_operands_take_fma(pad, shift):
    """A row stride that is not a multiple of 8 elements (16 bytes), or a
    base that is not 16-byte aligned, cannot be read by the tensor-core
    kernel's 16-byte copies: the FMA kernel takes the call."""
    x, B, C = _conv_views(pad=pad, shift=shift)
    assert _ssd_route_of(x, B, C) == "fma"
    assert _ssd_route_of(*_conv_views(pad=8 * pad, shift=8 * shift)) \
        == "wgmma"


@pytest.mark.parametrize("dtype,hd,ns,Q", [
    (F32, 64, 128, 256), (F32, 128, 64, 128),   # f32: the FMA kernel
    (BF, 32, 128, 256),                         # head_dim 32
    (BF, 64, 32, 256), (BF, 64, 48, 128),       # other state sizes
    (BF, 64, 112, 256), (BF, 128, 16, 128),
    (BF, 64, 128, 96), (BF, 64, 128, 100),      # chunks off 64 rows
    (BF, 128, 64, 320), (BF, 64, 128, 512),     # chunks above 256 rows
])
def test_ssd_route_other_shapes_take_fma(dtype, hd, ns, Q):
    assert ssd.ssd_route(dtype, hd, ns, Q) == "fma"


@pytest.mark.parametrize("dtype,hd,ns,err", [
    (F16, 64, 128, TypeError), (torch.float64, 64, 64, TypeError),
    (BF, 48, 128, ValueError), (BF, 256, 128, ValueError),
    (BF, 64, 8, ValueError), (BF, 64, 144, ValueError),
    (F32, 64, 0, ValueError), (F32, 96, 64, ValueError),
])
def test_ssd_route_refusals(dtype, hd, ns, err):
    """What no kernel takes raises as ``ssd_scan`` does on a CUDA tensor."""
    with pytest.raises(err):
        ssd.ssd_route(dtype, hd, ns, 256)


@pytest.mark.parametrize("hd", ssd.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("ns", ssd.WGMMA_STATES)
@pytest.mark.parametrize("Q", [64, 128, 192, 256])
def test_ssd_wgmma_plan_fits(hd, ns, Q):
    plan = ssd.ssd_wgmma_plan(hd, ns, Q)
    tile = 64 * 128                       # 64 rows of 64 bf16 columns
    wide = ns // 64 * tile                # a [64, ns] bf16 tile
    scan = 256 * 8 + 256 * 4 + 4 * 8      # cum (f64), dt or w, warp totals
    # three planes of x ⊙ dt·w and B, a 64-row slice of each
    assert plan["states_smem"] == 3 * tile + wide + scan + 1024
    # four chunk-state blocks share an SM
    assert 4 * (plan["states_smem"] + 1024) <= 228 * 1024
    # C_i, three [64, 64] planes (the second j-tile buffer after the inter
    # term: B_j and x_j fit there) and the first j-tile buffer
    assert plan["out_smem"] == 2 * wide + 4 * tile + scan + 1024
    assert wide + tile <= 3 * tile
    assert max(plan["states_smem"], plan["out_smem"]) \
        <= HOPPER_SMEM == _build.SMEM_PER_BLOCK
    # three chunk-output blocks share an SM (228 KB, 1 KB reserved a block)
    assert 3 * (plan["out_smem"] + 1024) <= 228 * 1024
    assert plan["passes"] == 3


@pytest.mark.parametrize("hd,ns,Q", [(32, 128, 256), (64, 96, 256),
                                     (64, 128, 100), (64, 128, 320),
                                     (128, 64, 0)])
def test_ssd_wgmma_plan_refusals(hd, ns, Q):
    with pytest.raises(ValueError):
        ssd.ssd_wgmma_plan(hd, ns, Q)


def test_ssd_scan_on_cpu_takes_any_layout():
    """The route binds CUDA tensors only: on the CPU the plain version runs
    on misaligned views too, and no kernel launch is counted."""
    g = torch.Generator().manual_seed(0)
    x, B, C = _conv_views(T=40, din=128, ns=64, shift=1)
    for t in (x, B, C):
        t.copy_(0.25 * torch.randn(t.shape, generator=g))
    dt = torch.rand((2, 40, 2), generator=g)
    A = -torch.ones(2)
    kernels.reset_launch_counts()
    y, state = ssd.ssd_scan(x, dt, A, B, C, chunk=256)
    y_p, state_p = ssd.ssd_scan_plain(x.contiguous(), dt, A, B.contiguous(),
                                      C.contiguous(), chunk=256)
    assert torch.equal(y, y_p) and torch.equal(state, state_p)
    assert kernels.launch_counts()["ssd"] == 0
    assert kernels.design_launch_counts()["ssd:fma"] == 0
