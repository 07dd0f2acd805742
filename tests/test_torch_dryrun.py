"""The port's dry run (``repro_torch/launch/dryrun.py``,
``launch/hlo_analysis.py``) against the JAX package's
(``repro/launch/dryrun.py``, ``repro/launch/hlo_analysis.py``) on the CPU:
``model_flops`` and the roofline row equal JAX's; rank 0's param and
optimizer bytes on fake ranks at 2x4 equal JAX's shard shapes on
``mesh8``; the FLOP count of a smoke cell equals its derivation from the
config; the kernels take their fake routes and never build."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from repro.core.zebra_spmd import ZebraConfig as JZebraConfig
from repro.launch import hlo_analysis as j_hlo
from repro.models import registry as j_registry
from repro.models.config import SHAPES as J_SHAPES
from repro.models.modules import Policy as JPolicy, RunConfig as JRunConfig
from repro.train import optimizer as j_opt
from repro.train.step import make_train_program as j_make_train_program
from repro_torch import kernels
from repro_torch.core import hardware as HW
from repro_torch.kernels import _build, gmm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.models import registry
from repro_torch.models.config import SHAPES, ShapeConfig


def _jax_dryrun():
    """The JAX package's dry-run module. Importing it sets XLA_FLAGS to 512
    host devices (its own process's setting); the flag is put back at once,
    so this test process keeps conftest's 8."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as j_dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return j_dryrun


J_DRYRUN = _jax_dryrun()
SHAPE_T = ShapeConfig("t", "train", 32, 8)


def smoke(arch):
    return registry.smoke_config(registry.get_config(arch))


# ---------------------------------------------------------------------------
# model_flops, Roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", registry.names())
def test_model_flops_match_jax(arch, shape):
    assert dryrun.model_flops(registry.get_config(arch), SHAPES[shape]) == \
        J_DRYRUN.model_flops(j_registry.get_config(arch), J_SHAPES[shape])


ROOFLINE_CASES = [
    (3.1e14, 2.2e12, 7.5e10, 256, 2.1e16),   # collective-bound
    (1.9e15, 4.0e11, 1.0e9, 512, 1.1e18),    # compute-bound
    (1.0e11, 9.4e10, 4.3e8, 256, 8.2e11),    # memory-bound
    (0.0, 0.0, 0.0, 1, 0.0),
]


@pytest.mark.parametrize("case", ROOFLINE_CASES)
@pytest.mark.parametrize("link", [HW.H100_NET_BW, HW.H100_NVLINK_BW])
def test_roofline_row_matches_jax(case, link):
    f, b, c, n, mf = case
    got = hlo_analysis.Roofline(f, b, c, n, mf, link_bw=link).row()
    want = j_hlo.Roofline(f, b, c, n, mf, peak_flops=HW.H100_PEAK_FLOPS,
                          hbm_bw=HW.H100_HBM_BW, ici_bw=link,
                          ici_links=1).row()
    assert got == want
    assert hlo_analysis.Roofline(f, b, c, n, mf).peak_flops == 989e12


def test_collective_bytes_buckets():
    counts = {"all_gather": {"calls": 2, "bytes": 64, "operand_bytes": 16,
                             "ring_bytes": 48},
              "all_to_all_single": {"calls": 1, "bytes": 8,
                                    "operand_bytes": 8, "ring_bytes": 4},
              "isend": {"calls": 1, "bytes": 8, "operand_bytes": 8,
                        "ring_bytes": 8}}
    out = hlo_analysis.collective_bytes(counts)
    assert out == {"all-gather": 16, "all-reduce": 0, "reduce-scatter": 0,
                   "all-to-all": 8, "collective-permute": 8, "total": 32,
                   "ring_total": 60}


def test_slowest_link():
    from repro_torch.sharding.rules import MeshShape
    assert hlo_analysis.slowest_link(MeshShape((2, 4), ("data", "model"))) \
        == HW.H100_NVLINK_BW
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model")),
                        ((1, 16), ("data", "model"))):
        assert hlo_analysis.slowest_link(MeshShape(shape, axes)) == \
            HW.H100_NET_BW


# ---------------------------------------------------------------------------
# Argument bytes against JAX's shard shapes
# ---------------------------------------------------------------------------

def _shard_bytes(shapes, shardings) -> int:
    leaves = jax.tree.leaves(shapes)
    shs = jax.tree.leaves(shardings)
    assert len(leaves) == len(shs)
    total = 0
    for leaf, sh in zip(leaves, shs):
        n = 1
        for d in sh.shard_shape(leaf.shape):
            n *= d
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ["mixtral-d2", "llama3.2-3b"])
def test_rank0_argument_bytes_match_jax_shards(mesh8, arch):
    rec = dryrun.lower_cell(arch, SHAPE_T, multi_pod=False,
                            mesh_shape=(2, 4), cfg=smoke(arch))
    cfg = j_registry.smoke_config(j_registry.get_config(arch))
    run = JRunConfig(policy=JPolicy(param_dtype=jnp.float32),
                     attn_impl="chunked", moe_impl="gather", remat="full")
    z = JZebraConfig(mode="alltoall", num_microbatches=4,
                     capacity_factor=1.25) if cfg.is_moe else None
    program = j_make_train_program(cfg, mesh8, run, SHAPE_T, zcfg=z)
    oshapes = jax.eval_shape(
        functools.partial(j_opt.init_opt_state,
                          master_weights=program.master_weights),
        program.param_shapes)
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    assert rec["param_bytes_per_device"] == _shard_bytes(
        program.param_shapes, program.param_shardings)
    assert rec["opt_bytes_per_device"] == _shard_bytes(
        oshapes, program.opt_shardings)
    assert rec["arg_bytes_per_device"] == rec["param_bytes_per_device"] \
        + rec["opt_bytes_per_device"] + 2 * 8 * 32 * 4  # + the int32 batch
    assert rec["collective_bytes_per_device"] > 0  # a sharded step talks


def test_no_rank_holds_more_than_rank0():
    """Zebra replicated ("hybrid" rules) at 1x4 with 6 q heads over 2 kv
    heads: attention splits in ceil-blocks of 2 q heads (2, 2, 2, 0), so
    the ranks differ in compute; none holds more than rank 0."""
    cfg = dataclasses.replace(smoke("mixtral-d2"), n_heads=6)
    recs = [dryrun.lower_cell("mixtral-d2", SHAPE_T, multi_pod=False,
                              mesh_shape=(1, 4), rank=r, cfg=cfg,
                              zebra_mode="replicated", microbatches=2)
            for r in range(4)]
    held = [r["param_bytes_per_device"] + r["opt_bytes_per_device"]
            for r in recs]
    assert all(h <= held[0] for h in held)
    assert all(r["arg_bytes_per_device"] <= recs[0]["arg_bytes_per_device"]
               for r in recs)
    assert recs[3]["flops_per_device"] < recs[0]["flops_per_device"]


# ---------------------------------------------------------------------------
# FLOPs, derived
# ---------------------------------------------------------------------------

def test_flops_match_derivation():
    """Smoke llama3.2-3b at 1x1, 8 x 32, remat "full", one chunk of the
    chunked attention (chunk_q 512 >= 32) and of the chunked cross
    entropy. A product of [m, k] by [k, n] counts 2·m·k·n. Forward of a
    layer (M = B·S tokens): q, o 2·M·d·H·hd each, k, v 2·M·d·KH·hd each,
    the scores and the value product 2·B·H·S·S·hd each, gate, up and down
    2·M·d·ff each; the tied head 2·M·d·V. The step runs each layer's
    forward, recomputes it in the backward up to its last product (down,
    whose output no backward reads: the non-reentrant checkpoint stops
    there), recomputes the attention chunk's scores once more for its
    softmax backward (the chunk's own checkpoint), and takes two products
    for each product's backward (the gradients of both operands); the
    head runs forward, its chunk's recompute and two backward products."""
    cfg = smoke("llama3.2-3b")
    B, S = 8, 32
    M, d, ff, V = B * S, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert cfg.tie_embeddings and cfg.n_layers == 2
    proj = 2 * (2 * M * d * H * hd) + 2 * (2 * M * d * KH * hd)
    scores = 2 * B * H * S * S * hd
    down = 2 * M * ff * d
    mlp = 2 * (2 * M * d * ff) + down
    layer = proj + 2 * scores + mlp
    head = 2 * M * d * V
    want = cfg.n_layers * (4 * layer - down + scores) + 4 * head
    rec = dryrun.lower_cell("llama3.2-3b", SHAPE_T, multi_pod=False,
                            mesh_shape=(1, 1), cfg=cfg)
    assert rec["flops_per_device"] == want == 675_282_944
    assert rec["kernel_flops_per_device"] == 0
    assert rec["collective_calls"] == {}
    assert rec["temp_bytes_per_device"] > 0 and rec["fits_80gb"]


# ---------------------------------------------------------------------------
# The kernels' fake routes
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    """Any kernel build or library load raises."""
    def refuse(*a, **k):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)


def test_moe_cell_takes_the_fake_routes(no_build):
    cfg = smoke("mixtral-d2")
    rec = dryrun.lower_cell("mixtral-d2", SHAPE_T, multi_pod=False,
                            mesh_shape=(2, 4), cfg=cfg)
    d, f = cfg.d_model, cfg.d_ff_expert or cfg.d_ff
    bf, f32 = torch.bfloat16, torch.float32
    bm = 8
    want = {
        "gmm_glu": gmm.gmm_glu_route(bf, d, f, f, 0, bm),
        "gmm": {gmm.gmm_route(bf, bf, bf, False, f, d, bm),
                gmm.gmm_route(f32, bf, f32, True, d, f, bm),
                gmm.gmm_route(f32, bf, f32, False, f, d, bm),
                gmm.gmm_route(bf, bf, f32, False, d, f, bm)},
        "gmm_dw": {gmm.gmm_dw_route(bf, f32, d, f, bm),
                   gmm.gmm_dw_route(f32, f32, f, d, bm)}}
    assert want["gmm_glu"] == "wgmma" and want["gmm"] == {"wgmma"} \
        and want["gmm_dw"] == {"wgmma"}
    by_kernel, by_design = rec["launches"]["by_kernel"], \
        rec["launches"]["by_design"]
    assert by_kernel == {"gmm_glu": 4, "gmm": 14, "gmm_dw": 6}
    assert by_design == {f"{k}:wgmma": n for k, n in by_kernel.items()}
    work = rec["kernel_work"]
    assert {k: w["calls"] for k, w in work.items()} == by_kernel
    assert rec["kernel_flops_per_device"] == sum(
        w["flops"] for w in work.values()) > 0


def test_wrappers_on_fake_cuda_tensors(no_build):
    """On fake tensors naming the card, every wrapper takes the card's
    route (``_build.on_cpu`` is not asked) and records one call by design
    and the kernel's math in ``_build.FAKE_WORK``, with no build, no
    pointer and no launch count."""
    kernels.reset_launch_counts()
    _build.reset_fake_work()
    dev = "cuda"
    with FakeTensorMode():
        bf = dict(dtype=torch.bfloat16, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        Mp, K, N, G, bm = 64, 128, 256, 4, 16
        lhs, w = torch.empty(Mp, K, **bf), torch.empty(G, K, N, **bf)
        tg = torch.empty(Mp // bm, dtype=torch.int32, device=dev)
        out = gmm.gmm_tiled(lhs, w, tg, block_m=bm)
        assert is_fake(out) and out.shape == (Mp, N) and out.is_cuda
        wt = torch.empty(G, N, K, **bf).transpose(1, 2)
        gmm.gmm_tiled(torch.empty(Mp, K, **f32), wt, tg, block_m=bm,
                      out_dtype=torch.float32)
        gmm.gmm_glu_tiled_pair(lhs, w, w.clone(), tg, block_m=bm)
        gmm.gmm_glu_tiled(lhs, torch.empty(G, K, 2 * N, **bf), tg,
                          block_m=bm)
        dw = gmm.gmm_dw_tiled(lhs, torch.empty(Mp, N, **f32), tg, G,
                              block_m=bm)
        assert dw.shape == (G, K, N) and dw.dtype == torch.float32
        q = torch.empty(2, 4, 128, 64, **bf)
        kv = torch.empty(2, 2, 128, 64, **bf)
        o, lse = fa.flash_forward(q, kv, kv, scale=0.125, causal=True)
        fa.flash_backward(q, kv, kv, o, lse, o, scale=0.125, causal=True)
        x = torch.empty(2, 256, 4, 64, **bf)
        y, st = ssd.ssd_scan(x, torch.empty(2, 256, 4, **f32),
                             torch.empty(4, **f32),
                             torch.empty(2, 256, 64, **bf),
                             torch.empty(2, 256, 64, **bf), chunk=128)
        assert y.shape == x.shape and st.shape == (2, 4, 64, 64)
        pa.paged_decode_forward(
            torch.empty(2, 2, 2, 64, **bf), torch.empty(8, 16, 2, 64, **bf),
            torch.empty(8, 16, 2, 64, **bf),
            torch.empty(2, 4, dtype=torch.int32, device=dev),
            torch.empty(2, dtype=torch.int32, device=dev), scale=0.125)
    calls = _build.fake_calls()
    assert calls["by_kernel"] == {
        "gmm": 2, "gmm_glu": 2, "gmm_dw": 1, "flash_fwd": 1, "flash_dq": 1,
        "flash_dkv": 1, "ssd": 1, "paged_decode": 1}
    assert calls["by_design"] == {
        "gmm:wgmma": 2, "gmm_glu:wgmma": 2, "gmm_dw:wgmma": 1,
        "flash_fwd:wgmma": 1, "flash_dq:wgmma": 1, "flash_dkv:wgmma": 1,
        "ssd:wgmma": 1}
    assert not any(kernels.launch_counts().values())
    assert not any(kernels.design_launch_counts().values())
    assert not any(gmm.VARIANT_LAUNCHES.values())
    work = _build.FAKE_WORK
    assert work["gmm"]["flops"] == 2 * (2 * Mp * K * N)
    assert work["gmm_glu"]["flops"] == 2 * (4 * Mp * K * N)
    assert work["gmm_dw"]["flops"] == 2 * Mp * K * N
    pairs = 128 * 129 // 2
    assert work["flash_fwd"]["flops"] == 4 * 2 * 4 * 64 * pairs
    assert work["flash_dq"]["flops"] == 6 * 2 * 4 * 64 * pairs
    assert work["flash_dkv"]["flops"] == 8 * 2 * 4 * 64 * pairs
    assert work["ssd"]["flops"] == ssd.ssd_flops(2, 256, 4, 64, 64, 128)
    assert work["gmm"]["bytes"] == 2 * Mp * K + 2 * G * K * N + 4 * Mp // bm \
        + 2 * Mp * N + (4 * Mp * K + 2 * G * K * N + 4 * Mp // bm
                        + 4 * Mp * N)
    kernels.reset_launch_counts()
    _build.reset_fake_work()


def test_fake_route_checks_alignment():
    """The card's checks hold on fake tensors: a bf16 gmm at K off a
    multiple of 8 raises, and so does a misaligned view (the storage
    offset stands for the address)."""
    with FakeTensorMode():
        tg = torch.empty(4, dtype=torch.int32)
        w = torch.empty(2, 12, 16, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="K % 8"):
            gmm.gmm_tiled(torch.empty(32, 12, dtype=torch.bfloat16), w, tg,
                          block_m=8)
        big = torch.empty(32 * 16 + 1, dtype=torch.bfloat16)
        lhs = big[1:].view(32, 16)
        with pytest.raises(ValueError, match="16-byte aligned"):
            gmm.gmm_tiled(lhs, torch.empty(2, 16, 16, dtype=torch.bfloat16),
                          tg, block_m=8)
