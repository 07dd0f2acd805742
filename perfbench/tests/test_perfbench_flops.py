"""The yardstick's operation and byte counts against hand counts at a
tiny configuration."""

import dataclasses

from perfbench import flops
from perfbench.model import MoESpec

M = MoESpec(name="t", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1,
            head_dim=4, d_ff=16, n_experts=4, top_k=2, vocab=10,
            rope_theta=1e4, norm_eps=1e-6, router_aux_coef=0.01,
            router_z_coef=1e-3, lm_z_coef=1e-4, capacity_factor=1.25)


def test_active_params():
    # wq 8x8 + wo 8x8 + wk, wv 8x4 each + router 8x4 + 2 experts x 3 x 8x16
    per_layer = 64 + 64 + 32 + 32 + 32 + 2 * 3 * 128
    assert flops.active_params(M) == 2 * per_layer + 10 * 8


def test_model_flops():
    B, S = 3, 5
    n = flops.active_params(M)
    # causal attention: q k^T and p v, each 2 B H S^2 hd / 2, x3
    attn = 2 * 3 * (2 * (2 * B * 2 * S * S * 4) / 2)
    assert flops.model_flops(M, B, S) == 6 * n * B * S + attn


def test_expert_gemm_work():
    f, b = flops.expert_gemm_work(M, 6)
    assert f == 2 * 6 * 9 * 2 * 8 * 16
    w = 3 * 4 * 8 * 16
    assert b == 2 * (2 * w * 2 + w * 4 + 6 * 8 * 12)


def test_flash_work():
    B, S = 3, 5
    f, b = flops.flash_work(M, B, S)
    assert f == 2 * 6 * 2 * B * 2 * S * S * 4 / 2
    assert b == 2 * (B * S * 4 * 2 * (4 * 2 + 4 * 1) + B * 2 * S * 4)


def test_least_seconds_takes_the_larger_bound():
    assert flops.least_seconds(989e12, 0) == 1.0
    assert flops.least_seconds(0, 3.35e12) == 1.0
    assert flops.least_seconds(989e12, 6.7e12) == 2.0
    assert dataclasses.asdict(M)["top_k"] == 2
