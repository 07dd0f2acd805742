"""The frozen reference against the port's CPU path at a small size: with
the port's products in f32, its first three steps (losses, every leaf's
first clipped gradient and its change after the steps) are the
reference's to rounding, zebra (capacity drops per microbatch) and
dropless both; and the reference's attention backward is autograd's."""

import functools

import pytest
import torch

from perfbench import check
from perfbench import reference as ref
from perfbench.drivers import train as D
from tiny import tiny_cell


@pytest.fixture
def f32_port(monkeypatch):
    import repro_torch.models.modules as modules
    monkeypatch.setattr(modules, "Policy", functools.partial(
        modules.Policy, compute_dtype=torch.float32))
    torch.set_num_threads(1)


@pytest.mark.parametrize("cell", ["w1.zebra.4k", "w1.dropless.4k"])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_reference_is_the_port_in_f32(f32_port, cell, seed):
    s = D.setup(tiny_cell(cell), seed, "cpu")
    side, _ = D.check_steps(s, s.program.train_step)
    gaps = check.gaps(side, D.reference_readings(s))
    assert gaps["loss_gap"][0] < 1e-6
    assert gaps["grad_gap"][0] < 1e-5
    assert gaps["update_gap"][0] < 1e-4


def test_zebra_drops_copies():
    s = D.setup(tiny_cell("w1.zebra.4k"), 3, "cpu")
    u = torch.randn(64, s.m.d_model)
    router = torch.zeros(s.m.d_model, s.m.n_experts)
    router[:, 0] = 1.0  # every token prefers expert 0 ...
    wg = torch.randn(s.m.n_experts, s.m.d_model, s.m.d_ff)
    y_cap, *_ = ref.moe(u, router, wg, wg, wg.transpose(1, 2), s.m, True,
                        ref.EXACT)
    y_all, *_ = ref.moe(u, router, wg, wg, wg.transpose(1, 2), s.m, False,
                        ref.EXACT)
    C = ref.capacity(64, s.m)
    assert C < 64
    assert not torch.allclose(y_cap, y_all)


def test_attention_backward_is_autograds():
    torch.manual_seed(0)
    B, S, H, KH, hd = 2, 37, 4, 2, 8
    q = torch.randn(B, S, H, hd, dtype=torch.float64, requires_grad=True)
    k = torch.randn(B, S, KH, hd, dtype=torch.float64, requires_grad=True)
    v = torch.randn(B, S, KH, hd, dtype=torch.float64, requires_grad=True)
    out = ref._CausalAttention.apply(q, k, v, hd ** -0.5, 16, ref.EXACT)
    kk = k.repeat_interleave(H // KH, dim=2)
    vv = v.repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, kk) * hd ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).triu(1)
    p = torch.softmax(s.masked_fill(mask, -torch.inf), -1)
    plain = torch.einsum("bhst,bthd->bshd", p, vv)
    assert torch.allclose(out, plain, atol=1e-12)
    g = torch.randn_like(out)
    a = torch.autograd.grad(out, (q, k, v), g)
    b = torch.autograd.grad(plain, (q, k, v), g)
    for x, y in zip(a, b):
        assert torch.allclose(x, y, atol=1e-10)
