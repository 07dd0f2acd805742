"""repro_torch training parts against the JAX package: AdamW and its
schedule, the chunked cross entropy, chunked attention, the data
pipeline, and the refusals of what is not ported.

Inputs are numpy arrays from a seed handed to both packages; f32
throughout. Tolerances: 1e-6 relative for the optimizer (the same
elementwise arithmetic in the same order), 1e-5 for sums (other order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import MemmapSource as JMemmapSource
from repro.models import modules as jmodules
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro_torch.core.zebra_spmd import ZebraConfig
from repro_torch.data import (DataConfig, DataLoader, MemmapSource,
                              SyntheticSource, write_token_bin)
from repro_torch.models import modules
from repro_torch.models import registry
from repro_torch.models.config import ShapeConfig
from repro_torch.train import loss, optimizer as opt
from repro_torch.train.step import make_train_program
from torch_parity import to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 7, 10, 11, 55, 100, 130])
def test_lr_schedule_matches_jax(step):
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100,
              end_lr_frac=0.1)
    got = float(opt.lr_schedule(opt.OptimizerConfig(**kw), step))
    want = float(jopt.lr_schedule(jopt.OptimizerConfig(**kw), step))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("clip,master", [(1.0, False), (0.0, False),
                                         (1e9, True)])
def test_adamw_matches_jax_over_three_steps(clip, master):
    rng = np.random.RandomState(0)
    p_np = {"a": {"w": rng.randn(3, 4, 5).astype(np.float32)},
            "scale": rng.randn(6).astype(np.float32)}
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=4, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, p_np)
    jst = jopt.init_opt_state(jp, master_weights=master)
    tp = {"a": {"w": torch.from_numpy(p_np["a"]["w"].copy())},
          "scale": torch.from_numpy(p_np["scale"].copy())}
    tst = opt.init_opt_state(tp, master_weights=master)
    for step in range(3):
        g_np = {"a": {"w": (rng.randn(3, 4, 5) * (step + 1)).astype(
                    np.float32)},
                "scale": rng.randn(6).astype(np.float32)}
        jp, jst, jm = jopt.adamw_update(jopt.OptimizerConfig(**kw), jp,
                                        jax.tree.map(jnp.asarray, g_np), jst)
        grads = {"a/w": torch.from_numpy(g_np["a"]["w"]),
                 "scale": torch.from_numpy(g_np["scale"])}
        out, tst, tm = opt.adamw_update(opt.OptimizerConfig(**kw), tp, grads,
                                        tst)
        assert out is tp  # in place
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        np.testing.assert_allclose(to_np(tp["a"]["w"]), jp["a"]["w"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(to_np(tp["scale"]), jp["scale"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(to_np(tst["mu"]["a/w"]),
                                   jst["mu"]["a"]["w"], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(to_np(tst["nu"]["scale"]),
                                   jst["nu"]["scale"], rtol=1e-6, atol=1e-8)
    assert int(tst["step"]) == int(jst["step"]) == 3
    assert ("master" in tst) == master


def test_chunked_xent_matches_jax_values_and_grads():
    rng = np.random.RandomState(1)
    B, S, d, V = 2, 50, 16, 37
    h = rng.randn(B, S, d).astype(np.float32)
    table = rng.randn(V, d).astype(np.float32)
    t = rng.randint(0, V, (B, S)).astype(np.int32)

    def jf(h, table):
        return jloss.chunked_xent_from_hidden(h, table, jnp.asarray(t),
                                              chunk=16)[0]
    want = float(jf(jnp.asarray(h), jnp.asarray(table)))
    wg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    got, m = loss.chunked_xent_from_hidden(th, tt, torch.from_numpy(t),
                                           chunk=16)
    got.backward()
    assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(to_np(th.grad), np.asarray(wg[0]), **TOL)
    np.testing.assert_allclose(to_np(tt.grad), np.asarray(wg[1]), **TOL)
    full, fm = loss.cross_entropy(th.detach() @ tt.detach().T,
                                  torch.from_numpy(t))
    assert float(full) == pytest.approx(float(got.detach()), rel=1e-6)
    nll = float(m["nll"].detach())
    assert float(fm["nll"]) == pytest.approx(nll, rel=1e-6)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 0.0), (0, 5.0)])
def test_chunked_attention_matches_jax_and_reference(window, softcap):
    rng = np.random.RandomState(2)
    B, S, H, KH, hd = 2, 50, 4, 2, 8
    q, k, v = (rng.randn(B, S, n, hd).astype(np.float32)
               for n in (H, KH, KH))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(causal=True, window=window, scale=hd ** -0.5, softcap=softcap)

    def jf(q, k, v):
        return jmodules.chunked_attention(
            q, k, v, jnp.asarray(pos), jnp.asarray(pos),
            policy=jmodules.Policy(compute_dtype=jnp.float32), chunk_q=16,
            **kw)
    ct = rng.randn(B, S, H, hd).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(jf, jq, jk, jv)
    wgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v))
    pol = modules.Policy(compute_dtype=torch.float32)
    tpos = torch.from_numpy(pos)
    got = modules.chunked_attention(tq, tk, tv, tpos, tpos, policy=pol,
                                    chunk_q=16, **kw)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    for t, w in zip((tq, tk, tv), wgrads):
        np.testing.assert_allclose(to_np(t.grad), np.asarray(w), **TOL)
    mask = modules.attention_mask(tpos, tpos, causal=True, window=window)
    ref = modules.ref_attention(tq, tk, tv, mask, hd ** -0.5, softcap, pol)
    np.testing.assert_allclose(to_np(got), to_np(ref), **TOL)


def test_memmap_source_matches_jax_and_synthetic_is_deterministic(tmp_path):
    path = write_token_bin(str(tmp_path / "t.bin"), 1000, 300, seed=5)
    for step in (0, 3, 11):  # 11 wraps around the file
        got = MemmapSource(DataConfig(vocab_size=250, seq_len=16,
                                      global_batch=6, path=path),
                           host_index=1, host_count=2).batch_at(step)
        want = JMemmapSource(JDataConfig(vocab_size=250, seq_len=16,
                                         global_batch=6, path=path),
                             host_index=1, host_count=2).batch_at(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=4, seed=9)
    a, b = SyntheticSource(cfg).batch_at(2), SyntheticSource(cfg).batch_at(2)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert int(a["tokens"].max()) < 50 and int(a["tokens"].min()) >= 0
    assert not torch.equal(a["tokens"], SyntheticSource(cfg).batch_at(3)
                           ["tokens"])
    loader = DataLoader(cfg, start_step=2)
    assert torch.equal(next(loader)["tokens"], a["tokens"])
    assert loader.state_dict() == {"step": 3}


def test_unported_training_settings_raise():
    # attn_impl="flash" is ported: it constructs; remat="dots" still raises
    assert modules.RunConfig(attn_impl="flash").attn_impl == "flash"
    with pytest.raises(NotImplementedError, match="dots"):
        modules.RunConfig(remat="dots")
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    shape = ShapeConfig("t", "train", 32, 4)
    for kw in (dict(accum_steps=2), dict(mesh=object()),
               dict(constrain_grads=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            make_train_program(cfg, modules.RunConfig(), shape, device="cpu",
                               **kw)
    # zebra is ported: the program takes a ZebraConfig, fitted to the batch
    # (R 3 does not divide the batch of 4: lowered to 2)
    prog = make_train_program(cfg, modules.RunConfig(), shape, device="cpu",
                              zcfg=ZebraConfig(num_microbatches=3))
    assert prog.zcfg.num_microbatches == 2


def test_profile_streams_report_counts_overlap():
    """``launch/profile_train.streams_report``: per stream the union of its
    kernels' intervals, and the time two or more streams run at once (the
    zebra overlap), from the profiler's per-kernel stream ids."""
    from types import SimpleNamespace

    from repro_torch.launch import profile_train

    def kernel(stream, a, b, name="gmm_glu_wgmma_kernel"):
        return SimpleNamespace(
            device_type=torch.autograd.DeviceType.CUDA, name=name,
            device_resource_id=stream,
            time_range=SimpleNamespace(start=a, end=b))

    host = SimpleNamespace(device_type=torch.autograd.DeviceType.CPU,
                           name="gradient", device_resource_id=0,
                           time_range=SimpleNamespace(start=0, end=100))
    prof = SimpleNamespace(events=lambda: [
        host, kernel(7, 0, 10), kernel(7, 5, 20, "elementwise_kernel"),
        kernel(7, 30, 40), kernel(13, 15, 35), kernel(13, 50, 60),
        kernel(7, 60, 70)])
    rep = profile_train.streams_report(prof)
    assert rep["streams"]["7"]["busy_ms"] == pytest.approx(0.040)
    assert rep["streams"]["7"]["kernels"] == 4
    assert rep["streams"]["13"]["busy_ms"] == pytest.approx(0.030)
    # [15, 20] and [30, 35] overlap; [60, 60] only touches
    assert rep["overlap_ms"] == pytest.approx(0.010)
