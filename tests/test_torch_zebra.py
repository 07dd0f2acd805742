"""repro_torch zebra SPMD engine against the JAX package, at one EP rank
(the layer override: ``test_torch_zebra_override.py``; two ranks:
``test_torch_zebra_ranks.py``).

* ``_pack`` / ``_unpack``: the [E, C, d] buffer, the index maps (token,
  slot, keep, order) exactly and the weighted combine to 1e-6, at capacity
  factors 0.5, 1.25 and 99 (heavy drops, some, none).
* ``make_ep_moe`` in both modes (alltoall also with two dispatch chunks
  and one offloaded expert, and with two dispatch chunks combined in two
  sub-chunks instead of the default four) against the JAX package's on a 1x1 mesh: the
  output, the aux losses and the gradients of x and of every FFN param,
  at capacity 1.25 (inputs skewed so some experts overflow: drops) and
  99 (none).

The width is ``smoke_config(mixtral-w1)``'s (d 128, 8 experts top-2, d_ff
256); the JAX package runs under the f32 policy with
``use_gmm_kernel=True`` (its Pallas kernels in interpret mode), the port
its kernels' plain versions (the JAX side jitted). Tolerance: the f32
tier, 1e-5 relative, and 1e-5 absolute scaled by the array's largest
magnitude where it exceeds 1 (a router gradient sums 64 tokens' terms of
size ~10 that cancel: f32 sums in another order differ by ~1e-6 of the
largest term).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zebra_spmd as jz
from repro.launch.mesh import make_mesh
from repro.models import registry as jregistry
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRunConfig
from repro_torch.core import zebra_spmd as zs
from repro_torch.kernels import ops
from repro_torch.models import modules, registry
from repro_torch.models.modules import Policy, RunConfig
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)



def close(got, want, name=""):
    """The f32 tier: rtol 1e-5, atol 1e-5 * max(1, max|want|)."""
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=atol,
                               err_msg=name)


JCFG = jregistry.smoke_config(jregistry.get_config("mixtral-w1"))
CFG = registry.smoke_config(registry.get_config("mixtral-w1"))
JRUN = JRunConfig(policy=JPolicy(compute_dtype=jnp.float32),
                  attn_impl="chunked", moe_impl="gather", chunk_q=8,
                  use_gmm_kernel=True)
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32),
                attn_impl="chunked", moe_impl="gather", chunk_q=8)
AUX_CT = {"moe_aux_loss": 3.0, "moe_z_loss": -2.0}
MODES = {"replicated": dict(mode="replicated"),
         "alltoall": dict(mode="alltoall"),
         "alltoall_q2_off1": dict(mode="alltoall", n_chunks=2,
                                  offload_experts=1),
         "alltoall_q2_qc2": dict(mode="alltoall", n_chunks=2,
                                 n_chunks_combine=2)}


def combine_chunks(zcfg):
    """Qc: ``n_chunks_combine``, or by default 2Q when Q > 1, else 1."""
    Q = max(zcfg.n_chunks, 1)
    return zcfg.n_chunks_combine or (2 * Q if Q > 1 else 1)


def test_configs_agree():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert [f.name for f in dataclasses.fields(zs.ZebraConfig)] == \
        [f.name for f in dataclasses.fields(jz.ZebraConfig)]
    assert dataclasses.asdict(zs.ZebraConfig()) == \
        dataclasses.asdict(jz.ZebraConfig())


def _routing(T, E, k, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, E) + np.linspace(0.0, 1.5, E)  # skewed load
    idx = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    w = rng.rand(T, k).astype(np.float32)
    return idx, w / w.sum(1, keepdims=True)


@pytest.mark.parametrize("cf", [0.5, 1.25, 99.0])
def test_pack_unpack_match_jax(cf):
    T, E, k, d = 64, 8, 2, 16
    rng = np.random.RandomState(1)
    x = rng.randn(T, d).astype(np.float32)
    idx, w = _routing(T, E, k, seed=2)
    C = max(jz._round_up(int(T * k / E * cf), 8), 8)
    jbuf, jmeta = jz._pack(jnp.asarray(x), jnp.asarray(idx), E, C)
    buf, meta = zs._pack(torch.from_numpy(x), torch.from_numpy(idx), E, C)
    np.testing.assert_array_equal(to_np(buf), np.asarray(jbuf))
    for name, a, b in zip(("tok", "slot", "keep", "order"), meta, jmeta):
        np.testing.assert_array_equal(to_np(a), np.asarray(b), err_msg=name)
    kept = int(np.asarray(jmeta[2]).sum())
    assert (kept < T * k) == (cf < 99.0)
    out = rng.randn(E, C, d).astype(np.float32)
    want = jz._unpack(jnp.asarray(out), jmeta, jnp.asarray(w), T)
    got = zs._unpack(torch.from_numpy(out), meta, torch.from_numpy(w), T)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def ffn_arrays(cfg, seed=0):
    """One MoE layer's FFN params (numpy): router [d, E], experts."""
    rng = np.random.RandomState(seed)
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts

    def arr(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"router": arr(d, E, scale=2.0 / np.sqrt(d)),
            "wi_gate": arr(E, d, f, scale=1.0 / np.sqrt(d)),
            "wi_up": arr(E, d, f, scale=1.0 / np.sqrt(d)),
            "wo": arr(E, f, d, scale=1.0 / np.sqrt(f))}


def jax_ep_moe_grads(mesh, jzcfg, ffn, x, ct):
    """JAX ``make_ep_moe`` on ``mesh``: (y, aux, grads of (ffn, x)) for
    the cotangents ``ct`` of y and AUX_CT of the aux losses."""
    moe_fn = jz.make_ep_moe(mesh, JCFG, JRUN, jzcfg)

    @jax.jit
    def fwd_bwd(ffn, x, ct):
        (y, aux), vjp = jax.vjp(moe_fn, ffn, x)
        return y, aux, vjp((ct, {k: jnp.float32(c)
                                 for k, c in AUX_CT.items()}))

    with mesh:
        y, aux, (g_ffn, g_x) = fwd_bwd(
            {k: jnp.asarray(v) for k, v in ffn.items()}, jnp.asarray(x),
            jnp.asarray(ct))
    return (np.asarray(y), {k: float(v) for k, v in aux.items()},
            jax_values_np(g_ffn), np.asarray(g_x))


@pytest.mark.parametrize("cf", [1.25, 99.0])
@pytest.mark.parametrize("mode", list(MODES))
def test_ep_moe_one_rank_matches_jax(mode, cf):
    T, d = 64, CFG.d_model
    rng = np.random.RandomState(3)
    x = (rng.randn(T, d) * 0.5 + 0.3).astype(np.float32)  # skewed load
    ct = rng.randn(T, d).astype(np.float32)
    ffn = ffn_arrays(CFG)
    kw = dict(MODES[mode], capacity_factor=cf)
    zcfg = zs.ZebraConfig(**kw)
    _, idx, _ = modules.moe_route(torch.from_numpy(ffn["router"]), CFG,
                                  RUN.policy, torch.from_numpy(x))
    C = zs.capacity(T, CFG, zcfg)
    if zcfg.mode == "alltoall":
        C = ops.chunk_capacity(C, combine_chunks(zcfg))[0]
    load = torch.bincount(idx.reshape(-1).long(), minlength=CFG.n_experts)
    assert bool((load > C).any()) == (cf < 99.0)  # drops at 1.25 only
    want_y, want_aux, want_g, want_gx = jax_ep_moe_grads(
        make_mesh((1, 1), ("data", "model")), jz.ZebraConfig(**kw), ffn, x,
        ct)

    moe_fn = zs.make_ep_moe(CFG, RUN, zcfg)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in ffn.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y, aux = moe_fn(p, xt)
    loss = (y * torch.from_numpy(ct)).sum() + sum(
        aux[k] * c for k, c in AUX_CT.items())
    loss.backward()
    close(y, want_y, "y")
    for k in AUX_CT:
        assert aux[k].item() == pytest.approx(want_aux[k], rel=1e-5), k
    close(xt.grad, want_gx, "x")
    for k in ffn:
        close(p[k].grad, want_g[k], k)


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_stats_record_capacity_block_m_and_drops(mode):
    """``reset_stats`` / ``read_stats``: the capacity and row tile the
    engine chose and the share of this rank's token copies it dropped,
    equal to what the routing's expert loads give; off by default."""
    T, d = 64, CFG.d_model
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(T, d) * 0.5 + 0.3).astype(np.float32))
    ffn = {k: torch.from_numpy(v) for k, v in ffn_arrays(CFG).items()}
    zcfg = zs.ZebraConfig(**MODES[mode])
    moe_fn = zs.make_ep_moe(CFG, RUN, zcfg)
    zs.reset_stats(False)
    moe_fn(ffn, x)
    assert zs.read_stats() == {}
    zs.reset_stats()
    try:
        moe_fn(ffn, x)
        got = zs.read_stats()
    finally:
        zs.reset_stats(False)
    _, idx, _ = modules.moe_route(ffn["router"], CFG, RUN.policy, x)
    load = torch.bincount(idx.reshape(-1).long(), minlength=CFG.n_experts)
    C = zs.capacity(T, CFG, zcfg)  # 24: block_m 8
    bm = [8]
    if zcfg.mode == "alltoall":
        Q = max(zcfg.n_chunks, 1)
        C = ops.chunk_capacity(C, combine_chunks(zcfg))[0]
        bm = [ops.packed_block_m([C // Q])]
    kept = int(load.clamp(max=C).sum())
    assert got["capacity"] == [C] and got["block_m"] == bm
    assert (got["copies"], got["kept"]) == (T * CFG.top_k, kept)
    assert got["dropped_share"] == pytest.approx(1 - kept / (T * 2))
    assert got["dropped_share"] > 0
