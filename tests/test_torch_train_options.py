"""repro_torch's train-step options against the JAX package: gradient
accumulation, ``remat="dots"`` and int8 gradient compression.

* ``accum_steps=2``: five steps of ``smoke_config(mixtral-w1)`` (batch 4
  x seq 32, two slices of 2 sequences) through the port's
  ``make_train_program(accum_steps=2)`` and the JAX package's, the same
  weights (the JAX init through ``params_from_jax``), the same tokens (one
  ``write_token_bin`` file), the f32 policy, ``remat="full"``: with zebra
  (replicated, 2 microbatches fitted on the global batch of 4, refitted
  by the override to each slice of 2, capacity 1.25; the JAX package's
  default route, as its driver runs it) and with ``zcfg=None``. Per-step
  loss, nll, z-loss, aux losses, grad norm and learning rate within rtol
  2e-5, the tier of ``test_torch_train.py``.
* ``remat="dots"``: the same five zebra steps against the JAX package
  under ``remat="dots"`` (``dots_with_no_batch_dims_saveable``) within
  rtol 2e-5, and bitwise equal to the port's own ``remat="full"`` run
  (every metric and every param and moment after step 5). The policy is
  counted: per layer and step it saves the outputs of the q, k, v and o
  projections and of the router, per microbatch (2 layers x 2
  microbatches x 5 products), all ``aten.mm``; a policy that saves
  nothing fails.
* compression: ``compress`` / ``decompress`` / ``apply_error_feedback``
  and ``compress_tree`` with its error state on seeded f32 inputs, bitwise
  equal to the JAX package's (int8 values, scales, residuals), also across
  ten error-feedback rounds; and ``compressed_psum`` on two gloo CPU ranks
  (one ``torch.multiprocessing`` spawn) against the JAX package's
  ``compressed_psum`` in ``shard_map`` over the 2-device axis of a 1x2
  mesh: the mean within amax/127 of the exact mean, as
  ``tests/test_compression_accum.py:52-72`` holds its own, and equal to
  the JAX mean bit for bit (the residuals within one rounding of the
  dequantized product, which XLA fuses into the subtraction under jit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.utils.checkpoint import CheckpointPolicy

from repro.core.zebra_spmd import ZebraConfig as JZebraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import DataLoader as JDataLoader
from repro.launch.mesh import make_mesh
from repro.models import registry as jregistry
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRunConfig
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.step import make_train_program as jmake_train_program
from repro_torch.core.zebra_spmd import ZebraConfig
from repro_torch.data import DataConfig, DataLoader, write_token_bin
from repro_torch.models import modules, registry
from repro_torch.models.config import ShapeConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, params_from_jax
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_program
from torch_parity import compress_rank_worker, jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

B, S, STEPS = 4, 32, 5
METRICS = ("loss", "nll", "z_loss", "moe_aux_loss", "moe_z_loss",
           "grad_norm", "lr")
ZEBRA = dict(mode="replicated", num_microbatches=2, capacity_factor=1.25)


def _opt_cfg(mod):
    return mod.OptimizerConfig(peak_lr=3e-3, warmup_steps=2,
                               total_steps=STEPS)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    return write_token_bin(str(path), STEPS * B * S + 1, 256, seed=3)


def _jax_run(token_file, zcfg, remat="full", accum_steps=1):
    cfg = jregistry.smoke_config(jregistry.get_config("mixtral-w1"))
    mesh = make_mesh((1, 1), ("data", "model"))
    run = JRunConfig(policy=JPolicy(compute_dtype=jnp.float32),
                     attn_impl="chunked", moe_impl="gather", remat=remat,
                     chunk_q=16)
    prog = jmake_train_program(
        cfg, mesh, run, JShapeConfig("t", "train", S, B),
        opt_cfg=_opt_cfg(jopt),
        zcfg=None if zcfg is None else JZebraConfig(**zcfg),
        accum_steps=accum_steps)
    loader = JDataLoader(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                     global_batch=B, path=token_file))
    with mesh:
        params = prog.init_params(seed=0)
        init = jax_values_np(params)  # copied before the step donates them
        state = prog.init_opt(params)
        out = []
        for _ in range(STEPS):
            params, state, m = prog.train_step(params, state, next(loader))
            out.append({k: float(m[k]) for k in METRICS})
    return init, out


def _port_run(token_file, init, zcfg, remat="full", accum_steps=1):
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl="chunked", moe_impl="gather", remat=remat,
                    chunk_q=16)
    prog = make_train_program(
        cfg, run, ShapeConfig("t", "train", S, B), opt_cfg=_opt_cfg(opt),
        device="cpu", zcfg=None if zcfg is None else ZebraConfig(**zcfg),
        accum_steps=accum_steps)
    params = params_from_jax(init)
    state = prog.init_opt(params)
    loader = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, path=token_file))
    out = []
    for _ in range(STEPS):
        params, state, m = prog.train_step(params, state, next(loader))
        out.append({k: float(m[k]) for k in METRICS})
    assert int(state["step"]) == STEPS
    return out, params, state


def _assert_close(got, want):
    for step, (g, w) in enumerate(zip(got, want), 1):
        for k in METRICS:
            assert g[k] == pytest.approx(w[k], rel=2e-5, abs=1e-7), \
                (step, k, g[k], w[k])


# ---------------------------------------------------------------------------
# Gradient accumulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zcfg", [ZEBRA, None], ids=["zebra", "no_zebra"])
def test_accum_steps_match_jax(token_file, zcfg):
    init, want = _jax_run(token_file, zcfg, accum_steps=2)
    got, _, _ = _port_run(token_file, init, zcfg, accum_steps=2)
    _assert_close(got, want)
    # the accumulation did run: one slice alone gives another step 1
    one, _, _ = _port_run(token_file, init, zcfg, accum_steps=1)
    assert one[0]["grad_norm"] != got[0]["grad_norm"] or \
        one[0]["moe_aux_loss"] != got[0]["moe_aux_loss"]


def test_accum_steps_must_divide_the_batch():
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    with pytest.raises(ValueError, match="accum_steps=3"):
        make_train_program(cfg, RunConfig(), ShapeConfig("t", "train", S, B),
                           device="cpu", accum_steps=3)


# ---------------------------------------------------------------------------
# remat="dots"
# ---------------------------------------------------------------------------

def test_remat_dots_matches_jax_and_equals_full(token_file, monkeypatch):
    saved = {}
    policy = modules.dots_with_no_batch_dims_saveable

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved[str(op)] = saved.get(str(op), 0) + 1
        return out

    monkeypatch.setattr(modules, "dots_with_no_batch_dims_saveable",
                        counting)
    init, want = _jax_run(token_file, ZEBRA, remat="dots")
    got, p_dots, s_dots = _port_run(token_file, init, ZEBRA, remat="dots")
    _assert_close(got, want)
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    # q, k, v, o and the router per layer, microbatch and step
    assert saved == {"aten.mm.default": cfg.n_layers * 2 * 5 * STEPS}, saved
    saved.clear()
    full, p_full, s_full = _port_run(token_file, init, ZEBRA, remat="full")
    assert not saved  # the policy runs under "dots" only
    assert got == full
    a = flatten({"p": p_dots, "o": s_dots})
    b = flatten({"p": p_full, "o": s_full})
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_dots_policy_decides_by_batch_extent():
    """``x @ w`` on 3-d activations is an ``mm``; an einsum without batch
    dims a ``bmm`` of batch 1 (saved); attention scores a ``bmm`` over a
    real batch (recomputed)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            decision = modules.dots_with_no_batch_dims_saveable(
                None, func, *args, **(kwargs or {}))
            self.seen.append((func.overloadpacket.__name__, decision))
            return out

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=g)
    w = torch.randn(8, 6, generator=g)
    e = torch.randn(3, 8, 4, generator=g)
    q = torch.randn(2, 4, 5, 8, generator=g)
    with Record() as rec:
        x @ w
        torch.einsum("td,edf->tef", x[0], e)
        torch.einsum("bhqd,bhkd->bhqk", q, q)
    products = [(n, d) for n, d in rec.seen if n in ("mm", "bmm")]
    save, rec_ = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    assert products == [("mm", save), ("bmm", save), ("bmm", rec_)], \
        products


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def _grads(seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(16, 33) * 3e-3).astype(np.float32),
            "b": {"c": (rng.randn(7) * 2.0).astype(np.float32),
                  "z": np.zeros(5, np.float32)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def _assert_bitwise(got, want):
    g, w = flatten(got), flatten(jax_values_np(want))
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = to_np(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_compression_bitwise_equal_to_jax():
    g = _grads(0)
    for leaf in (g["w"], g["b"]["c"]):
        q, s = comp.compress(torch.from_numpy(leaf))
        jq, js = jcomp.compress(jnp.asarray(leaf))
        assert q.dtype == torch.int8 and s.dim() == 0
        assert to_np(q).tobytes() == np.asarray(jq).tobytes()
        assert to_np(s).tobytes() == np.asarray(js).tobytes()
        assert to_np(comp.decompress(q, s)).tobytes() == \
            np.asarray(jcomp.decompress(jq, js)).tobytes()
    # ten error-feedback rounds over a tree, new gradients each round
    err = comp.init_error_state(_torch_tree(g))
    jerr = jcomp.init_error_state(jax.tree.map(jnp.asarray, g))
    for r in range(10):
        g = _grads(r + 1)
        qs, scales, new_err = comp.compress_tree(_torch_tree(g), err)
        jqs, jscales, jnew_err = jcomp.compress_tree(
            jax.tree.map(jnp.asarray, g), jerr)
        _assert_bitwise(qs, jqs)
        _assert_bitwise(scales, jscales)
        hat = {k: comp.decompress(q, scales[k]) for k, q in qs.items()
               if not isinstance(q, dict)}
        hat["b"] = {k: comp.decompress(q, scales["b"][k])
                    for k, q in qs["b"].items()}
        err = new_err(hat)
        jerr = jnew_err(jax.tree.map(jcomp.decompress, jqs, jscales))
        _assert_bitwise(err, jerr)
        assert int(np.abs(to_np(qs["b"]["z"])).max()) == 0


def test_compressed_psum_one_rank_is_the_dequantized_tree():
    g = _torch_tree(_grads(4))
    err = comp.init_error_state(g)
    mean, new_err = comp.compressed_psum(g, err)
    qs, scales, _ = comp.compress_tree(g, err)
    for k, v in flatten(mean).items():
        want = comp.decompress(flatten(qs)[k], flatten(scales)[k])
        assert torch.equal(v, want), k
        assert torch.equal(flatten(new_err)[k], flatten(g)[k] - want), k


def test_compressed_psum_two_ranks_match_jax_shard_map(tmp_path):
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    rng = np.random.RandomState(2)
    grads = (rng.randn(8, 32) * 0.7).astype(np.float32)
    err = (rng.randn(8, 32) * 1e-3).astype(np.float32)
    np.savez(tmp_path / "in.npz", grads=grads, err=err)
    mp.spawn(compress_rank_worker, nprocs=2, join=True,
             args=(2, str(tmp_path / "init"), str(tmp_path / "in.npz"),
                   str(tmp_path)))
    ranks = [np.load(tmp_path / f"psum_{r}.npz") for r in range(2)]

    mesh = make_mesh((1, 2), ("data", "model"))
    out, new_err = jax.jit(shard_map(
        lambda g, e: jcomp.compressed_psum(g, e, "model"), mesh,
        in_specs=({"w": P("model", None)}, {"w": P("model", None)}),
        out_specs=({"w": P(None, None)}, {"w": P("model", None)})))(
            {"w": jnp.asarray(grads)}, {"w": jnp.asarray(err)})
    corrected = (grads + err).reshape(2, 4, 32)
    exact = corrected.mean(0)
    amax = float(np.abs(corrected).max())
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["mean"], exact, atol=amax / 127)
        assert got["mean"].tobytes() == np.asarray(out["w"])[:4].tobytes()
        # XLA contracts c - q * scale into one fused multiply-add under
        # jit; the port rounds the product first (the eager JAX arithmetic,
        # test_compression_bitwise_equal_to_jax): one rounding of q * scale
        np.testing.assert_allclose(
            got["err"], np.asarray(new_err["w"])[r * 4:(r + 1) * 4],
            rtol=0, atol=amax * 2.0 ** -23)
    assert ranks[0]["mean"].tobytes() == ranks[1]["mean"].tobytes()
