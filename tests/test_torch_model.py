"""repro_torch Mixtral model against the JAX package, on smoke-size
``mixtral-w2`` with the JAX init carried over by ``params_from_jax``.

Cache-free logits, chunked paged prefill logits (through non-contiguous,
differently ordered pages) and per-slot paged decode logits must match the
JAX package at 1e-4 under the f32 policy. The prefill chunks cover both
MoE routes: an 80-token chunk takes the packed route (fused GLU + down
GEMM kernels' plain versions), shorter chunks and decode the group-dense
route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro_torch.models import registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
PS, N_PAGES = 16, 12
TABLES = np.asarray([[5, 0, 3, 7, 9, 11], [1, 4, 2, -1, -1, -1]], np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg = jreg.smoke_config(jreg.get_config("mixtral-w2"))
    cfg = registry.smoke_config(registry.get_config("mixtral-w2"))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    return jcfg, jp, cfg, params_from_jax(jax_values_np(jp))


def _prompts(cfg):
    rng = np.random.RandomState(11)
    return [rng.randint(0, cfg.vocab_size, size=(n,)) for n in (80, 37)]


def test_cache_free_logits_match_jax(model):
    jcfg, jp, cfg, tp = model
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, 80))
    want, _, _ = jstack.apply_model(jp, jcfg, JRUN, jnp.asarray(toks))
    got, _, aux = stack.apply_model(tp, cfg, RUN, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert set(aux) == set(stack.AUX_KEYS)


@pytest.mark.parametrize("arch", [
    "qwen3-moe-30b-a3b",  # qk_norm, 8 experts of the smoke size
    "llama3.2-3b",        # dense SwiGLU MLP, tied embeddings
    "starcoder2-15b",     # LayerNorm, GELU MLP
])
def test_cache_free_logits_match_jax_other_archs(arch):
    jcfg = jreg.smoke_config(jreg.get_config(arch))
    cfg = registry.smoke_config(registry.get_config(arch))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(1), jcfg))[0]
    tp = params_from_jax(jax_values_np(jp))
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(2, 24))
    want, _, _ = jstack.apply_model(jp, jcfg, JRUN, jnp.asarray(toks))
    got, _, _ = stack.apply_model(tp, cfg, RUN, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_paged_prefill_and_decode_logits_match_jax(model):
    jcfg, jp, cfg, tp = model
    prompts = _prompts(cfg)
    chunks = [[80], [20, 17]]
    jstate = jstack.init_paged_decode_state(jcfg, 2, N_PAGES, PS,
                                            jnp.float32)
    tstate = stack.init_paged_decode_state(cfg, 2, N_PAGES, PS,
                                           torch.float32)
    firsts = []
    for b, (prompt, sizes) in enumerate(zip(prompts, chunks)):
        off = 0
        for c in sizes:
            toks = prompt[None, off:off + c]
            jl, jstate, _ = jstack.apply_model(
                jp, jcfg, JRUN, jnp.asarray(toks), decode_state=jstate,
                cache_index=jnp.asarray(off, jnp.int32),
                attend_to_cache=True,
                page_table=jnp.asarray(TABLES[b:b + 1]))
            tl, tstate, _ = stack.apply_model(
                tp, cfg, RUN, torch.from_numpy(toks), decode_state=tstate,
                cache_index=off, page_table=torch.from_numpy(TABLES[b:b + 1]))
            np.testing.assert_allclose(to_np(tl[:, -1]),
                                       np.asarray(jl[:, -1]), **TOL)
            off += c
        firsts.append(int(np.argmax(np.asarray(jl[0, -1]))))
        # the chunked prefill also matches the cache-free forward
        whole, _, _ = stack.apply_model(tp, cfg, RUN,
                                        torch.from_numpy(prompt[None]))
        np.testing.assert_allclose(to_np(tl[:, -1]), to_np(whole[:, -1]),
                                   **TOL)

    tok = np.asarray(firsts, np.int32)[:, None]
    pos = np.asarray([len(p) for p in prompts], np.int32)
    for _ in range(3):
        jl, jstate, _ = jstack.apply_model(
            jp, jcfg, JRUN, jnp.asarray(tok), decode_state=jstate,
            cache_index=jnp.asarray(pos), page_table=jnp.asarray(TABLES))
        tl, tstate, _ = stack.apply_model(
            tp, cfg, RUN, torch.from_numpy(tok), decode_state=tstate,
            cache_index=torch.from_numpy(pos),
            page_table=torch.from_numpy(TABLES))
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl[:, -1]), -1).astype(np.int32)[:, None]
        pos = pos + 1
    # the pools hold the same keys / values / positions, in place
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(
            to_np(tstate["blocks"]["pos0"]["kv"][name]),
            np.asarray(jstate["blocks"]["pos0"]["kv"][name]), **TOL)


def test_split_merge_kv_state_roundtrip(model):
    _, _, cfg, _ = model
    state = stack.init_paged_decode_state(cfg, 2, 4, PS, torch.float32)
    kv, rec = stack.split_kv_state(state)
    assert rec["blocks"]["pos0"] == {} and "kv" in kv["blocks"]["pos0"]
    merged = stack.merge_kv_state(kv, rec)
    assert merged["blocks"]["pos0"]["kv"]["k"] is state["blocks"]["pos0"][
        "kv"]["k"]
    # one layer's pool is a contiguous view of the stacked [L, P, ...] leaf
    pool = state["blocks"]["pos0"]["kv"]["k"]
    assert pool.shape == (cfg.n_layers, 4, PS, cfg.n_kv_heads, cfg.head_dim)
    assert pool[1].is_contiguous()
