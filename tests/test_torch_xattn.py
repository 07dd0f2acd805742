"""Cross-attention on the port against the JAX package: the layer, the
encoder stack, learned positions and the vision projection.

Every case runs the smoke configs of ``whisper-tiny`` (2 decoder layers
with cross-attention over a 2-layer bidirectional encoder of 16 frames,
learned positions, layernorm, GELU) and ``llama-3.2-vision-90b`` (10
layers: 8 self-attention, 2 cross-attention without a mixer, over 16
projected patch embeddings) on the JAX init carried over by
``params_from_jax``, under the f32 policy. The reference initialises each
cross-attention gate ``xgate`` to 0 and its drivers feed zero fronts, so
at init a cross-attention adds exactly 0 and its weights, the encoder and
``vision_proj`` get no gradient: every case sets ``xgate`` to ``GATE`` in
both trees and draws the fronts from a numpy seed, and the model cases
show that the gate moves the logits.

* ``apply_attention`` with a memory (S 24 over T 40, and a decode step at
  S 1) through the reference, chunked and flash paths (the JAX package's
  Pallas flash in interpret mode, the port's plain version): within
  1e-5 * max|JAX|;
* ``apply_model``: a 16-token prefill into a dense decode state, then 4
  lockstep decode steps, each step's logits within 1e-5 * max|JAX| and
  the greedy tokens equal; the prefill's logits at gate 0 differ from
  those at ``GATE`` by more than 1e-3 * max.

Training is held in ``test_torch_xattn_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modules as jmodules
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro_torch.models import modules, registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from torch_parity import XATTN_ARCHS as ARCHS
from torch_parity import XATTN_GATE as GATE
from torch_parity import fronts_np, jax_values_np, to_np, with_gate
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

REL = 1e-5
B, S, STEPS = 2, 16, 4


def _configs(arch):
    jcfg = jreg.smoke_config(jreg.get_config(arch))
    cfg = registry.smoke_config(registry.get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _close(got, want, rel=REL, what=""):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "chunked", "flash"])
@pytest.mark.parametrize("S_q", [24, 1])
def test_cross_attention_matches_jax(impl, S_q):
    """K and V from the memory, no RoPE, not causal, no cache: S_q
    queries over T 40 memory rows, through each attention path."""
    jcfg, cfg = _configs("llama-3.2-vision-90b")  # RoPE on: cross skips it
    T = 40
    jp = split_params(jmodules.init_attention(jax.random.PRNGKey(4), jcfg,
                                              cross=True))[0]
    assert "q_norm" not in jp
    tp = params_from_jax(jax_values_np(jp))
    rng = np.random.RandomState(5)
    x = rng.randn(2, S_q, cfg.d_model).astype(np.float32)
    kv = rng.randn(2, T, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_q, dtype=np.int32) + 7, (2, S_q))
    kv_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    jrun = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl=impl,
                chunk_q=16)
    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl=impl, chunk_q=16)
    want, _ = jmodules.apply_attention(
        jp, jcfg, jrun, jnp.asarray(x), jnp.asarray(pos), causal=True,
        kv=jnp.asarray(kv), kv_positions=jnp.asarray(kv_pos))
    got, _ = modules.apply_attention(
        tp, cfg, run, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        causal=True, kv=torch.from_numpy(kv),
        kv_positions=torch.from_numpy(kv_pos.copy()))
    _close(got, want, what=impl)


# ---------------------------------------------------------------------------
# The model: prefill and lockstep decode
# ---------------------------------------------------------------------------

_jstep = jax.jit(lambda params, state, tokens, cache_index, fronts, cfg:
                 jstack.apply_model(params, cfg, JRun(policy=JPolicy(
                     compute_dtype=jnp.float32)), tokens,
                     decode_state=state, cache_index=cache_index,
                     **fronts)[:2],
                 static_argnums=(5,))


@pytest.fixture(scope="module")
def models():
    """arch -> (jcfg, cfg, gated JAX params, gated port params, port
    params at gate 0)."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
        tp = params_from_jax(jax_values_np(jp))
        out[arch] = (jcfg, cfg, with_gate(jp, GATE), with_gate(tp, GATE), tp)
    return out


def _decode_run(cfg, params, tokens, fronts):
    """Prefill + STEPS greedy decode steps on the port; the logits of each
    call and the tokens fed."""
    state = stack.init_decode_state(cfg, B, S + STEPS + 1, torch.float32)
    tf = {k: torch.from_numpy(v) for k, v in fronts.items()}
    logits, index, toks = [], 0, tokens
    for _ in range(STEPS + 1):
        with torch.inference_mode():
            lg, state, _ = stack.apply_model(
                params, cfg, RunConfig(policy=Policy(
                    compute_dtype=torch.float32)),
                torch.from_numpy(toks).long(), decode_state=state,
                cache_index=index, **tf)
        logits.append(to_np(lg))
        index += toks.shape[1]
        toks = logits[-1][:, -1:].argmax(-1)
    return logits


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch):
    jcfg, cfg, jp, tp, tp0 = models[arch]
    fronts = fronts_np(cfg, B, 6)
    tokens = np.random.RandomState(7).randint(0, cfg.vocab_size, (B, S))
    got = _decode_run(cfg, tp, tokens, fronts)
    jstate = jstack.init_decode_state(jcfg, B, S + STEPS + 1, jnp.float32)
    jf = {k: jnp.asarray(v) for k, v in fronts.items()}
    toks, index = tokens, 0
    for step, g in enumerate(got):
        jlogits, jstate = _jstep(jp, jstate, jnp.asarray(toks, jnp.int32),
                                 jnp.asarray(index, jnp.int32), jf, jcfg)
        want = np.asarray(jlogits)
        _close(g, want, what=(arch, step))
        np.testing.assert_array_equal(g[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))
        index += toks.shape[1]
        toks = want[:, -1:].argmax(-1)
    # not vacuous: the gate moves the prefill's logits
    ungated = _decode_run(cfg, tp0, tokens, fronts)[0]
    assert np.abs(got[0] - ungated).max() > 1e-3 * np.abs(got[0]).max()
