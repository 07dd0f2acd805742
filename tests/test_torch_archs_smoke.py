"""The arch sweep on the port: ``tests/test_archs_smoke.py::
test_decode_smoke``'s case (batch 2, a 16-token prefill into a dense
decode state of 24 lines, then 4 greedy decode steps at a scalar
``cache_index``) through ``repro_torch`` and the JAX package, for every
arch whose init the port has (attention, RG-LRU and SSD mixers:
recurrentgemma-9b and mamba2-2.7b among them; cross-attention:
whisper-tiny and llama-3.2-vision-90b, given random fronts from a numpy
seed at every step and every ``xgate`` at ``XATTN_GATE``, so the
cross-attention adds to the residual), on the JAX init carried over by
``params_from_jax`` under the f32 policy. Each step's logits are within
1e-5 * max|JAX| of JAX's and finite, and both feed JAX's greedy token to
the next step. The JAX forward is jit-compiled (one compile per shape).
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
from torch_parity import XATTN_GATE, fronts_np, jax_values_np, to_np
from torch_parity import with_gate
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
REL = 1e-5
B, S, STEPS = 2, 16, 4


def _initable(name) -> bool:
    try:
        stack.param_specs(registry.get_config(name))
    except NotImplementedError:
        return False
    return True


ARCHS = [n for n in registry.names() if _initable(n)]


def test_the_sweep_holds_the_recurrent_archs():
    assert {"recurrentgemma-9b", "mamba2-2.7b"} <= set(ARCHS)
    assert {"whisper-tiny", "llama-3.2-vision-90b"} <= set(ARCHS)


_jstep = jax.jit(lambda params, state, tokens, cache_index, fronts, cfg:
                 jstack.apply_model(params, cfg, JRUN, tokens,
                                    decode_state=state,
                                    cache_index=cache_index, **fronts)[:2],
                 static_argnums=(5,))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_smoke_matches_jax(arch):
    jcfg = jreg.smoke_config(jreg.get_config(arch))
    cfg = registry.smoke_config(registry.get_config(arch))
    jp = with_gate(split_params(
        jstack.init_model(jax.random.PRNGKey(0), jcfg))[0], XATTN_GATE)
    tp = params_from_jax(jax_values_np(jp))
    fronts = fronts_np(cfg, B, 2)
    jfronts = {k: jnp.asarray(v) for k, v in fronts.items()}
    tfronts = {k: torch.from_numpy(v) for k, v in fronts.items()}
    jstate = jstack.init_decode_state(jcfg, B, S + 8, jnp.float32)
    state = stack.init_decode_state(cfg, B, S + 8, torch.float32)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         jcfg.vocab_size))
    index = 0
    for step in range(STEPS + 1):
        jlogits, jstate = _jstep(jp, jstate, jnp.asarray(tokens),
                                 jnp.asarray(index, jnp.int32), jfronts,
                                 jcfg)
        with torch.inference_mode():
            logits, state, _ = stack.apply_model(
                tp, cfg, RUN, torch.from_numpy(tokens).long(),
                decode_state=state, cache_index=index, **tfronts)
        want = np.asarray(jlogits)
        got = to_np(logits)
        assert got.shape == want.shape == (B, tokens.shape[1],
                                           cfg.vocab_size)
        assert np.isfinite(got).all()
        err = float(np.abs(got - want).max())
        assert err <= REL * float(np.abs(want).max()), (arch, step, err)
        index += tokens.shape[1]
        tokens = np.asarray(want[:, -1:].argmax(-1), np.int32)
