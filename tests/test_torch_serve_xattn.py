"""Serving the cross-attention archs on the port against the JAX package.

The JAX serve driver runs ``whisper-tiny`` and ``llama-3.2-vision-90b``
through its lockstep ``BatchedServer`` (the continuous engines carry no
front embeddings), whatever the deployment flags ask. Here, on the smoke
configs and the JAX init carried over by ``params_from_jax``, with every
``xgate`` at ``XATTN_GATE`` and random fronts from a numpy seed, under the
f32 policy:

* the port's ``BatchedServer`` (prefill, then lockstep greedy decode, the
  fronts handed to every step) gives JAX's ``BatchedServer``'s tokens, and
  other tokens at gate 0 (the cross-attention is not skipped);
* ``build_deployment`` returns the lockstep server for these archs under
  the dense, ``--paged``, ``--disagg`` and ``--fleet`` configs, as the JAX
  package's does;
* the serve driver ``--arch whisper-tiny --smoke --device cpu``, alone and
  with ``--paged``, exits 0 with the lockstep line, and its summary has
  the JAX driver's keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro.serve import BatchedServer as JBatchedServer
from repro.serve import make_serve_program as jmake_serve
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (BatchedServer, DisaggCfg, FleetCfg, PagedCfg,
                               ServeConfig, build_deployment,
                               make_serve_program)
from torch_parity import XATTN_ARCHS, XATTN_GATE, fronts_np, jax_values_np
from torch_parity import to_np, with_gate
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
            moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
SLOTS, PLEN, GEN = 2, 9, 6


def _lockstep(server, prompts, fronts):
    out = [server.submit_prefill(prompts, fronts)]
    out += [server.step(fronts) for _ in range(GEN - 1)]
    return np.concatenate([np.asarray(to_np(t)) for t in out], axis=1)


@pytest.mark.parametrize("arch", XATTN_ARCHS)
def test_batched_server_matches_jax(arch):
    jcfg = jreg.smoke_config(jreg.get_config(arch))
    cfg = registry.smoke_config(registry.get_config(arch))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    tp0 = params_from_jax(jax_values_np(jp))
    jp, tp = with_gate(jp, XATTN_GATE), with_gate(tp0, XATTN_GATE)
    prompts = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                               (SLOTS, PLEN))
    fronts = fronts_np(cfg, SLOTS, 4)
    prog = make_serve_program(cfg, RUN, device="cpu")
    got = _lockstep(BatchedServer(prog, tp, SLOTS, PLEN + GEN), prompts,
                    {k: torch.from_numpy(v) for k, v in fronts.items()})
    mesh = make_mesh((1, 1), ("data", "model"))
    jprog = jmake_serve(jcfg, mesh, JRUN,
                        JShapeConfig("t", "decode", PLEN + GEN, SLOTS),
                        max_len=PLEN + GEN)
    want = _lockstep(JBatchedServer(jprog, jp, SLOTS, PLEN + GEN),
                     jnp.asarray(prompts, jnp.int32),
                     {k: jnp.asarray(v) for k, v in fronts.items()})
    np.testing.assert_array_equal(got, want)
    ungated = _lockstep(BatchedServer(prog, tp0, SLOTS, PLEN + GEN),
                        prompts,
                        {k: torch.from_numpy(v) for k, v in fronts.items()})
    assert (ungated != got).any()


@pytest.mark.parametrize("mode", ["dense", "paged", "disagg", "fleet"])
def test_deployments_fall_back_to_lockstep(mode):
    cfg = registry.smoke_config(registry.get_config("whisper-tiny"))
    sc = ServeConfig(slots=2, max_len=16,
                     paged=PagedCfg(enabled=mode == "paged"),
                     disagg=DisaggCfg(enabled=mode == "disagg"),
                     fleet=FleetCfg(enabled=mode == "fleet"))
    server = build_deployment(cfg, RUN, sc, device="cpu")
    assert isinstance(server, BatchedServer)
    assert server.batch == 2 and server.max_len == 16


@pytest.mark.parametrize("extra", [[], ["--paged"]])
def test_cli_serves_whisper_lockstep(capsys, extra):
    argv = ["--arch", "whisper-tiny", "--smoke", "--device", "cpu",
            "--slots", "2", "--prompt-len", "8", "--gen", "4", *extra]
    assert serve_mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=whisper-tiny-smoke lockstep fallback generated " \
           "(2, 4)" in out
    s = serve_mod.serve_arch("whisper-tiny",
                             serve_mod.build_parser().parse_args(argv))
    assert {"tokens_per_s", "lockstep", "ok"} <= set(s)
    assert s["ok"] and s["lockstep"] and len(s["tokens"]) == 2
