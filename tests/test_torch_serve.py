"""repro_torch paged continuous-batching serving against the JAX package.

Greedy tokens of the port's engine equal the JAX paged
``ContinuousBatchingEngine``'s on the same ``build_trace`` Poisson trace
(smoke-size ``mixtral-w2``, JAX weights carried over), with a prefill chunk
large enough for the packed MoE route (>= 74 tokens at E = 8), and again
on an overcommitted pool that forces preemption. Sampled decoding is
deterministic across schedules. The driver serves on the CPU with
``--device cpu`` (also ``--disagg`` without ``--paged``, as the JAX driver
does), rejects invalid combinations by name with exit 1, and refuses to
run without a CUDA device otherwise.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.mesh import make_mesh
from repro.launch.serve import build_trace as jax_build_trace
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro.serve import BlockAllocator as JAllocator
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import GREEDY as JGREEDY
from repro.serve import Scheduler as JScheduler
from repro.serve import make_continuous_program as jmake_program
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve import (GREEDY, PagedCfg, Request, SamplingParams,
                               ServeConfig, build_deployment)
from torch_parity import jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

SLOTS, MAX_LEN, PS, CHUNK = 2, 104, 16, 96
TRACE = dict(seed=4, n=4, rate=0.5, prompt_len=96, gen=8)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.smoke_config(jreg.get_config("mixtral-w2"))
    cfg = registry.smoke_config(registry.get_config("mixtral-w2"))
    jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    tp = params_from_jax(jax_values_np(jp))
    trace = serve_mod.build_trace(vocab=cfg.vocab_size, sampling=GREEDY,
                                  **TRACE)
    jtrace = jax_build_trace(vocab=jcfg.vocab_size, sampling=JGREEDY,
                             **TRACE)
    assert [r.prompt for r in trace] == [r.prompt for r in jtrace]
    # one chunk holds >= 74 prompt tokens: M = 2 * 74 > 8 * 128 / 7, the
    # packed route of ops.moe_ffn
    assert max(len(r.prompt) for r in trace) >= 74
    mesh = make_mesh((1, 1), ("data", "model"))
    jrun = JRun(policy=JPolicy(compute_dtype=jnp.float32), moe_impl="gather")
    prog = jmake_program(jcfg, mesh, jrun, n_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PS)
    jeng = JEngine(prog, jp, JScheduler(
        SLOTS, MAX_LEN, prefill_chunk=CHUNK,
        allocator=JAllocator(prog.n_pages, prog.page_size, prog.max_pages)))
    jres = jeng.run(jtrace)
    return cfg, tp, trace, jres


def _engine(cfg, params, *, n_pages=None, slots=SLOTS, chunk=CHUNK,
            seed=0):
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    sc = ServeConfig(slots=slots, max_len=MAX_LEN, prefill_chunk=chunk,
                     seed=seed, paged=PagedCfg(enabled=True, page_size=PS,
                                               pool_pages=n_pages))
    return build_deployment(cfg, run, sc, params=params, device="cpu")


def _copy(trace, sampling=None):
    return [Request(rid=r.rid, prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens,
                    sampling=sampling or r.sampling, arrival=r.arrival)
            for r in trace]


def test_greedy_tokens_equal_jax_engine(setup):
    cfg, tp, trace, jres = setup
    eng = _engine(cfg, tp)
    res = eng.run(_copy(trace))
    assert res == jres
    assert all(len(res[r.rid]) == r.max_new_tokens for r in trace)
    eng.sched.allocator.check()
    assert eng.sched.allocator.pages_in_use == 0


def test_greedy_tokens_equal_jax_under_preemption(setup):
    cfg, tp, trace, jres = setup
    eng = _engine(cfg, tp, n_pages=8)  # 2 slots x 7 pages overcommitted
    res = eng.run(_copy(trace))
    assert eng.sched.n_preempted > 0, "pool was not tight enough"
    assert res == jres
    eng.sched.allocator.check()


def test_sampled_decoding_is_schedule_independent(setup):
    """Noise is a function of (seed, rid, n) only: the same trace gives
    the same tokens under another slot count, another chunking and a
    preempting pool."""
    cfg, tp, trace, _ = setup
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
    runs = [_engine(cfg, tp, seed=3).run(_copy(trace, sp)),
            _engine(cfg, tp, seed=3, slots=3, chunk=40).run(
                _copy(trace, sp)),
            _engine(cfg, tp, seed=3, n_pages=8).run(_copy(trace, sp))]
    assert runs[0] == runs[1] == runs[2]
    other_seed = _engine(cfg, tp, seed=4).run(_copy(trace, sp))
    assert other_seed != runs[0]


SMOKE_ARGS = ["--arch", "mixtral-w2", "--smoke", "--paged", "--slots", "2",
              "--requests", "2", "--prompt-len", "12", "--gen", "3",
              "--prefill-chunk", "8"]


def test_driver_serves_on_cpu(capsys):
    assert serve_mod.main(SMOKE_ARGS + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=mixtral-w2-smoke device=cpu 2 requests" in out


@pytest.mark.parametrize("extra,named", [
    (["--fleet", "--disagg"], "--fleet and --disagg are mutually exclusive"),
    (["--ep-size", "2"],
     "bad EP config: ep_size 2 != mesh axis 'model' size 1"),
    (["--kill-group", "1@2"], "--kill-group requires --fleet"),
    (["--fleet", "--prefix-cache"],
     "--prefix-cache is not supported with --fleet"),
    (["--slo-ttft", "1.0"], "--slo-ttft requires --fleet"),
    (["--ep-size", "1", "--fleet"],
     "--ep-size is not supported with --fleet"),
    (["--arch", "mamba2-2.7b", "--prefix-cache"],
     "--prefix-cache needs per-position KV only")])
def test_driver_rejects_unported_flags(capsys, extra, named):
    """The JAX driver's invalid combinations (expert-parallel decode over
    more ranks than the driver's one, or with the fleet, and the prefix
    cache on a recurrent arch among them), with its messages: one
    ``[serve] invalid configuration:`` line that names them, exit 1."""
    assert serve_mod.main(SMOKE_ARGS + ["--device", "cpu"] + extra) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("[serve] invalid "
                                               "configuration:")
    assert named in err[0]


def test_driver_rejects_running_without_paged(capsys):
    """Without ``--paged`` the driver serves dense caches, so the prefix
    cache is refused there with the JAX driver's message."""
    args = [a for a in SMOKE_ARGS if a != "--paged"] + ["--device", "cpu",
                                                       "--prefix-cache"]
    assert serve_mod.main(args) == 1
    err = capsys.readouterr().err
    assert "--prefix-cache needs a paged deployment" in err


def test_driver_accepts_disagg_without_paged(capsys):
    """``--disagg`` is paged by itself, as in the JAX driver."""
    args = [a for a in SMOKE_ARGS if a != "--paged"] + ["--device", "cpu",
                                                       "--disagg"]
    assert serve_mod.main(args) == 0
    captured = capsys.readouterr()
    assert "invalid configuration" not in captured.err
    assert "[serve] arch=mixtral-w2-smoke disagg: " in captured.out


def test_driver_needs_a_device_without_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    assert serve_mod.main(SMOKE_ARGS) != 0
    assert "no CUDA device" in capsys.readouterr().err
