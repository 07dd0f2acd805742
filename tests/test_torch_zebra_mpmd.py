"""repro_torch zebra MPMD engine (``core/zebra_mpmd.py``) against the JAX
package's ``ZebraMPMD`` and against the port's own fused model.

* Parity: the four cases of ``test_zebra.py::test_mpmd_engine_matches_fused``
  (offload None / (1, 0), n_chunks 1 / 2; smoke W1 with 2 layers, batch 4
  x 16, no drops) and one at capacity factor 1.25, where copies are
  dropped. The JAX engine runs on conftest's emulated CPU devices
  (attention devs[:2], experts devs[2:6]), the port's on the CPU with 4
  expert lanes, both on the same ``init_model`` weights
  (``params_from_jax``) under the f32 policy. The loss within 1e-5 and
  every leaf of grads_attn and of each layer's grads_exp within rtol 1e-5,
  atol 1e-5 * max|ref|.
* Fused: the engine against autograd of ``stack.apply_model`` (the NLL
  only) at a capacity with no drops.
* Placement, the issue order (Theorem 1's canonical schedule), the
  recompute's routing, the entry point.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.zebra_mpmd import ZebraMPMD as JZebraMPMD
from repro.models import registry as jregistry
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRunConfig
from repro.pytree import split_params
from repro_torch.core import schedule as S
from repro_torch.core import zebra_mpmd as zm
from repro_torch.launch import hetero_mpmd
from repro_torch.models import registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, params_from_jax
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRunConfig(policy=JPolicy(compute_dtype=jnp.float32),
                  moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
LANES = ["cpu"] * 4


def w1(layers=2, cap=99.0):
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    return dataclasses.replace(cfg, n_layers=layers, capacity_factor=cap)


def close(got, want, name=""):
    """rtol 1e-5, atol 1e-5 * max|want|."""
    want = np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=atol,
                               err_msg=name)


def nonlayer(tree):
    return {k: v for k, v in tree.items() if k != "layers"}


@pytest.fixture(scope="module")
def jax_inputs():
    """The JAX test's weights and batch: init_model(PRNGKey(0)) of the
    2-layer smoke W1, tokens and targets [4, 16]."""
    jcfg = dataclasses.replace(
        jregistry.smoke_config(jregistry.get_config("mixtral-w1")),
        capacity_factor=99.0, n_layers=2)
    key = jax.random.PRNGKey(0)
    params, _ = split_params(jstack.init_model(key, jcfg))
    tokens = jax.random.randint(key, (4, 16), 0, jcfg.vocab_size)
    targets = jax.random.randint(jax.random.fold_in(key, 1), (4, 16), 0,
                                 jcfg.vocab_size)
    return jcfg, params, tokens, targets


def torch_batch(tokens, targets):
    return (torch.from_numpy(np.array(tokens)),
            torch.from_numpy(np.array(targets)))


@pytest.mark.parametrize("offload,n_chunks,cf", [
    (None, 1, None), ((1, 0), 1, None), (None, 2, None), ((1, 0), 2, None),
    ((1, 0), 2, 1.25)])
def test_mpmd_engine_matches_jax(jax_inputs, offload, n_chunks, cf):
    jcfg, jparams, tokens, targets = jax_inputs
    devs = jax.devices()
    jeng = JZebraMPMD(jcfg, JRUN, attn_devices=devs[:2],
                      exp_devices=devs[2:6], num_microbatches=2,
                      offload=offload, capacity_factor=cf,
                      n_chunks=n_chunks)
    ja, je = jeng.shard_params(jparams)
    jloss, jga, jge = jeng.train_step(ja, je, tokens, targets)

    eng = zm.ZebraMPMD(w1(), RUN, ["cpu"], LANES, num_microbatches=2,
                       offload=offload, capacity_factor=cf,
                       n_chunks=n_chunks)
    kept = []
    route = eng.attn_route

    def recording(p, x, positions):
        out = route(p, x, positions)
        kept.append(int(out[4][2].sum()))
        return out
    eng.attn_route = recording
    attn_side, exp_layers = eng.shard_params(
        params_from_jax(jax_values_np(jparams)))
    loss, ga, ge = eng.train_step(attn_side, exp_layers,
                                  *torch_batch(tokens, targets))
    # the capacity-1.25 case drops copies (32 tokens x top-2 a microbatch)
    assert (min(kept) < 64) == (cf is not None)

    assert abs(float(loss) - float(jloss)) < 1e-5
    want = flatten(jax_values_np(nonlayer(jga)))
    got = flatten(nonlayer(ga))
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], k)
    for l in range(jcfg.n_layers):
        want = flatten(jax_values_np(jga["layers"][l]))
        got = flatten(ga["layers"][l])
        assert got.keys() == want.keys()
        for k in want:
            close(got[k], want[k], f"layer {l} {k}")
        for k in zm.EXPERT_KEYS:
            close(torch.cat([lane[k] for lane in ge[l]]), np.asarray(
                jge[l][k]), f"layer {l} experts {k}")


def seeded(cfg, seed=0):
    return stack.init_model(torch.Generator().manual_seed(seed), cfg)


def batch(cfg, B=4, S_=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, cfg.vocab_size, (B, S_), generator=g),
            torch.randint(0, cfg.vocab_size, (B, S_), generator=g))


def test_mpmd_engine_matches_fused_model():
    """No drops (capacity 99): the engine's loss and every gradient equal
    autograd through ``stack.apply_model`` with the NLL only."""
    cfg = w1()
    params = seeded(cfg)
    tokens, targets = batch(cfg)
    leaves = {k: v.clone().requires_grad_()
              for k, v in flatten(params).items()}
    logits, _, _ = stack.apply_model(zm._unflatten(leaves), cfg, RUN, tokens)
    logp = torch.log_softmax(logits, -1)
    ref_loss = -torch.gather(logp, -1, targets[..., None])[..., 0].mean()
    ref = dict(zip(leaves, torch.autograd.grad(ref_loss,
                                               list(leaves.values()))))

    offload = (1, 0)
    eng = zm.ZebraMPMD(cfg, RUN, ["cpu"], LANES, offload=offload,
                       n_chunks=2)
    attn_side, exp_layers = eng.shard_params(params)
    loss, ga, ge = eng.train_step(attn_side, exp_layers, tokens, targets)
    close(loss, to_np(ref_loss), "loss")
    for k, g in flatten(nonlayer(ga)).items():
        close(g, to_np(ref[k]), k)
    for l in range(cfg.n_layers):
        n_att = eng.plan.n_attn_experts(l)
        for k, g in flatten(ga["layers"][l]).items():
            want = to_np(ref[f"blocks/pos0/{k}"][l])
            if k in [f"ffn/{e}" for e in zm.EXPERT_KEYS]:
                want = want[:n_att]
            close(g, want, f"layer {l} {k}")
        for k in zm.EXPERT_KEYS:
            close(torch.cat([lane[k] for lane in ge[l]]),
                  to_np(ref[f"blocks/pos0/ffn/{k}"][l])[n_att:],
                  f"layer {l} experts {k}")


def test_placement_splits_experts_over_lanes():
    cfg = w1()
    params = seeded(cfg)
    eng = zm.ZebraMPMD(cfg, RUN, ["cpu", "cpu"], LANES, offload=(1, 0))
    assert eng.M == 2 and eng.N == 4
    attn_side, exp_layers = eng.shard_params(params)
    blocks = params["blocks"]["pos0"]
    for l, off in enumerate((1, 0)):
        n_att = eng.plan.n_attn_experts(l)
        assert n_att == off * eng.N
        El = (cfg.n_experts - n_att) // eng.N
        assert len(exp_layers[l]) == eng.N
        for k in zm.EXPERT_KEYS:
            w = blocks["ffn"][k][l]
            assert torch.equal(attn_side["layers"][l]["ffn"][k], w[:n_att])
            for i, lane in enumerate(exp_layers[l]):
                assert lane.keys() == set(zm.EXPERT_KEYS)
                lo = n_att + i * El
                assert torch.equal(lane[k], w[lo:lo + El])
        assert torch.equal(attn_side["layers"][l]["mixer"]["wq"],
                           blocks["mixer"]["wq"][l])
    assert torch.equal(attn_side["embed"]["table"], params["embed"]["table"])


@pytest.mark.parametrize("offload,lanes", [((1, 0), 3), (None, 3),
                                           ((3, 0), 4)])
def test_placement_rejects_uneven_lanes(offload, lanes):
    with pytest.raises(ValueError, match="expert lanes"):
        zm.ZebraMPMD(w1(), RUN, ["cpu"], ["cpu"] * lanes, offload=offload)


@pytest.mark.parametrize("attn,lanes", [(["cpu", "meta"], LANES),
                                        (["cpu"], ["meta"] * 4)])
def test_other_devices_need_the_mesh(attn, lanes):
    with pytest.raises(NotImplementedError, match="in rank mode, one process a rank"):
        zm.ZebraMPMD(w1(), RUN, attn, lanes)


def check_issue_order(order, sched):
    """``order`` issues every task of ``sched`` once, after all of its
    dependencies, and keeps each stream's canonical order."""
    assert sorted(order) == sorted(sched.all_tasks())
    seen = set()
    for t in order:
        assert all(d in seen for d in
                   S.dependencies(t, sched.L, sched.offload)), t
        seen.add(t)
    for name, tasks in sched.streams.items():
        assert [t for t in order if S.stream_of(t) == name] == tasks, name


@pytest.mark.parametrize("L,R,offload,Q", [
    (1, 1, None, 1), (2, 3, (0, 2), 1), (4, 2, (1, 2, 1, 2), 2),
    (5, 4, (1, 0, 0, 2, 1), 4)])
def test_issue_order_is_canonical(L, R, offload, Q):
    sched = S.canonical_schedule(L, R, offload, Q)
    check_issue_order(zm.issue_order(sched), sched)


def test_engine_issues_theorem1_schedule_and_routes_recompute_as_forward():
    """The tasks a step ran (recorded as each task's program is entered)
    are the canonical schedule in a topological order; every attn_route
    recompute of the backward routes (and packs) exactly as its forward
    did, drops included (capacity 1.25)."""
    cfg = w1(layers=3)
    eng = zm.ZebraMPMD(cfg, RUN, ["cpu"], LANES, num_microbatches=2,
                       offload=(1, 0, 1), capacity_factor=1.25, n_chunks=2)
    calls, ran = [], []
    route = eng.attn_route

    def recording(p, x, positions):
        out = route(p, x, positions)
        calls.append((torch.is_grad_enabled(), out[3], out[4]))
        return out

    def walked(key, program):
        def run(self, l, j, *rest):
            ran.append((*key, l, j))
            return program(self, l, j, *rest)
        return run
    eng.attn_route = recording
    eng._TASKS = {k: walked(k, f) for k, f in zm.ZebraMPMD._TASKS.items()}
    attn_side, exp_layers = eng.shard_params(seeded(cfg))
    eng.train_step(attn_side, exp_layers, *batch(cfg))
    sched = S.canonical_schedule(3, 2, (1, 0, 1), 2)
    check_issue_order(ran, sched)
    a_tasks = [t for t in ran if t[0] == "A"]  # one call each
    assert [c[0] for c in calls] == [t[1] == "B" for t in a_tasks]
    assert any(int(c[2][2].sum()) < c[2][2].numel() for c in calls)
    fwd = {t[2:]: c for t, c in zip(a_tasks, calls) if t[1] == "F"}
    for t, (_, idx, meta) in zip(a_tasks, calls):
        if t[1] == "B":
            _, f_idx, f_meta = fwd[t[2:]]
            assert torch.equal(idx, f_idx), t
            for a, b in zip(meta, f_meta):
                assert torch.equal(a, b), t


def test_entry_point_smoke_on_cpu(capsys):
    assert hetero_mpmd.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "planned R=4 offload=(1, 2, 1, 2)" in out
    assert "MPMD hetero run OK" in out and "step 1 loss=" in out


def test_entry_point_needs_the_card_by_default(capsys):
    assert not torch.cuda.is_available()
    assert hetero_mpmd.main(["--smoke"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_profile_finds_the_attention_stream_by_its_marker():
    """``launch/profile_mpmd``: the attention stream is the one that ran
    the marker kernel (here not the one that ran first); its overlap with
    the lanes, of all its kernels and of those other than the grouped
    GEMMs; the marker is left out of the other reports, and a profile
    without it raises."""
    from types import SimpleNamespace

    from repro_torch.launch import profile_mpmd

    def kernel(stream, a, b, name):
        return SimpleNamespace(
            device_type=torch.autograd.DeviceType.CUDA, name=name,
            device_resource_id=stream,
            time_range=SimpleNamespace(start=a, end=b))

    marker = kernel(13, 100, 101,
                    "at::cuda::(anonymous namespace)::spin_kernel(long)")
    events = [kernel(7, 0, 10, "gmm_glu_wgmma_kernel"),  # a lane, first
              kernel(13, 5, 20, "elementwise_kernel"),
              kernel(13, 20, 30, "gmm_glu_wgmma_kernel"),
              kernel(7, 25, 40, "gmm_wgmma_kernel"), marker]
    prof = SimpleNamespace(events=lambda: events)
    rep = profile_mpmd.attn_expert_overlap_ms(prof)
    assert rep["attn_stream"] == "13"
    # attention [5, 30] beside the lane's [0, 10] and [25, 40]
    assert rep["attn_expert_overlap_ms"] == pytest.approx(0.010)
    # its non-grouped [5, 20] beside [0, 10]
    assert rep["attn_nongrouped_expert_overlap_ms"] == pytest.approx(0.005)
    assert marker not in profile_mpmd._Unmarked(prof).events()
    assert len(profile_mpmd._Unmarked(prof).events()) == 4
    with pytest.raises(RuntimeError, match="marker"):
        profile_mpmd.attn_expert_overlap_ms(
            SimpleNamespace(events=lambda: events[:-1]))


def _span_set(tracer, track="zebra-mpmd"):
    """The (name, args) of every span opened on ``track``, sorted."""
    return sorted((ev.name, tuple(sorted(ev.args.items())))
                  for ev in tracer.events
                  if ev.track == track and ev.ph == "B")


@pytest.mark.parametrize("offload,n_chunks", [(None, 1), ((1, 0), 2)])
def test_traced_step_emits_jax_spans_and_the_same_bits(jax_inputs, offload,
                                                       n_chunks):
    """With the tracer on, a step opens the JAX engine's spans (the same
    (name, args) multiset on the ``zebra-mpmd`` track, pid ``train``),
    each complete (the issue order overlaps them), and computes the
    untraced step's loss and gradients bit for bit."""
    from repro.obs import trace as jtrace

    from repro_torch.obs import trace as obs_trace
    jcfg, jparams, tokens, targets = jax_inputs
    devs = jax.devices()
    jeng = JZebraMPMD(jcfg, JRUN, attn_devices=devs[:2],
                      exp_devices=devs[2:6], num_microbatches=2,
                      offload=offload, n_chunks=n_chunks)
    ja, je = jeng.shard_params(jparams)
    with jtrace.use(jtrace.Tracer()) as jtr:
        jeng.train_step(ja, je, tokens, targets)

    eng = zm.ZebraMPMD(w1(), RUN, ["cpu"], LANES, num_microbatches=2,
                       offload=offload, n_chunks=n_chunks)
    attn_side, exp_layers = eng.shard_params(
        params_from_jax(jax_values_np(jparams)))
    args = (attn_side, exp_layers, *torch_batch(tokens, targets))
    plain = eng.train_step(*args)
    with obs_trace.use(obs_trace.Tracer()) as tr:
        traced = eng.train_step(*args)
    assert _span_set(tr) == _span_set(jtr)
    assert len(_span_set(tr)) == 2 * (2 + 2 * jcfg.n_layers + 1)
    assert tr.tracks["zebra-mpmd"]["pid"] == "train"
    ends = [ev for ev in tr.events if ev.ph == "E"]
    assert len(ends) == len(_span_set(tr))
    assert all(ev.ts > tr.events[ev.parent].ts for ev in ends)
    assert torch.equal(plain[0], traced[0])
    for g0, g1 in zip(_grad_leaves(plain), _grad_leaves(traced)):
        assert torch.equal(g0, g1)


def _grad_leaves(result):
    """Every gradient tensor of a train_step result, in a fixed order."""
    _, ga, ge = result
    out = list(flatten(nonlayer(ga)).values())
    for l, layer in enumerate(ga["layers"]):
        out += list(flatten(layer).values())
        out += [lane[k] for lane in ge[l] for k in zm.EXPERT_KEYS]
    return out
