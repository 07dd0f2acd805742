"""repro_torch zebra MPMD engine across ranks (``core/zebra_mpmd_ranks.py``)
against the JAX package's ``ZebraMPMD`` on two device groups.

* Parity on gloo CPU ranks (``launch_ranks`` of
  ``torch_parity.mpmd_rank_worker``): one launch of 6 ranks (2 attention
  ranks, 4 expert lanes) against the JAX engine at devs[:2] / devs[2:6],
  the five cases of ``test_torch_zebra_mpmd.py::
  test_mpmd_engine_matches_jax`` (offload None / (1, 0), n_chunks 1 / 2,
  capacity factor 1.25 where copies drop; the 2-layer smoke W1, batch 4 x
  16, the same ``init_model`` weights); one launch of 8 ranks (4 + 4)
  against devs[:4] / devs[4:8] at batch 8 x 16, offload (1, 0), n_chunks
  2, capacity factor 1.25. Held on every rank: the loss within 1e-5;
  every leaf of grads_attn on every attention rank and each lane's expert
  gradients within rtol 1e-5, atol 1e-5 * max|ref|; each lane's forward
  chunks against the one-process engine's (the reference's chunk, row
  for row) at the same tier; the bytes of each hop, summed over the
  attention ranks, at most the reference's E_rem C d (twice that for
  C(B), which carries the cotangent and the recompute input); at
  capacity 1.25 copies of rank 1's tokens dropped because rank 0's
  filled the expert, where a pack of each rank's rows alone keeps others.
* Without ranks: the offset pack against ``_pack``, the pair sequences of
  the two sides, the refusals (on PyTorch's fake process-group backend),
  one step of an attention rank and of a lane on that backend.
"""

import json

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
from repro_torch.core import zebra_mpmd_ranks as zr
from repro_torch.core import zebra_spmd as zs
from repro_torch.models import registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten, params_from_jax
from torch_parity import (jax_values_np, mpmd_case_config, mpmd_named,
                          mpmd_rank_worker, run_beside_jax, to_np)
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRunConfig(policy=JPolicy(compute_dtype=jnp.float32),
                  moe_impl="gather")
RUN = RunConfig(policy=Policy(compute_dtype=torch.float32))
SEQ = 16


def case(name, offload, Q, cf, M=2, N=4, batch=4, **kw):
    return dict(name=name, M=M, N=N, offload=offload, Q=Q, cf=cf,
                batch=batch, **kw)


CASES = [case("none_q1", None, 1, None, trace=True),
         case("off_q1", [1, 0], 1, None), case("none_q2", None, 2, None),
         case("off_q2", [1, 0], 2, None), case("off_q2_cf", [1, 0], 2, 1.25)]
WIDE = [case("m4_off_q2_cf", [1, 0], 2, 1.25, M=4, batch=8)]


def close(got, want, name=""):
    """rtol 1e-5, atol 1e-5 * max|want|."""
    want = np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=atol,
                               err_msg=name)


def engine_args(c):
    return dict(num_microbatches=2,
                offload=tuple(c["offload"]) if c["offload"] else None,
                capacity_factor=c["cf"], n_chunks=c["Q"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine, and the one-process port engine's lane chunks,
    beside the port's ranks: ({case: reference}, {case: [rank outputs]})."""
    from repro.obs import trace as jtrace
    jcfg = mpmd_case_config(jregistry, {})
    key = jax.random.PRNGKey(0)
    jparams, _ = split_params(jstack.init_model(key, jcfg))
    values = jax_values_np(jparams)
    batches = {}
    for B in {c["batch"] for c in CASES + WIDE}:
        batches[B] = (jax.random.randint(key, (B, SEQ), 0, jcfg.vocab_size),
                      jax.random.randint(jax.random.fold_in(key, 1),
                                         (B, SEQ), 0, jcfg.vocab_size))
    inputs = {f"p|{k}": v for k, v in flatten(values).items()}
    for B, (t, g) in batches.items():
        inputs[f"tokens|{B}"], inputs[f"targets|{B}"] = (np.asarray(t),
                                                         np.asarray(g))
    params = params_from_jax(values)
    cfg = mpmd_case_config(registry, {})

    def reference(c):
        devs = jax.devices()
        M, N = c["M"], c["N"]
        jeng = JZebraMPMD(jcfg, JRUN, attn_devices=devs[:M],
                          exp_devices=devs[M:M + N], **engine_args(c))
        ja, je = jeng.shard_params(jparams)
        with jtrace.use(jtrace.Tracer()) as jtr:
            loss, jga, jge = jeng.train_step(ja, je, *batches[c["batch"]])
        spans = sorted([ev.name, sorted(ev.args.items())]
                       for ev in jtr.events
                       if ev.track == "zebra-mpmd" and ev.ph == "B")
        eng = zm.ZebraMPMD(cfg, RUN, ["cpu"], ["cpu"] * N, **engine_args(c))
        attn_side, exp_layers = eng.shard_params(params)
        lanes = {id(lane): i for layer in exp_layers
                 for i, lane in enumerate(layer)}
        chunks = {i: [] for i in range(N)}
        fwd = eng.expert_fwd

        def recording(p, buf):
            if id(p) in lanes:
                chunks[lanes[id(p)]].append(to_np(buf).copy())
            return fwd(p, buf)
        eng.expert_fwd = recording
        eng.train_step(attn_side, exp_layers,
                       *(torch.from_numpy(np.asarray(t))
                         for t in batches[c["batch"]]))
        return {"loss": float(loss), "ga": mpmd_named(jax_values_np(jga)),
                "ge": [jax_values_np(g) for g in jge], "chunks": chunks,
                "spans": json.loads(json.dumps(spans)),
                "n_att": [eng.plan.n_attn_experts(l)
                          for l in range(cfg.n_layers)],
                "lane_experts": [eng.lane_experts(l)
                                 for l in range(cfg.n_layers)],
                "C": eng.capacity(c["batch"] // 2 * SEQ),
                "C_rank": eng.capacity(c["batch"] // 2 // M * SEQ)[0]}

    narrow = tmp_path_factory.mktemp("mpmd_2x4")
    wide = tmp_path_factory.mktemp("mpmd_4x4")
    ref, per = run_beside_jax(narrow, 6, mpmd_rank_worker, CASES, inputs,
                              reference)
    ref4, per4 = run_beside_jax(wide, 8, mpmd_rank_worker, WIDE, inputs,
                                reference)
    return {**ref, **ref4}, {**per, **per4}


@pytest.mark.parametrize("c", CASES + WIDE, ids=lambda c: c["name"])
def test_ranks_match_jax(runs, c):
    """Loss, grads_attn on every attention rank, each lane's expert
    gradients and forward chunks, and the bytes of every hop."""
    ref, per = runs[0][c["name"]], runs[1][c["name"]]
    M, N = c["M"], c["N"]
    assert len(per) == M + N
    for r, out in enumerate(per):
        assert abs(float(out["loss"]) - ref["loss"]) < 1e-5, r
    for a in range(M):
        got = {k[2:]: per[a][k] for k in per[a] if k.startswith("g|")}
        assert got.keys() == ref["ga"].keys()
        for k, want in ref["ga"].items():
            close(got[k], want, f"attention rank {a} {k}")
    C, _Cq = ref["C"]
    d = 128
    for l, (n_att, El) in enumerate(zip(ref["n_att"], ref["lane_experts"])):
        for i in range(N):
            out = per[M + i]
            lo = i * El  # the JAX engine's expert side holds [n_att, E)
            for k in zm.EXPERT_KEYS:
                close(out[f"e|{l}|{k}"], ref["ge"][l][k][lo:lo + El],
                      f"lane {i} layer {l} {k}")
        rem = (El * N) * C * d * 4
        for j in range(2):
            for kind, lanes_back in (("F", "Fb"), ("B", "Bb")):
                sent = sum(int(per[a].get(f"hop|{kind}|{l}|{j}", 0))
                           for a in range(M))
                back = sum(int(per[M + i].get(f"hop|{lanes_back}|{l}|{j}",
                                              0)) for i in range(N))
                assert sent <= rem * (2 if kind == "B" else 1), (kind, l, j)
                assert back * (2 if kind == "B" else 1) == sent, (l, j)
    for i in range(N):
        got = [per[M + i][f"chunk|{n}"] for n in range(len(
            [k for k in per[M + i] if k.startswith("chunk|")]))]
        assert len(got) == len(ref["chunks"][i]) > 0
        for n, (g, w) in enumerate(zip(got, ref["chunks"][i])):
            assert g.shape == w.shape
            close(g, w, f"lane {i} chunk {n}")


def test_drops_cross_the_rank_boundary(runs):
    """At capacity 1.25 (2 + 4 ranks, C 16) some copy of rank 1's tokens
    is dropped because rank 0's copies filled the expert, though rank 1's
    own copies fit in it, and packs of each rank's rows alone (at the
    capacity of its rows, 8) would keep other copies. Both attention
    ranks read the same counts."""
    ref, per = runs[0]["off_q2_cf"], runs[1]["off_q2_cf"]
    C, C_rank = ref["C"][0], ref["C_rank"]
    across, other = False, False
    for key in [k for k in per[0] if k.startswith("routed|")]:
        counts = np.asarray(per[0][key])  # [M, E]
        assert np.array_equal(per[1][key], counts)
        off = np.cumsum(counts, 0) - counts
        kept = np.clip(C - off, 0, counts)
        across |= bool(((off[1] > 0) & (kept[1] < counts[1])
                        & (counts[1] <= C)).any())
        other |= bool((np.minimum(counts, C_rank) != kept).any())
    assert across and other


def test_rank0_emits_the_reference_spans(runs):
    """Rank 0's traced step opens the JAX engine's spans (names and
    args) on the ``zebra-mpmd`` track; no other rank traces."""
    ref, per = runs[0]["none_q1"], runs[1]["none_q1"]
    spans = json.loads(str(per[0]["spans"]))
    assert spans == ref["spans"]
    assert len(spans) == 2 * (2 + 2 * 2 + 1)
    assert all(json.loads(str(out["spans"])) == [] for out in per[1:])


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------

def test_pack_at_zero_offsets_is_pack():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(40, 16, generator=g)
    idx = torch.randint(0, 8, (40, 2), generator=g)
    want = zs._pack(x, idx, 8, 8)
    got = zs._pack_at(x, idx, 8, 8, torch.zeros(8, dtype=torch.int64))
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def test_pack_at_blocks_keep_the_whole_pack():
    """Blocks of a batch packed in turn, each from the slots where the
    earlier blocks' copies end, keep the copies one pack keeps, in its
    slots: the sum of the blocks' buffers is its buffer, bit for bit."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(48, 16, generator=g)
    idx = torch.randint(0, 8, (48, 2), generator=g)
    whole = zs._pack(x, idx, 8, 8)
    total, off, kept = torch.zeros_like(whole[0]), torch.zeros(8).long(), 0
    for blk in torch.arange(48).split([10, 14, 24]):
        buf, meta = zs._pack_at(x[blk], idx[blk], 8, 8, off)
        total += buf
        kept += int(meta[2].sum())
        off = off + torch.bincount(idx[blk].reshape(-1), minlength=8)
    assert torch.equal(total, whole[0])
    assert kept == int(whole[1][2].sum()) < 96


@pytest.mark.parametrize("offload,Q", [(None, 1), ((1, 0), 1), (None, 2),
                                       ((1, 0), 2)])
def test_pair_sequence_is_the_same_on_both_sides(offload, Q):
    """The messages an attention rank posts with a lane and those the lane
    posts with it, each derived from the issue order, pair up in order (a
    send against a receive); every message is posted at or after the
    task that makes its data, and each hop's data after its header."""
    L, R = 2, 2
    sched = S.canonical_schedule(L, R, offload, Q)
    order = zm.issue_order(sched)
    n_att = [0, 0] if offload is None else [o * 4 for o in offload]
    live = [8 - n > 0 for n in n_att]
    attn = zr.side_messages(order, Q, live, "attn")
    lane = zr.side_messages(order, Q, live, "lane")
    swap = {"send": "recv", "recv": "send"}
    assert [(swap[op], *rest) for op, *rest in attn] == lane
    kinds = [m[1:4] for m in attn]
    assert len(attn) == L * R * (1 + 4 * Q)
    for l in range(L):
        for j in range(R):
            seq = [k for k, ll, jj in kinds if (ll, jj) == (l, j)]
            assert seq == ["hdr"] + ["F"] * Q + ["Fb"] * Q + ["B"] * Q \
                + ["Bb"] * Q


@pytest.fixture
def fake_world():
    """Join PyTorch's fake process-group backend (collectives and
    point-to-point messages launched, moving no data) as ``rank`` of
    ``world``; left again after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(rank, world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


def test_ranks_must_fill_the_world(fake_world):
    fake_world(0, 3)
    with pytest.raises(ValueError, match="need 4 ranks; the process group "
                                         "has 3"):
        zr.RankGroups(2, 2, "cpu")


def test_microbatch_rows_must_split_over_the_attention_ranks(fake_world):
    fake_world(0, 3)
    cfg = mpmd_case_config(registry, {})
    eng = zr.ZebraMPMDRanks(cfg, RUN, zr.RankGroups(2, 1, "cpu"),
                            offload=(2, 0))
    tokens = torch.zeros(6, SEQ, dtype=torch.long)
    with pytest.raises(ValueError, match="do not split over 2 attention"):
        eng.train_step(None, None, tokens, tokens)


@pytest.mark.parametrize("rank", [0, 4])
def test_one_rank_steps_on_the_fake_backend(fake_world, monkeypatch, rank):
    """What ``chip_smoke.py``'s ``mpmd_ranks:`` runs on the card, at
    smoke size: attention rank 0 or lane 0 of 4x4 alone, its receives
    zeroed. The attention rank routes its 1 row a microbatch and runs no
    expert at a lane's shape; the lane runs each of its chunks; the loss
    is finite."""
    fake_world(rank, 8)
    cfg = mpmd_case_config(registry, {})
    eng = zr.ZebraMPMDRanks(cfg, RUN, zr.RankGroups(4, 4, "cpu"),
                            offload=(1, 0), n_chunks=2)
    shapes = {"attn": [], "experts": []}
    mixer, dense = zm.modules.apply_mixer_part, zs._experts_dense

    def attention(p, cfg_, run, spec, x, *a, **kw):
        shapes["attn"].append(tuple(x.shape))
        return mixer(p, cfg_, run, spec, x, *a, **kw)

    def experts(wg, wu, wo, buf, cd):
        shapes["experts"].append(tuple(buf.shape))
        return dense(wg, wu, wo, buf, cd)
    monkeypatch.setattr(zm.modules, "apply_mixer_part", attention)
    monkeypatch.setattr(zs, "_experts_dense", experts)
    attn_side, exp_layers = eng.shard_params(
        stack.init_model(torch.Generator().manual_seed(0), cfg))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, SEQ), generator=g)
    loss, ga, ge = eng.train_step(attn_side, exp_layers, tokens, tokens)
    assert torch.isfinite(loss)
    C, Cq = eng.capacity(4 * SEQ)
    lane_shapes = {(eng.lane_experts(l), Cq, cfg.d_model) for l in range(2)}
    if rank == 0:
        assert ge is None and set(shapes["attn"]) == {(1, SEQ, cfg.d_model)}
        assert not lane_shapes & set(shapes["experts"])
        # layer 0's offloaded experts, a forward and a recompute a
        # microbatch, in the rank's own capacity
        assert len(shapes["experts"]) == 2 * 2
        assert all(s[0] == 4 and s[1] < C for s in shapes["experts"])
    else:
        assert ga is None and not shapes["attn"]
        # a forward and a recompute a chunk, microbatch and layer
        assert sorted(shapes["experts"]) == sorted(
            [(eng.lane_experts(l), Cq, cfg.d_model)
             for l in range(2) for _ in range(2 * 2 * 2)])
        assert len(ge) == 2 and len(ge[0]) == 1


def test_entry_point_runs_the_example_layout_on_cpu_ranks(capfd):
    """``hetero_mpmd --smoke --device cpu --ranks 4x4``: 8 gloo ranks;
    rank 0 prints the loss and each rank's role and experts, and the loss
    is the one-process engine's."""
    from repro_torch.launch import hetero_mpmd
    assert hetero_mpmd.main(["--smoke", "--device", "cpu"]) == 0
    one = capfd.readouterr().out
    assert hetero_mpmd.main(["--smoke", "--device", "cpu", "--ranks",
                             "4x4"]) == 0
    out = capfd.readouterr().out
    assert "ranks=4x4" in out and "MPMD hetero run OK" in out
    assert "rank 3: attention, rows block 3 of 4" in out
    assert "rank 7: lane 3, experts by layer [7,8) [8,8) [7,8) [8,8)" in out

    def loss(text):
        return next(line for line in text.splitlines()
                    if line.startswith("disaggregated loss"))
    assert loss(out) == loss(one)
