"""The serving mesh's tensor-parallel plans (``serve.mesh.TPPlan``) module
by module, without ranks: M simulated model ranks run in one process, one
thread each, over a stub of ``torch.distributed`` that exchanges their
tensors in memory (:class:`_Ranks`), each on its cut of the weights
(``TPPlan.needs``) and its ``ShardContext``; their results, summed over
"model" by the stub's collectives, are held against the JAX package's
module computed whole on the same seed-0 JAX init and numpy inputs, f32,
within 1e-5 * max|JAX|:

* ``apply_attention`` with a dense cache split by line over the ranks
  (decode, a chunk attending to the cache, a whole-sequence prefill
  writing it) and with a paged pool split by page (decode), at H 4 over
  3 ranks (q heads 2, 2, 0: one rank without a head still holds cache
  lines) and 2, KH 2 and KH 1 (recurrentgemma's local attention); the
  y summed over the ranks and every rank's cache block;
* ``apply_mlp``, SwiGLU (llama) and GELU with biases (whisper), d_ff 256
  over 3 ranks (86, 86, 84) and 2;
* ``apply_rglru`` with a state, its channels over 2 and 4 ranks: y and
  each rank's block of the new ``conv`` and ``lru``;
* ``apply_ssd`` with a state, its heads over 2 and 4 ranks (one token and
  a chunk): y, each rank's ``ssm`` block and the whole new ``conv``;
* the vocabulary: the embedding lookup and the logits, vocab 256 over 3
  ranks (86, 86, 84) and 2;
* ``collectives.fetch``, the regroup of a dim stored in equal blocks into
  the ranges each rank computes with (24 heads over 16 ranks; ranges that
  overlap, are empty or come in several pieces): exactly those entries.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import modules as jm
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.models.modules import Policy as JPolicy
from repro.models.modules import RunConfig as JRun
from repro.pytree import split_params
from repro_torch.models import modules, registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import params_from_jax
from repro_torch.serve.mesh import TPPlan
from repro_torch.sharding.rules import MeshShape
from repro_torch.train.step import ShardContext
from torch_parity import jax_values_np, to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

JRUN = JRun(policy=JPolicy(compute_dtype=jnp.float32))
REL = 1e-5


class _Ranks:
    """A process group of ``M`` simulated ranks, one thread each: a
    collective hands every rank the tensors all of them passed in."""

    def __init__(self, M: int):
        self.M = M
        self.bar = threading.Barrier(M, timeout=120)
        self.slots = [None] * M
        self.local = threading.local()

    @property
    def rank(self) -> int:
        return self.local.rank

    def exchange(self, x):
        self.slots[self.rank] = x
        self.bar.wait()
        got = list(self.slots)
        self.bar.wait()
        return got


@pytest.fixture
def stub_dist(monkeypatch):
    """``torch.distributed``'s collectives on :class:`_Ranks` groups."""
    def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
        got = group.exchange(t.clone())
        out = got[0].clone()
        for g in got[1:]:
            out = torch.maximum(out, g) if op == dist.ReduceOp.MAX \
                else out + g
        t.copy_(out)

    def all_gather(parts, t, group=None):
        for p, g in zip(parts, group.exchange(t.clone())):
            p.copy_(g)

    def reduce_scatter(out, chunks, group=None):
        got = group.exchange([c.clone() for c in chunks])
        s = got[0][group.rank].clone()
        for g in got[1:]:
            s = s + g[group.rank]
        out.copy_(s)

    def all_to_all_single(out, inp, output_split_sizes=None,
                          input_split_sizes=None, group=None):
        sizes = input_split_sizes or [inp.shape[0] // group.M] * group.M
        got = group.exchange(list(inp.split(list(sizes), 0)))
        out.copy_(torch.cat([g[group.rank] for g in got], 0))

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter),
                     ("all_to_all_single", all_to_all_single),
                     ("get_world_size", lambda group=None: group.M),
                     ("get_rank", lambda group=None: group.rank)):
        monkeypatch.setattr(dist, name, fn)


def run_ranks(M: int, fn) -> list:
    """[fn(rank, group) for each of M simulated ranks], run at once."""
    group, out, errors = _Ranks(M), [None] * M, []

    def body(r):
        group.local.rank = r
        try:
            out[r] = fn(r, group)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            group.bar.abort()
    threads = [threading.Thread(target=body, args=(r,)) for r in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _close(got, want, rel=REL):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


_MODELS = {}


def _model(arch: str):
    """(JAX cfg, port cfg, JAX params, port params) of an arch's smoke
    config, seed-0 JAX init."""
    if arch not in _MODELS:
        jcfg = jreg.smoke_config(jreg.get_config(arch))
        cfg = registry.smoke_config(registry.get_config(arch))
        jp = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
        _MODELS[arch] = (jcfg, cfg, jp, params_from_jax(jax_values_np(jp)))
    return _MODELS[arch]


def _plan(cfg, M: int, r: int, group, rec=None) -> TPPlan:
    mesh = MeshShape((1, M), ("data", "model"))
    mesh.coords = {"data": 0, "model": r}
    return TPPlan(cfg, mesh, group, rec or {})


def _ctx(tp: TPPlan, r: int, group, lines=0, pages=0) -> ShardContext:
    """Rank r's ``ShardContext``, its plans' fields as
    ``ServeLayout.context`` gives them."""
    return ShardContext(**tp.fields(), kv_group=group, kv_rank=r,
                        kv_size=tp.M, kv_lines=lines, kv_pages=pages)


def _cut(cfg, tp: TPPlan, r: int, prefix: str, tree):
    """Rank r's cut of one layer's leaves at ``prefix`` (whole leaves
    stored, sliced as ``ServeLayout`` slices a leaf stored whole)."""
    flat = stack.flat_param_specs(cfg)
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        axes = flat[path].axes
        if path.startswith("blocks/"):
            axes = axes[1:]
        nd = tp.needs(path, axes)
        if nd is None:
            out[k] = v
            continue
        d, needs = nd
        rs = needs[r] or ((0, 0),)
        out[k] = torch.cat([v.narrow(d, a, b - a) for a, b in rs], d)
    return out


def _layer(params, sub: str):
    return {k: v[0] for k, v in params["blocks"]["pos0"][sub].items()}


def _run(ctx):
    return RunConfig(policy=Policy(compute_dtype=torch.float32), shard=ctx)


def _np(rng, *shape, scale=0.5):
    return (scale * rng.randn(*shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Attention with a cache
# ---------------------------------------------------------------------------

# H 4: over 3 (one rank without a head), 2, and 6 (fewer heads than
# ranks: each rank attends whole over its lines, nothing summed)
ATTN = [("llama3.2-3b", "attn", 3), ("llama3.2-3b", "attn", 2),
        ("recurrentgemma-9b", "local_attn", 3), ("llama3.2-3b", "attn", 6)]
C_LINES, B = 12, 2


def _attn_layer(arch):
    jcfg, cfg, jp, tp = _model(arch)
    pos = [i for i, s in enumerate(cfg.pattern)
           if s.mixer in ("attn", "local_attn")][0]
    jl = {k: v[0] for k, v in jp["blocks"][f"pos{pos}"]["mixer"].items()}
    tl = {k: v[0] for k, v in tp["blocks"][f"pos{pos}"]["mixer"].items()}
    return jcfg, cfg, jl, tl, f"blocks/pos{pos}/mixer"


def _dense_cache(cfg, rng, filled):
    """A dense cache of C_LINES lines whose first filled[b] lines of row
    b hold random keys at their positions."""
    k = _np(rng, B, C_LINES, cfg.n_kv_heads, cfg.head_dim)
    v = _np(rng, B, C_LINES, cfg.n_kv_heads, cfg.head_dim)
    pos = np.full((B, C_LINES), -1, np.int32)
    for b, n in enumerate(filled):
        pos[b, :n] = np.arange(n)
    live = (pos >= 0)[..., None, None]
    return {"k": k * live, "v": v * live, "pos": pos}


@pytest.mark.parametrize("arch,mixer,M", ATTN,
                         ids=[f"{a}-{m}-{M}" for a, m, M in ATTN])
@pytest.mark.parametrize("mode", ["decode", "chunk", "prefill"])
def test_attention_dense_cache_split(stub_dist, arch, mixer, M, mode):
    jcfg, cfg, jl, tl, prefix = _attn_layer(arch)
    window = cfg.window if mixer == "local_attn" else 0
    rng = np.random.RandomState(7)
    if mode == "decode":
        S, filled = 1, [5, 9]
        ci = np.array(filled, np.int32)
        positions = ci[:, None]
    elif mode == "chunk":
        S, filled = 4, [3, 3]
        ci = 3
        positions = np.broadcast_to(np.arange(3, 7), (B, S))
    else:
        S, filled, ci = 6, [0, 0], 0
        positions = np.broadcast_to(np.arange(S), (B, S))
    cache = _dense_cache(cfg, rng, filled)
    x = _np(rng, B, S, cfg.d_model)
    positions = np.ascontiguousarray(positions, np.int32)
    att = mode == "chunk"
    y_want, c_want = jm.apply_attention(
        jax.tree_util.tree_map(jnp.asarray, jl), jcfg, JRUN, jnp.asarray(x),
        jnp.asarray(positions), causal=True, window=window,
        cache={k: jnp.asarray(v) for k, v in cache.items()},
        cache_index=jnp.asarray(ci), attend_to_cache=att)
    per = C_LINES // M

    def rank(r, group):
        tp = _plan(cfg, M, r, group)
        sh = _ctx(tp, r, group, lines=C_LINES)
        blk = {k: torch.from_numpy(v[:, r * per:(r + 1) * per].copy())
               for k, v in cache.items()}
        y, _ = modules.apply_attention(
            _cut(cfg, tp, r, prefix, tl), cfg, _run(sh),
            torch.from_numpy(x), torch.from_numpy(positions), causal=True,
            window=window, cache=blk,
            cache_index=torch.as_tensor(ci), attend_to_cache=att)
        return sh.attn_reduce(y), blk
    outs = run_ranks(M, rank)
    for y, _ in outs:
        _close(y, y_want)
    for n in ("k", "v", "pos"):
        got = np.concatenate([to_np(blk[n]) for _, blk in outs], 1)
        np.testing.assert_allclose(got, np.asarray(c_want[n]), rtol=0,
                                   atol=REL * float(np.abs(
                                       np.asarray(c_want[n])).max() or 1))


@pytest.mark.parametrize("arch,mixer,M", ATTN,
                         ids=[f"{a}-{m}-{M}" for a, m, M in ATTN])
def test_attention_paged_decode_split(stub_dist, arch, mixer, M):
    jcfg, cfg, jl, tl, prefix = _attn_layer(arch)
    window = cfg.window if mixer == "local_attn" else 0
    rng = np.random.RandomState(11)
    P, ps = 6, 4
    pool = {"k": _np(rng, P, ps, cfg.n_kv_heads, cfg.head_dim),
            "v": _np(rng, P, ps, cfg.n_kv_heads, cfg.head_dim),
            "pos": np.full((P, ps), -1, np.int32)}
    table = np.array([[4, 1, -1], [2, 5, 0]], np.int32)
    filled = [6, 9]  # lines written before this step
    for b, n in enumerate(filled):
        for p in range(n):
            pool["pos"][table[b, p // ps], p % ps] = p
    ci = np.array(filled, np.int32)
    positions = ci[:, None].copy()
    x = _np(rng, B, 1, cfg.d_model)
    y_want, c_want = jm.apply_attention(
        jax.tree_util.tree_map(jnp.asarray, jl), jcfg, JRUN, jnp.asarray(x),
        jnp.asarray(positions), causal=True, window=window,
        cache={k: jnp.asarray(v) for k, v in pool.items()},
        cache_index=jnp.asarray(ci), page_table=jnp.asarray(table))
    per = P // M

    def rank(r, group):
        tp = _plan(cfg, M, r, group)
        sh = _ctx(tp, r, group, pages=P)
        blk = {k: torch.from_numpy(v[r * per:(r + 1) * per].copy())
               for k, v in pool.items()}
        y, _ = modules.apply_attention(
            _cut(cfg, tp, r, prefix, tl), cfg, _run(sh),
            torch.from_numpy(x), torch.from_numpy(positions), causal=True,
            window=window, cache=blk, cache_index=torch.from_numpy(ci),
            page_table=torch.from_numpy(table))
        return sh.attn_reduce(y), blk
    outs = run_ranks(M, rank)
    for y, _ in outs:
        _close(y, y_want)
    for n in ("k", "v", "pos"):
        got = np.concatenate([to_np(blk[n]) for _, blk in outs], 0)
        np.testing.assert_allclose(got, np.asarray(c_want[n]), rtol=0,
                                   atol=REL * float(np.abs(
                                       np.asarray(c_want[n])).max() or 1))


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

MLP = [(a, M) for M in (3, 2) for a in ("llama3.2-3b", "whisper-tiny")] + \
    [("llama3.2-3b", 8)]  # H 4 < 8 <= d_ff: the FFN split, heads whole


@pytest.mark.parametrize("arch,M", MLP, ids=[f"{M}-{a}" for a, M in MLP])
def test_mlp_split(stub_dist, arch, M):
    jcfg, cfg, jp, tp_params = _model(arch)
    jl, tl = _layer(jp, "ffn"), _layer(tp_params, "ffn")
    if "bi" in jl:  # nonzero biases, so the split adds bo once
        rng = np.random.RandomState(3)
        for k in ("bi", "bo"):
            b = _np(rng, *jl[k].shape)
            jl[k], tl[k] = jnp.asarray(b), torch.from_numpy(b)
    x = _np(np.random.RandomState(5), B, 5, cfg.d_model)
    want = jm.apply_mlp(jl, jcfg, JRUN, jnp.asarray(x))
    widths = []

    def rank(r, group):
        tp = _plan(cfg, M, r, group)
        p = _cut(cfg, tp, r, "blocks/pos0/ffn", tl)
        widths.append(p["wo"].shape[0])
        return modules.apply_mlp(p, cfg, _run(_ctx(tp, r, group)),
                                 torch.from_numpy(x))
    for y in run_ranks(M, rank):
        _close(y, want)
    F = cfg.d_ff
    assert sorted(widths) == sorted(
        min((r + 1) * -(-F // M), F) - min(r * -(-F // M), F)
        for r in range(M))


# ---------------------------------------------------------------------------
# Recurrent mixers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("S", [1, 5])
def test_rglru_split(stub_dist, M, S):
    jcfg, cfg, jp, tp_params = _model("recurrentgemma-9b")
    jl, tl = _layer(jp, "mixer"), _layer(tp_params, "mixer")
    rng = np.random.RandomState(S)
    w = cfg.lru_width
    st = {"conv": _np(rng, B, cfg.conv_width - 1, w),
          "lru": _np(rng, B, w)}
    x = _np(rng, B, S, cfg.d_model)
    y_want, s_want = jm.apply_rglru(
        jl, jcfg, JRUN, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    n = w // M

    def rank(r, group):
        tp = _plan(cfg, M, r, group,
                   {"blocks/pos0": ("rglru", r * n, (r + 1) * n, w)})
        state = {"conv": torch.from_numpy(st["conv"][..., r * n:(r + 1) * n]
                                          .copy()),
                 "lru": torch.from_numpy(st["lru"][:, r * n:(r + 1) * n]
                                         .copy()),
                 "tp": (r * n, (r + 1) * n, group)}
        return modules.apply_rglru(_cut(cfg, tp, r, "blocks/pos0/mixer", tl),
                                   cfg, _run(_ctx(tp, r, group)),
                                   torch.from_numpy(x), state)
    outs = run_ranks(M, rank)
    for y, _ in outs:
        _close(y, y_want)
    for k, d in (("conv", 2), ("lru", 1)):
        _close(torch.cat([s[k] for _, s in outs], d), s_want[k])


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("S", [1, 5])
def test_ssd_split(stub_dist, M, S):
    jcfg, cfg, jp, tp_params = _model("mamba2-2.7b")
    jl, tl = _layer(jp, "mixer"), _layer(tp_params, "mixer")
    rng = np.random.RandomState(20 + S)
    din = cfg.ssm_expand * cfg.d_model
    nh, ns = cfg.ssm_heads, cfg.ssm_state
    hd = din // nh
    st = {"conv": _np(rng, B, cfg.conv_width - 1, din + 2 * ns),
          "ssm": _np(rng, B, nh, hd, ns)}
    x = _np(rng, B, S, cfg.d_model)
    y_want, s_want = jm.apply_ssd(
        jl, jcfg, JRUN, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    n = nh // M

    def rank(r, group):
        tp = _plan(cfg, M, r, group,
                   {"blocks/pos0": ("ssd", r * n, (r + 1) * n, nh)})
        state = {"conv": torch.from_numpy(st["conv"]),
                 "ssm": torch.from_numpy(st["ssm"][:, r * n:(r + 1) * n]
                                         .copy()),
                 "tp": (r * n, (r + 1) * n, group)}
        return modules.apply_ssd(_cut(cfg, tp, r, "blocks/pos0/mixer", tl),
                                 cfg, _run(_ctx(tp, r, group)),
                                 torch.from_numpy(x), state)
    outs = run_ranks(M, rank)
    for y, s in outs:
        _close(y, y_want)
        _close(s["conv"], s_want["conv"])
    _close(torch.cat([s["ssm"] for _, s in outs], 1), s_want["ssm"])


# ---------------------------------------------------------------------------
# The vocabulary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [3, 2])
def test_vocab_split(stub_dist, M):
    jcfg, cfg, jp, tp_params = _model("llama3.2-3b")
    rng = np.random.RandomState(9)
    tokens = rng.randint(0, cfg.vocab_size, (B, 7)).astype(np.int32)
    x = _np(rng, B, 7, cfg.d_model)
    pol = JRUN.policy
    e_want = jm.apply_embedding(jp["embed"], jcfg, pol, jnp.asarray(tokens))
    l_want = jm.apply_unembedding(jp["embed"], jp.get("lm_head"), jcfg, pol,
                                  jnp.asarray(x))

    def rank(r, group):
        tp = _plan(cfg, M, r, group)
        table = _cut(cfg, tp, r, "embed", {"table": tp_params["embed"]
                                           ["table"]})
        pol_t = Policy(compute_dtype=torch.float32)
        e = modules.apply_embedding(table, cfg, pol_t,
                                    torch.from_numpy(tokens),
                                    vocab=tp.vocab)
        blk = modules.unembed_block(table, None, pol_t, torch.from_numpy(x))
        return e, blk.shape[-1], modules.apply_unembedding(
            table, None, cfg, pol_t, torch.from_numpy(x), vocab=tp.vocab)
    outs = run_ranks(M, rank)
    V = cfg.vocab_size
    b = -(-V // M)
    assert [n for _, n, _ in outs] == [min((r + 1) * b, V) - min(r * b, V)
                                       for r in range(M)]
    for e, _, lg in outs:
        _close(e, e_want)
        _close(lg, l_want)


# ---------------------------------------------------------------------------
# The regroup of stored blocks (collectives.fetch)
# ---------------------------------------------------------------------------

FETCH_NEEDS = [
    # 24 heads of 4 over 16 ranks: blocks of 2 heads, the last 4 empty
    (16, 96, [((8 * r, 8 * r + 8),) if r < 12 else () for r in range(16)]),
    # kv heads read by overlapping ranks, multi-range segments, a rank
    # that needs its own block exactly
    (4, 40, [((0, 10),), ((0, 3), (12, 18), (38, 40)), ((20, 30),),
             ((5, 7), (25, 35))]),
]


@pytest.mark.parametrize("M,n,needs", FETCH_NEEDS, ids=["heads", "ragged"])
def test_fetch_regroups_stored_blocks(stub_dist, M, n, needs):
    from repro_torch.sharding import collectives as C
    full = torch.arange(3 * n, dtype=torch.float32).reshape(3, n)
    blk = n // M

    def rank(r, group):
        return C.fetch(full[:, r * blk:(r + 1) * blk], 1, group,
                       tuple(tuple(x) for x in needs))
    for r, got in enumerate(run_ranks(M, rank)):
        want = torch.cat([full[:, a:b] for a, b in needs[r]], 1) \
            if needs[r] else full[:, :0]
        assert torch.equal(got, want), r


# ---------------------------------------------------------------------------
# A rank of a mesh with fewer heads than model ranks (the fake backend)
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_rank():
    """Join PyTorch's fake process-group backend (collectives launched,
    no data moved) as ``rank`` of ``world``; left again after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(rank, world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


CENSUS = [("llama3.2-3b", ["--paged"]), ("llama3.2-3b", []),
          ("whisper-tiny", [])]


@pytest.mark.parametrize("arch,extra", CENSUS,
                         ids=[a + "".join(e) for a, e in CENSUS])
def test_census_fewer_heads_than_ranks(fake_rank, arch, extra):
    """Model rank 1 of a 1x8 serving mesh, where H 4 < 8 <= d_ff 256 and
    the vocabulary 256 (smoke configs), served on the fake backend: the
    census shows every attention call on every head (whole: no head
    plan), every dense FFN call at its 32 columns and summed over "model"
    by one collective (whisper's encoder and decoder alike), the logits
    at their 32 columns. The tokens are not checked: no data moves."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.census import serve_census
    fake_rank(1, 8)
    mesh = make_mesh((1, 8), ("data", "model"), "cpu")
    args = serve_mod.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--mesh", "1x8",
         "--requests", "2", "--gen", "3", *extra])
    with serve_census() as rec:
        serve_mod.serve_arch(arch, args, mesh=mesh)
    cfg = registry.smoke_config(registry.get_config(arch))
    assert cfg.n_heads < 8 <= cfg.d_ff
    assert {tuple(a) for a in rec["attn"]} == {(cfg.n_heads,
                                                cfg.n_kv_heads)}
    assert set(rec["ffn"]) == {cfg.d_ff // 8}
    assert set(rec["ffn_sums"]) == {1}
    assert set(rec["vocab"]) == {cfg.vocab_size // 8}
