"""repro_torch's fault injection (``ft/chaos.py``) and KV transfer engine
(``serve/kv_transfer.py``) against the JAX package's.

* ``FaultPlan.parse`` gives the same specs on every entry of
  ``core.simulator.chaos_matrix()`` and raises the same ``ValueError`` on
  the malformed specs of ``tests/test_chaos.py``.
* ``FaultInjector`` driven by one seeded script of ticks, point fires and
  window probes gives the same fire sequence, event log and
  ``log_signature()`` for the same ``(seed, spec)``.
* ``KVTransferEngine.transfer`` between two paged pools (the same numpy
  pools and page ids in both packages, f32 and bf16, blocks of two pattern
  positions plus a tail layer) under the fault cases of
  ``tests/test_chaos.py`` (clean, drop, corrupt with and without
  checksums, stall, retry exhaustion by drop and by stall, both
  mid-transfer crashes): equal destination pools, equal ``TransferStats``
  field for field, the same exception with the same ``dst_state``; the
  per-chunk checksum equals the JAX one on the same payload (bf16 viewed
  as bytes).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simulator import chaos_matrix as jchaos_matrix
from repro.ft import chaos as jchaos
from repro.serve import kv_transfer as jxfer
from repro_torch.core.simulator import chaos_matrix
from repro_torch.ft import chaos
from repro_torch.serve import kv_transfer as xfer
from torch_parity import to_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

MALFORMED = ["", "  ;  ", "frobnicate*2", "drop%0", "drop%1.5", "drop*0",
             "hb_loss@2:g1~0", "drop~4", "hb_loss:g1", "hb_loss@4~2",
             "crash_start@2", "drop@@2"]


def test_chaos_matrix_is_the_jax_matrix():
    assert chaos_matrix() == jchaos_matrix()


@pytest.mark.parametrize("name,spec,seed", jchaos_matrix())
def test_parse_equals_jax_on_the_chaos_matrix(name, spec, seed):
    got = chaos.FaultPlan.parse(spec).specs
    want = jchaos.FaultPlan.parse(spec).specs
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]


@pytest.mark.parametrize("bad", MALFORMED)
def test_parse_rejects_malformed_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jchaos.FaultPlan.parse(bad)
    with pytest.raises(ValueError) as got:
        chaos.FaultPlan.parse(bad)
    assert str(got.value) == str(want.value)


def _drive(mod, spec: str, seed: int):
    """One fixed script over every site and a few targets: begin_tick,
    then fire / active at each hook point."""
    inj = mod.FaultInjector(mod.FaultPlan.parse(spec), seed=seed)
    fired = []
    rng = np.random.RandomState(seed)
    for t in range(24):
        inj.begin_tick(t)
        for _ in range(3):
            site = chaos.SITES[rng.randint(len(chaos.SITES))]
            target = ("g0", "g2", "g3", "*")[rng.randint(4)]
            if site in chaos.WINDOW_SITES:
                fired.append(("active", t, site, target,
                              inj.active(site, target)))
            else:
                fired.append(("fire", t, site, target,
                              inj.fire(site, target)))
    return fired, inj.log(), inj.log_signature()


@pytest.mark.parametrize("name,spec,seed", jchaos_matrix())
def test_injector_replay_equals_jax(name, spec, seed):
    got = _drive(chaos, spec, seed)
    assert got == _drive(jchaos, spec, seed)
    assert got == _drive(chaos, spec, seed)  # seeded replay


# ---------------------------------------------------------------------------
# The transfer engine on real pools
# ---------------------------------------------------------------------------

N_SRC, N_DST, PS, KH, HD = 10, 12, 4, 2, 8


def _pool_np(rng, n_pages, lead=()):
    return {"kv": {
        "k": rng.randn(*lead, n_pages, PS, KH, HD).astype(np.float32),
        "v": rng.randn(*lead, n_pages, PS, KH, HD).astype(np.float32),
        "pos": rng.randint(0, 99, size=(*lead, n_pages, PS))
        .astype(np.int32)}}


def _state_np(seed, n_pages):
    rng = np.random.RandomState(seed)
    return {"blocks": {"pos0": _pool_np(rng, n_pages, (2,)),
                       "pos1": _pool_np(rng, n_pages, (2,))},
            "tails": [_pool_np(rng, n_pages)]}


def _tree(tree, leaf):
    if isinstance(tree, dict):
        return {k: _tree(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, leaf) for v in tree]
    return leaf(tree)


def _as_jax(tree, bf16):
    return _tree(tree, lambda a: jnp.asarray(a).astype(jnp.bfloat16)
                 if bf16 and a.dtype == np.float32 else jnp.asarray(a))


def _as_torch(tree, bf16):
    return _tree(tree, lambda a: torch.from_numpy(a.copy()).to(
        torch.bfloat16) if bf16 and a.dtype == np.float32
        else torch.from_numpy(a.copy()))


def _np_of(tree):
    """Both packages' trees -> numpy (bf16 widened to f32)."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return to_np(x.float() if x.dtype == torch.bfloat16 else x)
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a
    return _tree(tree, leaf)


def _assert_trees_equal(got, want):
    flat_g = jxfer.jax.tree.leaves(_np_of(got))
    flat_w = jxfer.jax.tree.leaves(_np_of(want))
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w)


SRC_IDS = [3, 7, 1, 8, 0]           # five pages: two full chunks of 2 + 1
DST_IDS = [11, 2, 5, 9, 4]

CASES = [
    ("clean", None, {}),
    ("drop", "drop:g2*1", {}),
    ("corrupt", "corrupt:g2*1", {}),
    ("corrupt_unchecked", "corrupt:g2*1", {"verify_checksums": False}),
    ("stall", "stall:g2*1", {}),
    ("drop_then_corrupt", "drop:g2*1;corrupt:g2*1;stall:g2*1", {}),
    ("abort_by_drop", "drop:g2*3", {}),
    ("abort_by_stall", "stall@0:g2*3", {}),
    ("crash_mid_export", "crash_mid_export:g0", {}),
    ("crash_mid_import", "crash_mid_import:g2", {}),
    ("crash_between_chunks", "crash_mid_import:g2%0.5*1", {}),
]


def mod_chaos(mod):
    return jchaos if mod is jxfer else chaos


def _ship(mod, state_fn, spec, seed, kw, bf16):
    inj = mod_chaos(mod).FaultInjector(
        mod_chaos(mod).FaultPlan.parse(spec), seed=seed) if spec else None
    eng = mod.KVTransferEngine(chunk_pages=2, max_retries=2, timeout_s=0.5,
                               backoff_s=0.1, link_bw=1e9, latency_s=1e-3,
                               chaos=inj, **kw)
    src = state_fn(_state_np(0, N_SRC), bf16)
    dst = state_fn(_state_np(1, N_DST), bf16)
    try:
        dst = eng.transfer(src, dst, SRC_IDS, DST_IDS, dst_n_pages=N_DST,
                           src_name="g0", dst_name="g2", rid=5)
        err = None
    except (mod.TransferAbortedError, mod_chaos(mod).GroupCrashed) as e:
        err = (type(e).__name__, str(e))
        dst = e.dst_state
    return dst, dataclasses.asdict(eng.stats), err, \
        (inj.log() if inj else None)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,spec,kw", CASES, ids=[c[0] for c in CASES])
def test_transfer_equals_jax(name, spec, kw, bf16):
    got = _ship(xfer, _as_torch, spec, 7, kw, bf16)
    want = _ship(jxfer, _as_jax, spec, 7, kw, bf16)
    _assert_trees_equal(got[0], want[0])
    assert got[1] == want[1]            # TransferStats, field for field
    assert got[2] == want[2]            # the same exception, or none
    assert got[3] == want[3]            # the same faults fired
    if name == "clean":
        st = got[1]
        assert st["n_pages"] == 5 and st["n_chunks"] == 3
        # page-granular payload leaves only: [L, chunk, ps, ...] on the
        # stacked blocks, [chunk, ps, ...] on the tail
        assert sorted(set(st["shipped_shapes"])) == sorted({
            (2, 2, PS, KH, HD), (2, 2, PS), (2, PS, KH, HD), (2, PS)})
    if name == "corrupt_unchecked":  # delivered bit-flipped, unnoticed
        src = _np_of(_as_torch(_state_np(0, N_SRC), bf16))
        got_k = _np_of(got[0])["blocks"]["pos0"]["kv"]["k"]
        assert not np.array_equal(got_k[:, DST_IDS[0]],
                                  src["blocks"]["pos0"]["kv"]["k"][
                                      :, SRC_IDS[0]])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_checksum_and_corruption_equal_jax_bytes(bf16):
    src_t = _as_torch(_state_np(0, N_SRC), bf16)
    src_j = _as_jax(_state_np(0, N_SRC), bf16)
    ids = [4, 0, 9]
    pay_t = xfer.KVTransferEngine()._gather(src_t, ids)
    pay_j = jxfer.KVTransferEngine()._gather(src_j, jnp.asarray(ids))
    assert xfer._tree_crc(pay_t) == jxfer._tree_crc(pay_j)
    flip_t, flip_j = xfer._flip_bits(pay_t), jxfer._flip_bits(pay_j)
    assert xfer._tree_crc(flip_t) == jxfer._tree_crc(flip_j)
    assert xfer._tree_crc(flip_t) != xfer._tree_crc(pay_t)
    # the corruption lands on the first leaf of the JAX tree order only
    first = flip_t["blocks"]["pos0"]["kv"]["k"]
    assert not torch.equal(first, pay_t["blocks"]["pos0"]["kv"]["k"])
    assert torch.equal(flip_t["tails"][0]["kv"]["v"],
                       pay_t["tails"][0]["kv"]["v"])
