"""The Zipf source: the same seed gives the same batches, another seed
others, and the ids follow p(r) ∝ r^-s."""

import numpy as np

from perfbench import gen

MIX = {"batch": 8, "seq": 512, "tokens": {"law": "zipf", "s": 1.0}}


def test_deterministic_per_seed():
    a = gen.batches(MIX, 1000, 2 ** 33 + 5, 3)
    b = gen.batches(MIX, 1000, 2 ** 33 + 5, 3)
    c = gen.batches(MIX, 1000, 2 ** 33 + 6, 3)
    for x, y in zip(a, b):
        assert all((x[k] == y[k]).all() for k in x)
    assert not (a[0]["tokens"] == c[0]["tokens"]).all()
    assert not (a[0]["tokens"] == a[1]["tokens"]).all()


def test_targets_are_the_next_token():
    (b,) = gen.batches(MIX, 1000, 3, 1)
    assert b["tokens"].shape == (8, 512) and b["tokens"].dtype.is_signed
    assert (b["tokens"][:, 1:] == b["targets"][:, :-1]).all()


def test_follows_the_law():
    V, s = 200, 1.0
    mix = dict(MIX, tokens={"law": "zipf", "s": s})
    ids = np.concatenate([b["tokens"].numpy().ravel()
                          for b in gen.batches(mix, V, 9, 40)])
    counts = np.bincount(ids, minlength=V)
    freq = np.sort(counts)[::-1] / counts.sum()
    p = gen.rank_probs(V, s)
    # the top ranks within 5 standard errors of their probability
    n = counts.sum()
    se = np.sqrt(p[:10] * (1 - p[:10]) / n)
    assert (np.abs(freq[:10] - p[:10]) < 5 * se).all()
    # the rank-1 id holds about 1 / H_V of the tokens
    assert abs(freq[0] - 1 / np.sum(1 / np.arange(1, V + 1))) < 0.01
