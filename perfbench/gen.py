"""The one traffic generator: a training job's batches from the mix's
parameters (``traffic/<name>.json``) and ``--seed``.

Token ids follow a rank-frequency law p(r) ∝ r^-s over the vocabulary
(``"law": "zipf"``; real text is Zipfian, and frequent ids load a few
experts, so capacity drops and ragged expert groups show); the seed draws
the permutation that maps rank to id and every batch. Each batch is
``batch`` rows of ``seq + 1`` ids: ``tokens`` the first ``seq``,
``targets`` the next-token shift, int32 on the host, as the port's data
pipeline makes them. The same seed gives the same batches on any machine
(numpy's PCG64)."""

from __future__ import annotations

import numpy as np
import torch


def rank_probs(vocab: int, s: float) -> np.ndarray:
    """p(r) ∝ r^-s for ranks r = 1..vocab, in f64."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


def batches(traffic: dict, vocab: int, seed: int, n: int) -> list:
    """``n`` batches {"tokens", "targets"} [batch, seq] int32 of the mix."""
    law = traffic["tokens"]
    if law["law"] != "zipf":
        raise ValueError(f"unknown token law {law['law']!r}")
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    rank_to_id = rng.permutation(vocab)
    cdf = np.cumsum(rank_probs(vocab, law["s"]))
    B, S = int(traffic["batch"]), int(traffic["seq"])
    out = []
    for _ in range(n):
        u = rng.random((B, S + 1))
        ranks = np.minimum(np.searchsorted(cdf, u, side="right"), vocab - 1)
        ids = rank_to_id[ranks].astype(np.int32)
        out.append({"tokens": torch.from_numpy(ids[:, :-1].copy()),
                    "targets": torch.from_numpy(ids[:, 1:].copy())})
    return out
