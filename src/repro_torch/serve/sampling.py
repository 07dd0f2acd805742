"""Batched token sampling for the serving engine (DESIGN.md §7.4).

One fused sampler covers greedy, temperature, top-k and nucleus (top-p)
sampling: every slot selects its own behaviour from per-slot parameter
vectors, so a batch mixing greedy and sampled requests decodes in one
call.

Determinism contract (as in the JAX package): the random numbers for
request ``rid``'s ``n``-th generated token are a function of
(seed, rid, n) ONLY, so sampling is independent of batch composition, slot
assignment, prefill chunking and preemption. The JAX key schedule
``fold_in(fold_in(base, rid), n)`` cannot be reproduced in torch; the port
seeds one ``torch.Generator`` per (seed, rid, n) instead
(:func:`request_seed`). Greedy decoding (``argmax``, first maximum in both
frameworks) is token-exact against the JAX package; sampled decoding is
deterministic within the port.
"""

from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (0 / 1.0 = disabled)."""

    temperature: float = 0.0  # <= 0 -> greedy (argmax)
    top_k: int = 0            # 0 -> no top-k cut
    top_p: float = 1.0        # 1.0 -> no nucleus cut


GREEDY = SamplingParams()


def _mix(x: int) -> int:
    """splitmix64 finalizer: a bijective 64-bit avalanche."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_seed(seed: int, rid: int, n: int) -> int:
    """The generator seed of request ``rid``'s ``n``-th sampled token."""
    return _mix(_mix(_mix(seed) ^ (rid & _MASK64)) ^ (n & _MASK64)) >> 1


def request_noise(seed: int, rids, n_generated, sampled, vocab: int,
                  device) -> torch.Tensor:
    """Gumbel noise [B, vocab] f32: row b is drawn from
    ``request_seed(seed, rids[b], n_generated[b])`` when ``sampled[b]``,
    zeros otherwise (greedy rows never read it)."""
    noise = torch.zeros((len(rids), vocab), dtype=torch.float32,
                        device=device)
    for b, (rid, n, s) in enumerate(zip(rids, n_generated, sampled)):
        if not s:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(request_seed(seed, int(rid), int(n)))
        u = torch.rand((vocab,), generator=gen, device=device)
        noise[b] = -torch.log(-torch.log(u))
    return noise


def sample_tokens(logits, noise, temperature, top_k, top_p):
    """Sample one token per slot.

    logits: [B, V]; noise: [B, V] Gumbel (request_noise); temperature /
    top_p: [B] f32; top_k: [B] int. Returns [B] int32.

    Filtering runs in the sorted domain (descending logits, stable): top-k
    keeps rank < k; top-p keeps the smallest prefix whose mass reaches p
    (the head token always survives); the pick is a Gumbel-max over the
    surviving entries, mapped back through the sort permutation.
    """
    lg = logits.float()
    V = lg.shape[-1]
    greedy = temperature <= 0.0
    scaled = lg / temperature.clamp(min=1e-6)[:, None]
    vals, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    rank = torch.arange(V, device=lg.device)[None, :]
    k = torch.where(top_k <= 0, V, top_k)[:, None]
    keep = rank < k
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_p[:, None]  # mass BEFORE this entry < p
    keep |= rank == 0                       # head always survives
    vals = torch.where(keep, vals, float("-inf"))
    pick = order.gather(1, torch.argmax(vals + noise, dim=-1,
                                        keepdim=True))[:, 0]
    return torch.where(greedy, torch.argmax(lg, dim=-1), pick).to(
        torch.int32)
