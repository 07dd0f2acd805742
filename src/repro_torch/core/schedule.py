"""Zebra-parallelism task schedule — Theorem 1 of the paper.

Tasks:  A (attention compute), E (expert compute), D (dispatch all-to-all),
C (combine all-to-all), H (head + loss + head-backward, attention group),
X (Asym-EA offloaded expert compute on attention GPUs).
Phases: F (forward) / B (backward).

Streams (per the paper's three-streams-per-GPU design, §4.1):
    attn_comp — A, H, X on attention GPUs
    exp_comp  — E on expert GPUs
    link_a2e  — D^F and C^B (attention -> expert direction)
    link_e2a  — C^F and D^B (expert -> attention direction)
Dispatch/combine ride different directions, hence never contend (paper).

The canonical per-stream orders below are exactly Theorem 1's; the
simulator computes start times from data dependencies + per-stream FIFO, and
the property test checks no valid reordering beats the canonical order.

A copy of the JAX package's ``core/schedule.py`` with its imports rewritten
to the port (it imports neither jax nor the JAX package).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Tuple

Task = Tuple[str, str, int, int]  # (kind, phase, layer, microbatch)


def A(p, l, j): return ("A", p, l, j)  # noqa: E704


def E(p, l, j): return ("E", p, l, j)  # noqa: E704


def D(p, l, j): return ("D", p, l, j)  # noqa: E704


def C(p, l, j): return ("C", p, l, j)  # noqa: E704


def H(j): return ("H", "F", -1, j)  # noqa: E704


def X(p, l, j): return ("X", p, l, j)  # noqa: E704


STREAM_OF = {
    ("A", "F"): "attn_comp", ("A", "B"): "attn_comp",
    ("H", "F"): "attn_comp",
    ("X", "F"): "attn_comp", ("X", "B"): "attn_comp",
    ("E", "F"): "exp_comp", ("E", "B"): "exp_comp",
    ("D", "F"): "link_a2e", ("C", "B"): "link_a2e",
    ("C", "F"): "link_e2a", ("D", "B"): "link_e2a",
}


def stream_of(task: Task) -> str:
    return STREAM_OF[(task[0], task[1])]


@dataclasses.dataclass
class ZebraSchedule:
    L: int
    R: int
    offload: tuple  # per-layer o_l (0 = no Asym-EA at that layer)
    streams: Dict[str, List[Task]]
    # Sub-microbatch dispatch chunking (DESIGN.md §8): each D/C task is a
    # pipeline of n_chunks slices double-buffered against the matching E
    # task, so the simulator prices only its EXPOSED residue on the link
    # streams. Task ordering and dependencies are unchanged — chunking is
    # strictly finer-grained than the (layer, microbatch) task system.
    n_chunks: int = 1

    def all_tasks(self) -> List[Task]:
        return [t for s in self.streams.values() for t in s]


def dependencies(task: Task, L: int, offload: tuple) -> List[Task]:
    """Data-dependency predecessors of a task (paper §4.1 + Asym-EA §4.2)."""
    kind, phase, l, j = task
    has_x = offload[l] > 0 if 0 <= l < L else False
    deps: List[Task] = []
    if kind == "A" and phase == "F":
        if l > 0:
            deps.append(C("F", l - 1, j))
    elif kind == "D" and phase == "F":
        deps.append(A("F", l, j))
    elif kind == "E" and phase == "F":
        deps.append(D("F", l, j))
    elif kind == "X" and phase == "F":
        deps.append(D("F", l, j))  # needs tokens from other attention GPUs
    elif kind == "C" and phase == "F":
        deps.append(E("F", l, j))
        if has_x:
            deps.append(X("F", l, j))
    elif kind == "H":
        deps.append(C("F", L - 1, j))
    elif kind == "C" and phase == "B":
        deps.append(H(j) if l == L - 1 else A("B", l + 1, j))
    elif kind == "E" and phase == "B":
        deps.append(C("B", l, j))
    elif kind == "X" and phase == "B":
        deps.append(C("B", l, j))
    elif kind == "D" and phase == "B":
        deps.append(E("B", l, j))
        if has_x:
            deps.append(X("B", l, j))
    elif kind == "A" and phase == "B":
        deps.append(D("B", l, j))
    return deps


def canonical_schedule(L: int, R: int, offload: tuple = None,
                       n_chunks: int = 1) -> ZebraSchedule:
    """Theorem 1's optimal per-stream orders (+ Asym-EA X-task placement:
    offloaded expert compute goes after the layer's attention microbatches,
    paper §4.2). ``n_chunks`` records the sub-microbatch dispatch chunking
    the engines run with (see ZebraSchedule)."""
    offload = tuple(offload) if offload else tuple([0] * L)
    attn: List[Task] = []
    expc: List[Task] = []
    a2e: List[Task] = []
    e2a: List[Task] = []

    # ---- forward, layers 0..L-2
    for l in range(L - 1):
        attn += [A("F", l, j) for j in range(R)]
        if offload[l]:
            attn += [X("F", l, j) for j in range(R)]
        expc += [E("F", l, j) for j in range(R)]
        a2e += [D("F", l, j) for j in range(R)]
        e2a += [C("F", l, j) for j in range(R)]
    # ---- layer L-1: interleave fwd/bwd per microbatch (Theorem 1)
    lL = L - 1
    for j in range(R):
        attn += [A("F", lL, j)]
        if offload[lL]:
            attn += [X("F", lL, j)]
        attn += [H(j), A("B", lL, j)]
        expc += [E("F", lL, j), E("B", lL, j)]
        a2e += [D("F", lL, j), C("B", lL, j)]
        e2a += [C("F", lL, j), D("B", lL, j)]
        if offload[lL]:
            attn.insert(len(attn) - 1, X("B", lL, j))
    # ---- backward, layers L-2..0
    for l in range(L - 2, -1, -1):
        a2e += [C("B", l, j) for j in range(R)]
        expc += [E("B", l, j) for j in range(R)]
        if offload[l]:
            attn += [X("B", l, j) for j in range(R)]
        e2a += [D("B", l, j) for j in range(R)]
        attn += [A("B", l, j) for j in range(R)]

    return ZebraSchedule(L, R, offload, {
        "attn_comp": attn, "exp_comp": expc,
        "link_a2e": a2e, "link_e2a": e2a,
    }, n_chunks=max(int(n_chunks), 1))


def validate(sched: ZebraSchedule) -> None:
    """Check stream assignment and intra-stream dependency sanity."""
    for name, tasks in sched.streams.items():
        for t in tasks:
            assert stream_of(t) == name, (t, name)
        assert len(set(tasks)) == len(tasks), f"duplicate task in {name}"
    # Every dependency must exist somewhere.
    have = set(sched.all_tasks())
    for t in sched.all_tasks():
        for d in dependencies(t, sched.L, sched.offload):
            assert d in have, (t, d)
