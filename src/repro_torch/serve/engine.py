"""Serving engines over KV decode states (mirror of
``repro/serve/engine.py``, DESIGN.md §7 / §9).

Two entry points:

* ``make_continuous_program`` / ``ContinuousBatchingEngine``, the serving
  path: chunked prefill at batch 1, per-slot sampled decode over all live
  slots, slot recycling; trace spans, flows, counters and idle marks on
  the tick clock (§15). Two builds: the dense one (the JAX driver's
  default) keeps a contiguous per-slot KV reservation, prefills into a
  batch-1 cache and inserts it wholesale into the freed slot; the paged
  one (§9) writes prefill straight into the request's pool pages, decodes
  through per-slot page tables, grows pages on demand and preempts the
  newest request on pool exhaustion, and with a prefix index on the
  scheduler copy-on-write forks shared pages before any write lands in
  them (§14).
* ``make_serve_program`` / ``BatchedServer``, the lockstep path: one
  scalar ``cache_index`` for the whole batch, whole-batch prefill, greedy
  decode, with the front embeddings (``fronts``: whisper's
  ``encoder_embeds``, the vision archs' ``vision_embeds``) handed to every
  step. The drivers serve the encoder-decoder and vision archs through
  it (the continuous engines carry no fronts); it is also the dense
  engine's parity reference.

Differences from the JAX engines, all about execution and none about
results: the steps run eagerly (no jit) under ``torch.inference_mode``;
the KV caches and pools are updated in place where JAX returns a new
state (the insert and the COW fork too); the engines keep one
compute-dtype copy of each weight matrix made at load
(``stack.compute_params``) instead of casting every call. Expert-parallel
decode (``ep``, DESIGN.md §11) runs both builds' MoE FFNs through
``serve.ep_decode``'s EP hop over an ``EPGroup`` (the mesh's "model"
axis). Both continuous builds run on a rank of the serving mesh
(``mesh=``, ``serve.mesh``; one device is its 1x1 mesh) where the JAX
package hands GSPMD its shardings: weights gathered per layer, KV split
over "model" with the attention merged by log-sum-exp, slots over
"data".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.models import stack
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import RunConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import sampling
from repro_torch.serve.mesh import (ServeLayout, decode_state_specs,  # noqa: F401
                                    paged_state_specs)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import PrefillChunk, Request, Scheduler


@dataclasses.dataclass
class ServeProgram:
    """The steps of the lockstep server.

      prefill_step(params, state, tokens[B,S], fronts)
          -> (state, last_logits [B,V])
      decode_step(params, state, tok[B,1], cache_index, fronts)
          -> (state, next[B,1])

    ``fronts`` is a dict of ``stack.apply_model``'s front keywords
    (``encoder_embeds`` / ``vision_embeds``), empty for a decoder-only
    arch. The steps take and return every row of the batch; on a mesh
    the params and state are this rank's blocks (:meth:`prepare`,
    ``init_state``), each step runs on the rank's rows and gathers its
    outputs over "data".
    """

    cfg: ModelConfig
    run: RunConfig
    device: torch.device
    prefill_step: Callable
    decode_step: Callable
    init_state: Callable     # (batch, max_len) -> dense decode state
    layout: Callable = None  # (batch, max_len) -> serve.mesh.ServeLayout

    def prepare(self, params, batch: int, max_len: int):
        """This rank's blocks of ``params``, each matrix cast once to the
        compute dtype (``stack.compute_params``)."""
        return stack.compute_params(
            self.layout(batch, max_len).local_params(params),
            self.run.policy)


def make_serve_program(cfg: ModelConfig, run: RunConfig, *, mesh=None,
                       device="cuda") -> ServeProgram:
    """Build the lockstep server's steps (``repro/serve/engine.py``'s
    ``make_serve_program``): whole-batch prefill into a dense cache from
    line 0, then greedy decode with one scalar ``cache_index``. MoE FFNs
    go through zebra's expert-parallel MoE (``zebra_spmd.make_ep_moe``
    over the mesh, replicated, at twice the model's capacity factor), as
    in the JAX package; on one device that is the whole expert set. The
    JAX function's ``shape`` and ``max_len`` size its sharded state; here
    the server's ``batch`` and ``max_len`` size the layout and state it
    allocates (``init_state``). Each step takes the fronts and rebuilds
    the cross-attention memory from them (whisper's encoder stack, the
    vision projection) as the reference's steps do: a decode step pays
    the encoder again, which the port does not cache either.

    ``mesh`` (a ``launch.mesh.Mesh``; None: the 1x1 mesh of ``device``):
    the program of this rank of the serving mesh (``serve.mesh``):
    weights gathered per layer (the encoder's too), the dense caches
    split by line over "model" and merged by log-sum-exp, the batch's
    rows (prompts, fronts and the cross-attention memory built from them)
    over "data" by ``fit_batch_axes``, the expert stacks over "model".
    """
    device = torch.device(device)
    layouts = {}

    def layout(batch: int, max_len: int = None):
        """The rank's layout, step config and MoE override of a batch of
        ``batch`` rows (built on the first call, with ``max_len``)."""
        if batch not in layouts:
            if max_len is None:
                raise ValueError(f"no state of batch {batch}: init_state "
                                 f"first")
            lay = ServeLayout(cfg, mesh, n_slots=batch, max_len=max_len,
                              dtype=run.policy.compute_dtype, device=device,
                              ep_moe=cfg.is_moe)
            run_m = dataclasses.replace(run, shard=lay.context(decode=True))
            layouts[batch] = (lay, run_m, _lockstep_moe(cfg, run, lay))
        return layouts[batch]

    def rows(lay, fronts):
        return {k: v[lay.rows] for k, v in fronts.items()}

    @torch.inference_mode()
    def prefill(params, state, tokens, fronts):
        """Full-sequence prefill writing the caches; only the final
        position is unembedded."""
        lay, run_m, moe = layout(tokens.shape[0])
        params = lay.gather_params(params)
        hidden, state, _ = stack.apply_model(
            params, cfg, run_m, tokens[lay.rows], decode_state=state,
            cache_index=0, moe_override=moe, return_hidden=True,
            **rows(lay, fronts))
        return state, lay.gather_slots(stack.unembed(params, cfg, run_m,
                                                     hidden[:, -1]))

    @torch.inference_mode()
    def decode(params, state, tok, cache_index, fronts):
        """One decode step: tok [B,1] -> greedy next token [B,1]."""
        lay, run_m, moe = layout(tok.shape[0])
        logits, state, _ = stack.apply_model(
            lay.gather_params(params), cfg, run_m, tok[lay.rows],
            decode_state=state, cache_index=cache_index, moe_override=moe,
            **rows(lay, fronts))
        return state, lay.gather_slots(logits[:, -1].argmax(-1)[:, None])

    return ServeProgram(
        cfg=cfg, run=run, device=device, prefill_step=prefill,
        decode_step=decode, layout=lambda b, m: layout(b, m)[0],
        init_state=lambda batch, max_len: layout(
            batch, max_len)[0].dense_state(batch))


def _lockstep_moe(cfg: ModelConfig, run: RunConfig, lay: ServeLayout):
    """The lockstep server's MoE override on ``lay``'s mesh: the JAX
    package's ``make_ep_moe`` (replicated, twice the capacity factor, the
    tokens of the rank's rows, so the capacity is the JAX package's per
    rank), or None for a dense arch."""
    if not cfg.is_moe:
        return None
    from repro_torch.core.zebra_spmd import ZebraConfig, make_ep_moe
    moe_fn = make_ep_moe(cfg, run, ZebraConfig(
        mode="replicated", batch_axes=lay.batch_axes or ("data",),
        capacity_factor=cfg.capacity_factor * 2), mesh=lay.mesh)

    def moe_override(ffn_params, u):
        y2, aux = moe_fn(ffn_params, u.reshape(-1, u.shape[-1]))
        return y2.reshape(u.shape).to(u.dtype), aux
    return moe_override


class BatchedServer:
    """Minimal lockstep loop over fixed slots: the drivers' server for
    encoder-decoder and vision archs (``fronts``: their front embeddings,
    given to every call), and the dense engine's parity reference. On a
    mesh it holds this rank's blocks of the params and state; the tokens
    and logits are every row's."""

    def __init__(self, program: ServeProgram, params, batch: int,
                 max_len: int):
        self.p = program
        self.params = program.prepare(params, batch, max_len)
        self.batch = batch
        self.max_len = max_len
        self.state = program.init_state(batch, max_len)
        self.cache_index = 0
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64,
                                  device=program.device)
        self.logits = None  # the last prefill's last-position logits

    def _fronts(self, fronts) -> dict:
        return {k: torch.as_tensor(v, device=self.p.device)
                for k, v in (fronts or {}).items()}

    def submit_prefill(self, tokens, fronts=None):
        """Prefill every slot from line 0; the first tokens (greedy) are
        returned and the prefill's last-position logits kept in
        ``logits`` [B, V]."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                 device=self.p.device)
        self.state, self.logits = self.p.prefill_step(
            self.params, self.state, tokens, self._fronts(fronts))
        self.cache_index = tokens.shape[1]
        self.tokens = self.logits.argmax(-1)[:, None]
        return self.tokens

    def step(self, fronts=None):
        self.state, self.tokens = self.p.decode_step(
            self.params, self.state, self.tokens, self.cache_index,
            self._fronts(fronts))
        self.cache_index += 1
        return self.tokens


@dataclasses.dataclass
class ContinuousProgram:
    """The steps of the continuous-batching engine, in one of two builds.

    Dense (``paged=False``): per-slot contiguous KV reservations; prefill
    runs on a separate batch-1 state inserted wholesale on admission.
      prefill_step(params, pstate, tokens[1,c], offset)
          -> (pstate, last_logits [1,V] f32)
      insert_step(state, pstate, slot) -> state
      decode_step(params, state, tok[B,1], pos[B], active[B], rids[B],
                  ngen[B], temp[B], topk[B], topp[B])
          -> (state, next[B], last_logits [B,V] f32)

    Paged (``paged=True``): KV in shared pools addressed through per-slot
    page tables; prefill writes the request's pages directly, the insert
    copies only the batch-1 recurrent carry.
      prefill_step(params, state, prec, tokens[1,c], offset, ptrow[1,MP])
          -> (state, prec, last_logits [1,V] f32)
      insert_step(state, prec, slot) -> state
      decode_step(params, state, tok[B,1], pos[B], ptabs[B,MP], active[B],
                  rids[B], ngen[B], temp[B], topk[B], topp[B])
          -> (state, next[B], last_logits [B,V] f32)
      fork_step(state, src_ids, dst_ids) -> state   (COW page copy)

    Both: sample_step(logits[N,V], rids, ngen, temp, topk, topp) -> [N].
    Step inputs may be numpy arrays; outputs are tensors on ``device``.

    EP decode (DESIGN.md §11): with ``ep`` set, params must be placed
    (``serve.ep_decode.place_params`` under ``ep_group``, the EP ranks of
    the mesh's "model" axis) and decode_step
    returns a 4th output, the per-layer routed-copy histogram [n_rows,
    n_experts] (f32, on ``device``) that feeds the placement EMA.

    On a mesh (``layout``, a ``serve.mesh.ServeLayout``; the 1x1 mesh of
    one device otherwise) the steps take this rank's param blocks
    (:meth:`prepare`) and state blocks and return what every rank
    returns alike: the logits and tokens of every slot, the histogram
    summed over the slots of every data rank. ``pool``: this rank's block
    of the paged pool (None when it is not split), which the KV transfer
    and the COW fork read and write through.
    """

    cfg: ModelConfig
    run: RunConfig
    device: torch.device
    n_slots: int
    max_len: int
    prefill_step: Callable
    insert_step: Callable
    decode_step: Callable
    sample_step: Callable
    init_state: Callable     # () -> decode state (B = n_slots)
    init_pstate: Callable = None  # dense: () -> batch-1 prefill state
    init_prec: Callable = None    # paged: () -> batch-1 recurrent carry
    fork_step: Callable = None
    paged: bool = False
    page_size: int = 0
    n_pages: int = 0
    max_pages: int = 0       # page-table slots per request
    ep: object = None        # serve.ep_decode.EPDecodeConfig
    ep_group: object = None  # its core.zebra_spmd.EPGroup
    layout: ServeLayout = None
    pool: object = None      # serve.mesh.PoolShard of a split pool

    def prepare(self, params):
        """The tree the steps run on: this rank's blocks of ``params``
        (whole or cut already), every matrix cast once to the compute
        dtype (``stack.compute_params``)."""
        return stack.compute_params(self.layout.local_params(params),
                                    self.run.policy)


def make_continuous_program(cfg: ModelConfig, run: RunConfig, serve_cfg, *,
                            device="cuda", ep=None,
                            mesh=None) -> ContinuousProgram:
    """Build the engine's steps. ``serve_cfg`` (a
    :class:`repro_torch.serve.config.ServeConfig`) supplies slots, max_len
    and seed; with ``paged.enabled`` the paged build, whose page geometry
    it also supplies (``paged.pool_pages`` defaults to full reservation
    capacity, slots x pages per sequence), else the dense build.

    MoE FFNs take the dropless gather path (``apply_moe``). With ``ep`` (a
    ``serve.ep_decode.EPDecodeConfig``) expert weights are instead
    sharded over the EP ranks, the mesh's "model" axis, and the MoE hop
    runs the chunked all-to-all dispatch (DESIGN.md §11); ``decode_step``
    then returns a 4th output, the per-layer routed-copy histogram.

    ``mesh`` (a ``launch.mesh.Mesh``; None: the 1x1 mesh of ``device``):
    the program of this rank of the serving mesh (``serve.mesh``)."""
    if cfg.is_encdec or cfg.vision_seq > 0:
        raise ValueError("continuous batching supports decoder-only LMs")
    device = torch.device(device)
    if serve_cfg.paged.enabled:
        return _make_paged_program(
            cfg, run, n_slots=serve_cfg.slots, max_len=serve_cfg.max_len,
            seed=serve_cfg.seed, page_size=serve_cfg.paged.page_size,
            n_pages=serve_cfg.paged.pool_pages, device=device, ep=ep,
            mesh=mesh)
    return _make_dense_program(cfg, run, n_slots=serve_cfg.slots,
                               max_len=serve_cfg.max_len,
                               seed=serve_cfg.seed, device=device, ep=ep,
                               mesh=mesh)


class _EPHooks:
    """A program build's EP lines (``repro/serve/engine.py:348-356``):
    the prefill override, the decode override over the live-slot mask, and
    the decode step's extra aux key. Without ``ep`` every hook is off. The
    EP ranks: the "model" axis of ``layout``'s mesh."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, ep,
                 layout: ServeLayout):
        self.ep = ep
        self.group = None
        if ep is None:
            return
        from repro_torch.core.zebra_spmd import EPGroup
        from repro_torch.serve import ep_decode as epd
        self.group = EPGroup(layout.model_group)
        epd.validate_ep_config(cfg, layout.mesh, ep)
        self.moe = epd.make_ep_moe_decode(cfg, run, ep, self.group)
        self.extras = (("ep_counts", (cfg.n_experts,)),)
        self.prefill = epd.moe_override_for(self.moe)
        self._override = epd.moe_override_for

    def prefill_kw(self) -> dict:
        return {} if self.ep is None else {"moe_override": self.prefill}

    def decode_kw(self, active) -> dict:
        if self.ep is None:
            return {}
        return {"moe_override": self._override(self.moe, active),
                "aux_extras": self.extras, "layer_aux": True}


def _sampler(seed: int, device: torch.device) -> Callable:
    """sample(logits[N,V], rids, ngen, temp, topk, topp) -> [N]: the
    per-request (seed, rid, n) noise, so a request samples the same token
    whatever its slot, neighbours or schedule."""
    def dev(x, dt):
        return torch.as_tensor(np.asarray(x), device=device, dtype=dt)

    @torch.inference_mode()
    def sample(logits, rids, ngen, temp, topk, topp):
        temp = np.asarray(temp, np.float32)
        noise = sampling.request_noise(seed, rids, ngen, temp > 0,
                                       logits.shape[-1], device)
        return sampling.sample_tokens(logits.float(), noise,
                                      dev(temp, None),
                                      dev(topk, torch.int64),
                                      dev(topp, torch.float32))
    return sample


def _make_dense_program(cfg: ModelConfig, run: RunConfig, *, n_slots: int,
                        max_len: int, seed: int, device: torch.device,
                        ep=None, mesh=None) -> ContinuousProgram:
    """Dense program (the JAX engine's default build): each slot owns a
    contiguous [max_len] KV reservation (a ring on sliding-window layers).
    A prompt prefills chunk by chunk into a batch-1 state that attends
    over its own cache; the finished state is inserted wholesale into the
    freed slot, so live slots are never touched. Decode carries the
    per-slot position vector ``pos [B]`` (the next cache line; -1 for a
    dead slot, which writes no line and whose queries mask every key) and
    attends over the whole [B, C] cache through the materialised plain
    path, as the reference does (``modules.partial_attention``).

    On a mesh a rank holds lines of every row of its data rank's slots
    (the prefill state: of its one row) and decodes those slots, its
    partial attention merged over "model"; the insert lands in the data
    rank that owns the slot."""
    B = n_slots
    dtype = run.policy.compute_dtype
    sample = _sampler(seed, device)
    lay = ServeLayout(cfg, mesh, n_slots=B, max_len=max_len, dtype=dtype,
                      device=device, ep=ep is not None)
    run_b = dataclasses.replace(run, shard=lay.context(decode=True))
    run_p = dataclasses.replace(run, shard=lay.context(decode=False))
    eph = _EPHooks(cfg, run, ep, lay)

    def dev(x, dt=None):
        return torch.as_tensor(np.asarray(x), device=device, dtype=dt)

    @torch.inference_mode()
    def prefill(params, pstate, tokens, offset):
        """One prompt chunk at batch 1: writes cache lines [offset,
        offset + c), attends over the whole cache (earlier chunks
        included), returns the f32 logits of the chunk's last position."""
        params = lay.gather_params(params)
        hidden, pstate, _ = stack.apply_model(
            params, cfg, run_p, dev(tokens, torch.int64),
            decode_state=pstate, cache_index=int(offset),
            attend_to_cache=True, return_hidden=True, **eph.prefill_kw())
        return pstate, stack.unembed(params, cfg, run_p,
                                     hidden[:, -1]).float()

    @torch.inference_mode()
    def insert(state, pstate, slot):
        """Overwrite row ``slot`` of every decode-state leaf with the
        batch-1 prefilled state (batch axis 1 on stacked block leaves, 0
        on tails): KV and cache positions alike, so a recycled slot cannot
        leak. In place: returns the same state. On a mesh each leaf's
        block takes the row if it holds that slot (``ServeLayout.insert``).
        """
        lay.insert(state, pstate, slot)
        return state

    @torch.inference_mode()
    def decode(params, state, tok, pos, active, rids, ngen, temp, topk,
               topp):
        """One decode step for every slot; dead slots (pos < 0) write no
        cache lines and emit token 0. Under EP the per-layer routed-copy
        histogram rides along as a 4th output."""
        live = dev(active, torch.bool)
        rows = lay.rows
        logits, state, aux = stack.apply_model(
            lay.gather_params(params), cfg, run_b,
            dev(lay.local_rows(tok), torch.int64), decode_state=state,
            cache_index=dev(lay.local_rows(pos), torch.int32),
            **eph.decode_kw(live[rows]))
        last = lay.gather_slots(logits[:, -1].float())
        nxt = sample(last, rids, ngen, temp, topk, topp)
        out = (state, torch.where(live, nxt, 0), last)
        if not ep:
            return out
        return out + (lay.sum_slots(aux["per_layer"]["ep_counts"]),)

    return ContinuousProgram(
        cfg=cfg, run=run, device=device, n_slots=B, max_len=max_len,
        prefill_step=prefill, insert_step=insert, decode_step=decode,
        sample_step=sample, init_state=lambda: lay.dense_state(B),
        init_pstate=lambda: lay.dense_state(1), ep=ep, ep_group=eph.group,
        layout=lay)


def _make_paged_program(cfg: ModelConfig, run: RunConfig, *, n_slots: int,
                        max_len: int, seed: int, page_size: int,
                        n_pages: int | None, device: torch.device,
                        ep=None, mesh=None) -> ContinuousProgram:
    """Paged-KV program (DESIGN.md §9.4): KV never moves at admission or
    recycling — prefill scatters straight into the request's pool pages,
    the insert step copies only the batch-1 recurrent carry, and freeing is
    the allocator's page-table reset.

    On a mesh a rank holds the pages of its block of every pool (split
    over "model", the same on every data rank: each data rank's decode
    writes reach every copy) and decodes its data rank's slots."""
    B = n_slots
    max_pages = -(-max_len // page_size)
    n_pages = n_pages if n_pages is not None else B * max_pages
    if n_pages < max_pages:
        raise ValueError("pool smaller than one sequence")
    dtype = run.policy.compute_dtype
    sample = _sampler(seed, device)
    lay = ServeLayout(cfg, mesh, n_slots=B, max_len=max_len, dtype=dtype,
                      device=device, ep=ep is not None)
    run_b = dataclasses.replace(run, shard=lay.context(decode=True,
                                                       n_pages=n_pages))
    run_p = dataclasses.replace(run, shard=lay.context(decode=False,
                                                       n_pages=n_pages))
    pool = lay.pool(n_pages)
    eph = _EPHooks(cfg, run, ep, lay)

    def dev(x, dt=None):
        return torch.as_tensor(np.asarray(x), device=device, dtype=dt)

    def unembed(params, hidden):
        return stack.unembed(params, cfg, run_p, hidden).float()

    @torch.inference_mode()
    def prefill(params, state, prec, tokens, offset, ptrow):
        """One prompt chunk at batch 1, scattered through the request's
        page table straight into the shared pools."""
        kv_s, rec_s = stack.split_kv_state(state)
        merged = stack.merge_kv_state(kv_s, prec)
        params = lay.gather_params(params)
        hidden, new_merged, _ = stack.apply_model(
            params, cfg, run_p, dev(tokens, torch.int64),
            decode_state=merged, cache_index=int(offset), return_hidden=True,
            page_table=dev(ptrow, torch.int32), **eph.prefill_kw())
        kv_n, prec_n = stack.split_kv_state(new_merged)
        return (stack.merge_kv_state(kv_n, rec_s), prec_n,
                unembed(params, hidden[:, -1]))

    @torch.inference_mode()
    def insert(state, prec, slot):
        """Admission copies ONLY the recurrent carry into the slot row; the
        KV pages are already in the pool (written by prefill). In place:
        returns the same state. On a mesh the carry's blocks land in each
        leaf's block that holds the slot (``ServeLayout.insert``)."""
        lay.insert(stack.split_kv_state(state)[1], prec, slot)
        return state

    @torch.inference_mode()
    def decode(params, state, tok, pos, ptabs, active, rids, ngen, temp,
               topk, topp):
        """One decode step for every slot; dead slots (pos < 0) write no
        cache lines and emit token 0. Under EP the per-layer routed-copy
        histogram rides along as a 4th output."""
        live = dev(active, torch.bool)
        rows = lay.rows
        logits, state, aux = stack.apply_model(
            lay.gather_params(params), cfg, run_b,
            dev(lay.local_rows(tok), torch.int64), decode_state=state,
            cache_index=dev(lay.local_rows(pos), torch.int32),
            page_table=dev(lay.local_rows(ptabs), torch.int32),
            **eph.decode_kw(live[rows]))
        last = lay.gather_slots(logits[:, -1].float())
        nxt = sample(last, rids, ngen, temp, topk, topp)
        out = (state, torch.where(live, nxt, 0), last)
        if not ep:
            return out
        return out + (lay.sum_slots(aux["per_layer"]["ep_counts"]),)

    @torch.inference_mode()
    def fork(state, src, dst):
        """Copy-on-write page copy (DESIGN.md §14): duplicate physical
        page ``src`` into ``dst`` across every layer's K/V/pos pool, in
        place, before a writer diverges from a shared prefix. One page of
        device traffic, the only KV copy of the unified paged engine; it
        runs on the stream of the writes it precedes. On a split pool the
        page goes from its owner to the owner of ``dst``."""
        return stack.scatter_kv_pages(
            state, stack.gather_kv_pages(state, src, pool), dst, pool)

    return ContinuousProgram(
        cfg=cfg, run=run, device=device, n_slots=B, max_len=max_len,
        prefill_step=prefill, insert_step=insert, decode_step=decode,
        sample_step=sample, fork_step=fork,
        init_state=lambda: lay.paged_state(B, n_pages, page_size),
        init_prec=lay.prefill_carry,
        paged=True, page_size=page_size, n_pages=n_pages,
        max_pages=max_pages, ep=ep, ep_group=eph.group, layout=lay,
        pool=pool)


class ContinuousBatchingEngine:
    """Continuous-batching serving loop (DESIGN.md §7).

    One ``tick`` = up to ``scheduler.token_budget`` chunked-prefill tokens
    (admitting at most one request at a time into a freed slot) followed by
    ONE batched decode step over all live slots. Requests finish and free
    their slot on EOS or length limit while other slots keep decoding;
    generated tokens land in ``results[rid]``.

    With a paged program (§9.4) the scheduler carries a ``BlockAllocator``;
    the engine mirrors each slot's page table, claims a page whenever a
    slot's next write position crosses a page boundary, and relieves pool
    OOM by preempting the newest running request before the decode step
    runs. With the scheduler's prefix index, a shared page is COW-forked
    before the prefill chunk or decode step that writes into it.
    """

    def __init__(self, program: ContinuousProgram, params,
                 scheduler: Scheduler, *, metrics: ServeMetrics = None,
                 on_token: Callable = None, record_logits: bool = False):
        self.p = program
        # One compute-dtype copy of each weight matrix (of this rank's
        # blocks on a mesh), made at load; the caller's f32 params are not
        # modified.
        self.params = program.prepare(params)
        self.sched = scheduler
        self.metrics = metrics or ServeMetrics()
        self.on_token = on_token  # callable(rid, token, finished)
        self.record_logits = record_logits
        self.logits: Dict[int, List[np.ndarray]] = {}  # rid -> [V] rows
        self.rejected: List[int] = []  # rids refused admission
        self.tick_count = 0
        self.track = "serve"  # tracer track (disagg overrides per role)
        self.owns_clock = True  # standalone: this engine advances the tracer
        scheduler.set_track(self.track)
        self.n_prefill_chunks = 0  # prefill_step calls
        self.n_decode_steps = 0    # decode_step calls
        B = program.n_slots
        self.state = program.init_state()
        self.pstate = None  # dense: batch-1 prefill state
        self.prec = None    # paged: batch-1 prefill recurrent carry
        # Host mirrors of the per-slot decode inputs.
        self._tok = np.zeros((B,), np.int32)
        self._pos = np.full((B,), -1, np.int32)
        self._active = np.zeros((B,), bool)
        self._rid = np.zeros((B,), np.int32)
        self._ngen = np.zeros((B,), np.int32)
        self._temp = np.zeros((B,), np.float32)
        self._topk = np.zeros((B,), np.int32)
        self._topp = np.ones((B,), np.float32)
        if program.paged:
            alloc = scheduler.allocator
            if alloc is None:
                raise ValueError("the paged program needs an allocator")
            if alloc.page_size != program.page_size \
                    or alloc.n_pages != program.n_pages \
                    or alloc.max_pages_per_seq < program.max_pages:
                raise ValueError("allocator geometry disagrees with the "
                                 "program")
            self._ptab = np.full((B, program.max_pages), -1, np.int32)
            self.page_peak = 0
            self._page_ticks: List[tuple] = []  # (pages_in_use, n_active)

    @property
    def results(self) -> Dict[int, List[int]]:
        return self.sched.results

    def set_track(self, track: str) -> None:
        """Point this engine's trace events at ``track``. Controllers that
        call this own the tick clock, so the engine stops advancing it."""
        self.track = track
        self.owns_clock = False
        self.sched.set_track(track)

    def submit(self, req: Request) -> None:
        self.sched.submit(req)
        self.metrics.on_submit(req.rid, len(req.prompt))
        obs_trace.TRACER.flow(self.track, "queued", req.rid,
                              prompt=len(req.prompt))

    # -- one engine tick ----------------------------------------------------

    def tick(self) -> None:
        tr = obs_trace.TRACER
        if self.owns_clock:
            tr.advance(self.tick_count)
        worked = False
        budget = self.sched.token_budget
        while budget > 0:
            chunk = self.sched.plan_prefill(budget)
            if chunk is None:
                break
            with tr.span(self.track, "prefill", rid=chunk.request.rid,
                         start=chunk.start, length=chunk.length):
                if chunk.first:
                    tr.flow(self.track, "prefill", chunk.request.rid)
                self._run_prefill_chunk(chunk)
            worked = True
            budget -= chunk.length
        if self.p.paged:
            self._ensure_pages()
        if self._active.any():
            with tr.span(self.track, "decode",
                         n_active=int(self._active.sum())):
                self._decode_once()
            worked = True
        if tr.enabled:
            tr.count(self.track, "queue_depth", self.sched.queue_depth)
            if not worked:
                bucket = "pool-OOM" \
                    if self.sched.prefill.wait_reason == "pages" \
                    else "queue-starved"
                tr.mark_idle(self.track, bucket)
        self.metrics.on_tick(self.sched.queue_depth, self.sched.n_active)
        if self.p.paged:
            in_use = self.sched.allocator.pages_in_use
            self.page_peak = max(self.page_peak, in_use)
            self._page_ticks.append((in_use, self.sched.n_active))
        self.tick_count += 1

    def _run_prefill_chunk(self, chunk: PrefillChunk) -> None:
        req = chunk.request
        toks = np.asarray(
            chunk.tokens[chunk.start:chunk.start + chunk.length],
            np.int32)[None, :]
        if not self.p.paged:
            if chunk.start == 0:  # fresh request -> fresh prefill cache
                self.pstate = self.p.init_pstate()
            self.pstate, logits = self.p.prefill_step(
                self.params, self.pstate, toks, chunk.start)
        else:
            if chunk.first:  # fresh (or resumed) request -> fresh carry;
                # a prefix hit starts at chunk.skipped, not 0 (§14)
                self.prec = self.p.init_prec()
            # Fork-on-divergence: this chunk writes lines [start,
            # start+length) and any SHARED page in that range is
            # COW-forked before the scatter lands (a resumed mid-page
            # prefill into a cached partial tail is the canonical case).
            self._cow_guard(req.rid, chunk.start, chunk.length)
            ptrow = self.sched.allocator.table(req.rid,
                                               self.p.max_pages)[None, :]
            self.state, self.prec, logits = self.p.prefill_step(
                self.params, self.state, self.prec, toks, chunk.start, ptrow)
        self.n_prefill_chunks += 1
        if self.sched.finish_prefill_chunk(chunk):
            self._admit(chunk, logits)

    def _admit(self, chunk: PrefillChunk, last_logits) -> None:
        """Sample the next token from the prefill logits and insert the
        prefilled state into the freed slot. For a preemption resume
        (``chunk.n_done > 0``) the re-prefill replayed prompt + generated
        tokens, so the sample index continues at ``n_done`` — the
        (seed, rid, n) noise makes the continuation token-exact (§7.4)."""
        req, slot = chunk.request, chunk.slot
        sp = req.sampling
        first = self.p.sample_step(
            last_logits, np.asarray([req.rid], np.int32),
            np.asarray([chunk.n_done], np.int32),
            np.asarray([sp.temperature], np.float32),
            np.asarray([sp.top_k], np.int32),
            np.asarray([sp.top_p], np.float32))
        if self.p.paged:
            self.state = self.p.insert_step(self.state, self.prec, slot)
            self.prec = None
            self._ptab[slot] = self.sched.allocator.table(req.rid,
                                                          self.p.max_pages)
        else:
            self.state = self.p.insert_step(self.state, self.pstate, slot)
            self.pstate = None
        first = int(first[0])
        if self.record_logits:
            row = last_logits[0].cpu().numpy()
            if chunk.n_done == 0:
                self.logits[req.rid] = [row]
            else:
                self.logits[req.rid].append(row)
        self.metrics.on_token(req.rid, self.tick_count)
        finished = self.sched.activate(chunk, first)
        if self.on_token:
            self.on_token(req.rid, first, finished)
        if finished:
            self.metrics.on_finish(req.rid, self.tick_count)
            if self.p.paged:
                self._ptab[slot] = -1
            return
        self._tok[slot] = first
        self._pos[slot] = len(chunk.tokens)
        self._active[slot] = True
        self._rid[slot] = req.rid
        self._ngen[slot] = chunk.n_done + 1
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p

    def _cow_guard(self, rid: int, line_start: int, n_lines: int,
                   slot: int = None) -> None:
        """COW-fork every SHARED page of ``rid`` that the upcoming write
        to lines [line_start, line_start + n_lines) would touch
        (DESIGN.md §14): a fresh page replaces the shared one in the table
        and ``fork_step`` copies its device lines, so no writer ever
        mutates a page with refcount > 1. On pool exhaustion the newest
        running request is preempted for the copy target."""
        alloc = self.sched.allocator
        ps = alloc.page_size
        table = alloc.tables.get(rid)
        if not table or n_lines <= 0:
            return
        lo = line_start // ps
        hi = min((line_start + n_lines - 1) // ps, len(table) - 1)
        for pslot in range(lo, hi + 1):
            if not alloc.is_shared(table[pslot]):
                continue
            while True:
                try:
                    old, new = alloc.cow_fork(rid, pslot)
                    break
                except MemoryError:
                    victim = self.sched.preempt_newest()
                    if victim is None:
                        raise RuntimeError("COW OOM with nothing to "
                                           "preempt") from None
                    self._clear_slot(victim)
                    if slot is not None and victim == slot:
                        return  # the writer itself was evicted; it resumes
            self.state = self.p.fork_step(self.state, [old], [new])
            if slot is not None:
                self._ptab[slot] = alloc.table(rid, self.p.max_pages)

    def _ensure_pages(self) -> None:
        """Claim a pool page for every live slot whose next write position
        has crossed its allocated frontier; on pool OOM, preempt the newest
        running request (oldest slots are served first, so the loop always
        converges — down to one live request, which submit() guaranteed
        fits the pool). With a prefix cache, a slot about to write into a
        still-shared page COW-forks it first (the decode half of
        fork-on-divergence, §14)."""
        alloc = self.sched.allocator
        order = sorted((int(s) for s in np.nonzero(self._active)[0]),
                       key=lambda s: self.sched.running[s].seq)
        for slot in order:
            if not self._active[slot]:
                continue  # evicted by an earlier slot's OOM relief
            rid = int(self._rid[slot])
            while not alloc.covers(rid, int(self._pos[slot])):
                if alloc.extend(rid):
                    self._ptab[slot] = alloc.table(rid, self.p.max_pages)
                    continue
                victim = self.sched.preempt_newest()
                if victim is None:
                    raise RuntimeError("pool OOM with nothing to preempt")
                self._clear_slot(victim)
                if victim == slot:
                    break  # this slot itself was evicted; it will resume
            if self._active[slot]:
                self._cow_guard(rid, int(self._pos[slot]), 1, slot=slot)

    def _decode_once(self) -> None:
        ptab = (self._ptab,) if self.p.paged else ()
        out = self.p.decode_step(
            self.params, self.state, self._tok[:, None], self._pos, *ptab,
            self._active, self._rid, self._ngen, self._temp, self._topk,
            self._topp)
        if self.p.ep is not None:
            self.state, nxt, logits, counts = out
            self._on_ep_counts(counts.cpu().numpy())
        else:
            self.state, nxt, logits = out
        self.n_decode_steps += 1
        nxt = nxt.cpu().numpy()
        if self.record_logits:
            logits = logits.cpu().numpy()
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            tok = int(nxt[slot])
            rid = int(self._rid[slot])
            if self.record_logits:
                self.logits[rid].append(logits[slot])
            self.metrics.on_token(rid, self.tick_count)
            finished = self.sched.note_token(slot, tok)
            if self.on_token:
                self.on_token(rid, tok, finished)
            if finished:
                self.metrics.on_finish(rid, self.tick_count)
                self._clear_slot(slot)
            else:
                self._tok[slot] = tok
                self._pos[slot] += 1
                self._ngen[slot] += 1

    def _on_ep_counts(self, counts) -> None:
        """Routing-histogram hook (EP decode): overridden by
        ``serve.ep_decode.EPContinuousBatchingEngine`` to feed the
        placement EMA; a plain engine driving an EP program drops them."""

    def _clear_slot(self, slot: int) -> None:
        self._active[slot] = False
        self._pos[slot] = -1
        self._tok[slot] = 0
        self._ngen[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        if self.p.paged:
            self._ptab[slot] = -1

    def page_occupancy(self) -> dict:
        """Pool occupancy over the run (paged mode): peak pages in use,
        the time-averaged cache lines held per active slot, the prefix
        cache's accounting (zeros when caching is off) and the step
        counts."""
        if not self.p.paged:
            raise ValueError("page occupancy needs a paged program")
        ticks = [t for t in self._page_ticks if t[1] > 0]
        lines = [p * self.p.page_size / a for p, a in ticks]
        alloc = self.sched.allocator
        return {
            "page_size": self.p.page_size,
            "n_pages": self.p.n_pages,
            "page_peak": self.page_peak,
            "mean_lines_per_active_slot":
                round(sum(lines) / len(lines), 2) if lines else 0.0,
            "n_preempted": self.sched.n_preempted,
            "pages_allocated": alloc.n_fresh_allocs,
            "pages_shared": alloc.n_shared_allocs,
            "n_cow_forks": alloc.n_cow_forks,
            "prefix_hits": self.sched.prefill.n_prefix_hits,
            "tokens_skipped": self.sched.prefill.n_tokens_skipped,
            "prefill_chunks": self.n_prefill_chunks,
            "decode_steps": self.n_decode_steps,
        }

    # -- trace driver -------------------------------------------------------

    def run(self, requests: List[Request], max_ticks: int = 100_000):
        """Drive a trace to completion. ``Request.arrival`` is in engine
        ticks (the simulated clock); requests are submitted when the tick
        counter reaches their arrival time."""
        pending = sorted(requests, key=lambda r: r.arrival)
        while True:
            while pending and pending[0].arrival <= self.tick_count:
                req = pending.pop(0)
                try:
                    self.submit(req)
                except ValueError:
                    # inadmissible (oversized / empty): reject this request,
                    # keep serving the rest
                    self.rejected.append(req.rid)
            if not pending and not self.sched.has_work() \
                    and not self._active.any():
                return self.results
            self.tick()
            if self.tick_count > max_ticks:
                raise RuntimeError(f"serve trace exceeded {max_ticks} ticks")
