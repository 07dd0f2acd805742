#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (and
counts the tensor-core instructions, HGMMA, in each library's SASS) and
drives the port's main paths through its own drivers, at full width and
full depth, with random weights from seed 0:

* serve: a Poisson trace on ``mixtral-w2`` (4 layers, d_model 2048, 24
  experts top-2) through ``repro_torch.launch.serve`` with the paged
  engine;
* train: ``repro_torch.launch.train`` on ``mixtral-w1`` (4 layers, d_model
  2048, 12 experts top-2), 6 steps of batch 8 x seq 256 (forward, the
  recomputing backward, AdamW; bf16 compute, f32 params), with the
  driver's chunked attention;
* train_flash: the same driver loop, steps and batches with
  ``RunConfig(attn_impl="flash")``: every attention forward, recompute and
  backward through the flash attention kernels;
* train_mamba2: ``repro_torch.launch.train`` on ``mamba2-2.7b`` (64 SSD
  layers, d_model 2560, 80 heads of 64, state 128, chunk 256; 2.70 B
  params), one untimed warm-up step and then 6 steps of batch 2 x seq 2048
  (eight chunks per sequence, so the carried state is exercised): every
  SSD mixer's scan, forward and remat recompute, through the tensor-core
  SSD scan (``ssd_wgmma.cu``);
* train_zebra: the train driver's default on ``mixtral-w1``, zebra
  parallelism (replicated, 2 microbatches of 1024 tokens, capacity 1.25:
  216 rows per expert, the grouped kernels at block_m 8), attention on one
  CUDA stream beside the experts on a second; one untimed warm-up step,
  then 6 steps of batch 8 x seq 256;
* zebra_a2a: the same with ``--zebra-mode alltoall --n-chunks 2
  --offload-experts 2`` (chunked dispatch and combine, the two offloaded
  experts in chunk 0's grouped call; capacity 224 in chunks of 112 rows,
  block_m 16), 3 steps;
* train_mpmd: ``repro_torch.launch.hetero_mpmd``'s default, the zebra
  MPMD engine on ``mixtral-w1``: the port's planner on the paper's
  A40 + V100 ZP group picks the Asym-EA offloads (1, 2, 1, 2), and the
  engine walks Theorem 1's schedule with the attention group on one CUDA
  stream and 4 expert lanes on four more (2 microbatches of 1024 tokens,
  capacity 1.25: C 216, block_m 8); one untimed warm-up step, then 3
  steps of batch 8 x seq 256 (forward and stage-recompute backward; the
  engine applies no optimizer);
* mpmd_chunks: the same with ``--n-chunks 2`` (C 224 in chunks of 112
  rows: the lanes at block_m 16, the offloaded experts at 32);
* mpmd_ranks: the engine across ranks, ``hetero_mpmd --ranks 4x4`` at
  the same full-width default (4 attention ranks on 1 row of every
  microbatch each, 4 expert lanes one rank each), attention rank 0 and
  lane 0 each in a process of its own on PyTorch's fake process-group
  backend (its point-to-point messages and collectives posted but moving
  no data, its receives zeroed), 3 steps each;
* train_ckpt: the train driver's checkpoint and resume on ``mixtral-w1``
  at full width cut to 1 layer (0.67 B params, 8.04 GB a save with the
  two AdamW moments; full depth would write 27.4 GB a save): 4 steps
  straight, then 2 steps with ``--ckpt-every 2 --ckpt-dir`` (a directory
  under ``build/``, deleted after) and a new program resuming with
  ``--resume`` for steps 3-4;
* train_accum: ``mixtral-w1`` at full width and depth, zebra default,
  batch 8 x 256 through ``make_train_program(accum_steps=2)`` (two
  slices of 4 sequences, the f32 gradients summed): one untimed warm-up
  step, then 3 steps;
* remat_dots: one zebra W1 step under ``remat="dots"`` (the outputs of
  the matrix products without batch dims saved) and one under
  ``remat="full"`` from the same params and batch;
* compress: the int8 error-feedback compression (``train/compression.py``)
  of the W1 step-1 gradient tree, two rounds, on the card and on its CPU
  copy;
* train_trace: the train driver with ``--trace-out build/train_trace.json``
  on zebra W1, 3 steps;
* train_mesh: the training mesh, the driver's zebra default on W1 at full
  width and depth, 3 steps, through the one-process program and through
  ``--mesh 1x1`` (the mesh program on one rank of an NCCL group); with
  n >= 2 cards also ``--mesh 1xn`` and ``nx1``, one process per card;
* train_sp: the same driver run, 3 steps, at ``--mesh 1x1`` and as model
  rank 1 of ``--mesh 1x6`` on PyTorch's fake process-group backend
  (collectives launched but moving no data; each run in a process of
  its own): the rank's residual stream between blocks in seq blocks of
  43 positions, its attention at its 3 of the 16 q heads (kv heads 0, 1,
  1, repeated to one per q head), its 2 of the 12 experts; then 2 more
  steps of that rank with ``attn_impl="flash"``;
* dryrun: the dry run (``repro_torch.launch.dryrun``), one rank's step
  traced on fake tensors on a fake process group, the kernels through
  their fake routes (nothing launched), in a process of its own: the
  train_zebra configuration at 1x1, held against the real step (kernel
  calls by kernel and design per step equal to train_zebra's launches,
  param and optimizer bytes equal to train_mesh's tree and rules, the dry
  run's peak beside the real ``max_memory_allocated``), then
  ``qwen3-moe-30b-a3b train_4k`` and ``llama3.2-3b decode_32k`` at 16x16,
  rank 0 (each record and its wall seconds);
* serve_prefix: the serve driver on ``mixtral-w2`` with ``--prefix-cache
  --fair --tenants 2 --requests 8`` (a 192-token, 12-page shared prefix
  per tenant) and one exact repeat of request 0's prompt arriving 64
  ticks after the last request (request 0 has finished: its registered
  tail page is COW-forked); the same trace without the cache; and the
  cached run again under an f32 ``Policy`` with first-token logits
  recorded;
* serve_disagg: ``--disagg --pool-pages 34`` on the serve trace (a decode
  pool of 1.3 max-length sequences of 26 pages: 40 pages, about 1.5, did
  not preempt on this trace), both allocators checked at every tick, the
  transfer's gather, checksum and scatter timed; beside it the unified
  ``--paged`` engine on the same trace, first-token logits recorded;
* serve_disagg_prefix: ``--disagg --prefix-cache --fair --tenants 2`` on
  the serve_prefix trace with its repeat, a decode pool of 160 pages (the
  default 104 evicts request 0's pinned pages before the repeat comes);
* serve_trace: the serve run of the serve trace with ``--trace-out
  build/serve_trace.json``, twice.
* serve_dense: the serve trace without ``--paged`` (the driver's default:
  dense per-slot KV caches, decode through the materialised attention),
  beside the paged serve run; then under the f32 policy through the dense
  and the paged engines, first-token logits recorded.
* serve_fleet: the serve trace on the elastic fleet, ``--fleet
  --prefill-groups a40,a40 --decode-groups v100,v100 --fleet-elastic
  --kill-group 2@10`` with the chaos matrix's ``standard`` schedule (seed
  909): the classes set the router's priors, every group computes on the
  one card; then the same under the f32 policy, beside the unified paged
  engine under f32.
* serve_ep: expert-parallel decode at one EP rank on the serve trace
  (``--ep-size 1``: every MoE FFN through the EP hop, 2 all-to-all
  chunks, the identity at one rank): (a) ``--paged --ep-placement
  planned`` in bf16, the GLU's block_m tallied per call; (b) the same in
  f32 beside the unified ``--paged`` engine in f32, first-token logits
  recorded; (c) f32 with uniform placement and an explicit
  ``engine.rebalance`` to the reversed slot order after tick 5; (d)
  dense (no ``--paged``); (e) ``--disagg`` with the 34-page decode pool;
  then ``ep_tiles``: the GLU and bf16 ``gmm`` at the EP decode chunk (24
  x 8 rows, block_m 8) and prefill chunk (24 x 128 rows) layouts.
* serve_mesh: the serving mesh at ``--mesh 1x1``: the serve trace on
  W2, dense (no ``--paged``) and ``--paged``, through the engine built
  without a mesh, twice through ``launch_ranks`` at world 1 (one rank of
  an NCCL group, the mesh program: ``serve.mesh``) and without a mesh
  again, first-token and decode logits recorded; then ``paged_lse``: the paged decode
  kernel's log-sum-exp output against its plain version at the serve
  shape and at recurrentgemma's heads and window, in bf16 and f32, and
  the pool split in two halves, each through the kernel on a rank-local
  table, merged by log-sum-exp (``modules.merge_partials``), against the
  whole pool's kernel, with the kernel's time with and without the lse.
* serve_tp: the serving mesh's tensor parallelism over "model":
  ``llama3.2-3b`` at full width and depth (28 layers, d 3072, 24 q / 8 kv
  heads, d_ff 8192, vocab 128256), bf16, on the serve trace (no EOS: the
  generation lengths are the trace's), dense and ``--paged``, at
  ``--mesh 1x1`` and as model rank 1 of ``--mesh 1x4`` on PyTorch's fake
  process-group backend (collectives launched, no data moved), each mesh
  in a process of its own: the rank computes q heads 6-11 and the kv
  heads 2-3 they read, 2048 of the FFN's 8192 columns and 32064 of the
  vocabulary's rows, and holds a quarter of every cache's lines and
  pool's pages.
* serve_rgemma: ``recurrentgemma-9b`` (38 layers: 12 x (RG-LRU, RG-LRU,
  local attention with a 2048-line window) + 2 RG-LRU; d_model 4096,
  lru_width 4096, MQA 16 x 256, a tied 256000 vocab; 9.40 B params) on
  the serve trace plus one request with a 2304-token prompt (the dense
  ring wraps, paged decode masks by the window): (a) dense (the driver's
  default), (b) ``--paged``, (d) ``--disagg``, each in bf16; then (c)
  dense and paged under the f32 policy, first-token logits recorded.
* serve_mamba2: ``mamba2-2.7b`` on the serve trace: (a) dense, (b)
  ``--paged``, (d) ``--disagg`` (every chunk checksum recorded), in
  bf16; (c) ``--paged`` under the f32 policy, first-token logits
  recorded. The engines' SSD decode runs ``ref.ssd_decode_step`` (the
  reference's route; no kernel) and their prefill from a state
  ``ref.ssd_chunked`` (no kernel), the cache-free forward they are held
  against the SSD scan kernel.
* serve_mesh_recurrent: the recurrent archs on the serving mesh at
  ``--mesh 1x1``: ``recurrentgemma-9b`` (full width and depth)
  ``--paged`` on serve_rgemma's trace and ``mamba2-2.7b`` (full) dense
  on the serve trace, bf16, each served without a mesh, twice through
  ``launch_ranks`` at world 1 and without a mesh again (the mesh program
  reads its per-slot states through ``serve.mesh.RecurrentBlocks``),
  every logit row recorded.
* train_rgemma: the train driver on ``recurrentgemma-9b`` at full width
  cut to 5 layers (one repeat of the pattern and the 2-layer RG-LRU
  tail: 2.17 B params, ~35 GB of params, gradients and AdamW moments;
  the 38 layers would need ~150 GB), one untimed warm-up step, then 3
  steps of batch 2 x seq 4096 (the window bites).
* rglru_scan: the port's RG-LRU scan (``modules._lru_scan``, a doubling
  scan in plain torch) at [2, 4096, 4096] f32 with an h0 against a
  sequential loop, timed forward and backward beside its byte bounds.
* paged_rgemma: paged decode at recurrentgemma's heads (KH 1, G 16, hd
  256) and window on 4 slots of 146 table slots, three past the window,
  in bf16 and f32.
* train_whisper: the train driver on ``whisper-tiny`` at its full config
  (4 encoder layers over 1500 frames, 4 decoder layers with
  cross-attention, d_model 384, 6 heads of 64; 69.0 M params) with the
  driver's zero fronts, one untimed warm-up step, then 3 steps of batch
  8 x seq 256 with the driver's chunked attention;
  train_whisper_flash: the same 3 steps with ``attn_impl="flash"``: the
  decoder's causal self-attention, its cross-attention over the 1500
  encoder frames and the encoder's bidirectional attention through the
  flash kernels, launches counted by shape;
* the flash kernels in cross-attention's regime (not causal, key lengths
  1500 and 1601, not multiples of the 64-row k-tile): the whisper
  encoder (8 x 6 heads, 1500 x 1500), whisper's cross-attention (256 x
  1500) and llama-3.2-vision's (2 x 64 heads over 8 KV heads, 256 x
  1601, hd 128), on the ``flash_cases:`` line;
* serve_whisper / serve_vision: ``whisper-tiny`` (full) and
  ``llama-3.2-vision-90b`` at full width cut to one repeat of its pattern
  (4 self-attention layers and 1 cross-attention layer: 6.39 B params;
  the 100 layers do not fit) served through the driver's lockstep
  fallback (4 slots, 64-token prompts, 16 tokens), every cross-attention
  gate at 0.8 (the reference initialises it to 0, which would hide the
  cross-attention) and random fronts: bf16 timed, with the device ms of
  rebuilding the memory that every decode step pays; then under the f32
  policy against the cache-free forward.
* serve_mesh_lockstep: the lockstep server on the serving mesh at
  ``--mesh 1x1``: whisper-tiny (full) and llama-3.2-vision-90b (5
  layers), gates 0.8, random fronts, bf16, served without a mesh, twice
  through ``launch_ranks`` at world 1 and without a mesh again.

It fails unless:

* every request finishes with its full budget and the page allocator's
  accounting is clean; every train step's loss and grad norm are finite;
* each kernel of a path was launched during that path's run (launch
  counters set to 0 just before it and read just after), every fused GLU,
  flash forward, dq and dk/dv launch, every ``gmm_dw`` launch and every
  bf16, f32 x bf16 and f32 x bf16^T ``gmm_tiled`` launch of the serve,
  train and flash runs (no ``gmm`` launch on the FMA kernel) and every
  ``ssd`` launch of the mamba2 run went through the tensor-core kernels (``gmm_wgmma.cu``, ``gmm_f32_wgmma.cu``,
  ``flash_fwd_wgmma.cu``, ``flash_bwd_wgmma.cu``, ``gmm_dw_wgmma.cu``,
  ``ssd_wgmma.cu``: their design counters), the six wgmma libraries hold
  HGMMA instructions, and each train
  run launched each grouped kernel the expected number of times per layer
  and step (gmm_glu 2: forward + recompute; gmm 8; gmm_dw 3); the chunked
  run no flash kernel, the flash run flash_fwd 2 (forward + recompute),
  flash_dq 1 and flash_dkv 1 per layer and step; the mamba2 run ssd 2
  (forward + recompute) per layer and step and no other kernel;
* the flash run's step-1 loss and grad norm are within 1e-2 relative of
  the chunked run's (the bf16 tier: the two round p at other places);
* the zebra runs launched exactly gmm_glu 4, gmm 14, gmm_dw 6 per layer
  and step (replicated: per microbatch the GLU forward and recompute, gmm
  2 + 5 and gmm_dw 3 of the FFN without row scales) and 8, 28, 12
  (alltoall: one call per dispatch chunk), all on the tensor-core
  designs, with the capacity and block_m above (the engine's record);
  one step of each zebra mode at capacity 6 (= E / top_k: no drops,
  C 1024, block_m 128) is within 1e-2 relative of the --no-zebra run's
  step 1 in loss and grad norm (``zebra_equal:``); the zebra gradient step
  run twice is bitwise equal, and equal to a one-stream run of the same
  override within 1e-4 * max|one-stream| (``zebra_streams:``, with the
  two timings); every grouped kernel at the zebra layouts (12 x 216 rows
  at block_m 8, 2 x 224 + 10 x 112 at block_m 16) agrees with its plain
  version at its tier on the tensor-core design (``zebra_tiles:``, each
  timed beside the same rows at block_m 128);
* the MPMD engine's issue order is Theorem 1's canonical schedule (a
  topological order under ``schedule.dependencies`` keeping each
  stream's list), the MPMD runs launched exactly gmm_glu
  2, gmm 7, gmm_dw 3 per expert call (a lane's chunk or the offloaded
  experts, per microbatch and layer), all on the tensor-core designs,
  with the capacity and block_m above; one MPMD step at capacity 6 (C
  1024, block_m 128), NLL only, against autograd through the port's
  fused W1 and through the SPMD zebra override on the card, each routed
  as the engine routed, with at most 32 of the 8192 token-layer routings
  choosing otherwise in either: under the f32 policy the loss and every
  gradient leaf within 1e-4 * max of both; under the bf16 one the loss
  within 1e-2 of the fused W1's and every leaf within 2e-2 * max of it
  (any two of the three bf16 computations differ by 1.07e-2 to 1.30e-2
  of a leaf's max; ``mpmd_equal:``);
  the MPMD step on its streams is bitwise equal to its
  rerun and within the f32 tier of the same engine on one stream
  (``mpmd_streams:``, with both timings);
* ``mpmd_ranks:``: lane 0 launches the one-process engine's lane
  launches a step over N (gmm_glu 2, gmm 7, gmm_dw 3 per chunk, layer
  and microbatch), every expert call at [E_lane, C_chunk, 2048], no
  attention; attention rank 0 gmm_glu 2, gmm 7, gmm_dw 3 per
  offloaded-expert call, none at a lane's shape, every attention call at
  [1, 256, 2048]; all on the tensor-core designs; each rank's peak
  ``torch.cuda.max_memory_allocated`` below the one-process engine's in
  ``train_mpmd:``; every loss finite (the fake backend's values are not
  checked; each rank's step ms, labelled one rank's compute with the
  point-to-point sends not run, its peak beside the one-process one and
  its messages and bytes a step by kind printed);
* the resumed steps 3-4 of ``train_ckpt`` give the straight run's losses
  and grad norms, and its params and moments after step 4, bit for bit,
  and launch exactly the zebra counts per layer and step, all wgmma (the
  line: bytes written, each save's host snapshot and write seconds, the
  write timed on its thread for an async save, the restore's seconds);
* ``train_accum`` launches exactly twice the zebra counts per layer and
  step (8 / 28 / 12), all wgmma, with finite losses and grad norms, and at
  capacity 6 (no drops) its step-1 loss is within 1e-2 of the
  ``accum_steps=1`` step 1 (the aux losses are averaged over the slices);
* the ``remat_dots`` step equals the ``full`` step bit for bit in loss,
  grad norm and every updated param and moment (both gradient-phase
  times and peak memories on the line);
* every int8 tensor, scale and residual of ``compress`` on the card
  equals the CPU's bit for bit (IEEE division and round-half-even on
  both), and ``compressed_psum`` without a process group returns the
  dequantized tree (wire bytes against f32 bytes on the line);
* ``train_trace`` ends ``ok`` with one ``[train] zebra-sim:`` line, the
  ``[train] idle:`` lines and a trace of more than 0 events, its losses
  and grad norms bitwise those of the untraced ``train_zebra`` run's
  first 3 steps;
* ``train_mesh``: the ``--mesh 1x1`` losses and every param leaf after
  step 3 within 1e-6 (of the loss, of max|leaf|) of the one-process
  program's, exactly the zebra launches per layer and step (all wgmma),
  no collective launched, this rank's param and optimizer bytes equal
  to the sharding rules' block shapes; a 1xn / nx1 run's losses within
  1e-2 of the world-1 run's (the step ms of both programs, the
  collective count and the bytes printed);
* ``train_sp``: on rank 1 of the fake 1x6 world every attention call at
  3 q and 3 kv heads (chunked, counted at the call, and flash), every
  block's checkpoint keeping [8, 43, 2048] in storage of that size (a
  saved-tensor hook), exactly the zebra launches per layer and step (all
  wgmma) and flash 4 / 2 / 2 (forward, dq, dk/dv) per layer and step,
  and a peak ``torch.cuda.max_memory_allocated`` below the 1x1 run's
  (the rank's step ms, labelled one rank's compute with the collectives
  not run, both peaks and the collectives by kind printed; the fake
  backend's values are not checked);
* each kernel agrees with its plain PyTorch version on the card, at the
  main path's shapes: bf16 outputs within 2e-2 * min(1, max|plain|) (the
  bf16 tier, scaled down where the outputs stay below 1; per decode slot
  for paged decode), f32 outputs within 1e-4 * max|plain| (f32 sums in
  another order only); paged decode also at a long context (4 slots x
  4096 positions) and in f32 (the ``paged_cases:`` line, with the split
  count of each case);
* the MoE FFN's five gradients (dx, dwg, dwu, dwo, dscales) from its
  autograd Function (the kernels) agree with autograd through the plain
  composition within 1e-4 * max|plain| each, at one layer's train shapes
  in f32, and in bf16 (x, weights and row scales as the train runs give
  them: the tensor-core GLU and the f32 x bf16^T data gradients) within
  2e-2 * min(1, max|plain|); so do the flash attention Function's dq, dk,
  dv against
  autograd through the attention oracle; in bf16 at the flash run's
  attention shape the Function's output and dq, dk, dv agree with the
  plain forward and backward at the bf16 tier;
* every grouped kernel (the six ``gmm_tiled`` operand types, the fused GLU
  in bf16 and f32, ``gmm_dw`` with a bf16 and an f32 lhs; the bf16 ones,
  f32 x bf16, f32 x bf16^T and ``gmm_dw`` on the tensor-core design) takes
  block_m 8,
  16 and 32 and agrees with its plain version there;
* the flash kernels agree with their plain versions at the train shape
  and at batch 2 x seq 1024 (causal tile skipping), with a window, with a
  softcap (forward) and in f32;
* the SSD scan kernel agrees with its plain version at the mamba2 run's
  shape, at a ragged T (2 x 1000) and at T < 128, in bf16 (the tensor-core
  design; a bf16 case on another design fails the run) and f32 (the FMA
  design) (y at the tiers above, the f32 final state within 1e-4 *
  max|plain|), and the
  SSD autograd Function on the card agrees with the same Function on the
  CPU in f32 (y and state within 1e-4 * max, the five gradients within
  1e-3 * max: the backward's f32 exp(cum_i - cum_j) is only as exact as
  the ulp of a chunk's cum, 2.4e-4 at |cum| ~ 3000);
* under the f32 policy, the paged engine's first-token logits of the
  trace's first request whose prompt spans several prefill chunks match
  the cache-free forward's within 1e-3 * max|logit|;
* serve_prefix: every request of both bf16 runs finishes (``ok``), with
  at least 1 prefix hit, 192 skipped tokens and 1 COW fork in the cached
  run, the allocator and the index clean and an empty pool after the
  index's ``flush()``; under the f32 policy the first-token logits of
  every prefix-hit request and of the repeat within 1e-3 * max|logit| of
  the cache-free forward (the share of bf16 greedy tokens equal to the
  uncached run's is reported, not gated: a shorter prefill chunk may
  route the MoE otherwise);
* serve_disagg: every request finishes, both allocators clean at every
  tick and after the run, at least 1 preemption, transfers = requests +
  re-prefills, every shipped leaf page-granular ([4, 4, 16, 4, 128] for K
  and V, [4, 4, 16] for the positions), and every request's first-token
  logits within 1e-3 * max of the unified engine's (bitwise equality
  reported);
* serve_disagg_prefix: at least 1 full hit, transfers = requests - full
  hits + re-prefills, the decode index and both allocators clean and an
  empty decode pool after ``flush()``;
* serve_trace: both traced runs ``ok`` with more than 0 events and the
  ``[serve] idle:`` lines, greedy tokens bitwise the unified engine's
  untraced run's (serve_disagg), and the same tick-clock signature;
* serve_dense: every request finishes, the GLU and ``gmm`` kernels
  launched (every launch on the tensor-core design) and the paged decode
  kernel not; every f32 first-token logit within 1e-5 * max of the paged
  engine's;
* serve_fleet: every request finishes, every group's allocator clean at
  every tick, zero pages in use after the drain and no group leaking, at
  least one flip and one death, the GLU, ``gmm`` and paged decode kernels
  launched (tensor-core GLU and ``gmm``); ``torch.cuda.memory_allocated``
  after the run exceeds the one before by the compute-dtype params and
  the live groups' pools and less than half a pool more (a pool dropped
  at a flip or rejoin is released), and is back where it was once the
  fleet is dropped; the f32 fleet's greedy tokens equal the unified paged
  engine's, or the first divergence is a near-tie: the cache-free
  forward's top-2 margin there within 1e-4 * max|logit|;
* serve_ep: (a) every request finishes, GLU and ``gmm`` launched exactly
  2 (chunks) x 4 (layers) per prefill chunk and decode step, paged
  decode 4 per decode step, every GLU and ``gmm`` launch on the
  tensor-core design, the decode steps' GLU calls at block_m 8, one EMA
  update a decode step; (b) every f32 first-token logit within 1e-3 *
  max of the replicated engine's, and the greedy tokens equal or the
  first divergence a near-tie (top-2 margin within 1e-4 * max|logit|);
  (c) exactly one re-balance, with live slots, every token bitwise (b)'s
  EP run's, the allocator clean at every tick and empty after; (d) every
  request finishes, no paged decode launch; (e) every request finishes,
  the decode worker's EMA updated; ``ep_tiles``: each kernel within its
  tier of its plain version on the tensor-core design;
* serve_mesh: every request finishes in all four runs; each run's
  tokens and every recorded f32 logit row bitwise the first one-device
  run's, 0 collectives launched, each run's launches equal the first's,
  each serve kernel launched (no paged decode launch dense); ``paged_lse``: each output within its tier
  of the plain version and bitwise the call without lse, each lse within
  1e-5 * max(1, max|lse|) of the plain one with -inf where it is; the
  two-half merge within 1e-5 * max|whole| (f32) or 2e-2 * min(1,
  max|whole|) (bf16, the values scaled by GRAD_BF16_CT);
* serve_tp: on rank 1 of the fake 1x4 world, in both modes, every
  attention call at 6 q and 2 kv heads, every FFN at width 2048 and
  summed over "model" by one collective, every unembedding a block of 32064 columns before its gather, as many decode
  steps as the 1x1 run, the paged decode launches a decode step equal to
  the 1x1 run's (28), and a peak ``torch.cuda.max_memory_allocated``
  below the 1x1 run's (TTFT p50, ITL p50 and tok/s of both runs, labelled
  one rank's compute with the collectives not run, both peaks and the
  collectives by kind with their bytes printed);
* train_mpmd: one step traced (``obs.trace.Tracer`` installed) is bitwise
  the untraced step, loss and every gradient leaf, with the reference's
  spans (R embed, head and embed^B, R * L F and B);
* serve_rgemma: every request of every run finishes, the allocators
  clean (both checked every tick under disagg), paged decode launched
  exactly 12 times (the local-attention layers) a decode step in the
  paged and disagg runs and never in the dense one, transfers =
  requests + re-prefills; under f32 every request's first-token logits
  within 1e-3 * max|logit| of the cache-free forward, the dense
  engine's within 1e-5 * max of the paged engine's, and the dense and
  paged tokens equal or diverging at a top-2 margin within 1e-4 *
  max|logit|;
* serve_mamba2: every request finishes, the allocators clean, the
  disagg transfers = requests + re-prefills with 0 KV bytes and every
  chunk's checksum 0 (the CRC of an empty payload); under f32 every
  first-token logits within 1e-3 * max|logit| of the cache-free forward;
* serve_mesh_recurrent: every request of the four runs of each arch
  finishes; tokens and every recorded f32 logit row bitwise the first
  run's; 0 collectives; each run's launches equal the first run's;
  recurrentgemma's paged decode launched exactly 12 times a decode step;
* train_rgemma: every loss and grad norm finite;
* rglru_scan: the scan within 1e-5 * max|loop| of the loop; paged_rgemma
  at the paged decode tiers above;
* train_whisper: finite losses and grad norms, no hand-written kernel
  launched; train_whisper_flash: finite, exactly flash_fwd 2, flash_dq 1
  and flash_dkv 1 per attention call and step at each of its three
  shapes, all on the tensor-core design, step 1 within 1e-2 of the
  chunked run's in loss and grad norm; the flash kernels at the three
  cross-attention shapes within the bf16 tier of their plain versions on
  the tensor-core design;
* serve_whisper, serve_vision: the lockstep run generates every token;
  under f32 the first-token logits within 1e-3 * max|logit| of the
  cache-free forward, the greedy tokens equal to greedy decoding by the
  forward or diverging at a top-2 margin within 1e-4 * max|logit|, and
  the forward's logits at gate 0 more than 1e-3 * max away (the check is
  not vacuous);
* serve_mesh_lockstep: each arch's four lockstep runs generate every
  token, their tokens and prefill logits bitwise the first run's, 0
  collectives, each run's launches equal the first run's.

One untimed warm-up request (its own engine) and one untimed warm-up train
step (its own model; the zebra run has its own too) run before the timed
runs, launches not counted, so
that one-time costs (library handles, allocator growth) stay out of the
timed windows. The serve model is released before the train phase.

Printed in order: the device line (torch's name and nvidia-smi's name and
power limit), the kernel build time with each library's HGMMA count, the
warm-up and serve runs' lines,
the serve_prefix, serve_disagg, serve_disagg_prefix, serve_trace,
serve_dense, serve_fleet, serve_ep and ep_tiles lines (each as its
phase ends), the train
runs' lines, the train_ckpt, train_accum, remat_dots, compress,
train_trace, train_mesh, train_sp and dryrun lines (each as its phase
ends), the serve_tp line (after serve_mesh), the
kernel
tolerances,
the ``kernels`` JSON line
(each entry also names its ``design``: ``"wgmma"`` or ``"fma"``; ``ms``,
``plain_ms`` and ``library_ms`` are device times per call, read with CUDA
events behind a spin kernel that keeps the host's queueing out of them,
``host_ms`` is the kernel wrapper's host time per call, and ``fma_ms``
the FMA kernel that a tensor-core design replaced, on the same inputs:
the fused GLU, f32 x bf16 and f32 x bf16^T ``gmm``, ``gmm_dw``, flash
backward and SSD entries),
the serve, parity, train, train_flash, train_mamba2, grad, grad_bf16,
flash_grad,
flash_grad_bf16, c1_tiles, paged_cases, flash_cases (the flash kernels at
every case
shape, with ``fma_ms``: the FMA dq or dk/dv kernel that the tensor-core
design replaced, timed on the same bf16 inputs), ssd_cases (with
``fma_ms`` on the tensor-core design), ssd_grad, train_zebra, zebra_a2a,
zebra_equal, zebra_streams, zebra_tiles, train_mpmd, mpmd_chunks,
mpmd_equal and mpmd_streams lines (the serve_rgemma, serve_mamba2,
train_rgemma, rglru_scan, paged_rgemma, mpmd_ranks, train_whisper,
train_whisper_flash, serve_whisper, serve_vision, serve_mesh_recurrent
and serve_mesh_lockstep lines print as their phases end, before the
kernels line), and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no result.
Details (nvcc register reports, the full result) go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import math
import pathlib
import subprocess
import sys
import time
import weakref

ROOT = pathlib.Path(__file__).resolve().parent
SERVE_ARGS = ["--arch", "mixtral-w2", "--paged", "--page-size", "16",
              "--prefill-chunk", "256", "--prompt-len", "384", "--gen", "32",
              "--slots", "4", "--requests", "6"]
WARMUP_ARGS = SERVE_ARGS + ["--requests", "1", "--gen", "4"]  # last wins
TRAIN_ARGS = ["--arch", "mixtral-w1", "--no-zebra", "--mesh", "1x1",
              "--steps", "6", "--batch", "8", "--seq", "256"]
TRAIN_WARMUP_ARGS = TRAIN_ARGS + ["--steps", "1"]
SERVE_KERNELS = ("gmm_glu", "gmm", "paged_decode")
# the serving deployments of the prefix cache and disaggregation on W2
PREFIX_ARGS = SERVE_ARGS + ["--prefix-cache", "--fair", "--tenants", "2",
                            "--requests", "8", "--shared-prefix-len", "192"]
REPEAT_AFTER = 64           # ticks after the last arrival: a drained system
UNPAGED_ARGS = [a for a in SERVE_ARGS if a != "--paged"]
# 34 decode pages: 2 preemptions on this trace (40, ~1.5 sequences of 26
# pages, preempts none: admission waits for pages instead)
DISAGG_ARGS = UNPAGED_ARGS + ["--disagg", "--pool-pages", "34"]
DISAGG_PREFIX_ARGS = [a for a in PREFIX_ARGS if a != "--paged"] + [
    "--disagg", "--pool-pages", "160"]
# page-granular payload leaves: [layers, chunk pages, lines, KV heads, hd]
# for K and V, [layers, chunk pages, lines] for the positions
DISAGG_SHAPES = {(4, 4, 16, 4, 128), (4, 4, 16)}
# The dense continuous mode (the driver's default: no --paged) and the
# fleet on the serve trace: 2 prefill + 2 decode groups, role flips on,
# group 2 (the first decode group, two requests in flight then) killed at
# tick 10, and the chaos matrix's "standard" schedule (drops, a corrupt
# chunk, a stall, a heartbeat flap that zombifies group 3 from tick 6):
# with g2 dead and g3 fenced no decode group is left, so a prefill group
# is flipped to decode; the zombie rejoins at generation 1.
DENSE_ARGS = UNPAGED_ARGS
FLEET_CHAOS = ("drop%0.5*2;corrupt*1;stall*1;hb_loss@6:g3~8", "909")
FLEET_ARGS = UNPAGED_ARGS + [
    "--fleet", "--prefill-groups", "a40,a40", "--decode-groups",
    "v100,v100", "--fleet-elastic", "--kill-group", "2@10", "--chaos",
    FLEET_CHAOS[0], "--chaos-seed", FLEET_CHAOS[1]]
DENSE_REL = 1e-5            # f32 dense vs paged first-token logits
F32_TIER = 1e-4             # an f32 divergence's top-2 margin / max|logit|
# Expert-parallel decode at one EP rank on the serve trace: (a) paged,
# planned placement (the routing EMA's drift checked every 8 decode
# steps), bf16; (b) the same in f32; (c) f32, uniform placement, an
# explicit re-balance to the reversed slot order after tick 5; (d) dense;
# (e) disaggregated (the 34-page decode pool).
EP_FLAGS = ["--ep-size", "1", "--ep-placement", "planned"]
EP_ARGS = SERVE_ARGS + EP_FLAGS
EP_UNIFORM_ARGS = SERVE_ARGS + ["--ep-size", "1"]
EP_DENSE_ARGS = UNPAGED_ARGS + EP_FLAGS
EP_DISAGG_ARGS = DISAGG_ARGS + ["--ep-size", "1"]
EP_REBALANCE_TICK = 5
EP_CHUNKS = 2               # the driver's all-to-all chunks (EPCfg)
# the grouped kernels at W2's EP layouts (24 experts): one all-to-all
# chunk of a decode step (4 slots: C 16 in 2 chunks of 8 rows) and of a
# 256-token prefill chunk (C 256 in 2 chunks of 128)
EP_TILES = (("ep decode chunk", [8] * 24, 8),
            ("ep prefill chunk", [128] * 24, 128))
# Launches per layer and train step: the forward and its remat recompute
# (one GLU and one down GEMM each), and the MoE FFN backward (gmm: g, u,
# y, dh, dx twice; gmm_dw: dwo, dwg, dwu).
TRAIN_LAUNCHES = {"gmm_glu": 2, "gmm": 8, "gmm_dw": 3}
# ... and of the flash attention kernels under attn_impl="flash" (0 under
# the chunked attention): forward and its remat recompute, one backward.
FLASH_LAUNCHES = {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}
FLASH_GAP = 1e-2            # flash vs chunked step-1 loss / grad norm
# zebra, the train driver's default for MoE archs (replicated, 2
# microbatches of 1024 tokens, capacity 1.25: C 216, block_m 8)
ZEBRA_ARGS = ["--arch", "mixtral-w1", "--mesh", "1x1", "--steps", "6",
              "--batch", "8", "--seq", "256"]
A2A_FLAGS = ["--zebra-mode", "alltoall", "--n-chunks", "2",
             "--offload-experts", "2"]
ZEBRA_A2A_ARGS = ZEBRA_ARGS + ["--steps", "3"] + A2A_FLAGS
# Launches per layer and step under zebra, no row scales (the combine
# weights multiply outside the FFN): per expert call the GLU forward and
# its remat recompute (2), gmm forward + recompute (2) and backward g, u,
# dh, dx twice (5), gmm_dw 3; one call per microbatch (R = 2) in
# replicated mode, one per dispatch chunk (Q = 2) in alltoall mode.
ZEBRA_LAUNCHES = {"gmm_glu": 4, "gmm": 14, "gmm_dw": 6}
ZEBRA_A2A_LAUNCHES = {"gmm_glu": 8, "gmm": 28, "gmm_dw": 12}
ZEBRA_ENGINE = {"replicated": ([216], [8]),   # (capacities, block_m)
                "alltoall": ([224], [16])}    # chunks of 112 rows
# the training mesh (train_mesh:): the driver's zebra default through
# --mesh 1x1, the mesh program on one NCCL rank, against the one-process
# program; where the machine has n >= 2 cards, also 1xn and nx1
MESH_ARGS = ["--arch", "mixtral-w1", "--mesh", "1x1", "--steps", "3",
             "--batch", "8", "--seq", "256"]
MESH_TIER = 1e-6            # world 1 vs one process: loss, leaf / max|leaf|
# one rank of a wider training mesh (train_sp:): model rank SP_RANK of
# --mesh 1xSP_M on the fake process-group backend, which moves no data, so
# the rank's own kernels, shapes and memory are real. W1's 16 q heads over
# 6 ranks: blocks of 3 (rank 1: q heads 3-5, which read kv heads 0, 1, 1:
# groups of unequal size, so its kv heads repeat to one per q head); its 4
# kv heads, wq / wk / wv / wo (2048 or 512 columns) and the 32000-row head
# do not divide over 6 and stay whole; 2 of the 12 experts; the residual
# stream between blocks in seq blocks of ceil(256 / 6) = 43
SP_M, SP_RANK = 6, 1
SP_HEADS = [3, 3]           # [q heads, kv heads] of every attention call
SP_KEPT = [8, 43, 2048]     # what each block's checkpoint keeps (bf16)
SP_FLASH_STEPS = 2
# flash launches per layer and step under zebra (2 microbatches): the
# forward and its recompute, dq and dk/dv, per microbatch
SP_FLASH_LAUNCHES = {"flash_fwd": 4, "flash_dq": 2, "flash_dkv": 2}
# the dry run (dryrun:): the train_zebra configuration (arch, batch, seq;
# zebra replicated, 2 microbatches) at 1x1, then two production cells at
# 16x16, rank 0; the phase's wall seconds are printed beside
# DRYRUN_BUDGET_S, the time it is meant to take on the card's host
DRYRUN_CHECK = ("mixtral-w1", 8, 256)
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k"),
                ("llama3.2-3b", "decode_32k"))
DRYRUN_BUDGET_S = 120.0
MESH_BF16_TIER = 1e-2       # world n vs world 1 (bf16, per-shard capacity)
ZEBRA_EQUAL_CF = 6.0        # = E / top_k: no drops, C 1024, block_m 128
ZEBRA_GAP = 1e-2            # zebra (no drops) vs --no-zebra step 1
# the driver's checkpoint and resume (train_ckpt:) on W1 cut to this many
# layers: 0.67 B params, 8.04 GB with the two AdamW moments per save
CKPT_LAYERS = 1
CKPT_ARGS = ZEBRA_ARGS
ACCUM_STEPS = 3             # timed accum_steps=2 steps, after one warm-up
# the zebra MPMD engine (launch/hetero_mpmd.py's default: mixtral-w1 at
# full width, the planner's offloads (1, 2, 1, 2) clamped to E // 2, 4
# expert lanes on the card, 2 microbatches of 1024 tokens, capacity 1.25)
MPMD_STEPS = 3              # timed steps, after one untimed warm-up step
# Launches per expert call: the forward (GLU, down gmm), and in the
# backward the stage recompute (GLU, down gmm) and the MoE FFN backward
# without row scales (gmm g, u, dh, dx twice; gmm_dw 3).
MPMD_CALL = {"gmm_glu": 2, "gmm": 7, "gmm_dw": 3}
# (C, C_chunk, block_m of a lane's chunk, block_m of the offloaded experts)
MPMD_ENGINE = {1: (216, 216, 8, 8), 2: (224, 112, 16, 32)}
MPMD_EQUAL_CF = 6.0         # = E / top_k: no drops, C 1024, block_m 128
MPMD_GAP = 1e-2             # the bf16 loss vs the fused W1's
# bf16 gradient leaves vs the fused W1's, of each leaf's max: any two bf16
# computations of this step (the engine, the SPMD zebra override, the
# fused W1) differ by 1.07e-2 to 1.30e-2 at their worst leaves on the
# H100, the same comparisons in f32 by at most 9e-6 (PERF.md)
MPMD_BF16_LEAF = 2e-2
MPMD_FLIPS = 32             # of 8192 token-layer routings (1-8 measured)
# the engine across ranks (mpmd_ranks:): hetero_mpmd's default at --ranks
# MxN on the fake process-group backend (messages and collectives
# launched, moving no data), attention rank 0 and lane 0 (rank M), each in
# a process of its own
MPMD_RANKS = (4, 4)
MPMD_RANKS_STEPS = 3
MAMBA2_ARGS = ["--arch", "mamba2-2.7b", "--mesh", "1x1", "--steps", "6",
               "--batch", "2", "--seq", "2048"]
MAMBA2_WARMUP_ARGS = MAMBA2_ARGS + ["--steps", "1"]
# ... of the mamba2 run: the SSD scan's forward and its remat recompute
# (the backward is autograd of ref.ssd_chunked, no kernel), nothing else;
# one per ssd_scan call, whatever the CUDA launches of its design.
MAMBA2_LAUNCHES = {"ssd": 2}
SSD_REPLACES = "src/repro/kernels/ssd.py:82"
SSD_GRAD_TOL = 1e-3         # SSD Function gradients, card vs CPU (f32)
FLASH_REPLACES = {
    "flash_fwd": "src/repro/kernels/flash_attention.py:122",
    "flash_dq": "src/repro/kernels/flash_attention.py:245",
    "flash_dkv": "src/repro/kernels/flash_attention.py:271"}
# the libraries built on wgmma: each must hold HGMMA in its SASS
WGMMA_LIBS = ("gmm_wgmma", "gmm_f32_wgmma", "gmm_dw_wgmma",
              "flash_fwd_wgmma", "flash_bwd_wgmma", "ssd_wgmma")
# gmm_tiled operand types that run on the tensor cores on the main paths
# (bf16 operands; f32 x bf16 and f32 x bf16^T at K and N multiples of 8)
WGMMA_GMM = ("gmm:bf16.bf16->bf16", "gmm:bf16.bf16->f32",
             "gmm:f32.bf16->f32", "gmm:f32.bf16T->f32")
GRAD_BF16_CT = 0.05         # cotangent scale: every bf16 gradient below 2
# the serving mesh (serve_mesh:): the serve trace dense and paged at 1x1
MESH_SERVE = ("dense", "paged")
# the serving mesh's tensor parallelism (serve_tp:): llama3.2-3b at full
# width and depth on the serve trace, at 1x1 and as model rank TP_RANK of
# 1xTP_M on the fake backend: q heads in blocks of 6 (rank 1: q heads
# 6-11, reading kv heads 2-3), d_ff 8192 in blocks of 2048, the vocabulary
# 128256 in blocks of 32064
TP_ARCH = "llama3.2-3b"
TP_M, TP_RANK = 4, 1
TP_ARGS = ["--arch", TP_ARCH] + UNPAGED_ARGS[2:]
TP_HEADS = [6, 2]           # [q heads, kv heads] of every attention call
TP_FFN = 2048               # "mlp" columns of every FFN call
TP_VOCAB = 32064            # logit columns of every unembedding block
TP_LAYERS = 28              # attention layers: paged decode a step
LSE_TIER = 1e-5             # lse, kernel vs plain: of max(1, max|lse|)
MERGE_F32_TIER = 1e-5       # two-half merge vs the whole pool (f32)
C1_BLOCK_M = (8, 16, 32)    # the row tiles under 64 (capacity routing)
# the zebra runs' packed layouts: (label, rows of each expert, block_m)
ZEBRA_TILES = (("replicated", [216] * 12, 8),
               ("alltoall chunk 0", [224] * 2 + [112] * 10, 16))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
TOL_BF16 = 2e-2             # the bf16 tier of tests/test_kernels.py:40
TOL_F32 = 1e-4              # f32 outputs: sum order only
PARITY_REL = 1e-3
# The recurrent archs (RG-LRU and SSD mixers), served at full width and
# depth on the serve trace. recurrentgemma-9b's trace gains one request
# whose prompt passes its 2048-line window (the dense ring wraps, paged
# decode masks by the window): max_len = 2304 + 32.
RGEMMA = "recurrentgemma-9b"
MAMBA2 = "mamba2-2.7b"
LONG_PROMPT = 2304
RGEMMA_PAGED_ARGS = SERVE_ARGS + ["--arch", RGEMMA, "--prompt-len",
                                  str(LONG_PROMPT)]
RGEMMA_DENSE_ARGS = [a for a in RGEMMA_PAGED_ARGS if a != "--paged"]
RGEMMA_DISAGG_ARGS = RGEMMA_DENSE_ARGS + ["--disagg"]
RGEMMA_ATTN_LAYERS = 12     # local_attn layers: paged decode launches a step
MAMBA2_PAGED_ARGS = SERVE_ARGS + ["--arch", MAMBA2]
MAMBA2_DENSE_ARGS = [a for a in MAMBA2_PAGED_ARGS if a != "--paged"]
MAMBA2_DISAGG_ARGS = MAMBA2_DENSE_ARGS + ["--disagg"]
# recurrentgemma-9b trained at full width cut to 5 layers: one repeat of
# (rglru, rglru, local_attn) and the 2-layer rglru tail (2.17 B params,
# ~35 GB of f32 params, gradients and AdamW moments; the 38 layers' 9.40 B
# would need ~150 GB), batch 2 x seq 4096 so that the window bites
RGEMMA_TRAIN_LAYERS = 5
RGEMMA_TRAIN_ARGS = ["--arch", RGEMMA, "--mesh", "1x1", "--steps", "3",
                     "--batch", "2", "--seq", "4096"]
RGLRU_SCAN_SHAPE = (2, 4096, 4096)   # the train run's [B, S, lru_width]
# The cross-attention archs. whisper-tiny at its full config (4 encoder
# layers over 1500 frames, 4 decoder layers with cross-attention, d 384, 6
# heads of 64: 69.0 M params) trained by the driver and served lockstep;
# llama-3.2-vision-90b at full width cut to one repeat of its pattern (4
# self-attention layers and 1 cross-attention layer over 1601 patches:
# 6.39 B params; the 100 layers are ~180 GB in bf16) served lockstep. Its
# training (f32 weights, gradients and two AdamW moments: ~102 GB at 5
# layers) does not fit the card and is held on the CPU against the JAX
# trainer (tests/test_torch_xattn_train.py).
WHISPER = "whisper-tiny"
VISION = "llama-3.2-vision-90b"
VISION_LAYERS = 5
WHISPER_TRAIN_ARGS = ["--arch", WHISPER, "--mesh", "1x1", "--steps", "3",
                      "--batch", "8", "--seq", "256"]
# attention calls of a whisper train step: 4 decoder layers x (causal self
# + cross over the 1500 frames) and 4 bidirectional encoder layers; each
# launches flash_fwd 2 (forward + remat recompute), dq 1, dk/dv 1
WHISPER_ATTN = {(256, 256, True): 4, (256, 1500, False): 4,
                (1500, 1500, False): 4}
XATTN_SERVE_ARGS = ["--slots", "4", "--prompt-len", "64", "--gen", "16"]
# the reference initialises every cross-attention gate to 0 (tanh(0) = 0:
# the cross-attention adds nothing) and its drivers feed zero fronts; the
# serve phases set the gates here and draw random fronts, so that the
# cross-attention moves the logits they hold
XATTN_GATE = 0.8
# the flash kernels in cross-attention's regime (not causal, T not a
# multiple of the 64-row k-tile, T > S): (label, B, S, T, H, KH, hd)
XATTN_FLASH_CASES = (("whisper encoder", 8, 1500, 1500, 6, 6, 64),
                     ("whisper cross", 8, 256, 1500, 6, 6, 64),
                     ("vision cross", 2, 256, 1601, 64, 8, 128))


_SPIN_CYCLES_PER_MS = []


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin kernel on this
    card (measured once)."""
    if not _SPIN_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def cuda_times(fn, iters: int, warmup: int = 2) -> tuple:
    """(device ms, host ms) per call of ``fn`` over ``iters`` back-to-back
    calls. Device: CUDA events around the calls, queued behind a spin
    kernel that holds the card until the host has queued them all, so the
    reading is the card's time even where a wrapper's host cost per call
    (argument checks, ctypes, tensor-map encoding) exceeds its kernel's.
    Host: the host's time to queue one call. The spin is sized from one
    call's host time and lengthened if the host outran it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    spin_ms = 2e3 * (time.perf_counter() - t0) * iters + 1.0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms(torch)))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        if queued_ms < spin_ms:
            break
        spin_ms = 2 * queued_ms
    return start.elapsed_time(end) / iters, queued_ms / iters


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` per call (:func:`cuda_times`)."""
    return cuda_times(fn, iters, warmup)[0]


def kernel_times(fn, iters: int) -> dict:
    """``ms`` (device) and ``host_ms`` of a kernel wrapper's call."""
    ms, host_ms = cuda_times(fn, iters)
    return {"ms": ms, "host_ms": host_ms}


def bound(bytes_moved: float, flops: float, peak: float = BF16_FLOPS):
    """Least time in ms: bytes over the HBM rate or operations over
    ``peak`` (the bf16 tensor-core rate for bf16 operands, FP32_FLOPS
    where an operand is f32), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_f32(got, want):
    """(max abs error, tolerance, ok) for f32 outputs: 1e-4 * max|plain|."""
    err = float((got.float() - want.float()).abs().max())
    tol = TOL_F32 * float(want.float().abs().max())
    return err, tol, err <= tol


def grouped_mm_ms(torch, fn):
    """(ms, note) of a ``torch._grouped_mm`` yardstick call, or (None, the
    reason) where this torch lacks it or refuses the operands."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm not in this torch"
    try:
        return cuda_ms(fn, 5), "torch._grouped_mm"
    except RuntimeError as e:  # optional yardstick: record why not
        return None, f"torch._grouped_mm refused: {str(e)[:160]}"


def compare(got, want, per_row: bool = False):
    """(max abs error, tolerance, ok): 2e-2 scaled down to the outputs'
    size where they stay below 1, never looser than 2e-2. ``per_row``
    scales it to each row of the leading axis (each decode slot) on its
    own; the tolerance reported is then the tightest row's."""
    diff = (got.float() - want.float()).abs()
    size = want.float().abs()
    if per_row:
        dims = tuple(range(1, diff.dim()))
        err, top = diff.amax(dims), size.amax(dims)
    else:
        err, top = diff.max()[None], size.max()[None]
    tol = TOL_BF16 * top.clamp(max=1.0)
    return (float(err.max()), float(tol.min()), bool((err <= tol).all()))


def with_design(fn, default: str = "fma"):
    """(fn(), design): the design ("wgmma" or "fma") whose launch counter
    the call moved, for the wrappers that count one (gmm_tiled, the flash
    forward); ``default`` for the kernels that have one design only."""
    from repro_torch import kernels
    before = kernels.design_launch_counts()
    out = fn()
    after = kernels.design_launch_counts()
    moved = sorted({k.split(":")[1] for k in after if after[k] > before[k]})
    return out, "+".join(moved) or default


def check_designs(label: str, counts: dict):
    """Every fused GLU launch of a main-path run (bf16, K and N multiples
    of 8 on these paths), every flash forward, dq and dk/dv launch (bf16
    at head_dim 128), every ``gmm_dw`` launch (K and N multiples of 8),
    every ``ssd`` launch (bf16, head_dim 64, state 128, chunk 256, views of
    the conv output with 16-byte aligned strides and bases) and every
    bf16, f32 x bf16 or f32 x bf16^T ``gmm_tiled`` launch took the
    tensor-core kernel (design counters; the ``gmm:wgmma`` count must equal
    those operand types' launches, the only ones that route there, and no
    ``gmm`` launch may take the FMA kernel). HGMMA in the built libraries'
    SASS shows that those kernels use the tensor cores."""
    for k in ("gmm_glu", "gmm_dw", "flash_fwd", "flash_dq", "flash_dkv",
              "ssd"):
        if counts[f"{k}:wgmma"] != counts[k]:
            raise RuntimeError(f"{label}: a {k} launch did not take the "
                               f"tensor-core kernel: {counts}")
    if counts["gmm:wgmma"] != sum(counts[v] for v in WGMMA_GMM) \
            or counts["gmm:fma"]:
        raise RuntimeError(f"{label}: a bf16 or f32 x bf16 gmm launch did "
                           f"not take the tensor-core kernel: {counts}")


def kernel_source(name: str, design: str) -> str:
    """The CUDA source of a grouped kernel's design (entry ``name``)."""
    if name.startswith("gmm_dw"):
        f = {"wgmma": "gmm_dw_wgmma.cu", "fma": "gmm_dw.cu"}[design]
    elif name.startswith("gmm:f32.bf16") and design == "wgmma":
        f = "gmm_f32_wgmma.cu"
    else:
        f = {"wgmma": "gmm_wgmma.cu", "fma": "gmm.cu"}[design]
    return f"src/repro_torch/csrc/{f}"


def kernel_replaces(name: str) -> str:
    """The Pallas call site a grouped kernel entry replaces."""
    line = (300 if name.startswith("gmm_dw")
            else 222 if name.startswith("gmm_glu") else 69)
    return f"src/repro/kernels/gmm.py:{line}"


def fma_launch(torch, lib, entry: str, tensors, out, *ints):
    """A call of the FMA kernel ``entry`` of ``lib`` (csrc/gmm.cu or
    csrc/gmm_dw.cu: the design that a tensor-core kernel replaced) on the
    same inputs, through its C entry, writing ``out``: no launch counter
    moves. ``ints``: the entry's int arguments after its pointers."""
    from repro_torch.kernels import gmm
    fn = getattr(lib, entry)
    ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()]

    def launch():  # out lives as long as the closure
        gmm._raise_on(fn(*ptrs, *ints,
                         torch.cuda.current_stream().cuda_stream),
                      f"{entry} (fma)")
    launch.out = out
    return launch


def fma_glu(torch, lhs, wg, wu, tg, block_m: int):
    """The FMA fused GLU (csrc/gmm.cu) on the pair-form inputs."""
    from repro_torch.kernels import gmm
    (Mp, K), N = lhs.shape, wg.shape[-1]
    return fma_launch(torch, gmm._lib(), "gmm_glu_bf16", (lhs, wg, wu, tg),
                      torch.empty((Mp, N), dtype=lhs.dtype,
                                  device=lhs.device),
                      Mp, K, N, N, 0, block_m)


def tile_ends(torch, tg, n_groups: int, block_m: int):
    """int32 end row of each group in the packed layout (the offsets that
    ``torch._grouped_mm`` takes): group g owns rows [ends[g-1], ends[g])."""
    counts = torch.bincount(tg.long(), minlength=n_groups) * block_m
    return torch.cumsum(counts, 0).to(torch.int32)


def check_gmm_kernels(torch, cfg):
    """Fused GLU and down GEMM at the serve run's prefill-chunk shapes: a
    256-token chunk routed top-2 over the experts (M = 512 rows, padded to
    Mp = round_up(512, 128) + 24 * 128 = 3584)."""
    from repro_torch.kernels import gmm, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    E, d, f, block_m = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 128
    T = 256
    logits = torch.randn((T, E), generator=gen, device=dev)
    idx = torch.topk(logits, cfg.top_k, dim=-1).indices.reshape(-1)
    idx = torch.sort(idx).values
    sizes = torch.bincount(idx, minlength=E).to(torch.int32)
    M = int(sizes.sum())
    dest, tg, mp = ops._pack_meta(sizes, M, E, block_m)
    used = int((sizes > 0).sum())

    def rows(k):  # inputs scaled so |out| < 4: one bf16 ulp < 2e-2 there
        x = 0.5 * torch.randn((M, k), generator=gen, device=dev)
        return ops._scatter_rows(x.to(torch.bfloat16), dest, mp)

    def weights(k, n):
        w = torch.randn((E, k, n), generator=gen, device=dev) / math.sqrt(k)
        return w.to(torch.bfloat16)

    out = []
    lhs, wg, wu = rows(d), weights(d, f), weights(d, f)
    got, design = with_design(lambda: gmm.gmm_glu_tiled_pair(
        lhs, wg, wu, tg, block_m=block_m))
    want = gmm.gmm_glu_plain(lhs, wg, wu, tg, block_m=block_m)
    torch.cuda.synchronize()
    err, tol, ok = compare(got, want)
    t_bound, by = bound(2 * (M * d + used * d * 2 * f + M * f),
                        2 * M * d * 2 * f)
    out.append({
        "name": "gmm_glu", "route": "cuda", "design": design,
        "source": kernel_source("gmm_glu", design),
        "replaces": kernel_replaces("gmm_glu"),
        "max_abs_err": err, "tol": tol, "ok": ok,
        **kernel_times(lambda: gmm.gmm_glu_tiled_pair(lhs, wg, wu, tg,
                                                      block_m=block_m), 10),
        "plain_ms": cuda_ms(lambda: gmm.gmm_glu_plain(lhs, wg, wu, tg,
                                                      block_m=block_m), 5),
        "fma_ms": (cuda_ms(fma_glu(torch, lhs, wg, wu, tg, block_m), 5)
                   if design == "wgmma" else None),
        "bound_ms": t_bound, "bound_by": by, "library_ms": None,
        "library": "none: no PyTorch call fuses the GLU",
        "shapes": {"lhs": list(lhs.shape), "w": list(wg.shape),
                   "rows": M, "groups_used": used}})
    del lhs, wg, wu, got, want

    lhs, wo = rows(f), weights(f, d)
    got, design = with_design(lambda: gmm.gmm_tiled(lhs, wo, tg,
                                                    block_m=block_m))
    want = gmm.gmm_tiled_plain(lhs, wo, tg, block_m=block_m)
    torch.cuda.synchronize()
    err, tol, ok = compare(got, want)
    t_bound, by = bound(2 * (M * f + used * f * d + M * d), 2 * M * f * d)
    # Yardstick only: PyTorch's grouped GEMM over the same packed groups
    # (group g owns rows [ends[g-1], ends[g]) of the padded layout).
    ends = tile_ends(torch, tg, E, block_m)
    lib_ms, lib_note = grouped_mm_ms(
        torch, lambda: torch._grouped_mm(lhs, wo, offs=ends))
    out.append({
        "name": "gmm:bf16.bf16->bf16", "route": "cuda", "design": design,
        "source": "src/repro_torch/csrc/gmm_wgmma.cu",
        "replaces": "src/repro/kernels/gmm.py:69",
        "max_abs_err": err, "tol": tol, "ok": ok,
        **kernel_times(lambda: gmm.gmm_tiled(lhs, wo, tg, block_m=block_m),
                       10),
        "plain_ms": cuda_ms(lambda: gmm.gmm_tiled_plain(lhs, wo, tg,
                                                        block_m=block_m), 5),
        "bound_ms": t_bound, "bound_by": by, "library_ms": lib_ms,
        "library": lib_note,
        "shapes": {"lhs": list(lhs.shape), "w": list(wo.shape),
                   "rows": M, "groups_used": used}})
    return out


def paged_case(torch, cfg, label: str, B: int, MP: int, q_pos, dtype,
               seed: int, window: int = 0):
    """Paged decode (the split kernel) against its plain version at
    ``cfg``'s heads on B slots of MP table slots of 16 lines (a pool of B *
    MP pages, shuffled), table slots past each slot's frontier ``q_pos``
    -1, keys more than ``window`` positions back masked (0: none): bf16
    per slot at the bf16 tier, f32 at 1e-4 * max|plain|; its time, host
    time, split count, the plain version's time and the byte bound of the
    live lines (those inside the window)."""
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    KH, hd, ps = cfg.n_kv_heads, cfg.head_dim, 16
    G, P = cfg.n_heads // KH, B * MP
    q = torch.randn((B, KH, G, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, ps, KH, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, KH, hd), generator=gen, device=dev).to(dtype)
    table = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = table.reshape(B, MP).contiguous()
    q_pos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    for b, p in enumerate(q_pos.tolist()):  # pages past the frontier: -1
        table[b, p // ps + 1:] = -1
    kw = dict(scale=hd ** -0.5, window=window)
    got = pa.paged_decode_forward(q, kp, vp, table, q_pos, **kw)
    want = pa.paged_decode_plain(q, kp, vp, table, q_pos, **kw)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    err, tol, ok = (compare(got, want, per_row=True) if bf16  # per slot
                    else compare_f32(got, want))
    ok = ok and torch.equal(
        pa.paged_decode_forward(q, kp, vp, table, q_pos, **kw), got)
    del got, want
    lines = sum(min(p + 1, window or p + 1) for p in q_pos.tolist())
    es = q.element_size()
    # no tensor cores: the FMA pipe's peak (the bytes bound it anyway)
    t_bound, by = bound(es * (2 * q.numel() + 2 * lines * KH * hd),
                        4 * lines * KH * G * hd, FP32_FLOPS)
    plan = pa.paged_decode_plan(B, KH, G, hd, MP, es,
                                pa._sm_count(dev.index or 0))
    return {
        "name": "paged_decode", "route": "cuda", "design": "split",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:109",
        "max_abs_err": err, "tol": tol, "ok": ok,
        **kernel_times(lambda: pa.paged_decode_forward(q, kp, vp, table,
                                                       q_pos, **kw), 50),
        "plain_ms": cuda_ms(lambda: pa.paged_decode_plain(q, kp, vp, table,
                                                          q_pos, **kw), 20),
        "fma_ms": None,
        "bound_ms": t_bound, "bound_by": by, "library_ms": None,
        "library": "none: no PyTorch call decodes over a page table",
        "shapes": {"case": label, "q": list(q.shape),
                   "pools": list(kp.shape), "table": list(table.shape),
                   "dtype": str(dtype).replace("torch.", ""),
                   "window": window, "q_pos": q_pos.tolist(),
                   "live_lines": lines, "splits": plan["splits"],
                   "pages_per_split": plan["pages_per_split"],
                   "bytes_needed": es * (2 * q.numel()
                                         + 2 * lines * KH * hd)}}


def check_paged_kernel(torch, cfg):
    """Paged decode at the serve run's decode shapes (the kernels line's
    entry: 4 slots, 26 table slots of 16 lines, max_len 416, a 104-page
    pool, bf16), and in f32, and at a long context: 4 slots x 4096
    positions (256 table slots each, 16.8 MB of live K and V in bf16), in
    bf16 and f32 (the ``paged_cases:`` line)."""
    bf, f32 = torch.bfloat16, torch.float32
    serve_pos = [415, 300, 131, 17]
    main = paged_case(torch, cfg, "serve", 4, 26, serve_pos, bf, 2)
    cases = [paged_case(torch, cfg, "serve-f32", 4, 26, serve_pos, f32, 2)]
    for dtype in (bf, f32):
        tag = "" if dtype == bf else "-f32"
        cases.append(paged_case(torch, cfg, f"4x4096{tag}", 4, 256,
                                [4095] * 4, dtype, 14))
    return main, cases


def train_routing(torch, cfg, gen, tokens: int, block_m: int = 128):
    """Random top-2 routing of ``tokens`` tokens over the experts, as the
    train run's: (sizes, dest, tile_group, Mp, M)."""
    from repro_torch.kernels import ops
    E = cfg.n_experts
    logits = torch.randn((tokens, E), generator=gen, device="cuda")
    idx = torch.topk(logits, cfg.top_k, dim=-1).indices.reshape(-1)
    sizes = torch.bincount(idx, minlength=E).to(torch.int32)
    M = int(sizes.sum())
    dest, tg, mp = ops._pack_meta(sizes, M, E, block_m)
    return sizes, dest, tg, mp, M


def check_train_kernels(torch, cfg, train_tokens: int):
    """The MoE FFN backward's grouped kernels at the train run's shapes:
    2048 tokens routed top-2 over 12 experts (M = 4096 rows, padded to
    Mp = 4096 + 12 * 128 = 5632), d 2048, f 7168; operand types as under
    the bf16 policy (bf16 x_p and weights, f32 h_p and cotangents)."""
    from repro_torch.kernels import gmm, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    E, d, f, bm = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 128
    sizes, dest, tg, mp, M = train_routing(torch, cfg, gen, train_tokens)
    used = int((sizes > 0).sum())
    ends = tile_ends(torch, tg, E, bm)

    def rows(k, dtype, scale=0.5):  # packed rows, pad rows zero
        x = scale * torch.randn((M, k), generator=gen, device=dev)
        return ops._scatter_rows(x.to(dtype), dest, mp)

    def weights(k, n):
        w = torch.randn((E, k, n), generator=gen, device=dev) / math.sqrt(k)
        return w.to(torch.bfloat16)

    bf, f32 = torch.bfloat16, torch.float32
    x_p, h_p, dout_p, dg_p = rows(d, bf), rows(f, f32), rows(d, f32), \
        rows(f, f32)
    hb_p = rows(f, bf)  # the forward's bf16 h (the down projection)
    wg, wu, wo = weights(d, f), weights(d, f), weights(f, d)
    wo_t = wo.transpose(1, 2)
    out = []

    def entry(name, fn, plain, bytes_moved, flops, peak, lib, shapes,
              counter=None, fma=None):
        (got, design), want = with_design(fn), plain()
        torch.cuda.synchronize()
        err, tol, ok = (compare if got.dtype == bf else compare_f32)(got,
                                                                     want)
        del got, want
        t_bound, by = bound(bytes_moved, flops, peak)
        lib_ms, lib_note = lib()
        out.append({
            "name": name, "route": "cuda", "design": design,
            "counter": counter or name,
            "source": kernel_source(name, design),
            "replaces": kernel_replaces(name),
            "max_abs_err": err, "tol": tol, "ok": ok,
            **kernel_times(fn, 5), "plain_ms": cuda_ms(plain, 3),
            "fma_ms": cuda_ms(fma, 5) if fma and design == "wgmma" else None,
            "bound_ms": t_bound, "bound_by": by, "library_ms": lib_ms,
            "library": lib_note,
            "shapes": dict(shapes, rows=M, padded_rows=mp,
                           groups_used=used)})

    # the fused GLU at the train shape (forward and remat recompute)
    entry("gmm_glu (train shape)",
          lambda: gmm.gmm_glu_tiled_pair(x_p, wg, wu, tg, block_m=bm),
          lambda: gmm.gmm_glu_plain(x_p, wg, wu, tg, block_m=bm),
          2 * M * d + 2 * used * d * 2 * f + 2 * M * f, 2 * M * d * 2 * f,
          BF16_FLOPS,
          lambda: (None, "none: no PyTorch call fuses the GLU"),
          {"lhs": list(x_p.shape), "w": list(wg.shape)},
          counter="gmm_glu", fma=fma_glu(torch, x_p, wg, wu, tg, bm))
    # the forward's down projection at the train shape: bf16 x bf16 -> bf16
    entry("gmm:bf16.bf16->bf16 (train shape)",
          lambda: gmm.gmm_tiled(hb_p, wo, tg, block_m=bm),
          lambda: gmm.gmm_tiled_plain(hb_p, wo, tg, block_m=bm),
          2 * M * f + 2 * used * f * d + 2 * M * d, 2 * M * f * d,
          BF16_FLOPS,
          lambda: grouped_mm_ms(torch, lambda: torch._grouped_mm(
              hb_p, wo, offs=ends)),
          {"lhs": list(hb_p.shape), "w": list(wo.shape)},
          counter="gmm:bf16.bf16->bf16")
    kw = dict(block_m=bm, out_dtype=f32)
    # g, u recompute: bf16 x bf16 -> f32 (bf16 operands: tensor-core peak)
    entry("gmm:bf16.bf16->f32",
          lambda: gmm.gmm_tiled(x_p, wg, tg, **kw),
          lambda: gmm.gmm_tiled_plain(x_p, wg, tg, **kw),
          2 * M * d + 2 * used * d * f + 4 * M * f, 2 * M * d * f,
          BF16_FLOPS,
          lambda: grouped_mm_ms(torch, lambda: torch._grouped_mm(
              x_p, wg, offs=ends, out_dtype=f32)),
          {"lhs": list(x_p.shape), "w": list(wg.shape)})
    # y = h @ wo on the unrounded f32 h: f32 x bf16 -> f32, the row-major
    # weight read MN-major; the tensor-core design's work is its three
    # bf16 products (the f32 lhs's split terms) at the bf16 peak; "fma"
    # times the replaced FMA kernel on the same inputs
    split_passes = gmm.gmm_wgmma_plan(bm, f32)["passes"]
    entry("gmm:f32.bf16->f32",
          lambda: gmm.gmm_tiled(h_p, wo, tg, **kw),
          lambda: gmm.gmm_tiled_plain(h_p, wo, tg, **kw),
          4 * M * f + 2 * used * f * d + 4 * M * d,
          split_passes * 2 * M * f * d, BF16_FLOPS,
          lambda: grouped_mm_ms(torch, lambda: torch._grouped_mm(
              h_p, wo, offs=ends)),
          {"lhs": list(h_p.shape), "w": list(wo.shape),
           "passes": split_passes},
          fma=fma_launch(torch, gmm._lib(), "gmm_f32_bf16_f32",
                         (h_p, wo, tg),
                         torch.empty((mp, d), dtype=f32, device=dev),
                         mp, f, d, d, bm))
    # dh = dout @ wo^T, the transposed weight read by stride (K-major), the
    # same design
    entry("gmm:f32.bf16T->f32",
          lambda: gmm.gmm_tiled(dout_p, wo_t, tg, **kw),
          lambda: gmm.gmm_tiled_plain(dout_p, wo_t, tg, **kw),
          4 * M * d + 2 * used * f * d + 4 * M * f,
          split_passes * 2 * M * d * f, BF16_FLOPS,
          lambda: grouped_mm_ms(torch, lambda: torch._grouped_mm(
              dout_p, wo_t, offs=ends)),
          {"lhs": list(dout_p.shape), "w": list(wo_t.shape),
           "w_strides": list(wo_t.stride()), "passes": split_passes},
          fma=fma_launch(torch, gmm._lib(), "gmm_t_f32_bf16_f32",
                         (dout_p, wo, tg),
                         torch.empty((mp, f), dtype=f32, device=dev),
                         mp, d, f, d, bm))
    # dwo from the f32 h and cotangent; dwg from the bf16 x and f32 dg.
    # The tensor-core design's work: its bf16 products (six per f32 x f32
    # pair of the three-term split, three for the bf16 lhs) at the bf16
    # peak; "fma" times the replaced FMA kernel on the same inputs.
    f32_passes = gmm.gmm_dw_wgmma_plan(bm, f32)["passes"]
    bf16_passes = gmm.gmm_dw_wgmma_plan(bm, bf)["passes"]
    entry("gmm_dw:f32.f32->f32",
          lambda: gmm.gmm_dw_tiled(h_p, dout_p, tg, E, block_m=bm),
          lambda: gmm.gmm_dw_tiled_plain(h_p, dout_p, tg, E, block_m=bm),
          4 * M * f + 4 * M * d + 4 * E * f * d,
          f32_passes * 2 * M * f * d, BF16_FLOPS,
          lambda: grouped_mm_ms(torch, lambda: torch._grouped_mm(
              h_p.t(), dout_p, offs=ends)),
          {"lhs": list(h_p.shape), "dout": list(dout_p.shape),
           "out": [E, f, d], "passes": f32_passes},
          fma=fma_dw(torch, h_p, dout_p, tg, E, bm))
    entry("gmm_dw:bf16.f32->f32",
          lambda: gmm.gmm_dw_tiled(x_p, dg_p, tg, E, block_m=bm),
          lambda: gmm.gmm_dw_tiled_plain(x_p, dg_p, tg, E, block_m=bm),
          2 * M * d + 4 * M * f + 4 * E * d * f,
          bf16_passes * 2 * M * d * f, BF16_FLOPS,
          lambda: grouped_mm_ms(torch, lambda: torch._grouped_mm(
              x_p.t(), dg_p, offs=ends)),
          {"lhs": list(x_p.shape), "dout": list(dg_p.shape),
           "out": [E, d, f], "passes": bf16_passes},
          fma=fma_dw(torch, x_p, dg_p, tg, E, bm))
    return out


def fma_dw(torch, lhs, dout, tg, n_groups: int, block_m: int):
    """The FMA ``gmm_dw`` kernel (csrc/gmm_dw.cu) on the same inputs."""
    from repro_torch.kernels import gmm
    Mp, K = lhs.shape
    N = dout.shape[1]
    return fma_launch(torch, gmm._dw_lib(),
                      f"gmm_dw_{gmm._DTYPES[lhs.dtype]}", (lhs, dout, tg),
                      torch.empty((n_groups, K, N), dtype=torch.float32,
                                  device=lhs.device),
                      n_groups, K, N, Mp // block_m, block_m)


def grad_phase(torch, cfg, train_tokens: int):
    """The MoE FFN autograd Function (the grouped kernels and their
    backward) against torch.autograd through the plain composition
    scatter -> gmm_glu_plain -> gmm_tiled_plain -> gather x scales, at
    one layer's train shapes in f32: all five gradients."""
    from repro_torch.kernels import gmm, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    E, d, f, bm = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 128
    sizes, dest, tg, mp, M = train_routing(torch, cfg, gen, train_tokens)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    inputs = [rand(M, d, scale=0.5), rand(E, d, f, scale=d ** -0.5),
              rand(E, d, f, scale=d ** -0.5), rand(E, f, d, scale=f ** -0.5),
              torch.rand((M,), generator=gen, device=dev)]
    ct = rand(M, d)

    def plain(x, wg, wu, wo, sc):
        x_p = ops._scatter_rows(x, dest, mp)
        h_p = gmm.gmm_glu_plain(x_p, wg, wu, tg, block_m=bm)
        out_p = gmm.gmm_tiled_plain(h_p, wo, tg, block_m=bm)
        return ops._gather_rows(out_p, dest) * sc[:, None]

    def kernel(x, wg, wu, wo, sc):
        return ops.moe_ffn(x, wg, wu, wo, sizes, row_scales=sc,
                           block_m=bm, small_m=False)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*ins)
        out.backward(ct)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return [out.detach()] + [t.grad for t in ins], dt

    got, t_kernel = grads(kernel)
    want, t_plain = grads(plain)
    names = ("out", "dx", "dwg", "dwu", "dwo", "dscales")
    res = {}
    for name, a, b in zip(names, got, want):
        err, tol, ok = compare_f32(a, b)
        res[name] = {"max_abs_err": err, "tol": tol, "ok": ok}
    zero = [g for g, n in enumerate(sizes.tolist()) if n == 0]
    return {"shapes": {"x": [M, d], "w": [E, d, f], "padded_rows": mp},
            "groups_empty": zero, "results": res,
            "fwd_bwd_s": t_kernel, "plain_fwd_bwd_s": t_plain,
            "ok": all(r["ok"] for r in res.values())}


def grad_bf16_phase(torch, cfg, train_tokens: int):
    """The MoE FFN autograd Function as the train runs call it: bf16 x,
    weights and row scales (the tensor-core GLU and bf16 gmm forward, the
    f32 x bf16^T data gradients dh and dx, gmm_dw on the bf16 x), against
    torch.autograd through the plain composition on the same bf16 inputs,
    at one W1 layer's train shapes: the output and the five gradients
    within 2e-2 * min(1, max|plain|) (the plain path rounds dh to bf16,
    the Function keeps it in f32, as the reference). The cotangent is
    scaled by GRAD_BF16_CT so every gradient stays below 2, where one bf16
    ulp is under the tier. Every GLU and gmm launch (f32 x bf16 and f32 x
    bf16^T included) must take the tensor-core design."""
    from repro_torch import kernels
    from repro_torch.kernels import gmm, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    E, d, f, bm = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 128
    sizes, dest, tg, mp, M = train_routing(torch, cfg, gen, train_tokens)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen,
                                    device=dev)).to(bf)

    inputs = [rand(M, d, scale=0.5), rand(E, d, f, scale=d ** -0.5),
              rand(E, d, f, scale=d ** -0.5), rand(E, f, d, scale=f ** -0.5),
              torch.rand((M,), generator=gen, device=dev).to(bf)]
    ct = rand(M, d, scale=GRAD_BF16_CT)

    def plain(x, wg, wu, wo, sc):
        x_p = ops._scatter_rows(x, dest, mp)
        h_p = gmm.gmm_glu_plain(x_p, wg, wu, tg, block_m=bm)
        out_p = gmm.gmm_tiled_plain(h_p, wo, tg, block_m=bm)
        return ops._gather_rows(out_p, dest) * sc[:, None]

    def kernel(x, wg, wu, wo, sc):
        return ops.moe_ffn(x, wg, wu, wo, sizes, row_scales=sc,
                           block_m=bm, small_m=False)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        out = fn(*ins)
        out.backward(ct)
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in ins]

    before = {**kernels.design_launch_counts(),
              **kernels.variant_launch_counts()}
    got = grads(kernel)
    after = {**kernels.design_launch_counts(),
             **kernels.variant_launch_counts()}
    moved = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    want = grads(plain)
    res = {}
    for name, a, b in zip(("out", "dx", "dwg", "dwu", "dwo", "dscales"),
                          got, want):
        err, tol, ok = compare(a, b)
        res[name] = {"max_abs_err": err, "tol": tol,
                     "max_abs_plain": float(b.float().abs().max()),
                     "ok": ok and a.dtype == bf}
    # GLU 1; gmm: down 1, g and u 2, the scaled variant's y on the f32 h
    # (f32 x bf16) 1, dh 1, dx 2, all on the tensor cores; gmm_dw 3
    designs_ok = (moved.get("gmm_glu:wgmma") == 1
                  and "gmm_glu:fma" not in moved
                  and moved.get("gmm:f32.bf16T->f32") == 3
                  and moved.get("gmm:f32.bf16->f32") == 1
                  and moved.get("gmm:wgmma") == 7
                  and "gmm:fma" not in moved
                  and moved.get("gmm_dw:wgmma") == 3)
    return {"shapes": {"x": [M, d], "w": [E, d, f], "padded_rows": mp,
                       "dtype": "bfloat16", "ct_scale": GRAD_BF16_CT},
            "designs": moved, "results": res,
            "ok": designs_ok and all(r["ok"] for r in res.values())}


def parity_f32(torch, serve_mod):
    """The paged engine (chunked prefill through the kernels, f32 policy)
    against the cache-free forward: first-token logits of the trace's first
    request whose prompt needs more than one prefill chunk."""
    from repro_torch.models import registry, stack
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.serve import ServeConfig, build_deployment
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    cfg = registry.get_config("mixtral-w2")
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = stack.init_model(gen, cfg, device="cuda")
    sc = ServeConfig.from_args(args)
    trace = serve_mod.build_trace(args.seed, args.requests, args.rate,
                                  args.prompt_len, args.gen, cfg.vocab_size,
                                  sc.sampling)
    req = next(r for r in trace if len(r.prompt) > args.prefill_chunk)
    engine = build_deployment(cfg, run, sc, params=params, device="cuda",
                              record_logits=True)
    engine.run([req])
    paged = torch.from_numpy(engine.logits[req.rid][0]).cuda()
    with torch.inference_mode():
        ref, _, _ = stack.apply_model(
            params, cfg, run,
            torch.tensor([req.prompt], dtype=torch.int64, device="cuda"))
    ref = ref[0, -1].float()
    diff = float((paged - ref).abs().max())
    scale = float(ref.abs().max())
    return {"rid": req.rid, "prompt": len(req.prompt),
            "prefill_chunks": engine.n_prefill_chunks,
            "max_abs_diff": diff, "max_abs_logit": scale,
            "limit": PARITY_REL * scale,
            "ok": diff <= PARITY_REL * scale
            and engine.n_prefill_chunks >= 2}


def timed_train(torch, train_mod, smi: str, argv, per_step: dict,
                run=None, zcfg=None, zstats=None):
    """The train driver's steps of ``argv`` under ``run`` (default: the
    driver's chunked attention) and ``zcfg`` (default: the command line's
    zebra config), the launch counters set to 0 just before and read just
    after. ``zstats``: the zebra engine's record (capacities, row tiles,
    drops) put on the line; None records it during these steps, which
    adds device work to every pack, so a timed run passes the record of
    its untimed warm-up step (:func:`zebra_warmup`). Raises on a
    non-finite step or a kernel of the path that never launched; the
    exact counts (``per_step`` per layer and step, 0 for every other
    kernel) are checked by the caller."""
    from repro_torch import kernels
    from repro_torch.core import zebra_spmd
    from repro_torch.models import registry
    args = train_mod.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    zebra_spmd.reset_stats(zstats is None)
    kernels.reset_launch_counts()
    summary = train_mod.train_arch(args.arch, args, run, zcfg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    variants = kernels.variant_launch_counts()
    designs = kernels.design_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if zstats is None:
        zstats = zebra_spmd.read_stats()
    zebra_spmd.reset_stats(False)
    attn = run.attn_impl if run is not None else "chunked"
    zebra = summary["zebra"]
    label = f"{args.arch}, {attn}" + (f", zebra {zebra['mode']}" if zebra
                                      else "")
    if not summary["ok"]:
        raise RuntimeError(f"train run ({label}): a loss or grad norm is "
                           f"not finite")
    missing = [k for k, n in per_step.items() if n and launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the train path "
                           f"({label}): {missing} ({launches})")
    layers = registry.get_config(args.arch).n_layers
    expected = {k: per_step.get(k, 0) * layers * args.steps
                for k in launches}
    per_layer_step = {k: launches[k] / (layers * args.steps)
                      for k in ("gmm_glu", "gmm", "gmm_dw")}
    line = {
        "arch": args.arch, "attn_impl": attn, "zebra": zebra,
        "zebra_engine": zstats, "launches_per_layer_step": per_layer_step,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "params": summary["params"],
        "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "ms_per_step": summary["ms_per_step"],
        "tokens_per_s": summary["tokens_per_s"],
        "step_ms": [t * 1e3 for t in summary["step_s"]],
        "loss": [m["loss"] for m in summary["history"]],
        "grad_norm": [m["grad_norm"] for m in summary["history"]],
        "max_memory_allocated": peak, "launches": launches,
        "launches_expected": expected, "variant_launches": variants,
        "design_launches": designs}
    counts = {**launches, **variants, **designs}
    check_designs(f"train run ({label})", counts)
    return line, counts


def train_phase(torch, train_mod, smi: str):
    """The train main path: one untimed warm-up step on a model of its
    own, then the driver's 6 steps (:func:`timed_train`)."""
    warm = train_mod.train_arch(
        "mixtral-w1", train_mod.build_parser().parse_args(TRAIN_WARMUP_ARGS))
    if not warm["ok"]:
        raise RuntimeError("warm-up train step failed")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train warm-up: 1 step (untimed, not counted), loss "
          f"{warm['history'][0]['loss']:.4f}", flush=True)
    return timed_train(torch, train_mod, smi, TRAIN_ARGS,
                       dict(TRAIN_LAUNCHES))


def train_flash_phase(torch, train_mod, smi: str, chunked: dict):
    """The flash train path: the driver's 6 steps with attn_impl="flash"
    (no separate warm-up: the kernels are built and the median is
    reported), and its step-1 loss and grad norm against the chunked
    run's."""
    from repro_torch.models.modules import Policy, RunConfig
    run = RunConfig(policy=Policy(), attn_impl="flash", moe_impl="gather",
                    remat="full")
    line, counts = timed_train(torch, train_mod, smi, TRAIN_ARGS,
                               dict(TRAIN_LAUNCHES, **FLASH_LAUNCHES), run)
    line["step1_rel_gap_vs_chunked"] = {
        k: abs(line[k][0] - chunked[k][0]) / abs(chunked[k][0])
        for k in ("loss", "grad_norm")}
    return line, counts


def check_zebra_line(line: dict, mode: str):
    """The zebra engine's record of a run: its capacity and block_m as
    expected for ``mode`` at capacity 1.25 (ZEBRA_ENGINE)."""
    caps, bms = ZEBRA_ENGINE[mode]
    got = line["zebra_engine"]
    if got.get("capacity") != caps or got.get("block_m") != bms:
        raise RuntimeError(f"zebra {mode} run chose capacity "
                           f"{got.get('capacity')} and block_m "
                           f"{got.get('block_m')}, expected {caps}, {bms}")


def zebra_warmup(torch, train_mod, argv, label: str) -> dict:
    """One untimed step of ``argv`` on a model of its own (the one-time
    costs: allocator growth, the first plans), with the zebra engine's
    record on; returns that record (capacities, row tiles, dropped share
    of this step's token copies) for the timed run's line."""
    from repro_torch.core import zebra_spmd
    zebra_spmd.reset_stats()
    try:
        warm = train_mod.train_arch(
            "mixtral-w1", train_mod.build_parser().parse_args(
                argv + ["--steps", "1"]))
        zstats = zebra_spmd.read_stats()
    finally:
        zebra_spmd.reset_stats(False)
    if not warm["ok"]:
        raise RuntimeError(f"{label} warm-up train step failed")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label} warm-up: 1 step (untimed, not counted), loss "
          f"{warm['history'][0]['loss']:.4f}", flush=True)
    return zstats


def train_zebra_phase(torch, train_mod, smi: str):
    """The train driver's default on mixtral-w1 (zebra replicated, 2
    microbatches, capacity 1.25): one untimed warm-up step, which records
    the engine's choices, then the driver's 6 steps with the record off
    (:func:`timed_train`)."""
    zstats = zebra_warmup(torch, train_mod, ZEBRA_ARGS, "train_zebra")
    line, counts = timed_train(torch, train_mod, smi, ZEBRA_ARGS,
                               dict(ZEBRA_LAUNCHES), zstats=zstats)
    check_zebra_line(line, "replicated")
    return line, counts


def zebra_a2a_phase(torch, train_mod, smi: str):
    """The driver with ``--zebra-mode alltoall --n-chunks 2
    --offload-experts 2`` (one rank: the all-to-alls are the identity; the
    two offloaded experts join chunk 0's grouped call): one untimed
    warm-up step, then 3 steps, as :func:`train_zebra_phase`."""
    zstats = zebra_warmup(torch, train_mod, ZEBRA_A2A_ARGS, "zebra_a2a")
    line, counts = timed_train(torch, train_mod, smi, ZEBRA_A2A_ARGS,
                               dict(ZEBRA_A2A_LAUNCHES), zstats=zstats)
    check_zebra_line(line, "alltoall")
    return line, counts


def zebra_equal_phase(torch, train_mod, smi: str, no_zebra: dict):
    """One step of each zebra mode at capacity ZEBRA_EQUAL_CF (no drops:
    C 1024, block_m 128; alltoall with 2 chunks and 2 offloaded experts):
    step-1 loss and grad norm against the --no-zebra run's step 1, within
    ZEBRA_GAP relative (the bf16 tier: the microbatches round and average
    the aux losses in other places). The engine's record is on during the
    step; no time of this phase is reported."""
    from repro_torch.core.zebra_spmd import ZebraConfig
    out = {}
    for mode, flags, per_step, chunks, off in (
            ("replicated", [], ZEBRA_LAUNCHES, 1, 0),
            ("alltoall", A2A_FLAGS, ZEBRA_A2A_LAUNCHES, 2, 2)):
        zcfg = ZebraConfig(mode=mode, num_microbatches=2,
                           capacity_factor=ZEBRA_EQUAL_CF, n_chunks=chunks,
                           offload_experts=off)
        line, _ = timed_train(torch, train_mod, smi,
                              ZEBRA_ARGS + ["--steps", "1"] + flags,
                              dict(per_step), zcfg=zcfg)
        gc.collect()
        torch.cuda.empty_cache()
        gap = {k: abs(line[k][0] - no_zebra[k][0]) / abs(no_zebra[k][0])
               for k in ("loss", "grad_norm")}
        engine = line["zebra_engine"]
        want = {k: line["launches_expected"][k] for k in per_step}
        out[mode] = {
            "loss": line["loss"][0], "grad_norm": line["grad_norm"][0],
            "rel_gap_vs_no_zebra": gap, "capacity": engine["capacity"],
            "block_m": engine["block_m"],
            "dropped_share": engine["dropped_share"],
            "launches": {k: line["launches"][k] for k in per_step},
            "ok": (max(gap.values()) <= ZEBRA_GAP
                   and engine["capacity"] == [1024]
                   and engine["block_m"] == [128]
                   and engine["dropped_share"] == 0.0
                   and want == {k: line["launches"][k] for k in want})}
    return {"capacity_factor": ZEBRA_EQUAL_CF, "tol": ZEBRA_GAP,
            "no_zebra": {k: no_zebra[k][0] for k in ("loss", "grad_norm")},
            "modes": out, "ok": all(m["ok"] for m in out.values())}


def zebra_streams_phase(torch, train_mod):
    """The zebra step's gradients on the card: one batch through the
    driver's program twice (two streams; the reruns must be bitwise
    equal) and through the same override on one stream
    (``zebra_streams=False``): every gradient and the loss within the f32
    tier (1e-4 * max|one-stream|); and the gradient phase's host-clock ms
    (median of 3 after a warm-up) on two streams and on one."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.step import make_train_program
    args = train_mod.build_parser().parse_args(ZEBRA_ARGS)
    cfg, program, loader = train_mod.build(args.arch, args)
    one = make_train_program(
        cfg, program.run, ShapeConfig("cli", "train", args.seq, args.batch),
        opt_cfg=program.opt_cfg, device="cuda", zcfg=program.zcfg,
        zebra_streams=False)
    params = program.init_params(seed=0)
    batch = next(loader)

    def timed(prog):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads, m = prog.grad_fn(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del grads, m
        return sorted(times[1:])[1] * 1e3

    g1, m1 = program.grad_fn(params, batch)
    g2, m2 = program.grad_fn(params, batch)
    torch.cuda.synchronize()
    bitwise = torch.equal(m1["loss"], m2["loss"]) and all(
        torch.equal(g1[k], g2[k]) for k in g1)
    del g2, m2
    g3, m3 = one.grad_fn(params, batch)
    torch.cuda.synchronize()
    worst, worst_rel, ok = None, 0.0, True
    for k in g1:
        err, tol, good = compare_f32(g1[k], g3[k])
        rel = err / max(tol / TOL_F32, 1e-30)
        ok = ok and good
        if rel >= worst_rel:
            worst, worst_rel = k, rel
    loss_err, loss_tol, loss_ok = compare_f32(m1["loss"], m3["loss"])
    same = all(torch.equal(g1[k], g3[k]) for k in g1)
    del g1, g3, m1, m3
    two_ms, one_ms = timed(program), timed(one)
    return {"bitwise_rerun": bitwise, "one_stream_bitwise_equal": same,
            "worst_grad": worst, "worst_grad_rel_err": worst_rel,
            "loss_abs_err": loss_err, "loss_tol": loss_tol,
            "grad_ms_two_streams": two_ms, "grad_ms_one_stream": one_ms,
            "ok": bitwise and ok and loss_ok}


def mpmd_calls(s) -> int:
    """Expert calls of one MPMD step: per microbatch and layer one per
    lane holding experts and chunk, and one for the offloaded experts."""
    eng = s.engine
    return eng.R * sum(
        eng.Q * eng.N * (eng.lane_experts(l) > 0)
        + (eng.plan.n_attn_experts(l) > 0) for l in range(s.cfg.n_layers))


def mpmd_phase(torch, smi: str, n_chunks: int):
    """The zebra MPMD step at full width (``launch/hetero_mpmd.py``'s
    default, ``--n-chunks``): one untimed warm-up step, then MPMD_STEPS
    steps with the launch counters set to 0 just before and read just
    after. Raises on a non-finite loss or gradient, a launch count other
    than MPMD_CALL per expert call, a launch off the tensor-core design,
    a capacity or block_m other than MPMD_ENGINE's, or an issue order
    other than Theorem 1's (:func:`canonical_order`)."""
    from repro_torch import kernels
    from repro_torch.launch import hetero_mpmd as hm
    s = hm.build(hm.build_parser().parse_args(["--n-chunks",
                                                str(n_chunks)]))
    batch, seq = s.tokens.shape
    label = f"mpmd Q {n_chunks}"
    if not hm.finite(*hm.step(s)):
        raise RuntimeError(f"{label}: warm-up step not finite")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_s, losses, ok = [], [], True
    for _ in range(MPMD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hm.step(s)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        ok = ok and hm.finite(*out)
        losses.append(float(out[0]))
        del out
    launches = kernels.launch_counts()
    counts = {**launches, **kernels.variant_launch_counts(),
              **kernels.design_launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    if not ok:
        raise RuntimeError(f"{label}: a loss or gradient is not finite")
    check_designs(label, counts)
    calls = mpmd_calls(s)
    expected = {k: MPMD_CALL.get(k, 0) * calls * MPMD_STEPS
                for k in launches}
    if expected != launches:
        raise RuntimeError(f"{label}: launches {launches}, expected "
                           f"{expected}")
    layout = hm.layout(s)
    got = (layout["C"], layout["C_chunk"], layout["block_m_lane_chunk"],
           layout["block_m_local"])
    if got != MPMD_ENGINE[n_chunks]:
        raise RuntimeError(f"{label}: (C, C_chunk, block_m lane, block_m "
                           f"local) {got}, expected "
                           f"{MPMD_ENGINE[n_chunks]}")
    ms = sorted(step_s)[len(step_s) // 2] * 1e3
    canonical = canonical_order(s.engine)
    traced = mpmd_traced(torch, s) if n_chunks == 1 else None
    line = {"arch": s.cfg.name, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "lanes": s.engine.N,
            "microbatches": s.engine.R, "batch": batch, "seq": seq,
            "steps": MPMD_STEPS,
            "plan": {"R": s.plan.R, "offload": list(s.plan.offload),
                     "n_chunks": s.plan.n_chunks},
            "layout": layout, "ms_per_step": ms,
            "tokens_per_s": batch * seq / (ms / 1e3),
            "step_ms": [t * 1e3 for t in step_s], "loss": losses,
            "max_memory_allocated": peak, "expert_calls_per_step": calls,
            "launches_per_step": {k: launches[k] / MPMD_STEPS
                                  for k in MPMD_CALL},
            "design_launches": {k: v for k, v in counts.items()
                                if k.endswith((":wgmma", ":fma"))},
            "tasks": len(s.engine.order), "canonical_order": canonical}
    if traced is not None:
        line["traced_step"] = traced
    if not canonical:
        raise RuntimeError(f"{label}: the engine's issue order is not "
                           f"Theorem 1's canonical schedule")
    if traced is not None and not traced["ok"]:
        raise RuntimeError(f"{label}: the traced step is not bitwise the "
                           f"untraced one, or its spans are not the "
                           f"reference's set: {traced}")
    return line, counts


def mpmd_traced(torch, s) -> dict:
    """One MPMD step untraced and one under an ``obs.trace.Tracer``
    (outside the counted window): loss and every gradient leaf bitwise
    equal, and the spans the reference's (``embed``, ``F``, ``head``,
    ``B``, ``embed^B``: R * (3 + 2 L) on the ``zebra-mpmd`` track)."""
    from repro_torch.launch import hetero_mpmd as hm
    from repro_torch.obs import trace as obs_trace
    from repro_torch.pytree import flatten

    def leaves(out):
        _, ga, ge = out
        trees = [{k: v for k, v in ga.items() if k != "layers"},
                 *ga["layers"], *(lane for layer in ge for lane in layer)]
        return [out[0]] + [t for tree in trees
                           for t in flatten(tree).values()]
    plain = leaves(hm.step(s))
    tracer = obs_trace.Tracer()
    with obs_trace.use(tracer):
        traced = leaves(hm.step(s))
    torch.cuda.synchronize()
    equal = len(plain) == len(traced) and all(
        torch.equal(a, b) for a, b in zip(plain, traced))
    names = sorted(ev.name.split(" ")[0] for ev in tracer.events
                   if ev.track == "zebra-mpmd" and ev.ph == "B")
    R, L = s.engine.R, s.cfg.n_layers
    kinds = {k: names.count(k) for k in sorted(set(names))}
    want = {"B": R * L, "F": R * L, "embed": R, "embed^B": R, "head": R}
    return {"bitwise": equal, "leaves": len(plain), "spans": len(names),
            "span_kinds": kinds, "ok": equal and kinds == want}


def canonical_order(engine) -> bool:
    """Whether the order ``train_step`` walks issues every task of
    ``schedule.canonical_schedule`` once, after all of its
    ``schedule.dependencies``, keeping each stream's canonical list."""
    from repro_torch.core import schedule as S
    sched, order = engine.schedule, engine.order
    seen = set()
    for t in order:
        if t in seen or not all(d in seen for d in S.dependencies(
                t, sched.L, sched.offload)):
            return False
        seen.add(t)
    return (seen == set(sched.all_tasks()) and all(
        [t for t in order if S.stream_of(t) == name] == tasks
        for name, tasks in sched.streams.items()))


def mpmd_named(grads_attn, grads_exp) -> dict:
    """The engine's gradient leaves by name: ``layers/l/...`` per layer
    of the attention side (its experts the offloaded [0, n_att)) and
    ``lanes/l/i/key`` those of lane i at layer l."""
    from repro_torch.pytree import flatten
    out = flatten({k: v for k, v in grads_attn.items() if k != "layers"})
    for l, layer in enumerate(grads_attn["layers"]):
        out.update({f"layers/{l}/{k}": v for k, v in flatten(layer).items()})
        for i, lane in enumerate(grads_exp[l]):
            out.update({f"lanes/{l}/{i}/{k}": v for k, v in lane.items()})
    return out


def fused_named(s, names, ref: dict) -> dict:
    """A fused tree's gradients (``ref``, by path) cut as the engine
    places them, under the names of :func:`mpmd_named`."""
    from repro_torch.core.zebra_mpmd import EXPERT_KEYS
    out = {}
    for name in names:
        side, _, rest = name.partition("/")
        if side == "layers":
            l, k = rest.split("/", 1)
            want = ref[f"blocks/pos0/{k}"][int(l)]
            if k in [f"ffn/{e}" for e in EXPERT_KEYS]:
                want = want[:s.engine.plan.n_attn_experts(int(l))]
        elif side == "lanes":
            l, i, k = (int(v) if v.isdigit() else v
                       for v in rest.split("/", 2))
            El = s.engine.lane_experts(l)
            first = s.engine.plan.n_attn_experts(l) + i * El
            want = ref[f"blocks/pos0/ffn/{k}"][l][first:first + El]
        else:
            want = ref[name]
        out[name] = want
    return out


def rel_errors(got: dict, want: dict) -> dict:
    """Per leaf max|got - want| / max|want|; None where shapes differ, 0
    for a leaf of no experts."""
    out = {}
    for k, g in got.items():
        w = want[k]
        if g.shape != w.shape or not g.numel():
            out[k] = None if g.shape != w.shape else 0.0
            continue
        err = float((g.float() - w.float()).abs().max())
        out[k] = err / max(float(w.float().abs().max()), 1e-30)
    return out


def worst(rel: dict, n: int = 5) -> list:
    return sorted(rel.items(), key=lambda kv: -float(
        "inf" if kv[1] is None else kv[1]))[:n]


def mpmd_equal_case(torch, run=None) -> dict:
    """One MPMD step at capacity MPMD_EQUAL_CF (no drops: C 1024, block_m
    128) under ``run`` (default: the entry point's bf16 policy), leaf by
    leaf against two references on the card, the NLL only, each routed
    as the engine's forward routed:

    * ``fused``: autograd through the port's fused W1 (``stack.apply_model``
      on the single-pack MoE route, which scales the combine's rows inside
      the down GEMM);
    * ``spmd``: autograd through the same model with the SPMD zebra
      override (``zebra_spmd.make_layer_override``, replicated, the
      engine's R microbatches), which packs, runs the experts and rounds
      their outputs before the weighted combine as the engine does.

    Both references sum the router's inputs in other orders than the
    engine, so a token whose second and third expert nearly tie may pick
    another expert there, and one such token moves the gradients it
    touches by up to 0.28 of a leaf's max on the H100 (PERF.md). So each
    reference takes the engine's two experts for every token (through
    ``modules.moe_route``, which all of them call: the same softmax, its
    values at the engine's experts renormalized, equal to its own top-k
    where the choices agree) and counts the tokens whose own choice
    differs (``routing_flips``, of ``routed_tokens``)."""
    from repro_torch.core import zebra_spmd
    from repro_torch.launch import hetero_mpmd as hm
    from repro_torch.models import modules, stack
    from repro_torch.pytree import flatten, tree_map
    s = hm.build(hm.build_parser().parse_args([]),
                 capacity_factor=MPMD_EQUAL_CF, run=run)
    layout = hm.layout(s)
    L, R = s.cfg.n_layers, s.engine.R
    route, routes = modules.moe_route, []

    def recording(*a, **kw):
        out = route(*a, **kw)
        routes.append(out[1])
        return out

    modules.moe_route = recording
    try:
        loss, ga, ge = hm.step(s)
    finally:
        modules.moe_route = route
    got = mpmd_named(ga, ge)
    a_tasks = [t for t in s.engine.order if t[0] == "A"]
    fwd = {t[2:]: r for t, r in zip(a_tasks, routes) if t[1] == "F"}

    def reference(wants, layer_override=None):
        """(loss, named grads, flips): autograd through apply_model with
        the routing of each moe_route call taken from ``wants`` in call
        order."""
        flips = []

        def pinned(router_w, cfg, policy, x2d, **kw):
            _w, idx, aux = route(router_w, cfg, policy, x2d, **kw)
            want = wants[len(flips)]
            flips.append(int((idx.sort(-1).values != want.sort(-1).values)
                             .any(-1).sum()))
            acc = policy.accum_dtype
            probs = torch.softmax(x2d.to(acc) @ router_w.to(acc), dim=-1)
            w = torch.gather(probs, -1, want.long())
            return w / w.sum(-1, keepdim=True), want, aux

        tree = tree_map(lambda t: t.detach().requires_grad_(), s.params)
        leaves = flatten(tree)
        modules.moe_route = pinned
        try:
            logits, _, _ = stack.apply_model(tree, s.cfg, s.run, s.tokens,
                                             layer_override=layer_override)
        finally:
            modules.moe_route = route
        logp = torch.log_softmax(logits, -1)
        del logits
        ref_loss = -torch.gather(logp, -1, s.targets[..., None])[..., 0] \
            .mean()
        grads = dict(zip(leaves, torch.autograd.grad(
            ref_loss, list(leaves.values()))))
        if len(flips) != len(wants):
            raise RuntimeError(f"mpmd_equal: {len(flips)} routings, "
                               f"expected {len(wants)}")
        return float(ref_loss.detach()), fused_named(s, got, grads), \
            sum(flips)

    fused_loss, fused, fused_flips = reference(
        [torch.cat([fwd[(l, j)] for j in range(R)]) for l in range(L)])
    zcfg = zebra_spmd.ZebraConfig(mode="replicated", num_microbatches=R,
                                  capacity_factor=MPMD_EQUAL_CF)
    spmd_loss, spmd, spmd_flips = reference(
        [fwd[(l, j)] for l in range(L) for j in range(R)],
        zebra_spmd.make_layer_override(s.cfg, s.run, zcfg))
    vs_fused, vs_spmd = rel_errors(got, fused), rel_errors(got, spmd)
    spmd_vs_fused = rel_errors(spmd, fused)
    loss = float(loss)
    return {"compute_dtype": str(s.run.policy.compute_dtype),
            "C": layout["C"], "block_m": [layout["block_m_lane_chunk"],
                                          layout["block_m_local"]],
            "leaves": len(got), "routed_tokens": L * s.tokens.numel(),
            "loss": loss, "fused_loss": fused_loss, "spmd_loss": spmd_loss,
            "loss_rel_err": abs(loss - fused_loss) / abs(fused_loss),
            "routing_flips": {"fused": fused_flips, "spmd": spmd_flips},
            "vs_fused": vs_fused, "vs_spmd": vs_spmd,
            "spmd_vs_fused": spmd_vs_fused,
            "worst": {"vs_fused": worst(vs_fused),
                      "vs_spmd": worst(vs_spmd),
                      "spmd_vs_fused": worst(spmd_vs_fused)},
            "layout_ok": (layout["C"] == 1024 and layout[
                "block_m_lane_chunk"] == layout["block_m_local"] == 128)}


def worst_of(rel: dict) -> float:
    return max(float("inf") if v is None else v for v in rel.values())


def mpmd_equal_phase(torch) -> dict:
    """:func:`mpmd_equal_case` under the f32 and the bf16 policy. Both:
    at most MPMD_FLIPS of the routed tokens choose another expert in
    either reference, C 1024 and block_m 128. f32: the loss and every
    gradient leaf within the f32 tier (TOL_F32 * max) of both references.
    bf16: the loss within MPMD_GAP of the fused one, and every leaf within
    MPMD_BF16_LEAF * max of the fused W1; the engine's and the SPMD
    override's distances from the fused W1 and from each other are
    reported side by side."""
    from repro_torch.models.modules import Policy, RunConfig
    f32 = mpmd_equal_case(torch, RunConfig(
        policy=Policy(compute_dtype=torch.float32), attn_impl="chunked",
        moe_impl="gather"))
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = mpmd_equal_case(torch)
    for case in (f32, bf16):
        case["flips_ok"] = max(case["routing_flips"].values()) <= MPMD_FLIPS
    f32["ok"] = (f32["flips_ok"] and f32["layout_ok"]
                 and f32["loss_rel_err"] <= TOL_F32
                 and worst_of(f32["vs_fused"]) <= TOL_F32
                 and worst_of(f32["vs_spmd"]) <= TOL_F32)
    bf16["ok"] = (bf16["flips_ok"] and bf16["layout_ok"]
                  and bf16["loss_rel_err"] <= MPMD_GAP
                  and worst_of(bf16["vs_fused"]) <= MPMD_BF16_LEAF)
    summary = {}
    for name, case in (("f32", f32), ("bf16", bf16)):
        summary[name] = {k: v for k, v in case.items()
                         if k not in ("vs_fused", "vs_spmd", "spmd_vs_fused")}
        summary[name]["max"] = {k: worst_of(case[k]) for k in (
            "vs_fused", "vs_spmd", "spmd_vs_fused")}
    return {"capacity_factor": MPMD_EQUAL_CF, "max_flips": MPMD_FLIPS,
            "tol": {"f32": TOL_F32, "bf16_loss": MPMD_GAP,
                    "bf16_leaf": MPMD_BF16_LEAF}, **summary,
            "ok": f32["ok"] and bf16["ok"]}


def mpmd_streams_phase(torch):
    """The MPMD step on its streams (the caller's and one per lane) twice
    (bitwise equal) and on one stream (``streams=False``): the loss and
    every gradient within the f32 tier (1e-4 * max|one-stream|); and each
    step's host-clock ms (median of 3 after a warm-up)."""
    from repro_torch.launch import hetero_mpmd as hm
    args = hm.build_parser().parse_args([])
    s = hm.build(args)
    one = hm.make_engine(args, s.cfg, s.run, s.offload, streams=False)

    def run(engine):
        loss, ga, ge = engine.train_step(s.attn_side, s.exp_layers,
                                         s.tokens, s.targets)
        return {"loss": loss, **mpmd_named(ga, ge)}

    def timed(engine):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.train_step(s.attn_side, s.exp_layers, s.tokens,
                                    s.targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del out
        return sorted(times[1:])[1] * 1e3

    g1, g2 = run(s.engine), run(s.engine)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(g1[k], g2[k]) for k in g1)
    del g2
    g3 = run(one)
    torch.cuda.synchronize()
    worst, worst_rel, ok = None, 0.0, True
    for k in g1:
        err, tol, good = compare_f32(g1[k], g3[k])
        rel = err / max(tol / TOL_F32, 1e-30)
        ok = ok and good
        if rel >= worst_rel:
            worst, worst_rel = k, rel
    same = all(torch.equal(g1[k], g3[k]) for k in g1)
    del g1, g3
    streams_ms, one_ms = timed(s.engine), timed(one)
    return {"bitwise_rerun": bitwise, "one_stream_bitwise_equal": same,
            "worst": worst, "worst_rel_err": worst_rel,
            "step_ms_streams": streams_ms, "step_ms_one_stream": one_ms,
            "ok": bitwise and ok}


def zebra_plain(torch, name: str, lhs, tg, bm: int, spans, G: int, *, wg,
                wu, wo, wo_t, dout):
    """The plain version of grouped kernel ``name`` on one packed layout,
    evaluated one expert's rows at a time (the plain versions gather one
    weight per row tile: 324 tiles of 8 rows would gather 19 GB of f32
    weights at once). Returns a thunk."""
    from repro_torch.kernels import gmm
    rhs = {"gmm:bf16.bf16->bf16": wo, "gmm:bf16.bf16->f32": wg,
           "gmm:f32.bf16->f32": wo, "gmm:f32.bf16T->f32": wo_t}.get(name)
    o_dt = None if name.endswith("bf16") else torch.float32

    def part(r0, r1):
        t = tg[r0 // bm:r1 // bm]
        if name == "gmm_glu":
            return gmm.gmm_glu_plain(lhs[r0:r1], wg, wu, t, block_m=bm)
        if name.startswith("gmm_dw"):
            return gmm.gmm_dw_tiled_plain(lhs[r0:r1], dout[r0:r1], t, G,
                                          block_m=bm)
        return gmm.gmm_tiled_plain(lhs[r0:r1], rhs, t, block_m=bm,
                                   out_dtype=o_dt)

    if name.startswith("gmm_dw"):  # each expert's share: exact zeros else
        return lambda: sum(part(r0, r1) for r0, r1 in spans)
    return lambda: torch.cat([part(r0, r1) for r0, r1 in spans])


def zebra_tiles_phase(torch, cfg, launches_by_path: dict,
                      tiles=ZEBRA_TILES, names=None):
    """The grouped kernels at the zebra runs' packed layouts (W1 widths, 12
    experts, ZEBRA_TILES: 12 x 216 rows at block_m 8 and alltoall chunk
    0's 2 x 224 + 10 x 112 rows at block_m 16), each against its plain
    version at its tier, on the tensor-core design, and timed beside the
    same rows packed at block_m 128 (each expert padded to a multiple of
    128 rows). Operand types as in the zebra backward: bf16 x and
    weights, f32 h and cotangents. ``launches``: each path's count of the
    kernel (the GLU's, or the gmm / gmm_dw operand type's). ``tiles`` and
    ``names`` (a subset of the kernels) serve other layouts: EP decode's
    (EP_TILES, forward kernels only, W2 widths)."""
    from repro_torch.kernels import gmm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    d, f = cfg.d_model, cfg.d_ff_expert
    bf, f32 = torch.bfloat16, torch.float32
    out = []
    for label, caps, bm in tiles:
        G, M = len(caps), sum(caps)

        def layout(block):  # (tile_group, row of each real row)
            padded = [-(-c // block) * block for c in caps]
            tg = torch.repeat_interleave(
                torch.arange(G, dtype=torch.int32, device=dev),
                torch.tensor([p // block for p in padded], device=dev))
            starts = [sum(padded[:g]) for g in range(G)]
            rows = torch.cat([torch.arange(s0, s0 + c, device=dev)
                              for s0, c in zip(starts, caps)])
            return tg, rows, sum(padded)

        tg, _, mp = layout(bm)
        tg128, rows128, mp128 = layout(128)

        def rows(k, dtype, scale=0.5):  # the packed rows, and at 128
            x = (scale * torch.randn((M, k), generator=gen,
                                     device=dev)).to(dtype)
            x128 = torch.zeros((mp128, k), dtype=dtype, device=dev)
            x128[rows128] = x
            return x, x128

        def weights(k, n):
            w = torch.randn((G, k, n), generator=gen, device=dev)
            return (w / math.sqrt(k)).to(bf)

        (x_p, x128), (hb, hb128) = rows(d, bf), rows(f, bf)
        (h_p, h128), (do_p, do128) = rows(f, f32), rows(d, f32)
        dg_p, dg128 = rows(f, f32)
        wg, wu, wo = weights(d, f), weights(d, f), weights(f, d)
        wo_t = wo.transpose(1, 2)
        kw = dict(out_dtype=f32)
        split = gmm.gmm_wgmma_plan(bm, f32)["passes"]
        dw_f32 = gmm.gmm_dw_wgmma_plan(bm, f32)["passes"]
        dw_bf16 = gmm.gmm_dw_wgmma_plan(bm, bf)["passes"]
        wbytes = 2 * G * d * f
        cases = (  # name, kernel(block_m, tg, lhs), lhs, work
            ("gmm_glu", lambda b, t, x: gmm.gmm_glu_tiled_pair(
                x, wg, wu, t, block_m=b), (x_p, x128),
             (2 * M * d + 2 * wbytes + 2 * M * f, 4 * M * d * f)),
            ("gmm:bf16.bf16->bf16", lambda b, t, x: gmm.gmm_tiled(
                x, wo, t, block_m=b), (hb, hb128),
             (2 * M * f + wbytes + 2 * M * d, 2 * M * f * d)),
            ("gmm:bf16.bf16->f32", lambda b, t, x: gmm.gmm_tiled(
                x, wg, t, block_m=b, **kw), (x_p, x128),
             (2 * M * d + wbytes + 4 * M * f, 2 * M * d * f)),
            ("gmm:f32.bf16->f32", lambda b, t, x: gmm.gmm_tiled(
                x, wo, t, block_m=b, **kw), (h_p, h128),
             (4 * M * f + wbytes + 4 * M * d, split * 2 * M * f * d)),
            ("gmm:f32.bf16T->f32", lambda b, t, x: gmm.gmm_tiled(
                x, wo_t, t, block_m=b, **kw), (do_p, do128),
             (4 * M * d + wbytes + 4 * M * f, split * 2 * M * d * f)),
            ("gmm_dw:f32.f32->f32", lambda b, t, x: gmm.gmm_dw_tiled(
                x, do_p if b == bm else do128, t, G, block_m=b),
             (h_p, h128),
             (4 * M * f + 4 * M * d + 4 * G * f * d,
              dw_f32 * 2 * M * f * d)),
            ("gmm_dw:bf16.f32->f32", lambda b, t, x: gmm.gmm_dw_tiled(
                x, dg_p if b == bm else dg128, t, G, block_m=b),
             (x_p, x128),
             (2 * M * d + 4 * M * f + 4 * G * d * f,
              dw_bf16 * 2 * M * d * f)))
        spans = [(sum(caps[:g]), sum(caps[:g + 1])) for g in range(G)]
        for name, fn, (lhs, lhs128), (moved, flops) in cases:
            if names is not None and name not in names:
                continue
            plain = zebra_plain(torch, name, lhs, tg, bm, spans, G,
                                wg=wg, wu=wu, wo=wo, wo_t=wo_t,
                                dout=do_p if "f32.f32" in name else dg_p)
            got, design = with_design(lambda: fn(bm, tg, lhs))
            want = plain()
            torch.cuda.synchronize()
            err, tol, ok = (compare if got.dtype == bf else compare_f32)(
                got, want)
            del got, want
            t_bound, by = bound(moved, flops)
            plan = (gmm.gmm_wgmma_plan(bm, lhs.dtype) if "dw" not in name
                    else None)
            out.append({
                "name": name, "layout": label, "route": "cuda",
                "design": design, "source": kernel_source(name, design),
                "replaces": kernel_replaces(name), "block_m": bm,
                "tile_m": plan["tile_m"] if plan else bm,
                "max_abs_err": err, "tol": tol,
                "ok": ok and design == "wgmma",
                **kernel_times(lambda: fn(bm, tg, lhs), 5),
                "ms_block_m128": cuda_ms(lambda: fn(128, tg128, lhs128), 5),
                "bound_ms": t_bound, "bound_by": by,
                "launches": {p: c.get(name, 0)
                             for p, c in launches_by_path.items()},
                "shapes": {"rows": M, "padded_rows": mp,
                           "padded_rows_block_m128": mp128, "groups": G,
                           "K": lhs.shape[1]}})
        del x_p, x128, hb, hb128, h_p, h128, do_p, do128, dg_p, dg128
        torch.cuda.empty_cache()
    return out


def sdpa_ms(torch, q, k, v, do, scale: float, causal: bool = True):
    """(forward ms, backward ms, note) of PyTorch's GQA
    scaled_dot_product_attention (causal, or not) on the kernels' inputs
    ([B, heads, rows, hd]): the yardstick of the flash kernels, never
    called by the port. The backward is forward + backward minus forward
    (dq, dk, dv as one figure); (None, None, the reason) where this torch
    refuses."""
    F = torch.nn.functional

    def fwd(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal,
                                              scale=scale, enable_gqa=True)

    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    try:
        f_ms = cuda_ms(lambda: fwd(q, k, v), 10)
        fb_ms = cuda_ms(lambda: torch.autograd.grad(fwd(*ins), ins, do), 10)
    except (RuntimeError, TypeError) as e:  # optional yardstick
        return None, None, f"SDPA refused: {str(e)[:160]}"
    return f_ms, fb_ms - f_ms, f"torch SDPA (is_causal={causal}, enable_gqa)"


def flash_case(torch, label, B, S, H, KH, hd, dtype, window=0, softcap=0.0,
               seed=5, T=None, causal=True):
    """The flash kernels against their plain versions on random inputs of
    one shape, S queries over T keys (default S), causal or not: the
    forward (o in q's dtype, lse in f32) and, without softcap, the dq and
    dk/dv kernels (fed the plain forward's o and lse, as the backward of
    the Function is). Inputs are scaled so the bf16 outputs stay below 4,
    where one bf16 ulp is below 2e-2; a softcap case scales q up so the
    tanh bends the logits. Returns one entry per kernel, with its time, the
    plain version's, its bound and the SDPA yardstick (cases without
    window or softcap)."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    T = S if T is None else T

    def rnd(heads, scale, rows):
        x = torch.randn((B, heads, rows, hd), generator=gen, device=dev)
        return (scale * x).to(dtype)

    q, k, v, do = rnd(H, 4.0 if softcap else 1.0, S), rnd(KH, 1.0, T), \
        rnd(KH, 0.5, T), rnd(H, 0.25, S)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window)
    bf16 = dtype == torch.bfloat16
    check = compare if bf16 else compare_f32
    es, peak = q.element_size(), BF16_FLOPS if bf16 else FP32_FLOPS
    pairs = int(fa._mask(S, T, S, T, causal, window, dev).sum()) * B * H
    nq, nkv, rows = q.numel(), k.numel(), B * H * S
    lib_f = lib_b = None
    lib_note = "none: SDPA has no window / softcap of this form"
    if not window and not softcap:
        lib_f, lib_b, lib_note = sdpa_ms(torch, q, k, v, do, kw["scale"],
                                         causal)
    shapes = {"case": label, "q": list(q.shape), "kv": list(k.shape),
              "dtype": str(dtype).replace("torch.", ""), "causal": causal,
              "window": window, "softcap": softcap, "live_pairs": pairs}

    def entry(name, errs, ms, plain_ms, bytes_moved, flops, lib_ms,
              design="fma"):
        t_bound, by = bound(bytes_moved, flops, peak)
        source = {"wgmma": ("flash_fwd_wgmma.cu" if name == "flash_fwd"
                            else "flash_bwd_wgmma.cu"),
                  "fma": "flash_attention.cu"}[design]
        return {"name": name, "route": "cuda", "design": design,
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": FLASH_REPLACES[name],
                "max_abs_err": max(e[0] for e in errs.values()),
                "tol": min(e[1] for e in errs.values()),
                "errors": {n: {"max_abs_err": e[0], "tol": e[1]}
                           for n, e in errs.items()},
                "ok": all(e[2] for e in errs.values()),
                **ms, "plain_ms": plain_ms, "bound_ms": t_bound,
                "bound_by": by, "library_ms": lib_ms, "library": lib_note,
                "shapes": shapes}

    fwd_kw = dict(kw, softcap=softcap)
    (o, lse), design = with_design(lambda: fa.flash_forward(q, k, v,
                                                            **fwd_kw))
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **fwd_kw)
    torch.cuda.synchronize()
    out = [entry(
        "flash_fwd", {"o": check(o, o_p), "lse": compare_f32(lse, lse_p)},
        kernel_times(lambda: fa.flash_forward(q, k, v, **fwd_kw), 10),
        cuda_ms(lambda: fa.flash_forward_plain(q, k, v, **fwd_kw), 3),
        es * (2 * nq + 2 * nkv) + 4 * rows, 4 * hd * pairs, lib_f, design)]
    del o, lse
    if softcap:
        return out
    delta = (do.float() * o_p.float()).sum(-1).contiguous()
    bw = (q, k, v, do, lse_p, delta)
    (dq,), dq_design = with_design(lambda: fa._launch_backward("dq", *bw,
                                                               **kw))
    (dk, dv), dkv_design = with_design(lambda: fa._launch_backward(
        "dkv", *bw, **kw))
    want = fa.flash_backward_plain(q, k, v, o_p, lse_p, do, **kw)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: fa.flash_backward_plain(q, k, v, o_p, lse_p,
                                                       do, **kw), 3)
    out.append(entry(
        "flash_dq", {"dq": check(dq, want[0])},
        kernel_times(lambda: fa._launch_backward("dq", *bw, **kw), 10),
        plain_ms,
        es * (3 * nq + 2 * nkv) + 8 * rows, 6 * hd * pairs, lib_b,
        dq_design))
    out.append(entry(
        "flash_dkv", {"dk": check(dk, want[1]), "dv": check(dv, want[2])},
        kernel_times(lambda: fa._launch_backward("dkv", *bw, **kw), 10),
        plain_ms,
        es * (2 * nq + 4 * nkv) + 8 * rows, 8 * hd * pairs, lib_b,
        dkv_design))
    for e in out[1:]:
        e["plain"] = "flash_backward_plain (dq, dk, dv together)"
        e["library"] = ("SDPA forward + backward minus forward (dq, dk, dv "
                        "together)" if lib_b is not None else lib_note)
        # the FMA kernel the tensor-core design replaced, same inputs
        e["fma_ms"] = (fma_backward_ms(torch, e["name"][6:], bw, kw)
                       if e["design"] == "wgmma" else None)
    return out


def fma_backward_ms(torch, name: str, bw, kw) -> float:
    """Device ms of the FMA ``flash_<name>`` kernel of
    csrc/flash_attention.cu on the inputs ``bw`` = (q, k, v, do, lse,
    delta): the design that the tensor-core kernel replaced for bf16,
    timed in the same run. It is launched through the library's C entry,
    outside the wrapper, whose route sends bf16 to the tensor cores."""
    import ctypes
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do, lse, delta = bw
    dims = fa._check(q, k, v, kw.get("q_len"), kw.get("kv_len"), do)
    outs = (torch.empty_like(q),) if name == "dq" else \
        (torch.empty_like(k), torch.empty_like(v))
    strides = fa._strides(q, k, v, do, *outs)
    fn = getattr(fa._lib(), f"flash_{name}_{fa._DTYPES[q.dtype]}")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            ctypes.addressof(strides), *dims, int(kw["causal"]),
            int(kw.get("window", 0)), float(kw["scale"]), fa._stream(q))

    def launch():
        if fn(*args) != 0:
            raise RuntimeError(f"FMA flash_{name} launch failed")
    return cuda_ms(launch, 10)


def check_flash_kernels(torch, cfg, batch: int, seq: int):
    """The flash kernels at the flash train run's shapes (the kernel line's
    entries) and at batch 2 x seq 1024 (8+ q-tiles: the causal skip), with
    a window, with a softcap (forward only) and under f32 inputs."""
    dims = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    bf, f32 = torch.bfloat16, torch.float32
    main = flash_case(torch, f"{batch}x{seq}", batch, seq, *dims, bf)
    cases = (flash_case(torch, "2x1024", 2, 1024, *dims, bf)
             + flash_case(torch, f"{batch}x{seq}-window100", batch, seq,
                          *dims, bf, window=100)
             + flash_case(torch, f"{batch}x{seq}-softcap5", batch, seq,
                          *dims, bf, softcap=5.0)
             + flash_case(torch, f"{batch}x{seq}-f32", batch, seq, *dims,
                          f32))
    return main, cases


def flash_grad_phase(torch, cfg, batch: int, seq: int):
    """The flash attention Function (forward, dq and dk/dv kernels) against
    torch.autograd through the attention oracle ``ref.attention`` with the
    causal mask, at the train shape in f32: out, dq, dk, dv."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rand(heads, scale=1.0):
        return scale * torch.randn((batch, seq, heads, hd), generator=gen,
                                   device=dev)

    inputs, ct = [rand(H), rand(KH), rand(KH, 0.5)], rand(H)
    mask = ref.causal_window_mask(seq, seq, True, 0, device=dev)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        out = fn(*ins)
        out.backward(ct)
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in ins]

    got = grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=True))
    want = grads(lambda q, k, v: ref.attention(q, k, v, mask=mask))
    res = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err, tol, ok = compare_f32(a, b)
        res[name] = {"max_abs_err": err, "tol": tol, "ok": ok}
    return {"shapes": {"q": list(inputs[0].shape),
                       "kv": list(inputs[1].shape), "causal": True},
            "results": res, "ok": all(r["ok"] for r in res.values())}


def flash_grad_bf16_phase(torch, cfg, batch: int, seq: int):
    """The flash attention Function in bf16 at the flash train run's
    attention shape (causal, GQA, hd 128): its output and dq, dk, dv (the
    tensor-core forward, dq and dk/dv kernels; each launch must take that
    design) against the plain forward and backward on the same inputs,
    within 2e-2 * min(1, max|plain|)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rand(heads, scale):  # |dq|, |dk|, |dv| stay below 1 at these scales
        x = torch.randn((batch, seq, heads, hd), generator=gen, device=dev)
        return (scale * x).to(torch.bfloat16)

    q, k, v, ct = rand(H, 1.0), rand(KH, 1.0), rand(KH, 0.5), rand(H, 0.25)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = kernels.design_launch_counts()
    out = ops.flash_attention(*ins, causal=True)
    out.backward(ct)
    torch.cuda.synchronize()
    after = kernels.design_launch_counts()
    moved = {n: after[n] - before[n] for n in after if after[n] > before[n]}
    kw = dict(scale=hd ** -0.5, causal=True)
    o_p, lse_p = fa.flash_forward_plain(*(t.transpose(1, 2)
                                          for t in (q, k, v)), **kw)
    want = fa.flash_backward_plain(*(t.transpose(1, 2) for t in (q, k, v)),
                                   o_p, lse_p, ct.transpose(1, 2), **kw)
    res = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          [out.detach()] + [t.grad for t in ins],
                          [o_p] + list(want)):
        err, tol, ok = compare(a, b.transpose(1, 2))
        res[name] = {"max_abs_err": err, "tol": tol, "ok": ok}
    designs_ok = moved == {"flash_fwd:wgmma": 1, "flash_dq:wgmma": 1,
                           "flash_dkv:wgmma": 1}
    return {"shapes": {"q": list(q.shape), "kv": list(k.shape),
                       "dtype": "bfloat16", "causal": True},
            "designs": moved, "results": res,
            "ok": designs_ok and all(r["ok"] for r in res.values())}


def c1_tiles_phase(torch):
    """Every grouped kernel at block_m 8, 16 and 32 (row tiles under 64,
    as the reference's capacity routing produces) against its plain
    version at a small packed shape: groups of 37, 0, 90, 73 and 5 rows,
    K 96, N 80; each call must launch its kernel once, the bf16 ones, f32
    x bf16, f32 x bf16^T and gmm_dw on the tensor-core design. bf16
    outputs at the bf16 tier, f32 at 1e-4 * max|plain|."""
    from repro_torch import kernels
    from repro_torch.kernels import gmm, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32
    sizes = torch.tensor([37, 0, 90, 73, 5], dtype=torch.int32, device=dev)
    M, G, K, N = int(sizes.sum()), sizes.numel(), 96, 80
    x = 0.5 * torch.randn((M, K), generator=gen, device=dev)
    dy = torch.randn((M, N), generator=gen, device=dev)
    wg, wu = (torch.randn((G, K, N), generator=gen, device=dev)
              / math.sqrt(K) for _ in range(2))
    wgb, wub = wg.to(bf), wu.to(bf)

    def transposed(w):  # swapaxes(W, 1, 2) of a row-major [G, N, K] weight
        return w.transpose(1, 2).contiguous().transpose(1, 2)

    tiled = (gmm.gmm_tiled, gmm.gmm_tiled_plain)
    glu = (gmm.gmm_glu_tiled_pair, gmm.gmm_glu_plain)
    dw = (gmm.gmm_dw_tiled, gmm.gmm_dw_tiled_plain)
    results = {}
    for bm in C1_BLOCK_M:
        dest, tg, mp = ops._pack_meta(sizes, M, G, bm)
        xb, xf, dyf = (ops._scatter_rows(t.to(dt), dest, mp)
                       for t, dt in ((x, bf), (x, f32), (dy, f32)))
        calls = {
            "gmm:bf16.bf16->bf16": (tiled, (xb, wgb, tg), {}),
            "gmm:bf16.bf16->f32": (tiled, (xb, wgb, tg), {"out_dtype": f32}),
            "gmm:f32.f32->f32": (tiled, (xf, wg, tg), {}),
            "gmm:f32.bf16->f32": (tiled, (xf, wgb, tg), {"out_dtype": f32}),
            "gmm:f32.bf16T->f32": (tiled, (xf, transposed(wgb), tg),
                                   {"out_dtype": f32}),
            "gmm:f32.f32T->f32": (tiled, (xf, transposed(wg), tg), {}),
            "gmm_glu:bf16": (glu, (xb, wgb, wub, tg), {}),
            "gmm_glu:f32": (glu, (xf, wg, wu, tg), {}),
            "gmm_dw:bf16.f32->f32": (dw, (xb, dyf, tg, G), {}),
            "gmm_dw:f32.f32->f32": (dw, (xf, dyf, tg, G), {}),
        }
        for name, ((kernel, plain), args, kw) in calls.items():
            before = sum(kernels.launch_counts().values())
            got, design = with_design(lambda: kernel(*args, block_m=bm, **kw))
            launched = sum(kernels.launch_counts().values()) - before
            want = plain(*args, block_m=bm, **kw)
            torch.cuda.synchronize()
            err, tol, ok = (compare if got.dtype == bf else compare_f32)(
                got, want)
            # K 96, N 80: gmm_dw, the bf16 GLU, the bf16 gmm, f32 x bf16
            # and f32 x bf16^T take the tensor-core design
            ok = ok and (design == "wgmma" or not (
                name.startswith("gmm_dw") or name == "gmm_glu:bf16"
                or name in WGMMA_GMM))
            results.setdefault(name, {})[bm] = {
                "max_abs_err": err, "tol": tol, "launches": launched,
                "design": design, "ok": ok and launched == 1}
    return {"block_m": list(C1_BLOCK_M),
            "shape": {"groups": sizes.tolist(), "K": K, "N": N},
            "results": results,
            "ok": all(r["ok"] for per in results.values()
                      for r in per.values())}


def train_mamba2_phase(torch, train_mod, smi: str):
    """The mamba2 train path: one untimed warm-up step on a model of its
    own, then the driver's 6 steps of batch 2 x seq 2048 on full-width,
    full-depth ``mamba2-2.7b`` (:func:`timed_train`)."""
    warm = train_mod.train_arch(
        "mamba2-2.7b",
        train_mod.build_parser().parse_args(MAMBA2_WARMUP_ARGS))
    if not warm["ok"]:
        raise RuntimeError("mamba2 warm-up train step failed")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_mamba2 warm-up: 1 step (untimed, not counted), loss "
          f"{warm['history'][0]['loss']:.4f}", flush=True)
    return timed_train(torch, train_mod, smi, MAMBA2_ARGS, MAMBA2_LAUNCHES)


def ssd_inputs(torch, cfg, b: int, T: int, dtype, dev, seed: int):
    """x, dt, A, B, C of one SSD mixer at ``cfg``'s widths, as the model
    hands them to the scan: x, B and C strided views into one [b, T,
    din + 2 ns] tensor (the conv output), dt = softplus(N(0,1)) f32, A =
    -(1..16) as mamba2's init. x, B and C are scaled by 1/4 so |y| stays
    near 1, where one bf16 ulp is below the 2e-2 tier."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, ns = cfg.ssm_heads, cfg.ssm_state
    din = cfg.ssm_expand * cfg.d_model
    xbc = 0.25 * torch.randn((b, T, din + 2 * ns), generator=gen,
                             device=dev)
    xbc = xbc.to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, T, h), generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    return (xbc[..., :din].reshape(b, T, h, din // h), dt, A,
            xbc[..., din:din + ns], xbc[..., din + ns:])


def ssd_work(b: int, T: int, h: int, hd: int, ns: int, Q: int,
             es: int, passes: int = 1):
    """(bytes, flops) the scan needs: x, dt, B, C read once, y and the
    f32 state written once; products: per (batch, head) and chunk of r
    live rows the causal half of G·x̄ (2·hd per live (i, j) pair), C·S
    (but for the first chunk, where S = 0) and the state update (2·r·ns·hd
    each), each ``passes`` times (the tensor-core design's three bf16 terms
    of each f32 factor), and C·Bᵀ once per (batch, chunk) over its live
    pairs."""
    flops = 0
    for c, c0 in enumerate(range(0, T, Q)):
        r = min(Q, T - c0)
        pairs = r * (r + 1) // 2
        flops += passes * b * h * (2 * hd * pairs
                                   + 2 * r * ns * hd * (2 if c else 1))
        flops += b * 2 * ns * pairs
    moved = (b * T * h * hd * es * 2 + b * T * h * 4 + h * 4
             + 2 * b * T * ns * es + b * h * hd * ns * 4)
    return moved, flops


def fma_ssd(torch, args, chunk: int):
    """A call of the FMA SSD kernel (csrc/ssd.cu, the design the
    tensor-core kernel replaced for bf16) on the same inputs, through its C
    entry: no launch counter moves."""
    import ctypes
    from repro_torch.kernels import ssd
    x, dt, A, B, C = args
    b, T, h, hd = x.shape
    ns = B.shape[-1]
    y = torch.empty((b, T, h, hd), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, hd, ns), dtype=torch.float32,
                        device=x.device)
    st = [*x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
          *y.stride()[:3]]
    strides = (ctypes.c_longlong * len(st))(*st)
    fn = getattr(ssd._lib(), f"ssd_scan_{ssd._DTYPES[x.dtype]}")
    Q = ssd.chunk_rows(T, chunk)

    def launch():  # y, state and strides live as long as the closure
        if fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), y.data_ptr(), state.data_ptr(),
              ctypes.addressof(strides), b, T, h, hd, ns, Q,
              torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("FMA ssd_scan launch failed")
    return launch


def ssd_case(torch, cfg, label: str, b: int, T: int, dtype, seed: int):
    """The SSD scan kernel against its plain version at ``cfg``'s widths
    and chunk on one (b, T): y at the tier of its dtype, the final state
    at the f32 tier; the design that ran (bf16: the tensor cores), its
    time, the plain version's, the replaced FMA kernel's on the same
    inputs (tensor-core design) and the bound of the design's work."""
    from repro_torch.kernels import ssd
    dev = torch.device("cuda")
    args = ssd_inputs(torch, cfg, b, T, dtype, dev, seed)
    chunk = cfg.ssm_chunk
    (y, state), design = with_design(lambda: ssd.ssd_scan(*args,
                                                          chunk=chunk))
    y_p, state_p = ssd.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    errs = {"y": (compare if bf16 else compare_f32)(y, y_p),
            "state": compare_f32(state, state_p)}
    del y, state, y_p, state_p
    x = args[0]
    Q = ssd.chunk_rows(T, chunk)
    wgmma = design == "wgmma"
    hd, ns = x.shape[3], args[3].shape[-1]
    passes = ssd.ssd_wgmma_plan(hd, ns, Q)["passes"] if wgmma else 1
    moved, flops = ssd_work(b, T, x.shape[2], hd, ns, Q, x.element_size(),
                            passes)
    t_bound, by = bound(moved, flops, BF16_FLOPS if wgmma else FP32_FLOPS)
    return {
        "name": "ssd", "route": "cuda", "design": design,
        "source": ("src/repro_torch/csrc/ssd_wgmma.cu" if wgmma
                   else "src/repro_torch/csrc/ssd.cu"),
        "replaces": SSD_REPLACES,
        "max_abs_err": max(e[0] for e in errs.values()),
        "tol": min(e[1] for e in errs.values()),
        "errors": {n: {"max_abs_err": e[0], "tol": e[1]}
                   for n, e in errs.items()},
        "ok": all(e[2] for e in errs.values()),
        **kernel_times(lambda: ssd.ssd_scan(*args, chunk=chunk), 10),
        "plain_ms": cuda_ms(lambda: ssd.ssd_scan_plain(*args, chunk=chunk),
                            3),
        "fma_ms": cuda_ms(fma_ssd(torch, args, chunk), 10) if wgmma else None,
        "bound_ms": t_bound, "bound_by": by, "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "shapes": {"case": label, "x": list(x.shape),
                   "x_strides": list(x.stride()), "B": list(args[3].shape),
                   "dtype": str(dtype).replace("torch.", ""), "chunk": Q,
                   "passes": passes, "flops_needed": flops,
                   "bytes_needed": moved}}


def check_ssd_kernel(torch, cfg, batch: int, seq: int):
    """The SSD scan kernel at the mamba2 run's shape (the kernels line's
    entry, bf16 as under the bf16 policy), and at that shape in f32, at a
    ragged T (2 x 1000) and at T < 128 (the chunk drops to 128), in bf16
    and f32."""
    bf, f32 = torch.bfloat16, torch.float32
    main = ssd_case(torch, cfg, f"{batch}x{seq}", batch, seq, bf, 9)
    cases = [ssd_case(torch, cfg, f"{batch}x{seq}-f32", batch, seq, f32, 9)]
    for b, T in ((2, 1000), (2, 100)):
        for dtype in (bf, f32):
            cases.append(ssd_case(torch, cfg, f"{b}x{T}", b, T, dtype, 10))
    return main, cases


def ssd_grad_phase(torch, cfg):
    """The SSD autograd Function (kernel forward, autograd of
    ref.ssd_chunked backward) on the card against the same Function on the
    CPU (plain forward), f32, at the mamba2 widths on 1 x 600 (three
    chunks, the last one ragged): y, state and the five gradients."""
    from repro_torch.kernels import ops
    args = ssd_inputs(torch, cfg, 1, 600, torch.float32, "cpu", 11)
    gen = torch.Generator().manual_seed(12)
    gy = torch.randn(args[0].shape, generator=gen)
    gs = torch.randn((1, cfg.ssm_heads, args[0].shape[-1], cfg.ssm_state),
                     generator=gen)

    def run(dev):
        ins = [t.detach().to(dev).requires_grad_(True) for t in args]
        y, state = ops.ssd(*ins, chunk=cfg.ssm_chunk)
        torch.autograd.backward([y, state], [gy.to(dev), gs.to(dev)])
        return [y.detach(), state.detach()] + [t.grad for t in ins]

    want = run("cpu")
    got = run(torch.device("cuda"))
    torch.cuda.synchronize()
    res = {}
    for i, (name, a, b) in enumerate(zip(
            ("y", "state", "dx", "ddt", "dA", "dB", "dC"), got, want)):
        err = float((a.cpu() - b).abs().max())
        tol = (TOL_F32 if i < 2 else SSD_GRAD_TOL) * float(b.abs().max())
        res[name] = {"max_abs_err": err, "tol": tol, "ok": err <= tol}
    return {"shapes": {"x": list(args[0].shape), "chunk": cfg.ssm_chunk},
            "results": res, "ok": all(r["ok"] for r in res.values())}


# -- the training driver's infrastructure and step options -------------------

def driver_counts(kernels) -> dict:
    """The launch, operand-type and design counters as one dict."""
    return {**kernels.launch_counts(), **kernels.variant_launch_counts(),
            **kernels.design_launch_counts()}


def check_zebra_launches(label: str, counts: dict, per_step: dict,
                         layers: int, steps: int):
    """Exactly ``per_step`` launches per layer and step, no other kernel,
    every one on the tensor-core design."""
    from repro_torch import kernels
    check_designs(label, counts)
    names = kernels.launch_counts()
    want = {k: per_step.get(k, 0) * layers * steps for k in names}
    got = {k: counts[k] for k in names}
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want}")


class _Tee:
    """A stdout that also keeps what was written (the driver's lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def train_ckpt_phase(torch, train_mod, smi: str):
    """The driver's checkpoint and resume on W1 at full width cut to 1
    layer (CKPT_LAYERS): 4 steps straight; then 2 steps with
    ``--ckpt-every 2`` into a directory under ``build/``, and a new
    program that resumes (``--resume``) and trains steps 3-4, its launch
    counters set to 0 just before and read just after. Steps 3-4's losses
    and grad norms, and every param and moment after step 4, must equal
    the straight run's bit for bit; steps 3-4 launch exactly the zebra
    counts per layer and step, all wgmma. Reports the bytes written, each
    save's host snapshot and write ms (the async write timed on its
    thread) and the restore's ms; deletes the directory."""
    import dataclasses
    import shutil

    from repro_torch import kernels
    from repro_torch.models import registry
    from repro_torch.pytree import flatten
    cfg = dataclasses.replace(registry.get_config("mixtral-w1"),
                              n_layers=CKPT_LAYERS)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    parse = train_mod.build_parser().parse_args
    try:
        straight = train_mod.train_arch(
            "mixtral-w1", parse(CKPT_ARGS + ["--steps", "4"]), cfg=cfg,
            return_state=True)
        first = train_mod.train_arch(
            "mixtral-w1", parse(CKPT_ARGS + ["--steps", "2", "--ckpt-every",
                                             "2", "--ckpt-dir",
                                             str(ckpt_dir)]), cfg=cfg)
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        resumed = train_mod.train_arch(
            "mixtral-w1", parse(CKPT_ARGS + ["--steps", "4", "--resume",
                                             "--ckpt-dir", str(ckpt_dir)]),
            cfg=cfg, return_state=True)
        torch.cuda.synchronize()
        counts = driver_counts(kernels)
        disk = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                   if f.is_file())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check_zebra_launches("train_ckpt (steps 3-4)", counts, ZEBRA_LAUNCHES,
                         CKPT_LAYERS, 2)
    want = {"loss": [m["loss"] for m in straight["history"][2:]],
            "grad_norm": [m["grad_norm"] for m in straight["history"][2:]]}
    got = {"loss": [m["loss"] for m in resumed["history"]],
           "grad_norm": [m["grad_norm"] for m in resumed["history"]]}
    a = flatten({"params": straight["final_params"],
                 "opt": straight["final_opt_state"]})
    b = flatten({"params": resumed["final_params"],
                 "opt": resumed["final_opt_state"]})
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    saves = first["ckpt"]["saves"] + resumed["ckpt"]["saves"]
    restore = resumed["ckpt"]["restore"]
    line = {"arch": "mixtral-w1", "reduced": {"n_layers": [4, CKPT_LAYERS]},
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "params": resumed["params"],
            "zebra": resumed["zebra"], "start_step": resumed["start_step"],
            "steps_3_4": got, "straight_steps_3_4": want,
            "bitwise_metrics": got == want, "leaves": len(a),
            "leaves_differing": differ,
            "saves": [{k: r[k] for k in ("step", "bytes", "snapshot_s",
                                         "write_s", "blocking")}
                      for r in saves],
            "bytes_written": sum(r["bytes"] for r in saves),
            "checkpoint_dir_bytes": disk,
            "restore_s": restore["s"], "restore_bytes": restore["bytes"],
            "launches_per_layer_step": {k: counts[k] / (CKPT_LAYERS * 2)
                                        for k in ZEBRA_LAUNCHES},
            "design_launches": {k: v for k, v in counts.items()
                                if k.endswith((":wgmma", ":fma"))},
            "ok": got == want and not differ
            and resumed["start_step"] == 2 and resumed["ok"]}
    del straight, resumed, a, b
    return line, counts


def tree_nbytes(tree) -> int:
    from repro_torch.pytree import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def layout_nbytes(layout, params, opt_state) -> dict:
    """This rank's param and optimizer bytes as held, and as the sharding
    rules' block shapes (``local_shape`` of the fitted specs) give them."""
    from repro_torch.pytree import flatten
    from repro_torch.sharding.rules import local_shape
    mesh = layout.mesh
    p, o = flatten(params), flatten(opt_state)
    want_p = sum(math.prod(local_shape(layout.param_specs[k],
                                       layout.shapes[k], mesh))
                 * p[k].element_size() for k in p)
    want_o = 4 * sum(math.prod(local_shape(s, layout.shapes[k], mesh))
                     for key in ("mu", "nu", "master")
                     for k, s in layout.opt_specs.get(key, {}).items())
    return {"param_bytes": tree_nbytes(params), "param_bytes_rules": want_p,
            "opt_bytes": tree_nbytes(opt_state),
            "opt_bytes_rules": want_o + 4}  # + the int32 step


def mesh_rank_worker(rank: int, argv, out_path: str):
    """One rank of the driver's ``--mesh`` at world n (``launch_ranks``
    target): rank 0 writes the losses and grad norms to ``out_path``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    args = train_mod.build_parser().parse_args(argv)
    mesh = make_mesh(parse_mesh(args.mesh), ("data", "model"), "cuda")
    s = train_mod.train_arch(args.arch, args, mesh=mesh)
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps({
            "ok": s["ok"], "ms_per_step": s["ms_per_step"],
            "loss": [m["loss"] for m in s["history"]],
            "grad_norm": [m["grad_norm"] for m in s["history"]]}))


def train_mesh_phase(torch, train_mod, smi: str):
    """The training mesh: the driver's zebra default on mixtral-w1 at full
    width and depth, 3 steps, first through the one-process program, then
    through ``--mesh 1x1``: the mesh program on one rank of an NCCL group
    (``launch_ranks``), its launch and collective counters set to 0 just
    before and read just after. Gate: its losses and every param leaf
    after step 3 equal the one-process program's within MESH_TIER (of the
    loss, of max|leaf|), and it launches exactly the zebra counts per
    layer and step, all wgmma. Reported: both programs' step ms, the
    collectives launched (none at one rank), this rank's param and
    optimizer bytes against the rules' block shapes. With n >= 2 cards,
    ``--mesh 1xn`` and ``nx1`` run too (one process per card), their
    losses held to the world-1 run's at MESH_BF16_TIER."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.launch.mesh import launch_ranks, make_mesh
    from repro_torch.models import registry
    from repro_torch.pytree import flatten
    from repro_torch.sharding import collectives as C
    args = train_mod.build_parser().parse_args(MESH_ARGS)
    layers = registry.get_config(args.arch).n_layers
    one = train_mod.train_arch(args.arch, args, return_state=True)
    ref = {k: v.detach().clone() for k, v in
           flatten(one["final_params"]).items()}
    one.pop("final_params"), one.pop("final_opt_state")
    gc.collect()
    torch.cuda.empty_cache()
    box = {}

    def rank0(rank):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        kernels.reset_launch_counts()
        C.reset_counts()
        s = train_mod.train_arch(args.arch, args, return_state=True,
                                 mesh=mesh)
        torch.cuda.synchronize()
        box["counts"] = driver_counts(kernels)
        box["collectives"] = dict(C.COUNTS)
        got = flatten(s["final_params"])
        box["leaf_err"] = max(
            float((got[k].float() - v.float()).abs().max())
            / max(float(v.float().abs().max()), 1e-30)
            for k, v in ref.items())
        box["bytes"] = layout_nbytes(s.pop("layout"),
                                     s.pop("final_params"),
                                     s.pop("final_opt_state"))
        box["summary"] = s

    launch_ranks(rank0, 1, "cuda")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    s, counts = box["summary"], box["counts"]
    check_zebra_launches("train_mesh (1x1)", counts, ZEBRA_LAUNCHES,
                         layers, args.steps)
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(s["history"], one["history"]))
    worlds = {"1x1": [m["loss"] for m in s["history"]]}
    n = torch.cuda.device_count()
    wide_ok = True
    if n >= 2:
        for mesh_arg in (f"1x{n}", f"{n}x1"):
            with tempfile.TemporaryDirectory() as tmp:
                out = pathlib.Path(tmp) / "losses.json"
                argv = [a if a != "1x1" else mesh_arg for a in MESH_ARGS]
                launch_ranks(mesh_rank_worker, n, "cuda", argv, str(out))
                res = json.loads(out.read_text())
            worlds[mesh_arg] = res["loss"]
            wide_ok &= res["ok"] and all(
                abs(a - b) <= MESH_BF16_TIER * abs(b)
                for a, b in zip(res["loss"], worlds["1x1"]))
    line = {"arch": args.arch, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "mesh": "1x1", "zebra": s["zebra"],
            "params": s["params"], "steps": args.steps,
            "batch": args.batch, "seq": args.seq,
            "loss": worlds["1x1"],
            "one_process_loss": [m["loss"] for m in one["history"]],
            "loss_rel_err": loss_err, "leaf_rel_err": box["leaf_err"],
            "ms_per_step": s["ms_per_step"],
            "one_process_ms_per_step": one["ms_per_step"],
            "step_ms": [t * 1e3 for t in s["step_s"]],
            "one_process_step_ms": [t * 1e3 for t in one["step_s"]],
            "collectives": box["collectives"],
            "collectives_launched": sum(box["collectives"].values()),
            **box["bytes"], "worlds_ran": list(worlds),
            "world_losses": worlds,
            "launches_per_layer_step": {
                k: counts[k] / (layers * args.steps)
                for k in ZEBRA_LAUNCHES},
            "ok": s["ok"] and one["ok"] and loss_err <= MESH_TIER
            and box["leaf_err"] <= MESH_TIER
            and not box["collectives"] and wide_ok
            and box["bytes"]["param_bytes"]
            == box["bytes"]["param_bytes_rules"]
            and box["bytes"]["opt_bytes"] == box["bytes"]["opt_bytes_rules"]}
    return line, counts


def sp_rank_worker(model: int, rank: int, out_path: str):
    """Model rank ``rank`` of ``--mesh 1x<model>`` (MESH_ARGS) on the fake
    process-group backend, in a process of its own: the driver's 3 zebra
    steps (chunked attention), then at world > 1 SP_FLASH_STEPS more with
    ``attn_impl="flash"``, each run's launch and collective counters set
    to 0 just before and read just after. Measured on the way
    (``obs.census.mesh_census``): the q and kv heads of every attention
    call, what each block's checkpoint keeps for the backward (shape and
    storage bytes); and the peak of ``torch.cuda.max_memory_allocated``
    over the chunked run. Writes them to ``out_path`` as JSON."""
    import argparse

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.obs.census import mesh_census
    from repro_torch.sharding import collectives as C
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=model)
    try:
        mesh = make_mesh((1, model), ("data", "model"), "cuda")
        args = train_mod.build_parser().parse_args(
            [a if a != "1x1" else f"1x{model}" for a in MESH_ARGS])
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        C.reset_counts()
        with mesh_census() as rec:
            s = train_mod.train_arch(args.arch, args, mesh=mesh)
        torch.cuda.synchronize()
        out = {"torch": torch.__version__, "backend": dist.get_backend(),
               "world": model, "rank": rank, "coords": mesh.coords,
               "counts": driver_counts(kernels),
               "collectives": dict(C.COUNTS),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "step_ms": [t * 1e3 for t in s["step_s"]],
               "ms_per_step": s["ms_per_step"], "zebra": s["zebra"],
               **rec}
        if model > 1:
            run = RunConfig(policy=Policy(), attn_impl="flash",
                            moe_impl="gather", remat="full")
            kernels.reset_launch_counts()
            with mesh_census() as rec:
                f = train_mod.train_arch(
                    args.arch, argparse.Namespace(**dict(
                        vars(args), steps=SP_FLASH_STEPS)), run=run,
                    mesh=mesh)
            torch.cuda.synchronize()
            out["flash"] = {"counts": driver_counts(kernels),
                            "attn": rec["attn"],
                            "step_ms": [t * 1e3 for t in f["step_s"]]}
        pathlib.Path(out_path).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def spawned_json(torch, label: str, target, *args) -> dict:
    """``target(*args, out_path)`` in a spawned process (this process's
    cached device memory released first); the JSON it writes."""
    import multiprocessing
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "out.json"
        p = multiprocessing.get_context("spawn").Process(
            target=target, args=(*args, str(out)))
        p.start()
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
            p.join()
            raise RuntimeError(f"{label} timed out")
        if p.exitcode != 0 or not out.exists():
            raise RuntimeError(f"{label} exited {p.exitcode}")
        return json.loads(out.read_text())


def sp_run(torch, model: int, rank: int) -> dict:
    """:func:`sp_rank_worker` in a spawned process; its JSON."""
    return spawned_json(torch, f"train_sp: rank {rank} of 1x{model}",
                        sp_rank_worker, model, rank)


def dryrun_worker(out_path: str):
    """``launch.dryrun.lower_cell`` on each cell of the dryrun phase, each
    on a fake process group of its own, in this process: the records with
    each cell's wall seconds, written to ``out_path`` as JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    arch, batch, seq = DRYRUN_CHECK
    cells = [(arch, ShapeConfig("train_zebra", "train", seq, batch),
              dict(mesh_shape=(1, 1), zebra_mode="replicated",
                   microbatches=2))]
    cells += [(a, s, {}) for a, s in DRYRUN_CELLS]
    out = []
    for a, s, kw in cells:
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(a, s, multi_pod=False, **kw)
        rec["wall_s"] = time.perf_counter() - t0
        out.append(rec)
    pathlib.Path(out_path).write_text(json.dumps(out))


def dryrun_phase(torch, smi: str, zebra_line: dict, mesh_line: dict):
    """The dry run on the card's host (:func:`dryrun_worker` in a spawned
    process). Gates: the 1x1 trace of train_zebra's configuration makes
    per step, by kernel and by design, the kernel calls
    (``_build.FAKE_WORK``, nothing launched) that train_zebra's real steps
    launched per step (the wrappers' ``LAUNCHES``); its param and
    optimizer bytes equal train_mesh's (the real tree's and the rules'
    block shapes, W1 at --mesh 1x1); the production cells are ok; the
    card's ``total_memory`` gives every record the ``fits_80gb`` that
    ``H100_MEMORY_BYTES`` gave it. Reported: the card's total memory
    beside that constant, the dry run's peak (arg + temp) beside
    train_zebra's ``max_memory_allocated``, both records, their wall
    seconds and the phase's beside DRYRUN_BUDGET_S."""
    from repro_torch.core import hardware as HW
    t0 = time.perf_counter()
    recs = spawned_json(torch, "dryrun", dryrun_worker)
    wall = time.perf_counter() - t0
    chk, cells = recs[0], recs[1:]
    steps = zebra_line["steps"]

    def per_step(counts):
        return {k: n // steps for k, n in counts.items() if n}
    whole = all(n % steps == 0 for c in ("launches", "design_launches")
                for n in zebra_line[c].values())
    launches_ok = whole and chk["launches"]["by_kernel"] == per_step(
        zebra_line["launches"]) and chk["launches"]["by_design"] == \
        per_step(zebra_line["design_launches"])
    bytes_ok = (chk["param_bytes_per_device"] == mesh_line["param_bytes"]
                == mesh_line["param_bytes_rules"]
                and chk["opt_bytes_per_device"] == mesh_line["opt_bytes"]
                == mesh_line["opt_bytes_rules"])
    total_memory = torch.cuda.get_device_properties(0).total_memory
    fits_same = all((r["total_bytes_per_device"] < total_memory)
                    == r["fits_80gb"] for r in recs if r["status"] == "ok")
    real_peak = zebra_line["max_memory_allocated"]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "total_memory": total_memory,
            "h100_memory_bytes": HW.H100_MEMORY_BYTES,
            "check": {k: chk[k] for k in (
                "arch", "mesh", "launches", "param_bytes_per_device",
                "opt_bytes_per_device", "arg_bytes_per_device",
                "temp_bytes_per_device", "total_bytes_per_device",
                "flops_per_device", "hbm_bytes_per_device", "trace_s",
                "wall_s")},
            "real_launches_per_step": per_step(zebra_line["launches"]),
            "real_design_launches_per_step": per_step(
                zebra_line["design_launches"]),
            "real_bytes": {k: mesh_line[k] for k in (
                "param_bytes", "param_bytes_rules", "opt_bytes",
                "opt_bytes_rules")},
            "real_max_memory_allocated": real_peak,
            "dryrun_peak_over_real": chk["total_bytes_per_device"]
            / real_peak,
            "cells": cells, "phase_wall_s": wall,
            "budget_s": DRYRUN_BUDGET_S,
            "launches_ok": launches_ok, "bytes_ok": bytes_ok,
            "fits_same_on_card": fits_same,
            "ok": launches_ok and bytes_ok and fits_same
            and all(c["status"] == "ok" for c in cells)}


def mpmd_rank_worker(rank: int, out_path: str):
    """Rank ``rank`` of ``hetero_mpmd --ranks MxN`` (MPMD_RANKS, the
    full-width default) on the fake process-group backend, in a process
    of its own: the engine built (this rank's part of the seeded model
    kept, the fused tree dropped), then MPMD_RANKS_STEPS steps with the
    launch counters set to 0 just before and read just after. Measured on
    the way: the shape of every attention call's input and of every
    expert call's packed buffer, the peak of
    ``torch.cuda.max_memory_allocated`` over the steps, the messages and
    bytes of the last step by kind. Writes them to ``out_path`` as JSON."""
    import collections

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.core import zebra_mpmd as zm
    from repro_torch.core import zebra_spmd as zs
    from repro_torch.core.zebra_mpmd_ranks import RankGroups
    from repro_torch.launch import hetero_mpmd as hm
    torch.backends.cuda.matmul.allow_tf32 = False
    M, N = MPMD_RANKS
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=M + N)
    try:
        args = hm.build_parser().parse_args(["--ranks", f"{M}x{N}"])
        s = hm.build(args, ranks=RankGroups(M, N, "cuda"))
        gc.collect()
        torch.cuda.empty_cache()
        attn, experts = collections.Counter(), collections.Counter()
        mixer, dense = zm.modules.apply_mixer_part, zs._experts_dense

        def attention(p, cfg, run, spec, x, *a, **kw):
            attn[tuple(x.shape)] += 1
            return mixer(p, cfg, run, spec, x, *a, **kw)

        def grouped(wg, wu, wo, buf, cd):
            experts[tuple(buf.shape)] += 1
            return dense(wg, wu, wo, buf, cd)
        zm.modules.apply_mixer_part, zs._experts_dense = attention, grouped
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        step_s, losses, ok = [], [], True
        for _ in range(MPMD_RANKS_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = hm.step(s)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            ok = ok and hm.finite(*out)
            losses.append(float(out[0]))
            del out
        counts = driver_counts(kernels)
        eng = s.engine
        pathlib.Path(out_path).write_text(json.dumps({
            "torch": torch.__version__, "backend": dist.get_backend(),
            "rank": rank, "role": eng.ranks.role, "counts": counts,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "step_ms": [t * 1e3 for t in step_s], "loss": losses,
            "finite": ok, "layout": hm.layout(s),
            "attn_shapes": [[list(k), n] for k, n in attn.items()],
            "expert_shapes": [[list(k), n] for k, n in experts.items()],
            "messages_per_step": {f"{op} {kind}": {"messages": n,
                                                   "bytes": b}
                                  for (op, kind), (n, b) in
                                  eng.traffic.items()}}))
    finally:
        dist.destroy_process_group()


def mpmd_ranks_phase(torch, smi: str, one_process: dict):
    """The zebra MPMD engine across ranks, one rank at a time: attention
    rank 0 and lane 0 of ``hetero_mpmd --ranks 4x4`` (the full-width
    default: W1, bf16, 8 x 256, R 2, the planned offloads clamped), each
    in a process of its own on the fake backend, MPMD_RANKS_STEPS steps
    (:func:`mpmd_rank_worker`; the backend moves no data, so the values
    are not checked: the receives are zeroed, the shapes, launches and
    memory are the rank's own). Gates: the lane launches the one-process
    engine's lane launches a step over N (MPMD_CALL per chunk, layer and
    microbatch), every expert call at [E_lane, C_chunk, d]; the attention
    rank launches MPMD_CALL per offloaded-expert call, none at a lane's
    shape, and every attention call at 1 row of 256; both all on the
    tensor-core designs, each peak below the one-process engine's in
    ``train_mpmd:`` (``one_process``), every loss finite. Reported: each
    rank's step ms (its compute only, the point-to-point sends not run),
    its peak beside the one-process one, its messages and bytes a step by
    kind."""
    from repro_torch import kernels
    from repro_torch.launch import hetero_mpmd as hm
    M, N = MPMD_RANKS
    runs = {"attention": spawned_json(torch, "mpmd_ranks: attention rank 0",
                                      mpmd_rank_worker, 0),
            "lane": spawned_json(torch, f"mpmd_ranks: lane 0 (rank {M})",
                                 mpmd_rank_worker, M)}
    lay = runs["lane"]["layout"]
    R, Q, L = hm.MICROBATCHES, lay["n_chunks"], len(lay["offload"])
    steps, d = MPMD_RANKS_STEPS, 2048
    lane_calls = R * Q * sum(e > 0 for e in lay["experts_per_lane"])
    attn_calls = R * sum(a > 0 for a in lay["attn_experts"])
    names = kernels.launch_counts()
    want = {"lane": {k: MPMD_CALL.get(k, 0) * lane_calls * steps
                     for k in names},
            "attention": {k: MPMD_CALL.get(k, 0) * attn_calls * steps
                          for k in names}}
    lane_shapes = {(e, lay["C_chunk"], d) for e in lay["experts_per_lane"]
                   if e}
    out, ok = {}, True
    for role, r in runs.items():
        check_designs(f"mpmd_ranks ({role})", r["counts"])
        got = {k: r["counts"][k] for k in names}
        shapes = {tuple(k) for k, _n in r["expert_shapes"]}
        if role == "lane":
            shapes_ok = shapes == lane_shapes and not r["attn_shapes"]
        else:
            shapes_ok = not shapes & lane_shapes and {
                tuple(k) for k, _n in r["attn_shapes"]} == {
                    (hm.BATCH // (R * M), hm.SEQ, d)}
        ok_r = (got == want[role] and shapes_ok and r["finite"]
                and r["peak_bytes"] < one_process["max_memory_allocated"])
        ok = ok and ok_r
        out[role] = {
            "rank": r["rank"], "ok": ok_r, "loss": r["loss"],
            "step_ms_one_rank_compute_sends_not_run": r["step_ms"],
            "peak_bytes": r["peak_bytes"],
            "launches_per_step": {k: got[k] / steps for k in MPMD_CALL},
            "counts": r["counts"],
            "launches_expected_per_step": {k: want[role][k] / steps
                                           for k in MPMD_CALL},
            "attn_shapes": r["attn_shapes"],
            "expert_shapes": r["expert_shapes"],
            "messages_per_step": r["messages_per_step"]}
    one_lane = {k: MPMD_CALL[k] * lane_calls * N for k in MPMD_CALL}
    return {"arch": "mixtral-w1", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": runs["lane"]["torch"],
            "backend": runs["lane"]["backend"], "ranks": f"{M}x{N}",
            "batch": hm.BATCH, "seq": hm.SEQ, "steps": steps, "layers": L,
            "layout": {k: lay[k] for k in ("C", "C_chunk", "offload",
                                           "attn_experts",
                                           "experts_per_lane")},
            "one_process_peak_bytes": one_process["max_memory_allocated"],
            "one_process_step_ms": one_process["step_ms"],
            "one_process_lane_launches_per_step": one_lane,
            **out, "ok": ok}


def train_sp_phase(torch, smi: str):
    """Sequence parallelism and attention split by heads, on one rank of
    a wider training mesh: the driver's zebra default on mixtral-w1 at
    full width and depth (MESH_ARGS' batch and seq, 3 steps) at ``--mesh
    1x1`` and as model rank SP_RANK of ``--mesh 1xSP_M`` on the fake
    backend (collectives launched but not run: the rank's values are not
    checked), each in a process of its own (:func:`sp_rank_worker`).
    Gates on the 1xSP_M rank: every attention call at SP_HEADS heads, every
    block's checkpoint keeping SP_KEPT in storage of that size, exactly
    the zebra launches per layer and step (all wgmma), then
    SP_FLASH_STEPS flash steps at SP_HEADS with exactly SP_FLASH_LAUNCHES
    per layer and step; its peak memory below the 1x1 run's. Reported:
    step ms (one rank's compute, collectives not run), both peaks and the
    collectives by kind."""
    from repro_torch.models import registry
    cfg = registry.get_config("mixtral-w1")
    layers, steps = cfg.n_layers, 3
    one = sp_run(torch, 1, 0)
    sp = sp_run(torch, SP_M, SP_RANK)
    check_zebra_launches("train_sp (1x1)", one["counts"], ZEBRA_LAUNCHES,
                         layers, steps)
    check_zebra_launches(f"train_sp (rank {SP_RANK} of 1x{SP_M})",
                         sp["counts"], ZEBRA_LAUNCHES, layers, steps)
    fl = sp["flash"]
    check_designs("train_sp (flash)", fl["counts"])
    want_flash = {k: n * layers * SP_FLASH_STEPS
                  for k, n in SP_FLASH_LAUNCHES.items()}
    got_flash = {k: fl["counts"].get(k, 0) for k in SP_FLASH_LAUNCHES}
    kept_bytes = math.prod(SP_KEPT) * 2
    heads_ok = bool(sp["attn"]) and all(a == SP_HEADS for a in sp["attn"])
    kept_ok = sp["kept"] == [[SP_KEPT, kept_bytes]] * (layers * steps)
    flash_ok = got_flash == want_flash and bool(fl["attn"]) and all(
        a == SP_HEADS for a in fl["attn"])
    return {"arch": cfg.name, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": sp["torch"],
            "backend": sp["backend"], "mesh": f"1x{SP_M}",
            "rank": SP_RANK, "coords": sp["coords"], "zebra": sp["zebra"],
            "batch": 8, "seq": 256,
            "attn_calls": len(sp["attn"]),
            "attn_heads": sorted({tuple(a) for a in sp["attn"]}),
            "one_rank_attn_heads": sorted({tuple(a) for a in one["attn"]}),
            "kept": sp["kept"][:1], "kept_blocks": len(sp["kept"]),
            "one_rank_kept": one["kept"][:1],
            "step_ms_one_rank_compute_collectives_not_run": sp["step_ms"],
            "ms_per_step_one_rank_compute": sp["ms_per_step"],
            "one_rank_1x1_step_ms": one["step_ms"],
            "peak_bytes": sp["peak_bytes"],
            "peak_bytes_1x1": one["peak_bytes"],
            "collectives": sp["collectives"],
            "collectives_1x1": one["collectives"],
            "launches_per_layer_step": {
                k: sp["counts"][k] / (layers * steps)
                for k in ZEBRA_LAUNCHES},
            "flash_launches": got_flash, "flash_step_ms": fl["step_ms"],
            "ok": heads_ok and kept_ok and flash_ok
            and sp["peak_bytes"] < one["peak_bytes"]}


def program_steps(torch, program, loader, params, state, n: int):
    """``n`` train steps of ``program``; (params, state, metrics per step,
    host seconds per step around work that ends in a synchronize)."""
    hist, step_s = [], []
    for _ in range(n):
        batch = next(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = program.train_step(params, state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        hist.append({k: float(v) for k, v in m.items()})
    return params, state, hist, step_s


def accum_program(torch, train_mod, accum_steps: int, zcfg=None):
    """(cfg, program, loader) of the driver's zebra W1 with
    ``make_train_program(accum_steps=)`` (the driver has no flag for it,
    as the JAX driver has none) and ``zcfg`` (default: the command
    line's)."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.step import make_train_program
    args = train_mod.build_parser().parse_args(ZEBRA_ARGS)
    cfg, program, loader = train_mod.build(args.arch, args, zcfg=zcfg)
    program = make_train_program(
        cfg, program.run, ShapeConfig("cli", "train", args.seq, args.batch),
        opt_cfg=program.opt_cfg, device=args.device,
        zcfg=zcfg or train_mod.zebra_config(args, cfg),
        accum_steps=accum_steps)
    return cfg, program, loader


def train_accum_phase(torch, train_mod, smi: str):
    """W1 at full width and depth, zebra default, batch 8 x 256 through
    ``make_train_program(accum_steps=2)``: one untimed warm-up step, then
    ACCUM_STEPS timed steps with the launch counters set to 0 just before
    and read just after (exactly twice the zebra counts per layer and
    step, all wgmma; finite losses and grad norms). Then, at capacity
    ZEBRA_EQUAL_CF (no drops), step 1 under accum_steps 2 and 1 from the
    same params: losses within ZEBRA_GAP (the aux losses are averaged
    over the slices)."""
    from repro_torch import kernels
    from repro_torch.core.zebra_spmd import ZebraConfig
    cfg, program, loader = accum_program(torch, train_mod, 2)
    params = program.init_params(seed=0)
    state = program.init_opt(params)
    params, state, warm, _ = program_steps(torch, program, loader, params,
                                           state, 1)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    params, state, hist, step_s = program_steps(torch, program, loader,
                                                params, state, ACCUM_STEPS)
    counts = driver_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    del params, state, program
    gc.collect()
    torch.cuda.empty_cache()
    check_zebra_launches("train_accum", counts,
                         {k: 2 * n for k, n in ZEBRA_LAUNCHES.items()},
                         cfg.n_layers, ACCUM_STEPS)
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in warm + hist)
    step1 = {}
    for accum in (2, 1):
        zcfg = ZebraConfig(mode="replicated", num_microbatches=2,
                           capacity_factor=ZEBRA_EQUAL_CF)
        _, prog, ld = accum_program(torch, train_mod, accum, zcfg)
        p = prog.init_params(seed=0)
        _, _, h, _ = program_steps(torch, prog, ld, p, prog.init_opt(p), 1)
        step1[accum] = h[0]
        del p, prog
        gc.collect()
        torch.cuda.empty_cache()
    gap = abs(step1[2]["loss"] - step1[1]["loss"])
    ms = sorted(step_s)[len(step_s) // 2] * 1e3
    args = train_mod.build_parser().parse_args(ZEBRA_ARGS)
    return {"arch": cfg.name, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "accum_steps": 2, "batch": args.batch,
            "seq": args.seq, "steps": ACCUM_STEPS, "ms_per_step": ms,
            "tokens_per_s": args.batch * args.seq / (ms / 1e3),
            "step_ms": [t * 1e3 for t in step_s],
            "loss": [m["loss"] for m in hist],
            "grad_norm": [m["grad_norm"] for m in hist],
            "max_memory_allocated": peak,
            "launches_per_layer_step": {
                k: counts[k] / (cfg.n_layers * ACCUM_STEPS)
                for k in ZEBRA_LAUNCHES},
            "design_launches": {k: v for k, v in counts.items()
                                if k.endswith((":wgmma", ":fma"))},
            "capacity_factor_equal": ZEBRA_EQUAL_CF,
            "step1_loss_accum2": step1[2]["loss"],
            "step1_loss_accum1": step1[1]["loss"],
            "step1_loss_abs_gap": gap, "tol": ZEBRA_GAP,
            "ok": finite and gap <= ZEBRA_GAP}, counts


def remat_dots_phase(torch, train_mod, smi: str):
    """One W1 step (zebra default, batch 8 x 256) under remat="dots"
    against one under remat="full" from the same params (seed 0) and
    batch: loss, grad norm and every updated param and moment bitwise
    equal (the "full" state is held on the host meanwhile). Each program's
    gradient phase is timed (median of 3 after an untimed one) and its
    step's peak memory read; the dots run's launches are counted."""
    from repro_torch import kernels
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.pytree import flatten
    args = train_mod.build_parser().parse_args(ZEBRA_ARGS)
    out, host = {}, None
    for remat in ("full", "dots"):
        run = RunConfig(policy=Policy(), attn_impl="chunked",
                        moe_impl="gather", remat=remat)
        cfg, program, loader = train_mod.build(args.arch, args, run)
        params = program.init_params(seed=0)
        state = program.init_opt(params)
        batch = next(loader)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, m = program.grad_fn(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del g, m
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if remat == "dots":
            kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = program.train_step(params, state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        out[remat] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "step_ms": step_ms,
                      "grad_ms": sorted(times[1:])[1] * 1e3,
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}
        leaves = flatten({"params": params, "opt": state})
        if remat == "full":
            host = {k: v.cpu() for k, v in leaves.items()}
        else:
            counts = driver_counts(kernels)
            differ = [k for k, v in leaves.items()
                      if not torch.equal(v.cpu(), host[k])]
        del params, state, m, leaves, program
        gc.collect()
        torch.cuda.empty_cache()
    check_zebra_launches("remat_dots", counts, ZEBRA_LAUNCHES,
                         cfg.n_layers, 1)
    same = all(out["dots"][k] == out["full"][k]
               for k in ("loss", "grad_norm"))
    return {"arch": cfg.name, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "batch": args.batch, "seq": args.seq,
            "zebra": "replicated", "full": out["full"], "dots": out["dots"],
            "leaves": len(host), "leaves_differing": differ,
            "bitwise_metrics": same, "ok": same and not differ}, counts


def compress_phase(torch, smi: str):
    """``compress_tree`` / ``decompress`` with error feedback on the W1
    step-1 gradient tree (zebra default, batch 8 x 256, seed 0), on the
    card and on its CPU copy, two rounds (zero error state, then the first
    round's residual): every int8 tensor, scale and residual bitwise
    equal; ``compressed_psum`` without a process group returns the
    dequantized tree. Reports the wire bytes (int8 + scales) against the
    f32 bytes and the card's ms per round."""
    from repro_torch.launch import train as train_mod
    from repro_torch.pytree import flatten
    from repro_torch.train import compression as comp
    args = train_mod.build_parser().parse_args(ZEBRA_ARGS)
    _, program, loader = train_mod.build(args.arch, args)
    params = program.init_params(seed=0)
    grads, _ = program.grad_fn(params, next(loader))
    del params, program
    gc.collect()
    torch.cuda.empty_cache()
    host = {k: v.cpu() for k, v in grads.items()}
    ok, worst, ms = True, [], []
    err_dev = comp.init_error_state(grads)
    err_cpu = comp.init_error_state(host)
    wire = f32 = 0
    for rnd in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_dev, s_dev, fn_dev = comp.compress_tree(grads, err_dev)
        hat_dev = {k: comp.decompress(q, s_dev[k]) for k, q in q_dev.items()}
        new_dev = fn_dev(hat_dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        q_cpu, s_cpu, fn_cpu = comp.compress_tree(host, err_cpu)
        new_cpu = fn_cpu({k: comp.decompress(q, s_cpu[k])
                          for k, q in q_cpu.items()})
        for k in q_cpu:
            same = (torch.equal(q_dev[k].cpu(), q_cpu[k])
                    and torch.equal(s_dev[k].cpu(), s_cpu[k])
                    and torch.equal(new_dev[k].cpu(), new_cpu[k]))
            if not same:
                ok = False
                worst.append(f"round {rnd}: {k}")
        del hat_dev, fn_dev, q_cpu, s_cpu, fn_cpu
        gc.collect()
        if rnd == 0:
            wire = sum(q.numel() + 4 for q in q_dev.values())
            f32 = sum(4 * g.numel() for g in grads.values())
            mean, _ = comp.compressed_psum(grads, err_dev)
            psum_ok = all(torch.equal(mean[k],
                                      comp.decompress(q_dev[k], s_dev[k]))
                          for k in mean)
            del mean
        err_dev, err_cpu = new_dev, new_cpu
        del q_dev, s_dev, new_dev, new_cpu
        gc.collect()
        torch.cuda.empty_cache()
    n = len(host)
    del grads, host, err_dev, err_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": "mixtral-w1", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "tensors": n, "rounds": 2,
            "wire_bytes": wire, "f32_bytes": f32,
            "wire_ratio": wire / f32, "card_ms_per_round": ms,
            "bitwise_vs_cpu": ok, "differing": worst[:8],
            "psum_one_rank_is_dequantized": psum_ok,
            "ok": ok and psum_ok}


def train_trace_phase(torch, train_mod, smi: str, zebra_line: dict):
    """The driver with ``--trace-out build/train_trace.json`` on W1 zebra
    for 3 steps (the launch counters set to 0 just before and read just
    after): ``ok``, the ``[train] zebra-sim:`` and ``[train] idle:`` lines,
    more than 0 events, and losses and grad norms bitwise those of the
    same steps without tracing (the train_zebra run's first 3 steps: the
    same params, batches and, inside the warmup, learning rates)."""
    import contextlib

    from repro_torch import kernels
    path = ROOT / "build" / "train_trace.json"
    args = train_mod.build_parser().parse_args(
        ZEBRA_ARGS + ["--steps", "3", "--trace-out", str(path)])
    tee = _Tee(sys.stdout)
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(tee):
        summary = train_mod.train_arch(args.arch, args)
    torch.cuda.synchronize()
    counts = driver_counts(kernels)
    text = "".join(tee.lines)
    check_zebra_launches("train_trace", counts, ZEBRA_LAUNCHES, 4, 3)
    got = {"loss": [m["loss"] for m in summary["history"]],
           "grad_norm": [m["grad_norm"] for m in summary["history"]]}
    want = {k: zebra_line[k][:3] for k in ("loss", "grad_norm")}
    sim = [ln for ln in text.splitlines() if ln.startswith(
        "[train] zebra-sim:")]
    idle = [ln for ln in text.splitlines() if ln.startswith("[train] idle:")]
    events = (summary["trace"] or {}).get("events", 0)
    return {"arch": summary["arch"], "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "steps": 3, "trace": str(path),
            "events": events, "zebra_sim": sim, "idle": idle,
            "loss": got["loss"], "grad_norm": got["grad_norm"],
            "bitwise_vs_untraced": got == want,
            "ms_per_step": summary["ms_per_step"],
            "ok": (summary["ok"] and events > 0 and len(sim) == 1
                   and bool(idle) and got == want)}, counts


# -- the serving deployments: prefix cache, disaggregation, tracing ----------

def serve_run(torch, serve_mod, argv, *, params, trace=None, run=None,
              hook=None, tracer=None, arch="mixtral-w2", mesh=None,
              **extra):
    """One serve-driver run of ``argv`` on ``arch`` (default W2; through
    ``serve_arch``, at the arch's full depth) on the given params, the
    launch counters set to 0 just before and read just after.
    ``hook(engine)`` runs on the built deployment; ``tracer`` (an
    ``obs.trace.Tracer``) is installed around the run; ``mesh``: the rank
    of the serving mesh it runs on; ``extra``: ``serve_arch``'s ``fronts``
    and ``cfg``. Returns (summary, counts, engine, printed text)."""
    import contextlib

    from repro_torch import kernels
    from repro_torch.obs import trace as obs_trace
    args = serve_mod.build_parser().parse_args(argv)
    box = {}

    def keep(engine):
        box["engine"] = engine
        if hook is not None:
            hook(engine)
    tee = _Tee(sys.stdout)
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(tee), (
            obs_trace.use(tracer) if tracer is not None
            else contextlib.nullcontext()):
        s = serve_mod.serve_arch(arch, args, trace=trace, params=params,
                                 run=run, engine_hook=keep, mesh=mesh,
                                 **extra)
    torch.cuda.synchronize()
    return s, driver_counts(kernels), box["engine"], "".join(tee.lines)


def serve_numbers(s: dict, counts: dict) -> dict:
    """The numbers a serve line reports for one run."""
    from repro_torch import kernels
    return {"ok": s["ok"], "requests": s["n_requests"],
            "tokens": s["n_generated_tokens"],
            "tokens_per_s": s["tokens_per_s"],
            "ttft_p50_s": s["ttft_s"]["p50"], "itl_p50_s": s["itl_s"]["p50"],
            "launches": {k: counts[k] for k in SERVE_KERNELS},
            "design_launches": {k: counts[k]
                                for k in kernels.design_launch_counts()}}


def check_serve_launches(label: str, counts: dict):
    """Each serve kernel launched, every GLU and gmm on the tensor-core
    design (the paged decode kernel has one design, ``split``)."""
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"{label}: kernels never launched: {missing}")
    check_designs(label, counts)


def prefix_trace(serve_mod, cfg, argv):
    """The driver's multi-tenant trace of ``argv`` plus one exact repeat of
    request 0's prompt, REPEAT_AFTER ticks after the last arrival."""
    from repro_torch.serve import Request, ServeConfig
    args = serve_mod.build_parser().parse_args(argv)
    trace = serve_mod.build_tenant_trace(args, cfg.vocab_size,
                                         ServeConfig.from_args(args).sampling)
    r0 = trace[0]
    trace.append(Request(
        rid=len(trace), prompt=list(r0.prompt),
        max_new_tokens=r0.max_new_tokens, sampling=r0.sampling,
        arrival=max(r.arrival for r in trace) + REPEAT_AFTER,
        tenant=r0.tenant))
    return trace


def first_logits_vs_forward(torch, params, cfg, run, engine, rids, trace):
    """Each request's recorded first-token logits against the cache-free
    forward on its prompt: (worst max|diff| / max|logit|, per rid)."""
    from repro_torch.models import stack
    by_rid = {r.rid: r for r in trace}
    out = {}
    for rid in rids:
        got = torch.from_numpy(engine.logits[rid][0]).cuda()
        with torch.inference_mode():
            ref, _, _ = stack.apply_model(
                params, cfg, run, torch.tensor([by_rid[rid].prompt],
                                               dtype=torch.int64,
                                               device="cuda"))
        ref = ref[0, -1].float()
        out[rid] = float((got - ref).abs().max()) / float(ref.abs().max())
    return max(out.values()), out


def serve_prefix_phase(torch, serve_mod, params, smi: str):
    """``--prefix-cache --fair --tenants 2`` on W2 with the repeat (the
    main-path run, counted), the same trace without the cache, and the
    cached run under the f32 policy against the cache-free forward."""
    from repro_torch.models import registry
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.obs import trace as obs_trace
    cfg = registry.get_config("mixtral-w2")
    trace = prefix_trace(serve_mod, cfg, PREFIX_ARGS)
    repeat = trace[-1]
    s, counts, eng, _ = serve_run(torch, serve_mod, PREFIX_ARGS,
                                  params=params, trace=trace)
    check_serve_launches("serve_prefix", counts)
    r0_finish = eng.metrics.requests[0].finish_tick
    index, alloc = eng.sched.prefix_index, eng.sched.allocator
    index.check()
    alloc.check()
    flushed = index.flush()
    alloc.check()
    empty = alloc.pages_in_use == 0
    cached = dict(eng.results)
    del eng, index, alloc
    s_off, off_counts, e_off, _ = serve_run(
        torch, serve_mod, [a for a in PREFIX_ARGS if a != "--prefix-cache"],
        params=params, trace=trace)
    check_serve_launches("serve_prefix (uncached)", off_counts)
    uncached = dict(e_off.results)
    del e_off
    same = sum(a == b for r in trace
               for a, b in zip(cached[r.rid], uncached[r.rid]))
    total = sum(len(cached[r.rid]) for r in trace)
    # f32: the first-token logits of every prefix hit and of the repeat
    run32 = RunConfig(policy=Policy(compute_dtype=torch.float32))
    tracer = obs_trace.Tracer()
    s32, _, e32, _ = serve_run(
        torch, serve_mod, PREFIX_ARGS, params=params, trace=trace,
        run=run32, tracer=tracer,
        hook=lambda e: setattr(e, "record_logits", True))
    hits = sorted({ev.args["rid"] for ev in tracer.events
                   if ev.name == "prefix-skip"})
    worst, per_rid = first_logits_vs_forward(
        torch, params, cfg, run32, e32, sorted(set(hits) | {repeat.rid}),
        trace)
    forks32 = e32.sched.allocator.n_cow_forks
    del e32
    pre = s["prefix"]
    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "requests": len(trace),
            "shared_prefix": 192, "repeat_rid": repeat.rid,
            "repeat_arrival": repeat.arrival, "r0_finish_tick": r0_finish,
            "cached": serve_numbers(s, counts), "prefix": pre,
            "uncached": serve_numbers(s_off, off_counts),
            "flushed_pages": flushed, "pool_empty_after_flush": empty,
            "greedy_equal_share": same / total,
            "f32": {"ok": s32["ok"], "hit_rids": hits,
                    "n_cow_forks": forks32, "worst_rel": worst,
                    "rel_by_rid": per_rid, "limit_rel": PARITY_REL}}
    line["ok"] = bool(
        s["ok"] and s_off["ok"] and s32["ok"]
        and pre["admissions_hit"] >= 1 and pre["tokens_skipped"] >= 192
        and pre["n_cow_forks"] >= 1 and r0_finish < repeat.arrival
        and empty and repeat.rid in hits and worst <= PARITY_REL)
    return line, counts


def checked_every_tick(ctl) -> None:
    """Run both allocators' (and the decode index's) ``check()`` after
    every tick of a disagg controller."""
    tick = ctl.tick

    def checked():
        tick()
        ctl.prefill.allocator.check()
        ctl.decode.allocator.check()
        if ctl.decode.sched.prefix_index is not None:
            ctl.decode.sched.prefix_index.check()
    ctl.tick = checked


def serve_disagg_phase(torch, serve_mod, params, smi: str):
    """``--disagg --pool-pages 34`` on the serve trace (the main-path run,
    counted; allocators checked every tick, the transfer's phases timed),
    beside the unified engine on the same trace. Returns the line, the
    counts and the unified run's tokens (serve_trace's untraced
    reference)."""
    def disagg_hook(ctl):
        checked_every_tick(ctl)
        ctl.transfer.phase_s = {}
        ctl.decode.record_logits = True
    s, counts, ctl, _ = serve_run(torch, serve_mod, DISAGG_ARGS,
                                  params=params, hook=disagg_hook)
    check_serve_launches("serve_disagg", counts)
    st = ctl.transfer.stats
    d = s["disagg"]
    phase = {k: sum(v) * 1e3 / st.n_chunks
             for k, v in ctl.transfer.phase_s.items()}
    shapes = {tuple(x) for x in st.shipped_shapes}
    clean = (ctl.prefill.allocator.pages_in_use == 0
             and ctl.decode.allocator.pages_in_use == 0)
    d_logits, d_results = ctl.logits, dict(ctl.results)
    del ctl
    s_u, u_counts, eng, _ = serve_run(
        torch, serve_mod, SERVE_ARGS, params=params,
        hook=lambda e: setattr(e, "record_logits", True))
    check_serve_launches("serve_disagg (unified)", u_counts)
    rel, bitwise = {}, True
    for rid, rows in eng.logits.items():
        a, b = d_logits[rid][0], rows[0]
        rel[rid] = float(abs(a - b).max()) / float(abs(b).max())
        bitwise = bitwise and bool((a == b).all())
    unified = dict(eng.results)
    del eng
    same = sum(x == y for rid in unified
               for x, y in zip(unified[rid], d_results[rid]))
    total = sum(len(v) for v in unified.values())
    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "disagg": serve_numbers(s, counts),
            "unified": serve_numbers(s_u, u_counts), "sections": d,
            "transfer": {"chunks": st.n_chunks, "pages": st.n_pages,
                         "bytes": st.bytes,
                         "page_bytes": st.bytes // max(st.n_pages, 1),
                         "ms_per_chunk": phase,
                         "shipped_shapes": sorted(shapes)},
            "allocators_clean": clean, "first_logits_rel": rel,
            "first_logits_worst_rel": max(rel.values()),
            "first_logits_bitwise": bitwise,
            "greedy_equal_share": same / total}
    line["ok"] = bool(
        s["ok"] and s_u["ok"] and clean and d["n_preempted"] >= 1
        and d["kv_transfers"] == s["n_requests"] + d["n_preempted"]
        and shapes == DISAGG_SHAPES
        and max(rel.values()) <= PARITY_REL)
    return line, counts, unified


def serve_disagg_prefix_phase(torch, serve_mod, params, smi: str):
    """``--disagg --prefix-cache --fair --tenants 2`` on the serve_prefix
    trace with its repeat (the main-path run, counted), every tick
    checked."""
    from repro_torch.models import registry
    trace = prefix_trace(serve_mod, registry.get_config("mixtral-w2"),
                         DISAGG_PREFIX_ARGS)
    s, counts, ctl, _ = serve_run(torch, serve_mod, DISAGG_PREFIX_ARGS,
                                  params=params, trace=trace,
                                  hook=checked_every_tick)
    check_serve_launches("serve_disagg_prefix", counts)
    d = s["disagg"]
    index = ctl.decode.sched.prefix_index
    index.check()
    ctl.prefill.allocator.check()
    ctl.decode.allocator.check()
    flushed = index.flush()
    ctl.decode.allocator.check()
    empty = ctl.decode.allocator.pages_in_use == 0 \
        and ctl.prefill.allocator.pages_in_use == 0
    del ctl, index
    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "run": serve_numbers(s, counts),
            "sections": d, "prefix": s["prefix"], "flushed_pages": flushed,
            "pools_empty_after_flush": empty}
    line["ok"] = bool(
        s["ok"] and d["prefix_full_hits"] >= 1 and empty
        and d["kv_transfers"] == s["n_requests"] - d["prefix_full_hits"]
        + d["n_preempted"])
    return line, counts


def serve_trace_phase(torch, serve_mod, params, smi: str, untraced: dict):
    """The serve trace with ``--trace-out build/serve_trace.json``, twice
    (the first run counted): ``ok``, events, the idle lines, tokens
    bitwise the untraced unified run's, one tick-clock signature."""
    from repro_torch.obs import trace as obs_trace
    path = ROOT / "build" / "serve_trace.json"
    argv = SERVE_ARGS + ["--trace-out", str(path)]
    runs = []
    for _ in range(2):
        box = {}
        s, counts, eng, text = serve_run(
            torch, serve_mod, argv, params=params,
            hook=lambda e: box.update(tracer=obs_trace.TRACER))
        runs.append((s, counts, dict(eng.results), box["tracer"], text))
        del eng
    path.unlink(missing_ok=True)
    (s, counts, results, _, text), second = runs
    idle = [ln for ln in text.splitlines() if ln.startswith("[serve] idle:")]
    sigs = [r[3].signature() for r in runs]
    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "run": serve_numbers(s, counts),
            "events": s["trace"]["n_events"], "idle": idle,
            "signature": sigs[0], "signature_rerun_equal": sigs[0] == sigs[1],
            "tokens_equal_untraced": results == untraced}
    line["ok"] = bool(s["ok"] and second[0]["ok"] and line["events"] > 0
                      and idle and sigs[0] == sigs[1]
                      and results == untraced)
    return line, counts


def serve_dense_phase(torch, serve_mod, params, smi: str, paged: dict,
                      unified: dict):
    """The serve trace without ``--paged`` (dense per-slot caches, the
    driver's default; the main-path run, counted), then the paged engine
    on the same params right after it (one run a side, reported beside
    the ``serve:`` run's numbers), the dense run's greedy tokens against
    the unified paged engine's (``unified``, bf16, reported); then the
    trace under the f32 policy through the dense and the paged engines:
    first-token logits of every request within DENSE_REL * max of the
    paged engine's."""
    from repro_torch.models.modules import Policy, RunConfig
    s, counts, eng, _ = serve_run(torch, serve_mod, DENSE_ARGS,
                                  params=params)
    check_designs("serve_dense", counts)
    steps = {"prefill_chunks": eng.n_prefill_chunks,
             "decode_steps": eng.n_decode_steps}
    dense = dict(eng.results)
    del eng
    s_p, p_counts, _, _ = serve_run(torch, serve_mod, SERVE_ARGS,
                                    params=params)
    run32 = RunConfig(policy=Policy(compute_dtype=torch.float32))

    def record(e):
        e.record_logits = True
    s32, _, d32, _ = serve_run(torch, serve_mod, DENSE_ARGS, params=params,
                               run=run32, hook=record)
    d_logits, d_res = d32.logits, dict(d32.results)
    del d32
    p32, _, e32, _ = serve_run(torch, serve_mod, SERVE_ARGS, params=params,
                               run=run32, hook=record)
    rel = {rid: float(abs(d_logits[rid][0] - rows[0]).max())
           / float(abs(rows[0]).max()) for rid, rows in e32.logits.items()}
    p_res = dict(e32.results)
    del e32
    same = sum(a == b for rid in unified
               for a, b in zip(dense[rid], unified[rid]))
    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "dense": serve_numbers(s, counts),
            "dense_steps": steps, "paged_serve_run": paged,
            "paged_beside": serve_numbers(s_p, p_counts),
            "greedy_equal_share_vs_paged": same / sum(
                len(v) for v in unified.values()),
            "f32": {"ok": s32["ok"] and p32["ok"], "first_logits_rel": rel,
                    "worst_rel": max(rel.values()), "limit_rel": DENSE_REL,
                    "greedy_equal": d_res == p_res}}
    line["ok"] = bool(
        s["ok"] and s_p["ok"] and line["f32"]["ok"]
        and max(rel.values()) <= DENSE_REL
        and counts["gmm_glu"] > 0 and counts["gmm"] > 0
        and counts["paged_decode"] == 0)
    return line, counts


def fleet_checked(ctl, built=None) -> None:
    """Check every group's allocator after every tick of a fleet. With a
    list ``built``, keep a weak reference to every worker the fleet holds
    or builds (at a flip or a rejoin) in it."""
    tick = ctl.tick

    def checked():
        tick()
        for g in ctl.groups:
            g.worker.allocator.check()
    ctl.tick = checked
    if built is None:
        return
    built += [weakref.ref(g.worker) for g in ctl.groups]

    def tracked(make):
        def build(*args):
            worker = make(*args)
            built.append(weakref.ref(worker))
            return worker
        return build
    ctl._make_prefill = tracked(ctl._make_prefill)
    ctl._make_decode = tracked(ctl._make_decode)


def tree_bytes(tree, dtype=None) -> int:
    """Bytes of the tensors (of ``dtype``, if given) in a nested dict /
    list tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v, dtype) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v, dtype) for v in tree)
    if tree is None or (dtype is not None and tree.dtype != dtype):
        return 0
    return tree.numel() * tree.element_size()


def first_divergence(torch, params, cfg, run, trace, got: dict,
                     want: dict):
    """The first token where ``got`` differs from ``want`` (request order
    of the trace), with the cache-free forward's top-2 logit margin at
    that position (relative to max|logit|); None when all are equal."""
    from repro_torch.models import stack
    device = params["embed"]["table"].device
    for r in trace:
        a, b = got[r.rid], want[r.rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        with torch.inference_mode():
            logits, _, _ = stack.apply_model(
                params, cfg, run, torch.tensor([r.prompt + b[:j]],
                                               dtype=torch.int64,
                                               device=device))
        last = logits[0, -1].float()
        top = last.topk(2).values
        margin = float(top[0] - top[1])
        return {"rid": r.rid, "pos": j, "fleet": a[j], "unified": b[j],
                "margin": margin,
                "margin_rel": margin / float(last.abs().max())}
    return None


def serve_fleet_phase(torch, serve_mod, params, smi: str, unified: dict):
    """The fleet on the serve trace (FLEET_ARGS; the main-path run,
    counted): every allocator checked every tick, every request finished,
    zero pages in use after the drain, every worker the fleet dropped (a
    killed group's, a flipped group's old role's, a rejoined zombie's)
    freed with its pool by the run's end, device memory before, after the
    run (with the compute-dtype params, the live groups' pools and the
    caching allocator's rounding of their blocks, the residual) and after
    release; then the trace under the f32 policy through the fleet and the
    unified paged engine: greedy tokens equal, or the first divergence a
    near-tie (top-2 margin within F32_TIER * max|logit|)."""
    from repro_torch.models import registry, stack
    from repro_torch.models.modules import Policy, RunConfig
    cfg = registry.get_config("mixtral-w2")
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    built = []
    s, counts, ctl, _ = serve_run(
        torch, serve_mod, FLEET_ARGS, params=params,
        hook=lambda c: fleet_checked(c, built))
    check_serve_launches("serve_fleet", counts)
    gc.collect()
    mem_run = torch.cuda.memory_allocated()
    workers = [g.worker for g in ctl.groups + ctl.zombies]
    dropped_alive = sum(1 for ref in built if ref() is not None
                        and all(ref() is not w for w in workers))
    pools = sum(tree_bytes(w.state) for w in workers)
    # the compute-dtype copies (the f32 leaves are the caller's params)
    compute = tree_bytes(workers[0].params, torch.bfloat16)
    empty = all(g.worker.allocator.pages_in_use == 0 for g in ctl.groups)
    events = [(e.tick, e.kind, e.gid, e.detail) for e in ctl.events]
    recovered = sum(int(e.detail.split()[0]) for e in ctl.events
                    if e.kind == "recover")
    robust = ctl.metrics.robust.as_dict()
    st = ctl.transfer.stats
    pool_bytes = {g.name: tree_bytes(g.worker.state) for g in ctl.groups}
    bf16 = dict(ctl.results)
    del ctl, workers
    gc.collect()
    mem_end = torch.cuda.memory_allocated()
    run32 = RunConfig(policy=Policy(compute_dtype=torch.float32))
    s32, _, c32, _ = serve_run(torch, serve_mod, FLEET_ARGS, params=params,
                               run=run32, hook=fleet_checked)
    f32_fleet = dict(c32.results)
    f32_events = [(e.tick, e.kind, e.gid, e.detail) for e in c32.events]
    del c32
    u32, _, e32, _ = serve_run(torch, serve_mod, SERVE_ARGS, params=params,
                               run=run32)
    f32_unified = dict(e32.results)
    del e32
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    from repro_torch.serve import GREEDY
    trace = serve_mod.build_trace(args.seed, args.requests, args.rate,
                                  args.prompt_len, args.gen, cfg.vocab_size,
                                  GREEDY)
    div = first_divergence(torch, params, cfg, run32, trace, f32_fleet,
                           f32_unified)
    same = sum(a == b for rid in unified
               for a, b in zip(bf16[rid], unified[rid]))
    kinds = [e[1] for e in events]
    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "run": serve_numbers(s, counts),
            "fleet": {k: s["fleet"][k] for k in ("ticks", "groups",
                                                 "n_flips", "n_killed",
                                                 "kv_transfers",
                                                 "kv_pages_shipped")},
            "events": events, "flips": kinds.count("flip"),
            "deaths": kinds.count("dead"), "rejoins": kinds.count("rejoin"),
            "re_prefills": recovered + robust["transfer_aborts"],
            "fenced_completions": robust["fenced_stale_completions"],
            "shed": s["chaos"]["n_shed"], "transfers": st.n_transfers,
            "chaos": {k: s["chaos"][k] for k in ("spec", "seed", "events",
                                                 "signature", "counters",
                                                 "leaked_groups")},
            "pages_in_use_after_drain": 0 if empty else "nonzero",
            "pool_bytes": pool_bytes,
            "workers_built": len(built),
            "dropped_workers_alive": dropped_alive,
            "memory_allocated": {"before": mem0, "after_run": mem_run,
                                 "after_release": mem_end,
                                 "compute_params": compute,
                                 "live_pools": pools,
                                 "residual": mem_run - mem0 - compute
                                 - pools},
            "greedy_equal_share_vs_unified_bf16": same / sum(
                len(v) for v in unified.values()),
            "f32": {"ok": s32["ok"] and u32["ok"], "events": f32_events,
                    "greedy_equal": f32_fleet == f32_unified,
                    "first_divergence": div, "limit_rel": F32_TIER}}
    line["ok"] = bool(
        s["ok"] and empty and line["f32"]["ok"] and not
        s["chaos"]["leaked_groups"] and line["flips"] >= 1
        and line["deaths"] >= 1 and dropped_alive == 0
        and len(built) > len(pool_bytes) and mem_end <= mem0
        and (div is None or div["margin_rel"] <= F32_TIER))
    return line, counts


def glu_block_m_recorder():
    """(install, remove, histogram): while installed, every fused GLU call
    of the grouped-GEMM wrapper is tallied by its block_m in the
    histogram {block_m: calls}; the wrapper itself (and its launch
    count) is untouched."""
    from repro_torch.kernels import gmm
    real = gmm.gmm_glu_tiled_pair
    hist: dict = {}

    def recording(lhs, rhs_gate, rhs_up, tile_group, *, block_m=128):
        hist[block_m] = hist.get(block_m, 0) + 1
        return real(lhs, rhs_gate, rhs_up, tile_group, block_m=block_m)

    def install():
        gmm.gmm_glu_tiled_pair = recording

    def remove():
        gmm.gmm_glu_tiled_pair = real
    return install, remove, hist


def ep_numbers(s: dict, counts: dict, eng=None) -> dict:
    """A serve line's numbers for an EP run, with its ``ep`` section and,
    for a unified engine, its step counts."""
    out = {**serve_numbers(s, counts), "ep": s.get("ep")}
    if eng is not None and hasattr(eng, "n_decode_steps"):
        out["prefill_chunks"] = eng.n_prefill_chunks
        out["decode_steps"] = eng.n_decode_steps
    return out


def serve_ep_phase(torch, serve_mod, params, smi: str):
    """Expert-parallel decode at one EP rank through the serve driver on
    the serve trace (every MoE FFN through the EP hop: pack in placement
    slot order, two all-to-all chunks, the grouped kernels on the rank's
    24 experts, combine; every collective the identity at one rank):

    (a) ``--paged --ep-size 1 --ep-placement planned`` in bf16 (the
        main-path run, counted; the GLU's block_m tallied per call):
        every request finishes, GLU and ``gmm`` launched 2 (chunks) x 4
        (layers) per prefill chunk and decode step, paged decode 4 per
        decode step, all GLU and ``gmm`` launches on the tensor-core
        design, the decode steps' GLU calls at block_m 8;
    (b) the same in f32 beside the unified ``--paged`` engine without EP
        in f32: first-token logits within PARITY_REL * max of the
        replicated engine's; greedy tokens equal, or the first divergence
        a near-tie (top-2 margin within F32_TIER * max|logit|);
    (c) f32, uniform placement, ``engine.rebalance`` to the reversed slot
        order after tick EP_REBALANCE_TICK (slots live, pages allocated):
        one re-balance, every token bitwise (b)'s EP run's, the allocator
        clean at every tick and empty after the run;
    (d) dense (no ``--paged``) in bf16: every request finishes, no paged
        decode launch;
    (e) ``--disagg --ep-size 1`` (34-page decode pool) in bf16: every
        request finishes, the decode worker's EMA updated.

    Returns (line, counts of (a), of (d), of (e))."""
    from repro_torch.models import registry
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.serve import GREEDY
    from repro_torch.serve import ep_decode as epd
    cfg = registry.get_config("mixtral-w2")
    L = cfg.n_layers
    install, remove, glu_bm = glu_block_m_recorder()
    install()
    try:
        s, counts, eng, _ = serve_run(torch, serve_mod, EP_ARGS,
                                      params=params)
    finally:
        remove()
    check_serve_launches("serve_ep", counts)
    a = ep_numbers(s, counts, eng)
    a["glu_block_m_calls"] = {str(k): v for k, v in sorted(glu_bm.items())}
    hops = EP_CHUNKS * L * (eng.n_prefill_chunks + eng.n_decode_steps)
    a_ok = bool(s["ok"] and counts["gmm_glu"] == counts["gmm"] == hops
                and counts["paged_decode"] == L * eng.n_decode_steps
                and glu_bm.get(8, 0) >= EP_CHUNKS * L * eng.n_decode_steps
                and s["ep"]["ema_updates"] == eng.n_decode_steps)
    a["placement"] = [list(p) for p in eng.placement]
    del eng
    gc.collect()

    run32 = RunConfig(policy=Policy(compute_dtype=torch.float32))

    def record(e):
        e.record_logits = True
    s32, b_counts, e32, _ = serve_run(torch, serve_mod, EP_ARGS,
                                      params=params, run=run32, hook=record)
    ep_logits, ep_tokens = e32.logits, dict(e32.results)
    b_rebalances = e32.n_rebalances
    del e32
    gc.collect()
    u32, u_counts, r32, _ = serve_run(torch, serve_mod, SERVE_ARGS,
                                      params=params, run=run32, hook=record)
    rel = {rid: float(abs(ep_logits[rid][0] - rows[0]).max())
           / float(abs(rows[0]).max()) for rid, rows in r32.logits.items()}
    rep_tokens = dict(r32.results)
    del r32
    gc.collect()
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    trace = serve_mod.build_trace(args.seed, args.requests, args.rate,
                                  args.prompt_len, args.gen, cfg.vocab_size,
                                  GREEDY)
    div = first_divergence(torch, params, cfg, run32, trace, ep_tokens,
                           rep_tokens)
    b = {"ok": s32["ok"] and u32["ok"], "ep": ep_numbers(s32, b_counts),
         "replicated": ep_numbers(u32, u_counts), "first_logits_rel": rel,
         "worst_rel": max(rel.values()), "limit_rel": PARITY_REL,
         "greedy_equal": ep_tokens == rep_tokens, "first_divergence": div,
         "limit_margin_rel": F32_TIER, "n_rebalances": b_rebalances}
    for k in ("ep", "replicated"):
        b[k].pop("design_launches")
    b_ok = bool(b["ok"] and b["worst_rel"] <= PARITY_REL
                and (div is None or div["margin_rel"] <= F32_TIER))

    moved = {}

    def rebalancing(e):
        checked_every_tick_unified(e)
        tick = e.tick

        def ticked():
            tick()
            if e.tick_count == EP_REBALANCE_TICK:
                moved["live"] = int(e._active.sum())
                moved["pages"] = e.sched.allocator.pages_in_use
                moved["done"] = e.rebalance(
                    tuple(tuple(reversed(p)) for p in e.placement))
        e.tick = ticked
    c32, c_counts, c_eng, _ = serve_run(torch, serve_mod, EP_UNIFORM_ARGS,
                                        params=params, run=run32,
                                        hook=rebalancing)
    c_tokens = dict(c_eng.results)
    c = {"ok": c32["ok"], "run": ep_numbers(c32, c_counts),
         "n_rebalances": c_eng.n_rebalances, "at_tick": EP_REBALANCE_TICK,
         "at_rebalance": moved,
         "placement": [list(p) for p in c_eng.placement],
         "tokens_bitwise_b": c_tokens == ep_tokens,
         "pages_in_use_after": c_eng.sched.allocator.pages_in_use}
    c["run"].pop("design_launches")
    c_ok = bool(c["ok"] and c["n_rebalances"] == 1 and moved.get("done")
                and moved.get("live", 0) > 0 and c["tokens_bitwise_b"]
                and c["pages_in_use_after"] == 0)
    del c_eng
    gc.collect()

    s_d, d_counts, d_eng, _ = serve_run(torch, serve_mod, EP_DENSE_ARGS,
                                        params=params)
    check_designs("serve_ep dense", d_counts)
    d = ep_numbers(s_d, d_counts, d_eng)
    d_ok = bool(s_d["ok"] and d_counts["paged_decode"] == 0
                and d_counts["gmm_glu"] > 0 and d_counts["gmm"] > 0)
    del d_eng
    gc.collect()

    s_e, e_counts, ctl, _ = serve_run(torch, serve_mod, EP_DISAGG_ARGS,
                                      params=params, hook=checked_every_tick)
    check_serve_launches("serve_ep disagg", e_counts)
    e = ep_numbers(s_e, e_counts)
    e["disagg"] = s_e["disagg"]
    e_ok = bool(s_e["ok"] and ctl.decode.routing_ema.n_updates > 0
                and ctl.prefill.p.ep is not None)
    del ctl
    gc.collect()

    budget = epd.ep_hbm_budget(
        cfg, hbm_bytes=torch.cuda.get_device_properties(0).total_memory,
        ep_size=1, page_size=16)
    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "a_paged_planned_bf16": a,
            "b_f32_vs_replicated": b, "c_f32_rebalance": c,
            "d_dense_bf16": d, "e_disagg_bf16": e,
            "ep_hbm_budget": budget,
            "expert_bytes_per_device": budget["expert_bytes_per_device"],
            "gates": {"a": a_ok, "b": b_ok, "c": c_ok, "d": d_ok,
                      "e": e_ok}}
    line["ok"] = a_ok and b_ok and c_ok and d_ok and e_ok
    return line, counts, d_counts, e_counts


# -- the recurrent archs: RG-LRU and SSD mixers (ROADMAP A8) ----------------

def bracketed_runs(torch, serve_mod, argv, outputs, *, params,
                   trace=None, **kw) -> list:
    """``argv`` served four times in the order one device, ``--mesh 1x1``,
    ``--mesh 1x1``, one device (:func:`serve_run`; the mesh runs through
    ``launch_ranks`` at world 1, NCCL, the collective counters set to 0
    just before each and read just after), each with a fresh ``trace()``
    where given. ``outputs(engine, summary)`` takes what a run is held
    on. Returns
    one dict a run: its build, summary, launch counts, collectives and
    outputs."""
    from repro_torch.launch.mesh import launch_ranks, make_mesh
    from repro_torch.sharding import collectives as C
    runs = []

    def one(build, mesh=None):
        C.reset_counts()
        s, counts, eng, _ = serve_run(
            torch, serve_mod, argv, params=params, mesh=mesh,
            trace=trace() if trace is not None else None, **kw)
        runs.append({"build": build, "s": s, "counts": counts,
                     "collectives": dict(C.COUNTS), "out": outputs(eng, s)})
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    def rank0(rank):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        one("mesh", mesh)
        one("mesh", mesh)

    one("one_device")
    launch_ranks(rank0, 1, "cuda")
    one("one_device")
    return runs


def run_numbers(s: dict) -> dict:
    """tok/s, TTFT and ITL p50 of one serve run's summary (the lockstep
    server reports its prefill and each decode step)."""
    if s.get("lockstep"):
        itl = sorted(s["itl_s"])
        return {"tokens_per_s": s["tokens_per_s"], "ttft_s": s["ttft_s"],
                "itl_p50_s": itl[len(itl) // 2]}
    return {"requests": s["n_requests"], "tokens": s["n_generated_tokens"],
            "tokens_per_s": s["tokens_per_s"],
            "ttft_p50_s": s["ttft_s"]["p50"], "itl_p50_s": s["itl_s"]["p50"]}


def bracket_line(runs, same, launch_keys) -> dict:
    """The numbers and gate of :func:`bracketed_runs`: every run ok and
    ``same`` as the first, no collective, the launches of ``launch_keys``
    equal the first run's."""
    launches = [{k: r["counts"][k] for k in launch_keys} for r in runs]
    line = {"order": [r["build"] for r in runs],
            "bitwise": all(same(r["out"], runs[0]["out"]) for r in runs),
            "collectives": [r["collectives"] for r in runs],
            "launches": launches,
            "runs": [run_numbers(r["s"]) for r in runs]}
    line["ok"] = bool(all(r["s"]["ok"] for r in runs) and line["bitwise"]
                      and not any(line["collectives"])
                      and all(c == launches[0] for c in launches))
    return line


def serve_mesh_phase(torch, serve_mod, params, smi: str):
    """The serving mesh at ``--mesh 1x1`` (world 1): the serve trace on W2
    at full width and depth, dense and ``--paged``, through
    :func:`bracketed_runs` (one device, mesh, mesh, one device; the mesh
    program of ``serve.mesh`` on its one NCCL rank). Gate: every request
    finishes; tokens and every recorded f32 logit row (the engine's,
    prefill and decode) of every run bitwise the first one-device run's;
    no collective; each run's launches equal the first's, each serve
    kernel launched (paged decode only paged). Reported: ITL p50 and tok/s
    of each run (host clock, this card). Returns (line, {mode: launch
    counts of the first mesh run})."""
    import numpy as np

    def record(engine):
        engine.record_logits = True

    def outputs(eng, _s):
        return ({int(k): list(v) for k, v in eng.results.items()},
                {int(k): np.stack(v) for k, v in eng.logits.items()})

    def same(a, b):
        return a[0] == b[0] and a[1].keys() == b[1].keys() \
            and all(np.array_equal(a[1][r], b[1][r]) for r in b[1])

    line = {"arch": "mixtral-w2", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "mesh": "1x1", "modes": {}}
    counts_by, ok = {}, True
    for mode in MESH_SERVE:
        argv = SERVE_ARGS if mode == "paged" else UNPAGED_ARGS
        runs = bracketed_runs(torch, serve_mod, argv, outputs,
                              params=params, hook=record)
        sub = bracket_line(runs, same, SERVE_KERNELS)
        counts = runs[1]["counts"]
        sub["launched"] = all(counts[k] > 0 for k in SERVE_KERNELS
                              if k != "paged_decode") \
            and (counts["paged_decode"] > 0) == (mode == "paged")
        sub["logit_rows"] = int(sum(len(v) for v in
                                    runs[0]["out"][1].values()))
        sub["ok"] = bool(sub["ok"] and sub["launched"])
        ok &= sub["ok"]
        counts_by[mode] = counts
        line["modes"][mode] = sub
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    line["ok"] = ok
    return line, counts_by


def tp_rank_worker(model: int, rank: int, out_path: str):
    """Model rank ``rank`` of ``--mesh 1x<model>`` (TP_ARGS) on the fake
    process-group backend, in a process of its own: the serve driver's
    run of the serve trace, dense then ``--paged`` (each after one untimed
    warm-up request, not counted), on the seed-0 params
    the deployment draws (on the 1x4 rank each leaf drawn whole and cut
    to the rank's block as it is drawn), each run's launch and
    collective counters set to 0 just before and read just after, with
    ``obs.census.serve_census`` (the heads, FFN width and vocabulary block
    of every call) and ``launch.mesh_comm.Counter`` (the collectives'
    bytes) on; the decode steps and the peak of
    ``torch.cuda.max_memory_allocated`` of each. Writes them to
    ``out_path`` as JSON."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.mesh_comm import Counter
    from repro_torch.obs.census import serve_census
    from repro_torch.sharding import collectives as C
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=model)
    try:
        mesh = make_mesh((1, model), ("data", "model"), "cuda")
        out = {"torch": torch.__version__, "backend": dist.get_backend(),
               "world": model, "rank": rank, "coords": mesh.coords}
        for mode in MESH_SERVE:
            argv = TP_ARGS + ["--mesh", f"1x{model}"] + (
                ["--paged"] if mode == "paged" else [])
            serve_run(torch, serve_mod, argv + ["--requests", "1", "--gen",
                                                "4"],
                      params=None, arch=TP_ARCH, mesh=mesh)  # warm-up
            box = {}
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            C.reset_counts()
            counter = Counter()
            try:
                counter.on = True
                with serve_census() as rec:
                    s, counts, eng, _ = serve_run(
                        torch, serve_mod, argv, params=None, arch=TP_ARCH,
                        mesh=mesh, hook=lambda e: box.update(e=e))
            finally:
                counter.close()
            out[mode] = {
                "numbers": run_numbers(s), "ok": s["ok"],
                "decode_steps": eng.n_decode_steps,
                "counts": {k: counts[k] for k in SERVE_KERNELS},
                "collectives": dict(C.COUNTS),
                "collective_bytes": {k: c["bytes"]
                                     for k, c in counter.counts.items()},
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "attn": sorted(set(map(tuple, rec["attn"]))),
                "ffn": sorted(set(rec["ffn"])),
                "ffn_sums": sorted(set(rec["ffn_sums"])),
                "vocab": sorted(set(rec["vocab"])),
                "weight_bytes_per_step": sorted(set(rec["weights"]))}
            del eng, box
        pathlib.Path(out_path).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def serve_tp_phase(torch, smi: str):
    """The serving mesh's tensor parallelism on one rank of a wider mesh:
    llama3.2-3b at full width and depth (TP_ARGS: the serve trace, bf16,
    dense and ``--paged``) at ``--mesh 1x1`` and as model rank TP_RANK of
    ``--mesh 1xTP_M`` on the fake backend (collectives launched but not
    run: the rank's values are not checked), each mesh in a process of
    its own (:func:`tp_rank_worker`). Gates on the 1xTP_M rank, in each
    mode: every request finishes; every attention call at TP_HEADS heads,
    every FFN at TP_FFN columns summed over "model" by one collective,
    every unembedding block at TP_VOCAB
    columns; as many decode steps as the 1x1 run and the same paged
    decode launches a decode step (TP_LAYERS, paged; 0 dense); its peak
    memory below the 1x1 run's. Reported: TTFT p50, ITL p50 and tok/s of
    both runs (host clock; the rank's labelled one rank's compute with
    the collectives not run), both peaks, the weight bytes a step runs on
    and the collectives by kind with their bytes."""
    one = spawned_json(torch, "serve_tp: 1x1", tp_rank_worker, 1, 0)
    tp = spawned_json(torch, f"serve_tp: rank {TP_RANK} of 1x{TP_M}",
                      tp_rank_worker, TP_M, TP_RANK)
    line = {"arch": TP_ARCH, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": tp["torch"],
            "backend": tp["backend"], "mesh": f"1x{TP_M}", "rank": TP_RANK,
            "coords": tp["coords"], "modes": {}}
    ok = True
    for mode in MESH_SERVE:
        a, b = one[mode], tp[mode]
        per_step = [r["counts"]["paged_decode"] / max(r["decode_steps"], 1)
                    for r in (a, b)]
        want = TP_LAYERS if mode == "paged" else 0
        sub = {"attn_heads": b["attn"], "ffn_widths": b["ffn"],
               "ffn_sums": b["ffn_sums"], "vocab_blocks": b["vocab"],
               "one_rank_attn_heads": a["attn"],
               "one_rank_ffn_widths": a["ffn"],
               "one_rank_vocab_blocks": a["vocab"],
               "decode_steps": [a["decode_steps"], b["decode_steps"]],
               "paged_decode_per_step": per_step,
               "launches": [a["counts"], b["counts"]],
               "one_rank_compute_collectives_not_run": b["numbers"],
               "one_rank_1x1": a["numbers"],
               "peak_bytes": b["peak_bytes"],
               "peak_bytes_1x1": a["peak_bytes"],
               "weight_bytes_per_step": b["weight_bytes_per_step"],
               "weight_bytes_per_step_1x1": a["weight_bytes_per_step"],
               "collectives": b["collectives"],
               "collective_bytes": b["collective_bytes"],
               "collectives_1x1": a["collectives"]}
        sub["ok"] = bool(
            a["ok"] and b["ok"] and b["attn"] == [TP_HEADS]
            and b["ffn"] == [TP_FFN] and b["ffn_sums"] == [1]
            and b["vocab"] == [TP_VOCAB]
            and a["decode_steps"] == b["decode_steps"] > 0
            and per_step == [want, want]
            and b["peak_bytes"] < a["peak_bytes"])
        ok &= sub["ok"]
        line["modes"][mode] = sub
    line["ok"] = bool(ok)
    return line


def paged_lse_case(torch, cfg, label: str, B: int, MP: int, q_pos, dtype,
                   seed: int, window: int = 0):
    """The paged decode kernel's lse output (:func:`paged_case`'s inputs,
    the values scaled by GRAD_BF16_CT) against its plain version, and the
    pool cut in two halves of pages, each half through the kernel on a
    rank-local table (its pages renumbered from 0, the others -1), the two
    partials merged by ``modules.merge_partials``, against the whole
    pool's kernel; the kernel's time with and without the lse output."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.modules import merge_partials
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    KH, hd, ps = cfg.n_kv_heads, cfg.head_dim, 16
    G, P = cfg.n_heads // KH, B * MP
    q = torch.randn((B, KH, G, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, ps, KH, hd), generator=gen, device=dev).to(dtype)
    vp = (torch.randn((P, ps, KH, hd), generator=gen, device=dev)
          * GRAD_BF16_CT).to(dtype)
    table = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = table.reshape(B, MP).contiguous()
    q_pos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    for b, p in enumerate(q_pos.tolist()):
        table[b, p // ps + 1:] = -1
    kw = dict(scale=hd ** -0.5, window=window)
    out, lse = pa.paged_decode_forward(q, kp, vp, table, q_pos, **kw,
                                       return_lse=True)
    want, lse_p = pa.paged_decode_plain(q, kp, vp, table, q_pos, **kw,
                                        return_lse=True)
    plain_out = pa.paged_decode_forward(q, kp, vp, table, q_pos, **kw)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    err, tol, out_ok = (compare(out, want, per_row=True) if bf16
                        else compare_f32(out, want))
    live = torch.isfinite(lse_p)
    lse_err = float((lse - lse_p)[live].abs().max()) if live.any() else 0.0
    lse_tol = LSE_TIER * max(1.0, float(lse_p[live].abs().max()))
    lse_ok = torch.equal(torch.isfinite(lse), live) and lse_err <= lse_tol
    h = P // 2
    parts = []
    for lo in (0, h):
        own = (table >= lo) & (table < lo + h)
        loc = torch.where(own, table - lo, -1).to(torch.int32).contiguous()
        parts.append(pa.paged_decode_forward(
            q, kp[lo:lo + h], vp[lo:lo + h], loc, q_pos, **kw,
            return_lse=True))
    merged = merge_partials(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
    if bf16:
        m_err, m_tol, m_ok = compare(merged, plain_out)
    else:
        m_err = float((merged - plain_out).abs().max())
        m_tol = MERGE_F32_TIER * float(plain_out.abs().max())
        m_ok = m_err <= m_tol
    t_lse = kernel_times(lambda: pa.paged_decode_forward(
        q, kp, vp, table, q_pos, **kw, return_lse=True), 50)
    t_out = kernel_times(lambda: pa.paged_decode_forward(
        q, kp, vp, table, q_pos, **kw), 50)
    return {"case": label, "dtype": str(dtype).replace("torch.", ""),
            "q": list(q.shape), "pools": list(kp.shape),
            "table": list(table.shape), "window": window,
            "q_pos": q_pos.tolist(), "out_err": err, "out_tol": tol,
            "out_bitwise_without_lse": torch.equal(out, plain_out),
            "lse_err": lse_err, "lse_tol": lse_tol,
            "lse_neg_inf": int((~live).sum()),
            "merge_err": m_err, "merge_tol": m_tol,
            "ms_lse": t_lse["ms"], "ms": t_out["ms"],
            "host_ms_lse": t_lse["host_ms"], "host_ms": t_out["host_ms"],
            "ok": bool(out_ok and lse_ok and m_ok
                       and torch.equal(out, plain_out))}


def paged_lse_phase(torch):
    """:func:`paged_lse_case` at the serve shape (W2's heads, 4 slots, 26
    table slots) and at recurrentgemma's heads (KH 1, G 16, hd 256) and
    2048-line window, in bf16 and f32."""
    from repro_torch.models import registry
    w2, rg = registry.get_config("mixtral-w2"), registry.get_config(RGEMMA)
    MP = -(-(LONG_PROMPT + 32) // 16)
    out = []
    for tag, dtype in (("", torch.bfloat16), ("-f32", torch.float32)):
        out.append(paged_lse_case(torch, w2, f"serve{tag}", 4, 26,
                                  [415, 300, 131, 17], dtype, 31))
        out.append(paged_lse_case(torch, rg, f"rgemma{tag}", 4, MP,
                                  [MP * 16 - 1, LONG_PROMPT - 1, 2100, 700],
                                  dtype, 32, window=rg.window))
    return out


def recurrent_trace(serve_mod, cfg, long_prompt: int = 0):
    """The serve trace (SERVE_ARGS' 6 requests) on ``cfg``'s vocabulary,
    plus, with ``long_prompt``, one request of that many seeded tokens
    arriving with the last one."""
    import torch

    from repro_torch.serve import Request, ServeConfig
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    sampling = ServeConfig.from_args(args).sampling
    trace = serve_mod.build_trace(args.seed, args.requests, args.rate,
                                  args.prompt_len, args.gen, cfg.vocab_size,
                                  sampling)
    if long_prompt:
        gen = torch.Generator().manual_seed(7)
        trace.append(Request(
            rid=len(trace), prompt=torch.randint(
                0, cfg.vocab_size, (long_prompt,), generator=gen).tolist(),
            max_new_tokens=args.gen, sampling=sampling,
            arrival=trace[-1].arrival))
    return trace


def decode_bytes(params) -> int:
    """Bytes of the tree a decode step reads once: the compute-dtype
    matrices (``stack._COMPUTE_LEAVES``) in bf16, every other leaf
    (norms, the RG-LRU gates w_i / w_a cast to f32 at use, the SSD's
    A_log, D, dt_bias) in f32."""
    from repro_torch.models import stack

    def walk(tree):
        return sum(walk(v) if isinstance(v, dict)
                   else v.numel() * (2 if k in stack._COMPUTE_LEAVES else 4)
                   for k, v in tree.items())
    return walk(params)


def count_decode_steps(worker, box: dict) -> None:
    """Count the decode steps of ``worker``'s program in ``box["steps"]``
    (a disaggregated decode worker keeps no count of its own)."""
    step = worker.p.decode_step

    def counted(*a, **kw):
        box["steps"] += 1
        return step(*a, **kw)
    worker.p.decode_step = counted


def recording_crcs(crcs: list):
    """Record every chunk checksum the KV transfer computes in ``crcs``;
    returns the function that removes the recorder."""
    from repro_torch.serve import kv_transfer
    crc = kv_transfer._tree_crc

    def recorded(payload):
        crcs.append(crc(payload))
        return crcs[-1]
    kv_transfer._tree_crc = recorded
    return lambda: setattr(kv_transfer, "_tree_crc", crc)


def recurrent_f32_runs(torch, serve_mod, params, cfg, arch, runs, trace):
    """The f32 runs of ``runs`` ({label: argv}) with first-token logits
    recorded, each request's against the cache-free forward on its prompt
    (computed once a request): (per label: summary ok, first rows,
    results), {label: {rid: rel}}."""
    from repro_torch.models import stack
    from repro_torch.models.modules import (Policy, RunConfig,
                                            apply_unembedding)
    run32 = RunConfig(policy=Policy(compute_dtype=torch.float32))
    out = {}
    for label, argv in runs.items():
        s, _, eng, _ = serve_run(
            torch, serve_mod, argv, params=params, trace=trace(), run=run32,
            hook=lambda e: setattr(e, "record_logits", True), arch=arch)
        out[label] = (s["ok"], {rid: rows[0]
                                for rid, rows in eng.logits.items()},
                      dict(eng.results))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    rel = {label: {} for label in runs}
    for r in trace():
        with torch.inference_mode():
            ref, _, _ = stack.apply_model(
                params, cfg, run32, torch.tensor([r.prompt], device="cuda"),
                return_hidden=True)
            ref = apply_unembedding(params["embed"], params.get("lm_head"),
                                    cfg, run32.policy, ref[:, -1])[0].float()
        for label in runs:
            got = torch.from_numpy(out[label][1][r.rid]).cuda()
            rel[label][r.rid] = float((got - ref).abs().max()) \
                / float(ref.abs().max())
    return out, rel, run32


def serve_rgemma_phase(torch, serve_mod, smi: str):
    """recurrentgemma-9b at full width and depth (38 layers: 24 RG-LRU,
    12 local attention with a 2048-line window; 9.40 B params, seed 0) on
    the serve trace plus a 2304-token prompt: (a) dense, the driver's
    default, (b) ``--paged``, (d) ``--disagg``, each in bf16, the
    main-path runs (counted); then (c) dense and paged under the f32
    policy, first-token logits recorded. Paged decode launches 12 a decode
    step in (b) and (d), none in (a)."""
    from repro_torch.models import registry, stack
    from repro_torch.pytree import flatten
    cfg = registry.get_config(RGEMMA)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = stack.init_model(gen, cfg, device="cuda")
    n_params = sum(v.numel() for v in flatten(params).values())

    def trace():
        return recurrent_trace(serve_mod, cfg, LONG_PROMPT)
    counts, steps, lines = {}, {}, {}
    for label, argv in (("dense", RGEMMA_DENSE_ARGS),
                        ("paged", RGEMMA_PAGED_ARGS)):
        s, c, eng, _ = serve_run(torch, serve_mod, argv, params=params,
                                 trace=trace(), arch=RGEMMA)
        counts[label], steps[label] = c, eng.n_decode_steps
        lines[label] = dict(serve_numbers(s, c),
                            decode_steps=eng.n_decode_steps,
                            prefill_chunks=eng.n_prefill_chunks)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    box = {"steps": 0}

    def disagg_hook(ctl):
        checked_every_tick(ctl)
        count_decode_steps(ctl.decode, box)
    s_g, counts["disagg"], ctl, _ = serve_run(
        torch, serve_mod, RGEMMA_DISAGG_ARGS, params=params, trace=trace(),
        hook=disagg_hook, arch=RGEMMA)
    st, d = ctl.transfer.stats, s_g["disagg"]
    steps["disagg"] = box["steps"]
    lines["disagg"] = dict(serve_numbers(s_g, counts["disagg"]),
                           decode_steps=box["steps"], sections=d,
                           transfer={"pages": st.n_pages, "bytes": st.bytes})
    del ctl
    gc.collect()
    torch.cuda.empty_cache()
    f32, rel, run32 = recurrent_f32_runs(
        torch, serve_mod, params, cfg, RGEMMA,
        {"dense": RGEMMA_DENSE_ARGS, "paged": RGEMMA_PAGED_ARGS}, trace)
    dp = {rid: float(abs(f32["dense"][1][rid] - row).max())
          / float(abs(row).max()) for rid, row in f32["paged"][1].items()}
    div = first_divergence(torch, params, cfg, run32, trace(),
                           f32["dense"][2], f32["paged"][2])
    bound_ms = decode_bytes(params) / HBM_BYTES_PER_S * 1e3
    del params
    launches = {k: c["paged_decode"] for k, c in counts.items()}
    want = {"dense": 0, "paged": RGEMMA_ATTN_LAYERS * steps["paged"],
            "disagg": RGEMMA_ATTN_LAYERS * steps["disagg"]}
    line = {"arch": RGEMMA, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "params": n_params,
            "long_prompt": LONG_PROMPT, "window": cfg.window, **lines,
            "paged_decode_launches": launches,
            "paged_decode_expected": want,
            "itl_bound_ms": bound_ms,
            "f32": {"ok": f32["dense"][0] and f32["paged"][0],
                    "first_logits_vs_forward": rel,
                    "worst_vs_forward": max(max(v.values())
                                            for v in rel.values()),
                    "limit_vs_forward": PARITY_REL,
                    "dense_vs_paged": dp, "worst_dense_vs_paged": max(
                        dp.values()), "limit_dense_vs_paged": DENSE_REL,
                    "greedy_equal": f32["dense"][2] == f32["paged"][2],
                    "first_divergence": div}}
    line["ok"] = bool(
        all(v["ok"] for v in lines.values()) and line["f32"]["ok"]
        and launches == want and steps["paged"] > 0
        and d["kv_transfers"] == s_g["n_requests"] + d["n_preempted"]
        and line["f32"]["worst_vs_forward"] <= PARITY_REL
        and line["f32"]["worst_dense_vs_paged"] <= DENSE_REL
        and (div is None or div["margin_rel"] <= F32_TIER))
    return line, counts


def serve_mamba2_phase(torch, serve_mod, smi: str):
    """mamba2-2.7b at full width and depth (64 SSD layers, seed 0) on the
    serve trace: (a) dense, (b) ``--paged`` and (d) ``--disagg`` in bf16,
    the main-path runs (counted; the engines' SSD decode runs
    ``ref.ssd_decode_step``, the reference's route, and their prefill
    ``ref.ssd_chunked`` from the state, no kernel), (d) with
    every chunk checksum recorded; then (c) ``--paged`` under the f32
    policy, first-token logits against the cache-free forward (through the
    SSD scan kernel)."""
    from repro_torch.models import registry, stack
    cfg = registry.get_config(MAMBA2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = stack.init_model(gen, cfg, device="cuda")

    def trace():
        return recurrent_trace(serve_mod, cfg)
    counts, lines = {}, {}
    for label, argv in (("dense", MAMBA2_DENSE_ARGS),
                        ("paged", MAMBA2_PAGED_ARGS)):
        s, c, eng, _ = serve_run(torch, serve_mod, argv, params=params,
                                 trace=trace(), arch=MAMBA2)
        counts[label] = c
        lines[label] = dict(serve_numbers(s, c),
                            decode_steps=eng.n_decode_steps,
                            prefill_chunks=eng.n_prefill_chunks)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    crcs = []
    undo = recording_crcs(crcs)
    try:
        s_g, counts["disagg"], ctl, _ = serve_run(
            torch, serve_mod, MAMBA2_DISAGG_ARGS, params=params,
            trace=trace(), hook=checked_every_tick, arch=MAMBA2)
    finally:
        undo()
    st, d = ctl.transfer.stats, s_g["disagg"]
    lines["disagg"] = dict(serve_numbers(s_g, counts["disagg"]),
                           sections=d, transfer={
                               "transfers": st.n_transfers,
                               "chunks": st.n_chunks, "pages": st.n_pages,
                               "bytes": st.bytes, "crcs": len(crcs),
                               "crc_values": sorted(set(crcs))})
    del ctl
    gc.collect()
    torch.cuda.empty_cache()
    f32, rel, _ = recurrent_f32_runs(torch, serve_mod, params, cfg, MAMBA2,
                                     {"paged": MAMBA2_PAGED_ARGS}, trace)
    ssm = 2 * cfg.n_layers * 4 * cfg.ssm_expand * cfg.d_model \
        * cfg.ssm_state * 4  # 4 slots' f32 SSD states read and written
    w_bytes = decode_bytes(params)
    del params
    line = {"arch": MAMBA2, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, **lines,
            "itl_bound_ms": (w_bytes + ssm) / HBM_BYTES_PER_S * 1e3,
            "decode_bytes": {"weights": w_bytes, "ssd_states": ssm},
            "f32": {"ok": f32["paged"][0],
                    "first_logits_vs_forward": rel["paged"],
                    "worst_vs_forward": max(rel["paged"].values()),
                    "limit_vs_forward": PARITY_REL}}
    line["ok"] = bool(
        all(v["ok"] for v in lines.values()) and line["f32"]["ok"]
        and line["f32"]["worst_vs_forward"] <= PARITY_REL
        and st.bytes == 0 and st.n_transfers >= s_g["n_requests"] > 0
        and d["kv_transfers"] == s_g["n_requests"] + d["n_preempted"]
        and len(crcs) > 0 and set(crcs) == {0})
    return line, counts


def serve_mesh_recurrent_phase(torch, serve_mod, smi: str):
    """The recurrent archs on the serving mesh at ``--mesh 1x1``:
    recurrentgemma-9b at full width and depth ``--paged`` on the serve
    trace plus the 2304-token prompt, and mamba2-2.7b at full width and
    depth dense on the serve trace, each in bf16 through
    :func:`bracketed_runs` (one device, mesh, mesh, one device; the mesh
    program reads its recurrent state blocks through
    ``serve.mesh.RecurrentBlocks``, at world 1 the whole leaves). Gate:
    every request finishes; tokens and every recorded f32 logit row
    bitwise the first run's in all four runs; no collective; each run's
    launches equal the first's; recurrentgemma's paged decode launches 12
    a decode step. Reported: ITL p50 and tok/s of each run (host clock).
    Returns (line, {arch: launch counts of the first mesh run})."""
    import numpy as np

    from repro_torch.models import registry, stack

    def record(engine):
        engine.record_logits = True

    def outputs(eng, _s):
        return ({int(k): list(v) for k, v in eng.results.items()},
                {int(k): np.stack(v) for k, v in eng.logits.items()},
                eng.n_decode_steps)

    def same(a, b):
        return a[0] == b[0] and a[1].keys() == b[1].keys() \
            and all(np.array_equal(a[1][r], b[1][r]) for r in b[1])

    line = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "mesh": "1x1"}
    counts_by, ok = {}, True
    for arch, mode, argv, long in ((RGEMMA, "paged", RGEMMA_PAGED_ARGS,
                                    LONG_PROMPT),
                                   (MAMBA2, "dense", MAMBA2_DENSE_ARGS, 0)):
        cfg = registry.get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = stack.init_model(gen, cfg, device="cuda")
        runs = bracketed_runs(
            torch, serve_mod, argv, outputs, params=params, arch=arch,
            hook=record, trace=lambda: recurrent_trace(serve_mod, cfg, long))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        sub = bracket_line(runs, same, SERVE_KERNELS)
        steps = [r["out"][2] for r in runs]
        paged = [r["counts"]["paged_decode"] for r in runs]
        want = [RGEMMA_ATTN_LAYERS * n if mode == "paged" else 0
                for n in steps]
        sub.update(arch=arch, mode=mode, decode_steps=steps,
                   paged_decode_launches=paged,
                   paged_decode_expected=want,
                   logit_rows=int(sum(len(v) for v in
                                      runs[0]["out"][1].values())),
                   reduced=None)
        sub["ok"] = bool(sub["ok"] and paged == want)
        ok &= sub["ok"]
        line[arch] = sub
        counts_by[arch] = runs[1]["counts"]
    line["ok"] = bool(ok)
    return line, counts_by


def serve_mesh_lockstep_phase(torch, serve_mod, smi: str):
    """The lockstep server on the serving mesh at ``--mesh 1x1``:
    whisper-tiny (full config) and llama-3.2-vision-90b (full width cut to
    VISION_LAYERS, as serve_vision runs it), seed-0 weights with every
    gate at XATTN_GATE and random fronts, bf16, through
    :func:`bracketed_runs` (``serve_arch`` -> ``serve_arch_lockstep`` ->
    ``make_serve_program(mesh=)``). Gate: the generated tokens and the
    prefill's last-position logits bitwise the first run's in all four
    runs; no collective; each run's launches equal the first's.
    Returns (line, {arch: launch counts of the first mesh run})."""
    import dataclasses

    from repro_torch.models import registry, stack

    def outputs(server, s):
        return (s["tokens"], server.logits.float().cpu())

    def same(a, b):
        return a[0] == b[0] and torch.equal(a[1], b[1])

    line = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "mesh": "1x1", "gate": XATTN_GATE}
    counts_by, ok = {}, True
    for arch, layers in ((WHISPER, None), (VISION, VISION_LAYERS)):
        full = registry.get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = stack.init_model(gen, cfg, device="cuda")
        with_gate(params, XATTN_GATE)
        fronts = {k: v.to(torch.bfloat16) for k, v in
                  random_fronts(torch, cfg, 4, 1).items()}
        runs = bracketed_runs(
            torch, serve_mod, ["--arch", arch] + XATTN_SERVE_ARGS, outputs,
            params=params, arch=arch, fronts=fronts, cfg=cfg)
        del params, fronts
        gc.collect()
        torch.cuda.empty_cache()
        sub = bracket_line(runs, same, SERVE_KERNELS)
        sub.update(arch=arch, reduced=(None if layers is None else
                                       {"n_layers": [full.n_layers,
                                                     layers]}))
        ok &= sub["ok"]
        line[arch] = sub
        counts_by[arch] = runs[1]["counts"]
    line["ok"] = bool(ok)
    return line, counts_by


def train_rgemma_phase(torch, train_mod, smi: str):
    """The train driver on recurrentgemma-9b at full width cut to 5 layers
    (RGEMMA_TRAIN_LAYERS: one repeat of the pattern and the rglru tail),
    batch 2 x seq 4096: one untimed warm-up step on a model of its own,
    then 3 steps, the launch counters set to 0 just before and read just
    after (no kernel is on this path: the RG-LRU scan is plain torch, the
    driver's attention chunked). Gate: finite losses and grad norms."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.models import registry
    full = registry.get_config(RGEMMA)
    cfg = dataclasses.replace(full, n_layers=RGEMMA_TRAIN_LAYERS)
    parse = train_mod.build_parser().parse_args
    warm = train_mod.train_arch(RGEMMA, parse(RGEMMA_TRAIN_ARGS
                                              + ["--steps", "1"]), cfg=cfg)
    if not warm["ok"]:
        raise RuntimeError("recurrentgemma warm-up train step failed")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    args = parse(RGEMMA_TRAIN_ARGS)
    s = train_mod.train_arch(RGEMMA, args, cfg=cfg)
    torch.cuda.synchronize()
    counts = driver_counts(kernels)
    line = {"arch": RGEMMA, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "params": s["params"],
            "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
            "steps": args.steps, "batch": args.batch, "seq": args.seq,
            "ms_per_step": s["ms_per_step"],
            "tokens_per_s": s["tokens_per_s"],
            "step_ms": [t * 1e3 for t in s["step_s"]],
            "loss": [m["loss"] for m in s["history"]],
            "grad_norm": [m["grad_norm"] for m in s["history"]],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in counts.items() if v},
            "ok": bool(s["ok"])}
    return line, counts


def rglru_scan_phase(torch, smi: str):
    """The port's ``modules._lru_scan`` (the doubling scan) at the train
    run's full width, [2, 4096, 4096] f32 with an h0, against a sequential
    loop on the card (max|diff| within 1e-5 * max|loop|); its forward and
    forward + backward device times (CUDA events), the loop's, and the
    byte bounds: the forward reads a, gx, h0 and writes h; the backward
    reads a, h and dh and writes da, dgx, dh0."""
    from repro_torch.models import modules
    B, S, W = RGLRU_SCAN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.rand((B, S, W), generator=gen, device="cuda")
    a.mul_(0.999 - 0.5).add_(0.5)
    gx = torch.randn((B, S, W), generator=gen, device="cuda")
    h0 = torch.randn((B, W), generator=gen, device="cuda")

    def loop():
        out = torch.empty_like(gx)
        h = h0
        for t in range(S):
            h = a[:, t] * h + gx[:, t]
            out[:, t] = h
        return out
    with torch.no_grad():
        got, want = modules._lru_scan(a, gx, h0), loop()
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        del got, want
        fwd_ms, fwd_host = cuda_times(lambda: modules._lru_scan(a, gx, h0),
                                      5)
        loop_ms = cuda_ms(loop, 1, warmup=1)
    leaves = [t.clone().requires_grad_(True) for t in (a, gx, h0)]
    dh = torch.randn_like(gx)

    def fwd_bwd():
        return torch.autograd.grad(modules._lru_scan(*leaves), leaves, dh)
    fb_ms = cuda_ms(fwd_bwd, 3)
    n = 4 * B * S * W
    f_bound, f_by = bound(3 * n + 4 * B * W, 2 * B * S * W, FP32_FLOPS)
    b_bound, b_by = bound(5 * n + 8 * B * W, 4 * B * S * W, FP32_FLOPS)
    del leaves, dh, a, gx, h0
    torch.cuda.empty_cache()
    return {"shape": [B, S, W], "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "passes": math.ceil(math.log2(S)),
            "max_abs_err": err, "tol": tol, "ms": fwd_ms,
            "host_ms": fwd_host, "fwd_bwd_ms": fb_ms,
            "bwd_ms": fb_ms - fwd_ms, "loop_ms": loop_ms,
            "bound_ms": f_bound, "bound_by": f_by, "bwd_bound_ms": b_bound,
            "bwd_bound_by": b_by, "ok": err <= tol}


def paged_rgemma_phase(torch):
    """Paged decode at recurrentgemma's heads (KH 1, G 16, hd 256, page
    16) and window (2048) on 4 slots of the serve run's 146 table slots,
    three of them past the window, in bf16 and f32 (:func:`paged_case`)."""
    from repro_torch.models import registry
    cfg = registry.get_config(RGEMMA)
    MP = -(-(LONG_PROMPT + 32) // 16)
    q_pos = [MP * 16 - 1, LONG_PROMPT - 1, 2100, 700]
    return [paged_case(torch, cfg, f"rgemma{tag}", 4, MP, q_pos, dtype, 21,
                       window=cfg.window)
            for tag, dtype in (("", torch.bfloat16),
                               ("-f32", torch.float32))]


def flash_shape_recorder():
    """Count the flash launches by (kernel, S, T, causal) in the returned
    Counter until the returned remover runs: a wrapper around the
    launching functions (the launch counters stay the wrappers')."""
    import collections

    from repro_torch.kernels import flash_attention as fa
    counts = collections.Counter()
    fwd, bwd = fa.flash_forward, fa._launch_backward

    def forward(q, k, v, **kw):
        out = fwd(q, k, v, **kw)
        if q.is_cuda:
            counts[("flash_fwd", q.shape[2], k.shape[2],
                    bool(kw["causal"]))] += 1
        return out

    def backward(name, q, k, v, *a, **kw):
        out = bwd(name, q, k, v, *a, **kw)
        counts[(f"flash_{name}", q.shape[2], k.shape[2],
                bool(kw["causal"]))] += 1
        return out
    fa.flash_forward, fa._launch_backward = forward, backward

    def remove():
        fa.flash_forward, fa._launch_backward = fwd, bwd
    return counts, remove


def train_whisper_phase(torch, train_mod, smi: str):
    """whisper-tiny at its full config through the train driver, batch 8 x
    seq 256 with the driver's zero fronts: one untimed warm-up step on a
    model of its own, then 3 steps with the driver's chunked attention
    (no hand-written kernel on that path) and 3 with
    ``attn_impl="flash"``: every self-, cross- and encoder attention
    through the flash kernels, launches counted by shape. Returns the two
    lines and counts and the launches by (kernel, S, T, causal)."""
    from repro_torch.models.modules import Policy, RunConfig
    parse = train_mod.build_parser().parse_args
    warm = train_mod.train_arch(WHISPER, parse(WHISPER_TRAIN_ARGS
                                               + ["--steps", "1"]))
    if not warm["ok"]:
        raise RuntimeError("whisper warm-up train step failed")
    gc.collect()
    torch.cuda.empty_cache()
    line, counts = timed_train(torch, train_mod, smi, WHISPER_TRAIN_ARGS,
                               {})
    gc.collect()
    torch.cuda.empty_cache()
    run = RunConfig(policy=Policy(), attn_impl="flash", moe_impl="gather",
                    remat="full")
    shapes, remove = flash_shape_recorder()
    try:
        fline, fcounts = timed_train(torch, train_mod, smi,
                                     WHISPER_TRAIN_ARGS, {}, run)
    finally:
        remove()
    steps = fline["steps"]
    want_shapes = {(k, *shape): n * steps * (2 if k == "flash_fwd" else 1)
                   for shape, n in WHISPER_ATTN.items()
                   for k in FLASH_LAUNCHES}
    calls = sum(WHISPER_ATTN.values()) * steps
    fline["launches_expected"] = {
        k: FLASH_LAUNCHES.get(k, 0) * calls for k in fline["launches"]}
    fline["launches_by_shape"] = {f"{k}:{S}x{T}:{'causal' if c else 'full'}":
                                  n for (k, S, T, c), n in
                                  sorted(shapes.items())}
    fline["step1_rel_gap_vs_chunked"] = {
        k: abs(fline[k][0] - line[k][0]) / abs(line[k][0])
        for k in ("loss", "grad_norm")}
    line["ok"] = all(v == 0 for v in line["launches"].values())
    fline["ok"] = bool(
        fline["launches_expected"] == fline["launches"]
        and dict(shapes) == want_shapes
        and max(fline["step1_rel_gap_vs_chunked"].values()) <= FLASH_GAP)
    return line, counts, fline, fcounts, dict(shapes)


def with_gate(params, gate: float) -> None:
    """Set every cross-attention gate ``xgate`` of a param tree to
    ``gate``, in place."""
    for k, v in params.items():
        if isinstance(v, dict):
            with_gate(v, gate)
        elif k == "xgate":
            v.fill_(gate)


def random_fronts(torch, cfg, batch: int, seed: int) -> dict:
    """Front embeddings of ``cfg`` drawn N(0, 1) in f32 on the card."""
    from repro_torch.models import stack
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen, device="cuda")
            for k, v in stack.zero_fronts(cfg, batch, torch.float32,
                                          "cuda").items()}


def serve_xattn_phase(torch, serve_mod, smi: str, arch: str,
                      layers=None):
    """``arch`` (cut to ``layers`` where given) served lockstep through
    the serve driver, seed-0 weights with every gate at XATTN_GATE and
    random fronts: (a) bf16, the main-path run (counted): tok/s, TTFT
    (the prefill), ITL per decode step, and the device ms of rebuilding
    the cross-attention memory (whisper's encoder, the vision projection)
    that every decode step pays; (b) under the f32 policy the lockstep
    server's first-token logits against the cache-free forward's, and its
    greedy tokens against greedy decoding by the cache-free forward
    (equal, or diverging where the forward's top-2 margin is within
    F32_TIER of max|logit|); the gate at 0 moves the forward's logits by
    more than 1e-3 of max|logit| (the check is not vacuous)."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import registry, stack
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.pytree import flatten
    from repro_torch.serve import ServeConfig, build_deployment
    full = registry.get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = stack.init_model(gen, cfg, device="cuda")
    with_gate(params, XATTN_GATE)
    n_params = sum(v.numel() for v in flatten(params).values())
    args = serve_mod.build_parser().parse_args(["--arch", arch]
                                               + XATTN_SERVE_ARGS)
    slots, gen_n = args.slots, args.gen
    fronts = random_fronts(torch, cfg, slots, 1)
    bf = {k: v.to(torch.bfloat16) for k, v in fronts.items()}
    kernels.reset_launch_counts()
    s = serve_mod.serve_arch(arch, args, params=params, fronts=bf, cfg=cfg)
    torch.cuda.synchronize()
    counts = driver_counts(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    run = RunConfig(policy=Policy())
    pc = stack.compute_params(params, run.policy)
    with torch.inference_mode():
        memory_ms = cuda_ms(lambda: stack.cross_memory(
            pc, cfg, run, slots, bf.get("encoder_embeds"),
            bf.get("vision_embeds")), 5)
    del pc
    gc.collect()
    torch.cuda.empty_cache()
    itl = sorted(s["itl_s"])[len(s["itl_s"]) // 2]

    run32 = RunConfig(policy=Policy(compute_dtype=torch.float32))
    sc = ServeConfig.from_args(args)
    prompts = np.random.RandomState(sc.seed).randint(
        0, cfg.vocab_size, (slots, args.prompt_len))
    server = build_deployment(cfg, run32, sc, params=params, device="cuda")
    out = [server.submit_prefill(prompts, fronts)]
    first = server.logits.float()
    out += [server.step(fronts) for _ in range(gen_n - 1)]
    got = torch.cat(out, dim=1).tolist()
    del server
    seq = torch.as_tensor(prompts, device="cuda")
    want, margins = [], []
    with torch.inference_mode():
        for i in range(gen_n):
            lg, _, _ = stack.apply_model(params, cfg, run32, seq, **fronts)
            last = lg[:, -1].float()
            if i == 0:
                ref_first = last
            top = last.topk(2).values
            margins.append(((top[:, 0] - top[:, 1])
                            / last.abs().amax(-1)).tolist())
            want.append(last.argmax(-1))
            seq = torch.cat([seq, want[-1][:, None]], dim=1)
        with_gate(params, 0.0)
        ungated, _, _ = stack.apply_model(params, cfg, run32,
                                          seq[:, :args.prompt_len], **fronts)
    want = torch.stack(want, dim=1).tolist()
    scale = float(ref_first.abs().max())
    rel = float((first - ref_first).abs().max()) / scale
    gate_moves = float((ungated[:, -1].float() - ref_first).abs().max())         / scale
    divergences = []
    for b in range(slots):
        j = next((i for i, (x, y) in enumerate(zip(got[b], want[b]))
                  if x != y), None)
        if j is not None:
            divergences.append({"slot": b, "pos": j,
                                "margin_rel": margins[j][b]})
    bf16_equal = sum(x == y for a, b in zip(s["tokens"], want)
                     for x, y in zip(a, b)) / (slots * gen_n)
    bound_ms = decode_bytes(params) / HBM_BYTES_PER_S * 1e3
    del params, fronts, bf
    gc.collect()
    torch.cuda.empty_cache()
    line = {"arch": arch, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "params": n_params,
            "reduced": (None if layers is None else
                        {"n_layers": [full.n_layers, cfg.n_layers]}),
            "slots": slots, "prompt_len": args.prompt_len, "gen": gen_n,
            "memory_len": cfg.encoder_seq or cfg.vision_seq,
            "gate": XATTN_GATE, "lockstep": s["lockstep"],
            "tokens_per_s": s["tokens_per_s"], "ttft_s": s["ttft_s"],
            "itl_p50_s": itl, "itl_s": s["itl_s"],
            "memory_rebuild_ms": memory_ms,
            "memory_rebuild_share_of_itl": memory_ms / (itl * 1e3),
            "itl_bound_ms": bound_ms,
            "launches": {k: v for k, v in counts.items() if v},
            "bf16_tokens_equal_f32_forward": bf16_equal,
            "f32": {"first_logits_vs_forward": rel,
                    "limit_vs_forward": PARITY_REL,
                    "greedy_equal": got == want,
                    "divergences": divergences,
                    "gate0_moves_logits": gate_moves}}
    line["ok"] = bool(
        s["ok"] and rel <= PARITY_REL and gate_moves > 1e-3
        and all(d["margin_rel"] <= F32_TIER for d in divergences))
    return line, counts


def check_xattn_flash(torch, by_shape: dict):
    """The flash kernels against their plain versions in bf16 at
    XATTN_FLASH_CASES, each entry with its launches at that shape in the
    whisper flash train run (``by_shape``; the vision cross shape is
    served through the reference attention: a kernel case only)."""
    out = []
    for label, B, S, T, H, KH, hd in XATTN_FLASH_CASES:
        for e in flash_case(torch, label, B, S, H, KH, hd, torch.bfloat16,
                            T=T, causal=False):
            e["launches"] = by_shape.get((e["name"], S, T, False), 0)
            out.append(e)
        torch.cuda.empty_cache()
    return out


def checked_every_tick_unified(engine) -> None:
    """Check a unified paged engine's allocator after every tick."""
    tick = engine.tick

    def checked():
        tick()
        engine.sched.allocator.check()
    engine.tick = checked


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)

    build_s = _build.build_all()
    hgmma = _build.sass_counts("HGMMA")
    print(f"build: {len(_build.sources())} CUDA sources compiled in "
          f"{build_s:.2f} s -> {_build.build_dir()}; HGMMA in SASS: "
          f"{json.dumps(hgmma)}", flush=True)
    if not all(hgmma.get(lib) for lib in WGMMA_LIBS):
        raise RuntimeError(f"the tensor-core kernels hold no HGMMA: {hgmma}")

    # -- untimed warm-up: one short request on an engine of its own ---------
    warm = serve_mod.serve_arch(
        "mixtral-w2", serve_mod.build_parser().parse_args(WARMUP_ARGS))
    if not warm["ok"]:
        raise RuntimeError("warm-up serve run failed its gate")
    torch.cuda.synchronize()
    print(f"warm-up: {warm['n_requests']} request, "
          f"{warm['n_generated_tokens']} tokens (untimed, not counted)",
          flush=True)

    # -- main path 1: the port's serve driver at full width -----------------
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    kernels.reset_launch_counts()
    summary = serve_mod.serve_arch("mixtral-w2", args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    serve_counts = {**launches, **kernels.variant_launch_counts(),
                    **kernels.design_launch_counts()}
    if not summary["ok"]:
        raise RuntimeError("serve run failed its gate")
    check_designs("serve run", serve_counts)
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the serve path: "
                           f"{missing} ({launches})")
    torch.cuda.empty_cache()

    # -- each serve kernel against its plain version at the serve shapes ---
    cfg = registry.get_config("mixtral-w2")
    paged_entry, paged_cases = check_paged_kernel(torch, cfg)
    entries = check_gmm_kernels(torch, cfg) + [paged_entry]
    torch.cuda.empty_cache()
    parity = parity_f32(torch, serve_mod)
    gc.collect()
    torch.cuda.empty_cache()  # the serve models are released here

    # -- main paths 1b-1e: the prefix cache, disaggregation, serve traces --
    from repro_torch.models import stack
    gen = torch.Generator(device="cuda").manual_seed(0)
    w2_params = stack.init_model(gen, cfg, device="cuda")
    prefix_line, prefix_counts = serve_prefix_phase(torch, serve_mod,
                                                    w2_params, smi)
    print("serve_prefix: " + json.dumps(prefix_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    disagg_line, disagg_counts, unified_tokens = serve_disagg_phase(
        torch, serve_mod, w2_params, smi)
    print("serve_disagg: " + json.dumps(disagg_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    dprefix_line, dprefix_counts = serve_disagg_prefix_phase(
        torch, serve_mod, w2_params, smi)
    print("serve_disagg_prefix: " + json.dumps(dprefix_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    strace_line, strace_counts = serve_trace_phase(
        torch, serve_mod, w2_params, smi, unified_tokens)
    print("serve_trace: " + json.dumps(strace_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    dense_line, dense_counts = serve_dense_phase(
        torch, serve_mod, w2_params, smi, {
            k: summary[k] for k in ("tokens_per_s", "n_generated_tokens")}
        | {"ttft_p50_s": summary["ttft_s"]["p50"],
           "itl_p50_s": summary["itl_s"]["p50"]}, unified_tokens)
    print("serve_dense: " + json.dumps(dense_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_line, fleet_counts = serve_fleet_phase(
        torch, serve_mod, w2_params, smi, unified_tokens)
    print("serve_fleet: " + json.dumps(fleet_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    ep_line, ep_counts, ep_dense_counts, ep_disagg_counts = serve_ep_phase(
        torch, serve_mod, w2_params, smi)
    print("serve_ep: " + json.dumps(ep_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    smesh_line, smesh_counts = serve_mesh_phase(torch, serve_mod, w2_params,
                                                smi)
    print("serve_mesh: " + json.dumps(smesh_line), flush=True)
    del w2_params, unified_tokens
    gc.collect()
    torch.cuda.empty_cache()
    tp_line = serve_tp_phase(torch, smi)
    print("serve_tp: " + json.dumps(tp_line), flush=True)
    paged_lse = paged_lse_phase(torch)
    print("paged_lse: " + json.dumps(paged_lse), flush=True)
    torch.cuda.empty_cache()
    ep_tiles = zebra_tiles_phase(
        torch, cfg, {"serve_ep": ep_counts,
                     "serve_ep_dense": ep_dense_counts,
                     "serve_ep_disagg": ep_disagg_counts},
        tiles=EP_TILES, names=("gmm_glu", "gmm:bf16.bf16->bf16"))
    print("ep_tiles: " + json.dumps(
        [{k: t[k] for k in ("name", "layout", "design", "block_m",
                            "max_abs_err", "tol", "ok", "ms", "host_ms",
                            "ms_block_m128", "bound_ms", "bound_by",
                            "launches", "shapes")} for t in ep_tiles]),
          flush=True)
    torch.cuda.empty_cache()

    # -- main path 2: the port's train driver at full width -----------------
    train_line, train_counts = train_phase(torch, train_mod, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 3: the same driver loop through the flash kernels --------
    flash_line, flash_counts = train_flash_phase(torch, train_mod, smi,
                                                 train_line)
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 4: the train driver on mamba2-2.7b (the SSD scan) --------
    mamba2_line, mamba2_counts = train_mamba2_phase(torch, train_mod, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 5: the train driver's default, zebra replicated ----------
    zebra_line, zebra_counts = train_zebra_phase(torch, train_mod, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 6: zebra alltoall, 2 chunks, 2 offloaded experts ---------
    a2a_line, a2a_counts = zebra_a2a_phase(torch, train_mod, smi)
    gc.collect()
    torch.cuda.empty_cache()
    zebra_equal = zebra_equal_phase(torch, train_mod, smi, train_line)
    zebra_streams = zebra_streams_phase(torch, train_mod)
    gc.collect()
    torch.cuda.empty_cache()

    # -- main paths 7, 8: the zebra MPMD engine, planned, at Q 1 and Q 2 ----
    mpmd_line, mpmd_counts = mpmd_phase(torch, smi, 1)
    gc.collect()
    torch.cuda.empty_cache()
    chunks_line, chunks_counts = mpmd_phase(torch, smi, 2)
    gc.collect()
    torch.cuda.empty_cache()
    mpmd_equal = mpmd_equal_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    mpmd_streams = mpmd_streams_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 8b: the engine across ranks, attention rank 0 and lane 0 of 4x4 --
    ranks_line = mpmd_ranks_phase(torch, smi, mpmd_line)
    print("mpmd_ranks: " + json.dumps(ranks_line), flush=True)

    # -- main paths 9-12: the training driver's infrastructure and options --
    ckpt_line, ckpt_counts = train_ckpt_phase(torch, train_mod, smi)
    print("train_ckpt: " + json.dumps(ckpt_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    accum_line, accum_counts = train_accum_phase(torch, train_mod, smi)
    print("train_accum: " + json.dumps(accum_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    dots_line, dots_counts = remat_dots_phase(torch, train_mod, smi)
    print("remat_dots: " + json.dumps(dots_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    compress_line = compress_phase(torch, smi)
    print("compress: " + json.dumps(compress_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    trace_line, trace_counts = train_trace_phase(torch, train_mod, smi,
                                                 zebra_line)
    print("train_trace: " + json.dumps(trace_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 12b: the training mesh, --mesh 1x1 (and 1xn, nx1) -------
    mesh_line, mesh_counts = train_mesh_phase(torch, train_mod, smi)
    print("train_mesh: " + json.dumps(mesh_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 12c: one rank of --mesh 1x6 (sequence parallel, heads split) -------
    sp_line = train_sp_phase(torch, smi)
    print("train_sp: " + json.dumps(sp_line), flush=True)
    # -- 12d: the dry run on fake ranks (nothing launched on the card) -----
    dryrun_line = dryrun_phase(torch, smi, zebra_line, mesh_line)
    print("dryrun: " + json.dumps(dryrun_line), flush=True)

    # -- the train path's kernels at the train shapes, and the gradients ----
    w1 = registry.get_config("mixtral-w1")
    batch, seq = train_line["batch"], train_line["seq"]
    entries += check_train_kernels(torch, w1, batch * seq)
    torch.cuda.empty_cache()
    grad = grad_phase(torch, w1, batch * seq)
    torch.cuda.empty_cache()
    grad_bf16 = grad_bf16_phase(torch, w1, batch * seq)
    torch.cuda.empty_cache()
    flash_entries, flash_cases = check_flash_kernels(torch, w1, batch, seq)
    entries += flash_entries
    torch.cuda.empty_cache()
    flash_grad = flash_grad_phase(torch, w1, batch, seq)
    flash_grad_bf16 = flash_grad_bf16_phase(torch, w1, batch, seq)
    torch.cuda.empty_cache()
    c1_tiles = c1_tiles_phase(torch)
    zebra_tiles = zebra_tiles_phase(torch, w1, {"train_zebra": zebra_counts,
                                                "zebra_a2a": a2a_counts})
    mamba2 = registry.get_config("mamba2-2.7b")
    ssd_entry, ssd_cases = check_ssd_kernel(torch, mamba2,
                                            mamba2_line["batch"],
                                            mamba2_line["seq"])
    entries.append(ssd_entry)
    ssd_grad = ssd_grad_phase(torch, mamba2)
    gc.collect()
    torch.cuda.empty_cache()

    # -- main paths 13-15: the recurrent archs (RG-LRU and SSD mixers) ------
    rgemma_line, rgemma_counts = serve_rgemma_phase(torch, serve_mod, smi)
    print("serve_rgemma: " + json.dumps(rgemma_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    m2_serve_line, m2_serve_counts = serve_mamba2_phase(torch, serve_mod,
                                                        smi)
    print("serve_mamba2: " + json.dumps(m2_serve_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    rmesh_line, rmesh_counts = serve_mesh_recurrent_phase(torch, serve_mod,
                                                          smi)
    print("serve_mesh_recurrent: " + json.dumps(rmesh_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    rg_train_line, rg_train_counts = train_rgemma_phase(torch, train_mod,
                                                        smi)
    print("train_rgemma: " + json.dumps(rg_train_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    scan_line = rglru_scan_phase(torch, smi)
    print("rglru_scan: " + json.dumps(scan_line), flush=True)
    paged_rgemma = paged_rgemma_phase(torch)
    print("paged_rgemma: " + json.dumps(
        [{k: e.get(k) for k in ("name", "design", "shapes", "max_abs_err",
                                "tol", "ok", "ms", "host_ms", "plain_ms",
                                "bound_ms", "bound_by")}
         for e in paged_rgemma]), flush=True)
    paged_cases += paged_rgemma

    # -- main paths 16-18: cross-attention (whisper-tiny, llama-3.2-vision) -
    (whisper_line, whisper_counts, whisper_flash_line, whisper_flash_counts,
     whisper_shapes) = train_whisper_phase(torch, train_mod, smi)
    print("train_whisper: " + json.dumps(whisper_line), flush=True)
    print("train_whisper_flash: " + json.dumps(whisper_flash_line),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    xattn_cases = check_xattn_flash(torch, whisper_shapes)
    flash_cases += xattn_cases
    gc.collect()
    torch.cuda.empty_cache()
    sw_line, sw_counts = serve_xattn_phase(torch, serve_mod, smi, WHISPER)
    print("serve_whisper: " + json.dumps(sw_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    sv_line, sv_counts = serve_xattn_phase(torch, serve_mod, smi, VISION,
                                           VISION_LAYERS)
    print("serve_vision: " + json.dumps(sv_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    lmesh_line, lmesh_counts = serve_mesh_lockstep_phase(torch, serve_mod,
                                                         smi)
    print("serve_mesh_lockstep: " + json.dumps(lmesh_line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    recurrent_counts = {
        **{f"serve_rgemma_{k}": c for k, c in rgemma_counts.items()},
        **{f"serve_mamba2_{k}": c for k, c in m2_serve_counts.items()},
        "train_rgemma": rg_train_counts,
        "train_whisper": whisper_counts,
        "train_whisper_flash": whisper_flash_counts,
        "serve_whisper": sw_counts, "serve_vision": sv_counts,
        **{f"serve_mesh_recurrent_{a}": c for a, c in rmesh_counts.items()},
        **{f"serve_mesh_lockstep_{a}": c for a, c in lmesh_counts.items()}}
    for e in entries:  # launches: the sum over the main-path runs
        c = e.get("counter", e["name"])
        e["launches_by_path"] = {
            "serve": serve_counts.get(c, 0),
            "serve_prefix": prefix_counts.get(c, 0),
            "serve_disagg": disagg_counts.get(c, 0),
            "serve_disagg_prefix": dprefix_counts.get(c, 0),
            "serve_trace": strace_counts.get(c, 0),
            "serve_dense": dense_counts.get(c, 0),
            "serve_fleet": fleet_counts.get(c, 0),
            "serve_ep": ep_counts.get(c, 0),
            "serve_ep_dense": ep_dense_counts.get(c, 0),
            "serve_ep_disagg": ep_disagg_counts.get(c, 0),
            **{f"serve_mesh_{m}": n.get(c, 0)
               for m, n in smesh_counts.items()},
            "train": train_counts.get(c, 0),
            "train_flash": flash_counts.get(c, 0),
            "train_mamba2": mamba2_counts.get(c, 0),
            "train_zebra": zebra_counts.get(c, 0),
            "zebra_a2a": a2a_counts.get(c, 0),
            "train_mpmd": mpmd_counts.get(c, 0),
            "mpmd_chunks": chunks_counts.get(c, 0),
            "mpmd_ranks": sum(ranks_line[role]["counts"].get(c, 0)
                              for role in ("attention", "lane")),
            "train_ckpt": ckpt_counts.get(c, 0),
            "train_accum": accum_counts.get(c, 0),
            "remat_dots": dots_counts.get(c, 0),
            "train_trace": trace_counts.get(c, 0),
            "train_mesh": mesh_counts.get(c, 0),
            **{k: n.get(c, 0) for k, n in recurrent_counts.items()}}
        e["launches"] = sum(e["launches_by_path"].values())
    bad = [e["name"] for e in entries if not e["ok"]] + [
        f"{e['name']}@{e['shapes']['case']}"
        for e in flash_cases + ssd_cases + paged_cases if not e["ok"]]
    # the bf16 grouped GEMMs and GLU, f32 x bf16 and f32 x bf16^T, gmm_dw,
    # the bf16 flash kernels and the bf16 SSD scan run on the tensor cores
    bad += [f"{e['name']}@{e['shapes'].get('case', '')}: design "
            f"{e['design']}" for e in entries + flash_cases + ssd_cases
            if e["design"] != "wgmma" and (
                e["name"].startswith(("gmm:bf16.bf16->", "gmm_dw:",
                                      "gmm_glu", "gmm:f32.bf16"))
                or (e["name"].startswith(("flash_", "ssd"))
                    and e["shapes"]["dtype"] == "bfloat16"))]

    steps = summary["paged"]
    serve_line = {
        "arch": "mixtral-w2", "device": name, "nvidia_smi": smi,
        "requests": summary["n_requests"],
        "tokens": summary["n_generated_tokens"],
        "tokens_per_s": summary["tokens_per_s"],
        "ttft_p50_s": summary["ttft_s"]["p50"],
        "itl_p50_s": summary["itl_s"]["p50"],
        "prefill_chunks": steps["prefill_chunks"],
        "decode_steps": steps["decode_steps"],
        "launches": launches, "allocator_check": "clean",
        "design_launches": {k: serve_counts[k] for k in
                            kernels.design_launch_counts()},
        "page_peak": steps["page_peak"], "preempted": steps["n_preempted"]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": name, "nvidia_smi": smi, "build_s": build_s,
        "sass_hgmma": hgmma, "nvcc_reports": _build.build_logs(),
        "kernels": entries,
        "serve": serve_line, "parity": parity,
        "serve_prefix": prefix_line, "serve_disagg": disagg_line,
        "serve_disagg_prefix": dprefix_line, "serve_trace": strace_line,
        "serve_dense": dense_line, "serve_fleet": fleet_line,
        "serve_ep": ep_line, "ep_tiles": ep_tiles,
        "serve_mesh": smesh_line, "paged_lse": paged_lse,
        "train": train_line,
        "train_flash": flash_line, "train_mamba2": mamba2_line,
        "grad": grad, "grad_bf16": grad_bf16, "flash_grad": flash_grad,
        "flash_grad_bf16": flash_grad_bf16, "c1_tiles": c1_tiles,
        "paged_cases": [paged_entry] + paged_cases,
        "train_zebra": zebra_line, "zebra_a2a": a2a_line,
        "zebra_equal": zebra_equal, "zebra_streams": zebra_streams,
        "zebra_tiles": zebra_tiles, "train_mpmd": mpmd_line,
        "mpmd_chunks": chunks_line, "mpmd_equal": mpmd_equal,
        "mpmd_streams": mpmd_streams, "mpmd_ranks": ranks_line,
        "train_ckpt": ckpt_line,
        "train_accum": accum_line, "remat_dots": dots_line,
        "compress": compress_line, "train_trace": trace_line,
        "train_mesh": mesh_line, "train_sp": sp_line,
        "serve_tp": tp_line, "dryrun": dryrun_line,
        "flash_cases": flash_entries + flash_cases,
        "ssd_cases": ssd_cases, "ssd_grad": ssd_grad,
        "serve_rgemma": rgemma_line, "serve_mamba2": m2_serve_line,
        "train_rgemma": rg_train_line, "rglru_scan": scan_line,
        "train_whisper": whisper_line,
        "train_whisper_flash": whisper_flash_line,
        "serve_whisper": sw_line, "serve_vision": sv_line,
        "serve_mesh_recurrent": rmesh_line,
        "serve_mesh_lockstep": lmesh_line}, indent=1))

    contract = ("name", "route", "design", "source", "replaces", "launches",
                "max_abs_err", "ms", "host_ms", "fma_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
    print("kernel tolerances: " + json.dumps(
        {e["name"]: e["tol"] for e in entries}), flush=True)
    print(json.dumps({"kernels": [{k: e.get(k) for k in contract}
                                  for e in entries]}), flush=True)
    print("serve: " + json.dumps(serve_line), flush=True)
    print("parity: " + json.dumps(parity), flush=True)
    print("train: " + json.dumps(train_line), flush=True)
    print("train_flash: " + json.dumps(flash_line), flush=True)
    print("train_mamba2: " + json.dumps(mamba2_line), flush=True)
    print("grad: " + json.dumps(grad), flush=True)
    print("grad_bf16: " + json.dumps(grad_bf16), flush=True)
    print("flash_grad: " + json.dumps(flash_grad), flush=True)
    print("flash_grad_bf16: " + json.dumps(flash_grad_bf16), flush=True)
    print("c1_tiles: " + json.dumps(c1_tiles), flush=True)
    print("paged_cases: " + json.dumps(
        [{k: e.get(k) for k in ("name", "design", "shapes", "max_abs_err",
                                "tol", "ok", "ms", "host_ms", "plain_ms",
                                "bound_ms", "bound_by")}
         for e in [paged_entry] + paged_cases]), flush=True)
    print("flash_cases: " + json.dumps(
        [{k: e.get(k) for k in ("name", "design", "shapes", "errors", "ok",
                                "ms", "host_ms", "fma_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "launches")}
         for e in flash_entries + flash_cases]),
          flush=True)
    print("ssd_cases: " + json.dumps(
        [{k: e[k] for k in ("name", "design", "source", "shapes", "errors",
                            "ok", "ms", "host_ms", "fma_ms", "plain_ms",
                            "bound_ms", "bound_by")}
         for e in ssd_cases]), flush=True)
    print("ssd_grad: " + json.dumps(ssd_grad), flush=True)
    zebra_keys = ("arch", "zebra", "zebra_engine", "ms_per_step",
                  "tokens_per_s", "max_memory_allocated",
                  "launches_per_layer_step", "step_ms", "loss", "grad_norm",
                  "design_launches")
    for label, line in (("train_zebra", zebra_line), ("zebra_a2a", a2a_line)):
        print(f"{label}: " + json.dumps({k: line[k] for k in zebra_keys}),
              flush=True)
    print("zebra_equal: " + json.dumps(zebra_equal), flush=True)
    print("zebra_streams: " + json.dumps(zebra_streams), flush=True)
    print("zebra_tiles: " + json.dumps(
        [{k: e[k] for k in ("name", "layout", "design", "block_m", "tile_m",
                            "max_abs_err", "tol", "ok", "ms", "host_ms",
                            "ms_block_m128", "bound_ms", "bound_by",
                            "launches", "shapes")}
         for e in zebra_tiles]), flush=True)
    for label, line in (("train_mpmd", mpmd_line),
                        ("mpmd_chunks", chunks_line),
                        ("mpmd_equal", mpmd_equal),
                        ("mpmd_streams", mpmd_streams)):
        print(f"{label}: " + json.dumps(line), flush=True)
    bad += [f"paged_lse@{c['case']}" for c in paged_lse if not c["ok"]]
    if not smesh_line["ok"]:
        bad.append("serve_mesh: the 1x1 mesh run is not bitwise the "
                   "one-device engine's, launched a collective or missed "
                   "a kernel")
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions "
                           f"beyond their tolerance, or ran on the wrong "
                           f"design: {bad}")
    if not parity["ok"]:
        raise RuntimeError("paged engine logits disagree with the "
                           "cache-free forward under the f32 policy, or the "
                           "prompt did not span several chunks")
    for line in (train_line, flash_line, mamba2_line, zebra_line, a2a_line):
        want = line["launches_expected"]
        if want != {k: line["launches"][k] for k in want}:
            raise RuntimeError(f"train launches ({line['arch']}, "
                               f"{line['attn_impl']}) {line['launches']} "
                               f"differ from the expected {want}")
    gap = flash_line["step1_rel_gap_vs_chunked"]
    if max(gap.values()) > FLASH_GAP:
        raise RuntimeError(f"flash train run's step 1 differs from the "
                           f"chunked run's by more than {FLASH_GAP}: {gap}")
    if not grad["ok"]:
        raise RuntimeError("MoE FFN gradients disagree with autograd through "
                           "the plain composition beyond their tolerance")
    if not grad_bf16["ok"]:
        raise RuntimeError("bf16 MoE FFN gradients disagree with autograd "
                           "through the plain composition beyond the bf16 "
                           "tier, or a GLU or f32 x bf16^T launch missed "
                           "the tensor-core design")
    if not flash_grad["ok"]:
        raise RuntimeError("flash attention gradients disagree with "
                           "autograd through the oracle beyond their "
                           "tolerance")
    if not flash_grad_bf16["ok"]:
        raise RuntimeError("bf16 flash attention gradients disagree with the "
                           "plain backward beyond the bf16 tier, or a launch "
                           "missed the tensor-core design")
    if not c1_tiles["ok"]:
        raise RuntimeError("a grouped kernel at block_m 8/16/32 disagrees "
                           "with its plain version or did not launch")
    if not ssd_grad["ok"]:
        raise RuntimeError("the SSD Function on the card disagrees with the "
                           "same Function on the CPU beyond its tolerance")
    if not zebra_equal["ok"]:
        raise RuntimeError(f"a zebra mode without drops differs from the "
                           f"--no-zebra step 1 by more than {ZEBRA_GAP}, or "
                           f"chose another capacity, block_m or launch "
                           f"count: {zebra_equal}")
    if not zebra_streams["ok"]:
        raise RuntimeError(f"the two-stream zebra step is not bitwise equal "
                           f"to its rerun or differs from the one-stream "
                           f"run beyond the f32 tier: {zebra_streams}")
    if not mpmd_equal["ok"]:
        raise RuntimeError(f"the MPMD step without drops routes more than "
                           f"{MPMD_FLIPS} tokens otherwise than a "
                           f"reference, differs from a reference beyond "
                           f"the f32 tier (f32), from the fused W1 beyond "
                           f"{MPMD_GAP} (bf16 loss) or {MPMD_BF16_LEAF} * "
                           f"max (bf16 leaves), or chose another capacity "
                           f"or block_m: {mpmd_equal}")
    if not mpmd_streams["ok"]:
        raise RuntimeError(f"the multi-stream MPMD step is not bitwise equal "
                           f"to its rerun or differs from the one-stream "
                           f"run beyond the f32 tier: {mpmd_streams}")
    for label, line, what in (
            ("serve_prefix", prefix_line, "a request did not finish, the "
             "cache did not hit, skip 192 tokens or fork a page, a pool or "
             "index was not clean, or an f32 prefix-hit's first-token "
             "logits differ from the cache-free forward beyond "
             f"{PARITY_REL} * max"),
            ("serve_disagg", disagg_line, "a request did not finish, an "
             "allocator was not clean, nothing was preempted, the transfer "
             "count is not requests + re-prefills, a shipped leaf is not "
             "page-granular, or a first-token logit differs from the "
             f"unified engine's beyond {PARITY_REL} * max"),
            ("serve_disagg_prefix", dprefix_line, "no full hit, a transfer "
             "count other than requests - full hits + re-prefills, or a "
             "pool not empty after the flush"),
            ("serve_trace", strace_line, "a traced run failed, traced no "
             "event, printed no idle line, changed the greedy tokens, or "
             "its signature differs from its rerun's"),
            ("serve_dense", dense_line, "a request did not finish, a GLU or "
             "gmm launch missed (or a paged decode launch happened), or an "
             "f32 first-token logit differs from the paged engine's beyond "
             f"{DENSE_REL} * max"),
            ("serve_fleet", fleet_line, "a request did not finish, a pool "
             "leaked or held pages after the drain, no flip or death "
             "happened, a dropped worker (and its pool) outlived the run "
             "or device memory the fleet, or the f32 tokens diverge from "
             "the unified engine's at a top-2 margin above "
             f"{F32_TIER} * max|logit|"),
            ("serve_ep", ep_line, "(a) a request did not finish, a GLU, "
             "gmm or paged decode count other than the EP hop's, a launch "
             "off the tensor-core design or a decode GLU off block_m 8; "
             "(b) an f32 first-token logit beyond "
             f"{PARITY_REL} * max of the replicated engine's or a "
             f"divergence at a top-2 margin above {F32_TIER} * max; (c) not "
             "one re-balance, a token other than (b)'s, or pages left; (d) "
             "a request did not finish or a paged decode launch; (e) a "
             "request did not finish or no EMA update"),
            ("train_ckpt", ckpt_line, "the resumed steps 3-4 or the state "
             "after step 4 differ from the straight run's bits"),
            ("train_accum", accum_line, "a loss or grad norm is not finite, "
             f"or step 1 differs from accum_steps=1 by more than "
             f"{ZEBRA_GAP}"),
            ("remat_dots", dots_line, "the dots step differs from the full "
             "step's bits"),
            ("compress", compress_line, "an int8 tensor, scale or residual "
             "differs from the CPU's bits, or the one-rank psum is not the "
             "dequantized tree"),
            ("train_trace", trace_line, "the traced run failed, printed no "
             "zebra-sim or idle line, traced no event, or its losses differ "
             "from the untraced run's bits"),
            ("train_mesh", mesh_line, "the --mesh 1x1 mesh program's losses "
             f"or a param leaf after step 3 differ from the one-process "
             f"program's beyond {MESH_TIER} (of the loss, of max|leaf|), it "
             "launched a collective, its bytes differ from the rules' "
             "block shapes, or a 1xn / nx1 run's losses differ from it "
             f"beyond {MESH_BF16_TIER}"),
            ("mpmd_ranks", ranks_line, "attention rank 0 or lane 0 of the "
             "fake 4x4 world launched other expert GEMMs than MPMD_CALL per "
             "call (the lane: the one-process engine's lane launches over "
             "N), off the tensor-core design, an expert call at other than "
             "a lane's [E_lane, C_chunk, d] (the lane) or at it (the "
             "attention rank), an attention call at other than 1 x 256, a "
             "peak not below the one-process engine's, or a loss not "
             "finite"),
            ("dryrun", dryrun_line, "the 1x1 dry run of train_zebra's "
             "configuration called other kernels or designs per step "
             "than the real steps launched, its param or optimizer bytes "
             "differ from train_mesh's, a production cell failed, or the "
             "card's total memory would change a record's fits_80gb"),
            ("train_sp", sp_line, f"rank {SP_RANK} of the fake 1x{SP_M} "
             f"world ran an attention call at other than {SP_HEADS} heads "
             f"(chunked or flash), a block's checkpoint kept other than "
             f"{SP_KEPT}, its flash launches were not {SP_FLASH_LAUNCHES} "
             "per layer and step, or its peak memory was not below the "
             "1x1 run's"),
            ("serve_tp", tp_line, f"rank {TP_RANK} of the fake 1x{TP_M} "
             f"world left a request unfinished, ran an attention call at "
             f"other than {TP_HEADS} heads, an FFN at other than {TP_FFN} "
             f"columns or an unembedding block at other than {TP_VOCAB}, "
             "decoded other than the 1x1 run's steps, launched other than "
             f"{TP_LAYERS} paged decodes a decode step (paged; 0 dense), or "
             "its peak memory was not below the 1x1 run's"),
            ("serve_rgemma", rgemma_line, "a request did not finish, an "
             "allocator was not clean, the paged decode launches are not 12 "
             "a decode step in the paged and disagg runs and 0 in the dense "
             "one, the transfers are not requests + re-prefills, an f32 "
             f"first-token logit is beyond {PARITY_REL} * max of the "
             f"cache-free forward or the dense one beyond {DENSE_REL} * max "
             "of the paged one, or the f32 dense and paged tokens diverge "
             f"at a top-2 margin above {F32_TIER} * max|logit|"),
            ("serve_mamba2", m2_serve_line, "a request did not finish, an "
             "allocator was not clean, a transfer shipped KV bytes or a "
             "checksum other than 0 (the CRC of an empty payload), the "
             "transfers are not requests + re-prefills, or an f32 "
             f"first-token logit is beyond {PARITY_REL} * max of the "
             "cache-free forward"),
            ("train_rgemma", rg_train_line, "a loss or grad norm is not "
             "finite"),
            ("train_whisper", whisper_line, "a hand-written kernel launched "
             "on the chunked path"),
            ("train_whisper_flash", whisper_flash_line, "the flash launches "
             "are not exactly fwd 2, dq 1, dk/dv 1 per attention call and "
             "step at each shape, or step 1 differs from the chunked run's "
             f"by more than {FLASH_GAP}"),
            ("serve_whisper", sw_line, "the lockstep run failed, the f32 "
             f"first-token logits are beyond {PARITY_REL} * max of the "
             "cache-free forward, the gate does not move them, or the f32 "
             "tokens diverge from the forward's at a top-2 margin above "
             f"{F32_TIER} * max|logit|"),
            ("serve_vision", sv_line, "the lockstep run failed, the f32 "
             f"first-token logits are beyond {PARITY_REL} * max of the "
             "cache-free forward, the gate does not move them, or the f32 "
             "tokens diverge from the forward's at a top-2 margin above "
             f"{F32_TIER} * max|logit|"),
            ("rglru_scan", scan_line, "the doubling scan differs from the "
             "sequential loop beyond 1e-5 * max|loop|"),
            ("serve_mesh_recurrent", rmesh_line, "a request did not "
             "finish, a --mesh 1x1 run's tokens or f32 logit rows are not "
             "bitwise the one-device engine's, it launched a collective, "
             "its launches differ from the one-device run's, or the paged "
             "decode launches are not 12 a decode step"),
            ("serve_mesh_lockstep", lmesh_line, "a lockstep run failed, a "
             "--mesh 1x1 run's tokens or prefill logits are not bitwise "
             "the one-device server's, it launched a collective, or its "
             "launches differ from the one-device run's")):
        if not line["ok"]:
            raise RuntimeError(f"{label}: {what}")
    bad_tiles = [f"{e['name']}@{e['layout']}" for e in zebra_tiles + ep_tiles
                 if not e["ok"]]
    if bad_tiles:
        raise RuntimeError(f"grouped kernels at the zebra or EP row tiles "
                           f"disagree with their plain versions or missed "
                           f"the tensor-core design: {bad_tiles}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
