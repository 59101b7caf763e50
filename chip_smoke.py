#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. the card: its name and power limit from ``nvidia-smi``;
2. build: the CUDA kernels, from ``src/repro_torch/kernels/csrc``, with
   ``nvcc`` for ``sm_90a`` into ``build/`` (one ``nvcc`` per source, in
   parallel); ptxas's registers and spills per kernel;
3. kernels vs plain: the fused LAMB kernels K1 (``lamb_moments``) and K2
   (``lamb_apply``) against their plain PyTorch version on the same inputs,
   at BERT-large leaf shapes, and with the non-finite guard's flag ``ok``:
   0 (x, m and v bit-identical, Σ(x'−x)² 0, as in the plain version) and 1
   (the bits of the call without a flag); the flash-attention kernels K3 (``flash_fwd``),
   K4 (``flash_dq``) and K5 (``flash_dkv``), forward and backward through
   the autograd boundary, against the plain version at the main path's
   shape, at seq 512 and under causal, window, ragged-length, GQA,
   cross-length, model-layout and head-dim 16, 32, 128 and 256 cases, at
   head dims 40 and 80, which ``flash_attention`` zero-pads to the
   kernels' next, and past 256 at 320, 512 and 576 on the wide kernels
   (320 and 576 padded to 384 and 640; causal and bidirectional, GQA,
   ragged lengths, a window) (bf16 K3, K4 and K5 on the tensor cores, fp32
   on the FMA kernels), and K4 and K5 run twice for equal bits; the fused CE kernels K6
   (``fused_ce_fwd``), K7 (``fused_ce_dh``) and K8 (``fused_ce_dw``), forward
   and backward through the autograd boundary, against the plain version at
   the main path's shape, at seq 512, with ragged rows, vocab and D, at D
   1280, 2048 and 2056 (past one 1024-column window), in the
   model's layout, in fp32, with zero cotangents and with all-zero rows
   (ties) (bf16 K6, K7 and K8 on the tensor cores, fp32 and bf16 rows off
   a 16-byte boundary on the FMA kernels), and K7 and K8 run twice for equal
   bits;
4. reference: two bert-smoke fp32 train steps with flash attention and the
   fused CE head on the card against the same steps on the CPU (the CPU path
   is the plain version the test suite holds to the JAX package);
5. main path: ``repro_torch.launch.train`` on full-width BERT-large
   (24 layers, d 1024, vocab 30522), batch 64 × seq 128, accum 2, bf16,
   fused LAMB, flash attention, fused CE head, 6 steps; finite losses, moved
   weights, every LAMB kernel launched 13 leaves × 6 steps times, every flash
   kernel 24 layers × 2 micro-batches × 6 steps times and every fused CE
   kernel 2 micro-batches × 6 steps times, every K3–K8 launch on the
   tensor-core kernel and no copy of ``do``; then 3 steps at seq 512
   (batch 32, accum 2) with their own counts;
6. timing with CUDA events: K1 and K2 over one full BERT-large update
   (also with the guard's flag), and K3–K8 at the main path's shape and at seq 512, each beside its plain
   version and its bound; ``scaled_dot_product_attention`` (beside K3–K5)
   and the dense head's ``matmul`` + ``cross_entropy`` pair (beside K6–K8)
   are timed as yardsticks only (the port never calls them); bf16 K6, K7
   and K8 also in their FMA design;
7. this slice's path at full width: the §4.1 two-stage run
   (``--mixed-batch``: 4 steps at seq 128 and batch 64, then 2 at seq 512
   and batch 16 on the same optimizer state) with the non-finite guard on,
   its counters and launch counts; the guard on the card (a ``grad_nan``
   step leaves params, moments and counters bit-identical, K1/K2 still
   launched); and a 4.0 GB checkpoint: written async after 2 steps,
   restored bit for bit by a fresh trainer with ``--resume``, continued to
   4 steps bit-equal to an uninterrupted run, with the sync and async save
   times;
8. the unfused optimizers at full width (after phase 7, before phase 6's
   timings): the gradients of one main-path step applied from one state by
   fused-direct LAMB, the ``core.lamb`` chain and the ``fused_lamb``
   transform, every param and moment within the reference's fused-against-
   unfused bound (rtol 2e-4, atol 2e-5); 3 steps through the launcher's
   Trainer for each of the nine optimizers (and fused LAMB) with
   ``--log-trust-ratios``, their losses, norms and trust-ratio summaries,
   launch counts (no K1/K2 on a chain), the first update's lr·‖x‖ per
   layer slice for LAMB, N-LAMB, NN-LAMB and LARS, and finite losses for
   the clipped or scale-free ones (not for LARS and momentum, which the
   reference gives no clip); a ``grad_nan`` step bit-identical on unfused
   LAMB and on LARS, the two-stage run on LANS (schedule counter restarted,
   moment counter carried), and a LARS state saved, restored and resumed
   bit-equal;
9. the rest of training at full width (after phase 8, before phase 6's
   timings): (a) the main path with ``--telemetry-dir``, losses, update
   norms and launch counts bit-identical to phase 5's, and with
   ``--log-trust-ratios`` too: valid events, one ``trust_ratios`` event a
   step with every leaf's per-layer ratios equal to K2's, a
   ``RUN_REPORT.json`` naming the card; (b) a ``loss_spike`` rollback to an
   async checkpoint, ending bit-equal to the run without the dropped
   batches; (c) momentum diverging under ``--rollback-on-spike``: the
   launcher exits 3 with status ``diverged``; (d) SIGTERM under
   ``--preempt-grace``: saved at the stopped step and resumed bit-equal to
   phase 7's uninterrupted run; (e) ``remat="full"``: bit-equal, K3 once
   more per layer and micro-batch, a lower peak; then the main path's step
   timed with nothing, telemetry, telemetry + trust records, the
   supervisor armed and remat, in turns, two rounds.  Checkpoints go
   under ``build/`` (at most two of 4.0 GB at once), removed as each check
   ends;
10. serving smollm-360m at full width (32 layers, d 960, 15 heads over 5,
   vocab 49152, bf16, random weights from seed 0; after phase 9, before
   phase 6's timings): (a) 8 prompts of 128 tokens, 32 new tokens greedy,
   through the static ``Engine`` and ``ContinuousEngine`` over 4 slots:
   where two sequences part, the static run's top-2 margin is within
   MARGIN_ULPS bf16 ulps; (b) the continuous run with flash attention on:
   K3 launched 32 layers × prefills times, all on the tensor cores, no
   other kernel; each of K3's prefill calls within a bf16 ulp of its plain
   version on the same q, k, v; (c) temperature 0.8
   and top-k 40 beside greedy rows: reproducible by seed, every draw in
   its row's top-k, greedy rows as in (a); (d) the launcher with injected faults and
   a stall SLO: one terminal state a request, valid events, a
   ``RUN_REPORT.json`` naming the card; (e) ``python -m
   repro_torch.launch.serve`` at 8 slots, 32 requests, as a subprocess; (f)
   prefill (dense and K3) and decode-step times, wall, event span, busy
   time, launches and idle share, one sync a decode step, an engine run's
   tokens/s, TTFT and latency, peak memory and the pool's bytes, two
   rounds in turns, and K3 alone at the serving shape beside its plain
   version, its bound and SDPA's forward;
11. granite-moe-1b-a400m at full width (24 layers, d 1024, 16 heads over
   8, 32 experts top-8, vocab 49155, bf16, random weights from seed 0;
   after phase 10, before phase 6's timings): (a) ``repro_torch.launch.train``
   at batch 16 × seq 512, accum 2, fused LAMB, flash and the fused CE head,
   4 steps: finite losses, ``loss/moe_lb`` and ``moe/drop_fraction`` in
   every row, moved weights, K1/K2 12 leaves × 4, K3–K5 24 × 2 × 4 and
   K6–K8 2 × 4 launches, all bf16 K3–K8 on the tensor cores; (b) the 8
   prompts of 128 tokens, 32 new greedy tokens, through the static
   ``Engine`` and the ``ContinuousEngine`` over 4 slots with flash on: K3
   24 × prefills launches and each call within a bf16 ulp of its plain
   version, each prefill's drop fraction, sequences compared where both
   engines' prefills dropped nothing, every prefill's last logits held to
   the forward on the same tokens; (c) the step timed (two rounds: wall,
   span, busy by group, launches, idle share, peak), the MoE layer's
   dispatch, expert products and combine forward and backward at the
   step's shape, a 128-token prefill with K3 and a decode step over 8
   slots;
12. the recurrent families (after phase 11, before phase 6's timings): (a)
   ``repro_torch.launch.train`` on xlstm-350m at full width (24 layers, d
   1024, 4 heads, up-projection 2048, vocab 50304, bf16, random weights from
   seed 0) at batch 16 × seq 256 (cut from 512 for the sLSTM's per-step
   launches; the width is not cut), accum 2, fused LAMB, 3 steps: finite
   losses, moved weights, K1/K2 32 leaves × 3 launches and no other kernel;
   then a step profiled (busy, launches) and two timed (wall, span, idle
   share) with the peak memory; (b) xlstm-350m served: the 8 prompts of
   128 tokens, 32 new greedy tokens, through the static ``Engine`` (a
   request a call) and the ``ContinuousEngine`` over 4 slots (phase 10's
   parting rule), every
   prefill's last logits held to the forward on the same tokens, no kernel
   launched; a prefill and a decode step over 8 slots timed, the pool's
   bytes; (c) jamba-smoke with ``--flash``: 3 training steps with K1/K2
   and K3–K5 at the counts of its one attention layer, then served through
   both engines (the static one a request a call) with K3 on every prefill,
   each call within a bf16 ulp of its plain version; (d) Jamba's Mamba
   layer alone at full width (d 8192, d_inner 16384, d_state 16, d_conv 4,
   dt rank 512) on B 1 × S 256: the parallel scan, the chunked scan (64)
   and token-by-token decode agree (fp32; parallel and chunked also in
   bf16), and the bf16 layer is timed.  Phase 6 then also times K1–K8 at
   granite-moe's shapes, flash at head dims 40, 64, 80, 128 and 256, K3–K5
   at 320, 512 and 576 beside SDPA and their bound, K6–K8 at D 1280 and
   2048, and K1/K2 over xlstm-350m's 32 leaves;
13. deepseek-v3 (after phase 12, before phase 6's timings): (a)
   deepseek-smoke with MTP (one dense block, two MoE blocks with MLA, 48
   leaves) trained 3 steps at batch 8 × seq 64, accum 2, bf16, fused LAMB
   and the fused CE head: finite losses with ``loss/mtp``, moved weights
   (``mtp/*`` and ``dense_blocks/*`` among them), K1/K2 48 × 3 and K6–K8
   2 × 3 launches on the tensor cores, no K3–K5 (the MLA has no flash
   path); the absorbed MLA's first-step loss from the same weights within a
   bf16 ulp of the naive one's; (b) deepseek-v3 at the published widths cut
   to one dense and one 256-expert MoE block (13.94 B params, bf16, from
   seed 0; init time and peak memory): 4 prompts of 64 tokens, 16 new
   greedy tokens, through the static ``Engine`` (a request a call) and the
   ``ContinuousEngine`` over 4 slots, naive and absorbed: prefill logits
   held to the forward, naive against absorbed per layer and by phase 10's
   parting rule, a one-slot run equal to the static run; a prefill and a
   decode step over 8 slots timed beside the decode's weight-read bound,
   the cache's bytes a token, peak memory; (c) its dense block at B 2 × S
   512 forward and backward, naive against absorbed (fp32 and bf16), and
   ``lm_loss`` with the fused head and MTP at D 7168 / V 129280 (K6–K8 once
   each over 7 D windows) held to the dense CE path and timed.  Phase 3
   also holds K1/K2 at deepseek-smoke's leaves and K6–K8 at its
   micro-batch and at D 7168 / V 129280 to their plain versions; phase 6
   times K6–K8 at D 7168 / V 129280.
14. data-parallel FSDP (after phase 13, before phase 6's timings): (a) the
   main path's BERT-large (batch 64 × seq 128, accum 2, bf16, fused LAMB,
   flash, fused CE) through ``repro_torch.launch.train`` with ``--mesh
   data=1,model=1``: the sharded Trainer on a real NCCL group of one rank,
   3 steps, against the same 3 steps without a mesh from the same seed:
   K1–K8 launch counts as phase 5's; losses, grad norms and params
   bit-equal (at one rank the sharded step keeps the order of operations);
   both steps' wall, device span and busy time, launches and peak memory;
   (b) the shard contract of K1/K2: each of BERT-large's 13
   leaves split along its ``data=4`` spec into 4 contiguous slices, K1's
   per-layer partials summed over the slices against K1 on the whole leaf
   (1e-5 relative) and K2 with the shared ratio writing each slice
   bit-equal to the whole leaf's K2; (c) ``per_device_state_bytes`` of
   BERT-large's params, μ and ν at ``data=4/8/16`` (meta tensors), at least
   N/2 times smaller than whole.  Phase 6 also times K1/K2 over a ``data=4``
   slice of every leaf; the ``kernels`` line gives that entry the launches
   of its own timing.
15. tensor parallelism (after phase 14, before phase 6's timings; the card
   is one H100, so a step over M ``model`` ranks runs only on gloo, in the
   CPU tests): (a) K6–K8's vocab-slice contract at BERT-large's head (N
   640, D 1024, V 30522) over model=2 (15,261 rows a slice) and
   smollm-360m's (N 1024, D 960, V 49152) over model=4: each slice on the
   tensor-core design; K6 on each slice with its vocab offset and
   statistics, merged by ``combine_vocab_slices`` (the function the head
   uses, here with the plain reductions over the slices), against the
   whole-vocab K6 within 1e-5 and ``correct`` equal on every row without
   a tied maximum; the slices' K7 partials summed in fp32 within 2 bf16
   ulps of the whole dh; the K8 slices against the whole dw's rows within
   phase 3's bound; (b) K1/K2 on each ``data=2,model=2`` rank's blocks of
   BERT-large's 13 leaves, the partials counted by the world rule
   (``ShardCtx.counts``) and summed within 1e-6 relative of the whole
   leaf's, K2's blocks bit-equal; (c) the main path with ``--mesh
   data=1,model=1`` (one NCCL rank: every tensor-parallel operator is the
   identity) bit-equal to phase 14's unsharded run with its launch counts;
   (d) one rank's tensor-parallel products at BERT-large's MLP over model=2
   (``wi`` column-parallel, ``wo`` row-parallel, 4096 tokens), forward and
   backward, within one bf16 ulp of the fp32 product.  Phase 6 also times
   K6–K8 on one slice of each (a) case beside the whole vocab's kernel,
   K1/K2 over a ``data=2,model=2`` rank's blocks, and (d)'s products beside
   the plain bf16 product and an fp32 GEMM of upcast operands.
16. rollback and preemption over a mesh, GQA on a rank's q heads, MoE data
   blocks (after phase 15, before phase 6's timings; one NCCL rank and its
   gloo host group): (a) phase 9's loss-spike rollback and SIGTERM grace
   save through the launcher with ``--mesh data=1,model=1``: the same
   ``rollback`` and ``preempt`` fields, final params bit-equal to phase
   9's, the resume bit-equal to phase 7's uninterrupted run; the agreed
   flag (a host all-reduce a step) alone under the profiler: its host µs
   and no device kernel or copy, and the step's wall, busy and launches
   with ``--preempt-grace`` against without; (b)
   smollm-360m's attention (15 heads over 5 kv heads, D 64) at B 8 x S 512
   through K3–K5, whole and as each model=3 rank's q heads against their
   global kv heads: o and dq within a bf16 ulp, the ranks' dk/dv partials
   summed in fp32 within 2 ulps; and through the port's ``attention()``
   (d 960, RoPE, flash) under each rank's ``ShardCtx`` on a data=1,model=3
   mesh whose model group is the one-rank NCCL world: the ranks' outputs
   and x/wk/wv gradients summed, and their wq/wo gradients side by side,
   each within 3x the whole bf16 call's distance from an fp32 run, K3–K5
   once a rank; (c) granite-moe-1b-a400m's MoE layer (T
   4096, E 32, top-8, capacity factor 1.0: some experts overflow) whole
   and as four data blocks with the global capacity and the blocks'
   offsets: outputs bit-equal,
   the drop fraction equal, the load-balance loss within 2e-6.  Phase 6
   also times one rank's K3–K5 beside the whole heads' call.
17. expert parallelism, the xLSTM/Mamba ``inner`` axis and MLA heads over
   ``model`` (after phase 16, before phase 6's timings; one card, so a
   step over M ranks runs only on gloo, in the CPU tests): each layer at
   full width in bf16 as M model ranks, each rank the port's own layer on
   its blocks on a thread of ``collectives.run_plain_ranks`` (the
   cross-rank sums and gathers are the plain collectives over the ranks'
   tensors on the card), one backward over the joined graph; every
   output and gradient (the ranks' sums, a split leaf's blocks side by
   side) within 3x the whole bf16 call's distance from an fp32 run: (a)
   granite-moe-1b-a400m's MoE layer (T 4096, E 32, top-8, capacity factor
   1.0) as four ranks' 8 experts, every rank's drop fraction equal to the
   whole layer's and its load-balance loss within 1e-6, and one rank's
   dispatch, experts and combine timed beside the whole layer's; (b)
   K1/K2 on each model=4 rank's blocks of granite-moe-1b's 12 leaves as
   phase 15 (b); (c) deepseek-v3's attention (d 7168, 128 heads, q_lora
   1536, kv_lora 512) at B 2 x S 512, naive and absorbed, as eight ranks'
   16 heads; (d) xlstm-350m's mLSTM and sLSTM blocks at B 4 x S 256 as two
   ranks and Jamba's Mamba layer (d 8192, d_inner 16384) at B 1 x S 256 as
   four.  Phase 6 also times K1/K2 over a model=4 rank's blocks of
   granite-moe-1b's leaves.
18. the dry-run and the roofline (after phase 17, before phase 6's
   timings): the fused CE meta route's vocab-split plan against the
   library's on this card (K6 and K7, both designs, five shapes); (a) the
   main path's step (BERT-large, batch 64 x seq 128, accum 2, bf16, fused
   LAMB, flash, the fused CE head) traced by ``launch/dryrun.py`` on meta
   tensors over an abstract data=1 mesh (nothing allocated on the card),
   then run on the card over a data=1 mesh of one NCCL rank (the same
   path): the traced argument bytes equal to the real state's and batch's
   exactly, every kernel's traced launches equal to one real step's (K1/K2
   13, K3-K5 48, K6-K8 2), the traced peak within 10% of
   ``max_memory_allocated`` over one step, and the profiled busy time at
   least the roofline's max(compute, memory) term; printed: the roofline
   share of busy and 6·N·D over busy and over wall at 989 TFLOP/s; (b)
   two production records run whole and timed on the host: smollm-360m x
   decode_32k and x train_4k on the 256-rank mesh.
19. serving on a mesh (after phase 18, before phase 6's timings; the card
   is one H100, so the ranks are threads of ``collectives.run_plain_ranks``,
   as in phase 17; bf16, random weights from seed 0, flash on): (a)
   granite-moe-1b-a400m at full width served by ``Engine(shard_ctx=)`` as
   four ``model`` ranks (each its parameter blocks and a cache of 2 of the 8
   kv heads), 8 prompts of 128 tokens, 16 greedy tokens, against the
   whole-model Engine: the first decode step's gathered logits within 3x
   the whole bf16 call's distance from an fp32 run; each rank's cache a
   quarter of the whole's; K3 launched 24 layers x 4 ranks times on the
   prefill, all on the tensor-core kernel, each call held against its plain
   version; the bf16 tokens logged by phase 10's parting rule (the
   randomly initialised model carries a rounding difference to the size of
   its logits over its depth, fp32 too: the log shows the fp32 ranks' free
   run and the whole model perturbed by 2^-24 parting alike); and in fp32
   at full depth every rank's block fed the whole run's input, with the
   whole run's MoE top-k sets, each block's output within 1e-4 of the
   whole block's update, the logits likewise (for (b) at the prompt's
   first 8,000 tokens in an 8,192-position cache); (b) smollm-360m at batch 1: a
   32,000-token prompt into a 32,768-position cache split over four
   ``data`` ranks (8,192 positions each), 16 greedy tokens, by (a)'s rules,
   K3 32 x 4 times; the dry-run's
   ``smollm-360m x long_500k`` record ``ok``, its k and v 1/16 of the whole
   cache's; (c) deepseek-v3's MLA (8 ranks of 16 heads, naive and
   absorbed, B 2, prefill 512), xlstm-350m's mLSTM and sLSTM (2 ranks, B
   4, prefill 256) and Jamba's Mamba layer (4 ranks, ``inner`` rule, B 1,
   prefill 256), each then 8 decode steps, every output and final state
   within 3x the whole bf16 call's distance from fp32; (d) K3 on one
   model=4 rank's heads at (a)'s prefill shape (B 8, 4 of 16 q heads, 2 of 8
   kv, S 128, causal) timed beside its plain version, its bound and SDPA.
20. the continuous engine on a mesh (after phase 19, before phase 6's
   timings; the ranks are threads of ``launch.mesh.run_plain_mesh``, each
   mesh with plain groups over data, model and every rank, its host group
   the last; bf16, random weights from seed 0, flash on): (a)
   granite-moe-1b-a400m at full width, 6 of its 24 layers, served by ``ContinuousEngine(
   shard_ctx=)`` over data=2,model=2 (an 8-slot pool of 256 positions, 4
   slots a data rank), 16 seeded prompts of 32-128 tokens, 16 greedy
   tokens each, every arrival at 0, with a NaN sample (request 3), a
   corrupted slot (request 5, quarantined 4 steps) and a stall past the
   watchdog's SLO at step 6 (the SLO 3x the slowest warm mesh step, the
   stall 1.25x the SLO), beside the whole-model ``ContinuousEngine`` on
   the same scenario: every rank's statuses, attempts, reasons and tokens
   alike, its events' kinds and request ids rank 0's and the whole
   engine's, rank 0 alone writing; the terminal counts, retries, quarantines and degraded flag
   the whole engine's; each rank's pool a quarter of the whole's (its k/v;
   the index whole); K3 6 layers x 4 ranks a prefill, retries included,
   all ``mma``, each call held against its plain version; the first
   admission's gathered prefill logits within 3x the whole bf16 call's
   distance from fp32 (token partings from the whole run logged); then in
   fp32, 4 requests through 4 slots (2 a data rank), each block of each
   rank fed the whole engine's input (a decode step's rows the rank's
   block of them) and kept to its top-k sets, as phase 19's check: every
   block within 1e-4 of the whole block's update, every gathered logits
   call (the 4 prefills and the 3 decode steps that give each request 3
   tokens) within 1e-4 of its size; (b) a
   second ``generate`` of 8 requests on (a)'s engines with rank 1's drain
   flag alone up from its 3rd poll and no grace: every rank drains at the
   same iteration and sheds the same requests; (c) smollm-360m at full
   width, one slot under ``cache_seq`` over data=4 (16,384 positions, 4,096
   a rank), a 16,000-token prompt and 8 greedy tokens: the first decode
   step's gathered logits by (a)'s 3x rule, each rank's pool a quarter of
   the whole's; then (a)'s fp32 check on the prompt's first 2,047 tokens in
   a 4,096-position cache (1,024 a rank), the prefill and 2 decode steps,
   the first writing in rank 1's block, the second in rank 2's; (d) the agreed readings per loop iteration and their host
   milliseconds beside (a)'s decode-step wall; K3 on one model=2 rank's
   heads at (a)'s prefill shape (B 1, 8 of 16 q heads, 4 of 8 kv, S 128,
   causal) timed beside its plain version, its bound and SDPA.
21. any parameter layout and the dry-run's loop count (after phase 20,
   before phase 6's timings): (a) K1/K2 on a data=2,model=2 rank's blocks
   of BERT-large's 13 leaves stored under ``--param-rule embed=data,model``
   (``embed`` over data and model together), by phase 15 (b)'s contract,
   each block's kernel against its plain version, and one rank's blocks
   timed beside the bound; (b) BERT-large at full width cut to 8 layers,
   batch 8 x seq 128, bf16, fused LAMB, flash and the fused CE head,
   trained 3 steps by the Trainer over data=2,model=2 thread ranks
   (``launch.mesh.run_plain_mesh``; each rank's backward runs through the
   graph the ranks' plain collectives join) under that rule and then under
   the default rules: step 1's loss bit-equal, steps 2-3 within a bf16 ulp
   of the loss, K3 launched alike; (c) phase 12's xlstm-350m step traced
   by the dry-run with each sLSTM loop counted from three of its steps:
   argument bytes equal to phase 12's state and batch, the peak within
   10% of phase 12's ``max_memory_allocated`` over its timed steps, phase
   12's busy at least the roofline's larger term; then the count against
   the unrolled trace under this machine's torch (2 layers, 64 positions,
   a prefill and a train step on the 256-rank mesh).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN_STEPS = 6
MAIN_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb",
    "--steps", str(MAIN_STEPS), "--log-every", "1",
]
SEQ512_STEPS = 3
SEQ512_ARGV = [
    "--arch", "bert-large", "--batch", "32", "--seq", "512", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb",
    "--steps", str(SEQ512_STEPS), "--log-every", "1",
]
# phase 7: the §4.1 two-stage run (4 steps at seq 128, batch 64, then 2 at
# seq 512, batch 16, re-warmed) with the guard on, and the 4-step runs of the
# checkpoint check (a save after 2 steps, a resume to 4)
STAGES_STEPS = 6
STAGES_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--mixed-batch", "--skip-nonfinite",
    "--steps", str(STAGES_STEPS), "--log-every", "1",
]
RESUME_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--steps", "4", "--log-every", "1",
]
LAYERS, LEAVES, ACCUM = 24, 13, 2
# phase 8: every optimizer through the Trainer at full width (3 steps at seq
# 128, batch 64, accum 2, bf16, flash and the fused CE head on), without
# --fused-lamb: LAMB runs as the transform chain
OPT_STEPS = 3
OPT_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--steps", str(OPT_STEPS), "--log-every", "1",
    "--log-trust-ratios",
]
OPTIMIZERS = ("lamb", "lans", "lars", "nlamb", "nnlamb", "adam", "adamw", "adagrad",
              "momentum")
# the trust-ratio optimizers: a masked-in layer slice's first update has norm lr·‖x‖
TRUST_OPTIMIZERS = ("lamb", "nlamb", "nnlamb", "lars")
# clipped or scale-free: finite losses asserted (LARS and momentum have no clip
# in the reference, and the gradient norm at this init is ~1e11: not asserted)
FINITE_OPTIMIZERS = ("lamb", "lans", "nlamb", "nnlamb", "adam", "adamw", "adagrad")
# the reference's fused-against-unfused bound (tests/test_large_batch.py)
FORMS_TOL = dict(rtol=2e-4, atol=2e-5)

# phase 10: serving smollm-360m at full width: 8 prompts of 128 tokens from
# seed 0 (as launch/serve.py makes them), 32 new tokens each, 4 slots
SERVE_ARCH, SERVE_LAYERS = "smollm-360m", 32
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_SLOTS = 8, 128, 32, 4
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_NEW + 8   # as launch/serve.py sizes its cache
# two greedy runs that part must do so where the top-2 logit margin is within
# this many bf16 ulps of the top logit: the runs' matrix products have other M,
# so cuBLAS may round them in another order
MARGIN_ULPS = 8
SERVE_FAULT_ARGV = [
    "--arch", SERVE_ARCH, "--continuous", "--slots", "4", "--requests", "8",
    "--prompt-len", "128", "--max-new", "32", "--stall-slo", "0.15",
    "--inject-faults", "sample_nan@1,slot_corrupt@2:persist,decode_stall@3:stall=0.2",
]
# phase 11: granite-moe-1b-a400m at full width (24 layers, d 1024, 16 heads
# over 8, 32 experts top-8, vocab 49155), trained and served
MOE_ARCH, MOE_LAYERS, MOE_LEAVES, MOE_STEPS = "granite-moe-1b-a400m", 24, 12, 4
MOE_ARGV = [
    "--arch", MOE_ARCH, "--batch", "16", "--seq", "512", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--flash", "--fused-ce",
    "--steps", str(MOE_STEPS), "--log-every", "1",
]
# phase 12: the recurrent families.  (a)-(b) xlstm-350m at full width (24
# layers, d 1024, 4 heads, up-projection 2048, vocab 50304): trained at batch
# 16 x seq 256, accum 2, fused LAMB (no attention, no fused head: K1/K2
# only), and served; (c) jamba-smoke with flash, trained and served; (d)
# Jamba's full-width Mamba layer alone, on B 1 x S 256.  The sequence is cut
# from 512 to 256 (the width is not): the sLSTM's time loop makes ~1 M
# launches a step at seq 512, ~16-20 s of host dispatch a step on the card,
# and six such steps would take the phase past three minutes
XLSTM_ARCH, XLSTM_LEAVES, XLSTM_STEPS, XLSTM_BATCH, XLSTM_SEQ = "xlstm-350m", 32, 3, 16, 256
XLSTM_ARGV = [
    "--arch", XLSTM_ARCH, "--batch", str(XLSTM_BATCH), "--seq", str(XLSTM_SEQ),
    "--accum-steps", "2", "--precision", "bf16", "--fused-lamb",
    "--steps", str(XLSTM_STEPS), "--log-every", "1",
]
JAMBA_STEPS = 3
JAMBA_ARGV = [
    "--arch", "jamba-1.5-large-398b", "--smoke", "--batch", "8", "--seq", "64",
    "--accum-steps", "2", "--precision", "bf16", "--fused-lamb", "--flash",
    "--steps", str(JAMBA_STEPS), "--log-every", "1",
]
MAMBA_SEQ, MAMBA_CHUNK = 256, 64
# phase 13: deepseek-v3.  (a) deepseek-smoke with MTP (3 layers, the first
# dense; d 128, 4 experts top-2, vocab 512; 48 leaves) trained with fused
# LAMB and the fused CE head at batch 8 x seq 64, accum 2; (b) the published
# widths (d 7168, 128 heads, q_lora 1536, kv_lora 512, rope 64, v 128, dense
# d_ff 18432, 256 experts top-8 of 2048 and a shared one, vocab 129280,
# untied) cut to one dense and one MoE block, bf16 weights, served; (c) its
# dense block at B 2 x S 512 and its loss head with MTP at D 7168, V 129280
DS_ARCH, DS_LEAVES, DS_STEPS = "deepseek-v3-671b", 48, 3
DS_ARGV = [
    "--arch", DS_ARCH, "--smoke", "--batch", "8", "--seq", "64", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--fused-ce",
    "--steps", str(DS_STEPS), "--log-every", "1",
]
DS_REQUESTS, DS_PROMPT, DS_NEW = 4, 64, 16
DS_PIECE_B, DS_PIECE_S = 2, 512
# the zoo's bf16 tolerance (tests/test_torch_serve.py): a few bf16 ulps of
# the tensor's scale, for bf16 paths that round in other places
BF16_TOL = 3e-2
# naive against absorbed MLA in bf16, in units of each tensor's scale: the
# reference casts the scores to fp32 only after the bf16 products, at |s| up
# to ~100 before the 1/sqrt(192) scale, and the two paths round them at other
# places (the absorbed one as s_nope + s_rope); on one full-width MLA layer
# (S 64, on the CPU) each bf16 path lies 1.1-2.4% of the scale from the fp32
# result, outputs and gradients, and the two paths as far from each other
MLA_BF16_TOL = 5e-2
SERVE_LAUNCH_REQUESTS = 32
SERVE_LAUNCH_ARGV = [
    "--arch", SERVE_ARCH, "--continuous", "--slots", "8", "--arrival-rate", "20",
    "--requests", str(SERVE_LAUNCH_REQUESTS), "--prompt-len", "128", "--max-new", "64",
]

# Every bound below is ``launch/roofline.bound`` of a kernel's
# ``kernels/cost.py`` count: the card's memory rate by name and the peak
# operation rates live in ``launch/roofline.py``.

KERNELS = {
    "lamb_moments": dict(route="cuda",
                         source="src/repro_torch/kernels/csrc/lamb_update.cu",
                         replaces="src/repro/kernels/lamb_update.py:31"),
    "lamb_apply": dict(route="cuda",
                       source="src/repro_torch/kernels/csrc/lamb_update.cu",
                       replaces="src/repro/kernels/lamb_update.py:50"),
    "flash_fwd": dict(route="cuda",
                      source="src/repro_torch/kernels/csrc/flash_attention.cu",
                      replaces="src/repro/kernels/flash_attention.py:122",
                      design="bf16: flash_fwd_mma_kernel, mma.sync m16n8k16 on the tensor "
                             "cores, q in registers, k/v in a 2-stage cp.async ring, p as "
                             "three bf16 terms; fp32: flash_fwd_kernel, FMA"),
    "flash_dq": dict(route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:213",
                     design="bf16: flash_dq_mma_kernel, mma.sync m16n8k16 on the tensor "
                            "cores, q/do in registers, k/v in a 2-stage cp.async ring, ds as "
                            "bf16 hi+lo into dq += ds k; fp32: flash_dq_kernel, FMA"),
    "flash_dkv": dict(route="cuda",
                      source="src/repro_torch/kernels/csrc/flash_attention.cu",
                      replaces="src/repro/kernels/flash_attention.py:246",
                      design="bf16: flash_dkv_mma_kernel, mma.sync m16n8k16 on the tensor "
                             "cores, k/v in shared memory, q/do/lse/di in a 2-stage cp.async "
                             "ring, p and ds as bf16 hi+lo, dk/dv in fp32 registers; fp32: "
                             "flash_dkv_kernel, FMA"),
    "fused_ce_fwd": dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_ce.cu",
                         replaces="src/repro/kernels/fused_ce.py:87",
                         design="bf16: fused_ce_fwd_mma_kernel, mma.sync m16n8k16 on the "
                                "tensor cores, 64 h rows resident over all of D, w in 64-column "
                                "chunks through a 4-slot cp.async ring, online max/sum/argmax "
                                "on the fragments, vocab split across blocks, + combine; fp32: "
                                "fused_ce_fwd_kernel, FMA"),
    "fused_ce_dh": dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_ce.cu",
                        replaces="src/repro/kernels/fused_ce.py:162",
                        design="bf16: fused_ce_dh_mma_kernel, mma.sync m16n8k16 on the tensor "
                               "cores, 32 h rows and a 64-row w tile resident over all of D, "
                               "refilled by cp.async two D chunks at a time, dlogits as bf16 "
                               "hi+lo, 32 x D fp32 accumulator in registers, vocab split "
                               "across blocks; fp32: fused_ce_dh_kernel, FMA"),
    "fused_ce_dw": dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_ce.cu",
                        replaces="src/repro/kernels/fused_ce.py:184",
                        design="bf16: fused_ce_dw_mma_kernel, as fused_ce_dh_mma_kernel with "
                               "a 32-row dw tile per block over every row of h; fp32: "
                               "fused_ce_dw_kernel, FMA"),
}
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
FUSED_CE = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")

# Leaf shapes for the kernel check: (name, shape, layer_axis, x dtype, g
# dtype, weight decay and trust ratio on).  BERT-large's, then
# granite-moe-1b-a400m's expert and router leaves (phase 11), then two of
# deepseek-smoke's (phase 13).
CHECK_CASES = [
    ("blocks/mlp/wi", (24, 1024, 4096), 0, "float32", "float32", True),
    ("embed", (30522, 1024), None, "float32", "float32", True),
    ("blocks/ln1/scale", (24, 1024), 0, "float32", "float32", False),
    ("ragged", (3, 1_000_003), 0, "float32", "float32", True),
    ("blocks/attn/wq bf16", (24, 1024, 16, 64), 0, "bfloat16", "float32", True),
    ("blocks/attn/wo bf16 grads", (24, 16, 64, 1024), 0, "bfloat16", "bfloat16", True),
    ("granite-moe blocks/moe/wi", (24, 32, 1024, 512), 0, "float32", "float32", True),
    ("granite-moe blocks/moe/router", (24, 1024, 32), 0, "float32", "float32", True),
    ("deepseek-smoke blocks/moe/wi", (2, 4, 128, 64), 0, "float32", "float32", True),
    ("deepseek-smoke mtp/proj", (256, 128), None, "float32", "float32", True),
]


# Flash-attention checks: (name, b, h, hkv, s, t, d, causal, window, kv_valid
# or None, dtype, layout).  The first two are the shapes the main path gives
# the kernels at seq 128 and 512, the third granite-moe-1b-a400m's training
# shape (phase 11).  Layout "bshd": q, k, v and do are the
# model's (B, S, H, D) tensors seen as (B, H, S, D) views, as flash_sdpa
# hands them over.
FLASH_CASES = [
    ("main path", 32, 16, 16, 128, 128, 64, False, 0, None, "bfloat16", "bhsd"),
    ("seq 512", 16, 16, 16, 512, 512, 64, False, 0, None, "bfloat16", "bhsd"),
    ("granite-moe training", 8, 16, 8, 512, 512, 64, True, 0, None, "bfloat16", "bshd"),
    ("causal", 4, 16, 16, 256, 256, 64, True, 0, None, "bfloat16", "bhsd"),
    ("window", 4, 8, 8, 512, 512, 64, True, 128, None, "float32", "bhsd"),
    ("valid + window, dead rows", 3, 4, 4, 300, 300, 64, True, 64, [40, 300, 177], "float32",
     "bhsd"),
    ("valid + window, dead rows", 3, 4, 4, 300, 300, 64, True, 64, [40, 300, 177], "bfloat16",
     "bhsd"),
    ("ragged valid", 4, 16, 16, 128, 128, 64, False, 0, [128, 77, 1, 0], "bfloat16", "bhsd"),
    ("ragged S = T", 4, 16, 16, 200, 200, 64, False, 0, None, "bfloat16", "bhsd"),
    ("GQA 8/2 + valid", 4, 8, 2, 256, 256, 64, False, 0, [256, 200, 31, 129], "bfloat16",
     "bhsd"),
    ("model layout, GQA 16/4", 8, 16, 4, 128, 128, 64, False, 0,
     [128, 100, 64, 1, 128, 77, 128, 5], "bfloat16", "bshd"),
    ("cross-length causal", 4, 8, 8, 128, 384, 64, True, 0, None, "float32", "bhsd"),
    ("D 16", 4, 8, 8, 256, 256, 16, False, 0, [256, 100, 17, 256], "bfloat16", "bhsd"),
    ("D 32 causal", 4, 8, 8, 320, 320, 32, True, 0, None, "bfloat16", "bhsd"),
    ("D 128 fp32", 4, 8, 8, 384, 384, 128, True, 0, None, "float32", "bhsd"),
    ("D 128 bf16", 4, 8, 8, 384, 384, 128, False, 0, None, "bfloat16", "bhsd"),
    ("serving prefill, GQA 15/5", 1, 15, 5, 128, 128, 64, True, 0, None, "bfloat16", "bshd"),
    ("serving prefill, ragged S", 1, 15, 5, 100, 100, 64, True, 0, None, "bfloat16", "bshd"),
    # head dims outside the kernels' own run zero-padded (smollm-smoke's 40,
    # hubert-xlarge's 80); paligemma-3b's 256 on the D 256 kernels
    ("D 40 causal GQA", 2, 6, 2, 200, 200, 40, True, 0, None, "bfloat16", "bshd"),
    ("D 40 bidirectional", 2, 4, 4, 128, 128, 40, False, 0, [128, 77], "bfloat16", "bhsd"),
    ("D 80 bidirectional", 4, 16, 16, 256, 256, 80, False, 0, None, "bfloat16", "bshd"),
    ("D 80 causal GQA fp32", 2, 8, 2, 160, 160, 80, True, 0, None, "float32", "bhsd"),
    ("D 256 causal MQA", 2, 8, 1, 300, 300, 256, True, 0, None, "bfloat16", "bshd"),
    ("D 256 bidirectional", 2, 4, 4, 256, 256, 256, False, 0, [256, 100], "bfloat16", "bhsd"),
    ("D 256 causal fp32", 1, 4, 2, 200, 200, 256, True, 0, None, "float32", "bhsd"),
    # past 256, the wide kernels: 320 (zero-padded to 384), 512, 576 (padded
    # to 640), causal and bidirectional, GQA, ragged lengths, a window
    ("D 320 causal GQA", 2, 8, 2, 300, 300, 320, True, 0, None, "bfloat16", "bshd"),
    ("D 320 bidirectional valid", 2, 4, 4, 256, 256, 320, False, 0, [256, 100], "bfloat16",
     "bhsd"),
    ("D 320 valid + window, dead rows", 2, 4, 4, 300, 300, 320, True, 64, [40, 300],
     "bfloat16", "bhsd"),
    ("D 512 causal", 2, 8, 8, 256, 256, 512, True, 0, None, "bfloat16", "bhsd"),
    ("D 512 bidirectional", 2, 4, 4, 200, 200, 512, False, 0, None, "bfloat16", "bshd"),
    ("D 576 causal MQA", 1, 8, 1, 300, 300, 576, True, 0, None, "bfloat16", "bshd"),
    ("D 576 bidirectional valid", 2, 4, 2, 128, 128, 576, False, 0, [128, 77], "bfloat16",
     "bhsd"),
    ("D 512 causal fp32", 1, 4, 2, 200, 200, 512, True, 0, None, "float32", "bhsd"),
    ("D 576 bidirectional fp32", 2, 4, 4, 160, 160, 576, False, 0, [160, 33], "float32",
     "bhsd"),
]
# Flash timing shapes (b, h, hkv, s, d, causal): what the main path gives
# the kernels; then granite-moe-1b-a400m's training shape (phase 11).
FLASH_TIMING = [("seq 128", 32, 16, 16, 128, 64, False), ("seq 512", 16, 16, 16, 512, 64, False)]
MOE_FLASH_TIMING = [("granite-moe seq 512", 8, 16, 8, 512, 64, True)]
# head dims past 256 (the wide kernels; 320 and 576 zero-padded to 384 and
# 640), at the padded-path timing's shape
WIDE_FLASH_TIMING = [(f"D {d}", 8, 16, 16, 512, d, False) for d in (320, 512, 576)]
# phase 16 (b): one model=3 rank's q heads of smollm-360m (5 of 15) against
# their kv heads made whole for them, beside the whole heads' GQA call
GQA_FLASH_TIMING = [("rank", 8, 5, 5, 512, 64, True), ("whole", 8, 15, 5, 512, 64, True)]
# Head dims of the padded path and D 256, at one shape (b 8, h 16, s 512,
# bidirectional): flash_attention forward and forward + backward, padding in.
WIDTH_DIMS = (40, 64, 80, 128, 256)

# Fused CE checks: (name, n, d, v, dtype, layout).  The first two are the
# shapes the main path gives the kernels: 32 sequences × 20 gathered positions
# at seq 128, 16 × 77 at seq 512, against the tied (30522, 1024) embedding.
# Layout "dense": h a contiguous (n, d) tensor; "model": h the rows
# gather_supervised takes from a (32, 128, d) hidden state, as the model's
# loss hands them over, against w cast from an fp32 embedding as the step
# casts its masters; "lm": the rows of an (n / 512, 512, d) hidden state with
# every position supervised, as lm_loss hands granite-moe-1b-a400m's over
# (phase 11: 8 sequences of 512 against the tied (49155, 1024) embedding, a
# ragged vocab); "offset": h starts 2 bytes past a 16-byte boundary, so bf16
# K7 and K8 take the FMA design.
CE_CASES = [
    ("main path", 640, 1024, 30522, "bfloat16", "dense"),
    ("seq 512", 1232, 1024, 30522, "bfloat16", "dense"),
    ("granite-moe training", 4096, 1024, 49155, "bfloat16", "lm"),
    ("ragged rows and vocab", 97, 1024, 300, "bfloat16", "dense"),
    ("fp32", 640, 1024, 30522, "float32", "dense"),
    ("ragged fp32, D 80", 97, 80, 300, "float32", "dense"),
    ("ragged bf16, D 80", 97, 80, 300, "bfloat16", "dense"),
    ("bf16 D 1000, N 333", 333, 1000, 5003, "bfloat16", "dense"),
    ("model layout", 640, 1024, 30522, "bfloat16", "model"),
    ("bf16 rows off 16 bytes", 97, 1024, 300, "bfloat16", "offset"),
    # D past one 1024-column window: hubert-xlarge's 1280, paligemma-3b's
    # 2048 (a vocab tile past 5003), and a ragged last window
    ("D 1280", 640, 1280, 5003, "bfloat16", "dense"),
    ("D 2048", 640, 2048, 30522, "bfloat16", "dense"),
    ("D 2048 fp32", 97, 2048, 3001, "float32", "dense"),
    ("D 2056 off 16 bytes", 97, 2056, 300, "bfloat16", "offset"),
    ("ragged D 2056", 97, 2056, 300, "bfloat16", "dense"),
    # phase 13: deepseek-smoke's micro-batch (4 x 64 rows, D 128, V 512) and
    # deepseek-v3's full-width head (2 x 512 rows, D 7168 in 7 windows)
    ("deepseek-smoke training", 256, 128, 512, "bfloat16", "dense"),
    ("deepseek-v3 head, D 7168", 1024, 7168, 129280, "bfloat16", "dense"),
]
# Fused CE timing shapes (n rows, D, V; bf16): the main path's, then
# granite-moe-1b-a400m's (8 sequences of 512, every position supervised),
# then D past one 1024-column window at the main path's n and V.
CE_TIMING = [("seq 128", 640, 1024, 30522), ("seq 512", 1232, 1024, 30522)]
MOE_CE_TIMING = [("granite-moe", 4096, 1024, 49155)]
WIDE_CE_TIMING = [("D 1280", 640, 1280, 30522), ("D 2048", 640, 2048, 30522)]
DS_CE_TIMING = [("deepseek-v3 D 7168", 1024, 7168, 129280)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0]


def memory_rate(name: str) -> float:
    from repro_torch.launch.roofline import memory_rate as rate

    return rate(name)


def bound_of(work, rate: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a ``kernels.cost.Work`` on a card of
    memory rate ``rate`` (``launch/roofline.bound``)."""
    from repro_torch.launch.roofline import bound

    t, by = bound(work, rate)
    return dict(bound_ms=t * 1e3, bound_by=by)


def ptxas_lines(log_text: str) -> list:
    """The registers and spill lines of ptxas's report, each after the
    kernel it belongs to (``name<dtype, D>``)."""
    out, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.strip()}")
    return out


def _kernel_name(sym: str) -> str:
    """``flash_fwd_mma_kernel<64>`` from its mangled name in the anonymous
    namespace (types: f = fp32, __nv_bfloat16 = bf16; ints: Li64E = 64)."""
    m = re.match(r"_ZN(\d+)", sym)
    if not m:
        return sym
    at = m.end() + int(m.group(1))   # past the namespace's name
    m = re.match(r"\d+", sym[at:])
    if not m:
        return sym
    at, n = at + m.end(), int(m.group())
    name, args = sym[at:at + n], sym[at + n:]
    targs = args[1:args.find("EEv") + 1] if args.startswith("I") else ""
    shown = ["bf16" if t.group(0).startswith("13") else t.group(1) or "fp32"
             for t in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f", targs)]
    return f"{name}<{', '.join(shown)}>" if shown else name


def bf16_ulp(t):
    import torch

    mag = t.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# phase 3: kernels against the plain version
# ---------------------------------------------------------------------------

def check_kernels(device) -> dict:
    """Max abs errors per kernel over the cases; raises on a mismatch.

    Tolerances: m', v' are the same fp32 formula (the kernel's multiply-adds
    may fuse), so a few ulps; the trust ratio's norms sum in another order,
    so 1e-5 relative; x' then differs by that share of its update plus an
    ulp of x (one bf16 ulp for bf16 weights).
    """
    import torch

    from repro_torch.kernels import lamb_update

    errs = {"lamb_moments": 0.0, "lamb_apply": 0.0}
    gen = torch.Generator(device=device).manual_seed(0)
    for name, shape, axis, xdt, gdt, on in CHECK_CASES:
        x = (0.05 * torch.randn(shape, generator=gen, device=device)).to(getattr(torch, xdt))
        g = (1e-3 * torch.randn(shape, generator=gen, device=device)).to(getattr(torch, gdt))
        m = 1e-4 * torch.randn(shape, generator=gen, device=device)
        v = 1e-8 * torch.rand(shape, generator=gen, device=device)
        kw = dict(weight_decay=0.01 if on else 0.0, apply_trust=on, layer_axis=axis)
        count = torch.tensor(5, dtype=torch.int32, device=device)
        lr = torch.tensor(1e-3, device=device)
        ref = lamb_update(x.clone(), g, m.clone(), v.clone(), count, lr, plain=True, **kw)
        x0, m0, v0 = x.clone(), m.clone(), v.clone()
        out = lamb_update(x, g, m, v, count, lr, **kw)
        torch.cuda.synchronize()
        em = float((out.m - ref.m).abs().max())
        ev = float((out.v - ref.v).abs().max())
        ex = float((out.x.float() - ref.x.float()).abs().max())
        er = float(((out.ratio - ref.ratio).abs() / ref.ratio.abs()).max())
        ed = abs(float(out.delta_sq) - float(ref.delta_sq)) / max(float(ref.delta_sq), 1e-30)
        step = (ref.x.float() - x0.float()).abs()
        if xdt == "bfloat16":
            x_ok = bool(((out.x.float() - ref.x.float()).abs() <= bf16_ulp(ref.x.float())).all())
        else:
            x_ok = bool(((out.x - ref.x).abs() <= 1e-4 * step + 1.2e-7 * ref.x.abs()
                         + 1e-12).all())
        ok = (torch.allclose(out.m, ref.m, rtol=1e-5, atol=1e-9)
              and torch.allclose(out.v, ref.v, rtol=1e-5, atol=1e-14)
              and er < 1e-5 and ed < 1e-4 and x_ok)
        log(f"check {name:26s} {str(shape):22s} x {xdt:8s} g {gdt:8s} "
            f"|dm| {em:.2e} |dv| {ev:.2e} |dx| {ex:.2e} ratio rel {er:.2e} "
            f"dsq rel {ed:.2e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain version on {name}")
        errs["lamb_moments"] = max(errs["lamb_moments"], em, ev)
        errs["lamb_apply"] = max(errs["lamb_apply"], ex)
        check_ok_flag(name, x0, g, m0, v0, count, lr, kw)
        del x, g, m, v, ref, out, x0, m0, v0, step
    torch.cuda.empty_cache()
    return errs


def check_ok_flag(name, x, g, m, v, count, lr, kw) -> None:
    """K1/K2 with the guard's flag: ``ok`` 0 stores nothing (x, m, v equal to
    the inputs bit for bit, Σ(x'−x)² exactly 0), as the plain version does;
    ``ok`` 1 gives the bits of the call without a flag.  Raises otherwise."""
    import torch

    from repro_torch.kernels import lamb_update

    def run(flag, plain=False):
        ok = None if flag is None else torch.tensor(flag, dtype=torch.int32, device=x.device)
        return lamb_update(x.clone(), g, m.clone(), v.clone(), count, lr, ok=ok,
                           plain=plain, **kw)

    skip, skip_plain = run(0), run(0, plain=True)
    taken, bare = run(1), run(None)
    torch.cuda.synchronize()
    skip_ok = all(torch.equal(a, b) for out in (skip, skip_plain)
                  for a, b in zip((out.x, out.m, out.v), (x, m, v))) \
        and float(skip.delta_sq) == 0.0 == float(skip_plain.delta_sq)
    taken_ok = all(torch.equal(a, b) for a, b in zip(
        (taken.x, taken.m, taken.v, taken.delta_sq), (bare.x, bare.m, bare.v, bare.delta_sq)))
    log(f"check {name:26s} ok=0: x, m, v unchanged and dsq 0 (kernel and plain) "
        f"{skip_ok}; ok=1 equal to no flag bit for bit {taken_ok}")
    if not (skip_ok and taken_ok):
        raise AssertionError(f"K1/K2 do not honour the ok flag on {name}")


def check_flash(device) -> dict:
    """Max abs errors per flash kernel over FLASH_CASES; raises on a mismatch.

    The kernels run through the autograd boundary (K3, then K4 and K5);
    each is held against the plain version on the same inputs: the forward
    on q, k, v, the backward on the kernel forward's residuals (o, lse) and
    do.  Both sides compute in fp32 from those inputs, in another order (the
    kernel's sums against cuBLAS), so fp32 outputs agree to 1e-4 relative
    plus 1e-4 of the tensor's largest magnitude; bf16 outputs round those
    fp32 values, so they may differ by one bf16 ulp (2^-7 relative): 1e-2
    relative plus the same absolute term.  lse is fp32: 1e-5.  A bf16 o
    that rounds to the other neighbouring value changes di = rowsum(o do),
    and through the cancelling dp - di the dq of its row by more than an
    ulp; so the plain backward from the plain forward's own o is not the
    same input, and how far the two chains part is logged, not held.
    """
    import torch

    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import FlashSpec, flash_attention, \
        flash_attention_bwd, flash_attention_fwd, flash_dkv, flash_dq, kernel_head_dim, row_dot

    errs = dict.fromkeys(FLASH, 0.0)
    gen = torch.Generator(device=device).manual_seed(2)

    def make(b, heads, n, d, dtype, layout):
        if layout == "bshd":
            x = torch.randn((b, n, heads, d), generator=gen, device=device)
            return x.to(dtype).transpose(1, 2)
        return torch.randn((b, heads, n, d), generator=gen, device=device).to(dtype)

    for name, b, h, hkv, s, t, d, causal, window, valid, dt, layout in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, do = (make(b, h, s, d, dtype, layout) for _ in range(2))
        k, v = (make(b, hkv, t, d, dtype, layout) for _ in range(2))
        kv_valid = None if valid is None else torch.tensor(valid, dtype=torch.int32,
                                                           device=device)
        outs = {}
        for plain in (True, False):
            qkv = [x.clone().requires_grad_() for x in (q, k, v)]
            o = flash_attention(*qkv, kv_valid, causal=causal, window=window, plain=plain)
            outs[plain] = [o.detach(), *torch.autograd.grad(o, qkv, do)]
        lim = None if valid is None else kv_valid.clamp(1, t)
        spec = FlashSpec(d**-0.5, causal, window, valid is not None)
        # a head dim outside the kernels' own: the kernels' call is the
        # padded one (flash_attention pads), held to the plain version on the
        # same padded inputs, sliced back
        dp = kernel_head_dim(d)
        pad = (lambda x: F.pad(x, (0, dp - d))) if dp != d else (lambda x: x)
        (o_k, lse), (o_ref, lse_ref) = (flash_attention_fwd(pad(q), pad(k), pad(v), lim, spec,
                                                            plain=p) for p in (False, True))
        same_inputs = [x[..., :d] for x in (o_ref, *flash_attention_bwd(
            pad(q), pad(k), pad(v), lim, o_k, lse, pad(do), spec, plain=True))]
        if dp != d and not torch.equal(outs[False][0], o_k[..., :d]):
            raise AssertionError(f"flash at head dim {d}: the padded call's o differs")
        torch.cuda.synchronize()
        rtol = 1e-2 if dt == "bfloat16" else 1e-4
        ok = bool(torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5))
        diffs, parted = [], []
        for a, r, c in zip(outs[False], same_inputs, outs[True]):
            a, r, c = a.float(), r.float(), c.float()
            atol = 1e-4 * max(1.0, float(r.abs().max()))
            ok = ok and bool(torch.isfinite(a).all()) and bool(
                torch.allclose(a, r, rtol=rtol, atol=atol))
            diffs.append(float((a - r).abs().max()))
            parted.append(int(((a - c).abs() > rtol * c.abs() + atol).sum()))
        if valid is not None and window:
            # rows where window ∩ valid is empty: o = 0 and dq = 0 exactly
            rows = torch.arange(s, device=device)
            dead = rows[None, :] > lim[:, None] + window - 2 - (t - s)   # (b, s)
            dead_o = outs[False][0].float()[dead[:, None, :, None].expand(b, h, s, d)]
            dead_dq = outs[False][1].float()[dead[:, None, :, None].expand(b, h, s, d)]
            ok = ok and int(dead.sum()) > 0 and float(dead_o.abs().max()) == 0.0 \
                and float(dead_dq.abs().max()) == 0.0
        log(f"check flash {name:26s} q {(b, h, s, d)} kv {(hkv, t)} causal {causal} "
            f"window {window} valid {valid} {dt} {layout}: |do| {diffs[0]:.2e} "
            f"|ddq| {diffs[1]:.2e} "
            f"|ddk| {diffs[2]:.2e} |ddv| {diffs[3]:.2e} |dlse| "
            f"{float((lse - lse_ref).abs().max()):.2e} (rtol {rtol:g}) "
            f"{'ok' if ok else 'MISMATCH'}; against the plain chain, elements past "
            f"that tolerance (o, dq, dk, dv): {parted} of {q.numel()}")
        if not ok:
            raise AssertionError(f"flash kernels disagree with the plain version on {name}")
        errs["flash_fwd"] = max(errs["flash_fwd"], diffs[0])
        errs["flash_dq"] = max(errs["flash_dq"], diffs[1])
        errs["flash_dkv"] = max(errs["flash_dkv"], diffs[2], diffs[3])
        del q, k, v, do, outs, same_inputs, o_k, o_ref
    # K4 and K5 own their dq and dk/dv tiles and sum in a fixed order: two
    # runs, equal bits
    for name, b, h, hkv, s, t, d, causal, window, valid, dt, layout in (
            FLASH_CASES[0], next(c for c in FLASH_CASES if c[0] == "GQA 8/2 + valid")):
        dtype = getattr(torch, dt)
        q, do = (make(b, h, s, d, dtype, layout) for _ in range(2))
        k, v = (make(b, hkv, t, d, dtype, layout) for _ in range(2))
        lim = None if valid is None else torch.tensor(valid, dtype=torch.int32,
                                                      device=device).clamp(1, t)
        spec = FlashSpec(d**-0.5, causal, window, valid is not None)
        o, lse = flash_attention_fwd(q, k, v, lim, spec)
        di = row_dot(o, do)
        runs = [(flash_dq(q, k, v, lim, lse, di, do, spec),
                 *flash_dkv(q, k, v, lim, lse, di, do, spec)) for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        log(f"check flash_dq, flash_dkv {name}: two runs {'equal' if same else 'DIFFER'} "
            f"bit for bit")
        if not same:
            raise AssertionError(f"flash_dq or flash_dkv is not bit-reproducible on {name}")
        del q, k, v, do, o, lse, di, runs
    torch.cuda.empty_cache()
    return errs


def ce_operand(x, layout: str):
    """``x`` (n, d) as the tensor the kernels are handed in CE_CASES's
    ``layout``, made from a fresh leaf that requires grad; gradients are
    taken against it."""
    import torch

    from repro_torch.train.loss import IGNORE, gather_supervised

    n, d = x.shape
    if layout == "dense":
        return x.clone().requires_grad_()
    if layout == "offset":
        leaf = x.clone().requires_grad_()
        return torch.cat([x.new_zeros(1), leaf.reshape(-1)])[1:].view(n, d)
    if layout == "lm":              # n / 512 sequences of 512, every row supervised
        b, s = n // 512, 512
    else:                           # layout "model": n = 32 sequences × n / 32 rows
        b, s = 32, 128
    p = n // b
    pos = torch.stack([torch.randperm(s, device=x.device)[:p].sort().values for _ in range(b)])
    leaf = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    leaf[torch.arange(b, device=x.device)[:, None], pos] = x.view(b, p, d)
    leaf.requires_grad_()
    labels = torch.full((b, s), IGNORE, dtype=torch.int32, device=x.device)
    labels[torch.arange(b, device=x.device)[:, None], pos] = 0
    return gather_supervised(leaf, labels, p)[0].reshape(n, d)


def check_fused_ce(device) -> dict:
    """Max abs errors per fused CE kernel over CE_CASES; raises on a mismatch.

    Inputs: h with std 1 whose first quarter of rows is all zero (every logit
    0, so the argmax is column 0: ties), w with std 0.05, labels at 0 and
    V − 1, the argmax on every other row (so ``correct`` is exercised) and
    random elsewhere, a cotangent that is 0 on every third row.  Both sides
    compute in fp32 from the same inputs in another order (the kernel's sums
    against cuBLAS; in the tensor-core design the dlogits enter the second
    product as two bf16 terms, ~16 bits), so nll and lse agree to 1e-5
    (both are also logged against the sums in fp64);
    ``correct`` is equal except where the label's logit ties the maximum
    within fp32 rounding; fp32 gradients agree to 1e-4 relative plus 1e-5 of
    the tensor's largest magnitude, bf16 gradients round those fp32 values,
    so one bf16 ulp (2^-7 relative) apart at most: 1e-2 relative plus 1e-4
    of the largest.  Rows with a zero cotangent must get exactly zero dh.
    Every case checks which design K6, K7 and K8 ran: the tensor cores for
    bf16 they can stage, FMA otherwise.  Then K7 and K8 run twice on two cases
    and must give equal bits.
    """
    import torch

    from repro_torch.kernels import VARIANT_LAUNCHES, reset_launches
    from repro_torch.kernels.fused_ce import fused_ce, fused_ce_dh, fused_ce_dw, fused_ce_fwd

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full fp32
    errs = dict.fromkeys(FUSED_CE, 0.0)
    gen = torch.Generator(device=device).manual_seed(4)
    torch.manual_seed(4)   # the model layout's positions

    def make(n, d, v, dtype):
        rows = torch.arange(n, device=device)
        h = torch.randn((n, d), generator=gen, device=device)
        h[: n // 4] = 0.0
        h = h.to(dtype)
        w = (0.05 * torch.randn((v, d), generator=gen, device=device)).to(dtype)
        logits = h.float() @ w.float().t()
        lbl = torch.randint(0, v, (n,), generator=gen, device=device, dtype=torch.int32)
        lbl = torch.where(rows % 2 == 0, logits.argmax(1).to(torch.int32), lbl)
        lbl[0], lbl[1] = 0, v - 1
        g = torch.rand((n,), generator=gen, device=device)
        g[rows % 3 == 1] = 0.0
        return h, w, logits, lbl, g

    for name, n, d, v, dt, layout in CE_CASES:
        dtype = getattr(torch, dt)
        rows = torch.arange(n, device=device)
        h, w, logits, lbl, g = make(n, d, v, dtype)
        outs = {}
        for plain in (True, False):
            hh = ce_operand(h, "dense" if plain else layout)
            ww = w.clone().requires_grad_()
            reset_launches()
            nll, correct = fused_ce(hh, ww, lbl, plain=plain)
            outs[plain] = [nll.detach(), correct, *torch.autograd.grad(nll, (hh, ww), g)]
        designs = {k: dict(VARIANT_LAUNCHES[k]) for k in FUSED_CE}
        want = "mma" if dtype == torch.bfloat16 and layout != "offset" else "fma"
        design_ok = all(c == {"mma": int(want == "mma"), "fma": int(want == "fma")}
                        for c in designs.values())
        lse, lse_ref = (fused_ce_fwd(h, w, lbl, plain=p)[2] for p in (False, True))
        # both fp32 sides against the sums in fp64, for the record
        lse64 = torch.logsumexp(h.double() @ w.double().t(), 1)
        e64 = [float((x.double() - lse64).abs().max()) for x in (lse, lse_ref)]
        del lse64
        torch.cuda.synchronize()
        (nll, correct, dh, dw), (nll_r, correct_r, dh_r, dw_r) = outs[False], outs[True]
        fails = []
        if not (torch.allclose(nll, nll_r, rtol=1e-5, atol=1e-5)
                and torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5)):
            fails.append("nll/lse")
        flips = correct != correct_r
        if bool(flips.any()):
            top = logits.amax(1)
            gap = (top - logits.gather(1, lbl.long()[:, None])[:, 0]).abs()
            if not bool((gap[flips] <= 1e-5 * (1 + top[flips].abs())).all()):
                fails.append("correct")
        bf16 = dtype == torch.bfloat16
        diffs = []
        for label, a, r in (("dh", dh, dh_r), ("dw", dw, dw_r)):
            a, r = a.float(), r.float()
            scale = max(float(r.abs().max()), 1e-30)
            if not (bool(torch.isfinite(a).all()) and bool(torch.allclose(
                    a, r, rtol=1e-2 if bf16 else 1e-4, atol=(1e-4 if bf16 else 1e-5) * scale))):
                fails.append(label)
            diffs.append(float((a - r).abs().max()))
        zero = rows < n // 4
        ties_ok = torch.equal(correct[zero], (lbl[zero] == 0).float())
        still_ok = float(dh[g == 0].abs().max()) == 0.0
        fails += [k for k, good in (("ties", ties_ok), ("zero-g rows", still_ok),
                                    ("designs", design_ok)) if not good]
        e_fwd = max(float((nll - nll_r).abs().max()), float((lse - lse_ref).abs().max()))
        log(f"check fused CE {name:24s} n {n} d {d} v {v} {dt} {layout}: |dnll|,|dlse| "
            f"{e_fwd:.2e} (|lse - lse in fp64| kernel {e64[0]:.2e}, plain {e64[1]:.2e}) "
            f"correct flips {int(flips.sum())} of {n} (label "
            f"wins on {int(correct_r.sum())}) |ddh| {diffs[0]:.2e} |ddw| {diffs[1]:.2e} ties "
            f"{ties_ok} zero-g rows {still_ok} K6-K8 designs {designs} (want {want}) "
            f"{'ok' if not fails else 'MISMATCH in ' + ', '.join(fails)}")
        if fails:
            raise AssertionError(f"fused CE kernels disagree with the plain version on {name}")
        errs["fused_ce_fwd"] = max(errs["fused_ce_fwd"], e_fwd)
        errs["fused_ce_dh"] = max(errs["fused_ce_dh"], diffs[0])
        errs["fused_ce_dw"] = max(errs["fused_ce_dw"], diffs[1])
        del h, w, logits, outs, dh, dw, dh_r, dw_r
    # K7 and K8 own their outputs (no atomics; K7's splits summed in order):
    # two runs, equal bits
    for name, n, d, v, dt, _ in (CE_CASES[0], next(c for c in CE_CASES if "N 333" in c[0])):
        h, w, _, lbl, g = make(n, d, v, getattr(torch, dt))
        lse = fused_ce_fwd(h, w, lbl)[2]
        same = all(torch.equal(*(fn(h, w, lbl, lse, g) for _ in range(2)))
                   for fn in (fused_ce_dh, fused_ce_dw))
        log(f"check fused_ce_dh, fused_ce_dw {name}: two runs "
            f"{'equal' if same else 'DIFFER'} bit for bit")
        if not same:
            raise AssertionError(f"fused CE backward is not bit-reproducible on {name}")
        del h, w, lbl, g, lse
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU on a small input
# ---------------------------------------------------------------------------

def check_against_cpu(device) -> None:
    import torch

    from repro_torch.configs import bert_large
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import warmup_poly_decay
    from repro_torch.data import batch_iterator
    from repro_torch.kernels import LAUNCHES, FusedLambState, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bert_large.smoke().replace(activation_dtype="float32", use_flash_kernel=True,
                                     use_fused_ce_head=True)
    tc = TrainConfig(optimizer="lamb", use_fused_lamb=True, accum_steps=2,
                     learning_rate=0.01)
    init, step = make_train_step(build_model(cfg), tc, warmup_poly_decay(0.01, 10, 0))
    cpu = init(0, "cpu")

    def to(state, dev):
        o = state.opt_state
        c = lambda d: {k: v.to(dev, copy=True) for k, v in d.items()}  # noqa: E731
        return TrainState(c(state.params), FusedLambState(
            o.count.to(dev, copy=True), o.sched_count.to(dev, copy=True), c(o.mu), c(o.nu)))

    gpu = to(cpu, device)
    data = batch_iterator(cfg, 8, 32, seed=3)
    reset_launches()
    for i in range(2):
        b = next(data)
        cpu, mc = step(cpu, {k: torch.from_numpy(v) for k, v in b.items()})
        gpu, mg = step(gpu, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
        lc, lg = float(mc["loss/total"]), float(mg["loss/total"])
        uc, ug = float(mc["update_norm"]), float(mg["update_norm"])
        log(f"reference step {i + 1}: loss cuda {lg:.7f} cpu {lc:.7f}; "
            f"update norm cuda {ug:.7f} cpu {uc:.7f}")
        if not (math.isclose(lg, lc, rel_tol=1e-4) and math.isclose(ug, uc, rel_tol=1e-4)):
            raise AssertionError("bert-smoke steps on the card disagree with the CPU")
    want = 2 * cfg.n_layers * 2  # steps × layers × micro-batches
    if any(LAUNCHES[k] != want for k in FLASH) or any(LAUNCHES[k] != 2 * 2 for k in FUSED_CE):
        raise AssertionError(f"kernels launched {LAUNCHES}, want {want} of each flash "
                             "kernel and 4 of each fused CE kernel")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def _want_launches(steps: int, fused_lamb: bool = True, leaves: int = LEAVES,
                   layers: int = LAYERS) -> dict:
    want = dict.fromkeys(("lamb_moments", "lamb_apply"), leaves * steps if fused_lamb else 0)
    want.update(dict.fromkeys(FLASH, layers * ACCUM * steps))
    want.update(dict.fromkeys(FUSED_CE, ACCUM * steps))
    return want


def _check_launches(label, steps, fused_lamb, launches, designs, copies, leaves: int = LEAVES,
                    layers: int = LAYERS) -> None:
    """Launch counts of ``steps`` full-width steps: K1/K2 ``leaves`` (BERT's
    13) × steps (0 on a transform chain), K3–K5 ``layers`` (24) × 2
    micro-batches × steps and K6–K8 2 × steps, every K3–K8 launch on the
    tensor-core kernel, and autograd's ``do`` read as it came, never
    copied."""
    want = _want_launches(steps, fused_lamb, leaves, layers)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    n_flash, n_ce = layers * ACCUM * steps, ACCUM * steps
    want_designs = {**{k: {"mma": n_flash, "fma": 0} for k in FLASH},
                    **{k: {"mma": n_ce, "fma": 0} for k in FUSED_CE}}
    if designs != want_designs or any(copies.values()):
        raise AssertionError(f"{label}: launches by design {designs}, want "
                             f"{want_designs}; copies {copies}, want none")


def _counts() -> tuple:
    from repro_torch.kernels import COPIES, LAUNCHES, VARIANT_LAUNCHES

    return (dict(LAUNCHES), {k: dict(v) for k, v in VARIANT_LAUNCHES.items()},
            dict(COPIES))


def _train(device, argv, steps, label):
    """One launcher run with the counts set to 0 just before it; raises on
    non-finite metrics or launch counts off the path's shape."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train as launch_train

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    trainer = launch_train.main(argv)
    torch.cuda.synchronize()
    launches, designs, copies = _counts()
    peak = torch.cuda.max_memory_allocated(device)

    hist = trainer.history
    n_leaves = len(trainer.state.params)
    cfg = trainer.model.cfg
    if len(hist) != steps or n_leaves != LEAVES or not cfg.use_flash_kernel \
            or not cfg.use_fused_ce_head:
        raise AssertionError(f"{len(hist)} logged steps, {n_leaves} leaves, flash "
                             f"{cfg.use_flash_kernel}, fused CE {cfg.use_fused_ce_head}")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("loss/total", "grad_norm", "update_norm")):
            raise AssertionError(f"non-finite metrics at step {h['step']}: {h}")
    _check_launches(label, steps, "--fused-lamb" in argv, launches, designs, copies)
    walls = [h["wall_s"] for h in hist]
    log(f"{label}: losses {[round(h['loss/total'], 4) for h in hist]}")
    if "--mixed-batch" in argv:
        log(f"{label}: stages {[h['stage'] for h in hist]}, step walls "
            f"{[round(b - a, 4) for a, b in zip([0.0] + walls, walls)]} s (the first of "
            f"each stage includes its warm-up), peak memory {peak / 2**30:.2f} GiB")
    else:
        steady = [b - a for a, b in zip(walls[1:], walls[2:])]  # after two warm-up steps
        step_s = sum(steady) / len(steady)
        batch, seq = (int(argv[argv.index(f) + 1]) for f in ("--batch", "--seq"))
        log(f"{label}: first step {walls[0]:.3f} s, steps 3-{steps} "
            f"{[round(s, 4) for s in steady]} s, mean {step_s * 1e3:.1f} ms/step, "
            f"{batch * seq / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    log(f"{label}: launches {launches}")
    log(f"{label}: launches by design {designs}; input copies {copies}")
    return trainer, launches


def run_main_path(device) -> tuple:
    """Phase 5; returns the main path's launch counts and history rows."""
    import torch

    trainer, launches = _train(device, MAIN_ARGV, MAIN_STEPS, "main path")
    hist = trainer.history
    # the same seed gives the same initial weights.  Every leaf under the
    # trust ratio must have moved (its step is lr·‖x‖-sized whatever the
    # gradient's scale); a leaf without it (norm scales and biases) moves by
    # lr·m̂/(√v̂+eps), which after clipping can be below half an ulp of 1.0.
    # The distance travelled must also fit the per-step update norms the
    # kernels reported: 0 < ‖x6 − x0‖ <= Σ_t ‖x_t − x_{t−1}‖.
    init = trainer.model.init(trainer.tc.seed, device)
    trust = trainer.model.trust_mask()
    moved_sq = 0.0
    still = []
    for k, p in trainer.state.params.items():
        d = float((p - init[k]).float().square().sum())
        moved_sq += d
        if d == 0.0:
            still.append(k)
    del init
    travelled = sum(h["update_norm"] for h in hist)
    log(f"main path: grad norms {[round(h['grad_norm'], 3) for h in hist]}, update norms "
        f"{[round(h['update_norm'], 4) for h in hist]}, |x6 - x0| {math.sqrt(moved_sq):.4f}, "
        f"leaves that did not move: {still}")
    if [k for k in still if trust[k]] or not 0.0 < math.sqrt(moved_sq) <= travelled * 1.0001:
        raise AssertionError("the parameters did not move as the kernels reported")
    del trainer
    torch.cuda.empty_cache()
    # the paper's stage-2 length: same model, seq 512
    trainer, _ = _train(device, SEQ512_ARGV, SEQ512_STEPS, "seq 512")
    del trainer
    torch.cuda.empty_cache()
    return launches, hist


# ---------------------------------------------------------------------------
# phase 7: the two-stage recipe, the guard and checkpoints at full width
# ---------------------------------------------------------------------------

def _state_tensors(state) -> dict:
    """Every tensor of a TrainState by its checkpoint path."""
    from repro_torch.checkpoint import tree_leaves_with_paths

    return dict(tree_leaves_with_paths(state))


def run_two_stages(device):
    """``--mixed-batch --skip-nonfinite`` on full-width BERT-large: every loss
    finite, no step skipped, ``count`` carried over the switch (6),
    ``sched_count`` restarted (2), ``step`` 6, and the launch counts of 6
    steps (each stage with accum 2).  Returns the trainer."""
    trainer, launches = _train(device, STAGES_ARGV, STAGES_STEPS, "two stages")
    hist, state = trainer.history, trainer.state
    o = state.opt_state
    counters = tuple(int(t) for t in (o.count, o.sched_count, state.step, state.skipped))
    skips = [h["nonfinite/skip"] for h in hist]
    log(f"two stages: count, sched_count, step, skipped {counters}; nonfinite/skip {skips}; "
        f"update norms {[round(h['update_norm'], 4) for h in hist]}")
    if [h["stage"] for h in hist] != [0, 0, 0, 0, 1, 1] or counters != (6, 2, 6, 0) \
            or any(skips) or [h["step"] for h in hist] != [1, 2, 3, 4, 5, 6]:
        raise AssertionError("the two-stage run did not carry count, restart sched_count "
                             "and take every step")
    return trainer


def check_guard(trainer, device, label: str = "guard", k12: tuple = (LEAVES, LEAVES)) -> None:
    """A ``grad_nan`` step at full width with the guard on: params, the
    optimizer state with all its counters, and ``step`` bit-identical to
    before, ``skipped`` + 1, K1 and K2 launched ``k12`` times (once per leaf
    on the fused path, 0 on a transform chain); the next clean step moves
    the weights."""
    import torch

    from repro_torch.data import DataPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train import GUARD_KEY, FaultInjector, FaultSpec, make_train_step

    _, step = make_train_step(trainer.model, trainer.tc, lambda t: torch.full(
        (), 1e-3, device=t.device))
    data = DataPipeline(trainer.model.cfg, 64, 128, device=device, seed=7)
    poisoned = FaultInjector([FaultSpec("grad_nan", at=0)]).stamp(next(data), 0)
    state = trainer.state
    before = {k: v.clone() for k, v in _state_tensors(state).items()}
    reset_launches()
    state, m = step(state, poisoned)
    torch.cuda.synchronize()
    launched = (LAUNCHES["lamb_moments"], LAUNCHES["lamb_apply"])
    after = _state_tensors(state)
    changed = [k for k, v in before.items() if k != "skipped" and not torch.equal(v, after[k])]
    skipped = int(state.skipped) - int(before["skipped"])
    log(f"{label}: grad_nan step: nonfinite/skip {float(m[GUARD_KEY])}, update norm "
        f"{float(m['update_norm'])}, {len(before)} leaves, changed {changed}, skipped "
        f"+{skipped}, K1/K2 launches {launched}")
    if changed or skipped != 1 or launched != k12 or float(m[GUARD_KEY]) != 1.0:
        raise AssertionError(f"{label}: the skipped step was not a bit-exact no-op")
    state, m = step(state, next(data))
    torch.cuda.synchronize()
    moved = sum(not torch.equal(v, state.params[k[len("params/"):]])
                for k, v in before.items() if k.startswith("params/"))
    log(f"{label}: next clean step: nonfinite/skip {float(m[GUARD_KEY])}, loss "
        f"{float(m['loss/total']):.4f}, update norm {float(m['update_norm']):.4f}, "
        f"param leaves moved {moved} of {LEAVES}, step {int(state.step)}")
    if float(m[GUARD_KEY]) != 0.0 or moved == 0 or int(state.step) != int(before["step"]) + 1:
        raise AssertionError(f"{label}: the clean step after a skip did not move the weights")
    del before, after


def _same_bits(a, b) -> bool:
    """Tensors or float lists equal bit for bit (NaN included)."""
    import struct

    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                  b.reshape(-1).view(torch.uint8))
    return [struct.pack("d", x) for x in a] == [struct.pack("d", x) for x in b]


def check_checkpoint_resume(device, argv=None, label: str = "checkpoint",
                            timed: bool = True, at: int = 2) -> None:
    """4 uninterrupted steps; then ``at`` steps with an async checkpoint at
    step ``at``, the checkpoint restored bit for bit, (``timed``: more
    saves, and a sync one, timed), and a fresh trainer resumed to 4 steps:
    its losses and params equal to the uninterrupted run's bit for bit.
    ``argv``: the launcher's flags (default ``RESUME_ARGV``, fused LAMB).
    The checkpoints go to a directory under ``build/``, removed in a
    ``finally``.  Returns the uninterrupted run's losses and params (on the
    host)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from repro_torch.launch.train import build, parse_args

    def run(extra, steps):
        trainer, data, _ = build(parse_args((argv or RESUME_ARGV) + extra))
        trainer.log = lambda msg: None
        trainer.fit(data, steps)
        torch.cuda.synchronize()
        return trainer

    ref = run([], 4)
    ref_params = {k: v.cpu() for k, v in ref.state.params.items()}
    ref_losses = [h["loss/total"] for h in ref.history]
    del ref
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="ckpt_"))
    try:
        free = shutil.disk_usage(tmp).free
        ckpt = ["--checkpoint-dir", str(tmp / "run"), "--checkpoint-every", str(at),
                "--async-checkpoint"]
        first = run(ckpt, at)
        ck = first.checkpointer
        if timed:
            # two more saves of the same state: the second snapshot allocates
            # the other host buffer, the third reuses the first (the steady cost)
            ck.save(at, first.state)
            ck.save(at, first.state)
        ck.wait()
        path = latest_checkpoint(str(tmp / "run"))
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        saved = _state_tensors(first.state)
        restored = _state_tensors(restore_checkpoint(path, first.state))
        same = [k for k in saved if _same_bits(saved[k], restored[k])]
        log(f"{label}: {len(saved)} leaves, {nbytes} bytes on disk "
            f"({nbytes / 1e9:.3f} GB; {free / 1e9:.1f} GB free before)")
        if timed:
            t0 = time.perf_counter()
            save_checkpoint(str(tmp / "sync"), at, first.state)
            sync_s = time.perf_counter() - t0
            shutil.rmtree(tmp / "sync")
            log(f"{label}: sync save {sync_s:.3f} s ({nbytes / sync_s / 1e9:.2f} GB/s)")
        for n, t in enumerate(ck.timings if timed else [], 1):
            log(f"checkpoint: async save {n}: snapshot {t['snapshot_s']:.4f} s on the step "
                f"loop, blocked {t['blocked_s']:.4f} s on the previous write, device-to-host "
                f"copies {t['copy_s']:.4f} s on the stream ({nbytes / max(t['copy_s'], 1e-9) / 1e9:.1f} "
                f"GB/s), writer waited {t['copy_wait_s']:.4f} s for them, write "
                f"{t['write_s']:.3f} s in the background")
        finite = all(bool(torch.isfinite(v).all()) for v in saved.values())
        log(f"{label}: restored leaves equal to the saved state bit for bit: "
            f"{len(same)} of {len(saved)}; the saved state finite: {finite}")
        state_bytes = sum(v.numel() * v.element_size() for v in saved.values())
        if len(same) != len(saved) or nbytes < state_bytes:
            raise AssertionError(f"{label}: the restored state differs from the saved one")
        del first, ck, saved, restored
        torch.cuda.empty_cache()
        resumed = run(ckpt + ["--resume"], 4)
        losses = [h["loss/total"] for h in resumed.history]
        differ = [k for k, v in resumed.state.params.items()
                  if not _same_bits(v.cpu(), ref_params[k])]
        log(f"{label}: resume: steps {[h['step'] for h in resumed.history]}, losses {losses} "
            f"against uninterrupted {ref_losses[at:]}; param leaves not bit-equal {differ}")
        if not _same_bits(losses, ref_losses[at:]) or differ or int(resumed.state.step) != 4:
            raise AssertionError(f"{label}: the resumed run is not bit-equal to the "
                                 "uninterrupted one")
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return ref_losses, ref_params


# ---------------------------------------------------------------------------
# phase 8: the unfused optimizers at full width
# ---------------------------------------------------------------------------

def check_lamb_forms(device) -> None:
    """The gradients of one main-path step (bf16, accum 2) applied from one
    initial state three ways: fused-direct LAMB (K1/K2 in place), the
    ``core.lamb`` chain and the ``fused_lamb`` transform (K1/K2 on copies);
    every param, mu and nu leaf of the latter two within ``FORMS_TOL`` of
    the first.  Prints each leaf family's largest difference."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.kernels import LAUNCHES, fused_lamb_init, make_fused_lamb_step, \
        reset_launches
    from repro_torch.launch.train import build, parse_args
    from repro_torch.train.step import _microbatch_grads, make_loss_fn, make_optimizer

    trainer, data, _ = build(parse_args(MAIN_ARGV))
    model, tc = trainer.model, trainer.tc
    params = model.init(tc.seed, device)
    cast = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in params.items()}
    grads, _ = _microbatch_grads(make_loss_fn(model), cast, next(data), tc.grad_accum_steps)
    del cast, trainer
    reset_launches()
    direct = {k: v.clone() for k, v in params.items()}
    state = fused_lamb_init(params)
    make_fused_lamb_step(
        tc.learning_rate, tc.b1, tc.b2, tc.eps, tc.weight_decay, wd_mask=model.wd_mask(),
        trust_mask=model.trust_mask(), layer_axes=model.layer_axes(),
        phi_bounds=tc.phi_bounds, grad_clip_norm=tc.grad_clip_norm,
    )(direct, {k: g.clone() for k, g in grads.items()}, state)
    forms = {}
    for name, form_tc in (("chain", dataclasses.replace(tc, use_fused_lamb=False)),
                          ("fused_lamb transform", tc)):
        opt = make_optimizer(model, form_tc)
        updates, st = opt.update(grads, opt.init(params), params)
        adam = st if name != "chain" else st[1]
        forms[name] = (optim.apply_updates(params, updates), adam.mu, adam.nu)
        del updates, st
    torch.cuda.synchronize()
    k12 = (LAUNCHES["lamb_moments"], LAUNCHES["lamb_apply"])
    bad = []
    for name, (x, mu, nu) in forms.items():
        worst = {}
        for family, got, want in (("params", x, direct), ("mu", mu, state.mu),
                                  ("nu", nu, state.nu)):
            for k in want:
                d = (got[k] - want[k]).abs()
                worst[family] = max(worst.get(family, 0.0), float(d.max()))
                if not torch.allclose(got[k], want[k], **FORMS_TOL):
                    bad.append(f"{name} {family}/{k}")
        log(f"lamb forms: {name} against fused-direct, largest |difference| "
            + ", ".join(f"{f} {v:.3e}" for f, v in worst.items()))
    log(f"lamb forms: K1/K2 launches {k12} (fused-direct and the transform, "
        f"{LEAVES} leaves each); leaves outside rtol 2e-4, atol 2e-5: {bad}")
    if bad or k12 != (2 * LEAVES, 2 * LEAVES):
        raise AssertionError("the three forms of LAMB disagree")
    del params, grads, direct, state, forms
    torch.cuda.empty_cache()


def _slice_norms(x, stacked: bool):
    import torch

    if stacked:
        return torch.linalg.vector_norm(x, dim=tuple(range(1, x.ndim)))
    return torch.linalg.vector_norm(x).reshape(1)


def run_optimizer(device, name: str, fused: bool = False) -> dict:
    """``OPT_STEPS`` steps of one optimizer through the launcher's Trainer,
    the counts set to 0 just before and read just after; for a trust-ratio
    optimizer, each masked-in layer slice's first update held to norm
    lr·‖x‖ (1e-3 relative).  Returns its history rows."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch.train import build, lr_schedule, parse_args

    label = f"optimizer {name}{' (fused)' if fused else ''}"
    args = parse_args(OPT_ARGV + ["--optimizer", name] + (["--fused-lamb"] if fused else []))
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    trainer, data, _ = build(args)
    trainer.log = lambda msg: None
    trainer.init()
    trust, axes = trainer.model.trust_mask(), trainer.model.layer_axes()
    x0 = ({k: v.clone() for k, v in trainer.state.params.items() if trust[k]}
          if name in TRUST_OPTIMIZERS else {})
    trainer.fit(data, 1)
    if x0:
        lr0 = float(lr_schedule(args)[1](torch.zeros((), dtype=torch.int32, device=device)))
        worst = 0.0
        for k, x in x0.items():
            w = _slice_norms(x, axes[k] == 0)
            u = _slice_norms(trainer.state.params[k] - x, axes[k] == 0)
            rel = ((u - lr0 * w).abs() / (lr0 * w))[w > 0]
            worst = max(worst, float(rel.max()))
        log(f"{label}: first update, largest |‖Δx‖ / (lr·‖x‖) − 1| over the masked-in "
            f"layer slices {worst:.3e} (lr {lr0:.6g})")
        if not worst <= 1e-3:
            raise AssertionError(f"{label}: the first update's norm is not lr·‖x‖")
        del x0
    trainer.fit(data, OPT_STEPS - 1)
    torch.cuda.synchronize()
    launches, designs, copies = _counts()
    peak = torch.cuda.max_memory_allocated(device)
    _check_launches(label, OPT_STEPS, fused, launches, designs, copies)
    hist = trainer.history
    keys = ("loss/total", "grad_norm", "update_norm", "trust_ratio/min",
            "trust_ratio/max", "trust_ratio/mean")
    for k in keys:
        log(f"{label}: {k} {[h[k] for h in hist]}")
    walls = [h["wall_s"] for h in hist]
    log(f"{label}: step walls {[round(b - a, 4) for a, b in zip([0.0] + walls, walls)]} s "
        f"(the first includes its warm-up), peak memory {peak / 2**30:.2f} GiB, "
        f"launches {launches}")
    if len(hist) != OPT_STEPS or (name in FINITE_OPTIMIZERS
                                  and not all(math.isfinite(h["loss/total"]) for h in hist)):
        raise AssertionError(f"{label}: {len(hist)} steps, losses "
                             f"{[h['loss/total'] for h in hist]}")
    del trainer
    torch.cuda.empty_cache()
    return hist


def check_unfused_guard_and_stages(device) -> None:
    """The guard and the stages on transform chains: a ``grad_nan`` step
    bit-identical on unfused LAMB (after one clean step, so its moment and
    schedule counters are 1) and on LARS (from its initial state); the
    two-stage run on LANS, its ``ScheduleState.count`` restarted at the
    switch and its ``ScaleByAdamState.count`` carried over; and a LARS
    state saved, restored and resumed bit-equal."""
    import torch

    from repro_torch.launch.train import build, parse_args

    for name, clean_steps in (("lamb", 1), ("lars", 0)):
        trainer, data, _ = build(parse_args(OPT_ARGV + ["--optimizer", name,
                                                        "--skip-nonfinite"]))
        trainer.log = lambda msg: None
        trainer.init()
        trainer.fit(data, clean_steps)
        check_guard(trainer, device, f"guard on {name}", k12=(0, 0))
        del trainer
        torch.cuda.empty_cache()
    argv = [a for a in STAGES_ARGV if a != "--fused-lamb"] + ["--optimizer", "lans"]
    trainer, _ = _train(device, argv, STAGES_STEPS, "two stages, lans")
    o, state = trainer.state.opt_state, trainer.state
    counters = (int(o[1].count), int(o[2].count), int(state.step), int(state.skipped))
    log(f"two stages, lans: ScaleByAdamState.count, ScheduleState.count, step, skipped "
        f"{counters}")
    if [h["stage"] for h in trainer.history] != [0, 0, 0, 0, 1, 1] or counters != (6, 2, 6, 0):
        raise AssertionError("two stages, lans: the moment counter was not carried or the "
                             "schedule's not restarted")
    del trainer, state, o
    torch.cuda.empty_cache()
    # LARS's state is finite after one step and not after two (its norm
    # scales take unclipped steps, see PERF.md): save it after one
    lars = [a for a in RESUME_ARGV if a != "--fused-lamb"] + ["--optimizer", "lars"]
    check_checkpoint_resume(device, lars, "checkpoint, lars", timed=False, at=1)


# ---------------------------------------------------------------------------
# phase 9: the rest of training at full width
# ---------------------------------------------------------------------------

def _with_steps(argv: list, steps: int) -> list:
    """``argv`` with its ``--steps`` value replaced."""
    out = list(argv)
    out[out.index("--steps") + 1] = str(steps)
    return out


def _trainer(argv: list, remat: str = "none", **kw):
    """``(trainer, data, args)`` as the launcher builds them from ``argv``,
    with the model config's ``remat`` and the Trainer keywords ``kw`` in
    place of the launcher's."""
    from repro_torch.launch.train import build, parse_args

    args = parse_args(argv)
    trainer, data, _ = build(args, remat=remat, **kw)
    trainer.log = lambda msg: None
    return trainer, data, args


def _scratch(prefix: str) -> Path:
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(dir=ROOT / "build", prefix=prefix))


def check_telemetry(device, main_hist, main_launches) -> None:
    """(a) The main path with ``--telemetry-dir``: losses and update norms
    bit-identical to phase 5's, launch counts equal; then with
    ``--log-trust-ratios`` too: every event valid, one ``trust_ratios``
    event per step with the 13 leaves (24 values a stacked leaf), the last
    step's ratios equal to those the fused step handed K2, and a
    ``RUN_REPORT.json`` naming the card that compares equal to itself."""
    import importlib
    import shutil

    import torch

    from repro_torch.telemetry import RunReport, read_events

    # the module whose trust_ratio the fused step's composition calls (the
    # package's ``lamb_update`` name is the function)
    lamb_mod = importlib.import_module("repro_torch.kernels.lamb_update")

    tmp = _scratch("telem_")
    try:
        trainer, launches = _train(device, MAIN_ARGV + ["--telemetry-dir", str(tmp / "a")],
                                   MAIN_STEPS, "telemetry")
        keys = ("loss/total", "update_norm")
        same = all(_same_bits([h[k] for h in trainer.history], [h[k] for h in main_hist])
                   for k in keys)
        log(f"telemetry: losses and update norms bit-identical to phase 5: {same}; launch "
            f"counts equal: {launches == main_launches}")
        if not same or launches != main_launches:
            raise AssertionError("telemetry changed the main path")
        del trainer
        torch.cuda.empty_cache()

        seen = []   # every ratio the fused step handed K2, leaf by leaf
        real = lamb_mod.trust_ratio

        def capture(*a, **kw):
            out = real(*a, **kw)
            seen.append(out.detach().clone())
            return out

        lamb_mod.trust_ratio = capture
        try:
            trainer, _ = _train(device, MAIN_ARGV + ["--telemetry-dir", str(tmp / "b"),
                                                     "--log-trust-ratios"],
                                MAIN_STEPS, "telemetry + trust")
        finally:
            lamb_mod.trust_ratio = real
        events = read_events(tmp / "b" / "events.jsonl")   # validates every event
        trust = [e for e in events if e["event"] == "trust_ratios"]
        names = [k.replace("/", ".") for k in trainer.state.params]
        axes = trainer.model.layer_axes()
        widths = [LAYERS if axes[k] == 0 else 1 for k in trainer.state.params]
        shapes_ok = all(list(e["layers"]) == names and [len(e["layers"][n]["per_layer"])
                                                        for n in names] == widths
                        for e in trust)
        last = [trust[-1]["layers"][n]["per_layer"] for n in names]
        equal_k2 = last == [r.reshape(-1).tolist() for r in seen[-LEAVES:]]
        report = json.loads((tmp / "b" / "RUN_REPORT.json").read_text())
        rep = RunReport(report)
        gate = rep.compare(RunReport.load(tmp / "b" / "RUN_REPORT.json"),
                           {"train.final.loss/total": 0.0, "train.steps": 0.0,
                            "provenance.device_kind": 0.0, "trust_ratios.steps_recorded": 0.0})
        kind = report["provenance"]["device_kind"]
        log(f"telemetry + trust: {len(events)} events, all valid; types "
            f"{report['events']['types']}; trust_ratios events {len(trust)}, leaves and "
            f"widths as the params: {shapes_ok}; last step's ratios equal to K2's: "
            f"{equal_k2}; report status {report.get('status')}, device_kind {kind!r}, "
            f"compare against itself: {gate.ok}; span mean "
            f"{report['spans']['step']['mean_s']:.4f} s")
        log(f"telemetry + trust: per-leaf ratio range at step {trust[-1]['step']}: "
            + ", ".join(f"{n} [{min(v):.3g}, {max(v):.3g}]" for n, v in zip(names, last)))
        if len(trust) != MAIN_STEPS or not shapes_ok or not equal_k2 or not gate.ok \
                or kind != torch.cuda.get_device_name(0) or report.get("status") != "ok":
            raise AssertionError("the telemetry run's events or report are wrong")
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


ROLLBACK_FIELDS = ("reason", "step", "from_step", "batches_dropped", "rollbacks", "discarded")


def _rollback_run(device, argv: list, tmp) -> tuple:
    """8 batches of ``argv`` with a ``loss_spike`` at batch 5, async
    checkpoints every 4 under ``tmp``, the supervisor armed after 3 losses,
    the counts set to 0 just before ``fit``.  Returns ``(trainer, stream,
    events, launches, checkpoints on disk)``."""
    import torch

    from repro_torch.data import DataPipeline
    from repro_torch.kernels import reset_launches
    from repro_torch.telemetry import EventLog
    from repro_torch.train import FaultInjector, FaultSpec, SupervisorConfig

    inj = FaultInjector([FaultSpec("loss_spike", at=5, scale=100.0)])
    events = EventLog.memory()
    trainer, _, args = _trainer(argv, checkpoint_dir=str(tmp), checkpoint_every=4,
                                async_checkpoint=True, telemetry=events,
                                supervisor=SupervisorConfig(spike_window=8, min_history=3))
    cfg = trainer.model.cfg

    def stream():
        return DataPipeline(cfg, args.batch, args.seq, device=device, seed=args.seed,
                            rows=trainer.batch_rows)

    def make_data():
        return inj.wrap(stream())

    reset_launches()
    trainer.fit(make_data(), 8, data_factory=make_data)
    torch.cuda.synchronize()
    launches, _, _ = _counts()
    on_disk = sorted(p.name for p in tmp.iterdir() if p.name.startswith("step_"))
    return trainer, stream, events.events, launches, on_disk


def check_rollback(device) -> dict:
    """(b) 8 batches with a ``loss_spike`` at batch 5, async checkpoints
    every 4, the supervisor armed after 3 losses: one ``rollback`` event to
    the step-4 checkpoint, ``step == 8 - batches_dropped``, ``run_end`` ok,
    and the params bit-equal to an uninterrupted run over the same stream
    with batches [restored_i, resume_i) removed.  At most two checkpoints
    (4.0 GB each) are on disk; removed at the end.  Returns the rollback
    event's fields and the final params (host copies): phase 16's
    reference."""
    import shutil

    import torch

    argv = _with_steps(MAIN_ARGV, 8)
    tmp = _scratch("ckpt_rollback_")
    try:
        trainer, stream, events, launches, on_disk = _rollback_run(device, argv, tmp)
        rbs = [e for e in events if e["event"] == "rollback"]
        end = events[-1]
        log(f"rollback: events {[e['event'] for e in events]}; rollback "
            f"{ {k: v for k, v in rbs[0].items() if k != 't'} if rbs else None}; "
            f"step {int(trainer.state.step)}; run_end {end.get('status')}; checkpoints on "
            f"disk {on_disk}; launches {launches}")
        if len(rbs) != 1 or not rbs[0]["step"] < rbs[0]["from_step"] \
                or int(trainer.state.step) != 8 - rbs[0]["batches_dropped"] \
                or end["event"] != "run_end" or end["status"] != "ok" \
                or launches != _want_launches(8):
            raise AssertionError("the rollback run did not roll back once and finish")
        restored_i = rbs[0]["step"]       # no step was skipped: batch ordinal = step
        resume_i = restored_i + rbs[0]["batches_dropped"]
        params = dict(trainer.state.params)
        out = dict(fields={k: rbs[0].get(k) for k in ROLLBACK_FIELDS},
                   step=int(trainer.state.step), status=end["status"],
                   params={k: v.cpu() for k, v in params.items()})
        del trainer
        torch.cuda.empty_cache()
        ref, _, _ = _trainer(argv)
        kept = (b for i, b in enumerate(stream()) if not restored_i <= i < resume_i)
        ref.fit(kept, 8 - (resume_i - restored_i))
        torch.cuda.synchronize()
        differ = [k for k, v in params.items() if not _same_bits(v, ref.state.params[k])]
        log(f"rollback: params against an uninterrupted run without batches "
            f"[{restored_i}, {resume_i}) ({int(ref.state.step)} steps): leaves not "
            f"bit-equal {differ}")
        if differ:
            raise AssertionError("the rolled-back run is not the run without the dropped "
                                 "batches")
        del ref, params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def check_divergence(device) -> None:
    """(c) Momentum (no clip, as in the reference) at full width with the
    supervisor, a checkpoint every step and one rollback allowed: its
    step-2 loss is not finite (phase 8), the last validated step is 0 and
    no checkpoint is that old, so the launcher exits 3 and the report says
    ``diverged``.  One 2.667 GB checkpoint at most; removed at the end."""
    import shutil

    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train as launch_train

    tmp = _scratch("ckpt_diverge_")
    argv = [a for a in RESUME_ARGV if a != "--fused-lamb"] + [
        "--optimizer", "momentum", "--rollback-on-spike", "--max-rollbacks", "1",
        "--checkpoint-dir", str(tmp / "ck"), "--checkpoint-every", "1",
        "--telemetry-dir", str(tmp / "t")]
    try:
        reset_launches()
        code = None
        try:
            launch_train.main(argv)
        except SystemExit as e:   # the launcher's exit code is what is checked
            code = e.code
        torch.cuda.synchronize()
        launches, _, _ = _counts()
        report = json.loads((tmp / "t" / "RUN_REPORT.json").read_text())
        log(f"divergence: launcher exit code {code}; report status {report.get('status')}, "
            f"run_end {report.get('run_end')}; launches {launches}")
        if code != 3 or report.get("status") != "diverged":
            raise AssertionError("the diverging momentum run did not exit 3 as diverged")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


class _TermBefore:
    """Sends SIGTERM to its own process before yielding batch ``n``."""

    def __init__(self, inner, n: int):
        self.inner, self.n, self.i = inner, n, 0

    def __iter__(self):
        return self

    def __next__(self):
        import os
        import signal

        if self.i == self.n:
            os.kill(os.getpid(), signal.SIGTERM)
        self.i += 1
        return next(self.inner)


PREEMPT_FIELDS = ("step", "signal", "saved", "grace_s")


def check_preemption(device, ref_losses, ref_params, mesh: tuple = (),
                     label: str = "preemption") -> dict:
    """(d) The 4-step run of phase 7 with async checkpoints and
    ``--preempt-grace 30``, SIGTERM before batch 2: the ``preempt`` event
    says saved, the latest checkpoint sits at the stopped step, and a
    ``--resume`` run reaches step 4 bit-equal to phase 7's uninterrupted
    run.  One 4.0 GB checkpoint; removed at the end.  ``mesh``: the
    launcher's ``--mesh`` flags for both runs (phase 16).  Returns the
    ``preempt`` event's fields and the stopped step."""
    import shutil

    import torch

    from repro_torch.checkpoint import checkpoint_step, latest_checkpoint
    from repro_torch.launch.train import build, parse_args
    from repro_torch.telemetry import read_events

    tmp = _scratch("ckpt_preempt_")
    ckpt = ["--checkpoint-dir", str(tmp / "ck"), "--async-checkpoint", *mesh]
    try:
        trainer, data, _ = build(parse_args(RESUME_ARGV + ckpt + [
            "--preempt-grace", "30", "--telemetry-dir", str(tmp / "t")]))
        trainer.log = lambda msg: None
        trainer.fit(_TermBefore(data, 2), 4)
        stopped = int(trainer.state.step)
        trainer.telemetry.close()
        pe = [e for e in read_events(tmp / "t" / "events.jsonl") if e["event"] == "preempt"]
        latest = checkpoint_step(latest_checkpoint(str(tmp / "ck")))
        log(f"{label}: stopped at step {stopped}, status {trainer._status}; preempt "
            f"event {pe[-1] if pe else None}; latest checkpoint step {latest}")
        if len(pe) != 1 or not pe[0]["saved"] or latest != stopped or stopped >= 4 \
                or trainer._status != "preempted":
            raise AssertionError(f"{label}: the preempted run did not save its stopped step")
        out = dict(fields={k: pe[0].get(k) for k in PREEMPT_FIELDS}, stopped=stopped)
        del trainer
        torch.cuda.empty_cache()
        resumed, data, _ = build(parse_args(RESUME_ARGV + ckpt + ["--resume"]))
        resumed.log = lambda msg: None
        resumed.fit(data, 4)
        losses = [h["loss/total"] for h in resumed.history]
        differ = [k for k, v in resumed.gather_state().params.items()
                  if not _same_bits(v.cpu(), ref_params[k])]
        log(f"{label}: resumed steps {[h['step'] for h in resumed.history]}, losses "
            f"{losses} against phase 7's uninterrupted {ref_losses[stopped:]}; param leaves "
            f"not bit-equal {differ}")
        if not _same_bits(losses, ref_losses[stopped:]) or differ \
                or int(resumed.state.step) != 4:
            raise AssertionError(f"{label}: the resumed run is not bit-equal to the "
                                 "uninterrupted one")
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def check_remat(device) -> None:
    """(e) 2 main-path steps with and without ``remat="full"``: losses and
    params bit-equal, K3 launched once more per layer and micro-batch (the
    recomputed forward) and K4/K5 as without, and a lower peak."""
    import torch

    from repro_torch.kernels import reset_launches

    argv = _with_steps(MAIN_ARGV, 2)
    runs = {}
    for remat in ("none", "full"):
        trainer, data, _ = _trainer(argv, remat=remat)
        trainer.init()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        trainer.fit(data, 2)
        torch.cuda.synchronize()
        launches, designs, copies = _counts()
        runs[remat] = dict(losses=[h["loss/total"] for h in trainer.history],
                           params={k: v.cpu() for k, v in trainer.state.params.items()},
                           launches=launches, peak=torch.cuda.max_memory_allocated(device))
        log(f"remat {remat}: losses {runs[remat]['losses']}, peak "
            f"{runs[remat]['peak'] / 2**30:.2f} GiB, launches {launches}, by design "
            f"{designs}, copies {copies}")
        del trainer, data
        torch.cuda.empty_cache()
    plain, remat = runs["none"], runs["full"]
    want = _want_launches(2)
    want["flash_fwd"] *= 2
    differ = [k for k, v in remat["params"].items() if not _same_bits(v, plain["params"][k])]
    log(f"remat: losses bit-equal {_same_bits(remat['losses'], plain['losses'])}, param "
        f"leaves not bit-equal {differ}; K3 launches {remat['launches']['flash_fwd']} "
        f"(want {want['flash_fwd']}); peak {remat['peak'] / 2**30:.2f} against "
        f"{plain['peak'] / 2**30:.2f} GiB without remat")
    if not _same_bits(remat["losses"], plain["losses"]) or differ \
            or remat["launches"] != want or plain["launches"] != _want_launches(2) \
            or not remat["peak"] < min(plain["peak"], 12.01 * 2**30):
        raise AssertionError("remat is not bit-equal, or its launches or peak are off")


TIMING_VARIANTS = ("nothing", "telemetry", "telemetry + trust", "rollback-armed", "remat")


def time_training_variants(device, rounds: int = 2) -> None:
    """The main path's step with each of ``TIMING_VARIANTS`` in turns,
    ``rounds`` rounds (``profile_step.measure``: two warm-up steps, one
    profiled, five timed with CUDA events; ``--log-every 1000``, so one
    logged step a ``fit``).  Rollback-armed saves no checkpoint inside the
    window (``--checkpoint-every 1000``): the supervisor's transfer a step
    is what it adds.  Prints each run and each variant's spread."""
    import shutil

    import torch

    from repro_torch.launch.profile_step import DEFAULT_ARGV, measure

    tmp = _scratch("timing_")
    extra = {
        "nothing": [], "remat": [],
        "telemetry": ["--telemetry-dir", str(tmp / "t")],
        "telemetry + trust": ["--telemetry-dir", str(tmp / "tt"), "--log-trust-ratios"],
        "rollback-armed": ["--rollback-on-spike", "--checkpoint-dir", str(tmp / "ck"),
                           "--checkpoint-every", "1000"],
    }
    got = {v: [] for v in TIMING_VARIANTS}
    try:
        for rnd in range(rounds):
            order = TIMING_VARIANTS if rnd % 2 == 0 else TIMING_VARIANTS[::-1]
            for v in order:
                trainer, data, _ = _trainer(DEFAULT_ARGV + ["--steps", "8"] + extra[v],
                                            remat="full" if v == "remat" else "none")
                r = measure(trainer, data)
                got[v].append(r)
                log(f"timing round {rnd + 1} {v}: wall {r['wall_ms']:.2f} ms/step, CUDA-event "
                    f"span {r['span_ms']:.2f} ms/step, busy {r['busy_ms']:.2f} ms in "
                    f"{r['launches']} launches, idle share {r['idle']:.3f}, peak "
                    f"{r['peak_gib']:.2f} GiB")
                del trainer, data
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for v in TIMING_VARIANTS:
        rs = got[v]
        spread = {k: [round(r[k], 2) for r in rs] for k in ("wall_ms", "span_ms", "busy_ms")}
        log(f"timing {v}: wall {spread['wall_ms']} ms/step (median "
            f"{sorted(spread['wall_ms'])[len(rs) // 2]}), span {spread['span_ms']}, busy "
            f"{spread['busy_ms']}, launches {[r['launches'] for r in rs]}, peak "
            f"{[round(r['peak_gib'], 2) for r in rs]} GiB")


# ---------------------------------------------------------------------------
# phase 10: serving smollm-360m at full width
# ---------------------------------------------------------------------------

def _serve_setup(device):
    """smollm-360m at full width (bf16 activations, fp32 params from seed 0),
    its twin with flash attention on (K3 on the prefill; the same params),
    and the 8 prompts of 128 tokens ``launch/serve.py`` makes from seed 0."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(SERVE_ARCH)
    model, fmodel = build_model(cfg), build_model(cfg.replace(use_flash_kernel=True))
    params = model.init(0, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, min(cfg.vocab_size, 1024), size=SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    log(f"serving: {cfg.name} {model.param_count() / 1e6:.1f}M params, {cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, head dim {cfg.head_dim}, "
        f"vocab {cfg.vocab_size}, {cfg.activation_dtype} activations")
    return model, fmodel, params, prompts


def _top_ulp(x):
    """A bf16 ulp of the magnitude of ``x`` (a float)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def _pool_prefill_logits(model, params, prompts, device):
    """(requests, V) fp32 last-position logits of one batch-1 pool prefill per prompt."""
    import torch

    from repro_torch.serve import make_pool_prefill

    prefill = make_pool_prefill(model, SERVE_MAX_LEN)
    with torch.inference_mode():
        return torch.cat([prefill(params, torch.from_numpy(p[None].copy()).to(device))[0]
                          .float() for p in prompts])


def check_serving_greedy(device, model, params, prompts):
    """(a) The 8 requests through the static ``Engine`` (one batch of 8) and
    through ``ContinuousEngine(n_slots=4)`` (admissions mid-decode), greedy.
    cuBLAS may pick other kernels for other M, so tokens may part where
    the static run's top-2 logit margin is within rounding: at the first
    step where two sequences part, that margin must be at most MARGIN_ULPS
    bf16 ulps of the top logit (the static run's logits from a replay of
    its own tokens through the engine's two steps).  Returns the continuous
    run's tokens."""
    import numpy as np
    import torch

    from repro_torch.serve import ContinuousEngine, Engine, Request, ServeRequest
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    b = len(prompts)
    t0 = time.perf_counter()
    static = Engine(model, params, max_len=SERVE_MAX_LEN).generate_batch(
        [Request(p, max_new_tokens=SERVE_NEW) for p in prompts])
    t_static = time.perf_counter() - t0
    st = np.stack([r.out_tokens for r in static])
    pre, dec = make_prefill_step(model), make_decode_step(model)
    with torch.inference_mode():
        cache = model.make_cache(b, SERVE_MAX_LEN, device)
        last, cache = pre(params, {"tokens": torch.from_numpy(np.stack(prompts)).to(device)},
                          cache)
        rows = [last.float()]
        for t in range(SERVE_NEW - 1):
            pos = torch.full((b, 1), SERVE_PROMPT + t, dtype=torch.int32, device=device)
            last, cache = dec(params, cache, torch.from_numpy(st[:, t:t + 1].copy()).to(device),
                              pos)
            rows.append(last.float())
        logits = torch.stack(rows, 1)   # (b, new, V)
        top2 = logits.topk(2, -1).values.cpu().numpy()
        replay = logits.argmax(-1).cpu().numpy()
        static_first = logits[:, 0]
        del logits, cache
    if not (replay == st).all():
        raise AssertionError("the replay of the static run picks other tokens than the run")
    t0 = time.perf_counter()
    cont = ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN).generate(
        [ServeRequest(p, max_new_tokens=SERVE_NEW) for p in prompts])
    t_cont = time.perf_counter() - t0
    ct = np.stack([np.asarray(r.out_tokens) for r in cont])
    first = _pool_prefill_logits(model, params, prompts, device)
    d_first = (first - static_first).abs().amax(-1).cpu().numpy()
    same = [bool((c == s).all()) for c, s in zip(ct, st)]
    faults, parts = [], []
    for i, ok in enumerate(same):
        if ok:
            continue
        t = int(np.argmax(ct[i] != st[i]))
        margin, tol = top2[i, t, 0] - top2[i, t, 1], MARGIN_ULPS * _top_ulp(top2[i, t, 0])
        parts.append(f"request {i} at step {t}: static margin {margin:.4g} (tol {tol:.4g})")
        if margin > tol:
            faults.append(i)
    margins = top2[:, :, 0] - top2[:, :, 1]
    log(f"serving (a): static batch of {b} in {t_static:.2f} s, continuous over {SERVE_SLOTS} "
        f"slots in {t_cont:.2f} s; identical token sequences {sum(same)} of {b}; first tokens "
        f"agree {int((ct[:, 0] == st[:, 0]).sum())} of {b}; |first-token logits, batch 8 - "
        f"batch 1 prefill| max {d_first.max():.4g} (top logits {top2[:, 0, 0].round(3).tolist()}); "
        f"parted: {parts or 'none'}; static top-2 margins: min {margins.min():.4g}, "
        f"{int((margins == 0).sum())} exact ties in {margins.size} steps")
    if faults or any(len(r.out_tokens) != SERVE_NEW for r in cont) \
            or any(r.status.value != "completed" for r in cont):
        raise AssertionError(f"static and continuous greedy runs part at a clear margin: "
                             f"requests {faults}")
    return ct


def check_serving_flash(device, model, fmodel, params, prompts, greedy_tokens) -> int:
    """(b) The continuous run of (a) with flash attention on: K3 launches 32
    layers x prefills times, all on ``flash_fwd_mma_kernel``, and no other
    kernel of the port.  Then each prompt's batch-1 prefill with K3 once
    more, each of its 32 K3 calls held against the plain version on the
    same q, k, v (the model's own, in its layout) by ``check_flash``'s bf16
    rule.  The last-position logits of a K3 prefill cannot be held to the
    dense prefill's: the reference's fan-in init saturates attention (std
    1/sqrt(heads) on ``wq``), and two bf16 roundings of the 32 layers part
    by the logits' own size (as bf16 and fp32 do); the distances are logged.  Returns K3's
    launches in the run."""
    import numpy as np
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention
    from repro_torch.serve import ContinuousEngine, ServeRequest

    torch.cuda.synchronize()
    reset_launches()
    eng = ContinuousEngine(fmodel, params, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    out = eng.generate([ServeRequest(p, max_new_tokens=SERVE_NEW) for p in prompts])
    torch.cuda.synchronize()
    launches, designs, copies = _counts()
    prefills = sum(r.attempts for r in out)
    want = {k: (SERVE_LAYERS * prefills if k == "flash_fwd" else 0) for k in launches}
    ft = np.stack([np.asarray(r.out_tokens) for r in out])
    log(f"serving (b): K3 on the prefill: {prefills} prefills, launches {launches}, by design "
        f"{designs['flash_fwd']}, copies {copies}; tokens identical to (a)'s dense run "
        f"{int(sum((f == g).all() for f, g in zip(ft, greedy_tokens)))} of {len(prompts)}")
    if launches != want or designs["flash_fwd"] != {"mma": SERVE_LAYERS * prefills, "fma": 0} \
            or any(copies.values()):
        raise AssertionError(f"serving with flash: launches {launches}, want {want}")

    real, errs = attention.flash_sdpa, []

    def held(q, k, v, **kw):
        o = real(q, k, v, **kw)
        ref = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              kw.get("kv_valid"), causal=kw["causal"], window=kw["window"],
                              plain=True).transpose(1, 2).float()
        atol = 1e-4 * max(1.0, float(ref.abs().max()))
        errs.append((bool(torch.allclose(o.float(), ref, rtol=1e-2, atol=atol)),
                     float((o.float() - ref).abs().max())))
        return o

    attention.flash_sdpa = held
    try:
        flash = _pool_prefill_logits(fmodel, params, prompts, device)
    finally:
        attention.flash_sdpa = real
    dense = _pool_prefill_logits(model, params, prompts, device)
    ref = _pool_prefill_logits(build_model(model.cfg.replace(activation_dtype="float32")),
                               params, prompts, device)
    log(f"serving (b): K3 in {len(errs)} prefill attention calls (32 layers x {len(prompts)} "
        f"prompts) against its plain version on the same q, k, v: within rtol 1e-2 + 1e-4 of "
        f"the scale {sum(ok for ok, _ in errs)} of {len(errs)}, |do| max "
        f"{max(e for _, e in errs):.3g}; whole-model last-position logits, max over the "
        f"vocab: |K3 - dense| {[round(x, 3) for x in (flash - dense).abs().amax(-1).tolist()]}, "
        f"|dense - fp32| {[round(x, 3) for x in (dense - ref).abs().amax(-1).tolist()]}, "
        f"top logit {[round(x, 3) for x in ref.amax(-1).tolist()]}")
    if len(errs) != SERVE_LAYERS * len(prompts) or not all(ok for ok, _ in errs) \
            or not bool(torch.isfinite(flash).all()):
        raise AssertionError("K3 on the serving prefill disagrees with its plain version")
    return launches["flash_fwd"]


def check_serving_sampling(device, model, params, prompts, greedy_tokens) -> None:
    """(c) Temperature 0.8 and top-k 40 on the odd requests, greedy on the
    even, through ``ContinuousEngine(n_slots=4)``: seed 0 twice gives the
    same tokens, seed 1 others; every token a sampled row draws lies in its
    row's top-k of the logits it was drawn from (``sample_tokens`` wrapped
    to record them); the greedy rows equal (a)'s tokens."""
    import numpy as np
    import torch

    import repro_torch.serve.continuous as continuous
    from repro_torch.serve import ContinuousEngine, ServeRequest

    def run(seed):
        reqs = [ServeRequest(p, max_new_tokens=SERVE_NEW, temperature=0.8 if i % 2 else 0.0,
                             top_k=40 if i % 2 else 0) for i, p in enumerate(prompts)]
        eng = ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                               seed=seed)
        return np.stack([np.asarray(r.out_tokens) for r in eng.generate(reqs)])

    seen = []
    real = continuous.sample_tokens

    def record(gen, logits, temperature, top_k=None):
        out = real(gen, logits, temperature, top_k)
        seen.append((logits.float(), temperature.clone(), top_k.clone(), out.clone()))
        return out

    continuous.sample_tokens = record
    try:
        a = run(0)
    finally:
        continuous.sample_tokens = real
    b, c = run(0), run(1)
    outside = 0
    draws = 0
    for logits, temps, top_k, out in seen:
        kth = torch.gather(logits.sort(-1, descending=True).values, -1,
                           (top_k.clamp(min=1).long() - 1)[:, None])[:, 0]
        picked = torch.gather(logits, -1, out.long()[:, None])[:, 0]
        hot = temps > 0
        outside += int((hot & (picked < kth)).sum())
        outside += int((~hot & (out.long() != logits.argmax(-1))).sum())
        draws += int(hot.sum())
    greedy_same = bool((a[0::2] == greedy_tokens[0::2]).all())
    log(f"serving (c): seed 0 twice identical {bool((a == b).all())}; seed 1 differs on "
        f"{int((a != c).any(-1).sum())} of {len(prompts) // 2} sampled requests; {draws} "
        f"sampled draws in {len(seen)} calls, outside the row's top-k or off argmax: "
        f"{outside}; greedy rows equal (a)'s: {greedy_same}")
    if not (a == b).all() or (a[1::2] == c[1::2]).all() or outside or not greedy_same \
            or not (a[0::2] == c[0::2]).all():
        raise AssertionError("sampling is not reproducible, in its top-k or greedy where asked")


def check_serving_faults(device) -> None:
    """(d) The launcher with ``--inject-faults`` and a stall SLO: each request
    ends in exactly one terminal state (the nan retries and completes, the
    persistent corruption exhausts its retries and fails), every event is
    valid, and ``RUN_REPORT.json``'s serve section names the card."""
    import shutil

    import torch

    from repro_torch.launch import serve as launch_serve
    from repro_torch.telemetry import read_events

    tmp = _scratch("serve_")
    try:
        out = launch_serve.main(SERVE_FAULT_ARGV + ["--telemetry-dir", str(tmp)])
        events = read_events(tmp / "events.jsonl")   # validates every event
        report = json.loads((tmp / "RUN_REPORT.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    serve = report["serve"]
    card = torch.cuda.get_device_name(0)
    counts = {s: sum(r.status.value == s for r in out)
              for s in ("completed", "shed", "timed_out", "failed")}
    log(f"serving (d): terminal states {counts}; report by_status {serve['by_status']}, "
        f"lifecycle {serve.get('lifecycle')}, device {serve['stats'].get('device')!r}, "
        f"provenance {report['provenance']['device_kind']!r}; {len(events)} events, all valid")
    if sum(counts.values()) != len(out) or serve["by_status"] != counts \
            or counts != {"completed": SERVE_REQUESTS - 1, "shed": 0, "timed_out": 0,
                          "failed": 1} \
            or serve["stats"].get("device") != card \
            or report["provenance"]["device_kind"] != card:
        raise AssertionError("the faulted serving run's terminal states or report are wrong")


def check_serving_launcher() -> None:
    """(e) ``python -m repro_torch.launch.serve`` as a user runs it, on the card."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *SERVE_LAUNCH_ARGV],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    log(f"serving (e): launcher exit {out.returncode} in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(ln for ln in lines if ln.startswith(("arch=", "stats:", "done:"))))
    want = f"done: submitted={SERVE_LAUNCH_REQUESTS} completed={SERVE_LAUNCH_REQUESTS} "
    if out.returncode != 0 or not lines or not lines[-1].startswith(want):
        raise AssertionError(f"the serve launcher failed: {out.stderr[-2000:]}")


def _device_rows(prof) -> list:
    """``(name, ms, count)`` of the device kernels and copies of a finished
    ``torch.profiler`` trace, summed by name from the trace's raw events
    (``key_averages`` spends minutes on the ~0.5 M events of an xlstm
    step)."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(key, ms, n) for key, (ms, n) in rows.items()]


def _profile_calls(fn, n: int = 5) -> dict:
    """Two warm-up calls, one under ``torch.profiler``, then ``n`` between
    CUDA events: wall and event-span ms per call, the profiled call's busy
    ms and launches, the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(ms, count) for _, ms, count in _device_rows(prof)]
    busy = sum(ms for ms, _ in rows)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    span = start.elapsed_time(end) / n
    return dict(wall_ms=wall, span_ms=span, busy_ms=busy, launches=sum(c for _, c in rows),
                idle=1 - busy / span)


def time_serving(device, model, fmodel, params, prompts, rate: float, rounds: int = 2) -> dict:
    """(f) In turns, ``rounds`` rounds: one 128-token prefill, dense and with
    K3; one decode step over 8 full slots (the engine's step, its one sync
    included), greedy; a continuous run of 16 requests over 8 slots with its
    ``serving_stats``; then peak memory, the pool's bytes, the syncs a
    decode step makes, and K3 alone at the serving prefill's shape beside
    its plain version, its bound and ``scaled_dot_product_attention``'s
    forward (a yardstick only).  Returns K3's serving numbers."""
    import warnings

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import FlashSpec, flash_attention_fwd
    from repro_torch.serve import (ContinuousEngine, KVPool, ServeRequest, make_pool_decode_step,
                                   make_pool_prefill, serving_stats)

    slots, max_len = 8, SERVE_PROMPT + 64 + 8
    prompt = torch.from_numpy(prompts[0][None].copy()).to(device)
    pre = {"dense": make_pool_prefill(model, max_len), "K3": make_pool_prefill(fmodel, max_len)}
    step = make_pool_decode_step(model, greedy=True)
    got = {k: [] for k in ("prefill dense", "prefill K3", "decode", "engine")}
    with torch.inference_mode():
        pool = KVPool(model, slots, max_len, device)
        for slot in range(slots):
            last, c1 = pre["dense"](params, torch.from_numpy(prompts[slot % len(prompts)][None]
                                                               .copy()).to(device))
            pool.insert(c1, pool.acquire(), SERVE_PROMPT)
        state = {"toks": last.argmax(-1).to(torch.int32).repeat(slots),
                 "pos": torch.full((slots,), SERVE_PROMPT, dtype=torch.int32, device=device)}
        active = torch.ones(slots, dtype=torch.bool, device=device)
        temps = torch.zeros(slots, device=device)
        top_k = torch.zeros(slots, dtype=torch.int32, device=device)

        def decode_step():
            toks, state["pos"], _ = step(params, pool.cache, state["toks"], state["pos"], active,
                                         temps, top_k, None)
            state["toks"] = toks
            toks.cpu()   # the engine's one sync a step

        for rnd in range(rounds):
            for name in ("dense", "K3"):
                r = _profile_calls(lambda: pre[name](params, prompt))
                got[f"prefill {name}"].append(r)
            r = _profile_calls(decode_step)
            got["decode"].append(r)
            torch.cuda.reset_peak_memory_stats(device)
            eng = ContinuousEngine(model, params, n_slots=slots, max_len=max_len)
            reqs = [ServeRequest(prompts[i % len(prompts)], max_new_tokens=SERVE_NEW)
                    for i in range(2 * slots)]
            stats = serving_stats(eng.generate(reqs))
            stats["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            stats["pool_gb"] = eng.pool.nbytes / 1e9
            got["engine"].append(stats)
            del eng
            for k in ("prefill dense", "prefill K3", "decode"):
                r = got[k][-1]
                log(f"serving timing round {rnd + 1} {k}: wall {r['wall_ms']:.3f} ms, event span "
                    f"{r['span_ms']:.3f} ms, busy {r['busy_ms']:.3f} ms in {r['launches']} "
                    f"launches, idle share {r['idle']:.3f}")
            log(f"serving timing round {rnd + 1} engine (16 requests, 8 slots, 128 + 32 tokens): "
                f"{stats['tokens_per_s']:.1f} tokens/s, TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} "
                f"p99 {stats['ttft_p99_s'] * 1e3:.1f} ms, latency p50 "
                f"{stats['latency_p50_s'] * 1e3:.1f} p99 {stats['latency_p99_s'] * 1e3:.1f} ms, "
                f"peak {stats['peak_gib']:.3f} GiB, pool {stats['pool_gb']:.4f} GB")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(4):
                    decode_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        log(f"serving: synchronizing calls in 4 decode steps: {syncs}")
        if syncs != 4:
            raise AssertionError(f"a decode step makes {syncs / 4:g} syncs, not 1: "
                                 f"{sorted({str(w.message)[:120] for w in caught})}")
        del pool

    gen = torch.Generator(device=device).manual_seed(7)
    h, hkv, s, d = 15, 5, SERVE_PROMPT, 64
    q = torch.randn((1, h, s, d), generator=gen, device=device).to(torch.bfloat16)
    k, v = (torch.randn((1, hkv, s, d), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    spec = FlashSpec(d**-0.5, True, 0, False)
    kr, vr = (x.repeat_interleave(h // hkv, 1) for x in (k, v))
    times = {"plain": [], "cuda": []}
    for plain in (True, False, False, True):
        times["plain" if plain else "cuda"].append(
            cuda_ms(lambda: flash_attention_fwd(q, k, v, None, spec, plain=plain)))
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True))
    # the causal (row, key) pairs this run computes
    work = cost.flash_fwd(1, h, hkv, s, s, d, torch.bfloat16, causal=True)
    out = dict(ms=min(times["cuda"]), plain_ms=min(times["plain"]), **bound_of(work, rate),
               library_ms=sdpa)
    log(f"time flash_fwd serving prefill (b 1 h {h} hkv {hkv} s {s} d {d} causal bf16): kernel "
        f"{times['cuda']} ms, plain {times['plain']} ms; bound {out['bound_ms']:.5f} ms by "
        f"{out['bound_by']} ({work.bytes / 1e6:.3f} MB, {work.operations / 1e6:.1f} MFLOP): "
        f"latency-bound; "
        f"scaled_dot_product_attention forward (k, v repeated to {h} heads) {sdpa:.4f} ms")
    for k_, rs in got.items():
        keys = ("tokens_per_s", "ttft_p50_s", "latency_p50_s", "peak_gib") if k_ == "engine" \
            else ("wall_ms", "span_ms", "busy_ms", "launches", "idle")
        log(f"serving timing {k_}: " + ", ".join(
            f"{key} {[round(float(r[key]), 4) for r in rs]}" for key in keys))
    del q, k, v, kr, vr
    torch.cuda.empty_cache()
    return out


def run_serving(device, rate: float) -> dict:
    """Phase 10; returns K3's serving launches and times for the kernels line."""
    import torch

    t0 = time.perf_counter()
    model, fmodel, params, prompts = _serve_setup(device)
    greedy = check_serving_greedy(device, model, params, prompts)
    launches = check_serving_flash(device, model, fmodel, params, prompts, greedy)
    check_serving_sampling(device, model, params, prompts, greedy)
    check_serving_faults(device)
    check_serving_launcher()
    timing = time_serving(device, model, fmodel, params, prompts, rate)
    del params
    torch.cuda.empty_cache()
    log(f"serving: phase 10 took {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, **timing)


# ---------------------------------------------------------------------------
# phase 11: granite-moe-1b-a400m at full width
# ---------------------------------------------------------------------------

def run_moe_training(device) -> dict:
    """(a) ``repro_torch.launch.train`` on granite-moe-1b-a400m: finite
    losses, the MoE metrics in every history row, weights that moved as the
    kernels reported, and K1–K8 launched exactly as worked out beforehand,
    every bf16 K3–K8 launch on the tensor cores.  Returns the launches."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train as launch_train

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    trainer = launch_train.main(MOE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, designs, copies = _counts()
    peak = torch.cuda.max_memory_allocated(device)
    hist, cfg = trainer.history, trainer.model.cfg
    log(f"moe training: {cfg.name} {trainer.model.param_count() / 1e9:.3f}B params, "
        f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
        f"{cfg.n_experts} experts top-{cfg.n_experts_per_tok}, vocab {cfg.vocab_size}; "
        f"{len(hist)} steps in {wall:.1f} s, peak memory {peak / 2**30:.2f} GiB")
    keys = ("loss/total", "loss/ce", "loss/moe_lb", "moe/drop_fraction", "grad_norm",
            "update_norm")
    for h in hist:
        log("moe training step " + str(h["step"]) + ": " + ", ".join(
            f"{k} {h[k]:.5g}" for k in keys if k in h))
    if len(hist) != MOE_STEPS or len(trainer.state.params) != MOE_LEAVES \
            or not (cfg.use_flash_kernel and cfg.use_fused_ce_head and cfg.n_experts):
        raise AssertionError(f"{len(hist)} logged steps, {len(trainer.state.params)} leaves, "
                             f"flash {cfg.use_flash_kernel}, fused CE {cfg.use_fused_ce_head}")
    for h in hist:
        if any(k not in h or not math.isfinite(h[k]) for k in keys):
            raise AssertionError(f"moe training: missing or non-finite metrics: {h}")
    init = trainer.model.init(trainer.tc.seed, device)
    trust = trainer.model.trust_mask()
    moved_sq, still = 0.0, []
    for k, p in trainer.state.params.items():
        d = float((p - init[k]).float().square().sum())
        moved_sq += d
        if d == 0.0:
            still.append(k)
    del init
    travelled = sum(h["update_norm"] for h in hist)
    log(f"moe training: |x4 - x0| {math.sqrt(moved_sq):.4f} against the update norms' sum "
        f"{travelled:.4f}; leaves that did not move: {still}; launches {launches}; by design "
        f"{designs}; copies {copies}")
    if [k for k in still if trust[k]] or not 0.0 < math.sqrt(moved_sq) <= travelled * 1.0001:
        raise AssertionError("moe training: the parameters did not move as the kernels reported")
    _check_launches("moe training", MOE_STEPS, True, launches, designs, copies,
                    leaves=MOE_LEAVES, layers=MOE_LAYERS)
    del trainer
    torch.cuda.empty_cache()
    return launches


def run_moe_serving(device) -> dict:
    """(b) The 8 prompts of 128 tokens, 32 new greedy tokens, through the
    static ``Engine`` one request at a time and through the
    ``ContinuousEngine`` over 4 slots, with flash attention on: K3 launched
    24 layers x prefills times and no other kernel, each K3 call within a
    bf16 ulp of its plain version on the same q, k, v (``check_flash``'s
    rule), each prefill's drop fraction logged.  MoE capacity depends on the
    tokens a call routes, so the static engine takes one request per call:
    both engines then route T = 128 at each prefill, and at decode (T = 1 and
    T = 4) the capacity max(int(cf·T·k/E), k) = 8 holds every expert's at
    most T assignments, so nothing drops there.  The two runs must give the
    same sequences up to phase 10's parting rule: where they part, the static
    run's own top-2 margin at that step (recorded from its logits) is at most
    MARGIN_ULPS bf16 ulps of its top logit.  Returns K3's launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model, transformer
    from repro_torch.models.layers import attention
    from repro_torch.serve import ContinuousEngine, Engine, Request, ServeRequest

    cfg = get_config(MOE_ARCH).replace(use_flash_kernel=True)
    model = build_model(cfg)
    params = model.init(0, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, min(cfg.vocab_size, 1024), size=SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    real_fwd, real_sdpa = transformer.forward, attention.flash_sdpa
    prefills, held, steps = [], [], []

    def recorded(params_, batch, cfg_, *, caches=None, decode=False, positions=None,
                 return_hidden=False):
        logits, aux = real_fwd(params_, batch, cfg_, caches=caches, decode=decode,
                               positions=positions, return_hidden=return_hidden)
        if caches is not None and not decode:
            prefills.append((batch["tokens"][0].cpu().numpy().tobytes(),
                             float(aux["moe_drop_fraction"])))
        if caches is not None:
            steps.append(logits[:, -1].float().topk(2, -1))
        return logits, aux

    def checked(q, k, v, **kw):
        o = real_sdpa(q, k, v, **kw)
        ref = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              kw.get("kv_valid"), causal=kw["causal"], window=kw["window"],
                              plain=True).transpose(1, 2).float()
        atol = 1e-4 * max(1.0, float(ref.abs().max()))
        held.append((bool(torch.allclose(o.float(), ref, rtol=1e-2, atol=atol)),
                     float((o.float() - ref).abs().max())))
        return o

    torch.cuda.synchronize()
    reset_launches()
    transformer.forward, attention.flash_sdpa = recorded, checked
    static, top2, top1 = [], [], []
    try:
        t0 = time.perf_counter()
        eng = Engine(model, params, max_len=SERVE_MAX_LEN)
        for p in prompts:
            steps.clear()
            static.append(eng.generate_batch([Request(p, max_new_tokens=SERVE_NEW)])[0])
            top2.append(torch.cat([r.values for r in steps[:SERVE_NEW]]).cpu().numpy())
            top1.append(torch.cat([r.indices[:, 0] for r in steps[:SERVE_NEW]]).cpu().numpy())
        t_static = time.perf_counter() - t0
        n_static = len(prefills)
        t0 = time.perf_counter()
        cont = ContinuousEngine(model, params, n_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN).generate(
            [ServeRequest(p, max_new_tokens=SERVE_NEW) for p in prompts])
        t_cont = time.perf_counter() - t0
    finally:
        transformer.forward, attention.flash_sdpa = real_fwd, real_sdpa
    torch.cuda.synchronize()
    launches, designs, copies = _counts()
    n_pre = len(prompts) + sum(r.attempts for r in cont)
    want = {k: (MOE_LAYERS * n_pre if k == "flash_fwd" else 0) for k in launches}
    st = np.stack([r.out_tokens for r in static])
    ct = np.stack([np.asarray(r.out_tokens) for r in cont])
    top2 = np.stack(top2)                        # (requests, new, 2)
    margins = top2[..., 0] - top2[..., 1]
    # the recorded logits are the ones the static run picked from (a tie may
    # pick either)
    replay_ok = bool(((np.stack(top1) == st) | (margins == 0)).all())
    drop_static = [d for _, d in prefills[:n_static]]
    drop_cont = dict(prefills[n_static:])
    parts, faults = [], []
    for i in range(len(prompts)):
        if (ct[i] == st[i]).all():
            continue
        t = int(np.argmax(ct[i] != st[i]))
        tol = MARGIN_ULPS * _top_ulp(top2[i, t, 0])
        parts.append(f"request {i} at step {t}: static margin {margins[i, t]:.4g} (tol {tol:.4g})")
        if margins[i, t] > tol:
            faults.append(i)
    log(f"moe serving: static one request at a time in {t_static:.2f} s, continuous over "
        f"{SERVE_SLOTS} slots in {t_cont:.2f} s; {len(prefills)} prefills, drop fractions "
        f"static {[round(x, 5) for x in drop_static]}, continuous "
        f"{[round(drop_cont.get(p.tobytes(), -1.0), 5) for p in prompts]}; identical token "
        f"sequences {sum(bool((c == x).all()) for c, x in zip(ct, st))} of {len(prompts)}; "
        f"parted: {parts or 'none'}; static top-2 margins: min {margins.min():.4g}, "
        f"{int((margins == 0).sum())} exact ties in {margins.size} steps; recorded logits "
        f"give the static tokens {replay_ok}")
    log(f"moe serving: K3 launches {launches} (want {want}), by design {designs['flash_fwd']}, "
        f"copies {copies}; K3 calls held to the plain version {sum(ok for ok, _ in held)} of "
        f"{len(held)}, |do| max {max((e for _, e in held), default=0.0):.3g}")
    if launches != want or designs["flash_fwd"] != {"mma": MOE_LAYERS * n_pre, "fma": 0} \
            or any(copies.values()):
        raise AssertionError(f"moe serving: launches {launches}, want {want}")
    if len(held) != MOE_LAYERS * n_pre or not all(ok for ok, _ in held):
        raise AssertionError("moe serving: K3 on the prefill disagrees with its plain version")
    if len(prefills) != n_pre or n_static != len(prompts) or not replay_ok or faults \
            or top2.shape[1] != SERVE_NEW or not np.isfinite(top2).all() \
            or any(len(r.out_tokens) != SERVE_NEW for r in cont) \
            or any(r.status.value != "completed" for r in cont):
        raise AssertionError(f"moe serving: static and continuous greedy runs part at a clear "
                             f"margin: requests {faults}")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches["flash_fwd"], prefills=n_pre,
                drops=dict(static=drop_static, continuous=list(drop_cont.values())))


def time_moe(device) -> dict:
    """(c) The training step (``profile_step.measure``: wall, CUDA-event span,
    busy, launches, idle share, peak; busy by group), two rounds; the MoE
    layer's three steps forward and backward at the step's per-layer shape
    (dispatch, expert products, combine) with CUDA events, times the 48
    layer passes of a step; one decode step over 8 full slots and a
    128-token prefill with K3."""
    import numpy as np
    import torch

    from repro_torch.launch.profile_step import _group, measure
    from repro_torch.models.layers import moe
    from repro_torch.serve import KVPool, make_pool_decode_step, make_pool_prefill

    out = {}
    steps = []
    for rnd in range(2):
        trainer, data, _ = _trainer(_with_steps(MOE_ARGV, 8) + ["--log-every", "1000"])
        r = measure(trainer, data)
        groups = {}
        for key, ms, _ in r["rows"]:
            groups[_group(key)] = groups.get(_group(key), 0.0) + ms
        r["groups"] = groups
        steps.append(r)
        log(f"moe timing round {rnd + 1} step: wall {r['wall_ms']:.2f} ms, span "
            f"{r['span_ms']:.2f} ms, busy {r['busy_ms']:.2f} ms in {r['launches']} launches, "
            f"idle share {r['idle']:.3f}, peak {r['peak_gib']:.2f} GiB; busy by group "
            + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
        if rnd == 0:
            cfg = trainer.model.cfg
            p = {k[len("blocks/moe/"):]: v[0].to(torch.bfloat16).detach()
                 for k, v in trainer.state.params.items() if k.startswith("blocks/moe/")}
        del trainer, data
        torch.cuda.empty_cache()
    out["step"] = {k: [s[k] for s in steps] for k in ("wall_ms", "span_ms", "busy_ms",
                                                      "launches", "idle", "peak_gib")}
    out["step"]["groups"] = steps[-1]["groups"]

    # the MoE layer's steps at the step's per-layer shape: 8 sequences of 512
    gen = torch.Generator(device=device).manual_seed(11)
    t = 8 * 512
    xf = torch.randn((t, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
    pg = {k: v.clone().requires_grad_() for k, v in p.items()}
    xg = xf.clone().requires_grad_()
    buf, dest, gates, keep, _ = moe.dispatch(pg, xg, cfg)
    y = moe.experts(pg, buf.detach().requires_grad_(), cfg)
    dbuf, dy = torch.randn_like(buf), torch.randn_like(y)
    dout = torch.randn((t, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)

    def disp(grad):
        b_, _, g_, _, _ = moe.dispatch(pg, xg, cfg)
        if grad:
            torch.autograd.grad((b_, g_), (xg, pg["router"]), (dbuf, torch.ones_like(g_)))

    def expt(grad):
        bb = buf.detach().requires_grad_(grad)
        y_ = moe.experts(pg, bb, cfg)
        if grad:
            torch.autograd.grad(y_, (bb, pg["wi"], pg["wg"], pg["wo"]), dy)

    def comb(grad):
        yy, gg = y.detach().requires_grad_(grad), gates.detach().requires_grad_(grad)
        o_ = moe.combine(yy, dest, gg, cfg.n_experts_per_tok)
        if grad:
            torch.autograd.grad(o_, (yy, gg), dout)

    parts = {}
    for name, fn in (("dispatch", disp), ("experts", expt), ("combine", comb)):
        fwd = cuda_ms(lambda: fn(False))
        both = cuda_ms(lambda: fn(True))
        parts[name] = dict(fwd_ms=fwd, fwd_bwd_ms=both)
    c = moe.capacity(t, cfg)
    flops = 3 * 2 * cfg.n_experts * c * cfg.d_model * cfg.moe_d_ff * 3   # fwd + 2x bwd
    per_layer = sum(v["fwd_bwd_ms"] for v in parts.values())
    busy = float(np.median([s["busy_ms"] for s in steps]))
    log(f"moe timing layer (T {t}, E {cfg.n_experts}, C {c}, keep {float(keep.float().mean()):.4f}): "
        + ", ".join(f"{k} fwd {v['fwd_ms']:.3f} ms, fwd+bwd {v['fwd_bwd_ms']:.3f} ms"
                    for k, v in parts.items())
        + f"; a layer's fwd+bwd {per_layer:.3f} ms x {MOE_LAYERS * ACCUM} = "
        f"{per_layer * MOE_LAYERS * ACCUM:.1f} ms of the step's {busy:.1f} ms busy "
        f"({100 * per_layer * MOE_LAYERS * ACCUM / busy:.1f}%); expert products "
        f"{flops / (parts['experts']['fwd_bwd_ms'] * 1e-3) / 1e12:.1f} TFLOP/s")
    out["moe_layer"] = dict(parts=parts, capacity=c, layer_fwd_bwd_ms=per_layer,
                            step_share=per_layer * MOE_LAYERS * ACCUM / busy)
    del pg, xg, buf, y, dbuf, dy, dout, xf

    # serving: a 128-token prefill with K3, a decode step over 8 full slots
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    smodel = build_model(get_config(MOE_ARCH).replace(use_flash_kernel=True))
    params = smodel.init(0, device)
    slots, max_len = 8, SERVE_PROMPT + 64 + 8
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, 1024, (1, SERVE_PROMPT)).astype(np.int32)).to(device)
    pre = make_pool_prefill(smodel, max_len)
    step = make_pool_decode_step(smodel, greedy=True)
    with torch.inference_mode():
        pool = KVPool(smodel, slots, max_len, device)
        for _ in range(slots):
            last, c1 = pre(params, prompt)
            pool.insert(c1, pool.acquire(), SERVE_PROMPT)
        state = {"toks": last.argmax(-1).to(torch.int32).repeat(slots),
                 "pos": torch.full((slots,), SERVE_PROMPT, dtype=torch.int32, device=device)}
        active = torch.ones(slots, dtype=torch.bool, device=device)
        temps = torch.zeros(slots, device=device)
        top_k = torch.zeros(slots, dtype=torch.int32, device=device)

        def decode_step():
            toks, state["pos"], _ = step(params, pool.cache, state["toks"], state["pos"], active,
                                         temps, top_k, None)
            state["toks"] = toks
            toks.cpu()

        torch.cuda.reset_peak_memory_stats(device)
        out["prefill"] = _profile_calls(lambda: pre(params, prompt))
        out["decode"] = _profile_calls(decode_step)
        out["serve_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        for k in ("prefill", "decode"):
            r = out[k]
            log(f"moe timing {k}: wall {r['wall_ms']:.3f} ms, event span {r['span_ms']:.3f} ms, "
                f"busy {r['busy_ms']:.3f} ms in {r['launches']} launches, idle share "
                f"{r['idle']:.3f}")
        del pool
    del params
    torch.cuda.empty_cache()
    return out


def run_moe(device) -> dict:
    """Phase 11; returns the training launches, K3's serving launches and the timings."""
    t0 = time.perf_counter()
    launches = run_moe_training(device)
    serving = run_moe_serving(device)
    timing = time_moe(device)
    log(f"moe: phase 11 took {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, serving=serving, timing=timing)


# ---------------------------------------------------------------------------
# phase 12: the recurrent families, xLSTM and Jamba
# ---------------------------------------------------------------------------

def run_xlstm_training(device) -> dict:
    """(a) ``repro_torch.launch.train`` on xlstm-350m at full width: finite
    losses, weights that moved as the kernels reported, K1/K2 launched
    32 leaves x 3 steps times and no other kernel; then one more step under
    ``torch.profiler`` (device activity only: busy and launches) and two
    between CUDA events (wall and span).  Returns the launches and timings."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataPipeline
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train as launch_train

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    trainer = launch_train.main(XLSTM_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, designs, copies = _counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    hist, cfg = trainer.history, trainer.model.cfg
    log(f"xlstm training: {cfg.name} {trainer.model.param_count()} params in "
        f"{len(trainer.state.params)} leaves, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, up-projection {int(cfg.xlstm_proj_factor * cfg.d_model)}, "
        f"vocab {cfg.vocab_size}; batch {XLSTM_BATCH} x seq {XLSTM_SEQ}, accum {ACCUM}; "
        f"{len(hist)} steps in {wall:.1f} s, step walls "
        f"{[round(b - a, 3) for a, b in zip([0.0] + [h['wall_s'] for h in hist], [h['wall_s'] for h in hist])]} s, "
        f"peak memory {peak:.2f} GiB")
    keys = ("loss/total", "grad_norm", "update_norm")
    for h in hist:
        log("xlstm training step " + str(h["step"]) + ": " + ", ".join(
            f"{k} {h[k]:.5g}" for k in keys))
    if len(hist) != XLSTM_STEPS or len(trainer.state.params) != XLSTM_LEAVES \
            or cfg.use_flash_kernel or cfg.use_fused_ce_head:
        raise AssertionError(f"xlstm training: {len(hist)} steps, "
                             f"{len(trainer.state.params)} leaves")
    if any(not math.isfinite(h[k]) for h in hist for k in keys):
        raise AssertionError(f"xlstm training: non-finite metrics {hist}")
    init = trainer.model.init(trainer.tc.seed, device)
    trust = trainer.model.trust_mask()
    moved_sq, still = 0.0, []
    for k, p in trainer.state.params.items():
        d = float((p - init[k]).float().square().sum())
        moved_sq += d
        if d == 0.0:
            still.append(k)
    del init
    travelled = sum(h["update_norm"] for h in hist)
    want = {k: (XLSTM_LEAVES * XLSTM_STEPS if k in ("lamb_moments", "lamb_apply") else 0)
            for k in launches}
    log(f"xlstm training: |x3 - x0| {math.sqrt(moved_sq):.4f} against the update norms' sum "
        f"{travelled:.4f}; leaves that did not move: {still}; launches {launches} (want "
        f"{want}); copies {copies}")
    if [k for k in still if trust[k]] or not 0.0 < math.sqrt(moved_sq) <= travelled * 1.0001:
        raise AssertionError("xlstm training: the parameters did not move as the kernels "
                             "reported")
    if launches != want or any(copies.values()):
        raise AssertionError(f"xlstm training: launches {launches}, want {want}")

    # the step on the card: one profiled, two timed, batches made beforehand
    trainer.log = lambda msg: None
    data = DataPipeline(cfg, XLSTM_BATCH, XLSTM_SEQ, device=device, seed=1)
    batches = [next(data) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.fit(iter(batches[:1]), 1)
        torch.cuda.synchronize()
    t_prof = time.perf_counter() - t0
    rows = _device_rows(prof)
    t_agg = time.perf_counter() - t0 - t_prof
    del prof
    busy, n_launch = sum(ms for _, ms, _ in rows), sum(n for *_, n in rows)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # what phase 21 (c) holds the dry-run's trace of this step to: the
    # state's and a batch's bytes, and the peak over the timed steps
    args_bytes = _tensor_bytes(trainer.state) + _tensor_bytes(batches[1])
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    start.record()
    trainer.fit(iter(batches[1:]), 2)
    end.record()
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated(device)
    step_wall = (time.perf_counter() - t0) * 1e3 / 2
    span = start.elapsed_time(end) / 2
    groups: dict = {}
    for key, ms, _ in rows:
        g = "lamb kernels" if "lamb_" in key else (
            "matrix products" if any(s in key for s in ("gemm", "Gemm", "sm90_xmma", "cutlass",
                                                        "nvjet")) else "other")
        groups[g] = groups.get(g, 0.0) + ms
    timing = dict(wall_ms=step_wall, span_ms=span, busy_ms=busy, launches=n_launch,
                  idle=1 - busy / span, peak_gib=peak, groups=groups, args_bytes=args_bytes,
                  step_peak=step_peak)
    log(f"xlstm timing step: wall {step_wall:.1f} ms, span {span:.1f} ms, busy {busy:.2f} ms "
        f"in {n_launch} launches, idle share {timing['idle']:.3f}, peak {peak:.2f} GiB "
        f"(the profiled step took {t_prof:.1f} s, its aggregation {t_agg:.1f} s), "
        f"max_memory_allocated over the timed steps {step_peak / 2**30:.3f} GiB, the state's "
        f"and a batch's bytes {args_bytes}; busy by "
        f"group "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(groups.items(), key=lambda x: -x[1]))
        + "; costliest kernels: " + "; ".join(
            f"{key[:60]} {ms:.2f} ms {n}x" for key, ms, n in sorted(rows, key=lambda r: -r[1])[:6]))
    del trainer, data, batches
    torch.cuda.empty_cache()
    return dict(launches=launches, timing=timing)


def _serve_engines(device, model, params, prompts, module, label: str, attn_layers: int,
                   parting_rule: bool = True, new: int = SERVE_NEW, check_one_slot: bool = False,
                   logit_tol: tuple = (1e-2, 1e-4)) -> dict:
    """The prompts, ``new`` greedy tokens each, through the static
    ``Engine`` (one request a call: both engines prefill at the same M, and
    MoE capacity sees the same tokens) and ``ContinuousEngine``
    over SERVE_SLOTS slots, the family's ``forward`` recorded: every
    prefill's last logits held to ``Model.apply`` on the same tokens
    (``logit_tol``: relative, and absolute in units of the logits' scale
    max(1, max|ref|); by default one bf16 ulp), phase 10's parting rule
    between the two runs, and, with ``attn_layers``, K3 launched attn_layers x prefills times and each call
    within a bf16 ulp of its plain version.  No other kernel may launch.
    Without ``parting_rule`` (a model that amplifies rounding past any
    margin: see run_xlstm_serving) the partings are logged and the first
    tokens must agree (both engines prefill a request alone).  Then, or with
    ``check_one_slot``, a ``ContinuousEngine`` over one slot, whose decode
    runs the static run's arithmetic, must give the static run's tokens of the first
    two requests exactly.  Returns the launches, prefills, tokens/s, and the
    static run's tokens and top-2 logits at each step."""
    import numpy as np
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.layers import attention
    from repro_torch.serve import ContinuousEngine, Engine, Request, ServeRequest

    real_fwd, real_sdpa = module.forward, attention.flash_sdpa
    prefills, held, steps = [], [], []

    def recorded(params_, batch, cfg_, **kw):
        logits, aux = real_fwd(params_, batch, cfg_, **kw)
        if kw.get("caches") is not None:
            if not kw.get("decode"):
                prefills.append((batch["tokens"].clone(), logits[:, -1].float()))
            steps.append(logits[:, -1].float().topk(2, -1))
        return logits, aux

    def checked(q, k, v, **kw):
        o = real_sdpa(q, k, v, **kw)
        ref = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              kw.get("kv_valid"), causal=kw["causal"], window=kw["window"],
                              plain=True).transpose(1, 2).float()
        atol = 1e-4 * max(1.0, float(ref.abs().max()))
        held.append(bool(torch.allclose(o.float(), ref, rtol=1e-2, atol=atol)))
        return o

    torch.cuda.synchronize()
    reset_launches()
    module.forward, attention.flash_sdpa = recorded, checked
    try:
        max_len = len(prompts[0]) + new + 8   # as launch/serve.py sizes its cache
        eng = Engine(model, params, max_len=max_len)
        t0 = time.perf_counter()
        static, top2 = [], []
        for p in prompts:
            steps.clear()
            static.append(eng.generate_batch([Request(p, max_new_tokens=new)])[0])
            top2.append(torch.cat([r.values for r in steps[:new]]).cpu().numpy())
        top2 = np.stack(top2)
        torch.cuda.synchronize()
        t_static = time.perf_counter() - t0
        n_static = len(prefills)
        steps.clear()
        t0 = time.perf_counter()
        cont = ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=max_len).generate(
            [ServeRequest(p, max_new_tokens=new) for p in prompts])
        torch.cuda.synchronize()
        t_cont = time.perf_counter() - t0
        one_slot = None if parting_rule and not check_one_slot else ContinuousEngine(
            model, params, n_slots=1, max_len=max_len).generate(
            [ServeRequest(p, max_new_tokens=new) for p in prompts[:2]])
    finally:
        module.forward, attention.flash_sdpa = real_fwd, real_sdpa
    launches, designs, copies = _counts()
    n_pre = len(prefills)
    want = {k: (attn_layers * n_pre if k == "flash_fwd" else 0) for k in launches}
    one_ok = one_slot is None or all(
        np.array_equal(np.asarray(r.out_tokens), x.out_tokens) for r, x in zip(one_slot, static))
    # each prefill's last logits against the forward on the same tokens
    same_bits, worst, far = 0, 0.0, 0
    with torch.inference_mode():
        for toks, last in prefills:
            ref = model.apply(params, {"tokens": toks})[0][:, -1].float()
            worst = max(worst, float((last - ref).abs().max()))
            same_bits += bool(torch.equal(last, ref))
            far += not bool(torch.allclose(last, ref, rtol=logit_tol[0], atol=logit_tol[1]
                                           * max(1.0, float(ref.abs().max()))))
    st = np.stack([r.out_tokens for r in static])
    ct = np.stack([np.asarray(r.out_tokens) for r in cont])
    margins = top2[..., 0] - top2[..., 1]
    parts, faults = [], []
    for i in range(len(prompts)):
        if (ct[i] == st[i]).all():
            continue
        t = int(np.argmax(ct[i] != st[i]))
        tol = MARGIN_ULPS * _top_ulp(top2[i, t, 0])
        parts.append(f"request {i} at step {t}: static margin {margins[i, t]:.4g} (tol {tol:.4g})")
        if margins[i, t] > tol if parting_rule else t == 0:
            faults.append(i)
    n_tok = len(prompts) * new
    log(f"{label} serving: static one request a call in "
        f"{t_static:.2f} s ({n_tok / t_static:.1f} tokens/s), continuous over {SERVE_SLOTS} "
        f"slots in {t_cont:.2f} s ({n_tok / t_cont:.1f} tokens/s); identical token sequences "
        f"{sum(bool((c == x).all()) for c, x in zip(ct, st))} of {len(prompts)}; parted: "
        f"{parts or 'none'}{'' if parting_rule else ' (logged, not held)'}; static top-2 "
        f"margins: min {margins.min():.4g}; {n_pre} prefills' last logits against the forward "
        f"on the same tokens: bit-equal {same_bits}, past rtol/atol {logit_tol} {far}, |d| max "
        f"{worst:.3g}" + ("" if one_slot is None else
                          f"; continuous over 1 slot gives the static tokens of the first "
                          f"{len(one_slot)} requests exactly: {one_ok}"))
    log(f"{label} serving: launches {launches} (want {want}), by design "
        f"{designs['flash_fwd']}, copies {copies}; K3 calls held to the plain version "
        f"{sum(held)} of {len(held)}")
    if launches != want or any(copies.values()) or (
            attn_layers and designs["flash_fwd"] != {"mma": attn_layers * n_pre, "fma": 0}):
        raise AssertionError(f"{label} serving: launches {launches}, want {want}")
    if len(held) != attn_layers * n_pre or not all(held):
        raise AssertionError(f"{label} serving: K3 on the prefill disagrees with its plain "
                             f"version")
    if far or faults or not one_ok or not np.isfinite(top2).all() \
            or top2.shape[1] != new or any(len(r.out_tokens) != new for r in cont) \
            or any(r.status.value != "completed" for r in cont):
        raise AssertionError(f"{label} serving: prefill logits past {logit_tol} of the "
                             f"forward ({far}), runs parting at a clear margin or at the first token "
                             f"(requests {faults}), or the one-slot run's tokens differ "
                             f"({not one_ok})")
    return dict(launches=launches, prefills=n_pre, static_tokens_per_s=n_tok / t_static,
                continuous_tokens_per_s=n_tok / t_cont, tokens=st, top2=top2)


def _time_decode(device, model, params, prompt_len: int) -> dict:
    """A ``prompt_len``-token pool prefill and a greedy decode step over 8
    slots filled with its cache (``_profile_calls``), the pool's bytes and
    the peak memory."""
    import numpy as np
    import torch

    from repro_torch.serve import KVPool, make_pool_decode_step, make_pool_prefill

    slots, max_len = 8, prompt_len + 64 + 8
    rng = np.random.default_rng(0)
    vocab = min(model.cfg.vocab_size, 1024)
    prompt = torch.from_numpy(rng.integers(0, vocab, (1, prompt_len)).astype(np.int32)).to(device)
    pre = make_pool_prefill(model, max_len)
    step = make_pool_decode_step(model, greedy=True)
    out = {}
    with torch.inference_mode():
        pool = KVPool(model, slots, max_len, device)
        last, c1 = pre(params, prompt)
        for _ in range(slots):
            pool.insert(c1, pool.acquire(), prompt_len)
        state = {"toks": last.argmax(-1).to(torch.int32).repeat(slots),
                 "pos": torch.full((slots,), prompt_len, dtype=torch.int32, device=device)}
        active = torch.ones(slots, dtype=torch.bool, device=device)
        temps = torch.zeros(slots, device=device)
        top_k = torch.zeros(slots, dtype=torch.int32, device=device)

        def decode_step():
            toks, state["pos"], _ = step(params, pool.cache, state["toks"], state["pos"], active,
                                         temps, top_k, None)
            state["toks"] = toks
            toks.cpu()

        torch.cuda.reset_peak_memory_stats(device)
        out["prefill"] = _profile_calls(lambda: pre(params, prompt), n=2)
        out["decode"] = _profile_calls(decode_step)
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        out["pool_gb"] = pool.nbytes / 1e9
        del pool
    return out


def check_rows_independent(device, model, params, prompts) -> None:
    """A decode step over SERVE_SLOTS prefilled slots run twice from the same
    state, the other slots' tokens and states changed (rolled) the second
    time: slot 0's logits and new state must be bit-equal (nothing in the
    step mixes rows)."""
    import torch

    from repro_torch.serve import KVPool, make_pool_prefill

    pre = make_pool_prefill(model, SERVE_MAX_LEN)
    with torch.inference_mode():
        pool = KVPool(model, SERVE_SLOTS, SERVE_MAX_LEN, device)
        for p in prompts[:SERVE_SLOTS]:
            pool.insert(pre(params, torch.from_numpy(p[None].copy()).to(device))[1],
                        pool.acquire(), SERVE_PROMPT)
        snap = {s: {k: v.clone() for k, v in leaves.items()} for s, leaves in pool.cache.items()}
        pos = torch.full((SERVE_SLOTS, 1), SERVE_PROMPT, dtype=torch.int32, device=device)
        toks = torch.arange(SERVE_SLOTS, dtype=torch.int32, device=device)[:, None] + 7
        rows = []
        for other in (False, True):
            for s, leaves in pool.cache.items():
                for k, v in leaves.items():
                    v.copy_(snap[s][k])
                    if other:
                        v[:, 1:].copy_(snap[s][k][:, 1:].roll(1, 1))
            t = torch.cat([toks[:1], toks[1:].roll(1, 0) * 3]) if other else toks
            logits, cache = model.decode(params, {"tokens": t}, pool.cache, pos)
            rows.append((logits[0].clone(), {(s, k): v[:, 0].clone() for s, leaves in
                                              cache.items() for k, v in leaves.items()}))
        torch.cuda.synchronize()
    same = torch.equal(rows[0][0], rows[1][0]) and all(
        torch.equal(v, rows[1][1][key]) for key, v in rows[0][1].items())
    log(f"xlstm serving: a decode step over {SERVE_SLOTS} slots, the other slots' tokens and "
        f"states changed: slot 0's logits and state bit-equal {same}")
    if not same:
        raise AssertionError("xlstm serving: a decode step mixes its rows")
    del pool, snap, rows


def run_xlstm_serving(device) -> dict:
    """(b) xlstm-350m served at full width from seed-0 weights: the 8 prompts
    of 128 tokens, 32 new greedy tokens, through both engines (no kernel of
    the port runs), then a decode step's rows checked independent of each
    other, and a prefill and a decode step over 8 slots timed.

    Random-init xlstm-350m amplifies rounding within one forward: the
    reference's init takes the fan-in of wq/wk/wv and the sLSTM's w_g from
    their heads axis (std 1/2), so the mLSTM's scores and the sLSTM's gate
    pre-activations are tens to hundreds, and their normalisers sum them
    with cancellation.  On an H100 80GB HBM3 (700 W), one decode step from
    the same state at batch 1 and batch 4 gave logits 0.013 apart in fp32
    (0.08 in bf16), ~1 (~2.5) after 30 steps, so the static
    (batch-1) and 4-slot runs part within a few steps even in fp32, past
    any margin of rounding.  So the static engine takes a request a call
    (both engines prefill at the same M: first tokens must agree), the
    4-slot run's partings are logged, and a one-slot continuous run, whose
    decode is the static run's arithmetic, must give its tokens exactly;
    the decode step's rows must not depend on each other (bit-equal)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, xlstm_model

    model = build_model(get_config(XLSTM_ARCH))
    params = model.init(0, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, min(model.cfg.vocab_size, 1024), size=SERVE_PROMPT)
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    out = _serve_engines(device, model, params, prompts, xlstm_model, "xlstm", 0,
                           parting_rule=False)
    check_rows_independent(device, model, params, prompts)
    out["timing"] = t = _time_decode(device, model, params, SERVE_PROMPT)
    for k in ("prefill", "decode"):
        r = t[k]
        log(f"xlstm timing {k}: wall {r['wall_ms']:.3f} ms, event span {r['span_ms']:.3f} ms, "
            f"busy {r['busy_ms']:.3f} ms in {r['launches']} launches, idle share "
            f"{r['idle']:.3f}")
    log(f"xlstm timing: the pool of 8 slots holds {t['pool_gb']:.4f} GB of state (O(1) in "
        f"length), peak {t['peak_gib']:.2f} GiB; decode {8 / (t['decode']['wall_ms'] * 1e-3):.1f} "
        f"tokens/s over 8 slots")
    del params
    torch.cuda.empty_cache()
    return out


def run_jamba_smoke(device) -> dict:
    """(c) jamba-smoke with flash on: ``repro_torch.launch.train`` 3 steps
    (K1/K2 its leaves x 3, K3–K5 its one attention layer x 2 micro-batches x
    3, all on the tensor cores; finite losses with the MoE terms), then the
    8 prompts through both engines (the static one a request a call, as
    phase 11, and the capacity factor raised so that no call drops) with K3
    on every prefill."""
    import numpy as np
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model, hybrid

    reset_launches()
    trainer = launch_train.main(JAMBA_ARGV)
    torch.cuda.synchronize()
    launches, designs, copies = _counts()
    hist, model = trainer.history, trainer.model
    cfg = model.cfg
    attn = cfg.n_layers // cfg.attn_period
    leaves = len(trainer.state.params)
    want = _want_launches(JAMBA_STEPS, leaves=leaves, layers=attn)
    want.update(dict.fromkeys(FUSED_CE, 0))
    log(f"jamba-smoke training: {cfg.name}, {cfg.n_layers} layers in {attn} period(s) of "
        f"{cfg.attn_period}, {leaves} leaves, flash {cfg.use_flash_kernel}; losses "
        f"{[round(h['loss/total'], 4) for h in hist]}, moe_lb "
        f"{[round(h.get('loss/moe_lb', float('nan')), 4) for h in hist]}; launches {launches} "
        f"(want {want}); by design {designs}; copies {copies}")
    if len(hist) != JAMBA_STEPS or not cfg.use_flash_kernel \
            or any(not math.isfinite(h["loss/total"]) or "loss/moe_lb" not in h for h in hist):
        raise AssertionError(f"jamba-smoke training: {hist}")
    if launches != want or any(copies.values()) or any(
            designs[k] != {"mma": attn * ACCUM * JAMBA_STEPS, "fma": 0} for k in FLASH):
        raise AssertionError(f"jamba-smoke training: launches {launches}, want {want}")
    params = trainer.state.params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    # 4 experts top-2: at capacity factor 1.25 a decode step over 4 slots
    # (8 assignments, capacity 2) may drop what a batch-1 step keeps, so
    # the served model raises it until no call drops (as the CPU tests do)
    smodel = build_model(cfg.replace(capacity_factor=8.0))
    serving = _serve_engines(device, smodel, params, prompts, hybrid, "jamba-smoke", attn)
    del trainer, params
    torch.cuda.empty_cache()
    return dict(launches=launches, serving=serving)


def check_mamba_full_width(device) -> dict:
    """(d) Jamba's Mamba layer alone at full width (d 8192, d_inner 16384,
    d_state 16, d_conv 4, dt rank 512; weights from seed 0) on B 1 x S 256:
    the parallel scan, the chunked scan (chunk 64) and token-by-token decode
    from the zero state, outputs and final ssm/conv state held to each
    other, in fp32 (1e-4 of each tensor's scale: the scans' fp32 sums in
    another order) and, parallel against chunked, in bf16 (one bf16 ulp:
    the same bf16 operands, fp32 scans in another order); then the bf16
    layer's forward timed (parallel and chunked) with its peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import mamba
    from repro_torch.nn import init_params

    cfg = get_config("jamba-1.5-large-398b")
    di = cfg.mamba_expand * cfg.d_model
    p = init_params(mamba.mamba_defs(cfg), 0, torch.device(device))
    n = sum(v.numel() for v in p.values())
    gen = torch.Generator(device=device).manual_seed(12)
    x32 = torch.randn((1, MAMBA_SEQ, cfg.d_model), generator=gen, device=device)
    out = {}
    with torch.inference_mode():
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for name, chunk in (("parallel", None), ("chunked", MAMBA_CHUNK)):
                st0 = mamba.init_mamba_state(1, cfg, dt, device)
                res[(dt, name)] = mamba.mamba(p, x, cfg, state=st0, chunk=chunk)
            if dt == torch.float32:
                st, ys = mamba.init_mamba_state(1, cfg, dt, device), []
                for t in range(MAMBA_SEQ):
                    y, st = mamba.mamba(p, x[:, t:t + 1], cfg, state=st, decode=True)
                    ys.append(y)
                res[(dt, "decode")] = (torch.cat(ys, 1), st)
        torch.cuda.synchronize()

        def far(a, b, rtol):
            a, b = a.float(), b.float()
            return float(((a - b).abs() - rtol * b.abs()).max() / max(1e-30, float(b.abs().max())))

        ref_y, ref_st = res[(torch.float32, "parallel")]
        checks = {}
        for name in ("chunked", "decode"):
            y, st = res[(torch.float32, name)]
            checks[f"fp32 {name}"] = max(far(y, ref_y, 1e-4), far(st["ssm"], ref_st["ssm"], 1e-4),
                                         far(st["conv"], ref_st["conv"], 0.0))
        (yb, sb), (yc, sc) = res[(torch.bfloat16, "parallel")], res[(torch.bfloat16, "chunked")]
        checks["bf16 chunked"] = max(far(yc, yb, 1e-2), far(sc["ssm"], sb["ssm"], 1e-4),
                                     far(sc["conv"], sb["conv"], 0.0))
        ok = {k: v <= (1e-2 if k.startswith("bf16") else 1e-4) for k, v in checks.items()}
        log(f"mamba full width: d {cfg.d_model}, d_inner {di}, d_state {cfg.mamba_d_state}, "
            f"d_conv {cfg.mamba_d_conv}, dt rank {mamba.dt_rank(cfg)}, {n} params; B 1 x S "
            f"{MAMBA_SEQ}; largest excess over the tolerance, in units of each tensor's scale "
            f"(<= 1e-4 fp32, 1e-2 bf16): {checks} {ok}; |y| max {float(ref_y.abs().max()):.4g}, "
            f"|h| max {float(ref_st['ssm'].abs().max()):.4g}")
        if not all(ok.values()) or not all(bool(torch.isfinite(r[0]).all()) for r in res.values()):
            raise AssertionError(f"mamba full width: the three scans disagree: {checks}")
        del res, ref_y, ref_st, yb, sb, yc, sc
        x = x32.to(torch.bfloat16)
        for name, chunk in (("parallel", None), ("chunked", MAMBA_CHUNK)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            ms = cuda_ms(lambda: mamba.mamba(p, x, cfg, chunk=chunk), reps=5)
            out[name] = dict(ms=ms, peak_gib=(torch.cuda.max_memory_allocated(device) - base)
                             / 2**30)
        st = mamba.init_mamba_state(1, cfg, torch.bfloat16, device)
        out["decode_step"] = dict(ms=cuda_ms(lambda: mamba.mamba(p, x[:, :1], cfg, state=st,
                                                                 decode=True), reps=20))
    log(f"mamba full width timing (bf16 activations, fp32 weights cast at use): "
        + ", ".join(f"{k} {v['ms']:.3f} ms" + (f" (peak {v['peak_gib']:.2f} GiB over the "
                                                 f"weights)" if "peak_gib" in v else "")
                    for k, v in out.items()))
    out["checks"] = checks
    del p, x32, x
    torch.cuda.empty_cache()
    return out


def run_recurrent(device) -> dict:
    """Phase 12; returns each part's launches and timings."""
    t0, out, took = time.perf_counter(), {}, {}
    for key, fn in (("xlstm_training", run_xlstm_training), ("xlstm_serving", run_xlstm_serving),
                    ("jamba_smoke", run_jamba_smoke), ("mamba", check_mamba_full_width)):
        t1 = time.perf_counter()
        out[key] = fn(device)
        took[key] = round(time.perf_counter() - t1, 1)
    log(f"recurrent: phase 12 took {time.perf_counter() - t0:.1f} s: {took}")
    return out


# ---------------------------------------------------------------------------
# phase 13: deepseek-v3 (MLA, the dense prefix, MTP)
# ---------------------------------------------------------------------------

def _deepseek_trainer(device, **cfg_kw):
    """``(trainer, data)`` of DS_ARGV as the launcher builds them, on
    deepseek-smoke with MTP on (the launcher has no flag for it, as the
    reference's has none) and the config fields ``cfg_kw``."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch.train import lr_schedule, parse_args
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    args = parse_args(DS_ARGV)
    cfg = smoke_config(DS_ARCH).replace(use_mtp=True, use_fused_ce_head=args.fused_ce, **cfg_kw)
    lr, schedule = lr_schedule(args)
    tc = TrainConfig(optimizer=args.optimizer, learning_rate=lr, weight_decay=args.weight_decay,
                     total_steps=args.steps, seed=args.seed, accum_steps=args.accum_steps,
                     precision=args.precision, use_fused_lamb=args.fused_lamb)
    trainer = Trainer(build_model(cfg), tc, device=device, schedule=schedule, log_every=1,
                      log_fn=lambda msg: None)
    return trainer, DataPipeline(cfg, args.batch, args.seq, device=device, seed=args.seed)


def run_deepseek_training(device) -> dict:
    """(a) deepseek-smoke with MTP, DS_STEPS steps on the card: finite
    losses with ``loss/mtp`` and the MoE terms in every row, weights that
    moved as the kernels reported (every ``mtp/*`` and ``dense_blocks/*``
    leaf under the trust ratio among them), K1/K2 launched 48 leaves x 3
    steps times, K6–K8 once a micro-batch (the main CE; the MTP head's CE
    is dense), all on the tensor cores, and no K3–K5 (the MLA has no flash
    path).  Then the absorbed MLA from the same weights and batches: its
    first step's loss within one bf16 ulp (2^-7 relative) of the naive
    run's.  Returns the launches."""
    import torch

    from repro_torch.kernels import reset_launches

    trainer, data = _deepseek_trainer(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    trainer.fit(data, DS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, designs, copies = _counts()
    hist, model = trainer.history, trainer.model
    cfg = model.cfg
    keys = ("loss/total", "loss/ce", "loss/mtp", "loss/moe_lb", "moe/drop_fraction",
            "grad_norm", "update_norm")
    log(f"deepseek-smoke training: {cfg.n_layers} layers ({cfg.n_dense_layers} dense), d "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.n_experts_per_tok}, MTP "
        f"{cfg.use_mtp}, fused CE {cfg.use_fused_ce_head}; {len(trainer.state.params)} leaves, "
        f"{model.param_count()} params; {len(hist)} steps in {wall:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    for h in hist:
        log("deepseek-smoke step " + str(h["step"]) + ": " + ", ".join(
            f"{k} {h[k]:.5g}" for k in keys if k in h))
    if len(hist) != DS_STEPS or len(trainer.state.params) != DS_LEAVES \
            or any(k not in h or not math.isfinite(h[k]) for h in hist for k in keys):
        raise AssertionError(f"deepseek-smoke training: {len(hist)} steps, "
                             f"{len(trainer.state.params)} leaves, history {hist}")
    init = model.init(trainer.tc.seed, device)
    trust = model.trust_mask()
    moved_sq, still = 0.0, []
    for k, p in trainer.state.params.items():
        d = float((p - init[k]).float().square().sum())
        moved_sq += d
        if d == 0.0:
            still.append(k)
    del init
    travelled = sum(h["update_norm"] for h in hist)
    prefix = [k for k in trainer.state.params if k.startswith(("mtp/", "dense_blocks/"))]
    want = {k: 0 for k in launches}
    want.update(dict.fromkeys(("lamb_moments", "lamb_apply"), DS_LEAVES * DS_STEPS))
    want.update(dict.fromkeys(FUSED_CE, ACCUM * DS_STEPS))
    log(f"deepseek-smoke training: |x3 - x0| {math.sqrt(moved_sq):.4f} against the update "
        f"norms' sum {travelled:.4f}; {len(prefix)} mtp/ and dense_blocks/ leaves, of which "
        f"did not move: {[k for k in still if k in prefix]}; leaves that did not move: "
        f"{still}; launches {launches} (want {want}); by design "
        f"{ {k: designs[k] for k in FUSED_CE} }; copies {copies}")
    if [k for k in still if trust[k]] or not 0.0 < math.sqrt(moved_sq) <= travelled * 1.0001:
        raise AssertionError("deepseek-smoke training: the parameters did not move as the "
                             "kernels reported")
    if launches != want or any(copies.values()) \
            or any(designs[k] != {"mma": ACCUM * DS_STEPS, "fma": 0} for k in FUSED_CE):
        raise AssertionError(f"deepseek-smoke training: launches {launches}, want {want}")
    del trainer, data
    atrainer, adata = _deepseek_trainer(device, mla_absorb=True)
    atrainer.fit(adata, 1)
    naive, absorbed = hist[0]["loss/total"], atrainer.history[0]["loss/total"]
    tol = 2.0 ** -7 * abs(naive)
    log(f"deepseek-smoke training: the absorbed MLA's first-step loss {absorbed:.6f} against "
        f"the naive {naive:.6f}: |d| {abs(absorbed - naive):.3g} (tol {tol:.3g}, one bf16 ulp)")
    if not abs(absorbed - naive) <= tol:
        raise AssertionError("deepseek-smoke training: absorbed and naive MLA losses part")
    del atrainer, adata
    torch.cuda.empty_cache()
    return dict(launches=launches, losses=[h["loss/total"] for h in hist])


def _deepseek_full(device):
    """deepseek-v3 at the published widths cut to one dense and one MoE
    block, bf16 weights from seed 0: ``(model, params, init)`` with the
    init's seconds and peak memory over what was allocated before."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(DS_ARCH).replace(n_layers=2, n_dense_layers=1, param_dtype="bfloat16")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    params = model.init(0, device)
    torch.cuda.synchronize()
    init = dict(seconds=time.perf_counter() - t0,
                peak_gib=(torch.cuda.max_memory_allocated(device) - base) / 2**30,
                tree_gb=sum(v.numel() * v.element_size() for v in params.values()) / 1e9)
    big = max(params, key=lambda k: params[k].numel())
    log(f"deepseek-v3 full width: {model.param_count()} params ({cfg.n_layers} layers, "
        f"{cfg.n_dense_layers} dense; d {cfg.d_model}, {cfg.n_heads} heads, q_lora "
        f"{cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, rope {cfg.qk_rope_dim}, nope "
        f"{cfg.qk_nope_dim}, v {cfg.v_head_dim}, dense d_ff {cfg.d_ff}, {cfg.n_experts} experts "
        f"top-{cfg.n_experts_per_tok} of {cfg.moe_d_ff} + {cfg.n_shared_experts} shared, vocab "
        f"{cfg.vocab_size}, untied {not cfg.tie_embeddings}) in bf16: init {init['seconds']:.2f} "
        f"s, {init['tree_gb']:.2f} GB of weights, peak {init['peak_gib']:.2f} GiB (the largest "
        f"leaf {big} {tuple(params[big].shape)}: {params[big].numel() * 4 / 1e9:.2f} GB in "
        f"fp32)")
    return model, params, init


def check_mla_paths_per_layer(device, model, params, prompts) -> float:
    """The prompts as one static batch with every MLA call (prefill and each
    decode step, both layers) run a second time on the other path (naive /
    absorbed) from the same input and a copy of its cache: each layer's
    outputs within MLA_BF16_TOL of its scale.  Returns the largest distance."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.serve import Engine, Request

    real, dists = transformer.mla_attention, []

    def both(p, x, positions, cfg, *, cache=None, decode=False, valid_len=None):
        copy = None if cache is None else {k: v.clone() for k, v in cache.items()}
        y = real(p, x, positions, cfg, cache=cache, decode=decode, valid_len=valid_len)
        y2 = real(p, x, positions, cfg.replace(mla_absorb=not cfg.mla_absorb), cache=copy,
                  decode=decode, valid_len=valid_len)
        dists.append(float((y.float() - y2.float()).abs().max())
                     / max(1.0, float(y.float().abs().max())))
        return y

    transformer.mla_attention = both
    try:
        Engine(model, params, max_len=DS_PROMPT + DS_NEW + 8).generate_batch(
            [Request(p, max_new_tokens=DS_NEW) for p in prompts])
    finally:
        transformer.mla_attention = real
    torch.cuda.synchronize()
    worst = max(dists)
    log(f"deepseek-v3 serving: naive against absorbed per layer over {len(dists)} MLA calls "
        f"(a prefill of {len(prompts)} and {DS_NEW} decode steps, 2 layers): largest |d| "
        f"{worst:.3g} of the output's scale (tol {MLA_BF16_TOL})")
    if len(dists) != 2 * (DS_NEW + 1) or worst > MLA_BF16_TOL:
        raise AssertionError("deepseek-v3 serving: the absorbed MLA parts from the naive one")
    return worst


def run_deepseek_serving(device, model, params, init) -> dict:
    """(b) The full-width model served: DS_REQUESTS prompts of DS_PROMPT
    tokens, DS_NEW greedy tokens each, through the static ``Engine`` (a
    request a call, as phase 11 serves MoE) and the ``ContinuousEngine``
    over 4 slots, naive and absorbed, no kernel of the port launched (the
    MLA has no flash path; serving has no fused head): every prefill's last
    logits held to the forward on the same tokens (BF16_TOL: the forward
    attends over S keys, the prefill over the cache's T), phase 10's parting
    rule between the engines and between naive and absorbed, a one-slot
    continuous run equal to the static run; naive against absorbed per layer
    (``check_mla_paths_per_layer``); then a prefill and a decode step over 8
    slots timed for each path, beside the decode's bound: every weight it
    reads (all but the embedding table's rows) over the memory rate."""
    import numpy as np
    import torch

    from repro_torch.models import build_model, transformer

    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, min(cfg.vocab_size, 1024), size=DS_PROMPT).astype(np.int32)
               for _ in range(DS_REQUESTS)]
    per_layer = check_mla_paths_per_layer(device, model, params, prompts)
    out = dict(init=init, per_layer=per_layer)
    models = {"naive": model, "absorbed": build_model(cfg.replace(mla_absorb=True))}
    for name, m in models.items():
        out[name] = _serve_engines(device, m, params, prompts, transformer,
                                   f"deepseek-v3 {name}", 0, new=DS_NEW, check_one_slot=True,
                                   logit_tol=(BF16_TOL, BF16_TOL))
    (st, top2), at = (out["naive"][k] for k in ("tokens", "top2")), out["absorbed"]["tokens"]
    margins = top2[..., 0] - top2[..., 1]
    parts, faults = [], []
    for i in range(len(prompts)):
        if (at[i] == st[i]).all():
            continue
        t = int(np.argmax(at[i] != st[i]))
        tol = MARGIN_ULPS * _top_ulp(top2[i, t, 0])
        parts.append(f"request {i} at step {t}: naive margin {margins[i, t]:.4g} (tol {tol:.4g})")
        if margins[i, t] > tol:
            faults.append(i)
    log(f"deepseek-v3 serving: naive against absorbed static runs: identical sequences "
        f"{sum(bool((a == x).all()) for a, x in zip(at, st))} of {len(prompts)}; parted: "
        f"{parts or 'none'}")
    if faults:
        raise AssertionError(f"deepseek-v3 serving: naive and absorbed part at a clear margin: "
                             f"requests {faults}")
    one = model.make_cache(1, 1, device)
    per_token = sum(v.numel() * v.element_size() for seg in one.values()
                    for k, v in seg.items() if k != "index")
    read = sum(v.numel() * v.element_size() for k, v in params.items() if k != "embed")
    bound_ms = read / memory_rate(torch.cuda.get_device_name(0)) * 1e3
    out["cache_bytes_per_token"], out["decode_bound_ms"] = per_token, bound_ms
    for name, m in models.items():
        out[name]["timing"] = t = _time_decode(device, m, params, DS_PROMPT)
        for k in ("prefill", "decode"):
            r = t[k]
            log(f"deepseek-v3 {name} timing {k}: wall {r['wall_ms']:.3f} ms, event span "
                f"{r['span_ms']:.3f} ms, busy {r['busy_ms']:.3f} ms in {r['launches']} launches, "
                f"idle share {r['idle']:.3f}")
        log(f"deepseek-v3 {name} timing: decode {8 / (t['decode']['wall_ms'] * 1e-3):.1f} "
            f"tokens/s over 8 slots; the decode step's bound {bound_ms:.3f} ms ({read / 1e9:.2f} "
            f"GB of weights read), its span {t['decode']['span_ms'] / bound_ms:.2f}x it; the "
            f"cache {per_token} bytes a token ({t['pool_gb']:.4f} GB for 8 slots of "
            f"{DS_PROMPT + 72}); peak {t['peak_gib']:.2f} GiB")
    for name in models:
        out[name].pop("top2")
        out[name]["tokens"] = out[name]["tokens"].tolist()
    return out


def _rel(a, ref) -> float:
    """max |a - ref| over max |ref|: the distance in units of the scale."""
    a, ref = a.detach().float(), ref.detach().float()
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def check_deepseek_pieces(device, model, params) -> dict:
    """(c) The full-width training pieces alone.  1. The dense prefix block
    (MLA + the 18432-wide MLP) at B DS_PIECE_B x S DS_PIECE_S forward and
    backward, naive and absorbed: output and every gradient (x's and each
    weight's) within 2e-4 of each tensor's scale in fp32 (the JAX suite's
    absorbed-against-naive bound) and MLA_BF16_TOL in bf16.  2. ``lm_loss`` with
    the fused head and MTP (a full-width MTP block drawn from seed 1) on bf16
    hidden states of (DS_PIECE_B, DS_PIECE_S, 7168) against the untied
    (7168, 129280) head, every position supervised (N 1024): K6, K7 and K8
    launched once each, on the tensor cores, over ``d_windows(7168)`` D
    windows; the loss within one bf16 ulp (2^-7 relative) of the dense
    ``cross_entropy`` path's on the same inputs (that path rounds its logits
    to bf16), d_hidden and d_unembed within BF16_TOL of their scale; both
    paths' forward + backward timed."""
    import torch

    from repro_torch import nn
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.fused_ce import d_windows
    from repro_torch.models import build_model, transformer
    from repro_torch.models.layers.embeddings import unembed
    from repro_torch.train.loss import lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model.cfg
    b, s, d = DS_PIECE_B, DS_PIECE_S, cfg.d_model
    gen = torch.Generator(device=device).manual_seed(13)
    out = {}

    # 1. the dense prefix block
    bp0 = {k[len("dense_blocks/"):]: v[0] for k, v in params.items()
           if k.startswith("dense_blocks/")}
    x0 = torch.randn((b, s, d), generator=gen, device=device)
    dy = torch.randn((b, s, d), generator=gen, device=device)
    positions = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)

    def block(dt, absorb):
        c = cfg.replace(mla_absorb=absorb)
        bp = {k: v.to(dt).detach().requires_grad_() for k, v in bp0.items()}
        x = x0.to(dt).requires_grad_()
        y, _ = transformer._one_block(bp, x, positions, c)
        return y, dict(zip(["x", *bp], torch.autograd.grad(y, [x, *bp.values()], dy.to(dt))))

    dists = {}
    for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, MLA_BF16_TOL)):
        (yn, gn), (ya, ga) = block(dt, False), block(dt, True)
        dist = {"y": _rel(ya, yn), **{k: _rel(ga[k], gn[k]) for k in gn}}
        finite = all(bool(torch.isfinite(t).all()) for t in (yn, ya, *gn.values(), *ga.values()))
        worst = max(dist, key=dist.get)
        log(f"deepseek-v3 dense block (B {b} x S {s}, {dt}): absorbed against naive, largest "
            f"distance {dist[worst]:.3g} of the scale at {worst} (tol {tol}); y "
            f"{dist['y']:.3g}, dx {dist['x']:.3g}, d wk_b {dist['attn/wk_b']:.3g}, d wv_b "
            f"{dist['attn/wv_b']:.3g}; finite {finite}")
        if dist[worst] > tol or not finite:
            raise AssertionError(f"deepseek-v3 dense block: absorbed and naive part in {dt}")
        dists[str(dt)] = dist
        del yn, gn, ya, ga
    out["block"] = dict(dists=dists, ms={
        name: cuda_ms(lambda: block(torch.bfloat16, absorb), reps=3)
        for name, absorb in (("naive", False), ("absorbed", True))})
    log(f"deepseek-v3 dense block bf16 forward + backward: naive {out['block']['ms']['naive']:.2f}"
        f" ms, absorbed {out['block']['ms']['absorbed']:.2f} ms")
    del bp0, x0, dy

    # 2. the loss head with MTP: the fused head (K6–K8) against the dense CE
    mcfg = cfg.replace(use_mtp=True, use_fused_ce_head=True)
    mtp = nn.init_params({"mtp": build_model(mcfg).defs["mtp"]}, 1, device, "bfloat16")
    lp = {"embed": params["embed"], "unembed": params["unembed"], **mtp}
    v = cfg.vocab_size
    tokens = torch.randint(0, v, (b, s), generator=gen, device=device, dtype=torch.int32)
    labels = torch.randint(0, v, (b, s), generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": labels}
    h0 = torch.randn((b, s, d), generator=gen, device=device).to(torch.bfloat16)

    def head(fused):
        p = {k: t.detach().requires_grad_(k == "unembed") for k, t in lp.items()}
        h = h0.clone().requires_grad_()
        aux = {"mtp_hidden": h}
        if fused:
            total, m = lm_loss(None, batch, aux, mcfg, params=p, hidden=h)
        else:
            total, m = lm_loss(unembed(h, p["unembed"]), batch, aux,
                               mcfg.replace(use_fused_ce_head=False), params=p)
        dh, dw = torch.autograd.grad(total, (h, p["unembed"]))
        return total.detach(), {k: t.detach() for k, t in m.items()}, dh, dw

    torch.cuda.synchronize()
    reset_launches()
    lf, mf, dhf, dwf = head(True)
    torch.cuda.synchronize()
    launches, designs, _ = _counts()
    ld, md, dhd, dwd = head(False)
    n = labels.numel()   # every position supervised
    windows = d_windows(d)
    rel_loss = abs(float(lf) - float(ld)) / abs(float(ld))
    dist = dict(d_hidden=_rel(dhf, dhd), d_unembed=_rel(dwf, dwd))
    want = {k: int(k in FUSED_CE) for k in launches}
    log(f"deepseek-v3 loss head (N {n}, D {d} in {windows} D windows, V {v}, untied, MTP): "
        f"fused {float(lf):.6f} (ce {float(mf['loss/ce']):.6f}, mtp {float(mf['loss/mtp']):.6f}) "
        f"against dense {float(ld):.6f} (ce {float(md['loss/ce']):.6f}): relative {rel_loss:.3g} "
        f"(tol {2.0 ** -7:.3g}); d_hidden {dist['d_hidden']:.3g}, d_unembed "
        f"{dist['d_unembed']:.3g} of their scale (tol {BF16_TOL}); launches {launches} (want "
        f"{want}), by design { {k: designs[k] for k in FUSED_CE} }")
    if launches != want or any(designs[k] != {"mma": 1, "fma": 0} for k in FUSED_CE) \
            or not rel_loss <= 2.0 ** -7 or max(dist.values()) > BF16_TOL \
            or not all(bool(torch.isfinite(t).all()) for t in (dhf, dwf)):
        raise AssertionError("deepseek-v3 loss head: the fused head parts from the dense path "
                             "or launched other than K6-K8 once each")
    del dhf, dwf, dhd, dwd
    out["head"] = dict(n=n, windows=windows, rel_loss=rel_loss, dists=dist, launches=launches,
                       ms={name: cuda_ms(lambda: head(fused), reps=3)
                           for name, fused in (("fused", True), ("dense", False))})
    log(f"deepseek-v3 loss head forward + backward (lm_loss with MTP): fused "
        f"{out['head']['ms']['fused']:.2f} ms, dense {out['head']['ms']['dense']:.2f} ms")
    del lp, mtp, h0
    torch.cuda.empty_cache()
    return out


def run_deepseek(device) -> dict:
    """Phase 13; returns each part's launches and timings."""
    import torch

    t0, out, took = time.perf_counter(), {}, {}
    t1 = time.perf_counter()
    out["training"] = run_deepseek_training(device)
    took["training"] = round(time.perf_counter() - t1, 1)
    t1 = time.perf_counter()
    model, params, init = _deepseek_full(device)
    out["serving"] = run_deepseek_serving(device, model, params, init)
    took["serving"] = round(time.perf_counter() - t1, 1)
    t1 = time.perf_counter()
    out["pieces"] = check_deepseek_pieces(device, model, params)
    took["pieces"] = round(time.perf_counter() - t1, 1)
    del params
    torch.cuda.empty_cache()
    log(f"deepseek: phase 13 took {time.perf_counter() - t0:.1f} s: {took}")
    return out


# ---------------------------------------------------------------------------
# phase 14: data-parallel FSDP
# ---------------------------------------------------------------------------

FSDP_STEPS = 3
FSDP_ARGV = _with_steps(MAIN_ARGV, FSDP_STEPS)
FSDP_MESH = ["--mesh", "data=1,model=1"]
FSDP_SHARDS = 4


def run_fsdp_main_path(device) -> dict:
    """(a) The main path through the sharded Trainer on a data=1 mesh (a
    real NCCL group of one rank) against the same steps without a mesh:
    launch counts, then losses, grad norms and params bit-equal (at one
    rank the sharded step keeps the unsharded order of operations), then
    both steps timed.  Returns the sharded run's launches and the timings."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch import profile_step
    from repro_torch.launch import train as launch_train

    runs = {}
    for label, argv in (("unsharded", FSDP_ARGV), ("data=1 mesh", FSDP_ARGV + FSDP_MESH)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        trainer = launch_train.main(argv)
        torch.cuda.synchronize()
        launches, designs, copies = _counts()
        _check_launches(f"fsdp {label}", FSDP_STEPS, True, launches, designs, copies)
        hist = trainer.history
        if len(hist) != FSDP_STEPS or not all(math.isfinite(h["loss/total"]) for h in hist):
            raise AssertionError(f"fsdp {label}: history {hist}")
        params = {k: v.float().cpu() for k, v in trainer.gather_state().params.items()}
        walls = [h["wall_s"] for h in hist]
        runs[label] = dict(losses=[h["loss/total"] for h in hist],
                           grad_norms=[h["grad_norm"] for h in hist], params=params,
                           launches=launches, mesh=trainer.mesh,
                           peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                           step_walls=[b - a for a, b in zip([0.0] + walls, walls)])
        del trainer
        torch.cuda.empty_cache()
    a, b = runs["unsharded"], runs["data=1 mesh"]
    if b["mesh"] is None or b["mesh"].shape != {"data": 1, "model": 1}:
        raise AssertionError(f"fsdp: the --mesh run had mesh {b['mesh']}")
    import torch.distributed as dist

    backend = dist.get_backend()
    rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"]))
    pdiff = max(float((b["params"][k] - a["params"][k]).abs().max()) for k in a["params"])
    same = b["losses"] == a["losses"] and b["grad_norms"] == a["grad_norms"]
    log(f"fsdp (a): process group {backend}, world {dist.get_world_size()}; losses "
        f"unsharded {a['losses']}, data=1 mesh {b['losses']} (max rel {rel:.2e}); grad "
        f"norms {a['grad_norms']} / {b['grad_norms']}; losses and grad norms bit-equal: "
        f"{same}; params max |diff| {pdiff:.3e}; launches {b['launches']}")
    if backend != "nccl" or not same or pdiff != 0.0:
        raise AssertionError(f"fsdp (a): backend {backend}, losses and grad norms "
                             f"bit-equal {same}, params max |diff| {pdiff}")
    # the unsharded run is phase 15 (c)'s reference too
    reference = {k: a[k] for k in ("losses", "grad_norms", "params", "launches")}
    del b["params"]
    timed, rows = {}, {}
    for label, argv in (("unsharded", FSDP_ARGV), ("data=1 mesh", FSDP_ARGV + FSDP_MESH)):
        trainer, data, _ = launch_train.build(launch_train.parse_args(argv))
        r = profile_step.measure(trainer, data)
        timed[label] = {k: r[k] for k in ("wall_ms", "span_ms", "busy_ms", "launches",
                                          "idle", "peak_gib")}
        rows[label] = {key: (ms, n) for key, ms, n in r["rows"]}
        log(f"fsdp (a) {label}: step walls {[round(w, 4) for w in runs[label]['step_walls']]} "
            f"s (first with warm-up), peak {runs[label]['peak_gib']:.2f} GiB; timed: wall "
            f"{r['wall_ms']:.2f} ms/step, device span {r['span_ms']:.2f} ms, busy "
            f"{r['busy_ms']:.2f} ms in {r['launches']} launches, idle {r['idle']:.3f}, peak "
            f"{r['peak_gib']:.2f} GiB")
        del trainer, data
        torch.cuda.empty_cache()
    u, m = timed["unsharded"], timed["data=1 mesh"]
    log(f"fsdp (a): the mesh's cost a step: wall {m['wall_ms'] - u['wall_ms']:+.2f} ms, busy "
        f"{m['busy_ms'] - u['busy_ms']:+.2f} ms, launches {m['launches'] - u['launches']:+d}")
    # where the busy time moved: the kernels whose time differs most
    ru, rm = rows["unsharded"], rows["data=1 mesh"]
    moved = sorted(set(ru) | set(rm),
                   key=lambda k: -abs(rm.get(k, (0.0, 0))[0] - ru.get(k, (0.0, 0))[0]))
    for key in moved[:10]:
        (ua, un), (ma, mn) = ru.get(key, (0.0, 0)), rm.get(key, (0.0, 0))
        log(f"fsdp (a) kernel {ma - ua:+8.3f} ms ({ua:.3f} ms {un}x -> {ma:.3f} ms {mn}x) "
            f"{key[:110]}")
    return dict(launches=b["launches"], timed=timed, reference=reference)


def check_shard_contract(device) -> None:
    """(b) K1/K2 on the data=4 slices of BERT-large's 13 leaves against the
    whole leaf: the slices' per-layer partials summed within 1e-5 relative
    of the whole leaf's, m' and v' and (with the whole leaf's ratio) x' bit-
    equal to its slices."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import lamb_apply, lamb_moments
    from repro_torch.kernels.lamb_update import bias_corrections, trust_ratio
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.nn import flatten
    from repro_torch.sharding import leaf_layout, specs_for
    from repro_torch.sharding.collectives import shard_leaf

    model = build_model(get_config("bert-large"))
    mesh = Mesh({"data": FSDP_SHARDS, "model": 1})
    specs, axes = specs_for(model.defs, mesh), model.layer_axes()
    gen = torch.Generator(device=device).manual_seed(2)
    c = bias_corrections(torch.tensor(5, device=device), 0.9, 0.999, device)
    lr = torch.tensor(1e-3, device=device)
    worst = {"partials": 0.0, "split": 0}
    for k, p in flatten(model.defs).items():
        dim = leaf_layout(specs[k], mesh).data
        layers = p.shape[0] if axes[k] == 0 else 1
        x = 0.05 * torch.randn(p.shape, generator=gen, device=device)
        g = 1e-3 * torch.randn(p.shape, generator=gen, device=device)
        m = 1e-4 * torch.randn(p.shape, generator=gen, device=device)
        v = 1e-8 * torch.rand(p.shape, generator=gen, device=device)
        parts = [tuple(shard_leaf(t, dim, FSDP_SHARDS, i) for t in (x, g, m, v))
                 for i in range(FSDP_SHARDS)]
        xsq, usq = lamb_moments(x, g, m, v, c, layers)
        sums = [lamb_moments(*t, c, layers) for t in parts]
        sx, su = (torch.stack([s[j] for s in sums]).sum(0) for j in (0, 1))
        rel = max(float(((sx - xsq).abs() / xsq).max()), float(((su - usq).abs() / usq).max()))
        ratio = trust_ratio(xsq, usq) * lr
        lamb_apply(x, m, v, c, ratio, layers)
        for t in parts:
            lamb_apply(t[0], t[2], t[3], c, ratio, layers)
        torch.cuda.synchronize()
        equal = all(torch.equal(shard_leaf(whole, dim, FSDP_SHARDS, i), part)
                    for i, t in enumerate(parts) for whole, part in zip((x, m, v),
                                                                        (t[0], t[2], t[3])))
        log(f"fsdp (b) {k:22s} {str(tuple(p.shape)):22s} split dim {dim}: partials rel "
            f"{rel:.2e}, x' m' v' slices bit-equal {equal}")
        if rel > 1e-5 or not equal:
            raise AssertionError(f"fsdp (b): {k} breaks the shard contract")
        worst["partials"] = max(worst["partials"], rel)
        worst["split"] += dim is not None
        del x, g, m, v, parts
    torch.cuda.empty_cache()
    log(f"fsdp (b): {worst['split']} of 13 leaves split; worst partials rel "
        f"{worst['partials']:.2e}")


def check_fsdp_memory() -> dict:
    """(c) Per-rank bytes of BERT-large's params, μ and ν at data=4/8/16,
    from meta tensors cut to rank 0's slices; at least N/2 times smaller
    than the whole state."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.nn import flatten
    from repro_torch.sharding import leaf_layout, per_device_state_bytes, specs_for
    from repro_torch.sharding.collectives import shard_leaf

    model = build_model(get_config("bert-large"))
    whole = {k: torch.empty(p.shape, device="meta") for k, p in flatten(model.defs).items()}
    base = 3 * per_device_state_bytes(whole)
    out = {}
    for n in (4, 8, 16):
        mesh = Mesh({"data": n, "model": 1})
        specs = specs_for(model.defs, mesh)
        rank0 = {k: shard_leaf(x, leaf_layout(specs[k], mesh).data, n, 0)
                 for k, x in whole.items()}
        per = 3 * per_device_state_bytes(rank0)
        out[n] = base / per
        log(f"fsdp (c) data={n}: params + mu + nu {per / 2**30:.3f} GiB a rank against "
            f"{base / 2**30:.3f} GiB whole: {out[n]:.3f}x (at least {n / 2:g}x)")
        if out[n] < n / 2:
            raise AssertionError(f"fsdp (c): data={n} saves only {out[n]:.2f}x")
    return out


def run_fsdp(device) -> dict:
    """Phase 14; returns (a)'s launches and timings and (c)'s ratios."""
    from repro_torch.launch.mesh import shutdown_distributed

    t0 = time.perf_counter()
    try:
        out = run_fsdp_main_path(device)
    finally:
        shutdown_distributed()
    check_shard_contract(device)
    out["memory"] = check_fsdp_memory()
    log(f"fsdp: phase 14 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: tensor parallelism over a model axis
# ---------------------------------------------------------------------------

TP_MESH = {"data": 2, "model": 2}
# (label, rows N, D, V, slices M, layout): BERT-large's tied head at the main
# path's seq 128 (32 x 20 gathered rows) over model=2, 15261 rows a slice;
# smollm-360m's tied head, 8 sequences of 128 with every position supervised,
# over model=4, 12288 rows a slice
TP_CE_CASES = [("bert-large model=2", 640, 1024, 30522, 2),
               ("smollm-360m model=4", 1024, 960, 49152, 4)]


def _vocab_slice_inputs(device, n, d, v, seed):
    """bf16 rows with std 1 and a vocab projection with std 0.05, labels on
    the argmax on every fourth row (so ``correct`` is exercised) and random
    elsewhere, an fp32 cotangent; and the fp32 logits."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((n, d), generator=gen, device=device).to(torch.bfloat16)
    w = (0.05 * torch.randn((v, d), generator=gen, device=device)).to(torch.bfloat16)
    logits = h.float() @ w.float().t()
    lbl = torch.randint(0, v, (n,), generator=gen, device=device, dtype=torch.int32)
    rows = torch.arange(n, device=device)
    lbl = torch.where(rows % 4 == 0, logits.argmax(1).to(torch.int32), lbl)
    g = torch.rand((n,), generator=gen, device=device)
    return h, w, lbl, g, logits


def vocab_slice_parts(h, w, lbl, g, m):
    """K6–K8 over ``m`` vocab slices as the vocab-parallel head runs them:
    K6 on each slice with its offset, merged by ``combine_vocab_slices``
    (over the slices with the plain reductions: one card), K7's partials
    summed in fp32 and rounded once, K8's rows concatenated."""
    import torch

    from repro_torch.kernels.fused_ce import (
        combine_vocab_slices,
        fused_ce_dh,
        fused_ce_dw,
        fused_ce_fwd,
    )
    from repro_torch.sharding.collectives import all_reduce_plain, reduce_from_model_plain

    vs = w.shape[0] // m
    parts = [w[r * vs:(r + 1) * vs] for r in range(m)]
    stats = [fused_ce_fwd(h, p, lbl, v0=r * vs, stats=True) for r, p in enumerate(parts)]
    lse, ll, idx = combine_vocab_slices(
        *(torch.stack([st[i] for st in stats]) for i in (2, 3, 4, 5)),
        lambda op, x: all_reduce_plain(x.unbind(0), op))
    dh_parts = [fused_ce_dh(h, p, (lbl - r * vs).contiguous(), lse, g)
                for r, p in enumerate(parts)]
    dw = torch.cat([fused_ce_dw(h, p, (lbl - r * vs).contiguous(), lse, g)
                    for r, p in enumerate(parts)])
    return dict(nll=lse - ll, lse=lse, correct=(idx == lbl).float(),
                dh=reduce_from_model_plain(dh_parts), dh_parts=dh_parts, dw=dw)


def check_vocab_slices(device) -> dict:
    """(a) K6–K8's vocab-slice contract at TP_CE_CASES: each slice on the
    tensor-core design; the merged K6 against the whole-vocab K6 within
    phase 3's K6 tolerance (1e-5), ``correct`` equal on every row whose
    label does not tie the maximum; the summed K7 partials within 2 bf16
    ulps of the whole dh (ulps of the largest of the element's whole value
    and its partials' magnitudes summed: the partials round at their own
    size); the K8 slices against the whole dw's rows within phase 3's bf16
    bound.  Returns each case's launches by kernel."""
    import torch

    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, reset_launches
    from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_dw, fused_ce_fwd

    out = {}
    for i, (label, n, d, v, m) in enumerate(TP_CE_CASES):
        h, w, lbl, g, logits = _vocab_slice_inputs(device, n, d, v, 15 + i)
        nll_w, correct_w, lse_w = fused_ce_fwd(h, w, lbl)
        dh_w = fused_ce_dh(h, w, lbl, lse_w, g)
        dw_w = fused_ce_dw(h, w, lbl, lse_w, g)
        torch.cuda.synchronize()
        reset_launches()
        got = vocab_slice_parts(h, w, lbl, g, m)
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in FUSED_CE}
        designs = {k: dict(VARIANT_LAUNCHES[k]) for k in FUSED_CE}
        fails = []
        if designs != {k: {"mma": m, "fma": 0} for k in FUSED_CE}:
            fails.append("designs")
        e_fwd = max(float((got["nll"] - nll_w).abs().max()),
                    float((got["lse"] - lse_w).abs().max()))
        if not (torch.allclose(got["nll"], nll_w, rtol=1e-5, atol=1e-5)
                and torch.allclose(got["lse"], lse_w, rtol=1e-5, atol=1e-5)):
            fails.append("nll/lse")
        # a row whose two largest logits tie within fp32 rounding may take
        # either column as its argmax; every other row must agree
        top2 = logits.topk(2, dim=1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * (1 + top2[:, 0].abs())
        flips = (got["correct"] != correct_w) & ~tie
        if bool(flips.any()):
            fails.append("correct")
        scale = torch.maximum(dh_w.float().abs(),
                              torch.stack([p.float().abs() for p in got["dh_parts"]]).sum(0))
        ulps = float(((got["dh"].float() - dh_w.float()).abs() / bf16_ulp(scale)).max())
        if ulps > 2.0 or not bool(torch.isfinite(got["dh"]).all()):
            fails.append("dh")
        dw_scale = max(float(dw_w.float().abs().max()), 1e-30)
        e_dw = float((got["dw"].float() - dw_w.float()).abs().max())
        if not torch.allclose(got["dw"].float(), dw_w.float(), rtol=1e-2, atol=1e-4 * dw_scale):
            fails.append("dw")
        log(f"tp (a) {label}: n {n} d {d} v {v} over {m} slices of {v // m}: |dnll|,|dlse| "
            f"{e_fwd:.2e}, correct on {int(got['correct'].sum())} rows (whole vocab "
            f"{int(correct_w.sum())}; {int(tie.sum())} rows with a tied maximum, "
            f"{int(((got['correct'] != correct_w) & tie).sum())} of them parted), summed dh "
            f"{ulps:.2f} bf16 ulps from the whole, |ddw| {e_dw:.2e} (scale {dw_scale:.2e}); "
            f"launches {launches}, designs {designs} "
            f"{'ok' if not fails else 'MISMATCH in ' + ', '.join(fails)}")
        if fails:
            raise AssertionError(f"tp (a): vocab slices disagree with the whole vocab on {label}")
        out[label] = launches
        del h, w, logits, got, dh_w, dw_w
    torch.cuda.empty_cache()
    return out


def _param_specs(model, mesh, rules=()):
    """``model``'s parameter specs on ``mesh`` under the default rules with
    the ``name=a,b`` overrides ``rules`` (the launchers' ``--param-rule``)."""
    from repro_torch.sharding import default_param_rules, override_rules, specs_for

    return specs_for(model.defs, mesh, override_rules(
        default_param_rules(multi_pod="pod" in mesh.shape), rules) if rules else None)


def check_tp_blocks(device, arch: str = "bert-large", mesh=None, label: str = "tp (b)",
                    rules=()) -> None:
    """(b) K1/K2 on the blocks of ``arch``'s leaves over ``mesh`` (BERT-large's
    13 over data=2,model=2; phase 17 granite-moe-1b's 12 over model=4;
    phase 21 BERT-large's stored under ``rules``): each rank's per-layer
    partials, zero where the world rule leaves the rank out
    (``ShardCtx.counts``), summed over the ranks within 1e-6 relative of K1
    on the whole leaf, and K1 on each block within 1e-6 relative of its
    plain version; with the whole leaf's ratio, K2 writes each block
    bit-equal to the whole leaf's, and K1 + K2 on each block are within
    phase 3's tolerances of the plain pair's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import lamb_apply, lamb_moments
    from repro_torch.kernels.lamb_update import bias_corrections, trust_ratio
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.nn import flatten
    from repro_torch.sharding import ShardCtx
    from repro_torch.sharding.collectives import shard_block

    mesh = mesh or TP_MESH
    model = build_model(get_config(arch).replace(use_flash_kernel=False,
                                                 use_fused_ce_head=False))
    world = mesh["data"] * mesh["model"]
    specs = _param_specs(model, Mesh(mesh), rules)
    ranks = [ShardCtx(Mesh(mesh, rank=r), param_specs=specs) for r in range(world)]
    axes = model.layer_axes()
    gen = torch.Generator(device=device).manual_seed(6)
    c = bias_corrections(torch.tensor(5, device=device), 0.9, 0.999, device)
    lr = torch.tensor(1e-3, device=device)
    worst, split = 0.0, {"data": 0, "model": 0, "both": 0}
    for k, p in flatten(model.defs).items():
        lay = ranks[0].layout(k)
        layers = p.shape[0] if axes[k] == 0 else 1
        x = 0.05 * torch.randn(p.shape, generator=gen, device=device)
        g = 1e-3 * torch.randn(p.shape, generator=gen, device=device)
        m = 1e-4 * torch.randn(p.shape, generator=gen, device=device)
        v = 1e-8 * torch.rand(p.shape, generator=gen, device=device)
        blocks = [tuple(shard_block(t, lay, ctx.mesh) for t in (x, g, m, v)) for ctx in ranks]
        plain = [tuple(t.clone() for t in b) for b in blocks]
        starts = [b[0].clone() for b in blocks]
        xsq, usq = lamb_moments(x, g, m, v, c, layers)
        sums = [lamb_moments(*t, c, layers) for t in blocks]
        sx, su = (torch.stack([s[j] if ctx.counts(k) else torch.zeros_like(s[j])
                               for s, ctx in zip(sums, ranks)]).sum(0) for j in (0, 1))
        rel = max(float(((sx - xsq).abs() / xsq).max()), float(((su - usq).abs() / usq).max()))
        # each block's K1 against its plain version on the same block
        for t, got in zip(plain, sums):
            for want, have in zip(lamb_moments(*t, c, layers, plain=True), got):
                rel = max(rel, float(((have - want).abs() / want).max()))
        ratio = trust_ratio(xsq, usq) * lr
        lamb_apply(x, m, v, c, ratio, layers)
        for t, q in zip(blocks, plain):
            lamb_apply(t[0], t[2], t[3], c, ratio, layers)
            lamb_apply(q[0], q[2], q[3], c, ratio, layers, plain=True)
        torch.cuda.synchronize()
        equal = all(torch.equal(shard_block(whole, lay, ctx.mesh), part)
                    for ctx, t in zip(ranks, blocks)
                    for whole, part in zip((x, m, v), (t[0], t[2], t[3])))
        # each block's K1 + K2 against the plain pair on the same block, by
        # phase 3's tolerances: m', v' a few ulps, x' 1e-4 of its step
        for t, q, x0 in zip(blocks, plain, starts):
            near = (torch.allclose(t[2], q[2], rtol=1e-5, atol=1e-9)
                    and torch.allclose(t[3], q[3], rtol=1e-5, atol=1e-14)
                    and bool(((t[0] - q[0]).abs() <= 1e-4 * (q[0] - x0).abs()
                              + 1.2e-7 * q[0].abs() + 1e-12).all()))
            if not near:
                raise AssertionError(f"{label}: {k}'s block kernels leave their plain version")
        counted = [r for r, ctx in enumerate(ranks) if ctx.counts(k)]
        log(f"{label} {k:22s} {str(tuple(p.shape)):22s} splits {lay.splits}, counted on "
            f"ranks {counted}: partials rel {rel:.2e}, x' m' v' blocks bit-equal {equal}")
        if rel > 1e-6 or not equal:
            raise AssertionError(f"{label}: {k} breaks the block contract")
        worst = max(worst, rel)
        cut = set(lay.axes)
        if {"data", "model"} <= cut:
            split["both"] += 1
        elif lay.split:
            split["model" if cut == {"model"} else "data"] += 1
        del x, g, m, v, blocks, plain, starts
    torch.cuda.empty_cache()
    log(f"{label}: of {len(flatten(model.defs))} leaves of {arch} over {mesh}"
        f"{' stored under ' + ','.join(rules) if rules else ''}, split over data and model "
        f"{split['both']}, data alone {split['data']}, model alone {split['model']}; worst "
        f"partials rel {worst:.2e}")


# (label, rows, in, out, product): BERT-large's MLP over model=2 at the main
# path's micro-batch (32 x 128 tokens): wi column-parallel (1024 -> 4096/2),
# wo row-parallel (4096/2 -> 1024)
TP_PRODUCTS = [("wi column-parallel", 4096, 1024, 2048, "column"),
               ("wo row-parallel", 4096, 2048, 1024, "row")]


def _tp_product_inputs(device, n, k, o, seed):
    """A bf16 input, weight (std k^-1/2) and output cotangent; the input and
    weight want gradients."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, k), generator=gen, device=device).to(torch.bfloat16)
    w = (k ** -0.5 * torch.randn((k, o), generator=gen, device=device)).to(torch.bfloat16)
    dy = torch.randn((n, o), generator=gen, device=device).to(torch.bfloat16)
    return x.requires_grad_(), w.requires_grad_(), dy


def _one_rank(kind):
    """One ``model`` rank's column_matmul or row_matmul at TP_MESH's model
    size, without the sum over the ranks (one card: no traffic)."""
    from repro_torch.models.layers.tensor_parallel import column_matmul, row_matmul
    from repro_torch.sharding.context import ModelAxis

    tp = ModelAxis(None, 0, TP_MESH["model"])
    fn = column_matmul if kind == "column" else row_matmul
    return lambda x, w: fn(x, w, tp)


def check_tp_products(device) -> None:
    """(d) One rank's tensor-parallel products at TP_PRODUCTS, forward and
    backward through autograd: the output, the input gradient and the
    weight gradient, each bf16 and within one bf16 ulp (plus 1e-6 of the
    sum of the terms' magnitudes, for the order of the fp32 sums) of the
    fp32 product of the bf16 operands.  Where the ranks split the
    contraction (the row product's output, the column product's input
    gradient) this runs the fp32-output GEMM."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # the fp32 references
    for i, (label, n, k, o, kind) in enumerate(TP_PRODUCTS):
        x, w, dy = _tp_product_inputs(device, n, k, o, 40 + i)
        y = _one_rank(kind)(x, w)
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        xf, wf, dyf = x.detach().float(), w.detach().float(), dy.float()
        ulps = {}
        for name, got, want, mag in (("y", y, xf @ wf, xf.abs() @ wf.abs()),
                                     ("dx", dx, dyf @ wf.t(), dyf.abs() @ wf.abs().t()),
                                     ("dw", dw, xf.t() @ dyf, xf.abs().t() @ dyf.abs())):
            if got.dtype != torch.bfloat16:
                raise AssertionError(f"tp (d): {label} {name} came back {got.dtype}")
            err = (got.detach().float() - want).abs()
            ulps[name] = float((err / (bf16_ulp(want) + 1e-6 * mag)).max())
        log(f"tp (d) {label}: n {n}, {k} -> {o}: bf16 ulps from the fp32 product "
            + ", ".join(f"{k_} {v:.2f}" for k_, v in ulps.items()))
        if max(ulps.values()) > 1.0:
            raise AssertionError(f"tp (d): {label} leaves the fp32 product by more than "
                                 "one bf16 ulp")
        del x, w, dy, y, dx, dw, xf, wf, dyf
    torch.cuda.empty_cache()


def time_tp_products(device, rate: float) -> dict:
    """Forward + backward of one rank's TP_PRODUCTS: the port's
    (``tp``: fp32 partials where the ranks split the contraction), the
    plain bf16 product one device runs (``bf16``), and the product formed
    as an fp32 GEMM of upcast operands (``fp32_upcast``, the design the
    port's replaced), in the order tp, bf16, upcast, upcast, bf16, tp;
    beside the bound of the three bf16 GEMMs.  Returns ``{label: ms}``."""
    import torch

    from repro_torch.kernels import cost
    out = {}
    for i, (label, n, k, o, kind) in enumerate(TP_PRODUCTS):
        x, w, dy = _tp_product_inputs(device, n, k, o, 40 + i)
        fns = {"tp": _one_rank(kind), "bf16": lambda a, b: a @ b,
               "fp32_upcast": lambda a, b: (a.float() @ b.float()).to(a.dtype)}
        times = {name: [] for name in fns}
        for name in ("tp", "bf16", "fp32_upcast", "fp32_upcast", "bf16", "tp"):
            fn = fns[name]
            times[name].append(cuda_ms(lambda: torch.autograd.grad(fn(x, w), (x, w), dy)))
        work = cost.Work(6 * (n * k + k * o + n * o) * 2, 3 * 2 * n * k * o, "bfloat16")
        entry = {name: min(t) for name, t in times.items()}
        entry.update(bound_of(work, rate))
        out[label] = entry
        log(f"time tp product {label} (n {n}, {k} -> {o}, bf16, forward + backward): "
            + ", ".join(f"{name} {t} ms" for name, t in times.items())
            + f"; bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}")
        del x, w, dy
    torch.cuda.empty_cache()
    return out


def run_tp_main_path(device, reference: dict) -> dict:
    """(c) The main path through the Trainer on a data=1,model=1 mesh (a real
    NCCL group of one rank): every tensor-parallel operator is the identity
    (no model axis of more than one rank), so launch counts equal phase
    14's unsharded run and losses, grad norms and params are bit-equal to
    it.  Returns the launches."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import shutdown_distributed
    from repro_torch.sharding import ShardCtx

    torch.cuda.synchronize()
    reset_launches()
    try:
        trainer = launch_train.main(FSDP_ARGV + ["--mesh", "data=1,model=1"])
        torch.cuda.synchronize()
        launches, designs, copies = _counts()
        _check_launches("tp data=1,model=1", FSDP_STEPS, True, launches, designs, copies)
        hist = trainer.history
        params = {k: v.float().cpu() for k, v in trainer.gather_state().params.items()}
        axis = ShardCtx(trainer.mesh).model_axis
    finally:
        shutdown_distributed()
    losses = [h["loss/total"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    pdiff = max(float((params[k] - reference["params"][k]).abs().max()) for k in params)
    same = losses == reference["losses"] and norms == reference["grad_norms"]
    log(f"tp (c): mesh {trainer.mesh.shape}, model axis {axis}; losses {losses} (phase 14 "
        f"unsharded {reference['losses']}), grad norms {norms}; bit-equal {same}; params "
        f"max |diff| {pdiff:.3e}; launches {launches} (phase 14 unsharded "
        f"{reference['launches']})")
    if (axis is not None or not same or pdiff != 0.0 or launches != reference["launches"]):
        raise AssertionError("tp (c): the data=1,model=1 main path left phase 14's bits or "
                             "launch counts")
    del trainer, params
    torch.cuda.empty_cache()
    return launches


def run_tp(device, fsdp: dict) -> dict:
    """Phase 15; returns (a)'s launches per case and (c)'s."""
    t0 = time.perf_counter()
    out = {"slices": check_vocab_slices(device)}
    check_tp_blocks(device)
    check_tp_products(device)
    out["launches"] = run_tp_main_path(device, fsdp.pop("reference"))
    log(f"tp: phase 15 took {time.perf_counter() - t0:.1f} s")
    return out


def time_vocab_slices(device, rate: float) -> dict:
    """K6–K8 on one vocab slice of each of TP_CE_CASES (bf16, the tensor-core
    design), plain, kernel, kernel, plain, beside the whole vocab's kernel,
    the slice's bound and the dense head's matmul + cross_entropy on the
    slice (a yardstick only).  Returns ``{kernel: {case: numbers}}``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES, cost
    from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_dw, fused_ce_fwd

    result = {k: {} for k in FUSED_CE}
    for i, (label, n, d, v, m) in enumerate(TP_CE_CASES):
        h, w, lbl, g, logits = _vocab_slice_inputs(device, n, d, v, 15 + i)
        del logits
        vs = v // m
        ws, local = w[:vs], lbl.clamp(max=vs - 1)   # rank 0's slice
        lse = fused_ce_fwd(h, w, lbl)[2]
        fns = {
            "fused_ce_fwd": lambda plain, ww, v0: fused_ce_fwd(h, ww, lbl, plain=plain, v0=v0,
                                                               stats=True),
            "fused_ce_dh": lambda plain, ww, v0: fused_ce_dh(h, ww, lbl - v0, lse, g,
                                                             plain=plain),
            "fused_ce_dw": lambda plain, ww, v0: fused_ce_dw(h, ww, lbl - v0, lse, g,
                                                             plain=plain),
        }
        works = {"fused_ce_fwd": cost.fused_ce_fwd(n, d, vs, torch.bfloat16, stats=True),
                 "fused_ce_dh": cost.fused_ce_dh(n, d, vs, torch.bfloat16),
                 "fused_ce_dw": cost.fused_ce_dw(n, d, vs, torch.bfloat16)}
        dense = cuda_ms(lambda: F.cross_entropy(torch.matmul(h, ws.t()), local.long(),
                                                reduction="none"))
        for name, fn in fns.items():
            before = LAUNCHES[name]
            times = {"plain": [], "cuda": [], "whole": []}
            for plain in (True, False, False, True):
                times["plain" if plain else "cuda"].append(cuda_ms(lambda: fn(plain, ws, 0)))
                if not plain:
                    times["whole"].append(cuda_ms(lambda: fn(False, w, 0)))
            timed = LAUNCHES[name] - before
            entry = dict(ms=min(times["cuda"]), plain_ms=min(times["plain"]),
                         **bound_of(works[name], rate),
                         library_ms=dense if name == "fused_ce_fwd" else None,
                         whole_vocab_ms=min(times["whole"]), timed_launches=timed)
            result[name][label] = entry
            log(f"time {name} {label} slice (n {n} d {d} v {vs} of {v}, bf16): kernel "
                f"{times['cuda']} ms, whole vocab {times['whole']} ms, plain "
                f"{times['plain']} ms; bound {entry['bound_ms']:.4f} ms by "
                f"{entry['bound_by']}; "
                f"{works[name].operations / (entry['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
        log(f"time library {label} slice: matmul + cross_entropy {dense:.4f} ms")
        del h, w, ws, lbl, local, g, lse
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 16: rollback and preemption over a mesh, GQA on a rank's q heads,
# MoE data blocks
# ---------------------------------------------------------------------------

ROBUST_MESH = ("--mesh", "data=1,model=1")
GQA_B, GQA_S, GQA_H, GQA_HKV, GQA_D, GQA_RANKS = 8, 512, 15, 5, 64, 3   # smollm-360m, model=3
# the ranks' attention() against the whole call: each tensor within this
# many times the whole bf16 call's distance from the fp32 run
GQA_MODULE_FACTOR = 3.0
MOE_BLOCKS, MOE_BLOCK_CF = 4, 1.0   # data blocks; a capacity factor that drops some tokens


def check_mesh_rollback(device, reference: dict) -> dict:
    """(a) Phase 9's loss-spike rollback through the launcher's Trainer on
    a data=1,model=1 mesh (an NCCL group of one rank, and the host group
    the verdict is broadcast over): the same ``rollback`` event fields, the
    same final step and status, the final params bit-equal to phase 9's.
    Returns the run's launches."""
    import shutil

    import torch

    tmp = _scratch("ckpt_mesh_rollback_")
    try:
        trainer, _, events, launches, on_disk = _rollback_run(
            device, _with_steps(MAIN_ARGV, 8) + list(ROBUST_MESH), tmp)
        rbs = [e for e in events if e["event"] == "rollback"]
        fields = {k: rbs[0].get(k) for k in ROLLBACK_FIELDS} if len(rbs) == 1 else None
        step, status = int(trainer.state.step), events[-1].get("status")
        differ = [k for k, v in trainer.gather_state().params.items()
                  if not _same_bits(v.cpu(), reference["params"][k])]
        log(f"mesh robustness (a) rollback: mesh {trainer.mesh.shape}, host group "
            f"{trainer.mesh.host_group is not None}; rollback {fields} (phase 9 "
            f"{reference['fields']}); step {step} status {status} (phase 9 "
            f"{reference['step']} {reference['status']}); checkpoints on disk {on_disk}; "
            f"param leaves not bit-equal to phase 9's {differ}; launches {launches}")
        if fields != reference["fields"] or step != reference["step"] \
                or status != reference["status"] or differ or launches != _want_launches(8):
            raise AssertionError("mesh robustness (a): the rollback over the mesh left phase "
                                 "9's")
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def time_agreed_flag(device, calls: int = 200) -> dict:
    """(a) The agreed flag alone: ``calls`` readings of
    ``PreemptionHandler.agreed`` over the mesh's host group (one gloo
    all-reduce each) under ``torch.profiler``: host µs a reading and the
    device kernels and copies it makes, which must be none.  Then the main
    path's step on the data=1,model=1 mesh without and with
    ``--preempt-grace 30``, in turns on one Trainer
    (``profile_step.measure``; ``preempt_grace`` unset for the run
    without): wall, busy and launches a step, logged.  A profiled step's
    launches drift by one or two between runs of one Trainer, so the
    flag's own trace is what is held to zero."""
    import torch
    import torch.distributed
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_step import DEFAULT_ARGV, measure
    from repro_torch.train.preempt import PreemptionHandler

    trainer, data, _ = _trainer(DEFAULT_ARGV + ["--steps", "8", "--preempt-grace", "30",
                                                *ROBUST_MESH])
    host, flag = trainer.mesh.host_group, PreemptionHandler(enabled=False)
    flag.agreed(host)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            flag.agreed(host)
        us = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
    on_device = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    log(f"mesh robustness (a) agreed flag: {calls} readings over the host group "
        f"({torch.distributed.get_backend(host)}), {us:.1f} us each on the host, {on_device} "
        "device kernels and copies")
    got = {"without": None, "--preempt-grace": None}
    for v in got:
        trainer.preempt_grace = 30.0 if v == "--preempt-grace" else None
        r = measure(trainer, data)
        got[v] = {k: r[k] for k in ("wall_ms", "span_ms", "busy_ms", "launches", "idle")}
        log(f"mesh robustness (a) timing {v}: wall {r['wall_ms']:.2f} ms/step, span "
            f"{r['span_ms']:.2f} ms, busy {r['busy_ms']:.2f} ms in {r['launches']} launches, "
            f"idle {r['idle']:.3f}")
    del trainer, data
    torch.cuda.empty_cache()
    if on_device:
        raise AssertionError(f"mesh robustness (a): the agreed flag made {on_device} device "
                             "kernels or copies")
    return dict(flag_us=us, flag_device_events=on_device, **got)


def check_gqa_rank_heads(device) -> dict:
    """(b) smollm-360m's attention (15 heads, 5 kv heads, D 64, causal) at
    B 8 x S 512 through K3–K5 (``flash_sdpa``, bf16), whole and as each of
    the three model=3 ranks' q heads against their global kv heads
    (``tensor_parallel.kv_head_index``: rank 0's heads read kv heads
    0,0,0,1,1): each rank's o and dq within a bf16 ulp of the whole run's
    slice, and the three ranks' dk/dv partials (each q head's, added into
    its kv head in fp32, as ``kv_heads_for_rank``'s backward does) summed
    in fp32 and rounded once, within 2 bf16 ulps of the whole run's (ulps
    of the largest of the element's whole value and its partials'
    magnitudes summed, as phase 15's K7 partials).  Returns the ranks'
    K3–K5 launches."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.ops import flash_sdpa
    from repro_torch.models.layers.tensor_parallel import kv_head_index
    from repro_torch.sharding.context import ModelAxis

    gen = torch.Generator(device=device).manual_seed(16)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    q, do = randn(GQA_B, GQA_S, GQA_H, GQA_D), randn(GQA_B, GQA_S, GQA_H, GQA_D)
    k, v = randn(GQA_B, GQA_S, GQA_HKV, GQA_D), randn(GQA_B, GQA_S, GQA_HKV, GQA_D)
    qw, kw, vw = (x.clone().requires_grad_() for x in (q, k, v))
    o = flash_sdpa(qw, kw, vw, causal=True)
    dq, dk, dv = torch.autograd.grad(o, (qw, kw, vw), do)
    h = GQA_H // GQA_RANKS
    acc = {n: torch.zeros(k.shape, dtype=torch.float32, device=device)
           for n in ("dk", "dv", "|dk|", "|dv|")}
    worst = {"o": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}

    def ulps(a, b, scale=None):
        scale = torch.maximum(a.float().abs(), b.float().abs()) if scale is None else scale
        return float(((a.float() - b.float()).abs() / bf16_ulp(scale)).max())

    heads = []
    reset_launches()
    for r in range(GQA_RANKS):
        idx = kv_head_index(h, GQA_H, GQA_HKV, ModelAxis(None, r, GQA_RANKS), device=device)
        heads.append(idx.tolist())
        cut = slice(r * h, (r + 1) * h)
        qr = q[:, :, cut].clone().requires_grad_()
        kr, vr = (x.index_select(2, idx).requires_grad_() for x in (k, v))
        orr = flash_sdpa(qr, kr, vr, causal=True)
        dqr, dkr, dvr = torch.autograd.grad(orr, (qr, kr, vr), do[:, :, cut])
        for n, part in (("dk", dkr), ("dv", dvr)):
            acc[n].index_add_(2, idx, part.float())
            acc[f"|{n}|"].index_add_(2, idx, part.float().abs())
        worst["o"] = max(worst["o"], ulps(orr.detach(), o[:, :, cut].detach()))
        worst["dq"] = max(worst["dq"], ulps(dqr, dq[:, :, cut]))
    torch.cuda.synchronize()
    launches, _, _ = _counts()
    # ulps of the largest of the element's whole value and its partials'
    # magnitudes summed: each q head's partial rounds at its own size
    for n, whole in (("dk", dk), ("dv", dv)):
        worst[n] = ulps(acc[n].to(torch.bfloat16), whole,
                        torch.maximum(whole.float().abs(), acc[f"|{n}|"]))
    log(f"mesh robustness (b) GQA: B {GQA_B} S {GQA_S} H {GQA_H} Hkv {GQA_HKV} D {GQA_D} over "
        f"model={GQA_RANKS}: the ranks' kv heads {heads}; worst bf16 ulps against the whole "
        f"run: {worst}; the ranks' launches {launches}")
    if worst["o"] > 1 or worst["dq"] > 1 or worst["dk"] > 2 or worst["dv"] > 2 \
            or any(launches[x] != GQA_RANKS for x in FLASH):
        raise AssertionError(f"mesh robustness (b): a rank's q heads left the whole run: "
                             f"{worst}, launches {launches}")
    del q, k, v, do, qw, kw, vw, o, dq, dk, dv, acc
    torch.cuda.empty_cache()
    return {x: launches[x] for x in FLASH}


def check_gqa_attention_ranks(device) -> dict:
    """(b) the port's own path for a rank's q heads: ``attention()`` of
    smollm-360m (d 960, 15 heads over 5 kv heads, D 64, RoPE, causal,
    flash) at B 8 x S 512 in bf16, whole and under each of the three
    model=3 ranks' ``ShardCtx``: a ``data=1,model=3`` mesh whose model
    group is this process's one-rank NCCL world, so that each rank's sums
    over ``model`` keep its own partial (``kv_heads_for_rank`` selects the
    global kv heads on the card, and its backward adds each q head's rows
    into its kv head in fp32).  The ranks' outputs and their ``x``, ``wk``
    and ``wv`` gradients, summed in fp32, and their ``wq``/``wo``
    gradients laid side by side, each no farther (max |diff|) from an fp32
    run of the same function (the plain attention on the same bf16 values
    upcast) than ``GQA_MODULE_FACTOR`` times the whole bf16 call is.  Each
    rank launches K3–K5 once.  Runs while phase 16 (a)'s process group is
    up; returns the ranks' launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers.attention import attention, attention_defs
    from repro_torch.sharding import ShardCtx, use_sharding

    cfg = get_config("smollm-360m").replace(use_flash_kernel=True)
    h, d = cfg.n_heads, cfg.d_model
    if (h, cfg.n_kv_heads, cfg.head_dim) != (GQA_H, GQA_HKV, GQA_D):
        raise AssertionError(f"mesh robustness (b): smollm-360m's heads are not {GQA_H} "
                             f"over {GQA_HKV} of {GQA_D}")
    group = dist.group.WORLD
    if dist.get_backend(group) != "nccl" or dist.get_world_size() != 1:
        raise AssertionError("mesh robustness (b): needs phase 16 (a)'s one-rank NCCL world")
    gen = torch.Generator(device=device).manual_seed(162)

    def randn(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    params = {name: randn(p.shape, 0.02 if name.startswith("b") else
                          (h * cfg.head_dim if name == "wo" else d) ** -0.5)
              for name, p in attention_defs(cfg).items()}
    x, dy = randn((GQA_B, GQA_S, d), 1.0), randn((GQA_B, GQA_S, d), 1.0)
    pos = torch.arange(GQA_S, device=device)[None].expand(GQA_B, GQA_S)
    names = sorted(params)

    def run(p, xx, c, ctx=None):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xin = xx.clone().requires_grad_()
        with use_sharding(ctx):
            out = attention(leaves, xin, pos, c)
        grads = torch.autograd.grad(out, [xin] + [leaves[k] for k in names], dy.to(out.dtype))
        return {"out": out.detach().float(), "x": grads[0].float(),
                **{k: g.float() for k, g in zip(names, grads[1:])}}

    ref = run({k: v.float() for k, v in params.items()}, x.float(),
              cfg.replace(use_flash_kernel=False))
    whole = run(params, x, cfg)
    per = h // GQA_RANKS
    split = {k: torch.zeros_like(v) for k, v in whole.items()}
    reset_launches()
    for r in range(GQA_RANKS):
        cut = slice(r * per, (r + 1) * per)
        mine = {k: v[:, cut] if k == "wq" else v[cut] if k in ("wo", "bq") else v
                for k, v in params.items()}
        mesh = Mesh({"data": 1, "model": GQA_RANKS}, rank=r, groups={("model",): group})
        for k, g in run(mine, x, cfg, ShardCtx(mesh)).items():
            if k == "wq":
                split[k][:, cut] = g
            elif k in ("wo", "bq"):
                split[k][cut] = g
            else:
                split[k] += g
    torch.cuda.synchronize()
    launches, _, _ = _counts()
    gaps = {k: (float((split[k] - ref[k]).abs().max()), float((whole[k] - ref[k]).abs().max()))
             for k in whole}
    log(f"mesh robustness (b) GQA attention(): B {GQA_B} S {GQA_S} d {d} over "
        f"model={GQA_RANKS} ranks of one NCCL rank; max |diff| from the fp32 run, the "
        f"ranks' sum against the whole call: "
        + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in gaps.items())
        + f"; the ranks' launches {launches}")
    far = {k: v for k, v in gaps.items() if not v[0] <= GQA_MODULE_FACTOR * v[1]}
    if far or any(launches[k] != GQA_RANKS for k in FLASH):
        raise AssertionError(f"mesh robustness (b): the ranks' attention() left the whole "
                             f"call: {far}, launches {launches}")
    del params, x, dy, ref, whole, split
    torch.cuda.empty_cache()
    return {k: launches[k] for k in FLASH}


def check_moe_data_blocks(device) -> dict:
    """(c) granite-moe-1b-a400m's MoE layer at phase 11's shape (B 8 x S
    512: T 4096 tokens, E 32, top-8, d 1024, expert ff 512; bf16) with
    capacity factor 1.0 (some experts overflow), whole and as four data
    blocks of 1024 rows: each block routes its rows, takes the whole
    layer's capacity and its offsets (the exclusive prefix of the blocks'
    per-expert counts, by the plain gather), places its kept assignments
    (``moe.place``) and runs the experts and the combine.  The four outputs concatenated bit-equal to
    the whole layer's; the drop fraction from the summed kept counts equal
    to the whole's, the load-balance loss from the summed router sums
    within fp32 rounding (2e-6 relative: the sums add in another order).
    Times one block's dispatch beside the whole's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe
    from repro_torch.sharding import collectives as C

    cfg = get_config(MOE_ARCH).replace(capacity_factor=MOE_BLOCK_CF)
    d, e, f, k = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.n_experts_per_tok
    gen = torch.Generator(device=device).manual_seed(17)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    p = {"router": randn(d, e, scale=d ** -0.5), "wi": randn(e, d, f, scale=d ** -0.5),
         "wg": randn(e, d, f, scale=d ** -0.5), "wo": randn(e, f, d, scale=f ** -0.5)}
    t = 8 * 512
    x = randn(t, d)
    with torch.no_grad():
        buf, dest, gates, keep, aux = moe.dispatch(p, x, cfg)
        whole = moe.combine(moe.experts(p, buf, cfg), dest, gates, k)
        drop = moe.drop_fraction(keep)
        c = moe.capacity(t, cfg)
        rows = t // MOE_BLOCKS
        blocks = []
        for r in range(MOE_BLOCKS):
            xr = x[r * rows:(r + 1) * rows]
            logits = xr.to(torch.float32) @ p["router"].to(torch.float32)
            gates_r, idx_r, _ = moe.route(logits, cfg)
            hits = moe.expert_hits(idx_r, e)
            blocks.append(dict(x=xr, gates=gates_r, idx=idx_r, hits=hits,
                               counts=hits.sum(1, dtype=torch.int32),
                               probs=torch.softmax(logits, -1).sum(0),
                               top1=F.one_hot(idx_r[:, 0], e).to(torch.float32).sum(0)))
        every = C.gather_leaf_plain([b["counts"][None] for b in blocks], 0)   # (blocks, E)
        outs, kept = [], []
        for r, b in enumerate(blocks):
            offsets = every[:r].sum(0, dtype=torch.int32)
            buf_r, dest_r, keep_r = moe.place(b["x"], b["idx"], b["hits"], c, offsets)
            outs.append(moe.combine(moe.experts(p, buf_r, cfg), dest_r, b["gates"], k))
            kept.append(keep_r.to(torch.float32).sum())
        me = C.all_reduce_plain([b["probs"] for b in blocks]) / t
        fe = C.all_reduce_plain([b["top1"] for b in blocks]) / t
        lb = e * (fe * me).sum()
        drop_blocks = 1.0 - C.all_reduce_plain(kept) / (t * k)
        same = torch.equal(torch.cat(outs), whole)
        lb_rel = float((lb - aux["moe_lb_loss"]).abs() / aux["moe_lb_loss"])
        drops = (float(drop), float(drop_blocks))
        log(f"mesh robustness (c) MoE: T {t} in {MOE_BLOCKS} blocks, E {e}, top-{k}, C {c}; "
            f"outputs bit-equal {same}; drop fraction whole {drops[0]} blocks {drops[1]}; lb "
            f"whole {float(aux['moe_lb_loss']):.8f} blocks {float(lb):.8f} (rel {lb_rel:.2e}); "
            f"block offsets of expert 0 {every[:, 0].cumsum(0).tolist()}")
        if not same or drops[0] != drops[1] or not drops[0] > 0 or lb_rel > 2e-6:
            raise AssertionError("mesh robustness (c): the data blocks left the whole layer")

        b0 = blocks[MOE_BLOCKS - 1]
        last = every[:MOE_BLOCKS - 1].sum(0, dtype=torch.int32)

        def block_dispatch():
            logits = b0["x"].to(torch.float32) @ p["router"].to(torch.float32)
            _, idx_r, _ = moe.route(logits, cfg)
            moe.place(b0["x"], idx_r, moe.expert_hits(idx_r, e), c, last)

        times = {"block": cuda_ms(block_dispatch),
                 "whole": cuda_ms(lambda: moe.dispatch(p, x, cfg))}
    log(f"mesh robustness (c) MoE dispatch: one block of {rows} rows {times['block']:.4f} ms, "
        f"the whole {t} rows {times['whole']:.4f} ms")
    del p, x, buf, whole, outs, blocks
    torch.cuda.empty_cache()
    return dict(times=times, drop=drops[0], capacity=c)


def run_mesh_robustness(device, rollback_ref: dict, preempt_ref: dict, ref_losses,
                        ref_params) -> dict:
    """Phase 16; returns (a)'s rollback launches and timing, (b)'s launches
    and (c)'s times."""
    from repro_torch.launch.mesh import shutdown_distributed

    t0 = time.perf_counter()
    out = {}
    try:
        out["launches"] = check_mesh_rollback(device, rollback_ref)
        got = check_preemption(device, ref_losses, ref_params, mesh=ROBUST_MESH,
                               label="mesh robustness (a) preemption")
        log(f"mesh robustness (a) preemption: preempt event {got['fields']} (phase 9 "
            f"{preempt_ref['fields']}), stopped at step {got['stopped']} (phase 9 "
            f"{preempt_ref['stopped']})")
        if got != preempt_ref:
            raise AssertionError("mesh robustness (a): the preemption over the mesh left "
                                 "phase 9's")
        out["agreed_flag"] = time_agreed_flag(device)
        out["gqa_launches"] = check_gqa_attention_ranks(device)
    finally:
        shutdown_distributed()
    out["gqa_contract_launches"] = check_gqa_rank_heads(device)
    out["moe"] = check_moe_data_blocks(device)
    log(f"mesh robustness: phase 16 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: expert parallelism, the inner axis and MLA heads over model
# ---------------------------------------------------------------------------

EP_MESH = {"data": 1, "model": 4}    # granite-moe-1b-a400m's 32 experts, 8 a rank
EP_T, EP_CF = 8 * 512, 1.0           # phase 11's micro-batch; some experts overflow
MLA_RANKS, MLA_B, MLA_S = 8, 2, 512  # deepseek-v3's 128 heads, 16 a rank
XLSTM_RANKS, XLSTM_B, XLSTM_S = 2, 4, 256
MAMBA_RANKS, MAMBA_B, MAMBA_S = 4, 1, 256


def _layer_weights(defs, device, seed: int) -> dict:
    """bf16 weights of a layer: the port's init from ``seed``, every
    all-zero matrix (the gate weights) drawn at its fan-in's scale so that
    the layer uses it."""
    import torch

    from repro_torch.nn import init_params

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, v in init_params(defs, seed, device).items():
        if v.dim() > 1 and not v.any():
            v = torch.randn(v.shape, generator=gen, device=device) * v.shape[0] ** -0.5
        out[k] = v.to(torch.bfloat16)
    return out


def _over_ranks(device, label: str, defs, call, cfg, m: int, x, dy, seed: int):
    """``call(p, x, cfg) -> (out, aux)`` of a layer three ways: an fp32 run
    (the bf16 weights and input upcast), the whole bf16 call, and its ``m``
    model ranks' shares, each rank the port's own layer on its blocks on a
    thread of ``run_plain_ranks`` (the cross-rank sums and gathers are the
    plain collectives over the ranks' tensors on the card; one backward
    over the joined graph).  The loss is ``Σ out·dy`` plus the MoE's
    load-balance term once.  Returns ``{tensor: (ranks' max |diff| from the
    fp32 run, whole's)}`` over the output, x's gradient and every leaf's
    (a split leaf's ranks' blocks side by side), the ranks' and the whole's
    aux, and the ranks' forward wall seconds."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardCtx, leaf_layout, specs_for, use_sharding
    from repro_torch.sharding import collectives as C

    weights = _layer_weights(defs, device, seed)
    sizes = {"data": 1, "model": m}
    specs = specs_for(defs, Mesh(sizes))
    dims = {k: leaf_layout(sp, Mesh(sizes)).model for k, sp in specs.items()}

    def loss(out, aux):
        return (out.float() * dy).sum() + aux.get("moe_lb_loss", 0.0)

    def run(p, xx, c):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xin = xx.clone().requires_grad_()
        out, aux = call(leaves, xin, c)
        names = sorted(leaves)
        grads = torch.autograd.grad(loss(out, aux), [xin] + [leaves[k] for k in names])
        return ({"out": out.detach().float(), "x": grads[0].float(),
                 **{k: g.float() for k, g in zip(names, grads[1:])}}, aux)

    ref, _ = run({k: v.float() for k, v in weights.items()}, x.float(),
                 cfg.replace(activation_dtype="float32"))
    whole, whole_aux = run(weights, x, cfg)

    shared = {k: v.clone().requires_grad_() for k, v in weights.items() if dims[k] is None}
    blocks = [{k: shared[k] if dims[k] is None
               else C.shard_leaf(v, dims[k], m, r).requires_grad_()
               for k, v in weights.items()} for r in range(m)]
    xin = x.clone().requires_grad_()

    def rank(group):
        torch.cuda.set_device(x.device)   # a new thread has no current context
        mesh = Mesh(sizes, rank=group.index, groups={("model",): group})
        with use_sharding(ShardCtx(mesh, param_specs=specs)):
            return call(blocks[group.index], xin, cfg)

    t0 = time.perf_counter()
    got = C.run_plain_ranks(rank, m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out, aux = got[0]   # every rank's output is the whole: summed or replicated
    names = sorted(weights)
    wanted = [xin] + [t for k in names
                      for t in ([shared[k]] if dims[k] is None else [b[k] for b in blocks])]
    grads = list(torch.autograd.grad(loss(out, aux), wanted))
    split = {"out": out.detach().float(), "x": grads.pop(0).float()}
    for k in names:   # a split leaf's ranks' blocks side by side
        parts = [grads.pop(0) for _ in range(1 if dims[k] is None else m)]
        split[k] = C.gather_leaf_plain(parts, dims[k]).float()
    gaps = {k: (float((split[k] - ref[k]).abs().max()), float((whole[k] - ref[k]).abs().max()))
            for k in whole}
    log(f"model axis {label}: over model={m} ranks (plain collectives), max "
        f"|diff| from the fp32 run, the ranks' against the whole bf16 call: "
        + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in gaps.items())
        + f"; the ranks' forward {wall:.2f} s wall")
    far = {k: v for k, v in gaps.items() if not v[0] <= GQA_MODULE_FACTOR * v[1]}
    if far:
        raise AssertionError(f"model axis {label}: the ranks left the whole call: {far}")
    del ref, whole, split, blocks, shared, weights, grads
    torch.cuda.empty_cache()
    return [a for _, a in got], whole_aux, wall


def check_expert_parallel(device) -> dict:
    """(a) granite-moe-1b-a400m's MoE layer (T 4096 = B 8 x S 512, E 32,
    top-8, d 1024, expert ff 512, capacity factor 1.0: some experts
    overflow; bf16) as each of four model ranks' 8 experts: the summed
    outputs, x and router gradients and each rank's wi/wg/wo gradients
    within 3x the whole bf16 call's distance from an fp32 run; every rank's
    drop fraction equal to the whole layer's and its load-balance loss
    within 1e-6.  Then one rank's dispatch (routing the gathered logits and
    placing its experts' rows), experts and combine (an fp32 partial)
    timed beside the whole layer's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe
    from repro_torch.sharding.context import ModelAxis

    cfg = get_config(MOE_ARCH).replace(capacity_factor=EP_CF)
    m, k = EP_MESH["model"], cfg.n_experts_per_tok
    gen = torch.Generator(device=device).manual_seed(171)
    x = torch.randn((8, EP_T // 8, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=device)
    auxs, whole_aux, wall = _over_ranks(device, "(a) expert parallel", moe.moe_defs(cfg),
                                        moe.moe, cfg, m, x, dy, 171)
    drops = [float(a["moe_drop_fraction"].detach()) for a in auxs]
    lbs = [float(a["moe_lb_loss"].detach()) for a in auxs]
    want_drop = float(whole_aux["moe_drop_fraction"].detach())
    want_lb = float(whole_aux["moe_lb_loss"].detach())
    lb_rel = max(abs(v - want_lb) / want_lb for v in lbs)
    log(f"model axis (a): T {EP_T}, E {cfg.n_experts} over {m} ranks, top-{k}, C "
        f"{moe.capacity(EP_T, cfg)}; drop fraction whole {want_drop} ranks {drops}; lb whole "
        f"{want_lb:.8f} ranks {lbs} (rel {lb_rel:.2e})")
    if any(v != want_drop for v in drops) or not want_drop > 0 or lb_rel > 1e-6:
        raise AssertionError("model axis (a): the ranks' routing left the whole layer's")

    # one rank's stages beside the whole layer's, bf16, no gradients
    p = _layer_weights(moe.moe_defs(cfg), device, 172)
    el = cfg.n_experts // m
    tp = ModelAxis(None, m - 1, m)
    mine = {n: (v[:, (m - 1) * el:] if n == "router" else v[(m - 1) * el:])
            for n, v in p.items()}
    xf = x.reshape(EP_T, cfg.d_model)
    with torch.no_grad():
        logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
        c = moe.capacity(EP_T, cfg)

        def rank_dispatch():
            gates, idx, _ = moe.route(logits, cfg)
            return moe.place(xf, idx, moe.expert_hits(idx, cfg.n_experts), c, None, tp), gates

        (buf_r, dest_r, _), gates = rank_dispatch()
        buf, dest, _, _, _ = moe.dispatch(p, xf, cfg)
        y_r, y = moe.experts(mine, buf_r, cfg), moe.experts(p, buf, cfg)
        times = {
            "dispatch": (cuda_ms(rank_dispatch), cuda_ms(lambda: moe.dispatch(p, xf, cfg))),
            "experts": (cuda_ms(lambda: moe.experts(mine, buf_r, cfg)),
                        cuda_ms(lambda: moe.experts(p, buf, cfg))),
            "combine": (cuda_ms(lambda: moe.combine(y_r, dest_r, gates, k, torch.float32)),
                        cuda_ms(lambda: moe.combine(y, dest, gates, k))),
        }
    log(f"model axis (a) timed, one rank's ({el} experts) against the whole layer's "
        f"({cfg.n_experts}), ms: " + ", ".join(f"{n} {a:.4f} / {b:.4f}" for n, (a, b) in times.items()))
    del p, mine, x, dy, buf, buf_r, y, y_r, logits
    torch.cuda.empty_cache()
    return dict(times=times, drop=want_drop, wall=wall)


def check_mla_heads(device) -> dict:
    """(c) deepseek-v3's full-width attention (d 7168, 128 heads, q_lora
    1536, kv_lora 512, nope 128 + rope 64, v 128) at B 2 x S 512, naive and
    absorbed, bf16, as each of eight model ranks' 16 heads: the summed
    outputs and x gradients and every leaf's gradient (the latent
    projections' summed, the heads' side by side) within 3x the whole bf16
    call's distance from an fp32 run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import mla

    base = get_config("deepseek-v3-671b")
    gen = torch.Generator(device=device).manual_seed(173)
    x = torch.randn((MLA_B, MLA_S, base.d_model), generator=gen, device=device
                    ).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=device)
    pos = torch.arange(MLA_S, device=device)[None].expand(MLA_B, MLA_S)
    walls = {}
    for name, absorb in (("naive", False), ("absorbed", True)):
        cfg = base.replace(mla_absorb=absorb)
        _, _, walls[name] = _over_ranks(
            device, f"(c) MLA {name}", mla.mla_defs(cfg),
            lambda p, xx, c: (mla.mla_attention(p, xx, pos, c), {}), cfg, MLA_RANKS, x, dy, 173)
    return walls


def check_inner_axis(device) -> dict:
    """(d) xlstm-350m's mLSTM and sLSTM blocks (d 1024, 4 heads, up-projection
    2048) at B 4 x S 256 as two model ranks (the mLSTM on each rank's 1024
    ``inner`` columns and 2 heads, the sLSTM on its 2 heads), and Jamba's
    full-width Mamba layer (d 8192, d_inner 16384, d_state 16, dt rank 512)
    at B 1 x S 256 as four ranks (4096 of d_inner each), bf16: the same
    rule as (a)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import mamba, xlstm

    walls = {}
    gen = torch.Generator(device=device).manual_seed(174)
    xcfg = get_config(XLSTM_ARCH)
    x = torch.randn((XLSTM_B, XLSTM_S, xcfg.d_model), generator=gen, device=device
                    ).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=device)
    for name, defs, fn in (("mLSTM", xlstm.mlstm_defs, xlstm.mlstm_block),
                           ("sLSTM", xlstm.slstm_defs, xlstm.slstm_block)):
        _, _, walls[name] = _over_ranks(
            device, f"(d) xlstm-350m {name}", defs(xcfg),
            lambda p, xx, c, fn=fn: (fn(p, xx, c)[0], {}), xcfg, XLSTM_RANKS, x, dy, 174)
    jcfg = get_config("jamba-1.5-large-398b")
    x = torch.randn((MAMBA_B, MAMBA_S, jcfg.d_model), generator=gen, device=device
                    ).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=device)
    _, _, walls["Mamba"] = _over_ranks(
        device, "(d) Jamba Mamba", mamba.mamba_defs(jcfg),
        lambda p, xx, c: (mamba.mamba(p, xx, c)[0], {}), jcfg, MAMBA_RANKS, x, dy, 175)
    return walls


def run_model_axis(device) -> dict:
    """Phase 17; returns (a)'s times and every part's ranks' wall seconds."""
    t0 = time.perf_counter()
    out = {"ep": check_expert_parallel(device)}
    check_tp_blocks(device, MOE_ARCH, EP_MESH, "model axis (b)")
    out["mla"] = check_mla_heads(device)
    out["inner"] = check_inner_axis(device)
    log(f"model axis: phase 17 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: the dry-run and the roofline
# ---------------------------------------------------------------------------

# (a) phase 5's step (BERT-large, batch 64 x seq 128, accum 2, bf16, fused
# LAMB, flash, the fused CE head), traced on meta tensors over an abstract
# data=1 mesh and then run on the card; (b) two production records
DRY_BATCH, DRY_SEQ = 64, 128
DRY_TC = dict(accum_steps=2, precision="bf16", use_fused_lamb=True)
DRY_LAUNCHES = {"lamb_moments": LEAVES, "lamb_apply": LEAVES,
                **{k: LAYERS * ACCUM for k in FLASH}, **{k: ACCUM for k in FUSED_CE}}
DRY_PEAK_TOL = 0.10
DRY_RECORDS = [("smollm-360m", "decode_32k"), ("smollm-360m", "train_4k")]
# K6's and K7's vocab-split plans held to the library's: (n, d, v)
DRY_PLAN_SHAPES = [(640, 1024, 30522), (1232, 1024, 30522), (4096, 1024, 49155),
                   (1024, 7168, 129280), (97, 80, 300)]


def _tensor_bytes(tree) -> int:
    import torch

    from repro_torch.checkpoint.io import tree_leaves_with_paths

    return sum(x.numel() * x.element_size() for _, x in tree_leaves_with_paths(tree)
               if isinstance(x, torch.Tensor))


def check_split_plans(device) -> None:
    """The meta route's vocab-split plan (``fused_ce.plan_splits``, from
    the H100 figures) against the library's on this card, for K6 and K7 in
    both designs, and K1's chunk (``lamb_update.CHUNK_ELEMS``) against the
    library's: the scratch the dry-run allocates is the kernels'."""
    import torch

    from repro_torch.kernels.fused_ce import DESIGNS, _DESIGN_CODES, _DTYPE_CODES, _splits, \
        plan_splits
    from repro_torch.kernels.lamb_update import CHUNK_ELEMS
    from repro_torch.kernels.lamb_update import _lib as lamb_lib

    chunk = lamb_lib().lamb_chunk_elems()
    if chunk != CHUNK_ELEMS:
        raise AssertionError(f"the meta route's LAMB chunk {CHUNK_ELEMS} differs from the "
                             f"library's {chunk}")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    bad = []
    for pass_ in (0, 1):
        for design in DESIGNS:
            for dtype in ((torch.bfloat16,) if design == "mma" else (torch.bfloat16,
                                                                     torch.float32)):
                for n, d, v in DRY_PLAN_SHAPES:
                    lib = _splits(device.index or 0, pass_, _DESIGN_CODES[design],
                                  _DTYPE_CODES[dtype], n, v, d)
                    ours = plan_splits(pass_, design, n, v, d, sms)
                    if lib != ours:
                        bad.append((pass_, design, str(dtype), n, d, v, lib, ours))
    log(f"dry-run: vocab-split plans against the library's: {len(bad)} differ {bad}")
    if bad:
        raise AssertionError(f"the meta route's split plan differs from the library's: {bad}")


def run_dryrun_phase(device) -> dict:
    """Phase 18: (a) the main path's step traced by the dry-run on an
    abstract data=1 mesh and then run on the card over a data=1 mesh of one
    NCCL rank (the same path): argument bytes equal to the real state's and
    batch's, each kernel's launches equal to one real step's, the peak
    within DRY_PEAK_TOL of ``max_memory_allocated``, the profiled busy time
    at least the roofline's larger term; (b) the DRY_RECORDS run whole and
    timed."""
    from repro_torch.launch.mesh import shutdown_distributed

    t_phase = time.perf_counter()
    check_split_plans(device)
    try:
        out = check_dryrun_main_path(device)
    finally:
        shutdown_distributed()
    out["records"] = check_dryrun_records()
    log(f"dry-run: phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return out


def check_dryrun_main_path(device) -> dict:
    """Phase 18 (a)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh, init_distributed
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.models.api import build_model
    from repro_torch.train.step import make_train_step

    model = build_model(get_config("bert-large"))
    shape = InputShape("main path", DRY_SEQ, DRY_BATCH, "train")
    allocated = torch.cuda.memory_allocated()
    rec = dryrun.trace(model, shape, abstract_mesh((1,), ("data",)), tc_kw=DRY_TC)
    if torch.cuda.memory_allocated() != allocated:
        raise AssertionError("the dry-run allocated on the card")
    mem, rl = rec["memory"], rec["roofline"]
    log(f"dry-run (a): traced in {rec['trace_s']:.2f} s: memory {json.dumps(mem)}, cost "
        f"{json.dumps(rec['cost'])}, kernels {json.dumps(rec['kernels'])}, collectives "
        f"{json.dumps(rec['collectives'])}; compute {rl['compute_s'] * 1e3:.3f} ms, memory "
        f"{rl['memory_s'] * 1e3:.3f} ms, collective {rl['collective_s'] * 1e3:.4f} ms")

    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, **DRY_TC)
    mesh, dev = init_distributed(device, "data=1")
    init_fn, step_fn = make_train_step(model, tc, mesh=mesh)
    state = init_fn(0, dev)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in
             make_batch(model.cfg, np.random.default_rng(0), DRY_BATCH, DRY_SEQ).items()}
    real_args = _tensor_bytes(state) + _tensor_bytes(batch)
    log(f"dry-run (a): argument bytes {mem['argument_size_in_bytes']}, the real state and "
        f"batch {real_args}")
    if mem["argument_size_in_bytes"] != real_args:
        raise AssertionError("the dry-run's argument bytes differ from the real state's "
                             "and batch's")
    reset_launches()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in KERNELS}
    traced = {k: rec["kernels"].get(k, {}).get("launches", 0) for k in KERNELS}
    log(f"dry-run (a): launches of one real step {launches}, traced {traced}")
    if launches != traced or launches != DRY_LAUNCHES:
        raise AssertionError(f"launches: real {launches}, traced {traced}, want {DRY_LAUNCHES}")
    del metrics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    off = mem["peak_memory_in_bytes"] / peak - 1
    log(f"dry-run (a): peak {mem['peak_memory_in_bytes'] / 2**30:.3f} GiB traced, "
        f"max_memory_allocated over one step {peak / 2**30:.3f} GiB ({off:+.2%})")
    if abs(off) > DRY_PEAK_TOL:
        raise AssertionError(f"the traced peak is {off:+.1%} off the card's")
    del metrics

    def step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        return metrics

    t = _profile_calls(step, n=5)
    busy, wall = t["busy_ms"] * 1e-3, t["wall_ms"] * 1e-3
    bound = max(rl["compute_s"], rl["memory_s"])
    mf = model_flops("train", model.active_param_count(), DRY_BATCH * DRY_SEQ)
    out = dict(trace_s=rec["trace_s"], memory=mem, cost=rec["cost"], kernels=rec["kernels"],
               real_peak=peak, peak_off=off, busy_ms=t["busy_ms"], wall_ms=t["wall_ms"],
               span_ms=t["span_ms"], launches=t["launches"], bound_ms=bound * 1e3,
               roofline_share=bound / busy, model_flops=mf,
               mfu_busy=mf / (busy * PEAK_FLOPS), mfu_wall=mf / (wall * PEAK_FLOPS))
    log(f"dry-run (a): busy {t['busy_ms']:.3f} ms in {t['launches']} launches, wall "
        f"{t['wall_ms']:.3f} ms, span {t['span_ms']:.3f} ms; roofline max(compute, memory) "
        f"{bound * 1e3:.3f} ms, share of busy {bound / busy:.4f}; model flops {mf:.4e}: "
        f"{out['mfu_busy']:.4f} of peak over busy, {out['mfu_wall']:.4f} over wall")
    if busy < bound:
        raise AssertionError(f"busy {busy * 1e3:.3f} ms below the roofline's {bound * 1e3:.3f}")
    del state, batch
    torch.cuda.empty_cache()
    return out


def check_dryrun_records() -> dict:
    """Phase 18 (b): each of DRY_RECORDS run whole (meta, on the host),
    timed; ``{record: seconds}``."""
    from repro_torch.launch import dryrun

    out = {}
    for arch, shape_name in DRY_RECORDS:
        t0 = time.perf_counter()
        r = dryrun.run_dryrun(arch, shape_name)
        wall_s = time.perf_counter() - t0
        log(f"dry-run (b) {arch} x {shape_name} x {r['mesh']} in {wall_s:.2f} s: "
            + json.dumps(r))
        rl = r.get("roofline", {})
        if r["status"] != "ok" or r["devices"] != 256 or not rl.get("memory_s", 0) > 0 \
                or not r["cost"]["flops"] > 0:
            raise AssertionError(f"dry-run (b): {arch} x {shape_name}: {r.get('status')}")
        out[f"{arch} x {shape_name}"] = dict(wall_s=wall_s, trace_s=r["trace_s"])
    return out


# ---------------------------------------------------------------------------
# phase 19: serving on a mesh
# ---------------------------------------------------------------------------

# (a) granite-moe-1b-a400m's 16 heads over 8 kv heads as four model ranks (2
# kv heads a rank's cache); (b) smollm-360m at batch 1 with its cache's
# sequence over four data ranks; (c) the layers with state as model ranks
MESH_SERVE_RANKS = 4
MESH_SERVE_PROMPT, MESH_SERVE_NEW = 128, 16
MESH_SERVE_MAX_LEN = MESH_SERVE_PROMPT + MESH_SERVE_NEW + 8
LONG_ARCH, LONG_RANKS, LONG_PROMPT, LONG_MAX_LEN, LONG_NEW = "smollm-360m", 4, 32000, 32768, 16
# (b)'s fp32 check: the prompt's first 8,000 tokens in an 8,192-position
# cache (2,048 a rank, the prompt in every rank's block); fp32 attention over
# the whole 32,000 costs five fp32 prefills on one card, some 20 s
LONG_LOCAL = (8000, 8192)
STATE_STEPS = 8
MESH_FACTOR = 3.0   # a rank's distance from fp32 against the whole bf16 call's
# fp32 at full depth, each block fed the whole run's input: a block's output
# within LOCAL_TOL of the size of the whole block's update (sums in another
# order), and where the ranks' own top-k set of a token differs from the
# whole run's (the whole run's set is kept), the whole run's gap between its
# k-th and (k+1)-th router probability within FLIP_GAP (a tie at rounding)
LOCAL_TOL, FLIP_GAP = 1e-4, 1e-5
LOCAL_STEPS = 4     # the decode steps of that check
K3_RANK_TIMING = [("serving model=4 rank", 8, 4, 2, 128, 64, True)]


def _rank_engines(device, model, params, sizes, axis, fn, rules=None, max_len=None,
                  probe=None):
    """``fn(engine)`` for each rank of the mesh ``sizes``, a thread each of
    ``run_plain_ranks`` whose group is the mesh's ``axis``: each rank's
    ``Engine(shard_ctx=)`` holds its parameter blocks and its cache block;
    ``probe`` (a :class:`_BlockProbe`) is told which rank each thread runs.
    Returns every rank's result and the ranks' wall seconds."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve import Engine
    from repro_torch.sharding import ShardCtx
    from repro_torch.sharding import collectives as C

    def rank(group):
        torch.cuda.set_device(device.index or 0)   # a new thread has no current context
        if probe is not None:
            probe.enter(group.index)
        mesh = Mesh(sizes, rank=group.index, groups={(axis,): group})
        ctx = ShardCtx(mesh).with_rules(**(rules or {}))
        return fn(Engine(model, params, max_len=max_len, shard_ctx=ctx))

    t0 = time.perf_counter()
    out = C.run_plain_ranks(rank, sizes[axis])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _parted(label, top2, whole_tokens, tokens) -> list:
    """Where a sequence parts from the whole run's, the whole run's top-2
    margin at that step against phase 10's rule (MARGIN_ULPS bf16 ulps of
    the top logit).  Returns the requests that part at a larger margin
    (logged with every parting)."""
    faults, parts = [], []
    for i in range(len(tokens)):
        if (tokens[i] == whole_tokens[i]).all():
            continue
        t = int((tokens[i] != whole_tokens[i]).argmax())
        limit = MARGIN_ULPS * _top_ulp(top2[i, t, 0])
        margin = top2[i, t, 0] - top2[i, t, 1]
        parts.append(f"request {i} at step {t}: margin {margin:.4g} (tol {limit:.4g})")
        if margin > limit:
            faults.append(i)
    log(f"serve mesh {label}: identical token sequences "
        f"{sum((a == b).all() for a, b in zip(tokens, whole_tokens))} of {len(tokens)}; "
        f"parted: {parts or 'none'}")
    return faults


def _whole_run(model, params, toks, reqs, max_len, new):
    """The whole model's greedy tokens, the top-2 logits of each step and
    the first decode step's logits (a replay of its own tokens), the wall
    seconds of the run and its cache bytes."""
    import numpy as np

    from repro_torch.serve import Engine

    whole = Engine(model, params, max_len=max_len)
    t0 = time.perf_counter()
    st = np.stack([r.out_tokens for r in whole.generate_batch(reqs())])
    wall = time.perf_counter() - t0
    rep = whole.replay(toks, st[:, :new - 1])
    return st, rep.topk(2, -1).values.cpu().numpy(), rep[:, 1], wall, whole.cache_bytes


class _BlockProbe:
    """Each transformer block's input and output, and each MoE layer's top-k
    set, of a whole-model run, and the ranks' blocks held to them.

    Installed over ``transformer._one_block`` and ``moe.route`` (the module
    globals the layers call).  ``mode`` "record": the whole run (the calling
    thread, no :meth:`enter`) keeps every block call's input and output, and
    every route call's expert ids and the gap between the k-th and (k+1)-th
    router probability.  "force": each rank's n-th block call takes the whole
    run's n-th input, its output is held to the whole's n-th output relative
    to the size of the whole block's update, and its n-th route call keeps the
    whole run's expert set, the gates from its own logits (a token whose own
    set differs logs the whole run's gap); where a rank computes fewer rows
    than the whole run (a decode step over its rows of a slot pool), its
    rows are the ``block``-th block of the whole's that :meth:`enter`
    names.  "free": rank 0's block outputs
    against the whole's relative to the whole's, and each route call's tokens
    whose set differs (nothing forced).  "perturb": a whole run again with the
    embeddings scaled by 1 ± 2^-24 (a rounding-size change) and the whole
    run's expert sets, its block outputs against the first's.  Readings stay
    on the device until :meth:`read`."""

    def __init__(self, mode="record"):
        import threading

        self.mode, self.local = mode, threading.local()
        self.w_in, self.w_out, self.w_idx, self.w_gap = [], [], [], []
        self.errs, self.flips = {}, {}

    def enter(self, rank, block=0):
        self.local.rank, self.local.block, self.local.nb, self.local.nr = rank, block, 0, 0
        self.errs[rank], self.flips[rank] = [], []

    def _mine(self, w, rows):
        """The whole run's ``w`` at this rank's ``rows`` rows."""
        if w.shape[0] == rows:
            return w
        b = getattr(self.local, "block", 0)
        return w[b * rows:(b + 1) * rows]

    def read(self):
        """``{rank: (block errors, differing sets by route call, the whole
        run's gaps there)}``."""
        return {r: ([float(e) for e in self.errs[r]],
                    [int(d.sum()) for d, _ in self.flips[r]],
                    [g for d, gap in self.flips[r] for g in gap[d].tolist()])
                for r in self.errs}

    def _next(self, counter):
        n = getattr(self.local, counter, 0)
        setattr(self.local, counter, n + 1)
        return n

    def block(self, real):
        def probed(bp, x, positions, cfg, **kw):
            rank = getattr(self.local, "rank", None)
            n = self._next("nb")
            if self.mode == "record":
                out, aux = real(bp, x, positions, cfg, **kw)
                self.w_in.append(x.float())
                self.w_out.append(out.float())
                return out, aux
            w_in, want = self.w_in[n], self.w_out[n]
            if self.mode == "force":
                w_in, want = self._mine(w_in, x.shape[0]), self._mine(want, x.shape[0])
                if x.shape != w_in.shape:
                    raise AssertionError(f"block call {n}: rank {rank}'s input "
                                         f"{tuple(x.shape)}, the whole's "
                                         f"{tuple(self.w_in[n].shape)}")
                x = w_in.to(x.dtype)
            out, aux = real(bp, x, positions, cfg, **kw)
            scale = (want - w_in) if self.mode == "force" else want
            if rank in (None, 0) or self.mode == "force":
                self.errs[rank].append((out.float() - want).abs().max() / scale.abs().max())
            return out, aux
        return probed

    def route(self, real):
        import torch

        def probed(logits, cfg, dp=None):
            gates, idx, aux = real(logits, cfg, dp)
            rank = getattr(self.local, "rank", None)
            n = self._next("nr")
            probs = torch.softmax(logits, -1)
            if self.mode == "record":
                top = torch.topk(probs, cfg.n_experts_per_tok + 1, -1).values
                self.w_idx.append(idx)
                self.w_gap.append(top[:, -2] - top[:, -1])
                return gates, idx, aux
            want = self._mine(self.w_idx[n], idx.shape[0])
            differ = (idx.sort(-1).values != want.sort(-1).values).any(-1)
            self.flips[rank].append((differ, self._mine(self.w_gap[n], idx.shape[0])))
            if self.mode == "free":
                return gates, idx, aux
            g = probs.gather(1, want)
            return g / g.sum(-1, keepdim=True), want, aux
        return probed

    def embed(self, real):
        import torch

        def probed(params, batch, cfg, dtype):
            x = real(params, batch, cfg, dtype)
            sign = torch.arange(x.numel(), device=x.device).view(x.shape) % 2 * 2 - 1
            return x * (1 + sign.to(x.dtype) * 2.0 ** -24)
        return probed

    def installed(self):
        import contextlib

        from repro_torch.models import transformer
        from repro_torch.models.layers import moe

        @contextlib.contextmanager
        def patch():
            saved = transformer._one_block, moe.route, transformer._embed_inputs
            transformer._one_block = self.block(saved[0])
            moe.route = self.route(saved[1])
            if self.mode == "perturb":
                transformer._embed_inputs = self.embed(saved[2])
            try:
                yield self
            finally:
                transformer._one_block, moe.route, transformer._embed_inputs = saved
        return patch()

    def moved(self, mode):
        """A probe of ``mode`` over this one's whole-run record."""
        other = _BlockProbe(mode)
        other.w_in, other.w_out, other.w_idx, other.w_gap = \
            self.w_in, self.w_out, self.w_idx, self.w_gap
        return other


def _mesh_against_whole(label, device, model, params, prompts, sizes, axis, rules=None,
                        max_len=None, new=MESH_SERVE_NEW, held=None, diagnose=False,
                        local_len=None):
    """One mesh's greedy run against the whole model's.

    bf16 (the path the K3 launches count, ``held`` wrapping each K3 call
    there if given): the first decode step's gathered logits (the whole
    run's first token teacher-forced) within MESH_FACTOR times the whole
    bf16 call's distance from fp32; its tokens are logged by phase 10's
    rule.  fp32 at full depth, every block fed the whole run's input
    (:class:`_BlockProbe` "force", the prefill and LOCAL_STEPS decode steps
    teacher-forced with the whole bf16 run's tokens): every block call of
    every rank within LOCAL_TOL, every kept top-k set a tie within
    FLIP_GAP, the gathered logits of each step within LOCAL_TOL of their
    size, and where a step's argmax differs from the whole's the whole's
    top-2 margin within LOCAL_TOL of its top logit (``local_len`` (prompt
    positions, max_len), if given, cuts the prompts and the cache of that
    check).  With ``diagnose``, the
    fp32 ranks' free prefill and the whole one perturbed at rounding size
    (:class:`_BlockProbe` "free" and "perturb") are logged: how far a
    rounding difference grows over the depth.  Every rank's tokens equal.
    Returns the launches, the ranks' and the whole cache bytes, the
    distances and the wall seconds."""
    import numpy as np
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention
    from repro_torch.serve import Engine, Request

    toks = np.stack(prompts)
    reqs = lambda: [Request(p, max_new_tokens=new) for p in prompts]   # noqa: E731

    def ranks(m, fn, probe=None):
        return _rank_engines(device, m, params, sizes, axis, fn, rules, max_len, probe)

    def tokens_of(e):
        return np.stack([r.out_tokens for r in e.generate_batch(reqs())]), e.cache_bytes

    # bf16, full depth
    st, top2, whole_first, t_whole, whole_bytes = _whole_run(model, params, toks, reqs,
                                                             max_len, new)
    torch.cuda.synchronize()
    reset_launches()
    real = attention.flash_sdpa
    if held is not None:
        attention.flash_sdpa = held
    try:
        got, wall = ranks(model, tokens_of)
    finally:
        attention.flash_sdpa = real
    launches, designs, _ = _counts()
    if any(not (g[0] == got[0][0]).all() for g in got):
        raise AssertionError(f"serve mesh {label}: the ranks' tokens differ")
    mt = got[0][0]
    parted = _parted(f"{label} bf16, by phase 10's rule (logged)", top2, st, mt)
    mesh_first = ranks(model, lambda e: e.replay(toks, st[:, :1])[:, 1])[0][0]
    torch.cuda.empty_cache()

    # fp32, full depth, each block on the whole run's input (the whole run's
    # first decode step also the bf16 rule's fp32 reference at the same
    # prompts)
    f32 = build_model(model.cfg.replace(activation_dtype="float32"))
    forced = st[:, :LOCAL_STEPS]
    if local_len is not None:
        ref_first = Engine(f32, params, max_len=max_len).replay(toks, st[:, :1])[:, 1]
        toks, max_len = toks[:, :local_len[0]], local_len[1]
    rec = _BlockProbe()
    with torch.no_grad(), rec.installed():
        w_logits = Engine(f32, params, max_len=max_len).replay(toks, forced)
    if local_len is None:
        ref_first = w_logits[:, 1]
    d_mesh = float((mesh_first - ref_first).abs().max())
    d_whole = float((whole_first - ref_first).abs().max())
    del mesh_first, whole_first, ref_first
    force = rec.moved("force")
    t0 = time.perf_counter()
    with force.installed():
        f_logits = ranks(f32, lambda e: e.replay(toks, forced), force)[0]
    readings = force.read()
    t_force = time.perf_counter() - t0
    size = w_logits.abs().amax(-1)
    top = w_logits.topk(2, -1).values
    step_err, faults = [], []
    for r, lg in enumerate(f_logits):
        step_err.append(float(((lg - w_logits).abs().amax(-1) / size).max()))
        moved = lg.argmax(-1) != w_logits.argmax(-1)
        margin = (top[..., 0] - top[..., 1]) / size
        if moved.any() and float(margin[moved].max()) > LOCAL_TOL:
            faults.append(f"rank {r}: an argmax moved at margin {float(margin[moved].max()):.3g}")
    block_err = max(max(e) for e, _, _ in readings.values())
    gaps = [g for _, _, v in readings.values() for g in v]
    n_flips = sum(sum(f) for _, f, _ in readings.values())
    depth = len(readings[0][0]) // (forced.shape[1] + 1)
    per_layer = [max(e[i] for e, _, _ in readings.values()) for i in range(len(readings[0][0]))]
    log(f"serve mesh {label} fp32 at full depth, each block fed the whole run's input "
        f"({len(per_layer)} block calls a rank, {len(prompts)} rows, a prompt of "
        f"{toks.shape[1]} in a cache of {max_len}, the prefill and "
        f"{forced.shape[1]} decode steps; {t_force:.2f} s): a block's output against the "
        f"whole's, over the whole block's update, max {block_err:.3g} (tol {LOCAL_TOL}); "
        f"the prefill's by layer {[float(f'{e:.3g}') for e in per_layer[:depth]]}, the "
        f"decode steps' max {max(per_layer[depth:]):.3g}; "
        f"the gathered logits of each step max {max(step_err):.3g} of "
        f"their size; top-k sets of a token that differed from the whole run's {n_flips}, "
        f"the whole run's k-th to (k+1)-th gap there max "
        f"{max(gaps) if gaps else None} (tol {FLIP_GAP}); {faults or 'no argmax moved'}")
    if block_err > LOCAL_TOL or max(step_err) > LOCAL_TOL or faults \
            or (gaps and max(gaps) > FLIP_GAP):
        raise AssertionError(f"serve mesh {label}: fp32 blocks on the whole run's inputs left "
                             f"it: block {block_err}, logits {max(step_err)}, flips at gaps "
                             f"{sorted(gaps)[-4:]}, {faults}")
    del f_logits
    torch.cuda.empty_cache()

    diag = None
    if diagnose:   # the prefill alone
        none = forced[:, :0]
        free = rec.moved("free")
        with free.installed():
            fr_logits = ranks(f32, lambda e: e.replay(toks, none), free)[0][0]
        pert = rec.moved("perturb")
        pert.enter(None)
        with torch.no_grad(), pert.installed():
            p_logits = Engine(f32, params, max_len=max_len).replay(toks, none)
        w_logits, size = w_logits[:, :1], size[:, :1]
        fr, pe = free.read()[0], pert.read()[None]

        diag = dict(
            free_prefill=[round(e, 7) for e in fr[0]], free_flips=fr[1],
            free_logits=float(((fr_logits - w_logits).abs().amax(-1) / size).max()),
            perturbed_prefill=[round(e, 7) for e in pe[0]],
            perturbed_logits=float(((p_logits - w_logits).abs().amax(-1) / size).max()))
        log(f"serve mesh {label} fp32 at full depth, free (rank 0's block outputs against "
            f"the whole's, over their size, and its tokens whose top-k set differs, by "
            f"prefill layer): {diag['free_prefill']}, flips {diag['free_flips']}, last "
            f"logits {diag['free_logits']:.3g} of their size; the whole model with its embeddings "
            f"scaled by 1 +- 2^-24 and the whole run's top-k sets: "
            f"{diag['perturbed_prefill']}, logits {diag['perturbed_logits']:.3g}")
        del fr_logits, p_logits
    del rec, force, w_logits
    torch.cuda.empty_cache()

    log(f"serve mesh {label}: whole bf16 run {t_whole:.2f} s, the ranks' run {wall:.2f} s; "
        f"first decode step's gathered bf16 logits, max |diff| from fp32: the ranks' "
        f"{d_mesh:.4g}, the whole bf16 call's {d_whole:.4g} (top logit {float(top2[:, 1, 0].max()):.4g}); "
        f"bf16 sequences parting at a margin past phase 10's rule {len(parted)} of "
        f"{len(prompts)}; cache bytes a rank {[g[1] for g in got]}, whole {whole_bytes}; K3 "
        f"launches in the bf16 ranks' run {launches['flash_fwd']} {designs['flash_fwd']}")
    if not d_mesh <= MESH_FACTOR * d_whole:
        raise AssertionError(f"serve mesh {label}: the mesh left the whole run: logits "
                             f"{d_mesh} against {d_whole}")
    return dict(launches=launches, designs=designs, rank_cache_bytes=[g[1] for g in got],
                whole_cache_bytes=whole_bytes, wall_s=wall, whole_s=t_whole, d_mesh=d_mesh,
                d_whole=d_whole, bf16_parted=len(parted), block_err=block_err,
                logits_err=max(step_err), kept_flips=n_flips, diagnosis=diag,
                bf16_identical=int(sum((a == b).all() for a, b in zip(mt, st))))


def check_mesh_model_ranks(device) -> dict:
    """(a) granite-moe-1b-a400m at full width (bf16, flash, fp32 params from
    seed 0) served by ``Engine(shard_ctx=)`` as four model ranks: 8 prompts
    of 128 tokens, 16 greedy tokens, against the whole-model Engine by
    :func:`_mesh_against_whole`; each rank's cache a quarter of the
    whole's (2 of the 8 kv heads); K3 launched 24 layers x 4 ranks times on
    the prefill, all on the tensor-core kernel, and each call held against
    its plain version on the same q, k and v by ``check_flash``'s bf16 rule
    (``check_serving_flash``'s)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention

    cfg = get_config(MOE_ARCH).replace(use_flash_kernel=True)
    model = build_model(cfg)
    params = model.init(0, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, min(cfg.vocab_size, 1024), size=MESH_SERVE_PROMPT)
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    real, errs = attention.flash_sdpa, []

    def held(q, k, v, **kw):
        o = real(q, k, v, **kw)
        ref = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              kw.get("kv_valid"), causal=kw["causal"], window=kw["window"],
                              plain=True).transpose(1, 2).float()
        atol = 1e-4 * max(1.0, float(ref.abs().max()))
        errs.append((bool(torch.allclose(o.float(), ref, rtol=1e-2, atol=atol)),
                     float((o.float() - ref).abs().max()), q.shape[2], k.shape[2]))
        return o

    m = MESH_SERVE_RANKS
    out = _mesh_against_whole("(a) granite-moe-1b model=4", device, model, params, prompts,
                              {"data": 1, "model": m}, "model", max_len=MESH_SERVE_MAX_LEN,
                              held=held, diagnose=True)
    idx = 4 * cfg.n_layers   # the (layers,) int32 index, whole on every rank
    want = {k: (MOE_LAYERS * m if k == "flash_fwd" else 0) for k in out["launches"]}
    heads = sorted({(e[2], e[3]) for e in errs})
    log(f"serve mesh (a): K3 in {len(errs)} rank calls (q heads, kv heads) {heads}, each "
        f"against its plain version: within rtol 1e-2 + 1e-4 of the scale "
        f"{sum(e[0] for e in errs)} of {len(errs)}, |o| diff max "
        f"{max(e[1] for e in errs):.3g}")
    if out["launches"] != want or out["designs"]["flash_fwd"] != {"mma": MOE_LAYERS * m, "fma": 0} \
            or len(errs) != MOE_LAYERS * m or not all(e[0] for e in errs) \
            or heads != [(cfg.n_heads // m, cfg.n_kv_heads // m)] \
            or any(m * (b - idx) != out["whole_cache_bytes"] - idx
                   for b in out["rank_cache_bytes"]):
        raise AssertionError(f"serve mesh (a): launches {out['launches']}, want {want}; "
                             f"cache bytes {out['rank_cache_bytes']}")
    del params
    torch.cuda.empty_cache()
    return out


def check_mesh_long_context(device) -> dict:
    """(b) smollm-360m at full width (bf16, flash) at batch 1: a 32,000-token
    prompt into a 32,768-position cache whose sequence is split over four
    data ranks (``cache_seq=("data",)``: 8,192 positions each, the prompt in
    every rank's block), then 16 greedy tokens, against the one-device
    Engine by :func:`_mesh_against_whole` (its fp32 block check at
    LONG_LOCAL); K3 once a layer a rank on the prefill.  Then the dry-run's
    ``smollm-360m x long_500k`` record on the
    256-rank mesh: ``ok``, its cache argument 1/16 of the whole cache."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.io import tree_leaves_with_paths
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import counting_mesh, make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import collectives as C

    cfg = get_config(LONG_ARCH).replace(use_flash_kernel=True)
    model = build_model(cfg)
    params = model.init(0, device)
    prompt = np.random.default_rng(19).integers(0, min(cfg.vocab_size, 1024), size=LONG_PROMPT
                                                ).astype(np.int32)
    out = _mesh_against_whole("(b) smollm-360m batch 1, cache_seq over data=4", device, model,
                              params, [prompt], {"data": LONG_RANKS, "model": 1}, "data",
                              rules={"cache_seq": ("data",)}, max_len=LONG_MAX_LEN,
                              new=LONG_NEW, local_len=LONG_LOCAL)
    idx = 4 * cfg.n_layers
    want = {k: (cfg.n_layers * LONG_RANKS if k == "flash_fwd" else 0) for k in out["launches"]}
    if out["launches"] != want or any(LONG_RANKS * (b - idx) != out["whole_cache_bytes"] - idx
                                      for b in out["rank_cache_bytes"]):
        raise AssertionError(f"serve mesh (b): launches {out['launches']}, want {want}; "
                             f"cache bytes {out['rank_cache_bytes']}")
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec = dryrun.run_dryrun(LONG_ARCH, "long_500k")
    shape = SHAPES["long_500k"]
    mesh = counting_mesh(make_production_mesh(), C.CollectiveTally())
    rules, _ = dryrun.dryrun_rules(mesh)
    _, args, _ = dryrun.call_for(model, shape, mesh, rules)
    whole = model.make_cache(shape.global_batch, shape.seq_len, "meta")

    def nbytes(tree, name):
        return sum(x.numel() * x.element_size() for p, x in tree_leaves_with_paths(tree)
                   if p.endswith(name))

    ratio = {n: nbytes(whole, n) / nbytes(args[1], n) for n in ("/k", "/v")}
    log(f"serve mesh (b) dry-run {LONG_ARCH} x long_500k x {rec['mesh']}: {rec['status']}, "
        f"{rec.get('devices')} ranks, argument bytes {rec['memory']['argument_size_in_bytes']}, "
        f"the whole cache's k and v over rank 0's {ratio}, in {time.perf_counter() - t0:.2f} s")
    if rec["status"] != "ok" or ratio != {"/k": 16.0, "/v": 16.0}:
        raise AssertionError(f"serve mesh (b): the long_500k record: {rec['status']}, {ratio}")
    out["dry_ratio"] = ratio
    return out


def _state_over_ranks(device, label, defs, serve, cfg, m, rules, fresh, xs, seed):
    """``serve(p, cfg, cache, xs) -> (outputs, final cache)`` (a prefill, then
    one decode step a further input) three ways: an fp32 run (the bf16
    weights and inputs upcast), the whole bf16 call, and its ``m`` model
    ranks, each the port's layer on its parameter blocks and its block of
    ``fresh(cfg, device)`` (the cache's specs under ``rules``) on a thread
    of ``run_plain_ranks``.  Every output and final cache leaf (the ranks'
    blocks side by side) within MESH_FACTOR times the whole call's distance
    from the fp32 run; returns the ranks' wall seconds."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardCtx, cache_block, cache_shardings, leaf_dims, \
        leaf_layout, specs_for, use_sharding
    from repro_torch.sharding import collectives as C

    weights = _layer_weights(defs, device, seed)
    f32 = cfg.replace(activation_dtype="float32")
    with torch.no_grad():
        ref = serve({k: v.float() for k, v in weights.items()}, f32, fresh(f32, device),
                    [x.float() for x in xs])
        whole = serve(weights, cfg, fresh(cfg, device), xs)
    sizes = {"data": 1, "model": m}
    specs = specs_for(defs, Mesh(sizes))
    dims = {k: leaf_layout(sp, Mesh(sizes)).model for k, sp in specs.items()}
    stacked = {k: v[None] for k, v in fresh(cfg, "meta").items()}
    lays = leaf_dims(cache_shardings(stacked, Mesh(sizes), rules), Mesh(sizes))

    def rank(group):
        torch.cuda.set_device(device.index or 0)
        mesh = Mesh(sizes, rank=group.index, groups={("model",): group})
        block = {k: C.shard_leaf(v, dims[k], m, group.index) for k, v in weights.items()}
        cache = {k: v[0] for k, v in cache_block(stacked, mesh, rules, device).items()}
        with torch.no_grad(), use_sharding(ShardCtx(mesh, rules, specs)):
            return serve(block, cfg, cache, xs)

    t0 = time.perf_counter()
    got = C.run_plain_ranks(rank, m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gaps = {}
    for i, (a, w, r) in enumerate(zip(got[0][0], whole[0], ref[0])):
        gaps[f"out{i}"] = (float((a.float() - r).abs().max()), float((w.float() - r).abs().max()))
    for k, r in ref[1].items():
        a = C.gather_leaf_plain([g[1][k][None] for g in got], lays[k].model)[0]
        gaps[k] = (float((a.float() - r.float()).abs().max()),
                   float((whole[1][k].float() - r.float()).abs().max()))
    log(f"serve mesh (c) {label}: over model={m} ranks, max |diff| from the fp32 run, the "
        f"ranks' / the whole bf16 call's: "
        + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in gaps.items())
        + f"; the ranks' {len(xs)} calls {wall:.2f} s wall")
    far = {k: v for k, v in gaps.items() if not v[0] <= MESH_FACTOR * v[1]}
    if far:
        raise AssertionError(f"serve mesh (c) {label}: the ranks left the whole call: {far}")
    del ref, whole, got, weights
    torch.cuda.empty_cache()
    return wall


def check_mesh_state_layers(device) -> dict:
    """(c) The layers with state at full width (bf16) as model ranks, a
    prefill then STATE_STEPS decode steps: deepseek-v3's MLA (d 7168, 128
    heads, kv_lora 512) as eight ranks of 16 heads, naive and absorbed, B 2,
    prefill 512 (the latent cache whole on every rank); xlstm-350m's mLSTM
    and sLSTM blocks as two ranks (2 heads each), B 4, prefill 256; Jamba's
    Mamba layer (d 8192, d_inner 16384) as four ranks under the dry-run's
    ``inner`` rule (a rank's 4096 of d_inner in its state), B 1, prefill
    256."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import mamba, mla, xlstm
    from repro_torch.sharding import default_act_rules

    gen = torch.Generator(device=device).manual_seed(191)
    rules = default_act_rules()

    def inputs(b, s, d):
        return [torch.randn((b, n, d), generator=gen, device=device).to(torch.bfloat16)
                for n in [s] + [1] * STATE_STEPS]

    def recurrent(fn):
        def serve(p, c, cache, xs):
            outs = []
            for i, x in enumerate(xs):
                y, cache = fn(p, x, c, state=cache, decode=i > 0)
                outs.append(y)
            return outs, cache
        return serve

    def mla_serve(p, c, cache, xs):
        outs, start = [], 0
        for i, x in enumerate(xs):
            b, s = x.shape[:2]
            pos = torch.arange(start, start + s, device=x.device)[None].expand(b, s)
            outs.append(mla.mla_attention(p, x, pos, c, cache=cache, decode=i > 0))
            start += s
        return outs, cache

    def dtype_of(c):
        return torch.float32 if c.activation_dtype == "float32" else torch.bfloat16

    walls = {}
    base = get_config("deepseek-v3-671b")
    xs = inputs(MLA_B, MLA_S, base.d_model)
    for name, absorb in (("naive", False), ("absorbed", True)):
        cfg = base.replace(mla_absorb=absorb)
        walls[f"MLA {name}"] = _state_over_ranks(
            device, f"deepseek-v3 MLA {name}", mla.mla_defs(cfg), mla_serve, cfg, MLA_RANKS,
            rules, lambda c, d: mla.init_mla_cache(MLA_B, MLA_S + STATE_STEPS, c, dtype_of(c), d),
            xs, 192)
    xcfg = get_config(XLSTM_ARCH)
    xs = inputs(XLSTM_B, XLSTM_S, xcfg.d_model)
    walls["mLSTM"] = _state_over_ranks(
        device, "xlstm-350m mLSTM", xlstm.mlstm_defs(xcfg), recurrent(xlstm.mlstm_block), xcfg,
        XLSTM_RANKS, rules, lambda c, d: xlstm.init_mlstm_state(XLSTM_B, c, d), xs, 193)
    walls["sLSTM"] = _state_over_ranks(
        device, "xlstm-350m sLSTM", xlstm.slstm_defs(xcfg), recurrent(xlstm.slstm_block), xcfg,
        XLSTM_RANKS, rules, lambda c, d: xlstm.init_slstm_state(XLSTM_B, c, d), xs, 194)
    jcfg = get_config("jamba-1.5-large-398b")
    xs = inputs(MAMBA_B, MAMBA_S, jcfg.d_model)
    walls["Mamba"] = _state_over_ranks(
        device, "Jamba Mamba", mamba.mamba_defs(jcfg), recurrent(mamba.mamba), jcfg,
        MAMBA_RANKS, dict(rules, inner=("model",)),
        lambda c, d: mamba.init_mamba_state(MAMBA_B, c, dtype_of(c), d), xs, 195)
    return walls


def run_serve_mesh(device, rate: float) -> dict:
    """Phase 19; returns (a)'s and (b)'s numbers, (c)'s walls and (d)'s K3
    times on a model=4 rank's heads at (a)'s prefill shape."""
    t0 = time.perf_counter()
    out = {"model": check_mesh_model_ranks(device)}
    out["long"] = check_mesh_long_context(device)
    out["state"] = check_mesh_state_layers(device)
    out["k3"] = time_flash(device, rate, K3_RANK_TIMING, every=True)[K3_RANK_TIMING[0][0]]
    log(f"serve mesh: phase 19 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the continuous engine on a mesh
# ---------------------------------------------------------------------------

CONT_MESH = {"data": 2, "model": 2}
# granite-moe-1b's full width cut to 6 of its 24 layers: four thread ranks
# on one card run host-serial, a decode step about four whole steps (1.2 s
# at 24 layers, 0.4-0.55 s at 8), and phase 20 keeps within its minute
CONT_LAYERS = 6
CONT_SLOTS, CONT_MAX_LEN, CONT_REQUESTS, CONT_NEW = 8, 256, 16, 16
CONT_PROMPTS = (32, 128)   # prompt lengths drawn from [32, 128]
# the watchdog's SLO: CONT_SLO_FACTOR times the slowest of the mesh's warm
# decode steps past the first (four thread ranks on one card run
# host-serial, a step about four whole steps); the stall at CONT_STALL_STEP
# CONT_STALL_FACTOR times the SLO
CONT_WARM_NEW, CONT_SLO_FACTOR, CONT_STALL_FACTOR, CONT_STALL_STEP = 4, 3.0, 1.25, 6
# (a)'s fp32 check: 4 requests through a 4-slot pool (2 slots a data rank,
# admitted two a loop iteration, so both data ranks' rows run), 3 tokens each
FORCED_SLOTS, FORCED_NEW = 4, 3
CONT_QUARANTINE = 4
DRAIN_REQUESTS, DRAIN_POLL = 8, 3
SEQ_RANKS, SEQ_MAX_LEN, SEQ_PROMPT, SEQ_NEW = 4, 16384, 16000, 8
# (c)'s fp32 check: the prompt's first 2,047 tokens in a 4,096-position
# cache (1,024 a rank), FORCED_NEW tokens, so the two decode steps write
# position 2,047 in rank 1's block and 2,048 in rank 2's
SEQ_LOCAL = (2047, 4096)
K3_CONT_TIMING = [("continuous model=2 rank", 1, 8, 4, 128, 64, True)]


class _GatheredLogits:
    """The first ``keep`` results of ``continuous.gather_logits`` on each
    thread (each call's gathered (rows, V) logits, in fp32), by the rank
    :meth:`enter` told it runs (None: a thread it was not told of, the
    whole engine's)."""

    def __init__(self, keep: int):
        import threading

        self.keep, self.local, self.calls = keep, threading.local(), {}

    def enter(self, rank: int, block: int = 0) -> None:
        self.local.rank = rank

    def installed(self):
        import contextlib

        from repro_torch.serve import continuous

        real = continuous.gather_logits

        def recorded(last, ctx, vocab):
            out = real(last, ctx, vocab)
            calls = self.calls.setdefault(getattr(self.local, "rank", None), [])
            if len(calls) < self.keep:
                calls.append(out.float().clone())
            return out

        @contextlib.contextmanager
        def patch():
            continuous.gather_logits = recorded
            try:
                yield self
            finally:
                continuous.gather_logits = real
        return patch()


def _cont_ranks(device, sizes, fn, probes=()):
    """``fn(mesh)`` on each rank of ``sizes``, a thread each of
    ``run_plain_mesh``, each of ``probes`` told the rank and its index over
    the data-parallel axes; returns the ranks' results and the wall
    seconds."""
    import torch

    from repro_torch.launch.mesh import run_plain_mesh
    from repro_torch.sharding.axes import batch_axes

    def rank(mesh):
        torch.cuda.set_device(device.index or 0)   # a new thread has no current context
        for probe in probes:
            probe.enter(mesh.rank, mesh.index(batch_axes(mesh)))
        return fn(mesh)

    t0 = time.perf_counter()
    out = run_plain_mesh(rank, sizes, timeout=600)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _outcome(reqs) -> list:
    return [(r.status.value, r.attempts, r.shed_reason or r.fail_reason,
             tuple(int(t) for t in r.out_tokens)) for r in reqs]


def _stats(events) -> dict:
    stats = [e for e in events if e["event"] == "serve_stats"][-1]
    return {k: stats[k] for k in ("submitted", "completed", "shed", "timed_out", "failed",
                                  "retries", "quarantines", "degraded", "decode_steps")}


def _from_fp32(label, model, params, prompt, forced, got, max_len) -> tuple:
    """(the ranks' logits' max |diff| from an fp32 run, the whole bf16
    call's): the whole model's logits after the prefill of ``prompt`` and
    each token of ``forced`` (teacher-forced, the static Engine), the last
    of them against ``got``; raises past MESH_FACTOR times."""
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.serve import Engine

    toks, forced = np.asarray(prompt, np.int32)[None], np.asarray(forced, np.int32)[None]
    whole = Engine(model, params, max_len=max_len).replay(toks, forced)[:, -1]
    f32 = build_model(model.cfg.replace(activation_dtype="float32"))
    ref = Engine(f32, params, max_len=max_len).replay(toks, forced)[:, -1]
    d_mesh = float((got - ref).abs().max())
    d_whole = float((whole - ref).abs().max())
    log(f"continuous mesh {label}: gathered bf16 logits, max |diff| from fp32: the ranks' "
        f"{d_mesh:.4g}, the whole bf16 call's {d_whole:.4g} (top logit "
        f"{float(ref.abs().max()):.4g}; rule {MESH_FACTOR}x)")
    if not d_mesh <= MESH_FACTOR * d_whole:
        raise AssertionError(f"continuous mesh {label}: the ranks left the whole run: "
                             f"{d_mesh} against {d_whole}")
    return d_mesh, d_whole


def _continuous_forced(label, device, model, params, specs, sizes, n_slots, max_len,
                       rules=None) -> dict:
    """The fp32 ``ContinuousEngine`` over the mesh ``sizes`` against the
    whole model's, on ``specs`` (``[(prompt, max_new_tokens)]``, greedy,
    every arrival at 0), each block of each rank fed the whole run's input
    and kept to its top-k sets (:class:`_BlockProbe` "force"; a decode
    step's rows the rank's block of the whole step's): every block call
    within LOCAL_TOL of the whole block's update, every kept set that
    differs a tie within FLIP_GAP, every gathered logits call (each
    admission's prefill, each decode step's (n_slots, V)) within LOCAL_TOL
    of its size, and where an argmax moved, the whole's top-2 margin within
    LOCAL_TOL of its size; then each rank's pool (its k/v or state block,
    the index whole) within LOCAL_TOL of its block of the whole engine's,
    every position ever written included.  Returns the errors, the calls
    and the seconds."""
    import torch

    from repro_torch.checkpoint.io import tree_leaves_with_paths
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine, ServeRequest
    from repro_torch.sharding import ShardCtx, cache_shardings, leaf_dims
    from repro_torch.sharding.collectives import shard_block

    f32 = build_model(model.cfg.replace(activation_dtype="float32"))

    def run(ctx=None):
        eng = ContinuousEngine(f32, params, n_slots=n_slots, max_len=max_len, shard_ctx=ctx)
        eng.generate([ServeRequest(p, max_new_tokens=n, rid=i) for i, (p, n) in enumerate(specs)])
        return eng.pool

    rec, logits = _BlockProbe(), _GatheredLogits(1 << 20)
    with torch.no_grad(), rec.installed(), logits.installed():
        whole_pool = dict(tree_leaves_with_paths(run().cache))
    meta = f32.make_cache(n_slots, max_len, "meta")

    def rank(mesh):
        """This rank's pool against its block of the whole engine's: the
        largest leaf difference over the whole leaf's size."""
        pool = run(ShardCtx(mesh).with_rules(**(rules or {})))
        lays = leaf_dims(cache_shardings(meta, mesh, pool.ctx.act_rules), mesh)
        err = 0.0
        for path, leaf in tree_leaves_with_paths(pool.cache):
            want = whole_pool[path]
            if path.endswith("/index"):
                err = max(err, float(not torch.equal(leaf, want)))
                continue
            want = shard_block(want, lays[path], mesh)
            size = float(want.abs().max()) or 1.0
            err = max(err, float((leaf.float() - want.float()).abs().max()) / size)
        return err

    force = rec.moved("force")
    t0 = time.perf_counter()
    with force.installed(), logits.installed():
        pool_err = max(_cont_ranks(device, sizes, rank, (force, logits))[0])
    t_force = time.perf_counter() - t0
    readings = force.read()
    whole = logits.calls.pop(None)
    step_err, faults = [], []
    for r, got in sorted(logits.calls.items()):
        if len(got) != len(whole):
            raise AssertionError(f"continuous mesh {label}: rank {r} gathered {len(got)} "
                                 f"logits, the whole engine {len(whole)}")
        for i, (g, w) in enumerate(zip(got, whole)):
            size = w.abs().amax(-1)
            step_err.append(float(((g - w).abs().amax(-1) / size).max()))
            top = w.topk(2, -1).values
            moved = g.argmax(-1) != w.argmax(-1)
            margin = (top[:, 0] - top[:, 1]) / size
            if moved.any() and float(margin[moved].max()) > LOCAL_TOL:
                faults.append(f"rank {r} call {i}: an argmax moved at margin "
                              f"{float(margin[moved].max()):.3g}")
    block_err = max(max(e) for e, _, _ in readings.values())
    gaps = [g for _, _, v in readings.values() for g in v]
    n_flips = sum(sum(f) for _, f, _ in readings.values())
    log(f"continuous mesh {label} fp32, each block fed the whole engine's input "
        f"({len(readings[0][0])} block calls a rank, {len(whole)} gathered logits calls, "
        f"{t_force:.2f} s): a block's output against the whole's, over the whole block's "
        f"update, max {block_err:.3g} (tol {LOCAL_TOL}); the gathered logits max "
        f"{max(step_err):.3g} of their size; top-k sets of a token that differed from the "
        f"whole run's {n_flips}, the whole run's k-th to (k+1)-th gap there max "
        f"{max(gaps) if gaps else None} (tol {FLIP_GAP}); {faults or 'no argmax moved'}; "
        f"a rank's pool against its block of the whole's, max {pool_err:.3g} of its size")
    if block_err > LOCAL_TOL or max(step_err) > LOCAL_TOL or faults \
            or (gaps and max(gaps) > FLIP_GAP) or pool_err > LOCAL_TOL:
        raise AssertionError(f"continuous mesh {label}: fp32 blocks on the whole engine's "
                             f"inputs left it: block {block_err}, logits {max(step_err)}, "
                             f"pool {pool_err}, flips at gaps {sorted(gaps)[-4:]}, {faults}")
    del rec, force, logits, whole, whole_pool
    torch.cuda.empty_cache()
    return dict(block_err=block_err, logits_err=max(step_err), pool_err=pool_err,
                kept_flips=n_flips, block_calls=len(readings[0][0]), s=t_force)


def check_continuous_mesh(device) -> dict:
    """(a), (b) and (d) of phase 20 (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention
    from repro_torch.serve import ContinuousEngine, KVPool, ServeFaultInjector, \
        ServeFaultSpec, ServeRequest
    from repro_torch.sharding import ShardCtx
    from repro_torch.telemetry import EventLog, read_events

    cfg = get_config(MOE_ARCH).replace(use_flash_kernel=True, n_layers=CONT_LAYERS)
    model = build_model(cfg)
    params = model.init(0, device)
    rng = np.random.default_rng(20)
    lens = rng.integers(CONT_PROMPTS[0], CONT_PROMPTS[1] + 1, size=CONT_REQUESTS)
    prompts = [rng.integers(0, min(cfg.vocab_size, 1024), size=n).astype(np.int32)
               for n in lens]
    drain_prompts = prompts[:DRAIN_REQUESTS]

    def reqs(ps):
        return [ServeRequest(p, max_new_tokens=CONT_NEW, rid=i) for i, p in enumerate(ps)]

    def watched(eng, walls):
        """``eng`` with each step wall its watchdog takes kept in ``walls``."""
        watchdog = eng._watchdog
        eng._watchdog = lambda w: (walls.append(w), watchdog(w))[1]
        return eng

    def warm(mesh=None):
        """One request through a fresh engine without faults, so that the
        first step's one-time costs fall outside the watchdog's readings;
        returns its decode steps' walls."""
        walls = []
        watched(ContinuousEngine(model, params, n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                                 shard_ctx=None if mesh is None else ShardCtx(mesh)),
                walls).generate([ServeRequest(prompts[0], max_new_tokens=CONT_WARM_NEW, rid=0)])
        return walls

    # the SLO from the mesh's warm steps (every rank's walls are rank 0's)
    warm_walls = _cont_ranks(device, CONT_MESH, warm)[0][0]
    slo = CONT_SLO_FACTOR * max(warm_walls[1:])
    stall = CONT_STALL_FACTOR * slo
    faults = (("sample_nan", 3, 0.0), ("slot_corrupt", 5, 0.0),
              ("decode_stall", CONT_STALL_STEP, stall))
    log(f"continuous mesh (a): the mesh's warm decode steps {[round(w, 4) for w in warm_walls]} "
        f"s; the watchdog's SLO {slo:.3f} s, the stall at step {CONT_STALL_STEP} {stall:.3f} s")

    def engine(mesh=None, log=None):
        inj = ServeFaultInjector([ServeFaultSpec(k, at, stall_s=st) for k, at, st in faults])
        return ContinuousEngine(model, params, n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                                faults=inj, quarantine_steps=CONT_QUARANTINE,
                                stall_slo_s=slo, telemetry=log,
                                shard_ctx=None if mesh is None else ShardCtx(mesh))

    # the whole model's engine on the same scenario
    warm()
    whole_log = EventLog.memory()
    t0 = time.perf_counter()
    whole = _outcome(engine(log=whole_log).generate(reqs(prompts)))
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    whole_stats = _stats(whole_log.events)

    real, errs = attention.flash_sdpa, []

    def held(q, k, v, **kw):
        o = real(q, k, v, **kw)
        ref = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              kw.get("kv_valid"), causal=kw["causal"], window=kw["window"],
                              plain=True).transpose(1, 2).float()
        atol = 1e-4 * max(1.0, float(ref.abs().max()))
        errs.append((bool(torch.allclose(o.float(), ref, rtol=1e-2, atol=atol)),
                     float((o.float() - ref).abs().max()), q.shape[2], k.shape[2]))
        return o

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    paths = [build / f"continuous_events_rank{r}.jsonl" for r in range(4)]
    for path in paths:
        path.unlink(missing_ok=True)
    probe = _GatheredLogits(1)

    def rank(mesh):
        walls = []
        eng = watched(engine(mesh, EventLog(paths[mesh.rank])), walls)
        out = _outcome(eng.generate(reqs(prompts)))
        # (a)'s counts, read on rank 0 before it agrees (b)'s first reading,
        # which no rank passes before every rank has
        counts = _counts() if mesh.rank == 0 else None
        eng.telemetry.close()
        first = dict(agreements=eng.agreements, agreement_s=eng.agreement_s,
                     iterations=eng.iterations, walls=walls, counts=counts,
                     events=None if mesh.rank == 0 else list(eng.telemetry.events))
        polls = iter(range(1, 1 << 30))
        eng.telemetry = EventLog.memory()
        drained = eng.generate(reqs(drain_prompts), drain_grace_s=0.0,
                               should_drain=(lambda: next(polls) >= DRAIN_POLL)
                               if mesh.rank == 1 else None)
        drain_events = [(e["event"], e.get("rid"), e.get("queued"), e.get("in_flight"))
                        for e in eng.telemetry.events]
        return out, first, eng.pool.nbytes, (_outcome(drained), drain_events,
                                             eng.iterations)

    torch.cuda.synchronize()
    reset_launches()
    attention.flash_sdpa = held
    try:
        with probe.installed():
            got, wall = _cont_ranks(device, CONT_MESH, rank, (probe,))
    finally:
        attention.flash_sdpa = real
    launches, designs, _ = got[0][1]["counts"]
    outs = [g[0] for g in got]
    if any(o != outs[0] for o in outs):
        raise AssertionError("continuous mesh (a): the ranks' outcomes differ")
    events0 = read_events(paths[0])
    wrote = [p.exists() for p in paths]
    kinds0 = [(e["event"], e.get("rid")) for e in events0]
    same_events = all([(e["event"], e.get("rid")) for e in g[1]["events"]] == kinds0
                      for g in got[1:])
    # the whole engine decided alike: its events' kinds and rids in order
    whole_events = [(e["event"], e.get("rid")) for e in whole_log.events] == kinds0
    mesh_stats = _stats(events0)
    for path in paths:
        path.unlink(missing_ok=True)
    prefills = sum(a for _, a, _, _ in outs[0])
    errs = errs[:CONT_LAYERS * 4 * prefills]   # (a)'s calls; (b)'s are held alike
    want = {k: (CONT_LAYERS * 4 * prefills if k == "flash_fwd" else 0) for k in launches}
    heads = sorted({(e[2], e[3]) for e in errs})
    idx = 4 * cfg.n_layers * CONT_SLOTS
    whole_pool = KVPool(model, CONT_SLOTS, CONT_MAX_LEN, "meta").nbytes
    pool_bytes = [g[2] for g in got]
    statuses = {s: sum(o[0] == s for o in outs[0]) for s in ("completed", "failed")}
    same_tokens = sum(a[3] == b[3] for a, b in zip(outs[0], whole))
    first = got[0][1]
    walls = first["walls"]
    stall_at = walls.index(max(walls)) if walls else None
    healthy = [w for i, w in enumerate(walls) if i != stall_at]
    log(f"continuous mesh (a) granite-moe-1b ({CONT_LAYERS} layers) data=2,model=2, "
        f"{CONT_SLOTS} slots: the ranks' "
        f"run {wall:.2f} s, the whole engine's {t_whole:.2f} s; statuses {statuses}, "
        f"attempts {[o[1] for o in outs[0]]}; the mesh's stats {mesh_stats}, the whole's "
        f"{whole_stats}; events {len(events0)} on rank 0, every rank's kinds and rids "
        f"rank 0's: {same_events}, the whole engine's: {whole_events}; logs written {wrote}; token sequences identical to the "
        f"whole run's {same_tokens} of {len(outs[0])} (logged only: routing ties part the "
        f"random-init MoE); pool bytes a rank {pool_bytes}, whole {whole_pool}; K3 "
        f"{launches['flash_fwd']} launches over {prefills} prefills {designs['flash_fwd']}, "
        f"{sum(e[0] for e in errs)} of {len(errs)} calls within the rule of their plain "
        f"version (|o| diff max {max(e[1] for e in errs):.3g}), (q heads, kv heads) {heads}")
    if not same_events or not whole_events or wrote != [True, False, False, False] \
            or mesh_stats != whole_stats \
            or launches != want or designs["flash_fwd"] != {"mma": want["flash_fwd"], "fma": 0} \
            or not all(e[0] for e in errs) or heads != [(cfg.n_heads // 2, cfg.n_kv_heads // 2)] \
            or any(4 * (b - idx) != whole_pool - idx for b in pool_bytes) \
            or [o[:3] for o in outs[0]] != [o[:3] for o in whole] \
            or [len(o[3]) for o in outs[0]] != [len(o[3]) for o in whole]:
        raise AssertionError(f"continuous mesh (a): events alike {same_events}, wrote {wrote}, "
                             f"stats {mesh_stats} against {whole_stats}, launches "
                             f"{launches} {designs['flash_fwd']} want {want}, pool "
                             f"{pool_bytes} of {whole_pool}")
    d_mesh, d_whole = _from_fp32("(a) the first admission's prefill", model, params,
                                 prompts[0], [], probe.calls[0][0], CONT_MAX_LEN)

    # (b): one drain flag
    drains = [g[3] for g in got]
    shed = [i for i, o in enumerate(drains[0][0]) if o[0] == "shed"]
    log(f"continuous mesh (b): rank 1's drain flag alone from its poll {DRAIN_POLL}: every "
        f"rank's outcome alike {all(d[0] == drains[0][0] for d in drains)}, its events alike "
        f"{all(d[1] == drains[0][1] for d in drains)}, loop iterations "
        f"{[d[2] for d in drains]}; shed {shed}, drain event "
        f"{[e for e in drains[0][1] if e[0] == 'serve_drain']}")
    if any(d != drains[0] for d in drains) or not shed \
            or not any(e[0] == "serve_drain" for e in drains[0][1]):
        raise AssertionError(f"continuous mesh (b): the ranks drained apart: {drains}")

    # (d): the agreement's cost
    per_iter = first["agreements"] / max(1, first["iterations"])
    log(f"continuous mesh (d): {first['agreements']} agreed readings over "
        f"{first['iterations']} loop iterations ({per_iter:.2f} an iteration), "
        f"{1e3 * first['agreement_s']:.2f} ms of rank 0's host time in all "
        f"({1e3 * first['agreement_s'] / max(1, first['agreements']):.3f} ms each); (a)'s "
        f"decode steps on the mesh {len(walls)}, wall mean "
        f"{1e3 * sum(healthy) / max(1, len(healthy)):.1f} ms, max {1e3 * max(healthy):.1f} ms "
        f"without the stalled step {stall_at} ({1e3 * max(walls):.1f} ms)")

    # fp32: the prefills and first decode steps, each block on the whole
    # engine's input
    forced = _continuous_forced("(a)", device, model, params,
                                [(p, FORCED_NEW) for p in prompts[:FORCED_SLOTS]],
                                CONT_MESH, FORCED_SLOTS, CONT_MAX_LEN)
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, designs=designs, prefills=prefills, wall_s=wall,
                whole_s=t_whole, pool_bytes=pool_bytes, whole_pool_bytes=whole_pool,
                d_mesh=d_mesh, d_whole=d_whole, identical=same_tokens, shed=shed,
                agreements=first["agreements"], iterations=first["iterations"],
                agreement_ms=1e3 * first["agreement_s"], slo_s=slo, stall_s=stall,
                step_ms=1e3 * sum(healthy) / max(1, len(healthy)), forced=forced)


def check_continuous_seq_split(device) -> dict:
    """(c) of phase 20: smollm-360m, one slot under ``cache_seq`` over four
    data ranks."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine, KVPool, ServeRequest
    from repro_torch.sharding import ShardCtx

    cfg = get_config(LONG_ARCH).replace(use_flash_kernel=True)
    model = build_model(cfg)
    params = model.init(0, device)
    prompt = np.random.default_rng(20).integers(0, min(cfg.vocab_size, 1024), size=SEQ_PROMPT
                                                ).astype(np.int32)
    probe = _GatheredLogits(2)   # the prefill's, then the first decode step's

    def rank(mesh):
        eng = ContinuousEngine(model, params, n_slots=1, max_len=SEQ_MAX_LEN,
                               shard_ctx=ShardCtx(mesh).with_rules(cache_seq=("data",)))
        out = eng.generate([ServeRequest(prompt, max_new_tokens=SEQ_NEW, rid=0)])
        return [int(t) for t in out[0].out_tokens], eng.pool.nbytes, eng.pool.ctx.cache_seq_split

    torch.cuda.synchronize()
    reset_launches()
    with probe.installed():
        got, wall = _cont_ranks(device, {"data": SEQ_RANKS, "model": 1}, rank, (probe,))
    launches, designs, _ = _counts()
    toks = got[0][0]
    idx = 4 * cfg.n_layers
    whole_pool = KVPool(model, 1, SEQ_MAX_LEN, "meta").nbytes
    pool_bytes = [g[1] for g in got]
    log(f"continuous mesh (c) smollm-360m, one slot of {SEQ_MAX_LEN} positions over data="
        f"{SEQ_RANKS} ({SEQ_MAX_LEN // SEQ_RANKS} a rank), a {SEQ_PROMPT}-token prompt, "
        f"{SEQ_NEW} tokens: the ranks' run {wall:.2f} s; tokens alike "
        f"{all(g[0] == toks for g in got)}; pool bytes a rank {pool_bytes}, whole "
        f"{whole_pool}; K3 {launches['flash_fwd']} {designs['flash_fwd']}")
    if any(g[0] != toks for g in got) or not all(g[2] for g in got) \
            or any(SEQ_RANKS * (b - idx) != whole_pool - idx for b in pool_bytes) \
            or launches["flash_fwd"] != cfg.n_layers * SEQ_RANKS or len(toks) != SEQ_NEW:
        raise AssertionError(f"continuous mesh (c): tokens {[g[0] for g in got]}, pool "
                             f"{pool_bytes} of {whole_pool}, launches {launches}")
    d_mesh, d_whole = _from_fp32("(c) the first decode step", model, params, prompt, toks[:1],
                                 probe.calls[0][1], SEQ_MAX_LEN)
    forced = _continuous_forced("(c)", device, model, params,
                                [(prompt[:SEQ_LOCAL[0]], FORCED_NEW)],
                                {"data": SEQ_RANKS, "model": 1}, 1, SEQ_LOCAL[1],
                                rules={"cache_seq": ("data",)})
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, pool_bytes=pool_bytes,
                whole_pool_bytes=whole_pool, d_mesh=d_mesh, d_whole=d_whole, forced=forced)


def run_continuous_mesh(device, rate: float) -> dict:
    """Phase 20; returns (a)'s, (c)'s and the K3 timing's numbers."""
    t0 = time.perf_counter()
    out = {"pool": check_continuous_mesh(device)}
    out["seq"] = check_continuous_seq_split(device)
    out["k3"] = time_flash(device, rate, K3_CONT_TIMING, every=True)[K3_CONT_TIMING[0][0]]
    log(f"continuous mesh: phase 20 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: any parameter layout, any mesh axis, and the dry-run's loop count
# ---------------------------------------------------------------------------

# the parameter rules (a) and (b) store BERT-large under: ``embed`` over data
# and model together (q/k/v cut along embed with their heads whole)
LAYOUT_RULES = ("embed=data,model",)
LAYOUT_MESH = {"data": 2, "model": 2}
# (b): BERT-large at full width cut to 8 of its 24 layers (four thread ranks
# dispatch host-serial, and each rank's backward runs through the graph the
# ranks share), batch 8 x seq 128, bf16, fused LAMB, flash, the fused CE head
LAYOUT_LAYERS, LAYOUT_BATCH, LAYOUT_SEQ, LAYOUT_STEPS = 8, 8, 128, 3
# (c): phase 12's step as the dry-run traces it
XLSTM_TC = dict(accum_steps=2, precision="bf16", use_fused_lamb=True)
# (c): the loop count against the unrolled trace at the suite's size
LOOP_CHECK_LAYERS, LOOP_CHECK_SEQ = 2, 64


def check_layout_blocks(device, rate: float) -> dict:
    """(a) K1/K2 on the blocks a data=2,model=2 rank stores of BERT-large's
    13 leaves under LAYOUT_RULES, by phase 15 (b)'s contract (and each
    kernel against its plain version on the blocks), then timed over one
    rank's blocks beside the bound from ``kernels/cost.py``."""
    check_tp_blocks(device, label="layout (a)", rules=LAYOUT_RULES)
    return time_kernels(device, rate, "bert-large", shards=LAYOUT_MESH["data"],
                        model_ranks=LAYOUT_MESH["model"], rules=LAYOUT_RULES)


def run_layout_mesh(device) -> dict:
    """(b) BERT-large (LAYOUT_LAYERS layers at full width) trained
    LAYOUT_STEPS steps by the Trainer over data=2,model=2 thread ranks
    (``launch.mesh.run_plain_mesh``), its params and moments stored under
    LAYOUT_RULES and then under the default rules: the layers compute in the
    default layout either way, so step 1's loss is bit-equal, steps 2-3
    within one bf16 ulp of the loss (phase 15 (d)'s rule), and K3 launches
    alike.  Returns each run's launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import run_plain_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import default_param_rules, override_rules
    from repro_torch.train import Trainer

    cfg = get_config("bert-large").replace(n_layers=LAYOUT_LAYERS)
    model = build_model(cfg)
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, precision="bf16",
                     use_fused_lamb=True)
    runs = {}
    for name, rules in (("rules", LAYOUT_RULES), ("default", ())):
        def rank(mesh, rules=rules):
            pr = override_rules(default_param_rules(), rules) if rules else None
            tr = Trainer(model, tc, device=device, mesh=mesh, param_rules=pr, log_every=1,
                         log_fn=lambda msg: None)
            tr.fit(DataPipeline(cfg, LAYOUT_BATCH, LAYOUT_SEQ, device=device, seed=0,
                                rows=tr.batch_rows), LAYOUT_STEPS)
            stored = {k: tuple(v.shape) for k, v in tr.state.params.items()}
            return [h["loss/total"] for h in tr.history], stored

        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = run_plain_mesh(rank, LAYOUT_MESH)
        torch.cuda.synchronize()
        launches, designs, _ = _counts()
        runs[name] = dict(losses=[o[0] for o in outs], stored=outs[0][1], launches=launches,
                          designs=designs, wall_s=time.perf_counter() - t0)
        log(f"layout (b) {name}: {cfg.name} at {LAYOUT_LAYERS} layers, batch {LAYOUT_BATCH} x "
            f"seq {LAYOUT_SEQ}, {LAYOUT_STEPS} steps over {LAYOUT_MESH} thread ranks in "
            f"{runs[name]['wall_s']:.1f} s: losses by rank {runs[name]['losses']}; rank 0 "
            f"stores wq {outs[0][1]['blocks/attn/wq']}, wo {outs[0][1]['blocks/attn/wo']}; "
            f"launches {launches}; designs {designs}")
    a, b = runs["rules"], runs["default"]
    if any(losses != run["losses"][0] for run in (a, b) for losses in run["losses"]):
        raise AssertionError("layout (b): a run's ranks logged different losses")
    first, rest = a["losses"][0], b["losses"][0]
    ulps = [abs(x - y) / float(bf16_ulp(torch.tensor(y))) for x, y in zip(first, rest)]
    log(f"layout (b): losses under {','.join(LAYOUT_RULES)} {first}, default {rest}; step 1 "
        f"bit-equal {first[0] == rest[0]}; bf16 ulps of the loss by step {ulps}")
    if first[0] != rest[0] or max(ulps) > 1.0:
        raise AssertionError("layout (b): the stored layout moved the step's products")
    if a["launches"]["flash_fwd"] != b["launches"]["flash_fwd"] or not all(
            a["launches"][k] > 0 for k in KERNELS):
        raise AssertionError(f"layout (b): launches {a['launches']} against {b['launches']}")
    if a["stored"] == b["stored"]:
        raise AssertionError("layout (b): the rules stored the default layout")
    return {name: r["launches"] for name, r in runs.items()}


def check_loop_count(device, xlstm: dict) -> dict:
    """(c) Phase 12's xlstm-350m step (batch 16 x seq 256, accum 2, bf16,
    fused LAMB) traced by the dry-run on an abstract data=1 mesh, each
    sLSTM loop counted from three of its steps: its argument bytes equal the
    real state's and batch's, its peak within DRY_PEAK_TOL of phase 12's
    ``max_memory_allocated`` over its timed steps, phase 12's profiled busy
    at least the roofline's larger term.  Then, under this machine's torch,
    the loop count against the unrolled trace at LOOP_CHECK_LAYERS layers
    and LOOP_CHECK_SEQ positions on the 256-rank mesh, a prefill and a
    train step: every count equal, the peak within 1%."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh, make_production_mesh
    from repro_torch.models.api import build_model

    timing = xlstm["timing"]
    model = build_model(get_config(XLSTM_ARCH))
    shape = InputShape("phase 12 step", XLSTM_SEQ, XLSTM_BATCH, "train")
    # (b)'s thread ranks leave graphs behind: collected here, so that what
    # is freed during the trace does not hide what it might allocate
    gc.collect()
    allocated = torch.cuda.memory_allocated()
    rec = dryrun.trace(model, shape, abstract_mesh((1,), ("data",)), tc_kw=XLSTM_TC)
    if torch.cuda.memory_allocated() > allocated:
        raise AssertionError("the dry-run allocated on the card")
    mem, rl = rec["memory"], rec["roofline"]
    off = mem["peak_memory_in_bytes"] / timing["step_peak"] - 1
    bound = max(rl["compute_s"], rl["memory_s"]) * 1e3
    log(f"loops (c): {XLSTM_ARCH} x batch {XLSTM_BATCH} x seq {XLSTM_SEQ} traced in "
        f"{rec['trace_s']:.2f} s: memory {json.dumps(mem)}, cost {json.dumps(rec['cost'])}; "
        f"argument bytes {mem['argument_size_in_bytes']}, phase 12's state and batch "
        f"{timing['args_bytes']}; peak {mem['peak_memory_in_bytes'] / 2**30:.3f} GiB traced, "
        f"phase 12's {timing['step_peak'] / 2**30:.3f} GiB ({off:+.2%}); roofline compute "
        f"{rl['compute_s'] * 1e3:.3f} ms, memory {rl['memory_s'] * 1e3:.3f} ms, phase 12's "
        f"busy {timing['busy_ms']:.3f} ms ({bound / timing['busy_ms']:.4f} of it)")
    if mem["argument_size_in_bytes"] != timing["args_bytes"]:
        raise AssertionError("loops (c): the traced argument bytes differ from the real "
                             "state's and batch's")
    if abs(off) > DRY_PEAK_TOL:
        raise AssertionError(f"loops (c): the traced peak is {off:+.1%} off the card's")
    if timing["busy_ms"] < bound:
        raise AssertionError(f"loops (c): busy {timing['busy_ms']:.3f} ms below the "
                             f"roofline's {bound:.3f}")
    small = build_model(get_config(XLSTM_ARCH).replace(n_layers=LOOP_CHECK_LAYERS))
    for kind, batch in (("prefill", 32), ("train", 256)):
        shape = InputShape("loops", LOOP_CHECK_SEQ, batch, kind)
        counted, unrolled = (dryrun.trace(small, shape, make_production_mesh(), loops=loops)
                             for loops in (True, False))
        peaks = [r["memory"]["peak_memory_in_bytes"] for r in (counted, unrolled)]
        same = all(counted[k] == unrolled[k] for k in ("cost", "kernels", "collectives"))
        log(f"loops (c) {kind}: counted in {counted['trace_s']:.2f} s, unrolled in "
            f"{unrolled['trace_s']:.2f} s; counts equal {same}; peaks {peaks}")
        if not same or abs(peaks[0] / peaks[1] - 1) > 0.01:
            raise AssertionError(f"loops (c): the {kind} loop count left the unrolled trace")
    return dict(trace_s=rec["trace_s"], memory=mem, bound_ms=bound, peak_off=off)


def run_layouts(device, rate: float, recurrent: dict) -> dict:
    """Phase 21; returns (a)'s timings and (b)'s launches."""
    t0 = time.perf_counter()
    out = {"blocks": check_layout_blocks(device, rate), "mesh": run_layout_mesh(device),
           "loops": check_loop_count(device, recurrent["xlstm_training"])}
    log(f"layouts: phase 21 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls after two warm-up calls.

    The device first sleeps (~20 ms at the H100's boost clock) while the host
    queues every call behind it, so the span between the events is device
    time even for a call whose host dispatch outlasts its kernels.
    """
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernels(device, rate: float, arch: str = "bert-large", shards: int = 1,
                 model_ranks: int = 1, rules=()) -> dict:
    """K1 and K2 over one full update of ``arch``'s leaves, plain, kernel
    (and with the guard's flag), kernel, plain, beside their bound.  With
    ``shards`` N > 1 or ``model_ranks`` M > 1: over the blocks one rank of a
    ``data=N,model=M`` mesh holds (phases 14 and 15), stored under the
    parameter rules' overrides ``rules`` (phase 21)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, cost, lamb_apply, lamb_moments
    from repro_torch.kernels.lamb_update import bias_corrections
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.nn import flatten
    from repro_torch.sharding import leaf_layout
    from repro_torch.sharding.collectives import shard_block

    model = build_model(get_config(arch).replace(
        use_flash_kernel=False, use_fused_ce_head=False))
    axes = model.layer_axes()
    mesh = Mesh({"data": shards, "model": model_ranks})
    specs = _param_specs(model, mesh, rules)
    gen = torch.Generator(device=device).manual_seed(1)
    leaves = []
    for k, p in flatten(model.defs).items():
        layers = p.shape[0] if axes[k] == 0 else 1
        # rank 0's block
        shape = shard_block(torch.empty(p.shape, device="meta"), leaf_layout(specs[k], mesh),
                            mesh).shape
        x = 0.05 * torch.randn(shape, generator=gen, device=device)
        g = 1e-3 * torch.randn(shape, generator=gen, device=device)
        m = torch.zeros_like(x)
        v = torch.zeros_like(x)
        ratio = torch.full((layers,), 1e-3, device=device)
        leaves.append((x, g, m, v, ratio, layers))
    c = bias_corrections(torch.tensor(5, device=device), 0.9, 0.999, device)
    n = sum(x.numel() for x, *_ in leaves)
    taken = torch.tensor(1, dtype=torch.int32, device=device)   # the guard's flag

    def moments(plain, ok=None):
        for x, g, m, v, _, layers in leaves:
            lamb_moments(x, g, m, v, c, layers, ok=ok, plain=plain)

    def apply(plain, ok=None):
        for x, _, m, v, ratio, layers in leaves:
            lamb_apply(x, m, v, c, ratio, layers, ok=ok, plain=plain)

    # what each function must move and compute over every leaf
    works = {"lamb_moments": cost.total(cost.lamb_moments(x.numel(), layers)
                                        for x, *_, layers in leaves),
             "lamb_apply": cost.total(cost.lamb_apply(x.numel(), layers)
                                      for x, *_, layers in leaves)}
    fns = {"lamb_moments": moments, "lamb_apply": apply}
    # plain, kernel, kernel with the guard's flag, the same twice more, plain:
    # the versions compared within one call
    times = {name: {"plain": [], "cuda": [], "ok": []} for name in fns}
    timed = {}   # the kernel's launches in its own timing
    for name, fn in fns.items():
        before = LAUNCHES[name]
        for plain in (True, False, False, True):
            times[name]["plain" if plain else "cuda"].append(cuda_ms(lambda: fn(plain)))
            if not plain:
                times[name]["ok"].append(cuda_ms(lambda: fn(False, taken)))
        timed[name] = LAUNCHES[name] - before
    out = {}
    for name in fns:
        t_k = min(times[name]["cuda"])
        t_p = min(times[name]["plain"])
        b = bound_of(works[name], rate)
        bound = b["bound_ms"]
        out[name] = dict(ms=t_k, plain_ms=t_p, **b,
                         library_ms=None, ok_ms=min(times[name]["ok"]),
                         timed_launches=timed[name])
        where = (arch if shards == model_ranks == 1
                 else f"{arch} data={shards},model={model_ranks} block"
                 + (f" stored under {','.join(rules)}" if rules else ""))
        log(f"time {name} {where}: kernel {times[name]['cuda']} ms, with ok=1 "
            f"{times[name]['ok']} ms, plain {times[name]['plain']} ms "
            f"over {n} elements in {len(leaves)} leaves; bound {bound:.3f} ms "
            f"({works[name].bytes / 1e9:.2f} GB at {rate / 1e12:.2f} TB/s); "
            f"{works[name].bytes / (t_k * 1e-3) / 1e12:.2f} TB/s achieved")
    log("time library: none; no single PyTorch call computes a LAMB update")
    del leaves
    torch.cuda.empty_cache()
    log(f"time full update {arch} data={shards},model={model_ranks} (K1 + K2): kernel {out['lamb_moments']['ms'] + out['lamb_apply']['ms']:.3f}"
        f" ms, plain {out['lamb_moments']['plain_ms'] + out['lamb_apply']['plain_ms']:.3f} ms")
    return out


def time_flash(device, rate: float, shapes=FLASH_TIMING, every: bool = False) -> dict:
    """K3–K5 at each of ``shapes`` (bf16, causal or no mask), plain, kernel,
    kernel, plain, beside their bound and ``scaled_dot_product_attention``
    (k and v repeated to every q head).  A head dim outside the kernels'
    own runs on inputs zero-padded to ``kernel_head_dim`` (the bound and
    SDPA at the real one).  Returns the first shape's numbers by kernel
    name, or with ``every`` each shape's by label."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import FlashSpec, flash_attention_fwd, \
        flash_dkv, flash_dq, kernel_head_dim, row_dot

    gen = torch.Generator(device=device).manual_seed(3)
    result = {}
    for label, b, h, hkv, s, d, causal in shapes:
        q, do = (torch.randn((b, h, s, d), generator=gen, device=device).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=device).to(torch.bfloat16)
                for _ in range(2))
        kr, vr = (x.repeat_interleave(h // hkv, 1) for x in (k, v))
        valid = None   # the main path's batches carry no lengths
        spec = FlashSpec(d**-0.5, causal, 0, False)
        dp = kernel_head_dim(d)
        if dp != d:   # the kernels' call, as flash_attention pads it
            q, k, v, do = (F.pad(x, (0, dp - d)) for x in (q, k, v, do))
        o, lse = flash_attention_fwd(q, k, v, valid, spec, plain=True)
        di = row_dot(o, do)
        fns = {
            "flash_fwd": lambda plain: flash_attention_fwd(q, k, v, valid, spec, plain=plain),
            "flash_dq": lambda plain: flash_dq(q, k, v, valid, lse, di, do, spec, plain=plain),
            "flash_dkv": lambda plain: flash_dkv(q, k, v, valid, lse, di, do, spec,
                                                 plain=plain),
        }
        # what each must move and compute over the (row, key) pairs the mask
        # keeps, at the real head dim
        works = {name: getattr(cost, name)(b, h, hkv, s, s, d, torch.bfloat16, causal)
                 for name in FLASH}
        times = {name: {"plain": [], "cuda": []} for name in fns}
        for name, fn in fns.items():
            for plain in (True, False, False, True):
                times[name]["plain" if plain else "cuda"].append(cuda_ms(lambda: fn(plain)))
        q_d, do_d = q[..., :d], do[..., :d]
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q_d, kr, vr,
                                                                  is_causal=causal))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q_d, kr, vr))
        sdpa_fb = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal), (qg, kg, vg), do_d))
        out = {}
        for name in fns:
            t_k, t_p = min(times[name]["cuda"]), min(times[name]["plain"])
            w = works[name]
            out[name] = dict(ms=t_k, plain_ms=t_p, **bound_of(w, rate),
                             library_ms=sdpa_fwd if name == "flash_fwd" else None)
            log(f"time {name} {label} (b {b} h {h} hkv {hkv} s {s} d {d} (kernels' {dp}) "
                f"causal {causal} bf16): kernel "
                f"{times[name]['cuda']} ms, plain {times[name]['plain']} ms; bound "
                f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
                f"({w.bytes / 1e6:.1f} MB, {w.operations / 1e9:.2f} GFLOP); achieved "
                f"{w.operations / (t_k * 1e-3) / 1e12:.2f} TFLOP/s, "
                f"{w.bytes / (t_k * 1e-3) / 1e12:.3f} TB/s")
        log(f"time library {label}: scaled_dot_product_attention forward {sdpa_fwd:.4f} ms, "
            f"forward + backward {sdpa_fb:.4f} ms (backward {sdpa_fb - sdpa_fwd:.4f} ms); "
            f"K3 {out['flash_fwd']['ms']:.4f} ms, K4 + K5 "
            f"{out['flash_dq']['ms'] + out['flash_dkv']['ms']:.4f} ms")
        result[label] = out
        del q, k, v, kr, vr, do, qg, kg, vg, o, lse, di, q_d, do_d
    torch.cuda.empty_cache()
    return result if every else result[shapes[0][0]]


def time_flash_widths(device, rate: float) -> dict:
    """``flash_attention`` (the padded path at a head dim outside the
    kernels' own) forward and forward + backward at WIDTH_DIMS, b 8, h 16,
    s 512, bidirectional, bf16, beside the forward's plain version, its
    bound at the real head dim, and ``scaled_dot_product_attention``'s
    forward alone and forward + backward as yardsticks.  Returns the times
    by head dim."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=device).manual_seed(9)
    b, h, s = 8, 16, 512
    out = {}
    for d in WIDTH_DIMS:
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=device)
                       .to(torch.bfloat16) for _ in range(4))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        with torch.no_grad():
            fwd = cuda_ms(lambda: flash_attention(q, k, v, causal=False))
            plain = cuda_ms(lambda: flash_attention(q, k, v, causal=False, plain=True))
            sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        both = cuda_ms(lambda: torch.autograd.grad(flash_attention(qg, kg, vg, causal=False),
                                                   (qg, kg, vg), do))
        sdpa = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qg, kg, vg),
                                                   (qg, kg, vg), do))
        # the forward's bound at the real head dim
        out[d] = dict(fwd_ms=fwd, fwd_bwd_ms=both, plain_fwd_ms=plain,
                      **bound_of(cost.flash_fwd(b, h, h, s, s, d, torch.bfloat16), rate),
                      sdpa_fwd_ms=sdpa_fwd, sdpa_fwd_bwd_ms=sdpa)
        del q, k, v, do, qg, kg, vg
    base = out[64]
    for d, r in out.items():
        log(f"time flash width D {d} (b {b} h {h} s {s} bidirectional bf16, padded to the "
            f"kernels' next head dim): forward {r['fwd_ms']:.4f} ms "
            f"({r['fwd_ms'] / base['fwd_ms']:.2f}x D 64), forward + backward "
            f"{r['fwd_bwd_ms']:.4f} ms ({r['fwd_bwd_ms'] / base['fwd_bwd_ms']:.2f}x D 64); "
            f"forward's plain version {r['plain_fwd_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']}; SDPA forward {r['sdpa_fwd_ms']:.4f} ms, forward + backward "
            f"{r['sdpa_fwd_bwd_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return out


def time_fused_ce(device, rate: float, shapes=CE_TIMING, fma: bool = True) -> dict:
    """K6–K8 at each of ``shapes`` (bf16), plain, kernel, kernel, plain,
    beside their bound and the dense head's two calls (``matmul`` then
    ``cross_entropy``) forward and forward + backward.  K6–K8 run on the
    tensor cores; with ``fma``, their FMA design (what bf16 rows off a
    16-byte boundary take) is timed in the same turns, on h 2 bytes off.
    Returns the first shape's numbers by kernel name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_dw, fused_ce_fwd

    gen = torch.Generator(device=device).manual_seed(5)
    result = {}
    for label, n, d, v in shapes:
        w = (0.05 * torch.randn((v, d), generator=gen, device=device)).to(torch.bfloat16)
        h = torch.randn((n, d), generator=gen, device=device).to(torch.bfloat16)
        lbl = torch.randint(0, v, (n,), generator=gen, device=device, dtype=torch.int32)
        g = torch.full((n,), 1.0 / n, device=device)
        lse = fused_ce_fwd(h, w, lbl, plain=True)[2]
        fns = {
            "fused_ce_fwd": lambda plain: fused_ce_fwd(h, w, lbl, plain=plain),
            "fused_ce_dh": lambda plain: fused_ce_dh(h, w, lbl, lse, g, plain=plain),
            "fused_ce_dw": lambda plain: fused_ce_dw(h, w, lbl, lse, g, plain=plain),
        }
        # what each must move and compute
        works = {name: getattr(cost, name)(n, d, v, torch.bfloat16) for name in FUSED_CE}
        h_off = torch.cat([h.new_zeros(1), h.reshape(-1)])[1:].view(n, d)   # FMA design
        fma_fns = {"fused_ce_fwd": lambda: fused_ce_fwd(h_off, w, lbl),
                   "fused_ce_dh": lambda: fused_ce_dh(h_off, w, lbl, lse, g),
                   "fused_ce_dw": lambda: fused_ce_dw(h_off, w, lbl, lse, g)}
        times = {name: {"plain": [], "cuda": [], "fma": []} for name in fns}
        for name, fn in fns.items():
            for plain in (True, False, False, True):
                times[name]["plain" if plain else "cuda"].append(cuda_ms(lambda: fn(plain)))
                if fma and plain:
                    times[name]["fma"].append(cuda_ms(fma_fns[name]))
        lbl64 = lbl.long()
        dense_fwd = cuda_ms(lambda: F.cross_entropy(torch.matmul(h, w.t()), lbl64,
                                                    reduction="none"))
        hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
        dense_fb = cuda_ms(lambda: torch.autograd.grad(
            F.cross_entropy(torch.matmul(hg, wg.t()), lbl64, reduction="none"), (hg, wg), g))
        out = {}
        for name in fns:
            t_k, t_p = min(times[name]["cuda"]), min(times[name]["plain"])
            out[name] = dict(ms=t_k, plain_ms=t_p, **bound_of(works[name], rate),
                             library_ms=dense_fwd if name == "fused_ce_fwd" else None)
            if times[name]["fma"]:
                out[name]["fma_ms"] = min(times[name]["fma"])
            log(f"time {name} {label} (n {n} d {d} v {v} bf16): kernel "
                f"{times[name]['cuda']} ms, plain {times[name]['plain']} ms, FMA design "
                f"{times[name]['fma'] or 'n/a'} ms; bound "
                f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
                f"({works[name].bytes / 1e6:.1f} MB, {works[name].operations / 1e9:.2f} "
                f"GFLOP); achieved {works[name].operations / (t_k * 1e-3) / 1e12:.2f} TFLOP/s")
        log(f"time library {label}: dense head matmul + cross_entropy (two calls, bf16 "
            f"logits) forward {dense_fwd:.4f} ms, forward + backward {dense_fb:.4f} ms "
            f"(backward {dense_fb - dense_fwd:.4f} ms); K6 {out['fused_ce_fwd']['ms']:.4f} ms, "
            f"K7 + K8 {out['fused_ce_dh']['ms'] + out['fused_ce_dw']['ms']:.4f} ms")
        result[label] = out
        del h, h_off, hg, lse, g, w, wg
    torch.cuda.empty_cache()
    return result[shapes[0][0]]


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(src/repro_torch not found)")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    log(card)
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s wall)")
    for src in build.SOURCES:
        for line in ptxas_lines((build.BUILD_DIR / f"{src}.log").read_text()):
            log(f"ptxas {src}: {line}")

    errs = {**check_kernels(device), **check_flash(device), **check_fused_ce(device)}
    check_against_cpu(device)
    launches, main_hist = run_main_path(device)
    trainer = run_two_stages(device)
    check_guard(trainer, device)
    del trainer
    torch.cuda.empty_cache()
    ref_losses, ref_params = check_checkpoint_resume(device)
    check_lamb_forms(device)
    for opt in OPTIMIZERS:
        run_optimizer(device, opt)
    run_optimizer(device, "lamb", fused=True)
    check_unfused_guard_and_stages(device)
    check_telemetry(device, main_hist, launches)
    rollback_ref = check_rollback(device)
    check_divergence(device)
    preempt_ref = check_preemption(device, ref_losses, ref_params)
    check_remat(device)
    time_training_variants(device)
    serving = run_serving(device, rate)
    moe = run_moe(device)
    recurrent = run_recurrent(device)
    deepseek = run_deepseek(device)
    fsdp = run_fsdp(device)
    tp = run_tp(device, fsdp)
    robust = run_mesh_robustness(device, rollback_ref, preempt_ref, ref_losses, ref_params)
    del ref_params, rollback_ref
    run_model_axis(device)
    run_dryrun_phase(device)
    serve_mesh = run_serve_mesh(device, rate)
    cont_mesh = run_continuous_mesh(device, rate)
    layouts = run_layouts(device, rate, recurrent)
    timing = {**time_kernels(device, rate), **time_flash(device, rate),
              **time_fused_ce(device, rate)}
    moe_timing = {**time_kernels(device, rate, MOE_ARCH),
                  **time_flash(device, rate, MOE_FLASH_TIMING),
                  **time_fused_ce(device, rate, MOE_CE_TIMING)}
    widths = time_flash_widths(device, rate)
    wide_flash = time_flash(device, rate, WIDE_FLASH_TIMING, every=True)
    xlstm_timing = time_kernels(device, rate, XLSTM_ARCH)
    shard_timing = time_kernels(device, rate, "bert-large", shards=FSDP_SHARDS)
    block_timing = time_kernels(device, rate, "bert-large", shards=TP_MESH["data"],
                                model_ranks=TP_MESH["model"])
    expert_timing = time_kernels(device, rate, MOE_ARCH, shards=EP_MESH["data"],
                                 model_ranks=EP_MESH["model"])
    slice_timing = time_vocab_slices(device, rate)
    gqa_timing = time_flash(device, rate, GQA_FLASH_TIMING, every=True)
    time_tp_products(device, rate)
    wide = {sh[0]: time_fused_ce(device, rate, [sh]) for sh in WIDE_CE_TIMING}
    # the FMA design is not timed there: at D 7168 it re-forms the scores in
    # each of 7 windows on FMA (seconds a call), and no path takes it there
    ds_ce = time_fused_ce(device, rate, DS_CE_TIMING, fma=False)

    kernels = [dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errs[k],
                    **timing[k], granite_moe=dict(launches=moe["launches"][k], **moe_timing[k]))
               for k in KERNELS]
    by_name = {k["name"]: k for k in kernels}
    # K3 on the serving paths (phases 10 and 11): its launches there and its
    # times at the serving prefill's shape; at the padded head dims
    by_name["flash_fwd"]["serving"] = serving
    by_name["flash_fwd"]["granite_moe"]["serving_launches"] = moe["serving"]["launches"]
    by_name["flash_fwd"]["head_dims"] = widths
    for k in FUSED_CE:   # at D past one 1024-column window
        by_name[k]["wide_d"] = {label: w[k] for label, w in wide.items()}
    # phase 12: K1/K2 on xlstm-350m's path (launches and times at its leaves),
    # every kernel's launches in jamba-smoke's training and K3's on its
    # prefills, and K3–K5 at head dims past 256
    for k in ("lamb_moments", "lamb_apply"):
        by_name[k]["xlstm"] = dict(launches=recurrent["xlstm_training"]["launches"][k],
                                   **xlstm_timing[k])
    for k in KERNELS:
        by_name[k]["jamba_smoke"] = dict(launches=recurrent["jamba_smoke"]["launches"][k])
    by_name["flash_fwd"]["jamba_smoke"]["serving_launches"] = \
        recurrent["jamba_smoke"]["serving"]["launches"]["flash_fwd"]
    for k in FLASH:
        by_name[k]["wide_head_dims"] = {label: w[k] for label, w in wide_flash.items()}
    # phase 13: every kernel's launches in deepseek-smoke's training (K1/K2
    # and K6–K8 run there), and K6–K8 on deepseek-v3's full-width head: its
    # launches in (c) and its times at D 7168
    for k in KERNELS:
        by_name[k]["deepseek_smoke"] = dict(launches=deepseek["training"]["launches"][k])
    for k in FUSED_CE:
        by_name[k]["deepseek_d7168"] = dict(
            launches=deepseek["pieces"]["head"]["launches"][k], **ds_ce[k])
    # phase 14: every kernel's launches in the main path through the sharded
    # Trainer on a data=1 mesh, and K1/K2's times over a data=4 rank's
    # slices with the launches of that timing (no data=4 path runs here)
    for k in KERNELS:
        by_name[k]["fsdp_data1_mesh"] = dict(launches=fsdp["launches"][k])
    for k in ("lamb_moments", "lamb_apply"):
        by_name[k]["bert_large_data4_slice"] = dict(
            launches=shard_timing[k].pop("timed_launches"), **shard_timing[k])
    # phase 15: every kernel's launches in the main path on a data=1,model=1
    # mesh; K6–K8 on one vocab slice of each (a) case (the launches of the
    # slice contract check and of the timing) and K1/K2 over a
    # data=2,model=2 rank's blocks (the launches of their timing)
    for k in KERNELS:
        by_name[k]["tp_data1_model1_mesh"] = dict(launches=tp["launches"][k])
    for k in FUSED_CE:
        by_name[k]["vocab_slice"] = {
            label: dict(launches=tp["slices"][label][k],
                        timed_launches=slice_timing[k][label].pop("timed_launches"),
                        **slice_timing[k][label]) for label in slice_timing[k]}
    for k in ("lamb_moments", "lamb_apply"):
        by_name[k]["bert_large_data2_model2_block"] = dict(
            launches=block_timing[k].pop("timed_launches"), **block_timing[k])
    # phase 16: every kernel's launches in the loss-spike rollback on a
    # data=1,model=1 mesh, and K3–K5's on the model=3 ranks' q heads (the
    # launches of the ranks' attention() calls, and of the kernel contract
    # check) with their times there beside the whole heads' call
    for k in KERNELS:
        by_name[k]["mesh_rollback"] = dict(launches=robust["launches"][k])
    for k in FLASH:
        by_name[k]["gqa_rank_heads"] = dict(launches=robust["gqa_launches"][k],
                                            contract_launches=robust["gqa_contract_launches"][k],
                                            **gqa_timing["rank"][k],
                                            whole_heads_ms=gqa_timing["whole"][k]["ms"])
    # phase 17: K1/K2 over a model=4 rank's blocks of granite-moe-1b's 12
    # leaves, its 8 experts among them (the launches of their timing; no
    # model > 1 path runs on one card)
    for k in ("lamb_moments", "lamb_apply"):
        by_name[k]["granite_moe_model4_block"] = dict(
            launches=expert_timing[k].pop("timed_launches"), **expert_timing[k])
    # phase 19: K3's launches on the model=4 ranks' prefill of (a) and the
    # data=4 ranks' batch-1 prefill of (b), and its times on one model=4
    # rank's heads at (a)'s prefill shape
    by_name["flash_fwd"]["serving_model4_rank"] = dict(
        launches=serve_mesh["model"]["launches"]["flash_fwd"],
        long_context_launches=serve_mesh["long"]["launches"]["flash_fwd"],
        **serve_mesh["k3"]["flash_fwd"])
    # phase 20: K3's launches on the continuous engine's prefills over
    # data=2,model=2 (retries included) and over data=4 at one slot, and
    # its times on one model=2 rank's heads at (a)'s prefill shape
    by_name["flash_fwd"]["continuous_model2_rank"] = dict(
        launches=cont_mesh["pool"]["launches"]["flash_fwd"],
        seq_split_launches=cont_mesh["seq"]["launches"]["flash_fwd"],
        **cont_mesh["k3"]["flash_fwd"])
    # phase 21: K1/K2 over a data=2,model=2 rank's blocks of BERT-large
    # stored under LAYOUT_RULES (the launches of their timing), and every
    # kernel's launches in (b)'s runs over thread ranks, under the rules and
    # under the default layout
    for k in ("lamb_moments", "lamb_apply"):
        by_name[k]["bert_large_embed_data_model_block"] = dict(
            launches=layouts["blocks"][k].pop("timed_launches"), **layouts["blocks"][k])
    for k in KERNELS:
        by_name[k]["layout_mesh"] = {name: launches[k]
                                     for name, launches in layouts["mesh"].items()}
    log(card)   # again near the end, where a truncated log still shows it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
