#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kungfu_tpu_torch) on one GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the result line):

1. probe   — torch/CUDA versions, device name, compute capability,
             ``nvidia-smi`` name and power limit;
2. build   — nvcc builds every hand-written CUDA kernel from ``csrc/``,
             one nvcc per source, all started together (the Triton
             kernels compile at their first launch, in phase 3); the
             wgmma/TMA flash kernels must show no register spills in
             ptxas's report and HGMMA and UTMALDG instructions in their
             SASS (``cuobjdump``) at every compiled head width (32, 64,
             96, 128, 256), and so must the LM head's wgmma forward, dh
             and dW kernels; the build's wall seconds are printed;
3. kernels — each kernel against its plain PyTorch version on the card,
             at the main path's shape and at the edge cases (for the
             flash kernels also a bf16 grid of sequence lengths around
             their tile edges, head dims 32/64/96/128/256 and the padded
             16/48/80/160, causal and not, the padded widths in f32
             too, one call of 70,000 batch-heads (two launches of
             each kernel), a 257-wide head refused with a ValueError
             that names the limit, and phase 17's ring rounds, the
             backward with a non-zero lse cotangent; for the
             cross-entropy also phase 17 (a)'s [16384, 32128]), with
             the tolerances below; timed (median
             of CUDA-event windows) beside its plain version and one
             PyTorch library call, the flash forward at its three
             main-path shapes and dQ and dK/dV at the two training
             shapes, and all three without a mask at one BERT-base
             rank's [96, 512, 64], and at phase 17's ring rounds ([192,
             512, 64] causal, [96, 1024, 64] without a mask), and at
             phase 26's [64, 2048, 80] (padded to 96) and [16, 2048,
             256] causal beside SDPA on the unpadded call, the
             cross-entropy at the flagship's [8192, 32128] and BERT's
             [4096, 30528], with the host µs per launch;
4. forward — the flagship forward (vocab 32128, d_model 768, 12 layers,
             12 heads, d_ff 3072, RoPE, causal, bf16, ids [4, 256]) with
             random weights from a seed, through the kernel, held
             against the same model under ``KF_TPU_ATTN=xla``;
5. serve   — the continuous-batching engine on the same model answers
             six requests (two sharing a 64-token prefix), held against
             full-context greedy decoding through the forward;
6. train   — the flagship training step (``gpt_small(max_seq=2048)``,
             f32 params, bf16 compute, ids/targets [4, 2048]): flash
             attention + fused cross-entropy through ``dp_train_step`` and
             ``synchronous_sgd(sgd(0.05, momentum=0.9))``; launches per
             step, first-step gradients against the plain path, ten steps
             of falling loss, one step through ``Transformer.loss`` under
             ``KF_TPU_XENT=fused``, step ms, tokens/s, MFU, peak memory;
7. train   — the same step with the fused LM head (``hidden`` +
             ``lm_head_nll``: the logits never reach device memory), held
             against flash + plain head + plain cross-entropy, and one
             step through ``Transformer.loss`` under
             ``KF_TPU_LM_HEAD=fused``; the same measurements;
8. S-SGD   — phase 6's step on four co-resident ranks of one card
             (``Communicator(devices=["cuda:0"] * 4)``, one batch row per
             rank), ``synchronous_sgd(..., schedule="pallas_ring",
             fuse_grads=True)``: one ring reduce-scatter and one ring
             all-gather over the fused gradient; the first loss and the
             reduced gradient against phase 6's single-rank ones, ten
             steps of falling loss, step ms, tokens/s, peak memory;
9. ZeRO    — ZeRO-2 and ZeRO-3 (``zero_train_step(...,
             schedule="pallas_ring")``) on the same ranks: 129 bucketed
             ring launches per direction, params after one step against
             phase 8's, falling loss, step ms, tokens/s, peak memory,
             per-rank optimizer bytes, and the ring bytes counted in one
             step against ``zero_comm_bytes``;
10. replicas — ``bert_base()`` (vocab 30528, learned positions,
             bidirectional) at full width and depth on the same four
             ranks, 8 x 512 tokens each, phase 6's loss, inner
             ``sgd(1e-3, momentum=0.9)``: SMA (``synchronous_averaging``,
             alpha 0.1) over stacked per-replica params, each rank's
             first step against the same step under KF_TPU_ATTN=xla, the
             ranks apart after it, ten steps of falling loss and a
             cross-rank spread below alpha 0's; AdaptiveSGD (switch at
             step 5: the spread falls across it); the GNS and variance
             monitors on the replicated step, their first-step square
             norms, variance and raw GNS against f64 on the host;
             ``Communicator.autotune_strategy`` at 4 MiB a rank (the
             pallas_ring candidate launches both ring kernels; the
             winner is installed and agrees with psum); step ms,
             tokens/s, MFU, launches and peak memory of the SMA and GNS
             steps;
11. elastic — phase 9's model under ZeRO-2 (``pallas_ring``, inner
             ``adam``) through the step-based schedule ``4:3,2:3,4:2``
             (``[1, 2048]`` a rank at four ranks, ``[2, 2048]`` at two),
             driven the KungFu way: a ``ConfigServer`` on an OS-assigned
             port holds the cluster, each change of size is a PUT of
             ``cluster.resize(n)`` read back with ``fetch_cluster``, and
             the new world is placed from the ``ZeroBoundary`` and the
             ``StepSnapshot`` committed after every step.  Each step
             after a resize is bitwise equal to a fixed-world step from
             the same boundary hand-repadded; at 4 -> 2 ``zero1_reshard``,
             ``zero_snapshot`` -> ``zero_restore``, ``zero_reshard_p2p``
             and chunk mode (four ``PyHostChannel``s on loopback, ring
             mirrors, ranks 1 and 3 dead) give the boundary's state bit
             for bit, and a step from chunk mode's equals the fixed
             world's; a ZeRO-3 param shard re-carved 4 -> 2 gathers
             bitwise and trains a stage-3 step at two ranks; every
             step's launches are exact at k = 4 and k = 2; the loss
             falls; commit, recarve, place and wire times, step ms and
             peak memory;
12. host engine — benchmarks/system.py's ``--backend host --model bert``
             loop with phase 10's model, batch and loss (the real
             gradient in place of the fake sizes): each step every
             rank's gradient goes into its pinned f32 buffer, four
             ``CollectiveEngine``s (one thread a rank) over
             ``NativeHostChannel``s from ``HostChannel``'s default
             ``auto`` mean-allreduce them in place in the C++ executor
             (the native library built with g++ from the checkout), and
             ``sgd(1e-3, momentum=0.9)`` applies the result on the card.
             Checks: (a) native channels and executor; (b) the four
             reduced buffers bitwise equal to each other and to the
             plain graph walk; (c) the C++ executor and the Python path
             bitwise equal for all eight strategies on 16 MiB a rank,
             and on the whole buffer under AUTO; (d) params after step 1
             within 1e-5 relative L2 per leaf of the device-plane S-SGD
             step; (e) falling loss; (f) ``set_strategy`` at a step
             boundary, the next step passing (b); (g) ZeRO-2 over the
             host plane (``host_bucket_pipeline`` and
             ``host_bucket_all_gather``), pipelined bitwise equal to
             serial, within 1e-5 of (d); (h) ``host_noise_scale`` against
             phase 10's GNS monitor.  Step ms split into grads, D2H,
             allreduce and H2D + update, GB/s per strategy, pinned bytes,
             peak memory and launches per step.

13. recover — the peer runtime and in-flight failure recovery on phase
             6's gpt_small: four ``Peer``s (one thread each) from
             ``parse_config_from_env`` over env dicts in
             ``single_machine_env``'s shape on ports found free, under a
             ``ConfigServer``; rank r takes row r of phase 6's batch.  A
             step: each rank's gradient on the card, D2H into its pinned
             buffer, ``host_bucket_pipeline``'s mean reduce-scatter over
             ``peer.engine()``, ``sgd(0.05, momentum=0.9)`` on the rank's
             chunks on the card, ``host_bucket_all_gather``; then
             ``ZeroBoundary.commit_local`` with ring-buddy mirrors,
             ``StepSnapshot.commit``, ``PersistPlane.commit`` (period 0)
             and ``elastic_step``.  ``KF_CHAOS_SPEC`` kills old rank 3
             (``mode=raise``) at its first engine collective of step 2;
             the survivors call ``recover_from_failure``, replay from
             step 1 at three ranks for steps 2-3; a ``preempt:all``
             clause fires at ``elastic_step``'s announcement of step 3,
             and two fresh peers with ``KF_PERSIST_RESTORE=1`` agree on
             the step-3 manifest, restore their shares and take step 4.
             Checks: (a) each survivor's ``PeerFailureError`` names rank
             3 within the peer deadline plus slack, every thread join
             bounded; (b) three peers at cluster version 1 with one
             digest, the shrunk cluster on the config server; (c) the
             agreed replay step 1, its params bitwise step 1's; (d) the
             re-carved momentum bitwise the step-1 state repadded into
             three chunks (rank 3's chunk from its ring buddy); (e)
             steps 2-3 bitwise a fixed world of three fresh peers; (f)
             the manifest's state bitwise step 3's repadded into two
             chunks, and step 4 bitwise a fixed two-rank world; (g) exact
             launches every step; (h) finite, falling loss.  Step ms at
             4, 3 and 2 ranks split into grads, D2H, reduce-scatter,
             update, all-gather and commits; detection, ping sweep,
             consensus, replay, re-carve, place, persist and restore
             times; pinned bytes, peak memory.
14. gossip — pair averaging on phase 10's bert_base(), batch and loss
             over four ``Peer``s from ``start_local_cluster(4,
             devices=["cuda"])`` (native channels, TCP on loopback), one
             thread each, inner ``sgd(1e-3, momentum=0.9)``, rank r's
             params the shared init perturbed by its own generator; the
             ranks' forward and backward run in turn on the main thread
             (in (b) under one lock).  (a) ``PairAveragingOptimizer``, f32
             wire, roundrobin, three steps in lockstep (a barrier after
             the pulls and after every step): every pulled buffer bitwise
             the version its target published, every peer's params
             bitwise a single-thread replay of the recurrence on the card
             with no wire, step 1's params within phase 10's tolerance of
             the same step under ``KF_TPU_ATTN=xla`` (the gradient's
             distance reported), exact launches.  (b)
             ``AsyncPairAveragingOptimizer``, bf16 wire, random targets,
             ``max_staleness=4``, ten free-running steps a peer: every
             taken buffer bitwise one version another peer published (a
             digest a version), at least nine averaged steps a peer, no
             landing reused past the bound, every puller joined within
             its bound at ``close()``, the cross-peer spread after ten
             steps below ten local steps', a falling mean loss, exact
             launches.  Step ms split into grads, pull, H2D, average +
             update and D2H + publish, pull GB/s and its share of the
             step, fused bytes, pinned bytes, peak memory;
15. adapt  — (a) ``DeviceBanditDriver(comm, check_every=2, min_pulls=1)``
             over psum, two_stage, ring and pallas_ring on S-SGD steps of
             bert_base() over four co-resident ranks (the fused gradient
             and the loss mean-allreduced through ``comm.all_reduce``, the
             large and the small bucket), fourteen steps: every arm of
             the large bucket measured; each arm's reduced gradient
             within 1e-6 relative L2 of psum's; pallas_ring's ring
             reduce-scatter and all-gather launches exact; every hook
             latency at least the CUDA-event time of its own collective
             (events recorded inside the hook's window); each bucket's
             installed arm equal to ``ArmStats.select`` recomputed from
             ``summary()``; one ``swap`` event per bucket and swap with
             the reference's fields; falling loss.  (b) bench.py:1285
             payload_adapt's scenario on three port peers: 200 KiB f32,
             ``delay:ms=30`` on the 0<->1 link for send and ping,
             ``KF_NATIVE_ENGINE=0``, ``HostBanditDriver(check_every=2,
             min_pulls=1, min_swap_collectives=1)``, forty steps after
             ten of each fixed strategy: lockstep swaps, one ``swap``
             event a rank at every swap seq, one final arm, each MST
             install equal to ``minimum_spanning_tree`` of the agreed
             latency matrix and without the 0-1 edge, exact values; the
             steady step against the best fixed strategy is recorded,
             not checked.  (c) ``AdaptiveStrategyDriver`` and
             ``monitored_all_reduce`` on the same peers: one interference
             vote on every rank, lockstep swaps, exact values.
16. serve  — the serving plane on the flagship (bench.py:1869
             payload_serve's deployment at full width and depth; bf16,
             ``max_batch=4``, ``max_seq=512``, 16-token pages, 256 a
             pool), on the Python transport.  (a) seven ``Peer``s from
             ``start_local_cluster(7)``: six ``ServeWorker``s (one
             ``InferenceEngine`` each on the card, one params tree,
             flat out) and a ``ServeRouter`` with ``SliceTopology(3,
             2)``, ``commit_every=4``, ``queue_depth=512``,
             ``deadline_s=2.0``, ``strike_limit=2``; every request a
             shared 64-token system prompt plus 8 seeded tokens, 24 new
             tokens; each worker's thread warmed by traffic; the offered
             rate (fixed period) half of what two workers sustain on a
             saturating burst; S1 and S2 chosen from the decode cadence
             measured at that rate; the arrivals submitted from a pool
             of threads; ``KF_CHAOS_SPEC`` kills rank 1 at its
             iteration S1 and slice 1 at S2.  Checks: no accepted request
             lost; both kills observed in the router's dead set, slice 0
             excluded whole at the first and slice 1 at the second; at
             least one replay; p99 e2e after recovery at most 2.0 x p99
             before the first kill, over at least 30 requests each (its
             ratio to the p99 of ranks 4 and 5 alone at the offered rate
             before the kills is reported);
             computed prefill tokens below the no-cache cost; every
             answer teacher-forced through ``model.apply`` (the flash
             kernel) within ``GREEDY_MARGIN`` of top-1 at every
             position; every replayed answer starting with its committed
             tokens.  (b) a ``ConfigServer`` with a ``ClusterAggregator``
             and four peers with ``KF_CONFIG_ENABLE_CLUSTER_MONITOR=1``:
             ``ServeFleet`` with ``ServeAutoscalePolicy(scale_up_queue=2,
             cooldown_steps=0)``, a ``BatchWidthController`` on each live
             engine, a burst of 16 on the one live worker; fleet ticks
             from ``GET /cluster`` spawn a worker (a new engine warmed on
             the card), which serves, and idle ticks retire it; the
             view's serving rollup counts completions, each live
             worker's rank reports its own pool's ``kf_kv_cache_bytes``
             and ``kv_bytes`` is their sum.  (c) a second ``warmup()``
             to 512 tokens captures only the new prefill buckets; a
             70-token answer's pages through ``PersistPlane`` to disk
             and into a fresh engine's pool: restored with none
             rejected, the prompt again reusing its four whole pages
             within ``GREEDY_MARGIN``, a page with one flipped byte
             rejected.  The served traffic launches no kernel (the
             engines' attention is the plain softmax); the teacher-forced
             checks launch the flash forward.  p50/p99 per phase, TTFT,
             decode iteration ms per worker, tokens/s, kill -> dead s,
             spawn s, widths, flash launches, peak memory.
17. sharded — the in-mesh 4-D plan (``ShardedTrainer``) in lockstep over
             sixteen co-resident ranks of the card, under
             ``KF_TPU_XENT=fused`` with TF32 off.  (a) the flagship at
             full width and depth (``max_seq`` 1024),
             ``ParallelPlan(dp=2, pp=2, sp=2, tp=2, n_micro=2,
             collective_schedule="pallas_ring")``
             (``MeshPlan.auto(16)``), ``sgd(0.01)``, the seeded batch
             [8, 1024]; params carried from one rank's
             ``Transformer.init`` by ``from_transformer_params``.  Its
             references: the one-rank model (flash, fused xent) stepped
             the same way, and the same sharded trainer run once through
             the kernels' plain versions (``_PlainFlash``,
             ``KF_TPU_XENT=plain``, the ``psum`` schedule; no launch).
             Checks: ``trainer.loss`` against both within
             ``SHARDED_LOSS_RTOL`` (beside two control readings, the
             one-rank loss in f32 and without the causal mask); step 1's
             launches exact (per layer and tick, one diagonal flash
             launch over every rank's rows and one full launch over the
             sp-1 ranks'; one xent launch each way over every last-stage
             rank's rows; one ring reduce-scatter and all-gather per
             leaf and dp group); every replica of the synchronized
             first-step gradient and of the params after the steps
             bitwise equal to its replica at index 0 of the axes that do
             not shard its leaf; that gradient, reassembled, against
             both references per leaf; five steps of finite, falling
             loss, each within ``SHARDED_LOSS_RTOL`` of the one-rank
             model's and the fall within ``SHARDED_GRAD_REL_L2`` of its
             fall.  Step ms (median of CUDA-event windows over steps
             2-5), tokens/s, peak memory, and a ``profile.py`` trace of
             two more steps (kernels per step, device idle share).  (b)
             the flagship's widths in f32, two layers a stage, on dp2
             sp2 tp2 and dp2 pp2 tp2: loss within 1e-5 and the params
             after one ``sgd(0.05)`` step within rtol 2e-4 / atol 2e-5
             of the one-rank model's.  (c)
             ``ring_attention(block_impl="flash")`` over four sp ranks
             at [2, 12, 4096, 64] bf16, causal and bidirectional:
             forward and q/k/v gradients against the same ring through
             the plain flash versions (the same dlse shift) and against
             dense f32 attention; ``kv_gather="pallas_ring"`` against
             dense.  (d) ``moe_apply`` over dp against local routing at
             f32 within 2e-5, and a four-expert MoE trainer on dp2 sp2
             tp2 at the flagship's width, two layers, three steps of
             falling loss. The phase's main path is (a)'s loss and five
             steps.
18. pipeline — the cross-host pipeline (``parallel/pp.py``) on the
             flagship at full width and depth (``max_seq`` 1024), under
             ``KF_TPU_XENT=fused`` with TF32 off: ``HostPipeline`` over
             four ``Peer``s from ``start_local_cluster(4,
             devices=["cuda"])`` in two emulated slices of two
             (``MEGASCALE_NUM_SLICES=2``, ``KF_SLICE_RANKS=2``), one
             thread a rank, the Python transport with
             ``KF_NATIVE_ENGINE=0`` and 30 ms of chaos delay on every
             engine send (bench.py:2099 payload_pp's wire);
             ``ParallelPlan(pp=2, dp=2, n_micro=4, zero_stage=2)``,
             ``sgd(0.05, momentum=0.9)``, each dp lane a [8, 1024]
             batch from seed 0; every rank runs ``warmup`` first.  (a)
             three steps of 1F1B, three of sequential and two of
             interleaved (two chunks a stage), each from the same start:
             1F1B and sequential params bitwise equal; each schedule's
             params and losses bitwise ``reference_pipeline_step`` run on
             the card for its plan; launches of rows 1-5 exact per step
             (per lane, the flash forward m(2 L0 + L1), dQ and dK/dV m(L0
             + L1), each xent kernel m); the first loss within
             ``PIPE_LOSS_RTOL`` of the one-rank flagship
             ``Transformer.loss`` on each lane's rows; the first loss and
             reduced gradient (``pipeline_gradients``) against the same
             step through the flash kernels' plain versions and
             ``KF_TPU_XENT=plain``, no launch (phase 17's limits).  Step
             ms (median), 1F1B over sequential, xray's ``pp_bubble``
             share of the ranks' wall, tokens/s over both lanes, peak
             memory.  The four ranks share the card, its default stream
             and autograd's device thread (ROADMAP C8), so these are
             the port's own times, not a cross-host pipeline's.  (b) two
             steps, then ``commit_boundary``, ``StepSnapshot.commit`` and
             ``replicate_ring``; ``die_slice:slice=1,step=2,mode=raise,
             rps=2`` with ``KF_CONFIG_PEER_DEADLINE=12``
             (tests/test_pp.py:761's drill); the survivors call
             ``Peer.recover_from_failure(stage_boundary=...,
             snapshot=...)`` to one stage on dp 2 (the dead stage's
             params from the lane's own mirror: no param byte on the
             wire) and take two steps, bitwise a fixed one-stage world
             replayed from the same boundary; kill -> PeerFailureError
             s, the re-carve's s and bytes, step ms at pp 2 and pp 1.
             (c) ``pp=2, dp=1, tp=2`` at the flagship's widths with four
             layers, one step bitwise ``reference_pipeline_step`` with
             the same plan.  The phase's main path is (a)'s timed steps.

19. images — the image models and the data plane, seeded from numpy
             seed 0, under TF32 off.  (a) bench.py:165 payload_resnet's
             step at full width: ``ResNet(50, 1000)`` (width 64), f32
             params, bf16 compute, 64 standard-normal images at 224 x 224
             and random labels, ``dp_train_step(loss_fn,
             synchronous_sgd(sgd(0.1, momentum=0.9), comm.axis), comm,
             has_aux=True)`` over ``Communicator(devices=["cuda:0"])``:
             three warm-up steps, eight timed by CUDA events, one under the
             profiler; images/s, TFLOP/s from the conv and dense shapes (2
             per multiply-add, the training step 3x the forward: 24.5
             GFLOP an image), peak memory, kernels a step, falling loss,
             and no ``aten::clone`` of an activation but the backward of
             the four asymmetric SAME pads (convolutions run on permuted
             ``channels_last`` views).  (b) the same step on four
             co-resident ranks of the card, 64 images each,
             ``schedule="pallas_ring"``: one ring reduce-scatter and one
             all-gather for each of ResNet-50's 161 gradient leaves (f32,
             64 to 2,359,296 elements), exactly 161 launches of each a
             step; the reduced gradient bitwise the plain ring's on the
             same stacked per-rank gradients (reduced twice, not
             recomputed: cuDNN's backward is not deterministic); the
             params replicated bitwise (``CHECK_REPLICAS``), the BN aux the
             mean of the four ranks'; images/s on the card, the reduce's
             and the ring kernels' share of the step.  (c) f32, 8 images:
             the card's eval logits, training loss and new BN state
             within ``IMG_F32_REL_L2`` relative L2 per leaf of the CPU
             path's (the one tier-1 holds against the JAX package), each
             leaf of its first gradients within ``IMG_F32_COND`` times
             the card's own spread on that leaf when the params move by
             6e-8 (floored at ``IMG_F32_REL_L2``: the train-mode gradient
             at init is that ill-conditioned in its batch-norm leaves),
             and the gradients of one full-width block (s1b0) in train
             mode within ``IMG_F32_REL_L2``; sync-BN over four lockstep
             ranks against one BN on the concatenated batch at ``rtol
             2e-5``.  (d)
             ``ImageNetFolder``'s synthetic fallback at 224, rank 0 of 4
             through its ``ElasticDataset``, feeds three of (a)'s steps
             through ``prefetch_to_device(device="cuda")`` (pinned copies
             on a side stream), with the ``input`` span's stall per step;
             ``mnist_slp()`` under ``synchronous_sgd(pallas_ring)`` over
             four co-resident ranks on ``synthetic_mnist``, each rank an
             ``ElasticDataset`` shard, through ``prefetch_to_device``:
             accuracy rises.  (e) VGG-16 with batch norm, batch 32 at 224,
             S-SGD on one rank: falling loss, images/s, peak memory.  The
             phase's main path is (b)'s steps.

20. kfrun  — the port's launcher on the card.  (a) ``python -m
             kungfu_tpu_torch -np 4 -H 127.0.0.1:4 -monitor -sentinel
             DIR`` runs four
             processes of this script in its worker mode
             (``--kfrun-worker``): each builds phase 10's bert_base() with
             seed 0 on the card, takes KFRUN_STEPS steps an epoch for
             KFRUN_EPOCHS epochs on [BERT_ROWS, BERT_SEQ] batches drawn
             from (seed, epoch, step, rank), flash attention and the xent
             kernels, its gradient D2H into a pinned buffer,
             mean-allreduced by ``kf.init()``'s ``peer.engine()`` and
             applied with ``sgd(1e-3, momentum=0.9)``; heartbeats through
             ``monitor/signals.py``; rank 0 writes an npz checkpoint of
             the params, the momentum and the epoch at each epoch end.
             Every step's net-monitor egress equals the bytes the engine's
             graphs send, exactly (both count payload bytes, no frame
             header); rank 0's first step is held against the kernels'
             plain versions.  While it runs the phase scrapes the builtin
             config server's ``/cluster`` (four fresh ranks) and
             ``/metrics`` and each worker's metrics server (egress and
             ingress per peer, a rate) and ``/alerts`` (200); after it
             the sentinel's ``cluster`` stream under DIR holds a sample
             for each push period and ``python -m
             kungfu_tpu_torch.monitor.kfhist --dir DIR --verdict`` exits
             0.  (b) the same with ``-auto-recover
             30s`` and ``--die-at-epoch 1``: rank 1 exits with
             ``DIE_EXIT_CODE`` after its first step of epoch 1 while its
             peers wait in the engine; the runner kills the group, waits
             for its exit and relaunches with ``--n-epochs 2 --restart
             1``; the workers restore the checkpoint and finish, and every
             epoch's losses and every rank's final params (device
             digests) equal (a)'s bit for bit.  Spawn to first step, step
             ms and the allreduce's share, death to the runner's verdict
             and to the group's exit, exit to the relaunched first step,
             the restore's ms and both walls are printed.

21. sentinel — the sentinel plane and the trace tools on the flagship
             (seed 0, ``KF_TPU_XENT=fused``).  (a) bench.py:2714
             payload_sentinel: three port peers (``KF_NATIVE_ENGINE=0``,
             the Python transport) each take the flagship's forward and
             backward at [P21_BATCH, P21_SEQ] (rows 1-5) and allreduce the
             first P21_GRAD_ELEMS f32 of the flat gradient on the host
             with STAR (held to the three slices' sum), paced at
             P21_PACE_X times the slowest of P21_WARM warm steps; a
             fake-clock ``ClusterAggregator`` with ``Sentinel.from_env()``
             (window P21_WINDOW) takes one sample a step.  Three chaos
             ``delay`` clauses on the 0<->1 link arm at step P21_CLEAN,
             ``wire_ms`` chosen so rank 1's legs exceed the pad by
             P21_WIRE_MARGIN of the pace.  No alert before the onset;
             ``regress:step_time_s`` exactly once within two windows;
             ``kf_alerts_total`` and the ``alert`` event; the incident's
             xray culprit rank 1 over chaos events on 0<->1 only;
             ``kfhist --verdict --upto`` equal to the incident's
             verdicts; a ``ConfigServer`` answering ``/alerts`` and
             ``/decisions``; kftop's alerts section; ``sentinel_signals``.
             (b) payload_pulse part B: ``HostBanditDriver`` on three
             peers under a 30 ms 0<->1 delay, one ledger record a step;
             the ranks agree on the arm, a ``bandit-host`` swap onto it
             is judged ``improved``, ``replay_effects`` recomputes every
             verdict, one ``decision`` event a swap.  (c) an
             ``InferenceEngine`` warmed before the sentinel's warmup, then
             one capture after it: ``watermark:recompile_steady`` fires
             once, a later sample fires nothing.  (d) ``device_trace``
             around one training step of rank 0: rows 1-5 in the trace
             with the wrappers' launch counts, ``trace_report()``'s
             ``@traced`` count; kftrace over (a)'s three dumps names rank
             1 the slowest in the faulted steps and the incident's
             culprit, and its Chrome trace loads back.  (e) the torch
             shim on three peers: ``broadcast_parameters`` makes the
             ranks' flagship params bitwise equal on the card, one
             ``SynchronousSGDOptimizer(torch.optim.SGD)`` step on three
             batches leaves them bitwise equal and within ``rtol`` 1e-6
             of plain SGD on the mean gradient, every tensor on the card.
             The phase's main path is (a), (d) and (e).
22. analysis — the port's kf-lint and kf-verify (``python -m
             kungfu_tpu_torch.analysis``) in subprocesses over this
             checkout: (a) every ported rule with no baseline, and (b)
             ``--proto`` (the protocols proved over every
             ``ParallelPlan`` geometry up to 16 ranks), each exit 0 with
             no finding, each checker's findings and seconds printed;
             (c) the same linter over a tmp copy of ``kungfu_tpu_torch/``
             with one planted fault per rule family
             (``kungfu_tpu_torch.analysis.mutations``) exits 1 with
             exactly those findings.  The three runs start together.
             (a) runs all nineteen rules.  (d), on the card meanwhile,
             the capture rule's premise: a tiny function with an
             ``.item()`` fails to capture under ``torch.cuda.graph``
             (its capture runs on a thread of its own, thread-local
             capture mode, so nothing of it outlives the failure), the
             same function without the sync captures and replays with
             the right values, and jit-sync over the same source
             flags exactly the ``.item()`` line.  Launches no kernel of
             the port.
23. world  — the multi-process device world: four worker processes of
             one provisioned world on the card (``python -m
             kungfu_tpu_torch -np 2 -H 127.0.0.1:4 -w -device-world``,
             ``python3 chip_smoke.py --world-worker`` each), active
             2 -> 4 -> 2, one communicator across the active processes
             through CUDA IPC.  Each epoch: bert_base() S-SGD steps under
             pallas_ring (rank 0's first step against the plain
             versions); (a) bert_base() ZeRO-3 steps under pallas_ring,
             its parameter shard and momentum re-carved at each resize
             by ``zero_snapshot`` / ``zero_reshard``, one ``kf_ring_ag`` a
             bucket in the forward and one ``kf_ring_rs`` in the
             backward in each process, the first step's mean gradient
             (its momentum) against the plain mean gradient leaf by leaf
             and its params SGD's apply of it bit for bit; at four
             processes the ring kernels across processes bitwise the
             stacked ring and the plain versions,
             (b) per-replica SMA (its weight average by psum) from
             replicas set apart, each rank's first-step gradient and
             update against the plain SMA step, and (c)
             ``ShardedTrainer`` on the flagship over dp=2 x tp=2
             spanning the four processes (``devices=comm``: tp's pair
             sums across processes through ``lift`` in its forward and
             its backward, the loss's mean over dp x tp is
             differentiated through ``lift``'s backward, dp's gradient
             sync runs the ring kernels), its first
             loss and synchronized gradient against the one-rank
             model's, its params SGD's apply of that gradient bit for
             bit.  Every process's loss bitwise its epoch's, exact
             launches a step, the sharded trainer's gathered params one
             digest in every process.
24. examples — the reference's example entry points
             (``kungfu_tpu_torch.examples``), each through its
             ``main(argv)`` in this process, its launches counted from
             zero: (a) ``long_context`` at the flagship's width (d_model
             768, 12 layers, 12 heads, d_ff 3072, learned positions,
             bf16) over four co-resident sp ranks with ``--block-impl
             auto``, first at S = 2048 (its own check of the ring loss
             against the dense loss), then at S = 32768, batch 1, three
             Adam steps: the first loss against the same ring through
             the plain einsum blocks (forward only, two heads at a
             time), the loss falls, rows 1-3 launch inside the ring;
             rows 1-3 held against their plain versions and timed at
             the ring round's [48, 8192, 64]; tokens/s, step ms, peak
             memory; (b) ``shard_train`` at its defaults (dp 2, sp 2, tp
             2), dense and with four experts; (c) ``strategy_tour
             --steps 18`` on eight co-resident ranks (one re-tune, ZeRO-1
             at 1/8; the autotune's probes launch rows 9-10, counted
             apart from the main path's launches, and install psum); (d)
             ``serve_demo`` at its defaults in a fresh process, its
             outcome read (its dead-list assertion depends on timing,
             ROADMAP C42), then ``serve_demo --tokens 96``
             (``EX_SERVE_ARGS``): no request lost through the chaos
             kill, a replay equal to greedy decoding through the flash
             forward (16-wide heads zero-padded to 32).
25. cluster — the compose-style elastic cluster:
             ``scripts/cluster_torch.py`` at the reference harness's
             defaults (an external config server, a watch runner on each
             of 127.0.0.1 and 127.0.0.2 with two slots, ``elastic_mnist``
             through ``2:3,4:3,2:3``) with ``--backend gpu``, in a
             session of its own under a 120 s limit: exit 0, its JSON
             line ``ok`` with sizes [2, 4], the runner of 127.0.0.2 at 0,
             2 and 0 workers a stage, every worker's params on
             ``cuda:0``, rank 0's loss falling, and no process of the
             cluster alive afterwards; the card's memory in use before
             and at its peak.  No kernel of rows 1-10 launches there (the
             SLP's loss takes the plain path).  A failure names the
             phase and stage and prints the harness's output, the tails
             of the server's and runners' logs and the card's memory in
             use before the ``FAIL:`` line.
26. head widths — the port's entry points at two public models'
             widths, from seed 0, four layers each: ``pythia_2p8b_w``
             (vocab 50304, d_model 2560, 32 heads of 80, d_ff 10240; the
             heads run zero-padded to the 96-wide kernels) and
             ``pythia_1b_w`` (vocab 50304, d_model 2048, 8 heads of 256,
             d_ff 8192), causal, RoPE, bf16.  For each: (a)
             ``Transformer.apply`` at ``[4, 256]``, its logits against
             ``KF_TPU_ATTN=xla`` within phase 4's tolerance; (b) an
             ``InferenceEngine`` answering four greedy requests, each
             token within phase 5's margin of the flash forward; (c)
             phase 6's one-rank step at ``[2, 2048]`` (plain head, fused
             cross-entropy, ``sgd(0.05, momentum=0.9)``), its first-step
             gradients against the kernels' plain versions (5e-2
             relative L2 per leaf but the q/k weights, phase 20's rule),
             the loss falling over three steps.  Rows 1-3 launch exactly
             four times a forward or a step in (a) and (c); each part's
             ms and tokens/s, the card's memory in use before the phase
             and at its peak.

Phase 3 also holds the ring reduce-scatter and all-gather kernels
bitwise against their plain versions, at the main path's shapes (a
262,144-column bucket over four ranks, the fused [4, 134,404,608]
gradient, and phase 17 (a)'s widest leaf, the embedding table, over two
ranks), at the reference suite's edges and at rows the kernels'
vector loads cannot take whole (a base off 16 bytes, a row stride off 4
elements, odd chunks and cuts, k = 16; 2-, 4- and 8-byte elements for
the all-gather), and times each with its host µs per launch, also at
phase 11's two-rank bucket (524,288 columns).  The fused
LM head's cases other than the flagship's (``LMH_CASES``: all-bf16,
all-f32, ragged N, D and V, clusters of three, four and eight CTAs for
the wgmma dh and dW kernels, and bf16 h with D past the largest
cluster, where dh and dW take the SIMT kernels) each run in a process
of their own (``python3 chip_smoke.py --lm-head-case NAME``), all
started together, so that a kernel that hangs or faults names its case.

Each path's launches are counted from zero just before it runs.  Each
phase starts with a ``phase <n> <name>: start <time>`` line.  It
prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Imports neither jax nor kungfu_tpu.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

#: bf16 kernel vs plain version: both round O once to bf16 (half an ulp
#: is 2^-9 relative, |O| < 4 here), and P is rounded to bf16 against the
#: running max in the kernel but the global max in the plain version
BF16_O_ATOL = 2e-2
#: lse is f32 from f32-accumulated scores in another summation order
BF16_LSE_ATOL = 1e-3
#: f32: the reference kernel's own tolerance (tests/test_pallas.py)
F32_ATOL = 2e-5
#: flagship logits, flash kernel vs plain attention, both bf16: the two
#: round attention outputs differently and the difference travels
#: through 12 layers; logits have a spread of about 0.2 here
LOGITS_ATOL = 5e-2
#: serving vs full-context greedy: where the engine's token is not the
#: reference's top-1, the reference's top-1 logit may beat the engine's
#: token by at most this (the same bf16 noise as LOGITS_ATOL)
GREEDY_MARGIN = 5e-2

#: flash backward, f32: the reference's own tolerances
#: (tests/test_pallas.py:61-145) against the blocked plain version on the
#: same saved (O, lse) and against autograd through plain attention
F32_GRAD_ATOL_BLOCKED = 2e-4
F32_GRAD_ATOL_AUTOGRAD = 5e-4
#: flash backward, bf16, as a share of the largest |gradient|: the kernel
#: rounds dO V^T's inputs, P and dS to bf16 (half an ulp is 2^-9
#: relative) and writes dQ/dK/dV in bf16, where the plain versions keep
#: f32 throughout; each gradient sums up to 2048 such terms, so a few
#: ulps at the top of the range (2^-7 relative is 0.8%) is the expected
#: difference, and 2e-2 leaves room for the longest rows
BF16_GRAD_RTOL = 2e-2
#: xent loss against the one-pass plain version: the reference kernel's
#: own tolerances (tests/test_pallas.py:181-225)
XENT_LOSS_ATOL_F32 = 1e-4
XENT_LOSS_ATOL_BF16 = 1e-3
#: dlogits against the blocked plain version: f32 as the reference's
#: kernel test; bf16 within one bf16 rounding of the largest |dlogit|
XENT_DLOGITS_ATOL_F32 = 2e-5
XENT_DLOGITS_RTOL_BF16 = 2 ** -8
#: first-step gradients, flash + fused xent against plain attention +
#: plain xent, relative L2 per leaf (denominator floored at 1e-3 of the
#: largest leaf's norm: the key biases' gradient is zero in exact
#: arithmetic, as softmax ignores a per-row shift, so both paths return
#: rounding noise there).  The plain attention rounds its scores to bf16
#: before the softmax, the kernel keeps them in f32; that 2^-9 relative
#: noise on the scores travels through 12 layers of bf16 activations
TRAIN_GRAD_REL_L2 = 5e-2
#: fused LM head, loss and lse against the plain version: the reference's
#: own tolerances (tests/test_pallas.py:384-386), |d| <= atol + rtol|ref|;
#: both sides take f32 products (exact for bf16 operands) in another
#: summation order, so they hold in every dtype case
LMH_LOSS_RTOL, LMH_LOSS_ATOL = 2e-5, 1e-6
#: f32 dh and dW: |d| <= rtol|ref| + share * max|ref|, the reference's
#: rtol 1e-4 (:393-395) plus an absolute term scaled to max|grad|: at
#: N = 8192 a dW element sums 8192 f32 terms (a dh element 32128) in
#: another order than cuBLAS, each addition rounding at 2^-24 of a
#: running sum up to max|grad|, so an element that cancels to near zero
#: keeps about sqrt(8192) * 2^-24 = 5.4e-6 of max|grad| of absolute
#: error; the share is twice that
LMH_GRAD_RTOL_F32, LMH_GRAD_ATOL_SHARE = 1e-4, 1e-5
#: bf16 dh and dW: both sides round an f32 sum once; where the two sums
#: straddle a rounding boundary they differ by one bf16 ulp, at most
#: 2^-7 of the value (equal at a power of two); the tolerance is two ulps
LMH_GRAD_RTOL_BF16 = 2 ** -6
#: Transformer.loss against the step's own first loss: the same
#: computation reached through the model's dispatch
MODEL_LOSS_RTOL = 1e-4
#: four ranks' mean loss against phase 6's one-rank loss over the same
#: tokens and params: the same sum of 8192 token losses, taken as four
#: f32 means of 2048 and their mean instead of one mean of 8192
RANKS_LOSS_RTOL = 1e-5
#: the four ranks' reduced first-step gradient against phase 6's
#: one-rank gradient, relative L2 per leaf (floored as for phase 6): the
#: ranks run the same kernels on [1, 2048] slices of phase 6's [4, 2048]
#: batch, so only the GEMMs' tiling at another M and the order of the
#: f32 sums over tokens differ; a bf16 activation that rounds the other
#: way in one layer travels through the rest, and the key biases'
#: gradient is rounding noise in both (zero in exact arithmetic)
RANKS_GRAD_REL_L2 = 5e-2
#: ZeRO params after one step against S-SGD's when they are not bitwise
#: equal: the reference's own tolerance (tests/test_zero.py:70-72)
ZERO_RTOL, ZERO_ATOL = 1e-5, 1e-6

FLAGSHIP = dict(vocab_size=32128, d_model=768, n_layers=12, n_heads=12,
                d_ff=3072, max_seq=512, causal=True, pos="rope",
                dtype="bfloat16")
#: the training path: bench.py:payload_lm's gpt_small at ids [4, 2048]
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 10
#: co-resident ranks of phases 8 and 9: one batch row each
RANKS = 4
#: f32 parameters of gpt_small(max_seq=2048); the 4-rank ring chunk
FLAGSHIP_PARAMS = 134_404_608

#: phase 11: the step-based resize schedule (size:steps, KungFu's
#: ``step_based_schedule`` form) of gpt_small under ZeRO-2 on one card,
#: and its inner optimizer: adam, so the committed boundary carries a
#: replicated scalar leaf (``count``) beside the two vector leaves
ELASTIC_SCHEDULE = "4:3,2:3,4:2"
ELASTIC_LR = 3e-4

#: phase 10: bert_base() (vocab 30528, learned positions, bidirectional)
#: on RANKS co-resident ranks, 8 x 512 tokens a rank; the inner
#: optimizer of benchmarks/system.py:103, sgd(1e-3, momentum=0.9)
BERT_ROWS, BERT_SEQ, BERT_VOCAB = 8, 512, 30528
BERT_PARAMS = 132_340_224
BERT_LR, BERT_MOMENTUM = 1e-3, 0.9
SMA_ALPHA = 0.1
ADA_CHANGE_STEP = 5
MONITOR_STEPS = 5
#: square norms and the variance, f32 on the card against f64 on the
#: host: sums of 132M squares a rank in another order, each rounding at
#: 2^-24 of a running sum (about sqrt(132M) * 6e-8 = 7e-4 relative at
#: worst for a sum of like-signed terms); the raw GNS divides a
#: difference of two such sums, so its error is larger
GNS_SQ_RTOL = 1e-3
GNS_RTOL = 1e-2
#: phase 12: main-path steps of the host engine before the two strategy
#: swaps (cut from 6 to make room for phase 24, then to 3, and to 2 for
#: phase 25); ZeRO-2's host bucket (columns a rank) and (c)'s slice
HOST_STEPS = 2
HOST_BUCKET = 1 << 20
HOST_SLICE_BYTES = 16 << 20
#: phase 12's params after one step against the device-plane S-SGD step,
#: relative L2 per leaf: only the order of the f32 four-term mean differs
HOST_PARAMS_RTOL = 1e-5
#: an allreduce mean under the autotuned schedule against psum's: four
#: f32 values summed in another order, rounded once each
AUTOTUNE_RTOL, AUTOTUNE_ATOL = 1e-5, 1e-6
#: phase 14: pair-averaging gossip on bert_base() over four peers: the
#: steps of the blocking optimizer (lockstep) and of the async one (free
#: running), the async run's staleness bound, and the absolute
#: perturbation of each rank's copy of the shared init (rank r draws
#: from its own generator, so the models differ)
GOSSIP_BLOCKING_STEPS = 3
GOSSIP_ASYNC_STEPS = 10
GOSSIP_STALENESS = 4
GOSSIP_PERTURB = 1e-3
#: async steps that must average with a landed model, of the ten: the
#: first blocks for its landing, so all ten should
GOSSIP_MIN_AVERAGED = 9
#: phase 15: device-bandit steps at check_every 2, so that every arm of
#: the large bucket is installed, settles for a window and is measured
#: in the next (four arms x two checks, ending on a check), and the
#: relative L2 of every arm's reduced gradient against psum's: four f32
#: terms summed in another order, rounded once each
ADAPT_STEPS = 14
ADAPT_CHECK_EVERY = 2
ADAPT_ARM_REL_L2 = 1e-6
#: phase 15's CUDA events are recorded inside the latency hook's window,
#: so the hook's seconds can fall short of the events' time only by the
#: events' resolution (0.5 us)
HOOK_EVENT_RESOLUTION_S = 1e-6
#: phase 15 (b)-(c): bench.py:1285 payload_adapt's scenario (three
#: peers, 200 KiB f32, 30 ms on the 0<->1 link for send and ping)
HOST_ADAPT_ELEMS = 50_000
HOST_ADAPT_WIRE_MS = 30
HOST_ADAPT_FIXED_STEPS = 10
HOST_ADAPT_STEPS = 40
HOST_ADAPT_FIXED_ARMS = ("STAR", "RING", "BINARY_TREE_STAR")
DRIVER_STEPS = 12
#: phase 19: bench.py:165 payload_resnet's step at full width (ResNet-50,
#: width 64, 1000 classes, 224 x 224, bf16 compute over f32 params, batch
#: 64 a rank, sgd(0.1, momentum=0.9)); its 161 parameter leaves, each one
#: ring reduce-scatter and one all-gather under pallas_ring
IMG_HW, IMG_BATCH, IMG_CLASSES, IMG_LR = 224, 64, 1000, 0.1
IMG_WARMUP, IMG_STEPS, IMG_RANK_STEPS, IMG_DATA_STEPS = 3, 8, 3, 3
RESNET_LEAVES = 161
#: (c): the card's f32 path (TF32 off) against the CPU's on 8 images,
#: relative L2 per leaf: cuDNN and the CPU's convolutions sum in other
#: orders (about 1e-6 a layer).  The forward (logits, loss, BN state)
#: holds 1e-3.  The first gradients at init do not: params nudged by 6e-8
#: move the card's own gradient by 3.4% (a batch-norm scale or bias sums
#: terms the next batch norm cancels), and the CPU's with and without
#: oneDNN differ by 2.1% (both on the H100's host), so each leaf is held
#: within IMG_F32_COND times the card's own spread on it under such a
#: nudge, and one well-conditioned block's gradients hold 1e-3
IMG_F32_BATCH, IMG_F32_REL_L2, IMG_F32_COND = 8, 1e-3, 4.0
#: (d): the SLP on synthetic_mnist, 64 rows a rank, two epochs
MNIST_BATCH, MNIST_EPOCHS, MNIST_LR = 64, 2, 0.5
#: (e): VGG-16 with batch norm, one rank
VGG_BATCH, VGG_STEPS, VGG_LR = 32, 4, 0.01


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}")
    check(out.returncode == 0, f"nvidia-smi exited {out.returncode}: "
          f"{out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int = 20, windows: int = 21) -> float:
    """Median over ``windows`` CUDA-event windows of the device time of
    one ``fn()`` in ms.  A sleep kernel holds the stream while the host
    enqueues ``iters`` calls, so the events time back-to-back device
    work, not the host's launch overhead.  The sleep lasts three times
    the host time of the window's calls (from the warm calls), at least
    ~10 ms and at most ~50 ms at H100 clocks (~2e6 cycles a ms)."""
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    sleep = int(2e6 * min(50.0, max(10.0, 3 * iters * host_ms)))
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(spec, flops: float, nbytes: float) -> dict:
    """Least time on the card: the larger of bf16 operations over the
    dense bf16 peak and bytes over the memory rate (datasheet)."""
    t_ops = flops / spec["bf16_flops"] * 1e3
    t_bytes = nbytes / spec["hbm_bytes_s"] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


#: bf16 edge cases of the wgmma kernels' tiling (128-row q blocks and
#: kv tiles in the forward, 128 kv rows by 64- or 32-row q tiles in the
#: dK/dV kernel): sequence lengths on both sides of the tile edges
EDGE_SEQS = (1, 63, 65, 127, 129, 2047)
EDGE_BH = (1, 12)
EDGE_DIMS = (32, 64, 96, 128, 256)
#: widths between the compiled ones: the wrapper zero-pads them to the
#: next compiled width and passes 1/sqrt of the unpadded width (16 -> 32,
#: 48 -> 64 with a scale that is not a power of two, 80 -> 96, 160 ->
#: 256); on the edge grid in bf16 and in f32
EDGE_PADDED = (16, 48, 80, 160)
#: one call over more batch-heads than a launch's grid takes (65535 on
#: y): the C launchers run it as two launches of each kernel
BIG_BH_SHAPE = (70000, 65, 64)
#: the main-path shapes [BH, S, D] of the flash kernels and their mask:
#: the serving forward, the one-rank training step, one of four
#: co-resident ranks, and one BERT-base rank of phase 10 (8 x 512
#: tokens, 12 heads, bidirectional)
FLASH_SHAPES = {"s256": (48, 256, 64, True),
                "s2048": (48, TRAIN_SEQ, 64, True),
                "rank_s2048": (12, TRAIN_SEQ, 64, True),
                "bert_s512": (8 * 12, 512, 64, False),
                # phase 17's ring rounds: (a)'s diagonal round over all
                # sixteen ranks' rows (16 x 2 x 6 heads, 512 a rank), and
                # (c)'s bidirectional round (4 x 2 x 12 heads, 1024)
                "ring_s512": (16 * 2 * 6, 512, 64, True),
                "ring_s1024": (4 * 2 * 12, 1024, 64, False)}
#: phase 26's attention at its two widths, [B * H, S, D] causal: Pythia
#: 2.8B's 80-wide heads (run padded to 96) and Pythia 1B's 256-wide ones
FLASH_SHAPES.update({"pythia_2p8b": (2 * 32, TRAIN_SEQ, 80, True),
                     "pythia_1b": (2 * 8, TRAIN_SEQ, 256, True)})
#: the backward's timed shapes: the two causal training shapes, BERT's,
#: the ring's and phase 26's
FLASH_BWD_SHAPES = ("s2048", "rank_s2048", "bert_s512", "ring_s512",
                    "ring_s1024", "pythia_2p8b", "pythia_1b")


def _edge_cases():
    """(name, (BH, S, D), dtype name, causal, input scale) of the edge
    grid: bf16 at every compiled and padded width, f32 at the padded
    widths, and one case with q and k scaled by 8, so row maxima move
    across kv blocks."""
    grid = ([("bfloat16", d) for d in sorted(EDGE_DIMS + EDGE_PADDED)]
            + [("float32", d) for d in EDGE_PADDED])
    cases = [(f"edge_{dt[:4]}_bh{bh}_s{s}_d{d}_{'causal' if c else 'full'}",
              (bh, s, d), dt, c, 1.0)
             for dt, d in grid for s in EDGE_SEQS for bh in EDGE_BH
             for c in (True, False)]
    cases.append(("edge_x8_bh12_s2047_d64_causal", (12, 2047, 64),
                  "bfloat16", True, 8.0))
    return cases


def _flash_operands(torch, attention, gen, bh: int, s: int, d: int,
                    n: int = 3):
    """``n`` bf16 ``[bh, s, d]`` operands, the same zero-padded to the
    compiled width the wrapper runs ``d`` at (contiguous, as the kernels
    take them), and that width's scale."""
    import torch.nn.functional as F

    dp, scale = attention.kernel_head_dim(d)
    ts = [torch.randn((bh, s, d), generator=gen, device="cuda"
                      ).to(torch.bfloat16) for _ in range(n)]
    return ts, [F.pad(t, (0, dp - d)).contiguous() for t in ts], dp, scale


def host_us(torch, fn, calls: int = 200) -> float:
    """Host µs per call of ``fn`` (a kernel wrapper), enqueued behind a
    sleep kernel so the launch queue never blocks."""
    fn()
    torch.cuda.synchronize()
    # ~50 ms at H100 clocks: 2.5x the 200 calls of the slowest wrapper
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_flash_forward(torch, attention, spec):
    """Forward kernel vs plain version at the main shapes and the edge
    cases."""
    import torch.nn.functional as F

    cases = [
        # name, (B, H, S, D), dtype, causal
        ("main", (4, 12, 256, 64), torch.bfloat16, True),
        ("train_main", (TRAIN_BATCH, 12, TRAIN_SEQ, 64), torch.bfloat16, True),
        ("bert_main", (BERT_ROWS, 12, BERT_SEQ, 64), torch.bfloat16, False),
        ("f32_causal_ragged", (2, 4, 200, 64), torch.float32, True),
        ("bf16_noncausal", (4, 12, 256, 64), torch.bfloat16, False),
        ("bf16_d128", (2, 8, 256, 128), torch.bfloat16, True),
        ("bf16_d32_ragged_noncausal", (2, 4, 130, 32), torch.bfloat16, False),
        ("f32_d128_noncausal", (1, 2, 100, 128), torch.float32, False),
        ("f32_d32", (1, 3, 70, 32), torch.float32, True),
        # phase 17's ring rounds: (a)'s diagonal round over all sixteen
        # ranks' rows and its full round over the eight ranks of sp
        # index 1, and (c)'s bidirectional round over four ranks
        ("ring_diag", (16 * 2, 6, 512, 64), torch.bfloat16, True),
        ("ring_full", (8 * 2, 6, 512, 64), torch.bfloat16, False),
        ("ring_s1024_full", (4 * 2, 12, 1024, 64), torch.bfloat16, False),
        # phase 21's rank step
        ("p21_main", (P21_BATCH, 12, P21_SEQ, 64), torch.bfloat16, True),
        # phase 26's widths: 80 runs padded to 96, 256 as it is
        ("pythia_2p8b_main", (2, 32, TRAIN_SEQ, 80), torch.bfloat16, True),
        ("pythia_1b_main", (2, 8, TRAIN_SEQ, 256), torch.bfloat16, True),
        ("f32_d256", (1, 2, 100, 256), torch.float32, True),
        ("f32_d96_noncausal", (1, 3, 130, 96), torch.float32, False),
        # more batch-heads than one launch's grid: two launches
        ("bh70000", (1, *BIG_BH_SHAPE), torch.bfloat16, True),
    ]
    cases = ([(n, sh, dt, c, 1.0) for n, sh, dt, c in cases]
             + [(n, (1, *sh), getattr(torch, dt), c, x)
                for n, sh, dt, c, x in _edge_cases()])
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    worst = 0.0
    for name, (b, h, s, d), dtype, causal, x in cases:
        q, k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda"
                               ) for _ in range(3))
        q, k, v = ((q * x).to(dtype), (k * x).to(dtype), v.to(dtype))
        out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = attention.flash_attention_reference(q, k, v, causal)
        o_err = (out.float() - ref_o.float()).abs().max().item()
        l_err = (lse - ref_lse).abs().max().item()
        o_tol, l_tol = ((BF16_O_ATOL, BF16_LSE_ATOL) if dtype == torch.bfloat16
                        else (F32_ATOL, F32_ATOL))
        edge = name.startswith("edge_")
        if not edge:
            print(f"flash fwd {name}: shape {(b, h, s, d)} {str(dtype)[6:]} "
                  f"causal={causal} max|dO|={o_err:.3e} (tol {o_tol}) "
                  f"max|dlse|={l_err:.3e} (tol {l_tol})")
        check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite O")
        check(o_err <= o_tol, f"{name}: O error {o_err} > {o_tol}")
        check(l_err <= l_tol, f"{name}: lse error {l_err} > {l_tol}")
        results[name] = {"o_err": o_err, "lse_err": l_err}
        if edge:
            worst = max(worst, o_err / o_tol, l_err / l_tol)
        elif name == "bh70000":
            print(f"flash fwd bh70000: {attention.bh_chunks(b * h)} "
                  f"(first batch-head, count) a launch")
        del q, k, v, out, lse, ref_o, ref_lse
    # a head wider than the widest compiled one is refused on the card,
    # never run through a plain version (ROADMAP C47)
    wide = torch.zeros((1, 8, attention.MAX_HEAD_DIM + 1), device="cuda",
                       dtype=torch.bfloat16)
    try:
        attention.flash_attention_with_lse(wide, wide, wide)
    except ValueError as e:
        check(str(attention.MAX_HEAD_DIM) in str(e),
              f"the {wide.shape[-1]}-wide refusal does not name the limit: {e}")
        print(f"flash fwd head dim {wide.shape[-1]}: refused ({e})")
    else:
        raise SmokeFailure(f"a {wide.shape[-1]}-wide head ran on the card")
    n_edge = len(_edge_cases())
    print(f"flash fwd edges: {n_edge} cases (S {EDGE_SEQS} x BH {EDGE_BH} "
          f"x causal/full at D {EDGE_DIMS} and padded {EDGE_PADDED} in bf16, "
          f"the padded in f32, and q, k x8 at [12, 2047, 64]): the largest "
          f"error used {worst:.3f} of its tolerance (bf16 O {BF16_O_ATOL}, "
          f"lse {BF16_LSE_ATOL}; f32 {F32_ATOL})")

    # timing at the main-path shapes (contiguous [BH, S, D]; warm L2); a
    # padded width's kernel runs on the padded operands, the plain version
    # and SDPA on the unpadded ones
    timing = {}
    for label, (bh, s, d, causal) in FLASH_SHAPES.items():
        (q, k, v), (qp, kp, vp), dp, scale = _flash_operands(
            torch, attention, gen, bh, s, d)
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        ms = device_ms(torch, lambda: attention._launch(qp, kp, vp, causal,
                                                        scale))
        plain_ms = device_ms(torch, lambda: attention.flash_attention_reference(
            q, k, v, causal), iters=1, windows=5)
        library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
        us = host_us(torch, lambda: attention._launch(qp, kp, vp, causal,
                                                      scale))
        # each (q, k) pair needs 4*D FLOPs (QK^T and PV): s(s+1)/2 pairs
        # a row block under the causal mask, s*s without; bytes are q, k,
        # v read once, O written once (bf16), lse written (f32).  The
        # bound is the unpadded width's; a padded width's kernel does the
        # work of its compiled width (bound_executed_ms)
        pairs = bh * (s * (s + 1) // 2 if causal else s * s)
        t = bound(spec, 4 * d * pairs, 4 * bh * s * d * 2 + bh * s * 4)
        timing[label] = {"ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "host_us": us, **t}
        pad_text = ""
        if dp != d:
            ex = bound(spec, 4 * dp * pairs, 4 * bh * s * dp * 2 + bh * s * 4)
            timing[label].update(head_dim_run=dp,
                                 bound_executed_ms=ex["bound_ms"])
            pad_text = (f"; padded to {dp}: {dp / d - 1:.0%} more kernel "
                        f"work, executed bound {ex['bound_ms']:.4f} ms")
        print(f"flash fwd timing {label} [{bh}, {s}, {d}] causal={causal}: "
              f"kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{t['bound_ms'] / ms:.1%} of it); "
              f"{t['flops'] / ms / 1e9:.1f} TFLOP/s; host {us:.1f} us per "
              f"launch{pad_text}")
        del q, k, v, qp, kp, vp, q4, k4, v4
    return results, timing


def _grad_err(got, ref) -> float:
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, ref))


def phase_flash_backward(torch, attention, spec):
    """dQ and dK/dV kernels (through the autograd op, with dO and dlse
    cotangents) vs the blocked plain version and vs autograd through the
    plain forward, at the main shape and the edge cases."""
    cases = [
        # name, (B, H, S, D), dtype, causal, nonzero dlse
        ("main", (TRAIN_BATCH, 12, TRAIN_SEQ, 64), torch.bfloat16, True, False),
        ("bert_main", (BERT_ROWS, 12, BERT_SEQ, 64), torch.bfloat16, False,
         False),
        ("bf16_dlse", (2, 4, 256, 64), torch.bfloat16, True, True),
        ("bf16_noncausal", (2, 4, 256, 64), torch.bfloat16, False, False),
        ("bf16_d32", (2, 4, 256, 32), torch.bfloat16, True, False),
        ("bf16_d128_ragged", (2, 4, 200, 128), torch.bfloat16, True, True),
        ("f32_causal_ragged", (2, 4, 200, 64), torch.float32, True, True),
        ("f32_noncausal", (1, 3, 130, 32), torch.float32, False, True),
        ("f32_d128", (1, 2, 100, 128), torch.float32, True, False),
        # phase 17's ring rounds, as the forward's, with the non-zero lse
        # cotangent the merge over rounds gives them
        ("ring_diag", (16 * 2, 6, 512, 64), torch.bfloat16, True, True),
        ("ring_full", (8 * 2, 6, 512, 64), torch.bfloat16, False, True),
        ("ring_s1024_full", (4 * 2, 12, 1024, 64), torch.bfloat16, False,
         True),
        ("p21_main", (P21_BATCH, 12, P21_SEQ, 64), torch.bfloat16, True,
         False),
        # a 48-wide head runs the D = 64 kernels with the scale
        # 1/sqrt(48), not a power of two: dK through bf16(Q * scale)
        ("bf16_d48_dk", (2, 4, 256, 48), torch.bfloat16, True, True),
        # phase 26's widths, and the f32 kernels at the new widths
        ("pythia_2p8b_main", (2, 32, TRAIN_SEQ, 80), torch.bfloat16, True,
         False),
        ("pythia_1b_main", (2, 8, TRAIN_SEQ, 256), torch.bfloat16, True,
         False),
        ("f32_d256", (1, 2, 100, 256), torch.float32, True, True),
        ("f32_d96_noncausal", (1, 3, 130, 96), torch.float32, False, True),
        ("bh70000", (1, *BIG_BH_SHAPE), torch.bfloat16, True, False),
    ]
    cases = ([(*c, 1.0) for c in cases]
             + [(n, (1, *sh), getattr(torch, dt), c, False, x)
                for n, sh, dt, c, x in _edge_cases()])
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    worst = 0.0
    for name, (b, h, s, d), dtype, causal, with_dlse, x in cases:
        shape = (b * h, s, d)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        q, k, v, do = ((q * x).to(dtype), (k * x).to(dtype), v.to(dtype),
                       do.to(dtype))
        dl = (torch.randn((b * h, s), generator=gen, device="cuda")
              if with_dlse else torch.zeros((b * h, s), device="cuda"))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = attention.flash_attention_with_lse(*leaves, causal=causal)
        got = torch.autograd.grad((out, lse), leaves, (do, dl))
        torch.cuda.synchronize()
        delta = (do.float() * out.float()).sum(-1) - dl
        blocked = attention.flash_attention_backward_reference(
            q, k, v, out.detach(), lse.detach(), do, causal, delta=delta)
        f32 = [t.float().requires_grad_(True) for t in (q, k, v)]
        ro, rl = attention.flash_attention_reference(*f32, causal)
        auto = torch.autograd.grad((ro, rl), f32, (do.float(), dl))
        e_blk, e_auto = _grad_err(got, blocked), _grad_err(got, auto)
        if dtype == torch.bfloat16:
            top = max(t.abs().max().item() for t in auto)
            t_blk = t_auto = BF16_GRAD_RTOL * top
        else:
            t_blk, t_auto = F32_GRAD_ATOL_BLOCKED, F32_GRAD_ATOL_AUTOGRAD
        if name.startswith("edge_"):
            worst = max(worst, e_blk / t_blk, e_auto / t_auto)
        else:
            print(f"flash bwd {name}: shape {(b, h, s, d)} {str(dtype)[6:]} "
                  f"causal={causal} dlse={with_dlse} max|d(dq,dk,dv)| vs "
                  f"blocked {e_blk:.3e} (tol {t_blk:.3e}), vs autograd "
                  f"{e_auto:.3e} (tol {t_auto:.3e})")
        check(all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"{name}: non-finite gradients")
        check(e_blk <= t_blk, f"{name}: backward vs blocked {e_blk} > {t_blk}")
        check(e_auto <= t_auto,
              f"{name}: backward vs autograd {e_auto} > {t_auto}")
        results[name] = {"dq_err": _grad_err(got[:1], blocked[:1]),
                         "dkv_err": _grad_err(got[1:], blocked[1:]),
                         "err_vs_autograd": e_auto}
        del q, k, v, do, leaves, out, lse, got, blocked, f32, ro, rl, auto
    print(f"flash bwd edges: {len(_edge_cases())} cases (as the "
          f"forward's), the largest error used {worst:.3f} of its tolerance "
          f"(vs blocked and vs autograd; bf16 {BF16_GRAD_RTOL} of max|grad|, "
          f"f32 {F32_GRAD_ATOL_BLOCKED} and {F32_GRAD_ATOL_AUTOGRAD})")
    check(worst <= 1.0, "an edge case exceeded its tolerance")

    # timing at the training shapes: each kernel alone, the plain
    # backward, and SDPA's backward (forward + backward less the forward)
    import torch.nn.functional as F

    timing = {}
    for label in FLASH_BWD_SHAPES:
        bh, s, d, causal = FLASH_SHAPES[label]
        (q, k, v, do), (qp, kp, vp, dop), dp, scale = _flash_operands(
            torch, attention, gen, bh, s, d, n=4)
        outp, lse = attention._launch(qp, kp, vp, causal, scale)
        out = outp[..., :d]
        delta = (do.float() * out.float()).sum(-1)
        dq_ms = device_ms(torch, lambda: attention._launch_bwd_dq(
            qp, kp, vp, dop, lse, delta, causal, scale))
        dkv_ms = device_ms(torch, lambda: attention._launch_bwd_dkv(
            qp, kp, vp, dop, lse, delta, causal, scale))
        dq_us = host_us(torch, lambda: attention._launch_bwd_dq(
            qp, kp, vp, dop, lse, delta, causal, scale))
        dkv_us = host_us(torch, lambda: attention._launch_bwd_dkv(
            qp, kp, vp, dop, lse, delta, causal, scale))
        plain_ms = device_ms(
            torch, lambda: attention.flash_attention_backward_reference(
                q, k, v, out, lse, do, causal), iters=1, windows=5)
        q4, k4, v4 = (t.view(1, bh, s, d).clone().requires_grad_(True)
                      for t in (q, k, v))
        do4 = do.view(1, bh, s, d)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            torch.autograd.grad(o, (q4, k4, v4), do4)

        with torch.no_grad():
            sdpa_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
        library_ms = device_ms(torch, sdpa_fwd_bwd) - sdpa_fwd
        pairs = bh * (s * (s + 1) // 2 if causal else s * s)
        # dQ: 3 products per causal pair (QK^T, dO V^T, dS K), 2*D FLOPs
        # each; reads q, k, v, dO (bf16) and lse, delta (f32), writes dq
        # dK/dV: 4 products (QK^T, dO V^T, P^T dO, dS^T Q); writes dk, dv
        rows = bh * s * 4 * 2
        t_dq = bound(spec, 3 * 2 * d * pairs, 5 * bh * s * d * 2 + rows)
        t_dkv = bound(spec, 4 * 2 * d * pairs, 6 * bh * s * d * 2 + rows)
        timing[label] = {
            "dq": {"ms": dq_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "host_us": dq_us, **t_dq},
            "dkv": {"ms": dkv_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "host_us": dkv_us, **t_dkv},
        }
        if dp != d:  # the padded kernels' work, at the compiled width
            for part, n_prod, n_io in (("dq", 3, 5), ("dkv", 4, 6)):
                ex = bound(spec, n_prod * 2 * dp * pairs,
                           n_io * bh * s * dp * 2 + rows)
                timing[label][part].update(head_dim_run=dp,
                                           bound_executed_ms=ex["bound_ms"])
        print(f"flash bwd timing {label} [{bh}, {s}, {d}] causal={causal}: "
              f"dQ {dq_ms:.4f} ms "
              f"(bound {t_dq['bound_ms']:.4f}, {t_dq['bound_by']}, "
              f"{t_dq['bound_ms'] / dq_ms:.1%} of it, "
              f"{t_dq['flops'] / dq_ms / 1e9:.1f} TFLOP/s, host "
              f"{dq_us:.1f} us per launch), dK/dV "
              f"{dkv_ms:.4f} ms (bound {t_dkv['bound_ms']:.4f}, "
              f"{t_dkv['bound_by']}, {t_dkv['bound_ms'] / dkv_ms:.1%} of it, "
              f"{t_dkv['flops'] / dkv_ms / 1e9:.1f} TFLOP/s, host "
              f"{dkv_us:.1f} us per launch); plain backward {plain_ms:.4f} "
              f"ms; sdpa backward {library_ms:.4f} ms (fwd+bwd less fwd "
              f"{sdpa_fwd:.4f})")
        del q, k, v, do, qp, kp, vp, dop, outp, out, lse, delta, q4, k4, v4
        del do4
    return results, timing


def phase_xent(torch, xk, spec):
    """Fused cross-entropy forward and backward kernels vs their plain
    versions, at the main shape (f32 and bf16) and ragged edges."""
    import torch.nn.functional as F

    n_main, v_main = TRAIN_BATCH * TRAIN_SEQ, FLAGSHIP["vocab_size"]
    cases = [
        # name, N, V, dtype
        ("main", n_main, v_main, torch.float32),
        ("bf16_main", n_main, v_main, torch.bfloat16),
        ("bert_main", BERT_ROWS * BERT_SEQ, BERT_VOCAB, torch.float32),
        ("ragged_v", 300, 1000, torch.float32),
        ("ragged_n", 8191, 2048, torch.float32),
        ("bf16_ragged", 517, 1000, torch.bfloat16),
        # phase 17 (a): every last-stage rank's rows in one launch (eight
        # ranks x two microbatches x [2, 512])
        ("sharded_main", 8 * 2 * 2 * 512, v_main, torch.float32),
        # phase 21's rank step
        ("p21_main", P21_BATCH * P21_SEQ, v_main, torch.float32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for name, n, v, dtype in cases:
        x = (torch.randn((n, v), generator=gen, device="cuda") * 3).to(dtype)
        t = torch.randint(0, v, (n,), generator=gen, device="cuda")
        g = torch.randn((n,), generator=gen, device="cuda")
        loss, lse = xk.forward(x, t)
        dlog = xk.backward(x, t, lse, g)
        torch.cuda.synchronize()
        ref_loss, ref_lse = xk.xent_forward_reference(x, t)
        ref_d = xk.xent_backward_reference(x, t, ref_lse, g)
        l_err = (loss - ref_loss).abs().max().item()
        d_err = (dlog.float() - ref_d.float()).abs().max().item()
        if dtype == torch.bfloat16:
            l_tol = XENT_LOSS_ATOL_BF16
            d_tol = XENT_DLOGITS_RTOL_BF16 * ref_d.float().abs().max().item()
        else:
            l_tol, d_tol = XENT_LOSS_ATOL_F32, XENT_DLOGITS_ATOL_F32
        print(f"xent {name}: [{n}, {v}] {str(dtype)[6:]} max|dloss|="
              f"{l_err:.3e} (tol {l_tol}) max|ddlogits|={d_err:.3e} "
              f"(tol {d_tol:.3e})")
        check(bool(torch.isfinite(loss).all()), f"xent {name}: non-finite loss")
        check(dlog.dtype == dtype, f"xent {name}: dlogits dtype {dlog.dtype}")
        check(l_err <= l_tol, f"xent {name}: loss error {l_err} > {l_tol}")
        check(d_err <= d_tol, f"xent {name}: dlogits error {d_err} > {d_tol}")
        results[name] = {"loss_err": l_err, "dlogits_err": d_err}
        del x, t, g, loss, lse, dlog, ref_loss, ref_lse, ref_d

    # timing at the main shapes (the flagship step's, one BERT-base
    # rank's), f32 logits as the models produce them
    timing = {}
    for label, (n, v) in {"main": (n_main, v_main),
                          "bert": (BERT_ROWS * BERT_SEQ, BERT_VOCAB)}.items():
        x = torch.randn((n, v), generator=gen, device="cuda")
        t = torch.randint(0, v, (n,), generator=gen, device="cuda")
        g = torch.full((n,), 1.0 / n, device="cuda")
        _, lse = xk.forward(x, t)
        fwd_ms = device_ms(torch, lambda: xk.forward(x, t))
        bwd_ms = device_ms(torch, lambda: xk.backward(x, t, lse, g))
        fwd_us = host_us(torch, lambda: xk.forward(x, t))
        bwd_us = host_us(torch, lambda: xk.backward(x, t, lse, g))
        plain_fwd = device_ms(torch, lambda: xk.xent_forward_reference(x, t),
                              iters=1, windows=5)
        plain_bwd = device_ms(torch, lambda: xk.xent_backward_reference(
            x, t, lse, g), iters=1, windows=5)
        with torch.no_grad():
            lib_fwd = device_ms(torch, lambda: F.cross_entropy(
                x, t, reduction="none"), iters=1, windows=5)
        xr = x.clone().requires_grad_(True)

        def lib_fwd_bwd():
            torch.autograd.grad(F.cross_entropy(xr, t, reduction="none"), xr,
                                g)

        lib_bwd = device_ms(torch, lib_fwd_bwd, iters=1, windows=5) - lib_fwd
        # no matrix product: the forward reads the logits once (and writes
        # two [N] f32 vectors); the backward reads them once and writes
        # dlogits
        t_fwd = bound(spec, 0, n * v * 4 + n * 4 + 2 * n * 4)
        t_bwd = bound(spec, 0, 2 * n * v * 4 + n * 4 * 3)
        timing[label] = {
            "fwd": {"ms": fwd_ms, "plain_ms": plain_fwd,
                    "library_ms": lib_fwd, "host_us": fwd_us, **t_fwd},
            "bwd": {"ms": bwd_ms, "plain_ms": plain_bwd,
                    "library_ms": lib_bwd, "host_us": bwd_us, **t_bwd},
        }
        print(f"xent timing {label} [{n}, {v}] f32: fwd {fwd_ms:.4f} ms "
              f"(bound {t_fwd['bound_ms']:.4f}, plain {plain_fwd:.4f}, "
              f"F.cross_entropy {lib_fwd:.4f}); bwd {bwd_ms:.4f} ms (bound "
              f"{t_bwd['bound_ms']:.4f}, plain {plain_bwd:.4f}, "
              f"F.cross_entropy backward {lib_bwd:.4f}); "
              f"{t_fwd['bytes'] / fwd_ms / 1e6:.0f} and "
              f"{t_bwd['bytes'] / bwd_ms / 1e6:.0f} GB/s; host {fwd_us:.1f} "
              f"and {bwd_us:.1f} us per launch")
        del x, t, g, lse, xr
    return results, timing


def _ratio(got, ref, rtol: float, atol: float) -> float:
    """max over elements of |got - ref| / (atol + rtol |ref|); <= 1 passes."""
    ref = ref.float()
    d = (got.float() - ref).abs()
    return (d / (atol + rtol * ref.abs())).max().item()


#: the fused LM head's cases: N, D, V, h dtype, W dtype.  bf16 h takes
#: the wgmma forward, dh and dW kernels on the split of W (f32 h the
#: SIMT ones)
LMH_CASES = {
    "main": (TRAIN_BATCH * TRAIN_SEQ, FLAGSHIP["d_model"],
             FLAGSHIP["vocab_size"], "bfloat16", "float32"),
    "bf16": (2048, 768, 8192, "bfloat16", "bfloat16"),
    "f32": (1024, 768, 4096, "float32", "float32"),
    "ragged": (517, 200, 1000, "bfloat16", "float32"),
    "ragged_f32_wide": (130, 1000, 777, "float32", "float32"),
    # the wgmma kernels' edges: V not a multiple of their 64 or 128 vocab
    # columns, D not a multiple of 16, N not a multiple of their 64 or
    # 128 rows
    "ragged_bf16": (517, 200, 1000, "bfloat16", "bfloat16"),
    # a cluster of three CTAs, the last partly past D; D not a multiple
    # of 8, so h is copied to rows of a 16-byte pitch
    "ragged_cluster3": (300, 603, 777, "bfloat16", "float32"),
    # a cluster of four CTAs
    "ragged_cluster4": (130, 1000, 777, "bfloat16", "float32"),
    # the largest cluster, eight CTAs
    "ragged_cluster8": (130, 2048, 777, "bfloat16", "float32"),
    # bf16 h past a cluster's eight slices: the wgmma forward, the SIMT
    # dh and dW kernels
    "ragged_bf16_wide": (130, 2100, 777, "bfloat16", "float32"),
}


def lm_head_case(torch, lmk, name: str) -> dict:
    """One case of the fused LM head: the split kernel bitwise against
    its plain version (bf16 h), then the forward, dh and dW kernels
    against theirs, with out-of-vocab targets in the ragged cases; the
    backward takes the forward's split of W, as the autograd function
    passes it."""
    n, d, v, dt_h, dt_w = LMH_CASES[name]
    dt_h, dt_w = getattr(torch, dt_h), getattr(torch, dt_w)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(
        3 + list(LMH_CASES).index(name))
    h = torch.randn((n, d), generator=gen, device="cuda").to(dt_h)
    w = (torch.randn((d, v), generator=gen, device="cuda") * 0.05).to(dt_w)
    t = torch.randint(0, v, (n,), generator=gen, device="cuda")
    if name.startswith("ragged"):
        t[:2] = torch.tensor([-1, v + 7])  # out of vocab: loss = lse
    g = torch.randn((n,), generator=gen, device="cuda")
    if dt_h == bf16:
        hi, lo = lmk.split_w(w)
        ref_hi, ref_lo = lmk.split_w_reference(w)
        torch.cuda.synchronize()
        check(torch.equal(hi.view(torch.int16), ref_hi.view(torch.int16))
              and (lo is None or torch.equal(lo.view(torch.int16),
                                             ref_lo.view(torch.int16))),
              f"lm_head {name}: split kernel != plain version")
        del hi, lo, ref_hi, ref_lo
    loss, lse, split = lmk.forward(h, w, t)
    check((split is not None) == (dt_h == bf16),
          f"lm_head {name}: the forward kept no split of W")
    dh, dw = lmk.backward(h, w, t, lse, g, split)
    del split
    torch.cuda.synchronize()
    ref_loss, ref_lse = lmk.lm_head_forward_reference(h, w, t)
    ref_dh, ref_dw = lmk.lm_head_backward_reference(h, w, t, ref_lse, g)
    ratios = {"loss": _ratio(loss, ref_loss, LMH_LOSS_RTOL, LMH_LOSS_ATOL),
              "lse": _ratio(lse, ref_lse, LMH_LOSS_RTOL, LMH_LOSS_ATOL)}
    for key, got, ref in (("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        rtol = LMH_GRAD_RTOL_BF16 if got.dtype == bf16 else LMH_GRAD_RTOL_F32
        atol = LMH_GRAD_ATOL_SHARE * ref.float().abs().max().item()
        ratios[key] = _ratio(got, ref, rtol, atol)
    errs = {"loss_err": (loss - ref_loss).abs().max().item(),
            "dh_err": (dh.float() - ref_dh.float()).abs().max().item(),
            "dw_err": (dw.float() - ref_dw.float()).abs().max().item()}
    print(f"lm_head {name}: h [{n}, {d}] {str(dt_h)[6:]} W [{d}, {v}] "
          f"{str(dt_w)[6:]}: share of tolerance used: " + ", ".join(
              f"{k} {r:.3f}" for k, r in ratios.items())
          + f"; max|dloss| {errs['loss_err']:.3e} max|ddh| "
          f"{errs['dh_err']:.3e} (max|dh| {ref_dh.float().abs().max().item():.3e}) "
          f"max|ddW| {errs['dw_err']:.3e} (max|dW| "
          f"{ref_dw.float().abs().max().item():.3e})", flush=True)
    check(dh.dtype == dt_h and dw.dtype == dt_w,
          f"lm_head {name}: gradient dtypes {dh.dtype} {dw.dtype}")
    for key, r in ratios.items():
        check(r <= 1.0, f"lm_head {name}: {key} off by {r:.3f} of its "
              f"tolerance")
    if name.startswith("ragged"):
        check(bool(torch.equal(loss[:2], lse[:2])),
              f"lm_head {name}: out-of-vocab targets do not give lse")
    return {**errs, **{f"{k}_tol_share": r for k, r in ratios.items()}}


def _lm_head_edges() -> dict:
    """Every case but the main one, each in a process of its own (all
    started together), so that a hang or a fault names its case."""
    def run(name):
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--lm-head-case",
                 name], capture_output=True, text=True, timeout=300, cwd=HERE)
        except subprocess.TimeoutExpired:
            return name, None, "timed out after 300 s"
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("LMH_CASE ")]
        for ln in out.stdout.splitlines():
            if ln.startswith("lm_head "):
                print(ln)
        if out.returncode != 0 or not lines:
            return name, None, (f"exit {out.returncode}: "
                                f"{out.stderr.strip()[-1500:]}")
        return name, json.loads(lines[-1][len("LMH_CASE "):]), None

    names = [k for k in LMH_CASES if k != "main"]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        done = list(pool.map(run, names))
    for name, _, err in done:
        check(err is None, f"lm_head {name}: {err}")
    return {name: res for name, res, _ in done}


def phase_lm_head(torch, lmk, spec):
    """Fused LM-head forward, dh and dW kernels (and the split of W for
    the wgmma dW kernel) vs their plain versions at the flagship shape
    (bf16 h, f32 W) in this process, then the other cases of
    ``LMH_CASES`` each in its own process; then timed at the flagship
    shape beside the plain versions and the plain head they replace."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    n_main, d_main, v_main = LMH_CASES["main"][:3]
    results = {"main": lm_head_case(torch, lmk, "main")}
    torch.cuda.empty_cache()
    results.update(_lm_head_edges())
    gen = torch.Generator(device="cuda").manual_seed(3)

    # timing at the main shape: each kernel alone (windows of 1-2
    # launches keep each kernel's timing to a few seconds), the plain
    # versions, and the plain head they replace: the f32 product plus
    # F.cross_entropy, and autograd's backward of that pair
    n, d, v = n_main, d_main, v_main
    h = torch.randn((n, d), generator=gen, device="cuda").to(bf16)
    w = torch.randn((d, v), generator=gen, device="cuda") * 0.05
    t = torch.randint(0, v, (n,), generator=gen, device="cuda")
    t32 = t.to(torch.int32)
    g = torch.full((n,), 1.0 / n, device="cuda")
    lse = lmk._launch_fwd(h, w, t32)[1]
    fwd_ms = device_ms(torch, lambda: lmk._launch_fwd(h, w, t32), iters=2,
                       windows=5)
    dh_ms = device_ms(torch, lambda: lmk._launch_dh(h, w, t32, lse, g),
                      iters=1, windows=5)
    dw_ms = device_ms(torch, lambda: lmk._launch_dw(h, w, t32, lse, g),
                      iters=1, windows=5)
    split_ms = device_ms(torch, lambda: lmk.split_w(w), iters=5, windows=5)
    host = {"fwd": host_us(torch, lambda: lmk._launch_fwd(h, w, t32), 10),
            "dh": host_us(torch, lambda: lmk._launch_dh(h, w, t32, lse, g), 10),
            "dw": host_us(torch, lambda: lmk._launch_dw(h, w, t32, lse, g), 10)}
    plain_fwd = device_ms(torch, lambda: lmk.lm_head_forward_reference(
        h, w, t), iters=1, windows=3)
    plain_bwd = device_ms(torch, lambda: lmk.lm_head_backward_reference(
        h, w, t, lse, g), iters=1, windows=3)
    with torch.no_grad():
        head_fwd = device_ms(torch, lambda: F.cross_entropy(
            h.float() @ w, t, reduction="none"), iters=1, windows=5)
    hr, wr = h.clone().requires_grad_(True), w.clone().requires_grad_(True)

    def head_fwd_bwd():
        torch.autograd.grad(F.cross_entropy(hr.float() @ wr, t,
                                            reduction="none"), (hr, wr), g)

    head_bwd = device_ms(torch, head_fwd_bwd, iters=1, windows=5) - head_fwd
    # one product is 2*N*D*V FLOPs (the forward does one, each backward
    # kernel two: the recomputed logits and its own); bytes: h, W,
    # targets read once (the backward also lse and g), loss and lse
    # written (f32), dh (h's dtype) or dW (W's dtype) written
    prod = 2 * n * d * v
    reads = h.numel() * h.element_size() + w.numel() * w.element_size() + n * 4
    timing = {}
    for key, ms, plain, head, flops, nbytes in (
            ("fwd", fwd_ms, plain_fwd, head_fwd, prod, reads + 2 * n * 4),
            ("dh", dh_ms, plain_bwd, head_bwd, 2 * prod,
             reads + 2 * n * 4 + h.numel() * h.element_size()),
            ("dw", dw_ms, plain_bwd, head_bwd, 2 * prod,
             reads + 2 * n * 4 + w.numel() * w.element_size())):
        timing[key] = {"ms": ms, "plain_ms": plain, "library_ms": None,
                       "plain_head_ms": head, "host_us": host[key],
                       "bound_fp32_ms": flops / spec["f32_flops"] * 1e3,
                       **bound(spec, flops, nbytes)}
    # the wgmma kernels run bf16 products of 2*N*D*V each: the logits
    # from W's two terms (all three kernels), then dW from dl's two terms
    # (four in all) or dh from dl_hi W_hi, dl_hi W_lo and dl_lo W_hi
    # (five); each times the split of W, which it makes when not given one
    for key, products in (("fwd", 2), ("dh", 5), ("dw", 4)):
        timing[key]["split_ms"] = split_ms
        timing[key]["bound_executed_ms"] = (products * prod
                                            / spec["bf16_flops"] * 1e3)
    print(f"lm_head timing main [{n}, {d}] x [{d}, {v}] bf16 h, f32 W: fwd "
          f"{fwd_ms:.4f} ms, dh {dh_ms:.4f} ms, dW {dw_ms:.4f} ms (bounds "
          f"{timing['fwd']['bound_ms']:.4f} / {timing['dh']['bound_ms']:.4f} "
          f"/ {timing['dw']['bound_ms']:.4f} at bf16 peak, "
          f"{timing['fwd']['bound_fp32_ms']:.4f} / "
          f"{timing['dh']['bound_fp32_ms']:.4f} / "
          f"{timing['dw']['bound_fp32_ms']:.4f} at FP32 peak; the kernels "
          f"execute {timing['fwd']['bound_executed_ms']:.4f} / "
          f"{timing['dh']['bound_executed_ms']:.4f} / "
          f"{timing['dw']['bound_executed_ms']:.4f} of bf16 work; the split "
          f"of W, {split_ms:.4f} ms, is in each time); host {host['fwd']:.1f} / "
          f"{host['dh']:.1f} / {host['dw']:.1f} us per launch; plain "
          f"versions fwd {plain_fwd:.4f} ms, bwd {plain_bwd:.4f} ms; plain "
          f"head (f32 product + F.cross_entropy, two calls) fwd "
          f"{head_fwd:.4f} ms, bwd {head_bwd:.4f} ms; "
          f"{prod / fwd_ms / 1e9:.1f} / {2 * prod / dh_ms / 1e9:.1f} / "
          f"{2 * prod / dw_ms / 1e9:.1f} TFLOP/s")
    return results, timing


def phase_forward(torch, attention, tr, model, params, ids):
    """The flagship forward once through the kernel (launches counted),
    then against the plain attention, then timed."""
    attention.reset_launch_counts()
    logits = model.apply(params, ids)
    torch.cuda.synchronize()
    launches = dict(attention.launch_counts)
    print(f"forward path launches: {launches}")
    check(launches["flash_fwd"] == model.cfg.n_layers,
          f"flash kernel launched {launches['flash_fwd']} times in one "
          f"forward, expected {model.cfg.n_layers}")
    check(tuple(logits.shape) == (4, 256, model.cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    saved = os.environ.get("KF_TPU_ATTN")
    os.environ["KF_TPU_ATTN"] = "xla"
    try:
        check(tr.pick_attention() is tr.default_attention,
              "KF_TPU_ATTN=xla did not select the plain attention")
        ref = model.apply(params, ids)
    finally:
        if saved is None:
            os.environ.pop("KF_TPU_ATTN")
        else:
            os.environ["KF_TPU_ATTN"] = saved
    err = (logits - ref).abs().max().item()
    spread = ref.std().item()
    print(f"forward logits vs KF_TPU_ATTN=xla: max|d|={err:.3e} "
          f"(tol {LOGITS_ATOL}, logit std {spread:.3f})")
    check(err <= LOGITS_ATOL, f"logits error {err} > {LOGITS_ATOL}")

    def wall_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    fwd_ms = wall_ms(lambda: model.apply(params, ids))
    plain_fwd_ms = wall_ms(lambda: model.apply(params, ids,
                                               attn_fn=tr.default_attention))
    toks = ids.numel() / (fwd_ms / 1e3)
    print(f"forward: {fwd_ms:.3f} ms/forward ({toks:.0f} tokens/s) through "
          f"the kernel; {plain_fwd_ms:.3f} ms with plain attention")
    return {"launches": launches["flash_fwd"], "logits_err": err,
            "ms": fwd_ms, "tokens_s": toks, "plain_attn_ms": plain_fwd_ms}


def phase_serve(torch, np, attention, model, params):
    from kungfu_tpu_torch.monitor.registry import REGISTRY
    from kungfu_tpu_torch.serve import slo
    from kungfu_tpu_torch.serve.engine import InferenceEngine

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, size=64).tolist()
    wave1 = {"r17": rng.integers(0, vocab, size=17).tolist(),
             "p73": prefix + rng.integers(0, vocab, size=9).tolist(),
             "r150": rng.integers(0, vocab, size=150).tolist(),
             "r200": rng.integers(0, vocab, size=200).tolist()}
    # the second wave arrives after the first has committed its pages,
    # so the shared 64-token prefix comes out of the paged cache
    wave2 = {"p94": prefix + rng.integers(0, vocab, size=30).tolist(),
             "r40": rng.integers(0, vocab, size=40).tolist()}
    new = 16
    engine = InferenceEngine(model, params, max_batch=8, max_seq=512)
    dev = params["embed"]["table"].device
    t0 = time.perf_counter()
    engine.warmup(prompt_lens=(200,))
    print(f"serve warmup: {time.perf_counter() - t0:.2f} s")
    REGISTRY.reset()
    attention.reset_launch_counts()
    done = {}
    t0 = time.perf_counter()
    steps = 0
    for wave in (wave1, wave2):
        for rid, toks in wave.items():
            engine.submit(rid, toks, new)
        while engine.pending_count or engine.active_count:
            for ev in engine.step():
                if ev["kind"] == "done":
                    done[ev["rid"]] = ev
            steps += 1
    wall = time.perf_counter() - t0
    launches = dict(attention.launch_counts)
    print(f"serve path launches: {launches} (the engine's attention is the "
          f"plain masked softmax, as in the reference engine)")
    prompts = {**wave1, **wave2}
    check(set(done) == set(prompts), f"completed {sorted(done)}")
    for rid, ev in done.items():
        check(len(ev["tokens"]) == new,
              f"{rid}: {len(ev['tokens'])} tokens, budget {new}")
    reused = sum(ev["reused_tokens"] for ev in done.values())
    check(reused > 0, "no prefill tokens were reused from the prefix cache")
    check(done["p94"]["reused_tokens"] == 64,
          f"p94 reused {done['p94']['reused_tokens']} tokens, expected 64")

    # full-context greedy reference through the forward (kernel path),
    # teacher-forced on the engine's tokens: one forward per request
    exact = total = 0
    worst = 0.0
    for rid, ev in done.items():
        seq = prompts[rid] + ev["tokens"]
        logits = model.apply(params, torch.tensor([seq[:-1]], device=dev))
        rows = logits[0, len(prompts[rid]) - 1:]          # [new, vocab]
        top = rows.argmax(dim=-1)
        got = torch.tensor(ev["tokens"], device=dev)
        gap = (rows.gather(1, top[:, None]) - rows.gather(1, got[:, None]))
        worst = max(worst, gap.max().item())
        exact += int((top == got).sum())
        total += new
    print(f"serve vs full-context greedy: {exact}/{total} tokens identical; "
          f"largest top-1 margin over the engine's token {worst:.3e} "
          f"(tol {GREEDY_MARGIN})")
    check(worst <= GREEDY_MARGIN,
          f"engine token loses to the greedy top-1 by {worst} > "
          f"{GREEDY_MARGIN}")
    tok = slo.slo_snapshot()["token"]
    ttfts = sorted(ev["ttft_s"] * 1e3 for ev in done.values())
    gen_tokens = new * len(done)
    print(f"serve: {len(done)} requests, {steps} steps, {wall:.3f} s wall, "
          f"{gen_tokens / wall:.1f} generated tokens/s; TTFT ms "
          f"{[round(t, 2) for t in ttfts]}; decode step p50 "
          f"{tok.get('p50', 0) * 1e3:.3f} ms mean "
          f"{tok['sum'] / max(tok['count'], 1) * 1e3:.3f} ms; reused "
          f"prefill tokens {reused}")
    return {"launches": launches["flash_fwd"], "wall_s": wall,
            "ttft_ms": ttfts, "decode_step_mean_ms":
                tok["sum"] / max(tok["count"], 1) * 1e3,
            "decode_step_p50_ms": tok.get("p50", 0) * 1e3,
            "greedy_exact": exact, "greedy_total": total,
            "greedy_worst_margin": worst, "reused_tokens": reused}


def _counts(kernels) -> dict:
    return {k: n for mod in kernels for k, n in mod.launch_counts.items()}


def _reset(kernels) -> None:
    for mod in kernels:
        mod.reset_launch_counts()


def phase_train(torch, np, kernels, tr, costmodel, spec, head: str):
    """The flagship training step through the kernels: launches per step,
    first-step gradients against the plain path, ten steps of falling
    loss on a fixed batch, one step through Transformer.loss under the
    knob that routes to the same kernels, then step time, tokens/s, MFU
    and the peak memory of the timed steps.

    ``head="plain"`` (phase 6): logits from the model, the fused xent
    kernels, held against plain attention + plain xent; the model step
    runs under KF_TPU_XENT=fused.  ``head="fused"`` (phase 7): the fused
    LM-head kernels on the final features, held against flash + plain
    head + plain xent, so the comparison isolates the head; the model
    step runs under KF_TPU_LM_HEAD=fused."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.lm_head import lm_head_nll
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step

    t0 = time.perf_counter()
    model, params, batch, flash, loss_fn = _flagship_train(torch, np, tr,
                                                           kernels[0])
    cfg = model.cfg
    torch.cuda.synchronize()
    print(f"train ({head} head) init: {time.perf_counter() - t0:.2f} s")

    if head == "fused":
        def loss_fn(p, b):  # noqa: F811 -- the fused head replaces it
            h = model.hidden(p, b[0], train=True, attn_fn=flash)
            return lm_head_nll(h, p["head"]["w"], b[1]).mean()

        ref_attn, knob = flash, "KF_TPU_LM_HEAD"
        routed = {"lm_head_fwd": 1, "lm_head_bwd_dh": 1, "lm_head_bwd_dw": 1,
                  "lm_head_split": 1}
    else:
        ref_attn, knob = tr.default_attention, "KF_TPU_XENT"
        routed = {"xent_fwd": 1, "xent_bwd": 1}

    def loss_plain(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=ref_attn)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, b[1][..., None]).squeeze(-1).mean()

    comm = Communicator(devices=["cuda:0"])
    tx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis)
    step = dp_train_step(loss_fn, tx, comm)
    opt = tx.init(params)

    # one step through the kernels, launches counted from zero
    _reset(kernels)
    p, o, loss = step(params, opt, batch)
    torch.cuda.synchronize()
    per_step = _counts(kernels)
    print(f"train step launches: {per_step}")
    want = {k: 0 for k in per_step}
    want.update(flash_fwd=cfg.n_layers, flash_bwd_dq=cfg.n_layers,
                flash_bwd_dkv=cfg.n_layers, **routed)
    check(per_step == want, f"one train step launched {per_step}, "
          f"expected {want}")
    losses = [float(loss)]

    # first-step gradients: kernels against the plain path
    g_kern, g_plain = (_grads(fn, params, batch)
                       for fn in (loss_fn, loss_plain))
    flat_f, flat_p = tr.flatten(g_kern), tr.flatten(g_plain)
    norms = {k: t.float().norm().item() for k, t in flat_p.items()}
    floor = 1e-3 * max(norms.values())
    rel = {k: (flat_f[k].float() - flat_p[k].float()).norm().item()
           / max(norms[k], floor) for k in flat_p}
    worst = max(rel, key=rel.get)
    print(f"first-step gradients vs plain path: worst leaf {worst} rel L2 "
          f"{rel[worst]:.3e} (tol {TRAIN_GRAD_REL_L2}); median "
          f"{statistics.median(rel.values()):.3e} over {len(rel)} leaves; "
          f"head/w {rel['head/w']:.3e}")
    check(all(bool(torch.isfinite(t).all()) for t in flat_f.values()),
          "non-finite gradients")
    check(rel[worst] <= TRAIN_GRAD_REL_L2,
          f"gradient of {worst} differs from the plain path by "
          f"{rel[worst]} > {TRAIN_GRAD_REL_L2}")
    del g_kern, g_plain, flat_f, flat_p

    # the remaining steps on the fixed batch, timed on the host clock;
    # counting starts again from zero, so the launches of the gradient
    # comparison above are not counted as the path's, and the peak
    # memory is the steps' own
    _reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train losses: {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0],
          f"loss did not fall over {TRAIN_STEPS} steps: {losses}")

    # one step through Transformer.loss, routed to the same kernels
    saved = os.environ.get(knob)
    os.environ[knob] = "fused"
    try:
        xent.XENT_ENV.reload()
        model_step = dp_train_step(
            lambda q, b: model.loss(q, b, attn_fn=flash), tx, comm)
        before = _counts(kernels)
        _, _, m_loss = model_step(params, tx.init(params), batch)
        torch.cuda.synchronize()
        after = _counts(kernels)
    finally:
        if saved is None:
            os.environ.pop(knob)
        else:
            os.environ[knob] = saved
        xent.XENT_ENV.reload()
    via_model = {k: after[k] - before[k] for k in after}
    print(f"Transformer.loss step under {knob}=fused: loss "
          f"{float(m_loss):.6f} (first step {losses[0]:.6f}), launches "
          f"{via_model}")
    check(via_model == want, f"Transformer.loss step launched {via_model}")
    check(abs(float(m_loss) - losses[0]) <= MODEL_LOSS_RTOL * abs(losses[0]),
          f"Transformer.loss {float(m_loss)} != the step's {losses[0]}")
    launches = {k: v + per_step[k] for k, v in _counts(kernels).items()}

    step_ms = statistics.median(times)
    toks = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    flops = costmodel.train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / (step_ms / 1e3) / spec["bf16_flops"]
    print(f"train ({head} head): {step_ms:.2f} ms/step median of "
          f"{len(times)} ({min(times):.2f}-{max(times):.2f}), {toks:.0f} "
          f"tokens/s, {flops / 1e12:.3f} TFLOP/step, MFU {mfu:.4f} against "
          f"{spec['bf16_flops'] / 1e12:.0f} TFLOP/s bf16; peak memory of "
          f"the timed steps {peak_gb:.2f} GiB")
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "grad_rel_l2_worst": rel[worst], "grad_worst_leaf": worst,
            "grad_rel_l2_head_w": rel["head/w"], "model_loss": float(m_loss),
            "step_ms": step_ms, "step_ms_all": times, "tokens_s": toks,
            "flops_per_step": flops, "mfu": mfu, "peak_gib": peak_gb}


def phase_ring(torch, ringk, rc, spec):
    """Ring reduce-scatter and all-gather kernels against their plain
    versions, bitwise, at the reference suite's edges and the main
    path's shapes (one ZeRO bucket, the fused S-SGD gradient), then
    timed beside the plain versions and one PyTorch call each."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def data(k, length, dtype):
        if not dtype.is_floating_point:
            return torch.randint(-1000, 1000, (k, length), generator=gen,
                                 device="cuda", dtype=dtype)
        return torch.randn((k, length), generator=gen, device="cuda").to(dtype)

    def case(k, chunk, dtype, bidi):
        cut = rc.band_cut(chunk, dtype, bidi)
        x = data(k, k * chunk, dtype)
        rs = ringk.reduce_scatter(x, cut)
        ag = ringk.all_gather(rs, cut)
        torch.cuda.synchronize()
        ok = (torch.equal(rs, rc.ring_reduce_scatter_reference(x, cut))
              and torch.equal(ag, rc.ring_all_gather_reference(rs, cut)))
        if dtype == torch.int32:
            ok = ok and torch.equal(rs, x.view(k, k, chunk).sum(
                0, dtype=torch.int32))
        check(ok, f"ring k={k} chunk={chunk} {dtype} bidirectional={bidi}: "
              f"kernel != plain version")
        return cut < chunk

    def view_case(k, chunk, cut, dtype, off, pad):
        # rows of a wider buffer: the base `off` elements in (not 16-byte
        # aligned when off is 1), the row stride k*chunk + off + pad
        x = data(k, k * chunk + off + pad, dtype)[:, off:off + k * chunk]
        rs = ringk.reduce_scatter(x, cut)
        shards = data(k, chunk + off + pad, dtype)[:, off:off + chunk]
        shards.copy_(rs)
        ag = ringk.all_gather(shards, cut)
        torch.cuda.synchronize()
        ok = (torch.equal(rs, rc.ring_reduce_scatter_reference(x, cut))
              and torch.equal(ag, rc.ring_all_gather_reference(rs, cut)))
        check(ok, f"ring k={k} chunk={chunk} cut={cut} {dtype} rows at "
              f"offset {off}, stride {x.stride(0)}: kernel != plain version")

    split = 0
    cases = 0
    for k in (2, 3, 5, 8):
        for chunk in (2048, 1024, 1000, 40):
            for bidi in (False, True):
                split += case(k, chunk, torch.float32, bidi)
                cases += 1
        split += case(k, 4096, torch.bfloat16, True)
        split += case(k, 4096, torch.int32, True)
        case(k, 1000, torch.int32, False)
        cases += 3
    check(split > 0, "no edge case split into two bands")
    print(f"ring edges: {cases} cases (k 2/3/5/8, f32 chunk 2048/1024/1000/"
          f"40 x one or two directions, bf16 4096 and int32 4096/1000), "
          f"{split} with two bands: reduce-scatter and all-gather bitwise "
          f"equal to the plain versions; int32 equal to view(k, k, "
          f"chunk).sum(0)")
    views = 0
    for k in (3, 4, 16):
        for chunk in (1001, 4097):
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                for cut in (chunk // 2 | 1, chunk):
                    for off, pad in ((1, 0), (0, 3), (1, 3)):
                        view_case(k, chunk, cut, dtype, off, pad)
                        views += 1
    for bidi in (False, True):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            case(16, 4096, dtype, bidi)
            views += 1
    # the all-gather moves 2-, 4- and 8-byte elements; the 4-byte ones
    # ran above, beside the reduce-scatter
    ag_views = 0
    for k in (3, 4, 16):
        for chunk in (1, 1001, 4097):
            for dtype in (torch.int16, torch.float64, torch.int64):
                for cut in sorted({chunk // 2 | 1, chunk}):
                    for off, pad in ((0, 0), (1, 0), (0, 3), (1, 3)):
                        shards = data(k, chunk + off + pad, dtype)[
                            :, off:off + chunk]
                        ag = ringk.all_gather(shards, cut)
                        torch.cuda.synchronize()
                        check(torch.equal(ag, rc.ring_all_gather_reference(
                            shards, cut)), f"ring all-gather k={k} "
                            f"chunk={chunk} cut={cut} {dtype} rows at offset "
                            f"{off}, stride {shards.stride(0)}: kernel != "
                            f"plain version")
                        ag_views += 1
    print(f"ring all-gather edges, 2- and 8-byte elements: {ag_views} cases "
          f"(k 3/4/16, chunk 1/1001/4097, int16/float64/int64, an odd cut "
          f"or one band, rows from element 0 or 1 with strides of chunk, "
          f"+ 1, + 3, + 4 elements): bitwise equal to the plain version")
    print(f"ring edges, unaligned rows: {views} cases (k 3/4/16, chunk 1001/"
          f"4097, f32/bf16/int32, an odd cut or one band; rows of a wider "
          f"buffer from element 1, and strides of k*chunk + 1, + 3, + 4 "
          f"elements; and k = 16 at chunk 4096 with the reference's cut): "
          f"reduce-scatter and all-gather bitwise equal to the plain "
          f"versions")

    # the main path's shapes: the ZeRO bucket at four ranks, the fused
    # S-SGD gradient, phase 11's bucket at two ranks, and phase 17's
    # widest leaf at two
    from kungfu_tpu_torch.ops.schedules import bucket_widths

    shapes = {"bucket": (RANKS, 262_144),
              "fused": (RANKS, FLAGSHIP_PARAMS // RANKS),
              "bucket_k2": (2, bucket_widths(FLAGSHIP_PARAMS // 2, 2, 4,
                                             4 << 20)[0]),
              # phase 17 (a)'s widest leaf (the embedding table, and the
              # head) over one dp ring of two ranks
              "leaf_k2": (2, FLAGSHIP["vocab_size"] * FLAGSHIP["d_model"]
                          // 2),
              # phase 19 (b)'s widest ResNet-50 leaf (a 3x3 512 -> 512
              # kernel) and its narrowest (a 64-channel BN vector) over
              # the four ranks
              "resnet_leaf": (RANKS, 3 * 3 * 512 * 512 // RANKS),
              "resnet_small": (RANKS, 64 // RANKS)}
    timing = {}
    for label, (k, chunk) in shapes.items():
        x = data(k, k * chunk, torch.float32)
        rs = ringk.reduce_scatter(x)
        ag = ringk.all_gather(rs)
        torch.cuda.synchronize()
        ref_rs = rc.ring_reduce_scatter_reference(x)
        check(torch.equal(rs, ref_rs), f"ring rs {label}: kernel != plain")
        del ref_rs
        ref_ag = rc.ring_all_gather_reference(rs)
        check(torch.equal(ag, ref_ag), f"ring ag {label}: kernel != plain")
        del ref_ag, ag
        big = label == "fused"
        it, win = (5, 7) if big else (50, 11)
        rs_ms = device_ms(torch, lambda: ringk.reduce_scatter(x), it, win)
        ag_ms = device_ms(torch, lambda: ringk.all_gather(rs), it, win)
        rs_plain = device_ms(torch, lambda: rc.ring_reduce_scatter_reference(
            x), 1, 3 if big else 5)
        ag_plain = device_ms(torch, lambda: rc.ring_all_gather_reference(rs),
                             1, 3 if big else 5)
        rs_lib = device_ms(torch, lambda: x.view(k, k, chunk).sum(0), it, win)
        ag_lib = device_ms(torch, lambda: rs.reshape(1, -1).expand(
            k, -1).contiguous(), it, win)
        calls = 20 if big else 200
        rs_us = host_us(torch, lambda: ringk.reduce_scatter(x), calls)
        ag_us = host_us(torch, lambda: ringk.all_gather(rs), calls)
        # each kernel reads its input once and writes its output once:
        # k*k*chunk and k*chunk f32 elements, the other way round for the
        # all-gather; no arithmetic to speak of
        nbytes = (k * k * chunk + k * chunk) * 4
        t = bound(spec, 0, nbytes)
        timing[label] = {
            "rs": {"ms": rs_ms, "plain_ms": rs_plain, "library_ms": rs_lib,
                   "host_us": rs_us, **t},
            "ag": {"ms": ag_ms, "plain_ms": ag_plain, "library_ms": ag_lib,
                   "host_us": ag_us, **t}}
        print(f"ring timing {label} k={k} chunk={chunk} f32: reduce-scatter "
              f"{rs_ms:.4f} ms (plain {rs_plain:.4f}, view(k, k, chunk)."
              f"sum(0) {rs_lib:.4f}), all-gather {ag_ms:.4f} ms (plain "
              f"{ag_plain:.4f}, expand().contiguous() {ag_lib:.4f}); bound "
              f"{t['bound_ms']:.4f} ms ({nbytes} bytes); "
              f"{nbytes / rs_ms / 1e6:.0f} and {nbytes / ag_ms / 1e6:.0f} GB/s; "
              f"host {rs_us:.1f} and {ag_us:.1f} us per launch")
        del x, rs
        torch.cuda.empty_cache()
    return timing


def _flagship_train(torch, np, tr, attention):
    """gpt_small(max_seq=2048) with random weights from seed 0, ids and
    targets [4, 2048] from ``default_rng(0)``, the flash attention and
    phase 6's loss (plain head, fused cross-entropy)."""
    from kungfu_tpu_torch.ops import xent

    model = tr.gpt_small(max_seq=TRAIN_SEQ)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    ids, targets = (torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    flash = attention.make_flash_attn()

    def loss_fn(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=flash)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    return model, params, (ids, targets), flash, loss_fn


def _grads(fn, params, batch):
    """The gradient tree of ``fn(params, batch)`` (one rank's pass)."""
    from kungfu_tpu_torch.parallel.train import per_rank_grads
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    grads = []
    per_rank_grads(fn, params, [batch], lambda r, g: grads.extend(g))
    return tree_unflatten(tree_flatten(params)[1], grads)


def _rank_launches(cfg, ranks: int = RANKS) -> dict:
    """One step's launches on ``ranks`` ranks, each running phase 6's
    per-rank forward and backward."""
    return dict(flash_fwd=ranks * cfg.n_layers,
                flash_bwd_dq=ranks * cfg.n_layers,
                flash_bwd_dkv=ranks * cfg.n_layers,
                xent_fwd=ranks, xent_bwd=ranks)


def _timed_steps(torch, np, step, p, o, batch, losses, steps=TRAIN_STEPS):
    """``steps`` - 1 more steps on the host clock; peak memory of those
    steps; returns (p, o, times, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"loss did not fall over {steps} steps: {losses}")
    return p, o, times, peak


def phase_ssgd(torch, np, kernels, tr, first_loss: float):
    """Phase 6's training step on RANKS co-resident ranks through the
    pallas_ring schedule, fused gradients: launches per step, the first
    loss and the reduced gradient against the one-rank step's, ten steps
    of falling loss, step ms, tokens/s and peak memory.  Returns the
    result and the params after the first step (phase 9 compares its
    own with them)."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.optimizers import (GradientTransformation, sgd,
                                             synchronous_sgd)
    from kungfu_tpu_torch.parallel.train import dp_train_step
    from kungfu_tpu_torch.utils.tree import tree_map

    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    cfg = model.cfg
    inner = sgd(0.05, momentum=0.9)
    seen = {}

    def update(grads, state, p=None):
        # keep the first reduced gradient the inner optimizer receives
        if "grads" not in seen:
            seen["grads"] = tree_map(lambda g: g.clone(), grads)
        return inner.update(grads, state, p)

    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    tx = synchronous_sgd(GradientTransformation(inner.init, update),
                         comm.axis, schedule="pallas_ring", fuse_grads=True)
    step = dp_train_step(loss_fn, tx, comm)
    opt = tx.init(params)

    # one step, launches counted from zero; the ranks' replicated rows
    # are checked bitwise equal before one is taken
    _reset(kernels)
    collective.CHECK_REPLICAS = True
    try:
        p, o, loss = step(params, opt, batch)
        torch.cuda.synchronize()
    finally:
        collective.CHECK_REPLICAS = False
    per_step = _counts(kernels)
    want = {key: 0 for key in per_step}
    want.update(_rank_launches(cfg), ring_rs=1, ring_ag=1)
    print(f"S-SGD ({RANKS} ranks, pallas_ring) step launches: {per_step}")
    check(per_step == want, f"one S-SGD step launched {per_step}, expected "
          f"{want}")
    losses = [float(loss)]
    loss_rel = abs(losses[0] - first_loss) / abs(first_loss)
    print(f"S-SGD first loss {losses[0]:.6f} vs one rank {first_loss:.6f}: "
          f"rel {loss_rel:.3e} (tol {RANKS_LOSS_RTOL})")
    check(loss_rel <= RANKS_LOSS_RTOL, f"S-SGD first loss {losses[0]} != "
          f"phase 6's {first_loss}")

    # the reduced gradient against the one-rank gradient (phase 6's)
    g_one = _grads(loss_fn, params, batch)
    flat_r, flat_1 = tr.flatten(seen.pop("grads")), tr.flatten(g_one)
    norms = {key: t.norm().item() for key, t in flat_1.items()}
    floor = 1e-3 * max(norms.values())
    rel = {key: (flat_r[key] - flat_1[key]).norm().item()
           / max(norms[key], floor) for key in flat_1}
    worst = max(rel, key=rel.get)
    print(f"S-SGD reduced first-step gradient vs one rank: worst leaf "
          f"{worst} rel L2 {rel[worst]:.3e} (tol {RANKS_GRAD_REL_L2}); "
          f"median {statistics.median(rel.values()):.3e}; head/w "
          f"{rel['head/w']:.3e}")
    check(rel[worst] <= RANKS_GRAD_REL_L2,
          f"reduced gradient of {worst} differs by {rel[worst]}")
    del g_one, flat_r, flat_1
    p1 = tree_map(lambda t: t.clone(), p)

    _reset(kernels)
    p, o, times, peak = _timed_steps(torch, np, step, p, o, batch, losses)
    launches = {key: v + per_step[key] for key, v in _counts(kernels).items()}
    step_ms = statistics.median(times)
    toks = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"S-SGD losses: {[round(x, 4) for x in losses]}")
    print(f"S-SGD ({RANKS} ranks on one card): {step_ms:.2f} ms/step median "
          f"of {len(times)} ({min(times):.2f}-{max(times):.2f}), {toks:.0f} "
          f"tokens/s over the global batch; peak memory of the timed steps "
          f"{peak:.2f} GiB")
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "first_loss_rel": loss_rel, "grad_rel_l2_worst": rel[worst],
            "grad_worst_leaf": worst,
            "grad_rel_l2_median": statistics.median(rel.values()),
            "step_ms": step_ms, "step_ms_all": times, "tokens_s": toks,
            "peak_gib": peak}, p1


def phase_zero(torch, np, kernels, tr, stage: int, ssgd_p1):
    """ZeRO stage ``stage`` on the same ranks through the pallas_ring
    bucket schedule: launches and ring bytes of one step, params after
    it against S-SGD's, ten steps of falling loss, step ms, tokens/s,
    peak memory and per-rank optimizer bytes."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collectives
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.zero import (opt_state_bytes_per_device,
                                                zero_train_step)

    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    z = zero_train_step(loss_fn, sgd(0.05, momentum=0.9), comm, stage=stage,
                        schedule="pallas_ring")
    o = z.init_opt(params)
    p = z.init_params(params)
    geo = z._get(params)
    buckets = len(geo.widths)
    analytic = z.comm_bytes(params)
    del params

    _reset(kernels)
    collectives.reset_ring_bytes()
    p, o, loss = z.step(p, o, batch)
    torch.cuda.synchronize()
    per_step = _counts(kernels)
    ring_bytes = dict(collectives.ring_bytes)
    want = {key: 0 for key in per_step}
    want.update(_rank_launches(model.cfg), ring_rs=buckets,
                ring_ag=buckets if stage == 3 else 0)
    print(f"ZeRO-{stage} step launches ({buckets} buckets of "
          f"{geo.widths[0]} columns): {per_step}")
    check(per_step == want, f"one ZeRO-{stage} step launched {per_step}, "
          f"expected {want}")
    want_bytes = {"reduce_scatter": analytic["grad_bytes"],
                  "all_gather": analytic["param_bytes"] if stage == 3 else 0.0}
    print(f"ZeRO-{stage} ring bytes per rank in one step: {ring_bytes}; "
          f"zero_comm_bytes {analytic} (stages 1/2 regather the params with "
          f"a plain copy, the reference's partitioner all-gather)")
    for key, v in want_bytes.items():
        check(abs(ring_bytes[key] - v) <= 1e-9 * max(v, 1.0),
              f"ZeRO-{stage} {key} bytes {ring_bytes[key]} != {v}")

    # params after one step against S-SGD's after one step
    got = tr.flatten(z.gather_params(p))
    ref = tr.flatten(ssgd_p1)
    same = [key for key in ref if torch.equal(got[key], ref[key])]
    worst = max(((got[key] - ref[key]).abs().max().item(), key) for key in ref)
    ratio = max(_ratio(got[key], ref[key], ZERO_RTOL, ZERO_ATOL)
                for key in ref)
    bitwise = len(same) == len(ref)
    print(f"ZeRO-{stage} params after one step vs S-SGD's: "
          f"{len(same)}/{len(ref)} leaves bitwise equal; max|d| "
          f"{worst[0]:.3e} ({worst[1]}); {ratio:.3f} of rtol {ZERO_RTOL} "
          f"atol {ZERO_ATOL}")
    check(ratio <= 1.0, f"ZeRO-{stage} params differ from S-SGD's beyond "
          f"rtol {ZERO_RTOL} atol {ZERO_ATOL}")
    del got, ref

    losses = [float(loss)]
    _reset(kernels)
    p, o, times, peak = _timed_steps(torch, np, z.step, p, o, batch, losses)
    launches = {key: v + per_step[key] for key, v in _counts(kernels).items()}
    step_ms = statistics.median(times)
    toks = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    opt_bytes = opt_state_bytes_per_device(o, RANKS)
    print(f"ZeRO-{stage} losses: {[round(x, 4) for x in losses]}")
    print(f"ZeRO-{stage} ({RANKS} ranks on one card): {step_ms:.2f} ms/step "
          f"median of {len(times)} ({min(times):.2f}-{max(times):.2f}), "
          f"{toks:.0f} tokens/s; peak memory of the timed steps {peak:.2f} "
          f"GiB; optimizer state {opt_bytes} bytes per rank")
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "buckets": buckets, "ring_bytes": ring_bytes,
            "zero_comm_bytes": analytic, "params_bitwise_vs_ssgd": bitwise,
            "leaves_bitwise": len(same), "max_abs_vs_ssgd": worst[0],
            "step_ms": step_ms, "step_ms_all": times, "tokens_s": toks,
            "peak_gib": peak, "opt_state_bytes_per_rank": opt_bytes}


def _put_cluster(port: int, cluster) -> int:
    """PUT ``cluster`` to the config server on ``port``; its new version."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/put",
                                 data=cluster.to_json().encode(), method="PUT")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())["version"]


def _trees_bitwise(torch, got, want) -> tuple:
    """(leaves bitwise equal, leaves) of two trees of one structure."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    check(len(a) == len(b), f"trees of {len(a)} and {len(b)} leaves")
    same = sum(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b))
    return same, len(a)


def _check_bitwise(torch, got, want, what: str) -> None:
    same, n = _trees_bitwise(torch, got, want)
    print(f"elastic: {what}: {same}/{n} leaves bitwise equal")
    check(same == n, f"{what}: {n - same} of {n} leaves differ")


def _chunk_mode_4_to_2(o4, total: int, c2):
    """Check 3: each of four ranks commits its own row of the 4-rank
    state (chunk mode), mirrors it on its ring predecessor over a
    PyHostChannel on loopback (one thread a rank), ranks 1 and 3 die
    (their channels close), and ranks 0 and 2 re-carve to two ranks from
    the buddy mirrors; their rows, stacked on the card."""
    from kungfu_tpu_torch.comm.host import PyHostChannel
    from kungfu_tpu_torch.elastic import ZeroBoundary, place_stacked
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.utils.tree import tree_map

    chans = [PyHostChannel(PeerID("127.0.0.1", 0), bind_host="127.0.0.1")
             for _ in range(RANKS)]
    peers = PeerList.of(*(c.self_id for c in chans))
    bounds = []
    for r in range(RANKS):
        b = ZeroBoundary()
        b.commit_local(0, tree_map(lambda t: t[r] if t.dim() == 2 else t, o4),
                       total=total, old_n=RANKS, my_old=r)
        bounds.append(b)

    class Peer:  # what the re-carve reads of a peer
        def __init__(self, chan):
            self.channel = chan
            self.config = type("C", (), {"self_id": chan.self_id})()

    def run(fns):
        with ThreadPoolExecutor(max_workers=len(fns)) as pool:
            return [f.result(timeout=600) for f in
                    [pool.submit(fn) for fn in fns]]

    survivors = (0, 2)
    try:
        t0 = time.perf_counter()
        sent = run([lambda b=b, c=c: b.replicate_ring(c, peers, tag="p11")
                    for b, c in zip(bounds, chans)])
        replicate_s = time.perf_counter() - t0
        for r in range(RANKS):
            if r not in survivors:
                chans[r].close()
        t0 = time.perf_counter()
        run([lambda r=r: bounds[r].recarve(
            2, peer=Peer(chans[r]), old_workers=peers,
            new_workers=peers.select(survivors), tag="p11", dead=(1, 3))
            for r in survivors])
        recarve_s = time.perf_counter() - t0
    finally:
        for c in chans:
            c.close()
    state = place_stacked([bounds[r] for r in survivors], c2)
    return state, {"wire_bytes": sum(sent), "replicate_s": replicate_s,
                   "recarve_s": recarve_s}


def phase_elastic(torch, np, kernels, tr):
    """gpt_small(max_seq=2048) under ZeRO-2 (pallas_ring, inner adam)
    through the step-based schedule ELASTIC_SCHEDULE, driven the KungFu
    way: a ConfigServer holds the cluster; at a change of size the loop
    PUTs ``cluster.resize(n)``, reads it back with ``fetch_cluster``,
    re-carves its ZeroBoundary, places it on a new Communicator and
    resumes from the StepSnapshot's params.  Checks, each fatal: the
    step after each resize bitwise equal to a fixed-world step from the
    same boundary hand-repadded; at 4 -> 2 four re-carve paths and chunk
    mode with dead ranks 1 and 3 bitwise equal; the ZeRO-3 shard
    re-carved 4 -> 2; exact launches of every step; falling loss."""
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.elastic import (ConfigServer, ZeroBoundary,
                                          fetch_cluster, step_based_schedule,
                                          total_steps)
    from kungfu_tpu_torch.ops.schedules import bucket_widths
    from kungfu_tpu_torch.optimizers import adam
    from kungfu_tpu_torch.parallel import zero
    from kungfu_tpu_torch.plan import Cluster, HostList
    from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                             tree_map, tree_unflatten)

    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    cfg = model.cfg
    total = sum(t.numel() for t in tree_leaves(params))
    check(total == FLAGSHIP_PARAMS, f"gpt_small has {total} params")
    launches = {key: 0 for key in _counts(kernels)}

    def buckets(n):
        return len(bucket_widths(math.ceil(total / n), n, 4, 4 << 20))

    timed = []

    def counted_step(z, p, o, n, stage, what):
        """One step, its launches checked against the exact count; its
        ms goes to ``timed``, apart from the state the boundaries
        commit."""
        _reset(kernels)
        t0 = time.perf_counter()
        p, o, loss = z.step(p, o, batch)
        loss = float(loss)  # synchronises
        ms = (time.perf_counter() - t0) * 1e3
        got = _counts(kernels)
        want = {key: 0 for key in got}
        want.update(_rank_launches(cfg, n), ring_rs=buckets(n),
                    ring_ag=buckets(n) if stage == 3 else 0)
        check(got == want, f"{what} ({n} ranks, ZeRO-{stage}) launched "
              f"{got}, expected {want}")
        for key, v in got.items():
            launches[key] += v
        check(math.isfinite(loss), f"{what}: loss {loss}")
        timed.append(ms)
        return p, o, loss

    def world(n, version, strategy):
        comm = Communicator(devices=["cuda:0"] * n, local_size=n,
                            strategy=strategy, version=version)
        return comm, zero.zero_train_step(loss_fn, adam(ELASTIC_LR), comm,
                                          stage=2, schedule="pallas_ring")

    def to_card(tree):
        return tree_map(lambda t: t.to("cuda"), tree)

    hosts = HostList.parse(f"127.0.0.1:{RANKS}")
    server = ConfigServer(port=0, host="127.0.0.1", cluster=Cluster(
        hosts.gen_runner_list(), hosts.gen_peer_list(RANKS))).start()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    try:
        cluster, version = fetch_cluster(server.url)
        comm, z = world(cluster.size(), version, "psum")
        o, p = z.init_opt(params), params
        boundary, snap = ZeroBoundary(), StepSnapshot()
        losses, step_ms = [], {}
        commit_ms, snap_ms, resizes = [], [], []
        chunk_mode = None
        for step in range(total_steps(ELASTIC_SCHEDULE)):
            n = step_based_schedule(ELASTIC_SCHEDULE, step)
            fixed = None
            if n != comm.size:
                old_n, strategy = comm.size, comm.strategy
                got_v = _put_cluster(server.port, cluster.resize(n))
                cluster, version = fetch_cluster(server.url)
                check(version == got_v and cluster.size() == n,
                      f"config server: version {version} with "
                      f"{cluster.size()} workers after a PUT of {n}")
                rec = {"step": step, "from": old_n, "to": n,
                       "version": version}
                # the strategy carries across the resize
                new_comm, new_z = world(n, version, strategy)
                committed = boundary.export_carve()
                if n < old_n:
                    # check 2 (+ 3): the other re-carve paths, from the
                    # live old-world state, each kept until compared
                    t0 = time.perf_counter()
                    paths = {"zero1_reshard": zero.zero1_reshard(
                        o, p, new_comm)}
                    torch.cuda.synchronize()
                    rec["zero1_reshard_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    fresh = zero.zero_train_step(
                        loss_fn, adam(ELASTIC_LR), new_comm).init_opt(params)
                    paths["snapshot_restore"] = zero.zero_restore(
                        zero.zero_snapshot(o), fresh, p, new_comm=new_comm)
                    del fresh
                    rec["snapshot_restore_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    paths["p2p"] = zero.zero_reshard_p2p(o, p, new_comm)
                    torch.cuda.synchronize()
                    rec["p2p_s"] = time.perf_counter() - t0
                    paths["chunk_mode"], chunk_mode = _chunk_mode_4_to_2(
                        o, total, new_comm)
                # free the old world's step, state and graphs
                del z, o, p
                torch.cuda.empty_cache()
                comm, z = new_comm, new_z
                del new_comm, new_z
                t0 = time.perf_counter()
                boundary.recarve(n)
                rec["recarve_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                o = boundary.place(comm)
                torch.cuda.synchronize()
                rec["place_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                p = to_card(snap.last()[1])
                torch.cuda.synchronize()
                rec["params_restore_s"] = time.perf_counter() - t0
                # check 1's fixed world: the committed state hand-repadded
                # in plain torch, on a communicator and step of its own
                _, _, _, _, _, _, vec, scal = committed
                chunk = math.ceil(total / n)
                o_fx = []
                for i in range(len(vec) + len(scal)):
                    if i in vec:
                        buf = torch.zeros(chunk * n, dtype=vec[i].dtype)
                        buf[:total] = vec[i][:total]
                        o_fx.append(buf.view(n, chunk).cuda())
                    else:
                        o_fx.append(scal[i].cuda())
                o_fx = tree_unflatten(tree_flatten(o)[1], o_fx)
                del committed, vec, scal
                for name, state in (paths.items() if n < old_n else ()):
                    _check_bitwise(torch, state, o, f"{old_n} -> {n} "
                                   f"{name} vs ZeroBoundary full mode")
                if n < old_n:
                    del paths["zero1_reshard"], paths["snapshot_restore"], \
                        paths["p2p"]
                    torch.cuda.empty_cache()
                _check_bitwise(torch, o_fx, o, f"{old_n} -> {n} hand "
                               "repad vs ZeroBoundary full mode")
                _, z_fx = world(n, version, strategy)
                fixed = counted_step(z_fx, to_card(snap.last()[1]), o_fx, n,
                                     2, f"fixed-world step {step}")
                del z_fx, o_fx
                if n < old_n:
                    ck = counted_step(z, to_card(snap.last()[1]),
                                      paths.pop("chunk_mode"), n, 2,
                                      f"chunk-mode step {step}")
                    _check_bitwise(torch, ck[:2], fixed[:2], f"step "
                                   f"{step} from the chunk-mode carve vs "
                                   "the fixed world")
                    del ck
                resizes.append(rec)
                print(f"elastic: resize {old_n} -> {n} at step {step} "
                      f"(config version {version}): " + ", ".join(
                          f"{k} {v:.3f}" for k, v in rec.items()
                          if k.endswith("_s")))
            p, o, loss = counted_step(z, p, o, n, 2, f"elastic step {step}")
            losses.append(loss)
            step_ms.setdefault(n, []).append(timed[-1])
            if fixed is not None:
                _check_bitwise(torch, (p, o), fixed[:2], f"step {step} "
                               f"after the resize to {n} vs the fixed world")
                check(loss == fixed[2], f"step {step} loss {loss} != "
                      f"fixed world's {fixed[2]}")
                del fixed
            t0 = time.perf_counter()
            boundary.commit(step, o, p)
            commit_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            snap.commit(step, p)
            snap_ms.append((time.perf_counter() - t0) * 1e3)
        sizes = [step_based_schedule(ELASTIC_SCHEDULE, s)
                 for s in range(len(losses))]
        print(f"elastic: schedule {ELASTIC_SCHEDULE}, sizes {sizes}, "
              f"losses {[round(x, 4) for x in losses]}")
        check(losses[-1] < losses[0], f"elastic loss did not fall: {losses}")
    finally:
        server.stop()
    del z, o, p, boundary, snap
    torch.cuda.empty_cache()

    # check 4: ZeRO-3 at four ranks, its param shard (and state)
    # re-carved to two, gathered bitwise, and one stage-3 step at two
    c4 = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    z3 = zero.zero_train_step(loss_fn, adam(ELASTIC_LR), c4, stage=3,
                              schedule="pallas_ring")
    ps, o3, loss3 = counted_step(z3, z3.init_params(params),
                                 z3.init_opt(params), RANKS, 3, "ZeRO-3 step")
    ms3 = timed[-1]
    b3 = ZeroBoundary()
    b3.commit(0, {"opt": o3, "p": ps}, params)
    full_old = tree_map(torch.clone, z3.gather_params(ps))
    del z3, ps, o3
    torch.cuda.empty_cache()
    b3.recarve(2)
    c2 = Communicator(devices=["cuda:0"] * 2, local_size=2)
    st = b3.place(c2)
    z32 = zero.zero_train_step(loss_fn, adam(ELASTIC_LR), c2, stage=3,
                               schedule="pallas_ring")
    z32.init_params(params)  # binds the stage-3 geometry
    _check_bitwise(torch, z32.gather_params(st["p"]), full_old,
                   "ZeRO-3 params gathered after the 4 -> 2 re-carve vs "
                   "before")
    del full_old
    _, _, loss32 = counted_step(z32, st["p"], st["opt"], 2, 3,
                                "ZeRO-3 step at 2 ranks")
    ms32 = timed[-1]
    del z32, st, b3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = time.perf_counter() - t_phase
    ms4 = statistics.median(step_ms[RANKS])
    ms2 = statistics.median(step_ms[2])
    print(f"elastic: step ms median {ms4:.2f} at 4 ranks "
          f"({step_ms[RANKS]}), {ms2:.2f} at 2 ({step_ms[2]}); "
          f"ZeroBoundary.commit ms median {statistics.median(commit_ms):.2f} "
          f"({[round(x, 2) for x in commit_ms]}, D2H of "
          f"{2 * total * 4} bytes of Adam state); StepSnapshot.commit ms "
          f"median {statistics.median(snap_ms):.2f} ({total * 4} bytes of "
          f"params)")
    print(f"elastic: chunk mode, dead ranks 1 and 3: replicate_ring "
          f"{chunk_mode['wire_bytes']} bytes on the wire in "
          f"{chunk_mode['replicate_s']:.3f} s "
          f"({chunk_mode['wire_bytes'] / chunk_mode['replicate_s'] / 1e9:.2f}"
          f" GB/s), recarve {chunk_mode['recarve_s']:.3f} s; ZeRO-3 steps "
          f"{ms3:.2f} ms at 4 ranks, {ms32:.2f} at 2; peak memory "
          f"{peak:.2f} GiB; phase {wall:.1f} s")
    return {"launches": launches, "schedule": ELASTIC_SCHEDULE,
            "losses": losses, "step_ms": {str(k): v for k, v in
                                          step_ms.items()},
            "step_ms_median_4": ms4, "step_ms_median_2": ms2,
            "boundary_commit_ms": commit_ms, "snapshot_commit_ms": snap_ms,
            "resizes": resizes, "chunk_mode": chunk_mode,
            "zero3_step_ms": [ms3, ms32], "zero3_losses": [loss3, loss32],
            "peak_gib": peak, "wall_s": wall}


def _spread(tree) -> float:
    """The cross-rank spread of a stacked tree: the largest standard
    deviation over the ranks of any element of any leaf."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    return max(float(t.float().std(0).max()) for t in tree_leaves(tree))


def _recording(tx, seen: dict):
    """``tx`` whose first ``update`` keeps a copy of the (stacked)
    gradients it receives in ``seen["grads"]``."""
    from kungfu_tpu_torch.optimizers import GradientTransformation
    from kungfu_tpu_torch.utils.tree import tree_map

    def update(grads, state, params=None):
        if "grads" not in seen:
            seen["grads"] = tree_map(lambda g: g.clone(), grads)
        return tx.update(grads, state, params)

    return GradientTransformation(tx.init, update)


def _rel_l2_per_rank(tr, got, ref) -> tuple:
    """Worst relative L2 over leaves and ranks of two stacked trees
    (denominator floored at 1e-3 of the largest leaf norm of the rank),
    with its leaf and rank."""
    flat_g, flat_r = tr.flatten(got), tr.flatten(ref)
    worst = (0.0, "", 0)
    for r in range(RANKS):
        norms = {k: t[r].float().norm().item() for k, t in flat_r.items()}
        floor = 1e-3 * max(norms.values())
        for k in flat_r:
            rel = ((flat_g[k][r].float() - flat_r[k][r].float()).norm().item()
                   / max(norms[k], floor))
            worst = max(worst, (rel, k, r))
    return worst


def _host_noise_stats(torch, grads, b_small: int) -> dict:
    """The mean over ranks of the square norms, the square norm of the
    mean, the variance and the raw GNS of stacked gradients, in f64 on
    the host, leaf by leaf."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    local = torch.zeros(RANKS, dtype=torch.float64)
    global_sq = 0.0
    for g in tree_leaves(grads):
        h = g.detach().to("cpu", torch.float64).reshape(RANKS, -1)
        local += (h * h).sum(1)
        m = h.mean(0)
        global_sq += float((m * m).sum())
        del h, m
    local_sq = float(local.mean())
    b_big = b_small * RANKS
    g2 = (b_big * global_sq - b_small * local_sq) / (b_big - b_small)
    s = (local_sq - global_sq) / (1.0 / b_small - 1.0 / b_big)
    return {"local_sq": local_sq, "global_sq": global_sq,
            "variance": local_sq - global_sq, "gns": s / abs(g2)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _bert_build(torch, np, tr, kernels):
    """bert_base() with random weights from seed 0 on the card, the
    global batch ([RANKS * BERT_ROWS, BERT_SEQ] ids and targets from
    ``default_rng(0)``) and phase 6's loss with the flash attention:
    ``(model, params, batch, loss_fn)``, shared by phases 10 and 12."""
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    model = tr.bert_base()
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    rows = RANKS * BERT_ROWS
    batch = tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(rows, BERT_SEQ))).cuda() for _ in range(2))
    flash = kernels[0].make_flash_attn()
    torch.cuda.synchronize()
    print(f"bert: bert_base() {n_params} f32 params (vocab "
          f"{cfg.vocab_size}, d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, pos {cfg.pos}, causal "
          f"{cfg.causal}, compute {cfg.dtype}); {RANKS} ranks x "
          f"[{BERT_ROWS}, {BERT_SEQ}] tokens; init "
          f"{time.perf_counter() - t0:.2f} s")
    check(n_params == BERT_PARAMS, f"bert_base() has {n_params} params, "
          f"expected {BERT_PARAMS}")

    def loss_fn(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=flash)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    return model, params, batch, loss_fn


def phase_replicas(torch, np, kernels, tr, costmodel, spec, bert):
    """bert_base() on RANKS co-resident ranks: SMA and AdaptiveSGD over
    stacked per-replica params, the GNS and variance monitors on the
    replicated step, and the autotune of the allreduce schedule.  Each
    main-path run counts its launches from zero; the comparison runs
    (the step under KF_TPU_ATTN=xla, SMA with alpha 0) are not
    counted."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collective, xent
    from kungfu_tpu_torch.ops.monitor import rank_sq_norms
    from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES
    from kungfu_tpu_torch.optimizers import (adaptive_sgd,
                                             monitor_gradient_noise_scale,
                                             monitor_gradient_variance, sgd,
                                             synchronous_averaging)
    from kungfu_tpu_torch.parallel.train import (dp_train_step,
                                                 stack_for_replicas)
    from kungfu_tpu_torch.utils.tree import tree_leaves

    model, params, batch, loss_fn = bert
    cfg = model.cfg
    n_params = sum(t.numel() for t in tree_leaves(params))
    rows = RANKS * BERT_ROWS

    def loss_xla(p, b):  # attention picked by KF_TPU_ATTN, set to xla
        logits = model.apply(p, b[0], train=True)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    want_step = {key: 0 for key in _counts(kernels)}
    want_step.update(flash_fwd=RANKS * cfg.n_layers,
                     flash_bwd_dq=RANKS * cfg.n_layers,
                     flash_bwd_dkv=RANKS * cfg.n_layers,
                     xent_fwd=RANKS, xent_bwd=RANKS)
    tokens = rows * BERT_SEQ
    flops = costmodel.train_step_flops(cfg, rows, BERT_SEQ)
    launches = {key: 0 for key in want_step}
    out = {"params": n_params}

    def add(counts):
        for key, v in counts.items():
            launches[key] += v

    def measure(name, times, peak, per_step):
        step_ms = statistics.median(times)
        m = {"step_ms": step_ms, "step_ms_all": times,
             "tokens_s": tokens / (step_ms / 1e3),
             "mfu": flops / (step_ms / 1e3) / spec["bf16_flops"],
             "launches_per_step": per_step, "peak_gib": peak}
        print(f"replicas {name} ({RANKS} ranks on one card): {step_ms:.2f} "
              f"ms/step median of {len(times)} ({min(times):.2f}-"
              f"{max(times):.2f}), {m['tokens_s']:.0f} tokens/s over the "
              f"global batch, {flops / 1e12:.3f} TFLOP/step, MFU "
              f"{m['mfu']:.4f}; launches per step {per_step}; peak memory "
              f"of the timed steps {peak:.2f} GiB")
        return m

    def stacked_start(tx):
        return (stack_for_replicas(params, RANKS),
                stack_for_replicas(tx.init(params), RANKS))

    # 1. SMA: the first step through the kernels, launches from zero
    seen = {}
    tx = _recording(synchronous_averaging(inner, comm.axis, alpha=SMA_ALPHA),
                    seen)
    step = dp_train_step(loss_fn, tx, comm, replicated_params=False)
    p, o = stacked_start(tx)
    _reset(kernels)
    p, o, loss = step(p, o, batch)
    torch.cuda.synchronize()
    per_step = _counts(kernels)
    add(per_step)
    print(f"replicas SMA step launches: {per_step}")
    check(per_step == want_step, f"one SMA step launched {per_step}, "
          f"expected {want_step}")
    losses = [float(loss)]
    g_kern = seen.pop("grads")

    # the same first step under KF_TPU_ATTN=xla (not counted)
    seen_x = {}
    tx_x = _recording(synchronous_averaging(inner, comm.axis,
                                            alpha=SMA_ALPHA), seen_x)
    saved = os.environ.get("KF_TPU_ATTN")
    os.environ["KF_TPU_ATTN"] = "xla"
    try:
        p_x, _, loss_x = dp_train_step(
            loss_xla, tx_x, comm, replicated_params=False)(
                *stacked_start(tx_x), batch)
        torch.cuda.synchronize()
    finally:
        if saved is None:
            os.environ.pop("KF_TPU_ATTN")
        else:
            os.environ["KF_TPU_ATTN"] = saved
    p_rel = _rel_l2_per_rank(tr, p, p_x)
    g_rel = _rel_l2_per_rank(tr, g_kern, seen_x.pop("grads"))
    del g_kern, p_x
    # each rank's params are held; its gradient (the whole update at step
    # 1, whose pull is 0) is reported: the flash backward's q and k
    # gradients stand further from the plain path's at BERT's nearly
    # uniform attention than phase 6's causal ones do (PERF.md §6)
    print(f"replicas SMA step 1 vs the same step under KF_TPU_ATTN=xla: "
          f"loss {losses[0]:.6f} vs {float(loss_x):.6f}; each rank's params "
          f"worst rel L2 {p_rel[0]:.3e} ({p_rel[1]}, rank {p_rel[2]}; tol "
          f"{TRAIN_GRAD_REL_L2}); each rank's gradient worst rel L2 "
          f"{g_rel[0]:.3e} ({g_rel[1]}, rank {g_rel[2]})")
    check(p_rel[0] <= TRAIN_GRAD_REL_L2,
          f"SMA step 1 params differ from the xla step's: {p_rel}")
    head = tr.flatten(p)["head/w"]
    differ = sum(not all(torch.equal(t[0], t[r]) for r in range(1, RANKS))
                 for t in tree_leaves(p))
    spread1 = _spread(p)
    print(f"replicas SMA after step 1: {differ} of {len(tree_leaves(p))} "
          f"leaves differ between ranks; spread {spread1:.3e}")
    check(spread1 > 0 and not torch.equal(head[0], head[1]),
          "SMA step 1 left the replicas equal: the step replicated")

    _reset(kernels)
    p, o, times, peak = _timed_steps(torch, np, step, p, o, batch, losses)
    add(_counts(kernels))
    spread_sma = _spread(p)
    print(f"replicas SMA losses: {[round(x, 4) for x in losses]}")
    out["sma"] = {"losses": losses, "first_loss_xla": float(loss_x),
                  "params_rel_l2_vs_xla": p_rel[0],
                  "grads_rel_l2_vs_xla": g_rel[0],
                  "leaves_differing_after_step1": differ,
                  "spread_after_step1": spread1,
                  "spread": spread_sma,
                  **measure("SMA", times, peak, per_step)}
    del p, o, step, tx

    # SMA with alpha 0 (local SGD), the same ten steps (not counted)
    tx0 = synchronous_averaging(inner, comm.axis, alpha=0.0)
    step0 = dp_train_step(loss_fn, tx0, comm, replicated_params=False)
    p, o = stacked_start(tx0)
    for _ in range(TRAIN_STEPS):
        p, o, _ = step0(p, o, batch)
    spread0 = _spread(p)
    del p, o, step0
    print(f"replicas SMA cross-rank spread after {TRAIN_STEPS} steps: alpha "
          f"{SMA_ALPHA} {spread_sma:.3e}, alpha 0 {spread0:.3e}")
    check(spread_sma < spread0, "SMA's pull did not hold the replicas closer "
          "than local SGD")
    out["sma"]["spread_alpha0"] = spread0
    torch.cuda.empty_cache()

    # 2. AdaptiveSGD: SMA for ADA_CHANGE_STEP steps, the full pull, S-SGD
    tx = adaptive_sgd(inner, comm.axis, change_step=ADA_CHANGE_STEP)
    step = dp_train_step(loss_fn, tx, comm, replicated_params=False)
    p, o = stacked_start(tx)
    _reset(kernels)
    losses, spreads = [], []
    for _ in range(TRAIN_STEPS):
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))
        spreads.append(_spread(p))
    add(_counts(kernels))
    before, after = spreads[ADA_CHANGE_STEP - 1], spreads[ADA_CHANGE_STEP]
    print(f"replicas AdaptiveSGD losses: {[round(x, 4) for x in losses]}; "
          f"spread per step {[float(f'{x:.3e}') for x in spreads]}; right "
          f"before the switch (step {ADA_CHANGE_STEP}) {before:.3e}, right "
          f"after the switch step {after:.3e}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"AdaptiveSGD loss did not fall: {losses}")
    check(after < before, "AdaptiveSGD's switch did not bring the replicas "
          "closer")
    check(o.step.tolist() == [TRAIN_STEPS] * RANKS,
          f"AdaptiveSGD step counts {o.step.tolist()}")
    out["adaptive_sgd"] = {"losses": losses, "spreads": spreads,
                           "spread_before_switch": before,
                           "spread_after_switch": after}
    del p, o, step, tx
    torch.cuda.empty_cache()

    # 3. the monitors on the replicated step
    def monitor_run(name, make_tx):
        seen = {}
        tx = _recording(make_tx(), seen)
        step = dp_train_step(loss_fn, tx, comm)
        p, o = params, tx.init(params)
        _reset(kernels)
        p, o, loss = step(p, o, batch)
        torch.cuda.synchronize()
        per_step = _counts(kernels)
        check(per_step == want_step, f"one {name} step launched {per_step}")
        first = o
        losses = [float(loss)]
        _reset(kernels)
        p, o, times, peak = _timed_steps(torch, np, step, p, o, batch, losses,
                                         steps=MONITOR_STEPS)
        counts = _counts(kernels)
        add(per_step)
        add(counts)
        print(f"replicas {name} losses: {[round(x, 4) for x in losses]}")
        return seen.pop("grads"), first, o, losses, times, peak, per_step

    g, first, last, losses, times, peak, per_step = monitor_run(
        "GNS", lambda: monitor_gradient_noise_scale(
            inner, comm.axis, local_batch_size=BERT_ROWS))
    host = _host_noise_stats(torch, g, BERT_ROWS)
    with comm.world():
        dev_local = float(collective.all_reduce(
            rank_sq_norms(g), comm.axis, op="mean")[0])
        dev_global = float(rank_sq_norms(collective.all_reduce(
            g, comm.axis, op="mean"))[0])
    del g
    raw = float(first.noise_scale)  # the EMA's first sample is the raw one
    errs = {"local_sq": _rel(dev_local, host["local_sq"]),
            "global_sq": _rel(dev_global, host["global_sq"]),
            "gns": _rel(raw, host["gns"])}
    print(f"replicas GNS step 1: mean |g_r|^2 {dev_local:.6e} (f64 "
          f"{host['local_sq']:.6e}, rel {errs['local_sq']:.2e}), |mean g|^2 "
          f"{dev_global:.6e} (f64 {host['global_sq']:.6e}, rel "
          f"{errs['global_sq']:.2e}), tol {GNS_SQ_RTOL}; raw GNS {raw:.6e} "
          f"(f64 {host['gns']:.6e}, rel {errs['gns']:.2e}, tol {GNS_RTOL}); "
          f"smoothed after {MONITOR_STEPS} steps "
          f"{float(last.noise_scale):.6e}")
    check(errs["local_sq"] <= GNS_SQ_RTOL and errs["global_sq"] <= GNS_SQ_RTOL,
          f"square norms differ from f64: {errs}")
    check(errs["gns"] <= GNS_RTOL, f"raw GNS differs from f64: {errs}")
    check(math.isfinite(float(last.noise_scale)), "non-finite noise scale")
    out["gns"] = {"losses": losses, "host_f64": host,
                  "device_local_sq": dev_local, "device_global_sq": dev_global,
                  "raw_gns_step1": raw, "rel_errors": errs,
                  "noise_scale": float(last.noise_scale),
                  **measure("GNS", times, peak, per_step)}
    del first, last
    torch.cuda.empty_cache()

    g, first, last, losses, *_ = monitor_run(
        "variance", lambda: monitor_gradient_variance(inner, comm.axis))
    host = _host_noise_stats(torch, g, BERT_ROWS)
    del g
    var = float(first.variance)
    err = _rel(var, host["variance"])
    print(f"replicas variance step 1: {var:.6e} (f64 {host['variance']:.6e}, "
          f"rel {err:.2e}, tol {GNS_SQ_RTOL}); after {MONITOR_STEPS} steps "
          f"{float(last.variance):.6e}")
    check(err <= GNS_SQ_RTOL, f"variance differs from f64 by {err}")
    check(float(last.variance) >= 0.0, "negative variance")
    out["variance"] = {"losses": losses, "variance_step1": var,
                       "host_f64": host["variance"], "rel_error": err,
                       "variance": float(last.variance)}
    del first, last, params
    torch.cuda.empty_cache()

    # 4. the autotune of the allreduce schedule (4 MiB a rank)
    _reset(kernels)
    winner = comm.autotune_strategy()
    torch.cuda.synchronize()
    counts = _counts(kernels)
    add(counts)
    times = comm.autotune_times
    print(f"replicas autotune: {winner} over "
          f"{ {k: round(v * 1e3, 4) for k, v in times.items()} } ms per "
          f"allreduce of 4 MiB a rank; launches {counts}")
    check(comm.strategy == winner, "autotune did not install its winner")
    check(set(times) == set(ALLREDUCE_SCHEDULES)
          and all(0 < v < 1e8 for v in times.values()),
          f"autotune did not time every schedule: {times}")
    check(counts["ring_rs"] > 0 and counts["ring_ag"] > 0,
          f"autotune's pallas_ring candidate launched {counts}")
    x = torch.randn((RANKS, 1 << 20), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    got = comm.all_reduce(x, op="mean")
    ref = Communicator(devices=["cuda:0"] * RANKS).all_reduce(x, op="mean")
    ratio = _ratio(got, ref, AUTOTUNE_RTOL, AUTOTUNE_ATOL)
    print(f"replicas allreduce mean under {winner} vs psum: {ratio:.3f} of "
          f"rtol {AUTOTUNE_RTOL} atol {AUTOTUNE_ATOL}")
    check(ratio <= 1.0, f"allreduce under {winner} differs from psum's")
    out["autotune"] = {"winner": winner, "ms": {k: v * 1e3 for k, v in
                                                 times.items()},
                       "launches": counts, "vs_psum_ratio": ratio}
    out["launches"] = launches
    return out

def _run_ranks(fns, timeout: float = 600.0,
               return_exceptions: bool = False) -> list:
    """Each callable on a daemon thread of its own (one a rank), their
    results in order; a thread still running after ``timeout`` fails the
    run instead of hanging it.  The first exception any raised is raised
    here, or with ``return_exceptions`` stands in the results."""
    import threading

    outs = [None] * len(fns)

    def wrap(i, fn):
        try:
            outs[i] = fn()
        except BaseException as e:  # noqa: BLE001 - raised or returned below
            outs[i] = e

    ts = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + timeout
    for t in ts:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, t in enumerate(ts) if t.is_alive()]
    check(not hung, f"threads {hung} still running after {timeout} s")
    if not return_exceptions:
        for x in outs:
            if isinstance(x, BaseException):
                raise x
    return outs


def _host_zero_geometry(total: int, n: int):
    """``(chunk, bucket widths)`` of an ``n``-rank host-plane ZeRO world."""
    chunk = math.ceil(total / n)
    nb, rem = divmod(chunk, HOST_BUCKET)
    return chunk, [HOST_BUCKET] * nb + ([rem] if rem else [])


def _host_sq_norms(np, bufs, avg) -> tuple:
    """``(mean over ranks of |g_r|^2, |avg|^2)`` in f64 numpy, as
    ``host_noise_scale`` takes them."""
    local = [float(np.sum(np.square(b.numpy().astype(np.float64))))
             for b in bufs]
    return (sum(local) / len(local),
            float(np.sum(np.square(avg.numpy().astype(np.float64)))))


def phase_host_engine(torch, np, kernels, tr, bert, gns10):
    """benchmarks/system.py's ``--backend host --model bert`` loop on the
    real model: each step, every rank's bert_base() gradient on the card
    (phase 10's model, batch and loss), copied into the rank's pinned
    f32 buffer, mean-allreduced in place by four CollectiveEngines (one
    thread a rank) over NativeHostChannels from HostChannel's default
    ``auto`` on loopback, copied back to the card and applied with
    ``sgd(1e-3, momentum=0.9)``.  Checks (a)-(h), each fatal: (a) native
    channels and the C++ executor; (b) the four reduced buffers bitwise
    equal to each other and to the plain graph walk; (c) the C++ executor
    and the Python path bitwise equal for every strategy on a 16 MiB
    slice, and on the whole buffer for the default strategy; (d) the
    params after step 1 against the device-plane S-SGD step; (e) falling
    loss; (f) a strategy swap at a step boundary; (g) ZeRO-2 over the
    host plane, pipelined bitwise equal to serial and close to (d); (h)
    host_noise_scale against phase 10's GNS monitor.  Launches are
    counted over the main-path steps only."""
    import shutil
    import tempfile

    from kungfu_tpu_torch.comm import engine as E
    from kungfu_tpu_torch.comm.host import HostChannel, NativeHostChannel
    from kungfu_tpu_torch.native import transport as nt
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.utils.tree import tree_flatten

    t_phase = time.perf_counter()
    model, params, batch, loss_fn = bert
    leaves, treedef = tree_flatten(params)
    sizes = [t.numel() for t in leaves]
    total = sum(sizes)
    check(total == BERT_PARAMS, f"{total} params, expected {BERT_PARAMS}")
    out = {"params": total}

    # (a) the library built from the checkout's sources, the channels
    # from the factory's default auto, the engines on AUTO
    t0 = time.perf_counter()
    check(nt.available(), "the native host library did not build")
    out["native_build_s"] = time.perf_counter() - t0
    for k in ("KF_TPU_HOST_TRANSPORT", "KF_NATIVE_ENGINE", "KF_CHAOS_SPEC",
              "KF_CONFIG_CHUNK_SIZE"):
        os.environ.pop(k, None)
    sock_dir = tempfile.mkdtemp(prefix="kfsock")
    os.environ["KF_SOCK_DIR"] = sock_dir
    unix = len(sock_dir) < 64  # AF_UNIX paths stop at 107 bytes
    os.environ["KF_TPU_USE_UNIXSOCK"] = "1" if unix else "0"
    chans = [HostChannel(PeerID("127.0.0.1", 0), bind_host="127.0.0.1")
             for _ in range(RANKS)]
    try:
        check(all(type(c) is NativeHostChannel for c in chans),
              f"HostChannel gave {[type(c).__name__ for c in chans]}")
        peers = PeerList.of(*(c.self_id for c in chans))
        engines = [E.CollectiveEngine(c, peers) for c in chans]
        chunk_bytes = E.engine_chunk_size(True)
        print(f"host engine: {RANKS} NativeHostChannels on {peers} "
              f"({'unix sockets' if unix else 'TCP'} on loopback), library "
              f"built in {out['native_build_s']:.2f} s; strategy AUTO = "
              f"{E.auto_select(1)}, {len(engines[0]._graphs)} graph pairs; "
              f"chunk {chunk_bytes} B; {E.engine_threads()} executor "
              f"threads a rank")
        out.update(_host_engine_steps(torch, np, kernels, E, engines, model,
                                      params, batch, loss_fn, treedef, sizes,
                                      chunk_bytes, gns10))
    finally:
        for c in chans:
            c.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _host_engine_steps(torch, np, kernels, E, engines, model, params, batch,
                       loss_fn, treedef, sizes, chunk_bytes, gns10):
    """Phase 12's steps and checks over the engines (see
    :func:`phase_host_engine`)."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops.monitor import host_noise_scale
    from kungfu_tpu_torch.optimizers import (apply_updates, sgd,
                                             synchronous_sgd)
    from kungfu_tpu_torch.parallel.train import (dp_train_step,
                                                 per_rank_grads, split_batch)
    from kungfu_tpu_torch.parallel.zero import (host_bucket_all_gather,
                                                host_bucket_pipeline,
                                                host_bucket_spans)
    from kungfu_tpu_torch.plan import Strategy
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    total = sum(sizes)
    shapes = [t.shape for t in tree_flatten(params)[0]]
    cfg = model.cfg
    shards = split_batch(batch, RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    bufs = [torch.empty(total, dtype=torch.float32, pin_memory=True)
            for _ in range(RANKS)]
    dev = torch.empty((RANKS, total), dtype=torch.float32, device="cuda")
    pinned = sum(b.numel() * b.element_size() for b in bufs)
    want_step = {key: 0 for key in _counts(kernels)}
    want_step.update(_rank_launches(cfg))
    launches = {key: 0 for key in want_step}
    out = {"pinned_bytes": pinned}

    def unflat(flat):
        parts, off = [], 0
        for k, shape in zip(sizes, shapes):
            parts.append(flat[off:off + k].view(shape))
            off += k
        return tree_unflatten(treedef, parts)

    def allreduce(tag, inplace=True, srcs=None):
        srcs = bufs if srcs is None else srcs
        return _run_ranks([lambda i=i: engines[i].all_reduce(
            srcs[i], op="mean", inplace=inplace, name=tag)
            for i in range(RANKS)])

    def step(p, o, k):
        """One main-path step; its phase times in ms and the loss."""
        _reset(kernels)
        t0 = time.perf_counter()

        def sink(r, grads):
            off = 0
            for g, n in zip(grads, sizes):
                dev[r, off:off + n].copy_(g.reshape(-1))
                off += n

        outs, _ = per_rank_grads(loss_fn, p, shards, sink)
        loss = sum(float(x) for x in outs) / RANKS  # synchronises
        t1 = time.perf_counter()
        for r in range(RANKS):
            bufs[r].copy_(dev[r])
        t2 = time.perf_counter()
        per = _counts(kernels)
        for key, v in per.items():
            launches[key] += v
        check(per == want_step, f"host-engine step {k} launched {per}, "
              f"expected {want_step}")
        return loss, {"grads_ms": (t1 - t0) * 1e3, "d2h_ms": (t2 - t1) * 1e3}

    def finish(p, o, times):
        t0 = time.perf_counter()
        allreduce(f"g{len(losses)}")
        t1 = time.perf_counter()
        g = unflat(bufs[0].to("cuda", non_blocking=True))
        u, o = inner.update(g, o, p)
        p = apply_updates(p, u)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        times.update(allreduce_ms=(t1 - t0) * 1e3,
                     h2d_update_ms=(t2 - t1) * 1e3)
        times["step_ms"] = sum(times[k] for k in (
            "grads_ms", "d2h_ms", "allreduce_ms", "h2d_update_ms"))
        return p, o

    def check_b(inputs, what):
        """(b): every rank's reduced buffer bitwise equal to the others'
        and to the plain walk of the engines' current graphs."""
        t0 = time.perf_counter()
        plain = E.graph_all_reduce_reference(inputs, engines[0]._graphs,
                                             "mean", chunk_size=chunk_bytes)
        same = [torch.equal(bufs[r], bufs[0]) for r in range(RANKS)]
        walk = [torch.equal(bufs[r], plain[r]) for r in range(RANKS)]
        print(f"host engine {what}: reduced buffers bitwise equal to rank "
              f"0's {same}, to the plain graph walk {walk} (walk "
              f"{time.perf_counter() - t0:.2f} s)")
        check(all(same) and all(walk), f"{what}: reduced buffers differ")

    losses, rows = [], []
    p, o = params, inner.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # step 1, with every check of the step-1 gradients
    loss, times = step(p, o, 1)
    losses.append(loss)
    inputs = [b.clone() for b in bufs]
    p, o = finish(p, o, times)
    rows.append(times)
    check(all(e.native_runs == 1 for e in engines),
          f"(a) the C++ executor ran {[e.native_runs for e in engines]}")
    check_b(inputs, "step 1")
    reduced = bufs[0].clone()

    # (h) the noise scale over the host plane against phase 10's monitor
    t0 = time.perf_counter()
    raw = _run_ranks([lambda i=i: host_noise_scale(
        engines[i], inputs[i], bufs[i], BERT_ROWS) for i in range(RANKS)])
    local_sq, global_sq = _host_sq_norms(np, inputs, reduced)
    errs = {"local_sq": _rel(local_sq, gns10["device_local_sq"]),
            "global_sq": _rel(global_sq, gns10["device_global_sq"]),
            "gns": max(_rel(x, gns10["raw_gns_step1"]) for x in raw)}
    print(f"host engine (h): host_noise_scale per rank {raw}; phase 10's "
          f"raw GNS {gns10['raw_gns_step1']:.6e}; mean |g_r|^2 "
          f"{local_sq:.6e} vs {gns10['device_local_sq']:.6e}, |mean g|^2 "
          f"{global_sq:.6e} vs {gns10['device_global_sq']:.6e}; rel "
          f"{errs} (tol {GNS_SQ_RTOL} norms, {GNS_RTOL} GNS; "
          f"{time.perf_counter() - t0:.2f} s)")
    check(len(set(raw)) == 1, f"(h) ranks disagree: {raw}")
    check(errs["local_sq"] <= GNS_SQ_RTOL and errs["global_sq"] <= GNS_SQ_RTOL
          and errs["gns"] <= GNS_RTOL, f"(h) noise scale differs: {errs}")
    out["noise_scale"] = {"raw": raw[0], "local_sq": local_sq,
                          "global_sq": global_sq, "rel_errors": errs}

    # (d) the params after step 1 against the device-plane S-SGD step
    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    p_dev, _, loss_dev = dp_train_step(
        loss_fn, synchronous_sgd(inner, comm.axis), comm)(
            params, inner.init(params), batch)
    p_dev_leaves = tree_flatten(p_dev)[0]
    p1_leaves = tree_flatten(p)[0]
    rel_d = max(float((a - b).norm() / b.norm())
                for a, b in zip(p1_leaves, p_dev_leaves))
    print(f"host engine (d): params after step 1 vs the device-plane S-SGD "
          f"step: worst rel L2 per leaf {rel_d:.3e} (tol {HOST_PARAMS_RTOL});"
          f" loss {losses[0]:.6f} vs {float(loss_dev):.6f}")
    check(rel_d <= HOST_PARAMS_RTOL, f"(d) params differ by {rel_d}")
    out["params_vs_device_ssgd"] = rel_d
    p1_host = torch.cat([t.reshape(-1).cpu() for t in p1_leaves])
    del p_dev, p_dev_leaves

    # (g) ZeRO-2 over the host plane on the same gradients
    chunk, widths = _host_zero_geometry(total, RANKS)
    spans = host_bucket_spans(chunk, widths)
    p0_host = torch.cat([t.reshape(-1).cpu() for t in tree_flatten(
        params)[0]])
    zero = {}
    for pipelined in (True, False):
        def rank(i, pipelined=pipelined):
            own = p0_host[i * chunk:(i + 1) * chunk].clone()
            mom = torch.zeros(chunk)

            def compute(b, red):
                off, w = spans[b]
                m = red + mom[off:off + w] * BERT_MOMENTUM
                mom[off:off + w] = m
                own[off:off + w] += -BERT_LR * m

            tag = "z2p" if pipelined else "z2s"
            host_bucket_pipeline(engines[i], inputs[i], widths, compute,
                                 op="mean", pipelined=pipelined, name=tag)
            return host_bucket_all_gather(engines[i], own, widths,
                                          pipelined=pipelined,
                                          name=tag + "g")

        t0 = time.perf_counter()
        zero[pipelined] = _run_ranks([lambda i=i: rank(i)
                                      for i in range(RANKS)])
        zero[f"{pipelined}_s"] = time.perf_counter() - t0
    z_same = all(torch.equal(zero[True][r], zero[False][r]) and
                 torch.equal(zero[True][r], zero[True][0])
                 for r in range(RANKS))
    z_rel = max(float((zero[True][0][off:off + k] - p1_host[off:off + k]).norm()
                      / p1_host[off:off + k].norm())
                for off, k in zip([0] + [int(x) for x in np.cumsum(sizes)[:-1]],
                                  sizes))
    print(f"host engine (g): ZeRO-2 over the host plane, {len(widths)} "
          f"buckets of {HOST_BUCKET} columns a rank: pipelined "
          f"{zero['True_s']:.2f} s, serial {zero['False_s']:.2f} s; "
          f"pipelined bitwise equal to serial on every rank {z_same}; vs (d)'s"
          f" params worst rel L2 per leaf {z_rel:.3e} (tol "
          f"{HOST_PARAMS_RTOL})")
    check(z_same, "(g) pipelined ZeRO-2 differs from serial")
    check(z_rel <= HOST_PARAMS_RTOL, f"(g) ZeRO-2 params differ by {z_rel}")
    out["zero2"] = {"buckets": len(widths), "pipelined_s": zero["True_s"],
                    "serial_s": zero["False_s"], "rel_vs_d": z_rel}
    del zero, p0_host, p1_host

    # (c) the C++ executor against the Python path, every strategy on a
    # 16 MiB slice of step 1's gradients, the whole buffer for AUTO
    cut = HOST_SLICE_BYTES // 4
    sl = [x[:cut].clone() for x in inputs]
    strategies = {}
    for strat in [s for s in Strategy if s != Strategy.AUTO]:
        for e in engines:
            e.set_strategy(strat)
        t0 = time.perf_counter()
        cxx = allreduce(f"c.{strat.value}.x", inplace=False, srcs=sl)
        t1 = time.perf_counter()
        # the engine's own stats of the C++ run: bytes over summed chunk
        # seconds, per graph pair
        gbs = [float(b / t / 1e9) if t else 0.0 for b, t in engines[0].stats]
        os.environ["KF_NATIVE_ENGINE"] = "0"
        try:
            py = allreduce(f"c.{strat.value}.p", inplace=False, srcs=sl)
        finally:
            os.environ.pop("KF_NATIVE_ENGINE")
        t2 = time.perf_counter()
        plain = E.graph_all_reduce_reference(sl, engines[0]._graphs, "mean",
                                             chunk_size=chunk_bytes)
        ok = all(torch.equal(cxx[r], py[r]) and torch.equal(cxx[r], plain[r])
                 and torch.equal(cxx[r], cxx[0]) for r in range(RANKS))
        strategies[strat.value] = {
            "pairs": len(engines[0]._graphs), "cxx_s": t1 - t0,
            "python_s": t2 - t1, "wall_gb_s_cxx": HOST_SLICE_BYTES / (t1 - t0)
            / 1e9, "wall_gb_s_python": HOST_SLICE_BYTES / (t2 - t1) / 1e9,
            "stats_gb_s": gbs, "bitwise": ok}
        print(f"host engine (c) {strat.value}: {len(engines[0]._graphs)} "
              f"pairs; C++ {t1 - t0:.3f} s ({HOST_SLICE_BYTES / (t1 - t0) / 1e9:.3f}"
              f" GB/s of buffer), Python path {t2 - t1:.3f} s "
              f"({HOST_SLICE_BYTES / (t2 - t1) / 1e9:.3f} GB/s); per-pair "
              f"stats GB/s {[round(x, 3) for x in gbs]}; C++ = Python = "
              f"plain walk bitwise {ok}")
        check(ok, f"(c) {strat.value}: the C++ executor and the Python path "
              "differ")
    del sl
    for e in engines:
        e.set_strategy(Strategy.AUTO)
    t0 = time.perf_counter()
    os.environ["KF_NATIVE_ENGINE"] = "0"
    try:
        py_full = allreduce("c.full.p", inplace=False, srcs=inputs)
    finally:
        os.environ.pop("KF_NATIVE_ENGINE")
    full_s = time.perf_counter() - t0
    full_ok = all(torch.equal(x, reduced) for x in py_full)
    print(f"host engine (c) AUTO, whole buffer ({total * 4} B a rank): Python "
          f"path {full_s:.2f} s ({total * 4 / full_s / 1e9:.3f} GB/s), C++ "
          f"step 1 {rows[0]['allreduce_ms'] / 1e3:.2f} s; bitwise equal "
          f"{full_ok}")
    check(full_ok, "(c) the Python path differs from the C++ executor on "
          "the whole buffer")
    out["strategies"] = strategies
    out["python_path_full_s"] = full_s
    del py_full, inputs

    # (e) the timed steps, then (f) a swap at each of two step boundaries
    for k in range(2, HOST_STEPS + 1):
        loss, times = step(p, o, k)
        losses.append(loss)
        p, o = finish(p, o, times)
        rows.append(times)
    for strat in (Strategy.STAR, Strategy.RING):
        for e in engines:
            e.set_strategy(strat)
        loss, times = step(p, o, len(losses) + 1)
        losses.append(loss)
        inputs = [b.clone() for b in bufs]
        p, o = finish(p, o, times)
        check_b(inputs, f"(f) the step after set_strategy({strat.value})")
        del inputs
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = losses[:HOST_STEPS]
    print(f"host engine (e): losses {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(timed[-1] < timed[0], f"(e) loss did not fall: {timed}")
    check(all(e.native_runs >= HOST_STEPS + 3 for e in engines),
          f"(a) native runs {[e.native_runs for e in engines]}")
    med = {k: statistics.median(r[k] for r in rows[1:]) for k in rows[0]}
    print(f"host engine step ({RANKS} ranks, {total * 4} B a rank, median of "
          f"steps 2-{HOST_STEPS}): {med['step_ms']:.2f} ms = grads "
          f"{med['grads_ms']:.2f} + D2H {med['d2h_ms']:.2f} + allreduce "
          f"{med['allreduce_ms']:.2f} + H2D and update "
          f"{med['h2d_update_ms']:.2f}; first step {rows[0]['step_ms']:.2f} "
          f"ms ({ {k: round(v, 2) for k, v in rows[0].items()} }); allreduce "
          f"{total * 4 / (med['allreduce_ms'] / 1e3) / 1e9:.3f} GB/s of buffer"
          f"; pinned {out['pinned_bytes']} B; peak device memory "
          f"{peak:.2f} GiB; launches per step {want_step}")
    out.update(losses=losses, step_rows=rows, median=med, first=rows[0],
               peak_gib=peak, launches=launches, per_step=want_step,
               native_runs=[e.native_runs for e in engines])
    return out


#: phase 13: sgd on the host plane's ZeRO-2 step through a kill, a shrink
#: and a cold restore.  Step 1 runs at four ranks; old rank 3 dies in
#: mode=raise at its first engine collective of step 2; the survivors
#: replay from step 1 and run steps 2-3 at three ranks; a preempt:all
#: clause fires at elastic_step's announcement of step 3, and two fresh
#: peers restore the step-3 manifest and take step 4 (the kill was at
#: step 4, the preemption at 5 and the last step 6 before phases 24 and
#: 25 needed the room)
RECOVER_LR, RECOVER_MOMENTUM = 0.05, 0.9
RECOVER_RANKS = (4, 3, 2)
RECOVER_KILL_STEP, RECOVER_PREEMPT_STEP, RECOVER_LAST = 2, 3, 4
RECOVER_VICTIM = 3
#: per-peer deadline of the phase's engine collectives (s): above the
#: largest skew of a healthy step (rank 0 waits out its params manifest
#: before elastic_step's sync), below what a kill may cost
RECOVER_DEADLINE_S = 20.0
#: the kill's detection may take the deadline plus this (check (a))
RECOVER_DETECT_SLACK_S = 15.0
#: complete manifests kept by rank 0's GC
RECOVER_KEEP = 2


def _repad(torch, flat, total: int, n: int):
    """``flat``'s first ``total`` elements zero-padded into ``n`` chunks,
    ``[n, chunk]`` on the host: a state laid out for an ``n``-rank world
    by hand, in plain torch."""
    chunk = math.ceil(total / n)
    out = torch.zeros(n * chunk, dtype=flat.dtype)
    out[:total] = flat[:total].cpu()
    return out.view(n, chunk)


class _RecoverRank:
    """One rank of phase 13's host-plane ZeRO-2 world: its peer, pinned
    buffers, parameter and momentum chunks on the card, and (on the
    main path) its boundary, snapshot and persist plane."""

    def __init__(self, torch, peer, r: int, n: int, total: int, flat_params,
                 mom_chunk):
        from kungfu_tpu_torch.optimizers._transform import TraceState

        self.peer, self.r, self.n = peer, r, n
        self.chunk, self.widths = _host_zero_geometry(total, n)
        c = self.chunk
        self.gbuf = torch.zeros(n * c, dtype=torch.float32, pin_memory=True)
        self.red = torch.empty(c, dtype=torch.float32, pin_memory=True)
        self.own = torch.empty(c, dtype=torch.float32, pin_memory=True)
        padded = _repad(torch, flat_params, total, n)
        self.p_own = padded[r].to("cuda")
        self.mom = TraceState(mom_chunk.reshape(-1).to("cuda"))
        self.zb = self.snap = self.plane = self.full = self.times = None


def _recover_body(torch, rk, k: int, inner, total: int, unflat, commit,
                  state):
    """Rank ``rk``'s part of step ``k`` on its own thread: the mean
    reduce-scatter of its pinned gradient, the sgd update of its chunks
    on the card, the all-gather of the params; on the main path the
    commits and ``elastic_step``.  Returns ``(gathered params, times,
    elastic state)``."""
    from kungfu_tpu_torch.elastic.hooks import elastic_step
    from kungfu_tpu_torch.optimizers import apply_updates
    from kungfu_tpu_torch.parallel.zero import (host_bucket_all_gather,
                                                host_bucket_pipeline,
                                                host_bucket_spans)

    eng = rk.peer.engine()
    spans = host_bucket_spans(rk.chunk, rk.widths)

    def keep(b, red):
        off, w = spans[b]
        rk.red[off:off + w].copy_(red)

    t0 = time.perf_counter()
    host_bucket_pipeline(eng, rk.gbuf, rk.widths, keep, op="mean",
                         name=f"g{k}")
    t1 = time.perf_counter()
    u, rk.mom = inner.update(rk.red.to("cuda", non_blocking=True), rk.mom,
                             rk.p_own)
    rk.p_own = apply_updates(rk.p_own, u)
    rk.own.copy_(rk.p_own)  # synchronises
    t2 = time.perf_counter()
    full = host_bucket_all_gather(eng, rk.own, rk.widths, name=f"p{k}")
    t3 = time.perf_counter()
    rk.full = full
    times = {"reduce_scatter_ms": (t1 - t0) * 1e3,
             "update_ms": (t2 - t1) * 1e3,
             "all_gather_ms": (t3 - t2) * 1e3}
    rk.times = times
    if not commit:
        return full, times, state
    flat = full[:total]
    rk.zb.commit_local(k, rk.mom, total=total, old_n=rk.n, my_old=rk.r)
    t4 = time.perf_counter()
    rk.zb.replicate_ring(rk.peer.channel, rk.peer.cluster.workers,
                         tag=f"s{k}")
    t5 = time.perf_counter()
    rk.snap.commit(k, unflat(flat))
    t6 = time.perf_counter()
    rk.plane.commit(k, rk.zb, replicated={"params": flat}
                    if rk.r == 0 else None)
    t7 = time.perf_counter()
    rk.plane.persist_fence()
    t8 = time.perf_counter()
    times.update(boundary_commit_ms=(t4 - t3) * 1e3,
                 buddy_ms=(t5 - t4) * 1e3, snapshot_ms=(t6 - t5) * 1e3,
                 persist_issue_ms=(t7 - t6) * 1e3,
                 persist_fence_ms=(t8 - t7) * 1e3)
    state, _, _ = elastic_step(rk.peer, state, None, unflat(flat),
                               zero_boundary=rk.zb)
    times["elastic_step_ms"] = (time.perf_counter() - t8) * 1e3
    return full, times, state


def _shrink_marks(events, ends) -> dict:
    """Seconds between the shrink marks of the recovery: per old rank,
    the ping sweep and the drain of in-flight handles (``ping-confirm``
    to ``consensus``) and the exclusion consensus (``consensus`` to
    ``propose``); over the ranks, the replay broadcast (first ``replay``
    to last ``zero-recarve``) and the re-carve (last ``zero-recarve`` to
    the last rank's return, ``ends`` on the timeline's clock)."""
    by = {}
    for ev in events:
        if ev["kind"] == "shrink":
            by.setdefault(ev["name"], []).append(
                (ev["ts"], ev["rank"], ev["attrs"]))
    out = {"find_dead_ranks_s": {}, "consensus_s": {}}
    for ts, rank, _ in by.get("ping-confirm", []):
        nxt = [t for t, r, _ in by.get("consensus", []) if r == rank]
        prop = [t for t, r, _ in by.get("propose", []) if r == rank]
        if nxt:
            out["find_dead_ranks_s"][rank] = nxt[0] - ts
            if prop:
                out["consensus_s"][rank] = prop[0] - nxt[0]
    rep = [t for t, _, _ in by.get("replay", [])]
    rec = [t for t, _, _ in by.get("zero-recarve", [])]
    if rep and rec:
        out["replay_broadcast_s"] = max(rec) - min(rep)
        out["recarve_s"] = max(ends) - max(rec)
    out["marks"] = sorted(by)
    return out


def phase_recover(torch, np, kernels, tr):
    """The peer runtime and in-flight failure recovery on gpt_small
    (max_seq 2048, the build of phases 6, 8, 9 and 11): four Peers, one
    thread each, made by ``parse_config_from_env`` from env dicts in
    ``single_machine_env``'s shape on ports found free
    (``start_local_cluster``), under a ConfigServer; rank r takes row r
    of phase 6's batch.  A step: every rank's gradient on the card
    (kernel rows 1-5), copied into its pinned buffer, mean
    reduce-scattered by ``host_bucket_pipeline`` over ``peer.engine()``,
    ``sgd(0.05, momentum=0.9)`` on the rank's chunks on the card, the
    params regathered by ``host_bucket_all_gather``; then
    ``ZeroBoundary.commit_local`` with ring-buddy mirrors,
    ``StepSnapshot.commit``, ``PersistPlane.commit`` (period 0), the
    fence and ``elastic_step``.  Old rank 3 dies at step 2's first
    engine collective; the survivors recover, replay from step 1 and run
    steps 2-3; a whole-job preemption after step 3 ends the run, and two
    fresh peers restore the step-3 manifest and take step 4.  Checks
    (a)-(h) of the module docstring, each fatal."""
    import shutil
    import tempfile
    from dataclasses import replace

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.comm.faults import PeerFailureError
    from kungfu_tpu_torch.elastic import ConfigServer, ZeroBoundary
    from kungfu_tpu_torch.elastic.hooks import ElasticState
    from kungfu_tpu_torch.elastic.persist import (PersistPlane,
                                                  agreed_manifest_path,
                                                  choose_manifest,
                                                  restore_from_manifest)
    from kungfu_tpu_torch.elastic.resize import fetch_cluster
    from kungfu_tpu_torch.monitor import timeline
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.train import per_rank_grads, split_batch
    from kungfu_tpu_torch.parallel.zero import reshard_plan
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.plan import Cluster, HostList
    from kungfu_tpu_torch.utils import envs
    from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                             tree_unflatten)

    t_phase = time.perf_counter()
    smi = nvidia_smi()  # stamped on every number the phase prints
    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    cfg = model.cfg
    leaves, treedef = tree_flatten(params)
    sizes = [t.numel() for t in leaves]
    shapes = [t.shape for t in leaves]
    total = sum(sizes)
    check(total == FLAGSHIP_PARAMS, f"gpt_small has {total} params")
    shards = split_batch(batch, TRAIN_BATCH)
    inner = sgd(RECOVER_LR, momentum=RECOVER_MOMENTUM)
    flat0 = torch.cat([t.reshape(-1) for t in leaves]).cpu()
    del params, leaves

    def unflat(flat):
        parts, off = [], 0
        for m, shape in zip(sizes, shapes):
            parts.append(flat[off:off + m].view(shape))
            off += m
        return tree_unflatten(treedef, parts)

    def flatten(tree):
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    dev = torch.empty((RANKS, total), dtype=torch.float32, device="cuda")
    launches = {key: 0 for key in _counts(kernels)}
    rows, losses, writes = {}, {}, []
    out = {"params": total, "deadline_s": RECOVER_DEADLINE_S}
    saved_env = {k: os.environ.get(k) for k in (
        "KF_CHAOS_SPEC", "KF_CONFIG_PEER_DEADLINE", "KF_PERSIST_PERIOD",
        "KF_PERSIST_KEEP", "KF_PERSIST_RESTORE", "KF_CONFIG_ENABLE_TRACE",
        "KF_TPU_USE_UNIXSOCK")}

    def step(world, k, flat, body, what="main path"):
        """Step ``k`` on ``world`` from the params ``flat``: the ranks'
        gradients on the main thread (launches checked), then
        ``body(rank)`` on a thread a rank; returns the loss, the bodies'
        results (or exceptions) and the step's main-thread times."""
        n = len(world)
        _reset(kernels)
        t0 = time.perf_counter()
        p = unflat(flat.to("cuda"))

        def sink(r, grads):
            off = 0
            for g, m in zip(grads, sizes):
                dev[r, off:off + m].copy_(g.reshape(-1))
                off += m

        outs, _ = per_rank_grads(loss_fn, p, shards[:n], sink)
        loss = sum(float(x) for x in outs) / n  # synchronises
        t1 = time.perf_counter()
        for r, rk in enumerate(world):
            rk.gbuf[:total].copy_(dev[r])
        t2 = time.perf_counter()
        got = _counts(kernels)
        want = {key: 0 for key in got}
        want.update(_rank_launches(cfg, n))
        check(got == want, f"(g) {what} step {k} at {n} ranks launched "
              f"{got}, expected {want}")
        if what == "main path":
            for key, v in got.items():
                launches[key] += v
        check(math.isfinite(loss), f"(h) {what} step {k}: loss {loss}")
        del p
        res = _run_ranks([lambda rk=rk: body(rk) for rk in world],
                         timeout=600, return_exceptions=True)
        return loss, res, {"grads_ms": (t1 - t0) * 1e3,
                           "d2h_ms": (t2 - t1) * 1e3,
                           "ranks_ms": (time.perf_counter() - t2) * 1e3}

    def plain_body(k, states=None):
        commit = states is not None

        def body(rk):
            return _recover_body(torch, rk, k, inner, total, unflat, commit,
                                 states[rk.r] if commit else None)
        return body

    def finish(world, res, k, loss, times, label):
        """Every rank's gathered params bitwise alike; the step's row and
        its persist writes (from the timeline's ckpt marks)."""
        bad = [x for x in res if isinstance(x, BaseException)]
        check(not bad, f"{label} step {k} raised {bad}")
        fulls = [rk.full for rk in world]
        check(all(torch.equal(f, fulls[0]) for f in fulls),
              f"{label} step {k}: the ranks' gathered params differ")
        row = dict(times)
        for key in res[0][1]:
            row[key] = statistics.median(x[1][key] for x in res
                                         if key in x[1])
        row["step_ms"] = sum(v for key, v in row.items()
                             if key.endswith("_ms") and key != "ranks_ms")
        row["loss"] = loss
        rows.setdefault(label, []).append(row)
        return fulls[0][:total].clone()

    def ckpt_writes():
        """(rank, step, s from issue to durable) of the persist marks
        since the last call."""
        issued = {}
        for ev in timeline.snapshot():
            if ev["kind"] != "ckpt":
                continue
            key = (ev["rank"], ev["attrs"].get("step"))
            if ev["name"] == "persist-issue":
                issued[key] = ev["ts"]
            elif ev["name"] == "persist-done" and key in issued:
                writes.append((key[0], key[1], ev["ts"] - issued[key],
                               ev["attrs"].get("nbytes")))
        timeline.reset()

    def fixed_world(n, flat, mom_rows, steps, tag):
        """``steps`` of a fresh ``n``-peer world (no commits) from the
        params ``flat`` and momentum rows ``mom_rows``, as the main path
        runs them: its engines, strategy and rows."""
        ps = start_local_cluster(n, devices=["cuda"])
        try:
            w = [_RecoverRank(torch, p, r, n, total, flat, mom_rows[r])
                 for r, p in enumerate(ps)]
            for k in steps:
                loss, res, times = step(w, k, flat, plain_body(k),
                                        what=f"fixed {tag}")
                flat = finish(w, res, k, loss, times, f"fixed_{n}")
                losses[f"fixed_{n}_{k}"] = loss
            return flat, torch.stack([rk.mom.trace.cpu() for rk in w])
        finally:
            for p in ps:
                p.close()

    hosts = HostList.parse(f"127.0.0.1:{RANKS}")
    server = ConfigServer(port=0, host="127.0.0.1", cluster=Cluster(
        hosts.gen_runner_list(), hosts.gen_peer_list(RANKS))).start()
    root = tempfile.mkdtemp(prefix="kfpersist")
    peers = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        chaos.reset()
        timeline.reset()
        os.environ["KF_TPU_USE_UNIXSOCK"] = "0"
        os.environ["KF_CONFIG_PEER_DEADLINE"] = str(RECOVER_DEADLINE_S)
        os.environ["KF_PERSIST_PERIOD"] = "0"
        os.environ["KF_PERSIST_KEEP"] = str(RECOVER_KEEP)
        os.environ["KF_CONFIG_ENABLE_TRACE"] = "1"
        os.environ.pop("KF_PERSIST_RESTORE", None)
        n4, n3, n2 = RECOVER_RANKS
        c4, w4 = _host_zero_geometry(total, n4)
        # the victim's Nth engine collective: a healthy step runs one
        # reduce-scatter and one all-gather a bucket and elastic_step's
        # step sync
        kill_coll = (2 * len(w4) + 1) * (RECOVER_KILL_STEP - 1) + 1
        spec = (f"die:coll={kill_coll},rank={RECOVER_VICTIM},mode=raise;"
                f"preempt:all,step={RECOVER_PREEMPT_STEP},mode=raise")
        os.environ["KF_CHAOS_SPEC"] = spec
        t0 = time.perf_counter()
        peers = start_local_cluster(
            n4, env={envs.CONFIG_SERVER: server.url}, devices=["cuda"])
        out["start_s"] = time.perf_counter() - t0
        comm = peers[0].communicator()
        check(comm.device.type == "cuda",
              f"a peer's communicator is on {comm.device}")
        print(f"recover: {n4} Peers {[str(p.config.self_id) for p in peers]}"
              f" started in {out['start_s']:.2f} s under ConfigServer "
              f"{server.url}; chaos {spec!r}; peer deadline "
              f"{RECOVER_DEADLINE_S} s; {len(w4)} buckets a rank at 4")
        world = [_RecoverRank(torch, p, r, n4, total, flat0,
                              torch.zeros(c4)) for r, p in enumerate(peers)]
        for rk in world:
            rk.zb, rk.snap = ZeroBoundary(), StepSnapshot()
            rk.plane = PersistPlane(root, rk.r, cluster_version=0)
        out["pinned_bytes_4"] = sum(
            b.numel() * 4 for rk in world for b in (rk.gbuf, rk.red, rk.own))
        states = [ElasticState(step=1) for _ in world]
        flat = flat0
        for k in range(1, RECOVER_KILL_STEP):
            loss, res, times = step(world, k, flat, plain_body(k, states))
            flat = finish(world, res, k, loss, times, str(n4))
            states = [x[2] for x in res]
            losses[k] = loss
            ckpt_writes()
        ctl = chaos.controller_for(RECOVER_VICTIM)
        check(ctl._colls == kill_coll - 1, f"the victim ran {ctl._colls} "
              f"engine collectives in steps 1-{RECOVER_KILL_STEP - 1}, not "
              f"{kill_coll - 1}")
        flat3 = flat
        # the optimizer's own state, not the boundary under test
        mom3 = torch.cat([rk.mom.trace.cpu() for rk in world])

        # the kill: old rank 3 dies at the kill step's first engine
        # collective
        deaths, errs, recov, ends = {}, {}, {}, []

        def kill_body(rk):
            try:
                _recover_body(torch, rk, RECOVER_KILL_STEP, inner, total,
                              unflat, True, states[rk.r])
                return "no failure"
            except chaos.InjectedDeath:
                deaths[rk.r] = time.perf_counter()
                rk.plane.close()
                rk.peer.close()  # its sockets stop answering pings
                return "died"
            except PeerFailureError as err:
                errs[rk.r] = (time.perf_counter(), err)
                shrunk, replay = rk.peer.recover_from_failure(
                    err, snapshot=rk.snap, zero_boundary=rk.zb)
                recov[rk.r] = time.perf_counter()
                ends.append(time.time())  # the timeline's clock
                return shrunk, replay

        loss4_dead, res, _ = step(world, RECOVER_KILL_STEP, flat, kill_body)
        marks = _shrink_marks(timeline.snapshot(), ends)
        timeline.reset()
        survivors = [rk for rk in world if rk.r != RECOVER_VICTIM]
        check(res[RECOVER_VICTIM] == "died" and set(deaths) ==
              {RECOVER_VICTIM}, f"the victim: {res[RECOVER_VICTIM]}")
        # (a) detection: a typed error naming the victim, in time
        detect = {}
        for rk in survivors:
            check(rk.r in errs, f"(a) rank {rk.r} got no PeerFailureError: "
                  f"{res[rk.r]}")
            t_err, err = errs[rk.r]
            detect[rk.r] = t_err - deaths[RECOVER_VICTIM]
            check(err.rank == RECOVER_VICTIM, f"(a) rank {rk.r}'s "
                  f"PeerFailureError names rank {err.rank}: {err}")
            check(detect[rk.r] <= RECOVER_DEADLINE_S + RECOVER_DETECT_SLACK_S,
                  f"(a) rank {rk.r} took {detect[rk.r]:.2f} s to detect")
        # (b) membership: three peers at version 1, one digest, published
        digests = {rk.peer.cluster.digest() for rk in survivors}
        check(all(rk.peer.size() == n3 and rk.peer.cluster_version == 1
                  and not rk.peer.detached for rk in survivors)
              and len(digests) == 1,
              f"(b) membership {[(rk.peer.size(), rk.peer.cluster_version) for rk in survivors]}, {len(digests)} digests")
        published, pub_v = fetch_cluster(server.url)
        check(published.workers == survivors[0].peer.cluster.workers,
              f"(b) the config server holds {published} (version {pub_v})")
        # (c) the agreed replay point: the previous step's params, bitwise
        replay_bytes = len(survivors[0].snap.serialize())
        flat_r = None
        for rk in survivors:
            shrunk, replay = res[rk.r]
            check(shrunk and replay is not None and replay[0] ==
                  RECOVER_KILL_STEP - 1, f"(c) rank {rk.r}: shrunk "
                  f"{shrunk}, replay step {replay and replay[0]}")
            got = flatten(replay[1])
            check(torch.equal(got, flat3), f"(c) rank {rk.r}'s replayed "
                  "params differ from the step before the kill's")
            flat_r = got
        # (d) the re-carve, the dead rank's chunk from its ring buddy
        want3 = _repad(torch, mom3, total, n3)
        for rk in survivors:
            got = rk.zb.chunks()[1][0]
            check(torch.equal(got, want3[rk.r]), f"(d) rank {rk.r}'s "
                  "re-carved momentum chunk differs from the step before "
                  "the kill's state "
                  "repadded into three chunks")
        plan = reshard_plan(total, n4, n3)
        moved = sum(ln for o, r, _, ln in plan
                    if (o if o != RECOVER_VICTIM else o - 1) != r) * 4
        comm3 = Communicator(devices=["cuda:0"] * n3, local_size=n3,
                             version=1)
        t0 = time.perf_counter()
        rows3 = [rk.zb.place(comm3) for rk in survivors]
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        world3 = []
        for rk, st in zip(survivors, rows3):
            nr = _RecoverRank(torch, rk.peer, rk.r, n3, total, flat_r,
                              st.trace)
            nr.zb, nr.snap = rk.zb, rk.snap
            nr.plane = PersistPlane(root, rk.r,
                                    cluster_version=rk.peer.cluster_version)
            rk.plane.close()
            world3.append(nr)
        del world, rows3
        out["pinned_bytes_3"] = sum(
            b.numel() * 4 for rk in world3 for b in (rk.gbuf, rk.red, rk.own))
        recover_s = {rk.r: recov[rk.r] - errs[rk.r][0] for rk in survivors}
        out.update(detect_s=detect, recover_s=recover_s, shrink=marks,
                   replay_bytes=replay_bytes, recarve_bytes=moved,
                   place_s=place_s, kill_coll=kill_coll,
                   replay_step=RECOVER_KILL_STEP - 1)
        print(f"recover: old rank {RECOVER_VICTIM} died at its engine "
              f"collective {kill_coll} (step {RECOVER_KILL_STEP}); kill -> "
              f"PeerFailureError s {detect}; recover_from_failure s "
              f"{recover_s}; ping sweep s {marks['find_dead_ranks_s']}, "
              f"exclusion consensus s {marks['consensus_s']}, replay "
              f"broadcast {marks.get('replay_broadcast_s', float('nan')):.3f}"
              f" s for {replay_bytes} B; re-carve "
              f"{marks.get('recarve_s', float('nan')):.3f} s, {moved} B "
              f"moved; place {place_s:.3f} s; cluster version 1 of {n3} "
              f"peers, published (config version {pub_v}); {smi}")

        # the kill step to the preempt step at three ranks, from the
        # replay point
        states = [replace(states[rk.r], step=RECOVER_KILL_STEP)
                  for rk in world3]
        flat = flat_r
        preempted = {}

        def last_body(rk):
            try:
                return _recover_body(torch, rk, RECOVER_PREEMPT_STEP, inner,
                                     total, unflat, True, states[rk.r])
            except chaos.InjectedDeath:
                preempted[rk.r] = True
                rk.plane.close()
                rk.peer.close()
                return (rk.full, rk.times, None)

        for k in range(RECOVER_KILL_STEP, RECOVER_PREEMPT_STEP + 1):
            body = (last_body if k == RECOVER_PREEMPT_STEP
                    else plain_body(k, states))
            loss, res, times = step(world3, k, flat, body)
            flat = finish(world3, res, k, loss, times, str(n3))
            states = [x[2] for x in res]
            losses[k] = loss
            ckpt_writes()
        check(sorted(preempted) == list(range(n3)),
              f"preempt:all fired on ranks {sorted(preempted)}")
        flat6 = flat
        mom6 = torch.cat([rk.mom.trace.cpu() for rk in world3])
        mdir6 = os.path.join(root, f"step_{RECOVER_PREEMPT_STEP:08d}.v1")
        manifest_bytes = sum(os.path.getsize(os.path.join(mdir6, f))
                             for f in os.listdir(mdir6))
        del world3
        peers = []
        chaos.reset()
        os.environ.pop("KF_CHAOS_SPEC")
        os.environ.pop("KF_CONFIG_ENABLE_TRACE")

        # (e) a fixed three-rank world from (c) + (d), the same steps
        fx6, fx_mom6 = fixed_world(n3, flat3, want3,
                                   range(RECOVER_KILL_STEP,
                                         RECOVER_PREEMPT_STEP + 1), "3")
        _check_bitwise(torch, [flat6, mom6], [fx6, fx_mom6.reshape(-1)],
                       f"recover (e): params and momentum after steps "
                       f"{RECOVER_KILL_STEP}-{RECOVER_PREEMPT_STEP} vs a "
                       f"fixed three-rank world")
        for k in range(RECOVER_KILL_STEP, RECOVER_PREEMPT_STEP + 1):
            check(losses[k] == losses[f"fixed_3_{k}"],
                  f"(e) step {k} loss {losses[k]} != the fixed world's")

        # (f) the cold restore: two fresh peers agree on the newest
        # complete manifest and restore their shares of it
        os.environ["KF_PERSIST_RESTORE"] = "1"
        check(envs.persist_knobs()["restore"], "KF_PERSIST_RESTORE unarmed")
        t0 = time.perf_counter()
        peers = start_local_cluster(n2, devices=["cuda"])

        def restore_body(p):
            r = p.rank()
            plane = PersistPlane(root, r, cluster_version=p.cluster_version)
            s, v = choose_manifest(root) if r == 0 else (-1, -1)
            s, v = plane.agree_manifest(p.channel, p.cluster.workers, r, s, v)
            rs = restore_from_manifest(agreed_manifest_path(root, s, v), r,
                                       n2)
            zb = ZeroBoundary()
            rs.install_into_boundary(zb)
            plane.close()
            return rs, zb

        restored = _run_ranks([lambda p=p: restore_body(p) for p in peers],
                              timeout=300, return_exceptions=True)
        restore_s = time.perf_counter() - t0
        want2 = _repad(torch, mom6, total, n2)
        for r, x in enumerate(restored):
            check(not isinstance(x, BaseException), f"(f) restore: {x}")
            rs, zb = x
            check(rs.step == RECOVER_PREEMPT_STEP and rs.meta["old_n"] == n3,
                  f"(f) rank {r} restored step {rs.step} of "
                  f"{rs.meta['old_n']} ranks")
            check(torch.equal(rs.vec[0], want2[r]) and
                  torch.equal(zb.chunks()[1][0], want2[r]),
                  f"(f) rank {r}'s restored momentum differs from step "
                  f"{RECOVER_PREEMPT_STEP}'s state repadded into two chunks")
            check(torch.equal(rs.replicated["params"], flat6),
                  f"(f) rank {r}'s restored params differ from step "
                  f"{RECOVER_PREEMPT_STEP}'s")
        world2 = [_RecoverRank(torch, p, r, n2, total,
                               restored[r][0].replicated["params"],
                               restored[r][0].vec[0])
                  for r, p in enumerate(peers)]
        k = RECOVER_LAST
        loss, res, times = step(world2, k,
                                restored[0][0].replicated["params"],
                                plain_body(k))
        flat7 = finish(world2, res, k, loss, times, str(n2))
        losses[k] = loss
        mom7 = torch.cat([rk.mom.trace.cpu() for rk in world2])
        del world2
        for p in peers:
            p.close()
        peers = []
        fx7, fx_mom7 = fixed_world(n2, flat6, want2, [k], "2")
        _check_bitwise(torch, [flat7, mom7], [fx7, fx_mom7.reshape(-1)],
                       f"recover (f): params and momentum after step "
                       f"{RECOVER_LAST} from the manifest vs a fixed two-rank "
                       f"world")
        check(losses[k] == losses[f"fixed_2_{k}"],
              f"(f) step {k} loss {losses[k]} != the fixed world's")
    finally:
        for p in peers:
            p.close()
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
        for key, v in saved_env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        chaos.reset()
        timeline.reset()
    # (h) the loss
    main = [losses[k] for k in range(1, RECOVER_LAST + 1)]
    print(f"recover (h): losses of steps 1-{RECOVER_LAST} "
          f"{[round(x, 4) for x in main]}")
    check(main[-1] < main[0], f"(h) the loss did not fall: {main}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {}
    for label, rs_ in rows.items():
        keys = {key for r in rs_ for key in r if key != "loss"}
        med[label] = {key: statistics.median(r[key] for r in rs_ if key in r)
                      for key in keys}
    w_rank0 = [w[2] for w in writes if w[0] == 0]
    w_other = [w[2] for w in writes if w[0] != 0]
    wall = time.perf_counter() - t_phase
    for label in (str(n) for n in RECOVER_RANKS):
        m = med[label]
        print(f"recover step ms at {label} ranks (median of "
              f"{len(rows[label])}): {m['step_ms']:.2f} = grads "
              f"{m['grads_ms']:.2f} + D2H {m['d2h_ms']:.2f} + "
              f"reduce-scatter {m['reduce_scatter_ms']:.2f} + update "
              f"{m['update_ms']:.2f} + all-gather {m['all_gather_ms']:.2f}"
              + "".join(f" + {key[:-3]} {m[key]:.2f}" for key in (
                  "boundary_commit_ms", "buddy_ms", "snapshot_ms",
                  "persist_issue_ms", "persist_fence_ms", "elastic_step_ms")
                  if key in m) + f"; {smi}")
    print(f"recover: persist {manifest_bytes} B in the step-"
          f"{RECOVER_PREEMPT_STEP} manifest; "
          f"writer-thread s per write rank 0 "
          f"{[round(x, 3) for x in w_rank0]}, other ranks median "
          f"{statistics.median(w_other) if w_other else float('nan'):.3f}; "
          f"agree_manifest + restore {restore_s:.3f} s (2 peers started "
          f"with it); pinned {out['pinned_bytes_4']} B at 4 ranks; peak "
          f"device memory {peak:.2f} GiB; phase {wall:.1f} s; {smi}")
    out.update(launches=launches, losses={str(k): v for k, v in
                                          losses.items()},
               step_rows=rows, median=med, persist_writes=writes,
               manifest_bytes=manifest_bytes, restore_s=restore_s,
               peak_gib=peak, wall_s=wall)
    return out


#: the wgmma/TMA kernels: their ptxas report must show no spills and
#: their SASS must hold wgmma (HGMMA) and TMA load (UTMALDG) instructions
def _loss_grads(fn, params, shard):
    """``(loss, gradient tree)`` of ``fn(params, shard)``, one rank's pass."""
    from kungfu_tpu_torch.parallel.train import per_rank_grads
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    grads = []
    outs, _ = per_rank_grads(fn, params, [shard], lambda r, g: grads.extend(g))
    return outs[0], tree_unflatten(tree_flatten(params)[1], grads)


def _tree_rel_l2(got, ref) -> tuple:
    """Worst relative L2 over the leaves of two trees (denominator
    floored at 1e-3 of the largest leaf norm), with its leaf index."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    g, r = tree_leaves(got), tree_leaves(ref)
    norms = [t.float().norm().item() for t in r]
    floor = 1e-3 * max(norms)
    return max(((a.float() - b.float()).norm().item() / max(nb, floor), i)
               for i, (a, b, nb) in enumerate(zip(g, r, norms)))


def _trees_equal(torch, a, b) -> bool:
    from kungfu_tpu_torch.utils.tree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _peer_spread(torch, trees) -> float:
    """The spread across separate trees: the largest standard deviation
    over the trees of any element of any leaf."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    leaves = [tree_leaves(t) for t in trees]
    return max(float(torch.stack(ls).float().std(0).max())
               for ls in zip(*leaves))


def _device_digest(torch, t) -> tuple:
    """A digest of a tensor's bytes, taken on the card in slices: two
    weighted sums of its 16-bit words (int64 arithmetic a slice)."""
    w = t.contiguous().view(torch.int16).reshape(-1)
    a = b = 0
    for off in range(0, w.numel(), 1 << 25):
        x = w[off:off + (1 << 25)].to(torch.int64)
        i = torch.arange(off, off + x.numel(), device=x.device,
                         dtype=torch.int64)
        a += int((x * (i % 65521 + 1)).sum())
        b += int((x * (i * 2654435761 % 2147483647)).sum())
    return a, b


def _set_env(pairs: dict) -> dict:
    """Set (or, for None, unset) env vars; returns the old values."""
    old = {k: os.environ.get(k) for k in pairs}
    for k, v in pairs.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def _time_parts(torch, o, rows) -> dict:
    """Wrap ``o``'s H2D of a pulled model, its average + update and its
    publish with timers (the first two drain the card's queue, so the
    card's time lands in its part); each step's parts in ms are appended
    to ``rows`` at its publish.  Returns the open step's dict, for a
    caller's own parts."""
    t = {}

    def timed(name, fn, drain):
        def run(*a):
            t0 = time.perf_counter()
            res = fn(*a)
            if drain:
                torch.cuda.current_stream().synchronize()
            t[name] = t.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return res

        return run

    o._deserialize_buf = timed("h2d_ms", o._deserialize_buf, True)
    o._step_fn = timed("average_update_ms", o._step_fn, True)
    publish = timed("publish_ms", o._publish_buf, False)

    def publish_and_row(fused):
        publish(fused)
        rows.append(dict(t))
        t.clear()

    o._publish_buf = publish_and_row
    return t


def phase_gossip(torch, np, kernels, tr, bert):
    """Pair-averaging gossip on bert_base() (phase 10's model, batch and
    loss) over four ``Peer``s from ``start_local_cluster(4,
    devices=["cuda"])``, one thread each, on HostChannel's default
    ``auto`` (native) over TCP on loopback; inner ``sgd(1e-3,
    momentum=0.9)``; rank r's params are the shared init perturbed by
    its own generator.  The ranks' forward and backward run on the main
    thread (in (b) under one lock), one after another, as on every
    co-resident phase.  Checks (a)-(b) of the module docstring."""
    from kungfu_tpu_torch.optimizers import (AsyncPairAveragingOptimizer,
                                             PairAveragingOptimizer, sgd)
    from kungfu_tpu_torch.parallel.train import split_batch
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    model, params, batch, loss_fn = bert
    cfg = model.cfg
    shards = split_batch(batch, RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    per_step = {key: 0 for key in _counts(kernels)}
    per_step.update(_rank_launches(cfg))
    launches = {key: 0 for key in per_step}
    total = sum(t.numel() for t in tree_leaves(params))

    def start(r):
        gen = torch.Generator(device="cuda").manual_seed(1000 + r)
        return tree_map(lambda t: t + GOSSIP_PERTURB * torch.randn(
            t.shape, generator=gen, device=t.device, dtype=t.dtype), params)

    starts = [start(r) for r in range(RANKS)]
    out = {"params": total, "fused_bytes_f32": total * 4,
           "fused_bytes_bf16": total * 2, "card": smi}
    old = _set_env({"KF_TPU_USE_UNIXSOCK": "0", "KF_CHAOS_SPEC": None,
                    "KF_NATIVE_ENGINE": None, "KF_TPU_HOST_TRANSPORT": None,
                    "KF_CONFIG_ENABLE_TRACE": None})
    try:
        out["blocking"] = _gossip_blocking(
            torch, np, kernels, start_local_cluster, PairAveragingOptimizer,
            model, starts, shards, loss_fn, inner, per_step, launches)
        torch.cuda.empty_cache()
        out["async"] = _gossip_async(
            torch, np, kernels, start_local_cluster,
            AsyncPairAveragingOptimizer, starts, shards, loss_fn, inner,
            per_step, launches)
    finally:
        _set_env(old)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _gossip_blocking(torch, np, kernels, start_local_cluster, Opt, model,
                     starts, shards, loss_fn, inner, per_step, launches):
    """(a): the blocking optimizer, f32 wire, roundrobin, three steps in
    lockstep: every pulled buffer bitwise the version its target
    published, every peer's params bitwise a single-thread replay of the
    recurrence on the card with no wire, and step 1 held against the
    same step under KF_TPU_ATTN=xla."""
    import types

    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.utils.tree import tree_map

    n = RANKS
    peers = start_local_cluster(n, devices=["cuda"])
    try:
        kinds = {type(p.channel).__name__ for p in peers}
        check(kinds == {"NativeHostChannel"},
              f"(a) gossip peers on {kinds}, expected the native channel")
        opts = [Opt(inner, peer=p, name="model", selector="roundrobin")
                for p in peers]
        times = [[] for _ in range(n)]
        pulled = []

        def instrument(r, o):
            t = _time_parts(torch, o, times[r])
            o_pull = o._pull

            def pull(target):
                t0 = time.perf_counter()
                got = o_pull(target)
                t["pull_ms"] = (time.perf_counter() - t0) * 1e3
                want = peers[target].store.get(o.name,
                                               version=str(o._step_count))
                pulled.append((r, target, o._step_count + 1,
                               got is not None and want is not None
                               and np.array_equal(np.asarray(got), want)))
                # lockstep: every peer has pulled before any publishes
                o.peer.barrier()
                return got

            o._pull = pull

        for r, o in enumerate(opts):
            instrument(r, o)
        params = [tree_map(torch.clone, s) for s in starts]
        states = _run_ranks([lambda r=r: opts[r].init(params[r])
                             for r in range(n)], timeout=300)
        # the replay: the same recurrence on the card, no wire
        replay = types.SimpleNamespace(fuse_dtype=torch.float32, inner=inner)
        rp = [tree_map(torch.clone, s) for s in starts]
        rs = [inner.init(p) for p in rp]
        rf = [fuse(p, dtype=torch.float32)[0] for p in rp]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, grads_ms, rows = [], [], []
        for k in range(1, GOSSIP_BLOCKING_STEPS + 1):
            _reset(kernels)
            t0 = time.perf_counter()
            outs = [_loss_grads(loss_fn, params[r], shards[r])
                    for r in range(n)]
            loss = sum(float(x) for x, _ in outs) / n  # synchronises
            grads_ms.append((time.perf_counter() - t0) * 1e3)
            got = _counts(kernels)
            check(got == per_step, f"(a) gossip step {k} launched {got}, "
                  f"expected {per_step}")
            for key, v in got.items():
                launches[key] += v
            losses.append(loss)
            grads = [g for _, g in outs]
            t1 = time.perf_counter()
            res = _run_ranks([lambda r=r: opts[r].step(params[r], grads[r],
                                                       states[r])
                              for r in range(n)], timeout=600)
            rows.append((time.perf_counter() - t1) * 1e3)
            params, states = [x[0] for x in res], [x[1] for x in res]
            # the replay of step k: rank r averages with its roundrobin
            # target's fused params of step k - 1
            new = []
            for r in range(n):
                others = [j for j in range(n) if j != r]
                tgt = others[(k - 1) % len(others)]
                new.append(Opt._step_fn(replay, rp[r], grads[r], rs[r],
                                        rf[tgt]))
            rp, rs, rf = ([x[0] for x in new], [x[1] for x in new],
                          [x[2] for x in new])
            same = [_trees_equal(torch, params[r], rp[r]) for r in range(n)]
            print(f"gossip (a) step {k}: loss {loss:.6f}; params bitwise "
                  f"equal to the replay {same}")
            check(all(same), f"(a) gossip step {k} params differ from the "
                  f"replay: {same}")
            if k == 1:
                p1, g1 = params, grads
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bad = [p for p in pulled if not p[3]]
        print(f"gossip (a): {len(pulled)} pulls, each bitwise the version "
              f"its target published: {not bad}")
        check(len(pulled) == n * GOSSIP_BLOCKING_STEPS and not bad,
              f"(a) pulled buffers differ from the published ones: {bad}")
        check(all(o.averaged_steps == GOSSIP_BLOCKING_STEPS for o in opts),
              f"(a) averaged steps {[o.averaged_steps for o in opts]}")
        del rp, rs, rf

        # step 1 under KF_TPU_ATTN=xla (not counted): the same average and
        # update from the plain path's gradient
        def loss_xla(p, b):
            logits = model.apply(p, b[0], train=True)
            return xent.softmax_cross_entropy(logits, b[1]).mean()

        saved = _set_env({"KF_TPU_ATTN": "xla"})
        p_rel, g_rel = (0.0, 0), (0.0, 0)
        try:
            for r in range(n):
                _, gx = _loss_grads(loss_xla, starts[r], shards[r])
                tgt = [j for j in range(n) if j != r][0]  # step 1's target
                px = Opt._step_fn(replay, starts[r], gx, inner.init(starts[r]),
                                  fuse(starts[tgt], dtype=torch.float32)[0])[0]
                p_rel = max(p_rel, _tree_rel_l2(p1[r], px))
                g_rel = max(g_rel, _tree_rel_l2(g1[r], gx))
                del gx, px
        finally:
            _set_env(saved)
        print(f"gossip (a) step 1 vs the same step under KF_TPU_ATTN=xla: "
              f"each peer's params worst rel L2 {p_rel[0]:.3e} (leaf "
              f"{p_rel[1]}; tol {TRAIN_GRAD_REL_L2}); each peer's gradient "
              f"worst rel L2 {g_rel[0]:.3e} (leaf {g_rel[1]}, reported: the "
              f"flash backward's q/k gradients at BERT's nearly uniform "
              f"attention, PERF.md section 6)")
        check(p_rel[0] <= TRAIN_GRAD_REL_L2,
              f"(a) step 1 params differ from the xla step's: {p_rel}")
        per = {key: statistics.median([t[key] for r in range(n)
                                       for t in times[r]])
               for key in times[0][0]}
        grads_med = statistics.median(grads_ms)
        step_ms = grads_med + sum(per.values())
        pull_s = sum(o.pull_seconds for o in opts)
        pull_b = sum(o.pull_bytes for o in opts)
        res = {"losses": losses, "grads_ms": grads_ms,
               "threads_wall_ms": rows, "per_peer_median_ms": per,
               "step_ms": step_ms, "pull_gb_s": pull_b / pull_s / 1e9,
               "pull_share_of_step": per["pull_ms"] / step_ms,
               "pinned_landing_bytes": sum(o._recv_buf.nbytes for o in opts),
               # the store's window of three versions a peer
               "pinned_published_bytes": n * 3 * opts[0]._model_nbytes(
                   starts[0]),
               "peak_gib": peak, "params_rel_l2_vs_xla": p_rel[0],
               "grads_rel_l2_vs_xla": g_rel[0]}
        print(f"gossip (a) blocking, f32 wire, {n} peers: step "
              f"{step_ms:.2f} ms = grads of the four ranks in turn "
              f"{grads_med:.2f} ms + per peer (the four threads at once) "
              f"pull {per['pull_ms']:.2f} ms, H2D {per['h2d_ms']:.2f} ms, "
              f"average + update {per['average_update_ms']:.2f} ms, D2H + "
              f"publish {per['publish_ms']:.2f} ms (threads' wall with the "
              f"harness's checks {statistics.median(rows):.2f} ms); pulls "
              f"at {res['pull_gb_s']:.3f} GB/s, "
              f"{res['pull_share_of_step']:.3f} of the step; pinned landing "
              f"buffers {res['pinned_landing_bytes']} B; peak {peak:.2f} GiB")
        return res
    finally:
        for p in peers:
            p.close()


def _gossip_async(torch, np, kernels, start_local_cluster, Opt, starts,
                  shards, loss_fn, inner, per_step, launches):
    """(b): the async optimizer, bf16 wire, random targets, staleness
    bound 4, ten free-running steps a peer: every taken buffer bitwise
    one version a peer other than the taker published, at least nine
    averaged steps a peer, no landing reused more than the bound in a
    row, every puller joined within its bound, a cross-peer spread below
    ten local steps', a falling loss and exact launches.  The digests are
    taken on the card (the fused output before its publish, the copy of
    a taken landing after its H2D) and left out of the step times."""
    import threading

    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.optimizers import apply_updates
    from kungfu_tpu_torch.utils.tree import tree_map

    n = RANKS
    peers = start_local_cluster(n, devices=["cuda"])
    opts = []
    try:
        opts = [Opt(inner, peer=p, name="model-bf16", selector="random",
                    fuse_dtype=torch.bfloat16,
                    max_staleness=GOSSIP_STALENESS) for p in peers]
        published = [set() for _ in range(n)]
        taken = [[] for _ in range(n)]
        parts = [[] for _ in range(n)]
        digest_s = [0.0] * n

        def note(r, t):
            t0 = time.perf_counter()
            d = _device_digest(torch, t)
            digest_s[r] += time.perf_counter() - t0
            return d

        for r, o in enumerate(opts):
            _time_parts(torch, o, parts[r])  # timers inside the digests
            o_pub, o_pub_buf, o_h2d = (o._publish, o._publish_buf,
                                       o._deserialize_buf)

            def publish(params, r=r, orig=o_pub):  # the init's version
                published[r].add(note(r, fuse(params,
                                              dtype=torch.bfloat16)[0]))
                orig(params)

            def publish_buf(fused, r=r, orig=o_pub_buf):
                published[r].add(note(r, fused))  # before it can be served
                orig(fused)

            def h2d(blob, device, r=r, orig=o_h2d):
                other = orig(blob, device)
                taken[r].append(note(r, other))
                return other

            o._publish, o._publish_buf = publish, publish_buf
            o._deserialize_buf = h2d
        params = [tree_map(torch.clone, s) for s in starts]
        states = _run_ranks([lambda r=r: opts[r].init(params[r])
                             for r in range(n)], timeout=300)
        lock = threading.Lock()
        losses = [[] for _ in range(n)]
        reuse = [[] for _ in range(n)]
        step_ms = [[] for _ in range(n)]
        grads_ms = [[] for _ in range(n)]

        def run(r):
            p, s = params[r], states[r]
            for _ in range(GOSSIP_ASYNC_STEPS):
                t0 = time.perf_counter()
                with lock:  # the ranks' passes run in turn on the card
                    t1 = time.perf_counter()
                    loss, g = _loss_grads(loss_fn, p, shards[r])
                    losses[r].append(float(loss))  # synchronises
                    t2 = time.perf_counter()
                h0 = digest_s[r]
                p, s = opts[r].step(p, g, s)
                torch.cuda.current_stream().synchronize()
                t3 = time.perf_counter()
                grads_ms[r].append((t2 - t1) * 1e3)
                # the step's wall, less the harness's digests
                step_ms[r].append((t3 - t0 - (digest_s[r] - h0)) * 1e3)
                reuse[r].append(opts[r]._consumed_same)
            return p

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        t0 = time.perf_counter()
        final = _run_ranks([lambda r=r: run(r) for r in range(n)],
                           timeout=900)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = _counts(kernels)
        want = {k: v * GOSSIP_ASYNC_STEPS for k, v in per_step.items()}
        check(got == want, f"(b) async gossip launched {got}, expected "
              f"{want}")
        for key, v in got.items():
            launches[key] += v
        averaged = [o.averaged_steps for o in opts]
        bad = [(r, i) for r in range(n) for i, d in enumerate(taken[r])
               if not any(d in published[j] for j in range(n) if j != r)]
        print(f"gossip (b): {sum(map(len, taken))} pulled models averaged "
              f"with, each "
              f"bitwise one version another peer published: {not bad}; "
              f"averaged steps {averaged}; landing reuse per step {reuse}")
        check(not bad and all(taken), f"(b) taken buffers match no "
              f"published version: {bad}")
        check(all(a >= GOSSIP_MIN_AVERAGED for a in averaged),
              f"(b) averaged steps {averaged} < {GOSSIP_MIN_AVERAGED}")
        check(max(max(x) for x in reuse) <= GOSSIP_STALENESS,
              f"(b) a landing was reused past the bound: {reuse}")
        pull_s = sum(o.pull_seconds for o in opts)
        pull_b = sum(o.pull_bytes for o in opts)
        landings = [o._puller.seq for o in opts]
        slots = sum(sum(b.nbytes for b in o._puller._slots) for o in opts)
        joins = []
        for o in opts:
            puller, bound = o._puller, 3.0 * o._pull_timeout + 5.0
            t1 = time.perf_counter()
            o.close()
            joins.append(time.perf_counter() - t1)
            check(not puller.is_alive() and joins[-1] <= bound,
                  f"(b) a puller did not join within {bound} s "
                  f"({joins[-1]:.2f} s)")
        mean_loss = [sum(losses[r][k] for r in range(n)) / n
                     for k in range(GOSSIP_ASYNC_STEPS)]
        check(all(math.isfinite(x) for x in mean_loss)
              and mean_loss[-1] < mean_loss[0],
              f"(b) mean loss did not fall: {mean_loss}")
        spread = _peer_spread(torch, final)
        del final, params, states

        # the same ten steps with gossip off (not counted)
        local = []
        for r in range(n):
            p, s = tree_map(torch.clone, starts[r]), inner.init(starts[r])
            for _ in range(GOSSIP_ASYNC_STEPS):
                _, g = _loss_grads(loss_fn, p, shards[r])
                u, s = inner.update(g, s, p)
                p = apply_updates(p, u)
            local.append(p)
            del s
        spread_local = _peer_spread(torch, local)
        del local
        print(f"gossip (b) cross-peer spread after {GOSSIP_ASYNC_STEPS} "
              f"steps: {spread:.4e} with gossip, {spread_local:.4e} with "
              f"local steps only; mean loss {[round(x, 4) for x in mean_loss]}")
        check(spread < spread_local, "(b) gossip did not bring the peers "
              "closer than local steps")
        per = {key: statistics.median([row.get(key, 0.0) for r in range(n)
                                       for row in parts[r]])
               for key in ("h2d_ms", "average_update_ms", "publish_ms")}
        res = {"mean_losses": mean_loss, "averaged_steps": averaged,
               "per_peer_median_ms": per,
               "landings": landings, "reuse": reuse,
               "step_ms": statistics.median(sum(step_ms, [])),
               "grads_ms": statistics.median(sum(grads_ms, [])),
               "wall_s": wall, "pull_gb_s": pull_b / pull_s / 1e9,
               "pull_bytes": pull_b, "close_s": joins,
               "spread": spread, "spread_local": spread_local,
               "pinned_slot_bytes": slots,
               "pinned_published_bytes": n * 3 * opts[0]._model_nbytes(
                   starts[0]),
               "peak_gib": peak}
        print(f"gossip (b) async, bf16 wire, {n} peers free-running: step "
              f"{res['step_ms']:.2f} ms a peer (its own grads "
              f"{res['grads_ms']:.2f} ms, under the lock the four peers "
              f"share; H2D {per['h2d_ms']:.2f} ms, average + update "
              f"{per['average_update_ms']:.2f} ms, D2H + publish "
              f"{per['publish_ms']:.2f} ms; the rest waits for the lock or "
              f"a landing), {GOSSIP_ASYNC_STEPS} steps in {wall:.2f} s; "
              f"{landings} landings at {res['pull_gb_s']:.3f} GB/s per pull; "
              f"close joins {[round(x, 3) for x in joins]} s; pinned slots "
              f"{slots} B; peak {peak:.2f} GiB")
        return res
    finally:
        for o in opts:
            o.close()
        for p in peers:
            p.close()


def phase_adapt(torch, np, kernels, tr, bert):
    """The online adaptation plane: (a) the device bandit over the four
    allreduce schedules on bert_base()'s S-SGD steps over four
    co-resident ranks; (b) the host bandit under injected interference
    (bench.py:1285 payload_adapt's scenario) on three port peers; (c)
    ``AdaptiveStrategyDriver`` and ``monitored_all_reduce`` on the same
    peers.  Checks of the module docstring."""
    t_phase = time.perf_counter()
    out = {"card": nvidia_smi()}
    old = _set_env({"KF_CONFIG_ENABLE_TRACE": "1", "KF_TPU_USE_UNIXSOCK": "0",
                    "KF_CHAOS_SPEC": None, "KF_NATIVE_ENGINE": None,
                    "KF_TPU_HOST_TRANSPORT": None})
    try:
        out["device"] = _adapt_device(torch, np, kernels, bert)
        torch.cuda.empty_cache()
        out.update(_adapt_host(np))
    finally:
        _set_env(old)
    out["launches"] = out["device"].pop("launches")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _adapt_device(torch, np, kernels, bert):
    """(a): S-SGD on four co-resident ranks of the card, the fused
    gradient and the loss mean-allreduced through ``comm.all_reduce``,
    ``DeviceBanditDriver(comm, check_every=2, min_pulls=1)`` over every
    schedule."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.monitor import timeline
    from kungfu_tpu_torch.monitor.adapt_device import DeviceBanditDriver
    from kungfu_tpu_torch.ops.schedules import (ALLREDUCE_SCHEDULES,
                                                SIZE_BUCKETS, size_bucket)
    from kungfu_tpu_torch.optimizers import apply_updates, sgd
    from kungfu_tpu_torch.parallel.train import per_rank_grads, split_batch
    from kungfu_tpu_torch.policy import ArmStats
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    model, params, batch, loss_fn = bert
    cfg = model.cfg
    shards = split_batch(batch, RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    leaves, treedef = tree_flatten(params)
    sizes, shapes = [t.numel() for t in leaves], [t.shape for t in leaves]
    total = sum(sizes)
    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    timeline.reset()
    drv = DeviceBanditDriver(comm, check_every=ADAPT_CHECK_EVERY, min_pulls=1)
    check(drv.table.arms == ALLREDUCE_SCHEDULES,
          f"(a) arms {drv.table.arms}")
    # CUDA events around each allreduce's launches, inside the latency
    # hook's window (the window drains the card's queue on both sides)
    events, records = [], []
    axis_reduce = comm._axis_reduce

    def timed_axis_reduce(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = axis_reduce(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return res

    def hook(nbytes, sched, seconds):
        e0, e1 = events[-1]
        events.clear()
        records.append((nbytes, sched, seconds, e0.elapsed_time(e1) / 1e3))
        drv._on_collective(nbytes, sched, seconds)

    comm._axis_reduce = timed_axis_reduce
    comm.set_latency_hook(hook)
    dev = torch.empty((RANKS, total), dtype=torch.float32, device="cuda")

    def sink(r, grads):
        off = 0
        for g, m in zip(grads, sizes):
            dev[r, off:off + m].copy_(g.reshape(-1))
            off += m

    def unflat(flat):
        parts, off = [], 0
        for m, shape in zip(sizes, shapes):
            parts.append(flat[off:off + m].view(shape))
            off += m
        return tree_unflatten(treedef, parts)

    per_step = {key: 0 for key in _counts(kernels)}
    per_step.update(_rank_launches(cfg))
    p, o = params, inner.init(params)
    losses, step_ms, installs = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    for k in range(1, ADAPT_STEPS + 1):
        t0 = time.perf_counter()
        outs, _ = per_rank_grads(loss_fn, p, shards, sink)
        loss = comm.all_reduce(torch.stack([x.float() for x in outs])[:, None],
                               op="mean")
        red = comm.all_reduce(dev, op="mean")
        u, o = inner.update(unflat(red[0]), o, p)
        p = apply_updates(p, u)
        del red
        losses.append(float(loss[0, 0]))
        swapped = drv.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        installs.append([comm.strategy_for_bucket(b)
                         for b in range(len(SIZE_BUCKETS))])
        print(f"adapt (a) step {k}: loss {losses[-1]:.6f}, installed "
              f"{dict(zip(SIZE_BUCKETS, installs[-1]))}, swapped {swapped}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    comm.set_latency_hook(None)
    comm._axis_reduce = axis_reduce
    got = _counts(kernels)
    ring = sum(1 for _, s, _, _ in records if s == "pallas_ring")
    want = {key: v * ADAPT_STEPS for key, v in per_step.items()}
    want.update(ring_rs=ring, ring_ag=ring)
    print(f"adapt (a) launches {got}, expected {want} ({ring} allreduces "
          f"under pallas_ring, one ring reduce-scatter and all-gather each)")
    check(ring > 0 and got == want, f"(a) launches {got}, expected {want}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"(a) loss did not fall: {losses}")
    check(len(records) == 2 * ADAPT_STEPS,
          f"(a) the hook saw {len(records)} allreduces")
    short = [(n, s, t, e) for n, s, t, e in records
             if t + HOOK_EVENT_RESOLUTION_S < e]
    check(not short, f"(a) hook latencies below the CUDA-event time of the "
          f"same collective: {short}")
    # the bucket table against a select recomputed from the summary
    summary = drv.summary()
    for b, row in summary.items():
        t = ArmStats(drv.table.arms, min_pulls=1)
        for arm, st in row["arms"].items():
            if st["count"]:
                t.observe(arm, st["mean_s"], count=st["count"])
        check(t.select() == row["active"] == comm.strategy_for_bucket(b),
              f"(a) bucket {SIZE_BUCKETS[b]}: installed "
              f"{comm.strategy_for_bucket(b)}, summary {row['active']}, "
              f"recomputed {t.select()}")
    large = summary[1]["arms"]
    check(all(v["count"] > 0 for v in large.values()),
          f"(a) an arm of the large bucket was never measured: {large}")
    # one swap event per bucket per swap, with the reference's fields
    swaps = [e for e in timeline.snapshot() if e["kind"] == "swap"]
    keys = [(e["attrs"]["seq"], e["attrs"]["bucket"]) for e in swaps]
    check(len(swaps) == drv.swaps > 0 and len(set(keys)) == len(keys)
          and all(e["attrs"]["plane"] == "device"
                  and {"plane", "bucket", "seq", "prev", "step"}
                  <= set(e["attrs"]) for e in swaps),
          f"(a) swap events {swaps} for {drv.swaps} swaps")
    # every arm's reduced gradient against psum's (the last step's)
    comm.set_bucket_strategy(0, None)
    red = {}
    ring_counts = {}
    for arm in ALLREDUCE_SCHEDULES:
        comm.set_bucket_strategy(1, arm)
        _reset(kernels)
        red[arm] = comm.all_reduce(dev, op="mean")[0].clone()
        torch.cuda.synchronize()
        ring_counts[arm] = (kernels[3].launch_counts["ring_rs"],
                            kernels[3].launch_counts["ring_ag"])
    rel = {arm: float(torch.linalg.vector_norm(red[arm] - red["psum"])
                      / torch.linalg.vector_norm(red["psum"]))
           for arm in ALLREDUCE_SCHEDULES}
    del red
    print(f"adapt (a) each arm's reduced gradient vs psum's, rel L2: {rel} "
          f"(tol {ADAPT_ARM_REL_L2}); ring launches {ring_counts}")
    check(all(v <= ADAPT_ARM_REL_L2 for v in rel.values()),
          f"(a) an arm differs from psum: {rel}")
    check(ring_counts["pallas_ring"] == (1, 1)
          and all(ring_counts[a] == (0, 0) for a in ALLREDUCE_SCHEDULES
                  if a != "pallas_ring"), f"(a) ring launches {ring_counts}")
    lat = {}
    for nbytes, sched, t, e in records:
        b = SIZE_BUCKETS[size_bucket(nbytes)]
        lat.setdefault(b, {}).setdefault(sched, []).append((t, e))
    mean_ms = {b: {s: {"hook_ms": 1e3 * sum(t for t, _ in v) / len(v),
                       "event_ms": 1e3 * sum(e for _, e in v) / len(v),
                       "n": len(v)}
                   for s, v in d.items()} for b, d in lat.items()}
    winners = {SIZE_BUCKETS[b]: row["active"] for b, row in summary.items()}
    print(f"adapt (a) mean latency per bucket and arm (hook, CUDA events): "
          f"{json.dumps(mean_ms)}; winners {winners}; {drv.swaps} swaps; "
          f"step {statistics.median(step_ms):.2f} ms median; peak "
          f"{peak:.2f} GiB")
    return {"losses": losses, "step_ms": step_ms, "installs": installs,
            "latency": mean_ms, "winners": winners, "swaps": drv.swaps,
            "rel_l2_vs_psum": rel, "summary": {SIZE_BUCKETS[b]: v for b, v in
                                              summary.items()},
            "peak_gib": peak, "launches": got}


def _adapt_host(np):
    """(b) and (c) on three port peers with 30 ms on the 0<->1 link for
    send and ping; the engines on the Python path (the chaos hooks ride
    it), as bench.py's."""
    import threading
    from collections import Counter

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.monitor import adapt, adaptive, timeline
    from kungfu_tpu_torch.monitor.adapt_device import MST_ARM, HostBanditDriver
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.plan.graph import Graph
    from kungfu_tpu_torch.plan.mst import minimum_spanning_tree

    os.environ["KF_NATIVE_ENGINE"] = "0"
    os.environ["KF_CHAOS_SPEC"] = ";".join(
        f"delay:ms={HOST_ADAPT_WIRE_MS},rank={a},peer={b},on={on}"
        for a, b in ((0, 1), (1, 0)) for on in ("send", "ping"))
    chaos.reset()
    data = np.ones(HOST_ADAPT_ELEMS, np.float32)

    def measure(p, driver=None):
        t0 = time.perf_counter()
        got = p.engine().all_reduce(data, op="sum")
        dt = time.perf_counter() - t0
        check(bool(np.all(got == 3.0)), f"(b) allreduce gave {got[:4]}")
        return dt, driver.step(dt) if driver is not None else False

    def peers_on(strategy):
        return start_local_cluster(
            3, env={"KF_ALLREDUCE_STRATEGY": strategy}, devices=["cuda"])

    out = {}
    try:
        fixed = {}
        for s in HOST_ADAPT_FIXED_ARMS:
            ps = peers_on(s)
            try:
                times = []
                for _ in range(HOST_ADAPT_FIXED_STEPS):
                    dts = _run_ranks([lambda p=p: measure(p)[0] for p in ps],
                                     timeout=120)
                    times.append(max(dts))
                fixed[s] = statistics.median(times[2:])
            finally:
                for p in ps:
                    p.close()
        timeline.reset()
        ps = peers_on(HOST_ADAPT_FIXED_ARMS[0])
        mats, trees = {}, []
        lock = threading.Lock()
        latency_matrix = adapt.latency_matrix

        def recording_matrix(peer, samples=1):
            m = latency_matrix(peer, samples)
            with lock:
                mats.setdefault(peer.rank(), []).append(m)
            return m

        adapt.latency_matrix = recording_matrix
        for p in ps:
            def set_tree(forest, p=p, orig=p.set_tree):
                orig(forest)
                with lock:  # the matrix this rank's MST was taken from
                    trees.append((p.rank(), len(mats[p.rank()]) - 1,
                                  list(forest),
                                  p.engine()._graphs[0][1].digest_bytes()))

            p.set_tree = set_tree
        try:
            drivers = [HostBanditDriver(p, check_every=2, min_pulls=1,
                                        min_swap_collectives=1) for p in ps]
            times, swap_steps, actives = [], [], []
            for i in range(HOST_ADAPT_STEPS):
                res = _run_ranks([lambda p=p, d=d: measure(p, d)
                                  for p, d in zip(ps, drivers)], timeout=120)
                flags = {s for _, s in res}
                check(len(flags) == 1, f"(b) non-lockstep swap at step {i}")
                times.append(max(dt for dt, _ in res))
                actives.append(drivers[0].active)
                if flags.pop():
                    swap_steps.append(i)
            check(len({d.active for d in drivers}) == 1,
                  f"(b) ranks ended on {[d.active for d in drivers]}")
            evs = [e for e in timeline.snapshot() if e["kind"] == "swap"]
            by_seq = Counter((e["attrs"]["seq"], e["name"]) for e in evs)
            seqs = Counter(e["attrs"]["seq"] for e in evs)
            check(evs and all(v == 3 for v in by_seq.values())
                  and all(v == 3 for v in seqs.values()),
                  f"(b) swap events per seq {dict(by_seq)}")
            check(trees, "(b) the bandit never installed the MST arm")
            for r, k, forest, digest in trees:
                m = mats[r][k]
                check(all(np.array_equal(m, mats[j][k]) for j in mats),
                      "(b) the ranks' latency matrices differ")
                check(forest == minimum_spanning_tree(m)
                      and digest == Graph.from_forest_array(
                          forest).digest_bytes(),
                      f"(b) rank {r} installed {forest}, the MST of its "
                      f"matrix is {minimum_spanning_tree(m)}")
                check(forest[1] != 0 and forest[0] != 1,
                      f"(b) the MST {forest} keeps the 0-1 edge")
            steady = statistics.median(times[-8:])
            best = min(fixed.values())
            print(f"adapt (b) host bandit: swaps at steps {swap_steps}, arms "
                  f"per step {actives}; swap events per seq "
                  f"{ {f'seq{s}:{a}': c for (s, a), c in sorted(by_seq.items())} }; "
                  f"MST installs {[(r, f) for r, _, f, _ in trees]} of the "
                  f"matrix {mats[0][-1].round(5).tolist()}; steady step "
                  f"{steady * 1e3:.2f} ms against the best fixed strategy "
                  f"{min(fixed, key=fixed.get)} "
                  f"{best * 1e3:.2f} ms (fixed {[(k, round(v * 1e3, 2)) for k, v in fixed.items()]})"
                  f"; a host timing, recorded only")
            out["host_bandit"] = {
                "fixed_ms": {k: v * 1e3 for k, v in fixed.items()},
                "steady_ms": steady * 1e3, "step_ms": [t * 1e3 for t in times],
                "swap_steps": swap_steps, "final_arm": drivers[0].active,
                "mst_installs": [f for _, _, f, _ in trees],
                "latency_matrix": mats[0][-1].tolist(),
                "mst_installed": drivers[0].active == MST_ARM}

            # (c) the interference driver on the same peers
            votes = {}
            vote = adaptive.majority_vote_interference

            def recording_vote(peer, suspected):
                agreed = vote(peer, suspected)
                with lock:
                    votes.setdefault(peer.rank(), []).append(agreed)
                return agreed

            adaptive.majority_vote_interference = recording_vote
            try:
                ds = [adaptive.AdaptiveStrategyDriver(p, check_every=2)
                      for p in ps]
                swaps = []
                for i in range(DRIVER_STEPS):
                    res = _run_ranks([lambda p=p, d=d: (
                        adaptive.monitored_all_reduce(p.engine(), data, d),
                        d.swaps) for p, d in zip(ps, ds)], timeout=120)
                    for got, _ in res:
                        check(bool(np.all(got == 3.0)),
                              f"(c) allreduce gave {got[:4]}")
                    swaps.append({s for _, s in res})
                    check(len(swaps[-1]) == 1, f"(c) non-lockstep swap at "
                          f"step {i}: {swaps[-1]}")
            finally:
                adaptive.majority_vote_interference = vote
            check(len(votes) == 3 and all(votes[r] == votes[0]
                                          for r in votes)
                  and len(votes[0]) == DRIVER_STEPS // 2,
                  f"(c) interference votes differ: {votes}")
            print(f"adapt (c) AdaptiveStrategyDriver: votes {votes[0]} on "
                  f"every rank, swaps {[s.pop() for s in swaps]}, strategy "
                  f"{ps[0].engine().strategy}")
            out["interference_driver"] = {"votes": votes[0],
                                          "swaps": ds[0].swaps}
        finally:
            adapt.latency_matrix = latency_matrix
            for p in ps:
                p.close()
    finally:
        chaos.reset()
    return out


#: phase 16: the reference's serving deployment (bench.py:1869
#: payload_serve) at the flagship's width and depth — six workers over
#: three emulated two-rank slices and one router, the reference's router
#: settings, chat traffic with a shared 64-token system prompt
SERVE_WORKERS = 6
SERVE_SLICES = 3
SERVE_SYSTEM_TOKENS = 64
SERVE_USER_TOKENS = 8
SERVE_NEW_TOKENS = 24
SERVE_MAX_BATCH = 4
SERVE_MAX_SEQ = 512
SERVE_PAGE_TOKENS = 16
SERVE_PAGES = 256
SERVE_COMMIT_EVERY = 4
SERVE_QUEUE_DEPTH = 512
SERVE_DEADLINE_S = 2.0
SERVE_STRIKES = 2
#: the reference's gate: p99 e2e after both kills over p99 before them
SERVE_RECOVERY_RATIO = 2.0
#: requests that must finish before the first kill, and be submitted
#: after the second recovery, for the p99s to mean something
SERVE_MIN_PRE = 30
SERVE_MIN_AFTER = 30
#: the saturating burst two workers take to measure their capacity
SERVE_CAPACITY_REQUESTS = 32
#: requests two workers take at the offered rate before the kills: the
#: p99 of the after phase's regime (two live workers), reported beside
#: the reference's ratio to the pre-kill p99 of six workers
SERVE_BASELINE_REQUESTS = 60
#: seconds of load at the offered rate that measure each worker's
#: decode cadence, from which the kills' steps are chosen
SERVE_CALIBRATE_S = 3.0
#: rank 1 dies at the tenth decode iteration after the pair that hands it
#: a request in the timed load (two commits of four tokens made by then)
SERVE_KILL1_ITERATIONS = 10
#: seconds of decoding at the busiest worker's measured cadence after
#: which rank 2, the dispatch's first choice once slice 0 is out, dies
SERVE_KILL_GAP_S = 5.0
#: requests submitted after the second recovery (the check asks for 30)
SERVE_AFTER_TARGET = 60
#: the whole timed load's ceiling: a kill that never fires fails here
SERVE_LOAD_LIMIT_S = 120.0
#: threads submitting the timed load's arrivals
SERVE_SUBMITTERS = 8
#: (b) the burst on the one live worker, the reporters' push period
SERVE_BURST = 16
SERVE_PUSH_PERIOD_S = 0.2
#: (c) the prompt answered before the cold restart (four whole pages)
SERVE_WARM_PROMPT = 70


def _step_meter(eng) -> dict:
    """Count and time ``eng.step`` calls: a serve worker's decode
    iteration counter (the chaos ``die`` clock) equals the count, since
    the worker calls ``step`` once an iteration."""
    st = {"n": 0, "busy_s": 0.0}
    inner = eng.step

    def step():
        t0 = time.perf_counter()
        out = inner()
        st["busy_s"] += time.perf_counter() - t0
        st["n"] += 1
        return out

    eng.step = step
    return st


def _serve_engine(model, params, rank):
    from kungfu_tpu_torch.serve.engine import InferenceEngine
    from kungfu_tpu_torch.serve.kvcache import KVCachePool, PageSpec

    pool = KVCachePool(PageSpec.for_model(model.cfg,
                                          page_tokens=SERVE_PAGE_TOKENS),
                       SERVE_PAGES)
    eng = InferenceEngine(model, params, pool=pool,
                          max_batch=SERVE_MAX_BATCH, max_seq=SERVE_MAX_SEQ,
                          rank=rank)
    eng.warmup(prompt_lens=(SERVE_SYSTEM_TOKENS + SERVE_USER_TOKENS
                            + SERVE_NEW_TOKENS,))
    return eng


def _teacher_forced(torch, model, params, pairs) -> tuple:
    """Every ``(prompt, tokens)`` through ``model.apply`` (the flash
    kernel) on the full context: the largest top-1 margin over a served
    token, per pair whether every token is the top-1, and the flash
    forward launches this check made."""
    from kungfu_tpu_torch.ops.cuda import attention

    launches0 = attention.launch_counts["flash_fwd"]
    dev = params["embed"]["table"].device
    worst = 0.0
    by_len: dict = {}
    for i, (p, toks) in enumerate(pairs):
        by_len.setdefault((len(p), len(toks)), []).append(i)
    exact = [False] * len(pairs)
    for (lp, _), idx in by_len.items():
        for lo in range(0, len(idx), 32):
            part = idx[lo:lo + 32]
            ids = torch.tensor([pairs[i][0] + pairs[i][1][:-1] for i in part],
                               device=dev)
            with torch.no_grad():
                logits = model.apply(params, ids)[:, lp - 1:].float()
            got = torch.tensor([pairs[i][1] for i in part], device=dev)
            top = logits.argmax(dim=-1)
            gap = (logits.gather(2, top[..., None])
                   - logits.gather(2, got[..., None]))[..., 0]
            worst = max(worst, gap.max().item())
            for j, i in enumerate(part):
                exact[i] = bool((top[j] == got[j]).all())
    return worst, exact, attention.launch_counts["flash_fwd"] - launches0


def _pct(np, xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def phase_serve_plane(torch, np, attention, tr):
    """The serving plane on the flagship (bench.py:1869 payload_serve's
    deployment at full width and depth): (a) six ``ServeWorker``s and a
    ``ServeRouter`` through a worker kill and a slice kill at half the
    survivors' capacity; (b) ``ServeFleet`` autoscaling from the live
    aggregator's ``/cluster`` view; (c) a warm KV cache across a cold
    restart through the persist plane.  Checks of the module docstring."""
    from kungfu_tpu_torch import chaos

    t_phase = time.perf_counter()
    out = {"card": nvidia_smi()}
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    model = tr.Transformer(tr.TransformerConfig(**FLAGSHIP))
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    old = _set_env({"KF_TPU_HOST_TRANSPORT": "python",
                    "KF_NATIVE_ENGINE": "0", "KF_TPU_USE_UNIXSOCK": "0",
                    "KF_CHAOS_SPEC": None,
                    "KF_CONFIG_ENABLE_CLUSTER_MONITOR": None,
                    "KF_CONFIG_MONITOR_PUSH_PERIOD": None})
    chaos.reset()
    try:
        # no inference_mode here: the engines' slabs are written in place
        # by the worker threads, which do not inherit a thread-local mode
        out["slo"] = _serve_slo(torch, np, model, params)
        torch.cuda.empty_cache()
        out["autoscale"] = _serve_autoscale(torch, np, model, params)
        torch.cuda.empty_cache()
    finally:
        _set_env(old)
        chaos.reset()
    # the served traffic of (a)-(c) launches no kernel: the engines'
    # attention is the plain softmax, as the reference's.  Only the
    # teacher-forced checks run the flash forward
    checked = (out["slo"]["teacher_forced_launches"]
               + out["autoscale"]["warm"]["teacher_forced_launches"])
    served = attention.launch_counts["flash_fwd"] - checked
    out["launches"] = {"served": served, "teacher_forced": checked}
    check(out["slo"]["served_launches"] == 0 and served == 0,
          f"the served traffic launched flash_fwd {served} times")
    check(checked > 0, "phase 16's teacher-forced check never launched "
          "flash_fwd")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve plane: flash_fwd launches: served traffic {served} (the "
          f"engines' attention is the plain softmax), teacher-forced "
          f"checks {checked}; peak {out['peak_gib']:.2f} GiB, phase "
          f"{out['phase_s']:.2f} s ({out['card']})")
    del model, params
    return out


def _serve_slo(torch, np, model, params) -> dict:
    """(a) The SLO through two kills: seven peers, six workers on the
    card (one engine each, one params tree), the router with
    ``SliceTopology(3, 2)``; the offered rate is half of what two workers
    sustain; rank 1 dies at its decode iteration S1 and slice 1 (ranks 2
    and 3) at S2."""
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.slices import SliceTopology
    from kungfu_tpu_torch.monitor.registry import REGISTRY
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.serve.router import ServeRouter, ServeWorker

    import threading
    from concurrent.futures import ThreadPoolExecutor

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(16)
    system = rng.integers(0, vocab, size=SERVE_SYSTEM_TOKENS).tolist()

    def prompt(extra=0):
        return system + rng.integers(
            0, vocab, size=SERVE_USER_TOKENS + extra).tolist()

    out = {}
    t0 = time.perf_counter()
    peers = start_local_cluster(SERVE_WORKERS + 1, devices=["cuda"])
    engines, meters, servers, routers = [], [], [], []
    try:
        for r in range(SERVE_WORKERS):
            eng = _serve_engine(model, params, r)
            engines.append(eng)
            meters.append(_step_meter(eng))
            servers.append(ServeWorker(peers[r], eng,
                                       commit_every=SERVE_COMMIT_EVERY,
                                       step_period_s=0.0).start())
        slab = engines[0]._k.numel() * engines[0]._k.element_size() * 2
        out["slab_mb"] = slab / 1e6
        rport = peers[SERVE_WORKERS]

        def router(ranks, **kw):
            r = ServeRouter(rport, worker_ranks=ranks,
                            queue_depth=SERVE_QUEUE_DEPTH, **kw)
            routers.append(r)
            return r

        # warm each worker's own thread (its first cuBLAS call makes the
        # thread's handle and workspace): one request a worker through
        # each prefill bucket the traffic and its replays reach
        warm = router(list(range(SERVE_WORKERS)), deadline_s=60.0)
        for extra in (0, 0, 16):
            hs = [warm.submit(prompt(extra), SERVE_NEW_TOKENS)
                  for _ in range(SERVE_WORKERS)]
            for h in hs:
                h.wait(120)
        warm.close()
        out["setup_s"] = time.perf_counter() - t0

        # what two workers sustain: a saturating burst on ranks 4 and 5
        cap = router([4, 5], deadline_s=60.0)
        n45 = meters[4]["n"] + meters[5]["n"]
        t1 = time.perf_counter()
        hs = [cap.submit(prompt(), SERVE_NEW_TOKENS)
              for _ in range(SERVE_CAPACITY_REQUESTS)]
        for h in hs:
            h.wait(120)
        wall = time.perf_counter() - t1
        cap.close()
        capacity = SERVE_CAPACITY_REQUESTS / wall
        r_max = (meters[4]["n"] + meters[5]["n"] - n45) / 2 / wall
        rate = capacity / 2
        period = 1.0 / rate
        out.update(capacity_rps=capacity, rate_rps=rate,
                   saturated_it_s=r_max)
        print(f"serve (a): two workers sustain {capacity:.2f} req/s "
              f"({r_max:.1f} decode iterations/s each); offered rate "
              f"{rate:.2f} req/s (period {period * 1e3:.1f} ms)")

        # the after phase's regime before any kill: ranks 4 and 5 alone
        # at the offered rate
        base = router([4, 5], deadline_s=SERVE_DEADLINE_S)
        t1 = time.perf_counter()
        hs = []
        for i in range(SERVE_BASELINE_REQUESTS):
            hs.append(base.submit(prompt(), SERVE_NEW_TOKENS))
            time.sleep(max(0.0, t1 + (i + 1) * period - time.perf_counter()))
        for h in hs:
            h.wait(120)
        base.close()
        two = [h.done_s - h.submitted_s for h in hs]
        out.update(p50_two_workers_ms=_pct(np, two, 50) * 1e3,
                   p99_two_workers_ms=_pct(np, two, 99) * 1e3)
        print(f"serve (a): two workers at the offered rate, before the "
              f"kills: {len(two)} requests, p50 "
              f"{out['p50_two_workers_ms']:.1f} ms, p99 "
              f"{out['p99_two_workers_ms']:.1f} ms")

        main = router(list(range(SERVE_WORKERS)),
                      deadline_s=SERVE_DEADLINE_S, strike_limit=SERVE_STRIKES,
                      topology=SliceTopology(SERVE_SLICES, 2))

        # the decode cadence at the offered rate, each worker
        before = [m["n"] for m in meters]
        t1 = time.perf_counter()
        cal = []
        while time.perf_counter() - t1 < SERVE_CALIBRATE_S:
            cal.append(main.submit(prompt(), SERVE_NEW_TOKENS))
            time.sleep(max(0.0, t1 + len(cal) * period - time.perf_counter()))
        cal_wall = time.perf_counter() - t1
        r_cal = [(m["n"] - b) / cal_wall for m, b in zip(meters, before)]
        for h in cal:
            h.wait(120)
        cal_e2e = [h.done_s - h.submitted_s for h in cal]
        p50_cal = _pct(np, cal_e2e, 50)
        # least-outstanding dispatch with the lowest-rank tie-break sends
        # every request to the lowest live rank while one request is done
        # before the next arrives; so rank 1 first decodes when it is
        # handed the extra request of the pair below, and rank 2 decodes
        # all the traffic once slice 0 is out.  Where a worker does decode
        # at the offered rate (a slower host), its measured cadence
        # carries it past the pre-kill window first.  Rank 1's kill is
        # armed when the pair arrives, at its own count then: on a host
        # where it decodes through the pre-kill window faster than it did
        # while calibrating, a step chosen here came before that window
        # filled (19 of 30 requests on one slower H100 host)
        now = [m["n"] for m in meters]
        busiest = max(r_cal)
        t_pre = (SERVE_MIN_PRE + 10) * period + 2 * p50_cal
        t_mid = t_pre + SERVE_DEADLINE_S + 1.0
        s2 = max(now[2] + int(r_cal[2] * t_mid),
                 now[3] + int(r_cal[3] * t_mid)) + int(
                     busiest * SERVE_KILL_GAP_S)
        slice_kill = f"die_slice:slice=1,step={s2},mode=raise,rps=2"
        out.update(s2=s2, calibrate_it_s=r_cal, p50_calibrate_s=p50_cal)
        print(f"serve (a): decode iterations/s at the offered rate "
              f"{[round(x, 1) for x in r_cal]}; e2e p50 {p50_cal * 1e3:.1f} "
              f"ms; S1 rank 1's count when the pair arrives + "
              f"{SERVE_KILL1_ITERATIONS} (rank 1 at {now[1]} now), S2 {s2} "
              f"(ranks 2, 3 at {now[2]}, {now[3]}: {SERVE_KILL_GAP_S} s at "
              f"{busiest:.1f} iterations/s after {t_mid:.2f} s)")

        reused0 = REGISTRY.counter("kf_serve_prefill_tokens_total",
                                   what="reused").value
        computed0 = REGISTRY.counter("kf_serve_prefill_tokens_total",
                                     what="computed").value
        replayed0 = main.replayed
        busy0 = [(m["n"], m["busy_s"]) for m in meters]
        marks: dict = {}
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                t = time.perf_counter()
                dead = main.dead_workers
                if "k1" not in marks and servers[1].dead:
                    marks["k1"] = t
                if "r1" not in marks and 1 in dead:
                    marks["r1"] = t
                    marks["dead_r1"] = dead
                if "k2" not in marks and (servers[2].dead
                                          or servers[3].dead):
                    marks["k2"] = t
                if "r2" not in marks and {2, 3} <= set(dead):
                    marks["r2"] = t
                    marks["dead_r2"] = dead
                    marks["open_r2"] = sum(1 for _, h in list(sent)
                                           if not h.done())
                time.sleep(0.005)

        os.environ["KF_CHAOS_SPEC"] = slice_kill
        sent = []  # (prompt, handle) as each submit returns
        submits = []
        # each arrival is submitted from a pool thread, as by a client of
        # its own: a dispatch that waits out a dead worker's connect
        # retries (about 0.6 s) delays its own request, not the arrivals
        # behind it, which would otherwise land as one burst after it
        pool = ThreadPoolExecutor(SERVE_SUBMITTERS,
                                  thread_name_prefix="kf-smoke-submit")
        poller = threading.Thread(target=poll, daemon=True)
        poller.start()

        def arrive():
            p = prompt()
            submits.append(pool.submit(lambda: sent.append(
                (p, main.submit(p, SERVE_NEW_TOKENS)))))

        t_load = time.perf_counter()
        regular = 0
        pair_at = None
        while True:
            now_t = time.perf_counter()
            if now_t - t_load > SERVE_LOAD_LIMIT_S:
                stop.set()
                pool.shutdown(wait=False, cancel_futures=True)
                raise SmokeFailure(
                    f"(a) the kills did not both happen within "
                    f"{SERVE_LOAD_LIMIT_S} s of load: marks {sorted(marks)}")
            r2 = marks.get("r2")
            if r2 is not None and sum(
                    1 for _, h in list(sent) if h.submitted_s > r2) \
                    >= SERVE_AFTER_TARGET:
                break
            if pair_at is None and sum(
                    1 for _, h in list(sent) if h.done()) \
                    >= SERVE_MIN_PRE + 5:
                s1 = meters[1]["n"] + SERVE_KILL1_ITERATIONS
                spec = f"die:rank=1,step={s1},mode=raise;{slice_kill}"
                os.environ["KF_CHAOS_SPEC"] = spec
                out.update(s1=s1, chaos_spec=spec)
                print(f"serve (a): KF_CHAOS_SPEC={spec!r} as the pair "
                      f"arrives")
                # one extra arrival beside the regular one: the pair
                # overlaps, so the dispatch hands one of them to rank 1
                pair_at = now_t - t_load
                arrive()
            arrive()
            regular += 1
            time.sleep(max(0.0, t_load + regular * period
                           - time.perf_counter()))
        pool.shutdown(wait=True)
        for f in submits:
            f.result()  # a failed admission fails the run
        prompts = [p for p, _ in sent]
        handles = [h for _, h in sent]
        outs = []
        for h in handles:
            try:
                outs.append(h.wait(120))
            except Exception as e:  # noqa: BLE001 - counted as lost
                outs.append(e)
        load_wall = time.perf_counter() - t_load
        stop.set()
        poller.join(2.0)
        os.environ.pop("KF_CHAOS_SPEC", None)
        # every count was reset when the phase began: the launches of
        # the served traffic alone, before any teacher forcing
        out["served_launches"] = attention.launch_counts["flash_fwd"]

        lost = [h.rid for h, o in zip(handles, outs)
                if not isinstance(o, list) or len(o) != SERVE_NEW_TOKENS]
        check(not lost, f"(a) {len(lost)} accepted requests lost: {lost[:5]}")
        k1, r1, k2, r2 = (marks.get(k) for k in ("k1", "r1", "k2", "r2"))
        check(None not in (k1, r1, k2, r2),
              f"(a) kills not both observed: marks {sorted(marks)}")
        check(set(marks["dead_r1"]) == {0, 1},
              f"(a) after rank 1 died the router excluded "
              f"{marks['dead_r1']}, not slice 0 (ranks 0 and 1) whole")
        check(r1 < k2, "(a) the slice kill came before the first recovery")
        check(set(marks["dead_r2"]) == {0, 1, 2, 3}
              and main.dead_workers == [0, 1, 2, 3]
              and main.live_workers == [4, 5],
              f"(a) after the slice kill dead {main.dead_workers}, live "
              f"{main.live_workers}")
        replays = main.replayed - replayed0
        check(replays >= 1, "(a) no request was replayed")

        def overlaps(h, lo, hi):
            return h.submitted_s <= hi and h.done_s >= lo

        phases = {"pre": [], "during_worker_kill": [], "between": [],
                  "during_slice_kill": [], "after": []}
        for h in handles:
            e2e = h.done_s - h.submitted_s
            if overlaps(h, k1, r1):
                phases["during_worker_kill"].append(e2e)
            elif overlaps(h, k2, r2):
                phases["during_slice_kill"].append(e2e)
            elif h.done_s < k1:
                phases["pre"].append(e2e)
            elif h.submitted_s > r2:
                phases["after"].append(e2e)
            else:
                phases["between"].append(e2e)
        rows = {k: {"n": len(v), "p50_ms": (_pct(np, v, 50) or 0) * 1e3,
                    "p99_ms": (_pct(np, v, 99) or 0) * 1e3}
                for k, v in phases.items()}
        for k, v in rows.items():
            print(f"serve (a) {k}: n {v['n']}, p50 {v['p50_ms']:.1f} ms, "
                  f"p99 {v['p99_ms']:.1f} ms")
        slow = sorted((h for h in handles if h.submitted_s > r2),
                      key=lambda h: h.submitted_s - h.done_s)[:5]
        out["slowest_after"] = [
            {"submitted_after_recovery_ms": (h.submitted_s - r2) * 1e3,
             "e2e_ms": (h.done_s - h.submitted_s) * 1e3,
             "ttft_ms": (h.ttft_s or 0) * 1e3, "worker": h.worker,
             "queue_ms": ((h.stats or {}).get("queue_s") or 0) * 1e3}
            for h in slow]
        out["open_at_recovery"] = marks["open_r2"]
        print(f"serve (a): {marks['open_r2']} requests open when slice 1 "
              f"was marked dead; the slowest after the recovery "
              f"{json.dumps(out['slowest_after'])}")
        check(len(phases["pre"]) >= SERVE_MIN_PRE,
              f"(a) {len(phases['pre'])} requests finished before the first "
              f"kill, fewer than {SERVE_MIN_PRE}")
        check(len(phases["after"]) >= SERVE_MIN_AFTER,
              f"(a) {len(phases['after'])} requests after the recovery")
        p99_after = _pct(np, phases["after"], 99)
        ratio = p99_after / _pct(np, phases["pre"], 99)
        check(ratio <= SERVE_RECOVERY_RATIO,
              f"(a) p99 after / p99 before = {ratio:.3f} > "
              f"{SERVE_RECOVERY_RATIO}")
        # the pre-kill phase runs six engine threads and the after phase
        # two, so the reference's ratio also compares two host regimes:
        # the after phase against the two workers' own p99, reported
        ratio_two = p99_after / (out["p99_two_workers_ms"] / 1e3)

        reused = REGISTRY.counter("kf_serve_prefill_tokens_total",
                                  what="reused").value - reused0
        computed = REGISTRY.counter("kf_serve_prefill_tokens_total",
                                    what="computed").value - computed0
        # without the paged cache every admission, replays included,
        # prefills its whole prompt
        naive = sum(len(h.prompt) + len(h.committed) for h in handles)
        check(reused > 0 and computed < naive,
              f"(a) prefix reuse not engaged: computed {computed}, reused "
              f"{reused}, no-cache cost {naive}")

        worst, exact, out["teacher_forced_launches"] = _teacher_forced(
            torch, model, params, [(p, o) for p, o in zip(prompts, outs)])
        check(worst <= GREEDY_MARGIN,
              f"(a) a served token loses to the full-context top-1 by "
              f"{worst} > {GREEDY_MARGIN}")
        replayed = [i for i, h in enumerate(handles) if h.replays]
        for i in replayed:
            h = handles[i]
            check(outs[i][:len(h.committed)] == h.committed,
                  f"(a) {h.rid}'s output does not start with its "
                  f"{len(h.committed)} committed tokens")
        replay_exact = sum(exact[i] for i in replayed)

        ttft = [h.ttft_s for h in handles if h.ttft_s is not None]
        step_ms = [((m["busy_s"] - b[1]) / max(1, m["n"] - b[0])) * 1e3
                   for m, b in zip(meters, busy0)]
        gen = SERVE_NEW_TOKENS * len(handles)
        out.update(
            pair_at_s=pair_at, kill1_at_s=k1 - t_load, kill2_at_s=k2 - t_load,
            phases=rows, recovery_ratio=ratio,
            recovery_ratio_two_workers=ratio_two, requests=len(handles),
            replayed_requests=len(replayed), replays=replays,
            replay_exact=replay_exact, exact=sum(exact),
            kill1_to_dead_s=r1 - k1, kill2_to_dead_s=r2 - k2,
            ttft_p50_ms=_pct(np, ttft, 50) * 1e3,
            ttft_p99_ms=_pct(np, ttft, 99) * 1e3,
            step_ms_per_worker=step_ms, tokens_per_s=gen / load_wall,
            load_s=load_wall, worst_margin=worst,
            prefill={"computed": computed, "reused": reused,
                     "no_cache_cost": naive},
            p50_pre_s=_pct(np, phases["pre"], 50))
        print(f"serve (a): the pair arrived {pair_at:.2f} s into the load, "
              f"rank 1 died at {k1 - t_load:.2f} s, slice 1 at "
              f"{k2 - t_load:.2f} s")
        print(f"serve (a): {len(handles)} requests over {load_wall:.2f} s, "
              f"none lost; p99 after/before {ratio:.3f} (gate "
              f"{SERVE_RECOVERY_RATIO}), after/two workers before the kills "
              f"{ratio_two:.3f}; kill -> marked dead "
              f"{r1 - k1:.3f} s (rank 1, slice 0 excluded), {r2 - k2:.3f} s "
              f"(slice 1); {replays} replays of {len(replayed)} requests, "
              f"{replay_exact} of them equal to full-context greedy, "
              f"{sum(exact)}/{len(handles)} overall; worst top-1 margin "
              f"{worst:.3e} (tol {GREEDY_MARGIN})")
        print(f"serve (a): TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 "
              f"{out['ttft_p99_ms']:.1f} ms; decode iteration ms per worker "
              f"{[round(x, 2) for x in step_ms]}; {gen / load_wall:.1f} "
              f"generated tokens/s; prefill computed {computed}, reused "
              f"{reused}, no-cache cost {naive}; slab {slab / 1e6:.1f} MB "
              f"an engine")
    finally:
        os.environ.pop("KF_CHAOS_SPEC", None)
        for r in routers:
            r.close()
        for s in servers:
            if not s.dead:
                s.stop()
        for p in peers:
            try:
                p.close()
            except Exception:  # noqa: BLE001 - the victims closed theirs
                pass
        chaos.reset()
    return out


def _get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _serve_autoscale(torch, np, model, params) -> dict:
    """(b) ``ServeFleet`` from the live aggregator: a router and three
    provisioned worker ranks under a ``ConfigServer`` with a
    ``ClusterAggregator``, every peer pushing snapshots; a burst on the
    one live worker spawns a second, which serves; idle ticks retire it.
    Then (c) on the same worker."""
    from kungfu_tpu_torch.elastic.configserver import ConfigServer
    from kungfu_tpu_torch.monitor.aggregator import ClusterAggregator
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.policy.serve import (BatchWidthController,
                                               ServeAutoscalePolicy)
    from kungfu_tpu_torch.serve.router import ServeRouter, ServeWorker
    from kungfu_tpu_torch.serve.scale import ServeFleet
    from kungfu_tpu_torch.serve.slo import SLOTargets

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(17)
    system = rng.integers(0, vocab, size=SERVE_SYSTEM_TOKENS).tolist()

    def prompt():
        return system + rng.integers(0, vocab,
                                     size=SERVE_USER_TOKENS).tolist()

    out = {}
    srv = ConfigServer(port=0, aggregator=ClusterAggregator(
        stale_after=60.0)).start()
    old = _set_env({"KF_CONFIG_ENABLE_CLUSTER_MONITOR": "1",
                    "KF_CONFIG_MONITOR_PUSH_PERIOD": str(SERVE_PUSH_PERIOD_S)})
    cluster_url = f"http://127.0.0.1:{srv.port}/cluster"
    peers, servers, router = [], {}, None
    engines, widths, ctls = {}, [], {}
    try:
        peers = start_local_cluster(4, env={"KF_CONFIG_SERVER": srv.url},
                                    devices=["cuda"])
        router_peer = peers[3]

        def start_worker(rank):
            eng = _serve_engine(model, params, rank)
            engines[rank] = eng
            w = ServeWorker(peers[rank], eng,
                            commit_every=SERVE_COMMIT_EVERY).start()
            servers[rank] = w
            return w

        def control(rank):
            eng = engines[rank]
            ctls[rank] = BatchWidthController(
                lambda w: (widths.append((rank, w)) or eng.set_width(w)),
                lo=1, hi=SERVE_MAX_BATCH, targets=targets)

        start_worker(0)
        router = ServeRouter(router_peer, worker_ranks=[0],
                             queue_depth=SERVE_QUEUE_DEPTH,
                             deadline_s=SERVE_DEADLINE_S)
        router.submit(prompt(), SERVE_NEW_TOKENS).wait(120)  # warm thread
        h = router.submit(prompt(), SERVE_NEW_TOKENS)
        h.wait(120)
        alone = h.done_s - h.submitted_s
        # a burst of 16 on one worker of width 4 completes about one
        # batch per unloaded latency: the first batch finishes near 1.1 of
        # it (admission takes a step a request), the second near 2, so a
        # budget of 1.2 is blown while the queue still holds 8
        targets = SLOTargets(ttft_s=0.5, e2e_s=1.2 * alone)
        out.update(alone_ms=alone * 1e3, e2e_budget_ms=targets.e2e_s * 1e3)
        control(0)
        spawn_s = []

        def spawn(rank):
            w = start_worker(rank)
            control(rank)
            return w

        fleet = ServeFleet(router, ServeAutoscalePolicy(
            targets=targets, scale_up_queue=2, cooldown_steps=0), spawn)
        burst = [router.submit(prompt(), SERVE_NEW_TOKENS)
                 for _ in range(SERVE_BURST)]
        t0 = time.perf_counter()
        spawned = []
        while not spawned:
            check(time.perf_counter() - t0 < 60,
                  "(b) the fleet did not spawn within 60 s of the burst")
            view = _get_json(cluster_url)
            for ctl in list(ctls.values()):
                ctl.observe_view(view)
            t1 = time.perf_counter()
            spawned = fleet.tick(view)
            if spawned:
                spawn_s.append(time.perf_counter() - t1)
            else:
                time.sleep(SERVE_PUSH_PERIOD_S)
        new = spawned[0]
        check(router.live_workers == [0, new],
              f"(b) live workers {router.live_workers} after the spawn")
        extra = [router.submit(prompt(), SERVE_NEW_TOKENS) for _ in range(4)]
        done = [h.wait(120) for h in burst + extra]
        check(all(len(o) == SERVE_NEW_TOKENS for o in done),
              "(b) a request was lost")
        on_new = [h for h in extra if h.worker == new]
        check(on_new, f"(b) no request completed on the spawned worker {new}")
        # quiet: two push periods with no traffic, then the rollup
        time.sleep(3 * SERVE_PUSH_PERIOD_S)
        view = _get_json(cluster_url)
        srv_view = view["serving"]
        rows = {r["rank"]: r["gauges"].get("kf_kv_cache_bytes")
                for r in view["ranks"]}
        live_pools = {r: engines[r].pool.footprint_bytes
                      for r in router.live_workers}
        # each live worker's rank reports its own pool, the router's
        # and the unspawned rank none
        check(srv_view is not None and srv_view["completed"] > 0,
              f"(b) no serving rollup with completions: {srv_view}")
        check(rows == {**{r: None for r in range(4)}, **live_pools}
              and srv_view["kv_bytes"] == sum(live_pools.values()),
              f"(b) kv_bytes {srv_view['kv_bytes']}, rows {rows}, live "
              f"pools {live_pools}")
        t0 = time.perf_counter()
        while router.live_workers != [0]:
            check(time.perf_counter() - t0 < 30,
                  f"(b) idle ticks did not retire worker {new}")
            view = _get_json(cluster_url)
            for r in router.live_workers:
                ctls[r].observe_view(view)
            fleet.tick(view)
            time.sleep(SERVE_PUSH_PERIOD_S)
        check(new not in fleet.workers, "(b) the retired worker is still owned")
        out.update(spawned=new, spawn_s=spawn_s[0], widths=widths,
                   kv_bytes_view=srv_view["kv_bytes"],
                   live_pools_bytes=sum(live_pools.values()),
                   completed_view=srv_view["completed"],
                   served_by_new=len(on_new))
        print(f"serve (b): burst of {SERVE_BURST} on one worker (e2e budget "
              f"{targets.e2e_s * 1e3:.1f} ms) spawned worker {new} in "
              f"{spawn_s[0]:.2f} s (engine build, warmup, admit); it served "
              f"{len(on_new)} of 4 later requests; idle ticks retired it; "
              f"widths set {widths}; view kv_bytes {srv_view['kv_bytes']} "
              f"= the live pools {live_pools}, completed "
              f"{srv_view['completed']}")
        out["warm"] = _serve_warm(torch, np, model, params, router,
                                  engines[0], vocab)
    finally:
        if router is not None:
            router.close()
        for w in servers.values():
            if not w.dead:
                w.stop()
        for p in peers:
            p.close()
        _set_env(old)
        srv.stop()
    return out


def _serve_warm(torch, np, model, params, router, eng, vocab) -> dict:
    """(c) A warm cache across a cold restart: the worker's committed
    pages through ``PersistPlane`` to disk and back into a fresh
    engine's pool; the same prompt reuses its four whole pages."""
    import shutil
    import tempfile

    from kungfu_tpu_torch.elastic.persist import (PersistPlane,
                                                  restore_from_manifest)
    from kungfu_tpu_torch.serve.kvcache import KVCachePool

    rng = np.random.default_rng(18)
    p = rng.integers(0, vocab, size=SERVE_WARM_PROMPT).tolist()
    first = router.submit(p, SERVE_NEW_TOKENS).wait(120)
    snap = eng.pool.snapshot_committed()
    root = tempfile.mkdtemp(prefix="kf-serve-warm-")
    try:
        t0 = time.perf_counter()
        plane = PersistPlane(root, 0, period_s=0.0)
        mdir = plane.persist_async(1, replicated=snap).wait(120)
        plane.close()
        back = restore_from_manifest(mdir, 0, 1).replicated
        disk_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_pages = sum(1 for k in back if k.endswith("_p"))
    fresh = _serve_engine(model, params, 0)
    # a second warmup with longer prompts captures only the new buckets
    before, decode = set(fresh._prefill_graphs), fresh._decode_graph
    fresh.warmup(prompt_lens=(SERVE_MAX_SEQ,))
    added = sorted(set(fresh._prefill_graphs) - before)
    check(before and max(fresh._prefill_graphs) == SERVE_MAX_SEQ
          and before < set(fresh._prefill_graphs)
          and fresh._decode_graph is decode,
          f"(c) a second warmup captured {sorted(fresh._prefill_graphs)} "
          f"after {sorted(before)}")
    restored, rejected = fresh.pool.restore_committed(back)
    check(restored > 0 and rejected == 0 and restored == n_pages,
          f"(c) restore gave ({restored}, {rejected}) of {n_pages} pages")
    fresh.submit("warm", p, SERVE_NEW_TOKENS)
    done = [e for e in fresh.drain() if e["kind"] == "done"][0]
    whole = (SERVE_WARM_PROMPT - 1) // SERVE_PAGE_TOKENS * SERVE_PAGE_TOKENS
    check(done["reused_tokens"] == whole == 64,
          f"(c) reused {done['reused_tokens']} tokens, expected {whole}")
    worst, exact, checked = _teacher_forced(
        torch, model, params, [(p, done["tokens"]), (p, first)])
    check(worst <= GREEDY_MARGIN,
          f"(c) a token loses to the full-context top-1 by {worst}")
    same = sum(a == b for a, b in zip(done["tokens"], first))
    bad = dict(back)
    k = bad["kv0_k"].clone()
    k.view(torch.uint8).view(-1)[0] ^= 1
    bad["kv0_k"] = k
    spoiled = KVCachePool(fresh.pool.spec, SERVE_PAGES).restore_committed(bad)
    check(spoiled == (n_pages - 1, 1),
          f"(c) a page with one flipped byte gave {spoiled}")
    print(f"serve (c): {n_pages} committed pages through the persist plane "
          f"in {disk_s:.2f} s, restored ({restored}, {rejected}); the "
          f"{SERVE_WARM_PROMPT}-token prompt reused {done['reused_tokens']} "
          f"tokens; {same}/{SERVE_NEW_TOKENS} tokens equal to the first "
          f"answer; worst top-1 margin {worst:.3e}; one flipped byte -> "
          f"{spoiled}; a second warmup added prefill graphs {added}")
    return {"pages": n_pages, "restored": restored, "rejected": rejected,
            "reused": done["reused_tokens"], "same_as_first": same,
            "worst_margin": worst, "disk_s": disk_s, "flipped": spoiled,
            "graphs_added": added, "teacher_forced_launches": checked}


#: phase 17: the in-mesh 4-D plan on the flagship.  MeshPlan.auto(16)'s
#: factorization over sixteen co-resident ranks of the card, the batch
#: [8, 1024] (each rank [4, 512] in two microbatches of [2, 512], six
#: local heads, six layers a stage), the reference trainer's default
#: optimizer sgd(0.01), the loss through the fused cross-entropy
SHARDED_PLAN = dict(dp=2, pp=2, sp=2, tp=2, n_micro=2)
SHARDED_BATCH, SHARDED_SEQ = 8, 1024
SHARDED_STEPS = 5
SHARDED_LR = 0.01
#: trainer.loss (and the loss before each of the five steps) against the
#: one-rank model's, and trainer.loss against the plain sharded run's:
#: tp sums two bf16 partial products where the one rank rounds one full
#: product, the ring merges two flash blocks by lse, and the plain run's
#: attention rounds otherwise than the kernels'.  Set from readings on an
#: H100 (deterministic kernels, so each run reads the same): 1.56e-6,
#: 4.6e-7 and 2.8e-6 at most over the trajectory.  At init the loss sits
#: near ln(32128) whatever attention computes (the one-rank f32 loss is
#: 9.2e-7 from the bf16 one; the loss without the causal mask, an
#: attention fault, is printed beside it), so this limit catches gross
#: faults only; the gradient checks below are the ones that see attention
SHARDED_LOSS_RTOL = 1e-5
#: the synchronized first-step gradient against the one-rank gradient
#: and the plain sharded run's, relative L2 per leaf, floored at 1e-3 of
#: the largest leaf's norm as RANKS_GRAD_REL_L2 is (the key biases'
#: gradient is rounding noise on both sides), for the reasons of
#: SHARDED_LOSS_RTOL (readings: worst leaves 2.3e-2 and 1.8e-2, medians
#: 8.7e-3 and 8.1e-3); and the loss's fall over the five steps against
#: the one-rank model's (reading 3.8e-3), a sum of products of the two
SHARDED_GRAD_REL_L2 = 5e-2
#: (b): f32 at the reference's own tolerances (tests/test_parallel.py:
#: 165, 248-267): the loss, and the params after one sgd(0.05) step
SHARDED_F32_LAYERS_A_STAGE = 2
SHARDED_F32_LR = 0.05
SHARDED_F32_LOSS_RTOL = 1e-5
SHARDED_F32_RTOL, SHARDED_F32_ATOL = 2e-4, 2e-5
#: (c): ring attention alone over four sp ranks, [B, H, S, D] bf16
RING_SP = 4
RING_SHAPE = (2, 12, 4096, 64)
#: (d): MoE on dp2 x sp2 x tp2 at the flagship's width, two layers, four
#: experts; EP over dp against local routing at the reference's own
#: tolerance (tests/test_parallel.py:298), f32
MOE_EXPERTS = 4
MOE_TOKENS = 4096
MOE_RTOL = MOE_ATOL = 2e-5
MOE_STEPS = 3


class _PlainFlash:
    """``flash_attention_with_lse`` through the plain versions on CUDA
    tensors: ``flash_attention_reference`` forward and
    ``flash_attention_backward_reference`` with ``delta = rowsum(dO * O)
    - dlse``, the shift the kernels' wrapper forms."""

    def __init__(self, torch, attention):
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal):
                out, lse = attention.flash_attention_reference(q, k, v,
                                                               causal)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.causal = causal
                return out, lse

            @staticmethod
            def backward(ctx, dout, dlse):
                q, k, v, out, lse = ctx.saved_tensors
                delta = (dout.float() * out.float()).sum(-1) - dlse.float()
                return (*attention.flash_attention_backward_reference(
                    q, k, v, out, lse, dout, ctx.causal, delta=delta), None)

        self.fn = Fn

    def __call__(self, q, k, v, causal=True):
        return self.fn.apply(q, k, v, causal)


def _rel_l2_leaves(got: dict, ref: dict) -> dict:
    """Relative L2 per leaf of two flat trees, the denominator floored at
    1e-3 of the largest leaf norm."""
    norms = {k: t.float().norm().item() for k, t in ref.items()}
    floor = 1e-3 * max(norms.values())
    return {k: (got[k].float() - ref[k].float()).norm().item()
            / max(norms[k], floor) for k in ref}


def _global_flat(trainer, tree, L: int) -> dict:
    """A sharded trainer's tree (params or gradients) as the one-rank
    Transformer's flat ``layer_{i}/...`` keys, reassembled from the
    ranks' blocks."""
    from kungfu_tpu_torch.models.transformer import flatten

    glob = flatten(trainer.gather_params(tree))
    out = {}
    for key, t in glob.items():
        if key.startswith("layers/"):
            for i in range(L):
                out[f"layer_{i}/{key[len('layers/'):]}"] = t[i]
        else:
            out[key] = t
    return out


def _sharded_batch(torch, np, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(
        0, vocab, size=(SHARDED_BATCH, SHARDED_SEQ))).cuda()
        for _ in range(2))


def phase_sharded(torch, np, kernels, tr, spec):
    """Phase 17: the in-mesh 4-D ShardedTrainer on the card; see the
    module docstring.  Returns the result; its ``launches`` are (a)'s
    main path: the loss and the five steps."""
    from kungfu_tpu_torch import profile
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.optimizers import GradientTransformation, sgd
    from kungfu_tpu_torch.parallel import MeshPlan, ParallelPlan, ShardedTrainer

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the f32 products must not run as TF32")
    check(MeshPlan.auto(16) == MeshPlan(**{k: SHARDED_PLAN[k] for k in (
        "dp", "pp", "sp", "tp")}), "MeshPlan.auto(16) is not the plan")
    saved = os.environ.get("KF_TPU_XENT")
    os.environ["KF_TPU_XENT"] = "fused"
    xent.XENT_ENV.reload()
    try:
        out = {"a": _sharded_flagship(torch, np, kernels, tr, spec, profile,
                                      GradientTransformation, sgd,
                                      ParallelPlan, ShardedTrainer)}
        torch.cuda.empty_cache()
        out["b"] = _sharded_f32(torch, np, kernels, tr, sgd, MeshPlan,
                                ShardedTrainer)
        torch.cuda.empty_cache()
        out["c"] = _ring_alone(torch, np, kernels)
        torch.cuda.empty_cache()
        out["d"] = _moe_flagship(torch, np, kernels, tr, MeshPlan,
                                 ShardedTrainer)
    finally:
        if saved is None:
            os.environ.pop("KF_TPU_XENT")
        else:
            os.environ["KF_TPU_XENT"] = saved
        xent.XENT_ENV.reload()
    out["launches"] = out["a"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _one_rank_sgd(torch, loss_fn, tparams, batch):
    """The one-rank model stepped as (a)'s trainer steps: the loss before
    each of ``SHARDED_STEPS`` sgd(``SHARDED_LR``) updates, and the first
    gradient."""
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tparams)
    losses, first = [], None
    for _ in range(SHARDED_STEPS):
        own = [t.detach().requires_grad_(True) for t in leaves]
        loss = loss_fn(tree_unflatten(treedef, own), batch)
        grads = torch.autograd.grad(loss, own)
        losses.append(float(loss.detach()))
        if first is None:
            first = tree_unflatten(treedef, list(grads))
        leaves = [t.detach() - SHARDED_LR * g for t, g in zip(own, grads)]
        del own, loss, grads
    return losses, first


def _replica_diff(torch, trainer, tree) -> tuple:
    """(largest |difference| of any leaf's replica from the replica at
    index 0 of every mesh axis that does not shard the leaf, its leaf,
    replica pairs compared) over a stacked tree: after ``sync_grads``
    every replica holds the same bits."""
    from kungfu_tpu_torch.models.transformer import flatten
    from kungfu_tpu_torch.parallel import AXES
    from kungfu_tpu_torch.parallel.train import _rank_coords

    coords = _rank_coords(trainer.plan)
    index = {tuple(c[a] for a in AXES): r for r, c in enumerate(coords)}
    specs = flatten(trainer.param_specs)
    worst, worst_leaf, pairs = 0.0, None, 0
    for name, x in flatten(tree).items():
        used = {a for a in specs[name].names if a is not None}
        for r, c in enumerate(coords):
            r0 = index[tuple(c[a] if a in used else 0 for a in AXES)]
            if r0 == r:
                continue
            pairs += 1
            if not torch.equal(x[r], x[r0]):
                d = (x[r] - x[r0]).abs().max().item()
                d = math.inf if math.isnan(d) else d
                if d >= worst:
                    worst, worst_leaf = d, name
    return worst, worst_leaf, pairs


def _sharded_plain(torch, kernels, attention, xent, cfg, tparams, batch, GT,
                   sgd, ParallelPlan, ShardedTrainer):
    """(a)'s loss and first synchronized gradient with no hand-written
    kernel: the same sharded trainer with the flash kernels' plain
    versions (``_PlainFlash``), ``KF_TPU_XENT=plain`` and the ``psum``
    schedule."""
    inner = sgd(SHARDED_LR)
    seen = {}

    def update(grads, state, p=None):
        seen.setdefault("grads", grads)
        return inner.update(grads, state, p)

    plan = ParallelPlan(**SHARDED_PLAN, collective_schedule="psum")
    trainer = ShardedTrainer(cfg, plan, tx=GT(inner.init, update),
                             devices=["cuda:0"] * plan.size)
    params = trainer.from_transformer_params(tparams)
    state = {"params": params, "opt_state": trainer.tx.init(params),
             "step": 0}
    real = attention.flash_attention_with_lse
    attention.flash_attention_with_lse = _PlainFlash(torch, attention)
    os.environ["KF_TPU_XENT"] = "plain"
    xent.XENT_ENV.reload()
    before = _counts(kernels)
    try:
        loss = float(trainer.loss(state, batch))
        trainer.step(state, batch)
        torch.cuda.synchronize()
    finally:
        attention.flash_attention_with_lse = real
        os.environ["KF_TPU_XENT"] = "fused"
        xent.XENT_ENV.reload()
    after = _counts(kernels)
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    check(not launched, f"(a)'s plain run launched kernels: {launched}")
    grads = _global_flat(trainer, seen.pop("grads"), cfg.n_layers)
    return loss, grads


def _sharded_flagship(torch, np, kernels, tr, spec, profile, GT, sgd,
                      ParallelPlan, ShardedTrainer):
    """(a): the flagship over sixteen co-resident ranks, held against the
    one-rank model stepped the same way and against the same sharded
    step through the kernels' plain versions."""
    from dataclasses import replace

    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.cuda import attention

    cfg = tr.TransformerConfig(**{**FLAGSHIP, "max_seq": SHARDED_SEQ})
    model = tr.Transformer(cfg)
    tparams = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = _sharded_batch(torch, np, cfg.vocab_size)
    flash = attention.make_flash_attn()

    def one_loss(p, b):
        return model.loss(p, b, train=False, attn_fn=flash)

    want_losses, g_one = _one_rank_sgd(torch, one_loss, tparams, batch)
    g_one = tr.flatten(g_one)
    want_loss = want_losses[0]
    # controls for the loss limit: the same one-rank loss with every
    # product in f32 instead of bf16, and with attention that sees the
    # future (an attention fault)
    f32_loss, nc_loss = (float(tr.Transformer(replace(cfg, **kw)).loss(
        tparams, batch, train=False, attn_fn=flash))
        for kw in ({"dtype": "float32"}, {"causal": False}))
    plain_loss, g_plain = _sharded_plain(
        torch, kernels, attention, xent, cfg, tparams, batch, GT, sgd,
        ParallelPlan, ShardedTrainer)
    torch.cuda.empty_cache()

    inner = sgd(SHARDED_LR)
    seen = {}

    def update(grads, state, p=None):
        # keep the first synchronized gradient the optimizer receives
        seen.setdefault("grads", grads)
        return inner.update(grads, state, p)

    plan = ParallelPlan(**SHARDED_PLAN, collective_schedule="pallas_ring")
    t0 = time.perf_counter()
    trainer = ShardedTrainer(cfg, plan, tx=GT(inner.init, update),
                             devices=["cuda:0"] * plan.size)
    params = trainer.from_transformer_params(tparams)
    state = {"params": params, "opt_state": trainer.tx.init(params),
             "step": 0}
    torch.cuda.synchronize()
    param_gib = sum(t.numel() * 4 for t in tr.flatten(params).values()) / 2**30
    print(f"sharded (a): {plan.size} ranks dp{plan.dp} pp{plan.pp} "
          f"sp{plan.sp} tp{plan.tp}, n_micro {trainer.n_micro}, stacked f32 "
          f"params {param_gib:.2f} GiB, set-up "
          f"{time.perf_counter() - t0:.2f} s")

    # the main path, launches counted from zero: the loss, five steps
    _reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    loss0 = float(trainer.loss(state, batch))
    loss_rel = abs(loss0 - want_loss) / abs(want_loss)
    plain_rel = abs(loss0 - plain_loss) / abs(plain_loss)
    f32_rel = abs(f32_loss - want_loss) / abs(want_loss)
    nc_rel = abs(nc_loss - want_loss) / abs(want_loss)
    print(f"sharded (a) loss {loss0:.7f}: vs one rank {want_loss:.7f} rel "
          f"{loss_rel:.3e}, vs the plain sharded run {plain_loss:.7f} rel "
          f"{plain_rel:.3e} (tol {SHARDED_LOSS_RTOL}); controls, one rank's "
          f"loss in f32 {f32_loss:.7f} rel {f32_rel:.3e}, without the "
          f"causal mask {nc_loss:.7f} rel {nc_rel:.3e}; launches of the "
          f"loss {_counts(kernels)}")
    check(np.isfinite(loss0) and loss_rel <= SHARDED_LOSS_RTOL,
          f"sharded loss {loss0} != one rank's {want_loss}")
    check(plain_rel <= SHARDED_LOSS_RTOL,
          f"sharded loss {loss0} != the plain sharded run's {plain_loss}")

    losses, times = [], []
    before = _counts(kernels)
    for i in range(SHARDED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = trainer.step(state, batch)
        end.record()
        losses.append(float(loss))  # synchronises
        times.append(start.elapsed_time(end))
        if i == 0:
            after = _counts(kernels)
            per_step = {k: after[k] - before[k] for k in after}
    main = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_layers_stage = cfg.n_layers // plan.pp
    ticks = trainer.n_micro + plan.pp - 1
    # a causal ring over two sp ranks: round 0 one diagonal launch over
    # every rank's rows, round 1 one full launch over the sp-1 ranks'
    n_flash = ticks * n_layers_stage * plan.sp
    n_leaves = len(tr.flatten(params))
    groups = plan.size // plan.dp
    want = {k: 0 for k in per_step}
    want.update(flash_fwd=n_flash, flash_bwd_dq=n_flash,
                flash_bwd_dkv=n_flash,
                xent_fwd=1, xent_bwd=1, ring_rs=n_leaves * groups,
                ring_ag=n_leaves * groups)
    print(f"sharded (a) step 1 launches {per_step} (expected {want})")
    check(per_step == want, f"sharded step launched {per_step}, expected "
          f"{want}")

    # every replica of the synchronized gradient and of the params after
    # the steps holds the same bits as its replica at index 0
    first = seen.pop("grads")
    for what, tree in (("first-step gradient", first),
                       (f"params after {SHARDED_STEPS} steps",
                        state["params"])):
        d, leaf, pairs = _replica_diff(torch, trainer, tree)
        print(f"sharded (a) {what}: {pairs} replica pairs over the axes "
              f"that do not shard each leaf, largest |difference| {d} "
              f"({leaf})")
        check(d == 0.0, f"the {what}'s replicas of {leaf} differ by {d}")

    # the synchronized first-step gradient, reassembled, against one rank
    # and against the plain sharded run
    got = _global_flat(trainer, first, cfg.n_layers)
    del first
    grad = {}
    for label, ref in (("one rank", g_one), ("the plain sharded run",
                                             g_plain)):
        rel = _rel_l2_leaves(got, ref)
        worst = max(rel, key=rel.get)
        med = statistics.median(rel.values())
        print(f"sharded (a) first-step gradient vs {label}: worst leaf "
              f"{worst} rel L2 {rel[worst]:.3e} (tol {SHARDED_GRAD_REL_L2}); "
              f"median {med:.3e} over {len(rel)} leaves; head/w "
              f"{rel['head/w']:.3e}")
        check(rel[worst] <= SHARDED_GRAD_REL_L2,
              f"sharded gradient of {worst} differs from {label}'s by "
              f"{rel[worst]}")
        grad[label] = {"worst": rel[worst], "leaf": worst, "median": med}
    del got, g_one, g_plain

    traj = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    fall, want_fall = losses[0] - losses[-1], want_losses[0] - want_losses[-1]
    fall_rel = abs(fall - want_fall) / abs(want_fall)
    print(f"sharded (a) losses: {losses}; one rank stepped the same way: "
          f"{want_losses}; largest rel difference {traj:.3e} (tol "
          f"{SHARDED_LOSS_RTOL}); fall over the steps {fall:.6e} vs one "
          f"rank's {want_fall:.6e}, rel {fall_rel:.3e} (tol "
          f"{SHARDED_GRAD_REL_L2})")
    check(all(np.isfinite(losses)), f"non-finite sharded loss {losses}")
    check(losses[-1] < losses[0],
          f"sharded loss did not fall over {SHARDED_STEPS} steps: {losses}")
    check(traj <= SHARDED_LOSS_RTOL,
          f"sharded losses {losses} != one rank's {want_losses}")
    check(fall_rel <= SHARDED_GRAD_REL_L2,
          f"sharded loss fell by {fall}, one rank's by {want_fall}")
    step_ms = statistics.median(times[1:])
    toks = SHARDED_BATCH * SHARDED_SEQ / (step_ms / 1e3)

    def run():
        nonlocal state
        state, _ = trainer.step(state, batch)

    prof = profile._profile(torch, run, 2)
    print(f"sharded (a): {step_ms:.2f} ms/step (median of CUDA-event "
          f"windows over steps 2-{SHARDED_STEPS}: {times[1:]}), {toks:.0f} "
          f"tokens/s, peak memory {peak:.2f} GiB; profiled step: "
          f"{prof['kernels_per_call']:.0f} kernels, device busy "
          f"{prof['device_busy_ms_per_call']:.2f} of "
          f"{prof['wall_ms_per_call']:.2f} ms, idle share "
          f"{prof['device_idle_share']:.4f}; by family "
          f"{prof['device_ms_by_family']}")
    return {"launches": main, "per_step": per_step, "loss": loss0,
            "one_rank_loss": want_loss, "loss_rel": loss_rel,
            "plain_loss": plain_loss, "plain_loss_rel": plain_rel,
            "f32_control_rel": f32_rel, "noncausal_control_rel": nc_rel,
            "losses": losses,
            "one_rank_losses": want_losses, "trajectory_rel": traj,
            "fall_rel": fall_rel, "grad_rel_l2": grad,
            "step_ms": step_ms, "step_ms_all": times, "tokens_s": toks,
            "peak_gib": peak, "param_gib": param_gib, "profile": prof}


def _sharded_f32(torch, np, kernels, tr, sgd, MeshPlan, ShardedTrainer):
    """(b): the flagship's widths in f32, two layers a stage, on
    dp2 x sp2 x tp2 and dp2 x pp2 x tp2: the loss and the params after
    one step against the one-rank model's at the reference's tolerances."""
    from kungfu_tpu_torch.ops.cuda import attention

    flash = attention.make_flash_attn()
    out = {}
    for plan in (MeshPlan(dp=2, sp=2, tp=2), MeshPlan(dp=2, pp=2, tp=2)):
        L = SHARDED_F32_LAYERS_A_STAGE * plan.pp
        cfg = tr.TransformerConfig(**{**FLAGSHIP, "dtype": "float32",
                                      "n_layers": L, "max_seq": SHARDED_SEQ})
        model = tr.Transformer(cfg)
        tparams = model.init(torch.Generator().manual_seed(1), device="cuda")
        batch = _sharded_batch(torch, np, cfg.vocab_size, seed=1)

        def loss_fn(p, b):
            return model.loss(p, b, train=False, attn_fn=flash)

        want_loss = float(loss_fn(tparams, batch))
        g = tr.flatten(_grads(loss_fn, tparams, batch))
        want = {k: t - SHARDED_F32_LR * g[k]
                for k, t in tr.flatten(tparams).items()}
        del g
        trainer = ShardedTrainer(cfg, plan, tx=sgd(SHARDED_F32_LR),
                                 n_micro=2 if plan.pp > 1 else 1,
                                 devices=["cuda:0"] * plan.size)
        params = trainer.from_transformer_params(tparams)
        state = {"params": params, "opt_state": trainer.tx.init(params),
                 "step": 0}
        loss = float(trainer.loss(state, batch))
        state, _ = trainer.step(state, batch)
        got = _global_flat(trainer, state["params"], L)
        ratio = {k: ((got[k] - want[k]).abs() / (
            SHARDED_F32_ATOL + SHARDED_F32_RTOL * want[k].abs())).max().item()
            for k in want}
        worst = max(ratio, key=ratio.get)
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        label = f"dp{plan.dp}pp{plan.pp}sp{plan.sp}tp{plan.tp}"
        print(f"sharded (b) f32 {label}, {L} layers: loss {loss:.7f} vs one "
              f"rank {want_loss:.7f}, rel {loss_rel:.3e} (tol "
              f"{SHARDED_F32_LOSS_RTOL}); params after one step: worst leaf "
              f"{worst} at {ratio[worst]:.3f} of |d| <= {SHARDED_F32_ATOL} + "
              f"{SHARDED_F32_RTOL}|ref|")
        check(loss_rel <= SHARDED_F32_LOSS_RTOL,
              f"f32 {label} loss {loss} != one rank's {want_loss}")
        check(ratio[worst] <= 1.0,
              f"f32 {label} params of {worst} off by {ratio[worst]} of the "
              "tolerance")
        out[label] = {"loss_rel": loss_rel, "param_worst_leaf": worst,
                      "param_tol_share": ratio[worst]}
        del model, tparams, trainer, params, state, got, want
        torch.cuda.empty_cache()
    return out


def _ring_alone(torch, np, kernels):
    """(c): ring attention over four sp ranks, bf16, causal and
    bidirectional: the flash kernels (non-zero lse cotangent) against the
    same ring through the plain flash versions and against dense f32
    attention on the whole sequence; the gathered path over the ring
    kernels against dense."""
    from kungfu_tpu_torch.models.transformer import default_attention
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.parallel import ring

    B, H, S, D = RING_SHAPE
    n = RING_SP
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))

    def stack(t):
        return t.reshape(B, H, n, S // n, D).permute(2, 0, 1, 3, 4).contiguous()

    def unstack(t):
        return t.permute(1, 2, 0, 3, 4).reshape(B, H, S, D)

    def run(causal, **kw):
        leaves = [stack(t).requires_grad_(True) for t in (q, k, v)]
        before = _counts(kernels)
        with collective.rank_world([("sp", n)]):
            o = ring.ring_attention(*leaves, causal=causal, axis="sp", **kw)
            grads = torch.autograd.grad(o, leaves, stack(do))
        torch.cuda.synchronize()
        after = _counts(kernels)
        return (unstack(o.detach()), [unstack(g) for g in grads],
                {key: after[key] - before[key] for key in after
                 if after[key] != before[key]})

    out = {}
    plain = _PlainFlash(torch, attention)
    for causal in (True, False):
        f32 = [t.float().requires_grad_(True) for t in (q, k, v)]
        ro = default_attention(*f32, causal)
        rg = torch.autograd.grad(ro, f32, do.float())
        ro = ro.detach()
        top = max(g.abs().max().item() for g in rg)
        g_tol = BF16_GRAD_RTOL * top
        ko, kg, k_launch = run(causal, block_impl="flash")
        real = attention.flash_attention_with_lse
        attention.flash_attention_with_lse = plain
        try:
            po, pg, p_launch = run(causal, block_impl="flash")
        finally:
            attention.flash_attention_with_lse = real
        go, gg, g_launch = run(causal, kv_gather="pallas_ring")
        errs = {
            "o_vs_plain": (ko.float() - po.float()).abs().max().item(),
            "o_vs_dense": (ko.float() - ro).abs().max().item(),
            "grad_vs_plain": _grad_err(kg, pg),
            "grad_vs_dense": _grad_err(kg, rg),
            "gathered_o_vs_dense": (go.float() - ro).abs().max().item(),
            "gathered_grad_vs_dense": _grad_err(gg, rg)}
        label = "causal" if causal else "full"
        print(f"sharded (c) ring {label} over {n} sp ranks {RING_SHAPE}: "
              f"{errs} (O tol {BF16_O_ATOL}, gradient tol {g_tol:.3e} = "
              f"{BF16_GRAD_RTOL} of max|grad| {top:.3e}); kernel launches "
              f"{k_launch}, plain run {p_launch}, gathered {g_launch}")
        for key, err in errs.items():
            tol = g_tol if "grad" in key else BF16_O_ATOL
            check(err <= tol, f"ring {label} {key}: {err} > {tol}")
        for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(k_launch.get(key, 0) > 0, f"ring {label}: no {key} launch")
        check(not p_launch, f"the plain ring launched kernels: {p_launch}")
        check(g_launch.get("ring_ag", 0) > 0 and g_launch.get("ring_rs", 0)
              > 0, f"gathered ring {label}: ring kernels {g_launch}")
        out[label] = {**errs, "grad_tol": g_tol, "kernel_launches": k_launch,
                      "gathered_launches": g_launch}
        del f32, ro, rg, ko, kg, po, pg, go, gg
        torch.cuda.empty_cache()
    return out


def _moe_flagship(torch, np, kernels, tr, MeshPlan, ShardedTrainer):
    """(d): moe_apply over dp against local routing at f32, then a MoE
    ShardedTrainer on dp2 x sp2 x tp2 at the flagship's width, two
    layers, three steps."""
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.optimizers import adam
    from kungfu_tpu_torch.parallel import moe_apply, moe_init
    from kungfu_tpu_torch.utils.tree import tree_map

    D, F, E = FLAGSHIP["d_model"], FLAGSHIP["d_ff"], MOE_EXPERTS
    params = tree_map(lambda t: t.cuda(), moe_init(
        torch.Generator().manual_seed(3), E, D, F, E))
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((MOE_TOKENS, D), generator=gen, device="cuda")
    y_loc, _ = moe_apply(params, x, None, E, capacity_factor=float(E))
    ep = 2
    stacked = {"gate": {"w": params["gate"]["w"].expand(ep, D, E).clone()},
               "w_in": params["w_in"].reshape(ep, E // ep, D, F),
               "w_out": params["w_out"].reshape(ep, E // ep, F, D)}
    with collective.rank_world([("dp", ep)]):
        y_ep, aux = moe_apply(stacked, x.reshape(ep, MOE_TOKENS // ep, D),
                              "dp", E, capacity_factor=float(E))
    y_ep = y_ep.reshape(MOE_TOKENS, D)
    ratio = ((y_ep - y_loc).abs() / (MOE_ATOL + MOE_RTOL * y_loc.abs())
             ).max().item()
    print(f"sharded (d) moe_apply over dp={ep} vs local, [{MOE_TOKENS}, {D}] "
          f"f32, {E} experts: worst |d| at {ratio:.3f} of {MOE_ATOL} + "
          f"{MOE_RTOL}|ref|; aux {aux.tolist()}")
    check(ratio <= 1.0, f"moe_apply EP differs from local by {ratio} of "
          "the tolerance")

    cfg = tr.TransformerConfig(**{**FLAGSHIP, "n_layers": 2,
                                  "max_seq": SHARDED_SEQ})
    trainer = ShardedTrainer(cfg, MeshPlan(dp=2, sp=2, tp=2), n_experts=E,
                             tx=adam(1e-3), devices=["cuda:0"] * 8)
    state = trainer.init(torch.Generator().manual_seed(4))
    batch = _sharded_batch(torch, np, cfg.vocab_size, seed=4)
    losses = []
    before = _counts(kernels)
    for _ in range(MOE_STEPS):
        state, loss = trainer.step(state, batch)
        losses.append(float(loss))
    after = _counts(kernels)
    launches = {key: after[key] - before[key] for key in after}
    print(f"sharded (d) MoE trainer dp2 sp2 tp2, {E} experts, 2 layers: "
          f"losses {losses}; launches {launches}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"MoE trainer loss did not fall: {losses}")
    return {"ep_tol_share": ratio, "losses": losses, "launches": launches}


#: phase 18 (a): the flagship (max_seq 1024) through HostPipeline over
#: four in-process Peers in two emulated slices of two: pp across the
#: slices, dp lanes within, ZeRO-2 with sgd(0.05, momentum=0.9), each dp
#: lane a [8, 1024] batch from seed 0 in four microbatches, and 30 ms of
#: chaos delay on every engine send (bench.py:2099 payload_pp's wire)
PIPE_PLAN = dict(pp=2, dp=2, n_micro=4, zero_stage=2)
PIPE_BATCH, PIPE_SEQ = 8, 1024
PIPE_LR, PIPE_MOMENTUM = 0.05, 0.9
PIPE_WIRE_MS = 30
#: steps of each schedule, each from the same start; interleaved with
#: two chunks a stage (two steps each before phase 25 needed the room;
#: the momentum's second use is held in (b), after the slice kill)
PIPE_STEPS = {"1f1b": 1, "sequential": 1, "interleaved": 1}
PIPE_INTERLEAVE = 2
#: the first loss against the one-rank flagship Transformer.loss on the
#: same rows, and the first loss and reduced gradient against the same
#: step through the kernels' plain versions: phase 17's limits.
#: Readings on an H100 (run 1 of the phase): the loss 0 and 2.3e-8 from
#: the one-rank model's, 5.7e-7 and 1.2e-6 from the plain versions'; the
#: gradient's worst leaf 1.8e-2 (a key weight), median 7.8e-3
PIPE_LOSS_RTOL = SHARDED_LOSS_RTOL
PIPE_GRAD_REL_L2 = SHARDED_GRAD_REL_L2
#: (b): slice 1 dies as step 2 begins (tests/test_pp.py:761's drill and
#: its peer deadline: detection read 12.01-12.02 s); one step at one
#: stage after the re-carve (two before phase 25 needed the room)
PIPE_KILL_STEP = 2
PIPE_DEADLINE_S = 12
PIPE_AFTER_STEPS = 1
#: (c): tensor parallelism within each stage at the flagship's widths
PIPE_TP_LAYERS = 4
PIPE_TP_PLAN = dict(pp=2, dp=1, tp=2, n_micro=4)


def _pipe_batches(np, vocab: int, lanes: int) -> list:
    """Each dp lane's ``[PIPE_BATCH, PIPE_SEQ]`` ids and targets from
    seed 0, as host int32 arrays."""
    rng = np.random.default_rng(0)
    return [tuple(rng.integers(0, vocab, size=(PIPE_BATCH, PIPE_SEQ))
                  .astype(np.int32) for _ in range(2))
            for _ in range(lanes)]


def _pipe_launches(pp, cfg, plan) -> dict:
    """Launches of rows 1-5 in one step, derived from the schedule: per
    lane and microbatch, every layer of a virtual stage before the last
    runs the flash forward twice (F, and its recompute in B), the last
    virtual stage's once (its F is fused into the loss gradient); every
    layer dQ and dK/dV once; the loss one xent launch each way."""
    v = plan.interleave if plan.pp_schedule == "interleaved" else 1
    lo, hi = pp.stage_partition(cfg.n_layers, plan.pp * v)[-1]
    L, m = cfg.n_layers, plan.n_micro
    lane = {"flash_fwd": m * (2 * (L - (hi - lo)) + (hi - lo)),
            "flash_bwd_dq": m * L, "flash_bwd_dkv": m * L,
            "xent_fwd": m, "xent_bwd": m}
    return {k: n * plan.dp for k, n in lane.items()}


def _close_peers(peers) -> None:
    for p in peers:
        try:
            p.close()
        except Exception:  # noqa: BLE001 - a dead peer closed itself
            pass


def _stage_trees(pipes) -> list:
    """Each rank's stage params (every chunk), global layout."""
    return [[pipe.mods[c].gather(pipe.params[c]) for c in range(pipe.v)]
            for pipe in pipes]


def _pipe_against(torch, pp, cfg, pipes, full, what: str) -> None:
    """Every rank's stage (every chunk) bitwise the slice of ``full``."""
    for pipe in pipes:
        part = pp.interleaved_partition(cfg.n_layers, pipe._S, pipe.v)
        for c in range(pipe.v):
            lo, hi = part[pipe.stage][c]
            vs = c * pipe._S + pipe.stage
            want = pp.slice_stage_params(cfg, full, lo, hi, vs == 0,
                                         vs == pipe._V - 1)
            same, n = _trees_bitwise(torch, pipe.mods[c].gather(
                pipe.params[c]), want)
            check(same == n, f"{what}: rank {pipe.rank} chunk {c}: "
                  f"{n - same} of {n} leaves differ")


def _timed(obj, name: str, acc: dict) -> None:
    """Accumulate the host seconds of ``obj.name(...)`` calls in
    ``acc[name]`` (the instance's method, wrapped in place)."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, wrapped)


def _pipe_breakdown(evs, accs, steps: int, step_ms: float) -> dict:
    """Each rank's host ms a step, averaged over the ranks: the ``pp``
    spans (``fwd`` and ``bwd`` enqueue their stage's math; ``bubble`` is
    the wait for a hop), the dp sync's issue (flatten and D2H of the
    stage gradient, the bucket sends) and finish (the peers' buckets,
    the sum, the update, the all-gather of the new chunk and the H2D),
    and the rest of the step (activation D2H, sends, the host's share
    of the stage math)."""
    out = {}
    for r, acc in enumerate(accs):
        parts = {n: sum(e["dur"] for e in evs if e.get("kind") == "pp"
                        and e.get("name") == n and e.get("rank") == r)
                 for n in ("fwd", "bwd", "bubble")}
        parts["dp_sync_begin"] = acc.get("_dp_sync_begin", 0.0)
        parts["dp_sync_finish"] = acc.get("_dp_sync_finish", 0.0)
        for k, v in parts.items():
            out[k] = out.get(k, 0.0) + 1e3 * v / steps / len(accs)
    out["other"] = step_ms - sum(out.values())
    return out


def phase_pipeline(torch, np, kernels, tr, spec):
    """Phase 18: the cross-host pipeline on the card; see the module
    docstring.  Returns the result; its ``launches`` are (a)'s main
    path: the timed steps of the three schedules."""
    from kungfu_tpu_torch.ops import xent

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the f32 products must not run as TF32")
    old = _set_env({"KF_TPU_XENT": "fused", "KF_TPU_ATTN": None,
                    "KF_NATIVE_ENGINE": "0",
                    "KF_TPU_HOST_TRANSPORT": "python",
                    "MEGASCALE_NUM_SLICES": "2", "KF_SLICE_RANKS": "2",
                    "MEGASCALE_SLICE_ID": None,
                    "KF_CONFIG_ENABLE_TRACE": "1",
                    "KF_CONFIG_PEER_DEADLINE": str(PIPE_DEADLINE_S),
                    "KF_CHAOS_SPEC": None})
    xent.XENT_ENV.reload()
    try:
        cfg = tr.TransformerConfig(**{**FLAGSHIP, "max_seq": PIPE_SEQ})
        gen = torch.Generator().manual_seed(0)
        tparams = tr.Transformer(cfg).init(gen, device="cuda")
        batches = _pipe_batches(np, cfg.vocab_size, PIPE_PLAN["dp"])
        out = {"a": _pipe_schedules(torch, np, kernels, tr, spec, cfg,
                                    tparams, batches)}
        torch.cuda.empty_cache()
        out["b"] = _pipe_slice_kill(torch, np, cfg, tparams, batches)
        del tparams
        torch.cuda.empty_cache()
        _set_env({"MEGASCALE_NUM_SLICES": None, "KF_SLICE_RANKS": None,
                  "KF_CONFIG_ENABLE_TRACE": None})
        out["c"] = _pipe_tp(torch, np, tr, batches)
    finally:
        _set_env(old)
        xent.XENT_ENV.reload()
    out["launches"] = out["a"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"pipeline phase: {out['phase_s']:.2f} s")
    return out


def _pipe_schedules(torch, np, kernels, tr, spec, cfg, tparams, batches):
    """(a): three schedules from the same start on one four-peer
    cluster, each bitwise its reference_pipeline_step on the card, with
    exact launches; the first step against the one-rank model and the
    plain versions."""
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.monitor import timeline, xray
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel import pp
    from kungfu_tpu_torch.parallel.train import ParallelPlan
    from kungfu_tpu_torch.peer import start_local_cluster

    full = pp.stacked_from_transformer(cfg, tparams)
    lanes = len(batches)
    tokens = lanes * PIPE_BATCH * PIPE_SEQ
    inner = lambda: sgd(PIPE_LR, momentum=PIPE_MOMENTUM)  # noqa: E731
    plans = {s: ParallelPlan(**PIPE_PLAN, pp_schedule=s, interleave=(
        PIPE_INTERLEAVE if s == "interleaved" else 1)) for s in PIPE_STEPS}
    old = _set_env({"KF_CHAOS_SPEC": f"delay:ms={PIPE_WIRE_MS},on=send"})
    chaos.reset()
    peers = start_local_cluster(4, env={"KF_ALLREDUCE_STRATEGY": "STAR"},
                                devices=["cuda"])
    out, finals, first_losses = {}, {}, {}
    launches = {k: 0 for k in _counts(kernels)}
    try:
        check(peers[0].slice_topology() is not None
              and peers[0].slice_topology().num_slices == 2,
              f"not two emulated slices: {peers[0].slice_topology()}")
        for sched, steps in PIPE_STEPS.items():
            plan = plans[sched]
            pipes = [pp.HostPipeline(p.engine(), plan, cfg, full_params=full,
                                     inner=inner(), peer=p, device="cuda")
                     for p in peers]
            t0 = time.perf_counter()
            for pipe in pipes:
                pipe.warmup(PIPE_BATCH, PIPE_SEQ)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            accs = [{} for _ in pipes]
            for pipe, acc in zip(pipes, accs):
                _timed(pipe, "_dp_sync_begin", acc)
                _timed(pipe, "_dp_sync_finish", acc)
            torch.cuda.reset_peak_memory_stats()
            cursor, _ = timeline.events_tail(0)
            _reset(kernels)
            walls, losses = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                outs = _run_ranks([lambda i=i: pipes[i].train_step(
                    *batches[i % lanes]) for i in range(len(pipes))],
                    timeout=300)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append([o for o in outs if o is not None])
            counts = _counts(kernels)
            _, evs = timeline.events_tail(cursor)
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = {k: n * steps for k, n in
                    _pipe_launches(pp, cfg, plan).items()}
            got = {k: counts[k] for k in want}
            print(f"pipeline (a) {sched}: launches {got}, expected {want}")
            check(got == want, f"(a) {sched}: launches {got} != {want}")
            check(all(counts[k] == 0 for k in counts if k not in want),
                  f"(a) {sched}: unexpected launches {counts}")
            for k, n in counts.items():
                launches[k] += n
            bubble = wall = 0.0
            for r in range(len(pipes)):
                split = xray.rank_phase_split(
                    [e for e in evs if e.get("rank") == r])
                bubble += split["pp_bubble"]
                wall += split["wall_s"]
            step_ms = 1e3 * statistics.median(walls)
            parts = _pipe_breakdown(evs, accs, steps,
                                    1e3 * sum(walls) / steps)
            out[sched] = {
                "step_ms": step_ms, "step_ms_all": [1e3 * w for w in walls],
                "rank_ms_per_step": parts,
                "tokens_per_s": tokens / (step_ms / 1e3),
                "pp_bubble_fraction": bubble / wall if wall else None,
                "peak_gib": peak, "warmup_s": warm_s, "losses": losses,
                "launches_per_step": _pipe_launches(pp, cfg, plan)}
            res = out[sched]
            print(f"pipeline (a) {sched}: step {step_ms:.1f} ms (median "
                  f"of {steps}: {[round(1e3 * w, 1) for w in walls]}), "
                  f"{res['tokens_per_s']:.0f} tokens/s over {lanes} lanes, "
                  f"pp_bubble {res['pp_bubble_fraction']:.3f} of the ranks' "
                  f"wall, peak {peak:.2f} GiB, losses {losses}; a rank's "
                  f"ms a step: { {k: round(v, 1) for k, v in parts.items()} }")
            for step_losses in losses:
                check(all(np.isfinite(step_losses)),
                      f"(a) {sched}: loss not finite: {losses}")
            first_losses[sched] = losses[0]
            finals[sched] = _stage_trees(pipes)
            # the reference step on the card for the same plan
            ref, states = full, None
            for _ in range(steps):
                ref, ref_losses, states = pp.reference_pipeline_step(
                    cfg, plan, ref, batches, inner(), opt_states=states,
                    device="cuda")
            _pipe_against(torch, pp, cfg, pipes, ref,
                          f"(a) {sched} against reference_pipeline_step")
            check(losses[-1] == ref_losses, f"(a) {sched}: losses "
                  f"{losses[-1]} != the reference step's {ref_losses}")
            del pipes, ref, states
            torch.cuda.empty_cache()
        differ = [r for r, (ra, rb) in enumerate(zip(
            finals["1f1b"], finals["sequential"])) for a, b in zip(ra, rb)
            if len(set(_trees_bitwise(torch, a, b))) != 1]
        print(f"pipeline (a): 1F1B and sequential params bitwise equal on "
              f"{len(finals['1f1b']) - len(differ)} of "
              f"{len(finals['1f1b'])} ranks")
        check(not differ, f"(a): 1F1B and sequential params differ on "
              f"ranks {differ}")
        check(first_losses["1f1b"] == first_losses["sequential"],
              f"(a): first losses differ: {first_losses}")
        out["ratio_1f1b_over_sequential"] = (out["1f1b"]["step_ms"]
                                             / out["sequential"]["step_ms"])
        print(f"pipeline (a): 1F1B over sequential step time "
              f"{out['ratio_1f1b_over_sequential']:.3f}")
    finally:
        _close_peers(peers)
        _set_env(old)
        chaos.reset()
    del finals
    torch.cuda.empty_cache()
    out.update(_pipe_first_step(torch, np, kernels, tr, attention, pp, cfg,
                                tparams, full, plans["1f1b"], batches,
                                first_losses["1f1b"]))
    out["launches"] = launches
    return out


def _per_layer(tr, stacked) -> dict:
    """A stacked tree as the one-rank model's flat ``layer_{i}/...``
    keys, one entry a layer's leaf."""
    out = {}
    for key, t in tr.flatten(stacked).items():
        if key.startswith("layers/"):
            for i in range(t.shape[0]):
                out[f"layer_{i}/{key[len('layers/'):]}"] = t[i]
        else:
            out[key] = t
    return out


def _pipe_first_step(torch, np, kernels, tr, attention, pp, cfg, tparams,
                     full, plan, batches, pipe_losses) -> dict:
    """(a)'s first step against the one-rank flagship loss on each lane's
    rows, and its loss and reduced gradient against the same step
    through the flash kernels' plain versions and ``KF_TPU_XENT=plain``
    (no launch)."""
    from kungfu_tpu_torch.ops import xent

    model = tr.Transformer(cfg)
    one_rank = []
    with torch.no_grad():
        for ids, tgt in batches:
            one_rank.append(float(model.loss(tparams, (
                torch.from_numpy(ids).cuda(), torch.from_numpy(tgt).cuda()),
                train=False)))
    rel = [abs(a - b) / abs(b) for a, b in zip(pipe_losses, one_rank)]
    print(f"pipeline (a): first losses {pipe_losses}, the one-rank model's "
          f"{one_rank}, relative {rel}")
    check(max(rel) <= PIPE_LOSS_RTOL,
          f"(a): first loss {rel} from the one-rank model's")
    grads, losses = pp.pipeline_gradients(cfg, plan, full, batches,
                                          device="cuda")
    check(losses == pipe_losses,
          f"(a): pipeline_gradients' losses {losses} != {pipe_losses}")
    flash = _PlainFlash(torch, attention)

    def plain_attn(q, k, v, causal):
        b, h, s, d = q.shape
        o, _ = flash(q.reshape(b * h, s, d), k.reshape(b * h, s, d),
                     v.reshape(b * h, s, d), causal)
        return o.reshape(b, h, s, d)

    real = pp.pick_attention
    pp.pick_attention = lambda: plain_attn
    os.environ["KF_TPU_XENT"] = "plain"
    xent.XENT_ENV.reload()
    before = _counts(kernels)
    try:
        pgrads, plosses = pp.pipeline_gradients(cfg, plan, full, batches,
                                                device="cuda")
        torch.cuda.synchronize()
    finally:
        pp.pick_attention = real
        os.environ["KF_TPU_XENT"] = "fused"
        xent.XENT_ENV.reload()
    after = _counts(kernels)
    check(after == before, f"(a)'s plain step launched kernels: "
          f"{ {k: after[k] - before[k] for k in after} }")
    lrel = [abs(a - b) / abs(b) for a, b in zip(losses, plosses)]
    errs = _rel_l2_leaves(_per_layer(tr, grads), _per_layer(tr, pgrads))
    worst = max(errs, key=errs.get)
    print(f"pipeline (a): first loss against the plain versions' {lrel}; "
          f"reduced gradient relative L2 per leaf: worst {worst} "
          f"{errs[worst]:.3e}, median {statistics.median(errs.values()):.3e}")
    check(max(lrel) <= PIPE_LOSS_RTOL, f"(a): loss {lrel} from the plain's")
    check(errs[worst] <= PIPE_GRAD_REL_L2,
          f"(a): gradient {worst} {errs[worst]:.3e} from the plain's")
    return {"one_rank_losses": one_rank, "one_rank_loss_rel": rel,
            "plain_loss_rel": lrel, "plain_grad_rel_l2_worst":
            [worst, errs[worst]],
            "plain_grad_rel_l2_median": statistics.median(errs.values())}


def _pipe_slice_kill(torch, np, cfg, tparams, batches) -> dict:
    """(b): two steps, the boundary and snapshot committed and mirrored,
    slice 1 killed as step 2 begins; the survivors recover through
    ``Peer.recover_from_failure(stage_boundary=...)`` to one stage on
    dp 2 and take two steps, bitwise a fixed one-stage world replayed
    from the same boundary."""
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.faults import PeerFailureError
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.optimizers._transform import TraceState
    from kungfu_tpu_torch.parallel import pp
    from kungfu_tpu_torch.parallel.train import ParallelPlan
    from kungfu_tpu_torch.peer import start_local_cluster

    full = pp.stacked_from_transformer(cfg, tparams)
    plan = ParallelPlan(**PIPE_PLAN)
    inner = lambda: sgd(PIPE_LR, momentum=PIPE_MOMENTUM)  # noqa: E731
    lanes = len(batches)
    old = _set_env({"KF_CHAOS_SPEC": (
        f"delay:ms={PIPE_WIRE_MS},on=send;die_slice:slice=1,"
        f"step={PIPE_KILL_STEP},mode=raise,rps=2")})
    chaos.reset()
    peers = start_local_cluster(4, env={"KF_ALLREDUCE_STRATEGY": "STAR"},
                                devices=["cuda"])

    def worker(i):
        pipe = pp.HostPipeline(peers[i].engine(), plan, cfg, full_params=full,
                               inner=inner(), peer=peers[i], device="cuda")
        sb, snap = pp.StageBoundary(), StepSnapshot()
        ids, tgt = batches[i % lanes]
        pipe.warmup(PIPE_BATCH, PIPE_SEQ)
        torch.cuda.synchronize()
        res = {"walls_pp2": [], "walls_pp1": []}
        try:
            for s in range(PIPE_KILL_STEP):
                chaos.note_step(peers[i].chaos_rank(), s)
                t0 = time.perf_counter()
                pipe.train_step(ids, tgt)
                torch.cuda.synchronize()
                res["walls_pp2"].append(time.perf_counter() - t0)
            pipe.commit_boundary(sb)
            res["mirror_bytes"] = sb.replicate_ring(
                peers[i].channel, peers[i].cluster.workers,
                tag=f"b{PIPE_KILL_STEP}")
            snap.commit(PIPE_KILL_STEP, {"anchor": np.int64(PIPE_KILL_STEP)})
            chaos.note_step(peers[i].chaos_rank(), PIPE_KILL_STEP)
            pipe.train_step(ids, tgt)
            res["status"] = "no-death"
        except chaos.InjectedDeath:
            res["t_kill"] = time.perf_counter()
            peers[i].close()
            res["status"] = "died"
        except PeerFailureError as err:
            res["t_detect"] = time.perf_counter()
            res["suspect"] = err.rank
            t0 = time.perf_counter()
            shrunk, replay = peers[i].recover_from_failure(
                err, snapshot=snap, stage_boundary=sb)
            res["recover_s"] = time.perf_counter() - t0
            res["shrunk"], res["replay_step"] = shrunk, (
                replay[0] if replay else None)
            res["recarve"] = dict(sb.last_recarve)
            pipe2 = pp.HostPipeline.from_boundary(
                peers[i].engine(), plan.with_stages(1), cfg, sb,
                inner=inner(), peer=peers[i], device="cuda")
            res["layers"] = pipe2.stage_layers()
            pipe2.warmup(PIPE_BATCH, PIPE_SEQ)
            for _ in range(PIPE_AFTER_STEPS):
                t0 = time.perf_counter()
                pipe2.train_step(ids, tgt)
                torch.cuda.synchronize()
                res["walls_pp1"].append(time.perf_counter() - t0)
            res["params"] = pipe2.mods[0].gather(pipe2.params[0])
            res["status"] = "recovered"
        return res

    try:
        res = _run_ranks([lambda i=i: worker(i) for i in range(4)],
                         timeout=400)
    finally:
        _close_peers(peers[:2])
        _set_env(old)
        chaos.reset()
    status = [r["status"] for r in res]
    print(f"pipeline (b): {status}")
    check(status == ["recovered", "recovered", "died", "died"],
          f"(b): {status}")
    t_kill = min(r["t_kill"] for r in res[2:])
    for i in (0, 1):
        r = res[i]
        check(r["shrunk"] and r["replay_step"] == PIPE_KILL_STEP,
              f"(b) rank {i}: shrunk {r['shrunk']} replay {r['replay_step']}")
        check(r["layers"] == (0, cfg.n_layers), f"(b): layers {r['layers']}")
        check(r["recarve"]["sent_param_bytes"] == 0,
              f"(b) rank {i}: the dead stage's params crossed the wire: "
              f"{r['recarve']}")
    full1, states1 = full, None
    for _ in range(PIPE_KILL_STEP):
        full1, _, states1 = pp.reference_pipeline_step(
            cfg, plan, full1, batches, inner(), opt_states=states1,
            device="cuda")
    state = [TraceState(pp.merge_stage_trees(
        cfg, 2, 1, [states1[0].trace, states1[1].trace]))]
    plan1 = plan.with_stages(1)
    for _ in range(PIPE_AFTER_STEPS):
        full1, _, state = pp.reference_pipeline_step(
            cfg, plan1, full1, batches, inner(), opt_states=state,
            device="cuda")
    want = pp.slice_stage_params(cfg, full1, 0, cfg.n_layers, True, True)
    for i in (0, 1):
        same, n = _trees_bitwise(torch, res[i]["params"], want)
        print(f"pipeline (b) rank {i}: {same}/{n} leaves bitwise the "
              "fixed one-stage world")
        check(same == n, f"(b) rank {i}: {n - same} leaves differ from the "
              "fixed-world replay")
    pp2 = [max(res[i]["walls_pp2"][s] for i in range(4))
           for s in range(PIPE_KILL_STEP)]
    pp1 = [max(res[i]["walls_pp1"][s] for i in (0, 1))
           for s in range(PIPE_AFTER_STEPS)]
    out = {
        "detect_s": [res[i]["t_detect"] - t_kill for i in (0, 1)],
        "suspects": [res[i]["suspect"] for i in (0, 1)],
        "recover_s": [res[i]["recover_s"] for i in (0, 1)],
        "recarve": [res[i]["recarve"] for i in (0, 1)],
        "mirror_bytes": [r.get("mirror_bytes") for r in res],
        "step_ms_pp2": [1e3 * w for w in pp2],
        "step_ms_pp1": [1e3 * w for w in pp1]}
    print(f"pipeline (b): kill -> PeerFailureError {out['detect_s']} s "
          f"(peer deadline {PIPE_DEADLINE_S} s), recover_from_failure "
          f"{out['recover_s']} s, re-carve {out['recarve']}, mirror "
          f"blobs {out['mirror_bytes']} B, step ms at pp 2 "
          f"{out['step_ms_pp2']} and at pp 1 {out['step_ms_pp1']}")
    return out


def _pipe_tp(torch, np, tr, batches) -> dict:
    """(c): pp 2 x tp 2 at the flagship's widths, four layers, one step,
    bitwise reference_pipeline_step with the same plan."""
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel import pp
    from kungfu_tpu_torch.parallel.train import ParallelPlan
    from kungfu_tpu_torch.peer import start_local_cluster

    cfg = tr.TransformerConfig(**{**FLAGSHIP, "max_seq": PIPE_SEQ,
                                  "n_layers": PIPE_TP_LAYERS})
    full = pp.init_stacked_params(cfg, torch.Generator().manual_seed(1),
                                  device="cuda")
    plan = ParallelPlan(**PIPE_TP_PLAN)
    inner = lambda: sgd(PIPE_LR, momentum=PIPE_MOMENTUM)  # noqa: E731
    peers = start_local_cluster(2, env={"KF_ALLREDUCE_STRATEGY": "STAR"},
                                devices=["cuda"])
    try:
        pipes = [pp.HostPipeline(p.engine(), plan, cfg, full_params=full,
                                 inner=inner(), peer=p, device="cuda")
                 for p in peers]
        for pipe in pipes:
            pipe.warmup(PIPE_BATCH, PIPE_SEQ)
        t0 = time.perf_counter()
        outs = _run_ranks([lambda i=i: pipes[i].train_step(*batches[0])
                           for i in range(2)], timeout=300)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        _close_peers(peers)
    ref, losses, _ = pp.reference_pipeline_step(
        cfg, plan, full, batches[:1], inner(), device="cuda")
    _pipe_against(torch, pp, cfg, pipes, ref, "(c) tp 2")
    check(outs[1] == losses[0], f"(c): loss {outs[1]} != {losses[0]}")
    print(f"pipeline (c): pp 2 x tp 2, {PIPE_TP_LAYERS} layers: loss "
          f"{outs[1]:.6f}, bitwise reference_pipeline_step, step "
          f"{step_ms:.1f} ms")
    return {"loss": outs[1], "step_ms": step_ms}


WGMMA_KERNELS = ("flash_fwd_bf16_wgmma_kernel",
                 "flash_bwd_dq_bf16_wgmma_kernel",
                 "flash_bwd_dkv_bf16_wgmma_kernel",
                 "lm_head_fwd_wgmma_kernel",
                 "lm_head_bwd_dh_wgmma_kernel",
                 "lm_head_bwd_dw_wgmma_kernel")
#: their instantiations: the flash kernels at D 32/64/96/128/256; the LM
#: head's forward, dh and dW, each for f32 and bf16 W
WGMMA_INSTANTIATIONS = 3 * 5 + 3 * 2


def _resnet_macs(model, hw: int) -> int:
    """Multiply-adds of one image through ``model``'s forward at
    ``hw`` x ``hw``, counted from its conv and dense shapes (SAME convs:
    ``ceil(H / s)`` outputs).  The stem counts as the 7x7/s2 conv it
    computes (the s2d form's zero taps are not counted)."""
    w, h = model.width, -(-hw // 2)
    macs = h * h * 49 * 3 * w
    h = -(-h // 2)                                  # the 3x3/s2 max pool
    in_ch = w
    for s, nblocks in enumerate(model.blocks_per_stage):
        mid = w * 2 ** s
        out = mid * 4
        for b in range(nblocks):
            ho = -(-h // (2 if (b == 0 and s > 0) else 1))
            macs += h * h * in_ch * mid + ho * ho * (9 * mid * mid + mid * out)
            if b == 0:
                macs += ho * ho * in_ch * out
            h, in_ch = ho, out
    return macs + in_ch * model.num_classes


def _vgg_macs(model, hw: int) -> int:
    """Multiply-adds of one image through a VGG forward (3x3 SAME convs,
    2x2 pools, the GAP head)."""
    macs, h, in_ch = 0, hw, 3
    for c in model.cfg:
        if c == "M":
            h //= 2
            continue
        macs += h * h * 9 * in_ch * c
        in_ch = c
    return macs + in_ch * model.hidden + model.hidden * model.num_classes


def _image_batch(torch, np, rng, n: int, hw: int, classes: int):
    """``n`` standard-normal NHWC images as bf16 on the card (as bench.py's
    payload_resnet draws them) and int64 labels."""
    images = torch.from_numpy(rng.standard_normal(
        (n, hw, hw, 3), dtype=np.float32)).to("cuda", torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, classes, size=(n,))).cuda()
    return images, labels


def _event_steps(torch, step, carry, batch, steps: int, losses: list):
    """``steps`` steps of ``step(p, s, o, batch)`` timed by CUDA events
    (ms each) and on the host clock; returns the device ms, host ms and
    the memory of those steps: the card's peak allocation, what was held
    when they began (params, optimizer state, the batch and what earlier
    phases keep) and the steps' own peak above that."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dev, host = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        *carry[:], loss = step(*carry, batch)
        b.record()
        losses.append(float(loss))  # synchronises
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    return dev, host, {"peak_gib": peak / 2 ** 30, "held_gib": held / 2 ** 30,
                       "step_peak_gib": (peak - held) / 2 ** 30}


def _mem_text(mem: dict) -> str:
    return (f"peak {mem['peak_gib']:.2f} GiB ({mem['step_peak_gib']:.2f} "
            f"above the {mem['held_gib']:.2f} held when the steps began)")


def _activation_copies(torch, step, carry, batch, n: int) -> dict:
    """One step under the profiler with shapes: its kernels, cuDNN's
    layout-transform kernels, and the ``aten::clone`` calls whose input is
    a 4-D activation (batch ``n`` first, both other spatial axes >= 7).
    A clone under ``aten::constant_pad_nd`` is the backward of an
    asymmetric SAME pad (a negative pad is a narrow and a clone: one per
    pad, the stem's max pool and the three 3x3/s2 convs); any other is
    an NHWC <-> NCHW copy that a conv on permuted views must not make."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        *carry[:], loss = step(*carry, batch)
        torch.cuda.synchronize()

    def under_pad(evt):
        while evt is not None:
            if evt.name == "aten::constant_pad_nd":
                return True
            evt = evt.cpu_parent
        return False

    kernels, transforms, pads, clones, shapes = 0, 0, 0, 0, []
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels += 1
            low = evt.name.lower()
            transforms += ("nchwtonhwc" in low or "nhwctonchw" in low)
        elif evt.name == "aten::clone" and evt.input_shapes:
            shp = list(evt.input_shapes[0])
            if len(shp) == 4 and shp[0] == n and min(shp[2], shp[3]) >= 7:
                if under_pad(evt.cpu_parent):
                    pads += 1
                else:
                    clones += 1
                    shapes.append(shp)
    return {"kernels_per_step": kernels, "layout_transform_kernels":
            transforms, "pad_backward_clones": pads,
            "activation_clones": clones,
            "activation_clone_shapes": shapes[:8], "loss": float(loss)}


def phase_images(torch, np, kernels, spec) -> dict:
    """Phase 19: ResNet-50 S-SGD (bench.py:165 payload_resnet) on one and
    on four co-resident ranks, the card's f32 path against the CPU's,
    the data plane, and VGG-16; see the module docstring."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.models.resnet import ResNet
    from kungfu_tpu_torch.models.vgg import VGG
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step

    t_phase = time.perf_counter()
    out = {}
    model = ResNet(50, num_classes=IMG_CLASSES)
    rng = np.random.default_rng(0)
    params, state = model.init(torch.Generator().manual_seed(0),
                               device="cuda")
    init_cpu = tuple(_to_cpu(torch, t) for t in (params, state))
    step_flops = 3 * 2 * _resnet_macs(model, IMG_HW)

    def loss_fn(p, s, b):
        return model.loss(p, s, b, train=True)

    # (a) one rank: payload_resnet's step
    comm = Communicator(devices=["cuda:0"])
    tx = synchronous_sgd(sgd(IMG_LR, momentum=0.9), comm.axis)
    step = dp_train_step(loss_fn, tx, comm, has_aux=True)
    batch = _image_batch(torch, np, rng, IMG_BATCH, IMG_HW, IMG_CLASSES)
    carry = [params, state, tx.init(params)]
    losses = []
    t0 = time.perf_counter()
    for _ in range(IMG_WARMUP):
        *carry[:], loss = step(*carry, batch)
        losses.append(float(loss))
    warm_s = time.perf_counter() - t0
    dev, host, mem = _event_steps(torch, step, carry, batch, IMG_STEPS,
                                  losses)
    prof = _activation_copies(torch, step, carry, batch, IMG_BATCH)
    losses.append(prof["loss"])
    step_ms = statistics.median(dev)
    ips = IMG_BATCH / (step_ms / 1e3)
    tflops = step_flops * IMG_BATCH / (step_ms / 1e3) / 1e12
    check(all(math.isfinite(x) for x in losses), f"ResNet-50 losses {losses}")
    check(losses[-1] < losses[0],
          f"ResNet-50 loss did not fall over {len(losses)} steps: {losses}")
    check(prof["activation_clones"] == 0,
          f"the step copies activations: {prof['activation_clone_shapes']}")
    check(prof["pad_backward_clones"] == 4, f"{prof['pad_backward_clones']} "
          "pad-backward copies, expected the 4 asymmetric pads'")
    out["one_rank"] = {
        "images_s": ips, "step_ms": step_ms, "step_ms_all": dev,
        "host_ms_all": host, "warmup_s": warm_s, **mem,
        "train_flops_per_image": step_flops, "tflops": tflops,
        "bf16_peak_share": tflops * 1e12 / spec["bf16_flops"],
        "losses": losses, **prof}
    print(f"images (a) ResNet-50 one rank, batch {IMG_BATCH} at {IMG_HW}, "
          f"bf16: {step_ms:.2f} ms/step (CUDA events, median of "
          f"{IMG_STEPS}; host {statistics.median(host):.2f}), {ips:.1f} "
          f"images/s, {tflops:.1f} TFLOP/s of {step_flops / 1e9:.2f} "
          f"GFLOP an image a step ({tflops * 1e12 / spec['bf16_flops']:.3f} "
          f"of the bf16 peak), {_mem_text(mem)}, "
          f"{prof['kernels_per_step']} kernels a step, "
          f"{prof['layout_transform_kernels']} cuDNN layout transforms, "
          f"{prof['activation_clones']} activation copies (and "
          f"{prof['pad_backward_clones']} pad-backward copies); losses "
          f"{[round(x, 4) for x in losses]}")
    del batch

    # (b) four co-resident ranks under pallas_ring
    out["four_ranks"], launches = _images_four_ranks(
        torch, np, kernels, model, loss_fn, init_cpu, rng)

    # (c) the card's f32 path against the CPU's
    out["f32_vs_cpu"] = _images_f32_vs_cpu(torch, np, model, init_cpu, rng)
    del init_cpu

    # (d) the data plane, from (a)'s params on
    out["data"] = _images_data_plane(torch, np, step, carry, mnist_slp)
    del carry, params, state
    torch.cuda.empty_cache()

    # (e) VGG-16 (BN), one rank
    out["vgg16"] = _images_vgg(torch, np, VGG, spec, rng)
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    print(f"images phase: {out['phase_s']:.2f} s")
    return out


def _to_cpu(torch, tree):
    from kungfu_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _images_four_ranks(torch, np, kernels, model, loss_fn, init_cpu, rng):
    """(b): the step on four co-resident ranks of the card, each its own
    64 images, ``schedule="pallas_ring"``: one ring reduce-scatter and one
    all-gather per gradient leaf; the reduced gradient bitwise the ring's
    plain version on the same per-rank gradients, the aux the mean of the
    ranks' rows, the params replicated."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.ops.collectives import ring_all_reduce
    from kungfu_tpu_torch.optimizers import (GradientTransformation, sgd,
                                             synchronous_sgd)
    from kungfu_tpu_torch.parallel.train import dp_train_step
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    inner = sgd(IMG_LR, momentum=0.9)
    # the first step keeps its stacked and reduced gradients and the
    # ranks' new BN state
    seen, marks, rows, first = {}, [], [], [True]

    def inner_update(g, s, p=None):
        marks[-1][1].record()          # the reduce ends here
        if first[0]:
            seen["reduced"] = tree_map(lambda t: t.clone(), g)
        return inner.update(g, s, p)

    sync = synchronous_sgd(GradientTransformation(inner.init, inner_update),
                           comm.axis, schedule="pallas_ring")

    def update(g, s, p=None):
        marks.append((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
        marks[-1][0].record()          # the per-rank gradients are done
        if first[0]:
            seen["stacked"] = tree_map(lambda t: t.clone(), g)
        return sync.update(g, s, p)

    def loss4(p, s, b):
        loss, new = loss_fn(p, s, b)
        if first[0]:
            rows.append(tree_map(lambda t: t.detach().clone(), new))
        return loss, new

    tx = GradientTransformation(sync.init, update)
    step = dp_train_step(loss4, tx, comm, has_aux=True)
    params, state = (tree_map(lambda t: t.cuda(), x) for x in init_cpu)
    carry = [params, state, tx.init(params)]
    batch = _image_batch(torch, np, rng, RANKS * IMG_BATCH, IMG_HW,
                         IMG_CLASSES)
    n_leaves = len(tree_leaves(params))
    check(n_leaves == RESNET_LEAVES, f"ResNet-50 has {n_leaves} leaves")

    _reset(kernels)
    collective.CHECK_REPLICAS = True
    try:
        *carry[:], loss = step(*carry, batch)
        torch.cuda.synchronize()
    finally:
        collective.CHECK_REPLICAS = False
        first[0] = False
    per_step = _counts(kernels)
    want = {key: 0 for key in per_step}
    want.update(ring_rs=RESNET_LEAVES, ring_ag=RESNET_LEAVES)
    check(per_step == want, f"one four-rank ResNet-50 step launched "
          f"{per_step}, expected {want}")
    losses = [float(loss)]

    # the same stacked gradients reduced again through the plain ring
    with comm.world():
        plain = collective.replicated(tree_map(
            lambda a: ring_all_reduce(a, "kf_local", impl="lax") / RANKS,
            seen.pop("stacked")))
    same = [torch.equal(a, b) for a, b in zip(tree_leaves(seen["reduced"]),
                                              tree_leaves(plain))]
    check(all(same), f"{same.count(False)} reduced gradient leaves differ "
          "from the plain ring's")
    del plain, seen["reduced"]
    # the aux: the mean of the four ranks' new BN state
    mean = tree_map(lambda *r: torch.stack(r).sum(0) / RANKS, *rows)
    aux_rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                  for a, b in zip(tree_leaves(carry[1]), tree_leaves(mean)))
    check(aux_rel <= 1e-6, f"the BN aux is not the ranks' mean: {aux_rel}")
    del rows[:], mean

    _reset(kernels)
    marks.clear()
    dev, host, mem = _event_steps(torch, step, carry, batch,
                                  IMG_RANK_STEPS, losses)
    timed = _counts(kernels)
    want_t = {key: v * IMG_RANK_STEPS for key, v in want.items()}
    check(timed == want_t, f"{IMG_RANK_STEPS} four-rank steps launched "
          f"{timed}, expected {want_t}")
    launches = {key: per_step[key] + timed[key] for key in per_step}
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"four-rank losses did not fall: {losses}")
    ring_ms = [a.elapsed_time(b) for a, b in marks]
    step_ms = statistics.median(dev)
    ips = RANKS * IMG_BATCH / (step_ms / 1e3)
    ring_kernel_ms = _ring_kernel_ms(torch, step, carry, batch)
    res = {"images_s_per_card": ips, "step_ms": step_ms, "step_ms_all": dev,
           "host_ms_all": host, **mem, "losses": losses,
           "per_step_launches": per_step,
           "reduce_ms": statistics.median(ring_ms),
           "reduce_share": statistics.median(ring_ms) / step_ms,
           "ring_kernel_ms": ring_kernel_ms,
           "ring_kernel_share": ring_kernel_ms / step_ms,
           "aux_rel": aux_rel}
    print(f"images (b) ResNet-50 on {RANKS} co-resident ranks, {IMG_BATCH} "
          f"images each, pallas_ring: {step_ms:.2f} ms/step, {ips:.1f} "
          f"images/s on the card, reduce (pad, {RESNET_LEAVES} ring "
          f"reduce-scatters and all-gathers, mean) "
          f"{res['reduce_ms']:.2f} ms = {res['reduce_share']:.3f} of the "
          f"step, ring kernels alone {ring_kernel_ms:.3f} ms = "
          f"{res['ring_kernel_share']:.4f}; launches a step {per_step}; "
          f"reduced gradient bitwise the plain ring's; aux rel "
          f"{aux_rel:.1e}; {_mem_text(mem)}; losses "
          f"{[round(x, 4) for x in losses]}")
    del carry, batch
    torch.cuda.empty_cache()
    return res, launches


def _ring_kernel_ms(torch, step, carry, batch) -> float:
    """Device ms of the ring kernels in one step (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        *carry[:], _ = step(*carry, batch)
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if getattr(e, "device_type", None)
             == torch.autograd.DeviceType.CUDA and "ring_" in e.name)
    return us / 1e3


def _images_f32_vs_cpu(torch, np, model, init_cpu, rng) -> dict:
    """(c): the same params and 8 images in f32 on the card (TF32 off)
    and on the CPU: eval logits, the training loss, the new BN state and
    the first gradients per leaf, and one block's gradients; then sync-BN
    over four lockstep ranks against one BN on the concatenated batch."""
    from kungfu_tpu_torch.models import nn
    from kungfu_tpu_torch.models.resnet import bottleneck
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.parallel.train import per_rank_grads
    from kungfu_tpu_torch.utils.tree import (tree_flatten_with_path,
                                             tree_leaves, tree_map)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    x = torch.from_numpy(rng.standard_normal((IMG_F32_BATCH, IMG_HW, IMG_HW,
                                              3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, IMG_CLASSES, size=(IMG_F32_BATCH,)))

    def run(dev, trees=init_cpu):
        p, s = (tree_map(lambda t: t.to(dev), a) for a in trees)
        b = (x.to(dev), y.to(dev))
        with torch.no_grad():
            logits, _ = model.apply(p, s, b[0], train=False,
                                    dtype=torch.float32)
        grads = []
        outs, _ = per_rank_grads(
            lambda pp, bb: model.loss(pp, s, bb, dtype=torch.float32), p,
            [b], lambda r, g: grads.extend(g))
        loss, new_state = outs[0]
        return {"logits": logits.cpu(), "loss": loss.cpu(),
                "state": _to_cpu(torch, new_state),
                "grads": [g.cpu() for g in grads]}

    t0 = time.perf_counter()
    card = run("cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = run("cpu")
    t_cpu = time.perf_counter() - t0
    # the conditioning: the card again on params moved by 6e-8 relative
    # (one f32 ulp's order), whose gradients move by a few percent at
    # init (train-mode batch norm through 53 layers)
    g = torch.Generator().manual_seed(1)
    moved = tuple(tree_map(lambda t: t * (1 + 6e-8 * torch.randn(
        t.shape, generator=g)), a) if i == 0 else a
        for i, a in enumerate(init_cpu))
    nudged = run("cuda", moved)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    paths = ["/".join(p) for p, _ in tree_flatten_with_path(init_cpu[0])[0]]
    # relative L2 per leaf, the denominator floored at 1e-3 of the
    # largest leaf's norm (phase 6's convention): a batch-norm scale or
    # bias gradient sums terms that cancel (the next batch norm removes
    # each channel's mean), so where it is small both paths return
    # mostly rounding
    floor = 1e-3 * max(float(b.norm()) for b in host["grads"])

    def floored(got, want):
        return {path: float((a - b).norm()) / max(float(b.norm()), floor)
                for path, a, b in zip(paths, got, want)}

    g_rel = floored(card["grads"], host["grads"])
    g_self = floored(nudged["grads"], card["grads"])
    # each leaf is held within the larger of IMG_F32_REL_L2 and four times
    # the card's own spread under that nudge on that leaf
    tol = {k: max(IMG_F32_REL_L2, IMG_F32_COND * g_self[k]) for k in paths}
    share = {k: g_rel[k] / tol[k] for k in paths}
    worst = max(share, key=share.get)
    at_floor = [k for k in paths if tol[k] == IMG_F32_REL_L2]
    # (median rel, median tol) of the weights (conv, head) and of the
    # batch-norm scales and biases
    kinds = {kind: [k for k in paths if (k.rsplit("/", 1)[1] in ("w", "b"))
                    == (kind == "weights")] for kind in ("weights", "bn")}
    by_kind = {kind: (statistics.median(g_rel[k] for k in ks),
                      statistics.median(tol[k] for k in ks))
               for kind, ks in kinds.items()}
    raw = {path: rel(a, b) for path, a, b in zip(paths, card["grads"],
                                                 host["grads"])}
    s_rel = max(rel(a, b) for a, b in zip(tree_leaves(card["state"]),
                                          tree_leaves(host["state"])))
    raw_worst = sorted(raw, key=raw.get, reverse=True)[:5]
    res = {"logits_rel": rel(card["logits"], host["logits"]),
           "loss_rel": rel(card["loss"], host["loss"]),
           "state_rel_worst": s_rel, "grad_worst_leaf": worst,
           "grad_rel_worst": g_rel[worst], "grad_tol_worst": tol[worst],
           "grad_tol_share_worst": share[worst],
           "grad_rel_median": statistics.median(g_rel.values()),
           "grad_tol_max": max(tol.values()), "grad_by_kind": by_kind,
           "grad_leaves_at_floor": len(at_floor),
           "grad_rel_worst_at_floor": max((g_rel[k] for k in at_floor),
                                          default=0.0),
           "grad_unfloored_worst": [(k, raw[k], float(
               host["grads"][paths.index(k)].norm())) for k in raw_worst],
           "grad_floor": floor, "card_s": t_card, "cpu_s": t_cpu}
    print(f"images (c) unfloored worst gradient leaves (rel, |g|): "
          f"{res['grad_unfloored_worst']}, floor {floor:.3e}")
    for key in ("logits_rel", "loss_rel", "state_rel_worst"):
        check(res[key] <= IMG_F32_REL_L2, f"f32 card vs CPU {key} "
              f"{res[key]}")
    check(share[worst] <= 1.0, f"f32 card vs CPU gradient {g_rel[worst]} "
          f"at {worst}, beyond its {tol[worst]}")

    # one full-width block in train mode (s1b0: the 3x3/s2 and the
    # projection, batch norm over 8 x 28 x 28 samples a channel) is well
    # conditioned: its gradients hold IMG_F32_REL_L2 per leaf, unfloored
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (IMG_F32_BATCH, IMG_HW // 4, IMG_HW // 4, 4 * model.width),
        dtype=np.float32))

    def block_grads(dev):
        blk = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                       init_cpu[0]["s1b0"])
        bst = tree_map(lambda t: t.to(dev), init_cpu[1]["s1b0"])
        y, _ = bottleneck(blk, bst, h.to(dev), stride=2, train=True,
                          dtype=torch.float32)
        return [g.cpu() for g in torch.autograd.grad(y.sin().sum(),
                                                     tree_leaves(blk))]

    b_rel = [rel(a, b) for a, b in zip(block_grads("cuda"),
                                       block_grads("cpu"))]
    res["block_grad_rel_worst"] = max(b_rel)
    check(max(b_rel) <= IMG_F32_REL_L2, f"f32 card vs CPU s1b0 block "
          f"gradient {max(b_rel)}, beyond {IMG_F32_REL_L2}")

    # sync-BN over four lockstep ranks against one BN on the whole batch
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = torch.randn((RANKS, 16, 56, 56, 64), generator=gen, device="cuda")
    p = {"scale": torch.rand(64, generator=gen, device="cuda") + 0.5,
         "bias": torch.randn(64, generator=gen, device="cuda")}
    st = nn.batchnorm_state_init(64)
    st = tree_map(lambda t: t.cuda(), st)
    with collective.rank_world([("dp", RANKS)]):
        ys, ss = nn.batchnorm_apply(p, st, xs, True, axis_name="dp")
    yw, sw = nn.batchnorm_apply(p, st, xs.reshape(-1, 56, 56, 64), True)
    ok = torch.allclose(ys.reshape(yw.shape), yw, rtol=2e-5, atol=2e-5)
    for k in ("mean", "var"):
        ok = ok and all(torch.allclose(ss[k][r], sw[k], rtol=2e-5, atol=2e-5)
                        for r in range(RANKS))
    check(ok, "sync-BN over four ranks != one BN on the concatenated batch")
    res["sync_bn_max_abs"] = float((ys.reshape(yw.shape) - yw).abs().max())
    print(f"images (c) f32, TF32 off, {IMG_F32_BATCH} images at {IMG_HW}: "
          f"card vs CPU relative L2 logits {res['logits_rel']:.2e}, loss "
          f"{res['loss_rel']:.2e}, BN state {s_rel:.2e}; gradients "
          f"(floored) median {res['grad_rel_median']:.2e}, closest to its "
          f"tolerance {worst} {g_rel[worst]:.2e} of {tol[worst]:.2e} (each "
          f"leaf's: {IMG_F32_COND:g}x the card's own spread under a 6e-8 "
          f"nudge of the params, at least {IMG_F32_REL_L2:g}; the largest "
          f"{res['grad_tol_max']:.2e}; median rel and tol: conv and head "
          f"weights {by_kind['weights'][0]:.2e}, {by_kind['weights'][1]:.2e}"
          f", batch norm {by_kind['bn'][0]:.2e}, {by_kind['bn'][1]:.2e}), "
          f"{len(at_floor)} of {len(paths)} "
          f"leaves at {IMG_F32_REL_L2:g}, worst of them "
          f"{res['grad_rel_worst_at_floor']:.2e}; s1b0 block gradients "
          f"worst {max(b_rel):.2e} (tol {IMG_F32_REL_L2:g}); card "
          f"{t_card:.1f} s, CPU {t_cpu:.1f} s; sync-BN over {RANKS} ranks = "
          f"one BN on the batch (max |d| {res['sync_bn_max_abs']:.1e}, "
          f"rtol 2e-5)")
    return res


def _images_data_plane(torch, np, step, carry, mnist_slp) -> dict:
    """(d): ImageNetFolder's synthetic fallback at 224, rank 0 of 4,
    through prefetch_to_device into three of (a)'s steps, the input stall
    per step from the ``input`` span; then the SLP under S-SGD over four
    co-resident ranks on synthetic_mnist, each rank an ElasticDataset
    shard, through prefetch_to_device."""
    import shutil
    import tempfile

    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.datasets import (ElasticDataset, ImageNetFolder,
                                           prefetch_to_device,
                                           synthetic_mnist)
    from kungfu_tpu_torch.monitor import timeline
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step

    saved = _set_env({"KF_CONFIG_ENABLE_TRACE": "1"})
    root = tempfile.mkdtemp(prefix="kfimg")
    try:
        timeline.reset()
        folder = ImageNetFolder(root=root, image_size=IMG_HW,
                                batch_size=IMG_BATCH, rank=0, size=RANKS,
                                seed=0, n_synthetic=16 * IMG_BATCH,
                                synthetic_classes=IMG_CLASSES, device="cpu")
        losses, step_ms = [], []
        batches = (folder.next_batch() for _ in range(IMG_DATA_STEPS))
        t_prev = time.perf_counter()
        for b in prefetch_to_device(batches, size=2, device="cuda"):
            check(b[0].is_cuda and tuple(b[0].shape) == (IMG_BATCH, IMG_HW,
                                                          IMG_HW, 3),
                  f"staged batch {tuple(b[0].shape)} on {b[0].device}")
            *carry[:], loss = step(*carry, b)
            losses.append(float(loss))
            now = time.perf_counter()
            step_ms.append((now - t_prev) * 1e3)
            t_prev = now
        stalls = [e["dur"] * 1e3 for e in timeline.snapshot()
                  if e["kind"] == "input" and e["name"] == "prefetch.next"]
        check(len(losses) == IMG_DATA_STEPS
              and all(math.isfinite(x) for x in losses),
              f"ImageNet-fed losses {losses}")
        check(folder.consumed == IMG_DATA_STEPS * IMG_BATCH * RANKS,
              f"folder consumed {folder.consumed}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _set_env(saved)
        timeline.reset()
    imagenet = {"losses": losses, "input_stall_ms": stalls[:IMG_DATA_STEPS],
                "loop_ms": step_ms}
    print(f"images (d) ImageNetFolder synthetic at {IMG_HW}, rank 0 of "
          f"{RANKS}, {IMG_BATCH} a batch, prefetch_to_device(cuda): losses "
          f"{[round(x, 4) for x in losses]}, input stall per step "
          f"{[round(x, 2) for x in stalls[:IMG_DATA_STEPS]]} ms (decode on "
          f"the host), loop ms {[round(x, 1) for x in step_ms]}")

    # the SLP over four co-resident ranks
    x, y = synthetic_mnist()
    slp = mnist_slp()
    p = slp.init(torch.Generator().manual_seed(0), device="cuda")
    comm4 = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    tx = synchronous_sgd(sgd(MNIST_LR), comm4.axis, schedule="pallas_ring")
    step4 = dp_train_step(lambda pp, b: slp.loss(pp, b), tx, comm4)
    shards = [ElasticDataset([x, y], MNIST_BATCH, rank=r, size=RANKS,
                             seed=0) for r in range(RANKS)]

    def global_batches():
        for parts in zip(*(s.epochs(MNIST_EPOCHS) for s in shards)):
            yield (np.concatenate([q[0] for q in parts]),
                   np.concatenate([q[1] for q in parts]))

    full = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    acc0 = float(slp.accuracy(p, full))
    o = tx.init(p)
    n_steps = 0
    for b in prefetch_to_device(global_batches(), device="cuda"):
        p, o, loss = step4(p, o, b)
        n_steps += 1
    acc1 = float(slp.accuracy(p, full))
    check(n_steps == MNIST_EPOCHS * len(x) // (MNIST_BATCH * RANKS),
          f"{n_steps} SLP steps")
    check(acc1 > acc0 + 0.3, f"SLP accuracy did not rise: {acc0} -> {acc1}")
    print(f"images (d) mnist_slp on {RANKS} co-resident ranks, "
          f"synthetic_mnist through ElasticDataset shards and "
          f"prefetch_to_device, pallas_ring: accuracy {acc0:.3f} -> "
          f"{acc1:.3f} over {n_steps} steps, last loss {float(loss):.4f}")
    return {"imagenet": imagenet, "slp_accuracy": [acc0, acc1],
            "slp_steps": n_steps, "slp_last_loss": float(loss)}


def _images_vgg(torch, np, VGG, spec, rng) -> dict:
    """(e): VGG-16 with batch norm on one rank, batch 32 at 224, bf16:
    S-SGD steps on a fixed batch, falling loss, images/s, peak memory."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step

    model = VGG(16, num_classes=IMG_CLASSES)
    params, state = model.init(torch.Generator().manual_seed(0),
                               device="cuda")
    comm = Communicator(devices=["cuda:0"])
    tx = synchronous_sgd(sgd(VGG_LR, momentum=0.9), comm.axis)
    step = dp_train_step(lambda p, s, b: model.loss(p, s, b, train=True),
                         tx, comm, has_aux=True)
    batch = _image_batch(torch, np, rng, VGG_BATCH, IMG_HW, IMG_CLASSES)
    carry = [params, state, tx.init(params)]
    losses = []
    for _ in range(2):
        *carry[:], loss = step(*carry, batch)
        losses.append(float(loss))
    dev, host, mem = _event_steps(torch, step, carry, batch, VGG_STEPS,
                                  losses)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"VGG-16 loss did not fall: {losses}")
    step_ms = statistics.median(dev)
    flops = 3 * 2 * _vgg_macs(model, IMG_HW)
    tflops = flops * VGG_BATCH / (step_ms / 1e3) / 1e12
    res = {"images_s": VGG_BATCH / (step_ms / 1e3), "step_ms": step_ms,
           "step_ms_all": dev, **mem, "losses": losses,
           "train_flops_per_image": flops, "tflops": tflops}
    print(f"images (e) VGG-16 BN one rank, batch {VGG_BATCH} at {IMG_HW}, "
          f"bf16: {step_ms:.2f} ms/step, {res['images_s']:.1f} images/s, "
          f"{tflops:.1f} TFLOP/s of {flops / 1e9:.2f} GFLOP an image a "
          f"step, {_mem_text(mem)}; losses "
          f"{[round(x, 4) for x in losses]}")
    del carry, batch
    torch.cuda.empty_cache()
    return res


#: phase 20: bert_base() under the port's launcher, one worker process a
#: rank on the card (``python -m kungfu_tpu_torch -np 4 -monitor``); each
#: epoch takes KFRUN_STEPS steps on KFRUN_BATCH-seeded [BERT_ROWS,
#: BERT_SEQ] batches a rank and ends in an npz checkpoint of the params,
#: the momentum and the epoch (rank 0 writes it)
KFRUN_NP, KFRUN_EPOCHS, KFRUN_STEPS = 4, 2, 2
#: (b): rank 1 exits with DIE_EXIT_CODE after its first step of this
#: epoch; the monitored runner's failure-detection period
KFRUN_DIE_EPOCH, KFRUN_PERIOD = 1, "30s"
#: rank 0's first step against the same step through the kernels' plain
#: versions, phase 10's tolerances: the loss as the four ranks' against
#: one rank's; the params after one SGD step, and every gradient leaf but
#: the attention's q and k weights, 5e-2 relative L2 per leaf.  The q and
#: k weight gradients are reported: at bert_base()'s nearly uniform
#: attention they stand 0.10-0.13 from the plain path's (ROADMAP C10)
KFRUN_LOSS_RTOL, KFRUN_GRAD_REL_L2 = RANKS_LOSS_RTOL, RANKS_GRAD_REL_L2
KFRUN_QK_LEAVES = ("/wq/", "/wk/")
#: one launch of the launcher (a or b), command included, at most
KFRUN_TIMEOUT_S = 300
#: (a) runs under ``-sentinel``: the ranks push every
#: KF_CONFIG_MONITOR_PUSH_PERIOD (1 s by default) and the sentinel samples
#: at most once a KF_SENTINEL_PERIOD (1 s) on an ingest, so consecutive
#: samples of the cluster stream stand at most this many periods apart
KFRUN_PUSH_PERIOD_S, KFRUN_SENTINEL_GAP = 1.0, 3.0


def _kfrun_batch(torch, np, vocab: int, epoch: int, step: int, rank: int):
    """A worker's batch: ids and targets [BERT_ROWS, BERT_SEQ], a function
    of (seed 0, epoch, step, rank) only, so a relaunched round draws the
    batches the first round drew."""
    rng = np.random.default_rng([0, epoch, step, rank])
    return tuple(torch.from_numpy(rng.integers(
        0, vocab, size=(BERT_ROWS, BERT_SEQ))).cuda() for _ in range(2))


def _plain_flash_attn(torch, attention):
    """The ``attn_fn`` of ``Transformer.apply`` through the flash kernels'
    plain versions (``_PlainFlash``) on ``[B, H, S, D]`` operands."""
    plain = _PlainFlash(torch, attention)

    def attn(q, k, v, causal):
        b, h, s, d = q.shape
        out = plain(q.reshape(b * h, s, d), k.reshape(b * h, s, d),
                    v.reshape(b * h, s, d), causal)[0]
        return out.reshape(b, h, s, d)

    return attn


def _plain_loss_grads(torch, kernels, model, params, batch):
    """One rank's loss and gradients (a list in ``tree_flatten`` order)
    through the kernels' plain versions: flash reference forward and
    backward, ``token_nll_rows`` under ``KF_TPU_XENT=plain``; no kernel
    may launch."""
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.parallel.train import per_rank_grads

    plain_attn = _plain_flash_attn(torch, attention)

    def loss_plain(p, b):  # the xent kernels' plain version: log_softmax
        logits = model.apply(p, b[0], train=True, attn_fn=plain_attn)
        return xent.token_nll_rows(logits, b[1]).mean()

    old = _set_env({"KF_TPU_XENT": "plain"})
    xent.XENT_ENV.reload()
    before = _counts(kernels)
    try:
        grads = []
        outs, _ = per_rank_grads(loss_plain, params, [batch],
                                 lambda r, g: grads.extend(g))
        torch.cuda.synchronize()
    finally:
        _set_env(old)
        xent.XENT_ENV.reload()
    launched = {k: v - before[k] for k, v in _counts(kernels).items()
                if v != before[k]}
    check(not launched, f"the plain first step launched kernels: {launched}")
    return outs[0], grads


def _kfrun_plain_check(torch, kernels, model, params, batch, loss_k,
                       grads_k, lr: float = BERT_LR,
                       what: str = "worker") -> dict:
    """Rank 0's first step through the kernels' plain versions (flash
    reference forward and backward, ``token_nll_rows`` under
    ``KF_TPU_XENT=plain``), held against
    the kernels' loss and gradients, and the params after one SGD step of
    rate ``lr`` from each; no kernel may launch."""
    from kungfu_tpu_torch.utils.tree import tree_flatten_with_path

    loss_p, grads = _plain_loss_grads(torch, kernels, model, params, batch)
    loss_p = float(loss_p)
    pairs = [("/".join(map(str, path)), p)
             for path, p in tree_flatten_with_path(params)[0]]
    names = [n for n, _ in pairs]
    rel = _rel_l2_leaves(dict(zip(names, grads_k)), dict(zip(names, grads)))
    # the params after one SGD step from the same start (phase 10's check)
    step_k = {n: p - lr * g for (n, p), g in zip(pairs, grads_k)}
    step_p = {n: p - lr * g for (n, p), g in zip(pairs, grads)}
    rel_p = _rel_l2_leaves(step_k, step_p)
    qk = {n: v for n, v in rel.items()
          if any(k in f"/{n}/" for k in KFRUN_QK_LEAVES)}
    rest = {n: v for n, v in rel.items() if n not in qk}
    worst = max(rest, key=rest.get)
    worst_qk = max(qk, key=qk.get)
    out = {"loss": loss_k, "loss_plain": loss_p,
           "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_l2_worst": rest[worst], "grad_rel_l2_worst_leaf": worst,
           "qk_grad_rel_l2_worst": qk[worst_qk],
           "qk_grad_rel_l2_worst_leaf": worst_qk,
           "params_rel_l2_worst": max(rel_p.values())}
    check(out["loss_rel"] <= KFRUN_LOSS_RTOL,
          f"{what} first loss {loss_k} vs plain {loss_p}: rel "
          f"{out['loss_rel']:.3e} > {KFRUN_LOSS_RTOL}")
    check(out["grad_rel_l2_worst"] <= KFRUN_GRAD_REL_L2
          and out["params_rel_l2_worst"] <= KFRUN_GRAD_REL_L2,
          f"{what} first step vs plain: {out}")
    return out


def kfrun_worker_main(argv) -> int:
    """``--kfrun-worker``: phase 20's training program, one rank a
    process under the port's launcher (see :func:`phase_kfrun`).  Writes
    one JSON object a line to ``--out``/rank{r}.jsonl (appended, so a
    relaunched round adds to the first round's lines): ``up`` at start,
    one ``epoch`` line an epoch, ``die`` before a deliberate exit, and
    ``done``."""
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(prog="chip_smoke.py --kfrun-worker")
    ap.add_argument("--n-epochs", type=int, default=KFRUN_EPOCHS)
    ap.add_argument("--steps", type=int, default=KFRUN_STEPS)
    ap.add_argument("--restart", type=int, default=0)
    ap.add_argument("--die-at-epoch", type=int, default=-1)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    proc0 = float(os.environ["KF_PROC_START_TIMESTAMP"])
    sys.path.insert(0, HERE)
    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.chaos import DIE_EXIT_CODE
    from kungfu_tpu_torch.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.monitor.signals import (monitor_batch_begin,
                                                  monitor_batch_end,
                                                  monitor_epoch_end,
                                                  monitor_train_end)
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.ops.cuda import collectives as ringk
    from kungfu_tpu_torch.ops.cuda import lm_head as lmk
    from kungfu_tpu_torch.ops.triton import xent as xk
    from kungfu_tpu_torch.optimizers import apply_updates, sgd
    from kungfu_tpu_torch.parallel.train import per_rank_grads
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (attention, xk, lmk, ringk)
    peer = kf.init()
    device = peer.device()  # the card: raises without one
    rank, size = peer.rank(), peer.size()
    engine = peer.engine()
    chan, mon = peer.channel, peer.net_monitor
    check(engine is not None and mon is not None,
          "the worker needs a host engine and KF_CONFIG_ENABLE_MONITORING")
    path = os.path.join(args.out, f"rank{rank}.jsonl")

    def emit(kind: str, **rec) -> None:
        line = json.dumps({"kind": kind, "rank": rank, "wall": time.time(),
                           "restart": args.restart, **rec})
        with open(path, "a") as f:
            f.write(line + "\n")
        print("KFRUN " + line, flush=True)

    emit("up", size=size, self=str(peer.config.self_id), device=str(device),
         metrics_port=peer._metrics_server.port, pid=os.getpid(),
         up_s=time.time() - proc0)
    model = tr.bert_base()
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    flash = attention.make_flash_attn()

    def loss_fn(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=flash)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    opt = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    o = opt.init(params)
    leaves, treedef = tree_flatten(params)
    sizes = [t.numel() for t in leaves]
    total = sum(sizes)
    check(total == BERT_PARAMS, f"{total} params, expected {BERT_PARAMS}")
    buf = torch.empty(total, dtype=torch.float32, pin_memory=True)
    start, restore_ms = 0, None
    if args.restart:
        t0 = time.perf_counter()
        got = restore_checkpoint(args.ckpt_dir, {"params": params, "opt": o})
        check(got is not None, f"restart without a checkpoint in "
              f"{args.ckpt_dir}")
        tree, _, meta = got
        params, o = tree["params"], tree["opt"]
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        start = int(meta["epochs_done"])
    elif rank == 0:
        for name in os.listdir(args.ckpt_dir):
            os.unlink(os.path.join(args.ckpt_dir, name))
    want_step = {key: 0 for key in _counts(kernels)}
    want_step.update(flash_fwd=model.cfg.n_layers,
                     flash_bwd_dq=model.cfg.n_layers,
                     flash_bwd_dkv=model.cfg.n_layers,
                     xent_fwd=1, xent_bwd=1)

    def unflat(flat):
        parts, off = [], 0
        for t, n in zip(leaves, sizes):
            parts.append(flat[off:off + n].view(t.shape))
            off += n
        return tree_unflatten(treedef, parts)

    def egress_total() -> int:
        chan.poll_counters()  # the C++ counters, now
        return sum(mon.totals()["egress"].values())

    first_step_s = None
    plain = None
    for e in range(start, start + args.n_epochs):
        losses, rows = [], []
        launches = {key: 0 for key in want_step}
        for s in range(args.steps):
            monitor_batch_begin(rank)
            batch = _kfrun_batch(torch, np, model.cfg.vocab_size, e, s, rank)
            _reset(kernels)
            t0 = time.perf_counter()
            grads = []
            outs, _ = per_rank_grads(loss_fn, params, [batch],
                                     lambda r, g: grads.extend(g))
            loss = float(outs[0])  # synchronises
            t1 = time.perf_counter()
            per = _counts(kernels)
            check(per == want_step, f"rank {rank} step ({e}, {s}) launched "
                  f"{per}, expected {want_step}")
            for key, v in per.items():
                launches[key] += v
            if plain is None and rank == 0 and not args.restart:
                plain = _kfrun_plain_check(torch, kernels, model, params,
                                           batch, loss, grads)
            t1b = time.perf_counter()
            off = 0
            for g, n in zip(grads, sizes):
                buf[off:off + n].copy_(g.reshape(-1))
                off += n
            del grads
            t2 = time.perf_counter()
            name = f"g{e}.{s}"
            eg0 = egress_total()
            engine.all_reduce(buf, op="mean", inplace=True, name=name)
            t3 = time.perf_counter()
            egress = egress_total() - eg0
            want_egress = sum(engine.all_reduce_egress(
                total * 4, 4, name).values())
            check(egress == want_egress, f"rank {rank}: the net monitor "
                  f"counted {egress} B of {name}, its engine sent "
                  f"{want_egress} B")
            u, o = opt.update(unflat(buf.to("cuda", non_blocking=True)), o,
                              params)
            params = apply_updates(params, u)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            monitor_batch_end(rank)
            losses.append(loss)
            rows.append({"grads_ms": (t1 - t0) * 1e3,
                         "d2h_ms": (t2 - t1b) * 1e3,
                         "allreduce_ms": (t3 - t2) * 1e3,
                         "h2d_update_ms": (t4 - t3) * 1e3,
                         "step_ms": (t4 - t0 - (t1b - t1)) * 1e3,
                         "egress_bytes": egress,
                         "rates": mon.egress_rates()})
            if first_step_s is None:
                first_step_s = time.time() - proc0
                emit("first", first_step_s=first_step_s)
            if (e == args.die_at_epoch and s == 0 and rank == 1
                    and not args.restart):
                emit("die", epoch=e, step=s, losses=losses, steps=rows,
                     launches=launches)
                os._exit(DIE_EXIT_CODE)
        monitor_epoch_end(rank, e)
        ckpt_ms = None
        if rank == 0:
            t0 = time.perf_counter()
            save_checkpoint(args.ckpt_dir, e, {"params": params, "opt": o},
                            meta={"epochs_done": e + 1})
            ckpt_ms = (time.perf_counter() - t0) * 1e3
        emit("epoch", epoch=e, losses=losses, steps=rows, launches=launches,
             ckpt_ms=ckpt_ms)
    digest = [0, 0]
    for t in tree_flatten(params)[0]:
        a, b = _device_digest(torch, t)
        digest = [digest[0] + a, digest[1] + b]
    monitor_train_end(rank)
    emit("done", digest=digest, restore_ms=restore_ms, plain=plain,
         start_epoch=start,
         totals={k: sum(v.values()) for k, v in mon.totals().items()})
    kf.finalize()
    return 0


def _free_port(host: str = "127.0.0.1") -> int:
    import socket

    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _free_port_range(n: int, host: str = "127.0.0.1") -> int:
    """A base port whose next ``n`` ports and their metrics ports (+10000)
    were free when probed."""
    import random
    import socket

    for _ in range(200):
        base = random.randrange(20000, 30000)
        try:
            socks = []
            for p in [base + i for i in range(n)] + \
                    [base + 10000 + i for i in range(n)]:
                s = socket.socket()
                socks.append(s)
                s.bind((host, p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise SmokeFailure(f"no free range of {n} ports")


def _kfrun_records(out_dir: str) -> list:
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".jsonl"):
            with open(os.path.join(out_dir, name)) as f:
                recs += [json.loads(ln) for ln in f if ln.strip()]
    return recs


def _http(url: str, timeout: float = 2.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""
    except OSError:
        return None, ""


def _prom(text: str, name: str) -> dict:
    """``{labels: value}`` of one Prometheus series family."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(name + "{") or ln.startswith(name + " "):
            key, _, val = ln.rpartition(" ")
            out[key[len(name):]] = float(val)
    return out


def _kfrun_launch(root: str, name: str, runner_args: list,
                  worker_args: list, scrape: bool) -> dict:
    """One run of ``python -m kungfu_tpu_torch -np 4 -H 127.0.0.1:4
    -monitor ... python3 chip_smoke.py --kfrun-worker``; while it runs,
    with ``scrape``, polls the builtin config server's ``/cluster`` and
    ``/metrics`` and every worker's metrics server."""
    base = _free_port_range(KFRUN_NP)
    cfg_port = _free_port()
    d = os.path.join(root, name)
    out_dir, ckpt, logdir = (os.path.join(d, x) for x in ("out", "ckpt",
                                                           "logs"))
    for x in (out_dir, ckpt):
        os.makedirs(x)
    cmd = [sys.executable, "-m", "kungfu_tpu_torch", "-np", str(KFRUN_NP),
           "-H", f"127.0.0.1:{KFRUN_NP}", "-monitor", "-q",
           "-builtin-config-port", str(cfg_port), "-logdir", logdir,
           "-port-range", f"{base}-{base + 1000}", *runner_args,
           sys.executable, os.path.abspath(__file__), "--kfrun-worker",
           "--n-epochs", str(KFRUN_EPOCHS), "--steps", str(KFRUN_STEPS),
           "--ckpt-dir", ckpt, "--out", out_dir, *worker_args]
    env = dict(os.environ, PYTHONPATH=HERE, KF_SOCK_DIR=root,
               KF_TPU_USE_UNIXSOCK="1" if len(root) < 64 else "0")
    runner_log = os.path.join(d, "runner.log")
    print(f"kfrun {name}: {' '.join(cmd[2:])}")
    t0 = time.time()
    with open(runner_log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=HERE, env=env, start_new_session=True)
    cfg = f"http://127.0.0.1:{cfg_port}"
    scrapes = {"cluster": None, "metrics": None, "workers": {},
               "alerts": []}
    try:
        while proc.poll() is None:
            if time.time() - t0 > KFRUN_TIMEOUT_S:
                raise SmokeFailure(f"kfrun {name} ran past "
                                   f"{KFRUN_TIMEOUT_S} s")
            time.sleep(0.5)
            if not scrape:
                continue
            code, text = _http(cfg + "/cluster")
            if code == 200:
                view = json.loads(text)
                fresh = [r["rank"] for r in view["ranks"]
                         if r["rank"] not in view["stale"]]
                if len(fresh) >= len(
                        (scrapes["cluster"] or {}).get("fresh", [])):
                    scrapes["cluster"] = {"fresh": fresh,
                                          "stale": view["stale"]}
            code, _ = _http(cfg + "/alerts")
            if code not in scrapes["alerts"]:
                scrapes["alerts"].append(code)
            code, text = _http(cfg + "/metrics")
            if code == 200 and "kf_cluster_ranks" in text:
                scrapes["metrics"] = {
                    "ranks": _prom(text, "kf_cluster_ranks").get("", 0),
                    "series": sum(1 for ln in text.splitlines()
                                  if ln and not ln.startswith("#"))}
            for rec in _kfrun_records(out_dir):
                if rec["kind"] != "up":
                    continue
                code, text = _http(
                    f"http://127.0.0.1:{rec['metrics_port']}/metrics")
                if code != 200:
                    continue
                w = scrapes["workers"].setdefault(
                    rec["rank"], {"max_rate": 0.0, "egress": {},
                                  "ingress": {}})
                rate = sum(_prom(text, "kf_egress_bytes_per_sec").values())
                w["max_rate"] = max(w["max_rate"], rate)
                # the scrape with the most bytes (totals only grow)
                eg = _prom(text, "kf_egress_bytes_total")
                if sum(eg.values()) >= sum(w["egress"].values()):
                    w["egress"] = eg
                    w["ingress"] = _prom(text, "kf_ingress_bytes_total")
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            # the runner's group, then each worker's: a worker runs in a
            # process group of its own
            os.killpg(proc.pid, 9)
            proc.wait()
            for rec in _kfrun_records(out_dir):
                if rec["kind"] == "up":
                    try:
                        os.killpg(rec["pid"], 9)
                    except (ProcessLookupError, PermissionError):
                        pass
    wall = time.time() - t0
    with open(runner_log) as f:
        log = f.read()
    events = {}
    for ln in log.splitlines():
        if "event: monitored-round-" in ln:
            ev = ln.split("event: ", 1)[1].split(" |", 1)[0]
            events[ev] = float(ln.split("wall=", 1)[1].split()[0])
    print(f"kfrun {name}: exit {rc} after {wall:.2f} s; runner log tail:\n"
          + "\n".join(log.splitlines()[-8:]))
    if rc != 0 and os.path.isdir(logdir):
        for fn in sorted(os.listdir(logdir)):
            if fn.endswith(".stderr.log"):
                with open(os.path.join(logdir, fn)) as f:
                    tail = f.read().splitlines()[-12:]
                print(f"kfrun {name} {fn}:\n" + "\n".join(tail))
    return {"rc": rc, "wall_s": wall, "records": _kfrun_records(out_dir),
            "scrapes": scrapes, "events": events, "t0": t0}


def _kfrun_epochs(recs, restart=None) -> dict:
    """``{(rank, epoch): record}`` of the epoch lines (of one round)."""
    return {(r["rank"], r["epoch"]): r for r in recs
            if r["kind"] == "epoch"
            and (restart is None or r["restart"] == restart)}


def _kfrun_sentinel(sdir: str, a: dict) -> dict:
    """(a) under ``-sentinel DIR``: ``/alerts`` answered 200, the
    ``cluster`` stream holds a sample for each push period the run
    lasted (no gap between samples past KFRUN_SENTINEL_GAP periods), and
    ``python -m kungfu_tpu_torch.monitor.kfhist --dir DIR --verdict``
    exits 0."""
    from kungfu_tpu_torch.monitor import history

    recs = history.read_stream(sdir, "cluster")
    walls = [r["wall"] for r in recs]
    gaps = [b - w for w, b in zip(walls, walls[1:])]
    rep = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.monitor.kfhist", "--dir",
         sdir, "--verdict"], capture_output=True, text=True, timeout=120,
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE))
    out = {"alerts_codes": a["scrapes"]["alerts"], "records": len(recs),
           "span_s": walls[-1] - walls[0] if walls else 0.0,
           "max_gap_s": max(gaps) if gaps else None,
           "kfhist_rc": rep.returncode,
           "kfhist": rep.stdout.splitlines()[:1]}
    check(200 in a["scrapes"]["alerts"],
          f"(a) /alerts answered {a['scrapes']['alerts']}, never 200")
    check(len(recs) > 1 and out["max_gap_s"]
          <= KFRUN_SENTINEL_GAP * KFRUN_PUSH_PERIOD_S,
          f"(a) the sentinel's cluster stream: {out}")
    check(rep.returncode == 0, f"kfhist --verdict exited {rep.returncode}: "
          f"{rep.stderr[-1500:]}")
    print(f"kfrun (a) -sentinel: /alerts {a['scrapes']['alerts']}; "
          f"{out['records']} cluster samples over {out['span_s']:.1f} s, "
          f"largest gap {out['max_gap_s']:.2f} s; kfhist --verdict exit 0: "
          f"{out['kfhist']}")
    return out


def phase_kfrun(torch, np, kernels) -> dict:
    """Phase 20: the launcher on the card.  (a) SimpleRun with -monitor:
    four worker processes of ``chip_smoke.py --kfrun-worker`` train
    bert_base() for KFRUN_EPOCHS epochs over the host engine while the
    phase scrapes ``/cluster``, ``/metrics`` and each worker's metrics
    server.  (b) MonitoredRun (``-auto-recover``): rank 1 exits with
    DIE_EXIT_CODE after its first step of epoch 1, the runner kills the
    group and relaunches it with ``--n-epochs 2 --restart 1``, the
    workers restore the epoch checkpoint and finish: every epoch's
    losses and every rank's final params equal (a)'s bit for bit."""
    import shutil
    import tempfile

    from kungfu_tpu_torch.chaos import DIE_EXIT_CODE

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kfr")
    out = {}
    try:
        sdir = os.path.join(root, "sentinel")
        a = _kfrun_launch(root, "a", ["-sentinel", sdir], [], scrape=True)
        check(a["rc"] == 0, f"(a) exited {a['rc']}")
        out["a_sentinel"] = _kfrun_sentinel(sdir, a)
        b = _kfrun_launch(root, "b", ["-auto-recover", KFRUN_PERIOD],
                          ["--die-at-epoch", str(KFRUN_DIE_EPOCH)],
                          scrape=False)
        check(b["rc"] == 0, f"(b)'s runner exited {b['rc']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ranks = range(KFRUN_NP)
    epochs = range(KFRUN_EPOCHS)
    ea = _kfrun_epochs(a["records"])
    done_a = {r["rank"]: r for r in a["records"] if r["kind"] == "done"}
    check(set(ea) == {(r, e) for r in ranks for e in epochs}
          and set(done_a) == set(ranks),
          f"(a) is missing JSON lines: epochs {sorted(ea)}, done "
          f"{sorted(done_a)}")
    plain = done_a[0]["plain"]
    print(f"kfrun (a) rank 0 first step vs the plain versions: loss "
          f"{plain['loss']:.6f} vs {plain['loss_plain']:.6f} (rel "
          f"{plain['loss_rel']:.3e}, tol {KFRUN_LOSS_RTOL}); worst gradient "
          f"leaf but q/k {plain['grad_rel_l2_worst_leaf']} rel L2 "
          f"{plain['grad_rel_l2_worst']:.3e}, params after one step "
          f"{plain['params_rel_l2_worst']:.3e} (tol {KFRUN_GRAD_REL_L2}); "
          f"q/k weights {plain['qk_grad_rel_l2_worst_leaf']} "
          f"{plain['qk_grad_rel_l2_worst']:.3e} (C10)")
    # (a)'s scrapes
    sc = a["scrapes"]
    check(sc["cluster"] is not None
          and sorted(sc["cluster"]["fresh"]) == list(ranks),
          f"/cluster never showed {KFRUN_NP} fresh ranks: {sc['cluster']}")
    check(sc["metrics"] is not None
          and sc["metrics"]["ranks"] == KFRUN_NP,
          f"/metrics never rendered {KFRUN_NP} ranks: {sc['metrics']}")
    for r in ranks:
        w = sc["workers"].get(r)
        check(w is not None and w["egress"] and w["ingress"]
              and all(v > 0 for v in w["egress"].values())
              and all(v > 0 for v in w["ingress"].values())
              and w["max_rate"] > 0,
              f"rank {r}'s metrics server: {w}")
    warm = [row for e in epochs for r in ranks
            for i, row in enumerate(ea[(r, e)]["steps"]) if (e, i) != (0, 0)]
    med = {k: statistics.median(row[k] for row in warm) for k in (
        "step_ms", "grads_ms", "d2h_ms", "allreduce_ms", "h2d_update_ms")}
    per_step_bytes = statistics.median(row["egress_bytes"] for row in warm)
    max_rate = {r: sc["workers"][r]["max_rate"] for r in ranks}
    out["a"] = {"wall_s": a["wall_s"], "plain": plain,
                "first_step_s": {x["rank"]: x["first_step_s"]
                                 for x in a["records"]
                                 if x["kind"] == "first"},
                "up_s": {x["rank"]: x["up_s"] for x in a["records"]
                         if x["kind"] == "up"},
                "median_ms": med,
                "allreduce_share": med["allreduce_ms"] / med["step_ms"],
                "egress_bytes_per_step": per_step_bytes,
                "egress_bytes_per_s_of_step": per_step_bytes
                / (med["step_ms"] / 1e3),
                "egress_bytes_per_s_of_allreduce": per_step_bytes
                / (med["allreduce_ms"] / 1e3),
                "monitor_max_egress_rate": max_rate,
                "ckpt_ms": [ea[(0, e)]["ckpt_ms"] for e in epochs],
                "cluster": sc["cluster"], "metrics": sc["metrics"],
                "totals": {r: done_a[r]["totals"] for r in ranks}}
    print(f"kfrun (a): {KFRUN_NP} workers x {KFRUN_EPOCHS} epochs x "
          f"{KFRUN_STEPS} steps in {a['wall_s']:.2f} s; spawn to first "
          f"step {out['a']['first_step_s']}; step {med['step_ms']:.1f} ms "
          f"median (allreduce {med['allreduce_ms']:.1f} ms, "
          f"{out['a']['allreduce_share']:.3f} of it; grads "
          f"{med['grads_ms']:.1f}, D2H {med['d2h_ms']:.1f}, H2D+update "
          f"{med['h2d_update_ms']:.1f}); egress {per_step_bytes:.0f} B a "
          f"step a rank = {out['a']['egress_bytes_per_s_of_step']:.3e} B/s "
          f"of step time, {out['a']['egress_bytes_per_s_of_allreduce']:.3e}"
          f" B/s of allreduce; the monitor's highest egress rate "
          f"{max_rate}; checkpoints {out['a']['ckpt_ms']} ms; /cluster "
          f"{sc['cluster']}, /metrics {sc['metrics']}")
    # (b): a real process death and the relaunch
    recs = b["records"]
    die = [x for x in recs if x["kind"] == "die"]
    check(len(die) == 1 and die[0]["rank"] == 1
          and die[0]["epoch"] == KFRUN_DIE_EPOCH,
          f"(b) expected rank 1's death in epoch {KFRUN_DIE_EPOCH}: {die}")
    e0 = _kfrun_epochs(recs, restart=0)
    e1 = _kfrun_epochs(recs, restart=1)
    done_b = {x["rank"]: x for x in recs if x["kind"] == "done"}
    check(set(e0) == {(r, 0) for r in ranks}
          and set(e1) == {(r, e) for r in ranks for e in epochs if e >= 1}
          and set(done_b) == set(ranks)
          and all(x["restart"] == 1 and x["start_epoch"] == KFRUN_DIE_EPOCH
                  for x in done_b.values()),
          f"(b) is missing JSON lines: round 0 {sorted(e0)}, round 1 "
          f"{sorted(e1)}, done {sorted(done_b)}")
    eb = {**e0, **e1}
    diff = [(r, e) for r in ranks for e in epochs
            if eb[(r, e)]["losses"] != ea[(r, e)]["losses"]]
    check(not diff, f"(b)'s losses differ from (a)'s at (rank, epoch) {diff}")
    digests = {r: done_b[r]["digest"] for r in ranks}
    check(all(digests[r] == done_a[r]["digest"] for r in ranks)
          and len({tuple(d) for d in digests.values()}) == 1,
          f"(b)'s final params differ from (a)'s: {digests} vs "
          f"{ {r: done_a[r]['digest'] for r in ranks} }")
    ev = b["events"]
    check({"monitored-round-0-down", "monitored-round-0-exited",
           "monitored-round-1-spawn"} <= set(ev), f"runner events {ev}")
    first = {(x["restart"], x["rank"]): x for x in recs
             if x["kind"] == "first"}
    check(all((1, r) in first for r in ranks), f"(b) first steps {first}")
    out["b"] = {"wall_s": b["wall_s"], "wall_vs_a": b["wall_s"] / a["wall_s"],
                "death_to_detect_s": ev["monitored-round-0-down"]
                - die[0]["wall"],
                "death_to_group_exit_s": ev["monitored-round-0-exited"]
                - die[0]["wall"],
                "exit_to_relaunched_first_step_s": max(
                    first[(1, r)]["wall"] for r in ranks)
                - ev["monitored-round-0-exited"],
                "first_step_s": {
                    f"round{k}": {r: first[(k, r)]["first_step_s"]
                                  for r in ranks if (k, r) in first}
                    for k in (0, 1)},
                "restore_ms": {r: done_b[r]["restore_ms"] for r in ranks},
                "exit_code": DIE_EXIT_CODE}
    print(f"kfrun (b): {b['wall_s']:.2f} s ({out['b']['wall_vs_a']:.3f}x "
          f"(a)); rank 1's death to the runner's verdict "
          f"{out['b']['death_to_detect_s']:.3f} s, to the group's exit "
          f"{out['b']['death_to_group_exit_s']:.3f} s; exit to the "
          f"relaunched first step {out['b']['exit_to_relaunched_first_step_s']:.2f}"
          f" s; restore {out['b']['restore_ms']} ms; every epoch's losses "
          f"and every rank's final params bitwise (a)'s")
    # every step's launches in both runs; the killed round's partial
    # epochs report none but the dying rank's
    launches = {k: 0 for k in _counts(kernels)}
    for rec in a["records"] + recs:
        if rec["kind"] in ("epoch", "die"):
            for k, v in rec["launches"].items():
                launches[k] += v
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"kfrun phase: {out['phase_s']:.2f} s; launches {launches}")
    return out


#: phase 21: the sentinel plane and the trace tools on the flagship.  Each
#: of three port peers (the Python engine path, so the chaos hooks apply)
#: runs the flagship's forward and backward at [P21_BATCH, P21_SEQ] a step
#: and allreduces the first P21_GRAD_ELEMS f32 of its flat gradient on the
#: host with STAR (bench.py:2714 payload_sentinel's scenario)
P21_RANKS, P21_BATCH, P21_SEQ = 3, 2, 128
P21_GRAD_ELEMS = 50_000
#: the allreduced slice against the three slices' sum
P21_ALLREDUCE_RTOL = 1e-6
#: (a): unsampled warm steps the pace is taken from, the pace as a
#: multiple of their slowest, the sentinel's window, the clean and the
#: faulted steps, and the detection budget in windows
P21_WARM, P21_PACE_X, P21_WINDOW = 4, 1.5, 4
P21_CLEAN, P21_CHAOS, P21_K_WINDOWS = 16, 10, 2
#: rank 1's two legs (its send, then its receive at twice the delay)
#: exceed the pad (the pace less a step's compute) by at least this share
#: of the pace
P21_WIRE_MARGIN = 0.3
#: (b): bench.py:3110-3230 part B of payload_pulse: the host bandit under
#: a 30 ms 0<->1 delay on send and ping, a two-sample ledger window
P21_LEDGER_STEPS, P21_LEDGER_WINDOW, P21_LEDGER_WIRE_MS = 36, 2, 30
#: (c): the sentinel's warmup in steps, and the prefill lengths warmed
#: before it (buckets 16 and 32) and after it (one new bucket, 64)
P21_WARMUP_STEPS, P21_PROMPT_EARLY, P21_PROMPT_LATE = 2, 32, 48
#: (e): one SynchronousSGDOptimizer(torch.optim.SGD) step against a plain
#: SGD step on the mean of the three gradients
P21_SGD_LR, P21_SGD_RTOL = 0.05, 1e-6
#: the rows of the TPU kernel table phase 21 launches, by their names in
#: the wrappers' counts and a substring of each CUDA kernel's name in the
#: profiler's device events
P21_KERNELS = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
               "flash_bwd_dkv": "flash_bwd_dkv_",
               "xent_fwd": "_xent_fwd_kernel", "xent_bwd": "_xent_bwd_kernel"}
#: every sentinel and chaos token the phase sets, unset around it
P21_ENVS = ("KF_SENTINEL_DIR", "KF_SENTINEL_PERIOD", "KF_SENTINEL_WINDOW",
            "KF_SENTINEL_THRESHOLD", "KF_SENTINEL_WARMUP_STEPS",
            "KF_SENTINEL_MFU_FLOOR", "KF_SENTINEL_STEP_CEILING_S",
            "KF_SENTINEL_KEEP_BYTES", "KF_SENTINEL_INCIDENT_WINDOW",
            "KF_CHAOS_SPEC")


def _p21_batch(torch, np, vocab: int, rank: int, step: int):
    """Rank ``rank``'s ids and targets at ``step``, from a seed."""
    rng = np.random.default_rng([21, rank, step + 1000])
    ids, tg = (torch.from_numpy(rng.integers(0, vocab, size=(
        P21_BATCH, P21_SEQ))).cuda() for _ in range(2))
    return ids, tg


def _p21_sentinel(torch, np, ctx, root: str) -> dict:
    """(a): payload_sentinel on the card; see phase_sentinel."""
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.configserver import ConfigServer
    from kungfu_tpu_torch.monitor import kftop, timeline
    from kungfu_tpu_torch.monitor.aggregator import (REPORT_KINDS,
                                                     ClusterAggregator,
                                                     make_snapshot)
    from kungfu_tpu_torch.monitor.registry import REGISTRY
    from kungfu_tpu_torch.monitor.sentinel import Sentinel
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.policy import sentinel_signals

    ranks = range(P21_RANKS)
    vocab = ctx["model"].cfg.vocab_size
    slices, sums = {}, {}
    rank_steps = [0]  # forward and backward passes, for the launch count

    def rank_step(p, r, step, pace):
        t0 = time.perf_counter()
        with timeline.span("input", "batch.next", rank=r):
            batch = _p21_batch(torch, np, vocab, r, step)
        g = ctx["grad_slice"](batch)
        out = p.engine().all_reduce(g, op="sum")
        slices[r], sums[r] = g, out
        pad = pace - (time.perf_counter() - t0)
        if pad > 0:
            time.sleep(pad)
        return time.perf_counter() - t0

    def world(peers, step, pace):
        walls = _run_ranks([lambda p=p, r=r: rank_step(p, r, step, pace)
                            for r, p in zip(ranks, peers)], timeout=300)
        rank_steps[0] += len(walls)
        want = slices[0] + slices[1] + slices[2]
        for r in ranks:
            check(np.allclose(sums[r], want, rtol=P21_ALLREDUCE_RTOL, atol=0),
                  f"(a) rank {r}'s allreduce at step {step} is not the "
                  f"three slices' sum")
        return walls

    env = {"KF_ALLREDUCE_STRATEGY": "STAR"}
    # the pace: the slowest of four unsampled warm steps, without faults
    peers = start_local_cluster(P21_RANKS, env=env, devices=["cuda"])
    try:
        world(peers, -1, 0.0)  # first launches of this process's shapes
        warm = [max(world(peers, -1, 0.0)) for _ in range(P21_WARM)]
    finally:
        for p in peers:
            p.close()
    pace = P21_PACE_X * max(warm)
    # rank 1's legs are its send (wire) and its receive (twice the wire);
    # the pad is at most the whole pace (a step that computes nothing), so
    # legs of (1 + margin) x pace exceed any pad by the margin x pace
    wire_ms = math.ceil((1 + P21_WIRE_MARGIN) * pace / 3 * 1e3)
    print(f"phase 21 (a): warm steps {[round(w * 1e3, 2) for w in warm]} ms, "
          f"pace {pace * 1e3:.2f} ms, pad below {pace * 1e3:.2f} ms, "
          f"wire_ms {wire_ms} (rank 1's legs {3 * wire_ms} ms >= the pad + "
          f"{P21_WIRE_MARGIN} x the pace)")
    d = os.path.join(root, "a")
    _set_env({"KF_SENTINEL_DIR": d, "KF_SENTINEL_PERIOD": "1",
              "KF_SENTINEL_WINDOW": str(P21_WINDOW),
              "KF_CHAOS_SPEC": (
                  f"delay:ms={wire_ms},rank=0,peer=1,on=send,"
                  f"after_step={P21_CLEAN};"
                  f"delay:ms={wire_ms},rank=1,peer=0,on=send,"
                  f"after_step={P21_CLEAN};"
                  f"delay:ms={2 * wire_ms},rank=1,peer=0,on=recv,"
                  f"after_step={P21_CLEAN}")})
    chaos.reset()
    clock = [1000.0]
    agg = ClusterAggregator(stale_after=3600.0, time_fn=lambda: clock[0])
    sentinel = Sentinel.from_env()
    check(sentinel is not None and sentinel.window == P21_WINDOW,
          "Sentinel.from_env() did not read KF_SENTINEL_DIR/WINDOW")
    agg.attach_sentinel(sentinel)
    counter = REGISTRY.counter("kf_alerts_total", rule="regress:step_time_s")
    alerts0 = counter.value

    def ingest(r, step, wall_s, events):
        agg.ingest(make_snapshot(
            rank=r, pid=os.getpid(), wall=clock[0], step=step,
            step_time_s=wall_s, counters={}, gauges={}, latency={},
            events=[e for e in events if e["rank"] == r
                    and e["kind"] in REPORT_KINDS
                    and e.get("step", -1) >= step - 1],
            net={}, strategy="STAR"))

    # the operator's view while the alert is live: the routes, kftop's
    # frame and the policy signals, read once the rule first turns active
    srv = ConfigServer(port=0, aggregator=agg).start()
    live = {}

    def scrape():
        for route in ("/alerts", "/decisions", "/cluster"):
            code, text = _http(f"http://127.0.0.1:{srv.port}{route}")
            live[route] = code
        live["view"] = json.loads(text) if code == 200 else None

    peers = start_local_cluster(P21_RANKS, env=env, devices=["cuda"])
    walls_by_step = []
    try:
        for _ in range(2):
            world(peers, -1, pace)
        timeline.reset()
        onset_records, early = None, None
        t0 = time.perf_counter()
        for i in range(P21_CLEAN + P21_CHAOS):
            if i == P21_CLEAN:
                early = [a["rule"] for a in sentinel.alerts_view()["alerts"]]
                onset_records = sentinel.alerts_view()["records"]
            for r in ranks:
                chaos.note_step(r, i)
            walls = world(peers, i, pace)
            walls_by_step.append(walls)
            events = timeline.snapshot()
            for r in ranks:
                ingest(r, i, walls[r], events)
            # past the sample period, then rank 0 again: the sentinel's
            # sample of step i sees every rank's row fresh
            clock[0] += 1.0
            ingest(0, i, walls[0], events)
            if not live and "regress:step_time_s" in \
                    sentinel.alerts_view()["active"]:
                scrape()
        loop_s = time.perf_counter() - t0
    finally:
        srv.stop()
        for p in peers:
            p.close()
        os.environ.pop("KF_CHAOS_SPEC", None)
        chaos.reset()
    check(early == [], f"(a) alerts before the onset: {early}")
    av = sentinel.alerts_view()
    fired = [a for a in av["alerts"] if a["rule"] == "regress:step_time_s"]
    check(len(fired) == 1 and fired[0].get("incident"),
          f"(a) regress:step_time_s fired {len(fired)} times: {av['alerts']}")
    with open(fired[0]["incident"]) as f:
        incident = json.load(f)
    latency = incident["history_n"] - onset_records
    check(0 < latency <= P21_K_WINDOWS * P21_WINDOW,
          f"(a) alert {latency} samples after the onset (budget "
          f"{P21_K_WINDOWS * P21_WINDOW})")
    check(counter.value - alerts0 == 1,
          f"kf_alerts_total{{rule=regress:step_time_s}} moved by "
          f"{counter.value - alerts0}")
    check(any(e["kind"] == "alert" and e["name"] == "regress:step_time_s"
              for e in timeline.snapshot()), "(a) no alert timeline event")
    culprit = ((incident.get("xray") or {}).get("verdict") or {}).get(
        "culprit") or {}
    links = {(e["rank"], e["attrs"].get("peer"))
             for e in incident["timeline_tail"]
             if e["kind"] == "chaos" and e["name"] == "delay"}
    check(culprit.get("slowest_rank") == 1 and links
          and links <= {(0, 1), (1, 0)},
          f"(a) the incident names {culprit} over chaos links {links}, not "
          f"rank 1 and the 0<->1 edge")
    # the offline replay, the tool as an operator runs it (its window
    # and threshold from the same env knobs)
    rep = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.monitor.kfhist", "--dir", d,
         "--verdict", "--upto", str(incident["history_n"]), "--json"],
        capture_output=True, text=True, timeout=120, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE))
    check(rep.returncode == 0, f"kfhist --verdict exited {rep.returncode}: "
          f"{rep.stderr[-1500:]}")
    offline = json.loads(rep.stdout)["verdicts"]
    check(json.dumps(offline, sort_keys=True)
          == json.dumps(incident["verdicts"], sort_keys=True),
          f"(a) kfhist's replay {offline} differs from the incident's "
          f"{incident['verdicts']}")
    codes = {k: v for k, v in live.items() if k != "view"}
    check(codes == {"/alerts": 200, "/decisions": 200, "/cluster": 200},
          f"(a) the config server answered {codes}")
    view = live["view"]
    frame = kftop.render_view(view)
    check("== ALERTS" in frame and "regress:step_time_s" in frame,
          "(a) kftop's frame has no alerts section")
    sig = sentinel_signals(view)
    check(sig is not None and "step_time_s" in sig["regressing"],
          f"(a) sentinel_signals: {sig}")
    clean = [max(w) for w in walls_by_step[:P21_CLEAN]]
    faulted = [max(w) for w in walls_by_step[P21_CLEAN:]]
    v = incident["verdicts"]["step_time_s"]
    # each rank's dump of the shared recorder, as its own process writes it
    dumps = [os.path.join(root, f"trace-rank{r}.jsonl") for r in ranks]
    for r, path in zip(ranks, dumps):
        timeline.dump(path, rank=r)
    out = {"warm_ms": [w * 1e3 for w in warm], "pace_ms": pace * 1e3,
           "wire_ms": wire_ms,
           "clean_step_ms_median": statistics.median(clean) * 1e3,
           "faulted_step_ms_median": statistics.median(faulted) * 1e3,
           "onset_records": onset_records,
           "alert_history_n": incident["history_n"],
           "samples_onset_to_alert": latency, "score": v["score"],
           "base_median_s": v["base_median"],
           "recent_median_s": v["recent_median"], "culprit": culprit,
           "chaos_links": sorted(links), "loop_s": loop_s,
           "rules_fired": [a["rule"] for a in av["alerts"]],
           "incident": os.path.basename(fired[0]["incident"]),
           "dumps": dumps,
           "culprit_rank": culprit.get("slowest_rank"),
           "rank_steps": rank_steps[0]}
    print(f"phase 21 (a): clean step {out['clean_step_ms_median']:.2f} ms, "
          f"faulted {out['faulted_step_ms_median']:.2f} ms (median of the "
          f"slowest rank); regress:step_time_s {latency} samples after the "
          f"onset (score {v['score']}, baseline {v['base_median']} s -> "
          f"{v['recent_median']} s); incident culprit {culprit}; chaos "
          f"links {sorted(links)}; kfhist replay equal; /alerts "
          f"/decisions 200; rules fired {out['rules_fired']}")
    return out


def _p21_ledger(np, root: str, data) -> dict:
    """(b): payload_pulse part B over three peers; see phase_sentinel."""
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.monitor import history, ledger, timeline
    from kungfu_tpu_torch.monitor.adapt_device import HostBanditDriver
    from kungfu_tpu_torch.peer import start_local_cluster

    d = os.path.join(root, "b")
    _set_env({"KF_SENTINEL_DIR": d,
              "KF_SENTINEL_WINDOW": str(P21_LEDGER_WINDOW),
              "KF_CHAOS_SPEC": ";".join(
                  f"delay:ms={P21_LEDGER_WIRE_MS},rank={a},peer={b},on={on}"
                  for a, b in ((0, 1), (1, 0)) for on in ("send", "ping"))})
    chaos.reset()
    ledger.reset()
    timeline.reset()
    led = ledger.ledger_for(d)
    check(led.window == P21_LEDGER_WINDOW, f"ledger window {led.window}")
    ring = history.HistoryRing(d, "cluster")
    peers = start_local_cluster(
        P21_RANKS, env={"KF_ALLREDUCE_STRATEGY": "STAR"}, devices=["cuda"])
    want = data + data + data
    try:
        drivers = [HostBanditDriver(p, check_every=2, min_pulls=1,
                                    min_swap_collectives=1) for p in peers]

        def measure(p, drv):
            t0 = time.perf_counter()
            got = p.engine().all_reduce(data, op="sum")
            dt = time.perf_counter() - t0
            check(np.allclose(got, want, rtol=P21_ALLREDUCE_RTOL, atol=0),
                  "(b) allreduce is not the three slices' sum")
            drv.step(dt)
            return dt

        times = []
        for _ in range(P21_LEDGER_STEPS):
            dts = _run_ranks([lambda p=p, drv=drv: measure(p, drv)
                              for p, drv in zip(peers, drivers)],
                             timeout=120)
            rec = {"series": {"step_time_s": max(dts)}}
            ring.append(rec)
            led.on_sample(rec)
            times.append(max(dts))
        active = {drv.active for drv in drivers}
        swaps = sum(drv.swaps for drv in drivers)
    finally:
        for p in peers:
            p.close()
        os.environ.pop("KF_CHAOS_SPEC", None)
        chaos.reset()
    check(len(active) == 1, f"(b) the ranks diverged on the arm: {active}")
    arm = next(iter(active))
    view = led.view()
    verdicts = [(ledger.lfield(row["decision"], "actor"),
                 ledger.lfield(row["decision"], "new"),
                 ledger.lfield(row["effect"], "verdict"))
                for row in view["decisions"]]
    check(any(a == "bandit-host" and new == arm and v == "improved"
              for a, new, v in verdicts)
          and all(ledger.lfield(row["decision"], "knob") == "strategy"
                  for row in view["decisions"]),
          f"(b) no bandit-host/strategy decision onto {arm} judged improved: "
          f"{verdicts}")
    rep = ledger.replay_effects(d)
    judged = [r for r in rep["decisions"] if r["online"] is not None]
    check(judged and all(json.dumps(r["online"], sort_keys=True)
                         == json.dumps(r["replayed"], sort_keys=True)
                         for r in judged),
          "(b) replay_effects does not recompute every judged verdict")
    evs = timeline.snapshot()
    decisions = [e for e in evs if e["kind"] == "decision"]
    swap_events = [e for e in evs if e["kind"] == "swap"]
    check(len(decisions) == swaps == len(swap_events) > 0,
          f"(b) {len(decisions)} decision events, {len(swap_events)} swap "
          f"events, {swaps} swaps")
    out = {"arm": arm, "swaps": swaps, "decisions": verdicts,
           "judged": len(judged), "summary": view["summary"],
           "step_ms_first": times[0] * 1e3,
           "step_ms_last8_median": statistics.median(times[-8:]) * 1e3}
    print(f"phase 21 (b): arm {arm} on every rank, {swaps} swaps (and as "
          f"many decision events), verdicts {verdicts}, replay identical "
          f"for {len(judged)} judged; step {out['step_ms_first']:.1f} -> "
          f"{out['step_ms_last8_median']:.1f} ms")
    return out


def _p21_recompile(torch, ctx, root: str) -> dict:
    """(c): the recompile watermark over a CUDA-graph capture after the
    sentinel's warmup; see phase_sentinel."""
    from kungfu_tpu_torch.monitor import timeline
    from kungfu_tpu_torch.monitor.aggregator import (ClusterAggregator,
                                                     RankReporter)
    from kungfu_tpu_torch.monitor.metrics import install_compile_metrics
    from kungfu_tpu_torch.monitor.registry import REGISTRY
    from kungfu_tpu_torch.monitor.sentinel import Sentinel
    from kungfu_tpu_torch.serve.engine import InferenceEngine
    from kungfu_tpu_torch.serve.kvcache import KVCachePool, PageSpec

    _set_env({"KF_SENTINEL_DIR": os.path.join(root, "c"),
              "KF_SENTINEL_PERIOD": "1", "KF_SENTINEL_WINDOW": "4",
              "KF_SENTINEL_WARMUP_STEPS": str(P21_WARMUP_STEPS)})
    print(f"phase 21 (c): KF_SENTINEL_WARMUP_STEPS={P21_WARMUP_STEPS}")
    check(install_compile_metrics() and install_compile_metrics(),
          "install_compile_metrics")
    counter = REGISTRY.counter("kf_jit_compiles_total")
    hist = REGISTRY.histogram("kf_jit_compile_seconds")
    model, params = ctx["model"], ctx["params"]
    pool = KVCachePool(PageSpec.for_model(model.cfg,
                                          page_tokens=SERVE_PAGE_TOKENS),
                       SERVE_PAGES)
    n0 = counter.value
    eng = InferenceEngine(model, params, pool=pool, max_batch=SERVE_MAX_BATCH,
                          max_seq=SERVE_MAX_SEQ, rank=0)
    eng.warmup(prompt_lens=(P21_PROMPT_EARLY,))
    early = counter.value - n0
    check(early >= 2, f"(c) the first warmup captured {early} graphs")
    clock = [1000.0]
    agg = ClusterAggregator(stale_after=3600.0, time_fn=lambda: clock[0])
    sentinel = Sentinel.from_env()
    check(sentinel.warmup_steps == P21_WARMUP_STEPS, "warmup steps")
    agg.attach_sentinel(sentinel)
    reporter = RankReporter(0, "http://127.0.0.1:1/get")
    fired, rows = [], []
    late = None
    for step in range(P21_WARMUP_STEPS + 4):
        if step == P21_WARMUP_STEPS + 2:
            c0, s0 = counter.value, hist.sum
            eng.warmup(prompt_lens=(P21_PROMPT_LATE,))
            late = {"captures": counter.value - c0,
                    "capture_ms": (hist.sum - s0) * 1e3}
        timeline.set_step(step)
        agg.ingest(reporter.snapshot_once())
        clock[0] += 1.0
        rows.append(agg.cluster_view()["ranks"][0]["counters"].get(
            "kf_jit_compiles_total"))
        fired.append([a["rule"] for a in sentinel.alerts_view()["alerts"]])
    timeline.set_step(-1)
    del eng
    want = [[]] * (P21_WARMUP_STEPS + 2) + [["watermark:recompile_steady"]] * 2
    check(fired == want and late["captures"] == 1
          and rows[-2] == rows[-3] + 1,
          f"(c) alerts by sample {fired}, the late warmup's captures "
          f"{late}, the rank row's compiles {rows}")
    out = {"warmup_steps": P21_WARMUP_STEPS, "early_captures": early,
           "late": late, "row_compiles": rows,
           "alerts": fired[-1]}
    print(f"phase 21 (c): {early} captures before the sentinel's warmup; "
          f"one capture at step {P21_WARMUP_STEPS + 2} "
          f"({late['capture_ms']:.1f} ms) fired watermark:recompile_steady "
          f"once; the next sample fired nothing; the rank row's "
          f"kf_jit_compiles_total {rows}")
    return out


def _p21_trace(torch, np, kernels, ctx, root: str, a: dict) -> dict:
    """(d): device_trace around one training step of rank 0, and kftrace
    over (a)'s dumps; see phase_sentinel."""
    import contextlib
    import io

    from kungfu_tpu_torch.monitor import skew, traceview, xray
    from kungfu_tpu_torch.parallel.train import per_rank_grads
    from kungfu_tpu_torch.utils import trace

    trace.reset_trace_stats()
    model, params = ctx["model"], ctx["params"]
    batch = _p21_batch(torch, np, model.cfg.vocab_size, 0, 0)

    @trace.traced(name="phase21.train_step")
    def step():
        return ctx["grads"](batch)

    # the same step outside the trace, held against the plain versions
    grads_k = []
    outs, _ = per_rank_grads(ctx["loss_fn"], params, [batch],
                             lambda r, g: grads_k.extend(g))
    plain = _kfrun_plain_check(torch, kernels, model, params, batch,
                               float(outs[0]), grads_k, lr=P21_SGD_LR,
                               what="phase 21 (d) rank 0")
    del grads_k, outs
    print(f"phase 21 (d): rank 0's step vs the plain versions: loss "
          f"{plain['loss']:.6f} vs {plain['loss_plain']:.6f} (rel "
          f"{plain['loss_rel']:.3e}, tol {KFRUN_LOSS_RTOL}); worst gradient "
          f"leaf {plain['grad_rel_l2_worst_leaf']} rel L2 "
          f"{plain['grad_rel_l2_worst']:.3e}, q/k "
          f"{plain['qk_grad_rel_l2_worst']:.3e}, params after an SGD step "
          f"{plain['params_rel_l2_worst']:.3e} (tol {KFRUN_GRAD_REL_L2})")
    torch.cuda.synchronize()
    _reset(kernels)
    logdir = os.path.join(root, "device_trace")
    with trace.device_trace(logdir, force=True) as prof:
        step()
    counts = _counts(kernels)
    check(counts == ctx["want"](1), f"(d) one step launched {counts}, "
          f"expected {ctx['want'](1)}")
    files = os.listdir(logdir)
    check(len(files) == 1 and files[0].endswith(".json"),
          f"(d) device_trace wrote {files}")
    with open(os.path.join(logdir, files[0])) as f:
        doc = json.load(f)
    check(doc.get("traceEvents"), "(d) the Chrome trace has no events")
    seen = {k: [0, 0.0] for k in P21_KERNELS}
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        for k, sub in P21_KERNELS.items():
            if sub in evt.name:
                seen[k][0] += 1
                seen[k][1] += evt.time_range.elapsed_us() / 1e3
    per_kernel = {k: {"launches": n, "wrapper_launches": counts[k],
                      "device_ms_per_launch": ms / n if n else None}
                  for k, (n, ms) in seen.items()}
    check(all(seen[k][0] == counts[k] > 0 for k in P21_KERNELS),
          f"(d) the device trace's launches {per_kernel} are not the "
          f"wrappers' counts")
    rep = trace.trace_report()
    check(rep.get("phase21.train_step", {}).get("count") == 1,
          f"(d) trace_report: {rep}")
    # kftrace over (a)'s three dumps
    events = traceview.load_all(a["dumps"])
    text = traceview.render_report(events, top=P21_CLEAN + P21_CHAOS)
    chaos_steps = [row for row in skew.slowest_rank_per_step(events)
                   if row["step"] >= P21_CLEAN]
    slow1 = [row["step"] for row in chaos_steps if row["slowest_rank"] == 1]
    check(len(slow1) * 2 > len(chaos_steps) > 0
          and all(f"step {s}: rank 1 " in text for s in slow1),
          f"(d) kftrace's report does not name rank 1 the slowest in the "
          f"faulted steps: {chaos_steps}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = traceview.main(["--critical-path", *a["dumps"]])
    culprit = xray.verdict(events)["culprit"]
    check(rc == 0 and culprit["slowest_rank"] == a["culprit_rank"]
          and f"culprit edge: all_reduce/{culprit['tag']} rank "
              f"{culprit['slowest_rank']} " in buf.getvalue(),
          f"(d) --critical-path names {culprit}, the incident rank "
          f"{a['culprit_rank']}")
    merged = os.path.join(root, "merged.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = traceview.main(["merge", "-o", merged, *a["dumps"]])
    with open(merged) as f:
        chrome = json.load(f)
    check(rc == 0 and chrome == traceview.chrome_trace(events),
          "(d) kftrace merge did not write the Chrome trace that loads back")
    launches = dict(counts)
    out = {"per_kernel": per_kernel,
           "trace_events": len(doc["traceEvents"]),
           "traced_count": rep["phase21.train_step"]["count"],
           "kftrace_slowest_rank1_steps": slow1,
           "critical_path_culprit": culprit,
           "chrome_events": len(chrome["traceEvents"]),
           "plain": plain, "launches": launches}
    print(f"phase 21 (d): device trace {files[0]} "
          f"({out['trace_events']} events): "
          + ", ".join(f"{k} {v['launches']} launches, "
                      f"{v['device_ms_per_launch'] or 0.0:.4f} ms"
                      for k, v in per_kernel.items())
          + f"; kftrace names rank 1 the slowest in faulted steps {slow1}; "
          f"--critical-path culprit {culprit['slowest_rank']} -> "
          f"{culprit['fastest_rank']}")
    return out


def _p21_shim(torch, np, ctx) -> dict:
    """(e): the torch shim on the card over three port peers; see
    phase_sentinel."""
    from kungfu_tpu_torch import torch as kt
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    model = ctx["model"]
    vocab = model.cfg.vocab_size
    ranks = range(P21_RANKS)
    trees = [model.init(torch.Generator().manual_seed(100 + r),
                        device="cuda") for r in ranks]
    treedef = tree_flatten(trees[0])[1]
    leaves = [[t.detach().clone().requires_grad_(True)
               for t in tree_flatten(tr)[0]] for tr in trees]
    del trees
    peers = start_local_cluster(
        P21_RANKS, env={"KF_ALLREDUCE_STRATEGY": "STAR"}, devices=["cuda"])
    grads0 = {}
    try:
        t0 = time.perf_counter()
        _run_ranks([lambda p=p, r=r: kt.broadcast_parameters(
            leaves[r], engine=p.engine()) for p, r in zip(peers, ranks)],
            timeout=600)
        bcast_s = time.perf_counter() - t0
        diff = [(r, i) for r in ranks for i, t in enumerate(leaves[r])
                if not torch.equal(t, leaves[0][i])]
        check(not diff, f"(e) after broadcast_parameters leaves differ: "
                        f"{diff[:4]}")
        before = [t.detach().clone() for t in leaves[0]]

        def rank_step(p, r):
            opt = kt.SynchronousSGDOptimizer(
                torch.optim.SGD(leaves[r], lr=P21_SGD_LR), engine=p.engine())
            ids, tg = _p21_batch(torch, np, vocab, r, 100)
            logits = model.apply(tree_unflatten(treedef, leaves[r]), ids,
                                 train=True, attn_fn=ctx["flash"])
            ctx["xent"].softmax_cross_entropy(logits, tg).mean().backward()
            grads0[r] = [t.grad.detach().clone() for t in leaves[r]]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        step_s = _run_ranks([lambda p=p, r=r: rank_step(p, r)
                             for p, r in zip(peers, ranks)], timeout=600)
    finally:
        for p in peers:
            p.close()
    diff = [(r, i) for r in ranks for i, t in enumerate(leaves[r])
            if not torch.equal(t, leaves[0][i])]
    check(not diff, f"(e) params differ across ranks after the step: "
                    f"{diff[:4]}")
    # the plain step: torch.optim.SGD on a copy of the start, its gradient
    # the mean of the three ranks' own.  The mean divides by a tensor: a
    # CUDA division by a Python number multiplies by its reciprocal, one
    # more rounding than the engine's (numpy's) division
    plain = [t.clone().requires_grad_(True) for t in before]
    three = torch.tensor(3.0, device=before[0].device)
    for i, t in enumerate(plain):
        t.grad = (grads0[0][i] + grads0[1][i] + grads0[2][i]) / three
    torch.optim.SGD(plain, lr=P21_SGD_LR).step()
    worst = 0.0
    for i, (t, want) in enumerate(zip(leaves[0], plain)):
        t, want = t.detach(), want.detach()
        check(torch.allclose(t, want, rtol=P21_SGD_RTOL, atol=0),
              f"(e) leaf {i} differs from a plain SGD step on the mean "
              f"gradient")
        worst = max(worst, ((t - want).abs()
                            / want.abs().clamp_min(1e-30)).max().item())
    on_card = all(t.is_cuda and t.grad is not None and t.grad.is_cuda
                  for r in ranks for t in leaves[r])
    check(on_card, "(e) a tensor left the card")
    out = {"broadcast_s": bcast_s,
           "step_ms": [s * 1e3 for s in step_s],
           "worst_rel_vs_plain": worst,
           "bitwise_vs_plain": all(torch.equal(t.detach(), w.detach())
                                   for t, w in zip(leaves[0], plain)),
           "leaves": len(leaves[0]),
           "params": sum(t.numel() for t in leaves[0])}
    print(f"phase 21 (e): broadcast_parameters of {out['params']} params in "
          f"{out['leaves']} leaves {bcast_s:.2f} s, the three ranks bitwise "
          f"equal; SynchronousSGDOptimizer(SGD) step "
          f"{[round(s, 1) for s in out['step_ms']]} ms, ranks bitwise equal,"
          f" worst relative difference from plain SGD on the mean gradient "
          f"{worst:.3e} (rtol {P21_SGD_RTOL}); every tensor on the card")
    return out


def phase_sentinel(torch, np, kernels, tr) -> dict:
    """Phase 21: the sentinel plane and the trace tools on the flagship.
    (a) three peers train the flagship at [P21_BATCH, P21_SEQ] a rank,
    allreduce a gradient slice on the host, paced, sampled by a fake-clock
    aggregator with ``Sentinel.from_env()``; a 0<->1 delay armed at step
    P21_CLEAN must raise ``regress:step_time_s`` once within two windows,
    with an incident naming rank 1, kfhist's replay equal, ``/alerts``,
    ``/decisions``, kftop and ``sentinel_signals``.  (b) the host bandit's
    swaps judged by the decision ledger.  (c) a CUDA-graph capture after
    the sentinel's warmup fires ``watermark:recompile_steady`` once.  (d)
    ``device_trace`` over one training step names rows 1-5 with the
    wrappers' counts; kftrace over (a)'s dumps.  (e) the torch shim:
    ``broadcast_parameters`` and one ``SynchronousSGDOptimizer`` step.
    Returns the result; its ``launches`` are (a), (d) and (e)'s."""
    import shutil
    import tempfile

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.monitor import ledger, timeline
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.utils.tree import tree_flatten

    t_phase = time.perf_counter()
    old = _set_env({**{k: None for k in P21_ENVS},
                    "KF_TPU_XENT": "fused", "KF_TPU_ATTN": None,
                    "KF_NATIVE_ENGINE": "0",
                    "KF_TPU_HOST_TRANSPORT": "python",
                    "KF_CONFIG_ENABLE_TRACE": "1"})
    xent.XENT_ENV.reload()
    ledger.reset()
    timeline.reset()
    chaos.reset()
    root = tempfile.mkdtemp(prefix="kfs")
    out = {}
    try:
        model = tr.Transformer(tr.TransformerConfig(**FLAGSHIP))
        params = model.init(torch.Generator().manual_seed(0), device="cuda")
        flash = attention.make_flash_attn()

        def loss_fn(p, b):
            logits = model.apply(p, b[0], train=True, attn_fn=flash)
            return xent.softmax_cross_entropy(logits, b[1]).mean()

        def grads(batch):
            return _grads(loss_fn, params, batch)

        def grad_slice(batch):
            # the first P21_GRAD_ELEMS of the flat gradient, to the host
            g = tree_flatten(grads(batch))[0][0].reshape(-1)
            return g[:P21_GRAD_ELEMS].float().cpu().numpy()

        def want(rank_steps):
            # every kernel's launches over ``rank_steps`` forward and
            # backward passes; no other kernel launches
            return {**{k: 0 for k in _counts(kernels)},
                    **_rank_launches(model.cfg, rank_steps)}

        ctx = {"model": model, "params": params, "flash": flash,
               "xent": xent, "loss_fn": loss_fn, "grads": grads,
               "grad_slice": grad_slice, "want": want}
        _reset(kernels)
        out["a"] = _p21_sentinel(torch, np, ctx, root)
        launches = _counts(kernels)
        check(launches == want(out["a"]["rank_steps"]),
              f"(a) {out['a']['rank_steps']} rank steps launched "
              f"{launches}, expected {want(out['a']['rank_steps'])}")
        data = grad_slice(_p21_batch(torch, np, model.cfg.vocab_size, 0, 0))
        _reset(kernels)
        out["b"] = _p21_ledger(np, root, data)
        _set_env({k: None for k in P21_ENVS})
        out["c"] = _p21_recompile(torch, ctx, root)
        _set_env({k: None for k in P21_ENVS})
        out["d"] = _p21_trace(torch, np, kernels, ctx, root, out["a"])
        launches = {k: v + out["d"]["launches"][k]
                    for k, v in launches.items()}
        del params
        torch.cuda.empty_cache()
        _set_env({"KF_NATIVE_ENGINE": None, "KF_TPU_HOST_TRANSPORT": None})
        _reset(kernels)
        out["e"] = _p21_shim(torch, np, ctx)
        check(_counts(kernels) == want(P21_RANKS),
              f"(e) one step on {P21_RANKS} ranks launched "
              f"{_counts(kernels)}, expected {want(P21_RANKS)}")
        launches = {k: v + n for (k, v), n in zip(
            launches.items(), (_counts(kernels)[k] for k in launches))}
    finally:
        _set_env(old)
        xent.XENT_ENV.reload()
        ledger.reset()
        chaos.reset()
        shutil.rmtree(root, ignore_errors=True)
    out["a"].pop("dumps")
    for k in P21_KERNELS:
        check(launches[k] > 0, f"phase 21 never launched {k}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"sentinel phase: {out['phase_s']:.2f} s; launches {launches}")
    return out


#: phase 22: the linter runs' time limit, seconds each
P22_TIMEOUT_S = 300

#: phase 22 (d): the source jit-sync reads and the card runs.  ``capture``
#: calls its parameter inside the capture, so both functions passed to it
#: are in capture scope; only ``scaled`` syncs
P22_CAPTURE_SRC = '''import torch


def scaled(x):
    s = x.sum()
    return x * s.item()


def scaled_on_device(x):
    s = x.sum()
    return x * s


def capture(fn, x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn(x)
    return graph, out


def both(x):
    return capture(scaled, x), capture(scaled_on_device, x)
'''


def _p22_capture(tmp: str) -> dict:
    """Phase 22 (d): the sync refused under capture, the same function
    without it captured and replayed, and jit-sync's view of the same
    source (see the module docstring)."""
    import importlib.util
    import threading

    import torch

    from kungfu_tpu_torch.analysis import core, jitpurity

    t0 = time.perf_counter()
    pkg = os.path.join(tmp, "kungfu_tpu_torch")
    os.makedirs(pkg)
    path = os.path.join(pkg, "p22_capture.py")
    with open(path, "w") as f:
        f.write(P22_CAPTURE_SRC)
    item_line = next(i + 1 for i, line in enumerate(
        P22_CAPTURE_SRC.splitlines()) if ".item()" in line)
    found = [(v.line, v.message) for v in jitpurity.check(tmp)]
    core.clear_parse_cache()
    check(len(found) == 1 and found[0][0] == item_line
          and "in capture scope `scaled`" in found[0][1],
          f"phase 22 (d): jit-sync over the capture source found {found}, "
          f"expected the .item() at line {item_line}")
    spec = importlib.util.spec_from_file_location("p22_capture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    x = torch.arange(1, 1025, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm both up before any capture
        for fn in (mod.scaled, mod.scaled_on_device):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    refused = {}

    def sync_capture():
        try:
            refused["graph"] = mod.capture(mod.scaled, x)
        except Exception as e:  # noqa: BLE001 - the refusal is the check
            # the sync's own error, which the capture's end then reports
            # as "a previous error during capture"
            first = e.__context__ or e
            refused["error"] = f"{type(first).__name__}: {first}"

    th = threading.Thread(target=sync_capture, name="p22-capture")
    th.start()
    th.join(timeout=60)
    check(not th.is_alive(), "phase 22 (d): the refused capture hung")
    check("error" in refused and "graph" not in refused,
          "phase 22 (d): a capture with .item() inside succeeded")
    refused.pop("graph", None)
    torch.cuda.synchronize()

    graph, out = mod.capture(mod.scaled_on_device, x)
    x.copy_(torch.arange(1025, 1, -1, dtype=torch.float32, device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    want = x * x.sum()
    err = float((out - want).abs().max())
    check(err == 0.0, f"phase 22 (d): the replayed graph is off by {err}")
    del graph, out, mod
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    check(wall < 5.0, f"phase 22 (d) took {wall:.2f} s, over 5 s")
    first = refused["error"].splitlines()[0][:200]
    print(f"phase 22 (d): .item() under capture refused ({first}); the "
          f"clean function captured and replayed (max abs err {err}); "
          f"jit-sync flags line {item_line} only; {wall:.2f} s")
    return {"refused": first, "replay_max_abs_err": err,
            "jit_sync_line": item_line, "wall_s": wall}


def phase_analysis() -> dict:
    """Phase 22: kf-lint and kf-verify over this checkout and over a
    planted copy; see the module docstring.  Each run is a subprocess
    of ``python -m kungfu_tpu_torch.analysis --json --timing``; all
    three start together and every one is stopped before this returns."""
    import re
    import shutil
    import tempfile

    from kungfu_tpu_torch.analysis import mutations
    from kungfu_tpu_torch.analysis.cli import CHECKERS, PROTO_CHECKERS

    timing_re = re.compile(r"^kflint: (\S+) (\d+) finding\(s\) in "
                             r"([0-9.]+) s$", re.M)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="kf-p22-")
    tmp_d = tempfile.mkdtemp(prefix="kf-p22d-")
    procs = {}
    try:
        mutations.plant_all(mutations.copy_port(HERE, tmp))
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.analysis", "--json",
               "--timing"]
        runs = {"tree": cmd + ["--root", HERE],
                "proto": cmd + ["--root", HERE, "--proto"],
                "planted": cmd + ["--root", tmp]}

        def run(key):
            t0 = time.perf_counter()
            proc = procs[key] = subprocess.Popen(
                runs[key], cwd=HERE, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
            try:
                so, se = proc.communicate(timeout=P22_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"phase 22 ({key}): the linter ran past "
                                   f"{P22_TIMEOUT_S} s") from None
            return {"rc": proc.returncode, "out": so, "err": se,
                    "wall_s": time.perf_counter() - t0}

        with ThreadPoolExecutor(max_workers=len(runs)) as pool:
            futs = {key: pool.submit(run, key) for key in runs}
            # (d) on the card while the linters run
            capture = _p22_capture(tmp_d)
            res = {key: f.result() for key, f in futs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(tmp_d, ignore_errors=True)

    out = {}
    want = {"tree": (0, sorted(CHECKERS)), "proto": (0, list(PROTO_CHECKERS)),
            "planted": (1, sorted(CHECKERS))}
    for label, key in (("a", "tree"), ("b", "proto"), ("c", "planted")):
        r = res[key]
        try:
            findings = json.loads(r["out"])
        except ValueError:
            raise SmokeFailure(f"phase 22 ({label}): no JSON findings, "
                               f"rc {r['rc']}: {r['err'][-2000:]}") from None
        timing = {m.group(1): (int(m.group(2)), float(m.group(3)))
                  for m in timing_re.finditer(r["err"])}
        for name in sorted(timing):
            n, secs = timing[name]
            print(f"phase 22 ({label}) {key}: {name} {n} finding(s) "
                  f"in {secs:.3f} s")
        rc, names = want[key]
        check(r["rc"] == rc, f"phase 22 ({label}): the linter exited "
                             f"{r['rc']}, expected {rc}: {r['err'][-2000:]}")
        check(sorted(timing) == names,
              f"phase 22 ({label}): ran {sorted(timing)}, expected {names}")
        if key == "planted":
            missed = mutations.unexplained(findings)
            check(not missed, f"phase 22 (c): the planted copy's findings "
                              f"are not the plants: {missed}")
        else:
            check(findings == [], f"phase 22 ({label}): {len(findings)} "
                                  f"finding(s) on the tree: "
                                  f"{findings[:5]}")
        print(f"phase 22 ({label}) {key}: exit {r['rc']}, "
              f"{len(findings)} finding(s), wall {r['wall_s']:.2f} s")
        out[key] = {"rc": r["rc"], "findings": len(findings),
                    "wall_s": r["wall_s"],
                    "checkers": {k: {"findings": v[0], "s": v[1]}
                                 for k, v in timing.items()}}
    out["plants"] = [{"checker": p.checker, "path": p.path,
                      "findings": p.count} for p in mutations.PLANTS]
    out["capture"] = capture
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"analysis phase: {out['phase_s']:.2f} s")
    return out


def _ptxas_report(log: str) -> dict:
    """{mangled kernel name: its ptxas lines} from an ``-Xptxas -v`` log."""
    import re

    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w]+)'?", line)
        if m:
            cur = m.group(1)
            report.setdefault(cur, [])
        elif cur is not None and ("registers" in line or "spill" in line):
            report[cur].append(line.strip().replace("ptxas info    : ", ""))
    return report


def _sass_counts(torch, path) -> dict:
    """{mangled kernel name: {"HGMMA": n, "UTMALDG": n}} for the wgmma
    kernels in a built library, from ``cuobjdump --dump-sass``."""
    import re
    from pathlib import Path

    from kungfu_tpu_torch.ops.cuda import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-sass", str(path)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump exited {out.returncode}: "
          f"{out.stderr.strip()[:500]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in WGMMA_KERNELS) else None
            if cur:
                counts[cur] = {"HGMMA": 0, "UTMALDG": 0}
        elif cur:
            for op in ("HGMMA", "UTMALDG"):
                counts[cur][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def build_all(torch, attention, lmk, ringk) -> dict:
    """nvcc for each CUDA source, all started together; then each wgmma
    kernel's ptxas report (no spills allowed) and SASS counts (HGMMA and
    UTMALDG must be there)."""
    import re

    t0 = time.perf_counter()
    loaders = (attention.load, attention.load_bwd, lmk.load, ringk.load)
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        futures = [pool.submit(fn) for fn in loaders]
        built = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    print(f"build: {wall:.2f} s wall")
    info = {"wall_s": wall, "kernels": {}}
    for b in built:
        print(f"  {b.path.name}: nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            # "Performance": ptxas's warning that it serialised wgmma
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Performance")):
                print(f"  ptxas: {line.strip()}")
    for b in built[:3]:
        report = _ptxas_report(b.log)
        for fn, counts in _sass_counts(torch, b.path).items():
            lines = report.get(fn, [])
            print(f"wgmma kernel {fn}: {'; '.join(lines)}; SASS HGMMA "
                  f"{counts['HGMMA']}, UTMALDG {counts['UTMALDG']}")
            check(bool(lines), f"{fn}: no ptxas report")
            check(all(re.search(r"\b0 bytes spill stores", ln)
                      for ln in lines if "spill" in ln),
                  f"{fn} spills registers: {lines}")
            check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                  f"{fn}: SASS without wgmma or TMA loads: {counts}")
            info["kernels"][fn] = {"ptxas": lines, **counts}
    names = " ".join(info["kernels"])
    check(all(k in names for k in WGMMA_KERNELS)
          and len(info["kernels"]) == WGMMA_INSTANTIATIONS,
          f"expected {WGMMA_INSTANTIATIONS} wgmma kernels (flash at D "
          f"32/64/96/128/256; LM-head forward, dh and dW for f32 and bf16 "
          f"W), found {names}")
    for d in (96, 256):  # the new widths: every flash kernel at both
        for k in WGMMA_KERNELS[:3]:
            check(any(k in fn and f"ILi{d}E" in fn for fn in info["kernels"]),
                  f"no {k} at D = {d}")
    return info


#: phase 23: bert_base() in a provisioned world of WORLD_SLOTS worker
#: processes on the card (``python -m kungfu_tpu_torch -np 2 -H
#: 127.0.0.1:4 -w -device-world``), active in turn per WORLD_SCHEDULE,
#: WORLD_STEPS S-SGD steps an epoch under pallas_ring on [BERT_ROWS,
#: BERT_SEQ] a rank: the ring kernels across processes
WORLD_SLOTS, WORLD_SCHEDULE, WORLD_STEPS = 4, (2, 4, 2), 2
#: the launch of phase 23, command included, at most
WORLD_TIMEOUT_S = 600
#: launches a rank's S-SGD step makes of each ring kernel: one fused
#: gradient, one reduce-scatter and one all-gather
WORLD_RING_PER_STEP = 1
#: timed launches of each ring kernel at the process-spanning shape
WORLD_TIMED = 10
#: (a) ZeRO-3 steps an epoch on their own bert_base() params (SGD with
#: momentum, the parameter shard and the momentum re-carved at each
#: resize), buckets of 32 MiB: 16 buckets at two processes and at four
WORLD_ZERO3_STEPS = 2
WORLD_ZERO3_BUCKET = 32 << 20
#: (b) per-replica SMA steps at the four-process epoch, the weight
#: average by all_reduce's psum path (the ring kernels do not run in
#: it); each rank's replica starts WORLD_SMA_SPREAD times a normal draw
#: away from the S-SGD params, so that the first step's pull
#: alpha * (avg - p), about 1e-4 an entry, stands well above the f32
#: rounding of the update at BERT's parameter scale
WORLD_SMA_STEPS = 2
WORLD_SMA_SPREAD = 1e-3
#: (c) ShardedTrainer steps on the flagship over dp=2 x tp=2 across the
#: four processes, at the four-process epoch: the global batch [4, 1024]
#: (each dp replica [2, 1024]), the reference trainer's sgd(0.01)
WORLD_SHARDED_PLAN = dict(dp=2, tp=2)
WORLD_SHARDED_STEPS = 2
WORLD_SHARDED_BATCH, WORLD_SHARDED_SEQ = 4, 1024
#: the check of ``lift``'s backward across the four processes: one f32
#: row of this length a rank
WORLD_LIFT_LEN = 1 << 16


def _world_batch(torch, np, vocab: int, epoch: int, step: int, ranks: int):
    """The global batch of one step of phase 23: ids and targets
    [ranks * BERT_ROWS, BERT_SEQ], a function of (23, epoch, step) only,
    so every process passes the same one."""
    rng = np.random.default_rng([23, epoch, step])
    return tuple(torch.from_numpy(rng.integers(
        0, vocab, size=(ranks * BERT_ROWS, BERT_SEQ))).cuda()
        for _ in range(2))


def _world_ring_check(torch, comm, kernels, loss_fn, params, shard) -> dict:
    """Phase 23's check of the ring kernels across processes, run by every
    active process of the four-process epoch after its steps (its
    launches are not the main path's): one rank's fused gradient through
    the cross-process reduce-scatter and all-gather, each timed on the
    host with its barrier waits, held bitwise against the single-process
    stacked kernels and the plain versions on the four gathered buffers;
    then each kernel timed at this shape, every process launching at
    once, and (process 0, the others waiting) the stacked single call,
    the plain version and the PyTorch call on the same buffers."""
    from kungfu_tpu_torch.ops import collectives as rc
    from kungfu_tpu_torch.ops.cuda import collectives as ringk
    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.ops.schedules import _flatten_pad
    from kungfu_tpu_torch.parallel.train import per_rank_grads

    span, k, first = comm.span, comm.size, comm.first_rank
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = []
    per_rank_grads(loss_fn, params, [shard], lambda r, g: grads.extend(g))
    buf, _ = fuse(grads)
    del grads
    parts, _ = _flatten_pad(buf[None], k, "sum")
    del buf
    flat = parts.reshape(1, -1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chunk = flat.shape[1] // k
    cut = rc.band_cut(chunk, flat.dtype, False)
    b0 = span.stats["barrier_s"]
    with comm.world():
        rs = rc.ring_reduce_scatter(flat, "kf_local", impl="pallas")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        b1 = span.stats["barrier_s"]
        ag = rc.ring_all_gather(rs, "kf_local", impl="pallas")
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    b2 = span.stats["barrier_s"]
    out = {"k": k, "chunk": chunk, "cut": cut,
           "grads_ms": (t1 - t0) * 1e3, "rs_step_ms": (t2 - t1) * 1e3,
           "ag_step_ms": (t3 - t2) * 1e3,
           "rs_barrier_ms": (b1 - b0) * 1e3, "ag_barrier_ms": (b2 - b1) * 1e3,
           "rs_digest": _device_digest(torch, rs[0]),
           "ag_digest": _device_digest(torch, ag[0])}
    rows = span.rows

    def timed(x, launch):
        # every process launches WORLD_TIMED times on the rows it
        # published; the reads end and all meet before anyone publishes
        (views,) = span.publish([x])
        ring = [views[g // rows][g % rows] for g in range(k)]
        launch(ring)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        for _ in range(WORLD_TIMED):
            launch(ring)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t
        span.barrier()
        return start.elapsed_time(end) / WORLD_TIMED, wall * 1e3 / WORLD_TIMED

    rs_out = torch.empty((1, chunk), dtype=flat.dtype, device=flat.device)
    ag_out = torch.empty((1, k * chunk), dtype=flat.dtype, device=flat.device)
    out["rs_ms"], out["rs_wall_ms"] = timed(flat, lambda ring: (
        ringk.reduce_scatter_rows(ring, [rs_out[0]], first, cut)))
    out["ag_ms"], out["ag_wall_ms"] = timed(rs, lambda ring: (
        ringk.all_gather_rows(ring, [ag_out[0]], first, cut)))
    del rs_out, ag_out
    # the stacked kernels and the plain versions on the four published
    # buffers, one process at a time (the others wait at the barrier), so
    # that only one process holds the whole [k, k * chunk] buffer and
    # their outputs at once; process 0 also times them in its turn
    (views,) = span.publish([flat])
    for q in range(span.procs):
        if q == span.index:
            full = torch.cat(views, 0)
            st_rs = ringk.reduce_scatter(full, cut)
            st_ag = ringk.all_gather(st_rs, cut)
            pl_rs = rc.ring_reduce_scatter_reference(full, cut)
            pl_ag = rc.ring_all_gather_reference(pl_rs, cut)
            out.update(
                stacked_rs_digest=_device_digest(torch, st_rs[first]),
                stacked_ag_digest=_device_digest(torch, st_ag[first]),
                rs_vs_stacked=bool(torch.equal(rs[0], st_rs[first])),
                ag_vs_stacked=bool(torch.equal(ag[0], st_ag[first])),
                rs_vs_plain=bool(torch.equal(rs[0], pl_rs[first])),
                ag_vs_plain=bool(torch.equal(ag[0], pl_ag[first])))
            del st_ag, pl_rs, pl_ag
            if first == 0:
                out["stacked_rs_ms"] = device_ms(
                    torch, lambda: ringk.reduce_scatter(full, cut), 3, 5)
                out["stacked_ag_ms"] = device_ms(
                    torch, lambda: ringk.all_gather(st_rs, cut), 3, 5)
                out["plain_rs_ms"] = device_ms(
                    torch, lambda: rc.ring_reduce_scatter_reference(full, cut),
                    1, 3)
                out["plain_ag_ms"] = device_ms(
                    torch, lambda: rc.ring_all_gather_reference(st_rs, cut),
                    1, 3)
                out["library_rs_ms"] = device_ms(
                    torch, lambda: full.view(k, k, chunk).sum(0), 3, 5)
                out["library_ag_ms"] = device_ms(
                    torch, lambda: st_rs.reshape(1, -1).expand(k, -1)
                    .contiguous(), 3, 5)
            del full, st_rs
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        span.barrier()
    span.drain()
    del views, flat, parts, rs, ag
    torch.cuda.empty_cache()
    return out


def _world_steps(torch, kernels, span, want, run, batches) -> dict:
    """``run(batch) -> loss`` over ``batches``, launches counted from zero
    a step and held to ``want``: each step's loss (repr), host ms around
    a synchronised step, the span's barrier ms inside it, the launches."""
    out = {"losses": [], "step_ms": [], "barrier_ms": [],
           "launches": {key: 0 for key in want}}
    for i, batch in enumerate(batches):
        _reset(kernels)
        torch.cuda.synchronize()
        b0 = span.stats["barrier_s"]
        t0 = time.perf_counter()
        loss = float(run(batch))  # synchronises
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["barrier_ms"].append((span.stats["barrier_s"] - b0) * 1e3)
        out["losses"].append(repr(loss))
        check(math.isfinite(loss), f"step {i}: loss {loss}")
        per = _counts(kernels)
        check(per == want, f"step {i} launched {per}, expected {want}")
        for key, n in per.items():
            out["launches"][key] += n
    return out


def _leaf_names(tree) -> list:
    """``path/of/leaf`` names in ``tree_flatten`` order."""
    from kungfu_tpu_torch.utils.tree import tree_flatten_with_path

    return ["/".join(map(str, path))
            for path, _ in tree_flatten_with_path(tree)[0]]


def _rel_text(rel: dict) -> str:
    """A :func:`_leaf_rel` result as text."""
    text = f"worst leaf rel L2 {rel['worst']:.3e} ({rel['leaf']})"
    if "qk_worst" in rel:
        text += f", q/k {rel['qk_worst']:.3e} ({rel['qk_leaf']})"
    return text


def _apply_text(a: dict) -> str:
    """An :func:`_apply_differs` result as text."""
    return (f"{a['leaves'] - len(a['differ'])}/{a['leaves']} leaves "
            f"bitwise, largest |difference| {a['max_abs']}")


def _leaf_rel(got: dict, ref: dict, qk_apart: bool) -> dict:
    """The worst relative L2 per leaf (:func:`_rel_l2_leaves`) and its
    leaf.  With ``qk_apart`` the q/k leaves' worst stands apart, as phase
    20 keeps it (``KFRUN_QK_LEAVES``: at BERT's nearly uniform attention
    the flash backward's q and k gradients stand further from the plain
    path's); it is reported, not held."""
    rel = _rel_l2_leaves(got, ref)
    qk = {n: x for n, x in rel.items() if qk_apart
          and any(k in f"/{n}/" for k in KFRUN_QK_LEAVES)}
    rest = {n: x for n, x in rel.items() if n not in qk}
    out = {"worst": max(rest.values()), "leaf": max(rest, key=rest.get)}
    if qk:
        out.update(qk_worst=max(qk.values()), qk_leaf=max(qk, key=qk.get))
    return out


def _apply_differs(torch, new: dict, start: dict, grad: dict,
                   lr: float) -> dict:
    """SGD's apply from ``start`` by ``grad``, as ``sgd`` and
    ``apply_updates`` compute it (``start + (-lr * grad)``), held bit for
    bit against ``new`` leaf by leaf: the leaves that differ and the
    largest |difference|.  A relative check of ``(start - new) / lr``
    cannot stand in for it: where ``lr * grad`` falls below half an f32
    ulp of the param (a layer norm's scale at 1, BERT's key weights at
    init) the step rounds it away."""
    differ, worst = [], 0.0
    for n, t in new.items():
        d = t - (start[n] + (-lr * grad[n]))
        if bool(d.any()):
            differ.append(n)
            worst = max(worst, d.abs().max().item())
    return {"leaves": len(new), "differ": differ, "max_abs": worst}


def _world_zero3(torch, np, kernels, comm, peer, model, loss_fn, params0,
                 carry: dict, v: int, want: dict) -> dict:
    """Phase 23 (a): ``WORLD_ZERO3_STEPS`` ZeRO-3 steps of bert_base()
    under pallas_ring over the epoch's communicator.  The parameter
    shard and the momentum come from ``params0`` at epoch 0 and from the
    last epoch's snapshots (``carry``) after, through ``zero_reshard``;
    the epoch ends by snapshotting both again.  At epoch 0 every process
    also takes its rank's first step through the plain versions and
    means the gradients across the processes; after the first step the
    ZeRO-3 step's mean gradient (its momentum, gathered) is held against
    that plain mean gradient leaf by leaf, and its gathered params
    against SGD's apply of that momentum (:func:`_apply_differs`)."""
    from kungfu_tpu_torch.ops import collective as coll
    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.train import split_batch
    from kungfu_tpu_torch.parallel.zero import (zero_reshard, zero_snapshot,
                                                zero_train_step)
    from kungfu_tpu_torch.utils.tree import tree_leaves

    vocab, span = model.cfg.vocab_size, comm.span
    z = zero_train_step(loss_fn, sgd(BERT_LR, momentum=BERT_MOMENTUM), comm,
                        stage=3, bucket_bytes=WORLD_ZERO3_BUCKET,
                        schedule="pallas_ring")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, o = z.init_params(params0), z.init_opt(params0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if v:
        # rank 0 holds the snapshots; the others pass None and receive
        p = zero_reshard(p, params0, comm, peer, snapshot=carry.get("p"))
        o = zero_reshard(o, params0, comm, peer, snapshot=carry.get("o"))
    torch.cuda.synchronize()
    init_ms, recarve_ms = ((t1 - t0) * 1e3,
                           (time.perf_counter() - t1) * 1e3)
    buckets = len(z._require_g3().widths)  # noqa: SLF001
    want = dict(want, ring_rs=buckets, ring_ag=buckets)
    batches = [_world_batch(torch, np, vocab, v, s, comm.size)
               for s in range(WORLD_ZERO3_STEPS)]
    plain = None
    names = _leaf_names(params0)
    if v == 0:
        # the plain first step: each rank's plain loss and gradient on
        # its shard, meaned across the processes (the plain psum path)
        shard = split_batch(batches[0], comm.size)[comm.first_rank]
        loss_p, grads_p = _plain_loss_grads(torch, kernels, model, params0,
                                            shard)
        flat, _ = fuse(grads_p)
        del grads_p
        with comm.world():
            mean = coll.all_reduce(flat[None], comm.axis, op="mean")[0]
            loss_p = float(coll.all_reduce(loss_p.reshape(1), comm.axis,
                                           op="mean")[0])
        del flat
        mean_p, off = {}, 0
        for name, leaf in zip(names, tree_leaves(params0)):
            mean_p[name] = mean[off:off + leaf.numel()].view(leaf.shape)
            off += leaf.numel()
    state = {"p": p, "o": o}

    def run(batch):
        state["p"], state["o"], loss = z.step(state["p"], state["o"], batch)
        return loss

    out = _world_steps(torch, kernels, span, want, run, batches[:1])
    if v == 0:
        # one SGD-momentum step from zero momentum: the momentum is the
        # step's mean gradient, and the update is BERT_LR times it
        grad = dict(zip(names, tree_leaves(
            z.gather_params(state["o"].trace))))
        new = dict(zip(names, tree_leaves(z.gather_params(state["p"]))))
        loss_k = float(out["losses"][0])
        plain = {"loss": loss_k, "loss_plain": loss_p,
                 "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                 "grad": _leaf_rel(grad, mean_p, qk_apart=True),
                 "apply": _apply_differs(torch, new, dict(zip(
                     names, tree_leaves(params0))), grad, BERT_LR)}
        del grad, new, mean_p, mean
    rest = _world_steps(torch, kernels, span, want, run, batches[1:])
    for key in ("losses", "step_ms", "barrier_ms"):
        out[key] += rest[key]
    for key, n in rest["launches"].items():
        out["launches"][key] += n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry["o"] = zero_snapshot(state["o"], peer)
    carry["p"] = zero_snapshot(state["p"], peer)
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    out.update(buckets=buckets, init_ms=init_ms, recarve_ms=recarve_ms,
               snapshot_ms=snapshot_ms, plain=plain,
               shard_digest=_device_digest(torch, state["p"]))
    return out


def _sma_replica(torch, leaves, rank: int) -> list:
    """Rank ``rank``'s starting replica of phase 23 (b): each leaf plus
    ``WORLD_SMA_SPREAD`` times a normal draw seeded by the rank, so any
    process can make every rank's replica."""
    gen = torch.Generator(device=leaves[0].device).manual_seed(23_000 + rank)
    return [t + WORLD_SMA_SPREAD * torch.randn(
        t.shape, generator=gen, device=t.device, dtype=t.dtype)
        for t in leaves]


def _world_sma(torch, np, kernels, comm, model, loss_fn, params, v: int,
               want: dict) -> dict:
    """Phase 23 (b): ``WORLD_SMA_STEPS`` per-replica SMA steps (alpha
    ``SMA_ALPHA``, the weights averaged by ``all_reduce``'s psum path,
    the reference's) from the S-SGD params, each rank's replica moved
    apart first (:func:`_sma_replica`) so that the first step's average
    pulls; this process's replica rows.  After the first step each row
    is held against the plain SMA step: its momentum (the row's local
    gradient) against the plain versions' gradient on the rank's shard,
    and its update against ``-BERT_LR * g + SMA_ALPHA * (avg - p)``, the
    average made here from every rank's replica."""
    from kungfu_tpu_torch.optimizers import sgd, synchronous_averaging
    from kungfu_tpu_torch.parallel.train import (dp_train_step, split_batch,
                                                 stack_for_replicas)
    from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                             tree_unflatten)

    tx = synchronous_averaging(sgd(BERT_LR, momentum=BERT_MOMENTUM),
                               comm.axis, alpha=SMA_ALPHA)
    step = dp_train_step(loss_fn, tx, comm, replicated_params=False)
    leaves, treedef = tree_flatten(params)
    names = _leaf_names(params)
    ranks = range(comm.first_rank, comm.first_rank + comm.addressable_n)
    starts, avg = {}, [torch.zeros_like(t) for t in leaves]
    for r in range(comm.size):
        rep = _sma_replica(torch, leaves, r)
        avg = [a + t for a, t in zip(avg, rep)]
        if r in ranks:
            starts[r] = rep
    avg = [a / comm.size for a in avg]
    state = {"p": tree_unflatten(treedef, [
        torch.stack([starts[r][i] for r in ranks])
        for i in range(len(leaves))]),
        "o": stack_for_replicas(tx.init(params), comm.addressable_n)}
    want = dict(want, ring_rs=0, ring_ag=0)

    def run(batch):
        state["p"], state["o"], loss = step(state["p"], state["o"], batch)
        return loss

    batches = [_world_batch(torch, np, model.cfg.vocab_size, v, 10 + s,
                            comm.size) for s in range(WORLD_SMA_STEPS)]
    out = _world_steps(torch, kernels, comm.span, want, run, batches[:1])
    shards = split_batch(batches[0], comm.size)
    plain = []
    for j, r in enumerate(ranks):
        start = starts.pop(r)
        loss_p, g = _plain_loss_grads(torch, kernels, model,
                                      tree_unflatten(treedef, start),
                                      shards[r])
        got_g = {n: t[j] for n, t in zip(
            names, tree_leaves(state["o"].trace))}
        got_u = {n: t[j] - s for n, t, s in zip(
            names, tree_leaves(state["p"]), start)}
        want_u = {n: -BERT_LR * gi + SMA_ALPHA * (a - s) for n, gi, a, s
                  in zip(names, g, avg, start)}
        plain.append({"rank": r, "loss_plain": float(loss_p),
                      "grad": _leaf_rel(got_g, dict(zip(names, g)),
                                        qk_apart=True),
                      "update": _leaf_rel(got_u, want_u, qk_apart=False)})
        del start, g, got_g, got_u, want_u
    del avg
    rest = _world_steps(torch, kernels, comm.span, want, run, batches[1:])
    for key in ("losses", "step_ms", "barrier_ms"):
        out[key] += rest[key]
    for key, n in rest["launches"].items():
        out["launches"][key] += n
    out.update(leaves=len(leaves), plain=plain)
    return out


def _world_lift_check(torch, comm) -> dict:
    """Phase 23's check of the differentiable ``lift`` across the
    processes, run by every process of the four-process epoch: nothing
    of (a)-(c) differentiates through ``lift`` (the tp pair, ZeRO-3's
    gather and the ring pair have backwards of their own, whose
    collectives run ``lift`` forward only).  Each collective's output
    and input gradient over the span, on this process's rows of seeded
    ``[n, WORLD_LIFT_LEN]`` inputs and cotangents, held bit for bit
    against the same collective over a one-process communicator of n
    co-resident ranks on the whole inputs; the cases that differ."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collective as coll

    n, lo, rows, ax = comm.size, comm.first_rank, comm.addressable_n, \
        "kf_local"
    shift = [((j + 1) % n, j) for j in range(n)]
    cases = {
        "all_reduce_sum": lambda x: coll.all_reduce(x, ax),
        "all_reduce_mean": lambda x: coll.all_reduce(x, ax, op="mean"),
        "all_reduce_max": lambda x: coll.all_reduce(x, ax, op="max"),
        "all_gather": lambda x: coll.all_gather(x, ax, tiled=True),
        "broadcast": lambda x: coll.broadcast(x, ax, root=1),
        "ppermute": lambda x: coll.ppermute(x, ax, shift),
        "all_to_all": lambda x: coll.all_to_all(
            x.reshape(x.shape[0], n, -1), ax, 0, 1),
        "chain": lambda x: coll.all_gather(
            coll.all_reduce(x, ax) * x, ax, tiled=True).tanh(),
    }
    one = Communicator(devices=[comm.device] * n, local_size=n)

    def vjp(c, fn, x, ct):
        x = x.clone().requires_grad_(True)
        with c.world():
            y = fn(x)
            (g,) = torch.autograd.grad(y, x, ct)
        return y.detach(), g

    differ = []
    for i, (name, fn) in enumerate(cases.items()):
        gen = torch.Generator(device=comm.device).manual_seed(2300 + i)
        x = torch.randn((n, WORLD_LIFT_LEN), generator=gen,
                        device=comm.device)
        with one.world():
            shape = fn(x).shape
        ct = torch.randn(shape, generator=gen, device=comm.device)
        y1, g1 = vjp(one, fn, x, ct)
        y, g = vjp(comm, fn, x[lo:lo + rows], ct[lo:lo + rows])
        if not (torch.equal(y, y1[lo:lo + rows])
                and torch.equal(g, g1[lo:lo + rows])):
            differ.append(name)
    return {"cases": list(cases), "differ": differ}


def _world_sharded(torch, np, kernels, comm, tr, attention) -> dict:
    """Phase 23 (c) under ``KF_TPU_XENT=fused``, as phase 17 runs
    (:func:`_world_sharded_steps`)."""
    from kungfu_tpu_torch.ops import xent

    old = _set_env({"KF_TPU_XENT": "fused"})
    xent.XENT_ENV.reload()
    try:
        return _world_sharded_steps(torch, np, kernels, comm, tr, attention)
    finally:
        _set_env(old)
        xent.XENT_ENV.reload()


def _world_sharded_steps(torch, np, kernels, comm, tr, attention) -> dict:
    """Phase 23 (c): ``WORLD_SHARDED_STEPS`` steps of the flagship
    through ``ShardedTrainer(ParallelPlan(dp=2, tp=2,
    collective_schedule="pallas_ring"), devices=comm)``: the mesh spans
    the four processes, one rank each, so tp's pair and dp's gradient
    sync both cross processes.  Process 0 first takes the one-rank
    model's loss and gradient on the same batch (phase 17's reference);
    after the first step the synchronized gradient the optimizer
    received, gathered from every process, is held against that
    gradient leaf by leaf, and the gathered params against SGD's apply
    of it (:func:`_apply_differs`).  Each process's loss and the digest
    of the gathered params."""
    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.train import ParallelPlan, ShardedTrainer
    from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                             tree_unflatten)

    cfg = tr.TransformerConfig(**{**FLAGSHIP, "max_seq": WORLD_SHARDED_SEQ})
    model = tr.Transformer(cfg)
    tparams = model.init(torch.Generator().manual_seed(0),
                         device=comm.device)
    rng = np.random.default_rng([23, 3])
    batch = tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(WORLD_SHARDED_BATCH, WORLD_SHARDED_SEQ)))
        .to(comm.device) for _ in range(2))
    one = None
    if comm.first_rank == 0:
        leaves, treedef = tree_flatten(tparams)
        own = [t.detach().requires_grad_(True) for t in leaves]
        loss = model.loss(tree_unflatten(treedef, own), batch, train=False,
                          attn_fn=attention.make_flash_attn())
        grads = torch.autograd.grad(loss, own)
        one = {"loss": float(loss.detach()),
               "grads": tr.flatten(tree_unflatten(treedef, list(grads)))}
        del own, loss, grads
    seen = {}
    trainer = ShardedTrainer(cfg, ParallelPlan(
        **WORLD_SHARDED_PLAN, collective_schedule="pallas_ring"),
        tx=_recording(sgd(SHARDED_LR), seen), devices=comm)
    params = trainer.from_transformer_params(tparams)
    del tparams
    state = {"s": {"params": params, "opt_state": trainer.tx.init(params),
                   "step": 0}}
    n_leaves = len(tree_leaves(params))
    L = cfg.n_layers
    want = {key: 0 for key in _counts(kernels)}
    want.update(flash_fwd=L, flash_bwd_dq=L, flash_bwd_dkv=L, xent_fwd=1,
                xent_bwd=1, ring_rs=n_leaves, ring_ag=n_leaves)

    def run(b):
        state["s"], loss = trainer.step(state["s"], b)
        return loss

    out = _world_steps(torch, kernels, comm.span, want, run, [batch])
    # every process takes part in the gathers (the step is functional:
    # ``params`` still holds the start); process 0 compares
    grad = _global_flat(trainer, seen.pop("grads"), L)
    new = _global_flat(trainer, state["s"]["params"], L)
    start = _global_flat(trainer, params, L)
    del params
    if one is not None:
        first = float(out["losses"][0])
        out["plain"] = {
            "one_rank_loss": one["loss"],
            "loss_rel": abs(first - one["loss"]) / abs(one["loss"]),
            "grad": _leaf_rel(grad, one["grads"], qk_apart=False),
            "apply": _apply_differs(torch, new, start, grad, SHARDED_LR)}
        del one
    del grad, new, start
    rest = _world_steps(torch, kernels, comm.span, want, run,
                        [batch] * (WORLD_SHARDED_STEPS - 1))
    for key in ("losses", "step_ms", "barrier_ms"):
        out[key] += rest[key]
    for key, n in rest["launches"].items():
        out["launches"][key] += n
    flat, _ = fuse(trainer.gather_params(state["s"]["params"]))
    out.update(leaves=n_leaves, params_digest=_device_digest(torch, flat))
    return out


def world_worker_main(argv) -> int:
    """``--world-worker``: phase 23's program, one process a world slot
    under ``python -m kungfu_tpu_torch -w -device-world``: the reference's
    ``examples/device_elastic.py`` loop (a psum of world_rank + 1 an
    epoch, standby slots waiting in ``await_rejoin``) with bert_base()
    S-SGD steps under pallas_ring over the re-carved communicator, then
    (a) ZeRO-3 steps, and at four processes (b) SMA and (c) the sharded
    flagship, on the same communicator.  It
    prints the ``KFEPOCH`` and ``KFDONE`` lines and writes one JSON object
    a line to ``--out``/slot{world_rank}.jsonl."""
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(prog="chip_smoke.py --world-worker")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.initializer import resync_parameters
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.ops.cuda import collectives as ringk
    from kungfu_tpu_torch.ops.cuda import lm_head as lmk
    from kungfu_tpu_torch.ops.triton import xent as xk
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import (dp_train_step,
                                                 per_rank_grads, split_batch)
    from kungfu_tpu_torch.peer import Peer

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (attention, xk, lmk, ringk)
    proc0 = float(os.environ["KF_PROC_START_TIMESTAMP"])
    peer = Peer()
    peer.start()
    world = peer.config.world_peers
    check(world is not None, "phase 23's worker runs under -device-world")
    wr = world.rank(peer.config.self_id)
    path = os.path.join(args.out, f"slot{wr}.jsonl")

    def emit(kind: str, **rec) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"kind": kind, "slot": wr,
                                "wall": time.time(), **rec}) + "\n")

    emit("up", pid=os.getpid(), up_s=time.time() - proc0,
         boot_ms=peer._pworld.boot_s * 1e3)  # noqa: SLF001
    model = tr.bert_base()
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    # (a)'s starting params and the carve's structure after (the steps
    # are functional: nothing writes into these tensors)
    params0 = params
    z3_carry = {}
    flash = attention.make_flash_attn()

    def loss_fn(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=flash)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    opt = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    opt_state = None
    want = {key: 0 for key in _counts(kernels)}
    want.update(flash_fwd=model.cfg.n_layers, flash_bwd_dq=model.cfg.n_layers,
                flash_bwd_dkv=model.cfg.n_layers, xent_fwd=1, xent_bwd=1,
                ring_rs=WORLD_RING_PER_STEP, ring_ag=WORLD_RING_PER_STEP)
    schedule = list(WORLD_SCHEDULE)
    deadline = time.time() + WORLD_TIMEOUT_S
    mem = {}

    def mark(section: str) -> None:
        # this process's peak GiB allocated and reserved by PyTorch in the
        # section that just ended (the span's buffers are not PyTorch's)
        mem[section] = [torch.cuda.max_memory_allocated() / 2 ** 30,
                        torch.cuda.max_memory_reserved() / 2 ** 30]
        torch.cuda.reset_peak_memory_stats()
    while time.time() < deadline:
        if peer.standby:
            try:
                _, version = peer.observe_stage()
            except (OSError, ValueError, KeyError):
                time.sleep(0.2)
                continue
            if version >= len(schedule):
                break
            peer.await_rejoin(timeout=2.0)
            continue
        v = peer.cluster_version
        comm = peer.communicator()
        if v == 0:
            comm.set_strategy("pallas_ring")
        mem = {}
        torch.cuda.reset_peak_memory_stats()
        x = torch.full((comm.addressable_n,), float(wr + 1), device="cuda")
        got = float(comm.all_reduce(x)[0])
        expect = float(sum(world.rank(w) + 1 for w in peer.cluster.workers))
        check(got == expect, f"slot {wr} epoch {v}: psum {got} != {expect}")
        tx = synchronous_sgd(opt, comm.axis, schedule="pallas_ring",
                             fuse_grads=True)
        step = dp_train_step(loss_fn, tx, comm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = opt_state if opt_state is not None else tx.init(params)
        params, opt_state = resync_parameters((params, state), peer,
                                              comm=comm, root=0)
        torch.cuda.synchronize()
        resync_ms = (time.perf_counter() - t0) * 1e3
        plain = None
        if v == 0 and comm.first_rank == 0:
            # rank 0's first step through the kernels, then the same step
            # through their plain versions (phase 20's check)
            batch = _world_batch(torch, np, model.cfg.vocab_size, v, 0,
                                 comm.size)
            shard = split_batch(batch, comm.size)[0]
            grads = []
            outs, _ = per_rank_grads(loss_fn, params, [shard],
                                     lambda r, g: grads.extend(g))
            plain = _kfrun_plain_check(torch, kernels, model, params, shard,
                                       float(outs[0]), grads,
                                       what="phase 23 rank 0")
            del grads
        span = comm.span
        b0, open_s = span.stats["barrier_s"], span.stats["open_s"]
        losses, step_ms, first_wall = [], [], None
        launches = {key: 0 for key in want}
        for s in range(WORLD_STEPS):
            batch = _world_batch(torch, np, model.cfg.vocab_size, v, s,
                                 comm.size)
            _reset(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))  # synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if first_wall is None:
                first_wall = time.time()
            per = _counts(kernels)
            check(per == want, f"slot {wr} epoch {v} step {s} launched "
                  f"{per}, expected {want}")
            for key, n in per.items():
                launches[key] += n
        barrier_ms = (span.stats["barrier_s"] - b0) * 1e3
        mark("ssgd")
        ring = sma = sharded = lift = None
        if comm.size == WORLD_SLOTS:
            shard = split_batch(batch, comm.size)[comm.first_rank]
            ring = _world_ring_check(torch, comm, kernels, loss_fn, params,
                                     shard)
            mark("ring")
            lift = _world_lift_check(torch, comm)
            mark("lift")
        # (a) ZeRO-3 every epoch; (b) SMA and (c) the sharded flagship at
        # four processes, each on the same communicator
        base = {key: n for key, n in want.items()}
        zero3 = _world_zero3(torch, np, kernels, comm, peer, model, loss_fn,
                             params0, z3_carry, v, base)
        torch.cuda.empty_cache()
        mark("zero3")
        if comm.size == WORLD_SLOTS:
            sma = _world_sma(torch, np, kernels, comm, model, loss_fn,
                             params, v, base)
            torch.cuda.empty_cache()
            mark("sma")
            sharded = _world_sharded(torch, np, kernels, comm, tr, attention)
            torch.cuda.empty_cache()
            mark("sharded")
        emit("a17", v=v, zero3=zero3, sma=sma, sharded=sharded, lift=lift)
        emit("epoch", v=v, size=peer.size(), rank=peer.rank(), psum=got,
             losses=[repr(x) for x in losses], step_ms=step_ms,
             step_barrier_ms=barrier_ms, resync_ms=resync_ms,
             open_ms=span.stats["open_s"] * 1e3, open_ms_before=open_s * 1e3,
             opens=span.stats["opens"], first_step_wall=first_wall,
             launches=launches, plain=plain, ring=ring,
             strategy=comm.strategy, mem=mem)
        print(f"KFEPOCH v={v} size={peer.size()} rank={peer.rank()} "
              f"world_rank={wr} psum={got} expect={expect} pid={os.getpid()} "
              f"ok=True strategy={comm.strategy} loss={losses[-1]:.17g}",
              flush=True)
        if v + 1 < len(schedule):
            if peer.rank() == 0:
                emit("propose", v=v, size=schedule[v + 1])
                peer.propose_new_size(schedule[v + 1])
            while (peer.cluster_version <= v and not peer.standby
                   and time.time() < deadline):
                peer.resize_cluster_from_url()
        else:
            if peer.rank() == 0:
                peer.propose_new_size(peer.size())  # the shutdown sentinel
            break
    else:
        raise SmokeFailure(f"slot {wr}: phase 23 timed out")
    peer.close()
    emit("done", pid=os.getpid())
    print(f"KFDONE world_rank={wr} pid={os.getpid()}", flush=True)
    return 0


def _world_a17_checks(np, epochs: dict, a17: dict, launches: dict) -> dict:
    """Phase 23's parent-side checks of (a)-(c) over the workers'
    records; their launches are added to ``launches`` (the main path's).
    The first steps against the plain versions are held here, not in the
    workers, so that a fault found by one process stops no other midway
    through a collective."""
    check(sorted(a17) == [0, 1, 2]
          and [len(a17[v]) for v in (0, 1, 2)] == list(WORLD_SCHEDULE),
          f"(a)-(c) records an epoch {[len(a17.get(v, [])) for v in a17]}")
    four = [v for v, n in enumerate(WORLD_SCHEDULE) if n == WORLD_SLOTS]
    out = {"zero3": {"losses": {}, "step_ms": {}, "barrier_ms": {},
                     "init_ms": {}, "recarve_ms": {}, "snapshot_ms": {}}}
    z3 = out["zero3"]
    for v, rs in a17.items():
        zs = [r["zero3"] for r in rs]
        check(len({tuple(z["losses"]) for z in zs}) == 1,
              f"epoch {v}'s ZeRO-3 losses diverged: "
              f"{[z['losses'] for z in zs]}")
        check(len({z["buckets"] for z in zs}) == 1, "ZeRO-3 bucket counts")
        z3["buckets"] = zs[0]["buckets"]
        z3["losses"][v] = [float(x) for x in zs[0]["losses"]]
        for key in ("step_ms", "barrier_ms", "init_ms", "recarve_ms",
                    "snapshot_ms"):
            z3[key][v] = [z[key] for z in zs]
        for z in zs:
            for key, n in z["launches"].items():
                launches[key] += n
        check((v in four) == all(r["sma"] is not None
                                 and r["sharded"] is not None for r in rs),
              f"epoch {v}: (b) and (c) run at four processes only")
    plain = [r["zero3"]["plain"] for r in a17[0]]
    check(all(x is not None for x in plain), "ZeRO-3's plain first step")
    for x in plain:
        check(x["loss_rel"] <= KFRUN_LOSS_RTOL
              and x["grad"]["worst"] <= KFRUN_GRAD_REL_L2
              and not x["apply"]["differ"],
              f"ZeRO-3's first step vs the plain mean step: {x}")
    z3["plain"] = plain[0]
    ssgd0 = [float(x) for x in epochs[0][0]["losses"]]
    z3["first_vs_ssgd"] = {"zero3": z3["losses"][0][0], "ssgd": ssgd0[0],
                           "bitwise": z3["losses"][0][0] == ssgd0[0]}
    z3["steps"] = WORLD_ZERO3_STEPS * sum(WORLD_SCHEDULE)
    for key, n_step in (("ring_rs", z3["buckets"]),
                        ("ring_ag", z3["buckets"])):
        got = sum(r["zero3"]["launches"][key] for rs in a17.values()
                  for r in rs)
        check(got == n_step * z3["steps"], f"ZeRO-3 {key} launches {got}")
    for v in four:
        sms = [r["sma"] for r in a17[v]]
        shs = [r["sharded"] for r in a17[v]]
        check(len({tuple(x["losses"]) for x in sms}) == 1,
              f"SMA losses diverged: {[x['losses'] for x in sms]}")
        rows = [x for sm in sms for x in sm["plain"]]
        check(sorted(x["rank"] for x in rows) == list(range(WORLD_SLOTS)),
              f"SMA's plain rows {[x['rank'] for x in rows]}")
        sma_loss = float(sms[0]["losses"][0])
        sma_plain = sum(x["loss_plain"] for x in rows) / len(rows)
        sma_rel = abs(sma_loss - sma_plain) / abs(sma_plain)
        check(sma_rel <= KFRUN_LOSS_RTOL,
              f"SMA's first loss {sma_loss} vs the plain ranks' mean "
              f"{sma_plain}")
        for x in rows:
            check(x["grad"]["worst"] <= KFRUN_GRAD_REL_L2
                  and x["update"]["worst"] <= KFRUN_GRAD_REL_L2,
                  f"SMA's first step vs the plain SMA step: {x}")
        lifts = [r["lift"] for r in a17[v]]
        check(all(not x["differ"] for x in lifts),
              f"lift's vjps across processes vs one process: {lifts}")
        out["lift"] = {"cases": lifts[0]["cases"], "processes": len(lifts)}
        check(len({tuple(x["losses"]) for x in shs}) == 1,
              f"sharded losses diverged: {[x['losses'] for x in shs]}")
        check(len({tuple(x["params_digest"]) for x in shs}) == 1,
              "the sharded trainer's gathered params differ by process")
        ones = [x["plain"] for x in shs if "plain" in x]
        check(len(ones) == 1, "process 0's one-rank reference")
        one = ones[0]
        check(one["loss_rel"] <= SHARDED_LOSS_RTOL
              and one["grad"]["worst"] <= SHARDED_GRAD_REL_L2
              and not one["apply"]["differ"],
              f"the sharded first step vs the one-rank model: {one}")
        for x in sms + shs:
            for key, n in x["launches"].items():
                launches[key] += n
        out["sma"] = {"leaves": sms[0]["leaves"],
                      "losses": [float(x) for x in sms[0]["losses"]],
                      "plain": {"loss_rel": sma_rel, "rows": rows},
                      "step_ms": [x["step_ms"] for x in sms],
                      "barrier_ms": [x["barrier_ms"] for x in sms]}
        out["sharded"] = {"leaves": shs[0]["leaves"],
                          "losses": [float(x) for x in shs[0]["losses"]],
                          "plain": one,
                          "step_ms": [x["step_ms"] for x in shs],
                          "barrier_ms": [x["barrier_ms"] for x in shs]}
    return out


def phase_world(torch, np, kernels, spec, kfrun) -> dict:
    """Phase 23: the multi-process device world.  bert_base() S-SGD under
    pallas_ring in a provisioned world of four worker processes on the
    card, active 2 -> 4 -> 2 (``python -m kungfu_tpu_torch -np 2 -H
    127.0.0.1:4 -w -device-world``, one process a slot, a communicator
    across the active processes through CUDA IPC), then on the same
    communicator (a) ZeRO-3 every epoch, (b) SMA and (c) the sharded
    flagship at four processes (:func:`_world_a17_checks`).  Checks: the
    psums name the active slots, every replica's loss is bitwise its
    epoch's, rank 0's first step against the plain versions, exact
    launches a step, the cross-process ring kernels bitwise the
    single-process stacked ring and the plain versions on the same four
    gradient buffers, worker 0 keeps one pid, KFDONE from every slot."""
    import shutil
    import tempfile
    import threading

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kfw")
    # the card's memory in use by every process, read every 50 ms while
    # the workers run, beside what this process holds
    total = torch.cuda.mem_get_info()[1]
    held = [torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
            total - torch.cuda.mem_get_info()[0]]
    peak_used, stop = [0], threading.Event()

    def poll():
        while not stop.wait(0.05):
            peak_used[0] = max(peak_used[0],
                               total - torch.cuda.mem_get_info()[0])

    poller = threading.Thread(target=poll, daemon=True)
    try:
        base = _free_port_range(WORLD_SLOTS)
        cfg_port = _free_port()
        out_dir, logdir = (os.path.join(root, x) for x in ("out", "logs"))
        os.makedirs(out_dir)
        cmd = [sys.executable, "-m", "kungfu_tpu_torch", "-np",
               str(WORLD_SCHEDULE[0]), "-H", f"127.0.0.1:{WORLD_SLOTS}", "-w",
               "-device-world", "-q", "-builtin-config-port", str(cfg_port),
               "-logdir", logdir, "-port-range", f"{base}-{base + 1000}",
               sys.executable, os.path.abspath(__file__), "--world-worker",
               "--out", out_dir]
        env = dict(os.environ, PYTHONPATH=HERE, KF_SOCK_DIR=root,
                   KF_TPU_USE_UNIXSOCK="1" if len(root) < 64 else "0")
        print(f"world: {' '.join(cmd[2:])}")
        t0 = time.time()
        with open(os.path.join(root, "runner.log"), "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    cwd=HERE, env=env, start_new_session=True)
        poller.start()
        try:
            rc = proc.wait(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = None
        finally:
            stop.set()
            poller.join()
        wall_s = time.time() - t0
        gib = 2 ** 30
        print(f"world memory: the card's peak in use {peak_used[0] / gib:.2f}"
              f" of {total / gib:.2f} GiB while the workers ran; before "
              f"them {held[2] / gib:.2f} GiB in use, this process "
              f"{held[0] / gib:.2f} GiB allocated and {held[1] / gib:.2f} "
              f"reserved by PyTorch")
        logs = ""
        for name in sorted(os.listdir(logdir)) if os.path.isdir(logdir) \
                else []:
            with open(os.path.join(logdir, name)) as f:
                logs += f.read()
        if rc != 0:
            with open(os.path.join(root, "runner.log")) as f:
                tail = (f.read() + logs)[-6000:]
            raise SmokeFailure(f"phase 23's launch exited {rc}: {tail}")
        recs = _kfrun_records(out_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    epochs, a17 = {}, {}
    for r in recs:
        if r["kind"] == "epoch":
            epochs.setdefault(r["v"], []).append(r)
        elif r["kind"] == "a17":
            a17.setdefault(r["v"], []).append(r)
    check(sorted(epochs) == [0, 1, 2], f"epochs {sorted(epochs)}")
    sizes = [len(epochs[v]) for v in (0, 1, 2)]
    check(sizes == list(WORLD_SCHEDULE), f"active slots an epoch {sizes}")
    want_psum = {v: float(sum(range(1, n + 1)))
                 for v, n in enumerate(WORLD_SCHEDULE)}
    check(all(r["psum"] == want_psum[v] for v, rs in epochs.items()
              for r in rs), "psums " + str(
        {v: [r["psum"] for r in rs] for v, rs in epochs.items()}))
    check(sorted(r["slot"] for r in epochs[1]) == [0, 1, 2, 3]
          and all(sorted(r["slot"] for r in epochs[v]) == [0, 1]
                  for v in (0, 2)), "slots an epoch")
    for v, rs in epochs.items():
        check(len({tuple(r["losses"]) for r in rs}) == 1,
              f"epoch {v}'s replicas diverged: {[r['losses'] for r in rs]}")
        check(all(r["strategy"] == "pallas_ring" for r in rs),
              f"epoch {v} strategies {[r['strategy'] for r in rs]}")
    losses = [[float(x) for x in epochs[v][0]["losses"]] for v in (0, 1, 2)]
    check(all(np.isfinite(x) for ls in losses for x in ls),
          f"non-finite losses {losses}")
    pids = {r["slot"]: {x["pid"] for x in recs
                        if x["slot"] == r["slot"] and "pid" in x}
            for r in recs}
    check(all(len(p) == 1 for p in pids.values()), f"pids {pids}")
    done = {r["slot"] for r in recs if r["kind"] == "done"}
    check(done == set(range(WORLD_SLOTS)), f"done from slots {done}")
    check(len(re.findall(r"^KFDONE world_rank=\d+", logs, re.M))
          == WORLD_SLOTS and len(re.findall(r"^KFEPOCH ", logs, re.M))
          == sum(WORLD_SCHEDULE), "KFEPOCH / KFDONE lines in the logs")
    check("keep their original device world" not in logs,
          "the fixed-world warning in a provisioned world")
    plain = [r["plain"] for r in epochs[0] if r["plain"]]
    check(len(plain) == 1, f"rank 0's plain check {plain}")
    plain = plain[0]
    # the ring across the four processes
    rings = [r["ring"] for r in epochs[1]]
    check(all(x["rs_vs_stacked"] and x["ag_vs_stacked"] and x["rs_vs_plain"]
              and x["ag_vs_plain"] for x in rings),
          f"cross-process ring vs stacked/plain: {rings}")
    check(all(x["rs_digest"] == x["stacked_rs_digest"]
              and x["ag_digest"] == x["stacked_ag_digest"] for x in rings)
          and len({tuple(x["ag_digest"]) for x in rings}) == 1,
          "ring digests")
    r0 = [x for x in rings if "stacked_rs_ms" in x]
    check(len(r0) == 1, "process 0's stacked timing")
    r0 = r0[0]
    k, chunk = r0["k"], r0["chunk"]
    # the four processes' launches together read every rank's buffer
    # once and write every output once: the stacked launch's bytes
    nbytes = (k * k * chunk + k * chunk) * 4
    t = bound(spec, 0, nbytes)
    med = statistics.median
    launches = {key: sum(r["launches"][key] for rs in epochs.values()
                         for r in rs) for key in epochs[0][0]["launches"]}
    n_steps = sum(WORLD_SCHEDULE) * WORLD_STEPS
    check(launches["ring_rs"] == launches["ring_ag"]
          == n_steps * WORLD_RING_PER_STEP, f"ring launches {launches}")
    a17_out = _world_a17_checks(np, epochs, a17, launches)
    props = {r["v"]: r["wall"] for r in recs if r["kind"] == "propose"}
    resize_s = {v: max(r["first_step_wall"] for r in epochs[v])
                - props[v - 1] for v in (1, 2)}
    warm = [ms for v in (0, 1, 2) for r in epochs[v]
            for i, ms in enumerate(r["step_ms"]) if i]
    out = {
        "wall_s": wall_s, "losses": losses, "plain": plain,
        "launches": launches,
        "step_ms": {v: [r["step_ms"] for r in epochs[v]] for v in epochs},
        "step_ms_warm_median": med(warm),
        "step_barrier_ms": {v: [r["step_barrier_ms"] for r in epochs[v]]
                            for v in epochs},
        "split_4proc": {key: med(x[key] for x in rings) for key in (
            "grads_ms", "rs_step_ms", "ag_step_ms", "rs_barrier_ms",
            "ag_barrier_ms")},
        "ipc_open_ms": {v: [r["open_ms"] for r in epochs[v]] for v in epochs},
        "resync_ms": {v: [r["resync_ms"] for r in epochs[v]] for v in epochs},
        "propose_to_first_step_s": resize_s,
        "boot_ms": [r["boot_ms"] for r in recs if r["kind"] == "up"],
        "ring_span": {
            "k": k, "chunk": chunk,
            "rs": {"ms": med(x["rs_ms"] for x in rings),
                   "wall_ms": med(x["rs_wall_ms"] for x in rings),
                   "stacked_ms": r0["stacked_rs_ms"],
                   "plain_ms": r0["plain_rs_ms"],
                   "library_ms": r0["library_rs_ms"], **t},
            "ag": {"ms": med(x["ag_ms"] for x in rings),
                   "wall_ms": med(x["ag_wall_ms"] for x in rings),
                   "stacked_ms": r0["stacked_ag_ms"],
                   "plain_ms": r0["plain_ag_ms"],
                   "library_ms": r0["library_ag_ms"], **t}},
        "memory": {"peak_used_gib": peak_used[0] / gib,
                   "total_gib": total / gib, "before_used_gib": held[2] / gib,
                   "parent_allocated_gib": held[0] / gib,
                   "parent_reserved_gib": held[1] / gib,
                   "sections_gib": {v: {r["slot"]: r["mem"] for r in rs}
                                    for v, rs in epochs.items()}},
        "kfrun_host_engine": {
            "step_ms": kfrun["a"]["median_ms"]["step_ms"],
            "allreduce_share": kfrun["a"]["allreduce_share"]},
        **a17_out,
    }
    sp = out["split_4proc"]
    rsx, agx = out["ring_span"]["rs"], out["ring_span"]["ag"]
    print(f"world (phase 23): {WORLD_SLOTS} slots, schedule "
          f"{list(WORLD_SCHEDULE)}, {WORLD_STEPS} steps an epoch, "
          f"{wall_s:.2f} s; losses {losses} (every replica bitwise its "
          f"epoch's); rank 0's first step vs plain: loss rel "
          f"{plain['loss_rel']:.3e}, worst gradient leaf but q/k "
          f"{plain['grad_rel_l2_worst']:.3e}")
    print(f"world step: {out['step_ms_warm_median']:.1f} ms median warm "
          f"(every epoch {out['step_ms']}); barrier waits in the steps "
          f"{out['step_barrier_ms']} ms; at four processes: grads "
          f"{sp['grads_ms']:.1f} ms, cross-process reduce-scatter "
          f"{sp['rs_step_ms']:.2f} ms (barrier {sp['rs_barrier_ms']:.2f}), "
          f"all-gather {sp['ag_step_ms']:.2f} ms (barrier "
          f"{sp['ag_barrier_ms']:.2f})")
    print(f"world epochs: IPC open ms {out['ipc_open_ms']}; resync ms "
          f"{out['resync_ms']}; propose -> first step of the new epoch "
          f"{ {v: round(s, 3) for v, s in resize_s.items()} } s; boot ms "
          f"{out['boot_ms']}")
    print(f"world ring at k={k} chunk={chunk} f32 across four processes: "
          f"reduce-scatter {rsx['ms']:.4f} ms a launch in each process "
          f"(wall {rsx['wall_ms']:.4f}), all-gather {agx['ms']:.4f} ms (wall "
          f"{agx['wall_ms']:.4f}); the stacked single call "
          f"{rsx['stacked_ms']:.4f} and {agx['stacked_ms']:.4f} ms, plain "
          f"{rsx['plain_ms']:.4f} and {agx['plain_ms']:.4f} ms, PyTorch "
          f"{rsx['library_ms']:.4f} and {agx['library_ms']:.4f} ms; bound "
          f"{t['bound_ms']:.4f} ms ({nbytes} bytes); launches {launches}")
    z3, sm, sh = out["zero3"], out["sma"], out["sharded"]
    z3p = z3["plain"]
    print(f"world (a) ZeRO-3 under pallas_ring, {z3['buckets']} buckets: "
          f"step ms {z3['step_ms']}, barrier ms in the steps "
          f"{z3['barrier_ms']}; losses {z3['losses']} (every process "
          f"bitwise its epoch's; S-SGD's first loss "
          f"{z3['first_vs_ssgd']}); carve ms {z3['init_ms']}, re-carve "
          f"ms {z3['recarve_ms']}, "
          f"snapshot ms {z3['snapshot_ms']}; first step vs the plain mean "
          f"step: loss rel {z3p['loss_rel']:.3e}, mean gradient (the "
          f"momentum) {_rel_text(z3p['grad'])} (tol {KFRUN_GRAD_REL_L2}); "
          f"params vs SGD's apply of it: {_apply_text(z3p['apply'])}")
    smp = sm["plain"]
    print(f"world (b) SMA at four processes, {sm['leaves']} leaves, the "
          f"average by psum: step ms {sm['step_ms']}, barrier ms "
          f"{sm['barrier_ms']}, losses {sm['losses']}; first step vs the "
          f"plain SMA step: loss rel {smp['loss_rel']:.3e}, each rank's "
          + "; ".join(f"rank {x['rank']} gradient {_rel_text(x['grad'])}, "
                      f"update {_rel_text(x['update'])}"
                      for x in smp["rows"])
          + f" (tol {KFRUN_GRAD_REL_L2})")
    shp = sh["plain"]
    print(f"world (c) ShardedTrainer dp2 x tp2 across four processes, the "
          f"flagship at [{WORLD_SHARDED_BATCH}, {WORLD_SHARDED_SEQ}]: step ms "
          f"{sh['step_ms']}, barrier ms {sh['barrier_ms']}, losses "
          f"{sh['losses']}; first step vs the one-rank model: loss rel "
          f"{shp['loss_rel']:.3e}, synchronized gradient "
          f"{_rel_text(shp['grad'])} (tol {SHARDED_GRAD_REL_L2}); params vs "
          f"SGD's apply of it: {_apply_text(shp['apply'])}")
    print(f"world lift: {len(out['lift']['cases'])} collectives "
          f"({', '.join(out['lift']['cases'])}) over the span in each of "
          f"{out['lift']['processes']} processes, outputs and input "
          f"gradients bitwise the one-process communicator's")
    print(f"world memory by section, each process's peak GiB allocated "
          f"and reserved by PyTorch (slot: section: [allocated, reserved]): "
          + "; ".join(f"epoch {v}: " + json.dumps({
              slot: {sec: [round(x, 2) for x in m] for sec, m in ms.items()}
              for slot, ms in sorted(sec_v.items())})
              for v, sec_v in out["memory"]["sections_gib"].items()))
    print(f"world beside phase 20's host engine (for reading): "
          f"{out['kfrun_host_engine']['step_ms']:.1f} ms a step, allreduce "
          f"{out['kfrun_host_engine']['allreduce_share']:.3f} of it")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"world phase: {out['phase_s']:.2f} s")
    return out


#: phase 24: the reference's example entry points, in-process, on the
#: card.  (a) long_context at the flagship's width: 12 heads and d_ff
#: 3072 follow from the example's own rule, four co-resident sp ranks,
#: block_impl auto (the flash kernels in every ring round)
EX_LC_WIDTH = ["--d-model", "768", "--n-layers", "12", "--sp", "4",
               "--block-impl", "auto"]
#: first below the example's dense-check gate, then the headline length
EX_LC_CHECKED = ["--seq-len", "2048", "--steps", "2"]
EX_LC_LONG = ["--seq-len", "32768", "--batch-size", "1", "--steps", "3"]
#: the long run's first loss against the same ring over the plain
#: einsum blocks, forward only: phase 17's loss tolerance
#: (SHARDED_LOSS_RTOL).  At init the loss sits near ln(1024) whatever
#: attention computes, so the loss without the causal mask is printed
#: beside it, as phase 17 does
EX_LC_LOSS_RTOL = SHARDED_LOSS_RTOL
#: the einsum blocks run this many heads at a time: a head's [4, 8192,
#: 8192] f32 logits are 1 GiB, and the block's temporaries a few of them
EX_LC_PLAIN_HEADS = 2
#: rows 1-3 at the ring's shape: the diagonal round of S/sp = 8192 over
#: all four ranks' 12 heads, causal, with the merge's lse cotangent
EX_RING_SHAPE = (4 * 12, 8192, 64)
#: (c): strategy_tour at the reference test's --steps
EX_TOUR_STEPS = 18
#: (d): serve_demo's requests long enough to overlap.  Least-outstanding
#: dispatch ties to the lowest rank, as the reference's does: worker 1
#: gets a request only while worker 0 holds one, and the victim joins
#: the router's dead list only once it holds two expired requests or a
#: later dispatch to it fails, which needs workers 0 and 2 to hold two
#: each.  At 24 tokens a request can end on an H100 within the 20 ms
#: between arrivals, so the kill may never land, or land on one request
#: that replays alone, and the demo's dead-list assertion fails (ROADMAP
#: C42); at 96 each takes 300 ms or more (prompt 17 + 96 <= max_seq 128)
EX_SERVE_ARGS = ["--tokens", "96"]
#: (d) first reads serve_demo at its defaults in a fresh process: each
#: request's worker, replays and milliseconds, and the demo's outcome.
#: Its dead-list assertion is timing's (C42), so that one outcome is
#: read, not held; any other failure fails the phase
EX_SERVE_DEFAULTS_DRIVER = """\
import json
from kungfu_tpu_torch.examples import serve_demo
from kungfu_tpu_torch.serve import router
handles = []
submit = router.ServeRouter.submit
def recorded(self, *args, **kwargs):
    handles.append(submit(self, *args, **kwargs))
    return handles[-1]
router.ServeRouter.submit = recorded
try:
    serve_demo.main([])
    outcome = "passed"
except AssertionError as e:
    outcome = "assertion: " + str(e)
print("SERVE_DEFAULTS " + json.dumps({"outcome": outcome, "requests": [
    [h.worker, h.replays, ((h.done_s or h.submitted_s) - h.submitted_s)
     * 1e3] for h in handles]}), flush=True)
"""
#: the dead-list assertion's message: the victim stayed live
EX_SERVE_DEFAULTS_READ = ("passed", "assertion: []")
EX_SERVE_DEFAULTS_TIMEOUT_S = 180
#: knobs the earlier phases set that a user's run of an example has not
EX_CLEAR_ENV = ("KF_CHAOS_SPEC", "KF_JAX_PLATFORM", "MEGASCALE_NUM_SLICES",
                "KF_SLICE_RANKS", "KF_TPU_XENT", "KF_TPU_ATTN",
                "KF_TPU_LM_HEAD", "KF_NATIVE_ENGINE", "KF_TPU_HOST_TRANSPORT")


def _per_head_einsum(torch, long_context, sp: int, heads: int):
    """The example's ``attn_fn`` through the ring's plain einsum blocks,
    ``heads`` heads at a time (the [S/sp, S/sp] f32 logits of all 12
    would not fit beside the model)."""
    ring = long_context.ring_attn(sp, "einsum")

    def attn(q, k, v, causal):
        outs = [ring(q[:, h:h + heads].contiguous(),
                     k[:, h:h + heads].contiguous(),
                     v[:, h:h + heads].contiguous(), causal)
                for h in range(0, q.shape[1], heads)]
        return torch.cat(outs, dim=1)

    return attn


def _ring_shape_rows(torch, attention, spec) -> dict:
    """Rows 1-3 at the ring's S/sp = 8192 round: the kernels against
    their plain versions on the same inputs (the forward's in chunks of
    12 rows: a chunk's [12, 8192, 8192] f32 scores are 3 GiB), then
    timed beside the plain versions and SDPA, with the bound."""
    import torch.nn.functional as F

    bh, s, d = EX_RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    dl = torch.randn((bh, s), generator=gen, device="cuda")
    chunk = 12

    def plain_fwd():
        parts = [attention.flash_attention_reference(
            q[i:i + chunk], k[i:i + chunk], v[i:i + chunk], True)
            for i in range(0, bh, chunk)]
        return (torch.cat([o for o, _ in parts]),
                torch.cat([l for _, l in parts]))

    out, lse = attention._launch(q, k, v, True)
    ref_o, ref_lse = plain_fwd()
    o_err = (out.float() - ref_o.float()).abs().max().item()
    l_err = (lse - ref_lse).abs().max().item()
    del ref_o, ref_lse
    delta = (do.float() * out.float()).sum(-1) - dl
    dq = attention._launch_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = attention._launch_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    blocked = attention.flash_attention_backward_reference(
        q, k, v, out, lse, do, True, delta=delta)
    top = max(t.float().abs().max().item() for t in blocked)
    g_tol = BF16_GRAD_RTOL * top
    dq_err = _grad_err([dq], blocked[:1])
    dkv_err = _grad_err([dk, dv], blocked[1:])
    del blocked, dq, dk, dv
    print(f"examples ring rows [{bh}, {s}, {d}] causal: max|dO| "
          f"{o_err:.3e} (tol {BF16_O_ATOL}), max|dlse| {l_err:.3e} (tol "
          f"{BF16_LSE_ATOL}), dQ {dq_err:.3e} and dK/dV {dkv_err:.3e} vs "
          f"the blocked plain backward (tol {g_tol:.3e})")
    check(o_err <= BF16_O_ATOL, f"ring-shape forward O error {o_err}")
    check(l_err <= BF16_LSE_ATOL, f"ring-shape forward lse error {l_err}")
    check(dq_err <= g_tol, f"ring-shape dQ error {dq_err} > {g_tol}")
    check(dkv_err <= g_tol, f"ring-shape dK/dV error {dkv_err} > {g_tol}")

    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
    fwd_ms = device_ms(torch, lambda: attention._launch(q, k, v, True),
                       iters=5, windows=7)
    plain_ms = device_ms(torch, plain_fwd, iters=1, windows=3)
    sdpa_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=5, windows=7)
    fwd_us = host_us(torch, lambda: attention._launch(q, k, v, True),
                     calls=20)
    dq_ms = device_ms(torch, lambda: attention._launch_bwd_dq(
        q, k, v, do, lse, delta, True), iters=5, windows=7)
    dkv_ms = device_ms(torch, lambda: attention._launch_bwd_dkv(
        q, k, v, do, lse, delta, True), iters=5, windows=7)
    dq_us = host_us(torch, lambda: attention._launch_bwd_dq(
        q, k, v, do, lse, delta, True), calls=20)
    dkv_us = host_us(torch, lambda: attention._launch_bwd_dkv(
        q, k, v, do, lse, delta, True), calls=20)
    bwd_plain_ms = device_ms(
        torch, lambda: attention.flash_attention_backward_reference(
            q, k, v, out, lse, do, True), iters=1, windows=3)
    qg, kg, vg = (t.view(1, bh, s, d).clone().requires_grad_(True)
                  for t in (q, k, v))
    do4 = do.view(1, bh, s, d)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do4)

    sdpa_bwd_ms = device_ms(torch, sdpa_fwd_bwd, iters=3, windows=5) - sdpa_ms
    # the bounds as phase 3 counts them (phase_flash_forward/_backward)
    pairs = bh * (s * (s + 1) // 2)
    rows = bh * s * 4 * 2
    t_fwd = bound(spec, 4 * d * pairs, 4 * bh * s * d * 2 + bh * s * 4)
    t_dq = bound(spec, 3 * 2 * d * pairs, 5 * bh * s * d * 2 + rows)
    t_dkv = bound(spec, 4 * 2 * d * pairs, 6 * bh * s * d * 2 + rows)
    timing = {
        "fwd": {"ms": fwd_ms, "plain_ms": plain_ms, "library_ms": sdpa_ms,
                "host_us": fwd_us, **t_fwd},
        "dq": {"ms": dq_ms, "plain_ms": bwd_plain_ms,
               "library_ms": sdpa_bwd_ms, "host_us": dq_us, **t_dq},
        "dkv": {"ms": dkv_ms, "plain_ms": bwd_plain_ms,
                "library_ms": sdpa_bwd_ms, "host_us": dkv_us, **t_dkv}}
    for name, t in timing.items():
        print(f"examples ring rows {name} [{bh}, {s}, {d}] causal: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['bound_ms'] / t['ms']:.1%} of it), "
              f"{t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s, host "
              f"{t['host_us']:.1f} us per launch")
    del q, k, v, do, dl, out, lse, delta, q4, k4, v4, qg, kg, vg, do4
    return {"errors": {"o_err": o_err, "lse_err": l_err, "dq_err": dq_err,
                       "dkv_err": dkv_err, "grad_tol": g_tol},
            "timing": timing}


def phase_examples(torch, np, kernels, spec) -> dict:
    """Phase 24: the reference's example entry points through their
    ``main(argv)``, in this process, on the card, each run's launches
    counted from zero.  (a) ``long_context`` at the flagship's width
    on four sp ranks: at S = 2048 its own dense check, then at S = 32768
    three Adam steps, the first loss against the ring over the plain
    einsum blocks, rows 1-3 launched inside the ring and held and timed
    at its round's shape; (b) ``shard_train`` at its defaults, dense and
    with four experts; (c) ``strategy_tour`` at ``--steps 18``; (d)
    ``serve_demo`` at its defaults in a fresh process, read, then at
    ``EX_SERVE_ARGS``, held."""
    from kungfu_tpu_torch.examples import (long_context, serve_demo,
                                           shard_train, strategy_tour)
    from kungfu_tpu_torch.ops.cuda import attention

    t_phase = time.perf_counter()
    # the examples as a user starts them: no knob an earlier phase set
    old = _set_env({k: None for k in EX_CLEAR_ENV})
    try:
        return _examples(torch, kernels, spec, long_context, serve_demo,
                         shard_train, strategy_tour, attention, t_phase)
    finally:
        _set_env(old)


def _examples(torch, kernels, spec, long_context, serve_demo, shard_train,
              strategy_tour, attention, t_phase) -> dict:
    import contextlib
    import io

    out = {"runs": {}}
    total: dict = {}

    def run(label, fn, apart=None):
        """``apart``: launches made inside the run that are not its own
        (the autotune's probes), left out of its count."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        _reset(kernels)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: n - (apart or {}).get(k, 0)
                    for k, n in _counts(kernels).items()}
        launches = {k: n for k, n in launches.items() if n}
        text = buf.getvalue()
        print(text, end="")
        check(rc == 0, f"examples {label}: main returned {rc}")
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        res = {"wall_s": wall, "launches": launches,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"examples {label}: {wall:.2f} s, peak "
              f"{res['peak_gib']:.2f} GiB, launches {launches}")
        out["runs"][label] = res
        return res, text

    # (a) long_context at the flagship's width
    rep = {}
    a1, _ = run("long_context S=2048", lambda: long_context.main(
        EX_LC_WIDTH + EX_LC_CHECKED, rep))
    got, ref = rep["dense_check"]
    a1.update(dense_check={"ring": got, "dense": ref}, losses=rep["losses"],
              step_s=rep["step_s"], tok_s=rep["tok_s"])
    rep = {}
    a2, _ = run("long_context S=32768", lambda: long_context.main(
        EX_LC_WIDTH + EX_LC_LONG, rep))
    a2.update(losses=rep["losses"], step_s=rep["step_s"], tok_s=rep["tok_s"])
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(a2["launches"].get(key, 0) > 0,
              f"long_context S=32768: no {key} launch inside the ring")
    check(all(math.isfinite(x) for x in a2["losses"]),
          f"long_context S=32768: losses {a2['losses']}")
    check(a2["losses"][-1] < a2["losses"][0],
          f"long_context S=32768: loss did not fall {a2['losses']}")
    args = long_context.parse_args(EX_LC_WIDTH + EX_LC_LONG)
    model, params, ids, targets = long_context.build(args,
                                                     torch.device("cuda"))
    before = _counts(kernels)
    t0 = time.perf_counter()
    with torch.no_grad():
        plain = float(long_context.sharded_loss(
            model, params, ids, targets, args.sp,
            _per_head_einsum(torch, long_context, args.sp,
                             EX_LC_PLAIN_HEADS)))
    plain_s = time.perf_counter() - t0
    after = _counts(kernels)
    check(after == before, f"the plain ring launched kernels: "
          f"{ {k: after[k] - before[k] for k in after} }")
    flash = long_context.ring_attn(args.sp, "flash")
    with torch.no_grad():
        # an attention fault's loss, for scale: the ring without the mask
        unmasked = float(long_context.sharded_loss(
            model, params, ids, targets, args.sp,
            lambda q, k, v, causal: flash(q, k, v, False)))
    first = a2["losses"][0]
    rel = abs(first - plain) / abs(plain)
    print(f"examples long_context S=32768: first loss {first:.6f} through "
          f"the flash kernels, {plain:.6f} through the plain einsum ring "
          f"(rel {rel:.3e}, tol {EX_LC_LOSS_RTOL}; {plain_s:.2f} s); "
          f"without the causal mask {unmasked:.6f}")
    check(rel <= EX_LC_LOSS_RTOL,
          f"long_context S=32768 first loss {first} vs plain ring {plain}")
    a2.update(plain_loss=plain, rel=rel, unmasked_loss=unmasked,
              plain_s=plain_s)
    del model, params, ids, targets
    gc.collect()
    torch.cuda.empty_cache()
    out["ring_rows"] = _ring_shape_rows(torch, attention, spec)
    torch.cuda.empty_cache()

    # (b) shard_train at its defaults, dense and MoE
    for label, argv in (("shard_train", []),
                        ("shard_train experts 4", ["--experts", "4"])):
        res, text = run(label, lambda argv=argv: shard_train.main(argv))
        check("mesh MeshPlan(dp=2, pp=1, sp=2, tp=2) over 8/8 devices"
              in text and text.rstrip().endswith("OK"),
              f"{label}: output {text[-300:]!r}")
        check(res["launches"].get("flash_fwd", 0) > 0,
              f"{label}: no flash_fwd launch")

    # (c) strategy_tour.  Its autotune times every schedule, the ring
    # kernels among them, and installs psum on one card, so rows 9-10
    # launch in its probes only: those are counted apart
    from kungfu_tpu_torch.comm.device import Communicator

    probes: dict = {}
    autotune = Communicator.autotune_strategy

    def probed(self, *args, **kwargs):
        before = _counts(kernels)
        try:
            return autotune(self, *args, **kwargs)
        finally:
            for key, n in _counts(kernels).items():
                probes[key] = probes.get(key, 0) + n - before[key]

    Communicator.autotune_strategy = probed
    try:
        res, text = run("strategy_tour", lambda: strategy_tour.main(
            ["--steps", str(EX_TOUR_STEPS)]), apart=probes)
    finally:
        Communicator.autotune_strategy = autotune
    for want in ("[1] autotune", "adaptive re-tunes: 1", "(1/8)"):
        check(want in text, f"strategy_tour: {want!r} missing: "
              f"{text[-500:]!r}")
    for key in ("ring_rs", "ring_ag"):
        check(probes.get(key, 0) > 0,
              f"strategy_tour: no {key} launch in the autotune's probes")
    res["probe_launches"] = {k: n for k, n in probes.items() if n}
    print(f"examples strategy_tour: autotune probe launches "
          f"{res['probe_launches']} (not the main path's)")
    out["probe_launches"] = {key: probes.get(key, 0)
                             for key in _counts(kernels)}

    # (d) serve_demo: its defaults in a fresh process, read; then held
    # at EX_SERVE_ARGS
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", EX_SERVE_DEFAULTS_DRIVER], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
        text=True, timeout=EX_SERVE_DEFAULTS_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("SERVE_DEFAULTS ")]
    check(proc.returncode == 0 and lines,
          f"serve_demo at its defaults: rc {proc.returncode}: "
          f"{(proc.stdout + proc.stderr)[-1500:]!r}")
    defaults = json.loads(lines[0].split(" ", 1)[1])
    check(defaults["outcome"] in EX_SERVE_DEFAULTS_READ,
          f"serve_demo at its defaults: {defaults['outcome']}")
    ms = [r[2] for r in defaults["requests"]]
    per_worker = [sum(r[0] == w for r in defaults["requests"])
                  for w in range(3)]
    defaults.update(wall_s=time.perf_counter() - t0, per_worker=per_worker,
                    ms_range=[min(ms), max(ms)])
    replays = sum(r[1] for r in defaults["requests"])
    if defaults["outcome"] == "passed":
        read = "passed"
    elif replays:
        read = ("the kill landed, its one stuck request replayed alone and "
                "the victim stayed off the dead list (ROADMAP C42)")
    else:
        read = ("the kill never landed: each request ended before the next "
                "arrived, so worker 0 took them all (ROADMAP C42)")
    print(f"examples serve_demo at its defaults, fresh process: {read}; "
          f"requests a worker at the end {per_worker}, replays "
          f"{replays}, {min(ms):.1f}-"
          f"{max(ms):.1f} ms a request; {defaults['wall_s']:.2f} s")
    out["serve_defaults"] = defaults

    rep = {}
    res, text = run("serve_demo", lambda: serve_demo.main(EX_SERVE_ARGS,
                                                          rep))
    check("serve-demo: survived worker kill; 24/24 requests completed"
          in text, f"serve_demo: output {text[-300:]!r}")
    # the engine's attention is plain, as the reference's; the greedy
    # reference's full forwards run row 1 on 16-wide heads padded to 64
    check(res["launches"].get("flash_fwd", 0) > 0,
          "serve_demo: no flash_fwd launch in the greedy reference")
    res.update(replayed=rep["replayed"], reused=rep["reused"])

    out["long_context"] = {"s2048": a1, "s32768": a2}
    out["launches"] = {key: total.get(key, 0) for key in _counts(kernels)}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"examples (a) long_context S=32768: {a2['tok_s']:,.0f} tok/s, "
          f"{a2['step_s'] * 1e3:.1f} ms a step, peak {a2['peak_gib']:.2f} "
          f"GiB; S=2048 {a1['tok_s']:,.0f} tok/s, "
          f"{a1['step_s'] * 1e3:.1f} ms a step")
    print(f"examples phase: {out['phase_s']:.2f} s, launches "
          f"{out['launches']}")
    return out


#: phase 25: ``scripts/cluster_torch.py`` at the reference harness's
#: defaults on the card: two loopback-alias hosts of two slots, two
#: workers to start, 2 -> 4 -> 2, three steps a stage
CLUSTER_ARGS = ["--hosts", "2", "--slots-per-host", "2", "--np", "2",
                "--schedule", "2:3,4:3,2:3"]
#: the harness's own limit (its --timeout, s), and the phase's on top:
#: the harness's cleanup takes up to twice its 10 s kill grace
CLUSTER_TIMEOUT_S = 120
CLUSTER_DEADLINE_S = CLUSTER_TIMEOUT_S + 30
CLUSTER_SIZES = [2, 4]
#: each host's workers at v0, v1 and v2 (the runners' ``watching`` and
#: ``stage`` lines): the grow lands on the host that started empty
CLUSTER_LOCAL = {"127.0.0.1": [(0, 2), (1, 2), (2, 2)],
                 "127.0.0.2": [(0, 0), (1, 2), (2, 0)]}
#: lines of each log printed on a failure
CLUSTER_TAIL = 40


def _cluster_harness():
    """``scripts/cluster_torch.py`` as a module (its log parsers and the
    tagged-process helpers)."""
    import importlib.util

    path = os.path.join(HERE, "scripts", "cluster_torch.py")
    spec = importlib.util.spec_from_file_location("cluster_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def _event_wall(text: str, name: str):
    m = re.search(r"event: " + re.escape(name) + r" \| wall=([\d.]+)", text)
    return float(m.group(1)) if m else None


def phase_cluster(torch) -> dict:
    """Phase 25: the compose-style elastic cluster on the card.
    ``scripts/cluster_torch.py`` (its own session) starts an external
    config server and one watch runner on each of 127.0.0.1 and
    127.0.0.2, whose ``elastic_mnist`` workers train on the card through
    2 -> 4 -> 2.  Checks: exit 0 and the harness's JSON line (``ok``,
    sizes [2, 4]); the runner of 127.0.0.2 starts with no worker, runs
    two in the grown stage and none after the shrink; every worker's
    params on ``cuda:0``; rank 0's last loss below its first; no process
    of the cluster alive afterwards (each process group seen while it
    ran, ``os.killpg(pgid, 0)``).  The card's memory in use is read
    every 0.1 s.  A failure names its stage and prints the harness's
    output and every log's tail before it raises."""
    import shutil
    import signal
    import tempfile
    import threading
    import uuid

    ct = _cluster_harness()
    gib = 2 ** 30
    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    before = total - free
    print(f"cluster memory before: {before / gib:.2f} of {total / gib:.2f} "
          f"GiB in use, this process {torch.cuda.memory_allocated() / gib:.2f}"
          f" GiB allocated and {torch.cuda.memory_reserved() / gib:.2f} "
          f"reserved by PyTorch", flush=True)
    root = tempfile.mkdtemp(prefix="kfc")
    logdir = os.path.join(root, "logs")
    tag = uuid.uuid4().hex
    cmd = [sys.executable, os.path.join(HERE, "scripts", "cluster_torch.py"),
           *CLUSTER_ARGS, "--backend", "gpu", "--logdir", logdir,
           "--timeout", str(CLUSTER_TIMEOUT_S)]
    env = dict(os.environ, **{ct.TAG_ENV: tag})
    peak, groups, stop = [before], set(), threading.Event()

    def poll():
        while not stop.wait(0.1):
            peak[0] = max(peak[0], total - torch.cuda.mem_get_info()[0])
            groups.update(ct.process_groups(ct.tagged_pids(tag)))

    poller = threading.Thread(target=poll, daemon=True)
    hosts = sorted(CLUSTER_LOCAL)
    res = {"out": "", "err": ""}

    def fail(stage: str, msg: str):
        print(f"phase 25 {stage}: the harness's stdout:\n{res['out']}\n"
              f"its stderr:\n{res['err']}", file=sys.stderr)
        for name in ["config-server.log"] + [f"runner-{h}.log"
                                             for h in hosts]:
            tail = _read(os.path.join(logdir, name)).splitlines()
            print(f"phase 25 {stage}: the last {CLUSTER_TAIL} lines of "
                  f"{name}:\n" + "\n".join(tail[-CLUSTER_TAIL:]),
                  file=sys.stderr)
        free = torch.cuda.mem_get_info()[0]
        print(f"phase 25 {stage}: the card's memory in use "
              f"{(total - free) / gib:.2f} of {total / gib:.2f} GiB",
              file=sys.stderr)
        raise SmokeFailure(f"phase 25 {stage}: {msg}")

    proc = None
    try:
        t0 = time.time()
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
        groups.add(proc.pid)
        poller.start()
        print(f"cluster: {' '.join(cmd[1:])}", flush=True)
        try:
            res["out"], res["err"] = proc.communicate(
                timeout=CLUSTER_DEADLINE_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            res["out"], res["err"] = proc.communicate()
            fail("run", f"the harness ran past {CLUSTER_DEADLINE_S} s")
        wall_s = time.time() - t0
        stop.set()
        poller.join()
        if proc.returncode != 0:
            fail("exit", f"the harness exited {proc.returncode}")
        lines = res["out"].strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, ValueError):
            fail("result", "no JSON line last on the harness's stdout")
        if not (result.get("ok") is True
                and result.get("sizes_observed") == CLUSTER_SIZES):
            fail("result", f"{result}, want ok and sizes {CLUSTER_SIZES}")
        # each host's workers at every stage, from its runner's log
        local = {h: ct.local_workers(_read(os.path.join(
            logdir, f"runner-{h}.log"))) for h in hosts}
        if local != CLUSTER_LOCAL:
            fail("runners", f"workers a stage by host {local}, want "
                 f"{CLUSTER_LOCAL}")
        # the workers' own lines: where their params live, rank 0's loss
        ups, steps, done = [], [], []
        for h in hosts:
            wdir = os.path.join(logdir, f"workers-{h}")
            for name in sorted(os.listdir(wdir)) if os.path.isdir(wdir) \
                    else []:
                text = _read(os.path.join(wdir, name))
                ups += re.findall(r"^worker (\d+)/(\d+) up \(v(\d+)\) on "
                                  r"(\S+)$", text, re.M)
                done += re.findall(r"^worker (\d+): done at step (\d+), "
                                   r"sizes seen \[([\d, ]+)\]", text, re.M)
                if h == hosts[0] and name == "worker-0.stdout.log":
                    steps = [(int(s), int(n), float(x)) for s, n, x in
                             re.findall(r"^step (\d+): size (\d+) loss "
                                        r"(\S+)$", text, re.M)]
        devices = sorted({d for *_, d in ups})
        if len(ups) != 4 or devices != ["cuda:0"]:
            fail("devices", f"worker up lines {ups}, want four on cuda:0")
        if len(done) != 2 or any(s != "2, 4" for *_, s in done):
            fail("done", f"finished workers {done}, want two that saw "
                 f"sizes [2, 4]")
        losses = [x for *_, x in steps]
        if len(losses) < 2 or not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail("loss", f"rank 0's losses {steps} do not fall")
        # every process group of the cluster is gone
        alive = []
        for g in sorted(groups):
            try:
                os.killpg(g, 0)
                alive.append(g)
            except ProcessLookupError:
                pass
            except PermissionError:
                alive.append(g)
        if alive or ct.tagged_pids(tag):
            fail("cleanup", f"process groups still alive {alive} of "
                 f"{sorted(groups)}; tagged {ct.tagged_pids(tag)}")
        # each stage's wall: rank 0's peer start and resizes, the end
        rank0 = _read(os.path.join(logdir, f"workers-{hosts[0]}",
                                   "worker-0.stderr.log"))
        marks = [t0, _event_wall(rank0, "peer-started"),
                 _event_wall(rank0, "cluster-resized-v1-n4"),
                 _event_wall(rank0, "cluster-resized-v2-n2"), t0 + wall_s]
        if None in marks:
            fail("events", f"rank 0's events {marks}")
        stage_s = dict(zip(("boot", "v0_size2", "v1_size4", "v2_size2"),
                           [b - a for a, b in zip(marks, marks[1:])]))
    finally:
        stop.set()
        if poller.is_alive():
            poller.join()
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        for pid in ct.tagged_pids(tag):
            try:
                os.killpg(os.getpgid(pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        shutil.rmtree(root, ignore_errors=True)
    out = {"wall_s": wall_s, "stage_s": stage_s, "sizes": CLUSTER_SIZES,
           "local_workers": local, "losses": steps,
           "process_groups": len(groups),
           "memory_gib": {"before": before / gib, "peak": peak[0] / gib,
                          "total": total / gib},
           "phase_s": time.perf_counter() - t_phase}
    print(f"cluster: {len(hosts)} runners x 2 slots, "
          f"{CLUSTER_ARGS[-1]}, harness {wall_s:.2f} s (stages "
          f"{ {k: round(v, 2) for k, v in stage_s.items()} } s); "
          f"sizes_observed {CLUSTER_SIZES}; workers a stage by host "
          f"{local}; every worker on cuda:0; rank 0's losses {steps}; "
          f"{len(groups)} process groups, none alive after")
    print(f"cluster memory: the card's peak in use {peak[0] / gib:.2f} of "
          f"{total / gib:.2f} GiB while the cluster ran, "
          f"{(peak[0] - before) / 2 ** 20:.0f} MiB above the "
          f"{before / gib:.2f} GiB before it")
    print(f"cluster phase: {out['phase_s']:.2f} s")
    return out


#: phase 26: two public models' widths in the JAX package's
#: TransformerConfig, depth cut to four layers (from 32 and 16), random
#: weights from seed 0: Pythia-2.8B's (EleutherAI/pythia-2.8b
#: config.json; Biderman et al. 2023, Table 1), whose 80-wide heads run
#: zero-padded to the 96-wide kernels, and Pythia-1B's, whose heads are
#: 256 wide.  Pythia's partial rotary (a quarter of each head) and
#: parallel residual are not in the reference's Transformer: its full
#: RoPE and sequential block stand in
HEAD_WIDTH_MODELS = {
    "pythia_2p8b_w": dict(vocab_size=50304, d_model=2560, n_heads=32,
                          d_ff=10240),
    "pythia_1b_w": dict(vocab_size=50304, d_model=2048, n_heads=8,
                        d_ff=8192)}
HEAD_WIDTH_COMMON = dict(n_layers=4, max_seq=TRAIN_SEQ, causal=True,
                         pos="rope", dtype="bfloat16")
#: (b): four greedy requests of these prompt lengths, 16 new tokens each
HEAD_WIDTH_PROMPTS, HEAD_WIDTH_NEW = (17, 64, 150, 200), 16
#: (c): phase 6's step at ids and targets [2, 2048], three steps
HEAD_WIDTH_BATCH, HEAD_WIDTH_STEPS = 2, 3


def _head_width_serve(torch, np, model, params) -> dict:
    """(b): an ``InferenceEngine`` answers four greedy requests; each
    token is held against full-context greedy decoding through the flash
    forward (phase 5's margin)."""
    from kungfu_tpu_torch.serve.engine import InferenceEngine

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(1)
    prompts = {f"r{n}": rng.integers(0, vocab, size=n).tolist()
               for n in HEAD_WIDTH_PROMPTS}
    engine = InferenceEngine(model, params, max_batch=len(prompts),
                             max_seq=512)
    engine.warmup(prompt_lens=(max(HEAD_WIDTH_PROMPTS),))
    done, steps = {}, 0
    t0 = time.perf_counter()
    for rid, toks in prompts.items():
        engine.submit(rid, toks, HEAD_WIDTH_NEW)
    while engine.pending_count or engine.active_count:
        for ev in engine.step():
            if ev["kind"] == "done":
                done[ev["rid"]] = ev
        steps += 1
    wall = time.perf_counter() - t0
    check(set(done) == set(prompts), f"completed {sorted(done)}")
    for rid, ev in done.items():
        check(len(ev["tokens"]) == HEAD_WIDTH_NEW,
              f"{rid}: {len(ev['tokens'])} tokens, budget {HEAD_WIDTH_NEW}")
    worst, exact, _ = _teacher_forced(
        torch, model, params, [(prompts[r], done[r]["tokens"]) for r in done])
    total = HEAD_WIDTH_NEW * len(done)
    print(f"  (b) serve: {len(done)} requests, {steps} steps, "
          f"{wall * 1e3:.1f} ms, {total / wall:.1f} generated tokens/s; vs "
          f"full-context greedy {sum(exact)}/{len(exact)} requests "
          f"identical, largest top-1 margin {worst:.3e} (tol "
          f"{GREEDY_MARGIN})")
    check(worst <= GREEDY_MARGIN, f"engine token loses to the greedy top-1 "
          f"by {worst} > {GREEDY_MARGIN}")
    return {"ms": wall * 1e3, "tokens_s": total / wall, "steps": steps,
            "greedy_exact_requests": sum(exact), "greedy_worst_margin": worst}


def _head_width_train(torch, np, kernels, tr, model, params) -> dict:
    """(c): phase 6's one-rank step (flash, plain head, fused
    cross-entropy, ``synchronous_sgd(sgd(0.05, momentum=0.9))``) at
    ``[2, 2048]``: the first-step gradients against the kernels' plain
    versions (phase 20's rule), exact launches a step, three steps of
    falling loss."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step
    from kungfu_tpu_torch.utils.tree import tree_flatten

    cfg = model.cfg
    rng = np.random.default_rng(0)
    batch = tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(HEAD_WIDTH_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    flash = kernels[0].make_flash_attn()

    def loss_fn(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=flash)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    names = _leaf_names(params)
    g_kern = tree_flatten(_grads(loss_fn, params, batch))[0]
    loss_p, g_plain = _plain_loss_grads(torch, kernels, model, params, batch)
    rel = _leaf_rel(dict(zip(names, g_kern)), dict(zip(names, g_plain)),
                    qk_apart=True)
    print(f"  (c) first-step gradients vs the plain versions: "
          f"{_rel_text(rel)} (tol {KFRUN_GRAD_REL_L2} but q/k, C10)")
    check(all(bool(torch.isfinite(g).all()) for g in g_kern),
          "non-finite gradients")
    check(rel["worst"] <= KFRUN_GRAD_REL_L2,
          f"gradient of {rel['leaf']} differs from the plain versions' by "
          f"{rel['worst']} > {KFRUN_GRAD_REL_L2}")
    del g_kern, g_plain

    comm = Communicator(devices=["cuda:0"])
    tx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis)
    step = dp_train_step(loss_fn, tx, comm)
    p, o = params, tx.init(params)
    want = {k: 0 for k in _counts(kernels)}
    want.update(flash_fwd=cfg.n_layers, flash_bwd_dq=cfg.n_layers,
                flash_bwd_dkv=cfg.n_layers, xent_fwd=1, xent_bwd=1)
    losses, times, launches = [], [], dict.fromkeys(want, 0)
    for i in range(HEAD_WIDTH_STEPS):
        _reset(kernels)
        t0 = time.perf_counter()
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
        per_step = _counts(kernels)
        check(per_step == want, f"step {i} launched {per_step}, expected "
              f"{want}")
        launches = {k: launches[k] + per_step[k] for k in want}
    print(f"  (c) first loss {losses[0]:.6f}, through the plain versions "
          f"{float(loss_p):.6f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"loss did not fall over {HEAD_WIDTH_STEPS} steps: {losses}")
    step_ms = statistics.median(times[1:])
    toks = HEAD_WIDTH_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"  (c) train: losses {[round(x, 4) for x in losses]}, step ms "
          f"{[round(t, 2) for t in times]} (median of steps 2-"
          f"{HEAD_WIDTH_STEPS} {step_ms:.2f}), {toks:.0f} tokens/s; "
          f"launches a step {want}")
    return {"launches": launches, "losses": losses, "loss_plain":
            float(loss_p), "grad_rel": rel, "step_ms": step_ms,
            "step_ms_all": times, "tokens_s": toks}


def phase_head_widths(torch, np, kernels, tr) -> dict:
    """Phase 26: the forward, the serving engine and the training step
    at Pythia-2.8B's and Pythia-1B's widths (``HEAD_WIDTH_MODELS``)."""
    import threading

    attention = kernels[0]
    gib = 2 ** 30
    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    peak, stop = [total - free], threading.Event()
    print(f"head widths memory before: {(total - free) / gib:.2f} of "
          f"{total / gib:.2f} GiB in use, this process "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB allocated and "
          f"{torch.cuda.memory_reserved() / gib:.2f} reserved by PyTorch; "
          f"{nvidia_smi()}", flush=True)

    def poll():
        while not stop.wait(0.05):
            peak[0] = max(peak[0], total - torch.cuda.mem_get_info()[0])

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    out = {"launches": dict.fromkeys(_counts(kernels), 0), "models": {},
           "mem_before_gib": (total - free) / gib}
    try:
        for name, widths in HEAD_WIDTH_MODELS.items():
            t0 = time.perf_counter()
            cfg = tr.TransformerConfig(**widths, **HEAD_WIDTH_COMMON)
            model = tr.Transformer(cfg)
            d = cfg.d_model // cfg.n_heads
            dp, _ = attention.kernel_head_dim(d)
            params = model.init(torch.Generator().manual_seed(0),
                                device="cuda")
            print(f"head widths {name}: d_model {cfg.d_model}, "
                  f"{cfg.n_heads} heads of {d} (the kernels run {dp}), "
                  f"{cfg.n_layers} layers, d_ff {cfg.d_ff}, vocab "
                  f"{cfg.vocab_size}", flush=True)
            ids = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, size=(4, 256))).cuda()
            with torch.inference_mode():
                fwd = phase_forward(torch, attention, tr, model, params, ids)
                print(f"  (a) forward: {fwd['ms']:.3f} ms, "
                      f"{fwd['tokens_s']:.0f} tokens/s, logits vs xla "
                      f"{fwd['logits_err']:.3e}")
                serve = _head_width_serve(torch, np, model, params)
            train = _head_width_train(torch, np, kernels, tr, model, params)
            out["launches"]["flash_fwd"] += fwd["launches"]
            for k, n in train["launches"].items():
                out["launches"][k] += n
            out["models"][name] = {"head_dim": d, "head_dim_run": dp,
                                   "forward": fwd, "serve": serve,
                                   "train": train,
                                   "wall_s": time.perf_counter() - t0}
            print(f"head widths {name}: {out['models'][name]['wall_s']:.2f}"
                  f" s", flush=True)
            del model, params, ids
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        stop.set()
        poller.join()
    out["mem_peak_gib"] = peak[0] / gib
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"head widths phase: {out['phase_s']:.2f} s; the card's memory in "
          f"use {out['mem_before_gib']:.2f} GiB before, "
          f"{out['mem_peak_gib']:.2f} at its peak (read every 50 ms); "
          f"launches {out['launches']}")
    return out


def _stamp(n: int, name: str) -> None:
    """The line that places a phase in the output: its number, its
    name and the wall clock at its start."""
    print(f"phase {n} {name}: start {time.strftime('%Y-%m-%d %H:%M:%S')}",
          flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.ops import collectives as rc
    from kungfu_tpu_torch.ops import costmodel
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.ops.cuda import collectives as ringk
    from kungfu_tpu_torch.ops.cuda import lm_head as lmk
    from kungfu_tpu_torch.ops.triton import xent as xk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. probe
    _stamp(1, "probe")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    print(f"probe: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name!r} capability {cap} "
          f"count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"compute capability {cap}, the kernels target 9.0")
    spec = costmodel.card_spec(name)
    check(spec is not None, f"no datasheet entry for {name!r}")

    # 2. build
    _stamp(2, "build")
    build = build_all(torch, attention, lmk, ringk)

    # 3. kernels against their plain versions
    _stamp(3, "kernels")
    t0 = time.perf_counter()
    fwd_errs, fwd_timing = phase_flash_forward(torch, attention, spec)
    bwd_errs, bwd_timing = phase_flash_backward(torch, attention, spec)
    xent_errs, xent_timing = phase_xent(torch, xk, spec)
    torch.cuda.empty_cache()
    lmh_errs, lmh_timing = phase_lm_head(torch, lmk, spec)
    torch.cuda.empty_cache()
    ring_timing = phase_ring(torch, ringk, rc, spec)
    print(f"kernels phase: {time.perf_counter() - t0:.2f} s")

    # 4. + 5. the forward and serving paths, without autograd graphs
    _stamp(4, "forward")
    model = tr.Transformer(tr.TransformerConfig(**FLAGSHIP))
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"init: {time.perf_counter() - t0:.2f} s")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, FLAGSHIP["vocab_size"], size=(4, 256))).cuda()
    with torch.inference_mode():
        fwd = phase_forward(torch, attention, tr, model, params, ids)
        _stamp(5, "serve")
        serve = phase_serve(torch, np, attention, model, params)
    del model, params
    torch.cuda.empty_cache()

    # 6. + 7. the training path, plain head then fused LM head; each
    # phase's peak memory is its own timed steps'
    kernels = (attention, xk, lmk, ringk)
    _stamp(6, "train, plain head")
    train = phase_train(torch, np, kernels, tr, costmodel, spec, "plain")
    torch.cuda.empty_cache()
    _stamp(7, "train, fused LM head")
    train_fused = phase_train(torch, np, kernels, tr, costmodel, spec, "fused")
    print(f"train, fused LM head against the plain head: "
          f"{train_fused['step_ms']:.2f} vs {train['step_ms']:.2f} ms/step, "
          f"peak {train_fused['peak_gib']:.2f} vs {train['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()

    # 8. + 9. the same step on four co-resident ranks: S-SGD, then ZeRO
    _stamp(8, "S-SGD")
    ssgd, ssgd_p1 = phase_ssgd(torch, np, kernels, tr, train["losses"][0])
    torch.cuda.empty_cache()
    _stamp(9, "ZeRO")
    zero2 = phase_zero(torch, np, kernels, tr, 2, ssgd_p1)
    torch.cuda.empty_cache()
    zero3 = phase_zero(torch, np, kernels, tr, 3, ssgd_p1)
    del ssgd_p1
    torch.cuda.empty_cache()

    # 10. bert_base() on the same ranks: SMA, AdaptiveSGD, the monitors
    # and the autotune of the allreduce schedule
    _stamp(10, "replicas")
    t0 = time.perf_counter()
    bert = _bert_build(torch, np, tr, kernels)
    replicas = phase_replicas(torch, np, kernels, tr, costmodel, spec, bert)
    print(f"replicas phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 11. ZeRO-2 through a live 4 -> 2 -> 4 resize of the same ranks
    _stamp(11, "elastic")
    t0 = time.perf_counter()
    elastic = phase_elastic(torch, np, kernels, tr)
    print(f"elastic phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 12. the host engine: system.py's --backend host loop on bert_base()
    _stamp(12, "host engine")
    host_engine = phase_host_engine(torch, np, kernels, tr, bert,
                                    replicas["gns"])
    print(f"host engine phase: {host_engine['phase_s']:.2f} s")
    torch.cuda.empty_cache()

    # 13. the peer runtime: a rank killed mid-collective, the survivors
    # shrunk and replayed, a whole-job preemption restored from manifests
    _stamp(13, "recover")
    recover = phase_recover(torch, np, kernels, tr)
    print(f"recover phase: {recover['wall_s']:.2f} s")
    torch.cuda.empty_cache()

    # 14. pair-averaging gossip on bert_base() over four peers
    _stamp(14, "gossip")
    gossip = phase_gossip(torch, np, kernels, tr, bert)
    print(f"gossip phase: {gossip['phase_s']:.2f} s")
    torch.cuda.empty_cache()

    # 15. the adaptation plane: the device bandit on bert_base()'s S-SGD
    # steps, the host bandit and the interference driver under chaos
    _stamp(15, "adapt")
    adapt = phase_adapt(torch, np, kernels, tr, bert)
    print(f"adapt phase: {adapt['phase_s']:.2f} s")
    del bert
    torch.cuda.empty_cache()

    # 16. the serving plane on the flagship: six workers and a router
    # through a worker kill and a slice kill, the autoscale loop over the
    # live aggregator, a warm KV cache across a cold restart
    _stamp(16, "serve plane")
    serve_plane = phase_serve_plane(torch, np, attention, tr)
    torch.cuda.empty_cache()

    # 17. the in-mesh 4-D plan: the flagship over sixteen co-resident
    # ranks, f32 at the reference's tolerances, ring attention alone, MoE
    _stamp(17, "sharded")
    sharded = phase_sharded(torch, np, kernels, tr, spec)
    print(f"sharded phase: {sharded['phase_s']:.2f} s")
    torch.cuda.empty_cache()

    # 18. the cross-host pipeline: the flagship over two emulated slices
    # of two peers, three schedules, a slice kill re-carved, tp in a stage
    _stamp(18, "pipeline")
    pipeline = phase_pipeline(torch, np, kernels, tr, spec)
    torch.cuda.empty_cache()

    # 19. the image models and the data plane: ResNet-50 S-SGD on one and
    # four ranks, f32 card vs CPU, ImageNet/MNIST through prefetch, VGG-16
    _stamp(19, "images")
    images = phase_images(torch, np, kernels, spec)
    torch.cuda.empty_cache()

    # 20. the launcher: bert_base() in four worker processes under
    # `python -m kungfu_tpu_torch -monitor`, then a real worker death
    # relaunched from the epoch checkpoint by -auto-recover
    _stamp(20, "launcher")
    kfrun = phase_kfrun(torch, np, kernels)
    torch.cuda.empty_cache()

    # 21. the sentinel plane and the trace tools on the flagship: a planted
    # step-time regression caught online and replayed offline, the
    # decision ledger, the recompile watermark, device_trace and kftrace,
    # the torch shim
    _stamp(21, "sentinel")
    sentinel = phase_sentinel(torch, np, kernels, tr)
    torch.cuda.empty_cache()

    # 22. the port's kf-lint and kf-verify over this checkout and over a
    # copy with one planted fault per rule family; no kernel launches
    _stamp(22, "analysis")
    analysis = phase_analysis()
    # phase 23's four workers share the card with this process: let go of
    # what the earlier phases' cycles still hold
    gc.collect()
    torch.cuda.empty_cache()

    # 23. the multi-process device world: bert_base() in four worker
    # processes of one provisioned world, re-carved 2 -> 4 -> 2, the ring
    # kernels across processes through CUDA IPC
    _stamp(23, "world")
    world = phase_world(torch, np, kernels, spec, kfrun)
    torch.cuda.empty_cache()

    # 24. the reference's example entry points, in this process: long
    # context at the flagship's width over four sp ranks, the 4-D
    # trainer, the strategy tour and the serving demo
    _stamp(24, "examples")
    examples = phase_examples(torch, np, kernels, spec)
    torch.cuda.empty_cache()

    # 25. the compose-style elastic cluster: scripts/cluster_torch.py's
    # config server and two watch runners, elastic_mnist on the card
    # through 2 -> 4 -> 2; four more CUDA contexts share the card with
    # this process, so let go of what the earlier phases still hold
    gc.collect()
    torch.cuda.empty_cache()
    _stamp(25, "cluster")
    cluster = phase_cluster(torch)

    # 26. the port's entry points at Pythia-2.8B's and Pythia-1B's widths:
    # 80-wide heads padded to the 96-wide kernels, 256-wide heads
    gc.collect()
    torch.cuda.empty_cache()
    _stamp(26, "head widths")
    head_widths = phase_head_widths(torch, np, kernels, tr)
    fwd_timing["ring_s8192"] = examples["ring_rows"]["timing"]["fwd"]
    bwd_timing["ring_s8192"] = {
        part: examples["ring_rows"]["timing"][part] for part in ("dq", "dkv")}
    paths = (train, train_fused, ssgd, zero2, zero3, replicas, elastic,
             host_engine, recover, gossip, adapt, sharded, pipeline, images,
             kfrun, sentinel, world, examples, head_widths)

    def row(name, route, source, replaces, key, err, timing, others=None):
        extra = {k: timing[k] for k in ("plain_head_ms", "bound_fp32_ms",
                                        "bound_executed_ms", "split_ms",
                                        "host_us") if k in timing}
        # the same kernel at other main-path shapes: phase 10's, phase 17's
        for label, other in (others or {}).items():
            extra.update({f"{label}_{k}": other[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "host_us",
                "head_dim_run", "bound_executed_ms") if k in other})
        return {"name": name, "route": route, "source": source,
                "replaces": replaces,
                "launches": (fwd["launches"] + serve["launches"]
                             + serve_plane["launches"]["served"]
                             if key == "flash_fwd" else 0)
                + sum(path["launches"][key] for path in paths),
                "max_abs_err": err,
                **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
                **extra}

    def ring_row(name, replaces, key, kind):
        # the fused S-SGD shape; the 4 MiB ZeRO bucket at four ranks and
        # at two (phase 11), phase 17's widest leaf at two, and phase 19's
        # widest and narrowest ResNet-50 leaf at four beside it.  Both
        # kernels are held bitwise, so the error is 0
        out = row(name, "cuda", cu + "ring.cu", replaces, key, 0.0,
                  ring_timing["fused"][kind])
        for label in ("bucket", "bucket_k2", "leaf_k2", "resnet_leaf",
                      "resnet_small"):
            out.update({f"{label}_{k}": ring_timing[label][kind][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "host_us")})
        # phase 23's process-spanning shape: one launch a process, four
        # processes, and the stacked single call on the same buffers
        span = world["ring_span"][kind]
        out.update({f"span_{k}": span[k] for k in (
            "ms", "wall_ms", "stacked_ms", "plain_ms", "library_ms",
            "bound_ms")})
        out["span_launches"] = world["launches"][key]
        # phase 24's autotune probes, outside ``launches``
        out["autotune_probe_launches"] = examples["probe_launches"][key]
        return out

    cu = "kungfu_tpu_torch/ops/cuda/csrc/"
    tri = "kungfu_tpu_torch/ops/triton/xent.py"
    other_flash = (("bert", "bert_s512"), ("ring_s512", "ring_s512"),
                   ("ring_s1024", "ring_s1024"), ("ring_s8192", "ring_s8192"),
                   ("pythia_2p8b", "pythia_2p8b"), ("pythia_1b", "pythia_1b"))
    pal = "kungfu_tpu/ops/pallas/"
    rows = [
        row("attention._fwd_kernel", "cuda", cu + "flash_fwd.cu",
            pal + "attention.py:77", "flash_fwd",
            fwd_errs["train_main"]["o_err"], fwd_timing["s2048"],
            {lb: fwd_timing[sh] for lb, sh in other_flash}),
        row("attention._bwd_dq_kernel", "cuda", cu + "flash_bwd.cu",
            pal + "attention.py:241", "flash_bwd_dq",
            bwd_errs["main"]["dq_err"], bwd_timing["s2048"]["dq"],
            {lb: bwd_timing[sh]["dq"] for lb, sh in other_flash}),
        row("attention._bwd_dkv_kernel", "cuda", cu + "flash_bwd.cu",
            pal + "attention.py:288", "flash_bwd_dkv",
            bwd_errs["main"]["dkv_err"], bwd_timing["s2048"]["dkv"],
            {lb: bwd_timing[sh]["dkv"] for lb, sh in other_flash}),
        row("xent._fwd_kernel", "triton", tri, pal + "xent.py:49",
            "xent_fwd", xent_errs["main"]["loss_err"],
            xent_timing["main"]["fwd"], {"bert": xent_timing["bert"]["fwd"]}),
        row("xent._bwd_kernel", "triton", tri, pal + "xent.py:163",
            "xent_bwd", xent_errs["main"]["dlogits_err"],
            xent_timing["main"]["bwd"], {"bert": xent_timing["bert"]["bwd"]}),
        row("lm_head._fwd_kernel", "cuda", cu + "lm_head.cu",
            pal + "lm_head.py:60", "lm_head_fwd",
            lmh_errs["main"]["loss_err"], lmh_timing["fwd"]),
        row("lm_head._bwd_dh_kernel", "cuda", cu + "lm_head.cu",
            pal + "lm_head.py:113", "lm_head_bwd_dh",
            lmh_errs["main"]["dh_err"], lmh_timing["dh"]),
        row("lm_head._bwd_dw_kernel", "cuda", cu + "lm_head.cu",
            pal + "lm_head.py:139", "lm_head_bwd_dw",
            lmh_errs["main"]["dw_err"], lmh_timing["dw"]),
        ring_row("collectives._rs_kernel", pal + "collectives.py:287",
                 "ring_rs", "rs"),
        ring_row("collectives._ag_kernel", pal + "collectives.py:359",
                 "ring_ag", "ag"),
    ]
    for k in rows:
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd", "ring_rs", "ring_ag"):
        check(replicas["launches"][key] > 0,
              f"phase 10 never launched {key}")
        check(elastic["launches"][key] > 0,
              f"phase 11 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd"):
        check(host_engine["launches"][key] > 0,
              f"phase 12 never launched {key}")
        check(recover["launches"][key] > 0,
              f"phase 13 never launched {key}")
        check(gossip["launches"][key] > 0,
              f"phase 14 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd", "ring_rs", "ring_ag"):
        check(adapt["launches"][key] > 0, f"phase 15 never launched {key}")
        check(sharded["launches"][key] > 0, f"phase 17 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd"):
        check(pipeline["launches"][key] > 0, f"phase 18 never launched {key}")
    for key in ("ring_rs", "ring_ag"):
        check(images["launches"][key] > 0, f"phase 19 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd"):
        check(kfrun["launches"][key] > 0, f"phase 20 never launched {key}")
        check(sentinel["launches"][key] > 0, f"phase 21 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd", "ring_rs", "ring_ag"):
        check(world["launches"][key] > 0, f"phase 23 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(examples["launches"][key] > 0, f"phase 24 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd"):
        check(head_widths["launches"][key] > 0,
              f"phase 26 never launched {key}")
    print("details: " + json.dumps({
        "forward": fwd, "serve": serve, "train": train,
        "train_fused_head": train_fused, "ssgd_4_ranks": ssgd,
        "zero2_4_ranks": zero2, "zero3_4_ranks": zero3,
        "replicas_bert_4_ranks": replicas, "elastic_4_2_4": elastic,
        "host_engine_bert_4_ranks": host_engine,
        "recover_gpt_4_3_2": recover, "gossip_bert_4_peers": gossip,
        "adapt_bert_4_ranks_3_peers": adapt,
        "serve_plane_flagship_6_workers": serve_plane,
        "sharded_flagship_16_ranks": sharded,
        "pipeline_flagship_2_slices_of_2": pipeline,
        "images_resnet50_vgg16_data": images,
        "kfrun_bert_4_processes": kfrun,
        "sentinel_flagship_3_peers": sentinel,
        "analysis_lint_verify": analysis,
        "world_bert_4_processes": world,
        "examples_entry_points": examples,
        "cluster_compose_2_hosts": cluster,
        "head_widths_pythia_2p8b_1b": head_widths,
        "ring_timing": ring_timing, "build": build,
        "flash_fwd_errors": fwd_errs, "flash_fwd_timing": fwd_timing,
        "flash_bwd_errors": bwd_errs, "flash_bwd_timing": bwd_timing,
        "xent_errors": xent_errs, "xent_timing": xent_timing,
        "lm_head_errors": lmh_errs, "lm_head_timing": lmh_timing}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def lm_head_case_main(name: str) -> int:
    """``--lm-head-case NAME``: one case of ``LMH_CASES`` (phase 3 runs
    each edge case so), its result as a ``LMH_CASE`` JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.ops.cuda import lm_head as lmk

    torch.backends.cuda.matmul.allow_tf32 = False
    print("LMH_CASE " + json.dumps(lm_head_case(torch, lmk, name)))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--lm-head-case"]:
            sys.exit(lm_head_case_main(sys.argv[2]))
        if sys.argv[1:2] == ["--kfrun-worker"]:
            sys.exit(kfrun_worker_main(sys.argv[2:]))
        if sys.argv[1:2] == ["--world-worker"]:
            sys.exit(world_worker_main(sys.argv[2:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
