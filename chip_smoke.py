#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Thirteen paths, each through the entry points a user calls:

  * the paper's wafer-scale torus: 1024x1024 ``ManycoreCell`` cores running
    a two-phase ring allreduce, partitioned over 2 pods x 2x2 granules with
    all 8 granules batched on one card, through ``ChannelGraph`` ->
    ``Simulation`` -> ``FusedEngine``, whose epoch is one call of the
    hand-written ``granule_step`` kernel
    (``src/repro_torch/kernels/csrc/granule_step.cu``);
  * the paper's systolic matmul (§IV-B): a 1024x1024 grid of
    ``SystolicCell`` MAC cores computing the full 1024x1024 product
    ``Y = A @ B``, through ``ChannelGraph.grid`` -> ``RegisterGridEngine``
    -> ``Simulation``, whose epoch of K = 62 cycles is one call of the
    hand-written ``systolic_step`` kernel
    (``src/repro_torch/kernels/csrc/systolic_step.cu``);
  * the same matmul on the generic fused engine: ``FusedEngine.grid`` of
    1024x1024 ``SystolicCell``s -> ``Simulation``, whose epoch of K = 62
    cycles is one call of ``granule_step``, stepping the cells with the
    kernel's SystolicCell device step (the kernel also runs programs of
    several groups and of several block types in one launch a cycle);
  * the fused host-I/O path: ``make_chain`` / ``make_ring`` of
    ``PipeStage``s through ``Simulation`` -> ``FusedEngine``, the chain fed
    and drained by the host, each epoch one call of ``granule_step`` with
    the kernel's PipeStage device step (the reference's
    ``benchmarks/sim_throughput.py`` chain session on the fused engine);
  * the queue interpreter: the same wafer and matmul on ``GraphEngine``
    and its ``GridEngine`` preset (``build(engine="graph")``), plain
    PyTorch on the card as the reference's ``GraphEngine`` is plain XLA
    (it reaches no Pallas kernel), run to the end in the device loop;
  * the session surface (``core/session.py``): monitors, ``trace``,
    ``save``/``load`` through ``checkpoint/checkpointing.py`` and the
    ``obs`` schema and report, on all four engines and on wafer-1M through
    ``FusedEngine`` (``granule_step``; the register engine's
    ``systolic_step`` in the small scenario);
  * real mesh axes (``core/mesh.py``): the wafer with its pods real (two
    shards of four batched granules) and on the reference example's
    all-real (pod, gr, gc) mesh (eight shards), and the systolic matmul on
    a 2x2 mesh of the register engine, every shard its own state on the
    one card, launching its own ``granule_step`` / ``systolic_step``
    programs, the exchange classes that leave a shard copied between
    shards;
  * the procs engine (``runtime/``): ``build(engine="procs")``, one
    free-running worker process a granule on the card, joined by
    shared-memory rings, each worker replaying its captured cycle graphs
    (plain PyTorch, as the reference's worker is plain XLA: it reaches no
    Pallas kernel), on the wafer at full width against ``GraphEngine``,
    and self-healing (``on_fault="recover"``): drilled faults healed by
    respawn, restore and replay, bit-identical to a fault-free fleet;
    with worker telemetry (``sim.trace``: a record a phase from every
    worker);
  * multi-host fleets (``runtime/bridge.py``, ``runtime/fleet.py``):
    ``hosts=2``, the granules on two launcher processes whose workers
    exchange across hosts only through a TCP ring bridge, every worker on
    the card, bit-identical to the single-host fleet, link faults healed;
  * LM serving: ``launch.serve.serve`` -> ``models.model.init_params`` ->
    ``prefill`` -> greedy ``decode_step``s for recurrentgemma-2b,
    xlstm-125m and the dense llama3.2-1b at their published widths (batch
    4, a 3,072-token prompt, 16 tokens), whose prefill runs the
    hand-written ``flash_attention``, ``rglru_scan`` and ``slstm_scan``
    kernels (``src/repro_torch/kernels/csrc/{flash_attention,rglru_scan,
    slstm_scan}.cu``; the sLSTM kernel also serves every decode step);
  * the MoE, vision-language and audio models: ``models.model.init_params``
    -> ``prefill`` -> greedy ``decode_step``s for qwen3-moe-235b-a22b and
    llama4-maverick-400b-a17b (``attn_moe``, ``models/moe.py``) and for
    qwen2-vl-72b (M-RoPE, from embeddings), and ``forward`` of the
    non-causal hubert-xlarge encoder over embeddings, at their published
    widths with only the depth cut, every attention layer through the
    hand-written ``flash_attention`` kernel;
  * training: ``launch.train.train`` -> ``launch.steps.make_train_step``
    (``models.model.loss_fn``, its gradients, ``optim.optimizer.AdamW``)
    over the synthetic ``data.pipeline.TokenPipeline``, for llama3.2-1b at
    its published widths and ``train_4k``'s 4,096-token sequence (batch
    4), then recurrentgemma-2b and xlstm-125m, every flash, RG-LRU and
    sLSTM call through its ``torch.autograd.Function``
    (``kernels/ops.py``): the Hopper kernel forward, the reference's
    backward in torch ops (the RG-LRU's reverse scan a kernel launch);
  * the XLA-only tooling's counterparts: ``launch.dryrun.run_lm_cell`` on
    the card (``launch.steps.cell_step``: the eager train, prefill and
    decode steps of a cell) for llama3.2-1b's ``train_4k``, ``prefill_32k``
    and ``decode_32k`` at its published widths, counted by
    ``launch.op_analysis`` (flash attention reporting its plain version's
    work), ``run_manycore`` on the card, and the ``single``/``multi``
    tables of every cell through ``launch.report``.

Phases (a failing phase raises, and the script exits non-zero):

  1. build   compile every kernel from the checkout's sources (nvcc,
             sm_90a; one nvcc for each source and, with rg-full, for each
             RG-LRU chunk variant, started together) and log ptxas's
             registers and spills for each instantiation.
  2. small   a 32x32 torus, 8 granules, tiers (2, 4), capacity 4: the
             kernel against the plain PyTorch version on a CPU copy, every
             state leaf bit-exact after each of 10 epochs, overlap off and on;
             then ``run_until`` in the device loop against the host loop
             (``run_until_host``) at budgets 0, 1, 3 and 1000 and spans of
             1, 3 and 8 epochs, overlap off and on: every leaf and the
             epoch count equal, the host loop launching once an epoch and
             the device loop once an epoch of each replayed span and of
             the capture's warm-up; and a predicate that calls ``bool()``
             must raise.
  3. full    the full-width wafer (1,048,576 cores, k_inner 16, k_outer 4,
             capacity 62): one epoch bit-exact against the plain version on
             a CPU copy; the kernel's and the plain version's times per
             simulated cycle on the card (medians over whole epochs) beside
             the memory bound counted from the run's tensors and data
             (``cycle_bytes``; also the earlier count, which read the
             inverse maps too); then
             ``Simulation.run(until=allreduce_done)`` through the kernel
             in the device loop (spans of epochs replayed from a CUDA
             graph, ``core.device_loop``), with the launch count set to 0
             just before and read just after (one an epoch of each
             replayed span and of the capture's warm-up), and every
             core's total checked against the global sum 4,718,592; then
             ``compare_loops``: the plain host loop on the same card must
             stop at the same cycle with a bit-identical state; the wall,
             core-cycles/s and host syncs of the first run (capture apart,
             as set-up), of a warm replay and of the host loop; and both
             loops under ``torch.profiler``, whose traces give the
             device's idle share and each kernel's time per simulated
             cycle.
  4. sys-small  the systolic kernel's MAC against ``hw.systolic.mac`` on
             2^20 random triples (one rounding, as the reference's FMA);
             then the register engine through the kernel against the same
             engine through the plain version, both on the card, every
             state leaf equal after every epoch to completion, at
             (M, R, C) = (12, 8, 8) and (33, 17, 23) one tile and
             (12, 8, 8) and (33, 18, 24) 2x2 tiles (17 x 23 does not split
             into 2x2 tiles), K = 2, 7 and 16, each under the default plan
             (the tile in one CTA) and with blocks below the tile, 3
             cycles a launch; and an interior tile fed only through its
             slabs with emission limits below K.
  5. sys-full  the full-width systolic matmul (1,048,576 cores, M = 1024,
             K = 62): set-up seconds; one mid-run epoch bit-exact against
             the plain version on the card; the kernel's plan (block, k,
             shared memory); for k = 1, 2, 4, 8 and 16, the kernel's call
             bit-exact against the plain version's call on the next
             epoch's input and its time per simulated cycle (medians over
             whole epochs); the plain version's time; the bound of one
             call (each input of the K-cycle call read once, each output
             written once) beside the per-cycle streaming count of the
             one-launch-a-cycle design; ``Simulation.run(until=every south
             cell collected M outputs)`` through the kernel in the device
             loop with the launch count set to 0 just before and read just
             after, Y held against the f64 product under the rounding bound
             of in-order FMA sums, gamma_R * (|A| @ |B|)
             (``hw.systolic.matmul_error_bound``); ``compare_loops`` as in
             ``full``, and the device loop's wall at spans of 1, 4, 8, 16
             and 32 epochs (each captured, then replayed warm three
             times); and the same run at 4x4 tiles, whose Y must equal the
             one-tile Y bit for bit.
  6. fsys-small  ``granule_step`` through the fused engine against the plain
             version (``epoch_program_ref``, called by name on a copy on the
             card), every state leaf bit-exact after every epoch to the end
             of the run (``kernels.fused_checks``): ``FusedEngine.grid`` of
             SystolicCells at (M, R, C) = (6, 4, 4) and (33, 17, 23), K = 1,
             3 and 62, Y within the bound; a grid of two SystolicCell
             groups; a ManycoreCell torus with SystolicCell relays in its
             rings beside a systolic grid (two block types, three groups),
             on one granule and on two batched ones.
  7. fsys-full  ``FusedEngine.grid(SystolicCell(1024), 1024, 1024, K=62)``
             on the sys-full operands: set-up seconds; one mid-run epoch
             bit-exact against ``epoch_program_ref`` on a copy on the card;
             the kernel's and the plain version's times per simulated cycle
             (medians over whole epochs from mid-run) beside the bound
             counted from the run's tensors and fires
             (``fsys_cycle_bytes``); ``Simulation.run(until=every south
             cell collected M outputs)`` in the device loop with the launch
             count set to 0 just before and read just after, Y
             bit-identical to ``RegisterGridEngine``'s Y on the same
             operands and within gamma_R * (|A| @ |B|), core-cycles/s and
             peak memory; ``compare_loops`` as in ``full``.
  8. fused-io  ``PipeStage``'s device step: ``make_chain(4)`` through the
             session on ``FusedEngine`` (K = 1 at capacity 2, every boundary
             bit-identical to ``NetworkSim`` on the card; K = 2 on one and on
             two granules, the packet sequence identical); 40 host-fed epochs
             of a 16-stage chain on 1, 2 and 4 granules and 12 epochs of a
             seeded 12-stage ring on 2, each bit-exact against
             ``epoch_program_ref`` on a copy on the card; the main path, the
             reference's ``_chain_session`` (``make_chain(4, capacity=8)``,
             K = 2, 200 packets) with the launch count set to 0 just before
             and read just after, every packet back in order and equal to
             ``NetworkSim``'s; then a chain of ``PIPE_N`` (1,048,576) stages
             fed from the host: set-up, one epoch bit-exact against the
             plain version, the kernel's and the plain version's ms a cycle
             (CUDA events) beside the byte bound (``pipe_cycle_bytes``),
             added to row 1 of the ``kernels`` line under ``pipestage``.
  9. graph-small  ``GraphEngine`` on a 32x32 torus, 8 granules, tiers
             (2, 4), capacity 4: the card (the queue array written in
             place) against the same engine on a CPU copy (the functional
             forms), every state leaf bit-exact after each of 10 epochs,
             overlap off and on; ``run_until`` in the device loop against
             the host loop at budgets 0, 1, 3 and 1000, the same stop epoch
             and state, neither kernel launched; against ``FusedEngine``
             (``granule_step``) at capacity 2 and K = (1, 1), every block
             state equal after every epoch; the heterogeneous SoC
             (``examples/torch_heterogeneous_soc.py``) at K = 1 bit-identical
             to ``NetworkSim`` on the card; a ``PipeStage`` chain driven
             through ``sim.tx``/``sim.rx``.
  10. graph-full  wafer-1M on ``GraphEngine`` (every channel a ring of 62,
             2 pods x 2x2 granules on the card): set-up seconds; one epoch
             bit-exact against a CPU copy; ``Simulation.run(until=
             allreduce_done)`` in the device loop with every total
             4,718,592 and no kernel launched; stop cycle, wall,
             core-cycles/s, host syncs, capture seconds, peak memory and
             the bytes a cycle counted from the run's tensors
             (``graph_cycle_bytes``); ``compare_loops`` against the host
             loop, with both loops traced over an 8-epoch window (idle
             share, device events a cycle); then ``GridEngine`` on the
             1024^2 systolic matmul at K = 62, whose Y must equal the
             register engine's bit for bit.
  11. session-small  the rest of the session surface on the card: the
             four-engine scenario of ``tests/test_session.py`` (a 6x4 @ 4x4
             systolic network on single, graph, fused and register: reset,
             ``run(cycles=12)``, ``save``, ``run(until)``, then a fresh
             session's ``load`` and resume), every Y bit-identical to the
             single engine's and each resume to its run; the interactive
             chain scenario (send, run, checkpoint, send more, drain) of
             Increment blocks on single and graph and of SystolicCell
             relays (``granule_step``'s device step) on single, graph and
             fused, equal across engines and across resume; monitor cadence
             on a 32x32 wafer on ``FusedEngine`` (10x1, 3+7 and 10 epochs
             sample alike) and ``run(until)`` with a monitor every 1, 3 and
             16 epochs stopping at the monitor-free cycle, state bit for bit;
             a traced host-I/O run, traffic bit-identical to the untraced
             one, its file valid (``obs.schema``) and summarized
             (``obs.report``); ``examples/torch_quickstart.py``; with
             ``granule_step`` and ``systolic_step`` launched.
  12. session-full  wafer-1M as a session on ``FusedEngine``:
             ``run(until=allreduce_done)`` without and with a monitor every
             16 epochs (reading ``sim.cycle`` and ``sim.probe(0).total``),
             both stopping at cycle 4,352 with the same state, samples at
             epochs 16, 32, 48 and 64, every core's final total 4,718,592;
             the warm walls, host syncs and captures of both; ``save`` at
             epoch 32 (seconds, bytes on disk), ``load`` into the running
             session (in place: its resume captures no span) and into a
             fresh one, both resuming to a final state bit-identical to the
             uninterrupted run; one warm ``run(epochs=8)`` traced, its
             state bit for bit the untraced run's; the ``epoch_window``
             span, which ends when the launches return (host time: the
             card's time is in the profiler's trace), beside the untraced
             window's wall, which waits for the card.
  13. mesh-small  real mesh axes, every shard on the card: the 32x32 wafer
             (tiers (2, 4), capacity 4) on ``GraphEngine`` and
             ``FusedEngine`` with the pods real and the granules batched
             and on the all-real (pod, gr, gc) mesh, overlap off and on,
             every leaf after each of 10 epochs bit-exact against the same
             sharded engine run on the CPU and, but for the credit columns
             (a real axis colors its classes per shift), against the
             one-shard run; ``run_until`` in the device loop stopping where
             the host loop and the one-shard run stop, state bit for bit;
             the register engine at (M, R, C) = (33, 18, 24), K = 3 and 62,
             on a 2x2 mesh, every epoch bit-exact against its CPU run and
             the 2x2 tiles stacked on one shard, one ``systolic_step``
             launch a shard an epoch, Y bit-identical to one tile's; a
             session of four SystolicCell relays whose host ports home on
             shards 3 and 1 (graph and fused): traffic and probes
             bit-identical to the CPU and the one-shard session, a save,
             an in-place load (addresses kept) whose resume equals a CPU
             session's resume from the same checkpoint.
  14. mesh-full  at full width, nothing cut, every shard on the card:
             the all-batch wafer-1M run (the ``full`` cell) as the
             yardstick; wafer-1M-pods (``FusedEngine``, pods real, 2
             shards of 4 granules: the inner tier resident in each shard's
             ``granule_step`` program, the pod tier across shards) and
             wafer-1M-mesh8 (the example's (2, 2, 2) mesh, 8 shards of one
             granule, every exchange across shards) through
             ``Simulation.run(until=allreduce_done)`` with the launch count
             set to 0 just before and read just after, stopping at cycle
             4,352 (68 epochs) with every block state bit-identical to the
             all-batch run's; ``compare_loops`` (the host loop's stop and
             state, a warm replay, both loops traced over 8 epochs: idle
             share, device events a cycle); the warm seconds beside the
             all-batch run's, the bytes that cross shards an epoch
             (``shard_move_bytes``) and their device time in a traced
             eager epoch (``trace_shard_moves``); systolic-1M-mesh
             (``RegisterGridEngine``, 2x2 mesh, 4 shards of 512x512): Y
             bit-identical to one tile's, the stop the 2x2-stacked tiles',
             ``compare_loops``, launches, bytes.
  15. procs-small  the procs engine, every worker on the card: the chain's
             host I/O script (K = 1, capacity 2, 2 workers) and the 4-worker
             non-zero-home script, traffic bit-identical to ``NetworkSim`` on
             the card; the 6x4 @ 4x4 systolic scenario on 4 workers
             (``run(cycles=12)``, ``save``, probe, ``run(until)``, a fresh
             fleet's ``load`` and resume), ``Y`` bit-identical; the 32x32
             wafer on 4 workers (``batch_signatures`` and ``overlap`` off,
             then both on), stop and blocks bit-identical to ``GraphEngine``
             on the same ``PartitionTree``; the recovery drills of
             ``tests/test_recovery.py`` (a 3-stage chain on 2 workers, K = 1,
             ``snapshot_every=2``): ``kill:1@5``, ``exit0:1@3``,
             ``corrupt:0@3`` and ``hang:1@3`` (timeout 8 s) under
             ``on_fault="recover"``, host trace and final ``gather_state``
             bit-identical to a fault-free fleet's with one restart, no
             worker or ``/dev/shm`` segment of the earlier incarnation left,
             and ``corrupt:0@3`` under ``raise`` raising
             ``RingCorruptionError``; SIGKILL of worker 1 raising
             ``WorkerDiedError`` naming it, "granule 1" in its log tail.
  16. procs-full  wafer-1M-procs4: ``configs/manycore.py::CONFIG`` at full
             width on the reference example's procs layout (2 pods x 2 row
             strips, 4 worker processes of 262,144 cores, all on the card),
             ``run(until=allreduce_done)``; then ``batch_signatures`` (2
             workers of 2 strips: the torus has two strip shapes) for
             ``PROCS_BATCH_EPOCHS`` (16) epochs; the yardstick
             ``GraphEngine`` on the same tree in one process: stop cycle and
             every block bit-identical, every total 4,718,592 (the
             batch_signatures run: every block after as many epochs).  Logs set-up (lowering, prebuild, rings,
             spawn, workers ready, capture), the run's seconds and
             core-cycles/s, rings and shared-memory bytes, ring ops and view
             bytes an epoch, each worker's run, busy, wait and capture
             seconds, and (plain) the card's idle share over 2 traced epochs.
             Then the plain fleet's until-run again inside ``sim.trace``
             (worker telemetry): its seconds against the untraced run's,
             each worker's epoch split into ingest, step, exchange issue,
             exchange commit and flush from the exported trace, records
             dropped and the ``perfmodel.model_drift`` gauge; then the
             fleet under ``on_fault="recover"`` with no fault by
             ``run(epochs=67)`` (a snapshot every 16): its seconds, the
             snapshots' count, seconds and bytes; and a fresh fleet with
             ``kill:1@40``: stop and blocks bit-identical to
             ``GraphEngine``'s, MTTR (its seconds less the fault-free
             recover run's) split into detect, teardown, backoff, respawn,
             restore, replay (8 epochs from the snapshot at 32) and the
             snapshots' excess.  (The until-mode recover run and kill
             drill, which PR 23 measured, are left out for time.)
  17. fleet-small  multi-host fleets on the card, ``tests/test_bridge.py``'s
             scenarios on ``hosts=2``: a 4-stage ``PipeStage`` chain at
             capacity 2 (4 workers, K = 1) under host I/O, traffic
             bit-identical to ``hosts=1`` and to ``NetworkSim``
             (cycle-accurate) and ``gather_state`` to ``hosts=1``, the
             follower launcher without CUDA; the same fleet traced
             (bit-identical, a track a worker, ``stats()["bridges"]`` valid
             under ``obs/schema.py``, a ``perfmodel.model_drift`` gauge), then
             ``linkkill`` armed on it under ``raise`` giving
             ``LinkDownError``; the systolic scenario saved on two hosts and
             loaded back into the running 2-host fleet, ``Y`` bit-identical
             both times, then ``linkcorrupt`` armed on it under ``raise``
             giving ``RingCorruptionError``; ``linkkill:0@3``,
             ``linkcorrupt:0@5:r1`` and ``linkslow:0@7:r2`` on one fleet under
             ``on_fault="recover"`` (two restarts, the slow pump absorbed),
             trace and ``gather_state`` bit-identical to the fault-free fleet;
             after every teardown no process (worker, bridge, follower and
             the follower's own), ``/dev/shm`` segment or listening port of
             the earlier incarnation left.
  18. fleet-full  wafer-1M-procs4-hosts2: wafer-1M-procs4 on ``hosts=2``
             (granules 0 and 1 on h0, 2 and 3 on h1; one link carrying the
             2,048 pod-tier channels, the strip tier in shared memory):
             ``run(until=allreduce_done)`` on a warm fleet, stop 4,352,
             every total 4,718,592, ``gather_state`` bit-identical to the
             single-host fleet's (procs-full's, or its own when procs-full
             did not run) and every block to ``GraphEngine``'s; logs the
             set-up split (blob, rings, workers ready, the follower's boot,
             rendezvous), the run's seconds beside procs4's and
             ``GraphEngine``'s in the same call, ``bridge_stats`` and its
             bytes a pod exchange, each worker's wait share; the fault-free
             recover ``run(epochs=67)``; then ``linkkill:0@40`` armed on
             that warm fleet under ``run(epochs=67)``: healed
             bit-identically, MTTR split with the re-rendezvous its own
             term, nothing of the first incarnation left.
  19. lm-small  each LM kernel against its plain version on the card, at
             the CPU tests' shapes (``kernels.lm_checks``): attention MHA,
             GQA and MQA, causal with and without a window, f32 (the
             CUDA-core route) and bf16 (the tensor-core route; each case
             must take its dtype's route), D up to 256, T not a multiple
             of 128; the RG-LRU with and without h0; the sLSTM at T = 1
             and longer, R in f32 and bf16, up to xlstm-125m's width.
  20. lm-dense  ``serve()`` with no arguments (llama3.2-1b at the smoke
             size, on the card); then llama3.2-1b at full width (16 layers,
             d 2048, GQA 32/8, head dim 64) through ``serve`` with the flash
             launch count set to 0 just before and read just after (16,
             all on the tensor-core route), every logit finite, and the
             first layer's flash call held against the plain version at the
             run's own inputs.
  21. rg-full  recurrentgemma-2b at full width (26 layers, d 2560, 8 local
             attention layers, window 2048): ``serve`` with every kernel's
             launch count set to 0 just before and read just after (8
             ``flash_attention``, all on the tensor-core route, 18
             ``rglru_scan``), every logit finite;
             set-up, prefill and decode rates, peak memory; then one
             layer's kernel inputs from that run, the kernel against its
             plain version at full shape, and the times of the kernel, the
             plain version and (attention) ``scaled_dot_product_attention``
             with the same mask, beside the bound counted from the inputs,
             and the kernel's ratios to both; for the RG-LRU also 11 calls
             that must give the same bits, its chunk sweep (the source's
             256 steps a CTA and the variants 64, 128, 512 built in
             ``build``, each held against the plain version) and its time
             at batch 1 beside that bound, its calls timed behind a held
             stream so that the wrapper's host time stays out (the served
             call also without); last, a warm prefill and one decode step
             under ``torch.profiler``: device idle share and time by kernel
             (``rglru_clear``: the RG-LRU's status clear).
  22. xl-full  xlstm-125m the same way (96 ``slstm_scan`` launches: 6 in the
             prefill, 6 in each of the 15 decode steps), at the first
             decode step's inputs and the first prefill's: the cluster
             plan, the T = 1 call by CUDA events and the wrapper's host
             time a call, us a step and the marginal step (T against T/2).
  23. lm-fam  the four ``SMOKE`` configs of qwen3-moe, llama4-maverick,
             qwen2-vl and hubert in f32, kernel-aligned (``use_kernels``, a
             256-token prompt; qwen2-vl and hubert a seeded (2, 256, d)
             embeddings tensor), from one ``init_params`` on the card and on
             the CPU: prefill and 4 greedy decode steps (hubert:
             ``forward``), logits within 1e-4 and greedy tokens identical,
             every MoE layer's routing indices identical, the flash kernel
             launched (its CUDA-core route); ``apply_mrope`` with three
             different position streams up to 8,192, card against CPU within
             1e-4 (the devices' ``pow`` may round a frequency an ulp apart,
             which the angle carries times the position).
  24. moe-full  qwen3-moe-235b-a22b (8 of 94 layers; 128 experts, top-8)
             then llama4-maverick-400b-a17b (2 of 48 layers, one attn /
             attn_moe stage; top-1 sigmoid, a shared expert) at their
             published widths: ``init_params``, ``prefill`` of 4 x 3,072
             seeded prompts and greedy ``decode_step``s to 16 tokens, with
             the flash launch counts set to 0 just before and read just
             after (8 and 2, all on the tensor-core route), every logit
             finite and the tokens in range; set-up, prefill and decode
             rates, peak memory, the share of the first MoE layer's prefill
             choices dropped by capacity; the first flash call held against
             its plain version at the run's own inputs and timed beside
             ``scaled_dot_product_attention`` (same mask) and the bound; the
             first MoE layer's dispatch (router and slots), scatter, expert
             GEMMs and combine timed by CUDA events; a warm prefill and one
             decode step under ``torch.profiler``: idle share, device time in
             the expert GEMMs, the dispatch and the combine.
  25. emb-full  qwen2-vl-72b (12 of 80 layers; M-RoPE 16/24/24) from a
             seeded (4, 3072, 8192) bf16 embeddings tensor through
             ``prefill`` and greedy ``decode_step``s (12 flash launches), then
             hubert-xlarge (all 48 layers; 16 heads of 80, non-causal) by
             ``forward`` over a seeded (4, 3072, 1280) embeddings tensor (48
             flash launches, D = 80 on the tensor-core route), with
             moe-full's checks, timings and trace.
  26. train-small  the gradient check: each ``Function`` of ``kernels/ops.py``
             (flash f32 and bf16, causal, windowed and not; the RG-LRU with
             and without h0; the sLSTM with f32 and bf16 R, a zero carry
             with m = -inf) on the card, its kernel path against its plain
             path (``lm_checks.plain_forward``) on the same inputs and
             output gradients: the output and every input's gradient within
             ``lm_checks.GRAD_TOL_*``, the kernel launched; then
             ``train("llama3.2-1b", smoke=True)`` for 24 steps with
             ``fail_at=(10, 19)`` and a checkpoint every 8 (2 restarts, the
             loss falling, every loss finite) and the resume-determinism
             pair of ``tests/test_system.py``.
  27. train-full  ``train`` at published widths: llama3.2-1b (1.236 B
             parameters, 16 layers) at 4 x 4,096 tokens for 20 steps, lr
             3e-3, the launch counts set to 0 just before and read just
             after (each attention layer twice a step: remat recomputes it),
             the loss falling and finite: set-up, step time, tokens/s, peak
             memory, the loss curve and grad norms; a traced warm step (idle
             share, top device ops, each backward's device time); then
             recurrentgemma-2b (2 x 4,096, 3 steps) and xlstm-125m (4 x
             2,048, 2 steps) the same way.  Each kernel's first call with
             grad: kernel path against plain path, the forward's times and
             bound, the backward's time beside the plain backward (autograd
             through the plain version) and ``scaled_dot_product_attention``'s
             backward (flash).
  28. dryrun-full  the dry-run on the card (``launch.dryrun``): llama3.2-1b
             ``train_4k`` at published widths, batch 4 (train-full's), the
             launch counts set to 0 just before and read just after: the
             arguments' bytes predicted from the specs equal to the bytes
             its params, moments and batch take on the card, the step timed
             beside train-full's, the op counts' roofline terms,
             ``dominant`` and ``useful_ratio``; ``prefill_32k`` and
             ``decode_32k`` at the batches the card holds (``reduced``);
             the counts through the kernels equal to those through their
             plain versions (``lm_checks.count_paths``; FLOPs exactly,
             bytes beside) at 2-layer cuts of llama3.2-1b ``train_4k``,
             recurrentgemma-2b ``prefill_32k`` and xlstm-125m prefill;
             ``run_manycore`` on the card; every record rendered through
             ``launch.report`` with the ``single``/``multi`` records of all
             10 architectures x 4 shapes and the manycore grid.

After the last phase the script stops the forkserver and resource tracker
the fleets started and checks that no process of the run is left (every one
carries the run's token in its environment). The output ends with a JSON line
describing each kernel, the card's name and power limit from nvidia-smi, and
the one-line result JSON.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,small,sys-small
    python3 chip_smoke.py --phases build,fsys-small,fsys-full
    python3 chip_smoke.py --phases build,fused-io,procs-small,procs-full
    python3 chip_smoke.py --phases build,graph-small,graph-full
    python3 chip_smoke.py --phases build,session-small,session-full
    python3 chip_smoke.py --phases build,mesh-small,mesh-full
    python3 chip_smoke.py --phases build,procs-small,procs-full
    python3 chip_smoke.py --phases build,fleet-small,fleet-full
    python3 chip_smoke.py --phases build,lm-small,lm-dense,rg-full,xl-full
    python3 chip_smoke.py --phases build,lm-small,lm-fam,moe-full,emb-full
    python3 chip_smoke.py --phases build,train-small,train-full
    python3 chip_smoke.py --phases build,dryrun-full
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
TOTAL = 4_718_592.0  # sum over the wafer of (arange(R*C) % 8) + 1
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores (NVIDIA data sheet)
KERNELS = ("granule_step", "systolic_step", "flash_attention", "rglru_scan",
           "slstm_scan")
#: rg-full's chunk sweep of the RG-LRU kernel: the source's chunk (256)
#: and these, built as variants (``-DRGLRU_CHUNK``).
RGLRU_SWEEP_VARIANTS = (64, 128, 512)
PHASES = ("build", "small", "full", "sys-small", "sys-full", "fsys-small",
          "fsys-full", "fused-io", "graph-small", "graph-full", "session-small", "session-full",
          "mesh-small", "mesh-full", "procs-small", "procs-full", "fleet-small",
          "fleet-full", "lm-small", "lm-dense", "rg-full", "xl-full", "lm-fam",
          "moe-full", "emb-full", "train-small", "train-full", "dryrun-full")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def to_cpu(tree):
    from repro_torch.core.struct import tree_map
    import torch

    return tree_map(
        lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree
    )


def wafer_engine(R, C, k_outer, k_inner, capacity, overlap, device, engine=None):
    """The wafer torus on 2 pods x 4 granules batched on one card, on
    ``engine`` (a class; ``FusedEngine`` by default)."""
    import numpy as np
    from repro_torch.core import ChannelGraph, tiered_grid_partition
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.manycore import ManycoreCell, make_core_params

    values = ((np.arange(R * C, dtype=np.int64) % 8) + 1).astype(np.float32)
    graph = ChannelGraph.torus(
        ManycoreCell(R, C), R, C, params=make_core_params(values.reshape(R, C)),
        capacity=capacity,
    )
    eng = (engine or FusedEngine)(
        graph, tiered_grid_partition(R, C, [(2, 1), (2, 2)]), None,
        tiers=[(("pod",), k_outer), (("g",), k_inner)],
        batch_axes={"pod": 2, "g": 4}, overlap=overlap, device=device,
    )
    return eng, values


def phase_small() -> None:
    import torch
    from repro_torch.core import device_loop
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.kernels import granule_step
    from repro_torch.kernels.fused_checks import compare

    for overlap in (False, True):
        eng, _ = wafer_engine(32, 32, 2, 4, 4, overlap, "cuda")
        gpu = eng.init(0)
        cpu = to_cpu(gpu)
        for ep in range(10):
            gpu = eng.run_epochs(gpu, 1)
            cpu = eng.run_epochs(cpu, 1)
            torch.cuda.synchronize()
            compare(gpu, cpu)
        cyc = int(gpu.cycle.reshape(-1)[0])
        log(f"[small] 32x32 tiers (2, 4) cap 4 overlap={overlap}: 10 epochs "
            f"({cyc} cycles) bit-exact against the plain version")

    # the device loop against the host loop: the stop cycle, every leaf and
    # the launch count, at budgets that cut the run and one that does not
    done = lambda s: allreduce_done(s.block_states[0])  # noqa: E731
    base = device_loop.SPAN
    try:
        for overlap in (False, True):
            eng, _ = wafer_engine(32, 32, 2, 4, 4, overlap, "cuda")
            for span in (1, 3, 8):
                device_loop.SPAN = span
                for budget in (0, 1, 3, 1000):
                    n0, c0 = granule_step.launches, until_counts()
                    host = eng.run_until_host(eng.init(0), done, budget)
                    n1, host_counts = granule_step.launches, counts_since(c0)
                    c1 = until_counts()
                    dev = eng.run_until(eng.init(0), done, budget)
                    n2 = granule_step.launches
                    torch.cuda.synchronize()
                    compare(dev, host)
                    epochs = int(host.epoch.reshape(-1)[0])
                    if n1 - n0 != epochs or host_counts["epochs"] != epochs:
                        raise AssertionError(
                            f"[small] the host loop launched {n1 - n0} times and "
                            f"counted {host_counts['epochs']} epochs for {epochs}")
                    check_loop_counts("small", "granule_step", n2 - n1,
                                      counts_since(c1), epochs)
                log(f"[small] overlap={overlap} span {span}: run_until at budgets 0, 1, "
                    f"3 and 1000 bit-exact against the host loop (stop cycle "
                    f"{int(dev.cycle.reshape(-1)[0])}, {epochs} epochs; the host loop "
                    f"{n1 - n0} launches, the device loop {n2 - n1})")
    finally:
        device_loop.SPAN = base
    try:
        eng.run_until(eng.init(0), lambda s: bool(done(s)), 10)
    except device_loop.HostSyncError as e:
        log(f"[small] a predicate that reads back raises: {str(e)[:60]}...")
    else:
        raise AssertionError("a predicate calling bool() did not raise")


# CoreState leaves ManycoreCell.step reads, and writes, every cycle: it
# never touches ``value``, and writes ``own`` and ``total`` only at the two
# phase ends (12 B a core in a whole run).
STEP_READS = ("phase", "sent", "rcvd", "own", "acc", "fwd", "fwd_v", "fires")
STEP_WRITES = ("phase", "sent", "rcvd", "acc", "fwd", "fwd_v", "fires")


def sends_x2(local) -> int:
    """Sum of ``fires`` plus the packets held in registers and boundary
    queues.  A core's ``fires`` counts its sends and accepts, and packets in
    flight change by sends less accepts, so between two epoch boundaries
    (when no exchange slab holds a packet) this grows by twice the packets
    sent."""
    import torch
    from repro_torch.core import queue as qmod

    q = local.queues
    held = int(local.reg_v.sum())
    if q.buf.shape[0] > 1:
        held += int(qmod.size(q).sum())
    return int(local.block_states[0].fires.sum(dtype=torch.int64)) + held


def cycle_bytes(local, consts, program, pushes: float,
                inverse_maps: bool = False) -> dict:
    """The least bytes one simulated cycle must move, each input read once
    and each output written once, counted from this run's tensors and data:

      * block state: the leaves of ``STEP_READS`` read, of ``STEP_WRITES``
        written;
      * registers: the valid flag and payload word 0 read, the flag written;
      * boundary queue rows: head, tail and the front's word 0 read, head
        and tail written;
      * the payload of each packet pushed (``pushes`` per cycle, counted in
        the timed window);
      * the port tables ``rx_idx`` and ``tx_idx``, read;
      * per epoch, amortized over its cycles: each exchange reads its tables
        and reads and writes its credits.  The packets an exchange moves
        between boundary rows are left out (``xchg_payload_max`` is the most
        they could add).

    Tables derived from the port tables (the inverse maps, the consumer
    table) are a kernel's choice, as scratch is, and are left out; with
    ``inverse_maps`` the inverse maps are counted too, as the earlier
    count of the two-launch design did."""
    def nb(x):
        return x.numel() * x.element_size()

    st = local.block_states[0]
    block = (sum(nb(getattr(st, f)) for f in STEP_READS)
             + sum(nb(getattr(st, f)) for f in STEP_WRITES))
    n_reg, W = local.reg_val.shape
    word = local.reg_val.element_size()
    regs = n_reg * (2 * local.reg_v.element_size() + word)
    q = local.queues
    rows = q.head.numel() if q.buf.shape[0] > 1 else 0
    queues = rows * (2 * (q.head.element_size() + q.tail.element_size()) + word)
    packets = pushes * W * word
    tables = sum(nb(x) for x in consts.rx_idx) + sum(nb(x) for x in consts.tx_idx)
    if inverse_maps:
        tables += (nb(consts.inv_tx) + nb(consts.inv_tx_mask) + nb(consts.inv_rx)
                   + nb(consts.inv_rx_mask))
    n_cycles = sum(a for op, a in program if op == "C")
    xchg = xchg_payload = 0
    for op, t in program:
        if op in ("X", "XC"):
            xchg += sum(nb(x[t]) for x in (consts.send_idx, consts.send_mask,
                                           consts.recv_idx, consts.recv_mask,
                                           consts.bat_fwd, consts.bat_rev))
            xchg += 2 * nb(local.credits[t])
            xchg_payload += 2 * consts.send_idx[t].numel() * consts.depths[t] * W * word
    per_cycle = block + regs + queues + packets + tables + xchg / n_cycles
    return {"block": block, "regs": regs, "queues": queues, "packets": packets,
            "tables": tables, "per_cycle": per_cycle, "n_cycles": n_cycles,
            "xchg_payload_max": xchg_payload / n_cycles}


def time_reps(fn, reps: int, hold: bool = False) -> list:
    """ms of each of ``reps`` calls of ``fn()``, by CUDA events around each
    call (the caller warms up first).  ``hold``: first hold the stream for
    ~10 ms (``torch.cuda._sleep``), so that the host has enqueued every call
    before the card reaches the first and the events time the card alone
    (for a call shorter than its wrapper's host time)."""
    import torch

    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(20_000_000)
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


def odd_program(program) -> tuple:
    """``program`` with its last cycle op one cycle shorter: an odd cycle
    count, whose end copies the parity buffers back (``copy_back``)."""
    i = max(j for j, (op, _) in enumerate(program) if op == "C")
    return tuple(program[:i]) + (("C", program[i][1] - 1),) + tuple(program[i + 1:])


def flag_cost(carry, program, consts, reps: int) -> dict:
    """ms a simulated cycle of the program kernel called without the
    until-loop's stop flag (``none``) and with it clear (``clear``), for
    ``program`` and for its odd-count form (``odd none``, ``odd clear``):
    the median of ``reps`` calls each, alternating, every call from the
    same state (the carry is assigned back before each)."""
    import statistics

    import torch
    from repro_torch.core.struct import tree_map
    from repro_torch.kernels import granule_step

    start = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, carry)
    clear = torch.zeros((), dtype=torch.bool, device=carry[0].device)
    odd = odd_program(program)
    cases = (("none", program, None), ("clear", program, clear),
             ("odd none", odd, None), ("odd clear", odd, clear))
    times = {key: [] for key, _, _ in cases}
    for _ in range(reps):
        for key, prog, stop in cases:
            assign(carry, start)
            n_cyc = sum(a for op, a in prog if op == "C")
            times[key] += [t / n_cyc for t in time_reps(
                lambda: granule_step.epoch_program_cuda(carry, prog, consts, stop), 1)]
    assign(carry, start)
    return {k: statistics.median(v) for k, v in times.items()}


def log_flag_cost(tag: str, flag: dict, reps: int) -> None:
    log(f"[{tag}] the kernel with the until-loop's stop flag clear: "
        f"{flag['clear']:.5f} ms a cycle, without the flag {flag['none']:.5f}; "
        f"the program one cycle shorter (odd count, ending in copy_back): "
        f"flag clear {flag['odd clear']:.5f}, without {flag['odd none']:.5f} "
        f"(medians of {reps} alternating calls from one state)")


KERNEL_NAMES = ("granule_cycle", "exchange_drain", "exchange_fill",
                "exchange_credit")


def traced_run(run, names=KERNEL_NAMES) -> dict:
    """Call ``run()`` under ``torch.profiler`` (device activity only) and
    read its trace: host wall seconds of the call, device busy seconds (the
    union of every device event's interval) and device seconds per kernel
    of ``names``.  ``busy`` is None when the trace holds no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    per_kernel = dict.fromkeys(names, 0.0)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi, name in spans:
        kernel = next((k for k in names if k in name), None)
        if kernel:
            per_kernel[kernel] += (hi - lo) * 1e-6
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    return {"wall": wall, "busy": busy_us * 1e-6 if spans else None,
            "per_kernel": per_kernel, "events": len(spans)}


def idle_share(trace: dict) -> str:
    if trace["busy"] is None:
        return "not measured (the trace holds no device event)"
    return f"{1.0 - trace['busy'] / trace['wall']:.4f}"


def until_counts() -> dict:
    """The device loop's counters in the registry: host syncs, epochs,
    spans, captures and capture seconds so far."""
    from repro_torch.obs.registry import REGISTRY

    snap = REGISTRY.snapshot()
    cap = snap.get("until.capture_s", {})
    return {"syncs": snap.get("until.host_syncs", 0.0),
            "epochs": snap.get("until.epochs", 0.0),
            "spans": snap.get("until.spans", 0.0),
            "captures": snap.get("until.captures", 0.0),
            "capture_s": cap.get("sum", 0.0) if isinstance(cap, dict) else 0.0}


def check_loop_counts(tag: str, kernel: str, launches: int, counts: dict,
                      epochs: int) -> None:
    """An until-run in the device loop launched ``kernel`` (one call an
    epoch) once an epoch of its capture's warm-up, a span with ``stop``
    set, and once an epoch of the span each time the graph replayed,
    no-op epochs included; and the loop counted the epochs the state ran
    (``counts``: ``counts_since`` over the run)."""
    from repro_torch.core import device_loop

    span = device_loop.SPAN
    want = span * (counts["spans"] + counts["captures"])
    if launches != want:
        raise AssertionError(
            f"[{tag}] {launches} {kernel} launches, not span {span} x "
            f"({int(counts['spans'])} replays + {int(counts['captures'])} warm-up)")
    if counts["epochs"] != epochs:
        raise AssertionError(f"[{tag}] the loop counted {counts['epochs']} epochs, "
                             f"the state ran {epochs}")


def counts_since(before: dict) -> dict:
    now = until_counts()
    return {k: now[k] - before[k] for k in now}


def assign(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into ``dst``'s, in place (the
    device loop's cached graph holds ``dst``'s addresses)."""
    import torch
    from repro_torch.core.struct import tree_leaves

    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if isinstance(d, torch.Tensor) and d.data_ptr() != s.data_ptr():
            d.copy_(s)


def compare_loops(tag: str, eng, sim, start, done, max_epochs: int, first: dict,
                  clone, same, cores: int, names=KERNEL_NAMES,
                  spans=None, trace_epochs=None) -> dict:
    """The until-run of the main path (already made by the caller, from
    ``start``: ``sim.run(until=done)`` through the device loop, ``first``
    its wall and counters) against the plain host loop
    (``run_until_host``) on the same card: the stop cycle and the final
    state (``same``) must be the host loop's.  Then, from ``start`` again,
    a warm replay of the device loop (the captured graph reused: the state
    is assigned in place), the host loop's wall, and both loops under the
    profiler.  ``spans``: the device loop's wall at each of these epochs a
    span (each captured anew, then replayed warm).  ``trace_epochs``: trace
    only that many epochs from ``start`` (a window of a run whose every
    cycle launches many small kernels; the device loop's span for that
    budget is captured before the traced replay), else the whole run.
    Logs one line a measurement; returns the numbers."""
    import torch
    from repro_torch.core import device_loop

    cycles = sim.cycle
    torch.cuda.synchronize()
    c0 = until_counts()
    t0 = time.perf_counter()
    host = eng.run_until_host(clone(start), done, max_epochs)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    host_syncs = counts_since(c0)["syncs"]
    host_cycles = int(host.cycle.reshape(-1)[0])
    if host_cycles != cycles:
        raise AssertionError(f"[{tag}] the device loop stopped at cycle {cycles}, "
                             f"the host loop at {host_cycles}")
    same(sim.state, host)
    del host

    def warm_run():
        assign(sim.state, start)
        torch.cuda.synchronize()
        c = until_counts()
        t = time.perf_counter()
        sim.run(until=done, max_epochs=max_epochs)
        sim.block_until_ready()
        wall = time.perf_counter() - t
        if sim.cycle != cycles:
            raise AssertionError(f"[{tag}] a warm replay stopped at cycle "
                                 f"{sim.cycle}, the first run at {cycles}")
        return wall, counts_since(c)

    warm_s, warm = warm_run()
    if warm["captures"]:
        raise AssertionError(f"[{tag}] a warm replay captured anew")
    log(f"[{tag}] device loop (span {device_loop.SPAN}): stop cycle {cycles} = the "
        f"host loop's, final state bit-identical to it; first run {first['wall']:.4f} "
        f"s wall of which capture {first['capture_s']:.4f} s (set-up), run "
        f"{first['wall'] - first['capture_s']:.4f} s, {int(first['syncs'])} host "
        f"syncs; warm replay {warm_s:.4f} s wall, {int(warm['spans'])} spans, "
        f"{int(warm['syncs'])} host syncs, {cores * cycles / warm_s:.4e} "
        f"core-cycles/s; host loop {host_s:.4f} s wall, {int(host_syncs)} host "
        f"syncs, {cores * cycles / host_s:.4e} core-cycles/s; warm device loop at "
        f"{host_s / warm_s:.2f}x the host loop's rate")

    budget, traced = max_epochs, cycles
    if trace_epochs is not None:
        budget = trace_epochs
        assign(sim.state, start)
        sim.run(until=done, max_epochs=budget)  # captures the window's span
        traced = sim.cycle - int(start.cycle.reshape(-1)[0])
    assign(sim.state, start)
    dev_trace = traced_run(lambda: sim.run(until=done, max_epochs=budget), names)
    if trace_epochs is None and sim.cycle != cycles:
        raise AssertionError(f"[{tag}] the traced replay stopped at cycle {sim.cycle}")
    host_start = clone(start)
    host_trace = traced_run(lambda: eng.run_until_host(host_start, done, budget),
                            names)
    del host_start
    window = "" if trace_epochs is None else f" ({trace_epochs} epochs, {traced} cycles)"
    for name, trace in (("device loop", dev_trace), ("host loop", host_trace)):
        kernels = "; ".join(f"{k} {v / traced * 1e6:.2f} us"
                            for k, v in trace["per_kernel"].items())
        busy = "not measured" if trace["busy"] is None else f"{trace['busy']:.4f} s"
        log(f"[{tag}-trace] {name}{window}: {trace['wall']:.4f} s wall, device busy "
            f"{busy} over {trace['events']} device events "
            f"({trace['events'] / traced:.1f} a simulated cycle), idle share "
            f"{idle_share(trace)}; per simulated cycle: {kernels}")
    out = {"warm_s": warm_s, "host_s": host_s, "warm_syncs": warm["syncs"],
           "host_syncs": host_syncs, "dev_trace": dev_trace, "host_trace": host_trace,
           "traced_cycles": traced}

    sweep = {}
    base = device_loop.SPAN
    try:
        for span in spans or ():
            device_loop.SPAN = span
            assign(sim.state, start)
            c = until_counts()
            t = time.perf_counter()
            sim.run(until=done, max_epochs=max_epochs)
            sim.block_until_ready()
            first_s, cap = time.perf_counter() - t, counts_since(c)["capture_s"]
            walls = [warm_run() for _ in range(3)]
            sweep[span] = [w for w, _ in walls]
            log(f"[{tag}] span {span}: capture {cap:.4f} s (first run {first_s:.4f} "
                f"s); warm replays {', '.join(f'{w:.4f}' for w in sweep[span])} s "
                f"wall, {int(walls[0][1]['spans'])} spans, "
                f"{int(walls[0][1]['syncs'])} host syncs a run")
    finally:
        device_loop.SPAN = base
    out["sweep"] = sweep
    return out


def phase_full(result: dict) -> None:
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import Simulation, device_loop
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.kernels import granule_step
    from repro_torch.kernels.fused_checks import clone, compare

    R, C = CONFIG.grid_rows, CONFIG.grid_cols
    t0 = time.perf_counter()
    eng, values = wafer_engine(R, C, CONFIG.k_outer, CONFIG.k_inner,
                               CONFIG.queue_capacity, False, "cuda")
    sim = Simulation(eng).reset(0)
    sim.block_until_ready()
    setup_s = time.perf_counter() - t0
    log(f"[full] {R}x{C} torus = {R * C} cores, {eng.G} granules batched, "
        f"tiers K={eng.K_tiers}, capacity {eng.capacity}, program "
        f"{eng._resident_program(0)}; set-up {setup_s:.2f} s")

    # one epoch: the kernel against the plain version on a CPU copy
    start = clone(sim.state)
    t1 = time.perf_counter()
    plain = eng.run_epochs(to_cpu(start), 1)
    plain_cpu_s = time.perf_counter() - t1
    kern = eng.run_epochs(clone(start), 1)
    torch.cuda.synchronize()
    err = compare(kern, plain)
    log(f"[full] one epoch bit-exact against the plain version on a CPU copy "
        f"(max |diff| {err}; the CPU copy took {plain_cpu_s:.2f} s)")

    # times per simulated cycle on the card: kernel vs plain PyTorch, the
    # median of each over whole epochs from the start of the run
    local = eng._local_view(clone(start))
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    program = eng._resident_program(0)
    consts = eng._consts(local.tables)
    n_cyc = sum(a for op, a in program if op == "C")
    n_before = granule_step.launches
    kernel = lambda: granule_step.epoch_program_cuda(carry, program, consts)  # noqa: E731
    kernel()  # warm-up
    torch.cuda.synchronize()
    reps = 10
    x2_before = sends_x2(local)
    k_times = [t / n_cyc for t in time_reps(kernel, reps)]
    pushes = (sends_x2(local) - x2_before) / 2 / (reps * n_cyc)
    flag = flag_cost(carry, program, consts, reps)
    granule_step.launches = n_before  # timing launches are not the main path
    ref_carry = carry

    def run_ref():
        nonlocal ref_carry
        ref_carry = granule_step.epoch_program_ref(
            eng._resident_cycle, ref_carry, program,
            exchange_fn=eng._resident_exchange,
            issue_fn=eng._resident_exchange_issue,
            commit_fn=eng._resident_exchange_commit, consts=consts)

    run_ref()  # warm-up
    p_times = [t / n_cyc for t in time_reps(run_ref, 7)]
    kern_ms, plain_ms = statistics.median(k_times), statistics.median(p_times)
    nbytes = cycle_bytes(local, consts, program, pushes)
    bound_ms = nbytes["per_cycle"] / HBM_BYTES_PER_S * 1e3
    old_count = cycle_bytes(local, consts, program, pushes, inverse_maps=True)
    old_ms = old_count["per_cycle"] / HBM_BYTES_PER_S * 1e3
    per_core = {k: nbytes[k] / (R * C) for k in
                ("per_cycle", "block", "regs", "queues", "packets", "tables")}
    log(f"[full] per simulated cycle at {R * C} cores (median over {reps} "
        f"kernel and {len(p_times)} plain epochs): kernel {kern_ms:.5f} ms "
        f"({min(k_times):.5f}-{max(k_times):.5f}), plain PyTorch on the card "
        f"{plain_ms:.4f} ms ({min(p_times):.4f}-{max(p_times):.4f}), "
        f"{plain_ms / kern_ms:.1f}x the kernel; memory bound {bound_ms:.5f} ms, "
        f"kernel at {kern_ms / bound_ms:.2f}x it")
    log_flag_cost("full", flag, reps)
    log("[full] bound per core and cycle: " + ", ".join(
        f"{k} {v:.2f} B" for k, v in per_core.items())
        + f" ({pushes / (R * C):.4f} packets pushed a core and cycle); "
        f"exchange payloads left out, at most "
        f"{nbytes['xchg_payload_max'] / nbytes['per_cycle']:.2%} of the bound")
    log(f"[full] the earlier count (the inverse maps counted too): "
        f"{old_count['per_cycle'] / (R * C):.2f} B a core, {old_ms:.5f} ms a "
        f"cycle, kernel at {kern_ms / old_ms:.2f}x it")
    del carry, ref_carry, local, start, plain, kern

    # the main path: Simulation.run(until=allreduce_done) through the
    # kernel, in the device loop (spans of epochs replayed from a CUDA graph)
    sim.reset(0)
    sim.block_until_ready()
    start = clone(sim.state)
    torch.cuda.reset_peak_memory_stats()
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    granule_step.launches = 0
    c0 = until_counts()
    t2 = time.perf_counter()
    sim.run(until=done, max_epochs=1000)
    sim.block_until_ready()
    run_s = time.perf_counter() - t2
    launches = granule_step.launches
    first = dict(counts_since(c0), wall=run_s)
    if launches <= 0:
        raise AssertionError("the main path launched the granule_step kernel 0 times")
    totals = eng.gather_group(sim.state, 0).total
    phases = eng.gather_group(sim.state, 0).phase
    if not (phases == 2).all():
        raise AssertionError(f"{int((phases != 2).sum())} cores did not finish")
    if not np.array_equal(totals, np.full_like(totals, TOTAL)):
        raise AssertionError(f"allreduce totals {np.unique(totals)[:5]} != {TOTAL}")
    if float(values.astype(np.float64).sum()) != TOTAL:
        raise AssertionError("wafer values do not sum to the expected total")
    cycles = sim.cycle
    check_loop_counts("full", "granule_step", launches, first, sim.epoch)
    run_only = run_s - first["capture_s"]
    log(f"[full] converged: every one of {R * C} cores holds total {TOTAL:.0f} "
        f"after {cycles} cycles ({sim.epoch} epochs); run {run_only:.3f} s "
        f"(wall {run_s:.3f} s less the capture's {first['capture_s']:.3f} s, "
        f"set-up), set-up {setup_s:.2f} s; {R * C * cycles / run_only:.4e} "
        f"core-cycles/s; granule_step launches {launches}; device memory in use "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the host loop on the same card, warm replays, and both loops under
    # the profiler: the device's idle share and each kernel's device time
    # per simulated cycle, from the traces
    compare_loops("full", eng, sim, start, done, 1000, first, clone, compare, R * C)
    granule_step.launches = launches
    del start
    result.update(
        name="granule_step", route="cuda",
        source="src/repro_torch/kernels/csrc/granule_step.cu",
        replaces="src/repro/kernels/granule_step.py:306",
        block_type="ManycoreCell", block_types=["ManycoreCell", "SystolicCell", "PipeStage"],
        launches=launches, max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None,
    )


# ------------------------------------------------------------ systolic path
SYS_M = SYS_R = SYS_C = 1024  # the paper's grid; the full product Y = A @ B
SYS_K = 62  # the paper's queue depth, the largest K of the JAX K-sweep
SYS_SEED = 0
SYS_SWEEP = (1, 2, 4, 8, 16)  # cycles a launch of systolic_step's sweep
SPAN_SWEEP = (1, 4, 8, 16, 32)  # epochs a captured span of the device loop


def sys_operands(M, R, C, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)


def sys_graph(A, B):
    """The systolic grid's IR, built without a Python loop per cell.  Its
    (R, C, M) stream buffer is numpy zeros with A in column 0 only, so the
    host touches a few MB of it."""
    from repro_torch.core import ChannelGraph
    from repro_torch.hw.systolic import SystolicCell, make_cell_params

    return ChannelGraph.grid(SystolicCell(A.shape[0]), *B.shape,
                             params=make_cell_params(A, B))


def phase_sys_small() -> None:
    from repro_torch.kernels import systolic_step as sk
    from repro_torch.kernels.systolic_checks import (
        check_engine, check_interior_tile, check_mac)

    # the MAC: the kernel's __fmaf_rn against mac() on the card and on the
    # CPU (an exact FMA there), and against multiply-then-add
    two = check_mac(1 << 20, SYS_SEED)
    log(f"[sys-small] MAC: kernel __fmaf_rn == mac() on the card == mac() on "
        f"the CPU on {1 << 20} triples; multiply-then-add differs in {two}")

    cases = [((12, 8, 8), (1, 1)), ((33, 17, 23), (1, 1)),
             ((12, 8, 8), (2, 2)), ((33, 18, 24), (2, 2))]
    for (M, R, C), tiles in cases:
        Tr, Tc = R // tiles[0], C // tiles[1]
        for K in (2, 7, 16):
            # the default plan (the tile in one CTA, one launch a call), and
            # blocks below the tile with a halo, 3 cycles a launch
            for plan in (None, sk.tile_plan(Tr, Tc, K, k=3,
                                            block=(max(1, Tr // 3), max(1, Tc // 2)))):
                epochs, cycles = check_engine(M, R, C, K, tiles, M + R + C + K, plan)
                shown = plan or sk.tile_plan(Tr, Tc, K)
                log(f"[sys-small] (M, R, C)={(M, R, C)} tiles={tiles} K={K}, blocks "
                    f"{shown.block} k={shown.k}: {epochs} epochs ({cycles} cycles) "
                    f"bit-exact against the plain version; Y within the bound")

    # an interior tile fed only through its slabs, limits below K
    emitted = check_interior_tile((3, 2))
    log(f"[sys-small] interior tile fed through its slabs, limits 3/2 < K=8: "
        f"4 calls bit-exact against the plain version ({emitted} packets out)")


def sys_cycle_bytes(cell: dict, d_west_fires: int, d_collects: int,
                    n_cycles: int) -> dict:
    """The per-cycle streaming count: the bytes one simulated cycle moves
    when every leaf is read and written every cycle (the design of one
    launch a cycle), counted from this run's tensors and data:

      * per cell read: ``b``, ``a_reg``, ``a_v``, ``p_reg``, ``p_v`` and the
        four flags; written: both registers and both valid flags;
      * ``a_idx`` read on the ``is_west`` cells and ``y_idx`` on the
        ``is_south`` cells, the only cells whose step uses them;
      * per west-cell fire (counted in the timed window): the ``a_buf``
        element read and ``a_idx`` written; per collect: the ``y_buf``
        element and ``y_idx`` written.

    The slabs are left out: with one tile nothing crosses them."""
    def nb(k):
        x = cell[k]
        return x.numel() * x.element_size()

    reads = sum(nb(k) for k in ("b", "a_reg", "a_v", "p_reg", "p_v", "is_west",
                                "is_north", "is_south", "is_east"))
    idx = (int(cell["is_west"].sum()) * cell["a_idx"].element_size()
           + int(cell["is_south"].sum()) * cell["y_idx"].element_size())
    writes = sum(nb(k) for k in ("a_reg", "a_v", "p_reg", "p_v"))
    word = cell["a_buf"].element_size() + cell["a_idx"].element_size()
    edges = idx + (d_west_fires + d_collects) * word / n_cycles
    return {"reads": reads, "writes": writes, "edges": edges,
            "per_cycle": reads + writes + edges}


def sys_call_bytes(cell: dict, d_west_fires: int, d_collects: int,
                   n_calls: int) -> float:
    """The least bytes one K-cycle call must move, each input of the call
    read once and each output written once (the bound of a kernel that
    keeps the cells on chip across cycles), from this run's tensors and
    data: ``b``, the registers, valid flags and four flags of every cell
    read and the registers and valid flags written; ``a_idx`` read and
    written on the ``is_west`` cells and ``y_idx`` on the ``is_south``
    cells; the ``a_buf`` elements the call streams and the ``y_buf``
    elements it collects (counted over ``n_calls`` timed calls).  The
    slabs are left out: with one tile nothing crosses them."""
    c = sys_cycle_bytes(cell, 0, 0, 1)
    idx = (int(cell["is_west"].sum()) * cell["a_idx"].element_size()
           + int(cell["is_south"].sum()) * cell["y_idx"].element_size())
    stream = (d_west_fires + d_collects) * cell["a_buf"].element_size() / n_calls
    return c["reads"] + c["writes"] + 2 * idx + stream


def phase_sys_full(result: dict) -> None:
    import gc
    import statistics

    import numpy as np
    import torch
    from repro_torch.core import Simulation, device_loop
    from repro_torch.core.fastgrid import RegisterGridEngine
    from repro_torch.hw.systolic import matmul_error_bound
    from repro_torch.kernels import systolic_step as sk
    from repro_torch.kernels.systolic_checks import (
        assert_states_equal, check_call, clone_state)

    M, R, C, K = SYS_M, SYS_R, SYS_C, SYS_K
    t0 = time.perf_counter()
    A, B = sys_operands(M, R, C, SYS_SEED)
    graph = sys_graph(A, B)
    eng = RegisterGridEngine.from_graph(graph, K=K)
    sim = Simulation(eng).reset()
    sim.block_until_ready()
    setup_s = time.perf_counter() - t0
    log(f"[sys-full] {R}x{C} grid = {R * C} cores, M={M}, K={K}, tiles "
        f"{(eng.Dr, eng.Dc)}; a_buf and y_buf {M * R * C * 4 / 2**30:.0f} GiB "
        f"each; set-up {setup_s:.2f} s")

    # one mid-run epoch: the kernel against the plain version on the card
    n0 = (2 * M + R + C) // (2 * K)  # half way: every cell is busy
    sim.run(epochs=n0)
    sim.block_until_ready()
    t1 = time.perf_counter()
    plain = eng._epoch(clone_state(sim.state), step=sk.systolic_step_ref)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    kern = eng._epoch(sim.state)
    torch.cuda.synchronize()
    err = assert_states_equal(kern, plain)
    log(f"[sys-full] epoch {n0 + 1} (cycles {n0 * K}-{(n0 + 1) * K}) bit-exact "
        f"against the plain version on the card (max |diff| {err}; the plain "
        f"epoch took {plain_s:.2f} s)")
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    # the plan, and each k of the sweep: bit-exact against the plain
    # version's call on this epoch's input, then timed per simulated cycle
    # (the median over whole epochs, continuing the run from here)
    Tr, Tc = eng.Tr, eng.Tc
    plan0 = sk.tile_plan(Tr, Tc, K)
    log(f"[sys-full] plan: blocks of {plan0.block[0]}x{plan0.block[1]} cells, "
        f"k = {plan0.k} cycles a launch, {plan0.smem} B of shared memory a CTA, "
        f"{plan0.launches} launches a call of {K} cycles")
    inp = eng.step_input(kern)
    del kern
    want = sk.systolic_step_ref(inp, K)
    n_before = sk.launches
    reps = 10
    total = lambda st, k: int(st[k].sum(dtype=torch.int64))  # noqa: E731
    sweep = {}
    for plan in (sk.tile_plan(Tr, Tc, K, k=k) for k in SYS_SWEEP):
        check_call(inp, K, plan, want)
        kstate = {key: v if key == "a_buf" else v.clone() for key, v in inp.items()}

        def kernel(plan=plan, kstate=kstate):  # each epoch continues the last
            out = sk.systolic_step_cuda(kstate, K, plan)
            kstate.update({key: out[key] for key in sk.CELL_OUT})

        kernel()  # warm-up
        torch.cuda.synchronize()
        a0, y0 = total(kstate, "a_idx"), total(kstate, "y_idx")
        times = [t / K for t in time_reps(kernel, reps)]
        sweep[plan.k] = (plan, times, total(kstate, "a_idx") - a0,
                    total(kstate, "y_idx") - y0)
        log(f"[sys-full] k = {plan.k}: blocks {plan.block[0]}x{plan.block[1]}, "
            f"{plan.smem} B a CTA, {plan.launches} launches a call; bit-exact "
            f"against the plain version's call; median {statistics.median(times):.5f} "
            f"ms a cycle ({min(times):.5f}-{max(times):.5f}, {reps} calls)")
        del kstate
    sk.launches = n_before  # checking and timing launches are not the main path
    del want
    _, k_times, d_fires, d_collects = sweep[plan0.k]
    plain_reps = 3
    sk.systolic_step_ref(inp, K)  # warm-up
    p_times = [t / K for t in time_reps(lambda: sk.systolic_step_ref(inp, K),
                                        plain_reps)]
    kern_ms, plain_ms = statistics.median(k_times), statistics.median(p_times)
    stream = sys_cycle_bytes(inp, d_fires, d_collects, reps * K)
    stream_ms = stream["per_cycle"] / HBM_BYTES_PER_S * 1e3
    call = sys_call_bytes(inp, d_fires, d_collects, reps)
    bound_ms = call / K / HBM_BYTES_PER_S * 1e3
    log(f"[sys-full] per simulated cycle at {R * C} cores (k = {plan0.k}, median "
        f"over {reps} kernel and {plain_reps} plain epochs of {K} cycles): kernel "
        f"{kern_ms:.5f} ms ({min(k_times):.5f}-{max(k_times):.5f}), plain "
        f"PyTorch on the card {plain_ms:.4f} ms ({min(p_times):.4f}-"
        f"{max(p_times):.4f}), {plain_ms / kern_ms:.1f}x the kernel")
    log(f"[sys-full] bound of one call (each input of the {K}-cycle call read "
        f"once, each output written once): {call / (R * C):.3f} B a core a call, "
        f"{bound_ms:.6f} ms a cycle, kernel at {kern_ms / bound_ms:.1f}x it; the "
        f"per-cycle streaming count (every leaf read and written every cycle): "
        f"{stream['per_cycle'] / (R * C):.3f} B a core a cycle, {stream_ms:.5f} ms, "
        f"kernel at {kern_ms / stream_ms:.2f}x it ({d_fires} stream reads and "
        f"{d_collects} collects in {reps * K} timed cycles)")
    del inp
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: Simulation.run(until=every south cell has M outputs),
    # in the device loop
    sim.reset()
    sim.block_until_ready()
    start = clone_state(sim.state)
    torch.cuda.reset_peak_memory_stats()
    done = eng.y_done
    sk.launches = 0
    c0 = until_counts()
    t2 = time.perf_counter()
    sim.run(until=done, max_epochs=1000)
    sim.block_until_ready()
    run_s = time.perf_counter() - t2
    launches = sk.launches
    first = dict(counts_since(c0), wall=run_s)
    if launches <= 0:
        raise AssertionError("the main path launched the systolic_step kernel 0 times")
    cycles, epochs = sim.cycle, sim.epoch
    Y = eng.result(sim.state)
    Y64 = A.astype(np.float64) @ B.astype(np.float64)
    tol = matmul_error_bound(A, B)
    err_y = np.abs(Y - Y64)
    if Y.shape != (M, C) or not np.isfinite(Y).all() or not (err_y <= tol).all():
        raise AssertionError(f"Y off the f64 product: max |err| {err_y.max()}, "
                             f"max err/bound {(err_y / tol).max()}")
    check_loop_counts("sys-full", "systolic_step", launches, first, epochs)
    run_only = run_s - first["capture_s"]
    log(f"[sys-full] done: every south cell collected {M} outputs after "
        f"{cycles} cycles ({epochs} epochs); Y {Y.shape} within "
        f"gamma_R*(|A|@|B|) of the f64 product (max |err| {err_y.max():.3e}, "
        f"max err/bound {(err_y / tol).max():.4f}, max |Y| "
        f"{np.abs(Y64).max():.2f}); run {run_only:.3f} s (wall {run_s:.3f} s "
        f"less the capture's {first['capture_s']:.3f} s, set-up), set-up "
        f"{setup_s:.2f} s; {R * C * cycles / run_only:.4e} core-cycles/s; "
        f"systolic_step launches {launches} ({int(first['spans'])} replayed spans of "
        f"{device_loop.SPAN} epochs and one span's warm-up); device memory in use "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the host loop on the same card, warm replays, both loops under the
    # profiler, and the device loop's span sweep
    compare_loops("sys-full", eng, sim, start, done, 1000, first, clone_state,
                  assert_states_equal, R * C, ("systolic_window",), SPAN_SWEEP)
    sk.launches = launches
    sim._state = None
    del start
    gc.collect()
    torch.cuda.empty_cache()

    # the same run on 4x4 tiles: the result does not depend on the partition
    eng4 = RegisterGridEngine.from_graph(graph, K=K, tiles=(4, 4))
    sim4 = Simulation(eng4).reset()
    t3 = time.perf_counter()
    sim4.run(until=eng4.y_done)
    sim4.block_until_ready()
    run4_s = time.perf_counter() - t3
    Y4 = eng4.result(sim4.state)
    if not np.array_equal(Y4.view(np.uint32), Y.view(np.uint32)):
        raise AssertionError("Y at tiles (4, 4) differs from Y at tiles (1, 1)")
    log(f"[sys-full] tiles (4, 4) of {eng4.Tr}x{eng4.Tc}: Y bit-identical to one tile "
        f"after {sim4.cycle} cycles ({sim4.epoch} epochs), run {run4_s:.3f} s")
    sim4._state = None
    result.update(
        name="systolic_step", route="cuda",
        source="src/repro_torch/kernels/csrc/systolic_step.cu",
        replaces="src/repro/kernels/systolic_step.py:176",
        launches=launches, max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None,
    )

# ---------------------------------------------- the fused engine beyond the wafer
FSYS_SMALL = ((6, 4, 4), (33, 17, 23))
FSYS_K = (1, 3, 62)


def phase_fsys_small() -> None:
    import numpy as np
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.systolic import (SystolicCell, make_cell_params,
                                         matmul_error_bound)
    from repro_torch.kernels import fused_checks as fc

    for M, R, C in FSYS_SMALL:
        for K in FSYS_K:
            A, B = fc.operands(M, R, C, seed=M + K)
            eng = FusedEngine.grid(SystolicCell(M), R, C, K=K,
                                   params=make_cell_params(A, B))
            epochs, st = fc.check_engine(eng, fc.network_done(eng), 1000)
            Y = fc.grid_result(eng, st, 0, R, C, M)
            err = np.abs(Y - A.astype(np.float64) @ B.astype(np.float64))
            if not (err <= matmul_error_bound(A, B)).all():
                raise AssertionError(f"[fsys-small] {(M, R, C)} K={K}: Y off the bound")
            log(f"[fsys-small] FusedEngine.grid (M, R, C)={(M, R, C)} K={K}: "
                f"{epochs} epochs ({int(st.cycle.reshape(-1)[0])} cycles) bit-exact "
                f"against epoch_program_ref on the card; Y within the bound")
    A, B = fc.operands(9, 6, 5, seed=5)
    nets = {
        "two SystolicCell groups": (fc.two_group_systolic(A, B, capacity=4)[0], {}),
        "ManycoreCell torus with SystolicCell relays + systolic grid": (
            fc.mixed_network(A, B, 4, 5, capacity=4)[0], {}),
        "the same on 2 batched granules": (
            fc.mixed_network(A, B, 4, 5, capacity=4)[0],
            dict(partition=np.arange(54) % 2, tiers=[(("g",), 3)],
                 batch_axes={"g": 2})),
    }
    for name, (net, kw) in nets.items():
        eng = net.build(engine="fused", session=False, device="cuda",
                        **{"K": 3, **kw})
        epochs, st = fc.check_engine(eng, fc.network_done(eng), 1000)
        types = [type(g.block).__name__ for g in eng.graph.groups]
        log(f"[fsys-small] {name}: groups {types}, {eng.B} granule(s): {epochs} "
            f"epochs bit-exact against epoch_program_ref on the card")


def fsys_cycle_bytes(local, consts, fired, n_cycles: int) -> dict:
    """The least bytes one simulated cycle of the SystolicCell grid must
    move, each input read once and each output written once, counted from
    this run's tensors and data (``fired``: each cell's fires over the
    ``n_cycles`` timed cycles, on the card):

      * every cell: ``b`` and the four flags read; the port tables
        ``rx_idx`` and ``tx_idx`` read;
      * every register: its valid flag read and written;
      * west cells: ``a_idx`` read (their ``a_valid``);
      * per fire: ``fires`` read and written; a west fire reads its
        ``a_buf`` element and writes ``a_idx``; a south fire reads and
        writes ``y_idx`` and writes its ``y_buf`` element; a fire pops
        ``[a, tag]`` from a west register and ``psum`` from a north one
        (where they are not synthesized) and pushes ``[a, tag]`` east and
        ``[y, tag]`` south (where not dropped).

    The consumer table is a kernel's choice and is left out, as in
    ``cycle_bytes``.  With one granule there are no queue rows."""
    import torch

    st = local.block_states[0]
    word = local.reg_val.element_size()
    n = st.b.numel()
    per_cell = (st.b.element_size() + 4 * st.is_west.element_size()
                + (consts.rx_idx[0].element_size() + consts.tx_idx[0].element_size()) * 2)
    regs = local.reg_v.numel() * 2 * local.reg_v.element_size()
    west = int(st.is_west.sum()) * st.a_idx.element_size()
    f = fired.to(torch.int64)

    def fires(mask):
        return int(f[mask].sum())

    total = int(f.sum())
    per_fire = (2 * st.fires.element_size() * total
                + (word + st.a_idx.element_size()) * fires(st.is_west)
                + (2 * st.y_idx.element_size() + word) * fires(st.is_south)
                + 2 * word * fires(~st.is_west) + word * fires(~st.is_north)
                + 2 * word * fires(~st.is_east) + 2 * word * fires(~st.is_south))
    per_cycle = n * per_cell + regs + west + per_fire / n_cycles
    return {"per_cycle": per_cycle, "cells": n * per_cell, "regs": regs,
            "fires": per_fire / n_cycles, "fire_rate": total / n / n_cycles}


def phase_fsys_full(result: dict) -> None:
    import gc
    import statistics

    import numpy as np
    import torch
    from repro_torch.core import Simulation, device_loop
    from repro_torch.core.fastgrid import RegisterGridEngine
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.systolic import (SystolicCell, make_cell_params,
                                         matmul_error_bound)
    from repro_torch.kernels import fused_checks as fc
    from repro_torch.kernels import granule_step

    M, R, C, K = SYS_M, SYS_R, SYS_C, SYS_K
    A, B = sys_operands(M, R, C, SYS_SEED)
    # the register engine's Y on the same operands, the yardstick of (c)
    reg = RegisterGridEngine.from_graph(sys_graph(A, B), K=K)
    rsim = Simulation(reg).reset()
    rsim.run(until=reg.y_done)
    Y_reg, reg_cycles = reg.result(rsim.state), rsim.cycle
    del reg, rsim
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = FusedEngine.grid(SystolicCell(m_stream=M), R, C, K=K,
                           params=make_cell_params(A, B))
    sim = Simulation(eng).reset(0)
    sim.block_until_ready()
    setup_s = time.perf_counter() - t0
    done = fc.network_done(eng)
    log(f"[fsys-full] FusedEngine.grid: {R}x{C} SystolicCells = {R * C} cores, "
        f"M={M}, K={K}, {eng.G} granule, program {eng._resident_program(0)}; "
        f"{eng.n_reg} registers; set-up {setup_s:.2f} s")

    # (a) one mid-run epoch: the kernel against epoch_program_ref on a copy,
    # both on the card
    n0 = (2 * M + R + C) // (2 * K)
    sim.run(epochs=n0)
    sim.block_until_ready()
    t1 = time.perf_counter()
    plain = fc.plain_epochs(eng, fc.clone(sim.state))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    kern = eng.run_epochs(fc.clone(sim.state), 1)
    torch.cuda.synchronize()
    err = fc.compare(kern, plain)
    log(f"[fsys-full] epoch {n0 + 1} (cycles {n0 * K}-{(n0 + 1) * K}) bit-exact "
        f"against epoch_program_ref on a copy on the card (max |diff| {err}; the "
        f"plain epoch took {plain_s:.2f} s)")
    del plain, kern
    gc.collect()
    torch.cuda.empty_cache()

    # (d) ms a simulated cycle: the kernel (CUDA events, whole epochs from
    # mid-run on) and the plain version on the card, beside the bound
    local = eng._local_view(sim.state)
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    program = eng._resident_program(0)
    consts = eng._consts(local.tables)
    n_cyc = sum(a for op, a in program if op == "C")
    n_before = granule_step.launches
    kernel = lambda: granule_step.epoch_program_cuda(carry, program, consts)  # noqa: E731
    kernel()  # warm-up
    torch.cuda.synchronize()
    reps = 10
    f0 = local.block_states[0].fires.clone()
    k_times = [t / n_cyc for t in time_reps(kernel, reps)]
    fired = local.block_states[0].fires - f0
    flag = flag_cost(carry, program, consts, reps)
    granule_step.launches = n_before  # timing launches are not the main path
    ref_carry = carry

    def run_ref():
        nonlocal ref_carry
        ref_carry = granule_step.epoch_program_ref(
            eng._resident_cycle, ref_carry, program, consts=consts)

    run_ref()  # warm-up
    p_times = [t / n_cyc for t in time_reps(run_ref, 2)]
    kern_ms, plain_ms = statistics.median(k_times), statistics.median(p_times)
    nbytes = fsys_cycle_bytes(local, consts, fired, reps * n_cyc)
    bound_ms = nbytes["per_cycle"] / HBM_BYTES_PER_S * 1e3
    log(f"[fsys-full] per simulated cycle at {R * C} cores (median over {reps} "
        f"kernel and {len(p_times)} plain epochs of {n_cyc} cycles): kernel "
        f"{kern_ms:.5f} ms ({min(k_times):.5f}-{max(k_times):.5f}), plain PyTorch "
        f"on the card {plain_ms:.4f} ms ({min(p_times):.4f}-{max(p_times):.4f}), "
        f"{plain_ms / kern_ms:.1f}x the kernel; memory bound {bound_ms:.5f} ms "
        f"({nbytes['per_cycle'] / (R * C):.2f} B a core: cells "
        f"{nbytes['cells'] / (R * C):.2f}, registers {nbytes['regs'] / (R * C):.2f}, "
        f"per fire {nbytes['fires'] / (R * C):.2f} at {nbytes['fire_rate']:.4f} "
        f"fires a core and cycle), kernel at {kern_ms / bound_ms:.2f}x it")
    log_flag_cost("fsys-full", flag, reps)
    del carry, ref_carry, local, f0, fired
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the main path: Simulation.run(until=every south cell collected M
    # outputs) through the kernel
    sim.reset(0)
    sim.block_until_ready()
    start = fc.clone(sim.state)
    torch.cuda.reset_peak_memory_stats()
    granule_step.launches = 0
    c0 = until_counts()
    t2 = time.perf_counter()
    sim.run(until=done, max_epochs=1000)
    sim.block_until_ready()
    run_s = time.perf_counter() - t2
    launches = granule_step.launches
    first = dict(counts_since(c0), wall=run_s)
    if launches <= 0:
        raise AssertionError("the fused systolic run launched granule_step 0 times")
    cycles, epochs = sim.cycle, sim.epoch
    peak = torch.cuda.max_memory_allocated()
    # (c) Y: bit-identical to the register engine's, within the bound
    Y = fc.grid_result(eng, sim.state, 0, R, C, M)
    Y64 = A.astype(np.float64) @ B.astype(np.float64)
    tol = matmul_error_bound(A, B)
    err_y = np.abs(Y - Y64)
    if Y.shape != (M, C) or not np.isfinite(Y).all() or not (err_y <= tol).all():
        raise AssertionError(f"Y off the f64 product: max |err| {err_y.max()}, "
                             f"max err/bound {(err_y / tol).max()}")
    if not np.array_equal(Y.view(np.uint32), Y_reg.view(np.uint32)):
        raise AssertionError("the fused engine's Y differs from the register engine's")
    check_loop_counts("fsys-full", "granule_step", launches, first, epochs)
    run_only = run_s - first["capture_s"]
    log(f"[fsys-full] done: every south cell collected {M} outputs after {cycles} "
        f"cycles ({epochs} epochs; the register engine: {reg_cycles}); Y "
        f"bit-identical to RegisterGridEngine's and within gamma_R*(|A|@|B|) (max "
        f"err/bound {(err_y / tol).max():.4f}); run {run_only:.3f} s (wall "
        f"{run_s:.3f} s less the capture's {first['capture_s']:.3f} s, set-up), "
        f"set-up {setup_s:.2f} s; {R * C * cycles / run_only:.4e} core-cycles/s; "
        f"granule_step launches {launches} ({int(first['spans'])} replayed spans of "
        f"{device_loop.SPAN} epochs and one span's warm-up); device memory peak {peak / 2**20:.1f} MiB")

    # the host loop on the same card, warm replays, both loops under the
    # profiler
    compare_loops("fsys-full", eng, sim, start, done, 1000, first, fc.clone,
                  fc.compare, R * C, ("granule_cycle",))
    granule_step.launches = launches
    sim._state = None
    del start
    gc.collect()
    torch.cuda.empty_cache()
    result.update(
        name="granule_step[SystolicCell]", route="cuda",
        source="src/repro_torch/kernels/csrc/granule_step.cu",
        replaces="src/repro/kernels/granule_step.py:306",
        block_type="SystolicCell", block_types=["ManycoreCell", "SystolicCell", "PipeStage"],
        launches=launches, max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None,
    )


# ------------------------------------------------ the fused host-I/O path
PIPE_N = 1_048_576  # the timed chain's stages: the wafer cells' slot count
PIPE_K = 16  # its cycles an epoch (one launch a cycle)
PIPE_CAP = 8  # its queue capacity (the reference's make_chain default)


def pipe_cycle_bytes(local, consts, pushes: float) -> dict:
    """The least bytes one simulated cycle of a PipeStage network must
    move, each input read once and each output written once, counted from
    this run's tensors and data.  Every cycle: each register's valid flag
    read and written (the cycle's new flags), each boundary or external
    queue row's head, tail and front word 0 read and head and tail
    written, and the port tables ``rx_idx`` and ``tx_idx`` read.  Each
    handshake (``pushes`` a cycle, counted in the timed window): the
    stage's ``count`` read and written and the packet's payload read and
    written.  A stage that does not fire touches neither its ``count``
    nor a payload."""
    def nb(x):
        return x.numel() * x.element_size()

    count = local.block_states[0].count
    n_reg, W = local.reg_val.shape
    word = local.reg_val.element_size()
    regs = n_reg * 2 * local.reg_v.element_size()
    q = local.queues
    rows = q.head.numel() if q.buf.shape[0] > 1 else 0
    queues = rows * (2 * (q.head.element_size() + q.tail.element_size()) + word)
    tables = sum(nb(x) for x in consts.rx_idx) + sum(nb(x) for x in consts.tx_idx)
    block = pushes * 2 * count.element_size()
    packets = pushes * 2 * W * word
    return {"block": block, "regs": regs, "queues": queues, "packets": packets,
            "tables": tables, "per_cycle": block + regs + queues + packets + tables}


def chain_session(sim, n_pkts: int) -> list:
    """The reference's ``_chain_session`` traffic (``benchmarks/
    sim_throughput.py``): up to 4 packets sent at a time until ``n_pkts``
    are queued, 8 cycles run, the receiver drained, until every packet is
    back.  Returns the packets received, in order."""
    import numpy as np

    tx, rx = sim.tx("tx"), sim.rx("rx")
    out, queued = [], 0
    for _ in range(100_000):
        if sum(len(x) for x in out) >= n_pkts:
            break
        if queued < n_pkts:
            batch = [[float(queued + j), 0.0] for j in range(min(4, n_pkts - queued))]
            tx.send_many(batch)  # overflow parks in the host tier
            queued += len(batch)
        sim.run(cycles=8)
        out.append(np.asarray(rx.drain()))
    return out


def phase_fused_io(result: dict) -> None:
    """PipeStage's device step: the fused host-I/O path on the card."""
    import gc
    import statistics

    import numpy as np
    import torch
    from repro_torch.core.struct import tree_map
    from repro_torch.hw.pipestage import make_chain, make_ring
    from repro_torch.kernels import fused_checks as fc
    from repro_torch.kernels import granule_step

    # (a) the io_script through the session: K = 1 at capacity 2 per
    # boundary, K = 2 as a packet sequence, against NetworkSim on the card
    for K, cap, kw in ((1, 2, {}), (2, 8, {}),
                       (2, 8, dict(partition=[0, 0, 1, 1], tiers=[(("g",), 2)],
                                   batch_axes={"g": 2}))):
        want = io_script(make_chain(4, capacity=cap).build(device="cuda").reset(0))
        sim = make_chain(4, capacity=cap).build(engine="fused", device="cuda", K=K, **kw)
        before = granule_step.launches
        got = io_script(sim.reset(0))
        n = granule_step.launches - before
        if K == 1:
            same = len(got) == len(want) and all(np.array_equal(a, b)
                                                 for a, b in zip(want, got))
        else:
            same = np.array_equal(np.concatenate(want), np.concatenate(got))
        if not same or n <= 0:
            raise AssertionError(f"[fused-io] chain K={K} {kw}: traffic differs from "
                                 f"NetworkSim or no launch ({n})")
        log(f"[fused-io] make_chain(4, capacity={cap}) K={K} on FusedEngine, "
            f"{sim.engine.B} granule(s): {sum(len(t) for t in got)} packets "
            f"{'at every boundary' if K == 1 else 'in sequence'} bit-identical to "
            f"NetworkSim on the card; {n} granule_step launches")

    # (b) program epochs with PipeStage groups against epoch_program_ref on
    # a copy: a host-fed chain (1, 2 and 4 granules) and a seeded ring
    for K, g in ((1, 1), (2, 2), (4, 4)):
        kw = ({} if g == 1 else dict(partition=(np.arange(16) * g // 16).tolist(),
                                     tiers=[(("g",), K)], batch_axes={"g": g}))
        eng = make_chain(16, capacity=4, delta=0.5).build(
            engine="fused", session=False, device="cuda", K=K, **kw)
        popped = fc.check_io(eng, 40, seed=K)
        log(f"[fused-io] make_chain(16) K={K} on {g} granule(s): 40 host-fed epochs "
            f"bit-exact against epoch_program_ref on a copy on the card, {popped} "
            f"packets popped alike")
    eng = make_ring(12, capacity=4).build(
        engine="fused", session=False, device="cuda", K=2,
        partition=[0] * 6 + [1] * 6, tiers=[(("g",), 2)], batch_axes={"g": 2})
    kern = fc.seed_registers(eng.init(0), every=2)
    plain = fc.clone(kern)
    for _ in range(12):
        kern = eng.run_epochs(kern, 1)
        plain = fc.plain_epochs(eng, plain)
        torch.cuda.synchronize()
        fc.compare(kern, plain)
    log(f"[fused-io] make_ring(12) K=2 on 2 granules, registers seeded: 12 epochs "
        f"bit-exact against epoch_program_ref ({int(kern.block_states[0].count.sum())} "
        f"handshakes)")

    # (c) the main path: the reference's _chain_session (make_chain(4,
    # capacity=8), K = 2, 200 packets) through Simulation on FusedEngine,
    # the launch count set to 0 just before and read just after
    want = chain_session(make_chain(4, capacity=8).build(device="cuda").reset(0), 200)
    sim = make_chain(4, capacity=8).build(engine="fused", device="cuda", K=2).reset(0)
    sim.block_until_ready()
    granule_step.launches = 0
    t0 = time.perf_counter()
    got = chain_session(sim, 200)
    sim.block_until_ready()
    run_s = time.perf_counter() - t0
    launches = granule_step.launches
    got, want = np.concatenate(got), np.concatenate(want)
    expect = np.stack([np.arange(200, dtype=np.float32) + 4.0,
                       np.zeros(200, np.float32)], axis=1)
    if launches <= 0:
        raise AssertionError("[fused-io] the main path launched granule_step 0 times")
    if not (np.array_equal(got, want) and np.array_equal(got, expect)):
        raise AssertionError("[fused-io] _chain_session: packets differ")
    counts = [int(sim.probe(i).count) for i in range(4)]
    log(f"[fused-io] _chain_session on FusedEngine: 200 packets back in order, each "
        f"+4.0 (bit-identical to NetworkSim on the card), counts {counts}, "
        f"{sim.cycle} cycles in {run_s:.3f} s, granule_step launches {launches}")

    # (d) the timed chain: PIPE_N stages fed from the host, the kernel's and
    # the plain version's ms a simulated cycle beside the byte bound
    t0 = time.perf_counter()
    net = make_chain(PIPE_N, capacity=PIPE_CAP)
    net_s = time.perf_counter() - t0
    sim = net.build(engine="fused", device="cuda", K=PIPE_K).reset(0)
    sim.block_until_ready()
    setup_s = time.perf_counter() - t0
    eng = sim.engine
    for _ in range(64):  # host-fed warm-up: packets spread down the chain
        sim.tx("tx").send_many([[float(i), 0.0] for i in range(PIPE_CAP - 1)])
        sim.run(epochs=1)
        sim.rx("rx").drain()
    sim.tx("tx").send_many([[float(i), 1.0] for i in range(PIPE_CAP - 1)])
    sim.block_until_ready()
    start = fc.clone(sim.state)
    plain = fc.plain_epochs(eng, fc.clone(start))
    kern = eng.run_epochs(fc.clone(start), 1)
    torch.cuda.synchronize()
    err = fc.compare(kern, plain)
    del kern, plain
    local = eng._local_view(fc.clone(start))
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    program = eng._resident_program(0)
    consts = eng._consts(local.tables)
    n_cyc = sum(a for op, a in program if op == "C")
    n_before = granule_step.launches
    kernel = lambda: granule_step.epoch_program_cuda(carry, program, consts)  # noqa: E731
    kernel()  # warm-up
    torch.cuda.synchronize()
    reps = 10
    c0 = int(local.block_states[0].count.sum(dtype=torch.int64))
    k_times = [t / n_cyc for t in time_reps(kernel, reps)]
    pushes = (int(local.block_states[0].count.sum(dtype=torch.int64)) - c0) / (reps * n_cyc)
    granule_step.launches = n_before  # timing launches are not the main path
    ref_carry = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, carry)

    def run_ref():
        nonlocal ref_carry
        ref_carry = granule_step.epoch_program_ref(
            eng._resident_cycle, ref_carry, program,
            exchange_fn=eng._resident_exchange,
            issue_fn=eng._resident_exchange_issue,
            commit_fn=eng._resident_exchange_commit, consts=consts)

    run_ref()  # warm-up
    p_times = [t / n_cyc for t in time_reps(run_ref, 5)]
    kern_ms, plain_ms = statistics.median(k_times), statistics.median(p_times)
    nbytes = pipe_cycle_bytes(local, consts, pushes)
    bound_ms = nbytes["per_cycle"] / HBM_BYTES_PER_S * 1e3
    log(f"[fused-io] make_chain({PIPE_N}, capacity={PIPE_CAP}) at K={PIPE_K} on "
        f"FusedEngine: network {net_s:.2f} s, set-up {setup_s:.2f} s; one epoch from "
        f"a host-fed state bit-exact against the plain version on a copy (max |diff| "
        f"{err}); per simulated cycle (median over {reps} kernel and {len(p_times)} "
        f"plain epochs): kernel {kern_ms:.5f} ms ({min(k_times):.5f}-{max(k_times):.5f}), "
        f"plain PyTorch on the card {plain_ms:.4f} ms ({min(p_times):.4f}-"
        f"{max(p_times):.4f}), {plain_ms / kern_ms:.1f}x the kernel; memory bound "
        f"{bound_ms:.5f} ms, kernel at {kern_ms / bound_ms:.2f}x it; bound per slot "
        + ", ".join(f"{k} {nbytes[k] / PIPE_N:.2f} B" for k in
                    ("per_cycle", "block", "regs", "queues", "packets", "tables"))
        + f" ({pushes:.1f} handshakes a cycle)")
    del carry, ref_carry, local, start, sim, eng, net
    gc.collect()
    torch.cuda.empty_cache()
    result["pipestage"] = dict(
        block_type="PipeStage", cell=f"make_chain({PIPE_N}) K={PIPE_K}",
        launches=launches, max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None)


# ------------------------------------------- the queue interpreter (GraphEngine)
GRAPH_TRACE_EPOCHS = 8  # the traced window of graph-full's until-runs


def load_example(name: str):
    """A module of the checkout's ``examples/`` directory, by file name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_graph_small() -> None:
    import numpy as np
    import torch
    from repro_torch.core import ChannelGraph, device_loop
    from repro_torch.core.distributed import GraphEngine
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params
    from repro_torch.hw.pipestage import make_chain
    from repro_torch.core.struct import tree_paths
    from repro_torch.kernels import granule_step, systolic_step
    from repro_torch.kernels.fused_checks import compare

    # the card's in-place path against the functional one on a CPU copy
    for overlap in (False, True):
        eng, _ = wafer_engine(32, 32, 2, 4, 4, overlap, "cuda", GraphEngine)
        gpu = eng.init(0)
        cpu = to_cpu(gpu)
        for ep in range(10):
            gpu = eng.run_epochs(gpu, 1)
            cpu = eng.run_epochs(cpu, 1)
            torch.cuda.synchronize()
            compare(gpu, cpu)
        log(f"[graph-small] GraphEngine 32x32 tiers (2, 4) cap 4 overlap={overlap}: "
            f"10 epochs ({int(gpu.cycle.reshape(-1)[0])} cycles) on the card bit-exact "
            f"against a CPU copy ({eng.n_local} queue rows a granule)")

    # the device loop against the host loop; neither kernel launches
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    eng, _ = wafer_engine(32, 32, 2, 4, 4, False, "cuda", GraphEngine)
    for budget in (0, 1, 3, 1000):
        n0 = (granule_step.launches, systolic_step.launches)
        c0 = until_counts()
        host = eng.run_until_host(eng.init(0), done, budget)
        c1 = until_counts()
        dev = eng.run_until(eng.init(0), done, budget)
        torch.cuda.synchronize()
        compare(dev, host)
        epochs = int(dev.epoch.reshape(-1)[0])
        host_epochs, dev_epochs = c1["epochs"] - c0["epochs"], counts_since(c1)["epochs"]
        if not host_epochs == dev_epochs == epochs:
            raise AssertionError(f"[graph-small] the loops counted {host_epochs} and "
                                 f"{dev_epochs} epochs for {epochs}")
        if (granule_step.launches, systolic_step.launches) != n0:
            raise AssertionError("[graph-small] the queue interpreter launched a kernel")
        log(f"[graph-small] run_until at budget {budget}: the device loop (span "
            f"{device_loop.SPAN}) stops at the host loop's epoch {epochs} (cycle "
            f"{int(dev.cycle.reshape(-1)[0])}) with its state bit for bit; "
            f"granule_step and systolic_step launched 0 times")

    # against the fused engine (the granule_step kernel) at capacity 2, K = (1, 1)
    vals = ((np.arange(32 * 32) % 8) + 1).astype(np.float32).reshape(32, 32)

    def torus():
        return ChannelGraph.torus(ManycoreCell(32, 32), 32, 32,
                                  params=make_core_params(vals), capacity=2)

    part = np.arange(32 * 32) % 8
    kw = dict(tiers=[(("g",), 1)], batch_axes={"g": 8}, device="cuda")
    geng, feng = GraphEngine(torus(), part, None, **kw), FusedEngine(torus(), part, None, **kw)
    gs, fs = geng.init(0), feng.init(0)
    for ep in range(1000):
        gs, fs = geng.run_epochs(gs, 1), feng.run_epochs(fs, 1)
        theirs = dict(tree_paths(feng._local_view(fs).block_states[0]))
        for name, x in tree_paths(geng._local_view(gs).block_states[0]):
            # float leaves compared as bits (the bytes of each element)
            x, y = x.reshape(-1).view(torch.uint8), theirs[name].reshape(-1).view(torch.uint8)
            if not torch.equal(x, y):
                raise AssertionError(f"[graph-small] block state {name} differs from "
                                     f"the fused engine's after epoch {ep + 1}")
        if bool(done(geng._local_view(gs))):
            break
    if not (geng.gather_group(gs, 0).total == vals.sum()).all():
        raise AssertionError("[graph-small] the capacity-2 allreduce did not converge")
    log(f"[graph-small] GraphEngine against FusedEngine (granule_step) at capacity 2, "
        f"K = (1, 1), 32x32 on 8 granules: every block state equal after each of "
        f"{ep + 1} epochs, to the allreduce's end")

    # the heterogeneous SoC: three block types without a device step
    soc = load_example("torch_heterogeneous_soc")
    single = soc.run_single(120, device="cuda")
    dist, seng = soc.run_distributed(K=1, cycles=120, device="cuda")
    for name in ("pc", "acc", "results", "n_done", "waiting"):
        if not torch.equal(getattr(single, name), getattr(dist, name)):
            raise AssertionError(f"[graph-small] SoC {name}: GraphEngine K=1 != NetworkSim")
    k8, _ = soc.run_distributed(K=8, cycles=160, device="cuda")
    if int(k8.n_done) != soc.N_REQ:
        raise AssertionError("[graph-small] SoC at K=8 did not complete")
    log(f"[graph-small] heterogeneous SoC (Cpu, DramModel, AnalogRamp) on 3 batched "
        f"granules, K = 1: GraphEngine bit-identical to NetworkSim on the card "
        f"(results {dist.results.cpu().numpy().round(3).tolist()}); K = 8 completes "
        f"{int(k8.n_done)}/{soc.N_REQ}")

    # a PipeStage chain through the session's host ports
    sim = make_chain(6, capacity=4).build(engine="graph", partition=[0, 0, 1, 1, 2, 2],
                                          K=2, batch_axes={"g": 3}, device="cuda")
    sim.reset(0)
    pays = np.stack([np.arange(20, dtype=np.float32), np.arange(20)], 1)
    sim.tx("tx").send_many(pays)
    got = []
    for _ in range(40):
        sim.run(cycles=4)
        got.extend(sim.rx("rx").drain().tolist())
    want = (pays + np.array([6.0, 0.0], np.float32)).tolist()
    if got != want:
        raise AssertionError(f"[graph-small] the chain returned {got[:4]}..., not {want[:4]}...")
    log(f"[graph-small] PipeStage chain of 6 on 3 granules, K = 2: {len(got)} packets "
        f"sent through sim.tx and drained through sim.rx in order, each +6 on word 0")


def graph_cycle_bytes(local, pushes: float, n_cycles: int, n_exchanges: dict) -> dict:
    """The least bytes one simulated cycle of the queue interpreter must
    move on the wafer, each input read once and each output written once,
    counted from this run's tensors and data:

      * block state: the leaves of ``STEP_READS`` read, of ``STEP_WRITES``
        written (as ``cycle_bytes``);
      * every queue row: head and tail read (its fullness and emptiness)
        and written, and the front's word 0 read;
      * the payload of each packet pushed (``pushes`` per cycle, counted
        over the run);
      * the port tables ``rx_idx`` and ``tx_idx``, read;
      * per exchange (``n_exchanges``: tier -> exchanges an epoch),
        amortized over the epoch's ``n_cycles``: the tier's tables read and
        its credits read and written.

    The queue rows' other slots and words are storage the interpreter's
    ring semantics keep, not traffic a cycle needs."""
    def nb(x):
        return x.numel() * x.element_size()

    st = local.block_states[0]
    block = (sum(nb(getattr(st, f)) for f in STEP_READS)
             + sum(nb(getattr(st, f)) for f in STEP_WRITES))
    q = local.queues
    word = q.buf.element_size()
    rows = q.head.numel()
    queues = rows * (2 * (q.head.element_size() + q.tail.element_size()) + word)
    packets = pushes * q.buf.shape[-1] * word
    tb = local.tables
    tables = sum(nb(x) for x in tb.rx_idx) + sum(nb(x) for x in tb.tx_idx)
    xchg = sum(n * (sum(nb(x[t]) for x in (tb.send_idx, tb.send_mask, tb.recv_idx,
                                            tb.recv_mask, tb.bat_fwd, tb.bat_rev))
                    + 2 * nb(local.credits[t]))
               for t, n in n_exchanges.items())
    per_cycle = block + queues + packets + tables + xchg / n_cycles
    return {"block": block, "queues": queues, "packets": packets, "tables": tables,
            "per_cycle": per_cycle}


def phase_graph_full() -> None:
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import Simulation, device_loop
    from repro_torch.core.distributed import GraphEngine, GridEngine
    from repro_torch.core.fastgrid import RegisterGridEngine
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.hw.systolic import SystolicCell, make_cell_params
    from repro_torch.kernels import granule_step, systolic_step
    from repro_torch.kernels.fused_checks import clone, compare

    R, C = CONFIG.grid_rows, CONFIG.grid_cols
    t0 = time.perf_counter()
    eng, values = wafer_engine(R, C, CONFIG.k_outer, CONFIG.k_inner,
                               CONFIG.queue_capacity, False, "cuda", GraphEngine)
    sim = Simulation(eng).reset(0)
    sim.block_until_ready()
    setup_s = time.perf_counter() - t0
    q = sim.state.queues
    log(f"[graph-full] GraphEngine {R}x{C} torus = {R * C} cores, {eng.G} granules "
        f"batched, tiers K={eng.K_tiers}, capacity {eng.capacity}: {eng.n_local} queue "
        f"rows a granule, buffer {q.buf.numel() * q.buf.element_size() / 2**30:.3f} "
        f"GiB; set-up {setup_s:.2f} s")

    # one epoch: the card (in place) against a CPU copy (functional)
    start = clone(sim.state)
    t1 = time.perf_counter()
    plain = eng.run_epochs(to_cpu(start), 1)
    plain_cpu_s = time.perf_counter() - t1
    kern = eng.run_epochs(clone(start), 1)
    torch.cuda.synchronize()
    err = compare(kern, plain)
    log(f"[graph-full] one epoch on the card bit-exact against a CPU copy (max |diff| "
        f"{err}; the CPU copy took {plain_cpu_s:.2f} s)")
    del plain, kern
    gc.collect()

    # the main path: Simulation.run(until=allreduce_done) in the device loop
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = (granule_step.launches, systolic_step.launches)
    fires0 = int(sim.state.block_states[0].fires.sum(dtype=torch.int64))
    c0 = until_counts()
    t2 = time.perf_counter()
    sim.run(until=done, max_epochs=1000)
    sim.block_until_ready()
    run_s = time.perf_counter() - t2
    first = dict(counts_since(c0), wall=run_s)
    peak = torch.cuda.max_memory_allocated()
    totals = eng.gather_group(sim.state, 0).total
    if not np.array_equal(totals, np.full_like(totals, TOTAL)):
        raise AssertionError(f"[graph-full] totals {np.unique(totals)[:5]} != {TOTAL}")
    if (granule_step.launches, systolic_step.launches) != n0:
        raise AssertionError("[graph-full] the queue interpreter launched a kernel")
    cycles, epochs = sim.cycle, sim.epoch
    local = eng._local_view(sim.state)
    # fires count sends and accepts; every packet sent is accepted by the run's end
    pushes = (int(local.block_states[0].fires.sum(dtype=torch.int64)) - fires0) / 2 / cycles
    # tier t exchanges once a round of tier t - 1: prod(K_0 .. K_{t-1}) an epoch
    n_x = {t: int(np.prod(eng.K_tiers[:t])) for t in range(len(eng.tiers))
           if eng.tier_classes[t]}
    nbytes = graph_cycle_bytes(local, pushes, eng.cycles_per_epoch, n_x)
    bound_ms = nbytes["per_cycle"] / HBM_BYTES_PER_S * 1e3
    run_only = run_s - first["capture_s"]
    log(f"[graph-full] converged: every one of {R * C} cores holds total {TOTAL:.0f} "
        f"after {cycles} cycles ({epochs} epochs) in the device loop; run "
        f"{run_only:.3f} s (wall {run_s:.3f} s less the capture's "
        f"{first['capture_s']:.3f} s, set-up), {run_only / cycles * 1e3:.4f} ms a "
        f"cycle, {R * C * cycles / run_only:.4e} core-cycles/s; {int(first['syncs'])} "
        f"host syncs (spans of {device_loop.SPAN} epochs); granule_step and "
        f"systolic_step launched 0 times; device memory peak "
        f"{peak / 2**30:.2f} GiB")
    log(f"[graph-full] bound a cycle (bytes, from this run's tensors): "
        f"{nbytes['per_cycle'] / (R * C):.2f} B a core (block "
        f"{nbytes['block'] / (R * C):.2f}, queue rows {nbytes['queues'] / (R * C):.2f}, "
        f"packets {nbytes['packets'] / (R * C):.2f} at {pushes / (R * C):.4f} a core "
        f"and cycle, tables {nbytes['tables'] / (R * C):.2f}), {bound_ms:.5f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the run at "
        f"{run_only / cycles * 1e3 / bound_ms:.1f}x it")

    # the host loop on the same card, a warm replay, and a traced window of both
    out = compare_loops("graph-full", eng, sim, start, done, 1000, first, clone,
                        compare, R * C, (), trace_epochs=GRAPH_TRACE_EPOCHS)
    trace = out["dev_trace"]
    if trace["busy"] is not None:
        log(f"[graph-full] traced window: {trace['busy'] / out['traced_cycles'] * 1e3:.4f} "
            f"ms of device time a cycle, {trace['events'] / out['traced_cycles']:.1f} "
            f"device events a cycle (the nodes the captured graph runs: kernels, "
            f"copies and fills)")
    sim._state = None
    del start, local, q, sim, eng
    gc.collect()
    torch.cuda.empty_cache()

    # GridEngine on the 1024^2 systolic matmul: Y bit-identical to the
    # register engine's
    M, SR, SC, K = SYS_M, SYS_R, SYS_C, SYS_K
    A, B = sys_operands(M, SR, SC, SYS_SEED)
    reg = RegisterGridEngine.from_graph(sys_graph(A, B), K=K)
    rsim = Simulation(reg).reset()
    rsim.run(until=reg.y_done)
    Y_reg, reg_cycles = reg.result(rsim.state), rsim.cycle
    del reg, rsim
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    geng = GridEngine(SystolicCell(M), SR, SC, K=K)
    gsim = Simulation(geng).reset(0, cell_params=make_cell_params(A, B))
    gsim.block_until_ready()
    gsetup_s = time.perf_counter() - t3
    torch.cuda.reset_peak_memory_stats()
    pred = lambda c: ((~c.is_south) | (c.y_idx >= M)).all()  # noqa: E731
    c0 = until_counts()
    t4 = time.perf_counter()
    gsim.run(until=pred, max_epochs=1000)
    gsim.block_until_ready()
    grun_s = time.perf_counter() - t4
    gfirst = counts_since(c0)
    cells = geng._local_view(gsim.state).block_states[0]
    south = torch.as_tensor(geng._member_slot[0][(SR - 1) * SC + np.arange(SC)],
                            device="cuda")
    Y = cells.y_buf[south].T.cpu().numpy()
    if not np.array_equal(Y.view(np.uint32), Y_reg.view(np.uint32)):
        raise AssertionError("[graph-full] GridEngine's Y differs from the register engine's")
    grun_only = grun_s - gfirst["capture_s"]
    log(f"[graph-full] GridEngine {SR}x{SC} SystolicCells, M={M}, K={K}: Y "
        f"bit-identical to RegisterGridEngine's after {gsim.cycle} cycles ({gsim.epoch} "
        f"epochs; the register engine {reg_cycles}); set-up {gsetup_s:.2f} s, run "
        f"{grun_only:.3f} s (capture {gfirst['capture_s']:.3f} s apart), "
        f"{grun_only / gsim.cycle * 1e3:.4f} ms a cycle, "
        f"{SR * SC * gsim.cycle / grun_only:.4e} core-cycles/s, "
        f"{int(gfirst['syncs'])} host syncs; device memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gsim._state = None
    del gsim, geng, cells
    gc.collect()
    torch.cuda.empty_cache()

# ------------------------------------------------------------ LM serving
LM_BATCH, LM_PROMPT, LM_GEN = 4, 3072, 16
FLASH_ROW = dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:137")
#: the kernel table's fixed keys of the three LM kernels' rows
KERNEL_ROWS = {
    "flash_attention": FLASH_ROW,
    "rglru_scan": dict(name="rglru_scan", route="cuda",
                       source="src/repro_torch/kernels/csrc/rglru_scan.cu",
                       replaces="src/repro/kernels/rglru_scan.py:78"),
    "slstm_scan": dict(name="slstm_scan", route="cuda",
                       source="src/repro_torch/kernels/csrc/slstm_scan.cu",
                       replaces="src/repro/kernels/slstm_scan.py:121"),
}


def phase_lm_small() -> None:
    from repro_torch.kernels import lm_checks as lc

    from repro_torch.kernels import flash_attention as fa

    for case in lc.FLASH_CASES:
        before = dict(fa.route_launches)
        err = lc.check_flash(case)
        route = fa.route(case[8], case[5])
        if fa.route_launches[route] != before[route] + 1:
            raise AssertionError(f"[lm-small] {case} did not take the {route} route")
        log(f"[lm-small] flash_attention (B, Hq, Hkv, T, S, D, causal, window, "
            f"dtype) = {case}, {route} route: kernel == plain version (max |diff| "
            f"{err:.3e})")
    for case in lc.RGLRU_CASES:
        err = lc.check_rglru(case)
        log(f"[lm-small] rglru_scan (B, T, D, h0) = {case}: kernel == plain "
            f"version (max |diff| {err:.3e})")
    for case in lc.SLSTM_CASES:
        err = lc.check_slstm(case)
        log(f"[lm-small] slstm_scan (B, T, d, H, R dtype, carry) = {case}: "
            f"kernel == plain version (max |diff| {err:.3e})")


def phase_lm_dense() -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lm_checks as lc
    from repro_torch.launch.serve import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    r = serve(verbose=False)  # the defaults: llama3.2-1b, smoke size, the card
    if not r["finite"] or r["tokens"].shape != (4, 16):
        raise AssertionError(f"[lm-dense] serve(): tokens {r['tokens'].shape}, "
                             f"finite {r['finite']}")
    log(f"[lm-dense] serve() with no arguments: llama3.2-1b at the smoke size on "
        f"the card, every logit finite, first tokens {r['tokens'][:, :6].tolist()}")
    captured: dict = {}
    _, routes = serve_full("llama3.2-1b", "lm-dense", {"flash_attention": fa},
                           {"flash_attention": 16}, captured)
    if routes["flash_attention"] != {"tensor_cores": 16, "cuda_cores": 0}:
        raise AssertionError(f"[lm-dense] flash routes {routes['flash_attention']}: "
                             "all 16 served launches must take the tensor cores")
    (q, k, v), kw = captured.pop(("flash_attention_cuda", None))
    mkw = dict(causal=kw["causal"], window=kw["window"], sm_scale=kw["sm_scale"])
    err = lc.compare_flash(q.contiguous(), k.contiguous(), v.contiguous(), **mkw)
    log(f"[lm-dense] flash_attention at the first layer's q {tuple(q.shape)}, k/v "
        f"{tuple(k.shape)} {q.dtype} (D = {q.shape[-1]}, {fa.route(q.dtype, q.shape[-1])} "
        f"route), {mkw}: kernel == plain version within one bf16 ulp (max |diff| "
        f"{err:.3e})")


def attention_pairs(T: int, S: int, causal: bool, window) -> int:
    """(q, k) pairs the mask admits for one (batch, head)."""
    import numpy as np

    q = np.arange(T, dtype=np.int64)
    hi = np.minimum(q if causal else S - 1, S - 1)
    lo = np.zeros_like(q) if window is None else np.maximum(q - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, ops_per_s: float) -> tuple:
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_first_calls(mod, name: str, store: dict, kind=None):
    """Wrap ``mod.name`` so that the arguments of its first call of each
    kind land in ``store[name, kind(*args)]`` (one kind, None, where
    ``kind`` is None); returns a function that restores it."""
    orig = getattr(mod, name)

    def wrapped(*args, **kw):
        store.setdefault((name, kind and kind(*args)), (args, kw))
        return orig(*args, **kw)

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, orig)


def serve_full(arch: str, tag: str, modules: dict, expect: dict, captured: dict,
               kinds: dict | None = None):
    """``serve`` at full width with the kernels' launch counts set to 0 just
    before and read just after; raises unless each equals ``expect`` and
    every logit is finite.  The first call of each kernel's wrapper (of
    each kind, by ``kinds[name]``) lands in ``captured``."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config(arch)
    kinds = kinds or {}
    restore = [capture_first_calls(mod, f"{name}_cuda", captured, kinds.get(name))
               for name, mod in modules.items()]
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for mod in modules.values():
            mod.launches = 0
            for route in getattr(mod, "route_launches", {}):
                mod.route_launches[route] = 0
        r = serve(arch, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
                  gen=LM_GEN, seed=0, verbose=False, device="cuda")
        launches = {name: mod.launches for name, mod in modules.items()}
        routes = {name: dict(mod.route_launches) for name, mod in modules.items()
                  if hasattr(mod, "route_launches")}
    finally:
        for undo in restore:
            undo()
    peak = torch.cuda.max_memory_allocated()
    if launches != expect:
        raise AssertionError(f"[{tag}] launches {launches}, expected {expect}")
    tok = r["tokens"]
    if not r["finite"]:
        raise AssertionError(f"[{tag}] a logit of the run was not finite")
    if tok.shape != (LM_BATCH, LM_GEN) or tok.min() < 0 or tok.max() >= cfg.vocab:
        raise AssertionError(f"[{tag}] tokens {tok.shape} out of range")
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}, {cfg.dtype}; batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_GEN} greedy tokens; set-up {r['setup_s']:.3f} s; prefill "
        f"{r['prefill_s']:.4f} s ({LM_BATCH * LM_PROMPT / r['prefill_s']:.1f} "
        f"tok/s); decode {r['tok_per_s']:.2f} tok/s; every logit finite; "
        f"launches {launches}, by route {routes}; peak device memory "
        f"{peak / 2**20:.1f} MiB; "
        f"first tokens {tok[:, :6].tolist()}")
    return launches, routes


def serve_batch(arch: str, tag: str, mod, batch: int) -> None:
    """``serve`` through the entry point at ``batch`` rows and a short
    prompt, outside the main path: every logit finite, tokens in range,
    and the kernel of ``mod`` launched."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config(arch)
    before = mod.launches
    r = serve(arch, smoke=False, batch=batch, prompt_len=512, gen=4, seed=0,
              verbose=False, device="cuda")
    tok = r["tokens"]
    if not r["finite"] or tok.shape != (batch, 4) or tok.min() < 0 or tok.max() >= cfg.vocab:
        raise AssertionError(f"[{tag}] batch {batch}: tokens {tuple(tok.shape)}, "
                             f"finite {r['finite']}")
    log(f"[{tag}] {cfg.name} at batch {batch}, prompt 512, 4 tokens: every logit "
        f"finite; {mod.launches - before} kernel launches; prefill "
        f"{r['prefill_s']:.4f} s")


LM_TRACE_NAMES = ("fa_fwd", "rglru_fwd", "rglru_clear", "slstm_fwd", "gemm", "nvjet")


def trace_serving(arch: str, tag: str) -> None:
    """``trace_model`` of ``arch`` at full width from fresh weights and
    ``serve``'s prompts.  The launch counts these calls add are not the
    main path's."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    with torch.inference_mode():
        params = M.init_params(cfg, 0, device="cuda")
        trace_model(tag, cfg, params, model_inputs(cfg, LM_BATCH, LM_PROMPT, "cuda"))


def rglru_bytes(x, h0) -> int:
    """x and a (x's shape and dtype) and h0 read once, h and h_last
    written once."""
    return nbytes(x, x, x) + x.shape[0] * x.shape[2] * x.element_size() + (
        nbytes(h0) if h0 is not None else 0)


def rglru_bound(x, h0) -> tuple:
    return bound(rglru_bytes(x, h0), 2 * x.numel(), F32_OPS_PER_S)


def time_kernel(tag: str, name: str, kernel, plain, reps: int, plain_reps: int,
                library=None, hold: bool = False):
    """Median ms of each, by CUDA events, after a warm-up call of each
    (``hold``: the kernel's calls with ``time_reps``'s hold)."""
    import statistics

    out = {}
    for key, fn, n in (("ms", kernel, reps), ("plain_ms", plain, plain_reps),
                       ("library_ms", library, reps)):
        if fn is None:
            out[key] = None
            continue
        fn()
        times = time_reps(fn, n, hold and key == "ms")
        out[key] = statistics.median(times)
        log(f"[{tag}] {name} {key}: median {out[key]:.4f} ms over {n} calls "
            f"({min(times):.4f}-{max(times):.4f})")
    return out


def flash_at_inputs(tag: str, q, k, v, kw: dict) -> dict:
    """A served flash call's q, k, v (as its wrapper got them) and keyword
    arguments: the kernel against its plain version, then the times of the
    kernel, the plain version and ``scaled_dot_product_attention`` with the
    same mask, beside the bound counted from the inputs.  Returns the
    kernel table's numbers (``max_abs_err``, ``ms``, ``plain_ms``,
    ``library_ms``, ``bound_ms``, ``bound_by``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lm_checks as lc
    from repro_torch.kernels.ref import attention_mask

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    causal, window, scale = kw["causal"], kw["window"], kw["sm_scale"]
    mkw = dict(causal=causal, window=window, sm_scale=scale)
    B, Hq, T, D = q.shape
    err = lc.compare_flash(q, k, v, **mkw)
    log(f"[{tag}] flash_attention at q {tuple(q.shape)}, k/v {tuple(k.shape)} "
        f"{q.dtype}, causal {causal}, window {window}, scale {scale}: kernel == "
        f"plain version within one bf16 ulp (max |diff| {err:.3e})")
    # the same mask: a window's as a boolean mask, a causal one as is_causal
    mask = (attention_mask(T, k.shape[2], causal, window, q.device)
            if window is not None else None)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
        enable_gqa=True)
    lib_err = (lib().float() - fa.flash_attention_ref(
        q, k, v, **mkw).float()).abs().max().item()
    times = time_kernel(
        tag, "flash_attention",
        lambda: fa.flash_attention_cuda(q, k, v, **mkw),
        lambda: fa.flash_attention_ref(q, k, v, **mkw),
        10, 3, lib)
    pairs = attention_pairs(T, k.shape[2], causal, window) * B * Hq
    n_bytes = nbytes(q, k, v, q)  # q, k, v read; o (q's shape and dtype) written
    bound_ms, by = bound(n_bytes, 4 * D * pairs, BF16_OPS_PER_S)
    log(f"[{tag}] flash_attention bound: {pairs} (q, k) pairs, "
        f"{4 * D * pairs:.4e} flop, {n_bytes} B -> {bound_ms:.4f} ms ({by}); "
        f"kernel ({fa.route(q.dtype, D)} route, {fa.smem_bytes(q.dtype, D)} B of "
        f"shared memory a CTA) at {times['ms'] / bound_ms:.2f}x it and "
        f"{times['ms'] / times['library_ms']:.3f}x scaled_dot_product_attention "
        f"(same mask), which differs from the plain version by at most {lib_err:.3e}")
    return dict(max_abs_err=err, **times, bound_ms=bound_ms, bound_by=by)


def phase_rg_full(results: list) -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lm_checks as lc
    from repro_torch.kernels import rglru_scan as rg

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 unembedding stays f32
    captured: dict = {}
    launches, routes = serve_full("recurrentgemma-2b", "rg-full",
                                  {"flash_attention": fa, "rglru_scan": rg},
                                  {"flash_attention": 8, "rglru_scan": 18}, captured)
    if routes["flash_attention"] != {"tensor_cores": 8, "cuda_cores": 0}:
        raise AssertionError(f"[rg-full] flash routes {routes['flash_attention']}: "
                             "all 8 served launches must take the tensor cores")

    # attention: the first local-attention layer's q, k, v from that run
    (q, k, v), kw = captured.pop(("flash_attention_cuda", None))
    row = flash_at_inputs("rg-full", q, k, v, kw)
    results.append(dict(FLASH_ROW, launches=launches["flash_attention"], **row))
    del q, k, v

    # RG-LRU: the first recurrent layer's x and a from that run
    (x, a, h0), _ = captured.pop(("rglru_scan_cuda", None))
    plan = rg.scan_plan(*x.shape)
    err = lc.compare_rglru(x, a, h0)
    log(f"[rg-full] rglru_scan at x {tuple(x.shape)} {x.dtype}, h0 "
        f"{'given' if h0 is not None else 'zeros'}: kernel == plain version "
        f"(max |diff| {err:.3e}, max |h| {rg.rglru_scan_ref(x, a, h0)[0].abs().max().item():.3f}); "
        f"plan {plan.ctas} CTAs of {plan.threads} threads ({plan.tiles} tiles of 32 "
        f"channels x {plan.chunks} chunks of {plan.chunk} steps), "
        f"{plan.status_pairs * 8} B of status")
    first = rg.rglru_scan_cuda(x, a, h0)
    for _ in range(10):
        again = rg.rglru_scan_cuda(x, a, h0)
        if not (torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])):
            raise AssertionError("[rg-full] rglru_scan: two calls on the same inputs "
                                 "differ")
    log("[rg-full] rglru_scan: 11 calls on the served inputs give the same bits")
    del first, again
    bound_ms, by = rglru_bound(x, h0)
    # the chunk sweep at the served inputs, each chunk held against the plain version
    for tc in sorted(RGLRU_SWEEP_VARIANTS + (plan.chunk,)):
        kern = rg.rglru_scan_cuda if tc == plan.chunk else rg.chunk_variant(tc)
        err_tc = lc.compare_rglru(x, a, h0, kern)
        t_tc = time_kernel("rg-full", f"rglru_scan (chunk {tc})",
                           lambda kern=kern: kern(x, a, h0), None, 10, 0, hold=True)
        log(f"[rg-full] rglru_scan chunk sweep: chunk {tc} "
            f"({rg.scan_plan(*x.shape, tc).ctas} CTAs), kernel == plain "
            f"version (max |diff| {err_tc:.3e}), {t_tc['ms']:.4f} ms, "
            f"{t_tc['ms'] / bound_ms:.2f}x the bound")
    # batch 1: a quarter of the bytes, a quarter of the CTAs
    x1, a1 = x[:1].contiguous(), a[:1].contiguous()
    h01 = None if h0 is None else h0[:1].contiguous()
    err1 = lc.compare_rglru(x1, a1, h01)
    t1 = time_kernel("rg-full", "rglru_scan (batch 1)",
                     lambda: rg.rglru_scan_cuda(x1, a1, h01), None, 10, 0, hold=True)
    bound1, by1 = rglru_bound(x1, h01)
    log(f"[rg-full] rglru_scan at batch 1, x {tuple(x1.shape)}: kernel == plain "
        f"version (max |diff| {err1:.3e}); {t1['ms']:.4f} ms against its bound "
        f"{bound1:.4f} ms ({by1}), {t1['ms'] / bound1:.2f}x")
    del x1, a1, h01
    # the served shape without the hold too, as earlier kernels were timed
    time_kernel("rg-full", "rglru_scan (no hold)", lambda: rg.rglru_scan_cuda(x, a, h0),
                None, 10, 0)
    times = time_kernel("rg-full", "rglru_scan", lambda: rg.rglru_scan_cuda(x, a, h0),
                        lambda: rg.rglru_scan_ref(x, a, h0), 10, 3, hold=True)
    log(f"[rg-full] rglru_scan bound: {rglru_bytes(x, h0)} B, {2 * x.numel()} flop -> "
        f"{bound_ms:.4f} ms ({by}); kernel (chunk {plan.chunk}) at "
        f"{times['ms'] / bound_ms:.2f}x it, {bound_ms / times['ms']:.3f} of it")
    results.append(dict(
        KERNEL_ROWS["rglru_scan"], launches=launches["rglru_scan"], max_abs_err=err,
        **times, bound_ms=bound_ms, bound_by=by))
    del x, a, h0
    trace_serving("recurrentgemma-2b", "rg-full")


def phase_xl_full(results: list) -> None:
    import torch
    from repro_torch.kernels import lm_checks as lc
    from repro_torch.kernels import slstm_scan as sl

    torch.backends.cuda.matmul.allow_tf32 = False
    captured: dict = {}
    # 6 sLSTM layers: one launch each in the prefill and in each of the
    # gen - 1 decode steps (T = 1 takes the kernel too)
    launches, _ = serve_full(
        "xlstm-125m", "xl-full", {"slstm_scan": sl}, {"slstm_scan": 6 * LM_GEN},
        captured, {"slstm_scan": lambda r, pre, carry0: pre.shape[1] == 1})
    # the first decode step's inputs: T = 1 from the carry the prefill left
    (r, pre, carry0), _ = captured.pop(("slstm_scan_cuda", True))
    if pre.shape[1] != 1 or not all(torch.isfinite(x).all() for x in carry0):
        raise AssertionError(f"[xl-full] the decode call's pre {tuple(pre.shape)} "
                             "or its carry is not a decode step's")
    err_dec = lc.compare_slstm(r, pre, carry0)
    log(f"[xl-full] slstm_scan at the first decode step's pre {tuple(pre.shape)} "
        f"and the carry the prefill left (every m finite, max |m| "
        f"{carry0[3].abs().max().item():.3f}): kernel == plain version (max |diff| "
        f"{err_dec:.3e})")
    dec = time_kernel("xl-full", "slstm_scan (decode, T = 1)",
                      lambda: sl.slstm_scan_cuda(r, pre, carry0),
                      lambda: sl.slstm_scan_ref(r, pre, carry0), 20, 5)
    n_calls = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        sl.slstm_scan_cuda(r, pre, carry0)
    host_us = (time.perf_counter() - t0) / n_calls * 1e6
    torch.cuda.synchronize()
    log(f"[xl-full] slstm_scan decode call: {dec['ms']:.4f} ms by CUDA events "
        f"(the single-CTA design before the cluster one: 0.2020 ms on an H100 "
        f"80GB HBM3 at 700 W); the wrapper's host work "
        f"{host_us:.1f} us a call ({n_calls} calls enqueued back to back)")
    # the first prefill call's inputs, from a zero carry with m = -inf
    (r, pre, carry0), _ = captured.pop(("slstm_scan_cuda", False))
    B, T, _, d = pre.shape
    H, hd = r["i"].shape[:2]
    err = lc.compare_slstm(r, pre, carry0)
    plan = sl.cluster_plan(B, hd, r["i"].dtype)
    log(f"[xl-full] slstm_scan at pre {tuple(pre.shape)}, R {H}x({hd}, {hd}) "
        f"{r['i'].dtype}: kernel == plain version (max |diff| {err:.3e}); "
        f"{H} clusters of {plan.C} CTAs, {plan.E} channels and {plan.threads} "
        f"threads a CTA, k-sum split {plan.KS} ways, {plan.smem} B of shared "
        f"memory a CTA")
    times = time_kernel("xl-full", "slstm_scan",
                        lambda: sl.slstm_scan_cuda(r, pre, carry0),
                        lambda: sl.slstm_scan_ref(r, pre, carry0), 5, 2)
    # R, pre and the carry read; four sequences and the final carry written
    n_bytes = (nbytes(*r.values(), pre, *carry0) + 4 * B * T * d * 4
               + nbytes(*carry0))
    flop = 4 * 2 * hd * d * B * T  # h @ R_g for the four gates, in f32
    bound_ms, by = bound(n_bytes, flop, F32_OPS_PER_S)
    log(f"[xl-full] slstm_scan bound: {n_bytes} B, {flop:.4e} flop (f32) -> "
        f"{bound_ms:.4f} ms ({by}); kernel at {times['ms'] / bound_ms:.1f}x it; "
        f"the {T} steps form a dependent chain, {times['ms'] / T * 1e3:.3f} us a step")
    half = pre[:, :T // 2].contiguous()
    t_half = time_kernel("xl-full", f"slstm_scan (T = {T // 2})",
                         lambda: sl.slstm_scan_cuda(r, half, carry0), None, 5, 0)
    step_us = (times["ms"] - t_half["ms"]) / (T - T // 2) * 1e3
    log(f"[xl-full] slstm_scan marginal step: {step_us:.3f} us ((T = {T} minus "
        f"T = {T // 2}) / {T - T // 2}); the chain floor at this step time: "
        f"{step_us * T / 1e3:.3f} ms")
    # the cluster sizes cluster_plan passes over, on the same inputs
    want = sl.slstm_scan_ref(r, pre, carry0)
    for c in sorted(set(sl.CLUSTER_SIZES) - {plan.C}):
        try:
            p_c = sl.cluster_plan(B, hd, r["i"].dtype, sizes=(c,))
        except ValueError as e:
            log(f"[xl-full] slstm_scan with a cluster of {c}: no plan ({e})")
            continue
        run_c = lambda p_c=p_c: sl.slstm_scan_cuda(r, pre, carry0, plan=p_c)  # noqa: E731
        err_c = lc.assert_close(run_c()[0], want[0], f"slstm_scan hs (C = {c})",
                                rtol=1e-4, atol_rel=1e-4)
        t_c = time_kernel("xl-full", f"slstm_scan (C = {c})", run_c, None, 5, 0)
        log(f"[xl-full] slstm_scan with a cluster of {c} ({p_c.threads} threads, "
            f"{p_c.smem} B a CTA): hs == plain version (max |diff| {err_c:.3e}); "
            f"{t_c['ms'] / T * 1e3:.3f} us a step")
    del want
    # more batch rows than one cluster's buffers hold: groups of rows, each
    # row's prompt a different shift of the served one
    big = torch.cat([pre.roll(97 * j, dims=1) for j in range(8)])
    carry_big = tuple(x.repeat(8, 1) for x in carry0)
    p_big = sl.cluster_plan(big.shape[0], hd, r["i"].dtype)
    err_big = lc.compare_slstm(r, big, carry_big)
    t_big = time_kernel("xl-full", f"slstm_scan (B = {big.shape[0]})",
                        lambda: sl.slstm_scan_cuda(r, big, carry_big), None, 5, 0)
    log(f"[xl-full] slstm_scan at pre {tuple(big.shape)}: {p_big.groups} groups of "
        f"{p_big.Bg} rows a head, clusters of {p_big.C}, {p_big.smem} B a CTA: "
        f"kernel == plain version (max |diff| {err_big:.3e}); "
        f"{t_big['ms'] / T * 1e3:.3f} us a step")
    del big, carry_big
    results.append(dict(
        KERNEL_ROWS["slstm_scan"], launches=launches["slstm_scan"],
        max_abs_err=max(err, err_dec), **times,
        bound_ms=bound_ms, bound_by=by))
    del r, pre, carry0
    serve_batch("xlstm-125m", "xl-full", sl, 32)
    trace_serving("xlstm-125m", "xl-full")


# ------------------------------------------------------------ MoE, VLM, audio
LM_FAM_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "qwen2-vl-72b",
                "hubert-xlarge")
LM_FAM_PROMPT, LM_FAM_BATCH, LM_FAM_GEN = 256, 2, 4
#: moe-full's and emb-full's models and the depth each keeps: every other
#: width is the published one.
FULL_DEPTHS = {"qwen3-moe-235b-a22b": 8, "llama4-maverick-400b-a17b": 2,
               "qwen2-vl-72b": 12, "hubert-xlarge": 48}
MOE_PIECES = ("dispatch", "scatter", "experts", "combine")


def model_inputs(cfg, batch: int, T: int, device):
    """Prompts as ``serve`` makes them (from a generator seeded 1), or for
    an embeddings-input config a seeded (batch, T, d) normal tensor in
    ``cfg.dtype``."""
    import torch

    gen = torch.Generator().manual_seed(1)
    if cfg.input_mode == "embeddings":
        x = torch.randn((batch, T, cfg.d_model), generator=gen)
        return x.to(device=device, dtype=getattr(torch, cfg.dtype))
    return torch.randint(2, cfg.vocab, (batch, T), generator=gen).to(device)


def greedy(params, cfg, inputs, gen: int, sync=lambda: None) -> dict:
    """``prefill`` and greedy ``decode_step``s to ``gen`` tokens (as
    ``serve`` runs them: the rate over the steps after the first), or for
    an encoder ``forward`` alone.  ``logits``: each call's; ``tokens``
    (B, gen) (the encoder: every position's argmax)."""
    import torch
    from repro_torch.models import model as M

    T = inputs.shape[1]
    out = {"decode_s": 0.0}
    t0 = time.perf_counter()
    if not cfg.causal:
        logits, out["aux"] = M.forward(params, cfg, inputs)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out.update(logits=[logits], tokens=logits.argmax(-1))
        return out
    states, logits = M.prefill(params, cfg, inputs, T + gen)
    sync()
    out["prefill_s"] = time.perf_counter() - t0
    out["logits"], toks = [logits], [logits.argmax(-1)]
    for t in range(gen - 1):
        if t == 1:
            sync()
            t1 = time.perf_counter()
        states, logits = M.decode_step(params, cfg, states, toks[-1], T + t)
        out["logits"].append(logits)
        toks.append(logits.argmax(-1))
    sync()
    if gen > 2:
        out["decode_s"] = time.perf_counter() - t1
    out.update(tokens=torch.stack(toks, 1), states=states)
    return out


def phase_lm_fam() -> None:
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.struct import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in LM_FAM_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True), use_kernels=True)
        params = M.init_params(cfg, 0, device="cpu")
        inputs = model_inputs(cfg, LM_FAM_BATCH, LM_FAM_PROMPT, "cpu")
        runs = {}
        for dev in ("cuda", "cpu"):
            routes: list = []
            router = moe._router

            def recorded(*a, _router=router, _routes=routes):
                out = _router(*a)
                _routes.append(out[0].cpu())
                return out

            moe._router = recorded
            before = fa.launches
            try:
                with torch.inference_mode():
                    r = greedy(tree_map(lambda t: t.to(dev), params), cfg, inputs.to(dev),
                               LM_FAM_GEN + 1)
            finally:
                moe._router = router
            r["launches"] = fa.launches - before
            r["routes"] = routes
            runs[dev] = r
        card, cpu = runs["cuda"], runs["cpu"]
        if card["launches"] < cfg.n_layers:
            raise AssertionError(f"[lm-fam] {arch}: {card['launches']} flash launches on "
                                 f"the card, expected at least {cfg.n_layers}")
        err = 0.0
        for i, (a, b) in enumerate(zip(card["logits"], cpu["logits"])):
            d = (a.cpu() - b).abs().max().item()
            if not d <= 1e-4:
                raise AssertionError(f"[lm-fam] {arch} call {i}: logits differ by {d:.3e}")
            err = max(err, d)
        if not torch.equal(card["tokens"].cpu(), cpu["tokens"]):
            raise AssertionError(f"[lm-fam] {arch}: greedy tokens differ")
        if len(card["routes"]) != len(cpu["routes"]) or not all(
                torch.equal(a, b) for a, b in zip(card["routes"], cpu["routes"])):
            raise AssertionError(f"[lm-fam] {arch}: MoE routing differs between card "
                                 "and CPU")
        what = ("prefill + 4 greedy decode steps" if cfg.causal else "forward")
        log(f"[lm-fam] {cfg.name} (f32, use_kernels, {tuple(inputs.shape)} "
            f"{'embeddings' if cfg.input_mode == 'embeddings' else 'tokens'}): {what} "
            f"on the card == on the CPU (logits max |diff| {err:.3e}, greedy tokens "
            f"identical); {len(card['routes'])} MoE router calls with identical "
            f"routing; {card['launches']} flash launches on the card")
    # M-RoPE with three different position streams
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 64, 4, 128), generator=gen)
    pos = torch.randint(0, 8192, (3, 2, 64), generator=gen)
    a = L.apply_mrope(x.cuda(), pos.cuda(), 1e6, (16, 24, 24)).cpu()
    b = L.apply_mrope(x, pos, 1e6, (16, 24, 24))
    d = (a - b).abs().max().item()
    # 1e-4 as the logits above: the devices' pow may round rope_freqs an ulp
    # apart, and the angle pos * freq carries that ulp times pos (to 8192)
    if not d <= 1e-4 or torch.equal(b, L.apply_rope(x, pos[0], 1e6)):
        raise AssertionError(f"[lm-fam] apply_mrope: card against CPU {d:.3e}")
    log(f"[lm-fam] apply_mrope, three different position streams, x (2, 64, 4, 128), "
        f"sections (16, 24, 24): card == CPU (max |diff| {d:.3e})")


def moe_drops(tag: str, cfg, call) -> None:
    """The first MoE layer's prefill input (``moe_fwd``'s first call):
    the share of its choices dropped by capacity, and its dispatch,
    scatter, expert GEMMs and combine timed by CUDA events."""
    import statistics

    import torch
    from repro_torch.models import moe

    (p, _, x, *_), _ = call
    mc = cfg.moe
    idx, gates, _, slot, keep, cap = moe.dispatch(p, mc, x)
    B, S, d = x.shape
    load = torch.stack([torch.bincount(r, minlength=mc.n_experts)
                        for r in idx.reshape(B, -1)])
    log(f"[{tag}] first MoE layer's prefill: {B} x {S} tokens, top-{mc.top_k} of "
        f"{mc.n_experts}, capacity {cap} a group: {int((~keep).sum())} of "
        f"{keep.numel()} choices dropped ({(~keep).float().mean().item():.4f}); "
        f"tokens with a dropped choice {(~keep).any(-1).float().mean().item():.4f}; "
        f"the busiest expert of a group took {int(load.max())} choices")
    n = mc.n_experts * cap
    buf = moe.scatter(x, slot, n + 1)
    e_in = buf[:, :n].reshape(B, mc.n_experts, cap, d)
    e_out = moe.experts(p, cfg, e_in)
    calls = {"dispatch": lambda: moe.dispatch(p, mc, x),
             "scatter": lambda: moe.scatter(x, slot, n + 1),
             "experts": lambda: moe.experts(p, cfg, e_in),
             "combine": lambda: moe.combine(e_out, slot, gates, keep)}
    times = {}
    for name, fn in calls.items():
        fn()
        times[name] = statistics.median(time_reps(fn, 5))
    flop = 3 * 2 * B * n * d * mc.d_ff_expert
    log(f"[{tag}] first MoE layer by CUDA events (medians of 5): "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in times.items())
        + f"; the expert GEMMs {flop:.4e} flop over {B * n} slots, "
        f"{flop / times['experts'] / 1e9:.1f} TFLOP/s")


def moe_split(run) -> dict | None:
    """``run()`` under ``torch.profiler`` (host and device), each piece of
    ``moe_fwd`` in a ``record_function`` range: device ms of each piece's
    kernels; None when the trace attributes no device time to them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe

    origs = {name: getattr(moe, name) for name in MOE_PIECES}

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with record_function(f"moe.{name}"):
                return fn(*a, **kw)
        return wrapped

    for name, fn in origs.items():
        setattr(moe, name, ranged(name, fn))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for name, fn in origs.items():
            setattr(moe, name, fn)
    ms = dict.fromkeys(MOE_PIECES, 0.0)
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("moe."):
            ms[ev.name[4:]] += ev.device_time_total * 1e-3
    return ms if any(ms.values()) else None


def trace_model(tag: str, cfg, params, inputs) -> None:
    """A warm prefill (an encoder's ``forward``) and one decode step, each
    under ``torch.profiler``: wall, device busy and idle share, and the
    device time of each kernel of ``LM_TRACE_NAMES`` (``gemm`` and
    ``nvjet``: cuBLAS's matrix products); for a MoE model also the device
    time of each piece of the MoE FFN (a second trace, host activity on).
    The launch counts these calls add are not the main path's."""
    from repro_torch.models import model as M

    out = {}

    def first():
        if cfg.causal:
            out["prefill"] = M.prefill(params, cfg, inputs, inputs.shape[1] + LM_GEN)
        else:
            M.forward(params, cfg, inputs)

    def decode():
        states, logits = out["prefill"]
        M.decode_step(params, cfg, states, logits.argmax(-1), inputs.shape[1])

    steps = [("prefill" if cfg.causal else "forward", first)]
    if cfg.causal:
        steps.append(("decode step", decode))
    for _, fn in steps:  # warm-ups
        fn()
    for what, fn in steps:
        tr = traced_run(fn, LM_TRACE_NAMES)
        if tr["busy"] is None:
            log(f"[{tag}] traced warm {what}: {tr['wall']:.4f} s wall; device idle "
                "share: not measured (the trace holds no device event)")
            continue
        kernels = "; ".join(f"{k} {v * 1e3:.3f} ms" for k, v in tr["per_kernel"].items())
        other = tr["busy"] - sum(tr["per_kernel"].values())
        log(f"[{tag}] traced warm {what}: {tr['wall']:.4f} s wall, device busy "
            f"{tr['busy']:.4f} s over {tr['events']} device events, idle share "
            f"{idle_share(tr)}; {kernels}; other device work {other * 1e3:.3f} ms")
        if cfg.moe is None:
            continue
        split = moe_split(fn)
        if split is None:
            log(f"[{tag}] traced warm {what}, MoE pieces: not measured (no device "
                "time in the record_function ranges)")
            continue
        total = sum(split.values())
        log(f"[{tag}] traced warm {what}, MoE FFN device time {total * 1e-3:.4f} s "
            "over its MoE layers: " + "; ".join(f"{k} {v:.3f} ms ({v / total:.3f})"
                                  for k, v in split.items())
            + " (dispatch: router, top-k and slots; experts: the three GEMMs and the "
            "activation)")


def full_model(tag: str, arch: str, paths: dict) -> None:
    """``arch`` at its published widths and ``FULL_DEPTHS[arch]`` layers:
    ``init_params``, then ``greedy`` at ``LM_BATCH`` x ``LM_PROMPT`` to
    ``LM_GEN`` tokens, the flash launch counts set to 0 just before and
    read just after (one a layer, all on the tensor-core route), every
    logit finite and the tokens in range; then the first flash call held
    and timed at its inputs (``paths[cfg.name]``), the first MoE layer's
    drops and pieces, and the traces."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.struct import tree_paths
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 unembedding stays f32
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=FULL_DEPTHS[arch])
    captured: dict = {}
    restore = [capture_first_calls(fa, "flash_attention_cuda", captured)]
    if cfg.moe is not None:
        restore.append(capture_first_calls(M, "moe_fwd", captured))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.inference_mode():
            fa.launches = 0
            for route in fa.route_launches:
                fa.route_launches[route] = 0
            t0 = time.perf_counter()
            params = M.init_params(cfg, 0, device="cuda")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            inputs = model_inputs(cfg, LM_BATCH, LM_PROMPT, "cuda")
            r = greedy(params, cfg, inputs, LM_GEN, torch.cuda.synchronize)
            launches, routes = fa.launches, dict(fa.route_launches)
    finally:
        for undo in restore:
            undo()
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers or routes["tensor_cores"] != cfg.n_layers:
        raise AssertionError(f"[{tag}] {cfg.name}: flash launches {launches}, by route "
                             f"{routes}; expected {cfg.n_layers}, all on the tensor "
                             "cores")
    if not all(torch.isfinite(lg).all() for lg in r["logits"]):
        raise AssertionError(f"[{tag}] {cfg.name}: a logit of the run was not finite")
    tok = r["tokens"]
    if tok.min() < 0 or tok.max() >= cfg.vocab:
        raise AssertionError(f"[{tag}] {cfg.name}: tokens out of range")
    n_tok = LM_BATCH * LM_PROMPT
    n_params = sum(t.numel() * t.element_size() for _, t in tree_paths(params))
    if cfg.causal:
        rates = (f"prefill {r['prefill_s']:.4f} s ({n_tok / r['prefill_s']:.1f} tok/s); "
                 f"decode {LM_BATCH * (LM_GEN - 2) / r['decode_s']:.2f} tok/s "
                 f"({r['decode_s'] / (LM_GEN - 2) * 1e3:.1f} ms a step); "
                 f"{LM_GEN} greedy tokens, first {tok[:, :6].tolist()}")
    else:
        rates = (f"forward {r['prefill_s']:.4f} s ({n_tok / r['prefill_s']:.1f} tok/s), "
                 f"logits {tuple(r['logits'][0].shape)}, aux {r['aux'].item()}")
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers (of {get_config(arch).n_layers}), "
        f"d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {cfg.dtype} weights {n_params / 1e9:.2f} GB; "
        f"{'embeddings' if cfg.input_mode == 'embeddings' else 'tokens'} "
        f"{tuple(inputs.shape)}; set-up {setup_s:.3f} s; {rates}; every logit finite; "
        f"flash launches {launches}, by route {routes}; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    del r
    (q, k, v), kw = captured.pop(("flash_attention_cuda", None))
    paths[cfg.name] = dict(launches=launches, **flash_at_inputs(tag, q, k, v, kw))
    del q, k, v
    if cfg.moe is not None:
        moe_drops(tag, cfg, captured.pop(("moe_fwd", None)))
    captured.clear()
    with torch.inference_mode():
        trace_model(tag, cfg, params, inputs)
    del params, inputs
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_full(paths: dict) -> None:
    for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"):
        full_model("moe-full", arch, paths)


def phase_emb_full(paths: dict) -> None:
    for arch in ("qwen2-vl-72b", "hubert-xlarge"):
        full_model("emb-full", arch, paths)


# ------------------------------------------------------------ training
#: train-full's runs: arch -> (batch, sequence, steps).  ``train_4k``'s
#: 4,096-token sequence (xlstm-125m 2,048), published widths, the batch
#: cut from 256 to fit one card.
TRAIN_FULL = {"llama3.2-1b": (4, 4096, 20), "recurrentgemma-2b": (2, 4096, 3),
              "xlstm-125m": (4, 2048, 2)}
TRAIN_LR = 3e-3
#: the ``kernels/ops.py`` entry of each kernel, and its ``Function``'s
#: backward (``record_function`` ranges of the traced step)
TRAIN_OPS = {"flash_attention": "flash_attention", "rglru_scan": "rglru",
             "slstm_scan": "slstm_scan"}
TRAIN_BWD = ("flash_bwd", "rglru_bwd", "slstm_bwd")


def phase_train_small() -> None:
    """Each ``Function``'s kernel path against its plain path on the card,
    then ``train`` with crashes and the resume pair."""
    import math
    import tempfile

    import numpy as np
    from repro_torch.kernels import lm_checks as lc
    from repro_torch.launch.train import train

    for case in lc.FLASH_GRAD_CASES:
        err = lc.check_flash_grads(case)
        log(f"[train-small] FlashFn (B, Hq, Hkv, T, D, causal, window, dtype) = {case}: "
            f"kernel path == plain path, o and dq, dk, dv (max |diff| {err:.3e})")
    for case in lc.RGLRU_GRAD_CASES:
        err = lc.check_rglru_grads(case)
        log(f"[train-small] RglruFn (B, T, D, h0) = {case}: kernel path (2 launches: "
            f"the forward and the reverse scan) == plain path, dx, da, dh0 "
            f"(max |diff| {err:.3e})")
    for case in lc.SLSTM_GRAD_CASES:
        err = lc.check_slstm_grads(case)
        log(f"[train-small] SlstmFn (B, T, d, H, R dtype, carry) = {case}: kernel path "
            f"== plain path, dR, dpre, dcarry0 (max |diff| {err:.3e})")
    log(f"[train-small] gradient tolerances: {lc.GRAD_TOL_F32} (f32) and "
        f"{lc.GRAD_TOL_BF16} (bf16) of the plain path's largest magnitude")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = train("llama3.2-1b", smoke=True, steps=24, batch=4, seq=128,
                    ckpt_dir=os.path.join(tmp, "crash"), ckpt_every=8, fail_at=(10, 19),
                    verbose=False)
        losses = out["losses"]
        if not (out["restarts"] == 2 and out["steps_run"] > 24
                and np.isfinite(losses + out["grad_norms"]).all()
                and out["final_loss"] < losses[0]):
            raise AssertionError(f"[train-small] crash run: restarts {out['restarts']}, "
                                 f"steps run {out['steps_run']}, losses {losses}")
        log(f"[train-small] train(llama3.2-1b, smoke, 24 steps, batch 4, seq 128, "
            f"fail_at (10, 19), a checkpoint every 8) on the card: {out['restarts']} "
            f"restarts, {out['steps_run']} steps run, loss {losses[0]:.4f} -> "
            f"{out['final_loss']:.4f}, every loss and grad norm finite "
            f"({time.perf_counter() - t0:.1f} s)")
        kw = dict(smoke=True, steps=16, batch=2, seq=32, ckpt_every=4, verbose=False)
        a = train("llama3.2-1b", ckpt_dir=os.path.join(tmp, "a"), **kw)
        b = train("llama3.2-1b", ckpt_dir=os.path.join(tmp, "b"), fail_at=(9,), **kw)
        if not (b["restarts"] == 1
                and math.isclose(a["final_loss"], b["final_loss"], rel_tol=1e-5)):
            raise AssertionError(f"[train-small] resume: {a['final_loss']} against "
                                 f"{b['final_loss']} after {b['restarts']} restarts")
        log(f"[train-small] resume determinism (tests/test_system.py:23): uninterrupted "
            f"{a['final_loss']:.6f}, crashed at step 9 and resumed {b['final_loss']:.6f}")


def capture_grad_calls(store: dict):
    """Wrap the ``kernels/ops.py`` entry of each kernel so that the
    arguments of its first call with grad (detached copies) land in
    ``store[kernel]``; returns a function that restores them."""
    import torch
    from repro_torch.kernels import ops

    undo = []
    for name, entry in TRAIN_OPS.items():
        orig = getattr(ops, entry)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            if _name not in store and torch.is_grad_enabled():
                copy = lambda x: (x.detach().clone() if isinstance(x, torch.Tensor)  # noqa: E731
                                  else x)
                store[_name] = ([{g: copy(t) for g, t in a.items()} if isinstance(a, dict)
                                 else tuple(map(copy, a)) if isinstance(a, tuple)
                                 else copy(a) for a in args], dict(kw))
            return _orig(*args, **kw)

        setattr(ops, entry, wrapped)
        undo.append((entry, orig))
    return lambda: [setattr(ops, e, o) for e, o in undo]


def expected_train_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps of ``cfg`` at full width:
    each layer's forward twice (remat recomputes it in the backward), and
    the RG-LRU once more (the backward's reverse scan)."""
    from repro_torch.models import model as M

    kinds = [k for pattern, n in M.segments_of(cfg) for k in pattern * n]
    fwd = 2 if cfg.remat else 1
    return {"flash_attention": fwd * steps * sum(k in M.ATTN_KINDS for k in kinds),
            "rglru_scan": (fwd + 1) * steps * kinds.count("rglru"),
            "slstm_scan": fwd * steps * kinds.count("slstm")}


def time_backward(forward, inputs: list, grads_out, reps: int) -> float:
    """Median ms of ``torch.autograd.grad`` of ``forward(*inputs)`` (one
    forward, its graph kept), by CUDA events; a warm-up call first where
    ``reps`` > 1 (a backward of seconds is timed cold, once)."""
    import statistics

    import torch

    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = forward(*leaves)
    run = lambda: torch.autograd.grad(outs, leaves, grads_out, retain_graph=True)  # noqa: E731
    if reps > 1:
        run()
    ms = statistics.median(time_reps(run, reps))
    del outs
    return ms


def train_kernel_row(tag: str, name: str, args: list, kw: dict) -> dict:
    """The first call of ``name``'s ``Function`` in a train run, at its
    inputs: kernel path against plain path (output and every input's
    gradient, ``lm_checks``), the forward's times and bound as the serving
    phases take them, and the backward's time on the kernel path beside
    the plain backward (autograd through the plain version)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lm_checks as lc
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.kernels.ref import attention_mask

    gen = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda x: torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)  # noqa: E731
    if name == "flash_attention":
        q, k, v = (x.contiguous() for x in args[:3])
        mkw = dict(causal=kw["causal"], window=kw["window"], sm_scale=kw.get("sm_scale"))
        do = rand(q)
        err = lc.compare_flash_grads(q, k, v, do, **mkw)
        fwd = flash_at_inputs(tag, q, k, v, dict(mkw, sm_scale=mkw["sm_scale"]
                                                 or q.shape[-1] ** -0.5))
        kern = lambda *t: ops.flash_attention(*t, **mkw)  # noqa: E731
        plain = lambda *t: fa.flash_attention_ref(*t, **mkw)  # noqa: E731
        inputs, gout = [q, k, v], (do,)
        mask = (attention_mask(q.shape[2], k.shape[2], mkw["causal"], mkw["window"],
                               q.device) if mkw["window"] is not None else None)
        library = lambda *t: F.scaled_dot_product_attention(  # noqa: E731
            *t, attn_mask=mask, is_causal=mkw["causal"] and mask is None,
            scale=mkw["sm_scale"], enable_gqa=True)
        pairs = attention_pairs(q.shape[2], k.shape[2], mkw["causal"], mkw["window"])
        bwd_flop = 7 * 2 * pairs * q.shape[0] * q.shape[1] * q.shape[3]
        # q, k, v, o, do and lse read; dq, dk, dv written
        bwd_bytes = 2 * nbytes(q, k, v) + 2 * nbytes(q) + 4 * q[..., 0].numel()
        shape = f"q {tuple(q.shape)}, k/v {tuple(k.shape)} {q.dtype}, {mkw}"
        reps = 3
    elif name == "rglru_scan":
        library = None
        x, a, h0 = args[:3]
        dh, dlast = rand(x), rand(x[:, 0])
        err = lc.compare_rglru_grads(x, a, h0, dh, dlast)
        fwd = time_kernel(tag, "rglru_scan", lambda: rg.rglru_scan_cuda(x, a, h0),
                          lambda: rg.rglru_scan_ref(x, a, h0), 10, 3, hold=True)
        fwd["bound_ms"], fwd["bound_by"] = rglru_bound(x, h0)
        fwd["library_ms"], fwd["max_abs_err"] = None, lc.compare_rglru(x, a, h0)
        kern = lambda x_, a_: ops.rglru(x_, a_, h0)  # noqa: E731
        plain = lambda x_, a_: rg.rglru_scan_ref(x_, a_, h0)  # noqa: E731
        inputs, gout = [x, a], (dh, dlast)
        bwd_flop = 5 * x.numel()
        bwd_bytes = 5 * nbytes(x) + 2 * nbytes(x[:, 0])  # a, h, dh in; dx, da out
        shape = f"x {tuple(x.shape)} {x.dtype}, h0 {'given' if h0 is not None else 'None'}"
        reps = 5
    else:
        r, pre, carry0 = args[:3]
        B, T, _, d = pre.shape
        H, hd = r["i"].shape[:2]
        dhs, dfin = rand(pre[:, :, 0]), [rand(c) for c in carry0]
        err = lc.compare_slstm_grads(r, pre, carry0, dhs, dfin)
        fwd = time_kernel(tag, "slstm_scan", lambda: sl.slstm_scan_cuda(r, pre, carry0),
                          lambda: sl.slstm_scan_ref(r, pre, carry0), 3, 1)
        n_bytes = (nbytes(*r.values(), pre, *carry0) + 4 * B * T * d * 4 + nbytes(*carry0))
        fwd["bound_ms"], fwd["bound_by"] = bound(n_bytes, 4 * 2 * hd * d * B * T,
                                                 F32_OPS_PER_S)
        fwd["library_ms"], fwd["max_abs_err"] = None, lc.compare_slstm(r, pre, carry0)
        rs = [r[g] for g in sl.GATES]
        kern = lambda *t: _slstm_outs(ops.slstm_scan, t)  # noqa: E731
        plain = lambda *t: _slstm_outs(sl.slstm_scan_ref, t)  # noqa: E731
        inputs, gout = rs + [pre, *carry0], (dhs, *dfin)
        bwd_flop = 3 * 4 * 2 * hd * d * B * T
        # pre, dpre and the four sequences and dhs (f32), R and dR
        bwd_bytes = 2 * nbytes(pre) + 5 * 4 * B * T * d + 2 * nbytes(*rs)
        shape = f"pre {tuple(pre.shape)}, R {H}x({hd}, {hd}) {r['i'].dtype}"
        reps = 1
        library = None
    bwd_ms = time_backward(kern, inputs, gout, reps)
    plain_bwd_ms = time_backward(plain, inputs, gout, max(1, reps - 1))
    library_bwd_ms = None if library is None else time_backward(library, inputs, gout, reps)
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_flop, F32_OPS_PER_S)
    log(f"[{tag}] {name} at the train step's first call, {shape}: kernel path == plain "
        f"path (every input's gradient, max |diff| {err:.3e}); forward {fwd['ms']:.4f} ms "
        f"(plain {fwd['plain_ms']:.4f}, bound {fwd['bound_ms']:.4f}, {fwd['bound_by']}); "
        f"backward (torch ops) {bwd_ms:.4f} ms against its bound {bwd_bound:.4f} ms "
        f"({bwd_by}: {bwd_flop:.4e} f32 flop, {bwd_bytes} B); the plain backward "
        f"(autograd through the plain version) {plain_bwd_ms:.4f} ms"
        + ("" if library_bwd_ms is None else
           f"; scaled_dot_product_attention's backward (same mask, enable_gqa) "
           f"{library_bwd_ms:.4f} ms"))
    return dict(max_abs_err=fwd["max_abs_err"], grad_max_abs_err=err, ms=fwd["ms"],
                plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
                bound_by=fwd["bound_by"], library_ms=fwd["library_ms"], bwd_ms=bwd_ms,
                plain_bwd_ms=plain_bwd_ms, library_bwd_ms=library_bwd_ms,
                bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by, shape=shape)


def _slstm_outs(scan, t):
    from repro_torch.kernels import slstm_scan as sl

    hs, _, fin = scan(dict(zip(sl.GATES, t[:4])), t[4], tuple(t[5:]))
    return (hs, *fin)


def trace_train_step(tag: str, arch: str, B: int, T: int) -> None:
    """One warm train step of ``arch`` at full width under ``torch.profiler``
    (device activity): wall, idle share, the top device ops; then one with
    host activity too, each ``Function``'s backward in a ``record_function``
    range: its device time and share of the step's.  Fresh weights; the
    launches these steps add are not the main path's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import AdamW

    cfg = get_config(arch)
    params = M.init_params(cfg, 0, device="cuda")
    opt = AdamW(lr=TRAIN_LR, warmup_steps=2, total_steps=20)
    state = {"opt": opt.init(params), "params": params}
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=T, global_batch=B))

    def run():
        b = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch().items()}
        state["params"], state["opt"], m = step(state["params"], state["opt"], b)
        float(m["loss"])

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    if not spans:
        log(f"[{tag}] traced train step: {wall:.4f} s wall; device idle share: not "
            "measured (the trace holds no device event)")
        return
    per_op: dict = {}
    busy_us, reach = 0.0, float("-inf")
    for lo, hi, name in spans:
        per_op[name] = per_op.get(name, 0.0) + (hi - lo) * 1e-3
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    busy_ms = busy_us * 1e-3
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{tag}] traced warm train step ({arch}, {B} x {T}): {wall:.4f} s wall, device "
        f"busy {busy_ms * 1e-3:.4f} s over {len(spans)} device events, idle share "
        f"{1.0 - busy_ms * 1e-3 / wall:.4f}; top device ops: "
        + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in top))
    origs = {name: getattr(ops, name) for name in TRAIN_BWD}

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with record_function(f"bwd.{name}"):
                return fn(*a, **kw)
        return wrapped

    for name, fn in origs.items():
        setattr(ops, name, ranged(name, fn))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for name, fn in origs.items():
            setattr(ops, name, fn)
    ms = dict.fromkeys(TRAIN_BWD, 0.0)
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("bwd."):
            ms[ev.name[4:]] += ev.device_time_total * 1e-3
    log(f"[{tag}] traced warm train step, the Functions' backwards by device time: "
        + "; ".join(f"{k} {v:.2f} ms ({v / busy_ms:.3f} of the untraced step's busy)"
                    for k, v in ms.items() if v)
        + ("" if any(ms.values()) else "not measured (no device time in the ranges)"))
    del state, params


def phase_train_full(rows: dict) -> None:
    """``launch.train.train`` at published widths: llama3.2-1b (the path),
    then recurrentgemma-2b and xlstm-125m; each run's launch counts set to
    0 just before and read just after; each kernel's first call held and
    timed at its inputs (``rows``: kernel -> arch -> numbers)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.launch.train import train

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 unembedding stays f32
    mods = {"flash_attention": fa, "rglru_scan": rg, "slstm_scan": sl}
    for arch, (B, T, steps) in TRAIN_FULL.items():
        tag = "train-full"
        cfg = get_config(arch)
        captured: dict = {}
        undo = capture_grad_calls(captured)
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for mod in mods.values():
                mod.launches = 0
            t0 = time.perf_counter()
            out = train(arch, smoke=False, steps=steps, batch=B, seq=T, lr=TRAIN_LR,
                        verbose=False)
            run_s = time.perf_counter() - t0
            launches = {n: mod.launches for n, mod in mods.items()}
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated()
        want = expected_train_launches(cfg, steps)
        if launches != want:
            raise AssertionError(f"[{tag}] {arch}: launches {launches}, expected {want}")
        losses, gnorms = out["losses"], out["grad_norms"]
        if not np.isfinite(losses + gnorms).all() or len(losses) != steps:
            raise AssertionError(f"[{tag}] {arch}: losses {losses}, grad norms {gnorms}")
        if arch == "llama3.2-1b" and not losses[-1] < losses[0]:
            raise AssertionError(f"[{tag}] {arch}: the loss did not fall: {losses}")
        warm = out["step_s"][1:] or out["step_s"]
        step_s = statistics.median(warm)
        log(f"[{tag}] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
            f"{cfg.param_count() / 1e9:.3f} B parameters, {cfg.dtype}, remat "
            f"{cfg.remat}; batch {B} x {T} tokens, {steps} steps at lr {TRAIN_LR}: "
            f"set-up {out['setup_s']:.3f} s, first step {out['step_s'][0]:.3f} s, step "
            f"median {step_s:.4f} s ({min(warm):.4f}-{max(warm):.4f}) = "
            f"{B * T / step_s:.1f} tokens/s, run {run_s:.1f} s; peak device memory "
            f"{peak / 2**30:.2f} GiB; launches {launches}")
        log(f"[{tag}] {arch} loss curve: " + ", ".join(f"{x:.4f}" for x in losses))
        log(f"[{tag}] {arch} grad norms: " + ", ".join(f"{x:.3f}" for x in gnorms))
        del out
        torch.cuda.empty_cache()
        if arch == "llama3.2-1b":
            trace_train_step(tag, arch, B, T)
            torch.cuda.empty_cache()
        for name, (args, kw) in captured.items():
            row = train_kernel_row(tag, name, args, kw)
            rows.setdefault(name, {})[arch] = dict(row, launches=launches[name])
            torch.cuda.empty_cache()
        del captured


# ------------------------------------------------------------ the dry-run
DRYRUN_ARCH = "llama3.2-1b"
PR26_STEP_S = 2.7576  # train-full's llama step, PR 26 (PERF.md; H100 80GB HBM3, 700 W)
#: count_paths' cells: (arch, shape, layers, batch, sequence cut or None).
#: The xlstm prefill's sequence is cut to 1,024: its plain path runs the
#: sLSTM's ~90 aten ops a step under the counter's Python modes.
COUNT_CELLS = (("llama3.2-1b", "train_4k", 2, 1, None),
               ("recurrentgemma-2b", "prefill_32k", 2, 1, None),
               ("xlstm-125m", "prefill_32k", 2, 1, 1024))
COUNT_KERNELS = {"llama3.2-1b": "flash_attention", "recurrentgemma-2b": "rglru_scan",
                 "xlstm-125m": "slstm_scan"}


def dryrun_line(rec: dict, card: str) -> str:
    mem = rec["memory_analysis"]
    peak = mem.get("peak_bytes")
    return (f"batch {rec.get('batch', '-')} (reduced: {rec.get('reduced') or 'nothing'}); "
            f"build {rec['build_s']:.3f} s, step {rec['step_s']:.4f} s on {card}; "
            f"arguments predicted {mem['argument_size_in_bytes']} B, allocated "
            f"{mem['argument_allocated_bytes']} B; peak "
            f"{'-' if peak is None else f'{peak / 2**30:.2f} GiB'}; counted "
            f"{rec['hlo_flops']:.6e} flop, {rec['hlo_bytes_per_chip']:.6e} B over "
            f"{rec['ops']} aten ops (kernel reports {rec.get('kernels', {})}); terms "
            f"compute {rec['compute_s']:.6f} s, memory {rec['memory_s']:.6f} s, "
            f"collective {rec['collective_s']} s at 989 TFLOP/s and 3.35 TB/s: dominant "
            f"{rec['dominant']}, model flops {rec['model_flops']:.6e}, useful_ratio "
            f"{rec['useful_ratio']:.6f}")


def phase_dryrun_full() -> None:
    """``launch.dryrun`` on the card: llama3.2-1b's three cells through
    ``run_lm_cell`` (the launch counts set to 0 just before each and read
    just after), the counts through the kernels against those through
    their plain versions, ``run_manycore``, and every record rendered
    through ``launch.report``."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lm_checks as lc
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import report as R
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding.partition import Strategy

    tag = "dryrun-full"
    card = nvidia_smi()
    mods = {"flash_attention": fa, "rglru_scan": rg, "slstm_scan": sl}
    cfg = get_config(DRYRUN_ARCH)
    n_attn = sum(k in M.ATTN_KINDS for pattern, n in M.segments_of(cfg) for k in pattern * n)
    fwd = 2 if cfg.remat else 1
    with tempfile.TemporaryDirectory() as out_dir:
        # the first batch tried: train-full's for train_4k; prefill_32k's 32
        # rows need ~115 GB of activations, so its search starts at 16
        for shape, batch in (("train_4k", TRAIN_FULL[DRYRUN_ARCH][0]), ("prefill_32k", 16),
                             ("decode_32k", None)):
            torch.cuda.empty_cache()
            for mod in mods.values():
                mod.launches = 0
            t0 = time.perf_counter()
            rec = D.run_lm_cell(DRYRUN_ARCH, shape, "card", batch=batch)
            launches = {n: m.launches for n, m in mods.items()}
            if rec["status"] != "ok":
                raise AssertionError(f"[{tag}] {shape}: {rec.get('error') or rec.get('reason')}"
                                     f"\n{rec.get('trace', '')}")
            D.save(rec, out_dir)
            mem = rec["memory_analysis"]
            step = SHAPES[shape].step
            want = {"train": {"flash_attention": fwd * n_attn},
                    "prefill": {"flash_attention": n_attn}, "decode": {}}[step]
            if rec["kernels"] != want:
                raise AssertionError(f"[{tag}] {shape}: the counted run's kernel reports "
                                     f"{rec['kernels']}, expected {want}")
            if step == "train":
                if mem["argument_size_in_bytes"] != mem["argument_allocated_bytes"]:
                    raise AssertionError(f"[{tag}] train_4k: predicted argument bytes "
                                         f"{mem['argument_size_in_bytes']} != allocated "
                                         f"{mem['argument_allocated_bytes']}")
                if launches != {"flash_attention": 2 * fwd * n_attn, "rglru_scan": 0,
                                "slstm_scan": 0}:
                    raise AssertionError(f"[{tag}] train_4k: launches {launches}")
            elif launches["flash_attention"] < (step == "prefill") * 2 * n_attn:
                raise AssertionError(f"[{tag}] {shape}: launches {launches}")
            log(f"[{tag}] {DRYRUN_ARCH} {shape} on the card ({time.perf_counter() - t0:.1f} s, "
                f"launches {launches}): " + dryrun_line(rec, card)
                + (f"; train-full's step (PR 26) {PR26_STEP_S} s, this step "
                   f"{rec['step_s'] / PR26_STEP_S:.3f}x it; predicted == allocated argument "
                   f"bytes" if step == "train" else
                   f"; decode's position is a host int here, 4 B in the reference's "
                   f"arguments" if step == "decode" else ""))
            del rec
        for arch, shape_name, layers, batch, seq in COUNT_CELLS:
            ccfg = dataclasses.replace(get_config(arch), n_layers=layers)
            cshape = SHAPES[shape_name]
            if seq is not None:
                cshape = dataclasses.replace(cshape, seq_len=seq)

            def run(ccfg=ccfg, cshape=cshape, batch=batch):
                fn, args, _ = S.cell_step(ccfg, cshape, make_host_mesh(), Strategy(), "cuda",
                                          batch=batch)
                fn(*args)
                torch.cuda.synchronize()

            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            kern, plain = lc.count_paths(run)
            name = COUNT_KERNELS[arch]
            layout = lc.flash_layout_bytes(ccfg, batch, cshape.seq_len, kern)
            if (kern.flops != plain.flops or name not in kern.kernels or plain.kernels
                    or kern.bytes - plain.bytes != layout):
                raise AssertionError(
                    f"[{tag}] {arch} {shape_name}: through the kernels {kern.flops} flop, "
                    f"{kern.bytes} B (reports {kern.kernels}), through the plain versions "
                    f"{plain.flops} flop, {plain.bytes} B; o's layout copies {layout} B")
            log(f"[{tag}] counts of {arch} {shape_name} ({layers}-layer cut, batch {batch}, "
                f"sequence {cshape.seq_len}{' (cut)' if seq else ''}) with use_kernels=True "
                f"through the kernels (reports {kern.kernels}) == through their plain "
                f"versions: {kern.flops} flop each; bytes {kern.bytes} and {plain.bytes}, "
                f"the difference {kern.bytes - plain.bytes} the copies of flash's "
                f"(B, H, T, D) output into the layer's (B, T, H, D) order (one a call, "
                f"after the kernel only); aten ops {kern.ops} and {plain.ops} "
                f"({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = D.run_manycore("card")
        if rec["status"] != "ok":
            raise AssertionError(f"[{tag}] manycore: {rec.get('error')}\n{rec.get('trace', '')}")
        D.save(rec, out_dir)
        mem = rec["memory_analysis"]
        log(f"[{tag}] manycore {rec['shape']} on GridEngine, one shard on the card "
            f"({time.perf_counter() - t0:.1f} s): build {rec['build_s']:.3f} s, "
            f"an epoch ({rec['step_kind']}) {rec['step_s']:.4f} s on {card}; state "
            f"{mem['argument_size_in_bytes']} B, peak {mem['peak_bytes'] / 2**30:.2f} GiB; "
            f"counted {rec['hlo_bytes_per_chip']:.6e} B over {rec['ops']} aten ops, memory "
            f"term {rec['memory_s']:.6f} s")
        t0 = time.perf_counter()
        for arch in ARCH_IDS:
            for mk in ("single", "multi"):
                recs = ([D.run_manycore(mk)] if arch == "manycore" else
                        [D.run_lm_cell(arch, shape, mk) for shape in SHAPES])
                for r in recs:
                    if r["status"] == "error":
                        raise AssertionError(f"[{tag}] {arch} {r['shape']} {mk}: {r['error']}")
                    D.save(r, out_dir)
        log(f"[{tag}] single and multi records of 10 architectures x 4 shapes and the "
            f"manycore grid in {time.perf_counter() - t0:.1f} s; launch.report:")
        for line in (R.dryrun_table(out_dir) + "\n\n" + R.roofline_table("card", out_dir)
                     ).splitlines():
            log(f"[{tag}] {line}")


# ------------------------------------------------------------ session surface
def relay_network(n: int, M: int):
    """A chain of ``n`` SystolicCells fed by the host: each passes the
    packet east unchanged and collects ``a * b`` into its ``y_buf`` (its
    north and south edges synthesized), the last hands it back to the
    host.  Host I/O through ``granule_step``'s SystolicCell device step."""
    import numpy as np
    from repro_torch.core import Network
    from repro_torch.hw.systolic import SystolicCell, SystolicParams

    net = Network(payload_words=2, capacity=4)
    cell = SystolicCell(M)
    insts = [net.instantiate(cell, name=f"r{i}", params=SystolicParams(
        b=np.float32(i + 2), is_west=np.bool_(False), is_north=np.bool_(True),
        is_south=np.bool_(True), is_east=np.bool_(False),
        a_buf=np.zeros(M, np.float32))) for i in range(n)]
    net.external_in(insts[0]["w_in"], "tx")
    for a, b in zip(insts, insts[1:]):
        net.connect(a["e_out"], b["w_in"])
    net.external_out(insts[-1]["e_out"], "rx")
    return net


def interactive(sim, count, ckpt=None, resume=None):
    """``tests/test_session.py``'s interactive scenario: send, run 8
    cycles, save (or load), send more, run and drain.  Returns the traffic,
    ``count(state)`` of each of the 3 blocks, and the cycle."""
    import numpy as np

    sim.reset(0)
    if resume is None:
        sim.tx("tx").send_many([[v, 0.0] for v in (10.0, 20.0, 30.0)])
        sim.run(cycles=8)
        if ckpt is not None:
            sim.save(ckpt)
    else:
        sim.load(resume)
    sim.tx("tx").send_many([[v, 1.0] for v in (40.0, 50.0)])
    out = []
    for _ in range(5):
        sim.run(cycles=10)
        out.extend(np.asarray(sim.rx("rx").drain()))
    return np.asarray(out), [int(count(sim.probe(i))) for i in range(3)], sim.cycle


def io_script(sim):
    """Pseudo-random host sends and drains, one boundary at a time."""
    import numpy as np

    rng = np.random.RandomState(0)
    tx, rx = sim.tx("tx"), sim.rx("rx")
    trace = []
    for step in range(12):
        k = int(rng.randint(0, 3))
        if k:
            tx.send_many([[100.0 * step + j, float(step)] for j in range(k)])
        sim.run(cycles=sim.period)
        trace.append(np.asarray(rx.drain()))
    sim.run(cycles=16 * sim.period)
    trace.append(np.asarray(rx.drain()))
    return trace


def phase_session_small() -> None:
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core import Network, Simulation
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.hw.systolic import make_systolic_network
    from repro_torch.kernels import granule_step, systolic_step
    from repro_torch.kernels.fused_checks import compare
    from repro_torch.obs import report, schema
    from repro_torch.obs import trace as obs_trace

    granule_step.launches = systolic_step.launches = 0
    tmp = tempfile.mkdtemp(prefix="session-small-")
    try:
        # the four-engine scenario of tests/test_session.py on the card
        rng = np.random.RandomState(3)
        M, K, N = 6, 4, 4
        A, B = rng.randn(M, K).astype(np.float32), rng.randn(K, N).astype(np.float32)

        def build(engine):
            net, _ = make_systolic_network(A, B)
            if engine == "single":
                return net.build(device="cuda")
            return net.build(engine=engine, device="cuda", K=4)

        def done_for(sim):
            if sim.kind == "register":
                return lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all()
            return lambda s: ((~s.block_states[0].is_south)
                              | (s.block_states[0].y_idx >= M)).all()

        def result_of(sim):
            if sim.kind == "register":
                return np.asarray(sim.engine.result(sim.state))
            return np.stack([sim.probe((K - 1) * N + c).y_buf.cpu().numpy()
                             for c in range(N)], 1)

        results, resumed, stops = {}, {}, {}
        for engine in ("single", "graph", "fused", "register"):
            sim = build(engine).reset(0)
            sim.run(cycles=12)
            ckpt = os.path.join(tmp, f"sys_{engine}")
            sim.save(ckpt)
            sim.run(until=done_for(sim), max_epochs=100_000, cache_key="done")
            results[engine], stops[engine] = result_of(sim), sim.cycle
            sim2 = build(engine).reset(0)
            sim2.load(ckpt)
            if sim2.cycle != 12:
                raise AssertionError(f"[session-small] {engine}: loaded cycle {sim2.cycle}")
            sim2.run(until=done_for(sim2), max_epochs=100_000, cache_key="done")
            resumed[engine] = result_of(sim2)
            schema.validate_stats(sim2.stats())
        for engine in results:
            for got, what in ((results[engine], "run"), (resumed[engine], "resume")):
                if not np.array_equal(got.view(np.int32), results["single"].view(np.int32)):
                    raise AssertionError(f"[session-small] {engine} {what}: Y differs "
                                         "from the single engine's")
        if not np.allclose(results["single"], A @ B, rtol=1e-4, atol=1e-5):
            raise AssertionError("[session-small] Y is not A @ B")
        log(f"[session-small] systolic {M}x{K} @ {K}x{N} on single, graph, fused and "
            f"register: reset, run(cycles=12), save, run(until) and a fresh session's "
            f"load and resume; every Y bit-identical to the single engine's, each "
            f"resume to its run (stop cycles {stops})")

        # the interactive chain scenario: Increment blocks (no device step:
        # single and graph), SystolicCell relays (fused, through granule_step)
        quickstart = load_example("torch_quickstart")
        dut = quickstart.IncrementDut()

        def chain(block_net, engine):
            net = block_net()
            if engine == "single":
                return net.build(device="cuda")
            return net.build(engine=engine, device="cuda", K=2)

        def inc_net():
            net = Network(payload_words=2, capacity=4)
            insts = [net.instantiate(dut, name=f"b{i}") for i in range(3)]
            net.external_in(insts[0]["to_rtl"], "tx")
            for a, b in zip(insts, insts[1:]):
                net.connect(a["from_rtl"], b["to_rtl"])
            net.external_out(insts[-1]["from_rtl"], "rx")
            return net

        for name, block_net, count, engines, want in (
                ("Increment", inc_net, lambda s: s.handshakes, ("single", "graph"),
                 [13.0, 23.0, 33.0, 43.0, 53.0]),
                ("SystolicCell relay", lambda: relay_network(3, 8), lambda s: s.y_idx,
                 ("single", "graph", "fused"), [10.0, 20.0, 30.0, 40.0, 50.0])):
            ref = None
            for engine in engines:
                ckpt = os.path.join(tmp, f"chain_{name[:3]}_{engine}")
                full = interactive(chain(block_net, engine), count, ckpt=ckpt)
                res = interactive(chain(block_net, engine), count, resume=ckpt)
                if not (np.array_equal(full[0], res[0]) and full[1:] == res[1:]):
                    raise AssertionError(f"[session-small] {name} {engine}: the resumed "
                                         "run differs from the uninterrupted one")
                if sorted(full[0][:, 0].tolist()) != want or full[1] != [5, 5, 5]:
                    raise AssertionError(f"[session-small] {name} {engine}: got "
                                         f"{full[0][:, 0].tolist()}, counts {full[1]}")
                ref = full if ref is None else ref
                if not (np.array_equal(full[0], ref[0]) and full[1:] == ref[1:]):
                    raise AssertionError(f"[session-small] {name} {engine} differs "
                                         f"from {engines[0]}")
            log(f"[session-small] {name} chain, interactive checkpoint/resume on "
                f"{', '.join(engines)}: traffic {ref[0][:, 0].tolist()}, counts {ref[1]}, "
                f"cycle {ref[2]}, equal across engines and across resume")
        try:
            interactive(chain(inc_net, "fused"), lambda s: s.handshakes)
        except NotImplementedError as e:
            log(f"[session-small] the fused engine refuses the Increment chain on "
                f"the card (no device step): {str(e)[:70]}...")
        else:
            raise AssertionError("the fused engine ran a block without a device step")

        # monitor cadence and the monitor-invariant stop on FusedEngine
        eng, _ = wafer_engine(32, 32, 2, 4, 4, False, "cuda")
        done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
        samples = {}
        for slices in ((1,) * 10, (3, 7), (10,)):
            sim = Simulation(eng).reset(0)
            got = samples[slices] = []
            sim.add_monitor(lambda s, got=got: got.append(
                (s.epoch, int(s.engine.gather_group(s.state, 0).fires.sum()))), every=2)
            for n in slices:
                sim.run(epochs=n)
        if len({tuple(v) for v in samples.values()}) != 1 or \
                [e for e, _ in samples[(10,)]] != [2, 4, 6, 8, 10]:
            raise AssertionError(f"[session-small] monitor samples {samples}")
        free = Simulation(eng).reset(0).run(until=done, max_epochs=1000)
        for every in (1, 3, 16):
            sim = Simulation(eng).reset(0)
            seen = []
            sim.add_monitor(lambda s: seen.append(s.epoch), every=every)
            sim.run(until=done, max_epochs=1000)
            if sim.cycle != free.cycle or seen != list(range(every, sim.epoch + 1, every)):
                raise AssertionError(f"[session-small] monitor every {every}: stop "
                                     f"{sim.cycle} (free {free.cycle}), samples {seen}")
            compare(sim.state, free.state)
        # traced, a monitored until-run records a span for every stretch it ran
        sim = Simulation(eng).reset(0)
        sim.add_monitor(lambda s: None, every=16)
        path = os.path.join(tmp, "until_trace.json")
        obs_trace.recorder().clear()
        with sim.trace(path):
            sim.run(until=done, max_epochs=1000)
        spans = [e for e in schema.validate_trace_file(path)["traceEvents"]
                 if e["name"] == "epoch_window"]
        if sim.cycle != free.cycle or sum(e["args"]["epochs"] for e in spans) != sim.epoch:
            raise AssertionError(f"[session-small] traced monitored run: stop {sim.cycle} "
                                 f"(free {free.cycle}), spans {[e['args'] for e in spans]}")
        compare(sim.state, free.state)
        log(f"[session-small] FusedEngine 32x32 wafer: a monitor every 2 epochs samples "
            f"{samples[(10,)][:3]}... alike over 10x1, 3+7 and 10 epochs; run(until) "
            f"with a monitor every 1, 3 and 16 epochs stops at the monitor-free cycle "
            f"{free.cycle} with its state bit for bit; traced with a monitor every 16, "
            f"{len(spans)} epoch_window spans cover its {sim.epoch} epochs")

        # the flight recorder: traced traffic bit-identical, a valid file
        ref = io_script(chain(lambda: relay_network(3, 8), "fused").reset(0))
        sim = chain(lambda: relay_network(3, 8), "fused").reset(0)
        path = os.path.join(tmp, "trace.json")
        obs_trace.recorder().clear()
        with sim.trace(path):
            got = io_script(sim)
        if len(ref) != len(got) or not all(np.array_equal(a, b) for a, b in zip(ref, got)):
            raise AssertionError("[session-small] traced traffic differs from untraced")
        doc = schema.validate_trace_file(path)
        spans = [e for e in doc["traceEvents"] if e["name"] == "epoch_window"]
        text = report.summarize(doc)
        log(f"[session-small] traced relay chain on the fused engine: traffic "
            f"({sum(len(t) for t in got)} packets) bit-identical to the untraced run; "
            f"{len(spans)} epoch_window spans, valid; report: {text.splitlines()[3].strip()}")

        stats = quickstart.main(["--device", "cuda"])
        log(f"[session-small] examples/torch_quickstart.py on cuda: cycle "
            f"{stats['cycle']}, sent {stats['ports']['tx']['to_rtl.q']['sent']}, "
            f"received {stats['ports']['rx']['from_rtl.q']['received']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {"granule_step": granule_step.launches, "systolic_step": systolic_step.launches}
    if min(launched.values()) <= 0:
        raise AssertionError(f"[session-small] kernel launches {launched}")
    log(f"[session-small] kernel launches in the phase: {launched}")


def phase_session_full() -> None:
    """wafer-1M as a session on ``FusedEngine``: a monitor every 16 epochs,
    a save at epoch 32, loads in place and into a fresh session, a trace."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import Simulation
    from repro_torch.core.struct import tree_leaves
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.kernels import granule_step
    from repro_torch.kernels.fused_checks import clone, compare
    from repro_torch.obs import report, schema
    from repro_torch.obs import trace as obs_trace

    R, C, every, save_at = CONFIG.grid_rows, CONFIG.grid_cols, 16, 32
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    eng, values = wafer_engine(R, C, CONFIG.k_outer, CONFIG.k_inner,
                               CONFIG.queue_capacity, False, "cuda")
    total = float(values.astype(np.float64).sum())  # 4,718,592 at full width
    sim = Simulation(eng).reset(0)
    start = clone(sim.state)
    sync()
    leaves = [x for x in tree_leaves(sim.state) if isinstance(x, torch.Tensor)]
    state_bytes = sum(x.numel() * x.element_size() for x in leaves)
    log(f"[session-full] wafer {R}x{C} on FusedEngine (tiers {eng.K_tiers}, capacity "
        f"{eng.capacity}, {eng.cycles_per_epoch} cycles an epoch): set-up "
        f"{time.perf_counter() - t0:.2f} s; state {len(leaves)} tensor leaves, "
        f"{state_bytes} B ({state_bytes / 2**20:.1f} MiB)")
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731

    def timed_run(**kw):
        assign(sim.state, start)
        sync()
        c0 = until_counts()
        t = time.perf_counter()
        sim.run(**kw)
        sync()
        return time.perf_counter() - t, counts_since(c0)

    granule_step.launches = 0
    # 1. run to allreduce_done without a monitor, then with one every 16
    # epochs; each cold (its capture) and warm
    timed_run(until=done, max_epochs=1000)
    free_s, free = timed_run(until=done, max_epochs=1000)
    stop, final = sim.cycle, clone(sim.state)
    samples = []

    def sample(s):
        samples.append((s.epoch, s.cycle, float(s.probe(0).total)))

    mon = sim.add_monitor(sample, every=every)
    cold_s, cold = timed_run(until=done, max_epochs=1000)
    mon.remove()
    samples.clear()
    mon = sim.add_monitor(sample, every=every)
    mon_s, warm = timed_run(until=done, max_epochs=1000)
    if sim.cycle != stop:
        raise AssertionError(f"[session-full] the monitored run stopped at {sim.cycle}, "
                             f"the monitor-free run at {stop}")
    compare(sim.state, final)
    per = sim.period
    want_epochs = list(range(every, stop // per + 1, every))
    if [e for e, _, _ in samples] != want_epochs or \
            [c for _, c, _ in samples] != [e * per for e in want_epochs]:
        raise AssertionError(f"[session-full] monitor samples {samples}")
    totals = eng.gather_group(sim.state, 0).total
    if not np.array_equal(totals, np.full_like(totals, total)):
        raise AssertionError(f"[session-full] totals {np.unique(totals)[:5]} != {total}")
    if warm["captures"] != 0:
        raise AssertionError(f"[session-full] the warm monitored run captured "
                             f"{warm['captures']} spans")
    log(f"[session-full] run(until=allreduce_done) stops at cycle {stop} "
        f"({stop // per} epochs) with and without a monitor every {every} epochs, state "
        f"bit for bit; every core's total {total:.0f}; samples (epoch, cycle, "
        f"probe(0).total) {samples}")
    log(f"[session-full] warm wall: monitor-free {free_s:.4f} s ({int(free['syncs'])} host "
        f"syncs, {int(free['spans'])} spans), monitored {mon_s:.4f} s "
        f"({int(warm['syncs'])} host syncs, {int(warm['spans'])} spans, "
        f"{mon.samples} samples), {mon_s / free_s:.3f}x; captures: warm runs "
        f"{int(free['captures'] + warm['captures'])}, the monitored cold run "
        f"{int(cold['captures'])} ({cold['capture_s']:.3f} s, wall {cold_s:.3f} s)")

    # 2. save at epoch 32; load into the running session and into a fresh one
    mon.remove()
    assign(sim.state, start)
    sim.run(epochs=save_at)
    tmp = tempfile.mkdtemp(prefix="session-full-")
    try:
        sync()
        t = time.perf_counter()
        path = sim.save(tmp)
        save_s = time.perf_counter() - t
        disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        sim.run(until=done, max_epochs=1000)
        c0 = until_counts()
        t = time.perf_counter()
        sim.load(tmp)
        sync()
        load_in_place_s = time.perf_counter() - t
        if sim.cycle != save_at * per:
            raise AssertionError(f"[session-full] loaded cycle {sim.cycle}")
        sim.run(until=done, max_epochs=1000)
        resumed = counts_since(c0)
        if resumed["captures"] != 0:
            raise AssertionError(f"[session-full] the in-place load's resume captured "
                                 f"{resumed['captures']} spans")
        if sim.cycle != stop:
            raise AssertionError(f"[session-full] in-place resume stopped at {sim.cycle}")
        compare(sim.state, final)
        fresh = Simulation(eng).reset(0)
        sync()
        t = time.perf_counter()
        fresh.load(tmp)
        sync()
        load_fresh_s = time.perf_counter() - t
        fresh.run(until=done, max_epochs=1000)
        if fresh.cycle != stop:
            raise AssertionError(f"[session-full] fresh resume stopped at {fresh.cycle}")
        compare(fresh.state, final)
        del fresh
        log(f"[session-full] save at epoch {save_at}: {save_s:.3f} s, {disk} B on disk "
            f"({disk / 2**20:.1f} MiB); load into the running session (in place) "
            f"{load_in_place_s:.3f} s, into a fresh one {load_fresh_s:.3f} s; both "
            f"resume to cycle {stop}, every leaf bit for bit the uninterrupted run's; "
            f"the in-place resume captured 0 spans ({int(resumed['spans'])} replayed)")

        # 3. one warm run(epochs=8), untraced and traced
        walls = [timed_run(epochs=8)[0] for _ in range(3)]
        untraced = clone(sim.state)
        trace_path = os.path.join(tmp, "trace.json")
        assign(sim.state, start)
        sync()
        obs_trace.recorder().clear()
        with sim.trace(trace_path):
            sim.run(epochs=8)
        compare(sim.state, untraced)
        doc = schema.validate_trace_file(trace_path)
        span = [e for e in doc["traceEvents"] if e["name"] == "epoch_window"][-1]
        report.summarize(doc)
        log(f"[session-full] run(epochs=8) warm: untraced wall to the card's end "
            f"{min(walls):.4f}-{max(walls):.4f} s (3 runs); traced epoch_window span "
            f"(host time, to the launches' return) {span['dur'] / 1e6:.4f} s "
            f"(args {span['args']}), state bit for bit the untraced run's; trace valid")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if granule_step.launches <= 0:
        raise AssertionError("[session-full] granule_step launched 0 times")
    log(f"[session-full] granule_step launches in the phase: {granule_step.launches}")


# ---------------------------------------------------------------- the mesh
#: mesh-full's cells: the wafer's pods real (two shards of four batched
#: granules) and the reference example's all-real (pod, gr, gc) mesh
#: (eight shards of one granule), every shard on the one card
#: where the [full] wafer's allreduce stops: (cycle, epoch)
WAFER_STOP = (4352, 68)
MESH_LAYOUTS = {
    "pods": dict(mesh={"pod": 2}, batch_axes={"gr": 2, "gc": 2}),
    "mesh8": dict(mesh={"pod": 2, "gr": 2, "gc": 2}),
}


def mesh_wafer(R, C, k_outer, k_inner, capacity, overlap, device, engine, layout):
    """The wafer torus on 2 pods x 2x2 granules with real mesh axes
    (``MESH_LAYOUTS[layout]``), on ``engine`` (a class), every shard on
    ``device``; the partition and the values are ``wafer_engine``'s."""
    import numpy as np
    from repro_torch.core import ChannelGraph, tiered_grid_partition
    from repro_torch.hw.manycore import ManycoreCell, make_core_params

    values = ((np.arange(R * C, dtype=np.int64) % 8) + 1).astype(np.float32)
    graph = ChannelGraph.torus(
        ManycoreCell(R, C), R, C, params=make_core_params(values.reshape(R, C)),
        capacity=capacity,
    )
    return engine(
        graph, tiered_grid_partition(R, C, [(2, 1), (2, 2)]),
        tiers=[(("pod",), k_outer), (("gr", "gc"), k_inner)], overlap=overlap,
        device=device, **MESH_LAYOUTS[layout],
    ), values


def compare_global(a, b, skip=()) -> float:
    """Every leaf of two engine states in the global layout (a sharded
    state gathered by ``core.mesh.unshard``; tables excluded, floats
    compared as bits, the leading granule dims flattened), but those whose
    path starts with one of ``skip``; raises unless every one is
    bit-exact, else returns the max |diff| over the float leaves."""
    import torch
    from repro_torch.core.mesh import unshard
    from repro_torch.core.struct import tree_paths

    def leaves(st):
        st = unshard(st)
        st = st.replace(tables=None) if hasattr(st, "tables") else st
        return {k: v.cpu() for k, v in tree_paths(st) if not k.startswith(tuple(skip))}

    def bits(x):  # granule dims flattened: (pod, g) and (pod, gr, gc) agree
        x = x.reshape(-1)
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    la, lb = leaves(a), leaves(b)
    if sorted(la) != sorted(lb):
        raise AssertionError(f"leaf sets differ: {sorted(set(la) ^ set(lb))}")
    bad = [k for k, x in la.items() if x.numel() != lb[k].numel()
           or x.dtype != lb[k].dtype or not torch.equal(bits(x), bits(lb[k]))]
    if bad:
        raise AssertionError(f"states differ in {bad}")
    # equal NaNs give NaN, equal infinities NaN: both count as 0
    return max([float((x.reshape(-1) - lb[k].reshape(-1)).abs().nan_to_num(0.0).max())
                for k, x in la.items() if x.is_floating_point() and x.numel()] or [0.0])


def shard_move_bytes(eng) -> int:
    """Bytes an epoch copies between shards: for every exchange class's
    (src, dst) shard pair, its column window of the slab (B rows x cmax x
    E_t x W f32) and of the counts forward and of the credits back, once a
    tier-t exchange, ``cycles_per_epoch / periods[t]`` times an epoch."""
    total = 0
    for t, classes in enumerate(eng.tier_classes):
        n_x = eng.cycles_per_epoch // eng.periods[t]
        for cl in classes:
            per_row = cl.cmax * (eng.E_tiers[t] * eng.W * 4 + 4 + 4)
            total += n_x * len(cl.shard_perm()) * eng.B * per_row
    return total


def trace_shard_moves(eng, state, method: str = "_shard_move") -> dict:
    """One eager epoch of ``state`` (which it advances) under
    ``torch.profiler``, each call of the engine's cross-shard move
    (``_shard_move``; the register engine's ``_pshift``) in a
    ``record_function`` range: the device seconds of the kernels the
    moves launched (their copies, zero fills and landing buffers, read as
    the ranges' device time), the number of moves, and the epoch's device
    busy seconds and wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    move = getattr(eng, method)

    def traced(*args, **kw):
        with record_function("shard_move"):
            return move(*args, **kw)

    setattr(eng, method, traced)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run_epochs(state, 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        delattr(eng, method)
    events = prof.events()
    # the host-side ranges: their device time is the kernels launched in
    # them (the trace's device-side copy of a range spans its gaps too)
    ranges = [e for e in events if e.name == "shard_move" and e.device_type == DeviceType.CPU]
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA]
    busy, reach = 0.0, float("-inf")
    for lo, hi in sorted(device):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    moves_us = sum(getattr(e, "device_time_total", 0.0) for e in ranges)
    return {"moves": len(ranges), "moves_s": moves_us * 1e-6,
            "busy_s": busy * 1e-6 if device else None, "wall": wall}


def moves_line(tm: dict) -> str:
    """``trace_shard_moves``'s numbers, in words."""
    moves = (f"{tm['moves_s'] * 1e3:.4f} ms" if tm["moves_s"] else
             "not measured (the trace gives its ranges no device time)")
    busy = "not measured" if tm["busy_s"] is None else f"{tm['busy_s'] * 1e3:.4f} ms"
    return (f"their device time in a traced eager epoch {moves} (the copies, zero "
            f"fills and landing buffers), of the epoch's {busy} device busy and "
            f"{tm['wall'] * 1e3:.2f} ms wall")


def phase_mesh_small() -> None:
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import Simulation
    from repro_torch.core.distributed import GraphEngine
    from repro_torch.core.fastgrid import RegisterGridEngine
    from repro_torch.core.fused import FusedEngine
    from repro_torch.core.mesh import ShardedState
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.kernels import granule_step
    from repro_torch.kernels import systolic_step as sk

    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    for Engine in (GraphEngine, FusedEngine):
        kind = Engine.engine_kind
        for layout in MESH_LAYOUTS:
            for overlap in (False, True):
                eng, _ = mesh_wafer(32, 32, 2, 4, 4, overlap, "cuda", Engine, layout)
                one, _ = wafer_engine(32, 32, 2, 4, 4, overlap, "cuda", Engine)
                gpu = eng.init(0)
                if not isinstance(gpu, ShardedState) or len(gpu.shards) != eng.G_real:
                    raise AssertionError(f"[mesh-small] {layout}: not {eng.G_real} shards")
                cpu, ref = to_cpu(gpu), one.init(0)
                calls = 0
                for ep in range(10):
                    n0 = granule_step.launches
                    gpu = eng.run_epochs(gpu, 1)
                    calls += granule_step.launches - n0
                    cpu, ref = eng.run_epochs(cpu, 1), one.run_epochs(ref, 1)
                    torch.cuda.synchronize()
                    compare_global(gpu, cpu)
                    # the class layout differs (the coloring is refined per
                    # real shift), so the credit columns do
                    compare_global(gpu, ref, skip=("credits",))
                dev = eng.run_until(eng.init(0), done, 1000)
                host = eng.run_until_host(eng.init(0), done, 1000)
                ref = one.run_until(one.init(0), done, 1000)
                torch.cuda.synchronize()
                compare_global(dev, host)
                compare_global(dev, ref, skip=("credits",))
                cyc = int(dev.cycle.reshape(-1)[0])
                log(f"[mesh-small] {kind} 32x32 {layout} ({eng.G_real} shards of "
                    f"{eng.B} granules on the card) overlap={overlap}: 10 epochs "
                    f"bit-exact against the CPU run of the same engine and, but "
                    f"for the credit columns, the one-shard run"
                    + (f" (granule_step calls an epoch: {calls / 10:g})" if kind == "fused" else "")
                    + f"; run_until stops at cycle {cyc} as the host loop and the "
                    f"one-shard run do, state bit-identical")

    # the register engine: one systolic_step launch a shard an epoch
    M, R, C = 33, 18, 24
    A, B = sys_operands(M, R, C, SYS_SEED)
    for K in (3, 62):
        mesh = RegisterGridEngine.from_graph(sys_graph(A, B), K=K, mesh={"gr": 2, "gc": 2})
        stacked = RegisterGridEngine.from_graph(sys_graph(A, B), K=K, tiles=(2, 2))
        gpu = mesh.init()
        cpu, ref = to_cpu(gpu), stacked.init()
        calls, epochs = 0, 0
        while not mesh.host_done(gpu, mesh.y_done):
            n0 = sk.launches
            gpu = mesh.run_epochs(gpu, 1)
            calls += sk.launches - n0
            cpu, ref = mesh.run_epochs(cpu, 1), stacked.run_epochs(ref, 1)
            epochs += 1
            torch.cuda.synchronize()
            compare_global(gpu, cpu)
            compare_global(gpu, ref)
        if calls != 4 * epochs:
            raise AssertionError(f"[mesh-small] {calls} systolic_step launches for "
                                 f"{epochs} epochs of 4 shards")
        one = RegisterGridEngine.from_graph(sys_graph(A, B), K=K)
        y1 = one.result(one.run_until_done(one.init(), 10_000))
        dev = mesh.run_until_done(mesh.init(), 10_000)
        if not np.array_equal(mesh.result(dev).view(np.uint32), y1.view(np.uint32)):
            raise AssertionError("[mesh-small] the mesh's Y differs from one tile's")
        compare_global(dev, gpu)
        log(f"[mesh-small] register (M, R, C)={(M, R, C)} K={K} on a 2x2 mesh (4 shards "
            f"on the card): {epochs} epochs bit-exact against its CPU run and the "
            f"2x2-stacked one-shard run, one launch a shard an epoch; run_until's Y "
            f"bit-identical to one tile's")

    # a session whose host ports home on shards 3 and 1: traffic, probe,
    # save and load in place, against the CPU and the one-shard session
    part = {"r0": 3, "r1": 2, "r2": 2, "r3": 1}
    tmp = tempfile.mkdtemp()
    try:
        for kind in ("graph", "fused"):
            traces = {}
            for where, dev, kw in (("card", "cuda", {"mesh": {"gx": 4}}),
                                   ("cpu", "cpu", {"mesh": {"gx": 4}}),
                                   ("one-shard", "cuda", {"batch_axes": {"gx": 4}})):
                sim = relay_network(4, 4).build(engine=kind, partition=part, K=1,
                                                device=dev, **kw)
                sim.reset(0)
                traces[where] = (io_script(sim), sim.cycle,
                                 [int(sim.probe(i).fires) for i in range(4)])
                if where == "card":
                    homes = (sim.engine._ext_at(sim.engine.graph.ext_in, "tx")[0],
                             sim.engine._ext_at(sim.engine.graph.ext_out, "rx")[0])
                    ck = sim.save(os.path.join(tmp, kind))
                    sim.run(cycles=5)
                    ptrs = [x.data_ptr() for x in to_leaves(sim.state)]
                    sim.load(os.path.join(tmp, kind))
                    if [x.data_ptr() for x in to_leaves(sim.state)] != ptrs:
                        raise AssertionError("[mesh-small] load moved the shards' tensors")
                    back = io_script(sim)
                    # the same checkpoint resumed by a CPU session
                    twin = relay_network(4, 4).build(engine=kind, partition=part, K=1,
                                                     device="cpu", **kw).reset(0)
                    twin.load(os.path.join(tmp, kind))
                    if not all(np.array_equal(x, y) for x, y in zip(back, io_script(twin))):
                        raise AssertionError("[mesh-small] the resumed traffic differs "
                                             "from the CPU session's resume")
            for where in ("cpu", "one-shard"):
                a, b = traces["card"], traces[where]
                if a[1:] != b[1:] or len(a[0]) != len(b[0]) or not all(
                        np.array_equal(x, y) for x, y in zip(a[0], b[0])):
                    raise AssertionError(f"[mesh-small] {kind} session traffic differs "
                                         f"from the {where} run")
            log(f"[mesh-small] {kind} session on 4 shards, ext-in homed on shard "
                f"{homes[0]}, ext-out on {homes[1]}: {sum(len(t) for t in traces['card'][0])} "
                f"packets back, traffic and probes bit-identical to the CPU and the "
                f"one-shard session; saved ({os.path.basename(ck)}), loaded in place "
                f"(addresses kept), {sum(len(t) for t in back)} more packets, as a CPU "
                f"session resumed from the same checkpoint gives them")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def to_leaves(state) -> list:
    import torch
    from repro_torch.core.struct import tree_leaves

    return [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]


def phase_mesh_full(kernels: list) -> None:
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import Simulation, device_loop
    from repro_torch.core.fastgrid import RegisterGridEngine
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.kernels import granule_step
    from repro_torch.kernels import systolic_step as sk
    from repro_torch.kernels.fused_checks import clone

    R, C = CONFIG.grid_rows, CONFIG.grid_cols
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    launches, errs = {}, {}

    def until(sim, start, tag):
        """The first run from ``start`` (capture included) and a warm
        replay; returns (first counters, warm seconds, warm counters)."""
        assign(sim.state, start)
        torch.cuda.synchronize()
        c0 = until_counts()
        t0 = time.perf_counter()
        sim.run(until=done, max_epochs=1000)
        sim.block_until_ready()
        first = dict(counts_since(c0), wall=time.perf_counter() - t0)
        assign(sim.state, start)
        torch.cuda.synchronize()
        c1 = until_counts()
        t1 = time.perf_counter()
        sim.run(until=done, max_epochs=1000)
        sim.block_until_ready()
        warm_s, warm = time.perf_counter() - t1, counts_since(c1)
        if warm["captures"]:
            raise AssertionError(f"[{tag}] a warm replay captured anew")
        return first, warm_s, warm

    # the all-batch [full] cell in this call: the yardstick of both layouts
    one, values = wafer_engine(R, C, CONFIG.k_outer, CONFIG.k_inner,
                               CONFIG.queue_capacity, False, "cuda")
    sim1 = Simulation(one).reset(0)
    start1 = clone(sim1.state)
    _, warm1_s, warm1 = until(sim1, start1, "mesh-full/all-batch")
    blocks1 = one.gather_group(sim1.state, 0)
    cycles1 = sim1.cycle
    log(f"[mesh-full] all-batch wafer-1M (1 shard of 8 granules): stops at cycle "
        f"{cycles1}; warm until-run {warm1_s:.4f} s, "
        f"{R * C * cycles1 / warm1_s:.4e} core-cycles/s, {int(warm1['syncs'])} host syncs")
    sim1._state = None
    del start1
    gc.collect()
    torch.cuda.empty_cache()

    for layout, cell in (("pods", "wafer-1M-pods"), ("mesh8", "wafer-1M-mesh8")):
        t0 = time.perf_counter()
        eng, _ = mesh_wafer(R, C, CONFIG.k_outer, CONFIG.k_inner, CONFIG.queue_capacity,
                            False, "cuda", FusedEngine, layout)
        sim = Simulation(eng).reset(0)
        sim.block_until_ready()
        setup_s = time.perf_counter() - t0
        start = clone(sim.state)
        log(f"[{cell}] {R}x{C} torus, {eng.G_real} shards of {eng.B} granules on the "
            f"card, tiers K={eng.K_tiers}, resident from tier {eng._resident_from} "
            f"(program {eng._resident_program(eng._resident_from)}); set-up {setup_s:.2f} s")

        # one epoch from the start: every shard's granule_step programs at
        # this cell's shapes against their plain versions, as the same
        # sharded engine runs them on a CPU copy
        t2 = time.perf_counter()
        plain = eng.run_epochs(to_cpu(start), 1)
        plain_s = time.perf_counter() - t2
        kern = eng.run_epochs(clone(start), 1)
        torch.cuda.synchronize()
        errs[cell] = compare_global(kern, plain)
        del plain, kern
        log(f"[{cell}] one epoch bit-exact against the same sharded engine on a CPU "
            f"copy, each shard's programs in their plain version (max |diff| "
            f"{errs[cell]}; the CPU copy took {plain_s:.2f} s)")

        # the main path: Simulation.run(until=allreduce_done) in the device
        # loop, the launch count set to 0 just before and read just after
        granule_step.launches = 0
        c0 = until_counts()
        t1 = time.perf_counter()
        sim.run(until=done, max_epochs=1000)
        sim.block_until_ready()
        first = dict(counts_since(c0), wall=time.perf_counter() - t1)
        launches[cell] = granule_step.launches
        blocks = eng.gather_group(sim.state, 0)
        if (sim.cycle, sim.epoch) != WAFER_STOP:
            raise AssertionError(f"[{cell}] stopped at cycle {sim.cycle} ({sim.epoch} "
                                 f"epochs), not {WAFER_STOP}")
        if not np.array_equal(blocks.total, np.full_like(blocks.total, TOTAL)):
            raise AssertionError(f"[{cell}] allreduce totals {np.unique(blocks.total)[:5]}")
        for name in blocks1._data_fields:
            if not np.array_equal(getattr(blocks, name).view(np.uint8),
                                  getattr(blocks1, name).view(np.uint8)):
                raise AssertionError(f"[{cell}] block state {name} differs from the "
                                     "all-batch run's")
        calls = launches[cell] / (device_loop.SPAN * (first["spans"] + first["captures"]))
        if calls != int(calls) or calls < eng.G_real:
            raise AssertionError(f"[{cell}] {launches[cell]} granule_step calls are not a "
                                 "whole number a gated epoch, one or more a shard")
        log(f"[{cell}] converged: every one of {R * C} cores holds {TOTAL:.0f} after "
            f"{sim.cycle} cycles ({sim.epoch} epochs), every block state bit-identical "
            f"to the all-batch run's; granule_step calls {launches[cell]} ({calls:g} an "
            f"epoch: one program a shard a tier-{eng._resident_from} round), capture "
            f"{first['capture_s']:.4f} s")

        # the device loop against the host loop, a warm replay, and both
        # loops traced over an 8-epoch window
        cycles = sim.cycle
        out = compare_loops(cell, eng, sim, start, done, 1000, first, clone,
                            compare_global, R * C, trace_epochs=8)
        tr = out["dev_trace"]
        log(f"[{cell}] warm until-run {out['warm_s']:.4f} s against the all-batch "
            f"run's {warm1_s:.4f} s in this call ({out['warm_s'] / warm1_s:.2f}x); "
            f"{R * C * cycles / out['warm_s']:.4e} core-cycles/s; "
            f"{int(out['warm_syncs'])} host syncs; capture {first['capture_s']:.4f} s; "
            f"device events a cycle in the traced window "
            f"{tr['events'] / out['traced_cycles']:.1f}; idle share {idle_share(tr)}")

        # the bytes that cross shards an epoch, and their device time in a
        # traced epoch
        assign(sim.state, start)
        nbytes = shard_move_bytes(eng)
        tm = trace_shard_moves(eng, sim.state)
        log(f"[{cell}] cross-shard copies: {nbytes} B an epoch "
            f"({nbytes / (CONFIG.k_inner * CONFIG.k_outer):.0f} B a cycle) in "
            f"{tm['moves']} moves; {moves_line(tm)}")
        sim._state = None
        del start, sim, eng, out
        gc.collect()
        torch.cuda.empty_cache()

    # systolic-1M-mesh: the [sys-full] array on four shards of 512x512
    M, K = SYS_M, SYS_K
    A, B = sys_operands(M, SYS_R, SYS_C, SYS_SEED)
    graph = sys_graph(A, B)
    ref = RegisterGridEngine.from_graph(graph, K=K)
    sim1 = Simulation(ref).reset()
    start1, done1 = clone(sim1.state), ref.y_done
    t0 = time.perf_counter()
    sim1.run(until=done1, max_epochs=1000)
    sim1.block_until_ready()
    first1_s = time.perf_counter() - t0
    Y1, cycles1 = ref.result(sim1.state).copy(), sim1.cycle
    assign(sim1.state, start1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim1.run(until=done1, max_epochs=1000)
    sim1.block_until_ready()
    warm1_s = time.perf_counter() - t1
    sim1._state = None
    del start1
    gc.collect()
    torch.cuda.empty_cache()
    # 2x2 tiles stacked on one shard: the mesh's dynamics (tiles exchange
    # once an epoch), so its stop cycle
    stacked = Simulation(RegisterGridEngine.from_graph(graph, K=K, tiles=(2, 2))).reset()
    stacked.run(until=stacked.engine.y_done, max_epochs=1000)
    Y4, cycles4 = stacked.engine.result(stacked.state), stacked.cycle
    stacked._state = None
    gc.collect()
    torch.cuda.empty_cache()
    if not np.array_equal(Y4.view(np.uint32), Y1.view(np.uint32)):
        raise AssertionError("[systolic-1M-mesh] 2x2 stacked tiles' Y is not one tile's")
    log(f"[systolic-1M-mesh] one tile: Y after {cycles1} cycles, first run "
        f"{first1_s:.4f} s (a capture included), warm {warm1_s:.4f} s; 2x2 tiles "
        f"stacked on one shard: the same Y after {cycles4} cycles")

    eng = RegisterGridEngine.from_graph(graph, K=K, mesh={"gr": 2, "gc": 2})
    sim = Simulation(eng).reset()
    sim.block_until_ready()
    start, done = clone(sim.state), eng.y_done  # one predicate object: one cache key

    # one mid-run epoch (every cell busy): each shard's systolic_step launch
    # at its 512x512 tile against systolic_step_ref on a copy on the card,
    # the cross-shard shifts included
    n0 = (2 * M + SYS_R + SYS_C) // (2 * K)
    mid = eng.run_epochs(clone(start), n0)
    t2 = time.perf_counter()
    plain = eng._join(eng._epoch_all(eng._shards(clone(mid)), step=sk.systolic_step_ref))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t2
    kern = eng._join(eng._epoch_all(eng._shards(mid)))
    torch.cuda.synchronize()
    errs["systolic-1M-mesh"] = compare_global(kern, plain)
    del mid, plain, kern
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[systolic-1M-mesh] epoch {n0 + 1} (cycles {n0 * K}-{(n0 + 1) * K}) of the "
        f"4 shards bit-exact against systolic_step_ref on a copy on the card (max "
        f"|diff| {errs['systolic-1M-mesh']}; the plain epoch took {plain_s:.2f} s)")

    sk.launches = 0
    c0 = until_counts()
    t3 = time.perf_counter()
    sim.run(until=done, max_epochs=1000)
    sim.block_until_ready()
    first = dict(counts_since(c0), wall=time.perf_counter() - t3)
    launches["systolic-1M-mesh"] = sk.launches
    Y = eng.result(sim.state)
    if sim.cycle != cycles4 or not np.array_equal(Y.view(np.uint32), Y1.view(np.uint32)):
        raise AssertionError(f"[systolic-1M-mesh] Y after {sim.cycle} cycles is not the "
                             f"one-tile Y, or the stacked tiles' stop ({cycles4})")
    check_loop_counts("systolic-1M-mesh", "systolic_step", sk.launches // 4, first,
                      sim.epoch)
    cycles, epochs = sim.cycle, sim.epoch
    out = compare_loops("systolic-1M-mesh", eng, sim, start, done, 1000, first,
                        clone, compare_global, SYS_R * SYS_C, ("systolic_window",))
    tr = out["dev_trace"]
    Tr, Tc = eng.Tr, eng.Tc
    # east and south: the slab (K f32) and count forward, the credit back,
    # between the two pairs of neighbouring shards along each axis
    nbytes = 2 * (Tr * K * 4 + Tr * 4 + Tr * 4) + 2 * (Tc * K * 4 + Tc * 4 + Tc * 4)
    assign(sim.state, start)
    tm = trace_shard_moves(eng, sim.state, "_pshift")
    log(f"[systolic-1M-mesh] 4 shards of {Tr}x{Tc}: Y bit-identical to one tile's "
        f"after {cycles} cycles ({epochs} epochs); systolic_step launches "
        f"{launches['systolic-1M-mesh']} (4 an epoch); warm until-run "
        f"{out['warm_s']:.4f} s against one tile's {warm1_s:.4f} s in this call "
        f"({out['warm_s'] / warm1_s:.2f}x); "
        f"{SYS_R * SYS_C * cycles / out['warm_s']:.4e} core-cycles/s; "
        f"{int(out['warm_syncs'])} host syncs; capture {first['capture_s']:.4f} s; "
        f"device events a cycle {tr['events'] / out['traced_cycles']:.2f}; idle share "
        f"{idle_share(tr)}; cross-shard copies {nbytes} B an epoch in "
        f"{tm['moves']} shifts; {moves_line(tm)}")
    sim._state = None
    del start
    gc.collect()
    torch.cuda.empty_cache()
    for cell, n in launches.items():
        log(f"[mesh-full] {cell}: {n} launches on the main path, max |diff| against "
            f"the plain version {errs[cell]}")
    for row, cells in ((kernels[0], ("wafer-1M-pods", "wafer-1M-mesh8")),
                       (kernels[1], ("systolic-1M-mesh",))):
        row["mesh_launches"] = {c: launches[c] for c in cells}
        row["mesh_max_abs_err"] = {c: errs[c] for c in cells}


# ------------------------------------------------------------ procs fleets
PROCS_TIMEOUT = 120.0  # seconds a worker may go silent before it is dead
#: epochs of procs-full's batch_signatures run (a fixed window against
#: GraphEngine's state after as many, not the run to its end: the recover
#: runs took its time)
PROCS_BATCH_EPOCHS = 16
#: the epoch at whose boundary fleet-full's drill kills link 0's proxy
FLEET_KILL_EPOCH = 40
#: shared between procs-full and fleet-full when both run in one call: the
#: GraphEngine yardstick and the single-host fleet's run (fleet-full builds
#: its own when procs-full did not run)
SHARED: dict = {}


def procs_wafer(R, C, k_outer, k_inner, capacity, device, **kw):
    """The wafer torus on the reference example's procs layout: 2 pods x 2
    row strips, ``tiered_grid_partition(R, C, [(2, 1), (2, 1)])`` under a
    ``PartitionTree`` with tiers ``pod`` (K = ``k_outer``) and ``g`` (K =
    ``k_inner``).  ``kw`` goes to ``ProcsEngine``; ``engine="graph"`` in
    it builds ``GraphEngine`` on the same tree instead, its 4 granules
    batched.  Returns (engine, values)."""
    import numpy as np
    from repro_torch.core import ChannelGraph, tiered_grid_partition
    from repro_torch.core.distributed import GraphEngine
    from repro_torch.core.graph import PartitionTree, Tier
    from repro_torch.hw.manycore import ManycoreCell, make_core_params
    from repro_torch.runtime import ProcsEngine

    values = ((np.arange(R * C, dtype=np.int64) % 8) + 1).astype(np.float32)
    graph = ChannelGraph.torus(
        ManycoreCell(R, C), R, C, params=make_core_params(values.reshape(R, C)),
        capacity=capacity,
    )
    ptree = PartitionTree(tiered_grid_partition(R, C, [(2, 1), (2, 1)]),
                          (Tier(axes=("pod",), K=k_outer), Tier(axes=("g",), K=k_inner)),
                          {"pod": 2, "g": 2})
    if kw.pop("engine", None) == "graph":
        return GraphEngine(graph, ptree, batch_axes={"pod": 2, "g": 2},
                           device=device, **kw), values
    return ProcsEngine(graph, ptree, timeout=PROCS_TIMEOUT, device=device, **kw), values


def same_leaves(a, b) -> bool:
    """Two trees of numpy leaves hold the same bits, leaf for leaf."""
    import numpy as np
    from repro_torch.core.struct import tree_paths

    pa, pb = tree_paths(a), tree_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        for (_, x), (_, y) in zip(pa, pb))


def phase_procs_small() -> None:
    """The procs engine on the card, workers on cuda, at small sizes."""
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np
    from repro_torch.core import Simulation
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.hw.pipestage import make_chain
    from repro_torch.hw.systolic import make_systolic_network
    from repro_torch.runtime import WorkerDiedError

    def procs(net, **kw):
        return net.build(engine="procs", device="cuda", timeout=PROCS_TIMEOUT, **kw)

    # host I/O: K = 1, capacity 2, 2 workers; the 4-worker non-zero home
    for tag, n, part, nw in (("chain", 3, [0, 0, 1], 2),
                             ("non-zero home", 4, {"s0": 3, "s1": 2, "s2": 2, "s3": 1}, 4)):
        ref = make_chain(n, capacity=2).build(device="cuda")
        want = io_script(ref.reset(0))
        t0 = time.perf_counter()
        sim = procs(make_chain(n, capacity=2), n_workers=nw, partition=part, K=1)
        try:
            got = io_script(sim.reset(0))
            devices = {r["device"] for r in sim.stats()["workers"]}
        finally:
            sim.engine.close()
        if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"[procs-small] {tag}: traffic differs from the single netlist")
        if not all(d.startswith("cuda") for d in devices):
            raise AssertionError(f"[procs-small] {tag}: workers on {devices}")
        log(f"[procs-small] {tag}: {nw} workers on {sorted(devices)}, "
            f"{sum(len(t) for t in got)} packets over {len(got)} boundaries "
            f"bit-identical to NetworkSim on the card ({time.perf_counter() - t0:.2f} s "
            f"with the fleet's start)")

    # the systolic scenario: run(cycles), save, probe, run(until), load fresh
    rng = np.random.RandomState(3)
    M, K, N = 6, 4, 4
    A, B = rng.randn(M, K).astype(np.float32), rng.randn(K, N).astype(np.float32)
    done = lambda s: ((~s.block_states[0].is_south)  # noqa: E731
                      | (s.block_states[0].y_idx >= M)).all()

    def result_of(sim):
        return np.stack([np.asarray(sim.probe((K - 1) * N + c).y_buf.cpu())
                         for c in range(N)], axis=1)

    ref = make_systolic_network(A, B)[0].build(device="cuda").reset(0)
    ref.run(until=done, max_epochs=100_000)
    want = result_of(ref)
    part = (np.arange(K * N) % 4).tolist()
    ck = tempfile.mkdtemp(prefix="procs_small_")
    try:
        sim = procs(make_systolic_network(A, B)[0], n_workers=4, partition=part, K=4)
        try:
            sim.reset(0).run(cycles=12)
            sim.save(ck)
            a_idx = int(sim.probe(0).a_idx)
            sim.run(until=done, max_epochs=100_000)
            got, stop = result_of(sim), sim.cycle
        finally:
            sim.engine.close()
        sim2 = procs(make_systolic_network(A, B)[0], n_workers=4, partition=part, K=4)
        try:
            sim2.reset(0).load(ck)
            resumed_at = sim2.cycle
            sim2.run(until=done, max_epochs=100_000)
            got2 = result_of(sim2)
        finally:
            sim2.engine.close()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if not (a_idx > 0 and resumed_at == 12 and np.array_equal(got.view(np.uint32), want.view(np.uint32))
            and np.array_equal(got2.view(np.uint32), want.view(np.uint32))):
        raise AssertionError(f"[procs-small] systolic: Y differs (a_idx {a_idx}, "
                             f"resumed at {resumed_at})")
    log(f"[procs-small] systolic 6x4 @ 4x4 on 4 workers: run(cycles=12), save, probe "
        f"(a_idx {a_idx}), run(until) to cycle {stop}, and a fresh fleet's load + "
        f"resume: Y bit-identical to NetworkSim on the card")

    # the 32x32 wafer on 4 workers against GraphEngine on the same tree
    geng, values = procs_wafer(32, 32, 2, 4, 4, "cuda", engine="graph")
    wafer_done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    gsim = Simulation(geng).reset(0)
    gsim.run(until=wafer_done, max_epochs=1000)
    want_blocks, want_stop = geng.gather_group(gsim.state, 0), gsim.cycle
    del gsim, geng
    for batch, overlap in ((False, False), (True, True)):
        eng, _ = procs_wafer(32, 32, 2, 4, 4, "cuda", batch_signatures=batch,
                             overlap=overlap)
        try:
            sim = Simulation(eng).reset(0)
            sim.run(until=wafer_done, max_epochs=1000)
            blocks, stop = eng.gather_group(sim.state, 0), sim.cycle
        finally:
            eng.close()
        if stop != want_stop or not same_leaves(want_blocks, blocks):
            raise AssertionError(f"[procs-small] wafer 32x32 batch={batch} overlap={overlap}:"
                                 f" stop {stop} (GraphEngine {want_stop}) or blocks differ")
        log(f"[procs-small] wafer 32x32 on {eng.NW} workers (batch_signatures={batch}, "
            f"overlap={overlap}): stop cycle {stop} and every block bit-identical to "
            f"GraphEngine on the same PartitionTree on the card")

    # self-healing drills, the reference's _drill scenario
    fault_drills()

    # SIGKILL of one worker: WorkerDiedError naming it, with its log tail
    sim = procs(make_chain(3, capacity=4), n_workers=3, partition=[0, 1, 2], K=1)
    sim.reset(0).tx("tx").send([1.0, 0.0])
    sim.run(cycles=4)
    os.kill(sim.engine._procs[1].pid, signal.SIGKILL)
    t0 = time.monotonic()
    try:
        sim.run(cycles=200)
    except WorkerDiedError as e:
        waited = time.monotonic() - t0
        if e.worker != 1 or "granule 1" not in str(e) or not sim.engine._closed:
            raise AssertionError(f"[procs-small] kill: wrong diagnosis {e}") from e
        if waited > PROCS_TIMEOUT:
            raise AssertionError(f"[procs-small] kill: raised after {waited:.1f} s") from e
        log(f"[procs-small] SIGKILL of worker 1: WorkerDiedError after {waited:.2f} s "
            f"naming it, its log tail holding 'granule 1'; the fleet torn down")
    else:
        raise AssertionError("[procs-small] a killed worker went unnoticed")
    finally:
        sim.engine.close()


def watch_incarnations(eng) -> dict:
    """Spy on ``eng``'s teardowns and recovery respawns.  At each ``close``
    of a live fleet: its wall-clock start, its seconds and every worker's
    log tail (read before the teardown).  At each ``_reopen``: the worker
    processes and ring prefix of the incarnation it replaces, and its
    seconds (rings, spawn, every worker ready with its captures).  At each
    run command and each recovery snapshot: its epoch, its seconds and the
    incarnation that ran it."""
    from repro_torch.runtime.fault_tolerance import read_log_tail

    seen: dict = {"close": [], "reopen": [], "commands": [], "snapshots": []}
    close, reopen, raw = eng.close, eng._reopen, eng._run_epochs_raw
    take = eng._recovery._take_snapshot

    def timed(key, fn, state, *args):
        epoch, t0 = int(state.epoch), time.perf_counter()
        out = fn(state, *args)
        seen[key].append({"epoch": epoch, "n": args[0] if args else 0,
                          "seconds": time.perf_counter() - t0,
                          "incarnation": eng._incarnation})
        return out

    def close_spy():
        if eng._closed:
            return close()
        paths = eng._monitor.log_paths if eng._monitor is not None else {}
        logs = {w: read_log_tail(p, max_bytes=8192) for w, p in paths.items()}
        # the fleet's other members: bridges, follower launchers and what
        # each follower reported (its processes and ring prefix), and the
        # ports its listeners held
        members = {"procs": [*eng._procs.values(), *eng._bridge_procs.values(),
                             *eng._follower_procs.values()],
                   "hello": {h: dict(v) for h, v in eng._follower_hello.items()},
                   "ports": [*eng._accept_ports.values(),
                             *([eng._ctl_listener.getsockname()[1]]
                               if eng._ctl_listener is not None else [])],
                   "prefix": eng._ring_prefix}
        at, t0 = time.time(), time.perf_counter()
        close()
        seen["close"].append({"at": at, "seconds": time.perf_counter() - t0,
                              "logs": logs, **members})

    def reopen_spy():
        seen["reopen"].append({"procs": list(eng._procs.values()),
                               "prefix": eng._ring_prefix})
        t0 = time.perf_counter()
        reopen()
        seen["reopen"][-1]["seconds"] = time.perf_counter() - t0

    eng.close, eng._reopen = close_spy, reopen_spy
    eng._run_epochs_raw = lambda state, n: timed("commands", raw, state, n)
    eng._recovery._take_snapshot = lambda state: timed("snapshots", take, state)
    return seen


def leftovers_line(tag: str, closes: list, reopens: list) -> str:
    """No process of the fleets torn down in ``closes`` (workers in
    ``reopens``; bridges, follower launchers and the processes each
    follower reported) alive, none of their shared-memory segments in
    ``/dev/shm`` (the leader's ring prefix and each follower's) and none
    of their listening ports still listening."""
    import os

    procs = {p.pid: p for p in [*(p for r in reopens for p in r["procs"]),
                                *(p for c in closes for p in c["procs"])]}
    pids = [pid for c in closes for h in c["hello"].values() for pid in h.get("pids", ())]
    alive = [p.pid for p in procs.values() if p.is_alive()] + [p for p in pids
                                                               if pid_alive(p)]
    prefixes = ([r["prefix"] for r in reopens] + [c["prefix"] for c in closes]
                + [h["prefix"] for c in closes for h in c["hello"].values()])
    segs = [f for f in os.listdir("/dev/shm") if f.startswith(tuple(prefixes))]
    ports = sorted({p for c in closes for p in c["ports"]} & listening_ports())
    if alive or segs or ports:
        raise AssertionError(f"[{tag}] earlier incarnation left processes {alive}, "
                             f"segments {segs[:5]} and listening ports {ports}")
    teardown = ", ".join(f"{c['seconds']:.2f}" for c in closes)
    n_ports = len({p for c in closes for p in c["ports"]})
    return (f"{len(procs) + len(pids)} processes of {max(len(closes), len(reopens))} "
            f"earlier incarnation(s) gone (teardown {teardown} s), none of their "
            f"segments in /dev/shm, none of their {n_ports} ports listening")


def check_no_leftovers(tag: str, seen: dict) -> str:
    """No worker, bridge or follower process of an earlier incarnation
    alive, none of its shared-memory segments left in ``/dev/shm``, none
    of its listening sockets open — on either host of a bridged fleet."""
    gone = seen["reopen"]
    return leftovers_line(tag, seen["close"][:len(gone)], gone)


def recovery_split(seen: dict, last: dict) -> dict:
    """The seconds of one recovery from the spies of ``watch_incarnations``
    and the controller's ``last_recovery``: ``teardown`` (the faulted
    fleet's ``close``), ``respawn`` (``_reopen``) and ``restore``
    (``scatter_state``: the controller's restore seconds less its backoff
    and the respawn)."""
    teardown, respawn = seen["close"][0]["seconds"], seen["reopen"][0]["seconds"]
    return {"teardown": teardown, "respawn": respawn,
            "restore": last["restore_seconds"] - last["backoff_s"] - respawn}


def fault_drills() -> None:
    """The reference's recovery drill (``tests/test_recovery.py``'s
    ``_drill``: a 3-stage chain on 2 workers, K = 1, ``snapshot_every=2``,
    ``backoff_s=0``), every worker on the card: kill, clean exit and
    corruption healed bit-identical to a fault-free fleet, corruption
    raising under ``raise``, a hung worker healed; no process or segment of
    an earlier incarnation left."""
    import numpy as np
    from repro_torch.hw.pipestage import make_chain
    from repro_torch.obs.registry import REGISTRY
    from repro_torch.runtime import RingCorruptionError

    def fleet(**kw):
        kw.setdefault("timeout", PROCS_TIMEOUT)
        return make_chain(3, capacity=4).build(
            engine="procs", device="cuda", n_workers=2, partition=[0, 0, 1], K=1, **kw)

    def run(sim):
        try:
            trace = io_script(sim.reset(0))
            return trace, sim.engine.gather_state(sim.state), sim.engine.fault_stats()
        finally:
            sim.engine.close()

    want, want_tree, _ = run(fleet())
    recover = dict(on_fault="recover", snapshot_every=2, backoff_s=0.0)
    for plan, fault, kw in (("kill:1@5", "WorkerDiedError", {}),
                            ("exit0:1@3", "WorkerDiedError", {}),
                            ("corrupt:0@3", "RingCorruptionError", {}),
                            ("hang:1@3", "WorkerDiedError", dict(timeout=8.0))):
        sim = fleet(fault_plan=plan, **recover, **kw)
        seen = watch_incarnations(sim.engine)
        killed = REGISTRY.counters().get("procs.close.killed", 0.0)
        t0 = time.perf_counter()
        got, tree, faults = run(sim)
        wall = time.perf_counter() - t0
        killed = REGISTRY.counters().get("procs.close.killed", 0.0) - killed
        last = faults["last_recovery"] or {}
        if not (len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(want, got))
                and same_leaves(want_tree, tree)):
            raise AssertionError(f"[procs-small] drill {plan}: traffic or state differs")
        if faults["restarts"] != 1 or last.get("fault") != fault:
            raise AssertionError(f"[procs-small] drill {plan}: {faults}")
        left = check_no_leftovers(plan, seen)
        split = recovery_split(seen, last)
        log(f"[procs-small] drill {plan} under recover: {fault} healed, host trace and "
            f"gather_state bit-identical to the fault-free fleet; restarts 1, "
            f"incarnation {faults['incarnation']}, restored epoch "
            f"{last['restored_epoch']}, respawn {split['respawn']:.2f} s, "
            f"restore {split['restore']:.3f} s, {faults['snapshots']} snapshots; "
            f"{wall:.2f} s in all; {left}; workers killed after SIGTERM failed: "
            f"{killed:.0f}")
    sim = fleet(fault_plan="corrupt:0@3")
    try:
        sim.reset(0)
        sim.run(cycles=8 * sim.period)
    except RingCorruptionError as e:
        log(f"[procs-small] drill corrupt:0@3 under raise: RingCorruptionError ({e})")
    else:
        raise AssertionError("[procs-small] corrupt under raise did not raise")
    finally:
        sim.engine.close()


def log_fleet_trace(tag: str, prof: dict) -> None:
    """Log a fleet's traced window (``ProcsEngine.profile_epochs``): each
    worker's device-busy seconds and the card's idle share."""
    busy = [p["busy_s"] for p in prof.values()]
    if any(b is None for b in busy):
        log(f"[procs-full] {tag}: device idle share not measured (a worker's "
            f"trace holds no device event)")
        return
    wall = max(p["wall_s"] for p in prof.values())
    own = ", ".join(f"{1 - b / p['wall_s']:.4f}" for b, p in zip(busy, prof.values()))
    log(f"[procs-full] {tag}: traced 2 epochs on every worker: wall {wall:.3f} s; "
        f"device busy by worker {', '.join(f'{b:.3f}' for b in busy)} s; the card's "
        f"idle share {1 - sum(busy) / wall:.4f} (the workers time-slice it, so their "
        f"busy seconds add); each worker's own {own}")


def graph_yardstick(args, done, tag: str) -> None:
    """GraphEngine on the procs layout's PartitionTree, one process: its
    stop and blocks after ``run(until=allreduce_done)`` and after
    ``PROCS_BATCH_EPOCHS`` epochs, and its until-run's seconds, into
    ``SHARED["graph"]``."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import Simulation

    t0 = time.perf_counter()
    geng, _ = procs_wafer(*args, engine="graph")
    gsim = Simulation(geng).reset(0)
    gsim.block_until_ready()
    gsetup = time.perf_counter() - t0
    t1 = time.perf_counter()
    gsim.run(until=done, max_epochs=1000)
    gsim.block_until_ready()
    gwall = time.perf_counter() - t1
    want, want_stop = geng.gather_group(gsim.state, 0), gsim.cycle
    if not np.array_equal(want.total, np.full_like(want.total, TOTAL)):
        raise AssertionError(f"[{tag}] GraphEngine's totals are not the global sum")
    log(f"[{tag}] yardstick GraphEngine on the same PartitionTree (4 granules "
        f"batched, one process): stop cycle {want_stop}, set-up {gsetup:.2f} s, until-run "
        f"{gwall:.3f} s (its span capture included)")
    gsim.reset(0).run(epochs=PROCS_BATCH_EPOCHS)  # the batch_signatures run's yardstick
    SHARED["graph"] = {"want": want, "want_stop": want_stop, "gwall": gwall,
                       "want_cut": geng.gather_group(gsim.state, 0)}
    gsim._state = None
    del gsim, geng
    gc.collect()
    torch.cuda.empty_cache()


def single_host_done(eng, sim, done, want, want_stop, run_s: float, tag: str) -> None:
    """The single-host wafer-1M-procs4 fleet at its stop after a warm
    untraced until-run of ``run_s`` seconds: its ``gather_state`` (the
    2-host fleet's yardstick), then the same run traced
    (``telemetry_run``), into ``SHARED["procs4"]``."""
    tree = eng.gather_state(sim.state)
    tel = telemetry_run(tag, eng, sim, done, want, want_stop, run_s)
    SHARED["procs4"] = {"run_s": run_s, "tree": tree, **tel}


def phase_procs_full() -> None:
    """wafer-1M-procs4: the full wafer on 4 worker processes on the card,
    plain and with batch_signatures, against GraphEngine on the same tree."""
    import gc

    import numpy as np
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import Simulation
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.core.struct import tree_leaves

    R, C = CONFIG.grid_rows, CONFIG.grid_cols
    args = (R, C, CONFIG.k_outer, CONFIG.k_inner, CONFIG.queue_capacity, "cuda")
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731

    # the yardstick: GraphEngine on the same PartitionTree, one process
    graph_yardstick(args, done, "procs-full")
    want, want_stop, gwall, want_cut = (
        SHARED["graph"][k] for k in ("want", "want_stop", "gwall", "want_cut"))

    for batch in (False, True):
        tag = "batch_signatures" if batch else "plain"
        t0 = time.perf_counter()
        eng, _ = procs_wafer(*args, batch_signatures=batch)
        build_s = time.perf_counter() - t0
        try:
            t1 = time.perf_counter()
            eng.launch()
            launch_s = time.perf_counter() - t1
            ls = eng.launch_stats
            ready = max(ls["ready_seconds"].values())
            caps = [b["capture_s"] for b in ls["build"].values()]
            pre = [b["seconds"] for b in ls["build"].values()]
            own = [b["setup_s"] for b in ls["build"].values()]
            n_chan = sum(len(c) for c in eng.lowering.routes.values())
            log(f"[procs-full] wafer-1M-procs4 ({tag}): {eng.G} granules of "
                f"{R * C // eng.G} cores on {eng.NW} worker processes, "
                f"{eng.build_stats['n_signatures']} signatures {eng._worker_members}, "
                f"n_local {eng.n_local}; set-up: lowering {eng.lowering_seconds:.2f} s, "
                f"prebuild {eng.build_stats['prebuild_seconds']:.2f} s (the rest of the "
                f"constructor {build_s - eng.lowering_seconds - eng.build_stats['prebuild_seconds']:.2f} s), "
                f"rings {ls['rings_seconds']:.2f} s, spawn {ls['spawn_seconds']:.2f} s, "
                f"workers ready after {ready:.2f} s (start, CUDA, template, capture "
                f"{', '.join(f'{c:.2f}' for c in caps)} s; of it the spawn to each "
                f"worker's entry {', '.join(f'{c:.2f}' for c in ls['entry_seconds'].values())}"
                f" s, each worker's own "
                f"set-up (spec, device context, state, rings) "
                f"{', '.join(f'{c:.2f}' for c in own)} s and template and captures "
                f"{', '.join(f'{c:.2f}' for c in pre)} s); launch {launch_s:.2f} s")
            log(f"[procs-full] {tag}: {ls['n_rings']} rings for {n_chan} boundary channels "
                f"(a slab and a credit ring each, plus {len(eng.graph.ext_ports())} host "
                f"ports), {ls['shm_bytes']} B of shared memory mapped "
                f"({ls['shm_pages'] * 4096} B in whole 4 KiB pages)")
            t2 = time.perf_counter()
            sim = Simulation(eng).reset(0)
            init_s = time.perf_counter() - t2
            if not batch:  # a traced window of 2 epochs, then the run anew
                log_fleet_trace(tag, eng.profile_epochs(sim.state, 2)[1])
            t3 = time.perf_counter()
            sim.reset(0)
            reinit_s = time.perf_counter() - t3
            view_bytes = sum(x.nbytes for v in eng._views()
                             for x in tree_leaves(v.replace(tables=None)))
            t4 = time.perf_counter()
            if batch:  # a fixed window, to keep the script inside its time
                sim.run(epochs=PROCS_BATCH_EPOCHS)
            else:
                sim.run(until=done, max_epochs=1000)
            run_s = time.perf_counter() - t4
            stop, epochs = sim.cycle, sim.epoch
            rows = eng.worker_stats(sim.state)
            blocks = eng.gather_group(sim.state, 0)
            if not batch:  # traced again, then under recover, fault-free
                single_host_done(eng, sim, done, want, want_stop, run_s, "procs-full")
                eng.on_fault = "recover"
                recover = recover_epochs(eng, sim, want, want_stop, "procs-full")
        finally:
            eng.close()
        if batch:
            if epochs != PROCS_BATCH_EPOCHS or not same_leaves(want_cut, blocks):
                raise AssertionError(f"[procs-full] {tag}: blocks after {epochs} epochs "
                                     "differ from GraphEngine's")
        elif stop != want_stop:
            raise AssertionError(f"[procs-full] {tag}: stop {stop} != GraphEngine's {want_stop}")
        elif not same_leaves(want, blocks):
            raise AssertionError(f"[procs-full] {tag}: blocks differ from GraphEngine's")
        elif not np.array_equal(blocks.total, np.full_like(blocks.total, TOTAL)):
            raise AssertionError(f"[procs-full] {tag}: totals are not the global sum")
        if not all(r["device"].startswith("cuda") for r in rows):
            raise AssertionError(f"[procs-full] {tag}: a worker ran off the card")
        # a batched worker reports its process's counters on each of its rows
        per_worker = {eng._worker_of[r["granule"]]: r for r in rows}
        ops = sum(r["ring_ops"] for r in per_worker.values())
        if batch:
            log(f"[procs-full] {tag}: {epochs} epochs ({stop} cycles), every block "
                f"bit-identical to GraphEngine's after as many; init {init_s:.2f} s (again "
                f"{reinit_s:.2f} s); run(epochs={epochs}) {run_s:.3f} s = "
                f"{R * C * stop / run_s:.4e} core-cycles/s; {ops / epochs:.0f} ring ops "
                f"an epoch")
        else:
            log(f"[procs-full] {tag}: converged at cycle {stop} ({epochs} epochs), every "
                f"block bit-identical to GraphEngine's and every total {TOTAL:.0f}; init "
                f"{init_s:.2f} s (again {reinit_s:.2f} s); run(until) {run_s:.3f} s = "
                f"{R * C * stop / run_s:.4e} core-cycles/s ({run_s / gwall:.1f}x "
                f"GraphEngine's {gwall:.3f} s in this call); {ops / epochs:.0f} ring ops "
                f"and {view_bytes} B of view an epoch")
        for w, r in sorted(per_worker.items()):
            busy = r["run_s"] - r["wait_s"]
            log(f"[procs-full] {tag}: worker {w} (granules {eng._worker_members[w]}) on "
                f"{r['device']}: run "
                f"{r['run_s']:.3f} s, busy {busy:.3f} s, ring wait {r['wait_s']:.3f} s "
                f"(share {r['wait_fraction']:.4f}), capture {r['capture_s']:.3f} s, "
                f"{r['ring_ops']} ring ops")
        gc.collect()
        if not batch:  # a kill drill on a fresh fleet, epochs-run
            kill_drill(args, want, want_stop, recover)
            gc.collect()


def snapshot_seconds():
    """The count and the seconds of the recovery snapshots taken so far in
    this process (the ``recovery.snapshot.s`` histogram)."""
    from repro_torch.obs.registry import REGISTRY

    snap = REGISTRY.histogram("recovery.snapshot.s").summary()
    return snap["count"], snap["sum"]


def recover_epochs(eng, sim, want, want_stop, tag: str) -> dict:
    """The fleet again under ``on_fault="recover"``, no fault, by
    ``run(epochs=67)`` (a snapshot at entry and at every 16th epoch),
    ending at ``GraphEngine``'s stop with its blocks; logs the run's
    seconds and the snapshots' count, seconds and bytes.  Returns the
    run's seconds, snapshots, snapshot seconds and epochs (the kill
    drill's yardstick)."""
    from repro_torch.core.struct import tree_leaves

    sim.reset(0)
    n0, s0 = snapshot_seconds()
    t0 = time.perf_counter()
    sim.run(epochs=want_stop // sim.period)
    run_s = time.perf_counter() - t0
    n1, s1 = snapshot_seconds()
    stats = eng.fault_stats()
    if sim.cycle != want_stop or not same_leaves(want, eng.gather_group(sim.state, 0)):
        raise AssertionError(f"[{tag}] recover epochs: stop {sim.cycle} or blocks differ")
    nbytes = sum(x.nbytes for x in tree_leaves(eng._recovery._snapshot))
    log(f"[{tag}] under on_fault=recover, no fault: run(epochs={sim.epoch}) "
        f"{run_s:.3f} s, stop cycle {sim.cycle}, blocks bit-identical to GraphEngine's; "
        f"{n1 - n0} snapshots (snapshot_every {stats['snapshot_every']}, last at epoch "
        f"{stats['last_snapshot_epoch']}): {s1 - s0:.3f} s, {nbytes} B a snapshot")
    return {"run_s": run_s, "snapshots": n1 - n0, "snapshot_s": s1 - s0,
            "epochs": sim.epoch}


def kill_drill(args, want, want_stop, clean: dict) -> None:
    """wafer-1M-procs4 under ``on_fault="recover"`` with ``kill:1@40`` on a
    fresh fleet, run to ``GraphEngine``'s stop by ``run(epochs=67)``
    (snapshots every 16 epochs, so the epochs since epoch 32 are
    replayed): the stop and every block as ``GraphEngine``'s, and MTTR (the
    faulted run's seconds less the fault-free recover run's, the drill's
    fleet warmed first by 16 epochs as that run's fleet is warm) split
    into detect (the
    kill, stamped in the worker's log, to the faulted fleet's teardown),
    teardown, backoff, respawn (``_reopen``: rings, spawn, workers ready
    with their captures), restore (``scatter_state``), replay (the epochs
    replayed at the fault-free run's seconds an epoch less its snapshots)
    and the snapshots' excess over the fault-free run's."""
    import re
    import statistics

    import numpy as np

    from repro_torch.core import Simulation
    from repro_torch.obs.registry import REGISTRY

    killed = REGISTRY.counters().get("procs.close.killed", 0.0)
    t0 = time.perf_counter()
    eng, _ = procs_wafer(*args, on_fault="recover", fault_plan="kill:1@40")
    seen = watch_incarnations(eng)
    try:
        sim = Simulation(eng).reset(0)
        setup_s = time.perf_counter() - t0
        # warm the fresh fleet (its first snapshot and first epochs), as the
        # fault-free runs' fleet is warm, then start again at epoch 0
        t0 = time.perf_counter()
        sim.run(epochs=16)
        sim.reset(0)
        warm_s = time.perf_counter() - t0
        seen["commands"].clear()
        seen["snapshots"].clear()
        n0, s0 = snapshot_seconds()
        t1 = time.perf_counter()
        sim.run(epochs=want_stop // sim.period)
        run_s = time.perf_counter() - t1
        n1, s1 = snapshot_seconds()
        stop, epochs = sim.cycle, sim.epoch
        blocks = eng.gather_group(sim.state, 0)
        stats = eng.fault_stats()
        ready = max(eng.launch_stats["ready_seconds"].values())
        caps = [b["capture_s"] for b in eng.launch_stats["build"].values()]
        own = [b["setup_s"] for b in eng.launch_stats["build"].values()]
    finally:
        eng.close()
    killed = REGISTRY.counters().get("procs.close.killed", 0.0) - killed
    tag = "kill:1@40 under recover, run(epochs)"
    if stop != want_stop or not same_leaves(want, blocks):
        raise AssertionError(f"[procs-full] {tag}: stop {stop} (GraphEngine "
                             f"{want_stop}) or blocks differ")
    if not np.array_equal(blocks.total, np.full_like(blocks.total, TOTAL)):
        raise AssertionError(f"[procs-full] {tag}: totals are not the global sum")
    last = stats["last_recovery"]
    m = re.search(r"\[faultinject\] epoch (\d+) at t=([0-9.]+)",
                  seen["close"][0]["logs"].get(1, ""))
    if stats["restarts"] != 1 or last["fault"] != "WorkerDiedError" or m is None:
        raise AssertionError(f"[procs-full] {tag}: {stats}")
    left = check_no_leftovers(f"procs-full {tag}", seen)
    split = recovery_split(seen, last)
    detect = seen["close"][0]["at"] - float(m.group(2))
    ref = clean
    mttr = run_s - ref["run_s"]
    # the kill fires before its epoch runs: the epochs from the restored
    # snapshot up to it run again (the controller counts as "confirmed"
    # only those before the command that faulted)
    n_replay = int(m.group(1)) - last["restored_epoch"]
    per_epoch = (ref["run_s"] - ref["snapshot_s"]) / ref["epochs"]
    replay = n_replay * per_epoch
    snap_extra = (s1 - s0) - ref["snapshot_s"]
    # the first command after the respawn against the run's median seconds
    # an epoch before it, and the snapshots' seconds before and after it
    before = [c for c in seen["commands"] if c["incarnation"] == 0 and c["n"]]
    rate = statistics.median(c["seconds"] / c["n"] for c in before)
    first = next(c for c in seen["commands"] if c["incarnation"] == 1)
    first_extra = first["seconds"] - first["n"] * rate
    snaps = [[c["seconds"] for c in seen["snapshots"] if c["incarnation"] == i and c["epoch"]]
             for i in (0, 1)]
    rest = (mttr - detect - split["teardown"] - last["backoff_s"] - split["respawn"]
            - split["restore"] - replay - snap_extra - first_extra)
    log(f"[procs-full] {tag}: WorkerDiedError healed, stop cycle {stop} ({epochs} "
        f"epochs) and every block bit-identical to GraphEngine's, every total "
        f"{TOTAL:.0f}; restored epoch {last['restored_epoch']}, {n_replay} epochs "
        f"replayed ({last['confirmed_epochs_replayed']} confirmed), {n1 - n0} "
        f"snapshots in the run; {left}; workers killed after "
        f"SIGTERM failed: {killed:.0f}; set-up {setup_s:.2f} s, warm-up (16 epochs) "
        f"{warm_s:.2f} s")
    log(f"[procs-full] {tag}: MTTR {mttr:.3f} s (the run {run_s:.3f} s less the "
        f"fault-free recover run's {ref['run_s']:.3f} s): detect {detect:.3f} s (the "
        f"kill at epoch {m.group(1)} to the teardown), teardown "
        f"{split['teardown']:.3f} s, backoff {last['backoff_s']:.3f} s, respawn "
        f"{split['respawn']:.3f} s (workers ready after {ready:.2f} s, their own set-up "
        f"{', '.join(f'{c:.2f}' for c in own)} s, captures "
        f"{', '.join(f'{c:.2f}' for c in caps)} s), restore {split['restore']:.3f} s, "
        f"replay {replay:.3f} s ({n_replay} epochs at the fault-free run's "
        f"{per_epoch:.4f} s an epoch less its snapshots), snapshots {snap_extra:.3f} s "
        f"more than the fault-free run's ({n1 - n0} taken in {s1 - s0:.3f} s against "
        f"{ref['snapshots']} in {ref['snapshot_s']:.3f} s; this run's before the respawn "
        f"{statistics.mean(snaps[0]) if snaps[0] else float('nan'):.4f} s each, after it "
        f"{', '.join(f'{x:.4f}' for x in snaps[1][:4])}{' ...' if len(snaps[1]) > 4 else ''} "
        f"s), the first command after the respawn ({first['n']} epochs from epoch "
        f"{first['epoch']}) {first_extra:.3f} s over the run's median {rate:.4f} s an "
        f"epoch before it ({first['seconds']:.3f} s), the rest {rest:.3f} s")


# ------------------------------------------------------------ multi-host fleets
def listening_ports() -> set:
    """The TCP ports in LISTEN state on this machine (``/proc/net/tcp``)."""
    out = set()
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                next(f)
                for line in f:
                    parts = line.split()
                    if parts[3] == "0A":
                        out.add(int(parts[1].rsplit(":", 1)[1], 16))
        except OSError:
            pass
    return out


def pid_alive(pid: int) -> bool:
    """``pid`` is a live process (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def chain_run(traced_path=None, keep: bool = False, **kw):
    """``io_script`` on a 4-stage PipeStage chain at capacity 2, one worker
    a stage on the card, K = 1 (``tests/test_bridge.py``'s chain, one stage
    longer so each host holds two workers), and the final
    ``gather_state``.  With ``traced_path`` the fleet runs the script once
    untraced, then again inside ``sim.trace(traced_path)``.  With ``keep``
    the fleet stays open (``facts["sim"]``).  Returns (trace, tree, engine
    facts, traced trace or None); the facts hold each recovery's
    ``last_recovery`` record in order (``"recoveries"``)."""
    from repro_torch.hw.pipestage import make_chain
    from repro_torch.obs import schema

    sim = make_chain(4, capacity=2).build(
        engine="procs", device="cuda", n_workers=4, partition=[0, 1, 2, 3], K=1,
        timeout=PROCS_TIMEOUT, **kw)
    eng = sim.engine
    seen = watch_incarnations(eng)
    recoveries = []
    recover = eng._recovery._recover

    def recover_spy(fault, state):
        out = recover(fault, state)
        recoveries.append(eng.fault_stats()["last_recovery"])
        return out

    eng._recovery._recover = recover_spy
    try:
        trace = io_script(sim.reset(0))
        tree = eng.gather_state(sim.state)
        facts = {"hosts": {h: r.get("cuda_initialized")
                           for h, r in eng.launch_stats.get("hosts", {}).items()},
                 "devices": sorted({r["device"] for r in eng.worker_stats()}),
                 "faults": eng.fault_stats(), "seen": seen, "recoveries": recoveries}
        traced = None
        if traced_path is not None:
            with sim.trace(traced_path):
                traced = io_script(sim.reset(0))
            facts["stats"] = schema.validate_stats(sim.stats())
    except BaseException:
        eng.close()
        raise
    if keep:
        facts["sim"] = sim
    else:
        eng.close()
    return trace, tree, facts, traced


def same_traffic(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def arm_link_fault(eng, plan: str) -> None:
    """Arm ``plan``'s link faults on a running fleet: a link fault is the
    launcher's to fire at a command boundary, so no process needs it at
    spawn (the fleet's incarnation must be the plan's)."""
    from repro_torch.runtime.faultinject import parse_fault_plan, split_plan

    eng.fault_plan = parse_fault_plan(plan)
    eng._link_faults = split_plan(eng.fault_plan)[1]
    eng._fired_links = set()


def raise_drill(sim, plan: str, exc, tag: str) -> None:
    """``plan`` armed on the live fleet of ``sim`` under ``on_fault="raise"``:
    the run must raise ``exc``, and nothing of the fleet may be left."""
    eng = sim.engine
    arm_link_fault(eng, plan)
    seen = watch_incarnations(eng)
    try:
        sim.reset(0)
        sim.run(cycles=(eng._link_faults[0].epoch + 8) * sim.period)
    except exc as e:
        msg = f"{type(e).__name__} ({str(e).splitlines()[0]})"
    else:
        raise AssertionError(f"[{tag}] {plan} under raise did not raise")
    finally:
        eng.close()
    log(f"[{tag}] drill {plan} under raise on that fleet: {msg}; "
        f"{leftovers_line(f'raise {plan}', seen['close'], [])}")


def phase_fleet_small() -> None:
    """Multi-host fleets on the card at small sizes, the scenarios of
    ``tests/test_bridge.py`` on ``hosts=2``."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.hw.pipestage import make_chain
    from repro_torch.hw.systolic import make_systolic_network
    from repro_torch.obs import drift, schema
    from repro_torch.obs.registry import REGISTRY
    from repro_torch.runtime import LinkDownError, RingCorruptionError

    tmp = tempfile.mkdtemp(prefix="fleet_small_")
    try:
        # the 4-stage chain under host I/O at capacity 2: NetworkSim, hosts=1
        # and hosts=2 (cycle-accurate), then the same 2-host fleet traced,
        # then a link kill armed on it under raise
        ref = make_chain(4, capacity=2).build(device="cuda")
        want_ns = io_script(ref.reset(0))
        t0 = time.perf_counter()
        want, want_tree, _f, _t = chain_run()
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = os.path.join(tmp, "fleet.json")
        got, tree, facts, traced = chain_run(traced_path=path, keep=True, hosts=2)
        sim = facts["sim"]
        two_s = time.perf_counter() - t0
        try:
            if not (same_traffic(want_ns, want) and same_traffic(want, got)
                    and same_leaves(want_tree, tree)):
                raise AssertionError("[fleet-small] chain: hosts=2, hosts=1 and NetworkSim "
                                     "differ")
            if facts["hosts"] != {"h1": False} or not all(
                    d.startswith("cuda") for d in facts["devices"]):
                raise AssertionError(f"[fleet-small] chain: follower CUDA state "
                                     f"{facts['hosts']}, workers on {facts['devices']}")
            if not same_traffic(want, traced):
                raise AssertionError("[fleet-small] traced chain: traffic differs")
            st = facts["stats"]
            doc = schema.validate_trace_file(path)
            tracks = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") == "worker"}
            names = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "worker"}
            fit = drift.compute_drift(REGISTRY.snapshot(), registry=REGISTRY)
            if not ({(0, 0), (0, 1), (1, 2), (1, 3)} <= tracks and {
                    "ingest", "step", "exchange_issue", "exchange_commit", "flush",
                    "epoch"} <= names and len(st["bridges"]) == 2
                    and "perfmodel.model_drift" in REGISTRY.snapshot()):
                raise AssertionError(f"[fleet-small] traced chain: tracks {sorted(tracks)}, "
                                     f"names {sorted(names)}, bridges {st.get('bridges')}")
            rows = {r["host"]: r for r in st["bridges"]}
            log(f"[fleet-small] 4-stage chain at capacity 2, 4 workers on the card, K = 1: "
                f"{sum(len(t) for t in got)} packets over {len(got)} boundaries on hosts=2 "
                f"bit-identical to hosts=1 and to NetworkSim (cycle-accurate), "
                f"gather_state bit-identical to hosts=1 ({two_s:.2f} s with the fleet's "
                f"start and a traced rerun; hosts=1 {one_s:.2f} s); the follower launcher "
                f"never initialised CUDA; traced rerun bit-identical, worker tracks "
                f"{sorted(tracks)}, bridges {rows['h0']['slabs_tx']} slabs h0->h1, credit "
                f"RTT {rows['h0']['credit_rtt_s'] * 1e3:.3f} ms, connect "
                f"{rows['h0']['connect_s']:.2f} / {rows['h1']['connect_s']:.2f} s; "
                f"perfmodel.model_drift {fit.get('model_drift', float('nan')):.4f}")
        except BaseException:
            sim.engine.close()
            raise
        raise_drill(sim, "linkkill:0@3", LinkDownError, "fleet-small")

        # systolic: save on two hosts, load back into the running 2-host
        # fleet (a fenced scatter over the control link), then a corrupted
        # slab frame armed on it under raise
        rng = np.random.RandomState(3)
        M, K, N = 6, 4, 4
        A, B = rng.randn(M, K).astype(np.float32), rng.randn(K, N).astype(np.float32)
        done = lambda s: ((~s.block_states[0].is_south)  # noqa: E731
                          | (s.block_states[0].y_idx >= M)).all()

        def result_of(s):
            return np.stack([np.asarray(s.probe((K - 1) * N + c).y_buf.cpu())
                             for c in range(N)], axis=1)

        ref = make_systolic_network(A, B)[0].build(device="cuda").reset(0)
        ref.run(until=done, max_epochs=100_000)
        want_y = result_of(ref)
        ck = os.path.join(tmp, "sys")
        sim = make_systolic_network(A, B)[0].build(
            engine="procs", device="cuda", timeout=PROCS_TIMEOUT, n_workers=4,
            partition=(np.arange(K * N) // 4).tolist(), K=4, hosts=2)
        try:
            sim.reset(0).run(cycles=12)
            sim.save(ck)
            sim.run(until=done, max_epochs=100_000)
            y1 = result_of(sim)
            sim.reset(0).load(ck)
            at = sim.cycle
            sim.run(until=done, max_epochs=100_000)
            y2 = result_of(sim)
        except BaseException:
            sim.engine.close()
            raise
        if not (at == 12 and np.array_equal(y1.view(np.uint32), want_y.view(np.uint32))
                and np.array_equal(y2.view(np.uint32), want_y.view(np.uint32))):
            sim.engine.close()
            raise AssertionError(f"[fleet-small] systolic: Y differs (resumed at {at})")
        log("[fleet-small] systolic 6x4 @ 4x4 on 4 workers, hosts=2: run(cycles=12), "
            "save, run(until); reset, load (scatter over the control link into both "
            "hosts' workers) and resume from cycle 12: Y bit-identical to NetworkSim on "
            "the card both times")
        raise_drill(sim, "linkcorrupt:0@1", RingCorruptionError, "fleet-small")

        # the three link kinds under recover on one fleet, each armed in the
        # incarnation the one before leaves (:r<N>)
        plan = "linkkill:0@3,linkcorrupt:0@5:r1,linkslow:0@7:r2:0.05"
        fired = REGISTRY.counters().get("faults.injected", 0.0)
        t0 = time.perf_counter()
        got, tree, facts, _t = chain_run(hosts=2, fault_plan=plan, on_fault="recover",
                                         snapshot_every=2, backoff_s=0.0)
        wall = time.perf_counter() - t0
        fired = REGISTRY.counters().get("faults.injected", 0.0) - fired
        faults = facts["faults"]
        if not (same_traffic(want, got) and same_leaves(want_tree, tree)):
            raise AssertionError(f"[fleet-small] drill {plan}: traffic or state differs")
        kinds = [r["fault"] for r in facts["recoveries"]]
        if (faults["restarts"] != 2 or fired != 3
                or kinds != ["LinkDownError", "RingCorruptionError"]):
            raise AssertionError(f"[fleet-small] drill {plan}: {faults}, faults {kinds}")
        respawn = ", ".join(f"{r['seconds']:.2f}" for r in facts["seen"]["reopen"])
        log(f"[fleet-small] drill {plan} under recover: LinkDownError healed, then "
            f"RingCorruptionError healed, then the paused pump absorbed (no restart); "
            f"host trace and gather_state bit-identical to the fault-free fleet; "
            f"restarts {faults['restarts']}, incarnation {faults['incarnation']}, "
            f"respawns {respawn} s, {fired:.0f} link faults fired; "
            f"{check_no_leftovers(f'fleet {plan}', facts['seen'])}; "
            f"{wall:.2f} s in all")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fleet_cell(args, **kw):
    """wafer-1M-procs4-hosts2: ``procs_wafer`` on ``hosts=2`` (granules 0
    and 1 on h0, 2 and 3 on h1, every worker on the one card)."""
    return procs_wafer(*args, hosts=2, **kw)


def log_setup(tag: str, eng, build_s: float, launch_s: float) -> None:
    """The set-up split of a 2-host fleet: the leader's lowering and
    prebuild, the build blob, rings, spawn, its workers ready, the
    follower's boot (spawn to hello: its imports, blob, lowering, rings,
    workers) and the rendezvous."""
    ls = eng.launch_stats
    h1 = ls["hosts"]["h1"]
    fl = h1["launch"]
    log(f"[fleet-full] {tag}: set-up {build_s + launch_s:.2f} s: constructor "
        f"{build_s:.2f} s (lowering {eng.lowering_seconds:.2f}, prebuild "
        f"{eng.build_stats['prebuild_seconds']:.2f}); launch {launch_s:.2f} s: blob "
        f"{eng.build_stats['follower_blob_bytes']} B written in "
        f"{ls['blob_seconds']:.3f} s, leader rings {ls['rings_seconds']:.2f} s, spawn "
        f"{ls['spawn_seconds']:.2f} s, leader workers ready after "
        f"{max(ls['ready_seconds'].values()):.2f} s (spawn to entry "
        f"{', '.join(f'{c:.2f}' for c in ls['entry_seconds'].values())} s), followers' hellos "
        f"{ls['followers_seconds']:.2f} s after that, rendezvous in all "
        f"{ls['rendezvous_seconds']:.2f} s; h1: blob read + constructor "
        f"{fl['blob_read_seconds']:.2f} s (lowering {h1['lowering_seconds']:.2f}), rings "
        f"{fl['rings_seconds']:.2f} s, spawn {fl['spawn_seconds']:.2f} s, workers ready "
        f"after {max(fl['ready_seconds'].values()):.2f} s (spawn to entry "
        f"{', '.join(f'{c:.2f}' for c in fl['entry_seconds'].values())} s), CUDA in its launcher: "
        f"{h1['cuda_initialized']}")


def bridge_line(rows: list, n_exchanges: int) -> str:
    """``bridge_stats`` as one log line: each side's bytes, slabs and
    credits each way, credit RTT, wait fraction, and bytes a pod exchange."""
    parts = []
    for r in rows:
        parts.append(
            f"{r['host']} ({r['role']}): tx {r['bytes_tx']} B / rx {r['bytes_rx']} B, "
            f"slabs {r['slabs_tx']}/{r['slabs_rx']}, credits {r['credits_tx']}/"
            f"{r['credits_rx']}, credit RTT {r['credit_rtt_s'] * 1e3:.3f} ms, wait "
            f"{r['wait_fraction']:.4f}, connect {r['connect_s']:.2f} s, "
            f"{(r['bytes_tx'] + r['bytes_rx']) / max(n_exchanges, 1):.0f} B a pod exchange")
    return "; ".join(parts)


def telemetry_run(tag: str, eng, sim, done, want, want_stop, untraced_s: float) -> dict:
    """The fleet's warm until-run again inside ``sim.trace``: the traced
    run's seconds against the untraced one's, each worker's epoch split
    into its phases from the exported trace, records dropped, and the
    ``perfmodel.model_drift`` gauge.  Stop and blocks as GraphEngine's."""
    import tempfile

    from repro_torch.obs import drift, schema, trace
    from repro_torch.obs.registry import REGISTRY, MetricsRegistry

    path = os.path.join(tempfile.mkdtemp(prefix="fleet_trace_"), "trace.json")
    dropped0 = {r["granule"]: r["telem_dropped"] for r in eng.worker_stats()}
    trace.recorder().clear()  # earlier phases' windows are exported already
    sim.reset(0)
    t0 = time.perf_counter()
    with sim.trace(path):
        sim.run(until=done, max_epochs=1000)
    traced_s = time.perf_counter() - t0
    if sim.cycle != want_stop or not same_leaves(want, eng.gather_group(sim.state, 0)):
        raise AssertionError(f"[{tag}] traced run: stop {sim.cycle} or blocks differ")
    rows = eng.worker_stats(sim.state)
    dropped = sum(r["telem_dropped"] - dropped0[r["granule"]] for r in rows)
    doc = schema.validate_trace_file(path)
    with open(path) as f:
        size = len(f.read())
    split: dict = {}
    phases = MetricsRegistry()  # this run's phase histograms alone
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "worker":
            w = split.setdefault((e["pid"], e["tid"]), {})
            w[e["name"]] = w.get(e["name"], 0.0) + e["dur"] * 1e-6
            phases.observe(f"procs.phase.{e['name']}.s", e["dur"] * 1e-6)
            if e["name"] == "epoch":
                w["n"] = w.get("n", 0) + 1
    fit = drift.compute_drift(phases.snapshot(), overlap=eng.overlap, registry=REGISTRY)
    log(f"[{tag}] telemetry: traced until-run {traced_s:.3f} s against the untraced "
        f"{untraced_s:.3f} s ({traced_s / untraced_s:.3f}x; each phase ends with a "
        f"synchronize of the worker's device), stop {sim.cycle}, blocks bit-identical; "
        f"{dropped} records dropped; trace {size} B; perfmodel.model_drift "
        f"{fit['model_drift']:.4f} (measured {fit['measured_s'] * 1e3:.2f} ms an epoch, "
        f"predicted {fit['predicted_s'] * 1e3:.2f}: step {fit['t_step'] * 1e3:.2f}, comm "
        f"{fit['t_comm'] * 1e3:.2f}, residual {fit['t_residual'] * 1e3:.2f})")
    for (pid, w), ph in sorted(split.items()):
        ep = ph.get("epoch", 0.0)
        parts = ", ".join(f"{k} {ph.get(k, 0.0):.3f} s ({ph.get(k, 0.0) / ep:.3f})"
                          for k in ("ingest", "step", "exchange_issue", "exchange_commit",
                                    "flush"))
        log(f"[{tag}] telemetry: worker {w} (trace pid {pid}) {ph.get('n', 0)} epochs, "
            f"{ep:.3f} s in epochs: {parts}")
    return {"traced_s": traced_s, "dropped": dropped, "drift": fit}


def phase_fleet_full() -> None:
    """wafer-1M-procs4-hosts2: the full wafer on 4 workers over 2 hosts
    joined by a TCP ring bridge, every worker on the card."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import Simulation
    from repro_torch.hw.manycore import allreduce_done

    R, C = CONFIG.grid_rows, CONFIG.grid_cols
    args = (R, C, CONFIG.k_outer, CONFIG.k_inner, CONFIG.queue_capacity, "cuda")
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    if "graph" not in SHARED:
        graph_yardstick(args, done, "fleet-full")
    want, want_stop, gwall = (SHARED["graph"][k] for k in ("want", "want_stop", "gwall"))
    if "procs4" not in SHARED:
        eng, _ = procs_wafer(*args)
        try:
            sim = Simulation(eng).reset(0)
            sim.run(epochs=2)
            sim.reset(0)
            t0 = time.perf_counter()
            sim.run(until=done, max_epochs=1000)
            run_s = time.perf_counter() - t0
            single_host_done(eng, sim, done, want, want_stop, run_s, "fleet-full")
        finally:
            eng.close()
        gc.collect()
    one = SHARED["procs4"]

    t0 = time.perf_counter()
    eng, _ = fleet_cell(args)
    build_s = time.perf_counter() - t0
    try:
        t1 = time.perf_counter()
        eng.launch()
        launch_s = time.perf_counter() - t1
        lk = eng._links[0]
        tiers = {eng._chan_tier[c] for c, _h in lk.chans}
        log(f"[fleet-full] wafer-1M-procs4-hosts2: {eng.G} granules on {eng.NW} workers, "
            f"plan {dict((h, eng.host_plan.granules_of(h)) for h in eng.host_plan.hosts)}; "
            f"{len(eng._links)} link ({lk.label}) carrying {len(lk.chans)} channels of "
            f"tier(s) {sorted(tiers)} (slab slot {eng._rings[next(iter(eng._rings))].stride}"
            f" B), the other {sum(len(c) for c in eng.lowering.routes.values()) - len(lk.chans)}"
            f" boundary channels in shared memory")
        log_setup("wafer-1M-procs4-hosts2", eng, build_s, launch_s)
        sim = Simulation(eng).reset(0)
        sim.run(epochs=2)  # warm: the first epochs' graphs and rings
        sim.reset(0)
        b0 = {(r["link"], r["host"]): r for r in eng.bridge_stats()}
        t2 = time.perf_counter()
        sim.run(until=done, max_epochs=1000)
        run_s = time.perf_counter() - t2
        stop, epochs = sim.cycle, sim.epoch
        rows = eng.bridge_stats()
        delta = [dict(r, **{k: r[k] - b0[(r["link"], r["host"])][k] for k in
                            ("bytes_tx", "bytes_rx", "slabs_tx", "slabs_rx",
                             "credits_tx", "credits_rx")}) for r in rows]
        wrows = eng.worker_stats(sim.state)
        tree = eng.gather_state(sim.state)
        blocks = eng.gather_group(sim.state, 0)
        if stop != want_stop or not same_leaves(want, blocks):
            raise AssertionError(f"[fleet-full] stop {stop} (GraphEngine {want_stop}) "
                                 "or blocks differ")
        if not np.array_equal(blocks.total, np.full_like(blocks.total, TOTAL)):
            raise AssertionError("[fleet-full] totals are not the global sum")
        if not same_leaves(one["tree"], tree):
            raise AssertionError("[fleet-full] gather_state differs from the single-host "
                                 "fleet's")
        pod_exchanges = -(-epochs * eng.cycles_per_epoch // eng.periods[0])
        log(f"[fleet-full] wafer-1M-procs4-hosts2: converged at cycle {stop} ({epochs} "
            f"epochs), every total {TOTAL:.0f}, gather_state bit-identical to the "
            f"single-host fleet's and every block to GraphEngine's; warm run(until) "
            f"{run_s:.3f} s = {R * C * stop / run_s:.4e} core-cycles/s against the "
            f"single-host fleet's {one['run_s']:.3f} s ({run_s / one['run_s']:.2f}x) "
            f"and GraphEngine's {gwall:.3f} s in this call")
        log(f"[fleet-full] bridges over the run ({pod_exchanges} pod exchanges): "
            f"{bridge_line(delta, pod_exchanges)}")
        for r in sorted(wrows, key=lambda r: r["granule"]):
            log(f"[fleet-full] hosts2: worker {eng._worker_of[r['granule']]} on "
                f"{eng._host_of_w[eng._worker_of[r['granule']]]} ({r['device']}): run "
                f"{r['run_s']:.3f} s, ring wait {r['wait_s']:.3f} s (share "
                f"{r['wait_fraction']:.4f}), {r['ring_ops']} ring ops")
        del tree
        # the fault-free recover run by run(epochs=67): the drill's yardstick
        eng.on_fault = "recover"
        clean = recover_epochs(eng, sim, want, want_stop, "fleet-full")
        link_drill(eng, sim, want, want_stop, clean)
    finally:
        eng.close()
    gc.collect()
    torch.cuda.empty_cache()


def link_drill(eng, sim, want, want_stop, clean: dict) -> None:
    """``linkkill:0@FLEET_KILL_EPOCH`` armed on the warm wafer-1M-procs4-hosts2
    fleet under ``on_fault="recover"`` (its fault-free ``run(epochs=67)``
    just ran), run by ``run(epochs=67)`` (snapshots every 16, so epochs
    32-39 are replayed): the stop and every block as GraphEngine's, MTTR
    (the run's seconds less the fault-free run's) split into detect (the
    kill to the faulted fleet's teardown), teardown, backoff, respawn with
    the re-rendezvous as its own term, restore, replay and the rest."""
    import numpy as np

    arm_link_fault(eng, f"linkkill:0@{FLEET_KILL_EPOCH}")  # incarnation 0
    seen = watch_incarnations(eng)
    fired = []
    fire = eng._fire_link_fault

    def fire_spy(a):
        fired.append(time.time())
        return fire(a)

    eng._fire_link_fault = fire_spy
    sim.reset(0)
    n0, s0 = snapshot_seconds()
    t1 = time.perf_counter()
    sim.run(epochs=want_stop // sim.period)
    run_s = time.perf_counter() - t1
    n1, s1 = snapshot_seconds()
    stop, epochs = sim.cycle, sim.epoch
    blocks = eng.gather_group(sim.state, 0)
    stats = eng.fault_stats()
    ls = eng.launch_stats
    tag = f"linkkill:0@{FLEET_KILL_EPOCH} under recover, run(epochs)"
    if stop != want_stop or not same_leaves(want, blocks):
        raise AssertionError(f"[fleet-full] {tag}: stop {stop} or blocks differ")
    if not np.array_equal(blocks.total, np.full_like(blocks.total, TOTAL)):
        raise AssertionError(f"[fleet-full] {tag}: totals are not the global sum")
    last = stats["last_recovery"]
    if stats["restarts"] != 1 or last["fault"] != "LinkDownError" or not fired:
        raise AssertionError(f"[fleet-full] {tag}: {stats}")
    left = check_no_leftovers(f"fleet-full {tag}", seen)
    split = recovery_split(seen, last)
    detect = seen["close"][0]["at"] - fired[0]
    mttr = run_s - clean["run_s"]
    n_replay = FLEET_KILL_EPOCH - last["restored_epoch"]
    per_epoch = (clean["run_s"] - clean["snapshot_s"]) / clean["epochs"]
    replay = n_replay * per_epoch
    snap_extra = (s1 - s0) - clean["snapshot_s"]
    ready = max(ls["ready_seconds"].values())
    rdv = ls["rendezvous_seconds"]
    rest = (mttr - detect - split["teardown"] - last["backoff_s"] - split["respawn"]
            - split["restore"] - replay - snap_extra)
    log(f"[fleet-full] {tag}: LinkDownError healed, stop cycle {stop} ({epochs} epochs), "
        f"every block bit-identical to GraphEngine's, every total {TOTAL:.0f}; restored "
        f"epoch {last['restored_epoch']}, {n_replay} epochs replayed, {n1 - n0} snapshots "
        f"in the run; {left}")
    log(f"[fleet-full] {tag}: MTTR {mttr:.3f} s (the run {run_s:.3f} s less the "
        f"fault-free recover run's {clean['run_s']:.3f} s): detect {detect:.3f} s (the "
        f"proxy's kill to the teardown), teardown {split['teardown']:.3f} s, backoff "
        f"{last['backoff_s']:.3f} s, respawn {split['respawn']:.3f} s (the leader's "
        f"workers ready after {ready:.2f} s, then the re-rendezvous {rdv:.3f} s: "
        f"the follower's hello {ls['followers_seconds']:.3f} s, links up and the "
        f"follower ready {rdv - ls['followers_seconds']:.3f} s), restore "
        f"{split['restore']:.3f} s, replay {replay:.3f} s ({n_replay} epochs at the "
        f"fault-free run's {per_epoch:.4f} s an epoch less its snapshots), snapshots "
        f"{snap_extra:.3f} s more than the fault-free run's, the rest {rest:.3f} s")


RUN_TOKEN = "CHIP_SMOKE_RUN"  # environment variable every process of a run inherits


def run_processes(token: str) -> dict:
    """Every live process but this one whose environment holds this run's
    token: whatever the run started, at any depth (forkservers, workers,
    bridges, followers and theirs), orphans included.  pid -> command."""
    mark = f"{RUN_TOKEN}={token}".encode()
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as f:
                if mark not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if pid_alive(int(d)):
            out[int(d)] = cmd[:160]
    return out


def stop_run_processes(token: str, grace: float = 5.0) -> str:
    """Stop this process's forkserver and resource tracker, then check
    that no other process of the run is left: one still alive ``grace``
    seconds later is killed and fails the run (a fleet teardown that
    leaves a process behind is a fault of the port)."""
    import signal

    from repro_torch.runtime.launcher import stop_helpers

    stopped = stop_helpers()
    deadline = time.monotonic() + grace
    left = run_processes(token)
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = run_processes(token)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    if left:
        raise AssertionError(f"[exit] processes of this run left after every fleet "
                             f"closed (killed now): {left}")
    return (f"[exit] no process of this run left: forkserver and resource tracker "
            f"stopped ({len(stopped)} process(es)), nothing else alive")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's package is missing ({SRC}/repro_torch); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    token = os.environ[RUN_TOKEN] = f"{os.getpid()}-{time.time_ns()}"

    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    # every kernel, and the RG-LRU's chunk-sweep variants (rg-full)
    builds = [(name, ()) for name in KERNELS] + (
        [("rglru_scan", (f"RGLRU_CHUNK={tc}",)) for tc in RGLRU_SWEEP_VARIANTS]
        if "rg-full" in phases else [])
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(lambda b: _build.build(*b), builds)))
    for name, defines in builds:
        key = _build.report_key(name, defines)
        log(f"[build] {key} built in {secs[name, defines]:.2f} s")
        for line in _build.PTXAS_REPORT.get(key, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Function properties",
                                       "Performance Loss", "setmaxnreg")):
                log(f"[build] {line.strip()}")
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for all {len(builds)}")
    kernels = [{}, {}, {}]
    lm_kernels: list = []
    lm_paths: dict = {}  # flash at moe-full's and emb-full's models
    train_rows: dict = {}  # kernel -> arch -> train-full's numbers
    for phase, run in (("small", phase_small),
                       ("full", lambda: phase_full(kernels[0])),
                       ("sys-small", phase_sys_small),
                       ("sys-full", lambda: phase_sys_full(kernels[1])),
                       ("fsys-small", phase_fsys_small),
                       ("fsys-full", lambda: phase_fsys_full(kernels[2])),
                       ("fused-io", lambda: phase_fused_io(kernels[0])),
                       ("graph-small", phase_graph_small),
                       ("graph-full", phase_graph_full),
                       ("session-small", phase_session_small),
                       ("session-full", phase_session_full),
                       ("mesh-small", phase_mesh_small),
                       ("mesh-full", lambda: phase_mesh_full(kernels)),
                       ("procs-small", phase_procs_small),
                       ("procs-full", phase_procs_full),
                       ("fleet-small", phase_fleet_small),
                       ("fleet-full", phase_fleet_full),
                       ("lm-small", phase_lm_small),
                       ("lm-dense", phase_lm_dense),
                       ("rg-full", lambda: phase_rg_full(lm_kernels)),
                       ("xl-full", lambda: phase_xl_full(lm_kernels)),
                       ("lm-fam", phase_lm_fam),
                       ("moe-full", lambda: phase_moe_full(lm_paths)),
                       ("emb-full", lambda: phase_emb_full(lm_paths)),
                       ("train-small", phase_train_small),
                       ("train-full", lambda: phase_train_full(train_rows)),
                       ("dryrun-full", phase_dryrun_full)):
        if phase in phases:
            t1 = time.perf_counter()
            run()
            log(f"[{phase}] phase took {time.perf_counter() - t1:.1f} s")
    log(stop_run_processes(token))
    if lm_paths:  # flash's row (rg-full's, or the first model's) takes each model's
        flash = next((k for k in lm_kernels if k["name"] == "flash_attention"), None)
        if flash is None:
            flash = dict(FLASH_ROW, **next(iter(lm_paths.values())))
            lm_kernels.append(flash)
        flash["paths"] = lm_paths
    for name, by_arch in train_rows.items():
        # rows 3-5 gain the backward's times at the train path's first call
        # (the first arch that reached the kernel); a run without the
        # serving phases takes the whole row from there
        first = next(iter(by_arch.values()))
        row = next((k for k in lm_kernels if k["name"] == name), None)
        if row is None:
            row = dict(KERNEL_ROWS[name], **{k: first[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
            lm_kernels.append(row)
        row.update(bwd_ms=first["bwd_ms"], plain_bwd_ms=first["plain_bwd_ms"],
                   library_bwd_ms=first["library_bwd_ms"], train=by_arch)
    print(json.dumps({"kernels": [k for k in kernels + lm_kernels if k.get("name")]}),
          flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
