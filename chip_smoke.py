#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, ``tpusim_torch capture → simulate``, at the
registered width of ``flash_attention_pallas`` ([32, 1024, 128] f32), of
the ten workloads the general lowering captures, of the seven
multi-device workloads (all their ranks on the one card, in one process
and as a process a rank) and of the
model suite (the two 64-device steps over meta tensors),
simulate's lane-batched pricing with its row scans on the card, the
campaign and fleet layers whose scenario-batched warm runs those scans,
the sharding advisor, the observability layer and trace tools, and the
serving daemon on the card's host, and holds each CUDA kernel
against its plain PyTorch version.  Phases, in order (any failure exits
non-zero and prints no result):

1. the card's name and power limit (``nvidia-smi``) and the CUDA version;
2. build every kernel from ``tpusim_torch/csrc`` with nvcc (timed), and
   the instruction probes (``mma_probe.cu``), one nvcc per source, all
   started together; print ptxas's registers, shared memory and spills for
   every instantiation, and fail on a kernel's spill;
3. kernel vs plain version on the card, at the main path's shapes and at
   shapes that take the kernel's edges (a sequence that is not a multiple
   of the key tile, padded and unaligned head dims), in f32 and bf16;
4. the main path through the CLI entry functions, with the kernels'
   launch counters set to 0 just before and read just after; simulate at
   v5e and v5p, and all five golden cells (``matmul_512`` at v5e and v5p;
   the 4-device ``llama_tiny_tp2dp2`` with its 14 collectives on the
   analytic ICI model, on the detailed one, and with power at v6e)
   against ``ci/golden/*.json``, each with its host seconds; then the
   multi-device path through the CLI (``simulate --network-mode detailed
   --power``), whose counters are read the same way (it runs on the
   card's host and launches no kernel);
5. timings (median of CUDA-event times) in f32 and bf16: kernel, plain
   version, ``scaled_dot_product_attention`` as a yardstick, and the
   card's bound (the larger of operations over the tensor cores' peak for
   the input type and bytes over HBM's peak);
6. the pricing fastpath: (a) golden cells 1-5 simulated on the card's
   host with ``pricing_backend="serial"`` and ``"vectorized"`` (cold and
   with the compiled columns cached), each report against its golden and
   the two backends' stats equal apart from the ``fastpath_*`` keys, with
   host seconds; (b) ``price_module_batch`` over ``llama_tiny_tp2dp2``'s
   module at v5p with 64 degraded lanes (seeded scales in (0.5, 1]) with
   ``backend="cuda"`` — the ``scan_rows`` kernel — with the launch counters
   set to 0 just before and read just after: one launch per run step
   (printed with the lanes per launch), every lane's result equal to
   ``"vectorized"``'s and to the lane's serial walk; (c) ``scan_rows``
   against its plain version by bytes on seeded matrices, S in {1, 64,
   4096} lanes x k in {1, 47, 4096} ops, values from 1e-3 to 1e9, and its
   segmented entry ``scan_segments`` by bytes on every step launch of (b),
   on the same steps at 746 lanes, and on ragged segments (empty, one row,
   repeated and unsorted rows, 4096 rows) at 1, 32, 33 and 746 lanes,
   ops-major and at lane stride 0; (d) the times of (b) and (c): the
   batched call per backend, each step launch of (b) at 64 and 746 lanes
   (the kernel alone and the route's round trip), the latency of a
   dependent float64 add (``mma_probe.cu``), and at every shape of (c)
   kernel, plain version, the host row scan, ``torch.cumsum`` on the card
   as the yardstick, the chain floor (k dependent adds) and the bound;
7. degraded pods on the card's host, with the kernels' launch counters set
   to 0 just before and read just after (they must stay 0: this path
   launches no kernel), each part with its host seconds: (a) the faults
   smoke contract of ``ci/check_golden.py`` (``ci/faults_schema.json``
   read as data: its kinds equal ``FAULT_KINDS``, its example schedules
   round-trip, a healthy ``llama_tiny_tp2dp2`` @ v5p run carries no
   ``faults_*`` key, one dead link stamps every required key and inflates
   both collective and step cycles); (b) every example schedule on
   ``llama_tiny_tp2dp2`` @ v5p on the analytic and the detailed network,
   ``serial`` and ``vectorized`` stats equal apart from ``fastpath_*``;
   (c) ``simulate --workers 4`` on a two-module trace built from
   ``matmul_512`` — its pool forks after CUDA is initialised, must stamp
   ``pool_workers`` 4 and ``pool_parallel_segments`` 2, and give the
   serial stats; (d) ``faults --arch v5p --chips 64`` (192 scenarios),
   serial and ``--workers 4``, reports equal by bytes; (e) ``faults
   --arch v5p --chips 8 --trace llama_tiny_tp2dp2`` (12 scenarios)
   serially, with ``--workers 4`` and twice with ``--result-cache DIR``,
   reports equal by bytes, the second cached run taking every module
   result from the disk tier;
8. the durable store on the card's host, the kernels' launch counters set
   to 0 just before each part and read just after, each part with its host
   seconds: (a) golden cells 1-5 through ``python -m tpusim_torch simulate
   --compile-cache DIR``, all five cold in one fresh process, then all five
   warm in another, each run timed inside the child from before
   ``load_trace`` to the end of simulate;
   every report passes its golden without the ``fastpath_*`` keys, the
   warm run shows ``fastpath_store_hits`` >= 1, ``fastpath_compile_misses``
   0 and ``fastpath_ir_ops_built`` 0, and cold and warm stats are equal
   apart from ``fastpath_*``; (b) the garbage-collection pauses of 10 ms or
   more in the cold ``llama_tiny_tp2dp2`` runs (``gc.callbacks``), and in
   one cold llama run inside this process, which holds CUDA; (c)
   ``warm_states`` over 64 seeded chip-degradation states of
   ``llama_tiny_tp2dp2`` @ v5p with ``backend="cuda"`` (``scan_rows``
   launches > 0, and lanes per launch) and ``"vectorized"`` (0 launches),
   each into a fresh disk
   result cache, every published record equal by bytes to the one the
   per-state ``CachedEngine.run`` writes, ``auto`` still resolving to
   ``vectorized``; (d) the ``cache`` CLI over (a)'s store: ``stats`` counts
   both tiers, ``verify`` finds no corrupt record, a record with one byte
   flipped is quarantined once, ``gc --quota`` leaves the store under the
   quota; (e) phase 7 (e) again in (a)'s two fresh processes, the warm
   cached leg in the second;
9. compound-fault campaigns and the fleet twin on the card's host, each
   part with its host seconds and the kernels' launch counters set to 0
   just before each run and read just after: (a) ``run_campaign`` on the
   campaign and DCN smoke specs and ``run_fleet`` on the fleet smoke spec
   of ``ci/check_golden.py`` (copied here), each with ``scenario_batch``
   ``False``, ``"vectorized"`` and ``"cuda"``: the three reports equal by
   bytes, ``cuda`` launching ``scan_rows`` and the others nothing; each
   report against its golden (``model_version`` masked, non-floats equal,
   floats within a relative 1e-12, the count of differing floats and the
   largest gap printed) and the smoke's contract checks; (b) ``python -m
   tpusim_torch campaign`` (the campaign smoke at 256 scenarios a slice)
   and ``fleet`` ((d)'s fleet) uninterrupted through the CLI, then
   cancelled mid-run in this process once half their records are
   journaled (the run's ``CancelToken`` tripped on the journaled count)
   and by the CLI's ``--max-wall-s`` (exit 3), each then ``--resume``-d
   through the CLI in a fresh process (the four resumes in one): the
   report equals the
   uninterrupted one by bytes, the journaled work resumed, not priced; (c) the campaign smoke's fault model on a
   v5p 4x4x4 pod, 1024 scenarios, under the three legs: reports equal by
   bytes, ``scan_rows`` launches and lanes per launch, ``BatchStats``;
   (d) the fleet smoke's traffic and policies on 8 pods over 300 s with
   frontier targets 12 and 48 req/s up to 16 pods, ``False`` and
   ``"cuda"``, reports equal by bytes;
10. the sharding advisor on the card's host, each part with its host
   seconds and the kernels' launch counters set to 0 just before it and
   read just after (they must stay 0: the advisor prices on the host):
   (a) ``run_advise`` on ``ci/check_golden.py``'s advise smoke spec
   (copied here) against ``ci/golden/advise_smoke.json`` under phase 9's
   float rule (the count of differing floats and the largest gap
   printed) and the smoke's contract (>= 12 ranked cells with the contract
   columns, ``dp4xtp2`` with 14 collectives per chip, a recommendation); a
   warm pass through the same result cache walks no module and gives the
   same bytes; golden cells 1-5 still pass after the sweep; (b) ``python
   -m tpusim_torch advise`` on the same spec, cold through the CLI's entry
   function and warm in a fresh process, through one ``--result-cache``
   directory: both ``--json`` reports equal by bytes and to (a)'s; (c) a v5p-64 sweep (``dp``, ``tp``,
   ``dp_tp``, ``sp``, ``pp`` and the pinned ``dp4xtp4xpp4``, 10 cells)
   cold, warm and with 4 pricing workers, reports equal by bytes, the
   warm pass walking no module, with per-cell seconds and, in the cold
   leg, each cell's calls of and seconds in ``permute_seconds``; (d) the
   critical-path analyzer on every module of the 12-trace corpus at
   v5p: critical path <= the engine's cycles <= the serial sum;
11. the general lowering (core ATen -> fused HLO) on the ten workloads
   with committed silicon traces, each at its registered width on the
   card, with the kernels' launch counters set to 0 just before and read
   just after (they must stay 0: the workloads run through plain torch
   ops): (a) ``capture W DIR --launches 2 --snapshot`` through the CLI
   entry function, timed; (b) the module text captured on the card equals
   by bytes the text the same torch lowers from CPU tensors of the same
   shapes; (c) every snapshot buffer against a CPU run of the same module
   on the same inputs, the first launch elementwise within rtol = atol =
   1e-4 (float32) or 2e-2 (bfloat16), later launches (which start from
   state that already differs) and matmul_chain's ill-conditioned chain
   norm-wise; (d) the trace simulated at v5e and v5p, per-step totals
   beside ``reports/silicon/W``'s divided by its ``n_steps``, with the
   ratios at the registered width and from a capture at the silicon
   trace's own shapes; (e) ``measure_wall_time``'s median on the card.
12. multi-device capture: the seven multi-device workloads
   (``ici_allreduce`` over 8 devices, ``ulysses_attention_sp8``,
   ``moe_ep4``, ``llama_tiny``, ``llama_tiny_tp2dp2``,
   ``decode_step_tp8``, ``ring_attention_sp8``) at registered width, every
   rank of a workload on the one card through the rank runner
   (``tpusim_torch.spmd.run_ranks``), the kernels' counters set to
   0 just before and read just after (they must stay 0): (a) ``capture W
   DIR --snapshot`` through the CLI, timed; (b) the card's HLO equals by
   bytes the CPU's; (c) the N ranks' global outputs against the
   workload's unsharded computation on the card (global attention, the
   round-robin MoE of each token shard with every expert on one device,
   the single-rank llama step on the whole batch, the plain decode, the
   mean of ``x``'s shards; ``llama_tiny``, one device, against the CPU)
   within rtol = atol = 1e-4 (float32) or 2e-2 (bfloat16); (d) simulated
   at v5p, ``llama_tiny_tp2dp2`` also at golden cells 3-5's arches beside
   the fixture (MXU flops equal); (e) the median of a whole N-rank step.
13. the model suite (``llama_tiny_train``, ``llama7b``, ``moe_ep8_train``,
   ``pipeline_pp4``, ``resnet50``, ``resnet50_train``, ``resnet50_dp8``,
   ``llama7b_tp8dp8``, ``llama7b_aot_v5p64``) at registered width, the
   kernels' counters set to 0 just before and read just after (they must
   stay 0): (a) ``capture W DIR`` through the CLI, timed (the 64-device
   steps over meta tensors, their ``--snapshot`` refused; ``llama7b`` and
   ``llama7b_tp8dp8`` at 4 of their 32 layers, :data:`CAPTURE_DEPTH`); (b) the
   concrete ones' HLO on the card equals by bytes the CPU's (the CPU's
   captured in a fresh process that runs beside the phase and never
   touches the card); (c) each
   one's check — the card against the CPU (``llama7b`` at 2 layers, seq
   256, norm-wise, against a float32 evaluation on the CPU, the CPU's
   bf16 run and the two apart reported beside it; the ResNets at batch 2, the forward in float32 and the
   train step in float64, and in bfloat16 the forward's logits, the train
   step's loss and each batch-norm layer alone on its input, output and
   vjp), the ranks against the unsharded step (``moe_ep8_train``;
   ``pipeline_pp4`` against ``reference_forward``; ``resnet50_dp8`` in
   float64 at batch 64, and its batch-norms synchronized over 8 ranks in
   bfloat16 against the CPU's, layer by layer; the
   64-device steps at a small configuration, and the AOT step's reversed
   scan of hand-written layer backwards against autograd of the unrolled
   layers), replicas bit for bit; (d) simulated at v5p: MXU flops,
   collectives, ICI bytes; (e) the median step and the peak of
   ``torch.cuda.max_memory_allocated``, beside the card's name and power
   limit.

14. the nine ``ubench`` workloads the port took last (``matmul``,
   ``small_matmul_chain``, ``op_overhead_chain``, ``dynamic_loop``,
   ``softmax_narrow``, ``relayout_copy``, ``matmul_int8``,
   ``reduce_lane_wide``, ``reduce_major_acc``) at registered width, the
   kernels' counters set to 0 just before and read just after (they must
   stay 0): (a) ``capture W DIR --launches 2`` through the CLI, timed;
   (b) the card's HLO equals by bytes the CPU's; (c) the card's output
   against a CPU run on the same inputs — float32 within rtol = atol =
   1e-4, bfloat16 2e-2, ``matmul_int8`` exactly, ``dynamic_loop``'s root
   within 1e-4; the two 4096^3 products on their first 256 rows;
   ``small_matmul_chain``'s registered output NaN on both sides (64
   squarings overflow), its numbers held at depth 4; (d) ``lint``
   through the CLI with zero errors; (e) simulated at v5e, only
   ``dynamic_loop`` with unknown-trip loops (one a launch); the median
   step and the peak of ``torch.cuda.max_memory_allocated``; (f)
   ``matmul`` at 512^3 captured as ``matmul_512``: the fixture's command
   list by bytes and MXU flops at v5e and v5p, ``simulate
   --validate=strict`` prices it; (g) ``lint --perf`` and ``perf-report``
   (text and JSON) of ``llama_tiny_tp2dp2`` at v5p print what the CPU
   prints, by bytes.
15. observability and the trace tools on the card's host, the kernels'
   counters set to 0 just before each part and read just after (they
   must stay 0): (a) the five golden cells through ``simulate_trace``
   with an instrumentation hub, each beside the plain run: the golden
   passes without the ``obs_*`` and ``fastpath_*`` keys, the other stats
   equal the plain run's, the spans ``parse``, ``simulate`` and
   ``simulate/engine`` recorded, the export valid under
   ``ci/obs_schema.json`` and its ``samples.jsonl`` and ``trace.json``
   equal by sha256 to the CPU run's (:data:`OBS_DIGESTS`); then
   ``simulate llama_tiny_tp2dp2 --arch v5p --obs-out DIR`` in a fresh
   process, held the same way; (b) the ``link_down`` and ``hbm_throttle``
   example schedules on the llama cell at v5p on the detailed network:
   the ``faults_active`` track, the worst link occupancy and the
   ``ici.detailed.*`` counters (:data:`OBS_FAULT_COUNTERS`); (c)
   ``profile`` of the llama cell: depth-0 phases cover at least 90% of
   the measured total, the top-op table the CPU's; (d) ``timeline
   --counters``, ``aerial --power --gz``, ``bbv --out``, ``occupancy`` and
   a scripted ``debug`` on ``matmul_512`` at v5e and the llama module at
   v5p, each output the CPU's (:data:`TOOL_DIGESTS`).
16. streaming pricing and the offline harness on the card's host, the
   kernels' counters set to 0 just before each part run in this process
   and read just after (they must stay 0), (a)'s fresh processes and (b)
   and (c) in the background while (d) runs: (a) a synthetic module just
   over 64 MiB (``tests/test_fastpath.py``'s generator,
   :data:`STREAM_COMPS` computations, 91 MB) simulated in fresh
   processes, streamed by the default threshold (``serial``;
   ``vectorized`` with every default, whose peak RSS over its import
   floor must stay below 0.35 x the file; ``vectorized`` with a cold
   compile store: a lean ``.cmod``, at most 8 computations parsed, no
   per-op aggregates) and in memory (``serial``, ``vectorized``), then
   warm from the store in this process (0 IR ops built), all six stats
   equal; (b) ``derive-arch`` ==
   ``configs/v5p.derived.flags`` by bytes; (c) ``correl-regen`` ==
   ``reports/correl_ops.json`` and ``async_observable.json``, the refined
   overlay's sha256 the CPU's (:data:`REFINE_DIGEST`), the full ``loo``
   == ``reports/loo.json`` within 1e-3 on its rounded fields (model and
   package versions masked); (d) ``run -B ubench -C v5e --capture`` over
   a trace root seeded with phases 11, 12 and 14's captures: its capture
   job captures ``flash_attention_pallas`` on the card in a fresh process
   (the module phase 4's by bytes), every simulate job prints the exit
   sentinel; ``stats-diff`` of the tree against itself and against a copy
   with one stat changed (exit 1 under ``--check``, naming the stat).
17. the serving plane on the card's host (``tpusim_torch.serve``), the
   kernels' counters set to 0 at the phase's start and read at its end
   (they must stay 0), (d)'s fresh processes started first and run beside
   (a)-(c): (a) ``ci/check_golden.py``'s serve smoke on a daemon in this
   process: the golden matrix served cold equals ``ci/golden/*.json`` by
   the served-bytes canon (``_serve_served_bytes``, copied as data; the
   v6e power cell, which both packages miss by one ulp on Python 3.12,
   under phase 9's float rule), a warm pass all ``cache_hit`` with 0
   engine walks, ``/metrics`` parsing with the serve counters,
   ``/healthz`` ok, the drain complete; the warm served p50 of
   ``matmul_512`` @ v5e; (b) the same with two supervised workers forked
   from this process (0 walks here over both passes), then the chaos
   smoke (a worker SIGKILLed mid-matrix: 0 failed requests, every response
   the golden's, a restart) and the guard smoke's cooperative cancel (a
   request past its deadline answers 504 in-process, the worker keeps its
   pid and answers the next request warm, the counter on ``/metrics``);
   (c) the card's captures at registered width (phase 4's
   ``flash_attention_pallas``, phase 11's ten, phase 12's
   ``ici_allreduce``) served at v5e and v5p with the hot cache on, each
   equal by the canon to ``simulate_trace`` on the same dir, a repeat a
   hot hit with the same bytes; (d) ``python -m tpusim_torch serve
   --port 0 --serve-workers 2 --result-cache D --compile-cache D``
   answers a golden cell with the golden's bytes and under SIGTERM prints
   "drained, exiting" and exits 0; ``simulate --max-wall-s 1e-6`` exits
   3; ``simulate --max-rss`` below the RSS on ``decode_step`` (a serial
   walk of seconds) sheds and exits 3, and far above it prints the stats
   of the run without the flag; then the cold ``simulate`` process of
   ``matmul_512`` @ v5e alone, timed; ``TPUSIM_STREAM_THRESHOLD`` as it
   was.
18. the front tier, the sharded campaign, ``serve-bench``, the native
   bridges and the power fit on the card's host, the kernels' counters set
   to 0 at the phase's start and read at its end (they must stay 0), (b)
   first, then (c)'s two fresh processes in the background while (a), (d)
   and (e) run: (a) a
   ``FrontSupervisor`` of two acceptors forked from this process, on
   SO_REUSEPORT and then on the fd-passing fallback: the golden matrix
   served (fresh connections, so both acceptors serve) equals the goldens
   under phase 17's canon and float rule, a repeat the same bytes; one
   acceptor SIGKILLed under traffic (every request answered) and
   respawned; ``/metrics`` fleet-wide (two acceptors alive, the fleet's
   request count at least one acceptor's); (b) phase 9 (c)'s v5p 4x4x4
   campaign single-node, then on 3 forked nodes with one SIGKILLed once
   its journal holds scenarios (the survivors price the rest, nothing
   twice), then through the CLI over a dead node's half-done journal
   (``--nodes 3`` refused, ``--nodes 3 --resume`` finishes it): each
   merged ``report.json`` equal by bytes to the single-node one; (c)
   ``serve-bench --worker-sweep 0,2`` and ``--acceptor-sweep 1,2`` over
   the card's captures (``--reps 1``): every leg 0 errors and its requests
   answered; req/s and p50 per leg and the cold-CLI ratio printed; (d)
   ``libtpusim_native.so`` built from ``native/`` (its build seconds
   printed) and loaded: ``hlo_scan`` v2 parses every capture of phases 4,
   11 and 12 to the Python parser's ops; golden cells 1-5 and a module of
   long runs priced through ``native`` equal ``vectorized``'s stats, the
   long runs through the C scan; golden cell 4 through ``ici_net`` equals
   its Python backend's stats; each bridge's counter shows it ran; (e)
   ``tune --power`` for v5e and v5p into a temporary directory: the
   ``coefficients`` equal ``tpusim_torch/power/fitted/*.json``;
19. the live probes on the card (:data:`PROBE_STEPS`-step loops at
   registered width, device time from ``torch.profiler``): (a) ``tune()``
   on the card, its ``TunerResult`` printed, with no fit errors, no fall
   back to wall time, a link bandwidth only on a host of several cards,
   and achieved bf16 TFLOP/s and HBM GB/s above 0 and at most 1.05x the
   card's peaks; (b)
   ``correlate_workload`` on ``matmul``, ``elementwise_stream`` and
   ``flash_attention_pallas`` with an op profile, each timed on the
   device (``real_source == "device"``), sim and real seconds per step,
   the error and the idle share printed, flash's kernel launched there;
   (c) ``correlate-ops matmul_chain --json`` in a fresh process and
   ``correlate_workload_ops`` on ``flash_attention_pallas`` here: at least
   half the device time matched, and flash's ``custom-call`` row measured;
   (d) ``sample_workload_power`` on ``matmul`` for 3 s through NVML, its
   watts in (0, 1.05 x the power limit]; (e) the looped ``matmul``'s
   profiler busy time within [0.8, 1.02]x its CUDA-event wall time.
20. ranks as processes (``tpusim_torch.spmd_procs.RankGroup``: one
   spawned process a rank), the kernels' counters set to 0 at the start
   and read at the end (they must stay 0): (a) groups of 2, 4 and 8 rank
   processes, every rank on ``cuda:0``, joined over gloo (each collective
   staged through host memory), started at once: a collective probe
   (every collective, ``(2, 2)`` mesh on both axes in either order and on
   one, 1-D meshes of 8 and 2; data movement equal by bits to the vmap
   runner, float32 sums within 1e-6, bf16 within one rounding); then
   ``llama_tiny_tp2dp2`` (a snapshot of 2 launches), ``moe_ep4``,
   ``ulysses_attention_sp8``, ``ring_attention_sp8``, ``decode_step_tp8``
   and ``ici_allreduce`` over 2 ranks at registered width through
   ``snapshot_buffers`` and ``measure_wall_time`` on the group: every
   buffer against the vmap runner on the card (rtol = atol 1e-4
   float32, 2e-2 bfloat16, integers by bits), replicas equal bit for bit
   (``unshard``), the median step beside phase 12 (e)'s vmap median; (b)
   on a host with a card for each rank, the probe and the same workloads
   one rank a card over NCCL (the route ``ranks_for`` takes for capture
   and the probes) and ``tune``'s ``ici_link_bandwidth`` (phase 19 (a)'s
   fit over every card, none of its fit errors); on one card, what each
   needs.
21. the causal attention kernel (``csrc/flash_attention_wgmma.cu``), which
   the Llama decoder's eager bf16 forward on the card runs once a layer
   at head dim 128 (phase 13's ``llama7b`` check runs such a forward too;
   the counters of :data:`KERNELS` count the ported TPU kernels,
   ``causal_launch_count`` this kernel's launches):
   (a) the kernel against its plain version in bf16 at each benchmark
   cell's attention shape (atol = rtol 1e-2) and at its edges at head dim
   128 (one row, 130, 200 and 333 rows, rep 1, 2 and 4, rows wider than
   their heads), and what the wrapper refuses (float32, head dim 64, rows
   TMA cannot address); (b) the kernel's time and host cost a call, its
   plain version's, the score chain's it replaced and PyTorch's SDPA as a
   yardstick at each of those shapes, with the bound; (c) one forward step
   of Mistral-7B and DeepSeek-LLM-7B (at a 2k cell's shape) and
   ``llama7b``: one launch a layer, the worst logit row against the score
   chain's within 0.5 (the benchmark's limit on ``logit_row_err``), each
   path's step time and peak memory; ``llama_tiny`` (head dim 32, outside
   the kernel's domain): no launch, the chain's logits; and
   ``LlamaForwardSharded`` (``llama_tiny`` at dim 512 in bf16, 4 heads of
   128, tp 2) with a rank process a rank on the card: one launch a layer
   on each rank, its logits against the chain's within 0.5; (d)
   ``llama_tiny`` and
   ``llama7b`` captured over CUDA arguments: the HLO text equal by bytes
   to the capture over meta tensors and to the parent commit's
   (:data:`CAUSAL_HLO_DIGESTS`), no launch; (e) the non-causal kernel's
   time at its registered shape beside PERF.md's kernel table
   (:data:`FLASH_TABLE_MS`), a reading, not a check.
   ``causal_alone()`` runs phases 1, 2 and 21 by themselves.
22. the causal kernel at two head dims, which DeepSeek-V2's latent
   attention (``tpusim_torch/models/deepseek_v2.py``) runs once a layer:
   (a) the kernel against its plain version at q.k head dim 192, value
   head dim 128 and the model's scale, v read in place from a wider row,
   in bf16 at the benchmark cell's shape [1, 16384, 16], at a short and an
   odd length and at one row and 130 and 200 rows (atol = rtol 1e-2), and
   what the wrapper refuses; (b) the kernel's time and host cost a call,
   the plain version's and PyTorch's SDPA as a yardstick at those shapes,
   with the bound, beside the kernel at head dim 128 at the 4k cell's
   shape and the non-causal kernel at its registered shape; (c) one
   forward of DeepSeek-V2-Lite at published widths and full depth over
   2048 tokens: one launch a layer, its logits against the score chain's
   within 0.5, and the busiest expert's tokens over the mean in each
   expert layer; ``deepseek_v2_tiny`` (head dims 32 / 16): no launch, the
   chain's logits.
   ``mla_alone()`` runs phases 1, 2 and 22 by themselves.
23. the RMSNorm kernel (``csrc/rms_norm.cu``), which every norm of both
   decoders' eager bf16 forwards on the card runs (the op
   ``tpusim_torch::rms_norm``; ``rn.launch_count`` counts its launches):
   (a) the kernel against the chain it replaced (atol = rtol 1e-2) at the
   cells' shapes, DeepSeek-V2-Lite's latent read from rows 576 apart, one
   row and 333 rows, eps 1e-5 and 1e-6, and what the wrapper refuses
   (float32, a misaligned base, a row stride or a width that is no
   multiple of 8), the two layouts also through the decoders' route,
   which takes them to the kernel, where they raise; (b) the kernel's
   time, the chain's and PyTorch's fused ``rms_norm`` as a yardstick at
   the three shapes of the cells' steps, each cycling through inputs L2
   cannot hold and queued behind a sleep on the card, so that the host's
   cost a call does not pace them, with the bound (one read and one
   write), and the host's cost a call, untraced, of the wrapper, of the
   decoders' route to it and of the chain; (c) one forward of
   Mistral-7B, DeepSeek-LLM-7B, ``llama7b``, ``llama_tiny``,
   DeepSeek-V2-Lite and ``deepseek_v2_tiny``: one launch a norm, the
   logits against the chains' (the forward with a gradient recorded)
   within 0.5.
   ``norm_alone()`` runs phases 1, 2 and 23 by themselves.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, the one before that the kernels' JSON
record (flash's launches: phases 4 and 19; the causal kernel's a step:
phases 21 and 22; the RMSNorm kernel's a forward: phase 23), the one
before that phase 23's (``norm: {...}``), phase 22's (``mla: {...}``),
phase 21's (``causal: {...}``), phase
20's (``ranks: {...}``), phase 19's (``probes: {...}``), phase 18's
(``front: {...}``), phase 17's
(``serve: {...}``), phase 16's
(``harness: {...}``), phase 15's
(``obs: {...}``), before it
phase 14's (``ubench: {...}``), phase 13's (``models: {...}``), phase 12's (``multidevice: {...}``),
phase 11's (``lowered: {...}``) and phase 10's (``advisor: {...}``).  Needs
no network and one card; exits non-zero without a CUDA device or without
the rest of the repository beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpusim_torch.__main__ import main as cli  # noqa: E402
from tpusim_torch.kernels import build  # noqa: E402
from tpusim_torch.kernels.bench import (  # noqa: E402
    REPS,
    SAMPLES,
    card,
    dadd_latency,
    inputs,
    time_ms,
)
from tpusim_torch.kernels import flash_attention as fa  # noqa: E402
from tpusim_torch.kernels import rms_norm as rn  # noqa: E402
from tpusim_torch.kernels import scan_rows as sr  # noqa: E402
from tpusim_torch.models.flash_attention import flash_attention  # noqa: E402
from tpusim_torch.fastpath import batch as fp_batch  # noqa: E402
from tpusim_torch.fastpath import price_module_batch, warm_states  # noqa: E402
from tpusim_torch.faults import (  # noqa: E402
    FAULT_KINDS,
    link_down_schedule,
    load_fault_schedule,
)
from tpusim_torch.ici.topology import torus_for  # noqa: E402
from tpusim_torch.obs import (  # noqa: E402
    Instrumentation,
    validate_obs_dir,
    write_obs_dir,
)
from tpusim_torch.guard.store import store_bytes  # noqa: E402
from tpusim_torch.perf.cache import (  # noqa: E402
    CachedEngine,
    ResultCache,
    clear_compiled_cache,
    result_to_doc,
)
from tpusim_torch.sim import driver as sim_driver  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace  # noqa: E402
from tpusim_torch.sim.stats import EXIT_SENTINEL  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch import spmd  # noqa: E402
from tpusim_torch.spmd import Mesh, P, SpmdModule  # noqa: E402
from tpusim_torch.harness.correl_ops import (  # noqa: E402
    correlate_workload_ops,
    measure_device_time,
)
from tpusim_torch.harness.correlate import (  # noqa: E402
    correlate_workload,
    loopify,
)
from tpusim_torch.harness.tuner import tune  # noqa: E402
from tpusim_torch.power.telemetry import sample_workload_power  # noqa: E402
from tpusim_torch.tracer.capture import (  # noqa: E402
    capture_to_dir,
    export_to_hlo,
    measure_wall_time,
    snapshot_buffers,
)

#: published H100 SXM peaks (NVIDIA data sheet, dense): the tensor cores in
#: TF32 (the fastest unit that takes f32 operands) and in bf16, f32 on the
#: CUDA cores (the bound as first stated, kept for comparison), and HBM3
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_CUDA_CORE_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: float64 on the CUDA cores (data sheet; the scan's adds are no matrix
#: product, so the FP64 tensor cores' 67 TFLOP/s do not apply)
PEAK_F64_FLOPS = 34e12
#: the kernel's f32 path takes three TF32 products per product (split TF32)
SPLIT_TF32_PRODUCTS = 3

#: registered width of flash_attention_pallas: batch 4 x heads 8, seq 1024,
#: head_dim 128
MAIN_SHAPE = (32, 1024, 128)

#: f32: the kernel and the plain version both accumulate in f32; they differ
#: in summation order (online softmax) and in the kernel's split-TF32
#: products (within 2^-21 of f32 per operand); 2e-5 is the JAX package's own
#: tolerance for this kernel
ATOL_F32 = 2e-5
#: bf16: both compute in f32 from the same bf16 inputs and round the output
#: once to bf16 (relative spacing 2^-8), so f32 results a hair apart can
#: round one bf16 ulp apart: at most 2^-7 |x| <= 1e-2 |x|, plus 1e-2 near 0.
#: The kernel also rounds P once to bf16 for its P V product (2.0e-3 at the
#: main shape in a CPU emulation, 16% of this budget)
TOL_BF16 = 1e-2

#: the golden matrix of ``ci/check_golden.py``: (fixture, arch, overlays,
#: golden file stem)
GOLDEN_CELLS = (
    ("matmul_512", "v5e", [], "matmul_512__v5e"),
    ("matmul_512", "v5p", [], "matmul_512__v5p"),
    ("llama_tiny_tp2dp2", "v5p", [], "llama_tiny_tp2dp2__v5p"),
    ("llama_tiny_tp2dp2", "v5p",
     [{"arch": {"ici": {"network_mode": "detailed"}}}],
     "llama_tiny_tp2dp2__v5p__arch.ici.network_mode=detailed"),
    ("llama_tiny_tp2dp2", "v6e", [{"power_enabled": True}],
     "llama_tiny_tp2dp2__v6e__power_enabled=True"),
)
FIXTURES = REPO / "tests" / "fixtures" / "traces"
VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
RTOL_GOLDEN = 1e-9

#: every ported TPU kernel: (name, source, TPU kernel it replaces, its
#: wrapper's launch counter and the counter's reset).  The causal attention
#: kernel (:data:`CAUSAL_SOURCE`) replaces none; phases 21 and 22 count its
#: launches (``fa.causal_launch_count``).  Nor does the RMSNorm kernel
#: (:data:`NORM_SOURCE`); phase 23 counts its launches
#: (``rn.launch_count``)
KERNELS = (
    ("flash_attention", "tpusim_torch/csrc/flash_attention.cu",
     "tpusim/models/pallas_attention.py:50", fa.launch_count,
     fa.reset_launch_count),
    # not a Pallas kernel: the counterpart of the JAX package's lane-axis
    # scan backend
    ("scan_rows", "tpusim_torch/csrc/scan_rows.cu",
     "tpusim/fastpath/jax_backend.py:74", sr.launch_count,
     sr.reset_launch_count),
)


#: host seconds of each phase, from its start to the next one's
PHASE_SECONDS: dict[int, float] = {}
_PHASE_START: list = []
#: wall seconds of each fresh process the current phase ran
_PROCESS_S: list[float] = []


def run_process(argv: list[str], **kw) -> subprocess.CompletedProcess:
    """``subprocess.run`` of a fresh process, its wall seconds kept for the
    phase's summary line."""
    t0 = time.perf_counter()
    try:
        return subprocess.run(argv, **kw)
    finally:
        _PROCESS_S.append(time.perf_counter() - t0)


def phase(n: int | None, title: str = "") -> None:
    """Start phase ``n`` (``None``: end the last one), printing how long
    the one before it took, and the fresh processes it ran."""
    now = time.perf_counter()
    if _PHASE_START:
        last, t0 = _PHASE_START.pop()
        PHASE_SECONDS[last] = now - t0
        procs = (f" ({len(_PROCESS_S)} fresh processes, "
                 f"{sum(_PROCESS_S):.1f} s)" if _PROCESS_S else "")
        print(f"  phase {last} took {now - t0:.1f} s{procs}", flush=True)
        _PROCESS_S.clear()
    if n is not None:
        _PHASE_START.append((n, now))
        print(f"== phase {n}: {title}", flush=True)


def compare_golden(name: str, stats: dict) -> list[str]:
    """``ci/check_golden.py``'s comparison rule, reading the goldens as data."""
    golden = json.loads((REPO / "ci" / "golden" / f"{name}.json").read_text())
    errors = []
    for key in sorted(set(golden) | set(stats)):
        if key in VOLATILE:
            continue
        if key not in golden or key not in stats:
            errors.append(f"{name}: stat {key} only on one side")
            continue
        g, s = golden[key], stats[key]
        if isinstance(g, (int, float)) and isinstance(s, (int, float)):
            if abs(g - s) > RTOL_GOLDEN * max(abs(g), abs(s), 1e-30):
                errors.append(f"{name}: {key} {g!r} -> {s!r}")
        elif g != s:
            errors.append(f"{name}: {key} {g!r} -> {s!r}")
    return errors


def run_cli(argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    if rc != 0:
        raise RuntimeError(f"tpusim_torch {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def golden_cells(card_name: str) -> None:
    """The five golden cells against ``ci/golden/*.json``, each with its
    host seconds.  Raises on any difference."""
    for fixture, arch, overlays, golden in GOLDEN_CELLS:
        t0 = time.perf_counter()
        report = simulate_trace(FIXTURES / fixture, arch=arch,
                                overlays=list(overlays), tuned=False)
        host_s = time.perf_counter() - t0
        stats = json.loads(report.stats.to_json())
        errors = compare_golden(golden, stats)
        if errors:
            raise AssertionError("\n".join(errors))
        print(f"  golden {golden}: {len(stats)} stats match; host "
              f"{host_s:.4f} s (card: {card_name})")


def simulate_cells(card_name: str) -> None:
    """Phase 4, simulate half: the five golden cells, then the
    multi-device path through the CLI with the kernels' counters set to 0
    just before and read just after.  Raises on any difference."""
    golden_cells(card_name)

    # the multi-device path: collectives on the detailed ICI network and
    # the power model, through the CLI; host Python, no kernel
    for *_, reset in KERNELS:
        reset()
    t0 = time.perf_counter()
    text = run_cli(["simulate", str(FIXTURES / "llama_tiny_tp2dp2"),
                    "--arch", "v5p", "--network-mode", "detailed", "--power"])
    host_s = time.perf_counter() - t0
    sim_launches = {name: count() for name, _, _, count, _ in KERNELS}
    lines = text.splitlines()
    if lines[-1] != EXIT_SENTINEL or "TPUWattch power report" not in lines:
        raise AssertionError("simulate --network-mode detailed --power: "
                             "no exit sentinel or power report")
    picked = {ln.split(" = ")[0]: ln for ln in lines if " = " in ln}
    for key in ("tpusim_sim_cycle", "tpusim_tot_collective_count",
                "tpusim_power_avg_watts"):
        if key not in picked:
            raise AssertionError(f"multi-device simulate: no {key} line")
        print(f"  {picked[key]}")
    watts = float(picked["tpusim_power_avg_watts"].split(" = ")[1])
    if picked["tpusim_tot_collective_count"] != "tpusim_tot_collective_count = 14" \
            or not math.isfinite(watts) or watts <= 0:
        raise AssertionError(f"multi-device simulate: {picked}")
    print(f"simulate llama_tiny_tp2dp2 --arch v5p --network-mode detailed "
          f"--power: host {host_s:.4f} s (card: {card_name}); kernel "
          f"launches {sim_launches} (this path runs on the host)")


#: phase 3: (shape, dtype, block_q).  The main path's shapes first; then
#: a sequence that is no multiple of the 64-key tile with head dim 80
#: (zero-padded to 128), small head dims, and head dim 50, whose rows are
#: not whole 16-byte chunks (loaded element by element)
CHECKS = (
    (MAIN_SHAPE, torch.float32, 128),
    (MAIN_SHAPE, torch.bfloat16, 128),
    ((2, 256, 64), torch.float32, 128),
    ((2, 192, 32), torch.float32, 64),
    ((3, 96, 80), torch.float32, 32),
    ((2, 192, 32), torch.bfloat16, 64),
    ((2, 80, 50), torch.float32, 16),
)


#: the causal attention kernel, which replaces the decoders' score chain
CAUSAL_SOURCE = ("tpusim_torch/csrc/flash_attention_wgmma.cu "
                 "(tpusim_causal_attention_wgmma_fwd)")
NORM_SOURCE = "tpusim_torch/csrc/rms_norm.cu (tpusim_rms_norm_fwd)"
#: sources built in phase 2: every kernel, and the instruction probes whose
#: dependent-add latency phase 6 (d) reads
BUILT = tuple(k[0] for k in KERNELS) + ("flash_attention_wgmma",
                                        "rms_norm", "mma_probe")
#: ptxas notes that undo a design: wgmma serialized (C7520), a register
#: budget the warp-specialised kernel asked for and did not get (C7508)
PTXAS_REFUSED = ("C7520", "C7508")


def build_kernels() -> None:
    """Phase 2: build every kernel and the probes, one nvcc per source, all
    started together; print ptxas's registers, shared memory, spills and
    wgmma notes, and fail on a spill in a kernel or on a note of
    :data:`PTXAS_REFUSED`."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(BUILT)) as pool:
        libs = list(pool.map(build.build_library, BUILT))
    for name, so in zip(BUILT, libs):
        log = (so.parent / "build.log").read_text()
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line \
                    or "(C75" in line:
                print(f"  ptxas {name}: {line.strip()}")
            if any(f"({code})" in line for code in PTXAS_REFUSED):
                raise AssertionError(f"{name}: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                               line)
            if name != "mma_probe" and spills and spills.groups() != ("0", "0"):
                raise AssertionError(f"{name} spills: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")


def check_kernels() -> dict:
    """Phase 3: every kernel against its plain version on the card; returns
    the max abs error by (shape, dtype).  Raises on a disagreement."""
    errs = {}
    for shape, dtype, block_q in CHECKS:
        q, k, v = inputs(shape, dtype, seed=1)
        got = flash_attention(q, k, v, block_q=block_q)
        want = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        if dtype == torch.float32:
            ok = err <= ATOL_F32
            tol = f"atol {ATOL_F32}"
        else:
            ok = bool((diff <= TOL_BF16 + TOL_BF16 * want.float().abs()).all())
            tol = f"atol {TOL_BF16} + rtol {TOL_BF16}"
        ok = ok and bool(torch.isfinite(got.float()).all())
        print(f"  {list(shape)} {str(dtype)[6:]} block_q {block_q}: max "
              f"|kernel - plain| {err:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees at {shape} {dtype}")
        errs[(shape, dtype)] = err
    return errs


def time_attention(dtype: torch.dtype, card_name: str) -> dict:
    """Phase 5 for one input type at the main shape: kernel, plain version
    and ``scaled_dot_product_attention`` times, and the card's bound."""
    bh, s, d = MAIN_SHAPE
    name = str(dtype)[6:]
    q, k, v = inputs(MAIN_SHAPE, dtype, seed=3)
    out = {
        "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v)),
        "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
        # the same call on a [batch, heads, S, D] view: PyTorch then picks a
        # fused backend (on [BH, S, D] it takes its unfused math path)
        "library_fused_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *(x.view(4, bh // 4, s, d) for x in (q, k, v)))),
    }
    flops = 4.0 * bh * s * s * d
    nbytes = 4 * q.numel() * q.element_size()
    peak, unit = ((PEAK_TF32_FLOPS, "TF32") if dtype == torch.float32
                  else (PEAK_BF16_FLOPS, "bf16"))
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    out["bound_ms"] = max(ops_ms, bytes_ms)
    out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    for label, what in (("ms", "kernel"), ("plain_ms", "plain"),
                        ("library_ms", "library_sdpa"),
                        ("library_fused_ms", "library_sdpa_4d")):
        print(f"time {what}: {out[label]:.4f} ms at {list(MAIN_SHAPE)} {name}, "
              f"median of {SAMPLES} x {REPS} back-to-back calls (card: {card_name})")
    print(f"time bound: {out['bound_ms']:.4f} ms = max({flops:.4g} flop / "
          f"{peak / 1e12:.0f} TFLOP/s {unit}, {nbytes} B / 3.35 TB/s), from the "
          f"published H100 SXM peaks; the kernel reaches "
          f"{out['bound_ms'] / out['ms']:.1%} of it and takes "
          f"{out['ms'] / out['library_ms']:.3f} x the library's time "
          f"({out['ms'] / out['library_fused_ms']:.3f} x its fused backend's) "
          f"(card: {card_name})")
    if dtype == torch.float32:
        split_ms = SPLIT_TF32_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3
        core_ms = flops / PEAK_F32_CUDA_CORE_FLOPS * 1e3
        out["bound_split_tf32_ms"] = max(split_ms, bytes_ms)
        out["bound_cuda_core_ms"] = max(core_ms, bytes_ms)
        print(f"time bound split TF32: {out['bound_split_tf32_ms']:.4f} ms "
              f"({SPLIT_TF32_PRODUCTS} TF32 products a product); the kernel "
              f"reaches {out['bound_split_tf32_ms'] / out['ms']:.1%} of it")
        print(f"time bound f32 CUDA cores: {out['bound_cuda_core_ms']:.4f} ms "
              f"(67 TFLOP/s, the bound as first stated)")
    return out


#: garbage-collection pauses at or above this are printed (phases 6 a, 8 b)
GC_PAUSE_S = 0.010
#: phase 6 (b): degraded lanes of the batched pricing call, and the seed of
#: their (clock_scale, hbm_scale) draws
BATCH_LANES = 64
BATCH_SEED = 7
#: phase 6 (c): scan_rows shapes (lanes x ops) and the seed of the matrices
SCAN_LANES = (1, 64, 4096)
SCAN_OPS = (1, 47, 4096)
SCAN_SEED = 11
#: the shape timed for the kernels' record: the batched call's 64 lanes
#: over the longest run of (c)
SCAN_TIMED = (64, 4096)


def host_ms(fn, samples: int = 7) -> float:
    """Median host-clock milliseconds of ``fn`` over ``samples`` calls,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def without_fastpath(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if not k.startswith("fastpath_")}


@contextlib.contextmanager
def watch_host():
    """While the block runs, record in this process every garbage-
    collection pause (generation, seconds, objects collected) and the
    seconds of each ``load_trace`` the driver makes."""
    rec = {"gc": [], "load_s": []}
    marks = {}

    def on_gc(phase_, info):
        if phase_ == "start":
            marks["gc"] = time.perf_counter()
        else:
            rec["gc"].append([info["generation"],
                              time.perf_counter() - marks["gc"],
                              info["collected"]])

    load = sim_driver.load_trace

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        try:
            return load(*a, **k)
        finally:
            rec["load_s"].append(time.perf_counter() - t0)

    sim_driver.load_trace = timed_load
    gc.callbacks.append(on_gc)
    try:
        yield rec
    finally:
        gc.callbacks.remove(on_gc)
        sim_driver.load_trace = load


def fastpath_cells(card_name: str) -> dict:
    """Phase 6 (a): golden cells 1-5 under the serial walk and the
    vectorized fastpath (cold: compiled columns cleared first; warm: the
    compiled-module tier holds them).  Every report must pass its golden,
    and the backends' stats must be equal apart from ``fastpath_*`` and
    the host-time keys.  Returns, by (golden, run), the host seconds of
    the whole call and of its replay alone (``SimReport.wall_seconds``:
    pricing and command stream, without loading and parsing the trace),
    and prints the ``load_trace`` seconds of each call beside them, with
    any GC pause of :data:`GC_PAUSE_S` or more."""
    seconds = {}
    for fixture, arch, overlays, golden in GOLDEN_CELLS:
        runs = {}
        loads = {}
        for run, backend in (("serial", "serial"),
                             ("vectorized_cold", "vectorized"),
                             ("vectorized_warm", "vectorized")):
            if run == "vectorized_cold":
                clear_compiled_cache()
            with watch_host() as watched:
                t0 = time.perf_counter()
                report = simulate_trace(FIXTURES / fixture, arch=arch,
                                        overlays=list(overlays), tuned=False,
                                        pricing_backend=backend)
                seconds[(golden, run)] = (time.perf_counter() - t0,
                                          report.wall_seconds)
            loads[run] = sum(watched["load_s"])
            for g, dt, n in watched["gc"]:
                if dt >= GC_PAUSE_S:
                    print(f"  GC pause in {golden} {run}: generation {g}, "
                          f"{dt * 1e3:.1f} ms, {n} collected (card: "
                          f"{card_name})")
            stats = json.loads(report.stats.to_json())
            if stats.get("fastpath_backend") != backend:
                raise AssertionError(f"{golden} {run}: fastpath_backend "
                                     f"{stats.get('fastpath_backend')!r}")
            errors = compare_golden(golden, without_fastpath(stats))
            if errors:
                raise AssertionError("\n".join(errors))
            runs[run] = {k: v for k, v in without_fastpath(stats).items()
                         if k not in VOLATILE}
        if not runs["serial"] == runs["vectorized_cold"] == runs["vectorized_warm"]:
            raise AssertionError(f"{golden}: serial and vectorized stats differ")
        print(f"  golden {golden}: serial and vectorized pass, stats equal; "
              "host s (whole call / load_trace / replay alone): " + ", ".join(
                  f"{run} {seconds[(golden, run)][0]:.4f} / "
                  f"{loads[run]:.4f} / {seconds[(golden, run)][1]:.4f}"
                  for run in runs)
              + f" (card: {card_name})")
    return seconds


def batch_module_and_engines():
    """Phase 6 (b)'s inputs: ``llama_tiny_tp2dp2``'s module at v5p and a
    maker of its 64 degraded lanes' engines (scales in (0.5, 1])."""
    scales = 1.0 - 0.5 * np.random.default_rng(BATCH_SEED).random(
        (BATCH_LANES, 2))
    cfg = load_config(arch="v5p")
    [module] = load_trace(FIXTURES / "llama_tiny_tp2dp2").modules.values()

    def engines():
        return [Engine(cfg, clock_scale=float(c), hbm_scale=float(h))
                for c, h in scales]
    return module, engines


def docs(results) -> list[str]:
    return [json.dumps(result_to_doc(r)) for r in results]


def run_steps(cm, comp: str, depth: int = 0) -> int:
    """Run steps the batched walk visits from ``comp`` (a while body's, a
    callee's and every branch's once per visit): the ``cuda`` route's
    launches when no lane's accumulators diverge."""
    if depth > 32:
        return 0
    n = 0
    for step in cm.comp(comp).steps:
        if step[0] == "run":
            n += 1
        elif step[0] in ("while", "call"):
            n += run_steps(cm, step[4], depth + 1)
        elif step[0] == "cond":
            n += sum(run_steps(cm, b, depth + 1) for b in step[4])
    return n


def batch_on_card(module, engines) -> dict:
    """Phase 6 (b): the batched pricing call with its row scans on the
    card, the kernels' counters set to 0 just before and read just after
    (one ``scan_rows`` launch per run step); every lane against the host
    row scans and against its serial walk."""
    from tpusim_torch.fastpath.price import entry_of
    from tpusim_torch.perf.cache import compiled_for

    lanes_engines = engines()
    cm = compiled_for(module, lanes_engines[0])
    steps = run_steps(cm, entry_of(module, cm))
    for *_, reset in KERNELS:
        reset()
    with scan_lanes() as lanes:
        got = price_module_batch(module, lanes_engines, backend="cuda")
        torch.cuda.synchronize()
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    print(f"  price_module_batch llama_tiny_tp2dp2 @ v5p, {BATCH_LANES} lanes, "
          f"backend cuda: kernel launches {launches}; {steps} run steps; "
          f"{lanes_text(lanes)} a call")
    if launches["scan_rows"] != steps or len(lanes) != steps:
        raise AssertionError(f"the batched pricing call launched scan_rows "
                             f"{launches['scan_rows']} times for {steps} run "
                             f"steps")
    got = docs(got)
    host = docs(price_module_batch(module, engines(), backend="vectorized"))
    serial = docs(e._run_serial(module) for e in engines())
    if got != host or got != serial:
        bad = [s for s in range(BATCH_LANES)
               if not got[s] == host[s] == serial[s]]
        raise AssertionError(f"batched lanes differ at {bad[:8]}")
    cycles = [json.loads(d)["cycles"] for d in got]
    if not all(math.isfinite(c) and c > 0 for c in cycles):
        raise AssertionError("non-finite or empty lane cycles")
    print(f"  every lane equals the host row scans and its serial walk; "
          f"cycles {min(cycles):.6g} .. {max(cycles):.6g}")
    return launches


def scan_inputs(lanes: int, ops: int, seed: int):
    """Seeded ``[lanes]`` seeds and an ops-major ``[ops, lanes]`` matrix,
    float64, log-uniform from 1e-3 to 1e9, on the CPU."""
    vals = np.exp(np.random.default_rng(seed).uniform(
        math.log(1e-3), math.log(1e9), size=(ops + 1, lanes)))
    return torch.from_numpy(vals[0].copy()), torch.from_numpy(vals[1:].copy())


def check_scan_rows() -> float:
    """Phase 6 (c): the kernel against its plain version by bytes at every
    (lanes, ops) shape; returns the largest absolute difference (0)."""
    worst = 0.0
    for lanes in SCAN_LANES:
        for ops in SCAN_OPS:
            seeds, mat = scan_inputs(lanes, ops, SCAN_SEED)
            got = sr.scan_rows(seeds.cuda(), mat.cuda()).cpu()
            want = sr.scan_rows_reference(seeds, mat)
            same = got.numpy().tobytes() == want.numpy().tobytes()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            print(f"  scan_rows [{ops}, {lanes}]: bytes "
                  f"{'equal' if same else 'DIFFER'} to the plain version "
                  f"(max abs diff {err:.3g})")
            if not same:
                raise AssertionError(f"scan_rows differs at {lanes} x {ops}")
    return worst


#: phase 6 (c): ragged segments over a [RAGGED_OPS, S] matrix — a run,
#: empty ones (whole chain and end only), one row, repeated and unsorted
#: rows, and one longer than the kernel's ring — at these lane counts, on
#: an ops-major matrix and on one column shared by every lane (stride 0)
RAGGED_OPS = 4096
RAGGED = (
    (list(range(3, 20)), True),
    ([], True),
    ([7], False),
    ([], False),
    ([5, 5, 5, 2], False),
    ([4095, 0, 17, 8, 8, 30], True),
    (list(range(RAGGED_OPS))[::-1], True),
    (list(range(0, RAGGED_OPS, 3)), False),
)
RAGGED_LANES = (1, 32, 33, 746)
#: phase 6 (c, d): the lanes of a 1024-scenario campaign's warm group
#: (phase 9 c), beside phase 6 (b)'s 64
CAMPAIGN_LANES = 746


def log_uniform(shape, seed: int) -> torch.Tensor:
    """Seeded float64 values, log-uniform from 1e-3 to 1e9, on the CPU."""
    return torch.from_numpy(np.exp(np.random.default_rng(seed).uniform(
        math.log(1e-3), math.log(1e9), size=shape)))


@contextlib.contextmanager
def step_scans():
    """Record the (plan, seeds, matrix on the card) of every launch the
    ``cuda`` route makes."""
    rec = []
    real = fp_batch._CardScans.scan

    def scan(self, plan, seeds, mat=None, column=None):
        rec.append((plan, seeds, mat if column is None else column.cuda()))
        return real(self, plan, seeds, mat=mat, column=column)
    fp_batch._CardScans.scan = scan
    try:
        yield rec
    finally:
        fp_batch._CardScans.scan = real


def segment_args(plan, seeds: torch.Tensor, mat: torch.Tensor) -> tuple:
    """``scan_segments``' arguments on the card for a plan, ``[n_seg, S]``
    seeds and a matrix (``[n]``: one column shared by every lane)."""
    table, idx = plan.split(plan.head.cuda())
    seeds = seeds.cuda()
    mat = mat.cuda()
    if mat.dim() == 1:
        mat = mat[:, None].expand(mat.shape[0], seeds.shape[1])
    return mat, idx, table, seeds, plan.out_rows


def path_steps(module, engines) -> list:
    """The plans, seeds and matrices of the ``cuda`` route's launches in
    phase 6 (b)'s call."""
    with step_scans() as rec:
        price_module_batch(module, engines(), backend="cuda")
    torch.cuda.synchronize()
    return rec


def check_scan_segments(steps) -> float:
    """Phase 6 (c), the segmented entry: the kernel against its plain
    version by bytes on every step launch of (b) (64 lanes), on the same
    steps at :data:`CAMPAIGN_LANES` lanes, and on :data:`RAGGED` at
    :data:`RAGGED_LANES` lanes, ops-major and at lane stride 0; returns
    the largest absolute difference (0)."""
    cases = []
    for i, (plan, seeds, mat) in enumerate(steps):
        cases.append((f"llama step {i}", plan,
                      torch.tensor(seeds, dtype=torch.float64), mat))
        cases.append((f"llama step {i}", plan,
                      log_uniform((plan.n_seg, CAMPAIGN_LANES), SCAN_SEED + i),
                      log_uniform((mat.shape[0], CAMPAIGN_LANES), SCAN_SEED)))
    ragged = sr.pack_segments(RAGGED)
    for lanes in RAGGED_LANES:
        seeds = log_uniform((len(RAGGED), lanes), SCAN_SEED + lanes)
        cases.append(("ragged", ragged, seeds,
                      log_uniform((RAGGED_OPS, lanes), SCAN_SEED)))
        cases.append(("ragged, lane stride 0", ragged, seeds,
                      log_uniform((RAGGED_OPS,), SCAN_SEED)))
    worst = 0.0
    for what, plan, seeds, mat in cases:
        args = segment_args(plan, seeds, mat)
        got = sr.scan_segments(*args).cpu()
        want = sr.scan_segments_reference(*(a.cpu() for a in args[:4]),
                                          plan.out_rows)
        same = got.numpy().tobytes() == want.numpy().tobytes()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        if not same or what.startswith(("ragged", "llama step 0")):
            print(f"  scan_segments {what}, {plan.n_seg} segments of "
                  f"{min(n for _, n, _ in plan.spans)}-"
                  f"{max(n for _, n, _ in plan.spans)} rows, "
                  f"{seeds.shape[1]} lanes: bytes "
                  f"{'equal' if same else 'DIFFER'} to the plain version "
                  f"(max abs diff {err:.3g})")
        if not same:
            raise AssertionError(f"scan_segments differs: {what}, "
                                 f"{seeds.shape[1]} lanes")
    print(f"  scan_segments: {len(cases)} cases equal by bytes to the plain "
          f"version ({len(steps)} llama steps at {BATCH_LANES} and "
          f"{CAMPAIGN_LANES} lanes, ragged and stride-0 at {RAGGED_LANES})")
    return worst


#: phase 6 (d): calls a device timing enqueues behind one sleep kernel of
#: DEVICE_SLEEP cycles (about 2 ms), longer than the host takes to enqueue
#: them
DEVICE_REPS = 40
DEVICE_SLEEP = 4_000_000


def device_ms(fn) -> float:
    """The card's time for one call of ``fn``, median of SAMPLES: a sleep
    kernel holds the card while the host enqueues DEVICE_REPS calls, so
    the events around them time the card's work and not the host's
    enqueueing (at a run step's shapes a call's host work outlasts its
    kernel)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(DEVICE_SLEEP)
        start.record()
        for _ in range(DEVICE_REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / DEVICE_REPS)
    return statistics.median(times)


def time_steps(steps, card_name: str) -> dict:
    """Phase 6 (d), the time the path pays: each of (b)'s step launches at
    64 and :data:`CAMPAIGN_LANES` lanes: the wrapper's call back to back
    (CUDA events; at these shapes its host work, a launch's overhead), the
    kernel on the card (:func:`device_ms`), and the route's whole round
    trip (host clock: staging, the copy over, the launch, the copy back and
    the synchronisation); min / median / max over the steps and their sum,
    a batched call's scan time."""
    card = fp_batch._CardScans("cuda")
    out = {}
    for lanes in (BATCH_LANES, CAMPAIGN_LANES):
        call, device, trip = [], [], []
        for i, (plan, seeds, mat) in enumerate(steps):
            if lanes != BATCH_LANES:
                seeds = log_uniform((plan.n_seg, lanes), SCAN_SEED + i).tolist()
                mat = log_uniform((mat.shape[0], lanes), SCAN_SEED).cuda()
            args = segment_args(plan, torch.tensor(seeds, dtype=torch.float64),
                                mat)
            call.append(time_ms(lambda: sr.scan_segments(*args)))
            device.append(device_ms(lambda: sr.scan_segments(*args)))
            trip.append(host_ms(lambda: card.scan(plan, seeds, mat=mat),
                                samples=9))
        out[lanes] = {"call_ms": call, "device_ms": device,
                      "round_trip_ms": trip}
        rows = [n for p, _, _ in steps for _, n, _ in p.spans]
        print(f"time scan_segments, {len(steps)} llama step launches at "
              f"{lanes} lanes ({min(rows)}-{max(rows)} rows a segment), min / "
              f"median / max and sum over the steps: the wrapper's call "
              f"{min(call):.4f} / {statistics.median(call):.4f} / "
              f"{max(call):.4f} ms, sum {sum(call):.4f} (CUDA events, back to "
              f"back); the kernel on the card {min(device):.4f} / "
              f"{statistics.median(device):.4f} / {max(device):.4f} ms, sum "
              f"{sum(device):.4f}; the round trip {min(trip):.4f} / "
              f"{statistics.median(trip):.4f} / {max(trip):.4f} ms, sum "
              f"{sum(trip):.4f} (host clock) (card: {card_name})")
    return out


def time_fastpath(module, engines, steps, card_name: str) -> dict:
    """Phase 6 (d): the batched call under both backends (host clock), the
    step launches of (b) (:func:`time_steps`), the latency of a dependent
    float64 add, and scan_rows at every shape of (c): kernel (CUDA
    events), plain version and host row scan (host clock), torch.cumsum on
    the card as the yardstick, the chain floor and the bound."""
    out = {}
    for backend in ("cuda", "vectorized"):
        out[f"batch_{backend}_ms"] = host_ms(
            lambda: price_module_batch(module, engines(), backend=backend),
            samples=5)
    out["serial_walk_ms"] = host_ms(
        lambda: [e._run_serial(module) for e in engines()], samples=3)
    print(f"time price_module_batch {BATCH_LANES} lanes: cuda "
          f"{out['batch_cuda_ms']:.2f} ms, vectorized "
          f"{out['batch_vectorized_ms']:.2f} ms, the lanes' serial walks "
          f"{out['serial_walk_ms']:.2f} ms (host clock, median; card: "
          f"{card_name})")
    out["steps"] = time_steps(steps, card_name)
    lat = dadd_latency()
    out["dadd"] = lat
    print(f"latency of a dependent __dadd_rn: {lat['cycles_per_add']:.3f} "
          f"cycles, {lat['ns_per_add']:.4f} ns at {lat['clock_ghz']:.3f} GHz "
          f"(one warp, {lat['adds']} adds; card: {card_name})")
    for lanes in SCAN_LANES:
        for ops in SCAN_OPS:
            seeds, mat = scan_inputs(lanes, ops, SCAN_SEED + 1)
            seeds_d, mat_d = seeds.cuda(), mat.cuda()
            rows = mat.t().contiguous()
            t = {
                "ms": time_ms(lambda: sr.scan_rows(seeds_d, mat_d)),
                "plain_ms": host_ms(
                    lambda: sr.scan_rows_reference(seeds, mat), samples=3),
                "host_vectorized_ms": host_ms(
                    lambda: fp_batch._scan_rows_host(seeds, rows), samples=3),
            }
            full = torch.cat([seeds_d[None], mat_d])
            t["library_ms"] = time_ms(lambda: torch.cumsum(full, 0))
            t["library_bytes_equal"] = (
                torch.cumsum(full, 0).cpu().numpy().tobytes()
                == sr.scan_rows_reference(seeds, mat).numpy().tobytes())
            nbytes = 2 * lanes * (ops + 1) * 8
            bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
            # a lane's adds are dependent: the operations take at least the
            # chain (k adds, each one dependent add's latency), and at least
            # all of them at the f64 peak rate
            t["chain_floor_ms"] = ops * lat["ns_per_add"] * 1e-6
            ops_ms = max(lanes * ops / PEAK_F64_FLOPS * 1e3,
                         t["chain_floor_ms"])
            t["bound_ms"] = max(bytes_ms, ops_ms)
            t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
            print(f"time scan_rows [{ops}, {lanes}]: kernel {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, host row scan "
                  f"{t['host_vectorized_ms']:.4f} ms, torch.cumsum on the "
                  f"card {t['library_ms']:.4f} ms (bytes equal: "
                  f"{t['library_bytes_equal']}), bound {t['bound_ms']:.6f} ms "
                  f"({t['bound_by']}: {nbytes} B / 3.35 TB/s = "
                  f"{bytes_ms:.6f} ms; chain floor {ops} dependent adds x "
                  f"{lat['ns_per_add']:.4f} ns = {t['chain_floor_ms']:.6f} ms; "
                  f"{lanes * ops} adds / 34 TFLOP/s f64); the kernel reaches "
                  f"{t['bound_ms'] / t['ms']:.1%} of the bound (card: "
                  f"{card_name})")
            out[(lanes, ops)] = t
    return out


#: phase 7: the faults contract, read as data, and the pool's width
FAULTS_SCHEMA = REPO / "ci" / "faults_schema.json"
POOL_WORKERS = 4


def stats_of(report, drop: tuple[str, ...] = ()) -> dict:
    """A report's stats without the host-time keys and the prefixes in
    ``drop``."""
    return {k: v for k, v in json.loads(report.stats.to_json()).items()
            if k not in VOLATILE and not k.startswith(drop)}


def faults_smoke(card_name: str) -> dict:
    """Phase 7 (a): ``ci/check_golden.py``'s faults smoke contract, run
    against the port.  Raises on a violation; returns its summary."""
    t0 = time.perf_counter()
    schema = json.loads(FAULTS_SCHEMA.read_text())
    if set(schema["fault_kinds"]) != set(FAULT_KINDS):
        raise AssertionError(f"schema kinds {sorted(schema['fault_kinds'])} "
                             f"!= FAULT_KINDS {sorted(FAULT_KINDS)}")
    for kind, doc in schema["example_schedules"].items():
        sched = load_fault_schedule(doc)
        if not sched.faults or sched.faults[0].kind != kind \
                or load_fault_schedule(sched.to_doc()) != sched:
            raise AssertionError(f"example schedule {kind!r} did not round-trip")
    trace = FIXTURES / "llama_tiny_tp2dp2"
    healthy = simulate_trace(trace, arch="v5p", tuned=False)
    leaked = [k for k in healthy.stats.values if k.startswith("faults_")]
    if leaked:
        raise AssertionError(f"healthy run leaked fault stats {leaked}")
    topo = torus_for(healthy.num_devices, "v5p")
    a, b = topo.undirected_links()[0]
    faulted = simulate_trace(trace, arch="v5p", tuned=False,
                             faults=link_down_schedule(topo, a, b),
                             topology=topo)
    missing = [k for k in schema["stats_required_when_active"]
               if k not in faulted.stats.values]
    if missing:
        raise AssertionError(f"faulted run misses stats keys {missing}")
    h_coll = healthy.stats.get("tot_collective_cycles", 0.0)
    f_coll = faulted.stats.get("tot_collective_cycles", 0.0)
    if not (f_coll > h_coll and faulted.cycles > healthy.cycles):
        raise AssertionError(
            f"dead link did not inflate collective cycles ({h_coll} -> "
            f"{f_coll}) and step cycles ({healthy.cycles} -> {faulted.cycles})")
    out = {
        "kinds": sorted(schema["fault_kinds"]),
        "dead_link": f"{list(topo.coords(a))}->{list(topo.coords(b))}",
        "step_inflation": faulted.cycles / healthy.cycles,
        "collective_inflation": f_coll / h_coll,
        "stats_keys": schema["stats_required_when_active"],
    }
    print(f"  (a) faults smoke: dead link {out['dead_link']}, step cycles "
          f"x{out['step_inflation']:.6f}, collective cycles "
          f"x{out['collective_inflation']:.6f}; host "
          f"{time.perf_counter() - t0:.4f} s (card: {card_name})")
    return out


def example_schedules(card_name: str) -> None:
    """Phase 7 (b): every example schedule on ``llama_tiny_tp2dp2`` @ v5p,
    analytic and detailed network, ``serial`` and ``vectorized`` stats
    equal apart from ``fastpath_*``."""
    t0 = time.perf_counter()
    schema = json.loads(FAULTS_SCHEMA.read_text())
    for mode in ("analytic", "detailed"):
        overlays = [{"arch": {"ici": {"network_mode": mode}}}]
        for kind, doc in schema["example_schedules"].items():
            runs = [stats_of(simulate_trace(
                FIXTURES / "llama_tiny_tp2dp2", arch="v5p",
                overlays=overlays, tuned=False, faults=doc,
                pricing_backend=backend), drop=("fastpath_",))
                for backend in ("serial", "vectorized")]
            if runs[0] != runs[1] or "faults_active" not in runs[0]:
                raise AssertionError(f"{kind} {mode}: serial and vectorized "
                                     "stats differ")
    print(f"  (b) {len(schema['example_schedules'])} example schedules x "
          f"{{analytic, detailed}}: serial == vectorized; host "
          f"{time.perf_counter() - t0:.4f} s (card: {card_name})")


def two_module_trace(dst: Path) -> Path:
    """A trace with two distinct modules (``matmul_512`` and a copy with
    a narrower first operand), launched a, b, a on device 0, so the
    driver's segment-parallel pricing engages (two launch classes)."""
    src = FIXTURES / "matmul_512"
    (dst / "modules").mkdir(parents=True)
    hlo = (src / "modules" / "matmul_512.hlo").read_text()
    (dst / "modules" / "mm_a.hlo").write_text(hlo)
    (dst / "modules" / "mm_b.hlo").write_text(
        hlo.replace("f32[512,512]", "f32[256,512]", 1))
    shutil.copy(src / "meta.json", dst / "meta.json")
    cmds = [{"kind": "kernel_launch", "module": m, "device": 0}
            for m in ("mm_a", "mm_b", "mm_a")]
    (dst / "commandlist.jsonl").write_text(
        "\n".join(json.dumps(c) for c in cmds) + "\n")
    return dst


def pooled_simulate(work: Path, card_name: str) -> None:
    """Phase 7 (c): ``simulate --workers 4`` on the two-module trace
    against the serial run, through the CLI."""
    t0 = time.perf_counter()
    trace = two_module_trace(work / "two_module")
    runs = {}
    for label, extra in (("serial", []),
                         ("pooled", ["--workers", str(POOL_WORKERS)])):
        out = work / f"two_module_{label}.json"
        run_cli(["simulate", str(trace), "--arch", "v5e", "--json", str(out),
                 *extra])
        runs[label] = {k: v for k, v in json.loads(out.read_text()).items()
                       if k not in VOLATILE}
    pooled = runs["pooled"]
    if pooled.get("pool_workers") != POOL_WORKERS \
            or pooled.get("pool_parallel_segments") != 2:
        raise AssertionError(f"the pool did not engage: {pooled}")
    if {k: v for k, v in pooled.items() if not k.startswith("pool_")} \
            != runs["serial"]:
        raise AssertionError("pooled and serial stats differ")
    print(f"  (c) simulate --workers {POOL_WORKERS} on a two-module trace: "
          f"pool_workers {pooled['pool_workers']}, pool_parallel_segments "
          f"{pooled['pool_parallel_segments']}, stats equal the serial run's; "
          f"host {time.perf_counter() - t0:.4f} s (card: {card_name})")


@contextlib.contextmanager
def counting_engine_runs():
    """Count the engine's pricing walks while the block runs (a result
    cache hit returns before ``Engine.run``)."""
    calls = {"n": 0}
    orig = Engine.run

    def counting(self, module):
        calls["n"] += 1
        return orig(self, module)

    Engine.run = counting
    try:
        yield calls
    finally:
        Engine.run = orig


def sweep_reports(work: Path, argv: list[str], runs: dict) -> dict:
    """``faults`` through the CLI once per ``runs`` entry (label -> extra
    flags); returns each run's ``--json`` report bytes, host seconds and
    engine walks."""
    out = {}
    for label, extra in runs.items():
        path = work / f"sweep_{label}.json"
        with counting_engine_runs() as calls:
            t0 = time.perf_counter()
            run_cli(["faults", *argv, "--json", str(path), *extra])
            secs = time.perf_counter() - t0
        out[label] = (path.read_bytes(), secs, calls["n"])
    return out


def sweeps(work: Path, card_name: str) -> dict:
    """Phase 7 (d) and (e): the analytic and the trace link sweeps through
    the CLI, serial, pooled and cached, reports equal by bytes.  Returns
    the host seconds by run."""
    workers = ["--workers", str(POOL_WORKERS)]
    analytic = sweep_reports(work, ["--arch", "v5p", "--chips", "64"],
                             {"d_serial": [], "d_pooled": workers})
    cached = ["--result-cache", str(work / "result_cache")]
    traced = sweep_reports(
        work, ["--arch", "v5p", "--chips", "8", "--trace",
               str(FIXTURES / "llama_tiny_tp2dp2")],
        {"e_serial": [], "e_pooled": workers, "e_cached_cold": cached,
         "e_cached_warm": cached})
    for name, reports in (("d", analytic), ("e", traced)):
        blobs = {label: blob for label, (blob, _, _) in reports.items()}
        if len(set(blobs.values())) != 1:
            raise AssertionError(f"({name}) sweep reports differ: "
                                 f"{sorted(blobs)}")
    doc_d = json.loads(analytic["d_serial"][0])
    doc_e = json.loads(traced["e_serial"][0])
    if doc_d["scenarios"] != 192 or doc_e["scenarios"] != 12:
        raise AssertionError(f"scenario counts {doc_d['scenarios']}, "
                             f"{doc_e['scenarios']}")
    walks = {label: n for label, (_, _, n) in traced.items()}
    if walks["e_cached_cold"] < 1 or walks["e_cached_warm"] != 0:
        raise AssertionError(f"engine walks by run {walks}: the warm "
                             "cached sweep must take every module result "
                             "from the disk tier")
    seconds = {label: secs for reports in (analytic, traced)
               for label, (_, secs, _) in reports.items()}
    print(f"  (d) faults --arch v5p --chips 64: 192 scenarios, worst "
          f"x{doc_d['worst_inflation']:.6f} at {doc_d['worst_link']}; serial "
          f"and --workers {POOL_WORKERS} reports equal by bytes; host "
          f"{seconds['d_serial']:.4f} / {seconds['d_pooled']:.4f} s "
          f"(card: {card_name})")
    print(f"  (e) faults --arch v5p --chips 8 --trace llama_tiny_tp2dp2: 12 "
          f"scenarios, worst x{doc_e['worst_inflation']:.6f}; serial, "
          f"--workers {POOL_WORKERS}, --result-cache cold and warm reports "
          f"equal by bytes; engine walks in the parent {walks} (the warm run "
          f"prices nothing); host " + " / ".join(
              f"{seconds[k]:.4f}" for k in ("e_serial", "e_pooled",
                                            "e_cached_cold", "e_cached_warm"))
          + f" s (card: {card_name})")
    return seconds


def degraded_pods(card_name: str, work: Path) -> dict:
    """Phase 7: (a)-(e) in ``work`` (an empty directory), with the
    kernels' launch counters set to 0 just before and read just after.
    Raises on any failure, and when a kernel was launched; returns the
    launch counts, the smoke summary and the sweeps' host seconds."""
    for *_, reset in KERNELS:
        reset()
    t0 = time.perf_counter()
    smoke = faults_smoke(card_name)
    example_schedules(card_name)
    pooled_simulate(work, card_name)
    seconds = sweeps(work, card_name)
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    print(f"degraded pods: host {time.perf_counter() - t0:.4f} s (card: "
          f"{card_name}); kernel launches {launches} (this path runs on the "
          f"host)")
    if any(launches.values()):
        raise AssertionError(f"the host path launched kernels: {launches}")
    return {"launches": launches, "smoke": smoke, "seconds": seconds}


#: phase 8: the child each fresh-process run executes (``python -c``): it
#: runs CLI commands one after another and writes, to the JSON path it is
#: given, a record per command: its host seconds from its first
#: ``load_trace`` (or from the CLI's start, when the command loads no
#: trace through the driver) to the CLI's return, the engine walks it
#: made, every garbage-collection pause, its kernels' launch counts and
#: what it printed.  Arguments: repo root, output path, the commands as a
#: JSON list of argument lists.
FRESH_CHILD = r"""
import contextlib, gc, io, json, sys, time
repo, out_path, commands = sys.argv[1:]
sys.path.insert(0, repo)
import tpusim_torch.sim.driver as driver
from tpusim_torch.__main__ import main
from tpusim_torch.kernels import flash_attention, scan_rows
from tpusim_torch.timing.engine import Engine

marks, pauses, walks = {}, [], [0]
load = driver.load_trace
def timed_load(*a, **k):
    marks.setdefault("load", time.perf_counter())
    return load(*a, **k)
driver.load_trace = timed_load
run = Engine.run
def counting(self, module):
    walks[0] += 1
    return run(self, module)
Engine.run = counting
def on_gc(phase, info):
    if phase == "start":
        marks["gc"] = time.perf_counter()
    else:
        pauses.append([info["generation"], time.perf_counter() - marks["gc"],
                       info["collected"]])
gc.callbacks.append(on_gc)
records = []
for argv in json.loads(commands):
    marks.pop("load", None)
    pauses.clear()
    walks[0] = 0
    flash_attention.reset_launch_count()
    scan_rows.reset_launch_count()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    t1 = time.perf_counter()
    records.append({
        "rc": rc, "host_s": t1 - marks.get("load", t0), "cli_s": t1 - t0,
        "walks": walks[0], "gc": list(pauses), "stdout": out.getvalue(),
        "launches": {"flash_attention": flash_attention.launch_count(),
                     "scan_rows": scan_rows.launch_count()}})
    if rc != 0:
        break
gc.callbacks.remove(on_gc)
with open(out_path, "w") as f:
    json.dump(records, f)
"""
#: phase 8 (c): chip-degradation states of warm_states and their seed
WARM_STATES = 64
WARM_SEED = 19


def fresh_run(work: Path, commands: list[list[str]], tag: str,
              untuned: bool = True) -> list[dict]:
    """CLI commands one after another in one fresh process
    (:data:`FRESH_CHILD`), with no inherited compile store and, when
    ``untuned``, the committed tuner overlays off (``$TPUSIM_TUNED_DIR``
    an empty dir, as the golden cells are priced).  Returns the child's
    record of each command; raises when one fails."""
    out = work / f"fresh_{tag}.json"
    env = dict(os.environ)
    if untuned:
        tuned = work / "no_tuned_overlays"
        tuned.mkdir(exist_ok=True)
        env["TPUSIM_TUNED_DIR"] = str(tuned)
    env.pop("TPUSIM_COMPILE_CACHE", None)
    proc = run_process(
        [sys.executable, "-c", FRESH_CHILD, str(REPO), str(out),
         json.dumps(commands)],
        capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"fresh process {tag} exited "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    recs = json.loads(out.read_text())
    for argv, rec in zip(commands, recs):
        if rec["rc"] != 0:
            raise RuntimeError(f"fresh tpusim_torch {' '.join(argv)}: rc "
                               f"{rec['rc']}: {proc.stderr[-2000:]}")
    if len(recs) != len(commands):
        raise RuntimeError(f"fresh process {tag} ran {len(recs)} of "
                           f"{len(commands)} commands")
    return recs


def cell_flags(overlays: list) -> list[str]:
    """A golden cell's overlays as ``simulate`` flags."""
    flags = []
    for ov in overlays:
        if ov == {"power_enabled": True}:
            flags.append("--power")
        elif ov == {"arch": {"ici": {"network_mode": "detailed"}}}:
            flags += ["--network-mode", "detailed"]
        else:
            raise ValueError(f"no simulate flag for overlay {ov}")
    return flags


#: phase 8 (e): phase 7 (e)'s trace sweep, and its legs' extra flags
#: (the cached legs' directory is filled in per run)
SWEEP_ARGV = ["faults", "--arch", "v5p", "--chips", "8", "--trace",
              str(FIXTURES / "llama_tiny_tp2dp2")]
SWEEP_LEGS = {"e_serial": [], "e_pooled": ["--workers", str(POOL_WORKERS)],
              "e_cached_cold": ["--result-cache"],
              "e_cached_warm": ["--result-cache"]}


def fresh_processes(work: Path, store: Path, cells=GOLDEN_CELLS) -> dict:
    """Phase 8 (a) and (e)'s two fresh processes: the golden cells
    through ``simulate --compile-cache``, all cold (the store empty, so
    each cell compiles and publishes its own record), then phase 7 (e)'s
    sweep serial, pooled and cached cold (an empty result-cache
    directory); and, in the second, the cells warm (every cell priced
    from the records, with no compiled state in memory) and the sweep
    cached warm (no result in memory, so every one comes from the disk
    tier).  Returns the child's record of each command, by (golden, run)
    and by sweep leg."""
    def cell(run):
        return [
            ["simulate", str(FIXTURES / fixture), "--arch", arch,
             *cell_flags(overlays), "--compile-cache", str(store),
             "--json", str(work / f"{golden}_{run}.json")]
            for fixture, arch, overlays, golden in cells]

    def sweep(label):
        extra = SWEEP_LEGS[label]
        if extra == ["--result-cache"]:
            extra = extra + [str(work / "fresh_result_cache")]
        return [*SWEEP_ARGV, "--json",
                str(work / f"fresh_{label}_report.json"), *extra]

    recs = {}
    for run, legs in (("cold", ("e_serial", "e_pooled", "e_cached_cold")),
                      ("warm", ("e_cached_warm",))):
        keys = [(golden, run) for *_, golden in cells] + list(legs)
        got = fresh_run(work, cell(run) + [sweep(label) for label in legs],
                        run)
        recs.update(zip(keys, got))
    return recs


def store_cells(card_name: str, work: Path, recs: dict,
                cells=GOLDEN_CELLS) -> dict:
    """Phase 8 (a) and (b): the golden cells' cold and warm runs of
    :func:`fresh_processes` — each report passes its golden, warm shows a
    store hit, no compile and no IR op built, and cold and warm stats are
    equal.  Returns the host seconds by (golden, run) and the cold llama
    runs' GC pauses of :data:`GC_PAUSE_S` or more."""
    seconds, pauses = {}, {}
    for fixture, arch, overlays, golden in cells:
        runs = {}
        for run in ("cold", "warm"):
            path = work / f"{golden}_{run}.json"
            rec = recs[(golden, run)]
            stats = json.loads(path.read_text())
            errors = compare_golden(golden, without_fastpath(stats))
            if errors:
                raise AssertionError("\n".join(errors))
            if any(rec["launches"].values()):
                raise AssertionError(f"{golden} {run}: kernel launches "
                                     f"{rec['launches']}")
            seconds[(golden, run)] = rec["host_s"]
            runs[run] = stats
            if run == "cold" and fixture == "llama_tiny_tp2dp2":
                pauses[golden] = [p for p in rec["gc"] if p[1] >= GC_PAUSE_S]
        warm = runs["warm"]
        if warm.get("fastpath_store_hits", 0) < 1 \
                or warm.get("fastpath_compile_misses") != 0 \
                or warm.get("fastpath_ir_ops_built") != 0:
            raise AssertionError(f"{golden} warm: " + str(
                {k: v for k, v in warm.items() if k.startswith("fastpath_")}))
        if {k: v for k, v in without_fastpath(runs["cold"]).items()
                if k not in VOLATILE} != \
                {k: v for k, v in without_fastpath(warm).items()
                 if k not in VOLATILE}:
            raise AssertionError(f"{golden}: cold and warm stats differ")
        print(f"  (a) golden {golden}: cold and warm pass, stats equal; "
              f"cold store_writes {runs['cold']['fastpath_store_writes']}, "
              f"ir_ops_built {runs['cold']['fastpath_ir_ops_built']}; warm "
              f"store_hits {warm['fastpath_store_hits']}, compile_misses 0, "
              f"ir_ops_built 0; host s from load_trace, fresh processes: cold "
              f"{seconds[(golden, 'cold')]:.4f}, warm "
              f"{seconds[(golden, 'warm')]:.4f} (card: {card_name})")
    for golden, found in pauses.items():
        print(f"  (b) {golden} cold: {len(found)} GC pause(s) >= "
              f"{GC_PAUSE_S * 1e3:.0f} ms" + "".join(
                  f"; generation {g}: {dt * 1e3:.1f} ms, {n} collected"
                  for g, dt, n in found) + f" (card: {card_name})")
    return {"seconds": seconds, "gc_pauses": pauses}


#: phase 8 (b): in-process cold loads of each llama cell
PARENT_LOADS = 3


def parent_gc_pauses(card_name: str) -> dict:
    """Phase 8 (b), second half: the llama cells cold in this process,
    which holds torch's and CUDA's heap — where a pause of about 0.3 s
    inside a trace load was seen (PERF.md §7) — :data:`PARENT_LOADS`
    times each, with every GC pause and each ``load_trace``'s seconds
    recorded."""
    out = {}
    for fixture, arch, overlays, golden in GOLDEN_CELLS:
        if fixture != "llama_tiny_tp2dp2":
            continue
        calls = []
        for _ in range(PARENT_LOADS):
            clear_compiled_cache()
            with watch_host() as watched:
                t0 = time.perf_counter()
                report = simulate_trace(FIXTURES / fixture, arch=arch,
                                        overlays=list(overlays), tuned=False)
                calls.append((time.perf_counter() - t0,
                              sum(watched["load_s"]), report.wall_seconds,
                              [p for p in watched["gc"] if p[1] >= GC_PAUSE_S],
                              len(watched["gc"])))
        out[golden] = calls
        print(f"  (b) {golden} cold in this process, {PARENT_LOADS} runs, "
              f"host s (whole / load_trace / replay alone, GC passes, "
              f"pauses >= {GC_PAUSE_S * 1e3:.0f} ms): " + "; ".join(
                  f"{whole:.4f} / {load:.4f} / {replay:.4f}, {n} passes, "
                  + (", ".join(f"gen {g} {dt * 1e3:.1f} ms" for g, dt, _ in
                               found) or "none")
                  for whole, load, replay, found, n in calls)
              + f" (card: {card_name})")
    return out


def degradation_states(topo, n: int = WARM_STATES, seed: int = WARM_SEED):
    """``n`` seeded chip-degradation states bound to ``topo``: one
    straggling chip and one throttled HBM each, scales in (0.5, 1]."""
    rng = random.Random(seed)
    chips = topo.num_chips
    return [load_fault_schedule({"faults": [
        {"kind": "chip_straggler", "chip": rng.randrange(chips),
         "clock_scale": 1.0 - 0.5 * rng.random()},
        {"kind": "hbm_throttle", "chip": rng.randrange(chips),
         "hbm_scale": 1.0 - 0.5 * rng.random()},
    ]}).bind(topo) for _ in range(n)]


def per_state_records(pod, cfg, topo, states, cache: ResultCache) -> None:
    """The per-state walk ``warm_states`` stands in for: each state's
    launch classes through ``CachedEngine.run`` into ``cache``."""
    for state in states:
        view = state.view_at(0.0)
        topo_k = topo.with_faults(view)
        for dev_id in sorted(pod.devices):
            cs, hs = view.chip_scales(dev_id)
            engine = CachedEngine(cfg, topology=topo_k, clock_scale=cs,
                                  hbm_scale=hs, result_cache=cache)
            for cmd in pod.devices[dev_id].commands:
                if cmd.module in pod.modules:
                    engine.run(pod.modules[cmd.module])


def records(directory: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(directory.glob("*.json"))}


def warm_states_phase(card_name: str, work: Path,
                      backends=("cuda", "vectorized")) -> dict:
    """Phase 8 (c): ``warm_states`` over :data:`WARM_STATES` seeded states
    per backend, each into a fresh disk result cache; every published
    record equal by bytes to the per-state walk's.  Returns the launches
    and host ms by backend."""
    pod = load_trace(FIXTURES / "llama_tiny_tp2dp2")
    cfg = load_config(arch="v5p", tuned=False)
    # the pod's torus as the driver sizes it: the trace records device 0's
    # stream only, its module spans 4 chips
    topo = torus_for(max(m.num_devices for m in pod.modules.values()), "v5p")
    states = degradation_states(topo)
    per_state_records(pod, cfg, topo, states,
                      ResultCache(disk_dir=work / "per_state"))
    want = records(work / "per_state")
    # auto is the native scan where the library loads (phase 18 (d) holds
    # it to vectorized), as in the reference
    from tpusim_torch.fastpath.native import native_batch_available

    auto = "native" if native_batch_available() else "vectorized"
    if fp_batch.resolve_batch_backend(None) != auto:
        raise AssertionError(f"auto no longer resolves to {auto}")
    out = {}
    for backend in backends:
        for *_, reset in KERNELS:
            reset()
        cache = ResultCache(disk_dir=work / f"warm_{backend}")
        with scan_lanes() as lanes:
            stats = warm_states(pod, cfg, topo, states, cache,
                                backend=backend)
            if backend == "cuda":
                torch.cuda.synchronize()
        launches = {name: count() for name, _, _, count, _ in KERNELS}
        got = records(work / f"warm_{backend}")
        if got != want or stats.states != len(want):
            raise AssertionError(
                f"warm_states {backend}: {stats.stats_dict()}, "
                f"{len(got)} records vs {len(want)} per-state, differing "
                f"{sorted(k for k in want if got.get(k) != want[k])[:4]}")
        if (launches["scan_rows"] > 0) != (backend == "cuda") \
                or launches["flash_attention"]:
            raise AssertionError(f"warm_states {backend}: launches {launches}")
        ms = host_ms(lambda: warm_states(pod, cfg, topo, states, ResultCache(),
                                         backend=backend), samples=5)
        out[backend] = {"launches": launches, "ms": ms} | lanes_record(lanes)
        print(f"  (c) warm_states {len(states)} states llama_tiny_tp2dp2 @ "
              f"v5p, backend {backend}: {stats.states} lanes in "
              f"{stats.groups} group(s), {len(got)} records equal by bytes "
              f"to the per-state walk's; kernel launches {launches} "
              f"({lanes_text(lanes)}); host {ms:.2f} ms (median of 5, fresh "
              f"memory cache each; card: {card_name})")
    return out


def cache_cli(card_name: str, store: Path) -> dict:
    """Phase 8 (d): the ``cache`` CLI over (a)'s store, with one result
    record added beside its compiled records."""
    t0 = time.perf_counter()
    run_cli(["simulate", str(FIXTURES / "matmul_512"), "--arch", "v5e",
             "--result-cache", str(store)])

    def field(text: str, label: str) -> int:
        line = next(ln for ln in text.splitlines()
                    if ln.strip().startswith(label))
        return int(line.split(":", 1)[1].split()[0])

    stats = run_cli(["cache", "stats", "--dir", str(store)])
    compiled, results = field(stats, "compiled:"), field(stats, "results:")
    if compiled < 1 or results < 1:
        raise AssertionError(f"cache stats does not count both tiers:\n{stats}")
    verify = run_cli(["cache", "verify", "--dir", str(store)])
    if field(verify, "quarantined (corrupt):") != 0:
        raise AssertionError(f"verify of a sound store:\n{verify}")
    victim = sorted(store.glob("*.cmod"))[0]
    raw = bytearray(victim.read_bytes())
    raw[3] ^= 0xFF  # one byte of the magic
    victim.write_bytes(bytes(raw))
    first = run_cli(["cache", "verify", "--dir", str(store)])
    second = run_cli(["cache", "verify", "--dir", str(store)])
    if field(first, "quarantined (corrupt):") != 1 \
            or field(second, "quarantined (corrupt):") != 0 \
            or victim.exists():
        raise AssertionError(f"flipped record not quarantined once:\n"
                             f"{first}\n{second}")
    quota = store_bytes(store) // 2
    gc_out = run_cli(["cache", "gc", "--dir", str(store), "--quota",
                      str(quota)])
    left = store_bytes(store)
    if left > quota:
        raise AssertionError(f"gc left {left} B over the {quota} B quota")
    print(f"  (d) cache stats: {compiled} compiled + {results} result "
          f"record(s); verify: 0 corrupt; one flipped byte: quarantined by "
          f"the first verify, 0 by the second; gc --quota {quota}: "
          f"{field(gc_out, 'deleted:')} deleted, {left} B left; host "
          f"{time.perf_counter() - t0:.4f} s (card: {card_name})")
    return {"compiled": compiled, "results": results, "quota": quota,
            "left": left}


def fresh_sweeps(card_name: str, work: Path, recs: dict) -> dict:
    """Phase 8 (e): phase 7 (e)'s four legs in the fresh processes of
    :func:`fresh_processes` (the warm cached leg in the second, which has
    no result in memory); reports equal by bytes, the warm cached leg
    pricing nothing."""
    out = {label: recs[label] for label in SWEEP_LEGS}
    blobs = {label: (work / f"fresh_{label}_report.json").read_bytes()
             for label in SWEEP_LEGS}
    if len(set(blobs.values())) != 1:
        raise AssertionError("fresh-process sweep reports differ")
    walks = {label: rec["walks"] for label, rec in out.items()}
    if walks["e_cached_cold"] < 1 or walks["e_cached_warm"] != 0:
        raise AssertionError(f"fresh-process engine walks {walks}")
    print(f"  (e) faults --trace llama_tiny_tp2dp2 in fresh processes, the "
          f"warm cached leg in the second: reports equal by bytes; engine "
          f"walks {walks}; host s "
          f"inside the child " + " / ".join(
              f"{label[2:]} {rec['cli_s']:.4f}" for label, rec in out.items())
          + f" (card: {card_name})")
    return {label: rec["cli_s"] for label, rec in out.items()}


def durable_store(card_name: str, work: Path) -> dict:
    """Phase 8: (a)-(e) in ``work`` (an empty directory), the kernels'
    launch counters set to 0 just before each part and read just after.
    Raises on any failure."""
    store = work / "store"
    out, launches, recs = {}, {}, {}

    def part_a():
        recs.update(fresh_processes(work, store))
        return store_cells(card_name, work, recs)

    for part, fn in (
            ("a", part_a),
            ("b", lambda: parent_gc_pauses(card_name)),
            ("c", lambda: warm_states_phase(card_name, work)),
            ("d", lambda: cache_cli(card_name, store)),
            ("e", lambda: fresh_sweeps(card_name, work, recs))):
        for *_, reset in KERNELS:
            reset()
        out[part] = fn()
        launches[part] = {name: count() for name, _, _, count, _ in KERNELS}
    print(f"durable store: kernel launches by part {launches} (card: "
          f"{card_name})")
    return out


#: phase 9: the smoke specs of ``ci/check_golden.py`` (``CAMPAIGN_SMOKE_SPEC``,
#: ``DCN_SMOKE_SPEC``, ``FLEET_SMOKE_SPEC``), copied; their goldens
#: (``ci/golden/{campaign,dcn,fleet}_smoke.json``) are read as data
CAMPAIGN_SMOKE_SPEC = {
    "name": "ci-campaign-smoke",
    "seed": 3,
    "scenarios": 16,
    "arch": "v5p",
    "chips": 8,
    "tuned": False,
    "faults": {
        "count": {"dist": "uniform", "min": 0, "max": 3},
        "kinds": {"link_down": 1.0, "link_degraded": 1.0,
                  "chip_straggler": 0.5, "hbm_throttle": 0.5},
        "scale": {"min": 0.4, "max": 0.9},
    },
    "correlated_groups": [
        {"name": "cable-bundle-y", "prob": 0.06, "axis": 1},
        {"name": "cable-bundle-z", "prob": 0.06, "axis": 2},
    ],
    "slo": {"step_time_ms": 0.55, "percentile": 90},
    "candidate_slices": [{"arch": "v5p", "chips": 4},
                         {"arch": "v5p", "chips": 16}],
}
DCN_SMOKE_SPEC = {
    "name": "ci-dcn-smoke",
    "seed": 7,
    "scenarios": 8,
    "arch": "v5p",
    "chips": 4,
    "tuned": False,
    "dcn": {
        "num_slices": 2,
        "nics_per_slice": 2,
        "nic_bandwidth": 25e9,
        "hop_latency": 1e-5,
    },
    "faults": {
        "count": {"dist": "uniform", "min": 1, "max": 2},
        "kinds": {"slice_down": 2.0, "dcn_link_down": 1.0,
                  "link_degraded": 0.5},
        "scale": {"min": 0.4, "max": 0.9},
    },
}
FLEET_SMOKE_SPEC = {
    "name": "ci-fleet-smoke",
    "seed": 3,
    "pods": 2,
    "arch": "v5p",
    "chips": 8,
    "tuned": False,
    "horizon_s": 30.0,
    "traffic": {
        "shape": "bursty",
        "load_points": [5.0, 30.0],
        "burst": {"factor": 4.0, "fraction": 0.1, "period_s": 20.0},
        "mix": [{"name": "chat", "weight": 3.0, "steps": 100},
                {"name": "batch", "weight": 1.0, "steps": 400}],
    },
    "faults": {
        "count": {"dist": "uniform", "min": 0, "max": 2},
        "kinds": {"link_down": 1.0, "hbm_throttle": 1.0},
        "scale": {"min": 0.4, "max": 0.9},
        "window": {"min_s": 10.0, "max_s": 30.0},
        "pod_loss": {"prob": 0.9},
    },
    "policies": {
        "max_inflight": 1,
        "queue_depth": 4,
        "deadline_s": 0.5,
        "restart_backoff_s": 5.0,
    },
    "slo": {"latency_ms": 400.0, "percentile": 95},
    "frontier": {"target_rps": [12.0], "max_pods": 4},
}
#: a smoke report against its golden: ``model_version`` masked, every
#: non-float equal, every float within this relative gap.  The goldens'
#: means (``sum(values) / len(values)``) were summed by an interpreter
#: whose float ``sum`` rounds differently from Python 3.12's, so the JAX
#: package itself misses them by bytes in their last one or two digits
SMOKE_RTOL = 1e-12
#: ``scenario_batch`` of phase 9's legs: no batching, the host row scans,
#: the row scans on the card (``scan_rows``)
BATCH_LEGS = (False, "vectorized", "cuda")
#: phase 9 (c): the campaign smoke's fault model on a v5p 4x4x4 pod
BIG_CAMPAIGN_CHIPS = 64
BIG_CAMPAIGN_SCENARIOS = 1024
#: phase 9 (d): the fleet smoke's traffic and policies on 8 pods over 300 s
BIG_FLEET_PODS = 8
BIG_FLEET_HORIZON_S = 300.0
BIG_FLEET_FRONTIER = {"target_rps": [12.0, 48.0], "max_pods": 16}


def report_bytes(doc: dict) -> bytes:
    """A report as ``ci/check_golden.py`` writes it."""
    return (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()


def golden_gaps(got, want, path: str = "") -> list[float]:
    """The relative gaps of the floats that differ between a report and
    its golden (``model_version`` masked by the caller); raises when a
    non-float differs or a float is further than :data:`SMOKE_RTOL`."""
    if isinstance(want, float) and isinstance(got, float):
        if got == want:
            return []
        gap = abs(got - want) / max(abs(got), abs(want))
        if not gap <= SMOKE_RTOL:
            raise AssertionError(f"{path}: {got!r} vs golden {want!r}")
        return [gap]
    if type(got) is not type(want):
        raise AssertionError(f"{path}: {got!r} vs golden {want!r}")
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(
                f"{path}: keys {sorted(set(got) ^ set(want))}")
        return [g for k in sorted(want)
                for g in golden_gaps(got[k], want[k], f"{path}.{k}")]
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} vs {len(want)} items")
        return [g for i, (a, b) in enumerate(zip(got, want))
                for g in golden_gaps(a, b, f"{path}[{i}]")]
    if got != want:
        raise AssertionError(f"{path}: {got!r} vs golden {want!r}")
    return []


def smoke_contract(name: str, doc: dict, stats: dict) -> None:
    """The contract checks of ``ci/check_golden.py``'s campaign, dcn and
    fleet smokes (beyond the golden comparison)."""
    if name == "campaign":
        primary = doc["slices"][0]
        if not all(isinstance(primary["inflation"].get(k), float)
                   for k in ("p50", "p95", "p99", "max")):
            raise AssertionError("campaign smoke: inflation percentiles")
        if not any(s["partition_rate"] > 0 for s in doc["slices"]):
            raise AssertionError("campaign smoke: no partitioned scenario")
        cap = doc.get("capacity")
        if not cap or cap.get("smallest_meeting_slice") is None:
            raise AssertionError("campaign smoke: capacity answer missing")
        if not all(isinstance(r.get("healthy_watts"), float)
                   for r in cap["table"]):
            raise AssertionError("campaign smoke: table rows miss watts")
        if stats["campaign_partitioned_total"] < 1:
            raise AssertionError("campaign smoke: no partition counted")
    elif name == "dcn":
        sl = doc["slices"][0]
        dcn = sl.get("dcn")
        if not dcn or dcn["slice_loss_scenarios"] < 1:
            raise AssertionError("dcn smoke: no slice-loss scenario")
        if sum(dcn["slices_ok_hist"].values()) != sl["scenarios"]:
            raise AssertionError("dcn smoke: histogram misses scenarios")
        for row in doc["rows"]:
            if row["dcn"]["slices_lost"] > 0 and \
                    row.get("status") != "partitioned":
                raise AssertionError(f"dcn smoke: row {row['index']}")
    else:
        for row in doc["curve"]:
            lat = row["latency_ms"]
            if lat is None or not all(isinstance(lat.get(k), float)
                                      for k in ("p50", "p99")):
                raise AssertionError("fleet smoke: curve latency missing")
            if row["served"] and row["energy_per_request_j"] is None:
                raise AssertionError("fleet smoke: energy per request")
        if stats["fleet_lost_shed_total"] < 1:
            raise AssertionError("fleet smoke: no shedding loss")
        if stats["fleet_pod_losses_total"] < 1 or not doc["recovery"]:
            raise AssertionError("fleet smoke: no pod loss / recovery row")
        if any(r["time_to_recover_s"] <= 0 for r in doc["recovery"]):
            raise AssertionError("fleet smoke: time to recover <= 0")
        table = doc["frontier"]["table"]
        if not table or table[0]["pods_needed"] is None:
            raise AssertionError("fleet smoke: frontier answer is null")


def lanes_text(lanes: list[int]) -> str:
    if not lanes:
        return "scan_rows 0 launches"
    return (f"scan_rows {len(lanes)} launches, lanes per launch "
            f"{min(lanes)}-{max(lanes)} (median "
            f"{statistics.median(lanes):g})")


def lanes_record(lanes: list[int]) -> dict:
    return {"calls": len(lanes), "lanes_min": min(lanes, default=0),
            "lanes_max": max(lanes, default=0),
            "lanes_median": statistics.median(lanes) if lanes else 0}


@contextlib.contextmanager
def scan_lanes():
    """Record the lanes of every call of the ``scan_rows`` kernel's wrapper
    entries (``scan_rows``, ``scan_segments``) the batched pricer makes
    (its matrices are ops-major, ``[k, S]``)."""
    lanes: list[int] = []
    rows, segments = sr.scan_rows, sr.scan_segments

    def on_rows(seeds, mat):
        lanes.append(int(mat.shape[1]))
        return rows(seeds, mat)

    def on_segments(mat, *rest):
        lanes.append(int(mat.shape[1]))
        return segments(mat, *rest)
    sr.scan_rows, sr.scan_segments = on_rows, on_segments
    try:
        yield lanes
    finally:
        sr.scan_rows, sr.scan_segments = rows, segments


def batch_legs(run, spec: dict, legs=None) -> dict:
    """``run`` (``run_campaign`` or ``run_fleet``) over the fixture under
    each ``scenario_batch`` leg, the kernels' launch counters set to 0
    just before each leg and read just after.  Returns, per leg, the
    result, the report's bytes, host seconds, launches and the lanes of
    each ``scan_rows`` call; raises unless every leg's report is equal by
    bytes, ``cuda`` launches ``scan_rows`` and the host legs launch
    nothing."""
    out = {}
    for leg in legs or BATCH_LEGS:
        for *_, reset in KERNELS:
            reset()
        with scan_lanes() as lanes:
            t0 = time.perf_counter()
            res = run(spec, trace_path=FIXTURES / "llama_tiny_tp2dp2",
                      scenario_batch=leg)
            host_s = time.perf_counter() - t0
        if leg == "cuda":
            torch.cuda.synchronize()  # the counts are read after the card
        launches = {name: count() for name, _, _, count, _ in KERNELS}
        out[str(leg)] = {"res": res, "bytes": report_bytes(res.doc),
                         "host_s": host_s, "launches": launches,
                         "lanes": list(lanes)}
    if len({leg["bytes"] for leg in out.values()}) != 1:
        raise AssertionError(f"{spec['name']}: reports differ across "
                             f"scenario_batch legs {list(out)}")
    for leg, rec in out.items():
        want_scan = rec["launches"]["scan_rows"] >= 1 if leg == "cuda" \
            else rec["launches"]["scan_rows"] == 0
        if not want_scan or rec["launches"]["flash_attention"]:
            raise AssertionError(f"{spec['name']} leg {leg}: launches "
                                 f"{rec['launches']}")
    return out


def smokes(card_name: str) -> dict:
    """Phase 9 (a): the campaign, DCN and fleet smokes under every leg,
    each against its golden and its contract checks."""
    from tpusim_torch.campaign import run_campaign
    from tpusim_torch.fleet import run_fleet

    out = {}
    for name, run, spec in (("campaign", run_campaign, CAMPAIGN_SMOKE_SPEC),
                            ("dcn", run_campaign, DCN_SMOKE_SPEC),
                            ("fleet", run_fleet, FLEET_SMOKE_SPEC)):
        legs = batch_legs(run, spec)
        res = legs["False"]["res"]
        golden = json.loads(
            (REPO / "ci" / "golden" / f"{name}_smoke.json").read_text())
        doc = dict(res.doc)
        doc["model_version"] = golden["model_version"] = "masked"
        gaps = golden_gaps(doc, golden)
        smoke_contract(name, res.doc, res.stats.stats_dict())
        print(f"  (a) {name} smoke: reports equal by bytes under "
              f"{'/'.join(legs)}; golden: {len(gaps)} float(s) differ, "
              f"largest relative gap {max(gaps, default=0.0):.3g}; "
              f"contract holds; host s " + " / ".join(
                  f"{leg} {rec['host_s']:.4f}" for leg, rec in legs.items())
              + f"; {lanes_text(legs[str(BATCH_LEGS[-1])]['lanes'])}"
              f" (card: {card_name})")
        out[name] = {leg: {"host_s": rec["host_s"],
                           "launches": rec["launches"]["scan_rows"]}
                     for leg, rec in legs.items()}
    return out


def cli_here(argv: list[str]) -> int:
    """``tpusim_torch ARGV`` through the CLI's entry function in this
    process; returns its exit code (0 or 3, a cancelled run)."""
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli(argv)
    if rc not in (0, 3):
        raise RuntimeError(f"tpusim_torch {' '.join(argv)} exited {rc}")
    return rc


def cli_process(argv: list[str], timeout: float = 600) -> tuple[int, str]:
    """``python -m tpusim_torch ARGV`` in a fresh process."""
    proc = run_process([sys.executable, "-m", "tpusim_torch", *argv],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=timeout)
    if proc.returncode not in (0, 3):
        raise RuntimeError(f"tpusim_torch {' '.join(argv)} exited "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.returncode, proc.stdout


#: phase 9 (b): the campaign's scenarios a slice, and the ``--max-wall-s``
#: deadline (s) of the CLI leg, which cancels before the first check
CLI_CAMPAIGN_SCENARIOS = 256
CLI_MAX_WALL_S = 0.001


def journaled(journal: Path, kind: str) -> int:
    """Records of ``kind`` in a campaign or fleet journal."""
    if not journal.is_file():
        return 0
    return sum(json.loads(line).get("kind") == kind
               for line in journal.read_text().splitlines() if line)


@contextlib.contextmanager
def cancel_after_journaled(kind: str, count: int, token):
    """Trip ``token`` once ``count`` records of ``kind`` are journaled:
    ``Journal.append`` is wrapped for the ``with`` block (here, not in the
    package), so the run is cancelled on a count it can observe, at the
    next check of its token."""
    from tpusim_torch.campaign.journal import Journal

    append = Journal.append
    seen = [0]

    def counting(self, rec: dict) -> None:
        append(self, rec)
        if rec.get("kind") == kind:
            seen[0] += 1
            if seen[0] >= count:
                token.cancel(f"{seen[0]} {kind} record(s) journaled")

    Journal.append = counting
    try:
        yield
    finally:
        Journal.append = append


def cli_resume(card_name: str, work: Path) -> dict:
    """Phase 9 (b): ``campaign`` and ``fleet`` uninterrupted through the
    CLI's entry function, then cancelled two ways and resumed with
    ``--resume`` through the CLI in a fresh process (a resume reads only
    what the journal holds, no state of the process that wrote it; the
    four resumes run one after another in one fresh process), where the
    resumed report must equal the uninterrupted one by bytes, every
    journaled record be resumed and none be priced again:

    * mid-run: in this process, with the run's ``CancelToken`` tripped
      once half the uninterrupted run's records (at least one) are
      journaled (:func:`cancel_after_journaled`) — a count, not a clock:
      the smokes journal all their work within milliseconds at the end
      of a run whose start varies by more than that;
    * by the CLI's ``--max-wall-s`` (:data:`CLI_MAX_WALL_S`): exit 3,
      with the journal as far as it got (its header, or nothing).

    The campaign is the smoke's spec at :data:`CLI_CAMPAIGN_SCENARIOS`
    scenarios a slice, the fleet (d)'s."""
    from tpusim_torch.campaign import run_campaign
    from tpusim_torch.fleet import run_fleet
    from tpusim_torch.guard.cancel import CancelToken, OperationCancelled

    trace = str(FIXTURES / "llama_tiny_tp2dp2")
    out, resumes = {}, []
    for cmd, spec, run, kind, resumed_re in (
            ("campaign", dict(CAMPAIGN_SMOKE_SPEC,
                              scenarios=CLI_CAMPAIGN_SCENARIOS),
             run_campaign, "scenario", r"(\d+) resumed from journal"),
            ("fleet", big_fleet_spec(), run_fleet, "state",
             r"fleet_states_resumed = (\d+)")):
        spec_path = work / f"{cmd}_spec.json"
        spec_path.write_text(json.dumps(spec))
        full = work / f"{cmd}_full"
        t0 = time.perf_counter()
        cli_here([cmd, str(spec_path), "--trace", trace, "--out", str(full)])
        full_s = time.perf_counter() - t0
        total = journaled(full / "journal.jsonl", kind)
        count = max(1, total // 2)
        part = work / f"{cmd}_part"
        token = CancelToken()
        try:
            with cancel_after_journaled(kind, count, token):
                run(str(spec_path), trace_path=trace, out_dir=part,
                    cancel=token)
        except OperationCancelled:
            pass
        else:
            raise AssertionError(f"{cmd}: not cancelled after {count} "
                                 f"{kind} record(s)")
        done = journaled(part / "journal.jsonl", kind)
        if not count <= done < total:
            raise AssertionError(f"{cmd}: cancelled with {done} of {total} "
                                 f"{kind} records journaled (asked "
                                 f"{count})")
        wall = work / f"{cmd}_wall"
        rc = cli_here([cmd, str(spec_path), "--trace", trace,
                       "--out", str(wall), "--max-wall-s",
                       repr(CLI_MAX_WALL_S)])
        if rc != 3:
            raise AssertionError(f"{cmd} --max-wall-s {CLI_MAX_WALL_S}: "
                                 f"exit {rc}, not 3")
        wall_done = journaled(wall / "journal.jsonl", kind)
        for cut, journaled_n in ((part, done), (wall, wall_done)):
            resumes.append((cmd, cut, full, journaled_n, resumed_re))
        out[cmd] = {"total": total, "resumed": done,
                    "max_wall_s_journaled": wall_done, "full_s": full_s}
    recs = fresh_run(work, [
        [cmd, str(work / f"{cmd}_spec.json"), "--trace", trace, "--out",
         str(cut), "--resume"] for cmd, cut, *_ in resumes], "resumes",
        untuned=False)
    for (cmd, cut, full, journaled_n, resumed_re), rec in zip(resumes, recs):
        resumed = int(re.search(resumed_re, rec["stdout"]).group(1))
        if resumed != journaled_n:
            raise AssertionError(f"{cmd} --resume of {cut.name}: {resumed} "
                                 f"resumed of {journaled_n} journaled")
        if (cut / "report.json").read_bytes() != \
                (full / "report.json").read_bytes():
            raise AssertionError(f"{cmd}: the report resumed from "
                                 f"{cut.name} differs")
    for cmd, o in out.items():
        kind = "scenario" if cmd == "campaign" else "state"
        print(f"  (b) {cmd} CLI: uninterrupted {o.pop('full_s'):.2f} s, "
              f"{o['total']} {kind} records; cancelled after "
              f"{o['resumed']} journaled, --resume: {o['resumed']} "
              f"resumed, report equal by bytes; --max-wall-s "
              f"{CLI_MAX_WALL_S}: exit 3 with {o['max_wall_s_journaled']} "
              f"journaled, --resume: report equal by bytes (card: "
              f"{card_name})")
    return out


def big_campaign(card_name: str) -> dict:
    """Phase 9 (c): the campaign smoke's fault model on a v5p 4x4x4 pod,
    1024 scenarios, under every leg."""
    from tpusim_torch.campaign import run_campaign

    spec = {k: v for k, v in CAMPAIGN_SMOKE_SPEC.items()
            if k not in ("slo", "candidate_slices")}
    spec.update(name="campaign-v5p-64", chips=BIG_CAMPAIGN_CHIPS,
                scenarios=BIG_CAMPAIGN_SCENARIOS)
    legs = batch_legs(run_campaign, spec)
    lanes = legs[str(BATCH_LEGS[-1])]["lanes"]
    stats = legs["False"]["res"].stats.stats_dict()
    print(f"  (c) campaign v5p-{BIG_CAMPAIGN_CHIPS}, "
          f"{BIG_CAMPAIGN_SCENARIOS} scenarios "
          f"({stats['campaign_scenarios_priced']} priced, "
          f"{stats['campaign_partitioned_total']} partitioned): "
          f"reports equal by bytes; host s " + " / ".join(
              f"{leg} {rec['host_s']:.4f}" for leg, rec in legs.items())
          + f"; {lanes_text(lanes)}; batch stats "
          + "; ".join(f"{leg} {rec['res'].batch_stats.stats_dict()}"
                      for leg, rec in legs.items() if leg != "False")
          + f" (card: {card_name})")
    return {leg: {"host_s": rec["host_s"],
                  "launches": rec["launches"]["scan_rows"]}
            for leg, rec in legs.items()} | lanes_record(lanes)


def big_fleet_spec() -> dict:
    """Phase 9 (d)'s fleet: the smoke's traffic and policies at a size
    users run."""
    return dict(FLEET_SMOKE_SPEC, name="fleet-8x300s", pods=BIG_FLEET_PODS,
                horizon_s=BIG_FLEET_HORIZON_S, frontier=BIG_FLEET_FRONTIER)


def big_fleet(card_name: str) -> dict:
    """Phase 9 (d): the fleet smoke's traffic and policies on 8 pods
    over 300 s, frontier targets 12 and 48 req/s up to 16 pods, without
    batching and with the card's row scans."""
    from tpusim_torch.fleet import run_fleet

    legs = batch_legs(run_fleet, big_fleet_spec(),
                      legs=(False, BATCH_LEGS[-1]))
    res = legs["False"]["res"]
    stats = res.stats.stats_dict()
    lanes = legs[str(BATCH_LEGS[-1])]["lanes"]
    needed = [row["pods_needed"] for row in res.doc["frontier"]["table"]]
    print(f"  (d) fleet {BIG_FLEET_PODS} pods x {BIG_FLEET_HORIZON_S:g} s: "
          f"{stats['fleet_states_priced']} states priced, "
          f"{stats['fleet_requests_total']} requests, "
          f"{stats['fleet_cells_total']} cells, pods needed {needed}; "
          f"reports equal by bytes; host s " + " / ".join(
              f"{leg} {rec['host_s']:.4f}" for leg, rec in legs.items())
          + f"; {lanes_text(lanes)}; batch stats "
          f"{legs[str(BATCH_LEGS[-1])]['res'].batch_stats.stats_dict()} "
          f"(card: {card_name})")
    return {leg: {"host_s": rec["host_s"],
                  "launches": rec["launches"]["scan_rows"]}
            for leg, rec in legs.items()} | lanes_record(lanes)


def campaign_fleet(card_name: str, work: Path) -> dict:
    """Phase 9: (a)-(d) in ``work`` (an empty directory).  Raises on any
    failure."""
    out = {}
    t0 = time.perf_counter()
    out["a"] = smokes(card_name)
    out["b"] = cli_resume(card_name, work)
    out["c"] = big_campaign(card_name)
    out["d"] = big_fleet(card_name)
    print(f"campaign and fleet: {time.perf_counter() - t0:.1f} s "
          f"(card: {card_name})")
    return out


#: phase 10: ``ci/check_golden.py``'s ``ADVISE_SMOKE_SPEC`` (copied; a test
#: holds the two equal) and the golden it is held to
ADVISE_SMOKE_SPEC = {
    "name": "ci-advise-smoke",
    "strategies": ["dp", "tp", "dp_tp", "sp", "pp"],
    "slices": [{"arch": "v5p", "chips": 8},
               {"arch": "v5e", "chips": 8}],
    "meshes": [{"dp": 2, "tp": 2, "pp": 2}],
    "tuned": False,
    "slo": {"step_time_ms": 1.0},
}
#: phase 10 (c): a sweep at a size users run — a v5p 4x4x4 slice, the
#: single-axis strategies, every dp x tp factorization and one pinned
#: three-axis mesh (10 cells), also with the pricing pool this wide
BIG_ADVISE_CHIPS = 64
BIG_ADVISE_STRATEGIES = ["dp", "tp", "dp_tp", "sp", "pp"]
BIG_ADVISE_MESH = {"dp": 4, "tp": 4, "pp": 4}
BIG_ADVISE_WORKERS = 4
#: phase 10 (d): the traces of the corpus that are not silicon captures
FIXTURES_CORPUS = (FIXTURES / "llama_tiny_tp2dp2", FIXTURES / "matmul_512")


def big_advise_spec() -> dict:
    """Phase 10 (c)'s sweep."""
    return {"name": "v5p-64", "strategies": list(BIG_ADVISE_STRATEGIES),
            "slices": [{"arch": "v5p", "chips": BIG_ADVISE_CHIPS}],
            "meshes": [dict(BIG_ADVISE_MESH)], "tuned": False,
            "slo": {"step_time_ms": 1.0}}


def critpath_corpus() -> tuple:
    """Phase 10 (d)'s traces: the two fixtures and every silicon capture."""
    silicon = REPO / "reports" / "silicon"
    return FIXTURES_CORPUS + tuple(sorted(
        d for d in silicon.iterdir() if (d / "modules").is_dir()))


def no_launches(part: str) -> dict:
    """The kernels' launch counts since their reset; raises unless 0."""
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    if any(launches.values()):
        raise AssertionError(f"{part} launched kernels: {launches}")
    return launches


def advise_smoke(card_name: str) -> dict:
    """Phase 10 (a): the advise smoke through ``run_advise`` against its
    golden (the float rule of phase 9) and ``ci/check_golden.py``'s
    contract; a warm pass through the same cache walks no module; golden
    cells 1-5 still pass after the sweep."""
    from tpusim_torch.advise import run_advise

    for *_, reset in KERNELS:
        reset()
    cache = ResultCache()
    with counting_engine_runs() as cold_walks:
        t0 = time.perf_counter()
        res = run_advise(ADVISE_SMOKE_SPEC,
                         trace_path=FIXTURES / "llama_tiny_tp2dp2",
                         result_cache=cache)
        cold_s = time.perf_counter() - t0
    golden = json.loads(
        (REPO / "ci" / "golden" / "advise_smoke.json").read_text())
    doc = dict(res.doc)
    doc["model_version"] = golden["model_version"] = "masked"
    gaps = golden_gaps(doc, golden)
    cells = res.doc["cells"]
    if len(cells) < 12 or res.doc["recommendation"] is None:
        raise AssertionError(f"advise smoke: {len(cells)} cells, "
                             f"recommendation {res.doc['recommendation']}")
    for col in ("step_ms", "ici_bytes", "hbm_resident_gib", "watts",
                "slo_ok", "collectives_per_chip"):
        if any(col not in r for r in cells):
            raise AssertionError(f"advise smoke: cell column {col!r} missing")
    dp4tp2 = [r for r in cells if r["mesh"] == {"dp": 4, "tp": 2}]
    if not dp4tp2 or dp4tp2[0]["collectives_per_chip"] != 14:
        raise AssertionError("advise smoke: dp=4 x tp=2 cell does not "
                             "synthesize the 14-collective step")
    with counting_engine_runs() as warm_walks:
        t0 = time.perf_counter()
        warm = run_advise(ADVISE_SMOKE_SPEC,
                          trace_path=FIXTURES / "llama_tiny_tp2dp2",
                          result_cache=cache)
        warm_s = time.perf_counter() - t0
    if warm_walks["n"] != 0 or report_bytes(warm.doc) != report_bytes(res.doc):
        raise AssertionError(f"advise smoke: warm pass walked "
                             f"{warm_walks['n']} module(s) or differs")
    launches = no_launches("the advise smoke")
    print(f"  (a) advise smoke: {len(cells)} cells, "
          f"{sum(r['feasible'] for r in cells)} feasible, recommendation "
          f"{res.doc['recommendation']['cell']}; golden: {len(gaps)} "
          f"float(s) differ, largest relative gap {max(gaps, default=0.0):.3g}"
          f"; contract holds; engine walks cold {cold_walks['n']} / warm "
          f"{warm_walks['n']}, warm report equal by bytes; host s cold "
          f"{cold_s:.4f} / warm {warm_s:.4f}; kernel launches {launches} "
          f"(card: {card_name})")
    golden_cells(card_name)
    return {"res": res, "cells": len(cells), "cold_s": cold_s,
            "warm_s": warm_s, "warm_walks": warm_walks["n"],
            "golden_floats_differ": len(gaps),
            "golden_max_gap": max(gaps, default=0.0)}


def advise_cli(card_name: str, work: Path, doc: dict) -> dict:
    """Phase 10 (b): ``advise`` through the CLI, cold (its entry function
    in this process, into an empty disk result cache) and then warm in a
    fresh process, whose results can come from nothing but that disk
    tier: both JSON reports equal by bytes, and equal to (a)'s
    document."""
    spec = work / "advise_spec.json"
    spec.write_text(json.dumps(ADVISE_SMOKE_SPEC))
    cache = work / "advise_rc"
    out = {}
    for leg in ("cold", "warm"):
        path = work / f"advise_{leg}.json"
        for *_, reset in KERNELS:
            reset()
        argv = ["advise", str(spec), "--trace",
                str(FIXTURES / "llama_tiny_tp2dp2"),
                "--result-cache", str(cache), "--json", str(path)]
        t0 = time.perf_counter()
        text = run_cli(argv) if leg == "cold" else cli_process(argv)[1]
        out[leg] = {"s": time.perf_counter() - t0,
                    "bytes": path.read_bytes(),
                    "stats": [ln.strip() for ln in text.splitlines()
                              if ln.strip().startswith("advise_")]}
        no_launches(f"the advise CLI ({leg})")
    # ``advise --json`` writes indent 2
    want = (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()
    if not out["cold"]["bytes"] == out["warm"]["bytes"] == want:
        raise AssertionError("advise CLI: cold, warm and (a)'s reports differ")
    print(f"  (b) advise CLI, cold in this process, warm in a fresh one: "
          f"cold "
          f"{out['cold']['s']:.2f} s / warm {out['warm']['s']:.2f} s; "
          f"reports equal by bytes and to (a)'s; "
          f"{'; '.join(out['warm']['stats'])} (card: {card_name})")
    return {leg: rec["s"] for leg, rec in out.items()}


@contextlib.contextmanager
def timing_permutes():
    """Per cell, the calls of the analytic collective model's
    ``permute_seconds``, the pairs they price (one ``hop_distance`` each)
    and the host seconds inside them; the cell is the one whose progress
    line comes next."""
    from tpusim_torch.ici.collectives import CollectiveModel

    per_cell: list[dict] = []
    cur = {"calls": 0, "pairs": 0, "s": 0.0}
    orig = CollectiveModel.permute_seconds

    def timed(self, payload, pairs):
        t0 = time.perf_counter()
        try:
            return orig(self, payload, pairs)
        finally:
            cur["s"] += time.perf_counter() - t0
            cur["calls"] += 1
            cur["pairs"] += len(pairs)

    def next_cell() -> None:
        per_cell.append(dict(cur))
        cur.update(calls=0, pairs=0, s=0.0)

    CollectiveModel.permute_seconds = timed
    try:
        yield per_cell, next_cell
    finally:
        CollectiveModel.permute_seconds = orig


def big_advise(card_name: str) -> dict:
    """Phase 10 (c): :func:`big_advise_spec` cold, warm through the same
    cache, and with :data:`BIG_ADVISE_WORKERS` pricing workers into a
    fresh cache; reports equal by bytes; per-cell seconds from
    ``progress``, and in the cold leg each cell's seconds inside
    ``permute_seconds``."""
    from tpusim_torch.advise import run_advise

    spec = big_advise_spec()
    cache = ResultCache()
    legs = {}
    for leg, kw in (("cold", {"result_cache": cache}),
                    ("warm", {"result_cache": cache}),
                    (f"workers {BIG_ADVISE_WORKERS}",
                     {"workers": BIG_ADVISE_WORKERS})):
        stamps = []
        for *_, reset in KERNELS:
            reset()
        with counting_engine_runs() as walks, timing_permutes() as (
                permutes, next_cell):
            def progress(msg: str) -> None:
                stamps.append((msg.split(":")[0], time.perf_counter()))
                next_cell()
            t0 = time.perf_counter()
            res = run_advise(spec, trace_path=FIXTURES / "llama_tiny_tp2dp2",
                             progress=progress, **kw)
            total = time.perf_counter() - t0
        no_launches(f"the v5p-{BIG_ADVISE_CHIPS} advise sweep ({leg})")
        starts = [t0] + [t for _, t in stamps[:-1]]
        legs[leg] = {"res": res, "s": total, "walks": walks["n"],
                     "cells": {c: t - s for (c, t), s in zip(stamps, starts)},
                     "permutes": dict(zip((c for c, _ in stamps), permutes))}
    if len({report_bytes(rec["res"].doc) for rec in legs.values()}) != 1:
        raise AssertionError(f"v5p-{BIG_ADVISE_CHIPS} advise: reports differ "
                             f"across {list(legs)}")
    if legs["warm"]["walks"] != 0:
        raise AssertionError(f"v5p-{BIG_ADVISE_CHIPS} advise: warm pass "
                             f"walked {legs['warm']['walks']} module(s)")
    doc = legs["cold"]["res"].doc
    for leg, rec in legs.items():
        print(f"  (c) advise v5p-{BIG_ADVISE_CHIPS} {leg}: "
              f"{len(doc['cells'])} cells, {rec['walks']} engine walks, "
              f"host {rec['s']:.4f} s; per cell s " + ", ".join(
                  f"{c} {t:.4f}" for c, t in rec["cells"].items())
              + f" (card: {card_name})")
    print(f"  (c) reports equal by bytes; recommendation "
          f"{doc['recommendation']['cell'] if doc['recommendation'] else None}")
    cold = legs["cold"]
    for cell, p in cold["permutes"].items():
        if p["calls"]:
            print(f"  (c) cold {cell}: permute_seconds {p['calls']} calls, "
                  f"{p['pairs']} pairs (hop_distance calls), {p['s']:.4f} of "
                  f"the cell's {cold['cells'][cell]:.4f} host s "
                  f"({p['s'] / cold['cells'][cell]:.1%})")
    return {"cells": len(doc["cells"]),
            "host_s": {leg: rec["s"] for leg, rec in legs.items()},
            "cell_s": cold["cells"], "permutes": cold["permutes"]}


def critpath_check(card_name: str) -> dict:
    """Phase 10 (d): the critical-path analyzer on every module of the
    corpus at v5p: critical path <= the engine's cycles <= serial sum."""
    from tpusim_torch.analysis import analyze_module_perf

    cfg = load_config(arch="v5p", tuned=False)
    for *_, reset in KERNELS:
        reset()
    t0 = time.perf_counter()
    modules = 0
    for trace_dir in critpath_corpus():
        pod = load_trace(trace_dir)
        for name, mod in sorted(pod.modules.items()):
            mp = analyze_module_perf(mod, cfg)
            eng = Engine(cfg).run(mod).cycles
            tol = 1e-6 * max(eng, 1.0)
            if not (mp.critical_path_cycles <= eng + tol
                    and eng <= mp.serial_cycles + tol):
                raise AssertionError(
                    f"{trace_dir.name}/{name}: critical path "
                    f"{mp.critical_path_cycles}, engine {eng}, serial "
                    f"{mp.serial_cycles}")
            modules += 1
    host_s = time.perf_counter() - t0
    no_launches("the critical-path analyzer")
    print(f"  (d) critical path <= engine <= serial sum on {modules} "
          f"modules of {len(critpath_corpus())} traces at v5p; host "
          f"{host_s:.4f} s (card: {card_name})")
    return {"modules": modules, "host_s": host_s}


def advisor(card_name: str, work: Path) -> dict:
    """Phase 10: (a)-(d) in ``work`` (an empty directory), the kernels'
    launch counters set to 0 just before each part and read just after
    (this path runs on the host).  Raises on any failure."""
    t0 = time.perf_counter()
    a = advise_smoke(card_name)
    out = {"a": {k: v for k, v in a.items() if k != "res"}}
    out["b"] = advise_cli(card_name, work, a["res"].doc)
    out["c"] = big_advise(card_name)
    out["d"] = critpath_check(card_name)
    print(f"sharding advisor: {time.perf_counter() - t0:.1f} s "
          f"(card: {card_name})")
    return out


#: phase 11: the workloads the general lowering captures — the ten with
#: committed silicon traces (``reports/silicon/manifest.json``), in the
#: order the port took them
LOWERED = ("elementwise_stream", "transcendental", "reduction",
           "matmul_chain", "attention_1chip", "conv2d", "embedding_lookup",
           "mlp_train_step", "decode_step", "lstm_layer")
#: phase 11 (c): rtol = atol per input dtype (tests/test_torch_workloads.py),
#: at the registered width (no workload takes the card's host 10 s there)
TOL_LOWERED = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: phase 11 (c): a later launch runs on the state the launch before it
#: left, which already differs between the card and the CPU by that
#: launch's rounding, so later launches are held norm-wise, ||card - cpu||
#: <= tol ||cpu||: conv2d and matmul_chain feed their unnormalised outputs
#: back as inputs, and near-zero outputs there carry the first launch's
#: differences past an elementwise bound.  Workloads held norm-wise from
#: the first launch on: matmul_chain's layers of unscaled N(0, 1) weights grow its values to
#: ~7e6 after four layers and ~8e12 after the second launch; outputs that
#: cancel to near zero carry the libraries' different summation orders
#: past any elementwise bound (a card run read 48652 of 4194304 elements
#: past 2e-2 in bfloat16, and 71 even in float32, at norm-wise 1.6e-3
#: and 1.4e-6)
NORMWISE = frozenset({"matmul_chain"})
#: phase 11 (d): the shapes each silicon trace was captured at (its entry
#: parameters); seven differ from the registered width, so the ratios to
#: the silicon totals are taken from a port capture at these shapes
SILICON_SHAPES = {
    "elementwise_stream": dict(elems=33554432),
    "transcendental": dict(elems=8388608),
    "reduction": dict(rows=4096, cols=4096),
    "matmul_chain": dict(m=2048, k=2048, depth=4),
    "attention_1chip": dict(batch=4, seq=1024, heads=8, head_dim=128),
    "conv2d": dict(batch=16, hw=56, cin=64, cout=64, ksize=3),
    "embedding_lookup": dict(vocab=131072, dim=1024, lookups=8192),
    "mlp_train_step": dict(batch=256, width=1024, depth=2),
    # the trace's pos is a runtime value; pricing reads only shapes
    "decode_step": dict(batch=8, seq_cache=1024, heads=8, head_dim=128,
                        layers=2, pos=512),
    "lstm_layer": dict(batch=64, hidden=1024, seq=64),
}
#: phase 11 (d): kernel cycles are tot_sim_cycles less memcpy_cycles: the
#: silicon traces hold no host copies
#: phase 11 (d): the totals set beside the silicon traces'
SIM_KEYS = ("tot_mxu_flops", "tot_flops", "tot_hbm_bytes", "tot_sim_cycles",
            "kernel_cycles")


def per_step(stats: dict, steps: int) -> dict:
    stats = dict(stats, kernel_cycles=stats["tot_sim_cycles"]
                 - stats["memcpy_cycles"])
    return {k: stats[k] / steps for k in SIM_KEYS}


def card_vs_cpu(name: str, card_dir: Path, work: Path) -> dict:
    """Phase 11 (c): the snapshot buffers of the CLI's capture on the card
    (in ``card_dir``) against a CPU run of the same module on the same
    inputs (2 launches each)."""
    module, args = get_workload(name).build(device="cuda")
    tol = TOL_LOWERED[args[0].dtype]
    on_card = sorted(card_dir.glob("*.npy"))
    t0 = time.perf_counter()
    on_cpu = snapshot_buffers(module, *(a.cpu() for a in args),
                              out_dir=work / "cpu", launches=2)
    cpu_s = time.perf_counter() - t0
    on_cpu = sorted(on_cpu)
    if [p.name for p in on_card] != [p.name for p in on_cpu]:
        raise AssertionError(f"{name}: snapshot files differ")
    worst, err = 0.0, 0.0
    for a, b in zip(on_card, on_cpu):
        x, y = np.load(a), np.load(b)
        if x.shape != y.shape or not np.isfinite(x).all():
            raise AssertionError(f"{name}: bad snapshot {a.name}")
        gap = np.abs(x - y)
        err = max(err, float(gap.max(initial=0.0)))
        if name in NORMWISE or not a.name.startswith("launch0_"):
            frac = float(np.linalg.norm(gap.astype(np.float64))
                         / np.linalg.norm(y.astype(np.float64)) / tol)
        else:
            frac = float((gap / (tol + tol * np.abs(y))).max(initial=0.0))
        worst = max(worst, frac)
    if worst > 1.0:
        raise AssertionError(
            f"{name}: card and CPU snapshots differ beyond {tol} "
            f"(worst {worst:.3g} of the tolerance)")
    return {"max_abs_err": err, "tol": tol, "worst_of_tol": worst,
            "normwise": name in NORMWISE, "cpu_s": cpu_s,
            "buffers": len(on_card)}


def lowered_workloads(card_name: str, work: Path) -> dict:
    """Phase 11: each workload at its registered width on the card — (a)
    capture through the CLI, (b) the same HLO on the CPU, (c) the
    snapshots against the CPU, (d) simulated per step at v5e and v5p
    beside the silicon trace's totals per step, (e) the step's median time
    on the card, (f) no custom kernel launched."""
    manifest = json.loads(
        (REPO / "reports" / "silicon" / "manifest.json").read_text())
    n_steps = {w["name"]: w["n_steps"] for w in manifest["workloads"]}
    for *_, reset in KERNELS:
        reset()
    t_phase = time.perf_counter()
    rows = {}
    for name in LOWERED:
        trace = work / name
        t0 = time.perf_counter()
        run_cli(["capture", name, str(trace), "--launches", "2",
                 "--snapshot"])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        module, args = get_workload(name).build(device="cuda")
        card_text = (trace / "modules" / f"{name}.hlo").read_text()
        # the CPU capture only reads shapes and dtypes
        cpu_args = tuple(a.cpu() if a.dim() == 0 else
                         torch.empty(a.shape, dtype=a.dtype) for a in args)
        cpu_text, _ = export_to_hlo(module, cpu_args, name)
        if cpu_text != card_text:
            raise AssertionError(f"{name}: the card's HLO differs from the "
                                 f"CPU's")
        check = card_vs_cpu(name, trace / "checkpoint_files",
                            work / f"{name}_snapshots")
        shutil.rmtree(trace / "checkpoint_files")
        shutil.rmtree(work / f"{name}_snapshots")
        sim = {}
        for arch in ("v5e", "v5p"):
            st = stats_of(simulate_trace(trace, arch=arch, tuned=False))
            if st["tot_unknown_trip_loops"]:
                raise AssertionError(f"{name}: unresolved loop trip count")
            sim[arch] = per_step(st, st["kernel_launches"])
        silicon = per_step(stats_of(simulate_trace(
            REPO / "reports" / "silicon" / name, arch="v5e", tuned=False)),
            n_steps[name])
        at = work / f"{name}_silicon_shapes"
        sil_module, sil_args = get_workload(name).build(
            device="cuda", **SILICON_SHAPES[name])
        capture_to_dir(at, sil_module, *sil_args, name=name)
        same = per_step(stats_of(simulate_trace(at, arch="v5e",
                                                tuned=False)), 1)
        ratio = {k: (same[k] / silicon[k] if silicon[k] else None)
                 for k in SIM_KEYS}
        ratio_registered = {
            k: (sim["v5e"][k] / silicon[k] if silicon[k] else None)
            for k in SIM_KEYS}
        wall = measure_wall_time(module, *args, iters=5, warmup=2)
        rows[name] = {
            "params": get_workload(name).params, "capture_s": capture_s,
            "hlo_bytes": len(card_text), "card_vs_cpu": check,
            "sim_per_step": sim, "silicon_v5e_per_step": silicon,
            "n_steps": n_steps[name], "silicon_shapes": SILICON_SHAPES[name],
            "v5e_at_silicon_shapes": same, "v5e_over_silicon": ratio,
            "registered_v5e_over_silicon": ratio_registered,
            "median_ms": wall["median_s"] * 1e3,
        }
        print(f"  {name}: capture {capture_s:.2f} s, HLO card == CPU "
              f"({len(card_text)} B); card vs CPU max |err| "
              f"{check['max_abs_err']:.3g} ({check['worst_of_tol']:.3g} of "
              f"tol {check['tol']}{', norm-wise' if check['normwise'] else ''}); "
              f"median "
              f"{rows[name]['median_ms']:.4f} ms on {card_name}", flush=True)
        for arch in ("v5e", "v5p"):
            print(f"    {arch} per step: " + ", ".join(
                f"{k} {sim[arch][k]:.6g}" for k in SIM_KEYS))
        print("    silicon v5e per step (/" + str(n_steps[name]) + "): "
              + ", ".join(f"{k} {silicon[k]:.6g}" for k in SIM_KEYS))
        for tag, r in (("registered", ratio_registered),
                       ("at the silicon shapes", ratio)):
            print(f"    v5e / silicon, {tag}: " + ", ".join(
                f"{k} {r[k]:.4g}" if r[k] is not None else f"{k} n/a"
                for k in SIM_KEYS))
        torch.cuda.empty_cache()
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    if any(launches.values()):
        raise AssertionError(f"phase 11 launched a custom kernel: {launches}")
    seconds = time.perf_counter() - t_phase
    print(f"  kernel launches across phase 11: {launches}; {seconds:.1f} s")
    return {"workloads": rows, "launches": launches, "seconds": seconds,
            "card": card_name}


#: phase 12: the multi-device workloads, each at its registered width
#: (ici_allreduce over 8 devices: its world is a build override)
MULTI = ("ici_allreduce", "ulysses_attention_sp8", "moe_ep4", "llama_tiny",
         "llama_tiny_tp2dp2", "decode_step_tp8", "ring_attention_sp8")
MULTI_SETS = {"ici_allreduce": {"world": 8}}
#: phase 12 (d): golden cells 3-5's (arch, overlays, name), for
#: llama_tiny_tp2dp2; the others at the first
GOLDEN_ARCHES = tuple(
    (arch, overlays, " ".join([arch, *(json.dumps(o) for o in overlays)]))
    for _, arch, overlays, _ in GOLDEN_CELLS[2:])
#: phase 12 (d): the totals printed beside the fixture's
MULTI_KEYS = ("tot_mxu_flops", "tot_collective_count", "tot_ici_bytes",
              "tot_hbm_bytes", "tot_sim_cycles")
#: phase 12 (c): attention's unsharded reference runs this many query rows
#: at a time (softmax rows are independent; a whole [1, 16, 16384, 16384]
#: f32 score matrix is 16 GiB)
ATTN_QUERY_BLOCK = 2048


def unsharded(name: str, module, args) -> list[torch.Tensor]:
    """Phase 12 (c): the workload's unsharded computation, on the device
    its arguments lie on."""
    from tpusim_torch.models.attention import attention
    from tpusim_torch.models.decode import DecodeStep
    from tpusim_torch.models.llama import LlamaTrainStep
    from tpusim_torch.models.moe import round_robin_moe

    with torch.no_grad():
        if name == "ici_allreduce":
            x = args[0]
            n = module.world
            return [(x.view(n, -1).sum(0) * (1.0 / n)).repeat(n)]
        if name in ("ulysses_attention_sp8", "ring_attention_sp8"):
            q, k, v = args
            return [torch.cat([attention(qb, k, v) for qb in
                               q.split(ATTN_QUERY_BLOCK, dim=1)], dim=1)]
        if name == "moe_ep4":
            return [round_robin_moe(*args, ep=module.world)]
        if name == "decode_step_tp8":
            hidden, ck = args[0], args[1]
            return list(DecodeStep(hidden.shape[0], ck.shape[2],
                                   module.heads, module.head_dim)(*args))
        if name == "llama_tiny_tp2dp2":
            step = LlamaTrainStep(module.cfg, None, module.batch, module.lr)
            return list(step(*args))
        if name == "llama_tiny":
            # a single-chip workload: the same module on the CPU
            return [module(*(a.cpu() for a in args))]
    raise KeyError(name)


def grads_held(module, args) -> dict:
    """Phase 12 (c) for ``llama_tiny_tp2dp2``: the float32 gradients the
    dp all-reduce carries, from the N ranks, against the single-rank step's
    on the whole batch, each within 2e-2 of its norm (the bfloat16
    tolerance).  A bf16 SGD step of 3e-4 leaves most parameters unchanged,
    so only the gradients show the backward."""
    from tpusim_torch.models.llama import LlamaTrainStep

    single = LlamaTrainStep(module.cfg, None, module.batch, module.lr)
    got, want = module.grads(*args), single.grads(*args)
    errs = [float((g.double() - w.double()).norm() / w.double().norm())
            for g, w in zip(got[1:], want[1:])]
    loss_err = abs(got[0].item() - want[0].item())
    if max(errs) > TOL_LOWERED[torch.bfloat16] or loss_err > 1e-4 * abs(
            want[0].item()):
        raise AssertionError(f"llama_tiny_tp2dp2: gradients differ from the "
                             f"single-rank step's (norm-wise errors up to "
                             f"{max(errs):.3g}, loss {loss_err:.3g})")
    return {"leaves": len(errs), "max_norm_err": max(errs),
            "min_norm_err": min(errs), "loss_abs_err": loss_err}


def held_to(name: str, snaps: list[Path], want: list[torch.Tensor]) -> dict:
    """Phase 12 (c): the CLI's snapshot buffers (the N ranks' global
    outputs) against the unsharded computation, elementwise within
    |x - y| <= tol + tol |y| at the outputs' dtype."""
    if len(snaps) != len(want):
        raise AssertionError(f"{name}: {len(snaps)} snapshots, "
                             f"{len(want)} outputs")
    worst, err = 0.0, 0.0
    for path, w in zip(snaps, want):
        tol = TOL_LOWERED[w.dtype] if w.is_floating_point() else 0.0
        x = np.load(path)
        y = w.detach().float().cpu().numpy() if w.is_floating_point() \
            else w.cpu().numpy()
        if x.shape != y.shape or not np.isfinite(x).all():
            raise AssertionError(f"{name}: bad snapshot {path.name} "
                                 f"{x.shape} vs {y.shape}")
        gap = np.abs(x.astype(np.float64) - y.astype(np.float64))
        err = max(err, float(gap.max(initial=0.0)))
        if tol:
            worst = max(worst, float((gap / (tol + tol * np.abs(y)))
                                     .max(initial=0.0)))
        elif gap.any():
            worst = math.inf
    if worst > 1.0:
        raise AssertionError(f"{name}: the {len(snaps)} outputs differ from "
                             f"the unsharded computation (worst {worst:.3g} "
                             f"of the tolerance)")
    return {"max_abs_err": err, "worst_of_tol": worst}


def multi_device(card_name: str, work: Path) -> dict:
    """Phase 12: the multi-device workloads at registered width, all of a
    workload's ranks on the one card through ``run_ranks`` — (a)
    ``capture W DIR --snapshot`` through the CLI, timed; (b) the module
    text captured on the card equals by bytes the text the same torch
    lowers from CPU tensors of the same shapes; (c) the snapshots (the
    global outputs of the N ranks) against the workload's unsharded
    computation on the card; (d) simulated at v5p, and llama_tiny_tp2dp2
    also at golden cells 3-5's arches, beside the fixture; (e) the median
    of a whole N-rank step; (f) no custom kernel launched."""
    from tpusim_torch.tracer.capture import capture

    for *_, reset in KERNELS:
        reset()
    t_phase = time.perf_counter()
    rows = {}
    fixture = {cell: stats_of(simulate_trace(
        FIXTURES / "llama_tiny_tp2dp2", arch=arch, tuned=False,
        overlays=overlays)) for arch, overlays, cell in GOLDEN_ARCHES}
    for name in MULTI:
        sets = MULTI_SETS.get(name, {})
        trace = work / name
        t0 = time.perf_counter()
        run_cli(["capture", name, str(trace), "--snapshot",
                 *(f"--set={k}={v}" for k, v in sets.items())])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        module, args = get_workload(name).build(device="cuda", **sets)
        card_text = (trace / "modules" / f"{name}.hlo").read_text()
        cpu_args = tuple(a.cpu() if a.dim() == 0 else
                         torch.empty(a.shape, dtype=a.dtype) for a in args)
        if capture(module, *cpu_args, name=name).hlo_text != card_text:
            raise AssertionError(f"{name}: the card's HLO differs from the "
                                 f"CPU's")
        del cpu_args
        snaps = sorted((trace / "checkpoint_files").glob("launch0_*.npy"),
                       key=lambda p: int(p.stem.split("buf")[1]))
        check = held_to(name, snaps, unsharded(name, module, args))
        if name == "llama_tiny_tp2dp2":
            check["grads"] = grads_held(module, args)
            print(f"  {name}: gradients vs the single-rank step, "
                  f"{check['grads']['leaves']} leaves, norm-wise error "
                  f"{check['grads']['min_norm_err']:.4g}-"
                  f"{check['grads']['max_norm_err']:.4g}; loss |err| "
                  f"{check['grads']['loss_abs_err']:.3g} ({card_name})",
                  flush=True)
        shutil.rmtree(trace / "checkpoint_files")
        torch.cuda.empty_cache()
        cells = {}
        for arch, overlays, cell in (GOLDEN_ARCHES
                                     if name == "llama_tiny_tp2dp2"
                                     else GOLDEN_ARCHES[:1]):
            st = stats_of(simulate_trace(trace, arch=arch, tuned=False,
                                         overlays=overlays))
            cells[cell] = {k: st[k] for k in MULTI_KEYS}
        wall = measure_wall_time(module, *args, iters=3, warmup=1)
        world = getattr(module, "world", 1)
        rows[name] = {"world": world, "capture_s": capture_s,
                      "hlo_bytes": len(card_text), "vs_unsharded": check,
                      "sim": cells, "median_ms": wall["median_s"] * 1e3}
        print(f"  {name} ({world} ranks): capture {capture_s:.2f} s, HLO "
              f"card == CPU ({len(card_text)} B); vs unsharded max |err| "
              f"{check['max_abs_err']:.3g} ({check['worst_of_tol']:.3g} of "
              f"tol); median step {rows[name]['median_ms']:.4f} ms on "
              f"{card_name}", flush=True)
        for cell, st in cells.items():
            line = ", ".join(f"{k} {st[k]:.10g}" for k in MULTI_KEYS)
            print(f"    {cell}: {line}")
            if name == "llama_tiny_tp2dp2":
                fx = fixture[cell]
                print("      fixture: " + ", ".join(
                    f"{k} {fx[k]:.10g}" for k in MULTI_KEYS))
                if st["tot_mxu_flops"] != fx["tot_mxu_flops"]:
                    raise AssertionError(f"{name} @ {cell}: MXU flops "
                                         f"differ from the fixture's")
        del module, args
        torch.cuda.empty_cache()
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    if any(launches.values()):
        raise AssertionError(f"phase 12 launched a custom kernel: {launches}")
    seconds = time.perf_counter() - t_phase
    print(f"  kernel launches across phase 12: {launches}; {seconds:.1f} s")
    return {"workloads": rows, "launches": launches, "seconds": seconds,
            "card": card_name}


#: phase 13: the model suite, each at its registered width
MODELS = ("llama_tiny_train", "llama7b", "moe_ep8_train", "pipeline_pp4",
          "resnet50", "resnet50_train", "resnet50_dp8", "llama7b_tp8dp8",
          "llama7b_aot_v5p64")
#: phase 13 (a, b, d, e): the depth the unrolled 7B captures run at — 4 of
#: their 32 layers at full width (every layer lowers to the same ops, and
#: the capture and its CPU re-capture take time in proportion to depth:
#: 32 layers of ``llama7b`` took 41 s each way, 8 layers 9.6-23.4 s on the
#: card's hosts; the checks of (c) keep their own configurations)
CAPTURE_DEPTH = {"llama7b": dict(layers=4), "llama7b_tp8dp8": dict(layers=4)}
#: phase 13 (c): the small configuration the 64-way step's ranks run at
#: on the card (7B's structure cut to size, as tests/test_torch_models.py)
LLAMA_SMALL = dict(vocab=512, dim=256, layers=2, heads=8, kv_heads=8,
                   ffn=512, batch=16, seq=32)
#: phase 13 (c): the card-vs-CPU runs' cuts of registered width.  The
#: ResNets are held end to end in float32 (and the train step in
#: float64): a batch-norm network at init spreads rounding with depth, so
#: in bfloat16 the card's and the CPU's gradients lie 127% apart at 224²,
#: batch 2; their bfloat16 is held where it is well conditioned
#: (:func:`resnet_bf16_held`)
CARD_VS_CPU = {"llama7b": dict(layers=2, seq=256),
               "resnet50": dict(batch=2, dtype="float32"),
               "resnet50_train": dict(batch=2, dtype="float32")}
#: phase 13 (c): the workloads whose card run is held against a float32
#: evaluation on the CPU of the same (bf16) parameters and tokens, not
#: against the CPU's bf16 run: on the card the decoder's attention is the
#: causal kernel (float32 scores), on the CPU the score chain (scores
#: rounded to bf16), whose own distance from float32 is reported beside it
#: (``llama7b``, 2 layers, seq 256, on an H100 80GB HBM3: the CPU's bf16
#: run 1.01 of the 2e-2 from float32, norm-wise)
F32_HELD = ("llama7b",)
#: phase 13 (c): the ResNets' float32 logits, norm-wise (the JAX
#: package's own float32 logits lie 1.7e-4 from its float64 ones,
#: norm-wise, at batch 8, 32²)
TOL_RESNET_F32 = 1e-3
#: phase 13 (c): the train step runs card and CPU in float64 (its float32
#: gradients at batch 2 spread by 3% between the two, as the network's
#: conditioning amplifies the convolutions' rounding), each output and
#: gradient within this of the CPU's norm
F64_CHECK = {"resnet50_train": 1e-9}
#: phase 13 (c): resnet50_dp8's ranks against the one-rank step, float64
DP8_F64_BATCH = 64
#: phase 13 (c): the ResNets in bfloat16, norm-wise, card against CPU:
#: resnet50's logits and resnet50_train's loss at 224², batch 2 (every
#: other output of the step is the network's conditioning's), and each
#: batch-norm layer alone on its input of the CPU forward at 224², batch
#: 8 (:func:`bn_layers_held`): its output and its vjp.  Readings on an
#: H100 80GB HBM3 at 700 W: logits 4.8e-2, loss 9.9e-4, batch-norm
#: outputs 2.8e-4, vjps 8e-6 (one device) and 4.3e-3 (8 ranks)
RESNET_BF16 = dict(batch=2, dtype="bfloat16")
BN_BATCH = 8
TOL_RESNET_BF16 = {"logits": 0.1, "loss": 0.02, "bn_out": 2e-3,
                   "bn_grad": 2e-2}
SIM_MODEL_KEYS = ("tot_mxu_flops", "tot_collective_count", "tot_ici_bytes")


def close(name: str, got, want, tol: float, normwise: bool) -> dict:
    """Phase 13 (c): ``got`` against ``want`` (tensors, any device),
    elementwise within ``tol + tol |y|`` or norm-wise within ``tol``."""
    worst, err = 0.0, 0.0
    for g, w in zip(got, want):
        x, y = g.detach().double().cpu(), w.detach().double().cpu()
        if x.shape != y.shape or not torch.isfinite(x).all():
            raise AssertionError(f"{name}: bad output {tuple(x.shape)} vs "
                                 f"{tuple(y.shape)}")
        gap = (x - y).abs()
        err = max(err, float(gap.max()) if gap.numel() else 0.0)
        if normwise:
            if float(y.norm()) > 0:
                worst = max(worst, float(gap.norm() / y.norm()) / tol)
        else:
            worst = max(worst, float((gap / (tol + tol * y.abs())).max()))
    if worst > 1.0:
        raise AssertionError(f"{name}: outputs differ beyond {tol} "
                             f"({'norm-wise' if normwise else 'elementwise'}"
                             f", worst {worst:.3g} of the tolerance)")
    return {"max_abs_err": err, "worst_of_tol": worst, "tol": tol,
            "normwise": normwise, "outputs": len(got)}


def _listed(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def module_text(trace: Path, name: str) -> str:
    """A trace's module text, stored plain or (a large one) gzipped."""
    import gzip

    plain = trace / "modules" / f"{name}.hlo"
    if plain.exists():
        return plain.read_text()
    return gzip.decompress((trace / "modules" / f"{name}.hlo.gz")
                           .read_bytes()).decode()


def model_numerics(name: str) -> dict:
    """Phase 13 (c): each workload's check: the card
    against the CPU for the single-chip ones (at a cut of registered width
    where one is listed), the ranks against the unsharded computation on
    the card for the sharded ones; replicated outputs of the rank runner
    equal bit for bit (``unshard`` refuses a disagreeing replica)."""
    from tpusim_torch.models.moe import MoeTrainStep
    from tpusim_torch.models.pipeline import reference_forward
    from tpusim_torch.models.resnet import ResNet50Train

    wl = get_workload(name)
    kw = CARD_VS_CPU.get(name, {})
    # the train steps' gradients come from function transforms, which an
    # outer no_grad does not reach
    with torch.no_grad():
        if name == "moe_ep8_train":
            module, args = wl.build(device="cuda")
            single = MoeTrainStep(1, module.tokens, shards=module.world)
            out = close(name, module.run(*args), single(*args),
                        TOL_LOWERED[torch.float32], False)
            got, want = module.grads(*args), single.grads(*args)
            out["grads"] = close(name, got, want, 2e-2, True)
            return out
        if name == "pipeline_pp4":
            module, args = wl.build(device="cuda")
            return close(name, [module.run(*args)], [reference_forward(*args)],
                         TOL_LOWERED[torch.float32], False)
        if name == "resnet50_dp8":
            # in float64 at 224² and 8 samples a rank: in float32 the two
            # sum the batch-norm statistics in another order, which the
            # network's conditioning spreads to 2.3% on the gradients at
            # batch 256 (bf16: up to 10%, CPU, 224², batch 16); float64 at
            # batch 256 would not fit twice in 80 GB
            module, args = wl.build(device="cuda", batch=DP8_F64_BATCH,
                                    dtype="float32")
            args = tuple(a.double() if a.is_floating_point() else a
                         for a in args)
            single = ResNet50Train(1000, module.batch)
            got = module.grads(*args)
            gc.collect()
            torch.cuda.empty_cache()
            want = single.grads(*args)
            out = close(name, got[:1], want[:1], 1e-9, True)
            out["grads"] = close(name, got[1:], want[1:], 1e-9, True)
            out["cut"] = {"batch": DP8_F64_BATCH, "dtype": "float64"}
            del module, args, single, got, want
            gc.collect()
            torch.cuda.empty_cache()
            out["bf16"] = {"bn_layers": bn_layers_held(8)}
            return out
        if name in ("llama7b_tp8dp8", "llama7b_aot_v5p64"):
            small = dict(LLAMA_SMALL, dtype="float32")
            module, args = wl.build(device="cuda", **small)
            single, _ = wl.build(device="cuda", dp=1, tp=1, **small)
            got, want = module.grads(*args), single.grads(*args)
            out = close(name, got[:1], want[:1], TOL_LOWERED[torch.float32],
                        False)
            out["grads"] = close(name, got[1:], want[1:], 2e-2, True)
            out["ranks"] = module.world
            if name == "llama7b_aot_v5p64":
                out["scan_backward"] = scan_backward_held(single, args, want)
            return out
        # single chip: the card against the CPU on the same inputs
        out = card_against_cpu(name, kw)
        if name.startswith("resnet50"):
            out["bf16"] = resnet_bf16_held(name)
        return out


def resnet_bf16_held(name: str) -> dict:
    """Phase 13 (c), bfloat16 (:data:`TOL_RESNET_BF16`): ``resnet50``'s
    logits or ``resnet50_train``'s loss on the card against the CPU at
    :data:`RESNET_BF16`, every output of the CPU's dtype and finite; for
    the train step also each batch-norm layer alone."""
    module, args = get_workload(name).build(device="cuda", **RESNET_BF16)
    cpu_args = tuple(a.cpu() for a in args)
    train = getattr(module, "train_step", False)
    run = module.run if train else module
    with torch.no_grad():
        got, want = _listed(run(*args)), _listed(run(*cpu_args))
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: a bfloat16 output of dtype "
                                 f"{g.dtype} (CPU {w.dtype}) or not finite")
    key = "loss" if train else "logits"
    out = close(f"{name} bfloat16 {key}", got[:1], want[:1],
                TOL_RESNET_BF16[key], True)
    out["cut"] = RESNET_BF16
    if train:
        del module, args, got
        out["bn_layers"] = bn_layers_held(1)
    return out


_BN_INPUTS: list = []


def bn_layers_held(ranks: int) -> dict:
    """Phase 13 (c), bfloat16: each of ``resnet50``'s 53 batch-norms alone
    on its input in the CPU forward at 224², batch :data:`BN_BATCH` (the
    input, scale and bias its ``_BatchNorm`` saw), its output and the vjp
    of a seeded cotangent (input, scale, bias) on the card against the
    CPU's, norm-wise: on one device, or synchronized over ``ranks`` (one
    sample each; the bias's gradient summed over them)."""
    from tpusim_torch.models import resnet as rn
    from tpusim_torch.spmd import Mesh, P, psum, run_ranks

    if not _BN_INPUTS:
        module, args = get_workload("resnet50").build(
            device="cpu", batch=BN_BATCH, dtype="bfloat16")
        plain = rn._BatchNorm.plain

        def spy(bn):
            _BN_INPUTS.append((bn.x, bn.scale, bn.bias))
            return plain(bn)

        rn._BatchNorm.plain = spy
        try:
            with torch.no_grad():
                module(*args)
        finally:
            rn._BatchNorm.plain = plain
    mesh = Mesh((ranks,), ("dp",))

    def vjp(x, scale, bias, ct, mesh=None):
        def norm(x, s, b):
            net = rn._Net({"scale": s, "bias": b}, mesh, BN_BATCH)
            return net.norm(x, "scale", "bias")

        y, back = torch.func.vjp(norm, x, scale, bias)
        return (y, *back(ct))

    def rank(x, scale, bias, ct):
        y, dx, ds, db = vjp(x, scale, bias, ct, mesh)
        return y, dx, ds, psum(db, mesh, "dp")

    gen = torch.Generator().manual_seed(7)
    worst = [0.0, 0.0]
    for x, scale, bias in _BN_INPUTS:
        ct = torch.randn(x.shape, generator=gen).to(x.dtype)
        want = vjp(x, scale, bias, ct)
        card = [t.cuda() for t in (x, scale, bias, ct)]
        if ranks == 1:
            got = vjp(*card)
        else:
            got = run_ranks(rank, mesh, *card,
                            in_specs=(P("dp"), P(), P(), P("dp")),
                            out_specs=(P("dp"), P("dp"), P(), P()))
        errs = [float((g.double().cpu() - w.double()).norm()
                      / w.double().norm()) for g, w in zip(got, want)]
        worst = [max(worst[0], errs[0]), max(worst[1], *errs[1:])]
    tol = (TOL_RESNET_BF16["bn_out"], TOL_RESNET_BF16["bn_grad"])
    if worst[0] > tol[0] or worst[1] > tol[1]:
        raise AssertionError(f"resnet50 batch-norms over {ranks} ranks, "
                             f"bfloat16: output {worst[0]:.3g} (tol "
                             f"{tol[0]}), vjp {worst[1]:.3g} (tol {tol[1]})")
    return {"layers": len(_BN_INPUTS), "ranks": ranks, "out": worst[0],
            "vjp": worst[1], "tol_out": tol[0], "tol_vjp": tol[1],
            "batch": BN_BATCH}


def card_against_cpu(name: str, kw: dict) -> dict:
    """Phase 13 (c) for a single-chip workload built with ``kw``: its
    outputs (and a train step's gradients) on the card against a CPU run
    on the same inputs."""
    module, args = get_workload(name).build(device="cuda", **kw)
    f64 = name in F64_CHECK
    if f64:
        args = tuple(a.double() if a.is_floating_point() else a
                     for a in args)
    cpu_args = tuple(a.cpu() for a in args)
    train = getattr(module, "train_step", False)
    # the 53 batch-norms, and the 4096-wide bf16 products of 7B
    normwise = name.startswith("resnet50") or name == "llama7b"
    dtype = next(a.dtype for a in args if a.is_floating_point())
    tol = (F64_CHECK[name] if f64 else TOL_RESNET_F32
           if name.startswith("resnet50") and dtype == torch.float32
           else TOL_LOWERED[dtype])
    run = module.run if train else module
    with torch.no_grad():
        pair = (_listed(run(*args)), _listed(run(*cpu_args)))
        if name in F32_HELD:
            f32 = _listed(run(*(a.float() if a.is_floating_point() else a
                                for a in cpu_args)))
    if name in F32_HELD:
        # the card's run held within ``tol`` of float32; the CPU's (the
        # score chain, scores rounded to bf16) and the two apart are
        # readings, printed before the check
        rel = [close(f"{name} {label}", *two, 1.0, normwise)["worst_of_tol"]
               / tol for label, two in (("card vs float32", (pair[0], f32)),
                                        ("CPU vs float32", (pair[1], f32)),
                                        ("card vs CPU", pair))]
        print(f"  {name} against float32 on the CPU: card {rel[0]:.3g} of "
              f"tol {tol}{', norm-wise' if normwise else ''}; readings: CPU "
              f"{rel[1]:.3g}, card vs CPU {rel[2]:.3g}", flush=True)
        out = close(f"{name} card vs float32", pair[0], f32, tol, normwise)
        out.update(card_vs_f32=rel[0], cpu_vs_f32=rel[1], card_vs_cpu=rel[2])
    else:
        out = close(name, *pair, tol, normwise)
    if train:
        out["grads"] = close(name, module.grads(*args),
                             module.grads(*cpu_args), tol if f64 else 2e-2,
                             True)
    out["cut"] = dict(kw, dtype="float64") if f64 else kw
    return out


def scan_backward_held(aot, args, want) -> dict:
    """Phase 13 (c) for ``llama7b_aot_v5p64``: its hand-written layer
    backward (the reversed scan) against autograd of the same layers
    unrolled (``LlamaTrainStep``), one rank, float32, each gradient
    within 1e-4 of its norm."""
    from tpusim_torch.models.llama import LAYER_KEYS, LlamaTrainStep

    embed, final_norm, *stacked = args[:-2]
    flat = [embed, final_norm] + [stacked[j][i]
                                  for i in range(aot.cfg.layers)
                                  for j in range(len(LAYER_KEYS))]
    ref = LlamaTrainStep(aot.cfg, None, aot.batch).grads(*flat, *args[-2:])
    got = [want[0], want[1], want[2]] + [
        want[3 + j][i] for i in range(aot.cfg.layers)
        for j in range(len(LAYER_KEYS))]
    return close("llama7b_aot_v5p64 scan backward", got, list(ref), 1e-4,
                 True)


def bf16_note(held: dict | None) -> str:
    """Phase 13's line: the bfloat16 checks' readings beside their
    limits."""
    if not held:
        return ""
    parts = []
    if "worst_of_tol" in held:
        parts.append(f"{held['max_abs_err']:.3g} max |err|, "
                     f"{held['worst_of_tol']:.3g} of tol {held['tol']}")
    bn = held.get("bn_layers")
    if bn:
        parts.append(f"{bn['layers']} batch-norms over {bn['ranks']} "
                     f"rank(s): output {bn['out']:.3g} (tol {bn['tol_out']}),"
                     f" vjp {bn['vjp']:.3g} (tol {bn['tol_vjp']})")
    return ", bf16 " + "; ".join(parts)


#: phase 13 (b): the CPU re-captures, in a fresh process that runs beside
#: the phase (it never touches the card): each concrete workload built on
#: the CPU at the card's width and depth, captured from CPU tensors of its
#: arguments' shapes (0-d arguments keep their values), the module text
#: written to ``OUT/<name>.hlo`` and each capture's seconds to
#: ``OUT/seconds.json``
RECAPTURE_CHILD = r"""
import json, sys, time
from pathlib import Path
repo, out_dir, jobs = sys.argv[1:]
sys.path.insert(0, repo)
import torch
torch.set_num_threads(2)
from tpusim_torch.models import get_workload
from tpusim_torch.tracer.capture import capture
seconds = {}
for name, depth in json.loads(jobs):
    t0 = time.perf_counter()
    module, args = get_workload(name).build(device="cpu", **depth)
    cpu_args = tuple(a if a.dim() == 0 else
                     torch.empty(a.shape, dtype=a.dtype) for a in args)
    text = capture(module, *cpu_args, name=name).hlo_text
    (Path(out_dir) / f"{name}.hlo").write_text(text)
    del module, args, cpu_args
    seconds[name] = time.perf_counter() - t0
(Path(out_dir) / "seconds.json").write_text(json.dumps(seconds))
"""


def start_recaptures(work: Path) -> tuple:
    """Phase 13 (b)'s CPU side, started in the background
    (:data:`RECAPTURE_CHILD`); :func:`finish` joins it."""
    out = work / "recaptured"
    out.mkdir()
    jobs = [(name, CAPTURE_DEPTH.get(name, {})) for name in MODELS
            if not get_workload(name).abstract]
    return start([sys.executable, "-c", RECAPTURE_CHILD, str(REPO),
                  str(out), json.dumps(jobs)], work / "recapture.log",
                 child_env(CUDA_VISIBLE_DEVICES=""))


def model_suite(card_name: str, work: Path) -> dict:
    """Phase 13: the model suite at registered width — (a) ``capture W
    DIR`` through the CLI, timed (the 64-way ``llama7b_tp8dp8`` over meta
    tensors: nothing materialised, and ``--snapshot`` refused); (b) the
    concrete ones' HLO captured on the card equals by bytes the text
    lowered from CPU tensors of the same shapes (captured in a fresh
    process beside the phase, :func:`start_recaptures`); (c) each
    workload's numerics check (:func:`model_numerics`); (d) simulated at
    v5p: MXU flops, collectives and ICI bytes; (e) the median step on the
    card and the peak of ``torch.cuda.max_memory_allocated`` over the
    workload's part; (f) no custom kernel launched."""
    for *_, reset in KERNELS:
        reset()
    t_phase = time.perf_counter()
    recapture = start_recaptures(work)
    card_texts = {}
    rows = {}
    for name in MODELS:
        wl = get_workload(name)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trace = work / name
        depth = CAPTURE_DEPTH.get(name, {})
        t0 = time.perf_counter()
        run_cli(["capture", name, str(trace)]
                + [f"--set={k}={v}" for k, v in depth.items()])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        text = module_text(trace, name)
        row = {"world": wl.num_devices, "capture_s": capture_s,
               "hlo_bytes": len(text), "abstract": wl.abstract, **depth}
        if wl.abstract:
            buf = io.StringIO()
            with contextlib.redirect_stderr(buf):
                rc = cli(["capture", name, str(work / f"{name}_snap"),
                          "--snapshot"])
            if rc == 0 or "needs concrete inputs" not in buf.getvalue():
                raise AssertionError(f"{name}: --snapshot of an abstract "
                                     f"capture did not refuse")
            shutil.rmtree(work / f"{name}_snap", ignore_errors=True)
            row["median_ms"] = None
        else:
            card_texts[name] = text
            t0 = time.perf_counter()
            module, args = wl.build(device="cuda", **depth)
            wall = measure_wall_time(module, *args, iters=3, warmup=1)
            row["median_ms"] = wall["median_s"] * 1e3
            row["step_s"] = time.perf_counter() - t0
            del module, args
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        row["check"] = model_numerics(name)
        row["check_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = stats_of(simulate_trace(trace, arch="v5p", tuned=False))
        row["simulate_s"] = time.perf_counter() - t0
        row["v5p"] = {k: st[k] for k in SIM_MODEL_KEYS}
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        rows[name] = row
        med = (f"{row['median_ms']:.4f} ms" if row["median_ms"] is not None
               else "none (abstract)")
        chk = row["check"]
        print(f"  {name} ({row['world']} devices"
              + "".join(f", {k} {v}" for k, v in depth.items())
              + f"): capture {capture_s:.2f} s"
              f"{' (abstract)' if wl.abstract else ''}; "
              f"check max |err| {chk['max_abs_err']:.3g} "
              f"({chk['worst_of_tol']:.3g} of tol {chk['tol']}"
              f"{', norm-wise' if chk['normwise'] else ''})"
              + (f", grads {chk['grads']['worst_of_tol']:.3g} of "
                 f"{chk['grads']['tol']}" if "grads" in chk else "")
              + bf16_note(chk.get("bf16"))
              + f"; median step {med}; peak "
              f"{row['peak_mem_bytes'] / 2**30:.2f} GiB on {card_name}",
              flush=True)
        print("    v5p: " + ", ".join(f"{k} {row['v5p'][k]:.10g}"
                                      for k in SIM_MODEL_KEYS))
        shutil.rmtree(trace, ignore_errors=True)
    t0 = time.perf_counter()
    rc, log, _ = finish(recapture)
    waited_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase 13 (b): the CPU re-captures failed: "
                             f"{log[-2000:]}")
    recapture_s = json.loads(
        (work / "recaptured" / "seconds.json").read_text())
    for name, text in card_texts.items():
        cpu = (work / "recaptured" / f"{name}.hlo").read_text()
        if cpu != text:
            raise AssertionError(f"{name}: the card's HLO differs from the "
                                 f"CPU's")
        rows[name]["recapture_s"] = recapture_s[name]
    print(f"  HLO card == CPU for {sorted(card_texts)} (CPU re-captures "
          f"beside the phase: {sum(recapture_s.values()):.1f} s, "
          f"{waited_s:.1f} s waited for at the end)")
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    if any(launches.values()):
        raise AssertionError(f"phase 13 launched a custom kernel: {launches}")
    seconds = time.perf_counter() - t_phase
    print(f"  kernel launches across phase 13: {launches}; {seconds:.1f} s")
    return {"workloads": rows, "launches": launches, "seconds": seconds,
            "card": card_name}


#: phase 14: the nine workloads of suite ``ubench`` the port took last, in
#: the reference's order, each at its registered width (``matmul`` and
#: ``matmul_int8`` at 4096^3, ``reduce_lane_wide`` at 65536 x 1024 bf16)
UBENCH = ("matmul", "small_matmul_chain", "op_overhead_chain",
          "dynamic_loop", "softmax_narrow", "relayout_copy", "matmul_int8",
          "reduce_lane_wide", "reduce_major_acc")
#: phase 14 (c): rtol = atol by output dtype (tests/test_torch_ubench.py);
#: an int32 product is held exactly, dynamic_loop's root at atol 1e-4
TOL_UBENCH = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int32: 0.0}
TOL_DYNAMIC_LOOP = 1e-4
#: phase 14 (c): the rows of the two 4096^3 products the CPU recomputes
#: (each row of a product depends on its own row of ``a`` alone)
CPU_ROWS = 256
#: phase 14 (c): small_matmul_chain squares its input 64 times at its
#: registered parameters; the values pass bf16's range after ~10
#: squarings, so its registered output is NaN on the card and on the CPU
#: alike, and its numbers are held at this depth
CHAIN_CHECK_DEPTH = 4
#: phase 14 (g): sha256 of what the port's CLI prints for
#: llama_tiny_tp2dp2 at v5p, untuned, on the CPU (tests/test_torch_lint.py
#: holds these to the CPU run, and that run to the JAX package's CLI): ``lint
#: --perf``, ``lint --perf --format json`` (the same document as
#: ``perf-report --format json``) and ``perf-report``
LINT_DIGESTS = {
    ("lint", "--perf"):
        "e6ea52359615f00773c1c46cd32c4a3dfc18e659a5c3eda14a8e49ab1c575a7e",
    ("lint", "--perf", "--format", "json"):
        "3b985c348ac4f5c54928d7408111b4e34a6813d7af211c9cce6992c9f9474874",
    ("perf-report",):
        "97272dbef7b713be1c9f059804610d3eb9ad09abf064e257320237786bbfbb4b",
    ("perf-report", "--format", "json"):
        "3b985c348ac4f5c54928d7408111b4e34a6813d7af211c9cce6992c9f9474874",
}


def ubench_numerics(name: str, module, args) -> dict:
    """Phase 14 (c): the workload's output on the card against a CPU run
    of the same module on the same inputs (the first :data:`CPU_ROWS`
    rows of the two large products)."""
    from tpusim_torch.models.microbench import SmallMatmulChain

    notes = {}
    with torch.no_grad():
        got = module(*args)
        if name in ("matmul", "matmul_int8"):
            got = got[:CPU_ROWS]
            want = module(args[0][:CPU_ROWS].cpu(), args[1].cpu())
            notes["rows"] = CPU_ROWS
        else:
            want = module(*(a.cpu() for a in args))
        if name == "small_matmul_chain":
            if not (torch.isnan(got).all() and torch.isnan(want).all()):
                raise AssertionError(f"{name}: the registered chain did not "
                                     f"overflow on both sides")
            notes["registered_output"] = "NaN on card and CPU"
            notes["checked_depth"] = CHAIN_CHECK_DEPTH
            chain = SmallMatmulChain(CHAIN_CHECK_DEPTH)
            got, want = chain(args[0]), chain(args[0].cpu())
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: card {got.dtype}{list(got.shape)} vs "
                             f"CPU {want.dtype}{list(want.shape)}")
    if name == "dynamic_loop":
        tol = TOL_DYNAMIC_LOOP
    else:
        tol = TOL_UBENCH[got.dtype]
    g, w = got.double(), want.double()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{name}: non-finite output")
    gap = (g - w).abs()
    err = float(gap.max())
    if tol == 0.0:
        worst = 0.0 if torch.equal(got, want) else math.inf
    elif name == "dynamic_loop":
        worst = err / tol
    else:
        worst = float((gap / (tol + tol * w.abs())).max())
    if worst > 1.0:
        raise AssertionError(f"{name}: card and CPU differ beyond {tol} "
                             f"(worst {worst:.3g} of the tolerance)")
    return {"max_abs_err": err, "tol": tol, "worst_of_tol": worst, **notes}


def ubench_matmul_512(card_name: str, work: Path) -> dict:
    """Phase 14 (f): ``matmul`` at 512^3, two launches, captured on the
    card as module ``matmul_512``: its command list is the fixture's by
    bytes, its MXU flops the fixture's at v5e and v5p, and ``simulate
    --validate`` prices it."""
    module, args = get_workload("matmul").build(device="cuda", m=512, n=512,
                                                k=512)
    trace = work / "matmul_512"
    capture_to_dir(trace, module, *args, name="matmul_512", launches=2)
    fixture = FIXTURES / "matmul_512"
    if (trace / "commandlist.jsonl").read_bytes() != \
            (fixture / "commandlist.jsonl").read_bytes():
        raise AssertionError("matmul_512: command list differs from the "
                             "fixture's")
    flops = {}
    for arch in ("v5e", "v5p"):
        got = stats_of(simulate_trace(trace, arch=arch, tuned=False))
        want = stats_of(simulate_trace(fixture, arch=arch, tuned=False))
        if got["tot_mxu_flops"] != want["tot_mxu_flops"]:
            raise AssertionError(f"matmul_512 @ {arch}: MXU flops "
                                 f"{got['tot_mxu_flops']} vs the fixture's "
                                 f"{want['tot_mxu_flops']}")
        flops[arch] = got["tot_mxu_flops"]
    text = run_cli(["simulate", str(trace), "--arch", "v5e",
                    "--validate=strict"])
    if EXIT_SENTINEL not in text:
        raise AssertionError("matmul_512: simulate --validate did not price")
    print(f"  (f) matmul_512 captured on the card: command list == fixture, "
          f"MXU flops == fixture's (v5e {flops['v5e']:.10g}, v5p "
          f"{flops['v5p']:.10g}); simulate --validate=strict priced it "
          f"(card: {card_name})")
    return {"tot_mxu_flops": flops, "validated": True}


@contextlib.contextmanager
def untuned():
    """Price without the committed tuner overlays (``configs/*.tuned.flags``,
    which a live bench run refreshes), as the golden cells and the tests
    do: ``$TPUSIM_TUNED_DIR`` points at an empty directory for the block."""
    old = os.environ.get("TPUSIM_TUNED_DIR")
    with tempfile.TemporaryDirectory() as empty:
        os.environ["TPUSIM_TUNED_DIR"] = empty
        try:
            yield
        finally:
            if old is None:
                del os.environ["TPUSIM_TUNED_DIR"]
            else:
                os.environ["TPUSIM_TUNED_DIR"] = old


def ubench_lint_llama(card_name: str) -> dict:
    """Phase 14 (g): ``lint --perf`` and ``perf-report`` of
    llama_tiny_tp2dp2 at v5p print what the CPU prints
    (:data:`LINT_DIGESTS`)."""
    import hashlib

    trace = str(FIXTURES / "llama_tiny_tp2dp2")
    out = {}
    for flags, digest in LINT_DIGESTS.items():
        argv = [flags[0], trace, "--arch", "v5p", *flags[1:]]
        t0 = time.perf_counter()
        with untuned():
            text = run_cli(argv)
        seconds = time.perf_counter() - t0
        got = hashlib.sha256(text.encode()).hexdigest()
        if got != digest:
            raise AssertionError(f"{' '.join(argv)}: output differs from "
                                 f"the CPU's (sha256 {got})")
        out[" ".join(flags)] = seconds
    print(f"  (g) llama_tiny_tp2dp2 @ v5p: lint --perf and perf-report "
          f"(text, JSON) equal the CPU's by bytes; host s "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
          + f" (card: {card_name})")
    return {"host_s": out}


def ubench_workloads(card_name: str, work: Path,
                     keep: Path | None = None) -> dict:
    """Phase 14: each ``ubench`` workload the port took last at its
    registered width — (a) ``capture W DIR --launches 2`` through the
    CLI, timed; (b) the card's HLO equals by bytes the text lowered from
    CPU tensors of the same shapes; (c) the card's output against the
    CPU's (:func:`ubench_numerics`); (d) ``lint`` through the CLI with
    zero errors; (e) simulated at v5e, ``dynamic_loop``'s while counted
    as an unknown trip count once a launch and every other loop known;
    the median step on the card and the peak of
    ``torch.cuda.max_memory_allocated``; then (f) the matmul_512 fixture
    (:func:`ubench_matmul_512`) and (g) the analyzer on the card's host
    (:func:`ubench_lint_llama`); no custom kernel launched.  Each trace
    is copied to ``keep``, when given, before it is removed."""
    for *_, reset in KERNELS:
        reset()
    t_phase = time.perf_counter()
    rows = {}
    for name in UBENCH:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trace = work / name
        t0 = time.perf_counter()
        run_cli(["capture", name, str(trace), "--launches", "2"])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        module, args = get_workload(name).build(device="cuda")
        text = module_text(trace, name)
        cpu_args = tuple(torch.empty(a.shape, dtype=a.dtype) for a in args)
        if export_to_hlo(module, cpu_args, name)[0] != text:
            raise AssertionError(f"{name}: the card's HLO differs from the "
                                 f"CPU's")
        del cpu_args
        check = ubench_numerics(name, module, args)
        lint = run_cli(["lint", str(trace)])
        errors = int(re.search(r"tpusim lint: (\d+) error", lint).group(1))
        if errors:
            raise AssertionError(f"{name}: lint found {errors} error(s):\n"
                                 f"{lint}")
        st = stats_of(simulate_trace(trace, arch="v5e", tuned=False))
        unknown = st["tot_unknown_trip_loops"]
        want = st["kernel_launches"] if name == "dynamic_loop" else 0
        if unknown != want:
            raise AssertionError(f"{name}: {unknown} unknown-trip loops, "
                                 f"want {want}")
        wall = measure_wall_time(module, *args, iters=5, warmup=2)
        rows[name] = {
            "params": get_workload(name).params, "capture_s": capture_s,
            "hlo_bytes": len(text), "check": check,
            "lint_errors": errors, "unknown_trip_loops": unknown,
            "v5e": {k: st[k] for k in ("tot_mxu_flops", "tot_hbm_bytes",
                                       "tot_sim_cycles")},
            "median_ms": wall["median_s"] * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }
        row = rows[name]
        print(f"  {name}: capture {capture_s:.2f} s, HLO card == CPU "
              f"({len(text)} B); card vs CPU max |err| "
              f"{check['max_abs_err']:.3g} ({check['worst_of_tol']:.3g} of "
              f"tol {check['tol']}); lint 0 errors; v5e unknown-trip loops "
              f"{unknown}; median step {row['median_ms']:.4f} ms; peak "
              f"{row['peak_mem_bytes'] / 2**30:.3f} GiB on {card_name}",
              flush=True)
        del module, args
        if keep is not None:
            keep_traces(work, (name,), keep)
        shutil.rmtree(trace, ignore_errors=True)
    matmul_512 = ubench_matmul_512(card_name, work)
    lint = ubench_lint_llama(card_name)
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched a custom kernel: {launches}")
    seconds = time.perf_counter() - t_phase
    print(f"  kernel launches across phase 14: {launches}; {seconds:.1f} s")
    return {"workloads": rows, "matmul_512": matmul_512, "lint": lint,
            "launches": launches, "seconds": seconds, "card": card_name}


# ---------------------------------------------------------------------------
# phase 15: observability and the trace tools on the card's host
# ---------------------------------------------------------------------------

#: phase 15: the obs contract of ``ci/check_golden.py``, read as data
OBS_SCHEMA = REPO / "ci" / "obs_schema.json"
#: phase 15 (a, b): the files of an obs run whose bytes are pinned
OBS_FILES = ("samples.jsonl", "trace.json")
#: phase 15 (a): the spans every obs run of ``simulate_trace`` records
OBS_SPANS = ("obs_span_parse_s", "obs_span_simulate_s",
             "obs_span_simulate.engine_s")
#: phase 15 (b): the example schedules of ``ci/faults_schema.json`` run on
#: ``llama_tiny_tp2dp2`` at v5p on the detailed network: a fault for the
#: whole run and a windowed one
OBS_FAULT_KINDS = ("link_down", "hbm_throttle")
#: phase 15 (a, b): sha256 of each obs run's files (:data:`OBS_FILES`), by
#: golden cell or fault schedule — the CPU run's, which
#: ``tests/test_torch_obs.py`` holds equal to the JAX package's
OBS_DIGESTS = {
    "matmul_512__v5e": {
        "samples.jsonl":
            "092e33be753325e4f9d5ddc5ef95a013128eae474755f99956b5718a2c0e9b51",
        "trace.json":
            "7291c35fd01cb2f73bcd7776da78dcba4334d8fca0ce92a7d7689d9b7063ca83",
    },
    "matmul_512__v5p": {
        "samples.jsonl":
            "0437983492d378483f83f1a663f901c361ff37171793005dd16857c63f953bca",
        "trace.json":
            "fee4b2b0d121d618d9c5ac5bc8e80781bddcbac6f0019e6a23cba64086c79464",
    },
    "llama_tiny_tp2dp2__v5p": {
        "samples.jsonl":
            "467e88ab28cd8a83d0e0e552d088ad0b9df2c962b6dead8566681f10341a7892",
        "trace.json":
            "64d632dee4fae0d29d698d1540fbe339cbd4ec229ff0fd01add1fcbfd596b358",
    },
    "llama_tiny_tp2dp2__v5p__arch.ici.network_mode=detailed": {
        "samples.jsonl":
            "9f5ca3ff53dd6f9680b43b8610ba9f7757056fba31bdc54cb02983f1d8d3cbaf",
        "trace.json":
            "dbd48c7cee763c4462cde1b06c8d400426be3505c1f9f920167c5a36f43fef53",
    },
    "llama_tiny_tp2dp2__v6e__power_enabled=True": {
        "samples.jsonl":
            "18e2114f0411c82f4bb230ba0bb03b3b9d2dc71f94813a049210751003a6cc2f",
        "trace.json":
            "59856d882bbfdb9de3019bd230ed1c2e4af580877f5f94338918385a8f2ed162",
    },
    "link_down": {
        "samples.jsonl":
            "e26ab8ad55dc81f8f0a473d21a6a708f4c310bfef6d4791e26ecd9f7829141bd",
        "trace.json":
            "7f17346033823906fb3187a704c3f1937bc72f83db106b671ff7c64c9549d699",
    },
    "hbm_throttle": {
        "samples.jsonl":
            "c3bb39ad27f8e78abdf65f0c12212568f4f612c45df4f96877a24eed272fd943",
        "trace.json":
            "0d1d1df7f368b02d1407eb848c24a96dac8240f25657f24d308cdf663eebf1de",
    },
}
#: phase 15 (b): ``faults_worst_link_occupancy`` and the ``ici.detailed.*``
#: counters of each degraded run (the CPU run's; equal to the JAX
#: package's, ``tests/test_torch_obs.py``)
OBS_FAULT_COUNTERS = {
    "link_down": {
        "faults_worst_link_occupancy": 0.9113487505388621,
        "obs_ici.detailed.degraded_link_busy_cycles": 0.0,
        "obs_ici.detailed.link_busy_cycles": 934771.6601307188,
        "obs_ici.detailed.link_cycle_capacity": 1728963.346405228,
        "obs_ici.detailed.priced_all-reduce_count": 14.0,
        "obs_ici.detailed.priced_collectives": 14.0,
        "obs_ici.detailed.worst_link_occupancy": 0.9113487505388621,
    },
    "hbm_throttle": {
        "faults_worst_link_occupancy": 0.9113487505388608,
        "obs_ici.detailed.degraded_link_busy_cycles": 0.0,
        "obs_ici.detailed.link_busy_cycles": 495294.95424836595,
        "obs_ici.detailed.link_cycle_capacity": 607294.9542483661,
        "obs_ici.detailed.priced_all-reduce_count": 14.0,
        "obs_ici.detailed.priced_collectives": 14.0,
        "obs_ici.detailed.worst_link_occupancy": 0.9113487505388608,
    },
}
#: phase 15 (d): the tools' cells, the ``debug`` session's script and the
#: sha256 of each tool's output by (fixture, tool) — the CPU run's, which
#: ``tests/test_torch_trace_tools.py`` holds equal to the JAX CLI's
TOOL_CELLS = (("matmul_512", "v5e"), ("llama_tiny_tp2dp2", "v5p"))
DEBUG_SCRIPT = "b dot\nl 3\ns 2\np\nc\nstats\nc\nq\n"
TOOL_DIGESTS = {
    ("matmul_512", "timeline"):
        "690ea4ad3962cfbf31490eb242413f4dc61872fb54cc56a61cf9da4efbc23cc5",
    ("matmul_512", "aerial"):
        "303511798821d5a1f378d5ca86c49d4ca8e653ef9afe993e428f2e50c9e39bd7",
    ("matmul_512", "bbv"):
        "0ead29f5461a972d99d1abfc6f63060377a5cdd77d4122a37b75e1e0e1117232",
    ("matmul_512", "occupancy"):
        "f7646f0fc1176cc9a010072070ee18b9f662e456d9dbb57e11dea7a073872744",
    ("matmul_512", "debug"):
        "7132ea9b062a4ba41f81f2e2195180db305876b0d45e613161cf83ca55bf4fc1",
    ("llama_tiny_tp2dp2", "timeline"):
        "9ffbf5908c987697599b6bf5fede5eb1703f29ef6bd9042f3fbd6653ffbfce0f",
    ("llama_tiny_tp2dp2", "aerial"):
        "ede4d30227a85f116aff17a7ee5b5f00bca3390836f9ab8b5de6800008bef3d2",
    ("llama_tiny_tp2dp2", "bbv"):
        "a13c96ca728f6e1de4c2241a8d607ed8651d5421f603b32f74184c6bb89a71ac",
    ("llama_tiny_tp2dp2", "occupancy"):
        "e14254de299d3c554ca1c7ff3ce23174dcf3ac7d99a4e0a7e2c1dfe3c4e2addb",
    ("llama_tiny_tp2dp2", "debug"):
        "7c2c4e0a93a57ff552fffefa7fc8249566ee9e9f550b7a49bbb692c49e826a8d",
}
#: phase 15 (c): sha256 of ``profile``'s top-op table (the lines after
#: "costliest ops") of the llama cell — the CPU run's, equal to the JAX
#: CLI's (``tests/test_torch_trace_tools.py``)
PROFILE_TOP = 5
PROFILE_TOP_DIGEST = (
    "75c4e9ef778b1679e1c8b89108693c1b18844ae01ea4b28a28a9d7ae49df2888")


def sha256(data: bytes) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()


def obs_digests(out_dir: Path) -> dict:
    """The sha256 of each pinned file of an obs export directory."""
    return {name: sha256((out_dir / name).read_bytes()) for name in OBS_FILES}


def obs_run(fixture: str, arch: str, overlays: list, out_dir: Path,
            faults=None) -> tuple:
    """One obs run of ``simulate_trace`` (untuned, as the goldens) and its
    export directory, checked against ``ci/obs_schema.json``.  Returns the
    report, its stats and the export's summary."""
    obs = Instrumentation()
    report = simulate_trace(FIXTURES / fixture, arch=arch,
                            overlays=list(overlays), tuned=False, obs=obs,
                            faults=faults)
    write_obs_dir(out_dir, report, obs=obs)
    summary = validate_obs_dir(out_dir, json.loads(OBS_SCHEMA.read_text()))
    return report, stats_of(report), summary


def obs_pinned(tag: str, out_dir: Path) -> None:
    """Raise unless an export's files equal :data:`OBS_DIGESTS` ``[tag]``."""
    got = obs_digests(out_dir)
    if got != OBS_DIGESTS[tag]:
        raise AssertionError(f"obs {tag}: files differ from the CPU run's "
                             f"({got})")


def without_obs(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if not k.startswith(("obs_", "fastpath_"))}


def obs_cells(card_name: str, work: Path) -> dict:
    """Phase 15 (a): the five golden cells through ``simulate_trace`` with
    an instrumentation hub, each beside the same run without one: the
    report passes its golden without the ``obs_*`` and ``fastpath_*``
    keys and equals the plain run's key for key there; the spans
    :data:`OBS_SPANS` are recorded; the export validates against the
    schema and its files equal :data:`OBS_DIGESTS`.  Then ``simulate
    llama_tiny_tp2dp2 --arch v5p --obs-out DIR`` through the CLI in a fresh
    process, held the same way.  Returns the host seconds of each cell
    with and without obs."""
    seconds = {}
    for fixture, arch, overlays, golden in GOLDEN_CELLS:
        t0 = time.perf_counter()
        plain = stats_of(simulate_trace(FIXTURES / fixture, arch=arch,
                                        overlays=list(overlays), tuned=False))
        plain_s = time.perf_counter() - t0
        out_dir = work / f"obs_{golden}"
        t0 = time.perf_counter()
        report, stats, summary = obs_run(fixture, arch, overlays, out_dir)
        obs_s = time.perf_counter() - t0
        errors = compare_golden(golden, without_obs(stats))
        if errors:
            raise AssertionError("\n".join(errors))
        if without_obs(stats) != without_obs(plain):
            raise AssertionError(f"{golden}: the obs run's stats differ from "
                                 f"the plain run's")
        missing = [k for k in OBS_SPANS if k not in stats]
        if missing or report.samples is None:
            raise AssertionError(f"{golden}: no spans {missing} or samples")
        obs_pinned(golden, out_dir)
        seconds[golden] = {"plain": plain_s, "obs": obs_s}
        print(f"  (a) golden {golden} with obs: golden passes, stats == the "
              f"plain run's; {summary['windows']} windows x "
              f"{report.samples.window_cycles:.0f} cycles, "
              f"{summary['gauges']} gauges; samples.jsonl and trace.json "
              f"equal the CPU's; host s plain {plain_s:.4f} / obs "
              f"{obs_s:.4f} (card: {card_name})")
    golden = GOLDEN_CELLS[2][3]
    out_dir = work / "obs_cli"
    tuned = work / "no_tuned_overlays"
    tuned.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    proc = run_process(
        [sys.executable, "-m", "tpusim_torch", "simulate",
         str(FIXTURES / "llama_tiny_tp2dp2"), "--arch", "v5p",
         "--obs-out", str(out_dir), "--json", str(work / "obs_cli.json")],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, TPUSIM_TUNED_DIR=str(tuned)))
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0 or EXIT_SENTINEL not in proc.stdout:
        raise RuntimeError(f"simulate --obs-out exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    stats = json.loads((work / "obs_cli.json").read_text())
    errors = compare_golden(golden, without_obs(stats))
    if errors:
        raise AssertionError("\n".join(errors))
    if [k for k in OBS_SPANS if k not in stats]:
        raise AssertionError("simulate --obs-out: spans missing")
    summary = validate_obs_dir(out_dir, json.loads(OBS_SCHEMA.read_text()))
    obs_pinned(golden, out_dir)
    obs_line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("obs: "))
    print(f"  (a) simulate llama_tiny_tp2dp2 --arch v5p --obs-out, fresh "
          f"process: golden passes; {summary['windows']} windows; files "
          f"equal the CPU's; {cli_s:.2f} s (card: {card_name})")
    print(f"      {obs_line.split(' -> ')[0]}")
    seconds["cli"] = cli_s
    return seconds


def obs_degraded(card_name: str, work: Path) -> dict:
    """Phase 15 (b): the :data:`OBS_FAULT_KINDS` example schedules on
    ``llama_tiny_tp2dp2`` at v5p on the detailed network, with obs: the
    ``faults_active`` track in the trace, the worst link occupancy and
    the ``ici.detailed.*`` counters equal :data:`OBS_FAULT_COUNTERS`, the
    files :data:`OBS_DIGESTS`."""
    examples = json.loads(FAULTS_SCHEMA.read_text())["example_schedules"]
    seconds = {}
    for kind in OBS_FAULT_KINDS:
        out_dir = work / f"obs_{kind}"
        t0 = time.perf_counter()
        report, stats, _ = obs_run(
            "llama_tiny_tp2dp2", "v5p",
            [{"arch": {"ici": {"network_mode": "detailed"}}}], out_dir,
            faults=examples[kind])
        seconds[kind] = time.perf_counter() - t0
        trace = json.loads((out_dir / "trace.json").read_text())
        if not any(ev.get("name") == "faults_active" and ev.get("ph") == "C"
                   for ev in trace["traceEvents"]):
            raise AssertionError(f"{kind}: no faults_active track")
        got = {k: v for k, v in stats.items()
               if k == "faults_worst_link_occupancy"
               or k.startswith("obs_ici.detailed.")}
        if got != OBS_FAULT_COUNTERS[kind]:
            raise AssertionError(f"{kind}: counters {got}, want "
                                 f"{OBS_FAULT_COUNTERS[kind]}")
        obs_pinned(kind, out_dir)
        print(f"  (b) {kind} on llama_tiny_tp2dp2 @ v5p, detailed network: "
              f"faults_active track present; faults_worst_link_occupancy "
              f"{got['faults_worst_link_occupancy']!r} and "
              f"{len(got) - 1} ici.detailed counters equal the CPU's; files "
              f"equal the CPU's; host {seconds[kind]:.4f} s "
              f"(card: {card_name})")
    return seconds


def profile_table(text: str) -> list[str]:
    """``profile``'s top-op table: the lines from "costliest ops" on."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if "costliest ops" in ln)
    return lines[start:]


def obs_profile(card_name: str) -> dict:
    """Phase 15 (c): ``profile`` of the llama cell at v5p (untuned): its
    depth-0 phases cover at least 90% of the measured total, as the
    reference's test holds, and its top-op table equals the CPU's."""
    t0 = time.perf_counter()
    with untuned():
        text = run_cli(["profile", str(FIXTURES / "llama_tiny_tp2dp2"),
                        "--arch", "v5p", "--top", str(PROFILE_TOP)])
    seconds = time.perf_counter() - t0
    cover = next(ln for ln in text.splitlines() if "(phases cover)" in ln)
    pct = float(cover.split("%")[0].split()[-1])
    if pct < 90.0:
        raise AssertionError(f"profile: phases cover {pct}% < 90%:\n{text}")
    table = profile_table(text)
    if sha256("\n".join(table).encode()) != PROFILE_TOP_DIGEST:
        raise AssertionError("profile: top-op table differs from the CPU's")
    print("\n".join(f"    {ln}" for ln in text.splitlines()))
    print(f"  (c) profile llama_tiny_tp2dp2 @ v5p: phases cover {pct}%; "
          f"top-op table equals the CPU's; host {seconds:.3f} s "
          f"(card: {card_name})")
    return {"cover_pct": pct, "host_s": seconds}


def tool_outputs(main, trace: Path, arch: str, work: Path) -> dict:
    """The bytes each trace tool of a CLI's ``main`` writes for one module
    (the first of ``trace``), untuned: ``timeline --counters`` (the JSON),
    ``aerial --power --gz`` (its text lanes and the decompressed log),
    ``bbv --out``, ``occupancy`` and a scripted ``debug`` session
    (:data:`DEBUG_SCRIPT`).  Paths are left out: only what the tool
    computes."""
    import gzip

    def run(argv, stdin=""):
        buf = io.StringIO()
        old = sys.stdin
        sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(buf), untuned():
                rc = main(argv)
        finally:
            sys.stdin = old
        if rc != 0:
            raise RuntimeError(f"{' '.join(argv)} exited {rc}")
        return buf.getvalue()

    work.mkdir(parents=True, exist_ok=True)
    t = str(trace)
    out = {}
    run(["timeline", t, str(work / "timeline.json"), "--arch", arch,
         "--counters"])
    out["timeline"] = (work / "timeline.json").read_bytes()
    text = run(["aerial", t, "--arch", arch, "--power", "--gz",
                str(work / "aerial.jsonl.gz")])
    lanes = "".join(ln for ln in text.splitlines(keepends=True)
                    if "written to" not in ln)
    out["aerial"] = lanes.encode() + gzip.decompress(
        (work / "aerial.jsonl.gz").read_bytes())
    text = run(["bbv", t, "--interval", "50", "--out", str(work / "bbv.bb")])
    out["bbv"] = text.splitlines()[0].encode() + (work / "bbv.bb").read_bytes()
    out["occupancy"] = run(["occupancy", t, "--arch", arch]).encode()
    out["debug"] = run(["debug", t, "--arch", arch], DEBUG_SCRIPT).encode()
    return out


def obs_tools(card_name: str, work: Path) -> dict:
    """Phase 15 (d): the trace tools on ``matmul_512`` at v5e and the
    llama module at v5p (:func:`tool_outputs`), each output equal to
    :data:`TOOL_DIGESTS`."""
    seconds = {}
    for fixture, arch in TOOL_CELLS:
        t0 = time.perf_counter()
        outs = tool_outputs(cli, FIXTURES / fixture, arch, work / fixture)
        seconds[fixture] = time.perf_counter() - t0
        for tool, data in outs.items():
            if sha256(data) != TOOL_DIGESTS[(fixture, tool)]:
                raise AssertionError(f"{tool} on {fixture}: output differs "
                                     f"from the CPU's")
        print(f"  (d) {fixture} @ {arch}: " + ", ".join(
            f"{tool} {len(data)} B" for tool, data in outs.items())
            + f", each equal to the CPU's; host {seconds[fixture]:.3f} s "
            f"(card: {card_name})")
    return seconds


def observability(card_name: str, work: Path) -> dict:
    """Phase 15: (a)-(d) on the card's host in ``work`` (an empty
    directory), the kernels' counters set to 0 just before each part and
    read just after (they must stay 0).  Returns each part's seconds and
    readings."""
    out = {"seconds": {}, "launches": {}}
    t_phase = time.perf_counter()
    for part, run in (("a", lambda: obs_cells(card_name, work)),
                      ("b", lambda: obs_degraded(card_name, work)),
                      ("c", lambda: obs_profile(card_name)),
                      ("d", lambda: obs_tools(card_name, work))):
        for *_, reset in KERNELS:
            reset()
        t0 = time.perf_counter()
        out[part] = run()
        out["seconds"][part] = time.perf_counter() - t0
        out["launches"][part] = no_launches(f"phase 15 ({part})")
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["card"] = card_name
    print(f"observability: kernel launches by part {out['launches']}; "
          f"{out['seconds']['phase']:.1f} s (card: {card_name})")
    return out


# ---------------------------------------------------------------------------
# phase 16: streaming pricing and the offline harness on the card's host
# ---------------------------------------------------------------------------

#: phase 16 (a): the synthetic module of ``tests/test_fastpath.py``'s RSS
#: test (one called computation is about 0.71 MB of text): 96 computations
#: of 1000 ops make a file just over the 64 MiB streaming threshold (68.3
#: MB), 128 one of 91.1 MB.  What streaming keeps is ~150 B an op (the
#: float64 columns and index tables) over a fixed few MiB (the parse of
#: one computation, allocator slack), so the bound's margin grows with the
#: file: at 96 it read within the fixed part's noise of the bound; at 128
#: it added 19.18-22.65 MiB against 30.4 MiB on the card's host (NVIDIA
#: H100 80GB HBM3, 700.00 W; PERF.md)
STREAM_COMPS = 128
STREAM_OPS = 1000
#: phase 16 (a): the size the module must reach to stream by the default
#: threshold (``STREAM_THRESHOLD_BYTES``), and the environment the
#: streamed legs add (none: the default threshold decides)
MIN_STREAM_BYTES = 64 * 1024 * 1024
STREAM_ENV: dict = {}
#: phase 16 (a): the reference's bound on what streaming adds to the RSS
#: of a fresh process, as a fraction of the module file's size
STREAM_RSS_FRACTION = 0.35
#: phase 16 (a): StreamingModuleTrace's parse cap, which ``load_trace``
#: leaves at its default
STREAM_PARSED_CAP = 8
#: phase 16 (a): a fresh process that simulates the streamed module with
#: every default but, when a directory is given, a durable compile store
#: (the cold store leg), and records its RSS: its floor is the high-water
#: mark (``ru_maxrss``) after the imports that pricing needs, its peak the
#: mark after ``simulate_trace``.  Arguments: repo root, trace dir, output
#: path, store dir or "".
STREAM_CHILD = r"""
import json, resource, sys, time
repo, trace, out_path, store = sys.argv[1:]
sys.path.insert(0, repo)
import torch
import tpusim_torch.fastpath.compile
import tpusim_torch.fastpath.price
import tpusim_torch.perf.cache
import tpusim_torch.sim.driver as driver
import tpusim_torch.trace.lazy

def hwm_kb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

pods = []
load = driver.load_trace
def keep(*a, **k):
    pods.append(load(*a, **k))
    return pods[-1]
driver.load_trace = keep
floor_kb = hwm_kb()
t0 = time.perf_counter()
report = driver.simulate_trace(trace, arch="v5e", tuned=False,
                               compile_cache=store or None)
seconds = time.perf_counter() - t0
[module] = pods[0].modules.values()
with open(out_path, "w") as f:
    json.dump({"floor_kb": floor_kb, "seconds": seconds,
               "peak_kb": hwm_kb(), "stats": report.stats.values,
               "per_op": len(report.totals.per_op_cycles),
               "module": type(module).__name__,
               "parsed": module.parsed_count}, f)
"""
#: phase 16 (a): how :data:`STREAM_CHILD` is started.  A process's
#: ``ru_maxrss`` survives ``exec`` and starts from the address space it
#: was forked from, so a child forked from this script (several GB by
#: phase 16) would read this script's mark; forked from a small
#: interpreter started for the purpose, it reads its own
HOP = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"
#: phase 16 (c): the rounding of ``reports/loo.json``'s fields (3
#: decimals), which a float ``sum`` on another Python moves by one unit
LOO_ATOL = 1e-3
#: phase 16 (c): sha256 of ``refine --out``'s overlay with the CLI's
#: defaults (6 sweeps, anchor 1.0, the committed per-op rows), which both
#: packages write on the CPU (tests/test_torch_refine.py)
REFINE_DIGEST = \
    "075f9ac0c66abdc25844d9dd31a89d4ac12e6745f28b57fb365ada078c321c7f"
#: phase 16 (d): the suite and config the run takes, the workers it runs
#: its jobs on, and the workload left out of the seeded trace root (the
#: run's own capture job captures it)
RUN_SUITE = "ubench"
RUN_CONFIG = "v5e"
RUN_PARALLEL = 8
RUN_CAPTURED = "flash_attention_pallas"
#: phase 16 (d): the stat changed in the copy ``stats-diff`` compares with
DIFF_STAT = "sim_cycle"


def keep_traces(work: Path, names, kept: Path) -> None:
    """Copy captured trace dirs (without snapshot buffers) to ``kept``,
    which outlives the phase's temporary directory."""
    for name in names:
        shutil.copytree(work / name, kept / name, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("checkpoint_files"))


def write_stream_trace(tdir: Path) -> Path:
    """The synthetic trace of ``tests/test_fastpath.py``'s RSS test:
    :data:`STREAM_COMPS` called computations of :data:`STREAM_OPS` adds
    with long metadata."""
    n_comps, n_ops = STREAM_COMPS, STREAM_OPS
    pad = "x" * 580
    (tdir / "modules").mkdir(parents=True)
    (tdir / "meta.json").write_text(json.dumps({
        "format_version": 1, "platform": "tpu",
        "device_kind": "TPU v5 lite",
    }))
    hlo = tdir / "modules" / "giant.hlo"
    with open(hlo, "w") as f:
        f.write("HloModule giant_stream, is_scheduled=true\n\n")
        for c in range(n_comps):
            f.write(f"%body_{c} (p0: f32[512,512]) -> f32[512,512] {{\n")
            f.write("  %p0 = f32[512,512]{1,0:T(8,128)} parameter(0)\n")
            prev = "%p0"
            for i in range(n_ops):
                f.write(
                    f"  %add_{i} = f32[512,512]{{1,0:T(8,128)}} "
                    f"add({prev}, %p0), metadata={{op_name="
                    f"\"layer{c}/add{i}/{pad}\" source_file=\"g.py\" "
                    f"source_line={i}}}\n"
                )
                prev = f"%add_{i}"
            f.write(f"  ROOT %root = f32[512,512]{{1,0:T(8,128)}} "
                    f"copy({prev})\n}}\n\n")
        f.write("ENTRY %main (p0: f32[512,512]) -> f32[512,512] {\n")
        f.write("  %p0 = f32[512,512]{1,0:T(8,128)} parameter(0)\n")
        prev = "%p0"
        for c in range(n_comps):
            f.write(f"  %call_{c} = f32[512,512]{{1,0:T(8,128)}} "
                    f"call({prev}), to_apply=%body_{c}\n")
            prev = f"%call_{c}"
        f.write(f"  ROOT %out = f32[512,512]{{1,0:T(8,128)}} "
                f"copy({prev})\n}}\n")
    return hlo


def child_env(**kw) -> dict:
    """The environment of a fresh process of phase 16: none of this
    process's ``TPUSIM_`` settings (the streaming threshold, the tuned
    overlays, a compile store), then ``kw``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUSIM_")}
    env.update(kw)
    return env


def start(argv: list[str], log: Path, env: dict) -> tuple:
    """A fresh process started in the background, its output to ``log``;
    :func:`finish` waits for it."""
    f = open(log, "w")
    proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT,
                            cwd=REPO, env=env)
    return proc, f, time.perf_counter(), argv


def finish(started: tuple, timeout: float = 600) -> tuple[int, str, float]:
    """Wait for a :func:`start`-ed process (killing it past ``timeout``);
    returns its exit code, output and wall seconds until joined (these
    processes run side by side, so the phase line does not sum them)."""
    proc, f, t0, argv = started
    try:
        rc = proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()
    seconds = time.perf_counter() - t0
    return rc, Path(f.name).read_text(), seconds


def compared(stats: dict) -> dict:
    """Stats without the host clock's keys and the ``fastpath_`` counters
    (process-wide: they count what the process compiled before)."""
    return {k: v for k, v in without_fastpath(stats).items()
            if k not in VOLATILE}


def start_streaming(work: Path, untuned_dir: Path) -> dict:
    """Phase 16 (a), started: the synthetic module just over 64 MiB
    written, then in fresh processes ``simulate --pricing-backend serial``
    streamed by the default threshold, ``serial`` and ``vectorized`` in
    memory (``$TPUSIM_STREAM_THRESHOLD`` raised), and
    :data:`STREAM_CHILD` twice, streamed with every default (the RSS leg)
    and with a compile store (the cold store leg)."""
    t0 = time.perf_counter()
    trace = work / "stream_trace"
    hlo = write_stream_trace(trace)
    size = hlo.stat().st_size
    if size < MIN_STREAM_BYTES:
        raise AssertionError(f"streaming trace of {size} B is under "
                             f"{MIN_STREAM_BYTES} B")
    env = {"stream": dict(STREAM_ENV),
           "memory": {"TPUSIM_STREAM_THRESHOLD": str(1 << 40)}}
    legs = {}
    for mode, backend in (("stream", "serial"), ("memory", "serial"),
                          ("memory", "vectorized")):
        out = work / f"stream_{mode}_{backend}.json"
        legs[f"{mode}_{backend}"] = (out, start(
            [sys.executable, "-m", "tpusim_torch", "simulate", str(trace),
             "--arch", "v5e", "--pricing-backend", backend,
             "--json", str(out)],
            work / f"stream_{mode}_{backend}.log",
            child_env(TPUSIM_TUNED_DIR=str(untuned_dir), **env[mode])))
    for leg, store in (("rss", ""), ("store_cold", work / "stream_store")):
        out = work / f"stream_{leg}.json"
        legs[leg] = (out, start(
            [sys.executable, "-c", HOP, sys.executable, "-c", STREAM_CHILD,
             str(REPO), str(trace), str(out), str(store)],
            work / f"stream_{leg}.log",
            child_env(TPUSIM_TUNED_DIR=str(untuned_dir), **env["stream"])))
    return {"trace": trace, "size": size, "legs": legs,
            "write_s": time.perf_counter() - t0,
            "store": work / "stream_store"}


def finish_streaming(card_name: str, started: dict) -> dict:
    """Phase 16 (a), checked: every leg's stats equal the in-memory serial
    run's (the host clock's and the ``fastpath_`` keys aside); the RSS
    leg's peak over its own import floor below
    :data:`STREAM_RSS_FRACTION` of the file; the cold store leg priced a
    streaming module with at most :data:`STREAM_PARSED_CAP` computations
    parsed and no per-op aggregates, and wrote one lean ``.cmod``; then,
    in this process, the warm store leg prices from that record with 0
    IR ops built."""
    from tpusim_torch.ir import ir_build_counter
    from tpusim_torch.fastpath.store import (
        read_record_header,
        set_compile_store,
    )

    size, store = started["size"], started["store"]
    seconds, docs = {}, {}
    for leg, (out, proc) in started["legs"].items():
        rc, log, seconds[leg] = finish(proc)
        if rc != 0:
            raise AssertionError(f"streaming leg {leg}: exit {rc}: "
                                 f"{log[-2000:]}")
        docs[leg] = json.loads(out.read_text())
    want = compared(docs["memory_serial"])
    stats = {leg: compared(doc) for leg, doc in docs.items()
             if leg not in ("rss", "store_cold")}
    stats.update({leg: compared(docs[leg]["stats"])
                  for leg in ("rss", "store_cold")})
    for leg in ("rss", "store_cold"):
        doc = docs[leg]
        if doc["module"] != "StreamingModuleTrace" or doc["per_op"] \
                or doc["parsed"] > STREAM_PARSED_CAP:
            raise AssertionError(f"streaming leg {leg}: {doc['module']}, "
                                 f"{doc['per_op']} per-op rows, "
                                 f"{doc['parsed']} parsed")
    [record] = store.glob("*.cmod")
    header = read_record_header(record)
    if header["lean"] is not True or not header["key"].endswith("|lean"):
        raise AssertionError(f"the store's record is not lean: "
                             f"{header['key']}")
    if docs["store_cold"]["stats"].get("fastpath_store_writes", 0) < 1:
        raise AssertionError("the cold store leg wrote no record")

    # the warm leg in this process: no compiled state in memory, so every
    # column comes from the record; the fastpath_ counters are process-
    # wide, so the IR ops it built are the counter's rise across it
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("TPUSIM_STREAM")}
    os.environ.update(STREAM_ENV)
    clear_compiled_cache()
    built = ir_build_counter["ops"]
    t0 = time.perf_counter()
    try:
        warm = simulate_trace(started["trace"], arch="v5e", tuned=False,
                              compile_cache=store)
    finally:
        set_compile_store(None)
        clear_compiled_cache()
        for k in STREAM_ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)
    seconds["store_warm"] = time.perf_counter() - t0
    built = ir_build_counter["ops"] - built
    if warm.stats.get("fastpath_store_hits", 0) < 1 or built:
        raise AssertionError(f"warm store leg: {built} IR ops built, store "
                             f"hits {warm.stats.get('fastpath_store_hits')}")
    if warm.totals.per_op_cycles:
        raise AssertionError("the warm store leg carried per-op aggregates")
    stats["store_warm"] = compared(warm.stats.values)
    for leg, st in stats.items():
        if st != want:
            raise AssertionError(f"streaming leg {leg}: stats differ from "
                                 f"the in-memory serial run's")
    rss = docs["rss"]
    added = (rss["peak_kb"] - rss["floor_kb"]) * 1024
    if added <= 0:
        raise AssertionError(f"the RSS leg read no rise: {rss}")
    if added >= STREAM_RSS_FRACTION * size:
        raise AssertionError(
            f"streaming added {added} B of RSS over the import floor, not "
            f"below {STREAM_RSS_FRACTION} x the {size} B file")
    out = {
        "file_bytes": size, "comps": STREAM_COMPS, "ops": STREAM_OPS,
        "write_s": started["write_s"], "rss_floor_kb": rss["floor_kb"],
        "rss_peak_kb": rss["peak_kb"], "rss_added_bytes": added,
        "rss_added_of_file": added / size,
        "pricing_s": {leg: docs[leg]["seconds"]
                      for leg in ("rss", "store_cold")},
        "joined_s": seconds, "parsed": {
            leg: docs[leg]["parsed"] for leg in ("rss", "store_cold")},
        "sim_cycle": want["sim_cycle"],
    }
    print(f"  (a) {STREAM_COMPS} x {STREAM_OPS}-op module, {size} B: "
          f"simulate streamed (serial, vectorized, vectorized with a cold "
          f"and a warm compile store) and in memory (serial, vectorized), "
          f"equal stats (sim_cycle {want['sim_cycle']!r}); RSS leg floor "
          f"{rss['floor_kb']} KiB, peak {rss['peak_kb']} KiB, added "
          f"{added / 2**20:.2f} MiB = {added / size:.4f} of the file "
          f"(bound {STREAM_RSS_FRACTION}); pricing s: RSS leg "
          f"{rss['seconds']:.2f}, cold store {docs['store_cold']['seconds']:.2f} "
          f"({docs['store_cold']['parsed']} parsed, lean record), warm "
          f"store {seconds['store_warm']:.2f} (0 IR ops); fresh processes "
          f"joined after s " + ", ".join(
              f"{k} {v:.1f}" for k, v in seconds.items() if k != "store_warm")
          + f" (card: {card_name})")
    return out


def start_offline(work: Path) -> dict:
    """Phase 16 (b) and (c), started in the background: ``derive-arch``,
    ``correl-regen``, ``refine`` and the full ``loo`` through the CLI in
    fresh processes with the committed overlays (``configs/``), each
    writing into ``work``."""
    env = child_env()
    cmds = {
        "derive-arch": ["derive-arch", "--out",
                        str(work / "v5p.derived.flags")],
        "correl-regen": ["correl-regen", "--out",
                         str(work / "correl" / "correl_ops.json")],
        "refine": ["refine", "--out", str(work / "refined.flags")],
        "loo": ["loo", "--out", str(work / "loo.json")],
    }
    return {name: start([sys.executable, "-m", "tpusim_torch", *argv],
                        work / f"{name}.log", env)
            for name, argv in cmds.items()}


def loo_gaps(got, want, path: str = "") -> list[tuple[str, float]]:
    """Fields where ``got`` misses ``want`` (``model_version`` aside):
    raises on a structural or non-float difference, returns each float
    gap with its path."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"loo.json{path}: keys differ")
        return [g for k in want if k != "model_version"
                for g in loo_gaps(got[k], want[k], f"{path}.{k}")]
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"loo.json{path}: lengths differ")
        return [g for i, (a, b) in enumerate(zip(got, want))
                for g in loo_gaps(a, b, f"{path}[{i}]")]
    if isinstance(want, float) and isinstance(got, (int, float)):
        return [(path, abs(got - want))] if got != want else []
    if got != want:
        raise AssertionError(f"loo.json{path}: {got!r} != {want!r}")
    return []


def finish_offline(card_name: str, work: Path, started: dict) -> dict:
    """Phase 16 (b) and (c): each output against the committed artifact —
    ``configs/v5p.derived.flags`` by bytes, ``correl_ops.json`` ``==``
    ``reports/``'s and ``async_observable.json`` ``==`` too (both but for
    ``model_version`` and ``tpusim_version``), the refined overlay's sha256
    :data:`REFINE_DIGEST`, ``loo.json`` within :data:`LOO_ATOL` on its
    rounded floats and equal elsewhere."""
    seconds = {}
    for name, proc in started.items():
        rc, log, seconds[name] = finish(proc)
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}: {log[-2000:]}")
    if (work / "v5p.derived.flags").read_bytes() != \
            (REPO / "configs" / "v5p.derived.flags").read_bytes():
        raise AssertionError("derive-arch: output differs from "
                             "configs/v5p.derived.flags")
    masked = ("model_version", "tpusim_version")
    for name in ("correl_ops.json", "async_observable.json"):
        got = json.loads((work / "correl" / name).read_text())
        want = json.loads((REPO / "reports" / name).read_text())
        if {k: v for k, v in got.items() if k not in masked} != \
                {k: v for k, v in want.items() if k not in masked}:
            raise AssertionError(f"correl-regen: {name} differs from "
                                 f"reports/{name}")
    digest = sha256((work / "refined.flags").read_bytes())
    if digest != REFINE_DIGEST:
        raise AssertionError(f"refine: overlay sha256 {digest}")
    gaps = loo_gaps(json.loads((work / "loo.json").read_text()),
                    json.loads((REPO / "reports" / "loo.json").read_text()))
    if any(gap > LOO_ATOL for _, gap in gaps):
        raise AssertionError(f"loo: fields off by more than {LOO_ATOL}: "
                             f"{gaps}")
    print(f"  (b) derive-arch == configs/v5p.derived.flags by bytes "
          f"({seconds['derive-arch']:.1f} s)")
    print(f"  (c) correl-regen == reports/correl_ops.json and "
          f"async_observable.json ({seconds['correl-regen']:.1f} s); refine "
          f"overlay sha256 == the CPU's ({seconds['refine']:.1f} s); loo "
          f"== reports/loo.json but {len(gaps)} rounded field(s) within "
          f"{LOO_ATOL}: " + ", ".join(f"{p} {g:.3g}" for p, g in gaps)
          + f" ({seconds['loo']:.1f} s; card: {card_name})")
    return {"seconds": seconds, "loo_gaps": gaps}


def run_and_diff(card_name: str, work: Path, kept: Path,
                 main_hlo: str) -> dict:
    """Phase 16 (d): ``run -B ubench -C v5e --capture`` over a trace root
    seeded with the card's captures of phases 11, 12 and 14 (every entry
    but :data:`RUN_CAPTURED`, which the run's own capture job captures on
    the card in a fresh process: its module's text must be phase 4's, its
    device the card); every ``simulate`` job printed the exit sentinel;
    then ``stats-diff`` of the run tree against itself ("no differences",
    exit 0) and against a copy with one stat changed (exit 1 under
    ``--check``, naming the stat)."""
    from tpusim_torch.harness.suites import load_suite

    entries = load_suite(RUN_SUITE)
    root = work / "traces"
    root.mkdir()
    for e in entries:
        if e.run_name != RUN_CAPTURED:
            shutil.copytree(kept / e.workload, root / e.run_name)
    out = work / "runs"
    # the run's jobs are `python -m tpusim_torch` processes: they find the
    # package through PYTHONPATH wherever this script was started from
    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([path] if path else []))
    t0 = time.perf_counter()
    try:
        text = run_cli(["run", "-B", RUN_SUITE, "-C", RUN_CONFIG, "-o",
                        str(out), "--traces", str(root), "--capture",
                        "--parallel", str(RUN_PARALLEL),
                        "--monitor-interval", "0"])
    finally:
        if path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = path
    run_s = time.perf_counter() - t0
    captures = json.loads((root / "capture_jobs.json").read_text())
    if [Path(j["log"]).name for j in captures] != \
            [f"{RUN_CAPTURED}.capture.log"] or \
            captures[0]["status"] != "done":
        raise AssertionError(f"capture jobs: {captures}")
    captured = root / RUN_CAPTURED
    if module_text(captured, RUN_CAPTURED) != main_hlo:
        raise AssertionError(f"{RUN_CAPTURED}: the run's capture differs "
                             f"from phase 4's module")
    kind = json.loads((captured / "meta.json").read_text())["device_kind"]
    if kind != torch.cuda.get_device_name(0):
        raise AssertionError(f"{RUN_CAPTURED} captured on {kind!r}")
    jobs = json.loads((out / "jobs.json").read_text())
    failures = json.loads((out / "failures.json").read_text())
    runs = sorted(p.parent.name for p in out.glob("*/run.log"))
    if failures or len(jobs) != len(entries) or len(runs) != len(entries) \
            or any(EXIT_SENTINEL not in (out / r / "run.log").read_text()
                   for r in runs):
        raise AssertionError(f"run: {len(runs)} runs of {len(entries)}, "
                             f"failures {failures}")
    if f"{len(entries)} runs scraped" not in text:
        raise AssertionError(f"run printed {text!r}")
    rows = {r: json.loads((out / r / "run.stats.json").read_text())
            for r in runs}

    same = io.StringIO()
    with contextlib.redirect_stdout(same):
        rc_same = cli(["stats-diff", str(out), str(out), "--check"])
    changed = work / "runs_changed"
    shutil.copytree(out, changed)
    victim = runs[0]
    sidecar = changed / victim / "run.stats.json"
    doc = json.loads(sidecar.read_text())
    doc[DIFF_STAT] = doc[DIFF_STAT] * 2 + 1
    sidecar.write_text(json.dumps(doc))
    diff = io.StringIO()
    with contextlib.redirect_stdout(diff):
        rc_diff = cli(["stats-diff", str(out), str(changed), "--check"])
    want = (f"{victim}/run.log: {DIFF_STAT} {rows[victim][DIFF_STAT]} -> "
            f"{doc[DIFF_STAT]}")
    if (rc_same, same.getvalue()) != (0, "no differences\n") or \
            rc_diff != 1 or diff.getvalue().splitlines() != [want]:
        raise AssertionError(f"stats-diff: {rc_same} {same.getvalue()!r}; "
                             f"{rc_diff} {diff.getvalue()!r}")
    print(f"  (d) run -B {RUN_SUITE} -C {RUN_CONFIG} --capture: "
          f"{len(runs)} runs, every simulate job with the exit sentinel, 1 "
          f"capture job ({RUN_CAPTURED} on {kind}, its module == phase 4's); "
          f"{run_s:.1f} s with --parallel {RUN_PARALLEL}; stats-diff: "
          f"itself 'no differences', one stat changed exit 1 '{want}' "
          f"(card: {card_name})")
    return {"runs": len(runs), "capture_jobs": len(captures),
            "run_s": run_s,
            "sim_cycle": {r: rows[r].get("sim_cycle") for r in runs}}


def streaming_harness(card_name: str, work: Path, kept: Path,
                      main_hlo: str) -> dict:
    """Phase 16: (a)'s five fresh processes and (b) and (c) start in the
    background, (d) runs meanwhile, then (a)'s warm leg and the checks of
    (a)-(c); the kernels' counters are set to 0 just before each part run
    in this process and read just after (they must stay 0: phase 16
    prices on the host, and the capture job of (d) runs in its own
    process).  Returns each part's seconds and readings."""
    out = {"seconds": {}, "launches": {}}
    t_phase = time.perf_counter()
    untuned_dir = work / "no_tuned_overlays"
    untuned_dir.mkdir()
    offline = work / "offline"
    offline.mkdir()
    procs = []
    try:
        offline_started = start_offline(offline)
        procs += offline_started.values()
        streaming = start_streaming(work, untuned_dir)
        procs += [p for _, p in streaming["legs"].values()]
        for part, fn in (
                ("d", lambda: run_and_diff(card_name, work, kept,
                                           main_hlo)),
                ("a", lambda: finish_streaming(card_name, streaming)),
                ("bc", lambda: finish_offline(card_name, offline,
                                              offline_started))):
            for *_, reset in KERNELS:
                reset()
            t0 = time.perf_counter()
            out[part] = fn()
            out["seconds"][part] = time.perf_counter() - t0
            out["launches"][part] = no_launches(f"phase 16 ({part})")
    finally:
        for proc, f, *_ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["card"] = card_name
    print(f"harness: kernel launches by part {out['launches']}; "
          f"{out['seconds']['phase']:.1f} s (card: {card_name})")
    return out


# ---------------------------------------------------------------------------
# phase 17: the serving plane on the card's host
# ---------------------------------------------------------------------------

#: ``ci/check_golden.py``'s served-bytes canon (``_serve_served_bytes``),
#: copied as data: a served stats doc without :data:`VOLATILE` and the perf
#: layer's accounting prefixes, rendered as the golden writer renders the
#: CLI's
SERVED_DROP_PREFIXES = ("cache_", "pool_", "guard_", "fastpath_")
#: phase 17 (a): warm requests of :data:`SERVE_TIMED_CELL` timed for the
#: served p50
SERVE_P50_REQUESTS = 200
#: phase 17 (a), (d): the golden cell timed warm through the daemon and
#: cold through a fresh ``simulate`` process
SERVE_TIMED_CELL = GOLDEN_CELLS[0]
#: phase 17 (c): the traces the card captured at registered width
#: (phase 4, the ten of phase 11, phase 12's all-reduce)
SERVED_CAPTURES = ("flash_attention_pallas",) + LOWERED + ("ici_allreduce",)
#: phase 17 (d): a module whose serial walk prices for seconds, far past
#: the watchdog's 0.25 s sample interval, and the thresholds below and
#: far above any process's RSS
RSS_TRACE = REPO / "reports" / "silicon" / "decode_step"
RSS_BELOW = "1M"
RSS_ABOVE = "512G"
#: phase 17 (d): runs the command in its arguments and prints the seconds
#: it took as its last line (a process's own wall time, though several run
#: side by side)
TIMED = ("import subprocess, sys, time; t0 = time.perf_counter(); "
         "rc = subprocess.call(sys.argv[1:]); "
         "print(f'process_s {time.perf_counter() - t0!r}'); sys.exit(rc)")


def served_bytes(stats: dict) -> str:
    doc = {k: v for k, v in stats.items()
           if k not in VOLATILE and not k.startswith(SERVED_DROP_PREFIXES)}
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def held_to_golden(stem: str, stats: dict) -> int:
    """A served stats doc against its golden by the served-bytes canon:
    equal bytes, or (the v6e power cell on Python 3.12, whose float
    ``sum`` moves one field by an ulp in both packages, ROADMAP A8) every
    key and non-float equal and the floats within :data:`SMOKE_RTOL`.
    Returns the number of floats that differ."""
    got = served_bytes(stats)
    want = (REPO / "ci" / "golden" / f"{stem}.json").read_text()
    if got == want:
        return 0
    return len(golden_gaps(json.loads(got), json.loads(want), stem))


def golden_pass(client) -> list:
    """Every golden cell through ``client``: (stem, SimResult)."""
    return [(stem, client.simulate(trace=fixture, arch=arch,
                                   overlays=list(overlays), tuned=False))
            for fixture, arch, overlays, stem in GOLDEN_CELLS]


def metrics_gauges(prom: str, required: list[str]) -> int:
    """``/metrics`` parses as Prometheus text and carries ``required``;
    returns the number of samples."""
    n = 0
    for line in prom.splitlines():
        if line and not line.startswith("#"):
            key, value = line.split()
            float(value)
            n += 1
    missing = [k for k in required if f"tpusim_{k} " not in prom]
    if missing:
        raise AssertionError(f"/metrics misses {missing}")
    return n


def serve_smoke_leg(serve_workers: int) -> dict:
    """Phase 17 (a) / (b): ``ci/check_golden.py``'s ``serve_smoke`` on
    the port — the golden matrix served cold equals the goldens by the
    canon; a warm pass is all ``cache_hit`` with 0 engine walks in this
    process (over both passes when a forked pool prices); ``/metrics``
    carries the serve counters; ``/healthz`` ok; the drain completes.
    At 0 workers the warm p50 of :data:`SERVE_TIMED_CELL` is timed."""
    from tpusim_torch.serve.client import ServeClient
    from tpusim_torch.serve.daemon import ServeDaemon

    out = {}
    daemon = ServeDaemon(trace_root=FIXTURES, max_inflight=4,
                         serve_workers=serve_workers)
    with counting_engine_runs() as walks:
        daemon.start()
        try:
            client = ServeClient(daemon.url)
            health = client.healthz()
            if health["status"] != "ok" or (
                    serve_workers
                    and health["workers_alive"] != serve_workers):
                raise AssertionError(f"healthz: {health}")
            cold = golden_pass(client)
            out["float_gaps"] = {stem: held_to_golden(stem, r.stats)
                                 for stem, r in cold}
            walks_before = walks["n"] if not serve_workers else 0
            warm = golden_pass(client)
            out["walks"] = walks["n"] - walks_before
            if out["walks"]:
                raise AssertionError(f"{out['walks']} engine walks in this "
                                     f"process (expected 0)")
            missed = [stem for stem, r in warm if not r.cache_hit]
            if missed:
                raise AssertionError(f"warm pass not cache_hit: {missed}")
            for (stem, a), (_, b) in zip(cold, warm):
                if served_bytes(a.stats) != served_bytes(b.stats):
                    raise AssertionError(f"{stem}: warm bytes differ")
            required = ["serve_requests_total", "serve_cache_hits"]
            if serve_workers:
                required += ["serve_workers_alive",
                             "serve_worker_restarts_total",
                             "serve_worker_kills_total",
                             "serve_quarantine_size", "serve_shed_503_total"]
            out["gauges"] = metrics_gauges(client.metrics_text(), required)
            if not serve_workers:
                fixture, arch, overlays, _ = SERVE_TIMED_CELL
                times = []
                for _ in range(SERVE_P50_REQUESTS):
                    t0 = time.perf_counter()
                    client.simulate(trace=fixture, arch=arch,
                                    overlays=list(overlays), tuned=False)
                    times.append(time.perf_counter() - t0)
                out["warm_p50_ms"] = statistics.median(times) * 1e3
        finally:
            if not daemon.drain_and_stop():
                raise AssertionError("the daemon did not drain")
    return out


def serve_chaos_leg() -> dict:
    """Phase 17 (b): ``serve_chaos_smoke`` — a worker SIGKILLed the moment
    it holds a request, mid-matrix: 0 failed requests, every response the
    golden's by the canon, at least one restart."""
    import threading

    from tpusim_torch.serve.client import ServeClient
    from tpusim_torch.serve.daemon import ServeDaemon

    daemon = ServeDaemon(trace_root=FIXTURES, max_inflight=4,
                         serve_workers=2).start()
    sup = daemon.supervisor
    stop = threading.Event()
    killed = {"pid": None}

    def chaos():
        while not stop.is_set():
            for slot in sup.slots:
                if slot.busy and slot.pid is not None:
                    killed["pid"] = slot.pid
                    sup.kill_worker(slot.index)
                    return
            stop.wait(0.002)

    chaos_thread = threading.Thread(target=chaos, daemon=True)
    try:
        client = ServeClient(daemon.url)
        chaos_thread.start()
        served = 0
        for _ in range(2):
            for stem, r in golden_pass(client):
                held_to_golden(stem, r.stats)
                served += 1
        stop.set()
        chaos_thread.join(timeout=5.0)
        restarts = sum(s.restarts for s in sup.slots)
        if killed["pid"] is None or restarts < 1:
            raise AssertionError(f"chaos: killed {killed['pid']}, "
                                 f"restarts {restarts}")
    finally:
        stop.set()
        if not daemon.drain_and_stop():
            raise AssertionError("the daemon did not drain after chaos")
    return {"served": served, "killed_pid": killed["pid"],
            "restarts": restarts, "retried": sup.retried}


def coop_cancel_leg() -> dict:
    """Phase 17 (b): ``guard_smoke``'s leg 2 — a request past its
    deadline answers 504 through the worker's in-process cancel; the
    worker keeps its pid (no restart, no kill), answers the next request
    warm with the same bytes, and the cooperative-cancel counter is on
    ``/metrics``."""
    from tpusim_torch.serve.client import ServeClient
    from tpusim_torch.serve.daemon import ServeDaemon

    daemon = ServeDaemon(trace_root=FIXTURES, serve_workers=2,
                         chaos_hooks=True).start()
    try:
        client = ServeClient(daemon.url)
        warmup = client.simulate(trace="matmul_512", arch="v5e", tuned=False)
        pids = [w["pid"] for w in client.healthz()["workers"]]
        resp, payload = client._raw("POST", "/v1/simulate", {
            "trace": "matmul_512", "arch": "v5e", "tuned": False,
            "_chaos_spin_s": 10, "deadline_ms": 400,
        })
        doc = json.loads(payload)
        if resp.status != 504 or "cooperative" not in doc.get("detail", ""):
            raise AssertionError(f"expected an in-process 504, got "
                                 f"{resp.status} {doc.get('detail')!r}")
        health = client.healthz()
        after = [w["pid"] for w in health["workers"]]
        restarts = sum(w["restarts"] for w in health["workers"])
        kills = sum(w["kills"] for w in health["workers"])
        if after != pids or restarts or kills or \
                health["workers_alive"] != 2:
            raise AssertionError(f"the cancel cost a worker: pids {pids} -> "
                                 f"{after}, restarts {restarts}, kills "
                                 f"{kills}")
        if "tpusim_serve_worker_coop_cancels_total 1" not in \
                client.metrics_text():
            raise AssertionError("/metrics misses the coop-cancel counter")
        repeat = client.simulate(trace="matmul_512", arch="v5e", tuned=False)
        if not repeat.cache_hit or \
                served_bytes(repeat.stats) != served_bytes(warmup.stats):
            raise AssertionError("the post-cancel repeat was not warm")
    finally:
        if not daemon.drain_and_stop():
            raise AssertionError("the daemon did not drain after the cancel")
    return {"pids": pids, "restarts": restarts, "kills": kills}


def full_width_leg(work: Path, kept: Path) -> dict:
    """Phase 17 (c): the card's captures at registered width served at
    v5e and v5p with the hot cache on: each cold response equals
    ``simulate_trace`` on the same dir by the canon, and a repeat is a
    hot hit with the same bytes."""
    from tpusim_torch.serve.client import ServeClient
    from tpusim_torch.serve.daemon import ServeDaemon

    root = work / "served_traces"
    root.mkdir()
    for name in SERVED_CAPTURES:
        shutil.copytree(kept / name, root / name)
    out = {"cells": 0, "hot_hits": 0}
    daemon = ServeDaemon(trace_root=root, hot_cache=work / "hot").start()
    try:
        client = ServeClient(daemon.url)
        for name in SERVED_CAPTURES:
            for arch in ("v5e", "v5p"):
                # unvalidated, as simulate_trace prices by default
                cold = client.simulate(trace=name, arch=arch, tuned=False,
                                       validate=False)
                want = served_bytes(stats_of(simulate_trace(
                    root / name, arch=arch, tuned=False)))
                if served_bytes(cold.stats) != want:
                    raise AssertionError(f"{name} @ {arch}: served stats "
                                         f"differ from simulate_trace's")
                hot = client.simulate(trace=name, arch=arch, tuned=False,
                                      validate=False)
                if not hot.cache_hit or served_bytes(hot.stats) != want:
                    raise AssertionError(f"{name} @ {arch}: the repeat "
                                         f"was not the same bytes, warm")
                out["cells"] += 1
        prom = client.metrics_text()
        out["hot_hits"] = next(
            float(ln.split()[1]) for ln in prom.splitlines()
            if ln.startswith("tpusim_serve_hot_hits_total "))
        if out["hot_hits"] != out["cells"]:
            raise AssertionError(f"{out['hot_hits']} hot hits for "
                                 f"{out['cells']} repeats")
    finally:
        if not daemon.drain_and_stop():
            raise AssertionError("the daemon did not drain")
    return out


def start_entry_points(work: Path) -> dict:
    """Phase 17 (d): the fresh processes, all started together: ``serve``
    with two forked workers and both durable tiers; ``simulate
    --max-wall-s 1e-6``; ``simulate --max-rss`` below and far above the
    RSS on :data:`RSS_TRACE` (serial) and the same without the flag."""
    env = child_env()
    store = work / "store"
    rss = [str(RSS_TRACE), "--arch", "v5e", "--pricing-backend", "serial"]
    runs = {
        "wall": ["simulate", str(FIXTURES / "llama_tiny_tp2dp2"),
                 "--arch", "v5p", "--max-wall-s", "1e-6"],
        "rss_below": ["simulate", *rss, "--max-rss", RSS_BELOW],
        "rss_above": ["simulate", *rss, "--max-rss", RSS_ABOVE,
                      "--json", str(work / "rss_above.json")],
        "rss_plain": ["simulate", *rss, "--json", str(work / "plain.json")],
    }
    started = {k: start([sys.executable, "-c", TIMED, sys.executable, "-m",
                         "tpusim_torch", *argv], work / f"{k}.log", env)
               for k, argv in runs.items()}
    log = open(work / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpusim_torch", "serve", "--port", "0",
         "--trace-root", str(FIXTURES), "--serve-workers", "2",
         "--result-cache", str(store), "--compile-cache", str(store)],
        stdout=subprocess.PIPE, stderr=log, text=True, cwd=REPO, env=env)
    return {"runs": started, "serve": (proc, log, time.perf_counter())}


def stop_serve(proc) -> None:
    """Stop a ``serve`` process that is still up: SIGTERM first (its drain
    reaps the workers it forked, which a SIGKILL would orphan), then
    SIGKILL past a minute."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def finish_entry_points(work: Path, started: dict) -> dict:
    """Phase 17 (d)'s checks: the served golden cell's bytes, SIGTERM's
    drain and exit 0; exit 3 for both cancels, the RSS leg naming the
    shed; the far-above run's stats equal the plain run's.  Then the cold
    ``simulate`` process of :data:`SERVE_TIMED_CELL`, alone, timed."""
    import signal

    from tpusim_torch.serve.client import ServeClient

    out = {}
    proc, log, t0 = started["serve"]
    try:
        line = proc.stdout.readline()
        if "listening on http://" not in line:
            raise AssertionError(f"serve did not start: {line!r}")
        url = line.split("listening on ", 1)[1].split()[0]
        fixture, arch, overlays, stem = SERVE_TIMED_CELL
        r = ServeClient(url, timeout_s=120.0).simulate(
            trace=fixture, arch=arch, overlays=list(overlays), tuned=False)
        if served_bytes(r.stats) != \
                (REPO / "ci" / "golden" / f"{stem}.json").read_text():
            raise AssertionError("the fresh daemon's golden cell differs")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        rest = proc.stdout.read()
        if rc != 0 or "drained, exiting" not in rest:
            raise AssertionError(f"serve under SIGTERM: exit {rc}, {rest!r}")
        out["serve_s"] = time.perf_counter() - t0
    finally:
        stop_serve(proc)
        log.close()
    done = {k: finish(s) for k, s in started["runs"].items()}
    for k in ("wall", "rss_below"):
        rc, text, _ = done[k]
        if rc != 3 or "tpusim_torch simulate: cancelled: " not in text:
            raise AssertionError(f"simulate {k}: exit {rc}: {text[-400:]}")
    if "every droppable store already shed" not in done["rss_below"][1]:
        raise AssertionError("the RSS leg did not shed")
    for k in ("rss_above", "rss_plain"):
        if done[k][0] != 0 or EXIT_SENTINEL not in done[k][1]:
            raise AssertionError(f"simulate {k}: exit {done[k][0]}")
    above, plain = (
        {key: v for key, v in json.loads((work / f).read_text()).items()
         if key not in VOLATILE} for f in ("rss_above.json", "plain.json"))
    if above != plain:
        raise AssertionError("--max-rss far above the RSS changed stats")
    out["process_s"] = {
        k: float(v[1].strip().splitlines()[-1].split()[1])
        for k, v in done.items()}
    fixture, arch, *_ = SERVE_TIMED_CELL
    t0 = time.perf_counter()
    proc = run_process([sys.executable, "-m", "tpusim_torch", "simulate",
                        str(FIXTURES / fixture), "--arch", arch],
                       capture_output=True, text=True, cwd=REPO,
                       env=child_env(), timeout=600)
    out["cold_cell_process_s"] = time.perf_counter() - t0
    if proc.returncode != 0 or EXIT_SENTINEL not in proc.stdout:
        raise AssertionError(f"cold simulate: exit {proc.returncode}")
    return out


def serving_plane(card_name: str, work: Path, kept: Path) -> dict:
    """Phase 17: (d)'s fresh processes start first, (a)-(c) run in this
    process meanwhile, then (d)'s checks; the kernels' counters are set
    to 0 at the phase's start and read at its end (they must stay 0:
    serving prices on the host, and the forked workers never touch the
    card).  ``TPUSIM_STREAM_THRESHOLD`` is as it was afterwards."""
    threshold = os.environ.get("TPUSIM_STREAM_THRESHOLD")
    for *_, reset in KERNELS:
        reset()
    out = {"seconds": {}}
    t_phase = time.perf_counter()
    started = start_entry_points(work)
    try:
        for part, fn in (("a", lambda: serve_smoke_leg(0)),
                         ("b", lambda: {"pool": serve_smoke_leg(2),
                                        "chaos": serve_chaos_leg(),
                                        "coop_cancel": coop_cancel_leg()}),
                         ("c", lambda: full_width_leg(work, kept)),
                         ("d", lambda: finish_entry_points(work, started))):
            t0 = time.perf_counter()
            out[part] = fn()
            out["seconds"][part] = time.perf_counter() - t0
            print(f"  ({part}) {out['seconds'][part]:.2f} s: "
                  + json.dumps(out[part]), flush=True)
    finally:
        proc, log, _ = started["serve"]
        stop_serve(proc)
        log.close()
        for proc, f, *_ in started["runs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    if os.environ.get("TPUSIM_STREAM_THRESHOLD") != threshold:
        raise AssertionError("phase 17 left TPUSIM_STREAM_THRESHOLD changed")
    out["launches"] = no_launches("phase 17")
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["card"] = card_name
    fixture, arch, _, _ = SERVE_TIMED_CELL
    print(f"  serving plane: {fixture} @ {arch} warm served p50 "
          f"{out['a']['warm_p50_ms']:.3f} ms, cold simulate process "
          f"{out['d']['cold_cell_process_s']:.2f} s; kernel launches "
          f"{out['launches']}; {out['seconds']['phase']:.1f} s "
          f"(card: {card_name})", flush=True)
    return out

# ---------------------------------------------------------------------------
# phase 18: the front tier, the sharded campaign, the bench, the native
# bridges and the power fit on the card's host
# ---------------------------------------------------------------------------

#: phase 18 (a): the acceptors of each front, and the requests of its
#: kill-and-heal storm (acceptor 1 SIGKILLed before the sixth)
FRONT_ACCEPTORS = 2
FRONT_STORM = 30
#: phase 18 (b): the nodes phase 9 (c)'s campaign shards over, and the
#: scenario records the victim's journal holds when it is SIGKILLed
SHARD_NODES = 3
SHARD_KILL_AFTER = 8
#: phase 18 (c): the bench's mix (captures of phases 4, 11 and 12, priced
#: at v5e); per sweep its legs and the requests of a leg's storm (the
#: reference's defaults: 64 for the worker sweep, 256 for the acceptor
#: sweep, whose storm forks its loadgen processes inside the timed
#: window), at the reference's default concurrency
BENCH_TRACES = ("flash_attention_pallas", "matmul_chain", "ici_allreduce")
BENCH_SWEEPS = {"worker": ("--worker-sweep", "0,2", 64),
                "acceptor": ("--acceptor-sweep", "1,2", 256)}
BENCH_CONCURRENCY = 8
#: phase 18 (d): every capture of phases 4, 11 and 12
PARSED_CAPTURES = ("flash_attention_pallas",) + LOWERED + MULTI
#: phase 18 (d): a module of long synchronous runs (no golden cell has a
#: run past the native scan's 192-op threshold): computations x ops
LONG_RUNS = (4, 400)


def kill_and_heal(front, url: str) -> dict:
    """Acceptor 1 SIGKILLed mid-storm: every request answers (the client
    reconnects onto the survivor), the supervisor respawns the slot and
    ``/healthz`` counts both acceptors again."""
    from tpusim_torch.serve.client import ServeClient

    fixture, arch, overlays, _ = GOLDEN_CELLS[0]
    boots = front.slots[1].boots
    t0 = time.perf_counter()
    for i in range(FRONT_STORM):
        if i == 5:
            front.kill_acceptor(1)
        ServeClient(url, retries=3).simulate(
            trace=fixture, arch=arch, overlays=list(overlays), tuned=False)
    deadline = time.monotonic() + 30
    while (front.slots[1].boots <= boots or not front.slots[1].alive) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    healed_s = time.perf_counter() - t0
    health = ServeClient(url, retries=3).healthz()
    if front.slots[1].boots <= boots or health["acceptors_alive"] != 2:
        raise AssertionError(f"the killed acceptor did not heal: {health}")
    return {"storm_requests": FRONT_STORM, "heal_s": healed_s,
            "restarts": front.slots[1].restarts}


def front_leg(work: Path, fd_mode: bool) -> dict:
    """Phase 18 (a), one transport: the golden matrix through a two-
    acceptor front, first and repeated on fresh connections; the kill and
    heal; the fleet-wide ``/metrics``; a clean stop."""
    from tpusim_torch.serve.client import ServeClient
    from tpusim_torch.serve.front import FrontSupervisor

    old = os.environ.get("TPUSIM_NO_REUSEPORT")
    if fd_mode:
        os.environ["TPUSIM_NO_REUSEPORT"] = "1"
    tag = "fd" if fd_mode else "reuseport"
    try:
        front = FrontSupervisor(
            {"trace_root": str(FIXTURES), "max_inflight": 4,
             "hot_cache": str(work / f"hot_{tag}"),
             "quarantine_dir": str(work / f"quarantine_{tag}")},
            num_acceptors=FRONT_ACCEPTORS, restart_backoff_s=0.1).start()
    finally:
        if old is None:
            os.environ.pop("TPUSIM_NO_REUSEPORT", None)
        else:
            os.environ["TPUSIM_NO_REUSEPORT"] = old
    out = {}
    try:
        if front.reuse_port == fd_mode:
            raise AssertionError(f"{tag}: reuse_port {front.reuse_port}")
        health = ServeClient(front.url, retries=3).healthz()
        if health["acceptors_alive"] != FRONT_ACCEPTORS:
            raise AssertionError(f"{tag}: healthz {health}")
        gaps = {}
        for leg in ("first", "repeated"):
            for fixture, arch, overlays, stem in GOLDEN_CELLS:
                r = ServeClient(front.url, retries=3).simulate(
                    trace=fixture, arch=arch, overlays=list(overlays),
                    tuned=False)
                gaps[stem] = held_to_golden(stem, r.stats)
        out["float_gaps"] = gaps
        out["kill"] = kill_and_heal(front, front.url)
        client = ServeClient(front.url, retries=3)
        fleet = client.metrics_text()
        _, local = client._raw("GET", "/metrics?scope=local")

        def metric(text, key):
            return next((float(ln.split()[1]) for ln in text.splitlines()
                         if ln.startswith(f"tpusim_{key} ")), 0.0)

        if (metric(fleet, "serve_acceptors_alive") != FRONT_ACCEPTORS
                or metric(fleet, "serve_acceptors_configured")
                != FRONT_ACCEPTORS
                or metric(fleet, "serve_requests_total")
                < metric(local.decode(), "serve_requests_total")):
            raise AssertionError(f"{tag}: /metrics is not fleet-wide")
        out["fleet_requests"] = metric(fleet, "serve_requests_total")
        out["hot_hits"] = metric(fleet, "serve_hot_hits_total")
    finally:
        if not front.stop():
            raise AssertionError(f"{tag}: the front did not stop cleanly")
    return out


def shard_sigs(out_dir: Path) -> tuple[set, int]:
    """Every (slice, index) the shard journals under ``out_dir`` hold, and
    how many of them more than once."""
    from tpusim_torch.campaign.journal import Journal

    seen: set = set()
    dup = 0
    for d in sorted((out_dir / "shards").iterdir()):
        for rec in Journal(d).iter_records():
            if rec.get("kind") == "scenario":
                sig = (rec["slice"], rec["index"])
                dup += sig in seen
                seen.add(sig)
    return seen, dup


def kill_when_journaled(procs: dict, out_dir: Path, killed: list) -> None:
    """``on_spawn`` of the sharded run into ``out_dir``: SIGKILL the
    lowest node of the first wave once its journal holds
    :data:`SHARD_KILL_AFTER` scenarios (from a thread, so the coordinator
    joins its nodes meanwhile)."""
    import signal
    import threading

    if killed or not procs:
        return
    node = sorted(procs)[0]
    victim = procs[node]
    journal = out_dir / "shards" / f"n{node}" / "journal.jsonl"

    def watch():
        deadline = time.monotonic() + 120
        while victim.is_alive() and time.monotonic() < deadline:
            try:
                n = journal.read_text().count('"kind": "scenario"')
            except OSError:
                n = 0
            if n >= SHARD_KILL_AFTER:
                break
            time.sleep(0.005)
        os.kill(victim.pid, signal.SIGKILL)

    killed.append(node)
    threading.Thread(target=watch, daemon=True).start()


def shard_leg(work: Path) -> dict:
    """Phase 18 (b): phase 9 (c)'s campaign single-node, sharded with a
    node SIGKILLed mid-run, and resumed elsewhere through the CLI."""
    from tpusim_torch.campaign import (
        load_campaign_spec, run_campaign, run_sharded_campaign,
        shard_assignment, spec_hash,
    )

    spec = {k: v for k, v in CAMPAIGN_SMOKE_SPEC.items()
            if k not in ("slo", "candidate_slices")}
    spec.update(name="campaign-v5p-64", chips=BIG_CAMPAIGN_CHIPS,
                scenarios=BIG_CAMPAIGN_SCENARIOS)
    trace = FIXTURES / "llama_tiny_tp2dp2"
    out = {}
    t0 = time.perf_counter()
    run_campaign(spec, trace_path=trace, out_dir=work / "single")
    out["single_s"] = time.perf_counter() - t0
    single = (work / "single" / "report.json").read_bytes()
    killed: list = []
    msgs: list = []
    t0 = time.perf_counter()
    res = run_sharded_campaign(
        spec, trace_path=trace, out_dir=work / "sharded", nodes=SHARD_NODES,
        progress=msgs.append,
        on_spawn=lambda procs: kill_when_journaled(
            procs, work / "sharded", killed))
    out["sharded_s"] = time.perf_counter() - t0
    sigs, dup = shard_sigs(work / "sharded")
    if not any("died" in m for m in msgs) or dup or \
            len(sigs) != res.stats.scenarios:
        raise AssertionError(f"sharded run: {msgs}, {dup} priced twice")
    if (work / "sharded" / "report.json").read_bytes() != single:
        raise AssertionError("the sharded report differs from the "
                             "single-node one")
    out["waves"] = msgs
    # a dead node's half-done journal, resumed elsewhere through the CLI
    parsed = load_campaign_spec(spec)
    sigs = [(sl.label, i) for sl in parsed.slices(4)
            for i in range(parsed.scenarios)]
    share = sorted(shard_assignment(sigs, [0, 1], spec_hash(parsed))[1])
    resumed = work / "resumed"
    run_campaign(spec, trace_path=trace, out_dir=resumed / "shards" / "n1",
                 only=set(share[:len(share) // 2]))
    spec_path = work / "spec.json"
    spec_path.write_text(json.dumps(spec))
    argv = ["campaign", str(spec_path), "--trace", str(trace), "--out",
            str(resumed), "--nodes", str(SHARD_NODES)]
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        refused = cli(argv)
    if refused != 1 or "already holds journaled scenarios" not in \
            err.getvalue():
        raise AssertionError(f"--nodes over a journal: exit {refused}")
    t0 = time.perf_counter()
    text = run_cli(argv + ["--resume"])
    out["resume_s"] = time.perf_counter() - t0
    if (resumed / "report.json").read_bytes() != single:
        raise AssertionError("the resumed report differs from the "
                             "single-node one")
    out["resume_line"] = next(ln.strip() for ln in text.splitlines()
                              if "resumed from journal" in ln)
    return out


def start_bench(work: Path, kept: Path) -> dict:
    """Phase 18 (c): both sweeps as fresh ``serve-bench`` processes over a
    trace root of the card's captures, started together."""
    root = work / "bench_traces"
    root.mkdir()
    for name in BENCH_TRACES:
        shutil.copytree(kept / name, root / name)
    mix = [a for t in BENCH_TRACES for a in ("--trace", t)]
    return {kind: (start([sys.executable, "-m", "tpusim_torch", "serve-bench",
                          flag, legs, "--trace-root", str(root), *mix,
                          "--arch", "v5e", "--reps", "1",
                          "--requests", str(requests),
                          "--concurrency", str(BENCH_CONCURRENCY),
                          "--json", str(work / f"bench_{kind}.json")],
                         work / f"bench_{kind}.log", child_env()),
                   work / f"bench_{kind}.json", requests)
            for kind, (flag, legs, requests) in BENCH_SWEEPS.items()}


def finish_bench(started: dict) -> dict:
    """Phase 18 (c)'s checks: exit 0, every leg's requests answered with
    0 errors; req/s and p50 per leg, and the cold-CLI ratio."""
    out = {}
    for kind, (proc, path, requests) in started.items():
        rc, text, seconds = finish(proc)
        if rc != 0:
            raise AssertionError(f"serve-bench {kind} sweep: exit {rc}: "
                                 f"{text[-800:]}")
        doc = json.loads(path.read_text())
        legs = doc[f"{kind}_sweep"]
        bad = [leg for leg in legs if leg["error_count"]
               or leg["requests"] != requests]
        if bad:
            raise AssertionError(f"serve-bench {kind} sweep: {bad}")
        key = "serve_workers" if kind == "worker" else "acceptors"
        out[kind] = {"seconds": seconds, "legs": [
            {key: leg[key], "rps": leg["throughput_rps"],
             "p50_ms": leg["latency_ms"]["p50"],
             "p99_ms": leg["latency_ms"]["p99"]} for leg in legs]}
        if kind == "worker":
            out["cli_baseline"] = legs[0]["cli_baseline"]
    return out


def write_long_runs_trace(tdir: Path) -> Path:
    """A trace of :data:`LONG_RUNS` computations of synchronous runs
    (adds, multiplies, exponentials, a dot every 50th op, some results in
    VMEM), called in turn from the entry (``tests/test_torch_native.py``
    prices it too)."""
    n_comps, n_ops = LONG_RUNS
    (tdir / "modules").mkdir(parents=True)
    (tdir / "meta.json").write_text(json.dumps({
        "format_version": 1, "platform": "tpu",
        "device_kind": "TPU v5 lite"}))
    (tdir / "commandlist.jsonl").write_text(json.dumps({
        "kind": "kernel_launch", "stream": 0, "device": 0, "bytes": 0,
        "module": "long", "collective": None, "attrs": {}}) + "\n")
    lay = "f32[128,128]{1,0:T(8,128)}"
    vm = "f32[128,128]{1,0:T(8,128)S(1)}"
    lines = ["HloModule long_runs, is_scheduled=true", ""]
    for c in range(n_comps):
        lines.append(f"%body_{c} (p0: f32[128,128]) -> f32[128,128] {{")
        lines.append(f"  %p0 = {lay} parameter(0)")
        prev = "%p0"
        for i in range(n_ops):
            kind = ("dot" if i % 50 == 49 else
                    ("add", "multiply", "exponential")[i % 3])
            if kind == "dot":
                rhs = (f"dot({prev}, %p0), lhs_contracting_dims={{1}}, "
                       f"rhs_contracting_dims={{0}}")
            elif kind == "exponential":
                rhs = f"exponential({prev})"
            else:
                rhs = f"{kind}({prev}, %p0)"
            lines.append(f"  %op_{i} = {vm if i % 7 == 3 else lay} {rhs}")
            prev = f"%op_{i}"
        lines += [f"  ROOT %root = {lay} copy({prev})", "}", ""]
    lines.append("ENTRY %main (p0: f32[128,128]) -> f32[128,128] {")
    lines.append(f"  %p0 = {lay} parameter(0)")
    prev = "%p0"
    for c in range(n_comps):
        lines.append(f"  %call_{c} = {lay} call({prev}), to_apply=%body_{c}")
        prev = f"%call_{c}"
    lines += [f"  ROOT %out = {lay} copy({prev})", "}"]
    (tdir / "modules" / "long.hlo").write_text("\n".join(lines) + "\n")
    return tdir


def same_ops(name: str, a, b) -> int:
    """Two parses of one module hold the same computations and ops (name,
    opcode, operands, result, attributes, metadata, called computations,
    collective); returns the op count."""
    if list(a.computations) != list(b.computations) or \
            a.entry_name != b.entry_name or a.meta != b.meta:
        raise AssertionError(f"{name}: computations differ")
    n = 0
    for cname, ca in a.computations.items():
        cb = b.computations[cname]
        if len(ca.ops) != len(cb.ops):
            raise AssertionError(f"{name}/{cname}: op counts differ")
        for x, y in zip(ca.ops, cb.ops):
            if (x.name, x.opcode, x.operands, str(x.result), x.attrs,
                    x.metadata, x.called, x.collective, x.is_root) != (
                    y.name, y.opcode, y.operands, str(y.result), y.attrs,
                    y.metadata, y.called, y.collective, y.is_root):
                raise AssertionError(f"{name}/{cname}: op {x.name} differs")
            n += 1
    return n


def native_leg(kept: Path, work: Path) -> dict:
    """Phase 18 (d): the three native bridges against the Python paths,
    with their counters."""
    import gzip

    from tpusim_torch.fastpath import native as fp_native
    from tpusim_torch.ici import detailed
    from tpusim_torch.kernels import native_build
    from tpusim_torch.trace import native as tn
    from tpusim_torch.trace.hlo_text import parse_hlo_module

    if not (tn.native_available() and fp_native.native_price_available()
            and fp_native.native_batch_available()
            and detailed.native_net_available()):
        raise AssertionError("libtpusim_native.so is not available")
    out = {"library": str(native_build.library_path().relative_to(REPO)),
           "build_s": native_build.build_seconds()}
    parses, ops, t_native, t_python = tn.NATIVE_PARSES, 0, 0.0, 0.0
    for name in PARSED_CAPTURES:
        for path in sorted((kept / name / "modules").iterdir()):
            text = (gzip.open(path, "rt").read() if path.suffix == ".gz"
                    else path.read_text())
            t0 = time.perf_counter()
            a = tn.parse_hlo_module_native(text, name)
            t1 = time.perf_counter()
            b = parse_hlo_module(text, name)
            t_python += time.perf_counter() - t1
            t_native += t1 - t0
            ops += same_ops(name, a, b)
    out["hlo_scan"] = {"captures": len(PARSED_CAPTURES), "ops": ops,
                       "v2": tn._HAS_V2,
                       "parses": tn.NATIVE_PARSES - parses,
                       "native_s": t_native, "python_s": t_python}
    scans = fp_native.SCAN_CALLS
    long_trace = write_long_runs_trace(work / "long_runs")
    cells = [(FIXTURES / f, a, o, stem) for f, a, o, stem in GOLDEN_CELLS]
    cells.append((long_trace, "v5e", [], "long_runs"))
    for trace, arch, overlays, stem in cells:
        got, want = (compared(stats_of(simulate_trace(
            trace, arch=arch, overlays=list(overlays), tuned=False,
            pricing_backend=b))) for b in ("native", "vectorized"))
        if got != want:
            raise AssertionError(f"{stem}: native and vectorized differ")
    out["price_scan"] = {"cells": len(cells),
                         "calls": fp_native.SCAN_CALLS - scans}
    if not out["price_scan"]["calls"]:
        raise AssertionError("the long runs never reached the C scan")
    fixture, arch, overlays, stem = GOLDEN_CELLS[3]
    runs = detailed.NET_RUNS
    native = stats_of(simulate_trace(FIXTURES / fixture, arch=arch,
                                     overlays=list(overlays), tuned=False))
    nets = detailed.NET_RUNS - runs
    available = detailed.native_net_available
    detailed.native_net_available = lambda: False
    try:
        python = stats_of(simulate_trace(FIXTURES / fixture, arch=arch,
                                         overlays=list(overlays),
                                         tuned=False))
    finally:
        detailed.native_net_available = available
    if not nets or compared(native) != compared(python):
        raise AssertionError(f"{stem}: ici_net ({nets} runs) and the "
                             f"Python network differ")
    out["ici_net"] = {"cell": stem, "runs": nets}
    return out


def power_fit_leg(work: Path) -> dict:
    """Phase 18 (e): ``tune --power`` per fitted generation, its
    coefficients the committed ones."""
    out = {}
    for arch in ("v5e", "v5p"):
        run_cli(["tune", "--power", "--arch", arch, "--out",
                 str(work / "fitted")])
        got = json.loads((work / "fitted" / f"{arch}.json").read_text())
        want = json.loads((REPO / "tpusim_torch" / "power" / "fitted"
                           / f"{arch}.json").read_text())
        if got["coefficients"] != want["coefficients"]:
            raise AssertionError(f"tune --power {arch}: coefficients differ")
        out[arch] = got["meta"]["source"]
    return out


def front_shards_bench(card_name: str, work: Path, kept: Path) -> dict:
    """Phase 18: (b) first (its forked nodes fill the host's cores), then
    (c)'s processes start, and (a), (d) and (e) run in this process while
    they boot, then (c)'s checks: the bench's storms share the host with
    the other sweep only.  The kernels' counters are set to 0 at the
    start and read at the end (they must stay 0)."""
    for *_, reset in KERNELS:
        reset()
    out = {"seconds": {}}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    out["b"] = shard_leg(work)
    out["seconds"]["b"] = time.perf_counter() - t0
    print(f"  (b) {out['seconds']['b']:.2f} s: " + json.dumps(out["b"]),
          flush=True)
    started = start_bench(work, kept)
    try:
        for part, fn in (("a", lambda: {"reuseport": front_leg(work, False),
                                        "fd": front_leg(work, True)}),
                         ("d", lambda: native_leg(kept, work)),
                         ("e", lambda: power_fit_leg(work)),
                         ("c", lambda: finish_bench(started))):
            t0 = time.perf_counter()
            out[part] = fn()
            out["seconds"][part] = time.perf_counter() - t0
            print(f"  ({part}) {out['seconds'][part]:.2f} s: "
                  + json.dumps(out[part]), flush=True)
    finally:
        for proc, *_ in started.values():
            if proc[0].poll() is None:
                proc[0].kill()
                proc[0].wait()
            proc[1].close()
    out["launches"] = no_launches("phase 18")
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["card"] = card_name
    for kind in BENCH_SWEEPS:
        print(f"  serve-bench {kind} sweep: " + "; ".join(
            f"{leg.get('serve_workers', leg.get('acceptors'))}: "
            f"{leg['rps']} req/s, p50 {leg['p50_ms']} ms"
            for leg in out["c"][kind]["legs"]) + f" (card: {card_name})")
    cb = out["c"]["cli_baseline"]
    print(f"  cold CLI simulate of {cb['trace']} {cb['cold_cli_s']} s -> "
          f"warm served p50 {cb['warm_p50_ms']} ms = {cb['speedup_p50']}x; "
          f"native build {out['d']['build_s']} s; kernel launches "
          f"{out['launches']}; {out['seconds']['phase']:.1f} s "
          f"(card: {card_name})", flush=True)
    return out


#: phase 19: the loop length of every probe, and the workloads it
#: correlates at registered width
PROBE_STEPS = 16
PROBED = ("matmul", "elementwise_stream", "flash_attention_pallas")
#: (e): the profiler's busy time over the CUDA-event wall time of the
#: looped 4096^3 matmul, which keeps the card busy
BUSY_OVER_WALL = (0.8, 1.02)


def tuner_leg() -> dict:
    """Phase 19 (a): ``tune()`` on the card."""
    result = tune(device="cuda")
    doc = dataclasses.asdict(result)
    print("  tune: " + json.dumps(doc), flush=True)
    det = result.details
    if det.get("fit_errors") or det.get("wall_time_fallbacks"):
        raise AssertionError(f"tune: {det}")
    if (result.ici_link_bandwidth is None) != (torch.cuda.device_count() < 2):
        raise AssertionError(f"tune: link bandwidth "
                             f"{result.ici_link_bandwidth} on "
                             f"{torch.cuda.device_count()} card(s)")
    tflops, gbps = det["mxu_achieved_tflops"], det["hbm_achieved_gbps"]
    if not 0 < tflops <= 1.05 * PEAK_BF16_FLOPS / 1e12:
        raise AssertionError(f"tune: bf16 {tflops} TFLOP/s")
    if not 0 < gbps <= 1.05 * PEAK_HBM_BYTES / 1e9:
        raise AssertionError(f"tune: HBM {gbps} GB/s")
    return doc


def correlate_leg() -> dict:
    """Phase 19 (b): ``correlate_workload`` on :data:`PROBED`, each with
    an op profile, timed on the device."""
    out = {}
    for name in PROBED:
        module, args = get_workload(name).build(device="cuda")
        prof: dict = {}
        before = fa.launch_count()
        pt = correlate_workload(module, args, name=name,
                                n_steps=PROBE_STEPS, op_profile_out=prof)
        if pt.real_source != "device" or "ops" not in prof:
            raise AssertionError(f"correlate {name}: {pt.real_source}")
        out[name] = {"sim_s": pt.sim_seconds, "real_s": pt.real_seconds,
                     "error_pct": pt.error_pct,
                     "idle_share": prof["idle_share"],
                     "flash_launches": fa.launch_count() - before}
        del module, args
    if out["flash_attention_pallas"]["flash_launches"] < 1:
        raise AssertionError("correlate never launched flash_attention")
    return out


def correlate_ops_leg(work: Path) -> dict:
    """Phase 19 (c): ``correlate-ops matmul_chain`` through the CLI in a
    fresh process, then ``correlate_workload_ops`` on flash here."""
    path = work / "correl_ops.json"
    cli_process(["correlate-ops", "matmul_chain", "--json", str(path)])
    doc = json.loads(path.read_text())["workloads"][0]
    out = {"matmul_chain": {"matched_time_fraction":
                            doc["matched_time_fraction"],
                            "n_matched": doc["n_matched"]}}
    module, args = get_workload("flash_attention_pallas").build(
        device="cuda")
    corr = correlate_workload_ops(module, args,
                                  name="flash_attention_pallas")
    calls = [r for r in corr.rows if r.opcode == "custom-call"]
    out["flash_attention_pallas"] = {
        "matched_time_fraction": corr.matched_time_fraction,
        "n_matched": len(corr.rows),
        "custom_call": calls[0].to_json() if calls else None}
    for name, got in out.items():
        if got["matched_time_fraction"] < 0.5:
            raise AssertionError(f"correlate-ops {name}: {got}")
    if not calls or calls[0].real_ns <= 0:
        raise AssertionError(f"flash: no measured custom-call row: {out}")
    return out


def power_leg(card_name: str) -> dict:
    """Phase 19 (d): ``sample_workload_power`` on ``matmul`` for 3 s."""
    limit = float(card_name.rsplit(",", 1)[1].split()[0])
    module, args = get_workload("matmul").build(device="cuda")
    sample = sample_workload_power(module, args, name="matmul", seconds=3.0)
    if sample is None or not 0 < sample.watts <= 1.05 * limit:
        raise AssertionError(f"power sample {sample} (limit {limit} W)")
    return {"watts": sample.watts, "limit_w": limit}


def busy_leg() -> dict:
    """Phase 19 (e): the looped ``matmul``'s profiler busy time per step
    against its CUDA-event wall time."""
    module, args = get_workload("matmul").build(device="cuda")
    looped = loopify(module, PROBE_STEPS)
    busy = measure_device_time(looped, *args)
    wall = measure_wall_time(looped, *args, iters=3)
    ratio = busy["median_s"] / wall["median_s"]
    lo, hi = BUSY_OVER_WALL
    if not lo <= ratio <= hi:
        raise AssertionError(f"busy / wall = {ratio} for {busy}, {wall}")
    return {"busy_ms_per_step": busy["median_s"] / PROBE_STEPS * 1e3,
            "wall_ms_per_step": wall["median_s"] / PROBE_STEPS * 1e3,
            "busy_over_wall": ratio, "idle_share": busy["idle_share"],
            "lost_execs": busy["lost_execs"]}


def live_probes(card_name: str, work: Path) -> dict:
    """Phase 19: (a)-(e) in turn, the kernels' counters set to 0 at the
    start; flash's launches are read at the end."""
    for *_, reset in KERNELS:
        reset()
    out = {"seconds": {}}
    t_phase = time.perf_counter()
    for part, fn in (("a", tuner_leg), ("b", correlate_leg),
                     ("c", lambda: correlate_ops_leg(work)),
                     ("d", lambda: power_leg(card_name)),
                     ("e", busy_leg)):
        t0 = time.perf_counter()
        out[part] = fn()
        out["seconds"][part] = time.perf_counter() - t0
        if part != "a":
            print(f"  ({part}) {out['seconds'][part]:.2f} s: "
                  + json.dumps(out[part]), flush=True)
    out["launches"] = {name: count() for name, _, _, count, _ in KERNELS}
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["card"] = card_name
    for name, pt in out["b"].items():
        print(f"  correlate {name}: sim {pt['sim_s'] * 1e3:.4f} ms/step, "
              f"real {pt['real_s'] * 1e3:.4f} ms/step (device), error "
              f"{pt['error_pct']:+.1f}%, idle share {pt['idle_share']:.3f} "
              f"(card: {card_name})", flush=True)
    print(f"  kernel launches {out['launches']}; "
          f"{out['seconds']['phase']:.1f} s (card: {card_name})", flush=True)
    return out


#: phase 20: the multi-device workloads run one rank a process, each at its
#: registered width (``ici_allreduce`` over 2 ranks: its world is a build
#: override)
RANKED = ("llama_tiny_tp2dp2", "moe_ep4", "ulysses_attention_sp8",
          "ring_attention_sp8", "decode_step_tp8", "ici_allreduce")
RANKED_SETS = {"ici_allreduce": {"world": 2}}
#: phase 20: launches snapshotted (the llama step's second launch starts
#: from the first's parameters)
RANKED_LAUNCHES = {"llama_tiny_tp2dp2": 2}
#: phase 20: seconds a group's ranks have to start and to answer a call
#: (a hung rank is killed then, inside the script's limit)
RANK_TIMEOUT_S = 300
#: phase 20: the collective probe's block a rank, float32 and bf16
PROBE_BLOCK = (1024, 1024)


class CollectiveProbe(SpmdModule):
    """Phase 20: every collective over ``axis`` of ``mesh`` on a
    block a rank (``x`` float32, ``h`` bfloat16), in one program:
    ``psum`` of each, ``pmax``, ``all_gather``, ``psum_scatter``,
    ``all_to_all``, ``ppermute`` with position 0 no pair's target, and
    ``axis_index``."""

    def __init__(self, mesh: Mesh, axis):
        super().__init__()
        self.mesh, self.axis = mesh, axis
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        rest = tuple(n for n in mesh.names if n not in names)
        every, rep = P(mesh.names), P(rest or None)
        self.in_specs = (every, every)
        self.out_specs = (rep, rep, rep, rep, every, every, every, every)

    def forward(self, x, h):
        m, a = self.mesh, self.axis
        g = math.prod(m.shape[i] for i in m.axes(a))
        return (spmd.psum(x, m, a), spmd.psum(h, m, a), spmd.pmax(x, m, a),
                spmd.all_gather(h, m, a, 1), spmd.psum_scatter(x, m, a, 0),
                spmd.all_to_all(h, m, a, 0, 1),
                spmd.ppermute(h, m, a, [(j, j + 1) for j in range(g - 1)]),
                spmd.axis_index(x, m, a).reshape(1))


#: phase 20: which of the probe's outputs are sums (held by tolerance:
#: float32 within 1e-6, bf16 within one rounding); the rest move data and
#: are held by bits
PROBE_SUMS = {0: 1e-6, 1: 2.0 ** -7, 4: 1e-6}


def probe_collectives(group, mesh: Mesh, axis) -> dict:
    """Phase 20: :class:`CollectiveProbe` on ``group`` against the
    vmap runner on the same global arrays."""
    module = CollectiveProbe(mesh, axis)
    gen = torch.Generator(device="cpu").manual_seed(mesh.size)
    rows = PROBE_BLOCK[0] * mesh.size
    x = torch.randn((rows, PROBE_BLOCK[1]), generator=gen).to("cuda")
    h = torch.randn((rows, PROBE_BLOCK[1]), generator=gen).to(
        "cuda", torch.bfloat16)
    with torch.no_grad():
        got = group.run_module(module, x, h)
        want = module.run(x, h)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"probe {axis}: output {i} {g.shape} "
                                 f"{g.dtype} vs {w.shape} {w.dtype}")
        if i not in PROBE_SUMS:
            if not torch.equal(g, w):
                raise AssertionError(f"probe {axis}: output {i} (data "
                                     f"movement) differs by bits")
            continue
        tol = PROBE_SUMS[i]
        gap = (g.double() - w.double()).abs() / (tol + tol * w.double().abs())
        worst = max(worst, float(gap.max()))
    if worst > 1.0:
        raise AssertionError(f"probe {axis}: sums {worst:.3g} of the "
                             f"tolerance")
    return {"mesh": list(mesh.shape), "axis": axis, "sums_worst_of_tol": worst,
            "moves_equal_bits": len(got) - len(PROBE_SUMS)}


def vmap_launches(module, args, launches: int) -> list[list[torch.Tensor]]:
    """Phase 20: the vmap runner's outputs of each launch on the card (a
    later launch from the updated parameters, as ``snapshot_buffers``
    threads them), on the CPU."""
    outs, cur = [], args
    with torch.no_grad():
        for _ in range(launches):
            out = module.run(*cur)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            outs.append([o.cpu() for o in out])
            cur = (*out[1:], *args[len(out) - 1:])
    return outs


def ranks_held(name: str, snaps: Path, want: list) -> dict:
    """Phase 20: each snapshot of the rank processes against the vmap
    runner's output of the same launch: equal by bits (``exact``), or
    floats within |x - y| <= tol + tol |y| at their dtype; integers by
    bits."""
    worst, err, exact = 0.0, 0.0, 0
    for i, outs in enumerate(want):
        for j, w in enumerate(outs):
            x = np.load(snaps / f"launch{i}_buf{j}.npy")
            y = (w.float() if w.dtype == torch.bfloat16 else w).numpy()
            if x.shape != y.shape or not np.isfinite(x).all():
                raise AssertionError(f"{name}: bad snapshot launch{i}_buf{j} "
                                     f"{x.shape} vs {y.shape}")
            if np.array_equal(x, y):
                exact += 1
                continue
            if not w.is_floating_point():
                raise AssertionError(f"{name}: integer output {j} of "
                                     f"launch {i} differs")
            tol = TOL_LOWERED[w.dtype]
            gap = np.abs(x.astype(np.float64) - y.astype(np.float64))
            err = max(err, float(gap.max(initial=0.0)))
            worst = max(worst, float((gap / (tol + tol * np.abs(y)))
                                     .max(initial=0.0)))
    if worst > 1.0:
        raise AssertionError(f"{name}: the rank processes' outputs differ "
                             f"from the vmap runner's ({worst:.3g} of the "
                             f"tolerance)")
    return {"max_abs_err": err, "worst_of_tol": worst, "exact": exact,
            "buffers": sum(len(o) for o in want)}


def vmap_reference(name: str) -> tuple:
    """Phase 20: a workload built on the card and the vmap runner's
    outputs of its snapshotted launches, with the seconds they took."""
    t0 = time.perf_counter()
    module, args = get_workload(name).build(device="cuda",
                                            **RANKED_SETS.get(name, {}))
    want = vmap_launches(module, args, RANKED_LAUNCHES.get(name, 1))
    torch.cuda.empty_cache()
    return module, args, want, time.perf_counter() - t0


def ranked_workload(name: str, group, work: Path, ref: tuple) -> dict:
    """Phase 20: one workload on ``group`` (None: the route
    ``ranks_for`` takes, one rank a card) against the vmap runner's
    outputs ``ref`` (:func:`vmap_reference`) on the card: snapshots held,
    replicas checked by ``unshard``, the median step of
    ``measure_wall_time``."""
    from tpusim_torch.spmd_procs import runner_text

    module, args, want, vmap_s = ref
    launches = len(want)
    seconds = {"vmap": vmap_s}
    out = work / name
    t0 = time.perf_counter()
    snapshot_buffers(module, *args, out_dir=out, launches=launches,
                     group=group)
    seconds["snapshot"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    held = ranks_held(name, out, want)
    shutil.rmtree(out)
    seconds["held"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wall = measure_wall_time(module, *args, iters=3, warmup=1, group=group)
    seconds["timing"] = time.perf_counter() - t0
    runner = runner_text(module, args[0].device, group)
    del module, args, want
    torch.cuda.empty_cache()
    return {"runner": runner, "launches": launches, "seconds": seconds,
            "vs_vmap": held, "median_ms": wall["median_s"] * 1e3}


#: phase 20: the probes' (group size, mesh, axis)
PROBE_MESHES = ((4, Mesh((2, 2), ("a", "b")), ("b", "a")),
                (4, Mesh((2, 2), ("a", "b")), "a"),
                (8, Mesh((8,), ("d",)), "d"),
                (2, Mesh((2,), ("d",)), "d"))


def _worlds() -> dict:
    """Phase 20: each workload's ranks."""
    return {n: RANKED_SETS.get(n, {}).get("world")
            or get_workload(n).num_devices for n in RANKED}


def shared_card_leg(card_name: str, vmap_ms: dict, work: Path) -> dict:
    """Phase 20 (a): groups of 2, 4 and 8 rank processes with every rank
    on ``cuda:0``, joined over gloo and started at once: the collective
    probes, then each workload against the vmap runner, its median step
    beside phase 12 (e)'s ``vmap_ms``."""
    from tpusim_torch.spmd_procs import RankGroup

    worlds = _worlds()
    groups = {w: RankGroup(["cuda:0"] * w, timeout=RANK_TIMEOUT_S).start()
              for w in sorted(set(worlds.values()))}
    out = {"probes": [], "workloads": {}}
    try:
        # the references while the ranks start
        refs = {name: vmap_reference(name) for name in RANKED}
        for w, mesh, axis in PROBE_MESHES:
            t0 = time.perf_counter()
            out["probes"].append(probe_collectives(groups[w], mesh, axis))
            out["probes"][-1]["seconds"] = time.perf_counter() - t0
        print(f"  (a) collective probes on {groups[8].describe()} and its "
              f"4- and 2-rank peers: " + json.dumps(out["probes"]),
              flush=True)
        for name in RANKED:
            row = ranked_workload(name, groups[worlds[name]], work,
                                  refs.pop(name))
            out["workloads"][name] = row
            print(f"  (a) {name} ({row['runner']}): {row['launches']} "
                  f"launch(es) vs the vmap runner max |err| "
                  f"{row['vs_vmap']['max_abs_err']:.3g} "
                  f"({row['vs_vmap']['worst_of_tol']:.3g} of tol), replicas "
                  f"equal; median step {row['median_ms']:.4f} ms (vmap, "
                  f"phase 12 (e): {vmap_ms.get(name, 'n/a')}) on "
                  f"{card_name}; seconds " + json.dumps(row["seconds"]),
                  flush=True)
    finally:
        for g in groups.values():
            g.close()
    return out


def card_a_rank_leg(card_name: str, tuned: dict | None, work: Path) -> dict:
    """Phase 20 (b): with a card for each rank, the probes over NCCL, each
    workload the route ``ranks_for`` takes (one rank a card) against the
    vmap runner, and ``tune``'s ``ici_link_bandwidth`` (``tuned``: phase
    19 (a)'s result; fitted here when None); on fewer cards, what each
    needs."""
    from tpusim_torch.harness import tuner
    from tpusim_torch.spmd_procs import RankGroup
    from tpusim_torch.timing.arch import detect_arch

    worlds = _worlds()
    cards = torch.cuda.device_count()
    out: dict = {"probes": [], "workloads": {}}
    for w, mesh, axis in PROBE_MESHES:
        if cards >= w:
            with RankGroup([f"cuda:{i}" for i in range(w)],
                           timeout=RANK_TIMEOUT_S) as group:
                out["probes"].append(probe_collectives(group, mesh, axis))
    if out["probes"]:
        print("  (b) collective probes over nccl: "
              + json.dumps(out["probes"]), flush=True)
    for name in RANKED:
        if cards < worlds[name]:
            print(f"  (b) {name}: one rank a card needs {worlds[name]} "
                  f"cards; this host has {cards}")
            continue
        row = ranked_workload(name, None, work, vmap_reference(name))
        out["workloads"][name] = row
        print(f"  (b) {name} ({row['runner']}): max |err| "
              f"{row['vs_vmap']['max_abs_err']:.3g} "
              f"({row['vs_vmap']['worst_of_tol']:.3g} of tol); median step "
              f"{row['median_ms']:.4f} ms on {card_name}; seconds "
              + json.dumps(row["seconds"]), flush=True)
    if cards < 2:
        print(f"  (b) tune ici_link_bandwidth: "
              f"{tuner.ici_runner_text('cuda')}")
        return out
    bw = (tuned or {}).get("ici_link_bandwidth")
    if tuned is None:
        tuner._WALL_FALLBACKS.clear()
        bw = tuner._fit_ici(detect_arch(torch.cuda.get_device_name(0)),
                            device="cuda")
        if tuner._WALL_FALLBACKS:
            raise AssertionError(f"tune: the ICI fit fell back to wall "
                                 f"time: {tuner._WALL_FALLBACKS}")
    if not bw or (tuned or {}).get("details", {}).get(
            "fit_errors", {}).get("ici_link_bandwidth"):
        raise AssertionError(f"tune: no ICI fit on {cards} cards: {tuned}")
    out["ici_link_bandwidth"] = bw
    print(f"  (b) tune ici_link_bandwidth {bw:.6g} B/s "
          f"({tuner.ici_runner_text('cuda')}; {card_name})")
    return out


def ranks_as_processes(card_name: str, vmap_ms: dict, tuned: dict | None,
                       legs: str = "ab") -> dict:
    """Phase 20: :func:`shared_card_leg` (a) and :func:`card_a_rank_leg`
    (b), the kernels' counters set to 0 before and read after (they must
    stay 0); ``legs``: which to run."""
    for *_, reset in KERNELS:
        reset()
    t_phase = time.perf_counter()
    # the rank processes share the card with what this one cached
    torch.cuda.empty_cache()
    out = {"seconds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for leg, fn in (("a", lambda: shared_card_leg(
                            card_name, vmap_ms, Path(tmp))),
                        ("b", lambda: card_a_rank_leg(
                            card_name, tuned, Path(tmp)))):
            if leg in legs:
                t0 = time.perf_counter()
                out[leg] = fn()
                out["seconds"][leg] = time.perf_counter() - t0
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    if any(launches.values()):
        raise AssertionError(f"phase 20 launched a custom kernel: {launches}")
    out["launches"] = launches
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["card"] = card_name
    print(f"  kernel launches across phase 20: {launches}; "
          f"{out['seconds']['phase']:.1f} s (card: {card_name})", flush=True)
    return out


def ranks_alone(legs: str = "ab") -> int:
    """Phase 20 alone on this host's cards (its leg (b) needs a card a
    rank): ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.
    ranks_alone('b'))"``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card_name = card()
    print(f"card: {card_name}; {torch.cuda.device_count()} cards; torch "
          f"{torch.__version__}")
    out = ranks_as_processes(card_name, {}, None, legs=legs)
    print("ranks: " + json.dumps(out))
    return 0


#: phase 21: the decoder's attention at each benchmark cell's shape:
#: (label, (batch, seq, heads, kv heads, head dim))
CAUSAL_SHAPES = (
    ("mistral7b.prefill_2k", (2, 2048, 32, 8, 128)),
    ("deepseek7b.prefill_2k", (2, 2048, 32, 32, 128)),
    ("mistral7b.prefill_4k", (1, 4096, 32, 8, 128)),
    ("mistral7b.prefill_256", (16, 256, 32, 8, 128)),
)
#: phase 21: the kernel's edges at head dim 128 in bf16, held to the plain
#: version: one row, sequences of no whole 128-key tile or query block
#: (130, 200, 333), rep 4, 2 and 1, rows wider than their heads by 16
#: bytes; (shape, strided)
CAUSAL_EDGES = (
    ((1, 1, 4, 1, 128), False),
    ((1, 130, 4, 2, 128), False),
    ((2, 200, 8, 2, 128), True),
    ((1, 333, 4, 4, 128), False),
)
#: phase 21 (b): host calls of the wrapper a reading of its host cost
HOST_CALLS = 50
#: phase 21: the configurations whose forward step is counted: the
#: benchmark's two (Mistral-7B-v0.1 and DeepSeek-LLM-7B-base
#: ``config.json``, the output tied to the embedding as the port has it)
#: at a cell's shape each, and the registered ``llama_tiny`` (head dim 32,
#: outside the kernel's domain: the score chain, no launch) and
#: ``llama7b``: (label, config fields, batch, seq)
CAUSAL_CONFIGS = (
    ("mistral7b", dict(vocab=32000, dim=4096, layers=32, heads=32,
                       kv_heads=8, ffn=14336, max_seq=4096, eps=1e-5),
     (2, 2048)),
    ("deepseek7b", dict(vocab=102400, dim=4096, layers=30, heads=32,
                        kv_heads=32, ffn=11008, max_seq=4096, eps=1e-6),
     (2, 2048)),
    ("llama_tiny", "tiny", (4, 256)),
    ("llama7b", "7b", (1, 2048)),
)
#: phase 21: sha256 of the HLO text the commit before the causal kernel
#: captured for ``llama_tiny`` (on the CPU) and ``llama7b`` (over meta
#: tensors): the lowering reads only shapes, and a capture traces over fake
#: tensors, so the decoder's graph is the score chain on every device
CAUSAL_HLO_DIGESTS = {
    "llama_tiny": "8cfb07e57d021ce60f5b4e08ed2e36210ad2fec7ee2e8ef05ad90cd709f1939b",
    "llama7b": "432582491b0dd2b3014469cc843cd0af735f00c4746d39752d1ee600a282a6f5",
}
#: phase 21: the non-causal kernel's table figures at its registered shape
#: (PERF.md's kernel table, one NVIDIA H100 80GB HBM3 at 700 W): a reading
#: more than :data:`FLASH_TABLE_TOL` outside is reported as such, not
#: failed, since the same build reads several percent apart from machine
#: to machine; a regression of that kernel is told by timing it against
#: the earlier build in one call
FLASH_TABLE_MS = {"float32": (0.2945, 0.3005), "bfloat16": (0.0725, 0.0725)}
FLASH_TABLE_TOL = 0.03
#: phase 21: the worst row of a forward's logits, kernel path against the
#: score chain on the card, may differ by at most the benchmark's limit on
#: ``logit_row_err`` (both are bf16 evaluations; each is held to a float32
#: reference by the benchmark)
CAUSAL_STEP_ROW_ERR = 0.5


def causal_inputs(shape, dtype, seed: int, strided: bool = False):
    """Seeded q [B, S, H, D] and k, v [B, S, KVH, D] on the card;
    ``strided``: each a view of rows 8 elements wider than its heads."""
    b, s, h, kvh, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pad = 8 if strided else 0

    def draw(heads):
        rows = torch.randn(b, s, heads * d + pad, generator=gen,
                           device="cuda", dtype=dtype)
        return rows[..., :heads * d].view(b, s, heads, d)

    return draw(h), draw(kvh), draw(kvh)


def causal_flops(shape) -> float:
    """Operations of causal attention over the lower triangle with its
    diagonal: QK^T and PV, 2 x 2 x D a kept score."""
    b, s, h, _, d = shape
    return 2.0 * b * h * s * (s + 1) * d


def check_causal(shape, strided: bool = False) -> float:
    """The causal kernel against its plain version on the card in bf16;
    returns the max abs error.  Raises on a disagreement."""
    q, k, v = causal_inputs(shape, torch.bfloat16, seed=5, strided=strided)
    got = fa._cuda_causal(q, k, v, 1.0 / math.sqrt(shape[-1]))
    want = fa.causal_attention_reference(q, k, v)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= TOL_BF16 + TOL_BF16 * want.float().abs()).all())
    ok = ok and bool(torch.isfinite(got.float()).all())
    print(f"  causal {list(shape)} bf16{' strided' if strided else ''}: max "
          f"|kernel - plain| {err:.3e} (atol {TOL_BF16} + rtol {TOL_BF16}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"causal kernel disagrees at {shape}")
    return err


def refused(label: str, bad, want) -> None:
    """The causal wrapper refuses each of ``bad`` (q, k, v on the card)
    before a launch, raising ``want``."""
    before = fa.causal_launch_count()
    for q, k, v in bad:
        try:
            fa.causal_attention_fwd(q, k, v)
        except want as e:
            print(f"  {label} refused: {e}")
        else:
            raise AssertionError(f"the causal wrapper took {label} "
                                 f"{tuple(q.shape)} {q.dtype}")
    if fa.causal_launch_count() != before:
        raise AssertionError(f"a refused {label} call launched")


def host_us(fn) -> float:
    """Host microseconds a call of ``fn``: :data:`HOST_CALLS` calls after
    a warm one, timed before the card is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def time_kernel(q, k, v, scale) -> dict:
    """The causal kernel at q, k, v: ``ms`` on the card, ``host_us`` its
    host cost a call."""
    return {"ms": time_ms(lambda: fa._cuda_causal(q, k, v, scale)),
            "host_us": host_us(lambda: fa._cuda_causal(q, k, v, scale))}


def time_causal(label: str, shape, card_name: str) -> dict:
    """The causal kernel, its plain version, the decoders' score chain it
    replaced and PyTorch's SDPA (a yardstick the port never calls) at one
    shape in bf16, with the card's bound."""
    from tpusim_torch.models import blocks

    b, s, h, kvh, d = shape
    q, k, v = causal_inputs(shape, torch.bfloat16, seed=6)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = {
        **time_kernel(q, k, v, 1.0 / math.sqrt(d)),
        "plain_ms": time_ms(lambda: fa.causal_attention_reference(q, k, v)),
        "chain_ms": time_ms(lambda: blocks.score_chain(q, k, v)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
    }
    flops = causal_flops(shape)
    nbytes = 2 * b * s * (h + kvh) * d * 2
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    out["bound_ms"] = max(ops_ms, bytes_ms)
    out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    out["tflops"] = flops / out["ms"] / 1e9
    print(f"time causal {label} {list(shape)} bf16: kernel "
          f"{out['ms']:.4f} ms ({out['tflops']:.1f} TFLOP/s, "
          f"{out['bound_ms'] / out['ms']:.1%} of the bound "
          f"{out['bound_ms']:.4f} ms by {out['bound_by']}; host "
          f"{out['host_us']:.1f} us a call), plain {out['plain_ms']:.4f} ms, "
          f"score chain {out['chain_ms']:.4f} ms, library SDPA "
          f"{out['library_ms']:.4f} ms; median of {SAMPLES} x {REPS} "
          f"back-to-back calls (card: {card_name})", flush=True)
    return out


def causal_steps(card_name: str) -> dict:
    """One forward step of each of :data:`CAUSAL_CONFIGS` on the card: the
    causal kernel launched once a layer where the kernel takes the layer's
    attention, else never; the logits against the score chain's
    (``_Decoder.logits`` without ``forward_only``), within
    :data:`CAUSAL_STEP_ROW_ERR` of them, or equal to them where no launch
    is made; and each path's step time (host clock over 5 synchronised
    steps after 2)."""
    from tpusim_torch.models import llama as port_llama

    out = {}
    for label, fields, (batch, seq) in CAUSAL_CONFIGS:
        cfg = (port_llama.PRESETS[fields] if isinstance(fields, str)
               else port_llama.LlamaConfig(**fields))
        params = port_llama.init_params(cfg, "cuda", seed=7)
        gen = torch.Generator(device="cuda").manual_seed(8)
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                               device="cuda", dtype=torch.int32)
        module = port_llama.LlamaForward(cfg)
        chain = port_llama._Decoder(cfg, None)
        takes = (cfg.head_dim,) * 2 in fa.WGMMA_HEAD_DIMS
        with torch.no_grad():
            fa.reset_causal_launch_count()
            got = module(*params, tokens)
            torch.cuda.synchronize()
            launches = fa.causal_launch_count()
            want, _ = chain.logits(params, tokens)
            if launches != (cfg.layers if takes else 0) \
                    or fa.causal_launch_count() != launches:
                raise AssertionError(
                    f"{label}: {launches} causal launches for "
                    f"{cfg.layers} layers at head dim {cfg.head_dim}")
            g, w = got.float(), want.float()
            row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
            if not row <= CAUSAL_STEP_ROW_ERR:
                raise AssertionError(f"{label}: kernel vs chain row {row}")
            if not takes and not torch.equal(got, want):
                raise AssertionError(f"{label}: the forward is not the "
                                     f"chain's (row {row})")
            del got, want, g, w
            ms = {}
            for path, fn in (("kernel", lambda: module(*params, tokens)),
                             ("chain", lambda: chain.logits(params, tokens))):
                torch.cuda.reset_peak_memory_stats()
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                ms[path] = (time.perf_counter() - t0) / 5 * 1e3
                ms[f"{path}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[label] = {"layers": cfg.layers, "launches": launches,
                      "row_err_vs_chain": row, **ms}
        print(f"  step {label} [{batch}, {seq}]: {launches} causal launches "
              f"({cfg.layers} layers at head dim {cfg.head_dim}); worst "
              f"logit row forward vs chain "
              f"{row:.4f}; step {ms['kernel']:.2f} ms (chain "
              f"{ms['chain']:.2f} ms), peak {ms['kernel_peak_gib']:.2f} GiB "
              f"(chain {ms['chain_peak_gib']:.2f}) (card: {card_name})",
              flush=True)
        del params, module, chain
        torch.cuda.empty_cache()
    return out


#: phase 21 (c): the sharded forward whose ranks each run the causal kernel
#: at ``heads / tp`` query and ``kv_heads / tp`` key/value heads:
#: ``llama_tiny`` widened to 4 heads of 128 in bf16 (the kernel's domain)
#: on a ``(dp, tp)`` mesh of 1 x 2, two rank processes sharing the card
#: over gloo
CAUSAL_SHARDED = dict(preset="tiny", batch=4, dp=1, tp=2, dim=512,
                      dtype="bfloat16")


def causal_sharded(card_name: str) -> dict:
    """One no-grad forward of ``LlamaForwardSharded`` with a rank process
    a rank: the causal kernel launched once a layer on every rank, and the
    reassembled logits against the single-card score chain's."""
    from tpusim_torch.models import llama as port_llama
    from tpusim_torch.spmd import unshard
    from tpusim_torch.spmd_procs import RankGroup, _run_task

    module, args = port_llama.build_llama(device="cuda", train=False,
                                          **CAUSAL_SHARDED)
    cfg, mesh = module.cfg, module.mesh
    torch.cuda.empty_cache()
    with RankGroup(["cuda:0"] * mesh.size, timeout=RANK_TIMEOUT_S) as group:
        group.call(_run_task, [(fa.reset_causal_launch_count, (), False)]
                   * group.world)
        with torch.no_grad():
            got = group.run_module(module, *args)
        launches = [int(n) for n in group.call(
            _run_task, [(fa.causal_launch_count, (), False)] * group.world)]
        ranks = group.describe()
    with torch.no_grad():
        want, _ = port_llama._Decoder(cfg, None).logits(args[:-1], args[-1])
    g, w = got.float(), want.float()
    row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
    print(f"  sharded step llama_tiny (dim {cfg.dim}, {cfg.heads} heads of "
          f"{cfg.head_dim}) dp {mesh.shape[0]} x tp {mesh.shape[1]} "
          f"on {ranks}: causal launches by rank {launches} ({cfg.layers} "
          f"layers); worst logit row against the chain {row:.4f} (card: "
          f"{card_name})", flush=True)
    if launches != [cfg.layers] * mesh.size:
        raise AssertionError(f"sharded step: causal launches {launches} for "
                             f"{cfg.layers} layers a rank")
    if not row <= CAUSAL_STEP_ROW_ERR:
        raise AssertionError(f"sharded step: kernel vs chain row {row}")
    return {"mesh": list(mesh.shape), "layers": cfg.layers,
            "launches": launches, "row_err_vs_chain": row}


def causal_hlo(card_name: str) -> dict:
    """``llama_tiny`` and ``llama7b`` captured over CUDA arguments and over
    meta tensors, each text equal by bytes to the other and to the parent
    commit's (:data:`CAUSAL_HLO_DIGESTS`); the kernel never launches."""
    import hashlib

    fa.reset_causal_launch_count()
    out = {}
    for name, want in CAUSAL_HLO_DIGESTS.items():
        got = {}
        for dev in ("cuda", "meta"):
            module, args = get_workload(name).build(device=dev)
            text, _ = export_to_hlo(module, args, name)
            got[dev] = hashlib.sha256(text.encode()).hexdigest()
            del module, args
        torch.cuda.empty_cache()
        if got["cuda"] != got["meta"] or got["cuda"] != want:
            raise AssertionError(f"{name}: HLO digests {got}, parent {want}")
        out[name] = got["cuda"]
        print(f"  capture {name}: HLO sha256 {got['cuda'][:16]} on the card "
              f"== over meta == the parent's (card: {card_name})")
    if fa.causal_launch_count():
        raise AssertionError("a capture launched the causal kernel")
    return out


def flash_against_table(card_name: str) -> dict:
    """The non-causal kernel at its registered shape beside
    :data:`FLASH_TABLE_MS`: each reading, and whether it lies within
    :data:`FLASH_TABLE_TOL` of the table."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        ms = time_attention(dtype, card_name)["ms"]
        lo, hi = FLASH_TABLE_MS[name]
        within = lo * (1 - FLASH_TABLE_TOL) <= ms <= hi * (1 + FLASH_TABLE_TOL)
        print(f"  flash {name}: {ms:.4f} ms against the table's "
              f"{lo}-{hi} ms ({'within' if within else 'OUTSIDE'} "
              f"{FLASH_TABLE_TOL:.0%}; a reading, not a check)")
        out[name] = {"ms": ms, "table_ms": [lo, hi], "within": within}
    return out


def causal_attention_phase(card_name: str) -> dict:
    """Phase 21: the causal kernel and the decoder's route to it."""
    t_phase = time.perf_counter()
    out = {"card": card_name}
    out["errors"] = {label: check_causal(shape)
                     for label, shape in CAUSAL_SHAPES}
    out["edges"] = [check_causal(shape, strided)
                    for shape, strided in CAUSAL_EDGES]
    q, k, v = causal_inputs((1, 16, 4, 2, 128), torch.bfloat16, seed=9)
    refused("float32", [(q.float(), k.float(), v.float())], TypeError)
    narrow = causal_inputs((1, 16, 4, 2, 64), torch.bfloat16, seed=9)
    # rows 4 elements (8 bytes) wider than their heads: no whole 16-byte
    # chunk for TMA
    wide = tuple(torch.zeros(1, 16, n * 128 + 4, dtype=torch.bfloat16,
                             device="cuda")[..., :n * 128].view(1, 16, n, 128)
                 for n in (4, 2, 2))
    refused("head dim or layout", [
        narrow, (q, k[:, :, :1].expand(-1, -1, 3, -1), v),
        (q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v), wide],
        ValueError)
    out["times"] = {label: time_causal(label, shape, card_name)
                    for label, shape in CAUSAL_SHAPES}
    out["steps"] = causal_steps(card_name)
    out["sharded"] = causal_sharded(card_name)
    out["hlo"] = causal_hlo(card_name)
    out["flash"] = flash_against_table(card_name)
    out["seconds"] = time.perf_counter() - t_phase
    return out


#: phase 22: DeepSeek-V2's latent attention (q.k over 192 dims, values over
#: 128, scale 192^-0.5 * m^2) at the benchmark cell's shape and at a short
#: and an odd length: (label, (batch, seq, heads, q/k head dim, v head dim))
MLA_SHAPES = (
    ("dsv2lite.prefill_16k", (1, 16384, 16, 192, 128)),
    ("short", (2, 256, 16, 192, 128)),
    ("odd", (1, 333, 16, 192, 128)),
)
#: phase 22: the edges at two head dims in bf16, held to the plain version:
#: one row, and sequences of no whole 128-key tile (130, 200) besides the
#: odd shape's 333
MLA_EDGES = (
    ("one_row", (1, 1, 16, 192, 128)),
    ("rows_130", (1, 130, 16, 192, 128)),
    ("rows_200", (2, 200, 16, 192, 128)),
)
#: phase 22 (c): the forward step counted: DeepSeek-V2-Lite at published
#: widths and full depth, one sequence of this many tokens
MLA_STEP_SEQ = 2048


def mla_scale() -> float:
    from tpusim_torch.models import deepseek_v2

    return deepseek_v2.softmax_scale(deepseek_v2.PRESETS["lite"])


def mla_inputs(shape, dtype, seed: int):
    """Seeded q [B, S, H, DQK], k [B, S, H, DQK] and v [B, S, H, DV] on
    the card, v read in place as the model reads it: the second half of
    each head's [keys, values] row of the latent's up-projection."""
    b, s, h, dqk, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*size):
        return torch.randn(*size, generator=gen, device="cuda", dtype=dtype)

    kv = draw(b, s, h, 128 + dv)
    return draw(b, s, h, dqk), draw(b, s, h, dqk), kv[..., 128:]


def mla_flops(shape) -> float:
    """Operations of causal attention over the lower triangle with its
    diagonal: 2 DQK for a score's QK^T and 2 DV for its PV."""
    b, s, h, dqk, dv = shape
    return float(b * h * s * (s + 1) * (dqk + dv))


def check_mla(shape) -> float:
    """The causal kernel at two head dims against its plain version on the
    card in bf16; returns the max abs error.  Raises on a disagreement."""
    q, k, v = mla_inputs(shape, torch.bfloat16, seed=11)
    scale = mla_scale()
    got = fa._cuda_causal(q, k, v, scale)
    want = fa.causal_attention_reference(q, k, v, scale)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= TOL_BF16 + TOL_BF16 * want.float().abs()).all())
    ok = ok and bool(torch.isfinite(got.float()).all()) and \
        got.shape == (*shape[:3], shape[4])
    print(f"  mla {list(shape)} bf16: max |kernel - plain| {err:.3e} (atol "
          f"{TOL_BF16} + rtol {TOL_BF16}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"latent attention disagrees at {shape}")
    del q, k, v, got, want, diff
    torch.cuda.empty_cache()
    return err


def time_mla(label: str, shape, card_name: str) -> dict:
    """The causal kernel at two head dims, its plain version and PyTorch's
    SDPA (a yardstick the port never calls) at one shape in bf16, with the
    card's bound."""
    b, s, h, dqk, dv = shape
    q, k, v = mla_inputs(shape, torch.bfloat16, seed=12)
    scale = mla_scale()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = {**time_kernel(q, k, v, scale),
           "plain_ms": time_ms(
               lambda: fa.causal_attention_reference(q, k, v, scale))}
    torch.cuda.empty_cache()
    out["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale))
    flops = mla_flops(shape)
    nbytes = b * s * h * 2 * (dqk + dv) * 2
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    out["bound_ms"] = max(ops_ms, bytes_ms)
    out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    out["tflops"] = flops / out["ms"] / 1e9
    print(f"time mla {label} {list(shape)} bf16: kernel "
          f"{out['ms']:.4f} ms ({out['tflops']:.1f} TFLOP/s, "
          f"{out['bound_ms'] / out['ms']:.1%} of the bound "
          f"{out['bound_ms']:.4f} ms by {out['bound_by']}; host "
          f"{out['host_us']:.1f} us a call), plain {out['plain_ms']:.4f} ms, "
          f"library SDPA {out['library_ms']:.4f} ms; median of {SAMPLES} x "
          f"{REPS} back-to-back calls (card: {card_name})", flush=True)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def mla_step(card_name: str, name: str = "deepseek_v2_lite",
             seq: int = MLA_STEP_SEQ) -> dict:
    """One forward of ``name`` at ``seq`` tokens: the causal kernel
    launched once a layer where the kernel takes the latent attention's
    head dims, else never; the expert layers' balance; and the logits
    against the score chain's (the same forward with a gradient recorded,
    which keeps the chain), within :data:`CAUSAL_STEP_ROW_ERR` of them,
    or equal to them where no launch is made."""
    from tpusim_torch.models import get_workload

    module, args = get_workload(name).build(device="cuda", seq=seq)
    cfg = module.cfg
    layers = cfg.layers
    takes = (cfg.qk_head_dim, cfg.v_head_dim) in fa.WGMMA_HEAD_DIMS
    with torch.no_grad():
        fa.reset_causal_launch_count()
        got = module(*args)
        torch.cuda.synchronize()
        launches = fa.causal_launch_count()
    balance = list(module.busiest_over_mean)
    with torch.enable_grad():
        want = module(*args)
    if launches != (layers if takes else 0) \
            or fa.causal_launch_count() != launches:
        raise AssertionError(f"{name}: {launches} causal launches for "
                             f"{layers} layers at head dims "
                             f"{cfg.qk_head_dim} / {cfg.v_head_dim}")
    g, w = got.float(), want.detach().float()
    row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
    print(f"  step {name} [1, {seq}]: {launches} causal launches ({layers} "
          f"layers at head dims {cfg.qk_head_dim} / {cfg.v_head_dim}); worst "
          f"logit row forward vs chain {row:.4f}; busiest expert over the "
          f"mean by layer {[round(x, 3) for x in balance]} (card: "
          f"{card_name})", flush=True)
    if not row <= CAUSAL_STEP_ROW_ERR:
        raise AssertionError(f"{name}: kernel vs chain row {row}")
    if not takes and not torch.equal(got, want.detach()):
        raise AssertionError(f"{name}: the forward is not the chain's "
                             f"(row {row})")
    del module, args, got, want, g, w
    torch.cuda.empty_cache()
    return {"layers": layers, "launches": launches,
            "row_err_vs_chain": row, "busiest_over_mean": balance}


def mla_attention_phase(card_name: str) -> dict:
    """Phase 22: the causal kernel at two head dims, DeepSeek-V2's latent
    attention, beside the kernels the Llama cells run."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"card": card_name, "scale": mla_scale()}
    out["errors"] = {label: check_mla(shape) for label, shape in MLA_SHAPES}
    out["edges"] = {label: check_mla(shape) for label, shape in MLA_EDGES}
    q, k, v = mla_inputs((1, 16, 2, 224, 128), torch.bfloat16, seed=13)
    refused("float32", [tuple(x[..., :192].float() for x in (q, k))
                        + (v.float(),)], TypeError)
    refused("head dims", [(q, k, v), (q[..., :160], k[..., :160], v),
                          (q[..., :160], k[..., :160], v[:, :, :1])],
            ValueError)
    out["times"] = {label: time_mla(label, shape, card_name)
                    for label, shape in MLA_SHAPES}
    out["beside"] = {
        "causal_hd128": time_causal("mistral7b.prefill_4k",
                                    dict(CAUSAL_SHAPES)["mistral7b.prefill_4k"],
                                    card_name),
        "flash_bf16": time_attention(torch.bfloat16, card_name),
    }
    out["step"] = mla_step(card_name)
    out["tiny_step"] = mla_step(card_name, "deepseek_v2_tiny", 64)
    out["seconds"] = time.perf_counter() - t_phase
    return out


#: phase 23: the RMSNorm kernel held to the decoders' chain (atol = rtol
#: :data:`TOL_BF16`) at their shapes and edges: (label, x's shape, the
#: elements between two rows, eps)
NORM_CHECKS = (
    ("mistral7b.prefill_2k", (2, 2048, 4096), 4096, 1e-5),
    ("mistral7b.prefill_256", (16, 256, 4096), 4096, 1e-5),
    ("deepseek7b.prefill_2k", (2, 2048, 4096), 4096, 1e-6),
    ("dsv2lite_hidden", (1, 16384, 2048), 2048, 1e-6),
    ("dsv2lite_latent", (1, 16384, 512), 576, 1e-6),
    ("one_row", (1, 1, 4096), 4096, 1e-5),
    ("rows_333", (1, 333, 4096), 4096, 1e-6),
    ("rows_333_latent", (1, 333, 512), 576, 1e-5),
)
#: phase 23 (b): the shapes of the cells' steps, timed: every Llama cell's
#: 4096 tokens of 4096, DeepSeek-V2-Lite's 16,384 of 2048 and its latent's
#: 16,384 of 512 read from rows 576 apart: (label, x's shape, row)
NORM_TIMED = (
    ("llama_4096x4096", (4096, 4096), 4096),
    ("dsv2lite_16384x2048", (16384, 2048), 2048),
    ("dsv2lite_latent_16384x512", (16384, 512), 576),
)
#: phase 23 (b): bytes of inputs a timing cycles through, so that no launch
#: finds its rows in the 50 MB L2
NORM_COLD_BYTES = 256 << 20
#: phase 23 (b): cycles the card sleeps before a timed sample, so that the
#: host has queued all :data:`REPS` calls before the first runs (about 2 ms:
#: the wrapper's host cost, some 25 us a call, would otherwise pace the
#: shorter shapes)
NORM_SLEEP_CYCLES = 4_000_000
#: phase 23 (c): the forwards counted, one launch a norm: the benchmark's
#: two Llama configurations (:data:`CAUSAL_CONFIGS`) and the registered
#: ``llama7b``, ``llama_tiny`` (dim 128 in bf16: inside the domain),
#: ``deepseek_v2_lite`` and ``deepseek_v2_tiny``, each over this many tokens
NORM_STEP_SEQ = 512


def norm_inputs(shape, row: int, seed: int):
    """Seeded x (``shape``, its rows ``row`` elements apart) and w near 1 on
    the card, in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full = torch.randn((*shape[:-1], row), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
         ).to(torch.bfloat16)
    return full[..., :shape[-1]], w


def check_norm(label: str, shape, row: int, eps: float) -> dict:
    """The RMSNorm kernel against the chain on the card: the max abs error
    and the share of elements equal to the bit.  Raises on a
    disagreement."""
    x, w = norm_inputs(shape, row, seed=21)
    before = rn.launch_count()
    got = rn.rms_norm_fwd(x, w, eps)
    want = rn.rms_norm_reference(x, w, eps)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    equal = (got == want).float().mean().item()
    ok = bool((diff <= TOL_BF16 + TOL_BF16 * want.float().abs()).all())
    ok = ok and bool(torch.isfinite(got.float()).all()) \
        and rn.launch_count() == before + 1 and got.is_contiguous()
    print(f"  norm {label} {list(shape)} rows {row} apart eps {eps}: max "
          f"|kernel - chain| {err:.3e} (atol {TOL_BF16} + rtol {TOL_BF16}), "
          f"{equal:.4%} of the elements equal {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"RMSNorm kernel disagrees at {label}")
    return {"max_abs_err": err, "equal_share": equal}


def norm_refused() -> None:
    """What the wrapper refuses, each before a launch: float32, a base off
    a 16-byte boundary, rows apart by no multiple of 8 elements, a width
    that is no multiple of 8; and the two layouts through the decoders'
    route (``blocks._rmsnorm``, no gradient), which takes them to the
    kernel, where they raise."""
    from tpusim_torch.models import blocks

    x, w = norm_inputs((4, 256), 256, seed=22)
    wide = torch.zeros(4, 264, dtype=torch.bfloat16, device="cuda")
    bad = [("float32", x.float(), w.float(), TypeError),
           ("misaligned", wide[:, 4:260], w, ValueError),
           ("row stride 260", torch.zeros(4, 260, dtype=torch.bfloat16,
                                          device="cuda")[:, :256], w,
            ValueError),
           ("width 252", x[:, :252], w[:252], ValueError)]
    before = rn.launch_count()
    for label, bx, bw, want in bad:
        try:
            rn.rms_norm_fwd(bx, bw, 1e-5)
        except want as e:
            print(f"  norm {label} refused: {e}")
        else:
            raise AssertionError(f"the RMSNorm wrapper took {label}")
    for label, bx, bw, want in bad[1:3]:
        try:
            with torch.no_grad():
                blocks._rmsnorm(bx, bw, 1e-5)
        except want:
            print(f"  norm {label} through the decoders' route raised")
        else:
            raise AssertionError(f"the decoders' route took {label}")
    if rn.launch_count() != before:
        raise AssertionError("a refused RMSNorm call launched")


def queued_ms(fn) -> float:
    """Device milliseconds a call of ``fn``: the median over
    :data:`SAMPLES` CUDA-event times of :data:`REPS` back-to-back calls,
    queued behind a sleep on the card (:data:`NORM_SLEEP_CYCLES`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(NORM_SLEEP_CYCLES)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def time_norm(label: str, shape, row: int, card_name: str) -> dict:
    """The RMSNorm kernel, the chain it replaced and PyTorch's fused
    ``rms_norm`` (a yardstick the port never calls) at one shape in bf16,
    each cycling through inputs that L2 cannot hold (:func:`queued_ms`),
    with the card's bound: one read and one write of each element; and
    the host's cost a call (:func:`host_us`, untraced) of the wrapper, of
    the decoders' route to it (``blocks._rmsnorm`` with no gradient: the
    predicate, the op's dispatch and the wrapper) and of the chain."""
    import itertools

    from tpusim_torch.models import blocks

    rows, dim = shape
    n = max(2, -(-NORM_COLD_BYTES // (rows * row * 2)))
    ins = [norm_inputs(shape, row, seed=23 + i) for i in range(n)]
    w = ins[0][1]
    cyc = itertools.cycle([x for x, _ in ins])
    out = {"ms": queued_ms(lambda: rn.rms_norm_fwd(next(cyc), w, 1e-6)),
           "host_us": host_us(lambda: rn.rms_norm_fwd(ins[0][0], w, 1e-6)),
           "chain_host_us": host_us(
               lambda: rn.rms_norm_reference(ins[0][0], w, 1e-6)),
           "chain_ms": queued_ms(
               lambda: rn.rms_norm_reference(next(cyc), w, 1e-6)),
           "library_ms": queued_ms(lambda: torch.nn.functional.rms_norm(
               next(cyc), (dim,), w, 1e-6))}
    with torch.no_grad():
        out["route_host_us"] = host_us(
            lambda: blocks._rmsnorm(ins[0][0], w, 1e-6))
    nbytes = 2 * rows * dim * 2 + dim * 2
    out["bound_ms"] = nbytes / PEAK_HBM_BYTES * 1e3
    out["bound_by"] = "bytes"
    out["tb_per_s"] = nbytes / out["ms"] / 1e9
    print(f"time norm {label} {list(shape)} rows {row} apart bf16: kernel "
          f"{out['ms']:.4f} ms ({out['tb_per_s']:.3f} TB/s, "
          f"{out['bound_ms'] / out['ms']:.1%} of the bound "
          f"{out['bound_ms']:.4f} ms by bytes; host {out['host_us']:.1f} us "
          f"a call, {out['route_host_us']:.1f} through the decoders' route),"
          f" chain {out['chain_ms']:.4f} ms (host "
          f"{out['chain_host_us']:.1f} us a call), library "
          f"F.rms_norm {out['library_ms']:.4f} ms; {n} inputs in turn, "
          f"median of {SAMPLES} x {REPS} back-to-back calls queued behind "
          f"a sleep (card: {card_name})", flush=True)
    del ins, cyc
    torch.cuda.empty_cache()
    return out


def norm_steps(card_name: str) -> dict:
    """One no-grad forward of each decoder of :data:`NORM_STEP_SEQ`
    tokens: one kernel launch a norm (2L + 1 in the Llama decoder, 3L + 1
    in DeepSeek-V2's), and the logits against the chains' (the same
    forward with a gradient recorded), within
    :data:`CAUSAL_STEP_ROW_ERR`."""
    from tpusim_torch.models import llama as port_llama

    runs = [(label, fields) for label, fields, _ in CAUSAL_CONFIGS] + [
        ("deepseek_v2_lite", None), ("deepseek_v2_tiny", None)]
    out = {}
    for label, fields in runs:
        if fields is None:
            module, args = get_workload(label).build(device="cuda",
                                                     seq=NORM_STEP_SEQ)
            norms = 3 * module.cfg.layers + 1
        else:
            cfg = (port_llama.PRESETS[fields] if isinstance(fields, str)
                   else port_llama.LlamaConfig(**fields))
            module = port_llama.LlamaForward(cfg)
            gen = torch.Generator(device="cuda").manual_seed(8)
            args = (*port_llama.init_params(cfg, "cuda", seed=7),
                    torch.randint(0, cfg.vocab, (1, NORM_STEP_SEQ),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32))
            norms = 2 * cfg.layers + 1
        with torch.no_grad():
            rn.reset_launch_count()
            got = module(*args)
            torch.cuda.synchronize()
            launches = rn.launch_count()
            with torch.enable_grad():
                want = module(*args).detach()
        if launches != norms or rn.launch_count() != launches:
            raise AssertionError(f"{label}: {launches} RMSNorm launches for "
                                 f"{norms} norms")
        g, w = got.float(), want.float()
        row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
        print(f"  step {label} {list(args[-1].shape)}: {launches} RMSNorm "
              f"launches ({norms} norms); worst logit row against the "
              f"chains {row:.4f} (card: {card_name})", flush=True)
        if not row <= CAUSAL_STEP_ROW_ERR:
            raise AssertionError(f"{label}: kernel vs chain row {row}")
        out[label] = {"norms": norms, "launches": launches,
                      "row_err_vs_chain": row}
        del module, args, got, want, g, w
        torch.cuda.empty_cache()
    return out


def rms_norm_phase(card_name: str) -> dict:
    """Phase 23: the RMSNorm kernel and the decoders' route to it."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"card": card_name}
    out["errors"] = {label: check_norm(label, shape, row, eps)
                     for label, shape, row, eps in NORM_CHECKS}
    norm_refused()
    out["times"] = {label: time_norm(label, shape, row, card_name)
                    for label, shape, row in NORM_TIMED}
    out["steps"] = norm_steps(card_name)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def norm_alone() -> int:
    """Phases 1, 2 and 23 alone: ``python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.norm_alone())"``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(1, "card")
    card_name = card()
    print(f"card: {card_name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase(2, "build")
    build_kernels()
    phase(23, "the RMSNorm kernel on the decoders' step")
    out = rms_norm_phase(card_name)
    phase(None)
    print("norm: " + json.dumps(out))
    return 0


def mla_alone() -> int:
    """Phases 1, 2 and 22 alone: ``python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.mla_alone())"``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(1, "card")
    card_name = card()
    print(f"card: {card_name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase(2, "build")
    build_kernels()
    phase(22, "the causal kernel at two head dims: DeepSeek-V2's latent "
              "attention")
    out = mla_attention_phase(card_name)
    phase(None)
    print("mla: " + json.dumps(out))
    return 0


def causal_alone() -> int:
    """Phases 1, 2 and 21 alone: ``python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.causal_alone())"``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(1, "card")
    card_name = card()
    print(f"card: {card_name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase(2, "build")
    build_kernels()
    phase(21, "the causal attention kernel on the decoder's step")
    out = causal_attention_phase(card_name)
    phase(None)
    print("causal: " + json.dumps(out))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase(1, "card")
    card_name = card()
    print(f"card: {card_name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    phase(2, "build")
    build_kernels()

    phase(3, "kernel vs plain version")
    errs = check_kernels()
    q, k, v = inputs((2, 200, 64), torch.float32, seed=2)
    try:
        flash_attention(q, k, v, block_q=128)
    except ValueError as e:
        print(f"  [2, 200, 64] block_q 128 raises: {e}")
    else:
        raise AssertionError("a sequence that block_q does not divide ran")
    torch.cuda.synchronize()

    # the card's captures at registered width that seed phases 16 (d) and
    # 17 (c)
    kept_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_kept_")
    kept = Path(kept_dir.name)

    phase(4, "main path: capture -> simulate")
    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    trace = work / "flash_attention_pallas"
    for *_, reset in KERNELS:
        reset()
    t0 = time.perf_counter()
    out = run_cli(["capture", "flash_attention_pallas", str(trace),
                   "--launches", "2", "--snapshot"])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = {name: count() for name, _, _, count, _ in KERNELS}
    print(out.strip())
    print(f"capture: {capture_s:.2f} s; kernel launches {launches}")
    if launches["flash_attention"] < 1:
        raise AssertionError("main path never launched kernel flash_attention")
    snaps = sorted((trace / "checkpoint_files").glob("*.npy"))
    for p in snaps:
        a = np.load(p)
        if a.shape != MAIN_SHAPE or not np.isfinite(a).all():
            raise AssertionError(f"bad snapshot {p.name}: {a.shape}")
    if len(snaps) != 2:
        raise AssertionError(f"expected 2 snapshots, got {len(snaps)}")
    # phase 16 (d) holds the suite runner's capture of this workload to it
    main_hlo = module_text(trace, "flash_attention_pallas")
    for arch in ("v5e", "v5p"):
        text = run_cli(["simulate", str(trace), "--arch", arch])
        if EXIT_SENTINEL not in text:
            raise AssertionError(f"simulate --arch {arch}: no exit sentinel")
        picked = [ln for ln in text.splitlines() if any(
            f"tpusim_{k} =" in ln for k in
            ("sim_cycle", "kernel_launches", "tot_hbm_bytes", "tot_flops")
        )]
        print(f"  simulate --arch {arch}: " + "; ".join(picked))
    keep_traces(work, ("flash_attention_pallas",), kept)
    shutil.rmtree(work, ignore_errors=True)
    simulate_cells(card_name)

    phase(5, "timing")
    f32 = time_attention(torch.float32, card_name)
    bf16 = time_attention(torch.bfloat16, card_name)
    torch.cuda.synchronize()

    phase(6, "pricing fastpath: serial vs vectorized, batched lanes on the card")
    cell_seconds = fastpath_cells(card_name)
    module, engines = batch_module_and_engines()
    batch_launches = batch_on_card(module, engines)
    steps = path_steps(module, engines)
    scan_err = max(check_scan_rows(), check_scan_segments(steps))
    fp_times = time_fastpath(module, engines, steps, card_name)
    scan = fp_times[SCAN_TIMED]
    torch.cuda.synchronize()

    phase(7, "degraded pods on the card's host")
    with tempfile.TemporaryDirectory() as tmp:
        degraded_pods(card_name, Path(tmp))

    phase(8, "durable store on the card's host")
    with tempfile.TemporaryDirectory() as tmp:
        store = durable_store(card_name, Path(tmp))

    phase(9, "compound-fault campaigns and the fleet twin")
    with tempfile.TemporaryDirectory() as tmp:
        fleet = campaign_fleet(card_name, Path(tmp))

    phase(10, "the sharding advisor on the card's host")
    with tempfile.TemporaryDirectory() as tmp:
        advise = advisor(card_name, Path(tmp))
    print("advisor: " + json.dumps(advise))

    phase(11, "the general lowering: ten workloads at registered width")
    with tempfile.TemporaryDirectory() as tmp:
        lowered = lowered_workloads(card_name, Path(tmp))
        keep_traces(Path(tmp), LOWERED, kept)
    print("lowered: " + json.dumps(lowered))

    phase(12, "multi-device capture: seven workloads, all ranks on the card")
    with tempfile.TemporaryDirectory() as tmp:
        multi = multi_device(card_name, Path(tmp))
        keep_traces(Path(tmp), MULTI, kept)
    print("multidevice: " + json.dumps(multi))

    phase(13, "the model suite at registered width")
    with tempfile.TemporaryDirectory() as tmp:
        models = model_suite(card_name, Path(tmp))

    phase(14, "the ubench workloads at registered width, and the analyzer")
    with tempfile.TemporaryDirectory() as tmp:
        ubench = ubench_workloads(card_name, Path(tmp), keep=kept)

    phase(15, "observability and the trace tools on the card's host")
    with tempfile.TemporaryDirectory() as tmp:
        observed = observability(card_name, Path(tmp))

    phase(16, "streaming pricing and the offline harness on the card's host")
    with tempfile.TemporaryDirectory() as tmp:
        harness = streaming_harness(card_name, Path(tmp), kept, main_hlo)

    phase(17, "the serving plane on the card's host")
    with tempfile.TemporaryDirectory() as tmp:
        served = serving_plane(card_name, Path(tmp), kept)

    phase(18, "front tier, shards, bench, native and the power fit on the "
              "card's host")
    with tempfile.TemporaryDirectory() as tmp:
        front = front_shards_bench(card_name, Path(tmp), kept)
    kept_dir.cleanup()

    phase(19, "the live probes on the card")
    with tempfile.TemporaryDirectory() as tmp:
        probes = live_probes(card_name, Path(tmp))

    phase(20, "ranks as processes: over gloo on the card, over NCCL on a "
              "card a rank")
    ranked = ranks_as_processes(
        card_name, {n: f"{r['median_ms']:.4f} ms at {r['world']} ranks"
                    for n, r in multi["workloads"].items()}, probes["a"])

    phase(21, "the causal attention kernel on the decoder's step")
    causal = causal_attention_phase(card_name)
    phase(22, "the causal kernel at two head dims: DeepSeek-V2's latent "
              "attention")
    mla = mla_attention_phase(card_name)
    phase(23, "the RMSNorm kernel on the decoders' step")
    norm = rms_norm_phase(card_name)
    phase(None)
    models["phase_seconds"] = PHASE_SECONDS
    print("models: " + json.dumps(models))
    print("ubench: " + json.dumps(ubench))
    print("obs: " + json.dumps(observed))
    print("harness: " + json.dumps(harness))
    print("serve: " + json.dumps(served))
    print("front: " + json.dumps(front))
    print("probes: " + json.dumps(probes))
    print("ranks: " + json.dumps(ranked))
    print("causal: " + json.dumps(causal))
    print("mla: " + json.dumps(mla))
    print("norm: " + json.dumps(norm))

    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": KERNELS[0][1],
        "replaces": KERNELS[0][2],
        "launches": (launches["flash_attention"]
                     + probes["launches"]["flash_attention"]),
        "max_abs_err": errs[(MAIN_SHAPE, torch.float32)],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "library_fused_ms": f32["library_fused_ms"],
        "bound_split_tf32_ms": f32["bound_split_tf32_ms"],
        "bound_cuda_core_ms": f32["bound_cuda_core_ms"],
        "bf16_max_abs_err": errs[(MAIN_SHAPE, torch.bfloat16)],
        "bf16_ms": bf16["ms"],
        "bf16_plain_ms": bf16["plain_ms"],
        "bf16_bound_ms": bf16["bound_ms"],
        "bf16_bound_by": bf16["bound_by"],
        "bf16_library_ms": bf16["library_ms"],
        "bf16_library_fused_ms": bf16["library_fused_ms"],
    }, {
        "name": "scan_rows",
        "route": "cuda",
        "source": KERNELS[1][1],
        "replaces": KERNELS[1][2],
        "launches": batch_launches["scan_rows"],
        "max_abs_err": scan_err,
        "ms": scan["ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"],
        "library_ms": scan["library_ms"],
        "shape_ops_lanes": [SCAN_TIMED[1], SCAN_TIMED[0]],
        "chain_floor_ms": scan["chain_floor_ms"],
        "dadd_latency": fp_times["dadd"],
        "shapes": {f"{ops}x{lanes}": {
            k: fp_times[(lanes, ops)][k] for k in (
                "ms", "bound_ms", "bound_by", "chain_floor_ms", "library_ms")}
            for lanes in SCAN_LANES for ops in SCAN_OPS},
        "step_launches": {str(lanes): t for lanes, t
                          in fp_times["steps"].items()},
        "host_vectorized_ms": scan["host_vectorized_ms"],
        "library_bytes_equal": scan["library_bytes_equal"],
        "batch_cuda_ms": fp_times["batch_cuda_ms"],
        "batch_vectorized_ms": fp_times["batch_vectorized_ms"],
        "batch_serial_walk_ms": fp_times["serial_walk_ms"],
        "golden_host_s": {f"{g}|{run}": list(v)
                          for (g, run), v in cell_seconds.items()},
        "warm_states_launches": store["c"]["cuda"]["launches"]["scan_rows"],
        "warm_states_lanes_per_launch": [store["c"]["cuda"]["lanes_min"],
                                         store["c"]["cuda"]["lanes_max"]],
        "warm_states_cuda_ms": store["c"]["cuda"]["ms"],
        "warm_states_vectorized_ms": store["c"]["vectorized"]["ms"],
        "store_golden_host_s": {f"{g}|{run}": v for (g, run), v
                                in store["a"]["seconds"].items()},
        "campaign_smokes": fleet["a"],
        "campaign_v5p64_1024": fleet["c"],
        "fleet_8x300s": fleet["d"],
    }, {
        "name": "causal_attention",
        "route": "cuda",
        "source": CAUSAL_SOURCE,
        "replaces": "the score chain of tpusim_torch/models/blocks.py "
                    "score_chain (no TPU kernel)",
        "launches_per_step": {
            **{n: r["launches"] for n, r in causal["steps"].items()},
            "deepseek_v2_lite": mla["step"]["launches"],
            "deepseek_v2_tiny": mla["tiny_step"]["launches"]},
        "max_abs_err": {**causal["errors"], **mla["errors"]},
        "times": {**causal["times"], **mla["times"]},
    }, {
        "name": "rms_norm",
        "route": "cuda",
        "source": NORM_SOURCE,
        "replaces": "the float32 chain of tpusim_torch/kernels/rms_norm.py "
                    "rms_norm_reference (no TPU kernel)",
        "launches_per_step": {n: r["launches"]
                              for n, r in norm["steps"].items()},
        "max_abs_err": {n: r["max_abs_err"]
                        for n, r in norm["errors"].items()},
        "times": norm["times"],
    }]}
    keys = ("ms", "plain_ms", "library_ms", "library_fused_ms")
    times = [f32[k] for k in keys] + [bf16[k] for k in keys] + [
        scan[k] for k in ("ms", "plain_ms", "library_ms")]
    if not all(math.isfinite(x) for x in times):
        raise AssertionError(f"non-finite timing in {record}")
    print(json.dumps(record))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
