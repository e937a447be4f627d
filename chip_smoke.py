#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, ``tpusim_torch capture → simulate``, at the
registered width of ``flash_attention_pallas`` ([32, 1024, 128] f32), of
the ten workloads the general lowering captures, of the seven
multi-device workloads (all their ranks on the one card) and of the
model suite (the two 64-device steps over meta tensors),
simulate's lane-batched pricing with its row scans on the card, the
campaign and fleet layers whose scenario-batched warm runs those scans,
and the sharding advisor on the card's host, and holds each CUDA kernel
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
   --compile-cache DIR``, cold then warm, each run a fresh process timed
   inside the child from before ``load_trace`` to the end of simulate;
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
   quota; (e) phase 7 (e) again, each of its four legs in a fresh process;
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
   and ``fleet`` ((d)'s fleet) uninterrupted in fresh processes, then
   cancelled mid-run in this process once half their records are
   journaled (the run's ``CancelToken`` tripped on the journaled count)
   and by the CLI's ``--max-wall-s`` (exit 3), each then ``--resume``-d
   through the CLI in a fresh process: the report equals the
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
   -m tpusim_torch advise`` on the same spec in fresh processes, cold and
   warm through one ``--result-cache`` directory: both ``--json`` reports
   equal by bytes and to (a)'s; (c) a v5p-64 sweep (``dp``, ``tp``,
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
   steps over meta tensors, their ``--snapshot`` refused); (b) the
   concrete ones' HLO on the card equals by bytes the CPU's; (c) each
   one's check — the card against the CPU (``llama7b`` at 2 layers, seq
   256, norm-wise; the ResNets at batch 2, the forward in float32 and the
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

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, the one before that the kernels' JSON
record, the one before that phase 14's (``ubench: {...}``), before it
phase 13's (``models: {...}``), phase 12's (``multidevice: {...}``),
phase 11's (``lowered: {...}``) and phase 10's (``advisor: {...}``).  Needs
no network and one card; exits non-zero without a CUDA device or without
the rest of the repository beside it.
"""

from __future__ import annotations

import contextlib
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

#: every kernel of the port: (name, source, TPU kernel it replaces, its
#: wrapper's launch counter and the counter's reset)
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


def phase(n: int | None, title: str = "") -> None:
    """Start phase ``n`` (``None``: end the last one), printing how long
    the one before it took."""
    now = time.perf_counter()
    if _PHASE_START:
        last, t0 = _PHASE_START.pop()
        PHASE_SECONDS[last] = now - t0
        print(f"  phase {last} took {now - t0:.1f} s", flush=True)
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


#: sources built in phase 2: every kernel, and the instruction probes whose
#: dependent-add latency phase 6 (d) reads
BUILT = tuple(k[0] for k in KERNELS) + ("mma_probe",)


def build_kernels() -> None:
    """Phase 2: build every kernel and the probes, one nvcc per source, all
    started together; print ptxas's registers, shared memory and spills,
    and fail on a spill in a kernel."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(BUILT)) as pool:
        libs = list(pool.map(build.build_library, BUILT))
    for name, so in zip(BUILT, libs):
        log = (so.parent / "build.log").read_text()
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
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
#: runs one CLI command and writes, to the JSON path it is given, its host
#: seconds from the first ``load_trace`` (or from the CLI's start, when the
#: command loads no trace through the driver) to the CLI's return, the
#: engine walks it made, every garbage-collection pause and its kernels'
#: launch counts.  Arguments: repo root, output path, CLI arguments.
FRESH_CHILD = r"""
import gc, json, sys, time
repo, out_path, *argv = sys.argv[1:]
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
t0 = time.perf_counter()
rc = main(argv)
t1 = time.perf_counter()
gc.callbacks.remove(on_gc)
with open(out_path, "w") as f:
    json.dump({"rc": rc, "host_s": t1 - marks.get("load", t0),
               "cli_s": t1 - t0, "walks": walks[0], "gc": pauses,
               "launches": {"flash_attention": flash_attention.launch_count(),
                            "scan_rows": scan_rows.launch_count()}}, f)
"""
#: phase 8 (c): chip-degradation states of warm_states and their seed
WARM_STATES = 64
WARM_SEED = 19


def fresh_run(work: Path, argv: list[str], tag: str) -> tuple[dict, str]:
    """One CLI command in a fresh process (:data:`FRESH_CHILD`), with the
    committed tuner overlays off (``$TPUSIM_TUNED_DIR`` an empty dir, as
    the golden cells are priced) and no inherited compile store.  Returns
    the child's record and its standard output; raises when it fails."""
    out = work / f"fresh_{tag}.json"
    tuned = work / "no_tuned_overlays"
    tuned.mkdir(exist_ok=True)
    env = dict(os.environ, TPUSIM_TUNED_DIR=str(tuned))
    env.pop("TPUSIM_COMPILE_CACHE", None)
    proc = subprocess.run(
        [sys.executable, "-c", FRESH_CHILD, str(REPO), str(out), *argv],
        capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"fresh tpusim_torch {' '.join(argv)} exited "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    rec = json.loads(out.read_text())
    if rec["rc"] != 0:
        raise RuntimeError(f"fresh tpusim_torch {' '.join(argv)}: rc "
                           f"{rec['rc']}: {proc.stderr[-2000:]}")
    return rec, proc.stdout


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


def store_cells(card_name: str, work: Path, store: Path,
                cells=GOLDEN_CELLS) -> dict:
    """Phase 8 (a) and (b): each golden cell through ``simulate
    --compile-cache`` cold then warm, each run a fresh process.  Returns
    the host seconds by (golden, run) and the cold llama runs' GC pauses
    of :data:`GC_PAUSE_S` or more."""
    seconds, pauses = {}, {}
    for fixture, arch, overlays, golden in cells:
        runs = {}
        for run in ("cold", "warm"):
            path = work / f"{golden}_{run}.json"
            rec, _ = fresh_run(work, [
                "simulate", str(FIXTURES / fixture), "--arch", arch,
                *cell_flags(overlays), "--compile-cache", str(store),
                "--json", str(path)], f"{golden}_{run}")
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
              f"ir_ops_built 0; host s from load_trace, fresh process: cold "
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
    if fp_batch.resolve_batch_backend(None) != "vectorized":
        raise AssertionError("auto no longer resolves to vectorized")
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


def fresh_sweeps(card_name: str, work: Path) -> dict:
    """Phase 8 (e): phase 7 (e)'s four legs, each in a fresh process;
    reports equal by bytes, the warm cached leg pricing nothing."""
    argv = ["faults", "--arch", "v5p", "--chips", "8", "--trace",
            str(FIXTURES / "llama_tiny_tp2dp2")]
    cached = ["--result-cache", str(work / "fresh_result_cache")]
    legs = {"e_serial": [], "e_pooled": ["--workers", str(POOL_WORKERS)],
            "e_cached_cold": cached, "e_cached_warm": cached}
    out, blobs = {}, {}
    for label, extra in legs.items():
        path = work / f"fresh_{label}_report.json"
        rec, _ = fresh_run(work, [*argv, "--json", str(path), *extra], label)
        blobs[label] = path.read_bytes()
        out[label] = rec
    if len(set(blobs.values())) != 1:
        raise AssertionError("fresh-process sweep reports differ")
    walks = {label: rec["walks"] for label, rec in out.items()}
    if walks["e_cached_cold"] < 1 or walks["e_cached_warm"] != 0:
        raise AssertionError(f"fresh-process engine walks {walks}")
    print(f"  (e) faults --trace llama_tiny_tp2dp2, each leg a fresh "
          f"process: reports equal by bytes; engine walks {walks}; host s "
          f"inside the child " + " / ".join(
              f"{label[2:]} {rec['cli_s']:.4f}" for label, rec in out.items())
          + f" (card: {card_name})")
    return {label: rec["cli_s"] for label, rec in out.items()}


def durable_store(card_name: str, work: Path) -> dict:
    """Phase 8: (a)-(e) in ``work`` (an empty directory), the kernels'
    launch counters set to 0 just before each part and read just after.
    Raises on any failure."""
    store = work / "store"
    out, launches = {}, {}
    for part, fn in (
            ("a", lambda: store_cells(card_name, work, store)),
            ("b", lambda: parent_gc_pauses(card_name)),
            ("c", lambda: warm_states_phase(card_name, work)),
            ("d", lambda: cache_cli(card_name, store)),
            ("e", lambda: fresh_sweeps(card_name, work))):
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


def cli_process(argv: list[str], timeout: float = 600) -> tuple[int, str]:
    """``python -m tpusim_torch ARGV`` in a fresh process."""
    proc = subprocess.run([sys.executable, "-m", "tpusim_torch", *argv],
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


def resume_cli(cmd: str, spec_path: Path, trace: str, part: Path,
               full: Path, kind: str, resumed_re: str) -> int:
    """``--resume`` of a cancelled run in a fresh process: every journaled
    record is resumed, nothing journaled is priced again and the report
    equals the uninterrupted one by bytes.  Returns the records
    resumed."""
    done = journaled(part / "journal.jsonl", kind)
    rc, text = cli_process([cmd, str(spec_path), "--trace", trace,
                            "--out", str(part), "--resume"])
    resumed = int(re.search(resumed_re, text).group(1))
    if rc != 0 or resumed != done:
        raise AssertionError(f"{cmd} --resume: rc {rc}, {resumed} "
                             f"resumed of {done} journaled")
    if (part / "report.json").read_bytes() != \
            (full / "report.json").read_bytes():
        raise AssertionError(f"{cmd}: resumed report differs")
    return resumed


def cli_resume(card_name: str, work: Path) -> dict:
    """Phase 9 (b): ``campaign`` and ``fleet`` uninterrupted through the
    CLI in a fresh process, then cancelled two ways and resumed with
    ``--resume`` through the CLI in a fresh process, where the resumed
    report must equal the uninterrupted one by bytes, every journaled
    record be resumed and none be priced again:

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
    out = {}
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
        cli_process([cmd, str(spec_path), "--trace", trace,
                     "--out", str(full)])
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
        resumed = resume_cli(cmd, spec_path, trace, part, full, kind,
                             resumed_re)
        wall = work / f"{cmd}_wall"
        rc, _ = cli_process([cmd, str(spec_path), "--trace", trace,
                             "--out", str(wall), "--max-wall-s",
                             repr(CLI_MAX_WALL_S)])
        if rc != 3:
            raise AssertionError(f"{cmd} --max-wall-s {CLI_MAX_WALL_S}: "
                                 f"exit {rc}, not 3")
        wall_done = journaled(wall / "journal.jsonl", kind)
        resume_cli(cmd, spec_path, trace, wall, full, kind, resumed_re)
        print(f"  (b) {cmd} CLI: uninterrupted {full_s:.2f} s, {total} "
              f"{kind} records; cancelled after {done} journaled, "
              f"--resume: {resumed} resumed, report equal by bytes; "
              f"--max-wall-s {CLI_MAX_WALL_S}: exit 3 with {wall_done} "
              f"journaled, --resume: report equal by bytes "
              f"(card: {card_name})")
        out[cmd] = {"total": total, "resumed": resumed,
                    "max_wall_s_journaled": wall_done}
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
    """Phase 10 (b): ``python -m tpusim_torch advise`` in fresh processes,
    cold and then warm through one disk result cache: both JSON reports
    equal by bytes, and equal to (a)'s document."""
    spec = work / "advise_spec.json"
    spec.write_text(json.dumps(ADVISE_SMOKE_SPEC))
    cache = work / "advise_rc"
    out = {}
    for leg in ("cold", "warm"):
        path = work / f"advise_{leg}.json"
        for *_, reset in KERNELS:
            reset()
        t0 = time.perf_counter()
        _, text = cli_process(["advise", str(spec), "--trace",
                               str(FIXTURES / "llama_tiny_tp2dp2"),
                               "--result-cache", str(cache),
                               "--json", str(path)])
        out[leg] = {"s": time.perf_counter() - t0,
                    "bytes": path.read_bytes(),
                    "stats": [ln.strip() for ln in text.splitlines()
                              if ln.strip().startswith("advise_")]}
        no_launches(f"the advise CLI ({leg})")
    # ``advise --json`` writes indent 2
    want = (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()
    if not out["cold"]["bytes"] == out["warm"]["bytes"] == want:
        raise AssertionError("advise CLI: cold, warm and (a)'s reports differ")
    print(f"  (b) advise CLI in fresh processes: cold "
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


def model_suite(card_name: str, work: Path) -> dict:
    """Phase 13: the model suite at registered width — (a) ``capture W
    DIR`` through the CLI, timed (the 64-way ``llama7b_tp8dp8`` over meta
    tensors: nothing materialised, and ``--snapshot`` refused); (b) the
    concrete ones' HLO captured on the card equals by bytes the text
    lowered from CPU tensors of the same shapes; (c) each workload's
    numerics check (:func:`model_numerics`); (d) simulated at v5p: MXU
    flops, collectives and ICI bytes; (e) the median step on the card and
    the peak of ``torch.cuda.max_memory_allocated`` over the workload's
    part; (f) no custom kernel launched."""
    from tpusim_torch.tracer.capture import capture

    for *_, reset in KERNELS:
        reset()
    t_phase = time.perf_counter()
    rows = {}
    for name in MODELS:
        wl = get_workload(name)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trace = work / name
        t0 = time.perf_counter()
        run_cli(["capture", name, str(trace)])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        text = module_text(trace, name)
        row = {"world": wl.num_devices, "capture_s": capture_s,
               "hlo_bytes": len(text), "abstract": wl.abstract}
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
            module, args = wl.build(device="cuda")
            cpu_args = tuple(a.cpu() if a.dim() == 0 else
                             torch.empty(a.shape, dtype=a.dtype)
                             for a in args)
            if capture(module, *cpu_args, name=name).hlo_text != text:
                raise AssertionError(f"{name}: the card's HLO differs from "
                                     f"the CPU's")
            del cpu_args
            wall = measure_wall_time(module, *args, iters=3, warmup=1)
            row["median_ms"] = wall["median_s"] * 1e3
            del module, args
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        row["check"] = model_numerics(name)
        row["check_s"] = time.perf_counter() - t0
        st = stats_of(simulate_trace(trace, arch="v5p", tuned=False))
        row["v5p"] = {k: st[k] for k in SIM_MODEL_KEYS}
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        rows[name] = row
        med = (f"{row['median_ms']:.4f} ms" if row["median_ms"] is not None
               else "none (abstract)")
        chk = row["check"]
        print(f"  {name} ({row['world']} devices): capture {capture_s:.2f} s"
              f"{' (abstract)' if wl.abstract else ', HLO card == CPU'}; "
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


def ubench_workloads(card_name: str, work: Path) -> dict:
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
    (:func:`ubench_lint_llama`); no custom kernel launched."""
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
    for arch in ("v5e", "v5p"):
        text = run_cli(["simulate", str(trace), "--arch", arch])
        if EXIT_SENTINEL not in text:
            raise AssertionError(f"simulate --arch {arch}: no exit sentinel")
        picked = [ln for ln in text.splitlines() if any(
            f"tpusim_{k} =" in ln for k in
            ("sim_cycle", "kernel_launches", "tot_hbm_bytes", "tot_flops")
        )]
        print(f"  simulate --arch {arch}: " + "; ".join(picked))
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
    print("lowered: " + json.dumps(lowered))

    phase(12, "multi-device capture: seven workloads, all ranks on the card")
    with tempfile.TemporaryDirectory() as tmp:
        multi = multi_device(card_name, Path(tmp))
    print("multidevice: " + json.dumps(multi))

    phase(13, "the model suite at registered width")
    with tempfile.TemporaryDirectory() as tmp:
        models = model_suite(card_name, Path(tmp))

    phase(14, "the ubench workloads at registered width, and the analyzer")
    with tempfile.TemporaryDirectory() as tmp:
        ubench = ubench_workloads(card_name, Path(tmp))
    phase(None)
    models["phase_seconds"] = PHASE_SECONDS
    print("models: " + json.dumps(models))
    print("ubench: " + json.dumps(ubench))

    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": KERNELS[0][1],
        "replaces": KERNELS[0][2],
        "launches": launches["flash_attention"],
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
