#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, ``tpusim_torch capture → simulate``, at the
registered width of ``flash_attention_pallas`` ([32, 1024, 128] f32), and
holds its CUDA kernel against the plain PyTorch version.  Phases, in order
(any failure exits non-zero and prints no result):

1. the card's name and power limit (``nvidia-smi``) and the CUDA version;
2. build every kernel from ``tpusim_torch/csrc`` with nvcc (timed);
3. kernel vs plain version on the card, at the main path's shapes;
4. the main path through the CLI entry functions, with the kernels'
   launch counters set to 0 just before and read just after; simulate at
   v5e and v5p, and the two ``matmul_512`` golden cells against
   ``ci/golden/*.json``;
5. timings (median of CUDA-event times): kernel, plain version, the
   card's bound, and ``scaled_dot_product_attention`` as a yardstick.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and the one before that the kernels'
JSON record.  Needs no network and one card; exits non-zero without a
CUDA device or without the rest of the repository beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpusim_torch.__main__ import main as cli  # noqa: E402
from tpusim_torch.kernels import build  # noqa: E402
from tpusim_torch.kernels import flash_attention as fa  # noqa: E402
from tpusim_torch.models.flash_attention import flash_attention  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace  # noqa: E402
from tpusim_torch.sim.stats import EXIT_SENTINEL  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores and
#: HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: registered width of flash_attention_pallas: batch 4 x heads 8, seq 1024,
#: head_dim 128
MAIN_SHAPE = (32, 1024, 128)

#: f32: the kernel and the plain version both accumulate in f32 and differ
#: only in summation order (online softmax); 2e-5 is the JAX package's own
#: tolerance for this kernel
ATOL_F32 = 2e-5
#: bf16: both compute in f32 from the same bf16 inputs and round the output
#: once to bf16 (relative spacing 2^-8), so f32 results a hair apart can
#: round one bf16 ulp apart: at most 2^-7 |x| <= 1e-2 |x|, plus 1e-2 near 0
TOL_BF16 = 1e-2

GOLDEN_CELLS = (("matmul_512", "v5e"), ("matmul_512", "v5p"))
VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
RTOL_GOLDEN = 1e-9

#: every kernel of the port: (name, source, TPU kernel it replaces, its
#: wrapper's launch counter and the counter's reset)
KERNELS = (
    ("flash_attention", "tpusim_torch/csrc/flash_attention.cu",
     "tpusim/models/pallas_attention.py:50", fa.launch_count,
     fa.reset_launch_count),
)


def phase(n: int, title: str) -> None:
    print(f"== phase {n}: {title}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


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


SAMPLES, REPS = 25, 10


def time_ms(fn, warmup: int = 3) -> float:
    """ms per call of ``fn()``: median over ``SAMPLES`` CUDA-event times of
    ``REPS`` back-to-back calls each (so host overhead between calls is
    hidden behind the device's work, as in a real run; L2 stays warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        for _ in range(3)
    )


def run_cli(argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    if rc != 0:
        raise RuntimeError(f"tpusim_torch {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase(1, "card")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    phase(2, "build")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        libs = list(pool.map(build.build_library, [k[0] for k in KERNELS]))
    for so in libs:
        log = (so.parent / "build.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")

    phase(3, "kernel vs plain version")
    errs = {}
    for shape, dtype, block_q in (
        (MAIN_SHAPE, torch.float32, 128),
        (MAIN_SHAPE, torch.bfloat16, 128),
        ((2, 256, 64), torch.float32, 128),
        ((2, 192, 32), torch.float32, 64),
    ):
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
        print(f"  {list(shape)} {str(dtype)[6:]}: max |kernel - plain| "
              f"{err:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees at {shape} {dtype}")
        errs[(shape, dtype)] = err
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
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"main path never launched kernel {name}")
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
    for fixture, arch in GOLDEN_CELLS:
        report = simulate_trace(REPO / "tests" / "fixtures" / "traces" / fixture,
                                arch=arch, tuned=False)
        stats = json.loads(report.stats.to_json())
        errors = compare_golden(f"{fixture}__{arch}", stats)
        if errors:
            raise AssertionError("\n".join(errors))
        print(f"  golden {fixture}__{arch}: {len(stats)} stats match")
    shutil.rmtree(work, ignore_errors=True)

    phase(5, "timing")
    bh, s, d = MAIN_SHAPE
    q, k, v = inputs(MAIN_SHAPE, torch.float32, seed=3)
    kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v))
    flops = 4.0 * bh * s * s * d
    nbytes = 4 * q.numel() * q.element_size()
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    for label, ms in (("kernel", kernel_ms), ("plain", plain_ms),
                      ("library_sdpa", library_ms)):
        print(f"time {label}: {ms:.4f} ms at {list(MAIN_SHAPE)} f32, median "
              f"of {SAMPLES} x {REPS} back-to-back calls (card: {card})")
    print(f"time bound: {bound_ms:.4f} ms = max({flops:.4g} flop / 67 TFLOP/s "
          f"f32, {nbytes} B / 3.35 TB/s), computed from the published H100 "
          f"SXM peaks; the kernel reaches {bound_ms / kernel_ms:.1%} of it "
          f"(card: {card})")
    torch.cuda.synchronize()

    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": KERNELS[0][1],
        "replaces": KERNELS[0][2],
        "launches": launches["flash_attention"],
        "max_abs_err": errs[(MAIN_SHAPE, torch.float32)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}
    if not all(math.isfinite(x) for x in (kernel_ms, plain_ms, library_ms)):
        raise AssertionError(f"non-finite timing in {record}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
