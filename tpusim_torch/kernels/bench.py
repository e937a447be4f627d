"""Measurements of the port's CUDA kernels on the card (not used by the port).

    python -m tpusim_torch.kernels.bench ceiling
    python -m tpusim_torch.kernels.bench compare \\
        --build new=tpusim_torch/csrc --build old=OTHER/tpusim_torch/csrc

``ceiling`` runs ``csrc/mma_probe.cu``: the throughput of warp-level
``mma.sync`` in TF32 (m16n8k8) and bf16 (m16n8k16), and of rounding a
float32 to TF32 by ``cvt.rna.tf32.f32`` and by integer operations -- what
the attention kernel can reach with the instructions it is built from --
and the latency of one dependent float64 add, which times the chain floor
of a ``scan_rows`` lane (k adds take at least k times it).

``compare`` builds ``flash_attention.cu`` from each ``--build LABEL=DIR``
(a csrc directory, such as one unpacked from another commit with ``git
archive``), holds every build
against the plain version, and times the builds in turns at the registered
shape [32, 1024, 128] in f32 and bf16.  Times of one card differ by several
percent from call to call, so two versions are compared inside one run.
Every result line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from tpusim_torch.kernels import build
from tpusim_torch.kernels.flash_attention import flash_attention_reference

SHAPE = (32, 1024, 128)
SM_COUNT = 132  # H100 SXM
SAMPLES, REPS, ROUNDS = 25, 10, 2


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median over SAMPLES CUDA-event times of REPS back-to-back calls."""
    for _ in range(3):
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


def dadd_latency(iters: int = 1 << 16) -> dict:
    """The latency of one dependent ``__dadd_rn`` on the card, from one
    warp's chain of ``iters`` x 16 adds: cycles (``clock64``) and
    nanoseconds (the global timer) per add, and the clock they imply."""
    lib = ctypes.CDLL(str(build.build_library("mma_probe")))
    fn = lib.tpusim_dadd_chain_probe
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    adds = iters * lib.tpusim_dadd_chain_unroll()
    inp = torch.tensor([1.0, 1.0], dtype=torch.float64, device="cuda")
    out = torch.empty(32, dtype=torch.float64, device="cuda")
    stamps = torch.zeros(2, dtype=torch.int64, device="cuda")
    err = fn(iters, inp.data_ptr(), out.data_ptr(), stamps.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dadd chain probe failed: cudaError {err}")
    torch.cuda.synchronize()
    if out.tolist() != [1.0 + adds] * 32:
        raise AssertionError(f"dadd chain probe: {out[0].item()} != "
                             f"{1.0 + adds}")
    cycles, ns = stamps.tolist()
    return {"adds": adds, "cycles_per_add": cycles / adds,
            "ns_per_add": ns / adds, "clock_ghz": cycles / ns}


def ceiling() -> None:
    lib = ctypes.CDLL(str(build.build_library("mma_probe")))
    lib.tpusim_mma_probe.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    ilp = lib.tpusim_mma_probe_ilp()
    blocks, iters = SM_COUNT * 4, 4096
    name = card()
    for which, what, flop in ((0, "mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
                              (1, "mma.sync m16n8k16 bf16", 2 * 16 * 8 * 16),
                              (2, "cvt.rna.tf32.f32", None),
                              (3, "tf32 rounding by integer ops", None)):
        for threads in (256, 512):
            out = torch.empty(blocks * threads, device="cuda")
            ms = ctypes.c_float()
            err = lib.tpusim_mma_probe(which, blocks, threads, iters,
                                       out.data_ptr(), ctypes.byref(ms))
            if err:
                raise RuntimeError(f"mma_probe failed: cudaError {err}")
            seconds = ms.value * 1e-3
            if flop:
                n = blocks * threads // 32 * iters * ilp
                rate = f"{n * flop / seconds / 1e12:.1f} TFLOP/s"
            else:
                n = blocks * threads * iters * ilp
                rate = f"{n / seconds / SM_COUNT / 1e9:.1f} G roundings/s per SM"
            print(f"ceiling {what}: {rate} ({threads // 32} warps a block, "
                  f"4 blocks an SM, {ilp} chains a warp; card: {name})")
    lat = dadd_latency()
    print(f"latency __dadd_rn, dependent: {lat['cycles_per_add']:.3f} cycles, "
          f"{lat['ns_per_add']:.4f} ns an add at {lat['clock_ghz']:.3f} GHz "
          f"(one warp, {lat['adds']} adds; card: {name})")


def _compile(label: str, src: Path):
    """Build ``src/flash_attention.cu``; its C entry."""
    out = build.BUILD_DIR / "compare" / label
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libflash_attention.so"
    cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
           str(src / "flash_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{log[-4000:]}")
    regs = [ln.split("Used")[1].split(",")[0].strip()
            for ln in log.splitlines() if "Used" in ln]
    spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln})
    print(f"build {label}: {regs}; {spills}")
    lib = ctypes.CDLL(str(so))
    fn = lib.tpusim_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, q, k, v):
    o = torch.empty_like(q)
    bh, s, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d,
             0 if q.dtype == torch.float32 else 1, 1.0 / math.sqrt(d),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return o


def inputs(shape, dtype, seed):
    """q, k, v of one shape, normal, from a seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                 for _ in range(3))


def compare(builds: list[str]) -> None:
    fns = {}
    for spec in builds:
        label, src = spec.split("=", 1)
        fns[label] = _compile(label, Path(src))
    name = card()
    # chip_smoke.py's tolerances: f32 atol 2e-5, bf16 atol + rtol 1e-2
    for dtype, atol, rtol in ((torch.float32, 2e-5, 0.0),
                              (torch.bfloat16, 1e-2, 1e-2)):
        for shape in (SHAPE, (3, 96, 80), (2, 80, 50)):
            q, k, v = inputs(shape, dtype, seed=1)
            want = flash_attention_reference(q, k, v).float()
            for label, fn in fns.items():
                diff = (_run(fn, q, k, v).float() - want).abs()
                if not bool((diff <= atol + rtol * want.abs()).all()):
                    raise AssertionError(f"{label} disagrees at {shape} "
                                         f"{dtype}: {diff.max().item():.3e}")
        q, k, v = inputs(SHAPE, dtype, seed=3)
        times = {label: [] for label in fns}
        for _ in range(ROUNDS):
            for label, fn in fns.items():
                times[label].append(time_ms(lambda: _run(fn, q, k, v)))
        for label, ts in times.items():
            print(f"compare {label} {str(dtype)[6:]} {list(SHAPE)}: ms "
                  f"{' '.join(f'{t:.4f}' for t in ts)} (median of {SAMPLES} x "
                  f"{REPS} calls, {ROUNDS} rounds in turns; card: {name})")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpusim_torch.kernels.bench")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ceiling", help="instruction throughput probes")
    cp = sub.add_parser("compare", help="time builds of the kernel in turns")
    cp.add_argument("--build", action="append", required=True,
                    metavar="LABEL=DIR", help="a label and a csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; this runs on the GPU", file=sys.stderr)
        return 1
    if args.cmd == "ceiling":
        ceiling()
    else:
        if not all("=" in b for b in args.build):
            ap.error("--build takes LABEL=DIR")
        compare(args.build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
