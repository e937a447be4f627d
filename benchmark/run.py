"""Benchmark of tpusim_torch on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number compared
beside its limit, which are also the last lines of standard error.
Exits non-zero, printing no result, without the cards the cell asks for,
when a per-layer metric of a traced run reads nothing, or when a module
of JAX or of the JAX package is loaded once the window has closed.  Build and kernel caches go to fixed directories inside the
checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
#: top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpusim"})

EXIT_NO_CARD = 3
EXIT_FOREIGN = 4
EXIT_MISSING_METRIC = 5


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is in :data:`FORBIDDEN`."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def _environment() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness, spec

    torch.set_num_threads(1)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"this host has {have}", file=sys.stderr)
        return EXIT_NO_CARD
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T0)
    except harness.MissingMetric as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return EXIT_MISSING_METRIC
    found = foreign_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return EXIT_FOREIGN
    print(f"run took {time.perf_counter() - T0:.3f} s from process start",
          file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
