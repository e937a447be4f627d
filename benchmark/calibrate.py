"""Readings a cell's limit is set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--faults]

For each of ``--seeds``, a whole run of the cell (``--seconds`` long) and
its ``logit_row_err``: the lower reading is the largest.  For each of
``--control-seeds``, a whole run with the control in the program's place
(:class:`benchmark.faults.Control`: the plain reference with every
product's operands rounded to fp8 e4m3, the precision below the
configuration's bfloat16), judged as a run is: the upper reading is the
smallest, and ``correct`` has to read false.  ``--faults``
also runs the cell with each fault of :mod:`benchmark.faults` planted
under the timed path, on each control seed.  ``--look`` reads, on the
first control seed, where the program's gap comes from: the program in
float32 on the same weights, the plain reference with bfloat16 storage,
the program with cuBLAS's reduced-precision bf16 reductions off, and the
program cut to fewer layers.  One JSON line a reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import faults, harness, spec, traffic

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.find_cell(args.workload)
    fam = spec.family(cell.config["family"])
    mix, config = cell.traffic, cell.config

    def emit(**doc):
        print(json.dumps(dict(cell=cell.name, **doc)), flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t)
        emit(kind="program", seed=seed,
             logit_row_err=r["checks"]["logit_row_err"]["value"],
             steps=r["attempted"], wall_s=time.perf_counter() - t)
    for seed in args.control_seeds:
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t,
                             wrap=faults.control(fam, config))
        emit(kind="control", seed=seed, precision="float8_e4m3fn",
             logit_row_err=r["checks"]["logit_row_err"]["value"],
             correct=r["correct"], steps=r["attempted"],
             wall_s=time.perf_counter() - t)
        if args.look and seed == args.control_seeds[0]:
            dev = torch.device("cuda")
            params = fam.make_params(config, seed, dev)
            tokens = fam.step_input(
                fam.make_inputs(config, mix, seed, dev),
                traffic.compared_step(mix, seed))
            ref = fam.reference(params, tokens, config)
            _look(fam, config, params, tokens, ref, emit, seed)
            del params, tokens, ref
        if args.faults:
            for name, wrap in faults.all_faults(
                    mix["batch"], fam.dims(config).vocab).items():
                t = time.perf_counter()
                r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                     t, wrap=wrap)
                emit(kind="fault", fault=name, seed=seed,
                     logit_row_err=r["checks"]["logit_row_err"]["value"],
                     correct=r["correct"])
    return 0


def _look(fam, config, params, tokens, ref, emit, seed) -> None:
    import torch

    from benchmark import compare

    def program(cfg, ps):
        return fam.step(fam.build(cfg, "cuda"), ps, tokens)

    got = program(config, params)
    emit(kind="look", seed=seed, what="program bfloat16",
         logit_row_err=compare.row_error(got, ref))
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    got = program(config, params)
    matmul.allow_bf16_reduced_precision_reduction = saved
    emit(kind="look", seed=seed, what="program bfloat16, no reduced-"
         "precision reductions", logit_row_err=compare.row_error(got, ref))
    wit = fam.reference(params, tokens, config, store_dtype=torch.bfloat16)
    emit(kind="look", seed=seed, what="reference, bfloat16 storage",
         logit_row_err=compare.row_error(wit, ref),
         vs_program=compare.row_error(got, wit))
    del got, wit
    f32 = [p.float() for p in params]
    got = program(dict(config, torch_dtype="float32"), f32)
    emit(kind="look", seed=seed, what="program float32, same weights",
         logit_row_err=compare.row_error(got, ref))
    del got, f32
    per_layer = (len(params) - 2) // config["num_hidden_layers"]
    for layers in (1, 2, 4, 8, 16):
        if layers >= config["num_hidden_layers"]:
            break
        cut = dict(config, num_hidden_layers=layers)
        ps = params[:2 + per_layer * layers]
        r = fam.reference(ps, tokens, cut)
        emit(kind="look", seed=seed, what=f"program bfloat16, {layers} layers",
             logit_row_err=compare.row_error(program(cut, ps), r),
             witness=compare.row_error(
                 fam.reference(ps, tokens, cut, store_dtype=torch.bfloat16),
                 r))


if __name__ == "__main__":
    sys.exit(main())
