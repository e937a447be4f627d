"""Command-line interface of the port (counterpart of ``tpusim/__main__.py``).

    python -m tpusim_torch capture  <workload> <out-dir> [--launches N]
                                    [--snapshot] [--set K=V] [--device cuda|cpu]
    python -m tpusim_torch simulate <trace-dir> [--arch v5e] [--config F] [--json F]
                                    [--power] [--network-mode analytic|detailed]
                                    [--resume-kernel N] [--checkpoint-kernel N]
                                    [--resume-op N] [--checkpoint-op N]
                                    [--lenient-parse]
                                    [--pricing-backend auto|serial|vectorized|native]
    python -m tpusim_torch info     <trace-dir>
    python -m tpusim_torch workloads

The output format is the reference's.  Its other subcommands wait for
their slices of the port (see ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _cmd_simulate(args: argparse.Namespace) -> int:
    from tpusim_torch.sim.driver import simulate_trace

    overlays = list(args.config or [])
    if args.power:
        overlays.append({"power_enabled": True})
    if args.resume_kernel:
        overlays.append({"resume_kernel": args.resume_kernel})
    if args.checkpoint_kernel:
        overlays.append({"checkpoint_kernel": args.checkpoint_kernel})
    if args.resume_op:
        overlays.append({"resume_op": args.resume_op})
    if args.checkpoint_op:
        overlays.append({"checkpoint_op": args.checkpoint_op})
    if args.network_mode:
        overlays.append({"arch": {"ici": {"network_mode": args.network_mode}}})
    report = simulate_trace(
        args.trace, arch=args.arch, overlays=overlays,
        lenient=args.lenient_parse, pricing_backend=args.pricing_backend,
    )
    if args.power and report.power is not None:
        print(report.power.report_text())
    report.print_report()
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.stats.to_json() + "\n")
    return 0


def _parse_sets(items: list[str] | None) -> dict:
    """``--set k=v`` overrides (ints/floats/json parsed, else string)."""
    out = {}
    for item in items or []:
        k, _, v = item.partition("=")
        try:
            out[k] = json.loads(v)
        except (json.JSONDecodeError, ValueError):
            out[k] = v
    return out


def _cmd_capture(args: argparse.Namespace) -> int:
    from tpusim_torch.models import get_workload
    from tpusim_torch.tracer.capture import capture_to_dir, snapshot_buffers

    wl = get_workload(args.workload)
    module, wl_args = wl.build(device=args.device, **_parse_sets(args.set))
    capture_to_dir(
        args.out, module, *wl_args, name=wl.name, launches=args.launches
    )
    if args.snapshot:
        paths = snapshot_buffers(
            module, *wl_args,
            out_dir=Path(args.out) / "checkpoint_files",
            launches=args.launches,
        )
        print(f"{len(paths)} buffer snapshots in {args.out}/checkpoint_files")
    print(f"trace written to {args.out}")
    return 0


def _cmd_info(args: argparse.Namespace) -> int:
    from tpusim_torch.trace.format import load_trace

    pod = load_trace(args.trace)
    info = {
        "meta": pod.meta,
        "modules": {
            name: {
                "computations": len(m.computations),
                "entry_ops": len(m.entry.ops) if m.entry_name else 0,
                "collectives": len(m.collectives()),
                "num_devices": m.num_devices,
            }
            for name, m in pod.modules.items()
        },
        "devices": {
            d: len(t.commands) for d, t in pod.devices.items()
        },
    }
    print(json.dumps(info, indent=2, default=str))
    return 0


def _cmd_workloads(args: argparse.Namespace) -> int:
    from tpusim_torch.models import list_workloads

    for wl in sorted(list_workloads(), key=lambda w: (w.suite, w.name)):
        print(f"{wl.suite:10s} {wl.name:26s} devices={wl.num_devices:<3d} "
              f"{wl.description}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpusim_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("simulate", help="replay a stored trace")
    ps.add_argument("trace")
    ps.add_argument("--arch", default=None, help="arch preset (v4/v5e/v5p/v6e)")
    ps.add_argument("--config", action="append",
                    help="overlay flag file(s), applied in order")
    ps.add_argument("--json", default=None, help="also write stats JSON here")
    ps.add_argument("--power", action="store_true",
                    help="enable the TPUWattch power model")
    ps.add_argument("--resume-kernel", type=int, default=0,
                    help="fast-forward the first N kernel launches")
    ps.add_argument("--checkpoint-kernel", type=int, default=0,
                    help="stop the replay after N kernel launches")
    ps.add_argument("--resume-op", type=int, default=0,
                    help="fast-forward the first N entry ops inside each "
                         "module replay (sub-kernel resume)")
    ps.add_argument("--checkpoint-op", type=int, default=0,
                    help="stop each module replay after N entry ops "
                         "(sub-kernel checkpoint; drains in-flight async)")
    ps.add_argument("--network-mode", default=None,
                    choices=["analytic", "detailed"],
                    help="ICI model: closed-form schedules or per-packet "
                         "torus network sim (the -network_mode equivalent)")
    ps.add_argument("--lenient-parse", action="store_true",
                    help="skip malformed HLO lines with a counted "
                         "warning instead of raising mid-file (salvage "
                         "mode for damaged captures)")
    ps.add_argument("--pricing-backend", default=None,
                    choices=["auto", "serial", "vectorized", "native"],
                    help="pin the tpusim_torch.fastpath pricing backend "
                         "(byte-identical; default auto = vectorized; also "
                         "via $TPUSIM_PRICING_BACKEND; native is not "
                         "ported yet and raises) and stamp fastpath_* "
                         "stats on the report")
    ps.set_defaults(fn=_cmd_simulate)

    pc = sub.add_parser("capture", help="capture a registered workload")
    pc.add_argument("workload")
    pc.add_argument("out")
    pc.add_argument("--launches", type=int, default=1)
    pc.add_argument("--snapshot", action="store_true",
                    help="also run the workload and dump every output "
                         "buffer per launch to <out>/checkpoint_files/")
    pc.add_argument("--set", action="append", metavar="K=V",
                    help="workload builder parameter override(s)")
    pc.add_argument("--device", default="cuda",
                    help="device the workload's tensors live on "
                         "(default cuda; cpu runs the plain versions)")
    pc.set_defaults(fn=_cmd_capture)

    pi = sub.add_parser("info", help="describe a stored trace")
    pi.add_argument("trace")
    pi.set_defaults(fn=_cmd_info)

    pw = sub.add_parser("workloads", help="list registered workloads")
    pw.set_defaults(fn=_cmd_workloads)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, FileNotFoundError, ValueError, RuntimeError) as e:
        # RuntimeError covers a missing card and a capture graph node the
        # port cannot lower yet (NotImplementedError)
        print(f"tpusim_torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
