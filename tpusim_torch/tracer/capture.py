"""PyTorch → trace capture.

Port of ``tpusim/tracer/capture.py``.  Where the JAX package runs
``jax.jit → lower → compile`` and stores XLA's HLO text, the port takes
the workload's graph in core ATen ops (:func:`capture_graph`: ``torch.
export`` for a forward module, ``make_fx`` for a train step), lowers it
to HLO (:mod:`tpusim_torch.tracer.lower`), fuses it
(:mod:`tpusim_torch.tracer.fuse`) and writes the text in the parser's
own syntax, with a tuple ``ROOT`` when the workload returns several
tensors.  The custom op ``tpusim_torch::flash_attention`` stays one
``custom-call`` with ``custom_call_target="tpu_custom_call"`` and no
``cost_estimate`` — what a TPU capture of the Pallas kernel holds.

A multi-device workload (:class:`~tpusim_torch.spmd.SpmdModule`)
is captured as the program of one device (``$TPUSIM_TRACE_DEVICE``,
default 0) over its shards, with ``num_partitions`` in the header and the
mesh size as ``num_devices`` in the meta.  Its snapshots and timings run
one rank a process on ``cuda:0`` … ``cuda:N-1`` when the host has a card
for each of its N ranks (:func:`~tpusim_torch.spmd_procs.ranks_for`, the
reference's ``jax.devices()[:n]``), on the ranks of a given
:class:`~tpusim_torch.spmd_procs.RankGroup`, and otherwise every rank at
once on the one card (:func:`~tpusim_torch.spmd.run_ranks`).  The trace
is the same bytes either way: capture runs nothing.

An abstract workload (its arguments on the ``meta`` device, the port's
counterpart of the reference's ``ShapeDtypeStruct`` arguments) is
captured the same way, without materialising a tensor; it has no values
to snapshot or time, so :func:`snapshot_buffers` and
:func:`measure_wall_time` refuse it with ``ValueError``.

A graph node outside the lowering's op table raises
``NotImplementedError``.  Like the reference, :func:`capture` runs
nothing on the device (the graph is traced over fake tensors);
:func:`snapshot_buffers` and :func:`measure_wall_time` run the workload.
The meta keeps the reference's keys; ``xla_cost_analysis`` and
``memory_analysis`` stay empty, as there is no XLA here.
"""

from __future__ import annotations

import math
import os
import shutil
import statistics
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tpusim_torch.ir import CommandKind, TraceCommand
from tpusim_torch.spmd import SpmdModule, global_shape
from tpusim_torch.spmd_procs import RankGroup, ranks_for
from tpusim_torch.trace.format import TraceDir, save_trace
from tpusim_torch.tracer.lower import lower_graph

__all__ = ["Capture", "capture", "capture_to_dir", "capture_graph",
           "export_to_hlo",
           "snapshot_buffers", "measure_wall_time"]

def capture_graph(module: torch.nn.Module,
                  args: tuple[torch.Tensor, ...]) -> torch.fx.GraphModule:
    """The module's graph in core ATen ops: ``torch.export`` then
    ``run_decompositions()``, or, for a module whose ``train_step`` is
    true (a step that calls ``torch.autograd.grad``, which export does
    not take), ``make_fx`` over fake tensors with the core ATen
    decompositions.  Neither runs anything on the device."""
    if getattr(module, "train_step", False):
        from torch._decomp import core_aten_decompositions
        from torch.fx.experimental.proxy_tensor import make_fx

        return make_fx(module,
                       decomposition_table=core_aten_decompositions(),
                       tracing_mode="fake")(*args)
    ep = torch.export.export(module, args).run_decompositions()
    for spec in ep.graph_signature.input_specs:
        if spec.kind != torch.export.graph_signature.InputKind.USER_INPUT:
            raise NotImplementedError(
                f"capture takes modules without parameters or buffers; "
                f"input {spec.arg.name} is a {spec.kind.name}"
            )
    return ep.graph_module


def export_to_hlo(module: torch.nn.Module, args: tuple[torch.Tensor, ...],
                  name: str, num_partitions: int = 1
                  ) -> tuple[str, list[torch.Tensor]]:
    """HLO text of the module's lowered and fused graph, and the (fake)
    output tensors in order.  ``num_partitions``: the devices of an SPMD
    program (``args`` are then one device's shards)."""
    hlo, outs = lower_graph(capture_graph(module, args), name,
                            num_partitions=num_partitions)
    return hlo.text(), outs


@dataclass
class Capture:
    """One captured module + its metadata.

    ``graph`` is the FX graph that was lowered, and ``origins`` /
    ``fused`` its provenance (see :class:`~tpusim_torch.tracer.hlo_ir.
    HloModule`), which the HLO text does not carry: the per-op profile
    (:mod:`tpusim_torch.harness.correl_ops`) runs the graph and files each
    node's device time under the instruction that node became."""

    name: str
    hlo_text: str
    meta: dict[str, Any] = field(default_factory=dict)
    in_bytes: int = 0
    out_bytes: int = 0
    graph: torch.fx.GraphModule | None = None
    origins: dict[str, str] = field(default_factory=dict)
    fused: dict[str, str] = field(default_factory=dict)

    _module: Any = field(default=None, repr=False)

    @property
    def module(self):
        """The parsed :class:`~tpusim_torch.ir.ModuleTrace` of
        ``hlo_text`` (lazily, as the reference's), with the meta."""
        if self._module is None:
            from tpusim_torch.trace.lazy import (
                LAZY_THRESHOLD_BYTES, parse_hlo_module_lazy,
            )
            from tpusim_torch.trace.native import parse_hlo_module_fast

            if len(self.hlo_text) >= LAZY_THRESHOLD_BYTES:
                self._module = parse_hlo_module_lazy(
                    self.hlo_text, name_hint=self.name)
            else:
                self._module = parse_hlo_module_fast(
                    self.hlo_text, name_hint=self.name)
            self._module.meta.update(self.meta)
        return self._module

    def commands(self) -> list[TraceCommand]:
        """The command-stream entries for one launch of this capture on
        device 0, stream 0: H2D memcpys for inputs, the kernel launch, D2H
        for outputs."""
        cmds = []
        if self.in_bytes:
            cmds.append(TraceCommand(
                kind=CommandKind.MEMCPY_H2D, nbytes=self.in_bytes,
            ))
        cmds.append(TraceCommand(
            kind=CommandKind.KERNEL_LAUNCH, module=self.name,
        ))
        if self.out_bytes:
            cmds.append(TraceCommand(
                kind=CommandKind.MEMCPY_D2H, nbytes=self.out_bytes,
            ))
        return cmds


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _device_of(args: tuple[torch.Tensor, ...]) -> torch.device:
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"inputs must lie on one device; got {devs}")
    return devs.pop()


def _concrete(args: tuple[torch.Tensor, ...], what: str) -> torch.device:
    """The inputs' device; abstract (``meta``) inputs are refused."""
    dev = _device_of(args)
    if dev.type == "meta":
        raise ValueError(
            f"{what} needs concrete inputs; this workload has abstract "
            f"(meta) arguments (AOT capture) — skip --snapshot and timing")
    return dev


#: the ``platform`` every capture of the port stamps.  The cost model
#: undoes XLA:CPU's FloatNormalization (every bf16 dot widened to f32)
#: only for a ``cpu`` or ``interpreter`` platform; the port's lowering
#: never widens a dot, so its f32 dot is a genuine f32 dot on either
#: device, and the same HLO text prices the same wherever it was
#: captured.  The device stays in ``device_kind``.
PLATFORM = "tpusim_torch"


def _device_meta(dev: torch.device, num_devices: int) -> dict[str, Any]:
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return {"platform": PLATFORM, "device_kind": kind,
            "num_devices": num_devices}


def capture(module: torch.nn.Module, *args: torch.Tensor,
            name: str | None = None) -> Capture:
    """Capture ``module(*args)`` as a trace: export, write HLO, and take
    the memcpy sizes from the inputs and the exported output.

    For an SPMD workload (:class:`~tpusim_torch.spmd.SpmdModule`),
    ``args`` are the global arrays: the trace is the program of device
    ``$TPUSIM_TRACE_DEVICE`` (default 0) over its shards — every device
    runs the same program — with ``num_partitions`` and ``num_devices``
    the mesh size, and the memcpys carry the global arrays' bytes, as the
    reference counts them."""
    cap_name = name or type(module).__name__
    spmd = isinstance(module, SpmdModule)
    world = module.world if spmd else 1
    trace_device = int(os.environ.get("TPUSIM_TRACE_DEVICE", "0") or 0)
    local = args
    if spmd:
        if not 0 <= trace_device < world:
            raise ValueError(f"TPUSIM_TRACE_DEVICE={trace_device} is not a "
                             f"device of the {world}-device mesh")
        local = module.local_args(*args, rank=trace_device)
    graph = capture_graph(module, local)
    hlo, out_vals = lower_graph(graph, cap_name, num_partitions=world)
    hlo_text = hlo.text()
    meta: dict[str, Any] = {
        "capture_name": cap_name,
        **_device_meta(_device_of(args), world),
        "trace_device": trace_device,
        "xla_cost_analysis": {},
        "memory_analysis": {},
    }
    if spmd:
        specs = module.out_specs
        specs = specs if len(out_vals) > 1 else (specs,)
        out_bytes = sum(
            math.prod(global_shape(v.shape, module.mesh, s))
            * v.element_size() for v, s in zip(out_vals, specs))
    else:
        out_bytes = sum(_nbytes(v) for v in out_vals)
    return Capture(name=cap_name, hlo_text=hlo_text, meta=meta,
                   in_bytes=sum(_nbytes(a) for a in args),
                   out_bytes=out_bytes, graph=graph, origins=hlo.origins,
                   fused=hlo.fused)


def _runner(module: torch.nn.Module, group: RankGroup | None = None):
    """What runs one launch of the workload on global arrays: the ranks
    of ``group``, the vmap rank runner for an SPMD workload without one,
    else the module."""
    if group is not None:
        return lambda *a: group.run_module(module, *a)
    return module.run if isinstance(module, SpmdModule) else module


def capture_to_dir(path: str | Path, module: torch.nn.Module,
                   *args: torch.Tensor, name: str | None = None,
                   launches: int = 1,
                   compress: bool | str = "auto") -> TraceDir:
    """Capture and write a trace directory (module + commandlist + meta);
    ``compress`` as in :func:`~tpusim_torch.trace.format.save_trace`."""
    cap = capture(module, *args, name=name)
    cmds: list[TraceCommand] = []
    for i in range(launches):
        launch_cmds = cap.commands()
        # steady-state shape: inputs uploaded once before the first launch,
        # outputs read back once after the last; middles are kernel-only
        if i > 0:
            launch_cmds = [
                c for c in launch_cmds if c.kind != CommandKind.MEMCPY_H2D
            ]
        if i < launches - 1:
            launch_cmds = [
                c for c in launch_cmds if c.kind != CommandKind.MEMCPY_D2H
            ]
        cmds.extend(launch_cmds)
    return save_trace(
        path, modules={cap.name: cap.hlo_text}, commands=cmds, meta=cap.meta,
        compress=compress,
    )


def _leaves(out: Any) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return []


def _sig(x: Any):
    leaves = _leaves(x)
    if not leaves or (isinstance(x, (tuple, list)) and
                      len(leaves) != len(x)):
        return None
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


def snapshot_buffers(module: torch.nn.Module, *args: torch.Tensor,
                     out_dir: str | Path, launches: int = 1,
                     group: RankGroup | None = None) -> list[Path]:
    """Run the workload on its device and dump every output buffer to
    ``launch{i}_buf{j}.npy`` after each launch; a multi-device workload
    on the ranks :func:`~tpusim_torch.spmd_procs.ranks_for` gives it
    (``group``, or one rank a card, or the vmap runner).

    As in the reference, outputs are fed back into arguments of the same
    shape and dtype (a train step's updated state) before the next
    launch; a program none of whose outputs matches an argument is
    stateless, and its launch-0 buffers are replicated for the later
    launches instead of re-running it."""
    dev = _concrete(args, "snapshot_buffers")
    out_root = Path(out_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    paths: list[Path] = []

    def _thread(out, cur_args):
        candidates = [out]
        if isinstance(out, (tuple, list)):
            candidates.extend(out)
        new_args = list(cur_args)
        used: set[int] = set()
        changed = False
        for pos, a in enumerate(new_args):
            sa = _sig(a)
            if sa is None:
                continue
            for ci, cand in enumerate(candidates):
                if ci not in used and _sig(cand) == sa:
                    new_args[pos] = cand
                    used.add(ci)
                    changed = True
                    break
        return tuple(new_args), changed

    def _save(i: int, out) -> int:
        leaves = _leaves(out)
        for j, leaf in enumerate(leaves):
            path = out_root / f"launch{i}_buf{j}.npy"
            np.save(path, leaf.detach().float().cpu().numpy()
                    if leaf.dtype == torch.bfloat16
                    else leaf.detach().cpu().numpy())
            paths.append(path)
        return len(leaves)

    with ranks_for(module, dev, group) as ranks, torch.no_grad():
        step = _runner(module, ranks)
        cur_args = args
        out = step(*cur_args)
        n_bufs = _save(0, out)
        for i in range(1, launches):
            cur_args, changed = _thread(out, cur_args)
            if not changed:
                warnings.warn(
                    "snapshot_buffers: no output matches any input; "
                    "treating the program as stateless per launch and "
                    "replicating launch-0 buffers for launches 1.."
                    f"{launches - 1}", stacklevel=2,
                )
                for k in range(i, launches):
                    for j in range(n_bufs):
                        src = out_root / f"launch0_buf{j}.npy"
                        dst = out_root / f"launch{k}_buf{j}.npy"
                        dst.unlink(missing_ok=True)
                        try:
                            os.link(src, dst)
                        except OSError:
                            shutil.copyfile(src, dst)
                        paths.append(dst)
                break
            out = step(*cur_args)
            _save(i, out)
    return paths


def measure_wall_time(module: torch.nn.Module, *args: torch.Tensor,
                      iters: int = 10, warmup: int = 3,
                      group: RankGroup | None = None) -> dict[str, float]:
    """Time real execution of ``module(*args)``; the same keys as the
    reference.  On a CUDA device each of 3 batches of ``iters`` launches is
    timed with CUDA events (``fence_s`` is 0: the events need no host
    readback); on the CPU with the host clock.  A multi-device workload
    on ranks of their own (:func:`~tpusim_torch.spmd_procs.ranks_for`)
    times each launch after a barrier, at its slowest rank's time
    (:meth:`~tpusim_torch.spmd_procs.RankGroup.time_launches`), a batch
    the mean of its launches.  Abstract (``meta``) arguments are
    refused."""
    dev = _concrete(args, "measure_wall_time")
    n = max(iters, 1)
    with ranks_for(module, dev, group) as ranks:
        if ranks is None:
            times = _batches(_runner(module), args, dev, n, warmup)
        else:
            each = ranks.time_launches(module, *args, launches=3 * n,
                                       warmup=max(warmup, 1))
            times = [sum(each[i * n:(i + 1) * n]) / n for i in range(3)]
    times.sort()
    return {
        "iters": float(3 * n),
        "fence_s": 0.0,
        "min_s": times[0],
        "median_s": statistics.median(times),
        "mean_s": sum(times) / len(times),
    }


def _batches(module, args: tuple, dev: torch.device, n: int,
             warmup: int) -> list[float]:
    """Seconds a launch in each of 3 batches of ``n`` back-to-back
    launches in this process."""
    with torch.no_grad():
        for _ in range(max(warmup, 1)):
            module(*args)
        times = []
        for _ in range(3):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    module(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / n)
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    module(*args)
                times.append((time.perf_counter() - t0) / n)
    return times
