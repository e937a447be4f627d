"""PyTorch → trace capture.

Port of ``tpusim/tracer/capture.py``.  Where the JAX package runs
``jax.jit → lower → compile`` and stores XLA's HLO text, the port runs
``torch.export.export`` on the workload's module and writes HLO text for
the exported graph in the parser's own syntax:

* one ``parameter(i)`` per placeholder;
* one ``custom-call`` with ``custom_call_target="tpu_custom_call"`` per
  call of the custom op ``tpusim_torch::flash_attention`` — what a TPU
  capture of the Pallas kernel holds.  No ``cost_estimate`` is written:
  the JAX ``flash_attention`` passes none to ``pallas_call`` either;
* ``ROOT`` for the output.

Any other graph node raises ``NotImplementedError``: general aten→HLO
lowering is ROADMAP A5.  Like the reference, :func:`capture` runs nothing
on the device (export runs the op's fake implementation);
:func:`snapshot_buffers` and :func:`measure_wall_time` run the kernel.
"""

from __future__ import annotations

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
from tpusim_torch.trace.format import TraceDir, save_trace

__all__ = ["Capture", "capture", "capture_to_dir", "export_to_hlo",
           "snapshot_buffers", "measure_wall_time"]

#: torch dtype → HLO primitive type, for the dtypes the custom ops take
_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: custom ops the capture writes as a TPU custom-call
_CUSTOM_CALL_OPS = ("tpusim_torch::flash_attention",)


def _hlo_shape(t: torch.Tensor, layout: bool = True) -> str:
    try:
        dt = _HLO_DTYPES[t.dtype]
    except KeyError:
        raise NotImplementedError(
            f"no HLO type for torch dtype {t.dtype}"
        ) from None
    dims = ",".join(str(int(d)) for d in t.shape)
    if not layout:
        return f"{dt}[{dims}]"
    # row-major: minor-to-major is the reversed dim order
    minor = ",".join(str(i) for i in range(t.dim() - 1, -1, -1))
    return f"{dt}[{dims}]{{{minor}}}"


def export_to_hlo(module: torch.nn.Module, args: tuple[torch.Tensor, ...],
                  name: str) -> tuple[str, torch.Tensor]:
    """HLO text of ``torch.export.export(module, args)``'s graph, and the
    (fake) output tensor export inferred."""
    ep = torch.export.export(module, args)
    graph = ep.graph_module.graph
    lines: list[str] = []
    params: list[torch.Tensor] = []
    values: dict[str, str] = {}    # fx node name -> HLO value name
    root: str | None = None
    root_val: torch.Tensor | None = None
    for node in graph.nodes:
        val = node.meta.get("val")
        if node.op == "placeholder":
            values[node.name] = node.name
            lines.append(
                f"  %{node.name} = {_hlo_shape(val)} parameter({len(params)})"
            )
            params.append(val)
        elif node.op == "call_function" and getattr(
            node.target, "name", lambda: ""
        )().split(".")[0] in _CUSTOM_CALL_OPS:
            tensors = [a for a in node.args if isinstance(a, torch.fx.Node)]
            values[node.name] = node.name
            operands = ", ".join(f"%{values[a.name]}" for a in tensors)
            lines.append(
                f"  %{node.name} = {_hlo_shape(val)} custom-call({operands}), "
                f'custom_call_target="tpu_custom_call"'
            )
        elif node.op == "output":
            outs = node.args[0]
            if len(outs) != 1 or not isinstance(outs[0], torch.fx.Node):
                raise NotImplementedError(
                    "capture writes one tensor output; general outputs "
                    "wait for ROADMAP A5"
                )
            root = values[outs[0].name]
            root_val = outs[0].meta["val"]
        else:
            raise NotImplementedError(
                f"capture lowers only the custom ops {_CUSTOM_CALL_OPS}; "
                f"graph node {node.op} {node.target} needs the general "
                f"aten->HLO lowering of ROADMAP A5"
            )
    if root is None or root_val is None:
        raise NotImplementedError("exported graph has no tensor output")
    # the output is the last instruction the graph defines; mark it ROOT
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith(f"  %{root} = "):
            lines[i] = "  ROOT " + lines[i][2:]
            break
    else:
        raise NotImplementedError("a graph that returns an input is not lowered")
    param_layouts = ", ".join(_hlo_shape(p) for p in params)
    header = (
        f"HloModule {name}, is_scheduled=true, "
        f"entry_computation_layout={{({param_layouts})->"
        f"{_hlo_shape(root_val)}}}"
    )
    sig = ", ".join(
        f"{values[n.name]}: {_hlo_shape(p, layout=False)}"
        for n, p in zip(
            [n for n in graph.nodes if n.op == "placeholder"], params
        )
    )
    entry = f"ENTRY %main ({sig}) -> {_hlo_shape(root_val, layout=False)} {{"
    return "\n".join([header, "", entry, *lines, "}", ""]), root_val


@dataclass
class Capture:
    """One captured module + its metadata."""

    name: str
    hlo_text: str
    meta: dict[str, Any] = field(default_factory=dict)
    in_bytes: int = 0
    out_bytes: int = 0

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


def _device_meta(dev: torch.device) -> dict[str, Any]:
    if dev.type == "cuda":
        return {
            "platform": "cuda",
            "device_kind": torch.cuda.get_device_name(dev),
            "num_devices": torch.cuda.device_count(),
        }
    return {"platform": dev.type, "device_kind": dev.type, "num_devices": 1}


def capture(module: torch.nn.Module, *args: torch.Tensor,
            name: str | None = None) -> Capture:
    """Capture ``module(*args)`` as a trace: export, write HLO, and take
    the memcpy sizes from the inputs and the exported output."""
    cap_name = name or type(module).__name__
    hlo_text, out_val = export_to_hlo(module, args, cap_name)
    meta: dict[str, Any] = {
        "capture_name": cap_name,
        **_device_meta(_device_of(args)),
        "trace_device": int(os.environ.get("TPUSIM_TRACE_DEVICE", "0") or 0),
        "xla_cost_analysis": {},
        "memory_analysis": {},
    }
    return Capture(name=cap_name, hlo_text=hlo_text, meta=meta,
                   in_bytes=sum(_nbytes(a) for a in args),
                   out_bytes=_nbytes(out_val))


def capture_to_dir(path: str | Path, module: torch.nn.Module,
                   *args: torch.Tensor, name: str | None = None,
                   launches: int = 1) -> TraceDir:
    """Capture and write a trace directory (module + commandlist + meta)."""
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
        path, modules={cap.name: cap.hlo_text}, commands=cmds, meta=cap.meta
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
                     out_dir: str | Path, launches: int = 1) -> list[Path]:
    """Run the workload on its device and dump every output buffer to
    ``launch{i}_buf{j}.npy`` after each launch.

    As in the reference, outputs are fed back into arguments of the same
    shape and dtype (a train step's updated state) before the next
    launch; a program none of whose outputs matches an argument is
    stateless, and its launch-0 buffers are replicated for the later
    launches instead of re-running it."""
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

    cur_args = args
    with torch.no_grad():
        out = module(*cur_args)
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
            out = module(*cur_args)
            _save(i, out)
    return paths


def measure_wall_time(module: torch.nn.Module, *args: torch.Tensor,
                      iters: int = 10, warmup: int = 3) -> dict[str, float]:
    """Time real execution of ``module(*args)``; the same keys as the
    reference.  On a CUDA device each of 3 batches of ``iters`` launches is
    timed with CUDA events (``fence_s`` is 0: the events need no host
    readback); on the CPU with the host clock."""
    dev = _device_of(args)
    with torch.no_grad():
        for _ in range(max(warmup, 1)):
            module(*args)
        n = max(iters, 1)
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
    times.sort()
    return {
        "iters": float(3 * n),
        "fence_s": 0.0,
        "min_s": times[0],
        "median_s": statistics.median(times),
        "mean_s": sum(times) / len(times),
    }
