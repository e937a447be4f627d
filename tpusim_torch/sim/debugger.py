"""Interactive single-step debugger.

Port of ``tpusim/sim/debugger.py``; its output is the JAX package's,
byte for byte, on the same module and config.

The rebuild of the reference's gdb-style interactive debug loop
(``src/debug.{h,cc}``: ``gpgpu_debug()`` on ``g_single_step``, with
watchpoints).  Steps through a module's entry schedule one HLO op at a
time, printing each op's cost breakdown; breakpoints match op names or
opcodes (the watchpoint analogue).

Commands::

    s [n]      step n ops (default 1)
    c          continue to next breakpoint / end
    b <pat>    add breakpoint on op name or opcode substring
    l [n]      list the next n ops (default 5)
    p          print current op details (cost, bytes, attrs)
    stats      print accumulated counters so far
    q          quit
"""

from __future__ import annotations

import shlex
import sys
from typing import TextIO

from tpusim_torch.ir import ModuleTrace
from tpusim_torch.timing.config import SimConfig
from tpusim_torch.timing.cost import CostModel

__all__ = ["Debugger"]


class Debugger:
    def __init__(self, module: ModuleTrace, config: SimConfig | None = None):
        self.module = module
        self.config = config or SimConfig()
        self.cost = CostModel(self.config.arch)
        comp = module.entry
        self.ops = comp.ops
        self.comp = comp
        self.pos = 0
        self.t_cycles = 0.0
        self.breakpoints: list[str] = []
        self.counters = {"flops": 0.0, "hbm_bytes": 0.0, "ops": 0}

    # ------------------------------------------------------------------

    def _cost(self, op):
        return self.cost.op_cost(op, self.comp, self.module)

    def _step_one(self, out: TextIO) -> bool:
        if self.pos >= len(self.ops):
            print("(end of schedule)", file=out)
            return False
        op = self.ops[self.pos]
        c = self._cost(op)
        self.t_cycles += c.cycles
        self.counters["flops"] += c.flops
        self.counters["hbm_bytes"] += c.hbm_bytes
        self.counters["ops"] += 1
        print(
            f"[{self.pos:4d}] t={self.t_cycles:12.0f}cy "
            f"{op.opcode:20s} {op.name:32s} "
            f"+{c.cycles:9.0f}cy unit={c.unit.value}",
            file=out,
        )
        self.pos += 1
        return True

    def _hits_breakpoint(self) -> bool:
        if self.pos >= len(self.ops):
            return False
        op = self.ops[self.pos]
        return any(b in op.name or b in op.opcode for b in self.breakpoints)

    # ------------------------------------------------------------------

    def repl(self, in_stream: TextIO | None = None,
             out: TextIO | None = None) -> None:
        in_stream = in_stream or sys.stdin
        out = out or sys.stdout
        print(
            f"tpusim debugger: module {self.module.name!r}, "
            f"{len(self.ops)} entry ops.  's' step, 'c' continue, "
            f"'b <pat>' break, 'q' quit.",
            file=out,
        )
        for raw in in_stream:
            line = raw.strip()
            if not line:
                continue
            try:
                parts = shlex.split(line)
            except ValueError:
                print("?", file=out)
                continue
            cmd, args = parts[0], parts[1:]

            def _int_arg(default: int) -> int:
                try:
                    return int(args[0]) if args else default
                except ValueError:
                    print(f"? not a count: {args[0]!r}", file=out)
                    return 0

            if cmd == "q":
                break
            elif cmd == "s":
                n = _int_arg(1)
                for _ in range(n):
                    if not self._step_one(out):
                        break
            elif cmd == "c":
                stepped = False
                while self.pos < len(self.ops):
                    if stepped and self._hits_breakpoint():
                        op = self.ops[self.pos]
                        print(f"breakpoint: next op is {op.name} "
                              f"({op.opcode})", file=out)
                        break
                    if not self._step_one(out):
                        break
                    stepped = True
                if self.pos >= len(self.ops):
                    print(f"done: {self.t_cycles:.0f} cycles total", file=out)
            elif cmd == "b" and args:
                self.breakpoints.append(args[0])
                print(f"breakpoint #{len(self.breakpoints)} on "
                      f"{args[0]!r}", file=out)
            elif cmd == "l":
                n = _int_arg(5)
                for i in range(self.pos, min(self.pos + n, len(self.ops))):
                    op = self.ops[i]
                    print(f"  [{i:4d}] {op.opcode:20s} {op.name}", file=out)
            elif cmd == "p":
                if self.pos < len(self.ops):
                    op = self.ops[self.pos]
                    c = self._cost(op)
                    print(f"next op : {op.name} ({op.opcode})", file=out)
                    print(f"result  : {op.result}", file=out)
                    print(f"operands: {', '.join(op.operands)}", file=out)
                    print(f"cycles  : {c.cycles:.0f} (compute "
                          f"{c.compute_cycles:.0f} / mem {c.mem_cycles:.0f})",
                          file=out)
                    print(f"bytes   : hbm {c.hbm_bytes:.0f} vmem "
                          f"{c.vmem_bytes:.0f} ici {c.ici_bytes:.0f}",
                          file=out)
                    if op.attrs:
                        keys = ", ".join(sorted(op.attrs)[:8])
                        print(f"attrs   : {keys}", file=out)
                else:
                    print("(end of schedule)", file=out)
            elif cmd == "stats":
                print(f"ops={self.counters['ops']} "
                      f"t={self.t_cycles:.0f}cy "
                      f"flops={self.counters['flops']:.3g} "
                      f"hbm={self.counters['hbm_bytes']:.3g}B", file=out)
            else:
                print("commands: s [n] | c | b <pat> | l [n] | p | stats | q",
                      file=out)
