"""A small in-memory HLO module: what the lowering builds, the passes
rewrite, and :meth:`HloModule.text` prints in the syntax
:mod:`tpusim_torch.trace.hlo_text` parses.

Every array is dense row-major (layout ``{n-1,…,0}``), so a reshape is
always a ``bitcast``.  Names are unique across the module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

__all__ = ["Array", "Shape", "Instr", "Computation", "HloModule",
           "shape_text"]


@dataclass(frozen=True)
class Array:
    dtype: str
    dims: tuple[int, ...]

    @property
    def rank(self) -> int:
        return len(self.dims)


#: an array, or a tuple of arrays (a while carry, a multi-output root)
Shape = Union[Array, tuple]


def shape_text(shape: Shape, layout: bool = True) -> str:
    if isinstance(shape, tuple):
        return "(" + ", ".join(shape_text(s, layout) for s in shape) + ")"
    dims = ",".join(str(int(d)) for d in shape.dims)
    if not layout or not shape.dims:
        return f"{shape.dtype}[{dims}]"
    minor = ",".join(str(i) for i in range(shape.rank - 1, -1, -1))
    return f"{shape.dtype}[{dims}]{{{minor}}}"


@dataclass
class Instr:
    name: str
    shape: Shape
    opcode: str
    operands: list[str] = field(default_factory=list)
    #: ``key=value`` texts in print order
    attrs: list[str] = field(default_factory=list)
    #: the text inside the parens of a ``constant`` / ``parameter``
    arg: str | None = None

    def text(self, is_root: bool = False) -> str:
        inside = (self.arg if self.arg is not None
                  else ", ".join(f"%{o}" for o in self.operands))
        tail = "".join(f", {a}" for a in self.attrs)
        root = "ROOT " if is_root else ""
        return (f"  {root}%{self.name} = {shape_text(self.shape)} "
                f"{self.opcode}({inside}){tail}")


class Computation:
    def __init__(self, name: str, is_entry: bool = False):
        self.name = name
        self.is_entry = is_entry
        self.instrs: list[Instr] = []
        self.root: str | None = None
        #: fusion is run over this computation (entry and loop bodies)
        self.fusible = is_entry

    def add(self, instr: Instr) -> str:
        self.instrs.append(instr)
        return instr.name

    def get(self, name: str) -> Instr:
        for i in self.instrs:
            if i.name == name:
                return i
        raise KeyError(name)

    def index(self) -> dict[str, Instr]:
        return {i.name: i for i in self.instrs}

    @property
    def params(self) -> list[Instr]:
        return sorted((i for i in self.instrs if i.opcode == "parameter"),
                      key=lambda i: int(i.arg))

    def root_instr(self) -> Instr:
        return self.get(self.root)

    def users(self) -> dict[str, list[str]]:
        """name → distinct user names, in instruction order."""
        out: dict[str, list[str]] = {i.name: [] for i in self.instrs}
        for i in self.instrs:
            for o in dict.fromkeys(i.operands):
                out[o].append(i.name)
        return out

    def remove_dead(self) -> None:
        """Drop instructions the root does not reach (parameters stay)."""
        idx = self.index()
        live = set()
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n in live:
                continue
            live.add(n)
            stack.extend(idx[n].operands)
        self.instrs = [i for i in self.instrs
                       if i.name in live or i.opcode == "parameter"]

    def text(self) -> str:
        params = ", ".join(f"{p.name}: {shape_text(p.shape, False)}"
                           for p in self.params)
        ret = shape_text(self.root_instr().shape, False)
        head = ("ENTRY " if self.is_entry else "") + f"%{self.name}"
        lines = [f"{head} ({params}) -> {ret} {{"]
        lines += [i.text(i.name == self.root) for i in self.instrs]
        lines.append("}")
        return "\n".join(lines)


class HloModule:
    def __init__(self, name: str):
        self.name = name
        self.computations: list[Computation] = []
        self._taken: set[str] = set()
        self._counters: dict[str, int] = {}
        #: reduce regions by kind and dtype, shared across the module
        self.regions: dict[str, str] = {}
        #: devices of the SPMD program (``num_partitions`` in the header)
        self.num_partitions = 1
        self._channels = 0

    def channel(self) -> int:
        """A fresh ``channel_id`` for a collective (1, 2, ...)."""
        self._channels += 1
        return self._channels

    def fresh(self, base: str) -> str:
        """A module-unique name from ``base``."""
        if base not in self._taken:
            self._taken.add(base)
            return base
        n = self._counters.get(base, 0)
        while True:
            n += 1
            cand = f"{base}.{n}"
            if cand not in self._taken:
                self._counters[base] = n
                self._taken.add(cand)
                return cand

    def new_computation(self, base: str, is_entry: bool = False) -> Computation:
        comp = Computation(self.fresh(base), is_entry)
        self.computations.append(comp)
        return comp

    @property
    def entry(self) -> Computation:
        return next(c for c in self.computations if c.is_entry)

    def text(self) -> str:
        entry = self.entry
        params = ", ".join(shape_text(p.shape) for p in entry.params)
        out = shape_text(entry.root_instr().shape)
        head = (f"HloModule {self.name}, is_scheduled=true, "
                f"entry_computation_layout={{({params})->{out}}}")
        if self.num_partitions > 1:
            head += f", num_partitions={self.num_partitions}"
        parts = [head, ""]
        for c in self.computations:
            if not c.is_entry:
                parts += [c.text(), ""]
        parts += [entry.text(), ""]
        return "\n".join(parts)
