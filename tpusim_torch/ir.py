"""ISA-independent trace IR.

Port of ``tpusim/ir.py``; the IR is identical, so trace dirs and
stats match the JAX package field for field.

This is the TPU rebuild of the reference's abstract hardware model IR
(``gpu-simulator/gpgpu-sim/src/abstract_hardware_model.h``: ``warp_inst_t``,
``kernel_info_t``, ``mem_access_t``).  Where the reference's IR is a per-warp
SASS instruction with per-lane addresses, ours is a per-device **HLO op**: the
unit of work XLA actually schedules onto a TensorCore.  The timing core
(:mod:`tpusim_torch.timing`) consumes only this IR; frontends — the live JAX capture
(:mod:`tpusim_torch.tracer`) or the stored-trace parser (:mod:`tpusim_torch.trace`) — are
swappable, mirroring the reference's ``exec_*`` vs ``trace_*`` class split
(``gpu-simulator/README.md:5-9``).
"""

from __future__ import annotations

import enum
import functools
import math
from dataclasses import dataclass, field
from typing import Iterator

# ---------------------------------------------------------------------------
# Dtypes
# ---------------------------------------------------------------------------

#: bits per element for every HLO primitive type we model.
DTYPE_BITS: dict[str, int] = {
    "pred": 8,
    "s2": 2, "u2": 2, "s4": 4, "u4": 4,
    "s8": 8, "u8": 8,
    "s16": 16, "u16": 16,
    "s32": 32, "u32": 32,
    "s64": 64, "u64": 64,
    "f8e4m3": 8, "f8e5m2": 8, "f8e4m3fn": 8, "f8e4m3b11fnuz": 8,
    "f8e5m2fnuz": 8, "f8e4m3fnuz": 8, "f8e3m4": 8, "f8e8m0fnu": 8,
    "f16": 16, "bf16": 16,
    "f32": 32, "f64": 64,
    "c64": 64, "c128": 128,
    "token": 0, "opaque": 0,
}


def dtype_bytes(dtype: str) -> float:
    """Bytes per element (may be fractional for sub-byte types)."""
    try:
        return DTYPE_BITS[dtype] / 8.0
    except KeyError:
        raise ValueError(f"unknown HLO dtype: {dtype!r}") from None


# ---------------------------------------------------------------------------
# Tensor shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype/layout of one HLO buffer.

    ``memory_space`` mirrors the ``S(n)`` annotation in TPU HLO layouts:
    0/absent = HBM ("default"), 1 = scalar memory (SMEM)... we keep the raw
    int and expose helpers.  ``tiling`` is the raw TPU tile string, e.g.
    ``"(8,128)(2,1)"`` — used by the MXU/VPU utilization model.
    """

    dtype: str
    shape: tuple[int, ...] = ()
    layout: tuple[int, ...] | None = None  # minor-to-major
    tiling: str | None = None
    memory_space: int = 0

    @property
    def rank(self) -> int:
        return len(self.shape)

    @functools.cached_property
    def elems(self) -> int:
        # cached: the schedule walk re-reads sizes tens of thousands of
        # times per run (cached_property writes to __dict__ directly,
        # which frozen dataclasses permit)
        return math.prod(self.shape) if self.shape else 1

    @functools.cached_property
    def nbytes(self) -> int:
        if self.dtype in ("token", "opaque"):
            return 0
        return int(math.ceil(self.elems * dtype_bytes(self.dtype)))

    def __str__(self) -> str:  # e.g. bf16[256,512]
        dims = ",".join(str(d) for d in self.shape)
        return f"{self.dtype}[{dims}]"


@dataclass(frozen=True)
class TupleSpec:
    """A tuple-shaped HLO value (e.g. async-start results, sort outputs)."""

    parts: tuple["TensorSpec | TupleSpec", ...] = ()

    @functools.cached_property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.parts)

    @functools.cached_property
    def elems(self) -> int:
        return sum(p.elems for p in self.parts)

    def leaves(self) -> Iterator[TensorSpec]:
        for p in self.parts:
            if isinstance(p, TupleSpec):
                yield from p.leaves()
            else:
                yield p

    def __str__(self) -> str:
        return "(" + ", ".join(str(p) for p in self.parts) + ")"


ShapeLike = TensorSpec | TupleSpec


def leaves_of(spec: ShapeLike) -> list[TensorSpec]:
    if isinstance(spec, TupleSpec):
        return list(spec.leaves())
    return [spec]


# ---------------------------------------------------------------------------
# Op categories (the "execution unit" routing — ISA_Def equivalent)
# ---------------------------------------------------------------------------


class Unit(enum.Enum):
    """Which TensorCore unit an op's cost is dominated by.

    The TPU-native analogue of the reference's opcode→unit categories
    (``gpu-simulator/ISA_Def/trace_opcode.h``, ``volta_opcode.h``): SP/DP/
    INT/SFU/TENSOR there; MXU/VPU/scalar/transpose/DMA/ICI here.
    """

    MXU = "mxu"            # systolic-array matmul / conv
    VPU = "vpu"            # vector elementwise / reduce
    SCALAR = "scalar"      # control, scalar compute, tiny ops
    TRANSPOSE = "xpose"    # transpose / permute unit
    DMA = "dma"            # HBM<->vmem / host<->HBM copies
    ICI = "ici"            # inter-chip collectives
    NONE = "none"          # free ops (bitcast, tuple, parameter, ...)


#: HLO opcodes that are pure data-movement / free at schedule time.
FREE_OPCODES = frozenset({
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "bitcast-convert", "after-all", "add-dependency", "partition-id",
    "replica-id", "domain", "opt-barrier", "get-dimension-size",
})

#: collective opcodes (plus their async -start/-done forms).
COLLECTIVE_OPCODES = frozenset({
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
})

#: opcodes the MXU executes.
MXU_OPCODES = frozenset({"dot", "convolution"})


def base_opcode(opcode: str) -> str:
    """Strip async ``-start``/``-done``/``-update`` suffixes.

    ``all-reduce-start`` → ``all-reduce``; ``copy-start`` → ``copy``.
    """
    for suffix in ("-start", "-done", "-update"):
        if opcode.endswith(suffix):
            return opcode[: -len(suffix)]
    return opcode


# ---------------------------------------------------------------------------
# Collective metadata
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectiveInfo:
    """Everything the ICI model needs to time one collective.

    The reference's NCCL path recorded *nothing* but the op kind
    (count/datatype are absent from its trace — SURVEY.md §5); recording
    sizes + replica groups here is the designed fix.
    """

    kind: str                                  # base opcode, e.g. "all-reduce"
    replica_groups: tuple[tuple[int, ...], ...] = ()
    channel_id: int | None = None
    use_global_device_ids: bool = False
    source_target_pairs: tuple[tuple[int, int], ...] = ()  # collective-permute
    split_dimension: int | None = None         # all-to-all
    dimensions: tuple[int, ...] = ()           # all-gather/reduce-scatter dim

    @property
    def group_size(self) -> int:
        if self.replica_groups:
            return max(len(g) for g in self.replica_groups)
        if self.source_target_pairs:
            return len({p for pair in self.source_target_pairs for p in pair})
        return 1


# ---------------------------------------------------------------------------
# Trace op + computations + module
# ---------------------------------------------------------------------------


@dataclass
class TraceOp:
    """One scheduled HLO instruction — the ``warp_inst_t`` of this framework."""

    name: str                       # HLO value name, no leading '%'
    opcode: str                     # raw opcode (may carry -start/-done)
    result: ShapeLike
    operands: tuple[str, ...] = ()
    called: tuple[str, ...] = ()    # called computation names (fusion/while/...)
    fusion_kind: str | None = None  # kLoop / kOutput / kInput / kCustom
    collective: CollectiveInfo | None = None
    attrs: dict[str, str] = field(default_factory=dict)
    metadata: dict[str, str] = field(default_factory=dict)
    is_root: bool = False

    # Cost annotations, filled by the parser/cost layer (not the frontend):
    flops: float = 0.0
    transcendentals: float = 0.0

    @property
    def base(self) -> str:
        # hot in the schedule walk: memoize per op (opcode never mutates
        # after parse)
        b = self.__dict__.get("_base")
        if b is None:
            b = base_opcode(self.opcode)
            self.__dict__["_base"] = b
        return b

    @property
    def is_async_start(self) -> bool:
        return self.opcode.endswith("-start") or self.opcode == "async-start"

    @property
    def is_async_done(self) -> bool:
        return self.opcode.endswith("-done") or self.opcode == "async-done"

    @property
    def is_collective(self) -> bool:
        return self.base in COLLECTIVE_OPCODES

    @property
    def out_bytes(self) -> int:
        return self.result.nbytes

    def __repr__(self) -> str:
        return f"TraceOp({self.name}: {self.opcode} -> {self.result})"


#: process-wide count of ops added to computations — the observable
#: behind the durable compile store's cold-path contract (a warm store
#: prices with zero IR construction).  A mutable holder, so the parse
#: loop pays no import or call to maintain it.
ir_build_counter = {"ops": 0}


@dataclass
class Computation:
    """One HLO computation: a named list of ops, in program (schedule) order."""

    name: str
    ops: list[TraceOp] = field(default_factory=list)
    is_entry: bool = False

    _by_name: dict[str, TraceOp] = field(default_factory=dict, repr=False)

    def add(self, op: TraceOp) -> None:
        self.ops.append(op)
        self._by_name[op.name] = op
        ir_build_counter["ops"] += 1

    def op(self, name: str) -> TraceOp:
        return self._by_name[name]

    def has_op(self, name: str) -> bool:
        return name in self._by_name

    @property
    def root(self) -> TraceOp:
        for op in self.ops:
            if op.is_root:
                return op
        return self.ops[-1]

    @property
    def parameters(self) -> list[TraceOp]:
        return [op for op in self.ops if op.opcode == "parameter"]


@dataclass
class ModuleTrace:
    """A full traced HLO module — the ``kernel_info_t`` of this framework.

    Entry computation order **is** the TPU schedule: XLA:TPU emits a fully
    sequential entry schedule with explicit async start/done pairs, so replay
    does not need a separate schedule file (unlike the reference, which must
    reconstruct warp interleavings from per-warp trace cursors,
    ``gpu-simulator/trace-driven/trace_driven.cc:57``).
    """

    name: str
    computations: dict[str, Computation] = field(default_factory=dict)
    entry_name: str | None = None
    # capture-time metadata (device kind, num_partitions/replicas, ...)
    meta: dict[str, object] = field(default_factory=dict)

    def add_computation(self, comp: Computation) -> None:
        self.computations[comp.name] = comp
        if comp.is_entry:
            self.entry_name = comp.name

    @property
    def entry(self) -> Computation:
        if self.entry_name is None:
            raise ValueError(f"module {self.name} has no ENTRY computation")
        return self.computations[self.entry_name]

    def computation(self, name: str) -> Computation:
        try:
            return self.computations[name]
        except KeyError:
            raise KeyError(
                f"module {self.name!r} has no computation {name!r} "
                f"(truncated trace?); has: {sorted(self.computations)[:8]}..."
            ) from None

    @property
    def num_partitions(self) -> int:
        return int(self.meta.get("num_partitions", 1))  # type: ignore[arg-type]

    @property
    def num_replicas(self) -> int:
        return int(self.meta.get("replica_count", 1))  # type: ignore[arg-type]

    @property
    def num_devices(self) -> int:
        return self.num_partitions * self.num_replicas

    def all_ops(self) -> Iterator[TraceOp]:
        for comp in self.computations.values():
            yield from comp.ops

    def collectives(self) -> list[TraceOp]:
        """Collective ops, each counted once (async ``-done`` halves are
        completion markers, not transfers)."""
        return [
            op for op in self.all_ops()
            if op.is_collective and not op.is_async_done
        ]


# ---------------------------------------------------------------------------
# Command stream (the kernelslist.g equivalent)
# ---------------------------------------------------------------------------


class CommandKind(enum.Enum):
    """Mirror of the reference's trace command types plus the NCCL additions
    (``gpu-simulator/trace-parser/trace_parser.h:16-27``)."""

    MEMCPY_H2D = "memcpy_h2d"
    MEMCPY_D2H = "memcpy_d2h"
    KERNEL_LAUNCH = "kernel_launch"
    COLLECTIVE = "collective"      # standalone cross-program collective
    COMM_INIT = "comm_init"        # ncclCommInitAll analogue (no-op, logged)
    COMM_DESTROY = "comm_destroy"
    GROUP_START = "group_start"
    GROUP_END = "group_end"


@dataclass
class TraceCommand:
    """One entry in a device's program stream."""

    kind: CommandKind
    stream_id: int = 0
    device_id: int = 0
    nbytes: int = 0                    # memcpy / standalone collective payload
    module: str | None = None          # kernel_launch: ModuleTrace name
    collective: CollectiveInfo | None = None
    attrs: dict[str, object] = field(default_factory=dict)


@dataclass
class DeviceTrace:
    """Per-device command stream — one per chip, like the fork's per-GPU
    ``kernel-<n>_<gpu>.trace`` sets (``tracer_tool.cu:442-445``)."""

    device_id: int
    commands: list[TraceCommand] = field(default_factory=list)


@dataclass
class PodTrace:
    """A full multi-chip capture: modules + per-device command streams +
    the topology they ran on."""

    modules: dict[str, ModuleTrace] = field(default_factory=dict)
    devices: dict[int, DeviceTrace] = field(default_factory=dict)
    meta: dict[str, object] = field(default_factory=dict)

    def device(self, device_id: int) -> DeviceTrace:
        if device_id not in self.devices:
            self.devices[device_id] = DeviceTrace(device_id)
        return self.devices[device_id]

    @property
    def num_devices(self) -> int:
        return max(len(self.devices), 1)
