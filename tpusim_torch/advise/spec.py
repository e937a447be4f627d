"""Advise specifications — the declarative half of ``tpusim_torch.advise``.

Port of ``tpusim/advise/spec.py``.

An advise spec describes the strategy space to sweep for one traced
workload: which parallelism strategies to consider, which pod slices
(arch preset x chip count) to price them on, optional user-pinned mesh
combos, and an optional step-time SLO every ranked cell is flagged
against.  The sweep itself (:mod:`tpusim_torch.advise.runner`) prices the
cross-product ``slices x strategies x meshes`` through the shared
engine-result cache.

Spec document::

    {
      "name": "llama-tiny-advise",
      "strategies": ["dp", "tp", "dp_tp", "sp", "pp"],
      "slices": [{"arch": "v5p", "chips": 8},
                 {"arch": "v5e", "chips": 8}],
      "meshes": [{"dp": 4, "tp": 2}],
      "microbatches": 4,
      "tuned": false,
      "max_cells": 64,
      "slo": {"step_time_ms": 1.0}
    }

The optional ``dcn`` block (:mod:`tpusim_torch.dcn.spec`) stands a modeled
multi-slice DCN fabric up over every candidate slice: mesh axes whose
collective groups outgrow one TPU slice then price hierarchically over
the fabric (dp-over-DCN x tp-over-ICI cells), each ranked row carries a
``dcn`` field naming its spanning axes, and the dp/tp crossover falls
out of the ranking as ``nic_bandwidth`` moves.

``strategies`` names the families to enumerate (``dp`` pure data
parallel, ``tp`` pure tensor parallel, ``dp_tp`` every composite
dp x tp factorization of the slice, ``sp`` ring-attention sequence
parallel, ``pp`` pipeline parallel with ``microbatches`` microbatches,
``ep`` expert parallel — priced only when the capture carries
all-to-all collectives).  ``meshes`` pins explicit combos on top of the
enumerated ones; each pinned mesh must factor at least one slice's chip
count exactly.  ``slices`` defaults to the capture's own pod size and
its doubling on v5p when omitted.

Validation raises :class:`AdviseSpecError` carrying a stable TL22x
diagnostic code (``TL220`` format, ``TL221`` unknown strategy,
``TL224`` SLO without candidate slices) so the static analyzer
(:mod:`tpusim_torch.analysis.advise_passes`) can anchor findings without
duplicating the rules; the slice-aware checks (``TL222`` mesh does not
factor the slice, ``TL223`` slice without an arch preset) live in the
analyzer because they need the composed slice list.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "AdviseSpec",
    "AdviseSpecError",
    "MeshSpec",
    "SliceSpec",
    "STRATEGIES",
    "load_advise_spec",
    "spec_hash",
]

#: the strategy families the transform layer can synthesize (the
#: MULTICHIP dryrun workload classes: dp/tp train, ring attention sp,
#: MoE ep, pipeline pp — MULTICHIP_r02-r05)
STRATEGIES: tuple[str, ...] = ("dp", "tp", "dp_tp", "sp", "pp", "ep")

#: mesh axis names a pinned combo may use, in canonical order
MESH_AXES: tuple[str, ...] = ("dp", "tp", "sp", "pp", "ep")

#: hard ceiling on priced cells — a typo'd spec must not queue a day of
#: pricing (the serve tier shares this bound)
MAX_CELLS = 512

#: pipeline microbatch ceiling (keeps synthesized command streams sane)
MAX_MICROBATCHES = 64

#: slice-size ceiling — a shade above the largest real pod (v5p-8960);
#: /v1/advise accepts specs remotely, and synthesized pods are O(chips)
#: command streams, so an absurd chip count must fail validation
MAX_SLICE_CHIPS = 16384


class AdviseSpecError(ValueError):
    """An advise spec failed validation.  ``code`` is the stable
    diagnostic code the static analyzer reports it under."""

    def __init__(self, message: str, code: str = "TL220"):
        self.code = code
        super().__init__(message)


def _require(cond: bool, msg: str, code: str = "TL220") -> None:
    if not cond:
        raise AdviseSpecError(msg, code=code)


@dataclass(frozen=True)
class SliceSpec:
    """One candidate pod shape to price the strategy space on."""

    arch: str
    chips: int

    @property
    def label(self) -> str:
        return f"{self.arch}-{self.chips}"

    @classmethod
    def parse(cls, i: int, doc) -> "SliceSpec":
        where = f"slices[{i}]"
        _require(isinstance(doc, dict), f"{where}: not an object: {doc!r}")
        extra = set(doc) - {"arch", "chips"}
        _require(not extra, f"{where}: unknown field(s) {sorted(extra)}")
        arch = doc.get("arch")
        _require(isinstance(arch, str) and bool(arch),
                 f"{where}: 'arch' must be a non-empty string, got {arch!r}")
        chips = doc.get("chips")
        _require(
            isinstance(chips, int) and not isinstance(chips, bool)
            and 1 <= chips <= MAX_SLICE_CHIPS,
            f"{where}: 'chips' must be an integer in "
            f"[1, {MAX_SLICE_CHIPS}], got {chips!r}",
        )
        return cls(arch=arch, chips=chips)


@dataclass(frozen=True)
class MeshSpec:
    """One pinned parallelism combo: mesh axis name -> degree."""

    axes: tuple[tuple[str, int], ...]   # canonical MESH_AXES order

    @property
    def product(self) -> int:
        out = 1
        for _, v in self.axes:
            out *= v
        return out

    @property
    def label(self) -> str:
        return "x".join(f"{k}{v}" for k, v in self.axes if v > 1) or "dp1"

    def degree(self, axis: str) -> int:
        for k, v in self.axes:
            if k == axis:
                return v
        return 1

    @classmethod
    def parse(cls, i: int, doc) -> "MeshSpec":
        where = f"meshes[{i}]"
        _require(isinstance(doc, dict) and doc,
                 f"{where}: must be a non-empty axis->degree object, "
                 f"got {doc!r}")
        extra = set(doc) - set(MESH_AXES)
        _require(
            not extra,
            f"{where}: unknown mesh axis(es) {sorted(extra)} "
            f"(valid: {list(MESH_AXES)})",
        )
        axes = []
        for k in MESH_AXES:
            if k not in doc:
                continue
            v = doc[k]
            _require(
                isinstance(v, int) and not isinstance(v, bool) and v >= 1,
                f"{where}.{k}: degree must be a positive integer, "
                f"got {v!r}",
            )
            axes.append((k, v))
        return cls(axes=tuple(axes))


@dataclass(frozen=True)
class SloSpec:
    """The feasibility question: a step-time bound every cell is
    flagged against."""

    step_time_ms: float

    @classmethod
    def parse(cls, doc) -> "SloSpec":
        _require(isinstance(doc, dict),
                 f"'slo' must be an object, got {doc!r}")
        extra = set(doc) - {"step_time_ms"}
        _require(not extra, f"slo: unknown field(s) {sorted(extra)}")
        ms = doc.get("step_time_ms")
        _require(
            isinstance(ms, (int, float)) and not isinstance(ms, bool)
            and ms > 0,
            f"slo.step_time_ms must be > 0, got {ms!r}",
        )
        return cls(step_time_ms=float(ms))


@dataclass(frozen=True)
class AdviseSpec:
    """A validated advise sweep: the strategy space plus the slices to
    price it on."""

    name: str
    strategies: tuple[str, ...]
    slices: tuple[SliceSpec, ...]      # () = default from the capture
    meshes: tuple[MeshSpec, ...]
    microbatches: int                  # 0 = pipeline degree
    tuned: bool
    max_cells: int
    slo: SloSpec | None
    #: the modeled multi-slice DCN fabric (None = single slice) — a
    #: :class:`tpusim_torch.dcn.DcnBlock`
    dcn: object | None = None
    #: the raw document, canonicalized — :func:`spec_hash` identity
    doc: dict = field(repr=False, hash=False, compare=False,
                      default_factory=dict)

    def resolved_slices(self, default_chips: int) -> tuple[SliceSpec, ...]:
        """Explicit slices, or the default pair: the capture's own pod
        size and its doubling, both on v5p (the generation the MULTICHIP
        dryruns model)."""
        if self.slices:
            return self.slices
        n = max(default_chips, 1)
        out = [SliceSpec(arch="v5p", chips=n)]
        if 2 * n != n:
            out.append(SliceSpec(arch="v5p", chips=2 * n))
        return tuple(out)


_TOP_FIELDS = {
    "name", "strategies", "slices", "meshes", "microbatches", "tuned",
    "max_cells", "slo", "dcn",
}


def load_advise_spec(src) -> AdviseSpec:
    """Load and validate an advise spec from a path, JSON text, or dict.
    Raises :class:`AdviseSpecError` (with a stable TL22x code) on any
    violation — the sweep must fail here, before anything prices."""
    if isinstance(src, AdviseSpec):
        return src
    if isinstance(src, (str, Path)) and not (
        isinstance(src, str) and src.lstrip().startswith("{")
    ):
        p = Path(src)
        if not p.is_file():
            raise AdviseSpecError(f"advise spec not found: {p}")
        try:
            doc = json.loads(p.read_text())
        except json.JSONDecodeError as e:
            raise AdviseSpecError(f"{p}: invalid JSON: {e}") from e
    elif isinstance(src, str):
        try:
            doc = json.loads(src)
        except json.JSONDecodeError as e:
            raise AdviseSpecError(f"invalid spec JSON: {e}") from e
    else:
        doc = src
    _require(isinstance(doc, dict),
             f"advise spec must be a JSON object, got {type(doc).__name__}")
    extra = set(doc) - _TOP_FIELDS
    _require(not extra, f"advise spec: unknown field(s) {sorted(extra)}")

    name = doc.get("name", "advise")
    _require(isinstance(name, str) and bool(name),
             f"'name' must be a non-empty string, got {name!r}")

    strategies_doc = doc.get("strategies", ["dp", "tp", "dp_tp"])
    _require(isinstance(strategies_doc, list) and bool(strategies_doc),
             f"'strategies' must be a non-empty list, "
             f"got {strategies_doc!r}")
    strategies: list[str] = []
    for s in strategies_doc:
        _require(
            isinstance(s, str) and s in STRATEGIES,
            f"unknown parallelism strategy {s!r} "
            f"(valid: {list(STRATEGIES)})",
            code="TL221",
        )
        if s not in strategies:
            strategies.append(s)

    slices_doc = doc.get("slices")
    if slices_doc is not None:
        _require(isinstance(slices_doc, list),
                 f"'slices' must be a list, got {slices_doc!r}")
        slices = tuple(
            SliceSpec.parse(i, s) for i, s in enumerate(slices_doc)
        )
    else:
        slices = ()

    meshes_doc = doc.get("meshes", [])
    _require(isinstance(meshes_doc, list),
             f"'meshes' must be a list, got {meshes_doc!r}")
    meshes = tuple(MeshSpec.parse(i, m) for i, m in enumerate(meshes_doc))

    microbatches = doc.get("microbatches", 0)
    _require(
        isinstance(microbatches, int) and not isinstance(microbatches, bool)
        and 0 <= microbatches <= MAX_MICROBATCHES,
        f"'microbatches' must be an integer in [0, {MAX_MICROBATCHES}] "
        f"(0 = the pipeline degree), got {microbatches!r}",
    )

    tuned = doc.get("tuned", True)
    _require(isinstance(tuned, bool),
             f"'tuned' must be a boolean, got {tuned!r}")

    max_cells = doc.get("max_cells", 64)
    _require(
        isinstance(max_cells, int) and not isinstance(max_cells, bool)
        and 1 <= max_cells <= MAX_CELLS,
        f"'max_cells' must be an integer in [1, {MAX_CELLS}], "
        f"got {max_cells!r}",
    )

    dcn = None
    if doc.get("dcn") is not None:
        from tpusim_torch.dcn.spec import DcnBlock, DcnSpecError

        try:
            dcn = DcnBlock.parse(doc["dcn"])
        except DcnSpecError as e:
            raise AdviseSpecError(str(e), code="TL230") from e

    slo = SloSpec.parse(doc["slo"]) if doc.get("slo") is not None else None
    _require(
        slo is None or slices_doc is None or bool(slices),
        "'slo' given without candidate slices — the feasibility flag "
        "needs pod shapes to rank",
        code="TL224",
    )

    return AdviseSpec(
        name=name, strategies=tuple(strategies), slices=slices,
        meshes=meshes, microbatches=microbatches, tuned=tuned,
        max_cells=max_cells, slo=slo, dcn=dcn, doc=doc,
    )


def spec_hash(spec: AdviseSpec) -> str:
    """Content identity of an advise sweep: sha256 over the canonical
    JSON of the raw document (the report doc carries it)."""
    canon = json.dumps(spec.doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]
