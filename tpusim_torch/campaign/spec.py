"""Campaign specifications — the declarative half of
``tpusim_torch.campaign``.

A campaign spec is a JSON document describing a *population* of degraded
pods, not one schedule: how many simultaneous faults to expect (a count
distribution), which fault kinds and with what weights, the scale range
for degraded kinds, optional activation windows, and correlated failure
groups (all links sharing a cable bundle — or a whole torus axis — fail
together).  A PRNG seed makes every sampled campaign byte-reproducible.

Spec document::

    {
      "name": "k-fault what-if",
      "seed": 1234,
      "scenarios": 64,
      "arch": "v5p",
      "chips": 64,
      "tuned": true,
      "faults": {
        "count": {"dist": "poisson", "mean": 2.0},
        "kinds": {"link_down": 1.0, "link_degraded": 1.0,
                  "chip_straggler": 0.5, "hbm_throttle": 0.5},
        "scale": {"min": 0.4, "max": 0.9},
        "window": {"prob": 0.25, "horizon_cycles": 1e9}
      },
      "correlated_groups": [
        {"name": "bundle-x0", "prob": 0.05,
         "links": [[[0,0,0],[1,0,0]], [[0,1,0],[1,1,0]]]},
        {"name": "axis-z", "prob": 0.02, "axis": 2}
      ],
      "retries": 1,
      "backoff_s": 0.1,
      "slo": {"step_time_ms": 2.0, "percentile": 99},
      "candidate_slices": [{"arch": "v5p", "chips": 32},
                           {"arch": "v5p", "chips": 64}]
    }

``count.dist`` is one of ``fixed`` (``n``), ``uniform`` (integer
``min``/``max`` inclusive) or ``poisson`` (``mean``).  ``kinds`` maps
:data:`tpusim_torch.faults.FAULT_KINDS` names to sampling weights (a bare list
means equal weights).  ``slo``/``candidate_slices`` are optional
together: when present, the campaign answers "what is the smallest
candidate slice that still meets ``step_time_ms`` at ``percentile``
under this degradation model?".

Naming caveat: ``candidate_slices`` are campaign "slices" — pod-SIZE
variants of one campaign (the key predates the multi-slice fabric and
is kept for back-compat).  TPU hardware slices are configured by the
optional ``dcn`` block (:mod:`tpusim_torch.dcn.spec`: ``num_slices``,
``nics_per_slice``, ``nic_bandwidth``, ``hop_latency``,
``oversubscription``), which stands up a modeled DCN fabric over every
candidate shape and is required before ``faults.kinds`` may sample the
DCN kinds (``dcn_link_down``/``dcn_link_degraded``/``slice_down``).

Validation raises :class:`CampaignSpecError` carrying a stable TL2xx
diagnostic code (``TL210`` format, ``TL211`` candidate slices, ``TL212``
SLO percentile) so the static analyzer
(:mod:`tpusim_torch.analysis.campaign_passes`) can anchor findings without
duplicating the rules; the topology-aware group check (``TL213``) lives
in the analyzer because it needs the bound torus.

Port of ``tpusim/campaign/spec.py``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.faults.schedule import FAULT_KINDS

__all__ = [
    "CampaignSpec",
    "CampaignSpecError",
    "CorrelatedGroup",
    "CountDist",
    "FaultModel",
    "SliceSpec",
    "SloSpec",
    "load_campaign_spec",
    "spec_hash",
]

#: hard ceiling on scenarios per slice — a typo'd spec must not queue a
#: month of pricing (the serve tier shares this bound)
MAX_SCENARIOS = 4096

#: keeps the Knuth poisson sampler's rejection loop bounded
MAX_POISSON_MEAN = 64.0


class CampaignSpecError(ValueError):
    """A campaign spec failed validation.  ``code`` is the stable
    diagnostic code the static analyzer reports it under."""

    def __init__(self, message: str, code: str = "TL210"):
        self.code = code
        super().__init__(message)


def _require(cond: bool, msg: str, code: str = "TL210") -> None:
    if not cond:
        raise CampaignSpecError(msg, code=code)


def _num(doc: dict, key: str, default, *, where: str):
    v = doc.get(key, default)
    _require(
        isinstance(v, (int, float)) and not isinstance(v, bool),
        f"{where}: {key!r} must be a number, got {v!r}",
    )
    return v


@dataclass(frozen=True)
class CountDist:
    """Per-scenario simultaneous-fault count distribution."""

    dist: str = "fixed"          # fixed | uniform | poisson
    n: int = 1                   # fixed
    lo: int = 0                  # uniform (inclusive)
    hi: int = 4
    mean: float = 2.0            # poisson

    @classmethod
    def parse(cls, doc) -> "CountDist":
        if doc is None:
            return cls()
        _require(isinstance(doc, dict),
                 f"faults.count must be an object, got {doc!r}")
        dist = doc.get("dist", "fixed")
        _require(dist in ("fixed", "uniform", "poisson"),
                 f"faults.count.dist must be fixed/uniform/poisson, "
                 f"got {dist!r}")
        if dist == "fixed":
            n = _num(doc, "n", 1, where="faults.count")
            _require(float(n).is_integer() and 0 <= n <= MAX_SCENARIOS,
                     f"faults.count.n must be a small non-negative "
                     f"integer, got {n!r}")
            return cls(dist=dist, n=int(n))
        if dist == "uniform":
            lo = _num(doc, "min", 0, where="faults.count")
            hi = _num(doc, "max", 4, where="faults.count")
            _require(
                float(lo).is_integer() and float(hi).is_integer()
                and 0 <= lo <= hi <= MAX_SCENARIOS,
                f"faults.count uniform needs integers "
                f"0 <= min <= max <= {MAX_SCENARIOS}, "
                f"got [{lo!r}, {hi!r}]",
            )
            return cls(dist=dist, lo=int(lo), hi=int(hi))
        mean = _num(doc, "mean", 2.0, where="faults.count")
        _require(0.0 <= mean <= MAX_POISSON_MEAN,
                 f"faults.count.mean must be in [0, {MAX_POISSON_MEAN}], "
                 f"got {mean!r}")
        return cls(dist=dist, mean=float(mean))

    def sample(self, rng) -> int:
        if self.dist == "fixed":
            return self.n
        if self.dist == "uniform":
            return rng.randint(self.lo, self.hi)
        # Knuth's poisson sampler — pure rng.random() draws, so the
        # stream is deterministic for a seeded random.Random
        import math

        limit = math.exp(-self.mean)
        k, p = 0, 1.0
        while True:
            p *= rng.random()
            if p <= limit:
                return k
            k += 1


@dataclass(frozen=True)
class FaultModel:
    """What one sampled fault looks like."""

    count: CountDist = field(default_factory=CountDist)
    #: (kind, weight) sorted by kind NAME: sampling iterates this, and
    #: the reproducibility contract is over the spec's canonical
    #: (sorted-keys) JSON — two documents listing the same kinds in a
    #: different order are the same campaign and must sample the same
    #: schedules (a persisted serve job round-trips through sort_keys)
    kinds: tuple[tuple[str, float], ...] = (("link_down", 1.0),)
    scale_min: float = 0.5
    scale_max: float = 0.9
    window_prob: float = 0.0
    window_horizon: float = 1e9

    @classmethod
    def parse(cls, doc) -> "FaultModel":
        if doc is None:
            return cls()
        _require(isinstance(doc, dict),
                 f"'faults' must be an object, got {doc!r}")
        extra = set(doc) - {"count", "kinds", "scale", "window"}
        _require(not extra, f"faults: unknown field(s) {sorted(extra)}")
        count = CountDist.parse(doc.get("count"))
        kinds_doc = doc.get("kinds", ["link_down"])
        if isinstance(kinds_doc, list):
            kinds_doc = {k: 1.0 for k in kinds_doc}
        _require(isinstance(kinds_doc, dict) and kinds_doc,
                 f"faults.kinds must be a non-empty list or "
                 f"kind->weight map, got {kinds_doc!r}")
        kinds: list[tuple[str, float]] = []
        for k, w in sorted(kinds_doc.items()):
            _require(k in FAULT_KINDS,
                     f"faults.kinds: unknown fault kind {k!r} "
                     f"(valid: {sorted(FAULT_KINDS)})")
            _require(
                isinstance(w, (int, float)) and not isinstance(w, bool)
                and w > 0,
                f"faults.kinds[{k!r}]: weight must be > 0, got {w!r}",
            )
            kinds.append((k, float(w)))
        scale = doc.get("scale") or {}
        _require(isinstance(scale, dict),
                 f"faults.scale must be an object, got {scale!r}")
        lo = _num(scale, "min", 0.5, where="faults.scale")
        hi = _num(scale, "max", 0.9, where="faults.scale")
        _require(0.0 < lo <= hi <= 1.0,
                 f"faults.scale must satisfy 0 < min <= max <= 1, "
                 f"got [{lo!r}, {hi!r}]")
        window = doc.get("window") or {}
        _require(isinstance(window, dict),
                 f"faults.window must be an object, got {window!r}")
        prob = _num(window, "prob", 0.0, where="faults.window")
        _require(0.0 <= prob <= 1.0,
                 f"faults.window.prob must be in [0, 1], got {prob!r}")
        horizon = _num(window, "horizon_cycles", 1e9,
                       where="faults.window")
        _require(horizon > 0,
                 f"faults.window.horizon_cycles must be > 0, "
                 f"got {horizon!r}")
        return cls(
            count=count, kinds=tuple(kinds),
            scale_min=float(lo), scale_max=float(hi),
            window_prob=float(prob), window_horizon=float(horizon),
        )


@dataclass(frozen=True)
class CorrelatedGroup:
    """Links that fail together: an explicit cable-bundle link list, or
    a whole torus axis (every link whose endpoints differ along it)."""

    name: str
    prob: float
    links: tuple[tuple[tuple[int, ...], tuple[int, ...]], ...] = ()
    axis: int | None = None

    @classmethod
    def parse(cls, i: int, doc) -> "CorrelatedGroup":
        where = f"correlated_groups[{i}]"
        _require(isinstance(doc, dict), f"{where}: not an object: {doc!r}")
        name = doc.get("name", f"group-{i}")
        _require(isinstance(name, str) and name,
                 f"{where}: 'name' must be a non-empty string")
        prob = _num(doc, "prob", None, where=where) \
            if "prob" in doc else None
        _require(prob is not None and 0.0 < prob <= 1.0,
                 f"{where}: 'prob' must be in (0, 1], got {prob!r}")
        has_links = "links" in doc
        has_axis = "axis" in doc
        _require(has_links != has_axis,
                 f"{where}: exactly one of 'links' or 'axis' is required")
        if has_axis:
            axis = doc["axis"]
            _require(
                isinstance(axis, int) and not isinstance(axis, bool)
                and axis >= 0,
                f"{where}: 'axis' must be a non-negative integer, "
                f"got {axis!r}",
            )
            return cls(name=name, prob=float(prob), axis=axis)
        links_doc = doc["links"]
        _require(isinstance(links_doc, list) and links_doc,
                 f"{where}: 'links' must be a non-empty list")
        links = []
        for j, pair in enumerate(links_doc):
            ok = (
                isinstance(pair, list) and len(pair) == 2
                and all(
                    isinstance(ep, list) and ep
                    and all(isinstance(x, int) and not isinstance(x, bool)
                            and x >= 0 for x in ep)
                    for ep in pair
                )
            )
            _require(ok,
                     f"{where}.links[{j}]: must be a "
                     f"[src_coords, dst_coords] pair, got {pair!r}")
            links.append((tuple(pair[0]), tuple(pair[1])))
        return cls(name=name, prob=float(prob), links=tuple(links))

    def resolve_links(self, topo) -> list[tuple[int, int]]:
        """Chip-id link list on a concrete torus.  Explicit links are
        resolved by coordinates; an axis group expands to every
        undirected link whose endpoints differ along that axis.
        Raises :class:`CampaignSpecError` (code TL213) on a link that
        is not a torus edge or an axis the torus does not have."""
        if self.axis is not None:
            if self.axis >= topo.ndims:
                raise CampaignSpecError(
                    f"correlated group {self.name!r}: axis {self.axis} "
                    f"out of range for {topo.ndims}D torus "
                    f"{list(topo.dims)}",
                    code="TL213",
                )
            return [
                (a, b) for a, b in topo.undirected_links()
                if topo.coords(a)[self.axis] != topo.coords(b)[self.axis]
            ]
        out = []
        for src, dst in self.links:
            for name, ep in (("src", src), ("dst", dst)):
                if len(ep) != topo.ndims or any(
                    x >= d for x, d in zip(ep, topo.dims)
                ):
                    raise CampaignSpecError(
                        f"correlated group {self.name!r}: {name} coords "
                        f"{list(ep)} not on the {topo.ndims}D torus "
                        f"{list(topo.dims)}",
                        code="TL213",
                    )
            a, b = topo.chip_at(src), topo.chip_at(dst)
            if a == b or topo.hop_distance(a, b) != 1:
                raise CampaignSpecError(
                    f"correlated group {self.name!r}: no ICI link "
                    f"between {list(src)} and {list(dst)} "
                    f"(not torus neighbors)",
                    code="TL213",
                )
            out.append((min(a, b), max(a, b)))
        return out


@dataclass(frozen=True)
class SliceSpec:
    """One candidate pod shape."""

    arch: str
    chips: int

    @property
    def label(self) -> str:
        return f"{self.arch}-{self.chips}"

    @classmethod
    def parse(cls, i: int, doc, default_arch: str) -> "SliceSpec":
        where = f"candidate_slices[{i}]"
        _require(isinstance(doc, dict), f"{where}: not an object: {doc!r}",
                 code="TL211")
        extra = set(doc) - {"arch", "chips"}
        _require(not extra, f"{where}: unknown field(s) {sorted(extra)}",
                 code="TL211")
        arch = doc.get("arch", default_arch)
        _require(isinstance(arch, str) and arch,
                 f"{where}: 'arch' must be a non-empty string",
                 code="TL211")
        chips = doc.get("chips")
        _require(
            isinstance(chips, int) and not isinstance(chips, bool)
            and chips >= 1,
            f"{where}: 'chips' must be a positive integer, got {chips!r}",
            code="TL211",
        )
        return cls(arch=arch, chips=chips)


@dataclass(frozen=True)
class SloSpec:
    """The capacity question: step time at a percentile."""

    step_time_ms: float
    percentile: float

    @classmethod
    def parse(cls, doc) -> "SloSpec":
        _require(isinstance(doc, dict),
                 f"'slo' must be an object, got {doc!r}")
        extra = set(doc) - {"step_time_ms", "percentile"}
        _require(not extra, f"slo: unknown field(s) {sorted(extra)}")
        ms = _num(doc, "step_time_ms", None, where="slo") \
            if "step_time_ms" in doc else None
        _require(ms is not None and ms > 0,
                 f"slo.step_time_ms must be > 0, got {ms!r}")
        pct = _num(doc, "percentile", 99.0, where="slo")
        _require(0.0 < pct <= 100.0,
                 f"slo.percentile must be in (0, 100], got {pct!r}",
                 code="TL212")
        return cls(step_time_ms=float(ms), percentile=float(pct))


@dataclass(frozen=True)
class CampaignSpec:
    """A validated campaign: the sampling model plus the candidate pod
    shapes to price it on.

    Terminology: campaign "slices" (:class:`SliceSpec`,
    ``candidate_slices``) are pod-SIZE variants of one campaign — a
    naming that predates the multi-slice fabric and is kept for spec
    back-compat.  TPU hardware slices (ICI domains joined by DCN) are
    the ``dcn`` block's ``num_slices``; see the glossary in
    docs/ARCHITECTURE.md."""

    name: str
    seed: int
    scenarios: int
    arch: str
    chips: int | None
    tuned: bool
    faults: FaultModel
    groups: tuple[CorrelatedGroup, ...]
    retries: int
    backoff_s: float
    slo: SloSpec | None
    candidates: tuple[SliceSpec, ...]
    #: the modeled multi-slice DCN fabric (None = single slice / flat
    #: scalar model) — a :class:`tpusim_torch.dcn.DcnBlock`
    dcn: object | None = None
    #: the raw document, canonicalized — the identity :func:`spec_hash`
    #: and the journal header are computed from
    doc: dict = field(repr=False, hash=False, compare=False,
                      default_factory=dict)

    def primary_slice(self, default_chips: int) -> SliceSpec:
        return SliceSpec(arch=self.arch,
                         chips=self.chips or default_chips)

    def slices(self, default_chips: int) -> list[SliceSpec]:
        """Primary slice first, then candidates (dedup'd by label so a
        candidate equal to the primary prices once)."""
        out = [self.primary_slice(default_chips)]
        seen = {out[0].label}
        for c in self.candidates:
            if c.label not in seen:
                seen.add(c.label)
                out.append(c)
        return out


_TOP_FIELDS = {
    "name", "seed", "scenarios", "arch", "chips", "tuned", "faults",
    "correlated_groups", "retries", "backoff_s", "slo",
    "candidate_slices", "dcn",
}


def load_campaign_spec(src) -> CampaignSpec:
    """Load and validate a campaign spec from a path, JSON text, or
    dict.  Raises :class:`CampaignSpecError` (with a stable TL2xx code)
    on any violation — a campaign must fail here, before anything is
    priced, never mid-run on scenario 412."""
    if isinstance(src, CampaignSpec):
        return src
    if isinstance(src, (str, Path)) and not (
        isinstance(src, str) and src.lstrip().startswith("{")
    ):
        p = Path(src)
        if not p.is_file():
            raise CampaignSpecError(f"campaign spec not found: {p}")
        try:
            doc = json.loads(p.read_text())
        except json.JSONDecodeError as e:
            raise CampaignSpecError(f"{p}: invalid JSON: {e}") from e
    elif isinstance(src, str):
        try:
            doc = json.loads(src)
        except json.JSONDecodeError as e:
            raise CampaignSpecError(f"invalid spec JSON: {e}") from e
    else:
        doc = src
    _require(isinstance(doc, dict),
             f"campaign spec must be a JSON object, got {type(doc).__name__}")
    extra = set(doc) - _TOP_FIELDS
    _require(not extra, f"campaign spec: unknown field(s) {sorted(extra)}")

    name = doc.get("name", "campaign")
    _require(isinstance(name, str) and name,
             f"'name' must be a non-empty string, got {name!r}")
    seed = doc.get("seed", 0)
    _require(isinstance(seed, int) and not isinstance(seed, bool),
             f"'seed' must be an integer, got {seed!r}")
    scenarios = doc.get("scenarios", 16)
    _require(
        isinstance(scenarios, int) and not isinstance(scenarios, bool)
        and 1 <= scenarios <= MAX_SCENARIOS,
        f"'scenarios' must be an integer in [1, {MAX_SCENARIOS}], "
        f"got {scenarios!r}",
    )
    arch = doc.get("arch", "v5p")
    _require(isinstance(arch, str) and arch,
             f"'arch' must be a non-empty string, got {arch!r}")
    chips = doc.get("chips")
    _require(
        chips is None or (
            isinstance(chips, int) and not isinstance(chips, bool)
            and chips >= 1
        ),
        f"'chips' must be a positive integer, got {chips!r}",
    )
    tuned = doc.get("tuned", True)
    _require(isinstance(tuned, bool),
             f"'tuned' must be a boolean, got {tuned!r}")
    faults = FaultModel.parse(doc.get("faults"))
    dcn = None
    if doc.get("dcn") is not None:
        from tpusim_torch.dcn.spec import DcnBlock, DcnSpecError

        try:
            dcn = DcnBlock.parse(doc["dcn"])
        except DcnSpecError as e:
            raise CampaignSpecError(str(e), code="TL230") from e
    from tpusim_torch.faults.schedule import _DCN_KINDS

    dcn_kinds = [k for k, _w in faults.kinds if k in _DCN_KINDS]
    _require(
        not dcn_kinds or dcn is not None,
        f"faults.kinds samples DCN fault kind(s) {dcn_kinds} but the "
        f"spec has no 'dcn' block — a DCN fault needs a configured "
        f"fabric to degrade",
        code="TL231",
    )
    groups_doc = doc.get("correlated_groups", [])
    _require(isinstance(groups_doc, list),
             f"'correlated_groups' must be a list, got {groups_doc!r}")
    groups = tuple(
        CorrelatedGroup.parse(i, g) for i, g in enumerate(groups_doc)
    )
    _require(len({g.name for g in groups}) == len(groups),
             "correlated_groups: duplicate group names")
    retries = doc.get("retries", 1)
    _require(
        isinstance(retries, int) and not isinstance(retries, bool)
        and 0 <= retries <= 8,
        f"'retries' must be an integer in [0, 8], got {retries!r}",
    )
    backoff_s = _num(doc, "backoff_s", 0.1, where="campaign spec")
    _require(backoff_s >= 0,
             f"'backoff_s' must be >= 0, got {backoff_s!r}")

    slo = SloSpec.parse(doc["slo"]) if doc.get("slo") is not None else None
    cands_doc = doc.get("candidate_slices")
    if cands_doc is not None:
        _require(isinstance(cands_doc, list),
                 f"'candidate_slices' must be a list, got {cands_doc!r}",
                 code="TL211")
        _require(bool(cands_doc),
                 "'candidate_slices' is empty — the capacity question "
                 "needs at least one candidate pod shape",
                 code="TL211")
        candidates = tuple(
            SliceSpec.parse(i, c, arch) for i, c in enumerate(cands_doc)
        )
    else:
        candidates = ()
    _require(slo is None or candidates,
             "'slo' given without 'candidate_slices' — the capacity "
             "answer needs candidate pod shapes to choose from",
             code="TL211")

    return CampaignSpec(
        name=name, seed=seed, scenarios=scenarios, arch=arch,
        chips=chips, tuned=tuned, faults=faults, groups=groups,
        retries=retries, backoff_s=float(backoff_s), slo=slo,
        candidates=candidates, dcn=dcn, doc=doc,
    )


def spec_hash(spec: CampaignSpec) -> str:
    """Content identity of a campaign: sha256 over the canonical JSON of
    the raw document.  The journal header carries it so ``--resume``
    refuses to splice two different campaigns into one report."""
    canon = json.dumps(spec.doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]
