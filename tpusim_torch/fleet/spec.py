"""Fleet specifications — the declarative half of :mod:`tpusim_torch.fleet`.

A fleet spec is a JSON document describing one serving-fleet what-if:
how many pods of which slice shape, what traffic arrives (an open-loop
arrival process with a request-class mix), what breaks while it serves
(a campaign-style seeded fault stream plus whole-pod loss events), which
admission policies govern each pod (the exact knobs the serve daemon
exposes as flags), and the capacity questions to answer (a latency SLO
and a pods-needed frontier).  A PRNG seed makes every sampled fleet
byte-reproducible.

Spec document::

    {
      "name": "prod what-if",
      "seed": 7,
      "pods": 3,
      "arch": "v5p",
      "chips": 8,
      "tuned": true,
      "horizon_s": 120.0,
      "traffic": {
        "shape": "bursty",
        "load_points": [20.0, 60.0],
        "burst": {"factor": 4.0, "fraction": 0.1, "period_s": 20.0},
        "diurnal": {"amplitude": 0.5, "period_s": 60.0},
        "mix": [{"name": "chat", "weight": 3.0, "steps": 1},
                {"name": "batch", "weight": 1.0, "steps": 8}]
      },
      "faults": {
        "count": {"dist": "poisson", "mean": 1.5},
        "kinds": {"link_down": 1.0, "hbm_throttle": 0.5},
        "scale": {"min": 0.4, "max": 0.9},
        "window": {"min_s": 5.0, "max_s": 30.0},
        "pod_loss": {"prob": 0.5}
      },
      "correlated_groups": [
        {"name": "axis-z", "prob": 0.1, "axis": 2}
      ],
      "policies": {
        "max_inflight": 1,
        "queue_depth": 16,
        "deadline_s": 0.5,
        "restart_backoff_s": 5.0
      },
      "recovery": {"dcn_gbps": 25.0},
      "dcn": {"num_slices": 2, "nics_per_slice": 4,
              "nic_bandwidth": 25e9},
      "slo": {"latency_ms": 400.0, "percentile": 99},
      "frontier": {"target_rps": [40.0], "max_pods": 6}
    }

``traffic.shape`` is one of ``poisson`` (homogeneous), ``bursty``
(on/off modulated, mean preserved) or ``diurnal`` (sinusoidal);
``load_points`` are the offered req/s values the goodput/p99 curve is
simulated at.  ``faults`` reuses the campaign count-distribution and
the :data:`tpusim_torch.faults.FAULT_KINDS` table, but every sampled fault is
WINDOWED in fleet seconds (``window.min_s``..``max_s`` long, anywhere in
the horizon); ``pod_loss.prob`` is the per-pod probability of one
whole-pod crash, healed after ``policies.restart_backoff_s``.

The optional ``dcn`` block (:mod:`tpusim_torch.dcn.spec`) stands a modeled
multi-slice DCN fabric up over every pod: it is required before
``faults.kinds`` may sample the DCN kinds
(``dcn_link_down``/``dcn_link_degraded``/``slice_down``), and when
present the recovery migration prices over the fabric's per-slice
injection bandwidth instead of the flat ``recovery.dcn_gbps`` constant
(kept as the back-compat path for fabric-less specs).

``policies`` maps 1:1 onto the serve daemon's flags — ``max_inflight``
↔ ``--max-inflight``, ``queue_depth`` ↔ ``--queue-depth``,
``deadline_s`` ↔ the request ``deadline_ms`` budget (guard's
cooperative-cancel 504), ``restart_backoff_s`` ↔ ``--restart-backoff``
— so the twin's knobs ARE the daemon's, not a parallel abstraction.

Validation raises :class:`FleetSpecError` carrying a stable TL24x
diagnostic code (``TL240`` format/policies, ``TL241`` traffic model,
``TL242`` SLO/frontier) so the static analyzer
(:mod:`tpusim_torch.analysis.fleet_passes`) can anchor findings without
duplicating the rules; the topology-aware group check (``TL243``) lives
in the analyzer because it needs the bound torus.

Port of ``tpusim/fleet/spec.py``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.campaign.spec import CorrelatedGroup, CountDist
from tpusim_torch.faults.schedule import FAULT_KINDS

__all__ = [
    "FleetFaultModel",
    "FleetSpec",
    "FleetSpecError",
    "FrontierSpec",
    "LatencySlo",
    "Policies",
    "RecoveryModel",
    "RequestClass",
    "TrafficModel",
    "load_fleet_spec",
    "spec_hash",
]

#: hard ceiling on sampled arrivals per cell — a typo'd rate x horizon
#: must not queue a month of event-walking (the serve tier shares this)
MAX_ARRIVALS_PER_CELL = 200_000

#: fleet-size ceilings (the frontier search shares them)
MAX_PODS = 64
MAX_LOAD_POINTS = 16
MAX_HORIZON_S = 86_400.0


class FleetSpecError(ValueError):
    """A fleet spec failed validation.  ``code`` is the stable
    diagnostic code the static analyzer reports it under."""

    def __init__(self, message: str, code: str = "TL240"):
        self.code = code
        super().__init__(message)


def _require(cond: bool, msg: str, code: str = "TL240") -> None:
    if not cond:
        raise FleetSpecError(msg, code=code)


def _num(doc: dict, key: str, default, *, where: str, code: str = "TL240"):
    v = doc.get(key, default)
    _require(
        isinstance(v, (int, float)) and not isinstance(v, bool),
        f"{where}: {key!r} must be a number, got {v!r}",
        code=code,
    )
    return v


@dataclass(frozen=True)
class RequestClass:
    """One slice of the request mix: a weight and a service size in
    pod steps (a batch job is N steps of the traced workload)."""

    name: str
    weight: float
    steps: int

    @classmethod
    def parse(cls, i: int, doc) -> "RequestClass":
        where = f"traffic.mix[{i}]"
        _require(isinstance(doc, dict), f"{where}: not an object: {doc!r}",
                 code="TL241")
        extra = set(doc) - {"name", "weight", "steps"}
        _require(not extra, f"{where}: unknown field(s) {sorted(extra)}",
                 code="TL241")
        name = doc.get("name", f"class-{i}")
        _require(isinstance(name, str) and name,
                 f"{where}: 'name' must be a non-empty string",
                 code="TL241")
        weight = _num(doc, "weight", 1.0, where=where, code="TL241")
        _require(weight > 0, f"{where}: 'weight' must be > 0, "
                             f"got {weight!r}", code="TL241")
        steps = doc.get("steps", 1)
        _require(
            isinstance(steps, int) and not isinstance(steps, bool)
            and 1 <= steps <= 4096,
            f"{where}: 'steps' must be an integer in [1, 4096], "
            f"got {steps!r}",
            code="TL241",
        )
        return cls(name=name, weight=float(weight), steps=steps)


@dataclass(frozen=True)
class TrafficModel:
    """The open-loop arrival process + request-class mix."""

    shape: str = "poisson"          # poisson | bursty | diurnal
    load_points: tuple[float, ...] = (10.0,)
    burst_factor: float = 4.0
    burst_fraction: float = 0.1
    burst_period_s: float = 20.0
    diurnal_amplitude: float = 0.5
    diurnal_period_s: float = 60.0
    mix: tuple[RequestClass, ...] = (
        RequestClass(name="default", weight=1.0, steps=1),
    )

    def peak_factor(self) -> float:
        """Ratio of the instantaneous peak rate to the mean — bounds the
        thinning envelope and the arrival-count ceiling."""
        if self.shape == "bursty":
            return self.burst_factor
        if self.shape == "diurnal":
            return 1.0 + self.diurnal_amplitude
        return 1.0

    @classmethod
    def parse(cls, doc, horizon_s: float) -> "TrafficModel":
        if doc is None:
            doc = {}
        _require(isinstance(doc, dict),
                 f"'traffic' must be an object, got {doc!r}", code="TL241")
        extra = set(doc) - {"shape", "load_points", "burst", "diurnal",
                            "mix"}
        _require(not extra, f"traffic: unknown field(s) {sorted(extra)}",
                 code="TL241")
        shape = doc.get("shape", "poisson")
        _require(shape in ("poisson", "bursty", "diurnal"),
                 f"traffic.shape must be poisson/bursty/diurnal, "
                 f"got {shape!r}", code="TL241")
        points_doc = doc.get("load_points", [10.0])
        _require(
            isinstance(points_doc, list) and points_doc
            and len(points_doc) <= MAX_LOAD_POINTS,
            f"traffic.load_points must be a non-empty list of at most "
            f"{MAX_LOAD_POINTS} rates, got {points_doc!r}",
            code="TL241",
        )
        points = []
        for i, p in enumerate(points_doc):
            _require(
                isinstance(p, (int, float)) and not isinstance(p, bool)
                and p > 0,
                f"traffic.load_points[{i}] must be a positive req/s "
                f"rate, got {p!r}",
                code="TL241",
            )
            points.append(float(p))
        burst = doc.get("burst") or {}
        _require(isinstance(burst, dict),
                 f"traffic.burst must be an object, got {burst!r}",
                 code="TL241")
        factor = _num(burst, "factor", 4.0, where="traffic.burst",
                      code="TL241")
        fraction = _num(burst, "fraction", 0.1, where="traffic.burst",
                        code="TL241")
        period = _num(burst, "period_s", 20.0, where="traffic.burst",
                      code="TL241")
        _require(factor >= 1.0 and 0.0 < fraction < 1.0 and period > 0,
                 f"traffic.burst needs factor >= 1, 0 < fraction < 1, "
                 f"period_s > 0; got {burst!r}", code="TL241")
        _require(factor * fraction <= 1.0,
                 f"traffic.burst: factor * fraction must be <= 1 (the "
                 f"off-burst rate would go negative), got "
                 f"{factor!r} * {fraction!r}", code="TL241")
        diurnal = doc.get("diurnal") or {}
        _require(isinstance(diurnal, dict),
                 f"traffic.diurnal must be an object, got {diurnal!r}",
                 code="TL241")
        amplitude = _num(diurnal, "amplitude", 0.5,
                         where="traffic.diurnal", code="TL241")
        dperiod = _num(diurnal, "period_s", 60.0,
                       where="traffic.diurnal", code="TL241")
        _require(0.0 <= amplitude < 1.0 and dperiod > 0,
                 f"traffic.diurnal needs 0 <= amplitude < 1, "
                 f"period_s > 0; got {diurnal!r}", code="TL241")
        mix_doc = doc.get("mix")
        if mix_doc is None:
            mix = (RequestClass(name="default", weight=1.0, steps=1),)
        else:
            _require(isinstance(mix_doc, list) and mix_doc,
                     f"traffic.mix must be a non-empty list, "
                     f"got {mix_doc!r}", code="TL241")
            mix = tuple(
                RequestClass.parse(i, c) for i, c in enumerate(mix_doc)
            )
            _require(len({c.name for c in mix}) == len(mix),
                     "traffic.mix: duplicate class names", code="TL241")
        model = cls(
            shape=shape, load_points=tuple(points),
            burst_factor=float(factor), burst_fraction=float(fraction),
            burst_period_s=float(period),
            diurnal_amplitude=float(amplitude),
            diurnal_period_s=float(dperiod), mix=mix,
        )
        peak = model.peak_factor()
        for p in points:
            _require(
                p * peak * horizon_s <= MAX_ARRIVALS_PER_CELL,
                f"traffic.load_points: {p:g} req/s x {horizon_s:g}s "
                f"horizon (peak factor {peak:g}) samples more than "
                f"{MAX_ARRIVALS_PER_CELL} arrivals per cell — shrink "
                f"the horizon or the rate",
                code="TL241",
            )
        return model


@dataclass(frozen=True)
class FleetFaultModel:
    """The degradation stream: campaign-style sampled faults, windowed
    in fleet seconds, plus whole-pod loss events."""

    count: CountDist = field(default_factory=CountDist)
    kinds: tuple[tuple[str, float], ...] = (("link_down", 1.0),)
    scale_min: float = 0.5
    scale_max: float = 0.9
    window_min_s: float = 5.0
    window_max_s: float = 30.0
    pod_loss_prob: float = 0.0

    @classmethod
    def parse(cls, doc, horizon_s: float) -> "FleetFaultModel":
        # the window DEFAULTS clamp to the horizon: a short-horizon
        # spec that never mentions windows must not be refused over
        # values it never wrote (explicit values still validate hard)
        wmax_d = min(30.0, horizon_s)
        wmin_d = min(5.0, wmax_d)
        if doc is None:
            return cls(window_min_s=wmin_d, window_max_s=wmax_d)
        _require(isinstance(doc, dict),
                 f"'faults' must be an object, got {doc!r}")
        extra = set(doc) - {"count", "kinds", "scale", "window",
                            "pod_loss"}
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
        wmin = _num(window, "min_s", wmin_d, where="faults.window")
        wmax = _num(window, "max_s", wmax_d, where="faults.window")
        _require(0.0 < wmin <= wmax <= horizon_s,
                 f"faults.window needs 0 < min_s <= max_s <= horizon_s "
                 f"({horizon_s:g}), got [{wmin!r}, {wmax!r}]")
        loss = doc.get("pod_loss") or {}
        _require(isinstance(loss, dict),
                 f"faults.pod_loss must be an object, got {loss!r}")
        extra = set(loss) - {"prob"}
        _require(not extra,
                 f"faults.pod_loss: unknown field(s) {sorted(extra)}")
        prob = _num(loss, "prob", 0.0, where="faults.pod_loss")
        _require(0.0 <= prob <= 1.0,
                 f"faults.pod_loss.prob must be in [0, 1], got {prob!r}")
        return cls(
            count=count, kinds=tuple(kinds),
            scale_min=float(lo), scale_max=float(hi),
            window_min_s=float(wmin), window_max_s=float(wmax),
            pod_loss_prob=float(prob),
        )


@dataclass(frozen=True)
class Policies:
    """Per-pod admission policy — the serve daemon's real flags."""

    max_inflight: int = 1        # serve --max-inflight
    queue_depth: int = 16        # serve --queue-depth (429 past it)
    deadline_s: float = 1.0      # request deadline_ms budget (504)
    restart_backoff_s: float = 5.0   # serve --restart-backoff

    @classmethod
    def parse(cls, doc) -> "Policies":
        if doc is None:
            return cls()
        _require(isinstance(doc, dict),
                 f"'policies' must be an object, got {doc!r}")
        extra = set(doc) - {"max_inflight", "queue_depth", "deadline_s",
                            "restart_backoff_s"}
        _require(not extra,
                 f"policies: unknown field(s) {sorted(extra)}")
        mi = doc.get("max_inflight", 1)
        _require(
            isinstance(mi, int) and not isinstance(mi, bool)
            and 1 <= mi <= 64,
            f"policies.max_inflight must be an integer in [1, 64], "
            f"got {mi!r}",
        )
        qd = doc.get("queue_depth", 16)
        _require(
            isinstance(qd, int) and not isinstance(qd, bool)
            and 0 <= qd <= 4096,
            f"policies.queue_depth must be an integer in [0, 4096], "
            f"got {qd!r}",
        )
        dl = _num(doc, "deadline_s", 1.0, where="policies")
        _require(dl > 0, f"policies.deadline_s must be > 0, got {dl!r}")
        rb = _num(doc, "restart_backoff_s", 5.0, where="policies")
        _require(rb >= 0,
                 f"policies.restart_backoff_s must be >= 0, got {rb!r}")
        return cls(max_inflight=mi, queue_depth=qd,
                   deadline_s=float(dl), restart_backoff_s=float(rb))


@dataclass(frozen=True)
class RecoveryModel:
    """Elastic-recovery pricing knobs (pod-loss re-shard migration).

    ``dcn_gbps`` is the flat-constant back-compat path: it prices the
    migration only when the spec has no ``dcn`` block; with a modeled
    fabric the migration goes through
    :meth:`tpusim_torch.dcn.DcnFabric.transfer_seconds` instead."""

    dcn_gbps: float = 25.0

    @classmethod
    def parse(cls, doc) -> "RecoveryModel":
        if doc is None:
            return cls()
        _require(isinstance(doc, dict),
                 f"'recovery' must be an object, got {doc!r}")
        extra = set(doc) - {"dcn_gbps"}
        _require(not extra,
                 f"recovery: unknown field(s) {sorted(extra)}")
        g = _num(doc, "dcn_gbps", 25.0, where="recovery")
        _require(g > 0, f"recovery.dcn_gbps must be > 0, got {g!r}")
        return cls(dcn_gbps=float(g))


@dataclass(frozen=True)
class LatencySlo:
    """The serving SLO: request latency at a percentile."""

    latency_ms: float
    percentile: float

    @classmethod
    def parse(cls, doc) -> "LatencySlo":
        _require(isinstance(doc, dict),
                 f"'slo' must be an object, got {doc!r}", code="TL242")
        extra = set(doc) - {"latency_ms", "percentile"}
        _require(not extra, f"slo: unknown field(s) {sorted(extra)}",
                 code="TL242")
        ms = _num(doc, "latency_ms", None, where="slo", code="TL242") \
            if "latency_ms" in doc else None
        _require(ms is not None and ms > 0,
                 f"slo.latency_ms must be > 0, got {ms!r}", code="TL242")
        pct = _num(doc, "percentile", 99.0, where="slo", code="TL242")
        _require(0.0 < pct <= 100.0,
                 f"slo.percentile must be in (0, 100], got {pct!r}",
                 code="TL242")
        return cls(latency_ms=float(ms), percentile=float(pct))


@dataclass(frozen=True)
class FrontierSpec:
    """The capacity-frontier question: pods needed per target rate."""

    target_rps: tuple[float, ...]
    max_pods: int

    @classmethod
    def parse(cls, doc, horizon_s: float, peak: float) -> "FrontierSpec":
        _require(isinstance(doc, dict),
                 f"'frontier' must be an object, got {doc!r}",
                 code="TL242")
        extra = set(doc) - {"target_rps", "max_pods"}
        _require(not extra,
                 f"frontier: unknown field(s) {sorted(extra)}",
                 code="TL242")
        targets_doc = doc.get("target_rps")
        _require(
            isinstance(targets_doc, list) and targets_doc
            and len(targets_doc) <= MAX_LOAD_POINTS,
            f"frontier.target_rps must be a non-empty list of at most "
            f"{MAX_LOAD_POINTS} rates, got {targets_doc!r}",
            code="TL242",
        )
        targets = []
        for i, p in enumerate(targets_doc):
            _require(
                isinstance(p, (int, float)) and not isinstance(p, bool)
                and p > 0
                and p * peak * horizon_s <= MAX_ARRIVALS_PER_CELL,
                f"frontier.target_rps[{i}] must be a positive rate "
                f"within the per-cell arrival ceiling, got {p!r}",
                code="TL242",
            )
            targets.append(float(p))
        mp = doc.get("max_pods", 8)
        _require(
            isinstance(mp, int) and not isinstance(mp, bool)
            and 1 <= mp <= MAX_PODS,
            f"frontier.max_pods must be an integer in [1, {MAX_PODS}], "
            f"got {mp!r}",
            code="TL242",
        )
        return cls(target_rps=tuple(targets), max_pods=mp)


@dataclass(frozen=True)
class FleetSpec:
    """A validated fleet what-if: pods, traffic, degradation, policies,
    and the capacity questions."""

    name: str
    seed: int
    pods: int
    arch: str
    chips: int | None
    tuned: bool
    horizon_s: float
    traffic: TrafficModel
    faults: FleetFaultModel
    groups: tuple[CorrelatedGroup, ...]
    policies: Policies
    recovery: RecoveryModel
    slo: LatencySlo | None
    frontier: FrontierSpec | None
    #: the modeled multi-slice DCN fabric (None = single slice / flat
    #: constant recovery) — a :class:`tpusim_torch.dcn.DcnBlock`
    dcn: object | None = None
    #: the raw document, canonicalized — :func:`spec_hash` and the
    #: journal header are computed from it
    doc: dict = field(repr=False, hash=False, compare=False,
                      default_factory=dict)

    def max_pods_modeled(self) -> int:
        """Pods whose fault streams must be sampled: the spec fleet plus
        whatever the frontier search will stand up."""
        return max(
            self.pods,
            self.frontier.max_pods if self.frontier is not None else 0,
        )


_TOP_FIELDS = {
    "name", "seed", "pods", "arch", "chips", "tuned", "horizon_s",
    "traffic", "faults", "correlated_groups", "policies", "recovery",
    "slo", "frontier", "dcn",
}


def load_fleet_spec(src) -> FleetSpec:
    """Load and validate a fleet spec from a path, JSON text, or dict.
    Raises :class:`FleetSpecError` (with a stable TL24x code) on any
    violation — a fleet run must fail here, before anything is priced,
    never mid-simulation."""
    if isinstance(src, FleetSpec):
        return src
    if isinstance(src, (str, Path)) and not (
        isinstance(src, str) and src.lstrip().startswith("{")
    ):
        p = Path(src)
        if not p.is_file():
            raise FleetSpecError(f"fleet spec not found: {p}")
        try:
            doc = json.loads(p.read_text())
        except json.JSONDecodeError as e:
            raise FleetSpecError(f"{p}: invalid JSON: {e}") from e
    elif isinstance(src, str):
        try:
            doc = json.loads(src)
        except json.JSONDecodeError as e:
            raise FleetSpecError(f"invalid spec JSON: {e}") from e
    else:
        doc = src
    _require(isinstance(doc, dict),
             f"fleet spec must be a JSON object, got {type(doc).__name__}")
    extra = set(doc) - _TOP_FIELDS
    _require(not extra, f"fleet spec: unknown field(s) {sorted(extra)}")

    name = doc.get("name", "fleet")
    _require(isinstance(name, str) and name,
             f"'name' must be a non-empty string, got {name!r}")
    seed = doc.get("seed", 0)
    _require(isinstance(seed, int) and not isinstance(seed, bool),
             f"'seed' must be an integer, got {seed!r}")
    pods = doc.get("pods", 1)
    _require(
        isinstance(pods, int) and not isinstance(pods, bool)
        and 1 <= pods <= MAX_PODS,
        f"'pods' must be an integer in [1, {MAX_PODS}], got {pods!r}",
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
    horizon_s = _num(doc, "horizon_s", 60.0, where="fleet spec")
    _require(0.0 < horizon_s <= MAX_HORIZON_S,
             f"'horizon_s' must be in (0, {MAX_HORIZON_S:g}], "
             f"got {horizon_s!r}")
    horizon_s = float(horizon_s)

    traffic = TrafficModel.parse(doc.get("traffic"), horizon_s)
    faults = FleetFaultModel.parse(doc.get("faults"), horizon_s)
    groups_doc = doc.get("correlated_groups", [])
    _require(isinstance(groups_doc, list),
             f"'correlated_groups' must be a list, got {groups_doc!r}")
    from tpusim_torch.campaign.spec import CampaignSpecError

    try:
        groups = tuple(
            CorrelatedGroup.parse(i, g) for i, g in enumerate(groups_doc)
        )
    except CampaignSpecError as e:
        # the group grammar is campaign's verbatim; re-tag its refusal
        # under the fleet code family so callers catch ONE error type
        raise FleetSpecError(str(e), code="TL240") from e
    _require(len({g.name for g in groups}) == len(groups),
             "correlated_groups: duplicate group names")
    policies = Policies.parse(doc.get("policies"))
    recovery = RecoveryModel.parse(doc.get("recovery"))
    dcn = None
    if doc.get("dcn") is not None:
        from tpusim_torch.dcn.spec import DcnBlock, DcnSpecError

        try:
            dcn = DcnBlock.parse(doc["dcn"])
        except DcnSpecError as e:
            raise FleetSpecError(str(e), code="TL230") from e
    from tpusim_torch.faults.schedule import _DCN_KINDS

    dcn_kinds = [k for k, _w in faults.kinds if k in _DCN_KINDS]
    _require(
        not dcn_kinds or dcn is not None,
        f"faults.kinds samples DCN fault kind(s) {dcn_kinds} but the "
        f"spec has no 'dcn' block — a DCN fault needs a configured "
        f"fabric to degrade",
        code="TL231",
    )
    slo = LatencySlo.parse(doc["slo"]) if doc.get("slo") is not None \
        else None
    frontier = None
    if doc.get("frontier") is not None:
        frontier = FrontierSpec.parse(
            doc["frontier"], horizon_s, traffic.peak_factor(),
        )
    _require(frontier is None or slo is not None,
             "'frontier' given without 'slo' — the pods-needed answer "
             "needs a latency SLO to meet",
             code="TL242")

    return FleetSpec(
        name=name, seed=seed, pods=pods, arch=arch, chips=chips,
        tuned=tuned, horizon_s=horizon_s, traffic=traffic,
        faults=faults, groups=groups, policies=policies,
        recovery=recovery, slo=slo, frontier=frontier, dcn=dcn,
        doc=doc,
    )


def spec_hash(spec: FleetSpec) -> str:
    """Content identity of a fleet spec: sha256 over the canonical JSON
    of the raw document.  The journal header carries it so ``--resume``
    refuses to splice two different fleets into one report."""
    canon = json.dumps(spec.doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]
