"""Stats-key contract pass: static audit of the report-key namespaces.

The greppable ``tpusim_*`` report is a public contract — scrapers,
goldens, and the obs/faults schemas all key on it.  PR 1 and PR 2 each
reserved a namespace (``obs_*``, ``faults_*``) with a no-op-default
discipline; ``ici_*`` names the shared interconnect field/track family.
Nothing enforced any of that until now.  This pass scans the *source*
of the subsystems that stamp stats (string literals + ``prefix=``
kwargs, via a token-level scan — no imports, so a broken module still
lints) and checks:

* **ownership** (TL301) — a key in a reserved namespace may only be
  introduced by the subsystem that owns it (the driver, which assembles
  the report, is a licensed writer for all of them);
* **documented prefixes** (TL302) — every ``update(..., prefix=...)``
  namespace injection must use a prefix from the registry below;
* **schema agreement** (TL303) — every key ``ci/faults_schema.json``
  requires when a schedule is active must actually be produced
  somewhere in the audited sources.

Port of ``tpusim/analysis/statskeys.py``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["PACKAGE", "STATS_NAMESPACES", "run_statskey_passes"]

#: the package whose sources the registry below names; an audit of
#: another package's tree (the reference's ``tpusim``, whose layout the
#: port mirrors) reads every path with this prefix swapped for its name
PACKAGE = "tpusim_torch"

#: namespace prefix -> repo-relative paths (files or directory prefixes)
#: licensed to introduce keys in it.  The driver and CLI assemble the
#: final report, so they may stamp any namespace; schemas document them.
STATS_NAMESPACES: dict[str, tuple[str, ...]] = {
    "obs_": (
        "tpusim_torch/obs/", "tpusim_torch/sim/driver.py", "tpusim_torch/sim/stats.py",
        "tpusim_torch/__main__.py",
    ),
    "faults_": (
        "tpusim_torch/faults/", "tpusim_torch/sim/driver.py",
        "ci/faults_schema.json", "ci/check_golden.py",
    ),
    # the interconnect field family is shared by design: the engine
    # accumulates ici_bytes, the sampler carries the lane, the exports
    # derive ici_occupancy/ici_gbps tracks; the advisor's report rows
    # and the CLI's ranked table carry the same ici_bytes meaning
    # verbatim (one name, one meaning, more surfaces)
    # tpusim/fastpath/ carries the engine's ici_bytes column through
    # its compiled columns verbatim (one name, one meaning)
    "ici_": (
        "tpusim_torch/ici/", "tpusim_torch/obs/", "tpusim_torch/timing/engine.py",
        "tpusim_torch/sim/driver.py", "tpusim_torch/advise/", "tpusim_torch/__main__.py",
        "tpusim_torch/fastpath/",
    ),
    # the performance layer (PR 4): result-cache effectiveness
    # (hits/misses/evictions + disk tier) — stamped by the driver only
    # when a cache is active, mirrored as obs counters by tpusim.perf.
    # tpusim.serve is licensed too: every request prices through a
    # per-request view of the shared cache, and the response's
    # `cache_hit` field is the serving layer's designed bridge to it
    "cache_": (
        "tpusim_torch/perf/", "tpusim_torch/sim/driver.py", "tpusim_torch/__main__.py",
        "tpusim_torch/serve/", "bench.py", "ci/check_golden.py",
    ),
    # worker-pool accounting (worker count, parallel segments) — stamped
    # by the driver only when the pool actually engaged
    "pool_": (
        "tpusim_torch/perf/", "tpusim_torch/sim/driver.py", "tpusim_torch/__main__.py",
        "ci/check_golden.py",
    ),
    # the serving layer (PR 5, extended by serve v2): daemon request/
    # admission/job counters plus the supervised worker-pool gauges
    # (serve_workers_alive, serve_worker_restarts_total,
    # serve_worker_kills_total, serve_quarantine_size,
    # serve_shed_503_total, ...) exported on /metrics (prometheus
    # gauges, not report lines) — minted only by tpusim.serve and the
    # CI serve smokes
    "serve_": (
        "tpusim_torch/serve/", "ci/check_golden.py",
    ),
    # the campaign layer (PR 6): Monte-Carlo executor accounting
    # (scenarios priced/resumed, partition + failure counts, retries) —
    # stamped only when a campaign actually ran; tpusim.serve mirrors
    # them on /metrics for async campaign jobs
    "campaign_": (
        "tpusim_torch/campaign/", "tpusim_torch/serve/", "tpusim_torch/__main__.py",
        "ci/check_golden.py",
    ),
    # the pricing fastpath (PR 8, durable tier PR 12): compiled-pricing
    # accounting (resolved backend, compiled-module cache hits/misses,
    # durable-store hits/writes) — stamped by the driver ONLY when a
    # --pricing-backend was explicitly requested or a --compile-cache
    # store is active (the cache_*/pool_* discipline: default
    # auto-fastpath runs stay key-identical, which is what keeps the
    # golden matrix byte-stable with the fastpath on); tpusim.serve
    # mirrors the block on /metrics when the store is mounted.
    # fastpath_batch* (PR 19): scenario-batched pricing accounting —
    # minted exclusively by fastpath/batch.py BatchStats.stats_dict()
    # and carried on CampaignResult/FleetResult.batch_stats (printed by
    # the CLI only when a batch pass engaged); NEVER report bytes, so
    # batched and per-state runs stay byte-identical by construction
    "fastpath_": (
        "tpusim_torch/fastpath/", "tpusim_torch/sim/driver.py", "tpusim_torch/__main__.py",
        "tpusim_torch/serve/", "bench.py", "ci/check_golden.py",
    ),
    # resource governance (tpusim.guard): store-quota/GC accounting,
    # memory-watchdog gauges, cooperative-cancellation counters —
    # stamped on reports ONLY when a quota is actually governing, and
    # on /metrics only when a guard feature (quota / --max-rss /
    # startup sweep) is active; un-governed runs stay key-identical
    "guard_": (
        "tpusim_torch/guard/", "tpusim_torch/perf/", "tpusim_torch/sim/driver.py",
        "tpusim_torch/serve/", "tpusim_torch/__main__.py", "ci/check_golden.py",
    ),
    # the fleet digital twin (tpusim.fleet): traffic-driven serving-
    # simulation accounting (requests served, per-policy loss
    # attribution, priced degradation states, pod losses) — stamped
    # only when a fleet twin actually ran (the campaign_* discipline:
    # healthy simulate reports never carry them); tpusim.serve mirrors
    # the totals on /metrics for async fleet jobs
    "fleet_": (
        "tpusim_torch/fleet/", "tpusim_torch/serve/", "tpusim_torch/__main__.py",
        "ci/check_golden.py",
    ),
    # the sharding advisor (PR 7): strategy-sweep executor accounting
    # (cells priced/skipped/feasible) — stamped only when an advise
    # sweep actually ran (the faults_* discipline: healthy simulate
    # reports never carry them); tpusim.serve mirrors the totals on
    # /metrics for async advise jobs
    "advise_": (
        "tpusim_torch/advise/", "tpusim_torch/serve/", "tpusim_torch/__main__.py",
        "ci/check_golden.py",
    ),
    # request-scoped tracing (L24): per-route/per-phase latency
    # histogram state + flight-recorder counters, exported on /metrics
    # ONLY when `--trace-requests` is active (the guard_* discipline:
    # tracing off means zero reqtrace keys and byte-identical
    # responses).  Key literals are minted by tpusim/obs/reqtrace.py
    # alone — the serving layer and CLI carry them opaquely through
    # metrics_values()/the fleet merge, which is what keeps the
    # one-writer collision audit clean
    "reqtrace_": (
        "tpusim_torch/obs/", "tpusim_torch/serve/", "tpusim_torch/__main__.py",
        "ci/check_golden.py",
    ),
    # the multi-slice DCN fabric (tpusim.dcn): a shared FIELD FAMILY by
    # design — the DCN fault kinds (dcn_link_down/dcn_link_degraded)
    # named by the faults schema and samplers, the config knobs the
    # fabric overlay writes (dcn_nics_per_slice/dcn_hop_bandwidth/...),
    # the fleet recovery back-compat knob (dcn_gbps), and the driver's
    # dcn_* report block (stamped ONLY when a fabric is configured and
    # the pod spans slices — fabric-less runs stay key-identical) carry
    # one prefix with one meaning across the dcn, faults, campaign, and
    # fleet packages
    "dcn_": (
        "tpusim_torch/dcn/", "tpusim_torch/faults/", "tpusim_torch/campaign/",
        "tpusim_torch/fleet/", "tpusim_torch/advise/", "tpusim_torch/sim/driver.py",
        "tpusim_torch/__main__.py", "ci/check_golden.py",
        "ci/faults_schema.json",
    ),
    # the multi-node cluster (PR 17, tpusim.serve.cluster): membership
    # epoch + join/beat/death/stale-rejoin counters and the forwarding/
    # shed accounting, exported on /metrics ONLY when the daemon is
    # actually clustered (a registry materialized or `--join`
    # succeeded) — the reqtrace_/guard_ discipline at node grain: a
    # never-joined daemon's scrape is key-identical, pinned by test.
    # The directory owner covers cluster.py, daemon.py, and front.py;
    # the CLI plumbs --join and the CI cluster smoke asserts the heal.
    "cluster_": (
        "tpusim_torch/serve/", "tpusim_torch/__main__.py", "ci/check_golden.py",
    ),
}

#: keys deliberately shared across surfaces, with the subsystems licensed
#: to carry them.  ``faults_active`` is PR 2's designed bridge: the
#: faults package stamps it as a report key AND the obs export derives
#: the same-named samples column / Perfetto counter track from the
#: "faults" lane — one name, one meaning, two surfaces.
SHARED_KEYS: dict[str, tuple[str, ...]] = {
    "faults_active": ("tpusim_torch/faults", "tpusim_torch/obs", "tpusim_torch/sim"),
    # serve v3's hot-response tier folds a cold response's per-request
    # cache accounting to its warm form (every get that missed cold
    # hits on replay), so the serving layer must name the exact pair
    # the driver stamps; the CLI's profile summary prints the same two
    # keys — one name, one meaning, more surfaces
    "cache_hits": (
        "tpusim_torch/perf", "tpusim_torch/sim", "tpusim_torch/serve",
        "tpusim_torch/__main__.py",
    ),
    "cache_misses": (
        "tpusim_torch/perf", "tpusim_torch/sim", "tpusim_torch/serve",
        "tpusim_torch/__main__.py",
    ),
}

#: prefixes `StatsRegistry.update(..., prefix=...)` may inject; "" is the
#: merge-in-place form, "tot_" the engine-totals block
DOCUMENTED_UPDATE_PREFIXES = frozenset(
    set(STATS_NAMESPACES) | {"", "tot_"}
)

#: namespaces whose keys are shared FIELD FAMILIES by design (many
#: writers, one meaning) and therefore exempt from the one-writer
#: collision audit; every other registered namespace is owned
SHARED_FIELD_FAMILIES = frozenset({"ici_", "dcn_"})

#: single-writer namespaces for the collision pass — derived from the
#: registry so a newly registered prefix is audited automatically
_OWNED_PREFIXES = tuple(
    sorted(set(STATS_NAMESPACES) - SHARED_FIELD_FAMILIES)
)

#: the source files whose stats-key surface is audited
AUDIT_GLOBS = (
    "tpusim_torch/sim/stats.py",
    "tpusim_torch/sim/driver.py",
    "tpusim_torch/__main__.py",
    "tpusim_torch/obs/*.py",
    "tpusim_torch/faults/*.py",
    "tpusim_torch/ici/*.py",
    "tpusim_torch/dcn/*.py",
    "tpusim_torch/perf/*.py",
    "tpusim_torch/fastpath/*.py",
    "tpusim_torch/serve/*.py",
    "tpusim_torch/campaign/*.py",
    "tpusim_torch/advise/*.py",
    "tpusim_torch/fleet/*.py",
    "tpusim_torch/guard/*.py",
    "tpusim_torch/timing/engine.py",
)

#: reserved-key literal matcher, derived from the namespace registry so
#: a prefix registered above is audited automatically
_KEY_RE = re.compile(
    r"""["']((?:%s)_[a-z0-9_.]+)["']"""
    % "|".join(sorted(p.rstrip("_") for p in STATS_NAMESPACES))
)
_PREFIX_KWARG_RE = re.compile(
    r"""prefix\s*=\s*["']([a-z0-9_.]*)["']"""
)


def _relocate(path: str, package: str) -> str:
    """``path`` of the registry, in ``package``'s tree."""
    if path == PACKAGE or path.startswith(PACKAGE + "/"):
        return package + path[len(PACKAGE):]
    return path


def _registry(package: str) -> tuple[dict, dict]:
    """(namespace owners, shared-key licensees) in ``package``'s tree."""
    return (
        {p: tuple(_relocate(o, package) for o in owners)
         for p, owners in STATS_NAMESPACES.items()},
        {k: tuple(_relocate(o, package) for o in owners)
         for k, owners in SHARED_KEYS.items()},
    )


def _audit_files(root: Path, package: str = PACKAGE) -> list[Path]:
    out: list[Path] = []
    for pat in AUDIT_GLOBS:
        out.extend(sorted(root.glob(_relocate(pat, package))))
    return out


def _subsystem(rel: str) -> str:
    """Grouping key for collision reporting: the owning package dir."""
    parts = rel.split("/")
    return "/".join(parts[:2]) if len(parts) > 2 else rel


def _owner_allows(owners: tuple[str, ...], rel: str) -> bool:
    return any(
        rel == o or (o.endswith("/") and rel.startswith(o))
        for o in owners
    )


def run_statskey_passes(
    diags: Diagnostics,
    root: str | Path | None = None,
    schema_path: str | Path | None = None,
    package: str = PACKAGE,
) -> None:
    """Audit the stats-key namespaces of ``package``'s sources in the
    repo at ``root`` (defaults to the repo this module lives in;
    ``schema_path`` defaults to its ``ci/faults_schema.json``)."""
    root = Path(root) if root is not None else \
        Path(__file__).resolve().parents[2]
    namespaces, shared_keys = _registry(package)
    found: dict[str, set[str]] = {}   # key -> set of rel paths
    for path in _audit_files(root, package):
        rel = path.relative_to(root).as_posix()
        text = path.read_text()
        for lineno, line in enumerate(text.splitlines(), 1):
            code = line.split("#", 1)[0]
            for m in _KEY_RE.finditer(code):
                key = m.group(1)
                found.setdefault(key, set()).add(rel)
                prefix = next(
                    p for p in namespaces if key.startswith(p)
                )
                if key in shared_keys:
                    if _subsystem(rel) not in shared_keys[key]:
                        diags.emit(
                            "TL301",
                            f"shared stats key {key!r} carried outside "
                            f"its licensed subsystems "
                            f"{list(shared_keys[key])}",
                            file=rel, line=lineno,
                        )
                elif not _owner_allows(namespaces[prefix], rel):
                    diags.emit(
                        "TL301",
                        f"stats key {key!r} introduced outside the "
                        f"{prefix}* namespace owners "
                        f"{list(namespaces[prefix])}",
                        file=rel, line=lineno,
                    )
            for m in _PREFIX_KWARG_RE.finditer(code):
                prefix = m.group(1)
                if prefix not in DOCUMENTED_UPDATE_PREFIXES:
                    diags.emit(
                        "TL302",
                        f"stats prefix {prefix!r} is not in the "
                        f"documented namespace registry "
                        f"({sorted(DOCUMENTED_UPDATE_PREFIXES - {''})})"
                        f" — register it in {package}.analysis.statskeys "
                        f"or reuse an existing namespace",
                        file=rel, line=lineno,
                    )

    # cross-subsystem collision: the same reserved key minted by two
    # different packages means two writers race for one report line
    for key, rels in sorted(found.items()):
        if not key.startswith(_OWNED_PREFIXES):
            continue  # shared field families (ici_*) are multi-writer
        subsystems = {
            _subsystem(r) for r in rels if not r.startswith("ci/")
        }
        subsystems -= set(shared_keys.get(key, ()))
        if len(subsystems) > 1:
            diags.emit(
                "TL301",
                f"stats key {key!r} is minted by multiple subsystems "
                f"({sorted(subsystems)}) — one writer must own each "
                f"report line",
            )

    schema_path = Path(schema_path) if schema_path is not None else \
        root / "ci" / "faults_schema.json"
    if schema_path.exists():
        try:
            schema = json.loads(schema_path.read_text())
        except json.JSONDecodeError as e:
            diags.emit(
                "TL303",
                f"cannot audit stats schema: invalid JSON: {e}",
                file=schema_path.name,
            )
            return
        for key in schema.get("stats_required_when_active", []):
            if key not in found:
                diags.emit(
                    "TL303",
                    f"schema requires stats key {key!r} when a fault "
                    f"schedule is active, but no audited source "
                    f"produces it",
                    file=schema_path.name,
                )
