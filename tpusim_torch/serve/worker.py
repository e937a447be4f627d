"""Request execution — the daemon's worker layer (port of
``tpusim/serve/worker.py``).

One :class:`ServeWorker` is shared by every HTTP thread and every async
job thread.  It owns the two warm stores that make the service faster
than a CLI run:

* the **process-wide result cache** (:class:`tpusim_torch.perf.ResultCache`,
  optionally disk-backed via ``--result-cache``): every request prices
  through :class:`~tpusim_torch.perf.CachedEngine`, so a repeat or near-repeat
  request (same modules, same composed config) is O(lookup) instead of
  an engine walk.  Each request sees the shared store through a
  :class:`_RequestCacheView` that counts hits/misses *per request* —
  the source of the response's ``cache_hit`` field — while the shared
  counters keep feeding ``/metrics``;
* the **composed-config cache**: ``load_config`` reads preset + tuned
  overlay files from disk; the composition is pure, so it is keyed by
  ``(arch, overlays, tuned)`` and reused across requests.

Validation contract (the 400 path): error-level :mod:`tpusim_torch.analysis`
diagnostics reject the request with the full TLxxx list instead of
pricing garbage — trace passes come pre-computed from the registry,
config passes run on the composed config, schedule passes on the fault
schedule, exactly the ``simulate --validate`` set.

Determinism contract: the pricing path is byte-identical to the CLI —
same :class:`~tpusim_torch.sim.driver.SimDriver`, same arch-from-meta
defaulting, same fault binding — so a served stats doc reproduces a
``python -m tpusim_torch simulate`` run float for float (pinned by
``tests/test_torch_serve.py`` against the golden cells and a live JAX
daemon; the per-request view's ``cache_hits``/``cache_misses``
accounting keys are the one addition, same namespace any
``--result-cache`` CLI run stamps).

Pricing is host work: a worker makes no CUDA tensor, so a supervised
worker forked from a process that holds a CUDA context never touches the
card (a forked child cannot initialise CUDA again).
"""

from __future__ import annotations

import json
import threading
import time

from tpusim_torch.perf.cache import ResultCache
from tpusim_torch.timing.model_version import model_version

__all__ = ["RequestError", "ServeWorker", "worker_child_main"]

#: hard cap on request deadlines — a client cannot pin a slot forever
MAX_DEADLINE_S = 600.0

#: composed configs kept hot (each is a small frozen dataclass, but the
#: key is request-controlled — a client stepping an overlay float must
#: not grow the daemon without bound; mirrors MAX_INLINE_ENTRIES)
MAX_CONFIG_ENTRIES = 128

#: strict-lint verdict cache bound (one full diagnostics doc per
#: distinct trace content hash — refusal docs are small; clean docs
#: are near-empty)
MAX_LINT_VERDICTS = 512


class RequestError(Exception):
    """A request-level failure with an HTTP status and a stable code.

    ``extra`` merges into the JSON error body (e.g. the diagnostics doc
    on a validation refusal)."""

    def __init__(
        self, status: int, code: str, detail: str,
        extra: dict | None = None,
    ):
        self.status = int(status)
        self.code = code
        self.detail = detail
        self.extra = extra or {}
        super().__init__(f"{status} {code}: {detail}")


class _RequestCacheView(ResultCache):
    """Per-request window onto the shared cache.

    Delegates storage to the shared instance (every request reads and
    feeds the same warm store) but counts hits/misses locally — the
    response's ``cache_hit`` must describe *this* request, and the
    shared cumulative counters cannot be read racelessly around a run.
    The driver stamps this view's ``stats_dict`` under ``cache_*``, so
    served reports carry per-request cache effectiveness."""

    def __init__(self, shared: ResultCache, timed: bool = False):
        super().__init__(disk_dir=None, max_entries=1)
        self._shared = shared
        # request-trace probe accounting: first-probe start + total
        # probe seconds, folded into ONE "cache_probe" span (a replay
        # may probe per segment; per-probe spans would bloat the tree)
        self._timed = timed
        self._probe_t0: float | None = None
        self._probe_s = 0.0

    def get(self, key):
        if self._timed:
            t0 = time.monotonic()
            result = self._shared.get(key)
            if self._probe_t0 is None:
                self._probe_t0 = t0
            self._probe_s += time.monotonic() - t0
        else:
            result = self._shared.get(key)
        if result is not None:
            self.hits += 1
        else:
            self.misses += 1
        return result

    def probe_span(self) -> tuple[str, float, float] | None:
        """The folded ``cache_probe`` span, or None if never probed."""
        if self._probe_t0 is None:
            return None
        return ("cache_probe", self._probe_t0, self._probe_s)

    def put(self, key, result) -> None:
        self._shared.put(key, result)

    def stats_dict(self) -> dict[str, float]:
        return {"hits": self.hits, "misses": self.misses}


def _pod_devices(pod) -> int:
    """The driver's pod-size rule, mirrored exactly (fault schedules
    must bind against the same torus the replay will use)."""
    return max(
        int(pod.meta.get("num_devices", 0) or 0),
        max((m.num_devices for m in pod.modules.values()), default=1),
        len(pod.devices) or 1,
    )


class ServeWorker:
    """Executes simulate / lint / sweep requests over the warm stores."""

    def __init__(
        self,
        registry,
        result_cache: ResultCache | None = None,
        workers: int = 1,
        strict_lint: bool = False,
    ):
        self.registry = registry
        self.result_cache = result_cache
        self.workers = max(int(workers), 1)
        self.strict_lint = bool(strict_lint)
        self.model_version = model_version()
        self._config_cache: dict[str, object] = {}
        self._config_lock = threading.Lock()
        # strict-lint verdict tier: the full trace-pass diagnostics doc
        # per CONTENT HASH — a fleet behind --strict-lint lints each
        # distinct trace exactly once, then refuses (422) or admits
        # from the cached verdict
        self._lint_verdicts: dict[str, dict] = {}
        self._lint_lock = threading.Lock()
        self.strict_lint_refused = 0
        # requests priced by THIS worker object (the zero-dispatch
        # proof: a pass served entirely from the hot mmap tier must
        # leave this counter untouched)
        self.priced = 0
        # cumulative async-job executor accounting (campaign_* and
        # advise_* namespaces), mirrored on /metrics
        self._job_totals: dict[str, float] = {}
        self._job_lock = threading.Lock()

    # -- shared resolution ---------------------------------------------------

    def _resolve_entry(self, req: dict):
        """The request's pod: a named registry trace or inline HLO."""
        from tpusim_torch.serve.registry import UnknownTrace

        trace = req.get("trace")
        hlo_text = req.get("hlo_text")
        if (trace is None) == (hlo_text is None):
            raise RequestError(
                400, "bad_request",
                "exactly one of 'trace' (registry name) or 'hlo_text' "
                "(inline HLO) is required",
            )
        if trace is not None:
            try:
                return self.registry.get(str(trace)), False
            except UnknownTrace as e:
                raise RequestError(404, "unknown_trace", str(e.args[0]))
        try:
            entry = self.registry.get_inline(
                str(hlo_text), int(req.get("num_devices", 1) or 1)
            )
        except (ValueError, KeyError, TypeError) as e:
            raise RequestError(
                400, "hlo_parse_error",
                f"inline HLO did not parse: {type(e).__name__}: {e}",
            )
        return entry, True

    def _config_for(self, pod, req: dict):
        """The composed SimConfig, cached by (arch, overlays, tuned).

        Request overlays are JSON dicts only — a service request must
        never name files on the daemon's filesystem."""
        from tpusim_torch.timing.config import load_config

        arch = req.get("arch")
        overlays = req.get("overlays") or []
        if not isinstance(overlays, list) or not all(
            isinstance(o, dict) for o in overlays
        ):
            raise RequestError(
                400, "bad_request",
                "'overlays' must be a list of JSON objects "
                "(flag files are not servable)",
            )
        tuned = bool(req.get("tuned", True))
        if arch is None:
            # the CLI's arch-from-capture defaulting, via the same
            # named-preset route so the tuned overlay applies
            kind = str(pod.meta.get("device_kind", "") or "")
            if kind:
                from tpusim_torch.timing.arch import detect_arch

                arch = detect_arch(kind).name
        key = json.dumps(
            {"arch": arch, "overlays": overlays, "tuned": tuned},
            sort_keys=True,
        )
        with self._config_lock:
            cfg = self._config_cache.get(key)
        if cfg is None:
            try:
                cfg = load_config(
                    arch=arch, overlays=list(overlays), tuned=tuned
                )
            except (KeyError, ValueError, FileNotFoundError) as e:
                raise RequestError(
                    400, "bad_config", f"config does not compose: {e}"
                )
            with self._config_lock:
                cfg = self._config_cache.setdefault(key, cfg)
                while len(self._config_cache) > MAX_CONFIG_ENTRIES:
                    oldest = next(iter(self._config_cache))
                    if oldest == key:
                        break
                    self._config_cache.pop(oldest)
        return cfg

    def _analyze(self, entry, inline: bool, cfg, req: dict):
        """The per-request pre-flight: cached trace passes + fresh
        config/schedule/memory passes.  Returns the Diagnostics."""
        from tpusim_torch.analysis.config_passes import run_config_passes
        from tpusim_torch.analysis.diagnostics import Diagnostics
        from tpusim_torch.analysis.memory_passes import run_memory_passes

        diags = Diagnostics()
        if not inline:
            diags.items.extend(
                self.registry.trace_diagnostics(entry).items
            )
        run_config_passes(cfg, diags, trace_meta=entry.pod.meta)
        # TL40x vs the request's composed arch — the dataflow walk is
        # memoized on each module object, so a hot pod pays it once
        run_memory_passes(entry.pod.modules, cfg, diags)
        faults = req.get("faults")
        if faults is not None:
            from tpusim_torch.analysis.schedule_passes import run_schedule_passes
            from tpusim_torch.ici.topology import torus_for

            topo = torus_for(_pod_devices(entry.pod), cfg.arch.name)
            run_schedule_passes(faults, topo, diags)
        return diags

    @staticmethod
    def _reject(diags) -> None:
        raise RequestError(
            400, "validation_failed",
            f"static analysis refused the request: {diags.summary()}",
            extra={
                "codes": sorted(d.code for d in diags.errors),
                "diagnostics": json.loads(diags.to_json()),
            },
        )

    # -- strict-lint gate ----------------------------------------------------

    def _content_key(self, entry, inline: bool, req: dict) -> str:
        """The verdict-cache identity: the modules' content hashes
        plus (registry traces) a commandlist fingerprint — the trace
        passes judge BOTH artifacts, so two traces sharing modules but
        differing commandlists must not cross-serve each other's
        verdict.  The same content re-registered under another name,
        or re-submitted inline, still lints once."""
        hashes = sorted(
            str(m.meta.get("content_hash", "") or "")
            for m in entry.pod.modules.values()
        )
        if not hashes or not any(hashes):
            hashes = [entry.name]  # degenerate: no stamped hash
        if not inline:
            # the trace passes judge THREE artifacts: modules,
            # commandlist.jsonl, and meta.json (TL007/TL010 gate on
            # the meta pod declaration) — the key must cover all of
            # them or look-alike traces cross-serve verdicts
            fp = getattr(entry, "_artifact_fp", None)
            if fp is None:
                import hashlib

                parts = []
                root = getattr(self.registry, "trace_root", None)
                if root is not None:
                    for fname in ("commandlist.jsonl", "meta.json"):
                        p = root / entry.name / fname
                        try:
                            digest = hashlib.sha256(
                                p.read_bytes()
                            ).hexdigest()[:16]
                        except OSError:
                            digest = "absent"
                        parts.append(f"{fname}:{digest}")
                fp = ";".join(parts) or "no-root"
                try:
                    entry._artifact_fp = fp
                except (AttributeError, TypeError):
                    pass
            hashes.append(fp)
        return "|".join(hashes)

    def _strict_lint_gate(self, entry, inline: bool, req: dict) -> None:
        """``--strict-lint``: refuse (422 + the full diagnostics doc)
        any trace whose trace-family passes report errors OR warnings.
        TL5xx perf-lint findings are exempt: they ride along in the
        doc as advisory warnings but never refuse.  The verdict is
        cached by content hash, so a fleet lints each distinct trace
        once; later submissions are admitted or refused from the cache
        without re-walking a line."""
        key = self._content_key(entry, inline, req)
        with self._lint_lock:
            doc = self._lint_verdicts.get(key)
        if doc is None:
            from tpusim_torch.analysis.diagnostics import Diagnostics

            if inline:
                from tpusim_torch.analysis.trace_passes import (
                    _parse_module_lines, run_module_passes,
                )

                diags = Diagnostics()
                pm = _parse_module_lines(
                    entry.name, "<inline hlo>",
                    str(req.get("hlo_text", "")),
                )
                run_module_passes(pm, diags, lenient=True)
            else:
                diags = self.registry.trace_diagnostics(entry)
            doc = json.loads(diags.to_json())
            with self._lint_lock:
                self._lint_verdicts.setdefault(key, doc)
                while len(self._lint_verdicts) > MAX_LINT_VERDICTS:
                    oldest = next(iter(self._lint_verdicts))
                    if oldest == key:
                        break
                    self._lint_verdicts.pop(oldest)
        # TL5xx perf-lint findings are advisory by contract: they pass
        # through in the cached doc for the caller to read but never
        # refuse admission, so recount the gate's severities without
        # them (the counts field keeps the full tally).
        counts: dict = {}
        for d in doc.get("diagnostics", []):
            if str(d.get("code", "")).startswith("TL5"):
                continue
            sev = d.get("severity", "")
            counts[sev] = counts.get(sev, 0) + 1
        if counts.get("error") or counts.get("warning"):
            with self._lint_lock:
                self.strict_lint_refused += 1
            raise RequestError(
                422, "strict_lint_refused",
                f"strict lint refused the trace: "
                f"{counts.get('error', 0)} error(s), "
                f"{counts.get('warning', 0)} warning(s) "
                f"(the daemon runs --strict-lint; see 'diagnostics')",
                extra={"diagnostics": doc},
            )

    # -- endpoints -----------------------------------------------------------

    def simulate(self, req: dict, cancel=None, spans=None) -> dict:
        """``POST /v1/simulate`` — price one pod replay.  ``cancel``
        (a :class:`tpusim_torch.guard.CancelToken` armed with the request's
        deadline) makes the replay cooperatively cancellable: the
        driver raises :class:`tpusim_torch.guard.OperationCancelled` at the
        next command/op boundary, the HTTP layer answers 504, and this
        worker — process or thread — survives with every cache warm.
        ``spans`` (request tracing) collects ``(name, abs_monotonic_s,
        dur_s)`` tier timings — lint verdict, cache probe, pricing."""
        from tpusim_torch.sim.driver import SimDriver

        entry, inline = self._resolve_entry(req)
        cfg = self._config_for(entry.pod, req)
        if self.strict_lint:
            if spans is None:
                self._strict_lint_gate(entry, inline, req)
            else:
                t_lint = time.monotonic()
                try:
                    self._strict_lint_gate(entry, inline, req)
                finally:
                    # a 422 refusal is the interesting trace — record
                    # the verdict span on the way out either way
                    spans.append(
                        ("lint", t_lint, time.monotonic() - t_lint)
                    )
        if bool(req.get("validate", True)):
            diags = self._analyze(entry, inline, cfg, req)
            if diags.has_errors:
                self._reject(diags)
        faults = None
        if req.get("faults") is not None:
            from tpusim_torch.faults import load_fault_schedule

            try:
                faults = load_fault_schedule(req["faults"])
            except (ValueError, KeyError, TypeError) as e:
                raise RequestError(
                    400, "bad_faults", f"fault schedule rejected: {e}"
                )
        view = (
            _RequestCacheView(self.result_cache, timed=spans is not None)
            if self.result_cache is not None else None
        )
        from tpusim_torch.faults import TopologyPartitionedError

        t_price = time.monotonic()
        try:
            report = SimDriver(
                cfg, faults=faults, result_cache=view,
                workers=self.workers, cancel=cancel,
            ).run(entry.pod)
        except (ValueError, KeyError, TopologyPartitionedError) as e:
            # a replay refusal (partitioned topology, unknown module) is
            # the request's fault, not the server's
            raise RequestError(
                422, "replay_failed", f"{type(e).__name__}: {e}"
            )
        finally:
            if spans is not None:
                # price covers the whole driver run (compile rides
                # inside it on a cold module); the folded cache-probe
                # span overlaps it as a child-by-timing
                spans.append(
                    ("price", t_price, time.monotonic() - t_price)
                )
                if view is not None:
                    probe = view.probe_span()
                    if probe is not None:
                        spans.append(probe)
        stats = json.loads(report.stats.to_json())
        self.priced += 1
        return {
            "trace": entry.name,
            "arch": cfg.arch.name,
            "num_devices": report.num_devices,
            "sim_cycles": report.cycles,
            "cache_hit": bool(
                view is not None and view.misses == 0 and view.hits > 0
            ),
            "stats": stats,
        }

    def lint(self, req: dict, cancel=None, spans=None) -> dict:
        """``POST /v1/lint`` — the analyzer's report, never a refusal
        (lint findings are the payload, not an error).  ``cancel`` is
        accepted for endpoint-signature uniformity; analysis runs in
        milliseconds, below any useful cancellation grain.  ``spans``
        (request tracing) collects the analyze timing."""
        entry, inline = self._resolve_entry(req)
        cfg = self._config_for(entry.pod, req)
        t_analyze = time.monotonic()
        diags = self._analyze(entry, inline, cfg, req)
        if spans is not None:
            spans.append(
                ("analyze", t_analyze, time.monotonic() - t_analyze)
            )
        from tpusim_torch.analysis.diagnostics import Severity

        return {
            "trace": entry.name,
            "arch": cfg.arch.name,
            "summary": diags.summary(),
            "errors": diags.count(Severity.ERROR),
            "warnings": diags.count(Severity.WARNING),
            "trace_passes": "skipped (inline hlo)" if inline else "ran",
            "diagnostics": json.loads(diags.to_json()),
        }

    def sweep(self, req: dict, cancel=None) -> dict:
        """``POST /v1/sweep`` body → the sweep report (runs on a job
        thread; the HTTP layer returns a job id immediately).
        ``cancel`` is the job's token — ``DELETE /v1/jobs/<id>`` trips
        it and the sweep unwinds at link grain as ``cancelled``."""
        from tpusim_torch.faults.sweep import single_link_sweep, trace_step_sweep
        from tpusim_torch.ici.topology import torus_for

        if req.get("trace") is not None or req.get("hlo_text") is not None:
            # trace sweeps replay a pod per scenario — a registry name
            # or an inline module both resolve to one
            entry, _ = self._resolve_entry(req)
            cfg = self._config_for(entry.pod, req)
            chips = int(req.get("chips") or _pod_devices(entry.pod))
            topo = torus_for(chips, cfg.arch.name)
            result = trace_step_sweep(
                None, topo,
                max_scenarios=int(req.get("max_scenarios", 16) or 16),
                workers=self.workers,
                result_cache=self.result_cache,
                pod=entry.pod,
                config=cfg,
                cancel=cancel,
            )
        else:
            cfg = self._config_for_sweep(req)
            chips = int(req.get("chips", 64) or 64)
            topo = torus_for(chips, cfg.arch.name)
            payload_mb = float(req.get("payload_mb", 64.0) or 64.0)
            result = single_link_sweep(
                topo, cfg.arch.ici,
                payload_bytes=payload_mb * 1024 * 1024,
                kind=str(req.get("kind", "all-reduce")),
                workers=self.workers,
                cancel=cancel,
            )
        return result.to_doc()

    def campaign(self, req: dict, out_dir=None, cancel=None) -> dict:
        """``POST /v1/campaign`` body → the campaign report (runs on a
        job thread).  ``req['spec']`` is the campaign spec document;
        the workload is the usual ``trace``/``hlo_text`` pair.  With a
        daemon ``--state-dir``, ``out_dir`` points at this job's
        journal directory — a restarted daemon re-enters here and
        resumes from the last completed scenario instead of re-pricing
        from zero."""
        import json as _json

        from tpusim_torch.analysis import ValidationError
        from tpusim_torch.campaign import (
            CampaignSpecError, load_campaign_spec, run_campaign,
        )

        spec_doc = req.get("spec")
        if not isinstance(spec_doc, dict):
            raise RequestError(
                400, "bad_request",
                "'spec' (a campaign spec object) is required",
            )
        try:
            spec = load_campaign_spec(spec_doc)
        except CampaignSpecError as e:
            raise RequestError(
                400, "bad_campaign_spec", str(e),
                extra={"codes": [e.code]},
            )
        entry, _inline = self._resolve_entry(req)
        try:
            result = run_campaign(
                spec,
                pod=entry.pod,
                trace_name=entry.name,
                out_dir=out_dir,
                resume=out_dir is not None,
                result_cache=self.result_cache,
                workers=self.workers,
                cancel=cancel,
            )
        except ValidationError as e:
            raise RequestError(
                400, "validation_failed",
                f"campaign spec refused: {e.diags.summary()}",
                extra={
                    "codes": sorted(d.code for d in e.diags.errors),
                    "diagnostics": _json.loads(e.diags.to_json()),
                },
            )
        self._accumulate(result.stats.stats_dict())
        return result.doc

    def fleet(self, req: dict, out_dir=None, cancel=None) -> dict:
        """``POST /v1/fleet`` body → the fleet digital-twin report
        (runs on a job thread).  ``req['spec']`` is the fleet spec
        document; the workload is the usual ``trace``/``hlo_text``
        pair.  With a daemon ``--state-dir``, ``out_dir`` points at
        this job's journal directory — a restarted daemon re-enters
        here and resumes with zero journaled pricing intervals
        re-priced."""
        import json as _json

        from tpusim_torch.analysis import ValidationError
        from tpusim_torch.fleet import FleetSpecError, load_fleet_spec, run_fleet

        spec_doc = req.get("spec")
        if not isinstance(spec_doc, dict):
            raise RequestError(
                400, "bad_request",
                "'spec' (a fleet spec object) is required",
            )
        try:
            spec = load_fleet_spec(spec_doc)
        except FleetSpecError as e:
            raise RequestError(
                400, "bad_fleet_spec", str(e),
                extra={"codes": [e.code]},
            )
        entry, _inline = self._resolve_entry(req)
        try:
            result = run_fleet(
                spec,
                pod=entry.pod,
                trace_name=entry.name,
                out_dir=out_dir,
                resume=out_dir is not None,
                result_cache=self.result_cache,
                workers=self.workers,
                cancel=cancel,
            )
        except ValidationError as e:
            raise RequestError(
                400, "validation_failed",
                f"fleet spec refused: {e.diags.summary()}",
                extra={
                    "codes": sorted(d.code for d in e.diags.errors),
                    "diagnostics": _json.loads(e.diags.to_json()),
                },
            )
        self._accumulate(result.stats.stats_dict())
        return result.doc

    def advise(self, req: dict, cancel=None) -> dict:
        """``POST /v1/advise`` body → the ranked advisor report (runs
        on a job thread).  ``req['spec']`` is the advise spec document;
        the workload is the usual ``trace``/``hlo_text`` pair.  The
        served doc is byte-identical to the ``tpusim advise`` CLI's —
        cells price through the same shared result cache."""
        import json as _json

        from tpusim_torch.advise import (
            AdviseSpecError, load_advise_spec, run_advise,
        )
        from tpusim_torch.analysis import ValidationError

        spec_doc = req.get("spec")
        if not isinstance(spec_doc, dict):
            raise RequestError(
                400, "bad_request",
                "'spec' (an advise spec object) is required",
            )
        try:
            spec = load_advise_spec(spec_doc)
        except AdviseSpecError as e:
            raise RequestError(
                400, "bad_advise_spec", str(e),
                extra={"codes": [e.code]},
            )
        entry, _inline = self._resolve_entry(req)
        try:
            result = run_advise(
                spec,
                pod=entry.pod,
                trace_name=entry.name,
                result_cache=self.result_cache,
                workers=self.workers,
                cancel=cancel,
            )
        except ValidationError as e:
            raise RequestError(
                400, "validation_failed",
                f"advise spec refused: {e.diags.summary()}",
                extra={
                    "codes": sorted(d.code for d in e.diags.errors),
                    "diagnostics": _json.loads(e.diags.to_json()),
                },
            )
        self._accumulate(result.stats.stats_dict())
        return result.doc

    def _accumulate(self, stats: dict[str, float]) -> None:
        with self._job_lock:
            for k, v in stats.items():
                self._job_totals[k] = self._job_totals.get(k, 0.0) + v

    def _config_for_sweep(self, req: dict):
        """Analytic sweeps have no pod to default the arch from."""

        class _NoPod:
            meta: dict = {}
            modules: dict = {}
            devices: dict = {}

        shim = _NoPod()
        if req.get("arch") is None:
            req = dict(req, arch="v5p")  # the faults CLI default
        return self._config_for(shim, req)

    # -- reporting -----------------------------------------------------------

    def stats_dict(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if self.result_cache is not None:
            for k, v in self.result_cache.stats_dict().items():
                out[f"cache_{k}"] = v
        with self._config_lock:
            out["configs_hot"] = len(self._config_cache)
        out["priced_total"] = self.priced
        if self.strict_lint:
            with self._lint_lock:
                out["lint_verdicts_cached"] = len(self._lint_verdicts)
            out["strict_lint_refused_total"] = self.strict_lint_refused
        with self._job_lock:
            out.update(self._job_totals)
        return out


# ---------------------------------------------------------------------------
# Supervised worker process
# ---------------------------------------------------------------------------

#: endpoints a supervised worker will execute; everything else is a
#: supervisor-side programming error, not client-reachable state
_CHILD_ENDPOINTS = frozenset({"simulate", "lint"})


def worker_child_main(index: int, conn, settings: dict) -> None:
    """Entry point of one supervised worker process.

    ``conn`` is the child end of the supervisor's duplex pipe; the
    protocol is ``(req_id, endpoint, body)`` in, ``(req_id, kind,
    payload)`` out with ``kind`` one of ``ack`` / ``ok`` /
    ``request_error`` / ``error``, and ``None`` as the shutdown
    sentinel.  The ``ack`` frame goes back the instant a request is
    read off the pipe, BEFORE any work: a worker that dies without
    acking provably never started the request, so the supervisor can
    retry it without charging the poison budget — a send() that landed
    in the pipe buffer of a worker the OOM killer then took is not the
    request's fault.  The response
    payloads are the exact objects the in-process :class:`ServeWorker`
    returns/raises — the supervisor re-raises them in the parent, which
    is what keeps multi-worker responses byte-identical to the
    single-process daemon.

    Each worker owns its whole pricing world: a private
    :class:`~tpusim_torch.serve.registry.TraceRegistry` (per-worker hot pods —
    affinity dispatch keeps a trace parsed in ~one worker), a private
    in-memory L1 :class:`~tpusim_torch.perf.ResultCache`, and, when
    ``settings["disk_cache_dir"]`` is set, the shared disk tier as L2
    with ``durable=True`` (fsync-before-replace: a worker killed
    mid-publish can never leave a short-read record for the fleet to
    warn about).  Nothing here is shared mutable state with the parent,
    so a SIGKILL at any instant costs exactly this process.

    Cooperative cancellation (tpusim_torch.guard): the supervisor ships the
    request's remaining deadline budget as the volatile body key
    ``_budget_s``; the child builds its own
    :class:`~tpusim_torch.guard.CancelToken` from it (tokens never travel
    across pipes) and prices under it.  A tripped token unwinds as the
    ``cancelled`` frame — the worker stays alive with its registry and
    L1 warm, the parent answers 504, and SIGTERM/SIGKILL becomes the
    escalation for a worker that never reaches a check (a hung native
    call), not the first resort.

    A forked child inherits torch's intra-op OpenMP pool in the state the
    parent left it (a parallel region entered here could wait forever on
    threads that were not forked), so the worker runs one intra-op thread,
    as the pricing pool's workers do; pricing's float64 scans are serial
    anyway, so no result changes.  Nothing here touches ``torch.cuda``.

    ``settings["chaos_hooks"]`` arms the fault-injection hooks the chaos
    tests and the CI chaos smoke use (``_chaos_exit`` → ``os._exit``,
    ``_chaos_sleep_s`` → sleep before pricing, ``_chaos_spin_s`` → a
    cancel-aware busy loop standing in for long pricing); a production
    daemon never sets it.
    """
    import os
    import signal as _signal
    import time as _time

    # the parent's handlers (SIGTERM → drain) are wrong here: a worker
    # dies promptly on TERM (the supervisor escalates to KILL anyway)
    # and ignores INT (a terminal ^C must drain via the parent, which
    # reaps the fleet — not race it to death)
    _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
    _signal.signal(_signal.SIGINT, _signal.SIG_IGN)
    # under fork the child inherits the daemon's listening socket; keep
    # it and a killed daemon's port stays bound by its orphans
    for fd in settings.get("inherited_fds") or ():
        try:
            os.close(int(fd))
        except (OSError, ValueError, TypeError):
            pass
    import torch

    torch.set_num_threads(1)

    from tpusim_torch.guard.cancel import OperationCancelled
    from tpusim_torch.perf.cache import ResultCache
    from tpusim_torch.serve.registry import TraceRegistry

    disk_dir = settings.get("disk_cache_dir") or None
    if settings.get("compile_cache_dir"):
        # the durable compiled-module tier, same dir discipline as the
        # shared L2: every worker loads columns a peer compiled and
        # publishes durably (fsync-before-replace) for the fleet
        from tpusim_torch.fastpath.store import as_compile_store

        as_compile_store(
            settings["compile_cache_dir"], durable=True,
            quota_bytes=settings.get("cache_quota_bytes"),
        )
    # pull the request path's one-time costs (backend resolution, lazy
    # pricing-stack imports) forward to worker boot
    from tpusim_torch.serve.daemon import _prewarm_pricing_stack

    _prewarm_pricing_stack()
    registry = TraceRegistry(settings.get("trace_root"))
    cache = ResultCache(
        disk_dir=disk_dir,
        max_entries=int(settings.get("cache_entries", 4096) or 4096),
        durable=disk_dir is not None,
        # the daemon's --cache-quota governs every writer of the shared
        # dir: each worker enforces it on its own puts (gc_store deletes
        # are idempotent across the fleet by design)
        quota_bytes=settings.get("cache_quota_bytes"),
    )
    worker = ServeWorker(
        registry, result_cache=cache, workers=1,
        strict_lint=bool(settings.get("strict_lint")),
    )
    chaos = bool(settings.get("chaos_hooks"))
    # the daemon's response format version: when present, success
    # responses travel as the final serialized body bytes (see below)
    format_version = settings.get("format_version")

    try:
        conn.send(("ready", os.getpid()))
    except (BrokenPipeError, OSError):
        return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg is None:
            return
        req_id, endpoint, body = msg
        try:
            # ack before ANY work (chaos hooks included): death after
            # this frame means the request was in flight when the
            # worker died — the supervisor's poison accounting keys
            # off exactly that distinction
            conn.send((req_id, "ack", None))
        except (BrokenPipeError, OSError):
            return
        cancel = None
        if isinstance(body, dict) and body.get("_budget_s") is not None:
            from tpusim_torch.guard.cancel import CancelToken

            body = dict(body)
            cancel = CancelToken.after(float(body.pop("_budget_s")))
        spans = None
        if isinstance(body, dict) and "_trace_ctx" in body:
            # request tracing is on: time this request's tiers and ship
            # them back in an extra "spans" frame ahead of the final
            # one.  The marker is volatile (stripped from content
            # hashes) and must never reach the endpoint body.
            body = dict(body)
            body.pop("_trace_ctx")
            spans = []
        if chaos and isinstance(body, dict):
            if body.get("_chaos_exit"):
                os._exit(3)
            nap = body.get("_chaos_sleep_s")
            if nap:
                _time.sleep(min(float(nap), 30.0))
        try:
            if chaos and isinstance(body, dict) and body.get("_chaos_spin_s"):
                # a cancel-aware stand-in for long pricing: spins like a
                # big replay would, checking the token at its grain —
                # the deterministic vehicle for the coop-cancel smoke
                spin_until = _time.monotonic() + min(
                    float(body["_chaos_spin_s"]), 30.0
                )
                while _time.monotonic() < spin_until:
                    if cancel is not None:
                        cancel.check()
                    _time.sleep(0.005)
            if endpoint not in _CHILD_ENDPOINTS:
                raise RequestError(
                    404, "unknown_endpoint",
                    f"supervised workers serve {sorted(_CHILD_ENDPOINTS)},"
                    f" not {endpoint!r}",
                )
            result = getattr(worker, endpoint)(
                body, cancel=cancel, spans=spans,
            ) if spans is not None else getattr(worker, endpoint)(
                body, cancel=cancel,
            )
        except RequestError as e:
            out = (req_id, "request_error",
                   (e.status, e.code, e.detail, e.extra))
            tier = None
        except OperationCancelled as e:
            # the deadline tripped INSIDE the pricing stack: this
            # process is healthy, its caches warm — the supervisor
            # answers 504 without killing anything
            out = (req_id, "cancelled", str(e))
            tier = None
        except Exception as e:  # noqa: BLE001 - the worker's 500 boundary
            out = (req_id, "error", f"{type(e).__name__}: {e}")
            tier = None
        else:
            tier = None
            if isinstance(result, dict) and "cache_hit" in result:
                tier = "warm" if result.get("cache_hit") else "priced"
            if format_version is not None:
                # serialize HERE, byte-for-byte what the parent's
                # _send_json would produce (same dumps args, same
                # envelope): the parent then writes the bytes straight
                # to the socket instead of unpickling a ~10 KB stats
                # dict and re-serializing it under its GIL — the hot
                # half of the per-request parent cost
                t_ser = _time.monotonic()
                blob = json.dumps({
                    "format_version": format_version,
                    "model_version": worker.model_version,
                    **result,
                }, sort_keys=True).encode() + b"\n"
                if spans is not None:
                    spans.append(
                        ("serialize", t_ser, _time.monotonic() - t_ser)
                    )
                out = (req_id, "ok_bytes", blob)
            else:
                out = (req_id, "ok", result)
        try:
            if spans is not None:
                # span frame rides ahead of the final frame; the bytes
                # of the final frame are untouched by tracing
                conn.send((req_id, "spans", {"spans": spans, "tier": tier}))
            conn.send(out)
        except (BrokenPipeError, OSError):
            return
