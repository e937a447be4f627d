"""The port's observability layer (``tpusim_torch.obs``) against the JAX
package.

* ``tests/test_obs.py`` run on the port: the sampler's window math, the
  span tree, the exports' schema round trip, the Prometheus text and the
  driver's contract that the disabled path changes nothing;
* ``power_timeline`` (``tests/test_power.py:108-128``);
* equality with the JAX package on the same trace and config:
  ``window_rows`` and the ``samples.jsonl`` and ``trace.json`` that
  ``write_obs_dir`` writes equal by bytes for golden cells 1-5 with and
  without a pinned window, and for ``llama_tiny_tp2dp2`` at v5p on the
  detailed network under the ``link_down`` and ``hbm_throttle`` example
  schedules; the ``obs_*`` counters and ``faults_worst_link_occupancy``
  ``==``, the ``obs_span_*`` key sets equal; ``metrics.prom`` equal by
  bytes once the span lines and the wall-clock keys are dropped; the
  non-obs stats pass the golden and equal the plain run's but for
  ``fastpath_*``;
* which path prices under obs: the fastpath, the ``--workers`` pool and
  the result cache each disengage, as in the JAX package, and the
  ``cache.*`` counters of a hub without sampling are the JAX package's;
* ``simulate --obs-out`` through the CLI writes the JAX CLI's files;
* ``chip_smoke.py``'s phase 15 pinned values are the JAX package's, and
  its host legs run here on the CPU.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim import obs as ref_obs  # noqa: E402
from tpusim.__main__ import main as ref_cli  # noqa: E402
from tpusim.perf.cache import ResultCache as RefCache  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim_torch import obs as port_obs  # noqa: E402
from tpusim_torch.__main__ import main as port_cli  # noqa: E402
from tpusim_torch.obs import (  # noqa: E402
    COUNTER_TRACKS,
    CycleWindowSampler,
    Instrumentation,
    counter_track_events,
    prometheus_text,
    read_samples_jsonl,
    validate_sample_rows,
    window_rows,
    write_samples_jsonl,
)
from tpusim_torch.perf.cache import ResultCache as PortCache  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "traces"
SCHEMA = json.loads((REPO / "ci" / "obs_schema.json").read_text())
EXAMPLES = json.loads(
    (REPO / "ci" / "faults_schema.json").read_text())["example_schedules"]
DETAILED = [{"arch": {"ici": {"network_mode": "detailed"}}}]
#: the report's host-clock keys (as ``tests/test_torch_simulate.py``)
VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
#: ``ci/check_golden.py``'s MATRIX: (fixture, arch, overlays, golden stem)
GOLDEN_CELLS = (
    ("matmul_512", "v5e", [], "matmul_512__v5e"),
    ("matmul_512", "v5p", [], "matmul_512__v5p"),
    ("llama_tiny_tp2dp2", "v5p", [], "llama_tiny_tp2dp2__v5p"),
    ("llama_tiny_tp2dp2", "v5p", DETAILED,
     "llama_tiny_tp2dp2__v5p__arch.ici.network_mode=detailed"),
    ("llama_tiny_tp2dp2", "v6e", [{"power_enabled": True}],
     "llama_tiny_tp2dp2__v6e__power_enabled=True"),
)
#: a pinned window, against the auto one
WINDOWS = (0.0, 5000.0)


def _check_golden():
    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CG = _check_golden()


# -- sampler window math -----------------------------------------------------

def test_sampler_splits_event_across_windows_proportionally():
    s = CycleWindowSampler(window_cycles=100.0)
    s.add("mxu", 50.0, 250.0, flops=1000.0, hbm_bytes=400.0)
    bins = s.bins()
    assert len(bins) == 3
    assert bins[0].busy["mxu"] == pytest.approx(50.0)
    assert bins[1].busy["mxu"] == pytest.approx(100.0)
    assert bins[2].busy["mxu"] == pytest.approx(50.0)
    # traffic splits with the same fractions, totals preserved
    assert bins[0].flops == pytest.approx(250.0)
    assert bins[1].flops == pytest.approx(500.0)
    assert s.total("flops") == pytest.approx(1000.0)
    assert s.total("hbm_bytes") == pytest.approx(400.0)


def test_sampler_partial_last_window():
    """An event ending mid-window leaves the tail window partially busy —
    its utilization reflects only the covered fraction."""
    s = CycleWindowSampler(window_cycles=100.0)
    s.add("vpu", 0.0, 130.0)
    bins = s.bins()
    assert len(bins) == 2
    assert bins[0].busy["vpu"] == pytest.approx(100.0)
    assert bins[1].busy["vpu"] == pytest.approx(30.0)
    # an event ending exactly on a boundary adds no phantom window
    s2 = CycleWindowSampler(window_cycles=100.0)
    s2.add("vpu", 0.0, 200.0)
    assert len(s2.bins()) == 2


def test_sampler_zero_cycle_ops_count_in_their_window():
    s = CycleWindowSampler(window_cycles=100.0)
    s.add("none", 150.0, 150.0, hbm_bytes=64.0)
    bins = s.bins()
    assert bins[1].op_count == pytest.approx(1.0)
    assert bins[1].busy.get("none", 0.0) == 0.0  # no phantom busy cycles
    assert bins[1].hbm_bytes == pytest.approx(64.0)


def test_pinned_window_is_honored_to_the_memory_cap():
    """--obs-window-cycles pins the window: pinned samplers get the high
    memory-safety cap, not auto mode's 4096, so a long run keeps the
    requested resolution (coarsenings would record any cap breach)."""
    s = CycleWindowSampler(window_cycles=10.0)
    assert s.pinned and s.max_windows == CycleWindowSampler.PINNED_MAX_WINDOWS
    s.add("mxu", 0.0, 100_000.0)  # 10k windows: >4096, under the cap
    assert s.window_cycles == 10.0 and s.coarsenings == 0
    assert s.num_windows == 10_000


def test_sampler_auto_coarsens_but_preserves_totals():
    s = CycleWindowSampler(max_windows=8)  # auto window, tiny cap
    w0 = s.window_cycles
    for i in range(100):
        s.add("mxu", i * w0, (i + 1) * w0, flops=10.0)
    assert s.coarsenings > 0
    assert s.num_windows <= 8
    assert s.total("flops") == pytest.approx(1000.0)
    assert s.total_busy("mxu") == pytest.approx(100.0 * w0)


def test_sampler_add_series_tiles_loop_bodies():
    body = CycleWindowSampler(window_cycles=10.0)
    body.add("mxu", 0.0, 10.0, flops=100.0)
    pod = CycleWindowSampler(window_cycles=10.0)
    pod.add_series(body, offset=20.0, repeats=3, period=10.0)
    assert pod.total("flops") == pytest.approx(300.0)
    assert pod.total_busy("mxu") == pytest.approx(30.0)
    assert pod.bins()[1].is_empty()          # nothing before the offset
    assert pod.bins()[2].busy["mxu"] == pytest.approx(10.0)


def test_sampler_add_series_clamps_to_true_body_length():
    """A loop body shorter than the sub-sampler window must not smear
    each trip past where it happened: a 50-cycle body x 10 trips spans
    [0, 500), never out to the 1024-cycle window quantum (which placed
    activity after the end of the program)."""
    body = CycleWindowSampler()        # auto window: 1024 cycles
    body.add("mxu", 0.0, 50.0, flops=100.0)
    pod = CycleWindowSampler(window_cycles=100.0)
    pod.add_series(body, offset=0.0, repeats=10, period=50.0, length=50.0)
    bins = pod.bins()
    assert len(bins) == 5                       # exactly the loop's span
    assert pod.total("flops") == pytest.approx(1000.0)
    assert pod.total_busy("mxu") == pytest.approx(500.0)
    # uniform across the loop: each 100-cycle window holds 2 trips
    assert bins[0].busy["mxu"] == pytest.approx(100.0)
    assert bins[4].busy["mxu"] == pytest.approx(100.0)


def test_sampler_add_series_smears_past_tile_budget(monkeypatch):
    monkeypatch.setattr(CycleWindowSampler, "_TILE_BUDGET", 10)
    body = CycleWindowSampler(window_cycles=10.0)
    body.add("vpu", 0.0, 10.0, flops=7.0)
    pod = CycleWindowSampler(window_cycles=1000.0)
    pod.add_series(body, offset=0.0, repeats=1000, period=10.0)
    # totals survive the smear exactly
    assert pod.total("flops") == pytest.approx(7000.0)
    assert pod.total_busy("vpu") == pytest.approx(10000.0)


@pytest.mark.parametrize("budget", [10, 65536])
def test_sampler_series_bins_equal_the_reference(monkeypatch, budget):
    """Tiled and smeared loop bodies, coarsening and a conditional's
    offset series give the JAX sampler's bins by value, float for float."""
    monkeypatch.setattr(CycleWindowSampler, "_TILE_BUDGET", budget)
    monkeypatch.setattr(ref_obs.CycleWindowSampler, "_TILE_BUDGET", budget)

    def build(mod):
        body = mod.CycleWindowSampler()
        body.add("mxu", 0.0, 37.5, flops=100.0, mxu_flops=64.0)
        body.add("dma", 12.25, 900.0, hbm_bytes=4096.0, vmem_bytes=8.0)
        body.add("vpu", 950.0, 950.0, transcendentals=3.0)
        pod = mod.CycleWindowSampler(max_windows=64)
        pod.add("ici", 3.0, 7777.7, ici_bytes=1e6)
        pod.add_series(body, offset=11.0, repeats=300, period=913.0,
                       length=911.5)
        pod.add_series(body, offset=5e5, length=950.0)
        return [b.to_dict() for b in pod.bins()], pod.window_cycles

    assert build(port_obs) == build(ref_obs)


# -- spans -------------------------------------------------------------------

def test_span_nesting_and_timing_monotonicity():
    obs = Instrumentation(sample=False)
    with obs.span("outer"):
        with obs.span("inner"):
            time.sleep(0.002)
        with obs.span("inner"):
            time.sleep(0.002)
        obs.add_time("manual", 0.001, count=3)
    outer = obs.spans["outer"]
    inner = obs.spans["outer/inner"]
    manual = obs.spans["outer/manual"]
    assert inner.count == 2 and inner.seconds >= 0.004
    assert manual.count == 3 and manual.seconds == pytest.approx(0.001)
    # a parent's wall covers its REAL children (add_time attributes
    # claimed seconds that need not be backed by the parent's wall, so
    # it joins child_seconds but not this bound)
    assert outer.seconds >= inner.seconds
    assert outer.child_seconds == pytest.approx(
        inner.seconds + manual.seconds
    )
    assert outer.self_seconds <= outer.seconds
    assert outer.peak_rss_kb > 0
    # tree order: parent immediately precedes its children
    paths = [s.path for s in obs.span_table()]
    assert paths[0] == "outer"
    assert set(paths[1:]) == {"outer/inner", "outer/manual"}


def test_profile_lines_phase_coverage():
    obs = Instrumentation(sample=False)
    with obs.span("a"):
        time.sleep(0.002)
    with obs.span("b"):
        time.sleep(0.002)
    lines = obs.profile_lines(total_seconds=0.004)
    assert any("(phases cover)" in l for l in lines)
    # depth-0 spans sum to >= the measured work
    top = sum(s.seconds for s in obs.span_table() if s.depth == 0)
    assert top >= 0.004


def test_null_hub_is_inert():
    from tpusim_torch.obs import NULL_OBS

    with NULL_OBS.span("x"):
        NULL_OBS.counter_add("c")
        NULL_OBS.add_time("y", 1.0)
    assert not NULL_OBS.enabled
    assert not hasattr(NULL_OBS, "spans")


def test_hub_stats_keys_equal_the_reference():
    """The same spans and counters flatten to the same keys (values are
    the host clock's but for counts and counters)."""
    def run(mod):
        obs = mod.Instrumentation(sample=False)
        with obs.span("simulate"):
            with obs.span("engine"):
                obs.add_time("cost", 0.5, count=7)
            obs.counter_add("cache.hits")
            obs.counter_set("samples.windows", 12)
        d = obs.stats_dict()
        return ({k: v for k, v in d.items() if not k.endswith("_s")},
                sorted(d), [ln.split()[0] for ln in obs.profile_lines()])

    assert run(port_obs) == run(ref_obs)


# -- export schema round-trip ------------------------------------------------

def _mini_rows():
    from tpusim_torch.timing.config import load_config

    arch = load_config(arch="v5e", tuned=False).arch
    s = CycleWindowSampler(window_cycles=1000.0)
    s.add("mxu", 0.0, 800.0, flops=1e6, mxu_flops=1e6, hbm_bytes=1e5)
    s.add("ici", 500.0, 2100.0, ici_bytes=3e5)
    s.add("dma", 1000.0, 1500.0, hbm_bytes=2e5)
    return arch, s, window_rows(s, arch, n_devices=1)


def test_counter_rows_round_trip_schema(tmp_path):
    arch, s, rows = _mini_rows()
    header_meta = {
        "arch": arch.name, "window_cycles": s.window_cycles,
        "num_devices": 1, "replayed_devices": 1,
        "clock_hz": arch.clock_hz, "config_name": arch.name,
    }
    p = tmp_path / "samples.jsonl"
    write_samples_jsonl(rows, p, header_meta)
    header, rows2 = read_samples_jsonl(p)
    validate_sample_rows(header, rows2, SCHEMA)  # must not raise
    assert rows2 == json.loads(json.dumps(rows))  # float-stable
    # utilization derives from busy cycles; ici occupancy spans windows
    assert rows2[0]["mxu_util"] == pytest.approx(0.8)
    assert rows2[0]["ici_occupancy"] == pytest.approx(0.5)
    assert rows2[1]["ici_occupancy"] == pytest.approx(1.0)
    assert rows2[0]["watts"] > 0

    # a row violating the schema is rejected
    bad = [dict(rows2[0])]
    del bad[0]["watts"]
    with pytest.raises(ValueError, match="watts"):
        validate_sample_rows(header, bad, SCHEMA)


def test_counter_track_events_cover_required_tracks():
    arch, _, rows = _mini_rows()
    events = counter_track_events(rows, arch.clock_hz)
    names = {e["name"] for e in events}
    assert set(SCHEMA["counter_tracks_required"]) <= names
    assert all(e["ph"] == "C" for e in events)
    ts = [e["ts"] for e in events if e["name"] == "mxu_util"]
    assert ts == sorted(ts)


def test_prometheus_text_format():
    text = prometheus_text({"sim_cycle": 123.0, "weird key!": 1,
                            "skip": "strings"})
    lines = [l for l in text.splitlines() if l and not l.startswith("#")]
    assert "tpusim_sim_cycle 123" in lines
    assert any(l.startswith("tpusim_weird_key_ ") for l in lines)
    assert not any("skip" in l for l in lines)


def test_prometheus_text_hardened_for_service_use():
    """The exposition document must survive hostile keys/labels: names
    sanitized (leading digits guarded), label values escaped, HELP/TYPE
    emitted, non-finite floats in the spellings scrapers accept."""
    text = prometheus_text(
        {"1starts_with_digit": 2.0, "ok": 1.5, "inf_v": float("inf"),
         "ninf_v": float("-inf"), "nan_v": float("nan"),
         "bool_skipped": True},
        labels={"trace": 'evil"name\\with\nnewline', "bad key!": "v"},
        help_text={"ok": "a help line\nwith newline"},
    )
    lines = text.splitlines()
    # names: prefix keeps most keys safe; a digit straight after an
    # empty prefix would still be guarded
    assert any(l.startswith("tpusim_1starts_with_digit{") for l in lines)
    bare = prometheus_text({"9lives": 1}, prefix="")
    assert bare.splitlines()[-1].startswith("_9lives ")
    # HELP/TYPE lines present, help newline escaped
    assert "# HELP tpusim_ok a help line\\nwith newline" in lines
    assert "# TYPE tpusim_ok gauge" in lines
    # label values escaped per the exposition format; label names
    # sanitized
    ok_line = next(l for l in lines if l.startswith("tpusim_ok{"))
    assert '\\"' in ok_line and "\\n" in ok_line and "\\\\" in ok_line
    assert "bad_key_=" in ok_line
    assert "\n" not in ok_line
    # non-finite spellings
    assert any(l.endswith(" +Inf") for l in lines)
    assert any(l.endswith(" -Inf") for l in lines)
    assert any(l.endswith(" NaN") for l in lines)
    # bools stay excluded
    assert "bool_skipped" not in text
    # and the reference's document, by bytes
    assert text == ref_obs.prometheus_text(
        {"1starts_with_digit": 2.0, "ok": 1.5, "inf_v": float("inf"),
         "ninf_v": float("-inf"), "nan_v": float("nan"),
         "bool_skipped": True},
        labels={"trace": 'evil"name\\with\nnewline', "bad key!": "v"},
        help_text={"ok": "a help line\nwith newline"},
    )


def test_prometheus_collided_names_keep_one_sample():
    # two keys that sanitize onto the same metric name: exactly one
    # TYPE line and ONE sample survives
    text = prometheus_text({"a b": 1.0, "a!b": 2.0})
    lines = text.splitlines()
    assert lines.count("# TYPE tpusim_a_b gauge") == 1
    samples = [l for l in lines if l.startswith("tpusim_a_b ")]
    assert samples == ["tpusim_a_b 1"]  # first key in sorted order wins


# -- power_timeline (tests/test_power.py:108-128) ----------------------------

def test_power_timeline_tracks_utilization():
    from tpusim_torch.power.model import POWER_PRESETS, power_timeline
    from tpusim_torch.sim.interval import IntervalSample
    from tpusim_torch.timing.config import ArchConfig

    arch = ArchConfig()
    c = POWER_PRESETS["v5p"]
    samples = [
        IntervalSample(0, 100, {"mxu": 100.0}),       # MXU pegged
        IntervalSample(100, 200, {"mxu": 50.0}),      # half busy
        IntervalSample(200, 300, {}),                 # idle
    ]
    tl = power_timeline(samples, arch, c)
    assert len(tl) == 3
    static = c.static_watts + c.idle_clock_watts
    peak_mxu = c.mxu_pj_per_flop * arch.peak_bf16_flops * 1e-12
    assert tl[0]["watts"] == pytest.approx(static + peak_mxu)
    assert tl[1]["watts"] == pytest.approx(static + 0.5 * peak_mxu)
    assert tl[2]["watts"] == pytest.approx(static)
    # full-power MXU on v5p should land in the hundreds of watts
    assert 100 < tl[0]["watts"] < 1500


# -- driver-level contract ---------------------------------------------------

@pytest.fixture(scope="module")
def fixture_trace():
    return FIXTURES / "llama_tiny_tp2dp2"


def test_disabled_path_adds_no_stats_keys(fixture_trace):
    report = simulate_trace(fixture_trace, arch="v5p", tuned=False)
    assert report.samples is None
    assert not [k for k in report.stats.values if k.startswith("obs_")]
    for k in report.kernels:
        assert k.result.samples is None


def test_enabled_path_samples_and_stats(fixture_trace, tmp_path):
    from tpusim_torch.obs import validate_obs_dir, write_obs_dir

    obs = Instrumentation()
    report = simulate_trace(fixture_trace, arch="v5p", tuned=False, obs=obs)
    s = report.samples
    assert s is not None and s.num_windows >= 2
    # the sampler's busy cycles agree with the engine's unit totals
    # (windows only re-bucket, they don't invent work); the pod series
    # covers the whole replay
    assert s.end_cycle >= report.cycles
    tot = report.totals
    for unit in ("mxu", "vpu"):
        assert s.total_busy(unit) == pytest.approx(
            tot.unit_busy_cycles.get(unit, 0.0), rel=1e-6)
    assert s.total("mxu_flops") == pytest.approx(tot.mxu_flops, rel=1e-6)
    # pod hbm traffic = module traffic + host memcpy commands (which the
    # engine totals don't carry), so >= with a sane bound
    assert tot.hbm_bytes <= s.total("hbm_bytes") <= tot.hbm_bytes * 1.05
    # spans + counters rode into the stats report
    keys = report.stats.values
    assert "obs_span_simulate.engine_s" in keys
    assert "obs_samples.windows" in keys
    # full export set validates against the checked-in schema
    write_obs_dir(tmp_path, report, obs=obs)
    summary = validate_obs_dir(tmp_path, SCHEMA)
    assert summary["windows"] == s.num_windows
    assert set(SCHEMA["counter_tracks_required"]) <= set(
        summary["counter_tracks"]
    )


def test_obs_stats_keys_do_not_leak_into_golden_set(fixture_trace):
    """The golden stat gate compares exact key sets; obs keys are only
    present when obs is on, so a default run's key set must be identical
    with and without the obs import having happened."""
    r1 = simulate_trace(fixture_trace, arch="v5p", tuned=False)
    Instrumentation()  # constructing a hub must not install any global
    r2 = simulate_trace(fixture_trace, arch="v5p", tuned=False)
    assert set(r1.stats.values) == set(r2.stats.values)


def test_timeline_counter_merge(fixture_trace):
    """`timeline --counters` path: module-level engine run with sampling,
    counter events merged into the Chrome trace via extra_events."""
    from tpusim_torch.sim.traceviz import timeline_to_chrome_trace
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.engine import Engine
    from tpusim_torch.trace.format import load_trace

    pod = load_trace(fixture_trace)
    mod = pod.modules[sorted(pod.modules)[0]]
    cfg = load_config(arch="v5p", tuned=False)
    obs = Instrumentation()
    res = Engine(cfg, record_timeline=True, obs=obs).run(mod)
    assert res.samples is not None and res.samples.num_windows >= 2
    rows = window_rows(res.samples, cfg.arch)
    trace = timeline_to_chrome_trace(
        res, cfg.arch, extra_events=counter_track_events(
            rows, cfg.arch.clock_hz
        ),
    )
    phs = {e["ph"] for e in trace["traceEvents"]}
    assert "C" in phs and "X" in phs
    counters = {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"}
    assert set(COUNTER_TRACKS) <= counters


def test_profile_cli_phases_sum(fixture_trace, capsys):
    """``python -m tpusim_torch profile`` prints the per-phase table with
    depth-0 phases covering >= 90% of the measured total, and the top
    costliest ops."""
    rc = port_cli(["profile", str(fixture_trace), "--arch", "v5p",
                   "--top", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "phase" in out and "peak_rss_mb" in out
    assert "costliest ops" in out
    cover = [l for l in out.splitlines() if "(phases cover)" in l]
    assert cover, out
    pct = float(cover[0].split("%")[0].split()[-1])
    assert pct >= 90.0, f"phases cover only {pct}% of total:\n{out}"


# -- equality with the JAX package ---------------------------------------------


def _obs_run(mod_obs, simulate, fixture, arch, overlays, out_dir,
             window=0.0, **kw):
    obs = mod_obs.Instrumentation(window_cycles=window)
    report = simulate(FIXTURES / fixture, arch=arch, overlays=list(overlays),
                      tuned=False, obs=obs, **kw)
    mod_obs.write_obs_dir(out_dir, report, obs=obs)
    return report, obs


def _counters(values: dict) -> dict:
    return {k: v for k, v in values.items()
            if (k.startswith("obs_") and not k.startswith("obs_span_"))
            or k == "faults_worst_link_occupancy"}


def _prom_sans_clock(text: str, drop: tuple[str, ...] = ()) -> list[str]:
    """``metrics.prom`` without the span lines, the wall-clock keys and
    the prefixes in ``drop``."""
    clock = {f"tpusim_{k}" for k in VOLATILE}
    skip = ("tpusim_obs_span_",) + tuple(f"tpusim_{p}" for p in drop)
    out = []
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("# ") else line.split()[0]
        name = name.split("{")[0]
        if name.startswith(skip) or name in clock:
            continue
        out.append(line)
    return out


def _plain(values: dict) -> dict:
    return {k: v for k, v in values.items()
            if not k.startswith(("obs_", "fastpath_")) and k not in VOLATILE}


def _held_equal(port, ref, port_dir: Path, ref_dir: Path,
                drop: tuple[str, ...] = ()) -> None:
    """Everything the obs port holds equal between the packages; ``drop``
    leaves process-wide counters out of ``metrics.prom`` (the fastpath's
    compile tier counts what this test process priced before)."""
    (pr, po), (rr, ro) = port, ref
    for name in ("samples.jsonl", "trace.json"):
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(
        ), name
    assert _prom_sans_clock((port_dir / "metrics.prom").read_text(), drop) \
        == _prom_sans_clock((ref_dir / "metrics.prom").read_text(), drop)
    pv, rv = pr.stats.values, rr.stats.values
    assert _counters(pv) == _counters(rv)
    assert {k for k in pv if k.startswith("obs_span_")} == \
        {k for k in rv if k.startswith("obs_span_")}
    assert set(po.spans) == set(ro.spans)
    assert {k: v for k, v in po.counters.items()} == ro.counters
    assert _plain(pv) == _plain(rv)
    assert port_obs.window_rows(pr.samples, pr.arch_config, 4) == \
        ref_obs.window_rows(rr.samples, rr.arch_config, 4)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("cell", GOLDEN_CELLS, ids=lambda c: c[3])
def test_golden_cell_obs_export_equals_the_reference(tmp_path, cell, window):
    fixture, arch, overlays, golden = cell
    port = _obs_run(port_obs, simulate_trace, fixture, arch, overlays,
                    tmp_path / "port", window)
    ref = _obs_run(ref_obs, ref_simulate, fixture, arch, overlays,
                   tmp_path / "ref", window)
    _held_equal(port, ref, tmp_path / "port", tmp_path / "ref")
    # the non-obs stats pass the golden and equal the plain run's
    stats = json.loads(port[0].stats.to_json())
    assert CG.compare({golden: _plain(stats)}) == []
    plain = simulate_trace(FIXTURES / fixture, arch=arch,
                           overlays=list(overlays), tuned=False)
    assert _plain(stats) == _plain(json.loads(plain.stats.to_json()))
    assert port[0].samples.window_cycles >= (window or 1024.0)


@pytest.mark.parametrize("kind", ["link_down", "hbm_throttle"])
def test_degraded_pod_obs_export_equals_the_reference(tmp_path, kind):
    port = _obs_run(port_obs, simulate_trace, "llama_tiny_tp2dp2", "v5p",
                    DETAILED, tmp_path / "port", faults=EXAMPLES[kind])
    ref = _obs_run(ref_obs, ref_simulate, "llama_tiny_tp2dp2", "v5p",
                   DETAILED, tmp_path / "ref", faults=EXAMPLES[kind])
    _held_equal(port, ref, tmp_path / "port", tmp_path / "ref")
    values = port[0].stats.values
    assert "faults_worst_link_occupancy" in values
    assert any(k.startswith("obs_ici.detailed.") for k in values)
    trace = json.loads((tmp_path / "port" / "trace.json").read_text())
    assert any(e["name"] == "faults_active" for e in trace["traceEvents"]
               if e["ph"] == "C")


def test_healthy_trace_has_no_faults_track(tmp_path):
    report, _ = _obs_run(port_obs, simulate_trace, "llama_tiny_tp2dp2",
                         "v5p", [], tmp_path)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert not any(e["name"] == "faults_active"
                   for e in trace["traceEvents"])
    assert "faults_worst_link_occupancy" not in report.stats.values


# -- which path prices under obs -------------------------------------------------


@pytest.mark.parametrize("backend", ["vectorized", "serial"])
def test_fastpath_disengages_under_obs(tmp_path, backend):
    """With a pricing backend requested the report says what priced:
    ``serial`` under obs, as in the JAX package, and the windows are the
    serial walk's (not empty)."""
    port = _obs_run(port_obs, simulate_trace, "llama_tiny_tp2dp2", "v5p",
                    [], tmp_path / "port", pricing_backend=backend)
    ref = _obs_run(ref_obs, ref_simulate, "llama_tiny_tp2dp2", "v5p", [],
                   tmp_path / "ref", pricing_backend=backend)
    assert port[0].stats.values["fastpath_backend"] == "serial"
    assert ref[0].stats.values["fastpath_backend"] == "serial"
    assert port[0].samples.total("mxu_flops") > 0
    _held_equal(port, ref, tmp_path / "port", tmp_path / "ref",
                drop=("fastpath_",))


def test_worker_pool_disengages_under_obs(tmp_path):
    port = _obs_run(port_obs, simulate_trace, "llama_tiny_tp2dp2", "v5p",
                    [], tmp_path / "port", workers=2)
    ref = _obs_run(ref_obs, ref_simulate, "llama_tiny_tp2dp2", "v5p", [],
                   tmp_path / "ref")
    assert not [k for k in port[0].stats.values if k.startswith("pool_")]
    assert port[0].samples.total("mxu_flops") > 0
    _held_equal(port, ref, tmp_path / "port", tmp_path / "ref")


def test_result_cache_is_bypassed_while_sampling(tmp_path):
    """A cached result carries no series: under a sampling hub the
    engine prices live, even with the result already cached."""
    cache, ref_cache = PortCache(), RefCache()
    simulate_trace(FIXTURES / "llama_tiny_tp2dp2", arch="v5p", tuned=False,
                   result_cache=cache)
    ref_simulate(FIXTURES / "llama_tiny_tp2dp2", arch="v5p", tuned=False,
                 result_cache=ref_cache)
    assert cache.misses == 1
    port = _obs_run(port_obs, simulate_trace, "llama_tiny_tp2dp2", "v5p",
                    [], tmp_path / "port", result_cache=cache)
    ref = _obs_run(ref_obs, ref_simulate, "llama_tiny_tp2dp2", "v5p", [],
                   tmp_path / "ref", result_cache=ref_cache)
    assert cache.hits == 0 and cache.misses == 1
    assert port[0].samples.total("mxu_flops") > 0
    _held_equal(port, ref, tmp_path / "port", tmp_path / "ref")


@pytest.mark.parametrize("disk", [False, True])
def test_cache_counters_equal_the_reference(tmp_path, disk):
    """A hub without sampling keeps the cache engaged: cold then warm,
    the ``cache.*`` counters and the span keys (``cache`` around the disk
    tier) are the JAX package's.  The cache keeps the first hub it was
    given (``as_result_cache`` upgrades only the no-op one), so that hub
    counts both runs."""
    got = []
    for tag, mod_obs, simulate, cache_cls in (
            ("port", port_obs, simulate_trace, PortCache),
            ("ref", ref_obs, ref_simulate, RefCache)):
        cache = cache_cls(disk_dir=tmp_path / tag if disk else None)
        hubs, stats = [], []
        for _ in range(2):
            obs = mod_obs.Instrumentation(sample=False)
            report = simulate(FIXTURES / "llama_tiny_tp2dp2", arch="v5p",
                              tuned=False, obs=obs, result_cache=cache)
            hubs.append(obs)
            stats.append(_plain(report.stats.values))
        got.append(([dict(h.counters) for h in hubs],
                    [sorted(h.spans) for h in hubs], stats))
    assert got[0] == got[1]
    counters, spans, _ = got[0]
    assert counters[0]["cache.misses"] == 1
    assert counters[0]["cache.hits"] == 1
    assert ("simulate/engine/cache" in spans[0]) is disk


def test_cli_obs_out_writes_the_reference_files(tmp_path):
    trace = str(FIXTURES / "llama_tiny_tp2dp2")
    outs = []
    for tag, main in (("port", port_cli), ("ref", ref_cli)):
        out_dir = tmp_path / tag
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["simulate", trace, "--arch", "v5p", "--obs-out",
                       str(out_dir), "--obs-window-cycles", "3000"])
        assert rc == 0
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("obs: ")]
        outs.append((lines[0].split(" -> ")[0], out_dir))
    assert outs[0][0] == outs[1][0] == "obs: 243 windows x 3000 cycles"
    for name in ("samples.jsonl", "trace.json"):
        assert (outs[0][1] / name).read_bytes() == \
            (outs[1][1] / name).read_bytes()
    assert _prom_sans_clock((outs[0][1] / "metrics.prom").read_text()) == \
        _prom_sans_clock((outs[1][1] / "metrics.prom").read_text())


def test_cli_warns_when_a_pinned_window_coarsens(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(CycleWindowSampler, "PINNED_MAX_WINDOWS", 64)
    rc = port_cli(["simulate", str(FIXTURES / "llama_tiny_tp2dp2"),
                   "--arch", "v5p", "--obs-out", str(tmp_path),
                   "--obs-window-cycles", "100"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "exceeded the 64-window memory cap; coarsened" in err


# -- chip_smoke.py's phase 15 ----------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_for_obs", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_obs_pins_are_the_reference(smoke, tmp_path):
    """``OBS_DIGESTS`` and ``OBS_FAULT_COUNTERS`` recomputed from the JAX
    package."""
    assert [c[3] for c in smoke.GOLDEN_CELLS] == [c[3] for c in GOLDEN_CELLS]
    runs = [(golden, fixture, arch, overlays, None)
            for fixture, arch, overlays, golden in GOLDEN_CELLS]
    runs += [(kind, "llama_tiny_tp2dp2", "v5p", DETAILED, EXAMPLES[kind])
             for kind in smoke.OBS_FAULT_KINDS]
    for tag, fixture, arch, overlays, faults in runs:
        report, _ = _obs_run(ref_obs, ref_simulate, fixture, arch, overlays,
                             tmp_path / tag, faults=faults)
        assert smoke.obs_digests(tmp_path / tag) == smoke.OBS_DIGESTS[tag]
        if faults is not None:
            got = {k: v for k, v in report.stats.values.items()
                   if k == "faults_worst_link_occupancy"
                   or k.startswith("obs_ici.detailed.")}
            assert got == smoke.OBS_FAULT_COUNTERS[tag]
    assert set(smoke.OBS_DIGESTS) == {r[0] for r in runs}


def test_chip_smoke_observability_on_cpu(smoke, tmp_path, capsys):
    """Phase 15's host legs on the CPU: every part passes, no kernel
    launches, and the summary carries each part's seconds."""
    out = smoke.observability("cpu", tmp_path)
    assert set(out["seconds"]) == {"a", "b", "c", "d", "phase"}
    assert all(not any(v.values()) for v in out["launches"].values())
    assert set(out["a"]) == {c[3] for c in GOLDEN_CELLS} | {"cli"}
    assert out["c"]["cover_pct"] >= 90.0
    text = capsys.readouterr().out
    for part in ("(a) golden", "(a) simulate llama_tiny_tp2dp2", "(b) link_down",
                 "(b) hbm_throttle", "(c) profile", "(d) matmul_512",
                 "(d) llama_tiny_tp2dp2"):
        assert f"  {part}" in text
