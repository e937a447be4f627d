"""The segmented entry of the ``scan_rows`` kernel, and the ``cuda``
route's one launch per run step, on the CPU.

* ``scan_segments`` on CPU tensors (its plain version,
  ``scan_segments_reference``) equals, by bytes, a per-segment
  ``np.cumsum`` of ``[seed, *mat[rows, s]]`` over ragged segments —
  lengths 0 and 1, repeated and unsorted rows, whole chains and ends — at
  S in {1, 32, 33, 746}, on an ops-major matrix and on one column shared
  by every lane (lane stride 0);
* ``pack_segments`` and ``unpack_segments`` round-trip: the table and
  indices read back give the segments packed;
* the ``cuda`` route rehearsed on the CPU (``_SCAN_DEVICE = "cpu"``): a
  64-lane ``llama_tiny_tp2dp2`` @ v5p call makes one ``scan_segments``
  call per run step (15) and no ``scan_rows`` call, every lane equal by
  bytes to ``vectorized``'s and to the JAX package's per-state walk; a
  column no lane changes goes over once, as one column; the lane-divergent
  conditional's per-lane-seeded chains and the vmem-spill views take the
  same entry;
* the wrapper's input checks and its launch counter on the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpusim.perf.cache import result_to_doc as ref_doc  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.timing.engine import Engine as RefEngine  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch.fastpath import batch as port_batch  # noqa: E402
from tpusim_torch.fastpath import price_module_batch  # noqa: E402
from tpusim_torch.fastpath.price import entry_of  # noqa: E402
from tpusim_torch.kernels import scan_rows as sr  # noqa: E402
from tpusim_torch.perf.cache import compiled_for  # noqa: E402
from tpusim_torch.perf.cache import result_to_doc as port_doc  # noqa: E402
from tpusim_torch.timing.config import load_config as port_config  # noqa: E402
from tpusim_torch.timing.engine import Engine as PortEngine  # noqa: E402
from tpusim_torch.trace.format import load_trace as port_load  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "traces"
SILICON = REPO / "reports" / "silicon"
LLAMA = FIXTURES / "llama_tiny_tp2dp2"
#: chip_smoke.py phase 6 (b)'s lanes: 64 seeded (clock, hbm) scales
LANES = 64
SEED = 7


def _matrix(ops: int, lanes: int, seed: int) -> np.ndarray:
    """Seeded float64 values, log-uniform from 1e-3 to 1e9."""
    return np.exp(np.random.default_rng(seed).uniform(
        np.log(1e-3), np.log(1e9), size=(ops, lanes)))


#: ragged segments over a 40-row matrix: (rows, whole chain?)
SEGMENTS = [
    (list(range(3, 20)), True),      # a run lo..hi
    ([], True),                      # empty, whole chain: the seed alone
    ([7], False),                    # one row
    ([], False),                     # empty, end only: the seed
    ([5, 5, 5, 2], False),           # repeated rows
    ([39, 0, 17, 8, 8, 30], True),   # unsorted rows
    (list(range(40))[::-1] * 2, False),  # longer than the ring's chunks
]


def _want(mat: np.ndarray, seeds: np.ndarray, segments) -> list[np.ndarray]:
    """Per segment, NumPy's cumsum of [seed, *mat[rows]] by lane — the
    JAX package's row scan — whole or its last row."""
    out = []
    for (rows, full), seed in zip(segments, seeds):
        chain = np.cumsum(np.concatenate([seed[None], mat[rows]]), axis=0)
        out.append(chain if full else chain[-1])
    return out


@pytest.mark.parametrize("shared", [False, True],
                         ids=["ops_major", "lane_stride_0"])
@pytest.mark.parametrize("lanes", [1, 32, 33, 746])
def test_scan_segments_plain_version_is_the_reference_scan(lanes, shared):
    seed = 3 * lanes + shared
    if shared:
        col = _matrix(40, 1, seed)[:, 0]
        mat_np = np.repeat(col[:, None], lanes, axis=1)
        mat = torch.as_strided(torch.from_numpy(col), (40, lanes), (1, 0))
    else:
        mat_np = _matrix(40, lanes, seed)
        mat = torch.from_numpy(mat_np)
    seeds_np = _matrix(len(SEGMENTS), lanes, seed + 1)
    plan = sr.pack_segments(SEGMENTS)
    table, idx = plan.split(plan.head)
    out = sr.scan_segments(mat, idx, table, torch.from_numpy(seeds_np),
                           plan.out_rows)
    assert out.shape == (plan.out_rows, lanes)
    got = sr.unpack_segments(plan, out)
    want = _want(mat_np, seeds_np, SEGMENTS)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.contiguous().numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("segments", [
    SEGMENTS,
    [(range(0, 1), False)],
    [(torch.tensor([4, 1, 4], dtype=torch.int64), True), ([], True)],
], ids=["ragged", "one_row", "tensor_rows"])
def test_pack_and_unpack_round_trip(segments):
    plan = sr.pack_segments(segments)
    want = [(list(rows.tolist() if isinstance(rows, torch.Tensor)
                  else rows), full) for rows, full in segments]
    table, idx = plan.split(plan.head)
    idx = idx.tolist()
    assert [(idx[off:off + n], bool(full))
            for off, n, _orow, full in table.tolist()] == want
    lengths = [len(rows) for rows, _ in want]
    assert plan.n_seg == len(want)
    assert plan.n_idx == sum(lengths)
    assert plan.out_rows == sum(n + 1 if full else 1
                                for n, (_, full) in zip(lengths, want))
    # the output's rows map back to the segments in order, without gaps
    out = torch.arange(plan.out_rows, dtype=torch.float64)[:, None]
    parts = sr.unpack_segments(plan, out)
    flat = torch.cat([p.reshape(-1) for p in parts])
    assert flat.tolist() == list(range(plan.out_rows))
    for part, n, (_, full) in zip(parts, lengths, want):
        assert part.shape == ((n + 1, 1) if full else (1,))


def test_pack_rejects_empty_plans_and_wide_rows():
    with pytest.raises(ValueError, match="at least one segment"):
        sr.pack_segments([])
    with pytest.raises(ValueError, match="2\\^31"):
        sr.pack_segments([([2 ** 31], False)])
    with pytest.raises(ValueError, match="2\\^31"):
        sr.pack_segments([([-1], False)])


def test_scan_segments_checks_inputs():
    plan = sr.pack_segments([([0, 1], True)])
    table, idx = plan.split(plan.head)
    mat = torch.zeros(3, 4, dtype=torch.float64)
    seeds = torch.zeros(1, 4, dtype=torch.float64)
    args = (plan.out_rows,)
    with pytest.raises(ValueError, match="float64"):
        sr.scan_segments(mat.float(), idx, table, seeds, *args)
    with pytest.raises(ValueError, match="seeds"):
        sr.scan_segments(mat, idx, table, seeds[:, :3], *args)
    with pytest.raises(ValueError, match="table"):
        sr.scan_segments(mat, idx, table[:, :3], seeds, *args)
    meta = [t.to("meta") for t in (mat, idx, table, seeds)]
    with pytest.raises(ValueError, match="no scan_segments for device"):
        sr.scan_segments(*meta, *args)
    with pytest.raises(ValueError, match="one device"):
        sr.scan_segments(meta[0], idx, table, seeds, *args)


def test_scan_segments_launch_counter_stays_zero_on_cpu():
    sr.reset_launch_count()
    plan = sr.pack_segments(SEGMENTS)
    table, idx = plan.split(plan.head)
    sr.scan_segments(torch.from_numpy(_matrix(40, 8, 1)), idx, table,
                     torch.from_numpy(_matrix(len(SEGMENTS), 8, 2)),
                     plan.out_rows)
    assert sr.launch_count() == 0


# -- the cuda route, rehearsed on the CPU -----------------------------------


@pytest.fixture
def route(monkeypatch):
    """The ``cuda`` backend with its scans sent to the CPU; records every
    call of either wrapper entry as (entry, matrix shape, matrix strides,
    segments)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_batch, "_SCAN_DEVICE", "cpu")
    calls = []
    rows, segments = sr.scan_rows, sr.scan_segments

    def on_rows(seeds, mat):
        calls.append(("scan_rows", tuple(mat.shape), mat.stride(), 1))
        return rows(seeds, mat)

    def on_segments(mat, idx, table, seeds, *rest):
        calls.append(("scan_segments", tuple(mat.shape), mat.stride(),
                      table.shape[0]))
        return segments(mat, idx, table, seeds, *rest)

    monkeypatch.setattr(sr, "scan_rows", on_rows)
    monkeypatch.setattr(sr, "scan_segments", on_segments)
    return calls


def _run_steps(cm, comp: str, depth: int = 0) -> int:
    """Run steps the batched walk visits from ``comp``: each of its own,
    and a callee's, a while body's and every branch's once per visit."""
    if depth > 32:
        return 0
    n = 0
    for step in cm.comp(comp).steps:
        kind = step[0]
        if kind == "run":
            n += 1
        elif kind in ("while", "call"):
            n += _run_steps(cm, step[4], depth + 1)
        elif kind == "cond":
            n += sum(_run_steps(cm, b, depth + 1) for b in step[4])
    return n


def _docs(results, to_doc) -> list[str]:
    return [json.dumps(to_doc(r)) for r in results]


def _scales(n: int = LANES, seed: int = SEED) -> list[tuple[float, float]]:
    drawn = 1.0 - 0.5 * np.random.default_rng(seed).random((n, 2))
    return [(float(c), float(h)) for c, h in drawn]


def test_llama_64_lanes_take_one_launch_per_run_step(route):
    """``chip_smoke.py`` phase 6 (b)'s call: 15 run steps, 15 calls of
    ``scan_segments`` (one per step, 3-5 segments each), none of
    ``scan_rows``; every lane equals ``vectorized`` and the JAX package's
    per-state walk by bytes."""
    cfg, rcfg = port_config(arch="v5p"), ref_config(arch="v5p")
    [mod] = port_load(LLAMA).modules.values()
    [rmod] = ref_load(LLAMA).modules.values()
    lanes = _scales()
    engines = [PortEngine(cfg, clock_scale=c, hbm_scale=h) for c, h in lanes]
    cm = compiled_for(mod, engines[0])
    entry = entry_of(mod, cm)
    steps = _run_steps(cm, entry)
    assert steps == 15
    got = _docs(price_module_batch(mod, engines, backend="cuda"), port_doc)
    assert [c[0] for c in route] == ["scan_segments"] * steps
    assert all(c[1] == (len(cm.comp(entry).names), LANES)
               and c[2] == (LANES, 1) for c in route)
    assert sorted({c[3] for c in route}) == [3, 5]
    host = _docs(price_module_batch(
        mod, [PortEngine(cfg, clock_scale=c, hbm_scale=h) for c, h in lanes],
        backend="vectorized"), port_doc)
    ref = _docs([RefEngine(rcfg, clock_scale=c, hbm_scale=h).run(rmod)
                 for c, h in lanes], ref_doc)
    assert got == host == ref


def test_shared_column_goes_over_once_as_a_column(route, monkeypatch):
    """With no degraded lane and no spill every lane shares the duration
    column: it is uploaded as ``[n]`` and read with a lane stride of 0."""
    uploads = []
    real = port_batch._CardScans.upload

    def upload(self, dur2):
        out = real(self, dur2)
        uploads.append((tuple(dur2.shape), tuple(out.shape)))
        return out

    monkeypatch.setattr(port_batch._CardScans, "upload", upload)
    cfg = port_config(arch="v5p")
    [mod] = port_load(LLAMA).modules.values()
    engines = [PortEngine(cfg) for _ in range(8)]
    got = _docs(price_module_batch(mod, engines, backend="cuda"), port_doc)
    assert uploads and all(out == (shape[1],) for shape, out in uploads)
    assert route and all(c[2] == (1, 0) and c[1][1] == 8 for c in route)
    host = _docs(price_module_batch(mod, [PortEngine(cfg) for _ in range(8)],
                                    backend="vectorized"), port_doc)
    assert got == host


def _divergent_cond_text(n: int = 4096) -> str:
    """A conditional whose worst branch depends on the lane (a matrix
    product, slower under a straggler clock, or a chain of adds, slower
    under a throttled HBM), then a run of 20 ops."""
    sh = f"f32[{n},{n}]{{1,0}}"
    tail = "\n".join(f"  %m{i} = {sh} multiply(%m{i - 1}, %m{i - 1})"
                     for i in range(1, 20))
    cond = (f"  %cond = {sh} conditional(%pred, %e0, %e0), "
            "true_computation=%compute_branch, "
            "false_computation=%memory_branch")
    return f"""HloModule cond_lanes, is_scheduled=true

%compute_branch (p0: f32[{n},{n}]) -> f32[{n},{n}] {{
  %p0 = {sh} parameter(0)
  ROOT %dot.1 = {sh} dot(%p0, %p0), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}
}}

%memory_branch (p1: f32[{n},{n}]) -> f32[{n},{n}] {{
  %p1 = {sh} parameter(0)
  %s1 = {sh} add(%p1, %p1)
  %s2 = {sh} add(%s1, %p1)
  ROOT %s3 = {sh} add(%s2, %s1)
}}

ENTRY %main (a: f32[{n},{n}], pred: pred[]) -> f32[{n},{n}] {{
  %a = {sh} parameter(0)
  %pred = pred[] parameter(1)
  %e0 = {sh} add(%a, %a)
{cond}
  %m0 = {sh} multiply(%cond, %cond)
{tail}
  ROOT %out = {sh} add(%m19, %m0)
}}
"""


def test_divergent_accumulators_take_the_entry_with_lane_stride_0(route):
    """After a lane-divergent conditional the flops, bytes and other
    lane-invariant columns chain from per-lane seeds: each goes over with
    its seeds in one staging copy and is scanned at a lane stride of 0."""
    from tpusim.trace.hlo_text import parse_hlo_module as ref_parse
    from tpusim_torch.trace.hlo_text import parse_hlo_module as port_parse

    text = _divergent_cond_text()
    lanes = [(1.0, 1.0), (0.5, 1.0), (1.0, 0.3), (0.7, 0.3), (0.3, 0.9)]
    ref_mod = ref_parse(text, name_hint="cond_lanes")
    port_mod = port_parse(text, name_hint="cond_lanes")
    cfg, rcfg = port_config(arch="v5e"), ref_config(arch="v5e")
    want = [RefEngine(rcfg, clock_scale=c, hbm_scale=h).run(ref_mod)
            for c, h in lanes]
    assert len({r.flops for r in want}) == 2, "the branches did not diverge"
    got = price_module_batch(
        port_mod, [PortEngine(cfg, clock_scale=c, hbm_scale=h)
                   for c, h in lanes], backend="cuda")
    assert _docs(got, port_doc) == _docs(want, ref_doc)
    shared = [c for c in route if c[2] == (1, 0)]
    full = [c for c in route if c[2] != (1, 0)]
    assert shared and all(c[3] == 1 for c in shared)
    assert full and all(c[0] == "scan_segments" for c in route)


def test_vmem_spill_views_under_the_cuda_route(route):
    """The vmem-spill transform's views (lane-variant cycle floors) through
    the route, against the JAX package's walk under the same overlay."""
    overlay = {"arch": {"vmem_bytes": 64 * 1024}}
    cfg = port_config(arch="v5e", overlays=[overlay])
    rcfg = ref_config(arch="v5e", overlays=[overlay])
    lanes = _scales(6, seed=11)
    spilled = 0
    # a while loop, a reduction and a module with no spill under the cap
    for trace in (SILICON / "lstm_layer", SILICON / "reduction",
                  SILICON / "elementwise_stream"):
        rpod, pod = ref_load(trace), port_load(trace)
        for name in sorted(pod.modules):
            want = [RefEngine(rcfg, clock_scale=c, hbm_scale=h)
                    .run(rpod.modules[name]) for c, h in lanes]
            spilled += want[0].vmem_spill_bytes > 0
            got = price_module_batch(
                pod.modules[name], [PortEngine(cfg, clock_scale=c,
                                               hbm_scale=h)
                                    for c, h in lanes], backend="cuda")
            assert _docs(got, port_doc) == _docs(want, ref_doc), name
    assert spilled == 2 and route
