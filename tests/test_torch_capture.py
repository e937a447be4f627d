"""The port's capture of ``flash_attention_pallas`` against the JAX package.

Captured on the CPU at batch 1, seq 256, heads 2, head_dim 64:

* the trace dir loads in the JAX package's ``load_trace`` and prices the
  same in both packages;
* its ``commandlist.jsonl`` equals the one ``tpusim.tracer.capture.
  capture_to_dir`` writes for the same workload with ``--launches 2``;
* ``--snapshot`` buffers equal the JAX interpret-mode snapshots on the
  same numpy inputs (atol 2e-5).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpusim.models import get_workload as ref_get_workload  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim.tracer.capture import capture_to_dir as ref_capture_to_dir  # noqa: E402
from tpusim.tracer.capture import snapshot_buffers as ref_snapshot  # noqa: E402
from tpusim_torch.__main__ import main as port_cli  # noqa: E402
from tpusim_torch.kernels import flash_attention as fa  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.models.flash_attention import (  # noqa: E402
    FlashAttention,
    from_numpy,
)
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.tracer.capture import (  # noqa: E402
    capture,
    capture_to_dir,
    measure_wall_time,
    snapshot_buffers,
)

SMALL = dict(batch=1, seq=256, heads=2, head_dim=64)
SETS = [f"--set={k}={v}" for k, v in SMALL.items()]
WORKLOAD = "flash_attention_pallas"


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("port") / WORKLOAD
    rc = port_cli(["capture", WORKLOAD, str(out), "--launches", "2",
                   "--device", "cpu", *SETS])
    assert rc == 0
    return out


def _stats(report) -> dict:
    stats = json.loads(report.stats.to_json())
    for k in ("simulation_rate_kops", "silicon_slowdown"):
        stats.pop(k)
    return stats


def test_registered_with_the_reference_parameters():
    port, ref = get_workload(WORKLOAD), ref_get_workload(WORKLOAD)
    assert port.params == ref.params
    assert port.suite == ref.suite and port.num_devices == ref.num_devices


def test_builder_draws_on_the_asked_device():
    module, (q, k, v) = get_workload(WORKLOAD).build(device="cpu", **SMALL)
    assert isinstance(module, torch.nn.Module)
    assert q.shape == (2, 256, 64) and q.device.type == "cpu"
    _, (q2, _, _) = get_workload(WORKLOAD).build(device="cpu", **SMALL)
    assert torch.equal(q, q2)  # seeded generator
    assert not torch.equal(q, k)


def test_trace_is_one_custom_call(port_trace):
    text = (port_trace / "modules" / f"{WORKLOAD}.hlo").read_text()
    assert text.startswith(f"HloModule {WORKLOAD}, is_scheduled=true, "
                           "entry_computation_layout={(f32[2,256,64]{2,1,0}")
    assert 'custom_call_target="tpu_custom_call"' in text
    assert "cost_estimate" not in text
    mod = ref_load(port_trace).modules[WORKLOAD]
    ops = mod.entry.ops
    assert [o.opcode for o in ops] == ["parameter"] * 3 + ["custom-call"]
    assert ops[-1].is_root and ops[-1].operands == ("q", "k", "v")


def test_port_trace_prices_the_same_in_both_packages(port_trace):
    for arch in ("v5e", "v5p"):
        want = _stats(ref_simulate(port_trace, arch=arch, tuned=False))
        got = _stats(port_simulate(port_trace, arch=arch, tuned=False))
        assert got == want
        # no cost_estimate: the custom-call prices as memory traffic only
        assert got["tot_flops"] == 0
        assert got["tot_hbm_bytes"] == 2 * 4 * 2 * 256 * 64 * 4
        assert got["kernel_launches"] == 2


def test_commandlist_matches_reference_capture(port_trace, tmp_path):
    fn, args = ref_get_workload(WORKLOAD).build(**SMALL)
    ref_dir = tmp_path / "ref"
    ref_capture_to_dir(ref_dir, fn, *args, name=WORKLOAD, launches=2)
    want = (ref_dir / "commandlist.jsonl").read_text()
    assert (port_trace / "commandlist.jsonl").read_text() == want
    ref_meta = json.loads((ref_dir / "meta.json").read_text())
    meta = json.loads((port_trace / "meta.json").read_text())
    assert list(meta) == list(ref_meta)
    # one platform for the port's lowered HLO on every device (C2); the
    # device is in device_kind
    assert meta["platform"] == "tpusim_torch" and meta["num_devices"] == 1
    assert meta["device_kind"] == "cpu"
    assert meta["xla_cost_analysis"] == {} and meta["memory_analysis"] == {}


def test_snapshot_matches_pallas_interpret(tmp_path):
    rng = np.random.default_rng(7)
    shape = (2, 256, 64)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(3))

    def jax_fn(q, k, v):
        from tpusim.models.pallas_attention import flash_attention

        return flash_attention(q, k, v, interpret=True)

    ref_snapshot(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 out_dir=tmp_path / "ref", launches=2)
    fa.reset_launch_count()
    paths = snapshot_buffers(FlashAttention(), *from_numpy(q, k, v,
                                                           device="cpu"),
                             out_dir=tmp_path / "port", launches=2)
    assert [p.name for p in paths] == ["launch0_buf0.npy", "launch1_buf0.npy"]
    exact = q
    for p in paths:
        want = np.load(tmp_path / "ref" / p.name)
        # the output has q's shape, so both packages feed it back as q
        # for the second launch; the float64 chain does the same
        exact = _attention_f64(exact, k, v)
        got = np.load(p)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                                   err_msg=_miss_report(got, want, exact))
    assert fa.launch_count() == 0  # the CPU takes the plain version


def _attention_f64(q, k, v) -> np.ndarray:
    """softmax(q kᵀ/√D) v in float64: the yardstick both sides are read
    against when they miss each other."""
    q, k, v = (np.asarray(a, dtype=np.float64) for a in (q, k, v))
    s = q @ np.swapaxes(k, -1, -2) / np.sqrt(q.shape[-1])
    w = np.exp(s - s.max(axis=-1, keepdims=True))
    return (w @ v) / w.sum(axis=-1, keepdims=True)


def _miss_report(port: np.ndarray, pallas: np.ndarray,
                 exact: np.ndarray) -> str:
    """Which side moved: each side's worst distance from the float64
    evaluation and the element, beside the worst gap between them."""
    parts = []
    for label, x in (("port", port), ("pallas", pallas)):
        d = np.abs(x.astype(np.float64) - exact)
        i = tuple(int(j) for j in np.unravel_index(int(d.argmax()), d.shape))
        parts.append(f"{label} worst |x - f64| {d[i]:.4g} at {i} "
                     f"(x {float(x[i])!r}, f64 {float(exact[i])!r})")
    gap = np.abs(port.astype(np.float64) - pallas)
    i = tuple(int(j) for j in np.unravel_index(int(gap.argmax()), gap.shape))
    parts.append(f"worst port-pallas gap {gap[i]:.4g} at {i}")
    return "; ".join(parts)


def test_cli_snapshot_writes_buffers(tmp_path):
    out = tmp_path / "t"
    assert port_cli(["capture", WORKLOAD, str(out), "--snapshot",
                     "--device", "cpu", *SETS]) == 0
    (buf,) = sorted((out / "checkpoint_files").glob("*.npy"))
    a = np.load(buf)
    assert a.shape == (2, 256, 64) and np.isfinite(a).all()


def test_cli_capture_without_a_card_refuses(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_cli(["capture", WORKLOAD, str(tmp_path / "x"), *SETS]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


def test_capture_refuses_other_graph_nodes():
    # a node outside the lowering's op table (cumsum) is refused by name
    class Summed(torch.nn.Module):
        def forward(self, q, k, v):
            return torch.cumsum(FlashAttention()(q, k, v), dim=1)

    q = torch.zeros(1, 64, 32)
    with pytest.raises(NotImplementedError, match="cumsum.*A5"):
        capture(Summed(), q, q, q)


def test_capture_to_dir_single_launch(tmp_path):
    module, args = get_workload(WORKLOAD).build(device="cpu", **SMALL)
    capture_to_dir(tmp_path / "one", module, *args, name=WORKLOAD)
    kinds = [json.loads(ln)["kind"] for ln in
             (tmp_path / "one" / "commandlist.jsonl").read_text().splitlines()]
    assert kinds == ["memcpy_h2d", "kernel_launch", "memcpy_d2h"]


def test_measure_wall_time_keys():
    module, args = get_workload(WORKLOAD).build(
        device="cpu", batch=1, seq=64, heads=1, head_dim=32)
    res = measure_wall_time(module, *args, iters=2, warmup=1)
    assert set(res) == {"iters", "fence_s", "min_s", "median_s", "mean_s"}
    assert res["iters"] == 6 and res["min_s"] <= res["median_s"]


@pytest.mark.parametrize("compress,gz", [(True, True), (False, False),
                                         ("auto", False)])
def test_capture_to_dir_compress(tmp_path, compress, gz):
    module, args = get_workload(WORKLOAD).build(device="cpu", **SMALL)
    out = tmp_path / "c"
    capture_to_dir(out, module, *args, name=WORKLOAD, compress=compress)
    names = sorted(p.name for p in (out / "modules").iterdir())
    assert names == [f"{WORKLOAD}.hlo.gz" if gz else f"{WORKLOAD}.hlo"]
    # both packages load the module, gzipped or not, and price it alike
    assert [o.opcode for o in ref_load(out).modules[WORKLOAD].entry.ops] == [
        "parameter"] * 3 + ["custom-call"]
    want = _stats(ref_simulate(out, arch="v5e", tuned=False))
    assert _stats(port_simulate(out, arch="v5e", tuned=False)) == want


def test_save_trace_auto_gzips_large_modules(tmp_path, monkeypatch):
    from tpusim_torch.trace import format as fmt

    module, args = get_workload(WORKLOAD).build(device="cpu", **SMALL)
    monkeypatch.setattr(fmt, "COMPRESS_THRESHOLD_BYTES", 16)
    capture_to_dir(tmp_path / "a", module, *args, name=WORKLOAD)
    assert (tmp_path / "a" / "modules" / f"{WORKLOAD}.hlo.gz").exists()
    with pytest.raises(ValueError, match="compress"):
        fmt.save_trace(tmp_path / "b", {}, [], compress="always")


class _F32Dot(torch.nn.Module):
    """A genuine f32 dot beside a larger bf16 input (C2)."""

    def forward(self, big, a, b):
        return big * 2, a.float() @ b.float()


@pytest.mark.parametrize("arch", ["v5e", "v5p"])
def test_f32_dot_prices_alike_captured_on_cpu_or_card(arch, tmp_path):
    """C2: the same lowered trace prices the same whichever device it was
    captured on.  The card's capture differs only in ``device_kind``; a
    ``cpu`` platform (what the port stamped before) would price the f32
    dot at the bf16 parameters' rate."""
    big = torch.zeros(4096, 4096, dtype=torch.bfloat16)
    a = torch.ones(1024, 1024, dtype=torch.bfloat16)
    cpu_dir = tmp_path / "cpu"
    capture_to_dir(cpu_dir, _F32Dot(), big, a, a.clone(), name="f32dot")
    card_dir = tmp_path / "card"
    import shutil

    shutil.copytree(cpu_dir, card_dir)
    meta = json.loads((card_dir / "meta.json").read_text())
    assert meta["platform"] == "tpusim_torch"
    meta["device_kind"] = "NVIDIA H100 80GB HBM3"
    (card_dir / "meta.json").write_text(json.dumps(meta))
    old_cpu = tmp_path / "old_cpu"
    shutil.copytree(cpu_dir, old_cpu)
    meta["platform"] = "cpu"
    (old_cpu / "meta.json").write_text(json.dumps(meta))

    got = {d: _stats(port_simulate(d, arch=arch, tuned=False))
           for d in (cpu_dir, card_dir, old_cpu)}
    keys = ("tot_busy_cycles_mxu", "tot_sim_cycles", "tot_mxu_flops")
    for k in keys:
        assert got[cpu_dir][k] == got[card_dir][k], k
    # the reference prices the port's trace the same way
    want = _stats(ref_simulate(card_dir, arch=arch, tuned=False))
    assert {k: want[k] for k in keys} == {k: got[card_dir][k] for k in keys}
    # the dot is priced as f32: a "cpu" platform widens it back to bf16
    # and takes fewer MXU cycles for the same flops
    assert got[old_cpu]["tot_mxu_flops"] == got[cpu_dir]["tot_mxu_flops"]
    assert (got[old_cpu]["tot_busy_cycles_mxu"]
            < got[cpu_dir]["tot_busy_cycles_mxu"])
