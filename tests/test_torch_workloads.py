"""The port's ten workloads with committed silicon traces, against the
JAX package, all on the CPU at small shapes (``SMALL``):

(i)   registration: parameters, suite, devices, description and the
      ``workloads`` line equal the reference's;
(ii)  numerics: the port module and the JAX function agree on the same
      numpy inputs — float32 within rtol = atol = 1e-4, bfloat16 within
      2e-2;
(iii) the reference's self-checks: ``mlp_train_step`` learns,
      ``decode_step`` writes the cache row at ``pos`` and nothing else,
      and refuses ``pos == seq_cache``;
(iv)  ``commandlist.jsonl`` of a 2-launch capture equals the JAX
      capture's by bytes (tuple ``out_bytes``, ``s32`` ``in_bytes``);
(v)   the port's trace prices the same in both packages (a ``while``
      resolves its trip count);
(vi)  simulated at v5e against the JAX package's CPU capture of the same
      workload and shapes: ``tot_mxu_flops`` equal at float32 and
      bfloat16, ``tot_hbm_bytes`` within ``BYTE_BAND`` at float32;
(vii) capture runs nothing on the device: the module only ever sees fake
      tensors.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_workloads.py``
prints the float32 ratios of (vi), and the JAX capture's ``cost_analysis``
flops beside its simulated flops, as the table PERF.md records.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpusim.__main__ import main as ref_cli  # noqa: E402
from tpusim.models import get_workload as ref_get_workload  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.tracer.capture import capture_to_dir as ref_capture_to_dir  # noqa: E402
from tpusim_torch.__main__ import main as port_cli  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.models.decode import DecodeStep  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.tracer.capture import capture  # noqa: E402

#: small shapes of each workload (its dtype parameter is set per test)
SMALL = {
    "elementwise_stream": dict(elems=65536),
    "transcendental": dict(elems=65536),
    "reduction": dict(rows=256, cols=256),
    "matmul_chain": dict(m=256, k=256, depth=2),
    "attention_1chip": dict(batch=1, seq=128, heads=2, head_dim=64),
    "conv2d": dict(batch=2, hw=8, cin=16, cout=16, ksize=3),
    "embedding_lookup": dict(vocab=1024, dim=64, lookups=128),
    "mlp_train_step": dict(batch=32, width=64, depth=2),
    "decode_step": dict(batch=2, seq_cache=64, heads=2, head_dim=32,
                        layers=2, pos=10),
    "lstm_layer": dict(batch=4, hidden=32, seq=16),
}
NAMES = list(SMALL)

#: the [lo, hi] band of the port's simulated tot_hbm_bytes over the JAX
#: CPU capture's, at float32
BYTE_BAND = {name: (0.8, 1.25) for name in NAMES}
# decode_step: XLA:CPU copies the loop-carried cache slices and the
# zero-filled stacked-output buffer (copy.11/.22/.23 in its trace) and
# writes the stacked outputs through a fused dynamic-update-slice that
# reads its update twice; those copies are the CPU backend's copy
# insertion, not fusion, and the port's loop writes in place.  The band
# keeps the same upper edge.
BYTE_BAND["decode_step"] = (0.7, 1.25)


@pytest.fixture(autouse=True)
def _jax_default_precision():
    """The JAX workloads are written for JAX's default 32-bit mode; another
    test in the same process may have switched x64 on (the JAX package's
    fastpath scan backend does)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _kw(name: str, dtype: str | None = "float32") -> dict:
    kw = dict(SMALL[name])
    if dtype is not None and "dtype" in ref_get_workload(name).params:
        kw["dtype"] = dtype
    return kw


def _has_dtype(name: str) -> bool:
    return "dtype" in ref_get_workload(name).params


def _stats(report) -> dict:
    stats = json.loads(report.stats.to_json())
    for k in ("simulation_rate_kops", "silicon_slowdown"):
        stats.pop(k)
    return stats


def _np(tree) -> list[np.ndarray]:
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


def _port_args(name: str, module, ref_args):
    """The port's arguments from the JAX builder's, through numpy."""
    arrays = jax.tree_util.tree_map(np.asarray, ref_args)
    return module.from_numpy(*arrays, device="cpu")


def _leaves(out) -> list[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _port_trace(tmp: Path, name: str, dtype: str = "float32") -> Path:
    out = tmp / f"port_{name}_{dtype}"
    sets = [f"--set={k}={json.dumps(v)}" for k, v in _kw(name, dtype).items()]
    assert port_cli(["capture", name, str(out), "--launches", "2",
                     "--device", "cpu", *sets]) == 0
    return out


def _ref_trace(tmp: Path, name: str, dtype: str = "float32") -> Path:
    out = tmp / f"ref_{name}_{dtype}"
    fn, args = ref_get_workload(name).build(**_kw(name, dtype))
    ref_capture_to_dir(out, fn, *args, name=name, launches=2)
    return out


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """(port, ref) trace dirs per (workload, dtype), captured once."""
    root = tmp_path_factory.mktemp("workloads")
    cache: dict[tuple[str, str], tuple[Path, Path]] = {}

    def get(name: str, dtype: str = "float32") -> tuple[Path, Path]:
        if (name, dtype) not in cache:
            cache[(name, dtype)] = (_port_trace(root, name, dtype),
                                    _ref_trace(root, name, dtype))
        return cache[(name, dtype)]

    return get


# ---------------------------------------------------------------------------
# (i) registration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_registered_as_the_reference(name):
    port, ref = get_workload(name), ref_get_workload(name)
    assert port.params == ref.params
    assert port.suite == ref.suite
    assert port.num_devices == ref.num_devices
    assert port.description == ref.description


def test_workloads_lines_equal_the_reference(capsys):
    assert port_cli(["workloads"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert ref_cli(["workloads"]) == 0
    ref = capsys.readouterr().out.splitlines()
    # the ten of this file, flash_attention_pallas, the seven of
    # tests/test_torch_multidevice.py, the nine of
    # tests/test_torch_models.py and tests/test_torch_resnet.py and the
    # nine of tests/test_torch_ubench.py; beside them the port's own two
    # DeepSeek-V2 workloads (tests/test_torch_deepseek_v2.py)
    assert len(ref) == 36 and len(port) == 36 + 2

    def pick(lines):
        return [ln for ln in lines if ln.split()[1] in SMALL]

    assert pick(port) == pick(ref) and len(pick(port)) == 10


# ---------------------------------------------------------------------------
# (ii) numerics against the JAX function
# ---------------------------------------------------------------------------

_CASES = [(n, "float32") for n in NAMES] + [
    (n, "bfloat16") for n in NAMES if _has_dtype(n)]

#: bfloat16 numerics of matmul_chain run one layer deep.  With the
#: reference's unscaled N(0, 1) weights the chain is ill-conditioned in
#: bfloat16: the two libraries round 7 of the 65536 first-layer products
#: and 7759 of the tanh-gelu outputs one bf16 ulp apart, and the second
#: product, 256 terms of magnitude ~16, carries those ulps to up to 0.07
#: on 7 of 65536 outputs.  One layer holds each library's rounding of
#: the product and the gelu to 2e-2; float32 runs both layers.
_NUMERIC_OVERRIDES = {("matmul_chain", "bfloat16"): dict(depth=1)}


@pytest.mark.parametrize("name,dtype", _CASES)
def test_port_module_matches_jax(name, dtype):
    kw = _kw(name, dtype) | _NUMERIC_OVERRIDES.get((name, dtype), {})
    fn, ref_args = ref_get_workload(name).build(**kw)
    want = _np(jax.jit(fn)(*ref_args))
    module, _ = get_workload(name).build(device="cpu", **kw)
    args = _port_args(name, module, ref_args)
    with torch.no_grad():
        got = _leaves(module(*args))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (iii) self-checks
# ---------------------------------------------------------------------------


def test_mlp_train_step_learns():
    module, args = get_workload("mlp_train_step").build(
        device="cpu", batch=64, width=256, depth=2, dtype="float32")
    with torch.no_grad():
        loss0, *params = module(*args)
        for _ in range(50):
            loss, *params = module(*params, *args[-2:])
    assert float(loss) < 0.95 * float(loss0)


def test_decode_step_writes_the_row_at_pos_only():
    B, S, H, D, L, P = 2, 16, 2, 8, 2, 5
    module, (h0, ck, cv, pos, wq, wk, wv, wo) = get_workload(
        "decode_step").build(device="cpu", batch=B, seq_cache=S, heads=H,
                             head_dim=D, layers=L, dtype="float32", pos=P)
    with torch.no_grad():
        h1, ck1, cv1, pos1 = module(h0, ck, cv, pos, wq, wk, wv, wo)
    assert int(pos1) == P + 1 and pos1.dtype == torch.int32
    h = h0.numpy().astype(np.float32)
    ckn, cvn = ck.numpy().copy(), cv.numpy().copy()
    for layer in range(L):
        q = (h @ wq[layer].numpy()).reshape(B, H, D)
        k = (h @ wk[layer].numpy()).reshape(B, H, D)
        v = (h @ wv[layer].numpy()).reshape(B, H, D)
        ckn[layer, :, P] = k
        cvn[layer, :, P] = v
        kc, vc = ckn[layer][:, :P + 1], cvn[layer][:, :P + 1]
        s = np.einsum("bhd,bshd->bhs", q, kc) * (D ** -0.5)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        attn = np.einsum("bhs,bshd->bhd", p, vc)
        h = h + attn.reshape(B, H * D) @ wo[layer].numpy()
    np.testing.assert_allclose(h1.numpy(), h, atol=2e-4, rtol=0)
    for got, want in ((ck1.numpy(), ckn), (cv1.numpy(), cvn)):
        np.testing.assert_allclose(got[:, :, P], want[:, :, P], atol=2e-5,
                                   rtol=0)
        np.testing.assert_array_equal(got[:, :, :P], want[:, :, :P])
        np.testing.assert_array_equal(got[:, :, P + 1:], want[:, :, P + 1:])


def test_decode_step_refuses_a_full_cache():
    with pytest.raises(ValueError, match="seq_cache"):
        get_workload("decode_step").build(
            device="cpu", batch=2, seq_cache=8, heads=2, head_dim=8,
            layers=1, dtype="float32", pos=8)


def test_decode_module_signature():
    module, args = get_workload("decode_step").build(
        device="cpu", **_kw("decode_step"))
    assert isinstance(module, DecodeStep)
    assert args[3].dtype == torch.int32 and args[3].dim() == 0


# ---------------------------------------------------------------------------
# (iv) commands, (v) pricing in both packages, (vi) against the JAX capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_commandlist_equals_the_reference(name, traces):
    port, ref = traces(name)
    assert ((port / "commandlist.jsonl").read_text()
            == (ref / "commandlist.jsonl").read_text())
    meta = json.loads((port / "meta.json").read_text())
    assert list(meta) == list(json.loads((ref / "meta.json").read_text()))
    assert meta["xla_cost_analysis"] == {} and meta["memory_analysis"] == {}


@pytest.mark.parametrize("name", NAMES)
def test_port_trace_prices_the_same_in_both_packages(name, traces):
    port, _ = traces(name)
    want = _stats(ref_simulate(port, arch="v5e", tuned=False))
    got = _stats(port_simulate(port, arch="v5e", tuned=False))
    assert got == want
    assert got["tot_unknown_trip_loops"] == 0
    assert got["kernel_launches"] == 2
    text = (port / "modules" / f"{name}.hlo").read_text()
    if name in ("lstm_layer", "decode_step"):
        assert " while(" in text and "known_trip_count" in text
    if name == "decode_step":
        assert "dynamic-update-slice(" in text and "scatter(" not in text


def _ratios(port: Path, ref: Path) -> dict[str, float]:
    got = _stats(port_simulate(port, arch="v5e", tuned=False))
    want = _stats(ref_simulate(ref, arch="v5e", tuned=False))
    return {k: (got[k] / want[k] if want[k] else float("nan"))
            for k in ("tot_mxu_flops", "tot_flops", "tot_hbm_bytes",
                      "tot_sim_cycles")} | {
        "mxu": (got["tot_mxu_flops"], want["tot_mxu_flops"]),
    }


@pytest.mark.parametrize("name", NAMES)
def test_against_the_jax_capture_float32(name, traces):
    r = _ratios(*traces(name))
    port_mxu, ref_mxu = r.pop("mxu")
    lo, hi = BYTE_BAND[name]
    assert port_mxu == pytest.approx(ref_mxu, rel=1e-9, abs=0), r
    assert lo <= r["tot_hbm_bytes"] <= hi, r


@pytest.mark.parametrize("name", [n for n in NAMES if _has_dtype(n)])
def test_mxu_flops_equal_the_jax_capture_bfloat16(name, traces):
    r = _ratios(*traces(name, "bfloat16"))
    port_mxu, ref_mxu = r.pop("mxu")
    assert port_mxu == pytest.approx(ref_mxu, rel=1e-9, abs=0), r


# ---------------------------------------------------------------------------
# (vii) capture runs nothing on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_capture_sees_only_fake_tensors(name, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensor

    module, args = get_workload(name).build(device="cpu", **_kw(name))
    before = [a.clone() for a in args]
    seen: list[bool] = []
    forward = module.forward

    def spy(*a):
        seen.append(all(isinstance(t, FakeTensor) for t in a
                        if isinstance(t, torch.Tensor)))
        return forward(*a)

    monkeypatch.setattr(module, "forward", spy)
    cap = capture(module, *args, name=name)
    assert seen and all(seen)
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    assert cap.in_bytes == sum(a.numel() * a.element_size() for a in args)


if __name__ == "__main__":   # the float32 ratio table of PERF.md
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        print("| workload | mxu flops | flops | HBM bytes | sim cycles | "
              "JAX meta flops | JAX simulated flops |")
        print("|---|---|---|---|---|---|---|")
        for name in NAMES:
            ref = _ref_trace(Path(tmp), name)
            r = _ratios(_port_trace(Path(tmp), name), ref)
            r.pop("mxu")
            meta = json.loads((ref / "meta.json").read_text())
            sim = _stats(ref_simulate(ref, arch="v5e", tuned=False))
            print(f"| {name} | " + " | ".join(
                f"{r[k]:.4f}" for k in ("tot_mxu_flops", "tot_flops",
                                        "tot_hbm_bytes", "tot_sim_cycles"))
                + f" | {meta['xla_cost_analysis'].get('flops', 0):.0f}"
                f" | {sim['tot_flops'] / sim['kernel_launches']:.0f} |")
