"""The RMSNorm kernel and the decoders' route to it.

On the CPU:

* the plain version (:func:`~tpusim_torch.kernels.rms_norm.rms_norm_reference`)
  is the decoders' float32 chain, and ``blocks._rmsnorm`` runs that chain
  bit for bit wherever the kernel is not taken: on the CPU, in float32,
  with a gradient recorded, under ``make_fx`` and ``torch.export``, in the
  train step (under ``torch.func.vjp``), the AOT step recording a gradient
  and the vmap rank runner (with the device check, ``blocks._on_card``,
  forced open and the wrapper made to raise);
* a no-grad bf16 AOT step takes the op in its layers' forward and in its
  backward's recompute, its head (under ``torch.func.vjp``) the chain;
* with the device check forced open, a no-grad bf16 forward of each
  decoder takes the op ``tpusim_torch::rms_norm`` once a norm (2L + 1 in
  the Llama decoder, 3L + 1 in DeepSeek-V2's, the latent norm read in
  place), inside the norm range, the plain version standing in for the
  launch, and its logits are the chain's;
* the kernel's domain (``rms_norm_takes``, dtypes and widths) holds every
  norm of the full-size decoders the benchmark runs or the port registers
  (over meta tensors, DeepSeek-V2-Lite's latent view 576 elements a row
  included) and sends float32, a dim that is not a multiple of 8 and a row
  too wide for the registers to the chain; a misaligned base, a row stride
  that is not a multiple of 8, rows not evenly apart and a weight of
  another width reach the kernel and raise there, before a launch;
* ``mechanism_faults.no_latent_norm`` still changes DeepSeek-V2's logits
  with the norms on the op's route;
* with the kernel's library stubbed, the wrapper passes the rows, the
  width and the row stride, counts each launch, refuses before a launch,
  launches nothing for no rows and raises on a launch's error;
* the HLO of ``llama_tiny`` and ``llama7b``, captured with the device
  check forced open, is the parent commit's.

On an NVIDIA card (skipped without one; ``python -m pytest
tests/test_torch_rms_norm.py -q`` there): the kernel against the chain
within atol = rtol 1e-2 (one bf16 ulp, as the causal kernel's tests hold
it) at the decoders' shapes and edges, and one launch a norm in a forward
of each decoder.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

import chip_smoke  # noqa: E402
from benchmark import mechanism_faults, spec  # noqa: E402
from tpusim_torch.kernels import rms_norm as rn  # noqa: E402
from tpusim_torch.models import blocks, get_workload  # noqa: E402
from tpusim_torch.models import deepseek_v2 as ds  # noqa: E402
from tpusim_torch.models import llama as port_llama  # noqa: E402
from tpusim_torch.models.llama_aot import build_llama_aot  # noqa: E402
from tpusim_torch.tracer.capture import (  # noqa: E402
    capture_graph,
    export_to_hlo,
)

REPO = Path(__file__).resolve().parents[1]
#: the kernel against the chain on the card: one bf16 ulp (the kernel
#: differs from the chain only in the order of a row's sum)
CARD_TOL = 1e-2


def parent_chain(x, w, eps):
    """``_rmsnorm`` as the decoders ran it before the kernel."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * w


def _xw(shape, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen)).to(dtype)
    return x, w


@pytest.fixture
def device_open(monkeypatch):
    """The decoders' device check forced open: what a CUDA tensor would
    pass, on the CPU."""
    monkeypatch.setattr(blocks, "_on_card", lambda x: True)


@pytest.fixture
def op_calls(device_open, monkeypatch):
    """The wrapper counted: each call's ``(x, w)``, the plain version
    standing in for the launch."""
    calls = []
    plain = rn.rms_norm_fwd

    def counted(x, w, eps):
        calls.append((x, w))
        return plain(x, w, eps)

    monkeypatch.setattr(rn, "rms_norm_fwd", counted)
    return calls


@pytest.fixture
def norm_raises(device_open, monkeypatch):
    def refuse(x, w, eps):
        raise AssertionError("the RMSNorm kernel was reached")

    monkeypatch.setattr(rn, "rms_norm_fwd", refuse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_the_plain_version_is_the_chain(dtype, eps):
    x, w = _xw((3, 5, 64), dtype)
    assert torch.equal(rn.rms_norm_reference(x, w, eps),
                       parent_chain(x, w, eps))
    assert torch.equal(rn.rms_norm_fwd(x, w, eps), parent_chain(x, w, eps))


@pytest.mark.parametrize("case", ["cpu", "float32", "grad"])
def test_rmsnorm_runs_the_chain_bit_for_bit(norm_raises, monkeypatch, case):
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    x, w = _xw((2, 16, 128), dtype)
    if case == "cpu":
        monkeypatch.setattr(blocks, "_on_card", lambda t: t.is_cuda)
    if case == "grad":
        x.requires_grad_()
        got = blocks._rmsnorm(x, w, 1e-5)
        got.float().sum().backward()
        assert x.grad is not None
    else:
        with torch.no_grad():
            got = blocks._rmsnorm(x, w, 1e-5)
    assert torch.equal(got.detach(), parent_chain(x.detach(), w, 1e-5))


@pytest.mark.parametrize("how", ["make_fx_fake", "make_fx_real", "export"])
def test_a_capture_holds_the_chain(norm_raises, how):
    x, w = _xw((2, 16, 128))

    class Norm(torch.nn.Module):
        def forward(self, x, w):
            return blocks._rmsnorm(x, w, 1e-6)

    with torch.no_grad():
        if how == "export":
            gm = capture_graph(Norm(), (x, w))
        else:
            gm = make_fx(Norm(), tracing_mode=how.split("_")[-1])(x, w)
    targets = {str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"}
    assert not any("rms_norm" in t for t in targets)
    assert any("rsqrt" in t for t in targets)


@pytest.mark.parametrize("caller", [
    "train_step", "train_step_no_grad", "aot_step_bfloat16", "aot_step_float32",
    "forward_with_grad", "sharded_vmap_ranks"])
def test_callers_that_keep_the_chain_never_reach_the_kernel(norm_raises,
                                                           caller):
    if caller.startswith("train_step"):
        module, args = get_workload("llama_tiny_train").build(
            device="cpu", batch=2, seq=16)
        with (torch.no_grad() if caller.endswith("no_grad")
              else torch.enable_grad()):
            loss, *_ = module(*args)
        assert torch.isfinite(loss)
    elif caller.startswith("aot_step"):
        # in float32 under no_grad; in bf16 recording a gradient (a no-grad
        # bf16 step takes the op: the next test)
        dtype = caller.split("_")[-1]
        module, args = build_llama_aot(preset="tiny", batch=2, seq=16, dp=1,
                                       tp=1, device="cpu", dtype=dtype)
        with (torch.no_grad() if dtype == "float32"
              else torch.enable_grad()):
            loss, *_ = module(*args)
        assert torch.isfinite(loss)
    elif caller == "forward_with_grad":
        module, args = get_workload("llama_tiny").build(device="cpu", seq=16)
        params = [a.requires_grad_() if a.is_floating_point() else a
                  for a in args]
        module(*params).float().sum().backward()
    else:
        module, args = port_llama.build_llama(
            preset="tiny", batch=2, seq=16, dp=1, tp=2, train=False,
            device="cpu")
        with torch.no_grad():
            assert torch.isfinite(module.run(*args).float()).all()


def test_a_no_grad_aot_step_takes_the_op_in_its_layers(op_calls,
                                                       monkeypatch):
    module, args = build_llama_aot(preset="tiny", batch=2, seq=16, dp=1,
                                   tp=1, device="cpu", dtype="bfloat16")
    with torch.no_grad():
        got = module(*args)
        # two norms a layer forward, the same two recomputed backward
        assert len(op_calls) == 4 * module.cfg.layers
        monkeypatch.setattr(blocks, "_on_card", lambda x: False)
        want = module(*args)
    assert len(op_calls) == 4 * module.cfg.layers
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_forward_reaches_the_patched_kernel(norm_raises):
    # the control: the patch is live where the kernel path is taken
    module, args = get_workload("llama_tiny").build(device="cpu", seq=16)
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        module(*args)


@pytest.mark.parametrize("name", ["llama_tiny", "deepseek_v2_tiny"])
def test_each_norm_of_a_forward_takes_the_op(op_calls, monkeypatch, name):
    module, args = get_workload(name).build(device="cpu", seq=40)
    cfg = module.cfg
    with torch.no_grad():
        got = module(*args)
        calls = list(op_calls)
        monkeypatch.setattr(blocks, "_on_card", lambda x: False)
        want = module(*args)
    assert len(op_calls) == len(calls)
    assert torch.equal(got, want)
    hidden = [(tuple(x.shape), x.is_contiguous()) for x, w in calls
              if w.shape[0] == cfg.dim]
    assert hidden == [((2 if name.startswith("deepseek") else 4, 40,
                        cfg.dim), True)] * len(hidden)
    if name == "llama_tiny":
        assert len(calls) == 2 * cfg.layers + 1 == len(hidden)
        return
    assert len(calls) == 3 * cfg.layers + 1
    latent = [x for x, w in calls if w.shape[0] == cfg.kv_lora_rank]
    assert len(latent) == cfg.layers
    # read in place: the first kv_lora_rank of each row of the latent and
    # rotary key product
    row = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert all(x.stride()[-2:] == (row, 1) for x in latent)
    assert all(rn._row_stride(x) == row for x in latent)


def test_the_norm_op_is_an_op_for_a_profiler(device_open):
    from torch.profiler import ProfilerActivity, profile

    module, args = get_workload("llama_tiny").build(device="cpu", seq=16)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        module(*args)
    spans = {name: [e.time_range for e in prof.events() if e.name == name]
             for name in ("tpusim_torch::rms_norm", blocks.NORM_RANGE)}
    ops, norms = spans.values()
    assert len(ops) == len(norms) == 2 * module.cfg.layers + 1
    for op, outer in zip(sorted(ops, key=lambda r: r.start),
                         sorted(norms, key=lambda r: r.start)):
        assert outer.start <= op.start and op.end <= outer.end


class _Stop(Exception):
    pass


def _meta_norms(name: str, limit: int | None):
    """The ``(x, w)`` of each norm a forward of ``name`` over meta tensors
    hands ``_rmsnorm``, the forward stopped after ``limit`` norms: a
    registered workload or a configuration of ``BENCHMARK.json``
    (``bench:<config>``)."""
    if name.startswith("bench:"):
        files = {c["name"]: c["file"]
                 for c in spec.load_json(REPO / "BENCHMARK.json")["configs"]}
        config = spec.load_json(REPO / files[name[len("bench:"):]])
        module = spec.family(config["family"]).build(config, "meta")
        program = ds if isinstance(module, ds.DeepseekV2Forward) \
            else port_llama
        tokens = torch.empty((1, 16), dtype=torch.int32, device="meta")
        args = (*program.init_params(module.cfg, "meta"), tokens)
    else:
        module, args = get_workload(name).build(device="meta", seq=16)
        program = ds if name.startswith("deepseek") else port_llama
    seen = []
    norm = program._rmsnorm

    def record(x, w, eps):
        seen.append((x, w))
        if len(seen) == limit:
            raise _Stop
        return norm(x, w, eps)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(program, "_rmsnorm", record)
        with torch.no_grad():
            try:
                module(*args)
            except _Stop:
                pass
    return module.cfg, seen


@pytest.mark.parametrize("name", [
    "bench:mistral7b", "bench:deepseek7b", "bench:dsv2lite", "llama7b",
    "deepseek_v2_lite", "llama_tiny", "deepseek_v2_tiny"])
def test_the_kernel_takes_every_norm_of_each_decoder(name):
    # a norm outside the domain runs the chain on the card: this pins each
    # one inside it.  DeepSeek-V2's forward stops at its first expert layer
    # (the routing reads counts a meta tensor does not hold): its dense
    # layer's three norms, the latent's among them
    deepseek = name in ("bench:dsv2lite", "deepseek_v2_lite",
                        "deepseek_v2_tiny")
    cfg, seen = _meta_norms(name, 4 if deepseek else None)
    if deepseek:
        seen = seen[:3]
        x, w = seen[1]
        assert w.shape[0] == cfg.kv_lora_rank
        assert rn._row_stride(x) == cfg.kv_lora_rank + cfg.qk_rope_head_dim
        assert not x.is_contiguous()
    else:
        assert len(seen) == 2 * cfg.layers + 1
    assert all(x.device.type == "meta" for x, _ in seen)
    assert all(rn.rms_norm_takes(x, w) for x, w in seen)
    # and the layout each hands the kernel is one it reads
    assert all(rn._row_stride(x) is not None and rn._row_stride(x) % 8 == 0
               and w.is_contiguous() for x, w in seen)


def test_the_benchmark_weights_keep_the_norms_in_the_domain():
    # the benchmark draws every norm as a view of one buffer of ones: each
    # view starts on a 16-byte boundary
    for config in ("mistral7b", "dsv2lite"):
        cfg = spec.load_json(REPO / f"benchmark/configs/{config}.json")
        fam = spec.family(cfg["family"])
        shapes = [s for _, s in fam.param_shapes(fam.dims(cfg))]
        norms = [s for s in shapes if len(s) == 1]
        offsets = [sum(torch.Size(s).numel() for s in norms[:i])
                   for i in range(len(norms))]
        assert norms and all(o % 8 == 0 for o in offsets)


@pytest.mark.parametrize("case, err", [
    ("float32", TypeError), ("w_float32", TypeError),
    ("misaligned_base", ValueError), ("odd_dim", ValueError),
    ("dim_not_a_multiple_of_8", ValueError),
    ("row_stride_not_a_multiple_of_8", ValueError),
    ("too_wide", ValueError), ("rows_not_evenly_apart", ValueError),
    ("w_of_another_width", ValueError)])
def test_the_domain_refuses_what_the_kernel_does_not_take(stub_kernel,
                                                          device_open,
                                                          monkeypatch, case,
                                                          err):
    # the dtype and the width choose the route, and a meta tensor answers
    # them; a layout the kernel cannot read reaches it and raises there
    calls, _ = stub_kernel
    monkeypatch.setattr(rn, "rms_norm_fwd", rn._cuda_rms_norm)
    dim = 512
    x, w = _xw((2, 16, dim))
    if case == "float32":
        x = x.float()
    elif case == "w_float32":
        w = w.float()
    elif case == "misaligned_base":
        x = _xw((2, 16, dim + 8))[0][..., 4:dim + 4]
    elif case == "odd_dim":
        x, w = x[..., :dim - 1], w[:dim - 1]
    elif case == "dim_not_a_multiple_of_8":
        x, w = x[..., :dim - 4], w[:dim - 4]
    elif case == "row_stride_not_a_multiple_of_8":
        x = _xw((2, 16, dim + 4))[0][..., :dim]
    elif case == "too_wide":
        x, w = _xw((2, rn.MAX_DIM + 8))
    elif case == "rows_not_evenly_apart":
        x = _xw((16, 2, dim))[0].transpose(0, 1)
    else:
        w = w[:dim // 2]
    layout = case in ("misaligned_base", "row_stride_not_a_multiple_of_8",
                      "rows_not_evenly_apart", "w_of_another_width")
    meta = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="meta")
    assert rn.rms_norm_takes(meta, w.to("meta")) is layout
    with torch.no_grad():
        if layout:
            with pytest.raises(err):
                blocks._rmsnorm(x, w, 1e-5)
        else:
            assert torch.equal(blocks._rmsnorm(x, w, 1e-5),
                               parent_chain(x, w, 1e-5))
    with pytest.raises(err):
        rn._cuda_rms_norm(x, w, 1e-5)
    assert rn.launch_count() == 0 and not calls
    # the widest and the strided rows it does take
    wide = torch.empty(3, rn.MAX_DIM, dtype=torch.bfloat16, device="meta")
    assert rn.rms_norm_takes(wide, wide[0])
    latent = torch.empty(2, 64, 576, dtype=torch.bfloat16,
                         device="meta")[..., :512]
    assert rn.rms_norm_takes(latent, latent[0, 0])


def test_the_row_stride():
    assert rn._row_stride(torch.empty(2, 8, 64)) == 64
    assert rn._row_stride(torch.empty(2, 8, 72)[..., :64]) == 72
    assert rn._row_stride(torch.empty(1, 1, 64)) == 64
    assert rn._row_stride(torch.empty(8, 1, 2, 64)[:, :, 1]) == 128
    assert rn._row_stride(torch.empty(8, 2, 64).transpose(0, 1)) is None
    assert rn._row_stride(torch.empty(2, 64, 8).transpose(1, 2)) is None
    assert rn._row_stride(torch.empty(2, 8, 64)[:, ::2]) == 128


def test_the_latent_norm_fault_still_bites_on_the_ops_route(op_calls):
    module, args = get_workload("deepseek_v2_tiny").build(device="cpu")
    cfg = module.cfg
    config = {"kv_lora_rank": cfg.kv_lora_rank, "hidden_size": cfg.dim}
    with torch.no_grad():
        good = module(*args)
        assert len(op_calls) == 3 * cfg.layers + 1
        op_calls.clear()
        with mechanism_faults.no_latent_norm(config):
            bad = module(*args)
        assert len(op_calls) == 2 * cfg.layers + 1
        op_calls.clear()
        again = module(*args)
    assert len(op_calls) == 3 * cfg.layers + 1
    assert torch.equal(again, good)
    assert not torch.allclose(bad.float(), good.float(), atol=1e-2,
                              rtol=1e-2)


class _StubEntry:
    """A C entry of a kernel library: records its arguments, returns
    ``err``."""

    def __init__(self, calls: list, err):
        self.argtypes = self.restype = None
        self.calls, self.err = calls, err

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _StubLibrary:
    def __init__(self, calls: list, err: int):
        self.tpusim_rms_norm_fwd = _StubEntry(calls, err)
        self.tpusim_cuda_error_string = _StubEntry([], b"invalid argument")


@pytest.fixture
def stub_kernel(monkeypatch):
    """The kernel's library stubbed and the stream taken as 0: the launch
    path runs on CPU tensors.  Returns the entry's calls and a dict whose
    ``err`` the entry returns."""
    calls: list = []
    state = {"err": 0}
    monkeypatch.setattr(rn, "load_library",
                        lambda name: _StubLibrary(calls, state["err"]))
    monkeypatch.setattr(rn, "_on_stream", lambda x, launch: launch(0))
    rn.reset_launch_count()
    yield calls, state
    rn.reset_launch_count()


@pytest.mark.parametrize("case", ["hidden", "latent_in_place", "one_row"])
def test_the_wrapper_passes_the_rows_and_counts_each_launch(stub_kernel,
                                                            case):
    calls, _ = stub_kernel
    if case == "latent_in_place":
        kv, w = _xw((2, 24, 576))
        x, w = kv[..., :512], w[:512]
    else:
        x, w = _xw((1, 1, 4096) if case == "one_row" else (2, 24, 4096))
    out = rn._cuda_rms_norm(x, w, 1e-6)
    assert out.shape == x.shape and out.is_contiguous()
    assert out.dtype == torch.bfloat16
    assert rn.launch_count() == 1
    (args,) = calls
    rows = x.numel() // x.shape[-1]
    assert args[:3] == (x.data_ptr(), w.data_ptr(), out.data_ptr())
    assert args[3:6] == (rows, x.shape[-1], x.stride(-2))
    assert args[6] == 1e-6 and args[7] == 0
    rn._cuda_rms_norm(x, w, 1e-6)
    assert rn.launch_count() == 2
    rn.reset_launch_count()
    assert rn.launch_count() == 0


@pytest.mark.parametrize("case, err", [
    ("float32", TypeError), ("misaligned", ValueError),
    ("row_stride", ValueError), ("launch_error", RuntimeError)])
def test_the_wrapper_refuses_before_a_launch(stub_kernel, case, err):
    calls, state = stub_kernel
    x, w = _xw((2, 8, 256))
    if case == "float32":
        x = x.float()
    elif case == "misaligned":
        x = _xw((2, 8, 264))[0][..., 4:260]
    elif case == "row_stride":
        x = _xw((2, 8, 260))[0][..., :256]
    else:
        state["err"] = 1
    with pytest.raises(err):
        rn._cuda_rms_norm(x, w, 1e-5)
    assert rn.launch_count() == 0
    assert len(calls) == (1 if case == "launch_error" else 0)


def test_no_rows_launch_nothing(stub_kernel):
    calls, _ = stub_kernel
    x, w = _xw((0, 4096))
    out = rn._cuda_rms_norm(x, w, 1e-5)
    assert out.shape == (0, 4096) and out.dtype == torch.bfloat16
    assert rn.launch_count() == 0 and not calls


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    x, w = _xw((3, 40, 96))
    assert torch.equal(rn.rms_norm_fwd(x, w, 1e-5), parent_chain(x, w, 1e-5))
    with pytest.raises(ValueError):
        rn.rms_norm_fwd(x.to("meta"), w.to("meta"), 1e-5)


@pytest.mark.parametrize("name", sorted(chip_smoke.CAUSAL_HLO_DIGESTS))
def test_the_captured_hlo_is_the_parents(device_open, name):
    # with the device check open a capture still holds the chain: the text
    # equals the commit before the kernels by bytes
    dev = "cpu" if name == "llama_tiny" else "meta"
    module, args = get_workload(name).build(device=dev)
    text, _ = export_to_hlo(module, args, name)
    digest = hashlib.sha256(text.encode()).hexdigest()
    assert digest == chip_smoke.CAUSAL_HLO_DIGESTS[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false on this host")
    return torch.device("cuda")


#: the kernel's shapes on the card: (label, x's shape, the row's width in
#: memory, eps)
CARD_SHAPES = [
    ("mistral_2k", (2, 2048, 4096), 4096, 1e-5),
    ("mistral_256", (16, 256, 4096), 4096, 1e-5),
    ("deepseek_2k", (2, 2048, 4096), 4096, 1e-6),
    ("dsv2lite_hidden", (1, 16384, 2048), 2048, 1e-6),
    ("dsv2lite_latent", (1, 16384, 512), 576, 1e-6),
    ("one_row", (1, 1, 4096), 4096, 1e-5),
    ("rows_333", (1, 333, 4096), 4096, 1e-6),
    ("rows_333_latent", (1, 333, 512), 576, 1e-5),
]


@pytest.mark.parametrize("label, shape, row, eps", CARD_SHAPES,
                         ids=[s[0] for s in CARD_SHAPES])
def test_the_kernel_is_the_chain_on_the_card(card, label, shape, row, eps):
    gen = torch.Generator(device=card).manual_seed(5)
    full = torch.randn((*shape[:-1], row), generator=gen, device=card,
                       dtype=torch.bfloat16)
    x = full[..., :shape[-1]]
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device=card)
         ).to(torch.bfloat16)
    rn.reset_launch_count()
    got = rn.rms_norm_fwd(x, w, eps)
    torch.cuda.synchronize()
    assert rn.launch_count() == 1
    want = parent_chain(x, w, eps)
    torch.testing.assert_close(got.float(), want.float(), atol=CARD_TOL,
                               rtol=CARD_TOL)
    # the same roundings: most elements agree to the bit
    assert (got == want).float().mean().item() > 0.99


@pytest.mark.parametrize("name, norms", [
    ("llama_tiny", lambda c: 2 * c.layers + 1),
    ("llama7b", lambda c: 2 * c.layers + 1),
    ("deepseek_v2_tiny", lambda c: 3 * c.layers + 1),
    ("deepseek_v2_lite", lambda c: 3 * c.layers + 1)])
def test_one_launch_a_norm_in_a_forward_on_the_card(card, name, norms):
    module, args = get_workload(name).build(device="cuda", seq=256)
    with torch.no_grad():
        rn.reset_launch_count()
        got = module(*args)
        torch.cuda.synchronize()
        launches = rn.launch_count()
    assert launches == norms(module.cfg)
    assert torch.isfinite(got.float()).all()
    del module, args, got
    torch.cuda.empty_cache()
