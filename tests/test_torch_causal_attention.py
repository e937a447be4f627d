"""The causal attention kernel and the decoders' route to it, on the CPU.

* :func:`~tpusim_torch.kernels.flash_attention.causal_attention_reference`
  (the kernel's plain version, which the wrapper takes for CPU tensors)
  against the decoders' score chain (``blocks.score_chain``, what a
  captured graph holds) on ``[B, S, H, D]`` queries and grouped
  ``[B, S, KVH, D]`` keys and values, in float32.  Tolerance: atol and
  rtol 1e-5; both compute in float32 and differ only in summation order
  and in the chain's division by √D where the plain version multiplies by
  its reciprocal (at most 6e-7 apart here);
* the wrapper refuses what neither route takes, and the kernel's layout
  (rows of packed heads, any number of elements apart) is told apart
  from the rest before a launch;
* with the device check (``blocks._on_card``) and the kernel's domain
  (``causal_kernel_takes``) forced open, a no-grad forward of
  ``LlamaForward`` takes the kernel path once a layer, the plain version
  standing in for the launch, and its logits match the chain's; a
  profiler sees each launch inside a dispatched
  ``tpusim_torch::causal_attention`` op (the op a profile links its kernel
  to) inside the layer's attention range;
* with only the device check forced open, a head dim or a dtype outside
  the kernel's domain runs the score chain and never reaches the wrapper;
* the kernel's domain holds the attention of every full-size decoder the
  port registers or the benchmark runs, and not the test-size ones nor a
  float32 build (read over meta tensors);
* with the kernel's library stubbed, the wrapper launches the kernel for
  bf16 at head dims 128 / 128 and 192 / 128 in rows TMA addresses, counts
  each launch, and refuses the rest before any launch;
* with both forced open and the wrapper made to raise, the
  callers that keep the chain never reach it: a gradient or ``torch.func``
  transform (``LlamaTrainStep``), the scanned AOT step (``llama_aot``,
  whose backward reads the probabilities), the vmap rank runner of
  ``LlamaForwardSharded``, and captures (``torch.export``, ``make_fx``),
  whose graphs stay the score chain.
"""

from __future__ import annotations

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from benchmark import spec  # noqa: E402
from tpusim_torch.kernels import flash_attention as fa  # noqa: E402
from tpusim_torch.models import blocks, get_workload  # noqa: E402
from tpusim_torch.models import deepseek_v2 as ds  # noqa: E402
from tpusim_torch.models import llama as port_llama  # noqa: E402
from tpusim_torch.models.llama_aot import build_llama_aot  # noqa: E402
from tpusim_torch.tracer.capture import capture_graph  # noqa: E402

TOL = 1e-5
HEADS = 4


def _qkv(batch, seq, heads, kv_heads, hd, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(batch, seq, heads, hd, generator=gen)
    k, v = (torch.randn(batch, seq, kv_heads, hd, generator=gen)
            for _ in range(2))
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("seq", [1, 200, 256])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("rep", [1, 4])
def test_plain_version_matches_the_score_chain(rep, hd, seq):
    q, k, v = _qkv(2, seq, HEADS, HEADS // rep, hd, seed=rep * hd + seq)
    *_, want = blocks.score_chain(q, k, v)
    got = fa.causal_attention_fwd(q, k, v)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(fa.causal_attention_reference(q, k, v), got,
                               atol=0, rtol=0)


def test_plain_version_reads_no_later_key_and_keeps_the_dtype():
    q, k, v = _qkv(1, 48, 8, 2, 64, seed=3)
    out = fa.causal_attention_fwd(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 30:] += 5.0
    v2[:, 30:] -= 5.0
    changed = fa.causal_attention_fwd(q, k2, v2)
    assert torch.equal(changed[:, :30], out[:, :30])
    assert not torch.equal(changed[:, 30:], out[:, 30:])
    # query head h reads key/value head h // 4
    q8 = q[:, :, :1].expand(-1, -1, 8, -1)
    o8 = fa.causal_attention_fwd(q8, k, v)
    assert torch.equal(o8[:, :, 1:4], o8[:, :, :1].expand(-1, -1, 3, -1))
    assert not torch.equal(o8[:, :, 4], o8[:, :, 0])
    bq, bk, bv = _qkv(1, 48, 8, 2, 64, dtype=torch.bfloat16, seed=3)
    assert fa.causal_attention_fwd(bq, bk, bv).dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["rank", "shape", "heads", "dtype",
                                  "head_dim", "device"])
def test_causal_wrapper_refuses_what_it_does_not_take(case):
    q, k, v = _qkv(1, 16, 4, 2, 32)
    if case == "rank":
        args, err = (q[0], k[0], v[0]), ValueError
    elif case == "shape":
        args, err = (q, k[:, :8], v[:, :8]), ValueError
    elif case == "heads":
        args, err = (q, *_qkv(1, 16, 4, 3, 32)[1:]), ValueError
    elif case == "dtype":
        args, err = (q.double(), k.double(), v.double()), TypeError
    elif case == "head_dim":
        args, err = _qkv(1, 16, 4, 2, 160), ValueError
    else:
        args, err = (x.to("meta") for x in (q, k, v)), ValueError
    with pytest.raises(err):
        fa.causal_attention_fwd(*args)


@pytest.fixture
def device_open(monkeypatch):
    """The decoders' device check forced open: what a CUDA tensor would
    pass, on the CPU."""
    monkeypatch.setattr(blocks, "_on_card", lambda x: True)


@pytest.fixture
def on_card(device_open, monkeypatch):
    """The device check and the kernel's domain forced open, so that the
    tiny float32 configurations take the kernel path (the plain version
    standing in for the launch)."""
    monkeypatch.setattr(fa, "causal_kernel_takes", lambda q, k, v: True)


@pytest.mark.parametrize("kv_heads", [4, 2, 1])
def test_forced_kernel_path_gives_the_chains_logits(on_card, monkeypatch,
                                                    kv_heads):
    module, args = get_workload("llama_tiny").build(
        device="cpu", seq=40, kv_heads=kv_heads, dtype="float32")
    calls = []
    plain = fa.causal_attention_fwd

    def counted(q, k, v, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), scale))
        return plain(q, k, v, scale)

    with torch.no_grad():
        monkeypatch.setattr(blocks, "_on_card", lambda x: False)
        want = module(*args)
        monkeypatch.setattr(blocks, "_on_card", lambda x: True)
        monkeypatch.setattr(fa, "causal_attention_fwd", counted)
        got = module(*args)
    cfg = module.cfg
    assert calls == [((4, 40, cfg.heads, cfg.head_dim),
                      (4, 40, kv_heads, cfg.head_dim), None)] * cfg.layers
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.fixture
def kernel_raises(on_card, monkeypatch):
    def refuse(q, k, v, scale=None):
        raise AssertionError("the causal kernel was reached")

    monkeypatch.setattr(fa, "causal_attention_fwd", refuse)


def test_a_forward_reaches_the_patched_kernel(kernel_raises):
    # the control: the patch is live where the kernel path is taken
    module, args = get_workload("llama_tiny").build(device="cpu", seq=16)
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        module(*args)


@pytest.mark.parametrize("case", ["head_dim", "dtype"])
def test_what_the_kernel_does_not_take_runs_the_score_chain(device_open,
                                                            monkeypatch,
                                                            case):
    # the kernel's domain decides before the op: bf16 at head dim 160, and
    # float32 at head dim 128, run the chain on the card
    if case == "head_dim":
        module, args = get_workload("llama_tiny").build(
            device="cpu", seq=16, dim=4 * 160)
    else:
        module, args = get_workload("llama_tiny").build(
            device="cpu", seq=16, dim=4 * 128, dtype="float32")
    calls = []
    plain = fa.causal_attention_fwd

    def counted(q, k, v, scale=None):
        calls.append(tuple(q.shape))
        return plain(q, k, v, scale)

    monkeypatch.setattr(fa, "causal_attention_fwd", counted)
    with torch.no_grad():
        got = module(*args)
        monkeypatch.setattr(blocks, "_on_card", lambda x: False)
        want = module(*args)
    assert calls == []
    assert torch.equal(got, want)


class _Reached(Exception):
    pass


def _first_attention(program, module, args):
    """The q, k, v that ``module``'s first layer hands the attention of
    ``program`` (its module), the forward stopped there."""
    seen = []

    def record(q, k, v, scale=None):
        seen.append((q, k, v))
        raise _Reached

    with pytest.MonkeyPatch.context() as m:
        m.setattr(program, "causal_attention", record)
        with torch.no_grad(), pytest.raises(_Reached):
            module(*args)
    return seen[0]


def _meta_decoder(name: str):
    """A decoder and its arguments over meta tensors: a registered
    workload (``name`` with ``_float32``: its float32 build) or a
    configuration of ``BENCHMARK.json`` (``bench:<config>``)."""
    if name.startswith("bench:"):
        root = Path(__file__).resolve().parents[1]
        files = {c["name"]: c["file"]
                 for c in spec.load_json(root / "BENCHMARK.json")["configs"]}
        config = spec.load_json(root / files[name[len("bench:"):]])
        module = spec.family(config["family"]).build(config, "meta")
        program = ds if isinstance(module, ds.DeepseekV2Forward) \
            else port_llama
        tokens = torch.empty((1, 16), dtype=torch.int32, device="meta")
        return program, module, (*program.init_params(module.cfg, "meta"),
                                 tokens)
    workload = name.removesuffix("_float32")
    kw = {"dtype": "float32"} if workload != name else {}
    module, args = get_workload(workload).build(device="meta", seq=16, **kw)
    program = ds if workload.startswith("deepseek") else port_llama
    return program, module, args


@pytest.mark.parametrize("name, takes", [
    ("llama7b", True), ("deepseek_v2_lite", True),
    ("bench:mistral7b", True), ("bench:deepseek7b", True),
    ("bench:dsv2lite", True), ("llama_tiny", False),
    ("deepseek_v2_tiny", False), ("llama7b_float32", False)])
def test_the_kernel_takes_every_full_size_decoder(name, takes):
    # a full-size decoder outside the domain would run the score chain on
    # the card without a word: this pins each one inside it
    program, module, args = _meta_decoder(name)
    q, k, v = _first_attention(program, module, args)
    assert q.device.type == "meta"
    assert fa.causal_kernel_takes(q, k, v) is takes


@pytest.mark.parametrize("caller", [
    "train_step", "train_step_no_grad", "aot_step", "forward_with_grad",
    "sharded_vmap_ranks", "export", "make_fx_fake", "make_fx_real"])
def test_callers_that_keep_the_chain_never_reach_the_kernel(kernel_raises,
                                                           caller):
    if caller.startswith("train_step"):
        module, args = get_workload("llama_tiny_train").build(
            device="cpu", batch=2, seq=16)
        with (torch.no_grad() if caller.endswith("no_grad")
              else torch.enable_grad()):
            loss, *_ = module(*args)
        assert torch.isfinite(loss)
    elif caller == "aot_step":
        module, args = build_llama_aot(preset="tiny", batch=2, seq=16, dp=1,
                                       tp=1, device="cpu", dtype="float32")
        with torch.no_grad():
            loss, *_ = module(*args)
        assert torch.isfinite(loss)
    elif caller == "forward_with_grad":
        module, args = get_workload("llama_tiny").build(device="cpu", seq=16)
        params = [a.requires_grad_() if a.is_floating_point() else a
                  for a in args]
        module(*params).float().sum().backward()
    elif caller == "sharded_vmap_ranks":
        module, args = port_llama.build_llama(
            preset="tiny", batch=2, seq=16, dp=1, tp=2, train=False,
            device="cpu", dtype="float32")
        with torch.no_grad():
            assert torch.isfinite(module.run(*args)).all()
    else:
        module, args = get_workload("llama_tiny").build(device="cpu", seq=16)
        with torch.no_grad():
            if caller == "export":
                gm = capture_graph(module, args)
            else:
                gm = make_fx(module,
                             tracing_mode=caller.split("_")[-1])(*args)
        targets = {str(n.target) for n in gm.graph.nodes
                   if n.op == "call_function"}
        assert not any("causal_attention" in t for t in targets)
        assert any("_softmax" in t for t in targets)


def test_the_layout_the_causal_kernel_reads():
    # rows of packed heads, any number of elements apart; anything else is
    # refused before a launch
    q = torch.empty(2, 8, 4, 16)
    assert fa._rows_apart(q) == 64
    wide = torch.empty(2, 8, 4 * 16 + 8)[..., :64].view(2, 8, 4, 16)
    assert fa._rows_apart(wide) == 72
    assert fa._rows_apart(q.transpose(1, 2).contiguous().transpose(1, 2)) \
        is None
    assert fa._rows_apart(torch.empty(2, 8, 4, 32)[..., :16]) is None
    assert fa._rows_apart(torch.empty(8, 2, 4, 16).transpose(0, 1)) is None
    assert fa._rows_apart(torch.empty(1, 8, 1, 16)[:, :, :, :]) == 16


def test_the_kernel_path_is_an_op_for_a_profiler(on_card):
    from torch.profiler import ProfilerActivity, profile

    module, args = get_workload("llama_tiny").build(device="cpu", seq=16)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        module(*args)
    spans = {name: [e.time_range for e in prof.events() if e.name == name]
             for name in ("tpusim_torch::causal_attention",
                          blocks.ATTENTION_RANGE)}
    ops, attention = spans.values()
    assert len(ops) == len(attention) == module.cfg.layers
    for op, outer in zip(sorted(ops, key=lambda r: r.start),
                         sorted(attention, key=lambda r: r.start)):
        assert outer.start <= op.start and op.end <= outer.end


class _StubEntry:
    """A C entry of a kernel library: records its arguments, returns
    ``err``."""

    def __init__(self, calls: list, err=0):
        self.argtypes = self.restype = None
        self.calls, self.err = calls, err

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _StubLibrary:
    def __init__(self, name: str, calls: dict, err: int):
        for entry in fa._ENTRIES[name]:
            setattr(self, entry, _StubEntry(calls.setdefault(entry, []), err))
        self.tpusim_cuda_error_string = _StubEntry([], b"invalid argument")


@pytest.fixture
def stub_kernels(monkeypatch):
    """The kernel libraries stubbed and the stream taken as 0: the launch
    path runs on CPU tensors.  Returns the calls by entry; ``err`` is what
    every entry returns."""
    calls: dict = {}
    state = {"err": 0}
    monkeypatch.setattr(fa, "load_library",
                        lambda name: _StubLibrary(name, calls, state["err"]))
    monkeypatch.setattr(fa, "_on_stream", lambda x, launch: launch(0))
    fa.reset_causal_launch_count()
    yield calls, state
    fa.reset_causal_launch_count()


def _latent_qkv(seq=16, heads=4, dtype=torch.bfloat16):
    """DeepSeek-V2's shapes: q, k over 192 dims, v read in place from the
    second half of each head's [keys, values] row."""
    gen = torch.Generator().manual_seed(11)
    q, k = (torch.randn(1, seq, heads, 192, generator=gen).to(dtype)
            for _ in range(2))
    kv = torch.randn(1, seq, heads, 256, generator=gen).to(dtype)
    return q, k, kv[..., 128:]


@pytest.mark.parametrize("case, refused", [
    ("bf16_128", None), ("bf16_192_128_in_place", None),
    ("bf16_rows_wider_by_16_bytes", None), ("f32_128", TypeError),
    ("f32_192_128", TypeError), ("bf16_64", ValueError),
    ("bf16_rows_wider_by_8_bytes", ValueError)])
def test_each_design_counts_the_launches_that_reach_it(stub_kernels, case,
                                                       refused):
    calls, _ = stub_kernels
    if case.startswith("bf16_192") or case == "f32_192_128":
        q, k, v = _latent_qkv(
            dtype=torch.float32 if case.startswith("f32") else torch.bfloat16)
    elif case.startswith("bf16_rows_wider"):
        pad = 8 if case.endswith("16_bytes") else 4
        q, k, v = (torch.zeros(2, 24, n * 128 + pad, dtype=torch.bfloat16)
                   [..., :n * 128].view(2, 24, n, 128) for n in (4, 2, 2))
    else:
        dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
        q, k, v = _qkv(2, 24, 4, 2, 64 if case.endswith("64") else 128,
                       dtype=dtype)
    if refused is not None:
        # float32, head dim 64 and rows TMA cannot address are refused
        # before any entry is called
        with pytest.raises(refused):
            fa._cuda_causal(q, k, v, 0.125)
        assert fa.causal_launch_count() == 0
        assert not any(calls.values())
        return
    out = fa._cuda_causal(q, k, v, 0.125)
    assert out.shape == (*q.shape[:3], v.shape[3]) and out.is_contiguous()
    assert fa.causal_launch_count() == 1
    (args,) = calls["tpusim_causal_attention_wgmma_fwd"]
    assert sum(len(c) for c in calls.values()) == 1
    # pointers, then batch, seq, heads, kv heads, the two head dims and the
    # strides the kernel reads (rows of q, k, v and v's heads)
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[4:14] == (q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                          q.shape[3], v.shape[3], *fa._causal_strides(q, k, v))
    assert args[-2:] == (0.125, 0)


def test_the_design_counts_add_up_and_reset(stub_kernels):
    q, k, v = _qkv(1, 16, 4, 2, 128, dtype=torch.bfloat16)
    for _ in range(3):
        fa._cuda_causal(q, k, v, 0.1)
    for _ in range(2):
        fa._cuda_causal(*_latent_qkv(), 0.1)
    with pytest.raises(TypeError):
        fa._cuda_causal(q.float(), k.float(), v.float(), 0.1)
    assert fa.causal_launch_count() == 5
    fa.reset_causal_launch_count()
    assert fa.causal_launch_count() == 0


@pytest.mark.parametrize("case", ["head_dim", "dtype", "refused_by_the_entry",
                                  "float32"])
def test_what_neither_design_takes_raises(stub_kernels, case):
    calls, state = stub_kernels
    q, k, v = _qkv(1, 16, 4, 2, 128, dtype=torch.bfloat16)
    if case == "head_dim":
        q, k, v = _qkv(1, 16, 4, 2, 160, dtype=torch.bfloat16)
        err, launch = ValueError, lambda: fa.causal_attention_fwd(q, k, v)
    elif case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
        err, launch = TypeError, lambda: fa.causal_attention_fwd(q, k, v)
    elif case == "refused_by_the_entry":
        state["err"] = 1
        err, launch = RuntimeError, lambda: fa._cuda_causal(q, k, v, 0.1)
    else:
        # the plain version takes float32; the kernel does not
        q, k, v = (x.float() for x in (q, k, v))
        err, launch = TypeError, lambda: fa._cuda_causal(q, k, v, 0.1)
    with pytest.raises(err):
        launch()
    assert fa.causal_launch_count() == 0
    if case != "refused_by_the_entry":
        assert not any(calls.values())
