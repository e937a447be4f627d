"""DeepSeek-V2 in the port (``tpusim_torch/models/deepseek_v2.py``) against
the benchmark's plain reference (``benchmark/reference/deepseek_v2_plain.py``)
on the CPU, at a tiny size that keeps every mechanism: one dense layer and
two expert layers, 8 routed experts top-2 and a shared one, the latent's
RMSNorm, and the published ``rope_scaling`` (YaRN) on the published 64
rotary dims.

* YaRN's tables and the softmax scale against the published constants
  (correction range 10 to 23, scale 0.114721 for DeepSeek-V2-Lite);
* the program's rotation (the published de-interleave, then halves)
  against the reference's (adjacent pairs in place) on ``q . k``;
* the program in float32 against the reference, tight (1e-5; both float32,
  apart only in summation order), with the same experts chosen for every
  token of every expert layer; in bfloat16 within :data:`TINY_LIMIT`,
  where the reference with bfloat16 storage reads what the program reads;
* the fp8 control and the five mechanism faults of
  :mod:`benchmark.mechanism_faults` read over :data:`TINY_LIMIT`, and the
  median row's gap over :data:`TINY_MEDIAN_LIMIT`;
* the family's operation counts (model operations less the weight
  products' are the attention's), its parameter list (the program's, the
  published count), what it refuses, and the tiny cell through the
  harness;
* with the device check and the kernel's domain forced open, a no-grad
  forward takes the causal kernel's path once a layer at its two head
  dims (here its plain version) and matches the score chain;
* the module imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import compare, faults, harness, spec, traffic  # noqa: E402
from benchmark import mechanism_faults  # noqa: E402
from benchmark.reference import deepseek_v2_plain as plain  # noqa: E402
from tpusim_torch.kernels import flash_attention as fa  # noqa: E402
from tpusim_torch.models import deepseek_v2 as ds  # noqa: E402
from tpusim_torch.models import get_workload, list_workloads  # noqa: E402
from tpusim_torch.models import blocks  # noqa: E402

fam = spec.family("deepseek_v2")
CELL = "dsv2lite.prefill_16k"
LITE = spec.load_json(REPO / "benchmark/configs/dsv2lite.json")
#: the test size: every key of the configuration file as published but
#: these (the rotary dims and rope_scaling stay published)
TINY = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=32, v_head_dim=32, intermediate_size=96,
            moe_intermediate_size=24, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1)
TINY_MIX = {"pool": 1, "batch": 2, "seq": 96}


def _cfg(dtype="bfloat16", **kw):
    return dict(LITE, **TINY, torch_dtype=dtype, **kw)


def _fan_in(key: str, shape) -> int:
    if len(shape) == 1 or key == "embed":
        return 1
    return shape[-1] if key == "lm_head" else shape[-2]


#: each weight's fan-in at the cell's widths
CELL_FAN_IN = {k: _fan_in(k, s) for k, s in fam.param_shapes(fam.dims(LITE))}


def _inputs(cfg, seed):
    """The family's parameters with each weight scaled by ``sqrt(fan-in at
    the cell / fan-in here)``: N(0, 0.02) at the cell's widths gives
    outputs of the magnitudes they have there (the queries and keys, so the
    attention is as sharp; the layer-0 residual against what is added to
    it), so that each mechanism weighs in the logits as it does in the
    cell; and the mix's tokens."""
    shapes = fam.param_shapes(fam.dims(cfg))
    params = [p if p.dim() == 1 else
              (p.float() * math.sqrt(CELL_FAN_IN[k] / _fan_in(k, p.shape))
               ).to(p.dtype)
              for (k, _), p in zip(shapes, fam.make_params(cfg, seed, "cpu"))]
    tokens = traffic.make_tokens(TINY_MIX, cfg["vocab_size"], seed, "cpu")[0]
    return params, tokens


# ---------------------------------------------------------------------------
# YaRN and the rotation
# ---------------------------------------------------------------------------


def test_yarn_tables_and_scale_are_the_published_constants():
    cfg = ds.PRESETS["lite"]
    assert ds.yarn_correction_range(cfg) == (10, 23)
    assert ds.softmax_scale(cfg) == pytest.approx(0.114721, abs=5e-7)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.26080, abs=5e-6)
    assert ds.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m)
    inv = ds.yarn_inv_freq(cfg)
    extra = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    assert inv.shape == (32,)
    torch.testing.assert_close(inv[:11], extra[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(inv[23:], extra[23:] / 40, rtol=1e-6, atol=0)
    ramp = (torch.arange(32.0) - 10) / 13
    mid = slice(11, 23)
    torch.testing.assert_close(
        inv[mid], extra[mid] / 40 * ramp[mid] + extra[mid] * (1 - ramp[mid]))
    # the reference's own derivation agrees
    torch.testing.assert_close(plain.inv_freq(fam.dims(LITE)), inv,
                               rtol=1e-6, atol=0)
    cos, sin = ds.yarn_tables(16384, cfg, "cpu")
    assert cos.shape == sin.shape == (1, 16384, 1, 32)


def test_pair_rotation_equals_the_published_form_on_qk():
    cfg = ds.PRESETS["lite"]
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(1, 300, 4, 64, generator=gen)
    k = torch.randn(1, 300, 1, 64, generator=gen)
    cos, sin = ds.yarn_tables(300, cfg, "cpu")
    pos, freqs = torch.arange(300), plain.inv_freq(fam.dims(LITE))
    pq, pk = ds._rope(q, cos, sin), ds._rope(k, cos, sin)
    rq, rk = plain._rope_pairs(q, pos, freqs), plain._rope_pairs(k, pos, freqs)
    # the published form leaves the dims de-interleaved: even pairs' first
    # coordinates, then their second
    perm = torch.cat([torch.arange(0, 64, 2), torch.arange(1, 64, 2)])
    torch.testing.assert_close(pq, rq[..., perm], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(torch.einsum("bqhd,bkhd->bhqk", pq, pk),
                               torch.einsum("bqhd,bkhd->bhqk", rq, rk),
                               rtol=1e-4, atol=1e-4)
    # the halves rotation on the un-permuted layout is another function
    wrong = blocks.rotate(q, cos, sin)
    assert not torch.allclose(torch.einsum("bqhd,bkhd->bhqk", wrong, pk),
                              torch.einsum("bqhd,bkhd->bhqk", pq, pk),
                              atol=1e-2)


# ---------------------------------------------------------------------------
# the program against the reference
# ---------------------------------------------------------------------------


def _recorded(module, name):
    """Patch ``module.<name>`` (a router) to record the experts it
    chooses; returns the patch and the record."""
    seen, inner = [], getattr(module, name)

    def record(*args, **kw):
        weight, experts = inner(*args, **kw)
        seen.append(experts.reshape(-1, experts.shape[-1]).sort(-1).values)
        return weight, experts

    return record, seen


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 7])
def test_program_matches_the_reference_in_float32_with_the_same_routing(
        seed, monkeypatch):
    cfg = _cfg("float32")
    params, tokens = _inputs(cfg, seed)
    program, chosen = _recorded(ds, "route")
    reference, want = _recorded(plain, "route")
    monkeypatch.setattr(ds, "route", program)
    monkeypatch.setattr(plain, "route", reference)
    got = fam.step(fam.build(cfg, "cpu"), params, tokens)
    ref = fam.reference(params, tokens, cfg)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert compare.row_error(got, ref) < 1e-5
    assert len(chosen) == len(want) == 2
    for a, b in zip(chosen, want):
        assert torch.equal(a, b)


#: the limit of ``logit_row_err`` at the test size (:data:`TINY`, seq 96,
#: batch 2, the weights of :func:`_inputs`), set from its readings on the
#: CPU over seeds 1-6: the bf16 program 0.070-0.150, the fp8 control
#: 0.498-0.562, the mechanism faults 0.215-0.342 (top-1 of top-2), 0.942 and
#: up (no shared experts), 0.849 and up (the scale without m^2), 0.450 and
#: up (plain RoPE), 0.518 and up (no latent norm).  The cell's own limit is
#: set from readings at its size on the card.
TINY_LIMIT = 0.2


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bf16_program_passes_and_the_fp8_control_fails(seed):
    cfg = _cfg()
    params, tokens = _inputs(cfg, seed)
    ref = fam.reference(params, tokens, cfg)
    got = fam.step(fam.build(cfg, "cpu"), params, tokens)
    ctl = fam.reference(params, tokens, cfg, matmul_dtype=torch.float8_e4m3fn)
    wit = fam.reference(params, tokens, cfg, store_dtype=torch.bfloat16)
    program = compare.row_error(got, ref)
    assert compare.row_error(ctl, ref) > TINY_LIMIT > program
    # bfloat16 storage alone reads what the program reads
    assert 0.5 < compare.row_error(wit, ref) / program < 2


@pytest.mark.parametrize("fault", sorted(mechanism_faults.ALL))
def test_each_mechanism_fault_reads_over_the_limit(fault):
    cfg = _cfg()
    params, tokens = _inputs(cfg, 1)
    ref = fam.reference(params, tokens, cfg)
    program = compare.row_error(
        fam.step(fam.build(cfg, "cpu"), params, tokens), ref)
    with mechanism_faults.ALL[fault](cfg):
        got = fam.step(fam.build(cfg, "cpu"), params, tokens)
    assert compare.row_error(got, ref) > TINY_LIMIT > program
    # the patch is gone after the block
    again = fam.step(fam.build(cfg, "cpu"), params, tokens)
    assert compare.row_error(again, ref) == program


#: the limit of ``logit_row_err_median`` at the test size (as
#: :data:`TINY_LIMIT`), set from its readings on the CPU over seeds 1-6: the
#: bf16 program 0.0125-0.0143, the fp8 control 0.191-0.207, the mechanism
#: faults 0.079-0.092 (top-1 of top-2), 0.539 and up (no shared experts),
#: 0.422 and up (the scale without m^2), 0.092 and up (plain RoPE), 0.185
#: and up (no latent norm)
TINY_MEDIAN_LIMIT = 0.035


@pytest.mark.parametrize("fault", ["control"] + sorted(mechanism_faults.ALL))
@pytest.mark.parametrize("seed", [1, 4])
def test_the_median_row_separates_the_program_from_each_fault(fault, seed):
    """The family's second reading: the median row's gap, which a fault in
    every token's mathematics moves (top-1 of top-2 included) and the
    program's worst rows do not."""
    cfg = _cfg()
    params, tokens = _inputs(cfg, seed)
    ref = fam.reference(params, tokens, cfg)
    got = fam.step(fam.build(cfg, "cpu"), params, tokens)
    program = fam.readings(got, ref)
    assert program["logit_row_err"] == compare.row_error(got, ref)
    if fault == "control":
        bad = fam.reference(params, tokens, cfg,
                            matmul_dtype=torch.float8_e4m3fn)
    else:
        with mechanism_faults.ALL[fault](cfg):
            bad = fam.step(fam.build(cfg, "cpu"), params, tokens)
    median = fam.readings(bad, ref)["logit_row_err_median"]
    assert median > TINY_MEDIAN_LIMIT > program["logit_row_err_median"]


def test_the_readings_read_nan_and_the_median_row():
    ref = torch.ones(2, 5, 4)
    out = ref.clone()
    out[0, 1] *= 1.5            # one row off by 0.5
    out[1] *= 1.1               # five rows off by 0.1, four exact
    r = fam.readings(out, ref)
    assert r["logit_row_err"] == pytest.approx(0.5)
    assert r["logit_row_err_median"] == pytest.approx(0.1)
    out[1, 4, 2] = float("nan")
    r = fam.readings(out, ref)
    assert math.isnan(r["logit_row_err"])
    assert math.isnan(r["logit_row_err_median"])


def test_the_expert_layer_drops_no_token_and_keeps_its_balance():
    module, args = get_workload("deepseek_v2_tiny").build(device="cpu")
    sorts, calls = [], []
    inner_sort, inner = ds.sort_by_expert, ds._experts

    def sorted_(flat, experts):
        got = inner_sort(flat, experts)
        sorts.append(got[0].tolist())
        return got

    def counted(rows, counts, gate_up, down):
        calls.append((rows.shape[0], list(counts)))
        return inner(rows, counts, gate_up, down)

    with torch.no_grad(), pytest.MonkeyPatch.context() as m:
        m.setattr(ds, "sort_by_expert", sorted_)
        m.setattr(ds, "_experts", counted)
        module(*args)
    cfg = module.cfg
    rows = args[-1].numel() * cfg.top_k
    assert len(sorts) == len(calls) == cfg.layers - 1
    for counts, (n, sizes) in zip(sorts, calls):
        assert len(counts) == cfg.experts and sum(counts) == rows
        assert sizes == [ds.padded(c) for c in counts] and n == sum(sizes)
    balance = module.busiest_over_mean
    assert len(balance) == cfg.layers - 1 and all(b >= 1 for b in balance)


def test_each_expert_takes_its_choices_in_rows_of_its_own():
    gen = torch.Generator().manual_seed(3)
    experts, a = 5, ds.EXPERT_ROWS
    flat = torch.randint(0, experts, (3 * a + 7,), generator=gen)
    flat[flat == 2] = 3                       # an expert no choice takes
    counts, source, place = ds.sort_by_expert(flat, experts)
    assert counts.tolist() == torch.bincount(flat, minlength=experts).tolist()
    sizes = [ds.padded(c) for c in counts.tolist()]
    assert all(s % a == 0 and c <= s < c + a
               for s, c in zip(sizes, counts.tolist()))
    assert source.shape[0] >= sum(sizes)
    # every choice in a row of its own, gathered back from that row
    assert torch.unique(place).numel() == flat.numel()
    assert torch.equal(source[place], torch.arange(flat.numel()))
    # inside its expert's segment, in the order the choices came
    starts = torch.tensor([0] + sizes).cumsum(0)
    for e in range(experts):
        mine = place[flat == e]
        assert torch.all((mine >= starts[e]) & (mine < starts[e + 1]))
        assert torch.equal(mine, starts[e] + torch.arange(mine.numel()))


# ---------------------------------------------------------------------------
# the kernel path
# ---------------------------------------------------------------------------


def test_forced_kernel_path_launches_once_a_layer_and_matches_the_chain(
        monkeypatch):
    module, args = get_workload("deepseek_v2_tiny").build(
        device="cpu", dtype="float32")
    calls = []
    plain_fwd = fa.causal_attention_fwd

    def counted(q, k, v, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      v.is_contiguous(), scale))
        return plain_fwd(q, k, v, scale)

    with torch.no_grad():
        want = module(*args)
        # the device check and the kernel's domain forced open: the tiny
        # float32 decoder's head dims (32 / 16) take the kernel path
        monkeypatch.setattr(blocks, "_on_card", lambda x: True)
        monkeypatch.setattr(fa, "causal_kernel_takes", lambda q, k, v: True)
        monkeypatch.setattr(fa, "causal_attention_fwd", counted)
        got = module(*args)
    cfg = module.cfg
    b, s = args[-1].shape
    q = (b, s, cfg.heads, cfg.qk_head_dim)
    assert calls == [(q, q, (b, s, cfg.heads, cfg.v_head_dim), False,
                      ds.softmax_scale(cfg))] * cfg.layers
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_the_wrapper_takes_two_head_dims_and_reads_v_in_place():
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(1, 40, 4, 192, generator=gen)
    k = torch.randn(1, 40, 4, 192, generator=gen)
    kv = torch.randn(1, 40, 4, 256, generator=gen)
    v = kv[..., 128:]
    scale = 0.1147
    out = fa.causal_attention_fwd(q, k, v, scale)
    assert out.shape == (1, 40, 4, 128) and out.is_contiguous()
    torch.testing.assert_close(out, blocks.score_chain(q, k, v, scale)[-1],
                               atol=1e-5, rtol=1e-5)
    # v's rows 1024 elements apart, its heads 256
    assert fa._rows_and_heads(v) == (1024, 256)
    assert fa._rows_and_heads(kv[..., :100]) == (1024, 256)
    assert fa._rows_and_heads(v.transpose(1, 2)) is None
    # q.k at 160 and v at 100 are taken; q.k past 192, v's heads other
    # than k's, or one head dim past 128 are refused
    fa.check_causal_inputs(q[..., :160], k[..., :160], v[..., :100])
    for bad in ((torch.randn(1, 40, 4, 224), torch.randn(1, 40, 4, 224), v),
                (q, k, kv[:, :, :2, 128:]),
                (q[..., :160], k[..., :160], torch.randn(1, 40, 4, 160))):
        with pytest.raises(ValueError):
            fa.causal_attention_fwd(*bad)


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["cell", "tiny"])
def test_model_flops_less_the_gemms_are_the_attention(size):
    cfg = LITE if size == "cell" else _cfg()
    mix = (spec.find_cell(CELL).traffic if size == "cell" else TINY_MIX)
    from benchmark import roofline

    gemm = sum(roofline.gemm_ops(m, n, k) * c
               for m, n, k, c in fam.gemms(cfg, mix))
    attn = fam.attention_flops(cfg, mix["batch"], mix["seq"])
    assert fam.model_flops(cfg, mix) - gemm == pytest.approx(attn, rel=1e-12)
    d = fam.dims(cfg)
    b, s = mix["batch"], mix["seq"]
    assert attn == d.layers * b * d.heads * s * (s + 1) * (
        d.qk_head_dim + d.v_head_dim)
    if size == "cell":
        # 80.3 TFLOP of weight products (44.2 of them routed experts') and
        # 37.1 of causal attention a 16k step
        assert gemm / 1e12 == pytest.approx(80.3, abs=0.05)
        experts = sum(roofline.gemm_ops(m, n, k) * c
                      for m, n, k, c in fam.gemms(cfg, mix) if m == 1536)
        assert experts / 1e12 == pytest.approx(44.2, abs=0.05)
        assert attn / 1e12 == pytest.approx(37.1, abs=0.05)
        assert fam.attention_bytes(cfg, b, s) / fam.attention_flops(
            cfg, b, s) < 1 / 4000


def test_the_family_lists_the_programs_parameters():
    d = fam.dims(LITE)
    shapes = fam.param_shapes(d)
    assert shapes == ds.param_shapes(fam.program_config(LITE))
    n = sum(math.prod(s) for _, s in shapes)
    assert n == LITE["held"]["parameters"] == 15_706_484_224
    assert n * 2 / 2 ** 30 == pytest.approx(LITE["held"]["bfloat16_gib"],
                                            abs=0.005)
    assert LITE["reduced"] == [] and d.layers == 27 and d.experts == 64
    assert d.vocab == 102400 and not LITE["tie_word_embeddings"]


@pytest.mark.parametrize("key,value", [
    ("norm_topk_prob", True), ("q_lora_rank", 1536), ("topk_method",
                                                       "group_limited_greedy"),
    ("scoring_func", "sigmoid"), ("tie_word_embeddings", True),
    ("rope_scaling", None), ("num_key_value_heads", 8)])
def test_the_family_refuses_what_the_program_does_not_compute(key, value):
    with pytest.raises(ValueError):
        fam.dims(dict(LITE, **{key: value}))


def test_the_config_refuses_unequal_mscales():
    """YaRN's cos/sin factor ``mscale / mscale_all_dim`` is taken as 1."""
    ds.DeepseekV2Config(mscale=0.5, mscale_all_dim=0.5)
    with pytest.raises(ValueError):
        ds.DeepseekV2Config(mscale=1.0, mscale_all_dim=0.707)


def test_the_family_refuses_a_sequence_past_the_context():
    with pytest.raises(ValueError):
        fam.check_traffic(LITE, {"batch": 1, "seq": 163841,
                                 "tokens": "uniform"})
    fam.check_traffic(LITE, spec.find_cell(CELL).traffic)


#: the limit of ``logit_row_err`` for the tiny cell run by the harness,
#: whose weights are the family's own N(0, 0.02) at the test size (seq 48,
#: batch 2), set from its readings on the CPU over seeds 1-6: the bf16
#: program 0.0081-0.0153, the fp8 control 0.094-0.129, an altered token
#: 0.99-1.16
HARNESS_TINY_LIMIT = 0.04
#: and of ``logit_row_err_median`` there, over seeds 1-6: the bf16 program
#: 0.0050-0.0058, the fp8 control 0.0715-0.0844; an altered token, one row
#: of a step, moves it by a tenth (0.0055-0.0064), which is why the worst
#: row is judged too
HARNESS_TINY_MEDIAN_LIMIT = 0.02


def _tiny_cell():
    real = spec.find_cell(CELL)
    return spec.Cell(name="tiny.dsv2lite", chips=1, config=_cfg(),
                     traffic=dict(real.traffic, batch=2, seq=48, warmup=2),
                     limits=copy.deepcopy(real.limits),
                     end_to_end=real.end_to_end, per_layer=real.per_layer)


@pytest.mark.parametrize("wrap", ["program", "control", "altered_token"])
def test_the_tiny_cell_through_the_harness(wrap):
    cell = _tiny_cell()
    cell.limits["logit_row_err"]["limit"] = HARNESS_TINY_LIMIT
    cell.limits["logit_row_err_median"]["limit"] = HARNESS_TINY_MEDIAN_LIMIT
    how = {"program": None,
           "control": faults.control(fam, cell.config),
           "altered_token": faults.all_faults(2, 512)["altered_token"]}[wrap]
    r = harness.run_cell(cell, 2 ** 31 + 91, 0.2, False, "cpu",
                         time.perf_counter(), wrap=how)
    assert r["correct"] is (wrap == "program")
    assert set(r["checks"]) == {"logit_row_err", "logit_row_err_median"}
    # the control fails both; a token altered, only the worst row
    median = r["checks"]["logit_row_err_median"]
    assert (median["value"] > median["limit"]) is (wrap == "control")


def test_the_cell_and_its_new_readers_are_found_by_name():
    cell = spec.find_cell(CELL)
    assert cell.chips == 1 and cell.traffic["seq"] == 16384
    names = {m["name"] for m in cell.per_layer}
    assert {"router_ms_per_step", "experts_ms_per_step",
            "mla_attention_roofline"} <= names
    # the new readers are scoped to this cell
    for other in ("mistral7b.prefill_2k", "deepseek7b.prefill_2k",
                  "mistral7b.prefill_4k", "mistral7b.prefill_256"):
        assert not {"router_ms_per_step", "experts_ms_per_step",
                    "mla_attention_roofline"} & {
            m["name"] for m in spec.find_cell(other).per_layer}


# ---------------------------------------------------------------------------
# the registry and the imports
# ---------------------------------------------------------------------------


def test_registered_at_published_widths():
    w = get_workload("deepseek_v2_lite")
    assert w.params == {"preset": "lite", "batch": 1, "seq": 16384,
                        "train": False}
    module, args = w.build(device="meta")
    assert sum(a.numel() for a in args[:-1]) == 15_706_484_224
    assert tuple(args[-1].shape) == (1, 16384)
    assert {x.name for x in list_workloads()
            if x.builder.__module__ == ds.__name__} == {
        "deepseek_v2_lite", "deepseek_v2_tiny"}
    with pytest.raises(ValueError):
        w.build(device="meta", train=True)


def test_imports_nothing_of_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import tpusim_torch.models.deepseek_v2\n"
        "from benchmark.reference import deepseek_v2_plain\n"
        "from benchmark import spec\n"
        "spec.family('deepseek_v2'); spec.metric_reader("
        "'mla_attention_roofline')\n"
        "import benchmark.mechanism_faults\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpusim')))\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    src = (REPO / "benchmark/reference/deepseek_v2_plain.py").read_text()
    assert "tpusim" not in src and "jax" not in src
