"""The families' operation counts against sums by hand."""

import pytest

from benchmark import roofline, spec
from benchmark.tests.conftest import ROOT

fam = spec.family("llama_decoder")


def _cfg(name):
    return spec.load_json(ROOT / f"benchmark/configs/{name}.json")


def _hand(d, ffn, layers, kv, vocab, b, s):
    t = b * s
    per_layer = 2 * t * (d * d + d * kv + d * kv + d * d + 3 * d * ffn)
    return (layers * per_layer + 2 * t * d * vocab,
            layers * 2 * b * d * s * (s + 1))


@pytest.mark.parametrize("name,sizes", [
    ("mistral7b", (4096, 14336, 32, 1024, 32000)),
    ("deepseek7b", (4096, 11008, 30, 4096, 102400)),
])
@pytest.mark.parametrize("b,s", [(2, 2048), (1, 4096), (16, 256)])
def test_flops_match_a_hand_sum(name, sizes, b, s):
    gemm, attn = _hand(*sizes, b, s)
    cfg, mix = _cfg(name), {"batch": b, "seq": s}
    assert fam.gemm_flops(cfg, b, s) == gemm
    assert fam.attention_flops(cfg, b, s) == attn
    assert fam.model_flops(cfg, mix) == gemm + attn
    assert sum(roofline.gemm_ops(m, n, k) * c
               for m, n, k, c in fam.gemms(cfg, mix)) == gemm


@pytest.mark.parametrize("name,b,s,tf", [
    ("mistral7b", 2, 2048, 60.45), ("deepseek7b", 2, 2048, 55.2),
    ("mistral7b", 1, 4096, 62.65), ("mistral7b", 16, 256, 58.5),
])
def test_flops_match_the_published_estimates(name, b, s, tf):
    # the estimates count attention over s^2, the harness over s(s+1)
    mix = {"batch": b, "seq": s}
    assert fam.model_flops(_cfg(name), mix) / 1e12 == pytest.approx(
        tf, rel=2e-3)
    assert fam.gemm_flops(_cfg("mistral7b"), b, s) / 1e12 == pytest.approx(
        58.25, rel=1e-4)


def test_held_parameters_and_bytes():
    for name in ("mistral7b", "deepseek7b"):
        cfg = _cfg(name)
        shapes = fam.param_shapes(fam.dims(cfg))
        n = sum(__import__("math").prod(s) for _, s in shapes)
        assert n == cfg["held"]["parameters"]
        assert n * 2 / 2 ** 30 == pytest.approx(cfg["held"]["bfloat16_gib"],
                                                abs=0.005)


def test_gemm_bound_is_the_larger_of_ops_and_bytes():
    # a product bound by bytes ([1, 4096] x [4096, 4096]) and one by ops
    small = roofline.gemm_bound_s([(1, 4096, 4096, 1)], 2, 989e12, 3.35e12)
    assert small[0] == pytest.approx(small[2]) and small[2] > small[1]
    big = roofline.gemm_bound_s([(4096, 4096, 4096, 2)], 2, 989e12, 3.35e12)
    assert big[0] == pytest.approx(big[1]) and big[1] > big[2]
    assert big[1] == pytest.approx(2 * 2 * 4096 ** 3 / 989e12)
