"""The plain reference against the program's decoder at tiny widths in
float32 on the CPU, with grouped-query and full multi-head attention."""

import pytest
import torch

from benchmark import compare, spec, traffic
from benchmark.tests.conftest import ROOT, TINY

fam = spec.family("llama_decoder")


def _cfg(name, dtype="float32"):
    cfg = dict(spec.load_json(ROOT / f"benchmark/configs/{name}.json"),
               **TINY[name])
    cfg["torch_dtype"] = dtype
    return cfg


@pytest.mark.parametrize("name", ["mistral7b", "deepseek7b"])
@pytest.mark.parametrize("seed", [0, 2 ** 33 + 7])
def test_reference_matches_the_program_in_float32(name, seed):
    cfg = _cfg(name)
    params = fam.make_params(cfg, seed, "cpu")
    tokens = traffic.make_tokens({"pool": 1, "batch": 2, "seq": 40},
                                 cfg["vocab_size"], seed, "cpu")[0]
    got = fam.step(fam.build(cfg, "cpu"), params, tokens)
    ref = fam.reference(params, tokens, cfg)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert compare.row_error(got, ref) < 1e-5


def test_gqa_repeats_consecutive_query_heads():
    cfg = _cfg("mistral7b")
    d = fam.dims(cfg)
    assert d.heads // d.kv_heads == 4


def test_same_seed_same_inputs_other_seed_other_inputs():
    cfg = _cfg("mistral7b", "bfloat16")
    a = fam.make_params(cfg, 5, "cpu")
    b = fam.make_params(cfg, 5, "cpu")
    c = fam.make_params(cfg, 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.bfloat16
    assert float(a[0].float().std()) == pytest.approx(0.02, rel=0.05)
    for norm in (a[1], a[2], a[3]):       # final, attention and MLP norms
        assert torch.equal(norm, torch.ones_like(norm))
    mix = {"pool": 3, "batch": 2, "seq": 16}
    t1 = traffic.make_tokens(mix, 512, 2 ** 31 + 11, "cpu")
    t2 = traffic.make_tokens(mix, 512, 2 ** 31 + 11, "cpu")
    assert torch.equal(t1, t2) and t1.dtype == torch.int32
    assert int(t1.max()) < 512 and not torch.equal(t1[0], t1[1])


def test_the_reference_imports_nothing_of_the_program():
    src = (ROOT / "benchmark/reference/llama_plain.py").read_text()
    assert "tpusim" not in src and "jax" not in src


def test_families_refuse_what_the_decoder_does_not_compute():
    cfg = _cfg("mistral7b")
    with pytest.raises(ValueError):
        fam.dims(dict(cfg, tie_word_embeddings=False))
    with pytest.raises(ValueError):
        fam.dims(dict(cfg, hidden_act="gelu"))
    with pytest.raises(ValueError):
        fam.check_traffic(cfg, {"batch": 1, "seq": 4097,
                                "tokens": "uniform"})
    with pytest.raises(ValueError):
        fam.check_traffic(cfg, {"batch": 1, "seq": 64, "tokens": "zipf"})
    fam.check_traffic(cfg, {"batch": 1, "seq": 4096, "tokens": "uniform"})
