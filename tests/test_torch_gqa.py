"""Grouped-query attention (``kv_heads < heads``) in the port's Llama
against the JAX package, on the CPU at the tiny preset's widths.

The reference's ``_attention`` repeats each key/value head over the head
axis (``jnp.repeat(k, heads // kv_heads, axis=2)``); the port's decoder
does the same with ``torch.repeat_interleave``.  From the same seeded
numpy weights and tokens:

* the forward's logits equal ``llama_forward``'s, float32 within rtol =
  atol = 1e-4 (the model suite's tolerance);
* the train step's loss equals ``jax.value_and_grad``'s within rtol 1e-4
  and each gradient is within 1e-4 of its norm;
* the step sharded over a ``(1, 2)`` mesh (each rank one key/value head)
  and the AOT step's hand-written backward (stacked layers, a reversed
  scan) equal the unsharded autograd step within 1e-5 of each norm;
* the captured forward prices the JAX CPU capture's MXU flops at v5e and
  v5p (rel 1e-9);
* a ``heads`` that ``kv_heads`` does not divide, and a tp axis that does
  not divide ``kv_heads``, raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpusim.models import llama as ref_llama  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.tracer.capture import capture_to_dir as ref_capture  # noqa: E402
from tpusim_torch.models import llama as port_llama  # noqa: E402
from tpusim_torch.models import llama_aot  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.spmd import Mesh  # noqa: E402
from tpusim_torch.tracer.capture import capture_to_dir as port_capture  # noqa: E402

#: the tiny preset's widths with two and one key/value heads
KV_HEADS = (2, 1)
BATCH, SEQ = 2, 16
TOL = 1e-4


def _cfgs(kv_heads: int):
    over = dict(vocab=512, dim=128, layers=2, heads=4, kv_heads=kv_heads,
                ffn=352, dtype="float32")
    return (ref_llama.LlamaConfig(max_seq=256, **over),
            dataclasses.replace(port_llama.PRESETS["tiny"], **over))


def _tree(ref_cfg, seed: int = 0) -> dict:
    """Seeded N(0, 0.02) weights and unit norms in the reference's pytree
    layout, float32 numpy."""
    rng = np.random.default_rng(seed)
    d, kv = ref_cfg.dim, ref_cfg.kv_heads * ref_cfg.head_dim
    layer = {"attn_norm": (d,), "wq": (d, d), "wk": (d, kv), "wv": (d, kv),
             "wo": (d, d), "mlp_norm": (d,), "w_gate": (d, ref_cfg.ffn),
             "w_up": (d, ref_cfg.ffn), "w_down": (ref_cfg.ffn, d)}

    def leaf(shape):
        if len(shape) == 1:
            return np.ones(shape, np.float32)
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    return {
        "embed": leaf((ref_cfg.vocab, d)),
        "final_norm": leaf((d,)),
        "layers": [{k: leaf(s) for k, s in layer.items()}
                   for _ in range(ref_cfg.layers)],
    }


def _tokens(vocab: int, seed: int = 1):
    tokens = np.random.default_rng(seed).integers(
        0, vocab, (BATCH, SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _port(tree, tokens, targets=None):
    flat = port_llama.params_from_numpy(tree, device="cpu")
    args = [torch.from_numpy(tokens)]
    if targets is not None:
        args.append(torch.from_numpy(targets))
    return flat, tuple(args)


def _norm_err(got: torch.Tensor, want) -> float:
    w = torch.from_numpy(np.asarray(want, dtype=np.float64))
    return float((got.double() - w).norm() / w.norm())


@pytest.mark.parametrize("kv_heads", KV_HEADS)
def test_forward_matches_jax(kv_heads):
    ref_cfg, cfg = _cfgs(kv_heads)
    tree = _tree(ref_cfg)
    tokens, _ = _tokens(cfg.vocab)
    want = np.asarray(ref_llama.llama_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
        ref_cfg))
    flat, args = _port(tree, tokens)
    with torch.no_grad():
        got = port_llama.LlamaForward(cfg)(*flat, *args)
    assert tuple(got.shape) == want.shape == (BATCH, SEQ, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _jax_grads(ref_cfg, tree, tokens, targets):
    def loss_fn(params):
        logits = ref_llama.llama_forward(
            params, jnp.asarray(tokens), ref_cfg).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                                   axis=-1)
        return nll.mean()

    loss, grads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    flat = [grads["embed"], grads["final_norm"]]
    for layer in grads["layers"]:
        flat += [layer[k] for k in port_llama.LAYER_KEYS]
    return float(loss), [np.asarray(g) for g in flat]


@pytest.mark.parametrize("kv_heads", KV_HEADS)
def test_train_gradients_match_jax(kv_heads):
    ref_cfg, cfg = _cfgs(kv_heads)
    tree = _tree(ref_cfg)
    tokens, targets = _tokens(cfg.vocab)
    want_loss, want = _jax_grads(ref_cfg, tree, tokens, targets)
    flat, args = _port(tree, tokens, targets)
    loss, *grads = port_llama.LlamaTrainStep(cfg, None, BATCH).grads(
        *flat, *args)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=TOL)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert tuple(g.shape) == w.shape and np.linalg.norm(w) > 0, i
        assert _norm_err(g, w) <= TOL, (i, _norm_err(g, w))


@pytest.mark.parametrize("kv_heads", KV_HEADS)
def test_sharded_and_aot_steps_equal_the_unsharded_step(kv_heads):
    ref_cfg, cfg = _cfgs(kv_heads)
    tree = _tree(ref_cfg)
    tokens, targets = _tokens(cfg.vocab)
    flat, args = _port(tree, tokens, targets)
    want = port_llama.LlamaTrainStep(cfg, None, BATCH).grads(*flat, *args)
    if kv_heads % 2 == 0:
        sharded = port_llama.LlamaTrainStep(cfg, Mesh((1, 2), ("dp", "tp")),
                                            BATCH)
        got = sharded.grads(*flat, *args)
        np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-6)
        for i, (g, w) in enumerate(zip(got[1:], want[1:])):
            assert _norm_err(g, w.numpy()) <= 1e-5, i
    # the AOT step: stacked layers, forward and hand-written backward in
    # scans
    keys = port_llama.LAYER_KEYS
    embed, final_norm, per_layer = flat[0], flat[1], flat[2:]
    stacked = [torch.stack([per_layer[i * len(keys) + j]
                            for i in range(cfg.layers)])
               for j in range(len(keys))]
    aot = llama_aot.LlamaAotTrainStep(cfg, None, BATCH)
    got = aot.grads(embed, final_norm, *stacked, *args)
    got_flat = list(got[:3]) + [got[3 + j][i] for i in range(cfg.layers)
                                for j in range(len(keys))]
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-6)
    assert len(got_flat) == len(want)
    for i, (g, w) in enumerate(zip(got_flat[1:], want[1:])):
        assert _norm_err(g, w.numpy()) <= 1e-5, i


def _mxu(path, simulate, arch: str) -> float:
    stats = json.loads(simulate(path, arch=arch, tuned=False).stats.to_json())
    return stats["tot_mxu_flops"]


@pytest.mark.parametrize("kv_heads", KV_HEADS)
def test_capture_prices_the_jax_captures_mxu_flops(kv_heads, tmp_path):
    ref_cfg, cfg = _cfgs(kv_heads)
    tree = _tree(ref_cfg)
    tokens, _ = _tokens(cfg.vocab)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_capture(ref_dir,
                lambda p, t: ref_llama.llama_forward(p, t, ref_cfg),
                jax.tree_util.tree_map(jnp.asarray, tree),
                jnp.asarray(tokens), name="llama_gqa")
    flat, args = _port(tree, tokens)
    port_capture(port_dir, port_llama.LlamaForward(cfg), *flat, *args,
                 name="llama_gqa")
    for arch in ("v5e", "v5p"):
        want = _mxu(ref_dir, ref_simulate, arch)
        got = _mxu(port_dir, port_simulate, arch)
        assert want > 0
        assert got == pytest.approx(want, rel=1e-9), arch


def test_refuses_what_the_reference_cannot_run():
    _, cfg = _cfgs(2)
    with pytest.raises(ValueError, match="not a multiple"):
        port_llama._Decoder(dataclasses.replace(cfg, kv_heads=3), None)
    with pytest.raises(ValueError, match="does not divide"):
        port_llama._Decoder(cfg, Mesh((1, 4), ("dp", "tp")))
    # a tp axis that divides kv_heads builds
    assert port_llama._Decoder(cfg, Mesh((1, 2), ("dp", "tp"))).rep == 2
