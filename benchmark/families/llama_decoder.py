"""The Llama-style decoder family: RMSNorm, RoPE, grouped-query attention,
SwiGLU, a tied output projection.

A family module is what a kind of cell needs beyond data: it builds the
program's module and its arguments, draws the step's inputs from the mix
and the seed, runs one step, names the plain reference, says which
readings of a step's output against the reference's are compared, and
counts the step's operations.  Here the module is the program's
``tpusim_torch.models.llama.LlamaForward`` over a ``LlamaConfig`` made
from a configuration file's published keys, called as
``measure_wall_time`` calls a module: ``module(*params, tokens)`` under
``torch.no_grad()``.  The parameters are the program's flat argument
list: ``embed``, ``final_norm``, then each layer's keys in sorted order
(:data:`LAYER_KEYS`), N(0, 0.02) weights and unit norms drawn on the
device from the seed.  Judged against
:mod:`benchmark.reference.llama_plain` by ``logit_row_err``.
"""

from __future__ import annotations

import torch

from benchmark import compare, roofline, seeds, traffic
from benchmark.reference import llama_plain

REFERENCE = "llama_plain"

#: a layer's parameters in the program's argument order (sorted keys)
LAYER_KEYS = ("attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk",
              "wo", "wq", "wv")

#: elements drawn by one ``torch.randn`` call
_CHUNK = 1 << 30

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def dims(config: dict) -> llama_plain.Dims:
    """The decoder's sizes from a configuration's published keys; refuses
    what this decoder does not compute."""
    if config.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {config['hidden_act']!r}: the "
                         f"decoder's MLP is SwiGLU")
    if not config.get("tie_word_embeddings", False):
        raise ValueError("the decoder ties its output projection to the "
                         "embedding: tie_word_embeddings must be true")
    if config.get("rope_scaling") is not None:
        raise ValueError("rope_scaling is not computed by the decoder")
    return llama_plain.Dims(
        vocab=config["vocab_size"], dim=config["hidden_size"],
        layers=config["num_hidden_layers"],
        heads=config["num_attention_heads"],
        kv_heads=config.get("num_key_value_heads",
                            config["num_attention_heads"]),
        ffn=config["intermediate_size"], eps=float(config["rms_norm_eps"]),
        rope_theta=float(config["rope_theta"]))


def dtype(config: dict) -> torch.dtype:
    return _DTYPES[config["torch_dtype"]]


def check_traffic(config: dict, mix: dict) -> None:
    """A token mix; full causal attention equals the published attention
    only where no sequence is longer than the sliding window (when there
    is one)."""
    traffic.check_tokens(mix)
    window, seq = config.get("sliding_window"), mix["seq"]
    if window is not None and seq > window:
        raise ValueError(f"seq {seq} exceeds sliding_window {window}: the "
                         f"decoder attends to the whole prefix")


def param_shapes(d: llama_plain.Dims) -> list[tuple[str, tuple[int, ...]]]:
    """``(key, shape)`` of each parameter in the program's argument
    order."""
    kv = d.kv_heads * d.head_dim
    layer = {
        "attn_norm": (d.dim,), "mlp_norm": (d.dim,),
        "wq": (d.dim, d.dim), "wk": (d.dim, kv), "wv": (d.dim, kv),
        "wo": (d.dim, d.dim), "w_gate": (d.dim, d.ffn),
        "w_up": (d.dim, d.ffn), "w_down": (d.ffn, d.dim),
    }
    out = [("embed", (d.vocab, d.dim)), ("final_norm", (d.dim,))]
    for _ in range(d.layers):
        out += [(k, layer[k]) for k in LAYER_KEYS]
    return out


def make_params(config: dict, seed: int, device) -> list[torch.Tensor]:
    """The parameters, drawn on ``device`` in the served dtype: every
    weight matrix a view of one buffer filled by a few ``randn`` calls
    (scaled by 0.02), every norm a view of one buffer of ones."""
    d, dt = dims(config), dtype(config)
    shapes = param_shapes(d)
    sizes = [torch.Size(s).numel() for _, s in shapes]
    mats = sum(n for (_, s), n in zip(shapes, sizes) if len(s) > 1)
    norms = sum(n for (_, s), n in zip(shapes, sizes) if len(s) == 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.stream(seed, "weights"))
    flat = torch.empty(mats, dtype=dt, device=device)
    for lo in range(0, mats, _CHUNK):
        part = flat[lo:lo + _CHUNK]
        torch.randn(part.shape, generator=gen, dtype=dt, device=device,
                    out=part)
        part.mul_(0.02)
    ones = torch.ones(norms, dtype=dt, device=device)
    out, at_m, at_n = [], 0, 0
    for (_, shape), n in zip(shapes, sizes):
        if len(shape) > 1:
            out.append(flat[at_m:at_m + n].view(shape))
            at_m += n
        else:
            out.append(ones[at_n:at_n + n].view(shape))
            at_n += n
    return out


def weights_tree(params) -> dict:
    """The flat parameters as the reference's tree."""
    n = len(LAYER_KEYS)
    layers = [dict(zip(LAYER_KEYS, params[i:i + n]))
              for i in range(2, len(params), n)]
    return {"embed": params[0], "final_norm": params[1], "layers": layers}


def build(config: dict, device):
    """The program's module for this configuration."""
    from tpusim_torch.models.llama import LlamaConfig, LlamaForward

    d = dims(config)
    cfg = LlamaConfig(vocab=d.vocab, dim=d.dim, layers=d.layers,
                      heads=d.heads, kv_heads=d.kv_heads, ffn=d.ffn,
                      max_seq=config.get("max_position_embeddings", 4096),
                      rope_theta=d.rope_theta, eps=d.eps,
                      dtype=config["torch_dtype"])
    return LlamaForward(cfg).to(device)


def make_inputs(config: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """The mix's token ids, ``[pool, batch, seq]``, uniform over the
    vocabulary."""
    return traffic.make_tokens(mix, dims(config).vocab, seed, device)


def step_input(inputs: torch.Tensor, i: int) -> torch.Tensor:
    """The token ids of step ``i``: the pool's batch ``i % pool``."""
    return inputs[i % inputs.shape[0]]


@torch.no_grad()
def step(module, params, tokens):
    """One timed step: a forward pass, as ``measure_wall_time`` runs it."""
    return module(*params, tokens)


def readings(out: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The numbers compared for one step (each an error: larger is
    worse)."""
    return {"logit_row_err": compare.row_error(out, ref)}


def reference(params, tokens, config: dict, matmul_dtype=None,
              store_dtype=None):
    """float32 logits of the plain reference (``matmul_dtype``: the
    control's rounding; ``store_dtype``: the bfloat16-storage witness)."""
    return llama_plain.forward(weights_tree(params), tokens, dims(config),
                               matmul_dtype=matmul_dtype,
                               store_dtype=store_dtype)


def gemms(config: dict, mix: dict) -> list[tuple[int, int, int, int]]:
    """The weight products of one step as ``(m, n, k, count)``: the q, k,
    v, o, gate, up and down projections of each layer over all tokens,
    then the tied output projection."""
    d = dims(config)
    t, kv = mix["batch"] * mix["seq"], d.kv_heads * d.head_dim
    per_layer = [(t, d.dim, d.dim), (t, kv, d.dim), (t, kv, d.dim),
                 (t, d.dim, d.dim), (t, d.ffn, d.dim), (t, d.ffn, d.dim),
                 (t, d.dim, d.ffn)]
    return ([(m, n, k, d.layers) for m, n, k in per_layer]
            + [(t, d.vocab, d.dim, 1)])


def gemm_flops(config: dict, batch: int, seq: int) -> float:
    """Operations of the weight products, two a multiply-add."""
    return sum(roofline.gemm_ops(m, n, k) * c for m, n, k, c in
               gemms(config, {"batch": batch, "seq": seq}))


def attention_flops(config: dict, batch: int, seq: int) -> float:
    """Causal attention's QK^T and PV over the lower triangle (the
    diagonal in it): ``2 * b * dim * s * (s + 1)`` a layer."""
    d = dims(config)
    return float(2 * batch * d.dim * seq * (seq + 1) * d.layers)


def model_flops(config: dict, mix: dict) -> float:
    """The step's model operations: the weight products and causal
    attention."""
    b, s = mix["batch"], mix["seq"]
    return gemm_flops(config, b, s) + attention_flops(config, b, s)


def element_size(config: dict) -> int:
    """Bytes of one element of the served dtype."""
    return torch.tensor([], dtype=dtype(config)).element_size()
