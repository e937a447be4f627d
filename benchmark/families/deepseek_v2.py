"""The DeepSeek-V2 family: multi-head latent attention, routed and shared
experts, YaRN rotary embeddings, an untied output head.

The module is the program's
``tpusim_torch.models.deepseek_v2.DeepseekV2Forward`` over a
``DeepseekV2Config`` made from a configuration file's published keys,
called as ``measure_wall_time`` calls a module: ``module(*params,
tokens)`` under ``torch.no_grad()``.  The parameters are the program's
flat argument list (:func:`param_shapes`): ``embed``, ``final_norm``,
``lm_head``, then each layer's keys in sorted order, a dense layer's
:data:`DENSE_KEYS` and an expert layer's :data:`MOE_KEYS`; N(0, 0.02)
weights and unit norms drawn on the device from the seed into one buffer.
Judged against :mod:`benchmark.reference.deepseek_v2_plain` by
``logit_row_err`` and ``logit_row_err_median`` (:func:`readings`).
"""

from __future__ import annotations

import torch

from benchmark import compare, roofline, seeds, traffic
from benchmark.reference import deepseek_v2_plain

REFERENCE = "deepseek_v2_plain"

#: a dense layer's and an expert layer's parameters in the program's
#: argument order (sorted keys)
DENSE_KEYS = ("attn_norm", "kv_a_norm", "mlp_norm", "w_down", "w_gate",
              "w_kv_a", "w_kv_b", "w_o", "w_q", "w_up")
MOE_KEYS = ("attn_norm", "e_down", "e_gate_up", "kv_a_norm", "mlp_norm",
            "router", "s_down", "s_gate", "s_up", "w_kv_a", "w_kv_b", "w_o",
            "w_q")

#: elements drawn by one ``torch.randn`` call
_CHUNK = 1 << 30

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

#: published keys the program computes only at one value
_FIXED = {"hidden_act": "silu", "q_lora_rank": None, "topk_method": "greedy",
          "scoring_func": "softmax", "norm_topk_prob": False, "n_group": 1,
          "topk_group": 1, "moe_layer_freq": 1, "attention_bias": False,
          "tie_word_embeddings": False}


def dims(config: dict) -> deepseek_v2_plain.Dims:
    """The decoder's sizes from a configuration's published keys; refuses
    what this decoder does not compute."""
    for key, value in _FIXED.items():
        if config.get(key, value) != value:
            raise ValueError(f"{key} {config[key]!r}: the decoder computes "
                             f"{value!r} only")
    scaling = config["rope_scaling"]
    if (scaling or {}).get("type") != "yarn" or (
            scaling["mscale"] != scaling["mscale_all_dim"]):
        raise ValueError(f"rope_scaling {scaling!r}: the decoder computes "
                         f"YaRN with mscale equal to mscale_all_dim")
    if config["num_key_value_heads"] != config["num_attention_heads"]:
        raise ValueError("latent attention expands the latent to every "
                         "head: num_key_value_heads must equal the heads")
    return deepseek_v2_plain.Dims(
        vocab=config["vocab_size"], dim=config["hidden_size"],
        layers=config["num_hidden_layers"],
        heads=config["num_attention_heads"],
        kv_lora_rank=config["kv_lora_rank"],
        qk_nope_head_dim=config["qk_nope_head_dim"],
        qk_rope_head_dim=config["qk_rope_head_dim"],
        v_head_dim=config["v_head_dim"], ffn=config["intermediate_size"],
        moe_ffn=config["moe_intermediate_size"],
        experts=config["n_routed_experts"],
        top_k=config["num_experts_per_tok"],
        shared_experts=config["n_shared_experts"],
        first_k_dense=config["first_k_dense_replace"],
        routed_scaling_factor=float(config["routed_scaling_factor"]),
        eps=float(config["rms_norm_eps"]),
        rope_theta=float(config["rope_theta"]),
        rope_factor=float(scaling["factor"]),
        original_max_position=scaling["original_max_position_embeddings"],
        beta_fast=float(scaling["beta_fast"]),
        beta_slow=float(scaling["beta_slow"]),
        mscale=float(scaling["mscale"]),
        mscale_all_dim=float(scaling["mscale_all_dim"]))


def dtype(config: dict) -> torch.dtype:
    return _DTYPES[config["torch_dtype"]]


def check_traffic(config: dict, mix: dict) -> None:
    """A token mix no longer than the configuration's context."""
    traffic.check_tokens(mix)
    if mix["seq"] > config["max_position_embeddings"]:
        raise ValueError(f"seq {mix['seq']} exceeds max_position_embeddings "
                         f"{config['max_position_embeddings']}")


def param_shapes(d) -> list[tuple[str, tuple[int, ...]]]:
    """``(key, shape)`` of each parameter in the program's argument
    order."""
    h, r = d.heads, d.kv_lora_rank
    attn = {
        "attn_norm": (d.dim,), "kv_a_norm": (r,), "mlp_norm": (d.dim,),
        "w_q": (d.dim, h * d.qk_head_dim),
        "w_kv_a": (d.dim, r + d.qk_rope_head_dim),
        "w_kv_b": (r, h * (d.qk_nope_head_dim + d.v_head_dim)),
        "w_o": (h * d.v_head_dim, d.dim),
    }
    shared = d.moe_ffn * d.shared_experts
    dense = dict(attn, w_gate=(d.dim, d.ffn), w_up=(d.dim, d.ffn),
                 w_down=(d.ffn, d.dim))
    moe = dict(attn, router=(d.dim, d.experts),
               e_gate_up=(d.experts, d.dim, 2 * d.moe_ffn),
               e_down=(d.experts, d.moe_ffn, d.dim),
               s_gate=(d.dim, shared), s_up=(d.dim, shared),
               s_down=(shared, d.dim))
    out = [("embed", (d.vocab, d.dim)), ("final_norm", (d.dim,)),
           ("lm_head", (d.vocab, d.dim))]
    for i in range(d.layers):
        if i >= d.first_k_dense:
            out += [(k, moe[k]) for k in MOE_KEYS]
        else:
            out += [(k, dense[k]) for k in DENSE_KEYS]
    return out


def make_params(config: dict, seed: int, device) -> list[torch.Tensor]:
    """The parameters, drawn on ``device`` in the served dtype: every
    weight a view of one buffer filled by a few ``randn`` calls (scaled by
    0.02), every norm a view of one buffer of ones."""
    dt = dtype(config)
    shapes = [s for _, s in param_shapes(dims(config))]
    sizes = [torch.Size(s).numel() for s in shapes]
    mats = sum(n for s, n in zip(shapes, sizes) if len(s) > 1)
    norms = sum(n for s, n in zip(shapes, sizes) if len(s) == 1)
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
    for shape, n in zip(shapes, sizes):
        if len(shape) > 1:
            out.append(flat[at_m:at_m + n].view(shape))
            at_m += n
        else:
            out.append(ones[at_n:at_n + n].view(shape))
            at_n += n
    return out


def weights_tree(params, config: dict) -> dict:
    """The flat parameters as the reference's tree (a routed expert's
    ``e_gate_up`` as its published ``e_gate`` and ``e_up``)."""
    d = dims(config)
    layers, at = [], 3
    for i in range(d.layers):
        keys = MOE_KEYS if i >= d.first_k_dense else DENSE_KEYS
        layer = dict(zip(keys, params[at:at + len(keys)]))
        if "e_gate_up" in layer:
            layer["e_gate"], layer["e_up"] = layer.pop("e_gate_up").chunk(
                2, dim=-1)
        layers.append(layer)
        at += len(keys)
    return {"embed": params[0], "final_norm": params[1],
            "lm_head": params[2], "layers": layers}


def program_config(config: dict):
    """The program's ``DeepseekV2Config`` of a configuration file."""
    from tpusim_torch.models.deepseek_v2 import DeepseekV2Config

    d = dims(config)
    return DeepseekV2Config(
        vocab=d.vocab, dim=d.dim, layers=d.layers, heads=d.heads,
        kv_lora_rank=d.kv_lora_rank, qk_nope_head_dim=d.qk_nope_head_dim,
        qk_rope_head_dim=d.qk_rope_head_dim, v_head_dim=d.v_head_dim,
        ffn=d.ffn, moe_ffn=d.moe_ffn, experts=d.experts, top_k=d.top_k,
        shared_experts=d.shared_experts, first_k_dense=d.first_k_dense,
        routed_scaling_factor=d.routed_scaling_factor, eps=d.eps,
        rope_theta=d.rope_theta, rope_factor=d.rope_factor,
        original_max_position=d.original_max_position,
        beta_fast=d.beta_fast, beta_slow=d.beta_slow, mscale=d.mscale,
        mscale_all_dim=d.mscale_all_dim, dtype=config["torch_dtype"])


def build(config: dict, device):
    """The program's module for this configuration."""
    from tpusim_torch.models.deepseek_v2 import DeepseekV2Forward

    return DeepseekV2Forward(program_config(config)).to(device)


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


@torch.no_grad()
def row_errors(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's relative gap ``||out - ref|| / ||ref||`` (float64, on the
    host), rows along the last axis."""
    ref = ref.reshape(-1, ref.shape[-1])
    out = out.reshape(-1, out.shape[-1])
    gaps = []
    for lo in range(0, ref.shape[0], 1024):
        r = ref[lo:lo + 1024]
        gap = (out[lo:lo + 1024].float() - r).norm(dim=-1)
        gaps.append((gap / r.norm(dim=-1).clamp_min(1e-30)).double().cpu())
    return torch.cat(gaps)


def readings(out: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The numbers compared for one step (each an error: larger is
    worse): the worst row's gap, ``logit_row_err``, which one row left out
    or altered lifts; and the median row's, ``logit_row_err_median``,
    which a fault in every token's routed experts lifts (a sixth expert
    left out moves every row by about as much as bfloat16 storage does,
    so it cannot lift the worst row past the program's own spread, while
    near-ties between a token's sixth and seventh expert lift only a few
    rows).  A NaN anywhere reads NaN in both."""
    gaps = row_errors(out, ref)
    return {"logit_row_err": compare.worst(gaps.tolist()),
            "logit_row_err_median": float(torch.quantile(gaps, 0.5))}


def reference(params, tokens, config: dict, matmul_dtype=None,
              store_dtype=None):
    """float32 logits of the plain reference (``matmul_dtype``: the
    control's rounding; ``store_dtype``: the bfloat16-storage witness)."""
    return deepseek_v2_plain.forward(weights_tree(params, config), tokens,
                                     dims(config), matmul_dtype=matmul_dtype,
                                     store_dtype=store_dtype)


def gemms(config: dict, mix: dict) -> list[tuple[float, int, int, int]]:
    """The weight products of one step as ``(m, n, k, count)``: each
    layer's q, latent-and-rotary-key, latent up-projection and o
    products; the dense layers' gate, up and down; each expert layer's
    float32 router product, shared experts' gate, up and down, and every
    routed expert's gate-and-up and down at ``tokens * k / experts`` rows
    (the products are
    bound by their operations, so the sum of their bounds does not depend
    on how the routing splits the tokens); the output head."""
    d = dims(config)
    t = mix["batch"] * mix["seq"]
    h, r = d.heads, d.kv_lora_rank
    moe_layers = d.layers - d.first_k_dense
    shared = d.moe_ffn * d.shared_experts
    rows = t * d.top_k / d.experts
    out = [(t, h * d.qk_head_dim, d.dim, d.layers),
           (t, r + d.qk_rope_head_dim, d.dim, d.layers),
           (t, h * (d.qk_nope_head_dim + d.v_head_dim), r, d.layers),
           (t, d.dim, h * d.v_head_dim, d.layers),
           (t, d.ffn, d.dim, 2 * d.first_k_dense),
           (t, d.dim, d.ffn, d.first_k_dense),
           (t, d.experts, d.dim, moe_layers),
           (t, shared, d.dim, 2 * moe_layers),
           (t, d.dim, shared, moe_layers),
           (rows, 2 * d.moe_ffn, d.dim, d.experts * moe_layers),
           (rows, d.dim, d.moe_ffn, d.experts * moe_layers),
           (t, d.vocab, d.dim, 1)]
    return [g for g in out if g[3]]


def gemm_flops(config: dict, batch: int, seq: int) -> float:
    """Operations of the weight products, two a multiply-add."""
    return sum(roofline.gemm_ops(m, n, k) * c for m, n, k, c in
               gemms(config, {"batch": batch, "seq": seq}))


def attention_flops(config: dict, batch: int, seq: int) -> float:
    """Causal latent attention's QK^T (over ``qk_head_dim``) and PV (over
    ``v_head_dim``) over the lower triangle with its diagonal: ``b * h *
    s * (s + 1) * (d_qk + d_v)`` a layer."""
    d = dims(config)
    return float(batch * d.heads * seq * (seq + 1)
                 * (d.qk_head_dim + d.v_head_dim) * d.layers)


def attention_bytes(config: dict, batch: int, seq: int) -> float:
    """Bytes the latent attention's kernels move a step: q and k (each
    head's ``qk_head_dim``) and v read once, the output (``v_head_dim``)
    written once, in the served dtype."""
    d = dims(config)
    per_layer = batch * seq * d.heads * 2 * (d.qk_head_dim + d.v_head_dim)
    return float(per_layer * d.layers * element_size(config))


def model_flops(config: dict, mix: dict) -> float:
    """The step's model operations: the weight products (the active
    experts only) and causal attention."""
    b, s = mix["batch"], mix["seq"]
    return gemm_flops(config, b, s) + attention_flops(config, b, s)


def element_size(config: dict) -> int:
    """Bytes of one element of the served dtype."""
    return torch.tensor([], dtype=dtype(config)).element_size()
