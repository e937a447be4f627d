"""DeepSeek-V2 decoder: multi-head latent attention, routed and shared
experts, YaRN rotary embeddings, an untied output head.

The layer equations of the published ``modeling_deepseek.py`` (DeepSeek-V2,
arXiv:2405.04434) without query compression (``q_lora_rank`` None, as in
DeepSeek-V2-Lite):

* **latent attention (MLA).**  ``q = h @ w_q`` per head is 128 "nope" and
  64 rotary dims; ``h @ w_kv_a`` is the 512-wide latent ``c`` and one
  64-dim rotary key shared by every head; ``c`` is RMS-normed and expanded
  by ``w_kv_b`` to each head's 128 key and 128 value dims.  The rotary
  parts are turned by YaRN's frequencies (:func:`yarn_inv_freq`); q and k
  are the nope and rotary parts side by side (192 dims), the shared rotary
  key broadcast to the heads; causal softmax attention at scale
  ``192^-0.5 * m^2`` (:func:`softmax_scale`), then ``@ w_o``;
* **the rotation** is the published one: the rotary dims are
  de-interleaved (``view(..., 32, 2).transpose``: even dims, then odd) and
  the halves rotated (:func:`tpusim_torch.models.blocks.rotate`).  q and k
  are permuted alike, so ``q . k`` equals that of adjacent pairs (2i,
  2i + 1) rotated in place;
* **routed experts.**  Router logits ``h.float() @ router.float()``, a
  float32 softmax over the experts, greedy top-k (weights not
  renormalised, times ``routed_scaling_factor``); the tokens sorted into
  expert order (none dropped), each expert's rows padded to a multiple of
  :data:`EXPERT_ROWS` (:func:`sort_by_expert`), each expert a SwiGLU over
  its rows (:func:`_experts`), the outputs put back in token order and
  summed over a token's k experts in float32 with their weights, then
  cast;
* **shared experts**: one SwiGLU of ``shared_experts`` times the expert
  width, added for every token; the first ``first_k_dense`` layers are a
  dense SwiGLU instead of the expert layer;
* **head**: the final RMSNorm and an untied ``lm_head`` ``[vocab, dim]``.

Arguments: the flat parameter list, then ``tokens`` [B, S] int32.  The
list is ``embed`` [vocab, dim], ``final_norm`` [dim], ``lm_head``
[vocab, dim], then each layer's keys in sorted order: a dense layer's
:data:`DENSE_KEYS`, an expert layer's :data:`MOE_KEYS` (:func:`param_shapes`;
weights in ``x @ w`` layout, each expert's stacked on a leading axis, a
routed expert's gate and up projections side by side in ``e_gate_up``, so
that one product computes both).

The expert layer reads the per-expert token counts to the host once a
layer, to cut the sorted rows into each expert's; the busiest expert's
count over the mean is kept for each expert layer of the last forward
(:attr:`DeepseekV2Forward.busiest_over_mean`).  The attention of an eager
bfloat16 CUDA forward with no gradient recorded and nothing tracing it
runs the port's causal kernel at head dims 192 / 128 (one launch a layer);
the CPU, another dtype or head dims, a gradient or a capture runs the
score chain (:func:`tpusim_torch.models.blocks.causal_attention`).
A capture for the simulator is not supported: the routing is
data-dependent.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpusim_torch.models.blocks import (
    ATTENTION_RANGE,
    EXPERTS_RANGE,
    HEAD_RANGE,
    MLP_RANGE,
    NORM_RANGE,
    PROJ_RANGE,
    ROPE_RANGE,
    ROUTER_RANGE,
    _rmsnorm,
    causal_attention,
    rotate,
)
from tpusim_torch.models.registry import register, resolve_device, torch_dtype
from tpusim_torch.obs.ranges import device_range

__all__ = ["DeepseekV2Config", "PRESETS", "DENSE_KEYS", "MOE_KEYS",
           "DeepseekV2Forward", "param_shapes", "init_params",
           "yarn_correction_range", "yarn_inv_freq", "softmax_scale",
           "route", "sort_by_expert", "shared_expert",
           "build_deepseek_v2"]

#: each expert's rows are padded to a multiple of this many, so that its
#: products take few shapes: cuBLAS chooses a kernel for a new shape on the
#: host, at several times the cost of a call at a shape it has met, and a
#: forward's row counts then fall on shapes that the first forwards met
#: (at 16k tokens about a dozen, where the exact counts take hundreds)
EXPERT_ROWS = 128


@dataclass(frozen=True)
class DeepseekV2Config:
    """The published keys of a DeepSeek-V2 ``config.json`` (the name in
    the comment where it differs)."""

    vocab: int = 102400                  # vocab_size
    dim: int = 2048                      # hidden_size
    layers: int = 27                     # num_hidden_layers
    heads: int = 16                      # num_attention_heads
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    ffn: int = 10944                     # intermediate_size (dense layers)
    moe_ffn: int = 1408                  # moe_intermediate_size
    experts: int = 64                    # n_routed_experts
    top_k: int = 6                       # num_experts_per_tok
    shared_experts: int = 2              # n_shared_experts
    first_k_dense: int = 1               # first_k_dense_replace
    routed_scaling_factor: float = 1.0
    eps: float = 1e-6                    # rms_norm_eps
    rope_theta: float = 10000.0
    # rope_scaling (type yarn)
    rope_factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    dtype: str = "bfloat16"

    def __post_init__(self):
        # YaRN's cos/sin factor mscale / mscale_all_dim is then 1, as in
        # every published DeepSeek-V2 config
        if self.mscale != self.mscale_all_dim:
            raise ValueError(f"mscale {self.mscale} != mscale_all_dim "
                             f"{self.mscale_all_dim}: the decoder computes "
                             f"YaRN with the two equal")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


PRESETS: dict[str, DeepseekV2Config] = {
    # DeepSeek-V2-Lite's config.json: 15.7e9 parameters, 29.26 GiB in bf16
    "lite": DeepseekV2Config(),
    # every mechanism at CPU size: a dense layer and two expert layers, 8
    # experts top-2 with a shared one, the latent norm, the published
    # rope_scaling on a 16-dim rotary part
    "tiny": DeepseekV2Config(
        vocab=512, dim=64, layers=3, heads=4, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, ffn=96,
        moe_ffn=24, experts=8, top_k=2, shared_experts=1),
}

#: a dense layer's and an expert layer's parameters in the argument order
#: (sorted keys)
DENSE_KEYS = ("attn_norm", "kv_a_norm", "mlp_norm", "w_down", "w_gate",
              "w_kv_a", "w_kv_b", "w_o", "w_q", "w_up")
MOE_KEYS = ("attn_norm", "e_down", "e_gate_up", "kv_a_norm", "mlp_norm",
            "router", "s_down", "s_gate", "s_up", "w_kv_a", "w_kv_b", "w_o",
            "w_q")


def _is_moe(cfg: DeepseekV2Config, i: int) -> bool:
    return i >= cfg.first_k_dense


def param_shapes(cfg: DeepseekV2Config) -> list[tuple[str, tuple[int, ...]]]:
    """``(key, shape)`` of each parameter in the argument order."""
    d, h = cfg.dim, cfg.heads
    attn = {
        "attn_norm": (d,), "kv_a_norm": (cfg.kv_lora_rank,), "mlp_norm": (d,),
        "w_q": (d, h * cfg.qk_head_dim),
        "w_kv_a": (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "w_kv_b": (cfg.kv_lora_rank,
                   h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "w_o": (h * cfg.v_head_dim, d),
    }
    shared = cfg.moe_ffn * cfg.shared_experts
    dense = dict(attn, w_gate=(d, cfg.ffn), w_up=(d, cfg.ffn),
                 w_down=(cfg.ffn, d))
    moe = dict(attn, router=(d, cfg.experts),
               e_gate_up=(cfg.experts, d, 2 * cfg.moe_ffn),
               e_down=(cfg.experts, cfg.moe_ffn, d),
               s_gate=(d, shared), s_up=(d, shared), s_down=(shared, d))
    out = [("embed", (cfg.vocab, d)), ("final_norm", (d,)),
           ("lm_head", (cfg.vocab, d))]
    for i in range(cfg.layers):
        if _is_moe(cfg, i):
            out += [(k, moe[k]) for k in MOE_KEYS]
        else:
            out += [(k, dense[k]) for k in DENSE_KEYS]
    return out


def init_params(cfg: DeepseekV2Config, device, seed: int = 0
                ) -> tuple[torch.Tensor, ...]:
    """Seeded random parameters: N(0, 0.02) weights, unit norms (on a
    ``meta`` device, their shapes and dtypes only)."""
    dt = torch_dtype(cfg.dtype)
    shapes = [s for _, s in param_shapes(cfg)]
    if torch.device(device).type == "meta":
        return tuple(torch.empty(s, dtype=dt, device=device) for s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.ones(s, dtype=dt, device=device) if len(s) == 1 else
        torch.randn(s, generator=gen, device=device, dtype=dt) * 0.02
        for s in shapes)


def _unflatten(cfg: DeepseekV2Config, params: Sequence[torch.Tensor]):
    embed, final_norm, lm_head = params[:3]
    layers, at = [], 3
    for i in range(cfg.layers):
        keys = MOE_KEYS if _is_moe(cfg, i) else DENSE_KEYS
        layers.append(dict(zip(keys, params[at:at + len(keys)])))
        at += len(keys)
    if at != len(params):
        raise ValueError(f"{len(params)} parameters for {cfg.layers} layers; "
                         f"expected {at}")
    return embed, final_norm, lm_head, layers


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config) -> tuple[int, int]:
    """The rotary dims (pairs) between which YaRN's ramp runs: ``floor``
    of the dim turned ``beta_fast`` times over the original context and
    ``ceil`` of the one turned ``beta_slow`` times, clamped to the dims."""
    d = cfg.qk_rope_head_dim

    def dim_of(turns: float) -> float:
        return (d * math.log(cfg.original_max_position
                             / (turns * 2 * math.pi))
                / (2 * math.log(cfg.rope_theta)))

    return (max(math.floor(dim_of(cfg.beta_fast)), 0),
            min(math.ceil(dim_of(cfg.beta_slow)), d - 1))


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of the rotary dims (``d / 2`` of them,
    float32): ``theta^(-2i/d)`` below the correction range, that over
    ``factor`` above it, a linear ramp between."""
    d = cfg.qk_rope_head_dim
    extra = 1.0 / cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    inter = extra / cfg.rope_factor
    low, high = yarn_correction_range(cfg)
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def yarn_tables(seq: int, cfg: DeepseekV2Config, device):
    """The rotary ``cos`` and ``sin`` tables, ``[1, seq, 1, d / 2]``
    (YaRN's cos/sin factor ``mscale / mscale_all_dim`` is 1: the config
    refuses the two unequal)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    angles = pos[:, None] * yarn_inv_freq(cfg, device)[None, :]
    return (torch.cos(angles)[None, :, None, :],
            torch.sin(angles)[None, :, None, :])


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``qk_head_dim^-0.5 * m^2``, ``m`` YaRN's attention factor over all
    dims (``0.1 * mscale_all_dim * ln(factor) + 1``)."""
    m = _yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    return cfg.qk_head_dim ** -0.5 * m * m


def _rope(x, cos, sin):
    """The published rotation of ``x`` [B, S, H, d]: de-interleaved (even
    dims, then odd), then its halves rotated; the result stays in the
    de-interleaved order."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, h, d // 2, 2).transpose(-1, -2).reshape(b, s, h, d)
    return rotate(x, cos, sin)


def _swiglu(x, gate, up, down):
    """``down(silu(x @ gate) * (x @ up))``."""
    return F.silu(x @ gate) * (x @ up) @ down


def _experts(rows, counts: list[int], gate_up, down):
    """The routed experts' SwiGLUs over ``rows`` [n, dim], sorted into
    expert order with ``counts[e]`` rows of expert ``e``: each expert's
    gate and up projections in one product (``gate_up`` [experts, dim, 2 *
    width], gate first) and its down product, two launches an expert, with
    the SiLU and the product of every expert's rows in one pass between
    them, so that the host issues the expert layer faster than the card
    runs it."""
    width = down.shape[1]
    gu = rows.new_empty(rows.shape[0], 2 * width)
    for x_e, gu_e, w_e in zip(rows.split(counts), gu.split(counts),
                              gate_up.unbind()):
        if x_e.shape[0]:
            torch.mm(x_e, w_e, out=gu_e)
    g, u = gu.chunk(2, dim=-1)
    act = F.silu(g) * u
    out = torch.empty_like(rows)
    for a_e, out_e, w_e in zip(act.split(counts), out.split(counts),
                               down.unbind()):
        if a_e.shape[0]:
            torch.mm(a_e, w_e, out=out_e)
    return out


def route(x, router, top_k: int, scaling: float):
    """The router over ``x`` [T, dim]: float32 logits ``x @ router``, a
    softmax over the experts and the greedy top-k, the weights not
    renormalised, times ``scaling``: ``(weights [T, k] float32, experts
    [T, k])``."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    weight, experts = torch.topk(probs, top_k, dim=-1, sorted=False)
    return weight * scaling, experts


class _HostCounts:
    """The rows each expert takes (``counts`` [experts] int64), on their
    way to the host.  On the card they are copied into pinned memory
    behind an event, without waiting, so that the card runs what is queued
    after the copy while the host waits for it (:meth:`get`), rather than
    emptying its queue at each expert layer."""

    def __init__(self, counts):
        self.done = None
        if counts.is_cuda:
            self.host = torch.empty(counts.shape, dtype=counts.dtype,
                                    pin_memory=True)
            self.host.copy_(counts, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host = counts

    def get(self) -> list[int]:
        if self.done is not None:
            self.done.synchronize()
        return self.host.tolist()


def padded(count: int) -> int:
    """``count`` rows rounded up to a multiple of :data:`EXPERT_ROWS`."""
    return -(-count // EXPERT_ROWS) * EXPERT_ROWS


def sort_by_expert(flat, experts: int):
    """Where each of the choices ``flat`` [T * k] (an expert each) goes
    among the sorted rows, each expert's rows starting at a multiple of
    :data:`EXPERT_ROWS`: ``(counts [experts], source [cap], place [T * k])``.
    ``source`` is the choice each of the ``cap`` rows is gathered from
    (``cap`` bounds every split; a padding row takes choice 0, whose
    product is computed and never read); choice ``i`` lands in row
    ``place[i]``.  All on the device, with no wait for the host."""
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(experts, dtype=torch.int64,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    rounded = (counts + EXPERT_ROWS - 1) // EXPERT_ROWS * EXPERT_ROWS
    # each expert's first padded row less its first sorted row
    shift = (rounded.cumsum(0) - rounded) - (counts.cumsum(0) - counts)
    sorted_place = torch.arange(n, device=flat.device) + shift[flat[order]]
    place = torch.empty_like(order).scatter_(0, order, sorted_place)
    cap = n + experts * (EXPERT_ROWS - 1)
    source = torch.zeros(cap, dtype=order.dtype,
                         device=flat.device).scatter_(0, sorted_place, order)
    return counts, source, place


def shared_expert(m, w: dict):
    """The shared experts over every token of ``m``: one SwiGLU of their
    summed width."""
    return _swiglu(m, w["s_gate"], w["s_up"], w["s_down"])


class DeepseekV2Forward(nn.Module):
    """``(*params, tokens) -> logits [B, S, vocab]``, single chip."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        self.scale = softmax_scale(cfg)
        #: each expert layer's busiest expert's tokens over the mean, in
        #: the last forward
        self.busiest_over_mean: list[float] = []

    def forward(self, *flat: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        tokens = flat[-1]
        embed, final_norm, lm_head, layers = _unflatten(cfg, flat[:-1])
        h = F.embedding(tokens, embed)
        with device_range(ROPE_RANGE):
            cos, sin = yarn_tables(tokens.shape[1], cfg, h.device)
        balance = []
        for i, w in enumerate(layers):
            h = self._attention(h, w, cos, sin)
            with device_range(NORM_RANGE):
                m = _rmsnorm(h, w["mlp_norm"], cfg.eps)
            if _is_moe(cfg, i):
                h, busiest = self._moe(h, m, w)
                balance.append(busiest)
            else:
                with device_range(MLP_RANGE):
                    h = h + _swiglu(m, w["w_gate"], w["w_up"], w["w_down"])
        self.busiest_over_mean = balance
        with device_range(NORM_RANGE):
            x = _rmsnorm(h, final_norm, cfg.eps)
        with device_range(HEAD_RANGE):
            return x @ lm_head.T

    def _attention(self, h, w: dict, cos, sin):
        """``h + mla(norm(h))``."""
        cfg = self.cfg
        b, s, _ = h.shape
        heads, nope, r = cfg.heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        with device_range(NORM_RANGE):
            a = _rmsnorm(h, w["attn_norm"], cfg.eps)
        with device_range(PROJ_RANGE):
            q = (a @ w["w_q"]).view(b, s, heads, cfg.qk_head_dim)
            kv_a = a @ w["w_kv_a"]
        with device_range(NORM_RANGE):
            c = _rmsnorm(kv_a[..., :r], w["kv_a_norm"], cfg.eps)
        with device_range(PROJ_RANGE):
            kv = (c @ w["w_kv_b"]).view(b, s, heads, nope + cfg.v_head_dim)
        with device_range(ROPE_RANGE):
            q_pe = _rope(q[..., nope:], cos, sin)
            k_pe = _rope(kv_a[..., r:].view(b, s, 1, cfg.qk_rope_head_dim),
                         cos, sin)
        with device_range(ATTENTION_RANGE):
            q = torch.cat([q[..., :nope], q_pe], dim=-1)
            k = torch.cat([kv[..., :nope], k_pe.expand(-1, -1, heads, -1)],
                          dim=-1)
            v = kv[..., nope:]
            o = causal_attention(q, k, v, self.scale)
            o = o.reshape(b, s, heads * cfg.v_head_dim)
        with device_range(PROJ_RANGE):
            return h + o @ w["w_o"]

    def _moe(self, h, m, w: dict):
        """``h + routed(m) + shared(m)``, and the busiest expert's tokens
        over the mean."""
        cfg = self.cfg
        dim = cfg.dim
        x = m.reshape(-1, dim)
        with device_range(ROUTER_RANGE):
            weight, idx = route(x, w["router"], cfg.top_k,
                                cfg.routed_scaling_factor)
            k = idx.shape[-1]
            counts, source, place = sort_by_expert(idx.reshape(-1),
                                                   cfg.experts)
            counts = _HostCounts(counts)
            rows = x.index_select(0, source // k)
        with device_range(MLP_RANGE):
            # queued before the host waits for the counts, so that the card
            # runs it while the host waits and issues the routed experts
            shared = shared_expert(m, w)
        with device_range(ROUTER_RANGE):
            counts = counts.get()
            sizes = [padded(c) for c in counts]
        with device_range(EXPERTS_RANGE):
            out = _experts(rows[:sum(sizes)], sizes, w["e_gate_up"],
                           w["e_down"])
        with device_range(ROUTER_RANGE):
            back = out.index_select(0, place)
            routed = (back.view(-1, k, dim) * weight[..., None]).sum(dim=1)
            routed = routed.to(m.dtype).view_as(m)
        with device_range(MLP_RANGE):
            h = h + (routed + shared)
        return h, max(counts) * cfg.experts / (x.shape[0] * k)


def _tokens(cfg: DeepseekV2Config, batch: int, seq: int, dev, seed: int = 0):
    if dev.type == "meta":
        return torch.empty((batch, seq), dtype=torch.int32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32).to(dev)


def build_deepseek_v2(preset: str = "tiny", batch: int = 2,
                      seq: int = 64, train: bool = False, device=None,
                      dtype: str | None = None):
    """Seeded random parameters (N(0, 0.02) weights) and tokens; the
    forward module and its arguments.  There is no train step."""
    if train:
        raise ValueError("deepseek_v2 has a forward only (train=False)")
    cfg = PRESETS[preset]
    if dtype is not None:
        cfg = replace(cfg, dtype=dtype)
    dev = resolve_device(device)
    return DeepseekV2Forward(cfg), (*init_params(cfg, dev),
                                    _tokens(cfg, batch, seq, dev))


@register(
    "deepseek_v2_lite",
    description="DeepSeek-V2-Lite fwd at published widths, single chip: "
    "MLA, 64 routed experts top-6 with 2 shared, YaRN RoPE",
    suite="models",
    preset="lite", batch=1, seq=16384, train=False,
)
def build_deepseek_v2_lite(device=None, **kw):
    # 15.7e9 parameters with the untied head, 29.26 GiB in bfloat16: one
    # H100 holds the whole forward at batch 1, seq 16384
    return build_deepseek_v2(device=device, **kw)


@register(
    "deepseek_v2_tiny",
    description="tiny DeepSeek-V2 decoder fwd (tests/CI): every mechanism "
    "of the Lite model",
    suite="models",
    preset="tiny", batch=2, seq=64, train=False,
)
def build_deepseek_v2_tiny(device=None, **kw):
    return build_deepseek_v2(device=device, **kw)
