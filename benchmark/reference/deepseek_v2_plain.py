"""A plain DeepSeek-V2 decoder in float32: the reference the DeepSeek-V2
cells are judged against.

Written from the published ``modeling_deepseek.py`` of DeepSeek-V2
(arXiv:2405.04434) without query compression, as in DeepSeek-V2-Lite:
pre-norm RMSNorm; multi-head latent attention (q projected per head into
"nope" and rotary dims; one joint projection to a latent, RMS-normed and
expanded per head into keys and values, and to one rotary key shared by
every head; YaRN rotary frequencies; causal softmax at scale
``qk_head_dim^-0.5 * m^2``); a dense SwiGLU in the first layers, then
expert layers (a float32 softmax router, greedy top-k, each routed expert
a SwiGLU, the weighted sum over a token's experts, plus the shared
experts); a final RMSNorm and an untied output head.  Plain torch
operations only, TF32 off, computed layer by layer so that one layer's
weights are held in float32 at a time; the attention in blocks of query
rows, so that a 16k-token step fits beside the bfloat16 weights; the
experts in a loop over the experts that gathers each one's tokens and adds
its weighted output back with ``index_add``.

Departures from the published code, none of which changes the
mathematics:

* the rotary dims are rotated as adjacent pairs (2i, 2i + 1) in place; the
  published code de-interleaves them (even dims, then odd) and rotates the
  halves, which permutes the rotary dims of q and k alike, so every score
  ``q . k`` is the same;
* the causal mask is applied with ``-inf`` to the scores of each query
  block rather than by adding a mask tensor;
* the weighted sum over a token's experts is taken expert by expert
  (``index_add``) rather than token by token;
* everything is float32, where the published model computes in its
  bfloat16 (its router and that weighted sum are float32 there too).

``matmul_dtype=torch.float8_e4m3fn`` is the control: every operand of
every product (the embedding table, the router and the attention's
too) is rounded to fp8 with one scale per tensor, and the products are
accumulated in float32, as an fp8 GEMM does.  ``store_dtype=torch.bfloat16``
rounds every activation the decoder stores to bfloat16 while the
arithmetic stays float32: a plain witness of what bfloat16 storage alone
costs.  It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

#: query rows a block of the attention
QUERY_BLOCK = 1024


@dataclass(frozen=True)
class Dims:
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    ffn: int
    moe_ffn: int
    experts: int
    top_k: int
    shared_experts: int
    first_k_dense: int
    routed_scaling_factor: float
    eps: float
    rope_theta: float
    rope_factor: float
    original_max_position: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@contextlib.contextmanager
def _no_tf32():
    """Full float32 products: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _rounder(matmul_dtype):
    """The operand rounding of the products: none in float32; fp8 with a
    per-tensor scale (the largest magnitude maps to the format's
    largest finite value) for the control."""
    if matmul_dtype is None:
        return lambda x: x
    top = torch.finfo(matmul_dtype).max

    def rnd(x):
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(matmul_dtype).float() * scale

    return rnd


def _storer(store_dtype):
    if store_dtype is None:
        return lambda x: x
    return lambda x: x.to(store_dtype).float()


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(factor) + 1`` (1 for a
    factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def inv_freq(dims: Dims, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of the rotary dims' pairs.  Pair ``i`` of
    ``d`` rotary dims turns ``theta^(-2i/d)`` a position; YaRN divides
    that by ``factor`` for the pairs that turn fewer than ``beta_slow``
    times over the original context, keeps it for those that turn more
    than ``beta_fast`` times, and blends the two linearly between (the
    pair that turns ``r`` times lies at ``d ln(L / 2 pi r) / 2 ln theta``,
    floored for ``beta_fast`` and ceiled for ``beta_slow``)."""
    d = dims.qk_rope_head_dim
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    base = dims.rope_theta ** (-2 * i / d)

    def at(turns):
        return d * math.log(dims.original_max_position
                            / (2 * math.pi * turns)) / (2 * math.log(
                                dims.rope_theta))

    low = max(math.floor(at(dims.beta_fast)), 0)
    high = min(math.ceil(at(dims.beta_slow)), d - 1)
    blend = torch.clamp((i - low) / max(high - low, 1e-3), 0.0, 1.0)
    return base / dims.rope_factor * blend + base * (1.0 - blend)


def _rope_pairs(x, positions, freqs):
    """Rotate ``x`` [B, S, H, d]: dims (2i, 2i + 1) are the two coordinates
    of pair ``i``, turned by ``position * freqs[i]`` (YaRN's cos/sin factor
    ``mscale / mscale_all_dim`` is 1 where the two are equal, as
    published; :func:`forward` refuses other values)."""
    ang = positions[:, None].float() * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin],
                       dim=-1).flatten(-2)


def _causal_attention(q, k, v, scale, rnd, st):
    """softmax(q k^T * scale, keys j <= i) v over ``[B, S, H, D]``, a block
    of :data:`QUERY_BLOCK` query rows at a time (each reading the keys up
    to its last row)."""
    b, s, h, _ = q.shape
    q, k, v = rnd(q), rnd(k), rnd(v)
    out = q.new_empty(b, s, h, v.shape[-1])
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        scores = st(st(torch.einsum("bqhd,bkhd->bhqk", q[:, lo:hi],
                                    k[:, :hi])) * scale)
        later = (torch.arange(hi, device=q.device)[None, :]
                 > torch.arange(lo, hi, device=q.device)[:, None])
        probs = st(torch.softmax(scores.masked_fill(later, float("-inf")),
                                 dim=-1))
        del scores
        out[:, lo:hi] = st(torch.einsum("bhqk,bkhd->bqhd", rnd(probs),
                                        v[:, :hi]))
    return out


def _mla(h, w: dict, dims: Dims, freqs, rnd, st):
    """``h + mla(norm(h))``."""
    b, s, _ = h.shape
    heads, nope = dims.heads, dims.qk_nope_head_dim
    rope = dims.qk_rope_head_dim
    r = dims.kv_lora_rank
    pos = torch.arange(s, device=h.device)
    a = rnd(st(_rmsnorm(h, w["attn_norm"], dims.eps)))
    q = st(a @ rnd(w["w_q"])).view(b, s, heads, nope + rope)
    kv_a = st(a @ rnd(w["w_kv_a"]))
    latent = rnd(st(_rmsnorm(kv_a[..., :r], w["kv_a_norm"], dims.eps)))
    kv = st(latent @ rnd(w["w_kv_b"])).view(b, s, heads,
                                            nope + dims.v_head_dim)
    q_rot = st(_rope_pairs(q[..., nope:], pos, freqs))
    k_rot = st(_rope_pairs(kv_a[..., r:].reshape(b, s, 1, rope), pos, freqs))
    q = torch.cat([q[..., :nope], q_rot], dim=-1)
    k = torch.cat([kv[..., :nope], k_rot.expand(b, s, heads, rope)], dim=-1)
    scale = (dims.qk_head_dim ** -0.5
             * yarn_mscale(dims.rope_factor, dims.mscale_all_dim) ** 2)
    o = _causal_attention(q, k, kv[..., nope:], scale, rnd, st)
    o = o.reshape(b, s, heads * dims.v_head_dim)
    return st(h + st(rnd(o) @ rnd(w["w_o"])))


def _swiglu(x, gate, up, down, rnd, st):
    """``down(silu(x @ gate) * (x @ up))`` (``x`` rounded by the caller)."""
    g = st(x @ rnd(gate))
    u = st(x @ rnd(up))
    return st(rnd(st(st(torch.nn.functional.silu(g)) * u)) @ rnd(down))


def route(x, router, dims: Dims, rnd):
    """The router over ``x`` [T, dim]: a float32 softmax over the experts
    and the greedy top-k, the weights not renormalised, times
    ``routed_scaling_factor``: ``(weights [T, k], experts [T, k])``."""
    probs = torch.softmax(rnd(x) @ rnd(router), dim=-1)
    weight, experts = torch.topk(probs, dims.top_k, dim=-1)
    return weight * dims.routed_scaling_factor, experts


def _moe(h, w: dict, dims: Dims, rnd, st):
    """``h + (routed(norm(h)) + shared(norm(h)))``."""
    m = st(_rmsnorm(h, w["mlp_norm"], dims.eps))
    x = m.reshape(-1, dims.dim)
    weight, experts = route(x, w["router"], dims, rnd)
    xr = rnd(x)
    routed = torch.zeros_like(x)
    for e in range(dims.experts):
        token, slot = torch.nonzero(experts == e, as_tuple=True)
        if token.numel() == 0:
            continue
        out = _swiglu(xr[token], w["e_gate"][e], w["e_up"][e],
                      w["e_down"][e], rnd, st)
        routed.index_add_(0, token, out * weight[token, slot, None])
    routed = st(routed).view_as(m)
    shared = _swiglu(rnd(m), w["s_gate"], w["s_up"], w["s_down"], rnd, st)
    return st(h + st(routed + shared))


def _dense(h, w: dict, dims: Dims, rnd, st):
    m = rnd(st(_rmsnorm(h, w["mlp_norm"], dims.eps)))
    return st(h + _swiglu(m, w["w_gate"], w["w_up"], w["w_down"], rnd, st))


@torch.no_grad()
def forward(weights: dict, tokens: torch.Tensor, dims: Dims,
            matmul_dtype=None, store_dtype=None) -> torch.Tensor:
    """float32 logits ``[B, S, vocab]`` of ``tokens`` [B, S] under
    ``weights``: ``{"embed": [vocab, dim], "final_norm": [dim],
    "lm_head": [vocab, dim], "layers": [{...}, ...]}`` in any dtype, a
    dense layer's keys ``attn_norm, kv_a_norm, mlp_norm, w_q, w_kv_a,
    w_kv_b, w_o, w_gate, w_up, w_down``, an expert layer's the same
    attention keys and ``router`` [dim, experts], ``e_gate``, ``e_up``
    [experts, dim, moe_ffn], ``e_down`` [experts, moe_ffn, dim],
    ``s_gate``, ``s_up``, ``s_down`` (``x @ w`` layout: ``w_q`` is ``[dim,
    heads * qk_head_dim]``).  The output projection is ``x @ lm_head^T``."""
    if dims.mscale != dims.mscale_all_dim:
        raise ValueError("the rotary tables' factor mscale / mscale_all_dim "
                         "is taken as 1: the two must be equal")
    rnd, st = _rounder(matmul_dtype), _storer(store_dtype)
    with _no_tf32():
        freqs = inv_freq(dims, tokens.device)
        h = rnd(weights["embed"].float())[tokens.long()]
        for i, layer in enumerate(weights["layers"]):
            w = {k: t.float() for k, t in layer.items()}
            h = _mla(h, w, dims, freqs, rnd, st)
            h = (_moe if i >= dims.first_k_dense else _dense)(h, w, dims, rnd,
                                                               st)
            del w
        x = st(_rmsnorm(h, weights["final_norm"].float(), dims.eps))
        return st(rnd(x) @ rnd(weights["lm_head"].float()).T)
