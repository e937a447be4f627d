"""A plain RMSNorm / RoPE / SwiGLU decoder in float32: the reference the
Llama-style cells are judged against.

Written from the published description of the Llama architecture (as in
Mistral-7B and DeepSeek-LLM-7B): pre-norm RMSNorm, rotary embeddings with
the half-split rotation, causal softmax attention where each key/value
head serves ``heads // kv_heads`` consecutive query heads, a SwiGLU MLP,
residual adds, a final RMSNorm and an output projection.  Plain torch
operations only, TF32 off, computed layer by layer so that one layer's
weights are held in float32 at a time.

``matmul_dtype=torch.float8_e4m3fn`` is the control: every operand of
every product (the embedding table too) is rounded to fp8 with one scale
per tensor, and the products are accumulated in float32, as an fp8 GEMM
does.  ``store_dtype=torch.bfloat16`` rounds every activation the
decoder stores (projections, rotated heads, scores, probabilities, the
residual stream, the MLP's products, the logits) to bfloat16 while the
arithmetic stays float32: a plain witness of what bfloat16 storage alone
costs.  It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Dims:
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    eps: float
    rope_theta: float

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


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


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """Rotate ``x`` [B, S, H, D]: the first and second halves of each head
    are the two coordinates of D/2 planes turned by ``pos * theta^(-2i/D)``."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = positions[:, None].float() * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _storer(store_dtype):
    if store_dtype is None:
        return lambda x: x
    return lambda x: x.to(store_dtype).float()


def _layer(h, w: dict, dims: Dims, rnd, st):
    b, s, _ = h.shape
    hd, heads, kvh = dims.head_dim, dims.heads, dims.kv_heads
    pos = torch.arange(s, device=h.device)
    a = rnd(st(_rmsnorm(h, w["attn_norm"], dims.eps)))
    q = st(a @ rnd(w["wq"])).view(b, s, heads, hd)
    k = st(a @ rnd(w["wk"])).view(b, s, kvh, hd)
    v = st(a @ rnd(w["wv"])).view(b, s, kvh, hd)
    q = st(_rope(q, pos, dims.rope_theta))
    k = st(_rope(k, pos, dims.rope_theta))
    # query head j reads key/value head j // (heads // kv_heads)
    group = heads // kvh
    k = k[:, :, torch.arange(heads, device=h.device) // group]
    v = v[:, :, torch.arange(heads, device=h.device) // group]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # [B, H, S, D]
    scores = st(st(rnd(q) @ rnd(k).transpose(-1, -2)) / hd ** 0.5)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = st(torch.softmax(scores, dim=-1))
    del scores
    o = st(rnd(probs) @ rnd(v)).transpose(1, 2).reshape(b, s, heads * hd)
    h = st(h + st(rnd(o) @ rnd(w["wo"])))
    m = rnd(st(_rmsnorm(h, w["mlp_norm"], dims.eps)))
    g = st(m @ rnd(w["w_gate"]))
    u = st(m @ rnd(w["w_up"]))
    mlp = st(rnd(st(st(torch.nn.functional.silu(g)) * u)) @ rnd(w["w_down"]))
    return st(h + mlp)


@torch.no_grad()
def forward(weights: dict, tokens: torch.Tensor, dims: Dims,
            matmul_dtype=None, store_dtype=None) -> torch.Tensor:
    """float32 logits ``[B, S, vocab]`` of ``tokens`` [B, S] under
    ``weights``: ``{"embed": [vocab, dim], "final_norm": [dim],
    "layers": [{"attn_norm", "mlp_norm", "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down"}, ...]}`` in any dtype (``x @ w``
    layout: ``wq`` is ``[dim, heads * head_dim]``).  The output
    projection is the embedding table, transposed."""
    rnd, st = _rounder(matmul_dtype), _storer(store_dtype)
    with _no_tf32():
        table = rnd(weights["embed"].float())
        h = table[tokens.long()]
        for layer in weights["layers"]:
            h = _layer(h, {k: t.float() for k, t in layer.items()}, dims,
                       rnd, st)
        x = st(_rmsnorm(h, weights["final_norm"].float(), dims.eps))
        return st(rnd(x) @ table.T)
