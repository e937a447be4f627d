"""Llama-2-7B with stacked, scanned layers — port of ``llama7b_aot_v5p64``
from ``tpusim/models/llama.py`` (``build_llama_aot``, ``stack_layers``,
``llama_forward(scan_layers=True)``).

The train step of a ``(dp, tp)`` mesh over layer parameters stacked on a
leading ``[L]`` dim: the decoder is one ``scan`` over the layers, and its
backward a second, reversed ``scan`` — two ``while`` loops in the trace,
as XLA's transpose of ``lax.scan`` gives.  ``torch.func`` cannot
differentiate through the ``scan`` operator under ``make_fx`` (its
``grad`` fails on it), so the layer's backward is written out
(:func:`layer_backward`): the forward scan stacks the residuals it needs
(the layer input, the rotated queries and keys, the values, the
attention probabilities and output, the residual stream after attention
and the MLP's gate and up projections), so the backward recomputes no
product and its MXU flops are autograd's.  The embedding and the tied
head outside the scans take ``torch.func.vjp``.

The collectives are the JAX capture's (its CPU-mesh trace at a small
configuration): in the forward body the two row-parallel all-reduces
over ``tp``; in the backward body the column-parallel groups' partial
input gradients (Q/K/V in one tuple, gate/up in another) over ``tp`` and
the layer's nine gradients over ``dp`` in one tuple; outside the loops
the vocab-parallel embedding, ``log_softmax``'s all-reduces (as
:class:`~tpusim_torch.models.llama.LlamaTrainStep`), the logits' input
gradient, and the loss with the embedding's two gradient parts and the
final norm's over ``dp``.

Registered abstract: the reference captures this step over
``ShapeDtypeStruct`` arguments on 64 virtual devices, the port over meta
tensors; its numerics are held at a small configuration (the build
overrides of :data:`~tpusim_torch.models.llama.CONFIG_OVERRIDES`).
"""

from __future__ import annotations

import torch

from tpusim_torch.models.llama import (
    LAYER_KEYS,
    LlamaConfig,
    _Decoder,
    _rmsnorm,
    _tokens,
    causal_mask,
    config_for,
    rope_tables,
    rotate,
)
from tpusim_torch.models.registry import register, resolve_device, torch_dtype
from tpusim_torch.spmd import (Mesh, P, SpmdModule, psum_coalesced, psum_plain,
                               run_ranks)

__all__ = ["LlamaAotTrainStep", "stacked_specs", "stacked_shapes",
           "init_stacked", "layer_forward", "layer_backward",
           "build_llama_aot"]

#: each stacked layer parameter's partition spec: the reference's
#: ``layer_spec`` in ``build_llama_aot``
_STACKED_SPECS = {
    "attn_norm": P(), "mlp_norm": P(),
    "wq": P(None, None, "tp"), "wk": P(None, None, "tp"),
    "wv": P(None, None, "tp"), "wo": P(None, "tp", None),
    "w_gate": P(None, None, "tp"), "w_up": P(None, None, "tp"),
    "w_down": P(None, "tp", None),
}


def stacked_shapes(cfg: LlamaConfig) -> list[tuple[int, ...]]:
    """``embed``, ``final_norm``, then the stacked layer parameters in
    :data:`LAYER_KEYS` order (the reference pytree's leaf order)."""
    kv = cfg.kv_heads * cfg.head_dim
    layer = {
        "attn_norm": (cfg.dim,), "mlp_norm": (cfg.dim,),
        "wq": (cfg.dim, cfg.dim), "wk": (cfg.dim, kv), "wv": (cfg.dim, kv),
        "wo": (cfg.dim, cfg.dim), "w_gate": (cfg.dim, cfg.ffn),
        "w_up": (cfg.dim, cfg.ffn), "w_down": (cfg.ffn, cfg.dim),
    }
    return [(cfg.vocab, cfg.dim), (cfg.dim,)] + [
        (cfg.layers, *layer[k]) for k in LAYER_KEYS]


def stacked_specs() -> tuple:
    return (P("tp", None), P()) + tuple(_STACKED_SPECS[k]
                                         for k in LAYER_KEYS)


def init_stacked(cfg: LlamaConfig, device, seed: int = 0
                 ) -> tuple[torch.Tensor, ...]:
    """Seeded stacked parameters (N(0, 0.02) weights, unit norms); on a
    ``meta`` device their shapes and dtypes only."""
    dt = torch_dtype(cfg.dtype)
    shapes = stacked_shapes(cfg)
    if torch.device(device).type == "meta":
        return tuple(torch.empty(s, dtype=dt, device=device) for s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for i, shape in enumerate(shapes):
        norm = i == 1 or (i >= 2 and LAYER_KEYS[i - 2].endswith("norm"))
        out.append(torch.ones(shape, dtype=dt, device=device) if norm else
                   torch.randn(shape, generator=gen, device=device,
                               dtype=dt) * 0.02)
    return tuple(out)


# ---------------------------------------------------------------------------
# One layer, forward and backward, for one rank
# ---------------------------------------------------------------------------


def layer_forward(dec: _Decoder, h, layer):
    """The decoder layer (``_Decoder.layer`` with the bare collectives):
    the next carry and the residuals :func:`layer_backward` reads, the
    layer input first (a copy: a scan output may not alias its carry)."""
    h2, res = dec.layer(h, dict(zip(LAYER_KEYS, layer)), plain=True)
    return h2, (h.clone(), *res)


def _rmsnorm_backward(x, w, dy, eps):
    """``(dx, dw)`` of ``(x32 * rsqrt(mean(x32²) + eps)).to(dt) * w``."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    n = (x32 * r).to(x.dtype)
    dw = (dy * n).reshape(-1, dy.shape[-1]).sum(0)
    dn = (dy * w).float()
    dx = r * dn - x32 * r ** 3 * (dn * x32).mean(dim=-1, keepdim=True)
    return dx.to(x.dtype), dw


def _wgrad(x, dy):
    """``x^T @ dy`` over the batch and sequence dims: a weight's
    gradient."""
    return x.reshape(-1, x.shape[-1]).T @ dy.reshape(-1, dy.shape[-1])


def layer_backward(dec: _Decoder, dh2, layer, res):
    """The cotangent of the layer's input and the nine gradients (in
    :data:`LAYER_KEYS` order) from the cotangent of its output and the
    residuals of :func:`layer_forward`."""
    cfg = dec.cfg
    w = dict(zip(LAYER_KEYS, layer))
    h, q, k, v, probs, o, h1, g, u = res
    b, s, _ = h.shape
    hd, heads = cfg.head_dim, cfg.heads // dec.tp
    cos, sin = rope_tables(s, hd, cfg.rope_theta, h.device)
    # the MLP (the row-parallel sum's cotangent passes through)
    sig = torch.sigmoid(g)
    gate = g * sig
    dp = dh2 @ w["w_down"].T
    d_down = _wgrad(gate * u, dh2)
    du = dp * gate
    dg = dp * u * (sig * (1 + g * (1 - sig)))
    m = _rmsnorm(h1, w["mlp_norm"], cfg.eps)
    d_gate, d_up = _wgrad(m, dg), _wgrad(m, du)
    dm = dec.psum_tp_sum((dg @ w["w_gate"].T, du @ w["w_up"].T))
    dx, d_mlp_norm = _rmsnorm_backward(h1, w["mlp_norm"], dm, cfg.eps)
    dh1 = dh2 + dx
    # attention
    do = dh1 @ w["wo"].T
    d_wo = _wgrad(o, dh1)
    do = do.reshape(b, s, heads, hd)
    dprobs = torch.einsum("bqhd,bkhd->bhqk", do, v)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, do)
    p32 = probs.float()
    ds = p32 * (dprobs.float() - (dprobs.float() * p32).sum(-1, keepdim=True))
    ds = torch.where(causal_mask(s, h.device)[None, None], ds, 0.0)
    dscores = (ds / (hd ** 0.5)).to(h.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", dscores, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", dscores, q)
    dq = rotate(dq, cos, sin, inverse=True).reshape(b, s, heads * hd)
    dk = rotate(dk, cos, sin, inverse=True).reshape(b, s, heads * hd)
    dv = dv.reshape(b, s, heads * hd)
    a = _rmsnorm(h, w["attn_norm"], cfg.eps)
    d_wq, d_wk, d_wv = _wgrad(a, dq), _wgrad(a, dk), _wgrad(a, dv)
    da = dec.psum_tp_sum((dq @ w["wq"].T, dk @ w["wk"].T, dv @ w["wv"].T))
    dx, d_attn_norm = _rmsnorm_backward(h, w["attn_norm"], da, cfg.eps)
    grads = {"attn_norm": d_attn_norm, "mlp_norm": d_mlp_norm,
             "w_down": d_down, "w_gate": d_gate, "w_up": d_up, "wk": d_wk,
             "wo": d_wo, "wq": d_wq, "wv": d_wv}
    return dh1 + dx, tuple(grads[k_] for k_ in LAYER_KEYS)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _static_shapes():
    """Dynamo (which traces an eager scan's body) with every shape
    static: a body traced again at other shapes (a capture at full width,
    then a run at a cut one) would otherwise turn symbolic, which torch
    2.11's matmul refuses under the rank runner's vmap."""
    return torch._dynamo.config.patch(automatic_dynamic_shapes=False,
                                      assume_static_by_default=True)


class LlamaAotTrainStep(SpmdModule):
    """``(embed, final_norm, *stacked, tokens, targets) -> (loss,
    *params')``: the reference's ``build_llama_aot`` step, one SGD step of
    lr 3e-4 on the mean token NLL, with the layers stacked and scanned.
    ``mesh=None``: the single-chip step."""

    #: capture traces the step with ``make_fx``
    train_step = True

    def __init__(self, cfg: LlamaConfig, mesh: Mesh | None, batch: int,
                 lr: float = 3e-4):
        super().__init__()
        self.cfg, self.lr, self.batch = cfg, lr, batch
        self.mesh = mesh or Mesh((1, 1), ("dp", "tp"))
        self._spmd = mesh
        data = P("dp")
        self.in_specs = stacked_specs() + (data, data)
        self.out_specs = (P(),) + stacked_specs()

    def loss_and_grads(self, *flat: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """One rank's ``(loss, *grads)``, each gradient float32 and
        all-reduced over ``dp``."""
        from torch._higher_order_ops.scan import scan

        embed, final_norm = flat[0], flat[1]
        stacked, tokens, targets = flat[2:-2], flat[-2], flat[-1]
        mesh = self._spmd
        dec = _Decoder(self.cfg, mesh)
        dp = self.mesh.shape[self.mesh.names.index("dp")]
        count = self.batch * tokens.shape[1]
        offset = dec.vocab_offset(embed, tokens)

        x0, embed_vjp = torch.func.vjp(
            lambda e: dec.embed(e, tokens, offset), embed)
        with _static_shapes():
            h_last, res = scan(lambda h, ly: layer_forward(dec, h, ly), x0,
                               tuple(stacked))

        def head(h, norm, table):
            x = dec.pvary_tp(_rmsnorm(h, norm, self.cfg.eps))
            return x @ table.T

        logits, head_vjp = torch.func.vjp(head, h_last, final_norm, embed)
        loss, d_logits = dec.nll(logits, offset, targets, count)
        dh, d_norm, d_table = head_vjp(d_logits.to(logits.dtype))

        def back(dh2, xs):
            ly, rs = xs[:len(LAYER_KEYS)], xs[len(LAYER_KEYS):]
            dh1, grads = layer_backward(dec, dh2, ly, rs)
            grads = [g.float() for g in grads]
            if mesh is not None and dp > 1:
                grads = psum_plain(grads, mesh, "dp")
            return dh1, tuple(grads)

        with _static_shapes():
            dx0, layer_grads = scan(back, dh, (*stacked, *res), reverse=True)
        (d_lookup,) = embed_vjp(dx0)
        head_grads = [loss, d_lookup.float(), d_table.float(), d_norm.float()]
        if mesh is not None and dp > 1:
            head_grads = psum_coalesced(head_grads, mesh, "dp")
        loss, d_lookup, d_table, d_norm = head_grads
        return (loss, d_lookup + d_table, d_norm, *layer_grads)

    def forward(self, *flat: torch.Tensor) -> tuple[torch.Tensor, ...]:
        loss, *grads = self.loss_and_grads(*flat)
        new = [(p.float() - self.lr * g).to(p.dtype)
               for p, g in zip(flat[:-2], grads)]
        return (loss, *new)

    def grads(self, *global_args: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``(loss, *grads)`` of the whole step over global arrays."""
        return run_ranks(self.loss_and_grads, self.mesh, *global_args,
                         in_specs=self.in_specs, out_specs=self.out_specs)


def build_llama_aot(preset: str = "7b", batch: int = 8, seq: int = 2048,
                    dp: int = 8, tp: int = 8, train: bool = True,
                    device=None, **overrides):
    """The reference's ``build_llama_aot``: the stacked step over seeded
    parameters and tokens (over meta tensors by default, nothing
    materialised).  ``overrides``: configuration fields, a build's cut to
    size."""
    if not train:
        raise ValueError("the scanned llama forward is not a registered "
                         "workload")
    cfg = config_for(preset, overrides)
    dev = resolve_device(device or "meta")
    params = init_stacked(cfg, dev)
    tokens, targets = _tokens(cfg, batch, seq, dev)
    mesh = Mesh((dp, tp), ("dp", "tp")) if dp * tp > 1 else None
    return LlamaAotTrainStep(cfg, mesh, batch), (*params, tokens, targets)


@register(
    "llama7b_aot_v5p64",
    description="Llama-2-7B pjit train step, AOT-captured on a dp8 x tp8 "
    "64-device mesh (BASELINE config #5; ShapeDtypeStruct args)",
    suite="models",
    num_devices=64,
    abstract=True,
    preset="7b", batch=8, seq=2048, dp=8, tp=8, train=True,
)
def build_llama7b_aot(device=None, **kw):
    return build_llama_aot(device=device, **kw)
