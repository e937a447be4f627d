"""Llama-2 decoder — port of ``llama_tiny``, ``llama_tiny_train``,
``llama_tiny_tp2dp2``, ``llama7b`` and ``llama7b_tp8dp8`` from
``tpusim/models/llama.py``.

RMSNorm, rotary embeddings, causal attention, SwiGLU MLP and a final
projection tied to the embedding, as in the reference.  Arguments are the
reference's parameter pytree flattened in its leaf order (``embed``,
``final_norm``, then each layer's keys sorted: :data:`LAYER_KEYS`),
followed by ``tokens`` (and ``targets`` for a train step), so the
memcpy sizes and the trace's parameter order are the JAX capture's.

The train step on a ``(dp, tp)`` mesh is the per-device program GSPMD
makes of the reference's ``NamedSharding`` specs, written out with the
collectives of :mod:`tpusim_torch.spmd` (Megatron's f and g), and with
the all-reduces of the JAX capture's CPU-mesh trace:

* the embedding is vocab-parallel: each rank gathers the rows of its
  vocab shard (``axis_index`` gives the shard's offset), zeroes the
  tokens outside it, and an all-reduce over ``tp`` sums the shards;
* the Q/K/V and gate/up projections are column-parallel, each behind its
  own :func:`~tpusim_torch.spmd.pvary` (one tuple all-reduce per group
  in the backward: XLA keeps the partial input gradients apart), the
  output and down projections row-parallel with an all-reduce over
  ``tp`` after them;
* the tied logits are vocab-parallel, and so is ``log_softmax``: the max
  over the vocab and the sum of exponentials are each all-reduced over
  ``tp``, and the target's log-probability (a select over the shard's
  vocab, where the reference's ``take_along_axis`` gathers) is
  all-reduced in one tuple with the backward's sum of the
  ``log_softmax`` cotangent, as XLA's combiner pairs them: the NLL's
  gradient is written out (``log_softmax``'s backward), and the decoder's
  taken with ``torch.func.vjp``;
* the loss and the gradients, in float32, are all-reduced over ``dp`` in
  one tuple all-reduce, the tied embedding's two gradient parts (the
  lookup's and the logits') apart, as in the JAX capture.

So ``llama_tiny_tp2dp2`` holds the fixture's 14 all-reduces: 7 in the
forward, 6 in the backward (the f of each column-parallel group and of
the logits, and the ``log_softmax`` tuple) and the one over ``dp``.

Every dot is the one in the JAX capture's per-device program
(``tests/fixtures/traces/llama_tiny_tp2dp2``), so the simulated MXU flops
are the same.

``llama7b_tp8dp8`` is captured over abstract (``meta``) tensors: one
rank's program of the 64-device step, with nothing materialised.  The
reference materialises it on 64 chips; the port's rank runner would hold
all 64 ranks on one card, far past its memory, so its numerics are held
at a small configuration (the build overrides of
:data:`CONFIG_OVERRIDES`) and its registered width is only captured.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpusim_torch.models.registry import (
    register,
    resolve_device,
    tensor_from_numpy,
    torch_dtype,
)
from tpusim_torch.spmd import (
    Mesh,
    P,
    SpmdModule,
    axis_index,
    pmax,
    psum,
    psum_coalesced,
    psum_plain,
    pvary,
    pvary_coalesced,
    run_ranks,
)

__all__ = ["LlamaConfig", "PRESETS", "LAYER_KEYS", "LlamaForward",
           "LlamaForwardSharded", "LlamaTrainStep", "params_from_numpy",
           "init_params", "build_llama"]


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    ffn: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


PRESETS: dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(vocab=512, dim=128, layers=2, heads=4, kv_heads=4,
                        ffn=352, max_seq=256),
    "1b": LlamaConfig(vocab=32000, dim=2048, layers=16, heads=16,
                      kv_heads=16, ffn=5504, max_seq=2048),
    "7b": LlamaConfig(),
}

#: a layer's parameters in the reference pytree's leaf order (sorted keys)
LAYER_KEYS = ("attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk",
              "wo", "wq", "wv")

#: the partition spec of each layer parameter on a (dp, tp) mesh — the
#: reference's ``param_shardings``
_LAYER_SPECS = {
    "attn_norm": P(), "mlp_norm": P(),
    "wq": P(None, "tp"), "wk": P(None, "tp"), "wv": P(None, "tp"),
    "wo": P("tp", None),
    "w_gate": P(None, "tp"), "w_up": P(None, "tp"),
    "w_down": P("tp", None),
}


def _shapes(cfg: LlamaConfig) -> list[tuple[int, ...]]:
    kv = cfg.kv_heads * cfg.head_dim
    layer = {
        "attn_norm": (cfg.dim,), "mlp_norm": (cfg.dim,),
        "wq": (cfg.dim, cfg.dim), "wk": (cfg.dim, kv), "wv": (cfg.dim, kv),
        "wo": (cfg.dim, cfg.dim), "w_gate": (cfg.dim, cfg.ffn),
        "w_up": (cfg.dim, cfg.ffn), "w_down": (cfg.ffn, cfg.dim),
    }
    out = [(cfg.vocab, cfg.dim), (cfg.dim,)]
    for _ in range(cfg.layers):
        out += [layer[k] for k in LAYER_KEYS]
    return out


def param_specs(cfg: LlamaConfig) -> tuple:
    """Partition specs of the flat parameters (``embed`` vocab-sharded)."""
    return (P("tp", None), P()) + tuple(
        _LAYER_SPECS[k] for _ in range(cfg.layers) for k in LAYER_KEYS)


def params_from_numpy(tree: dict, *, device=None) -> tuple[torch.Tensor, ...]:
    """The flat parameters from the reference's pytree of numpy arrays
    (``{"embed", "final_norm", "layers": [{...}, ...]}``)."""
    dev = resolve_device(device)
    flat = [tree["embed"], tree["final_norm"]]
    for layer in tree["layers"]:
        flat += [layer[k] for k in LAYER_KEYS]
    return tuple(tensor_from_numpy(a, dev) for a in flat)


def init_params(cfg: LlamaConfig, device, seed: int = 0
                ) -> tuple[torch.Tensor, ...]:
    """Seeded random parameters: N(0, 0.02) weights, unit norms (on a
    ``meta`` device, their shapes and dtypes only)."""
    dt = torch_dtype(cfg.dtype)
    if torch.device(device).type == "meta":
        return tuple(torch.empty(shape, dtype=dt, device=device)
                     for shape in _shapes(cfg))
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in _shapes(cfg):
        if len(shape) == 1:
            out.append(torch.ones(shape, dtype=dt, device=device))
        else:
            out.append(torch.randn(shape, generator=gen, device=device,
                                   dtype=dt) * 0.02)
    return tuple(out)


def _unflatten(params: Sequence[torch.Tensor]) -> tuple[Any, Any, list]:
    n = len(LAYER_KEYS)
    layers = [dict(zip(LAYER_KEYS, params[2 + i:2 + i + n]))
              for i in range(0, len(params) - 2, n)]
    return params[0], params[1], layers


# ---------------------------------------------------------------------------
# The decoder, for one rank (tp = 1: the single-chip program)
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpusim_torch::scatter_add_rows", mutates_args=())
def _scatter_add_rows(grad: torch.Tensor, ids: torch.Tensor,
                      rows: int) -> torch.Tensor:
    out = grad.new_zeros((rows, grad.shape[-1]))
    return out.index_add(0, ids.reshape(-1).long(),
                         grad.reshape(-1, grad.shape[-1]))


@_scatter_add_rows.register_fake
def _(grad, ids, rows):
    return grad.new_empty((rows, grad.shape[-1]))


def _scatter_add_rows_vmap(info, in_dims, grad, ids, rows):
    n = info.batch_size
    g = (grad.movedim(in_dims[0], 0) if in_dims[0] is not None
         else grad.expand(n, *grad.shape))
    i = (ids.movedim(in_dims[1], 0) if in_dims[1] is not None
         else ids.expand(n, *ids.shape))
    d = g.shape[-1]
    flat = (i.reshape(n, -1).long()
            + rows * torch.arange(n, device=i.device)[:, None]).reshape(-1)
    out = g.new_zeros((n * rows, d)).index_add(0, flat, g.reshape(-1, d))
    return out.reshape(n, rows, d), 0


torch.library.register_vmap(_scatter_add_rows, _scatter_add_rows_vmap)


class _ScatterAddRows(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(grad, ids, rows):
        return _scatter_add_rows(grad, ids, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _TakeRows.apply(g, ids), None, None


class _TakeRows(torch.autograd.Function):
    """``table[ids]`` whose gradient is one ``scatter`` with an add region
    into the table's rows (the JAX capture's scatter-add), over the int32
    ids; torch's own embedding backward widens them to int64."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, ids):
        return F.embedding(ids, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.rows = inputs[0].shape[0]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _ScatterAddRows.apply(g, ids, ctx.rows), None


def _rmsnorm(x, w, eps):
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * w


def rope_tables(seq: int, d: int, theta: float, device):
    """The rotary ``cos`` and ``sin`` tables, ``[1, seq, 1, d / 2]``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.pow(theta, -torch.arange(0, d, 2, dtype=torch.float32,
                                           device=device) / d)
    angles = pos[:, None] * freqs[None, :]
    return (torch.cos(angles)[None, :, None, :],
            torch.sin(angles)[None, :, None, :])


def rotate(x, cos, sin, inverse: bool = False):
    """The rotary rotation of ``x`` [B, S, H, D] (its transpose when
    ``inverse``), in float32, back in ``x``'s dtype."""
    d = x.shape[-1] // 2
    x1, x2 = torch.split(x.float(), d, dim=-1)
    s = -sin if inverse else sin
    return torch.cat([x1 * cos - x2 * s, x2 * cos + x1 * s],
                     dim=-1).to(x.dtype)


def causal_mask(s: int, device) -> torch.Tensor:
    idx = torch.arange(s, dtype=torch.int32, device=device)
    return idx[:, None] >= idx[None, :]


class _Decoder:
    """One rank's decoder over a ``(dp, tp)`` mesh, or the single-chip
    decoder (``mesh`` None)."""

    def __init__(self, cfg: LlamaConfig, mesh: Mesh | None):
        self.cfg, self.mesh = cfg, mesh
        self.tp = mesh.shape[mesh.names.index("tp")] if mesh else 1
        # grouped-query attention: each key/value head serves ``rep``
        # query heads (``jnp.repeat`` over the head axis, the reference's
        # ``_attention``); a tp rank holds whole key/value heads
        if cfg.heads % cfg.kv_heads:
            raise ValueError(f"heads ({cfg.heads}) is not a multiple of "
                             f"kv_heads ({cfg.kv_heads})")
        if cfg.kv_heads % self.tp:
            raise ValueError(f"the tp mesh axis ({self.tp}) does not "
                             f"divide kv_heads ({cfg.kv_heads})")
        self.rep = cfg.heads // cfg.kv_heads

    def repeat_kv(self, x):
        """``x`` [B, S, kv heads, D] with each head repeated ``rep`` times
        in place (``jnp.repeat(x, rep, axis=2)``)."""
        return x if self.rep == 1 else torch.repeat_interleave(
            x, self.rep, dim=2)

    def psum_tp(self, x):
        return psum(x, self.mesh, "tp") if self.tp > 1 else x

    def psum_tp_plain(self, x):
        return psum_plain([x], self.mesh, "tp")[0] if self.tp > 1 else x

    def pvary_tp(self, x):
        return pvary(x, self.mesh, "tp") if self.tp > 1 else x

    def pvary_tp_each(self, x, n: int) -> tuple:
        """``n`` uses of a replicated ``x`` by rank-varying ops, their
        partial cotangents all-reduced in one tuple."""
        if self.tp == 1:
            return (x,) * n
        return pvary_coalesced([x] * n, self.mesh, "tp")

    def vocab_offset(self, embed, tokens):
        if self.tp == 1:
            return None
        return axis_index(tokens, self.mesh, "tp") * embed.shape[0]

    def embed(self, embed, tokens, offset):
        if offset is None:
            return _TakeRows.apply(embed, tokens)
        ids = tokens - offset
        valid = (ids >= 0) & (ids < embed.shape[0])
        rows = _TakeRows.apply(embed, torch.where(valid, ids, 0))
        return self.psum_tp(torch.where(valid[..., None], rows, 0.0))

    def psum_tp_sum(self, xs):
        """The bare tuple all-reduce of column-parallel partial input
        gradients (one per projection), summed: a hand-written
        backward's."""
        if self.tp > 1:
            xs = psum_plain(xs, self.mesh, "tp")
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return total

    def layer(self, h, w: dict, plain: bool = False):
        """One decoder layer, ``h + attention(norm(h))`` then ``+
        mlp(norm(...))``: the next ``h`` and the residuals a hand-written
        backward reads (the rotated queries and keys, the values, the
        attention probabilities and output, the stream after attention,
        the MLP's gate and up projections).  ``plain``: the bare
        collectives and no ``pvary``, for a scan body, which nothing
        differentiates through."""
        cfg = self.cfg
        b, s, _ = h.shape
        hd, heads = cfg.head_dim, cfg.heads // self.tp
        psum_tp = self.psum_tp_plain if plain else self.psum_tp
        a = _rmsnorm(h, w["attn_norm"], cfg.eps)
        hq, hk, hv = (a,) * 3 if plain else self.pvary_tp_each(a, 3)
        kv_heads = heads // self.rep
        q = (hq @ w["wq"]).reshape(b, s, heads, hd)
        k = (hk @ w["wk"]).reshape(b, s, kv_heads, hd)
        v = (hv @ w["wv"]).reshape(b, s, kv_heads, hd)
        cos, sin = rope_tables(s, hd, cfg.rope_theta, h.device)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        k, v = self.repeat_kv(k), self.repeat_kv(v)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
        scores = torch.where(causal_mask(s, h.device)[None, None], scores,
                             -1e30)
        probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            b, s, heads * hd)
        h1 = h + psum_tp(o @ w["wo"])
        m = _rmsnorm(h1, w["mlp_norm"], cfg.eps)
        hg, hu = (m, m) if plain else self.pvary_tp_each(m, 2)
        g = hg @ w["w_gate"]
        gate = g * torch.sigmoid(g)         # jax.nn.silu
        u = hu @ w["w_up"]
        h2 = h1 + psum_tp((gate * u) @ w["w_down"])
        return h2, (q, k, v, probs, o, h1, g, u)

    def logits(self, params, tokens, out_embed=None):
        """``(logits of the rank's vocab shard, vocab offset)``;
        ``out_embed``: the tied projection's table, when it is taken apart
        from the lookup's (for its gradient part)."""
        embed, final_norm, layers = _unflatten(params)
        eps = self.cfg.eps
        offset = self.vocab_offset(embed, tokens)
        x = self.embed(embed, tokens, offset)
        for layer in layers:
            x, _ = self.layer(x, layer)
        x = self.pvary_tp(_rmsnorm(x, final_norm, eps))
        table = embed if out_embed is None else out_embed
        return x @ table.T, offset

    def nll(self, logits, offset, targets, count: int):
        """The mean token NLL over ``count`` tokens and its cotangent of
        the rank's logits: ``log_softmax`` over the vocab shards (the
        max, its gradient stopped as ``jax.nn.log_softmax`` does, and the
        sum of exponentials each all-reduced over ``tp``), the target's
        log-probability picked by a select and all-reduced with the
        backward's sum of the ``log_softmax`` cotangent in one tuple."""
        logits = logits.float()
        m = logits.amax(dim=-1)
        if self.tp > 1:
            m = pmax(m, self.mesh, "tp")
        z = logits - m[..., None]
        lse = torch.log(self.psum_tp(torch.exp(z).sum(dim=-1)))
        logp = z - lse[..., None]
        local = targets if offset is None else targets - offset
        vocab = torch.arange(logits.shape[-1], dtype=torch.int32,
                             device=logits.device)
        onehot = vocab == local[..., None]
        picked = torch.where(onehot, logp, 0.0).sum(-1, keepdim=True)
        d_logp = torch.where(onehot, -1.0 / count, 0.0)
        d_sum = d_logp.sum(-1)
        if self.tp > 1:
            picked, d_sum = psum_coalesced([picked, d_sum], self.mesh, "tp")
        d_z = d_logp - torch.exp(logp) * d_sum[..., None]
        return -picked.sum() / count, d_z


class LlamaForward(nn.Module):
    """``llama_forward``: ``(*params, tokens) -> logits [B, S, vocab]``,
    single chip."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, *flat: torch.Tensor) -> torch.Tensor:
        logits, _ = _Decoder(self.cfg, None).logits(flat[:-1], flat[-1])
        return logits


class LlamaForwardSharded(SpmdModule):
    """The reference's forward on a ``(dp, tp)`` mesh: ``(*params,
    tokens) -> logits``, each rank's the vocab shard of its batch shard
    (the tied projection is vocab-parallel)."""

    def __init__(self, cfg: LlamaConfig, mesh: Mesh):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.in_specs = param_specs(cfg) + (P("dp"),)
        self.out_specs = P("dp", None, "tp")

    def forward(self, *flat: torch.Tensor) -> torch.Tensor:
        logits, _ = _Decoder(self.cfg, self.mesh).logits(flat[:-1], flat[-1])
        return logits


class LlamaTrainStep(SpmdModule):
    """The reference's ``make_llama_train_step``: ``(*params, tokens,
    targets) -> (loss, *params')``, one SGD step on the mean token NLL.

    With a ``(dp, tp)`` mesh, ``forward`` is one rank's program over its
    shards and :meth:`run` the whole step; with ``mesh=None`` it is the
    single-chip step over the whole batch."""

    #: capture traces the step with ``make_fx`` (torch.export does not
    #: take a gradient)
    train_step = True

    def __init__(self, cfg: LlamaConfig, mesh: Mesh | None, batch: int,
                 lr: float = 3e-4):
        super().__init__()
        self.cfg, self.lr, self.batch = cfg, lr, batch
        self.mesh = mesh or Mesh((1, 1), ("dp", "tp"))
        self._spmd = mesh
        data = P("dp")
        self.in_specs = param_specs(cfg) + (data, data)
        self.out_specs = (P(),) + param_specs(cfg)

    def loss_and_grads(self, *flat: torch.Tensor
                       ) -> tuple[torch.Tensor, ...]:
        """One rank's ``(loss, *grads)``: the mean token NLL over the
        global batch and its float32 gradients, all-reduced over ``dp`` —
        what the update reads."""
        params, tokens, targets = tuple(flat[:-2]), flat[-2], flat[-1]
        decoder = _Decoder(self.cfg, self._spmd)
        # the mean over the global batch: each dp rank's share
        count = self.batch * tokens.shape[1]

        def logits_fn(*ps):
            # the tied table twice: the lookup's and the projection's
            # gradient parts come apart
            return decoder.logits(ps[:-1], tokens, out_embed=ps[-1])[0]

        logits, vjp_fn = torch.func.vjp(logits_fn, *params, params[0])
        offset = decoder.vocab_offset(params[0], tokens)
        loss, d_logits = decoder.nll(logits, offset, targets, count)
        grads = [g.float() for g in vjp_fn(d_logits.to(logits.dtype))]
        dp = self.mesh.shape[self.mesh.names.index("dp")]
        if self._spmd is not None and dp > 1:
            # one all-reduce of the loss and the float32 gradients (the
            # update reads them in float32), as the JAX capture's combiner
            # makes it
            loss, *grads = psum_coalesced([loss, *grads], self.mesh, "dp")
        grads[0] = grads[0] + grads.pop()
        return (loss, *grads)

    def forward(self, *flat: torch.Tensor) -> tuple[torch.Tensor, ...]:
        loss, *grads = self.loss_and_grads(*flat)
        new = [(p.float() - self.lr * g).to(p.dtype)
               for p, g in zip(flat[:-2], grads)]
        return (loss, *new)

    def grads(self, *global_args: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``(loss, *grads)`` of the whole step over global arrays, each
        gradient float32 and laid out as its parameter: what
        :meth:`run` updates the parameters with."""
        return run_ranks(self.loss_and_grads, self.mesh, *global_args,
                         in_specs=self.in_specs, out_specs=self.out_specs)


def _tokens(cfg: LlamaConfig, batch: int, seq: int, dev, seed: int = 0):
    if dev.type == "meta":
        tokens = torch.empty((batch, seq), dtype=torch.int32, device=dev)
        return tokens, torch.empty_like(tokens)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           dtype=torch.int32).to(dev)
    return tokens, torch.roll(tokens, -1, dims=1)


#: the configuration fields a build may override (cut to size)
CONFIG_OVERRIDES = ("vocab", "dim", "layers", "heads", "kv_heads", "ffn",
                    "dtype")


def config_for(preset: str, overrides: dict) -> LlamaConfig:
    """A preset with a build's configuration overrides (its cut to
    size, :data:`CONFIG_OVERRIDES`)."""
    bad = sorted(set(overrides) - set(CONFIG_OVERRIDES))
    if bad:
        raise ValueError(f"llama build overrides {bad} are not configuration "
                         f"fields ({', '.join(CONFIG_OVERRIDES)})")
    return dataclasses.replace(PRESETS[preset], **overrides)


def build_llama(preset: str = "tiny", batch: int = 8, seq: int | None = None,
                dp: int = 1, tp: int = 1, train: bool = True, device=None,
                **overrides):
    """The reference's ``build_llama_sharded``: seeded random parameters
    (N(0, 0.02) weights) and tokens; the module and its global
    arguments.  ``overrides``: configuration fields of the preset
    (:data:`CONFIG_OVERRIDES`), a build's cut to size, not registered
    parameters."""
    cfg = config_for(preset, overrides)
    seq = seq or min(cfg.max_seq, 512)
    dev = resolve_device(device)
    params = init_params(cfg, dev)
    tokens, targets = _tokens(cfg, batch, seq, dev)
    mesh = Mesh((dp, tp), ("dp", "tp")) if dp * tp > 1 else None
    if not train:
        if mesh is None:
            return LlamaForward(cfg), (*params, tokens)
        return LlamaForwardSharded(cfg, mesh), (*params, tokens)
    return LlamaTrainStep(cfg, mesh, batch), (*params, tokens, targets)


@register(
    "llama_tiny",
    description="tiny Llama decoder fwd (tests/CI)",
    suite="models",
    preset="tiny", batch=4, train=False,
)
def build_llama_tiny(device=None, **kw):
    return build_llama(device=device, **kw)


@register(
    "llama_tiny_tp2dp2",
    description="tiny Llama train step on a 2x2 dp/tp mesh",
    suite="models",
    num_devices=4,
    preset="tiny", batch=8, dp=2, tp=2, train=True,
)
def build_llama_tiny_sharded(device=None, **kw):
    return build_llama(device=device, **kw)


@register(
    "llama_tiny_train",
    description="multi-layer tiny Llama train step, single chip — the "
    "held-out full-model silicon workload (VERDICT r4 #2: the refiner "
    "never trains on it)",
    suite="models",
    preset="tiny", batch=4, dp=1, tp=1, train=True,
)
def build_llama_tiny_train(device=None, **kw):
    return build_llama(device=device, **kw)


@register(
    "llama7b",
    description="Llama-2-7B fwd, single chip (memory permitting)",
    suite="models",
    preset="7b", batch=1, seq=2048, train=False,
)
def build_llama7b(device=None, **kw):
    # 6.61e9 parameters (the output tied to the embedding), 13.2 GB in
    # bfloat16: one H100 holds the whole forward at batch 1, seq 2048
    return build_llama(device=device, **kw)


@register(
    "llama7b_tp8dp8",
    description="Llama-2-7B pjit train step on dp8 x tp8 (v5p-64, "
    "BASELINE config #5)",
    suite="models",
    num_devices=64,
    abstract=True,
    preset="7b", batch=64, seq=2048, dp=8, tp=8, train=True,
)
def build_llama7b_sharded(device=None, **kw):
    """Abstract by default (``meta``): the reference materialises this
    step on 64 chips, the port captures one rank's program of it over
    meta tensors (module docstring)."""
    return build_llama(device=device or "meta", **kw)
