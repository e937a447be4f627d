"""Llama-2 decoder — port of ``llama_tiny`` and ``llama_tiny_tp2dp2``
from ``tpusim/models/llama.py``.

RMSNorm, rotary embeddings, causal attention, SwiGLU MLP and a final
projection tied to the embedding, as in the reference.  Arguments are the
reference's parameter pytree flattened in its leaf order (``embed``,
``final_norm``, then each layer's keys sorted: :data:`LAYER_KEYS`),
followed by ``tokens`` (and ``targets`` for a train step), so the
memcpy sizes and the trace's parameter order are the JAX capture's.

The train step on a ``(dp, tp)`` mesh is the per-device program GSPMD
makes of the reference's ``NamedSharding`` specs, written out with the
collectives of :mod:`tpusim_torch.spmd` (Megatron's f and g):

* the embedding is vocab-parallel: each rank gathers the rows of its
  vocab shard (``axis_index`` gives the shard's offset), zeroes the
  tokens outside it, and an all-reduce over ``tp`` sums the shards;
* the Q/K/V and gate/up projections are column-parallel behind
  :func:`~tpusim_torch.spmd.pvary`, the output and down
  projections row-parallel with an all-reduce over ``tp`` after them;
* the tied logits are vocab-parallel, and so is the token NLL: the max
  over the vocab, the sum of exponentials and the target's logit (a
  select over the shard's vocab, where the reference's
  ``take_along_axis`` gathers) are each all-reduced over ``tp``;
* the loss and the gradients, in float32, are all-reduced over ``dp`` in
  one tuple all-reduce.

So the program holds the fixture's 14 all-reduces: 8 in the forward, 5
in the backward (the f of each column-parallel input and of the logits)
and the one over ``dp``.

Every dot is the one in the JAX capture's per-device program
(``tests/fixtures/traces/llama_tiny_tp2dp2``), so the simulated MXU flops
are the same.
"""

from __future__ import annotations

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
    pvary,
    run_ranks,
)

__all__ = ["LlamaConfig", "PRESETS", "LAYER_KEYS", "LlamaForward",
           "LlamaTrainStep", "params_from_numpy", "init_params"]


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
    """Seeded random parameters: N(0, 0.02) weights, unit norms."""
    dt = torch_dtype(cfg.dtype)
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


def _rope(q, k, theta):
    seq, d = q.shape[1], q.shape[-1]
    pos = torch.arange(seq, dtype=torch.float32, device=q.device)
    freqs = torch.pow(theta, -torch.arange(0, d, 2, dtype=torch.float32,
                                           device=q.device) / d)
    angles = pos[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]

    def rot(x):
        x1, x2 = torch.split(x.float(), d // 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


class _Decoder:
    """One rank's decoder over a ``(dp, tp)`` mesh, or the single-chip
    decoder (``mesh`` None)."""

    def __init__(self, cfg: LlamaConfig, mesh: Mesh | None):
        if cfg.kv_heads != cfg.heads:
            raise ValueError("grouped-query attention (kv_heads != heads) "
                             "is not ported")
        self.cfg, self.mesh = cfg, mesh
        self.tp = mesh.shape[mesh.names.index("tp")] if mesh else 1

    def psum_tp(self, x):
        return psum(x, self.mesh, "tp") if self.tp > 1 else x

    def pvary_tp(self, x):
        return pvary(x, self.mesh, "tp") if self.tp > 1 else x

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

    def attention(self, x, layer):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        h = self.pvary_tp(x)
        heads = cfg.heads // self.tp
        q = (h @ layer["wq"]).reshape(b, s, heads, hd)
        k = (h @ layer["wk"]).reshape(b, s, heads, hd)
        v = (h @ layer["wv"]).reshape(b, s, heads, hd)
        q, k = _rope(q, k, cfg.rope_theta)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
        idx = torch.arange(s, dtype=torch.int32, device=x.device)
        mask = idx[:, None] >= idx[None, :]
        scores = torch.where(mask[None, None], scores, -1e30)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            b, s, heads * hd)
        return self.psum_tp(out @ layer["wo"])

    def mlp(self, x, layer):
        h = self.pvary_tp(x)
        g = h @ layer["w_gate"]
        gate = g * torch.sigmoid(g)         # jax.nn.silu
        return self.psum_tp((gate * (h @ layer["w_up"])) @ layer["w_down"])

    def logits(self, params, tokens):
        """``(logits of the rank's vocab shard, vocab offset)``."""
        embed, final_norm, layers = _unflatten(params)
        eps = self.cfg.eps
        offset = self.vocab_offset(embed, tokens)
        x = self.embed(embed, tokens, offset)
        for layer in layers:
            x = x + self.attention(_rmsnorm(x, layer["attn_norm"], eps),
                                   layer)
            x = x + self.mlp(_rmsnorm(x, layer["mlp_norm"], eps), layer)
        x = self.pvary_tp(_rmsnorm(x, final_norm, eps))
        return x @ embed.T, offset

    def nll_sum(self, params, tokens, targets):
        """Σ −log p(target) over the rank's tokens, over the vocab shards:
        ``log Σ exp(z) − z[target]`` with ``z`` the logits less their
        max, the sum and the picked ``z`` each all-reduced over ``tp``.
        Written so, every value the shards share is only read by
        replicated ops, and its gradient needs no collective."""
        logits, offset = self.logits(params, tokens)
        logits = logits.float()
        m = logits.detach().amax(dim=-1)
        if self.tp > 1:
            m = pmax(m, self.mesh, "tp")
        z = logits - m[..., None]
        s = self.psum_tp(torch.exp(z).sum(dim=-1))
        local = targets if offset is None else targets - offset
        vocab = torch.arange(logits.shape[-1], dtype=torch.int32,
                             device=logits.device)
        picked = torch.where(vocab == local[..., None], z, 0.0).sum(-1)
        return (torch.log(s) - self.psum_tp(picked)).sum()


class LlamaForward(nn.Module):
    """``llama_forward``: ``(*params, tokens) -> logits [B, S, vocab]``,
    single chip."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, *flat: torch.Tensor) -> torch.Tensor:
        logits, _ = _Decoder(self.cfg, None).logits(flat[:-1], flat[-1])
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

        def loss_fn(ps):
            return decoder.nll_sum(ps, tokens, targets) / count

        grads, loss = torch.func.grad_and_value(loss_fn)(params)
        grads = [g.float() for g in grads]
        dp = self.mesh.shape[self.mesh.names.index("dp")]
        if self._spmd is not None and dp > 1:
            # one all-reduce of the loss and the float32 gradients (the
            # update reads them in float32), as the JAX capture's combiner
            # makes it
            loss, *grads = psum_coalesced([loss, *grads], self.mesh, "dp")
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
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           dtype=torch.int32).to(dev)
    return tokens, torch.roll(tokens, -1, dims=1)


def build_llama(preset: str = "tiny", batch: int = 8, seq: int | None = None,
                dp: int = 1, tp: int = 1, train: bool = True, device=None):
    """The reference's ``build_llama_sharded``: seeded random parameters
    (N(0, 0.02) weights) and tokens; the module and its global
    arguments."""
    cfg = PRESETS[preset]
    seq = seq or min(cfg.max_seq, 512)
    dev = resolve_device(device)
    params = init_params(cfg, dev)
    tokens, targets = _tokens(cfg, batch, seq, dev)
    if not train:
        if dp * tp != 1:
            raise ValueError("the sharded llama forward is not ported")
        return LlamaForward(cfg), (*params, tokens)
    mesh = Mesh((dp, tp), ("dp", "tp")) if dp * tp > 1 else None
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
