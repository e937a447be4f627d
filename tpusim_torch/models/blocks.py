"""What the port's decoders share: the profiler range names, RMSNorm, which
runs the RMSNorm kernel (the op ``tpusim_torch::rms_norm``) where
:func:`takes_norm_kernel` allows and the float32 chain everywhere else, the
rotary rotation, the causal mask, and the causal attention, which runs the
causal kernel (the op ``tpusim_torch::causal_attention``) where
:func:`takes_kernel` allows and the score chain everywhere else.

The Llama decoder (:mod:`tpusim_torch.models.llama`) and DeepSeek-V2's
(:mod:`tpusim_torch.models.deepseek_v2`) call :func:`causal_attention`;
the Llama train step keeps :func:`score_chain`'s residuals for its
hand-written backward.  Registers no workload.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from tpusim_torch.kernels import flash_attention as fa
from tpusim_torch.kernels import rms_norm as rn

__all__ = ["NORM_RANGE", "PROJ_RANGE", "ROPE_RANGE", "ATTENTION_RANGE",
           "MLP_RANGE", "HEAD_RANGE", "ROUTER_RANGE", "EXPERTS_RANGE",
           "takes_norm_kernel", "rotate", "causal_mask", "takes_kernel",
           "score_chain", "causal_attention"]

#: the decoders' profiler ranges (open only under a running profiler,
#: :func:`~tpusim_torch.obs.ranges.device_range`), named under the prefix
#: the benchmark reads: each RMSNorm; the q, k and v projections, and
#: apart the o projection with its residual add; the rotary tables and
#: rotations; the attention (the causal kernel, or the score chain from
#: the repeated keys and values to the PV product); the MLP with its
#: residual add; the output projection.  DeepSeek-V2's expert layer adds
#: the router (its product, softmax, top-k, the sort into expert order,
#: the read of the counts, the gather of the tokens and the weighted
#: combine back into token order) and every routed expert's gate, up,
#: SiLU, product and down.  The embedding lookup is in none.
NORM_RANGE = "tpusim_torch.llama.norm"
PROJ_RANGE = "tpusim_torch.llama.proj"
ROPE_RANGE = "tpusim_torch.llama.rope"
ATTENTION_RANGE = "tpusim_torch.llama.attention"
MLP_RANGE = "tpusim_torch.llama.mlp"
HEAD_RANGE = "tpusim_torch.llama.head"
ROUTER_RANGE = "tpusim_torch.llama.router"
EXPERTS_RANGE = "tpusim_torch.llama.experts"


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


#: the kernels as dispatched ops, ``tpusim_torch::causal_attention`` and
#: ``tpusim_torch::rms_norm``: a profiler links a launch to the op around
#: it (a ``record_function`` range gets no link), and its readers file each
#: kernel under its launching op.  Registered through the low-level
#: library, whose first call costs milliseconds where
#: ``torch.library.custom_op``'s cost seconds.  ``scale``: the softmax
#: scale, ``1 / sqrt(D)`` when None.
_LIB = torch.library.Library("tpusim_torch", "FRAGMENT")
_LIB.define("causal_attention(Tensor q, Tensor k, Tensor v, "
            "float? scale=None) -> Tensor")
_LIB.define("rms_norm(Tensor x, Tensor w, float eps) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl(
        "causal_attention",
        lambda q, k, v, scale=None: fa.causal_attention_fwd(q, k, v, scale),
        _key)
    _LIB.impl("rms_norm", lambda x, w, eps: rn.rms_norm_fwd(x, w, eps), _key)


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies where the kernels run."""
    return x.is_cuda


def _eager_on_card(*xs: torch.Tensor) -> bool:
    """Whether a call over ``xs`` may launch a kernel: no gradient is
    recorded and nothing traces the call (``torch.export``, ``make_fx``,
    dynamo: a captured graph holds the chains, which the simulator
    prices), and each is a real CUDA tensor, not a fake, functional or
    functorch-wrapped one."""
    if (torch.is_grad_enabled() or torch.compiler.is_compiling()
            or get_proxy_mode() is not None):
        return False
    return all(type(x) is torch.Tensor and _on_card(x) and not is_fake(x)
               and not torch._is_functional_tensor(x)
               and not torch._C._functorch.is_functorch_wrapped_tensor(x)
               for x in xs)


def takes_norm_kernel(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a forward's RMSNorm of ``x`` with weight ``w`` runs the
    RMSNorm kernel: :func:`_eager_on_card`, and the kernel takes their
    dtypes and width
    (:func:`~tpusim_torch.kernels.rms_norm.rms_norm_takes`).  A layout the
    kernel cannot read reaches it and raises there."""
    return _eager_on_card(x, w) and rn.rms_norm_takes(x, w)


def _rmsnorm(x, w, eps):
    """RMSNorm of ``x`` over its last dim with weight ``w``: the kernel
    where :func:`takes_norm_kernel` allows, else the chain
    (:func:`~tpusim_torch.kernels.rms_norm.rms_norm_reference`), whose
    roundings the kernel keeps."""
    if takes_norm_kernel(x, w):
        return torch.ops.tpusim_torch.rms_norm(x, w, eps)
    return rn.rms_norm_reference(x, w, eps)


def takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a forward's attention over ``q, k, v`` runs the causal
    kernel: :func:`_eager_on_card`, and the kernel is built for their
    dtype and head dims
    (:func:`~tpusim_torch.kernels.flash_attention.causal_kernel_takes`).
    A layout the kernel cannot read reaches it and raises there."""
    return _eager_on_card(q, k, v) and fa.causal_kernel_takes(q, k, v)


def score_chain(q, k, v, scale: float | None = None):
    """Causal attention over ``q`` [B, S, heads, D] and ``k`` [B, S, kv
    heads, D], ``v`` [B, S, kv heads, DV] as the reference writes it, and
    as a captured graph holds it: each key/value head repeated for its
    ``heads / kv heads`` query heads (``jnp.repeat`` over the head axis),
    the scores in the input dtype divided by ``sqrt(D)`` (multiplied by
    ``scale`` when given), masked, a float32 softmax rounded to the input
    dtype, and the product with v.  Returns the repeated keys and values,
    the probabilities and the output [B, S, heads, DV]."""
    s, rep = q.shape[1], q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    scores = (scores / (q.shape[-1] ** 0.5) if scale is None
              else scores * scale)
    scores = torch.where(causal_mask(s, q.device)[None, None], scores, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return k, v, probs, torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q, k, v, scale: float | None = None):
    """The attention output [B, S, heads, DV] of :func:`score_chain`: the
    causal kernel where :func:`takes_kernel` allows, else the chain."""
    if takes_kernel(q, k, v):
        return torch.ops.tpusim_torch.causal_attention(q, k, v, scale)
    return score_chain(q, k, v, scale)[-1]
