"""ResNet-50 — port of ``resnet50``, ``resnet50_train`` and
``resnet50_dp8`` from ``tpusim/models/resnet.py``.

The reference's network, parameter names and shapes: a 7×7/2 stem, a
3×3/2 max pool, four bottleneck stages [3, 4, 6, 3], batch-norm in
training mode (batch statistics, ``rsqrt`` of the variance in float32),
global average pooling and a dense head; the train step is SGD with
momentum 0.9 and lr 0.1 on the mean token NLL of ``log_softmax``.

Activations run NCHW inside the module; the input stays the reference's
NHWC and the kernels its HWIO, each reaching ``F.conv2d`` through a
``permute`` the lowering folds into the convolution's ``dim_labels``, so
every convolution is the one in the JAX capture.  JAX's ``padding=
"SAME"`` is asymmetric at stride 2 (the stem on 224 pads ``2_3``, a 3×3/2
conv on 56 pads ``0_1``, the max pool on 112 pads ``0_1`` with −inf);
torch pads only symmetrically, so those go through ``F.pad``, which the
lowering folds into the window's ``pad`` as XLA does.

Arguments are the reference pytree's leaves in its order (the parameter
dict by sorted key, then the velocity dict for a train step, the image
batch and the int32 labels).

``resnet50_dp8`` is the per-device program GSPMD makes of the
reference's batch sharded over ``dp``: each batch-norm's statistics are
those of the global batch.  The all-reduces are the JAX capture's, read
off its CPU-mesh trace:

* forward, per batch-norm: the sum for the mean, then the sum of
  squared deviations beside a second sum of the input (``jnp.var``
  takes its own mean) in one tuple;
* backward, per batch-norm: the partial cotangents of the mean and of
  the ``scale * rsqrt(var + eps)`` factor in one tuple (the scale's
  gradient follows from the second without another), then that of the
  variance's own mean;
* in each stage's first block the projection's and the first
  convolution's batch-norms share an all-reduce each way: in the forward
  the projection's tuple takes the first convolution's sum, in the
  backward the first convolution's variance-mean cotangent joins the
  projection's tuple;
* the loss and every other gradient (convolutions, head, batch-norm
  biases) in float32 tuples, as XLA:CPU's combiner makes them: a first
  block's projection bias and last bias take the same gradient (the
  block output's cotangent, summed), one value after XLA's CSE, which the
  combiner puts once in the main tuple for stages 2-4 and, for the first
  stage, in a tuple of its own beside it.

XLA:CPU's combiner splits no tuple by bytes (one tuple past 432 MiB,
``tests/test_torch_resnet_dp8.py``), so this grouping, read at test
shapes, is the one at registered width, where the main tuple holds
~102 MB of float32 gradients.
"""

from __future__ import annotations

import math
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
    psum,
    psum_coalesced,
    pvary,
    pvary_coalesced,
    run_ranks,
)

__all__ = ["STAGE_BLOCKS", "STAGE_FILTERS", "param_shapes", "param_names",
           "init_params", "params_from_numpy", "ResNet50", "ResNet50Train"]

STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_FILTERS = (64, 128, 256, 512)
EXPANSION = 4
EPS = 1e-5


def param_shapes(num_classes: int) -> dict[str, tuple[int, ...]]:
    """The reference's parameters by name, in its construction order."""
    shapes: dict[str, tuple[int, ...]] = {
        "stem_conv": (7, 7, 3, 64), "stem_scale": (64,), "stem_bias": (64,)}
    cin = 64
    for stage, (blocks, filters) in enumerate(zip(STAGE_BLOCKS,
                                                  STAGE_FILTERS)):
        cout = filters * EXPANSION
        for block in range(blocks):
            prefix = f"s{stage}b{block}"
            shapes[f"{prefix}_c1"] = (1, 1, cin, filters)
            shapes[f"{prefix}_c2"] = (3, 3, filters, filters)
            shapes[f"{prefix}_c3"] = (1, 1, filters, cout)
            for i in (1, 2, 3):
                ch = filters if i < 3 else cout
                shapes[f"{prefix}_scale{i}"] = (ch,)
                shapes[f"{prefix}_bias{i}"] = (ch,)
            if block == 0:
                shapes[f"{prefix}_proj"] = (1, 1, cin, cout)
                shapes[f"{prefix}_proj_scale"] = (cout,)
                shapes[f"{prefix}_proj_bias"] = (cout,)
            cin = cout
    shapes["head_w"] = (cin, num_classes)
    shapes["head_b"] = (num_classes,)
    return shapes


def param_names(num_classes: int = 1000) -> list[str]:
    """The parameters in the reference pytree's leaf order (sorted)."""
    return sorted(param_shapes(num_classes))


def init_params(num_classes: int, dtype: torch.dtype, device,
                seed: int = 0) -> tuple[torch.Tensor, ...]:
    """Seeded parameters in leaf order: He-normal kernels and head, unit
    scales, zero biases (the reference's init, from a torch generator)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = param_shapes(num_classes)
    out = {}
    for name, shape in shapes.items():
        if "scale" in name:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif "bias" in name or name == "head_b":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            fan_in = math.prod(shape[:-1])
            out[name] = torch.randn(shape, generator=gen, device=device,
                                    dtype=dtype) * (2.0 / fan_in) ** 0.5
    return tuple(out[n] for n in sorted(out))


def params_from_numpy(tree: dict, *, device=None) -> tuple[torch.Tensor, ...]:
    """The flat parameters from the reference's dict of numpy arrays."""
    dev = resolve_device(device)
    return tuple(tensor_from_numpy(tree[k], dev) for k in sorted(tree))


# ---------------------------------------------------------------------------
# Layers (NCHW)
# ---------------------------------------------------------------------------


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    """JAX's ``padding="SAME"`` along one dim: ``(lo, hi)``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(h: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``conv_general_dilated(h, w, stride, "SAME")`` with an HWIO
    kernel."""
    (lh, hh), (lw, hw) = (_same(h.shape[2], w.shape[0], stride),
                          _same(h.shape[3], w.shape[1], stride))
    wt = w.permute(3, 2, 0, 1)
    if (lh, lw) == (hh, hw):
        return F.conv2d(h, wt, stride=stride, padding=(lh, lw))
    return F.conv2d(F.pad(h, (lw, hw, lh, hh)), wt, stride=stride)


def _max_pool(h: torch.Tensor) -> torch.Tensor:
    """``reduce_window(max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME")``."""
    (lh, hh), (lw, hw) = _same(h.shape[2], 3, 2), _same(h.shape[3], 3, 2)
    return F.max_pool2d(F.pad(h, (lw, hw, lh, hh), value=float("-inf")),
                        3, 2)


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


_DIMS = (0, 2, 3)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype statistics are computed in: float32, or float64
    for a float64 run (the CPU tests hold the sharded step to the
    unsharded one there)."""
    return t if t.dtype == torch.float64 else t.float()


def _affine(x, mean, inv, bias) -> torch.Tensor:
    return (x - _chan(mean)) * _chan(inv) + _chan(bias)


class _BatchNorm:
    """One training-mode batch-norm: the single-chip form, or the
    data-parallel form in phases whose all-reduces a caller may merge
    with another batch-norm's (:class:`ResNet50Train`)."""

    def __init__(self, x: torch.Tensor, scale, bias, mesh: Mesh | None,
                 count: int):
        self.x, self.scale, self.bias = x, scale, bias
        self.mesh, self.count = mesh, count
        self.x32 = _wide(x)
        if mesh is not None:
            self.sum = self.x32.sum(_DIMS)

    def plain(self) -> torch.Tensor:
        x, dt = self.x, self.x.dtype
        mean = self.x32.mean(_DIMS).to(dt)
        var = self.x32.var(_DIMS, correction=0).to(dt)
        inv = self.scale * torch.rsqrt(_wide(var) + EPS).to(dt)
        return _affine(x, mean, inv, self.bias)

    # -- data parallel ------------------------------------------------------

    def set_mean(self, total: torch.Tensor) -> None:
        """The global mean from the all-reduced sum."""
        self.mean_r = total / self.count

    def squares(self, m2: torch.Tensor) -> torch.Tensor:
        """The local sum of squared deviations from the variance's own
        mean ``m2`` (rank-varying: the value after its ``pvary``)."""
        return ((self.x32 - _chan(m2)) ** 2).sum(_DIMS)

    def set_var(self, total: torch.Tensor) -> None:
        """``scale * rsqrt(var + eps)`` from the all-reduced squares."""
        dt = self.x.dtype
        var = (total / self.count).to(dt)
        self.inv_r = (_wide(self.scale)
                      * _wide(torch.rsqrt(_wide(var) + EPS).to(dt)))

    def output(self, mean_v: torch.Tensor, inv_v: torch.Tensor):
        dt = self.x.dtype
        return _affine(self.x, mean_v.to(dt), inv_v.to(dt), self.bias)

    def sync(self, merge_fwd: "_BatchNorm | None" = None,
             merge_bwd: "_BatchNorm | None" = None) -> torch.Tensor:
        """The data-parallel batch-norm, its mean set.  Its variance-mean
        ``pvary`` is its own unless a merge gave it (``m2``).
        ``merge_fwd``: a batch-norm whose sum for its mean rides in this
        one's tuple (its :meth:`set_mean` is done here); ``merge_bwd``: one
        whose variance-mean ``pvary`` joins this one's (and is given)."""
        mesh = self.mesh
        m2 = getattr(self, "m2", None)
        if m2 is None:
            m2 = pvary(self.mean_r, mesh, "dp")
        parts = [self.squares(m2), self.sum]
        if merge_fwd is not None:
            parts.append(merge_fwd.sum)
        red = psum_coalesced(parts, mesh, "dp")
        if merge_fwd is not None:
            merge_fwd.set_mean(red[2])
        self.set_var(red[0])
        if merge_bwd is None:
            mean_v, inv_v = pvary_coalesced([self.mean_r, self.inv_r], mesh,
                                            "dp")
        else:
            merge_bwd.m2, mean_v, inv_v = pvary_coalesced(
                [merge_bwd.mean_r, self.mean_r, self.inv_r], mesh, "dp")
        return self.output(mean_v, inv_v)


class _Net:
    """``resnet50_apply`` over named parameters, on one device (``mesh``
    None) or one rank of a ``(dp,)`` mesh with synchronized batch-norms
    over ``count`` positions per channel at each layer."""

    def __init__(self, params: dict, mesh: Mesh | None, batch: int):
        self.p, self.mesh, self.batch = params, mesh, batch

    def bn(self, x, scale: str, bias: str) -> _BatchNorm:
        count = self.batch * x.shape[2] * x.shape[3]
        return _BatchNorm(x, self.p[scale], self.p[bias], self.mesh, count)

    def norm(self, x, scale: str, bias: str) -> torch.Tensor:
        bn = self.bn(x, scale, bias)
        if self.mesh is None:
            return bn.plain()
        bn.set_mean(psum(bn.sum, self.mesh, "dp"))
        return bn.sync()

    def __call__(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        p = self.p
        h = _conv(x_nhwc.permute(0, 3, 1, 2), p["stem_conv"], 2)
        h = torch.relu(self.norm(h, "stem_scale", "stem_bias"))
        h = _max_pool(h)
        for stage, blocks in enumerate(STAGE_BLOCKS):
            for block in range(blocks):
                pre = f"s{stage}b{block}"
                stride = 2 if (block == 0 and stage > 0) else 1
                if block == 0:
                    shortcut, y = self.first_block(h, pre, stride)
                else:
                    shortcut = h
                    y = torch.relu(self.norm(_conv(h, p[f"{pre}_c1"]),
                                             f"{pre}_scale1",
                                             f"{pre}_bias1"))
                y = torch.relu(self.norm(_conv(y, p[f"{pre}_c2"], stride),
                                         f"{pre}_scale2", f"{pre}_bias2"))
                y = self.norm(_conv(y, p[f"{pre}_c3"]), f"{pre}_scale3",
                              f"{pre}_bias3")
                h = torch.relu(y + shortcut)
        h = h.mean((2, 3))
        return h @ p["head_w"] + p["head_b"]

    def first_block(self, h, pre: str, stride: int):
        """The projection shortcut and the first convolution of a stage's
        first block, their batch-norms' all-reduces merged (module
        docstring)."""
        p = self.p
        proj = self.bn(_conv(h, p[f"{pre}_proj"], stride),
                       f"{pre}_proj_scale", f"{pre}_proj_bias")
        c1 = self.bn(_conv(h, p[f"{pre}_c1"]), f"{pre}_scale1",
                     f"{pre}_bias1")
        if self.mesh is None:
            return proj.plain(), torch.relu(c1.plain())
        proj.set_mean(psum(proj.sum, self.mesh, "dp"))
        shortcut = proj.sync(merge_fwd=c1, merge_bwd=c1)
        return shortcut, torch.relu(c1.sync())


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ResNet50(nn.Module):
    """``resnet50_apply``: ``(*params, x) -> logits``, single chip."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.names = param_names(num_classes)

    def forward(self, *flat: torch.Tensor) -> torch.Tensor:
        params = dict(zip(self.names, flat[:-1]))
        x = flat[-1]
        return _Net(params, None, x.shape[0])(x)


class ResNet50Train(SpmdModule):
    """The reference's ``make_train_step``: ``(*params, *velocity, x,
    labels) -> (loss, *params', *velocity')``, one SGD-momentum step.

    With ``dp`` > 1, ``forward`` is one rank's program over its shard of
    the batch (the global batch ``batch``) and :meth:`run` the whole
    step; with ``dp`` 1 it is the single-chip step."""

    #: capture traces the step with ``make_fx``
    train_step = True

    def __init__(self, num_classes: int, batch: int, dp: int = 1,
                 momentum: float = 0.9, lr: float = 0.1):
        super().__init__()
        self.names = param_names(num_classes)
        self.batch, self.momentum, self.lr = batch, momentum, lr
        self.mesh = Mesh((dp,), ("dp",))
        self._spmd = self.mesh if dp > 1 else None
        n = len(self.names)
        self.in_specs = (P(),) * (2 * n) + (P("dp"), P("dp"))
        self.out_specs = (P(),) * (1 + 2 * n)

    def loss_and_grads(self, *flat: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """One rank's ``(loss, *grads)`` over the global batch, each
        gradient in its parameter's dtype, summed over ``dp``."""
        n = len(self.names)
        params, x, labels = flat[:n], flat[-2], flat[-1]
        mesh = self._spmd

        def loss_fn(ps):
            net = _Net(dict(zip(self.names, ps)), mesh, self.batch)
            logp = torch.log_softmax(_wide(net(x)), dim=-1)
            picked = torch.gather(logp, 1, labels[:, None].long())
            return -picked.sum() / self.batch

        grads, loss = torch.func.grad_and_value(loss_fn)(params)
        if mesh is None:
            return (loss, *grads)
        grads = list(grads)
        idx = {name: i for i, name in enumerate(self.names)}
        for stage in range(len(STAGE_BLOCKS)):
            # one value, as XLA's CSE makes it (module docstring)
            grads[idx[f"s{stage}b0_proj_bias"]] = grads[
                idx[f"s{stage}b0_bias3"]]
        # every gradient but the batch-norm scales' is a rank's partial
        # (the scales' follow from all-reduced cotangents)
        partial = [i for i, name in enumerate(self.names)
                   if "scale" not in name]
        apart = idx["s0b0_proj_bias"]
        main = [i for i in partial if i != apart]
        summed = psum_coalesced([loss] + [_wide(grads[i]) for i in main],
                                mesh, "dp")
        (own,) = psum_coalesced([_wide(grads[apart])], mesh, "dp")
        out = list(grads)
        for i, g in zip(main + [apart], [*summed[1:], own]):
            out[i] = g.to(grads[i].dtype)
        return (summed[0], *out)

    def forward(self, *flat: torch.Tensor) -> tuple[torch.Tensor, ...]:
        n = len(self.names)
        loss, *grads = self.loss_and_grads(*flat)
        params, velocity = flat[:n], flat[n:2 * n]
        velocity = [self.momentum * v + g for v, g in zip(velocity, grads)]
        params = [p - self.lr * v.to(p.dtype)
                  for p, v in zip(params, velocity)]
        return (loss, *params, *velocity)

    def grads(self, *global_args: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``(loss, *grads)`` of the whole step over global arrays."""
        n = len(self.names)
        return run_ranks(self.loss_and_grads, self.mesh, *global_args,
                         in_specs=self.in_specs,
                         out_specs=self.out_specs[:1 + n])


def _build(batch: int, image: int, num_classes: int, dtype: str,
           num_devices: int, train: bool, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    params = init_params(num_classes, dt, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, image, image, 3), generator=gen, device=dev,
                    dtype=dt)
    labels = (torch.arange(batch, device=dev) % num_classes).to(torch.int32)
    if not train:
        if num_devices != 1:
            raise ValueError("the data-parallel forward is not a "
                             "registered workload")
        return ResNet50(num_classes), (*params, x)
    velocity = tuple(p * 0 for p in params)
    step = ResNet50Train(num_classes, batch, dp=num_devices)
    return step, (*params, *velocity, x, labels)


@register(
    "resnet50",
    description="ResNet-50 fwd (single chip)",
    suite="models",
    batch=32, image=224, num_classes=1000, dtype="bfloat16",
    num_devices=1, train=False,
)
def build_resnet50(device=None, **kw):
    kw.setdefault("num_devices", 1)
    return _build(device=device, **kw)


@register(
    "resnet50_train",
    description="ResNet-50 train step (single chip)",
    suite="models",
    batch=32, image=224, num_classes=1000, dtype="bfloat16",
    num_devices=1, train=True,
)
def build_resnet50_train(device=None, **kw):
    kw.setdefault("num_devices", 1)
    return _build(device=device, **kw)


@register(
    "resnet50_dp8",
    description="ResNet-50 train step, data-parallel over 8 chips "
    "(BASELINE config #4)",
    suite="models",
    num_devices=8,
    batch=256, image=224, num_classes=1000, dtype="bfloat16", train=True,
)
def build_resnet50_dp8(device=None, **kw):
    kw.setdefault("num_devices", 8)
    return _build(device=device, **kw)
