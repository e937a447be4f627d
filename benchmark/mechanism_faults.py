"""Faults in the mechanisms of the DeepSeek-V2 program, to show that the
comparison that decides ``correct`` catches each part of the mathematics
left out or computed otherwise.

Each is a context manager that replaces one of the program's own
functions in ``tpusim_torch.models.deepseek_v2`` (nothing of the program
selects it) while a run builds and drives the module, as the planted
faults of :mod:`benchmark.faults` wrap it.  Used by the tests and on the
card; never by a benchmark run.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _program():
    from tpusim_torch.models import deepseek_v2

    return deepseek_v2


@contextlib.contextmanager
def one_expert_fewer(config: dict):
    """The router keeps its top k - 1 experts (top-5 of DeepSeek-V2-Lite's
    top-6)."""
    ds = _program()
    route = ds.route

    def fewer(x, router, top_k, scaling):
        return route(x, router, top_k - 1, scaling)

    with mock.patch.object(ds, "route", fewer):
        yield


@contextlib.contextmanager
def no_shared_experts(config: dict):
    """The shared experts left out of every expert layer."""
    ds = _program()
    with mock.patch.object(ds, "shared_expert",
                           lambda m, w: torch.zeros_like(m)):
        yield


@contextlib.contextmanager
def scale_without_mscale(config: dict):
    """The softmax scale ``qk_head_dim^-0.5``, without YaRN's ``m^2``."""
    ds = _program()
    with mock.patch.object(ds, "softmax_scale",
                           lambda cfg: cfg.qk_head_dim ** -0.5):
        yield


@contextlib.contextmanager
def plain_rope(config: dict):
    """Plain RoPE frequencies ``theta^(-2i/d)`` in place of YaRN's."""
    ds = _program()

    def plain(cfg, device=None):
        d = cfg.qk_rope_head_dim
        return 1.0 / cfg.rope_theta ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)

    with mock.patch.object(ds, "yarn_inv_freq", plain):
        yield


@contextlib.contextmanager
def no_latent_norm(config: dict):
    """The RMSNorm on the latent left out (the norm whose weight has the
    latent's width, ``kv_lora_rank``; every other norm has the hidden
    size)."""
    rank = config["kv_lora_rank"]
    if rank == config["hidden_size"]:
        raise ValueError("the latent norm is told apart by its width, which "
                         "here equals the hidden size")
    ds = _program()
    norm = ds._rmsnorm

    def skip_latent(x, w, eps):
        return x.contiguous() if w.shape[-1] == rank else norm(x, w, eps)

    with mock.patch.object(ds, "_rmsnorm", skip_latent):
        yield


#: the faults by name
ALL = {"top_k_less_one": one_expert_fewer,
       "no_shared_experts": no_shared_experts,
       "scale_without_mscale": scale_without_mscale,
       "plain_rope": plain_rope,
       "no_latent_norm": no_latent_norm}
