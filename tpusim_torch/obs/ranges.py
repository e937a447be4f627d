"""Profiler ranges inside the program, at no cost when no profiler runs.

:func:`device_range` opens a ``torch.profiler.record_function`` range
only while a profiler session is running and the code is being run, not
traced.  Otherwise it hands back one shared no-op context manager, and
the call costs an attribute load and a branch: a bare
``record_function`` costs tens of microseconds an enter and exit even
with no profiler running.

Tracing gets the no-op too: ``make_fx`` records a ``record_function`` as
``profiler._record_function_enter_new`` / ``_record_function_exit`` nodes
in the captured graph, with or without a profiler.  The no-op is a
``contextlib.nullcontext``, which dynamo (it traces a ``scan`` body under
capture, :mod:`tpusim_torch.models.loop`) enters; it refuses the hub's
own no-op span object.

Range names are dotted (``tpusim_torch.llama.attention``), never with
``::``: readers of a profile take a host event whose name holds ``::``
for a dispatched op.  No name starts with ``tpusim_torch.exec`` or
``tpusim_torch.node:``, the ranges of
:mod:`tpusim_torch.harness.correl_ops`.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _autograd_profiler

__all__ = ["OFF", "device_range"]

#: what :func:`device_range` returns when it opens no range
OFF = contextlib.nullcontext()


def device_range(name: str):
    """A profiler range named ``name`` around the ``with`` block, or
    :data:`OFF` when no profiler runs or the code is traced."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    import torch
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    if torch.compiler.is_compiling() or get_proxy_mode() is not None:
        return OFF
    return torch.profiler.record_function(name)
