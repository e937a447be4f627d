"""The pricing fastpath (port of :mod:`tpusim.fastpath`).

The hot path under simulate: the engine's schedule walk split into two
phases.

* **compile** (:mod:`tpusim_torch.fastpath.compile`) — one pass over a
  module turns each computation into flat float64 columns (cycles / bytes
  / flops per op, CPU ``torch.float64`` tensors) plus a step program
  (control flow, async joins, collectives, and contiguous *runs* of
  ordinary synchronous ops).  Compiled once per (module content hash,
  composed config) in :mod:`tpusim_torch.perf.cache`.
* **price** (:mod:`tpusim_torch.fastpath.price`) — replays the step
  program for one launch class (clock/HBM multipliers, spill fraction).
  Runs of sync ops accumulate through serial ``torch.cumsum`` scans;
  everything stateful (async DMA channels, ICI, HBM contention, control
  flow) steps through the same scalar logic as the reference walk.
* **batch** (:mod:`tpusim_torch.fastpath.batch`) — the scenario axis: S
  degradation states of one module price as ONE lane-axis pass, with the
  row scans on the host or, on request, in the ``scan_rows`` CUDA kernel;
  ``warm_states`` publishes a set of states' lanes into a result cache.
* **store** (:mod:`tpusim_torch.fastpath.store`) — the durable tier: the
  compiled columns as ``.cmod`` records, mapped back on load, so a warm
  store prices a lazily loaded module without parsing it.

Contract: every backend — ``serial`` (the reference walk in
:class:`tpusim_torch.timing.engine.Engine`) and ``vectorized`` — and
every lane of a batch produce **byte-identical**
:class:`~tpusim_torch.timing.engine.EngineResult` counters, equal to the
JAX package's (``tests/test_torch_fastpath.py``,
``tests/test_torch_batch_price.py``).  The fastpath disengages under
timeline recording and op-granularity checkpoint/resume
(``fastpath_eligible``).
"""

from tpusim_torch.fastpath.batch import (
    BATCH_BACKENDS,
    BatchStats,
    price_module_batch,
    resolve_batch_backend,
    warm_states,
)
from tpusim_torch.fastpath.compile import (
    CompiledComputation,
    CompiledModule,
    compile_module,
)
from tpusim_torch.fastpath.price import (
    BACKENDS,
    fastpath_eligible,
    price_module,
    resolve_backend,
    resolve_engine_scales,
)

__all__ = [
    "BACKENDS",
    "BATCH_BACKENDS",
    "BatchStats",
    "CompiledComputation",
    "CompiledModule",
    "compile_module",
    "fastpath_eligible",
    "price_module",
    "price_module_batch",
    "resolve_backend",
    "resolve_batch_backend",
    "resolve_engine_scales",
    "warm_states",
]
