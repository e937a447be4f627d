"""Cooperative cancellation (``tpusim_torch.guard.cancel``) through the
port's pricing stack, and ``ValidationError``.

A tripped token raises :class:`OperationCancelled` out of the serial
walk, the fastpath, the batched pricer, ``warm_states`` and the driver;
an armed token that never trips leaves every result equal by bytes to an
ungoverned run (cancellation changes whether a result is produced, never
its value).  The token's semantics and the refusal's message are the JAX
package's.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.analysis import ValidationError as RefValidationError  # noqa: E402,E501
from tpusim.analysis.diagnostics import Diagnostics as RefDiags  # noqa: E402
from tpusim.guard.cancel import CancelToken as RefToken  # noqa: E402
from tpusim.guard.cancel import OperationCancelled as RefCancelled  # noqa: E402,E501
from tpusim_torch.analysis import ValidationError  # noqa: E402
from tpusim_torch.analysis.diagnostics import Diagnostics  # noqa: E402
from tpusim_torch.fastpath.batch import (  # noqa: E402
    price_module_batch,
    warm_states,
)
from tpusim_torch.faults import load_fault_schedule  # noqa: E402
from tpusim_torch.guard import (  # noqa: E402
    CHECK_EVERY_OPS,
    CancelToken,
    OperationCancelled,
)
from tpusim_torch.ici.topology import torus_for  # noqa: E402
from tpusim_torch.perf.cache import (  # noqa: E402
    ResultCache,
    clear_compiled_cache,
    result_to_doc,
)
from tpusim_torch.sim.driver import SimDriver  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LLAMA = REPO / "tests" / "fixtures" / "traces" / "llama_tiny_tp2dp2"


def _tripped(cls=CancelToken):
    token = cls()
    token.cancel("stop here")
    return token


def test_token_semantics_equal_reference():
    for cls, err in ((CancelToken, OperationCancelled),
                     (RefToken, RefCancelled)):
        t = cls()
        assert not t.cancelled and t.remaining() is None
        t.check()
        t.cancel("first")
        t.cancel("second")
        assert t.cancelled and t.reason == "first"
        with pytest.raises(err, match="^first$"):
            t.check()
        late = cls.after(-5.0)
        assert late.cancelled and late.remaining() == 0.0
        with pytest.raises(err, match="deadline exceeded"):
            late.check()
        live = cls.after(60.0)
        assert 0.0 < live.remaining() <= 60.0 and not live.cancelled
    assert CHECK_EVERY_OPS == 256
    assert issubclass(OperationCancelled, RuntimeError)


def test_deadline_trips_without_an_explicit_cancel():
    t = CancelToken(deadline=time.monotonic() + 0.01)
    time.sleep(0.02)
    with pytest.raises(OperationCancelled, match="cooperative cancel"):
        t.check()


@pytest.fixture
def llama():
    clear_compiled_cache()
    pod = load_trace(LLAMA)
    cfg = load_config(arch="v5p", tuned=False)
    yield pod, cfg, next(iter(pod.modules.values()))
    clear_compiled_cache()


@pytest.mark.parametrize("backend", ["serial", "vectorized"])
def test_engine_walk_cancels_and_a_live_token_changes_nothing(llama,
                                                              backend):
    pod, cfg, module = llama
    plain = Engine(cfg, pricing_backend=backend).run(module)
    armed = Engine(cfg, pricing_backend=backend,
                   cancel=CancelToken.after(3600.0)).run(module)
    assert json.dumps(result_to_doc(armed)) == \
        json.dumps(result_to_doc(plain))
    with pytest.raises(OperationCancelled, match="stop here"):
        Engine(cfg, pricing_backend=backend, cancel=_tripped()).run(module)


def test_batch_pass_and_warm_states_cancel(llama):
    pod, cfg, module = llama
    topo = torus_for(4, "v5p")
    engines = [Engine(cfg, topology=topo, clock_scale=s)
               for s in (1.0, 0.7)]
    with pytest.raises(OperationCancelled):
        price_module_batch(module, engines, backend="vectorized",
                           cancel=_tripped())
    live = price_module_batch(module, engines, backend="vectorized",
                              cancel=CancelToken.after(3600.0))
    plain = price_module_batch(module, engines, backend="vectorized")
    assert [result_to_doc(r) for r in live] == \
        [result_to_doc(r) for r in plain]
    states = [load_fault_schedule({"faults": [
        {"kind": "chip_straggler", "chip": 1, "clock_scale": 0.6}]}
    ).bind(topo)]
    with pytest.raises(OperationCancelled):
        warm_states(pod, cfg, topo, states, ResultCache(),
                    backend="vectorized", cancel=_tripped())


def test_driver_cancels_at_command_grain(llama):
    pod, cfg, _module = llama
    with pytest.raises(OperationCancelled):
        SimDriver(cfg, cancel=_tripped()).run(pod)
    plain = SimDriver(cfg).run(pod)
    live = SimDriver(cfg, cancel=CancelToken.after(3600.0)).run(pod)
    drop = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
    a, b = (json.loads(r.stats.to_json()) for r in (plain, live))
    assert {k: v for k, v in a.items() if k not in drop} == \
        {k: v for k, v in b.items() if k not in drop}


def test_validation_error_message_equals_reference():
    got, want = Diagnostics(), RefDiags()
    for d in (got, want):
        d.emit("TL213", "correlated group 'g': axis 7 out of range",
               file="c.json")
        d.emit("TL232", "dcn.num_slices=9 exceeds the 8-chip system")
    assert str(ValidationError(got)) == str(RefValidationError(want))
    assert str(ValidationError(got, strict=True)) == \
        str(RefValidationError(want, strict=True))
    assert ValidationError(got).diags is got
