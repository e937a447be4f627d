"""Simulation as a service: the port's serving daemon (port of
:mod:`tpusim.serve`).

A one-shot CLI run pays process start, config compose and trace load on
every invocation, and shares no warm cache with the next.  The daemon
keeps traces parsed and caches warm across requests, behind a
stdlib-only JSON-over-HTTP API:

* ``POST /v1/simulate`` — trace ref or inline HLO text + config overlay
  + optional fault schedule → the stats doc, priced through
  :class:`tpusim_torch.perf.CachedEngine` over one process-wide shared
  :class:`~tpusim_torch.perf.ResultCache` (repeat requests are a lookup);
* ``POST /v1/lint`` — the ``lint`` diagnostics as JSON;
* ``POST /v1/sweep``, ``/v1/campaign``, ``/v1/fleet``, ``/v1/advise`` —
  async jobs: each returns a job id;
* ``GET /v1/jobs/<id>`` — queued/running/done/failed + result;
* ``GET /healthz`` / ``GET /metrics`` — liveness + Prometheus gauges;
* the cluster routes (join, heartbeat, forward) of :mod:`.cluster`.

Layers: a registry of pre-loaded trace dirs (:mod:`.registry`), an
admission/queue layer with bounded concurrency, deadlines and request-size
caps (:mod:`.admission`), a worker layer that prices through the shared
cache (:mod:`.worker`), optionally in supervised pre-forked processes
(:mod:`.supervisor`), a shared mmap hot-response cache
(:mod:`.hotcache`), and the HTTP + lifecycle layer with SIGTERM drain
(:mod:`.daemon`).  ``python -m tpusim_torch serve`` starts it;
:mod:`.client` is the typed urllib client.  ``serve --acceptors N``
runs N daemons behind one port (:mod:`.front`, SO_REUSEPORT or an
fd-passing fallback); :mod:`.bench` is the load generator
(``serve-bench``).

Serving is host work: nothing here makes a CUDA tensor, so a daemon
started beside a CUDA context forks workers (and a front tier its
acceptors) that never touch the card.
"""

from tpusim_torch.serve.admission import (
    AdmissionController,
    DeadlineExceeded,
    Degraded,
    Draining,
    JobTable,
    Overloaded,
)
from tpusim_torch.serve.client import ServeClient, ServeError
from tpusim_torch.serve.daemon import SERVE_FORMAT_VERSION, ServeDaemon
from tpusim_torch.serve.front import FrontSupervisor
from tpusim_torch.serve.hotcache import HotResponseCache
from tpusim_torch.serve.registry import TraceRegistry
from tpusim_torch.serve.supervisor import Supervisor, WorkerTimeout
from tpusim_torch.serve.worker import RequestError, ServeWorker

__all__ = [
    "AdmissionController",
    "DeadlineExceeded",
    "Degraded",
    "Draining",
    "FrontSupervisor",
    "HotResponseCache",
    "JobTable",
    "Overloaded",
    "RequestError",
    "SERVE_FORMAT_VERSION",
    "ServeClient",
    "ServeDaemon",
    "ServeError",
    "ServeWorker",
    "Supervisor",
    "TraceRegistry",
    "WorkerTimeout",
]
