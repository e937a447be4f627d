"""Experiment orchestration + validation harnesses.

Port of ``tpusim/harness/``: the rebuild of the reference's Python tooling
layer (``util/``) — ``run_simulations.py`` (job fabrication/launch),
``procman.py`` (local process manager), ``get_stats.py`` (stat scraping),
``plot-correlation.py`` (sim-vs-silicon validation: correlation points
and per-op correlation timed on the card, their offline regeneration,
the replay refiner and its leave-one-out check, the HTML report) and
``tuner.py`` (microbench-driven config fit, and the power fit of ``tune
--power``).  The correlator and the tuner import torch, so they load on
first use.
"""

from tpusim_torch.harness.procman import Job, ProcMan
from tpusim_torch.harness.runner import RunSpec, run_experiments
from tpusim_torch.harness.scrape import scrape_log, scrape_run_dirs, write_csv

__all__ = [
    "CorrelationPoint",
    "correlate_workload",
    "Job",
    "ProcMan",
    "RunSpec",
    "run_experiments",
    "scrape_log",
    "scrape_run_dirs",
    "write_csv",
    "TunerResult",
    "tune",
]

_LAZY = {
    "CorrelationPoint": "tpusim_torch.harness.correlate",
    "correlate_workload": "tpusim_torch.harness.correlate",
    "TunerResult": "tpusim_torch.harness.tuner",
    "tune": "tpusim_torch.harness.tuner",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
