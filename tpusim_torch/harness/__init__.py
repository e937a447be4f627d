"""Experiment orchestration + validation harnesses.

Port of ``tpusim/harness/``: the rebuild of the reference's Python tooling
layer (``util/``) — ``run_simulations.py`` (job fabrication/launch),
``procman.py`` (local process manager), ``get_stats.py`` (stat scraping)
and the offline half of the sim-vs-silicon validation (per-op correlation
regenerated from committed device rows, the replay refiner and its
leave-one-out check, correlation points and their HTML report, the power
fit of ``tune --power``).  The live correlator and the microbench tuner
time a TPU and are not ported (ROADMAP A12 item 5).
"""

from tpusim_torch.harness.procman import Job, ProcMan
from tpusim_torch.harness.runner import RunSpec, run_experiments
from tpusim_torch.harness.scrape import scrape_log, scrape_run_dirs, write_csv

__all__ = [
    "Job",
    "ProcMan",
    "RunSpec",
    "run_experiments",
    "scrape_log",
    "scrape_run_dirs",
    "write_csv",
]
