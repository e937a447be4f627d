"""ICI (inter-chip interconnect) model: topologies, links, collective
schedules.

Port of ``tpusim/ici/``.  The rebuild of the reference's interconnect
layer — the ``icnt_wrapper`` function-pointer ABI
(``src/gpgpu-sim/icnt_wrapper.h:36-64``), BookSim's torus
(``src/intersim2/networks/kncube.cpp``) — and of the distributed fork's
placeholder NCCL model (constant ``-nccl_allreduce_latency``,
``gpu-sim.cc:759-762``), replaced by analytic ring / bidirectional / tree
collective schedules over a real torus link model.
"""

from tpusim_torch.ici.topology import Topology, torus_for
from tpusim_torch.ici.collectives import CollectiveModel, collective_seconds

__all__ = ["Topology", "torus_for", "CollectiveModel", "collective_seconds"]
