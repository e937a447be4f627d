"""Standalone analysis tools — the ``util/tracer_nvbit/others/`` parity
slot: the reference ships auxiliary NVBit tools alongside its tracer
(bbv_tool for SimPoint basic-block vectors, occupancy_calc_tool).  Port
of ``tpusim/tools/``: the HLO-level equivalents
:mod:`tpusim_torch.tools.bbv` and :mod:`tpusim_torch.tools.occupancy`."""
