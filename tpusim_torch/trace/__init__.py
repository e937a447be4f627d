"""Trace formats: the HLO text parser and the trace-dir reader/writer."""

from tpusim_torch.trace.format import (
    TraceDir,
    load_trace,
    parse_commandlist,
    save_trace,
)
from tpusim_torch.trace.hlo_text import parse_hlo_module, parse_shape
