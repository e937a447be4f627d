"""Capture of workloads into trace dirs (``torch.export`` → HLO text)."""

from tpusim_torch.tracer.capture import (
    Capture,
    capture,
    capture_to_dir,
    measure_wall_time,
    snapshot_buffers,
)
