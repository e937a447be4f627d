"""tpusim_torch — the PyTorch/CUDA port of :mod:`tpusim`.

The JAX package ``tpusim`` stays the reference; each module here names the
module of ``tpusim`` it ports.  Capture runs workloads on an NVIDIA GPU
(hand-written CUDA kernels in ``csrc/``); simulate prices the trace on the
host with the same numbers as the reference.
"""

__version__ = "0.1.0"
