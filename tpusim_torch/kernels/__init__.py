"""Build, load and wrap the port's CUDA kernels (sources in ``csrc/``).

Nothing is compiled when this package is imported: a kernel is built the
first time its wrapper gets a CUDA tensor."""
