"""Caches of the port's pricing (port of part of :mod:`tpusim.perf`): the
compiled-module tier the fastpath keys its columns under."""
