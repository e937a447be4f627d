"""The port's performance layer (port of :mod:`tpusim.perf`): the
content-addressed caches of pricing (:mod:`tpusim_torch.perf.cache` — the
engine-result cache and the fastpath's compiled-module tier) and the
ordered worker pool of the sweeps and the driver
(:mod:`tpusim_torch.perf.pool`)."""
