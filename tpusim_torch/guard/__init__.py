"""Governance of the port's durable stores (port of the store half of
:mod:`tpusim.guard`): quota, garbage collection, integrity sweep and
clearing of a cache directory (:mod:`tpusim_torch.guard.store`).

Not ported yet: cancellation tokens and the memory watchdog
(ROADMAP A11)."""
