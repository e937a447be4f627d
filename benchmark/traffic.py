"""The general generator of a traffic mix: one data file of parameters
(``benchmark/traffic/<mix>.json``) and ``--seed`` give the inputs of
every step.

The keys of every mix, checked here:

* ``loop``: ``"closed"``, each step enqueued as soon as the previous call
  returns, with no host synchronisation between steps;
* ``pool``: distinct inputs drawn; step ``i`` runs input ``i % pool``;
* ``warmup``: steps run in set-up, before the window;
* ``compare_from``: the early step compared is drawn from the first
  ``compare_from`` steps of the window (the last step is compared too).

The keys of a token mix, which the family that takes tokens checks
(:func:`check_tokens`):

* ``batch``, ``seq``: the token ids of one step, ``[batch, seq]``;
* ``tokens``: how ids are drawn (``"uniform"`` over the vocabulary).
"""

from __future__ import annotations

import random

import torch

from benchmark import seeds

LOOPS = ("closed",)
DRAWS = ("uniform",)


def _whole(mix: dict, keys) -> None:
    for key in keys:
        if not isinstance(mix.get(key), int) or mix[key] < 1:
            raise ValueError(f"{key} must be a whole number >= 1")


def validate(mix: dict) -> dict:
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"loop {mix.get('loop')!r} not in {LOOPS}")
    _whole(mix, ("pool", "warmup", "compare_from"))
    return mix


def check_tokens(mix: dict) -> None:
    if mix.get("tokens") not in DRAWS:
        raise ValueError(f"tokens {mix.get('tokens')!r} not in {DRAWS}")
    _whole(mix, ("batch", "seq"))


def make_tokens(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """``[pool, batch, seq]`` int32 token ids, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.stream(seed, "tokens"))
    return torch.randint(0, vocab, (mix["pool"], mix["batch"], mix["seq"]),
                         generator=gen, dtype=torch.int32, device=device)


def compared_step(mix: dict, seed: int) -> int:
    """The early step of the window whose output is compared."""
    return random.Random(seeds.stream(seed, "compare")).randrange(
        mix["compare_from"])
