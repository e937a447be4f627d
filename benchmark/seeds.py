"""Independent streams from one ``--seed``: the weights, the tokens and
the choice of the steps compared each get a seed of their own."""

from __future__ import annotations

import hashlib


def stream(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of ``seed`` (any whole
    number, negative or past 64 bits too)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
