"""Faults planted under the timed path, and the control put in the
program's place, to show that the comparison catches them: each wraps
the program's module, called as ``module(*params, tokens)``, as
``harness.run_cell(..., wrap=...)`` takes it.  Used by the tests and by
``calibrate.py``; never by a benchmark run."""

from __future__ import annotations

import torch


class _Wrap(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner


class HalfBatch(_Wrap):
    """Half of the batch left out: the step runs the first half of the
    rows, and the rest of the output stays zero."""

    def forward(self, *args):
        tokens = args[-1]
        keep = tokens.shape[0] // 2
        part = self.inner(*args[:-1], tokens[:keep])
        out = part.new_zeros((tokens.shape[0], *part.shape[1:]))
        out[:keep] = part
        return out


class AlteredAnswer(_Wrap):
    """One answer altered where it is produced: the logits of the middle
    position of the first sequence are those of the position before it."""

    def forward(self, *args):
        out = self.inner(*args).clone()
        mid = out.shape[1] // 2
        out[0, mid] = out[0, mid - 1]
        return out


class AlteredToken(_Wrap):
    """One token altered where the step reads it: the middle token of
    the first sequence is replaced by its successor in the vocabulary."""

    def __init__(self, inner, vocab: int):
        super().__init__(inner)
        self.vocab = vocab

    def forward(self, *args):
        tokens = args[-1].clone()
        mid = tokens.shape[1] // 2
        tokens[0, mid] = (tokens[0, mid] + 1) % self.vocab
        return self.inner(*args[:-1], tokens)


class Stale(_Wrap):
    """A step that returns its first answer again: state left unchanged."""

    def __init__(self, inner):
        super().__init__(inner)
        self.first = None

    def forward(self, *args):
        if self.first is None:
            self.first = self.inner(*args)
        return self.first


class Control(_Wrap):
    """The control: the plain reference in the precision below the
    configuration's bfloat16 put in the program's place.  Each step
    returns the reference's logits for the step's own weights and tokens
    with every product's operands rounded to fp8 (e4m3, one scale a
    tensor)."""

    def __init__(self, inner, fam, config: dict):
        super().__init__(inner)
        self.fam, self.config = fam, config

    def forward(self, *args):
        return self.fam.reference(args[:-1], args[-1], self.config,
                                  matmul_dtype=torch.float8_e4m3fn)


def control(fam, config: dict):
    """The wrap that puts :class:`Control` in the program's place."""
    return lambda module: Control(module, fam, config)


def all_faults(batch: int, vocab: int) -> dict:
    """The faults a cell of this batch can have, by name."""
    out = {"altered_answer": AlteredAnswer,
           "altered_token": lambda m: AlteredToken(m, vocab),
           "stale": Stale}
    if batch > 1:
        out["half_batch"] = HalfBatch
    return out
