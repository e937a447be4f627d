"""The ``dcn`` spec block shared by campaign / fleet / advise specs.

Port of ``tpusim/dcn/spec.py``.  One parser, one schema: every spec
layer that can stand up a multi-slice system accepts the same block and
composes the same config overlay from it, the way their ``arch``/
``chips`` fields already share
:func:`tpusim_torch.timing.config.load_config`.

.. code-block:: json

    "dcn": {
      "num_slices": 2,
      "nics_per_slice": 4,
      "nic_bandwidth": 25e9,
      "hop_latency": 10e-6,
      "oversubscription": 1.0
    }

``num_slices`` is the only required key.  The block is the sole spec
surface — the derived ``arch.ici.dcn_*`` config fields are an
implementation detail specs never spell out (:func:`fabric_overlay`
composes them).

Callers (campaign/fleet/advise spec parsers) wrap :class:`DcnSpecError`
in their own error type carrying lint code TL230.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["DcnBlock", "DcnSpecError", "fabric_overlay"]

_FIELDS = {
    "num_slices", "nics_per_slice", "nic_bandwidth", "hop_latency",
    "oversubscription",
}


class DcnSpecError(ValueError):
    """A ``dcn`` block that fails format validation (TL230)."""


def _num(doc: dict, key: str, default: float) -> float:
    v = doc.get(key, default)
    if not isinstance(v, (int, float)) or isinstance(v, bool) \
            or not math.isfinite(v) or v <= 0:
        raise DcnSpecError(
            f"dcn.{key} must be a positive finite number, got {v!r}"
        )
    return float(v)


@dataclass(frozen=True)
class DcnBlock:
    """Parsed ``dcn`` spec block (defaults match the flat scalar
    model's ``dcn_bandwidth``/``dcn_latency`` defaults)."""

    num_slices: int
    nics_per_slice: int = 1
    nic_bandwidth: float = 25e9
    hop_latency: float = 10e-6
    oversubscription: float = 1.0

    @staticmethod
    def parse(doc) -> "DcnBlock":
        if not isinstance(doc, dict):
            raise DcnSpecError(
                f"dcn must be an object, got {type(doc).__name__}"
            )
        unknown = set(doc) - _FIELDS
        if unknown:
            raise DcnSpecError(
                f"unknown dcn field(s) {sorted(unknown)}; "
                f"valid: {sorted(_FIELDS)}"
            )
        if "num_slices" not in doc:
            raise DcnSpecError("dcn.num_slices is required")
        ns = doc["num_slices"]
        if not isinstance(ns, int) or isinstance(ns, bool) or ns < 2:
            raise DcnSpecError(
                f"dcn.num_slices must be an integer >= 2, got {ns!r}"
            )
        nics = doc.get("nics_per_slice", 1)
        if not isinstance(nics, int) or isinstance(nics, bool) \
                or nics < 1:
            raise DcnSpecError(
                "dcn.nics_per_slice must be an integer >= 1, "
                f"got {nics!r}"
            )
        return DcnBlock(
            num_slices=ns,
            nics_per_slice=nics,
            nic_bandwidth=_num(doc, "nic_bandwidth", 25e9),
            hop_latency=_num(doc, "hop_latency", 10e-6),
            oversubscription=_num(doc, "oversubscription", 1.0),
        )

    def to_doc(self) -> dict:
        return {
            "num_slices": self.num_slices,
            "nics_per_slice": self.nics_per_slice,
            "nic_bandwidth": self.nic_bandwidth,
            "hop_latency": self.hop_latency,
            "oversubscription": self.oversubscription,
        }


def fabric_overlay(block: DcnBlock, num_chips: int) -> dict:
    """The config overlay a ``dcn`` block composes for a system of
    ``num_chips`` chips — the one place the ``arch.ici.dcn_*`` field
    names are spelled.

    ``chips_per_slice`` rounds UP (``ceil``) so the slice count the
    collective model derives equals ``num_slices`` even when the chip
    count does not tile evenly (the config passes' TL108 warns on the
    uneven case)."""
    cps = max(math.ceil(num_chips / block.num_slices), 1)
    return {
        "arch": {
            "ici": {
                "chips_per_slice": cps,
                "dcn_nics_per_slice": block.nics_per_slice,
                "dcn_hop_bandwidth": block.nic_bandwidth,
                "dcn_hop_latency": block.hop_latency,
                "dcn_oversubscription": block.oversubscription,
            }
        }
    }
