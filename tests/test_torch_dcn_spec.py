"""The ``dcn`` spec block (``tpusim_torch.dcn.spec``), its passes
(TL23x) and the shared diagnostics core, against the JAX package's.

The block parser and the config overlay it composes equal the
reference's for good and bad blocks (same errors, same messages); the
DCN passes and the campaign/fleet loaders report the same TL230-TL232
diagnostics; the diagnostics registry, its families and its rendering
are the reference's (module paths under ``tpusim_torch/``).
"""

from __future__ import annotations

import json

import pytest

pytest.importorskip("torch")

from tpusim.analysis import diagnostics as ref_diag  # noqa: E402
from tpusim.analysis.dcn_passes import run_dcn_passes as ref_dcn  # noqa: E402
from tpusim.analysis.diagnostics import Diagnostics as RefDiags  # noqa: E402
from tpusim.campaign import load_campaign_spec as ref_campaign  # noqa: E402
from tpusim.dcn.spec import DcnBlock as RefBlock  # noqa: E402
from tpusim.dcn.spec import fabric_overlay as ref_overlay  # noqa: E402
from tpusim.faults import load_fault_schedule as ref_schedule  # noqa: E402
from tpusim.fleet import load_fleet_spec as ref_fleet  # noqa: E402
from tpusim_torch.analysis import diagnostics as diag  # noqa: E402
from tpusim_torch.analysis.dcn_passes import run_dcn_passes  # noqa: E402
from tpusim_torch.analysis.diagnostics import Diagnostics  # noqa: E402
from tpusim_torch.campaign import load_campaign_spec  # noqa: E402
from tpusim_torch.dcn import DcnBlock, DcnSpecError, fabric_overlay  # noqa: E402,E501
from tpusim_torch.faults import load_fault_schedule  # noqa: E402
from tpusim_torch.fleet import load_fleet_spec  # noqa: E402

GOOD = [
    {"num_slices": 2},
    {"num_slices": 2, "nics_per_slice": 2, "nic_bandwidth": 25e9,
     "hop_latency": 1e-5},
    {"num_slices": 16, "nics_per_slice": 8, "nic_bandwidth": 100e9,
     "hop_latency": 2e-6, "oversubscription": 3},
]
BAD = [
    {"num_slices": 1},
    {"num_slices": 2, "oversubscription": 0},
    {"num_slices": 2, "warp_drive": True},
    {"nics_per_slice": 2},
    {"num_slices": True},
    {"num_slices": 2, "nics_per_slice": 0},
    {"num_slices": 2, "nic_bandwidth": float("inf")},
    {"num_slices": 2, "hop_latency": "1us"},
    [2],
]


@pytest.mark.parametrize("doc", GOOD, ids=lambda d: str(len(d)))
def test_block_and_overlay_equal_reference(doc):
    block, ref = DcnBlock.parse(doc), RefBlock.parse(doc)
    assert block.to_doc() == ref.to_doc()
    for chips in (1, 4, 7, 8, 64):
        assert fabric_overlay(block, chips) == ref_overlay(ref, chips)


@pytest.mark.parametrize("doc", BAD, ids=lambda d: json.dumps(d)[:30])
def test_bad_block_gives_reference_message(doc):
    with pytest.raises(ValueError) as want:
        RefBlock.parse(doc)
    with pytest.raises(DcnSpecError) as got:
        DcnBlock.parse(doc)
    assert str(got.value) == str(want.value)


def _items(diags):
    return [(d.code, d.severity.value, d.message, d.file, d.line)
            for d in diags.sorted_items()]


@pytest.mark.parametrize("chips,faults", [
    (8, None),
    (1, None),
    (4, [{"kind": "slice_down", "slice": 1},
         {"kind": "slice_down", "slice": 5},
         {"kind": "dcn_link_down", "slice": 2}]),
], ids=["fits", "too_few_chips", "slices_out_of_range"])
def test_dcn_passes_equal_reference(chips, faults):
    doc = {"num_slices": 2, "nics_per_slice": 2}
    got, want = Diagnostics(), RefDiags()
    recs = faults and load_fault_schedule({"faults": faults}).faults
    rrecs = faults and ref_schedule({"faults": faults}).faults
    run_dcn_passes(DcnBlock.parse(doc), got, num_chips=chips, faults=recs,
                   file="spec.json")
    ref_dcn(RefBlock.parse(doc), want, num_chips=chips, faults=rrecs,
            file="spec.json")
    assert _items(got) == _items(want)
    raw = Diagnostics()
    run_dcn_passes(DcnBlock.parse(doc), raw, num_chips=chips, faults=faults)
    assert len(raw.items) == len(got.items)


SPEC_CASES = {
    "dcn_kind_without_fabric": {"faults": {"kinds": ["slice_down"]}},
    "bad_block": {"dcn": {"num_slices": 1}},
    "ok": {"dcn": {"num_slices": 2}, "faults": {"kinds": ["slice_down"]}},
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
@pytest.mark.parametrize("layer", ["campaign", "fleet"])
def test_spec_loaders_tag_dcn_errors_as_reference(layer, case):
    doc = {"seed": 1, **SPEC_CASES[case]}
    load, ref = ((load_campaign_spec, ref_campaign) if layer == "campaign"
                 else (load_fleet_spec, ref_fleet))
    try:
        rspec = ref(doc)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            load(doc)
        assert (got.value.code, str(got.value)) == (e.code, str(e))
        assert e.code == ("TL231" if case == "dcn_kind_without_fabric"
                          else "TL230")
    else:
        assert load(doc).dcn.to_doc() == rspec.dcn.to_doc()


# -- the diagnostics core -----------------------------------------------------


def test_code_registry_equals_reference():
    assert {c: (i.severity.value, i.summary) for c, i in diag.CODES.items()} \
        == {c: (i.severity.value, i.summary)
            for c, i in ref_diag.CODES.items()}
    for code in diag.CODES:
        fam, mod = diag.family_of(code)
        rfam, rmod = ref_diag.family_of(code)
        assert (fam, mod) == (rfam, rmod.replace("tpusim/", "tpusim_torch/"))
    assert diag.list_code_lines() == [
        ln.replace("tpusim/", "tpusim_torch/")
        for ln in ref_diag.list_code_lines()]
    with pytest.raises(KeyError, match="unregistered"):
        Diagnostics().emit("TL999", "x")


def test_rendering_equals_reference():
    emits = [("TL232", "b", "spec.json", None), ("TL210", "a", None, None),
             ("TL204", "c", "sched.json", 3), ("TL500", "d", "m.hlo", 9),
             ("TL402", "e", None, None)]
    got, want = Diagnostics(), RefDiags()
    for code, msg, file, line in emits:
        got.emit(code, msg, file=file, line=line)
        want.emit(code, msg, file=file, line=line)
    assert got.to_json() == want.to_json()
    assert got.text_lines() == want.text_lines()
    assert got.summary() == want.summary()
    assert got.has_errors and got.codes() == want.codes()
    back = Diagnostics.from_doc(json.loads(got.to_json()))
    assert back.to_json() == got.to_json()
