"""On the card, at ``dsv2lite.prefill_16k``'s own size: each mechanism fault
of :mod:`benchmark.mechanism_faults` planted in the program for a whole
run; the experts the program chooses against the reference's own choice;
the balance counter of the expert layers; and a short traced run's device
time by range, the expert layer's two ranges with the decoder's six.
Each test prints one JSON line.  These skip without an NVIDIA card; run
them on one with
``python -m pytest benchmark/tests/test_portbench_dsv2_card.py -q -s``."""

import json
import time

import pytest
import torch

from benchmark import harness, mechanism_faults, spans, spec, traffic

CELL = "dsv2lite.prefill_16k"
SEED = 2 ** 31 + 4321


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(mechanism_faults.ALL))
def test_each_mechanism_fault_at_the_cells_size(card, fault):
    """A run with the fault planted, judged as a run is: incorrect.
    Prints the readings; the limits file records them all."""
    c = spec.find_cell(CELL)
    with mechanism_faults.ALL[fault](c.config):
        r = harness.run_cell(c, SEED, 1.0, False, card, time.perf_counter())
    print(json.dumps({"cell": CELL, "fault": fault, "seed": SEED,
                      "checks": r["checks"], "correct": r["correct"],
                      "steps": r["attempted"]}))
    torch.cuda.empty_cache()
    assert r["correct"] is False, r["checks"]


@pytest.mark.card
def test_routing_against_the_references_own_and_the_balance(card,
                                                            monkeypatch):
    """One step of the program and the reference on the same weights and
    tokens, each router recorded: the share of (token, expert) choices in
    which the program's top-k and the reference's differ (near-ties
    between a token's k-th and (k+1)-th expert flip under bfloat16
    storage) by layer: the reference's choices the program did not make;
    and the busiest expert's tokens over the mean."""
    from benchmark.reference import deepseek_v2_plain as plain
    from tpusim_torch.models import deepseek_v2 as ds

    c = spec.find_cell(CELL)
    fam = spec.family(c.config["family"])
    seen = {"program": [], "reference": []}

    def recorded(inner, into):
        def route(*args, **kw):
            weight, experts = inner(*args, **kw)
            into.append(experts.reshape(-1, experts.shape[-1]).cpu())
            return weight, experts
        return route

    monkeypatch.setattr(ds, "route", recorded(ds.route, seen["program"]))
    monkeypatch.setattr(plain, "route",
                        recorded(plain.route, seen["reference"]))
    params = fam.make_params(c.config, SEED, card)
    tokens = fam.step_input(fam.make_inputs(c.config, c.traffic, SEED, card),
                            traffic.compared_step(c.traffic, SEED))
    module = fam.build(c.config, card)
    got = fam.step(module, params, tokens)
    balance = list(module.busiest_over_mean)
    del module
    ref = fam.reference(params, tokens, c.config)
    from benchmark import compare

    err = compare.row_error(got, ref)
    del got, ref
    torch.cuda.empty_cache()
    flips = []
    for a, b in zip(seen["program"], seen["reference"]):
        chosen = torch.zeros(a.shape[0], 64, dtype=torch.bool)
        chosen.scatter_(1, a.long(), True)
        theirs = torch.zeros_like(chosen)
        theirs.scatter_(1, b.long(), True)
        flips.append(int((theirs & ~chosen).sum()))
    choices = seen["reference"][0].numel()
    print(json.dumps({"cell": CELL, "seed": SEED, "logit_row_err": err,
                      "choices_a_layer": choices,
                      "flipped_by_layer": flips,
                      "flipped_share": sum(flips) / (choices * len(flips)),
                      "busiest_over_mean": balance}))
    assert len(flips) == len(balance) == c.config["num_hidden_layers"] - 1
    assert all(b >= 1 for b in balance)
    # near-ties only: a router that kept one expert fewer would miss a
    # sixth of the reference's choices
    assert sum(flips) < 0.1 * choices * len(flips)


@pytest.mark.card
def test_where_a_traced_step_goes_by_range(card):
    """A short traced run: device ms a step of each range of the decoder
    and of the expert layer, and their cover of the busy time."""
    c = spec.find_cell(CELL)
    seen = {}
    from benchmark import trace as tracing

    parse = tracing.parse

    def keep(prof):
        seen["trace"] = parse(prof)
        return seen["trace"]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tracing, "parse", keep)
        r = harness.run_cell(c, SEED, 5.0, True, card, time.perf_counter())
    tr = seen["trace"]
    parts = spans.PARTS + ("router", "experts")
    ms = {p: spans.ms_per_step(tr, p) for p in parts}
    busy = tr.busy_ns() / 1e6 / len(tr.steps)
    print(json.dumps({"cell": CELL, "steps": len(tr.steps), "ms_per_step": ms,
                      "busy_ms_per_step": busy,
                      "covered": sum(v or 0.0 for v in ms.values()) / busy,
                      "metrics": r["metrics"],
                      "breakdown": r["breakdown"]}))
    assert r["correct"] is True, r["checks"]
    assert all(v is not None for v in ms.values()), ms
    assert sum(ms.values()) >= 0.99 * busy
