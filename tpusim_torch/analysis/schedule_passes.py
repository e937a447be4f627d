"""Schedule passes: fault-schedule validity against the declared torus.

A fault-sweep run prices hundreds of scenarios; a schedule typo (a link
that isn't a torus edge, a window that never opens, two faults silently
stacking on the same cable) should fail in the analyzer, not mid-sweep.
The loader (:mod:`tpusim_torch.faults.schedule`) already *raises* on format
and binding violations — these passes convert those refusals into
anchored diagnostics (TL201/TL202) and add the checks the loader
deliberately tolerates (TL203 overlapping faults, TL204 no-effect
scales).

Port of ``tpusim/analysis/schedule_passes.py``.
"""

from __future__ import annotations

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["run_schedule_passes"]


def _entity_key(fault, where) -> tuple:
    """Hashable target identity: all link faults bucket on the
    normalized CABLE (min, max) — direction is compared separately by
    :func:`_directions` — and chip faults collide per chip *resource*
    (a straggler and an HBM throttle on the same chip compose;
    different kinds never collide)."""
    from tpusim_torch.faults.schedule import _LINK_KINDS

    if fault.kind in _LINK_KINDS:
        a, b = where
        return ("link", (min(a, b), max(a, b)))
    return (fault.kind, where)


def _directions(fault, where) -> frozenset:
    """The directed link pairs a link fault acts on (both ways unless
    ``directed``); empty for chip faults."""
    from tpusim_torch.faults.schedule import _LINK_KINDS

    if fault.kind not in _LINK_KINDS:
        return frozenset()
    a, b = where
    return frozenset([(a, b)] if fault.directed else [(a, b), (b, a)])


def run_schedule_passes(
    schedule_src,
    topo,
    diags: Diagnostics,
    file: str | None = None,
) -> None:
    """Validate one fault schedule against the declared topology.

    ``schedule_src`` is whatever the driver accepts (path / JSON text /
    dict / FaultSchedule); ``topo`` the :class:`~tpusim_torch.ici.topology.
    Topology` the trace declares.  ``file`` anchors diagnostics."""
    from tpusim_torch.faults import (
        FaultScheduleError, load_fault_schedule,
    )

    try:
        sched = load_fault_schedule(schedule_src)
    except FaultScheduleError as e:
        diags.emit("TL201", str(e), file=file)
        return
    try:
        state = sched.bind(topo)
    except FaultScheduleError as e:
        dims = "x".join(str(d) for d in topo.dims)
        diags.emit(
            "TL202",
            f"{e} (declared topology: {dims} torus, "
            f"{topo.num_chips} chips)",
            file=file,
        )
        return

    from tpusim_torch.faults.schedule import _DCN_KINDS, FAULT_KINDS

    bound = state.bound_faults()
    for i, (fault, where) in enumerate(bound):
        if fault.scale == 1.0 and FAULT_KINDS[fault.kind] is not None:
            diags.emit(
                "TL204",
                f"fault[{i}]: {fault.kind} with scale 1.0 has no "
                f"effect — drop it or lower the scale",
                file=file,
            )
    by_entity: dict[tuple, list[tuple[int, object, frozenset]]] = {}
    for i, (fault, where) in enumerate(bound):
        if fault.kind == "dcn_link_down":
            # each record is a DISTINCT NIC of the slice — overlapping
            # records stack by design (k NICs down), never a conflict
            continue
        by_entity.setdefault(_entity_key(fault, where), []).append(
            (i, fault, _directions(fault, where))
        )
    for key, entries in sorted(by_entity.items()):
        for a in range(len(entries)):
            for b in range(a + 1, len(entries)):
                i, fa, da = entries[a]
                j, fb, db = entries[b]
                if not fa.overlaps(fb):
                    continue
                if da and db and not (da & db):
                    # opposite directions of the same cable are two
                    # physical links — no stacking
                    continue
                if key[0] == "link":
                    what = f"link {key[1]}"
                elif key[0] in _DCN_KINDS:
                    what = f"{key[0]} on slice {key[1]}"
                else:
                    what = f"{key[0]} on chip {key[1]}"
                diags.emit(
                    "TL203",
                    f"fault[{i}] and fault[{j}] overlap on {what} "
                    f"(windows [{fa.start_cycle:g}, {fa.end_cycle:g}) "
                    f"and [{fb.start_cycle:g}, {fb.end_cycle:g})) — "
                    f"scales multiply / dead wins; if unintended, "
                    f"split the windows",
                    file=file,
                )
