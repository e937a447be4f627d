"""Collective-matching passes (TL41x): static cross-device deadlock
detection over a multi-device command stream.

A multi-device trace carries one command stream per device.  Standalone
collectives only complete when **every member of their replica group
issues a matching collective** — the runtime blocks each participant
until the rendezvous.  The Accel-Sim lineage discovers a broken
rendezvous as a simulation that never terminates; a fleet should refuse
the trace statically.  Aligning the per-device streams head-of-line
per replica group finds the four hang shapes:

* **TL410** — participants issue *different collective kinds* at the
  matching position (device 0 waits in an all-reduce, device 1 in an
  all-gather: both block forever);
* **TL411** — participants disagree on the *replica groups* of the
  matched collective (inconsistent group partitioning or ordering
  across members — each side waits for a rendezvous the other side
  never forms);
* **TL412** — a device in the group **never issues** the collective its
  peers are blocked on (its stream ends first: the group waits
  forever);
* **TL413** — matched participants disagree on the **byte count**
  (a size mismatch corrupts or wedges the transfer; the sim would
  price a number that is wrong on every real runtime).

Single-device captures are exempt by construction: a trace whose
commandlist carries only one device's stream is the normal
trace-one-replay-many SPMD capture (the driver replays it analytically
on the declared pod), so there are no peer streams to align.  Members
of a group that issue no commands at all are likewise skipped — a
partial capture of a wider pod is legal; only a device that *has* a
stream and leaves its group waiting is a hang.

The matcher stops at the first mismatched group: everything after a
broken rendezvous is speculative (the pod never gets there), and
cascading reports would bury the root cause.

Port of ``tpusim/analysis/collective_passes.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["run_collective_matching"]


@dataclass(frozen=True)
class _Issue:
    """One standalone collective issue in a device's stream."""

    device: int
    seq: int                 # position among this device's collectives
    kind: str
    groups: tuple[tuple[int, ...], ...]
    nbytes: int
    line: int                # commandlist.jsonl anchor


def _issue_group(issue: _Issue, present: frozenset[int]) -> tuple[int, ...]:
    """The participant set this issue rendezvouses with: the replica
    group containing the issuer (restricted to devices that actually
    carry a stream), or — groupless collectives — every present
    device."""
    for g in issue.groups:
        if issue.device in g:
            return tuple(sorted(set(g) & present))
    if issue.groups:
        return ()  # issuer outside its own groups: TL009's problem
    return tuple(sorted(present))


def run_collective_matching(pt, diags: Diagnostics) -> None:
    """Align the per-device standalone-collective streams of ``pt``
    (a :class:`~tpusim_torch.analysis.trace_passes.ParsedTrace`) and report
    the TL41x hang shapes."""
    streams: dict[int, list[_Issue]] = {}
    devices_with_commands: set[int] = set()
    for lineno, rec, err in pt.commands:
        if err is not None:
            continue
        device = rec.get("device", 0)
        if not isinstance(device, int) or isinstance(device, bool):
            continue
        devices_with_commands.add(device)
        if rec.get("kind") != "collective":
            continue
        coll = rec.get("collective") or {}
        groups = tuple(
            tuple(int(m) for m in g)
            for g in coll.get("replica_groups", []) or []
            if isinstance(g, (list, tuple))
        )
        q = streams.setdefault(device, [])
        q.append(_Issue(
            device=device,
            seq=len(q),
            kind=str(coll.get("kind", "?")),
            groups=groups,
            nbytes=int(rec.get("bytes", 0) or 0),
            line=lineno,
        ))
    if len(devices_with_commands) < 2 or not streams:
        return  # single-device capture: no peer streams to align

    present = frozenset(devices_with_commands)
    heads = {d: 0 for d in streams}

    def head(d: int) -> _Issue | None:
        q = streams.get(d)
        if q is None:
            return None
        i = heads.get(d, 0)
        return q[i] if i < len(q) else None

    def try_match(lead: _Issue):
        """Attempt the rendezvous ``lead`` waits on.  Returns
        ``("skip",)`` (malformed membership: consume the issue),
        ``("ok", matched)`` when every member's head agrees, or
        ``("diag", code, message)`` describing why THIS group is
        stuck.  A stuck group is only a hang when no other group can
        progress either — staggered disjoint groups legally complete
        in any order, so the caller reports nothing until the whole
        pod stalls."""
        group = _issue_group(lead, present)
        if lead.device not in group:
            # issuer outside every one of its own replica groups —
            # malformed membership is TL009's report; consuming the
            # issue keeps the walk making progress
            return ("skip",)
        matched: list[_Issue] = []
        for member in group:
            if member not in streams:
                return ("diag", "TL412",
                        f"device {member} has a command stream but "
                        f"never issues a collective; its group "
                        f"{list(group)} blocks forever on {lead.kind} "
                        f"#{lead.seq} issued by device {lead.device}")
            h = head(member)
            if h is None:
                return ("diag", "TL412",
                        f"device {member}'s collective stream ends "
                        f"after {heads[member]} matched "
                        f"collective(s); its group {list(group)} "
                        f"blocks forever on {lead.kind} #{lead.seq} "
                        f"issued by device {lead.device}")
            if h.kind != lead.kind:
                return ("diag", "TL410",
                        f"mismatched collective sequence: device "
                        f"{lead.device} issues {lead.kind} "
                        f"(collective #{lead.seq}) while group member "
                        f"{member} issues {h.kind} at its matching "
                        f"position (line {h.line}) — both block "
                        f"forever")
            if h.groups != lead.groups:
                same_sets = (
                    {frozenset(g) for g in h.groups}
                    == {frozenset(g) for g in lead.groups}
                )
                detail = (
                    "orders its replica groups differently"
                    if same_sets else
                    "declares different replica groups"
                )
                return ("diag", "TL411",
                        f"inconsistent replica groups: device "
                        f"{lead.device}'s {lead.kind} declares "
                        f"{[list(g) for g in lead.groups]} but group "
                        f"member {member} {detail} "
                        f"({[list(g) for g in h.groups]}, line "
                        f"{h.line}) — the rendezvous never forms")
            matched.append(h)
        if len({h.nbytes for h in matched}) > 1:
            per_dev = ", ".join(
                f"device {h.device}={h.nbytes}" for h in matched
            )
            return ("diag", "TL413",
                    f"byte-count disagreement on matched {lead.kind} "
                    f"(collective #{lead.seq} of group {list(group)}): "
                    f"{per_dev}")
        return ("ok", matched)

    while True:
        stuck: tuple[str, str, int] | None = None
        progressed = False
        exhausted = True
        for d in sorted(streams):
            lead = head(d)
            if lead is None:
                continue
            exhausted = False
            got = try_match(lead)
            if got[0] == "skip":
                heads[d] += 1
                progressed = True
                break
            if got[0] == "ok":
                for h in got[1]:
                    heads[h.device] += 1
                progressed = True
                break
            if stuck is None:
                stuck = (got[1], got[2], lead.line)
        if exhausted:
            return  # every stream fully matched
        if not progressed:
            # no group in the whole pod can rendezvous: a real stall,
            # reported once from the lowest-device head (cascades past
            # a broken rendezvous are speculative — the pod never
            # gets there)
            code, message, line = stuck
            diags.emit(
                code, message, file="commandlist.jsonl", line=line,
            )
            return
