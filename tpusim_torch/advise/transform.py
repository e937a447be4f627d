"""The strategy-transform layer — ``tpusim_torch.advise``'s core machinery.

Turns ONE traced workload into a priceable synthetic pod per
(mesh, strategy) cell, reusing the existing IR, engine, and ICI model
rather than inventing a new representation:

1. **Profile** (:func:`build_profile`): walk the capture's entry module
   once and classify every collective op by the mesh axis its replica
   groups span — contiguous groups (stride 1) are the minor mesh axis
   (``tp`` by the JAX ``('data', 'model')`` row-major convention),
   strided groups the major axis (``dp``), all-to-alls the expert axis
   (``ep``).  A single contiguous axis spanning the whole pod is
   classified ``dp`` (gradient sync is the only collective pure data
   parallelism emits).  Each site records its capture payload; the
   capture mesh (dp0 x tp0) falls out of the axis sizes.

2. **Per-chip op shapes** (:func:`scaled_module`): clone the module
   with every tensor's largest dimension scaled by the cell's per-chip
   element factor (``chips0 / (chips * microbatches)``) and the
   captured collectives stripped to free ops.  The engine then prices
   the cell's REAL per-chip shapes — fill/drain latencies, small-kernel
   floors, and roofline crossovers all move with the sharding, which a
   "divide the time by N" estimate cannot see.  The clone is
   collective-free, so the perf-cache key has no topology component:
   every cell with the same per-chip scale shares one engine walk.

3. **Collective synthesis** (:func:`build_cell_pod`): emit the
   strategy's implied collective set as standalone ``COLLECTIVE``
   commands on the target torus — the MULTICHIP dryrun conventions:

   * ``tp``  — every tp-role site re-emitted with group size tp and
     the activation payload scaled by the batch shard (dp0/dp·sp);
   * ``dp``  — every dp-role site (the gradient all-reduces) re-emitted
     with group size dp and payload scaled by tp0/tp (tp shards grads);
   * ``sp``  — ring attention: each tp-role site becomes a ring of
     ``sp - 1`` collective-permutes of the sequence-sharded block,
     plus one full-gradient all-reduce over the pod (params are
     replicated across sp);
   * ``pp``  — pipeline: the module is split into ``microbatches``
     launches per stage with a boundary-activation collective-permute
     between stage neighbors per microbatch; the driver's rendezvous
     (k-th collective over a group aligns across its members)
     reproduces the fill/drain bubble with no new scheduling code;
   * ``ep``  — every ep-role (all-to-all) site re-emitted with group
     size ep; cells are skipped when the capture has no expert
     structure to re-shard.

   The commands price through :mod:`tpusim_torch.ici.collectives` inside the
   ordinary :class:`~tpusim_torch.sim.driver.SimDriver` replay — same
   rendezvous, same torus, same fault-free analytic schedules as any
   stored trace.

The transform is pure and deterministic: a fixed (capture, cell) pair
produces byte-identical pods, which is what makes fixed-spec advise
reports CI-enforceable.

Port of ``tpusim/advise/transform.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from tpusim_torch.ir import (
    CollectiveInfo,
    CommandKind,
    Computation,
    ModuleTrace,
    PodTrace,
    TensorSpec,
    TraceCommand,
    TraceOp,
    TupleSpec,
)

__all__ = [
    "CollectiveSite",
    "TRANSFORM_VERSION",
    "WorkloadProfile",
    "build_cell_pod",
    "build_profile",
    "scaled_module",
]

#: bumped when the transform's output changes for the same input — part
#: of the synthetic modules' content hash, so stale engine-cache records
#: orphan instead of cross-serving
TRANSFORM_VERSION = 1


# ---------------------------------------------------------------------------
# Profile
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectiveSite:
    """One collective op of the capture, classified by mesh role."""

    name: str            # capture op name (kept for report provenance)
    kind: str            # base opcode: all-reduce / all-to-all / ...
    role: str            # "tp" | "dp" | "ep"
    payload_bytes: int   # per-chip payload at capture


@dataclass(frozen=True)
class WorkloadProfile:
    """Everything the transform needs from one capture, extracted once."""

    module_name: str
    chips0: int          # capture pod size
    dp0: int             # capture data-parallel degree
    tp0: int             # capture tensor-parallel degree
    sites: tuple[CollectiveSite, ...]
    param_bytes_total: int    # full (unsharded) parameter/gradient bytes
    act_boundary_bytes: int   # largest tp-site payload (pipeline boundary)
    capture_fp: str           # capture-module content fingerprint

    @property
    def tp_sites(self) -> tuple[CollectiveSite, ...]:
        return tuple(s for s in self.sites if s.role == "tp")

    @property
    def dp_sites(self) -> tuple[CollectiveSite, ...]:
        return tuple(s for s in self.sites if s.role == "dp")

    @property
    def ep_sites(self) -> tuple[CollectiveSite, ...]:
        return tuple(s for s in self.sites if s.role == "ep")


def _group_stride(groups: tuple[tuple[int, ...], ...]) -> int:
    """Member stride of the first multi-member group (1 = contiguous)."""
    for g in groups:
        if len(g) >= 2:
            return g[1] - g[0]
    return 1


def build_profile(pod: PodTrace, module_name: str | None = None) \
        -> WorkloadProfile:
    """Profile one capture: pick its largest module, classify the
    collective sites by mesh role, and recover the capture mesh."""
    if not pod.modules:
        raise ValueError("advise: trace has no modules to profile")
    if module_name is None:
        module_name = max(
            sorted(pod.modules),
            key=lambda n: sum(
                len(c.ops) for c in pod.modules[n].computations.values()
            ),
        )
    module = pod.modules[module_name]
    chips0 = max(
        int(pod.meta.get("num_devices", 0) or 0),
        module.num_devices,
        len(pod.devices) or 1,
    )

    sites: list[CollectiveSite] = []
    axis_sizes: dict[str, int] = {}
    for op in module.collectives():
        info = op.collective
        if info is None:
            continue
        groups = info.replica_groups
        size = info.group_size
        if size <= 1:
            continue
        if op.base in ("all-to-all", "ragged-all-to-all"):
            role = "ep"
        elif not groups:
            # no groups recorded: every chip participates -> gradient
            # sync over the whole (data-parallel) pod
            role = "dp"
        elif _group_stride(groups) > 1:
            role = "dp"
        elif size >= chips0:
            # one contiguous axis spanning the pod: pure dp capture
            role = "dp"
        else:
            role = "tp"
        sites.append(CollectiveSite(
            name=op.name, kind=op.base, role=role,
            payload_bytes=int(op.result.nbytes),
        ))
        axis_sizes[role] = max(axis_sizes.get(role, 1), size)

    tp0 = axis_sizes.get("tp", 1)
    dp0 = axis_sizes.get("dp", 0) or max(chips0 // max(tp0, 1), 1)
    dp_payload = sum(s.payload_bytes for s in sites if s.role == "dp")
    if dp_payload:
        # the gradient all-reduce moves params/tp0 per chip: undo the
        # capture's tp shard to recover the full parameter footprint
        param_total = dp_payload * tp0
    else:
        param_total = sum(
            p.result.nbytes for p in module.entry.parameters
        ) if module.entry_name else 0
    act_boundary = max(
        (s.payload_bytes for s in sites if s.role == "tp"), default=0,
    )
    if act_boundary == 0 and module.entry_name:
        act_boundary = int(module.entry.root.result.nbytes)

    from tpusim_torch.perf.cache import module_fingerprint

    fp = module_fingerprint(module) or module_name
    return WorkloadProfile(
        module_name=module_name, chips0=chips0, dp0=dp0, tp0=tp0,
        sites=tuple(sites), param_bytes_total=int(param_total),
        act_boundary_bytes=int(act_boundary), capture_fp=fp,
    )


# ---------------------------------------------------------------------------
# Per-chip op shapes
# ---------------------------------------------------------------------------


def _scale_spec(spec, factor: float):
    """Scale a shape's largest dimension by ``factor`` (recursing into
    tuples).  Per-chip ELEMENT COUNTS drive the roofline; the largest
    dim is the one real shardings split (batch/seq on activations, the
    model dim on weights), and scaling exactly one dim keeps every
    other dim — and the shape's rank/layout — intact."""
    if isinstance(spec, TupleSpec):
        return TupleSpec(parts=tuple(
            _scale_spec(p, factor) for p in spec.parts
        ))
    if not isinstance(spec, TensorSpec) or not spec.shape or factor == 1.0:
        return spec
    dims = list(spec.shape)
    i = max(range(len(dims)), key=lambda j: dims[j])
    dims[i] = max(1, int(round(dims[i] * factor)))
    return TensorSpec(
        dtype=spec.dtype, shape=tuple(dims), layout=spec.layout,
        tiling=spec.tiling, memory_space=spec.memory_space,
    )


def scaled_module(
    module: ModuleTrace,
    elem_factor: float,
    name: str,
    capture_fp: str,
) -> ModuleTrace:
    """Collective-free clone of ``module`` with per-chip shapes scaled
    by ``elem_factor``.

    Collective ops (async halves included) become ``bitcast`` — free at
    schedule time, def-use chain intact — because the cell's collective
    set is synthesized as standalone commands by
    :func:`build_cell_pod`; leaving the captured ones in would double-
    price the interconnect under the capture's mesh instead of the
    cell's.  The clone stamps a content hash derived from (capture
    fingerprint, transform version, factor), so the perf cache shares
    engine walks across every cell with the same per-chip shapes and
    invalidates whenever the transform itself changes."""
    out = ModuleTrace(name=name)
    for cname, comp in module.computations.items():
        clone = Computation(name=cname, is_entry=comp.is_entry)
        for op in comp.ops:
            strip = op.is_collective
            clone.add(TraceOp(
                name=op.name,
                opcode="bitcast" if strip else op.opcode,
                result=_scale_spec(op.result, elem_factor),
                operands=op.operands,
                called=() if strip else op.called,
                fusion_kind=op.fusion_kind,
                collective=None if strip else op.collective,
                attrs=op.attrs,
                metadata=op.metadata,
                is_root=op.is_root,
            ))
        out.add_computation(clone)
    out.entry_name = module.entry_name
    platform = str(module.meta.get("platform", "")) if module.meta else ""
    out.meta = {
        # the cost model's capture-backend dtype normalization keys on
        # the platform; the synthetic module inherits the capture's
        "platform": platform,
        "device_kind": str(module.meta.get("device_kind", "")),
        # per-chip program: one partition, one replica — the CELL pod
        # meta declares the device count, not the module
        "num_partitions": 1,
        "replica_count": 1,
        "content_hash": hashlib.sha256(
            f"{capture_fp}|advise-t{TRANSFORM_VERSION}|"
            f"{elem_factor!r}".encode()
        ).hexdigest()[:24],
    }
    return out


# ---------------------------------------------------------------------------
# Collective synthesis
# ---------------------------------------------------------------------------


def _tp_groups(chips: int, tp: int) -> tuple[tuple[int, ...], ...]:
    """Minor-axis groups: contiguous blocks of ``tp`` chip ids."""
    return tuple(
        tuple(range(j * tp, (j + 1) * tp)) for j in range(chips // tp)
    )


def _dp_groups(chips: int, dp: int, tp: int) -> tuple[tuple[int, ...], ...]:
    """Major-axis groups: stride-``tp`` combs of ``dp`` chip ids."""
    return tuple(
        tuple(r + k * tp for k in range(dp)) for r in range(tp)
    )


def _coll_cmd(device: int, kind: str, nbytes: int, groups,
              pairs=()) -> TraceCommand:
    return TraceCommand(
        kind=CommandKind.COLLECTIVE,
        device_id=device,
        nbytes=max(int(nbytes), 1),
        collective=CollectiveInfo(
            kind=kind,
            replica_groups=tuple(tuple(g) for g in groups),
            source_target_pairs=tuple(pairs),
        ),
    )


def build_cell_pod(
    profile: WorkloadProfile,
    compute: ModuleTrace,
    chips: int,
    degrees: dict[str, int],
    launches: int = 1,
) -> PodTrace:
    """Assemble the synthetic pod for one cell: ``launches`` kernel
    launches of the scaled compute module per chip, plus the strategy's
    synthesized collective commands (see the module docstring for the
    per-strategy conventions)."""
    dp = degrees.get("dp", 1)
    tp = degrees.get("tp", 1)
    sp = degrees.get("sp", 1)
    pp = degrees.get("pp", 1)
    ep = degrees.get("ep", 1)
    # activations shard with the batch/sequence axes; tp replicates them
    act_scale = profile.dp0 / max(dp * sp, 1)
    grad_scale = profile.tp0 / max(tp, 1)

    pod = PodTrace(meta={"num_devices": chips})
    pod.modules[compute.name] = compute

    if pp > 1:
        return _build_pipeline_pod(
            pod, profile, compute, chips, dp, tp, pp, launches,
            act_scale, grad_scale,
        )

    # all group/ring structures are loop-invariant: build them once,
    # not once per device (chips is request-controlled via /v1/advise,
    # so per-device rebuilds would make this O(chips^2))
    tp_groups = _tp_groups(chips, tp) if tp > 1 else ()
    ep_groups = _tp_groups(chips, ep) if ep > 1 else ()
    sp_groups: tuple[tuple[int, ...], ...] = ()
    sp_pairs: tuple[tuple[int, int], ...] = ()
    if sp > 1:
        # one sp subring per dp replica (layout: dp major, sp minor;
        # the supported-combination guard in the runner keeps tp/ep
        # out of sp meshes).  Every subring rotates concurrently —
        # one permute command carries all pairs, and each device's
        # rendezvous group is its own subring.
        sp_groups = tuple(
            tuple(range(b * sp, (b + 1) * sp)) for b in range(dp)
        )
        sp_pairs = tuple(
            (b * sp + i, b * sp + (i + 1) % sp)
            for b in range(dp) for i in range(sp)
        )
    dp_groups: tuple[tuple[int, ...], ...] = ()
    if dp > 1 and sp <= 1:
        # dp peers share their minor-axis coordinate; the minor axis is
        # whichever model axis the cell shards (tp or ep — never both,
        # per the supported-combination guard)
        dp_groups = _dp_groups(chips, dp, max(tp, ep))
    all_chips = (tuple(range(chips)),)

    for d in range(chips):
        dev = pod.device(d)
        for _ in range(launches):
            dev.commands.append(TraceCommand(
                kind=CommandKind.KERNEL_LAUNCH, device_id=d,
                module=compute.name,
            ))
        if tp > 1:
            for site in profile.tp_sites:
                dev.commands.append(_coll_cmd(
                    d, site.kind, site.payload_bytes * act_scale,
                    tp_groups,
                ))
        if sp > 1:
            # ring attention: rotate the sequence-sharded block around
            # each sp subring once per tp-role site (the per-layer
            # sync points of the capture), sp - 1 hops per rotation;
            # the block is the cell's per-chip activation (act_scale
            # already folds both the dp and sp shards)
            for site in profile.tp_sites:
                block = site.payload_bytes * act_scale
                for _ in range(sp - 1):
                    dev.commands.append(_coll_cmd(
                        d, "collective-permute", block,
                        groups=sp_groups, pairs=sp_pairs,
                    ))
        if ep > 1:
            for site in profile.ep_sites:
                dev.commands.append(_coll_cmd(
                    d, site.kind, site.payload_bytes * act_scale,
                    ep_groups,
                ))
        if sp > 1 and profile.dp_sites:
            # params are replicated across BOTH the sp ring and any dp
            # axis: gradient sync spans the whole pod at the full
            # (tp0-unsharded) payload
            for site in profile.dp_sites:
                dev.commands.append(_coll_cmd(
                    d, site.kind, site.payload_bytes * grad_scale,
                    all_chips,
                ))
        elif dp > 1:
            for site in profile.dp_sites:
                dev.commands.append(_coll_cmd(
                    d, site.kind, site.payload_bytes * grad_scale,
                    dp_groups,
                ))
    return pod


def _build_pipeline_pod(
    pod: PodTrace,
    profile: WorkloadProfile,
    compute: ModuleTrace,
    chips: int,
    dp: int,
    tp: int,
    pp: int,
    microbatches: int,
    act_scale: float,
    grad_scale: float,
) -> PodTrace:
    """Pipeline streams, composable with dp/tp axes.

    Chip layout (minor to major): ``id = (dp_idx * pp + stage) * tp +
    tp_idx`` — tp groups stay contiguous blocks, the stage neighbor of
    a chip sits ``tp`` ids away, and dp peers sit ``pp * tp`` apart.

    Stage ``s`` runs every microbatch through its layer shard and
    hands the boundary activation to stage ``s + 1`` as a
    collective-permute.  The driver's rendezvous (the k-th collective
    over a group aligns across its members) makes stage s+1's m-th
    launch wait for stage s's m-th hand-off — the fill/drain bubble
    emerges from the ordinary replay semantics.  The capture's tp-role
    sites split round-robin across stages (a stage owns 1/pp of the
    layers), re-emitted per microbatch at 1/microbatches payload; the
    dp gradient sync covers each stage's parameter shard."""
    m_count = max(microbatches, 1)
    boundary = max(
        int(profile.act_boundary_bytes * act_scale / m_count), 1,
    )
    tp_groups = _tp_groups(chips, tp) if tp > 1 else ()

    for d in range(chips):
        dev = pod.device(d)
        stage = (d // tp) % pp
        # this stage's share of the capture's per-layer sync points
        stage_sites = tuple(
            s for i, s in enumerate(profile.tp_sites) if i % pp == stage
        )
        prev_peer = d - tp   # stage - 1, same dp/tp coordinates
        next_peer = d + tp
        for _m in range(m_count):
            if stage > 0:
                dev.commands.append(_coll_cmd(
                    d, "collective-permute", boundary,
                    groups=((prev_peer, d),), pairs=((prev_peer, d),),
                ))
            dev.commands.append(TraceCommand(
                kind=CommandKind.KERNEL_LAUNCH, device_id=d,
                module=compute.name,
            ))
            if tp > 1:
                for site in stage_sites:
                    dev.commands.append(_coll_cmd(
                        d, site.kind,
                        site.payload_bytes * act_scale / m_count,
                        tp_groups,
                    ))
            if stage < pp - 1:
                dev.commands.append(_coll_cmd(
                    d, "collective-permute", boundary,
                    groups=((d, next_peer),), pairs=((d, next_peer),),
                ))
        if dp > 1 and profile.dp_sites:
            # gradient sync over this stage's parameter shard: peers
            # share (stage, tp_idx), spaced pp * tp ids apart
            groups = tuple(
                tuple(
                    (k * pp + s_) * tp + t_
                    for k in range(dp)
                )
                for s_ in range(pp) for t_ in range(tp)
            )
            for site in profile.dp_sites:
                dev.commands.append(_coll_cmd(
                    d, site.kind,
                    site.payload_bytes * grad_scale / pp, groups,
                ))
    return pod
