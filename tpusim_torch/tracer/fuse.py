"""Fusion pass over a lowered module — the stand-in for what XLA's
pipeline does to the JAX package's capture.

Over the entry computation and every loop body:

* a chain of elementwise ops fuses with its broadcasts, converts,
  reshapes (bitcasts), transposes, slices and constants into one
  ``fusion(...)``, ``kind=kLoop``, ``calls=%fused_computation.N``;
* a ``reduce`` becomes the root of a ``kind=kInput`` fusion with its
  elementwise producers (a reduce is never fused into a consumer);
* ``dot``, ``convolution``, ``gather``, ``scatter``,
  ``dynamic-update-slice``, ``while``, ``custom-call``, the collectives,
  ``partition-id``, tuples and parameters stay top level, as on the JAX
  package's traces;
* a producer with more than one user is fused into none of them, except
  scalar constants and broadcasts of them, which are copied into every
  fusion that reads them;
* scalar arithmetic stays unfused, so a loop body's induction step stays
  the ``add(iv, 1)`` that loop analysis reads.

What the pass decides is the HBM traffic the cost model charges: a fused
chain reads its inputs and writes its root once.  The TPU's ``kOutput``
fusion of a dot with its epilogue is not made here (ROADMAP A5).
"""

from __future__ import annotations

from tpusim_torch.tracer.hlo_ir import Array, Computation, HloModule, Instr

__all__ = ["fuse_module", "fuse_computation", "FUSIBLE"]

#: ops that fuse into a consumer's fusion
FUSIBLE = frozenset({
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "power",
    "exponential", "tanh", "logistic", "negate", "abs", "sqrt", "rsqrt",
    "log", "erf", "sine", "cosine", "remainder", "and", "or", "not",
    "compare", "select", "convert",
    "broadcast", "bitcast", "constant", "iota", "transpose", "slice",
    "concatenate", "dynamic-slice", "pad", "reverse",
})

#: ops that carry no work of their own
_FREE = frozenset({"bitcast", "constant"})


def _const_like(instr: Instr, idx: dict[str, Instr]) -> bool:
    """A scalar constant, or a broadcast of one: copied, never shared."""
    if instr.opcode == "constant":
        return isinstance(instr.shape, Array) and not instr.shape.dims
    if instr.opcode == "broadcast" and len(instr.operands) == 1:
        return _const_like(idx[instr.operands[0]], idx)
    return False


def fuse_computation(module: HloModule, comp: Computation) -> None:
    idx = comp.index()
    users = comp.users()
    group: dict[str, int] = {}
    members: dict[int, list[str]] = {}
    for instr in reversed(comp.instrs):
        op = instr.opcode
        if (op not in FUSIBLE and op != "reduce") or _const_like(instr, idx):
            continue
        us = users[instr.name]
        if op != "reduce" and len(us) == 1 and us[0] in group:
            g = group[us[0]]
        else:
            g = len(members)
            members[g] = []
        group[instr.name] = g
        members[g].append(instr.name)

    order = {i.name: k for k, i in enumerate(comp.instrs)}
    replaced: dict[str, Instr] = {}     # group root → fusion instruction
    moved: set[str] = set()
    for g, names in members.items():
        names.sort(key=order.get)
        inside = set(names)
        root = idx[names[-1]]
        ext: list[str] = []
        clones: list[str] = []

        def need(o: str) -> None:
            if o in inside or o in ext or o in clones:
                return
            if _const_like(idx[o], idx):
                for p in idx[o].operands:
                    need(p)
                clones.append(o)
            else:
                ext.append(o)

        for n in names:
            for o in idx[n].operands:
                need(o)
        work = [n for n in names if idx[n].opcode not in _FREE]
        if (not work or len(names) + len(clones) < 2
                or all(not idx[n].shape.dims for n in names + ext)):
            # scalar arithmetic (a loop's induction step among it) stays
            # plain, so loop analysis reads the step
            continue
        fc = module.new_computation("fused_computation")
        rename: dict[str, str] = {}
        for k, o in enumerate(ext):
            p = module.fresh(f"param_{k}")
            fc.add(Instr(p, idx[o].shape, "parameter", arg=str(k)))
            rename[o] = p
        for o in sorted(clones, key=order.get):
            c = idx[o]
            rename[o] = module.fresh(o)
            fc.add(Instr(rename[o], c.shape, c.opcode,
                         [rename[x] for x in c.operands], list(c.attrs),
                         c.arg))
        rename[root.name] = module.fresh(root.name)
        for n in names:
            m = idx[n]
            fc.add(Instr(rename.get(n, n), m.shape, m.opcode,
                         [rename.get(x, x) for x in m.operands],
                         list(m.attrs), m.arg))
        fc.root = rename[root.name]
        kind = "kInput" if root.opcode == "reduce" else "kLoop"
        replaced[root.name] = Instr(root.name, root.shape, "fusion", ext,
                                    [f"kind={kind}", f"calls=%{fc.name}"])
        moved.update(names[:-1])
        for n in names[:-1]:
            module.fused[n] = root.name
    comp.instrs = [replaced.get(i.name, i) for i in comp.instrs
                   if i.name not in moved]
    comp.remove_dead()


def fuse_module(module: HloModule) -> None:
    """Fuse the entry computation and every loop body."""
    for comp in list(module.computations):
        if comp.fusible:
            fuse_computation(module, comp)
