"""One process a rank: the runner of a multi-device workload whose ranks
lie on devices of their own.

The JAX package places one shard on each chip of ``Mesh(jax.devices()
[:n])`` and XLA runs them; the port's counterpart is a
:class:`RankGroup`: one process a rank, started with the ``spawn``
method (a fresh interpreter, never a fork: a child forked after CUDA must
not touch ``torch.cuda``), each with one intra-op thread, joined in a
``torch.distributed`` process group.  In each process the workload's
program runs eagerly over the rank's own shards, and every collective
custom op of :mod:`tpusim_torch.spmd` runs on ``torch.distributed``
(:class:`~tpusim_torch.spmd.RankContext`).

The backend follows from the devices, with no knob: ``nccl`` when every
rank has a CUDA device of its own; ``gloo`` otherwise (ranks sharing a
card, or on the CPU), each collective staged through host memory.  The
rendezvous is a ``FileStore`` in a temporary directory of the group's
own, so groups started at once never meet.

The parent builds the global arguments once, sends each rank its shards
(:func:`~tpusim_torch.spmd.local_shard`), and reassembles the outputs
with :func:`~tpusim_torch.spmd.unshard`, whose replica check stays.  A
rank's exception reaches the parent with the rank's traceback
(:class:`RankFailure`); a rank that does not answer within the group's
``timeout`` is killed, not waited on; either way every process of the
group is ended.

:func:`ranks_for` is what the capture and the live probes ask: a group
with a rank on each of ``cuda:0`` … ``cuda:N-1`` when the arguments lie
on a card and the host has at least as many cards as the mesh has ranks
(the reference's ``jax.devices()[:n]``), else no group (the vmap runner,
:func:`~tpusim_torch.spmd.run_ranks`, every rank on one device).
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from tpusim_torch.spmd import (
    Mesh, RankContext, SpmdModule, local_shard, rank_context, unshard,
)

__all__ = ["Rank", "RankFailure", "RankGroup", "backend_for", "every_rank",
           "ranks_for", "runner_text"]


class RankFailure(RuntimeError):
    """A rank raised, died or did not answer; its group is ended."""


@dataclass(frozen=True)
class Rank:
    """What a task learns of the rank it runs as."""

    rank: int
    world: int
    device: torch.device
    backend: str


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


def backend_for(devices: Sequence) -> str:
    """``nccl`` when every rank has a CUDA device of its own, else
    ``gloo``."""
    devs = [_device(d) for d in devices]
    own = len({d.index for d in devs}) == len(devs)
    return "nccl" if own and all(d.type == "cuda" for d in devs) else "gloo"


def _moved(tree: Any, device) -> Any:
    """Every tensor of a tuple / list / dict tree on ``device``
    (detached)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moved(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree


#: messages larger than this go through a file in the group's directory
_INLINE_BYTES = 1 << 20


@dataclass(frozen=True)
class _Spooled:
    """A message left in a file: the pipe carries only its path."""

    path: str


def _send(conn, obj, spool: str | None = None) -> None:
    """Send ``obj`` pickled (tensors travel as bytes, not through shared
    memory).  A large message is written to a file in ``spool`` and only
    its path crosses the pipe (through the pipe, a 151 MB message took
    12 s on an H100 host)."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if spool is not None and len(data) > _INLINE_BYTES:
        fd, path = tempfile.mkstemp(dir=spool, suffix=".pkl")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        data = pickle.dumps(_Spooled(path))
    conn.send_bytes(data)


def _recv(conn):
    obj = pickle.loads(conn.recv_bytes())
    if isinstance(obj, _Spooled):
        with open(obj.path, "rb") as f:
            data = f.read()
        os.unlink(obj.path)
        obj = pickle.loads(data)
    return obj


def barrier(rank: Rank) -> None:
    """A barrier over the group (NCCL's on the rank's own card)."""
    import torch.distributed as dist

    if rank.backend == "nccl":
        dist.barrier(device_ids=[rank.device.index])
    else:
        dist.barrier()


def every_rank(rank: Rank, flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of the group (a collective:
    every rank calls it at the same point of its task)."""
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=rank.device if
                     rank.backend == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _rank_main(rank: int, devices: tuple, store: str, conn,
               timeout_s: float) -> None:
    """A rank process: join the group, then run the parent's tasks
    (``(task, args)``, ``task(Rank, *args)`` with the args on the rank's
    device) until it sends None or goes away."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    # every rank lies on this host: bootstrap over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    world, dev = len(devices), devices[rank]
    backend = backend_for(devices)
    spool = os.path.dirname(store)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            # the context now, while the group starts, not at the first task
            torch.zeros(1, device=dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:
        _send(conn, ("err", traceback.format_exc()))
        return
    info = Rank(rank, world, dev, backend)
    ctx = RankContext(rank, world, staged=backend != "nccl")
    _send(conn, ("ok", None))
    try:
        while True:
            try:
                msg = _recv(conn)
            except (EOFError, OSError):
                return
            if msg is None:
                return
            task, args = msg
            try:
                with rank_context(ctx):
                    reply = ("ok", _moved(task(info, *_moved(args, dev)),
                                          "cpu"))
            except Exception:
                reply = ("err", traceback.format_exc())
            if dev.type == "cuda":
                # ranks may share the card: keep no cached blocks between
                # tasks
                torch.cuda.empty_cache()
            _send(conn, reply, spool)
    finally:
        dist.destroy_process_group()


def _reap(procs: list, conns: list, tmp) -> None:
    """End every process of a group, at once."""
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)
    for c in conns:
        c.close()
    procs.clear()
    conns.clear()
    tmp.cleanup()


def _run_task(rank: Rank, fn: Callable, args: tuple, grad: bool):
    with torch.set_grad_enabled(grad):
        return fn(*args)


def _time_task(rank: Rank, fn: Callable, args: tuple, launches: int,
               warmup: int) -> list[float]:
    """Seconds of each launch on this rank: a barrier before each, then
    CUDA events on the card (the host clock on the CPU), the rank's work
    finished before the next barrier."""
    cuda = rank.device.type == "cuda"
    times, events = [], []
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        for _ in range(launches):
            if cuda:
                torch.cuda.synchronize(rank.device)
            barrier(rank)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                events.append((start, end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append(time.perf_counter() - t0)
    return [s.elapsed_time(e) / 1e3 for s, e in events] if cuda else times


class RankGroup:
    """A process group with one process a rank, rank ``r`` on
    ``devices[r]``; started at the first use (or :meth:`start`), ended by
    :meth:`close` (or leaving its ``with``).  ``timeout``: seconds a
    call's ranks have to answer."""

    def __init__(self, devices: Sequence, timeout: float = 600.0):
        if not devices:
            raise ValueError("a rank group needs at least one device")
        self.devices = tuple(_device(d) for d in devices)
        self.world = len(self.devices)
        self.backend = backend_for(self.devices)
        self.timeout = float(timeout)
        self._procs: list = []
        self._conns: list = []
        self._ready = False
        self._reaper = None

    def describe(self) -> str:
        devs = sorted({str(d) for d in self.devices})
        where = (f"{devs[0]} x{self.world}" if len(devs) == 1
                 else ", ".join(str(d) for d in self.devices))
        return f"{self.world} rank processes over {self.backend} on {where}"

    def start(self) -> "RankGroup":
        """Spawn the rank processes (they join the group while the caller
        goes on; the first call waits for them)."""
        if self._procs:
            return self
        ctx = multiprocessing.get_context("spawn")
        tmp = tempfile.TemporaryDirectory(prefix="tpusim_ranks_")
        store = os.path.join(tmp.name, "store")
        self._spool = tmp.name
        for r in range(self.world):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=_rank_main, name=f"tpusim-rank{r}",
                            args=(r, self.devices, store, theirs,
                                  self.timeout), daemon=True)
            p.start()
            theirs.close()
            self._procs.append(p)
            self._conns.append(mine)
        self._reaper = weakref.finalize(self, _reap, self._procs,
                                        self._conns, tmp)
        self._ready = False
        return self

    def close(self) -> None:
        """Ask every rank to leave, and end what does not."""
        if not self._procs:
            return
        for c in self._conns:
            with contextlib.suppress(OSError):
                _send(c, None)
        deadline = time.monotonic() + 10
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        self._reaper()

    def __enter__(self) -> "RankGroup":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def alive(self) -> list[int]:
        """Pids of the group's live processes."""
        return [p.pid for p in self._procs if p.is_alive()]

    def _fail(self, why: str):
        self._reaper()
        raise RankFailure(why)

    def _gather(self) -> list:
        """One reply from every rank: a rank's error, death or silence
        past the timeout ends the group and raises."""
        out: list = [None] * self.world
        pending = {c: r for r, c in enumerate(self._conns)}
        sentinels = {p.sentinel: r for r, p in enumerate(self._procs)}
        deadline = time.monotonic() + self.timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"ranks {sorted(pending.values())} of {self.world} "
                           f"did not answer within {self.timeout:g} s")
            ready = multiprocessing.connection.wait(
                [*pending, *sentinels], timeout=left)
            # replies first: a rank that raised and then died said why
            for conn in [c for c in ready if c in pending]:
                r = pending.pop(conn)
                sentinels.pop(self._procs[r].sentinel, None)
                try:
                    status, payload = _recv(conn)
                except (EOFError, OSError):
                    self._procs[r].join(timeout=5)
                    self._fail(f"rank {r} on {self.devices[r]} exited "
                               f"(code {self._procs[r].exitcode})")
                if status == "err":
                    self._fail(f"rank {r} of {self.world} on "
                               f"{self.devices[r]} raised:\n{payload}")
                out[r] = payload
            for s in [s for s in ready if s in sentinels]:
                r = sentinels[s]
                if r in pending.values():
                    self._fail(f"rank {r} on {self.devices[r]} exited "
                               f"(code {self._procs[r].exitcode})")
        return out

    def call(self, task: Callable, per_rank: Sequence[tuple]) -> list:
        """``task(Rank, *per_rank[r])`` on every rank ``r`` (tensors moved
        to the rank's device; ``task`` importable by name); the results,
        tensors on the CPU, by rank."""
        if len(per_rank) != self.world:
            raise ValueError(f"{len(per_rank)} argument sets for "
                             f"{self.world} ranks")
        self.start()
        if not self._ready:
            self._gather()
            self._ready = True
        for conn, args in zip(self._conns, per_rank):
            try:
                _send(conn, (task, tuple(args)), self._spool)
            except OSError:
                self._fail("a rank went away before its task was sent")
        return self._gather()

    def shards(self, mesh: Mesh, global_args, in_specs) -> list[tuple]:
        """Each rank's shards of the global arguments, dense, on the
        CPU (what :meth:`call` sends)."""
        if mesh.size != self.world:
            raise ValueError(f"a mesh of {mesh.size} ranks on a group of "
                             f"{self.world}")
        if len(in_specs) != len(global_args):
            raise ValueError(f"{len(global_args)} arguments, "
                             f"{len(in_specs)} in_specs")
        host = [a.detach().cpu() for a in global_args]
        return [tuple(local_shard(a, mesh, s, r).clone(
                          memory_format=torch.contiguous_format)
                      for a, s in zip(host, in_specs))
                for r in range(self.world)]

    def run(self, fn: Callable, mesh: Mesh, *global_args: torch.Tensor,
            in_specs: Sequence[tuple], out_specs) -> Any:
        """:func:`~tpusim_torch.spmd.run_ranks` with a process a rank:
        ``fn`` (one rank's program, importable by name) on each rank's
        shards, the outputs reassembled on the arguments' device."""
        outs = self.call(_run_task, [(fn, a, torch.is_grad_enabled())
                                     for a in self.shards(mesh, global_args,
                                                           in_specs)])
        dev = global_args[0].device if global_args else torch.device("cpu")
        if isinstance(outs[0], (tuple, list)):
            if len(outs[0]) != len(out_specs):
                raise ValueError(f"{len(outs[0])} outputs, {len(out_specs)} "
                                 f"out_specs")
            return tuple(
                unshard(torch.stack([o[i] for o in outs]), mesh, s).to(dev)
                for i, s in enumerate(out_specs))
        return unshard(torch.stack(outs), mesh, out_specs).to(dev)

    def run_module(self, module: SpmdModule, *global_args: torch.Tensor):
        """One launch of a workload over global arrays."""
        return self.run(module, module.mesh, *global_args,
                        in_specs=module.in_specs, out_specs=module.out_specs)

    def time_launches(self, module: SpmdModule, *global_args: torch.Tensor,
                      launches: int, warmup: int = 1) -> list[float]:
        """Seconds of each of ``launches`` launches after ``warmup``: a
        barrier before each, each rank timing itself; a launch takes its
        slowest rank's time (a mesh finishes with its last device)."""
        per_rank = self.shards(module.mesh, global_args, module.in_specs)
        res = self.call(_time_task, [(module, a, launches, warmup)
                                     for a in per_rank])
        return [max(r[i] for r in res) for i in range(launches)]


def _world(module) -> int:
    return module.world if isinstance(module, SpmdModule) else 1


def _cards_for(module, device: torch.device) -> list[str] | None:
    """``cuda:0`` … ``cuda:N-1`` for a mesh of N > 1 ranks whose arguments
    lie on a card, on a host of at least N cards; else None."""
    world = _world(module)
    if (world > 1 and device.type == "cuda"
            and torch.cuda.device_count() >= world):
        return [f"cuda:{i}" for i in range(world)]
    return None


@contextlib.contextmanager
def ranks_for(module, device: torch.device, group: RankGroup | None = None):
    """The :class:`RankGroup` a run of ``module`` takes: ``group`` when
    given (left open); a new group with a rank on each of ``cuda:0`` …
    ``cuda:N-1`` when ``device`` is a card and the host has at least N
    cards for the mesh's N > 1 ranks (ended on leaving); else None, the
    vmap runner on ``device``."""
    if group is not None:
        if group.world != _world(module):
            raise ValueError(f"a workload of {_world(module)} ranks on a "
                             f"group of {group.world}")
        yield group
    elif (cards := _cards_for(module, device)) is not None:
        with RankGroup(cards) as g:
            yield g
    else:
        yield None


def runner_text(module, device: torch.device,
                group: RankGroup | None = None) -> str:
    """Which runner a run of ``module`` on ``device`` takes, in words."""
    world = _world(module)
    cards = _cards_for(module, device)
    if group is not None or cards is not None:
        return (group or RankGroup(cards)).describe()
    if world == 1:
        return f"one rank on {device}"
    have = torch.cuda.device_count() if device.type == "cuda" else 0
    fewer = (f" ({have} card{'s' if have != 1 else ''}, fewer than "
             f"{world})" if device.type == "cuda" else "")
    return f"the vmap runner, all {world} ranks on {device}{fewer}"
