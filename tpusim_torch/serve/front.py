"""Multi-acceptor front tier (port of ``tpusim/serve/front.py``).

One stdlib-threaded HTTP parent caps warm throughput: HTTP parse +
dispatch under a single GIL is the ceiling, not pricing, and adding
workers behind it does not lift it.  This module removes the single
parent: N **acceptor processes** each run a full
:class:`~tpusim_torch.serve.daemon.ServeDaemon` (their own HTTP parse,
admission, registry, optional supervised worker pool) and share ONE
public port via ``SO_REUSEPORT`` — the kernel distributes connections
across the fleet, so no single GIL ever touches every request.

Topology:

* **acceptors** — forked up front (spawn fallback), supervised by the
  parent :class:`FrontSupervisor`: crash detection, exponential-backoff
  restarts with deterministic jitter, peer-map rebroadcast on
  membership change.  The parent serves no HTTP itself; it holds a
  bound-but-not-listening reuseport socket purely to reserve the port
  (only LISTENING sockets join the kernel's delivery group).
* **acceptor 0 is the primary** — sole owner of the async
  :class:`~tpusim_torch.serve.admission.JobTable` (ids, persistence,
  restart recovery stay single-writer); the others proxy job-family
  routes to its direct listener over loopback.
* **shared state** — the disk result-cache tier (L2, quota-governed by
  every writer), the mmap :class:`~tpusim_torch.serve.hotcache.
  HotResponseCache` (any acceptor publishes, all serve from it), and
  the poison-quarantine directory (a request that killed workers behind
  one acceptor is refused by all).
* **fallback** (kernels without ``SO_REUSEPORT``, or
  ``TPUSIM_NO_REUSEPORT=1``) — the parent binds the one listener,
  accepts, and ships each connection's fd round-robin to an acceptor
  over a unix socketpair via :func:`socket.send_fds`; the acceptor
  rebuilds the socket and dispatches it into its own HTTP stack.  Same
  fleet semantics, one extra syscall per connection.

Byte-identity holds across every topology by construction: each
acceptor runs the exact serving stack the standalone daemon does, and
the hot tier stores final response bytes those stacks produced.

Serving is host work.  An acceptor forked from a process that holds a
CUDA context (``chip_smoke.py`` serves from one) never touches
``torch.cuda``, and runs one torch intra-op thread: a forked child that
enters the intra-op pool its parent already used can wait forever on
threads that were not forked (the pricing pool's and the serve
workers' rule).
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import socket
import struct
import threading
import time

__all__ = ["AcceptorSlot", "FrontSupervisor", "acceptor_main",
           "reuse_port_available"]

#: restart backoff ceiling for crashed acceptors
MAX_RESTART_BACKOFF_S = 30.0

#: how long one acceptor boot may take before the spawn is abandoned
ACCEPTOR_READY_TIMEOUT_S = 60.0


def reuse_port_available() -> bool:
    """True when this kernel (and this run) can use ``SO_REUSEPORT``.
    ``TPUSIM_NO_REUSEPORT=1`` forces the fd-passing fallback — the
    contract tests exercise both paths on any host."""
    if os.environ.get("TPUSIM_NO_REUSEPORT", "") not in ("", "0"):
        return False
    return hasattr(socket, "SO_REUSEPORT")


def _det_jitter(index: int, spawns: int, base: float) -> float:
    import hashlib

    h = hashlib.sha256(f"front:{index}:{spawns}".encode()).digest()
    return 0.25 * base * (int.from_bytes(h[:4], "big") / 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Acceptor child
# ---------------------------------------------------------------------------


def acceptor_main(index: int, conn, settings: dict) -> None:
    """Entry point of one acceptor process.

    ``settings`` is the picklable bootstrap document: every
    :class:`~tpusim_torch.serve.daemon.ServeDaemon` constructor knob plus
    ``host``/``public_port``/``reuse_port``/``fd_mode``/``close_fds``.
    The protocol over ``conn``: the child sends ``("ready", pid,
    direct_port)`` once serving; the parent pushes ``("peers", {index:
    direct_port}, primary_direct)`` on every membership change and
    ``None`` as the drain-and-exit sentinel.  In fd mode the acceptor
    additionally drains accepted-connection fds from ``settings
    ['fd_sock_fileno']`` (its end of the inherited socketpair).
    """
    import sys

    import torch

    from tpusim_torch.serve.daemon import ServeDaemon

    torch.set_num_threads(1)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    fd_mode = bool(settings.get("fd_mode"))
    daemon = ServeDaemon(
        trace_root=settings.get("trace_root"),
        host=settings.get("host", "127.0.0.1"),
        port=int(settings.get("public_port", 0)),
        max_inflight=settings.get("max_inflight", 4),
        queue_depth=settings.get("queue_depth", 16),
        deadline_s=settings.get("deadline_s", 30.0),
        max_request_bytes=settings.get(
            "max_request_bytes", 8 * 1024 * 1024
        ),
        result_cache=settings.get("result_cache"),
        cache_entries=settings.get("cache_entries", 4096),
        workers=settings.get("workers", 1),
        serve_workers=settings.get("workers_per_acceptor", 0),
        min_workers=settings.get("min_workers", 1),
        restart_backoff_s=settings.get("restart_backoff_s", 0.05),
        chaos_hooks=settings.get("chaos_hooks", False),
        # only the primary drains jobs; secondaries proxy to it
        job_workers=(
            settings.get("job_workers", 1) if index == 0 else 0
        ),
        job_queue_depth=settings.get("job_queue_depth", 16),
        drain_grace_s=settings.get("drain_grace_s", 60.0),
        state_dir=settings.get("state_dir") if index == 0 else None,
        verbose=settings.get("verbose", False),
        cache_quota=settings.get("disk_quota"),
        max_rss=settings.get("max_rss"),
        max_worker_rss=settings.get("max_worker_rss"),
        compile_cache=settings.get("compile_cache"),
        hot_cache=settings.get("hot_cache"),
        hot_quota_bytes=settings.get("hot_quota_bytes"),
        strict_lint=settings.get("strict_lint", False),
        trace_requests=settings.get("trace_requests", False),
        access_log=settings.get("access_log"),
        # cluster membership is a PRIMARY concern: acceptor 0 owns the
        # registry/heartbeat (the JobTable discipline); secondaries
        # proxy /v1/cluster/* to it over the direct listener
        cluster_join=(
            settings.get("join_addr") if index == 0 else None
        ),
        cluster_min_nodes=(
            settings.get("join_min_nodes", 1) if index == 0 else 1
        ),
        acceptor_index=index,
        acceptors_total=settings.get("acceptors_total", 0),
        reuse_port=not fd_mode and bool(settings.get("reuse_port", True)),
        public_listener=not fd_mode,
        quarantine_dir=settings.get("quarantine_dir"),
        close_fds=settings.get("close_fds") or (),
        # this acceptor's own channels: ITS workers must not inherit
        # them alive (a worker pinning the fd-passing socketpair would
        # let the parent ship connections into a dead acceptor)
        worker_close_fds=[
            fd for fd in (
                conn.fileno(),
                settings.get("fd_sock_fileno"),
            ) if fd is not None
        ],
    )
    # SIGTERM drains THIS acceptor (the front parent coordinates the
    # fleet; a directly-TERMed acceptor still exits clean on its own)
    drained = threading.Event()

    def _drain_and_exit(*_a):
        if drained.is_set():
            return
        drained.set()

        def _run():
            daemon.drain_and_stop()
            os._exit(0)  # the control loop may be blocked in recv()

        threading.Thread(target=_run, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain_and_exit)
    try:
        daemon.start()
    except OSError as e:
        try:
            conn.send(("bind_error", os.getpid(), str(e)))
        except (BrokenPipeError, OSError):
            pass
        return
    if fd_mode:
        fd_sock = socket.socket(
            socket.AF_UNIX, socket.SOCK_STREAM,
            fileno=int(settings["fd_sock_fileno"]),
        )

        def _fd_loop():
            while True:
                try:
                    msg, fds, _flags, _addr = socket.recv_fds(
                        fd_sock, 16, 4,
                    )
                except OSError:
                    return
                if not fds:
                    return  # parent closed its end: we are draining
                # the parent stamps its monotonic accept time into the
                # send_fds message (shared clock across fork): request
                # tracing turns it into the fd_dispatch span
                accepted_s = None
                if len(msg) >= 8:
                    try:
                        accepted_s = struct.unpack("<d", msg[:8])[0]
                    except struct.error:
                        accepted_s = None
                for fd in fds:
                    try:
                        client = socket.socket(fileno=fd)
                    except OSError:
                        try:
                            os.close(fd)
                        except OSError:
                            pass
                        continue
                    # from here the socket object OWNS the fd: close
                    # through it, never os.close (a raw close plus the
                    # object's own close would release the number twice
                    # — the second close could hit an unrelated fd a
                    # concurrent thread was just assigned)
                    try:
                        daemon.inject_connection(
                            client, client.getpeername(),
                            accepted_s=accepted_s,
                        )
                    except OSError:
                        try:
                            client.close()
                        except OSError:
                            pass

        threading.Thread(
            target=_fd_loop, name="tpusim-front-fdrecv", daemon=True,
        ).start()
    try:
        conn.send(("ready", os.getpid(), daemon.direct_port))
    except (BrokenPipeError, OSError):
        daemon.abort()
        return
    # control loop: peer pushes + the drain sentinel.  EOF (the parent
    # died) drains too — an orphan acceptor must not serve forever.
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            msg = None
        if msg is None:
            if not drained.is_set():
                drained.set()
                daemon.drain_and_stop()
            sys.exit(0)
        if isinstance(msg, tuple) and msg and msg[0] == "peers":
            daemon.set_peers(msg[1], msg[2])


# ---------------------------------------------------------------------------
# Front supervisor (parent)
# ---------------------------------------------------------------------------


class AcceptorSlot:
    """One supervised acceptor position."""

    def __init__(self, index: int):
        self.index = index
        self.proc = None
        self.conn = None
        self.fd_sock = None          # parent end of the fd socketpair
        self.pid: int | None = None
        self.direct_port: int | None = None
        self.alive = False
        self.spawns = 0
        self.boots = 0
        self.consecutive_failures = 0
        self.next_restart_at = 0.0

    @property
    def restarts(self) -> int:
        return max(self.boots - 1, 0)


class FrontSupervisor:
    """Owns the acceptor fleet: port reservation, spawn/restart,
    peer-map broadcast, and (fallback mode) the accept+fd-ship loop."""

    def __init__(
        self,
        settings: dict,
        num_acceptors: int = 2,
        host: str = "127.0.0.1",
        port: int = 0,
        restart_backoff_s: float = 0.2,
    ):
        self.settings = dict(settings)
        self.num_acceptors = max(int(num_acceptors), 1)
        self.host = host
        self._requested_port = int(port)
        self.port: int | None = None
        self.restart_backoff_s = max(float(restart_backoff_s), 0.01)
        self.reuse_port = reuse_port_available()
        self.slots = [AcceptorSlot(i) for i in range(self.num_acceptors)]
        self._reserve_sock: socket.socket | None = None
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._monitor: threading.Thread | None = None
        self._accept_thread: threading.Thread | None = None
        self._fd_rr = 0
        self._stopped = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FrontSupervisor":
        from tpusim_torch.perf.pool import DeferSignals

        if self.reuse_port:
            # reserve the port WITHOUT joining the delivery group: a
            # bound-but-not-listening reuseport socket holds the number
            # while only the acceptors' listening sockets receive
            self._reserve_sock = socket.socket(
                socket.AF_INET, socket.SOCK_STREAM,
            )
            self._reserve_sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEPORT, 1,
            )
            self._reserve_sock.bind((self.host, self._requested_port))
            self.port = self._reserve_sock.getsockname()[1]
        else:
            # fd-passing fallback: the parent owns the one listener
            self._listener = socket.socket(
                socket.AF_INET, socket.SOCK_STREAM,
            )
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1,
            )
            self._listener.bind((self.host, self._requested_port))
            self._listener.listen(128)
            self.port = self._listener.getsockname()[1]
        with DeferSignals():
            for slot in self.slots:
                ok = self._spawn(slot)
                if not ok and slot.index == 0:
                    # without a primary nothing async works; refuse to
                    # start a half-fleet silently
                    self.stop(grace_s=1.0)
                    raise RuntimeError(
                        "front tier failed to boot acceptor 0"
                    )
        self._broadcast_peers()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="tpusim-front-supervisor",
            daemon=True,
        )
        self._monitor.start()
        if not self.reuse_port:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="tpusim-front-accept",
                daemon=True,
            )
            self._accept_thread.start()
        return self

    def _child_settings(self, slot: AcceptorSlot) -> dict:
        s = dict(self.settings)
        s["host"] = self.host
        s["public_port"] = self.port
        s["reuse_port"] = self.reuse_port
        s["fd_mode"] = not self.reuse_port
        s["acceptors_total"] = self.num_acceptors
        close_fds = []
        if self._reserve_sock is not None:
            close_fds.append(self._reserve_sock.fileno())
        if self._listener is not None:
            close_fds.append(self._listener.fileno())
        # siblings' fd-socketpair parent ends AND control-pipe parent
        # ends travel into every fork; each child closes the ones that
        # are not its own.  The pipe ends matter for orphan drain: an
        # acceptor holding a sibling's pipe write end would keep that
        # sibling's conn.recv() from ever seeing EOF after the parent
        # dies — both orphans would serve the reuseport group forever.
        for other in self.slots:
            if other is slot:
                continue
            if other.fd_sock is not None:
                close_fds.append(other.fd_sock.fileno())
            if other.conn is not None:
                try:
                    close_fds.append(other.conn.fileno())
                except OSError:
                    pass
        s["close_fds"] = close_fds
        return s

    def _spawn(self, slot: AcceptorSlot) -> bool:
        methods = multiprocessing.get_all_start_methods()
        method = "fork" if "fork" in methods else "spawn"
        ctx = multiprocessing.get_context(method)
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        child_fd_sock = None
        if not self.reuse_port:
            parent_fd, child_fd_sock = socket.socketpair(
                socket.AF_UNIX, socket.SOCK_STREAM,
            )
            slot.fd_sock = parent_fd
        settings = self._child_settings(slot)
        if child_fd_sock is not None:
            settings["fd_sock_fileno"] = child_fd_sock.fileno()
        if method != "fork":
            settings["close_fds"] = []
        proc = ctx.Process(
            target=acceptor_main,
            args=(slot.index, child_conn, settings),
            name=f"tpusim-front-acceptor-{slot.index}",
            daemon=False,  # acceptors own worker children of their own
        )
        slot.spawns += 1
        try:
            proc.start()
        except OSError:
            parent_conn.close()
            self._mark_failed(slot)
            return False
        finally:
            child_conn.close()
            if child_fd_sock is not None:
                child_fd_sock.close()
        ready = False
        direct_port = None
        pid = None
        try:
            if parent_conn.poll(ACCEPTOR_READY_TIMEOUT_S):
                msg = parent_conn.recv()
                if (
                    isinstance(msg, tuple) and len(msg) == 3
                    and msg[0] == "ready"
                ):
                    ready, pid, direct_port = True, msg[1], msg[2]
        except (EOFError, OSError):
            ready = False
        if not ready:
            try:
                proc.kill()
                proc.join(1.0)
            except (OSError, ValueError):
                pass
            parent_conn.close()
            self._mark_failed(slot)
            return False
        with self._lock:
            if self._stop.is_set():
                registered = False
            else:
                slot.proc = proc
                slot.conn = parent_conn
                slot.pid = pid
                slot.direct_port = direct_port
                slot.alive = True
                slot.boots += 1
                slot.consecutive_failures = 0
                registered = True
        if not registered:
            # stop() won the lock first: its sentinel sweep is over, so
            # this fresh acceptor would never hear the drain — tear it
            # down here instead of leaking a live process that keeps
            # serving the reuseport group (the supervisor.py idiom)
            try:
                parent_conn.send(None)
            except (BrokenPipeError, OSError):
                pass
            proc.join(5.0)
            if proc.is_alive():
                try:
                    proc.kill()
                    proc.join(1.0)
                except (OSError, ValueError):
                    pass
            parent_conn.close()
            return False
        return True

    def _mark_failed(self, slot: AcceptorSlot) -> None:
        with self._lock:
            slot.alive = False
            slot.pid = None
            slot.consecutive_failures += 1
            base = self.restart_backoff_s * (
                2.0 ** max(slot.consecutive_failures - 1, 0)
            )
            base = min(base, MAX_RESTART_BACKOFF_S)
            slot.next_restart_at = time.monotonic() + base + _det_jitter(
                slot.index, slot.spawns, base,
            )
        if slot.fd_sock is not None:
            try:
                slot.fd_sock.close()
            except OSError:
                pass
            slot.fd_sock = None

    def _broadcast_peers(self) -> None:
        with self._lock:
            peers = {
                s.index: s.direct_port
                for s in self.slots
                if s.alive and s.direct_port is not None
            }
            primary = peers.get(0)
            conns = [
                (s, s.conn) for s in self.slots if s.alive and s.conn
            ]
        for slot, conn in conns:
            try:
                conn.send(("peers", peers, primary))
            except (BrokenPipeError, OSError):
                pass  # the monitor will notice the death

    def _monitor_loop(self) -> None:
        while not self._stop.wait(0.05):
            changed = False
            for slot in self.slots:
                if self._stop.is_set():
                    return
                proc = slot.proc
                if slot.alive and proc is not None and not proc.is_alive():
                    self._on_death(slot)
                    changed = True
                elif (
                    not slot.alive
                    and time.monotonic() >= slot.next_restart_at
                ):
                    if self._spawn(slot):
                        changed = True
            if changed and not self._stop.is_set():
                self._broadcast_peers()

    def _on_death(self, slot: AcceptorSlot) -> None:
        with self._lock:
            slot.alive = False
            slot.pid = None
            slot.consecutive_failures += 1
            base = self.restart_backoff_s * (
                2.0 ** max(slot.consecutive_failures - 1, 0)
            )
            base = min(base, MAX_RESTART_BACKOFF_S)
            slot.next_restart_at = time.monotonic() + base + _det_jitter(
                slot.index, slot.spawns, base,
            )
        for res in (slot.conn, slot.fd_sock):
            if res is not None:
                try:
                    res.close()
                except OSError:
                    pass
        slot.conn = None
        slot.fd_sock = None
        if slot.proc is not None:
            try:
                slot.proc.join(0.1)
            except (OSError, ValueError):
                pass
        slot.proc = None

    def _accept_loop(self) -> None:
        """Fallback mode only: accept on the one listener and ship each
        connection's fd to a live acceptor round-robin."""
        while not self._stop.is_set():
            try:
                self._listener.settimeout(0.2)
                client, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sent = False
            for _ in range(len(self.slots)):
                with self._lock:
                    self._fd_rr = (self._fd_rr + 1) % len(self.slots)
                    slot = self.slots[self._fd_rr]
                    fd_sock = slot.fd_sock if slot.alive else None
                if fd_sock is None:
                    continue
                try:
                    # the message carries the accept timestamp (shared
                    # monotonic clock) for the acceptor's fd_dispatch
                    # span; receivers that predate it ignored the bytes
                    socket.send_fds(
                        fd_sock,
                        [struct.pack("<d", time.monotonic())],
                        [client.fileno()],
                    )
                    sent = True
                    break
                except OSError:
                    continue
            client.close()  # the acceptor holds its own duplicate now
            if not sent:
                # no live acceptor: the close above RSTs the client —
                # the same outcome as a daemon that is simply down
                pass

    # -- shutdown ------------------------------------------------------------

    def stop(self, grace_s: float = 60.0) -> bool:
        """Drain the fleet: sentinel to every acceptor, bounded join,
        SIGKILL stragglers.  Returns True when every acceptor exited
        inside the grace period."""
        with self._lock:
            # same lock _spawn registers under: a respawn in flight
            # either registered already (the sweep below reaps it) or
            # sees _stop at registration and tears its acceptor down
            self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for slot in self.slots:
            if slot.conn is not None:
                try:
                    slot.conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        clean = True
        deadline = time.monotonic() + max(grace_s, 0.5)
        for slot in self.slots:
            proc = slot.proc
            if proc is None:
                continue
            proc.join(max(deadline - time.monotonic(), 0.1))
            if proc.is_alive():
                clean = False
                try:
                    proc.terminate()
                    proc.join(2.0)
                    if proc.is_alive():
                        proc.kill()
                        proc.join(1.0)
                except (OSError, ValueError):
                    pass
            for res in (slot.conn, slot.fd_sock):
                if res is not None:
                    try:
                        res.close()
                    except OSError:
                        pass
            slot.conn = None
            slot.fd_sock = None
            slot.alive = False
        if self._reserve_sock is not None:
            try:
                self._reserve_sock.close()
            except OSError:
                pass
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        self._stopped.set()
        return clean

    def wait_stopped(self, timeout_s: float | None = None) -> bool:
        return self._stopped.wait(timeout_s)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → drain the fleet on a helper thread."""

        def _on_signal(signum, frame):
            threading.Thread(
                target=self.stop, name="tpusim-front-drain", daemon=True,
            ).start()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    # -- chaos / reporting ---------------------------------------------------

    def acceptor_pids(self) -> list[int | None]:
        return [s.pid for s in self.slots]

    def alive_count(self) -> int:
        return sum(1 for s in self.slots if s.alive)

    def kill_acceptor(self, index: int) -> None:
        """SIGKILL one acceptor outright (chaos testing)."""
        pid = self.slots[index].pid
        if pid is not None:
            try:
                os.kill(pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass

    # -- context manager (tests) ---------------------------------------------

    def __enter__(self) -> "FrontSupervisor":
        return self.start()

    def __exit__(self, *exc) -> bool:
        if not self._stopped.is_set():
            self.stop()
        return False
