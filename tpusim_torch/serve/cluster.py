"""Multi-node serve cluster — membership, trace affinity, heartbeats
(port of ``tpusim/serve/cluster.py``).

This module scales serving *across* boxes with the smallest protocol
that stays split-brain safe:

* **membership** — one node is the cluster primary purely because the
  others were started with ``--join HOST:PORT`` pointing at it.  The
  primary owns a :class:`ClusterRegistry`: a versioned **epoch**
  (monotonic int) plus the member table.  Every mutation — join,
  death, rejoin — bumps the epoch, and the epoch has exactly ONE
  writer (the registry), the same single-writer discipline the
  JobTable uses for job ids.  Members learn the current view by
  pull-gossip: every heartbeat response carries it.
* **failure detection** — members POST ``/v1/cluster/beat`` every
  ``beat_interval_s``; a member missing ``missed_beats`` consecutive
  deadlines is marked dead and the epoch bumps, so survivors see the
  death on their next beat (the rebroadcast).  A dead node that comes
  back claiming its old epoch is **refused** (409 / :class:`
  StaleEpoch`) — it must rejoin fresh at epoch 0, so a partitioned
  node can never resurrect a stale view of the fleet.
* **affinity** — :class:`AffinityRing` consistent-hashes request
  affinity keys (volatile body keys already stripped by
  :meth:`~tpusim_torch.serve.supervisor.Supervisor.affinity_key`, so the
  key is node-invariant) over the alive members.  Each trace's
  hot/compiled state concentrates on few nodes; when a node dies only
  ITS keys remap (the consistent-hash contract, pinned by test).
* **backoff** — a member that cannot reach the primary retries with
  capped exponential backoff plus seeded jitter (sha256 of
  ``node_id:attempt`` — no ``random`` in serve paths, TL350).

Nothing here prices anything: the cluster is pure control plane.  The
serving data plane (hot cache, result cache, compiled tier) stays
node-local; cross-node traffic is one-hop request forwarding done by
the daemon, never state replication.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import threading
import time

__all__ = [
    "AffinityRing",
    "ClusterRegistry",
    "FORWARD_HEADER",
    "HeartbeatLoop",
    "StaleEpoch",
    "parse_addr",
    "seeded_jitter",
]

#: stamped on cross-node forwarded requests — its presence means "do
#: not forward again", the one-hop guarantee (no routing loops even
#: when two nodes briefly hold different views of the ring)
FORWARD_HEADER = "X-Tpusim-Forwarded"

#: seconds between member heartbeats (and the primary's reap sweeps)
DEFAULT_BEAT_INTERVAL_S = 1.0

#: consecutive missed beats before a member is declared dead
DEFAULT_MISSED_BEATS = 3

#: retry-backoff ceiling for a member that cannot reach the primary
MAX_BEAT_BACKOFF_S = 15.0

#: virtual points per node on the affinity ring — enough that one
#: death spreads its keys roughly evenly over the survivors
RING_REPLICAS = 64


class StaleEpoch(ValueError):
    """A join/beat carried an epoch the registry has moved past."""


def parse_addr(addr: str) -> tuple[str, int]:
    """``HOST:PORT`` → ``(host, port)``; raises ValueError loudly."""
    host, _, port = addr.rpartition(":")
    if not host or not port:
        raise ValueError(f"cluster address wants HOST:PORT, got {addr!r}")
    return host, int(port)


def seeded_jitter(salt: str, attempt: int, base: float) -> float:
    """Deterministic jitter in ``[0, base/4)`` — seeded, not random,
    so chaos tests replay byte-identically (serve discipline TL350)."""
    h = hashlib.sha256(f"{salt}:{attempt}".encode()).digest()
    return 0.25 * base * (int.from_bytes(h[:4], "big") / 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Consistent-hash affinity
# ---------------------------------------------------------------------------


class AffinityRing:
    """Consistent hash of affinity keys over node ids.

    ``RING_REPLICAS`` virtual points per node (sha256 of
    ``"{node_id}#{replica}"``); a key is owned by the first point at
    or after its own hash, wrapping.  Removing a node removes only its
    points, so only keys that node owned remap — the property the
    hot/compiled tiers need to survive a membership change warm.
    """

    def __init__(self, node_ids, replicas: int = RING_REPLICAS):
        points: list[tuple[int, str]] = []
        for nid in sorted(set(node_ids)):
            for r in range(replicas):
                h = hashlib.sha256(f"{nid}#{r}".encode()).digest()
                points.append((int.from_bytes(h[:8], "big"), nid))
        points.sort()
        self._points = points
        self._hashes = [p[0] for p in points]

    def __len__(self) -> int:
        return len({nid for _, nid in self._points})

    def owner(self, key: str) -> str | None:
        """Node id owning ``key`` (None on an empty ring)."""
        if not self._points:
            return None
        x = int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big"
        )
        i = bisect.bisect_right(self._hashes, x) % len(self._points)
        return self._points[i][1]


# ---------------------------------------------------------------------------
# Primary-side registry (the single epoch writer)
# ---------------------------------------------------------------------------


class ClusterRegistry:
    """Member table + versioned epoch, owned by the cluster primary.

    The primary itself is member zero and never reaped (it IS the
    registry; if it dies the cluster is headless until restart — the
    deliberate simplicity that keeps the epoch single-writer).
    ``clock`` is injectable so tests drive time instead of sleeping.
    """

    def __init__(
        self,
        node_id: str,
        url: str,
        beat_interval_s: float = DEFAULT_BEAT_INTERVAL_S,
        missed_beats: int = DEFAULT_MISSED_BEATS,
        clock=time.monotonic,
    ):
        self.node_id = node_id
        self.beat_interval_s = max(float(beat_interval_s), 0.05)
        self.missed_beats = max(int(missed_beats), 1)
        self._clock = clock
        self._lock = threading.Lock()
        self.epoch = 1
        self._members: dict[str, dict] = {
            node_id: {
                "url": url, "last_beat": clock(),
                "alive": True, "shedding": False,
            },
        }
        self.joins = 0
        self.beats = 0
        self.deaths = 0
        self.stale_rejoins = 0

    # -- mutations (each bumps the epoch) ---------------------------------

    def join(self, node_id: str, url: str, epoch: int = 0) -> dict:
        """Register ``node_id``; returns the new view.

        A fresh join (epoch 0) is always accepted — including a dead
        node coming back, which is exactly the heal path.  A join
        claiming a *stale* nonzero epoch is refused: the node holds an
        outdated picture of the fleet and must rejoin fresh.
        """
        with self._lock:
            if epoch and epoch < self.epoch:
                self.stale_rejoins += 1
                raise StaleEpoch(
                    f"join from {node_id} at stale epoch {epoch} "
                    f"(cluster at {self.epoch}); rejoin with epoch 0"
                )
            self._members[node_id] = {
                "url": url, "last_beat": self._clock(),
                "alive": True, "shedding": False,
            }
            self.epoch += 1
            self.joins += 1
            return self._view_locked()

    def beat(self, node_id: str, epoch: int = 0,
             shedding: bool = False) -> dict:
        """Record a heartbeat; returns the current view (the gossip).

        A beat from a node the registry holds dead (or never met) is
        refused — it was reaped while partitioned and must rejoin
        fresh, never quietly resurrect.
        """
        with self._lock:
            m = self._members.get(node_id)
            if m is None or not m["alive"]:
                self.stale_rejoins += 1
                raise StaleEpoch(
                    f"beat from {node_id} which is not an alive "
                    f"member at epoch {self.epoch}; rejoin with epoch 0"
                )
            m["last_beat"] = self._clock()
            m["shedding"] = bool(shedding)
            self.beats += 1
            return self._view_locked()

    def reap(self) -> list[str]:
        """Mark members past ``missed_beats`` deadlines dead; returns
        the newly dead ids.  One epoch bump covers the whole sweep."""
        deadline = self.beat_interval_s * self.missed_beats
        now = self._clock()
        died: list[str] = []
        with self._lock:
            for nid, m in self._members.items():
                if nid == self.node_id or not m["alive"]:
                    continue
                if now - m["last_beat"] > deadline:
                    m["alive"] = False
                    died.append(nid)
            if died:
                self.epoch += 1
                self.deaths += len(died)
        return died

    # -- views ------------------------------------------------------------

    def _view_locked(self) -> dict:
        return {
            "epoch": self.epoch,
            "beat_interval_s": self.beat_interval_s,
            "missed_beats": self.missed_beats,
            "members": [
                {
                    "node_id": nid, "url": m["url"],
                    "alive": m["alive"], "shedding": m["shedding"],
                }
                for nid, m in sorted(self._members.items())
            ],
        }

    def view(self) -> dict:
        with self._lock:
            return self._view_locked()

    def stats_dict(self) -> dict[str, float]:
        with self._lock:
            alive = sum(1 for m in self._members.values() if m["alive"])
            return {
                "cluster_epoch": float(self.epoch),
                "cluster_joins_total": float(self.joins),
                "cluster_beats_total": float(self.beats),
                "cluster_deaths_total": float(self.deaths),
                "cluster_stale_rejoins_total": float(self.stale_rejoins),
                "cluster_nodes_alive": float(alive),
                "cluster_nodes_configured": float(len(self._members)),
            }


# -- shared view helpers (primary view docs AND gossiped copies) ----------


def alive_members(view: dict | None) -> list[dict]:
    """Alive member entries of a view doc (empty for no view)."""
    if not isinstance(view, dict):
        return []
    return [
        m for m in view.get("members", ())
        if isinstance(m, dict) and m.get("alive")
    ]


def ring_for(view: dict | None, skip_shedding: bool = True) -> AffinityRing:
    """Affinity ring over a view's alive members.

    ``skip_shedding`` drops members currently load-shedding under
    their memory watchdog — the node-grain shed: the ring stops
    forwarding work at a node that is already fighting its RSS, the
    same backpressure the watchdog applies locally.  If everyone
    sheds, fall back to all alive members (never an empty ring while
    someone is up).
    """
    members = alive_members(view)
    if skip_shedding:
        healthy = [m for m in members if not m.get("shedding")]
        if healthy:
            members = healthy
    return AffinityRing([m["node_id"] for m in members])


def member_url(view: dict | None, node_id: str) -> str | None:
    for m in alive_members(view):
        if m.get("node_id") == node_id:
            return m.get("url")
    return None


# ---------------------------------------------------------------------------
# Member-side heartbeat loop
# ---------------------------------------------------------------------------


class HeartbeatLoop:
    """Join-then-beat thread run by every non-primary node.

    On any failure the loop backs off exponentially (capped, seeded
    jitter) and falls back to a fresh join — a 409 means the primary
    holds us dead or our epoch is stale, and the contract for both is
    the same: rejoin at epoch 0.  ``post`` is injectable for tests;
    the default speaks HTTP to ``join_addr``'s public port.
    """

    def __init__(
        self,
        node_id: str,
        url: str,
        join_addr: str,
        interval_s: float = DEFAULT_BEAT_INTERVAL_S,
        timeout_s: float = 2.0,
        post=None,
        on_view=None,
        shedding=None,
    ):
        self.node_id = node_id
        self.url = url
        self.join_addr = join_addr
        self.interval_s = max(float(interval_s), 0.05)
        self.timeout_s = float(timeout_s)
        self._post = post if post is not None else self._http_post
        self._on_view = on_view
        self._shedding = shedding if shedding is not None else (
            lambda: False
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._view: dict | None = None
        self._joined = False
        self._epoch = 0
        self.beats_sent = 0
        self.rejoins = 0

    # -- transport --------------------------------------------------------

    def _http_post(self, path: str, doc: dict):
        import http.client

        host, port = parse_addr(self.join_addr)
        conn = http.client.HTTPConnection(
            host, port, timeout=self.timeout_s,
        )
        try:
            conn.request(
                "POST", path, body=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = None
        return resp.status, parsed

    # -- protocol ---------------------------------------------------------

    def step(self) -> bool:
        """One join-or-beat exchange; True when the view advanced."""
        if not self._joined:
            status, doc = self._post("/v1/cluster/join", {
                "node_id": self.node_id, "url": self.url,
                "epoch": self._epoch,
            })
            if status == 409:
                # our epoch is stale: drop it and rejoin fresh
                self._epoch = 0
                return False
            if status != 200 or not isinstance(doc, dict):
                return False
            self._joined = True
            self.rejoins += 1
        else:
            status, doc = self._post("/v1/cluster/beat", {
                "node_id": self.node_id, "epoch": self._epoch,
                "shedding": bool(self._shedding()),
            })
            if status == 409:
                # the primary reaped us while we were partitioned;
                # the ONLY legal recovery is a fresh join
                self._joined = False
                self._epoch = 0
                return False
            if status != 200 or not isinstance(doc, dict):
                self._joined = False
                return False
            self.beats_sent += 1
        epoch = doc.get("epoch")
        if isinstance(epoch, int) and epoch >= self._epoch:
            self._epoch = epoch
            with self._lock:
                self._view = doc
            if self._on_view is not None:
                self._on_view(doc)
        return True

    def _run(self) -> None:
        attempt = 0
        while not self._stop.is_set():
            try:
                ok = self.step()
            except (OSError, ValueError):
                ok = False
                self._joined = False
            if ok:
                attempt = 0
                delay = self.interval_s
            else:
                attempt += 1
                base = min(
                    self.interval_s * (2.0 ** (attempt - 1)),
                    MAX_BEAT_BACKOFF_S,
                )
                delay = base + seeded_jitter(self.node_id, attempt, base)
            if self._stop.wait(delay):
                return

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "HeartbeatLoop":
        self._thread = threading.Thread(
            target=self._run, name="tpusim-cluster-beat", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def view(self) -> dict | None:
        with self._lock:
            return self._view

    @property
    def joined(self) -> bool:
        return self._joined
