"""Edge-cloud network model (the tc-netem role in the paper's testbed).

The paper emulates its network with ``tc-netem``: 50 ms RTT and 100 Mb/s
between edge and cloud, 20 ms RTT and 100 Mb/s between edge nodes (§4.1,
§4.3).  We model the same quantities explicitly; the figure-reproduction
benchmarks combine this model with *measured* local compute/store times to
recover the paper's end-to-end latency results on hardware we don't have.
Pure Python: a copy of ``repro.core.network`` whose ``FaultPlane`` keeps the
same ``zlib.crc32`` decisions, so one seed replays the same drop/dup/jitter
schedule in both packages.

``FaultPlane`` layers the UNRELIABLE part of the WAN on top: per-link drop
probability, duplication, delay jitter, and named partitions, all sampled
from a seeded counter-based stream so any fault schedule replays
bit-identically.  The replication transport (core/cluster.py outboxes)
consults it; the
latency model above stays separate — a partition does not change a link's
nominal RTT, it makes transmissions on it fail until healed.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, FrozenSet, Optional, Tuple

from repro_torch.analysis import lockdep


@dataclasses.dataclass(frozen=True)
class Link:
    rtt_ms: float
    bandwidth_mbps: float      # megaBITS per second, like the paper's 100Mb/s

    @property
    def one_way_ms(self) -> float:
        return self.rtt_ms / 2.0

    def transfer_ms(self, nbytes: int) -> float:
        if self.bandwidth_mbps <= 0:
            return 0.0
        return (nbytes * 8.0) / (self.bandwidth_mbps * 1e6) * 1e3


LOCAL_LINK = Link(rtt_ms=0.0, bandwidth_mbps=0.0)   # same node


@dataclasses.dataclass
class NetworkModel:
    links: Dict[Tuple[str, str], Link]
    default: Link = Link(rtt_ms=50.0, bandwidth_mbps=100.0)

    def link(self, a: str, b: str) -> Link:
        if a == b:
            return LOCAL_LINK
        return self.links.get((a, b)) or self.links.get((b, a)) or self.default

    def rtt_ms(self, a: str, b: str) -> float:
        return self.link(a, b).rtt_ms

    def one_way_ms(self, a: str, b: str) -> float:
        return self.link(a, b).one_way_ms

    def request_ms(self, a: str, b: str, payload_bytes: int = 0,
                   response_bytes: int = 0) -> float:
        """One request/response exchange: RTT + serialisation of both payloads."""
        l = self.link(a, b)
        return l.rtt_ms + l.transfer_ms(payload_bytes) + l.transfer_ms(response_bytes)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-link lossiness: each transmission independently drops with
    ``drop_p``, duplicates with ``dup_p``, and every delivered copy picks
    up a uniform extra delay in ``[0, jitter_ms]``."""
    drop_p: float = 0.0
    dup_p: float = 0.0
    jitter_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class Transmission:
    """The sampled fate of ONE send attempt on a faulty link."""
    ok: bool                            # False: dropped (or partitioned)
    copies: int                         # delivered copies (2 = duplicated)
    jitter_ms: Tuple[float, ...]        # per-copy extra delay


_DELIVERED = Transmission(ok=True, copies=1, jitter_ms=(0.0,))
_DROPPED = Transmission(ok=False, copies=0, jitter_ms=())


class FaultPlane:
    """Seeded, deterministic link-fault model over a ``NetworkModel``.

    Every sampling decision is a pure function of ``(seed, link, n)``
    where ``n`` is a per-directed-link send counter — no hidden RNG
    state, so a replay that issues the same sequence of sends per link
    observes the same drop/dup/jitter schedule regardless of thread
    interleaving across OTHER links.  (``zlib.crc32`` keys the stream:
    Python's ``hash`` is salted per process and would not replay.)

    Partitions are NAMED groups: ``partition({"edge1"}, {"cloud",
    "edge2"})`` severs every pair straddling two groups; nodes not
    listed are unaffected.  ``heal(name)`` removes one partition,
    ``heal()`` removes all.  A partitioned pair fails every transmission
    deterministically (no randomness burned) until healed.
    """

    def __init__(self, net: NetworkModel, seed: int = 0):
        self.net = net
        self.seed = int(seed)
        # guards fault specs, partitions and send counters (leaf lock:
        # pure dict/int ops, nothing else is ever acquired under it)
        self._lock = lockdep.make_lock("network.fault_lock")
        self._faults: Dict[FrozenSet[str], FaultSpec] = {}
        self._partitions: Dict[str, Tuple[FrozenSet[str], ...]] = {}
        self._counters: Dict[Tuple[str, str], int] = {}
        self._pnames = 0
        #: optional zero-arg callback fired AFTER a heal() removes at
        #: least one partition (outside the lock).  The Cluster hooks it
        #: to re-arm parked outbox entries so partition-era snapshots
        #: deliver as if freshly scheduled on the healed link.
        self.on_heal = None

    # ------------------------------------------------------------- config
    def set_fault(self, a: str, b: str, drop_p: float = 0.0,
                  dup_p: float = 0.0, jitter_ms: float = 0.0) -> None:
        """Install (or replace) the symmetric fault spec of link a<->b."""
        with self._lock:
            self._faults[frozenset((a, b))] = FaultSpec(
                drop_p=float(drop_p), dup_p=float(dup_p),
                jitter_ms=float(jitter_ms))

    def clear_fault(self, a: str, b: str) -> None:
        with self._lock:
            self._faults.pop(frozenset((a, b)), None)

    def clear_faults(self) -> None:
        with self._lock:
            self._faults.clear()

    def partition(self, *groups, name: Optional[str] = None) -> str:
        """Install a named partition separating the given node groups.
        Returns the name (auto-generated when omitted) for ``heal``."""
        gs = tuple(frozenset(g) for g in groups)
        if len(gs) < 2:
            raise ValueError("a partition needs >= 2 groups")
        with self._lock:
            if name is None:
                name = f"partition-{self._pnames}"
                self._pnames += 1
            self._partitions[name] = gs
            return name

    def heal(self, name: Optional[str] = None) -> None:
        """Remove one named partition, or every partition when ``name``
        is omitted.  Healing an unknown name is a no-op."""
        with self._lock:
            if name is None:
                healed = bool(self._partitions)
                self._partitions.clear()
            else:
                healed = self._partitions.pop(name, None) is not None
        # outside the lock: the hook takes the cluster's outbox lock,
        # which itself nests ABOVE this leaf
        if healed and self.on_heal is not None:
            self.on_heal()

    def partitioned(self, a: str, b: str) -> bool:
        """Whether any active partition separates ``a`` from ``b``."""
        if a == b:
            return False
        with self._lock:
            return self._partitioned_locked(a, b)

    def _partitioned_locked(self, a: str, b: str) -> bool:
        for groups in self._partitions.values():
            ga = gb = None
            for i, g in enumerate(groups):
                if a in g:
                    ga = i
                if b in g:
                    gb = i
            if ga is not None and gb is not None and ga != gb:
                return True
        return False

    def partitions(self) -> Dict[str, Tuple[FrozenSet[str], ...]]:
        with self._lock:
            return dict(self._partitions)

    # ----------------------------------------------------------- sampling
    def _u(self, a: str, b: str, n: int, salt: str) -> float:
        """Deterministic uniform [0,1) keyed by (seed, directed link,
        send counter, decision salt)."""
        key = f"{self.seed}|{a}>{b}|{n}|{salt}".encode()
        return zlib.crc32(key) / 2**32

    def transmit(self, a: str, b: str) -> Transmission:
        """Sample the fate of one a->b send: partitioned links always
        fail; otherwise drop/dup/jitter per the link's ``FaultSpec``.
        Each call burns one counter tick on the directed link."""
        if a == b:
            return _DELIVERED
        with self._lock:
            if self._partitioned_locked(a, b):
                return _DROPPED
            spec = self._faults.get(frozenset((a, b)))
            if spec is None:
                return _DELIVERED
            n = self._counters.get((a, b), 0)
            self._counters[(a, b)] = n + 1
        if spec.drop_p > 0.0 and self._u(a, b, n, "drop") < spec.drop_p:
            return _DROPPED
        copies = 2 if (spec.dup_p > 0.0
                       and self._u(a, b, n, "dup") < spec.dup_p) else 1
        if spec.jitter_ms > 0.0:
            jit = tuple(self._u(a, b, n, f"jit{i}") * spec.jitter_ms
                        for i in range(copies))
        else:
            jit = (0.0,) * copies
        return Transmission(ok=True, copies=copies, jitter_ms=jit)


def paper_topology() -> NetworkModel:
    """The §4 testbed: client, edge (x2 for §4.3), cloud.

    client<->edge is LAN-local (sub-ms; we use 1 ms RTT), edge<->cloud is
    50 ms RTT / 100 Mb/s, edge<->edge is 20 ms RTT / 100 Mb/s.
    """
    e_c = Link(rtt_ms=50.0, bandwidth_mbps=100.0)
    e_e = Link(rtt_ms=20.0, bandwidth_mbps=100.0)
    lan = Link(rtt_ms=1.0, bandwidth_mbps=1000.0)
    return NetworkModel(links={
        ("client", "edge"): lan,
        ("client", "edge1"): lan,
        ("client", "edge2"): Link(rtt_ms=21.0, bandwidth_mbps=100.0),
        ("client", "cloud"): e_c,
        ("edge", "cloud"): e_c,
        ("edge1", "cloud"): e_c,
        ("edge2", "cloud"): e_c,
        ("edge", "edge1"): e_e,
        ("edge", "edge2"): e_e,
        ("edge1", "edge2"): e_e,
    })
