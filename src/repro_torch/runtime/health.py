"""Heartbeat-based health monitoring with per-observer reachability views.

Nodes (pods/hosts) report (step, wall_time) heartbeats; the monitor keeps
TWO pictures of them:

* the legacy global view (``_beats``: last heartbeat each node SENT) —
  ``dead_nodes``/``stragglers``/``fleet_step`` read it, unchanged;
* per-observer reachability views (``_views``: the last heartbeat each
  OBSERVER received from each node).  A heartbeat reaches an observer only
  if the cluster's ``FaultPlane`` (when attached) says the pair is not
  partitioned, so a partition makes the victim silent to one side of the
  cut while the other side keeps hearing it.

``verdict(node)`` aggregates the views: a node silent to a QUORUM of live
observers (majority by default) is "dead"; silent to at least one but
fewer than quorum — the signature of a partition, not a crash — is
"suspect"; otherwise "alive".  ``ElasticMembership.poll`` drives its
ALIVE/SUSPECT/DEAD transitions off these verdicts.

Heartbeats are treated as small and frequent: partitions block them, but
per-link drop/jitter faults do not (a lost heartbeat is re-sent long
before any timeout; modelling individual losses would only add noise to
the suspicion signal).

Resurrection contract: ``dead_nodes``/``verdict`` are PURE — they never
touch the naming service (the old getter marked nodes dead in naming as a
side effect, and nothing ever cleared it).  Naming liveness is owned by
``ElasticMembership``: a crash marks dead, and only ``restore`` may
revive — a late ``beat()`` from a node already declared dead must NOT
silently flip naming back.  ``resurrect`` (called by restore) clears the
node's stale beat/view records so the restored node is not instantly
re-condemned by its pre-crash silence.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import lockdep
from repro_torch.core.naming import NamingService

# verdict values (string-compatible with runtime/elastic.py's states)
ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


@dataclasses.dataclass
class Heartbeat:
    step: int
    t: float


class HealthMonitor:
    def __init__(self, naming: Optional[NamingService] = None,
                 timeout_s: float = 30.0, lag_steps: int = 50,
                 plane=None, quorum: Optional[int] = None):
        self.naming = naming
        self.timeout_s = timeout_s
        self.lag_steps = lag_steps
        #: optional core.network.FaultPlane: gates which observers a
        #: heartbeat reaches (partitioned pairs hear nothing)
        self.plane = plane
        #: observers that must agree on silence to confirm a death;
        #: None = majority of live observers (floor(n/2) + 1)
        self.quorum = quorum
        self._lock = lockdep.make_lock("health.lock")
        self._beats: Dict[str, Heartbeat] = {}
        # observer -> {node: last heartbeat RECEIVED from node}
        self._views: Dict[str, Dict[str, Heartbeat]] = {}

    # ----------------------------------------------------------------- feeds
    def beat(self, node: str, step: int, t: Optional[float] = None) -> None:
        hb = Heartbeat(step=step, t=t if t is not None else time.monotonic())
        with self._lock:
            self._beats[node] = hb
            for obs in self._observers():
                if obs == node:
                    continue
                if self.plane is not None and self.plane.partitioned(obs,
                                                                     node):
                    continue
                self._views.setdefault(obs, {})[node] = hb

    def resurrect(self, node: str) -> None:
        """Forget ``node``'s beat and every observer's view of it — called
        by ``ElasticMembership.restore`` so a freshly restored node is
        judged on heartbeats it sends AFTER the restore, not condemned
        again by its pre-crash silence."""
        with self._lock:
            self._beats.pop(node, None)
            for view in self._views.values():
                view.pop(node, None)

    def _observers(self) -> List[str]:
        """Who receives heartbeats: every live registered node when a
        naming service is attached (suspects still observe), else every
        node that has ever beaten (bare monitors)."""
        if self.naming is not None:
            return self.naming.alive_nodes()
        return list(self._beats)

    # -------------------------------------------------------------- verdicts
    def dead_nodes(self, now: Optional[float] = None) -> List[str]:
        """Nodes whose last SENT heartbeat timed out.  PURE: unlike the
        historical version this never marks anything dead in naming —
        declaring a death (and reviving from one) is the membership's
        call, not a getter side effect."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            return [n for n, hb in self._beats.items()
                    if now - hb.t > self.timeout_s]

    def unreachable(self, observer: str, node: str,
                    now: Optional[float] = None) -> bool:
        """Whether ``observer``'s view of ``node`` has timed out (or never
        existed while the node demonstrably beats)."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            if node not in self._beats:
                return False        # never beat: no evidence either way
            hb = self._views.get(observer, {}).get(node)
            return hb is None or now - hb.t > self.timeout_s

    def verdict(self, node: str, now: Optional[float] = None
                ) -> str:
        """Aggregate the observers: ``dead`` when >= quorum of live
        observers find ``node`` silent, ``suspect`` when at least one
        (but fewer than quorum) does, else ``alive``."""
        state, _, _ = self.verdict_detail(node, now)
        return state

    def verdict_detail(self, node: str, now: Optional[float] = None
                       ) -> Tuple[str, int, int]:
        """``(verdict, silent_observers, total_observers)``."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            if node not in self._beats:
                return (ALIVE, 0, 0)    # never beat: cannot be judged
            obs = [o for o in self._observers() if o != node]
            if not obs:
                # nobody else to ask: fall back to the global timeout
                dead = now - self._beats[node].t > self.timeout_s
                return (DEAD if dead else ALIVE, int(dead), 0)
            silent = 0
            for o in obs:
                hb = self._views.get(o, {}).get(node)
                if hb is None or now - hb.t > self.timeout_s:
                    silent += 1
            q = self.quorum if self.quorum is not None \
                else len(obs) // 2 + 1
            if silent >= q:
                return (DEAD, silent, len(obs))
            if silent > 0:
                return (SUSPECT, silent, len(obs))
            return (ALIVE, 0, len(obs))

    # ------------------------------------------------------------ stragglers
    def stragglers(self) -> List[str]:
        with self._lock:
            if not self._beats:
                return []
            steps = sorted(hb.step for hb in self._beats.values())
            median = steps[len(steps) // 2]
            return [n for n, hb in self._beats.items()
                    if median - hb.step > self.lag_steps]

    def fleet_step(self) -> int:
        with self._lock:
            return min((hb.step for hb in self._beats.values()), default=0)
