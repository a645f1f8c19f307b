"""Elastic membership: node join/leave/crash as first-class serving events.

``ElasticMembership`` is the recovery state machine over a ``Cluster``.
Nodes move ALIVE -> DEAD (crash or health timeout) -> ALIVE (restore with
keygroup catch-up) or ALIVE -> LEFT (graceful leave with replica
hand-off); JOINING nodes register empty and serve only after deploy.  A
crash rebalances the dead node's keygroups to surviving replicas —
falling back to checkpoint-restore (``checkpoint/manager.py``) and then to
a fresh arena when no live replica holds the state — and drops the
replication deliveries still on the wire TO the dead node, so the
engine's dead-node eviction can fail the affected tickets fast
(at-most-once) instead of hanging the serving thread.

Arenas are written in place by every fold and merge, so each copy this
module hands to another replica is an ``arena_clone``; a checkpoint-revived
arena lands where the keygroup's ``KeygroupSpec`` places it (the
cluster's device).  Every catch-up fold runs through
``Cluster._deliver_until`` (one fused ``enoki_merge_rows`` launch per
keygroup on an aligned arena).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import lockdep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core.engine import AtomicStats
from repro_torch.core.keygroup import arena_new
from repro_torch.core.store import arena_clone
from repro_torch.core.versioning import MAX_NODES

# -- membership states ------------------------------------------------------
ALIVE = "alive"
SUSPECT = "suspect"  # silent to a MINORITY of observers (partition, not
                     # crash): no rebalance, replicas intact, not routable
DEAD = "dead"       # crashed or quorum-confirmed silent; restorable
LEFT = "left"       # graceful departure; data handed off first


@dataclasses.dataclass
class MembershipStats(AtomicStats):
    crashes: int = 0
    restores: int = 0
    joins: int = 0
    leaves: int = 0
    rebalanced: int = 0             # keygroups re-homed off a dead node
    re_replicated: int = 0          # copies made to restore min_replicas
    checkpoint_restores: int = 0    # sole-replica keygroups revived from disk
    fresh_restores: int = 0         # ...or lost entirely (fresh arena)
    caught_up: int = 0              # keygroups caught up on rejoin
    dropped_deliveries: int = 0     # replication events lost with a crash
    suspects: int = 0               # ALIVE -> SUSPECT transitions
    false_suspects: int = 0         # SUSPECT -> ALIVE (reachability returned)
    epoch_rejections: int = 0       # stale-fencing-epoch deliveries rejected


class ElasticMembership:
    """The recovery state machine over a ``Cluster`` (see module docstring).

    Transitions:

        join    —  register a brand-new empty node (ALIVE once deployed to)
        crash   —  ALIVE -> DEAD: liveness off FIRST (the router's candidate
                   filter and the engine's dead-node eviction key off it),
                   then handlers stashed (a restore models restart-with-the-
                   same-binary, so nothing recompiles), on-the-wire
                   deliveries TO the node dropped, and every keygroup it
                   hosted rebalanced to the surviving replicas — checkpoint
                   or fresh-arena fallback when it held the last copy
        restore —  DEAD -> ALIVE: catch the node's keygroups up from a live
                   peer's replication-log view BEFORE flipping liveness, so
                   it never serves a stale read
        leave   —  ALIVE -> LEFT: hand sole replicas off, then depart

    ``poll`` bridges the health plane: any node a ``HealthMonitor`` newly
    reports dead is crashed through the same path as an injected kill.
    """

    def __init__(self, cluster, monitor=None,
                 checkpoint_dir: Optional[str] = None,
                 min_replicas: int = 1):
        self.cluster = cluster
        self.monitor = monitor
        self.checkpoint_dir = checkpoint_dir
        self.min_replicas = max(1, int(min_replicas))
        self.stats = MembershipStats()
        self.state: Dict[str, str] = {n: ALIVE for n in cluster.nodes}
        # restart-with-same-binary stash: (handlers, batched, compute_ms)
        self._stash: Dict[str, Tuple[dict, dict, dict]] = {}
        # which keygroups each dead node hosted at crash time (rejoin set)
        self._hosted: Dict[str, Set[str]] = {}
        self._ckpt_mgrs: Dict[str, CheckpointManager] = {}
        # outermost lock of a membership transition; cluster node/queue
        # locks nest inside it, and nothing here is called under them
        self._lock = lockdep.make_rlock("membership.lock")
        # back-reference: the drain reports stale-epoch rejections here
        cluster.membership = self

    # ------------------------------------------------------------ checkpoints
    def _ckpt(self, node: str):
        if self.checkpoint_dir is None:
            return None
        mgr = self._ckpt_mgrs.get(node)
        if mgr is None:
            mgr = CheckpointManager(os.path.join(self.checkpoint_dir, node))
            self._ckpt_mgrs[node] = mgr
        return mgr

    def checkpoint(self, node: str, step: int = 0) -> bool:
        """Persist ``node``'s keygroup stores (atomic, blocking).  The
        crash path restores from the latest of these when the node held
        the LAST live copy of a keygroup."""
        mgr = self._ckpt(node)
        if mgr is None:
            return False
        with self._lock:
            nd = self.cluster.nodes[node]
            with nd.lock:
                stores = dict(nd.stores)
            mgr.save(step, stores, blocking=True)
        return True

    def _restore_from_checkpoint(self, node: str, kg: str):
        """The dead node's latest checkpointed copy of ``kg``, or None."""
        mgr = self._ckpt(node)
        if mgr is None or mgr.latest_step() is None:
            return None
        kspec = self.cluster.policies[kg]
        template = {kg: arena_new(kspec, MAX_NODES)}
        try:
            return mgr.restore(template)[kg]
        except (KeyError, ValueError, IOError):
            return None         # kg not in the checkpoint (or corrupted)

    # ------------------------------------------------------------ transitions
    def join(self, name: str, kind: str = "edge") -> None:
        """Register a NEW empty node.  It serves a function only after a
        ``cluster.deploy`` (which compiles handlers and places keygroups);
        until then the router never picks it."""
        with self._lock:
            self.cluster.add_node(name, kind)
            self.state[name] = ALIVE
            self.stats.inc("joins")

    def crash(self, node: str) -> Dict[str, str]:
        """Kill ``node`` and rebalance.  Returns ``{keygroup: new_home}``
        for every keygroup whose LAST live copy was here (re-homed to a
        survivor via checkpoint/fresh restore); keygroups with surviving
        replicas just lose this member."""
        with self._lock:
            rehomed = self._down(node)
            if rehomed is None:
                return {}
            self.stats.inc("crashes")
            return rehomed

    def _down(self, node: str) -> Optional[Dict[str, str]]:
        """The shared take-a-node-dark path of ``crash`` and ``leave``.
        Returns the rehome map, or None when the node was not ALIVE (a
        SUSPECT node quorum-confirmed dead crashes through here too)."""
        c = self.cluster
        with self._lock:
            if self.state.get(node) not in (ALIVE, SUSPECT):
                return None
            self.state[node] = DEAD
            # 1. liveness off first: router candidates, engine eviction and
            #    _nearest_deployment all read it (mark_dead also clears any
            #    suspect flag)
            c.naming.mark_dead(node)
            nd = c.nodes[node]
            with nd.lock:
                self._stash[node] = (dict(nd.handlers),
                                     dict(nd.batched_handlers),
                                     dict(nd.compute_ms))
                nd.handlers.clear()
                nd.batched_handlers.clear()
                lost = dict(nd.stores)
                nd.stores.clear()
            # 2. what was on the wire TO the node dies with it
            self.stats.inc("dropped_deliveries",
                           c.drop_pending_deliveries(node))
            # 3. rebalance its keygroups — each bumps its fencing epoch
            #    FIRST, so any snapshot the dead node (or a peer) stamped
            #    before this crash is rejected at delivery instead of
            #    resurrecting pre-crash state past the rebalance
            self._hosted[node] = set(lost)
            rehomed: Dict[str, str] = {}
            placed: Set[str] = set()
            for kg in sorted(lost):
                c.bump_fence(kg)
                c.naming.remove_replica(kg, node)
                target = self._rebalance(node, kg, placed)
                if target is not None:
                    rehomed[kg] = target
            # 4. a re-home or a top-up put new arenas in place: make their
            #    fold graphs now, so the survivors' next requests replay
            if placed:
                c.engine.prepare_folds(stores_on=placed)
            return rehomed

    def _alive_targets(self, near: str) -> List[str]:
        """ROUTABLE nodes sorted nearest-first from ``near`` (cloud nodes
        break RTT ties last, so edge keygroups prefer edge survivors).
        Suspect nodes are excluded: re-homing state onto a node the
        majority cannot reach would strand it."""
        c = self.cluster
        alive = [n for n in c.naming.routable_nodes() if n in c.nodes]
        return sorted(alive, key=lambda n: (c.net.rtt_ms(near, n),
                                            c.nodes[n].kind == "cloud", n))

    def _rebalance(self, dead: str, kg: str,
                   placed: Set[str]) -> Optional[str]:
        """Re-home ``kg`` after ``dead`` lost its copy: pick a survivor,
        restore state (live replica > checkpoint > fresh arena), re-home
        the owner of owner-placed policies, and top the replica set back
        up to ``min_replicas``.  Adds every node given a new arena to
        ``placed``.  Returns the new home when the dead node held the last
        copy, else None."""
        c = self.cluster
        kspec = c.policies[kg]
        live = [r for r in c.naming.replicas_of(kg)
                if c.naming.is_alive(r)]
        new_home: Optional[str] = None
        if not live:
            targets = self._alive_targets(dead)
            if kspec.policy == ReplicationPolicy.CLOUD_CENTRAL:
                # cloud-central state belongs on a cloud node when one lives
                clouds = [n for n in targets if c.nodes[n].kind == "cloud"]
                targets = clouds + [n for n in targets if n not in clouds]
            if not targets:
                return None     # whole cluster down: nothing to re-home to
            new_home = targets[0]
            store = self._restore_from_checkpoint(dead, kg)
            if store is not None:
                self.stats.inc("checkpoint_restores")
            else:
                # blank_arena, not arena_new: the rebuilt replica must
                # carry the keygroup's canonical slot layout to stay
                # merge-aligned with its peers
                store = c.blank_arena(kg, kspec)
                self.stats.inc("fresh_restores")
            tnd = c.nodes[new_home]
            with tnd.lock:
                tnd.stores[kg] = store
            placed.add(new_home)
            c.naming.add_replica(kg, new_home)
            live = [new_home]
            self.stats.inc("rebalanced")
        if kspec.owner == dead:
            # owner-placed policies must point at a live store
            owner = new_home or live[0]
            c.policies[kg] = dataclasses.replace(kspec, owner=owner)
            rec = c.naming.keygroup(kg)
            if rec is not None:
                rec.spec = c.policies[kg]
        # top the replica set back up (REPLICATED only — owner policies
        # keep a single placed copy by design)
        if c.policies[kg].policy == ReplicationPolicy.REPLICATED:
            for cand in self._alive_targets(live[0]):
                if len(live) >= self.min_replicas:
                    break
                if cand in live:
                    continue
                src = c.nodes[live[0]]
                with src.lock:
                    # clone, never share: folds and merges write into
                    # the arena in place, so an aliased replica would
                    # change with its source
                    snapshot = arena_clone(src.stores[kg])
                cnd = c.nodes[cand]
                with cnd.lock:
                    cnd.stores[kg] = snapshot
                placed.add(cand)
                c.naming.add_replica(kg, cand)
                live.append(cand)
                self.stats.inc("re_replicated")
        return new_home

    def restore(self, node: str, t: float = float("inf")) -> List[str]:
        """Bring a DEAD node back: re-install its stashed handlers, catch
        its keygroups up from a live peer's view of the replication log as
        of ``t``, and only THEN mark it alive.  Returns the keygroups
        caught up."""
        c = self.cluster
        with self._lock:
            if self.state.get(node) != DEAD:
                raise ValueError(f"{node!r} is not dead (state="
                                 f"{self.state.get(node)!r})")
            nd = c.nodes[node]
            handlers, batched, compute = self._stash.pop(
                node, ({}, {}, {}))
            with nd.lock:
                nd.handlers.update(handlers)
                nd.batched_handlers.update(batched)
                nd.compute_ms.update(compute)
            caught = []
            for kg in sorted(self._hosted.pop(node, set())):
                kspec = c.policies[kg]
                if (kspec.policy != ReplicationPolicy.REPLICATED
                        and kspec.owner != node):
                    continue    # owner re-homed while we were down: the
                                # store stays there (placement stability)
                peers = [r for r in c.naming.replicas_of(kg)
                         if r != node and c.naming.is_alive(r)]
                if peers:
                    # catch-up: fold the peer's pending deliveries up to
                    # ``t`` first, so the snapshot we copy reflects the
                    # replication log, then take it wholesale
                    src = min(peers, key=lambda p: c.net.rtt_ms(node, p))
                    c._deliver_until(src, t)
                    snd = c.nodes[src]
                    with snd.lock:
                        snapshot = arena_clone(snd.stores[kg])
                else:
                    snapshot = (self._restore_from_checkpoint(node, kg)
                                or c.blank_arena(kg, kspec))
                with nd.lock:
                    nd.stores[kg] = snapshot
                c.naming.add_replica(kg, node)
                caught.append(kg)
                self.stats.inc("caught_up")
            # the caught-up arenas are new: make their fold graphs before
            # the node can be routed to, so its first requests replay
            c.engine.prepare_folds(stores_on={node})
            # liveness LAST: the node is fully caught up before the
            # router's candidate filter can see it.  The health monitor
            # forgets the node's pre-crash silence — the resurrection
            # contract: only THIS path revives a node; a stray beat from a
            # dead node never flips naming back by itself, and a restored
            # node is not instantly re-condemned by stale views.
            if self.monitor is not None:
                resurrect = getattr(self.monitor, "resurrect", None)
                if resurrect is not None:
                    resurrect(node)
            c.naming.mark_alive(node)
            self.state[node] = ALIVE
            self.stats.inc("restores")
            return caught

    def leave(self, node: str, t: float = float("inf")) -> None:
        """Graceful departure: every keygroup this node is the last (or
        owner) copy of is handed off to a survivor FIRST — deliveries up
        to ``t`` folded in, so nothing on the wire is lost — then the node
        goes dark through the crash path (which now finds every keygroup
        safely replicated elsewhere)."""
        c = self.cluster
        with self._lock:
            if self.state.get(node) != ALIVE:
                return
            nd = c.nodes[node]
            c._deliver_until(node, t)       # fold what already arrived
            with nd.lock:
                hosted = dict(nd.stores)
            placed: Set[str] = set()
            for kg in sorted(hosted):
                kspec = c.policies[kg]
                others = [r for r in c.naming.replicas_of(kg)
                          if r != node and c.naming.is_alive(r)]
                if others and kspec.owner != node:
                    continue
                targets = [n for n in self._alive_targets(node)
                           if n != node and n not in others]
                if not targets:
                    continue    # last node standing: crash path persists it
                target = targets[0]
                tnd = c.nodes[target]
                with nd.lock:
                    snapshot = arena_clone(nd.stores[kg])
                with tnd.lock:
                    tnd.stores[kg] = snapshot
                placed.add(target)
                c.naming.add_replica(kg, target)
                if kspec.owner == node:
                    c.policies[kg] = dataclasses.replace(kspec, owner=target)
                    rec = c.naming.keygroup(kg)
                    if rec is not None:
                        rec.spec = c.policies[kg]
            if placed:
                c.engine.prepare_folds(stores_on=placed)
            self._down(node)
            self.state[node] = LEFT
            self.stats.inc("leaves")

    # ------------------------------------------------------------ health plane
    def suspect(self, node: str) -> bool:
        """ALIVE -> SUSPECT: a minority of observers finds the node silent
        (partition signature).  The node drops out of the routable set —
        the router stops picking it and the engine reroutes its queued
        windows — but NOTHING is torn down: replicas stay, replication
        keeps queueing to its outboxes, no rebalance fires.  Clears by
        ``unsuspect`` (reachability returns) or hardens into a crash when
        a quorum confirms the silence."""
        with self._lock:
            if self.state.get(node) != ALIVE:
                return False
            self.state[node] = SUSPECT
            self.cluster.naming.mark_suspect(node)
            self.stats.inc("suspects")
            return True

    def unsuspect(self, node: str) -> bool:
        """SUSPECT -> ALIVE: the partition healed (or the suspicion was
        wrong) — the node becomes routable again with no catch-up needed,
        because nothing was torn down and its outbox backlog delivers on
        the healed links."""
        with self._lock:
            if self.state.get(node) != SUSPECT:
                return False
            self.state[node] = ALIVE
            self.cluster.naming.clear_suspect(node)
            self.stats.inc("false_suspects")
            return True

    def poll(self, now: Optional[float] = None) -> List[str]:
        """Drive ALIVE/SUSPECT/DEAD off the health monitor's per-observer
        verdicts: quorum-confirmed silence crashes the node (same path as
        an injected kill — within ONE poll of the views timing out), a
        minority view parks it SUSPECT, and a clean bill un-suspects it.
        Monitors without per-observer views (anything exposing only
        ``dead_nodes``) degrade to the historical crash-on-timeout.  A
        serving loop calls this each wakeup; returns the nodes crashed
        this call."""
        if self.monitor is None:
            return []
        crashed = []
        verdict = getattr(self.monitor, "verdict", None)
        if verdict is None:                     # legacy monitor shape
            for n in self.monitor.dead_nodes(now):
                with self._lock:
                    if self.state.get(n) == ALIVE:
                        self.crash(n)
                        crashed.append(n)
            return crashed
        for n, st in list(self.state.items()):
            if st not in (ALIVE, SUSPECT):
                continue
            v = verdict(n, now)
            if v == DEAD:
                with self._lock:
                    if self.state.get(n) in (ALIVE, SUSPECT):
                        self.crash(n)
                        crashed.append(n)
            elif v == SUSPECT and st == ALIVE:
                self.suspect(n)
            elif v == ALIVE and st == SUSPECT:
                self.unsuspect(n)
        return crashed

    def alive(self) -> List[str]:
        return [n for n, s in self.state.items() if s == ALIVE]

