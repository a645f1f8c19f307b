"""Central naming service (the etcd role in FReD).

Holds global configuration — keygroup -> replica set & policy, function ->
deployment set — as CONTROL state only.  Exactly like the paper: the naming
service is consulted when deploying or re-configuring, never on the data
path.  It is deliberately a plain in-process object; at real scale it would
be backed by etcd/Zookeeper, and the interface below is what the rest of the
system is allowed to depend on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from repro_torch.analysis import lockdep
from repro_torch.core.keygroup import KeygroupSpec


@dataclasses.dataclass
class KeygroupRecord:
    spec: KeygroupSpec
    replicas: Set[str] = dataclasses.field(default_factory=set)
    config_version: int = 0


@dataclasses.dataclass
class FunctionRecord:
    name: str
    keygroups: List[str]
    deployed_to: Set[str] = dataclasses.field(default_factory=set)


class NamingService:
    """Thread-safe control-plane registry."""

    def __init__(self) -> None:
        self._lock = lockdep.make_lock("naming.lock")   # leaf: dict ops only
        self._keygroups: Dict[str, KeygroupRecord] = {}
        self._functions: Dict[str, FunctionRecord] = {}
        self._nodes: Dict[str, dict] = {}

    # -- node membership (heartbeats feed this; see runtime/health.py) -----
    def register_node(self, name: str, kind: str = "edge", **meta) -> None:
        with self._lock:
            self._nodes[name] = {"kind": kind, "alive": True,
                                 "suspect": False, **meta}

    def mark_dead(self, name: str) -> None:
        with self._lock:
            if name in self._nodes:
                self._nodes[name]["alive"] = False
                self._nodes[name]["suspect"] = False

    def mark_alive(self, name: str) -> None:
        """Re-admit a node (rejoin after crash/leave).  Callers must have
        caught the node's keygroups up FIRST (see runtime/elastic.py):
        liveness is what the router's candidate filter reads, so flipping
        it early would serve stale reads."""
        with self._lock:
            if name in self._nodes:
                self._nodes[name]["alive"] = True
                self._nodes[name]["suspect"] = False

    def mark_suspect(self, name: str) -> None:
        """Park a node SUSPECT (minority reachability view — see
        runtime/elastic.py): it stays ALIVE (replicas intact, replication
        keeps queueing to it) but drops out of the ROUTABLE set, so the
        router and the engine's reroute paths stop picking it."""
        with self._lock:
            if name in self._nodes:
                self._nodes[name]["suspect"] = True

    def clear_suspect(self, name: str) -> None:
        with self._lock:
            if name in self._nodes:
                self._nodes[name]["suspect"] = False

    def is_alive(self, name: str) -> bool:
        with self._lock:
            m = self._nodes.get(name)
            return bool(m and m["alive"])

    def is_suspect(self, name: str) -> bool:
        with self._lock:
            m = self._nodes.get(name)
            return bool(m and m.get("suspect"))

    def is_routable(self, name: str) -> bool:
        """Alive AND not suspect: eligible to receive NEW work.  Routing
        reads this; replication/liveness bookkeeping keeps reading
        ``is_alive`` (a suspect node's replicas are not torn down)."""
        with self._lock:
            m = self._nodes.get(name)
            return bool(m and m["alive"] and not m.get("suspect"))

    def alive_nodes(self) -> List[str]:
        with self._lock:
            return [n for n, m in self._nodes.items() if m["alive"]]

    def routable_nodes(self) -> List[str]:
        with self._lock:
            return [n for n, m in self._nodes.items()
                    if m["alive"] and not m.get("suspect")]

    def node_kind(self, name: str) -> str:
        return self._nodes[name]["kind"]

    # -- keygroups ----------------------------------------------------------
    def create_keygroup(self, spec: KeygroupSpec) -> KeygroupRecord:
        with self._lock:
            if spec.name in self._keygroups:
                return self._keygroups[spec.name]
            rec = KeygroupRecord(spec=spec)
            self._keygroups[spec.name] = rec
            return rec

    def keygroup(self, name: str) -> Optional[KeygroupRecord]:
        return self._keygroups.get(name)

    def add_replica(self, kg_name: str, node: str) -> KeygroupRecord:
        with self._lock:
            rec = self._keygroups[kg_name]
            if node not in rec.replicas:
                rec.replicas.add(node)
                rec.config_version += 1
            return rec

    def remove_replica(self, kg_name: str, node: str) -> None:
        with self._lock:
            rec = self._keygroups[kg_name]
            rec.replicas.discard(node)
            rec.config_version += 1

    def replicas_of(self, kg_name: str) -> Set[str]:
        rec = self._keygroups.get(kg_name)
        return set(rec.replicas) if rec else set()

    # -- functions ------------------------------------------------------------
    def register_function(self, name: str, keygroups: List[str]) -> FunctionRecord:
        with self._lock:
            rec = self._functions.get(name) or FunctionRecord(name, list(keygroups))
            self._functions[name] = rec
            return rec

    def add_deployment(self, fn_name: str, node: str) -> None:
        with self._lock:
            self._functions[fn_name].deployed_to.add(node)

    def remove_deployment(self, fn_name: str, node: str) -> None:
        with self._lock:
            rec = self._functions.get(fn_name)
            if rec is not None:
                rec.deployed_to.discard(node)

    def deployments_of(self, fn_name: str) -> Set[str]:
        rec = self._functions.get(fn_name)
        return set(rec.deployed_to) if rec else set()

    def function(self, name: str) -> Optional[FunctionRecord]:
        return self._functions.get(name)
