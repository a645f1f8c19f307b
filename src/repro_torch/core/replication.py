"""Anti-entropy replication on torch tensors: the counterpart of
``repro.core.replication``.

The paper's data plane: replicas exchange updates peer to peer and
converge through a merge (LWW/CRDT).  Two contexts share the same merges:

* **Logical nodes** (the Cluster simulator, the CRDT tests): replicas are
  separate states; ``anti_entropy_round`` merges every pair (all to all)
  or a gossip ring, and ``converge`` runs the rounds its topology needs.
* **Pods on one card**: the replicas of ``P`` pods are ONE state whose
  leaves carry the pod dim first (the idiom of
  ``launch/serve.make_replicate_sessions_step`` and
  ``make_decode_step(n_pods=P)``).  ``replicate_pod_axis`` is the
  reference's ``shard_map`` body with the collective spelled out on the
  stack: ``"full"`` folds the replicas in pod order (its ``all_gather``),
  ``"ring"`` merges each pod with pod ``i + 1`` (its ``ppermute`` pairs
  ``(i + 1, i)``).  ``make_pod_replicate_step`` builds that step for a
  device; it stays a separate step from serving, off the hot path.
* **Pods one a rank** (``mesh=``, a ``torch.distributed`` mesh with a
  ``pod`` axis): each rank holds its own pod's replica, with no pod dim,
  and the replicas cross between ranks through the reference's collectives
  (``parallel.collectives``): ``"full"`` all-gathers over ``pod`` and every
  rank folds the P replicas in pod order (P - 1 merges a rank), ``"ring"``
  ppermutes with pairs ``(i + 1, i)`` and merges once.  Every leaf moves
  in its own dtype: keys and versions cross bit for bit.

Merges may write into their first argument (``merge_arena_aligned`` runs
``enoki_merge_rows`` into it, the port's counterpart of donation), so
every function here merges into a CLONE of the replica it starts from:
the replicas it is handed come back untouched, as the reference's
immutable arrays do, and no merge of one replica can reach another's read.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.core.keygroup import TensorKeygroup, merge_tensor_keygroups
from repro_torch.core.store import Store, merge_stores, merge_stores_aligned
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.device import resolve_device

TOPOLOGIES = ("full", "ring")


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``tree_map`` over a replica: a (nested) container of tensors, a
    ``Store``, or a ``TensorKeygroup`` (its tree and its version)."""
    if isinstance(tree, TensorKeygroup):
        return TensorKeygroup(
            tree_map(fn, tree.tree, *(r.tree for r in rest)),
            fn(tree.version, *(r.version for r in rest)), tree.merge)
    return tree_map(fn, tree, *rest)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, TensorKeygroup):
        return tree_flatten(tree.tree)[0] + [tree.version]
    return tree_flatten(tree)[0]


def replica_clone(replica: Any) -> Any:
    """A deep copy of a replica into fresh tensors (``arena_clone`` for an
    arena), which a merge may then write into."""
    return _map(torch.clone, replica)


# ---------------------------------------------------------------------------
# Logical-node anti-entropy
# ---------------------------------------------------------------------------

def anti_entropy_round(replicas: List[Any], merge: Callable[[Any, Any], Any],
                       topology: str = "full") -> List[Any]:
    """One anti-entropy round over logical replicas, into new replicas.

    topology="full": every replica merges every other (converges in 1 round).
    topology="ring": replica i merges from (i-1) mod N (converges in N-1)."""
    n = len(replicas)
    if n <= 1:
        return list(replicas)
    if topology == "full":
        out = []
        for i in range(n):
            acc = replica_clone(replicas[i])
            for j in range(n):
                if j != i:
                    acc = merge(acc, replicas[j])
            out.append(acc)
        return out
    if topology == "ring":
        return [merge(replica_clone(replicas[i]), replicas[(i - 1) % n])
                for i in range(n)]
    raise ValueError(f"unknown topology {topology!r}")


def converge(replicas: List[Any], merge: Callable[[Any, Any], Any],
             topology: str = "full") -> List[Any]:
    """Run rounds until convergence is guaranteed by topology."""
    rounds = 1 if topology == "full" else max(1, len(replicas) - 1)
    for _ in range(rounds):
        replicas = anti_entropy_round(replicas, merge, topology)
    return replicas


# ---------------------------------------------------------------------------
# Pod-axis anti-entropy (the pods' replicas stacked on a leading dim)
# ---------------------------------------------------------------------------

def _take(stacked: Any, i: int) -> Any:
    return _map(lambda x: x[i], stacked)


def _stack(replicas: List[Any]) -> Any:
    return _map(lambda *xs: torch.stack(xs), *replicas)


def _merge_gathered(gathered: Any, merge: Callable[[Any, Any], Any],
                    n: int) -> Any:
    """Fold-merge the replicas stacked on a leading dim of size n, in pod
    order from pod 0, into a clone of pod 0's replica (n - 1 merges)."""
    acc = replica_clone(_take(gathered, 0))
    for i in range(1, n):
        acc = merge(acc, _take(gathered, i))
    return acc


def _replicate_ranks(state: Any, merge: Callable[[Any, Any], Any],
                     mesh, num_pods: int, topology: str) -> Any:
    """One round with this rank's replica ``state`` over the mesh's pods."""
    from repro_torch.parallel.collectives import all_gather, axis_size, \
        ppermute
    if axis_size(mesh, "pod") != num_pods:
        raise ValueError(f"{num_pods} pods on a mesh of "
                         f"{axis_size(mesh, 'pod')}")
    if topology == "full":
        gathered = _map(lambda x: all_gather(x, mesh, "pod"), state)
        return _merge_gathered(gathered, merge, num_pods)
    perm = [((i + 1) % num_pods, i) for i in range(num_pods)]
    neighbour = _map(lambda x: ppermute(x, mesh, "pod", perm), state)
    return merge(replica_clone(state), neighbour)


def replicate_pod_axis(state: Any, merge: Callable[[Any, Any], Any],
                       num_pods: int = 2, topology: str = "full",
                       mesh=None) -> Any:
    """One anti-entropy round over ``num_pods`` replicas stacked on the
    leading dim of every leaf of ``state``; returns a new stacked state.
    With ``mesh``, ``state`` is this rank's pod's replica (no pod dim) and
    the round runs over the mesh's ``pod`` axis, every rank ending with
    what the stacked form gives its pod.

    full: every pod ends with the fold of all replicas in pod order 0..n-1
          (the reference's all_gather + fold, which every pod computes
          alike): folded ONCE, n - 1 merges, and copied to every pod.
    ring: pod i merges pod (i + 1) mod n's replica, as the reference's
          ``ppermute`` pairs (i + 1, i) deliver it: n merges, each into a
          clone of pod i's replica and reading the stack as handed in."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}")
    if mesh is not None:
        return _replicate_ranks(state, merge, mesh, num_pods, topology)
    for leaf in _leaves(state):
        if leaf.ndim < 1 or leaf.shape[0] != num_pods:
            raise ValueError(f"every leaf needs the pod dim first: a leaf "
                             f"of shape {tuple(leaf.shape)} for {num_pods} "
                             "pods")
    if topology == "full":
        merged = _merge_gathered(state, merge, num_pods)
        return _stack([merged] * num_pods)
    return _stack([merge(replica_clone(_take(state, i)),
                         _take(state, (i + 1) % num_pods))
                   for i in range(num_pods)])


def make_pod_replicate_step(merge: Callable[[Any, Any], Any], num_pods: int,
                            topology: str = "full", device=None, mesh=None):
    """The off-hot-path replication step over pods stacked on ``device``
    (None: the CUDA card), or, with ``mesh``, over the mesh's pods one a
    rank: ``step(state) -> state'``, one ``replicate_pod_axis`` round.  The
    reference's ``state_specs`` (a replica's sharding inside its pod) have
    no counterpart: a rank holds its pod's whole replica."""
    dev = resolve_device(device)
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}")

    def step(state: Any) -> Any:
        for leaf in _leaves(state):
            if leaf.device.type != dev.type or dev.index not in (
                    None, leaf.device.index):
                raise ValueError(f"pod replicas on {leaf.device}, the step "
                                 f"on {dev}")
        return replicate_pod_axis(state, merge, num_pods=num_pods,
                                  topology=topology, mesh=mesh)

    return step


# Convenience merges for the two keygroup flavours --------------------------

def merge_arena(a: Store, b: Store) -> Store:
    """LWW merge of arena ``b`` into ``a``, into fresh tensors (the O(S^2)
    probe of ``merge_stores``; any slot layout)."""
    return merge_stores(a, b)


def merge_arena_aligned(a: Store, b: Store) -> Store:
    """Slot-aligned arena merge for pod-axis replication, written into
    ``a`` (returned): one ``enoki_merge_rows`` launch on the card, O(S·V).

    Every replica must carry the keygroup's canonical slot layout
    (deploy-time ``store_assign_slots``); unaligned or dynamic-key arenas
    keep ``merge_arena``."""
    return merge_stores_aligned(a, b)


def merge_tensor(a: TensorKeygroup, b: TensorKeygroup) -> TensorKeygroup:
    return merge_tensor_keygroups(a, b)
