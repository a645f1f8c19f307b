"""The node-local key-value store (FReD-replica analogue), on torch tensors.

A store replica is a fixed-capacity *arena*, exactly the reference layout:

    keys      (S,)    int32   FNV-1a key hashes, 0 == empty slot
    values    (S, V)  dtype   fixed-width payload rows (padded)
    lengths   (S,)    int32   actual payload length; -1 == tombstone
    versions  (S,)    int32   packed lamport versions (see versioning.py)
    vv        (N,)    int32   version vector: highest clock seen per node

In-place updates (the decision every other module follows): writes, folds
and merges WRITE INTO THE ARENA THEY ARE HANDED — ``kv_set``/``kv_delete``
update their slot with masked ``index_copy_``s, ``merge_stores_aligned`` and
``merge_snapshots_fused`` fold into their accumulator, and
``store_assign_slots`` stamps its layout into the arena.  This is the port's
counterpart of JAX buffer donation, so ``donation_enabled()`` is True on
every device, the CPU included, and every site that keeps a snapshot past a
later fold or merge must hold an ``arena_clone``, never the live arena:
replication snapshots and deploy-time replica copies (core/cluster.py), the
compute-time probe of a handler (``Cluster._measure_compute``) and the
prewarm scratch arenas (core/engine.py).  ``merge_stores`` alone stays pure:
it is the O(S^2) fallback body and the reference the aligned path is tested
against.

Conditional writes keep the reference's masked form (``torch.where`` on a
0-d predicate, slots picked by ``argmax``), so a write costs no host sync;
``store_assign_slots`` is the one host round trip, at deploy time.

Writes that find neither their key nor an empty slot are dropped with
``ok=False`` (arena overflow).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.versioning import VERSION_DTYPE, pack_version
from repro_torch.device import resolve_device
from repro_torch.kernels.enoki_merge.kernel import enoki_merge_rows


class Store(NamedTuple):
    keys: torch.Tensor       # (S,) int32
    values: torch.Tensor     # (S, V)
    lengths: torch.Tensor    # (S,) int32; -1 marks a tombstone
    versions: torch.Tensor   # (S,) int32 packed
    vv: torch.Tensor         # (N,) int32 version vector

    @property
    def slots(self) -> int:
        return self.keys.shape[0]

    @property
    def value_width(self) -> int:
        return self.values.shape[1]


def store_new(slots: int, value_width: int, num_nodes: int,
              dtype=torch.float32, device=None) -> Store:
    dev = resolve_device(device)
    return Store(
        keys=torch.zeros((slots,), dtype=torch.int32, device=dev),
        values=torch.zeros((slots, value_width), dtype=dtype, device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=dev),
        versions=torch.zeros((slots,), dtype=VERSION_DTYPE, device=dev),
        vv=torch.zeros((num_nodes,), dtype=torch.int32, device=dev),
    )


def _row_mask(pred: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return pred.reshape(pred.shape + (1,) * (x.ndim - pred.ndim))


def store_select(pred, a: Store, b: Store) -> Store:
    """``pred ? a : b`` over every arena leaf (pred: 0-d bool), into fresh
    tensors."""
    pred = torch.as_tensor(pred, device=a.keys.device)
    return Store(*(torch.where(_row_mask(pred, x), x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# Single-key ops
# ---------------------------------------------------------------------------

def _locate(store: Store, key_hash
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical slot probe.  Returns ``(slot, found, ok)`` as 0-d tensors:

    * ``slot``  — the matching slot when ``found``, else the first empty
      slot (the dynamic-key fallback assignment),
    * ``found`` — whether ``key_hash`` already occupies a slot (live OR
      tombstoned; occupancy, not liveness),
    * ``ok``    — False only on arena overflow (no match and no empty
      slot); callers drop the write.

    ``torch.argmax`` takes no bool tensor, so the masks are cast to int32;
    its tie rule (the FIRST maximal index) is the reference's, which is
    what lands a pre-assigned key on the same slot on every replica."""
    match = store.keys == key_hash
    found = match.any()
    empty = store.keys == 0
    slot = torch.where(found, torch.argmax(match.to(torch.int32)),
                       torch.argmax(empty.to(torch.int32)))
    ok = found | empty.any()
    return slot, found, ok


def _get(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # index_select, not t[slot]: indexing with a 0-d tensor reads it back
    # to the host
    return t.index_select(0, idx)[0]


def _put(t: torch.Tensor, idx: torch.Tensor, write: torch.Tensor,
         new) -> None:
    """``t[idx] = new if write else t[idx]``, in place, with no host sync."""
    if isinstance(new, torch.Tensor):
        new = new.to(t.dtype)
    t.index_copy_(0, idx, torch.where(write, new, t.index_select(0, idx)))


def kv_get(store: Store, key_hash
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (value_row, length, version, found).

    Tombstone-read contract: ``found`` here is liveness — a tombstoned key
    (length < 0) reads as absent: zero value, zero length, found=False.
    Its version still reads through so causal consumers can observe the
    delete."""
    slot, found, _ = _locate(store, key_hash)
    idx = slot.reshape(1)
    length = _get(store.lengths, idx)
    live = found & (length >= 0)
    row = _get(store.values, idx)
    value = torch.where(live, row, torch.zeros_like(row))
    version = torch.where(found, _get(store.versions, idx),
                          torch.zeros_like(length))
    return value, torch.where(live, length, torch.zeros_like(length)), \
        version, live


def _stamp(store: Store, clock, node_id: int, write: torch.Tensor):
    """The write's new clock and packed version, and the vv bump."""
    new_clock = torch.maximum(clock, store.vv.max()) + 1
    cur = store.vv[node_id]
    store.vv[node_id] = torch.where(write, torch.maximum(cur, new_clock), cur)
    return new_clock, pack_version(new_clock, node_id)


def kv_set(store: Store, key_hash, value_row, length, clock, node_id,
           mask=None) -> Tuple[Store, torch.Tensor, torch.Tensor]:
    """Write (upsert) into ``store``.  Returns (store, new_clock, ok).

    The node's lamport clock advances past everything this replica has seen
    (max of vv) so versions from causally-later writes always dominate.
    ``mask`` (0-d bool) gates the write like arena overflow does: a masked
    write leaves the arena and the clock as they were (the batched fold's
    bucket padding)."""
    slot, _, ok = _locate(store, key_hash)
    write = ok if mask is None else ok & mask
    idx = slot.reshape(1)
    new_clock, version = _stamp(store, clock, node_id, write)
    _put(store.keys, idx, write, key_hash)
    _put(store.values, idx, write, value_row)
    _put(store.lengths, idx, write, length)
    _put(store.versions, idx, write, version)
    return store, torch.where(write, new_clock, clock), write


def kv_delete(store: Store, key_hash, clock, node_id, mask=None
              ) -> Tuple[Store, torch.Tensor, torch.Tensor]:
    """Tombstone write (length = -1) so deletes replicate like updates."""
    slot, found, _ = _locate(store, key_hash)
    write = found if mask is None else found & mask
    idx = slot.reshape(1)
    new_clock, version = _stamp(store, clock, node_id, write)
    _put(store.values, idx, write, 0)
    _put(store.lengths, idx, write, -1)
    _put(store.versions, idx, write, version)
    return store, torch.where(write, new_clock, clock), write


def kv_scan(store: Store, key_hashes
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorised multi-get: (values (K,V), lengths (K,), found (K,))."""
    h = torch.as_tensor(key_hashes, dtype=torch.int32, device=store.keys.device)
    match = store.keys[None, :] == h[:, None]
    found = match.any(dim=1)
    empty = store.keys == 0
    slot = torch.where(found, torch.argmax(match.to(torch.int32), dim=1),
                       torch.argmax(empty.to(torch.int32)))
    lengths = store.lengths[slot]
    live = found & (lengths >= 0)
    vals = torch.where(live[:, None], store.values[slot], 0)
    return vals, torch.where(live, lengths, 0), live


def kv_set_fold(store: Store, key_hashes, rows, lengths, clock, node_id
                ) -> Tuple[Store, torch.Tensor, torch.Tensor]:
    """Batched upsert: the sequential fold of N ``kv_set``s, in order, so
    per-key last-writer-wins, version stamping and the final clock match N
    separate ``kv_set`` calls exactly.  Returns (store, clock', oks (B,))."""
    oks = []
    for h, row, ln in zip(key_hashes, rows, lengths):
        store, clock, ok = kv_set(store, h, row, ln, clock, node_id)
        oks.append(ok)
    return store, clock, torch.stack(oks)


# ---------------------------------------------------------------------------
# Replica merge (the anti-entropy inner op)
# ---------------------------------------------------------------------------

def merge_stores(a: Store, b: Store) -> Store:
    """LWW merge of replica ``b`` into ``a``, into FRESH tensors (pure;
    commutative up to slot permutation, and convergent).

    1. keys present in both  -> keep the higher packed version,
    2. keys only in ``b``    -> insert into a's empty slots (rank-matched),
    3. version vectors       -> elementwise max.

    O(S^2) comparisons: the fallback for keygroups that lost their slot
    alignment (slot-aligned keygroups take ``merge_stores_aligned``)."""
    b_live = b.keys != 0
    # --- 1. matched keys -------------------------------------------------
    match = (a.keys[:, None] == b.keys[None, :]) & b_live[None, :]   # (Sa, Sb)
    a_has_match = match.any(dim=1)
    b_idx = torch.argmax(match.to(torch.int32), dim=1)               # (Sa,)
    b_versions = b.versions[b_idx]
    take_b = a_has_match & (b_versions > a.versions)

    keys = torch.where(take_b, b.keys[b_idx], a.keys)
    values = torch.where(_row_mask(take_b, a.values), b.values[b_idx],
                         a.values)
    lengths = torch.where(take_b, b.lengths[b_idx], a.lengths)
    versions = torch.where(take_b, b_versions, a.versions)

    # --- 2. b-only keys -> empty slots of a -------------------------------
    b_new = b_live & ~match.any(dim=0)
    empty = keys == 0
    # rank-match: the i-th new b key goes to the i-th empty a slot
    empty_rank = torch.cumsum(empty.to(torch.int32), 0) - 1
    new_rank = torch.cumsum(b_new.to(torch.int32), 0) - 1
    lands = (empty[:, None] & b_new[None, :]
             & (empty_rank[:, None] == new_rank[None, :]))            # (Sa, Sb)
    has_insert = lands.any(dim=1)
    src = torch.argmax(lands.to(torch.int32), dim=1)

    keys = torch.where(has_insert, b.keys[src], keys)
    values = torch.where(_row_mask(has_insert, values), b.values[src], values)
    lengths = torch.where(has_insert, b.lengths[src], lengths)
    versions = torch.where(has_insert, b.versions[src], versions)

    # --- 3. version vectors ------------------------------------------------
    return Store(keys=keys, values=values, lengths=lengths,
                 versions=versions, vv=torch.maximum(a.vv, b.vv))


# ---------------------------------------------------------------------------
# Device-resident merge path: slot-aligned arenas + fused multi-way merge
# ---------------------------------------------------------------------------

def donation_enabled() -> bool:
    """Whether folds and merges reuse the arena they are handed: always, in
    the port (see the module docstring) — so every snapshot that outlives
    a later fold or merge must be an ``arena_clone``."""
    return True


def arena_clone(store: Store) -> Store:
    """Deep-copy an arena into fresh device buffers (snapshot hygiene)."""
    return Store(*(t.clone() for t in store))


def merge_stores_aligned(a: Store, b: Store) -> Store:
    """Elementwise LWW merge of SLOT-ALIGNED replica ``b`` into ``a``
    (written into ``a``; returns ``a``).

    Precondition: ``a.keys == b.keys`` slot for slot (deploy-time key
    pre-assignment, see ``store_assign_slots``).  Each slot is its own
    match, so the merge is the per-row versioned select of the
    ``enoki_merge_rows`` kernel: O(S·V) instead of ``merge_stores``'s
    O(S²) probe.  Bit-compatible with ``merge_stores`` on aligned arenas:
    a strictly greater version takes ``b``'s row, keys and length (ties
    keep ``a``), version vectors max elementwise."""
    return merge_snapshots_fused(a, (b,), aligned=True)


def merge_snapshots_fused(acc: Store, snaps: Sequence[Store], *,
                          aligned: bool) -> Store:
    """Merge K queued snapshots into ``acc``, in order, written into
    ``acc`` (returned).

    Order-preserving: identical to folding ``merge_stores`` (or the
    aligned variant) left to right.  On the aligned path this is ONE
    ``enoki_merge_rows`` launch for all K snapshots (keys, lengths and vv
    included); the fallback folds ``merge_stores`` and copies the result
    into ``acc``.  (The reference pads K up to a bucket to bound jit
    retraces; eager PyTorch has nothing to retrace, so K runs as is.)"""
    snaps = tuple(snaps)
    if not snaps:
        return acc
    if aligned:
        enoki_merge_rows(acc, snaps)
        return acc
    out = acc
    for snap in snaps:
        out = merge_stores(out, snap)
    for dst, src in zip(acc, out):
        dst.copy_(src)
    return acc


def store_assign_slots(store: Store, assignments: Dict[int, int]
                       ) -> Tuple[Store, bool]:
    """Stamp a deploy-time key→slot layout into ``store`` (host round trip,
    then copied back into the arena's own tensors).

    Each key hash is written into its canonical slot as a version-0
    tombstone (length -1, zero payload): reads still see it as absent, and
    ``_locate``'s argmax probe lands on the same slot on every replica that
    received the same layout — which is what makes the elementwise
    ``merge_stores_aligned`` path valid.

    Returns ``(store, ok)``.  ``ok`` is False, with the arena untouched,
    when the layout cannot be applied — a slot already holds a DIFFERENT
    key, or the hash already lives in some other slot: the caller must
    mark the keygroup unaligned and keep the O(S²) fallback."""
    keys = store.keys.cpu().numpy().copy()
    lengths = store.lengths.cpu().numpy().copy()
    occupied = {int(k): i for i, k in enumerate(keys) if k != 0}
    changed = False
    for h, slot in assignments.items():
        h = int(h)
        cur = int(keys[slot])
        if cur == h:
            continue
        if cur != 0 or h in occupied:
            return store, False
        keys[slot] = h
        lengths[slot] = -1
        occupied[h] = slot
        changed = True
    if changed:
        store.keys.copy_(torch.from_numpy(keys))
        store.lengths.copy_(torch.from_numpy(lengths))
    return store, True


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor (bf16, which numpy lacks, widens to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def store_contents(store: Store) -> dict:
    """Host-side canonical view {key_hash: (version, length, value)} for tests."""
    keys, values, lengths, versions = (to_numpy(t) for t in store[:4])
    out = {}
    for i, k in enumerate(keys):
        if k != 0:
            out[int(k)] = (int(versions[i]), int(lengths[i]),
                           values[i].tolist())
    return out


def stores_equal(a: Store, b: Store) -> bool:
    """Exact equality of two arenas as REPLICAS: same live contents, same
    versions, same version vector — slot layout ignored."""
    return (bool(torch.equal(a.vv.cpu(), b.vv.cpu()))
            and store_contents(a) == store_contents(b))
