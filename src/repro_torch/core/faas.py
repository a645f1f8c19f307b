"""The FaaS layer (tinyFaaS role): function registry, deployment, invocation.

The paper's programming model (Listing 1) is preserved as::

    @enoki_function(keygroups=["avg"])
    def call(kv, i):
        curr, found = kv.get("current")
        ...
        kv.set("current", curr)
        return curr

``kv`` is a handle whose get/set/scan/delete run torch ops on a ``Store``
(handlers are user code written with torch ops; the reference's are written
with ``jnp``).  Deployment runs the handler ONCE, eagerly, on a scratch
arena — the counterpart of the reference's ``jax.eval_shape`` trace — to
record its static per-invocation op log (kinds and payload bytes, used for
network accounting) and the key hashes it touches (used for slot
pre-assignment).  Key strings are hashed on the host: they are static,
exactly like the paper's literal key names.

Values are encoded by per-keygroup codecs (the arena stores fixed-width
rows).  Writes go into the arena the handler is given (see core/store.py).

The batched fold runs through a ``core.graphs.StepCache``: on CUDA one
captured graph per (block of requests x arena geometry x arena
addresses), replayed by every warm batch, the counterpart of the
reference's ``jax.jit`` of its ``lax.scan``.  So the kv ops never synchronise with the host: key
hashes go to the device once per key list (``_hash_tensor``), and a Python
number written by ``set`` is filled on the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.graphs import StepCache
from repro_torch.core.store import (Store, arena_clone, kv_delete, kv_get,
                                    kv_scan, kv_set, store_new)
from repro_torch.core.tree import tree_map
from repro_torch.core.versioning import MAX_NODES, fnv1a
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Codecs: python value <-> fixed-width arena row
# ---------------------------------------------------------------------------

class VectorCodec:
    """Float32 vectors up to ``width`` elements (scalars are width-1 views)."""

    def __init__(self, width: int):
        self.width = width

    def encode(self, val, device) -> Tuple[torch.Tensor, int]:
        if isinstance(val, (int, float)):
            # filled on the device: no copy from the host, so a constant
            # write can be captured in a graph
            arr = torch.full((1,), val, dtype=torch.float32, device=device)
        else:
            arr = torch.atleast_1d(torch.as_tensor(val, dtype=torch.float32,
                                                   device=device))
        n = arr.shape[0]
        if n > self.width:
            raise ValueError(f"value of length {n} exceeds arena width {self.width}")
        row = torch.zeros((self.width,), dtype=torch.float32, device=device)
        row[:n] = arr
        return row, n

    def decode(self, row: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        # static-width view; mask the padding so stale bytes never leak
        idx = torch.arange(self.width, device=row.device)
        return torch.where(idx < length, row, 0.0)


class BytesCodec:
    """uint8 payloads (for the size-sweep throughput benchmarks)."""

    def __init__(self, width: int):
        self.width = width

    def encode(self, val, device) -> Tuple[torch.Tensor, int]:
        arr = torch.as_tensor(val, dtype=torch.uint8, device=device)
        n = arr.shape[0]
        row = torch.zeros((self.width,), dtype=torch.uint8, device=device)
        row[:n] = arr
        return row, n

    def decode(self, row, length):
        return row  # callers slice by length host-side


# ---------------------------------------------------------------------------
# The kv handle (Listing 1's `import kv`)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hash_tensor(hashes: Tuple[int, ...], device: torch.device
                 ) -> torch.Tensor:
    """A scan's static key hashes on the device, made once per (key list,
    device): a copy from the host cannot be captured.  Read-only."""
    return torch.tensor(hashes, dtype=torch.int32, device=device)


class KV:
    """KV handle over one arena and one lamport clock.

    Also counts operations and payload bytes — the invocation layer charges
    network costs per op for remote placements (CLOUD_CENTRAL/PEER_FETCH).
    The byte counts equal the reference's: they feed the network charges,
    and through them every timeline field of an ``InvokeResult``.  ``mask``
    (0-d bool) gates every write: the batched fold masks bucket padding
    with it."""

    def __init__(self, store: Store, clock: torch.Tensor, node_id: int,
                 codec: VectorCodec, mask: Optional[torch.Tensor] = None):
        self._store = store
        self._clock = clock
        self._node_id = node_id
        self._codec = codec
        self._mask = mask
        self.ops: List[Tuple[str, int]] = []   # (kind, payload_bytes)
        # every key hash the handler touches — static (keys are literal
        # strings), so one deploy-time run enumerates the full key set
        self.key_hashes: List[int] = []

    # -- paper API ----------------------------------------------------------
    def get(self, key: str):
        h = fnv1a(key)
        row, length, _, found = kv_get(self._store, h)
        val = self._codec.decode(row, length)
        # float32 rows of codec width, whatever the arena dtype (as the
        # reference counts them)
        self.ops.append(("get", 4 * self._codec.width))
        self.key_hashes.append(h)
        return val, found

    def set(self, key: str, val) -> None:
        h = fnv1a(key)
        row, length = self._codec.encode(val, self._store.keys.device)
        self._store, self._clock, _ = kv_set(
            self._store, h, row, length, self._clock, self._node_id,
            mask=self._mask)
        self.ops.append(("set", row.numel() * row.element_size()))
        self.key_hashes.append(h)

    def scan(self, keys: Sequence[str]):
        hashes = [fnv1a(k) for k in keys]
        vals, lengths, founds = kv_scan(
            self._store, _hash_tensor(tuple(hashes), self._store.keys.device))
        idx = torch.arange(vals.shape[1], device=vals.device)[None, :]
        vals = torch.where(idx < lengths[:, None], vals, 0.0)
        self.ops.append(("scan", vals.numel() * vals.element_size()))
        self.key_hashes.extend(hashes)
        return vals, founds

    def delete(self, key: str) -> None:
        h = fnv1a(key)
        self._store, self._clock, _ = kv_delete(
            self._store, h, self._clock, self._node_id, mask=self._mask)
        self.ops.append(("delete", 0))
        self.key_hashes.append(h)

    # -- plumbing -------------------------------------------------------------
    @property
    def state(self) -> Tuple[Store, torch.Tensor]:
        return self._store, self._clock


# ---------------------------------------------------------------------------
# Function registry + deployment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FunctionSpec:
    name: str
    handler: Callable            # handler(kv, x) -> y
    keygroups: List[str]
    codec_width: int = 64
    calls: List[str] = dataclasses.field(default_factory=list)  # downstream fns
    async_calls: List[str] = dataclasses.field(default_factory=list)


# the port's own registry: torch handlers never mix with the reference's
_REGISTRY: Dict[str, FunctionSpec] = {}


def enoki_function(name: Optional[str] = None, keygroups: Sequence[str] = (),
                   codec_width: int = 64, calls: Sequence[str] = (),
                   async_calls: Sequence[str] = ()):
    """Decorator registering a stateful FaaS function."""

    def wrap(fn: Callable) -> Callable:
        spec = FunctionSpec(name=name or fn.__name__, handler=fn,
                            keygroups=list(keygroups), codec_width=codec_width,
                            calls=list(calls), async_calls=list(async_calls))
        _REGISTRY[spec.name] = spec
        fn.spec = spec
        return fn

    return wrap


def get_function(name: str) -> FunctionSpec:
    return _REGISTRY[name]


def registry() -> Dict[str, FunctionSpec]:
    return dict(_REGISTRY)


def as_input(x, device: torch.device):
    """A handler input (nested tuple/list/dict of arrays) as tensors on
    ``device``."""
    return tree_map(lambda a: torch.as_tensor(a, device=device), x)


def _trace(spec: FunctionSpec, node_id: int, example_input: Any,
           device: torch.device) -> KV:
    """The deploy-time run: the handler once, eagerly, on a scratch arena
    of the reference's ``_example_state`` geometry (64 slots, codec width,
    MAX_NODES).  Its ``ops``/``key_hashes`` are the static logs."""
    kv = KV(store_new(64, spec.codec_width, MAX_NODES, device=device),
            torch.zeros((), dtype=torch.int32, device=device), node_id,
            VectorCodec(spec.codec_width))
    spec.handler(kv, as_input(example_input, device))
    return kv


def compile_handler(spec: FunctionSpec, node_id: int, example_input: Any,
                    device=None) -> Callable:
    """Deploy one handler.  Returns ``step(store, clock, x) -> (store,
    clock', y, op_log)``; the handler writes into ``store``.  op_log is the
    static per-invocation (kind, bytes) trace of the deploy-time run."""
    dev = resolve_device(device)
    codec = VectorCodec(spec.codec_width)
    traced = _trace(spec, node_id, example_input, dev)
    op_log = list(traced.ops)

    def step(store, clock, x):
        kv = KV(store, clock, node_id, codec)
        y = spec.handler(kv, as_input(x, dev))
        new_store, new_clock = kv.state
        return new_store, new_clock, y, list(op_log)

    step.op_log = op_log
    step.key_hashes = tuple(dict.fromkeys(traced.key_hashes))
    step.read_only = handler_read_only(op_log)
    return step


def handler_read_only(op_log: Sequence[Tuple[str, int]]) -> bool:
    """Whether a deploy-time op trace contains no mutating store ops.

    The router uses this to decide which handlers are safe to re-invoke
    (hedged retries).  An EMPTY trace (stateless handler) is trivially
    read-only."""
    return all(k in ("get", "scan") for k, _ in op_log)


def _stack(ys: List[Any]) -> Any:
    return tree_map(lambda *leaves: torch.stack(leaves), ys[0], *ys[1:])


def compile_batched_handler(spec: FunctionSpec, node_id: int,
                            example_input: Any, device=None) -> Callable:
    """Deploy the *batched* handler — the §4.2 hot path.

    Returns ``bstep(store, clock, xs, valid, independent=False)`` where
    ``xs`` stacks B request inputs along axis 0 (tensors, or host numpy
    arrays such as the engine's staging buffers) and ``valid`` (B,) bool
    masks bucket padding.  Produces ``(store, clock', ys, op_log)`` with
    ``ys`` stacked per-request outputs.

    Execution strategy, chosen from the handler's static op trace:

    * mutating handlers — a masked sequential fold: the requests run in
      order against the arena, each write gated by its request's ``valid``
      entry, so per-key last-writer-wins semantics and the final clock are
      EXACTLY those of B sequential invocations (the reference's
      ``lax.scan`` with ``store_select``).  Writes go into ``store``;
    * read-only handlers (only get/scan ops) — every request runs against
      the shared arena, and the caller's own store/clock refs come back;
    * ``independent=True`` (stateless functions, no keygroup) — every
      request sees the arena as given: a mutating stateless handler runs on
      a per-request clone, matching B fresh-arena invocations.

    The fold runs through a ``StepCache`` (``bstep.steps``): on CUDA one
    captured graph per (block of requests, input shapes, arena geometry
    and addresses), replayed by every warm batch; ``ys`` and the clock
    come back as fresh tensors, copied out before the call returns.  A
    block is the whole bucket unless the handler is heavy: a captured
    graph unrolls its requests, so a block holds at most
    ``FOLD_GRAPH_OPS`` kv ops (``fold_block``) and a larger bucket replays
    it in turn, the clock carried from one replay to the next.  The arena
    is bound by address, except under ``independent=True``, where its
    values are an input.  ``bstep.prepare(...)`` (same arguments) makes
    the entries without running the fold (``engine.prewarm``), and
    ``bstep.eager(...)`` runs the fold's body over the whole batch, with
    no cache: the plain version the replays are held against.
    """
    dev = resolve_device(device)
    codec = VectorCodec(spec.codec_width)
    traced = _trace(spec, node_id, example_input, dev)
    op_log = list(traced.ops)
    read_only = handler_read_only(op_log)
    block = fold_block(len(op_log))

    def run(store, clock, x, mask=None):
        kv = KV(store, clock, node_id, codec, mask)
        y = spec.handler(kv, x)
        return kv.state[1], y

    def fold(state, params, inputs, independent):
        """The step's body over one block: ``(clock' or None, ys)``; None
        where the caller's clock stands (read-only, independent)."""
        if independent:
            store, clock, xs, valid = inputs
        else:
            store, (clock, xs, valid) = state, inputs
        ys = []
        if independent or read_only:
            for i in range(valid.shape[0]):
                s = store if read_only else arena_clone(store)
                ys.append(run(s, clock, tree_map(lambda t: t[i], xs))[1])
            return None, _stack(ys)
        for i in range(valid.shape[0]):
            clock, y = run(store, clock, tree_map(lambda t: t[i], xs),
                           mask=valid[i])
            ys.append(y)
        return clock, _stack(ys)

    steps = StepCache(f"fold:{spec.name}@{node_id}", fold)

    def _args(store, clock, xs, valid, independent):
        if independent:
            return {"inputs": (store, clock, xs, valid), "static": (True,)}
        return {"state": store, "inputs": (clock, xs, valid),
                "static": (False,)}

    def _blocks(n: int):
        for lo in range(0, n, block):
            yield lo, min(n, lo + block)

    def bstep(store, clock, xs, valid, independent: bool = False):
        carry, ys = clock, []
        for lo, hi in _blocks(valid.shape[0]):
            new_clock, y = steps(**_args(
                store, carry, tree_map(lambda t: t[lo:hi], xs),
                valid[lo:hi], independent))
            carry = carry if new_clock is None else new_clock
            ys.append(y)
        ys = ys[0] if len(ys) == 1 else tree_map(
            lambda *parts: torch.cat(parts), *ys)
        return store, carry, ys, list(op_log)

    def eager(store, clock, xs, valid, independent: bool = False):
        new_clock, ys = steps.eager(**_args(store, clock, xs, valid,
                                            independent))
        return (store, clock if new_clock is None else new_clock, ys,
                list(op_log))

    def prepare(store, clock, xs, valid, independent: bool = False) -> bool:
        fresh = False
        for lo, hi in dict.fromkeys(
                (0, hi - lo) for lo, hi in _blocks(valid.shape[0])):
            fresh |= steps.prepare(**_args(
                store, clock, tree_map(lambda t: t[lo:hi], xs),
                valid[lo:hi], independent))
        return fresh

    bstep.op_log = op_log
    bstep.key_hashes = tuple(dict.fromkeys(traced.key_hashes))
    bstep.read_only = read_only
    bstep.example = example_input
    bstep.block = block
    bstep.steps = steps
    bstep.eager = eager
    bstep.prepare = prepare
    return bstep


#: the most kv ops one captured fold graph unrolls (each op is ~10-25
#: small kernels, so ~25 k graph nodes): a light handler's whole bucket is
#: one graph, a heavy one's bucket a few replays of a smaller block
FOLD_GRAPH_OPS = 1024


def fold_block(n_ops: int) -> int:
    """Requests per captured fold block for a handler of ``n_ops`` kv ops
    a request: the largest power of two whose ops fit ``FOLD_GRAPH_OPS``
    (so it divides every power-of-two bucket up to it)."""
    fit = max(1, FOLD_GRAPH_OPS // max(1, n_ops))
    return 1 << (fit.bit_length() - 1)
