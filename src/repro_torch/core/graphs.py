"""Per-shape step caches: the port's counterpart of ``jax.jit``'s call cache.

The reference runs each hot step as one compiled program, cached per
shape: the batched fold (``jax.jit(lax.scan(...))`` per bucket and store
geometry), the decode pod-step (``jax.jit(jax.vmap(step))``) and the sLSTM
recurrence (``lax.scan``); a warm call dispatches the cached executable.
Eager PyTorch issues every small op from the host instead.  A
``StepCache`` gives such a step the reference's compile-once form:

* on CUDA, the first call with a new key CAPTURES the step as a
  ``torch.cuda.CUDAGraph`` (warm-up on a side stream, then capture), and
  every call replays it: copy the inputs into the graph's static buffers,
  ``replay()``, clone the outputs out;
* on the CPU, the step runs eagerly under the same key bookkeeping, so a
  first execution of a new key counts exactly where a capture would.

``analysis.jitprof.CompileCounter`` counts new entries (captures) while
it is active, on both devices.

A step's tensors come in three kinds, and the key follows them:

* ``state`` -- read and WRITTEN IN PLACE by the step (an arena, a decode
  cache).  The graph binds their addresses, so the key holds every leaf's
  data pointer, shape, strides and dtype: a replaced arena or cache is a
  new key.  Capture does not execute, but the warm-up before it does, so
  the warm-up runs on a clone and the live state is never written twice
  (a new key of a shape the cache already holds skips the warm-up);
* ``params`` -- read by address, never written (weights): keyed like
  ``state``, and not cloned for the warm-up;
* ``inputs`` -- tensors or numpy arrays whose VALUES are copied into the
  graph's static buffers before each replay (a batch of requests, the
  clock, a token): keyed by shape and dtype only.

``static`` holds hashable Python arguments of the body (a flag, a count):
they are part of the key.

The body is ``body(state, params, inputs, *static) -> outputs``; its
outputs are new tensors (never a ``state`` leaf), cloned out of the graph
after each replay.  It must not synchronise with the host (no ``.item()``,
no copy from host memory): capture refuses both, and the step raises.
There is no fallback: a capture or a replay that fails raises, and no CUDA
call runs the eager body in its place.  ``eager`` runs the body directly,
uncounted, for tests that hold a replay against it.

Each cache keeps at most ``PER_SHAPE`` entries of one shape and
``MAX_ENTRIES`` in all (the newest used), so a run that keeps replacing
arenas (crash re-homes, restores) or meets ever new shapes (prompt
lengths) does not grow it without end.

Each cache has its own lock over its entry table, its captures and its
replays: its graphs share one memory pool, and a graph's outputs are
cloned out before any other graph of the pool can replay.  Captures of
all caches are serialised besides by one process-wide capture lock (a
capture's entry empties the allocator's cache, which must not happen
while another capture is under way), so a capture in one cache never
stops another cache's replays; an admission's evictions happen under it
too.  Capture uses ``capture_error_mode="thread_local"``, so other
threads' device work is unaffected, and runs with the garbage collector
off: a dropped cluster holds its graphs in reference cycles, and tearing
one down inside a capture invalidates the capture.  The capture lock is
taken only inside a cache's lock; the bodies take no lock.
"""
from __future__ import annotations

import collections
import gc
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_map

#: entries a cache keeps of one shape (different state addresses)
PER_SHAPE = 2
#: entries a cache keeps in all
MAX_ENTRIES = 64

#: serialises captures across every cache (see the module docstring)
_CAPTURE_LOCK = threading.Lock()
#: guards _COUNTERS, the active CompileCounters (``analysis.jitprof``)
_COUNTERS_LOCK = threading.Lock()
_COUNTERS: List[Any] = []


def add_counter(counter) -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.append(counter)


def remove_counter(counter) -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.remove(counter)


def _freeze(treedef):
    if isinstance(treedef, (list, tuple)):
        return tuple(_freeze(d) for d in treedef)
    return treedef


def _sig(x, by_address: bool, ptrs: list):
    if isinstance(x, torch.Tensor):
        if by_address:
            ptrs.append(x.data_ptr())
            return (tuple(x.shape), x.dtype, x.stride(), x.device)
        return (tuple(x.shape), x.dtype, x.device)
    a = np.asarray(x)
    return (a.shape, a.dtype.str)


def _keys(state, params, inputs, static):
    """(full key, shape key): the full key adds the data pointers of every
    ``state`` and ``params`` leaf to the shape key."""
    ptrs: list = []
    shape = [static]
    for tree, by_address in ((state, True), (params, True), (inputs, False)):
        leaves, treedef = tree_flatten(tree)
        shape.append(_freeze(treedef))
        shape.append(tuple(_sig(x, by_address, ptrs) for x in leaves))
    shape = tuple(shape)
    return (shape, tuple(ptrs)), shape


def _device_of(*trees) -> torch.device:
    for tree in trees:
        for x in tree_flatten(tree)[0]:
            if isinstance(x, torch.Tensor):
                return x.device
    raise ValueError("a step needs at least one tensor to place it")


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """An input leaf as a tensor on ``device``: a host array is copied (the
    caller may reuse its buffer as soon as the step returns)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device, copy=True)


def _static_like(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device=device)
    a = np.asarray(x)
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    return torch.empty(a.shape, dtype=dtype, device=device)


def _copy_in(statics, inputs) -> None:
    for dst, src in zip(tree_flatten(statics)[0], tree_flatten(inputs)[0]):
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.ascontiguousarray(src))
        dst.copy_(src)


def _clone_out(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class _Graph:
    __slots__ = ("graph", "inputs", "outputs")

    def __init__(self, graph, inputs, outputs):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs


class StepCache:
    """Captured graphs of one step family, one per key (see the module
    docstring).  ``captures`` counts new entries over the cache's life and
    ``capture_ms`` their host time (warm-up, capture and instantiation on
    CUDA; the first execution on the CPU); ``replays`` counts CUDA
    replays."""

    def __init__(self, name: str, body: Callable):
        self.name = name
        self._body = body
        self._lock = threading.Lock()
        # full key -> (shape key, _Graph on CUDA, None on the CPU), oldest
        # used first
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.capture_ms = 0.0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._entries)

    # -------------------------------------------------------------- public
    def __call__(self, *, state=(), params=(), inputs=(), static=()):
        """Run the step: replay its graph on CUDA (capturing it first for a
        new key), or run the body eagerly on the CPU."""
        key, shape = _keys(state, params, inputs, static)
        dev = _device_of(state, params, inputs)
        if dev.type != "cuda":
            with self._lock:
                fresh = self._touch(key)
                if fresh:
                    self._admit(key, shape, None)
            t0 = time.perf_counter()
            out = self._body(state, params,
                             tree_map(lambda x: _as_tensor(x, dev), inputs),
                             *static)
            if fresh:
                self._note_capture(t0)
            return out
        with self._lock:
            if self._touch(key):
                entry = self._capture(key, shape, state, params, inputs,
                                      static, dev)
            else:
                entry = self._entries[key][1]
            _copy_in(entry.inputs, inputs)
            entry.graph.replay()
            self.replays += 1
            return tree_map(_clone_out, entry.outputs)

    def prepare(self, *, state=(), params=(), inputs=(), static=()) -> bool:
        """Make the entry for this key without running the step on
        ``state``: capture it on CUDA; on the CPU, execute the body once on
        a clone of ``state``.  Returns whether the key was new."""
        key, shape = _keys(state, params, inputs, static)
        dev = _device_of(state, params, inputs)
        with self._lock:
            if not self._touch(key):
                return False
            if dev.type == "cuda":
                self._capture(key, shape, state, params, inputs, static, dev)
                return True
            self._admit(key, shape, None)
        t0 = time.perf_counter()
        self._body(tree_map(torch.clone, state), params,
                   tree_map(lambda x: _as_tensor(x, dev), inputs), *static)
        self._note_capture(t0)
        return True

    def eager(self, *, state=(), params=(), inputs=(), static=()):
        """The body itself on the given tensors, uncounted and uncached:
        what a replay is held against."""
        dev = _device_of(state, params, inputs)
        return self._body(state, params,
                          tree_map(lambda x: _as_tensor(x, dev), inputs),
                          *static)

    # ------------------------------------------------------------ internals
    def _touch(self, key) -> bool:
        """Under the cache's lock: mark ``key`` newest; True when it has
        no entry."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        return True

    def _admit(self, key, shape, entry) -> None:
        """Under the cache's lock: add the entry, evict the oldest of its
        shape past ``PER_SHAPE`` and the oldest of all past
        ``MAX_ENTRIES``, and count the new entry on every active
        counter."""
        self._entries[key] = (shape, entry)
        same = [k for k, (s, _) in self._entries.items() if s == shape]
        for k in same[:max(0, len(same) - PER_SHAPE)]:
            del self._entries[k]
        while len(self._entries) > MAX_ENTRIES:
            self._entries.popitem(last=False)
        with _COUNTERS_LOCK:
            for counter in _COUNTERS:
                counter.events += 1

    def _note_capture(self, t0: float) -> None:
        with self._lock:
            self.captures += 1
            self.capture_ms += (time.perf_counter() - t0) * 1e3

    def _capture(self, key, shape, state, params, inputs, static,
                 dev: torch.device) -> _Graph:
        """Under the cache's lock: warm up on a clone of ``state`` (unless
        the cache holds a graph of this shape already), then capture the
        body against the live ``state``, ``params`` and fresh
        static input buffers, and admit the entry, all under the
        process-wide capture lock (so the graphs an admission evicts are
        torn down while no stream captures).  Raises whatever the capture
        raises."""
        with _CAPTURE_LOCK:
            entry = self._capture_locked(shape, state, params, inputs,
                                         static, dev)
            self._admit(key, shape, entry)
            return entry

    def _capture_locked(self, shape, state, params, inputs, static,
                        dev: torch.device) -> _Graph:
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
            self._pool = torch.cuda.graph_pool_handle()
        statics = tree_map(lambda x: _static_like(x, dev), inputs)
        _copy_in(statics, inputs)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(dev))
        if not any(s == shape for s, _ in self._entries.values()):
            with torch.cuda.stream(side):
                # the warm-up executes: lazy module loads, cuBLAS handles
                # and workspaces on this stream, allocator pools; never on
                # the live state.  A shape this cache holds a graph of
                # (new state addresses: a restore, a re-home) was warmed
                # up already
                self._body(tree_map(torch.clone, state), params, statics,
                           *static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a dead graph in a
        # reference cycle (a dropped cluster's) would be torn down there,
        # and a teardown is refused while the stream captures, which
        # invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = self._body(state, params, statics, *static)
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        return _Graph(graph, statics, outputs)

