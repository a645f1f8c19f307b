"""Checkpoint manager: async double-buffered saves, retention, restore onto
a template.

Saves run on a background thread (the caller never blocks on
serialization); a save is atomic (write to .tmp, fsync, rename).
``restore`` places every leaf on the device and in the dtype of the
template's leaf — a card arena restores onto the card, and the same file
restores onto the CPU — because the wire format is host numpy.  (The
reference's ``restore(..., shardings=)`` re-places leaves onto a JAX mesh;
the port has no mesh, and the template says where each leaf goes.)
"""
from __future__ import annotations

import os
import threading
from typing import Any, List, Optional

import torch

from repro_torch.analysis import lockdep
from repro_torch.checkpoint.serializer import deserialize_tree, serialize_tree
from repro_torch.core.tree import tree_map


def _host_copy(x):
    """A host copy the caller's later in-place writes cannot reach:
    ``Tensor.cpu()`` of a CPU tensor is the SAME tensor, so the copy is
    explicit."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = lockdep.make_lock("checkpoint.lock")

    # -- paths --------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.msgpack.zst")

    def steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".msgpack.zst"):
                out.append(int(f[len("ckpt_"):-len(".msgpack.zst")]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        # snapshot to host BEFORE handing to the writer thread so the
        # caller can write into its (device or host) state immediately
        # (double buffering); arenas are written in place, so this must be
        # a copy on every device
        host_state = tree_map(_host_copy, state)
        self.wait()

        def write():
            blob = serialize_tree(host_state)
            tmp = self._path(step) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self._path(step))
            self._retain()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self) -> None:
        with self._lock:
            steps = self.steps()
            for s in steps[:-self.keep]:
                try:
                    os.remove(self._path(s))
                except FileNotFoundError:
                    pass

    # -- restore ------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The checkpoint of ``step`` (default: the latest) in
        ``template``'s structure, each leaf on the device and in the dtype
        of the template's leaf."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(self._path(step), "rb") as f:
            return deserialize_tree(f.read(), template)
