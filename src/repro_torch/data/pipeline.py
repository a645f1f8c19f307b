"""Deterministic, shardable synthetic data pipeline: the counterpart of
``repro.data.pipeline``.

Every batch is a function of (seed, step, shard) alone: no filesystem, no
host state, so a restarted host resumes exactly from a checkpointed cursor,
data-parallel shards are disjoint, and re-sharding keeps the data (the
cursor is global; hosts slice it).  The cursor is an Enoki keygroup with
the ``max`` merge (a grow-only CRDT): a restarted host converges to the
highest step seen.

Token stream, as in the reference: Zipf-ish ids ``floor(exp(u ln V)) - 1``
(u uniform in [0, 1)), clipped to [0, V - 1], with a "grammar": with
probability 0.5 a position's token is ``(prev * 7 + 1) mod V``, prev being
the Zipf draw one position back, so the LM loss falls during a run.

The numbers differ from the reference's: it draws with ``jax.random``
(threefry), the port with a ``torch.Generator`` on the CPU seeded by
``batch_seed(seed, step, shard)``, a splitmix64 chain.  A seed gives the
same batch on the CPU and on the card (the batch is drawn on the CPU and
then moved).  Per batch the draws come in this order: the Zipf uniforms
(b, s + 1), the grammar's uniforms (b, s + 1) (a position follows the rule
where its uniform is < 0.5), then the vlm's ``patch_embeds`` or whisper's
``frame_embeds`` (b, num_patches, d) as normal x 0.02.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.keygroup import TensorKeygroup
from repro_torch.device import resolve_device

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def batch_seed(seed: int, step: int, shard: int) -> int:
    """The generator seed of one batch: splitmix64 folded over seed, step
    and shard (the reference's ``fold_in(fold_in(key(seed), step),
    shard)``), cut to 63 bits."""
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (step & _MASK64))
    h = _splitmix64(h ^ (shard & _MASK64))
    return h >> 1


def synthetic_batch(arch: ArchConfig, shape: ShapeConfig, seed: int,
                    step: int, shard: int = 0, num_shards: int = 1,
                    batch_override: Optional[int] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """One (possibly sharded) batch for ``step`` on ``device`` (None: the
    card): int32 ``tokens``/``labels`` (b, s), f32 ``loss_mask`` (b, s),
    and the vlm's ``patch_embeds`` (the mask zeroed over the patches) or
    whisper's ``frame_embeds``, (b, num_patches, d) f32.  Deterministic."""
    dev = resolve_device(device)
    b = (batch_override or shape.global_batch) // num_shards
    s = shape.seq_len
    gen = torch.Generator().manual_seed(batch_seed(seed, step, shard))
    vocab = arch.vocab_size
    u = torch.rand((b, s + 1), generator=gen)
    base = torch.exp(u * math.log(vocab)).to(torch.int32) - 1
    base = torch.clamp(base, 0, vocab - 1)
    # learnable structure: with p=0.5 the next token = (prev*7+1) mod V
    follow = torch.rand((b, s + 1), generator=gen) < 0.5
    rolled = (torch.roll(base, 1, dims=1) * 7 + 1) % vocab
    stream = torch.where(follow, rolled, base)
    batch = {"tokens": stream[:, :-1], "labels": stream[:, 1:],
             "loss_mask": torch.ones((b, s), dtype=torch.float32)}
    embeds = {"clip_patches": "patch_embeds",
              "audio_frames": "frame_embeds"}.get(arch.frontend_stub)
    if embeds:
        batch[embeds] = torch.randn((b, arch.num_patches, arch.d_model),
                                    generator=gen) * 0.02
    if arch.frontend_stub == "clip_patches":
        batch["loss_mask"][:, :arch.num_patches] = 0
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def rank_batch(arch: ArchConfig, shape: ShapeConfig, seed: int, step: int,
               mesh, axes=("data",), batch_override: Optional[int] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """This rank's shard of ``step``'s batch on ``mesh``:
    ``synthetic_batch`` with the rank's index over ``axes`` (its
    ``axis_index`` on ``data``, or on ``("pod", "data")`` for CLOUD_CENTRAL
    and PEER_FETCH, the first named major as a batch spec lays them) as
    ``shard``, of their sizes' product; axes the mesh lacks count as 1."""
    from repro_torch.parallel.collectives import axis_index, axis_size
    shard, n = 0, 1
    for a in axes:
        if a in mesh.mesh_dim_names:
            shard = shard * axis_size(mesh, a) + axis_index(mesh, a)
            n *= axis_size(mesh, a)
    return synthetic_batch(arch, shape, seed, step, shard=shard,
                           num_shards=n, batch_override=batch_override,
                           device=device)


@dataclasses.dataclass
class DataPipeline:
    """Host-side iterator with a replicable cursor keygroup on ``device``
    (None: the card), where the batches land too."""

    arch: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    batch_override: Optional[int] = None
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.cursor = TensorKeygroup.create(
            {"step": torch.zeros((), dtype=torch.int32, device=self.device)},
            merge="max")

    @property
    def step(self) -> int:
        return int(self.cursor.tree["step"])

    def next(self) -> Dict[str, torch.Tensor]:
        batch = synthetic_batch(self.arch, self.shape, self.seed, self.step,
                                self.shard, self.num_shards,
                                self.batch_override, device=self.device)
        self.cursor = self.cursor.write(
            {"step": self.cursor.tree["step"] + 1})
        return batch

    def restore(self, cursor: TensorKeygroup) -> None:
        """Adopt a replicated or checkpointed cursor (max-merge: never
        rewind)."""
        self.cursor = self.cursor.merged_with(cursor)
