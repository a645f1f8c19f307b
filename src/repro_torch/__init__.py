"""PyTorch/CUDA port of the Enoki reproduction (``repro`` is the JAX reference).

The package mirrors ``src/repro``'s layout and keeps its module and function
names, so the counterpart of ``repro.core.store.merge_stores`` is
``repro_torch.core.store.merge_stores``.  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.

Every entry point that creates state (``Cluster``, ``store_new``,
``arena_new``, ``KeygroupSpec``) takes ``device=None``, which means the CUDA
card; on a host without one it raises (see ``repro_torch.device``).  Pass
``device="cpu"`` to run on the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""
