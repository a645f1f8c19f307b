"""Concurrency-contract tables and the runtime lock-order validator.

Copies of ``repro.analysis.lock_order`` and ``repro.analysis.lockdep`` with
the same canonical lock names, so the port's locks are ordered by the same
``LOCK_ORDER``.  This package must stay importable without
``repro_torch.core`` (the core locks import ``lockdep`` at module load).
"""
