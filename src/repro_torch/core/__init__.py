"""Enoki core on PyTorch: the counterpart of ``repro.core``.

Layers:
  versioning/crdt/store   — versioned KV arena + convergent merges
  keygroup/naming         — replication units + control plane
  replication             — anti-entropy (logical nodes & stacked pods)
  consistency             — client-centric session guarantees
  faas/engine/cluster/router — the FaaS programming model + testbed + routing
  network/staleness       — the paper's network emulation + metrics
  carry                   — arena state carried over from numpy
"""
from repro_torch.core.cluster import Cluster, InvokeResult
from repro_torch.core.consistency import Session
from repro_torch.core.crdt import (GCounter, LWWRegister, PNCounter,
                                   gcounter_merge, lww_merge, pncounter_merge,
                                   vv_merge)
from repro_torch.core.engine import BatchedInvocationEngine, EngineStats
from repro_torch.core.faas import (KV, FunctionSpec, VectorCodec,
                                   compile_batched_handler, enoki_function,
                                   get_function, handler_read_only, registry)
from repro_torch.core.keygroup import KeygroupSpec, TensorKeygroup
from repro_torch.core.naming import NamingService
from repro_torch.core.network import NetworkModel, paper_topology
from repro_torch.core.replication import (anti_entropy_round, converge,
                                          make_pod_replicate_step,
                                          replicate_pod_axis)
from repro_torch.core.router import Router
from repro_torch.core.staleness import WriteLog, percentiles
from repro_torch.core.store import (Store, kv_delete, kv_get, kv_scan, kv_set,
                                    kv_set_fold, merge_stores, store_new,
                                    store_select, stores_equal)
from repro_torch.core.versioning import fnv1a

__all__ = [
    "Cluster", "InvokeResult", "Session", "BatchedInvocationEngine",
    "EngineStats", "GCounter", "LWWRegister", "PNCounter", "gcounter_merge",
    "lww_merge", "pncounter_merge", "vv_merge", "KV", "FunctionSpec",
    "VectorCodec", "compile_batched_handler", "enoki_function",
    "get_function", "handler_read_only", "registry", "KeygroupSpec",
    "TensorKeygroup", "NamingService", "NetworkModel", "paper_topology",
    "anti_entropy_round", "converge", "make_pod_replicate_step",
    "replicate_pod_axis", "Router", "WriteLog", "percentiles", "Store", "kv_delete", "kv_get",
    "kv_scan", "kv_set", "kv_set_fold", "merge_stores", "store_new",
    "store_select", "stores_equal", "fnv1a",
]
