"""Quickstart on the PyTorch port: the paper's Listing 1 on a three-node
Enoki cluster; the twin of ``examples/quickstart.py``.

Deploys a stateful function to two edge nodes with a replicated keygroup,
invokes it through the router, and prints what the paper is about: local
access latency vs the cloud alternative, and the staleness you pay.  It
runs on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu|cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core import Cluster, Router, enoki_function, get_function
from repro_torch.core.carry import cluster_to_numpy, result_to_numpy
from repro_torch.core.network import paper_topology
from repro_torch.core.store import kv_get
from repro_torch.core.versioning import fnv1a


# Listing 1 — "import kv" becomes the kv handle; keys are plain strings.
@enoki_function(name="hello", keygroups=["greetings"], codec_width=16)
def call(kv, i):
    curr, found = kv.get("current")
    count = torch.where(found, curr[0] + 1.0, 1.0)     # "Hello World!\n" += 1
    kv.set("current", torch.cat([count[None], i.new_zeros(15)]))
    return count[None]


def run(device=None, measure_compute=True, calls=5, log=None) -> dict:
    """The quickstart's scenario on ``device``; ``log`` takes each line
    ``main`` prints.  Returns every call's result, each edge replica's
    ``current``, the cloud-store call and both clusters, as host values."""
    say = log or (lambda line: None)
    zero = np.zeros((1,), np.float32)
    cluster = Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                      net=paper_topology(), measure_compute=measure_compute,
                      device=device)
    say("deploying 'hello' to edge+edge2 (keygroup replicated, Enoki)…")
    cluster.deploy(get_function("hello"), ["edge", "edge2"],
                   policy=ReplicationPolicy.REPLICATED, example_input=zero)
    router = Router(cluster, client="client")

    t, results = 0.0, []
    for i in range(calls):
        res = result_to_numpy(router.invoke("hello", zero, t_send=t,
                                            session_id="alice"))
        results.append(res)
        say(f"  call {i}: node={res['node']:6s} count="
            f"{float(res['output'][0]):.0f} "
            f"latency={res['response_ms']:6.1f} ms "
            f"(kv ops: {[k for k, _ in res['kv_ops']]})")
        t = res["t_received"] + 100.0

    # the counter lives in the keygroup, replicated to both edges
    cluster.flush_replication()
    replicas = {}
    for node in ("edge", "edge2"):
        val, _, _, _ = kv_get(cluster.store_of("greetings", node),
                              fnv1a("current"))
        replicas[node] = float(val[0])
        say(f"replica on {node:6s}: current = {replicas[node]:.0f}")

    # same function, store forced to the cloud (the paper's baseline)
    cluster2 = Cluster({"edge": "edge", "cloud": "cloud"},
                       net=paper_topology(), measure_compute=measure_compute,
                       device=device)
    cluster2.deploy(get_function("hello"), ["edge"],
                    policy=ReplicationPolicy.CLOUD_CENTRAL, owner="cloud",
                    example_input=zero)
    cloud = result_to_numpy(cluster2.invoke("hello", "edge", zero))
    say(f"\nsame call with the store in the cloud: "
        f"{cloud['response_ms']:6.1f} ms"
        f"  (every kv op pays the 50 ms RTT — Fig 3)")
    return {"calls": results, "replicas": replicas, "cloud": cloud,
            "cloud_ms": cloud["response_ms"],
            "cluster": cluster_to_numpy(cluster),
            "cloud_cluster": cluster_to_numpy(cluster2),
            "merge_dispatches": cluster.stats.merge_dispatches
            + cluster2.stats.merge_dispatches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    # None is the card, and raises where there is none: no CPU fallback
    return run(device=None if args.device == "cuda" else "cpu", log=print)


if __name__ == "__main__":
    main()
