"""The paper's §5 demonstration on the PyTorch port: the 8-function BeFaaS
smart-city app on Enoki, data store at the edge vs in the cloud; the twin
of ``examples/smart_city.py``.  It runs on the CUDA card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_smart_city.py [--device cpu|cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np

from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core import Cluster
from repro_torch.core.carry import cluster_to_numpy, result_to_numpy
from repro_torch.core.network import paper_topology

from torch_smart_city_app import STATEFUL, deploy_app

POLICIES = [(ReplicationPolicy.REPLICATED, "edge (Enoki)"),
            (ReplicationPolicy.CLOUD_CENTRAL, "cloud store")]


def run(device=None, measure_compute=True, events=60, seed=0,
        log=None) -> dict:
    """``events`` sensor events a policy, both policies drawing from ONE
    generator seeded ``seed``; ``log`` takes each line ``main`` prints.
    Returns, for each policy's ``.value``: every event's function and
    result, each function's latencies and the cluster with the four
    stateful arenas, as host values."""
    say = log or (lambda line: None)
    rng = np.random.default_rng(seed)
    out, merges = {}, 0
    for policy, label in POLICIES:
        c = Cluster({"edge": "edge", "cloud": "cloud"}, net=paper_topology(),
                    measure_compute=measure_compute, device=device)
        deploy_app(c, policy)
        lat, results = {}, []
        for i in range(events):
            t = i * 200.0
            u = rng.random()
            name = ("traffic_sensor_filter" if u < 0.45 else
                    "object_recognition" if u < 0.9 else
                    "weather_sensor_filter")
            x = np.asarray([rng.random() * 2 - 1, 0.0], np.float32)
            res = result_to_numpy(c.invoke(name, "edge", x, t_send=t))
            results.append((name, res))
            lat.setdefault(name, []).append(res["response_ms"])
        say(f"\nstore = {label}:")
        for name, xs in sorted(lat.items()):
            say(f"  {name:24s} p50={np.percentile(xs, 50):7.1f} ms "
                f"p90={np.percentile(xs, 90):7.1f} ms (n={len(xs)})")
        cl = cluster_to_numpy(c)
        out[policy.value] = {
            "results": results, "latencies": lat, "cluster": cl,
            "arenas": {kg: {k: v for k, v in cl.items()
                            if k.endswith(f"/{kg}")}
                       for kg in STATEFUL.values()}}
        merges += c.stats.merge_dispatches
    say("\n(paper Fig 8: weather endpoint unaffected by placement; "
        "traffic/object chains pay the store RTTs via movement_plan)")
    out["merge_dispatches"] = merges
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    # None is the card, and raises where there is none: no CPU fallback
    return run(device=None if args.device == "cuda" else "cpu", log=print)


if __name__ == "__main__":
    main()
