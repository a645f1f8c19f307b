"""Batched invocation engine on the PyTorch port: serve a burst of
concurrent stateful requests with one device dispatch; the twin of
``examples/batched_invoke.py``.

Deploys the paper's Listing-1-style counter/accumulator to an edge node,
then compares:

  1. 256 sequential ``Cluster.invoke`` calls (one Python round-trip + one
     device dispatch each — the §4.2 bottleneck), vs
  2. one ``Cluster.invoke_batch`` of the same 256 requests (one captured
     fold on the card, per-request emulated network), vs
  3. the ``submit``/``flush`` coalescing API that independent callers use,
  4. the background flusher: ``window_ms`` arrival-time windows drained by
     ``pump`` across TWO nodes in one flush cycle (cross-node fan-out).

It runs on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_batched_invoke.py [--device cpu|cuda]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import Cluster, enoki_function, get_function
from repro_torch.core.carry import (cluster_to_numpy, result_to_numpy,
                                    stats_to_dict)
from repro_torch.core.network import paper_topology


@enoki_function(name="accumulate", keygroups=["acc_kg"], codec_width=16)
def accumulate(kv, x):
    cur, found = kv.get("total")
    kv.set("total", cur + x)
    return cur[:1] + x[:1]


def _cluster(device, measure_compute):
    c = Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                net=paper_topology(), measure_compute=measure_compute,
                device=device)
    c.deploy(get_function("accumulate"), ["edge", "edge2"])
    return c


def run(device=None, measure_compute=False, burst=256, queued=32,
        windowed=64, log=None) -> dict:
    """The demo's four parts on ``device`` (the reference example builds
    its clusters with ``measure_compute=False``); ``log`` takes each line
    ``main`` prints.  Returns every result, the engine's stats, the three
    clusters and the two timed passes' ops/s, as host values."""
    say = log or (lambda line: None)
    cluster = _cluster(device, measure_compute)
    xs = [np.full(16, 1.0, np.float32) for _ in range(burst)]
    t_sends = [i * 0.1 for i in range(burst)]   # 10k rps arrival process

    # -- sequential baseline (first pass warms the step caches) -------------
    [cluster.invoke("accumulate", "edge", x, t_send=t)
     for x, t in zip(xs, t_sends)]
    t0 = time.perf_counter()
    seq = [cluster.invoke("accumulate", "edge", x, t_send=t)
           for x, t in zip(xs, t_sends)]
    np.asarray(seq[-1].output)
    seq_s = time.perf_counter() - t0

    # -- batched (same double-pass so totals line up) -----------------------
    cluster2 = _cluster(device, measure_compute)
    cluster2.invoke_batch("accumulate", "edge", xs, t_sends=t_sends)
    t0 = time.perf_counter()
    bat = cluster2.invoke_batch("accumulate", "edge", xs, t_sends=t_sends)
    bat_s = time.perf_counter() - t0

    seq, bat = [result_to_numpy(r) for r in seq], [result_to_numpy(r)
                                                  for r in bat]
    say(f"sequential: {len(seq) / seq_s:8.0f} ops/s")
    say(f"batched:    {len(bat) / bat_s:8.0f} ops/s "
        f"({seq_s / bat_s:.1f}x)")
    # identical final state: last response carries the full fold either way
    say(f"last output sequential: {float(seq[-1]['output'][0])}")
    say(f"last output batched:    {float(bat[-1]['output'][0])}")
    # per-request latency is still the emulated network's, not the batch's
    say(f"response_ms (same for all requests): {bat[0]['response_ms']:.2f}")

    # -- coalescing API -----------------------------------------------------
    cluster3 = _cluster(device, measure_compute)
    tickets = [cluster3.engine.submit("accumulate", "edge",
                                      np.full(16, 1.0, np.float32),
                                      t_send=float(i)) for i in range(queued)]
    flushed = {t: result_to_numpy(r)
               for t, r in cluster3.engine.flush().items()}
    say(f"flush() served {len(flushed)} queued requests; "
        f"last total = {float(flushed[tickets[-1]]['output'][0])}")

    # -- background flusher: windows + pump, fanned out across two nodes ----
    engine = cluster3.engine.configure(window_ms=8.0, max_batch=64)
    tickets = [engine.submit("accumulate", "edge" if i % 2 == 0 else "edge2",
                             np.full(16, 1.0, np.float32), t_send=i * 0.5)
               for i in range(windowed)]   # 2 req/ms split across 2 nodes
    before = engine.stats.windows_flushed
    served = {t: result_to_numpy(r) for t, r in engine.pump(100.0).items()}
    st = engine.stats
    windows = st.windows_flushed - before
    say(f"pump() served {len(served)} requests in {windows} windows "
        f"across 2 nodes (deadline flushes: {st.deadline_flushes})")
    # a windowed request waits at most window_ms past its solo latency
    say(f"windowed response_ms: {served[tickets[0]]['response_ms']:.2f} "
        f"(window 8.0 ms)")
    clusters = (cluster, cluster2, cluster3)
    return {"sequential": seq, "batched": bat, "flushed": flushed,
            "pumped": served, "pump_windows": windows,
            "engine_stats": stats_to_dict(st),
            "clusters": [cluster_to_numpy(c) for c in clusters],
            "sequential_ops_per_s": len(seq) / seq_s,
            "batched_ops_per_s": len(bat) / bat_s,
            "merge_dispatches": sum(c.stats.merge_dispatches
                                    for c in clusters)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    # None is the card, and raises where there is none: no CPU fallback
    return run(device=None if args.device == "cuda" else "cpu", log=print)


if __name__ == "__main__":
    main()
