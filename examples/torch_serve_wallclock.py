"""Wall-clock serving on the PyTorch port: the batched engine hosted as an
actual server; the twin of ``examples/serve_wallclock.py``.

``FaasServer`` maps REAL arrival times onto the virtual timeline:

  1. client threads submit stateful requests whenever they like; the
     serving thread sleeps exactly until the next window close
     (`router.next_deadline()`) instead of polling;
  2. a closed-loop run (each client fires its next request on completion)
     shows emergent batching under feedback;
  3. a STRAGGLER topology (the nearest replica serves slowly) shows the
     windowed hedge: read-only requests whose window outlives the hedge
     deadline are duplicated at the second replica, and the earlier
     completion wins (the duplicate goes to the lowest-latency-EWMA
     replica once samples exist);
  4. the CONCURRENT dispatch pipeline: `workers=2` runs the two store
     nodes' groups of each flush cycle on per-node executors, and an
     asyncio closed loop hosts 16 LOGICAL clients on one event loop —
     no thread per client.

It runs on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_wallclock.py [--device cpu|cuda]
"""
import argparse
import asyncio
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import (Cluster, enoki_function, get_function,
                              percentiles)
from repro_torch.core.network import paper_topology
from repro_torch.core.store import kv_get
from repro_torch.core.versioning import fnv1a
from repro_torch.launch.faas_server import (FaasServer, serve_closed_loop,
                                            serve_closed_loop_async)


@enoki_function(name="wc_acc", keygroups=["wc_kg"], codec_width=16)
def wc_acc(kv, x):
    cur, found = kv.get("total")
    kv.set("total", cur + x)
    return cur[:1] + x[:1]


@enoki_function(name="wc_read", keygroups=["wc_kg"], codec_width=16)
def wc_read(kv, x):
    cur, found = kv.get("total")
    return cur[:1]


def fresh_cluster(device=None, measure_compute=False):
    cluster = Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                      net=paper_topology(), measure_compute=measure_compute,
                      device=device)
    cluster.deploy(get_function("wc_acc"), ["edge", "edge2"])
    cluster.deploy(get_function("wc_read"), ["edge", "edge2"])
    x = np.ones(16, np.float32)
    for node in ("edge", "edge2"):          # warm fold graphs + seed state
        for b in (1, 8, 64):
            cluster.invoke_batch("wc_acc", node, [x] * b)
            cluster.invoke_batch("wc_read", node, [x] * b)
    cluster.flush_replication()
    return cluster, x


def _totals(cluster) -> dict:
    """Both edges' ``total`` after every replication delivery."""
    cluster.flush_replication()
    return {node: float(kv_get(cluster.store_of("wc_kg", node),
                               fnv1a("total"))[0][0])
            for node in ("edge", "edge2")}


def run(device=None, measure_compute=False, requests=128, straggler=64,
        log=None) -> dict:
    """The demo's four parts on ``device`` (the reference example builds
    its clusters with ``measure_compute=False``); ``log`` takes each line
    ``main`` prints.  Returns each part's counts, wall time, ops/s,
    virtual latency percentiles, hedges and both edges' final ``total``."""
    say = log or (lambda line: None)
    out, merges = {}, 0

    def part(name, cluster, srv, results, wall=None, **extra):
        nonlocal merges
        pct = percentiles(srv.response_ms)
        out[name] = {"requests": len(results),
                     "resolved": sum(r is not None for r in results),
                     "pumps": srv.stats.pumps, "wall_s": wall,
                     "ops_per_s": None if wall is None
                     else len(results) / wall,
                     "p50_ms": pct[50], "p99_ms": pct[99],
                     "totals": _totals(cluster), **extra}
        merges += cluster.stats.merge_dispatches
        return out[name]

    # -- 1. open-loop wall-clock serving ------------------------------------
    cluster, x = fresh_cluster(device, measure_compute)
    t0 = time.perf_counter()
    with FaasServer(cluster, window_ms=8.0, time_scale=100.0) as srv:
        futs = [srv.submit("wc_acc", x, session_id="demo")
                for _ in range(requests)]
        outs = [f.result(timeout=30.0) for f in futs]
    wall = time.perf_counter() - t0
    p = part("open_loop", cluster, srv, outs, wall)
    say(f"open loop: {len(outs)} requests in {wall*1e3:.0f} ms wall "
        f"({len(outs)/wall:.0f} ops/s), {p['pumps']} pumps")
    say(f"  virtual latency p50/p99: {p['p50_ms']:.1f}/{p['p99_ms']:.1f} ms "
        f"(window 8 ms)")

    # -- 2. closed loop: 8 clients, next request on completion --------------
    cluster, x = fresh_cluster(device, measure_compute)
    t0 = time.perf_counter()
    with FaasServer(cluster, window_ms=4.0, time_scale=100.0) as srv:
        rs = serve_closed_loop(srv, "wc_acc", lambda i: x,
                               n_requests=requests, concurrency=8)
    wall = time.perf_counter() - t0
    p = part("closed_loop", cluster, srv, rs, wall)
    say(f"closed loop: {len(rs)} requests, {p['pumps']} pumps, "
        f"{len(rs)/wall:.0f} ops/s wall")

    # -- 3. windowed hedging on a straggler topology ------------------------
    for hedged in (False, True):
        cluster, x = fresh_cluster(device, measure_compute)
        cluster.set_compute_ms("edge", "wc_read", 60.0)     # straggler
        with FaasServer(cluster, window_ms=16.0, time_scale=100.0,
                        hedge_after_ms=4.0 if hedged else None) as srv:
            futs = [srv.submit("wc_read", x) for _ in range(straggler)]
            outs = [f.result(timeout=30.0) for f in futs]
        st = srv.router.stats
        p = part("hedged" if hedged else "unhedged", cluster, srv, outs,
                 hedges_fired=st.hedges_fired, hedge_wins=st.hedge_wins)
        extra = (f", hedges fired/won: {st.hedges_fired}/{st.hedge_wins}"
                 if hedged else "")
        say(f"straggler {'with' if hedged else 'no  '} hedge: "
            f"p50/p99 = {p['p50_ms']:.1f}/{p['p99_ms']:.1f} ms{extra}")

    # -- 4. parallel pump + asyncio clients: one process, many logical
    #       clients, per-store-node executors -------------------------------
    cluster, x = fresh_cluster(device, measure_compute)
    t0 = time.perf_counter()
    with FaasServer(cluster, window_ms=4.0, time_scale=100.0,
                    workers=2) as srv:
        rs = asyncio.run(serve_closed_loop_async(
            srv, "wc_acc", lambda i: x, n_requests=requests, concurrency=16))
    wall = time.perf_counter() - t0
    p = part("asyncio", cluster, srv, rs, wall)
    say(f"asyncio closed loop (16 logical clients, workers=2): "
        f"{len(rs)} requests, {len(rs)/wall:.0f} ops/s wall, "
        f"{p['pumps']} pumps")
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
