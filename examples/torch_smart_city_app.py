"""The BeFaaS smart-city application (paper §5, Fig 7) as Enoki functions on
the PyTorch port; the twin of ``examples/smart_city_app.py``.

Eight functions across the edge-cloud continuum; four persist state in
keygroups.  Call graph (sync unless noted):

  traffic_sensor_filter (edge) --50%--> movement_plan (edge, stateful)
  object_recognition    (edge) --50%--> movement_plan
  weather_sensor_filter (edge) --async-> road_condition (cloud, stateful)
  movement_plan                --sync--> light_phase_calculation
                                         (edge, stateful)
                               --async-> traffic_statistics (cloud)
  emergency_detection   (edge) <-sync--  object_recognition

Filter convention (core/cluster.py): a handler whose output's first element
is < 0 suppresses its synchronous downstream calls.

The handlers build every constant on the input's device (``new_zeros``,
scalars in ``torch.where``): a fold on the card is a captured graph, which
takes no copy from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import enoki_function


def _pair(first, second, x):
    """[first, second] with a constant ``second``, on ``x``'s device."""
    return torch.stack([first, x.new_full((), second)])


def _padded(v, x, width):
    """The scalar ``v`` as a row of ``width``, zero-padded."""
    return torch.cat([v[None], x.new_zeros(width - 1)])


@enoki_function(name="traffic_sensor_filter", keygroups=[],
                calls=["movement_plan"], codec_width=4)
def traffic_sensor_filter(kv, x):
    # pass the event through when the measurement exceeds the threshold
    return _pair(torch.where(x[0] > 0.0, x[0], -1.0), 0.0, x)


@enoki_function(name="object_recognition", keygroups=[],
                calls=["movement_plan", "emergency_detection"], codec_width=4)
def object_recognition(kv, x):
    # "recognise" an object: a cheap deterministic feature score
    score = torch.tanh(x[0] * 3.0)
    return _pair(torch.where(x[0] > 0.0, score, -1.0), 1.0, x)


@enoki_function(name="weather_sensor_filter", keygroups=[],
                async_calls=["road_condition"], codec_width=4)
def weather_sensor_filter(kv, x):
    return _pair(torch.where(x[0] > 0.0, x[0], -1.0), 2.0, x)


@enoki_function(name="movement_plan", keygroups=["plans"],
                calls=["light_phase_calculation"],
                async_calls=["traffic_statistics"], codec_width=16)
def movement_plan(kv, x):
    """Stateful: reads the current plan, folds the event in, writes back
    (multiple kv accesses per invocation — the paper's hot path)."""
    plan, found = kv.get("plan")
    count, _ = kv.get("count")
    new_count = torch.where(found, count[0] + 1.0, 1.0)
    new_plan = torch.where(found, plan[0] * 0.9 + x[0] * 0.1, x[0])
    kv.set("plan", _padded(new_plan, x, 16))
    kv.set("count", _padded(new_count, x, 16))
    return torch.stack([new_plan, new_count])


@enoki_function(name="light_phase_calculation", keygroups=["lights"],
                codec_width=8)
def light_phase_calculation(kv, x):
    phase, found = kv.get("phase")
    new = torch.where(found, (phase[0] + 1.0) % 4.0, 0.0)
    kv.set("phase", _padded(new, x, 8))
    return new[None]


@enoki_function(name="traffic_statistics", keygroups=["stats"],
                codec_width=8)
def traffic_statistics(kv, x):
    total, found = kv.get("total")
    new = torch.where(found, total[0] + x[0], x[0])
    kv.set("total", _padded(new, x, 8))
    return new[None]


@enoki_function(name="road_condition", keygroups=["roads"], codec_width=8)
def road_condition(kv, x):
    worst, found = kv.get("worst")
    new = torch.where(found, torch.maximum(worst[0], x[0]), x[0])
    kv.set("worst", _padded(new, x, 8))
    return new[None]


@enoki_function(name="emergency_detection", keygroups=[], codec_width=4)
def emergency_detection(kv, x):
    return torch.where(x[:1] > 0.95, 1.0, 0.0)


STATEFUL = {"movement_plan": "plans", "light_phase_calculation": "lights",
            "traffic_statistics": "stats", "road_condition": "roads"}

EDGE_FNS = ["traffic_sensor_filter", "object_recognition",
            "weather_sensor_filter", "movement_plan",
            "light_phase_calculation", "emergency_detection"]
CLOUD_FNS = ["traffic_statistics", "road_condition"]


def deploy_app(cluster, data_policy, edge_nodes=("edge",),
               cloud_node="cloud"):
    """Deploy the eight functions; stateful keygroups follow data_policy."""
    from repro_torch.core.faas import get_function

    example = np.zeros((2,), np.float32)
    for fn in EDGE_FNS:
        cluster.deploy(get_function(fn), list(edge_nodes), policy=data_policy,
                       owner=cloud_node, example_input=example)
    for fn in CLOUD_FNS:
        cluster.deploy(get_function(fn), [cloud_node], policy=data_policy,
                       owner=cloud_node, example_input=example)
