"""What ``BENCHMARK.json`` names, found by name in the benchmark's files.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the
configuration: its source, published sizes, ``reduced``, ``assumed``, the
program's architecture id and the reference's module and sizes),
``traffic/<traffic>.json`` (the mix: its parameters and its ``kind``,
whose generator is ``kinds/<kind>.py``) and ``cells/<cell>.json`` (the
limits ``correct`` holds it to).  A per-layer metric ``m`` is read by
``metrics/<m>.py``, whose ``read(run)`` returns a number or None.  A
later cell, mix, kind or metric is new files and entries, not an edit of
these.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def sizes(self) -> dict:
        return self.config["reference"]["sizes"]

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(
            "portbench.reference." + self.config["reference"]["module"])


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files read; raises
    ``KeyError`` for a name it does not list."""
    bench = bench or benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cfg = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    here = root / "portbench"
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(root / cfg["file"]),
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(here / "cells" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def kind(name: str):
    """The generator of the traffic kind ``name``: the class ``Traffic``
    of ``kinds/<name>.py``."""
    if not name.isidentifier():
        raise KeyError(f"no traffic kind {name!r}")
    return importlib.import_module(f"portbench.kinds.{name}").Traffic


def reader(metric: str, root: pathlib.Path = ROOT) -> ModuleType:
    """The module of ``metrics/<metric>.py`` (a metric's name may hold a
    dot, so it is loaded from its path)."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
