"""Finding a cell by name: ``BENCHMARK.json``'s workload entry, its
configuration's file, ``traffic/<traffic>.json``, the loop module that
file names (``loops/<loop>.py``) and the reader of each per-layer
metric (``metrics/<metric>.py``)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    loop: object
    end_to_end: list = field(default_factory=list)    # BENCHMARK entries
    per_layer: list = field(default_factory=list)     # (entry, reader)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reported(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def metric_reader(name):
    """The reader module of a per-layer metric, from its file by path (a
    metric's name may hold dots): ``metrics/<name>.py``, else the module of
    the name's part before its first dot."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        name = name.split(".")[0]
        path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "simbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def find(bench, workload, root=ROOT, overrides=None):
    """The Cell named ``workload``; ``overrides`` ({"config": {...},
    "traffic": {...}}) replace keys of its files (tests at small sizes)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    overrides = overrides or {}
    config = _merge(config, overrides.get("config"))
    traffic = _merge(traffic, overrides.get("traffic"))
    loop = importlib.import_module("simbench.loops." + traffic["loop"])
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        loop=loop,
        end_to_end=[m for m in bench["end_to_end"]
                    if _reported(m, workload)],
        per_layer=[(m, metric_reader(m["name"])) for m in bench["per_layer"]
                   if _reported(m, workload)])
