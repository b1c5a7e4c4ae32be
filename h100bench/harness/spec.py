"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, each configuration's file (its ``file`` entry), each traffic mix's
file (``traffic/<name>.json``) and each per-layer metric's reader
(``metrics/<name>.py``).  A cell, a configuration, a mix or a metric is
added with files and entries alone; every metric is reported in every
cell."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    mix: dict             # the traffic file
    config_name: str
    traffic_name: str
    end_to_end: List[dict]
    per_layer: List[dict]


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT) -> Cell:
    bench = load_bench(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    c = cfgs[w["config"]]
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                config_name=w["config"], traffic_name=w["traffic"],
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The reader module of a per-layer metric, ``metrics/<name>.py``: it
    has ``read(obs)``, which returns the metric's value or None where its
    run has nothing to read."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def available_metrics(bench_dir: str = BENCH_DIR) -> List[str]:
    """Every metric with a reader file, by name."""
    d = os.path.join(bench_dir, "metrics")
    return sorted(f[:-3] for f in os.listdir(d)
                  if f.endswith(".py") and not f.startswith("_"))
