"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), its
comparison limits (``limits/<cell>.json``) and the readers of the per-layer
metrics (``metrics/<metric>.py``, one function ``read(run)``). A new
configuration, mix or metric is a new file; no file here changes."""

import importlib.util
import json
import os.path as osp

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(osp.join(root, "BENCHMARK.json"))


def cell(bench, name):
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError("no workload %r in BENCHMARK.json (have: %s)"
                   % (name, ", ".join(c["name"] for c in bench["workloads"])))


def config(name, here=HERE):
    return load_json(osp.join(here, "configs", name + ".json"))


def traffic(name, here=HERE):
    return load_json(osp.join(here, "traffic", name + ".json"))


def limits(cell_name, here=HERE):
    return load_json(osp.join(here, "limits", cell_name + ".json"))


def end_to_end(bench, cell_name):
    """The cell's end-to-end metrics: those without ``workloads`` and
    those that list the cell."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench, cell_name):
    """The per-layer metrics a traced run of the cell reports: those that
    list the cell, and those without ``workloads`` whose end-to-end metric
    the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(metric_name, here=HERE):
    """``read(run)`` of ``metrics/<metric_name>.py``."""
    path = osp.join(here, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
