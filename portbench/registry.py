"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), its
comparison limits (``limits/<cell>.json``), the readers of the per-layer
metrics (``metrics/<metric>.py``, one function ``read(run)``) and the
detector a configuration names (``detectors/<model>.py``, by its
``detector.model``). A new configuration, mix or metric is a new file. A
new detector is new files too: its module in ``detectors/``, its plain
reference modules under ``reference/``, a configuration, a limits file per
cell, readers for its metrics; ``BENCHMARK.json`` then gets the cell, and
the cell's name goes into the ``workloads`` list of each metric that it
reports. No file here changes."""

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
    return _load("metrics", metric_name, here).read


def detector(name, here=HERE):
    """The module ``detectors/<name>.py`` of a configuration's
    ``detector.model``, with

    - ``reference(cfg)``: the plain reference module, its state not loaded;
    - ``program(cfg, device)``: the program's wrapper, its state not loaded;
    - ``detect(cfg, model, frames, batch)``: the reference's per frame
      (boxes, scores), as ``models.reference_detect`` returns them;
    - ``calibrate(cfg, ref, frames)``: calibrates the seeded reference in
      place and returns the calibration's values per layer;
    - ``kernel_inputs(cfg)``: (module, function name, ``keep``) of each
      plain stand-in that ``detect`` calls for a hand-written kernel of the
      program (none for a detector without one); ``keep(*args)`` is what
      ``work`` reads of a call;
    - ``work(run, ref, frame)``: fills ``run.work`` (``model_flops``, and
      the work of each kernel from the recorded calls) for the readers;
    - optionally ``stage_counts(handle)``: the program's per-image stage
      counts of a submitted batch, or None;
    - ``TINY``: the detector's keys at the sizes of the harness's CPU tests."""
    return _load("detectors", name, here)


def _load(folder, name, here):
    """The module ``<folder>/<name>.py``, run anew; a missing file raises,
    naming the path looked for."""
    path = osp.join(here, folder, name + ".py")
    if not osp.isfile(path):
        raise FileNotFoundError("no %s %r in the benchmark: %s does not exist"
                                % (folder, name, path))
    spec = importlib.util.spec_from_file_location("portbench_%s_%s" % (folder, name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
