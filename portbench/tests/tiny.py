"""Tiny CPU runs of the harness for its tests: every cell's mix and
configuration shrunk (frame and crop sizes, counts, and the detector's
sizes that its module gives as ``TINY``: the R-CNN's resize, MTCNN's
smallest face) so that a run takes seconds on the CPU, with the card check
of ``run.py`` skipped (``harness.execute(device="cpu")``)."""

import contextlib
import copy
import io
import json
import time

from portbench import harness, models, registry


# cells whose drivers are built and tested but not yet in BENCHMARK.json (PERF.md)
PENDING = [({"name": "live_mtcnn_facenet.group", "config": "live_mtcnn_facenet",
             "traffic": "group", "chips": 1, "why": "grouping jobs"},
            {"name": "faces_per_s", "unit": "faces/s", "better": "higher", "bound": 0.25,
             "source": "host_clock"}),
           ({"name": "anime_rcnn_vitb16.served", "config": "anime_rcnn_vitb16",
             "traffic": "served", "chips": 1, "why": "the daemon under open-loop extracts"},
            {"name": "request_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
             "source": "host_clock"})]


def benchmark():
    """BENCHMARK.json with the pending cells added, so that their drivers
    are tested although the benchmark does not run them yet."""
    b = registry.benchmark()
    for cell, metric in PENDING:
        b["workloads"].append(cell)
        b["end_to_end"].append(dict(metric, workloads=[cell["name"]]))
    return b


CELLS = [c["name"] for c in benchmark()["workloads"]]


def shrink(cfg, tr):
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    d = cfg["detector"]
    d.update(models.detector(cfg).TINY)
    for spec in d.get("calibrate", []):
        spec["per_frame"] = max(1, spec["per_frame"] // 20)
        if "kept_per_frame" in spec:
            spec.update(kept_per_frame=1, criteria={"min_size": 8, "min_border": 1})
    small_clip = dict(size=[192, 112], fps=8, seconds=2, faces=3, face_px=[24, 60], variants=2,
                      threads=2)
    if tr["kind"] == "video":
        tr["clip"].update(small_clip)
        tr["criteria"].update(min_size=8, min_border=1)
        tr.update(batch_size=2)
    elif tr["kind"] == "group":
        tr["crops"].update(n=48, px=[40, 90])
        tr.update(calibration_images=16, clusters=[2, 3, 4])
    elif tr["kind"] == "served":
        tr["clip"].update(small_clip)
        tr["criteria"].update(min_size=8, min_border=1)
        tr.update(pool_frames=6, rate=2.0, sizes=[1, 2], calibration_crops=8, check_requests=3,
                  clients=4, warm={"batches": [1, 2], "embed_batches": [1, 2, 4]})
    return cfg, tr


def run_cell(name, seed=7, seconds=1.0, bench=None, edit=None):
    """One tiny CPU run of cell ``name``; returns (exit code, result dict
    or None, standard error). ``edit(cfg, tr)`` may change the shrunk
    configuration and mix in place."""
    bench = bench or benchmark()
    cell = registry.cell(bench, name)
    cfg, tr = shrink(registry.config(cell["config"]), registry.traffic(cell["traffic"]))
    if edit:
        edit(cfg, tr)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.execute(bench, cell, cfg, tr, seed, seconds, False, time.perf_counter(),
                             device="cpu")
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()


def control_values(name, seed=7, seconds=1.0):
    """(the program's numbers, the control's numbers) of one tiny CPU run
    of cell ``name``, and the cell's limits."""
    import importlib
    import shutil
    import tempfile

    cell = registry.cell(benchmark(), name)
    cfg, tr = shrink(registry.config(cell["config"]), registry.traffic(cell["traffic"]))
    driver = importlib.import_module("portbench.drivers." + tr["kind"])
    scratch = tempfile.mkdtemp(prefix="portbench_")
    run = harness.Run(cell, cfg, tr, seed, seconds, False, scratch)
    run.state["device"] = "cpu"
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            driver.setup(run)
            harness._window(driver, run)
            driver.release(run)
            program = {k: c["value"] for k, c in driver.check(run).items()}
            control = driver.control(run)
    finally:
        driver.close(run)
        shutil.rmtree(scratch, ignore_errors=True)
    return program, control, registry.limits(name)
