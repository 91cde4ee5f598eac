"""The run of one cell: set-up, the measured window, the check against the
plain reference, the metrics and the result line (see run.py)."""

import argparse
import importlib
import json
import os
import os.path as osp
import shutil
import sys
import tempfile
import time

from . import registry
from .spans import SpanRecorder

# top-level module names that may not be loaded in a run (compared whole:
# ``videotofaces_tpu_torch`` is the program and is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "videotofaces_tpu")


def forbidden_modules(modules=None):
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def prepare_environment(root=registry.ROOT):
    """Build and kernel caches at fixed paths inside the checkout; no
    library loads JAX; the program's own trace switch stays off."""
    os.environ["TORCH_EXTENSIONS_DIR"] = osp.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = osp.join(root, "build", "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("V2F_PROFILE_DIR", None)


def bytes_written():
    """Bytes this process has passed to write calls (files, and its own
    standard streams), from /proc/self/io."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class Run:
    """What one run knows: its cell, configuration and traffic, the seed,
    the scratch directory, the spans and counts of the window, the device
    trace (with ``--trace 1``) and the work the drivers computed for the
    per-layer readers."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, scratch):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.traced = seed, seconds, trace
        self.scratch = scratch
        self.spans = SpanRecorder()
        self.counts = {}
        self.e2e = {}
        self.work = {}
        self.trace = None
        self.attempted = self.failed = 0
        self.window_s = None
        self.window_ns = None
        self.prep_s = 0.0     # the benchmark's own set-up work, left out of setup_s
        self.state = {}       # the driver's own objects

    @property
    def name(self):
        return self.cell["name"]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(count):
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def main(argv, t_process):
    args = parse(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    prepare_environment()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("portbench: %s needs %d CUDA device(s); this machine has %d"
              % (cell["name"], cell["chips"],
                 torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    return execute(bench, cell, registry.config(cell["config"]),
                   registry.traffic(cell["traffic"]), args.seed, args.seconds,
                   bool(args.trace), t_process)


def execute(bench, cell, config, traffic, seed, seconds, trace, t_process, device="cuda"):
    """One run of ``cell`` with its configuration and traffic; prints the
    result line and returns the exit code. ``device`` other than the card
    is for the harness's own tests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module("portbench.drivers." + traffic["kind"])
    scratch = tempfile.mkdtemp(prefix="portbench_", dir=tempfile.gettempdir())
    run = Run(cell, config, traffic, seed, seconds, trace, scratch)
    run.state["device"] = device
    written0 = bytes_written()
    try:
        return _run(bench, driver, run, t_process, written0)
    finally:
        driver.close(run)
        shutil.rmtree(scratch, ignore_errors=True)


def _sync(run):
    """Wait for the run's own device work (none where the program runs in
    a child process that the cell's drivers module waits on)."""
    import torch

    if run.state["device"] != "cpu" and not run.state.get("remote"):
        torch.cuda.synchronize()


def _run(bench, driver, run, t_process, written0):
    import torch

    cuda = run.state["device"] != "cpu"
    driver.setup(run)
    _sync(run)
    # set-up of the program: process start to the window, less the
    # benchmark's own work (inputs made from the seed, the reference's
    # calibration of the seeded weights)
    total_s = time.perf_counter() - t_process
    setup_s = total_s - run.prep_s
    print("portbench: %s set-up %.3f s, of which %.3f s the benchmark's own (inputs from the "
          "seed, the reference's calibration), left out of setup_s"
          % (run.name, total_s, run.prep_s), file=sys.stderr)

    if run.traced and not run.state.get("remote"):
        from .devtrace import DeviceTrace

        run.trace = DeviceTrace()
        with run.trace:
            _window(driver, run)
    else:
        _window(driver, run)
    if run.state.get("remote"):
        peak = driver.memory_peak(run)
    else:
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    print("portbench: %s max_memory_allocated %d bytes" % (run.name, peak), file=sys.stderr)
    written = bytes_written()
    if written is not None and written0 is not None:
        print("portbench: %s bytes written %d" % (run.name, written - written0),
              file=sys.stderr)
    driver.release(run)
    if cuda:
        torch.cuda.empty_cache()

    compared = driver.check(run)
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    if run.traced:
        driver.work(run)
        metrics = {}
        for m in registry.per_layer(bench, run.name):
            value = registry.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in registry.end_to_end(bench, run.name):
            value = setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: %s" % ", ".join(bad), file=sys.stderr)
        return 3

    device = dict(device_info(run.cell["chips"]) if cuda else
                  {"platform": "cpu", "kind": "cpu", "count": 1}, memory_peak_bytes=peak)
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s()
        result["breakdown"] = run.trace.breakdown(run.spans)
    result["compared"] = compared
    for name, c in compared.items():
        print("compared %s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def _window(driver, run):
    t0 = time.time_ns()
    driver.window(run)
    _sync(run)
    t1 = time.time_ns()
    run.window_ns = (t0, t1)
    run.window_s = (t1 - t0) / 1e9
