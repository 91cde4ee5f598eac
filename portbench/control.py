"""The readings that the comparison limits of a cell are set from: the
program's numbers over many seeds (a short window each, at the cell's own
load; the checked work is whole in any window) and the control's numbers
(the reference computed in TF32, the step below the configurations'
float32, in the program's place) on the first seeds, all in one process.

    python3 portbench/control.py --workload <cell> --seeds S1 S2 ... \
        [--control 3] [--seconds 4] [--fault slot_offset]

Prints one JSON line per seed: {"seed", "program": {number: value},
"control": {...}}. With ``--fault`` (a detector fault of
``tests/faults.py``) the program runs with that fault planted under its
timed path, and "program" holds the fault's readings. Needs a CUDA
device."""

import argparse
import contextlib
import importlib
import json
import os.path as osp
import shutil
import sys
import tempfile
import time


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
    from portbench import harness, registry

    harness.prepare_environment()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg, tr = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    driver = importlib.import_module("portbench.drivers." + tr["kind"])
    patch = contextlib.ExitStack()
    if args.fault:
        import pytest

        from portbench.tests import faults

        faults.break_detector(patch.enter_context(pytest.MonkeyPatch.context()),
                              faults.DETECTOR[args.fault])
    for k, seed in enumerate(args.seeds):
        scratch = tempfile.mkdtemp(prefix="portbench_", dir=tempfile.gettempdir())
        run = harness.Run(cell, cfg, tr, seed, args.seconds, False, scratch)
        run.state["device"] = "cuda"
        t0 = time.perf_counter()
        try:
            driver.setup(run)
            harness._window(driver, run)
            driver.release(run)
            torch.cuda.empty_cache()
            out = {"seed": seed, "program": {n: c["value"] for n, c in driver.check(run).items()},
                   "e2e": run.e2e, "counts": run.counts}
            if k < args.control:
                out["control"] = driver.control(run)
            out["seconds"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
        finally:
            driver.close(run)
            shutil.rmtree(scratch, ignore_errors=True)
            torch.cuda.empty_cache()
    patch.close()


if __name__ == "__main__":
    main(sys.argv[1:])
