"""The served cell's load sweep: one daemon, then one window per offered
rate, each reporting the median and 95th percentile of the request times,
the requests completed per second and whether the backlog grew (the last
quarter of the requests against the first). The cell's rate is fixed from
it once, at about four fifths of the highest rate without a growing
backlog.

    python3 portbench/sweep.py [--workload anime_rcnn_vitb16.served] \
        --rates 2 4 6 [--seconds 20] [--seed 1]

Needs a CUDA device."""

import argparse
import json
import os.path as osp
import shutil
import sys
import tempfile

import numpy as np


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="anime_rcnn_vitb16.served")
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
    from portbench import harness, registry, traffic
    from portbench.drivers import served

    harness.prepare_environment()
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg, tr = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    scratch = tempfile.mkdtemp(prefix="portbench_", dir=tempfile.gettempdir())
    run = harness.Run(cell, cfg, tr, args.seed, args.seconds, False, scratch)
    run.state["device"] = "cuda"
    try:
        served.setup(run)
        rng = np.random.default_rng([args.seed, 1])
        n_frames = len(run.state["frames"])
        for rate in args.rates:
            times, counts = traffic.make_arrivals(args.seed, rate, args.seconds, tr["sizes"])
            run.state["requests"] = [(float(t), rng.choice(n_frames, int(n), replace=False))
                                     for t, n in zip(times, counts)]
            served.window(run)
            lat = run.state["latencies_ms"]
            q = max(len(lat) // 4, 1)
            print(json.dumps({"rate": rate, "requests": len(lat), "failed": run.failed,
                              "p50_ms": float(np.percentile(lat, 50)),
                              "p95_ms": float(np.percentile(lat, 95)),
                              "completed_per_s": len(lat) / run.counts["window_s"],
                              "first_quarter_ms": float(np.median(lat[:q])),
                              "last_quarter_ms": float(np.median(lat[-q:])),
                              "sender_late_ms_max": run.counts["late_ms_max"]}), flush=True)
    finally:
        served.close(run)
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
