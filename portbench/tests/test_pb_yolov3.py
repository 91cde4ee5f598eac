"""The YOLOv3 cell (``live_yolov3_facenet.video``) end to end at tiny sizes
on the CPU: set-up (the seeded head calibrated by ``detectors/yolov3.py``),
the window through ``process_video``, the check against the plain
reference, the work and the cell's two readers; and the plain reference
imports nothing of the program nor of JAX."""

import contextlib
import importlib
import io
import json
import shutil
import subprocess
import sys
import tempfile

import pytest

from portbench import harness, registry
from portbench.tests import tiny

CELL = "live_yolov3_facenet.video"
READERS = ("candidates_per_frame.video", "yolo_body_ms_per_batch.video")


def test_the_cell_declares_its_readers():
    names = {m["name"] for m in registry.per_layer(registry.benchmark(), CELL)}
    assert set(READERS) <= names
    assert not {"pnet_roofline", "pool_crops_roofline", "roi_align_roofline"} & names


def test_a_tiny_run_is_correct_and_read():
    c = registry.cell(tiny.benchmark(), CELL)
    cfg, tr = tiny.shrink(registry.config(c["config"]), registry.traffic(c["traffic"]))
    driver = importlib.import_module("portbench.drivers." + tr["kind"])
    scratch = tempfile.mkdtemp(prefix="portbench_")
    run = harness.Run(c, cfg, tr, 3000000019, 1.0, False, scratch)
    run.state["device"] = "cpu"
    err = io.StringIO()
    try:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            driver.setup(run)
            harness._window(driver, run)
            driver.release(run)
            compared = driver.check(run)
            driver.work(run)
    finally:
        driver.close(run)
        shutil.rmtree(scratch, ignore_errors=True)
    assert all(v["value"] <= v["limit"] for v in compared.values()), compared
    assert run.counts["checked_detections"] > 0 and run.counts["checked_crops"] > 0
    line = next(ln for ln in err.getvalue().splitlines() if "calibration" in ln)
    calib = json.loads(line.split("calibration ", 1)[1])["head.pred"]
    (spec,) = cfg["detector"]["calibrate"]
    assert calib["candidates_per_frame"] == pytest.approx(spec["per_frame"], abs=1)
    assert calib["kept_per_frame"] == pytest.approx(spec["kept_per_frame"], abs=0.5)
    got = {name: registry.reader(name)(run) for name in READERS + ("mfu.video",)}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["candidates_per_frame.video"] <= cfg["detector"]["pre_topk"]
    assert run.work["model_flops"] % run.counts["frames"] == 0


def test_the_reference_imports_nothing_forbidden():
    script = ("import sys\n"
              "import portbench.reference.yolo\n"
              "from portbench import harness\n"
              "print(harness.forbidden_modules(),"
              " sorted(m for m in sys.modules if m.startswith('videotofaces')))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=registry.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[] []"


def test_one_state_loads_into_both():
    import torch

    from videotofaces_tpu_torch.models.yolo import YOLOv3

    cfg = registry.config("live_yolov3_facenet")
    ref = registry.detector("yolov3").reference(cfg)
    with torch.device("meta"):
        prog = YOLOv3()
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in prog.state_dict().items()}
