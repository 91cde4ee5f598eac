"""The readers of the program's own spans and counters (the detectors'
host syncs and NMS fixpoints, the decode workers, the clip edges): each
returns a value on a tiny CPU run of each video cell, and the NMS idle
share labels a hand-built trace's gaps by the fixpoint spans alone."""

import contextlib
import importlib
import io
import shutil
import tempfile

import pytest

from portbench import harness, registry
from portbench.devtrace import DeviceTrace
from portbench.spans import SpanRecorder
from portbench.tests import tiny

NEW = ("host_syncs_per_batch.video", "nms_idle_share.video", "decoded_per_frame.video",
       "decode_ms_per_frame.video", "clip_edges_ms.video")
VIDEO = [c["name"] for c in registry.benchmark()["workloads"] if c["traffic"] == "video"]


def test_the_readers_are_declared_for_both_video_cells():
    bench = registry.benchmark()
    for cell in VIDEO:
        assert set(NEW) <= {m["name"] for m in registry.per_layer(bench, cell)}


@pytest.mark.parametrize("cell", VIDEO)
def test_readers_read_a_tiny_video_run(cell):
    c = registry.cell(tiny.benchmark(), cell)
    cfg, tr = tiny.shrink(registry.config(c["config"]), registry.traffic(c["traffic"]))
    driver = importlib.import_module("portbench.drivers." + tr["kind"])
    scratch = tempfile.mkdtemp(prefix="portbench_")
    run = harness.Run(c, cfg, tr, 11, 1.0, False, scratch)
    run.state["device"] = "cpu"
    try:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            driver.setup(run)
            harness._window(driver, run)
    finally:
        driver.close(run)
        shutil.rmtree(scratch, ignore_errors=True)
    run.trace = DeviceTrace([], run.window_ns)      # no card: every gap idle
    got = {name: registry.reader(name)(run) for name in NEW}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["host_syncs_per_batch.video"] >= 1        # a fixpoint checks at least once
    assert 1 <= got["decoded_per_frame.video"] <= 2 * tr["clip"]["fps"] * tr["video_step"]
    assert got["clip_edges_ms.video"] > 0 and got["decode_ms_per_frame.video"] > 0
    # the spans the existing readers take are there, as before
    for name in ("decode_wait_share.video", "postprocess_ms_per_frame.video",
                 "detect_ms_per_batch.video"):
        assert registry.reader(name)(run) is not None, name


def _spans(*intervals):
    rec = SpanRecorder()
    rec.intervals = list(intervals)
    return rec


@pytest.mark.parametrize("gap, share", [((100, 200), 10.0), ((300, 400), 0.0)])
def test_nms_idle_share_counts_gaps_under_fixpoints_only(gap, share):
    """One idle gap in a 1,000 ns window: inside an ``nms:fixpoint`` (at a
    ``host:sync`` of it) it counts; inside ``detect:submit`` alone, or at a
    ``host:sync`` that is no fixpoint's, it does not."""
    events = [("k", 0, gap[0]), ("k", gap[1], 1000)]
    run = type("Run", (), {})()
    run.trace = DeviceTrace(events, (0, 1000))
    run.spans = _spans(("detect:submit", 0, 1000), ("nms:fixpoint", 110, 190),
                       ("host:sync", 140, 160), ("host:sync", 340, 360))
    assert registry.reader("nms_idle_share.video")(run) == pytest.approx(share)
    run.spans = _spans(("detect:submit", 0, 1000))     # a parent without the span
    assert registry.reader("nms_idle_share.video")(run) is None


def test_readers_skip_a_program_without_the_spans():
    run = type("Run", (), {})()
    run.spans, run.trace = SpanRecorder(), DeviceTrace([], (0, 1000))
    run.counts = {"frames": 8, "batches": 2, "clips": 1}
    assert all(registry.reader(name)(run) is None for name in NEW)
