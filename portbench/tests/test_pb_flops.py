"""The yardstick's arithmetic against hand counts."""

import numpy as np
import torch

from portbench import devtrace, flops
from portbench.reference import resize as RS
from portbench.reference.vit import Block


def test_pnet_level_work_by_hand():
    # one level of 20 x 30 from a 40 x 60 frame: conv1 on 18 x 28, pool to
    # 9 x 14, conv2 on 7 x 12, conv3 + heads on 5 x 10
    nbytes, ops = flops.pnet_work((20, 30), 1, 40, 60)
    macs = 18 * 28 * 10 * 27 + 7 * 12 * 16 * 90 + 5 * 10 * (32 * 144 + 6 * 32)
    pool = 40 * 60 * 3          # 2 x 2 windows cover the frame once
    assert ops == pool + 2 * macs
    assert nbytes == 40 * 60 * 3 + 6632 * 4 + 5 * 10 * (4 * 4 + 4)


def test_rcnn_conv_ops_by_hand():
    conv = torch.nn.Conv2d(256, 256, 3, padding=1)
    x = torch.zeros(1, 256, 12, 20)
    assert flops.forward_ops(conv, lambda: conv(x)) == 2 * 256 * 12 * 20 * 256 * 9


def test_vit_block_ops_by_hand():
    blk = Block(768, 12, 3072)
    x = torch.zeros(1, 65, 768)
    # q, k, v and the projection, then the 3072-wide MLP, per token
    assert flops.forward_ops(blk, lambda: blk(x)) == 2 * 65 * (4 * 768 * 768 + 2 * 768 * 3072)


def test_covered_pixels_equal_a_painted_mask():
    rng = np.random.default_rng(0)
    b, h, w, n = 2, 30, 40, 25
    img = rng.integers(0, b, n)
    y0, x0 = rng.integers(-5, h, n), rng.integers(-5, w, n)
    y1, x1 = y0 + rng.integers(0, 20, n), x0 + rng.integers(0, 20, n)
    mask = np.zeros((b, h, w), bool)
    for i, a, c, d, e in zip(img, y0, y1, x0, x1):
        mask[i, max(a, 0):max(c, 0), max(d, 0):max(e, 0)] = True
    assert flops.covered(b, h, w, img, y0, y1, x0, x1) == int(mask.sum())


def test_crops_work_counts_live_windows_once():
    slots = np.array([[0, 0, 0, 10, 10, 1], [0, 5, 5, 10, 10, 1], [0, 0, 0, 30, 30, 0]])
    nbytes, ops = flops.crops_work(slots, 24, 1, 40, 40)
    union = 100 + 100 - 25
    assert nbytes == union * 3 + 3 * (24 * 24 * 3 * 4 + 24)
    assert ops == 200 * 3 + 3 * 24 * 24 * 3 * 3


def test_bound_and_peak():
    t, by = flops.bound_s(3.35e12, 1.0, "float32")
    assert (t, by) == (1.0, "bytes")
    t, by = flops.bound_s(1.0, 67e12, "float32")
    assert (t, by) == (1.0, "operations")
    assert flops.peak("highest") == 67e12


def test_pool_bounds_are_the_reference_resize():
    s, e = RS.pool_bounds_1d(10, 4)
    assert s.tolist() == [0, 2, 5, 7] and e.tolist() == [3, 5, 8, 10]


def test_trace_busy_idle_and_roofline_from_a_synthetic_timeline():
    from portbench.spans import SpanRecorder
    import importlib.util
    import os.path as osp

    ms = 1_000_000
    events = [("pool_level_kernel", 0 * ms, 2 * ms), ("pnet_level_kernel", 1 * ms, 4 * ms),
              ("gemm", 6 * ms, 7 * ms), ("pnet_tc_kernel", 20 * ms, 30 * ms)]
    tr = devtrace.DeviceTrace(events, (0, 20 * ms))      # the last one is outside
    assert tr.window_s() == 0.02
    assert tr.busy_s() == 0.005                          # [0, 4) and [6, 7)
    assert abs(tr.idle_share() - 75.0) < 1e-9
    assert tr.kernel_s("pool_level_kernel", "pnet_level_kernel", "pnet_tc_kernel") == (0.005, 2)
    spans = SpanRecorder()
    spans.intervals = [("decode:wait", 4 * ms, 6 * ms), ("host:postprocess", 7 * ms, 20 * ms)]
    assert dict(tr.idle_by_host(spans)) == {"decode:wait": 0.002, "host:postprocess": 0.013}

    class Run:
        trace = tr
        work = {"pnet": [(0, 67e12 * 0.001)]}          # 1 ms of operations
    path = osp.join(osp.dirname(osp.dirname(__file__)), "metrics", "pnet_roofline.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert abs(mod.read(Run) - 20.0) < 1e-9             # 1 ms of 5 ms
    Run.work = {}
    assert mod.read(Run) is None                        # nothing to read: no number
