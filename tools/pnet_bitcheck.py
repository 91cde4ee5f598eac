#!/usr/bin/env python3
"""Hold another build of ``csrc/pnet_level.cu`` against the tree's, on the card.

    git show HEAD~1:videotofaces_tpu_torch/csrc/pnet_level.cu > build/other/pnet_level.cu
    cp videotofaces_tpu_torch/csrc/window_sums.cuh build/other/
    python3 tools/pnet_bitcheck.py build/other [--batch 4] [--iters 5]

Builds the other source with the port's own nvcc flags into
``build/pnet_bitcheck/``, then runs both libraries' ``pnet_level_launch`` in
float32 on every level of the MTCNN pyramid of a batch of seeded 1080p frames
(min face 5, ``MTCNN.seeded(0)``), each level pooled where the wrapper pools
it. Prints, per level and per batch, whether ``reg`` and ``prob`` are equal
(``torch.equal``), both kernels' times by CUDA events and the float32 bound,
and exits 1 unless every level is equal. Needs a CUDA device.
"""

import argparse
import ctypes
import os.path as osp
import subprocess
import sys

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import bound_ms, cuda_ms, pnet_work  # noqa: E402
from videotofaces_tpu_torch.models import mtcnn as M  # noqa: E402
from videotofaces_tpu_torch.ops import _cuda  # noqa: E402
from videotofaces_tpu_torch.ops import pnet_kernel as PK  # noqa: E402
from videotofaces_tpu_torch.ops.resize import pool_windows_le2  # noqa: E402


def build(src_dir):
    out_dir = osp.join(ROOT, "build", "pnet_bitcheck")
    subprocess.run(["mkdir", "-p", out_dir], check=True)
    out = osp.join(out_dir, "other_pnet_level.so")
    run = subprocess.run([_cuda._nvcc(), *_cuda.FLAGS, "-o", out,
                          osp.join(src_dir, "pnet_level.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + run.stdout)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pnet_level_launch.argtypes = [p, i, i, i, i, i, p, p, p, p, i, p]
    lib.pnet_level_launch.restype = i
    return lib


def launch(lib, frames, level_hw, weights):
    """float32 ``pnet_level`` through ``lib``, allocated as the wrapper does."""
    b, h, w = frames.shape[:3]
    ph, pw = PK.out_hw(level_hw)
    dev = frames.device
    reg = torch.empty((b, 4, ph, pw), dtype=torch.float32, device=dev)
    prob = torch.empty((b, ph, pw), dtype=torch.float32, device=dev)
    pooled = (None if pool_windows_le2(level_hw, (h, w))
              else torch.empty((b,) + tuple(level_hw) + (4,), dtype=torch.float32, device=dev))
    rc = lib.pnet_level_launch(frames.data_ptr(), b, h, w, level_hw[0], level_hw[1],
                               None if pooled is None else pooled.data_ptr(),
                               weights.data_ptr(), reg.data_ptr(), prob.data_ptr(), 0,
                               _cuda.stream_ptr(dev))
    _cuda.check(rc, "pnet_level_launch")
    return reg, prob


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="directory holding the other pnet_level.cu and its headers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pnet_bitcheck: needs a CUDA device")
    dev = torch.device("cuda")
    mine, other = PK._lib(), build(args.other)
    b, h, w = args.batch, 1080, 1920
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    weights = PK.pack_weights(M.MTCNN.seeded(0).pnet, torch.float32).to(dev)
    _, sizes = M.scale_pyramid(h, w, 5)
    print("%s; batch %d of %dx%d, %d levels" % (torch.cuda.get_device_name(0), b, h, w,
                                                 len(sizes)))
    same, tot = True, {"tree": 0.0, "other": 0.0, "bound": 0.0}
    for level_hw in sizes:
        got = launch(mine, frames, level_hw, weights)
        want = launch(other, frames, level_hw, weights)
        eq = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        same &= eq
        t = {"tree": cuda_ms(lambda: launch(mine, frames, level_hw, weights), args.iters),
             "other": cuda_ms(lambda: launch(other, frames, level_hw, weights), args.iters),
             "bound": bound_ms(*pnet_work(level_hw, b, h, w, "float32"), "float32")[0]}
        tot = {k: tot[k] + t[k] for k in tot}
        print("level %-12s equal %-5s tree %8.3f ms  other %8.3f ms  bound %7.3f ms  (%4.1f %%)"
              % (level_hw, eq, t["tree"], t["other"], t["bound"], 100 * t["bound"] / t["tree"]))
    print("pyramid: equal %s; tree %.3f ms, other %.3f ms, bound %.3f ms per batch of %d "
          "(tree at %.1f %% of its bound)" % (same, tot["tree"], tot["other"], tot["bound"], b,
                                              100 * tot["bound"] / tot["tree"]))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
