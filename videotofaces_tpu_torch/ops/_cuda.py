"""Builds the port's CUDA sources (``csrc/*.cu``) and loads them.

Each source has a plain C interface and is compiled on its own by ``nvcc``
for ``sm_90a`` into a shared library under ``<repo>/build/torch_cuda/``,
named by a hash of its text, the headers beside it (``csrc/*.cuh``) and the
flags, then loaded with ``ctypes``. Nothing is built at import: the first
CUDA call of a kernel wrapper builds what it needs, and ``build_all()``
builds every source at once, one ``nvcc`` per source running in parallel.
No fast math: the kernels' divisions must stay IEEE-exact.
"""

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

SOURCES = ("pnet_level.cu", "pool_crops.cu", "resize_normalize.cu", "roi_align.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
_CSRC = osp.join(_PKG, "csrc")
_lock = threading.Lock()
_libs = {}


def build_dir():
    return osp.join(osp.dirname(_PKG), "build", "torch_cuda")


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and osp.isfile(osp.join(home, "bin", "nvcc")):
        return osp.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if osp.isfile("/usr/local/cuda/bin/nvcc"):   # the toolkit's default prefix
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(src):
    h = hashlib.sha1(" ".join(FLAGS).encode())
    # the source and every header beside it, which it may include
    for name in [src] + sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh")):
        with open(osp.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return osp.join(build_dir(), "%s_%s.so" % (src[:-3], digest[:12]))


def _start(src, out):
    os.makedirs(build_dir(), exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [_nvcc(), *FLAGS, "-o", tmp, osp.join(_CSRC, src)]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(src, out, tmp, proc):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s" % (src, log))
    with open(out + ".log", "w") as f:   # kept beside the library: ptxas_log()
        f.write(log)
    os.replace(tmp, out)


def build_all(sources=SOURCES):
    """Compile every source not built yet, all at once. Returns the wall
    seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = []
        for src in sources:
            out = _target(src)
            if not osp.isfile(out):
                jobs.append((src, out) + _start(src, out))
        for src, out, tmp, proc in jobs:
            _finish(src, out, tmp, proc)
    return time.perf_counter() - t0


def ptxas_log(src):
    """The ``nvcc -Xptxas -v`` output of a built source (registers, shared
    memory and spills per kernel), whichever process built it."""
    with open(_target(src) + ".log") as f:
        return f.read()


def load(src):
    """The loaded ``ctypes`` library of one source, built on first use."""
    with _lock:
        lib = _libs.get(src)
        if lib is not None:
            return lib
    build_all((src,))
    with _lock:
        if src not in _libs:
            _libs[src] = ctypes.CDLL(_target(src))
        return _libs[src]


def check(rc, what):
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d" % (what, rc))


def stream_ptr(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


_count_lock = threading.Lock()


def count_launch(fn):
    """Add one to ``fn.launches``, the launch count of a kernel wrapper.
    Several threads may launch at once (a service's callers, a pipeline's
    stages), and ``+= 1`` on an attribute is a read, an add and a write."""
    with _count_lock:
        fn.launches += 1
