"""``run.py`` without a card, the import audit, and (on the card) a short
run of every cell."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness, registry
from portbench.tests import tiny

ROOT = registry.ROOT
RUN = os.path.join(ROOT, "portbench", "run.py")
CELLS = [c["name"] for c in registry.benchmark()["workloads"]]


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, RUN, "--workload", CELLS[0], "--seed", "3000000001",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["videotofaces_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["videotofaces_tpu.ops", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "videotofaces_tpu"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_nor_jax():
    names = _loaded("import portbench.reference.rcnn, portbench.reference.mtcnn, "
                    "portbench.reference.facenet, portbench.reference.vit, "
                    "portbench.reference.pipeline, portbench.judge, portbench.flops")
    assert not names & {"videotofaces_tpu_torch", "videotofaces_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_whole_run_loads_no_jax(cell):
    names = _loaded("import sys\nsys.path.insert(0, %r)\n"
                    "from portbench.tests import tiny\n"
                    "rc, res, err = tiny.run_cell(%r)\n"
                    "assert rc == 0 and res['correct'], err[-2000:]" % (ROOT, cell))
    assert "videotofaces_tpu_torch" in names
    assert not names & {"videotofaces_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, RUN, "--workload", cell, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True,
                         timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
