"""A configuration, a traffic mix and a per-layer metric are added as new
files in a copy of the benchmark, with no existing file edited but
BENCHMARK.json, and the harness finds and runs them."""

import json
import os
import os.path as osp
import shutil
import subprocess
import sys

from portbench import registry

ROOT = registry.ROOT


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(osp.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(osp.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}

    cfg = json.loads((pb / "configs" / "live_mtcnn_facenet.json").read_text())
    cfg["name"] = "live_mtcnn_facenet_minface8"
    cfg["detector"]["min_face_size"] = 8
    (pb / "configs" / "live_mtcnn_facenet_minface8.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "video.json").read_text())
    mix["video_step"] = 1.0
    (pb / "traffic" / "video_1s.json").write_text(json.dumps(mix))
    (pb / "limits" / "live_mtcnn_facenet_minface8.video_1s.json").write_text(
        (pb / "limits" / "live_mtcnn_facenet.video.json").read_text())
    (pb / "metrics" / "frames_per_clip.video_1s.py").write_text(
        '"""Sampled frames per clip run."""\n\n\ndef read(run):\n'
        '    return run.counts["frames"] / run.counts["clips"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = "live_mtcnn_facenet_minface8.video_1s"
    bench["workloads"].append({"name": cell, "config": "live_mtcnn_facenet_minface8",
                               "traffic": "video_1s", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "frames_per_clip.video_1s", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "pipeline", "moves": "frames_per_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())
    here = str(pb)
    assert registry.config("live_mtcnn_facenet_minface8", here)["detector"]["min_face_size"] == 8
    assert registry.traffic("video_1s", here)["video_step"] == 1.0
    assert [m["name"] for m in registry.per_layer(bench, cell)][-1] == "frames_per_clip.video_1s"

    # a whole (tiny, CPU) run of the new cell in the copy, traced metrics read
    script = (
        "import sys, json, time\n"
        "sys.path.insert(0, %r)\n"
        "sys.path.append(%r)\n"
        "from portbench import harness, registry\n"
        "from portbench.tests import tiny\n"
        "bench = registry.benchmark()\n"
        "cell = registry.cell(bench, %r)\n"
        "cfg, tr = tiny.shrink(registry.config(cell['config']), registry.traffic(cell['traffic']))\n"
        "run = harness.Run(cell, cfg, tr, 3, 0.5, False, %r)\n"
        "run.state['device'] = 'cpu'\n"
        "import importlib\n"
        "drv = importlib.import_module('portbench.drivers.' + tr['kind'])\n"
        "drv.setup(run); harness._window(drv, run); drv.release(run)\n"
        "print(json.dumps({'m': registry.reader('frames_per_clip.video_1s')(run),"
        " 'mod': drv.__file__, 'step': run.traffic['video_step']}))\n"
        "drv.close(run)\n" % (str(root), ROOT, cell, str(tmp_path)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["mod"].startswith(str(root))
    assert res["step"] == 1.0
    # 2 s clips at 8 fps sampled every second: frames 8 and 16 minus the end
    assert res["m"] == 1.0
