"""Multi-host jobs of the port (videotofaces_tpu_torch/parallel/multihost.py,
the multi-host branches of api.py and the global hash dedup): the pure
helpers against the JAX package's, both transports with real concurrent
processes (the shared gather directory and a gloo process group), the wire
format shared with the JAX package, and two- and three-host
``video_to_faces`` jobs whose merged output must equal the single-host run.

Every host is a port-only subprocess on the CPU (tests/torch_mh_driver.py
for the jobs)."""

import os
import os.path as osp
import subprocess
import sys

import cv2
import numpy as np
import pytest

from videotofaces_tpu.parallel import multihost as JMH
from videotofaces_tpu_torch import api as TAPI
from videotofaces_tpu_torch.parallel import multihost as MH

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
TIMEOUT = 120


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("V2F_")}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)
    return env


def _run_all(procs):
    """Wait for every process; kill the rest when one outlives the limit."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(outs)
    return outs


def _python(code, env):
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


# -- pure helpers, against the JAX package's ------------------------------------


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_shard_list_and_host_prefix_match_jax(count):
    items = list("abcdefg")
    for i in range(count):
        assert MH.shard_list(items, i, count) == JMH.shard_list(items, i, count)
        assert MH.host_prefix("x_", i, count) == JMH.host_prefix("x_", i, count)
    shards = [MH.shard_list(items, i, count) for i in range(count)]
    assert sorted(sum(shards, [])) == items


def test_pack_unpack_names_match_jax():
    names = ["000001_0.jpg", "h01_02_000123_4.jpg", "", "visage_\u00e9.jpg"]
    np.testing.assert_array_equal(MH.pack_names(names), JMH.pack_names(names))
    np.testing.assert_array_equal(MH.pack_names(names, 24), JMH.pack_names(names, 24))
    assert MH.unpack_names(MH.pack_names(names)) == names
    for mod in (MH, JMH):
        with pytest.raises(ValueError, match="exceeds"):
            mod.pack_names(["x" * 65])


def test_merge_gathered_matches_jax():
    c = [2, 0, 1]
    rows = [np.arange(8).reshape(4, 2), np.zeros((0, 1)), 10 + np.arange(2).reshape(1, 2)]
    names = [MH.pack_names(["a", "b", "pad", "pad"]), MH.pack_names([]),
             MH.pack_names(["c"])]
    merged, out = MH.merge_gathered(c, rows, names)
    want, want_names = JMH.merge_gathered(c, rows, names)
    np.testing.assert_array_equal(merged, want)
    np.testing.assert_array_equal(merged, [[0, 1], [2, 3], [10, 11]])
    assert out == want_names == ["a", "b", "c"]
    empty, none = MH.merge_gathered([0, 0], [np.zeros((0, 3))] * 2, [MH.pack_names([])] * 2)
    assert empty.shape == (0, 3) and none == []


def test_allgather_identity_single_host(monkeypatch):
    monkeypatch.delenv("V2F_PROCESS_COUNT", raising=False)
    assert MH.process_info() == (0, 1)
    feats = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    g, names = MH.allgather_rows(feats, list("abcde"))
    np.testing.assert_array_equal(g, feats)
    assert names == list("abcde")


def test_more_hosts_without_a_transport_raise(monkeypatch):
    monkeypatch.setenv("V2F_PROCESS_INDEX", "0")
    monkeypatch.setenv("V2F_PROCESS_COUNT", "2")
    monkeypatch.delenv("V2F_GATHER_DIR", raising=False)
    with pytest.raises(RuntimeError, match="no transport"):
        MH.allgather_rows(np.ones((1, 2), np.float32), ["a.jpg"])


# -- the shared-directory transport ------------------------------------------------

_GATHER = r"""
import numpy as np, os, sys
sys.path.insert(0, ".")
from videotofaces_tpu_torch.parallel import multihost as MH
{setup}
i, n = MH.process_info()
# unequal counts (host i has i + 2 rows; the last host none), uint64 hashes
# with the top bit set, and a second gather of float rows in which the empty
# host sends encode_faces' (0, 1) placeholder
k = 0 if i == n - 1 else i + 2
rows = np.arange(k, dtype=np.uint64) + np.uint64(1 << 63) + np.uint64(1000 * i)
g, out = MH.allgather_rows(rows, ["h%d_%d.jpg" % (i, j) for j in range(k)])
print("MERGED", g.dtype, g.shape, list(map(int, g)), out)
f = np.zeros((0, 1), np.float32) if k == 0 else np.full((k, 4), i + 0.5, np.float32)
g2, out2 = MH.allgather_rows(f, ["f%d_%d.jpg" % (i, j) for j in range(k)])
print("FLOAT", g2.dtype, g2.shape, g2.ravel().tolist(), out2)
{teardown}
"""


def _want_lines(n, empty=False):
    """The lines host ``i`` prints; ``empty``: the host without rows, whose
    placeholder shape gives way to the gathered bytes' width (one uint64
    column), as in the JAX package."""
    rows, names, floats, fnames = [], [], [], []
    for i in range(n):
        k = 0 if i == n - 1 else i + 2
        rows += [(1 << 63) + 1000 * i + j for j in range(k)]
        names += ["h%d_%d.jpg" % (i, j) for j in range(k)]
        floats += [i + 0.5] * (4 * k)
        fnames += ["f%d_%d.jpg" % (i, j) for j in range(k)]
    return ("MERGED uint64 (%d,%s) %s %s" % (len(rows), " 1" if empty else "", rows, names),
            "FLOAT float32 (%d, 4) %s %s" % (len(fnames), floats, fnames))


def _hold(outs, n):
    assert [_lines(o) for o in outs] == [_want_lines(n, i == n - 1) for i in range(n)], outs


def _lines(out):
    return tuple(next(ln for ln in out.splitlines() if ln.startswith(tag))
                 for tag in ("MERGED", "FLOAT"))


@pytest.mark.parametrize("n", [2, 3])
def test_file_exchange_allgather_processes(tmp_path, n):
    """Real concurrent processes exchange uint64 hash rows that straddle 2^63
    and float rows with one empty host; every host sees the same merged
    rows, in host order."""
    procs = [_python(_GATHER.format(setup="", teardown=""),
                     _env(V2F_PROCESS_INDEX=str(i), V2F_PROCESS_COUNT=str(n),
                          V2F_GATHER_DIR=str(tmp_path), V2F_RUN_ID="testrun"))
             for i in range(n)]
    _hold(_run_all(procs), n)


# a process that exits with its group alive may abort in gloo's teardown
_DESTROY = "dist.barrier()\ndist.destroy_process_group()"


@pytest.mark.parametrize("default_backend", ["gloo", "nccl"])
def test_gloo_allgather_processes(tmp_path, default_backend):
    """The torch.distributed transport: a gloo group initialized through a
    file (no port bound), unequal counts, one empty host. A default group
    that reports NCCL (here a gloo group posing as one) gets a gloo twin:
    rows never go to the card to be gathered."""
    setup = ("import torch.distributed as dist\n"
             "dist.init_process_group('gloo', init_method='file://%s', "
             "rank=int(os.environ['RANK_']), world_size=3)\n"
             % (tmp_path / "init").as_posix())
    if default_backend == "nccl":
        setup += ("backend = dist.get_backend\n"
                  "dist.get_backend = lambda group=None: "
                  "'nccl' if group is None else backend(group)\n"
                  "made = []\n"
                  "new_group = dist.new_group\n"
                  "dist.new_group = lambda **kw: made.append(kw) or new_group(**kw)\n"
                  "import atexit\n"
                  "atexit.register(lambda: print('GROUPS', made))\n")
    procs = [_python(_GATHER.format(setup=setup, teardown=_DESTROY), _env(RANK_=str(i))) for i in range(3)]
    outs = _run_all(procs)
    _hold(outs, 3)
    if default_backend == "nccl":   # one gloo group, made once for both gathers
        assert all("GROUPS [{'backend': 'gloo'}]" in o for o in outs), outs


def test_gloo_group_must_agree_with_env_topology(tmp_path):
    code = ("import os, sys; sys.path.insert(0, '.')\n"
            "import numpy as np, torch.distributed as dist\n"
            "from videotofaces_tpu_torch.parallel import multihost as MH\n"
            "dist.init_process_group('gloo', init_method='file://%s', rank=0, "
            "world_size=1)\n"
            "try:\n"
            "    MH.allgather_rows(np.zeros((1, 1), np.uint8), ['a'])\n"
            "except RuntimeError as e:\n"
            "    print('REFUSED', e)\n"
            "dist.destroy_process_group()\n" % (tmp_path / "init").as_posix())
    out = _run_all([_python(code, _env(V2F_PROCESS_INDEX="1", V2F_PROCESS_COUNT="2"))])[0]
    assert "REFUSED host 1 of 2" in out, out


def test_wire_format_shared_with_the_jax_package(tmp_path):
    """A JAX-package host and a port host gather through one directory and
    see identical rows and names."""
    jax_code = _GATHER.format(setup="", teardown="").replace("videotofaces_tpu_torch", "videotofaces_tpu")
    env = dict(V2F_PROCESS_COUNT="2", V2F_GATHER_DIR=str(tmp_path), V2F_RUN_ID="wire")
    procs = [_python(jax_code, _env(V2F_PROCESS_INDEX="0", **env)),
             _python(_GATHER.format(setup="", teardown=""), _env(V2F_PROCESS_INDEX="1", **env))]
    _hold(_run_all(procs), 2)


def test_gather_dir_requires_run_id(tmp_path, monkeypatch):
    monkeypatch.setenv("V2F_GATHER_DIR", str(tmp_path))
    monkeypatch.delenv("V2F_RUN_ID", raising=False)
    monkeypatch.setenv("V2F_PROCESS_INDEX", "0")
    monkeypatch.setenv("V2F_PROCESS_COUNT", "2")
    with pytest.raises(RuntimeError, match="V2F_RUN_ID"):
        MH.allgather_rows(np.ones((1, 2), np.float32), ["a.jpg"])


def test_gather_dir_refuses_reused_run_id(tmp_path, monkeypatch):
    """seq>=1 leftovers under the SAME run id mean the id was reused; the
    seq-0 guard refuses rather than risk merging a prior run's rows."""
    monkeypatch.setenv("V2F_RUN_ID", "dup")
    rdir = tmp_path / "run_dup"
    rdir.mkdir()
    np.savez(str(rdir / "g001_h00.npz"), rows=np.zeros((1, 1), np.uint8))
    monkeypatch.setattr(MH, "_gather_seq", [0])
    with pytest.raises(RuntimeError, match="previous run"):
        MH._exchange_via_dir(str(tmp_path), 0, 2,
                             {"rows": np.zeros((1, 1), np.uint8)}, timeout=1)


def test_missing_peer_times_out(tmp_path, monkeypatch):
    monkeypatch.setenv("V2F_RUN_ID", "alone")
    monkeypatch.setattr(MH, "_gather_seq", [0])
    with pytest.raises(TimeoutError, match="never arrived"):
        MH._exchange_via_dir(str(tmp_path), 0, 2,
                             {"rows": np.zeros((1, 1), np.uint8)}, timeout=0.2)


def test_stale_run_dirs_reaped_fresh_kept(tmp_path, monkeypatch):
    """Dirs untouched past V2F_GATHER_REAP_HOURS are swept at the first
    gather of a new run; fresh dirs (possibly concurrent jobs) and the
    current run's dir survive."""
    import time

    monkeypatch.setenv("V2F_RUN_ID", "fresh")
    monkeypatch.setenv("V2F_GATHER_REAP_HOURS", "48")
    old = tmp_path / "run_old"
    old.mkdir()
    np.savez(str(old / "g000_h00.npz"), rows=np.zeros((1, 1), np.uint8))
    past = time.time() - 80 * 3600
    os.utime(str(old), (past, past))
    recent = tmp_path / "run_recent"
    recent.mkdir()
    monkeypatch.setattr(MH, "_gather_seq", [0])
    monkeypatch.setattr(MH, "_reaped", [False])
    out = MH._exchange_via_dir(str(tmp_path), 0, 1,
                               {"rows": np.zeros((2, 3), np.uint8)}, timeout=5)
    assert len(out) == 1 and out[0]["rows"].shape == (2, 3)
    assert not old.exists(), "stale run dir should be reaped"
    assert recent.exists(), "fresh run dir must survive"
    assert (tmp_path / "run_fresh").exists()


# -- grouping-only mode: shard the listing, refuse divergent listings --------------


def _face_dir(tmp_path, n):
    faces = tmp_path / "faces"
    faces.mkdir()
    for i in range(n):
        cv2.imwrite(str(faces / ("f%02d.jpg" % i)), np.full((16, 16, 3), 40 * i, np.uint8))


def test_grouping_mode_shards_paths_per_host(tmp_path, monkeypatch):
    """mode='grouping' gives each host a DISJOINT face shard; without it
    every host would gather identical copies of every row and the global
    dedup (distance 0) would delete the whole face set."""
    _face_dir(tmp_path, 6)
    monkeypatch.setattr(TAPI.MH, "allgather_rows",
                        lambda rows, names, **kw: (np.tile(rows, (2, 1)), list(names) * 2))
    got = {}
    for idx in range(2):
        monkeypatch.setenv("V2F_PROCESS_INDEX", str(idx))
        monkeypatch.setenv("V2F_PROCESS_COUNT", "2")
        plan = TAPI._plan_grouping("grouping", "clustering", 2, None, str(tmp_path), False)
        got[idx] = [osp.basename(p) for p in plan.paths]
    assert sorted(got[0] + got[1]) == ["f%02d.jpg" % i for i in range(6)]
    assert not set(got[0]) & set(got[1])


def test_grouping_mode_refuses_divergent_listings(tmp_path, monkeypatch):
    _face_dir(tmp_path, 4)
    monkeypatch.setattr(
        TAPI.MH, "allgather_rows",
        lambda rows, names, **kw: (np.tile(rows, (2, 1)),
                                   list(names) + ["other_host.jpg"] * len(names)))
    monkeypatch.setenv("V2F_PROCESS_INDEX", "0")
    monkeypatch.setenv("V2F_PROCESS_COUNT", "2")
    with pytest.raises(RuntimeError, match="shared filesystem"):
        TAPI._plan_grouping("grouping", "clustering", 2, None, str(tmp_path), False)


# -- whole jobs ------------------------------------------------------------------------


def _write_test_video(path, n_frames=30, fps=10, size=(128, 96), seed=1):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    assert vw.isOpened()
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = np.full((size[1], size[0], 3), (i * 6) % 255, np.uint8)
        frame[:, :, 1] = rng.integers(0, 255, size=(size[1], size[0]))
        vw.write(frame)
    vw.release()


def _faces_by_label(root):
    """After clustering: {label: sorted list of face-file bytes}."""
    faces = osp.join(root, "faces")
    out = {}
    for lbl in sorted(os.listdir(faces)):
        d = osp.join(faces, lbl)
        if osp.isdir(d):
            out[lbl] = sorted(open(osp.join(d, f), "rb").read() for f in os.listdir(d))
    return out


def _host(vids, out_dir, mode, env, args=()):
    os.makedirs(out_dir, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, osp.join(HERE, "torch_mh_driver.py"), vids, out_dir, mode, *args],
        env=_env(**env), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Two seeded videos and the single-host full job over them."""
    root = tmp_path_factory.mktemp("mh_job")
    vids = str(root / "vids")
    os.makedirs(vids)
    _write_test_video(osp.join(vids, "a.avi"))
    _write_test_video(osp.join(vids, "b.avi"), seed=7)
    _run_all([_host(vids, str(root / "single"), "full", {})])
    want = _faces_by_label(str(root / "single"))
    assert sum(map(len, want.values())) > 20, "too few faces for the hold"
    return root, vids, want


@pytest.mark.parametrize("transport,hosts", [("dir", 2), ("gloo", 2), ("dir", 3)])
def test_multi_host_full_job_matches_single_host(job, transport, hosts):
    """End to end: full mode (detect -> global hash dedup -> encode -> global
    gather -> k-means). The hosts together place the same face images in the
    same global cluster labels as one host. With three hosts over two
    videos, host 2 has no video and still joins every gather."""
    root, vids, want = job
    run = root / ("%s%d" % (transport, hosts))
    procs = []
    for i in range(hosts):
        if transport == "dir":
            env = dict(V2F_PROCESS_INDEX=str(i), V2F_PROCESS_COUNT=str(hosts),
                       V2F_GATHER_DIR=str(run / "gather"), V2F_RUN_ID="e2e")
            args = ()
        else:
            env = dict(V2F_RANK=str(i), V2F_WORLD=str(hosts))
            args = ("--gloo", (run / "init").as_posix())
        procs.append(_host(vids, str(run / ("h%d" % i)), "full", env, args))
    _run_all(procs)
    got = [_faces_by_label(str(run / ("h%d" % i))) for i in range(hosts)]
    assert set().union(*got) <= set(want)
    merged = {lbl: sorted(sum((g.get(lbl, []) for g in got), [])) for lbl in want}
    assert {k: len(v) for k, v in merged.items()} == {k: len(v) for k, v in want.items()}
    assert merged == want
    names = [f for i in range(hosts) for _, _, fs in os.walk(run / ("h%d" % i)) for f in fs
             if f.endswith(".jpg")]
    assert all(n.startswith("h0") for n in names) and len(set(names)) == len(names)


def test_multi_host_grouping_mode_on_a_shared_out_dir(job, tmp_path):
    """mode='grouping' over one shared folder of faces: the listing check
    passes, each host encodes its shard, and the hosts' file moves on the
    shared out_dir (both hosts move every file) leave the groups of one
    process over the same faces listed in the hosts' gather order (host 0's
    round-robin share, then host 1's: K-means++ draws in row order)."""
    _, _, want = job
    files = sorted(("%s_%03d.jpg" % (lbl, i), data)
                   for lbl, datas in want.items() for i, data in enumerate(datas))
    os.makedirs(tmp_path / "shared" / "faces")
    os.makedirs(tmp_path / "single" / "faces")
    for k, (name, data) in enumerate(files):
        (tmp_path / "shared" / "faces" / name).write_bytes(data)
        ordered = "%d%04d_%s" % (k % 2, k // 2, name)
        (tmp_path / "single" / "faces" / ordered).write_bytes(data)
    _run_all([_host(str(tmp_path), str(tmp_path / "single"), "grouping", {})])
    env = dict(V2F_PROCESS_COUNT="2", V2F_GATHER_DIR=str(tmp_path / "gather"),
               V2F_RUN_ID="grp")
    _run_all([_host(str(tmp_path), str(tmp_path / "shared"), "grouping",
                    dict(env, V2F_PROCESS_INDEX=str(i))) for i in range(2)])
    single = _faces_by_label(str(tmp_path / "single"))
    assert sum(map(len, single.values())) == len(files)
    assert _faces_by_label(str(tmp_path / "shared")) == single
    assert not [f for f in os.listdir(tmp_path / "shared" / "faces") if f.endswith(".jpg")]
