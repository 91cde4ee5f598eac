"""Multi-host data parallelism for video-library-scale batch jobs
(counterpart of videotofaces_tpu/parallel/multihost.py).

Every HOST (one process; several may share a machine or a card) processes
its own shard of the video list end-to-end through detection (decode and
JPEG writes are host-local); then the duplicate-removal and grouping stages
become GLOBAL by all-gathering (hash/embedding, face-name) rows across
hosts, so each host computes IDENTICAL dedup decisions and cluster
assignments and applies file moves only to its local faces.

Launch one process per host and call ``video_to_faces`` normally — api.py
consults :func:`process_info` and applies the sharding automatically. The
topology comes from ``V2F_PROCESS_INDEX`` / ``V2F_PROCESS_COUNT`` or, when
those are unset, from a ``torch.distributed`` process group that the
launching script initialized (``init_process_group``; the port never
initializes one itself). The all-gather then needs a transport: with
``V2F_GATHER_DIR`` set it runs a shared-filesystem exchange (atomic
per-host .npz drops + polling, scoped to a per-run subdirectory keyed by
the required ``V2F_RUN_ID``; the file names and keys are the JAX
package's, so hosts of either package read each other's drops); otherwise
it rides the initialized process group, over gloo on host tensors. Rows
travel as raw bytes (uint8 views), so any dtype — packed uint64 hashes
included — survives the transport exactly.
"""

import os
import os.path as osp
import time

import numpy as np

_gather_seq = [0]  # every host runs gathers in the same program order


def _dist():
    """``torch.distributed`` when a process group is initialized, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_info():
    """(process_index, process_count). Env override first (external
    launchers, tests), then an initialized ``torch.distributed`` group,
    else (0, 1) — as ``jax.process_index()`` is 0 of 1 until
    ``jax.distributed.initialize`` runs."""
    env_i, env_c = os.environ.get("V2F_PROCESS_INDEX"), os.environ.get("V2F_PROCESS_COUNT")
    if env_c:
        return int(env_i or 0), int(env_c)
    dist = _dist()
    if dist is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_list(items, index=None, count=None):
    """This host's shard: round-robin over the stable input order, so shards
    stay balanced when video sizes correlate with list position."""
    if count is None:
        index, count = process_info()
    return list(items[index::count])


def host_prefix(prefix="", index=None, count=None):
    """Face filenames must be unique across the library for the global
    grouping stage; prepend a host tag when more than one host writes."""
    if count is None:
        index, count = process_info()
    if count <= 1:
        return prefix
    return "h%02d_" % index + prefix


# -- name packing ------------------------------------------------------------


def pack_names(names, width=64):
    """List of strings -> uint8 [n, width] (utf-8, zero-padded); raises if a
    name exceeds the width (face filenames are ~20 chars)."""
    out = np.zeros((len(names), width), np.uint8)
    for i, s in enumerate(names):
        b = s.encode("utf-8")
        if len(b) > width:
            raise ValueError("name %r exceeds pack width %d" % (s, width))
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
    return out


def unpack_names(arr):
    return [bytes(row[row != 0]).decode("utf-8") for row in np.asarray(arr)]


def merge_gathered(counts, rows_per_host, names_per_host):
    """Trim per-host padding and concatenate in host order — every host runs
    this on identical gathered inputs, so the merged order (and everything
    derived from it: dedup decisions, K-means init, cluster labels) is
    identical everywhere. ``rows_per_host[h]`` is [>=counts[h], ...];
    ``names_per_host[h]`` is packed uint8. Returns (rows [N, ...], names)."""
    rows, names = [], []
    for h, n in enumerate(np.asarray(counts, dtype=np.int64).tolist()):
        if n:  # hosts with zero faces may carry a degenerate row width
            rows.append(np.asarray(rows_per_host[h][:n]))
        names += unpack_names(names_per_host[h][:n])
    if not rows:
        return np.asarray(rows_per_host[0])[:0], names
    return np.concatenate(rows, axis=0), names


# -- transports ----------------------------------------------------------------


def _run_scoped_dir(gdir):
    """Gather files live in a per-run subdirectory keyed by ``V2F_RUN_ID``
    (required, must be identical on every host and FRESH per run — e.g. the
    launcher's job id). Scoping by run id means leftover files from a prior
    run can never satisfy this run's polls: a detection-only job performs
    exactly one gather and its g000_h*.npz files stay behind by design (no
    host may delete its final drop before every peer has read it), so
    without scoping a reused directory would silently merge the previous
    run's rows into this run's dedup decisions."""
    run = os.environ.get("V2F_RUN_ID")
    if not run:
        raise RuntimeError(
            "V2F_GATHER_DIR requires V2F_RUN_ID: a run id shared by every "
            "host and unique per run (e.g. the launcher's job id)")
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in run)
    return osp.join(gdir, "run_" + safe)


_reaped = [False]  # stale-run sweep runs once per process


def _reap_stale_runs(root, mydir):
    """Best-effort removal of sibling run_* dirs untouched for longer than
    ``V2F_GATHER_REAP_HOURS`` (default 48; <=0 disables). Each run's FINAL
    g-files stay behind by design (no host may delete its last drop before
    every peer has read it), so a long-lived shared gather root would
    otherwise grow one run dir per job forever. Age-gating keeps the sweep
    safe next to concurrent jobs: an active run's dir mtime refreshes on
    every file drop/delete, so only genuinely abandoned runs qualify; races
    between hosts sweeping the same dir are harmless (ignore_errors)."""
    import shutil

    hours = float(os.environ.get("V2F_GATHER_REAP_HOURS", "48"))
    if hours <= 0:
        return
    cutoff = time.time() - hours * 3600.0
    try:
        entries = os.listdir(root)
    except OSError:
        return
    for e in entries:
        p = osp.join(root, e)
        if not e.startswith("run_") or p == mydir:
            continue
        try:
            if osp.isdir(p) and os.stat(p).st_mtime < cutoff:
                shutil.rmtree(p, ignore_errors=True)
        except OSError:
            pass


def _exchange_via_dir(gdir, index, count, payload, timeout=300.0):
    """Shared-filesystem all-gather: atomically drop this host's arrays as
    <run dir>/g<seq>_h<index>.npz, poll for everyone else's, load in host
    order. ``payload`` is a dict of arrays. Returns list of dicts, one per
    host."""
    root = gdir
    gdir = _run_scoped_dir(gdir)
    seq = _gather_seq[0]
    _gather_seq[0] += 1
    os.makedirs(gdir, exist_ok=True)
    if not _reaped[0]:
        _reaped[0] = True
        _reap_stale_runs(root, gdir)
    if seq == 0:
        # within a run-scoped dir, peers' g000 drops are legitimately
        # visible before we look; seq>=1 files can only mean the run id was
        # reused (contract violation) — refuse loudly rather than merge
        # stale rows.
        stale = [f for f in os.listdir(gdir)
                 if f.startswith("g") and f.endswith(".npz")
                 and not f.startswith("g000_")]
        if stale:
            raise RuntimeError(
                "gather dir %r contains files from a previous run with the "
                "same V2F_RUN_ID (e.g. %s); run ids must be fresh per run"
                % (gdir, stale[0]))
    tmp = osp.join(gdir, ".tmp_g%03d_h%02d_%d.npz" % (seq, index, os.getpid()))
    final = osp.join(gdir, "g%03d_h%02d.npz" % (seq, index))
    np.savez(tmp, **payload)
    os.replace(tmp, final)  # atomic: readers never see a partial file
    want = [osp.join(gdir, "g%03d_h%02d.npz" % (seq, h)) for h in range(count)]
    deadline = time.time() + timeout
    while not all(osp.exists(p) for p in want):
        if time.time() > deadline:
            missing = [p for p in want if not osp.exists(p)]
            raise TimeoutError("gather %d: hosts never arrived: %s" % (seq, missing))
        time.sleep(0.05)
    out = []
    for p in want:
        with np.load(p) as z:
            out.append({k: z[k] for k in z.files})
    if seq > 0:
        # every host has passed gather seq-1 (they wrote seq files), so this
        # host's previous drop can go — keeps reused dirs from accumulating
        # provably-stale files
        try:
            os.remove(osp.join(gdir, "g%03d_h%02d.npz" % (seq - 1, index)))
        except OSError:
            pass
    return out


_gloo = {}  # the default group's gloo twin, made once per process group


def _gloo_group(dist):
    """The group to gather host tensors on: the default one when it runs
    gloo, else one gloo group over the same ranks (rows never go to the
    card to be gathered)."""
    if dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _gloo:
        _gloo[key] = dist.new_group(backend="gloo")
    return _gloo[key]


def _allgather_padded(dist, arr, n_max, group):
    """All-gather a uint8 [n, W] array padded to [n_max, W]: [H, n_max, W]."""
    import torch

    pad = torch.zeros((n_max, arr.shape[1]), dtype=torch.uint8)
    pad[:arr.shape[0]] = torch.from_numpy(arr)
    parts = [torch.empty_like(pad) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, pad, group=group)
    return torch.stack(parts).numpy()


def _exchange_via_dist(dist, byte_rows, packed):
    """``torch.distributed`` all-gather of the byte rows and packed names
    (the JAX package's ``process_allgather`` steps): counts and row widths
    first as int64, then both arrays padded to the largest count and width.
    Returns (counts [H], rows [H, n_max, W], names [H, n_max, name_width])."""
    import torch

    group = _gloo_group(dist)
    h = dist.get_world_size(group)
    meta = torch.tensor([byte_rows.shape[0], byte_rows.shape[1]], dtype=torch.int64)
    metas = [torch.empty_like(meta) for _ in range(h)]
    dist.all_gather(metas, meta, group=group)
    metas = torch.stack(metas).numpy()
    counts, width = metas[:, 0], int(metas[:, 1].max())
    n_max = int(counts.max())
    rp = np.zeros((byte_rows.shape[0], width), np.uint8)
    rp[:, :byte_rows.shape[1]] = byte_rows
    return (counts, _allgather_padded(dist, rp, n_max, group),
            _allgather_padded(dist, packed, n_max, group))


def allgather_rows(rows, names, name_width=64):
    """All-gather (per-face rows, names) across hosts; identity when the
    topology is a single process. ``rows``: [n_local, ...] any dtype (packed
    uint64 hashes, float32 embeddings, ...). Returns (rows [N, ...], names)
    merged in host order — identical on every host. Raises when more than
    one host is configured and neither ``V2F_GATHER_DIR`` nor an
    initialized process group carries the rows."""
    index, count = process_info()
    rows = np.ascontiguousarray(rows)
    if count <= 1:
        return rows, list(names)
    byte_rows = rows.reshape(rows.shape[0], -1).view(np.uint8) if rows.size \
        else rows.reshape(0, 1).astype(np.uint8)
    packed = pack_names(names, name_width)

    gdir = os.environ.get("V2F_GATHER_DIR")
    if gdir:
        parts = _exchange_via_dir(gdir, index, count,
                                  {"rows": byte_rows, "names": packed})
        counts = [p["rows"].shape[0] for p in parts]
        merged, out_names = merge_gathered(counts, [p["rows"] for p in parts],
                                           [p["names"] for p in parts])
    else:
        dist = _dist()
        if dist is None:
            raise RuntimeError(
                "V2F_PROCESS_COUNT=%d but no transport: set V2F_GATHER_DIR (with "
                "V2F_RUN_ID) or initialize a torch.distributed process group" % count)
        if dist.get_world_size() != count or dist.get_rank() != index:
            raise RuntimeError(
                "host %d of %d (V2F_PROCESS_*) disagrees with the process group's "
                "rank %d of %d" % (index, count, dist.get_rank(), dist.get_world_size()))
        counts, rows_all, names_all = _exchange_via_dist(dist, byte_rows, packed)
        merged, out_names = merge_gathered(counts, rows_all, names_all)

    if merged.size:
        if rows.shape[0] == 0:
            # an empty local shard's trailing shape is a placeholder (e.g.
            # encode_faces returns (0, 1) without knowing the embedding
            # width) — size the rows from the gathered bytes instead
            merged = merged.view(rows.dtype).reshape(len(out_names), -1)
        else:
            merged = merged.view(rows.dtype).reshape(
                (len(out_names),) + rows.shape[1:])
    else:
        merged = np.zeros((0,) + rows.shape[1:], rows.dtype)
    return merged, out_names
