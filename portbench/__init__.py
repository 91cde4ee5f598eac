"""The benchmark of ``videotofaces_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``. Everything the harness needs for
a cell is found by name: ``configs/<config>.json``, ``traffic/<mix>.json``
(a data file read by the general generator in ``traffic.py`` and driven by
``drivers/<kind>.py``) and ``metrics/<metric>.py`` (one reader per per-layer
metric). ``reference/`` holds the plain PyTorch / NumPy reference that
decides ``correct``; it imports nothing of the program.
"""
