"""videotofaces_tpu_torch — the PyTorch/CUDA port of videotofaces_tpu.

Same public contract as the JAX package (``video_to_faces`` and the CLI),
running on one NVIDIA GPU; the hot kernels are hand-written CUDA C++ for
Hopper (``csrc/``). The port grows slice by slice (ROADMAP.md): this slice
runs detection mode with the MTCNN detector end to end.

Pipeline: host video decode -> batched on-device MTCNN cascade -> box
filter/expand/square -> crop & save -> hash dedup.
"""

from .api import video_to_faces  # noqa: F401

__version__ = "0.1.0"
