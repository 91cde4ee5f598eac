"""videotofaces_tpu_torch — the PyTorch/CUDA port of videotofaces_tpu.

Same public contract as the JAX package (``video_to_faces`` and the CLI),
running on one NVIDIA GPU, or data-parallel over the GPUs of a
``parallel`` mesh; the hot kernels are hand-written CUDA C++ for
Hopper (``csrc/``). The port grows slice by slice (ROADMAP.md): it runs the
anime path (Faster R-CNN + ViT, the API's defaults) and the live-action path
(YOLOv3, its default, or the MTCNN detector, with FaceNet) end to end —
detection, embeddings, embedding dedup and K-means grouping or reference
classification (``mode="full" | "detection" | "grouping"``).

Pipeline: host video decode -> batched on-device detector (YOLOv3, Faster
R-CNN or the MTCNN cascade) -> box filter/expand/square -> crop & save ->
hash dedup -> ViT or FaceNet embeddings -> embedding dedup -> K-means with
silhouette selection (or classification). ``serve`` keeps the detector
and encoder resident behind a unix-socket, TCP or HTTP daemon.
"""

from .api import video_to_faces  # noqa: F401
from .utils.gallery import image_gallery, dataframe_with_images  # noqa: F401

__version__ = "0.1.0"
