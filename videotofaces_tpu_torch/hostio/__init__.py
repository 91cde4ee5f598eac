"""Host IO: video decode with background prefetch, async image writing.

The decode path stays on host (OpenCV/FFmpeg) but is arranged to overlap
with device compute: a worker thread decodes batch i+1 while the GPU
processes batch i, and face
crops are written by a small thread pool (cv2 releases the GIL for both).
"""

from .video import (  # noqa: F401
    VideoReader,
    decode_workers_default,
    frame_schedule,
    open_reader,
    ParallelFrameSource,
    PrefetchingFrameSource,
    HAS_DECORD,
)
from .writer import AsyncImageWriter  # noqa: F401
