"""Typed stage configuration objects.

The reference threads positional tuples (``vid_params`` / ``det_params`` /
``save_params``, main.py:57-59) through three layers of calls; SURVEY §5 calls
that out as fragile. Here each pipeline stage gets a small frozen dataclass
with named fields and the path helpers the stage needs, constructed once in
``api.video_to_faces`` and passed down intact.
"""

import os
import os.path as osp
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class FrameSampling:
    """Which frames of a video get processed (reference detection.py:86-116)."""

    step: float = 1.0                # seconds between sampled frames
    fragment: Optional[Sequence[float]] = None   # (start, end) in minutes
    area: Optional[Sequence[int]] = None         # (x1, y1, x2, y2) crop in px
    reader: str = "opencv"           # "opencv" | "decord"


@dataclass(frozen=True)
class BoxCriteria:
    """Detector batching plus the accept/adjust rules applied to raw boxes
    (reference detection.py:165-260)."""

    batch_size: int = 4
    min_score: float = 0.4
    min_size: int = 50
    min_border: int = 5
    scale: Tuple[float, float, float, float] = (1.5, 1.5, 2.2, 1.2)
    square: bool = True


@dataclass(frozen=True)
class OutputLayout:
    """Where results land on disk. The directory shape is part of the public
    contract: crops under ``<root>/faces``, debug artifacts under
    ``<root>/intermediate/...`` (reference detection.py:49-55)."""

    root: str
    prefix: str = ""
    resize_to: Optional[object] = None   # int or (w, h): thumbnail crops
    save_frames: bool = False
    save_rejects: bool = False
    save_dupes: bool = False

    @property
    def faces_dir(self) -> str:
        return osp.join(self.root, "faces")

    def face_path(self, filename: str) -> str:
        return osp.join(self.faces_dir, filename)

    def intermediate(self, *parts: str) -> str:
        return osp.join(self.root, "intermediate", *parts)

    def with_prefix(self, prefix: str) -> "OutputLayout":
        return replace(self, prefix=prefix)

    def prepare_dirs(self, dedup_enabled: bool) -> None:
        os.makedirs(self.faces_dir, exist_ok=True)
        wanted = [("frames",) if self.save_frames else None,
                  ("rejects",) if self.save_rejects else None,
                  ("dupes1",) if (self.save_dupes and dedup_enabled) else None]
        for sub in wanted:
            if sub:
                os.makedirs(self.intermediate(*sub), exist_ok=True)


@dataclass(frozen=True)
class ClusterSpec:
    """K-means model selection (reference grouping.py:92-137)."""

    candidates: Sequence[int] = field(default_factory=lambda: list(range(2, 9)))
    keep_all: bool = False           # save every candidate k under G<k>/
    random_state: int = 0
    write_log: bool = True


@dataclass(frozen=True)
class ClassifySpec:
    """Nearest-reference classification (reference grouping.py:50-89)."""

    refs: Sequence[Tuple[str, Sequence[str]]] = ()   # [(class, [image paths])]
    other_thr: Optional[float] = 0.9  # min-dist >= thr -> "other"; falsy/-1 off
    write_log: bool = True


@dataclass(frozen=True)
class EncodeSpec:
    """Face-embedding batching (reference grouping.py:29-40)."""

    batch_size: int = 16
    area: Optional[Sequence[float]] = None   # fractional pre-crop
    dup_thr: Optional[float] = 0.25          # cosine dedup; falsy/-1 disables
