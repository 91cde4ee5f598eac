"""Asynchronous image writer: JPEG encode + disk IO off the critical path.

The reference writes each face synchronously inside the batch loop
(detection.py:155-156); here a small thread pool absorbs the writes (cv2
releases the GIL during imencode/imwrite) so the detection loop never blocks
on disk.
"""

from concurrent.futures import ThreadPoolExecutor

import cv2


class AsyncImageWriter:
    def __init__(self, workers=4):
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.pending = []

    def write(self, path, img):
        self.pending.append(self.pool.submit(self._write_checked, path, img))

    @staticmethod
    def _write_checked(path, img):
        # cv2.imwrite reports failure (missing dir, bad encoding, disk full)
        # by RETURNING False without raising — surface it, or the pipeline
        # records a face name whose file never existed and the grouping
        # stage crashes much later on imread -> None
        if not cv2.imwrite(path, img):
            raise IOError("cv2.imwrite failed for %s" % path)

    def flush(self):
        for f in self.pending:
            f.result()
        self.pending.clear()

    def close(self):
        self.flush()
        self.pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
