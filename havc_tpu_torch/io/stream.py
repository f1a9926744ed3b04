"""Streaming video input with bounded memory.

Port of ``havc_tpu.io.stream``: decode runs on a background thread that
fills a bounded queue of uint8 batches, so an arbitrarily long video runs
in O(batch) host memory while the device computes.  ``.y4m`` files are
read by ``io/y4m.py`` (numpy, no OpenCV); any other container is decoded
by OpenCV, imported only on that branch.

``FrameReader`` is the one place that knows both decoders: the streaming
entry points read geometry and frames through it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..utils.profiling import resolve_device
from ..utils.transfer import u8_to_unit, unit_to_u8
from .y4m import Y4MReader

__all__ = ["FrameReader", "is_y4m", "stream_batches", "process_video"]


def is_y4m(path: str) -> bool:
    return str(path).lower().endswith(".y4m")


class FrameReader:
    """Sequential uint8 frames of a ``.y4m`` file (numpy) or of any video
    OpenCV decodes: ``width``, ``height``, ``fps``; ``read(n, gray)``
    returns up to ``n`` frames, (k, H, W) luma when ``gray`` else (k, H,
    W, 3) RGB, or None at the end.  For OpenCV the luma is
    ``cv2.COLOR_BGR2GRAY`` of the decoded frame; for ``.y4m`` it is the Y
    plane."""

    def __init__(self, path: str):
        self.path = str(path)
        self._y4m = self._cap = None
        if is_y4m(self.path):
            self._y4m = Y4MReader(self.path)
            self.width, self.height, self.fps = self._y4m.width, self._y4m.height, self._y4m.fps
            return
        import cv2

        self._cv2 = cv2
        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            self._cap.release()
            raise IOError(f"cannot open video: {self.path}")
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 25.0
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def read(self, n: int, gray: bool = False) -> Optional[np.ndarray]:
        if self._y4m is not None:
            return self._y4m.read(n, gray)
        cv2 = self._cv2
        conv = cv2.COLOR_BGR2GRAY if gray else cv2.COLOR_BGR2RGB
        out = []
        for _ in range(n):
            ok, bgr = self._cap.read()
            if not ok:
                break
            out.append(cv2.cvtColor(bgr, conv))
        return np.stack(out) if out else None

    def close(self) -> None:
        if self._y4m is not None:
            self._y4m.close()
        if self._cap is not None:
            self._cap.release()

    def __enter__(self) -> "FrameReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _decode_worker(path: str, batch_size: int, out_q: queue.Queue, count, gray: bool,
                   stop: threading.Event):
    try:
        with FrameReader(path) as reader:
            n = 0
            while not stop.is_set() and (count is None or n < count):
                want = batch_size if count is None else min(batch_size, count - n)
                batch = reader.read(want, gray)
                if batch is None:
                    break
                out_q.put(batch)
                n += len(batch)
                if len(batch) < want:
                    break
    except BaseException as e:  # handed to the consumer, which raises it
        out_q.put(e)
    finally:
        out_q.put(None)  # end of stream


def stream_batches(
    path: str, batch_size: int = 8, prefetch: int = 4,
    count: Optional[int] = None, gray: bool = False,
) -> Iterator[np.ndarray]:
    """Yield (B, H, W, 3) uint8 RGB batches (``gray``: (B, H, W) luma)
    decoded on a background thread, at most ``prefetch`` batches ahead.
    A decode error is raised here.  Closing the generator early stops the
    thread."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    t = threading.Thread(target=_decode_worker, args=(path, batch_size, q, count, gray, stop),
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():  # free a slot for a worker blocked on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()


def process_video(
    path_in: str,
    path_out: str,
    fn: Callable[[torch.Tensor], torch.Tensor],
    batch_size: int = 8,
    prefetch: int = 4,
    count: Optional[int] = None,
    codec: str = "mp4v",
    device=None,
) -> int:
    """Stream a video through ``fn``, which maps (B, H, W, 3) float32 RGB
    [0, 1] tensors on ``device`` to the same shape; returns frames written.
    The tail batch is padded to ``batch_size``.  Frames cross to the
    device and back as uint8 (/255 and the final clip/round/quantise run
    on the device); the encode runs on this thread while the decode thread
    fills the queue."""
    import cv2

    dev = resolve_device(device)
    with FrameReader(path_in) as probe:
        fps, w, h = probe.fps, probe.width, probe.height
    writer = cv2.VideoWriter(path_out, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer: {path_out}")
    written = 0
    try:
        with torch.inference_mode():
            for batch in stream_batches(path_in, batch_size, prefetch, count):
                n = batch.shape[0]
                if n < batch_size:
                    batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - n, axis=0)])
                out = unit_to_u8(fn(u8_to_unit(torch.from_numpy(batch).to(dev))))
                for u8 in out[:n].cpu().numpy():
                    writer.write(cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
                    written += 1
    finally:
        writer.release()
    return written
