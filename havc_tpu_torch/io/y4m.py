"""YUV4MPEG2 (``.y4m``) reader in numpy.

The streaming paths read ``.y4m`` through this module and need no OpenCV
(``ffmpeg -i in.mp4 -pix_fmt yuv420p in.y4m`` makes one).  Headers
``C420``, ``C420jpeg``, ``C420mpeg2``, ``C420paldv`` and ``Cmono`` are
read (no ``C`` tag means 4:2:0); each frame follows a ``FRAME`` line.

Frames come out as uint8, so that they cross to the device at 1 byte a
channel: in gray mode the Y plane as it is; otherwise RGB by the
convention of the JAX package's native reader (``native/framepipe.cpp``,
``yuv420_rows_to_rgb``): full-range ``Y/255``, ``U`` and ``V`` centred on
0.5, ``R = Y + V/0.877``, ``B = Y + U/0.492``, ``G = (Y - 0.299 R - 0.114
B)/0.587`` in float32, clamped to [0, 1], then quantised as
``utils.transfer.unit_to_u8`` does (round half to even).  Chroma is
replicated from its 2x2 block.  A ``Cmono`` frame is gray: R = G = B = Y.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

__all__ = ["Y4MReader", "yuv420_to_rgb_u8"]

_F = np.float32
_COLORSPACES = ("420", "420jpeg", "420mpeg2", "420paldv", "mono")
# threads of the RGB conversion: half the host's cores, at most 4, so that
# the caller's own thread and the device's feeding keep theirs
_WORKERS = max(1, min(4, (os.cpu_count() or 1) // 2))


def yuv420_to_rgb_u8(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(..., H, W) Y and (..., ceil(H/2), ceil(W/2)) U, V planes, uint8 ->
    (..., H, W, 3) uint8 RGB (the module's conversion), one frame at a
    time so that its float planes stay in cache, several frames at once
    on a few threads (numpy releases the GIL)."""
    out = np.empty(y.shape + (3,), np.uint8)
    frames = list(np.ndindex(y.shape[:-2]))

    def convert(i):
        _frame_to_rgb(y[i], u[i], v[i], out[i])

    workers = min(len(frames), _WORKERS)
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(convert, frames))
    else:
        for i in frames:
            convert(i)
    return out


def _frame_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, out: np.ndarray) -> None:
    h, w = y.shape

    def up(c):  # chroma of pixel (i, j) is that of block (i // 2, j // 2)
        hc, wc = c.shape
        return np.broadcast_to(c[:, None, :, None], (hc, 2, wc, 2)).reshape(2 * hc, 2 * wc)[:h, :w]

    yy = y.astype(_F) / _F(255.0)
    # the chroma terms are the same for the 4 pixels of a block: computed
    # once a block, then replicated
    r = yy + up((v.astype(_F) / _F(255.0) - _F(0.5)) / _F(0.877))
    b = yy + up((u.astype(_F) / _F(255.0) - _F(0.5)) / _F(0.492))
    g = (yy - _F(0.299) * r - _F(0.114) * b) / _F(0.587)
    for k, c in enumerate((r, g, b)):
        np.clip(c, _F(0.0), _F(1.0), out=c)
        c *= _F(255.0)
        out[..., k] = np.rint(c)


class Y4MReader:
    """Sequential reader over one ``.y4m`` file: ``width``, ``height``,
    ``fps``, ``colorspace``; ``read(n, gray)`` returns up to ``n`` frames,
    or None at the end; ``read_planes(n)`` their raw Y, U, V planes.  A
    truncated last frame ends the stream, as in the native reader."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._parse_header(self._f.readline())
        except BaseException:
            self._f.close()
            raise
        h, w = self.height, self.width
        self._y_bytes = h * w
        self._c_shape = ((h + 1) // 2, (w + 1) // 2)
        self._c_bytes = 0 if self.colorspace == "mono" else 2 * self._c_shape[0] * self._c_shape[1]

    def _parse_header(self, line: bytes) -> None:
        if not line.startswith(b"YUV4MPEG2"):
            raise ValueError(f"{self.path}: not a YUV4MPEG2 file")
        self.width = self.height = 0
        self.fps = 25.0
        self.colorspace = "420"
        for tok in line[9:].split():
            tag, val = chr(tok[0]), tok[1:].decode("ascii")
            if tag == "W":
                self.width = int(val)
            elif tag == "H":
                self.height = int(val)
            elif tag == "F":
                num, den = val.split(":")
                self.fps = int(num) / max(int(den), 1)
            elif tag == "C":
                self.colorspace = val
        if self.colorspace not in _COLORSPACES:
            raise ValueError(f"{self.path}: colorspace C{self.colorspace} is not read "
                             f"(supported: {', '.join('C' + c for c in _COLORSPACES)})")
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"{self.path}: no frame geometry in the header")

    def _read_frame(self, y_out: np.ndarray, c_out: Optional[np.ndarray]) -> bool:
        line = self._f.readline()
        if not line:
            return False
        if not line.startswith(b"FRAME"):
            raise ValueError(f"{self.path}: expected a FRAME header, got {line[:16]!r}")
        if self._f.readinto(y_out.reshape(-1)) != self._y_bytes:
            return False
        if self._c_bytes:
            c = c_out if c_out is not None else np.empty(self._c_bytes, np.uint8)
            if self._f.readinto(c.reshape(-1)) != self._c_bytes:
                return False
        return True

    def _read_frames(self, n: int, keep_chroma: bool):
        """Up to ``n`` frames: (k, H, W) Y planes and, when kept and
        present, (k, 2, ceil(H/2), ceil(W/2)) U and V planes; None when no
        frame is left."""
        ys = np.empty((n, self.height, self.width), np.uint8)
        cs = np.empty((n, self._c_bytes), np.uint8) if keep_chroma and self._c_bytes else None
        k = 0
        while k < n and self._read_frame(ys[k], None if cs is None else cs[k]):
            k += 1
        if k == 0:
            return None
        return ys[:k], None if cs is None else cs[:k].reshape(k, 2, *self._c_shape)

    def read(self, n: int, gray: bool = False) -> Optional[np.ndarray]:
        """Up to ``n`` frames: (k, H, W) uint8 Y planes when ``gray``,
        else (k, H, W, 3) uint8 RGB; None when no frame is left."""
        got = self._read_frames(n, not gray)
        if got is None:
            return None
        ys, cs = got
        if gray:
            return ys
        if cs is None:  # Cmono
            return np.repeat(ys[..., None], 3, axis=-1)
        return yuv420_to_rgb_u8(ys, cs[:, 0], cs[:, 1])

    def read_planes(self, n: int):
        """Up to ``n`` frames as their uint8 planes: (k, H, W) Y and
        (k, ceil(H/2), ceil(W/2)) U and V (None for ``Cmono``); None when no
        frame is left."""
        got = self._read_frames(n, True)
        if got is None:
            return None
        ys, cs = got
        return (ys, None, None) if cs is None else (ys, cs[:, 0], cs[:, 1])

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Y4MReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
