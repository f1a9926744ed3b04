"""Host-side video and reference-frame IO.

Port of ``havc_tpu.io.video``: whole-clip decode and encode, still images,
and the reference-frame export/import (``ref_%06d.{jpg,png}``).  Files
are opened through OpenCV (``.y4m`` input through ``io/y4m.py``), and
OpenCV is imported inside each function that needs it.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from ..clip import Clip
from ..utils.profiling import resolve_device
from ..utils.transfer import u8_to_unit, unit_to_u8
from .stream import FrameReader

__all__ = [
    "read_video",
    "write_video",
    "write_video_y4m",
    "read_image",
    "write_image",
    "export_reference_frames",
    "read_reference_dir",
    "ref_frame_name",
    "parse_ref_num",
]

DEF_EXPORT_FORMAT = "jpg"  # reference constants.py:58
DEF_JPG_QUALITY = 95  # reference constants.py:59

_REF_RE = re.compile(r"ref_(\d{6})\.(jpg|jpeg|png)$", re.IGNORECASE)


def read_video(
    path: str,
    start: int = 0,
    count: Optional[int] = None,
    fps_force: Optional[float] = None,
    device=False,
) -> Clip:
    """Decode a video file into a Clip of float32 RGB [0, 1] frames.

    ``device=False`` keeps numpy frames; ``True`` (CUDA) or a device name
    uploads them as uint8 and divides by 255 there."""
    frames = []
    with FrameReader(path) as reader:
        fps = reader.fps
        if start and reader.read(start) is None:
            raise IOError(f"no frames decoded from: {path}")
        while count is None or len(frames) < count:
            got = reader.read(1)
            if got is None:
                break
            frames.append(got[0])
    if not frames:
        raise IOError(f"no frames decoded from: {path}")
    u8 = np.stack(frames)
    if device is False or device is None:
        return Clip(frames=u8.astype(np.float32) / np.float32(255.0), fps=fps_force or fps)
    dev = resolve_device(None if device is True else device)
    return Clip(frames=u8_to_unit(torch.from_numpy(u8).to(dev)), fps=fps_force or fps)


def write_video(clip: Clip, path: str, codec: str = "mp4v", batch_size: int = 16) -> None:
    """Encode a Clip to a video file; tensor frames are quantised where
    they are and come back as uint8, ``batch_size`` frames at a time."""
    import cv2

    h, w = clip.height, clip.width
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), clip.fps, (w, h))
    if not out.isOpened():
        raise IOError(f"cannot open video writer: {path}")
    try:
        for s in range(0, clip.num_frames, batch_size):
            chunk = clip.frames[s:s + batch_size]
            if isinstance(chunk, torch.Tensor):
                u8 = unit_to_u8(chunk).cpu().numpy()
            else:
                u8 = (np.clip(np.asarray(chunk), 0, 1) * 255).round().astype(np.uint8)
            for fr in u8:
                out.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
    finally:
        out.release()


def write_video_y4m(
    clip: Clip,
    path: str,
    matrix: str = "709",
    range_full: bool = False,
    dither: str = "error_diffusion",
    device=None,
) -> None:
    """Write YUV4MPEG2 4:2:0 (``C420mpeg2``) through ``io.formats``'s
    restore path: matrix and range conversion where the frames are
    (``device`` for numpy frames), Floyd-Steinberg dithering in the native
    library.  ffmpeg reads the file losslessly."""
    from .formats import restore_format_yuv420p8

    y, u, v = restore_format_yuv420p8(clip.frames, matrix, range_full, dither, device=device)
    t, h, w = y.shape
    num = int(round(clip.fps * 1000))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{num}:1000 Ip A1:1 C420mpeg2\n".encode())
        for i in range(t):
            f.write(b"FRAME\n")
            f.write(y[i].tobytes())
            f.write(u[i].tobytes())
            f.write(v[i].tobytes())


def read_image(path: str) -> np.ndarray:
    """Read an image as float32 RGB [0, 1]."""
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise IOError(f"cannot read image: {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def write_image(img, path: str, quality: int = DEF_JPG_QUALITY) -> None:
    import cv2

    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    u8 = (np.clip(np.asarray(img), 0, 1) * 255).round().astype(np.uint8)
    bgr = cv2.cvtColor(u8, cv2.COLOR_RGB2BGR)
    ext = os.path.splitext(path)[1].lower()
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] if ext in (".jpg", ".jpeg") else []
    if not cv2.imwrite(path, bgr, params):
        raise IOError(f"cannot write image: {path}")


def ref_frame_name(n: int, ext: str = DEF_EXPORT_FORMAT) -> str:
    """Reference-frame file naming: ``ref_%06d.ext``."""
    return f"ref_{n:06d}.{ext}"


def parse_ref_num(filename: str) -> Optional[int]:
    """Frame number from a ``ref_nnnnnn.*`` file name, else None."""
    m = _REF_RE.search(os.path.basename(filename))
    return int(m.group(1)) if m else None


def export_reference_frames(
    clip: Clip,
    out_dir: str,
    ext: str = DEF_EXPORT_FORMAT,
    frame_list=None,
    ref_offset: int = 0,
    ref_jpg_quality: int = DEF_JPG_QUALITY,
    ref_override: bool = True,
    sequence: bool = False,
) -> list:
    """Export the scene-change (or listed) frames as ``ref_nnnnnn``
    images: ``ref_offset`` is added to the number, ``sequence=True``
    numbers them consecutively instead of by frame index,
    ``ref_override=False`` skips existing files."""
    os.makedirs(out_dir, exist_ok=True)
    if frame_list is None:
        if clip.sc is None:
            raise ValueError("clip has no scene flags and no frame_list given")
        frame_list = list(np.nonzero(clip.sc.sc_prev)[0])
    written = []
    for i, n in enumerate(frame_list):
        num = (i if sequence else int(n)) + ref_offset
        path = os.path.join(out_dir, ref_frame_name(num, ext))
        if not ref_override and os.path.exists(path):
            continue
        write_image(clip.frames[int(n)], path, quality=ref_jpg_quality)
        written.append(path)
    return written


def read_reference_dir(ref_dir: str) -> dict:
    """Load all ``ref_nnnnnn.*`` images as {frame_num: RGB float array}."""
    if not os.path.isdir(ref_dir):
        raise IOError(f"reference dir not found: {ref_dir}")
    refs = {}
    for name in sorted(os.listdir(ref_dir)):
        num = parse_ref_num(name)
        if num is not None:
            refs[num] = read_image(os.path.join(ref_dir, name))
    return refs
