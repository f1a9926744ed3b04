"""The Clip: a batch of RGB frames plus per-frame scene metadata.

Port of ``havc_tpu.clip``.  ``frames`` is a numpy array or a torch tensor,
``(T, H, W, 3)`` float32 RGB in [0,1].  Pipeline stages keep residency: a
clip of numpy frames comes back with numpy frames, a clip of tensors with
tensors on the device the stage ran on.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Union

import numpy as np
import torch

from .utils.profiling import host_read

__all__ = ["Clip", "ClipInfo", "SceneFlags", "from_frames"]


@dataclass
class SceneFlags:
    """Per-frame scene metadata (the frame-prop bus of the reference)."""

    sc_prev: np.ndarray  # 1 where a new scene starts ("_SceneChangePrev")
    sc_next: np.ndarray  # "_SceneChangeNext" (ref-frame-ext marker)
    luma: np.ndarray  # mean luma per frame ("sc_luma")
    ratio: np.ndarray  # adaptive ratio per frame ("sc_ratio")
    threshold: float = 0.1  # "sc_threshold"
    frequency: int = 0  # "sc_frequency"

    def __len__(self):
        return len(self.sc_prev)

    @classmethod
    def every(cls, n: int, freq: int = 1, threshold: float = 0.0) -> "SceneFlags":
        """Frequency-only flags: every ``freq``-th frame and frame 0."""
        sc = np.zeros(n, dtype=np.int8)
        if freq >= 1:
            sc[::freq] = 1
        if n:
            sc[0] = 1
        return cls(sc_prev=sc, sc_next=np.zeros(n, dtype=np.int8),
                   luma=np.full(n, 0.5, dtype=np.float32),
                   ratio=np.zeros(n, dtype=np.float32), threshold=threshold, frequency=freq)

    @classmethod
    def from_frame_list(cls, n: int, frames, ref_frame_ext: bool = True) -> "SceneFlags":
        """Flags from an explicit reference-frame list."""
        sc = np.zeros(n, dtype=np.int8)
        nxt = np.zeros(n, dtype=np.int8)
        for i in frames:
            if 0 <= i < n:
                sc[i] = 1
                if ref_frame_ext:
                    nxt[i] = 1
        return cls(sc, nxt, np.full(n, 0.5, np.float32), np.zeros(n, np.float32))


@dataclass
class ClipInfo:
    """Origin-format record."""

    height: int
    width: int
    fps: float = 25.0
    matrix: str = "709"
    range_full: bool = True
    orig_dtype: str = "uint8"
    chroma_resized: bool = False
    orig_height: int = 0
    orig_width: int = 0


@dataclass
class Clip:
    """Batched RGB clip with frame metadata."""

    frames: Union[np.ndarray, torch.Tensor]
    fps: float = 25.0
    sc: Optional[SceneFlags] = None
    info: Optional[ClipInfo] = None

    def __post_init__(self):
        if self.info is None:
            t, h, w, _ = self.frames.shape
            self.info = ClipInfo(height=h, width=w, fps=self.fps,
                                 orig_height=h, orig_width=w)

    @property
    def num_frames(self) -> int:
        return self.frames.shape[0]

    @property
    def height(self) -> int:
        return self.frames.shape[1]

    @property
    def width(self) -> int:
        return self.frames.shape[2]

    def __len__(self) -> int:
        return self.num_frames

    @property
    def on_device(self) -> bool:
        """True when the frames are a torch tensor (on any device)."""
        return isinstance(self.frames, torch.Tensor)

    def with_frames(self, frames) -> "Clip":
        return replace(self, frames=frames)

    def to_device(self, device: torch.device) -> "Clip":
        """Frames as a float32 tensor on ``device``."""
        frames = torch.as_tensor(self.frames)
        return replace(self, frames=frames.to(device=device, dtype=torch.float32))

    def to_host(self) -> "Clip":
        if not self.on_device:
            return self
        return replace(self, frames=host_read(self.frames))

    def with_sc(self, sc: SceneFlags) -> "Clip":
        return replace(self, sc=sc)

    def copy_sc_from(self, other: "Clip") -> "Clip":
        return replace(self, sc=other.sc)

    def __getitem__(self, idx) -> "Clip":
        if isinstance(idx, slice):
            sc = None
            if self.sc is not None:
                sc = replace(self.sc, sc_prev=self.sc.sc_prev[idx],
                             sc_next=self.sc.sc_next[idx],
                             luma=self.sc.luma[idx], ratio=self.sc.ratio[idx])
            return replace(self, frames=self.frames[idx], sc=sc)
        raise TypeError("Clip indexing supports slices only")

    def map_batches(self, fn: Callable, batch_size: int = 8) -> "Clip":
        """Apply ``fn`` over ``(B, H, W, 3)`` tensor batches of at most
        ``batch_size`` frames.  The frames must be a tensor."""
        outs = [fn(self.frames[s:s + batch_size])
                for s in range(0, self.num_frames, batch_size)]
        return self.with_frames(torch.cat(outs, dim=0))


def from_frames(frames, fps: float = 25.0, device=False) -> Clip:
    """A Clip of uint8 (0..255) or float (0..1) frames, (T, H, W, 3) or
    (H, W, 3).  ``device=False`` keeps numpy float32 frames; ``True`` (CUDA)
    or a device name uploads them, uint8 as bytes divided by 255 on the
    device."""
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    if device is False or device is None:
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / 255.0
        return Clip(frames=frames.astype(np.float32), fps=fps)
    from .utils.profiling import resolve_device
    from .utils.transfer import u8_to_unit

    dev = resolve_device(None if device is True else device)
    if frames.dtype == np.uint8:
        return Clip(frames=u8_to_unit(torch.from_numpy(frames).to(dev)), fps=fps)
    return Clip(frames=torch.from_numpy(frames.astype(np.float32)).to(dev), fps=fps)
