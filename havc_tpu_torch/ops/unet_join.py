"""A U-Net decoder block's upsample-and-join: DeOldify's and DDColor's
``PixelShuffleICNR`` (ReLU -> pixel shuffle -> replicate pad -> 2x2 blur)
joined along the channels with the block's skip.

Three functions:

* ``unet_join_reference(conv_out, scale, bn, skip=, skip_bn=, blur=)`` —
  the plain PyTorch chain the models ran;
* ``unet_join_cuda(...)`` — the CUDA C++ kernel (``csrc/unet_join.cu``),
  one launch that writes the whole joined tensor; the counter
  ``unet_join_launches`` counts its launches;
* ``unet_join(...)`` — the dispatcher, counted in ``unet_join_calls``: the
  kernel where its inputs are float32, contiguous CUDA tensors, ``blur``
  is set, ``scale`` is 2 or 4 and the upsampled size is the skip's;
  otherwise (the CPU, another dtype, no blur, the nearest-resize branch of
  a skip of another size) the plain chain.  On CUDA a ``conv_out`` or a
  skip in another layout (DDColor's skips are channels-last views of its
  encoder features, and so is its first block's ``conv_out``) is copied
  to a contiguous tensor first.  The result is contiguous, as the plain
  chain's is on CUDA whatever its inputs' layout.

``conv_out`` is the shuffle's 1x1 conv output ``(N, C * scale**2, H,
W)``; ``bn`` its BatchNorm as ``(inv, shift)`` vectors
(``BatchNormInference.fold``) or None.  ``skip`` ``(N, S, scale * H,
scale * W)`` with ``skip_bn`` gives ``ReLU(cat(blur, BN(skip)))`` (a
decoder block); without ``skip_bn`` it gives ``cat(blur, skip)`` (the
DeOldify head's dense merge with its input); no ``skip`` gives the blur
alone.  The kernel gives the same bits as the plain chain.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .resize import resize_nearest
from ..utils.profiling import count

__all__ = ["unet_join", "unet_join_cuda", "unet_join_reference"]

Fold = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _bn(x: torch.Tensor, fold: Fold) -> torch.Tensor:
    inv, shift = fold
    return x * inv[:, None, None] + shift[:, None, None]


def unet_join_reference(conv_out: torch.Tensor, scale: int, bn: Fold = None, *,
                        skip: Optional[torch.Tensor] = None, skip_bn: Fold = None,
                        blur: bool = True) -> torch.Tensor:
    """The plain chain: (BN) -> ReLU -> pixel shuffle -> (replicate pad,
    2x2 stride-1 average pool) -> join."""
    x = conv_out if bn is None else _bn(conv_out, bn)
    x = F.pixel_shuffle(F.relu(x), scale)
    if blur:
        x = F.pad(x, (1, 0, 1, 0), mode="replicate")
        x = F.avg_pool2d(x, 2, stride=1)
    if skip is None:
        return x
    if skip_bn is None:
        return torch.cat([x, skip], dim=1)
    if x.shape[2:] != skip.shape[2:]:
        x = resize_nearest(x, skip.shape[2], skip.shape[3])
    return F.relu(torch.cat([x, _bn(skip, skip_bn)], dim=1))


def _flat(t: torch.Tensor, n: int, device, what: str) -> int:
    if t.shape != (n,) or t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"unet_join_cuda: {what} must be a contiguous float32 ({n},) "
                         f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return t.data_ptr()


def unet_join_cuda(conv_out: torch.Tensor, scale: int, bn: Fold = None, *,
                   skip: Optional[torch.Tensor] = None, skip_bn: Fold = None) -> torch.Tensor:
    """Launch the kernel (the blur always on); every tensor float32 and
    contiguous, on one CUDA device.
    Returns a new contiguous ``(N, C + S, scale * H, scale * W)``
    tensor."""
    if scale not in (2, 4):
        raise ValueError(f"unet_join_cuda: scale must be 2 or 4, got {scale}")
    if not conv_out.is_cuda or conv_out.dtype != torch.float32 or conv_out.ndim != 4 \
            or not conv_out.is_contiguous():
        raise ValueError("unet_join_cuda: conv_out must be a contiguous float32 NCHW CUDA "
                         f"tensor, got {tuple(conv_out.shape)} {conv_out.dtype} on "
                         f"{conv_out.device}")
    n, cr, h, w = conv_out.shape
    if cr % (scale * scale):
        raise ValueError(f"unet_join_cuda: {cr} channels do not shuffle by {scale}")
    c, dev = cr // (scale * scale), conv_out.device
    inv = shift = inv_s = shift_s = second = None
    if bn is not None:
        inv, shift = (_flat(t, cr, dev, "bn") for t in bn)
    s = 0
    if skip is not None:
        if skip.ndim != 4 or skip.shape[0] != n or skip.shape[2:] != (scale * h, scale * w) \
                or skip.device != dev or skip.dtype != torch.float32 \
                or not skip.is_contiguous():
            raise ValueError(f"unet_join_cuda: skip must be a contiguous float32 "
                             f"({n}, S, {scale * h}, {scale * w}) tensor on {dev}, "
                             f"got {tuple(skip.shape)} {skip.dtype} on {skip.device} strides "
                             f"{skip.stride()}")
        s, second = skip.shape[1], skip.data_ptr()
        if skip_bn is not None:
            inv_s, shift_s = (_flat(t, s, dev, "skip_bn") for t in skip_bn)
    out = torch.empty((n, c + s, scale * h, scale * w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = kernels.load("unet_join")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.unet_join_launch(conv_out.data_ptr(), inv, shift, second, inv_s, shift_s,
                                  out.data_ptr(), n, c, s, h, w, scale, stream)
    if rc != 0:
        raise RuntimeError(f"unet_join_cuda: launch failed with CUDA error {rc}")
    count("unet_join_launches")
    return out


def _takes_kernel(conv_out, scale, bn, skip, skip_bn, blur) -> bool:
    every = [t for t in (conv_out, *(bn or ()), skip, *(skip_bn or ())) if t is not None]
    if not blur or scale not in (2, 4) or conv_out.ndim != 4:
        return False
    if not all(t.is_cuda and t.dtype == torch.float32 and t.is_contiguous() for t in every):
        return False
    return skip is None or skip.shape[2:] == (scale * conv_out.shape[2], scale * conv_out.shape[3])


def unet_join(conv_out: torch.Tensor, scale: int, bn: Fold = None, *,
              skip: Optional[torch.Tensor] = None, skip_bn: Fold = None,
              blur: bool = True) -> torch.Tensor:
    """The kernel where it takes the inputs, else the plain chain."""
    count("unet_join_calls")
    if conv_out.is_cuda:
        conv_out = conv_out.contiguous()
    if skip is not None and skip.is_cuda:
        skip = skip.contiguous()
    if _takes_kernel(conv_out, scale, bn, skip, skip_bn, blur):
        return unet_join_cuda(conv_out, scale, bn, skip=skip, skip_bn=skip_bn)
    return unet_join_reference(conv_out, scale, bn, skip=skip, skip_bn=skip_bn, blur=blur)
