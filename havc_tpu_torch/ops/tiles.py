"""Overlapped spatial tiles: slicing and ramp-blend reconstruction, in
PyTorch.

Port of ``havc_tpu.ops.tiles`` (the Placebo/VerySlow tile presets): a clip
is cut into 2 (1x2) or 4 (2x2) overlapping tiles stacked on the batch
axis, colorized as one larger batch, and blended back with linear ramp
masks over the overlaps.  The geometry and the masks are computed on the
host in numpy, as the JAX package computes them; the masks and the
normaliser go to the device in one copy per call.
"""
from __future__ import annotations

import numpy as np
import torch

from .colorspace import luma, rgb_to_yuv, yuv_to_rgb

__all__ = ["slice_tiles", "reconstruct_tiles"]


def _tile_bounds(size: int, n: int, overlap: int):
    """Start offsets and the (even) tile size of ``n`` tiles covering
    ``size`` with ``overlap`` pixels shared between neighbours."""
    tile = (size + (n - 1) * overlap + n - 1) // n
    tile += tile % 2
    starts = [min(i * (tile - overlap), size - tile) for i in range(n)]
    return starts, tile


def slice_tiles(frames: torch.Tensor, rows: int = 2, cols: int = 2, overlap: int = 64,
                overlap_y: int | None = None):
    """``(T, H, W, C)`` -> ``(tiles, meta)``: tiles ``(rows*cols*T, th, tw,
    C)`` tile-major, meta the geometry for ``reconstruct_tiles``.
    ``overlap`` is the horizontal overlap, ``overlap_y`` the vertical one
    (default ``overlap``)."""
    t, h, w, c = frames.shape
    ys, th = _tile_bounds(h, rows, overlap if overlap_y is None else overlap_y)
    xs, tw = _tile_bounds(w, cols, overlap)
    tiles = torch.cat([frames[:, y0:y0 + th, x0:x0 + tw] for y0 in ys for x0 in xs], dim=0)
    return tiles, dict(shape=(t, h, w, c), ys=ys, xs=xs, th=th, tw=tw)


def _ramp_weight(size: int, start: int, tile: int, starts) -> np.ndarray:
    """1-D blend weight of a tile: linear ramps over its overlaps."""
    w = np.ones(tile, dtype=np.float32)
    prev = [s for s in starts if s < start]
    nxt = [s for s in starts if s > start]
    if prev:
        ov = prev[-1] + tile - start
        if ov > 0:
            w[:ov] = np.linspace(0.0, 1.0, ov + 2, dtype=np.float32)[1:-1]
    if nxt:
        ov = start + tile - nxt[0]
        if ov > 0:
            w[tile - ov:] = np.linspace(1.0, 0.0, ov + 2, dtype=np.float32)[1:-1]
    return w


def _masks(meta: dict):
    """Host-side ramp masks ``(n, th, tw, 1)`` in tile order and the
    normaliser ``max(sum of masks, 1e-6)`` of shape ``(H, W, 1)``."""
    _, h, w, _ = meta["shape"]
    ys, xs, th, tw = meta["ys"], meta["xs"], meta["th"], meta["tw"]
    masks, norm = [], np.zeros((h, w, 1), dtype=np.float32)
    for y0 in ys:
        wy = _ramp_weight(h, y0, th, ys)
        for x0 in xs:
            m = (wy[:, None] * _ramp_weight(w, x0, tw, xs)[None, :])[..., None]
            masks.append(m)
            norm[y0:y0 + th, x0:x0 + tw] += m
    return np.stack(masks), np.maximum(norm, 1e-6)


def reconstruct_tiles(tiles: torch.Tensor, meta: dict,
                      recover_luma: torch.Tensor | None = None) -> torch.Tensor:
    """Blend tiles back to ``(T, H, W, C)`` with the ramp masks; with
    ``recover_luma`` (the original frames) the blended chroma is married to
    their luma."""
    t, h, w, c = meta["shape"]
    ys, xs, th, tw = meta["ys"], meta["xs"], meta["th"], meta["tw"]
    masks_np, norm_np = _masks(meta)
    n = len(masks_np)
    # one host copy for both: the masks, then the normaliser
    packed = torch.from_numpy(np.concatenate([masks_np.reshape(-1), norm_np.reshape(-1)]))
    packed = packed.to(device=tiles.device, dtype=tiles.dtype)
    masks = packed[:n * th * tw].reshape(n, th, tw, 1)
    norm = packed[n * th * tw:].reshape(h, w, 1)
    acc = torch.zeros((t, h, w, c), dtype=tiles.dtype, device=tiles.device)
    idx = 0
    for y0 in ys:
        for x0 in xs:
            acc[:, y0:y0 + th, x0:x0 + tw] += tiles[idx * t:(idx + 1) * t] * masks[idx]
            idx += 1
    out = acc / norm
    if recover_luma is not None:
        yuv = rgb_to_yuv(out)
        out = torch.clamp(
            yuv_to_rgb(torch.stack([luma(recover_luma), yuv[..., 1], yuv[..., 2]], dim=-1)),
            0.0, 1.0)
    return out
