"""Local window attention, ColorMNet's short-term memory read: frozen copy
of the plain version in the port's ``havc_tpu_torch/ops/window_attn.py``.

For every query pixel, a softmax over the ``(2*max_dis+1)**2`` offsets of
its window of ``(q * scale) . k + rel`` (``scale = 1/sqrt(d_qk)``,
out-of-frame offsets set to -1e8), then the weighted sum of ``v``.
Channel-last: q, k ``(B, H, W, d_qk)``, v ``(B, H, W, d_vu)``,
rel ``(B, H, W, win*win)``; the result is ``(B, H, W, d_vu)`` float32.
``window_attn`` is the plain version on every device (no kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.precision import ieee_precision

__all__ = ["window_attn", "window_attn_reference"]


@ieee_precision()
def window_attn_reference(q, k, v, rel, max_dis: int = 7) -> torch.Tensor:
    """Unfold-einsum version: the windows of k and v are materialised,
    in IEEE float32 whatever the inputs' type and the process's flags
    (the kernel is held against it)."""
    q, k, v, rel = (t.float() for t in (q, k, v, rel))
    win = 2 * max_dis + 1
    b, h, w, _ = q.shape

    def unfold(x):  # (N, H, W, C) -> (N, H, W, win*win, C), zero-padded
        n, c = x.shape[0], x.shape[-1]
        patches = F.unfold(x.permute(0, 3, 1, 2), (win, win), padding=max_dis)
        return patches.reshape(n, c, win * win, h, w).permute(0, 3, 4, 2, 1)

    scale = 1.0 / math.sqrt(q.shape[-1])
    qk = torch.einsum("bhwc,bhwnc->bhwn", q * scale, unfold(k))
    mask = unfold(torch.ones((1, h, w, 1), dtype=q.dtype, device=q.device))[..., 0]
    qk = qk + rel
    qk = torch.where(mask > 0.5, qk, -1e8)
    attn = torch.softmax(qk, dim=-1)
    return torch.einsum("bhwn,bhwnc->bhwc", attn, unfold(v))


window_attn = window_attn_reference
