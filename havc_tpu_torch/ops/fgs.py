"""Fast Global Smoother (Min et al. 2014): the WLS edge-aware filter the
Deep-Exemplar path applies to its predicted chroma.  Port of
``havc_tpu.ops.fgs``.

Per row, then per column, the 1-D system ``(I + lambda_t A) u = f``, with
``A`` tridiagonal from the guide's weights ``w(p, q) = exp(-|I_p - I_q| /
sigma_color)``, is solved exactly by the Thomas algorithm, three times
with ``lambda_t = 1.5 * lambda * 4^(T - t) / (4^T - 1)``.

Plain PyTorch: each pass computes its coefficients once, then runs the
forward elimination and the back substitution as a loop over the solve
axis, each step on the ``(R * C,)`` slice of every independent system at
once (preallocated tensors, written in place), in the JAX scan's order of
operations.  About eight small kernels a step: a clip at the Medium work
size takes some 15,000 launches.
"""
from __future__ import annotations

import torch

__all__ = ["fgs_smooth", "fgs_smooth_ab"]


def _tridiag_thomas(a, b, c, f):
    """Solve ``a[i] u[i-1] + b[i] u[i] + c[i] u[i+1] = f[i]`` along axis 0
    of ``(N, R)`` tensors (``a[0]`` and ``c[N-1]`` are 0)."""
    n = f.shape[0]
    cp, dp, u = torch.empty_like(f), torch.empty_like(f), torch.empty_like(f)
    zeros = torch.zeros_like(f[0])
    denom, tmp = torch.empty_like(zeros), torch.empty_like(zeros)
    cp_prev = dp_prev = zeros
    for i in range(n):
        torch.sub(b[i], torch.mul(a[i], cp_prev, out=tmp), out=denom)
        torch.div(c[i], denom, out=cp[i])
        torch.sub(f[i], torch.mul(a[i], dp_prev, out=tmp), out=tmp)
        torch.div(tmp, denom, out=dp[i])
        cp_prev, dp_prev = cp[i], dp[i]
    u_next = zeros
    for i in range(n - 1, -1, -1):
        torch.sub(dp[i], torch.mul(cp[i], u_next, out=tmp), out=u[i])
        u_next = u[i]
    return u


def _pass_axis(x, guide, lam, sigma, axis):
    """One WLS pass over ``(B, H, W, C)`` ``x`` guided by ``(B, H, W)``
    ``guide``, solving along ``axis`` (1 = columns, 2 = rows)."""
    xm = x.movedim(axis, 0)  # (N, ..., C)
    n, c_ch = xm.shape[0], x.shape[-1]
    gr = guide.movedim(axis, 0).reshape(n, -1)  # (N, R)
    lw = lam * torch.exp(-torch.abs(gr[1:] - gr[:-1]) / sigma)
    zeros = torch.zeros_like(gr[:1])
    a = -torch.cat([zeros, lw])  # a[0] = 0
    c = -torch.cat([lw, zeros])  # c[N-1] = 0
    b = 1.0 - a - c

    def rep(m):  # one system per (row, channel), channels innermost
        return m[:, :, None].expand(-1, -1, c_ch).reshape(n, -1)

    us = _tridiag_thomas(rep(a), rep(b), rep(c), xm.reshape(n, -1))
    return us.reshape(xm.shape).movedim(0, axis)


def fgs_smooth(
    guide: torch.Tensor,  # (B, H, W) guide plane (uint8-scale codes)
    x: torch.Tensor,  # (B, H, W, C) planes to smooth
    lam: float = 500.0,
    sigma_color: float = 4.0,
    num_iter: int = 3,
) -> torch.Tensor:
    """OpenCV's ``ximgproc`` FastGlobalSmoother: rows then columns, each
    iteration with its own lambda."""
    guide = guide.float()
    out = x.float()
    denom = 4.0 ** num_iter - 1.0
    for t in range(1, num_iter + 1):
        lam_t = 1.5 * lam * (4.0 ** (num_iter - t)) / denom
        out = _pass_axis(out, guide, lam_t, sigma_color, axis=2)  # rows
        out = _pass_axis(out, guide, lam_t, sigma_color, axis=1)  # columns
    return out.to(x.dtype)


def fgs_smooth_ab(lab_l: torch.Tensor, ab: torch.Tensor,
                  lam: float = 500.0, sigma_color: float = 4.0) -> torch.Tensor:
    """The WLS filter Deep-Exemplar applies to its a/b planes (B, H,
    W, 2): the guide is L as uint8 codes, ``round(L * 255 / 100)``."""
    guide = torch.round(torch.clamp(lab_l[..., 0] * (255.0 / 100.0), 0.0, 255.0))
    return fgs_smooth(guide, ab, lam=lam, sigma_color=sigma_color)
