"""DeepRemaster NetworkC (NCDHW): a 3-D temporal CNN with source-reference
attention.  Port of ``havc_tpu.models.remaster``.

The port computes in ``(B, C, T, H, W)`` with ``nn.Conv3d``:

* ``down1``: nine ``TempConv`` blocks (conv3d + folded BatchNorm + ELU)
  over the luma minus 0.4462414, down to 1/8; ``reffeatnet1`` the same
  trunk over the RGB references minus 0.48;
* source-reference attention at 1/8 and 1/16 (queries from the frames,
  keys and values from the references, softmax over every reference
  token, ``gamma * out + source``), then two self-attentions;
* a decoder of skip concat and 2x spatial upsamples back to full size,
  ending in a sigmoid: ab in [0, 1].

``encode_refs`` runs the reference trunk once per reference window and
``colorize_with_refs`` reuses it for every frame window.  An attention's
logits are computed in row blocks of at most ``ATTN_BLOCK_ELEMS`` floats
(a row's softmax does not depend on the others): at 1080p the first
attention of one window has 5,760 x 57,600 logits, 1.33 GB in f32.

``TempConv`` folds its BatchNorm as the JAX package does, ``x * inv +
(bias - mean * scale / sqrt(var + eps))`` with ``inv = scale / sqrt(var +
eps)``, both constants formed in float32 and cast to the activations'
dtype; its statistics are the raw parameters ``bn_scale``, ``bn_bias``,
``bn_mean``, ``bn_var`` and the attention gate is ``gamma`` (flax names).

The network computes in the dtype of its parameters and input (bf16 when
the engine casts it); the attentions' logits and softmax are float32, the
weights cast back to the activations' dtype, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["NetworkC", "TempConv", "Upsample3d", "SourceReferenceAttention",
           "colorize_window", "ATTN_BLOCK_ELEMS"]

ATTN_BLOCK_ELEMS = 1 << 29  # logits per attention block: 2 GiB of f32


class TempConv(nn.Module):
    """conv3d + BatchNorm3d in inference form + ELU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 3, 3), stride=(1, 1, 1),
                 padding=(0, 1, 1)):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride, padding)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))
        self.bn_mean = nn.Parameter(torch.zeros(cout))
        self.bn_var = nn.Parameter(torch.ones(cout))

    def reset_flax(self, generator):
        self.bn_scale.fill_(1.0)
        self.bn_bias.zero_()
        self.bn_mean.zero_()
        self.bn_var.fill_(1.0)

    def forward(self, x):
        x = self.conv(x)
        scale, var = self.bn_scale.float(), self.bn_var.float()
        root = torch.sqrt(var + 1e-5)
        inv = (scale / root).to(x.dtype)
        shift = (self.bn_bias.float() - self.bn_mean.float() * scale / root).to(x.dtype)
        return F.elu(x * inv[:, None, None, None] + shift[:, None, None, None])


def _up_spatial(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """``jax.image.resize(..., "trilinear")`` with T unchanged: a bilinear
    upsample of H and W with half-pixel centres (the border replicates)."""
    b, c, t, h, w = x.shape
    return F.interpolate(x, size=(t, h * factor, w * factor), mode="trilinear",
                         align_corners=False)


class Upsample3d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = TempConv(cin, cout, (3, 3, 3), (1, 1, 1), (1, 1, 1))

    def forward(self, x):
        return self.conv(_up_spatial(x, 2))


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T*H*W, C)."""
    return x.flatten(2).transpose(1, 2)


class SourceReferenceAttention(nn.Module):
    """Global attention of the source tokens over the reference tokens,
    gated by ``gamma`` (flax init 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.query = nn.Conv3d(channels, channels // 8, 1)
        self.key = nn.Conv3d(channels, channels // 8, 1)
        self.value = nn.Conv3d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def reset_flax(self, generator):
        self.gamma.zero_()

    def forward(self, source, reference):
        b, c, st, sh, sw = source.shape
        q, k, v = _tokens(self.query(source)), _tokens(self.key(reference)), \
            _tokens(self.value(reference))
        n, m = q.shape[1], k.shape[1]
        rows = max(1, min(n, ATTN_BLOCK_ELEMS // max(b * m, 1)))
        kt = k.transpose(1, 2)
        q, kt = q.float(), kt.float()  # logits and softmax in float32
        out = torch.cat([torch.matmul(torch.softmax(torch.matmul(q[:, r:r + rows], kt), dim=-1)
                                      .to(v.dtype), v)
                         for r in range(0, n, rows)], dim=1)
        out = out.transpose(1, 2).reshape(b, c, st, sh, sw)
        return self.gamma.to(source.dtype) * out + source


class _Trunk(nn.Module):
    """The nine-block downsampling trunk (``down1`` / ``reffeatnet1``)."""

    def __init__(self, cin: int, replication_pad: bool = False):
        super().__init__()
        self.replication_pad = replication_pad
        s2 = dict(kernel=(1, 3, 3), stride=(1, 2, 2))
        self.b0 = TempConv(cin, 64, padding=(0, 0, 0) if replication_pad else (0, 1, 1), **s2)
        self.b1, self.b2 = TempConv(64, 128), TempConv(128, 128)
        self.b3 = TempConv(128, 256, padding=(0, 1, 1), **s2)
        self.b4, self.b5 = TempConv(256, 256), TempConv(256, 256)
        self.b6 = TempConv(256, 512, padding=(0, 1, 1), **s2)
        self.b7, self.b8 = TempConv(512, 512), TempConv(512, 512)

    def forward(self, x):
        if self.replication_pad:  # H and W padded by 1 (edge), T untouched
            x = F.pad(x, (1, 1, 1, 1, 0, 0), mode="replicate")
        for i in range(9):
            x = getattr(self, f"b{i}")(x)
        return x


class NetworkC(nn.Module):
    """L (B, 1, T, H, W) in [0, 1] and reference RGB (B, 3, Tr, H, W) in
    [0, 1] -> ab (B, 2, T, H, W) in [0, 1].  H and W divide by 16."""

    def __init__(self):
        super().__init__()
        s2 = dict(kernel=(1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        k3 = dict(kernel=(3, 3, 3), stride=(1, 1, 1), padding=(1, 1, 1))
        self.down1 = _Trunk(1, replication_pad=True)
        self.reffeatnet1 = _Trunk(3)
        self.stattn1 = SourceReferenceAttention(512)
        self.flat0, self.flat1 = TempConv(512, 512), TempConv(512, 512)
        self.down2_0, self.down2_1 = TempConv(512, 512, **s2), TempConv(512, 512)
        self.ref2_0, self.ref2_1, self.ref2_2 = (TempConv(512, 512, **s2), TempConv(512, 512),
                                                 TempConv(512, 512))
        self.stattn2 = SourceReferenceAttention(512)
        self.conv1 = TempConv(512, 512)
        self.selfattn1 = SourceReferenceAttention(512)
        self.up1 = TempConv(1024, 512, **k3)
        self.selfattn2 = SourceReferenceAttention(512)
        self.conv2 = TempConv(512, 256, **k3)
        self.up2_0 = Upsample3d(256, 128)
        self.up2_1 = TempConv(128, 64, **k3)
        self.up3_0 = Upsample3d(64, 32)
        self.up3_1 = TempConv(32, 16, **k3)
        self.up4_0 = TempConv(16, 8, **k3)
        self.up4_out = nn.Conv3d(8, 2, 3, 1, 1)

    def encode_refs(self, x_refs):
        """Reference stack -> (features at 1/8, features at 1/16)."""
        reffeat = self.reffeatnet1(x_refs - 0.48)
        return reffeat, self.ref2_2(self.ref2_1(self.ref2_0(reffeat)))

    def colorize_with_refs(self, x, reffeat: Optional[torch.Tensor],
                           reffeat2: Optional[torch.Tensor]):
        """Forward against encoded references (batch 1 broadcasts over the
        batch of ``x``), or none."""
        b = x.shape[0]

        def bcast(r):
            return r.expand(b, *r.shape[1:]) if r.shape[0] == 1 and b > 1 else r

        x1 = self.down1(x - 0.4462414)
        if reffeat is not None:
            x1 = self.stattn1(x1, bcast(reffeat))
        x2 = self.flat1(self.flat0(x1))
        out = self.down2_1(self.down2_0(x1))
        if reffeat2 is not None:
            out = self.stattn2(out, bcast(reffeat2))
        out = self.conv1(out)
        out = self.selfattn1(out, out)
        out = torch.cat([_up_spatial(out, 2), x2], dim=1)
        out = self.up1(out)
        out = self.selfattn2(out, out)
        out = self.conv2(out)
        out = self.up2_1(self.up2_0(out))
        out = self.up3_1(self.up3_0(out))
        out = self.up4_0(_up_spatial(out, 2))
        return torch.sigmoid(self.up4_out(out))

    def forward(self, x, x_refs: Optional[torch.Tensor] = None):
        reffeat, reffeat2 = self.encode_refs(x_refs) if x_refs is not None else (None, None)
        return self.colorize_with_refs(x, reffeat, reffeat2)


def colorize_window(model: NetworkC, luma01: torch.Tensor, refs_rgb: torch.Tensor) -> torch.Tensor:
    """One inference window, channel-last like the JAX package's: L (B, T,
    H, W, 1) and references (B, Tr, H, W, 3) -> ab01 (B, T, H, W, 2)."""
    out = model(luma01.permute(0, 4, 1, 2, 3), refs_rgb.permute(0, 4, 1, 2, 3))
    return out.permute(0, 2, 3, 4, 1)
