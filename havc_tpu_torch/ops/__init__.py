"""Tensor ops of the port: colorspace, resize, chroma, merge, temporal
and the fused post-chain kernel."""
