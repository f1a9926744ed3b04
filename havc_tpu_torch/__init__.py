"""havc_tpu_torch — the PyTorch/CUDA port of havc_tpu.

The main path, ``HAVC_main(clip)`` with its defaults, runs on an NVIDIA
GPU: plain tensor code in PyTorch, and the fused post-chain kernel
written in CUDA C++ for Hopper (``csrc/post_chain.cu``, built with
``nvcc`` at first use).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without CUDA the default raises.

The package imports torch and numpy only; it never imports jax or
havc_tpu.
"""

__version__ = "0.1.0"

from .api import *  # noqa: F401,F403
from .clip import Clip, SceneFlags  # noqa: F401
