"""havc_tpu_torch — the PyTorch/CUDA port of havc_tpu.

``HAVC_main(clip)`` with its whole classic surface (every preset,
Placebo and VerySlow included, every ColorModel with DeOldify Video,
Stable and Artistic, DDColor and Zhang, every CombMethod, ColorFix,
ColorTune, ColorMap and BlackWhiteTune), the filters (``HAVC_bw_tune``,
``HAVC_TimeCube``, ``HAVC_retinex``, ``HAVC_merge``, ...), the exemplar
paths, ``HAVC_main(clip, EnableDeepEx=True)`` with ColorMNet,
Deep-Exemplar, DeepRemaster (also ``HAVC_DeepRemaster``) or the hybrid,
and the bounded-memory streaming paths (``HAVC_main_streaming`` with
BWTune and LUT, ``streaming.HAVC_restore_video_streaming`` with every
engine) run on an
NVIDIA GPU: plain tensor code in PyTorch, and the TPU kernels rewritten in CUDA
C++ for Hopper (``csrc/post_chain.cu``, the fused post chain;
``csrc/window_attn.cu`` and, on bf16 inputs, ``csrc/window_attn_tc.cu``,
ColorMNet's local window attention), built with
``nvcc`` at first use.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without CUDA the default raises.

The package imports torch, numpy and scipy; OpenCV only inside the
functions that open a container file (``.y4m`` needs none).  It never
imports jax or havc_tpu.
"""

__version__ = "0.1.0"

from .api import *  # noqa: F401,F403
from .clip import Clip, SceneFlags  # noqa: F401
from .exemplar import HAVC_cmnet2, HAVC_deepex  # noqa: F401
from .scene import scene_detect  # noqa: F401
from .streaming import HAVC_main_streaming  # noqa: F401
from .utils import HAVC_LogMessage, HAVCError, MessageType  # noqa: F401
