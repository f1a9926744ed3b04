"""``HAVC_main_streaming`` with ``BWTune`` and ``LUT``: the port against the
JAX package on the CPU.

The set-up is tests/test_torch_streaming.py's (the same 40-frame gray mp4,
small engines carried from flax, render factor 4, torch on 2 threads),
whose fixtures this file uses.  BWTune is the full-resolution
``bw_tune_frames`` before the work resize, LUT the look (and its tweak)
after the restore; both retune luma on the device, so ``auto`` resolves
to ``i420``.  What each package's ``_WritePipeline._retire`` receives is
held to at most 1 code value apart, as tests/test_torch_streaming.py
holds it (the share of unequal codes is printed).
"""
import numpy as np
import pytest

import havc_tpu_torch
from havc_tpu_torch import streaming as tstream

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_streaming import (  # noqa: F401  (fixtures)
    J, _codes_close, _joined, _record_retire, cv2, engines_pair, gray_mp4,
    small_engines,
)


@pytest.mark.parametrize("kw,mode", [(dict(BWTune="Light"), "gray+i420"),
                                     (dict(LUT=2), "gray+i420"),
                                     (dict(BWTune="Medium", bw_method=2, LUT=8), "gray+i420")],
                         ids=["bwtune", "lut", "both"])
def test_main_streaming_bwtune_lut_matches_jax(J, small_engines, gray_mp4, monkeypatch, kw, mode):
    """The packed bytes agree within 1 code, in ``i420`` mode."""
    want = _record_retire(monkeypatch, J.streaming._WritePipeline, np.asarray)
    got = _record_retire(monkeypatch, tstream._WritePipeline, lambda p: p.wait())
    args = dict(batch_size=8, chunk_size=16, sink="null", **kw)
    n = J.streaming.HAVC_main_streaming(gray_mp4, "unused.mp4", **args)
    assert J.streaming.last_transfer() == mode
    assert havc_tpu_torch.HAVC_main_streaming(gray_mp4, "unused.mp4", device="cpu", **args) == n
    assert tstream.last_transfer() == mode
    _codes_close(_joined(want, "packed"), _joined(got, "packed"), f"{kw}")
