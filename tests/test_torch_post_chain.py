"""The port's fused post chain against the JAX package's.

The plain PyTorch version is held to havc_tpu's ``post_chain_reference``
and to ``post_chain_pallas`` (which on the CPU runs the same program) at
max abs <= 1e-5: both are the same float32 arithmetic, so only XLA's
and PyTorch's rounding of identical operations may differ.  The CUDA
kernel is held to the plain version on the card.

The JAX package is imported by the fixture ``pk`` only, so that the card
test runs where JAX is not installed (``python -m pytest --noconftest
tests/test_torch_post_chain.py -m cuda`` on the machine with the GPU).
"""
import numpy as np
import pytest
import torch

from havc_tpu_torch.ops import post_chain as pc
from havc_tpu_torch.utils.profiling import counters

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)


def _launches(name: str) -> int:
    """The kernel launch counter ``name`` of the port's registry."""
    return counters().get(name, 0)


TOL = 1e-5
KW = dict(cmap_ranges=((180.0, 280.0),), cmap_hue_shift=140.0, cmap_weight=0.1)
# the constants HAVC_stabilizer derives on the main path (dark_p=(0.2, 0.8),
# smooth_p=(0.3, 0.7, 0.9, 0.0), ColorMap None)
MAIN_KW = dict(dark_thr=0.1, dark_white=0.2, dark_sat=min(max(1.1 - 0.8, 0.10), 0.80),
               dark_bright=-0.8,
               sm_black=0.3, sm_white=0.7, sm_sat=0.9, sm_bright=-0.0)


@pytest.fixture(scope="module")
def pk():
    return pytest.importorskip("havc_tpu.ops.pallas_kernels")


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.parametrize("shape,kw,seed", [
    ((2, 64, 128, 3), KW, 1),
    ((1, 32, 128, 3), {}, 3),
    ((1, 30, 50, 3), KW, 2),
    ((3, 24, 40, 3), MAIN_KW, 4),
], ids=["colormap", "no_colormap", "odd_sizes", "main_path"])
def test_reference_matches_jax(pk, shape, kw, seed):
    x = _frames(shape, seed)
    want = np.asarray(pk.post_chain_reference(x, **kw))
    want_pallas = np.asarray(pk.post_chain_pallas(x, **kw))
    got = pc.post_chain(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - want_pallas).max() <= TOL


def test_ramp_constants_use_bankers_round():
    # Python's round() is banker's: 0.1*255 = 25.5 -> 26 and
    # 0.3*255 = 76.5 -> 76 (ties to even; C's roundf gives 26 and 77);
    # 0.7*255 = 178.49999999999997 -> 178
    assert pc._ramp(0.1, 0.2) == (26, 0.04)
    assert pc._ramp(0.3, 0.7) == (76, 0.01)


def test_cpu_tensor_takes_plain_version():
    before = _launches("post_chain_launches")
    pc.post_chain(torch.from_numpy(_frames((1, 8, 8, 3), 5)), **MAIN_KW)
    assert _launches("post_chain_launches") == before


def test_kernel_wrapper_refuses_cpu_tensor_and_too_many_ranges():
    with pytest.raises(ValueError):
        pc.post_chain_cuda(torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError):
        pc._params(pc._fill_defaults(dict(cmap_ranges=[(0.0, 1.0)] * 9)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw,start", [
    ((2, 64, 128, 3), KW, 0), ((1, 30, 50, 3), KW, 0), ((3, 96, 96, 3), MAIN_KW, 0),
    ((1, 7, 11, 3), MAIN_KW, 0), ((2, 5, 7, 3), KW, 1),
], ids=["colormap", "odd_sizes", "main_path", "ragged", "misaligned"])
def test_kernel_matches_plain_version_on_card(shape, kw, start):
    """``start`` 1 takes the contiguous slice ``x[1:]``, whose data start
    35 pixels (420 B) into the storage: not on a 16-byte boundary."""
    _need_cuda()
    x = torch.from_numpy(_frames(shape, 6)).cuda()[start:]
    assert x.is_contiguous()
    before = _launches("post_chain_launches")
    got = pc.post_chain(x, **kw)
    torch.cuda.synchronize()
    assert _launches("post_chain_launches") == before + 1
    want = pc.post_chain_reference(x, **kw)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_range_limited_forms_match_generic_on_card():
    """The kernel's cheaper remainder and sextant forms give the generic
    forms' bits over every float of their ranges."""
    _need_cuda()
    assert pc.check_range_forms() == [0, 0, 0]
