"""The port's local window attention against the JAX package's.

``window_attn_reference`` (unfold + einsum) is held to havc_tpu's
``local_window_attention`` (the Pallas kernel in interpret mode) and to
its ``local_window_attention_reference`` at max abs <= 1e-5: the same
float32 function, summed in another order.  The CUDA kernels are held to
the plain version on the card: the float32 one, and the bf16 one on the
same bf16 values (it computes in float32 from them, so the same 1e-5
holds; the JAX side of the bf16 inputs is in tests/test_torch_bf16.py).
The bf16 kernel's arithmetic (tensor-core products of the bf16 values,
the softmax weights in two bf16 terms) is emulated here on the CPU.

The JAX package is imported by the fixture ``pa`` only, so that the card
test runs where JAX is not installed (``python -m pytest --noconftest
tests/test_torch_window_attn.py -m cuda`` on the machine with the GPU).
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from havc_tpu_torch.ops import window_attn as wa
from havc_tpu_torch.utils.profiling import counters

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)


def _launches(name: str) -> int:
    """The kernel launch counter ``name`` of the port's registry."""
    return counters().get(name, 0)


TOL = 1e-5


@pytest.fixture(scope="module")
def pa():
    return pytest.importorskip("havc_tpu.ops.pallas_attn")


def _inputs(shape, d_vu, max_dis, seed):
    """q, k, v at 0.3 and rel at 0.1 standard deviations."""
    rng = np.random.default_rng(seed)
    b, h, w, d_qk = shape
    q = (rng.standard_normal((b, h, w, d_qk)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, h, w, d_qk)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, h, w, d_vu)) * 0.3).astype(np.float32)
    rel = (rng.standard_normal((b, h, w, (2 * max_dis + 1) ** 2)) * 0.1).astype(np.float32)
    return q, k, v, rel


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


CASES = [((2, 6, 9, 16), 32, 7, 0), ((2, 6, 9, 16), 32, 3, 1), ((1, 5, 11, 8), 24, 2, 2)]


@pytest.mark.parametrize("shape,d_vu,max_dis,seed", CASES)
def test_reference_matches_jax(pa, shape, d_vu, max_dis, seed):
    import jax.numpy as jnp

    q, k, v, rel = _inputs(shape, d_vu, max_dis, seed)
    got = wa.window_attn_reference(*map(torch.from_numpy, (q, k, v, rel)), max_dis=max_dis)
    jin = tuple(map(jnp.asarray, (q, k, v, rel)))
    want_kernel = np.asarray(pa.local_window_attention(*jin, max_dis=max_dis, interpret=True))
    want_unfold = np.asarray(pa.local_window_attention_reference(*jin, max_dis=max_dis))
    assert got.shape == want_kernel.shape
    assert np.abs(got.numpy() - want_kernel).max() <= TOL
    assert np.abs(got.numpy() - want_unfold).max() <= TOL


def test_out_of_frame_offsets_get_no_weight():
    """A 1x1 frame: every offset but the centre is out of frame (-1e8), so
    the output is v itself whatever rel says."""
    q, k, v, rel = _inputs((1, 1, 1, 4), 6, 7, 3)
    rel[..., 0] = 50.0  # a large logit at an out-of-frame offset
    out = wa.window_attn_reference(*map(torch.from_numpy, (q, k, v, rel)))
    assert np.abs(out.numpy() - v).max() <= TOL


def test_cpu_tensor_takes_plain_version():
    q, k, v, rel = map(torch.from_numpy, _inputs((1, 4, 5, 8), 16, 7, 4))
    before = _launches("window_attn_launches")
    got = wa.window_attn(q, k, v, rel)
    assert _launches("window_attn_launches") == before
    assert torch.equal(got, wa.window_attn_reference(q, k, v, rel))


def test_cpu_bf16_tensors_take_plain_version_in_float32():
    """bf16 inputs are computed with in float32 and give a float32 result,
    the plain version on the upcast values."""
    q, k, v, rel = (torch.from_numpy(x).bfloat16() for x in _inputs((1, 4, 5, 8), 16, 7, 4))
    before = _launches("window_attn_launches")
    got = wa.window_attn(q, k, v, rel)
    assert _launches("window_attn_launches") == before and got.dtype == torch.float32
    assert torch.equal(got, wa.window_attn_reference(q.float(), k.float(), v.float(),
                                                     rel.float()))


def test_kernel_wrapper_refuses_cpu_tensor_and_bad_shapes():
    q, k, v, rel = map(torch.from_numpy, _inputs((1, 4, 5, 8), 16, 7, 5))
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attn_cuda(q, k, v, rel)
    with pytest.raises(ValueError):
        wa.window_attn(q.to("meta"), k, v, rel)


# the path shape, batch 4 at it, a width that is not a multiple of the
# 4-pixel tile, and channel counts that take the kernels' 4-byte paths
CARD_CASES = [((1, 14, 28, 64), 1024, 7, 0), ((4, 14, 28, 64), 1024, 7, 1),
              ((1, 14, 27, 64), 1024, 7, 2), ((2, 5, 11, 6), 10, 2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d_vu,max_dis,seed", CASES + CARD_CASES)
def test_kernel_matches_plain_version_on_card(shape, d_vu, max_dis, seed):
    _need_cuda()
    q, k, v, rel = (torch.from_numpy(x).cuda() for x in _inputs(shape, d_vu, max_dis, seed))
    before = _launches("window_attn_launches")
    got = wa.window_attn(q, k, v, rel, max_dis=max_dis)
    torch.cuda.synchronize()
    assert _launches("window_attn_launches") == before + 1
    want = wa.window_attn_reference(q, k, v, rel, max_dis=max_dis)
    assert (got - want).abs().max().item() <= TOL


# bf16 inputs: the path shape and the scene batch (16-byte copies), the
# element-by-element copies of d_qk 6 and d_vu 10 with a ragged tile,
# max_dis 0, and render speed "slower" (a 28 x 42 grid: two row tiles)
BF16_CASES = [((1, 14, 28, 64), 1024, 7, 0), ((6, 14, 28, 64), 1024, 7, 4),
              ((2, 5, 11, 6), 10, 2, 3), ((1, 3, 5, 8), 16, 0, 5),
              ((1, 28, 42, 64), 1024, 7, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d_vu,max_dis,seed", BF16_CASES)
def test_bf16_kernel_matches_plain_version_on_card(shape, d_vu, max_dis, seed):
    """The bf16 kernel against the plain version on the same bf16 values:
    both compute in float32, so the float32 tolerance holds; one launch a
    call."""
    _need_cuda()
    q, k, v, rel = (torch.from_numpy(x).cuda().bfloat16()
                    for x in _inputs(shape, d_vu, max_dis, seed))
    before = (_launches("window_attn_launches"), _launches("window_attn_launches_bf16"))
    got = wa.window_attn(q, k, v, rel, max_dis=max_dis)
    torch.cuda.synchronize()
    assert (_launches("window_attn_launches"), _launches("window_attn_launches_bf16")) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32
    want = wa.window_attn_reference(q, k, v, rel, max_dis=max_dis)
    assert (got - want).abs().max().item() <= TOL


def tc_emulation(q, k, v, rel, max_dis: int, terms: int = 2) -> torch.Tensor:
    """The bf16 kernel's arithmetic (``csrc/window_attn_tc.cu``) in torch
    on the CPU: products of the bf16 values summed in float32 (exact, as
    on the tensor cores), the scale applied to the logits, e = exp(s -
    max) in float32, e in ``terms`` bf16 terms (hi = bf16(e), lo = bf16(e
    - hi)) each multiplied into v, the sum divided by sum(e).  The kernel
    takes the maximum as it goes and rescales its sums when it grows,
    which equals this up to rounding."""
    q, k, v, rel = (t.bfloat16().float() for t in (q, k, v, rel))
    win = 2 * max_dis + 1
    b, h, w, d_qk = q.shape

    def unfold(x):  # (N, H, W, C) -> (N, H, W, win*win, C), zero-padded
        n, c = x.shape[0], x.shape[-1]
        patches = F.unfold(x.permute(0, 3, 1, 2), (win, win), padding=max_dis)
        return patches.reshape(n, c, win * win, h, w).permute(0, 3, 4, 2, 1)

    s = torch.einsum("bhwc,bhwnc->bhwn", q, unfold(k)) * (1.0 / math.sqrt(d_qk)) + rel
    s = torch.where(unfold(torch.ones((1, h, w, 1)))[..., 0] > 0.5, s, -torch.inf)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    hi = e.bfloat16().float()
    vu = unfold(v)
    acc = sum(torch.einsum("bhwn,bhwnc->bhwc", p, vu)
              for p in [hi, (e - hi).bfloat16().float()][:terms])
    return acc / e.sum(-1, keepdim=True)


# the path's spatial shape (d_vu cut to 256: the unfold of 1024 is large),
# the scalar shape at max_dis 2, and max_dis 0
TC_CASES = [((1, 14, 28, 64), 256, 7, 0), ((2, 5, 11, 6), 10, 2, 3), ((1, 3, 5, 8), 16, 0, 5)]


@pytest.mark.parametrize("shape,d_vu,max_dis,seed", TC_CASES)
def test_tensor_core_arithmetic_matches_plain_and_jax(pa, shape, d_vu, max_dis, seed):
    """The weights in two bf16 terms keep the bf16 kernel within 1e-6 of
    the plain version on the same bf16 values, and within the float32
    tolerance of the JAX package's reference on them (jitted: one compile
    instead of one per op)."""
    import jax
    import jax.numpy as jnp

    q, k, v, rel = (torch.from_numpy(x).bfloat16() for x in _inputs(shape, d_vu, max_dis, seed))
    got = tc_emulation(q, k, v, rel, max_dis)
    assert (got - wa.window_attn_reference(q, k, v, rel, max_dis=max_dis)).abs().max() <= 1e-6
    jin = tuple(jnp.asarray(t.float().numpy()) for t in (q, k, v, rel))
    reference = jax.jit(pa.local_window_attention_reference, static_argnames="max_dis")
    want = np.asarray(reference(*jin, max_dis=max_dis))
    assert np.abs(got.numpy() - want).max() <= TOL


def test_one_bf16_term_misses_the_kernel_tolerance():
    """Why the weights take two bf16 terms: rounded to one, as attention
    kernels on bf16 usually do, they move the path shape's output ~20x
    past the 1e-5 tolerance."""
    shape, d_vu, max_dis, seed = TC_CASES[0]
    q, k, v, rel = (torch.from_numpy(x).bfloat16() for x in _inputs(shape, d_vu, max_dis, seed))
    want = wa.window_attn_reference(q, k, v, rel, max_dis=max_dis)
    assert (tc_emulation(q, k, v, rel, max_dis, terms=1) - want).abs().max() > 10 * TOL
