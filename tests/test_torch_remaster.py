"""The port's DeepRemaster (NetworkC, ``remaster_propagate``,
``HAVC_DeepRemaster``) against the JAX package's, on the CPU.

NetworkC runs at its published width (54,303,374 parameters) in both
packages with the same weights: seeded with numpy at the shapes
``jax.eval_shape`` gives (``seeded_params`` of
tests/test_torch_exemplar_surface.py: BatchNorm statistics off their init
values, the attention gates ``gamma`` at 0.3) and carried over with
``state_dict_from_flax`` (5-D kernels DHWIO -> OIDHW).  Frames are 32x64
for the network and 32x48 for the entry points (``frame_mindim=32`` on
48x64 clips: ``remaster_work_shape`` gives the /16 geometry).  The JAX
package's compiled functions are kept for the module.

Tolerance: 1e-4 of the output's scale for NetworkC (measured 1.2e-7
absolute: a sigmoid after f32 convolutions summed in another order) and
1e-4 absolute on RGB for the propagation and the entry points (the vivid
tweak's hue-range mask has no threshold near these colors).  The row
blocking of the port's attention and its bilinear upsample are held
exactly to the unblocked product (1e-6) and to ``jax.image.resize``'s
"trilinear" with T unchanged (1e-6, border rows included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu import exemplar as jex
from havc_tpu.clip import Clip as JClip
from havc_tpu.models import remaster as jrm
from havc_tpu.utils import jitcache

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.models import remaster as trm
from havc_tpu_torch.models.bridge import state_dict_from_flax

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_exemplar_surface import colored_clip, gray_clip, seeded_params

CPU = torch.device("cpu")
TOL = 1e-4


def remaster_tree():
    x, refs = jnp.zeros((1, 2, 32, 64, 1)), jnp.zeros((1, 2, 32, 64, 3))
    return seeded_params(jrm.NetworkC(), 31, x, refs)


def remaster_net(tree):
    net = trm.NetworkC()
    net.load_state_dict(state_dict_from_flax(tree))
    return net.eval().requires_grad_(False)


class JaxRemaster(jex.RemasterEngine):
    """The JAX package's engine with the shared tree, in float32."""

    def __init__(self, tree, seed=0, frame_size=320, dtype=None):
        self.size, self.model, self.dtype = frame_size, jrm.NetworkC(), jnp.float32
        self.params = {"params": tree}


@pytest.fixture(scope="module")
def tree():
    return remaster_tree()


@pytest.fixture(scope="module")
def net(tree):
    return remaster_net(tree)


@pytest.fixture(scope="module")
def remaster_both(tree, net):
    """Both packages' DeepRemaster engines swapped for the seeded one, the
    JAX compile cache kept for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        mp.setattr(jex, "_ENGINE_CACHE", {})
        mp.setattr(jex, "RemasterEngine", lambda **kw: JaxRemaster(tree, **kw))
        mp.setitem(tengines.registry._cache, ("remaster", "full", CPU), net)
        yield


def rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-6))


def rand(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def to5(a):  # (B, T, H, W, C) -> (B, C, T, H, W)
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def from5(t):
    return t.permute(0, 2, 3, 4, 1).numpy()


# --- NetworkC -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jnet():
    return jax.jit(jrm.NetworkC().apply)


@pytest.mark.parametrize("with_refs", [True, False], ids=["refs", "no_refs"])
def test_networkc(tree, net, jnet, with_refs):
    x = rand((2, 2, 32, 64, 1), 1)
    refs = rand((2, 3, 32, 64, 3), 2) if with_refs else None
    want = jnet({"params": tree}, jnp.asarray(x), None if refs is None else jnp.asarray(refs))
    with torch.no_grad():
        got = (trm.colorize_window(net, torch.from_numpy(x), torch.from_numpy(refs))
               if with_refs else from5(net(to5(x))))
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert rel(want, got) <= TOL


def test_encode_refs_then_colorize_equals_call(tree, net):
    """The encoded references (batch 1) broadcast over a batch of windows,
    as ``remaster_propagate`` uses them."""
    x, refs = rand((3, 2, 32, 64, 1), 3), rand((1, 4, 32, 64, 3), 4)
    jm = jrm.NetworkC()
    rf = jax.jit(lambda p, r: jm.apply(p, r, method="encode_refs"))({"params": tree},
                                                                    jnp.asarray(refs))
    want = jax.jit(lambda p, x_, a, b: jm.apply(p, x_, a, b, method="colorize_with_refs"))(
        {"params": tree}, jnp.asarray(x), *rf)
    with torch.no_grad():
        t_rf = net.encode_refs(to5(refs))
        got = from5(net.colorize_with_refs(to5(x), *t_rf))
        whole = from5(net(to5(x), to5(np.repeat(refs, 3, axis=0))))
    for a, b in zip(rf, t_rf):
        assert rel(a, from5(b)) <= TOL
    assert rel(want, got) <= TOL
    assert np.abs(got - whole).max() <= 1e-6


def test_attention_row_blocks(net, monkeypatch):
    """Logits in row blocks (here 7 rows at a time) equal the whole
    product: a row's softmax does not depend on the others."""
    x, refs = rand((1, 2, 32, 64, 1), 5), rand((1, 3, 32, 64, 3), 6)
    with torch.no_grad():
        whole = net(to5(x), to5(refs))
        monkeypatch.setattr(trm, "ATTN_BLOCK_ELEMS", 7 * 3 * 32)  # 7 rows of 3*4*8 keys
        blocked = net(to5(x), to5(refs))
    assert torch.abs(whole - blocked).max().item() <= 1e-6


def test_up_spatial_matches_trilinear():
    x = rand((2, 3, 5, 7, 4), 7)  # (B, T, H, W, C)
    want = np.asarray(jrm._up_spatial(jnp.asarray(x), 2))
    got = from5(trm._up_spatial(to5(x), 2))
    assert want.shape == got.shape == (2, 3, 10, 14, 4)
    assert np.abs(want - got).max() <= 1e-6
    assert np.abs(want[:, :, [0, -1]] - got[:, :, [0, -1]]).max() <= 1e-6  # the border rows


@pytest.mark.parametrize("wh", [(1920, 1080), (1080, 1920), (720, 480), (64, 48), (320, 180),
                                (1000, 333)])
def test_remaster_work_shape(wh):
    for mindim in (320, 256, 32):
        assert tex.remaster_work_shape(*wh, mindim) == jex.remaster_work_shape(*wh, mindim)
    assert tex.remaster_work_shape(1920, 1080) == (320, 576)


# --- remaster_propagate ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["sliding", "frame0", "static"])
def test_remaster_propagate(remaster_both, tree, net, case):
    """``sliding``: a window of 4 of 8 references that advances over 13
    frames (a ragged last window and a padded group); ``frame0``: the same
    schedule from a chunk starting at global frame 6 with the references
    from there; ``static``: no positions, the window stays."""
    frames, refs = rand((13, 32, 48, 3), 8), rand((8, 32, 48, 3), 9)
    pos = np.array([0, 2, 3, 5, 7, 9, 10, 12])
    kw = dict(ref_positions=pos, ref_buffer_size=4)
    if case == "frame0":
        frames, refs, kw = frames[6:], refs[3:], dict(ref_positions=pos[3:], ref_buffer_size=4,
                                                     frame0=6)
    elif case == "static":
        kw = dict(ref_buffer_size=4)
    want = jex.remaster_propagate(jex._get_engine("remaster"), frames, refs, **kw)
    got = tex.remaster_propagate(tex.RemasterEngine(device="cpu"), frames, refs, **kw)
    assert isinstance(got, torch.Tensor) and got.shape == frames.shape
    assert np.abs(np.asarray(want) - got.numpy()).max() <= TOL


def test_window_schedule_advances():
    """The host schedule the propagation follows: the window of 4 moves one
    slot whenever a window's first frame passes its second reference
    (st 4 passes frames 2 and 3 at once; from start 4 on, 4 + 4 = 8 is
    every reference)."""
    pos = np.array([0, 2, 3, 5, 7, 9, 10, 12])
    starts = tex._remaster_window_starts(13, 2, 4, 8, pos, 0.5, 0)
    assert starts == [0, 0, 2, 3, 4, 4, 4]
    assert tex._remaster_window_starts(7, 2, 4, 5, pos[3:], 0.5, 6) == [0, 1, 1, 1]


# --- HAVC_DeepRemaster ----------------------------------------------------------------


def _write_refs(d, frames, at):
    cv2 = pytest.importorskip("cv2")
    d.mkdir()
    for n in at:
        u8 = np.rint(np.clip(frames[n], 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(d / f"ref_{n:06d}.png"), cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
    return str(d)


@pytest.mark.parametrize("source", ["clip_ref", "dir_mode0", "dir_mode1", "clip_ref_vivid"])
def test_havc_deepremaster(remaster_both, tmp_path, source):
    gray, colored = gray_clip(seed=11), colored_clip(seed=12)
    kw = dict(frame_mindim=32, ref_buffer_size=4)
    jkw, tkw = dict(kw), dict(kw)
    if source.startswith("clip_ref"):
        jkw["clip_ref"], tkw["clip_ref"] = JClip(frames=colored.copy()), \
            havc_tpu_torch.Clip(frames=colored.copy())
        if source.endswith("vivid"):
            jkw["render_vivid"] = tkw["render_vivid"] = True
    else:
        ref_dir = _write_refs(tmp_path / "refs", colored, [0, 3, 6, 9, 11])
        jkw.update(ref_dir=ref_dir, mode=int(source[-1]))
        tkw.update(ref_dir=ref_dir, mode=int(source[-1]))
    want = jex.HAVC_DeepRemaster(JClip(frames=gray.copy()), **jkw)
    got = havc_tpu_torch.HAVC_DeepRemaster(havc_tpu_torch.Clip(frames=gray.copy()), device="cpu",
                                           **tkw)
    assert isinstance(got.frames, np.ndarray) and got.frames.shape == gray.shape
    assert np.abs(np.asarray(want.frames) - got.frames).max() <= TOL


def test_havc_deepremaster_needs_references():
    with pytest.raises(ValueError, match="ref_dir is unset"):
        havc_tpu_torch.HAVC_DeepRemaster(havc_tpu_torch.Clip(frames=gray_clip()), device="cpu")
