"""The port's classic-surface models against the JAX package's, with the
same weights: DeOldify Artistic's ``DeOldifyDeep`` (nano encoder) and the
Zhang nets ECCV16 and Siggraph17 at a narrow width, with their transposed
convolutions carried by the weight bridge.

The JAX Zhang modules have their published widths built in; the narrow
JAX nets here come from the same module code with the conv, transposed
conv and BatchNorm constructors it calls scaled by ``width / 64`` (the 313
classes and 2 ab channels kept), which is what the port's ``width``
argument does.  Flax parameters are seeded, their BatchNorm statistics
perturbed from a numpy seed, and carried over.  Tolerance: max abs error
<= 1e-4 of the output's max abs (float32 convolutions sum in another
order in XLA and in PyTorch).  The full-width nets are checked for key and
shape coverage only.  Torch runs on 2 threads, as in
tests/test_torch_streaming.py.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu.models import deoldify as jdo
from havc_tpu.models import layers as jlayers
from havc_tpu.models import zhang as jzh

from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.models import zhang as tzh
from havc_tpu_torch.models.bridge import flatten_tree, state_dict_from_flax, torch_key, torch_shape

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)


REL_TOL = 1e-4
ZHANG_WIDTH = 8


def perturb(tree, seed):
    """Nested numpy copy of a flax tree with the BatchNorm statistics and
    biases moved off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(name, v):
        v = np.array(v, dtype=np.float32)
        if name in ("scale", "var"):
            return v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        if name == "gamma":
            return np.full(v.shape, 0.3, np.float32)
        return v

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in node.items()}

    return walk(jax.tree_util.tree_map(np.asarray, dict(tree)))


@contextlib.contextmanager
def narrow_jax_zhang(width: int = ZHANG_WIDTH):
    """Inside: ``havc_tpu.models.zhang``'s nets build at ``width`` (their
    convs, transposed convs and BatchNorms scaled by width/64, the 313
    classes and 2 ab channels kept)."""
    def scaled(f):
        return f if f in (2, 313) else f * width // 64

    saved = {n: getattr(jzh, n) for n in ("PtConv", "PtConvTranspose", "BatchNormInference")}
    jzh.PtConv = lambda f, *a, **k: jlayers.PtConv(scaled(f), *a, **k)
    jzh.PtConvTranspose = lambda f, *a, **k: jlayers.PtConvTranspose(scaled(f), *a, **k)
    jzh.BatchNormInference = lambda f, *a, **k: jlayers.BatchNormInference(scaled(f), *a, **k)
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(jzh, n, v)


def carry_zhang(name: str, seed: int, width: int = ZHANG_WIDTH):
    """(flax module, params, torch module) of a narrow Zhang net with the
    same weights.  Apply the flax module inside ``narrow_jax_zhang``."""
    jm = jzh.ECCV16() if name == "eccv16" else jzh.Siggraph17()
    with narrow_jax_zhang(width):
        params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 1)))
    params = {"params": perturb(params["params"], seed)}
    tm = tzh.ECCV16(width) if name == "eccv16" else tzh.Siggraph17(width)
    tm.load_state_dict(state_dict_from_flax(params["params"]))
    return jm, params, tm.eval().requires_grad_(False)


def carry_deep(seed: int = 2):
    """(flax params, torch module) of a nano DeOldifyDeep."""
    jm = jdo.DeOldifyDeep(encoder="nano", nf_factor=1.5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    params = {"params": perturb(params["params"], seed)}
    tm = tdo.DeOldifyDeep(encoder="nano", nf_factor=1.5)
    tm.load_state_dict(state_dict_from_flax(params["params"]))
    return params, tm.eval().requires_grad_(False)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= REL_TOL * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def deep_pair():
    return carry_deep()


@pytest.fixture(scope="module", params=["eccv16", "siggraph17"])
def zhang_triple(request):
    return (request.param,) + carry_zhang(request.param, 3)


def test_transposed_conv_bridge_orientation():
    """A ``PtConvTranspose`` kernel lands in ``nn.ConvTranspose2d``'s
    (in, out, kh, kw) layout in the right spatial orientation: a kernel
    that is not symmetric gives the same output in both."""
    m = jlayers.PtConvTranspose(5, 4, 2, 1)
    x = np.random.default_rng(0).standard_normal((2, 6, 7, 3)).astype(np.float32)
    p = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sd = state_dict_from_flax(p["params"])
    assert set(sd) == {"weight", "bias"} and tuple(sd["weight"].shape) == (3, 5, 4, 4)
    t = torch.nn.ConvTranspose2d(3, 5, 4, 2, 1)
    t.load_state_dict(sd)
    got = t(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, m.apply(p, jnp.asarray(x)))
    flipped = torch.nn.ConvTranspose2d(3, 5, 4, 2, 1)
    flipped.load_state_dict({"weight": sd["weight"].flip(2, 3), "bias": sd["bias"]})
    assert (flipped(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1) - got
            ).abs().max() > 1e-2


def test_deoldify_deep_forward(deep_pair):
    params, tm = deep_pair
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jdo.DeOldifyDeep(encoder="nano", nf_factor=1.5).apply)(params, x)
    _close(tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), want)


def test_deoldify_deep_colorize(deep_pair):
    params, tm = deep_pair
    rgb = np.random.default_rng(5).random((1, 40, 56, 3), dtype=np.float32)
    want = jdo.colorize(params, jnp.asarray(rgb), jdo.DeOldifyDeep(encoder="nano", nf_factor=1.5),
                        render_factor=4)
    _close(tdo.colorize(tm, torch.from_numpy(rgb), render_factor=4), want)


def test_zhang_forward(zhang_triple):
    name, jm, params, tm = zhang_triple
    lum = (100.0 * np.random.default_rng(6).random((2, 64, 64, 1))).astype(np.float32)
    with narrow_jax_zhang():
        want = jm.apply(params, jnp.asarray(lum))
    _close(tm(torch.from_numpy(lum).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("input_size", [64, 256])
def test_zhang_colorize(zhang_triple, input_size):
    """The colorize call: bicubic resize, L in, ab out resized back and joined
    with the original L (256 is the size the engines use)."""
    name, jm, params, tm = zhang_triple
    rgb = np.random.default_rng(7).random((1, 48, 72, 3), dtype=np.float32)
    with narrow_jax_zhang():
        want = jzh.colorize(params, jnp.asarray(rgb), jm, input_size=input_size)
    _close(tzh.colorize(tm, torch.from_numpy(rgb), input_size=input_size), want)


@pytest.mark.parametrize("name", ["artistic", "eccv16", "siggraph17"])
def test_full_width_key_and_shape_coverage(name):
    if name == "artistic":
        jm, build, x = jdo.make_model("artistic"), lambda: tdo.make_model("artistic"), (1, 64, 64, 3)
    else:
        jm = jzh.ECCV16() if name == "eccv16" else jzh.Siggraph17()
        build = lambda: tzh.ECCV16() if name == "eccv16" else tzh.Siggraph17()  # noqa: E731
        x = (1, 64, 64, 1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(x))
    want = {torch_key(p): torch_shape(p, leaf.shape) for p, leaf in flatten_tree(shapes["params"])}
    with torch.device("meta"):
        tm = build()
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert got == want
    n_params = sum(int(np.prod(s)) for s in want.values())
    # full width: 63.6 M (Artistic), 32.2 M (ECCV16), 34.1 M (Siggraph17)
    assert n_params > {"artistic": 6e7, "eccv16": 3e7, "siggraph17": 3e7}[name], n_params
