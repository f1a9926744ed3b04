"""The port's models against the JAX package's, with the same weights.

The flax parameters are made by havc_tpu (seeded init, then every
BatchNorm statistic, scale and gate perturbed from a numpy seed so that a
swapped or dropped leaf shows), carried into the torch modules by the
weight bridge, and both forwards run on the same numpy input.  Tolerance:
max abs error <= 1e-4 of the output's max abs (float32 convolutions and
matmuls sum in another order in XLA and in PyTorch).

The full-width Video and Artistic models are checked for key and shape
coverage only: ``jax.eval_shape`` of their init against the port's modules
built on the meta device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu.models import ddcolor as jdd
from havc_tpu.models import deoldify as jdo
from havc_tpu.models import resnet as jresnet

from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.models import resnet as tresnet
from havc_tpu_torch.models.bridge import (
    flatten_tree, state_dict_from_flax, torch_key, torch_shape,
)

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

REL_TOL = 1e-4


def _perturb(tree, seed):
    """Nested copy of a flax tree (numpy) with BatchNorm/LayerNorm/gate
    leaves moved off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(name, v):
        v = np.array(v, dtype=np.float32)
        if name == "scale":
            return v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        if name == "var":
            return v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if name == "gamma":
            return np.full(v.shape, 0.3, np.float32)
        return v

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in node.items()}

    return walk(jax.tree_util.tree_map(np.asarray, dict(tree)))


def _carry(jmodel, tmodel, input_size, seed):
    """(flax params, torch module with the same weights)."""
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, input_size, input_size, 3)))
    params = {"params": _perturb(params["params"], seed)}
    tmodel.load_state_dict(state_dict_from_flax(params["params"]))
    return params, tmodel.eval().requires_grad_(False)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= REL_TOL * scale


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def deoldify_pair():
    return _carry(jdo.DeOldifyWide(encoder="nano", nf_factor=1),
                  tdo.DeOldifyWide(encoder="nano", nf_factor=1), 64, 0)


@pytest.fixture(scope="module")
def ddcolor_pair():
    return _carry(jdd.DDColor.from_config("micro"), tdd.DDColor.from_config("micro"), 64, 1)


def test_resnet_body_stages():
    params, tm = _carry(jresnet.ResNetBody.from_config("nano"),
                        tresnet.ResNetBody.from_config("nano"), 64, 2)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jresnet.ResNetBody.from_config("nano").apply(params, x)
    got = tm(_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_deoldify_forward(deoldify_pair):
    params, tm = deoldify_pair
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jdo.DeOldifyWide(encoder="nano", nf_factor=1).apply)(params, x)
    _close(_nhwc(tm(_nchw(x))), want)


def test_deoldify_colorize(deoldify_pair):
    params, tm = deoldify_pair
    jm = jdo.DeOldifyWide(encoder="nano", nf_factor=1)
    rgb = np.random.default_rng(2).random((2, 48, 64, 3), dtype=np.float32)
    want = jax.jit(lambda p, x: jdo.colorize(p, x, jm, render_factor=4))(params, rgb)
    _close(tdo.colorize(tm, torch.from_numpy(rgb), render_factor=4), want)


def test_ddcolor_forward(ddcolor_pair):
    params, tm = ddcolor_pair
    x = np.random.default_rng(3).random((2, 64, 64, 3), dtype=np.float32)
    want = jax.jit(jdd.DDColor.from_config("micro").apply)(params, x)
    _close(_nhwc(tm(_nchw(x))), want)


def test_ddcolor_colorize(ddcolor_pair):
    params, tm = ddcolor_pair
    jm = jdd.DDColor.from_config("micro")
    rgb = np.random.default_rng(4).random((2, 48, 64, 3), dtype=np.float32)
    want = jax.jit(lambda p, x: jdd.colorize(p, x, jm, input_size=64))(params, rgb)
    _close(tdd.colorize(tm, torch.from_numpy(rgb), input_size=64), want)


def test_sine_position_embedding():
    want = jdd.sine_position_embedding(6, 10, 32)
    _close(tdd.sine_position_embedding(6, 10, 32), want)


@pytest.mark.parametrize("name", ["video", "artistic"])
def test_full_width_key_and_shape_coverage(name):
    if name == "video":
        jm, build = jdo.make_model("video"), lambda: tdo.make_model("video")
    else:
        jm, build = jdd.DDColor.from_config("artistic"), lambda: tdd.DDColor.from_config("artistic")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = {torch_key(p): torch_shape(p, leaf.shape)
            for p, leaf in flatten_tree(shapes["params"])}
    with torch.device("meta"):
        tm = build()
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert sorted(set(want) - set(got)) == []  # no missing key
    assert sorted(set(got) - set(want)) == []  # no unexpected key
    assert got == want
    n_params = sum(int(np.prod(s)) for s in want.values())
    assert n_params > 2e8  # full width: 218 M (Video), 228 M (Artistic)


def test_registry_loads_the_jax_registry_npz(ddcolor_pair, tmp_path, monkeypatch):
    """A converted DDColor npz (params plus its ``__config__`` geometry, as
    havc_tpu's converter writes it) loads into both registries alike."""
    import json

    import havc_tpu.engines as jengines
    from havc_tpu.models.convert import save_params_npz

    import havc_tpu_torch.engines as tengines

    params, _ = ddcolor_pair
    cfg = dict(jdd.DDCOLOR_CONFIGS["micro"], unet_out=list(jdd.DDCOLOR_CONFIGS["micro"]["unet_out"]))
    blob = np.frombuffer(json.dumps(cfg).encode(), dtype=np.uint8).copy()
    save_params_npz({"params": params["params"], "__config__": {"json": blob}},
                    str(tmp_path / "ddcolor_artistic.npz"))
    monkeypatch.setattr(jengines, "registry", jengines.EngineRegistry(weights_dir=str(tmp_path)))
    monkeypatch.setattr(tengines, "registry", tengines.EngineRegistry(weights_dir=str(tmp_path)))
    jm, jp = jengines.registry.ddcolor("artistic")
    tm = tengines.registry.ddcolor("artistic", device="cpu")
    assert not tengines.registry.random_init_used
    x = np.random.default_rng(5).random((1, 64, 64, 3), dtype=np.float32)
    _close(_nhwc(tm(_nchw(x))), jax.jit(jm.apply)(jp, x))
