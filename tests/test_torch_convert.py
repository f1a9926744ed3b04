"""The port's checkpoint conversion against the JAX package's.

Both packages turn the reference's PyTorch checkpoints into the engine
registry's ``.npz`` files; one converted directory must serve both.  The
published checkpoints are not in the repository, so every checkpoint here
is built by the test with the reference's own key names (from the key
maps) and small seeded arrays of the right rank, then ``torch.save``d
under the reference's file name:

* every family of ``CONVERT_ALL_PLAN`` (DeOldify Video/Stable/Artistic
  with spectral- and weight-normed convs in fastai's ``model`` wrapper,
  both Zhang nets, two DDColor variants in the ``params`` wrapper with
  their geometry to detect, the three Deep-Exemplar files, ColorMNet with
  its 4-channel value-encoder stem and a training-only key, DeepRemaster
  under ``modelC``) converted by both packages' ``convert_all``: the same
  report, the same files, the same keys and bit-identical arrays, the
  DDColor ``__config__/json`` blob included; ``--strict`` and the missing
  report, and the port's command line;
* ``fold_spectral_norm`` against ``torch.nn.utils.spectral_norm`` in eval
  mode and ``fold_weight_norm`` against ``torch.nn.utils.weight_norm``
  (float32 rounding of the float64 fold: 1e-6);
* ``ddcolor_config_from_state_dict`` on the tiny and large layouts, the
  same in both packages;
* a micro DDColor and narrow Zhang nets converted from reference-layout
  checkpoints, loaded through both packages' ``set_weights_dir``: the same
  outputs within 1e-4 (the model tolerance of the other port tests).
"""
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import havc_tpu.engines as jengines
from havc_tpu.models import convert as jconv
from havc_tpu.models import ddcolor as jdd
from havc_tpu.models import zhang as jzh

import havc_tpu_torch.engines as tengines
from havc_tpu_torch.models import convert as tconv
from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import zhang as tzh
from havc_tpu_torch.models.convnext import CONVNEXT_CONFIGS

from test_torch_classic_models import ZHANG_WIDTH, narrow_jax_zhang
from test_torch_exemplar_surface import seeded_params
from test_torch_streaming import _few_torch_threads  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4

# small shapes of the right rank per (rule kind, torch suffix); 1-D (4,)
# for every other parameter
SHAPES = {
    ("conv", "weight"): (4, 3, 3, 3), ("convt", "weight"): (3, 4, 2, 2),
    ("conv3d", "weight"): (4, 3, 1, 3, 3), ("conv1d_2d", "weight"): (4, 3, 1),
    ("linear", "weight"): (4, 3),
    ("mha_q", "in_proj_weight"): (12, 4), ("mha_q", "in_proj_bias"): (12,),
    ("mha_k", "in_proj_weight"): (12, 4), ("mha_k", "in_proj_bias"): (12,),
    ("mha_v", "in_proj_weight"): (12, 4), ("mha_v", "in_proj_bias"): (12,),
    ("embed_query_feat", "weight"): (3, 4), ("embed_query_embed", "weight"): (3, 4),
    ("embed_level_embed", "weight"): (3, 4),
    ("vit_tokens", "cls_token"): (1, 1, 4), ("vit_tokens", "pos_embed"): (1, 5, 4),
    ("temp", "temperature"): (2, 1, 1),
}


def synth(key_map, seed, shapes=None):
    """A reference-layout state dict with every tensor the key map reads."""
    rng = np.random.default_rng(seed)
    sd = {}
    for prefix, spec in key_map.items():
        for _, kind in spec if isinstance(spec, list) else [spec]:
            for suffix in tconv._KIND_RULES[kind]:
                key = f"{prefix}.{suffix}"
                shape = (shapes or {}).get(key) or SHAPES.get((kind, suffix), (4,))
                sd.setdefault(key, rng.uniform(0.5, 1.5, shape).astype(np.float32))
    return sd


def spectral(sd, prefixes, seed):
    """Store ``<p>.weight`` as torch's spectral_norm does: weight_orig and
    the power-iteration vectors u, v (v seeded, u = W v normalised, so
    sigma = u W v > 0)."""
    rng = np.random.default_rng(seed)
    for p in prefixes:
        w = sd.pop(f"{p}.weight")
        v = rng.standard_normal(w[0].size)
        v /= np.linalg.norm(v)
        u = w.reshape(w.shape[0], -1) @ v
        sd[f"{p}.weight_orig"] = w
        sd[f"{p}.weight_u"] = (u / np.linalg.norm(u)).astype(np.float32)
        sd[f"{p}.weight_v"] = v.astype(np.float32)
    return sd


def weight_normed(sd, prefix, seed):
    w = sd.pop(f"{prefix}.weight")
    sd[f"{prefix}.weight_v"] = w
    sd[f"{prefix}.weight_g"] = np.random.default_rng(seed).uniform(
        0.5, 1.5, (w.shape[0],) + (1,) * (w.ndim - 1)).astype(np.float32)
    return sd


def save(sd, path, wrapper=None):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({wrapper: t, "epoch": 1} if wrapper else t, path)


def deoldify_sd(key_map, seed):
    """fastai's DeOldify layout: every conv outside the ResNet body
    spectral-normed (the attention's conv1d included), the final pixel
    shuffle weight-normed."""
    sd = synth(key_map, seed)
    convs = [p for p, (_, kind) in key_map.items()
             if kind in ("conv", "conv1d_2d") and not p.startswith("layers.0.")
             and p != "layers.8.conv.0"]
    return weight_normed(spectral(sd, convs, seed + 1), "layers.8.conv.0", seed + 2)


def ddcolor_sd(encoder, num_blocks, extra_bn, seed, published=False):
    """Upstream DDColor's layout at the ConvNeXt ``encoder``'s depths and
    widths (what the config detection reads; ``published``: the released
    query count, width and FFN too), the decoder convs spectral-normed and
    the last pixel shuffle weight-normed."""
    cfg = CONVNEXT_CONFIGS[encoder]
    key_map = tconv.ddcolor_key_map(depths=cfg["depths"], num_blocks=num_blocks,
                                    extra_bn=extra_bn)
    shapes = {f"encoder.arch.stages.{s}.{b}.dwconv.weight": (cfg["dims"][s], 1, 1, 1)
              for s, d in enumerate(cfg["depths"]) for b in range(d)}
    if published:
        shapes.update({"decoder.color_decoder.query_feat.weight": (100, 256),
                       "decoder.color_decoder.transformer_ffn_layers.0.linear1.weight":
                           (2048, 256)})
    sd = synth(key_map, seed, shapes)
    convs = [p for p in key_map if p.startswith(("decoder.layers.", "refine_net."))
             and p.endswith(".0") and key_map[p][1] == "conv"]
    return weight_normed(spectral(sd, convs, seed + 1), "decoder.last_shuf.conv.0", seed + 2)


def write_reference_dir(d):
    """Every checkpoint file the reference downloads, synthesized."""
    os.makedirs(d, exist_ok=True)
    save(deoldify_sd(tconv.deoldify_wide_key_map(), 1), f"{d}/ColorizeVideo_gen.pth", "model")
    save(deoldify_sd(tconv.deoldify_wide_key_map(), 2), f"{d}/ColorizeStable_gen.pth", "model")
    save(deoldify_sd(tconv.deoldify_deep_key_map(), 3), f"{d}/ColorizeArtistic_gen.pth",
         "model")
    save(synth(tconv.eccv16_key_map(), 4), f"{d}/colorization_release_v2-9b330a0b.pth")
    save(synth(tconv.siggraph17_key_map(), 5), f"{d}/siggraph17-df00044c.pth", "state_dict")
    save(ddcolor_sd("micro", 2, True, 6), f"{d}/ddcolor_modelscope.pth", "params")
    save(ddcolor_sd("micro", 3, False, 7), f"{d}/ddcolor_artistic.pth", "params_ema")
    save(synth(tconv.deepex_vgg19_key_map(), 8), f"{d}/vgg19_conv.pth")
    save(synth(tconv.deepex_warpnet_key_map(), 9), f"{d}/nonlocal_net_iter_76000.pth")
    save(synth(tconv.deepex_colorvid_key_map(), 10), f"{d}/colornet_iter_76000.pth")
    cm = synth(tconv.colormnet_key_map(), 11,
               {"value_encoder.conv1.weight": (64, 4, 7, 7)})  # the single-object stem
    cm["key_encoder.network2.backbone.mask_token"] = np.zeros((1, 4), np.float32)
    save(cm, f"{d}/DINOv2FeatureV6_LocalAtten_s2_154000.pth")
    save(synth(tconv.remaster_key_map(), 12), f"{d}/remasternet.pth.tar", "modelC")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    write_reference_dir(f"{root}/src")
    want = jconv.convert_all(f"{root}/src", f"{root}/jax")
    got = tconv.convert_all(f"{root}/src", f"{root}/port")
    return root, want, got


def test_convert_all_reports_agree(converted):
    _, want, got = converted
    assert got == want
    assert set(got.values()) == {"converted"} and len(got) == len(tconv.CONVERT_ALL_PLAN)


@pytest.mark.parametrize("name", [p[1] for p in jconv.CONVERT_ALL_PLAN])
def test_converted_npz_bit_identical(converted, name):
    root, _, _ = converted
    with np.load(f"{root}/jax/{name}") as a, np.load(f"{root}/port/{name}") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 0
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        if name.startswith("ddcolor"):
            cfg = json.loads(bytes(b["__config__/json"]).decode())
            assert cfg["encoder"] == "micro"
            assert cfg == tconv.npz_config(tengines.load_npz_params(f"{root}/port/{name}"))


def test_converted_colormnet_pads_the_stem(converted):
    root, _, _ = converted
    with np.load(f"{root}/port/colormnet.npz") as f:
        w = f["params/value_encoder/ResNetBody_0/conv1/Conv_0/kernel"]
        assert w.shape == (7, 7, 5, 64) and not w[:, :, 4].any()
        assert not any("mask_token" in k for k in f.files)


def test_convert_all_strict_and_missing(converted, tmp_path):
    root, _, _ = converted
    want = jconv.convert_all(str(tmp_path / "empty"), str(tmp_path / "j"))
    got = tconv.convert_all(str(tmp_path / "empty"), str(tmp_path / "t"))
    assert got == want and all(v.startswith("missing: ") for v in got.values())
    assert got["deepex.npz"] == "missing: vgg19_conv.pth"
    for conv in (jconv, tconv):
        with pytest.raises(FileNotFoundError, match="no ColorizeVideo_gen.pth"):
            conv.convert_all(str(tmp_path / "empty"), str(tmp_path / "s"), strict=True)


def test_command_line(converted, tmp_path):
    root, _, _ = converted
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "havc_tpu_torch.models.convert"]
    ok = subprocess.run(cmd + [f"{root}/src", str(tmp_path / "out"), "--strict"], env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.splitlines() == [f"{p[1]}: converted" for p in tconv.CONVERT_ALL_PLAN]
    bad = subprocess.run(cmd + [str(tmp_path / "none"), str(tmp_path / "o2"), "--strict"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "FileNotFoundError" in bad.stderr


# --- the folds --------------------------------------------------------------------------


@pytest.mark.parametrize("layer", ["conv", "linear"])
def test_fold_spectral_norm_matches_torch(layer):
    torch.manual_seed(0)
    m = torch.nn.Conv2d(6, 5, 3) if layer == "conv" else torch.nn.Linear(7, 4)
    m = torch.nn.utils.spectral_norm(m)
    x = torch.rand((2, 6, 8, 8)) if layer == "conv" else torch.rand((3, 7))
    for _ in range(3):  # training steps move u and v
        m(x)
    m.eval()
    with torch.no_grad():
        want = m(x)
        w_eval = m.weight.clone()
    sd = {f"m.{k}": v.numpy() for k, v in m.state_dict().items()}
    for conv in (jconv, tconv):
        folded = conv.fold_spectral_norm(sd)
        assert set(folded) == {"m.weight", "m.bias"} and folded["m.weight"].dtype == np.float32
        np.testing.assert_allclose(folded["m.weight"], w_eval.numpy(), rtol=1e-6, atol=1e-7)
    plain = (torch.nn.Conv2d(6, 5, 3) if layer == "conv" else torch.nn.Linear(7, 4))
    plain.load_state_dict({"weight": torch.from_numpy(tconv.fold_spectral_norm(sd)["m.weight"]),
                           "bias": m.bias.detach()})
    with torch.no_grad():
        assert (plain(x) - want).abs().max().item() <= 1e-6
    # without v the fold runs its own power iteration, in both packages alike
    no_v = {k: v for k, v in sd.items() if k != "m.weight_v"}
    assert np.array_equal(jconv.fold_spectral_norm(no_v)["m.weight"],
                          tconv.fold_spectral_norm(no_v)["m.weight"])


def test_fold_weight_norm_matches_torch():
    torch.manual_seed(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = torch.nn.utils.weight_norm(torch.nn.Conv2d(4, 6, 3))
    with torch.no_grad():
        m.weight_g.mul_(torch.rand_like(m.weight_g) + 0.5)
        m(torch.rand((1, 4, 5, 5)))
        w = m.weight.clone()
    sd = {f"m.{k}": v.detach().numpy() for k, v in m.state_dict().items()}
    for conv in (jconv, tconv):
        folded = conv.fold_weight_norm(sd)
        assert set(folded) == {"m.weight", "m.bias"} and folded["m.weight"].dtype == np.float32
        np.testing.assert_allclose(folded["m.weight"], w.numpy(), rtol=1e-6, atol=1e-7)
    assert np.array_equal(jconv.fold_weight_norm(sd)["m.weight"],
                          tconv.fold_weight_norm(sd)["m.weight"])


@pytest.mark.parametrize("encoder", ["tiny", "large"])
def test_ddcolor_config_from_state_dict(encoder):
    sd = ddcolor_sd(encoder, 9, encoder == "large", 20, published=True)
    want = jconv.ddcolor_config_from_state_dict(sd)
    got = tconv.ddcolor_config_from_state_dict(sd)
    assert got == want
    assert got["encoder"] == encoder and got["num_blocks"] == 9 and got["dim"] == 256
    assert got["num_queries"] == 100 and got["ffn_dim"] == 2048
    assert got["unet_extra_bn"] is (encoder == "large")


# --- converted checkpoints through both registries --------------------------------------


def flax_to_reference(params, key_map):
    """The reference-layout state dict of a flax tree (the converter's
    transforms inverted)."""
    inv = {"conv": lambda t: np.transpose(t, (3, 2, 0, 1)),
           "convt": lambda t: np.transpose(t, (3, 2, 0, 1)), "linear": np.transpose}
    sd, mha = {}, {}
    for prefix, spec in key_map.items():
        for path, kind in spec if isinstance(spec, list) else [spec]:
            node = params
            for p in path:
                node = node[p]
            if kind.startswith("mha_"):
                mha.setdefault(prefix, {})["qkv".index(kind[-1])] = (
                    np.transpose(np.asarray(node["kernel"])), np.asarray(node["bias"]))
                continue
            for suffix, (leaf, _) in tconv._KIND_RULES[kind].items():
                if leaf in node:
                    v = np.asarray(node[leaf])
                    sd[f"{prefix}.{suffix}"] = inv[kind](v) if leaf == "kernel" else v
    for prefix, parts in mha.items():
        sd[f"{prefix}.in_proj_weight"] = np.concatenate([parts[i][0] for i in range(3)])
        sd[f"{prefix}.in_proj_bias"] = np.concatenate([parts[i][1] for i in range(3)])
    return sd


@pytest.fixture
def both_registries(tmp_path, monkeypatch):
    """Both packages' registries pointed at ``tmp_path/out`` (and back)."""
    monkeypatch.setattr(jengines, "registry", jengines.EngineRegistry())
    monkeypatch.setattr(tengines, "registry", tengines.EngineRegistry())
    yield tmp_path
    jengines.set_weights_dir(None)
    tengines.set_weights_dir(None)


def test_micro_ddcolor_converted_loads_in_both(both_registries):
    d = both_registries
    model = jdd.DDColor.from_config("micro")
    tree = seeded_params(model, 30, jnp.zeros((1, 64, 64, 3)))
    key_map = tconv.ddcolor_key_map(depths=CONVNEXT_CONFIGS["micro"]["depths"], num_blocks=3,
                                    extra_bn=True)
    sd = flax_to_reference(tree, key_map)
    convs = [p for p in key_map if p.startswith("decoder.layers.") and p.endswith("conv.0")]
    os.makedirs(d / "src")
    save(weight_normed(spectral(sd, convs, 31), "decoder.last_shuf.conv.0", 32),
         str(d / "src" / "ddcolor_artistic.pth"), "params")
    assert tconv.convert_all(str(d / "src"), str(d / "out"))["ddcolor_artistic.npz"] == \
        "converted"
    jengines.set_weights_dir(str(d / "out"))
    tengines.set_weights_dir(str(d / "out"))
    x = np.random.default_rng(33).random((2, 48, 80, 3), dtype=np.float32)
    jm, jp = jengines.registry.ddcolor("artistic")
    want = np.asarray(jax.jit(lambda p, f: jdd.colorize(p, f, jm, input_size=64))(
        jp, jnp.asarray(x)))
    net = tengines.registry.ddcolor("artistic", "cpu")
    assert not tengines.registry.random_init_used
    with torch.inference_mode():
        got = tdd.colorize(net, torch.from_numpy(x), input_size=64).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("name", ["eccv16", "siggraph17"])
def test_narrow_zhang_converted_loads_in_both(both_registries, monkeypatch, name):
    d = both_registries
    src = "colorization_release_v2-9b330a0b.pth" if name == "eccv16" else \
        "siggraph17-df00044c.pth"
    key_map = tconv.eccv16_key_map() if name == "eccv16" else tconv.siggraph17_key_map()
    x = np.random.default_rng(34).random((2, 40, 56, 3), dtype=np.float32)
    with narrow_jax_zhang():
        jm = jzh.ECCV16() if name == "eccv16" else jzh.Siggraph17()
        tree = seeded_params(jm, 35, jnp.zeros((1, 32, 32, 1)))
        os.makedirs(d / "src")
        save(flax_to_reference(tree, key_map), str(d / "src" / src))
        report = tconv.convert_all(str(d / "src"), str(d / "out"))
        assert report[f"zhang_{name}.npz"] == "converted"
        jengines.set_weights_dir(str(d / "out"))
        want = np.asarray(jengines.zhang_frames(jnp.asarray(x), name, 64))
    for cls in ("ECCV16", "Siggraph17"):  # the port's registry builds them narrow
        monkeypatch.setattr(tzh, cls, lambda c=getattr(tzh, cls): c(ZHANG_WIDTH))
    tengines.set_weights_dir(str(d / "out"))
    with torch.inference_mode():
        got = tengines.zhang_frames(torch.from_numpy(x), name, 64, device="cpu").numpy()
    assert not tengines.registry.random_init_used
    assert np.abs(got - want).max() <= TOL
