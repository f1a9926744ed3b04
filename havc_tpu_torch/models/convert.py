"""Reference PyTorch checkpoints -> the engine registry's ``.npz`` files.

Port of ``havc_tpu.models.convert`` (numpy only, the same functions,
arithmetic and output): the five model families ship as PyTorch
``state_dict`` checkpoints, and this module turns them into the
``{'a/b/c': array}`` ``.npz`` layout that both packages' engine registries
load (``havc_tpu_torch.engines.set_weights_dir`` here,
``havc_tpu.engines.set_weights_dir`` in the JAX package): one converted
directory serves both.  The layout is the JAX package's flax parameter
tree, which ``models/bridge.py`` maps onto this package's modules.

Conversion rules:

* ``Conv2d.weight``          (O,I,kH,kW)  -> kernel (kH,kW,I,O)
* ``ConvTranspose2d.weight`` (I,O,kH,kW)  -> kernel (kH,kW,O,I)
* ``Linear.weight``          (O,I)        -> kernel (I,O)
* ``BatchNorm2d``  weight/bias/running_mean/running_var ->
  scale/bias/mean/var

Spectral and weight norms are folded into plain weights first
(``fold_spectral_norm``, ``fold_weight_norm``); DDColor's geometry is read
from its checkpoint (``ddcolor_config_from_state_dict``) and stored beside
the weights as a ``__config__/json`` blob.  Checkpoints are loaded with
``torch.load(map_location='cpu')``; a pre-extracted ``{key: np.ndarray}``
dict works as well.

    python -m havc_tpu_torch.models.convert <src_dir> <out_dir> [--strict]
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "load_state_dict",
    "convert_params",
    "eccv16_key_map",
    "siggraph17_key_map",
]

# kind -> {torch suffix -> (flax leaf name, transform)}
_KIND_RULES = {
    "conv": {
        "weight": ("kernel", lambda t: np.transpose(t, (2, 3, 1, 0))),
        "bias": ("bias", lambda t: t),
    },
    "convt": {
        "weight": ("kernel", lambda t: np.transpose(t, (2, 3, 1, 0))),
        "bias": ("bias", lambda t: t),
    },
    "linear": {
        "weight": ("kernel", lambda t: np.transpose(t)),
        "bias": ("bias", lambda t: t),
    },
    "bn": {
        "weight": ("scale", lambda t: t),
        "bias": ("bias", lambda t: t),
        "running_mean": ("mean", lambda t: t),
        "running_var": ("var", lambda t: t),
    },
}


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint into plain numpy arrays."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("state_dict", "params_ema", "params", "model"):
        if isinstance(sd, dict) and wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
            break
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}


def _set_path(tree: dict, path: Tuple[str, ...], leaf: str, value: np.ndarray):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = value


def convert_params(
    state_dict: Mapping[str, np.ndarray],
    key_map: Mapping[str, Tuple[Tuple[str, ...], str]],
    strict: bool = True,
) -> dict:
    """Build a ``{'params': ...}`` parameter tree from a torch state_dict.

    ``key_map``: {torch module prefix -> (parameter path, kind)}.
    Unmapped torch keys are ignored (training-only branches); with
    ``strict`` every mapped prefix must find its tensors.
    """
    params: dict = {}
    for prefix, spec in key_map.items():
        specs = spec if isinstance(spec, list) else [spec]
        for path, kind in specs:
            rules = _KIND_RULES[kind]
            found = False
            for suffix, (leaf, tf) in rules.items():
                tk = f"{prefix}.{suffix}"
                if tk in state_dict:
                    _set_path(params, path, leaf, np.asarray(tf(state_dict[tk])))
                    found = True
                elif strict and suffix in ("weight",):
                    raise KeyError(f"torch key not found: {tk}")
            if strict and not found:
                raise KeyError(f"no tensors found for prefix: {prefix}")
    return {"params": params}


# --- Zhang eccv16 / siggraph17 checkpoint layouts ---------------------------


def _conv_path(block: str, i: int) -> Tuple[str, ...]:
    return (block, f"conv{i}", "Conv_0")


def eccv16_key_map() -> dict:
    """Key map for colorization_release_v2 (ECCVGenerator)."""
    m = {}
    blocks = {"model1": 2, "model2": 2, "model3": 3, "model4": 3,
              "model5": 3, "model6": 3, "model7": 3}
    for name, n in blocks.items():
        for i in range(n):
            m[f"{name}.{2 * i}"] = (_conv_path(name, i), "conv")
        m[f"{name}.{2 * n}"] = ((name, "norm"), "bn")
    m["model8.0"] = (("model8_up", "ConvTranspose_0"), "convt")
    m["model8.2"] = (("model8_conv1", "Conv_0"), "conv")
    m["model8.4"] = (("model8_conv2", "Conv_0"), "conv")
    m["model8.6"] = (("model8_class", "Conv_0"), "conv")
    m["model_out"] = (("model_out", "Conv_0"), "conv")
    return m


def siggraph17_key_map() -> dict:
    """Key map for siggraph17-df00044c (SIGGRAPHGenerator); the training-only
    classification branch (model_class) is left unmapped."""
    m = {}
    enc = {"model1": 2, "model2": 2, "model3": 3, "model4": 3,
           "model5": 3, "model6": 3, "model7": 3}
    for name, n in enc.items():
        for i in range(n):
            m[f"{name}.{2 * i}"] = (_conv_path(name, i), "conv")
        m[f"{name}.{2 * n}"] = ((name, "norm"), "bn")
    m["model8up.0"] = (("model8_up", "ConvTranspose_0"), "convt")
    m["model3short8.0"] = (("model3short8", "Conv_0"), "conv")
    m["model8.1"] = (("model8_conv1", "Conv_0"), "conv")
    m["model8.3"] = (("model8_conv2", "Conv_0"), "conv")
    m["model8.5"] = (("model8_norm",), "bn")
    m["model9up.0"] = (("model9_up", "ConvTranspose_0"), "convt")
    m["model2short9.0"] = (("model2short9", "Conv_0"), "conv")
    m["model9.1"] = (("model9_conv1", "Conv_0"), "conv")
    m["model9.3"] = (("model9_norm",), "bn")
    m["model10up.0"] = (("model10_up", "ConvTranspose_0"), "convt")
    m["model1short10.0"] = (("model1short10", "Conv_0"), "conv")
    m["model10.1"] = (("model10_conv1", "Conv_0"), "conv")
    m["model_out.0"] = (("model_out", "Conv_0"), "conv")
    return m


def save_params_npz(params: dict, path: str) -> None:
    """Flatten a parameter tree to the {'a/b/c': array} npz layout the
    engine registries load (engines.load_npz_params)."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    walk(params, "")
    np.savez(path, **flat)


def convert_checkpoint(
    checkpoint_path: str, key_map: Mapping, out_path: str, strict: bool = True
) -> dict:
    """One-call torch checkpoint -> engine-loadable npz."""
    sd = load_state_dict(checkpoint_path)
    params = convert_params(sd, key_map, strict=strict)
    save_params_npz(params, out_path)
    return params


# --- spectral-norm folding ---------------------------------------------------


def fold_spectral_norm(
    state_dict: Dict[str, np.ndarray], n_power_iterations: int = 0
) -> Dict[str, np.ndarray]:
    """Fold torch spectral_norm parametrizations into plain weights.

    DeOldify's convs are spectral-normalized (deoldify/layers.py:38 with
    NormType.Spectral); checkpoints store ``weight_orig`` + ``weight_u`` +
    ``weight_v``.  In EVAL mode torch computes ``sigma = u^T W v`` from the
    STORED vectors without further power iteration
    (torch.nn.utils.spectral_norm compute_weight, do_power_iteration=False)
    — replicated exactly so converted weights match torch inference
    bit-for-bit.  ``n_power_iterations > 0`` additionally refines u/v first
    (only useful when a checkpoint lacks ``weight_v``).
    """
    out = dict(state_dict)
    for key in list(state_dict.keys()):
        if not key.endswith(".weight_orig"):
            continue
        base = key[: -len(".weight_orig")]
        w = np.asarray(state_dict[key], np.float64)
        w_mat = w.reshape(w.shape[0], -1)
        u = np.asarray(
            state_dict.get(f"{base}.weight_u", np.ones(w.shape[0])), np.float64
        )
        v_stored = state_dict.get(f"{base}.weight_v")
        if v_stored is not None and n_power_iterations == 0:
            v = np.asarray(v_stored, np.float64)
        else:
            iters = max(n_power_iterations, 30)
            for _ in range(iters):
                v = w_mat.T @ u
                v /= np.linalg.norm(v) + 1e-12
                u = w_mat @ v
                u /= np.linalg.norm(u) + 1e-12
        sigma = float(u @ w_mat @ v)
        out[f"{base}.weight"] = (w / max(sigma, 1e-12)).astype(np.float32)
        out.pop(key)
        out.pop(f"{base}.weight_u", None)
        out.pop(f"{base}.weight_v", None)
    return out


# --- Deep-Exemplar checkpoint layouts (attribute names from the published
#     torch modules; see models/deepex.py) ----------------------------------


def deepex_vgg19_key_map() -> dict:
    """VGG19_pytorch (NonlocalNet.py:192-226): conv attributes are named
    directly (conv1_1 .. conv5_2 on our extraction path)."""
    names = [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2",
        "conv3_1", "conv3_2", "conv3_3", "conv3_4",
        "conv4_1", "conv4_2", "conv4_3", "conv4_4",
        "conv5_1", "conv5_2",
    ]
    return {n: ((n, "Conv_0"), "conv") for n in names}


def deepex_colorvid_key_map() -> dict:
    """ColorVidNet (ColorVidNet.py:6-146).  The constructor replaces the
    BatchNorms with parameter-free InstanceNorms and the deconvs with
    Upsample+Conv Sequentials (ColorVidNet.py:104-117) — so checkpoints
    carry NO norm tensors and the up-convs live at ``convN_1.1``."""
    m = {}
    # conv1_1 is a 2-conv Sequential
    m["conv1_1.0"] = (("conv1_1a", "Conv_0"), "conv")
    m["conv1_1.2"] = (("conv1_1b", "Conv_0"), "conv")
    convs = [
        "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
        "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3",
        "conv6_1", "conv6_2", "conv6_3", "conv7_1", "conv7_2", "conv7_3",
        "conv3_3_short", "conv8_2", "conv8_3", "conv2_2_short", "conv9_2",
        "conv1_2_short", "conv10_2", "conv10_ab",
    ]
    for n in convs:
        m[n] = ((n, "Conv_0"), "conv")
    for n in ["conv8_1", "conv9_1", "conv10_1"]:
        m[f"{n}.1"] = ((n, "conv", "Conv_0"), "conv")
    for n in ["conv1_2norm_ss", "conv2_2norm_ss", "conv3_3norm_ss"]:
        m[n] = ((n, "Conv_0"), "conv")
    return m


def deepex_warpnet_key_map() -> dict:
    """WarpNet (NonlocalNet.py:355-520).  torch Sequentials layerN_1 hold
    [pad, conv, IN, PReLU, pad, conv, IN, PReLU(, Upsample)] — convs at
    indices 1/5 (layer5_1: 1/6 due to the mid Upsample), PReLU weights at
    3/7.  InstanceNorms are parameter-free."""
    m = {}
    pairs = {  # torch name -> (first half flax name, second half flax name)
        "layer2_1": ("l2a", "l2b", 1, 5, 3, 7),
        "layer3_1": ("l3a", "l3b", 1, 5, 3, 7),
        "layer4_1": ("l4a", "l4b", 1, 5, 3, 7),
        "layer5_1": ("l5a", "l5b", 1, 6, 3, 8),
    }
    for tname, (fa, fb, c1, c2, p1, p2) in pairs.items():
        m[f"{tname}.{c1}"] = ((fa, "conv", "Conv_0"), "conv")
        m[f"{tname}.{c2}"] = ((fb, "conv", "Conv_0"), "conv")
        m[f"{tname}.{p1}"] = ((fa,), "prelu")
        m[f"{tname}.{p2}"] = ((fb,), "prelu")
    for i, res in enumerate(("res1", "res2", "res3")):
        m[f"layer.{i}.conv1"] = ((res, "conv1", "Conv_0"), "conv")
        m[f"layer.{i}.conv2"] = ((res, "conv2", "Conv_0"), "conv")
        m[f"layer.{i}.prelu"] = ((res,), "prelu")
    m["theta"] = (("theta", "Conv_0"), "conv")
    m["phi"] = (("phi", "Conv_0"), "conv")
    return m


# torch nn.PReLU stores its slope as "<prefix>.weight"
_KIND_RULES["prelu"] = {"weight": ("prelu", lambda t: t)}


# extra rule kind for BatchNorm2d(affine=False)
_KIND_RULES["bn_noaffine"] = {
    "running_mean": ("mean", lambda t: t),
    "running_var": ("var", lambda t: t),
}


def remaster_key_map() -> dict:
    """DeepRemaster NetworkC (remasternet.py:103-161): Sequential indices
    map onto our named TempConv blocks (models/remaster.py)."""
    m = {}

    def temp(prefix, path):
        m[f"{prefix}.conv3d"] = (path + ("conv",), "conv3d")
        m[f"{prefix}.bn"] = (path + (), "bn3d")

    # down1: index 0 is ReplicationPad3d; TempConvs at 1..9 -> b0..b8
    for i in range(9):
        temp(f"down1.{i + 1}", ("down1", f"b{i}"))
    temp("flat.0", ("flat0",))
    temp("flat.1", ("flat1",))
    temp("down2.0", ("down2_0",))
    temp("down2.1", ("down2_1",))
    for name in ("stattn1", "stattn2", "selfattn1", "selfattn2"):
        for leaf in ("query", "key", "value"):
            m[f"{name}.{leaf}_conv"] = ((name, leaf), "conv3d")
        m[name] = ((name,), "gamma_bare")
    temp("conv1", ("conv1",))
    temp("up1.conv3d", ("up1",))
    temp("conv2", ("conv2",))
    temp("up2.0", ("up2_0", "conv"))
    temp("up2.1", ("up2_1",))
    temp("up3.0", ("up3_0", "conv"))
    temp("up3.1", ("up3_1",))
    temp("up4.0", ("up4_0",))
    m["up4.1"] = (("up4_out",), "conv3d")
    for i in range(9):
        temp(f"reffeatnet1.{i}", ("reffeatnet1", f"b{i}"))
    temp("reffeatnet2.0", ("ref2_0",))
    temp("reffeatnet2.1", ("ref2_1",))
    temp("reffeatnet2.2", ("ref2_2",))
    return m


# bare nn.Parameter gamma (SourceReferenceAttention, remasternet.py:51)
_KIND_RULES["gamma_bare"] = {"gamma": ("gamma", lambda t: t)}
# conv3d: torch (O, I, kT, kH, kW) -> flax (kT, kH, kW, I, O)
_KIND_RULES["conv3d"] = {
    "weight": ("kernel", lambda t: np.transpose(t, (2, 3, 4, 1, 0))),
    "bias": ("bias", lambda t: t),
}
# TempConv BatchNorm3d -> bn_scale/bn_bias/bn_mean/bn_var params
_KIND_RULES["bn3d"] = {
    "weight": ("bn_scale", lambda t: t),
    "bias": ("bn_bias", lambda t: t),
    "running_mean": ("bn_mean", lambda t: t),
    "running_var": ("bn_var", lambda t: t),
}

__all__ += [
    "fold_spectral_norm",
    "deepex_vgg19_key_map",
    "deepex_colorvid_key_map",
    "deepex_warpnet_key_map",
    "remaster_key_map",
    "save_params_npz",
    "convert_checkpoint",
]


# --- DeOldify (fastai DynamicUnetWide/Deep) checkpoint layout ---------------
#
# fastai saves learn.model.state_dict() where the model is
# SequentialEx([encoder, bn, relu, middle_conv, unet_block x4,
#               PixelShuffle_ICNR, MergeLayer, res_block, final_conv,
#               SigmoidRange]) (deoldify/unet.py:208-281).  Run
# ``fold_spectral_norm`` on the state_dict FIRST (all convs are
# spectral-normalized).  Layout derived from the module structure; pin
# against a real checkpoint before trusting bit-level parity.


def _resnet_body_map(
    prefix: str, flax_root: str, layers: Sequence[int],
    block_type: str = "bottleneck",
) -> dict:
    """torchvision resnet body wrapped by fastai create_body: children
    Sequential indices 0..7 = conv1, bn1, relu, maxpool, layer1..4."""
    m = {
        f"{prefix}.0": ((flax_root, "conv1", "Conv_0"), "conv"),
        f"{prefix}.1": ((flax_root, "bn1"), "bn"),
    }
    convs = ("conv1", "conv2", "conv3") if block_type == "bottleneck" else (
        "conv1", "conv2")
    bns = ("bn1", "bn2", "bn3") if block_type == "bottleneck" else (
        "bn1", "bn2")
    for stage, n_blocks in enumerate(layers):
        seq_idx = 4 + stage
        for b in range(n_blocks):
            base = f"{prefix}.{seq_idx}.{b}"
            root = (flax_root, f"layer{stage + 1}_block{b}")
            for c in convs:
                m[f"{base}.{c}"] = (root + (c, "Conv_0"), "conv")
            for bn in bns:
                m[f"{base}.{bn}"] = (root + (bn,), "bn")
            if b == 0 and (stage > 0 or block_type == "bottleneck"):
                m[f"{base}.downsample.0"] = (
                    root + ("down_conv", "Conv_0"), "conv")
                m[f"{base}.downsample.1"] = (root + ("down_bn",), "bn")
    return m


def _custom_conv_map(
    prefix: str, path: Tuple[str, ...], use_activ: bool = True,
    use_bn: bool = True, self_attention: bool = False,
) -> dict:
    """custom_conv_layer (deoldify/layers.py:8-46): Sequential(conv,
    [relu if use_activ], [bn if extra_bn], [SelfAttention]).  Validated
    layout (from instantiating the reference DynamicUnetWide): conv=0,
    bn at 2 (use_activ) or 1, attention at 3."""
    m = {f"{prefix}.0": (path + ("conv", "Conv_0"), "conv")}
    if use_bn:
        bn_idx = 2 if use_activ else 1
        m[f"{prefix}.{bn_idx}"] = (path + ("bn",), "bn")
    if self_attention:
        base = f"{prefix}.3"
        # fastai SelfAttention (layers.py:81-96): spectral-normed conv1d
        m[f"{base}.query"] = (path + ("attn", "query", "Conv_0"), "conv1d_2d")
        m[f"{base}.key"] = (path + ("attn", "key", "Conv_0"), "conv1d_2d")
        m[f"{base}.value"] = (path + ("attn", "value", "Conv_0"), "conv1d_2d")
        # gamma is a bare Parameter
        m[f"{base}"] = (path + ("attn",), "gamma")
    return m


_KIND_RULES["gamma"] = {"gamma": ("gamma", lambda t: t)}
# torch Conv1d (O, I, 1) -> flax 2D 1x1 conv kernel (1, 1, I, O)
_KIND_RULES["conv1d_2d"] = {
    "weight": ("kernel", lambda t: np.transpose(t, (2, 1, 0))[None]),
    "bias": ("bias", lambda t: t),
}


def deoldify_wide_key_map(layers=(3, 4, 23, 3), n_blocks: int = 4,
                          block_type: str = "bottleneck") -> dict:
    """Map for ColorizeVideo/Stable_gen (DynamicUnetWide over resnet101) —
    validated against the reference module's state_dict layout
    (tests/test_ref_parity_deoldify.py).  Run ``fold_spectral_norm`` +
    ``fold_weight_norm`` on the state_dict FIRST.
    """
    m = _resnet_body_map("layers.0", "ResNetBody_0", layers, block_type)
    m["layers.1"] = (("pre_bn",), "bn")
    # middle_conv: Sequential of 2 custom_conv_layers (with activ+bn)
    for i in range(2):
        m.update(_custom_conv_map(f"layers.3.{i}", (f"mid_conv{i + 1}",)))
    # unet blocks at indices 4..: shuf.conv (use_activ=False), bn, conv
    for i in range(n_blocks):
        base = f"layers.{4 + i}"
        path = (f"up{i}",)
        m.update(_custom_conv_map(
            f"{base}.shuf.conv", path + ("shuf", "conv"), use_activ=False))
        m[f"{base}.bn"] = (path + ("bn",), "bn")
        sa = i == n_blocks - 3
        m.update(_custom_conv_map(
            f"{base}.conv", path + ("conv",), self_attention=sa))
    # final pixel shuffle (index 8): fastai PixelShuffle_ICNR — weight-norm
    # conv with bias, NO bn (layers.py:204-220)
    m.update(_custom_conv_map(
        "layers.8.conv", ("final_shuf", "conv"), use_activ=False,
        use_bn=False))
    # last_cross res_block (index 10): fastai conv_layer x2 (spectral ->
    # bias, no bn)
    for i in range(2):
        m.update(_custom_conv_map(
            f"layers.10.layers.{i}", ("last_cross", f"conv{i + 1}"),
            use_bn=False))
    # final 1x1 conv (index 11)
    m["layers.11.0"] = (("head_conv", "Conv_0"), "conv")
    return m


def deoldify_deep_key_map(layers=(3, 4, 6, 3), n_blocks: int = 4) -> dict:
    """ColorizeArtistic_gen (DynamicUnetDeep over resnet34): UnetBlockDeep
    has conv1 + conv2 (unet.py:55-92) instead of the single Wide conv."""
    m = _resnet_body_map("layers.0", "ResNetBody_0", layers, "basic")
    m["layers.1"] = (("pre_bn",), "bn")
    for i in range(2):
        m.update(_custom_conv_map(f"layers.3.{i}", (f"mid_conv{i + 1}",)))
    for i in range(n_blocks):
        base = f"layers.{4 + i}"
        path = (f"up{i}",)
        m.update(_custom_conv_map(
            f"{base}.shuf.conv", path + ("shuf", "conv"), use_activ=False))
        m[f"{base}.bn"] = (path + ("bn",), "bn")
        sa = i == n_blocks - 3
        m.update(_custom_conv_map(f"{base}.conv1", path + ("conv1",)))
        m.update(_custom_conv_map(
            f"{base}.conv2", path + ("conv2",), self_attention=sa))
    m.update(_custom_conv_map(
        "layers.8.conv", ("final_shuf", "conv"), use_activ=False,
        use_bn=False))
    for i in range(2):
        m.update(_custom_conv_map(
            f"layers.10.layers.{i}", ("last_cross", f"conv{i + 1}"),
            use_bn=False))
    m["layers.11.0"] = (("head_conv", "Conv_0"), "conv")
    return m


def fold_weight_norm(state_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight_norm (weight_g, weight_v) into plain weights:
    W = g * v / ||v|| with the norm over all-but-the-first dims.  Used by
    the final PixelShuffle_ICNR conv (fastai layers.py:206 NormType.Weight).
    """
    out = dict(state_dict)
    for key in list(state_dict.keys()):
        if not key.endswith(".weight_g"):
            continue
        base = key[: -len(".weight_g")]
        g = np.asarray(state_dict[key], np.float64)
        v = np.asarray(state_dict[f"{base}.weight_v"], np.float64)
        norm = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(axis=1))
        shape = (-1,) + (1,) * (v.ndim - 1)
        out[f"{base}.weight"] = (
            v * (g.reshape(shape) / np.maximum(norm.reshape(shape), 1e-12))
        ).astype(np.float32)
        out.pop(key)
        out.pop(f"{base}.weight_v", None)
    return out


__all__ += ["deoldify_deep_key_map", "fold_weight_norm"]


__all__ += ["deoldify_wide_key_map"]


# --- ColorMNet checkpoint layout (DINOv2FeatureV6_LocalAtten_s2_154000.pth,
#     flat keys per network.py attribute tree; see network.py:161-225 for
#     the shape-sniffed load) ------------------------------------------------

# channel LayerNorm (resnet.py LayerNorm2d / nn.LayerNorm)
_KIND_RULES["ln"] = {
    "weight": ("scale", lambda t: t),
    "bias": ("bias", lambda t: t),
}
# bare tensors
_KIND_RULES["temp"] = {"temperature": ("temperature", lambda t: t)}
_KIND_RULES["ls1"] = {"gamma": ("ls1_gamma", lambda t: t)}
_KIND_RULES["ls2"] = {"gamma": ("ls2_gamma", lambda t: t)}
_KIND_RULES["vit_tokens"] = {
    "cls_token": ("cls_token", lambda t: t),
    "pos_embed": ("pos_embed", lambda t: t),
}
# DinoSegmentor's BN folded into flat module params (models/vit.py)
_KIND_RULES["bnflat"] = dict(_KIND_RULES["bn3d"])


def _resnet_named_map(
    prefix: str, flax_root: Tuple[str, ...], stage_names: Sequence[str],
    blocks: Sequence[int], block_type: str = "bottleneck",
) -> dict:
    """ColorMNet-style resnet trunks keep named stage attributes
    (modules.py:105-170: conv1, bn1, res2|layer1, layer2, layer3).
    Emits exactly the prefixes that exist so strict coverage checks hold."""
    m = {
        f"{prefix}.conv1": (flax_root + ("conv1", "Conv_0"), "conv"),
        f"{prefix}.bn1": (flax_root + ("bn1",), "bn"),
    }
    convs = ("conv1", "conv2", "conv3") if block_type == "bottleneck" else (
        "conv1", "conv2")
    bns = ("bn1", "bn2", "bn3") if block_type == "bottleneck" else (
        "bn1", "bn2")
    for stage_idx, (sname, n_blocks) in enumerate(zip(stage_names, blocks)):
        for b in range(n_blocks):
            base = f"{prefix}.{sname}.{b}"
            root = flax_root + (f"layer{stage_idx + 1}_block{b}",)
            for c in convs:
                m[f"{base}.{c}"] = (root + (c, "Conv_0"), "conv")
            for bn in bns:
                m[f"{base}.{bn}"] = (root + (bn,), "bn")
            # first block of a stage downsamples; basic-block stage 1 is
            # identity (stride 1, equal channels)
            if b == 0 and (stage_idx > 0 or block_type == "bottleneck"):
                m[f"{base}.downsample.0"] = (
                    root + ("down_conv", "Conv_0"), "conv")
                m[f"{base}.downsample.1"] = (root + ("down_bn",), "bn")
    return m


def _cbam_map(prefix: str, root: Tuple[str, ...]) -> dict:
    """CBAM (cbam.py): shared-MLP channel gate + 7x7 spatial gate."""
    return {
        f"{prefix}.ChannelGate.mlp.1": (root + ("mlp1",), "linear"),
        f"{prefix}.ChannelGate.mlp.3": (root + ("mlp2",), "linear"),
        f"{prefix}.SpatialGate.spatial.conv": (root + ("spatial",), "conv"),
    }


def _group_resblock_map(
    prefix: str, root: Tuple[str, ...], has_downsample: bool
) -> dict:
    """GroupResBlock (group_modules.py:38-57); downsample conv exists only
    when in_dim != out_dim."""
    m = {
        f"{prefix}.conv1": (root + ("conv1", "Conv_0"), "conv"),
        f"{prefix}.conv2": (root + ("conv2", "Conv_0"), "conv"),
    }
    if has_downsample:
        m[f"{prefix}.downsample"] = (root + ("downsample", "Conv_0"), "conv")
    return m


def _fusion_block_map(prefix: str, root: Tuple[str, ...]) -> dict:
    """FeatureFusionBlock (modules.py:22-41): block1 reduces x+g channels
    (downsample present), block2 is mid->out at equal dims (absent for all
    ColorMNet instantiations)."""
    m = {}
    m.update(_group_resblock_map(f"{prefix}.block1", root + ("block1",), True))
    m.update(_cbam_map(f"{prefix}.attention", root + ("attention",)))
    m.update(_group_resblock_map(f"{prefix}.block2", root + ("block2",), False))
    return m


def _fuse_map(prefix: str, root: Tuple[str, ...]) -> dict:
    """DINO<->ResNet Fuse block (resnet.py:370-399)."""
    m = {f"{prefix}.encode_enc": (root + ("encode_enc", "Conv_0"), "conv")}
    for ln in ("norm1", "norm2", "norm3"):
        m[f"{prefix}.{ln}"] = (root + (ln, "ln"), "ln")
    ca = root + ("crossattn",)
    m[f"{prefix}.crossattn"] = (ca, "temp")
    for n in ("to_q", "to_q_dw", "to_k", "to_k_dw", "to_v", "to_v_dw"):
        m[f"{prefix}.crossattn.{n}"] = (ca + (n,), "conv")
    m[f"{prefix}.crossattn.to_out.0"] = (ca + ("to_out",), "conv")
    return m


def dinov2_key_map(
    prefix: str = "key_encoder.network2.backbone",
    root: Tuple[str, ...] = ("key_encoder", "network2", "backbone"),
    depth: int = 12,
) -> dict:
    """DINOv2 ViT (facebookresearch/dinov2 vision_transformer.py layout:
    cls_token, pos_embed, patch_embed.proj, blocks.N.{norm1, attn.qkv,
    attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}, norm).
    ``mask_token`` is training-only — excluded."""
    m = {
        prefix: (root, "vit_tokens"),  # cls_token + pos_embed
        f"{prefix}.patch_embed.proj": (root + ("patch_embed",), "conv"),
        f"{prefix}.norm": (root + ("norm",), "ln"),
    }
    for i in range(depth):
        b = f"{prefix}.blocks.{i}"
        r = root + (f"block{i}",)
        m[f"{b}.norm1"] = (r + ("norm1",), "ln")
        m[f"{b}.attn.qkv"] = (r + ("attn", "qkv"), "linear")
        m[f"{b}.attn.proj"] = (r + ("attn", "proj"), "linear")
        m[f"{b}.ls1"] = (r, "ls1")
        m[f"{b}.norm2"] = (r + ("norm2",), "ln")
        m[f"{b}.mlp.fc1"] = (r + ("mlp_fc1",), "linear")
        m[f"{b}.mlp.fc2"] = (r + ("mlp_fc2",), "linear")
        m[f"{b}.ls2"] = (r, "ls2")
    return m


def colormnet_key_map(include_backbone: bool = True) -> dict:
    """Full map for the published ColorMNet checkpoint
    (network.py attribute tree).  ``load_weights`` calls a strict
    ``load_state_dict`` (network.py:225), so the checkpoint carries the
    DINOv2 backbone under ``key_encoder.network2.backbone.`` as well —
    mapped by default; hub construction (resnet.py:219) is only for the
    architecture."""
    m = {}
    # KeyEncoder_DINOv2_v6 (modules.py:158-195): resnet50 conv1..layer3,
    # stage attribute names conv1/bn1/res2/layer2/layer3
    m.update(_resnet_named_map(
        "key_encoder", ("key_encoder", "ResNetBody_0"),
        ("res2", "layer2", "layer3"), (3, 4, 6), "bottleneck",
    ))
    m["key_encoder.network2.conv3"] = (
        ("key_encoder", "network2", "conv3"), "conv")
    m["key_encoder.network2.bn3"] = (
        ("key_encoder", "network2"), "bnflat")
    for i in (1, 2, 3):
        m.update(_fuse_map(
            f"key_encoder.fuse{i}", ("key_encoder", f"fuse{i}")))
    if include_backbone:
        m.update(dinov2_key_map())

    # KeyProjection (modules.py:213-230)
    for n in ("key_proj", "d_proj", "e_proj"):
        m[f"key_proj.{n}"] = (("key_proj", n, "Conv_0"), "conv")

    # ValueEncoder (modules.py:105-156): resnet18 conv1..layer3 + fuser +
    # hidden_reinforce
    m.update(_resnet_named_map(
        "value_encoder", ("value_encoder", "ResNetBody_0"),
        ("layer1", "layer2", "layer3"), (2, 2, 2), "basic",
    ))
    m.update(_fusion_block_map(
        "value_encoder.fuser", ("value_encoder", "fuser")))
    m["value_encoder.hidden_reinforce.transform"] = (
        ("value_encoder", "hidden_reinforce", "transform", "Conv_0"), "conv")

    # short_term_attn (LocalGatedPropagation use_linear=False: only
    # relative_emb_k + dw_conv + projection exist, attention.py:742-775)
    m["short_term_attn.relative_emb_k"] = (
        ("short_term_attn", "relative_emb_k"), "conv")
    m["short_term_attn.dw_conv.conv"] = (
        ("short_term_attn", "dw_conv"), "conv")
    m["short_term_attn.projection"] = (
        ("short_term_attn", "projection"), "linear")

    # Decoder (modules.py:233-280)
    m.update(_fusion_block_map("decoder.fuser", ("decoder", "fuser")))
    m["decoder.hidden_update.g16_conv"] = (("decoder", "hu_g16", "Conv_0"), "conv")
    m["decoder.hidden_update.g8_conv"] = (("decoder", "hu_g8", "Conv_0"), "conv")
    m["decoder.hidden_update.g4_conv"] = (("decoder", "hu_g4", "Conv_0"), "conv")
    m["decoder.hidden_update.transform"] = (
        ("decoder", "hidden_update", "transform", "Conv_0"), "conv")
    for up, has_down in (("up_16_8", True), ("up_8_4", False)):
        m[f"decoder.{up}.skip_conv"] = (
            ("decoder", up, "skip_conv", "Conv_0"), "conv")
        m.update(_group_resblock_map(
            f"decoder.{up}.out_conv", ("decoder", up, "out_conv"), has_down))
    m["decoder.pred"] = (("decoder", "pred", "Conv_0"), "conv")
    return m


# keys that exist in checkpoints but are intentionally not converted
COLORMNET_EXCLUDED_KEYS = (
    "key_encoder.network2.backbone.mask_token",  # training-only
)


def convert_deepex_checkpoints(
    vgg19_path: str, nonlocal_path: str, colornet_path: str, out_path: str
) -> dict:
    """The three Deep-Exemplar .pth files (deepex/__init__.py:242-253:
    data/vgg19_conv.pth, nonlocal_net_iter_76000.pth,
    colornet_iter_76000.pth) -> one engine-loadable deepex.npz with groups
    vgg / warpnet / colorvid."""
    p_vgg = convert_params(load_state_dict(vgg19_path), deepex_vgg19_key_map(),
                           strict=False)
    p_warp = convert_params(load_state_dict(nonlocal_path),
                            deepex_warpnet_key_map())
    p_color = convert_params(load_state_dict(colornet_path),
                             deepex_colorvid_key_map())
    params = {"params": {
        "vgg": p_vgg["params"],
        "warpnet": p_warp["params"],
        "colorvid": p_color["params"],
    }}
    save_params_npz(params, out_path)
    return params


def convert_remaster_checkpoint(checkpoint_path: str, out_path: str) -> dict:
    """remasternet.pth.tar (remaster_render.py:112-120, key 'modelC') ->
    engine-loadable remaster.npz."""
    import torch

    blob = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    sd = blob.get("modelC", blob) if isinstance(blob, dict) else blob
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()
          if hasattr(v, "detach")}
    params = convert_params(sd, remaster_key_map())
    save_params_npz(params, out_path)
    return params


__all__ += ["convert_deepex_checkpoints", "convert_remaster_checkpoint"]


def convert_colormnet_checkpoint(
    checkpoint_path: str, out_path: str,
    dinov2_path: Optional[str] = None,
) -> dict:
    """DINOv2FeatureV6_LocalAtten_*.pth -> engine-loadable colormnet.npz.

    The published checkpoint carries the DINOv2 backbone inline
    (load_state_dict is strict, network.py:225); if a checkpoint without it
    is used, pass ``dinov2_path`` (dinov2_vits14_pretrain.pth) to merge it
    under key_encoder.network2.backbone first."""
    sd = dict(load_state_dict(checkpoint_path))
    # single->multi object conv pad (network.load_weights, network.py:210-222)
    k = "value_encoder.conv1.weight"
    if k in sd and sd[k].shape[1] == 4:
        sd[k] = np.concatenate(
            [sd[k], np.zeros((64, 1, 7, 7), sd[k].dtype)], axis=1
        )
    if dinov2_path is not None:
        for dk, dv in load_state_dict(dinov2_path).items():
            sd[f"key_encoder.network2.backbone.{dk}"] = dv
    has_backbone = any(
        key.startswith("key_encoder.network2.backbone.") for key in sd
    )
    params = convert_params(sd, colormnet_key_map(include_backbone=has_backbone))
    save_params_npz(params, out_path)
    return params


__all__ += ["colormnet_key_map", "dinov2_key_map", "COLORMNET_EXCLUDED_KEYS",
            "convert_colormnet_checkpoint"]


# --- DDColor checkpoint layout (upstream piddnad/DDColor
#     basicsr/archs/ddcolor_arch.py; consumed by the reference through the
#     vsddcolor wheel, vsslib/vsmodels.py:290-374) -------------------------

# torch nn.MultiheadAttention packs qkv into in_proj_weight (3d, d)
def _mha_slice(part):
    def w(t):
        d = t.shape[0] // 3
        return np.transpose(t[part * d:(part + 1) * d])

    def b(t):
        d = t.shape[0] // 3
        return t[part * d:(part + 1) * d]

    return {"in_proj_weight": ("kernel", w), "in_proj_bias": ("bias", b)}


_KIND_RULES["mha_q"] = _mha_slice(0)
_KIND_RULES["mha_k"] = _mha_slice(1)
_KIND_RULES["mha_v"] = _mha_slice(2)
_KIND_RULES["embed_query_feat"] = {"weight": ("query_feat", lambda t: t)}
_KIND_RULES["embed_query_embed"] = {"weight": ("query_embed", lambda t: t)}
_KIND_RULES["embed_level_embed"] = {"weight": ("level_embed", lambda t: t)}


def ddcolor_config_from_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """Infer DDColor geometry from a checkpoint (encoder depths/dims,
    decoder outputs, query count, block count, extra_bn) so conversion
    adapts to any released variant without hard-coding."""
    import re

    depths = [0, 0, 0, 0]
    dims = [0, 0, 0, 0]
    for k, v in sd.items():
        m = re.match(r"encoder\.arch\.stages\.(\d)\.(\d+)\.dwconv\.weight", k)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            depths[s] = max(depths[s], b + 1)
            dims[s] = v.shape[0]
    enc = None
    from .convnext import CONVNEXT_CONFIGS

    for name, c in CONVNEXT_CONFIGS.items():
        if tuple(c["depths"]) == tuple(depths) and tuple(c["dims"]) == tuple(dims):
            enc = name
            break
    n_blocks = 1 + max(
        int(re.match(
            r"decoder\.color_decoder\.transformer_ffn_layers\.(\d+)\.", k
        ).group(1))
        for k in sd
        if k.startswith("decoder.color_decoder.transformer_ffn_layers.")
    )
    unet_out = []
    for i in range(3):
        kk = f"decoder.layers.{i}.conv.0.weight"
        ko = f"decoder.layers.{i}.conv.0.weight_orig"
        w = sd.get(kk, sd.get(ko))
        unet_out.append(int(w.shape[0]))
    return dict(
        encoder=enc,
        dim=int(sd["decoder.color_decoder.query_feat.weight"].shape[1]),
        num_queries=int(sd["decoder.color_decoder.query_feat.weight"].shape[0]),
        num_blocks=n_blocks,
        unet_out=tuple(unet_out),
        unet_extra_bn="decoder.layers.0.shuf.conv.1.weight" in sd,
        ffn_dim=int(
            sd["decoder.color_decoder.transformer_ffn_layers.0.linear1.weight"]
            .shape[0]
        ),
        num_output_channels=int(
            sd.get("refine_net.0.0.weight",
                   sd.get("refine_net.0.0.weight_orig")).shape[0]
        ),
    )


def ddcolor_key_map(
    depths: Sequence[int] = (3, 3, 27, 3), num_blocks: int = 9,
    extra_bn: bool = True,
) -> dict:
    """Map for upstream DDColor checkpoints (net_g_*.pth 'params').
    Fold spectral + weight norms FIRST (decoder convs are spectral-normed,
    last_shuf is weight-normed).  Numerically validated: the converted
    tree reproduces a torch transcription of upstream DDColor end to end
    (tests/test_ref_parity_ddcolor.py vs tests/_ddcolor_oracle.py) and the
    full wheel pipeline is pinned by the golden gate
    (tests/test_golden_ddcolor.py); shapes adapt via
    ddcolor_config_from_state_dict."""
    m = {}
    # encoder (ConvNeXt with out norms)
    m["encoder.arch.downsample_layers.0.0"] = (
        ("convnext", "stem_conv"), "conv")
    m["encoder.arch.downsample_layers.0.1"] = (
        ("convnext", "stem_norm"), "ln")
    for s in range(1, 4):
        m[f"encoder.arch.downsample_layers.{s}.0"] = (
            ("convnext", f"down{s}_norm"), "ln")
        m[f"encoder.arch.downsample_layers.{s}.1"] = (
            ("convnext", f"down{s}_conv"), "conv")
    for s, depth in enumerate(depths):
        for b in range(depth):
            root = ("convnext", f"stage{s}_block{b}")
            base = f"encoder.arch.stages.{s}.{b}"
            m[f"{base}.dwconv"] = (root + ("dwconv",), "conv")
            m[f"{base}.norm"] = (root + ("norm",), "ln")
            m[f"{base}.pwconv1"] = (root + ("pwconv1",), "linear")
            m[f"{base}.pwconv2"] = (root + ("pwconv2",), "linear")
            m[base] = (root, "gamma")
        m[f"encoder.arch.norm{s}"] = (("convnext", f"out_norm{s}"), "ln")

    # pixel decoder: 3 UnetBlockWide + last_shuf
    for i in range(3):
        base = f"decoder.layers.{i}"
        path = (f"layer{i}",)
        m.update(_custom_conv_map(
            f"{base}.shuf.conv", path + ("shuf", "conv"), use_activ=False,
            use_bn=extra_bn))
        m[f"{base}.bn"] = (path + ("bn",), "bn")
        m.update(_custom_conv_map(
            f"{base}.conv", path + ("conv",), use_bn=extra_bn))
    m.update(_custom_conv_map(
        "decoder.last_shuf.conv", ("last_shuf", "conv"), use_activ=False,
        use_bn=False))

    # color decoder
    cd = "decoder.color_decoder"
    for i in range(num_blocks):
        blk = (f"block{i}",)
        m[f"{cd}.transformer_cross_attention_layers.{i}.multihead_attn"] = [
            (blk + ("cross", "q"), "mha_q"),
            (blk + ("cross", "k"), "mha_k"),
            (blk + ("cross", "v"), "mha_v"),
        ]
        m[f"{cd}.transformer_cross_attention_layers.{i}.multihead_attn.out_proj"] = (
            blk + ("cross", "proj"), "linear")
        m[f"{cd}.transformer_cross_attention_layers.{i}.norm"] = (
            blk + ("cross_norm",), "ln")
        m[f"{cd}.transformer_self_attention_layers.{i}.self_attn"] = [
            (blk + ("self", "q"), "mha_q"),
            (blk + ("self", "k"), "mha_k"),
            (blk + ("self", "v"), "mha_v"),
        ]
        m[f"{cd}.transformer_self_attention_layers.{i}.self_attn.out_proj"] = (
            blk + ("self", "proj"), "linear")
        m[f"{cd}.transformer_self_attention_layers.{i}.norm"] = (
            blk + ("self_norm",), "ln")
        m[f"{cd}.transformer_ffn_layers.{i}.linear1"] = (
            blk + ("ffn1",), "linear")
        m[f"{cd}.transformer_ffn_layers.{i}.linear2"] = (
            blk + ("ffn2",), "linear")
        m[f"{cd}.transformer_ffn_layers.{i}.norm"] = (
            blk + ("ffn_norm",), "ln")
    m[f"{cd}.decoder_norm"] = (("decoder_norm",), "ln")
    m[f"{cd}.query_feat"] = ((), "embed_query_feat")
    m[f"{cd}.query_embed"] = ((), "embed_query_embed")
    m[f"{cd}.level_embed"] = ((), "embed_level_embed")
    for s in range(3):
        m[f"{cd}.input_proj.{s}"] = ((f"input_proj{s}",), "conv")
    for j in range(3):
        m[f"{cd}.color_embed.layers.{j}"] = ((f"color_embed{j}",), "linear")
    m["refine_net.0.0"] = (("refine",), "conv")
    return m


def convert_ddcolor_checkpoint(checkpoint_path: str, out_path: str) -> dict:
    """Released DDColor .pt (net_g / 'params' wrapper) -> ddcolor npz.
    The inferred model geometry is stored under ``__config__/<k>`` in the
    npz so the engine rebuilds the exact module variant."""
    import json

    from .convnext import CONVNEXT_CONFIGS

    sd = load_state_dict(checkpoint_path)
    sd = fold_spectral_norm(sd)
    sd = fold_weight_norm(sd)
    cfg = ddcolor_config_from_state_dict(sd)
    key_map = ddcolor_key_map(
        depths=CONVNEXT_CONFIGS[cfg["encoder"]]["depths"],
        num_blocks=cfg["num_blocks"], extra_bn=cfg["unet_extra_bn"],
    )
    params = convert_params(sd, key_map)
    flat_cfg = np.frombuffer(
        json.dumps(cfg).encode(), dtype=np.uint8
    ).copy()
    tree = dict(params)
    tree["__config__"] = {"json": flat_cfg}
    save_params_npz(tree, out_path)
    return params


def npz_config(tree: dict) -> Optional[dict]:
    """Extract a ``__config__/json`` blob stored by convert_*_checkpoint."""
    import json

    blob = tree.get("__config__", {}).get("json")
    if blob is None:
        return None
    return json.loads(bytes(np.asarray(blob)).decode())


__all__ += ["ddcolor_key_map", "ddcolor_config_from_state_dict",
            "convert_ddcolor_checkpoint", "npz_config"]


# ---------------------------------------------------------------------------
# convert-all CLI: downloaded .pth directory -> registry-layout npz directory
# ---------------------------------------------------------------------------

def _conv_deoldify(kind):
    def run(src, dst):
        sd = fold_weight_norm(fold_spectral_norm(load_state_dict(src)))
        key_map = (deoldify_deep_key_map() if kind == "deep"
                   else deoldify_wide_key_map())
        save_params_npz(convert_params(sd, key_map), dst)
    return run


def _conv_simple(map_fn):
    def run(src, dst):
        convert_checkpoint(src, map_fn(), dst)
    return run


# (source filename globs, registry npz name, converter(srcs..., dst)).
# Source names are the exact files the reference downloads
# (vsdeoldify model_dir + torch.hub: __init__.py:2477, deepex/__init__.py:
# 242-253, colormnet_render.py:108, remaster/__init__.py 'remasternet').
CONVERT_ALL_PLAN = [
    (("ColorizeVideo_gen.pth",), "deoldify_video.npz",
     _conv_deoldify("wide")),
    (("ColorizeStable_gen.pth",), "deoldify_stable.npz",
     _conv_deoldify("wide")),
    (("ColorizeArtistic_gen.pth",), "deoldify_artistic.npz",
     _conv_deoldify("deep")),
    (("colorization_release_v2*.pth",), "zhang_eccv16.npz",
     _conv_simple(eccv16_key_map)),
    (("siggraph17*.pth",), "zhang_siggraph17.npz",
     _conv_simple(siggraph17_key_map)),
    (("ddcolor_modelscope.pth",), "ddcolor_modelscope.npz",
     convert_ddcolor_checkpoint),
    (("ddcolor_artistic.pth",), "ddcolor_artistic.npz",
     convert_ddcolor_checkpoint),
    (("vgg19_conv.pth", "nonlocal_net_iter_76000.pth",
      "colornet_iter_76000.pth"), "deepex.npz",
     convert_deepex_checkpoints),
    (("DINOv2FeatureV6_LocalAtten_s2_154000.pth",), "colormnet.npz",
     convert_colormnet_checkpoint),
    (("remasternet.pth.tar",), "remaster.npz",
     convert_remaster_checkpoint),
]


def convert_all(src_dir: str, out_dir: str, strict: bool = False) -> dict:
    """Convert every recognized reference checkpoint in ``src_dir`` into
    the engine-registry layout under ``out_dir``.

    One command from the downloaded .pth files to a ready weights
    directory:  ``python -m havc_tpu_torch.models.convert <src_dir>
    <out_dir>`` then ``havc_tpu_torch.engines.set_weights_dir(out_dir)``
    (or the JAX package's ``set_weights_dir``: the files are the same).
    Returns {npz_name: "converted"|"missing: <file>"};
    ``strict`` raises if any recognized family is absent."""
    import glob as _glob
    import os

    os.makedirs(out_dir, exist_ok=True)
    report = {}
    for globs, out_name, fn in CONVERT_ALL_PLAN:
        srcs = []
        missing = None
        for g in globs:
            hits = sorted(_glob.glob(os.path.join(src_dir, g)))
            if not hits:
                missing = g
                break
            srcs.append(hits[0])
        if missing is not None:
            report[out_name] = f"missing: {missing}"
            if strict:
                raise FileNotFoundError(
                    f"convert_all: no {missing} in {src_dir}")
            continue
        fn(*srcs, os.path.join(out_dir, out_name))
        report[out_name] = "converted"
    return report


__all__ += ["convert_all", "CONVERT_ALL_PLAN"]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert reference vs-deoldify checkpoints to the "
                    "engine-registry npz layout of havc_tpu_torch (and havc_tpu).")
    ap.add_argument("src_dir", help="directory with the downloaded .pth files")
    ap.add_argument("out_dir", help="output weights directory")
    ap.add_argument("--strict", action="store_true",
                    help="fail if any recognized checkpoint is missing")
    args = ap.parse_args()
    for name, status in convert_all(args.src_dir, args.out_dir,
                                    strict=args.strict).items():
        print(f"{name}: {status}")
