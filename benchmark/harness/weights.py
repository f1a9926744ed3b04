"""Seeded weights, made on the device, and the engines built from them.

A configuration lists its engines (``family``, ``name``, the model
``module`` and ``class`` and its constructor ``args``).  ``make_state``
draws one engine's whole state dict from its seed in two large calls (one
uniform draw over every element, turned into a normal truncated at 2
standard deviations) and then scales each tensor by its kind:

* kernels (2 or more dims): lecun normal, variance 1/fan_in, fan_in every
  dim but the first;
* norm scales ``1 + N(0, 0.02)``, biases ``N(0, 0.02)``, running means 0
  and variances 1;
* layer scales and attention gates (``*gamma``) 0.1, so that no block is
  inert; DDColor's queries and level embeddings ``N(0, 1)``, the ViT's
  position embedding and class token ``N(0, 0.02)``, ColorMNet's attention
  temperature 1.

An engine's ``scale`` multiplies named tensors further: a configuration
uses it on an engine's last layer where random weights would saturate its
output, or leave it all but gray, and trained ones do neither.  The names and shapes come from the benchmark's reference modules, so the
benchmark defines the weights; both sides load the same state dict
strictly, which also checks that the program's modules have the reference's
parameters.
"""
from __future__ import annotations

import importlib
import math
import zlib
from typing import Dict, List, Tuple

import torch

__all__ = ["make_state", "build_engine", "engine_seed", "param_count"]

_SQRT2 = math.sqrt(2.0)
_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated at +-2


def engine_seed(weight_seed: int, family: str, name: str) -> int:
    return weight_seed * 1_000_003 + zlib.crc32(f"{family}_{name}".encode())


def _rule(key: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(scale, offset) of a tensor: value = z * scale + offset, z a
    standard normal truncated at +-2."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("running_var", "bn_var"):
        return 0.0, 1.0
    if leaf in ("running_mean", "bn_mean"):
        return 0.0, 0.0
    if leaf == "temperature":
        return 0.0, 1.0
    if leaf.endswith("gamma"):
        return 0.0, 0.1
    if leaf in ("query_feat", "query_embed", "level_embed"):
        return 1.0 / _TRUNC_STD, 0.0
    if leaf in ("pos_embed", "cls_token"):
        return 0.02 / _TRUNC_STD, 0.0
    if len(shape) >= 2:
        return math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD, 0.0
    if leaf in ("weight", "bn_scale"):
        return 0.02, 1.0
    if leaf in ("bias", "bn_bias"):
        return 0.02, 0.0
    raise ValueError(f"weights: no rule for {key} {shape}")


def _meta_module(spec: dict, package: str) -> torch.nn.Module:
    mod = importlib.import_module(f"{package}.models.{spec['module']}")
    with torch.device("meta"):
        return getattr(mod, spec["class"])(**spec["args"])


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


@torch.no_grad()
def make_state(spec: dict, weight_seed: int, device, package: str) -> Dict[str, torch.Tensor]:
    """The engine's state dict from the seed, on ``device``, float32;
    names and shapes from ``package``'s module."""
    shapes: List[Tuple[str, torch.Size]] = [
        (k, v.shape) for k, v in _meta_module(spec, package).state_dict().items()]
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(engine_seed(weight_seed, spec["family"], spec["name"]))
    lo = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
    hi = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
    flat = torch.empty(total, device=device).uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    flat.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
    views, scales, offsets, state, at = [], [], [], {}, 0
    for key, shape in shapes:
        n = math.prod(shape)
        v = flat[at:at + n]
        at += n
        scale, offset = _rule(key, tuple(shape))
        scale *= spec.get("scale", {}).get(key, 1.0)
        views.append(v)
        scales.append(scale)
        offsets.append(offset)
        state[key] = v.view(shape)
    torch._foreach_mul_(views, scales)
    torch._foreach_add_(views, offsets)
    return state


def build_engine(spec: dict, state: Dict[str, torch.Tensor], package: str) -> torch.nn.Module:
    """``package``'s module for ``spec`` holding ``state`` (no copy), in
    inference mode; its parameter count must be the configuration's."""
    module = _meta_module(spec, package)
    module.load_state_dict(state, strict=True, assign=True)
    left = [k for k, t in list(module.named_parameters()) + list(module.named_buffers())
            if t.is_meta]
    if left:
        raise ValueError(f"{package} {spec['class']}: tensors outside the state dict: {left}")
    if param_count(module) != spec["params"]:
        raise ValueError(f"{package} {spec['class']}: {param_count(module)} parameters, "
                         f"the configuration states {spec['params']}")
    return module.eval().requires_grad_(False)
