"""Weight bridge: a flax parameter tree -> a ``state_dict`` of the port.

The port's modules carry the flax module names, so the mapping is
mechanical:

* the inner ``Conv_0`` / ``ConvTranspose_0`` level of the JAX package's
  ``PtConv`` / ``PtConvTranspose`` wrappers is dropped
  (``up0/shuf/conv/conv/Conv_0/kernel`` -> ``up0.shuf.conv.conv.weight``);
* conv ``kernel`` HWIO -> OIHW ``transpose(3, 2, 0, 1)`` (depthwise
  ``(7, 7, 1, C)`` -> ``(C, 1, 7, 7)``); a 3-D conv's DHWIO -> OIDHW
  ``transpose(4, 3, 0, 1, 2)``; Dense ``kernel (in, out)`` -> ``(out, in)``;
* a ``PtConvTranspose`` kernel (flax ``ConvTranspose`` with
  ``transpose_kernel=True``) is stored ``(kH, kW, O, I)``: the same
  ``transpose(3, 2, 0, 1)`` gives ``nn.ConvTranspose2d``'s ``(I, O, kH,
  kW)``, in the same spatial orientation (no flip: ``transpose_kernel``
  already computes torch's transposed convolution);
* LayerNorm / BatchNorm ``scale`` -> ``weight``; BatchNorm ``mean``/``var``
  -> ``running_mean``/``running_var``;
* raw parameters (``gamma``, ``query_feat``, ``query_embed``,
  ``level_embed``, the folded BatchNorms' ``bn_scale``/``bn_bias``/
  ``bn_mean``/``bn_var``) and ``bias`` as they are.

It takes the trees ``havc_tpu`` initialises and the converted ``.npz``
checkpoints the JAX engine registry reads (engines.load_npz_params).
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "torch_key", "torch_shape", "flatten_tree"]

_LEAF_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """Yield ``(path, leaf)`` for every leaf of a nested mapping."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from flatten_tree(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def torch_key(path: Tuple[str, ...]) -> str:
    """The ``state_dict`` key of a flax parameter path."""
    *mods, leaf = [p for p in path if p not in ("Conv_0", "ConvTranspose_0")]
    if leaf == "kernel":
        leaf = "weight"
    return ".".join(mods + [_LEAF_NAMES.get(leaf, leaf)])


def _kernel_perm(ndim: int):
    if ndim == 5:
        return (4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    if ndim == 4:
        return (3, 2, 0, 1)  # HWIO -> OIHW
    if ndim == 2:
        return (1, 0)  # (in, out) -> (out, in)
    raise ValueError(f"bridge: unsupported kernel rank {ndim}")


def torch_shape(path: Tuple[str, ...], shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The torch shape of a flax parameter of ``shape`` at ``path``."""
    if path[-1] != "kernel":
        return tuple(shape)
    return tuple(shape[i] for i in _kernel_perm(len(shape)))


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` for the port's module from a flax tree of arrays
    (the ``params`` collection, numpy or anything ``np.asarray`` takes)."""
    out = {}
    for path, leaf in flatten_tree(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.transpose(_kernel_perm(arr.ndim))
        key = torch_key(path)
        if key in out:
            raise ValueError(f"bridge: two flax paths map to {key!r}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
