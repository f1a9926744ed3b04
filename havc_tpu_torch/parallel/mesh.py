"""A device mesh and sharded pipeline steps, driven from one process.

Port of ``havc_tpu.parallel.mesh``.  The JAX package is single-controller:
one program over a ``jax.sharding.Mesh``, XLA inserting the transfers.
Here one process drives every device the same way: a batch is split into
one block per device (``Sharded``), each device runs its block (CUDA's
launches are asynchronous, so the devices overlap), and the results are
gathered onto the mesh's first device.  There is no ``torch.distributed``
and no process group.

* ``data`` axis: frames split across devices (every frame is independent
  in the classic colorize path);
* ``model`` axis: rows split across devices for the per-pixel post chain
  (``halo.py`` adds the neighbour rows a stencil needs).

A mesh may name one device more than once: two shards on one card run
the same split on that card.  ``make_mesh(n, platform="cpu")`` gives n
logical CPU shards, the counterpart of the JAX package's virtual CPU
devices; the tests use it.
"""
from __future__ import annotations

import copy
import weakref
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "shard_frames",
    "replicate",
    "sharded_pipeline_step",
    "sharded_engine_step",
    "sharded_classic_pipeline",
]

# the post chain of the sharded steps (the JAX package's ``post_kw``)
POST_KW = dict(
    dark_thr=0.1, dark_white=0.3, dark_sat=0.3, dark_bright=-0.8,
    sm_black=0.3, sm_white=0.7, sm_sat=0.9, sm_bright=0.0,
    cmap_ranges=((300.0, 360.0),), cmap_hue_shift=0.0, cmap_sat=0.8,
    cmap_weight=0.1,
)
PIXEL_MERGES = (2, 3, 4)  # merge methods that combine each pixel on its own


class Mesh:
    """A grid of ``torch.device``s with named axes, as
    ``jax.sharding.Mesh``: ``devices`` (a numpy object array), ``axis_names``
    and ``shape`` (``{name: size}``)."""

    def __init__(self, devices, axis_names=("data", "model")):
        arr = np.array(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        for i, d in enumerate(arr.flat):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            flat[i] = d
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def data_devices(self) -> list:
        """One device per index of the ``data`` axis (its first position on
        the other axes)."""
        a = self.axis_names.index("data")
        return list(np.moveaxis(self.devices, a, 0).reshape(self.devices.shape[a], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.distinct_devices()})"


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: int = 1, platform: Optional[str] = None) -> Mesh:
    """A (data x model) mesh: the first ``n_devices`` CUDA devices (all of
    them by default); too few raises.  ``platform="cpu"`` gives
    ``n_devices`` (default 1) logical shards on the CPU."""
    if platform == "cpu":
        n = n_devices or 1
        devs = [torch.device("cpu")] * n
    elif platform in (None, "cuda", "gpu"):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or have
        if n == 0 or have < n:
            raise ValueError(f"need {max(n, 1)} devices, have {have}")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"make_mesh: unknown platform {platform!r}")
    if data is None:
        data = n // model
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, model), axis_names=("data", "model"))


# --- sharded batches ---------------------------------------------------------------


def _axes(names) -> tuple:
    return () if names is None else (names,) if isinstance(names, str) else tuple(names)


def _counts(spec, mesh: Mesh) -> list:
    """How many blocks each dimension of ``spec`` splits into."""
    return [int(np.prod([mesh.shape[n] for n in _axes(names)])) for names in spec]


@dataclass
class Sharded:
    """A tensor split over a mesh: ``blocks`` (shaped like
    ``mesh.devices``) holds the block on each device.  ``spec`` says, per
    leading dimension, which mesh axes split it, as a JAX ``PartitionSpec``:
    ``("data", "model")`` splits frames over ``data`` and rows over
    ``model``; ``(("data", "model"),)`` splits frames over every device.
    A block repeats along the axes its spec does not name."""

    blocks: np.ndarray
    spec: tuple
    mesh: Mesh

    def _piece(self, pos) -> tuple:
        """The index of the block at mesh position ``pos``, per dimension."""
        out = []
        for names in self.spec:
            k = 0
            for name in _axes(names):
                a = self.mesh.axis_names.index(name)
                k = k * self.mesh.devices.shape[a] + pos[a]
            out.append(k)
        return tuple(out)

    def pieces(self) -> dict:
        """``{piece index: block}``, each distinct block once."""
        out = {}
        for pos in np.ndindex(self.mesh.devices.shape):
            out.setdefault(self._piece(pos), self.blocks[pos])
        return out

    @staticmethod
    def split(x: torch.Tensor, mesh: Mesh, spec) -> "Sharded":
        """Split ``x`` by ``spec`` and put each block on its device (a
        transfer that does not wait; a block on its own device is a view)."""
        spec = tuple(spec)
        counts = _counts(spec, mesh)
        for d, c in enumerate(counts):
            if x.shape[d] % c:
                raise ValueError(f"dimension {d} of size {x.shape[d]} does not split into {c}")
        blocks = np.empty(mesh.devices.shape, dtype=object)
        out = Sharded(blocks, spec, mesh)
        for pos in np.ndindex(mesh.devices.shape):
            b = x
            for d, k in enumerate(out._piece(pos)):
                n = x.shape[d] // counts[d]
                b = b.narrow(d, k * n, n)
            blocks[pos] = b.to(mesh.devices[pos], non_blocking=True)
        return out

    def map(self, fn: Callable) -> "Sharded":
        """``fn(block, device)`` on every device, with the same spec."""
        blocks = np.empty(self.blocks.shape, dtype=object)
        for pos in np.ndindex(self.blocks.shape):
            blocks[pos] = fn(self.blocks[pos], self.mesh.devices[pos])
        return Sharded(blocks, self.spec, self.mesh)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        dev = self.mesh.devices.flat[0]
        pieces = {k: b.to(dev, non_blocking=True) for k, b in self.pieces().items()}
        counts = _counts(self.spec, self.mesh)

        def join(prefix):
            if len(prefix) == len(counts):
                return pieces[prefix]
            return torch.cat([join(prefix + (k,)) for k in range(counts[len(prefix)])],
                             dim=len(prefix))

        return join(())

    def mean(self, fn: Callable = lambda b: b) -> torch.Tensor:
        """The mean of ``fn`` over the whole tensor: each distinct block's
        sum, summed on the first device."""
        dev = self.mesh.devices.flat[0]
        sums, count = [], 0
        for b in self.pieces().values():
            v = fn(b)
            sums.append(v.sum().to(dev, non_blocking=True))
            count += v.numel()
        return torch.stack(sums).sum() / count


def shard_frames(x, mesh: Mesh) -> Sharded:
    """A (T, H, W, C) batch with frames split over ``data`` and rows over
    ``model``."""
    return Sharded.split(torch.as_tensor(x), mesh, ("data", "model"))


_MODULE_COPIES: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def _module_device(m: nn.Module) -> Optional[torch.device]:
    for t in list(m.parameters()) + list(m.buffers()):
        return t.device
    return None


def _tree_to(tree, dev: torch.device):
    if isinstance(tree, nn.Module):
        if _module_device(tree) in (None, dev):
            return tree
        copies = _MODULE_COPIES.setdefault(tree, {})
        if dev not in copies:
            copies[dev] = copy.deepcopy(tree).to(dev)
        return copies[dev]
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, non_blocking=True)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to(t, dev) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree


def replicate(tree, mesh: Mesh) -> dict:
    """``{device: copy}`` of a module, a tensor or a tuple/list/dict of
    them, for each distinct device of the mesh.  A module is copied once per
    device and the copy kept (while the module lives); on its own device a
    module or tensor is itself."""
    return {dev: _tree_to(tree, dev) for dev in mesh.distinct_devices()}


# --- the sharded steps -----------------------------------------------------------------


def _seeded(build: Callable[[], nn.Module], dev: torch.device, name: str) -> nn.Module:
    """A module with flax's default initialisation from a seed of its
    name, made on ``dev`` (never on the host first)."""
    from ..models.layers import init_flax_defaults

    with torch.device("meta"):
        model = build()
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(zlib.crc32(name.encode()))
    init_flax_defaults(model, gen)
    return model.eval().requires_grad_(False)


class _Bound(nn.Module):
    """``fn(model, x)`` as a module, so ``torch.func.functional_call`` can
    run it with the weights of a parameter dict."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, x):
        return self.fn(self.model, x)


def _runner(model: nn.Module, fn: Callable, mesh: Mesh):
    """``run(params, x, device)``: ``fn(model, x)`` on ``device`` with the
    state dict ``params`` (copied there) in place of the model's weights."""
    bound = {dev: _Bound(m, fn) for dev, m in replicate(model, mesh).items()}

    def run(params, x, dev):
        p = {f"model.{k}": v for k, v in _tree_to(dict(params), dev).items()}
        return torch.func.functional_call(bound[dev], p, (x,))

    return run


def sharded_pipeline_step(mesh: Mesh, method: int = 3):
    """The multi-device pipeline step: two stand-in colorizers (a tint
    each way), merge ``method``, a saturation tweak and a clamp, with frames
    split over ``data`` and rows over ``model``.  ``step(frames)`` takes a
    (T, H, W, 3) tensor or a ``Sharded`` batch and returns the output
    gathered onto the first device and the mean luma over all shards.  The
    merges that need whole frames (5-7) join each data shard's rows on one
    device first."""
    from ..ops import merge as merge_ops
    from ..ops.chroma import tweak
    from ..ops.colorspace import luma, rgb_to_yuv, yuv_to_rgb_preserve_luma

    def tint(x, du, dv):
        yuv = rgb_to_yuv(x)
        return yuv_to_rgb_preserve_luma(
            torch.stack([yuv[..., 0], yuv[..., 1] + du, yuv[..., 2] + dv], -1))

    def local(frames, dev=None):
        stable = tint(frames, -0.02, 0.04)
        vivid = tint(frames, 0.05, -0.03)
        merged = merge_ops.combine_models(stable, vivid, method=method, b_weight=0.5)
        return torch.clamp(tweak(merged, sat=1.05), 0.0, 1.0)

    @torch.inference_mode()
    def step(frames):
        xs = frames if isinstance(frames, Sharded) else shard_frames(frames, mesh)
        if method in PIXEL_MERGES:
            out = xs.map(local)
        else:
            whole = Sharded.split(xs.gather(), mesh, ("data",)).map(local)
            out = Sharded.split(whole.gather(), mesh, ("data", "model"))
        return out.gather(), out.mean(luma)

    return step


def sharded_engine_step(mesh: Mesh, config: str = "tiny", input_size: int = 64,
                        work: int = 64):
    """The pipeline step with a real engine under the mesh: DDColor
    (``config``, seeded weights) over frames split across every device,
    the simple merge with the input, then the rows re-split over ``model``
    for the post chain (the CUDA kernel on the card) and a clamp, and the
    mean luma over all shards.

    Returns ``(step_fn, params)``: ``step_fn(params, frames)`` with
    ``params`` a DDColor state dict (the one returned, or another of the
    same keys), ``frames`` (T, H, W, 3) with T divisible by the mesh size
    and H by the ``model`` axis.  ``work`` is unused, as in the JAX
    package."""
    from ..models import ddcolor as dd
    from ..ops import merge as merge_ops
    from ..ops.colorspace import luma
    from ..ops.post_chain import post_chain

    del work
    dev0 = mesh.devices.flat[0]
    model = _seeded(lambda: dd.DDColor.from_config(config), dev0, f"ddcolor_{config}")
    run = _runner(model, lambda m, x: dd.colorize(m, x, input_size=input_size), mesh)

    @torch.inference_mode()
    def step(params, frames):
        xs = Sharded.split(torch.as_tensor(frames), mesh, (("data", "model"),))
        merged = xs.map(lambda x, dev: merge_ops.combine_models(
            x, run(params, x, dev), method=2, b_weight=0.5))
        spatial = Sharded.split(merged.gather(), mesh, ("data", "model"))
        out = spatial.map(lambda x, dev: torch.clamp(post_chain(x, **POST_KW), 0.0, 1.0))
        return out.gather(), out.mean(luma)

    return step, dict(model.state_dict())


def sharded_classic_pipeline(mesh: Mesh, do_encoder: str = "nano",
                             dd_config: str = "tiny", rf: int = 4,
                             input_size: int = 64):
    """The classic colorize pipeline under the mesh: spline64 work resize
    -> DeOldify (wide, ``do_encoder``) and DDColor (``dd_config``) ->
    constrained-chroma merge -> post chain (the CUDA kernel on the card) ->
    full-resolution chroma restore, frames split over every device; the
    output gathered onto the first device and the mean luma over all
    shards.

    Returns ``(step_fn, (do_params, dd_params))`` (state dicts of the
    seeded engines); ``step_fn(do_params, dd_params, frames)`` with T
    divisible by the mesh size.  The defaults are the test geometry; the
    production one is ``do_encoder="resnet101", dd_config="large", rf=24,
    input_size=384``."""
    from ..filters import chroma_resize_restore
    from ..models import ddcolor as dd
    from ..models import deoldify as do
    from ..ops import merge as merge_ops
    from ..ops.colorspace import luma
    from ..ops.post_chain import post_chain
    from ..ops.resize import resize

    dev0 = mesh.devices.flat[0]
    do_model = _seeded(lambda: do.DeOldifyWide(encoder=do_encoder, nf_factor=1), dev0,
                       f"deoldify_wide_{do_encoder}")
    dd_model = _seeded(lambda: dd.DDColor.from_config(dd_config), dev0, f"ddcolor_{dd_config}")
    run_do = _runner(do_model, lambda m, x: do.colorize(m, x, render_factor=rf), mesh)
    run_dd = _runner(dd_model, lambda m, x: dd.colorize(m, x, input_size=input_size), mesh)
    work = rf * 16

    @torch.inference_mode()
    def step(do_p, dd_p, frames):
        def local(x, dev):
            w = torch.clamp(resize(x, work, work, "spline64"), 0.0, 1.0)
            merged = merge_ops.combine_models(run_do(do_p, w, dev), run_dd(dd_p, w, dev),
                                              method=3, b_weight=0.5)
            return chroma_resize_restore(x, post_chain(merged, **POST_KW))

        out = Sharded.split(torch.as_tensor(frames), mesh, (("data", "model"),)).map(local)
        return out.gather(), out.mean(luma)

    return step, (dict(do_model.state_dict()), dict(dd_model.state_dict()))
