"""Halo exchange for row-sharded stencil ops (convolutions, blurs).

Port of ``havc_tpu.parallel.halo``.  Splitting a frame's rows over the
mesh's ``model`` axis needs, for any op with a receptive field, the rows
of the neighbouring shards: each block takes ``halo`` rows from the
block above and the block below (``Tensor.to(device, non_blocking=True)``,
a peer copy between GPUs), the true top and bottom borders replicate
their edge row, the unchanged local op runs on the haloed block and the
halo is cropped off.  For an edge-padded op of at most ``halo`` rows of
reach the result equals the op on the whole frame.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .mesh import Mesh, Sharded

__all__ = ["halo_exchange_rows", "spatial_halo_call"]


def halo_exchange_rows(x_local: Sharded, halo: int, axis_name: str) -> Sharded:
    """Extend every block of a sharded (T, H, W, C) batch by ``halo`` rows
    from each neighbour along the mesh axis ``axis_name`` (the axis that
    splits its rows), replicating the edge rows at the global top and
    bottom: blocks of (T, H_local + 2 * halo, W, C)."""
    mesh = x_local.mesh
    dim = [i for i, names in enumerate(x_local.spec)
           if axis_name in ((names,) if isinstance(names, str) else tuple(names or ()))]
    if len(dim) != 1:
        raise ValueError(f"halo_exchange_rows: spec {x_local.spec} does not split one "
                         f"dimension over {axis_name!r}")
    d, a = dim[0], mesh.axis_names.index(axis_name)
    n = mesh.devices.shape[a]
    blocks = np.empty(x_local.blocks.shape, dtype=object)
    for pos in np.ndindex(blocks.shape):
        b, j = x_local.blocks[pos], pos[a]
        edge_shape = list(b.shape)
        edge_shape[d] = halo

        def neighbour(k, last):  # block k's last (or first) halo rows, here
            nb = x_local.blocks[pos[:a] + (k,) + pos[a + 1:]]
            rows = nb.narrow(d, nb.shape[d] - halo if last else 0, halo)
            return rows.to(b.device, non_blocking=True)

        above = neighbour(j - 1, True) if j > 0 else b.narrow(d, 0, 1).expand(edge_shape)
        below = (neighbour(j + 1, False) if j < n - 1
                 else b.narrow(d, b.shape[d] - 1, 1).expand(edge_shape))
        blocks[pos] = torch.cat([above, b, below], dim=d)
    return Sharded(blocks, x_local.spec, mesh)


def spatial_halo_call(
    mesh: Mesh,
    fn: Callable[[torch.Tensor], torch.Tensor],
    halo: int,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """A row-sharded version of a local op.

    ``fn`` maps (T, H, W, C) -> (T, H, W, C) with a reach of at most
    ``halo`` rows (edge padding at the borders).  The returned callable
    takes a (T, H, W, C) tensor (or a ``Sharded`` batch of that spec),
    splits frames over ``data_axis`` and rows over ``model_axis``, exchanges
    the halos, runs ``fn`` on each block, crops, and returns the result
    gathered onto the mesh's first device: equal to ``fn`` on the whole
    batch."""
    spec = (data_axis, model_axis)

    def call(x):
        xs = x if isinstance(x, Sharded) else Sharded.split(torch.as_tensor(x), mesh, spec)
        ext = halo_exchange_rows(xs, halo, model_axis)

        def local(b, dev):
            out = fn(b)
            return out[:, halo:out.shape[1] - halo]

        return ext.map(local).gather()

    return call
