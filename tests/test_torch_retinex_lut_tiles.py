"""The port's retinex, 3D-LUT and tile ops against ``havc_tpu`` on the CPU.

Inputs are seeded numpy images.  Tolerance 1e-5 max abs, except the
retinex outputs: 1e-4.  Their box filters' cumulative sums run over up to
``W + 499`` samples at sigma 250, and XLA sums them in another order than
PyTorch (which order depends on how XLA's CPU runtime splits the work:
2.8e-5 was seen on one frame here); the log of the blur and the final
stretch to [0,1] amplify that.  The retinex luma gate's per-frame means
sit far from its [0.20, 0.80] bounds, so no frame's decision can flip.
The quantiles equal ``jnp.quantile``'s bit for bit, and the look lattices
too (built by the same numpy code from the same table).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu.ops import lut3d as jlut
from havc_tpu.ops import retinex as jret
from havc_tpu.ops import tiles as jtiles
from havc_tpu_torch.ops import lut3d as tlut
from havc_tpu_torch.ops import retinex as tret
from havc_tpu_torch.ops import tiles as ttiles

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

TOL = 1e-5
RETINEX_TOL = 1e-4


def _rgb(t, h, w, seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random((t, h, w, 3), dtype=np.float32)).astype(np.float32)


def _close(want, got, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


# --- retinex ---------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [25.0, 80.0, 250.0])
def test_gaussian_blur_box(sigma):
    x = _rgb(2, 40, 300, seed=1)[..., 0]
    _close(jret.gaussian_blur_box(jnp.asarray(x), sigma),
           tret.gaussian_blur_box(torch.from_numpy(x), sigma))


def test_quantile_matches_jnp_quantile():
    x = _rgb(3, 37, 41, seed=2)[..., 0].reshape(3, -1)
    for q in (0.001, 0.999, 0.5, 0.0, 1.0):
        want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=-1))
        got = tret.quantile_linear(torch.from_numpy(x), q).numpy()
        assert np.array_equal(want, got), q


@pytest.mark.parametrize("fn", ["msr", "msrcp_rgb", "msr_yuv"])
def test_msr_variants(fn):
    x = _rgb(2, 36, 52, seed=3, lo=0.1, hi=0.8)
    if fn == "msr":
        x = x[..., 0]
    _close(getattr(jret, fn)(jnp.asarray(x)), getattr(tret, fn)(torch.from_numpy(x)),
           RETINEX_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(blend=True), dict(fast_mode=False),
                                dict(fast_mode=False, blend=True, range_tv=False)])
def test_retinex_filter_gates(kw):
    """A mid frame is filtered, a dark and a bright frame pass through."""
    x = np.concatenate([_rgb(1, 30, 44, seed=4, lo=0.2, hi=0.8),
                        _rgb(1, 30, 44, seed=5, lo=0.0, hi=0.1),
                        _rgb(1, 30, 44, seed=6, lo=0.9, hi=1.0)])
    got = tret.retinex_filter(torch.from_numpy(x), **kw)
    _close(jret.retinex_filter(jnp.asarray(x), **kw), got, RETINEX_TOL)
    assert np.array_equal(got[1:].numpy(), x[1:])
    assert np.abs(got[0].numpy() - x[0]).max() > 0.01
    # a single (H, W, 3) frame
    _close(jret.retinex_filter(jnp.asarray(x[0]), **kw),
           tret.retinex_filter(torch.from_numpy(x[0]), **kw), RETINEX_TOL)


# --- 3D LUTs ---------------------------------------------------------------------


def test_tables_are_the_jax_packages():
    assert tlut.LUT_NAMES == jlut.LUT_NAMES
    assert tlut.LUT_TWEAKS == jlut.LUT_TWEAKS


@pytest.mark.parametrize("look", list(range(12)) + ["Warm Haze"])
def test_make_look_lut_bit_equal(look):
    want = jlut.make_look_lut(look)
    got = tlut.make_look_lut(look)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("look", [2, 8, 11])
def test_apply_lut3d(look):
    x = _rgb(2, 17, 23, seed=7)
    x[0, 0, :3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 1.0, 0.0]]  # lattice corners
    table = jlut.make_look_lut(look)
    _close(jlut.apply_lut3d(jnp.asarray(x), jnp.asarray(table)),
           tlut.apply_lut3d(torch.from_numpy(x), table))


def test_cube_round_trip(tmp_path):
    """A .cube file written red-fastest with a DOMAIN line reads back to
    the same lattice in both packages, and applies the same."""
    n = 5
    lattice = tlut.make_look_lut("hollywood", size=n)
    path = tmp_path / "look.cube"
    with open(path, "w") as f:
        f.write("# test\nTITLE \"t\"\nLUT_3D_SIZE 5\nDOMAIN_MIN 0 0 0\nDOMAIN_MAX 1 1 1\n")
        for b in range(n):
            for g in range(n):
                for r in range(n):
                    f.write("%.9f %.9f %.9f\n" % tuple(lattice[r, g, b]))
    got = tlut.load_cube(str(path))
    assert np.array_equal(got, jlut.load_cube(str(path)))
    assert np.abs(got - lattice).max() <= 1e-7
    x = _rgb(1, 9, 11, seed=8)
    _close(jlut.apply_lut3d(jnp.asarray(x), jnp.asarray(got)), tlut.apply_lut3d(
        torch.from_numpy(x), got))


# --- tiles -------------------------------------------------------------------------


@pytest.mark.parametrize("size,n,overlap", [(1920, 2, 192), (1080, 2, 108), (1079, 2, 64),
                                            (241, 2, 64), (136, 2, 64), (1000, 1, 0)])
def test_tile_bounds(size, n, overlap):
    assert ttiles._tile_bounds(size, n, overlap) == jtiles._tile_bounds(size, n, overlap)


@pytest.mark.parametrize("rows,cols", [(2, 2), (1, 2)])
@pytest.mark.parametrize("hw,ov", [((136, 240), (64, 64)), ((68, 121), (32, 20))])
def test_slice_reconstruct(rows, cols, hw, ov):
    x = _rgb(3, *hw, seed=9)
    jt, jmeta = jtiles.slice_tiles(jnp.asarray(x), rows, cols, ov[0], overlap_y=ov[1])
    tt, tmeta = ttiles.slice_tiles(torch.from_numpy(x), rows, cols, ov[0], overlap_y=ov[1])
    assert tmeta == jmeta
    assert np.array_equal(np.asarray(jt), tt.numpy())
    # the same tiles reconstruct to the frames (ramps sum to one)
    back = ttiles.reconstruct_tiles(tt, tmeta)
    assert np.abs(back.numpy() - x).max() <= 1e-6
    # processed tiles blend as the JAX package blends them, with and
    # without the luma copy-back
    proc = np.asarray(jt) * np.linspace(0.5, 1.0, len(jt), dtype=np.float32)[:, None, None, None]
    for luma in (None, x):
        want = jtiles.reconstruct_tiles(jnp.asarray(proc), jmeta,
                                        recover_luma=None if luma is None else jnp.asarray(luma))
        got = ttiles.reconstruct_tiles(torch.from_numpy(proc), tmeta,
                                       recover_luma=None if luma is None else torch.from_numpy(luma))
        _close(want, got)
