"""The port's output formats against the JAX package's on the CPU:
``io.formats`` (matrix, range, depth, subsampling, the inverse),
``io.native`` (the framepipe library built from ``native/framepipe.cpp``,
its Floyd-Steinberg quantizers and its threaded Y4M stream) and
``io.video.write_video_y4m`` read back by the port's ``Y4MReader``.

Floyd-Steinberg carries each pixel's error forward, so one code moved by
float noise shifts the pattern behind it.  It is held in two parts: the
two packages' native dithers given the same float planes are
bit-identical, and the float code planes before the dither agree to 1e-4
code.  The whole ``restore_format_yuv`` output is then held within 1
code at every pixel, each plane's mean within 0.01 code.  The JAX side
must really dither: its library has to load (a rounding fallback there
would make the comparison meaningless), and the port raises where the
library is missing.  The inverse conversion is held at 1e-5.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu.clip import Clip as JClip
from havc_tpu.io import formats as jformats
from havc_tpu.io import native as jnative
from havc_tpu.io import video as jvideo

import havc_tpu_torch
from havc_tpu_torch.io import Y4MReader
from havc_tpu_torch.io import formats as tformats
from havc_tpu_torch.io import native as tnative
from havc_tpu_torch.io import video as tvideo

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

CODE_TOL = 1e-4
MEAN_TOL = 0.01
OP_TOL = 1e-5


def frames(t=3, h=48, w=64, seed=0):
    """Smooth seeded RGB frames with a little noise, inside [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((t, h, w, 3), np.float32)
    for i in range(t):
        for c in range(3):
            a, b, p = rng.uniform(0.5, 3.0, 3)
            out[i, ..., c] = 0.5 + 0.35 * np.sin(a * xx / w * 6 + p) * np.cos(b * yy / h * 5)
    return np.clip(out + rng.normal(0, 0.02, out.shape).astype(np.float32), 0, 1)


def codes_close(want, got):
    """Within 1 code at every pixel, the means within MEAN_TOL codes."""
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        d = np.abs(w.astype(np.int64) - g.astype(np.int64))
        assert d.max() <= 1, d.max()
        assert abs(float(w.mean()) - float(g.mean())) <= MEAN_TOL


def test_native_libraries_load():
    """Both packages' libraries load: the JAX package's through its
    Makefile, the port's built from the same source into its own build
    directory."""
    assert jnative.load_native() is not None
    lib = tnative.load_native()
    assert lib is tnative.load_native()
    assert os.path.basename(tnative.build_native()).startswith("libframepipe-")


@pytest.mark.parametrize("bits", [8, 16])
def test_native_dither_is_bit_identical(bits):
    """The same float planes through each package's library give the same
    codes (the same C++ on the same machine)."""
    rng = np.random.default_rng(bits)
    planes = (rng.random((3, 37, 53), dtype=np.float32) * 250.0 + 3.0) * (1 << (bits - 8))
    lo, hi = 16.0 * (1 << (bits - 8)), 235.0 * (1 << (bits - 8))
    want = jformats._fs_dither(planes, lo, hi, bits=bits)
    got = tformats._fs_dither(planes, lo, hi, bits=bits)
    assert got.dtype == (np.uint8 if bits == 8 else np.uint16)
    np.testing.assert_array_equal(got, want)
    # error diffusion, not rounding: the dithered mean follows the float mean
    assert not np.array_equal(got, np.clip(np.round(planes), lo, hi).astype(got.dtype))


FORMATS = [(bits, ss, full) for bits in (8, 10, 16) for ss in ("420", "422", "444")
           for full in (False, True)]


@pytest.mark.parametrize("bits,subsampling,range_full", FORMATS)
def test_restore_format(bits, subsampling, range_full):
    x = frames(h=47 if subsampling == "420" else 48, w=63)  # odd sizes edge-pad the chroma
    jp = jformats.rgb_to_yuv_planes(jnp.asarray(x), "709", range_full, bits)
    want_planes = [np.asarray(jp[0])] + [np.asarray(jformats._subsample(c, subsampling))
                                         for c in jp[1:]]
    got_planes = tformats._code_planes(x, "709", range_full, bits, subsampling, "cpu")
    for w, g in zip(want_planes, got_planes):
        np.testing.assert_allclose(g, w, rtol=0, atol=CODE_TOL)
    want = jformats.restore_format_yuv(x, "709", range_full, bits, subsampling)
    got = tformats.restore_format_yuv(torch.from_numpy(x), "709", range_full, bits, subsampling)
    codes_close(want, got)
    for dither in ("none", "ordered"):  # any other value rounds
        codes_close(jformats.restore_format_yuv(x, "2020", range_full, bits, subsampling, dither),
                    tformats.restore_format_yuv(x, "2020", range_full, bits, subsampling, dither,
                                                device="cpu"))


@pytest.mark.parametrize("subsampling", ["420", "422", "444"])
@pytest.mark.parametrize("matrix", ["601", "709"])
def test_planes_to_rgb(subsampling, matrix):
    x = frames(w=64)
    y, u, v = jformats.restore_format_yuv(x, matrix, False, 10, subsampling)
    want = np.asarray(jformats.yuv_planes_to_rgb(y, u, v, matrix, False, 10))
    got = tformats.yuv_planes_to_rgb(y, u, v, matrix, False, 10, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)
    # the round trip through 10-bit codes comes back close (the subsampled
    # chroma loses the noise's detail)
    assert np.abs(got - x).mean() < (0.001 if subsampling == "444" else 0.02)
    y8, u8, v8 = tformats.restore_format_yuv420p8(x, matrix, device="cpu")
    np.testing.assert_allclose(tformats.yuv420p8_to_rgb(y8, u8, v8, matrix, device="cpu").numpy(),
                               np.asarray(jformats.yuv420p8_to_rgb(y8, u8, v8, matrix)),
                               rtol=0, atol=OP_TOL)


def test_1080p_plane():
    """One 1080p frame: the float planes at 1e-4 code, the dithered codes
    within 1 (error diffusion over 1920-wide rows)."""
    x = frames(t=1, h=1080, w=1920, seed=5)
    jp = jformats.rgb_to_yuv_planes(jnp.asarray(x), "709", False, 8)
    want_planes = [np.asarray(jp[0])] + [np.asarray(jformats._subsample(c)) for c in jp[1:]]
    got_planes = tformats._code_planes(x, "709", False, 8, "420", "cpu")
    for w, g in zip(want_planes, got_planes):
        np.testing.assert_allclose(g, w, rtol=0, atol=CODE_TOL)
    codes_close(jformats.restore_format_yuv420p8(x), tformats.restore_format_yuv420p8(
        x, device="cpu"))


def test_write_video_y4m_round_trip(tmp_path):
    """The port's ``.y4m`` is the JAX package's within 1 code (same header,
    same plane order); ``Y4MReader`` reads back exactly the planes
    ``restore_format_yuv420p8`` made, and the native Y4M stream of both
    packages decodes it the same."""
    x = frames(t=4, h=46, w=62, seed=2)
    jpath, tpath = str(tmp_path / "jax.y4m"), str(tmp_path / "port.y4m")
    jvideo.write_video_y4m(JClip(frames=x.copy(), fps=24.0), jpath)
    tvideo.write_video_y4m(havc_tpu_torch.Clip(frames=torch.from_numpy(x), fps=24.0), tpath)
    with open(jpath, "rb") as f:
        jhead = f.readline()
    with open(tpath, "rb") as f:
        thead = f.readline()
    assert thead == jhead == b"YUV4MPEG2 W62 H46 F24000:1000 Ip A1:1 C420mpeg2\n"
    with Y4MReader(tpath) as r:
        assert (r.width, r.height, r.fps, r.colorspace) == (62, 46, 24.0, "420mpeg2")
        got = r.read_planes(10)
        assert r.read_planes(1) is None
    with Y4MReader(jpath) as r:
        want = r.read_planes(10)
    codes_close(want, got)
    made = tformats.restore_format_yuv420p8(x, device="cpu")
    for a, b in zip(made, got):
        np.testing.assert_array_equal(a, b)
    rgb = tformats.yuv420p8_to_rgb(*got, device="cpu").numpy()
    psnr = 10 * np.log10(1.0 / np.mean((rgb - x) ** 2))
    assert psnr > 30, psnr
    # the native threaded stream of each package, on the port's file
    jstream, tstream = jnative.Y4MStream(tpath), tnative.Y4MStream(tpath)
    try:
        jb = list(jstream.read_batches(3))
        tb = list(tstream.read_batches(3))
    finally:
        jstream.close()
        tstream.close()
    assert [b.shape for b in tb] == [(3, 46, 62, 3), (1, 46, 62, 3)]
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)


def test_error_diffusion_raises_without_the_library(monkeypatch, tmp_path):
    """No rounding fallback: when the library cannot be built, the dither
    raises ``NativeUnavailable``; rounding stays available by name."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_SOURCE", tmp_path / "missing.cpp")
    x = frames(t=1)
    with pytest.raises(tnative.NativeUnavailable):
        tformats.restore_format_yuv420p8(x, device="cpu")
    with pytest.raises(tnative.NativeUnavailable):
        tvideo.write_video_y4m(havc_tpu_torch.Clip(frames=x), str(tmp_path / "x.y4m"),
                               device="cpu")
    y, u, v = tformats.restore_format_yuv420p8(x, dither="none", device="cpu")
    assert y.dtype == np.uint8 and y.shape == (1, 48, 64) and u.shape == (1, 24, 32)


def test_numpy_frames_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tformats.restore_format_yuv(frames(t=1))
