"""The U-Net decoders' upsample-and-join (``ops/unet_join.py``).

On the CPU: the plain chain ``unet_join_reference`` gives the bits of the
models' old composite (``PixelShuffleICNR`` then the join in
``UnetBlockWide``/``UnetBlockDeep``/the DeOldify head) in every mode, the
models give the bits of the benchmark's frozen copy of the old modules
(``benchmark/reference/havc_ref``), the dispatcher takes the plain chain
and counts the call but no launch, and no ``state_dict`` key or shape
moved.

On the card (``-m cuda``; run with ``python -m pytest --noconftest
tests/test_torch_unet_join.py -m cuda`` where JAX is not installed): the
kernel gives the plain chain's bits at the 9 sites of a 384² frame at
batch 8, at odd sizes, on negatives, signed zeros, infinities and NaN,
and inside whole DeOldify Video and DDColor large forwards, one launch a
site.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.models.layers import BatchNormInference, init_flax_defaults
from havc_tpu_torch.ops import unet_join as uj
from havc_tpu_torch.ops.resize import resize_nearest
from havc_tpu_torch.utils.profiling import counters, reset_counters

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark" / "reference"))
from havc_ref.models import ddcolor as rdd  # noqa: E402  (the frozen old modules)
from havc_ref.models import deoldify as rdo  # noqa: E402

COUNTERS = ("unet_join_calls", "unet_join_launches")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and equal bits (a NaN equals a NaN of the same bits)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Flax-default weights from ``seed``, then every BatchNorm's
    statistics, scales and biases and every conv bias moved off their
    init values, and the attention gates opened."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        init_flax_defaults(module, g)
        for m in module.modules():
            if isinstance(m, BatchNormInference):
                n = m.weight.shape[0]
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(1 + 0.2 * torch.rand(n, generator=g))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, tdo.SelfAttention):
                m.gamma.fill_(0.3)
    return module.eval()


# --- the models' old composite ------------------------------------------------


def old_shuffle(shuf: tdo.PixelShuffleICNR, x: torch.Tensor) -> torch.Tensor:
    """``PixelShuffleICNR.forward`` as the models ran it."""
    y = shuf.conv.conv(x)
    if hasattr(shuf.conv, "bn"):
        y = shuf.conv.bn(y)
    y = F.pixel_shuffle(F.relu(y), shuf.scale)
    if shuf.blur:
        y = F.pad(y, (1, 0, 1, 0), mode="replicate")
        y = F.avg_pool2d(y, 2, stride=1)
    return y


def old_join(x: torch.Tensor, skip: torch.Tensor, bn: BatchNormInference) -> torch.Tensor:
    """The join of ``UnetBlockWide``/``UnetBlockDeep`` as the models ran it."""
    if x.shape[2:] != skip.shape[2:]:
        x = resize_nearest(x, skip.shape[2], skip.shape[3])
    return F.relu(torch.cat([x, bn(skip)], dim=1))


# (mode, scale, use_bn, blur, skip size over the upsampled size)
MODES = [("skip", 2, True, True, 0), ("skip", 4, True, True, 0), ("copy", 2, False, True, 0),
         ("copy", 4, False, True, 0), ("none", 2, False, True, 0), ("none", 4, False, True, 0),
         ("none", 2, True, True, 0), ("skip", 2, True, False, 0), ("nearest", 2, True, True, 1)]


@pytest.mark.parametrize("mode,scale,use_bn,blur,grow", MODES,
                         ids=[f"{m[0]}-r{m[1]}{'-bn' if m[2] else ''}{'' if m[3] else '-noblur'}"
                              for m in MODES])
def test_reference_equals_old_composite(mode, scale, use_bn, blur, grow):
    g = torch.Generator().manual_seed(11)
    n, cin, feat, h, w, s = 2, 6, 3, 5, 7, 4
    shuf = seeded(tdo.PixelShuffleICNR(cin, feat, blur=blur, use_bn=use_bn, scale=scale), 1)
    bn_skip = seeded(BatchNormInference(s), 2)
    x = torch.randn(n, cin, h, w, generator=g)
    skip = torch.randn(n, s, scale * h + grow, scale * w + grow, generator=g)
    with torch.no_grad():
        conv_out = shuf.conv.conv(x)
        fold = shuf.conv.bn.fold() if use_bn else None
        if mode in ("skip", "nearest"):
            want = old_join(old_shuffle(shuf, x), skip, bn_skip)
            got = uj.unet_join_reference(conv_out, scale, fold, skip=skip,
                                         skip_bn=bn_skip.fold(), blur=blur)
        elif mode == "copy":
            want = torch.cat([old_shuffle(shuf, x), skip], dim=1)
            got = uj.unet_join_reference(conv_out, scale, fold, skip=skip, blur=blur)
        else:
            want = old_shuffle(shuf, x)
            got = uj.unet_join_reference(conv_out, scale, fold, blur=blur)
        assert same_bits(got, want)
        # the module's own forward (the dispatcher, on the CPU) gives them too
        if mode == "none":
            assert same_bits(shuf(x), want)
        elif mode == "copy":
            assert same_bits(shuf(x, skip), want)
        else:
            assert same_bits(shuf(x, skip, bn_skip.fold()), want)


def _pair(name: str, device="cpu"):
    """(port model, frozen old model) with the same seeded weights, small."""
    if name == "deoldify_wide":
        new, old = tdo.DeOldifyWide(encoder="nano", nf_factor=1), \
            rdo.DeOldifyWide(encoder="nano", nf_factor=1)
    elif name == "deoldify_deep":
        new, old = tdo.DeOldifyDeep(encoder="nano"), rdo.DeOldifyDeep(encoder="nano")
    else:
        new, old = tdd.DDColor.from_config("micro"), rdd.DDColor.from_config("micro")
    seeded(new, 5)
    old.load_state_dict(new.state_dict(), strict=True)
    return new.to(device), old.eval().to(device)


@pytest.mark.parametrize("size", [64, 72], ids=["even", "nearest_branch"])
@pytest.mark.parametrize("name", ["deoldify_wide", "deoldify_deep", "ddcolor"])
def test_models_equal_the_old_modules(name, size):
    """72 = 2.25 x 32: the deepest skips are of odd size, so a block's
    upsampled map takes the nearest-resize branch."""
    new, old = _pair(name)
    x = torch.rand(2, 3, size, size, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert same_bits(new(x), old(x))


def test_cpu_takes_the_plain_chain(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(uj, "unet_join_cuda", no_kernel)
    reset_counters(*COUNTERS)
    new, _ = _pair("deoldify_deep")
    with torch.no_grad():
        new(torch.rand(1, 3, 64, 64))
    c = counters()
    assert c.get("unet_join_calls") == 5  # up0..up3 and the head
    assert c.get("unet_join_launches", 0) == 0


def _fake(shape, cuda=True, dtype=torch.float32, layout=torch.contiguous_format):
    """A stand-in tensor dense in ``layout`` (None: in neither)."""
    return SimpleNamespace(shape=torch.Size(shape), ndim=len(shape), is_cuda=cuda, dtype=dtype,
                           is_contiguous=lambda memory_format=torch.contiguous_format:
                           memory_format == layout)


CL = torch.channels_last


@pytest.mark.parametrize("change,takes", [
    ({}, True), ({"cuda": False}, False), ({"dtype": torch.bfloat16}, False),
    ({"layout": None}, False), ({"layout": CL}, False), ({"skip_layout": CL}, False),
    ({"skip_layout": None}, False),
    ({"blur": False}, False), ({"scale": 3}, False), ({"skip_size": 17}, False),
    ({"skip": None}, True), ({"bn_cuda": False}, False),
])
def test_dispatch_rule(change, takes):
    """The kernel only for float32 contiguous CUDA tensors (``unet_join``
    makes a CUDA ``conv_out`` and skip contiguous first), a blur, scale 2
    or 4 and a skip of the upsampled size."""
    scale = change.get("scale", 2)
    kw = {k: change[k] for k in ("cuda", "dtype", "layout") if k in change}
    conv = _fake((2, 4 * scale * scale, 8, 8), **kw)
    bn = (_fake((4 * scale * scale,), cuda=change.get("bn_cuda", True)),) * 2
    size = change.get("skip_size", 8 * scale)
    skip = change.get("skip", _fake((2, 3, size, size),
                                    layout=change.get("skip_layout", torch.contiguous_format)))
    skip_bn = (_fake((3,)),) * 2 if skip is not None else None
    assert uj._takes_kernel(conv, scale, bn, skip, skip_bn, change.get("blur", True)) is takes


@pytest.mark.parametrize("name", ["DeOldifyWide", "DeOldifyDeep", "DDColor"])
def test_state_dict_unchanged(name):
    """Names and shapes of the published widths, against the frozen copy."""
    with torch.device("meta"):
        if name == "DDColor":
            new, old = tdd.DDColor.from_config("large"), rdd.DDColor.from_config("large")
        else:
            new, old = getattr(tdo, name)(), getattr(rdo, name)()
    assert [(k, v.shape) for k, v in new.state_dict().items()] == \
        [(k, v.shape) for k, v in old.state_dict().items()]


# --- on the card ------------------------------------------------------------------

# the 9 sites of a 384² frame, batch 8: (conv_out channels, H, scale, BN,
# skip channels or None, skip BN, layouts of conv_out and the skip as the
# models hand them over on the card: DDColor's skips are channels-last
# views of its encoder features, and so is its first block's conv_out;
# ``unet_join`` copies them to contiguous tensors)
SITES = {
    "deoldify_up0": (2048, 12, 2, True, 1024, True, ("nchw", "nchw")),
    "deoldify_up1": (2048, 24, 2, True, 512, True, ("nchw", "nchw")),
    "deoldify_up2": (2048, 48, 2, True, 256, True, ("nchw", "nchw")),
    "deoldify_up3": (1024, 96, 2, True, 64, True, ("nchw", "nchw")),
    "deoldify_final_shuf": (1024, 192, 2, False, 3, False, ("nchw", "nchw")),
    "ddcolor_layer0": (2048, 12, 2, True, 768, True, ("nhwc", "nhwc")),
    "ddcolor_layer1": (2048, 24, 2, True, 384, True, ("nchw", "nhwc")),
    "ddcolor_layer2": (1024, 48, 2, True, 192, True, ("nchw", "nhwc")),
    "ddcolor_last_shuf": (4096, 96, 4, False, None, False, ("nchw", "nchw")),
}


def _site_inputs(cr, h, w, scale, use_bn, s, skip_bn, layouts=("nchw", "nchw"), n=8, seed=0,
                 offset=0, special=False):
    """Inputs on the card, ``conv_out`` and the skip in ``layouts`` ("nhwc":
    a channels-last view); ``offset`` > 0 starts the tensors that many
    floats into their storage (not 16-byte aligned); ``special`` puts
    negatives, signed zeros, infinities and NaN among them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, layout="nchw"):
        if layout == "nhwc":
            nn_, c, hh, ww = shape
            return flat(nn_, hh, ww, c).permute(0, 3, 1, 2)
        return flat(*shape)

    def flat(*shape):
        x = torch.randn(int(torch.Size(shape).numel()) + offset, generator=g, device="cuda")
        if special:
            k = x.numel()
            idx = torch.randint(0, k, (max(k // 16, 8),), generator=g, device="cuda")
            vals = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, -1.0,
                                 -3e38, 3e38], device="cuda")
            x[idx] = vals[torch.arange(idx.numel(), device="cuda") % vals.numel()]
        return x[offset:].view(shape)

    conv = t(n, cr, h, w, layout=layouts[0])
    bn = (1 + 0.1 * t(cr), 0.1 * t(cr)) if use_bn else None
    skip = None if s is None else t(n, s, scale * h, scale * w, layout=layouts[1])
    sbn = (1 + 0.1 * t(s), 0.1 * t(s)) if skip_bn else None
    if special and bn is not None:  # a zero and a negative scale, an infinite shift
        bn[0][:3] = torch.tensor([0.0, -1.0, -0.0], device="cuda")
        bn[1][3:5] = torch.tensor([float("inf"), -0.0], device="cuda")
    return conv, bn, skip, sbn


def _check(conv, scale, bn, skip, sbn):
    """One launch, the plain chain's bits, in the plain chain's layout (on
    the card contiguous, whatever the inputs' layout)."""
    reset_counters(*COUNTERS)
    got = uj.unet_join(conv, scale, bn, skip=skip, skip_bn=sbn)
    want = uj.unet_join_reference(conv, scale, bn, skip=skip, skip_bn=sbn)
    torch.cuda.synchronize()
    assert same_bits(got, want)
    assert got.stride() == want.stride()
    assert counters().get("unet_join_launches") == 1 and counters().get("unet_join_calls") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(SITES))
def test_kernel_at_the_sites(site):
    _need_cuda()
    cr, h, scale, use_bn, s, skip_bn, layouts = SITES[site]
    conv, bn, skip, sbn = _site_inputs(cr, h, h, scale, use_bn, s, skip_bn, layouts)
    _check(conv, scale, bn, skip, sbn)


# (conv_out channels, H, W, scale, BN, skip channels, skip BN, storage offset)
ODD = {
    "odd_r2_skip": (12, 5, 7, 2, True, 5, True, 0),
    "odd_r4_copy": (16, 7, 9, 4, False, 3, False, 0),
    "c1_r4_none": (16, 3, 5, 4, True, None, False, 0),
    "c1_r2_skip_s1": (4, 1, 1, 2, True, 1, True, 0),
    "r4_wide_none": (32, 9, 131, 4, False, None, False, 0),
    "r2_tall_skip": (8, 133, 12, 2, True, 2, True, 0),
    "misaligned_r2_skip": (8, 12, 16, 2, True, 3, True, 1),
    "misaligned_r4_copy": (16, 6, 8, 4, False, 2, False, 3),
    "r2_many_tiles": (8, 100, 200, 2, True, 6, True, 0),
    "groups_r2_skip": (280, 9, 11, 2, True, 10, True, 0),
    "groups_r4_none": (1104, 5, 6, 4, False, None, False, 0),
    "narrow_tall_r2_skip": (4, 600, 3, 2, True, 1, True, 0),
    "narrow_tall_r4_none": (16, 300, 4, 4, False, None, False, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ODD))
def test_kernel_at_odd_sizes(case):
    _need_cuda()
    cr, h, w, scale, use_bn, s, skip_bn, offset = ODD[case]
    conv, bn, skip, sbn = _site_inputs(cr, h, w, scale, use_bn, s, skip_bn, n=2, seed=1,
                                       offset=offset)
    _check(conv, scale, bn, skip, sbn)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd_r2_skip", "odd_r4_copy", "c1_r4_none", "r2_many_tiles",
                                  "groups_r2_skip"])
def test_kernel_on_special_values(case):
    _need_cuda()
    cr, h, w, scale, use_bn, s, skip_bn, offset = ODD[case]
    conv, bn, skip, sbn = _site_inputs(cr, h, w, scale, use_bn, s, skip_bn, n=2, seed=2,
                                       special=True)
    assert bool(conv.isnan().any()) and bool(conv.isinf().any())
    _check(conv, scale, bn, skip, sbn)


@pytest.mark.cuda
def test_cuda_cases_the_kernel_does_not_take():
    """bf16, no blur and a skip of another size take the plain chain on
    the card: counted as calls, not as launches."""
    _need_cuda()
    conv, bn, skip, sbn = _site_inputs(16, 6, 6, 2, True, 3, True, n=2)
    reset_counters(*COUNTERS)
    for kw in (dict(skip=skip, skip_bn=sbn, blur=False),
               dict(skip=skip[:, :, :11, :11].contiguous(), skip_bn=sbn)):
        assert same_bits(uj.unet_join(conv, 2, bn, **kw),
                         uj.unet_join_reference(conv, 2, bn, **kw))
    half = conv.to(torch.bfloat16)
    fold = tuple(v.to(torch.bfloat16) for v in bn)
    assert same_bits(uj.unet_join(half, 2, fold), uj.unet_join_reference(half, 2, fold))
    assert counters().get("unet_join_calls") == 3
    assert counters().get("unet_join_launches", 0) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,sites", [("DeOldifyWide", 5), ("DDColor", 4)])
def test_model_forward_kernel_against_plain_chain(monkeypatch, name, sites):
    """A whole forward at 384², batch 2, published width, seeded weights:
    the kernel against the plain chain, bit for bit, one launch a site."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = tdd.DDColor.from_config("large") if name == "DDColor" else tdo.DeOldifyWide()
    model = seeded(model, 7).cuda()
    x = torch.rand(2, 3, 384, 384, generator=torch.Generator().manual_seed(4)).cuda()
    with torch.no_grad():
        reset_counters(*COUNTERS)
        got = model(x)
        torch.cuda.synchronize()
        c = counters()
        assert c.get("unet_join_launches") == sites and c.get("unet_join_calls") == sites
        monkeypatch.setattr(tdo, "unet_join", uj.unet_join_reference)
        want = model(x)
    assert bool(torch.isfinite(want).all())
    assert same_bits(got, want)
