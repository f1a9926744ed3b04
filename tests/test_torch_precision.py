"""The port's float32 precision rule (``havc_tpu_torch/utils/precision.py``):
engines reduced, everything else IEEE, as the JAX package runs its engines
at XLA's DEFAULT precision and pins ``Precision.HIGHEST`` elsewhere.

On the CPU every product is IEEE float32 whatever the flags say, so these
tests hold the decisions: what the resolver returns for a CPU and a CUDA
device under each way a caller sets PyTorch's flags, that the contexts
restore and nest, which flags the pinned functions and the engine doors
run their products under (recorded at the moment of the product), that
importing the port sets no flag, and that ``HAVC_main`` with the process
set to TF32 gives the CPU's result, held against the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import havc_tpu
import havc_tpu.engines as jengines
from havc_tpu.clip import Clip as JClip
from havc_tpu.models import ddcolor as jdd
from havc_tpu.models import deoldify as jdo
from havc_tpu.utils import jitcache

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import exemplar
from havc_tpu_torch.models import colormnet as cm
from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import deepex as dx
from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.models import zhang as tzh
from havc_tpu_torch.ops import merge, resize, window_attn
from havc_tpu_torch.scene import edges
from havc_tpu_torch.utils import precision
from havc_tpu_torch.models.bridge import state_dict_from_flax

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_exemplar_surface import seeded_params
from test_torch_main_path import TOL, _gray_clip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IEEE = dict.fromkeys(("matmul", "conv", "rnn"), "ieee")
TF32 = dict.fromkeys(("matmul", "conv", "rnn"), "tf32")


def _state():
    """Every float32 flag PyTorch reports, the legacy reads included."""
    return dict(precision.fp32_flags(), matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                matmul_precision=torch.get_float32_matmul_precision())


@pytest.fixture(autouse=True)
def flags_restored():
    """Each test may set the process's flags through either API; they are
    put back afterwards, the legacy booleans and the matmul enum first."""
    found = _state()
    yield
    torch.set_float32_matmul_precision(found["matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = found["matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = found["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.fp32_precision = found["matmul"]
    torch.backends.cudnn.conv.fp32_precision = found["conv"]
    torch.backends.cudnn.rnn.fp32_precision = found["rnn"]
    assert _state() == found


@pytest.fixture
def process_tf32():
    """The process set to TF32 for matmuls and cuDNN convolutions, as
    ``torch.set_float32_matmul_precision("high")`` on PyTorch's defaults
    leaves it."""
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    torch.backends.cudnn.rnn.fp32_precision = "tf32"


def _ask_matmul_ieee():
    torch.backends.cuda.matmul.fp32_precision = "ieee"


def _ask_conv_ieee():
    torch.backends.cudnn.conv.fp32_precision = "ieee"


def _legacy_matmul_off():
    torch.backends.cuda.matmul.allow_tf32 = False


def _legacy_cudnn_off():
    torch.backends.cudnn.allow_tf32 = False


def _highest():
    torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("ask", [_ask_matmul_ieee, _ask_conv_ieee, _legacy_matmul_off,
                                 _legacy_cudnn_off, _highest])
def test_resolver_follows_the_callers_flags(ask):
    """TF32 on a CUDA device at PyTorch's defaults, IEEE under each way a
    caller asks for it; IEEE on the CPU whatever the flags."""
    assert precision.engine_fp32_precision(torch.device("cuda")) == precision.TF32
    assert precision.engine_fp32_precision("cuda:0") == precision.TF32
    assert precision.engine_fp32_precision(torch.device("cpu")) == precision.IEEE
    torch.set_float32_matmul_precision("high")  # a caller's TF32 stays TF32
    assert precision.engine_fp32_precision(torch.device("cuda")) == precision.TF32
    torch.backends.cuda.matmul.fp32_precision = "none"
    ask()
    assert precision.engine_fp32_precision(torch.device("cuda")) == precision.IEEE
    assert precision.engine_fp32_precision(torch.device("cpu")) == precision.IEEE


def test_import_sets_no_flag():
    """A fresh interpreter reports the same flags before and after
    ``import havc_tpu_torch`` (every submodule imported)."""
    code = (
        "import importlib, pkgutil, torch\n"
        "def state():\n"
        "    b = torch.backends\n"
        "    return (b.cuda.matmul.fp32_precision, b.cudnn.conv.fp32_precision,\n"
        "            b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision, b.fp32_precision,\n"
        "            b.mkldnn.fp32_precision, b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,\n"
        "            torch.get_float32_matmul_precision())\n"
        "before = state()\n"
        "import havc_tpu_torch\n"
        "for m in pkgutil.walk_packages(havc_tpu_torch.__path__, 'havc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert state() == before, (before, state())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO, timeout=120)


@pytest.mark.parametrize("outer", ["engine", "ieee"])
def test_contexts_restore_and_nest(outer):
    found = precision.fp32_flags()
    enter = (lambda: precision.engine_precision("cuda")) if outer == "engine" \
        else precision.ieee_precision
    with enter() as value:
        assert precision.fp32_flags() == dict.fromkeys(found, value)
        with precision.ieee_precision():
            assert precision.fp32_flags() == IEEE
            with precision.engine_precision("cuda"):  # the innermost wins
                assert precision.fp32_flags() == IEEE  # the caller's IEEE is outside
            with precision.engine_precision("cpu"):
                assert precision.fp32_flags() == IEEE
        assert precision.fp32_flags() == dict.fromkeys(found, value)
    assert precision.fp32_flags() == found
    with pytest.raises(ZeroDivisionError):
        with enter():
            with precision.ieee_precision():
                1 / 0
    assert precision.fp32_flags() == found
    torch.backends.cuda.matmul.fp32_precision = "ieee"  # the caller's IEEE
    with precision.engine_precision("cuda"):
        assert precision.fp32_flags() == IEEE
    with precision.ieee_precision():
        with precision.engine_precision("cuda"):
            assert precision.fp32_flags() == IEEE
    assert precision.fp32_flags()["matmul"] == "ieee"


def recorder(fn):
    """``fn`` wrapped to keep the flags at each of its calls in
    ``.seen`` (a function, so that it binds as a method too)."""
    def wrapped(*args, **kwargs):
        wrapped.seen.append(precision.fp32_flags())
        return fn(*args, **kwargs)

    wrapped.seen = []
    return wrapped


def _rng_tensor(rng, *shape):
    return torch.from_numpy(rng.random(shape, dtype=np.float32))


def _run_resize(rng):
    resize.resize(_rng_tensor(rng, 2, 12, 16, 3), 7, 9, "spline64")


def _run_bilinear(rng):
    resize.bilinear_nchw(_rng_tensor(rng, 1, 3, 12, 16), 6, 20)


def _run_similarity(rng):
    cm.get_similarity(_rng_tensor(rng, 10, 8), _rng_tensor(rng, 10), _rng_tensor(rng, 6, 8),
                      _rng_tensor(rng, 6, 8))
    cm.get_similarity(_rng_tensor(rng, 10, 8), None, _rng_tensor(rng, 6, 8), None)


def _run_window_attn(rng):
    window_attn.window_attn_reference(_rng_tensor(rng, 1, 5, 6, 4), _rng_tensor(rng, 1, 5, 6, 4),
                                      _rng_tensor(rng, 1, 5, 6, 3), _rng_tensor(rng, 1, 5, 6, 9),
                                      max_dis=1)


def _run_laplacian(rng):
    merge._laplacian(_rng_tensor(rng, 2, 9, 11))


def _run_edges(rng):
    edges._conv2d(_rng_tensor(rng, 2, 9, 11), edges._KIRSCH)


# (function driven, module attribute holding the product it reaches)
PINNED = {
    "resize": (_run_resize, (torch, "einsum")),
    "bilinear_nchw": (_run_bilinear, (torch, "einsum")),
    "get_similarity": (_run_similarity, (torch.Tensor, "__matmul__")),
    "window_attn_reference": (_run_window_attn, (torch, "einsum")),
    "_laplacian": (_run_laplacian, (torch.nn.functional, "conv2d")),
    "edges._conv2d": (_run_edges, (edges, "_correlate")),
}


@pytest.mark.parametrize("name", list(PINNED))
def test_pinned_functions_compute_at_ieee(name, process_tf32, monkeypatch):
    """With the process at TF32, every product of the functions the JAX
    package pins to HIGHEST (or computes exactly) sees IEEE flags, and the
    process's flags are back afterwards."""
    run, (owner, attr) = PINNED[name]
    rec = recorder(getattr(owner, attr))
    monkeypatch.setattr(owner, attr, rec)
    run(np.random.default_rng(3))
    assert rec.seen and all(s == IEEE for s in rec.seen), rec.seen
    assert precision.fp32_flags() == TF32


@pytest.fixture
def card_decision(monkeypatch):
    """The resolver decides as for a CUDA device, whatever device the
    engines were given."""
    resolve = precision.engine_fp32_precision
    monkeypatch.setattr(precision, "engine_fp32_precision", lambda device: resolve("cuda"))


class _Stub(torch.nn.Module):
    """Stands in for an engine's network in the registry."""


def _record_model(monkeypatch, module, attr="colorize"):
    rec = recorder(lambda m, frames, **kw: frames)
    monkeypatch.setattr(module, attr, rec)
    return rec


def _door_deoldify(monkeypatch):
    monkeypatch.setattr(tengines.registry, "deoldify", lambda name, device=None: _Stub())
    rec = _record_model(monkeypatch, tdo)
    fn = tengines.make_deoldify_fn(2, 4, device="cpu")  # Artistic: two networks
    fn(torch.zeros(1, 8, 8, 3))
    return rec.seen


def _door_ddcolor(monkeypatch):
    monkeypatch.setattr(tengines.registry, "ddcolor", lambda name, device=None: _Stub())
    monkeypatch.setattr(tengines.registry, "zhang", lambda name, device=None: _Stub())
    rec_dd, rec_zh = _record_model(monkeypatch, tdd), _record_model(monkeypatch, tzh)
    for model in (1, 2):  # DDColor, then a Zhang net through the DDColor door
        tengines.make_ddcolor_fn(model, 4, device="cpu")(torch.zeros(1, 8, 8, 3))
    return rec_dd.seen + rec_zh.seen


def _door_zhang(monkeypatch):
    monkeypatch.setattr(tengines.registry, "zhang", lambda name, device=None: _Stub())
    rec = _record_model(monkeypatch, tzh)
    tengines.zhang_frames(torch.zeros(1, 8, 8, 3), device="cpu")
    return rec.seen


def _door_deepex(monkeypatch):
    rec_ref = recorder(lambda vgg, warp, ib_lab: None)
    rec = recorder(lambda vgg, warp, color, chunk, *ref: chunk[..., 1:])
    monkeypatch.setattr(dx, "encode_reference", rec_ref)
    monkeypatch.setattr(dx, "frame_colorization_batched", rec)
    engine = exemplar.DeepExEngine.__new__(exemplar.DeepExEngine)
    engine.device, engine.vgg, engine.warp, engine.color = torch.device("cpu"), None, None, None
    frames = torch.rand(5, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    exemplar.deepex_propagate(engine, frames, frames, np.array([1, 0, 0, 1, 0], bool),
                              wls_filter=False)
    return rec_ref.seen + rec.seen


DOORS = {"make_deoldify_fn": _door_deoldify, "make_ddcolor_fn": _door_ddcolor,
         "zhang_frames": _door_zhang, "deepex_propagate": _door_deepex}


@pytest.mark.parametrize("name", list(DOORS))
def test_engine_doors_enter_the_engine_context(name, card_decision, monkeypatch):
    """Each engine door runs its network inside ``engine_precision``: at
    PyTorch's defaults the network's forward sees TF32 flags, under the
    caller's IEEE setting IEEE ones, and the flags are back afterwards."""
    found = precision.fp32_flags()
    seen = DOORS[name](monkeypatch)
    assert seen and all(s == TF32 for s in seen), seen
    assert precision.fp32_flags() == found
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    seen = DOORS[name](monkeypatch)
    assert seen and all(s == IEEE for s in seen), seen


class _Stop(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_exemplar_engines_enter_it_at_float32_only(dtype, card_decision, monkeypatch):
    """ColorMNet and NetworkC enter the engine context when their network
    runs float32; a bf16 network runs under the process's flags (its
    products are bf16, or IEEE where pinned).  The context is left on an
    exception too."""
    found = precision.fp32_flags()
    want = TF32 if dtype == torch.float32 else found
    engine = exemplar.ColorMNetEngine.__new__(exemplar.ColorMNetEngine)
    engine.device, engine.dtype = torch.device("cpu"), dtype

    def stop(*args, **kwargs):
        seen.append(precision.fp32_flags())
        raise _Stop

    monkeypatch.setattr(exemplar, "_build_cm_step", lambda *a, **k: None)
    monkeypatch.setattr(exemplar, "_cm_prepare", stop)
    frames, ab = torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 2)
    for propagate in (exemplar.colormnet_propagate, exemplar.colormnet_propagate_scenes):
        seen = []
        with pytest.raises(_Stop):
            propagate(engine, frames, ab, np.array([True, False]))
        assert seen == [want]
        assert precision.fp32_flags() == found

    remaster = exemplar.RemasterEngine.__new__(exemplar.RemasterEngine)
    remaster.device, remaster.dtype = torch.device("cpu"), dtype
    remaster.model = type("Net", (), {"encode_refs": staticmethod(stop)})()
    seen = []
    with pytest.raises(_Stop):
        exemplar.remaster_propagate(remaster, frames, frames)
    assert seen == [want]
    assert precision.fp32_flags() == found


def _seeded_pair(jmodel, tmodel, seed):
    """Numpy-seeded weights (no compiled ``init``) in both packages."""
    params = {"params": seeded_params(jmodel, seed, np.zeros((1, 64, 64, 3), np.float32))}
    tmodel.load_state_dict(state_dict_from_flax(params["params"]))
    return params, tmodel.eval().requires_grad_(False)


def test_havc_main_at_tf32_flags_equals_the_cpu_default(process_tf32, monkeypatch):
    """A small ``HAVC_main`` on the CPU with the process set to TF32 equals
    the run at PyTorch's defaults bit for bit, and the JAX package within
    the main-path test's tolerance."""
    jp_do, tm_do = _seeded_pair(jdo.DeOldifyWide(encoder="nano", nf_factor=1),
                                tdo.DeOldifyWide(encoder="nano", nf_factor=1), 0)
    jp_dd, tm_dd = _seeded_pair(jdd.DDColor.from_config("micro"),
                                tdd.DDColor.from_config("micro"), 1)
    cpu = torch.device("cpu")
    monkeypatch.setattr(jitcache, "_CACHE", {})
    monkeypatch.setitem(jengines.registry._cache, ("deoldify", "video"),
                        (jdo.DeOldifyWide(encoder="nano", nf_factor=1), jp_do))
    monkeypatch.setitem(jengines.registry._cache, ("ddcolor", "artistic"),
                        (jdd.DDColor.from_config("micro"), jp_dd))
    j_do, j_dd = jengines.make_deoldify_fn, jengines.make_ddcolor_fn
    monkeypatch.setattr(jengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24: j_do(model, 4))
    monkeypatch.setattr(jengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: j_dd(model, 4, **kw))
    monkeypatch.setitem(tengines.registry._cache, ("deoldify", "video", cpu), tm_do)
    monkeypatch.setitem(tengines.registry._cache, ("ddcolor", "artistic", cpu), tm_dd)
    t_do, t_dd = tengines.make_deoldify_fn, tengines.make_ddcolor_fn
    monkeypatch.setattr(tengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24, **kw: t_do(model, 4, **kw))
    monkeypatch.setattr(tengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: t_dd(model, 4, **kw))

    frames = _gray_clip()[:4]  # one batch: one JAX compile

    def port():
        return havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames.copy()),
                                        batch_size=4, device="cpu").frames

    at_tf32 = port()
    assert precision.fp32_flags() == TF32
    torch.backends.cuda.matmul.fp32_precision = "none"  # PyTorch's defaults
    assert np.array_equal(at_tf32, port())
    want = np.asarray(havc_tpu.HAVC_main(JClip(frames=frames.copy()), batch_size=4).frames)
    assert np.abs(at_tf32 - want).max() <= TOL
