"""The port's device mesh, sharded steps and halo exchange against the JAX
package's, on the CPU.

The JAX package runs on the 8 virtual CPU devices tests/conftest.py sets
up; the port on ``make_mesh(8, platform="cpu")``, eight logical shards of
the CPU (one process, as the JAX package is single-controller).  Each
sharded function is held against the JAX one on the same numpy inputs
and against the port's own one-shard run:

* ``make_mesh`` shapes and errors; ``shard_frames``/``Sharded.gather``
  and ``replicate``;
* ``sharded_pipeline_step`` (merges 2, 3 and the frame-level 5, frames
  over ``data`` and rows over ``model``), ``sharded_engine_step`` (a
  micro DDColor, the JAX ``init_params`` tree carried across with
  ``state_dict_from_flax``) and ``sharded_classic_pipeline`` (nano
  DeOldify, micro DDColor);
* ``halo_exchange_rows`` and ``spatial_halo_call`` (a 5x5 box blur with
  halo 2 over four row shards);
* ``deepex_propagate(mesh=...)``, ``remaster_propagate(mesh=...)`` and
  ``colormnet_propagate_scenes(mesh=...)`` against the JAX package's with
  a mesh, as tests/test_exemplar_scenes.py runs them.

The JAX ``init_params`` of the engines are replaced by weights seeded with
numpy at ``jax.eval_shape``'s shapes (``seeded_params``), so no flax init
is compiled.  Tolerances: 1e-5 where only pixel arithmetic differs (and
between the port's sharded and one-shard runs), 1e-4 through models (the
exemplar tolerance), Deep-Exemplar's hard argmax by the share of moved
values (at most 2 % more than 1e-4 apart, as tests/test_torch_deepex.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu import exemplar as jex
from havc_tpu import parallel as jpar
from havc_tpu.models import ddcolor as jdd
from havc_tpu.models import deoldify as jdo
from havc_tpu.utils import jitcache

from havc_tpu_torch import exemplar as tex
from havc_tpu_torch import parallel as tpar
from havc_tpu_torch.models.bridge import state_dict_from_flax

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_deepex import JaxDeepEx, PortDeepEx, deepex_net, deepex_trees, scene_inputs
from test_torch_exemplar_surface import (  # noqa: F401  (seeded_colormnet: a fixture)
    _SeededEngine,
    seeded_colormnet,
    seeded_params,
)
from test_torch_remaster import JaxRemaster, remaster_net, remaster_tree

TOL = 1e-4
PIX = 1e-5


def cpu_mesh(data=8, model=1):
    return tpar.make_mesh(data * model, data=data, model=model, platform="cpu")


@pytest.fixture(scope="module", autouse=True)
def jax_cache():
    """The JAX package's compiled functions, kept for the module only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        yield


@pytest.fixture
def seeded_init(monkeypatch):
    """The JAX engines' ``init_params`` replaced by numpy-seeded weights."""
    def init(seed):
        return lambda model, input_size=64, seed=0: {"params": seeded_params(
            model, seed, jnp.zeros((1, input_size, input_size, 3)))}

    monkeypatch.setattr(jdd, "init_params", init(41))
    monkeypatch.setattr(jdo, "init_params", init(42))


def frames_rgb(t, h, w, seed):
    return np.random.default_rng(seed).random((t, h, w, 3), dtype=np.float32)


# --- the mesh ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,data,model", [(8, None, 1), (8, 4, 2), (8, None, 2), (1, None, 1)])
def test_make_mesh_shapes_match_jax(n, data, model):
    got = tpar.make_mesh(n, data=data, model=model, platform="cpu")
    want = jpar.make_mesh(n, data=data, model=model)
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape and got.size == n
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    assert got.data_devices() == [torch.device("cpu")] * got.shape["data"]


def test_make_mesh_errors():
    with pytest.raises(ValueError):
        tpar.make_mesh(6, data=4, model=2, platform="cpu")  # 6 devices are not 4 x 2
    with pytest.raises(ValueError):
        tpar.make_mesh(2, platform="tpu")
    if torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="need 64 devices"):
            tpar.make_mesh(64)


def test_shard_gather_replicate():
    mesh = cpu_mesh(2, 4)
    x = torch.from_numpy(frames_rgb(4, 16, 6, 0))
    s = tpar.shard_frames(x, mesh)
    assert s.blocks.shape == (2, 4) and s.blocks[1, 3].shape == (2, 4, 6, 3)
    assert torch.equal(s.blocks[1, 3], x[2:4, 12:16])
    assert torch.equal(s.gather(), x)
    x8 = torch.from_numpy(frames_rgb(8, 4, 2, 1))
    flat = tpar.Sharded.split(x8, mesh, (("data", "model"),))
    assert torch.equal(flat.blocks[1, 2], x8[6:7]) and torch.equal(flat.gather(), x8)
    with pytest.raises(ValueError, match="does not split"):
        tpar.Sharded.split(x[:3], mesh, ("data", "model"))
    net = torch.nn.Linear(3, 2)
    rep = tpar.replicate((net, x), mesh)
    assert list(rep) == [torch.device("cpu")] and rep[torch.device("cpu")][0] is net


# --- the sharded steps ------------------------------------------------------------------


@pytest.mark.parametrize("method", [2, 3, 5])
def test_sharded_pipeline_step(method):
    frames = frames_rgb(8, 32, 32, 2)
    jmesh = jpar.make_mesh(8, data=4, model=2)
    with jmesh:
        want, want_l = jpar.sharded_pipeline_step(jmesh, method=method)(jnp.asarray(frames))
    got, got_l = tpar.sharded_pipeline_step(cpu_mesh(4, 2), method=method)(
        torch.from_numpy(frames))
    one, one_l = tpar.sharded_pipeline_step(cpu_mesh(1), method=method)(torch.from_numpy(frames))
    assert got.shape == frames.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= PIX
    assert abs(got_l.item() - float(want_l)) <= PIX
    assert (got - one).abs().max().item() <= PIX and abs(got_l.item() - one_l.item()) <= PIX


def test_sharded_engine_step(seeded_init):
    frames = frames_rgb(8, 64, 64, 3)
    jmesh = jpar.make_mesh(8, data=4, model=2)
    jstep, jparams = jpar.sharded_engine_step(jmesh, config="micro", input_size=64)
    with jmesh:
        want, want_l = jstep(jparams, jnp.asarray(frames))
    params = state_dict_from_flax(jparams["params"])
    step, own = tpar.sharded_engine_step(cpu_mesh(4, 2), config="micro", input_size=64)
    assert set(own) == set(params)
    got, got_l = step(params, torch.from_numpy(frames))
    one, one_l = tpar.sharded_engine_step(cpu_mesh(1), config="micro", input_size=64)[0](
        params, torch.from_numpy(frames))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    assert abs(got_l.item() - float(want_l)) <= PIX
    assert (got - one).abs().max().item() <= PIX


def test_sharded_classic_pipeline(seeded_init):
    frames = frames_rgb(8, 48, 80, 4)
    kw = dict(do_encoder="nano", dd_config="micro", rf=4, input_size=64)
    jmesh = jpar.make_mesh(8)
    jstep, (jdo_p, jdd_p) = jpar.sharded_classic_pipeline(jmesh, **kw)
    with jmesh:
        want, want_l = jstep(jdo_p, jdd_p, jnp.asarray(frames))
    do_p, dd_p = (state_dict_from_flax(p["params"]) for p in (jdo_p, jdd_p))
    step, _ = tpar.sharded_classic_pipeline(cpu_mesh(8), **kw)
    got, got_l = step(do_p, dd_p, torch.from_numpy(frames))
    one, one_l = tpar.sharded_classic_pipeline(cpu_mesh(1), **kw)[0](do_p, dd_p,
                                                                     torch.from_numpy(frames))
    assert got.shape == frames.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    assert abs(got_l.item() - float(want_l)) <= PIX
    assert (got - one).abs().max().item() <= PIX


# --- halo exchange ----------------------------------------------------------------------


def blur5_torch(x):
    xp = torch.cat([x[:, :1].expand(-1, 2, -1, -1), x, x[:, -1:].expand(-1, 2, -1, -1)], 1)
    xp = torch.cat([xp[:, :, :1].expand(-1, -1, 2, -1), xp,
                    xp[:, :, -1:].expand(-1, -1, 2, -1)], 2)
    h, w = x.shape[1], x.shape[2]
    return sum(xp[:, i:i + h, j:j + w] for i in range(5) for j in range(5)) / 25.0


def blur5_jax(x):
    xp = jnp.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="edge")
    h, w = x.shape[1], x.shape[2]
    return sum(xp[:, i:i + h, j:j + w] for i in range(5) for j in range(5)) / 25.0


def test_halo_exchange_rows():
    mesh = cpu_mesh(1, 4)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1, 1)
    ext = tpar.halo_exchange_rows(tpar.shard_frames(x, mesh), 2, "model")
    rows = [b.reshape(-1).tolist() for b in ext.blocks[0]]
    assert rows[0] == [0, 0, 0, 1, 2, 3, 4, 5]  # the top edge replicated
    assert rows[1] == [2, 3, 4, 5, 6, 7, 8, 9]
    assert rows[3] == [10, 11, 12, 13, 14, 15, 15, 15]  # the bottom edge replicated
    with pytest.raises(ValueError, match="does not split one"):  # "model" splits no dimension
        tpar.halo_exchange_rows(tpar.Sharded.split(x, mesh, ("data",)), 2, "model")


def test_spatial_halo_call():
    x = frames_rgb(4, 16, 12, 5)
    jmesh = jpar.make_mesh(8, data=2, model=4)
    with jmesh:
        want = np.asarray(jpar.spatial_halo_call(jmesh, blur5_jax, halo=2)(jnp.asarray(x)))
    got = tpar.spatial_halo_call(cpu_mesh(2, 4), blur5_torch, halo=2)(torch.from_numpy(x))
    whole = blur5_torch(torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= PIX
    assert (got - whole).abs().max().item() <= 1e-6


# --- the exemplar engines over a mesh ---------------------------------------------------


def test_deepex_propagate_mesh():
    """Frame batches split over 8 shards (batch 4 rounded up to 8: one
    frame a shard) against the JAX package's on 8 devices, and equal to the
    port's unsharded run one frame a batch (the same arithmetic)."""
    trees, gray_refs = deepex_trees(), scene_inputs()
    gray, refs, is_ref = gray_refs
    kw = dict(wls_filter=False)
    with jpar.make_mesh(8) as jmesh:
        want = np.asarray(jex.deepex_propagate(JaxDeepEx(trees), gray, refs, is_ref,
                                               mesh=jmesh, **kw))
    eng = PortDeepEx(deepex_net(trees))
    got = tex.deepex_propagate(eng, gray, refs, is_ref, mesh=cpu_mesh(8), **kw)
    one = tex.deepex_propagate(eng, gray, refs, is_ref, batch_size=1, **kw)
    assert isinstance(got, torch.Tensor) and got.shape == gray.shape
    assert np.mean(np.abs(got.numpy() - want) > 1e-4) <= 0.02
    assert torch.equal(got, one)


def test_remaster_propagate_mesh():
    """Window groups split over 8 shards (group 4 rounded up to 8)."""
    tree = remaster_tree()
    rng = np.random.default_rng(8)
    frames = rng.random((13, 32, 48, 3), dtype=np.float32)
    refs = rng.random((8, 32, 48, 3), dtype=np.float32)
    kw = dict(ref_positions=np.array([0, 2, 3, 5, 7, 9, 10, 12]), ref_buffer_size=4)
    with jpar.make_mesh(8) as jmesh:
        want = np.asarray(jex.remaster_propagate(JaxRemaster(tree), frames, refs, mesh=jmesh,
                                                 **kw))
    eng = tex.RemasterEngine.__new__(tex.RemasterEngine)
    eng.size, eng.device, eng.model = 320, torch.device("cpu"), remaster_net(tree)
    got = tex.remaster_propagate(eng, frames, refs, mesh=cpu_mesh(8), **kw)
    one = tex.remaster_propagate(eng, frames, refs, **kw)
    assert isinstance(got, torch.Tensor) and got.shape == frames.shape
    assert np.abs(got.numpy() - want).max() <= TOL
    assert (got - one).abs().max().item() <= PIX


def test_colormnet_propagate_scenes_mesh(seeded_colormnet):  # noqa: F811
    """Six scenes split over 8 shards (padded with copies of scene 0), on
    a 32x48 engine."""
    tree, net = seeded_colormnet
    je = _SeededEngine(tree, work_size=(32, 48))
    te = tex.ColorMNetEngine(config="micro", work_size=(32, 48), device="cpu")
    te.net = net
    rng = np.random.default_rng(6)
    frames = rng.random((16, 32, 48, 3), dtype=np.float32)
    ref_ab = (rng.random((16, 32, 48, 2), dtype=np.float32) * 2 - 1) * 0.4
    is_ref = np.zeros(16, bool)
    is_ref[[0, 3, 6, 9, 12, 14]] = True
    with jpar.make_mesh(8) as jmesh:
        want = jex.colormnet_propagate_scenes(je, frames, ref_ab, is_ref, mesh=jmesh)
    got = tex.colormnet_propagate_scenes(te, frames, ref_ab, is_ref, mesh=cpu_mesh(8))
    one = tex.colormnet_propagate_scenes(te, frames, ref_ab, is_ref)
    assert np.abs(got.numpy() - want).max() <= TOL
    assert (got - one).abs().max().item() <= PIX
