"""The port's reduced-precision path against the JAX package's, on the CPU.

On its accelerator the JAX package runs ColorMNet and DeepRemaster in
bfloat16 (``dtype=None`` resolves to bf16 on the TPU); the port does the
same on the card (``dtype=None`` is bf16 on CUDA, float32 on the CPU).
Here both packages are built with an explicit bf16 dtype, from the same
numpy-seeded weights (``seeded_params``, carried over with
``state_dict_from_flax``) and the same numpy inputs:

* window attention on bf16 inputs: the port's plain version against the
  JAX package's kernel (``local_window_attention(..., interpret=True)``),
  both computing in float32 from the same bf16 values, within 1e-5
  (``WINDOW_TOL``).  The JAX package's CPU scan takes the unfold branch of
  ``LocalAttention`` instead, which scales q in bf16 (``q / scale``,
  colormnet.py:391-395); against that convention the kernel's result
  differs by up to ``UNFOLD_BF16_GAP``: measured 7.5e-5 at d_qk 8, where
  the bf16 rounding of q / sqrt(8) moves the logits, and 4.5e-8 at d_qk
  16, where the scale is a power of two and exact, as at the published
  d_qk 64;
* the memory on bf16 stores: similarities within 1e-5 of their scale
  (float32 products of the same bf16 operands), the same top-k indices
  at every read, the stores within one bf16 rounding (``STORE_TOL``) and
  the use and life counts within 1e-5 over inserts, reads, consolidations
  and evictions;
* ``colormnet_propagate`` (micro) and ``remaster_propagate`` (NetworkC at
  full width): bf16 rounds at other places in XLA and PyTorch (XLA fuses
  elementwise chains in float32, PyTorch rounds each op), so the two
  bf16 results are not held to each other directly.  Each package's bf16
  result lies within ``BF16_TOL`` of its own float32 result (measured
  here: ColorMNet ab 0.037 in JAX and 0.027 in the port, NetworkC RGB
  0.019 and 0.0093), and the two bf16 results lie within twice the larger
  of those two distances of each other (the ``floor_check`` pattern of
  tests/test_torch_deepex.py).  The float32 results agree within 1e-4;
* both engines resolve ``dtype=None`` to float32 on the CPU.

The JAX scans and NetworkC runs are shared by the tests through
module-scoped fixtures (one bf16 ColorMNet scan, one bf16 NetworkC
propagation, and their float32 twins).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu import exemplar as jex
from havc_tpu.models import colormnet as jcm
from havc_tpu.models import memory as jmem
from havc_tpu.models import remaster as jrm
from havc_tpu.ops import pallas_attn as pa
from havc_tpu.utils import jitcache

from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.models import colormnet as tcm
from havc_tpu_torch.models import memory as tmem
from havc_tpu_torch.ops import window_attn as wa

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_exemplar import _GROUPS, MEM_CFG, _mem_frames
from test_torch_exemplar_surface import seeded_colormnet  # noqa: F401  (fixture)
from test_torch_remaster import remaster_net, remaster_tree

WINDOW_TOL = 1e-5
UNFOLD_BF16_GAP = 1e-3
STORE_TOL = 2.0 ** -7  # relative: one bf16 rounding either way
BF16_TOL = dict(colormnet=0.06, remaster=0.04)  # max abs: ab in [-1, 1], RGB in [0, 1]
F32_TOL = 1e-4


def bf16(a):
    """The same bf16 values in both packages: numpy float32 rounded by torch."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


# --- window attention ------------------------------------------------------------------


@pytest.mark.parametrize("shape,d_vu,max_dis,seed", [((2, 6, 9, 16), 32, 7, 0),
                                                      ((1, 5, 11, 8), 24, 2, 2)])
def test_bf16_window_attention_matches_jax_kernel(shape, d_vu, max_dis, seed):
    rng = np.random.default_rng(seed)
    b, h, w, d_qk = shape
    win2 = (2 * max_dis + 1) ** 2
    ins = [bf16(rng.standard_normal((b, h, w, c)) * sd)
           for c, sd in ((d_qk, 0.3), (d_qk, 0.3), (d_vu, 0.3), (win2, 0.1))]
    got = wa.window_attn_reference(*(t for t, _ in ins), max_dis=max_dis)
    jin = [j for _, j in ins]
    want = np.asarray(pa.local_window_attention(*jin, max_dis=max_dis, interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= WINDOW_TOL
    # the unfold convention: q scaled in bf16 before the float32 products
    unfold = np.asarray(pa.local_window_attention_reference(*jin, max_dis=max_dis))
    gap = np.abs(got.numpy() - unfold).max()
    print(f"bf16 window attention: kernel convention vs q scaled in bf16: {gap:.3e}")
    assert gap <= UNFOLD_BF16_GAP


# --- memory on bf16 stores -------------------------------------------------------------


def _bf16_frames(n, seed):
    return [tuple(bf16(a) for a in frame) for frame in _mem_frames(n, seed)]


def _stores_close(js, ts):
    for name in ("work_valid", "lt_valid", "work_stamp"):
        assert np.array_equal(np.asarray(getattr(js, name)), getattr(ts, name).numpy()), name
    assert int(js.next_stamp) == ts.next_stamp
    for name in ("work_keys", "work_shrink", "work_sel", "work_values",
                 "lt_keys", "lt_shrink", "lt_values"):
        a, t = np.asarray(getattr(js, name), np.float32), getattr(ts, name)
        assert t.dtype == torch.bfloat16, name
        assert np.abs(a - t.float().numpy()).max() <= STORE_TOL * max(1.0, np.abs(a).max()), name
    for name in ("work_use", "work_life", "lt_use", "lt_life"):
        a, t = np.asarray(getattr(js, name)), getattr(ts, name)
        assert t.dtype == torch.float32, name
        assert np.abs(a - t.numpy()).max() <= 1e-5 * max(1.0, np.abs(a).max()), name


def test_bf16_memory_similarity_topk_and_readout_match_jax():
    jcfg, tcfg = jmem.MemoryConfig(**MEM_CFG), tmem.MemoryConfig(**MEM_CFG)
    js = jmem.init_memory(jcfg, dtype=jnp.bfloat16)
    ts = tmem.init_memory(tcfg, dtype=torch.bfloat16)
    j_insert = jax.jit(jmem.insert_working, static_argnums=1)
    j_read = jax.jit(jmem.read_memory, static_argnums=(1, 4))
    j_sim = jax.jit(jcm.get_similarity)
    rng = np.random.default_rng(9)
    W, P = MEM_CFG["max_mt_frames"], MEM_CFG["tokens_per_frame"]
    consolidated = evicted = False
    for i, ((tk, jk), (tsel, jsel), (tv, jv), (tsh, jsh)) in enumerate(_bf16_frames(16, 8)):
        on = i % 5 != 2
        js = j_insert(js, jcfg, jk, jsh, jsel, jv, jnp.asarray(on))
        ts = tmem.insert_working(ts, tcfg, tk, tsh, tsel, tv, on)
        _stores_close(js, ts)
        (tqk, jqk), (tqe, jqe) = bf16(rng.normal(size=(P, 4))), bf16(rng.random((P, 4)) + 0.05)
        # the similarity over [long-term, working] and its top-k, as read_memory takes them
        jmk = jnp.concatenate([js.lt_keys, js.work_keys.reshape(W * P, -1)])
        jms = jnp.concatenate([js.lt_shrink, js.work_shrink.reshape(W * P)])
        tmk = torch.cat([ts.lt_keys, ts.work_keys.reshape(W * P, -1)])
        tms = torch.cat([ts.lt_shrink, ts.work_shrink.reshape(W * P)])
        jsim = np.asarray(j_sim(jmk, jms, jqk, jqe))
        tsim = tcm.get_similarity(tmk, tms, tqk, tqe)
        assert tsim.dtype == torch.float32
        assert np.abs(jsim - tsim.numpy()).max() <= 1e-5 * np.abs(jsim).max()
        valid = np.concatenate([np.asarray(js.lt_valid), np.repeat(np.asarray(js.work_valid), P)])
        masked = np.where(valid[:, None], jsim, -1e30).T
        _, jidx = jax.lax.top_k(jnp.asarray(masked), MEM_CFG["top_k"])
        _, tidx = tcm.stable_top_k(torch.where(torch.from_numpy(valid)[:, None], tsim,
                                               -1e30).T, MEM_CFG["top_k"])
        assert np.array_equal(np.asarray(jidx), tidx.numpy())
        upd = i % 3 != 1
        jout, js = j_read(js, jcfg, jqk, jqe, upd)
        tout, ts = tmem.read_memory(ts, tcfg, tqk, tqe, update_usage=upd)
        assert jout.dtype == jnp.bfloat16 and tout.dtype == torch.bfloat16
        a = np.asarray(jout, np.float32)
        assert np.abs(a - tout.float().numpy()).max() <= STORE_TOL * max(1.0, np.abs(a).max())
        _stores_close(js, ts)
        n_lt = int(np.asarray(js.lt_valid).sum())
        consolidated |= n_lt > 0
        evicted |= n_lt < 4 * (i // 2)
    assert consolidated and evicted, "the sequence never consolidated or evicted"


# --- the engines at bf16 ---------------------------------------------------------------


class _JaxColorMNet(jex.ColorMNetEngine):
    """The JAX package's micro engine with the shared tree, cast to
    ``dtype`` as its own ``_init_params`` casts it."""

    def __init__(self, tree, dtype, work_size):
        self._tree = tree
        super().__init__(config="micro", work_size=work_size, dtype=dtype)

    def _init_params(self, seed):
        for group, attr in _GROUPS:
            setattr(self, attr, self._cast({"params": self._tree[group]}))
        self.g16_hw = (self.h // 16, self.w // 16)


class _JaxRemaster(jex.RemasterEngine):
    """The JAX package's DeepRemaster engine with the shared tree, cast to
    ``dtype``."""

    def __init__(self, tree, dtype):
        self.size, self.model, self.dtype = 320, jrm.NetworkC(), dtype
        self.params = jax.tree.map(lambda x: jnp.asarray(x, dtype), {"params": tree})


CM_WORK = (32, 48)
PRECISIONS = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))


def _prop_clip(T=6, seed=0):
    """Frames within the 32x48 engine; references at 0 and 3 (exemplar
    inserts: the memory, the short-term attention and the value encoder
    all run)."""
    rng = np.random.default_rng(seed)
    frames = rng.random((T, 26, 40, 3), dtype=np.float32)
    ref_ab = rng.random((T, 26, 40, 2), dtype=np.float32) * 2 - 1
    refs = rng.random((T, 26, 40, 3), dtype=np.float32)
    is_ref = np.zeros(T, bool)
    is_ref[[0, T // 2]] = True
    return frames, ref_ab, is_ref, refs


@pytest.fixture(scope="module")
def colormnet_runs(seeded_colormnet):  # noqa: F811
    """{("jax"|"port", "float32"|"bfloat16"): ab} of one exemplar-mode
    propagation."""
    tree, net = seeded_colormnet
    frames, ref_ab, is_ref, refs = _prop_clip()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        for jd, td in PRECISIONS:
            je = _JaxColorMNet(tree, jd, CM_WORK)
            out["jax", td] = np.asarray(jex.colormnet_propagate(
                je, frames, ref_ab, is_ref, ref_frames=refs, frame_propagate=False))
            te = tex.ColorMNetEngine(config="micro", work_size=CM_WORK, dtype=td, device="cpu")
            te.net = tex._cast_net(net, td)
            out["port", td] = tex.colormnet_propagate(
                te, frames, ref_ab, is_ref, ref_frames=refs, frame_propagate=False).numpy()
    return out


@pytest.fixture(scope="module")
def remaster_runs():
    """{("jax"|"port", dtype): RGB} of one sliding-window propagation (5
    frames, 4 references, a window of 2 that advances)."""
    tree = remaster_tree()
    net = remaster_net(tree)
    rng = np.random.default_rng(8)
    frames = rng.random((5, 32, 48, 3), dtype=np.float32)
    refs = rng.random((4, 32, 48, 3), dtype=np.float32)
    kw = dict(ref_positions=np.array([0, 1, 3, 4]), ref_buffer_size=2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        for jd, td in PRECISIONS:
            out["jax", td] = np.asarray(jex.remaster_propagate(_JaxRemaster(tree, jd), frames,
                                                               refs, **kw))
            te = tex.RemasterEngine(device="cpu", dtype=td)
            te.model = tex._cast_net(net, td)
            out["port", td] = tex.remaster_propagate(te, frames, refs, **kw).numpy()
    return out


def _bf16_floor_check(runs, bound, what):
    """Each package's bf16 result within ``bound`` of its own float32
    result; the two bf16 results within twice the larger of those
    distances of each other; the float32 results within F32_TOL."""
    f32, b16 = torch.float32, torch.bfloat16
    d = lambda a, b: float(np.abs(np.asarray(a, np.float64) - b).max())  # noqa: E731
    d_jax, d_port = d(runs["jax", b16], runs["jax", f32]), d(runs["port", b16], runs["port", f32])
    apart = d(runs["jax", b16], runs["port", b16])
    print(f"{what}: bf16 vs float32: JAX {d_jax:.4g}, port {d_port:.4g}; bf16 apart {apart:.4g}")
    assert d(runs["jax", f32], runs["port", f32]) <= F32_TOL, what
    assert d_jax <= bound and d_port <= bound, what
    assert apart <= 2.0 * max(d_jax, d_port), what
    assert d_port > 0.0, f"{what}: the port's bf16 run equals its float32 run"


def test_bf16_colormnet_propagate_against_jax(colormnet_runs):
    assert colormnet_runs["port", torch.bfloat16].dtype == np.float32
    _bf16_floor_check(colormnet_runs, BF16_TOL["colormnet"], "colormnet_propagate")


def test_bf16_remaster_propagate_against_jax(remaster_runs):
    assert remaster_runs["port", torch.bfloat16].dtype == np.float32
    _bf16_floor_check(remaster_runs, BF16_TOL["remaster"], "remaster_propagate")


# --- dtype resolution ------------------------------------------------------------------


def test_engines_default_to_float32_on_the_cpu(seeded_colormnet, monkeypatch):  # noqa: F811
    _, net = seeded_colormnet
    monkeypatch.setitem(tex.registry._cache, ("colormnet", "micro", torch.device("cpu")), net)
    cm = tex.ColorMNetEngine(config="micro", work_size=CM_WORK, device="cpu")
    rm = tex.RemasterEngine(frame_size=32, device="cpu")
    assert cm.dtype == rm.dtype == torch.float32
    assert cm.net is net  # the registry's module itself, not a copy
    assert all(p.dtype == torch.float32 for p in rm.model.parameters())
    cm16 = tex.ColorMNetEngine(config="micro", work_size=CM_WORK, dtype=torch.bfloat16,
                               device="cpu")
    assert cm16.dtype == torch.bfloat16 and cm16.net is not net
    assert all(p.dtype == torch.bfloat16 for p in cm16.net.parameters())
    assert all(p.dtype == torch.float32 for p in net.parameters())  # the registry's unchanged
    # the card's default, resolved without touching a card
    assert tex._engine_dtype(None, torch.device("cuda")) == torch.bfloat16
    assert tex._engine_dtype(torch.float32, torch.device("cuda")) == torch.float32
