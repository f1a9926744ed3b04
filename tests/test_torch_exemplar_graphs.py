"""ColorMNet's frame step in place, and as captured CUDA graphs.

On the CPU: the engine's own carry is refilled at every call, a vivid
rebuild in the middle of a clip equals a fresh call from that frame, the
slot an insert formed on the device is the one the host formed before,
the plans a step meets stay within ``MAX_STEP_PLANS``, and the step
counters count (no replay on the CPU).  On the card (``-m cuda``, run
with ``--noconftest``: no JAX there): the graph path is bit-identical to
the eager path on the full engine at 224x448 in bf16, with equal launch
and sync counts, the call that captures waits for the card nowhere, a
second call captures nothing, and its replays run as many window
attention kernels as the counter says; with two cards, the same for an
engine on the card that is not current.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.exemplar import allrefs
from havc_tpu_torch.models import memory as tmem
from havc_tpu_torch.utils import profiling

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _inputs(T, h, w, refs, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand((T, h, w, 3), generator=g)
    ref_ab = torch.rand((T, h, w, 2), generator=g) * 2 - 1
    ref_frames = torch.rand((T, h, w, 3), generator=g)
    is_ref = np.zeros(T, bool)
    is_ref[list(refs)] = True
    return frames.to(device), ref_ab.to(device), is_ref, ref_frames.to(device)


@pytest.fixture(scope="module")
def micro_engine():
    torch.manual_seed(0)
    return tex.ColorMNetEngine(config="micro", work_size=(32, 48), device="cpu")


MODES = {"propagate": dict(frame_propagate=True, vivid=False),
         "vivid": dict(frame_propagate=True, vivid=True),
         "exemplar": dict(frame_propagate=False, vivid=False)}


# --- on the CPU ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_carry_is_refilled_between_calls(micro_engine, mode):
    """Two calls on one engine with another clip between them give the
    same output, equal to a call on a carry of its own (``return_state``)."""
    frames, ref_ab, is_ref, refs = _inputs(12, 26, 40, [0, 7], seed=1)
    other = _inputs(12, 26, 40, [0, 3, 8], seed=2)
    kw = MODES[mode]
    first = tex.colormnet_propagate(micro_engine, frames, ref_ab, is_ref, ref_frames=refs, **kw)
    tex.colormnet_propagate(micro_engine, other[0], other[1], other[2], ref_frames=other[3], **kw)
    again = tex.colormnet_propagate(micro_engine, frames, ref_ab, is_ref, ref_frames=refs, **kw)
    own, carry = tex.colormnet_propagate(micro_engine, frames, ref_ab, is_ref, ref_frames=refs,
                                         return_state=True, **kw)
    assert torch.equal(first, again)
    assert torch.equal(first, own)
    assert carry[0] is not micro_engine.carry[0]


def test_vivid_reset_mid_clip_equals_a_fresh_call(micro_engine):
    """A vivid rebuild at frame 8 refills the carry in place: nothing of
    the frames before it is left (two clips that differ only there agree
    from frame 8 on, bit for bit), and the frames from there equal a call
    that starts at frame 8 (to 1e-5: the exemplars are encoded in a batch
    of one there, of two in the whole clip)."""
    frames, ref_ab, is_ref, refs = _inputs(16, 26, 40, [0, 8], seed=3)
    other = _inputs(16, 26, 40, [0, 8], seed=8)
    kw = MODES["vivid"]
    whole = tex.colormnet_propagate(micro_engine, frames, ref_ab, is_ref, ref_frames=refs, **kw)
    mixed = tex.colormnet_propagate(micro_engine, torch.cat([other[0][:8], frames[8:]]),
                                    torch.cat([other[1][:8], ref_ab[8:]]), is_ref,
                                    ref_frames=torch.cat([other[3][:8], refs[8:]]), **kw)
    tail = tex.colormnet_propagate(micro_engine, frames[8:], ref_ab[8:], is_ref[8:],
                                   ref_frames=refs[8:], **kw)
    assert not torch.equal(whole[:8], mixed[:8])
    assert torch.equal(whole[8:], mixed[8:])
    assert (whole[8:] - tail).abs().max().item() <= 1e-5


def _host_slot_insert(state, cfg, keys, shrink, sel, values):
    """An insert as the port wrote it with the slot formed on the host."""
    W = cfg.max_mt_frames
    stamp = state.next_stamp
    slot = 0 if stamp == 0 else 1 + (stamp - 1) % (W - 1)
    state.work_keys.select(-3, slot).copy_(keys)
    state.work_shrink.select(-2, slot).copy_(shrink)
    state.work_sel.select(-3, slot).copy_(sel)
    state.work_values.select(-3, slot).copy_(values)
    state.work_use.select(-2, slot).fill_(0.0)
    state.work_life.select(-2, slot).fill_(1e-7)
    state.work_valid.select(-1, slot).fill_(True)
    state.work_stamp.select(-1, slot).fill_(stamp)
    tmem.note_insert(state, cfg)


@pytest.mark.parametrize("scenes", [None, 3])
def test_device_slot_writes_the_host_slot(scenes):
    """Inserts past two wraps of the working ring (consolidating as it
    fills) write every store as the slot formed on the host did, with or
    without a scene axis; the device stamp follows ``next_stamp``."""
    cfg = tmem.MemoryConfig(key_dim=4, value_dim=8, tokens_per_frame=6, max_mt_frames=4,
                            min_mt_frames=1, num_prototypes=3, lt_capacity=40, top_k=3)
    dev, host = tmem.init_memory(cfg, scenes=scenes), tmem.init_memory(cfg, scenes=scenes)
    lead = () if scenes is None else (scenes,)
    g = torch.Generator().manual_seed(4)
    for i in range(11):
        keys = torch.randn(lead + (6, 4), generator=g)
        sel = torch.rand(lead + (6, 4), generator=g)
        shrink = torch.rand(lead + (6,), generator=g) + 1
        values = torch.randn(lead + (2, 6, 8), generator=g)
        full = host.host_valid.sum() + 1 >= cfg.max_mt_frames
        tmem.insert_working(dev, cfg, keys, shrink, sel, values, True)
        _host_slot_insert(host, cfg, keys, shrink, sel, values)
        if full:
            tmem._consolidate(host, cfg)
        for name in ("work_keys", "work_shrink", "work_sel", "work_values", "work_use",
                     "work_life", "work_valid", "work_stamp", "lt_keys", "lt_values",
                     "lt_valid"):
            assert torch.equal(getattr(dev, name), getattr(host, name)), (i, name)
        assert int(dev.stamp) == dev.next_stamp == host.next_stamp == i + 1
        assert np.array_equal(dev.host_valid, host.host_valid)
    assert int(dev.lt_valid.sum()) > 0, "the ring never consolidated"


@pytest.mark.parametrize("mode", list(MODES) + ["allrefs"])
def test_plans_stay_within_the_bound(micro_engine, mode):
    """Random schedules of 200 frames meet at most ``MAX_STEP_PLANS``
    plans in exemplar-insert modes, 8 in propagate mode (the step's
    docstring), and hit a full working store."""
    rng = np.random.default_rng(5)
    kw = dict(MODES.get(mode, dict(frame_propagate=False, vivid=True)))
    plans = set()
    for _ in range(20):
        is_ref = rng.random(200) < rng.choice([0.02, 0.1, 0.4])
        is_ref[[0, 40, 90, 130, 170]] = True  # the all-refs reader wants 4 or more
        reset = is_ref
        if mode == "allrefs":
            feed = allrefs.allrefs_feed_schedule(is_ref)
            src, reset = allrefs.allrefs_step_schedule(feed, vid_length=200)
            is_ref = np.asarray(src) >= 0
        step = tex._build_cm_step(micro_engine, **kw)
        carry = tex._cm_init_carry(micro_engine)
        for t in range(200):
            p, carry = step.plan(carry, bool(is_ref[t]), bool(reset[t]))
            plans.add(p)
    bound = 8 if mode == "propagate" else tex.MAX_STEP_PLANS
    assert len(plans) <= bound, sorted(plans)
    assert any(p.frame_full for p in plans)


def test_step_counters_on_the_cpu(micro_engine):
    """Every frame step is counted in ``cm_steps``; the CPU runs them all
    eagerly: no replay, no capture."""
    frames, ref_ab, is_ref, refs = _inputs(9, 26, 40, [0, 4], seed=6)
    tex.colormnet_propagate(micro_engine, frames, ref_ab, is_ref, ref_frames=refs)
    tex.colormnet_propagate_scenes(micro_engine, frames, ref_ab, is_ref, ref_frames=refs)
    c = profiling.counters()
    assert c["cm_steps"] == 9 + 5  # the scene batch: one step a frame of its longest scene
    assert c.get("cm_graph_replays", 0) == 0 and c.get("cm_graph_captures", 0) == 0
    assert micro_engine.step_graphs is None


# --- on the card --------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")


# the cell's work size (216x384 padded to the engine's 224x448)
CARD_SCHEDULES = {
    "cell": dict(T=16, refs=[0, 9], kw=MODES["vivid"]),
    "propagate": dict(T=16, refs=[0, 9], kw=MODES["propagate"]),
    "exemplar": dict(T=16, refs=[0, 9], kw=MODES["exemplar"]),
    # a reference every 4 frames, two inserts each: the working store
    # fills, consolidates and, past 172 long-term tokens, evicts
    "long": dict(T=60, refs=list(range(0, 60, 4)), kw=MODES["exemplar"], max_mem=300),
    "allrefs": dict(T=16, refs=[0, 4, 9, 13], kw={}, feed=True),
}
LAUNCHES = ("window_attn_launches", "window_attn_launches_bf16", "host_syncs")


def _counted():
    c = profiling.counters()
    profiling.reset_counters()
    return c


def _graph_path_against_eager(name, device):
    sch = CARD_SCHEDULES[name]
    T = sch["T"]
    torch.manual_seed(0)
    engine = tex.ColorMNetEngine(config="full", work_size=(224, 448), device=device,
                                 max_mem=sch.get("max_mem", 0))
    assert engine.dtype == torch.bfloat16
    frames, ref_ab, is_ref, refs = _inputs(T, 216, 384, sch["refs"], seed=7, device=device)
    kw = dict(sch["kw"])
    if sch.get("feed"):
        feed = allrefs.allrefs_feed_schedule(is_ref)
        kw["feed_schedule"], kw["reset_schedule"] = allrefs.allrefs_step_schedule(
            feed, vid_length=T, reset_on_ref_update=True)

    def run(**more):
        out = tex.colormnet_propagate(engine, frames, ref_ab, is_ref, ref_frames=refs,
                                      **kw, **more)
        torch.cuda.synchronize(device)
        return out

    profiling.reset_counters()
    eager, carry = run(return_state=True)  # a carry of its own: the eager step
    c_eager = _counted()
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as caught:  # the captures wait for nothing
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            graph = tex.colormnet_propagate(engine, frames, ref_ab, is_ref, ref_frames=refs,
                                            **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    syncs = [str(w.message) for w in caught if "synchronizing CUDA operation" in str(w.message)]
    c_first = _counted()
    # a fresh profiler around the replays, as the benchmark's traced run
    # opens one after its warm-up has captured
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = run()
    c_again = _counted()
    tc_kernels = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "window_attn_tc_kernel" in e.name)

    assert torch.equal(graph, eager) and torch.equal(again, eager)
    assert not syncs, syncs
    assert c_eager.get("cm_graph_replays", 0) == 0
    assert 1 <= c_first["cm_graph_captures"] <= tex.MAX_STEP_PLANS
    assert c_first["cm_graph_replays"] == T - c_first["cm_graph_captures"]
    assert c_again.get("cm_graph_captures", 0) == 0
    assert c_again["cm_graph_replays"] == c_again["cm_steps"] == T
    for k in LAUNCHES:
        assert c_eager.get(k, 0) == c_first.get(k, 0) == c_again.get(k, 0), k
    # the kernels the replays ran on the card, not the counts they credit
    assert tc_kernels == c_again.get("window_attn_launches_bf16", 0)
    if name == "cell":  # exemplar inserts at 0 and 9 skip the short-term read
        assert c_again["window_attn_launches_bf16"] == T - 2
    if name == "long":
        # 15 references, two inserts each: the store fills at the 10th
        # insert and every 5th after, 5 consolidations of 128 prototypes;
        # from the third on the 172 long-term tokens that start eviction
        # are passed
        assert carry[0].next_stamp == 30
        assert any(p.exem_full or p.frame_full for _, _, p in engine.step_graphs.graphs)
        assert int(carry[0].lt_valid.sum()) == int(engine.carry[0].lt_valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SCHEDULES))
def test_graph_path_is_bit_identical_to_eager(name):
    _need_cuda()
    _graph_path_against_eager(name, "cuda")


@pytest.mark.cuda
def test_graph_path_on_a_card_that_is_not_current():
    """An engine on card 1 while card 0 is current: its graphs are
    captured and replayed on card 1, bit-identical to the eager step."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    _graph_path_against_eager("cell", "cuda:1")
    assert torch.cuda.current_device() == 0
