"""Fixed-shape exemplar memory bank (ColorMNet's XMem-style memory).

Port of ``havc_tpu.models.memory``, with the same static shapes and masks:

* a working store of ``max_mt_frames`` frame slots addressed by insertion
  stamp (slot 0 pinned to the protected first insert, the others cycling
  ``1 + (stamp - 1) % (W - 1)``);
* consolidation when the store holds ``max_mt_frames`` frames: the
  highest normalised-usage candidate tokens become prototypes whose
  values and shrinkage are potentiated from all candidates, appended to
* a long-term store of ``lt_capacity`` token slots with a validity mask
  and normalised-usage eviction.

What the JAX package decides with ``lax.cond`` on values that depend only
on the insert schedule (whether an insert runs, whether the working store
is full) is decided here on the host: ``MemoryState`` keeps a host copy of
the working slots' validity and stamps beside the device tensors, so the
frame loop never waits for the card.  An insert is split along that line:
``note_insert`` keeps the host copy and says whether the store is full,
``write_working`` writes the device tensors.  The slot a frame goes to is
formed on the device from the state's own stamp counter, as the JAX
package forms it, so a captured CUDA graph of an insert writes the right
slot on every replay.  What depends on the data (which
long-term tokens are evicted, whether eviction runs) stays on the device:
both branches are computed and ``torch.where`` picks.  Every tie among
equal keys is broken as ``jax.lax.top_k`` breaks it (``stable_top_k``).

The stores (keys, shrinkage, selection, values) hold the engine's dtype
(``init_memory(..., dtype=torch.bfloat16)`` on the card), as the JAX
package's do; use and life counts stay float32.  Similarities, the
readout's and the potentiation's products run in float32 and are written
back in the stores' dtype.

With a leading scene axis (``init_memory(..., scenes=S)``) every device
tensor gains a first dimension of S and the functions run all S memories
at once: batched products, top-k along the last axis, eviction by
``torch.where`` per scene.  The host copies stay one schedule shared by
all S: the scene-batched scan starts every scene with a rebuild and an
exemplar insert at step 0, so each scene inserts at the same steps.

The functions update the state's tensors in place and return it; no
device tensor of a state is ever replaced, so its storage can be held by
a captured graph (``clear_host`` and ``clear_device`` empty it in place).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .colormnet import get_similarity, stable_top_k, topk_softmax

__all__ = ["MemoryConfig", "MemoryState", "init_memory", "clear_host", "clear_device",
           "insert_working", "note_insert", "write_working", "read_memory"]


class MemoryConfig(NamedTuple):
    key_dim: int = 64
    value_dim: int = 512
    num_objects: int = 2
    tokens_per_frame: int = 336  # P = (H/16)*(W/16) at working resolution
    max_mt_frames: int = 10  # max_mid_term_frames (T_max)
    min_mt_frames: int = 5  # min_mid_term_frames (T_min)
    num_prototypes: int = 128
    lt_capacity: int = 10000  # max_long_term_elements (tokens)
    top_k: int = 30
    mem_every: int = 5
    count_long_usage: bool = True


@dataclass
class MemoryState:
    # device tensors: shapes without the scene axis; with it each gains a
    # leading S
    # working store (frame granularity, insertion-stamped ring)
    work_keys: torch.Tensor  # (W, P, Ck)
    work_shrink: torch.Tensor  # (W, P)
    work_sel: torch.Tensor  # (W, P, Ck) selection, for potentiation
    work_values: torch.Tensor  # (O, W, P, Cv)
    work_use: torch.Tensor  # (W, P) use_count
    work_life: torch.Tensor  # (W, P) life_count
    work_valid: torch.Tensor  # (W,) bool
    work_stamp: torch.Tensor  # (W,) int32 insertion stamp
    # long-term store (token granularity)
    lt_keys: torch.Tensor  # (L, Ck)
    lt_shrink: torch.Tensor  # (L,)
    lt_values: torch.Tensor  # (O, L, Cv)
    lt_use: torch.Tensor  # (L,)
    lt_life: torch.Tensor  # (L,)
    lt_valid: torch.Tensor  # (L,) bool
    stamp: torch.Tensor  # () int32 == next_stamp, on the device (one for all scenes)
    # host copies of the schedule-determined fields
    next_stamp: int  # total inserts so far
    host_valid: np.ndarray  # (W,) bool == work_valid
    host_stamp: np.ndarray  # (W,) int == work_stamp


def init_memory(cfg: MemoryConfig, device=None, dtype=torch.float32,
                scenes: Optional[int] = None) -> MemoryState:
    """An empty memory; ``scenes`` S gives every device tensor a leading
    scene axis."""
    W, P, L, O = cfg.max_mt_frames, cfg.tokens_per_frame, cfg.lt_capacity, cfg.num_objects
    assert cfg.max_mt_frames >= 2, "need >= 2 working frame slots"
    assert cfg.max_mt_frames > cfg.min_mt_frames >= 1
    s = () if scenes is None else (int(scenes),)
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    return clear_device(MemoryState(
        work_keys=torch.empty(s + (W, P, cfg.key_dim), **kw),
        work_shrink=torch.empty(s + (W, P), **kw),
        work_sel=torch.empty(s + (W, P, cfg.key_dim), **kw),
        work_values=torch.empty(s + (O, W, P, cfg.value_dim), **kw),
        work_use=torch.empty(s + (W, P), **f32),
        work_life=torch.empty(s + (W, P), **f32),
        work_valid=torch.empty(s + (W,), dtype=torch.bool, device=device),
        work_stamp=torch.empty(s + (W,), dtype=torch.int32, device=device),
        lt_keys=torch.empty(s + (L, cfg.key_dim), **kw),
        lt_shrink=torch.empty(s + (L,), **kw),
        lt_values=torch.empty(s + (O, L, cfg.value_dim), **kw),
        lt_use=torch.empty(s + (L,), **f32),
        lt_life=torch.empty(s + (L,), **f32),
        lt_valid=torch.empty(s + (L,), dtype=torch.bool, device=device),
        stamp=torch.empty((), dtype=torch.int32, device=device),
        next_stamp=0,
        host_valid=np.zeros(W, bool),
        host_stamp=np.zeros(W, np.int64),
    ))


def clear_host(state: MemoryState) -> MemoryState:
    """Empty the host copy in place (no insert yet)."""
    state.next_stamp = 0
    state.host_valid[:] = False
    state.host_stamp[:] = 0
    return state


def clear_device(state: MemoryState) -> MemoryState:
    """Empty the device tensors in place (``init_memory``'s values): zero
    keys, selection, values, use counts and stamps, unit shrinkage, life
    counts 1e-7, no valid slot."""
    for t in (state.work_keys, state.work_sel, state.work_values, state.work_use,
              state.work_valid, state.work_stamp, state.lt_keys, state.lt_values, state.lt_use,
              state.lt_valid, state.stamp):
        t.zero_()
    for t in (state.work_shrink, state.lt_shrink):
        t.fill_(1.0)
    for t in (state.work_life, state.lt_life):
        t.fill_(1e-7)
    return state


def _candidates(valid, stamp, cfg: MemoryConfig):
    """Consolidation candidates: every live frame but the first insert and
    the ``min_mt_frames - 1`` most recent.  Works on numpy or torch, with
    or without a leading scene axis."""
    live = stamp * valid + (-1) * ~valid
    s_max = (live.max(axis=-1, keepdims=True) if isinstance(live, np.ndarray)
             else live.amax(dim=-1, keepdim=True))
    return valid & (stamp >= 1) & (stamp <= s_max - (cfg.min_mt_frames - 1))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per leading index: x (..., n, C), idx (..., k)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _put_rows(x: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``x[..., idx, :] = rows`` in place, per leading index (idx unique)."""
    x.scatter_(-2, idx[..., None].expand(rows.shape), rows)


def _consolidate(s: MemoryState, cfg: MemoryConfig) -> MemoryState:
    """Working store -> prototypes -> long-term store, with eviction."""
    W, P, L, O = cfg.max_mt_frames, cfg.tokens_per_frame, cfg.lt_capacity, cfg.num_objects
    n = W * P
    k_p = min(cfg.num_prototypes, n)
    lead = tuple(s.work_valid.shape[:-1])  # () or (S,)

    cand_frame = _candidates(s.work_valid, s.work_stamp, cfg)
    cand_tok = cand_frame[..., None].expand(lead + (W, P)).reshape(lead + (n,))
    keys = s.work_keys.reshape(lead + (n, -1))
    shrink = s.work_shrink.reshape(lead + (n,))
    sel = s.work_sel.reshape(lead + (n, -1))
    values = s.work_values.reshape(lead + (O, n, -1))
    usage = (s.work_use / s.work_life).reshape(lead + (n,))

    # prototypes = the highest normalised-usage candidate tokens
    topv, proto_idx = stable_top_k(torch.where(cand_tok, usage, -torch.inf), k_p)
    proto_ok = topv > -torch.inf
    proto_keys, proto_sel = _rows(keys, proto_idx), _rows(sel, proto_idx)

    # potentiation: softmax affinity of all candidates onto each prototype,
    # queried with the prototypes' selection
    sim = get_similarity(keys, shrink, proto_keys, proto_sel)  # (..., n, k_p)
    sim = torch.where(cand_tok[..., None], sim, -torch.inf)
    m = sim.max(dim=-2, keepdim=True).values
    e = torch.where(cand_tok[..., None], torch.exp(sim - m), 0.0)
    aff = e / torch.clamp(e.sum(dim=-2, keepdim=True), min=1e-30)
    values, shrink = values.float(), shrink.float()
    proto_values = torch.einsum("...nk,...onc->...okc", aff, values).to(s.lt_values.dtype)
    proto_shrink = (aff.transpose(-1, -2) @ shrink if not lead
                    else (aff.transpose(-1, -2) @ shrink[..., None])[..., 0])
    proto_shrink = proto_shrink.to(s.lt_shrink.dtype)

    # long-term eviction: once the store reaches L - k_p tokens, keep only
    # those whose normalised usage is strictly above the drop-th smallest;
    # computed always, applied per scene where it is due
    lcount = s.lt_valid.sum(dim=-1, keepdim=True)
    drop = lcount - (L - k_p)
    lu = torch.where(s.lt_valid, s.lt_use / s.lt_life, torch.inf)
    thr = torch.sort(lu, dim=-1).values.gather(-1, torch.clamp(drop - 1, 0, L - 1))
    due = (lcount >= L - k_p) & (drop > 0)
    s.lt_valid.copy_(torch.where(due, s.lt_valid & (lu > thr), s.lt_valid))

    # append the prototypes into the first k_p free long-term slots
    dst = stable_top_k(1.0 - s.lt_valid.float(), k_p)[1]
    ok = proto_ok[..., None]
    _put_rows(s.lt_keys, dst, torch.where(ok, proto_keys, _rows(s.lt_keys, dst)))
    _put_rows(s.lt_values, dst[..., None, :].expand(lead + (O, k_p)),
              torch.where(ok[..., None, :, :], proto_values,
                          _rows(s.lt_values, dst[..., None, :].expand(lead + (O, k_p)))))
    for name, fresh in (("lt_shrink", proto_shrink), ("lt_use", 0.0), ("lt_life", 1e-7)):
        t = getattr(s, name)
        t.scatter_(-1, dst, torch.where(proto_ok, fresh, t.gather(-1, dst)))
    s.lt_valid.scatter_(-1, dst, proto_ok | s.lt_valid.gather(-1, dst))

    # sieve: consolidated frames leave the working store (the host copy's
    # are taken out by ``note_insert``)
    s.work_valid &= ~cand_frame
    return s


def insert_working(state: MemoryState, cfg: MemoryConfig, keys: torch.Tensor,
                   shrink: torch.Tensor, sel: torch.Tensor, values: torch.Tensor,
                   enabled: bool) -> MemoryState:
    """One ``add_memory``: write the frame (keys (P, Ck), shrink (P,), sel
    (P, Ck), values (O, P, Cv); each with a leading S in a scene batch)
    into the working store, then consolidate if the store is full.
    ``enabled`` is a host bool: False is a no-op."""
    if not enabled:
        return state
    return write_working(state, cfg, keys, shrink, sel, values, note_insert(state, cfg))


def note_insert(state: MemoryState, cfg: MemoryConfig) -> bool:
    """The host's part of one insert: the host copy takes the new frame's
    slot and stamp, and, when the store is then full, loses the frames a
    consolidation moves out.  Returns whether it is full, which
    ``write_working`` is told."""
    W = cfg.max_mt_frames
    stamp = state.next_stamp
    slot = 0 if stamp == 0 else 1 + (stamp - 1) % (W - 1)
    state.host_valid[slot] = True
    state.host_stamp[slot] = stamp
    state.next_stamp = stamp + 1
    full = bool(state.host_valid.sum() >= W)
    if full:
        state.host_valid &= ~_candidates(state.host_valid, state.host_stamp, cfg)
    return full


def write_working(state: MemoryState, cfg: MemoryConfig, keys: torch.Tensor,
                  shrink: torch.Tensor, sel: torch.Tensor, values: torch.Tensor,
                  consolidate: bool) -> MemoryState:
    """The device's part of one insert (the arguments of
    ``insert_working``): the slot is formed from the state's device stamp,
    ``0 if stamp == 0 else 1 + (stamp - 1) % (W - 1)``, the frame written
    there, the stamp counted, then the store consolidated where
    ``consolidate`` (``note_insert``'s answer) says."""
    W = cfg.max_mt_frames
    stamp = state.stamp
    slot = torch.where(stamp == 0, 0, 1 + (stamp - 1) % (W - 1)).long().reshape(1)
    state.work_keys.index_copy_(-3, slot, keys.unsqueeze(-3))
    state.work_shrink.index_copy_(-2, slot, shrink.unsqueeze(-2))
    state.work_sel.index_copy_(-3, slot, sel.unsqueeze(-3))
    state.work_values.index_copy_(-3, slot, values.unsqueeze(-3))
    state.work_use.index_fill_(-2, slot, 0.0)
    state.work_life.index_fill_(-2, slot, 1e-7)
    state.work_valid.index_fill_(-1, slot, True)
    state.work_stamp.index_copy_(-1, slot, stamp.expand(state.work_stamp.shape[:-1] + (1,)))
    stamp += 1
    if consolidate:
        _consolidate(state, cfg)
    return state


def read_memory(state: MemoryState, cfg: MemoryConfig, qk: torch.Tensor,
                qe: Optional[torch.Tensor], update_usage: bool = True
                ) -> Tuple[torch.Tensor, MemoryState]:
    """Top-k softmax readout over [long-term, working] tokens for query
    keys qk (P, Ck) with selection qe (P, Ck) (each with a leading S in a
    scene batch): returns the (O, P, Cv) readout, in the values' dtype, and
    the state with use/life counts updated (only when ``update_usage`` and
    the memory holds anything).  An empty memory reads as zeros."""
    W, P, L, O = cfg.max_mt_frames, cfg.tokens_per_frame, cfg.lt_capacity, cfg.num_objects
    lead = tuple(state.work_valid.shape[:-1])
    mk = torch.cat([state.lt_keys, state.work_keys.reshape(lead + (W * P, -1))], dim=-2)
    ms = torch.cat([state.lt_shrink, state.work_shrink.reshape(lead + (W * P,))], dim=-1)
    valid = torch.cat([state.lt_valid, state.work_valid[..., None].expand(lead + (W, P))
                       .reshape(lead + (W * P,))], dim=-1)
    affinity, usage = topk_softmax(get_similarity(mk, ms, qk, qe), cfg.top_k, valid)
    # the readout of the two stores summed, instead of one product over
    # their concatenation (which would copy the long-term values each frame)
    out = torch.einsum("...np,...onc->...opc", affinity[..., :L, :], state.lt_values.float()) \
        + torch.einsum("...np,...onc->...opc", affinity[..., L:, :],
                       state.work_values.reshape(lead + (O, W * P, -1)).float())

    if update_usage:
        matched = valid.any(dim=-1, keepdim=True)
        work_live = (state.work_valid & matched)[..., None]
        state.work_use += torch.where(work_live, usage[..., L:].reshape(lead + (W, P)), 0.0)
        state.work_life += torch.where(work_live, 1.0, 0.0)
        if cfg.count_long_usage:
            lt_live = state.lt_valid & matched
            state.lt_use += torch.where(lt_live, usage[..., :L], 0.0)
            state.lt_life += torch.where(lt_live, 1.0, 0.0)
    return out.to(state.work_values.dtype), state
