"""All-refs forward-reference scheduling (ColorMNet ``encode_mode`` 2/3).

The port's own copy of ``havc_tpu.exemplar.allrefs`` (host-side numpy).

The reference's ``use_all_refs`` mode (vsslib/vsmodels.py:52-55 maps
``encode_mode`` 2/3 -> ``use_all_refs=True``) preloads forthcoming
scene-change reference frames and feeds the *next* upcoming reference to the
colorizer at (almost) every step, instead of feeding each reference at its
own frame.  Two reference components define the behavior:

* ``RefImageReader`` (colormnet/colormnet_utils.py:27-155): collects the
  scene-change frame indices by scanning the clip in 500-frame buffers
  (DEF_MAX_XREF_BUFFER), keeps a requested list of ``ref_list_size`` refs
  (clamped even, [DEF_MIN_XRF_FRAMES=4, DEF_MAX_XRF_FRAMES=250]), and at
  each frame ``n`` either yields the next unfed reference or ``None``
  (throttled by the DEF_MAX_XREF_WINDOW=20 forward-window rule once past
  the half of the list).
* ``ColorMNetRender.set_ref_frame``/``colorize_frame``
  (colormnet_render.py:171-226): every fed reference is inserted as an
  exemplar (``frame_as_video`` defaults False -> step_AnyExemplar
  semantics), and the InferenceCore is REBUILT — with the last valid
  reference as the fresh exemplar — whenever ``reset_on_ref_update``
  (render_vivid) fires on a fed ref with an advanced frame counter, or the
  frame counter reaches ``max_memory_frames``.

Both are deterministic functions of the scene-change flag list, so they
are computed on the host into per-step schedules before any device work
is queued (the frame loop of ``colormnet_propagate`` reads them):

* ``allrefs_feed_schedule(sc_prev)`` -> ``feed[n]`` = reference frame index
  fed at step ``n`` (or -1 for None) — RefImageReader transcription,
  held equal to the JAX package's in tests/test_torch_exemplar_sources.py.
* ``allrefs_step_schedule(feed, ...)`` -> ``(eff[n], reset[n])`` — the
  render-loop counter simulation: ``eff[n]`` is the exemplar actually inserted
  at step ``n`` (the fed ref, or on reset steps the last VALID ref —
  ``ref_img_valid``), ``reset[n]`` marks InferenceCore rebuilds.
"""
from __future__ import annotations

import numpy as np

from ..utils.log import HAVCError

# reference constants (vsslib/constants.py:64-73)
DEF_MAX_MEMORY_FRAMES = 10000
DEF_MAX_XREF_BUFFER = 500
DEF_MAX_XRF_FRAMES = 250
DEF_MAX_XREF_WINDOW = 20
DEF_NUM_XRF_FRAMES = 30
DEF_MIN_XRF_FRAMES = 4
DEF_MIN_RF_FRAMES = 4

__all__ = [
    "HAVCError",
    "allrefs_feed_schedule",
    "allrefs_step_schedule",
    "DEF_NUM_XRF_FRAMES",
]


def allrefs_feed_schedule(
    sc_prev: np.ndarray,
    ref_list_size: int = DEF_NUM_XRF_FRAMES,
    start_frame: int = 0,
) -> np.ndarray:
    """Per-step reference feed order: RefImageReader transcription.

    ``sc_prev`` is the per-frame scene-change mask (``_SceneChangePrev``);
    returns ``feed`` with ``feed[n]`` = frame index (into the reference
    clip) fed at step ``n``, or -1 when ``get_next_ref_frame`` returns
    None.  Every scheduled index satisfies ``sc_prev[idx]`` and each
    reference is fed at most once, in ascending order.

    Faithful to colormnet_utils.py:44-155 including the quirky
    forward-window throttle: past the (Python-round) half of the ref list,
    a new ref is fed only while at least DEF_MAX_XREF_WINDOW already-fed
    refs are still in the future relative to ``n``.
    """
    sc = np.asarray(sc_prev).astype(bool)
    total = int(len(sc))
    if total == 0:
        return np.zeros((0,), np.int32)

    # __init__ (colormnet_utils.py:44-51): buffer size must be even,
    # clamped to [DEF_MIN_XRF_FRAMES, DEF_MAX_XRF_FRAMES]
    req = max(
        min((int(ref_list_size) // 2) * 2, DEF_MAX_XRF_FRAMES),
        DEF_MIN_XRF_FRAMES,
    )

    # get_clip_ref_list (:73-99)
    start = min(start_frame, total - 1)
    buffer_size = min(total - start, DEF_MAX_XREF_BUFFER)
    req = min(total - start, req)
    ref_list = [start + i for i in range(buffer_size) if sc[i]]
    last_frame = start + buffer_size - 1

    def extend() -> bool:
        # extend_clip_ref_list (:57-71)
        nonlocal last_frame
        if last_frame == total - 1:
            return False
        num = min(total - last_frame - 1, buffer_size)
        batch = last_frame + num + 1
        before = len(ref_list)
        for i in range(last_frame + 1, batch):
            if sc[i]:
                ref_list.append(i)
        last_frame = batch - 1
        return len(ref_list) > before

    for _ in range(10):
        if len(ref_list) < req and last_frame < total - 1:
            extend()
        else:
            break
    if len(ref_list) < DEF_MIN_RF_FRAMES:
        raise HAVCError("RemasterColorizer(): number of reference frames must be at "
                        f"least 2, found  {len(ref_list)}")

    def search_new_refs() -> bool:
        # search_new_ref_imgs (:121-125)
        while not extend():
            if last_frame == total - 1:
                return False
        return True

    feed = np.full(total, -1, np.int32)
    ref_last_idx = 0
    for n in range(total):
        # get_next_ref_frame (:127-155)
        if ref_last_idx >= len(ref_list) - 1 and last_frame < total - 1:
            search_new_refs()
        if ref_last_idx > len(ref_list) - 1:
            continue  # no more reference frames are available
        ref_half_idx = round(len(ref_list) * 0.5)
        if ref_last_idx > ref_half_idx:
            n_last = ref_last_idx
            while n_last > 0 and n < ref_list[n_last]:
                n_last -= 1
            window = ref_last_idx - n_last
            if window < DEF_MAX_XREF_WINDOW:
                continue  # enough forward refs buffered — skip this step
        feed[n] = ref_list[ref_last_idx]
        ref_last_idx += 1
    return feed


def allrefs_step_schedule(
    feed: np.ndarray,
    vid_length: int,
    reset_on_ref_update: bool = True,
    max_memory_frames: int = 0,
):
    """Render-loop counter simulation -> ``(eff, reset)`` per-step schedules.

    Transcribes ColorMNetRender.set_ref_frame (colormnet_render.py:171-180)
    and colorize_frame's reset watchdog (:197-226): ``reset[n]`` marks the
    steps where the reference rebuilds the InferenceCore (memory, hidden
    and counters wiped), ``eff[n]`` is the exemplar image index inserted at
    step ``n`` — the fed ref, except on reset steps where the loop passes
    ``ref_img_valid`` (the most recent non-None ref) to the fresh core;
    -1 = no exemplar insert (plain propagation step).

    ``max_memory_frames`` <= 0 resolves like the render init (:85-88):
    ``min(DEF_MAX_MEMORY_FRAMES, vid_length)`` — at which value the
    frame-count watchdog can never fire within the clip.  The GPU
    free-memory branch of reset_cond_1 is treated as never-firing: the
    memory store's size is fixed by its configuration.
    """
    feed = np.asarray(feed, np.int64)
    T = len(feed)
    if max_memory_frames is None or max_memory_frames <= 0:
        mmf = min(DEF_MAX_MEMORY_FRAMES, int(vid_length))
    else:
        mmf = min(DEF_MAX_MEMORY_FRAMES, int(max_memory_frames))

    eff = np.full(T, -1, np.int32)
    reset = np.zeros(T, bool)
    frame_count = 0
    ref_count = 0
    ref_count_prv = 0
    valid = -1
    for n in range(T):
        fed = int(feed[n])
        if fed >= 0:  # set_ref_frame
            valid = fed
            ref_count_prv = ref_count if frame_count > 0 else 0
            ref_count = frame_count
        # colorize_frame reset conditions (:204-208)
        r1 = frame_count >= mmf
        r2 = (reset_on_ref_update and fed >= 0
              and (ref_count - ref_count_prv >= 1))
        if r1 or r2:
            if valid < 0:
                raise ValueError(
                    "allrefs_step_schedule: reset before any reference was "
                    "fed (feed[0] must be >= 0)"
                )
            frame_count = 0
            reset[n] = True
            eff[n] = valid
        else:
            eff[n] = fed
            frame_count += 1
    return eff, reset
