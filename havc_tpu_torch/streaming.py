"""Streaming entry points: bounded-memory colorization of videos of any
length.  Port of ``havc_tpu.streaming``.

``HAVC_main_streaming(path_in, path_out, ...)`` runs the classic pipeline
(optional full-resolution BWTune pre-tune -> spline64 work resize ->
DeOldify and DDColor -> merge -> dark, smooth and colormap filters ->
temporal chroma stabilizer -> full-resolution chroma restore -> optional
LUT look -> deflicker) as a stream:

1. decode on a background thread (``io.stream.stream_batches``);
2. upload of each uint8 batch through a ring of pinned staging buffers,
   then the per-frame stage on the device;
3. an overlap-chunked temporal stage: each chunk is processed with the
   halo of frames its stabilizer and deflicker windows need, so the
   output equals the whole-clip pipeline (true clip ends replicate the
   edge frame, as the whole-clip ops clip their indices);
4. a write pipeline: each packed chunk is copied to pinned host memory on
   a copy stream while later chunks compute; up to ``pipeline_depth``
   chunks stay in flight, and only retiring one waits for the card (on
   that chunk's event).

Memory is O(batch + chunk + halo) frames whatever the video's length.
Frames cross the link as uint8: a gray source 1 byte a pixel up, and in
``uv420`` mode 0.5 bytes a pixel down (the host holds the output luma: it
is the decoded gray, so only the chroma planes come back and the luma
deflicker runs on the host's Y planes).

``HAVC_restore_video_streaming`` recolors a B&W video from a colored
reference video with ColorMNet, Deep-Exemplar, DeepRemaster or the
hybrid, carrying each engine's state across chunks (ColorMNet's memory,
DeepEx's scene reference, DeepRemaster's reference window with a
look-ahead cursor over the reference video) so that the chunked output
equals the whole clip's.  Decisions are taken on the host from integers
it already holds; the restore path downloads one vector of scene flags
per chunk (per batch of 32 reference frames for DeepRemaster), which the
engines' loops need before they can be queued.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import engines, presets
from .api import bw_tune_frames
from .filters import (chroma_bright_tweak, colormap_filter, dark_tweak, recover_clip_luma,
                      recover_clip_luma_y)
from .io.stream import FrameReader, stream_batches
from .ops import lut3d
from .ops import merge as merge_ops
from .ops import temporal as temporal_ops
from .ops.chroma import tweak
from .ops.colorspace import luma as luma_of
from .ops.resize import resize
from .utils.profiling import resolve_device, stage_timer
from .utils.transfer import (gray_to_rgb, rgb_unit_to_i420_u8, rgb_unit_to_uv420_u8, u8_to_unit,
                             unit_to_u8)

__all__ = ["HAVC_main_streaming", "HAVC_restore_video_streaming", "last_transfer"]

# the transfer modes the last streaming call selected, e.g. "gray+uv420"
_LAST_TRANSFER: Optional[str] = None


def last_transfer() -> Optional[str]:
    """Upload+download modes selected by the most recent streaming call
    (``None`` before any call), e.g. ``"gray+uv420"`` / ``"rgb+i420"``."""
    return _LAST_TRANSFER


def _resolve_transfer(transfer_format: str, even: bool, use_gray: bool,
                      luma_retuned: bool = False):
    """The download mode, recorded for ``last_transfer``.  ``uv420`` is
    sound only when the host owns the output luma (gray upload, nothing
    retunes luma on the device); an ``uv420`` request that fails that
    gate falls back to ``i420``; odd geometries fall back to RGB (I420
    needs even sides).  Returns ``(use_uv420, use_i420)``."""
    uv_ok = even and use_gray and not luma_retuned
    tf = transfer_format
    if tf == "auto":
        tf = "uv420" if uv_ok else ("i420" if even else "rgb")
    use_uv420 = tf == "uv420" and uv_ok
    use_i420 = (tf == "i420" or (tf == "uv420" and not uv_ok)) and even
    global _LAST_TRANSFER
    _LAST_TRANSFER = ("gray+" if use_gray else "rgb+") + (
        "uv420" if use_uv420 else "i420" if use_i420 else "rgb")
    return use_uv420, use_i420


class _FrameBuf:
    """Rolling device buffer of frames, stored as the stage's (B, ...)
    batches: one append per batch, one ``torch.cat`` per window, and a
    drop slices at most the boundary batch."""

    def __init__(self):
        self.segs: list = []  # tensors of shape (b_i, ...)
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def append(self, batch: torch.Tensor) -> None:
        self.segs.append(batch)
        self.n += int(batch.shape[0])

    def window(self, lo: int, hi: int) -> torch.Tensor:
        """Frames [lo, hi); indices below 0 repeat the first buffered frame
        and indices past the end the last, as the whole-clip ops clip
        their indices at the true clip ends."""
        if self.n == 0:
            raise ValueError("_FrameBuf.window: the buffer is empty")
        lo_c, hi_c = max(lo, 0), min(hi, self.n)
        if lo_c >= hi_c:
            raise ValueError(f"_FrameBuf.window: [{lo}, {hi}) holds none of the {self.n} "
                             "buffered frames")
        parts, pos = [], 0
        for s in self.segs:
            b = int(s.shape[0])
            s_lo, s_hi = max(lo_c - pos, 0), min(hi_c - pos, b)
            if s_lo < s_hi:
                parts.append(s if (s_lo, s_hi) == (0, b) else s[s_lo:s_hi])
            pos += b
        if lo < 0:
            parts.insert(0, parts[0][:1].expand(-lo, *parts[0].shape[1:]))
        if hi > self.n:
            parts.append(parts[-1][-1:].expand(hi - self.n, *parts[-1].shape[1:]))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def drop(self, k: int) -> None:
        """Forget the first ``k`` frames (their windows are complete)."""
        if not 0 <= k <= self.n:
            raise ValueError(f"_FrameBuf.drop({k}): {self.n} frames are buffered")
        while self.segs and int(self.segs[0].shape[0]) <= k:
            b = int(self.segs[0].shape[0])
            k -= b
            self.n -= b
            self.segs.pop(0)
        if k:
            self.segs[0] = self.segs[0][k:]
            self.n -= k


# OpenCV's BT.601 studio-swing Y of a full-range luma byte, the integer
# form cv2.COLOR_RGB2YUV_I420 applies
_STUDIO_Y = ((900726 * np.arange(256, dtype=np.int64) + (1 << 19) + (16 << 20)) >> 20).astype(
    np.uint8)


def _studio_y(v_u8: np.ndarray) -> np.ndarray:
    """Studio-swing Y planes of full-range luma bytes, equal to the Y plane
    of the device's I420 pack."""
    return _STUDIO_Y[v_u8]


class _Uploader:
    """uint8 batches to the device through a ring of pinned staging
    buffers: each upload is an asynchronous copy on the compute stream,
    and a buffer is refilled only once the event of its previous upload
    has completed.  The ring's length bounds how many batches the host
    queues ahead of the card.  On the CPU it hands the array over."""

    def __init__(self, dev: torch.device, slots: int):
        self.dev = dev
        self.bufs: list = [None] * slots
        self.events: list = [None] * slots
        self.k = 0
        self.waits = 0  # uploads that found their buffer still in flight

    def __call__(self, batch: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(batch))
        if self.dev.type != "cuda":
            return src.to(self.dev)
        i = self.k % len(self.bufs)
        self.k += 1
        ev = self.events[i]
        if ev is not None and not ev.query():
            self.waits += 1
            ev.synchronize()
        buf = self.bufs[i]
        if buf is None or buf.shape != src.shape:
            buf = self.bufs[i] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        stream = torch.cuda.current_stream(self.dev)
        out = buf.to(self.dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
        self.events[i] = ev
        return out


class _Packed(NamedTuple):
    """A packed chunk on its way to the host: the host tensor its download
    fills (None for the device sink) and the event that marks it done
    (None on the CPU)."""

    host: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]

    def wait(self) -> Optional[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return None if self.host is None else self.host.numpy()


class _WritePipeline:
    """The device -> host -> encoder path shared by both entry points.

    ``push`` starts the chunk's download at once: a copy stream waits for
    the compute stream, copies into pinned host memory and records an
    event.  Pushing retires the oldest chunks down to ``depth`` in flight
    (``depth=1``: the just-pushed chunk stays in flight, the one before it
    retires); ``finish`` retires all.  Retiring waits on the chunk's event
    only.

    ``sink``: ``"video"`` encodes through ``writer``; ``"null"`` downloads
    without encoding; ``"device"`` downloads nothing and waits on the
    event.  In uv420 mode ``y_provider(meta, n)`` gives the studio-swing
    Y planes (the host owns the output luma) for the ``meta`` queued with
    the chunk."""

    def __init__(self, sink: str, writer, depth: int, use_uv420: bool,
                 use_i420: bool, y_provider=None):
        self.sink = sink
        self.writer = writer
        self.depth = max(int(depth), 1)
        self.use_uv420 = use_uv420
        self.use_i420 = use_i420
        self.y_provider = y_provider
        self.pending: list = []
        self.written = 0
        self.waits = 0  # retired chunks whose event had not completed
        self._copy_stream = None

    def push(self, dev: torch.Tensor, meta, n: int) -> None:
        self.pending.append((self._download(dev), meta, n))
        self._drain(keep=self.depth)

    def finish(self) -> None:
        self._drain(keep=0)

    def _download(self, dev: torch.Tensor) -> _Packed:
        if not dev.is_cuda:
            return _Packed(None if self.sink == "device" else dev, None)
        compute = torch.cuda.current_stream(dev.device)
        ev = torch.cuda.Event()
        if self.sink == "device":
            ev.record(compute)
            return _Packed(None, ev)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev.device)
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        self._copy_stream.wait_stream(compute)
        with torch.cuda.stream(self._copy_stream):
            host.copy_(dev, non_blocking=True)
            ev.record(self._copy_stream)
        dev.record_stream(self._copy_stream)
        return _Packed(host, ev)

    def _drain(self, keep: int) -> None:
        while len(self.pending) > keep:
            self._retire(*self.pending.pop(0))

    def _retire(self, packed: _Packed, meta, n: int) -> None:
        if packed.event is not None and not packed.event.query():
            self.waits += 1
        with stage_timer("retire_wait"):
            host = packed.wait()
        if self.sink == "device":
            self.written += n
            return
        if self.writer is None:
            if self.use_uv420:
                with stage_timer("host_y"):
                    self.y_provider(meta, n)
            self.written += n
            return
        import cv2

        with stage_timer("encode"):
            if self.use_uv420:
                ystudio = self.y_provider(meta, n)
                for i in range(n):
                    fr = np.concatenate([ystudio[i], host[i]], axis=0)
                    self.writer.write(cv2.cvtColor(fr, cv2.COLOR_YUV2BGR_I420))
            else:
                conv = cv2.COLOR_YUV2BGR_I420 if self.use_i420 else cv2.COLOR_RGB2BGR
                for fr in host[:n]:
                    self.writer.write(cv2.cvtColor(fr, conv))
        self.written += n


def _is_gray(rgb: np.ndarray, tol: int = 3) -> bool:
    """True when a decoded frame's channels agree within ``tol`` code
    values (exactly gray, or B&W with a re-encode's chroma ringing)."""
    spread = (rgb.max(axis=-1).astype(np.int16) - rgb.min(axis=-1).astype(np.int16)).max()
    return int(spread) <= tol


def _probe(path: str, gray_input):
    """(fps, width, height, gray upload) of a video; ``gray_input="auto"``
    decides from its first frame."""
    with FrameReader(path) as reader:
        fps, w, h = reader.fps, reader.width, reader.height
        use_gray = bool(gray_input)
        if gray_input == "auto":
            probe = reader.read(1)
            use_gray = probe is not None and _is_gray(probe[0])
    if w <= 0 or h <= 0:
        raise IOError(f"cannot read video geometry: {path}")
    return fps, w, h, use_gray


def _open_writer(path_out: str, codec: str, fps: float, w: int, h: int):
    import cv2

    writer = cv2.VideoWriter(path_out, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer: {path_out}")
    return writer


def _build_frame_stage(
    method: int, mweight: float, do_model: int, dd_model: int,
    deoldify_rf: int, ddcolor_rf: int, dd_tweak, hue_range: str,
    hue_range2: str, chroma_adjust2: str, frame_size: int, device=None,
    bw_tune_id: int = 0, bw_method: int = 0,
):
    """The per-frame stage: uint8 or gray input -> optional BWTune
    (``bw_tune_frames`` at full resolution) -> spline64 work resize ->
    engines -> ``combine_models`` -> dark, smooth and colormap filters
    (the filters themselves, not the fused post-chain kernel, as the JAX
    streaming path runs them).  Returns ``stage(frames) -> (full-resolution
    luma planes, work-size colorized frames)``: the restore reads only the
    (tuned) original's luma."""
    dev = resolve_device(device)
    do_fn = dd_fn = None
    if method != 1:
        do_fn = engines.make_deoldify_fn(do_model, deoldify_rf, device=dev)
    if method != 0:
        dd_fn = engines.make_ddcolor_fn(dd_model, ddcolor_rf, tweaks_flags=tuple(dd_tweak),
                                        tweaks=(engines.DEF_TWEAK_p, hue_range), device=dev)
    cmap = (chroma_adjust2 or "none").lower()

    def stage(frames: torch.Tensor):
        if frames.ndim == 3:  # gray upload: 1 byte a pixel crossed the link
            frames = frames[..., None]
        if frames.dtype == torch.uint8:
            frames = u8_to_unit(frames)
        if frames.shape[-1] == 1:
            frames = gray_to_rgb(frames)
        if bw_tune_id > 0:
            with stage_timer("bw_tune"):
                frames = bw_tune_frames(frames, bw_tune_id, bw_method)
        with stage_timer("work_resize"):
            work = torch.clamp(resize(frames, frame_size, frame_size, "spline64"), 0.0, 1.0)
        if method == 0:
            with stage_timer("deoldify"):
                combined = do_fn(work)
        elif method == 1:
            with stage_timer("ddcolor"):
                combined = dd_fn(work)
        else:
            with stage_timer("deoldify"):
                a = do_fn(work)
            with stage_timer("ddcolor"):
                b = dd_fn(work)
            with stage_timer("merge"):
                combined = merge_ops.combine_models(a, b, method=method, b_weight=mweight)
        with stage_timer("post_filters"):
            x = dark_tweak(combined, dark_threshold=0.2, dark_amount=0.8)
            x = chroma_bright_tweak(
                x, black_threshold=0.3, white_threshold=0.7, dark_sat=0.9,
                dark_bright=-0.0, chroma_adjust=(hue_range2 or "none").lower(),
            )
            if cmap not in ("none", ""):
                x = colormap_filter(x, cmap)
        return luma_of(frames), x

    return stage


def _pack(out: torch.Tensor, use_uv420: bool, use_i420: bool) -> torch.Tensor:
    """The uint8 form a chunk crosses the link in."""
    with stage_timer("pack"):
        if use_uv420:
            return rgb_unit_to_uv420_u8(out)
        if use_i420:
            return rgb_unit_to_i420_u8(out)
        return unit_to_u8(out)


@torch.inference_mode()
def HAVC_main_streaming(
    path_in: str,
    path_out: str,
    Preset: str = "medium",
    ColorModel: str = "video+artistic",
    CombMethod: str = "constrained-chroma",
    VideoTune: str = "balanced",
    ColorFix: str = "violet/red",
    ColorTune: str = "light",
    ColorMap: str = "none",
    BWTune: str = "none",
    bw_method: int = 0,
    LUT: Optional[int] = None,
    EnableDeflicker: bool = True,
    enable_stabilizer: bool = True,
    stab_p=(5, "A", 1, 15, 0.2, 0.8),
    batch_size: int = 8,
    chunk_size: int = 64,
    count: Optional[int] = None,
    codec: str = "mp4v",
    gray_input="auto",
    transfer_format: str = "auto",
    pipeline_depth: int = 3,
    sink: str = "video",
    source: str = "video",
    device=None,
) -> int:
    """Classic HAVC_main as a bounded-memory stream; returns the frames
    written.  Same parameters and defaults as the JAX package's, plus
    ``device`` (``None``: CUDA, raising without it).

    - ``gray_input``: ``"auto"`` uploads luma only (1 byte a pixel) when
      the first decoded frame's channels agree within 3 code values;
      ``True`` always, ``False`` never (RGB, 3 bytes a pixel).
    - ``transfer_format``: ``"auto"`` picks ``"uv420"`` (chroma planes
      only, 0.5 bytes a pixel: the host holds the luma and runs the luma
      deflicker on its Y planes) with gray upload, else ``"i420"``
      (OpenCV-exact BT.601 studio swing, 1.5 bytes a pixel), else
      ``"rgb"`` for odd geometries.
    - ``pipeline_depth``: packed chunks in flight on the download/write
      path before the oldest retires (1: one chunk behind).
    - ``sink``: ``"video"`` encodes to ``path_out``; ``"null"`` downloads
      without encoding; ``"device"`` downloads nothing.
    - ``source``: ``"video"`` decodes every frame; ``"device"`` uploads
      one decoded batch once and feeds it ``count // batch_size`` times
      (``count`` required), the compute-only measurement.

    - ``BWTune`` / ``bw_method``: the full-resolution BW tune before the
      work resize; ``LUT``: a built-in look (and its tweak) after the
      restore.  Both retune luma on the device, so ``auto`` picks
      ``i420``.

    ``.y4m`` input is read without OpenCV; other containers and the
    ``video`` sink need it."""
    if sink not in ("video", "null", "device"):
        raise ValueError(f"HAVC_main_streaming: unknown sink {sink!r}")
    if source not in ("video", "device"):
        raise ValueError(f"HAVC_main_streaming: unknown source {source!r}")
    if source == "device":
        if count is None:
            raise ValueError("HAVC_main_streaming: source='device' requires count")
        if int(count) < batch_size:
            raise ValueError(
                "HAVC_main_streaming: source='device' processes count rounded DOWN to a batch "
                f"multiple — count must be >= batch_size ({batch_size}), got {count}")
    dev = resolve_device(device)

    _, deoldify_rf, ddcolor_rf = presets.get_render_factors(Preset)
    do_model, dd_model, dd_method = presets.get_color_model(ColorModel)
    mweight = presets.get_mweight(VideoTune)
    method = presets.get_comb_method(CombMethod)
    if dd_method in (0, 1):
        method = dd_method
    dd_tweak, hue_range, hue_range2, _, chroma_adjust2 = presets.get_color_tune(
        ColorTune, ColorFix, ColorMap, dd_model)
    bw_tune_id = presets.get_tune_id(BWTune)

    fps, w, h, use_gray = _probe(path_in, gray_input)
    even = h % 2 == 0 and w % 2 == 0
    # BWTune retunes luma on the device; a LUT remaps luma and chroma jointly
    use_uv420, use_i420 = _resolve_transfer(transfer_format, even, use_gray,
                                            luma_retuned=bw_tune_id > 0 or LUT is not None)
    # in uv420 mode the (luma-only) deflicker runs on the host's Y planes
    dev_deflicker = EnableDeflicker and not use_uv420

    frame_size = min(max(ddcolor_rf, deoldify_rf) * 16, w)
    stage = _build_frame_stage(method, mweight, do_model, dd_model, deoldify_rf, ddcolor_rf,
                               dd_tweak, hue_range, hue_range2, chroma_adjust2, frame_size,
                               device=dev, bw_tune_id=bw_tune_id, bw_method=bw_method)

    # stab_p: (nframes, 'A'|'W', sat, tht, inner merge weight, tht_scen)
    stab_nframes = int(stab_p[0])
    stab_weighted = str(stab_p[1]).upper().startswith("W")
    stab_sat, stab_tht, stab_back = float(stab_p[2]), float(stab_p[3]), float(stab_p[4])
    stab_tht_scen = float(stab_p[5]) if len(stab_p) > 5 else 0.8
    nf = min(max(stab_nframes, 3), 15)
    nf = nf + 1 if nf % 2 == 0 else nf  # chroma_stabilizer rounds up to odd
    # halos: the temporal chroma window at work size, plus one frame of
    # full-resolution deflicker context each side on the device; in uv420
    # mode the host deflicker needs y[next] at the chunk's end, so the
    # flush keeps one more frame of decode lead
    halo_t = ((nf - 1) // 2) if enable_stabilizer else 0
    halo_d = 1 if dev_deflicker else 0
    halo_win = halo_t + halo_d
    halo = halo_win + (1 if (EnableDeflicker and use_uv420) else 0)

    def temporal_chunk(x, f0):
        # f0 = global index of x[0] keeps the warm-up of the first 15
        # frames aligned with the whole clip's
        with stage_timer("temporal"):
            return temporal_ops.chroma_stabilizer(
                x, nframes=stab_nframes, weighted=stab_weighted, sat=stab_sat, tht=stab_tht,
                weight=stab_back, tht_scen=stab_tht_scen, frame0=f0)

    # the look's lattice goes to the card once, before the loop
    table = lut3d.lattice_on(lut3d.make_look_lut(LUT), dev) if LUT is not None else None
    lut_tweaks = lut3d.LUT_TWEAKS.get(LUT) if LUT is not None else None

    def look(x):
        out = lut3d.apply_lut3d(x, table)
        if lut_tweaks is not None:
            hue, sat, bright, cont, gamma = lut_tweaks
            out = tweak(out, hue=hue, sat=sat, bright=bright / 255.0, cont=cont, gamma=gamma)
        return out

    def restore_chunk(hi_y, lo):
        """Full-resolution tail: luma restore, the LUT look, then the device
        deflicker (the in-memory order: stabilizer, HAVC_TimeCube,
        reduce_flicker)."""
        with stage_timer("restore"):
            out = recover_clip_luma_y(hi_y, torch.clamp(resize(lo, h, w, "spline64"), 0.0, 1.0))
            if table is not None:
                # a batch at a time: the lookup's gathers and the tweak's
                # sort over a whole chunk at 1080p took 24 GB
                out = torch.cat([look(out[i:i + batch_size])
                                 for i in range(0, out.shape[0], batch_size)])
            if dev_deflicker:
                out = temporal_ops.reduce_flicker(out)
            return out

    writer = _open_writer(path_out, codec, fps, w, h) if sink == "video" else None
    # the rolling device buffers: full-resolution luma planes and the
    # colorized work-size frames; frame 0 of each is global frame
    # `global_start`
    orig_buf, work_buf = _FrameBuf(), _FrameBuf()
    global_start = next_emit = 0

    # host Y planes for the uv420 tail: the decoded gray bytes, of which
    # the stage luma is exactly the /255 in gray-upload mode
    y_host: list = []
    y_base = 0

    def _host_y_window(start, ready):
        """Host luma tail: deflicker (reduce_flicker's arithmetic, luma
        only) of y[start-1 .. start+ready], clipped at the clip's ends,
        then the studio-swing Y mapping of the device's I420 pack.  Runs
        on the host CPU in float32, as the JAX package's numpy does, one
        frame at a time so that its planes stay in cache (a whole chunk's
        float temporaries made it ~15x slower)."""
        n_dec = y_base + len(y_host)

        def plane(i):
            y = torch.from_numpy(y_host[max(0, min(i, n_dec - 1)) - y_base])
            return y.to(torch.float32) / 255.0

        out = np.empty((ready, h, w), np.uint8)
        prev, cur = plane(start - 1), plane(start)
        for k in range(ready):
            nxt = plane(start + k + 1)
            y = cur
            if EnableDeflicker:
                target = 0.5 * (prev + nxt)
                limit = 5.0 / 255.0
                corr = torch.clamp(0.5 * (target - cur), -limit, limit)
                y = torch.clamp(cur + corr, 0.0, 1.0)
            out[k] = _studio_y(torch.round(y * 255.0).to(torch.uint8).numpy())
            prev, cur = cur, nxt
        return out

    def _y_for_chunk(start, ready):
        # at retire time; trims the host Y planes, keeping one past plane
        # for the next chunk's deflicker
        nonlocal y_base
        ystudio = _host_y_window(start, ready)
        keep_from = start + ready - 1
        if keep_from > y_base:
            del y_host[: keep_from - y_base]
            y_base = keep_from
        return ystudio

    pipe = _WritePipeline(sink, writer, pipeline_depth, use_uv420, use_i420,
                          y_provider=_y_for_chunk)
    # the host may queue a chunk and its halo ahead of the card, so that a
    # retire's host work never leaves the card without queued work
    upload = _Uploader(dev, slots=-(-(chunk_size + halo) // batch_size) + 2)

    def flush(final: bool):
        """Emit every frame whose temporal window is complete (all when
        ``final``), from host integers alone."""
        nonlocal global_start, next_emit
        while True:
            avail = global_start + len(work_buf) - next_emit
            if final:
                ready = min(avail, chunk_size)
            else:
                ready = chunk_size if avail - halo >= chunk_size else 0
            if ready <= 0:
                return
            lo = next_emit - global_start
            hi = lo + ready
            orig_ctx = orig_buf.window(lo - halo_d, hi + halo_d)
            if not enable_stabilizer:
                work_ctx = work_buf.window(lo - halo_d, hi + halo_d)
            else:
                # both halos, then the deflicker-context interior, whose
                # chroma windows are complete
                ext = work_buf.window(lo - halo_win, hi + halo_win)
                smoothed = temporal_chunk(ext, next_emit - halo_win)
                work_ctx = smoothed[halo_t: halo_t + ready + 2 * halo_d]
            out = restore_chunk(orig_ctx, work_ctx)[halo_d: halo_d + ready]
            pipe.push(_pack(out, use_uv420, use_i420), next_emit, ready)
            next_emit += ready
            # keep the window's past frames for the next chunk
            drop = max((next_emit - halo_win) - global_start, 0)
            if drop:
                orig_buf.drop(drop)
                work_buf.drop(drop)
                global_start += drop

    with contextlib.ExitStack() as cleanup:
        if writer is not None:
            cleanup.callback(writer.release)
        first_host = None
        if source == "device":
            # one decoded batch uploaded once, then fed again and again:
            # the same compute, chunk and pack work with no decode and no
            # upload inside the run
            with contextlib.closing(stream_batches(path_in, batch_size, prefetch=1,
                                                   count=batch_size, gray=use_gray)) as it:
                first_host = next(it, None)
            if first_host is None:
                raise IOError(f"HAVC_main_streaming: no frames decoded from {path_in}")
            if first_host.shape[0] < batch_size:
                first_host = np.concatenate(
                    [first_host, np.repeat(first_host[-1:], batch_size - first_host.shape[0],
                                           axis=0)])
            dev0 = upload(first_host)
            batches = (dev0 for _ in range(int(count) // batch_size))
        else:
            batches = cleanup.enter_context(contextlib.closing(
                stream_batches(path_in, batch_size, prefetch=4, count=count, gray=use_gray)))

        for batch in batches:
            if isinstance(batch, torch.Tensor):
                n, up = batch_size, batch
            else:
                n = int(batch.shape[0])
                padded = batch if n == batch_size else np.concatenate(
                    [batch, np.repeat(batch[-1:], batch_size - n, axis=0)])
                with stage_timer("upload"):
                    up = upload(padded)
            tuned, colored = stage(up)
            if use_uv420 and sink != "device":
                y_host.extend((first_host if first_host is not None else batch)[:n])
            orig_buf.append(tuned if n == batch_size else tuned[:n])
            work_buf.append(colored if n == batch_size else colored[:n])
            flush(final=False)
        flush(final=True)
        pipe.finish()
    return pipe.written


# ---------------------------------------------------------------------------
# HAVC_restore_video_streaming
# ---------------------------------------------------------------------------


@torch.inference_mode()
def HAVC_restore_video_streaming(
    path_in: str,
    path_ref: str,
    path_out: str,
    render_speed: str = "medium",
    engine_config: Optional[str] = None,
    sc_threshold: float = 0.10,
    chunk_size: int = 32,
    count: Optional[int] = None,
    codec: str = "mp4v",
    work_size: Optional[tuple] = None,
    gray_input="auto",
    transfer_format: str = "auto",
    ex_model: int = 0,
    render_vivid: bool = False,
    frame_propagate: bool = True,
    max_memory_frames: int = 0,
    ref_freq: Optional[int] = None,
    pipeline_depth: int = 3,
    sink: str = "video",
    frame_mindim: int = 320,
    device=None,
) -> int:
    """Exemplar restore as a bounded-memory stream: a B&W video recolored
    from a synchronized colored reference video, chunk by chunk, with each
    engine's state carried across chunks so that the output equals the
    whole clip's.  Same parameters and defaults as the JAX package's, plus
    ``device``.

    - ``ex_model=0`` (ColorMNet): the memory network's state
      (``resume_state``) flows from one chunk to the next.
    - ``ex_model=1`` (Deep-Exemplar): frames are independent given their
      scene's reference, so the carry is the current scene's reference,
      set on the first frame of a chunk that starts inside a scene.
    - ``ex_model=2`` (DeepRemaster): at ``remaster_work_shape``
      (``frame_mindim``), ``chunk_size`` rounded up to an even count; a
      reference every ``ref_freq`` (10) frames.  A look-ahead cursor
      decodes the reference video ahead of the input just far enough to
      know the next ``ref_buffer_size`` (``max_memory_frames`` or 20)
      references, and each chunk gets the trimmed slice of references
      with their global positions (``frame0``), so the sliding window
      replays the whole clip's; output stops where the reference ends.
      Memory: the chunk plus the window of references at work size.
    - ``ex_model=3`` (the hybrid): ``0.7 * ColorMNet + 0.3 * DeepEx``
      (vivid).

    A reference frame is a scene change when its mean absolute luma
    difference from the previous scene change's exceeds ``sc_threshold``
    (carried across chunks), or every ``ref_freq`` frames when > 1.  The
    reference video may have its own geometry: both meet at the work size
    (SmartResize of ``render_speed``, or ``work_size``).  ``gray_input``,
    ``transfer_format``, ``pipeline_depth`` and ``sink`` behave as in
    :func:`HAVC_main_streaming`."""
    from .exemplar import (DEF_VIVID_HUE_HIGH, DEF_VIVID_HUE_LOW, DEF_VIVID_SAT_HIGH,
                           DEF_VIVID_SAT_LOW, DeepExEngine, RemasterEngine, _get_engine,
                           colormnet_propagate, deepex_propagate, pad112_geometry,
                           remaster_propagate, remaster_work_shape, resolve_engine_config,
                           smart_resize_shape)
    from .ops.chroma import chroma_tweak
    from .ops.colorspace import lab_to_rgb, rgb_to_lab
    from .ops.resize import smart_resize_pad, smart_resize_restore

    if ex_model not in (0, 1, 2, 3):
        raise ValueError(f"HAVC_restore_video_streaming: unsupported ex_model {ex_model}")
    if sink not in ("video", "null", "device"):
        raise ValueError(f"HAVC_restore_video_streaming: unknown sink {sink!r}")
    dev = resolve_device(device)
    engine_config = resolve_engine_config(engine_config)
    if ref_freq is None:
        ref_freq = 10 if ex_model == 2 else 0  # DeepRemaster needs periodic references
    length = 2  # DeepRemaster's frames a forward
    if ex_model == 2 and chunk_size % length:
        chunk_size += 1  # chunk edges on window edges

    fps, w, h, use_gray = _probe(path_in, gray_input)
    # the output luma is the decoded B&W luma, so with the gray upload the
    # host can rebuild frames from the chroma planes alone
    use_uv420, use_i420 = _resolve_transfer(transfer_format, h % 2 == 0 and w % 2 == 0,
                                            use_gray)
    if work_size is not None:
        wh, ww = work_size
    elif ex_model == 2:  # NetworkC needs /16 sides
        wh, ww = remaster_work_shape(w, h, frame_mindim)
    else:
        wh, ww = smart_resize_shape(w, h, render_speed)
    _, pad_meta = smart_resize_pad(torch.zeros((1, h, w, 3), device=dev), wh, ww)

    def pad_fn(x):
        with stage_timer("work_resize"):
            return smart_resize_pad(x, wh, ww, "spline64")[0]

    def restore_fn(hi, lo):
        with stage_timer("restore"):
            return recover_clip_luma(hi, smart_resize_restore(lo, pad_meta, "spline64"))

    def sc_scan(refs, last, has_last, n0):
        """Resumable scene detection on the reference frames, one device
        step a frame: a frame is a reference when its mean |luma - last
        reference's luma| exceeds the threshold; ``last`` carries the last
        reference's luma across frames and chunks."""
        with stage_timer("scene_scan"):
            flags = []
            for i, lu in enumerate(luma_of(refs)):
                flag = ~has_last | ((lu - last).abs().mean() > sc_threshold)
                if ref_freq > 1 and (n0 + i) % ref_freq == 0:
                    flag = torch.ones_like(flag)
                last = torch.where(flag, lu, last)
                has_last = has_last | flag
                flags.append(flag)
            return torch.stack(flags), last, has_last

    state = None  # ColorMNet carry
    if ex_model in (0, 3):
        # the engine runs at the pad112 geometry (the 1/14 and 1/16 grids
        # align); colormnet_propagate pads in normalised-LAB space and unpads
        ph, pw = pad112_geometry(wh, ww)[:2]
        kw = dict(config=engine_config, work_size=(ph, pw), device=dev)
        if max_memory_frames > 0:
            kw["max_mem"] = int(max_memory_frames)
        cm_engine = _get_engine(**kw)

    def run_colormnet(work, work_refs, is_ref):
        nonlocal state
        ref_ab = torch.clamp(rgb_to_lab(work_refs)[..., 1:3] / 110.0, -1.0, 1.0)
        ab, state = colormnet_propagate(cm_engine, work, ref_ab, is_ref,
                                        frame_propagate=frame_propagate, vivid=render_vivid,
                                        resume_state=state, return_state=True)
        with stage_timer("cm_join"):
            lab = torch.cat([rgb_to_lab(work)[..., 0:1], ab * 110.0], dim=-1)
            return torch.clamp(lab_to_rgb(lab), 0.0, 1.0)

    carry_ref = None  # DeepEx: the current scene's reference at its size
    if ex_model in (1, 3):
        dx_engine = DeepExEngine(render_speed, dev)

    def run_deepex(work, work_refs, is_ref, vivid):
        nonlocal carry_ref
        with stage_timer("deepex_resize"):
            dxf = torch.clamp(resize(work, dx_engine.h, dx_engine.w, "spline64"), 0.0, 1.0)
            dxr = torch.clamp(resize(work_refs, dx_engine.h, dx_engine.w, "spline64"), 0.0, 1.0)
        flags = np.asarray(is_ref, bool).copy()
        if not flags[0]:  # a chunk that starts inside a scene: its reference first
            flags[0] = True
            dxr = torch.cat([carry_ref, dxr[1:]])
        out = deepex_propagate(dx_engine, dxf, dxr, flags, frame_propagate=frame_propagate,
                               vivid=vivid)
        li = int(np.nonzero(flags)[0][-1])
        carry_ref = dxr[li:li + 1]
        with stage_timer("deepex_resize"):
            return torch.clamp(resize(out, wh, ww, "spline64"), 0.0, 1.0)

    writer = _open_writer(path_out, codec, fps, w, h) if sink == "video" else None
    # uv420: the host Y is the studio-swing map of its own decoded gray
    # bytes (the output luma is the input luma here), queued per chunk
    pipe = _WritePipeline(sink, writer, pipeline_depth, use_uv420, use_i420,
                          y_provider=lambda y_u8, t: _studio_y(y_u8))
    up_in, up_ref = _Uploader(dev, slots=2), _Uploader(dev, slots=2)
    with contextlib.ExitStack() as cleanup:
        if writer is not None:
            cleanup.callback(writer.release)
        with FrameReader(path_ref) as probe_ref:
            rh, rw = probe_ref.height or h, probe_ref.width or w
        last_ref_luma = torch.zeros((rh, rw), device=dev)
        has_last = torch.zeros((), dtype=torch.bool, device=dev)
        # the input decodes on a background thread, a chunk at a time
        chunks_in = cleanup.enter_context(contextlib.closing(
            stream_batches(path_in, chunk_size, prefetch=2, count=count, gray=use_gray)))
        if ex_model == 2:
            # DeepRemaster: a look-ahead cursor over the reference video
            # finds the scene-change references ahead of the input; it
            # holds the reference window's frames at work size
            ref_reader = cleanup.enter_context(FrameReader(path_ref))
            rm_engine = RemasterEngine(frame_mindim, dev)
            buf = int(max_memory_frames) if max_memory_frames > 0 else 20
            refs_found = dict(imgs=[], pos=[], base=0, n=0, eof=False)

            def scan_more_refs(batch: int = 32):
                nonlocal last_ref_luma, has_last
                with stage_timer("decode"):
                    fr = ref_reader.read(batch)
                if fr is None:
                    refs_found["eof"] = True
                    return
                with stage_timer("upload"):
                    rgb = u8_to_unit(up_ref(fr))
                flags, last_ref_luma, has_last = sc_scan(rgb, last_ref_luma, has_last,
                                                         refs_found["n"])
                idx = np.nonzero(flags.cpu().numpy())[0]  # which frames to keep
                if len(idx):
                    sel = torch.stack([rgb[int(i)] for i in idx])
                    if render_vivid:  # the pre-tweak at the reference's size
                        sel = chroma_tweak(sel, sat=DEF_VIVID_SAT_HIGH, hue=int(DEF_VIVID_HUE_LOW))
                    refs_found["imgs"] += list(pad_fn(sel))
                    refs_found["pos"] += [refs_found["n"] + int(i) for i in idx]
                refs_found["n"] += len(fr)
                if len(fr) < batch:
                    refs_found["eof"] = True

            def found() -> int:
                return refs_found["base"] + len(refs_found["pos"])

            def ensure_refs(k: int):
                while found() < k and not refs_found["eof"]:
                    scan_more_refs()

            ensure_refs(buf)
            S = min(buf, found()) if refs_found["eof"] else buf
            half_idx = max(round(S * (1.0 - 0.5)) - 1, 0)
            ws = 0  # the sliding window's global start

            def run_remaster(work, f0, t):
                nonlocal ws
                ws0, base = ws, refs_found["base"]
                # replay the window's advance for every window start of the
                # chunk, decoding the reference video ahead on demand
                for st in range(f0, f0 + t, length):
                    while True:
                        ensure_refs(ws + S + 1)
                        if refs_found["eof"] and ws + S >= found():
                            break
                        if not st > refs_found["pos"][ws + half_idx - base]:
                            break
                        ws += 1
                hi = min(ws + S, found())
                colored = remaster_propagate(
                    rm_engine, work, torch.stack(refs_found["imgs"][ws0 - base:hi - base]),
                    length=length, ref_positions=np.asarray(refs_found["pos"][ws0 - base:hi - base]),
                    ref_buffer_size=buf, frame0=f0)
                if render_vivid:
                    colored = chroma_tweak(colored, sat=DEF_VIVID_SAT_LOW,
                                           hue=int(DEF_VIVID_HUE_HIGH))
                if ws > base:  # references below the window are not read again
                    del refs_found["imgs"][:ws - base], refs_found["pos"][:ws - base]
                    refs_found["base"] = ws
                return colored
        else:
            chunks_ref = cleanup.enter_context(contextlib.closing(
                stream_batches(path_ref, chunk_size, prefetch=2, count=count)))
        emitted = 0
        while count is None or emitted < count:
            n = chunk_size if count is None else min(chunk_size, count - emitted)
            with stage_timer("decode"):  # the wait for the decode threads
                bw_u8 = next(chunks_in, None)
                refs_u8 = None
                if bw_u8 is not None and ex_model != 2:
                    refs_u8 = next(chunks_ref, None)
            if bw_u8 is None or (ex_model != 2 and refs_u8 is None):
                break
            if ex_model == 2:  # no input frame past the reference's end
                while not refs_found["eof"] and refs_found["n"] < emitted + len(bw_u8):
                    scan_more_refs()
                t = min(len(bw_u8), max(refs_found["n"] - emitted, 0))
                if t <= 0:
                    break
            else:
                t = min(len(bw_u8), len(refs_u8))
            bw_u8 = bw_u8[:t]
            with stage_timer("upload"):
                bw = u8_to_unit(up_in(bw_u8))
            if use_gray:
                bw = gray_to_rgb(bw)
            work = pad_fn(bw)
            if ex_model == 2:
                colored_small = run_remaster(work, emitted, t)
            else:
                with stage_timer("upload"):
                    refs = u8_to_unit(up_ref(refs_u8[:t]))
                flags, last_ref_luma, has_last = sc_scan(refs, last_ref_luma, has_last, emitted)
                is_ref = flags.cpu().numpy()  # the engines' branches need them
                work_refs = pad_fn(refs)
                if ex_model == 0:
                    colored_small = run_colormnet(work, work_refs, is_ref)
                elif ex_model == 1:
                    colored_small = run_deepex(work, work_refs, is_ref, render_vivid)
                else:  # the hybrid
                    a = run_colormnet(work, work_refs, is_ref)
                    colored_small = a * 0.7 + run_deepex(work, work_refs, is_ref, True) * 0.3
            full = restore_fn(bw, colored_small)
            pipe.push(_pack(full, use_uv420, use_i420), bw_u8 if use_uv420 else None, t)
            emitted += t
            if t < n:
                break
        pipe.finish()
    return pipe.written
