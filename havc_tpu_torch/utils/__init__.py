"""Utility helpers: stage timing and the device rule."""

from .profiling import (  # noqa: F401
    enable_profiling,
    profiling_enabled,
    reset_stages,
    resolve_device,
    stage_report,
    stage_timer,
    stage_times,
)
