"""Utility helpers: stage timing, the device rule, the uint8 transfer
boundary and the log."""

from .log import HAVC_LogMessage, HAVCError, MessageType, get_logger  # noqa: F401

from .profiling import (  # noqa: F401
    device_trace,
    enable_profiling,
    on_device,
    profiling_enabled,
    reset_stages,
    resolve_device,
    stage_report,
    stage_timer,
    stage_times,
)
from .transfer import (  # noqa: F401
    gray_to_rgb,
    rgb_unit_to_i420_u8,
    rgb_unit_to_uv420_u8,
    u8_to_unit,
    unit_to_u8,
)
