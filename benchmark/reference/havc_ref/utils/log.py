"""Frozen copy of the port's ``havc_tpu_torch/utils/log.py`` (the benchmark's plain
reference).

Logging: the reference's ``HAVC_LogMessage`` surface.

Port of ``havc_tpu.utils.log``.  Messages go to the stdlib ``logging``
module (logger ``havc_tpu_torch``), so the host application routes them;
``MessageType.EXCEPTION`` raises :class:`HAVCError` instead of logging.
"""
from __future__ import annotations

import logging
from enum import IntEnum

__all__ = ["MessageType", "HAVCError", "HAVC_LogMessage", "get_logger"]

_logger = logging.getLogger("havc_tpu_torch")


class HAVCError(RuntimeError):
    """Raised by ``HAVC_LogMessage(MessageType.EXCEPTION, ...)`` and by
    the checks that refuse an input (the reference's ``vs.Error``)."""


class MessageType(IntEnum):
    """The reference's message levels (VapourSynth ``MESSAGE_TYPE_*``)."""

    DEBUG = 0
    INFORMATION = 1
    WARNING = 2
    CRITICAL = 3
    FATAL = 4
    EXCEPTION = 10


_LEVELS = {
    MessageType.DEBUG: logging.DEBUG,
    MessageType.INFORMATION: logging.INFO,
    MessageType.WARNING: logging.WARNING,
    MessageType.CRITICAL: logging.CRITICAL,
    MessageType.FATAL: logging.CRITICAL,
}


def get_logger() -> logging.Logger:
    return _logger


def HAVC_LogMessage(message_type: MessageType = MessageType.INFORMATION, *args) -> None:
    """Log the arguments joined by one space (or raise them, for
    EXCEPTION)."""
    message_text = " ".join(map(str, args))
    if message_type == MessageType.EXCEPTION:
        raise HAVCError(message_text)
    _logger.log(_LEVELS.get(MessageType(message_type), logging.INFO), message_text)
