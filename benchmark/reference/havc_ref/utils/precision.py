"""Frozen copy of the port's ``havc_tpu_torch/utils/precision.py`` (the benchmark's plain
reference).

The port's float32 precision on the card: the counterpart of XLA's
precision config in the JAX package.

The JAX package runs its engines' convolutions and dots at XLA's DEFAULT
precision, which its accelerator computes with reduced-precision operands,
and pins ``Precision.HIGHEST`` (full float32) where reduced precision
showed: the spline/kernel resizes, ``jax.image.resize`` (HIGHEST by
default) and ColorMNet's memory similarity.  The port keeps the same
rule, **engines reduced, everything else IEEE**:

* ``engine_precision(device)`` runs a block at ``engine_fp32_precision(
  device)``: on a CUDA device TF32 tensor cores (a 10-bit mantissa, against
  the bf16 operands of XLA's DEFAULT on the TPU), on the CPU IEEE float32.
  DeOldify, DDColor, Zhang, Deep-Exemplar and the float32 ColorMNet and
  NetworkC run inside it (their doors in ``engines``, ``exemplar`` and
  ``parallel.mesh`` enter it);
* ``ieee_precision()`` runs a block at IEEE float32, the counterpart of
  ``Precision.HIGHEST``: the resizes (``ops.resize``), ColorMNet's
  ``get_similarity``, window attention's plain version and the filters
  and scene detectors outside the engines, whose thresholds must decide
  on the card as on the CPU.

A caller asks for IEEE float32 everywhere through PyTorch's own flags, as
a JAX user asks with ``jax.default_matmul_precision("highest")``:
``torch.backends.cuda.matmul.fp32_precision = "ieee"`` or
``torch.backends.cudnn.conv.fp32_precision = "ieee"`` (the legacy
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` map onto these, and so does
``torch.set_float32_matmul_precision("highest")``, which sets the matmul
flag to ``"ieee"``).  PyTorch's defaults, matmul ``"none"`` and cuDNN
convolutions ``"tf32"``, mean "not set": the engines then run TF32.  Any
other matmul setting (``"tf32"``, or the bf16 of ``"medium"``) also
resolves to TF32.

Both contexts set the matmul flag and cuDNN's conv and RNN flags through
the ``fp32_precision`` API alone, restore what they found on exit, an
exception included, and nest: the innermost one wins.  Inside them read
the flags through ``fp32_precision`` (``fp32_flags``): PyTorch raises on
a legacy read (``allow_tf32``, ``torch.get_float32_matmul_precision()``,
``torch.backends.cudnn.flags()``) while the two APIs disagree.  The
flags are process-wide, so the contexts are entered only on the thread
that queues the work; in the port that is the main thread (the decode
thread of ``io.stream`` and the write pipeline queue no products).
Importing the package sets no flag.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Union

import torch

__all__ = ["IEEE", "TF32", "engine_fp32_precision", "engine_precision", "ieee_precision",
           "fp32_flags"]

IEEE = "ieee"
TF32 = "tf32"


def fp32_flags() -> Dict[str, str]:
    """PyTorch's float32 precision flags as its getters report them."""
    return {"matmul": torch.backends.cuda.matmul.fp32_precision,
            "conv": torch.backends.cudnn.conv.fp32_precision,
            "rnn": torch.backends.cudnn.rnn.fp32_precision}


def engine_fp32_precision(device: Union[str, torch.device]) -> str:
    """The engines' float32 precision on ``device``: ``TF32`` on a CUDA
    device unless the caller set the matmul flag to ``"ieee"`` or cuDNN's
    conv flag away from its default ``"tf32"``; ``IEEE`` elsewhere."""
    if torch.device(device).type != "cuda":
        return IEEE
    flags = fp32_flags()
    return IEEE if flags["matmul"] == IEEE or flags["conv"] != TF32 else TF32


def _set(flags: Dict[str, str]) -> None:
    torch.backends.cuda.matmul.fp32_precision = flags["matmul"]
    torch.backends.cudnn.conv.fp32_precision = flags["conv"]
    torch.backends.cudnn.rnn.fp32_precision = flags["rnn"]


@contextlib.contextmanager
def _precision(value: str) -> Iterator[str]:
    found = fp32_flags()
    _set(dict.fromkeys(found, value))
    try:
        yield value
    finally:
        _set(found)


def engine_precision(device: Union[str, torch.device]):
    """Context: matmuls and cuDNN convolutions at
    ``engine_fp32_precision(device)``."""
    return _precision(engine_fp32_precision(device))


def ieee_precision():
    """Context (also a decorator): matmuls and cuDNN convolutions at IEEE
    float32, whatever the process's flags."""
    return _precision(IEEE)
