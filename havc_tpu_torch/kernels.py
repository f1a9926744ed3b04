"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` (the hash is of the source
and of its full command line, so an edited source or a changed flag is
rebuilt), then loaded with ``ctypes``.  Every source shares
``NVCC_FLAGS`` and adds its own ``Kernel.flags``.  Nothing is built when
this module is imported: ``load`` builds on first use, ``build_all``
builds every source at once with one ``nvcc`` process per source running
in parallel.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

__all__ = ["load", "build_all", "build_command", "sass_counts", "SOURCES", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Kernel(NamedTuple):
    flags: Tuple[str, ...]  # this source's own nvcc flags, after NVCC_FLAGS
    entries: Dict[str, Tuple[list, type]]  # C entry point -> (argtypes, restype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

SOURCES = {
    # bit-exact HSV arithmetic: no multiply-add contraction
    "post_chain": Kernel(
        flags=("-fmad=false",),
        entries={
            "post_chain_launch": ([_P, _P, ctypes.c_longlong, _P, _P], _I),
            "post_chain_check_forms": ([_P, _P], _I),
        },
    ),
    # contraction allowed: the tolerance covers another rounding order
    "window_attn": Kernel(
        flags=(),
        entries={
            "window_attn_launch": ([_P] * 6 + [_I] * 6 + [_F, _I, _P], _I),
            "window_attn_scratch_floats": ([_I] * 4, ctypes.c_longlong),
        },
    ),
    # window attention on bf16 inputs, on the tensor cores; the same
    "window_attn_tc": Kernel(
        flags=(),
        entries={
            "window_attn_tc_launch": ([_P] * 5 + [_I] * 6 + [_F, _P], _I),
            "window_attn_tc_smem": ([_I] * 6, ctypes.c_longlong),
        },
    ),
    # the U-Net decoders' upsample-and-join, bit-identical to PyTorch's
    # chain: no multiply-add contraction
    "unet_join": Kernel(
        flags=("-fmad=false",),
        entries={
            "unet_join_launch": ([_P] * 7 + [_I] * 6 + [_P], _I),
        },
    ),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
build_logs: Dict[str, str] = {}  # name -> nvcc's output (ptxas register report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("havc_tpu_torch: nvcc not found; the CUDA kernels "
                           "are built with the CUDA toolkit")
    return path


def build_command(name: str, output: str = "{output}", nvcc: str = "nvcc") -> List[str]:
    """The ``nvcc`` command line that builds kernel ``name`` into
    ``output``; runs nothing."""
    return [nvcc, *NVCC_FLAGS, *SOURCES[name].flags, "-o", output, str(_CSRC / f"{name}.cu")]


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    cmd = " ".join(build_command(name)[1:])  # without the compiler's path
    digest = hashlib.sha256(src + cmd.encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{digest}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    target = _target(name)
    if target.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(build_command(name, str(tmp), _nvcc()), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    build_logs[name] = out
    target = _target(name)
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all(names: Iterable[str] = tuple(SOURCES)) -> None:
    """Compile every named kernel that is not built yet, all at once."""
    with _LOCK:
        procs = {n: _start_build(n) for n in names}
        for n, proc in procs.items():
            if proc is not None:
                _finish_build(n, proc)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed; its
    entry points have ``argtypes`` and ``restype`` set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_target(name)))
            for entry, (argtypes, restype) in SOURCES[name].entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIBS[name] = lib
    return _LIBS[name]


def sass_counts(path) -> Dict[str, int]:
    """Instructions of each ``__global__`` function in the built library
    at ``path``, counted from ``cuobjdump -sass`` (the toolkit's
    disassembler, beside ``nvcc``); the NOPs that pad a function's end are
    not counted."""
    tool = str(Path(_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
            counts[fn] += 1
    return counts
