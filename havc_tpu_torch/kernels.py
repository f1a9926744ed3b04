"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` (the hash is of the source
and the flags, so an edited source is rebuilt), then loaded with
``ctypes``.  Nothing is built when this module is imported: ``load`` builds
on first use, ``build_all`` builds every source at once with one ``nvcc``
process per source running in parallel.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["load", "build_all", "SOURCES", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (C entry point, ctypes argtypes, restype)
SOURCES = {
    "post_chain": (
        "post_chain_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p],
        ctypes.c_int,
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


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{digest}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    target = _target(name)
    if target.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


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
    entry point has ``argtypes`` and ``restype`` set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_target(name)))
            entry, argtypes, restype = SOURCES[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = restype
            _LIBS[name] = lib
    return _LIBS[name]
