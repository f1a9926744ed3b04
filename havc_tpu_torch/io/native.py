"""ctypes bindings of the native frame pipeline (``native/framepipe.cpp``).

Port of ``havc_tpu.io.native``.  The library holds a threaded Y4M reader
over a ring buffer, pixel converters and the Floyd-Steinberg quantizers of
``io.formats``.  ``load_native`` builds it with ``g++`` on first use (never
at import) into ``havc_tpu_torch/_build/libframepipe-<hash>.so``, the
hash of the source and the command line, written under a temporary name
and renamed into place (parallel processes may build it at once); the
source is the repo's ``native/framepipe.cpp`` as it stands, built with
``native/Makefile``'s flags; the name's hash also holds what
``-march=native`` means on the host, so a checkout shared by two hosts
builds one library each.  A missing source or compiler, or a failed
build, raises :class:`NativeUnavailable`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

__all__ = ["NativeUnavailable", "load_native", "Y4MStream", "build_native"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "framepipe.cpp"
_BUILD = _PKG / "_build"
# the flags of native/Makefile: the same arithmetic as the JAX package's
# build (-march=native lets g++ contract multiply-adds where the host has
# FMA, so the build's name also holds the host's -march)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_LIB = None
_LOCK = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def build_command(output: str = "{output}", cxx: str = "g++") -> list:
    """The ``g++`` command line that builds the library into ``output``."""
    return [cxx, *CXX_FLAGS, "-o", output, str(_SOURCE), "-lpthread"]


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("cannot build framepipe: no C++ compiler (g++) found")
    return cxx


def _native_arch(cxx: str) -> str:
    """What ``-march=native`` means to ``cxx`` on this host."""
    res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                         text=True)
    lines = [ln.split() for ln in res.stdout.splitlines() if ln.strip().startswith("-march=")]
    if res.returncode != 0 or not lines:
        raise NativeUnavailable(f"cannot query {cxx} for -march=native:\n{res.stderr}")
    return lines[0][-1]


def _target() -> Path:
    if not _SOURCE.exists():
        raise NativeUnavailable(f"native source not found: {_SOURCE}")
    cxx = _cxx()
    cmd = " ".join(build_command()[1:]) + " " + _native_arch(cxx)
    digest = hashlib.sha256(_SOURCE.read_bytes() + cmd.encode()).hexdigest()[:16]
    return _BUILD / f"libframepipe-{digest}.so"


def build_native() -> str:
    """Compile the library unless it is built; returns its path."""
    target = _target()
    if target.exists():
        return str(target)
    cxx = _cxx()
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(build_command(str(tmp), cxx), capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeUnavailable(f"cannot build framepipe (rc={res.returncode}):\n{res.stderr}")
    os.replace(tmp, target)
    return str(target)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64, SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_size_t
    sigs = {
        "fr_create": ([SZ, SZ], P),
        "fr_destroy": ([P], None),
        "fr_close": ([P], None),
        "fr_push": ([P, ctypes.c_char_p, SZ, I64], I),
        "fr_pop": ([P, P, ctypes.POINTER(I64)], I64),
        "fr_size": ([P], SZ),
        "y4m_open": ([ctypes.c_char_p], P),
        "y4m_info": ([P] + [ctypes.POINTER(I)] * 4 + [ctypes.POINTER(I64)], None),
        "y4m_read_frame": ([P, P], I64),
        "y4m_start_prefetch": ([P, P], None),
        "y4m_close": ([P], None),
        "u8_to_f32": ([P, P, I64], None),
        "f32_to_u8": ([P, P, I64], None),
        "yuv420_to_rgb_f32": ([P, P, I, I], None),
        "fs_dither_u8_batch": ([P, P, I, I, I, ctypes.c_float, ctypes.c_float], None),
        "fs_dither_u16_batch": ([P, P, I, I, I, ctypes.c_float, ctypes.c_float], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def load_native(auto_build: bool = True):
    """The loaded framepipe library (built first when ``auto_build``)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            target = _target()
            if not target.exists():
                if not auto_build:
                    raise NativeUnavailable(f"{target} not built")
                build_native()
            lib = ctypes.CDLL(str(target))
            _bind(lib)
            _LIB = lib
    return _LIB


class Y4MStream:
    """Y4M frames decoded on a native thread into a ring buffer, iterated
    as float32 RGB [0, 1] (the native BT.601 full-range conversion)."""

    def __init__(self, path: str, ring_capacity: int = 16):
        self.reader = self.ring = None
        self.lib = load_native()
        self.reader = self.lib.y4m_open(path.encode())
        if not self.reader:
            raise IOError(f"cannot open Y4M: {path}")
        w, h, fn, fd = (ctypes.c_int() for _ in range(4))
        fb = ctypes.c_int64()
        self.lib.y4m_info(self.reader, w, h, fn, fd, fb)
        self.width, self.height = w.value, h.value
        self.fps = fn.value / max(fd.value, 1)
        self.frame_bytes = fb.value
        self.ring = self.lib.fr_create(ring_capacity, self.frame_bytes)
        self.lib.y4m_start_prefetch(self.reader, self.ring)
        self._buf = np.empty(self.frame_bytes, np.uint8)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            idx = ctypes.c_int64()
            if self.lib.fr_pop(self.ring, self._buf.ctypes.data, idx) <= 0:
                break
            rgb = np.empty((self.height, self.width, 3), np.float32)
            self.lib.yuv420_to_rgb_f32(self._buf.ctypes.data, rgb.ctypes.data,
                                       self.width, self.height)
            yield rgb

    def read_batches(self, batch_size: int = 8) -> Iterator[np.ndarray]:
        batch = []
        for frame in self:
            batch.append(frame)
            if len(batch) == batch_size:
                yield np.stack(batch)
                batch = []
        if batch:
            yield np.stack(batch)

    def close(self):
        if self.reader:
            self.lib.y4m_close(self.reader)
            self.reader = None
        if self.ring:
            self.lib.fr_destroy(self.ring)
            self.ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
