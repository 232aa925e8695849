"""ctypes wrapper for the native async frame pipeline (native/frame_loader.cpp).

Provides `FrameLoader`: a C++ worker pool decoding images ahead of the
consumer with an ordered bounded queue — the reference's producer/consumer
frame pipeline (System::CreateFrameAndPush + mFrameQueue,
/root/reference/src/System.cc:307-402) as a native component feeding the
jitted device stages. Falls back to synchronous Python decoding when the shared
library hasn't been built (native/build.sh).
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libgfs_native.so")
_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    from geoflowslam.utils.native_build import ensure_native_lib
    if not ensure_native_lib(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.gfs_loader_create.restype = ctypes.c_void_p
    lib.gfs_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.gfs_loader_next.restype = ctypes.c_int
    lib.gfs_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.gfs_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class FrameLoader:
    """Ordered prefetching loader over (rgb_path, depth_path) lists."""

    def __init__(self, rgb_paths: List[str],
                 depth_paths: Optional[List[str]] = None,
                 height: int = 480, width: int = 640,
                 n_threads: int = 2, queue_cap: int = 50,
                 depth_scale: float = 1.0):
        self.h, self.w = height, width
        self.rgb_paths = rgb_paths
        self.depth_paths = depth_paths
        self.depth_scale = depth_scale
        self._handle = None
        self._i = 0
        lib = _load_lib()
        if lib is not None:
            n = len(rgb_paths)
            rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
            if depth_paths is not None:
                dep_arr = (ctypes.c_char_p * n)(
                    *[(p or "").encode() for p in depth_paths])
            else:
                dep_arr = None
            self._handle = lib.gfs_loader_create(
                rgb_arr, dep_arr, n, n_threads, queue_cap,
                ctypes.c_float(depth_scale))
            self._lib = lib

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
        if self._handle is not None:
            gray = np.zeros((self.h, self.w), np.float32)
            depth = np.zeros((self.h, self.w), np.float32)
            wout = ctypes.c_int()
            hout = ctypes.c_int()
            iout = ctypes.c_int()
            while True:
                rc = self._lib.gfs_loader_next(
                    self._handle,
                    gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ctypes.byref(wout), ctypes.byref(hout), ctypes.byref(iout))
                if rc == 0:
                    return
                if rc < 0:
                    continue  # decode failure: skip (reference warns + skips)
                d = depth.copy() if self.depth_paths is not None else None
                yield int(iout.value), gray.copy(), d
        else:
            from geoflowslam.io.datasets import load_image
            for i, p in enumerate(self.rgb_paths):
                g = load_image(p)
                d = None
                if self.depth_paths is not None and self.depth_paths[i]:
                    d = load_image(self.depth_paths[i]) * self.depth_scale
                yield i, g, d

    def close(self):
        if self._handle is not None:
            self._lib.gfs_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
