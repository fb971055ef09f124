"""ctypes binding to the native prefetching batch loader (port of
``f2nerf_tpu/data/native_loader.py``).

``native/libf2loader.so`` (built from ``native/src/loader.cpp`` by ``make
-C native``, shared with the JAX package) runs worker threads that
pre-generate (cam_idx, ij, gt) ray batches from the host-resident image
array. Batches are counter-seeded, so the stream is deterministic
whatever the thread scheduling, and one seed gives one stream in both
packages. It is a host-side batch source only: it never changes which
device or kernel runs. The trainer falls back to numpy
``Dataset.sample_batch`` when the library does not load.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

_LIB_PATH = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "native" / "libf2loader.so")
_lib = None


def _load_lib():
    global _lib
    if _lib is None and _LIB_PATH.exists():
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.f2l_create.restype = ctypes.c_void_p
        lib.f2l_create.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
            ctypes.c_int32, ctypes.c_int32]
        lib.f2l_next.restype = ctypes.c_int32
        lib.f2l_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        lib.f2l_destroy.restype = None
        lib.f2l_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library exists and loads in this process."""
    try:
        return _load_lib() is not None
    except OSError:
        return False


class NativeBatchLoader:
    """Prefetching ray-batch loader backed by native worker threads."""

    def __init__(self, images: np.ndarray, batch: int, seed: int = 2022,
                 n_threads: int = 2, queue_depth: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(
                f"native loader not built ({_LIB_PATH}); "
                "run `make -C native`")
        self._lib = lib
        # keep a C-contiguous float32 copy alive for the workers
        self._images = np.ascontiguousarray(images, dtype=np.float32)
        n, h, w, _ = self._images.shape
        self.batch = batch
        self._handle = lib.f2l_create(
            self._images.ctypes.data_as(ctypes.c_void_p),
            n, h, w, batch, seed, n_threads, queue_depth)
        if not self._handle:
            raise RuntimeError("f2l_create failed")

    def next(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        cam = np.empty(self.batch, np.int32)
        ij = np.empty((self.batch, 2), np.int32)
        gt = np.empty((self.batch, 3), np.float32)
        ok = self._lib.f2l_next(
            self._handle,
            cam.ctypes.data_as(ctypes.c_void_p),
            ij.ctypes.data_as(ctypes.c_void_p),
            gt.ctypes.data_as(ctypes.c_void_p))
        if not ok:
            raise RuntimeError("native loader stopped")
        return cam, ij, gt

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.f2l_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
