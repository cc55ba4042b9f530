"""ctypes binding to the committed native JPEG decoder
``native/libadamml_native.so`` (source ``native/decode.cpp``; the port's
counterpart of ``adamml_tpu/data/native_decode.py``).

The library is loaded read-only by its path in the repository and never
built here: the JAX package's loader runs ``make -C native`` when the
library is missing, which writes into ``native/``; the port reports the
decoder unavailable instead, and ``VideoDataset`` decodes with PIL. Rows
the library fails to decode come back as zeros, for the caller to decode
with PIL (the reference's retry-based robustness, reference
utils/video_dataset.py:51-66).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from .loaders import count_decoded

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB_PATH = os.path.join(_REPO_ROOT, "native", "libadamml_native.so")

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None
_lib_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    with _lib_lock:
        if _lib is None and _load_error is None:
            try:
                lib = ctypes.CDLL(LIB_PATH)
            except OSError as e:  # missing file or missing libjpeg
                _load_error = str(e)
                return None
            lib.adamml_decode_batch.restype = ctypes.c_int
            lib.adamml_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library did not load (None when it loaded or was not tried)."""
    _load()
    return _load_error


def decode_jpeg_batch(paths: Sequence[str], canvas: np.ndarray,
                      n_threads: int = 4) -> np.ndarray:
    """Decode ``paths[i]`` into ``canvas[i]`` (T, H, W, C) uint8, top-left
    anchored; frames larger than the canvas are fitted in C++ as
    ``loaders.place_in_canvas`` fits them. Returns (T, 2) int32 true
    (h, w); rows of zeros mark failures the caller should retry with PIL
    (all rows when the library is unavailable)."""
    t, ch, cw, c = canvas.shape
    if len(paths) != t or canvas.dtype != np.uint8:
        raise ValueError(f"{len(paths)} paths for a {canvas.dtype} canvas "
                         f"of {t} frames")
    if not canvas.flags["C_CONTIGUOUS"]:
        raise ValueError("the canvas must be C-contiguous")
    out_hw = np.zeros((t, 2), np.int32)
    lib = _load()
    if lib is None:
        return out_hw
    arr = (ctypes.c_char_p * t)(*[p.encode() for p in paths])
    lib.adamml_decode_batch(
        arr, t, canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ch, cw, c, out_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    count_decoded("native", int((out_hw[:, 0] > 0).sum()))
    return out_hw
