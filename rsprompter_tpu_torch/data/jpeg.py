"""JPEG files -> HWC BGR uint8 arrays, as ``cv2.imread(path, IMREAD_COLOR)``.

The card's machine has neither OpenCV nor PIL, and NWPU VHR-10 and SSDD
ship JPEGs. The port decodes them with its own baseline decoder,
``rsprompter_tpu_torch/native/jpeg.cpp``: libjpeg-turbo's ISLOW IDCT, fancy
upsampling and fixed-point YCbCr -> RGB, so that the bytes equal
``cv2.imread``'s (libjpeg-turbo under OpenCV; ``tests/test_torch_jpeg.py``
holds them equal). The library is built with ``g++`` at first use into
``build/native/`` (``utils/native.py``); a build that fails raises.

Baseline sequential Huffman only (SOF0, SOF1 at 8 bits; 1 or 3 components;
any integral sampling). A progressive, lossless, hierarchical or
arithmetic-coded file, 12-bit samples, 4 components, data that end
before the last MCU, Huffman tables that are no prefix code and frames of
more than 2^30 pixels (OpenCV's ``CV_IO_MAX_IMAGE_PIXELS``) raise
``ValueError`` with the file's name and the marker; nothing falls back to
OpenCV. The server hands it untrusted bytes. The EXIF orientation is applied as
OpenCV's ``imread`` applies it.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from rsprompter_tpu_torch.utils import native

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "jpeg.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
JPEG_SOI = b"\xff\xd8"
_ERR_LEN = 256

_intp = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "jpeg_header": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, _intp, _intp, _intp,
                                   ctypes.c_char_p, ctypes.c_int]),
    "jpeg_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]),
}
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The decoder's library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = native.load_library(SOURCE, BUILD_DIR, _SIGNATURES)
    return _lib


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8, as OpenCV's ``ApplyExifOrientation``."""
    if orientation >= 5:  # the rows are the image's columns
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, name: str = "JPEG data") -> np.ndarray:
    """Baseline JPEG bytes -> (H, W, 3) uint8 BGR; ``name`` (the file's)
    heads the message of the ``ValueError`` a refused file raises."""
    lib = load_library()
    h, w, orientation = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_header(data, len(data), h, w, orientation, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, h.value, w.value, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return _orient(out, orientation.value)
