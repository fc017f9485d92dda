"""JPEG files <-> HWC BGR uint8 arrays, as ``cv2.imread(path, IMREAD_COLOR)``
reads them and ``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, q])``
writes them.

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
OpenCV. Where OpenCV would decode the file (a progressive, lossless,
hierarchical or arithmetic-coded one, 12-bit samples, 4 components) the
error is ``NotDecoded``. The server hands it untrusted bytes. The EXIF orientation is applied as
OpenCV's ``imread`` applies it.

``encode_jpeg`` is the port's own baseline encoder,
``rsprompter_tpu_torch/native/jpeg_encode.cpp``, built the same way: 3-channel
BGR at a quality of 1-100, 4:2:0, libjpeg-turbo's colour conversion, ISLOW
DCT, quantiser and standard Huffman tables, so that its bytes equal
``cv2.imencode``'s (``tests/test_torch_jpeg_encode.py``). Any other input
raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict

import numpy as np

from rsprompter_tpu_torch.utils import native

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "jpeg.cpp"
ENCODER_SOURCE = PACKAGE_DIR / "native" / "jpeg_encode.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
JPEG_SOI = b"\xff\xd8"
_ERR_LEN = 256
_REFUSED = 2  # the C entry points' code for a valid file of a form left out

_intp = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "jpeg_header": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, _intp, _intp, _intp,
                                   ctypes.c_char_p, ctypes.c_int]),
}
_SIGNATURES.update({
    name: (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_char_p, ctypes.c_int])
    for name in ("jpeg_decode", "jpeg_decode_gray")
})
_ENCODER_SIGNATURES = {
    "jpeg_encode": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                     ctypes.c_int]),
}
_libs: Dict[Path, ctypes.CDLL] = {}  # by source, built and loaded once per process
_lock = threading.Lock()


def _load(source: Path, signatures) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            _libs[source] = native.load_library(source, BUILD_DIR, signatures)
        return _libs[source]


def load_library() -> ctypes.CDLL:
    """The decoder's library."""
    return _load(SOURCE, _SIGNATURES)


def load_encoder() -> ctypes.CDLL:
    """The encoder's library."""
    return _load(ENCODER_SOURCE, _ENCODER_SIGNATURES)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8, as OpenCV's ``ApplyExifOrientation``."""
    if orientation >= 5:  # the rows are the image's columns
        img = img.swapaxes(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


class NotDecoded(ValueError):
    """A valid image of a form that the port's decoders leave out and that
    ``cv2.imread`` decodes; a file that is cut or corrupt, which OpenCV
    cannot read either, raises a plain ``ValueError``."""


def _error(code: int, name: str, err) -> ValueError:
    return (NotDecoded if code == _REFUSED else ValueError)(f"{name}: {err.value.decode()}")


def decode_jpeg(data: bytes, name: str = "JPEG data", gray: bool = False) -> np.ndarray:
    """Baseline JPEG bytes -> (H, W, 3) uint8 BGR, or (H, W) uint8 with
    ``gray`` (``IMREAD_GRAYSCALE``); ``name`` (the file's) heads the message
    of the ``ValueError`` a refused file raises."""
    lib = load_library()
    h, w, orientation = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    code = lib.jpeg_header(data, len(data), h, w, orientation, err, _ERR_LEN)
    if code:
        raise _error(code, name, err)
    out = np.empty((h.value, w.value) if gray else (h.value, w.value, 3), np.uint8)
    decode = lib.jpeg_decode_gray if gray else lib.jpeg_decode
    code = decode(data, len(data), out.ctypes.data, h.value, w.value, err, _ERR_LEN)
    if code:
        raise _error(code, name, err)
    return _orient(out, orientation.value)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR -> baseline JPEG bytes at ``quality`` (1-100),
    the bytes ``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, quality])``
    gives; 95 is OpenCV's default."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 BGR, not {img.shape} {img.dtype}")
    if isinstance(quality, bool) or int(quality) != quality or not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality!r} is not an integer in 1..100")
    lib = load_encoder()
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = 1024 + h * w
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data, h, w, int(quality), out.ctypes.data, cap,
                            err, _ERR_LEN)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n
